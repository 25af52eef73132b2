"""GPipe pipeline executor over a ``stage`` mesh axis, with stage cuts
supplied by OULD placement (port of ``repro.parallel.pipeline``).

The paper's placement runs layer ranges on different nodes and ships the
boundary activation over the best link; this is the same execution shape on
a ``DeviceMesh``: every rank runs the same program (SPMD), keeps only its
stage's layers, and microbatch activations flow stage to stage by
``batch_isend_irecv`` on the stage group (the reference's ``ppermute``).

Schedule: GPipe fill/drain over T = n_micro + n_stages - 1 ticks; at tick t
stage s works on microbatch t - s.  Stage cuts may be non-uniform
(:func:`pipeline_forward_stages`), as OULD's rarely are uniform.  In eager
PyTorch a stage runs exactly its own layers and skips its bubble ticks: the
reference pads every stage to the longest and masks the padded layers and
bubble ticks only to keep ``lax.scan``'s shapes static, and its output does
not depend on them.  :func:`pipeline_forward` is the uniform case.
"""

from __future__ import annotations

from typing import Any, Callable, Sequence

import torch
import torch.distributed as dist

from .sharding import mesh_sizes


def pipeline_forward_stages(block_fn: Callable, params_layers: Sequence[Any], x: torch.Tensor,
                            *, mesh, stage_sizes: Sequence[int], stage_axis: str = "stage",
                            n_micro: int | None = None) -> torch.Tensor:
    """Run ``block_fn(layer_params, x_micro)`` over the layers as a pipeline
    with contiguous stage cuts.

    ``params_layers``: the L per-layer trees (a model's ``params["blocks"]``);
    a rank reads only its own stage's entries, so the others may be ``None``.
    ``stage_sizes``: layers a stage (sum L, one a stage, each >= 1), e.g.
    ``[s.layer_end - s.layer_start for s in plan.stages(r)]`` for an OULD
    cut.  ``x``: (B, ...) the whole batch, the same on every rank,
    B % n_micro == 0 (n_micro defaults to the stage count).  ``block_fn``
    keeps the activation's shape.  Returns, on every rank, the block stack's
    output, the sequential application of all L layers.
    """
    n_stages = mesh_sizes(mesh)[stage_axis]
    sizes = [int(s) for s in stage_sizes]
    L = len(params_layers)
    if len(sizes) != n_stages:
        raise ValueError(f"{len(sizes)} stage cuts on a {n_stages}-stage "
                         f"{stage_axis!r} mesh axis")
    if sum(sizes) != L or min(sizes) < 1:
        raise ValueError(f"stage_sizes {sizes} must partition L={L} layers "
                         "into non-empty contiguous slices")
    B = x.shape[0]
    n_micro = n_micro or n_stages
    if B % n_micro:
        raise ValueError(f"batch {B} does not split into {n_micro} microbatches")
    micro = x.reshape(n_micro, B // n_micro, *x.shape[1:])

    sid = mesh.get_local_rank(stage_axis) if n_stages > 1 else 0
    start = sum(sizes[:sid])
    mine = params_layers[start:start + sizes[sid]]

    def run_stage(h: torch.Tensor) -> torch.Tensor:
        for p in mine:
            h = block_fn(p, h)
        return h

    if n_stages == 1:
        return torch.cat([run_stage(m) for m in micro]).reshape(x.shape)

    group = mesh.get_group(stage_axis)
    # NCCL wants every rank of a group in its first collective; the first
    # tick's batch of P2P ops holds two stages only
    dist.barrier(group=group)
    last = n_stages - 1
    out = torch.empty_like(micro)
    buf = torch.empty_like(micro[0])
    for t in range(n_micro + n_stages - 1):
        m = t - sid
        y = None
        if 0 <= m < n_micro:
            y = run_stage(micro[m] if sid == 0 else buf).contiguous()
            if sid == last:
                out[m] = y
        # end of tick: this stage's output goes down; the next tick's input
        # (the previous stage's output at this tick) comes in
        ops = []
        if y is not None and sid < last:
            ops.append(dist.P2POp(dist.isend, y, group=group, group_peer=sid + 1))
        if sid > 0 and 0 <= t + 1 - sid < n_micro:
            buf = torch.empty_like(micro[0])
            ops.append(dist.P2POp(dist.irecv, buf, group=group, group_peer=sid - 1))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
    # only the last stage holds the outputs: broadcast them to every stage
    dist.broadcast(out, group=group, group_src=last)
    return out.reshape(x.shape)


def pipeline_forward(block_fn: Callable, params_layers: Sequence[Any], x: torch.Tensor, *,
                     mesh, stage_axis: str = "stage", n_micro: int | None = None
                     ) -> torch.Tensor:
    """Uniform cuts: L % n_stages == 0, each stage runs L / S layers."""
    n_stages = mesh_sizes(mesh)[stage_axis]
    L = len(params_layers)
    if L % n_stages:
        raise ValueError(f"{L} layers do not split evenly over {n_stages} stages")
    return pipeline_forward_stages(block_fn, params_layers, x, mesh=mesh,
                                   stage_sizes=[L // n_stages] * n_stages,
                                   stage_axis=stage_axis, n_micro=n_micro)
