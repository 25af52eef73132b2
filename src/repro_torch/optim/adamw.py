"""AdamW with global-norm clipping and a cosine schedule (port of
``repro.optim.adamw``).

The optimizer state mirrors the parameter tree (m and v in f32) beside an
int32 ``step``.  The reference is pure-functional and donates its buffers at
the jit boundary; the port updates params, m and v in place instead (at
xlstm-1.3B's full width a second copy of m and v would be another 28 GB),
computing each leaf's update in f32 and casting back to the param's dtype.
A tree is nested dicts, lists and tuples of tensors; its leaves are taken
in the reference's order (dict keys sorted, as ``jax.tree.leaves``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import torch


def tree_leaves(tree: Any) -> list:
    """The leaves, dict keys in sorted order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_unflatten(template: Any, leaves: list) -> Any:
    """``template``'s structure with ``leaves`` (in ``tree_leaves`` order)."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            built = {k: build(t[k]) for k in sorted(t)}
            return {k: built[k] for k in t}
        if isinstance(t, (list, tuple)):
            out = [build(v) for v in t]
            return type(t)(out) if isinstance(t, tuple) else out
        return next(it)

    return build(template)


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` and the matching leaves of ``rest``."""
    out = [fn(*xs) for xs in zip(tree_leaves(tree), *(tree_leaves(r) for r in rest))]
    return tree_unflatten(tree, out)


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warm-up, then cosine decay to ``min_lr_frac`` of ``lr``; f32."""
    s = step.float()
    warm = s / max(cfg.warmup_steps, 1)
    prog = torch.clamp((s - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0, 1)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (1 + torch.cos(math.pi * prog))
    return cfg.lr * torch.minimum(warm, cos)


def init(params: Any) -> dict:
    """m and v zeros in f32 beside each param (a DTensor param's laid out as
    it is), and an int32 step of 0."""
    first = tree_leaves(params)[0]

    def zeros(p: torch.Tensor) -> torch.Tensor:
        if type(p) is not torch.Tensor and hasattr(p, "placements"):  # a DTensor: its layout
            return torch.zeros_like(p, dtype=torch.float32)
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=first.device)}


def global_norm(tree: Any) -> torch.Tensor:
    """sqrt of the sum of every leaf's squares, in f32."""
    return torch.sqrt(torch.stack([torch.sum(torch.square(x.float()))
                                   for x in tree_leaves(tree)]).sum())


@torch.no_grad()
def update(cfg: AdamWConfig, grads: Any, state: dict, params: Any
           ) -> tuple[Any, dict, dict]:
    """One step: clip by the global norm, AdamW in f32, params cast back to
    their dtype.  Updates ``params`` and ``state``'s m and v in place and
    returns (params, state, {"grad_norm", "lr"})."""
    step = state["step"] + 1
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)
    lr = schedule(cfg, step)
    b1c = 1 - cfg.b1 ** step.float()
    b2c = 1 - cfg.b2 ** step.float()
    for p, g, m, v in zip(tree_leaves(params), tree_leaves(grads), tree_leaves(state["m"]),
                          tree_leaves(state["v"])):
        g = g.float() * scale
        m.mul_(cfg.b1).add_((1 - cfg.b1) * g)
        v.mul_(cfg.b2).add_((1 - cfg.b2) * g * g)
        delta = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps) + cfg.weight_decay * p.float()
        p.copy_(p.float() - lr * delta)
    state["step"] = step
    return params, state, {"grad_norm": gnorm, "lr": lr}
