"""Step functions: train, prefill and decode (port of
``repro.runtime.steps``).

The reference jits these; the port runs them eagerly.  Every block kind
``models/transformer.py`` ports runs through them.  The train step takes the
gradient of ``loss_fn`` with ``torch.autograd.grad`` over the param leaves,
optionally compresses it (int8 with error feedback), and applies AdamW in
place.  On the card it runs through the kernels' autograd: RMSNorm, flash
attention and the SSD scan have backward kernels, so the attention, hybrid
and mamba models train there.

Sharded steps: under the active mesh (``parallel.sharding.set_active_mesh``)
each step takes DTensor params (``sharding.shard_params(param_pspecs(...))``)
and placed inputs (``sharding.place_batch``, ``place_cache``), the
reference's ``in_shardings``, and runs each rank's part of it
(``models/transformer.py``); the train step's gradients, AdamW's moments and
the updated params keep their parameters' placements.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from ..configs.base import ModelConfig
from ..models import transformer
from ..optim import adamw
from ..optim import compression as comp
from ..parallel import sharding


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    optimizer: adamw.AdamWConfig = adamw.AdamWConfig()
    remat: bool = True
    grad_compression: bool = False   # int8 EF compression (cross-pod traffic)


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig):
    def train_step(params: Any, opt_state: dict, batch: dict) -> tuple[Any, dict, dict]:
        """One step.  Updates ``params`` and ``opt_state`` in place and
        returns them with the step's metrics (loss, nll, aux, grad_norm,
        lr; detached tensors)."""
        leaves = adamw.tree_leaves(params)
        for t in leaves:
            t.requires_grad_(True)
        try:
            loss, metrics = transformer.loss_fn(params, cfg, batch, remat=tcfg.remat)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        finally:
            for t in leaves:
                t.requires_grad_(False)
        grads = adamw.tree_unflatten(params, [torch.zeros_like(p) if g is None
                                              else sharding.like(g, p)
                                              for p, g in zip(leaves, grads)])
        if tcfg.grad_compression:
            grads, new_err = comp.compress_with_feedback(grads, opt_state["comp_error"])
        params, opt_state, opt_metrics = adamw.update(tcfg.optimizer, grads, opt_state, params)
        if tcfg.grad_compression:
            opt_state["comp_error"] = new_err
        return params, opt_state, {**{k: v.detach() for k, v in metrics.items()},
                                   **opt_metrics}

    return train_step


def init_opt_state(params: Any, tcfg: TrainConfig) -> dict:
    state = adamw.init(params)
    if tcfg.grad_compression:
        state["comp_error"] = comp.init_error(params)
    return state


def make_prefill_step(cfg: ModelConfig, max_len: int | None = None, *, plain: bool = False):
    def prefill_step(params: dict, batch: dict):
        return transformer.prefill(params, cfg, batch, max_len=max_len, plain=plain)

    return prefill_step


def make_decode_step(cfg: ModelConfig, *, plain: bool = False):
    def decode_step(params: dict, tokens, cache: list, pos: int):
        return transformer.decode_step(params, cfg, tokens, cache, pos, plain=plain)

    return decode_step
