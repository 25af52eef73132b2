"""Reference parameters -> the port's parameters.

``from_jax_params`` takes the reference's parameter tree whose leaves are
already numpy arrays (the caller ran ``jax.tree.map(np.asarray, params)``;
this module never imports jax) and returns the port's per-layer dicts of
tensors.  Weights keep the reference's (in, out) layout: a projection is
``x @ w`` in both packages, so nothing is transposed.
"""

from __future__ import annotations

import numpy as np
import torch

from ..configs.base import ModelConfig
from ..device import resolve_device


def _tensor(a: np.ndarray, dev: torch.device) -> torch.Tensor:
    # np.asarray of a jax array is read-only; torch.from_numpy wants a
    # writable buffer it may alias, so copy first.  bfloat16 has no numpy
    # dtype torch understands: it arrives as ml_dtypes.bfloat16 and goes
    # through float32, which holds every bfloat16 value exactly.
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(np.array(a, dtype=np.float32, copy=True)).to(
            device=dev, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True)).to(dev)


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


def from_jax_params(tree: dict, cfg: ModelConfig,
                    device: str | torch.device = "cuda") -> dict:
    """Unstack ``tree["blocks"][pp]`` (leaves with a leading group axis G)
    into per-layer weights: layer l = g * len(block_pattern) + pp."""
    dev = resolve_device(device)
    pat = cfg.block_pattern
    groups = cfg.n_layers // len(pat)
    out = {k: _map(v, lambda a: _tensor(a, dev)) for k, v in tree.items() if k != "blocks"}
    out["blocks"] = [_map(tree["blocks"][pp], lambda a, g=g: _tensor(a[g], dev))
                     for g in range(groups) for pp in range(len(pat))]
    return out
