"""Step functions: prefill / decode (port of the serving half of
``repro.runtime.steps``; the training steps are a later slice).

The reference jits these; the port runs them eagerly.  Every block kind
``models/transformer.py`` ports runs through them: GQA, SWA and MLA
attention, the MLP and MoE FFNs, and the hybrid and mamba SSM blocks.
"""

from __future__ import annotations

from ..configs.base import ModelConfig
from ..models import transformer


def make_prefill_step(cfg: ModelConfig, max_len: int | None = None, *, plain: bool = False):
    def prefill_step(params: dict, batch: dict):
        return transformer.prefill(params, cfg, batch, max_len=max_len, plain=plain)

    return prefill_step


def make_decode_step(cfg: ModelConfig, *, plain: bool = False):
    def decode_step(params: dict, tokens, cache: list, pos: int):
        return transformer.decode_step(params, cfg, tokens, cache, pos, plain=plain)

    return decode_step
