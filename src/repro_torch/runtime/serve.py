"""Serving runtime: batched prefill + greedy decode (port of
``repro.runtime.serve.ServeConfig`` and ``Server``).

Request admission and placement (``AdmissionController``,
``schedule_requests``) come with the placement slice.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..configs.base import ModelConfig
from ..device import resolve_device
from ..models.transformer import check_config
from . import steps as steps_mod


@dataclasses.dataclass
class ServeConfig:
    max_len: int = 128
    batch_size: int = 4


class Server:
    """Minimal production-shaped server: prefill -> decode loop.

    ``device`` defaults to the card and must be where ``params`` live.  The
    KV cache is updated in place by each decode step (the reference donates
    it to its jitted step instead)."""

    def __init__(self, cfg: ModelConfig, params: dict, scfg: ServeConfig, *,
                 device: str | torch.device = "cuda"):
        check_config(cfg)
        self.device = resolve_device(device)
        where = params["embed"]["table"].device
        if where.type != self.device.type:
            raise ValueError(f"params on {where}, server on {self.device}")
        self.cfg = cfg
        self.scfg = scfg
        self.params = params
        self._prefill = steps_mod.make_prefill_step(cfg, max_len=scfg.max_len)
        self._decode = steps_mod.make_decode_step(cfg)

    @torch.inference_mode()
    def generate(self, tokens: np.ndarray, steps: int) -> np.ndarray:
        """tokens: (B, S) prompt -> (B, steps) generated ids (greedy).

        The first id is the argmax of the prefill logits; each loop step
        appends the current id before decoding it, so ``steps`` decode calls
        run and the last one's argmax is discarded, as in the reference."""
        B, S = tokens.shape
        if S + steps > self.scfg.max_len:
            raise ValueError(f"prompt {S} + steps {steps} > max_len {self.scfg.max_len}")
        prompt = torch.as_tensor(np.asarray(tokens, np.int64), device=self.device)
        logits, cache = self._prefill(self.params, {"tokens": prompt})
        out = []
        pos = S
        tok = torch.argmax(logits, -1)[:, None]
        for _ in range(steps):
            out.append(tok[:, 0])
            logits, cache = self._decode(self.params, tok, cache, pos)
            tok = torch.argmax(logits, -1)[:, None]
            pos += 1
        return torch.stack(out, dim=1).cpu().numpy().astype(np.int32)
