"""Deterministic synthetic data pipeline: shardable, resumable, prefetched
(port of ``repro.data.pipeline``).

The loader yields global batches whose per-host slice is computed from
(host_id, num_hosts); restore-from-step is exact (the stream is a pure
function of (seed, step)).  ``_batch_at`` is the reference's numpy
generator, copied as it is, so the tokens and embeddings are bit for bit the
reference's.  A background thread makes the next batches while the current
step runs; ``__next__`` lands each on the loader's device.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Iterator

import numpy as np
import torch

from ..device import resolve_device


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    embed_stub_dim: int | None = None  # audio/vlm: yield embeddings instead


def _batch_at(cfg: DataConfig, step: int, host_id: int, num_hosts: int) -> dict:
    assert cfg.global_batch % num_hosts == 0
    per_host = cfg.global_batch // num_hosts
    rng = np.random.default_rng(
        np.random.SeedSequence([cfg.seed, step, host_id]))
    if cfg.embed_stub_dim:
        emb = rng.standard_normal(
            (per_host, cfg.seq_len, cfg.embed_stub_dim)).astype(np.float32)
        labels = rng.integers(0, cfg.vocab,
                              (per_host, cfg.seq_len), dtype=np.int32)
        return {"embeds": emb, "labels": labels}
    # Markov-ish synthetic tokens: loosely predictable so loss can fall.
    base = rng.integers(0, cfg.vocab, (per_host, cfg.seq_len), dtype=np.int32)
    shifted = np.roll(base, 1, axis=1)
    mix = rng.random((per_host, cfg.seq_len)) < 0.5
    tokens = np.where(mix, shifted, base).astype(np.int32)
    return {"tokens": tokens}


class DataLoader:
    """Iterator with exact resume: ``DataLoader(cfg, start_step=k)``.  Yields
    dicts of tensors on ``device`` (int32 tokens and labels, f32 embeds)."""

    def __init__(self, cfg: DataConfig, start_step: int = 0,
                 host_id: int = 0, num_hosts: int = 1, prefetch: int = 2,
                 device: str | torch.device = "cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.step = start_step
        self.host_id = host_id
        self.num_hosts = num_hosts
        self._q: queue.Queue = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        step = self.step
        while not self._stop.is_set():
            batch = _batch_at(self.cfg, step, self.host_id, self.num_hosts)
            try:
                self._q.put((step, batch), timeout=0.1)
                step += 1
            except queue.Full:
                continue

    def __iter__(self) -> Iterator[dict]:
        return self

    def __next__(self) -> dict:
        step, batch = self._q.get()
        self.step = step + 1
        return {k: torch.from_numpy(v).to(self.device) for k, v in batch.items()}

    def close(self):
        self._stop.set()
        self._thread.join(timeout=5.0)


def batch_specs(cfg: DataConfig, dtype: torch.dtype = torch.float32) -> dict:
    """``{name: (global shape, dtype)}`` of a batch."""
    if cfg.embed_stub_dim:
        return {"embeds": ((cfg.global_batch, cfg.seq_len, cfg.embed_stub_dim), dtype),
                "labels": ((cfg.global_batch, cfg.seq_len), torch.int32)}
    return {"tokens": ((cfg.global_batch, cfg.seq_len), torch.int32)}
