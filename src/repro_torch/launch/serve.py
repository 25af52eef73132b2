"""Serving launcher: batched greedy generation with the production server,
at full width in bf16 (``production_cfg``) on the card by default.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch internlm2_1p8b \\
        --batch 4 --prompt-len 1024 --steps 64
    PYTHONPATH=src python -m repro_torch.launch.serve --arch hymba_1p5b \\
        --batch 4 --prompt-len 1536 --steps 64

``--reduced`` runs the reference's small f32 shrink instead (the CPU path:
``--reduced --device cpu``).  Request placement over a serving pool
(``--planner``, ``--pool-nodes``, ``--execute``, ``--transport``,
``--trace-out`` in the reference) comes with the placement slice.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from .. import configs as C
from ..device import resolve_device
from ..models import init_params
from ..runtime.serve import ServeConfig, Server


def main(argv: list[str] | None = None) -> np.ndarray:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="internlm2_1p8b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--steps", type=int, default=16)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--reduced", action="store_true",
                    help="the reference's CPU shrink (2 layers, d 128, vocab 1024, f32) "
                         "instead of the full-width bf16 production config")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = C.get_config(args.arch)
    cfg = (cfg.reduced(n_layers=2, d_model=128, vocab=1024) if args.reduced
           else C.production_cfg(cfg))
    params = init_params(0, cfg, device=dev)
    srv = Server(cfg, params, ServeConfig(max_len=args.prompt_len + args.steps + 1,
                                          batch_size=args.batch), device=dev)
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab, (args.batch, args.prompt_len), dtype=np.int32)
    t0 = time.perf_counter()
    out = srv.generate(prompts, steps=args.steps)  # ends in a copy to the host
    wall = time.perf_counter() - t0
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"[serve] arch={args.arch} device={name} generated {out.shape} in "
          f"{wall:.3f}s: {out[0].tolist()}")
    return out


if __name__ == "__main__":
    main()
