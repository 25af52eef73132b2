"""Training launcher: the fault-tolerant loop on the card by default.

    PYTHONPATH=src python -m repro_torch.launch.train --arch xlstm_1p3b --steps 50
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu --steps 4

The reference's flags, plus ``--device``.  As in the reference,
``--reduced`` is on by default and cannot be turned off (``store_true``
with ``default=True``): the loop always trains the reduced config.  The
full-width train step runs through ``runtime.steps.make_train_step``.
Attention, hybrid and mamba models train on the CPU only until flash
attention and the SSD scan have backward kernels: on the card their kernels
refuse a grad-requiring input.
"""

from __future__ import annotations

import argparse
import os
import tempfile


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="internlm2_1p8b")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "repro_torch_train"))
    ap.add_argument("--grad-compression", action="store_true")
    ap.add_argument("--reduced", action="store_true", default=True,
                    help="train the reduced config (CPU-sized)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from .. import configs as C
    from ..data import DataConfig
    from ..device import resolve_device
    from ..optim import AdamWConfig
    from ..runtime import TrainConfig, train_loop

    dev = resolve_device(args.device)
    cfg = C.get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced(n_layers=2, d_model=128, vocab=1024)
    tcfg = TrainConfig(grad_compression=args.grad_compression,
                       optimizer=AdamWConfig(total_steps=args.steps))
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                      global_batch=args.batch,
                      embed_stub_dim=cfg.d_model if cfg.embed_stub else None)
    lcfg = train_loop.LoopConfig(total_steps=args.steps,
                                 ckpt_every=max(args.steps // 4, 1),
                                 ckpt_dir=args.ckpt_dir)
    out = train_loop.run_with_restarts(cfg, tcfg, lcfg, dcfg, device=dev)
    print(f"[train] arch={args.arch} device={dev} steps={out['last_step'] + 1} "
          f"loss {out['losses'][0]:.3f} -> {out['losses'][-1]:.3f} "
          f"stragglers={out['straggler_events']}")
    return out


if __name__ == "__main__":
    main()
