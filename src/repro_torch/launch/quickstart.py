"""Quickstart: train a tiny LM for 30 steps with the full stack (data
pipeline -> model -> AdamW -> checkpointing), then resume from the
checkpoint to show the exact restart (port of ``examples/quickstart.py``).

    PYTHONPATH=src python -m repro_torch.launch.quickstart [--device cuda|cpu]

internlm2 cut to 2 layers of d 64 over a vocab of 512, f32, batch 8 x 64,
checkpoints every 10 steps through ``train_loop.run``; the same loop run
again on the same directory resumes at step 30 and takes no new step.  On
the card (the default) its attention runs the f32 kernels at heads of 16,
forward and backward.
"""

from __future__ import annotations

import argparse
import tempfile

from .. import configs as C
from ..data import DataConfig
from ..device import resolve_device
from ..runtime import TrainConfig, train_loop


def config():
    """The example's model: internlm2 reduced to 2 layers, d 64, vocab 512."""
    return C.get_config("internlm2_1p8b").reduced(n_layers=2, d_model=64, vocab=512)


def main(argv: list[str] | None = None, params: dict | None = None) -> dict:
    """Run the example on ``--device`` and print its lines.  ``params``, on
    that device, replace the loop's initialisation from seed 0 (the tests
    pass the reference's, converted).  Returns the first run's losses and
    walls, the resumed run's step count and the printed lines."""
    ap = argparse.ArgumentParser(description="train a tiny LM, then resume it")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    cfg = config()
    tcfg = TrainConfig()
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=64, global_batch=8)
    lines: list[str] = []

    def say(line: str) -> None:
        print(line, flush=True)
        lines.append(line)

    with tempfile.TemporaryDirectory() as d:
        lcfg = train_loop.LoopConfig(total_steps=30, ckpt_every=10, ckpt_dir=d)
        out = train_loop.run(cfg, tcfg, lcfg, dcfg, params=params, device=dev)
        say(f"trained {len(out['losses'])} steps: "
            f"loss {out['losses'][0]:.3f} -> {out['losses'][-1]:.3f}")
        assert out["losses"][-1] < out["losses"][0], "loss should fall"

        # resume: the loop picks up at step 30 and does nothing more
        lcfg2 = train_loop.LoopConfig(total_steps=30, ckpt_every=10, ckpt_dir=d)
        out2 = train_loop.run(cfg, tcfg, lcfg2, dcfg, device=dev)
        say(f"resume check: {len(out2['losses'])} new steps (expect 0)")
    say("quickstart OK")
    return {"losses": out["losses"], "walls": out["walls"], "resumed_steps": len(out2["losses"]),
            "lines": lines}


if __name__ == "__main__":
    main()
