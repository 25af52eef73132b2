"""End to end: train a ~100M-parameter decoder LM for a few hundred
steps with the production loop, checkpointing, restart-on-failure and
straggler detection all active (port of ``examples/train_100m.py``).

By default a fast 60-step config (internlm2 cut to 4 layers of d 128 over 4
heads, vocab 2048, f32, batch 8 x 128); ``--full`` trains the ~100M model
for 300 steps: 12 layers of d 768, 12 query / 4 kv heads of 64, d_ff 3072,
vocab 32000, batch 8 x 512, in bf16.  The example's ``--full`` config keeps
internlm2's f32 weights beside its bf16 compute dtype, a mix the port
refuses (``transformer.check_config``: the reference's decode fails on it,
and its train step rounds only the embedding to bf16, every product after
it promoting to f32), so the port trains it in the reference's production
form, bf16 weights and compute (``production_cfg``).
AdamW warms up over 20 steps and decays over the run; one node failure is
injected at 40 % of the steps and ``run_with_restarts`` resumes from the
latest checkpoint (every 50 steps).

    PYTHONPATH=src python -m repro_torch.launch.train_100m [--full] [--steps N] \\
        [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import tempfile

from .. import configs as C
from ..data import DataConfig
from ..device import resolve_device
from ..optim import AdamWConfig, tree_leaves
from ..runtime import TrainConfig, train_loop


def config(full: bool):
    """(model config, steps, batch, sequence) of the example's two sizes."""
    base = C.get_config("internlm2_1p8b")
    if full:
        # ~100M params: 12L x d768 (GQA 12H/4kv, ff 3072), 32k vocab
        cfg = dataclasses.replace(base, n_layers=12, d_model=768, n_heads=12, n_kv=4,
                                  d_ff=3072, vocab=32000, head_dim=64)
        return C.production_cfg(cfg), 300, 8, 512
    return base.reduced(n_layers=4, d_model=128, n_heads=4, vocab=2048), 60, 8, 128


def main(argv: list[str] | None = None, params: dict | None = None) -> dict:
    """Run the example on ``--device`` and print its lines.  ``params``, on
    that device, replace the loop's initialisation from seed 0 (the tests
    pass the reference's, converted).  Returns the loop's output (losses,
    step and checkpoint walls, ``restarts``, the trained params), the
    parameter count, the step the failure was injected at and the printed
    lines."""
    ap = argparse.ArgumentParser(description="train a ~100M decoder with restarts")
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    cfg, steps, batch, seq = config(args.full)
    steps = args.steps or steps
    tcfg = TrainConfig(optimizer=AdamWConfig(lr=1e-3, warmup_steps=20, total_steps=steps))
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=seq, global_batch=batch)
    lines: list[str] = []
    with tempfile.TemporaryDirectory() as d:
        lcfg = train_loop.LoopConfig(total_steps=steps, ckpt_every=50, ckpt_dir=d)
        # one failure at 40% of the run: exercises restart and resume
        fail_step = {int(steps * 0.4)}
        fired = []

        def fail_at(s):
            if s in fail_step and s not in fired:
                fired.append(s)
                return True
            return False

        out = train_loop.run_with_restarts(cfg, tcfg, lcfg, dcfg, fail_at=fail_at,
                                           params=params, device=dev)
        n = sum(t.numel() for t in tree_leaves(out["params"]))
        lines.append(f"params={n / 1e6:.1f}M steps={out['last_step'] + 1} "
                     f"restarts={out['restarts']} "
                     f"loss {out['losses'][0]:.3f} -> {out['losses'][-1]:.3f}")
        print(lines[-1], flush=True)
        assert out["restarts"] >= 1, "failure injection should have fired"
        assert out["losses"][-1] < out["losses"][0]
    lines.append("train_100m OK")
    print(lines[-1], flush=True)
    return {**out, "n_params": n, "fail_step": min(fail_step), "lines": lines}


if __name__ == "__main__":
    main()
