"""A full-depth train step of this checkout beside the same step of another
checkout, on one card, in child processes in the order A B B A.

    python -m repro_torch.launch.ab_train --other PATH
    python -m repro_torch.launch.ab_train --other PATH --arch internlm2_1p8b --steps 8

A is this checkout, B the one whose root is PATH (its ``src`` holds its
``repro_torch``; unpack it with ``git archive``).  Each child builds its
checkout's kernels, then trains the arch at full width and depth in bf16
with remat, batch 2 x 4096, through ``make_train_step`` with the reference's
AdamW defaults on the pipeline's batches: one warm-up step, ``--steps``
steps each timed alone (synchronised walls), and one more step under
``torch.profiler``.  A child prints one JSON line: the walls, their median,
the profiled step's kernel milliseconds by group (``profile_serve``'s
groups), and the device's idle share, 1 - kernels / the median wall.  The
parent prints the card's name and power limit and the four children's lines.
Needs the card and ``nvcc``.
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import statistics
import subprocess
import sys
import time

SRC = pathlib.Path(__file__).resolve().parents[2]  # this checkout's src


def child(arch: str, steps: int, B: int, S: int) -> None:
    """One checkout's steps (see the module note); imports the
    ``repro_torch`` on ``PYTHONPATH``."""
    import collections

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import configs as C
    from repro_torch.data import DataConfig
    from repro_torch.data.pipeline import _batch_at
    from repro_torch.kernels import build
    from repro_torch.launch.profile_serve import _group
    from repro_torch.models import init_params
    from repro_torch.runtime import TrainConfig, init_opt_state, make_train_step

    t0 = time.perf_counter()
    build.build_all()
    built = time.perf_counter() - t0
    cfg = C.production_cfg(C.get_config(arch))
    params = init_params(0, cfg, device="cuda")
    tcfg = TrainConfig()
    opt = init_opt_state(params, tcfg)
    step = make_train_step(cfg, tcfg)
    batches = [{"tokens": torch.from_numpy(_batch_at(DataConfig(
        vocab=cfg.vocab, seq_len=S, global_batch=B, seed=0), i, 0, 1)["tokens"]).cuda()}
        for i in range(steps + 1)]
    params, opt, _ = step(params, opt, batches[0])
    torch.cuda.synchronize()
    walls, losses = [], []
    for b in batches[1:]:
        t1 = time.perf_counter()
        params, opt, m = step(params, opt, b)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t1)
        losses.append(m["loss"].item())
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        step(params, opt, batches[0])
        torch.cuda.synchronize()
    groups = collections.Counter()
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            groups[_group(e.key)] += e.self_device_time_total / 1e3
    kernels = sum(groups.values())
    wall = statistics.median(walls)
    print(json.dumps({"src": os.environ.get("PYTHONPATH", ""), "arch": arch, "build_s": built,
                      "walls_s": walls, "median_wall_s": wall, "losses": losses,
                      "kernels_ms": kernels, "idle_share": 1 - kernels / (wall * 1e3),
                      "groups_ms": dict(groups.most_common()),
                      "peak_gib": torch.cuda.max_memory_allocated() / 2**30}), flush=True)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--other", help="root of the other checkout (B)")
    ap.add_argument("--arch", default="hymba_1p5b")
    ap.add_argument("--steps", type=int, default=5, help="timed steps a child")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq", type=int, default=4096)
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child:
        child(args.arch, args.steps, args.batch, args.seq)
        return 0
    import torch
    if not torch.cuda.is_available():
        raise RuntimeError("ab_train: no cuda device; the A/B runs on the card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(f"[ab_train] card: {card.strip()}", flush=True)
    other = pathlib.Path(args.other).resolve() / "src"
    rc = 0
    for tag, src in (("A", SRC), ("B", other), ("B", other), ("A", SRC)):
        env = dict(os.environ, PYTHONPATH=str(src))
        r = subprocess.run([sys.executable, __file__, "--child", "--arch", args.arch,
                            "--steps", str(args.steps), "--batch", str(args.batch),
                            "--seq", str(args.seq)], capture_output=True, text=True, env=env,
                           timeout=1800)
        line = r.stdout.strip().splitlines()[-1] if r.stdout.strip() else ""
        print(f"[ab_train] {tag} rc {r.returncode}: {line or r.stderr[-3000:]}", flush=True)
        rc = rc or r.returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
