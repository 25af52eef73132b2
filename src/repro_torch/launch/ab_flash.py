"""Flash attention built from this checkout's source beside the same kernel
built from another version of ``csrc/flash_attention.cu``, timed in one
process on one card, in the order A B B A, at the served shapes.

    python -m repro_torch.launch.ab_flash --other PATH/flash_attention.cu

A is this checkout's source, B the other one.  Each shape prints both
versions' milliseconds a call in each round (CUDA events, the median of 7
windows of 10 calls over inputs cycled past the 50 MB L2) and whether the two
outputs are bitwise equal.  Needs the card and ``nvcc``.
"""

from __future__ import annotations

import argparse
import pathlib
import shutil
import statistics
import subprocess

import torch

from repro_torch.device import resolve_device
from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import flash_attention

# (what, B, S, Hq, Hkv, DK, DV, window)
SHAPES = [("internlm2 prefill", 4, 1024, 16, 8, 128, 128, None),
          ("hymba prefill", 4, 1536, 25, 5, 64, 64, 1024),
          ("granite prefill", 4, 1024, 24, 8, 64, 64, None),
          ("head dim 32", 4, 1024, 16, 16, 32, 32, None),
          ("minicpm3 prefill, MLA", 4, 1024, 40, 40, 96, 64, None)]


def use(csrc: pathlib.Path) -> None:
    """Launch the kernel built from ``csrc/flash_attention.cu`` from now on."""
    build.CSRC = csrc
    build.set_build_dir(build.BUILD_DIR)   # drops the loaded handles


def time_ms(fns, reps: int = 7, inner: int = 10) -> float:
    for f in fns:
        f()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for i in range(inner):
            fns[i % len(fns)]()
        end.record()
        torch.cuda.synchronize()
        out.append(start.elapsed_time(end) / inner)
    return statistics.median(out)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", required=True, type=pathlib.Path,
                    help="another version of csrc/flash_attention.cu")
    ap.add_argument("--dtypes", default="float32,bfloat16")
    args = ap.parse_args(argv)
    dev = resolve_device("cuda")
    mine = build.CSRC
    other = build.BUILD_DIR / "ab_other"
    other.mkdir(parents=True, exist_ok=True)
    shutil.copyfile(args.other, other / "flash_attention.cu")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip())
    gen = torch.Generator(device=dev).manual_seed(0)
    for dtype_name in args.dtypes.split(","):
        dt = getattr(torch, dtype_name)
        for what, B, S, hq, hkv, dk, dv, window in SHAPES:
            def randn(*shape):
                return torch.randn(shape, generator=gen, device=dev).to(dt)
            n_sets = max(2, -(-64 * 2**20 // (B * S * (hq * dk + hkv * (dk + dv)) * dt.itemsize)))
            sets = [(randn(B, S, hq, dk), randn(B, S, hkv, dk), randn(B, S, hkv, dv))
                    for _ in range(n_sets)]
            fns = [lambda s=s: flash_attention(*s, causal=True, window=window) for s in sets]
            ms, outs = {"A": [], "B": []}, {}
            for side in "ABBA":
                use(mine if side == "A" else other)
                outs[side] = flash_attention(*sets[0], causal=True, window=window)
                ms[side].append(time_ms(fns))
            use(mine)
            print(f"[ab_flash] {what} {dtype_name} q ({B},{S},{hq},{dk}) k ({B},{S},{hkv},{dk}) "
                  f"v ({B},{S},{hkv},{dv})" + (f" window {window}" if window else "")
                  + f": A {ms['A'][0]:.4f} / {ms['A'][1]:.4f} ms, B {ms['B'][0]:.4f} / "
                  f"{ms['B'][1]:.4f} ms, B/A {sum(ms['B']) / sum(ms['A']):.4f}; outputs "
                  + ("bitwise equal" if torch.equal(outs["A"], outs["B"]) else
                     f"differ by {(outs['A'] - outs['B']).abs().max().item():.3e}"), flush=True)


if __name__ == "__main__":
    main()
