"""Flash attention built from this checkout's source beside the same kernel
built from another version of ``csrc/flash_attention.cu``, timed in one
process on one card, in the order A B B A, at the served shapes.

    python -m repro_torch.launch.ab_flash --other PATH/flash_attention.cu [--prefill-32k]
    python -m repro_torch.launch.ab_flash --bwd --other PATH/flash_attention_bwd.cu

A is this checkout's source, B the other one, built with the headers
(``*.cuh``) beside it where its directory has any (another checkout's
``csrc``), else with this checkout's.  Each shape prints both versions'
milliseconds a call in each round (CUDA events, the median of 7 windows of
10 calls over inputs cycled past the 50 MB L2) and whether the two outputs
are bitwise equal, else their largest difference.  ``--prefill-32k`` adds
internlm2's prefill_32k cell at the dry-run's batch, q (13, 32768, 16, 128),
in bf16, at 3 windows of 2 calls (a call takes tenths of a second).  With
``--bwd``, the backward
(``flash_attention_bwd``, bf16, causal) at internlm2's, phi3-vision's and
granite's train shapes, on o and lse from this checkout's forward: each
version's microseconds a call (windows of 3 calls) and the largest |dq, dk,
dv| difference between the two (they sum in different orders, so they are
not held to bitwise equality).  Needs the card and ``nvcc``.
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

# (what, B, S, Hq, Hkv, D): the backward's train shapes (causal, bf16)
BWD_SHAPES = [("internlm2 train", 2, 4096, 16, 8, 128),
              ("phi3-vision train", 1, 4096, 32, 32, 96),
              ("granite train", 1, 4096, 24, 8, 64)]
# (what, B, S, Hq, Hkv, DK, DV, window)
SHAPES = [("internlm2 prefill", 4, 1024, 16, 8, 128, 128, None),
          ("hymba prefill", 4, 1536, 25, 5, 64, 64, 1024),
          ("granite prefill", 4, 1024, 24, 8, 64, 64, None),
          ("head dim 32", 4, 1024, 16, 16, 32, 32, None),
          ("minicpm3 prefill, MLA", 4, 1024, 40, 40, 96, 64, None),
          ("phi3-vision prefill", 4, 1024, 32, 32, 96, 96, None),
          ("danube prefill", 4, 4608, 32, 8, 120, 120, 4096)]
# internlm2's prefill_32k at the dry-run's max_batch: (what, B, S, Hq, Hkv, DK, DV, window)
PREFILL_32K = ("internlm2 prefill_32k", 13, 32768, 16, 8, 128, 128, None)


def use(csrc: pathlib.Path) -> None:
    """Launch the kernels built from the sources in ``csrc`` from now on."""
    build.CSRC = csrc
    build.set_build_dir(build.BUILD_DIR)   # drops the loaded handles


def bwd_main(mine: pathlib.Path, other: pathlib.Path, dev) -> None:
    """The --bwd comparison (see the module note)."""
    from repro_torch.kernels.flash_attention import _forward, flash_attention_bwd
    gen = torch.Generator(device=dev).manual_seed(0)
    for what, B, S, hq, hkv, d in BWD_SHAPES:
        def randn(*shape):
            return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
        per_set = B * S * (3 * hq + 2 * hkv) * d * 2
        sets = []
        for _ in range(max(2, -(-64 * 2**20 // per_set))):
            q, k, v, do = randn(B, S, hq, d), randn(B, S, hkv, d), randn(B, S, hkv, d), \
                randn(B, S, hq, d)
            o, lse = _forward(q, k, v, True, None, d ** -0.5, 0, True)
            sets.append((q, k, v, o, lse, do))
        fns = [lambda s=s: flash_attention_bwd(*s, causal=True) for s in sets]
        us, grads = {"A": [], "B": []}, {}
        for side in "ABBA":
            use(mine if side == "A" else other)
            grads[side] = flash_attention_bwd(*sets[0], causal=True)
            us[side].append(time_ms(fns, reps=7, inner=3) * 1e3)
        use(mine)
        diff = max((a.float() - b.float()).abs().max().item()
                   for a, b in zip(grads["A"], grads["B"]))
        print(f"[ab_flash] backward {what} q ({B},{S},{hq},{d}) k/v ({B},{S},{hkv},{d}) bf16 "
              f"causal: A {us['A'][0]:.2f} / {us['A'][1]:.2f} us, B {us['B'][0]:.2f} / "
              f"{us['B'][1]:.2f} us, B/A {sum(us['B']) / sum(us['A']):.4f}; max |dq, dk, dv| "
              f"difference {diff:.3e}", flush=True)


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
                    help="another version of csrc/flash_attention.cu (with --bwd: of "
                         "csrc/flash_attention_bwd.cu)")
    ap.add_argument("--bwd", action="store_true", help="compare the backward")
    ap.add_argument("--dtypes", default="float32,bfloat16")
    ap.add_argument("--prefill-32k", action="store_true",
                    help="also time internlm2's prefill_32k shape in bf16 (3 windows of 2 calls)")
    args = ap.parse_args(argv)
    dev = resolve_device("cuda")
    mine = build.CSRC
    other = build.BUILD_DIR / ("ab_other_bwd" if args.bwd else "ab_other")
    other.mkdir(parents=True, exist_ok=True)
    headers = sorted(args.other.parent.glob("*.cuh")) or sorted(mine.glob("*.cuh"))
    for header in headers:  # the headers the other source was written against
        shutil.copyfile(header, other / header.name)
    shutil.copyfile(args.other,
                    other / ("flash_attention_bwd.cu" if args.bwd else "flash_attention.cu"))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip())
    if args.bwd:
        bwd_main(mine, other, dev)
        return
    gen = torch.Generator(device=dev).manual_seed(0)
    runs = [(name, shape, 7, 10) for name in args.dtypes.split(",") for shape in SHAPES]
    if args.prefill_32k:
        runs.append(("bfloat16", PREFILL_32K, 3, 2))
    for dtype_name, (what, B, S, hq, hkv, dk, dv, window), reps, inner in runs:
        dt = getattr(torch, dtype_name)

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
            ms[side].append(time_ms(fns, reps=reps, inner=inner))
        use(mine)
        print(f"[ab_flash] {what} {dtype_name} q ({B},{S},{hq},{dk}) k ({B},{S},{hkv},{dk}) "
              f"v ({B},{S},{hkv},{dv})" + (f" window {window}" if window else "")
              + f": A {ms['A'][0]:.4f} / {ms['A'][1]:.4f} ms, B {ms['B'][0]:.4f} / "
              f"{ms['B'][1]:.4f} ms, B/A {sum(ms['B']) / sum(ms['A']):.4f}; outputs "
              + ("bitwise equal" if torch.equal(outs["A"], outs["B"]) else
                 f"differ by {(outs['A'] - outs['B']).abs().max().item():.3e}"), flush=True)
        del sets, fns, outs
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
