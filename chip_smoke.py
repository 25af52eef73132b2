#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving paths on one NVIDIA H100 and check them.

    python3 chip_smoke.py

Phases, each fatal (non-zero exit, no result line) on failure:
  1. card    — print ``nvidia-smi`` name and power limit; fail with no card.
  2. build   — nvcc every kernel in ``src/repro_torch/kernels/csrc`` (in
               parallel) into the gitignored ``_build`` directory; count the
               tensor-core instructions (HMMA/HGMMA) of flash attention's bf16
               instantiations in ``cuobjdump --dump-sass`` of the library.
  3. kernels — hold each hand-written kernel against its plain PyTorch
               version on the card, at the reference's test-sweep shapes
               (f32 and bf16) and at each serving path's shapes; time kernel,
               plain version and, where one exists, one PyTorch library call
               computing the same function (a yardstick the port never calls);
               hold flash attention's bf16 kernel and the SSD scan's bf16
               output pass, within their output rounding, to their own
               arithmetic in f32; print decode attention's split-K grid,
               rmsnorm's plan and the scan's grids as the wrappers launched
               them at the served shapes; and the device time alone
               (``torch.profiler``) of rmsnorm against ``F.rms_norm`` and of
               the scan by CUDA kernel.
  4. serve   — for each path, full-width bf16 with random weights from a
               seeded generator: ``Server.generate`` for batch 4 and 64 steps
               with the launch counts set to 0 just before and asserted
               exactly just after; then prefill and teacher-forced decode on
               the kernel path's own tokens against the plain path on the same
               weights, within a stated tolerance.  Paths: internlm2-1.8B
               (prompt 1024) and hymba-1.5B's hybrid attention+SSM blocks
               (prompt 1536: past the 1024 window, so the window mask, a ring
               roll and decode wrapping the ring all run).
  5. report  — a ``kernels`` JSON line, the card line, and as the last line
               ``{"ok": true, "device": {...}}``.

Imports nothing of the JAX package and no jax.
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
import statistics
import subprocess
import sys
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# Reference tolerances (tests/test_kernels.py: f32 3e-5, bf16 2e-2, SSD 5e-5).
TOL = {"float32": 3e-5, "bfloat16": 2e-2}
SSD_TOL = 5e-5
# A bf16 tensor-core kernel against its arithmetic in f32 (scheme_close).
SCHEME_RTOL, SCHEME_ATOL = 2.0 ** -8, 2.0 ** -12
# Published H100 SXM peaks (data sheet, dense): bf16 tensor cores, f32 on
# the CUDA cores, HBM3 bandwidth.
PEAK_BF16, PEAK_F32, PEAK_BYTES = 989e12, 67e12, 3.35e12

SEED = 0
STEPS = 64
# Serving paths: batch, prompt, and the exact launches of one generate of
# STEPS steps (one prefill + STEPS decode steps; a norm per layer for norm1
# and norm2, one more for a hybrid layer's SSM, and the final norm).
PATHS = {
    "internlm2_1p8b": dict(B=4, S=1024, launches={
        "rmsnorm": (2 * 24 + 1) * (1 + STEPS), "flash_attention": 24,
        "decode_attention": 24 * STEPS, "ssd_scan": 0}),
    "hymba_1p5b": dict(B=4, S=1536, launches={
        "rmsnorm": (3 * 32 + 1) * (1 + STEPS), "flash_attention": 32,
        "decode_attention": 32 * STEPS, "ssd_scan": 32 * (1 + STEPS)}),
}
# Kernel-path vs plain-path logits gate in bf16, max|d| / max|plain| at
# prefill and every step.  Both paths round the same f32 results to bf16, so
# they differ by an ulp where summation order moves a value across a rounding
# boundary, and those ulps compound through the layers' residual stream; each
# gate sits at its model's bf16 noise floor, the plain bf16 path's distance
# from the plain f32 path, measured on an H100 (NVIDIA H100 80GB HBM3, 700 W):
# - internlm2 (24 attn layers): plain bf16 vs f32 1.93e-2 at its worst step.
# - hymba (32 hybrid layers): plain bf16 vs f32 1.535e-1 at prefill, growing
#   from 1.3e-2 after layer 1 to 1.7e-1 after layer 32.  On the same weights
#   the plain path alone moves its logits by 8.7e-2 when only the scan's
#   chunk changes (128 for 256), as much as the kernels move them (8.4e-2),
#   so the gate is set from the noise floor, not from the kernels.  Over 64
#   decode steps plain bf16 vs f32 reached 2.1e-1, kernel vs plain 1.3e-1.
GATE = {"internlm2_1p8b": 2e-2, "hymba_1p5b": 1.6e-1}
# The same comparison in f32 (f32 weights, the kernels' f32 instantiations
# against the plain f32 path) has no bf16 rounding to amplify and holds
# rmsnorm, decode attention, the scan and flash attention's f32 kernel to
# their plain versions at full width: hymba's prefill logits agree to 1.6e-4
# (worst layer 4.6e-4; the f32 scan's cumulative log decays reach ~1e3 in
# magnitude, where one f32 ulp is ~1e-4).  Flash attention's bf16 kernel,
# the one that serves, has another instantiation: scheme_close holds it at
# the served shapes to its own arithmetic in f32.
F32_GATE = 2e-3


class SmokeError(RuntimeError):
    pass


def need(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeError(msg)


def time_ms(fns, reps: int = 7, inner: int = 10) -> float:
    """Median over ``reps`` CUDA-event windows of the mean time of ``inner``
    calls (at least one per fn); ``fns`` are cycled so inputs can outgrow the
    50 MB L2."""
    import torch
    inner = max(inner, len(fns))
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


def device_us(fns, calls: int = 30) -> dict:
    """Mean device microseconds of one call by CUDA kernel name, from
    ``torch.profiler``'s device rows over ``calls`` calls that cycle ``fns``
    (so inputs can outgrow the 50 MB L2).  Unlike ``time_ms`` of an eager
    call, no host work counts."""
    import re
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for f in fns:
        f()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(calls):
            fns[i % len(fns)]()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            m = re.search(r"\w+_kernel", e.key)
            name = m.group(0) if m else e.key[:40]
            out[name] = out.get(name, 0.0) + e.self_device_time_total / calls
    need(out != {}, "torch.profiler recorded no device time")
    return out


def close(got, want, dtype_name: str, what: str, tol: float | None = None) -> float:
    import torch
    err = (got.float() - want.float()).abs().max().item()
    tol = TOL[dtype_name] if tol is None else tol
    ok = torch.allclose(got.float(), want.float(), rtol=tol, atol=tol)
    need(ok and bool(torch.isfinite(got.float()).all()),
         f"{what}: kernel vs plain max|d| {err:.3e} beyond rtol=atol={tol}")
    return err


def card_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    need(r.returncode == 0 and r.stdout.strip() != "", f"nvidia-smi failed: {r.stderr}")
    return r.stdout.strip().splitlines()[0]


def nbytes(*ts) -> int:
    """Bytes of the elements of each tensor, read or written once."""
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def finish(rec: dict) -> dict:
    rec["bound_ms"] = max(rec["bytes_ms"], rec["ops_ms"])
    rec["bound_by"] = "bytes" if rec["bytes_ms"] >= rec["ops_ms"] else "operations"
    lib = "none" if rec["library_ms"] is None else f"{rec['library_ms']:.4f} ms"
    print(f"[kernels] {rec['name']} at {rec['shape']}: kernel {rec['ms']:.4f} ms, plain "
          f"{rec['plain_ms']:.4f} ms, library {lib}, bound {rec['bound_ms'] * 1e3:.2f} us "
          f"({rec['bound_by']}), max|d| {rec['max_abs_err']:.3e}", flush=True)
    return rec


def sweeps(torch, randn):
    """The reference's test-sweep shapes (tests/test_kernels.py) plus fully
    masked rows, an empty cache, hymba's head layout (g = 5, D = 64), and for
    the SSD scan a ragged chunk, one decode step, no initial state and the
    production dtype mix."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.chunked import ssd_scan_chunked
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.rmsnorm import rmsnorm
    from repro_torch.kernels.ssm_scan import ssd_scan

    for dt_name, dt in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        for (b, sq, skv, hq, hkv, d, causal, window, off) in [
                (2, 128, 128, 4, 2, 64, True, None, 0), (1, 100, 100, 3, 1, 32, True, None, 0),
                (2, 64, 192, 4, 4, 64, True, None, 128), (1, 256, 256, 8, 2, 64, True, 64, 0),
                (2, 128, 128, 4, 2, 64, False, None, 0), (1, 64, 64, 2, 2, 128, True, None, 0),
                (1, 64, 64, 2, 1, 64, True, 8, 100), (1, 70, 70, 2, 1, 32, True, None, -5),
                (1, 256, 256, 10, 2, 64, True, 64, 0),
                # served head layouts at length (the cp.async ring, causal and
                # window band skipping) and a ragged Sq
                (1, 1024, 1024, 16, 8, 128, True, None, 0),
                (1, 1536, 1536, 25, 5, 64, True, 1024, 0),
                (1, 1000, 1000, 4, 2, 128, True, None, 0)]:
            q, k, v = randn(b, sq, hq, d, dtype=dt), randn(b, skv, hkv, d, dtype=dt), \
                randn(b, skv, hkv, d, dtype=dt)
            kw = dict(causal=causal, window=window, kv_offset=off)
            what = f"flash_attention {dt_name} {(b, sq, skv, hq, hkv, d, causal, window, off)}"
            got = flash_attention(q, k, v, **kw)
            close(got, ref.attention(q, k, v, **kw), dt_name, what)
            if dt == torch.bfloat16:
                scheme_close(got, ref.attention_bf16_scheme(q, k, v, **kw), what)
        for (b, smax, hq, hkv, d, ln) in [(2, 256, 4, 2, 64, 100), (3, 100, 6, 6, 32, 100),
                                          (2, 512, 8, 2, 128, 511), (1, 64, 4, 1, 64, 64),
                                          (2, 96, 4, 2, 64, 0), (2, 256, 25, 5, 64, 200),
                                          # split-K at length: few (b, kvh) pairs, no
                                          # valid slot, hymba's ring
                                          (1, 4096, 8, 1, 128, 4000), (1, 4096, 4, 2, 64, 0),
                                          (4, 1024, 25, 5, 64, 1024)]:
            q, kc, vc = randn(b, hq, d, dtype=dt), randn(b, smax, hkv, d, dtype=dt), \
                randn(b, smax, hkv, d, dtype=dt)
            close(decode_attention(q, kc, vc, ln), ref.decode_attention(q, kc, vc, ln),
                  dt_name, f"decode_attention {dt_name} {(b, smax, hq, hkv, d, ln)}")
        # per-sequence device lengths: splits sized from Smax, some wholly past a length
        q, kc, vc = randn(3, 8, 128, dtype=dt), randn(3, 4096, 2, 128, dtype=dt), \
            randn(3, 4096, 2, 128, dtype=dt)
        lens = torch.tensor([1, 700, 4096], dtype=torch.int32, device="cuda")
        close(decode_attention(q, kc, vc, lens), ref.decode_attention(q, kc, vc, lens),
              dt_name, f"decode_attention {dt_name} per-sequence lengths [1, 700, 4096]")
        for shape in [(4, 37, 256), (2, 8, 64), (1, 1, 512), (4, 3200), (5, 100), (3, 7, 8192)]:
            x, s = randn(*shape, dtype=dt), randn(shape[-1]) * 0.1 + 1
            close(rmsnorm(x, s), ref.rmsnorm(x, s), dt_name, f"rmsnorm {dt_name} {shape}")
            # scale in x's dtype and in the other one
            s2 = s.to(torch.bfloat16 if dt == torch.float32 else torch.float32)
            close(rmsnorm(x, s2), ref.rmsnorm(x, s2), dt_name,
                  f"rmsnorm {dt_name} {shape} scale {s2.dtype}")
        # a contiguous view with a storage offset: not 16-byte aligned, so the
        # plan takes the scalar path
        flat = randn(1 + 6 * 2048, dtype=dt)
        x, s = flat[1:].view(6, 2048), randn(2048) * 0.1 + 1
        close(rmsnorm(x, s), ref.rmsnorm(x, s), dt_name, f"rmsnorm {dt_name} offset view")
        need(rmsnorm.last_plan.vec == 1, f"rmsnorm offset view: plan {rmsnorm.last_plan}")
    q, kc, vc = randn(3, 4, 32), randn(3, 128, 2, 32), randn(3, 128, 2, 32)
    lens = torch.tensor([5, 77, 128], dtype=torch.int32, device="cuda")
    close(decode_attention(q, kc, vc, lens), ref.decode_attention(q, kc, vc, lens),
          "float32", "decode_attention per-sequence lengths")
    print("[kernels] attention and rmsnorm sweeps passed (f32 3e-5, bf16 2e-2; bf16 flash "
          "also within its output rounding of its arithmetic in f32)", flush=True)

    # SSD scan, f32 at 5e-5 against both the sequential oracle and the
    # chunked plain version.  (B, S, H, P, N), chunk.
    cases = ([(shape, chunk) for shape in [(2, 96, 3, 16, 8), (1, 64, 1, 8, 4)]
              for chunk in (16, 32, 40, 96)]
             + [((2, 100, 3, 16, 8), 32), ((2, 1, 3, 16, 8), 256), ((2, 300, 3, 64, 16), 256),
                # S = Q + 1 (a last chunk of one step), many chunks, the widest
                # head and state, and S < Q
                ((2, 257, 3, 64, 16), 256), ((1, 1000, 2, 64, 16), 64),
                ((1, 130, 2, 128, 64), 64), ((1, 70, 2, 100, 32), 256)])
    for (B, S, H, P, N), chunk in cases:
        x, a, b, c, h0 = ssd_inputs(torch, randn, B, S, H, P, N)
        for h in (h0, None):
            y, hf = ssd_scan(x, a, b, c, h, chunk=chunk)
            for plain_name, (py, ph) in (("sequential", ref.ssd_scan(x, a, b, c, h)),
                                         ("chunked", ssd_scan_chunked(x, a, b, c, h, chunk=chunk))):
                what = f"ssd_scan f32 {(B, S, H, P, N)} chunk {chunk} h0 {h is not None} vs {plain_name}"
                close(y, py, "float32", what + " y", SSD_TOL)
                close(hf, ph, "float32", what + " h_final", SSD_TOL)
    # production dtype mix: x and c bf16 (c a slice of the fused b|c
    # projection), a and b f32, h0 f32; y at bf16's 2e-2, h_final at 5e-5 of
    # its magnitude.
    # (B, S, H, P, N), chunk, h0: many chunks, S = Q + 1, one step, and
    # other head and state widths (P 100 takes the unvectorised loads)
    for (B, S, H, P, N), chunk, with_h0 in [
            ((2, 300, 3, 64, 16), 256, True), ((2, 300, 3, 64, 16), 256, False),
            ((2, 257, 3, 64, 16), 256, True), ((2, 1, 3, 64, 16), 256, True),
            ((2, 1, 3, 64, 16), 256, False), ((1, 130, 2, 128, 64), 64, True),
            ((2, 96, 3, 16, 8), 32, False), ((1, 70, 2, 100, 32), 64, True)]:
        x, a, b, c, h0 = ssd_inputs(torch, randn, B, S, H, P, N, mix=True)
        h0 = h0 if with_h0 else None
        y, hf = ssd_scan(x, a, b, c, h0, chunk=chunk)
        case = f"ssd_scan mix {(B, S, H, P, N)} chunk {chunk} h0 {with_h0}"
        for plain_name, (py, ph) in (("sequential", ref.ssd_scan(x, a, b, c, h0)),
                                     ("chunked", ssd_scan_chunked(x, a, b, c, h0, chunk=chunk))):
            close(y, py, "bfloat16", f"{case} vs {plain_name} y")
            ssd_state_close(hf, ph, f"{case} vs {plain_name} h_final")
        if S > 1:  # the tensor-core output pass against its arithmetic in f32
            scheme_close(y, ref.ssd_scan_bf16_scheme(x, a, b, c, h0, chunk=chunk)[0], case)
    torch.cuda.synchronize()
    print("[kernels] ssd_scan sweep passed (f32 5e-5 vs sequential and chunked; "
          "bf16/f32 mix: y 2e-2, h_final 5e-5 relative, y within its output rounding of "
          "the bf16 scheme in f32)", flush=True)


def ssd_inputs(torch, randn, B, S, H, P, N, mix=False):
    """tests/test_kernels.py's distributions (a = sigmoid(normal + 2), b and c
    scaled by 0.3, h0 by 0.2).  ``mix``: the bf16 model's dtypes and layout."""
    x, a = randn(B, S, H, P), torch.sigmoid(randn(B, S, H) + 2.0)
    bc, h0 = randn(B, S, H, 2 * N) * 0.3, randn(B, H, P, N) * 0.2
    if mix:
        bc = bc.bfloat16()
        return x.bfloat16(), a, bc[..., :N].float(), bc[..., N:], h0
    return x, a, bc[..., :N].contiguous(), bc[..., N:].contiguous(), h0


def ssd_state_close(got, want, what: str) -> float:
    err = (got - want).abs().max().item()
    need(err <= SSD_TOL * want.abs().max().item() and bool(got.isfinite().all()),
         f"{what}: max|d| {err:.3e} beyond {SSD_TOL} x max|plain| {want.abs().max().item():.3e}")
    return err


def rmsnorm_record(torch, randn, rows: int, d: int, what: str) -> dict:
    from repro_torch.kernels import ref
    from repro_torch.kernels.rmsnorm import rmsnorm
    F = torch.nn.functional
    # Inputs cycled so a call does not find its input in L2 (> 50 MB in all).
    n_sets = max(2, -(-64 * 2**20 // (rows * d * 2)))
    xs, sc = [randn(rows, d, dtype=torch.bfloat16) for _ in range(n_sets)], \
        (randn(d) * 0.1 + 1).to(torch.bfloat16)
    err = close(rmsnorm(xs[0], sc), ref.rmsnorm(xs[0], sc), "bfloat16", f"rmsnorm {what}")
    xd = randn(4, d, dtype=torch.bfloat16)
    err = max(err, close(rmsnorm(xd, sc), ref.rmsnorm(xd, sc), "bfloat16", f"rmsnorm {what} decode"))
    n = rows * d
    rmsnorm.last_plan = None
    ms = time_ms([lambda x=x: rmsnorm(x, sc) for x in xs])
    plan = rmsnorm.last_plan  # as the wrapper launched it in the timed calls
    print(f"[kernels] rmsnorm plan at {what} ({rows}, {d}): {plan}", flush=True)
    need(plan is not None and plan.vec == 8, f"rmsnorm {what}: not the vector path: {plan}")
    # Device time alone, against F.rms_norm's, in turns: the eager calls
    # timed below are host-bound at these sizes.  Then a decode step's rows.
    dev = {}
    xds = [randn(4, d, dtype=torch.bfloat16) for _ in range(8)]
    for r in range(2):
        for rs, xx in (("", xs), (" decode rows", xds)):
            dev.setdefault("kernel" + rs, []).append(
                sum(device_us([lambda x=x: rmsnorm(x, sc) for x in xx]).values()))
            dev.setdefault("F.rms_norm" + rs, []).append(
                sum(device_us([lambda x=x: F.rms_norm(x, (d,), sc, 1e-5) for x in xx]).values()))
    print(f"[kernels] rmsnorm device us a call at {what} ({rows}, {d}) and (4, {d}), two "
          f"rounds: " + ", ".join(f"{k} {v[0]:.2f} / {v[1]:.2f}" for k, v in dev.items()),
          flush=True)
    return finish(dict(
        name="rmsnorm", shape=f"x ({rows}, {d}) bf16 [{what}]", max_abs_err=err,
        plan=plan._asdict(), device_us=dev, ms=ms,
        plain_ms=time_ms([lambda x=x: ref.rmsnorm(x, sc) for x in xs]),
        library_ms=time_ms([lambda x=x: F.rms_norm(x, (d,), sc, 1e-5) for x in xs]),
        bytes_ms=(2 * n + d) * 2 / PEAK_BYTES * 1e3, ops_ms=4 * n / PEAK_F32 * 1e3))


def flash_record(torch, randn, B, S, hq, hkv, hd, window, what: str) -> dict:
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention
    F = torch.nn.functional
    bf = torch.bfloat16
    q, k, v = randn(B, S, hq, hd, dtype=bf), randn(B, S, hkv, hd, dtype=bf), \
        randn(B, S, hkv, hd, dtype=bf)
    kw = dict(causal=True, window=window)
    got = flash_attention(q, k, v, **kw)
    err = close(got, ref.attention(q, k, v, **kw), "bfloat16", f"flash_attention {what}")
    scheme_close(got, ref.attention_bf16_scheme(q, k, v, **kw), f"flash_attention {what}")
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    # the causal (and windowed) mask; its unmasked (query, key) pairs count
    i = torch.arange(S, device="cuda")
    band = (i[None, :] <= i[:, None]) & (i[None, :] > i[:, None] - (window or S))
    pairs = int(band.sum())

    def lib():
        if window is None:
            return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=True)
        return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=band, enable_gqa=True)

    return finish(dict(
        name="flash_attention", max_abs_err=err,
        shape=f"q ({B},{S},{hq},{hd}), k/v ({B},{S},{hkv},{hd}) bf16 causal"
              + (f" window {window}" if window else "") + f" [{what}]",
        ms=time_ms([lambda: flash_attention(q, k, v, **kw)], reps=5, inner=3),
        plain_ms=time_ms([lambda: ref.attention(q, k, v, **kw)], reps=5, inner=3),
        library_ms=time_ms([lib], reps=5, inner=3),
        bytes_ms=(2 * B * S * hq * hd + 2 * B * S * hkv * hd) * 2 / PEAK_BYTES * 1e3,
        ops_ms=4 * B * hq * hd * pairs / PEAK_BF16 * 1e3))


def scheme_close(got, want32, what: str) -> None:
    """A bf16 tensor-core kernel against its own arithmetic in f32 (the plain
    ``ref.attention_bf16_scheme`` for flash attention,
    ``ref.ssd_scan_bf16_scheme`` for the scan's output pass): within the
    kernel's one rounding of the output to bf16 (half an ulp, at most 2^-8
    of the value) plus ``SCHEME_ATOL`` of max|out| for f32 summation order,
    far below the output's typical size; the bf16 sweep's 2e-2 is not."""
    d = (got.float() - want32).abs()
    lim = SCHEME_RTOL * want32.abs() + SCHEME_ATOL * want32.abs().max()
    ratio = (d / lim).max().item()
    print(f"[kernels] {what} vs the bf16 scheme in f32: max|d| {d.max().item():.3e}, "
          f"max|d| / (2^-8 |ref| + 2^-12 max|ref|) {ratio:.3f}", flush=True)
    need(ratio <= 1 and bool(got.float().isfinite().all()),
         f"{what}: beyond the bf16 scheme by {ratio:.3f} of its rounding tolerance")


def decode_record(torch, randn, B, smax, L, hq, hkv, hd, what: str) -> dict:
    from repro_torch.kernels import ref
    from repro_torch.kernels.decode_attention import decode_attention
    F = torch.nn.functional
    bf = torch.bfloat16
    # Cache sets cycled so each call finds its cache cold, as each layer's
    # cache is on the serving path.
    n_sets = max(2, -(-128 * 2**20 // (2 * B * smax * hkv * hd * 2)))
    sets = [(randn(B, hq, hd, dtype=bf), randn(B, smax, hkv, hd, dtype=bf),
             randn(B, smax, hkv, hd, dtype=bf)) for _ in range(n_sets)]
    q, kc, vc = sets[0]
    err = close(decode_attention(q, kc, vc, L), ref.decode_attention(q, kc, vc, L),
                "bfloat16", f"decode_attention {what}")
    valid = (torch.arange(smax, device="cuda") < L)[None, None, None, :].expand(B, 1, 1, -1)
    lib_sets = [(q.unsqueeze(2), kc.transpose(1, 2).contiguous(), vc.transpose(1, 2).contiguous())
                for (q, kc, vc) in sets]
    decode_attention.last_grid = None
    ms = time_ms([lambda s=s: decode_attention(*s, L) for s in sets])
    # the split kernel's grid as the wrapper launched it in the timed calls
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    need(decode_attention.last_grid is not None, f"decode_attention {what}: no grid recorded")
    bh, splits = decode_attention.last_grid
    grid = bh * splits
    print(f"[kernels] decode_attention grid at {what}: B*Hkv*splits = {bh}*{splits} = "
          f"{grid} blocks on {n_sm} SMs (as launched)", flush=True)
    need(grid > n_sm, f"decode_attention {what}: grid {grid} does not exceed {n_sm} SMs")
    return finish(dict(
        name="decode_attention", max_abs_err=err, grid=grid,
        shape=f"q ({B},{hq},{hd}), caches ({B},{smax},{hkv},{hd}) bf16, {L} valid [{what}]",
        ms=ms,
        plain_ms=time_ms([lambda s=s: ref.decode_attention(*s, L) for s in sets]),
        library_ms=time_ms([lambda s=s: F.scaled_dot_product_attention(
            *s, attn_mask=valid, enable_gqa=True) for s in lib_sets]),
        bytes_ms=(2 * B * L * hkv * hd * 2 + 2 * B * hq * hd * 2 + B * 4) / PEAK_BYTES * 1e3,
        ops_ms=4 * B * hq * hd * L / PEAK_BF16 * 1e3))


def ssd_record(torch, randn, B, S, H, P, N, chunk, with_h0: bool, what: str) -> dict:
    """The SSD scan at a serving shape, in the bf16 model's dtype mix.  No
    single PyTorch call computes it, so ``library_ms`` is None."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.chunked import ssd_scan_chunked
    from repro_torch.kernels.ssm_scan import ssd_scan

    def one_set():
        x, a, b, c, h0 = ssd_inputs(torch, randn, B, S, H, P, N, mix=True)
        return x, a, b, c, h0 if with_h0 else None

    # Input sets cycled so a call finds its inputs cold (> 50 MB in all), as
    # each layer's are on the serving path.
    sets = [one_set()]
    sets += [one_set() for _ in range(min(63, -(-64 * 2**20 // nbytes(*sets[0]))))]
    x, a, b, c, h0 = sets[0]
    y, hf = ssd_scan(x, a, b, c, h0, chunk=chunk)
    err = 0.0
    for plain_name, (py, ph) in (("chunked", ssd_scan_chunked(x, a, b, c, h0, chunk=chunk)),
                                 ("sequential", ref.ssd_scan(x, a, b, c, h0))):
        err = max(err, close(y, py, "bfloat16", f"ssd_scan {what} vs {plain_name} y"))
        ssd_state_close(hf, ph, f"ssd_scan {what} vs {plain_name} h_final")
    if S > 1:  # the tensor-core output pass against its arithmetic in f32
        scheme_close(y, ref.ssd_scan_bf16_scheme(x, a, b, c, h0, chunk=chunk)[0],
                     f"ssd_scan {what}")
    # Operations of the causal form this run's chunks need: per (batch,
    # head) and chunk of L steps, L(L+1)/2 gate entries of 2N flops and
    # their product with X (2P flops each), and 2LPN flops each for the
    # inter-chunk term and the state update.  Counted at the bf16
    # tensor-core peak: the least time any type of this work could take.
    Q = min(chunk, S)
    lens = [min(Q, S - s0) for s0 in range(0, S, Q)]
    flops = B * H * sum(L * (L + 1) * (N + P) + 4 * L * P * N for L in lens)
    reps, inner = (5, 3) if S > 1 else (7, 10)
    ssd_scan.last_grid = None
    ms = time_ms([lambda s=s: ssd_scan(*s, chunk=chunk) for s in sets], reps, inner)
    grid = ssd_scan.last_grid  # as the wrapper launched it in the timed calls
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    print(f"[kernels] ssd_scan grids at {what}: (chunk states, carry, outputs) = {grid} "
          f"blocks on {n_sm} SMs (as launched; (0, 0, n) is the single-step kernel)", flush=True)
    need(grid is not None and (S == 1) == (grid[:2] == (0, 0)),
         f"ssd_scan {what}: grid {grid} is not the {'step' if S == 1 else 'chunked'} path's")
    need(S == 1 or min(grid[0], grid[2]) > 2 * n_sm,
         f"ssd_scan {what}: grids {grid} do not exceed twice the {n_sm} SMs")
    dev = device_us([lambda s=s: ssd_scan(*s, chunk=chunk) for s in sets], 10 if S > 1 else 30)
    print(f"[kernels] ssd_scan device us a call at {what}: {sum(dev.values()):.2f} ("
          + ", ".join(f"{k} {v:.2f}" for k, v in sorted(dev.items(), key=lambda kv: -kv[1]))
          + ")", flush=True)
    return finish(dict(
        name="ssd_scan", max_abs_err=err, grid=list(grid), device_us=dev,
        shape=f"x ({B},{S},{H},{P}) bf16, a f32, b ({B},{S},{H},{N}) f32, c bf16, "
              f"chunk {chunk}, h0 {'f32' if with_h0 else 'none'} [{what}]",
        ms=ms,
        plain_ms=time_ms([lambda s=s: ssd_scan_chunked(*s, chunk=chunk) for s in sets],
                         reps, inner),
        library_ms=None,
        bytes_ms=(nbytes(x, a, b, c, h0) + nbytes(y, hf)) / PEAK_BYTES * 1e3,
        ops_ms=flops / PEAK_BF16 * 1e3))


def tensor_core_count() -> dict:
    """HMMA/HGMMA (tensor-core) and FFMA instructions per kernel function of
    the built flash-attention library, from ``cuobjdump --dump-sass``."""
    import collections
    import shutil
    from repro_torch.kernels import build
    lib = build._lib_path(build.CSRC / "flash_attention.cu")
    tool = shutil.which("cuobjdump") or str(pathlib.Path(build._nvcc()).parent / "cuobjdump")
    r = subprocess.run([tool, "--dump-sass", str(lib)], capture_output=True, text=True,
                       timeout=300)
    need(r.returncode == 0, f"cuobjdump --dump-sass {lib.name} failed: {r.stderr[-2000:]}")
    counts, fn = collections.defaultdict(collections.Counter), None
    for line in r.stdout.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
        elif fn is not None:
            for op in ("HGMMA", "HMMA", "FFMA"):
                if f" {op}." in line or f" {op} " in line:
                    counts[fn][op] += 1
    bf16 = {f: c for f, c in counts.items() if "flash_fwd_bf16_kernel" in f}
    f32 = {f: c for f, c in counts.items() if "flash_fwd_f32_kernel" in f}
    n_tc = sum(c["HMMA"] + c["HGMMA"] for c in bf16.values())
    print(f"[build] flash_attention bf16 instantiations: {len(bf16)} functions, {n_tc} "
          f"tensor-core instructions (HMMA/HGMMA) by function "
          f"{[c['HMMA'] + c['HGMMA'] for c in bf16.values()]}, FFMA "
          f"{[c['FFMA'] for c in bf16.values()]}; f32 instantiations: HMMA "
          f"{[c['HMMA'] + c['HGMMA'] for c in f32.values()]}, FFMA "
          f"{[c['FFMA'] for c in f32.values()]}", flush=True)
    need(len(bf16) == 3 and all(c["HMMA"] + c["HGMMA"] > 0 for c in bf16.values()),
         f"flash_attention bf16 instantiations without tensor-core instructions: {dict(bf16)}")
    return {"hmma_bf16": n_tc}


def kernel_phase(torch, gen) -> dict:
    """Parity sweeps, then parity and timing at each serving path's shapes.
    Returns, per kernel, its records: the first is the kernel's main record
    (the first path that runs it), the rest are further serving shapes."""
    def randn(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    sweeps(torch, randn)
    i2, hy = PATHS["internlm2_1p8b"], PATHS["hymba_1p5b"]
    L_i2, L_hy = i2["S"] + STEPS, hy["S"] + STEPS   # the last step's valid slots
    recs = {
        # internlm2-1.8B: d 2048, 16 query heads, 8 KV heads of 128, B 4, S 1024;
        # the decode cache has max_len = S + STEPS + 1 slots.
        "rmsnorm": [rmsnorm_record(torch, randn, i2["B"] * i2["S"], 2048, "internlm2 prefill"),
                    rmsnorm_record(torch, randn, hy["B"] * hy["S"], 1600, "hymba prefill d"),
                    rmsnorm_record(torch, randn, hy["B"] * hy["S"], 3200,
                                   "hymba prefill SSM inner")],
        "flash_attention": [
            flash_record(torch, randn, i2["B"], i2["S"], 16, 8, 128, None, "internlm2 prefill"),
            flash_record(torch, randn, hy["B"], hy["S"], 25, 5, 64, 1024, "hymba prefill")],
        "decode_attention": [
            decode_record(torch, randn, i2["B"], L_i2 + 1, L_i2, 16, 8, 128,
                          "internlm2 last step"),
            # hymba's SWA ring: 1024 slots, all valid once the prompt passed the window
            decode_record(torch, randn, hy["B"], 1024, 1024, 25, 5, 64, "hymba ring")],
        # hymba: 50 SSM heads of P 64, N 16, chunk 256
        "ssd_scan": [ssd_record(torch, randn, hy["B"], hy["S"], 50, 64, 16, 256, False,
                                "hymba prefill"),
                     ssd_record(torch, randn, hy["B"], 1, 50, 64, 16, 256, True,
                                "hymba decode step")],
    }
    torch.cuda.synchronize()
    return recs


def serve_phase(torch, arch: str) -> dict:
    """One full-width generate with exact launch counts, then the kernel path
    against the plain path (and, for information, the plain path in f32)."""
    from repro_torch import configs as C
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.rmsnorm import rmsnorm
    from repro_torch.kernels.ssm_scan import ssd_scan
    from repro_torch.models import init_params
    from repro_torch.runtime import ServeConfig, Server, make_decode_step, make_prefill_step

    B, S, want, gate = PATHS[arch]["B"], PATHS[arch]["S"], PATHS[arch]["launches"], GATE[arch]
    max_len = S + STEPS + 1
    cfg = C.production_cfg(C.get_config(arch))
    t0 = time.perf_counter()
    params = init_params(SEED, cfg, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    print(f"[serve {arch}] full width bf16: {cfg.n_layers} {'/'.join(cfg.block_pattern)} "
          f"layers, d {cfg.d_model}, {n_params / 1e9:.3f} B params, init "
          f"{time.perf_counter() - t0:.1f} s; batch {B}, prompt {S}, {STEPS} steps", flush=True)
    prompts = np.random.default_rng(SEED).integers(0, cfg.vocab, (B, S), dtype=np.int32)
    srv = Server(cfg, params, ServeConfig(max_len=max_len, batch_size=B), device="cuda")

    srv.generate(prompts, steps=2)  # warm-up: first cuBLAS calls at these shapes
    kernels = {"rmsnorm": rmsnorm, "flash_attention": flash_attention,
               "decode_attention": decode_attention, "ssd_scan": ssd_scan}
    for fn in kernels.values():
        fn.n_launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = srv.generate(prompts, steps=STEPS)  # ends in a copy to the host
    gen_s = time.perf_counter() - t0
    launches = {name: fn.n_launches for name, fn in kernels.items()}
    print(f"[serve {arch}] generate {out.shape} in {gen_s:.3f} s; launches {launches}; peak "
          f"device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    need(launches == want, f"{arch}: kernel launches {launches} != expected {want}")
    need(out.shape == (B, STEPS) and out.dtype == np.int32
         and bool(((out >= 0) & (out < cfg.vocab)).all()), f"bad generated ids {out.shape}")

    # Kernel path vs plain path on the same weights: prefill, then decode
    # teacher-forced on the kernel path's own tokens, gated by GATE.  The
    # same two paths in f32 on the same (upcast) weights are gated by
    # F32_GATE; for information, both bf16 paths are also held against the
    # plain f32 path: the bf16 noise floor.
    cfg32 = dataclasses.replace(cfg, param_dtype="float32", compute_dtype="float32")
    params32 = _tree_map(params, lambda t: t.float())
    paths = {"kernel": (make_prefill_step(cfg, max_len), make_decode_step(cfg), params),
             "plain": (make_prefill_step(cfg, max_len, plain=True),
                       make_decode_step(cfg, plain=True), params),
             "kernel32": (make_prefill_step(cfg32, max_len), make_decode_step(cfg32), params32),
             "f32": (make_prefill_step(cfg32, max_len, plain=True),
                     make_decode_step(cfg32, plain=True), params32)}
    gates = {"kernel-plain": gate, "kernel32-f32": F32_GATE}
    toks = torch.as_tensor(prompts.astype(np.int64), device="cuda")
    gen_ids = torch.as_tensor(out.astype(np.int64), device="cuda")
    rel = {"kernel-plain": [], "kernel32-f32": [], "kernel-f32": [], "plain-f32": []}
    agree, dec_ms, caches = [], [], {}

    def compare(logits, what):
        need(all(t.shape == (B, cfg.vocab) and bool(torch.isfinite(t).all())
                 for t in logits.values()), f"{what}: logits not finite or not {(B, cfg.vocab)}")
        for pair in rel:
            a, b = pair.split("-")
            rel[pair].append(((logits[a] - logits[b]).abs().max()
                              / logits[b].abs().max()).item())

    with torch.inference_mode():
        prefill_kernel, _, _ = paths["kernel"]
        prefill_kernel(params, {"tokens": toks})  # warm-up: the timed prefill allocates nothing new
        logits = {}
        for name, (prefill, _, prm) in paths.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits[name], caches[name] = prefill(prm, {"tokens": toks})
            torch.cuda.synchronize()
            if name == "kernel":
                prefill_ms = (time.perf_counter() - t0) * 1e3
        compare(logits, "prefill")
        agree.append(logits["plain"].argmax(-1) == gen_ids[:, 0])
        for i in range(STEPS):
            tok = gen_ids[:, i:i + 1]
            for name, (_, decode, prm) in paths.items():
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                logits[name], caches[name] = decode(prm, tok, caches[name], S + i)
                torch.cuda.synchronize()
                if name == "kernel":
                    dec_ms.append((time.perf_counter() - t0) * 1e3)
            compare(logits, f"decode step {i}")
            if i + 1 < STEPS:
                agree.append(logits["plain"].argmax(-1) == gen_ids[:, i + 1])
    share = torch.cat(agree).float().mean().item()
    dec_med = statistics.median(dec_ms)
    for pair, v in rel.items():
        worst = max(range(len(v)), key=v.__getitem__)
        print(f"[serve {arch}] logits {pair}: max|d| / max|ref| prefill {v[0]:.3e}, decode "
              f"median {statistics.median(v[1:]):.3e}, worst {v[worst]:.3e} at "
              + ("prefill" if worst == 0 else f"step {worst - 1}")
              + (f" (gate {gates[pair]})" if pair in gates else " (information)"), flush=True)
    for pair, g in gates.items():  # every number is printed before a gate fails
        need(max(rel[pair]) <= g, f"{arch}: logits {pair} max|d| / max|ref| reached "
             f"{max(rel[pair]):.3e} > {g}")
    print(f"[serve {arch}] greedy ids agreeing with the plain path: {share:.4f} "
          f"(information, not a gate: bf16 near-ties may flip an argmax)", flush=True)
    print(f"[serve {arch}] prefill {prefill_ms:.2f} ms (B {B}, S {S}); decode median "
          f"{dec_med:.3f} ms/step, {B * 1e3 / dec_med:.1f} tokens/s; generate wall "
          f"{gen_s:.3f} s = {B * STEPS / gen_s:.1f} generated tokens/s", flush=True)
    return launches


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, list):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _tree_map(tree, fn):
    if isinstance(tree, dict):
        return {k: _tree_map(v, fn) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_map(v, fn) for v in tree]
    return fn(tree)


SOURCES = {  # kernel -> (CUDA source, the TPU kernel it replaces)
    "rmsnorm": ("src/repro_torch/kernels/csrc/rmsnorm.cu", "src/repro/kernels/rmsnorm.py:19"),
    "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:26"),
    "decode_attention": ("src/repro_torch/kernels/csrc/decode_attention.cu",
                         "src/repro/kernels/decode_attention.py:24"),
    "ssd_scan": ("src/repro_torch/kernels/csrc/ssm_scan.cu", "src/repro/kernels/ssm_scan.py:25"),
}
TIMES = ("shape", "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
EXTRAS = ("grid", "plan", "device_us")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this check needs the card",
              file=sys.stderr)
        return 1
    # Outside a checkout of the repo this import fails before anything is printed.
    from repro_torch.device import resolve_device
    from repro_torch.kernels import build
    card = card_line()
    print(card, flush=True)

    resolve_device("cuda")  # TF32 off for the plain f32 comparisons
    print(f"[build] nvcc {' '.join(build.NVCC_FLAGS)}: "
          f"{build.build_all():.1f} s", flush=True)
    tensor_core_count()

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    recs = kernel_phase(torch, gen)
    torch.cuda.empty_cache()  # the serve phase times prefill: no allocator churn
    by_path = {}
    for arch in PATHS:
        by_path[arch] = serve_phase(torch, arch)
        torch.cuda.empty_cache()
    for name in SOURCES:
        need(any(by_path[arch][name] for arch in PATHS), f"{name} launched on no serving path")

    line = {"kernels": [
        {"name": name, "route": "cuda", "source": SOURCES[name][0],
         "replaces": SOURCES[name][1],
         "launches": sum(by_path[arch][name] for arch in PATHS),
         **{k: recs[name][0][k] for k in TIMES},
         "launches_by_path": {arch: by_path[arch][name] for arch in PATHS},
         "more_shapes": [{k: r[k] for k in TIMES + EXTRAS if k in r} for r in recs[name][1:]],
         **{k: recs[name][0][k] for k in EXTRAS if k in recs[name][0]}}
        for name in SOURCES]}
    print(json.dumps(line))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
