"""Where the serving time goes on the card: one prefill and a run of decode
steps of the full-width bf16 model under ``torch.profiler``.

    PYTHONPATH=src python -m repro_torch.launch.profile_serve \\
        --arch internlm2_1p8b --batch 4 --prompt-len 1024 --steps 16
    PYTHONPATH=src python -m repro_torch.launch.profile_serve \\
        --arch hymba_1p5b --batch 4 --prompt-len 1536 --steps 16
    PYTHONPATH=src python -m repro_torch.launch.profile_serve \\
        --arch minicpm3_4b --batch 4 --prompt-len 1024 --steps 16
    PYTHONPATH=src python -m repro_torch.launch.profile_serve \\
        --arch granite_moe_3b --batch 4 --prompt-len 1024 --steps 16
    PYTHONPATH=src python -m repro_torch.launch.profile_serve \\
        --arch xlstm_1p3b --batch 4 --prompt-len 1024 --steps 16
    PYTHONPATH=src python -m repro_torch.launch.profile_serve \\
        --arch h2o_danube3_4b --batch 4 --prompt-len 4608 --steps 16
    PYTHONPATH=src python -m repro_torch.launch.profile_serve \\
        --arch phi3_vision_4p2b --batch 4 --prompt-len 1024 --steps 16

Prints, for prefill and for decode, the host wall time (ended by a
synchronise) with and without the profiler, the summed device time of all
kernels, the device's idle share (1 - device / unprofiled wall: one stream,
so kernels do not overlap) and the kernels' device time grouped as the
port's hand-written kernels, matrix products, and everything else.
"""

from __future__ import annotations

import argparse
import collections
import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from .. import configs as C
from ..device import resolve_device
from ..models import init_params
from ..runtime import ServeConfig, Server, make_decode_step, make_prefill_step

# Kernel-name fragments of each group (the port's kernels are named in csrc/).
GROUPS = (("rmsnorm", ("rmsnorm_kernel", "rmsnorm_vec_kernel")),
          ("rmsnorm_bwd", ("rmsnorm_bwd_kernel", "rmsnorm_dscale_kernel")),
          ("flash_attention", ("flash_fwd_bf16_kernel", "flash_fwd_f32_kernel")),
          ("flash_attention_bwd", ("flash_bwd_dsum_kernel", "flash_bwd_dkdv_bf16_kernel",
                                   "flash_bwd_dkdv_f32_kernel", "flash_bwd_dq_bf16_kernel",
                                   "flash_bwd_dq_f32_kernel")),
          ("decode_attention", ("decode_split_kernel", "decode_combine_kernel")),
          ("ssd_scan", ("ssd_chunk_state_kernel", "ssd_carry_kernel", "ssd_output_kernel",
                        "ssd_output_tc_kernel", "ssd_step_kernel")),
          ("ssd_scan_bwd", ("ssd_bwd_state_kernel", "ssd_bwd_carry_kernel", "ssd_bwd_tile_kernel",
                            "ssd_bwd_da_kernel")),
          ("dp_sweep", ("dp_sweep_kernel",)),
          ("matmul", ("gemm", "gemv", "xmma", "cutlass", "sm90_", "nvjet")))


def _group(name: str) -> str:
    for group, keys in GROUPS:
        if any(k in name for k in keys):
            return group
    return "other"


def _device_us(prof) -> tuple[float, dict[str, float], dict[str, int],
                              list[tuple[str, float, int]]]:
    """Summed device time of all kernels (us), and by group, the kernels'
    device time and launches; and the top kernels by device time with their
    call counts.  Only device-side events count: a host op's row also
    carries the time of the kernels it launched."""
    total, groups, counts, rows = 0.0, collections.Counter(), collections.Counter(), []
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        us = e.self_device_time_total
        total += us
        groups[_group(e.key)] += us
        counts[_group(e.key)] += e.count
        rows.append((e.key, us, e.count))
    rows.sort(key=lambda r: -r[1])
    return total, dict(groups), dict(counts), rows[:8]


def _report(what: str, bare_s: float, wall_s: float, prof, n: int) -> None:
    """``bare_s``: the same work's wall without the profiler, whose host cost
    would otherwise count as device idle time.  Per group: device ms per
    call, share, and CUDA kernel launches per call with the mean device us
    per launch."""
    dev_us, groups, counts, top = _device_us(prof)
    print(f"[profile] {what}: wall {bare_s * 1e3 / n:.3f} ms unprofiled "
          f"({wall_s * 1e3 / n:.3f} ms profiled), kernels {dev_us / n / 1e3:.3f} ms per call; "
          f"device idle share {1 - dev_us / (bare_s * 1e6):.3f}")
    for g, us in sorted(groups.items(), key=lambda kv: -kv[1]):
        print(f"[profile]   {g:17s} {us / n / 1e3:8.3f} ms/call  {us / dev_us:6.1%}  "
              f"{counts[g] / n:7.1f} kernels/call, {us / max(counts[g], 1):9.3f} us each")
    for name, us, count in top:
        print(f"[profile]     {us / n / 1e3:8.3f} ms/call  x{count // n:<4d} {name[:90]}")


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="internlm2_1p8b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=1024)
    ap.add_argument("--steps", type=int, default=16)
    args = ap.parse_args(argv)

    dev = resolve_device("cuda")
    cfg = C.production_cfg(C.get_config(args.arch))
    B, S, steps = args.batch, args.prompt_len, args.steps
    max_len = S + steps + 1
    params = init_params(0, cfg, device=dev)
    prompts = np.random.default_rng(0).integers(0, cfg.vocab, (B, S), dtype=np.int32)
    # warm-up: first launches, cuBLAS handles, kernel builds
    Server(cfg, params, ServeConfig(max_len=max_len, batch_size=B), device=dev).generate(
        prompts, 2)
    prefill, decode = make_prefill_step(cfg, max_len), make_decode_step(cfg)
    toks = torch.as_tensor(prompts.astype(np.int64), device=dev)
    print(f"[profile] {cfg.name} bf16 full width on {torch.cuda.get_device_name(dev)}: "
          f"B {B}, prompt {S}, {steps} decode steps")

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    def decode_steps(logits, cache):
        for i in range(steps):
            logits, cache = decode(params, logits.argmax(-1)[:, None], cache, S + i)
        return logits

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with torch.inference_mode():
        (logits, cache), bare_prefill = timed(lambda: prefill(params, {"tokens": toks}))
        _, bare_decode = timed(lambda: decode_steps(logits, cache))
        with profile(activities=acts) as prof:
            (logits, cache), wall = timed(lambda: prefill(params, {"tokens": toks}))
        _report("prefill", bare_prefill, wall, prof, 1)
        with profile(activities=acts) as prof:
            _, wall = timed(lambda: decode_steps(logits, cache))
        _report("decode step", bare_decode, wall, prof, steps)


if __name__ == "__main__":
    main()
