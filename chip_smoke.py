#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving, parallel, training, dry-run,
placement and swarm paths on one NVIDIA H100 and check them.

    python3 chip_smoke.py

Phases, each fatal (non-zero exit, no result line) on failure:
  1. card    — print ``nvidia-smi`` name and power limit; fail with no card.
  2. build   — nvcc every kernel in ``src/repro_torch/kernels/csrc`` (in
               parallel) into the gitignored ``_build`` directory; count the
               tensor-core instructions (HMMA/HGMMA) of flash attention's bf16
               instantiations (one per (K, V) head-dim pair, MLA's (96, 64)
               and the padded (120, 120) among them) in ``cuobjdump
               --dump-sass`` of the library, and require Hopper's (HGMMA,
               no HMMA) in every bf16 dK/dV and dQ function of the
               backward's library; each kernel function's
               registers and spills from ``-Xptxas -v`` (``ptxas_report``).
  3. kernels — hold each hand-written kernel against its plain PyTorch
               version on the card, at the reference's test-sweep shapes
               (f32 and bf16) and at each serving path's shapes; time kernel,
               plain version and, where one exists, one PyTorch library call
               computing the same function (a yardstick the port never calls),
               MLA's split head dims (q/k 96, v 64) in f32 and bf16,
               decode at granite's group of 3, and h2o-danube3's head dim
               120 (window 4096 at prompt 4608, its ring of 4096 slots) and
               phi3-vision's 96/96 in f32 and bf16 among the served shapes
               (and at 120 and 96 a ragged Sq, a kv_offset and per-sequence
               lengths in the sweeps);
               hold flash attention's bf16 kernel and the SSD scan's bf16
               output pass, within their output rounding, to their own
               arithmetic in f32; print decode attention's split-K grid,
               rmsnorm's plan and the scan's grids as the wrappers launched
               them at the served shapes; and the device time alone
               (``torch.profiler``) of rmsnorm against ``F.rms_norm`` and of
               the scan by CUDA kernel.  The RMSNorm backward kernel against
               autograd through the plain ``ref.rmsnorm`` (dx and dscale,
               f32 3e-5 / bf16 2e-2 of max|plain|, dscale bitwise equal over
               two launches) at the sweep shapes, at the train step's
               (2048, 2048) and (2048, 4096) bf16 with times and device us
               (and their split between the row kernel and the dscale sum)
               beside ``F.rms_norm``'s autograd backward, and at the other
               served widths; and its autograd Function under
               ``torch.utils.checkpoint`` (launch counts, gradients).  The
               flash-attention backward kernel against ``ref.attention_bwd``
               (the closed form, on the forward kernel's own o and lse) at
               every (K, V) head-dim pair on edge shapes (f32 3e-5 of
               max|plain|; bf16 at BF16_FLOOR_RATIO x the plain bf16
               path's distance from f32; two launches bitwise equal; o
               bitwise equal with and without the lse), its Function under
               checkpoint, and at the train shapes (internlm2's batch 2 x
               4096 in bf16 and f32, danube's window 4096 at 4608,
               minicpm3's strided v, phi3-vision, granite's g = 3) with
               times, the device us of its CUDA kernels, the bound
               and SDPA's backward alone.  The SSD scan's backward kernel
               against ``ref.ssd_scan_bwd`` (the closed form) on the forward
               kernel's own workspace: f32 at 5e-5 x max|plain| for each of
               dx, da, db, dc, dh0 at the scan's sweep shapes; the bf16 mix
               (bf16 x, c, dy; f32 a, b, h0) with dx and dc at
               BF16_FLOOR_RATIO x the plain path's distance from plain f32
               and da, db, dh0 at 5e-5; two launches bitwise equal; and at
               hymba's train shape (batch 2 x 4096, 50 heads of 64, N 16,
               chunk 256) and serving prefill shape with times, the device
               us of its four CUDA kernels, the grid and the bound.  The
               SSD decode step at a rank's P of 4 (hymba decode_32k's rank
               0 on (16, 16): 8 sequences, every head); the f32 kernels'
               head dim 16 (the examples' reduced internlm2): flash
               attention forward and backward at quickstart's train shape,
               decode at serve_pipeline's last step.
  4. serve   — for each path, full-width bf16 with random weights from a
               seeded generator: ``Server.generate`` for batch 4 and 64 steps
               with the launch counts set to 0 just before and asserted
               exactly just after; then prefill and teacher-forced decode on
               the kernel path's own tokens against the plain path on the same
               weights, within a stated tolerance.  Paths: internlm2-1.8B
               (prompt 1024), hymba-1.5B's hybrid attention+SSM blocks
               (prompt 1536: past the 1024 window, so the window mask, a ring
               roll and decode wrapping the ring all run), minicpm3-4B's MLA
               blocks (prompt 1024; flash and decode attention at q/k 96, v
               64; the latent cache re-expanded every step) and
               granite-moe-3B's MoE FFN (prompt 1024; top-8 of 40 experts,
               the scatter impl, cap 1 at decode; in the comparison every
               path dispatches to the f32 path's experts, and the share of
               tokens whose own top-k sets agree between paths is printed at
               every step), xlstm-1.3B's 42 mLSTM and 6 sLSTM blocks
               (prompt 1024; the cells are plain PyTorch, the norms the
               kernel), h2o-danube3-4B (24 SWA layers, heads of 120, g 4;
               prompt 4608, past its 4096 window, so prefill's window mask
               binds and decode wraps the ring), phi3-vision-4.2B's backbone
               (32 layers, heads of 96, g 1), yi-6B (heads of 128, g 8) and
               musicgen-medium (48 layers, heads of 64, g 1), the last three
               at prompt 1024.
  5. parallel — the parallel layer on a world-one NCCL group (meshes
               (data, model) = (1, 1), (stage,) = (1,) and (data,) = (1,);
               ``make_production_mesh()`` raises on one card): internlm2-1.8B's
               params placed by ``shard_params(param_pspecs(...))``, each
               ``full_tensor()`` bit-identical; its 24-layer block stack (batch
               4 x 1024, bf16) through ``pipeline_forward_stages`` over one
               stage at n_micro 4 and 2 on the placed layers' local shards,
               with exact rmsnorm and flash-attention launches, held to plain
               f32 at 1.25 x the plain bf16 path's distance and in f32 at
               F32_GATE, walls beside the unpipelined stack; a checkpoint of
               those params restored with ``shardings=`` onto the (1, 1) mesh
               bit for bit; granite-moe-3B's prefill at batch 4 x 4096 =
               16,384 tokens (``impl="shard_map"``, the reference's
               threshold) through the expert-parallel path in all 32 MoE
               layers, exact launches, its NCCL all-gathers and all-reduces
               counted in its ``torch.profiler`` trace, held to the same
               prefill through scatter (top-k agreement, ROUTE_AGREE) and to
               plain f32 at the floor gate; placed VGG-16 on four frames
               through ``ExecutionEngine(mesh=(1,) data mesh)`` bit for bit
               equal to the run without a mesh.  The group is destroyed at
               the phase's end.
  5b. mesh  — the sharded steps (DTensor params from ``shard_params``,
               inputs placed by ``place_batch``/``place_cache``, every
               kernel through ``sharding.local_call``).  (a) On a world-one
               NCCL (1, 1) (data, model) mesh, full-width internlm2-1.8B and
               hymba-1.5B (batch 4, prompts as in the serve phase): prefill
               and 16 decode steps teacher-forced on the unsharded path's
               tokens, every logit and the cache bit-identical to the
               unsharded path and the launches equal; and one train step of
               the reduced loop's xlstm: loss, gradients and the params after
               AdamW bit-identical, params and moments keeping their
               placements, launches equal.  (b) On a ``fake`` process group of 256 ranks
               on the card (``launch/mesh.py::fake_mesh``), rank 0's program
               of internlm2-1.8B prefill_32k (batch 32), decode_32k (batch
               128) and train_4k (batch 256, 16 sequences of 4,096 a rank:
               the loss on the rank's slice of the vocab, one AdamW step)
               and of hymba-1.5B prefill_32k (its scan in the reference's
               head groups, the state handed to the cache by P) and
               decode_32k (the scan on every head at the rank's 4 of P) on
               the (16, 16) mesh at its local shapes: launches equal
               the dry-run's rank-0 trace, peak device memory its
               ``peak_memory_in_bytes`` within 2 % + 64 MiB; the
               compute-only wall is printed (the fake group moves no bytes,
               so no value is held).
  6. train   — xlstm-1.3B at full width: one pattern period's (8 layers)
               loss and gradient against plain f32, each path at 1.25 x a
               floor path's distance (``PERIOD_GATES``: the kernel path in
               bf16 against the plain bf16 path, in f32 against norms that
               sum their squares in f64, and the backward kernel alone
               against a closed-form backward), and the period's forward
               and backward by kernel group under the profiler; then, with
               every launch count set to 0, the main path: full depth,
               bf16, remat, three AdamW steps (exact forward and backward
               rmsnorm launches, finite losses, the step walls, the device's
               idle share from ``nvidia-smi``'s utilization, peak memory);
               the reduced loop
               (``train_loop.run_with_restarts``) resuming after an injected
               failure bit for bit as an uninterrupted run.
  6b. train attention — the attention train path: with every launch count
               set to 0, internlm2-1.8B at full width and depth, bf16,
               remat, batch 2 x 4096, three AdamW steps through
               ``make_train_step`` (exact launches of the flash and norm
               forward and backward kernels, finite losses, walls, idle
               share, peak memory); two-layer full-width cuts of internlm2,
               h2o-danube3 (4608 tokens, past its window), minicpm3 (MLA),
               phi3-vision and granite (dispatch pinned to the f32 path's
               experts), each path's token-by-token loss and whole
               gradient against plain f32 at BF16_FLOOR_RATIO x a floor
               (``CUT_GATES``); the launcher's default command
               (``python -m repro_torch.launch.train``: reduced internlm2)
               in a child process; and the reduced internlm2 loop resuming
               after an injected failure bit for bit.
  6c. train hybrid — this slice's main path: with every launch count set
               to 0, hymba-1.5B at full width and depth (32 hybrid layers),
               bf16, remat, batch 2 x 4096, three AdamW steps through
               ``make_train_step`` (exact launches of the SSD scan's, flash
               attention's and the norm's forward and backward kernels,
               finite losses, walls, idle share, peak memory, the step by
               kernel group); and its two-layer full-width cut at 4096
               tokens under CUT_GATES (the f32 floor with the scan in
               chunks of half the length and its closed-form backward,
               ``SsdClosedForm``).
  6d. examples — the reference's three remaining examples through the
               port's entry points, each printing its own lines:
               ``launch/quickstart.py`` (30 losses against the same run on
               the CPU from the same params within F32_GATE, the resume
               taking 0 steps), ``launch/train_100m.py --full`` (the ~100M
               decoder in bf16, 300 steps with one injected failure and
               restart, the loss falling; the step walls, checkpoint saves,
               the idle share) and ``launch/serve_pipeline.py`` at one
               H100's group sizes (the placement's lines, the generated
               tokens equal to the CPU's from the same params, the
               straggler-aware nodes); launches exact, counted from 0.
  7. dryrun  — the port's dry-run (``repro_torch.launch.dryrun``) and the
               card.  For h2o-danube3-4B, hymba-1.5B and xlstm-1.3B at
               long_500k (decode at position 524,287, the whole cell: batch
               1) and internlm2-1.8B at decode_32k, prefill_32k and
               train_4k (at the trace's largest batch that fits one card;
               the train step with its optimizer state resident, its loss
               finite): the cell's record
               (traced on meta tensors, printed), then its step on the card
               with the arguments resident, launch counts set to 0 just
               before and read just after.  Gates: launches equal the
               trace's kernel calls, peak device memory the trace's within
               2 % + 64 MiB, outputs the trace's shapes, and the first and
               last sequences' bf16 logits within BF16_FLOOR_RATIO of the
               plain path's distance from plain f32 (both at batch 1; at
               32,768 tokens the plain attention runs by blocks of queries).
               For internlm2's two cells, also: the batch after the largest
               runs out of memory or peaks over the dry-run's cap, near its
               trace; and the step's attention kernel at the cell's shape
               (decode over 32,768 slots, flash over 32,768 tokens) meets
               its plain version in every sequence (its times join the
               kernels line).  The phase runs on expandable segments, which
               the dry-run's peaks assume, and prints the card's memory
               beside the dry-run's cap.  Printed: the step's wall, its
               FLOPs over the wall as a share of the bf16 peak (mfu) and its
               computed bytes over the wall as a share of the byte rate,
               beside the card's name and power limit.
  8. place   — the paper's placement path.  With every launch count set to 0:
               the batched ``ould-dp-sparse`` planner on the card
               (``batch_solve=True``) on the S7 swarm (LeNet, N = 1024,
               1024 requests; benchmarks/bench_swarm.py), on VGG-16 at
               N = 256 and on LeNet at N = 4097 (k = 65), then LeNet and
               VGG-16 placed by ``ould-dp`` across at least two nodes a
               request and run by ``ExecutionEngine`` on four 326×595×3
               frames; the counts are read just after.  Then the gates: the
               batched plans equal the sequential planner's (admission,
               assignment, objective), the DP sweep kernel equals its plain
               version bit for bit on each swarm's first-launch rows (also
               with infeasible candidates, with and without compute cost),
               the placed outputs match the sequential run on the card and
               one frame the CPU run; and the walls, the sweep's plan as
               launched, times, bound and critical-path floor, the host
               stages of one sweep call, per-stage walls and the calibrated
               re-solve's MAE are printed.
  9. swarm   — the swarm serving runtime (``runtime/swarm.py``).  With every
               launch count set to 0: benchmarks/bench_swarm.py's CHURN
               under every policy, its OVERLOAD and an N = 1024 swarm under
               ``incremental-sparse``, each with its epoch re-solves batched
               on the card (``batch_solve=True``: the DP sweep kernel), and
               executed mode measuring LeNet's stages on the card; the
               counts are read just after.  Then the gates: each batched
               run equals its sequential run field by field (walls
               excepted), OULD-MP misses fewer deadlines than snapshot
               OULD on CHURN (the benchmark's S1) and every epoch is
               feasible (S3), executed mode serves as its analytic twin and
               warms its engine on a churn rejoin; the policies' miss,
               rejection and p99, the walls, the sweeps' device µs and the
               bound of each batched call's sweep are printed.
  10. transport — the byte-moving transports.  With every launch count set
               to 0: executed mode (``SWARM_EXEC``, seed 3) under
               ``incremental-sparse`` with its re-solves batched on the card,
               over ``loopback`` (plain worker processes) and ``multiproc``
               (torch workers landing each activation on the card); the
               counts are read just after.  Then the gates: each run equals
               its ``inproc`` twin and its sequential twin field by field
               (walls, the transport's name and bandwidths excepted), links
               are sampled at rates above 0, the worker pids differ from
               ours, the multiproc workers report ``cuda`` and the card's
               name, placed LeNet through both transports equals the
               in-process run bit for bit on four 326×595×3 frames, and the
               transport CLI round-trips f32, bf16 and int32 tensors through
               multiproc workers on the card byte for byte.  Printed: the
               realized MB/s per link, ship walls by payload, the workers'
               recv and echo shares and startup, and from a child process
               (``chip_smoke.py --warm-child``) pointed at the populated
               build directory the CUDA context, ``measure_warm_start`` over
               LeNet's [(0, 3), (3, 7)] and the first ``dp_sweep`` launch (a
               load, no nvcc) beside the build phase's nvcc wall.
  11. report — a ``kernels`` JSON line, the card line, and as the last line
               ``{"ok": true, "device": {...}}``.

Each phase prints the seconds it took.

Imports nothing of the JAX package and no jax.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import json
import os
import pathlib
import statistics
import subprocess
import sys
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
# Published H100 SXM peaks (data sheet, dense): bf16 tensor cores, f32 on the
# CUDA cores, HBM3 bandwidth; the bound columns share them with the dry-run.
# Outside a checkout of the repo this import fails before anything is printed.
from repro_torch.kernels.cost import PEAK_BF16, PEAK_BYTES, PEAK_F32  # noqa: E402

# Reference tolerances (tests/test_kernels.py: f32 3e-5, bf16 2e-2, SSD 5e-5).
TOL = {"float32": 3e-5, "bfloat16": 2e-2}
SSD_TOL = 5e-5
# A bf16 tensor-core kernel against its arithmetic in f32 (scheme_close).
SCHEME_RTOL, SCHEME_ATOL = 2.0 ** -8, 2.0 ** -12

SEED = 0
STEPS = 64
# H100 SXM f64 peak outside the tensor cores (NVIDIA's data sheet: 34
# TFLOP/s) for the DP sweep's bound; it counts an FMA as two operations, the
# sweep's unfused multiply, adds and compares as one each.
PEAK_F64 = 34e12
# Serving paths: batch, prompt, and the exact launches of one generate of
# STEPS steps (one prefill + STEPS decode steps; a norm per layer for norm1
# and norm2, one more for a hybrid layer's SSM, and the final norm).
PATHS = {
    "internlm2_1p8b": dict(B=4, S=1024, launches={
        "rmsnorm": (2 * 24 + 1) * (1 + STEPS), "flash_attention": 24,
        "decode_attention": 24 * STEPS, "ssd_scan": 0, "dp_sweep": 0}),
    "hymba_1p5b": dict(B=4, S=1536, launches={
        "rmsnorm": (3 * 32 + 1) * (1 + STEPS), "flash_attention": 32,
        "decode_attention": 32 * STEPS, "ssd_scan": 32 * (1 + STEPS), "dp_sweep": 0}),
    # MLA: norm_q and norm_kv beside norm1 and norm2, four norms a layer
    "minicpm3_4b": dict(B=4, S=1024, launches={
        "rmsnorm": (4 * 62 + 1) * (1 + STEPS), "flash_attention": 62,
        "decode_attention": 62 * STEPS, "ssd_scan": 0, "dp_sweep": 0}),
    "granite_moe_3b": dict(B=4, S=1024, launches={
        "rmsnorm": (2 * 32 + 1) * (1 + STEPS), "flash_attention": 32,
        "decode_attention": 32 * STEPS, "ssd_scan": 0, "dp_sweep": 0}),
    # xLSTM: norm1 in each of 48 layers, the inner norm of each of 42 mLSTM
    # and 6 sLSTM layers, and the final norm: 97 a pass
    "xlstm_1p3b": dict(B=4, S=1024, launches={
        "rmsnorm": (48 + 42 + 6 + 1) * (1 + STEPS), "flash_attention": 0,
        "decode_attention": 0, "ssd_scan": 0, "dp_sweep": 0}),
    # h2o-danube3-4B: 24 SWA layers, 32/8 heads of 120 (g 4), window 4096;
    # a prompt of 4608 so that prefill's window mask binds and the ring cache
    # (4096 slots) rolls, and every decode step wraps it
    "h2o_danube3_4b": dict(B=4, S=4608, launches={
        "rmsnorm": (2 * 24 + 1) * (1 + STEPS), "flash_attention": 24,
        "decode_attention": 24 * STEPS, "ssd_scan": 0, "dp_sweep": 0}),
    # phi3-vision-4.2B's phi3-mini backbone: 32 layers, 32/32 heads of 96
    # (g 1); token prompts through its vocab-32064 table (the CLIP frontend
    # is a stub in the reference too)
    "phi3_vision_4p2b": dict(B=4, S=1024, launches={
        "rmsnorm": (2 * 32 + 1) * (1 + STEPS), "flash_attention": 32,
        "decode_attention": 32 * STEPS, "ssd_scan": 0, "dp_sweep": 0}),
    # yi-6B: 32 layers, 32/4 heads of 128, g 8 (the decode kernel's widest
    # group)
    "yi_6b": dict(B=4, S=1024, launches={
        "rmsnorm": (2 * 32 + 1) * (1 + STEPS), "flash_attention": 32,
        "decode_attention": 32 * STEPS, "ssd_scan": 0, "dp_sweep": 0}),
    # musicgen-medium: 48 layers, 24/24 heads of 64 (g 1), token prompts
    # through its vocab-2048 table (the EnCodec frontend a stub)
    "musicgen_medium": dict(B=4, S=1024, launches={
        "rmsnorm": (2 * 48 + 1) * (1 + STEPS), "flash_attention": 48,
        "decode_attention": 48 * STEPS, "ssd_scan": 0, "dp_sweep": 0}),
}
for _path in PATHS.values():
    _path["launches"]["rmsnorm_bwd"] = 0  # serving takes no gradient
    _path["launches"]["flash_attention_bwd"] = 0
    _path["launches"]["ssd_scan_bwd"] = 0
# The train path: xlstm-1.3B at full width and depth in bf16, batch 2 x 1024
# tokens, STEPS of AdamW at the reference's defaults, remat on.  A step's
# forward runs each pattern group's 16 norms (norm1 in 8 layers, the inner
# norm of 7 mLSTM and 1 sLSTM) and the final norm; the backward recomputes
# the 6 groups (16 forward launches each again) and takes one backward
# launch a norm.
TRAIN = dict(B=2, S=1024, steps=3)
TRAIN_LAUNCHES = {"rmsnorm": TRAIN["steps"] * (2 * 6 * 16 + 1),
                  "rmsnorm_bwd": TRAIN["steps"] * (6 * 16 + 1), "flash_attention": 0,
                  "flash_attention_bwd": 0, "decode_attention": 0, "ssd_scan": 0,
                  "ssd_scan_bwd": 0, "dp_sweep": 0}
# The attention train path (this slice's main path): internlm2-1.8B at full
# width and depth (24 layers, 16/8 heads of 128) in bf16, batch 2 x 4096
# tokens, three AdamW steps, remat on.  A step's forward runs each layer's
# two norms and its attention once, the final norm once; the backward
# recomputes each layer (its two norms and attention again) and takes one
# backward launch each.
TRAIN_ATTN = dict(arch="internlm2_1p8b", B=2, S=4096, steps=3, layers=24)
TRAIN_ATTN_LAUNCHES = {
    "rmsnorm": TRAIN_ATTN["steps"] * (2 * 2 * 24 + 1),
    "rmsnorm_bwd": TRAIN_ATTN["steps"] * (2 * 24 + 1),
    "flash_attention": TRAIN_ATTN["steps"] * 2 * 24,
    "flash_attention_bwd": TRAIN_ATTN["steps"] * 24,
    "decode_attention": 0, "ssd_scan": 0, "ssd_scan_bwd": 0, "dp_sweep": 0}
# The hybrid train path (this slice's main path): hymba-1.5B at full width
# and depth (32 hybrid layers: SWA 1024 over 25/5 heads of 64 beside 50 SSM
# heads of P 64, N 16, chunk 256) in bf16, batch 2 x 4096 tokens, three
# AdamW steps, remat on.  A step's forward runs each layer's three norms
# (norm1, norm2, the SSM's gated norm), its attention and its scan once, the
# final norm once; the backward recomputes each layer and takes one
# backward launch of each.
TRAIN_HYBRID = dict(arch="hymba_1p5b", B=2, S=4096, steps=3, layers=32)
TRAIN_HYBRID_LAUNCHES = {
    "rmsnorm": TRAIN_HYBRID["steps"] * (2 * 3 * 32 + 1),
    "rmsnorm_bwd": TRAIN_HYBRID["steps"] * (3 * 32 + 1),
    "flash_attention": TRAIN_HYBRID["steps"] * 2 * 32,
    "flash_attention_bwd": TRAIN_HYBRID["steps"] * 32,
    "ssd_scan": TRAIN_HYBRID["steps"] * 2 * 32,
    "ssd_scan_bwd": TRAIN_HYBRID["steps"] * 32,
    "decode_attention": 0, "dp_sweep": 0}
# The reference's examples as the port's entry points (``launch/quickstart.py``,
# ``train_100m.py``, ``serve_pipeline.py``).  quickstart: internlm2 cut to 2
# layers of d 64 over 4 heads of 16 (f32), batch 8 x 64, 30 steps.
# train_100m --full: 12 layers of d 768 (12/4 heads of 64, bf16 compute),
# batch 8 x 512, 300 steps with a failure injected at step 120; the restart
# resumes from step 99's checkpoint (one every 50 steps), so 120 + 200 steps
# run.  serve_pipeline: the 2-layer model, batch 4, a prompt of 16 and 8
# generated tokens in 64 slots.
EXAMPLES = dict(B=8, S=64, steps=30, prompt=16, gen=8, max_len=64,
                full=dict(layers=12, steps=300, fail=120, resume=100))


def train_launches(steps: int, layers: int) -> dict:
    """The kernel launches of ``steps`` train steps of an attention model of
    ``layers`` layers under remat: each layer's two norms and its attention
    twice (the forward, the recompute), the final norm once, and one
    backward launch of each."""
    return {"rmsnorm": steps * (2 * 2 * layers + 1), "rmsnorm_bwd": steps * (2 * layers + 1),
            "flash_attention": steps * 2 * layers, "flash_attention_bwd": steps * layers,
            "decode_attention": 0, "ssd_scan": 0, "ssd_scan_bwd": 0, "dp_sweep": 0}


# The attention models' two-layer cuts at full width (PERIOD_GATES, one
# sequence of the train shape; danube's past its 4096 window), each path's
# loss and gradient against plain f32 with remat off.  The loss is held
# token by token (the sequence's NLL vector, relative L2): the mean alone is
# one number, whose distance from f32 in bf16 (~1e-6 relative) comes out
# above or below another path's by chance (minicpm3's kernel path 2.365e-6
# against plain bf16's 1.060e-6 on an NVIDIA H100 80GB HBM3 at 700 W, while
# the gradients of the two agreed to 0.1 %).  The f32 floor path changes
# each kernel's arithmetic by a rounding-level change of the same kind, in
# plain PyTorch, forward and backward, by reassociating its f32 sums, as the
# kernels do: the norms' sum of squares over the row's two halves and their
# backward in closed form (``NormVariant``); attention's logits over two
# halves of the head dim, o = exp(S - lse) V over two halves of the keys,
# and its backward in closed form (``ref.attention_bwd``;
# ``AttentionClosedForm``).  A change that adds precision (a sum in f64)
# is a smaller change than the kernels make: with the norms' sums in f64
# and cuBLAS's order kept for S and P·V, the f32 kernel path sat at
# 1.02-1.25 x that floor in all five cuts on an NVIDIA H100 80GB HBM3 at
# 700 W.  granite's dispatch is pinned to the f32 path's experts
# (``RouteLog``): a near-tie's flip is a discrete jump, not arithmetic.
CUTS = {"internlm2_1p8b": 4096, "h2o_danube3_4b": 4608, "minicpm3_4b": 4096,
        "phi3_vision_4p2b": 4096, "granite_moe_3b": 4096}
CUT_GATES = (("bf16", "kernel", "plain"), ("f32", "kernel32", "f32 floor"))
# The train period's gates: a path's loss and its gradient (every leaf as
# one vector, relative L2) against plain f32, each at most BF16_FLOOR_RATIO
# times a floor path's distance, the floor a change of the same kind:
#   bf16      the kernel path (bf16)            vs the plain bf16 path;
#   f32       the kernel path in f32 (kernel32) vs plain f32 whose norms sum
#             their squares in f64 (a rounding-level change of the norms'
#             forward, as the forward kernel's summation order is);
#   backward  plain forward, the backward kernel vs plain f32 whose norms'
#             backward is the closed form in PyTorch ops (the kernel's
#             formula, rounded otherwise).
# xLSTM's gradient at full width is sensitive to rounding in the norms'
# forward: on an NVIDIA H100 80GB HBM3 at 700 W, one period's gradient moves
# by 8.87e-3 (relative L2; a leaf's max element by up to 6 % of its max|g|)
# when only the norms' sums of squares are taken in f64, and by the same
# with the forward kernel, while the backward kernel alone moves it by
# 4.67e-6, as the closed form does.  So no per-leaf gate of 1e-4 x max|g|
# holds for any rounding-level change of the forward; the per-leaf numbers
# are printed.
PERIOD_GATES = (("bf16", "kernel", "plain"), ("f32", "kernel32", "f32 var in f64"),
                ("backward", "f32 kernel backward", "f32 closed-form backward"))
# The placement path.  Swarm instances for the batched DP, in the regime of
# benchmarks/bench_swarm.py's S7 (snapshot_problem: a provisioned swarm of
# 8 x 512 MB nodes over 300 m, requests from hotspot nodes, seed 0):
# model, N, requests, hotspots, compute budget a node.  LeNet at N = 1024 is
# S7's own instance (the paper's 95 GFLOP window).  VGG-16 gets 8 windows,
# provisioned like the memory: one 326x595 frame is 117 GFLOP, so at one
# window no node holds a frame's compute and the solve leaves S7's regime.
# LeNet at N = 4097 (512 requests from the same 64 hotspots) is the first
# swarm whose default budget, k = ceil(sqrt(N)) = 65, passes 64, and whose
# spb (134 MB) outgrows the 50 MB L2.
SWARMS = {"lenet N1024 (S7)": ("lenet", 1024, 1024, 64, 95e9),
          "vgg16 N256": ("vgg16", 256, 256, 32, 8 * 95e9),
          "lenet N4097": ("lenet", 4097, 512, 64, 95e9)}
# The sweep's critical-path floor, an estimate in SM cycles (latencies of
# one dependent step each, assumed, not measured here): one gather round
# (the candidates, then the spb entries, each an L2 round trip), and per
# layer a shared-memory read, an f64 add and compare for each of the
# ceil(k / 32) predecessors a lane holds, five merges of a warp's lanes and
# the owner's write with a barrier.
FLOOR_CYCLES = dict(l2_round=300, smem=30, add_compare=16, merge=40, barrier=40)
# Placed execution: four frames from two camera nodes over a pool whose
# per-node memory is below the model's total, so every request spans two
# nodes or more (LeNet 108 MB, VGG-16 1003 MB of which 480 MB is the folded
# head).  Compute capacity is set out of the way: one VGG-16 frame at
# 326x595 is 117 GFLOP, past a paper node's 95 GFLOP window.
PLACED = {"lenet": dict(nodes=10, mem=96e6), "vgg16": dict(nodes=16, mem=600e6)}
FRAMES, FRAME_HW = 4, (326, 595, 3)
EXEC_REL = 1e-4   # placed vs sequential, and card vs CPU, x max|ref| (f32 sums)

# Logits gates in bf16, max|d| / max|ref| at prefill and every step.  Both
# bf16 paths round the same f32 results to bf16, so they differ by an ulp
# where summation order moves a value across a rounding boundary, and those
# ulps compound through the layers' residual stream.  Every model's bf16
# gate is one method, which calibrates itself on the run: the kernel path
# may lie no further from the plain f32 path than BF16_FLOOR_RATIO times the
# plain bf16 path's own distance from it (the noise floor), each at its worst
# step.  internlm2 and hymba also keep the kernel-vs-plain gates (GATE) that
# were set at their floors when they were ported.  The floors, plain bf16 vs
# plain f32 at the worst step, measured on NVIDIA H100 80GB HBM3, 700.00 W:
# - internlm2 (24 attn layers): 1.93e-2 when GATE was set; 2.057e-2 later,
#   above GATE, which kernel vs plain still met at 1.95e-2.
# - hymba (32 hybrid layers): 1.535e-1 at prefill, growing from 1.3e-2
#   after layer 1 to 1.7e-1 after layer 32, 2.06e-1 over 64 decode steps.
#   On the same weights the plain path alone moves its logits by 8.7e-2 when
#   only the scan's chunk changes (128 for 256), as much as the kernels move
#   them (8.4e-2), so GATE is set from the noise floor, not from the kernels.
# - minicpm3 (62 MLA layers): 2.564e-2 (prefill 2.031e-2); kernel vs f32
#   2.712e-2, kernel vs plain 2.759e-2.
# - granite (32 attn + MoE layers, dispatch pinned to the f32 path's
#   experts, ``RouteLog``): 1.233e-2 (prefill 9.827e-3); kernel vs f32
#   1.373e-2, kernel vs plain 1.342e-2, the same in two runs.
# Two paths that each lie near the floor from f32 may lie up to twice it
# from each other, so a kernel-vs-plain gate at the floor fails on noise
# alone (minicpm3's and granite's would); the ratio to the floor does not.
GATE = {"internlm2_1p8b": 2e-2, "hymba_1p5b": 1.6e-1}
BF16_FLOOR_RATIO = 1.25
# The same comparison in f32 (f32 weights, the kernels' f32 instantiations
# against the plain f32 path) has no bf16 rounding to amplify and holds
# rmsnorm, decode attention, the scan and flash attention's f32 kernel to
# their plain versions at full width: hymba's prefill logits agree to 1.6e-4
# (worst layer 4.6e-4; the f32 scan's cumulative log decays reach ~1e3 in
# magnitude, where one f32 ulp is ~1e-4).  Flash attention's bf16 kernel,
# the one that serves, has another instantiation: scheme_close holds it at
# the served shapes to its own arithmetic in f32.  An MoE model is compared
# with its dispatch pinned to the f32 path's routing (``RouteLog``): a
# routing flip at a near-tie is a discrete jump, not kernel arithmetic.  The
# routing itself is gated there too: the kernel32 and f32 paths' own top-k
# sets agree in at least ROUTE_AGREE of the (layer, token) rows of prefill
# and decode together (on the H100, 1 to 4 of prefill's 131,072 rows
# differed in four runs, none of the decode steps' 8,192).  The rows are
# pooled: a flip at an f32 near-tie is as likely in a decode row as in a
# prefill row, and one flip in 8,192 would fail a decode share of 0.9999.
F32_GATE = 2e-3
ROUTE_AGREE = 0.9999


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
    """Device microseconds of one call by CUDA kernel name, from
    ``torch.profiler``'s device events over ``calls`` calls that cycle
    ``fns`` (so inputs can outgrow the 50 MB L2): a kernel's median launch
    times its launches a call.  Unlike ``time_ms`` of an eager call, no host
    work counts.  The profiler on the card's machine has returned profiles
    with a few launches lost or left over from the profile before, which a
    mean over ``calls`` would misstate (those are printed), and profiles
    with no device rows, which are taken again, at most twice more."""
    import re
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for f in fns:
        f()
    torch.cuda.synchronize()
    for attempt in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for i in range(calls):
                fns[i % len(fns)]()
            torch.cuda.synchronize()
        launches = {}
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                m = re.search(r"\w+_kernel", e.name)
                launches.setdefault(m.group(0) if m else e.name[:40], []).append(
                    e.self_device_time_total)
        if launches:
            if any(len(v) % calls for v in launches.values()):
                print(f"[profiler] {calls} calls recorded as launches "
                      f"{ {k: len(v) for k, v in launches.items()} }", flush=True)
            return {k: statistics.median(v) * max(1, round(len(v) / calls))
                    for k, v in launches.items()}
        print(f"[profiler] no device time recorded (attempt {attempt + 1} of 3)", flush=True)
    raise SmokeError("torch.profiler recorded no device time")


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
    dev = rec.get("device_us")
    dev = (f", device {sum(dev.values()):.2f} us a call {dev}"
           if dev and rec["name"] in ("flash_attention", "flash_attention_bwd",
                                      "decode_attention") else "")
    print(f"[kernels] {rec['name']} at {rec['shape']}: kernel {rec['ms']:.4f} ms, plain "
          f"{rec['plain_ms']:.4f} ms, library {lib}, bound {rec['bound_ms'] * 1e3:.2f} us "
          f"({rec['bound_by']}), max|d| {rec['max_abs_err']:.3e}{dev}", flush=True)
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
                (1, 1000, 1000, 4, 2, 128, True, None, 0),
                # head dim 120 (danube's: the bf16 tiles padded to 128) at g 4: a
                # ragged Sq under a window, a kv_offset, rows with no valid key;
                # phi3-vision's 96/96 at g 1, ragged and with an offset
                (1, 1000, 1000, 32, 8, 120, True, 300, 0),
                (2, 48, 176, 8, 2, 120, True, None, 128),
                (1, 64, 64, 4, 1, 120, True, 8, 100),
                (2, 130, 130, 4, 4, 96, True, None, 0),
                (2, 40, 104, 8, 8, 96, True, None, 64)]:
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
                                          (4, 1024, 25, 5, 64, 1024),
                                          # 120 over 16 (bf16) or 32 (f32) lanes a
                                          # slot, the last chunks off; 96/96
                                          (2, 300, 8, 2, 120, 290), (2, 96, 8, 2, 120, 0),
                                          (2, 1089, 4, 4, 96, 1088)]:
            q, kc, vc = randn(b, hq, d, dtype=dt), randn(b, smax, hkv, d, dtype=dt), \
                randn(b, smax, hkv, d, dtype=dt)
            close(decode_attention(q, kc, vc, ln), ref.decode_attention(q, kc, vc, ln),
                  dt_name, f"decode_attention {dt_name} {(b, smax, hq, hkv, d, ln)}")
        # per-sequence device lengths: splits sized from Smax, some wholly past a length
        for d in (128, 120, 96):
            q, kc, vc = randn(3, 8, d, dtype=dt), randn(3, 4096, 2, d, dtype=dt), \
                randn(3, 4096, 2, d, dtype=dt)
            lens = torch.tensor([1, 700, 4096], dtype=torch.int32, device="cuda")
            close(decode_attention(q, kc, vc, lens), ref.decode_attention(q, kc, vc, lens),
                  dt_name, f"decode_attention {dt_name} D {d} per-sequence lengths [1, 700, 4096]")
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


def rel_close(got, want, dtype_name: str, what: str) -> float:
    """max|got - want| / max|want| within the dtype's tolerance (TOL)."""
    import torch
    err = ((got.float() - want.float()).abs().max()
           / want.float().abs().max().clamp_min(1e-30)).item()
    need(err <= TOL[dtype_name] and bool(torch.isfinite(got.float()).all()),
         f"{what}: max|d| / max|plain| {err:.3e} beyond {TOL[dtype_name]}")
    return err


def bwd_check(torch, x, sc, g, what: str) -> float:
    """The RMSNorm backward kernel against its plain version (autograd
    through ``ref.rmsnorm``): dx at the tolerance of x's dtype, dscale at
    that of scale's, each relative to max|plain|; and a second launch
    bitwise equal to the first (dscale's fixed-order sum)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.rmsnorm import rmsnorm_bwd
    name = {torch.float32: "float32", torch.bfloat16: "bfloat16"}
    dx, ds = rmsnorm_bwd(x, sc, g)
    px, ps = ref.rmsnorm_bwd(x, sc, g)
    err = max(rel_close(dx, px, name[x.dtype], f"{what} dx"),
              rel_close(ds, ps, name[sc.dtype], f"{what} dscale"))
    dx2, ds2 = rmsnorm_bwd(x, sc, g)
    need(torch.equal(ds, ds2) and torch.equal(dx, dx2),
         f"{what}: two launches of the backward kernel differ")
    return err


def rmsnorm_bwd_sweep(torch, randn) -> None:
    """The backward kernel at the forward's sweep shapes (f32 and bf16 x,
    scale in each dtype), an unaligned view (the scalar path), and the
    autograd Function under ``torch.utils.checkpoint``: two forward launches
    and one backward launch a norm, gradients as the plain path's."""
    from torch.utils.checkpoint import checkpoint
    from repro_torch.kernels import ref
    from repro_torch.kernels.rmsnorm import rmsnorm, rmsnorm_bwd
    for dt in (torch.float32, torch.bfloat16):
        for shape in [(4, 37, 256), (2, 8, 64), (1, 1, 512), (4, 3200), (5, 100), (3, 7, 8192)]:
            for sdt in (torch.float32, torch.bfloat16):
                x, g = randn(*shape, dtype=dt), randn(*shape, dtype=dt)
                sc = (randn(shape[-1]) * 0.1 + 1).to(sdt)
                bwd_check(torch, x, sc, g, f"rmsnorm_bwd x {dt} {shape} scale {sdt}")
        flat = randn(1 + 6 * 2048, dtype=dt)
        bwd_check(torch, flat[1:].view(6, 2048), randn(2048) * 0.1 + 1, randn(6, 2048, dtype=dt),
                  f"rmsnorm_bwd x {dt} offset view")
        need(rmsnorm_bwd.last_plan.vec == 1, f"rmsnorm_bwd offset view: {rmsnorm_bwd.last_plan}")
    x = randn(64, 256).requires_grad_(True)
    sc = (randn(256) * 0.1 + 1).requires_grad_(True)
    rmsnorm.n_launches = rmsnorm_bwd.n_launches = 0
    y = checkpoint(lambda a, b: rmsnorm(rmsnorm(a, b), b) * 2, x, sc, use_reentrant=False)
    got = torch.autograd.grad(y.sum(), (x, sc))
    counts = (rmsnorm.n_launches, rmsnorm_bwd.n_launches)
    need(counts == (4, 2), f"rmsnorm under checkpoint: launches (forward, backward) {counts} "
         "!= (4, 2): two norms, each run and recomputed once and differentiated once")
    want = torch.autograd.grad((ref.rmsnorm(ref.rmsnorm(x, sc), sc) * 2).sum(), (x, sc))
    for a, b, what in zip(got, want, ("dx", "dscale")):
        rel_close(a, b, "float32", f"rmsnorm autograd under checkpoint {what}")
    print("[kernels] rmsnorm_bwd sweep passed (dx and dscale at f32 3e-5 / bf16 2e-2 of "
          "max|plain|, the output dtype's; dscale bitwise equal over two launches; under "
          "checkpoint 4 forward and 2 backward launches for two norms)", flush=True)


def rmsnorm_bwd_record(torch, randn, rows: int, d: int, what: str) -> dict:
    """The backward kernel at a train shape (bf16 x and scale): parity,
    the plan as launched, kernel / plain / library times, device us against
    ``F.rms_norm``'s autograd backward, and the bound (``cost.rmsnorm_bwd``:
    x and g read, dx written, scale read and dscale written once; about 10
    f32 operations an element)."""
    from repro_torch.kernels import cost, ref
    from repro_torch.kernels.rmsnorm import rmsnorm_bwd
    F = torch.nn.functional
    bf = torch.bfloat16
    n_sets = max(2, -(-64 * 2**20 // (2 * rows * d * 2)))  # > 50 MB in all: L2-cold
    sets = [(randn(rows, d, dtype=bf), randn(rows, d, dtype=bf)) for _ in range(n_sets)]
    sc = (randn(d) * 0.1 + 1).to(bf)
    err = bwd_check(torch, sets[0][0], sc, sets[0][1], f"rmsnorm_bwd {what}")
    work = cost.rmsnorm_bwd(rows, d, 2, 2)
    rmsnorm_bwd.last_plan = None
    ms = time_ms([lambda s=s: rmsnorm_bwd(s[0], sc, s[1]) for s in sets])
    plan = rmsnorm_bwd.last_plan  # as the wrapper launched it in the timed calls
    need(plan is not None and plan.vec == 8, f"rmsnorm_bwd {what}: not the vector path: {plan}")
    lib_sets = []  # F.rms_norm's graphs, built once; its backward is the yardstick
    for x, g in sets:
        xr, sr = x.detach().requires_grad_(True), sc.detach().requires_grad_(True)
        lib_sets.append((F.rms_norm(xr, (d,), sr, 1e-5), xr, sr, g))

    def lib(s):
        return torch.autograd.grad(s[0], (s[1], s[2]), s[3], retain_graph=True)

    dev = {}
    for _ in range(2):  # the kernel's time, and its split by CUDA kernel
        by_name = device_us([lambda s=s: rmsnorm_bwd(s[0], sc, s[1]) for s in sets])
        dev.setdefault("kernel", []).append(sum(by_name.values()))
        for name, us in sorted(by_name.items()):
            dev.setdefault(name, []).append(us)
        dev.setdefault("F.rms_norm backward", []).append(
            sum(device_us([lambda s=s: lib(s) for s in lib_sets]).values()))
    rec = finish(dict(
        name="rmsnorm_bwd", shape=f"x, g ({rows}, {d}) bf16, scale ({d},) bf16 [{what}]",
        max_abs_err=err, plan=plan._asdict(), device_us=dev, ms=ms,
        plain_ms=time_ms([lambda s=s: ref.rmsnorm_bwd(s[0], sc, s[1]) for s in sets]),
        library_ms=time_ms([lambda s=s: lib(s) for s in lib_sets]),
        bytes_ms=work.bytes / PEAK_BYTES * 1e3, ops_ms=work.flops / PEAK_F32 * 1e3))
    print(f"[kernels] rmsnorm_bwd plan at {what} ({rows}, {d}): {plan}; device us a call, two "
          f"rounds: " + ", ".join(f"{k} {v[0]:.2f} / {v[1]:.2f}" for k, v in dev.items())
          + f"; the partials add {2 * plan.blocks * d * 4 / 1e6:.2f} MB of traffic beside the "
          f"bound's {work.bytes / 1e6:.2f} MB", flush=True)
    return rec


def ssd_state_close(got, want, what: str) -> float:
    err = (got - want).abs().max().item()
    need(err <= SSD_TOL * want.abs().max().item() and bool(got.isfinite().all()),
         f"{what}: max|d| {err:.3e} beyond {SSD_TOL} x max|plain| {want.abs().max().item():.3e}")
    return err


def rmsnorm_record(torch, randn, rows: int, d: int, what: str) -> dict:
    from repro_torch.kernels import cost, ref
    from repro_torch.kernels.rmsnorm import rmsnorm
    F = torch.nn.functional
    # Inputs cycled so a call does not find its input in L2 (> 50 MB in all).
    n_sets = max(2, -(-64 * 2**20 // (rows * d * 2)))
    xs, sc = [randn(rows, d, dtype=torch.bfloat16) for _ in range(n_sets)], \
        (randn(d) * 0.1 + 1).to(torch.bfloat16)
    err = close(rmsnorm(xs[0], sc), ref.rmsnorm(xs[0], sc), "bfloat16", f"rmsnorm {what}")
    xd = randn(4, d, dtype=torch.bfloat16)
    err = max(err, close(rmsnorm(xd, sc), ref.rmsnorm(xd, sc), "bfloat16", f"rmsnorm {what} decode"))
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
    # A decode step's rows (cost.rmsnorm: x read and written once and the
    # scale read once, or 4 operations an element at the f32 peak), the larger.
    decode = cost.rmsnorm(4, d, 2, 2)
    decode_bytes_us = decode.bytes / PEAK_BYTES * 1e6
    decode_ops_us = decode.flops / PEAK_F32 * 1e6
    print(f"[kernels] rmsnorm device us a call at {what} ({rows}, {d}) and (4, {d}), two "
          f"rounds: " + ", ".join(f"{k} {v[0]:.2f} / {v[1]:.2f}" for k, v in dev.items())
          + f"; decode rows' bound {max(decode_bytes_us, decode_ops_us):.4f} us ("
          + ("bytes" if decode_bytes_us >= decode_ops_us else "operations") + ")",
          flush=True)
    # ... and the eager calls at a decode step's rows: kernel, plain version
    # and F.rms_norm, each launch host-bound
    rows_ms = {"ms": time_ms([lambda x=x: rmsnorm(x, sc) for x in xds]),
               "plain_ms": time_ms([lambda x=x: ref.rmsnorm(x, sc) for x in xds]),
               "library_ms": time_ms([lambda x=x: F.rms_norm(x, (d,), sc, 1e-5) for x in xds])}
    print(f"[kernels] rmsnorm eager ms a call at (4, {d}), {what}'s decode rows: kernel "
          f"{rows_ms['ms']:.4f}, plain {rows_ms['plain_ms']:.4f}, F.rms_norm "
          f"{rows_ms['library_ms']:.4f}", flush=True)
    work = cost.rmsnorm(rows, d, 2, 2)
    return finish(dict(
        name="rmsnorm", shape=f"x ({rows}, {d}) bf16 [{what}]", max_abs_err=err,
        plan=plan._asdict(), device_us=dev, ms=ms, decode_rows=rows_ms,
        plain_ms=time_ms([lambda x=x: ref.rmsnorm(x, sc) for x in xs]),
        library_ms=time_ms([lambda x=x: F.rms_norm(x, (d,), sc, 1e-5) for x in xs]),
        bytes_ms=work.bytes / PEAK_BYTES * 1e3, ops_ms=work.flops / PEAK_F32 * 1e3))


def flash_record(torch, randn, B, S, hq, hkv, hd, window, what: str, dv: int | None = None,
                 dtype_name: str = "bfloat16", scale: float | None = None) -> dict:
    """Flash attention at a served shape: q and k of head dim ``hd``, v of
    ``dv`` (MLA's 64 beside 96: then v is a strided slice of a (.., hd + dv)
    product, as the model passes it), in ``dtype_name``."""
    from repro_torch.kernels import cost, ref
    from repro_torch.kernels.flash_attention import flash_attention
    F = torch.nn.functional
    dt = getattr(torch, dtype_name)
    dv = hd if dv is None else dv
    q, k = randn(B, S, hq, hd, dtype=dt), randn(B, S, hkv, hd, dtype=dt)
    v = randn(B, S, hkv, dv, dtype=dt) if dv == hd else \
        randn(B, S, hkv, hd + dv, dtype=dt)[..., hd:]
    kw = dict(causal=True, window=window, scale=scale)
    got = flash_attention(q, k, v, **kw)
    err = close(got, ref.attention(q, k, v, **kw), dtype_name, f"flash_attention {what}")
    if dt == torch.bfloat16:
        scheme_close(got, ref.attention_bf16_scheme(q, k, v, **kw), f"flash_attention {what}")
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    # the causal (and windowed) mask, for SDPA
    i = torch.arange(S, device="cuda")
    band = (i[None, :] <= i[:, None]) & (i[None, :] > i[:, None] - (window or S))
    # q, k, v read and o written once; Q.K^T over hd and P.V over dv for each
    # unmasked pair, two operations a multiply-add
    work = cost.flash_attention(B, S, S, hq, hkv, hd, dv, q.element_size(), True, window)

    def lib():  # SDPA takes a v head dim other than q's
        if window is None:
            return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=True,
                                                  scale=scale)
        return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=band, enable_gqa=True,
                                              scale=scale)

    rec = dict(
        name="flash_attention", max_abs_err=err,
        shape=(f"q ({B},{S},{hq},{hd}), k/v ({B},{S},{hkv},{hd}) {dtype_name} causal" if dv == hd
               else f"q/k ({B},{S},{hq}|{hkv},{hd}), v ({B},{S},{hkv},{dv}) strided "
                    f"{dtype_name} causal")
              + (f" window {window}" if window else "") + f" [{what}]",
        ms=time_ms([lambda: flash_attention(q, k, v, **kw)], reps=5, inner=3),
        plain_ms=time_ms([lambda: ref.attention(q, k, v, **kw)], reps=5, inner=3),
        library_ms=time_ms([lib], reps=5, inner=3),
        bytes_ms=work.bytes / PEAK_BYTES * 1e3,
        ops_ms=work.flops / (PEAK_BF16 if dt == torch.bfloat16 else PEAK_F32) * 1e3)
    # the device time alone: the eager ms carries the wrapper's host work
    rec["device_us"] = device_us([lambda: flash_attention(q, k, v, **kw)], 10)
    return finish(rec)


def flash_bwd_inputs(torch, randn, B, S, hq, hkv, hd, dv, dt, kv=None):
    """q, k, v (v a strided slice of a (.., hd + dv) product where dv !=
    hd, as MLA passes it) and an output gradient; ``kv`` the key length
    where it differs from S (a ragged edge)."""
    kv = S if kv is None else kv
    q, k = randn(B, S, hq, hd, dtype=dt), randn(B, kv, hkv, hd, dtype=dt)
    v = randn(B, kv, hkv, dv, dtype=dt) if dv == hd else \
        randn(B, kv, hkv, hd + dv, dtype=dt)[..., hd:]
    return q, k, v, randn(B, S, hq, dv, dtype=dt)


def flash_bwd_check(torch, q, k, v, do, what: str, **kw) -> tuple[float, float]:
    """The flash backward kernel against ``ref.attention_bwd`` (the closed
    form in f32) on the forward kernel's own o and lse: f32 within TOL
    (3e-5) x max|plain| for each of dq, dk, dv; bf16 each within
    BF16_FLOOR_RATIO x the plain bf16 path's distance from plain f32 (the
    same closed form on the same values upcast), relative to max|f32|.
    Also: the forward's o bitwise equal with and without the lse output, and
    two backward launches bitwise equal.  Returns (max|kernel - plain| over
    the three, the worst kernel / floor ratio in bf16 (0 in f32))."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    scale = kw.pop("scale", None)
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    kw = {"causal": True, "window": None, "kv_offset": 0, **kw}
    o0, _ = fa._forward(q, k, v, kw["causal"], kw["window"], scale, kw["kv_offset"], False)
    o, lse = fa._forward(q, k, v, kw["causal"], kw["window"], scale, kw["kv_offset"], True)
    need(torch.equal(o0, o), f"flash_attention {what}: o differs when the lse is written")
    got = fa.flash_attention_bwd(q, k, v, o, lse, do, scale=scale, **kw)
    again = fa.flash_attention_bwd(q, k, v, o, lse, do, scale=scale, **kw)
    need(all(torch.equal(a, b) for a, b in zip(got, again)),
         f"flash_attention_bwd {what}: two launches differ")
    plain = ref.attention_bwd(q, k, v, o, lse, do, scale=scale, **kw)
    err = max((a.float() - b.float()).abs().max().item() for a, b in zip(got, plain))
    worst = 0.0
    if q.dtype == torch.float32:
        for a, b, n in zip(got, plain, ("dq", "dk", "dv")):
            rel_close(a, b, "float32", f"flash_attention_bwd {what} {n}")
    else:
        f32 = ref.attention_bwd(*(t.float() for t in (q, k, v, o)), lse, do.float(),
                                scale=scale, **kw)
        for a, b, c, n in zip(got, plain, f32, ("dq", "dk", "dv")):
            e, fl = rel_max(a, c), rel_max(b, c)
            need(e <= BF16_FLOOR_RATIO * fl and bool(a.float().isfinite().all()),
                 f"flash_attention_bwd {what} {n}: kernel-f32 {e:.3e} > {BF16_FLOOR_RATIO} x "
                 f"the plain bf16 path's {fl:.3e}")
            worst = max(worst, e / fl if fl else 0.0)
        del f32
    del got, again, plain
    return err, worst


def flash_bwd_sweep(torch, randn) -> None:
    """The backward kernel at every (DK, DV) pair in f32 and bf16 on edge
    shapes (flash_bwd_check's gates): causal with GQA, a ragged Skv past
    Sq with a kv_offset, a window at g 3, non-causal ragged, empty leading
    rows (kv_offset < 0 under a window), empty trailing rows; then the
    autograd Function under ``torch.utils.checkpoint``: two forward and one
    backward launch a call, and the gradients of autograd through the plain
    version."""
    from torch.utils.checkpoint import checkpoint
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    cases = ((2, 100, 100, 4, 2, True, None, 0), (1, 70, 130, 6, 2, True, None, 60),
             (1, 77, 77, 3, 1, True, 20, 0), (1, 40, 90, 4, 4, False, None, 0),
             (1, 50, 60, 4, 1, True, 16, -10), (1, 33, 40, 2, 2, False, 8, 45))
    worst = 0.0
    for dt in (torch.float32, torch.bfloat16):
        for dk, dv in fa.HEAD_DIMS:
            for B, S, kv, hq, hkv, causal, window, off in cases:
                q, k, v, do = flash_bwd_inputs(torch, randn, B, S, hq, hkv, dk, dv, dt, kv)
                _, w = flash_bwd_check(torch, q, k, v, do, f"sweep {dk}x{dv} {dt} "
                                       f"{(B, S, kv, hq, hkv, causal, window, off)}",
                                       causal=causal, window=window, kv_offset=off)
                worst = max(worst, w)
    q, k, v = (randn(2, 128, h, 64).requires_grad_(True) for h in (4, 2, 2))
    fa.flash_attention.n_launches = fa.flash_attention_bwd.n_launches = 0
    y = checkpoint(lambda a, b, c: fa.flash_attention(a, b, c) * 2, q, k, v, use_reentrant=False)
    got = torch.autograd.grad(y.sum(), (q, k, v))
    counts = (fa.flash_attention.n_launches, fa.flash_attention_bwd.n_launches)
    need(counts == (2, 1), f"flash attention under checkpoint: launches (forward, backward) "
         f"{counts} != (2, 1)")
    want = torch.autograd.grad((ref.attention(q, k, v) * 2).sum(), (q, k, v))
    for a, b, n in zip(got, want, ("dq", "dk", "dv")):
        rel_close(a, b, "float32", f"flash attention autograd under checkpoint {n}")
    print(f"[kernels] flash_attention_bwd sweep passed: every (DK, DV) pair {fa.HEAD_DIMS} in "
          f"f32 (3e-5 of max|plain|) and bf16 (worst kernel-f32 {worst:.3f} x the plain bf16 "
          f"path's distance, gate {BF16_FLOOR_RATIO}) on {len(cases)} edge shapes each, two "
          "launches bitwise equal, o bitwise equal with and without the lse; under checkpoint "
          "2 forward and 1 backward launches", flush=True)


def flash_bwd_record(torch, randn, B, S, hq, hkv, hd, window, what: str, dv: int | None = None,
                     dtype_name: str = "bfloat16", scale: float | None = None) -> dict:
    """The flash backward kernel at a train shape (causal; ``window``; v a
    strided slice where ``dv`` differs from ``hd``): ``flash_bwd_check``,
    then kernel, plain and library times, the device us of each of its
    CUDA kernels (bf16: dQ with D, then dK/dV; f32: D, dK/dV, dQ), and the bound
    (``cost.flash_attention_bwd``).  The library call is the backward alone
    of ``F.scaled_dot_product_attention(..., enable_gqa=True)`` (a band mask
    where there is a window), its graph built once."""
    from repro_torch.kernels import cost, ref
    from repro_torch.kernels import flash_attention as fa
    F = torch.nn.functional
    dt = getattr(torch, dtype_name)
    dv = hd if dv is None else dv
    q, k, v, do = flash_bwd_inputs(torch, randn, B, S, hq, hkv, hd, dv, dt)
    kw = dict(causal=True, window=window, scale=scale)
    err, worst = flash_bwd_check(torch, q, k, v, do, what, **kw)
    o, lse = fa._forward(q, k, v, True, window, hd ** -0.5 if scale is None else scale, 0, True)
    work = cost.flash_attention_bwd(B, S, S, hq, hkv, hd, dv, q.element_size(), True, window)
    ts = [t.transpose(1, 2).contiguous().requires_grad_(True) for t in (q, k, v)]
    i = torch.arange(S, device="cuda")
    band = (i[None, :] <= i[:, None]) & (i[None, :] > i[:, None] - (window or S))
    y = (F.scaled_dot_product_attention(*ts, is_causal=True, enable_gqa=True, scale=scale)
         if window is None else
         F.scaled_dot_product_attention(*ts, attn_mask=band, enable_gqa=True, scale=scale))
    g = do.transpose(1, 2).contiguous()

    def lib():
        return torch.autograd.grad(y, ts, g, retain_graph=True)

    def run():
        return fa.flash_attention_bwd(q, k, v, o, lse, do, **kw)

    rec = dict(
        name="flash_attention_bwd", max_abs_err=err, floor_ratio=worst,
        shape=(f"q ({B},{S},{hq},{hd}), k ({B},{S},{hkv},{hd}), v ({B},{S},{hkv},{dv})"
               + (" strided" if dv != hd else "") + f" {dtype_name} causal"
               + (f" window {window}" if window else "") + f" [{what}]"),
        ms=time_ms([run], reps=5, inner=3),
        plain_ms=time_ms([lambda: ref.attention_bwd(q, k, v, o, lse, do, **kw)], reps=3,
                         inner=1),
        library_ms=time_ms([lib], reps=5, inner=3),
        bytes_ms=work.bytes / PEAK_BYTES * 1e3,
        ops_ms=work.flops / (PEAK_BF16 if dt == torch.bfloat16 else PEAK_F32) * 1e3)
    rec["device_us"] = device_us([run], 10)
    rec["library_device_us"] = sum(device_us([lib], 10).values())
    del y, ts, g
    out = finish(rec)
    fwd = cost.flash_attention(B, S, S, hq, hkv, hd, dv, q.element_size(), True, window)
    print(f"[kernels] flash_attention_bwd {what}: device us a call "
          f"{sum(rec['device_us'].values()):.1f} ({rec['device_us']}), SDPA backward device us "
          f"{rec['library_device_us']:.1f}; the forward's work {fwd.flops:.4e} FLOPs, the "
          f"backward's {work.flops:.4e}", flush=True)
    return out


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


def decode_record(torch, randn, B, smax, L, hq, hkv, hd, what: str, dv: int | None = None,
                  dtype_name: str = "bfloat16", scale: float | None = None) -> dict:
    """Decode attention at a served shape: q and the K cache of head dim
    ``hd``, the V cache of ``dv`` (MLA's 64 beside 96: then a strided slice
    of a (.., hd + dv) product, as the model's re-expanded latent), in
    ``dtype_name``."""
    from repro_torch.kernels import cost, ref
    from repro_torch.kernels.decode_attention import MIN_SPLIT, decode_attention
    F = torch.nn.functional
    dt = getattr(torch, dtype_name)
    dv = hd if dv is None else dv
    es = torch.finfo(dt).bits // 8

    def one_set():  # q, then k, then v from the generator
        q, k = randn(B, hq, hd, dtype=dt), randn(B, smax, hkv, hd, dtype=dt)
        return q, k, (randn(B, smax, hkv, dv, dtype=dt) if dv == hd
                      else randn(B, smax, hkv, hd + dv, dtype=dt)[..., hd:])

    # Cache sets cycled so each call finds its cache cold, as each layer's
    # cache is on the serving path.
    n_sets = max(2, -(-128 * 2**20 // (B * smax * hkv * (hd + dv) * es)))
    sets = [one_set() for _ in range(n_sets)]
    q, kc, vc = sets[0]
    kw = dict(scale=scale)
    err = close(decode_attention(q, kc, vc, L, **kw), ref.decode_attention(q, kc, vc, L, **kw),
                dtype_name, f"decode_attention {what}")
    valid = (torch.arange(smax, device="cuda") < L)[None, None, None, :].expand(B, 1, 1, -1)
    lib_sets = [(q.unsqueeze(2), kc.transpose(1, 2).contiguous(), vc.transpose(1, 2).contiguous())
                for (q, kc, vc) in sets]
    decode_attention.last_grid = None
    ms = time_ms([lambda s=s: decode_attention(*s, L, **kw) for s in sets])
    # the split kernel's grid as the wrapper launched it in the timed calls
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    need(decode_attention.last_grid is not None, f"decode_attention {what}: no grid recorded")
    bh, splits = decode_attention.last_grid
    grid = bh * splits
    print(f"[kernels] decode_attention grid at {what}: B*Hkv*splits = {bh}*{splits} = "
          f"{grid} blocks on {n_sm} SMs (as launched)", flush=True)
    # the grid fills the SMs unless the valid slots split no further
    need(grid > n_sm or splits == max(1, L // MIN_SPLIT),
         f"decode_attention {what}: grid {grid} does not exceed {n_sm} SMs")
    work = cost.decode_attention(B, hq, hkv, hd, dv, L, es)
    rec = dict(
        name="decode_attention", max_abs_err=err, grid=grid,
        shape=(f"q ({B},{hq},{hd}), caches ({B},{smax},{hkv},{hd})" if dv == hd
               else f"q ({B},{hq},{hd}), k cache ({B},{smax},{hkv},{hd}), v cache "
                    f"({B},{smax},{hkv},{dv}) strided")
              + f" {dtype_name}, {L} valid [{what}]",
        ms=ms,
        plain_ms=time_ms([lambda s=s: ref.decode_attention(*s, L, **kw) for s in sets]),
        library_ms=time_ms([lambda s=s: F.scaled_dot_product_attention(
            *s, attn_mask=valid, enable_gqa=True, scale=scale) for s in lib_sets]),
        # the valid K and V slots, q read and o written once, the lengths;
        # q.k over hd and p.v over dv a valid slot and query head
        bytes_ms=work.bytes / PEAK_BYTES * 1e3,
        ops_ms=work.flops / (PEAK_BF16 if dt == torch.bfloat16 else PEAK_F32) * 1e3)
    # the device time alone (split + combine): the eager ms carries the wrapper's host work
    rec["device_us"] = device_us([lambda s=s: decode_attention(*s, L, **kw) for s in sets])
    return finish(rec)


def ssd_record(torch, randn, B, S, H, P, N, chunk, with_h0: bool, what: str) -> dict:
    """The SSD scan at a serving shape, in the bf16 model's dtype mix.  No
    single PyTorch call computes it, so ``library_ms`` is None."""
    from repro_torch.kernels import cost, ref
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
    # The causal form this run's chunks need (cost.ssd_scan), counted at the
    # bf16 tensor-core peak: the least time any type of this work could take.
    work = cost.ssd_scan(B, S, H, P, N, chunk, *(t.element_size() for t in (x, a, b, c)),
                         0 if h0 is None else h0.element_size())
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
        bytes_ms=work.bytes / PEAK_BYTES * 1e3,
        ops_ms=work.flops / PEAK_BF16 * 1e3))


def ssd_bwd_check(torch, x, a, b, c, h0, dy, dh, chunk: int, what: str) -> tuple[float, float]:
    """The SSD backward kernel against ``ref.ssd_scan_bwd`` (the closed form
    in f32) on the forward kernel's own workspace: in f32 each of dx, da,
    db, dc and dh0 within SSD_TOL x max|plain|; in the bf16 mix, dx and dc
    (bf16) each within BF16_FLOOR_RATIO x the plain bf16 path's distance
    from plain f32 (the closed form on the same values upcast), da, db and
    dh0 (f32) within SSD_TOL x max|f32| of it, and (the tensor-core passes)
    each of the five within its output rounding of its own arithmetic in
    f32, ``ref.ssd_scan_bwd_bf16_scheme`` (``scheme_close``).  Two launches
    bitwise equal.  Returns (max|kernel - plain| over the five, the worst
    bf16 kernel / floor ratio (0 in f32))."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import ssm_scan as ss
    _, _, saved = ss._forward(x, a, b, c, h0, chunk, True)
    got = ss.ssd_scan_bwd(x, a, b, c, h0, dy, dh, chunk=chunk, saved=saved)
    again = ss.ssd_scan_bwd(x, a, b, c, h0, dy, dh, chunk=chunk, saved=saved)
    need(all(g is None and g2 is None or torch.equal(g, g2) for g, g2 in zip(got, again)),
         f"ssd_scan_bwd {what}: two launches differ")
    plain = ref.ssd_scan_bwd(x, a, b, c, h0, dy, dh, chunk=chunk)
    names = ("dx", "da", "db", "dc", "dh0")
    err = max((g.float() - p.float()).abs().max().item()
              for g, p in zip(got, plain) if g is not None)
    worst = 0.0
    f32 = (plain if x.dtype == torch.float32 else
           ref.ssd_scan_bwd(x.float(), a, b, c.float(), h0, dy.float(), dh, chunk=chunk))
    def rel(a, b):  # a gradient that is zero (one step from no state: da) is zero in both
        return ((a.float() - b.float()).abs().max()
                / b.float().abs().max().clamp_min(1e-30)).item()

    for g, p, w, n in zip(got, plain, f32, names):
        if g is None:
            continue
        if g.dtype == torch.float32:
            e = rel(g, w)
            need(e <= SSD_TOL and bool(g.isfinite().all()),
                 f"ssd_scan_bwd {what} {n}: max|d| / max|plain| {e:.3e} beyond {SSD_TOL}")
        else:
            e, fl = rel(g, w), rel(p, w)
            need(e <= BF16_FLOOR_RATIO * fl and bool(g.float().isfinite().all()),
                 f"ssd_scan_bwd {what} {n}: kernel-f32 {e:.3e} > {BF16_FLOOR_RATIO} x the "
                 f"plain bf16 path's {fl:.3e}")
            worst = max(worst, e / fl if fl else 0.0)
    if x.dtype == torch.bfloat16:
        need(ss.ssd_scan_bwd.last_plan.tc, f"ssd_scan_bwd {what}: bf16 x off the tensor cores")
        scheme = ref.ssd_scan_bwd_bf16_scheme(x, a, b, c, h0, dy, dh, chunk=chunk)
        for g, w, n in zip(got, scheme, names):
            if g is not None:
                scheme_close(g, w, f"ssd_scan_bwd {what} {n}")
    del got, again, plain, f32
    return err, worst


def ssd_bwd_sweep(torch, randn) -> None:
    """The backward kernel over the forward's sweep shapes (a ragged last
    chunk, one step, S < Q, many chunks, the widest head and state, P 100)
    in f32, with h0 and h_final's gradient and without, and in the bf16 mix
    (there also P 32, padded to the instantiated 64); a bf16 call whose
    tensor-core block does not fit (P 128, N 64 at chunk 256) is refused
    before it launches."""
    for (B, S, H, P, N), chunk in [((2, 96, 3, 16, 8), 32), ((2, 100, 3, 16, 8), 32),
                                   ((2, 1, 3, 16, 8), 256), ((2, 300, 3, 64, 16), 256),
                                   ((2, 257, 3, 64, 16), 256), ((1, 1000, 2, 64, 16), 64),
                                   ((1, 130, 2, 128, 64), 64), ((1, 70, 2, 100, 32), 256)]:
        x, a, b, c, h0 = ssd_inputs(torch, randn, B, S, H, P, N)
        dy, dh = randn(B, S, H, P), randn(B, H, P, N)
        for with_state in (True, False):
            ssd_bwd_check(torch, x, a, b, c, h0 if with_state else None, dy,
                          dh if with_state else None, chunk,
                          f"f32 {(B, S, H, P, N)} chunk {chunk} h0/dh {with_state}")
    worst = 0.0
    for (B, S, H, P, N), chunk, with_state in [
            ((2, 300, 3, 64, 16), 256, True), ((2, 257, 3, 64, 16), 256, False),
            ((2, 1, 3, 64, 16), 256, True), ((1, 130, 2, 128, 64), 64, False),
            ((1, 70, 2, 100, 32), 64, True), ((2, 300, 3, 32, 16), 256, False)]:
        x, a, b, c, h0 = ssd_inputs(torch, randn, B, S, H, P, N, mix=True)
        dy, dh = randn(B, S, H, P, dtype=torch.bfloat16), randn(B, H, P, N)
        worst = max(worst, ssd_bwd_check(
            torch, x, a, b, c, h0 if with_state else None, dy, dh if with_state else None,
            chunk, f"mix {(B, S, H, P, N)} chunk {chunk} h0/dh {with_state}")[1])
    from repro_torch.kernels import ssm_scan as ss
    x, a, b, c, _ = ssd_inputs(torch, randn, 1, 300, 2, 128, 64, mix=True)
    dy = randn(1, 300, 2, 128, dtype=torch.bfloat16)
    _, _, saved = ss._forward(x, a, b, c, None, 256, True)
    n0 = ss.ssd_scan_bwd.n_launches
    try:
        ss.ssd_scan_bwd(x, a, b, c, None, dy, None, chunk=256, saved=saved)
        refused = False
    except ValueError:
        refused = True
    need(refused and ss.ssd_scan_bwd.n_launches == n0,
         "ssd_scan_bwd: a bf16 call whose tensor-core block does not fit was not refused")
    torch.cuda.synchronize()
    print(f"[kernels] ssd_scan_bwd sweep passed (f32 5e-5 of max|plain| each gradient; bf16 "
          f"mix: dx, dc within {BF16_FLOOR_RATIO} x the plain bf16 path's distance from f32, "
          f"worst {worst:.3f} x; da, db, dh0 5e-5; two launches bitwise equal; a bf16 block "
          f"that does not fit refused)", flush=True)


def ssd_bwd_record(torch, randn, B, S, H, P, N, chunk, what: str) -> dict:
    """The backward kernel at a train shape in the bf16 model's dtype mix,
    from a zero state with no gradient of h_final (the train step's call):
    ``ssd_bwd_check``, then kernel and plain times, the device us of its
    four CUDA kernels, the grid and the bound (``cost.ssd_scan_bwd``, its
    products counted at the bf16 tensor-core peak, as the forward's record
    counts them: the least time any type of this work could take).  No
    PyTorch call computes the SSD's backward, so ``library_ms`` is None."""
    from repro_torch.kernels import cost, ref
    from repro_torch.kernels import ssm_scan as ss

    def one_set():
        x, a, b, c, _ = ssd_inputs(torch, randn, B, S, H, P, N, mix=True)
        dy = randn(B, S, H, P, dtype=torch.bfloat16)
        return x, a, b, c, dy, ss._forward(x, a, b, c, None, chunk, True)[2]

    sets = [one_set()]
    sets += [one_set() for _ in range(min(15, -(-64 * 2**20 // nbytes(*sets[0][:5])) - 1))]
    x, a, b, c, dy, saved = sets[0]
    err, worst = ssd_bwd_check(torch, x, a, b, c, None, dy, None, chunk, what)
    work = cost.ssd_scan_bwd(B, S, H, P, N, chunk, *(t.element_size() for t in (x, a, b, c)),
                             0, 0)
    runs = [lambda s=s: ss.ssd_scan_bwd(*s[:4], None, s[4], None, chunk=chunk, saved=s[5])
            for s in sets]
    ss.ssd_scan_bwd.last_grid = None
    ms = time_ms(runs, reps=5, inner=3)
    grid = ss.ssd_scan_bwd.last_grid
    dev = device_us(runs, 10)
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    print(f"[kernels] ssd_scan_bwd at {what}: grids (chunk sums, carry, tiles, da) = {grid} "
          f"blocks on {n_sm} SMs (as launched); device us a call {sum(dev.values()):.2f} ("
          + ", ".join(f"{k} {v:.2f}" for k, v in sorted(dev.items(), key=lambda kv: -kv[1]))
          + f"); work {work.flops:.4e} FLOPs, {work.bytes:.4e} B", flush=True)
    return finish(dict(
        name="ssd_scan_bwd", max_abs_err=err, floor_ratio=worst, grid=list(grid),
        device_us=dev,
        shape=f"x, dy ({B},{S},{H},{P}) bf16, a f32, b ({B},{S},{H},{N}) f32, c bf16, "
              f"chunk {chunk}, h0 none, no dh_final [{what}]",
        ms=ms,
        plain_ms=time_ms([lambda: ref.ssd_scan_bwd(x, a, b, c, None, dy, None, chunk=chunk)],
                         reps=3, inner=1),
        library_ms=None,
        bytes_ms=work.bytes / PEAK_BYTES * 1e3,
        ops_ms=work.flops / PEAK_BF16 * 1e3))


def tensor_core_count() -> dict:
    """HMMA/HGMMA (tensor-core) and FFMA instructions per kernel function of
    the built flash-attention libraries, forward and backward, and of the
    SSD scan's backward, from ``cuobjdump --dump-sass``: every bf16 forward
    function runs on the tensor cores, every bf16 dK/dV and dQ function of
    the backward on Hopper's (HGMMA, no HMMA), and each of the SSD
    backward's 4 instantiations of its bf16 tile-pair and chunk-sum
    functions shows HMMA."""
    import collections
    import shutil
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import HEAD_DIMS
    tool = shutil.which("cuobjdump") or str(pathlib.Path(build._nvcc()).parent / "cuobjdump")
    counts = collections.defaultdict(collections.Counter)
    for src in ("flash_attention.cu", "flash_attention_bwd.cu", "ssm_scan_bwd_tc.cu"):
        lib = build._lib_path(build.CSRC / src)
        r = subprocess.run([tool, "--dump-sass", str(lib)], capture_output=True, text=True,
                           timeout=300)
        need(r.returncode == 0, f"cuobjdump --dump-sass {lib.name} failed: {r.stderr[-2000:]}")
        fn = None
        for line in r.stdout.splitlines():
            if "Function :" in line:
                fn = line.split("Function :")[1].strip()
            elif fn is not None:
                for op in ("HGMMA", "HMMA", "FFMA"):
                    if f" {op}." in line or f" {op} " in line:
                        counts[fn][op] += 1
    bf16 = {f: c for f, c in counts.items() if "flash_fwd_bf16_kernel" in f}
    f32 = {f: c for f, c in counts.items() if "flash_fwd_f32_kernel" in f}
    bwd = {f: c for f, c in counts.items()
           if "flash_bwd_dkdv_bf16_kernel" in f or "flash_bwd_dq_bf16_kernel" in f}
    n_tc = sum(c["HMMA"] + c["HGMMA"] for c in bf16.values())
    print(f"[build] flash_attention bf16 instantiations: {len(bf16)} functions, {n_tc} "
          f"tensor-core instructions (HMMA/HGMMA) by function "
          f"{[c['HMMA'] + c['HGMMA'] for c in bf16.values()]}, FFMA "
          f"{[c['FFMA'] for c in bf16.values()]}; f32 instantiations: HMMA "
          f"{[c['HMMA'] + c['HGMMA'] for c in f32.values()]}, FFMA "
          f"{[c['FFMA'] for c in f32.values()]}; flash_attention_bwd bf16 dK/dV and dQ: "
          f"{len(bwd)} functions, HGMMA {[c['HGMMA'] for c in bwd.values()]}, HMMA "
          f"{[c['HMMA'] for c in bwd.values()]}", flush=True)
    need(len(bf16) == len(HEAD_DIMS) and all(c["HMMA"] + c["HGMMA"] > 0 for c in bf16.values()),
         f"flash_attention bf16 instantiations without tensor-core instructions: {dict(bf16)}")
    need(len(bwd) == 2 * len(HEAD_DIMS)
         and all(c["HGMMA"] > 0 and c["HMMA"] == 0 for c in bwd.values()),
         f"flash_attention_bwd bf16 functions without HGMMA, or with HMMA: {dict(bwd)}")
    ssd = {f: c for f, c in counts.items()
           if "ssd_bwd_chunk_tc_kernel" in f or "ssd_bwd_state_tc_kernel" in f}
    print(f"[build] ssm_scan_bwd_tc bf16 tile-pair and chunk-sum functions: {len(ssd)}, HMMA "
          f"{[c['HMMA'] for c in ssd.values()]}, FFMA {[c['FFMA'] for c in ssd.values()]}",
          flush=True)
    need(len(ssd) == 8 and all(c["HMMA"] + c["HGMMA"] > 0 for c in ssd.values()),
         f"ssm_scan_bwd_tc bf16 functions without tensor-core instructions: {dict(ssd)}")
    return {"hmma_bf16": n_tc, "hgmma_bwd_bf16": sum(c["HGMMA"] for c in bwd.values()),
            "hmma_ssd_bwd_bf16": sum(c["HMMA"] + c["HGMMA"] for c in ssd.values())}


def ptxas_report() -> dict:
    """Registers and spills of each kernel function from nvcc's ``-Xptxas
    -v`` output in this process's build (``build.LOGS``).  Prints every
    function that spills, and the registers of flash and decode attention's
    instantiations at head dims 120 and 96 and of the RMSNorm backward's
    kernels; returns {short name: (registers, spill store bytes, spill load
    bytes)}."""
    import re
    import shutil
    from repro_torch.kernels import build
    rows = []
    for stem, log in sorted(build.LOGS.items()):
        fn, spill = None, (0, 0)
        for line in log.splitlines():
            m = re.search(r"Compiling entry function '(\w+)'", line)
            if m:
                fn, spill = m.group(1), (0, 0)
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            if m and fn:
                spill = (int(m.group(1)), int(m.group(2)))
            m = re.search(r"Used (\d+) registers", line)
            if m and fn:
                rows.append((fn, int(m.group(1)), *spill))
                fn = None
    if not rows:
        print("[build] ptxas: nothing was built in this process", flush=True)
        return {}
    names = [r[0] for r in rows]
    if shutil.which("c++filt"):
        out = subprocess.run(["c++filt"], input="\n".join(names), capture_output=True,
                             text=True, timeout=60).stdout.splitlines()
        if len(out) == len(names):
            names = out
    table = {}
    for name, (_, regs, st, ld) in zip(names, rows):
        short = re.sub(r"\(anonymous namespace\)::|^void |\(.*$", "", name)
        short = re.sub(r"__nv_bfloat16", "bf16", short)
        table[short] = (regs, st, ld)
    shown = [k for k, (_, st, _) in table.items()
             if st or "rmsnorm_bwd" in k or "dscale" in k
             or re.search(r"(120, 120|96, 96)", k)]
    print(f"[build] ptxas, {len(table)} kernel functions; spilling or new: " + "; ".join(
        f"{k} {table[k][0]} regs" + (f", spill {table[k][1]}/{table[k][2]} B" if table[k][1]
                                     else "") for k in shown), flush=True)
    return table


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
    # minicpm3-4B (MLA): d 2560, norm_kv over 256, 40 heads with q/k of 96
    # (qk_nope 64 + qk_rope 32) and v of 64 at scale 96^-0.5, in f32 (the f32
    # gate's kernels) and bf16; granite-moe-3B: 24 query heads over 8 KV heads
    # of 64, g = 3 on the kernel's G = 4 instantiation.  Appended after the
    # earlier records so their inputs stay the generator's same draws.
    mc, gr = PATHS["minicpm3_4b"], PATHS["granite_moe_3b"]
    L_mc, L_gr = mc["S"] + STEPS, gr["S"] + STEPS
    mla = dict(dv=64, scale=96 ** -0.5)
    recs["rmsnorm"] += [
        rmsnorm_record(torch, randn, mc["B"] * mc["S"], 2560, "minicpm3 prefill d"),
        rmsnorm_record(torch, randn, mc["B"] * mc["S"], 256, "minicpm3 prefill norm_kv")]
    recs["flash_attention"] += [
        flash_record(torch, randn, mc["B"], mc["S"], 40, 40, 96, None,
                     f"minicpm3 prefill, MLA {dt}", dtype_name=dt, **mla)
        for dt in ("bfloat16", "float32")] + [
        flash_record(torch, randn, gr["B"], gr["S"], 24, 8, 64, None, "granite prefill")]
    recs["decode_attention"] += [
        decode_record(torch, randn, mc["B"], L_mc + 1, L_mc, 40, 40, 96,
                      f"minicpm3 last step, MLA {dt}", dtype_name=dt, **mla)
        for dt in ("bfloat16", "float32")] + [
        decode_record(torch, randn, gr["B"], L_gr + 1, L_gr, 24, 8, 64,
                      "granite last step, g = 3")]
    # The two other widths these paths give the norm (its plan depends on d):
    # minicpm3's norm_q over q_lora_rank 768 and granite's d 1536.
    recs["rmsnorm"] += [
        rmsnorm_record(torch, randn, mc["B"] * mc["S"], 768, "minicpm3 prefill norm_q"),
        rmsnorm_record(torch, randn, gr["B"] * gr["S"], 1536, "granite prefill d"),
        # xlstm-1.3B's other width: the mLSTM's inner norm over d_inner 4096
        rmsnorm_record(torch, randn, PATHS["xlstm_1p3b"]["B"] * PATHS["xlstm_1p3b"]["S"], 4096,
                       "xlstm prefill mLSTM inner")]
    from repro_torch.kernels import ref
    from repro_torch.kernels.rmsnorm import rmsnorm
    # The backward kernel: its sweep, then the xLSTM train step's two widths
    # (batch 2 x 1024 tokens: d 2048 and the mLSTM's inner 4096), and the
    # forward's other served widths with the plan as launched.
    from repro_torch.kernels.rmsnorm import rmsnorm_bwd
    rmsnorm_bwd_sweep(torch, randn)
    rows = TRAIN["B"] * TRAIN["S"]
    recs["rmsnorm_bwd"] = [rmsnorm_bwd_record(torch, randn, rows, 2048, "xlstm train d"),
                           rmsnorm_bwd_record(torch, randn, rows, 4096, "xlstm train mLSTM inner")]
    for d in (1600, 3200, 2560, 256, 768, 1536):
        x, g = randn(rows, d, dtype=torch.bfloat16), randn(rows, d, dtype=torch.bfloat16)
        bwd_check(torch, x, (randn(d) * 0.1 + 1).bfloat16(), g, f"rmsnorm_bwd ({rows}, {d})")
        print(f"[kernels] rmsnorm_bwd ({rows}, {d}) bf16 within 2e-2, plan as launched "
              f"{rmsnorm_bwd.last_plan}", flush=True)
    # h2o-danube3-4B: 32 query heads over 8 KV heads of 120 (the bf16
    # kernel's tiles padded to 128), window 4096 binding at prompt 4608, and
    # decode over the full ring of 4096 slots; phi3-vision-4.2B: 32/32 heads
    # of 96 at prompt 1024.  Each in bf16 and in f32 (the f32 gate's kernels).
    dn, ph = PATHS["h2o_danube3_4b"], PATHS["phi3_vision_4p2b"]
    L_ph = ph["S"] + STEPS
    for dt in ("bfloat16", "float32"):
        recs["flash_attention"] += [
            flash_record(torch, randn, dn["B"], dn["S"], 32, 8, 120, 4096,
                         f"danube prefill {dt}", dtype_name=dt),
            flash_record(torch, randn, ph["B"], ph["S"], 32, 32, 96, None,
                         f"phi3-vision prefill {dt}", dtype_name=dt)]
        recs["decode_attention"] += [
            decode_record(torch, randn, dn["B"], 4096, 4096, 32, 8, 120, f"danube ring {dt}",
                          dtype_name=dt),
            decode_record(torch, randn, ph["B"], L_ph + 1, L_ph, 32, 32, 96,
                          f"phi3-vision last step {dt}", dtype_name=dt)]
    # the norm's forward at these paths' widths (danube 3840, phi3 3072, yi
    # 4096; musicgen's 1536 is granite's), prefill rows and decode rows
    for d in (3840, 3072):
        for rows in (4096, 4):
            x, sc = randn(rows, d, dtype=torch.bfloat16), (randn(d) * 0.1 + 1).bfloat16()
            close(rmsnorm(x, sc), ref.rmsnorm(x, sc), "bfloat16", f"rmsnorm ({rows}, {d})")
    # The flash backward: its sweep, then the attention train shapes: the
    # main path's (internlm2, batch 2 x 4096, 16/8 heads of 128) in bf16 and
    # f32, and a sequence of each two-layer cut's (danube's 120 with window
    # 4096 at 4608, minicpm3's 96 x 64 with v strided, phi3-vision's 96,
    # granite's g = 3).
    flash_bwd_sweep(torch, randn)
    B, S = TRAIN_ATTN["B"], TRAIN_ATTN["S"]
    recs["flash_attention_bwd"] = [
        flash_bwd_record(torch, randn, B, S, 16, 8, 128, None, "internlm2 train"),
        flash_bwd_record(torch, randn, B, S, 16, 8, 128, None, "internlm2 train f32",
                         dtype_name="float32"),
        flash_bwd_record(torch, randn, 1, 4608, 32, 8, 120, 4096, "danube train"),
        flash_bwd_record(torch, randn, 1, S, 40, 40, 96, None, "minicpm3 train, MLA", dv=64,
                         scale=96 ** -0.5),
        flash_bwd_record(torch, randn, 1, S, 32, 32, 96, None, "phi3-vision train"),
        flash_bwd_record(torch, randn, 1, S, 24, 8, 64, None, "granite train, g = 3")]
    # The SSD scan's backward: its sweep, then hymba's train shape (the main
    # path's: batch 2 x 4096, 50 heads of 64, N 16, chunk 256) and its
    # serving prefill's (batch 4 x 1536).
    ssd_bwd_sweep(torch, randn)
    th = TRAIN_HYBRID
    recs["ssd_scan_bwd"] = [
        ssd_bwd_record(torch, randn, th["B"], th["S"], 50, 64, 16, 256, "hymba train"),
        ssd_bwd_record(torch, randn, hy["B"], hy["S"], 50, 64, 16, 256, "hymba prefill shape")]
    # hymba decode_32k's state update on rank 0 of (16, 16): every head on
    # the rank's 4 of P (the cache leaf's layout), its 8 sequences
    recs["ssd_scan"].append(ssd_record(torch, randn, 8, 1, 50, 4, 16, 256, True,
                                       "hymba decode_32k rank 0, P 4 of 64"))
    # The examples' reduced internlm2 (d 64 over 4 heads of 16, f32): the
    # f32 kernels' head dim 16, forward and backward at quickstart's train
    # shape (batch 8 x 64) and decode at serve_pipeline's last step (prompt
    # 16 + 8 steps in 64 slots).
    ex = EXAMPLES
    recs["flash_attention"].append(flash_record(
        torch, randn, ex["B"], ex["S"], 4, 4, 16, None, "quickstart train f32",
        dtype_name="float32"))
    recs["flash_attention_bwd"].append(flash_bwd_record(
        torch, randn, ex["B"], ex["S"], 4, 4, 16, None, "quickstart train f32",
        dtype_name="float32"))
    recs["decode_attention"].append(decode_record(
        torch, randn, 4, ex["max_len"], ex["prompt"] + ex["gen"], 4, 4, 16,
        "serve_pipeline last step f32", dtype_name="float32"))
    torch.cuda.synchronize()
    return recs


def serve_phase(torch, arch: str) -> dict:
    """One full-width generate with exact launch counts, then the kernel path
    against the plain path (and, for information, the plain path in f32).
    The generate routes an MoE freely; the comparison pins its dispatch to
    the f32 path's routing (``RouteLog``); the kernel32 and f32 paths also
    run routing freely, for information."""
    from repro_torch import configs as C
    from repro_torch.models import init_params
    from repro_torch.runtime import ServeConfig, Server, make_decode_step, make_prefill_step

    B, S, want = PATHS[arch]["B"], PATHS[arch]["S"], PATHS[arch]["launches"]
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
    kernels = all_kernels()
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
    # teacher-forced on the kernel path's own tokens.  The same two paths in
    # f32 on the same (upcast) weights are gated by F32_GATE.  Both bf16
    # paths are held against the plain f32 path: the kernel path's distance
    # is gated at BF16_FLOOR_RATIO times the plain path's, the noise floor.
    cfg32 = dataclasses.replace(cfg, param_dtype="float32", compute_dtype="float32")
    params32 = _tree_map(params, lambda t: t.float())
    paths = {"kernel": (make_prefill_step(cfg, max_len), make_decode_step(cfg), params),
             "plain": (make_prefill_step(cfg, max_len, plain=True),
                       make_decode_step(cfg, plain=True), params),
             "kernel32": (make_prefill_step(cfg32, max_len), make_decode_step(cfg32), params32),
             "f32": (make_prefill_step(cfg32, max_len, plain=True),
                     make_decode_step(cfg32, plain=True), params32)}
    gates = {"kernel32-f32": F32_GATE}
    if arch in GATE:
        gates["kernel-plain"] = GATE[arch]
    toks = torch.as_tensor(prompts.astype(np.int64), device="cuda")
    gen_ids = torch.as_tensor(out.astype(np.int64), device="cuda")
    rel = {"kernel-plain": [], "kernel32-f32": [], "kernel-f32": [], "plain-f32": []}
    agree, dec_ms, caches = [], [], {}
    # An MoE's paths dispatch to the f32 path's experts (RouteLog), so the f32
    # path runs first at each step; two more f32 paths route freely.
    routes = RouteLog("f32") if cfg.moe is not None else None
    order = list(paths)
    if routes is not None:
        paths["kernel32 free"], paths["f32 free"] = paths["kernel32"], paths["f32"]
        rel["kernel32 free-f32 free"] = []
        order = ["f32", "kernel", "plain", "kernel32", "kernel32 free", "f32 free"]

    def compare(logits, what):
        need(all(t.shape == (B, cfg.vocab) and bool(torch.isfinite(t).all())
                 for t in logits.values()), f"{what}: logits not finite or not {(B, cfg.vocab)}")
        for pair in rel:
            a, b = pair.split("-")
            rel[pair].append(((logits[a] - logits[b]).abs().max()
                              / logits[b].abs().max()).item())
        if routes is not None:
            routes.compare([pair for pair in rel if " free" not in pair])

    with torch.inference_mode(), (routes or contextlib.nullcontext()):
        prefill_kernel, _, _ = paths["kernel"]
        prefill_kernel(params, {"tokens": toks})  # warm-up: the timed prefill allocates nothing new
        logits = {}
        for name in order:
            prefill, _, prm = paths[name]
            if routes is not None:
                routes.path = None if name.endswith(" free") else name
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
            for name in order:
                _, decode, prm = paths[name]
                if routes is not None:
                    routes.path = None if name.endswith(" free") else name
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
              + (f" (gate {gates[pair]})" if pair in gates else
                 f" (gate {BF16_FLOOR_RATIO} x plain-f32's worst)" if pair == "kernel-f32" else
                 " (information: both route freely)" if " free" in pair else " (information)"),
              flush=True)
    floor, kernel_f32 = max(rel["plain-f32"]), max(rel["kernel-f32"])
    print(f"[serve {arch}] bf16 noise floor (plain-f32 worst) {floor:.3e}; kernel-f32 worst "
          f"{kernel_f32:.3e} = {kernel_f32 / floor:.3f} x the floor (gate {BF16_FLOOR_RATIO})",
          flush=True)
    if routes is not None:
        routes.report(arch)
    for pair, g in gates.items():  # every number is printed before a gate fails
        need(max(rel[pair]) <= g, f"{arch}: logits {pair} max|d| / max|ref| reached "
             f"{max(rel[pair]):.3e} > {g}")
    need(kernel_f32 <= BF16_FLOOR_RATIO * floor, f"{arch}: logits kernel-f32 max|d| / max|ref| "
         f"reached {kernel_f32:.3e} > {BF16_FLOOR_RATIO} x the noise floor {floor:.3e}")
    if routes is not None:
        share_k32 = routes.agreement("kernel32-f32")
        need(share_k32 >= ROUTE_AGREE, f"{arch}: kernel32-f32 own top-k sets agree in "
             f"{share_k32:.6f} of the (layer, token) rows, below {ROUTE_AGREE}")
    print(f"[serve {arch}] greedy ids agreeing with the plain path: {share:.4f} "
          f"(information, not a gate: bf16 near-ties may flip an argmax)", flush=True)
    print(f"[serve {arch}] prefill {prefill_ms:.2f} ms (B {B}, S {S}); decode median "
          f"{dec_med:.3f} ms/step, {B * 1e3 / dec_med:.1f} tokens/s; generate wall "
          f"{gen_s:.3f} s = {B * STEPS / gen_s:.1f} generated tokens/s", flush=True)
    return launches


def leaf_names(tree, path="") -> list:
    """Each leaf's path, in ``optim.tree_leaves`` order."""
    if isinstance(tree, dict):
        return [n for k in sorted(tree) for n in leaf_names(tree[k], f"{path}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [n for i, v in enumerate(tree) for n in leaf_names(v, f"{path}/{i}")]
    return [path]


def loss_and_grads(torch, cfg, params, batch, plain: bool, remat: bool = False) -> tuple:
    """loss_fn's value and its gradient over every param leaf."""
    from repro_torch.models import transformer
    from repro_torch.optim import tree_leaves
    leaves = tree_leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    try:
        loss, _ = transformer.loss_fn(params, cfg, batch, remat=remat, plain=plain)
        # an embedding-stub arch does not read its token table: a zero gradient
        grads = [torch.zeros_like(t) if g is None else g for g, t in zip(
            torch.autograd.grad(loss, leaves, allow_unused=True), leaves)]
    finally:
        for t in leaves:
            t.requires_grad_(False)
    return loss.detach(), grads


class NormVariant:
    """While active, the norm a path runs is changed, for the floor paths
    of PERIOD_GATES and CUT_GATES.  ``"closed-form backward"``: the plain norm
    (``ref.rmsnorm``) under an autograd Function whose backward is
    dx = (g s) r - x r^3 mean(g s x), dscale = sum g (x r) in PyTorch ops,
    f32 (the backward kernel's formula with its own rounding).  ``"var in
    f64"``: the plain norm with its sum of squares in f64, rounded to f32.
    ``"var in halves, closed-form backward"``: the sum of squares in f32 over
    the row's two halves, added (a reassociation, as the kernel's sum is),
    under the closed-form backward.
    ``"kernel backward"``: the kernel path's Function with the plain
    forward in place of the forward kernel, so only the backward kernel
    runs."""

    def __init__(self, kind: str):
        self.kind = kind

    def __enter__(self):
        import torch
        from repro_torch.kernels import ref
        from repro_torch.kernels import rmsnorm as kernel_mod
        self._saved = [(ref, "rmsnorm", ref.rmsnorm), (kernel_mod, "_forward", kernel_mod._forward)]
        real = ref.rmsnorm

        def norm_f64(x, scale, eps=1e-5):
            var = (x.double() ** 2).mean(-1, keepdim=True).float()
            return ((x.float() * torch.rsqrt(var + eps)) * scale.float()).to(x.dtype)

        def norm_halves(x, scale, eps=1e-5):
            xf, h = x.float(), x.shape[-1] // 2
            var = ((xf[..., :h] ** 2).sum(-1, keepdim=True)
                   + (xf[..., h:] ** 2).sum(-1, keepdim=True)) / x.shape[-1]
            return ((xf * torch.rsqrt(var + eps)) * scale.float()).to(x.dtype)
        if self.kind == "kernel backward":
            kernel_mod._forward = lambda x, scale, eps: real(x, scale, eps)
        elif self.kind == "var in f64":
            ref.rmsnorm = norm_f64
        else:
            if self.kind == "var in halves, closed-form backward":
                real = norm_halves
            class Norm(torch.autograd.Function):
                @staticmethod
                def forward(ctx, x, scale, eps):
                    ctx.save_for_backward(x, scale)
                    ctx.eps = eps
                    return real(x, scale, eps)

                @staticmethod
                def backward(ctx, g):
                    x, scale = ctx.saved_tensors
                    xf, gs = x.float(), g.float() * scale.float()
                    r = torch.rsqrt((xf * xf).mean(-1, keepdim=True) + ctx.eps)
                    dx = gs * r - xf * (r ** 3 * (gs * xf).mean(-1, keepdim=True))
                    ds = (g.float() * (xf * r)).reshape(-1, x.shape[-1]).sum(0)
                    return dx.to(x.dtype), ds.to(scale.dtype), None

            ref.rmsnorm = lambda x, scale, eps=1e-5: Norm.apply(x, scale, eps)
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self._saved:
            setattr(mod, name, fn)


def profile_step(torch, fn) -> dict:
    """Device time of ``fn`` by kernel group (``launch/profile_serve.py``'s
    groups), from ``torch.profiler``'s device events alone."""
    import collections
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.launch.profile_serve import _group
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    groups, counts = collections.Counter(), collections.Counter()
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            groups[_group(e.key)] += e.self_device_time_total
            counts[_group(e.key)] += e.count
    return out, groups, counts


def train_steps(torch, step, params, opt, batches, before, n_params: int, want: dict,
                tag: str) -> tuple:
    """``step`` over ``batches`` with every launch count set to 0 just
    before and read just after: each step's synchronised wall and loss, the
    card's busy share from ``nvidia-smi`` over the steps after the first,
    peak memory and the params changed since ``before`` are printed; the
    losses must be finite, the optimizer step count and the launches
    exact.  Returns (params, opt, launches)."""
    from repro_torch.optim import tree_leaves
    kernels = all_kernels()
    for fn in kernels.values():
        fn.n_launches = 0
    torch.cuda.reset_peak_memory_stats()
    walls, losses, smi, util = [], [], None, []
    try:
        for i, b in enumerate(batches):
            if i == 1:  # the card's own busy share, sampled over the steps after the first
                smi = subprocess.Popen(["nvidia-smi", "--query-gpu=utilization.gpu",
                                        "--format=csv,noheader,nounits", "-lms", "100"],
                                       stdout=subprocess.PIPE, stderr=subprocess.DEVNULL,
                                       text=True)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params, opt, m = step(params, opt, b)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            losses.append(m["loss"].item())
    finally:
        if smi is not None:
            smi.terminate()
            util = [float(x) for x in smi.communicate(timeout=30)[0].split()
                    if x.replace(".", "", 1).isdigit()]
    launches = {name: fn.n_launches for name, fn in kernels.items()}
    peak = torch.cuda.max_memory_allocated() / 2**30
    changed = sum(int((a != b).sum()) for a, b in zip(before, tree_leaves(params)))
    before.clear()
    print(f"[{tag}] step walls {[round(w, 3) for w in walls]} s, losses "
          f"{[round(x, 6) for x in losses]}, optimizer step {int(opt['step'])}, launches "
          f"{launches}, peak device memory {peak:.2f} GiB; params changed in {changed} of "
          f"{n_params} elements (bf16 at lr {float(m['lr']):.3e})", flush=True)
    print(f"[{tag}] steps after the first: nvidia-smi utilization.gpu (the share of each "
          f"100 ms in which a kernel ran) over {len(util)} samples, mean "
          + (f"{statistics.mean(util):.1f} %: device idle share "
             f"{1 - statistics.mean(util) / 100:.3f}" if util else "not measured"), flush=True)
    need(all(np.isfinite(losses)), f"{tag} losses not finite: {losses}")
    need(int(opt["step"]) == len(batches), f"{tag}: optimizer step {int(opt['step'])}")
    need(changed > 0, f"{tag}: no parameter changed over the train steps")
    need(launches == want, f"{tag}: kernel launches {launches} != expected {want}")
    return params, opt, launches


def train_phase(torch) -> dict:
    """The xLSTM training path on the card: (1) one pattern period at full
    width, each path's loss and gradients against plain f32 (PERIOD_GATES);
    (2) full width and depth, TRAIN's AdamW steps with remat, exact launch
    counts; (3) the reduced loop resuming exactly after an injected
    failure."""
    import tempfile
    from repro_torch import configs as C
    from repro_torch.data import DataConfig
    from repro_torch.data.pipeline import _batch_at
    from repro_torch.models import init_params
    from repro_torch.optim import AdamWConfig, tree_leaves
    from repro_torch.runtime import TrainConfig, init_opt_state, make_train_step, train_loop

    B, S = TRAIN["B"], TRAIN["S"]
    cfg = C.production_cfg(C.get_config("xlstm_1p3b"))

    def batch_at(step):
        tokens = _batch_at(DataConfig(vocab=cfg.vocab, seq_len=S, global_batch=B, seed=SEED),
                           step, 0, 1)["tokens"]
        return {"tokens": torch.from_numpy(tokens).to("cuda")}

    # (1) One period (7 mLSTM + 1 sLSTM layers) at full width, remat off:
    # each path's loss and gradient against plain f32, held to a floor of
    # the same kind (PERIOD_GATES).
    cfg8 = dataclasses.replace(cfg, n_layers=8)
    cfg8_32 = dataclasses.replace(cfg8, param_dtype="float32", compute_dtype="float32")
    p8 = init_params(SEED, cfg8, device="cuda")
    p8_32 = _tree_map(p8, lambda t: t.float())
    names = leaf_names(p8)
    batch = batch_at(0)
    t0 = time.perf_counter()
    runs = {name: loss_and_grads(torch, c, prm, batch, plain)
            for name, (c, prm, plain) in {"f32": (cfg8_32, p8_32, True),
                                         "kernel": (cfg8, p8, False),
                                         "plain": (cfg8, p8, True),
                                         "kernel32": (cfg8_32, p8_32, False)}.items()}
    for name, kind, plain in (("f32 var in f64", "var in f64", True),
                              ("f32 kernel backward", "kernel backward", False),
                              ("f32 closed-form backward", "closed-form backward", True)):
        with NormVariant(kind):
            runs[name] = loss_and_grads(torch, cfg8_32, p8_32, batch, plain)
    torch.cuda.synchronize()
    period_s = time.perf_counter() - t0
    need(all(bool(torch.isfinite(runs[n][0])) for n in runs), "period loss not finite")
    dist = {}
    for name in runs:
        if name == "f32":
            continue
        (la, ga), (lb, gb) = runs[name], runs["f32"]
        loss = (abs(la - lb) / abs(lb)).item()
        sq = [((a.float() - b) ** 2).sum().item() for a, b in zip(ga, gb)]
        grad = (sum(sq) / sum((b ** 2).sum().item() for b in gb)) ** 0.5
        leaf = [((a.float() - b).abs().max() / b.abs().max().clamp_min(1e-30)).item()
                for a, b in zip(ga, gb)]
        dist[name] = (loss, grad)
        top = sorted(range(len(leaf)), key=leaf.__getitem__, reverse=True)[:3]
        print(f"[train] one period (8 layers) at full width, {name} vs plain f32: loss "
              f"{la.item():.6f} (f32 {lb.item():.6f}), |d| / |ref| {loss:.3e}; gradient "
              f"(all {len(ga)} leaves as one vector) |d|2 / |ref|2 {grad:.3e}; per leaf "
              f"max|d| / max|g| worst " + ", ".join(f"{names[i]} {leaf[i]:.3e}" for i in top)
              + f", median {statistics.median(leaf):.3e}", flush=True)
    print(f"[train] the period's {len(runs)} paths' loss and gradients {period_s:.1f} s",
          flush=True)
    # Where one period's forward and backward spend the device's time (the
    # bf16 kernel path with remat, as the train step runs each group): its
    # unprofiled wall, then the same call under the profiler.  The full
    # depth's 48 layers would record six times the ~0.1 M kernels.
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss_and_grads(torch, cfg8, p8, batch, False, remat=True)
    torch.cuda.synchronize()
    bare = time.perf_counter() - t0
    _, groups, counts = profile_step(torch, lambda: loss_and_grads(torch, cfg8, p8, batch, False,
                                                                   remat=True))
    dev_us = sum(groups.values())
    print(f"[train] one period's forward and backward (bf16, remat, batch {B} x {S}): wall "
          f"{bare * 1e3:.3f} ms unprofiled, kernels {dev_us / 1e3:.3f} ms: device idle share "
          f"{1 - dev_us / (bare * 1e6):.3f}"
          + "".join(f"; {g} {us / 1e3:.3f} ms ({counts[g]} kernels)"
                    for g, us in sorted(groups.items(), key=lambda kv: -kv[1])), flush=True)
    for what, k, floor_name in PERIOD_GATES:
        for i, metric in enumerate(("loss", "gradient")):
            got, floor = dist[k][i], dist[floor_name][i]
            print(f"[train] {what}: {k}-f32 {metric} {got:.3e} against the floor ({floor_name}"
                  f"-f32) {floor:.3e}: " + (f"{got / floor:.3f} x" if floor else "both 0")
                  + f" (gate {BF16_FLOOR_RATIO} x)", flush=True)
            need(got <= BF16_FLOOR_RATIO * floor, f"train period: {k}-f32 {metric} {got:.3e} > "
                 f"{BF16_FLOOR_RATIO} x the floor {floor:.3e}")
    del runs, p8, p8_32
    torch.cuda.empty_cache()

    # (2) The main path: full width and depth, bf16, remat, the reference's
    # AdamW defaults, STEPS steps on the pipeline's batches 0, 1, ...
    t0 = time.perf_counter()
    params = init_params(SEED, cfg, device="cuda")
    tcfg = TrainConfig()
    opt = init_opt_state(params, tcfg)
    step = make_train_step(cfg, tcfg)
    leaves = tree_leaves(params)
    n_params = sum(t.numel() for t in leaves)
    before = [t.clone() for t in leaves]
    batches = [batch_at(i) for i in range(TRAIN["steps"])]
    torch.cuda.synchronize()
    print(f"[train] full width bf16: {cfg.n_layers} layers, {n_params / 1e9:.3f} B params, "
          f"batch {B} x {S}, {TRAIN['steps']} AdamW steps, remat; params, optimizer state and "
          f"a copy of the params set up in {time.perf_counter() - t0:.1f} s", flush=True)
    params, opt, launches = train_steps(torch, step, params, opt, batches, before, n_params,
                                        TRAIN_LAUNCHES, "train")
    del params, opt, step, leaves, batches
    torch.cuda.empty_cache()

    # (3) The reduced loop (the launcher's shrink) on the card: checkpoints
    # every 5 steps, a failure injected at step 7, a restart from step 5's
    # checkpoint; the losses after it and the final params equal an
    # uninterrupted run's bit for bit.
    rcfg = C.get_config("xlstm_1p3b").reduced(n_layers=2, d_model=128, vocab=1024)
    rtcfg = TrainConfig(optimizer=AdamWConfig(warmup_steps=2, total_steps=10))
    dcfg = DataConfig(vocab=rcfg.vocab, seq_len=64, global_batch=4)
    fired = []

    def fail_at(s):
        if s == 7 and not fired:
            fired.append(s)
            return True
        return False

    with tempfile.TemporaryDirectory() as d:
        ref = train_loop.run(rcfg, rtcfg, train_loop.LoopConfig(
            total_steps=10, ckpt_every=5, ckpt_dir=f"{d}/ref"), dcfg, device="cuda")
        out = train_loop.run_with_restarts(rcfg, rtcfg, train_loop.LoopConfig(
            total_steps=10, ckpt_every=5, ckpt_dir=f"{d}/run"), dcfg, fail_at=fail_at,
            device="cuda")
    same_params = all(torch.equal(a, b) for a, b in zip(tree_leaves(out["params"]),
                                                        tree_leaves(ref["params"])))
    print(f"[train] reduced loop on the card: uninterrupted losses "
          f"{[round(x, 6) for x in ref['losses']]}; restarts {out['restarts']}, resumed losses "
          f"(steps 5-9) {[round(x, 6) for x in out['losses']]}, bitwise equal "
          f"{out['losses'] == ref['losses'][5:]}, final params bitwise equal {same_params}; "
          f"step walls median {statistics.median(ref['walls']) * 1e3:.1f} ms", flush=True)
    need(out["restarts"] == 1 and out["losses"] == ref["losses"][5:] and same_params,
         "the resumed reduced loop does not reproduce the uninterrupted run bit for bit")

    return launches


class AttentionClosedForm:
    """While active, the plain attention (``ref.attention``, what
    ``plain=True`` runs) is computed in closed form from the rows'
    log-sum-exp, o = exp(S·scale - lse) V in f32, S over two halves of the
    head dim and P·V over two halves of the keys (each sum reassociated),
    and carries its gradient through ``ref.attention_bwd`` under an
    autograd Function, in place of softmax and autograd through it: the
    flash kernels' formulas, rounded otherwise (half of CUTS's f32 floor
    path)."""

    def __enter__(self):
        import torch
        from repro_torch.kernels import ref
        self._ref, self._real = ref, ref.attention

        def closed_form(q, k, v, lse, causal=True, window=None, scale=None, kv_offset=0):
            B, Sq, Hq, D = q.shape
            _, Skv, Hkv, Dv = v.shape
            g = Hq // Hkv
            scale = D ** -0.5 if scale is None else scale
            qf, kf, vf = q.float().reshape(B, Sq, Hkv, g, D), k.float(), v.float()
            hd, hk = D // 2, Skv // 2
            s = (torch.einsum("bqhgd,bkhd->bhgqk", qf[..., :hd], kf[..., :hd])
                 + torch.einsum("bqhgd,bkhd->bhgqk", qf[..., hd:], kf[..., hd:])) * scale
            mask = ref._attention_mask(Sq, Skv, causal, window, kv_offset, q.device)
            p = torch.exp(s.masked_fill(~mask, float("-inf"))
                          - lse.reshape(B, Hkv, g, Sq)[..., None])
            p = torch.where(mask.any(-1)[:, None], p, 1.0 / Skv)
            o = (torch.einsum("bhgqk,bkhd->bqhgd", p[..., :hk], vf[:, :hk])
                 + torch.einsum("bhgqk,bkhd->bqhgd", p[..., hk:], vf[:, hk:]))
            return o.reshape(B, Sq, Hq, Dv).to(q.dtype)

        class Attention(torch.autograd.Function):
            @staticmethod
            def forward(ctx, q, k, v, kw):
                lse = ref.attention_lse(q, k, **kw)
                o = closed_form(q, k, v, lse, **kw)
                ctx.save_for_backward(q, k, v, o, lse)
                ctx.kw = kw
                return o

            @staticmethod
            def backward(ctx, do):
                return (*ref.attention_bwd(*ctx.saved_tensors, do.contiguous(), **ctx.kw), None)

        ref.attention = lambda q, k, v, **kw: Attention.apply(q, k, v, kw)
        return self

    def __exit__(self, *exc):
        self._ref.attention = self._real


def ssd_scan_halves(x, a, b, c, h0=None, *, chunk: int = 256):
    """``chunked.ssd_scan_chunked`` with its f32 sums reassociated, as the
    scan's kernels reassociate them: the running log decays summed 32 steps
    a block and then across the blocks (pass A's block scan), and C.B^T,
    the intra-chunk product with x, the injected state and the inter-chunk
    term each over two halves of their sum."""
    import torch
    F = torch.nn.functional
    B, S, H, P = x.shape
    N = b.shape[-1]
    Q = min(chunk, S)
    xf, af, bf, cf = (t.float() for t in (x, a, b, c))
    pad = -S % Q
    if pad:  # a = 1 and zeros past S, as the plain version pads
        xf, bf, cf = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (xf, bf, cf))
        af = F.pad(af, (0, 0, 0, pad), value=1.0)
    G = xf.shape[1] // Q
    xf, bf, cf = (t.reshape(B, G, Q, H, -1) for t in (xf, bf, cf))
    k = 32 if Q % 32 == 0 else 1
    inner = torch.log(torch.clamp(af, min=1e-37)).reshape(B, G, Q // k, k, H).cumsum(3)
    blocks = inner[:, :, :, -1]
    cum = (inner + (blocks.cumsum(2) - blocks)[:, :, :, None]).reshape(B, G, Q, H)
    total = cum[:, :, -1]
    n2, q2 = N // 2, Q // 2
    ein = torch.einsum
    tri = torch.ones((Q, Q), dtype=torch.bool, device=x.device).tril()[None, None, :, :, None]
    gate = torch.exp((cum[:, :, :, None] - cum[:, :, None]).masked_fill(~tri, float("-inf")))
    m = (ein("bgthn,bgshn->bgtsh", cf[..., :n2], bf[..., :n2])
         + ein("bgthn,bgshn->bgtsh", cf[..., n2:], bf[..., n2:])) * gate
    y_intra = (ein("bgtsh,bgshp->bgthp", m[:, :, :, :q2], xf[:, :, :q2])
               + ein("bgtsh,bgshp->bgthp", m[:, :, :, q2:], xf[:, :, q2:]))
    bw = bf * torch.exp(total[:, :, None] - cum)[..., None]
    h_in = (ein("bgqhn,bgqhp->bghpn", bw[:, :, :q2], xf[:, :, :q2])
            + ein("bgqhn,bgqhp->bghpn", bw[:, :, q2:], xf[:, :, q2:]))
    h = (torch.zeros((B, H, P, N), dtype=torch.float32, device=x.device) if h0 is None
         else h0.float())
    starts = []
    for g in range(G):
        starts.append(h)
        h = h * torch.exp(total[:, g])[..., None, None] + h_in[:, g]
    hs = torch.stack(starts, dim=1)
    y_inter = (ein("bgthn,bghpn->bgthp", cf[..., :n2], hs[..., :n2])
               + ein("bgthn,bghpn->bgthp", cf[..., n2:], hs[..., n2:])) * torch.exp(cum)[..., None]
    return (y_intra + y_inter).reshape(B, -1, H, P)[:, :S].to(x.dtype), h


class SsdClosedForm:
    """While active, the plain SSD scan (``chunked.ssd_scan_chunked``, what
    ``plain=True`` runs) is ``ssd_scan_halves``, its f32 sums reassociated,
    and carries its gradient through ``ref.ssd_scan_bwd``, the closed form,
    under an autograd Function in place of autograd through the chunked
    form: the kernels' formulas, rounded otherwise (with the norms' and
    attention's, CUT_GATES's f32 floor path for a hybrid model).  On an
    NVIDIA H100 80GB HBM3 at 700 W (hymba's two-layer cut at 4096 tokens)
    the f32 kernel path sat at 1.041 x this floor's token loss and 1.145 x
    its gradient; against a floor whose scan only ran in chunks of half the
    length, a smaller change than the kernels' reassociation, at 1.484 x
    its token loss."""

    def __enter__(self):
        import torch
        from repro_torch.kernels import ops, ref
        self._ops, self._real = ops, ops.ssd_scan_chunked

        class Scan(torch.autograd.Function):
            @staticmethod
            def forward(ctx, x, a, b, c, h0, chunk):
                ctx.save_for_backward(x, a, b, c, h0)
                ctx.chunk = chunk
                return ssd_scan_halves(x, a, b, c, h0, chunk=chunk)

            @staticmethod
            def backward(ctx, dy, dh):
                x, a, b, c, h0 = ctx.saved_tensors
                return (*ref.ssd_scan_bwd(x, a, b, c, h0, dy, dh, chunk=ctx.chunk), None)

        ops.ssd_scan_chunked = lambda x, a, b, c, h0=None, *, chunk=256: Scan.apply(
            x, a, b, c, h0, chunk)
        return self

    def __exit__(self, *exc):
        self._ops.ssd_scan_chunked = self._real


def cut_batch(torch, cfg, S: int) -> dict:
    """One sequence of the pipeline's batch 0 at ``S`` tokens (embeddings
    and labels for an embedding-stub arch), on the card."""
    from repro_torch.data import DataConfig
    from repro_torch.data.pipeline import _batch_at
    b = _batch_at(DataConfig(vocab=cfg.vocab, seq_len=S, global_batch=1, seed=SEED,
                             embed_stub_dim=cfg.d_model if cfg.embed_stub else None), 0, 0, 1)
    return {k: torch.from_numpy(v).to("cuda") for k, v in b.items()}


def token_nll(torch, cfg, params, batch, plain: bool):
    """The sequence's per-token NLL, as ``transformer.loss_fn`` forms it
    before its mean (f32, no gradient)."""
    from repro_torch.models import transformer
    with torch.no_grad():
        logits, _ = transformer.forward(params, cfg, batch, keep_padded=True, plain=plain)
        labels = batch.get("labels")
        if labels is None:
            labels, logits = batch["tokens"][:, 1:], logits[:, :-1]
        logp = torch.nn.functional.log_softmax(logits.float(), dim=-1)
        return -logp.gather(-1, labels.long()[..., None])[..., 0].flatten()


def train_cut(torch, arch: str, S: int, tag: str = "train attention") -> None:
    """A two-layer cut of ``arch`` at full width (CUTS): each path's loss
    (token by token) and gradient (every leaf as one vector) against plain
    f32, remat off, held to CUT_GATES's floors at BF16_FLOOR_RATIO.  A
    hybrid model's f32 floor path also takes ``SsdClosedForm``."""
    from repro_torch import configs as C
    from repro_torch.models import init_params
    cfg = dataclasses.replace(C.production_cfg(C.get_config(arch)), n_layers=2)
    cfg32 = dataclasses.replace(cfg, param_dtype="float32", compute_dtype="float32")
    p = init_params(SEED, cfg, device="cuda")
    p32 = _tree_map(p, lambda t: t.float())
    names = leaf_names(p)
    batch = cut_batch(torch, cfg, S)
    t0 = time.perf_counter()
    runs = {}
    with (RouteLog("f32") if cfg.moe is not None else contextlib.nullcontext()) as routes:
        for name, c, prm, plain in (("f32", cfg32, p32, True), ("kernel", cfg, p, False),
                                    ("plain", cfg, p, True), ("kernel32", cfg32, p32, False),
                                    ("f32 floor", cfg32, p32, True)):
            if routes is not None:
                routes.path = name
            with contextlib.ExitStack() as variants:
                if name == "f32 floor":
                    variants.enter_context(NormVariant("var in halves, closed-form backward"))
                    variants.enter_context(AttentionClosedForm())
                    if cfg.ssm is not None:
                        variants.enter_context(SsdClosedForm())
                runs[name] = (*loss_and_grads(torch, c, prm, batch, plain),
                              token_nll(torch, c, prm, batch, plain))
            torch.cuda.empty_cache()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    dist = {}
    for name in runs:
        if name == "f32":
            continue
        (la, ga, na), (lb, gb, nb) = runs[name], runs["f32"]
        mean = (abs(la.float() - lb) / abs(lb)).item()
        tokens = (torch.linalg.vector_norm(na - nb) / torch.linalg.vector_norm(nb)).item()
        sq = [((a.float() - b) ** 2).sum().item() for a, b in zip(ga, gb)]
        grad = (sum(sq) / sum((b ** 2).sum().item() for b in gb)) ** 0.5
        leaf = [((a.float() - b).abs().max() / b.abs().max().clamp_min(1e-30)).item()
                for a, b in zip(ga, gb)]
        dist[name] = (tokens, grad)
        top = sorted(range(len(leaf)), key=leaf.__getitem__, reverse=True)[:3]
        print(f"[{tag}] {arch} two layers at full width, S {S}: {name} vs plain f32: "
              f"loss {la.item():.6f} (f32 {lb.item():.6f}), |d| / |ref| {mean:.3e}, token by "
              f"token |d|2 / |ref|2 {tokens:.3e}; gradient ({len(ga)} leaves as one vector) "
              f"|d|2 / |ref|2 {grad:.3e}; per leaf max|d| / max|g| worst "
              + ", ".join(f"{names[i]} {leaf[i]:.3e}" for i in top)
              + f", median {statistics.median(leaf):.3e}", flush=True)
    need(all(bool(torch.isfinite(r[0])) and bool(torch.isfinite(r[2]).all())
             for r in runs.values()), f"{arch} cut: loss not finite")
    for what, k, floor_name in CUT_GATES:
        for i, metric in enumerate(("token loss", "gradient")):
            got, floor = dist[k][i], dist[floor_name][i]
            print(f"[{tag}] {arch} {what}: {k}-f32 {metric} {got:.3e} against the "
                  f"floor ({floor_name}-f32) {floor:.3e}: "
                  + (f"{got / floor:.3f} x" if floor else "both 0")
                  + f" (gate {BF16_FLOOR_RATIO} x)", flush=True)
            need(got <= BF16_FLOOR_RATIO * floor, f"{arch} cut: {k}-f32 {metric} {got:.3e} > "
                 f"{BF16_FLOOR_RATIO} x the floor {floor:.3e}")
    print(f"[{tag}] {arch} cut: {len(runs)} paths' loss and gradients {wall:.1f} s",
          flush=True)


def full_depth_steps(torch, spec: dict, want: dict, tag: str) -> dict:
    """``spec``'s arch at full width and depth, bf16, remat, its steps of
    AdamW through ``make_train_step`` on the pipeline's batches 0, 1, ...
    with every launch count set to 0 just before and read just after (exact
    launches ``want``, finite losses, walls, idle share, peak memory:
    ``train_steps``); then one more step's unprofiled wall and the same step
    under the profiler, by kernel group.  Returns the steps' launches."""
    from repro_torch import configs as C
    from repro_torch.data import DataConfig
    from repro_torch.data.pipeline import _batch_at
    from repro_torch.models import init_params
    from repro_torch.optim import tree_leaves
    from repro_torch.runtime import TrainConfig, init_opt_state, make_train_step

    card = card_line()
    B, S = spec["B"], spec["S"]
    cfg = C.production_cfg(C.get_config(spec["arch"]))
    need(cfg.n_layers == spec["layers"], f"{cfg.n_layers} layers")
    t0 = time.perf_counter()
    params = init_params(SEED, cfg, device="cuda")
    tcfg = TrainConfig()
    opt = init_opt_state(params, tcfg)
    step = make_train_step(cfg, tcfg)
    n_params = sum(t.numel() for t in tree_leaves(params))
    before = [t.clone() for t in tree_leaves(params)]
    batches = [{"tokens": torch.from_numpy(_batch_at(DataConfig(
        vocab=cfg.vocab, seq_len=S, global_batch=B, seed=SEED), i, 0, 1)["tokens"]).cuda()}
        for i in range(spec["steps"])]
    torch.cuda.synchronize()
    print(f"[{tag}] {spec['arch']} full width bf16: {cfg.n_layers} layers, "
          f"{n_params / 1e9:.3f} B params, batch {B} x {S}, {spec['steps']} AdamW steps, "
          f"remat; set up in {time.perf_counter() - t0:.1f} s [{card}]", flush=True)
    params, opt, launches = train_steps(torch, step, params, opt, batches, before, n_params,
                                        want, tag)
    # Where a step's device time goes: one more step, its unprofiled wall,
    # then the same under the profiler, by kernel group.
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step(params, opt, batches[0])
    torch.cuda.synchronize()
    bare = time.perf_counter() - t0
    _, groups, counts = profile_step(torch, lambda: step(params, opt, batches[0]))
    dev_us = sum(groups.values())
    print(f"[{tag}] one step (bf16, remat, batch {B} x {S}): wall {bare * 1e3:.3f} ms "
          f"unprofiled, kernels {dev_us / 1e3:.3f} ms: device idle share "
          f"{1 - dev_us / (bare * 1e6):.3f}"
          + "".join(f"; {g} {us / 1e3:.3f} ms ({counts[g]} kernels)"
                    for g, us in sorted(groups.items(), key=lambda kv: -kv[1])) + f" [{card}]",
          flush=True)
    del params, opt, step, batches
    torch.cuda.empty_cache()
    return launches


def train_attention_phase(torch) -> dict:
    """The attention train path and its checks: (1) internlm2-1.8B at full
    width and depth, bf16, remat, TRAIN_ATTN's three AdamW steps through
    ``make_train_step`` (``full_depth_steps``: exact forward and backward
    launches of both kernels, finite losses, walls, idle share, peak
    memory); (2) the two-layer cuts (CUTS) held to their floors; (3) the
    launcher's default command (``python -m repro_torch.launch.train``:
    reduced internlm2 on the card) in a child process, and the reduced
    loop's exact resume for internlm2.  Returns (1)'s launches."""
    import tempfile
    from repro_torch import configs as C
    from repro_torch.data import DataConfig
    from repro_torch.optim import AdamWConfig, tree_leaves
    from repro_torch.runtime import TrainConfig, train_loop

    launches = full_depth_steps(torch, TRAIN_ATTN, TRAIN_ATTN_LAUNCHES, "train attention")

    for arch, cut_s in CUTS.items():
        train_cut(torch, arch, cut_s)
        torch.cuda.empty_cache()

    # (3) the launcher's default command, as a user runs it
    with tempfile.TemporaryDirectory() as d:
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
        t0 = time.perf_counter()
        r = subprocess.run([sys.executable, "-m", "repro_torch.launch.train", "--ckpt-dir",
                            f"{d}/ckpt"], capture_output=True, text=True, env=env, cwd=ROOT,
                           timeout=300)
        wall = time.perf_counter() - t0
    out = [line for line in r.stdout.splitlines() if line.startswith("[train]")]
    print(f"[train attention] python -m repro_torch.launch.train (the default command: "
          f"reduced internlm2, 50 steps, batch 8 x 128, on the card): rc {r.returncode}, "
          f"{wall:.1f} s; {out[-1] if out else r.stderr[-2000:]}", flush=True)
    need(r.returncode == 0 and out and "device=cuda" in out[-1] and "nan" not in out[-1],
         f"the launcher's default command failed: {r.stderr[-3000:]}")

    rcfg = C.get_config(TRAIN_ATTN["arch"]).reduced(n_layers=2, d_model=128, vocab=1024)
    rtcfg = TrainConfig(optimizer=AdamWConfig(warmup_steps=2, total_steps=10))
    dcfg = DataConfig(vocab=rcfg.vocab, seq_len=64, global_batch=4)
    fired = []

    def fail_at(s):
        if s == 7 and not fired:
            fired.append(s)
            return True
        return False

    with tempfile.TemporaryDirectory() as d:
        ref = train_loop.run(rcfg, rtcfg, train_loop.LoopConfig(
            total_steps=10, ckpt_every=5, ckpt_dir=f"{d}/ref"), dcfg, device="cuda")
        res = train_loop.run_with_restarts(rcfg, rtcfg, train_loop.LoopConfig(
            total_steps=10, ckpt_every=5, ckpt_dir=f"{d}/run"), dcfg, fail_at=fail_at,
            device="cuda")
    same_params = all(torch.equal(a, b) for a, b in zip(tree_leaves(res["params"]),
                                                        tree_leaves(ref["params"])))
    print(f"[train attention] reduced internlm2 loop on the card: uninterrupted losses "
          f"{[round(x, 6) for x in ref['losses']]}; restarts {res['restarts']}, resumed losses "
          f"(steps 5-9) {[round(x, 6) for x in res['losses']]}, bitwise equal "
          f"{res['losses'] == ref['losses'][5:]}, final params bitwise equal {same_params}; "
          f"step walls median {statistics.median(ref['walls']) * 1e3:.1f} ms", flush=True)
    need(res["restarts"] == 1 and res["losses"] == ref["losses"][5:] and same_params,
         "the resumed reduced internlm2 loop does not reproduce the uninterrupted run bit for "
         "bit")
    return launches


def train_hybrid_phase(torch) -> dict:
    """This slice's main path and its checks: (1) hymba-1.5B at full width
    and depth, bf16, remat, TRAIN_HYBRID's three AdamW steps through
    ``make_train_step`` (``full_depth_steps``: exact forward and backward
    launches of the SSD scan, flash attention and the norms, finite losses,
    walls, idle share, peak memory); (2) its two-layer cut at one sequence
    of 4096, each path's loss token by token and its whole gradient against
    plain f32, held to CUT_GATES's floors (the f32 floor with
    ``SsdClosedForm``).  Returns (1)'s launches."""
    launches = full_depth_steps(torch, TRAIN_HYBRID, TRAIN_HYBRID_LAUNCHES, "train hybrid")
    train_cut(torch, TRAIN_HYBRID["arch"], TRAIN_HYBRID["S"], tag="train hybrid")
    torch.cuda.empty_cache()
    return launches


# The dry-run's cells held on the card (arch, shape): the three long_500k
# cells whole (their global batch is 1), internlm2's at the trace's largest
# batch that fits one card.
DRYRUN_CELLS = (("h2o_danube3_4b", "long_500k"), ("hymba_1p5b", "long_500k"),
                ("xlstm_1p3b", "long_500k"), ("internlm2_1p8b", "decode_32k"),
                ("internlm2_1p8b", "prefill_32k"), ("internlm2_1p8b", "train_4k"))
# The card's peak against the trace's: within 2 % and 64 MiB (what the trace
# does not see: kernels' own temporaries, as cub's in a sort, and blocks the
# allocator does not split).
PEAK_REL, PEAK_ABS = 0.02, 64 * 2**20
QUERY_BLOCK = 2048  # the plain attention's queries a block at 32,768 tokens


def attention_by_query_blocks(torch, whole, q, k, v, *, causal=True, window=None, scale=None,
                              kv_offset=0):
    """``whole`` (``ref.attention``) one block of QUERY_BLOCK queries at a
    time, each against the keys its causal mask leaves it: the same rows,
    softmax by softmax, but not the whole (B, H, Sq, Skv) f32 logits, which
    at 32,768 tokens are 68.7 GB a layer and sequence."""
    Sq = q.shape[1]
    if Sq <= QUERY_BLOCK:
        return whole(q, k, v, causal=causal, window=window, scale=scale, kv_offset=kv_offset)
    outs = []
    for i in range(0, Sq, QUERY_BLOCK):
        end = min(i + QUERY_BLOCK, Sq)
        kv = min(k.shape[1], end + kv_offset) if causal else k.shape[1]
        outs.append(whole(q[:, i:end], k[:, :kv], v[:, :kv], causal=causal, window=window,
                          scale=scale, kv_offset=kv_offset + i))
    return torch.cat(outs, dim=1)


@contextlib.contextmanager
def plain_attention_by_query_blocks(torch):
    """``ref.attention`` (what ``plain=True`` runs) replaced, while active,
    by ``attention_by_query_blocks`` of it."""
    from repro_torch.kernels import ref
    whole = ref.attention
    ref.attention = lambda q, k, v, **kw: attention_by_query_blocks(torch, whole, q, k, v, **kw)
    try:
        yield
    finally:
        ref.attention = whole


def flash_hold(torch, randn, B, S, hq, hkv, hd, what: str) -> dict:
    """Flash attention at a dry-run cell's own shape (bf16, causal), too
    large for ``flash_record``'s whole plain version: the kernel's output
    held to ``ref.attention`` sequence by sequence, by query blocks, for
    every sequence.  A call takes tenths of a second, so the kernel and SDPA
    are timed a call a window and the plain version once, in its check."""
    from repro_torch.kernels import cost, ref
    from repro_torch.kernels.flash_attention import flash_attention
    F = torch.nn.functional
    q, k, v = (randn(B, S, h, hd, dtype=torch.bfloat16) for h in (hq, hkv, hkv))
    got = flash_attention(q, k, v, causal=True)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    want = [attention_by_query_blocks(torch, ref.attention, q[b:b + 1], k[b:b + 1], v[b:b + 1])
            for b in range(B)]
    end.record()
    torch.cuda.synchronize()
    err = max(close(got[b:b + 1], w, "bfloat16", f"flash_attention {what} sequence {b}")
              for b, w in enumerate(want))
    del got, want
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    library_ms = time_ms([lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, enable_gqa=True)], reps=3, inner=1)
    del qt, kt, vt
    work = cost.flash_attention(B, S, S, hq, hkv, hd, hd, q.element_size(), True)
    rec = dict(
        name="flash_attention", max_abs_err=err,
        shape=f"q ({B},{S},{hq},{hd}), k/v ({B},{S},{hkv},{hd}) bfloat16 causal [{what}]",
        ms=time_ms([lambda: flash_attention(q, k, v, causal=True)], reps=3, inner=1),
        plain_ms=start.elapsed_time(end), library_ms=library_ms,
        bytes_ms=work.bytes / PEAK_BYTES * 1e3, ops_ms=work.flops / PEAK_BF16 * 1e3)
    return finish(rec)


def dryrun_inputs(torch, cfg, kind: str, B: int, S: int, dtype=None, first: int = 0) -> dict:
    """The step's inputs on the card for sequences ``first`` .. ``first + B
    - 1``, sequence by sequence from seeds, so that a sequence alone is the
    same at any batch: prompts (prefill), or the last token and a cache of
    S slots (decode; attention caches and SSM states drawn N(0, 1) in
    ``cfg``'s dtypes, xLSTM's cells at ``init_cache``'s values), its
    floating leaves cast to ``dtype`` if given (the f32 path's inputs: the
    same values)."""
    from repro_torch.models import init_cache
    seqs = range(first, first + B)
    if kind == "train":  # the step's optimizer state is made beside the params (dryrun_cell)
        rows = [np.random.default_rng([SEED, b]).integers(0, cfg.vocab, S, dtype=np.int32)
                for b in seqs]
        return {"batch": {"tokens": torch.from_numpy(np.stack(rows)).cuda()}}
    if kind == "prefill":
        rows = [np.random.default_rng([SEED, b]).integers(0, cfg.vocab, S, dtype=np.int32)
                for b in seqs]
        return {"batch": {"tokens": torch.from_numpy(np.stack(rows)).cuda()}}
    tok = [np.random.default_rng([SEED, b]).integers(0, cfg.vocab, 1, dtype=np.int32)
           for b in seqs]
    cache = init_cache(cfg, B, S, device="cuda")
    for layer, c in enumerate(cache):
        for j, (name, t) in enumerate(sorted(c.items())):
            if name in ("k", "v", "latent", "conv", "ssm"):
                for i, b in enumerate(seqs):
                    seed = ((SEED * 4096 + layer) * 16 + j) * 2**20 + b
                    t[i].normal_(generator=torch.Generator(device="cuda").manual_seed(seed))
            if dtype is not None and t.is_floating_point():
                c[name] = t.to(dtype)
    return {"tokens": torch.from_numpy(np.stack(tok)).cuda(), "cache": cache, "pos": S - 1}


def dryrun_phase(torch) -> tuple[dict, list]:
    """Each of DRYRUN_CELLS (``dryrun_cell``), on expandable segments, which
    the dry-run's peaks assume (``dryrun.ALLOCATOR``): on fixed segments a
    large segment's unsplit rest and the holes between blocks bind first
    (danube's arguments came out 66.6 MB over their blocks' sum, and
    prefill_32k at its traced batch 13 ran out of memory with 13.01 GiB
    reserved but unallocated).  The card's memory is printed beside the
    dry-run's cap, which must be free.  Returns the launches of the cells'
    steps, and the records of the kernels held at the cells' shapes."""
    from repro_torch.device import expandable_segments
    from repro_torch.launch import dryrun
    card = card_line()
    launches = {name: 0 for name in all_kernels()}
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info()
    cap = dryrun.CARD_BYTES - dryrun.RESERVE_BYTES
    print(f"[dryrun] card memory: total {total} B, free {free} B with "
          f"{torch.cuda.memory_reserved()} B reserved by this process; "
          f"the dry-run's cap {cap} B = CARD_BYTES {dryrun.CARD_BYTES} less RESERVE_BYTES "
          f"{dryrun.RESERVE_BYTES} [{card}]", flush=True)
    need(cap <= free + torch.cuda.memory_reserved(),
         f"dryrun: the cap {cap} B is more than the card has free ({free} B)")
    held = []
    expandable_segments()
    try:
        for arch, shape_name in DRYRUN_CELLS:
            held += dryrun_cell(torch, arch, shape_name, card, launches)
    finally:
        torch.cuda.empty_cache()
        expandable_segments(False)
    return launches, held


def dryrun_step(torch, cfg, kind: str, params, inputs):
    """The cell's step on ``inputs`` (``dryrun_inputs``), through the
    kernels, as a function of nothing."""
    from repro_torch.runtime import (TrainConfig, make_decode_step, make_prefill_step,
                                     make_train_step)
    if kind == "train":
        step = make_train_step(cfg, TrainConfig())
        return lambda: step(params, inputs["opt"], inputs["batch"])[2]
    if kind == "prefill":
        step = make_prefill_step(cfg)
        return lambda: step(params, inputs["batch"])
    step = make_decode_step(cfg)
    return lambda: step(params, inputs["tokens"], inputs["cache"], inputs["pos"])


def dryrun_cell(torch, arch: str, shape_name: str, card: str, launches: dict) -> list:
    """One of DRYRUN_CELLS: the dry-run's record (``run_cell``, traced on
    meta tensors), then the cell's step on the card at the record's batch B
    (its global batch if that fits, else its largest that fits) with the
    arguments resident.  Its launches equal the trace's kernel calls, its
    peak device memory the trace's within PEAK_REL and PEAK_ABS, its
    outputs the trace's shapes, and sequences 0 and B - 1's bf16 logits
    meet the serve phase's floor gate against the plain path in bf16 and
    f32 (each at batch 1); its wall, and the step's FLOPs and computed bytes
    over it as shares of the bf16 peak and the byte rate, are printed, and
    its launches added to ``launches``.  Where B is the largest batch under
    the cap, batch B + 1 is run too and must go over the cap or out of
    memory, and each kernel of the step is held to its plain version at the
    cell's shape for every sequence (their records are returned)."""
    from repro_torch import configs as C
    from repro_torch.configs.base import SHAPES
    from repro_torch.launch import dryrun
    from repro_torch.models import init_params
    from repro_torch.runtime import make_decode_step, make_prefill_step
    t_cell = time.perf_counter()
    rec = dryrun.run_cell(arch, shape_name, False, save=False, verbose=False)
    print(dryrun.summary(rec), flush=True)
    print(f"[dryrun] record {json.dumps(rec)}", flush=True)
    need(rec["status"] == "ok", f"dryrun {arch} {shape_name}: {rec.get('error')}")
    if SHAPES[shape_name].kind == "train":
        return dryrun_train_cell(torch, rec, card, launches, t_cell)
    shape, oc = SHAPES[shape_name], rec["one_card"]
    if shape.global_batch == 1:
        need(oc["fits"], f"dryrun {arch} {shape_name}: the whole cell does not fit one card")
        B, want = 1, {**rec["work"], "peak_bytes": oc["peak_bytes"]}
    else:
        need(oc["max_batch"] >= 1, f"dryrun {arch} {shape_name}: no batch fits one card")
        B, want = oc["max_batch"], oc["check"]
    S, kind = shape.seq_len, shape.kind
    cfg = C.production_cfg(C.get_config(arch))
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    params = init_params(SEED, cfg, device="cuda")
    inputs = dryrun_inputs(torch, cfg, kind, B, S)
    torch.cuda.synchronize()
    args = torch.cuda.memory_allocated() - base
    run = dryrun_step(torch, cfg, kind, params, inputs)
    rows = sorted({0, B - 1})
    torch.cuda.reset_peak_memory_stats()
    with torch.inference_mode():
        (logits, cache), counts, wall = counted(torch, run)
        got_out = dict(collections.Counter(str(tuple(t.shape))
                                           for t in [logits] + _leaves(cache)))
        kernel = {r: logits[r].float().clone() for r in rows}
        finite = bool(torch.isfinite(logits).all())
        del logits, cache
        if kind == "decode":  # the same step again (the same slot, the same values), warm
            _, _, wall = counted(torch, run)
    peak = torch.cuda.max_memory_allocated() - base
    del inputs, run
    print(f"[dryrun] {arch} {shape_name} on the card at batch {B}: arguments {args} B "
          f"(trace {want['arg_bytes']}), peak {peak} B against the trace's "
          f"{want['peak_bytes']} ({(peak - want['peak_bytes']) / 2**20:+.1f} MiB, "
          f"{peak / want['peak_bytes'] - 1:+.4%}; the step's rise over its arguments "
          f"{peak - args} B, traced {want['peak_bytes'] - want['arg_bytes']}); "
          f"reserved at most {torch.cuda.max_memory_reserved()} B; launches {counts} (trace "
          f"{want['kernel_calls']}); step wall {wall * 1e3:.3f} ms"
          + (" (warm, the second of two)" if kind == "decode" else " (the first call)")
          + f"; mfu {want['flops'] / (wall * PEAK_BF16):.4f}, computed bytes over the "
          f"byte rate {want['hbm_bytes'] / (wall * PEAK_BYTES):.4f} [{card}]", flush=True)
    need({k: counts[k] for k in want["kernel_calls"]} == want["kernel_calls"]
         and counts["dp_sweep"] == 0,
         f"dryrun {arch} {shape_name}: launches {counts} != the trace's "
         f"{want['kernel_calls']}")
    need(abs(peak - want["peak_bytes"]) <= PEAK_REL * want["peak_bytes"] + PEAK_ABS,
         f"dryrun {arch} {shape_name}: peak {peak} B vs the trace's {want['peak_bytes']} B")
    need(got_out == want["outputs"],
         f"dryrun {arch} {shape_name}: outputs {got_out} != the trace's {want['outputs']}")
    need(finite, f"dryrun {arch} {shape_name}: logits not finite")
    for name in launches:
        launches[name] += counts[name]

    # Each of sequences 0 and B - 1 alone through the plain path in bf16 and
    # in f32 (f32 weights, the same inputs upcast): the kernel path's
    # distance from f32 at most BF16_FLOOR_RATIO times the plain path's.
    cfg32 = dataclasses.replace(cfg, param_dtype="float32", compute_dtype="float32")
    for r in rows:
        logits = {"kernel": kernel.pop(r)}
        for name, c, prm in (("plain", cfg, params),
                             ("f32", cfg32, _tree_map(params, lambda t: t.float()))):
            one = dryrun_inputs(torch, cfg, kind, 1, S, None if c is cfg else torch.float32, r)
            with torch.inference_mode(), plain_attention_by_query_blocks(torch):
                if kind == "prefill":  # the logits alone: the cache goes at once
                    out = make_prefill_step(c, plain=True)(prm, one["batch"])[0]
                else:
                    out = make_decode_step(c, plain=True)(prm, one["tokens"], one["cache"],
                                                          one["pos"])[0]
            logits[name] = out[0].float()
            del one, out, prm
            torch.cuda.empty_cache()
        rel = {pair: rel_max(logits[pair.split("-")[0]], logits[pair.split("-")[1]])
               for pair in ("kernel-f32", "plain-f32", "kernel-plain")}
        print(f"[dryrun] {arch} {shape_name} sequence {r} of {B}'s logits (plain paths at "
              f"batch 1): " + ", ".join(f"{k} {v:.3e}" for k, v in rel.items())
              + f"; kernel-f32 = {rel['kernel-f32'] / rel['plain-f32']:.3f} x the floor (gate "
              f"{BF16_FLOOR_RATIO})", flush=True)
        need(rel["kernel-f32"] <= BF16_FLOOR_RATIO * rel["plain-f32"],
             f"dryrun {arch} {shape_name} sequence {r}: logits kernel-f32 "
             f"{rel['kernel-f32']:.3e} > {BF16_FLOOR_RATIO} x the floor {rel['plain-f32']:.3e}")
        del logits
    if shape.global_batch > 1:
        dryrun_next_batch(torch, cfg, kind, S, params, base, oc, f"{arch} {shape_name}", card)
    del params
    torch.cuda.empty_cache()
    held = (dryrun_kernel_holds(torch, cfg, kind, B, S, f"{arch} {shape_name} at batch {B}")
            if shape.global_batch > 1 else [])
    print(f"[dryrun] {arch} {shape_name}: cell {time.perf_counter() - t_cell:.1f} s", flush=True)
    return held


def train_state(params) -> dict:
    """A fresh AdamW state for ``params`` at the reference's defaults."""
    from repro_torch.runtime import TrainConfig, init_opt_state
    return init_opt_state(params, TrainConfig())


def dryrun_train_cell(torch, rec: dict, card: str, launches: dict, t_cell: float) -> list:
    """A train cell of DRYRUN_CELLS: the step (``make_train_step``: forward,
    remat backward through both backward kernels, AdamW) on the card at the
    record's largest batch that fits one card, params and optimizer state
    resident.  Gates: launches equal the trace's kernel calls, peak device
    memory the trace's within PEAK_REL and PEAK_ABS, the metrics the trace's
    shapes, a finite loss; then the next batch must peak over the cap or run
    out of memory (``dryrun_next_batch``)."""
    from repro_torch import configs as C
    from repro_torch.configs.base import SHAPES
    from repro_torch.models import init_params
    arch, shape_name = rec["arch"], rec["shape"]
    shape, oc = SHAPES[shape_name], rec["one_card"]
    need(oc["max_batch"] >= 1, f"dryrun {arch} {shape_name}: no batch fits one card")
    B, S, want = oc["max_batch"], shape.seq_len, oc["check"]
    cfg = C.production_cfg(C.get_config(arch))
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    params = init_params(SEED, cfg, device="cuda")
    inputs = dryrun_inputs(torch, cfg, "train", B, S)
    inputs["opt"] = train_state(params)
    torch.cuda.synchronize()
    args = torch.cuda.memory_allocated() - base
    run = dryrun_step(torch, cfg, "train", params, inputs)
    torch.cuda.reset_peak_memory_stats()
    metrics, counts, wall = counted(torch, run)
    peak = torch.cuda.max_memory_allocated() - base
    got_out = dict(collections.Counter(str(tuple(t.shape)) for t in _leaves(metrics)))
    loss = metrics["loss"].item()
    del inputs, run, metrics
    print(f"[dryrun] {arch} {shape_name} on the card at batch {B} x {S}: arguments {args} B "
          f"(trace {want['arg_bytes']}), peak {peak} B against the trace's "
          f"{want['peak_bytes']} ({(peak - want['peak_bytes']) / 2**20:+.1f} MiB, "
          f"{peak / want['peak_bytes'] - 1:+.4%}; the step's rise over its arguments "
          f"{peak - args} B, traced {want['peak_bytes'] - want['arg_bytes']}); "
          f"reserved at most {torch.cuda.max_memory_reserved()} B; launches {counts} (trace "
          f"{want['kernel_calls']}); loss {loss:.6f}; step wall {wall * 1e3:.3f} ms (the "
          f"first call); mfu {want['flops'] / (wall * PEAK_BF16):.4f}, computed bytes over "
          f"the byte rate {want['hbm_bytes'] / (wall * PEAK_BYTES):.4f} [{card}]", flush=True)
    need({k: counts[k] for k in want["kernel_calls"]} == want["kernel_calls"]
         and counts["dp_sweep"] == 0,
         f"dryrun {arch} {shape_name}: launches {counts} != the trace's "
         f"{want['kernel_calls']}")
    need(abs(peak - want["peak_bytes"]) <= PEAK_REL * want["peak_bytes"] + PEAK_ABS,
         f"dryrun {arch} {shape_name}: peak {peak} B vs the trace's {want['peak_bytes']} B")
    need(got_out == want["outputs"],
         f"dryrun {arch} {shape_name}: outputs {got_out} != the trace's {want['outputs']}")
    need(np.isfinite(loss), f"dryrun {arch} {shape_name}: loss {loss}")
    for name in launches:
        launches[name] += counts[name]
    dryrun_next_batch(torch, cfg, "train", S, params, base, oc, f"{arch} {shape_name}", card)
    del params
    torch.cuda.empty_cache()
    print(f"[dryrun] {arch} {shape_name}: cell {time.perf_counter() - t_cell:.1f} s", flush=True)
    return []


def dryrun_next_batch(torch, cfg, kind: str, S: int, params, base: int, oc: dict, what: str,
                      card: str) -> None:
    """The batch after the dry-run's largest (``oc["next"]``) on the card,
    with ``params`` resident and ``base`` the bytes allocated before them:
    the step must run out of memory, or peak over the cap within PEAK_REL
    and PEAK_ABS of its trace."""
    nxt, cap = oc["next"], oc["capacity_bytes"]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    try:
        inputs = dryrun_inputs(torch, cfg, kind, nxt["batch"], S)
        if kind == "train":
            inputs["opt"] = train_state(params)
        run = dryrun_step(torch, cfg, kind, params, inputs)
        with torch.inference_mode(kind != "train"):
            out = run()
            torch.cuda.synchronize()
        del out
        peak = torch.cuda.max_memory_allocated() - base
    except torch.OutOfMemoryError as e:
        peak, why = None, " ".join(str(e).split(" If reserved")[0].split())
    inputs = run = None
    torch.cuda.empty_cache()
    print(f"[dryrun] {what} at batch {nxt['batch']} (the dry-run's largest + 1): "
          + (f"out of memory ({why})" if peak is None else f"peak {peak} B")
          + f" against the trace's {nxt['peak_bytes']} B and the cap {cap} B [{card}]",
          flush=True)
    need(peak is None or (peak > cap and abs(peak - nxt["peak_bytes"])
                          <= PEAK_REL * nxt["peak_bytes"] + PEAK_ABS),
         f"{what}: batch {nxt['batch']} peaks at {peak} B, under the cap {cap} B or off its "
         f"trace's {nxt['peak_bytes']} B")


def dryrun_kernel_holds(torch, cfg, kind: str, B: int, S: int, what: str) -> list:
    """The step's attention kernel at the cell's shape, on random inputs,
    against its plain version for every sequence: decode attention over a
    full cache of S slots (``decode_record``), flash attention over S tokens
    (``flash_hold``)."""
    gen = torch.Generator(device="cuda").manual_seed(SEED)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    need(cfg.window is None and cfg.mla is None, f"{what}: the holds take plain causal GQA")
    if kind == "decode":
        rec = decode_record(torch, randn, B, S, S, cfg.n_heads, cfg.n_kv, cfg.hd, what)
    else:
        rec = flash_hold(torch, randn, B, S, cfg.n_heads, cfg.n_kv, cfg.hd, what)
    torch.cuda.empty_cache()
    return [rec]


class RouteLog:
    """The MoE's routing in the path comparison.  Routing is a discrete
    choice: where two paths' hidden states differ by rounding, a near-tie
    among the router's logits sends a token to another expert (and at
    decode, cap 1, drops another slot), and the flip then spreads through
    the later layers and tokens.  So, while active, the path named ``lead``
    routes freely and every other path dispatches each layer's tokens to
    the lead's top-k experts, in the lead's order (so capacity keeps the
    same slots), with gates from its own router logits at those experts:
    the paths then differ by their arithmetic alone, which is what the
    logits gates hold.  Each path's own top-k choice is still taken, and
    its sets (sorted) appended to the list of the path named ``path``.
    ``compare`` then takes, for each pair of paths, the share of (layer,
    token) rows whose own top-k sets agree at this step (prefill first,
    then each decode step) and the layers where they differ, and clears the
    lists."""

    def __init__(self, lead: str):
        self.lead, self.path, self.sets, self.forced, self.steps = lead, None, {}, [], []

    def __enter__(self):
        import torch
        from repro_torch.models import moe
        self._moe, self._real = moe, moe._route

        def spy(p, cfg, x2):
            gates, topi, aux = self._real(p, cfg, x2)
            if self.path is None:
                return gates, topi, aux
            own = self.sets.setdefault(self.path, [])
            own.append(topi.sort(dim=-1).values)
            if self.path == self.lead:
                self.forced.append(topi)
                return gates, topi, aux
            forced = self.forced[len(own) - 1]
            logits = x2.float() @ p["router"]
            return torch.softmax(logits.gather(-1, forced), dim=-1), forced, aux

        moe._route = spy
        return self

    def __exit__(self, *exc):
        self._moe._route = self._real
        self.path = None

    def compare(self, pairs) -> None:
        import torch
        step = {}
        for pair in pairs:
            a, b = (self.sets[n] for n in pair.split("-"))
            rows = torch.stack([(x == y).all(-1) for x, y in zip(a, b)])   # (layers, tokens)
            step[pair] = (rows.float().mean().item(),
                          torch.nonzero(~rows.all(-1)).flatten().tolist(), rows.numel())
        self.steps.append(step)
        self.sets, self.forced = {}, []

    def agreement(self, pair: str) -> float:
        """The agreeing share of (layer, token) rows over prefill and every
        decode step together."""
        rows = [s[pair] for s in self.steps]
        return sum(share * n for share, _, n in rows) / sum(n for _, _, n in rows)

    def report(self, arch: str) -> None:
        """One line a pair: the agreeing share at prefill and at each decode
        step, and the layers where the sets differ at each step that has any."""
        for pair in self.steps[0]:
            shares = [s[pair][0] for s in self.steps]
            where = {("prefill" if i == 0 else f"step {i - 1}"): s[pair][1]
                     for i, s in enumerate(self.steps) if s[pair][1]}
            print(f"[serve {arch}] routing {pair} (each path's own choice, dispatch pinned to "
                  f"the {self.lead} path's): top-k sets agreeing at prefill "
                  f"{shares[0]:.6f}, decode steps min {min(shares[1:]):.4f} mean "
                  f"{statistics.mean(shares[1:]):.6f} "
                  f"{[round(x, 4) for x in shares[1:]]}, all rows {self.agreement(pair):.6f}; "
                  f"differing layers " + (f"{where}" if where else "none")
                  + (f" (gate {ROUTE_AGREE} over all rows)"
                     if pair == "kernel32-f32" else " (information)"), flush=True)


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


def all_kernels() -> dict:
    """Every kernel wrapper by name (each counts its launches)."""
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.dp_sweep import dp_sweep
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.flash_attention import flash_attention_bwd
    from repro_torch.kernels.rmsnorm import rmsnorm, rmsnorm_bwd
    from repro_torch.kernels.ssm_scan import ssd_scan, ssd_scan_bwd
    return {"rmsnorm": rmsnorm, "flash_attention": flash_attention,
            "decode_attention": decode_attention, "ssd_scan": ssd_scan, "dp_sweep": dp_sweep,
            "rmsnorm_bwd": rmsnorm_bwd, "flash_attention_bwd": flash_attention_bwd,
            "ssd_scan_bwd": ssd_scan_bwd}


def swarm_problem(model: str, n: int, requests: int, hotspots: int, comp: float):
    """benchmarks/common.py::snapshot_problem at mem 8 x 512 MB, area 300 m,
    seed SEED: RPG positions, the paper's radio, requests from hotspots."""
    from repro_torch import core as C
    mob = C.RPGMobility(C.RPGParams(n_uavs=n, area_m=300.0, homogeneous=True), seed=SEED)
    rng = np.random.default_rng(SEED)
    sources = rng.integers(0, min(hotspots, n), requests).astype(np.int64)
    return C.Problem(C.lenet_profile() if model == "lenet" else C.vgg16_profile(),
                     np.full(n, 8 * 512e6), np.full(n, comp),
                     C.rate_matrix(mob.positions(1, seed=SEED)[0], C.RadioParams()),
                     sources, compute_speed=np.full(n, 9.5e9))


def first_rows(prob) -> dict:
    """The rows of a batched solve's first launch (``_place_batch``): each
    distinct source in order of first arrival, its candidates and
    feasibility at the full capacities, k = the default sparse budget."""
    from repro_torch.core import ould
    spb = prob.transfer_cost()
    prof = prob.profile
    consts = ould._sparse_consts(spb, prof.output_vector(), prof.memory_vector(),
                                 prof.compute_vector())
    mem_left, comp_left = prob.mem_cap.astype(float), prob.comp_cap.astype(float)
    head = mem_left / mem_left.max() + comp_left / comp_left.max()
    srcs = np.array(list(dict.fromkeys(int(s) for s in prob.sources)), np.int64)
    cand, valid = ould._sparse_select_batch(spb, srcs, mem_left, comp_left, head, consts,
                                            ould.default_sparse_k(prob.n_nodes))
    comp = np.array(prof.compute_vector())
    cc = comp[:, None] / prob.compute_speed[None, :] * prob.horizon()
    return dict(spb=spb, Kv=consts[0], Ks=float(prof.input_bytes), srcs=srcs, cand=cand,
                valid=valid, cc=cc)


def sweep_args(torch, rows: dict, with_cc: bool, infeasible: float = 0.0) -> tuple:
    """The sweep's arguments on the card; ``infeasible`` of the candidates
    lose their feasibility bit (a seeded draw), so their penalty is +inf."""
    valid = rows["valid"] & (np.random.default_rng(SEED).random(rows["valid"].shape)
                             >= infeasible)

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).cuda()

    return (put(rows["spb"]), put(rows["Kv"]), rows["Ks"], put(rows["srcs"]),
            put(rows["cand"]), put(valid), put(rows["cc"]) if with_cc else None)


def sweep_bound_ms(rows: dict, with_cc: bool) -> tuple[float, float]:
    """(bytes ms, operations ms) of one sweep over these rows: each input
    read once (the distinct spb and compute-cost entries the rows gather,
    sources, candidates, feasibility bits, Kv) and the outputs written once
    (final costs, back-pointers); a multiply, two or three adds and a compare
    per (row, layer, a, b), two or three operations per first-layer entry."""
    spb, cand, srcs = rows["spb"], rows["cand"], rows["srcs"]
    N = spb.shape[0]
    S, M, k = cand.shape
    gathers = [srcs[:, None] * N + cand[:, 0, :]] + [
        cand[:, j - 1, :, None] * N + cand[:, j, None, :] for j in range(1, M)]
    n_spb = np.unique(np.concatenate([g.ravel() for g in gathers])).size
    n_cc = np.unique(np.arange(M)[None, :, None] * N + cand).size if with_cc else 0
    nbytes = (8 * (n_spb + n_cc + S + S * M * k + (M - 1)) + S * M * k
              + 8 * S * k + 8 * (M - 1) * S * k)
    ops = S * (M - 1) * k * k * (4 + with_cc) + S * k * (2 + with_cc)
    return nbytes / PEAK_BYTES * 1e3, ops / PEAK_F64 * 1e3


GRID_KEYS = ("blocks", "threads", "rows", "stagers", "lanes", "tile", "slots", "ahead", "resident",
             "smem")
SM_CLOCK_GHZ = 1.98  # H100 SXM's top SM clock (data sheet); the floor assumes it


def sweep_floor_us(M: int, k: int) -> float:
    """The critical-path floor of one sweep (FLOOR_CYCLES): no serial DP on
    this card finishes sooner, whatever its byte bound."""
    c = FLOOR_CYCLES
    layer = c["smem"] + -(-k // 32) * c["add_compare"] + 5 * c["merge"] + c["barrier"]
    return (2 * c["l2_round"] + (M - 1) * layer) / (SM_CLOCK_GHZ * 1e3)


def sweep_host_stages(torch, rows: dict, what: str) -> None:
    """Where the host time of one batched sweep call goes, at these rows:
    ``core/batch_dp.py::solve_batch``'s stages replayed (spb already on the
    card, as within a solve), each ended by a synchronise -- the host-to-
    device copies of the padded rows, the launch (the wrapper's host time),
    the wait for the kernel, the copy back and the host backtrack -- and
    the whole ``solve_batch`` call beside them; medians of 7.  The replay's
    paths must equal ``solve_batch``'s."""
    from repro_torch.core import batch_dp
    from repro_torch.kernels.dp_sweep import dp_sweep
    spb, Ks, Kv = rows["spb"], rows["Ks"], rows["Kv"]
    srcs, cand, valid = rows["srcs"], rows["cand"], rows["valid"]
    S, M, k = cand.shape
    Sp = batch_dp.bucket_rows(S)
    dev = torch.device("cuda")

    def put(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(dev)

    want, _ = batch_dp.solve_batch(spb, Ks, None, srcs, cand, valid, (Kv,), device="cuda")
    stages = {name: [] for name in ("copies in", "launch", "kernel wait", "copy back",
                                    "backtrack", "solve_batch")}
    for _ in range(7):
        torch.cuda.synchronize()
        t = [time.perf_counter()]
        pad = Sp - S
        args = (batch_dp._device_spb(spb, dev), put(Kv, np.float64), float(Ks),
                put(np.concatenate([srcs, np.zeros(pad, srcs.dtype)]), np.int64),
                put(np.concatenate([cand, np.zeros((pad, M, k), cand.dtype)]), np.int64),
                put(np.concatenate([valid, np.ones((pad, M, k), bool)]), bool), None)
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        f, b = dp_sweep(*args)
        t.append(time.perf_counter())
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        final, backs = f[:S].cpu().numpy(), b[:, :S].cpu().numpy()
        t.append(time.perf_counter())
        q = np.arange(S)
        idx = np.argmin(final, axis=1)
        finite = np.isfinite(final[q, idx])
        nodes = np.empty((S, M), np.int64)
        nodes[:, M - 1] = cand[q, M - 1, idx]
        for j in range(M - 1, 0, -1):
            idx = backs[j - 1, q, idx]
            nodes[:, j - 1] = cand[q, j - 1, idx]
        t.append(time.perf_counter())
        batch_dp.solve_batch(spb, Ks, None, srcs, cand, valid, (Kv,), device="cuda")
        t.append(time.perf_counter())
        for name, dt in zip(stages, np.diff(t)):
            stages[name].append(dt * 1e3)
    need(all((w is None) == (not ok) and (w is None or np.array_equal(w, n))
             for w, ok, n in zip(want, finite, nodes)),
         f"{what}: the replayed sweep call's paths differ from solve_batch's")
    print(f"[place] host stages of one sweep call at {what} ({S} rows padded to {Sp}, M {M}, "
          f"k {k}), ms, median of 7: "
          + ", ".join(f"{name} {statistics.median(v):.4f}" for name, v in stages.items()),
          flush=True)


def repeated_layers(planner, prob, what: str) -> dict:
    """How many of the sweep's layers past layer 0 repeat the layer before, over
    every launch of one batched solve: ``solve_batch``'s real rows (no
    bucket padding) as the kernel sees them, layer j's transitions repeating
    layer j-1's where cand_j = cand_{j-1} = cand_{j-2} (the kernel's mask,
    layers j <= 63 only), in which case the kernel, staging the whole sweep
    at once, gathers nothing for it."""
    from repro_torch import core as C
    from repro_torch.core import batch_dp
    seen = []
    real = batch_dp.solve_batch

    def spy(spb, Ks, compute_cost, srcs, cand, valid, consts, device="cuda"):
        seen.append(np.array(cand))
        return real(spb, Ks, compute_cost, srcs, cand, valid, consts, device=device)

    batch_dp.solve_batch = spy
    try:
        planner.plan(prob, C.SnapshotView(prob.rates))
    finally:
        batch_dp.solve_batch = real
    rows = layers = reps = whole = 0
    for cand in seen:
        S, M, _ = cand.shape
        same = np.all(cand[:, 1:] == cand[:, :-1], axis=2)  # (S, M-1): cand_j == cand_{j-1}
        rep = same[:, 1:] & same[:, :-1]                     # layer j = 2..M-1 repeats j-1
        rep[:, 62:] = False
        rows, layers = rows + S, layers + S * (M - 1)
        reps += int(rep.sum())
        whole += int(np.sum(rep.sum(axis=1) == M - 2))
    share = dict(launches=len(seen), rows=rows, layers=layers, repeated=reps,
                 repeated_share=reps / max(layers, 1), rows_all_repeated=whole,
                 rows_all_repeated_share=whole / max(rows, 1))
    print(f"[place] {what}: repeated layers over the solve's {len(seen)} sweep launches "
          f"({rows} rows, {layers} layers past layer 0 in all): {reps} repeat the layer "
          f"before ({share['repeated_share']:.4f}), so the kernel gathers {layers - reps} "
          f"layers of k^2 entries, not {layers}; rows whose every layer past "
          f"the first repeats (k^2 gathers, not (M-1) k^2): {whole}/{rows} "
          f"({share['rows_all_repeated_share']:.4f})", flush=True)
    return share


def sweep_record(torch, rows: dict, what: str) -> dict:
    """The sweep kernel against its plain version, bit for bit (torch.equal)
    on these rows as they are and with 30 % of the candidates infeasible,
    with and without compute cost; then times and bound of the rows as the
    planner sweeps them (no compute cost).  No single PyTorch call computes
    a min-plus sweep, so ``library_ms`` is None."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.dp_sweep import dp_sweep
    for with_cc in (False, True):
        for infeasible in (0.0, 0.3):
            args = sweep_args(torch, rows, with_cc, infeasible)
            got, want = dp_sweep(*args), ref.dp_sweep(*args)
            torch.cuda.synchronize()
            case = f"dp_sweep {what} cc {with_cc} infeasible {infeasible}"
            need(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
                 f"{case}: kernel differs from its plain version (max|d| final "
                 f"{(got[0] - want[0]).abs().nan_to_num().max().item():.3e}, backs differ at "
                 f"{int((got[1] != want[1]).sum())} entries)")
            print(f"[place] {case}: kernel == plain bit for bit (final {tuple(got[0].shape)}, "
                  f"backs {tuple(got[1].shape)}, {int(got[0].isinf().sum())} inf finals)",
                  flush=True)
    args = sweep_args(torch, rows, False)
    S, M, k = rows["cand"].shape
    dp_sweep.last_grid = None
    ms = time_ms([lambda: dp_sweep(*args)], reps=7, inner=50)
    grid = dp_sweep.last_grid
    need(grid is not None, f"dp_sweep {what}: no launch recorded")
    dev = device_us([lambda: dp_sweep(*args)], calls=50)
    # The same rows cut to their first 1 and 2 layers: layer 0 alone (the
    # launch, the candidates' staging, c0), then one gathered layer; the
    # rest of the full sweep's time, spread over its M - 2 later layers.
    depth_us = {}
    for depth in (1, 2):
        cut = tuple(a[:, :depth].contiguous() if torch.is_tensor(a) and a.dim() == 3 else a
                    for a in args)
        depth_us[depth] = sum(device_us([lambda: dp_sweep(*cut)], calls=50).values())
    depth_us[M] = sum(dev.values())
    per_layer_us = (depth_us[M] - depth_us[2]) / (M - 2)
    # The same rows with layer j's candidates rotated by j places, so that no
    # layer repeats the one before and the kernel gathers every layer: what
    # the repeated layers save, on rows without that property.
    turn = (torch.arange(k, device="cuda")[None, :]
            - torch.arange(M, device="cuda")[:, None]) % k
    spun = tuple(a.gather(2, turn.expand(S, M, k)).contiguous()
                 if torch.is_tensor(a) and a.dim() == 3 else a for a in args)
    got, want = dp_sweep(*spun), ref.dp_sweep(*spun)
    need(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
         f"dp_sweep {what}, candidates rotated by layer: kernel differs from its plain version")
    norepeat_us = sum(device_us([lambda: dp_sweep(*spun)], calls=50).values())
    bytes_ms, ops_ms = sweep_bound_ms(rows, False)
    plan = dict(zip(GRID_KEYS, grid))
    floor_us = sweep_floor_us(M, k)
    print(f"[place] dp_sweep at {what}: plan as launched {plan}; "
          f"device us a call {sum(dev.values()):.2f} ({dev}); bound the larger of bytes / "
          f"{PEAK_BYTES / 1e12:.2f} TB/s = {bytes_ms * 1e3:.3f} us and f64 operations / "
          f"{PEAK_F64 / 1e12:.0f} TFLOP/s (H100 SXM, outside the tensor cores) = "
          f"{ops_ms * 1e3:.3f} us; critical-path floor (estimate, {FLOOR_CYCLES} cycles at "
          f"{SM_CLOCK_GHZ} GHz) {floor_us:.2f} us", flush=True)
    print(f"[place] dp_sweep at {what} by depth: device us M 1 {depth_us[1]:.2f}, M 2 "
          f"{depth_us[2]:.2f}, M {M} {depth_us[M]:.2f}; each layer past the second "
          f"{per_layer_us:.3f}; the same rows with no layer repeating the one before "
          f"(candidates rotated by layer, == plain bit for bit) {norepeat_us:.2f}",
          flush=True)
    sweep_host_stages(torch, rows, what)
    return finish(dict(
        name="dp_sweep", max_abs_err=0.0, grid=list(grid), device_us=dev, depth_us=depth_us,
        norepeat_us=norepeat_us,
        shape=f"{S} rows x {M} layers x k {k}, spb {rows['spb'].shape} f64, "
              f"no compute cost [{what}]",
        ms=ms, plain_ms=time_ms([lambda: ref.dp_sweep(*args)], reps=5, inner=5),
        library_ms=None, bytes_ms=bytes_ms, ops_ms=ops_ms))


def placed_setup(torch, model: str) -> dict:
    """A pool that forces every request across two nodes or more, the
    ould-dp plan, its stage graph and the engine on the card with weights
    from a generator seeded SEED."""
    from repro_torch import core as C
    from repro_torch import exec as X
    from repro_torch.models import cnn
    cfg = PLACED[model]
    n = cfg["nodes"]
    prof = C.lenet_profile() if model == "lenet" else C.vgg16_profile()
    mob = C.RPGMobility(C.RPGParams(n_uavs=n, area_m=100.0, homogeneous=True), seed=SEED)
    rates = C.rate_matrix(mob.positions(1, seed=SEED)[0], C.RadioParams())
    prob = C.Problem(prof, np.full(n, cfg["mem"]), np.full(n, 1e13), rates,
                     np.arange(FRAMES) % 2, compute_speed=np.full(n, 9.5e9))
    plan = C.get_planner("ould-dp").plan(prob, C.SnapshotView(rates))
    graph = X.compile_plan(plan)
    spans = [len(set(a)) for a in plan.assign]
    print(f"[place] {model}: {n} nodes of {cfg['mem'] / 1e6:.0f} MB (model "
          f"{sum(prof.memory_vector()) / 1e6:.1f} MB), sources {prob.sources.tolist()}; "
          f"ould-dp admitted {plan.n_admitted}/{FRAMES}, nodes a request {spans}, tasks "
          f"{len(graph.tasks)}, shared stages {graph.n_shared}, transfers "
          f"{len(graph.transfers)}", flush=True)
    need(plan.n_admitted == FRAMES and min(spans) >= 2,
         f"{model}: the pool did not force every request across two nodes: {spans}")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    params = (cnn.lenet_init if model == "lenet" else cnn.vgg16_init)(gen, device="cuda")
    layers = cnn.lenet_layers if model == "lenet" else cnn.vgg16_layers
    frames = np.random.default_rng(SEED).standard_normal((FRAMES, *FRAME_HW)).astype(np.float32)
    return dict(prob=prob, plan=plan, graph=graph, params=params, layers=layers,
                frames=frames, engine=X.ExecutionEngine(layers(params), device="cuda"))


def rel_err(got, want) -> float:
    return float(np.abs(got - want).max() / np.abs(want).max())


def placed_checks(torch, model: str, run: dict) -> None:
    """Placed outputs against the sequential run on the card, one frame on
    the card against the CPU, the walls, and the calibrated re-solve."""
    from repro_torch import core as C
    from repro_torch import exec as X
    from repro_torch.models import cnn
    report, engine, frames = run["report"], run["engine"], run["frames"]
    seq = engine.sequential_reference(frames, run["graph"].requests)
    errs = [rel_err(report.outputs[r], seq[r]) for r in run["graph"].requests]
    shape = report.outputs[0].shape
    print(f"[place] {model} placed vs sequential on the card: outputs {shape}, max|d| / "
          f"max|ref| by request {[f'{e:.2e}' for e in errs]} (gate {EXEC_REL})", flush=True)
    need(all(np.isfinite(report.outputs[r]).all() for r in report.outputs)
         and max(errs) <= EXEC_REL, f"{model}: placed outputs off the sequential run")
    cpu_params = _tree_map(run["params"], lambda t: t.cpu())
    with torch.inference_mode():
        cpu = cnn.apply_layers(run["layers"](cpu_params), torch.from_numpy(frames[:1]))[0].numpy()
    err = rel_err(seq[0], cpu)
    print(f"[place] {model} one frame, card vs CPU, same weights, TF32 off: max|d| / "
          f"max|CPU| {err:.2e} (gate {EXEC_REL})", flush=True)
    need(err <= EXEC_REL, f"{model}: card output off the CPU's")
    walls = ", ".join(f"node {t.node} units [{t.layer_start},{t.layer_end}) x{t.batch} "
                      f"{t.wall_s * 1e3:.3f} ms" for t in report.stage_timings)
    print(f"[place] {model} stage walls: {walls}", flush=True)
    print(f"[place] {model} executed_s (measured stage walls + modeled links) "
          f"{[f'{x:.6f}' for x in report.executed_s]}; compute_s "
          f"{[f'{x:.6f}' for x in report.compute_s]}; transfers' host walls "
          f"{[f'{t.serialize_s * 1e3:.3f} ms' for t in report.transfers]}", flush=True)
    cal, recon = X.calibrated_problem(run["prob"], report)
    replan = C.get_planner("ould-dp").plan(cal, C.SnapshotView(cal.rates))
    rereport = engine.run(X.compile_plan(replan), frames,
                          predicted_s=replan.evaluate().per_request_s)
    mae0 = report.abs_error_s[list(report.outputs)].mean()
    mae1 = rereport.abs_error_s[list(rereport.outputs)].mean()
    print(f"[place] {model} {recon.summary()}; predicted-vs-measured MAE "
          f"{mae0 * 1e3:.3f} ms -> {mae1 * 1e3:.3f} ms after the calibrated re-solve "
          f"(admitted {replan.n_admitted}/{FRAMES})", flush=True)
    need(np.isfinite(mae0) and np.isfinite(mae1), f"{model}: MAE not finite")


def placement_phase(torch) -> tuple[dict, list]:
    """The placement path with every launch count at 0, then its gates.
    Returns the path's launches by kernel and dp_sweep's records."""
    from repro_torch import core as C
    probs = {name: swarm_problem(*spec) for name, spec in SWARMS.items()}
    runs = {model: placed_setup(torch, model) for model in PLACED}
    batched = {name: C.get_planner("ould-dp-sparse", batch_solve=True, device="cuda")
               for name in SWARMS}
    kernels = all_kernels()
    dp_sweep = kernels["dp_sweep"]
    for fn in kernels.values():
        fn.n_launches = 0
    torch.cuda.synchronize()
    first, per_solve = {}, {}
    for name, prob in probs.items():  # the placement path: batched solves ...
        n0 = dp_sweep.n_launches
        t0 = time.perf_counter()
        first[name] = batched[name].plan(prob, C.SnapshotView(prob.rates))
        per_solve[name] = (dp_sweep.n_launches - n0, time.perf_counter() - t0)
    for model, run in runs.items():   # ... and placed inference
        run["report"] = run["engine"].run(
            run["graph"], run["frames"], predicted_s=run["plan"].evaluate().per_request_s)
    torch.cuda.synchronize()
    launches = {name: fn.n_launches for name, fn in kernels.items()}
    print(f"[place] launches on the placement path: {launches}", flush=True)
    need(launches["dp_sweep"] > 0 and all(v == 0 for k, v in launches.items() if k != "dp_sweep"),
         f"placement path launches {launches}")

    for name, prob in probs.items():
        seq = C.get_planner("ould-dp-sparse")
        view = C.SnapshotView(prob.rates)
        ps = seq.plan(prob, view)                        # first call off the clock
        seq_s, bat_s, n_sweeps = [], [], []
        for _ in range(3):
            t0 = time.perf_counter()
            ps = seq.plan(prob, view)
            seq_s.append(time.perf_counter() - t0)
            n0 = dp_sweep.n_launches
            t0 = time.perf_counter()
            pb = batched[name].plan(prob, view)
            bat_s.append(time.perf_counter() - t0)
            n_sweeps.append(dp_sweep.n_launches - n0)
            for got in (pb, first[name]):
                need(np.array_equal(got.admitted, ps.admitted)
                     and np.array_equal(got.assign, ps.assign) and got.objective == ps.objective,
                     f"{name}: batched plan differs from the sequential one")
        st = pb.solve_stats
        print(f"[place] {name}: batched == sequential (admitted {ps.n_admitted}/"
              f"{prob.n_requests}, objective {ps.objective!r}); wall min of 3: sequential "
              f"{min(seq_s) * 1e3:.2f} ms, batched {min(bat_s) * 1e3:.2f} ms (first batched "
              f"solve {per_solve[name][1] * 1e3:.2f} ms, {per_solve[name][0]} sweeps); "
              f"n_batched {st.n_batched}/{prob.n_requests}, sweep launches a solve "
              f"{n_sweeps}, k {st.k}", flush=True)
        repeated_layers(batched[name], prob, name)

    recs = [sweep_record(torch, first_rows(prob), name) for name, prob in probs.items()]
    for model, run in runs.items():
        placed_checks(torch, model, run)
    return launches, recs


# The swarm serving runtime (runtime/swarm.py): benchmarks/bench_swarm.py's
# CHURN (S1: 10 UAVs in two RPG groups, churn mtbf 60 s / mttr 20 s,
# bottleneck queues) and OVERLOAD (S6: one group, 4.5 arrivals/s held 240
# ticks, cut from 360 ticks to 180: 10 epochs, the streams still past what
# the group serves), the S7 swarm's N (1024 UAVs,
# 64 hotspots, default budget k 32, per-hop queues) cut to 30 ticks (2
# epochs, the second re-solving 344 active streams), and tests/test_swarm.py's
# SMALL with faster churn for executed mode, cut to 40 ticks (3 epochs, 113
# frames served at seed 3, three churn rejoins warming the engine): the
# script's depth, which its time limit bounds.
SWARM_CHURN = dict(arrival_rate_hz=0.3, mtbf_s=60.0, mttr_s=20.0, queue_model="bottleneck")
SWARM_OVERLOAD = dict(n_groups=1, duration_ticks=180, epoch_ticks=18, arrival_rate_hz=4.5,
                      hold_ticks_mean=240.0, mem_mb_hotspot_group=4096.0,
                      mem_mb_other_groups=4096.0, comp_cap_flops=1e18, gflops=5e9,
                      deadline_s=2.0, mtbf_s=float("inf"), queue_model="bottleneck")
SWARM_N1024 = dict(n_uavs=1024, hotspots=64, duration_ticks=30, epoch_ticks=15,
                   arrival_rate_hz=34.0, hold_ticks_mean=30.0)
SWARM_EXEC = dict(duration_ticks=40, arrival_rate_hz=0.3, mtbf_s=40.0, mttr_s=10.0)
# SimResult fields that are host walls, and the counter of sweep launches at
# a shape new to the process, which a sequential run cannot have.
SWARM_WALL_METRICS = ("solver.total_solve_s", "solver.jit_compiles")


def same_sim(a, b, what: str) -> None:
    """Two SimResults identical field by field: epoch logs with their solve
    walls set aside, metrics without SWARM_WALL_METRICS."""
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if f.name == "epochs":
            x = [dataclasses.replace(e, solve_time_s=0.0) for e in x]
            y = [dataclasses.replace(e, solve_time_s=0.0) for e in y]
        elif f.name == "metrics":
            x = {k: v for k, v in x.items() if k not in SWARM_WALL_METRICS}
            y = {k: v for k, v in y.items() if k not in SWARM_WALL_METRICS}
        same = (np.array_equal(x, y) and x.dtype == y.dtype if isinstance(x, np.ndarray)
                else x == y)
        need(same, f"{what}: field {f.name} differs between the batched and sequential runs")


def timed_sim(scn, policy: str, seed: int = SEED, **kw):
    from repro_torch.runtime.swarm import simulate
    t0 = time.perf_counter()
    r = simulate(scn, policy, seed, **kw)
    return r, time.perf_counter() - t0


def sweep_launch_us(torch, fn) -> list:
    """Device microseconds of each dp_sweep kernel launch while ``fn`` runs
    (``torch.profiler``'s device events); taken again, at most twice more,
    when the profile holds no device rows."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for attempt in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            out = fn()
            torch.cuda.synchronize()
        us = [e.self_device_time_total for e in prof.events()
              if e.device_type == DeviceType.CUDA and "dp_sweep_kernel" in e.name]
        if us:
            return out, us
        print(f"[profiler] no dp_sweep launch recorded (attempt {attempt + 1} of 3)", flush=True)
    raise SmokeError("torch.profiler recorded no dp_sweep launch in the swarm run")


def solve_batch_walls(run) -> tuple:
    """``run()``'s result, the host wall of each ``batch_dp.solve_batch``
    call it made (copies in, the sweep, copy back, backtrack; synchronised
    by the copy back), by a spy around the function the solvers call, and
    each call's sweep as (bound us, rows, M, k, its rows for ``sweep_args``),
    sorted by bound: the larger of ``sweep_bound_ms``'s bytes and operations
    times over the rows the call was given (its padding rows are no work the
    solve needs)."""
    from repro_torch.core import batch_dp
    real, walls, sweeps = batch_dp.solve_batch, [], []

    def spy(spb, Ks, cc, srcs, cand, valid, consts, *args, **kw):
        t0 = time.perf_counter()
        out = real(spb, Ks, cc, srcs, cand, valid, consts, *args, **kw)
        walls.append(time.perf_counter() - t0)
        sweeps.append(dict(spb=spb, Kv=consts[0], Ks=float(Ks), srcs=srcs.copy(),
                           cand=cand.copy(), valid=np.array(valid, bool), cc=cc))
        return out

    batch_dp.solve_batch = spy
    try:
        result = run()
    finally:
        batch_dp.solve_batch = real
    # bounds after the run: the re-solve walls it measures must not hold them
    return result, walls, sorted(
        ((max(sweep_bound_ms(rows, rows["cc"] is not None)) * 1e3, *rows["cand"].shape, rows)
         for rows in sweeps), key=lambda x: x[0])


def swarm_phase(torch) -> dict:
    """The swarm serving runtime with every launch count at 0: CHURN over
    every policy, OVERLOAD and N 1024 under incremental-sparse, each with its
    epoch re-solves batched on the card (batch_solve=True), and executed mode
    measuring LeNet's stages on the card; the counts are read just after.
    Then the gates: each batched run equals its sequential run
    (batch_solve=False) field by field, walls excepted; S1 and S3 on CHURN;
    executed mode serves as its analytic twin and warms on a churn rejoin;
    the median-bound batched call's rows of OVERLOAD and N 1024 are swept
    again, kernel against plain, and timed."""
    from repro_torch.kernels import ref
    from repro_torch.obs import Tracer
    from repro_torch.runtime.swarm import PLANNER_POLICIES, SwarmScenario
    kernels = all_kernels()
    dp_sweep = kernels["dp_sweep"]

    def scn(base, **kw):
        return SwarmScenario(**base, **kw)

    card = dict(batch_solve=True, device="cuda")
    for fn in kernels.values():
        fn.n_launches = 0
    torch.cuda.synchronize()
    bat, walls, sweeps_by_run = {}, {}, {}
    for policy in PLANNER_POLICIES:               # the main path: CHURN ...
        n0 = dp_sweep.n_launches
        bat[f"churn {policy}"], walls[f"churn {policy}"] = timed_sim(scn(SWARM_CHURN, **card),
                                                                     policy)
        sweeps_by_run[f"churn {policy}"] = dp_sweep.n_launches - n0
    for name, base in (("overload", SWARM_OVERLOAD), ("n1024", SWARM_N1024)):  # ... the large
        n0 = dp_sweep.n_launches
        bat[name], walls[name] = timed_sim(scn(base, **card), "incremental-sparse")
        sweeps_by_run[name] = dp_sweep.n_launches - n0
    tracer = Tracer()                             # ... and executed mode
    executed, walls["executed"] = timed_sim(scn(SWARM_EXEC, execute=True, device="cuda"),
                                            "incremental", 3, tracer=tracer)
    torch.cuda.synchronize()
    launches = {name: fn.n_launches for name, fn in kernels.items()}
    print(f"[swarm] launches on the swarm path: {launches}; sweeps by run {sweeps_by_run}",
          flush=True)
    need(launches["dp_sweep"] > 0 and all(v == 0 for k, v in launches.items() if k != "dp_sweep"),
         f"swarm path launches {launches}")

    # CHURN: the policy table, S1 and S3, batched == sequential
    for policy in PLANNER_POLICIES:
        r = bat[f"churn {policy}"]
        print(f"[swarm] churn {policy}: miss {r.deadline_miss_rate:.4f} (late "
              f"{r.over_deadline_miss_rate:.4f}, outage {r.outage_rate:.4f}), rejection "
              f"{r.rejection_rate:.4f}, p99 {r.p99_latency_s:.4f} s, served {r.served}, "
              f"resolve wall {r.total_resolve_s * 1e3:.3f} ms over {len(r.epochs)} epochs, "
              f"sim wall {walls[f'churn {policy}']:.3f} s, sweeps "
              f"{sweeps_by_run[f'churn {policy}']}",
              flush=True)
        need(all(e.feasible for e in r.epochs), f"S3: churn {policy} broke a capacity")
    mp, inc = bat["churn ould-mp"], bat["churn incremental"]
    print(f"[swarm] S1: ould-mp miss {mp.deadline_miss_rate:.4f} < incremental "
          f"{inc.deadline_miss_rate:.4f}", flush=True)
    need(mp.deadline_miss_rate < inc.deadline_miss_rate, "S1: ould-mp does not out-serve "
         "snapshot incremental under churn")
    need(sweeps_by_run["churn incremental-sparse"] > 0, "churn: no sweep launched")
    seq, _ = timed_sim(scn(SWARM_CHURN), "incremental-sparse")
    same_sim(bat["churn incremental-sparse"], seq, "churn incremental-sparse")
    print(f"[swarm] churn incremental-sparse: batched on the card == sequential (served "
          f"{seq.served}, missed {seq.missed}, {len(seq.epochs)} epochs); resolve wall batched "
          f"{bat['churn incremental-sparse'].total_resolve_s * 1e3:.3f} ms, sequential "
          f"{seq.total_resolve_s * 1e3:.3f} ms", flush=True)

    # OVERLOAD and N 1024: batched == sequential, walls and device times
    for name, base in (("overload", SWARM_OVERLOAD), ("n1024", SWARM_N1024)):
        b = bat[name]
        need(sweeps_by_run[name] > 0, f"{name}: no sweep launched")
        seq, seq_s = timed_sim(scn(base), "incremental-sparse")
        same_sim(b, seq, name)
        (again, _), us = sweep_launch_us(
            torch, lambda: timed_sim(scn(base, **card), "incremental-sparse"))
        same_sim(again, seq, f"{name} (profiled run)")
        spied, calls, shapes = solve_batch_walls(
            lambda: timed_sim(scn(base, **card), "incremental-sparse")[0])
        same_sim(spied, seq, f"{name} (run with solve_batch timed)")
        mid = shapes[len(shapes) // 2]
        # the median-bound call's rows again, kernel against plain (off the path's counts)
        args = sweep_args(torch, mid[4], mid[4]["cc"] is not None)
        got, want = dp_sweep(*args), ref.dp_sweep(*args)
        need(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
             f"{name}: the median call's sweep differs from its plain version")
        mid_ms = time_ms([lambda: dp_sweep(*args)], reps=7, inner=50)
        mid_plain = time_ms([lambda: ref.dp_sweep(*args)], reps=5, inner=5)
        st = [e for e in b.epochs if e.n_active]
        print(f"[swarm] {name}: batched on the card == sequential; sim wall batched "
              f"{walls[name]:.3f} s, sequential {seq_s:.3f} s; total_resolve_s batched "
              f"{b.total_resolve_s:.6f}, sequential {seq.total_resolve_s:.6f}; sweeps "
              f"{sweeps_by_run[name]} (profiled run {len(us)}), device us a sweep median "
              f"{statistics.median(us):.2f} (min {min(us):.2f}, max {max(us):.2f}); served "
              f"{b.served}, missed {b.missed}, p99 {b.p99_latency_s:.4f} s; epochs with "
              f"streams {len(st)}, active {[e.n_active for e in st]}, admitted "
              f"{[e.n_admitted for e in st]}", flush=True)
        print(f"[swarm] {name}: a third batched run with each solve_batch call timed: "
              f"{len(calls)} calls, {sum(calls):.6f} s in them (median "
              f"{statistics.median(calls) * 1e3:.4f} ms a call) of total_resolve_s "
              f"{spied.total_resolve_s:.6f}; the rest of the re-solves (candidate "
              f"selection, commits, the ladder) {spied.total_resolve_s - sum(calls):.6f} s",
              flush=True)
        print(f"[swarm] {name}: sweep bound a call (bytes / {PEAK_BYTES / 1e12:.2f} TB/s or "
              f"f64 operations / {PEAK_F64 / 1e12:.0f} TFLOP/s, the larger, over the rows "
              f"each call was given): median {mid[0]:.4g} us at {mid[1]} rows x M {mid[2]} x "
              f"k {mid[3]}, min {shapes[0][0]:.4g} us ({shapes[0][1]} rows), max "
              f"{shapes[-1][0]:.4g} us ({shapes[-1][1]} rows); that call's rows again: "
              f"kernel == plain bit for bit, kernel {mid_ms:.4f} ms, plain {mid_plain:.4f} ms "
              f"(eager, CUDA events)", flush=True)

    # executed mode: the stages measured on the card, the analytic twin
    twin, _ = timed_sim(scn(SWARM_EXEC), "incremental", 3)
    sm = tracer.select("stage_measure")
    ranges = [f"[{int(a)},{int(e)}) {d * 1e3:.3f} ms" for a, e, d in zip(sm["a0"], sm["a1"],
                                                                       sm["dur"])]
    print(f"[swarm] executed (LeNet stages measured on the card): served {executed.served} "
          f"(analytic twin {twin.served}), warm starts {executed.warm_starts}, p99 "
          f"{executed.p99_latency_s:.4f} s, sim wall {walls['executed']:.3f} s; "
          f"{len(ranges)} stage ranges measured: {', '.join(ranges)}", flush=True)
    need(executed.served == twin.served and executed.served > 0,
         "executed mode: served differs from its analytic twin")
    need(executed.warm_starts >= 1, "executed mode: no churn rejoin warmed the engine")
    need(len(ranges) > 0 and bool(np.isfinite(executed.latencies).all()),
         "executed mode: no stage measured or a latency not finite")
    return launches


# The transport phase: SWARM_EXEC (seed 3, whose churn rejoins warm the
# engine) under incremental-sparse with its re-solves batched on the card
# and executed mode, over each byte-moving transport.  Executed mode serves
# on stage walls measured on the card, so there the latencies and what is
# computed from them (over-deadline misses, queue waits, node demand) are
# walls too.
TRANSPORT_RUNS = ("loopback", "multiproc")
EXEC_WALL_FIELDS = ("latencies", "missed", "wait_total_s", "queue_demand_s")
EXEC_WALL_METRICS = ("sim.latency_s", "sim.missed", "sim.wait_total_s", "queue.max_demand_s")
# Ship walls by payload (bytes, f32 tensors on the card), each the median
# of SHIP_REPS ships; LeNet's boundary activations at 326x595 run from 480 B
# (fc1) to 4.57 MB (conv1's output).
SHIP_BYTES = (4 << 10, 64 << 10, 1 << 20, 4 << 20, 16 << 20, 64 << 20)
SHIP_REPS = 5
WARM_RANGES = ((0, 3), (3, 7))


def same_executed(a, b, what: str, links: bool = True) -> None:
    """Two executed-mode SimResults equal field by field but for walls, the
    transport's name and bandwidth values: the same completions, decisions
    and counters, and, where ``links`` (both runs moved bytes), the same
    sampled links."""
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if f.name in EXEC_WALL_FIELDS + ("transport",):
            if f.name == "latencies":
                need(x.size == y.size and bool(np.isfinite(x).all()),
                     f"{what}: {x.size} completions against {y.size}")
            continue
        if f.name == "link_bytes_per_s":
            need(not links or x.keys() == y.keys(), f"{what}: links {sorted(x)} against "
                 f"{sorted(y)}")
            continue
        if f.name == "epochs":
            x = [dataclasses.replace(e, solve_time_s=0.0) for e in x]
            y = [dataclasses.replace(e, solve_time_s=0.0) for e in y]
        elif f.name == "metrics":
            need(x["sim.latency_s"]["count"] == y["sim.latency_s"]["count"],
                 f"{what}: latency histogram counts differ")

            def keep(m):
                return {k: v for k, v in m.items()
                        if k not in SWARM_WALL_METRICS + EXEC_WALL_METRICS
                        and not k.startswith("transport.link.")}
            x, y = keep(x), keep(y)
        same = (np.array_equal(x, y) and x.dtype == y.dtype if isinstance(x, np.ndarray)
                else x == y)
        need(same, f"{what}: field {f.name} differs")


def ship_table(torch, tp, startup: float, what: str) -> None:
    """On ``tp``, started in ``startup`` s (the workers' startup): ship 4 KB
    once to each worker, then f32 tensors on the card of each SHIP_BYTES
    size; print the median wall and rate by size and the workers' recv/echo
    shares of all the transport's ship walls."""
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    rows = []
    for w in range(tp.n_workers):          # each connection's first ship, off the table
        tp.ship(0, w, torch.zeros(1024, device="cuda"))
    for nb in SHIP_BYTES:
        x = torch.randn(nb // 4, generator=gen, device="cuda")
        walls = []
        for i in range(SHIP_REPS):
            res = tp.ship(0, 1 + i % tp.n_workers, x)
            need(res.array.device == x.device and torch.equal(res.array, x),
                 f"{what}: a {nb} B ship came back different")
            walls.append(res.wall_s)
        med = statistics.median(walls)
        rows.append(f"{nb} B {med * 1e3:.3f} ms ({nb / med / 1e6:.0f} MB/s)")
    ws = tp.worker_stats.values()
    wall = sum(ls.wall_s for ls in tp.link_stats.values())
    recv, echo = sum(w.recv_s for w in ws), sum(w.echo_s for w in ws)
    backends = f", backends {tp.worker_backends} {tp.worker_devices}" if tp.device else ""
    print(f"[transport] {what}: {tp.n_workers} workers (pids {tp.worker_pids}, parent "
          f"{os.getpid()}{backends}) started in {startup:.3f} s; ship wall median of "
          f"{SHIP_REPS} by payload (card -> host -> worker -> host -> card): {', '.join(rows)}; "
          f"worker recv {recv / wall:.3f} and echo {echo / wall:.3f} of {wall:.3f} s of ship "
          f"walls", flush=True)


def warm_child() -> int:
    """``chip_smoke.py --warm-child``: a fresh process on the card, its build
    directory already populated by the parent.  Times the CUDA context,
    measure_warm_start over LeNet's WARM_RANGES, and the first dp_sweep
    launch (a library load, no nvcc) beside a second one; prints one JSON
    line."""
    import torch
    from repro_torch.exec import measure_warm_start
    from repro_torch.kernels import build, ref
    from repro_torch.kernels.dp_sweep import dp_sweep
    from repro_torch.models import cnn
    t0 = time.perf_counter()
    torch.zeros(1, device="cuda")
    torch.cuda.synchronize()
    context_s = time.perf_counter() - t0
    missing = [s.name for s in build.CSRC.glob("*.cu") if not build._lib_path(s).exists()]
    need(not missing, f"warm child: {missing} not built in {build.BUILD_DIR}")
    params = cnn.lenet_init(torch.Generator(device="cuda").manual_seed(SEED), device="cuda")
    frame = np.random.default_rng(SEED).standard_normal(FRAME_HW).astype(np.float32)
    rep = measure_warm_start(cnn.lenet_layers(params), WARM_RANGES, frame,
                             cache_dir=build.BUILD_DIR)
    args = sweep_args(torch, first_rows(swarm_problem(*SWARMS["lenet N1024 (S7)"])), False)
    walls = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = dp_sweep(*args)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    want = ref.dp_sweep(*args)
    need(torch.equal(out[0], want[0]) and torch.equal(out[1], want[1]),
         "warm child: dp_sweep differs from its plain version")
    print(json.dumps({"context_s": context_s, "cold_s": rep.cold_s, "warm_s": rep.warm_s,
                      "first_sweep_s": walls[0], "second_sweep_s": walls[1]}), flush=True)
    return 0


def transport_phase(torch, build_s: float) -> dict:
    """Executed mode over the byte-moving transports with every launch count
    at 0: SWARM_EXEC under incremental-sparse, re-solves batched on the card,
    over loopback and multiproc; the counts are read just after.  Then the
    gates: each run equal to its inproc twin and to its sequential twin
    (walls, transport and bandwidths excepted), links sampled, worker pids
    apart from ours, multiproc workers on the card; placed LeNet through both
    transports bitwise equal to inproc; the transport CLI's f32 / bf16 /
    int32 round trips through multiproc workers on the card.  Then the
    figures: bandwidth per link, ship walls by payload, worker shares and
    startup, and the warm-start child."""
    from repro_torch import exec as X
    from repro_torch import transport as TT
    from repro_torch.runtime.swarm import SwarmScenario
    kernels = all_kernels()
    dp_sweep = kernels["dp_sweep"]
    made: list = []                          # (transport name, object) the swarm built
    real = TT.make_transport

    def spy(name, **kw):
        tp = real(name, **kw)
        made.append((name, tp))
        return tp

    def scn(name, batched=True):
        return SwarmScenario(**SWARM_EXEC, execute=True, batch_solve=batched, device="cuda",
                             transport=name)

    TT.make_transport = spy
    try:
        for fn in kernels.values():
            fn.n_launches = 0
        torch.cuda.synchronize()
        runs, walls, sweeps_by_run = {}, {}, {}
        for name in TRANSPORT_RUNS:                 # the main path
            n0 = dp_sweep.n_launches
            runs[name], walls[name] = timed_sim(scn(name), "incremental-sparse", 3)
            sweeps_by_run[name] = dp_sweep.n_launches - n0
        torch.cuda.synchronize()
        launches = {name: fn.n_launches for name, fn in kernels.items()}
        swarm_tps = dict(made)
        print(f"[transport] launches on the transport path: {launches}; sweeps by run "
              f"{sweeps_by_run}", flush=True)
        need(launches["dp_sweep"] > 0 and all(sweeps_by_run.values())
             and all(v == 0 for k, v in launches.items() if k != "dp_sweep"),
             f"transport path launches {launches}, sweeps by run {sweeps_by_run}")
        twin, twin_s = timed_sim(scn("inproc"), "incremental-sparse", 3)
        for name in TRANSPORT_RUNS:
            r, tp = runs[name], swarm_tps[name]
            seq, seq_s = timed_sim(scn(name, batched=False), "incremental-sparse", 3)
            same_executed(r, twin, f"{name} against its inproc twin", links=False)
            same_executed(r, seq, f"{name} against its sequential twin")
            need(r.transport == name and r.link_bytes_per_s
                 and all(bw > 0 for bw in r.link_bytes_per_s.values()),
                 f"{name}: transport {r.transport}, links {r.link_bytes_per_s}")
            need(len(set(tp.worker_pids)) == tp.n_workers and os.getpid() not in tp.worker_pids,
                 f"{name}: worker pids {tp.worker_pids}, parent {os.getpid()}")
            if name == "multiproc":
                need(tp.worker_backends == ["cuda"] * tp.n_workers and tp.worker_devices
                     == [torch.cuda.get_device_name(0)] * tp.n_workers,
                     f"multiproc workers reached {tp.worker_backends} {tp.worker_devices}")
            ws = tp.worker_stats.values()
            print(f"[transport] swarm {name}: == inproc twin and == sequential twin (served "
                  f"{r.served}, {r.latencies.size} completions, {len(r.epochs)} epochs, warm "
                  f"starts {r.warm_starts}); sim wall {walls[name]:.3f} s (inproc twin "
                  f"{twin_s:.3f}, sequential {seq_s:.3f}); {tp.n_workers} workers, pids "
                  f"{tp.worker_pids} (parent {os.getpid()}), backends {tp.worker_backends} "
                  f"{tp.worker_devices}; realized MB/s by link "
                  f"{ {k: round(v / 1e6, 1) for k, v in r.link_bytes_per_s.items()} }; "
                  f"{sum(w.n for w in ws)} ships, worker recv {sum(w.recv_s for w in ws):.6f} "
                  f"s, echo {sum(w.echo_s for w in ws):.6f} s", flush=True)
    finally:
        TT.make_transport = real

    # placed LeNet through both transports, bitwise equal to inproc; then,
    # on the same workers, ship walls by payload, worker shares and startup
    run = placed_setup(torch, "lenet")
    ref = run["engine"].run(run["graph"], run["frames"])
    for name in TRANSPORT_RUNS:
        tp = real(name, n_workers=2, device="cuda")
        t0 = time.perf_counter()
        tp.start()
        startup = time.perf_counter() - t0
        try:
            eng = X.ExecutionEngine(run["layers"](run["params"]), transport=tp, device="cuda")
            rep = eng.run(run["graph"], run["frames"])
            bw = {k: round(v.bytes_per_s / 1e6, 1) for k, v in sorted(tp.link_stats.items())}
            ship_table(torch, tp, startup, "loopback (plain workers)" if name == "loopback"
                       else "multiproc (torch workers on the card)")
        finally:
            tp.close()
        need(sorted(rep.outputs) == sorted(ref.outputs)
             and all(np.array_equal(rep.outputs[r], ref.outputs[r]) for r in ref.outputs),
             f"placed lenet over {name}: outputs differ from inproc")
        print(f"[transport] placed lenet over {name}: {len(rep.transfers)} transfers, outputs "
              f"bitwise equal to inproc on {FRAMES} frames {FRAME_HW}; hop walls "
              f"{[f'{t.serialize_s * 1e3:.3f} ms' for t in rep.transfers]} (inproc "
              f"{[f'{t.serialize_s * 1e3:.3f} ms' for t in ref.transfers]}); MB/s by link "
              f"{bw}", flush=True)

    # the CLI's round trips through multiproc workers on the card
    cmd = [sys.executable, "-m", "repro_torch.transport", "--multiproc", "--device", "cuda",
           "--workers", "2", "--mb", "4", "--ships", "3"]
    r = subprocess.run(cmd, cwd=ROOT, env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
                       capture_output=True, text=True, timeout=300)
    print("\n".join(f"[transport] cli: {s}" for s in r.stdout.splitlines()), flush=True)
    need(r.returncode == 0 and "byte-exact" in r.stdout
         and "(float32, bfloat16, int32)" in r.stdout
         and "worker backends: ['cuda', 'cuda']" in r.stdout,
         f"transport CLI failed (rc {r.returncode}): {r.stderr[-2000:]}")


    # the warm-start layer in a fresh process
    r = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py"), "--warm-child"], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    need(r.returncode == 0, f"warm child failed (rc {r.returncode}): {r.stderr[-2000:]}")
    w = json.loads(r.stdout.strip().splitlines()[-1])
    built = (f"this run's nvcc build took {build_s:.1f} s" if build_s > 0 else
             "the build phase found every library already built, so this run has no nvcc "
             "wall to set beside it")
    print(f"[transport] warm child: CUDA context {w['context_s']:.3f} s; measure_warm_start "
          f"LeNet {list(WARM_RANGES)}: cold {[round(x * 1e3, 3) for x in w['cold_s']]} ms, warm "
          f"(after clear_in_memory) {[round(x * 1e3, 3) for x in w['warm_s']]} ms; first "
          f"dp_sweep launch from the populated build directory (load, no nvcc) "
          f"{w['first_sweep_s'] * 1e3:.3f} ms, second {w['second_sweep_s'] * 1e3:.3f} ms; "
          f"{built}", flush=True)
    return launches


# The parallel phase: the parallel layer on a world-one NCCL group.
# internlm2-1.8B's 24-layer block stack pipelined over one stage at each
# N_MICRO (two norms and one flash attention a layer a microbatch), granite's
# MoE prefill at the reference's expert-parallel threshold (B x S = 16,384
# tokens: every one of its 32 MoE layers takes the expert path), placed
# VGG-16 through the engine on a (1,) data mesh, and a checkpoint of
# internlm2's params restored onto the (1, 1) mesh.
PARALLEL = dict(stack="internlm2_1p8b", B=4, S=1024, n_micro=(4, 2),
                moe="granite_moe_3b", moe_B=4, moe_S=4096)
def rel_max(a, b) -> float:
    return ((a.float() - b.float()).abs().max() / b.float().abs().max()).item()


def counted(torch, fn):
    """fn() with every launch count set to 0 just before and read just
    after: (its result, its launches by kernel, its synchronised wall s)."""
    kernels = all_kernels()
    for k in kernels.values():
        k.n_launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, {name: k.n_launches for name, k in kernels.items()}, time.perf_counter() - t0


def nccl_events(torch, fn) -> dict:
    """``torch.profiler`` over fn(): the count of each host and device event
    whose name says NCCL, by (device type, name)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out: dict = {}
    for e in prof.events():
        if "nccl" in e.name.lower():
            key = (str(e.device_type).split(".")[-1], e.name[:60])
            out[key] = out.get(key, 0) + 1
    return out


def parallel_phase(torch) -> dict:
    """(a) a world-one NCCL group and its meshes; (b) internlm2's block stack
    pipelined; (c) granite's expert-parallel prefill; (d) VGG-16 through the
    engine on a data mesh; (e) a checkpoint re-sharded.  Returns the main
    path's launches by kernel: (b)'s pipelined runs and (c)'s prefill, each
    counted from 0."""
    import tempfile

    import torch.distributed as dist
    import torch.nn.functional as F
    from repro_torch import configs as C
    from repro_torch import exec as X
    from repro_torch.checkpointing import CheckpointManager
    from repro_torch.launch import mesh as launch_mesh
    from repro_torch.models import init_params, moe, prefill, transformer
    from repro_torch.parallel import (MeshAxes, named_shardings, param_pspecs,
                                      pipeline_forward_stages, set_active_mesh, shard_params)

    # (a)
    launch_mesh.init_process_group("cuda")
    need(dist.get_backend() == "nccl" and dist.get_world_size() == 1,
         f"process group {dist.get_backend()} of {dist.get_world_size()}")
    mesh11 = launch_mesh.make_mesh((1, 1), ("data", "model"))
    stage = launch_mesh.make_mesh((1,), ("stage",))
    data = launch_mesh.make_mesh((1,), ("data",))
    try:
        launch_mesh.make_production_mesh()
    except RuntimeError as e:
        need("(16, 16) needs 256 ranks" in str(e),
             f"make_production_mesh() on one card raised another error: {e!r}")
        print(f"[parallel] make_production_mesh() on one card raises: {e}", flush=True)
    else:
        need(False, "make_production_mesh() built a (16, 16) mesh on one card")
    print(f"[parallel] NCCL world of {dist.get_world_size()}: meshes {mesh11}, {stage}, {data}",
          flush=True)
    launches = {name: 0 for name in all_kernels()}
    try:
        # (b)
        arch, B, S = PARALLEL["stack"], PARALLEL["B"], PARALLEL["S"]
        cfg = C.production_cfg(C.get_config(arch))
        params = init_params(SEED, cfg, device="cuda")
        specs = param_pspecs(params, mesh11)
        t0 = time.perf_counter()
        placed = shard_params(params, mesh11, specs)
        torch.cuda.synchronize()
        place_s = time.perf_counter() - t0
        pairs = list(zip(_leaves(params), _leaves(placed)))
        need(all(torch.equal(b.full_tensor(), a) for a, b in pairs),
             f"{arch}: a placed leaf's full_tensor() differs from the weight")
        local = [_tree_map(p, lambda t: t.to_local()) for p in placed["blocks"]]
        sharded = sum(any(e is not None for e in s) for s in _leaves(specs))
        print(f"[parallel] {arch}: {len(pairs)} leaves placed by shard_params(param_pspecs) in "
              f"{place_s:.3f} s ({sharded} with a sharded dim on the (1, 1) mesh), each "
              "full_tensor() bit-identical to its weight", flush=True)
        toks = torch.as_tensor(np.random.default_rng(SEED).integers(0, cfg.vocab, (B, S)),
                               device="cuda")
        cfg32 = dataclasses.replace(cfg, param_dtype="float32", compute_dtype="float32")
        blocks32 = [_tree_map(p, lambda t: t.float()) for p in params["blocks"]]

        def stack(fn, blocks, x):
            for p in blocks:
                x = fn(p, x)
            return x

        with torch.inference_mode():
            x = F.embedding(toks, params["embed"]["table"])
            kernel, plain = transformer.block_fn(cfg), transformer.block_fn(cfg, plain=True)
            stack(kernel, local, x)   # warm-up: first cuBLAS calls at these shapes
            ref32 = stack(transformer.block_fn(cfg32, plain=True), blocks32, x.float())
            floor = rel_max(stack(plain, params["blocks"], x), ref32)
            unpiped, _, unpiped_s = counted(torch, lambda: stack(kernel, local, x))
            print(f"[parallel] {arch} block stack ({cfg.n_layers} layers, x {tuple(x.shape)} "
                  f"bf16) unpipelined: wall {unpiped_s * 1e3:.2f} ms; plain bf16 vs plain f32 "
                  f"(the floor) {floor:.3e}", flush=True)
            for n_micro in PARALLEL["n_micro"]:
                out, got, wall = counted(torch, lambda m=n_micro: pipeline_forward_stages(
                    kernel, local, x, mesh=stage, stage_sizes=[cfg.n_layers], n_micro=m))
                want = {**{k: 0 for k in launches}, "rmsnorm": 2 * cfg.n_layers * n_micro,
                        "flash_attention": cfg.n_layers * n_micro}
                need(got == want, f"pipelined n_micro {n_micro}: launches {got} != {want}")
                for k in launches:
                    launches[k] += got[k]
                err = rel_max(out, ref32)
                print(f"[parallel] {arch} pipelined, 1 stage, n_micro {n_micro}: wall "
                      f"{wall * 1e3:.2f} ms (unpipelined {unpiped_s * 1e3:.2f}); launches "
                      f"{got}; vs plain f32 {err:.3e} = {err / floor:.3f} x the floor (gate "
                      f"{BF16_FLOOR_RATIO}); vs the unpipelined kernel path "
                      f"{rel_max(out, unpiped):.3e} (information)", flush=True)
                need(err <= BF16_FLOOR_RATIO * floor, f"pipelined n_micro {n_micro}: {err:.3e} "
                     f"from f32 > {BF16_FLOOR_RATIO} x the floor {floor:.3e}")
            out32 = pipeline_forward_stages(transformer.block_fn(cfg32), blocks32, x.float(),
                                            mesh=stage, stage_sizes=[cfg.n_layers],
                                            n_micro=PARALLEL["n_micro"][0])
            err32 = rel_max(out32, ref32)
            print(f"[parallel] {arch} pipelined in f32 (the kernels' f32 instantiations) vs "
                  f"plain f32: {err32:.3e} (gate {F32_GATE})", flush=True)
            need(err32 <= F32_GATE, f"pipelined f32 {err32:.3e} > {F32_GATE}")
        del blocks32, ref32, out32, placed, local

        # (e) the checkpoint of (b)'s params, restored onto the (1, 1) mesh
        with tempfile.TemporaryDirectory() as d:
            mgr = CheckpointManager(d)
            t0 = time.perf_counter()
            mgr.save(0, params)
            save_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            restored, _ = mgr.restore(0, params, shardings=named_shardings(mesh11, specs))
            torch.cuda.synchronize()
            restore_s = time.perf_counter() - t0
        need(all(b.device_mesh is mesh11 and torch.equal(b.full_tensor(), a)
                 for a, b in zip(_leaves(params), _leaves(restored))),
             f"{arch}: a re-sharded leaf differs from the saved weight")
        print(f"[parallel] checkpoint of {arch}'s params: save {save_s:.2f} s, restore onto "
              f"the (1, 1) mesh as DTensors {restore_s:.2f} s, every leaf bit-identical",
              flush=True)
        del params, restored
        torch.cuda.empty_cache()

        # (c) granite's expert-parallel prefill at the threshold
        arch, B, S = PARALLEL["moe"], PARALLEL["moe_B"], PARALLEL["moe_S"]
        cfg = C.production_cfg(C.get_config(arch))
        need(cfg.moe.impl == "shard_map" and B * S >= moe.SHARD_MAP_MIN_TOKENS,
             f"{arch}: impl {cfg.moe.impl}, {B * S} tokens")
        E = cfg.moe.num_experts
        cap = max(1, int(B * S * cfg.moe.top_k * cfg.moe.capacity_factor / E))
        params = init_params(SEED, cfg, device="cuda")
        toks = torch.as_tensor(np.random.default_rng(SEED).integers(0, cfg.vocab, (B, S)),
                               device="cuda")
        cfg_sc = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, impl="scatter"))
        cfg32 = dataclasses.replace(cfg_sc, param_dtype="float32", compute_dtype="float32")
        params32 = _tree_map(params, lambda t: t.float())
        calls = {"expert": 0, "scatter": 0}
        real_ep, real_sc = moe._moe_expert_parallel, moe._moe_scatter

        def spy_ep(*a):
            calls["expert"] += 1
            return real_ep(*a)

        def spy_sc(*a):
            calls["scatter"] += 1
            return real_sc(*a)

        moe._moe_expert_parallel, moe._moe_scatter = spy_ep, spy_sc
        set_active_mesh(mesh11, MeshAxes())
        try:
            with torch.inference_mode():
                batch = {"tokens": toks}
                prefill(params, cfg, batch)   # warm-up
                calls.update(expert=0, scatter=0)
                (ep_logits, _), got, ep_s = counted(torch, lambda: prefill(params, cfg, batch))
                want = {**{k: 0 for k in launches}, "rmsnorm": 2 * cfg.n_layers + 1,
                        "flash_attention": cfg.n_layers}
                need(got == want, f"{arch} expert-path prefill: launches {got} != {want}")
                need(calls == {"expert": cfg.n_layers, "scatter": 0},
                     f"{arch}: MoE layers by path {calls}, not all {cfg.n_layers} expert-parallel")
                for k in launches:
                    launches[k] += got[k]
                print(f"[parallel] {arch} prefill (B {B}, S {S}: {B * S} tokens, E_pad {E}, "
                      f"cap {cap}) through the expert path in all {cfg.n_layers} MoE layers: "
                      f"wall {ep_s * 1e3:.2f} ms; launches {got}", flush=True)
                # Each MoE layer gathers its three expert weights and its
                # rows over data and sums over model, and averages aux over
                # data.  NCCL runs a one-rank collective without a kernel of
                # its own: an out-of-place all-gather becomes a device copy
                # (under its nccl:all_gather range on the card's stream), an
                # in-place sum nothing.
                events = nccl_events(torch, lambda: prefill(params, cfg, batch))
                print(f"[parallel] {arch} expert-path prefill under torch.profiler: NCCL "
                      f"events {events}", flush=True)
                want_events = {("CPU", "nccl:all_gather"): 4 * cfg.n_layers,
                               ("CUDA", "nccl:all_gather"): 4 * cfg.n_layers,
                               ("CPU", "nccl:all_reduce"): 2 * cfg.n_layers}
                need(all(events.get(k) == n for k, n in want_events.items()),
                     f"{arch}: NCCL collectives {events}, not {want_events}")
                (_, _), _, sc_s = counted(torch, lambda: prefill(params, cfg_sc, batch))
                # the comparison: every path dispatches to the f32 path's experts
                routes = RouteLog("f32")
                logits = {}
                with routes:
                    for name, c, prm, pl in (("f32", cfg32, params32, True),
                                             ("ep", cfg, params, False),
                                             ("scatter", cfg_sc, params, False),
                                             ("plain", cfg_sc, params, True)):
                        routes.path = name
                        logits[name] = prefill(prm, c, batch, plain=pl)[0]
                    routes.compare(["ep-scatter", "ep-f32"])
        finally:
            set_active_mesh(None)
            moe._moe_expert_parallel, moe._moe_scatter = real_ep, real_sc
        agree = routes.agreement("ep-scatter")
        floor, err = rel_max(logits["plain"], logits["f32"]), rel_max(logits["ep"], logits["f32"])
        ep_sc = rel_max(logits["ep"], logits["scatter"])
        print(f"[parallel] {arch} expert path vs scatter: prefill wall {ep_s * 1e3:.2f} vs "
              f"{sc_s * 1e3:.2f} ms; own top-k sets agree in {agree:.6f} of (layer, token) rows "
              f"(gate {ROUTE_AGREE}; vs f32 {routes.agreement('ep-f32'):.6f}); logits, dispatch "
              f"pinned to f32's routing: ep vs scatter {ep_sc:.3e}, ep vs f32 {err:.3e} = "
              f"{err / floor:.3f} x the floor {floor:.3e} (gate {BF16_FLOOR_RATIO})", flush=True)
        need(agree >= ROUTE_AGREE, f"{arch}: top-k agreement {agree:.6f} < {ROUTE_AGREE}")
        need(all(bool(torch.isfinite(t).all()) for t in logits.values())
             and ep_logits.shape == (B, cfg.vocab), f"{arch}: logits not finite or misshapen")
        need(err <= BF16_FLOOR_RATIO * floor, f"{arch}: expert path {err:.3e} from f32 > "
             f"{BF16_FLOOR_RATIO} x the floor {floor:.3e}")
        del params, params32, logits
        torch.cuda.empty_cache()

        # (d) placed VGG-16 through the engine on a (1,) data mesh
        run = placed_setup(torch, "vgg16")
        alone = run["engine"].run(run["graph"], run["frames"])
        on_mesh = X.ExecutionEngine(run["layers"](run["params"]), mesh=data,
                                    device="cuda").run(run["graph"], run["frames"])
        need(all(np.array_equal(on_mesh.outputs[r], alone.outputs[r]) for r in alone.outputs),
             "vgg16 on a (1,) data mesh differs from the run without a mesh")
        print(f"[parallel] placed vgg16 on {FRAMES} frames through ExecutionEngine(mesh=(1,) "
              f"data): outputs bit-identical to the run without a mesh; stage walls "
              f"{[round(t.wall_s * 1e3, 3) for t in on_mesh.stage_timings]} ms (without "
              f"{[round(t.wall_s * 1e3, 3) for t in alone.stage_timings]})", flush=True)
    finally:
        dist.destroy_process_group()
    return launches


# The [mesh] phase: (a)'s full-width serving paths and decode steps on a
# world-one mesh, and (b)'s production cells on a fake (16, 16) group.
MESH = dict(archs=("internlm2_1p8b", "hymba_1p5b"), steps=16,
            cells=(("internlm2_1p8b", "prefill_32k"), ("internlm2_1p8b", "decode_32k"),
                   ("internlm2_1p8b", "train_4k"), ("hymba_1p5b", "prefill_32k"),
                   ("hymba_1p5b", "decode_32k")))


def examples_phase(torch) -> dict:
    """The reference's three remaining examples through the port's entry
    points on the card, each printing its own lines.  quickstart: its 30
    losses against the same run on the CPU from the same initial params
    (made on the CPU from seed 0) within F32_GATE relative, the loss
    falling, the resume taking 0 steps, the launches exact.  train_100m
    --full: 300 steps and one restart, the loss falling, the launches exact
    (EXAMPLES' 320 steps run), the finishing attempt's step walls (median,
    spread), the checkpoint saves' walls, the card's busy share from
    ``nvidia-smi`` over the run and the idle share of one more step under
    the profiler.  serve_pipeline at one H100's group sizes: the placement's
    lines, the generated tokens equal to ``Server.generate`` on the CPU from
    the same params, the straggler-aware nodes avoiding group 5, the
    launches exact.  Returns the examples' launches."""
    from repro_torch.data import DataConfig
    from repro_torch.data.pipeline import _batch_at
    from repro_torch.launch import quickstart, serve_pipeline, train_100m
    from repro_torch.models import init_params
    from repro_torch.optim import AdamWConfig, tree_map
    from repro_torch.runtime import ServeConfig, Server, TrainConfig, make_train_step

    card = card_line()
    ex = EXAMPLES
    launches = {name: 0 for name in all_kernels()}

    def add(counts):
        for k in launches:
            launches[k] += counts[k]

    def on_card(params):
        return tree_map(lambda t: t.to("cuda"), params)

    # quickstart
    t0 = time.perf_counter()
    p_cpu = init_params(SEED, quickstart.config(), device="cpu")
    cpu = quickstart.main(["--device", "cpu"], params=p_cpu)
    cpu_s = time.perf_counter() - t0
    out, counts, wall = counted(torch, lambda: quickstart.main([], params=on_card(p_cpu)))
    add(counts)
    got, want = np.asarray(out["losses"]), np.asarray(cpu["losses"])
    gap = float(np.max(np.abs(got - want) / np.abs(want)))
    print(f"[examples] quickstart on the card: {len(got)} steps in {wall:.1f} s (steps "
          f"{statistics.median(out['walls']) * 1e3:.2f} ms median), losses within {gap:.3e} "
          f"relative of the CPU run's from the same params (gate {F32_GATE}; the CPU run "
          f"{cpu_s:.1f} s), resume {out['resumed_steps']} new steps; launches {counts} "
          f"[{card}]", flush=True)
    need(gap <= F32_GATE, f"quickstart: losses {gap:.3e} from the CPU run's")
    need(len(got) == ex["steps"] and got[-1] < got[0] and out["resumed_steps"] == 0,
         f"quickstart: {len(got)} steps, loss {got[0]} -> {got[-1]}, resumed "
         f"{out['resumed_steps']}")
    need(counts == train_launches(ex["steps"], 2), f"quickstart: launches {counts}")

    # train_100m --full
    fl = ex["full"]
    smi = subprocess.Popen(["nvidia-smi", "--query-gpu=utilization.gpu",
                            "--format=csv,noheader,nounits", "-lms", "100"],
                           stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    try:
        out, counts, wall = counted(torch, lambda: train_100m.main(["--full"]))
    finally:
        smi.terminate()
        util = [float(x) for x in smi.communicate(timeout=30)[0].split()
                if x.replace(".", "", 1).isdigit()]
    add(counts)
    run = fl["fail"] + fl["steps"] - fl["resume"]
    walls = sorted(out["walls"])
    q = lambda f: walls[min(int(f * len(walls)), len(walls) - 1)]  # noqa: E731
    cfg, steps, batch, seq = train_100m.config(True)
    tcfg = TrainConfig(optimizer=AdamWConfig(lr=1e-3, warmup_steps=20, total_steps=steps))
    step = make_train_step(cfg, tcfg)
    b = {"tokens": torch.from_numpy(_batch_at(DataConfig(vocab=cfg.vocab, seq_len=seq,
                                                         global_batch=batch), 0, 0, 1)
                                    ["tokens"]).cuda()}
    params, opt = out["params"], out["opt_state"]
    step(params, opt, b)   # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step(params, opt, b)
    torch.cuda.synchronize()
    bare = time.perf_counter() - t0
    _, groups, kcounts = profile_step(torch, lambda: step(params, opt, b))
    dev_us = sum(groups.values())
    print(f"[examples] train_100m --full on the card: {out['n_params'] / 1e6:.1f} M params, "
          f"{cfg.n_layers} layers, batch {batch} x {seq}, {out['last_step'] + 1} steps, "
          f"{out['restarts']} restart (failure at step {out['fail_step']}; {run} steps run), "
          f"loss {out['losses'][0]:.4f} -> {out['losses'][-1]:.4f}, {wall:.1f} s in all; the "
          f"finishing attempt's {len(walls)} step walls: median {statistics.median(walls) * 1e3:.3f} "
          f"ms, p10 {q(0.1) * 1e3:.3f}, p90 {q(0.9) * 1e3:.3f}, min {walls[0] * 1e3:.3f}, max "
          f"{walls[-1] * 1e3:.3f}; checkpoint saves {[round(w * 1e3, 1) for w in out['ckpt_walls']]} "
          f"ms; launches {counts} ({run} x {train_launches(1, cfg.n_layers)}) [{card}]",
          flush=True)
    print(f"[examples] train_100m: nvidia-smi utilization.gpu over the run, {len(util)} samples, "
          + (f"mean {statistics.mean(util):.1f} %: device idle share "
             f"{1 - statistics.mean(util) / 100:.3f}" if util else "not measured")
          + f"; one more step {bare * 1e3:.3f} ms unprofiled, kernels {dev_us / 1e3:.3f} ms: "
          f"device idle share {1 - dev_us / (bare * 1e6):.3f}"
          + "".join(f"; {g} {us / 1e3:.3f} ms ({kcounts[g]} kernels)"
                    for g, us in sorted(groups.items(), key=lambda kv: -kv[1])) + f" [{card}]",
          flush=True)
    need(out["last_step"] + 1 == fl["steps"] and out["restarts"] == 1,
         f"train_100m: {out['last_step'] + 1} steps, {out['restarts']} restarts")
    need(all(np.isfinite(out["losses"])) and out["losses"][-1] < out["losses"][0],
         f"train_100m: loss {out['losses'][0]} -> {out['losses'][-1]}")
    need(counts == train_launches(run, fl["layers"]), f"train_100m: launches {counts}")
    del out, params, opt, step, b
    torch.cuda.empty_cache()

    # serve_pipeline at one H100's group sizes
    cfg = serve_pipeline.config()
    p_cpu = init_params(SEED, cfg, device="cpu")
    out, counts, wall = counted(torch, lambda: serve_pipeline.main([], params=on_card(p_cpu)))
    add(counts)
    cpu_tokens = Server(cfg, p_cpu, ServeConfig(max_len=ex["max_len"], batch_size=4),
                        device="cpu").generate(serve_pipeline.prompts(cfg.vocab), steps=ex["gen"])
    same = np.array_equal(out["tokens"], cpu_tokens)
    want = {"rmsnorm": (2 * 2 + 1) * (1 + ex["gen"]), "flash_attention": 2,
            "decode_attention": 2 * ex["gen"]}
    print(f"[examples] serve_pipeline on the card: {wall:.1f} s in all; admitted "
          f"{out['admitted']}/6, routes {out['routes']}; tokens {out['tokens'].shape} equal to "
          f"the CPU's from the same params {same}; straggler-aware nodes {out['nodes']}; "
          f"launches {counts} [{card}]", flush=True)
    need(same, "serve_pipeline: the card's tokens differ from the CPU's")
    need(out["nodes"] and 5 not in out["nodes"], f"serve_pipeline: nodes {out['nodes']}")
    need({k: v for k, v in counts.items() if v} == want, f"serve_pipeline: launches {counts}")
    return launches


def mesh_phase(torch) -> dict:
    """(a) the sharded steps on a world-one NCCL (1, 1) mesh against the
    unsharded ones; (b) rank 0's program of the production cells on a fake
    (16, 16) group on the card against the dry-run's trace of it.  Returns
    the mesh path's launches: (a)'s sharded runs and (b)'s, each counted
    from 0."""
    import torch.distributed as dist
    from repro_torch import configs as C
    from repro_torch.configs.base import SHAPES
    from repro_torch.data import DataConfig
    from repro_torch.data.pipeline import _batch_at
    from repro_torch.device import expandable_segments
    from repro_torch.launch import dryrun
    from repro_torch.launch import mesh as launch_mesh
    from repro_torch.models import init_params, transformer
    from repro_torch.optim import tree_leaves
    from repro_torch.parallel import sharding as sh
    from repro_torch.runtime import TrainConfig, init_opt_state, make_train_step

    card = card_line()
    launches = {name: 0 for name in all_kernels()}

    def add(counts):
        for k in launches:
            launches[k] += counts[k]

    # decode attention's row max and sum (``return_ml``, the context-parallel
    # merge's inputs) against the plain version's, at internlm2's decode
    # shape over a cache cut in two: each half's (o, m, l), and the halves
    # merged by them against the whole cache's output
    from repro_torch.kernels import ref
    from repro_torch.kernels.decode_attention import decode_attention
    g = torch.Generator(device="cuda").manual_seed(SEED)
    q = torch.randn((4, 16, 128), generator=g, device="cuda").to(torch.bfloat16)
    kc, vc = (torch.randn((4, 2048, 8, 128), generator=g, device="cuda").to(torch.bfloat16)
              for _ in range(2))
    parts, worst = [], 0.0
    for a, b in ((0, 1024), (1024, 2048)):
        o, m, l = decode_attention(q, kc[:, a:b], vc[:, a:b], 1000 if a else 1024,
                                   return_ml=True)
        po, pm, pl = ref.decode_attention(q, kc[:, a:b], vc[:, a:b], 1000 if a else 1024,
                                          return_ml=True)
        close(o, po, "bfloat16", "decode_attention return_ml o")
        worst = max(worst, rel_max(m, pm), rel_max(l, pl))
        parts.append((o, m, l))
    mg = torch.maximum(parts[0][1], parts[1][1])
    w = [l * torch.exp(m - mg) for _, m, l in parts]
    merged = sum(o.float() * wi[..., None] for (o, _, _), wi in zip(parts, w)) / sum(w)[..., None]
    whole = ref.decode_attention(q, kc, vc, 2024)
    err = close(merged.to(torch.bfloat16), whole, "bfloat16", "decode halves merged")
    print(f"[mesh] decode_attention return_ml at (4, 16, 128) over 2 x 1024 slots: (m, l) "
          f"within {worst:.3e} of the plain version's (gate 1e-4), the halves merged by them "
          f"{err:.3e} from the whole cache's plain output (bf16 2e-2) [{card}]", flush=True)
    need(worst <= 1e-4, f"decode_attention return_ml: (m, l) {worst:.3e} from the plain version")

    # (a)
    launch_mesh.init_process_group("cuda")
    mesh11 = launch_mesh.make_mesh((1, 1), ("data", "model"))
    try:
        for arch in MESH["archs"]:
            cfg = C.production_cfg(C.get_config(arch))
            B, S, n = PATHS[arch]["B"], PATHS[arch]["S"], MESH["steps"]
            params = init_params(SEED, cfg, device="cuda")
            prompts = torch.as_tensor(np.random.default_rng(SEED).integers(
                0, cfg.vocab, (B, S), dtype=np.int32), device="cuda")

            def serve(p, place):
                """Prefill and n decode steps teacher-forced on ``toks``."""
                with torch.no_grad():
                    lg, cache = transformer.prefill(p, cfg, place({"tokens": prompts}),
                                                    max_len=S + n + 1)
                    outs = [lg]
                    for i in range(n):
                        lg, cache = transformer.decode_step(p, cfg, place({"tokens": toks[i]})[
                            "tokens"], cache, S + i)
                        outs.append(lg)
                return outs, cache

            with torch.no_grad():  # the unsharded path's greedy tokens
                lg, cache = transformer.prefill(params, cfg, {"tokens": prompts},
                                                max_len=S + n + 1)
                toks = []
                for i in range(n):
                    toks.append(lg.argmax(-1, keepdim=True).to(torch.int32))
                    lg, cache = transformer.decode_step(params, cfg, toks[-1], cache, S + i)
            del lg, cache
            (want, want_cache), plain_counts, plain_s = counted(
                torch, lambda: serve(params, lambda b: b))
            placed = sh.shard_params(params, mesh11, sh.param_pspecs(params, mesh11))
            sh.set_active_mesh(mesh11)
            try:
                (got, got_cache), counts, mesh_s = counted(
                    torch, lambda: serve(placed, lambda b: sh.place_batch(b, mesh11)))
            finally:
                sh.set_active_mesh(None)
            add(counts)
            same = [torch.equal(g.full_tensor(), w) for g, w in zip(got, want)]
            same_cache = all(torch.equal(g[k].full_tensor(), w[k])
                             for g, w in zip(got_cache, want_cache) for k in w)
            print(f"[mesh] {arch} on a world-one (1, 1) mesh, batch {B}, prompt {S}: prefill and "
                  f"{n} decode steps through DTensor params and local_map'd kernels, logits "
                  f"bit-identical at {sum(same)} of {len(same)} steps, cache bit-identical "
                  f"{same_cache}; launches {counts} (unsharded {plain_counts}); walls "
                  f"{mesh_s:.3f} s sharded, {plain_s:.3f} s unsharded [{card}]", flush=True)
            need(all(same) and same_cache, f"mesh {arch}: the sharded steps differ from the "
                 "unsharded ones on a world-one mesh")
            need(counts == plain_counts, f"mesh {arch}: launches {counts} != {plain_counts}")
            del params, placed, got, want, got_cache, want_cache
            torch.cuda.empty_cache()

        # the reduced loop's xlstm (the launcher's shrink), one train step
        rcfg = C.get_config("xlstm_1p3b").reduced(n_layers=2, d_model=128, vocab=1024)
        tcfg = TrainConfig()
        tokens = torch.from_numpy(_batch_at(DataConfig(vocab=rcfg.vocab, seq_len=64,
                                                       global_batch=4), 0, 0, 1)["tokens"])
        batch = {"tokens": tokens.to("cuda")}

        def grads(p, b):
            leaves = tree_leaves(p)
            for t in leaves:
                t.requires_grad_(True)
            loss, _ = transformer.loss_fn(p, rcfg, b, remat=True)
            out = torch.autograd.grad(loss, leaves)
            for t in leaves:
                t.requires_grad_(False)
            return loss, [sh.like(g, t) for g, t in zip(out, leaves)]

        p0 = init_params(SEED, rcfg, device="cuda")
        (loss0, g0), plain_counts, _ = counted(torch, lambda: grads(p0, batch))
        p1 = sh.shard_params(p0, mesh11, sh.param_pspecs(p0, mesh11))
        pa = init_params(SEED, rcfg, device="cuda")
        new0, _, met0 = make_train_step(rcfg, tcfg)(pa, init_opt_state(pa, tcfg), batch)
        sh.set_active_mesh(mesh11)
        try:
            (loss1, g1), counts, _ = counted(torch, lambda: grads(p1, sh.place_batch(batch,
                                                                                     mesh11)))
            opt = init_opt_state(p1, tcfg)
            (new, opt, met), step_counts, step_s = counted(
                torch, lambda: make_train_step(rcfg, tcfg)(p1, opt,
                                                           sh.place_batch(batch, mesh11)))
        finally:
            sh.set_active_mesh(None)
        add(counts)
        add(step_counts)
        same_g = sum(torch.equal(a.full_tensor(), b) for a, b in zip(g1, g0))
        same_p = sum(torch.equal(a.full_tensor(), b)
                     for a, b in zip(tree_leaves(new), tree_leaves(new0)))
        kept = all(tuple(a.placements) == tuple(b.placements) == tuple(c.placements)
                   for a, b, c in zip(tree_leaves(new), tree_leaves(opt["m"]), tree_leaves(opt["v"])))
        print(f"[mesh] reduced xlstm train step on the (1, 1) mesh: loss "
              f"{loss1.full_tensor().item()!r} (unsharded {loss0.item()!r}, bit-identical "
              f"{torch.equal(loss1.full_tensor(), loss0)}); gradient leaves bit-identical "
              f"{same_g} of {len(g0)}; after one AdamW step the step's loss bit-identical "
              f"{torch.equal(met['loss'].full_tensor(), met0['loss'])}, params bit-identical "
              f"{same_p} of {len(g0)}, params and moments keep their placements {kept}; "
              f"launches {counts} (unsharded {plain_counts}); the step {step_s * 1e3:.1f} ms, "
              f"launches {step_counts} [{card}]", flush=True)
        need(torch.equal(loss1.full_tensor(), loss0) and same_g == len(g0)
             and same_p == len(g0) and torch.equal(met["loss"].full_tensor(), met0["loss"]),
             "mesh: the sharded train step differs from the unsharded one")
        need(kept and counts == plain_counts and step_counts == plain_counts,
             f"mesh train: placements {kept}, launches {counts} / {step_counts} vs "
             f"{plain_counts}")
        del p0, p1, pa, g0, g1, new, new0, opt
    finally:
        dist.destroy_process_group()
    torch.cuda.empty_cache()

    # (b)
    sizes, axes = dryrun.MESHES["single"]
    expandable_segments()
    try:
        for arch, shape_name in MESH["cells"]:
            cfg = C.production_cfg(C.get_config(arch))
            shape = SHAPES[shape_name]
            t0 = time.perf_counter()
            pshapes = transformer.param_shapes(cfg)
            part = dryrun.CellCounts(cfg, shape, pshapes, "single").at(shape.global_batch)
            rec = dryrun.per_device(part, shape)
            trace_s = time.perf_counter() - t0
            with launch_mesh.fake_mesh(tuple(sizes.values()), tuple(sizes), "cuda") as mesh:
                sh.set_active_mesh(mesh, axes)
                try:
                    torch.cuda.empty_cache()
                    torch.cuda.synchronize()
                    base = torch.cuda.memory_allocated()
                    torch.cuda.reset_peak_memory_stats()
                    # made where the step runs: the serving steps in inference mode
                    with torch.inference_mode(shape.kind != "train"):
                        inputs = dryrun.sharded_inputs(
                            cfg, shape, mesh, axes,
                            dryrun.input_specs(cfg, shape, params=pshapes), device="cuda")
                    args = torch.cuda.memory_allocated() - base
                    out, counts, first_s = counted(torch, lambda: dryrun._step(cfg, shape, inputs))
                    peak = torch.cuda.max_memory_allocated() - base
                    del out
                    _, _, wall = counted(torch, lambda: dryrun._step(cfg, shape, inputs))
                    del inputs
                finally:
                    sh.set_active_mesh(None)
            add(counts)
            want = rec["partition"]["kernel_calls"]
            wpeak = rec["memory"]["peak_memory_in_bytes"]
            print(f"[mesh] {arch} {shape_name} rank 0 of (16, 16) on a fake group: local "
                  f"arguments {args} B (record {rec['memory']['argument_size_in_bytes']}), "
                  f"peak {peak} B against the record's {wpeak} ({(peak - wpeak) / 2**20:+.1f} "
                  f"MiB, {peak / wpeak - 1:+.4%}); launches {counts} (trace {want}); "
                  f"compute-only wall {wall * 1e3:.3f} ms (first call {first_s * 1e3:.3f} ms; "
                  f"no link moves a byte); the trace {trace_s:.1f} s: "
                  f"{rec['flops_per_partition']:.4e} FLOPs, {rec['collectives']['count']} "
                  f"collectives {rec['collectives']['weighted_link_traffic']:.4e} B weighted "
                  f"[{card}]", flush=True)
            need({k: counts[k] for k in want} == want and counts["dp_sweep"] == 0,
                 f"mesh {arch} {shape_name}: launches {counts} != the trace's {want}")
            need(abs(peak - wpeak) <= PEAK_REL * wpeak + PEAK_ABS,
                 f"mesh {arch} {shape_name}: peak {peak} B vs the record's {wpeak} B")
            torch.cuda.empty_cache()
    finally:
        expandable_segments(False)
    return launches


SOURCES = {  # kernel -> (CUDA source, the TPU kernel it replaces)
    "rmsnorm": ("src/repro_torch/kernels/csrc/rmsnorm.cu", "src/repro/kernels/rmsnorm.py:19"),
    "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:26"),
    "decode_attention": ("src/repro_torch/kernels/csrc/decode_attention.cu",
                         "src/repro/kernels/decode_attention.py:24"),
    "ssd_scan": ("src/repro_torch/kernels/csrc/ssm_scan.cu", "src/repro/kernels/ssm_scan.py:25"),
    "dp_sweep": ("src/repro_torch/kernels/csrc/dp_sweep.cu", "src/repro/core/batch_dp.py:75"),
    # no TPU kernel: the Pallas rmsnorm has no VJP, and the reference trains
    # through XLA's autodiff of ref.rmsnorm
    "rmsnorm_bwd": ("src/repro_torch/kernels/csrc/rmsnorm.cu", "src/repro/kernels/ref.py:40"),
    # no TPU kernel either: the Pallas flash attention has no VJP, and the
    # reference trains through XLA's autodiff of ref.attention
    "flash_attention_bwd": ("src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
                            "src/repro/kernels/ref.py:47"),
    # nor for the SSD scan: the Pallas scan has no VJP, and the reference
    # trains hybrid blocks through XLA's autodiff of its chunked scan
    "ssd_scan_bwd": ("src/repro_torch/kernels/csrc/ssm_scan_bwd_tc.cu",
                     "src/repro/kernels/chunked.py:34"),
}
TIMES = ("shape", "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
EXTRAS = ("grid", "plan", "device_us", "depth_us", "norepeat_us", "decode_rows")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this check needs the card",
              file=sys.stderr)
        return 1
    from repro_torch.device import resolve_device
    from repro_torch.kernels import build
    card = card_line()
    print(card, flush=True)
    t_phase = time.perf_counter()

    def phase_done(name: str) -> None:
        nonlocal t_phase
        now = time.perf_counter()
        print(f"[time] {name} phase {now - t_phase:.1f} s", flush=True)
        t_phase = now

    resolve_device("cuda")  # TF32 off for the plain f32 comparisons
    build_s = build.build_all()
    print(f"[build] nvcc {' '.join(build.NVCC_FLAGS)}: {build_s:.1f} s"
          + ("" if build_s > 0 else " (every library already built)"), flush=True)
    tensor_core_count()
    ptxas_report()
    phase_done("build")

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    recs = kernel_phase(torch, gen)
    torch.cuda.empty_cache()  # the serve phase times prefill: no allocator churn
    phase_done("kernels")
    by_path = {}
    for arch in PATHS:
        by_path[arch] = serve_phase(torch, arch)
        torch.cuda.empty_cache()
        phase_done(f"serve {arch}")
    by_path["parallel"] = parallel_phase(torch)
    torch.cuda.empty_cache()
    phase_done("parallel")
    by_path["mesh"] = mesh_phase(torch)
    torch.cuda.empty_cache()
    phase_done("mesh")
    by_path["train"] = train_phase(torch)
    torch.cuda.empty_cache()
    phase_done("train")
    by_path["train attention"] = train_attention_phase(torch)
    torch.cuda.empty_cache()
    phase_done("train attention")
    by_path["train hybrid"] = train_hybrid_phase(torch)
    torch.cuda.empty_cache()
    phase_done("train hybrid")
    by_path["examples"] = examples_phase(torch)
    torch.cuda.empty_cache()
    phase_done("examples")
    by_path["dryrun"], held = dryrun_phase(torch)
    for rec in held:  # the kernels at the dry-run cells' shapes
        recs[rec["name"]].append(rec)
    torch.cuda.empty_cache()
    phase_done("dryrun")
    by_path["placement"], recs["dp_sweep"] = placement_phase(torch)
    torch.cuda.empty_cache()
    phase_done("place")
    by_path["swarm"] = swarm_phase(torch)
    torch.cuda.empty_cache()
    phase_done("swarm")
    by_path["transport"] = transport_phase(torch, build_s)
    torch.cuda.empty_cache()
    phase_done("transport")
    for name in SOURCES:
        need(any(launches[name] for launches in by_path.values()),
             f"{name} launched on no path")

    line = {"kernels": [
        {"name": name, "route": "cuda", "source": SOURCES[name][0],
         "replaces": SOURCES[name][1],
         "launches": sum(launches[name] for launches in by_path.values()),
         **{k: recs[name][0][k] for k in TIMES},
         "launches_by_path": {path: launches[name] for path, launches in by_path.items()},
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
    sys.exit(warm_child() if sys.argv[1:] == ["--warm-child"] else main())
