"""Serving launcher: batched greedy generation with the production server,
at full width in bf16 (``production_cfg``) on the card by default — plus a
placed CNN inference over a simulated pool with any registered planner.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch internlm2_1p8b \\
        --batch 4 --prompt-len 1024 --steps 64
    PYTHONPATH=src python -m repro_torch.launch.serve --arch hymba_1p5b \\
        --batch 4 --prompt-len 1536 --steps 64
    PYTHONPATH=src python -m repro_torch.launch.serve --execute \\
        --planner ould-dp --pool-nodes 8

``--reduced`` runs the reference's small f32 shrink instead (the CPU path:
``--reduced --device cpu``).  ``--execute`` places LeNet's requests (two
hotspot camera nodes, 128 MB a node, so requests offload part of their
path) over ``--pool-nodes`` nodes with ``--planner`` (``--sparse-k`` for the
``*-sparse`` planners), runs the placed inference on ``--device`` through
the execution engine with the in-process transport, then re-solves on the
measured-calibrated profile and prints the predicted-vs-measured MAE before
and after.  Waiting for the runtime slice (ROADMAP): the reference's
LM-pool ``schedule_requests`` placement print (``runtime/serve.py``),
``--transport loopback|multiproc``, ``--compile-cache`` and
``--trace-out`` (which routes placement through ``AdmissionController``).
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
    ap.add_argument("--planner", default="ould-dp",
                    help="registered placement strategy for --execute "
                         "(see repro_torch.core.available_planners())")
    ap.add_argument("--pool-nodes", type=int, default=8)
    ap.add_argument("--sparse-k", type=int, default=None,
                    help="candidate budget for the *-sparse planners "
                         "(default: ceil(sqrt(pool nodes)))")
    ap.add_argument("--execute", action="store_true",
                    help="run a placed LeNet inference through the execution engine and "
                         "report predicted vs measured latency (plus a calibrated re-solve)")
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
    if args.execute:
        execute_placed(args, dev)
    return out


def execute_placed(args, dev: torch.device) -> None:
    """Plan-faithful execution: place LeNet over the pool with the chosen
    planner, run it through the execution engine on ``dev``, then re-solve
    on the measured-calibrated profile."""
    from ..core import Problem, SnapshotView, get_planner, lenet_profile
    from ..core.radio import TpuLinkModel
    from ..exec import ExecutionEngine, calibrated_problem, compile_plan, layer_fns_for

    link = TpuLinkModel()
    n = args.pool_nodes
    coords = np.stack([np.arange(n) % link.torus[0], np.arange(n) // link.torus[0]], -1)
    rates_bits = link.rate_matrix(coords, np.zeros(n, np.int64)) * 8.0
    profile = lenet_profile()
    # Hotspot the frames on two camera nodes: lenet wants ~108 MB end to
    # end, so at 128 MB/node the co-sourced requests must offload part of
    # their path — the plan has transfers for the transport to carry.
    sources = (np.arange(args.batch) % min(2, n)).astype(np.int64)
    prob = Problem(profile, np.full(n, 128e6), np.full(n, 95e9), rates_bits, sources,
                   compute_speed=np.full(n, 9.5e9))
    opts = dict(sparse_k=args.sparse_k, device=dev)
    plan = get_planner(args.planner, **opts).plan(prob, SnapshotView(rates_bits))
    graph = compile_plan(plan)
    engine = ExecutionEngine(layer_fns_for(profile, device=dev), device=dev)
    frames = np.random.default_rng(0).standard_normal(
        (args.batch, 326, 595, 3)).astype(np.float32)
    report = engine.run(graph, frames, predicted_s=plan.evaluate().per_request_s)
    cal_prob, recon = calibrated_problem(prob, report)
    replan = get_planner(args.planner, **opts).plan(cal_prob, SnapshotView(cal_prob.rates))
    rereport = engine.run(compile_plan(replan), frames,
                          predicted_s=replan.evaluate().per_request_s)
    mae0 = report.abs_error_s[list(report.outputs)].mean()
    mae1 = rereport.abs_error_s[list(rereport.outputs)].mean()
    print(f"[exec] planner={plan.planner_name} admitted={plan.n_admitted}/{args.batch} "
          f"tasks={len(graph.tasks)} shared={graph.n_shared} "
          f"transfers={len(graph.transfers)} "
          f"executed_avg={report.executed_s[list(report.outputs)].mean():.4f}s")
    print(f"[exec] {recon.summary()}")
    print(f"[exec] predicted-vs-measured MAE {mae0 * 1e3:.2f}ms -> "
          f"{mae1 * 1e3:.2f}ms after calibrated re-solve")


if __name__ == "__main__":
    main()
