"""Serving launcher: batched greedy generation with the production server,
at full width in bf16 (``production_cfg``) on the card by default — plus a
placed CNN inference over a simulated pool with any registered planner.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch internlm2_1p8b \\
        --batch 4 --prompt-len 1024 --steps 64
    PYTHONPATH=src python -m repro_torch.launch.serve --arch hymba_1p5b \\
        --batch 4 --prompt-len 1536 --steps 64
    PYTHONPATH=src python -m repro_torch.launch.serve --arch minicpm3_4b \\
        --batch 4 --prompt-len 1024 --steps 64      # MLA
    PYTHONPATH=src python -m repro_torch.launch.serve --arch granite_moe_3b \\
        --batch 4 --prompt-len 1024 --steps 64      # MoE
    PYTHONPATH=src python -m repro_torch.launch.serve --arch xlstm_1p3b \\
        --batch 4 --prompt-len 1024 --steps 64      # xLSTM (mLSTM and sLSTM)
    PYTHONPATH=src python -m repro_torch.launch.serve --arch h2o_danube3_4b \\
        --batch 4 --prompt-len 4608 --steps 64      # heads of 120, window 4096
    PYTHONPATH=src python -m repro_torch.launch.serve --arch phi3_vision_4p2b \\
        --batch 4 --prompt-len 1024 --steps 64      # heads of 96
    PYTHONPATH=src python -m repro_torch.launch.serve --execute \\
        --planner ould-dp --pool-nodes 8

``--reduced`` runs the reference's small f32 shrink instead (the CPU path:
``--reduced --device cpu``).  After generating, the launcher places the
batch's requests (the model's full-width layer groups) over a simulated
pool of ``--pool-nodes`` nodes with ``--planner`` (``--sparse-k`` for the
``*-sparse`` planners) through ``schedule_requests`` and prints the plan.
``--execute`` places LeNet's requests (two hotspot camera nodes, 128 MB a
node, so requests offload part of their path) over the same pool, runs the
placed inference on ``--device`` through the execution engine, its
boundary transfers routed through ``--transport`` (``inproc``: modeled
delay, the default; ``loopback``: ``--transport-workers`` worker OS
processes over sockets; ``multiproc``: torch worker processes landing each
activation on ``--device``), then re-solves on the measured-calibrated
profile — and, with a byte-moving transport, on the realized link bandwidth
— and prints the predicted-vs-measured MAE before and after.
``--compile-cache DIR`` points the kernels' build directory at ``DIR``
(``exec/compile_cache.py``).  ``--trace-out PATH`` writes a Chrome/Perfetto
trace of the run: under ``--execute`` the placement goes through
``AdmissionController`` (its solver span and per-request admission
verdicts), the engine's stage walls and the transport's shipments are
traced, and the run's metrics are printed.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from .. import configs as C
from ..device import resolve_device
from ..core.radio import TpuLinkModel
from ..models import init_params
from ..runtime.serve import AdmissionController, ServeConfig, Server, schedule_requests


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
    ap.add_argument("--transport", default="inproc",
                    choices=("inproc", "loopback", "multiproc"),
                    help="byte-moving backend for --execute transfers: inproc = "
                         "modeled delay (default), loopback = worker OS processes "
                         "over sockets, multiproc = torch worker processes landing "
                         "each activation on --device; non-inproc backends also "
                         "calibrate the rates from realized bandwidth before the "
                         "re-solve")
    ap.add_argument("--transport-workers", type=int, default=2)
    ap.add_argument("--compile-cache", default=None, metavar="DIR",
                    help="the kernels' build directory (repro_torch.exec.compile_cache): "
                         "a later run loads the built kernels from it instead of "
                         "compiling them")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="write a Chrome/Perfetto-loadable trace of this run "
                         "(repro_torch.obs): solver/admission spans for the pool "
                         "placement, engine stage walls and transport shipments "
                         "under --execute")
    args = ap.parse_args(argv)

    tracer = metrics = None
    if args.trace_out:
        from ..obs import MetricsRegistry, Tracer
        tracer = Tracer()
        metrics = MetricsRegistry()

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

    # Place the batch's requests over a simulated pool with the chosen
    # planner — provenance comes from the Plan, not a hard-coded label.
    link = TpuLinkModel()
    n = args.pool_nodes
    coords = np.stack([np.arange(n) % link.torus[0], np.arange(n) // link.torus[0]], -1)
    rates_bits = link.rate_matrix(coords, np.zeros(n, np.int64)) * 8.0
    plan, ev = schedule_requests(
        C.get_config(args.arch), n_nodes=n, requests=args.batch,
        hbm_bytes=16e9 * 16, flops_budget=197e12 * 10,
        rates_bits=rates_bits, planner=args.planner, sparse_k=args.sparse_k)
    sparse = ""
    if plan.solve_stats is not None and plan.solve_stats.k:
        st = plan.solve_stats
        sparse = (f" sparse[k={st.k} pruned={st.pruned_fraction:.2f} "
                  f"dense_fallbacks={st.n_dense_fallback}]")
    print(f"[serve] placement planner={plan.planner_name} "
          f"view={plan.view_kind} status={plan.status} "
          f"admitted={plan.n_admitted}/{args.batch} "
          f"comm={ev.comm_latency_s * 1e6:.1f}us "
          f"stages(req0)={len(plan.stages(0)) if plan.admitted[0] else 0}"
          + sparse)

    if args.execute:
        execute_placed(args, dev, rates_bits, tracer, metrics)
    if tracer is not None:
        n_ev = tracer.export_chrome(args.trace_out)
        print(f"[trace] wrote {n_ev} events to {args.trace_out} "
              f"(n_dropped={tracer.n_dropped}) — load in ui.perfetto.dev")
        if metrics.names():
            snap = metrics.snapshot()
            print("[trace] metrics: " + ", ".join(
                f"{k}={v:.4g}" if isinstance(v, float) else f"{k}={v}"
                for k, v in snap.items() if not isinstance(v, dict)))
    return out


def execute_placed(args, dev: torch.device, rates_bits: np.ndarray,
                   tracer=None, metrics=None) -> None:
    """Plan-faithful execution: place LeNet over the pool with the chosen
    planner (through ``AdmissionController`` when tracing), run it through
    the execution engine on ``dev`` with every transfer routed through
    ``--transport``, then re-solve on the measured-calibrated profile (and,
    with a byte-moving transport, on realized link bandwidth)."""
    from ..core import Problem, SnapshotView, get_planner, lenet_profile
    from ..exec import (ExecutionEngine, calibrated_problem, compile_cache, compile_plan,
                        layer_fns_for)
    from ..exec.stage_graph import trace_args
    from ..obs import ENGINE
    from ..transport import make_transport

    if args.compile_cache:
        compile_cache.enable(args.compile_cache)
    n = args.pool_nodes
    profile = lenet_profile()
    # Hotspot the frames on two camera nodes: lenet wants ~108 MB end to
    # end, so at 128 MB/node the co-sourced requests must offload part of
    # their path — the plan has transfers for the transport to carry.
    sources = (np.arange(args.batch) % min(2, n)).astype(np.int64)
    prob = Problem(profile, np.full(n, 128e6), np.full(n, 95e9), rates_bits, sources,
                   compute_speed=np.full(n, 9.5e9))
    opts = dict(sparse_k=args.sparse_k, device=dev)
    if tracer is not None:
        # Route placement through the controller so the trace carries the
        # solver span + per-request admission verdicts.
        plan = AdmissionController(args.planner, tracer=tracer, **opts).admit(
            prob, SnapshotView(rates_bits), request_ids=list(range(args.batch)))
    else:
        plan = get_planner(args.planner, **opts).plan(prob, SnapshotView(rates_bits))
    graph = compile_plan(plan)
    transport = make_transport(args.transport, n_workers=args.transport_workers, device=dev)
    engine = ExecutionEngine(layer_fns_for(profile, device=dev), transport=transport,
                             tracer=tracer, device=dev)
    frames = np.random.default_rng(0).standard_normal(
        (args.batch, 326, 595, 3)).astype(np.float32)
    moving = args.transport != "inproc"
    try:
        if tracer is not None:
            t_round = tracer.now()
        report = engine.run(graph, frames, predicted_s=plan.evaluate().per_request_s)
        if tracer is not None:
            tracer.span(ENGINE, "execute_round", t_round, tracer.now() - t_round,
                        args=trace_args(graph))
        cal_prob, recon = calibrated_problem(prob, report,
                                             transport=transport if moving else None)
        replan = get_planner(args.planner, **opts).plan(cal_prob,
                                                        SnapshotView(cal_prob.rates))
        regraph = compile_plan(replan)
        if tracer is not None:
            t_round = tracer.now()
        rereport = engine.run(regraph, frames, predicted_s=replan.evaluate().per_request_s)
        if tracer is not None:
            tracer.span(ENGINE, "execute_recal", t_round, tracer.now() - t_round,
                        args=trace_args(regraph))
    finally:
        transport.close()
    mae0 = report.abs_error_s[list(report.outputs)].mean()
    mae1 = rereport.abs_error_s[list(rereport.outputs)].mean()
    print(f"[exec] planner={plan.planner_name} admitted={plan.n_admitted}/{args.batch} "
          f"tasks={len(graph.tasks)} shared={graph.n_shared} "
          f"transfers={len(graph.transfers)} "
          f"executed_avg={report.executed_s[list(report.outputs)].mean():.4f}s")
    print(f"[exec] {recon.summary()}")
    if moving:
        bw = ", ".join(f"{s}->{d}: {ls.bytes_per_s / 1e6:.0f} MB/s"
                       for (s, d), ls in sorted(transport.link_stats.items()))
        print(f"[exec] transport={args.transport} "
              f"workers={sorted(set(transport.worker_pids))} "
              f"moved={transport.moved_bytes / 1e6:.1f}MB ({bw})")
        print(f"[exec] re-solve priced comm from {replan.problem.comm_source!r}")
    print(f"[exec] predicted-vs-measured MAE {mae0 * 1e3:.2f}ms -> "
          f"{mae1 * 1e3:.2f}ms after calibrated re-solve")
    if metrics is not None:
        metrics.counter("exec.tasks").inc(len(graph.tasks))
        metrics.counter("exec.transfers").inc(len(graph.transfers))
        metrics.counter("exec.admitted").inc(int(plan.n_admitted))
        metrics.gauge("exec.executed_avg_s").set(
            float(report.executed_s[list(report.outputs)].mean()))
        metrics.gauge("exec.mae_s").set(float(mae0))
        metrics.gauge("exec.mae_recal_s").set(float(mae1))
        for (s, d), ls in sorted(transport.link_stats.items()):
            metrics.gauge(f"transport.link.{s}-{d}.bytes_per_s").set(ls.bytes_per_s)


if __name__ == "__main__":
    main()
