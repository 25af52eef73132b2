"""End-to-end paper scenario: a swarm of resource-constrained UAVs runs
distributed CNN inference on captured frames (port of
``examples/uav_surveillance.py``).

Pipeline (all real computation, simulated radio):
  1. RPG mobility places 10 UAVs over the target area; Eq.(1) rates derived
     from SINR/path-loss.
  2. Frames arrive at hotspot UAVs → the chosen placement planner (the
     paper's OULD ILP by default) places each request's LeNet layers across
     the swarm under 128 MB / 9.5 GFLOPS caps; the sparse pruned DP places
     the same instance beside it.
  3. Each request executes for real: LeNet runs layer ranges per stage on
     ``--device`` (the card by default); activations "transmitted" between
     UAVs are accounted against the link rates to produce the end-to-end
     latency the paper plots.
  4. The horizon strategy (ould-mp) re-plans once for the whole predicted
     horizon while the swarm moves; the streaming swarm serves a Poisson
     stream under churn with three policies, then with a 10-tick-old view.
  5. The placed run repeats with every boundary activation shipped through
     worker OS processes, and the planner re-solves on the realized
     bandwidth.

Every strategy goes through the registry (``repro_torch.core.get_planner``),
and all printed strategy labels come from ``Plan.planner_name``.

    PYTHONPATH=src python -m repro_torch.launch.uav_surveillance [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import torch

from ..core import HorizonView, Problem, SnapshotView, get_planner, lenet_profile
from ..core.mobility import RPGMobility, RPGParams
from ..core.radio import RadioParams, rate_matrix
from ..device import resolve_device
from ..exec import ExecutionEngine, calibrated_problem, compile_plan
from ..models import cnn
from ..runtime.swarm import SwarmScenario, simulate
from ..transport import LoopbackTransport

MB = 1e6


def fmt_stats(plan) -> str:
    """Human-readable Plan.solve_stats (never silently dropped)."""
    st = plan.solve_stats
    if st is None:
        return "solve_stats: n/a"
    if st.k:
        return (f"solve_stats: k={st.k} escalations={st.n_escalations} "
                f"dense_fallbacks={st.n_dense_fallback} "
                f"pruned={st.pruned_fraction:.1%}")
    return (f"solve_stats: kept={st.n_kept} replaced={st.n_replaced} "
            f"cold={st.cold}")


def main(argv: list[str] | None = None, params: dict | None = None) -> None:
    """Run the scenario.  ``params`` are LeNet weights on the device (as
    ``cnn.lenet_init`` returns them); default a fresh init seeded 0."""
    ap = argparse.ArgumentParser(description="the paper's UAV surveillance scenario")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    profile = lenet_profile()
    if params is None:
        params = cnn.lenet_init(torch.Generator(dev).manual_seed(0), device=dev)
    layer_fns = cnn.lenet_layers(params)

    mob = RPGMobility(RPGParams(n_uavs=10, area_m=150.0, homogeneous=False), seed=0)
    pos = mob.positions(1)[0]
    rates = rate_matrix(pos, RadioParams())
    rng = np.random.default_rng(0)
    requests = 8
    sources = rng.integers(0, 3, requests).astype(np.int64)

    # 128 MB nodes: a whole LeNet (108 MB) + any second request cannot fit,
    # so high loads force per-layer splits — the paper's core mechanism.
    prob = Problem(profile, mem_cap=np.full(10, 128 * MB), comp_cap=np.full(10, 95e9),
                   rates=rates, sources=sources, compute_speed=np.full(10, 9.5e9))
    planner = get_planner("ould-ilp", mip_rel_gap=1e-4, time_limit=20.0)
    plan = planner.plan(prob, SnapshotView(rates))
    ev = plan.evaluate()
    print(f"{plan.planner_name}: {plan.status}, "
          f"admitted {ev.n_admitted}/{requests}, "
          f"avg latency {ev.avg_latency_per_request:.3f}s, "
          f"shared {ev.shared_bytes / MB:.1f} MB")

    # The sparse pruned-DP strategy on the same instance, with its solver
    # telemetry surfaced from Plan.solve_stats.
    sparse_plan = get_planner("ould-dp-sparse").plan(prob, SnapshotView(rates))
    print(f"{sparse_plan.planner_name}: {sparse_plan.status}, "
          f"admitted {sparse_plan.n_admitted}/{requests} — "
          f"{fmt_stats(sparse_plan)}")

    # Execute the placed plan for real through the execution engine on the
    # device: shared stages batch across requests, link delays come from the
    # same transfer_cost matrix OULD minimized.
    frames = rng.standard_normal((requests, 326, 595, 3)).astype(np.float32)
    graph = compile_plan(plan)
    engine = ExecutionEngine(layer_fns, device=dev)
    report = engine.run(graph, frames, predicted_s=ev.per_request_s)
    for r in graph.requests:
        cls = int(np.argmax(report.outputs[r][0]))
        route = "->".join(str(s.node) for s in plan.stages(r))
        print(f"  request {r}: class={cls} route=[{route}] "
              f"comm={report.comm_s[r] * 1e3:.2f}ms "
              f"measured={report.executed_s[r] * 1e3:.1f}ms "
              f"predicted={ev.per_request_s[r] * 1e3:.1f}ms")

    # The horizon strategy over 5 predicted steps while the swarm moves:
    # one placement judged against each realized step's snapshot.
    horizon = 5
    pred = mob.predicted_rates(horizon)
    mp_prob = Problem(profile, np.full(10, 256 * MB), np.full(10, 95e9),
                      pred, sources, compute_speed=np.full(10, 9.5e9))
    mp_plan = get_planner("ould-mp", mip_rel_gap=1e-3, time_limit=20.0).plan(
        mp_prob, HorizonView(pred))
    lat = [f"{e.avg_latency_per_request:.3f}" for e in mp_plan.evaluate_per_step()]
    print(f"{mp_plan.planner_name} one-shot plan, per-step latency over "
          f"horizon: {lat}")

    # Streaming scenario: Poisson request arrivals on a two-group swarm whose
    # inter-group links fade in and out of range, plus node churn — every
    # policy is a registry name; 'incremental' is warm-started snapshot OULD.
    scn = SwarmScenario(arrival_rate_hz=0.3, duration_ticks=90, mtbf_s=60.0, mttr_s=20.0)
    for policy in ("incremental", "ould-mp", "nearest"):
        r = simulate(scn, policy, seed=0)
        print(f"swarm[{r.policy:12s}]: "
              f"deadline_miss={r.deadline_miss_rate:.3f} "
              f"rejected={r.rejection_rate:.3f} "
              f"avg_latency={r.avg_latency_s:.3f}s "
              f"resolve_total={r.total_resolve_s * 1e3:.1f}ms")

    # The degraded-view axis: same policy, same event tape, but the planner
    # only ever sees a 10-tick-old snapshot (serving stays on realized rates).
    stale = simulate(dataclasses.replace(scn, view_degradation="stale:10"),
                     "incremental", seed=0)
    print(f"swarm[incremental stale:10]: "
          f"deadline_miss={stale.deadline_miss_rate:.3f} "
          f"rejected={stale.rejection_rate:.3f} "
          f"avg_latency={stale.avg_latency_s:.3f}s")

    # Byte-moving transport (DESIGN.md §7): run the placed CNN with every
    # boundary activation shipped through worker OS processes, then hand the
    # realized per-link bandwidth to calibrate_rates so the planner re-solves
    # on measured comm — provenance rides in Plan.problem.comm_source.
    with LoopbackTransport(n_workers=2) as tp:
        lb_engine = ExecutionEngine(layer_fns, transport=tp, device=dev)
        lb_report = lb_engine.run(graph, frames, predicted_s=np.asarray(ev.per_request_s))
        exact = all(np.array_equal(lb_report.outputs[r], report.outputs[r])
                    for r in graph.requests)
        cal_prob, recon = calibrated_problem(prob, lb_report, transport=tp)
        print(f"transport[loopback]: workers={sorted(set(tp.worker_pids))} "
              f"moved={tp.moved_bytes / 1e6:.1f}MB exact={exact}")
        print(f"  {recon.summary()}")
        replan = planner.plan(cal_prob, SnapshotView(cal_prob.rates))
        print(f"  re-solve priced comm from {replan.problem.comm_source!r}")
    if not exact:
        raise SystemExit("uav_surveillance: the loopback run's outputs differ from the "
                         "in-process run's")
    print("uav_surveillance OK")


if __name__ == "__main__":
    main()
