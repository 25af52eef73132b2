"""Serving example: OULD-scheduled multi-request serving and real decode
(port of ``examples/serve_pipeline.py``).

1. OULD places 6 concurrent serving requests' layer groups over a pool of
   16 groups (``schedule_requests``), linked by ``core.radio.TpuLinkModel``'s
   rates x 8: the paper's multi-request placement driving the serving
   runtime.  That model is the modelled TPU pod's hop-rate torus (50 GB/s a
   link a direction over hop distance), the one pod link model the
   reference has; the port adds none, and none of its rates is the card's.
2. internlm2 cut to 2 layers of d 64 over a vocab of 512 serves batched
   greedy generation through ``Server`` (prefill, then decode with the
   cache updated in place): batch 4, a prompt of 16, 8 steps, on
   ``--device`` (the card by default: flash attention, decode attention and
   the norm, f32 kernels at heads of 16).
3. A straggler: ``elastic.replan_placement`` re-solves OULD with group 5's
   compute slowed 4 x and shows the placement routing around it.

Each group's memory and compute are arguments: by default one H100's, 80 GB
and 989 TFLOP/s (the bf16 dense peak, ``kernels/cost.py``); the reference's
example gives each 16 GB and 1.97 PFLOP/s (``--hbm-bytes 16e9
--flops-budget 1.97e15``).

    PYTHONPATH=src python -m repro_torch.launch.serve_pipeline [--device cuda|cpu] \\
        [--hbm-bytes B] [--flops-budget F]
"""

from __future__ import annotations

import argparse

import numpy as np

from .. import configs as C
from ..core.placement import to_stages
from ..core.profiles import lm_profile
from ..core.radio import TpuLinkModel
from ..device import resolve_device
from ..kernels.cost import PEAK_BF16
from ..models import init_params
from ..runtime import elastic
from ..runtime.serve import ServeConfig, Server, schedule_requests

H100_HBM_BYTES = 80e9
BATCH, PROMPT, STEPS, MAX_LEN = 4, 16, 8, 64


def config():
    """The served model: internlm2 reduced to 2 layers, d 64, vocab 512."""
    return C.get_config("internlm2_1p8b").reduced(n_layers=2, d_model=64, vocab=512)


def prompts(vocab: int) -> np.ndarray:
    """The example's (BATCH, PROMPT) int32 prompts, from numpy's seed 0."""
    return np.random.default_rng(0).integers(0, vocab, (BATCH, PROMPT)).astype(np.int32)


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="OULD-scheduled serving with real decode")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--hbm-bytes", type=float, default=H100_HBM_BYTES,
                    help="each group's memory, bytes")
    ap.add_argument("--flops-budget", type=float, default=PEAK_BF16,
                    help="each group's compute, FLOP/s")
    return ap


def main(argv: list[str] | None = None, params: dict | None = None) -> dict:
    """Run the example and print its lines.  ``params`` (the reduced
    model's, on ``--device``) replace its initialisation from seed 0 (the
    tests pass the reference's, converted).  Returns the placement's
    admitted count, comm latency and first three routes, the generated
    tokens, the straggler-aware nodes and the printed lines."""
    args = parser().parse_args(argv)
    dev = resolve_device(args.device)
    lines: list[str] = []

    def say(line: str) -> None:
        print(line, flush=True)
        lines.append(line)

    full = C.get_config("internlm2_1p8b")
    link = TpuLinkModel()
    coords = np.stack([np.arange(16) % 16, np.zeros(16, np.int64)], -1)
    rates = link.rate_matrix(coords, np.zeros(16, np.int64)) * 8.0

    sol, ev = schedule_requests(full, n_nodes=16, requests=6, hbm_bytes=args.hbm_bytes,
                                flops_budget=args.flops_budget, rates_bits=rates, seq=2048)
    say(f"OULD serving placement: admitted {ev.n_admitted}/6, "
        f"comm latency {ev.comm_latency_s * 1e6:.1f}us total")
    routes = []
    for r in range(3):
        if not sol.admitted[r]:
            routes.append(None)
            say(f"  request {r} rejected")
            continue
        routes.append([s.node for s in to_stages(sol.assign[r])])
        say(f"  request {r} route: [{'->'.join(str(n) for n in routes[-1])}]")

    # real batched generation on the reduced model
    cfg = config()
    if params is None:
        params = init_params(0, cfg, device=dev)
    server = Server(cfg, params, ServeConfig(max_len=MAX_LEN, batch_size=BATCH), device=dev)
    out = server.generate(prompts(cfg.vocab), steps=STEPS)
    say(f"generated tokens shape {out.shape}: {out[0].tolist()}")

    # straggler: group 5 runs 4x slow -> OULD routes around it
    prof = lm_profile(full.name, n_layers=full.n_layers, d_model=full.d_model,
                      n_heads=full.n_heads, n_kv=full.n_kv, d_ff=full.d_ff,
                      vocab=full.vocab, seq=2048)
    slow = np.ones(16)
    slow[5] = 4.0
    stages = elastic.replan_placement(prof, n_groups=16, hbm_bytes=args.hbm_bytes,
                                      flops_budget=args.flops_budget, slowdown=slow)
    nodes = [s.node for s in stages]
    say(f"straggler-aware stages (group 5 degraded): nodes={nodes}, "
        f"avoids_straggler={5 not in nodes}")
    say("serve_pipeline OK")
    return {"admitted": int(ev.n_admitted), "comm_latency_s": float(ev.comm_latency_s),
            "routes": routes, "tokens": out, "nodes": nodes, "lines": lines}


if __name__ == "__main__":
    main()
