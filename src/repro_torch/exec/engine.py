"""StageGraph executor: layer-range callables with per-stage and
per-transfer wall-clock accounting (port of ``repro/exec/engine.py``).

The engine runs a compiled :class:`~repro_torch.exec.stage_graph.StageGraph`
tick by tick in topological order, on one device (the card by default):

* each :class:`StageTask` executes as ONE ``apply_layers`` call over its
  layer range — requests sharing the stage are stacked into a batch, so a
  hotspot plan runs a handful of launches no matter how many requests ride
  them.  Callables are cached per ``(layer_start, layer_end)`` range.  The
  first run of a range at an input shape is a warm-up off the clock (cuDNN
  picks its algorithms and the caching allocator grows there), as the
  reference keeps its XLA compile off the clock;
* each boundary :class:`Transfer` is routed through the engine's
  :class:`~repro_torch.transport.Transport` backend.  The default
  ``InProcTransport`` adds the analytic link delay
  (``Problem.transfer_cost()`` — the exact coefficient OULD minimized) to
  the *measured* host serialization wall (synchronise and copy to host).
  The ``loopback`` / ``multiproc`` backends move the real activation bytes
  through worker OS processes and hand the consuming stage the
  reconstructed tensor, so the measured hop wall is a realized link sample
  (per-link bandwidth accumulates on the transport for comm calibration).

Walls are host clock readings between ``torch.cuda.synchronize()`` calls
(the reference's ``block_until_ready``).  ``executed latency`` of a request
= measured stage walls along its path + modeled link delays — the realized
counterpart of ``Evaluation.per_request_s``.

The reference's ``mesh`` batch-sharding has no meaning on one card; it waits
for the port's parallel slice (ROADMAP).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Sequence

import numpy as np
import torch

from ..core.profiles import ModelProfile
from ..device import resolve_device
from ..models import cnn
from ..obs import ENGINE, NULL_TRACER
from ..transport import InProcTransport, Transport
from .stage_graph import StageGraph, StageTask


@dataclasses.dataclass(frozen=True)
class StageTiming:
    """Measured execution of one batched stage launch."""

    node: int
    layer_start: int
    layer_end: int
    batch: int            # requests stacked into the launch
    wall_s: float         # measured wall (post-warm-up, synchronised)


@dataclasses.dataclass(frozen=True)
class TransferRecord:
    """One executed boundary shipment: modeled link delay + measured host
    serialization wall (device sync + copy of the activation buffer)."""

    request: int
    src_node: int
    dst_node: int
    layer: int
    nbytes: float
    delay_s: float        # modeled: nbytes × spb[src, dst]
    serialize_s: float    # measured: the transport hop wall (host copy
                          #   for inproc; serialize + socket round trip +
                          #   reconstruct + device copy for loopback/multiproc)


@dataclasses.dataclass(frozen=True)
class ExecutionReport:
    """What actually ran: outputs plus the measured/modeled decomposition."""

    outputs: dict[int, np.ndarray]          # request row → final activation
    stage_timings: tuple[StageTiming, ...]
    transfers: tuple[TransferRecord, ...]
    executed_s: np.ndarray                  # (R,) measured comp + modeled comm
    compute_s: np.ndarray                   # (R,) measured stage walls only
    comm_s: np.ndarray                      # (R,) modeled link delays only
    predicted_s: np.ndarray | None = None   # (R,) analytic, when supplied
    transport: str = "inproc"               # backend that carried transfers

    def stage_wall(self, layer_start: int, layer_end: int) -> float:
        """Min measured wall over launches of this layer range."""
        walls = [t.wall_s for t in self.stage_timings
                 if (t.layer_start, t.layer_end) == (layer_start, layer_end)]
        if not walls:
            raise KeyError(f"no launch executed layers "
                           f"[{layer_start}, {layer_end})")
        return min(walls)

    @property
    def abs_error_s(self) -> np.ndarray:
        """|predicted − executed| per admitted request (requires predicted)."""
        if self.predicted_s is None:
            raise ValueError("report carries no prediction")
        mask = np.isfinite(self.executed_s) & np.isfinite(self.predicted_s)
        return np.abs(np.where(mask, self.predicted_s - self.executed_s, 0.0))


def layer_fns_for(profile: ModelProfile, params: dict | None = None,
                  generator: torch.Generator | None = None,
                  device: str | torch.device = "cuda") -> list[Callable]:
    """Per-unit apply functions matching ``profile``'s placement units.

    Supports the paper's CNN workloads (``lenet`` / ``vgg16``); other
    profiles must hand the engine their own ``layer_fns``.  ``params`` (on
    ``device`` already) wins over ``generator`` (a fresh init on ``device``;
    a generator seeded 0 on ``device`` when neither is given).
    """
    dev = resolve_device(device)
    if profile.name not in ("lenet", "vgg16"):
        raise ValueError(
            f"no builtin layer fns for profile {profile.name!r}; "
            "pass layer_fns to ExecutionEngine directly")
    if params is None:
        gen = generator if generator is not None else torch.Generator(dev).manual_seed(0)
        init = cnn.lenet_init if profile.name == "lenet" else cnn.vgg16_init
        params = init(gen, device=dev)
    fns = (cnn.lenet_layers if profile.name == "lenet" else cnn.vgg16_layers)(params)
    if len(fns) != profile.num_layers:
        raise ValueError(f"{profile.name}: {len(fns)} units, profile has {profile.num_layers}")
    return fns


class ExecutionEngine:
    """Executes stage graphs over one model's ``layer_fns`` on ``device``.

    One engine instance owns the callable cache and the record of warmed
    ``(range, shape)`` pairs, so repeated runs (calibration re-measures) pay
    the warm-up once per unique range and shape.
    """

    def __init__(self, layer_fns: Sequence[Callable], *,
                 transport: Transport | None = None, tracer=None,
                 device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        self.layer_fns = list(layer_fns)
        self.transport = transport if transport is not None else InProcTransport()
        # Observability: engine spans are real-time (``tracer.now()``) and
        # reconstructed from the measured walls the engine takes anyway.
        # Transfer spans come from the transport itself.
        self.tracer = tracer if tracer is not None else NULL_TRACER
        if self.tracer.enabled:
            self.tracer.intern("stage", "batch", "n_layers")
            self.tracer.intern("stage_measure", "layer_start", "layer_end")
            self.tracer.intern("warm_start", "n_ranges")
            set_tr = getattr(self.transport, "set_tracer", None)
            if set_tr is not None:
                set_tr(self.tracer)
        self._closures: dict[tuple[int, int], Callable] = {}
        self._warm: set[tuple[int, int, tuple]] = set()

    # -- callable cache ------------------------------------------------------
    def closure(self, layer_start: int, layer_end: int) -> Callable:
        rng = (layer_start, layer_end)
        if rng not in self._closures:
            fns = self.layer_fns

            def _run(x, _s=layer_start, _e=layer_end):
                with torch.inference_mode():
                    return cnn.apply_layers(fns, x, _s, _e)

            self._closures[rng] = _run
        return self._closures[rng]

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _put(self, x) -> torch.Tensor:
        if isinstance(x, torch.Tensor):
            return x.to(self.device)
        return torch.from_numpy(np.ascontiguousarray(x)).to(self.device)

    def _timed(self, fn: Callable, x: torch.Tensor) -> tuple[torch.Tensor, float]:
        """One synchronised run of ``fn`` on ``x``: (output, wall seconds)."""
        self._sync()
        t0 = time.perf_counter()
        y = fn(x)
        self._sync()
        return y, time.perf_counter() - t0

    def _warm_up(self, layer_start: int, layer_end: int, x: torch.Tensor) -> None:
        key = (layer_start, layer_end, tuple(x.shape))
        if key not in self._warm:              # first run off the clock
            self.closure(layer_start, layer_end)(x)
            self._sync()
            self._warm.add(key)

    def measure_range(self, layer_start: int, layer_end: int, x, *,
                      repeats: int = 1) -> float:
        """Measured wall of layers [layer_start, layer_end) on ``x`` (min of
        ``repeats``, warm-up excluded)."""
        fn = self.closure(layer_start, layer_end)
        x = self._put(x)
        self._warm_up(layer_start, layer_end, x)
        best = min(self._timed(fn, x)[1] for _ in range(max(1, repeats)))
        if self.tracer.enabled:
            self.tracer.span(ENGINE, "stage_measure",
                             self.tracer.now() - best, best,
                             a0=layer_start, a1=layer_end)
        return best

    def warm_start(self, signature: Sequence[tuple[int, int]],
                   frame: np.ndarray) -> float:
        """Warm the callables of a stage signature (the ``(start, end)``
        ranges of :func:`~repro_torch.exec.stage_graph.stage_signature`) on
        one sample frame; returns the total wall.  Boundary activations are
        propagated through the signature itself; a range whose start no prior
        range produced is fed through a ``[0, start)`` prefix."""
        t_begin = time.perf_counter()
        acts: dict[int, torch.Tensor] = {0: self._put(frame[None])}
        for s, e in sorted(signature):
            if s not in acts:
                acts[s] = self.closure(0, s)(acts[0])
            acts[e] = self.closure(s, e)(acts[s])
            self._sync()
            self._warm.add((s, e, tuple(acts[s].shape)))
        wall = time.perf_counter() - t_begin
        if self.tracer.enabled:
            self.tracer.span(ENGINE, "warm_start",
                             self.tracer.now() - wall, wall,
                             a0=len(signature))
        return wall

    def _launch(self, task: StageTask, x: torch.Tensor) -> tuple[torch.Tensor, float]:
        """Run one batched stage; returns (output, measured wall seconds)."""
        self._warm_up(task.layer_start, task.layer_end, x)
        return self._timed(self.closure(task.layer_start, task.layer_end), x)

    # -- execution -----------------------------------------------------------
    def run(self, graph: StageGraph, frames: np.ndarray, *,
            predicted_s: np.ndarray | None = None) -> ExecutionReport:
        """Execute ``graph`` on ``frames`` (one leading row per plan request;
        rejected rows are never read).  Returns the full measured report."""
        acts: dict[int, torch.Tensor] = {r: self._put(frames[r][None])
                                         for r in graph.requests}
        timings: list[StageTiming] = []
        compute_s = np.zeros(graph.n_requests)

        transfer_by_consumer = {(tr.request, tr.layer): tr
                                for tr in graph.transfers}
        records: list[TransferRecord] = []

        for task in graph.tasks:
            # Boundary shipments INTO this stage ride the transport backend.
            for r in task.requests:
                tr = transfer_by_consumer.get((r, task.layer_start))
                if tr is None:
                    continue
                res = self.transport.ship(tr.src_node, tr.dst_node, acts[r])
                acts[r] = self._put(res.array)   # a no-op for a tensor on the device
                records.append(TransferRecord(
                    tr.request, tr.src_node, tr.dst_node, tr.layer,
                    tr.nbytes, tr.delay_s, res.wall_s))
            x = (acts[task.requests[0]] if len(task.requests) == 1
                 else torch.cat([acts[r] for r in task.requests]))
            y, wall = self._launch(task, x)
            timings.append(StageTiming(task.node, task.layer_start,
                                       task.layer_end, len(task.requests),
                                       wall))
            if self.tracer.enabled:
                # ts backdated by the measured wall so the span covers the
                # timed run, never the warm-up _launch keeps off the clock.
                self.tracer.span(ENGINE, "stage",
                                 self.tracer.now() - wall, wall,
                                 lane=task.node, a0=len(task.requests),
                                 a1=task.layer_end - task.layer_start)
            for b, r in enumerate(task.requests):
                acts[r] = y[b:b + 1]
                compute_s[r] += wall

        comm_s = np.zeros(graph.n_requests)
        for tr in graph.transfers:
            comm_s[tr.request] += tr.delay_s
        executed = np.full(graph.n_requests, np.inf)
        for r in graph.requests:
            executed[r] = compute_s[r] + comm_s[r]
        outputs = {r: acts[r][0].cpu().numpy() for r in graph.requests}
        return ExecutionReport(outputs, tuple(timings), tuple(records),
                               executed, compute_s, comm_s, predicted_s,
                               transport=self.transport.name)

    def sequential_reference(self, frames: np.ndarray,
                             requests: Sequence[int]) -> dict[int, np.ndarray]:
        """Ground truth: every admitted request through all layers, one node."""
        fn = self.closure(0, len(self.layer_fns))
        return {r: fn(self._put(frames[r][None]))[0].cpu().numpy() for r in requests}
