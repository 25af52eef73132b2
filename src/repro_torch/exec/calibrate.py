"""Measured-latency profile calibration — closing the predicted ↔ realized
loop (DESIGN.md §5).

The analytic profiles (:mod:`repro_torch.core.profiles`) predict a layer's compute
time as ``c_j / speed_i`` from FLOP counts; DroNet-style measurements show
realized kernel time is dominated by effects the FLOP model cannot see
(cache behavior, im2col overheads, BLAS efficiency).  This module turns an
:class:`~repro_torch.exec.engine.ExecutionReport` back into profile updates:

* :func:`measured_layer_seconds` — distribute each measured stage wall over
  its layers proportionally to the analytic compute vector (min over
  launches for noise robustness), yielding a per-layer measured time;
* :func:`calibrate_profile` — a new :class:`ModelProfile` whose compute
  vector reproduces the measured times at the nominal ``speed`` (so
  ``c_j' / speed == measured_j``): every registered planner consumes it
  unchanged, and Eq. 5 occupancy stays in consistent units;
* :func:`reconcile` — the analytic-vs-measured gap, per layer and per link
  (modeled delay vs the measured transport hop), plus the per-request MAE
  that the acceptance gate tracks across a calibrated re-solve;
* :func:`calibrate_rates` / the ``transport=`` arm of
  :func:`calibrated_problem` — the comm-side twin: a byte-moving transport
  backend (:mod:`repro_torch.transport`) accumulates realized seconds/byte per
  directed link; sampled links replace the analytic rates, the problem's
  ``comm_source`` provenance records which transport priced them, and any
  registry planner re-solves on realized comm exactly as it re-solves on
  realized compute.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..core.ould import Problem
from ..core.profiles import ModelProfile
from .engine import ExecutionReport


@dataclasses.dataclass(frozen=True)
class CalibrationReport:
    """Analytic-vs-measured reconciliation for one executed plan."""

    layer_predicted_s: np.ndarray    # (M,) c_j / nominal speed
    layer_measured_s: np.ndarray     # (M,) from stage walls (predicted where
                                     #      no launch covered the layer)
    layer_covered: np.ndarray        # (M,) bool — measured by some launch
    link_modeled_s: dict             # (src, dst) → mean modeled delay
    link_serialize_s: dict           # (src, dst) → mean measured hop wall
    request_mae_s: float             # MAE(predicted, executed) per request
    profile: ModelProfile            # calibrated profile (compute updated)
    speed_scale: float               # nominal time / measured time (>1 ⇒
                                     #   hardware beats the FLOP model)
    # Comm-side twin (populated when a transport carried the transfers).
    link_measured_spb: dict = dataclasses.field(default_factory=dict)
                                     # (src, dst) → realized seconds/byte
    comm_mae_s: float = 0.0          # mean |modeled delay − realized hop|
                                     #   over executed transfers
    transport: str = "inproc"        # backend that produced the samples

    @property
    def layer_abs_gap_s(self) -> np.ndarray:
        return np.abs(self.layer_predicted_s - self.layer_measured_s)

    @property
    def link_abs_gap_s(self) -> dict:
        """Per directed link: |mean modeled delay − mean realized hop|."""
        return {k: abs(self.link_modeled_s[k] - self.link_serialize_s[k])
                for k in self.link_modeled_s if k in self.link_serialize_s}

    @property
    def mean_layer_gap_s(self) -> float:
        cov = self.layer_covered
        return float(self.layer_abs_gap_s[cov].mean()) if cov.any() else 0.0

    def summary(self) -> str:
        n_cov = int(self.layer_covered.sum())
        comm = ""
        if self.link_measured_spb:
            comm = (f", comm[{self.transport}]: "
                    f"{len(self.link_measured_spb)} links sampled, "
                    f"MAE={self.comm_mae_s * 1e3:.3f}ms")
        return (f"calibration: {n_cov}/{self.layer_covered.size} layers "
                f"measured, mean |gap|={self.mean_layer_gap_s * 1e3:.3f}ms, "
                f"request MAE={self.request_mae_s * 1e3:.3f}ms, "
                f"speed_scale={self.speed_scale:.3g}" + comm)


def measured_layer_seconds(report: ExecutionReport,
                           profile: ModelProfile) -> tuple[np.ndarray, np.ndarray]:
    """(M,) per-layer measured seconds + (M,) coverage mask.

    A stage launch measures the wall of its whole layer range on its whole
    batch; the per-layer estimate divides by the batch (these kernels scale
    ~linearly in batch on the target class of devices) and splits the range
    proportionally to the analytic compute vector — the standard profile-
    directed disaggregation.  Min over launches covering a layer.
    """
    comp = np.asarray(profile.compute_vector(), float)
    M = profile.num_layers
    measured = np.full(M, np.inf)
    for t in report.stage_timings:
        rng = slice(t.layer_start, t.layer_end)
        weights = comp[rng]
        total = weights.sum()
        share = (weights / total if total > 0
                 else np.full(t.layer_end - t.layer_start,
                              1.0 / (t.layer_end - t.layer_start)))
        per_item = t.wall_s / max(t.batch, 1)
        est = per_item * share
        measured[rng] = np.minimum(measured[rng], est)
    covered = np.isfinite(measured)
    measured = np.where(covered, measured, 0.0)
    return measured, covered


def calibrate_profile(profile: ModelProfile, layer_s: np.ndarray, *,
                      speed: float,
                      covered: np.ndarray | None = None) -> ModelProfile:
    """Profile whose compute vector realizes ``layer_s`` at ``speed``
    (uncovered layers keep their analytic FLOPs)."""
    layers = []
    for j, ly in enumerate(profile.layers):
        if covered is not None and not covered[j]:
            layers.append(ly)
            continue
        layers.append(dataclasses.replace(
            ly, compute_flops=float(layer_s[j] * speed)))
    return ModelProfile(profile.name, tuple(layers), profile.input_bytes)


def calibrate_rates(problem: Problem, link_spb: dict, *,
                    source: str = "measured") -> Problem:
    """Substitute realized per-link bandwidth into the instance's rates.

    ``link_spb`` maps ``(src, dst)`` to realized seconds/byte (a
    transport's :meth:`link_seconds_per_byte`).  Sampled links get the rate
    whose priced :meth:`~repro_torch.core.ould.Problem.transfer_cost` reproduces
    the measurement exactly (horizon stacks spread it evenly over steps,
    since pricing sums them); unsampled links keep their analytic rates.
    ``comm_source`` records the provenance — it rides into ``Plan.problem``
    on the re-solve.
    """
    rates = np.array(problem.rates, float, copy=True)
    unit = (1.0 / problem.rate_unit_bytes) * problem.horizon()
    for (s, d), spb in link_spb.items():
        if s == d or not np.isfinite(spb) or spb <= 0:
            continue
        if s < rates.shape[-2] and d < rates.shape[-1]:
            rates[..., s, d] = unit / spb
    return dataclasses.replace(problem, rates=rates, comm_source=source)


def calibrated_problem(problem: Problem, report: ExecutionReport, *,
                       transport=None) -> tuple[Problem, "CalibrationReport"]:
    """The same instance with the profile calibrated from ``report`` —
    hand it straight back to any registered planner for the measured-cost
    re-solve.  Also returns the reconciliation.

    With ``transport`` (the backend that carried the report's transfers),
    the comm side calibrates too: every link the transport sampled gets its
    realized bandwidth substituted via :func:`calibrate_rates`, so the
    re-solve prices both compute AND comm on measured numbers."""
    recon = reconcile(problem, report, transport=transport)
    out = dataclasses.replace(problem, profile=recon.profile)
    if transport is not None and recon.link_measured_spb:
        out = calibrate_rates(out, recon.link_measured_spb,
                              source=f"measured:{recon.transport}")
    return out, recon


def _nominal_speed(problem: Problem) -> float:
    speed = problem.compute_speed
    if speed is None:
        return float("inf")
    finite = np.asarray(speed, float)
    finite = finite[np.isfinite(finite) & (finite > 0)]
    return float(finite.mean()) if finite.size else float("inf")


def reconcile(problem: Problem, report: ExecutionReport, *,
              transport=None) -> CalibrationReport:
    """Quantify the analytic-vs-measured gap per layer and per link, and
    build the calibrated profile.  ``transport`` adds the comm-side twin:
    realized per-link seconds/byte and the modeled-vs-realized comm MAE."""
    profile = problem.profile
    speed = _nominal_speed(problem)
    comp = np.asarray(profile.compute_vector(), float)
    predicted = comp / speed if np.isfinite(speed) else np.zeros_like(comp)

    measured, covered = measured_layer_seconds(report, profile)
    cal_speed = speed if np.isfinite(speed) else 1e9
    cal_profile = calibrate_profile(profile, measured, speed=cal_speed,
                                    covered=covered)

    link_modeled: dict[tuple[int, int], list[float]] = {}
    link_serial: dict[tuple[int, int], list[float]] = {}
    for tr in report.transfers:
        key = (tr.src_node, tr.dst_node)
        link_modeled.setdefault(key, []).append(tr.delay_s)
        link_serial.setdefault(key, []).append(tr.serialize_s)

    if report.predicted_s is not None:
        mae = float(report.abs_error_s[list(report.outputs)].mean()) \
            if report.outputs else 0.0
    else:
        mask = np.isfinite(report.executed_s)
        pred = (predicted.sum() + report.comm_s)
        mae = float(np.abs(pred[mask] - report.executed_s[mask]).mean()) \
            if mask.any() else 0.0

    pred_cov = predicted[covered].sum()
    meas_cov = measured[covered].sum()
    scale = float(pred_cov / meas_cov) if meas_cov > 0 and pred_cov > 0 else 1.0

    link_spb: dict[tuple[int, int], float] = {}
    comm_mae = 0.0
    tname = report.transport
    if transport is not None:
        link_spb = transport.link_seconds_per_byte()
        tname = transport.name
    if report.transfers:
        comm_mae = float(np.mean([abs(tr.delay_s - tr.serialize_s)
                                  for tr in report.transfers]))
    return CalibrationReport(
        predicted, measured, covered,
        {k: float(np.mean(v)) for k, v in link_modeled.items()},
        {k: float(np.mean(v)) for k, v in link_serial.items()},
        mae, cal_profile, scale,
        link_measured_spb=link_spb, comm_mae_s=comm_mae, transport=tname)
