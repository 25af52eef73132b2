"""Reference-Point-Group (RPG) mobility — paper §III-C, citing [40].

A group leader follows a round-trip path between an initial and a final
point chosen to cover the target area; member UAVs are randomly placed
around the leader's reference point and follow the group's motion trend
with a small liberty radius.  Positions are recorded every time step;
OULD-MP consumes the *predicted* positions for t ∈ {1..T} and the induced
rate matrices ρ(t).

Deterministic given a seed — prediction in this model is exact replay of
the planned trajectory (the paper assumes planned paths are inputs).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .radio import RadioParams, rate_matrix


@dataclasses.dataclass(frozen=True)
class RPGParams:
    n_uavs: int = 10
    area_m: float = 100.0          # square side (paper: 100 and 500)
    altitude_m: float = 50.0       # fixed H (paper §III-A)
    leader_speed_mps: float = 5.0
    member_radius_m: float = 25.0  # liberty radius around reference point
    member_jitter_mps: float = 1.0 # per-step deviation inside the group
    step_s: float = 1.0            # T time-step duration
    homogeneous: bool = False      # if True, relative distances frozen (Fig. 2a)


class RPGMobility:
    """Generates (T, N, 3) positions; supports homogeneous (Fig. 2a) and
    non-homogeneous (Fig. 2b) group motion."""

    def __init__(self, params: RPGParams, seed: int = 0):
        self.p = params
        rng = np.random.default_rng(seed)
        r = rng.uniform(0, params.member_radius_m, params.n_uavs)
        theta = rng.uniform(0, 2 * np.pi, params.n_uavs)
        self._offsets = np.stack([r * np.cos(theta), r * np.sin(theta)], -1)
        self._rng = rng
        # Leader round-trip: corner-to-corner sweep covering the area.
        self._start = np.array([params.member_radius_m, params.member_radius_m])
        self._end = np.array([params.area_m - params.member_radius_m,
                              params.area_m - params.member_radius_m])

    def _leader_at(self, t: float) -> np.ndarray:
        span = np.linalg.norm(self._end - self._start)
        period = 2.0 * span / self.p.leader_speed_mps
        phase = (t * self.p.step_s) % period
        frac = phase / period * 2.0
        if frac > 1.0:
            frac = 2.0 - frac  # return leg of the round trip
        return self._start + frac * (self._end - self._start)

    def positions(self, num_steps: int, seed: int | None = None) -> np.ndarray:
        """(T, N, 3) planned positions for t = 0..T-1."""
        rng = np.random.default_rng(seed) if seed is not None else self._rng
        out = np.zeros((num_steps, self.p.n_uavs, 3))
        offsets = self._offsets.copy()
        for t in range(num_steps):
            leader = self._leader_at(t)
            if not self.p.homogeneous:
                drift = rng.normal(0.0, self.p.member_jitter_mps * self.p.step_s,
                                   offsets.shape)
                offsets = offsets + drift
                # members stay within the group liberty radius
                norm = np.linalg.norm(offsets, axis=-1, keepdims=True)
                scale = np.minimum(1.0, self.p.member_radius_m / np.maximum(norm, 1e-9))
                offsets = offsets * scale
            out[t, :, :2] = leader + offsets
            out[t, :, 2] = self.p.altitude_m
        return out

    def predicted_rates(self, num_steps: int, radio: RadioParams | None = None,
                        seed: int | None = None) -> np.ndarray:
        """(T, N, N) ρ_{i,k}(t) for OULD-MP (Eq. 14) — bits/s."""
        pos = self.positions(num_steps, seed=seed)
        return np.stack([rate_matrix(pos[t], radio) for t in range(pos.shape[0])])


class MultiGroupMobility:
    """Several RPG groups sweeping the area on independent leader paths.

    The single-group model keeps every pair within twice the liberty radius,
    so links never cross ``max_range`` and mobility alone cannot disconnect
    them.  Real surveillance swarms (§III-C, citing [40]) fly as *multiple*
    reference-point groups; inter-group distances then swing across the whole
    area and links predictably fade in and out of range — exactly the
    disconnection dynamics OULD-MP's horizon objective prices out (Fig. 13).

    Groups share the planned-trajectory determinism of :class:`RPGMobility`;
    group g's leader sweep is phase-shifted and direction-alternated so
    groups periodically converge (cheap cross-group offload) and diverge
    (links beyond ``max_range`` ⇒ ρ = 0).
    """

    def __init__(self, params: RPGParams, n_groups: int = 2, seed: int = 0):
        if params.n_uavs % n_groups:
            raise ValueError(f"{params.n_uavs} UAVs not divisible into "
                             f"{n_groups} groups")
        self.p = params
        self.n_groups = n_groups
        per = params.n_uavs // n_groups
        self.group_of = np.repeat(np.arange(n_groups), per)
        self._groups = []
        for g in range(n_groups):
            gp = dataclasses.replace(params, n_uavs=per)
            self._groups.append(RPGMobility(gp, seed=seed * 7919 + g))
        # Opposite-corner sweeps: even groups run SW→NE, odd groups NW→SE,
        # so group pairs meet mid-area and separate toward opposite corners.
        for g, mob in enumerate(self._groups):
            lo = params.member_radius_m
            hi = params.area_m - params.member_radius_m
            if g % 2 == 1:
                mob._start = np.array([lo, hi])
                mob._end = np.array([hi, lo])

    @property
    def n_uavs(self) -> int:
        return self.p.n_uavs

    def positions(self, num_steps: int, seed: int | None = None,
                  t0: int = 0) -> np.ndarray:
        """(T, N, 3) planned positions for t = t0..t0+T-1.  ``t0`` lets the
        simulator window the one planned trajectory instead of replaying from
        mission start each epoch."""
        out = np.zeros((num_steps, self.p.n_uavs, 3))
        per = self.p.n_uavs // self.n_groups
        for g, mob in enumerate(self._groups):
            gseed = (seed * 104729 + g) if seed is not None else None
            # Window the group's trajectory: generate t0+T steps then slice —
            # keeps the jittered member offsets deterministic in t0.
            pos = mob.positions(t0 + num_steps, seed=gseed)
            out[:, g * per:(g + 1) * per] = pos[t0:]
        return out

    def predicted_rates(self, num_steps: int, radio: RadioParams | None = None,
                        seed: int | None = None, t0: int = 0) -> np.ndarray:
        """(T, N, N) ρ_{i,k}(t) — inter-group pairs hit ρ = 0 when their
        groups separate beyond ``max_range`` (the OULD-MP scenario class)."""
        pos = self.positions(num_steps, seed=seed, t0=t0)
        return np.stack([rate_matrix(pos[t], radio) for t in range(pos.shape[0])])
