"""Air-to-air link model — paper Eq. (1) and §III-C link-quality semantics.

``ρ_{i,k} = B_i · log2(1 + Γ_{i,k})`` where Γ is the average SINR of the U2U
link.  Received power follows the path-loss law ``P_rx ∝ P_tx · d^{-α}``
(§III-C); interference sums the received power of concurrent transmitters
(the paper's latency curves attribute the density penalty to exactly this
term, citing [38]).  Disconnection: beyond ``max_range`` the SINR is treated
as 0 so ρ = B·log2(1) = 0, verbatim the paper's limit argument.

The same ``RateModel`` protocol also has a TPU instantiation
(:class:`TpuLinkModel`) used when OULD drives pipeline placement on a pod —
contention-free per-direction links, rate = per-link ICI/DCN bandwidth divided
by hop distance on the torus.  See DESIGN.md §2 for the mapping.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class RadioParams:
    bandwidth_hz: float = 20e6       # B_i = 20 MHz (paper §IV)
    tx_power_w: float = 0.1          # typical UAV Wi-Fi class transmitter
    noise_w: float = 1e-13           # thermal noise floor over 20 MHz
    path_loss_exp: float = 2.7       # α, LoS air-to-air (between 2 and 3)
    ref_gain: float = 1e-4           # channel gain at 1 m
    max_range_m: float = 300.0       # beyond this, link disconnected (ρ = 0)
    interference_frac: float = 0.1   # duty-cycle share of concurrent tx heard


def received_power(d: np.ndarray, p: RadioParams) -> np.ndarray:
    """P_rx ∝ d^{-α} with a reference gain; clamped below 1 m."""
    d = np.maximum(d, 1.0)
    return p.tx_power_w * p.ref_gain * d ** (-p.path_loss_exp)


def sinr_matrix(positions: np.ndarray, p: RadioParams) -> np.ndarray:
    """Γ_{i,k} for all pairs.

    positions: (N, 3) UAV coordinates.  Interference at receiver k sums the
    received power of all nodes other than {i, k}, scaled by the duty-cycle
    fraction (concurrent transmitters), matching the density penalty the
    paper observes for N=15 swarms.
    """
    n = positions.shape[0]
    diff = positions[:, None, :] - positions[None, :, :]
    dist = np.linalg.norm(diff, axis=-1)
    prx = received_power(dist, p)  # prx[i, k]: power of i heard at k
    np.fill_diagonal(prx, 0.0)
    total_at_k = prx.sum(axis=0)  # (N,) all power arriving at k
    sinr = np.zeros((n, n))
    for i in range(n):
        interference = (total_at_k - prx[i]) * p.interference_frac
        sinr[i] = prx[i] / (p.noise_w + interference)
    np.fill_diagonal(sinr, 0.0)
    sinr[dist > p.max_range_m] = 0.0
    return sinr


def rate_matrix(positions: np.ndarray, p: RadioParams | None = None) -> np.ndarray:
    """ρ_{i,k} = B·log2(1 + Γ_{i,k}) in bits/s — paper Eq. (1)."""
    p = p or RadioParams()
    gamma = sinr_matrix(positions, p)
    rho = p.bandwidth_hz * np.log2(1.0 + gamma)
    np.fill_diagonal(rho, np.inf)  # self-transfer is free (same node)
    return rho


# ---------------------------------------------------------------------------
# TPU instantiation of the same link abstraction (DESIGN.md §2)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TpuLinkModel:
    """Hop-count rate model on a 2D ICI torus with a slower pod-to-pod DCN."""

    ici_bytes_per_s: float = 50e9    # per link per direction (spec constant)
    dcn_bytes_per_s: float = 12.5e9  # inter-pod
    torus: tuple[int, int] = (16, 16)

    def rate_matrix(self, coords: np.ndarray, pods: np.ndarray) -> np.ndarray:
        """coords: (N, 2) torus coordinates; pods: (N,) pod index.

        Rate in *bytes/s*: ICI bandwidth divided by torus hop distance when in
        the same pod, DCN bandwidth across pods.  No interference term —
        point-to-point ICI links are contention-free per direction.
        """
        tx, ty = self.torus
        dx = np.abs(coords[:, None, 0] - coords[None, :, 0])
        dy = np.abs(coords[:, None, 1] - coords[None, :, 1])
        hops = np.minimum(dx, tx - dx) + np.minimum(dy, ty - dy)
        hops = np.maximum(hops, 1)
        rho = self.ici_bytes_per_s / hops
        cross = pods[:, None] != pods[None, :]
        rho = np.where(cross, self.dcn_bytes_per_s, rho)
        np.fill_diagonal(rho, np.inf)
        return rho
