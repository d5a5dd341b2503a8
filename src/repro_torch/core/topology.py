"""W-HFL network topology (paper §II, §V).

C clusters, each with one intermediate server (IS) and M mobile users
(MUs); one parameter server (PS).  Large-scale fading is distance-based,
`beta = d^{-p}` (p = path-loss exponent, paper uses p=4).

Geometry per the paper's experiments: clusters are placed uniformly at a
normalized distance in [0.5, 3] from the PS; MUs uniformly in an annulus
[0.5, 1] around their IS.
"""
from __future__ import annotations

from dataclasses import dataclass
import numpy as np


@dataclass(frozen=True)
class Topology:
    C: int                      # clusters
    M: int                      # users per cluster
    K: int                      # IS receive antennas
    K_ps: int                   # PS receive antennas
    p: float                    # path-loss exponent
    sigma_h2: float             # small-scale fading variance
    sigma_z2: float             # AWGN variance
    # distances (numpy, static — geometry is not traced)
    d_mu_is: np.ndarray         # [C, M, C]: MU (c',m) -> IS c
    d_is_ps: np.ndarray         # [C]: IS c -> PS
    d_mu_ps: np.ndarray         # [C, M]: MU -> PS (conventional FL)

    # --- derived large-scale fading coefficients ---
    @property
    def beta_mu_is(self) -> np.ndarray:  # [C, M, C]
        return self.d_mu_is ** (-self.p)

    @property
    def beta_is(self) -> np.ndarray:  # [C]
        return self.d_is_ps ** (-self.p)

    @property
    def beta_mu_ps(self) -> np.ndarray:  # [C, M]
        return self.d_mu_ps ** (-self.p)

    @property
    def beta_own(self) -> np.ndarray:  # [C, M]: beta_{c,m,c}
        """Own-cluster large-scale fading grid (MU (c, m) -> its own IS
        c) — the receive weights of the cluster matched filter, and the
        weights the COTAF attendance rescale renormalizes over
        (`repro.core.aggregation.attendance_rescale`)."""
        b = self.beta_mu_is
        return np.stack([b[c, :, c] for c in range(self.C)])

    @property
    def beta_bar_c(self) -> np.ndarray:  # [C]: sum_m beta_{c,m,c}
        return self.beta_own.sum(axis=1)

    @property
    def beta_bar(self) -> float:  # sum_c beta_IS,c
        return float(self.beta_is.sum())


def random_topology(
    seed: int,
    C: int = 4,
    M: int = 5,
    K: int = 100,
    K_ps: int = 100,
    p: float = 4.0,
    sigma_h2: float = 1.0,
    sigma_z2: float = 10.0,
    r_mu=(0.5, 1.0),
    r_cluster=(0.5, 3.0),
) -> Topology:
    """Paper §V geometry: random placements, full distance matrix."""
    rng = np.random.default_rng(seed)
    # PS at origin; cluster (IS) positions
    ang_c = rng.uniform(0, 2 * np.pi, C)
    rad_c = rng.uniform(*r_cluster, C)
    is_xy = np.stack([rad_c * np.cos(ang_c), rad_c * np.sin(ang_c)], -1)  # [C,2]
    # MU positions around their IS
    ang_m = rng.uniform(0, 2 * np.pi, (C, M))
    rad_m = rng.uniform(*r_mu, (C, M))
    mu_xy = is_xy[:, None, :] + np.stack(
        [rad_m * np.cos(ang_m), rad_m * np.sin(ang_m)], -1)  # [C,M,2]

    d_mu_is = np.linalg.norm(
        mu_xy[:, :, None, :] - is_xy[None, None, :, :], axis=-1)  # [C,M,C]
    d_is_ps = np.linalg.norm(is_xy, axis=-1)                      # [C]
    d_mu_ps = np.linalg.norm(mu_xy, axis=-1)                      # [C,M]
    # avoid degenerate zero distances
    d_mu_is = np.maximum(d_mu_is, 1e-3)
    return Topology(C=C, M=M, K=K, K_ps=K_ps, p=p, sigma_h2=sigma_h2,
                    sigma_z2=sigma_z2, d_mu_is=d_mu_is, d_is_ps=d_is_ps,
                    d_mu_ps=d_mu_ps)


def uniform_topology(
    C: int = 4,
    M: int = 5,
    K: int = 100,
    K_ps: int = 100,
    p: float = 4.0,
    sigma_h2: float = 1.0,
    sigma_z2: float = 10.0,
    d_mu: float = 0.75,
    d_cluster: float = 1.75,
    d_cross: float = 2.5,
) -> Topology:
    """Symmetric topology (Corollary 2 setting): all intra-cluster MU-IS
    distances equal, all IS-PS distances equal; cross-cluster distances
    equal.  Useful for validating against the closed-form bound."""
    d_mu_is = np.full((C, M, C), d_cross)
    for c in range(C):
        d_mu_is[c, :, c] = d_mu
    d_is_ps = np.full((C,), d_cluster)
    d_mu_ps = np.full((C, M), d_cluster)
    return Topology(C=C, M=M, K=K, K_ps=K_ps, p=p, sigma_h2=sigma_h2,
                    sigma_z2=sigma_z2, d_mu_is=d_mu_is, d_is_ps=d_is_ps,
                    d_mu_ps=d_mu_ps)


def power_schedule(t, base: float = 1.0, slope: float = 1e-2,
                   is_factor: float = 20.0, low: bool = False):
    """Paper §V: P_t = 1 + 1e-2 t, P_IS,t = 20 P_t; P_t,low = 0.5 P_t for
    the I=1 runs (consistent average power).

    `t` may be a scalar round index or a ``[T]`` array of indices — one
    implementation evaluates both, elementwise in float64, so the
    vectorized schedule consumed by the chunked round driver is
    bit-identical to the scalar per-round values the stepwise driver
    computes (including after the float32 cast at the jit boundary).
    Scalars return Python floats (as before); arrays return float64
    numpy arrays.
    """
    t = np.asarray(t, np.float64)
    P = base + slope * t
    if low:
        P = 0.5 * P
    P_is = is_factor * P
    if t.ndim == 0:
        return float(P), float(P_is)
    return P, P_is
