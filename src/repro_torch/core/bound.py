"""Convergence-bound evaluator (paper §IV, Theorem 1 + Corollaries).

The port's copy of the JAX package's `repro.core.bound`: numpy float64
on `repro_torch.core.topology`'s numpy geometry, the same operations in
the same order, so every curve equals the reference's bit for bit
(held by tests/test_torch_bound.py on the paper's Fig. 4 settings).

Reconstructed recursion (eq. 31 / Lemmas 1-3):
    D(t+1) <= X(t) D(t) + Y(t),      D(t) ~ E||theta_PS(t) - theta*||^2
    E[F(theta(T))] - F* <= (L/2) D(T)                        (Corollary 1)
with
    X(t) = 1 - mu eta(t) I (tau - eta(t)(tau-1))             (Lemma 2)
    Y(t) = [Lemma 1 channel/interference/noise total]
         + (1+mu(1-eta)) eta^2 I G^2 tau(tau-1)(2tau-1)/6
         + eta^2 I (tau^2+tau-1) G^2 + 2 eta I (tau-1) Gamma  (Lemma 2)

A(m1,m2,c1,c2) (referenced by Theorem 1, derived from the Lemma 6
moment calculus, worst case over cluster-iteration index pairs):
    r_i = beta_IS,ci * beta_{ci,mi,ci} / (beta_bar * beta_bar_ci)
    c1 != c2                : A = r1 r2 - r1 - r2 + 1
    c1 == c2, m1 != m2      : A = r1 r2 (1 + 1/K') - r1 - r2 + 1
    c1 == c2, m1 == m2      : A = r^2 (1 + 1/K')(1 + 1/K) - 2r + 1

The error-free baseline keeps only the Lemma-2 terms.  Conventional
(single-hop) OTA FL is evaluated as the degenerate topology C=1 with
all D=MC users in one cell at their MU->PS distances and a noiseless
relay hop (P_IS -> inf).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.core.topology import Topology


@dataclass(frozen=True)
class BoundParams:
    L: float = 10.0
    mu: float = 1.0
    G2: float = 1.0
    Gamma: float = 1.0
    two_n: int = 7850
    tau: int = 1
    I: int = 1
    init_dist: float = 1e3  # ||theta(0) - theta*||^2

    def eta(self, t):
        return max(5e-2 - 2e-5 * t, 1e-6)

    def P(self, t):
        return 1.0 + 1e-2 * t

    def P_is(self, t):
        return 10.0 * self.P(t)


def _lemma1_total(topo: Topology, bp: BoundParams, eta: float, P: float,
                  P_is: float, *, relay_noiseless: bool = False) -> float:
    """Numerically evaluate the Lemma 1 upper bound for general betas."""
    C, M, K, Kp = topo.C, topo.M, topo.K, topo.K_ps
    sh2, sz2 = topo.sigma_h2, topo.sigma_z2
    N = bp.two_n / 2.0
    G2, tau, I = bp.G2, bp.tau, bp.I
    b = np.asarray(topo.beta_mu_is, np.float64)       # [C', M, C]
    b_is = np.asarray(topo.beta_is, np.float64)       # [C]
    bbar_c = np.asarray(topo.beta_bar_c, np.float64)  # [C]
    bbar = float(b_is.sum())
    b_own = np.stack([b[c, :, c] for c in range(C)])  # [C, M]
    if relay_noiseless:
        P_is = 1e12

    # ---- T1: signal-coefficient deviation (Lemma 6) ----
    r = (b_is[:, None] * b_own) / (bbar * bbar_c[:, None])  # [C, M]
    A_sum = 0.0
    # c1 != c2 contributions: prod terms
    tot_r = r.sum()
    sum_r_per_c = r.sum(axis=1)  # [C]
    # sum over all pairs of r1*r2
    s_all = tot_r ** 2
    s_same_c = float((sum_r_per_c ** 2).sum())
    s_same_cm = float((r ** 2).sum())
    # base: r1r2 - r1 - r2 + 1 over all (c1,m1),(c2,m2): (MC)^2 terms
    n_pairs = (M * C) ** 2
    A_sum += s_all - 2.0 * (M * C) * tot_r + n_pairs
    # correction for c1==c2 pairs: extra r1r2/K'
    A_sum += s_same_c / Kp
    # correction for c1==c2, m1==m2: extra r^2 (1+1/K')(1/K) ≈ r^2((1+1/K')(1+1/K)-(1+1/K'))
    A_sum += s_same_cm * (1.0 + 1.0 / Kp) * (1.0 / K)
    T1 = (eta ** 2) * G2 * (I ** 2) * (tau ** 2) / (M ** 2 * C ** 2) * A_sum

    # ---- T2 (Lemma 10): IS->PS cross-IS interference of cluster signals ----
    if C > 1:
        coef = (2.0 + (M - 1) * (C - 2) * (K - 1) * (I - 1))
        s = 0.0
        for c in range(C):
            for cp in range(C):
                if cp == c:
                    continue
                s += (b_is[c] * b_is[cp]
                      * float(np.add.outer(b_own[cp], b_own[cp]).sum())
                      / bbar_c[cp] ** 2)
        T2 = (coef * (eta ** 2) * I * G2 * (tau ** 2)
              / (K * Kp * M ** 3 * C ** 2 * (C - 1) * bbar ** 2)) * s
    else:
        T2 = 0.0

    # ---- T3 (Lemmas 7+8): own-cluster MF leakage ----
    s3 = 0.0
    for c in range(C):
        for m in range(M):
            intra = b_own[c].sum() - b_own[c, m]
            inter = sum(b[c, :, cp].sum() for cp in range(C) if cp != c)
            s3 += ((Kp + 1) * b_is[c] ** 2 * b_own[c, m]
                   / bbar_c[c] ** 2) * (intra + inter)
    T3 = ((eta ** 2) * G2 * I * (tau ** 2)
          / (K * Kp * M ** 2 * C ** 2 * bbar ** 2)) * s3

    # ---- T4 (Lemmas 11+12): cross-IS x cross-user leakage ----
    s4 = 0.0
    for c in range(C):
        for cp in range(C):
            if cp == c:
                continue
            for m in range(M):
                intra = b_own[cp].sum() - b_own[cp, m]
                inter = sum(b[cp, :, cpp].sum() for cpp in range(C)
                            if cpp != cp)
                s4 += (b_is[c] * b_is[cp] * b_own[cp, m]
                       / bbar_c[cp] ** 2) * (intra + inter)
    T4 = ((eta ** 2) * G2 * I * (tau ** 2)
          / (K * Kp * M ** 2 * C ** 2 * bbar ** 2)) * s4

    # ---- T5 (Lemmas 9+13+14): thermal noise ----
    s5 = 0.0
    for c in range(C):
        inner = 1.0 / (P_is ** 2)
        acc = 0.0
        for m in range(M):
            acc += ((Kp + 1) * b_is[c] * b_own[c, m]
                    / (P ** 2 * bbar_c[c] ** 2))
            acc += sum(b_is[cp] * b_own[cp, m] / (P_is ** 2 * bbar_c[cp] ** 2)
                       for cp in range(C) if cp != c)
        inner += (I / (K * M ** 2)) * acc
        s5 += b_is[c] * inner
    T5 = (sz2 * N / (Kp * C ** 2 * sh2 * bbar ** 2)) * s5

    return T1 + T2 + T3 + T4 + T5


def _lemma2_consts(bp: BoundParams, eta: float) -> float:
    tau, I, G2, mu = bp.tau, bp.I, bp.G2, bp.mu
    return ((1 + mu * (1 - eta)) * eta ** 2 * I * G2
            * tau * (tau - 1) * (2 * tau - 1) / 6.0
            + eta ** 2 * I * (tau ** 2 + tau - 1) * G2
            + 2 * eta * I * (tau - 1) * bp.Gamma)


def theorem1_curve(topo: Topology, bp: BoundParams, T: int,
                   *, channel: str = "ota") -> np.ndarray:
    """Returns the loss-gap upper bound (L/2)*D(t) for t = 0..T.

    channel: "ota" (full Lemma 1) | "error-free" (Lemma 2 terms only).
    """
    D = bp.init_dist
    out = [bp.L / 2 * D]
    for t in range(T):
        eta = bp.eta(t)
        X = 1.0 - bp.mu * eta * bp.I * (bp.tau - eta * (bp.tau - 1))
        X = min(max(X, 0.0), 1.0)
        Y = _lemma2_consts(bp, eta)
        if channel == "ota":
            Y += _lemma1_total(topo, bp, eta, bp.P(t), bp.P_is(t))
        D = X * D + Y
        out.append(bp.L / 2 * D)
    return np.asarray(out)


def conventional_topology(topo: Topology) -> Topology:
    """Degenerate 1-cluster topology: all D=MC users in one cell at their
    MU->PS distances, IS==PS (noiseless relay handled by P_is->inf)."""
    import dataclasses
    D = topo.C * topo.M
    d = np.asarray(topo.d_mu_ps, np.float64).reshape(1, D, 1)
    return dataclasses.replace(
        topo, C=1, M=D, K=topo.K_ps,
        d_mu_is=d, d_is_ps=np.ones((1,)), d_mu_ps=d[:, :, 0])


def conventional_curve(topo: Topology, bp: BoundParams, T: int,
                       *, P_scale: float = 0.5) -> np.ndarray:
    """Single-hop OTA FL bound (paper's 'conventional FL' curve).

    `P_scale` implements the paper's §V edge-power-consistency protocol:
    "P_t,low = 0.5 P_t is used for the cases with I=1" — conventional FL
    transmits once per round on the long MU->PS link, so its edge power
    multiplier is halved to match the W-HFL runs' average edge power.
    """
    ct = conventional_topology(topo)
    import dataclasses
    bp1 = dataclasses.replace(bp, I=1)
    D = bp.init_dist
    out = [bp.L / 2 * D]
    for t in range(T):
        eta = bp.eta(t)
        X = 1.0 - bp.mu * eta * bp1.I * (bp.tau - eta * (bp.tau - 1))
        X = min(max(X, 0.0), 1.0)
        Y = _lemma2_consts(bp1, eta)
        Y += _lemma1_total(ct, bp1, eta, P_scale * bp.P(t), bp.P_is(t),
                           relay_noiseless=True)
        D = X * D + Y
        out.append(bp.L / 2 * D)
    return np.asarray(out)


def corollary2_Y(bp: BoundParams, topo: Topology, eta: float,
                 P: float) -> float:
    """Simplified symmetric-setting Y(t) (eq. 34, last line)."""
    return (2 * eta ** 2 * bp.G2
            + bp.two_n / 2 * topo.sigma_z2
            / (topo.K * topo.M ** 3 * topo.C ** 3 * topo.sigma_h2 * P ** 2))


def corollary2_curve(topo: Topology, bp: BoundParams, T: int,
                     eta: float) -> np.ndarray:
    """Constant-eta closed form (eq. 35)."""
    mu, L = bp.mu, bp.L
    out = []
    for t in range(T + 1):
        Y = corollary2_Y(bp, topo, eta, bp.P(t))
        val = (L / 2 * (1 - mu * eta) ** t * bp.init_dist
               + L / (2 * mu * eta) * Y * (1 - (1 - mu * eta) ** t))
        out.append(val)
    return np.asarray(out)
