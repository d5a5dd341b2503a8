"""W-HFL's two OTA hops over the moment-matched "equivalent" channel (or
the error-free "ideal" one), for the LM training step (the port of
`repro.core.dist`).

The JAX package runs these functions inside `shard_map`, one program
per (pod, cluster, user) mesh coordinate: each program holds one user's
delta, the cluster hop is a ``psum('user')`` and the global hop a
``psum(('pod', 'cluster'))``.  The port runs every user on one card, so
it takes all users' deltas at once, as a tree whose leaves carry a
leading [C, M] axis (cluster, user; C counts every pod's clusters, in
(pod, cluster) order):

- ``psum('user')`` is a sum over a cluster's M users, and the cluster
  hop returns each cluster's estimate, leaves [C, ...];
- ``psum(('pod', 'cluster'))`` is a sum over the C clusters, and the
  global hop returns the PS's estimate, leaves [...].

Every draw uses the key JAX uses at that coordinate: a user's gain
jitter `fold_in(key, user_id)`, a cluster's noise `fold_in(key,
1_000_003 + c)`, a cluster's global jitter `fold_in(key, 2_000_003 +
c)`, the PS's noise `fold_in(key, 3_000_017)`, each split over the tree's
leaves in `jax.tree` order (`repro_torch.tree`, sorted keys) and drawn
through the `jax.random` emulation (`nn.core._normal`, a slice of
`nn.core.DRAW_SLICE` elements at a time past that size; `draw_normal`).
Noise that JAX draws identically on every member
of a receiver group (a cluster's, the PS's) is drawn once here.

Real/complex bookkeeping as in the reference: a CN(0, V) perturbation
per complex entry is V/2 per real component of the (real) delta trees.
The hops work leaf by leaf, so their working memory is the deltas and
a leaf's draws.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch import prng
from repro_torch.core.topology import Topology
from repro_torch.nn.core import _normal
from repro_torch.tree import tree_from_paths, tree_leaves


@dataclass(frozen=True)
class DistGeom:
    """Per-user large-scale fading for the mesh-mapped W-HFL deployment.

    C total clusters (= n_pods * clusters_per_pod), M users each.
    """
    C: int
    M: int
    K: int                  # IS rx antennas
    K_ps: int               # PS rx antennas
    sigma_h2: float
    sigma_z2: float
    beta_own: np.ndarray    # [C, M]  MU -> own IS
    beta_cross: np.ndarray  # [C]     sum over other-cluster MU -> this IS
    beta_is: np.ndarray     # [C]     IS -> PS

    @property
    def beta_bar_c(self) -> np.ndarray:  # [C]
        return self.beta_own.sum(axis=1)

    @property
    def beta_bar(self) -> float:
        return float(self.beta_is.sum())


def geom_from_topology(topo: Topology, n_pods: int = 1) -> DistGeom:
    """Tile a (C, M) radio topology across pods (each pod hosts an
    independent copy of the cluster geometry; the PS hop spans pods)."""
    b = np.asarray(topo.beta_mu_is, np.float64)
    b_own = np.stack([b[c, :, c] for c in range(topo.C)])
    b_cross = np.stack([
        sum(b[cp, :, c].sum() for cp in range(topo.C) if cp != c)
        for c in range(topo.C)])
    return DistGeom(
        C=topo.C * n_pods, M=topo.M, K=topo.K, K_ps=topo.K_ps,
        sigma_h2=topo.sigma_h2, sigma_z2=topo.sigma_z2,
        beta_own=np.tile(b_own, (n_pods, 1)),
        beta_cross=np.tile(b_cross, n_pods),
        beta_is=np.tile(np.asarray(topo.beta_is, np.float64), n_pods),
    )


def uniform_geom(C: int, M: int, K: int = 64, K_ps: int = 64,
                 sigma_h2: float = 1.0, sigma_z2: float = 1.0,
                 d_mu: float = 0.75, d_is: float = 1.75, d_cross: float = 2.5,
                 p: float = 4.0) -> DistGeom:
    return DistGeom(
        C=C, M=M, K=K, K_ps=K_ps, sigma_h2=sigma_h2, sigma_z2=sigma_z2,
        beta_own=np.full((C, M), d_mu ** (-p)),
        beta_cross=np.full((C,), (C - 1) * M * d_cross ** (-p)),
        beta_is=np.full((C,), d_is ** (-p)),
    )


@dataclass(frozen=True)
class OTADistConfig:
    mode: str = "equivalent"      # "equivalent" | "ideal"
    interference: bool = True
    # per-element: the Lemma 7/9 per-entry interference variance; scalar:
    # the power-matched homogenized approximation (one scalar per hop)
    per_element_interference: bool = True
    fused: bool = False           # fold both hops into one (beyond-paper)
    # the fused train step only: per-element mean-square of a typical user
    # delta, for the interference variance.  None -> thermal noise only.
    tx_power_proxy: Optional[float] = None


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def _f32(x, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x, np.float32), device=device)


def draw_normal(key: torch.Tensor, shape) -> torch.Tensor:
    """float32 `jax.random.normal(key, shape)`, sliced past
    `nn.core.DRAW_SLICE` elements (the same bits).  A trace names the
    call's host ops by the range ``dist.draw_normal``, so the device time
    of the kernels they launch can be read from it."""
    with torch.profiler.record_function("dist.draw_normal"):
        return _normal(key, tuple(shape), 1.0, torch.float32)


def _sqsum(x: torch.Tensor) -> torch.Tensor:
    return torch.sum(torch.square(x.float()))


def _size(leaves: List[Tuple[tuple, torch.Tensor]], lead: int) -> int:
    """Elements of one member's tree (the leaves less `lead` axes)."""
    return sum(math.prod(t.shape[lead:]) for _, t in leaves)


def _rebuild(paths, tensors):
    return tree_from_paths(zip(paths, tensors))


def user_id(c: int, m: int, M: int) -> int:
    """The reference's global user index of user m of cluster c (c the
    global, pod-major cluster index)."""
    return c * M + m


# ---------------------------------------------------------------------------
# the two OTA hops
# ---------------------------------------------------------------------------

def cluster_hop(deltas, geom: DistGeom, key: torch.Tensor, P_t,
                cfg: OTADistConfig):
    """MU -> IS OTA aggregation (eq. 8-13, equivalent channel).

    `deltas`: every user's model delta, leaves [C, M, ...] (float32).
    Returns each cluster's estimate, leaves [C, ...]: the reference's
    `cluster_hop` output on cluster c's members."""
    leaves = list(tree_leaves(deltas))
    paths = [p for p, _ in leaves]
    C, M = geom.C, geom.M
    dev = leaves[0][1].device
    if cfg.mode == "ideal":
        return _rebuild(paths, [sum(t[:, m] / M for m in range(M))
                                for _, t in leaves])

    beta_own = _f32(geom.beta_own, dev)                      # [C, M]
    bb_all = _f32(geom.beta_bar_c, dev)                      # [C]
    bc_all = _f32(geom.beta_cross, dev)
    n_el = float(max(_size(leaves, 2), 1))
    inv_root_k = _f32(1.0 / np.sqrt(geom.K), dev)
    # the reference's `_noise_like` keys: split(key, n_leaves)
    eps_keys = [[prng.split(prng.fold_in(key, user_id(c, m, M)),
                            len(leaves)) for m in range(M)] for c in range(C)]
    out = [torch.empty(t.shape[:1] + t.shape[2:], dtype=t.dtype, device=dev)
           for _, t in leaves]
    for c in range(C):
        b_m = beta_own[c]                                    # [M]
        bb_c = bb_all[c]
        w = b_m / bb_c
        v_base = (geom.sigma_z2 / (geom.K * (P_t ** 2) * geom.sigma_h2
                                   * bb_c) / 2.0)
        if cfg.interference:
            pw_own = sum(sum(_sqsum(t[c, m]) for _, t in leaves) / M
                         for m in range(M))
            v_base = v_base + (bc_all[c] * pw_own / n_el
                               / (geom.K * bb_c ** 2)) / 2.0
            wi = b_m * (bb_c - b_m) / (geom.K * bb_c ** 2)   # [M]
            if not cfg.per_element_interference:
                pw = sum(wi[m] * sum(_sqsum(t[c, m]) for _, t in leaves)
                         for m in range(M))
                std_scalar = torch.sqrt(pw / n_el / 2.0 + v_base)
        else:
            std_scalar = torch.sqrt(v_base)
        no_keys = prng.split(prng.fold_in(key, 1_000_003 + c), len(leaves))
        for li, (_, t) in enumerate(leaves):
            est = None
            for m in range(M):
                x = t[c, m]
                e = draw_normal(eps_keys[c][m][li], x.shape) * inv_root_k
                y = (x.float() * (1.0 + e) * w[m]).to(x.dtype)
                est = y if est is None else est + y
            del e, y
            if cfg.interference and cfg.per_element_interference:
                p2 = sum(wi[m] * torch.square(t[c, m].float())
                         for m in range(M))
                std = torch.sqrt(p2 / 2.0 + v_base)
                del p2
            else:
                std = std_scalar
            noise = draw_normal(no_keys[li], est.shape).to(est.dtype) * std.to(
                est.dtype)
            out[li][c] = est + noise
    return _rebuild(paths, out)


def global_hop(is_deltas, geom: DistGeom, key: torch.Tensor, P_is_t,
               cfg: OTADistConfig):
    """IS -> PS OTA aggregation (eq. 15-18, equivalent channel).

    `is_deltas`: each cluster's accumulated delta, leaves [C, ...].
    Returns the PS's estimate, leaves [...]."""
    leaves = list(tree_leaves(is_deltas))
    paths = [p for p, _ in leaves]
    C = geom.C
    dev = leaves[0][1].device
    if cfg.mode == "ideal":
        return _rebuild(paths, [sum(t[c] / C for c in range(C))
                                for _, t in leaves])

    b_is = _f32(geom.beta_is, dev)
    bb = _f32(geom.beta_bar, dev)
    n_el = float(max(_size(leaves, 1), 1))
    inv_root_k = _f32(1.0 / np.sqrt(geom.K_ps), dev)
    eps_keys = [prng.split(prng.fold_in(key, 2_000_003 + c), len(leaves))
                for c in range(C)]
    w = b_is / bb                                              # [C]
    v_th = geom.sigma_z2 / (geom.K_ps * (P_is_t ** 2) * geom.sigma_h2
                            * bb) / 2.0
    interf = cfg.interference and C > 1
    wi = b_is * (bb - b_is) / (geom.K_ps * bb ** 2)            # [C]
    if interf and not cfg.per_element_interference:
        pw = sum(wi[c] * sum(_sqsum(t[c]) for _, t in leaves)
                 for c in range(C))
        std_scalar = torch.sqrt(pw / n_el / 2.0 + v_th)
    elif not interf:
        std_scalar = torch.sqrt(v_th)
    no_keys = prng.split(prng.fold_in(key, 3_000_017), len(leaves))
    out = []
    for li, (_, t) in enumerate(leaves):
        est = None
        for c in range(C):
            x = t[c]
            e = draw_normal(eps_keys[c][li], x.shape) * inv_root_k
            y = (x.float() * (1.0 + e) * w[c]).to(x.dtype)
            est = y if est is None else est + y
        del e, y
        if interf and cfg.per_element_interference:
            p2 = sum(wi[c] * torch.square(t[c].float()) for c in range(C))
            std = torch.sqrt(p2 / 2.0 + v_th)
            del p2
        else:
            std = std_scalar
        noise = draw_normal(no_keys[li], est.shape).to(est.dtype) * std.to(
            est.dtype)
        out.append(est + noise)
    return _rebuild(paths, out)


def fused_whfl_aggregate(deltas, geom: DistGeom, key: torch.Tensor, P_t,
                         P_is_t, cfg: OTADistConfig):
    """Beyond-paper fused path: both hops as one weighted sum.

        est = sum_c wg_c (1+eps_c) [ sum_m wc_m (1+eps_m) D_m + n_c ] + n_g

    with per-user scalar jitter folded into one weight per user and the
    clusters' and the PS's noise in one draw of the summed variance.
    `deltas` leaves [C, M, ...]; returns leaves [...]."""
    leaves = list(tree_leaves(deltas))
    paths = [p for p, _ in leaves]
    C, M = geom.C, geom.M
    dev = leaves[0][1].device
    if cfg.mode == "ideal":
        return _rebuild(paths, [sum(t[c, m] / (C * M) for c in range(C)
                                    for m in range(M)) for _, t in leaves])

    bo = _f32(geom.beta_own, dev)
    bbc = _f32(geom.beta_bar_c, dev)
    b_is = _f32(geom.beta_is, dev)
    bb = _f32(geom.beta_bar, dev)
    ws = {}
    for c in range(C):
        eps_c = prng.normal(prng.fold_in(key, 2_000_003 + c), ()) / np.sqrt(
            geom.K_ps)
        for m in range(M):
            eps_m = prng.normal(prng.fold_in(key, user_id(c, m, M)),
                                ()) / np.sqrt(geom.K)
            ws[c, m] = ((bo[c, m] / bbc[c]) * (1.0 + eps_m)
                        * (b_is[c] / bb) * (1.0 + eps_c))
    pw = sum(sum(_sqsum(t[c, m]) for _, t in leaves) / (C * M)
             for c in range(C) for m in range(M))
    n_el = float(max(_size(leaves, 2), 1))
    v_c = (torch.sum(bo * (bbc[:, None] - bo), dim=1) * (pw / n_el)
           / (geom.K * bbc ** 2)
           + _f32(geom.beta_cross, dev) * geom.M * (pw / n_el)
           / (geom.K * bbc ** 2)
           + geom.sigma_z2 / (geom.K * (P_t ** 2) * geom.sigma_h2 * bbc))
    wg2 = (b_is / bb) ** 2
    v_cluster_tot = torch.sum(wg2 * v_c)
    v_glob = (torch.sum(b_is * (bb - b_is)) * (pw / n_el)
              / (geom.K_ps * bb ** 2)
              + geom.sigma_z2 / (geom.K_ps * (P_is_t ** 2) * geom.sigma_h2
                                 * bb))
    std = torch.sqrt((v_cluster_tot + v_glob) / 2.0)
    no_keys = prng.split(prng.fold_in(key, 3_000_017), len(leaves))
    out = []
    for li, (_, t) in enumerate(leaves):
        est = None
        for c in range(C):
            for m in range(M):
                y = (t[c, m].float() * ws[c, m]).to(t.dtype)
                est = y if est is None else est + y
        noise = draw_normal(no_keys[li], est.shape).to(est.dtype) * std.to(
            est.dtype)
        out.append(est + noise)
    return _rebuild(paths, out)


def whfl_aggregate(deltas, geom: DistGeom, key: torch.Tensor, P_t, P_is_t,
                   cfg: OTADistConfig):
    """One W-HFL aggregation round (tau = I = 1) of every user's delta
    (leaves [C, M, ...]) to the PS's estimate (leaves [...]): the two
    hops, or the fused one with ``cfg.fused``."""
    if cfg.fused:
        return fused_whfl_aggregate(deltas, geom, key, P_t, P_is_t, cfg)
    k1, k2 = prng.split(key)
    est_c = cluster_hop(deltas, geom, k1, P_t, cfg)
    return global_hop(est_c, geom, k2, P_is_t, cfg)
