"""W-HFL's two OTA hops over the moment-matched "equivalent" channel (or
the error-free "ideal" one), for the LM training step (the port of
`repro.core.dist`).

The JAX package runs these functions inside `shard_map`, one program
per (pod, cluster, user) mesh coordinate: each program holds one user's
delta, the cluster hop is a ``psum('user')`` and the global hop a
``psum(('pod', 'cluster'))``.  The port has both forms, told apart by
one rule: **inside `repro_torch.sharding.shard_map`** (an axis context
is bound: one process per mesh coordinate), `cluster_hop`,
`global_hop`, `fused_whfl_aggregate` and `whfl_aggregate` take this
coordinate's tree and their sums are collectives over the rank's
groups, as in the reference (`sharding.psum`: the cluster hop over the
`user` group of M ranks, the global hop over the `(pod, cluster)` group
of C, the fused hop over all of `(pod, cluster, user)`); **outside
it**, they take every user's delta at once on one device, as a tree
whose leaves carry a leading [C, M] axis (cluster, user; C counts
every pod's clusters, in (pod, cluster) order):

- ``psum('user')`` is a sum over a cluster's M users, and the cluster
  hop returns each cluster's estimate, leaves [C, ...];
- ``psum(('pod', 'cluster'))`` is a sum over the C clusters, and the
  global hop returns the PS's estimate, leaves [...].

Both forms weight, divide and add in one order: a sum over a group of
two is a + b either way, and a scalar's sum is gathered and added in
rank order, as the one-card form adds its list.  So the two forms agree
bit for bit wherever every group has at most two members; the fused
hop's sum over four ranks adds in the backend's order.

Every draw uses the key JAX uses at that coordinate: a user's gain
jitter `fold_in(key, user_id)`, a cluster's noise `fold_in(key,
1_000_003 + c)`, a cluster's global jitter `fold_in(key, 2_000_003 +
c)`, the PS's noise `fold_in(key, 3_000_017)`, each split over the tree's
leaves in `jax.tree` order (`repro_torch.tree`, sorted keys) and drawn
through the `jax.random` emulation (`nn.core._normal`, a slice of
`nn.core.DRAW_SLICE` elements at a time past that size; `draw_normal`).
Noise that JAX draws identically on every member of a receiver group
(a cluster's, the PS's) is drawn by every member's rank too, and once
by the one-card form.

Placements: inside the runner a tree may hold shards (tensor
parallelism over "model", FSDP over the data axes); the ranked hops
then take its spec tree (``specs``, `sharding.param_sharding_tree`'s
layout).  Each leaf's draws are its shard's elements of the whole
leaf's draw (`draw_normal` with a spec: `prng.normal_at` at the
shard's flat indices), and every whole-tree reduction is global: a
split leaf's sum of squares is summed over the axes that split it,
a replicated leaf's counted once, and the element count is the whole
leaves' (`tree_sqsum`, `tree_size`).  Without specs (or with nothing
split) the hops are those of a replicated tree, bit for bit.

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
from repro_torch.sharding import api as sh
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


def draw_normal(key: torch.Tensor, shape, spec=None) -> torch.Tensor:
    """float32 `jax.random.normal(key, shape)`, sliced past
    `nn.core.DRAW_SLICE` elements (the same bits); with a `spec` (inside
    the runner), `shape` is this rank's shard's and the draw its
    elements of the whole leaf's.  A trace names the call's host ops by
    the range ``dist.draw_normal``, so the device time of the kernels
    they launch can be read from it."""
    with torch.profiler.record_function("dist.draw_normal"):
        if spec is not None and sh.sharded(spec):
            return _normal(key, sh.global_shape(shape, spec), 1.0,
                           torch.float32, spec)
        return _normal(key, tuple(shape), 1.0, torch.float32)


def _sqsum(x: torch.Tensor) -> torch.Tensor:
    return torch.sum(torch.square(x.float()))


def _size(leaves: List[Tuple[tuple, torch.Tensor]], lead: int) -> int:
    """Elements of one member's tree (the leaves less `lead` axes)."""
    return sum(math.prod(t.shape[lead:]) for _, t in leaves)


def spec_list(specs, n: int) -> list:
    """A spec tree's leaves, or n Nones (a replicated tree)."""
    return [None] * n if specs is None else sh.spec_leaves(specs)


def _split(specs) -> bool:
    return specs is not None and any(sh.sharded(s)
                                     for s in sh.spec_leaves(specs))


def tree_size(leaves, specs=None) -> int:
    """Elements of the whole tree whose shards are `leaves` ((path,
    tensor) pairs) under `specs` (inside the runner; None: replicated)."""
    if not _split(specs):
        return _size(leaves, 0)
    return sum(math.prod(sh.global_shape(t.shape, s)) for (_, t), s in
               zip(leaves, sh.spec_leaves(specs)))


def tree_sqsum(leaves, specs=None) -> torch.Tensor:
    """The whole tree's float32 sum of squares from this rank's shards:
    the leaves summed in groups by the axes that split them (in leaf
    order), each group's sum summed over its axes, the groups added in
    order of first appearance; a replicated tree's leaf by leaf."""
    if not _split(specs):
        return sum(_sqsum(t) for _, t in leaves)
    groups = {}
    for (_, t), spec in zip(leaves, sh.spec_leaves(specs)):
        groups.setdefault(sh.split_axes(spec), []).append(_sqsum(t))
    total = None
    for axes, parts in groups.items():
        part = _add_all(parts)
        part = sh.psum(part, axes) if axes else part
        total = part if total is None else total + part
    return total


def _add_all(xs):
    """x0 + x1 + ... from the first term (a sum from 0 would turn an
    all -0.0 entry into +0.0, which a collective over the ranks does
    not)."""
    xs = iter(xs)
    out = next(xs)
    for x in xs:
        out = out + x
    return out


def _rebuild(paths, tensors):
    return tree_from_paths(zip(paths, tensors))


def user_id(c: Optional[int] = None, m: Optional[int] = None,
            M: Optional[int] = None) -> int:
    """The reference's global user index of user m of cluster c (c the
    global, pod-major cluster index); with no arguments, inside
    `shard_map`, this rank's."""
    if c is None:
        return cluster_id() * _axis_size("user") + sh.axis_index("user")
    return c * M + m


def _axis_size(name: str) -> int:
    return sh.axis_size(name)


def cluster_id() -> int:
    """Inside `shard_map`: the global cluster index, pod * clusters per
    pod + cluster."""
    return (sh.axis_index("pod") * _axis_size("cluster")
            + sh.axis_index("cluster"))


def _ranked() -> bool:
    """True inside `shard_map`: the hops take this coordinate's tree."""
    return sh.current_axes() is not None


_USER = "user"
_CLUSTERS = ("pod", "cluster")
_ALL = ("pod", "cluster", "user")


# ---------------------------------------------------------------------------
# the two OTA hops
# ---------------------------------------------------------------------------

def cluster_hop(deltas, geom: DistGeom, key: torch.Tensor, P_t,
                cfg: OTADistConfig, *, specs=None):
    """MU -> IS OTA aggregation (eq. 8-13, equivalent channel).

    `deltas`: every user's model delta, leaves [C, M, ...] (float32).
    Returns each cluster's estimate, leaves [C, ...]: the reference's
    `cluster_hop` output on cluster c's members.  Inside `shard_map`:
    this user's delta to its cluster's estimate (`_rank_cluster_hop`)."""
    if _ranked():
        return _rank_cluster_hop(deltas, geom, key, P_t, cfg, specs)
    leaves = list(tree_leaves(deltas))
    paths = [p for p, _ in leaves]
    C, M = geom.C, geom.M
    dev = leaves[0][1].device
    if cfg.mode == "ideal":
        return _rebuild(paths, [_add_all(t[:, m] / M for m in range(M))
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
               cfg: OTADistConfig, *, specs=None):
    """IS -> PS OTA aggregation (eq. 15-18, equivalent channel).

    `is_deltas`: each cluster's accumulated delta, leaves [C, ...].
    Returns the PS's estimate, leaves [...].  Inside `shard_map`: this
    rank's cluster's delta to the PS's estimate (`_rank_global_hop`)."""
    if _ranked():
        return _rank_global_hop(is_deltas, geom, key, P_is_t, cfg, specs)
    leaves = list(tree_leaves(is_deltas))
    paths = [p for p, _ in leaves]
    C = geom.C
    dev = leaves[0][1].device
    if cfg.mode == "ideal":
        return _rebuild(paths, [_add_all(t[c] / C for c in range(C))
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
                         P_is_t, cfg: OTADistConfig, *, specs=None):
    """Beyond-paper fused path: both hops as one weighted sum.

        est = sum_c wg_c (1+eps_c) [ sum_m wc_m (1+eps_m) D_m + n_c ] + n_g

    with per-user scalar jitter folded into one weight per user and the
    clusters' and the PS's noise in one draw of the summed variance.
    `deltas` leaves [C, M, ...]; returns leaves [...].  Inside
    `shard_map`: this user's delta, one flat sum over all ranks
    (`_rank_fused`)."""
    if _ranked():
        return _rank_fused(deltas, geom, key, P_t, P_is_t, cfg, specs)
    leaves = list(tree_leaves(deltas))
    paths = [p for p, _ in leaves]
    C, M = geom.C, geom.M
    dev = leaves[0][1].device
    if cfg.mode == "ideal":
        return _rebuild(paths, [_add_all(t[c, m] / (C * M)
                                         for c in range(C)
                                         for m in range(M))
                                for _, t in leaves])

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
                   cfg: OTADistConfig, *, specs=None):
    """One W-HFL aggregation round (tau = I = 1) of every user's delta
    (leaves [C, M, ...]; inside `shard_map` this user's, whose shards'
    spec tree is `specs`) to the PS's estimate (leaves [...]): the two
    hops, or the fused one with ``cfg.fused``."""
    if cfg.fused:
        return fused_whfl_aggregate(deltas, geom, key, P_t, P_is_t, cfg,
                                    specs=specs)
    k1, k2 = prng.split(key)
    est_c = cluster_hop(deltas, geom, k1, P_t, cfg, specs=specs)
    return global_hop(est_c, geom, k2, P_is_t, cfg, specs=specs)


# ---------------------------------------------------------------------------
# one coordinate's hops (inside `sharding.shard_map`)
# ---------------------------------------------------------------------------

def _rank_hop(leaves, specs, eps_keys, no_keys, inv_root_k, w, wi, v_base,
              std_scalar, names, per_element: bool) -> list:
    """A hop's leaves on this rank: each leaf weighted and jittered and,
    per element, its interference power, both summed over `names`, then
    the sum plus noise of the resulting std."""
    out = []
    for li, ((_, x), spec) in enumerate(zip(leaves, specs)):
        e = draw_normal(eps_keys[li], x.shape, spec) * inv_root_k
        y = (x.float() * (1.0 + e) * w).to(x.dtype)
        del e
        est = sh.psum(y, names)
        del y
        if per_element:
            p2 = sh.psum(wi * torch.square(x.float()), names)
            std = torch.sqrt(p2 / 2.0 + v_base)
            del p2
        else:
            std = std_scalar
        noise = draw_normal(no_keys[li], est.shape, spec).to(
            est.dtype) * std.to(est.dtype)
        out.append(est + noise)
    return out


def _rank_cluster_hop(delta, geom: DistGeom, key: torch.Tensor, P_t,
                      cfg: OTADistConfig, specs=None):
    """This user's delta -> its cluster's estimate, identical on every
    member of the cluster.  Collectives over the `user` group: one
    delta-sized all-reduce (+ one more with per-element interference)
    and one scalar sum (+ one more with scalar interference)."""
    leaves = list(tree_leaves(delta))
    paths = [p for p, _ in leaves]
    M = geom.M
    dev = leaves[0][1].device
    if cfg.mode == "ideal":
        return _rebuild(paths, [sh.psum(t / M, _USER) for _, t in leaves])

    ci, ui = cluster_id(), sh.axis_index(_USER)
    b_m = _f32(geom.beta_own, dev)[ci, ui]
    bb_c = _f32(geom.beta_bar_c, dev)[ci]
    w = b_m / bb_c
    n_el = float(max(tree_size(leaves, specs), 1))
    v_base = (geom.sigma_z2 / (geom.K * (P_t ** 2) * geom.sigma_h2 * bb_c)
              / 2.0)
    wi = std_scalar = None
    if cfg.interference:
        sq = tree_sqsum(leaves, specs)
        pw_own = sh.psum(sq / M, _USER)
        v_base = v_base + (_f32(geom.beta_cross, dev)[ci] * pw_own / n_el
                           / (geom.K * bb_c ** 2)) / 2.0
        wi = b_m * (bb_c - b_m) / (geom.K * bb_c ** 2)
        if not cfg.per_element_interference:
            pw = sh.psum(wi * sq, _USER)
            std_scalar = torch.sqrt(pw / n_el / 2.0 + v_base)
    else:
        std_scalar = torch.sqrt(v_base)
    out = _rank_hop(
        leaves, spec_list(specs, len(leaves)),
        prng.split(prng.fold_in(key, user_id()), len(leaves)),
        prng.split(prng.fold_in(key, 1_000_003 + ci), len(leaves)),
        _f32(1.0 / np.sqrt(geom.K), dev), w, wi, v_base, std_scalar, _USER,
        cfg.interference and cfg.per_element_interference)
    return _rebuild(paths, out)


def _rank_global_hop(is_delta, geom: DistGeom, key: torch.Tensor, P_is_t,
                     cfg: OTADistConfig, specs=None):
    """This rank's cluster's delta -> the PS's estimate.  The sum over
    the `(pod, cluster)` group at a fixed user coordinate adds each
    cluster once."""
    leaves = list(tree_leaves(is_delta))
    paths = [p for p, _ in leaves]
    C = geom.C
    dev = leaves[0][1].device
    if cfg.mode == "ideal":
        return _rebuild(paths, [sh.psum(t / C, _CLUSTERS)
                                for _, t in leaves])

    ci = cluster_id()
    b_is = _f32(geom.beta_is, dev)[ci]
    bb = _f32(geom.beta_bar, dev)
    n_el = float(max(tree_size(leaves, specs), 1))
    w = b_is / bb
    v_th = geom.sigma_z2 / (geom.K_ps * (P_is_t ** 2) * geom.sigma_h2
                            * bb) / 2.0
    interf = cfg.interference and C > 1
    wi = b_is * (bb - b_is) / (geom.K_ps * bb ** 2)
    std_scalar = None
    if interf and not cfg.per_element_interference:
        pw = sh.psum(wi * tree_sqsum(leaves, specs), _CLUSTERS)
        std_scalar = torch.sqrt(pw / n_el / 2.0 + v_th)
    elif not interf:
        std_scalar = torch.sqrt(v_th)
    out = _rank_hop(
        leaves, spec_list(specs, len(leaves)),
        prng.split(prng.fold_in(key, 2_000_003 + ci), len(leaves)),
        prng.split(prng.fold_in(key, 3_000_017), len(leaves)),
        _f32(1.0 / np.sqrt(geom.K_ps), dev), w, wi, v_th, std_scalar,
        _CLUSTERS, interf and cfg.per_element_interference)
    return _rebuild(paths, out)


def _rank_fused(delta, geom: DistGeom, key: torch.Tensor, P_t, P_is_t,
                cfg: OTADistConfig, specs=None):
    """This user's delta -> the PS's estimate in one flat sum over all
    of (pod, cluster, user), its scalar weight both hops' gains."""
    leaves = list(tree_leaves(delta))
    paths = [p for p, _ in leaves]
    C, M = geom.C, geom.M
    dev = leaves[0][1].device
    if cfg.mode == "ideal":
        return _rebuild(paths, [sh.psum(t / (C * M), _ALL)
                                for _, t in leaves])

    ci, ui = cluster_id(), sh.axis_index(_USER)
    bo = _f32(geom.beta_own, dev)
    bbc = _f32(geom.beta_bar_c, dev)
    b_is = _f32(geom.beta_is, dev)
    bb = _f32(geom.beta_bar, dev)
    eps_c = prng.normal(prng.fold_in(key, 2_000_003 + ci), ()) / np.sqrt(
        geom.K_ps)
    eps_m = prng.normal(prng.fold_in(key, user_id()), ()) / np.sqrt(geom.K)
    w = ((bo[ci, ui] / bbc[ci]) * (1.0 + eps_m) * (b_is[ci] / bb)
         * (1.0 + eps_c))
    pw = sh.psum(tree_sqsum(leaves, specs) / (C * M), _ALL)
    n_el = float(max(tree_size(leaves, specs), 1))
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
    for li, ((_, t), spec) in enumerate(zip(leaves, spec_list(
            specs, len(leaves)))):
        est = sh.psum((t.float() * w).to(t.dtype), _ALL)
        noise = draw_normal(no_keys[li], est.shape, spec).to(
            est.dtype) * std.to(est.dtype)
        out.append(est + noise)
    return _rebuild(paths, out)
