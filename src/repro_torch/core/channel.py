"""Over-the-air (OTA) aggregation channels (paper §III).

Model deltas in R^{2N} are packed into C^N (eq. 7/14), transmitted
uncoded and simultaneously over a Rayleigh-fading MAC with path loss,
received over K antennas, matched-filter combined with the *sum* of the
own-cluster channels (eq. 9/16), and rescaled (eq. 12/17).

The receive fold is implemented by pluggable **channel backends**
(`ChannelBackend` registry); `OTAConfig.backend` selects one:

- ``equivalent`` — closed-form surrogate: the first/second moments of
  eq. (11)/(19) applied as per-entry Gaussian perturbations, drawn with
  the `jax.random` emulation so a key gives the reference's draws.
- ``reference`` — the paper's model, exactly: an einsum fold over
  antenna chunks that draws per-(user, antenna, symbol) channels chunk
  by chunk with the emulation.  The ground truth the others are gated
  on; it runs no kernel.
- ``slab_kernel`` — faithful path: draws the full [C_rx, U, K, N]
  channel slab with the emulation and runs the matched-filter combine
  (`repro_torch.kernels.mf_combine`, the Hopper kernel
  ``csrc/ota_combine.cu`` on the card) for all rx stations at once.
  O(C_rx * U * K * N) memory.
- ``fused`` — faithful path: fading and noise are derived inside the
  Hopper kernel from the counter PRNG (`repro_torch.kernels.fused_mac`);
  no channel tensor ever exists.

``mode="ideal"`` bypasses the channel entirely and wins over any backend.

Every hop computes on the device of its `deltas`; keys are int64 word
tensors (`repro_torch.prng`) on that device, and power multipliers are
float32 scalar tensors, as they enter the reference's jitted round.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch import prng
from repro_torch.core.topology import Topology
from repro_torch.kernels import (canonical_block_u, fused_combine,
                                 mf_combine)


@dataclass(frozen=True)
class OTAConfig:
    mode: str = "faithful"   # "faithful" | "equivalent" | "ideal"
    interference: bool = True
    antenna_chunk: int = 8   # antennas folded per scan step (reference)
    backend: str = ""        # "" (mode default) | "reference" |
    #                          "equivalent" | "slab_kernel" | "fused"


_MODE_DEFAULT_BACKEND = {"faithful": "reference", "equivalent": "equivalent"}


def _chunk(K: int, ck: int) -> int:
    """Largest divisor of K that is <= ck."""
    ck = max(1, min(ck, K))
    while K % ck:
        ck -= 1
    return ck


def resolve_backend(cfg: OTAConfig) -> str:
    """Backend name a non-ideal hop will dispatch to: the explicit
    `cfg.backend` if set, else the default for `cfg.mode`."""
    if cfg.backend:
        return cfg.backend
    try:
        return _MODE_DEFAULT_BACKEND[cfg.mode]
    except KeyError:
        raise ValueError(
            f"no default backend for mode {cfg.mode!r}; known modes: "
            f"{', '.join(sorted(_MODE_DEFAULT_BACKEND))}, ideal") from None


def vmap_seeds(hop_fn):
    """Lift an OTA hop over a leading seed/realization axis.

    ``hop_fn(key, deltas, topo, P, cfg) -> est`` (any of `cluster_ota`,
    `global_ota`, `conventional_ota`) becomes a function taking keys
    ``[S, 2]`` and deltas with a leading ``S`` axis, drawing S
    independent channel/noise realizations in one `torch.func.vmap`
    (the kernel backends as one launch for all S,
    `repro_torch.kernels.ops`).  Geometry, power and config are shared
    across the batch; each seed's draws equal its own call's, as they
    depend only on its key.  The hop-level view of what the sweep's
    ``batch="vmap"`` does to the whole round."""
    def batched(keys, deltas, topo, P, cfg: OTAConfig = OTAConfig()):
        return torch.func.vmap(lambda k, d: hop_fn(k, d, topo, P, cfg))(
            keys, deltas)
    return batched


# ---------------------------------------------------------------------------
# packing R^{2N} <-> C^N (eq. 7)
# ---------------------------------------------------------------------------

def pack_cx(x: torch.Tensor) -> torch.Tensor:
    """[..., 2N] real -> [..., N] complex64 (first half real, second
    half imaginary; not interleaved)."""
    n = x.shape[-1] // 2
    return torch.complex(x[..., :n].to(torch.float32),
                         x[..., n:].to(torch.float32))


def unpack_cx(y: torch.Tensor) -> torch.Tensor:
    return torch.cat([y.real, y.imag], dim=-1)


def _cn(key, shape, var: float) -> torch.Tensor:
    """Circularly-symmetric complex normal CN(0, var), drawn as the
    reference draws it: two normals from ``split(key)``."""
    kr, ki = prng.split(key)
    s = float(np.sqrt(var / 2.0))
    return torch.complex(s * prng.normal(kr, shape),
                         s * prng.normal(ki, shape))


def _seed_words(key: torch.Tensor) -> torch.Tensor:
    """PRNG key -> the two uint32 seed words of the fused kernel (under a
    seed vmap, each seed's own)."""
    return key.reshape(-1)[:2]


def _f32(x, device) -> torch.Tensor:
    return torch.as_tensor(np.ascontiguousarray(x, np.float32),
                           device=device)


# Static per-topology tensors, uploaded once per device: a copy from
# host memory makes the host wait for the card, so a hop must not repeat
# it every round.  A cluster-hop entry holds its Topology, so the id in
# its key cannot be reused while the entry lives; other entries are
# keyed by their array's bytes.
_GEOMETRY: Dict[tuple, object] = {}
_GEOMETRY_MAX = 64


def _cached(key, build):
    if key not in _GEOMETRY:
        if len(_GEOMETRY) >= _GEOMETRY_MAX:
            _GEOMETRY.clear()
        _GEOMETRY[key] = build()
    return _GEOMETRY[key]


def _const(x, device) -> torch.Tensor:
    """A static float32 array on `device`, uploaded once per content (a
    tensor, already on the device, passes through)."""
    if isinstance(x, torch.Tensor):
        return x
    a = np.ascontiguousarray(x, np.float32)
    return _cached(("const", a.tobytes(), a.shape, torch.device(device)),
                   lambda: _f32(a, device))


def _cluster_geometry(topo: Topology, cfg: OTAConfig,
                      device) -> Tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
    """Static cluster-hop geometry for the kernel backend, built once per
    topology, interference flag and device.

    Returns (amp [C_rx, U], own [C_rx, U], beta_bar [C]): per-rx channel
    amplitudes sqrt(beta[u -> c]), the own-cluster matched-filter mask,
    and the normalization sums.  ``interference=False`` zeroes the
    cross-cluster amplitudes.
    """
    key = ("cluster", id(topo), cfg.interference, torch.device(device))
    return _cached(key, lambda: (topo, _build_cluster_geometry(
        topo, cfg, device)))[1]


def _mac_geometry(beta: np.ndarray, device) -> Tuple[torch.Tensor,
                                                      torch.Tensor,
                                                      torch.Tensor]:
    """(amp [1, U], w [1, U], sum beta) of a single-cell hop: amplitudes
    sqrt(beta), unit matched-filter weights and the normalization sum,
    built once per beta and device (per call for a beta tensor)."""
    def build(bt):
        return (torch.sqrt(bt)[None, :].contiguous(),
                torch.ones((1, bt.numel()), device=device), bt.sum())

    if isinstance(beta, torch.Tensor):
        return build(beta.reshape(-1))
    b = np.ascontiguousarray(beta, np.float32).reshape(-1)
    return _cached(("mac", b.tobytes(), torch.device(device)),
                   lambda: build(_f32(b, device)))


def _build_cluster_geometry(topo: Topology, cfg: OTAConfig, device):
    C, M = topo.C, topo.M
    U = C * M
    beta = np.asarray(topo.beta_mu_is, np.float32).reshape(U, C)
    own = np.zeros((C, U), np.float32)
    for c in range(C):
        own[c, c * M:(c + 1) * M] = 1.0
    amp = np.sqrt(beta.T)                        # [C_rx, U]
    if not cfg.interference:
        amp = amp * own
    return (_f32(amp, device), _f32(own, device),
            _f32(topo.beta_bar_c, device))


def _own(h: torch.Tensor) -> torch.Tensor:
    """h: [C', M, C_rx, a, n] -> own-cluster channel sums [C, a, n]."""
    idx = torch.arange(h.shape[0], device=h.device)
    return h[idx, :, idx].sum(dim=1)          # h[idx, :, idx]: [C, M, a, n]


# ---------------------------------------------------------------------------
# backend protocol + registry
# ---------------------------------------------------------------------------

class ChannelBackend:
    """One implementation of the paper's two OTA receive folds.

    `cluster` is the MU -> IS hop (eq. 8-12): per-cluster estimates for
    every receiving IS.  `mac` is the single-cell hop (eq. 15-17) used
    both for IS -> PS (U = C) and conventional single-hop FL (U = C*M).
    All randomness follows `key`.
    """

    name: str = ""

    def cluster(self, key, deltas: torch.Tensor, topo: Topology, P_t,
                cfg: OTAConfig) -> torch.Tensor:
        """deltas [C, M, 2N] -> per-IS estimates [C, 2N]."""
        raise NotImplementedError

    def mac(self, key, deltas: torch.Tensor, beta: np.ndarray, K: int,
            sigma_h2: float, sigma_z2: float, P,
            cfg: OTAConfig) -> torch.Tensor:
        """deltas [U, 2N], beta [U] -> eq.(17)-rescaled estimate [2N].
        beta is a static array, or a float32 tensor on deltas' device."""
        raise NotImplementedError


BACKENDS: Dict[str, ChannelBackend] = {}


def register_backend(backend: ChannelBackend,
                     overwrite: bool = False) -> ChannelBackend:
    if backend.name in BACKENDS and not overwrite:
        raise ValueError(f"backend {backend.name!r} already registered")
    BACKENDS[backend.name] = backend
    return backend


def get_backend(name: str) -> ChannelBackend:
    try:
        return BACKENDS[name]
    except KeyError:
        raise KeyError(f"unknown channel backend {name!r}; known: "
                       f"{', '.join(sorted(BACKENDS))}") from None


def list_backends() -> Dict[str, ChannelBackend]:
    return dict(BACKENDS)


# ---------------------------------------------------------------------------
# "reference": einsum fold over antenna chunks (the ground truth)
# ---------------------------------------------------------------------------

class ReferenceBackend(ChannelBackend):
    """The paper's model folded chunk by chunk over antennas with complex
    einsums: exact, O(U * chunk * N) live memory per step.  The chunks
    run in key order, each from its own key of ``split(key, n_steps)``,
    as the reference's `lax.scan` runs them.

    Normalization (eq. 12): divide by P_t sigma_h^2 SUM_m beta, which
    makes the estimate the beta-weighted cluster mean in expectation
    (the reasoning is in the JAX package's `ReferenceBackend`).  All
    faithful backends share it.
    """

    name = "reference"

    def cluster(self, key, deltas, topo, P_t, cfg):
        C, M, twoN = deltas.shape
        N = twoN // 2
        dev = deltas.device
        tx = pack_cx(deltas)                                     # [C, M, N]
        beta = _const(topo.beta_mu_is, dev)                  # [C', M, C_rx]
        if not cfg.interference:
            # zero out cross-cluster path gains
            beta = beta * torch.eye(C, device=dev)[:, None, :]
        amp = torch.sqrt(beta)[:, :, :, None, None]
        beta_bar_c = _const(topo.beta_bar_c, dev)                # [C]
        K = topo.K
        ck = _chunk(K, cfg.antenna_chunk)
        acc = torch.zeros((C, N), dtype=torch.complex64, device=dev)
        for kk in prng.split(key, K // ck):
            k1, k2 = prng.split(kk)
            # h[c', m, c_rx, a, n] = sqrt(beta) g, g ~ CN(0, sigma_h2)
            h = amp * _cn(k1, (C, M, C, ck, N), topo.sigma_h2)
            z = _cn(k2, (C, ck, N), topo.sigma_z2)
            # received per rx cluster and antenna (eq. 8)
            y = P_t * torch.einsum("umcan,umn->can", h, tx) + z
            # own-cluster matched filter: sum_m h[c, m, c, a, n] (eq. 9)
            acc = acc + torch.einsum("can,can->cn", torch.conj(_own(h)), y)
        scale = 1.0 / (P_t * topo.sigma_h2 * beta_bar_c)
        return unpack_cx(acc / K * scale[:, None])

    def mac(self, key, deltas, beta, K, sigma_h2, sigma_z2, P, cfg):
        U, twoN = deltas.shape
        N = twoN // 2
        tx = pack_cx(deltas)                                     # [U, N]
        amp, _, b_bar = _mac_geometry(beta, deltas.device)
        amp = amp[0][:, None, None]
        ck = _chunk(K, cfg.antenna_chunk)
        acc = torch.zeros((N,), dtype=torch.complex64, device=deltas.device)
        for kk in prng.split(key, K // ck):
            k1, k2 = prng.split(kk)
            h = amp * _cn(k1, (U, ck, N), sigma_h2)
            z = _cn(k2, (ck, N), sigma_z2)
            y = P * torch.einsum("uan,un->an", h, tx) + z
            acc = acc + torch.einsum("an,an->n", torch.conj(h.sum(dim=0)), y)
        return unpack_cx(acc / K / (P * sigma_h2 * b_bar))


# ---------------------------------------------------------------------------
# "equivalent": second-order moment-matched surrogate
# ---------------------------------------------------------------------------

class EquivalentBackend(ChannelBackend):
    """Closed-form surrogate matched to the faithful model's first and
    second moments."""

    name = "equivalent"

    def cluster(self, key, deltas, topo, P_t, cfg):
        """est[c] = (1/beta_bar_c) sum_m beta_m (1 + eps_{m,n}) D_{c,m}
                    + CN(0, V_intra + V_inter + V_noise) per entry,

        with eps ~ N(0, 1/K) and the variances of the Lemma 7/9
        calculus; the signal term divides by beta_bar_c = SUM_m beta."""
        C, M, twoN = deltas.shape
        N = twoN // 2
        K = float(topo.K)
        dev = deltas.device
        tx = pack_cx(deltas)                                     # [C, M, N]
        beta = _const(topo.beta_mu_is, dev)                  # [C', M, C_rx]
        beta_own = torch.stack([beta[c, :, c] for c in range(C)])  # [C, M]
        bb = _const(topo.beta_bar_c, dev)                        # [C]

        k_eps, _, k_no = prng.split(key, 3)
        eps = prng.normal(k_eps, (C, M, N)) / math.sqrt(K)
        sig = torch.einsum("cm,cmn->cn", beta_own.to(torch.complex64),
                           tx * (1.0 + eps))
        sig = sig / bb[:, None]

        p2 = torch.abs(tx) ** 2                                  # [C, M, N]
        if cfg.interference:
            b_sum = beta_own.sum(dim=1)                          # == bb
            w_intra = torch.einsum(
                "cm,cmn->cn", beta_own,
                p2 * (b_sum[:, None, None] - beta_own[..., None]))
            V_intra = w_intra / (K * bb[:, None] ** 2)
            cross = torch.einsum("umc,umn->cn", beta, p2) - torch.einsum(
                "cm,cmn->cn", beta_own, p2)
            V_inter = bb[:, None] * cross / (K * bb[:, None] ** 2)
        else:
            V_intra = V_inter = torch.zeros((C, N), device=dev)
        V_noise = topo.sigma_z2 / (
            (P_t ** 2) * topo.sigma_h2 * bb[:, None] * K)
        noise = _cn(k_no, (C, N), 1.0) * torch.sqrt(V_intra + V_inter
                                                    + V_noise)
        return unpack_cx(sig + noise)

    def mac(self, key, deltas, beta, K, sigma_h2, sigma_z2, P, cfg):
        U, twoN = deltas.shape
        N = twoN // 2
        tx = pack_cx(deltas)
        b = _const(beta, deltas.device)
        b_bar = b.sum()
        k_eps, k_no = prng.split(key)
        eps = prng.normal(k_eps, (U, N)) / math.sqrt(K)
        sig = torch.einsum("u,un->n", b.to(torch.complex64),
                           tx * (1.0 + eps))
        sig = sig / b_bar
        if cfg.interference and U > 1:
            p2 = torch.abs(tx) ** 2
            w = torch.einsum("u,un->n", b, p2 * (b_bar - b)[:, None])
            V_int = w / (float(K) * b_bar ** 2)
        else:
            V_int = torch.zeros((N,), device=deltas.device)
        V_noise = sigma_z2 / ((P ** 2) * sigma_h2 * b_bar * float(K))
        noise = _cn(k_no, (N,), 1.0) * torch.sqrt(V_int + V_noise)
        return unpack_cx(sig + noise)


# ---------------------------------------------------------------------------
# "slab_kernel": materialized channels + the matched-filter combine kernel
# ---------------------------------------------------------------------------

class SlabKernelBackend(ChannelBackend):
    """Faithful path: draws the full channel slab with the emulation,
    then runs the matched-filter combine for all rx stations in one
    kernel launch.  Memory is O(C_rx * U * K * N): the throughput
    baseline the fused backend removes.  The same draws as the JAX
    package's ``slab_kernel`` backend."""

    name = "slab_kernel"

    @staticmethod
    def cluster_inputs(key, deltas, topo, P_t, cfg):
        """The combine's operands on the cluster hop: (h [C, U, K, N],
        P_t * tx [U, N], z [C, K, N], own-cluster weights [C, U])."""
        C, M, twoN = deltas.shape
        U, N = C * M, twoN // 2
        tx = pack_cx(deltas).reshape(U, N)
        amp, own, _ = _cluster_geometry(topo, cfg, deltas.device)
        k1, k2 = prng.split(key)
        g = _cn(k1, (C, U, topo.K, N), topo.sigma_h2)   # independent per rx
        h = amp[:, :, None, None] * g
        z = _cn(k2, (C, topo.K, N), topo.sigma_z2)
        return h, P_t * tx, z, own

    @staticmethod
    def mac_inputs(key, deltas, beta, K, sigma_h2, sigma_z2, P):
        """The combine's operands on a single-cell hop: (h [U, K, N],
        P * tx [U, N], z [K, N]); the weights are all ones."""
        tx = pack_cx(deltas)
        U, N = tx.shape
        amp, _, _ = _mac_geometry(beta, deltas.device)
        k1, k2 = prng.split(key)
        h = amp[0][:, None, None] * _cn(k1, (U, K, N), sigma_h2)
        z = _cn(k2, (K, N), sigma_z2)
        return h, P * tx, z

    def cluster(self, key, deltas, topo, P_t, cfg):
        _, _, bb = _cluster_geometry(topo, cfg, deltas.device)
        y = mf_combine(*self.cluster_inputs(key, deltas, topo, P_t, cfg))
        est = y / topo.K / (P_t * topo.sigma_h2 * bb[:, None])
        return unpack_cx(est)

    def mac(self, key, deltas, beta, K, sigma_h2, sigma_z2, P, cfg):
        _, _, b_bar = _mac_geometry(beta, deltas.device)
        y = mf_combine(*self.mac_inputs(key, deltas, beta, K, sigma_h2,
                                        sigma_z2, P))
        return fused_estimate(y, K, P, sigma_h2, b_bar)


# ---------------------------------------------------------------------------
# "fused": on-the-fly channel generation inside the kernel
# ---------------------------------------------------------------------------

def fused_estimate(y, K: int, P, sigma_h2: float, b_bar) -> torch.Tensor:
    """The fused combine's complex y [..., N] -> the unpacked estimate
    [..., 2N]: y / K / (P sigma_h2 b_bar), the matched filter's
    normalization (b_bar broadcasts against y's leading axes)."""
    return unpack_cx(y / K / (P * sigma_h2 * b_bar))


class FusedBackend(ChannelBackend):
    """Faithful path for large U: channels and noise are derived inside
    the kernel from the counter PRNG seeded by `key`; channel memory is
    O(1) per thread.  Same draws as the JAX package's fused backend."""

    name = "fused"

    def cluster(self, key, deltas, topo, P_t, cfg):
        C, M, twoN = deltas.shape
        N = twoN // 2
        U, K = C * M, topo.K
        tx = pack_cx(deltas).reshape(U, N)
        amp, own, bb = _cluster_geometry(topo, cfg, deltas.device)
        y = fused_combine(_seed_words(key), P_t * tx, amp, own, K=K,
                          sigma_h2=topo.sigma_h2, sigma_z2=topo.sigma_z2,
                          block_u=canonical_block_u(M))
        return fused_estimate(y, K, P_t, topo.sigma_h2, bb[:, None])

    def mac(self, key, deltas, beta, K, sigma_h2, sigma_z2, P, cfg):
        tx = pack_cx(deltas)
        amp, w, b_bar = _mac_geometry(beta, deltas.device)
        y = fused_combine(_seed_words(key), P * tx, amp, w, K=K,
                          sigma_h2=sigma_h2, sigma_z2=sigma_z2)[0]
        return fused_estimate(y, K, P, sigma_h2, b_bar)


register_backend(ReferenceBackend())
register_backend(EquivalentBackend())
register_backend(SlabKernelBackend())
register_backend(FusedBackend())


# ---------------------------------------------------------------------------
# public hops (paper eq. 8-12, 15-19)
# ---------------------------------------------------------------------------

def cluster_ota(key, deltas: torch.Tensor, topo: Topology, P_t,
                cfg: OTAConfig = OTAConfig()) -> torch.Tensor:
    """Cluster aggregation hop (MUs -> ISs), eq. (8)-(12).

    deltas: [C, M, 2N].  Returns [C, 2N], each IS's estimate of its
    cluster mean.
    """
    if cfg.mode == "ideal":
        return deltas.mean(dim=1)
    return get_backend(resolve_backend(cfg)).cluster(key, deltas, topo,
                                                     P_t, cfg)


def global_ota(key, is_deltas: torch.Tensor, topo: Topology, P_is_t,
               cfg: OTAConfig = OTAConfig()) -> torch.Tensor:
    """Global aggregation hop (ISs -> PS), eq. (15)-(19).

    is_deltas: [C, 2N].  Returns [2N].
    """
    if cfg.mode == "ideal":
        return is_deltas.mean(dim=0)
    return get_backend(resolve_backend(cfg)).mac(
        key, is_deltas, topo.beta_is, topo.K_ps, topo.sigma_h2,
        topo.sigma_z2, P_is_t, cfg)


def conventional_ota(key, deltas: torch.Tensor, topo: Topology, P_t,
                     cfg: OTAConfig = OTAConfig()) -> torch.Tensor:
    """Conventional (single-hop) OTA FL: every MU transmits directly to
    the PS (the paper's baseline).  deltas: [C, M, 2N] -> [2N]."""
    C, M, twoN = deltas.shape
    flat = deltas.reshape(C * M, twoN)
    if cfg.mode == "ideal":
        return flat.mean(dim=0)
    return get_backend(resolve_backend(cfg)).mac(
        key, flat, np.asarray(topo.beta_mu_ps).reshape(C * M), topo.K_ps,
        topo.sigma_h2, topo.sigma_z2, P_t, cfg)


# ---------------------------------------------------------------------------
# orthogonalized per-user reception (the robust folds' substrate)
# ---------------------------------------------------------------------------

# Backends whose receive fold can be evaluated one user at a time.  The
# analog MAC delivers only the waveform sum P sum_m h_m x_m + z: a
# coordinate median or trim is a nonlinear per-user order statistic,
# which no matched filter (or any linear processing) of the sum can
# recover.  Robust folds therefore need orthogonal uplink slots, one per
# MU, modelled as single-user MAC hops.  `reference` and `equivalent`
# fold one user exactly (moment-matched at U = 1); the `slab_kernel` and
# `fused` kernels exist for the U-way superposition, and one user at a
# time would make them many tiny launches, so they are rejected.
ROBUST_CAPABLE_BACKENDS = ("reference", "equivalent")


def orthogonal_cluster_ota(key, deltas: torch.Tensor, topo: Topology, P_t,
                           cfg: OTAConfig = OTAConfig()) -> torch.Tensor:
    """Per-user orthogonalized cluster hop: each MU transmits to its own
    IS on a slot of its own, so the IS receives one noisy estimate per
    user, which the robust cluster folds (`repro_torch.core.aggregation.
    masked_median`, `masked_trimmed_mean`) fold over.

    deltas [C, M, 2N] -> per-user estimates [C, M, 2N].  User (c, m)'s
    slot is a U = 1 single-cell hop (eq. 15-17) with its own-cluster gain
    ``topo.beta_own[c, m]`` and key ``split(key, C*M)[c*M + m]``, as in
    the JAX package.  The gains are one cached [C, M] tensor, indexed
    per user.  ``mode="ideal"`` returns `deltas`."""
    if cfg.mode == "ideal":
        return deltas
    name = resolve_backend(cfg)
    if name not in ROBUST_CAPABLE_BACKENDS:
        raise ValueError(
            f"robust cluster aggregation needs per-user reception; "
            f"backend {name!r} implements the in-channel OTA "
            f"superposition, which cannot be robustified (see "
            f"repro_torch.core.channel.ROBUST_CAPABLE_BACKENDS). Use one "
            f"of: {', '.join(ROBUST_CAPABLE_BACKENDS)}, or mode='ideal'.")
    backend = get_backend(name)
    C, M, _ = deltas.shape
    beta_own = _const(topo.beta_own, deltas.device)              # [C, M]
    keys = prng.split(key, C * M)
    return torch.stack([torch.stack([
        backend.mac(keys[c * M + m], deltas[c, m][None],
                    beta_own[c, m:m + 1], topo.K, topo.sigma_h2,
                    topo.sigma_z2, P_t, cfg)
        for m in range(M)]) for c in range(C)])
