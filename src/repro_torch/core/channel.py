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
- ``fused`` — faithful path: fading and noise are derived inside the
  Hopper kernel from the counter PRNG (`repro_torch.kernels.fused_mac`);
  no channel tensor ever exists.
- ``reference`` and ``slab_kernel`` are registered but not ported yet;
  they raise and name the ROADMAP item that brings them.

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
from repro_torch.kernels import canonical_block_u, fused_combine


@dataclass(frozen=True)
class OTAConfig:
    mode: str = "faithful"   # "faithful" | "equivalent" | "ideal"
    interference: bool = True
    antenna_chunk: int = 8   # antennas folded per scan step (reference)
    backend: str = ""        # "" (mode default) | "reference" |
    #                          "equivalent" | "slab_kernel" | "fused"


_MODE_DEFAULT_BACKEND = {"faithful": "reference", "equivalent": "equivalent"}


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
    """PRNG key -> the two uint32 seed words of the fused kernel."""
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
    """A static float32 array on `device`, uploaded once per content."""
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
    built once per beta and device."""
    b = np.ascontiguousarray(beta, np.float32).reshape(-1)

    def build():
        bt = _f32(b, device)
        return (torch.sqrt(bt)[None, :].contiguous(),
                torch.ones((1, b.size), device=device), bt.sum())

    return _cached(("mac", b.tobytes(), torch.device(device)), build)


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
        """deltas [U, 2N], beta [U] -> eq.(17)-rescaled estimate [2N]."""
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


class _NotPortedBackend(ChannelBackend):
    """A backend of the JAX package the port has not reached yet."""

    def __init__(self, name: str, roadmap: str):
        self.name = name
        self.roadmap = roadmap

    def _raise(self):
        raise NotImplementedError(
            f"channel backend {self.name!r} is not ported yet "
            f"(ROADMAP queue A, {self.roadmap})")

    def cluster(self, key, deltas, topo, P_t, cfg):
        self._raise()

    def mac(self, key, deltas, beta, K, sigma_h2, sigma_z2, P, cfg):
        self._raise()


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
# "fused": on-the-fly channel generation inside the kernel
# ---------------------------------------------------------------------------

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
        est = y / K / (P_t * topo.sigma_h2 * bb[:, None])
        return unpack_cx(est)

    def mac(self, key, deltas, beta, K, sigma_h2, sigma_z2, P, cfg):
        tx = pack_cx(deltas)
        amp, w, b_bar = _mac_geometry(beta, deltas.device)
        y = fused_combine(_seed_words(key), P * tx, amp, w, K=K,
                          sigma_h2=sigma_h2, sigma_z2=sigma_z2)[0]
        return unpack_cx(y / K / (P * sigma_h2 * b_bar))


register_backend(_NotPortedBackend("reference", "item 3 (channel layer)"))
register_backend(EquivalentBackend())
register_backend(_NotPortedBackend("slab_kernel", "item 8 (slab backend)"))
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


def orthogonal_cluster_ota(key, deltas, topo, P_t, cfg=OTAConfig()):
    """Per-user orthogonalized cluster hop (robust-aggregation substrate):
    not ported yet."""
    raise NotImplementedError(
        "orthogonal_cluster_ota is not ported yet (ROADMAP queue A, "
        "item 7: participation and robustness)")
