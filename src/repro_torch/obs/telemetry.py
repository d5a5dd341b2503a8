"""Per-round in-program diagnostics (the paper's physical-layer view).

The port's copy of the JAX package's `repro.obs.telemetry`: the same
fields, shapes and formulas.  The round body
(`repro_torch.core.whfl.make_round_body`, which both engines run) calls
in with values it already holds -- the users' precoded flat deltas, the
fold's output, the round's attendance mask -- so telemetry adds no hop
and no host read; both drivers fetch the block with the eval metrics.

Field glossary (paper symbols; all float32, shapes ``()`` or ``[C]``):

- ``attendance`` -- the realized fraction of users transmitting this
  round (the mean of the participation mask; 1 at full attendance).
- ``symbol_energy_edge`` -- per-cluster mean per-symbol transmit energy
  of the MU -> IS hop, ``P_t^2 mean_m ||Delta_{c,m}||^2 / N``.
- ``rx_power`` -- matched-filter receive signal power at IS c,
  ``P_t^2 sum_m beta_{c,m,c} ||Delta_{c,m}||^2 / N``.
- ``snr`` -- ``rx_power / sigma_z^2``.
- ``noise_floor`` -- the cluster estimate's effective per-entry noise
  variance after matched filtering and normalization,
  ``sigma_z^2 / (P_t^2 sigma_h^2 beta_bar_c K)``.
- ``grad_norm_pre`` -- ``||mean_m Delta_{c,m}||_2``, the norm of the
  noiseless full-attendance cluster mean.
- ``grad_norm_post`` -- ``||est_c||_2``, the realized estimate's norm.
- ``grad_ratio`` -- ``grad_norm_post / grad_norm_pre`` (0 where the
  pre-norm is 0).
- ``symbol_energy_is`` / ``snr_is`` -- the same energy and receive SNR
  for the IS -> PS hop (zero in conventional mode, which has no second
  hop).

Conventional (single-hop) mode keeps the ``[C]`` layout: the per-user
sums run against the PS geometry (``beta_mu_ps``, ``K_ps``), and the
scalar PS-side quantities (``noise_floor``, ``grad_norm_post``) are
broadcast over clusters.

The JAX package passes these inputs through an optimization barrier so
that XLA cannot fuse the extra reads into the round and change its
rounding.  The port runs eagerly (or replays the eager ops as a CUDA
graph): no compiler fuses across ops, so the diagnostics only read the
round's tensors and no barrier is needed.
"""
from __future__ import annotations

from typing import TYPE_CHECKING, Dict, Optional

import numpy as np
import torch

if TYPE_CHECKING:   # the round body (repro_torch.core) imports this module
    from repro_torch.core.topology import Topology

TELEMETRY_KEYS = (
    "attendance", "symbol_energy_edge", "rx_power", "snr",
    "noise_floor", "grad_norm_pre", "grad_norm_post", "grad_ratio",
    "symbol_energy_is", "snr_is",
)
EDGE_KEYS = TELEMETRY_KEYS[:8]
IS_KEYS = TELEMETRY_KEYS[8:]

_f32 = torch.float32


def edge_telemetry_init(C: int, device=None) -> Dict[str, torch.Tensor]:
    """The zero cluster-hop block, shaped as `cluster_telemetry`'s."""
    z = torch.zeros((), dtype=_f32, device=device)
    zc = torch.zeros((C,), dtype=_f32, device=device)
    return {"attendance": z, "symbol_energy_edge": zc, "rx_power": zc,
            "snr": zc, "noise_floor": zc, "grad_norm_pre": zc,
            "grad_norm_post": zc, "grad_ratio": zc}


def is_telemetry_zero(device=None) -> Dict[str, torch.Tensor]:
    """The zero IS -> PS block (also conventional mode's value)."""
    z = torch.zeros((), dtype=_f32, device=device)
    return {"symbol_energy_is": z, "snr_is": z}


def telemetry_init(C: int, device=None) -> Dict[str, torch.Tensor]:
    """The full zero block `init_round_state` seeds the state with."""
    return {**edge_telemetry_init(C, device), **is_telemetry_zero(device)}


def cluster_telemetry(flat: torch.Tensor, est: torch.Tensor,
                      claimed: Optional[torch.Tensor], topo: "Topology",
                      P_t, mode: str = "whfl") -> Dict[str, torch.Tensor]:
    """Cluster-hop diagnostics from one round's values.

    flat: the users' flat deltas [C, M, 2N] after any precoding (so the
    energies are what was sent); est: the fold's output, [C, 2N], or
    the global [2N] estimate in ``mode="conventional"``; claimed: the
    round's [C, M] attendance mask, or None at full attendance.
    """
    from repro_torch.core.channel import _const
    C, M, two_n = flat.shape
    N = two_n // 2
    dev = flat.device
    P = torch.as_tensor(P_t, dtype=_f32, device=dev)
    E = torch.sum(torch.square(flat), dim=-1)                  # [C, M]
    if mode == "conventional":
        beta = _const(np.asarray(topo.beta_mu_ps), dev)
        bb = float(np.float32(np.asarray(topo.beta_mu_ps).sum()))
        K = float(topo.K_ps)
        post = torch.sqrt(torch.sum(torch.square(est), dim=-1)).expand(C)
    else:
        beta = _const(np.asarray(topo.beta_own), dev)
        bb = _const(np.asarray(topo.beta_bar_c), dev)          # [C]
        K = float(topo.K)
        post = torch.sqrt(torch.sum(torch.square(est), dim=-1))  # [C]
    P2 = P ** 2
    rx = P2 * torch.sum(beta * E, dim=-1) / N                  # [C]
    sz2 = float(np.float32(topo.sigma_z2))
    # a tensor numerator: `float / tensor` would multiply by a reciprocal
    nf = (torch.full((), sz2, dtype=_f32, device=dev)
          / (P2 * float(np.float32(topo.sigma_h2)) * bb * K)).expand(C)
    pre = torch.sqrt(torch.sum(torch.square(torch.mean(flat, dim=1)),
                               dim=-1))
    att = (torch.mean(claimed) if claimed is not None
           else torch.ones((), dtype=_f32, device=dev))
    pos = pre > 0
    return {
        "attendance": att.to(_f32),
        "symbol_energy_edge": P2 * torch.mean(E, dim=-1) / N,
        "rx_power": rx,
        "snr": rx / sz2,
        "noise_floor": nf.contiguous(),
        "grad_norm_pre": pre,
        "grad_norm_post": post.contiguous(),
        "grad_ratio": torch.where(
            pos, post / torch.where(pos, pre, torch.ones_like(pre)),
            torch.zeros_like(pre)),
    }


def is_telemetry(is_deltas: torch.Tensor, topo: "Topology",
                 P_is_t) -> Dict[str, torch.Tensor]:
    """IS -> PS hop diagnostics from the IS deltas [C, 2N]."""
    from repro_torch.core.channel import _const
    N = is_deltas.shape[1] // 2
    dev = is_deltas.device
    P2 = torch.as_tensor(P_is_t, dtype=_f32, device=dev) ** 2
    E = torch.sum(torch.square(is_deltas), dim=-1)             # [C]
    beta = _const(np.asarray(topo.beta_is), dev)
    sz2 = float(np.float32(topo.sigma_z2))
    return {"symbol_energy_is": P2 * torch.mean(E) / N,
            "snr_is": P2 * torch.sum(beta * E) / (N * sz2)}


def pack(tele: Dict[str, torch.Tensor]) -> torch.Tensor:
    """One block as a flat float32 vector in `TELEMETRY_KEYS` order
    (how it rides with the eval metrics)."""
    return torch.cat([tele[k].reshape(-1) for k in TELEMETRY_KEYS])


def unpack(vec, C: int) -> Dict[str, np.ndarray]:
    """Inverse of `pack` on the host: float32 scalars and [C] arrays."""
    vec = np.asarray(vec, np.float32)
    out, off = {}, 0
    for k in TELEMETRY_KEYS:
        n = C if k in EDGE_KEYS[1:] else 1
        out[k] = vec[off] if n == 1 else vec[off:off + n]
        off += n
    return out


def summarize(tele: Dict) -> Dict:
    """Scalar (mean over everything) view of one block: what the run
    journal emits per eval window."""
    return {k: float(np.mean(np.asarray(tele[k]))) for k in TELEMETRY_KEYS
            if k in tele}
