"""Public wrappers the channel backends call for the OTA combines."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.fused_mac import fused_mac
from repro_torch.kernels.ota_combine import ota_combine


def mf_combine(h: torch.Tensor, t: torch.Tensor, z: torch.Tensor,
               w: Optional[torch.Tensor] = None) -> torch.Tensor:
    """y[n] = sum_k conj(sum_u w_u h[u,k,n]) (sum_u h[u,k,n] t[u,n] + z[k,n]).

    The slab path (``backend="slab_kernel"``).  h: complex64 [U, K, N]
    (or [B, U, K, N] for B rx stations sharing the transmit symbols);
    t: complex64 [U, N]; z: complex64 [K, N] (or [B, K, N]); w: float32
    [U] (or [B, U]) matched-filter weights, all ones when None.  Returns
    complex64 [N] (or [B, N]).
    """
    if w is None:
        w = torch.ones(h.shape[:-2], dtype=torch.float32, device=h.device)
    return ota_combine(h, t, z, w)


def fused_combine(seed, t: torch.Tensor, amp: torch.Tensor,
                  w: torch.Tensor, *, K: int, sigma_h2: float,
                  sigma_z2: float, rx_base: int = 0, n_base: int = 0,
                  u_base: int = 0, block_u: int = 32) -> torch.Tensor:
    """Fused combine over on-the-fly channels (no [U, K, N] slab).

    seed: the two counter-PRNG seed words; t: complex64 [U, N] transmit
    symbols (pre-scaled by P); amp: float32 [B, U] channel amplitudes;
    w: float32 [B, U] matched-filter weights.  Returns complex64 [B, N],
    the un-rescaled eq. (9)/(16) combine per rx station.
    """
    y_re, y_im = fused_mac(seed, t.real.contiguous(), t.imag.contiguous(),
                           amp, w, K=K, sigma_h2=sigma_h2,
                           sigma_z2=sigma_z2, rx_base=rx_base,
                           u_base=u_base, n_base=n_base, block_u=block_u)
    return torch.complex(y_re, y_im)
