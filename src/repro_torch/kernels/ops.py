"""Public wrapper the channel backends call for the fused combine."""
from __future__ import annotations

import torch

from repro_torch.kernels.fused_mac import fused_mac


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
