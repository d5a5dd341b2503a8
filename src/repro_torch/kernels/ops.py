"""Public wrappers the channel backends call for the OTA combines.

Each is a `torch.library.custom_op` over a leading seed axis
(``repro_torch::fused_combine``, ``repro_torch::mf_combine``) with a
`torch.func.vmap` rule, so a hop run under a seed vmap (the sweep's
``batch="vmap"``, `repro_torch.core.channel.vmap_seeds`) reaches the
kernel as one launch for all seeds: the rule moves the vmapped axis to
the front, folds it into the op's seed axis (an operand the vmap does
not batch is expanded with stride 0, never copied) and calls the op
once.  On CUDA tensors the op launches the kernel, on CPU tensors it
runs the plain version, both seed-batched.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.fused_mac import fused_mac
from repro_torch.kernels.ota_combine import ota_combine
from repro_torch.prng import as_words


def _seed_fold_rule(op, n_tensors: int):
    """The vmap rule of a seed-batched op whose first `n_tensors`
    arguments carry a leading seed axis: the vmapped axis (size V) is
    folded into it, [V, S, ...] -> [V * S, ...], and the result is split
    back, [V * S, ...] -> [V, S, ...], batched at 0."""
    def rule(info, in_dims, *args):
        dims = in_dims[:n_tensors]
        if all(d is None for d in dims):
            return op(*args), None
        V = info.batch_size
        folded = []
        for x, d in zip(args[:n_tensors], dims):
            x = x.expand(V, *x.shape) if d is None else x.movedim(d, 0)
            folded.append(x.reshape(V * x.shape[1], *x.shape[2:]))
        y = op(*folded, *args[n_tensors:])
        return y.reshape(V, -1, *y.shape[1:]), 0
    return rule


def _per_seed(x: torch.Tensor) -> torch.Tensor:
    """`x` contiguous past its seed axis; a seed axis of stride 0 (one
    block for every seed) stays so."""
    if x.shape[0] > 1 and x.stride(0) == 0:
        return x[0].contiguous().expand(x.shape)
    return x.contiguous()


@torch.library.custom_op("repro_torch::fused_combine", mutates_args=())
def _fused_combine(seed: torch.Tensor, t: torch.Tensor, amp: torch.Tensor,
                   w: torch.Tensor, K: int, sigma_h2: float, sigma_z2: float,
                   rx_base: int, n_base: int, u_base: int,
                   block_u: int) -> torch.Tensor:
    """`fused_mac` over S seeds: seed [S, 2], t complex64 [S, U, N], amp
    and w [S, B, U] -> complex64 [S, B, N]."""
    y_re, y_im = fused_mac(seed, _per_seed(t.real), _per_seed(t.imag),
                           _per_seed(amp), _per_seed(w), K=K,
                           sigma_h2=sigma_h2, sigma_z2=sigma_z2,
                           rx_base=rx_base, u_base=u_base, n_base=n_base,
                           block_u=block_u)
    return torch.complex(y_re, y_im)


_fused_combine.register_vmap(_seed_fold_rule(_fused_combine, 4))


@torch.library.custom_op("repro_torch::mf_combine", mutates_args=())
def _mf_combine(h: torch.Tensor, t: torch.Tensor, z: torch.Tensor,
                w: torch.Tensor) -> torch.Tensor:
    """`ota_combine` over S seeds: h [S, B, U, K, N], t [S, U, N], z
    [S, B, K, N], w [S, B, U] -> [S, B, N]."""
    return ota_combine(*(_per_seed(x) for x in (h, t, z, w)))


_mf_combine.register_vmap(_seed_fold_rule(_mf_combine, 4))


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
    one = h.dim() == 3
    if one:
        h, z, w = h[None], z[None], w[None]
    y = _mf_combine(h[None], t[None], z[None], w[None])[0]
    return y[0] if one else y


def fused_combine(seed, t: torch.Tensor, amp: torch.Tensor,
                  w: torch.Tensor, *, K: int, sigma_h2: float,
                  sigma_z2: float, rx_base: int = 0, n_base: int = 0,
                  u_base: int = 0, block_u: int = 32) -> torch.Tensor:
    """Fused combine over on-the-fly channels (no [U, K, N] slab).

    seed: the two counter-PRNG seed words (an int64 tensor [2]); t:
    complex64 [U, N] transmit symbols (pre-scaled by P); amp: float32
    [B, U] channel amplitudes; w: float32 [B, U] matched-filter weights.
    Returns complex64 [B, N], the un-rescaled eq. (9)/(16) combine per
    rx station.
    """
    seed = as_words(seed, t.device).reshape(-1)[:2]
    return _fused_combine(seed[None], t[None], amp[None], w[None], int(K),
                          float(sigma_h2), float(sigma_z2), int(rx_base),
                          int(n_base), int(u_base), int(block_u))[0]
