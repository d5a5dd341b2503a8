"""OTA matched-filter combine over a materialized channel slab.

    y[b, n] = sum_k conj(sum_u w[b,u] h[b,u,k,n])
                    * (sum_u h[b,u,k,n] t[u,n] + z[b,k,n])

h: complex64 [B, U, K, N] (or [U, K, N]); t: complex64 [U, N], shared by
the B receiving stations; z: complex64 [B, K, N] (or [K, N]); w: float32
[B, U] (or [U]) matched-filter weights.  The result is complex64 [B, N]
(or [N]), un-rescaled: the caller divides by K and applies the
eq. (12)/(17) normalization.  An unbatched call runs as B = 1.

S seeds run in one launch with a leading seed axis on every operand:
h [S, B, U, K, N], t [S, U, N], z [S, B, K, N], w [S, B, U] -> y
[S, B, N].  Each operand is contiguous past its seed axis, whose stride
may be 0 (one block shared by every seed, as the matched-filter weights
are), and seed s's rows equal the launch with seed s's operands alone
bit for bit.  This is how the sweep's ``batch="vmap"`` seeds reach the
kernel (`repro_torch.kernels.ops.mf_combine`).

Two implementations of that one function live here:

- `ota_combine`, the wrapper: on CUDA tensors it launches the
  hand-written Hopper kernel ``csrc/ota_combine.cu`` (and counts the
  launch in ``ota_combine.launches``); on CPU tensors it runs
  `ota_combine_plain`.  It chooses by the device of its inputs and by
  nothing else.
- `ota_combine_plain`, the plain PyTorch version: the `torch.einsum`
  composition of the JAX package's oracles `ota_combine_ref` and
  `ota_combine_ref_batched`.  The CPU tests hold it to the JAX kernels,
  and the card's smoke run holds the CUDA kernel to it.

The kernel reads the interleaved complex64 tensors as they are; a
``.real`` view of a slab is strided, and making it contiguous would cost
a read and a write of the whole slab.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.fused_mac import seed_stride


def _seeded(h, t, z, w):
    """The four operands in the seed-batched layout [S, B, ...] (views),
    and how many leading axes the call had: 0 ([U, K, N]), 1 ([B, U, K,
    N]) or 2 ([S, B, U, K, N])."""
    if h.dim() == 3:
        return h[None, None], t[None], z[None, None], w[None, None], 0
    if h.dim() == 4:
        return h[None], t[None], z[None], w[None], 1
    return h, t, z, w, 2


def _unseeded(y, lead: int):
    """The result [S, B, N] in the layout of a call with `lead` leading
    axes (`_seeded`)."""
    return y if lead == 2 else y[0] if lead == 1 else y[0, 0]


def _check(h, t, z, w) -> None:
    if h.dim() != 5:
        raise ValueError(f"h must be [U, K, N], [B, U, K, N] or "
                         f"[S, B, U, K, N], got {tuple(h.shape)}")
    S, B, U, K, N = h.shape
    want = {"h": (h, torch.complex64, (S, B, U, K, N)),
            "t": (t, torch.complex64, (S, U, N)),
            "z": (z, torch.complex64, (S, B, K, N)),
            "w": (w, torch.float32, (S, B, U))}
    for name, (x, dtype, shape) in want.items():
        if x.dtype != dtype or tuple(x.shape) != shape:
            raise ValueError(f"{name} must be {dtype} {shape}, got "
                             f"{x.dtype} {tuple(x.shape)}")
        seed_stride(x, name)
        if x.is_conj():
            raise ValueError(f"{name} has a pending conjugation")
        if x.device != h.device:
            raise ValueError(f"{name} is on {x.device}, h on {h.device}")
    if min(U, K) < 1 or max(S, B) > 65535:
        raise ValueError(f"need U, K >= 1 and S, B <= 65535, got "
                         f"{(S, B, U, K, N)}")


@functools.lru_cache(maxsize=None)
def _kernel_fn():
    """The kernel's C entry point, built and typed once per process."""
    fn = build.load("ota_combine").ota_combine_launch
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
                   + [ctypes.c_longlong] * 4 + [ctypes.c_void_p])
    return fn


def ota_combine(h: torch.Tensor, t: torch.Tensor, z: torch.Tensor,
                w: torch.Tensor) -> torch.Tensor:
    """The combine on the inputs' device: the CUDA kernel for CUDA
    tensors, the plain version for CPU tensors; any other device
    raises.  One launch for every seed and rx station."""
    hs, ts, zs, ws, lead = _seeded(h, t, z, w)
    _check(hs, ts, zs, ws)
    dev = hs.device
    if dev.type == "cpu":
        return ota_combine_plain(h, t, z, w)
    if dev.type != "cuda":
        raise ValueError(f"ota_combine runs on cpu or cuda tensors, got "
                         f"{dev}")
    S, B, U, K, N = hs.shape
    y = torch.empty((S, B, N), dtype=torch.complex64, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = _kernel_fn()(hs.data_ptr(), ts.data_ptr(), zs.data_ptr(),
                           ws.data_ptr(), y.data_ptr(), S, B, U, K, N,
                           *(seed_stride(x, "") for x in (hs, ts, zs, ws)),
                           stream)
    if err != 0:
        raise RuntimeError(f"ota_combine kernel launch failed: CUDA "
                           f"error {err}")
    ota_combine.launches += 1
    return _unseeded(y, lead)


ota_combine.launches = 0


def ota_combine_plain(h: torch.Tensor, t: torch.Tensor, z: torch.Tensor,
                      w: torch.Tensor) -> torch.Tensor:
    """The kernel's function in complex `torch.einsum`s, on any device:
    r = sum_u h t + z, mf = sum_u w h, y = sum_k conj(mf) r; in the
    layouts `ota_combine` takes, a leading seed axis included."""
    hs, ts, zs, ws, lead = _seeded(h, t, z, w)
    r = torch.einsum("sbukn,sun->sbkn", hs, ts) + zs
    mf = torch.einsum("sbu,sbukn->sbkn", ws.to(torch.complex64), hs)
    return _unseeded(torch.sum(torch.conj(mf) * r, dim=2), lead)
