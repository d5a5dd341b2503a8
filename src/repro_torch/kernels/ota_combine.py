"""OTA matched-filter combine over a materialized channel slab.

    y[b, n] = sum_k conj(sum_u w[b,u] h[b,u,k,n])
                    * (sum_u h[b,u,k,n] t[u,n] + z[b,k,n])

h: complex64 [B, U, K, N] (or [U, K, N]); t: complex64 [U, N], shared by
the B receiving stations; z: complex64 [B, K, N] (or [K, N]); w: float32
[B, U] (or [U]) matched-filter weights.  The result is complex64 [B, N]
(or [N]), un-rescaled: the caller divides by K and applies the
eq. (12)/(17) normalization.  An unbatched call runs as B = 1.

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


def _batched(h, t, z, w):
    """The four operands in the batched layout (views), and whether the
    call was batched."""
    if h.dim() == 3:
        return h[None], t, z[None], w[None], False
    return h, t, z, w, True


def _check(h, t, z, w) -> None:
    if h.dim() != 4:
        raise ValueError(f"h must be [U, K, N] or [B, U, K, N], got "
                         f"{tuple(h.shape)}")
    B, U, K, N = h.shape
    want = {"h": (h, torch.complex64, (B, U, K, N)),
            "t": (t, torch.complex64, (U, N)),
            "z": (z, torch.complex64, (B, K, N)),
            "w": (w, torch.float32, (B, U))}
    for name, (x, dtype, shape) in want.items():
        if x.dtype != dtype or tuple(x.shape) != shape:
            raise ValueError(f"{name} must be {dtype} {shape}, got "
                             f"{x.dtype} {tuple(x.shape)}")
        if not x.is_contiguous() or x.is_conj():
            raise ValueError(f"{name} must be a contiguous tensor with no "
                             f"pending conjugation")
        if x.device != h.device:
            raise ValueError(f"{name} is on {x.device}, h on {h.device}")
    if min(U, K) < 1 or B > 65535:
        raise ValueError(f"need U, K >= 1 and B <= 65535, got "
                         f"{(B, U, K, N)}")


@functools.lru_cache(maxsize=None)
def _kernel_fn():
    """The kernel's C entry point, built and typed once per process."""
    fn = build.load("ota_combine").ota_combine_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [
        ctypes.c_void_p]
    return fn


def ota_combine(h: torch.Tensor, t: torch.Tensor, z: torch.Tensor,
                w: torch.Tensor) -> torch.Tensor:
    """The combine on the inputs' device: the CUDA kernel for CUDA
    tensors, the plain version for CPU tensors; any other device
    raises."""
    hb, tb, zb, wb, batched = _batched(h, t, z, w)
    _check(hb, tb, zb, wb)
    dev = hb.device
    if dev.type == "cpu":
        y = ota_combine_plain(hb, tb, zb, wb)
    elif dev.type == "cuda":
        B, U, K, N = hb.shape
        y = torch.empty((B, N), dtype=torch.complex64, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        with torch.cuda.device(dev):
            err = _kernel_fn()(hb.data_ptr(), tb.data_ptr(), zb.data_ptr(),
                               wb.data_ptr(), y.data_ptr(), B, U, K, N,
                               stream)
        if err != 0:
            raise RuntimeError(f"ota_combine kernel launch failed: CUDA "
                               f"error {err}")
        ota_combine.launches += 1
    else:
        raise ValueError(f"ota_combine runs on cpu or cuda tensors, got "
                         f"{dev}")
    return y if batched else y[0]


ota_combine.launches = 0


def ota_combine_plain(h: torch.Tensor, t: torch.Tensor, z: torch.Tensor,
                      w: torch.Tensor) -> torch.Tensor:
    """The kernel's function in complex `torch.einsum`s, on any device:
    r = sum_u h t + z, mf = sum_u w h, y = sum_k conj(mf) r."""
    hb, tb, zb, wb, batched = _batched(h, t, z, w)
    r = torch.einsum("bukn,un->bkn", hb, tb) + zb
    mf = torch.einsum("bu,bukn->bkn", wb.to(torch.complex64), hb)
    y = torch.sum(torch.conj(mf) * r, dim=1)
    return y if batched else y[0]
