"""Fused OTA matched-filter combine with in-kernel channel generation.

    y[b, n] = sum_k conj(sum_u w[b,u] h[b,u,k,n])
                    * (sum_u h[b,u,k,n] t[u,n] + z[b,k,n])

with h = amp[b,u] * g, g ~ CN(0, sigma_h2) and z ~ CN(0, sigma_z2) drawn
from the threefry2x32 counter PRNG (`repro_torch.prng`): no [U, K, N]
channel tensor is ever materialized.

Three implementations of that one function live here:

- `fused_mac`, the wrapper: on CUDA tensors it launches the hand-written
  Hopper kernel ``csrc/fused_mac.cu`` (and counts the launch in
  ``fused_mac.launches``); on CPU tensors it runs `fused_mac_plain`.  It
  chooses by the device of its inputs and by nothing else.
- `fused_mac_plain`, the plain PyTorch version: the same draws and the
  same arithmetic in torch ops, looping over u-blocks so its memory is
  O(B * block_u * K * N).  The CPU tests hold it to the JAX kernel, and
  the card's smoke run holds the CUDA kernel to it.
- `fused_mac_ref`, the einsum oracle that materializes every draw.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from repro_torch import prng
from repro_torch.kernels import build
from repro_torch.prng import (MASK32, _TAG_CHAN, _TAG_NOISE, _cx_normal,
                              _k_stride, _mul32, _stream_keys, as_words)


def canonical_block_u(M: int, cap: int = 1024) -> int:
    """The u-block size every fused cluster-hop path shares: a pure
    function of the per-cluster user count M that always divides M and
    halves down from M only while above `cap`."""
    bu = max(int(M), 1)
    while bu > cap and bu % 2 == 0:
        bu //= 2
    return bu


def _sigmas(sigma_h2: float, sigma_z2: float):
    return float(np.sqrt(sigma_h2 / 2.0)), float(np.sqrt(sigma_z2 / 2.0))


def _check(t_re, t_im, amp, w, K: int):
    if K < 1:
        raise ValueError(f"K must be >= 1, got {K}")
    for name, x in (("t_re", t_re), ("t_im", t_im), ("amp", amp), ("w", w)):
        if (x.dtype != torch.float32 or x.dim() != 2
                or not x.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous 2-D float32 "
                             f"tensor, got {x.dtype} {tuple(x.shape)}")
        if x.device != t_re.device:
            raise ValueError(f"{name} is on {x.device}, t_re on "
                             f"{t_re.device}")
    if t_im.shape != t_re.shape:
        raise ValueError(f"t_im {tuple(t_im.shape)} != t_re "
                         f"{tuple(t_re.shape)}")
    if w.shape != amp.shape or amp.shape[1] != t_re.shape[0]:
        raise ValueError(f"amp {tuple(amp.shape)} and w {tuple(w.shape)} "
                         f"must be [B, U] with U = {t_re.shape[0]}")


@functools.lru_cache(maxsize=64)
def _base_words(rx_base: int, u_base: int, n_base: int,
                device: torch.device) -> torch.Tensor:
    """(rx_base, u_base, n_base, 0, 0, 0) as the uint32 bit patterns of
    an int32 device tensor, uploaded once per bases and device."""
    words = np.array([rx_base, u_base, n_base, 0, 0, 0],
                     np.int64) & MASK32
    return torch.as_tensor(words.astype(np.uint32).view(np.int32),
                           device=device)


def _launch_words(seed, rx_base, u_base, n_base, device) -> torch.Tensor:
    """(s0, s1, rx_base, u_base, n_base, 0, 0, 0) as the uint32 bit
    patterns of an int32 device tensor.  The seed words stay on the
    device: the low 32-bit half of each little-endian int64 word is that
    word's bit pattern, so a view selects it and one `cat` joins it to
    the cached bases."""
    s = as_words(seed, device).reshape(-1)[:2].contiguous()
    return torch.cat([s.view(torch.int32)[0::2],
                      _base_words(int(rx_base), int(u_base), int(n_base),
                                  torch.device(device))])


@functools.lru_cache(maxsize=None)
def _kernel_fn():
    """The kernel's C entry point, built and typed once per process."""
    fn = build.load("fused_mac").fused_mac_launch
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 4
                   + [ctypes.c_float] * 2 + [ctypes.c_void_p])
    return fn


def fused_mac(seed, t_re: torch.Tensor, t_im: torch.Tensor,
              amp: torch.Tensor, w: torch.Tensor, *, K: int,
              sigma_h2: float, sigma_z2: float, rx_base: int = 0,
              u_base: int = 0, n_base: int = 0, block_u: int = 32):
    """Fused OTA combine over K on-the-fly Rayleigh antennas.

    seed: the two uint32 seed words (int64 tensor [2] on the inputs'
    device, or anything `prng.as_words` takes); t_re, t_im: float32
    [U, N] transmit symbols (pre-scaled by P); amp, w: float32 [B, U].
    Returns (y_re, y_im), each float32 [B, N], un-rescaled.  The counter
    bases shift the global (rx, u, n) indices of the draws.  `block_u`
    is the plain version's u-blocking (the CUDA kernel walks every u in
    one loop); it changes float summation order only, never a draw.
    """
    _check(t_re, t_im, amp, w, K)
    dev = t_re.device
    if dev.type == "cpu":
        return fused_mac_plain(seed, t_re, t_im, amp, w, K=K,
                               sigma_h2=sigma_h2, sigma_z2=sigma_z2,
                               rx_base=rx_base, u_base=u_base,
                               n_base=n_base, block_u=block_u)
    if dev.type != "cuda":
        raise ValueError(f"fused_mac runs on cpu or cuda tensors, got {dev}")
    B, U = amp.shape
    N = t_re.shape[1]
    words = _launch_words(seed, rx_base, u_base, n_base, dev)
    y_re = torch.empty((B, N), dtype=torch.float32, device=dev)
    y_im = torch.empty((B, N), dtype=torch.float32, device=dev)
    s_h, s_z = _sigmas(sigma_h2, sigma_z2)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = _kernel_fn()(words.data_ptr(), t_re.data_ptr(),
                           t_im.data_ptr(), amp.data_ptr(), w.data_ptr(),
                           y_re.data_ptr(), y_im.data_ptr(), B, U, K, N,
                           s_h, s_z, stream)
    if err != 0:
        raise RuntimeError(f"fused_mac kernel launch failed: CUDA error "
                           f"{err}")
    fused_mac.launches += 1
    return y_re, y_im


fused_mac.launches = 0


def fused_mac_plain(seed, t_re, t_im, amp, w, *, K: int, sigma_h2: float,
                    sigma_z2: float, rx_base: int = 0, u_base: int = 0,
                    n_base: int = 0, block_u: int = 32):
    """The kernel's function in plain torch ops, on any device.

    r starts from the noise z and mf from zero; both accumulate over
    u-blocks of `block_u` users in ascending order, then
    ``y = sum_k conj(mf) * r``.  Same counters, same keys, same
    Box-Muller as the CUDA kernel and the JAX reference."""
    dev = t_re.device
    s = as_words(seed, dev).reshape(-1)[:2]
    B, U = amp.shape
    N = t_re.shape[1]
    s_h, s_z = _sigmas(sigma_h2, sigma_z2)
    rx = (torch.arange(B, device=dev) + rx_base)[:, None, None]
    kk = torch.arange(K, device=dev)[None, :, None]
    nn = (torch.arange(N, device=dev) + n_base)[None, None, :]
    zk0, zk1 = _stream_keys(s[0], s[1], rx, _TAG_NOISE)
    r_re, r_im = _cx_normal(zk0, zk1, kk, nn, s_z)             # [B, K, N]
    mf_re = torch.zeros_like(r_re)
    mf_im = torch.zeros_like(r_im)
    hk0, hk1 = _stream_keys(s[0], s[1], rx[..., None], _TAG_CHAN)
    bu = max(1, min(int(block_u), U))
    kstride = _k_stride(K)
    for u0 in range(0, U, bu):
        u1 = min(u0 + bu, U)
        uu = torch.arange(u0, u1, device=dev) + u_base
        w0 = (_mul32(uu, kstride)[:, None, None] + kk) & MASK32  # [bu,K,1]
        g_re, g_im = _cx_normal(hk0, hk1, w0[None], nn[None], s_h)
        a = amp[:, u0:u1, None, None]
        wa = (w[:, u0:u1] * amp[:, u0:u1])[:, :, None, None]
        h_re, h_im = a * g_re, a * g_im                  # [B, bu, K, N]
        tr = t_re[None, u0:u1, None, :]
        ti = t_im[None, u0:u1, None, :]
        r_re += (h_re * tr - h_im * ti).sum(1)
        r_im += (h_re * ti + h_im * tr).sum(1)
        mf_re += (wa * g_re).sum(1)
        mf_im += (wa * g_im).sum(1)
    y_re = (mf_re * r_re + mf_im * r_im).sum(1)
    y_im = (mf_re * r_im - mf_im * r_re).sum(1)
    return y_re, y_im


def fused_mac_ref(seed, t_re, t_im, amp, w, *, K: int, sigma_h2: float,
                  sigma_z2: float, rx_base: int = 0, u_base: int = 0,
                  n_base: int = 0):
    """Einsum oracle: materializes the same draws (`prng.fused_channels`)
    and folds them the slab way.  O(B*U*K*N) memory."""
    U, N = t_re.shape
    B = amp.shape[0]
    g, z = prng.fused_channels(as_words(seed, t_re.device), B, U, K, N,
                               sigma_h2, sigma_z2, rx_base=rx_base,
                               u_base=u_base, n_base=n_base)
    t = torch.complex(t_re, t_im)
    h = amp.to(torch.complex64)[:, :, None, None] * g
    r = torch.einsum("bukn,un->bkn", h, t) + z
    mf = torch.einsum("bu,bukn->bkn", w.to(torch.complex64), h)
    y = torch.sum(torch.conj(mf) * r, dim=1)
    return y.real.contiguous(), y.imag.contiguous()
