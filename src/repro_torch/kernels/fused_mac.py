"""Fused OTA matched-filter combine with in-kernel channel generation.

    y[b, n] = sum_k conj(sum_u w[b,u] h[b,u,k,n])
                    * (sum_u h[b,u,k,n] t[u,n] + z[b,k,n])

with h = amp[b,u] * g, g ~ CN(0, sigma_h2) and z ~ CN(0, sigma_z2) drawn
from the threefry2x32 counter PRNG (`repro_torch.prng`): no [U, K, N]
channel tensor is ever materialized.

The users are summed in u-blocks of `block_u`: r starts at the noise z
and mf at 0, and each block's sum (from 0, users ascending) is added to
them in ascending block order.  The same sum can be split in two, which
is how the u-sharded cluster hop runs it over tiles of the user axis:

- `fused_mac_partials` writes each block's pre-contraction sums
  ``pr = sum h t`` and ``pm = sum w h`` ([B, G, K, N] each, no noise);
- `fused_partials_reduce` draws z, folds the blocks in order and
  contracts over k.  On the card it gives `fused_mac`'s y bit for bit
  (the three kernels of ``csrc/fused_mac.cu`` share the per-block sum,
  the noise draw and the finalize); on the CPU the plain versions share
  `_block_sums`, `fused_noise` and `_finalize` and agree the same way.

`fused_mac` and its plain version also take S seeds at once: seed
words [S, 2], transmit symbols [S, U, N] and gains [S, B, U] give y
[S, B, N] in one launch, each seed's rows bit for bit those of its own
unbatched launch (the seed axis of a gain may have stride 0, one block
shared by every seed).  This is how the sweep's ``batch="vmap"`` seeds
reach the kernel (`repro_torch.kernels.ops.fused_combine`).  The
partials and the fold serve the sharded engine, which runs seeds one by
one, and take one seed.

Each kernel has a wrapper and a plain version:

- the wrapper (`fused_mac`, `fused_mac_partials`,
  `fused_partials_reduce`): on CUDA tensors it launches the hand-written
  Hopper kernel (and counts the launch in its ``launches``); on CPU
  tensors it runs the plain version.  It chooses by the device of its
  inputs and by nothing else.
- the plain PyTorch version (`fused_mac_plain`,
  `fused_mac_partials_plain`, `fused_partials_reduce_plain`): the same
  draws and the same arithmetic in torch ops, one u-block at a time, so
  its memory is O(B * block_u * K * N).  The CPU tests hold it to the
  JAX package, and the card's smoke run holds the kernel to it.

`fused_mac_ref` is the einsum oracle that materializes every draw.
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


def _sigma(var: float) -> float:
    return float(np.sqrt(var / 2.0))


def seed_stride(x: torch.Tensor, name: str) -> int:
    """The stride of `x`'s leading seed axis, for a kernel that reads
    seed s's block at s times it: `x` must be contiguous past that axis,
    and the stride is 0 (one block shared by every seed) or one block."""
    inner = x[0] if x.shape[0] else x
    block = inner.numel()
    if not inner.is_contiguous() or (x.shape[0] > 1
                                     and x.stride(0) not in (0, block)):
        raise ValueError(f"{name} {tuple(x.shape)} must be contiguous "
                         f"past its seed axis, whose stride is 0 or "
                         f"{block}, got strides {x.stride()}")
    return x.stride(0) if x.shape[0] > 1 else block


def _check(t_re, t_im, amp, w, K: int, lead: int = 0):
    """`lead` = 1 where every operand carries a leading seed axis (its
    stride checked by `seed_stride`)."""
    if K < 1:
        raise ValueError(f"K must be >= 1, got {K}")
    for name, x in (("t_re", t_re), ("t_im", t_im), ("amp", amp), ("w", w)):
        if (x.dtype != torch.float32 or x.dim() != 2 + lead
                or not (lead or x.is_contiguous())):
            raise ValueError(f"{name} must be a contiguous {2 + lead}-D "
                             f"float32 tensor, got {x.dtype} "
                             f"{tuple(x.shape)}")
        if lead:
            seed_stride(x, name)
        if x.device != t_re.device:
            raise ValueError(f"{name} is on {x.device}, t_re on "
                             f"{t_re.device}")
    if t_im.shape != t_re.shape:
        raise ValueError(f"t_im {tuple(t_im.shape)} != t_re "
                         f"{tuple(t_re.shape)}")
    if (w.shape != amp.shape or amp.shape[-1] != t_re.shape[-2]
            or amp.shape[:lead] != t_re.shape[:lead]):
        raise ValueError(f"amp {tuple(amp.shape)} and w {tuple(w.shape)} "
                         f"must be [{'S, ' * lead}B, U] with U = "
                         f"{t_re.shape[-2]}")


def _device(x: torch.Tensor, name: str) -> torch.device:
    """The device a wrapper runs on: cpu (the plain version) or cuda
    (the kernel); any other raises."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on cpu or cuda tensors, got "
                         f"{x.device}")
    return x.device


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
    patterns of an int32 device tensor, [8] for one seed's words [2] and
    [S, 8] for S seeds' [S, 2].  The seed words stay on the device: the
    low 32-bit half of each little-endian int64 word is that word's bit
    pattern, so a view selects it and one `cat` joins it to the cached
    bases."""
    s = as_words(seed, device)
    s = (s.reshape(-1)[:2] if s.dim() < 2 else s).contiguous()
    lo = s.view(torch.int32)[..., 0::2]
    bases = _base_words(int(rx_base), int(u_base), int(n_base),
                        torch.device(device))
    return torch.cat([lo, bases.expand(*lo.shape[:-1], 6)], dim=-1)


_P, _I, _F, _L = (ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
                  ctypes.c_longlong)
_SIGNATURES = {
    "fused_mac_launch": [_P] * 7 + [_I] * 6 + [_L] * 2 + [_F] * 2 + [_P],
    "fused_mac_partials_launch": [_P] * 9 + [_I] * 5 + [_F] + [_P],
    "fused_partials_reduce_launch": [_P] * 7 + [_I] * 4 + [_F] + [_P],
}


@functools.lru_cache(maxsize=None)
def _kernel_fn(name: str):
    """A C entry point of ``csrc/fused_mac.cu``, built and typed once per
    process."""
    fn = getattr(build.load("fused_mac"), name)
    fn.restype = ctypes.c_int
    fn.argtypes = _SIGNATURES[name]
    return fn


def _launch(name: str, dev: torch.device, *args) -> None:
    """Call entry point `name` on the current stream of `dev`; tensors
    pass as their data pointers.  Raises when the launch is refused."""
    stream = torch.cuda.current_stream(dev).cuda_stream
    args = [a.data_ptr() if isinstance(a, torch.Tensor) else a
            for a in args]
    with torch.cuda.device(dev):
        err = _kernel_fn(name)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name} failed: CUDA error {err}")


# ---------------------------------------------------------------------------
# the full combine
# ---------------------------------------------------------------------------

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
    sets the u-blocking of the sums; it changes float summation order
    only, never a draw.

    S seeds in one launch: seed [S, 2], t_re, t_im [S, U, N], amp, w
    [S, B, U] (each contiguous past the seed axis, whose stride may be
    0) give y_re, y_im [S, B, N]; seed s's rows equal the unbatched
    call with seed s's operands bit for bit.
    """
    lead = t_re.dim() - 2
    _check(t_re, t_im, amp, w, K, lead)
    dev = _device(t_re, "fused_mac")
    if dev.type == "cpu":
        return fused_mac_plain(seed, t_re, t_im, amp, w, K=K,
                               sigma_h2=sigma_h2, sigma_z2=sigma_z2,
                               rx_base=rx_base, u_base=u_base,
                               n_base=n_base, block_u=block_u)
    words = _launch_words(seed, rx_base, u_base, n_base, dev)
    if not lead:
        words, t_re, t_im, amp, w = (words[None], t_re[None], t_im[None],
                                     amp[None], w[None])
    S, B, U = amp.shape
    N = t_re.shape[-1]
    if words.shape != (S, 8):
        raise ValueError(f"{words.shape[0]} seeds' words for {S} seeds' "
                         f"operands")
    if t_im.stride() != t_re.stride() or w.stride() != amp.stride():
        raise ValueError("t_re and t_im, and amp and w, must share their "
                         "strides")
    y_re = torch.empty((S, B, N), dtype=torch.float32, device=dev)
    y_im = torch.empty((S, B, N), dtype=torch.float32, device=dev)
    _launch("fused_mac_launch", dev, words, t_re, t_im, amp, w, y_re,
            y_im, S, B, U, K, N, max(1, min(int(block_u), U)),
            seed_stride(t_re, "t_re"), seed_stride(amp, "amp"),
            _sigma(sigma_h2), _sigma(sigma_z2))
    fused_mac.launches += 1
    return (y_re, y_im) if lead else (y_re[0], y_im[0])


fused_mac.launches = 0


def _seed_keys(seed, device=None):
    """Seed words -> (s0, s1) for the plain versions: one seed's [2]
    gives two scalars, S seeds' [S, 2] two [S, 1, 1, 1] tensors, which
    broadcast against [B, K, N] draws to put the seed axis in front."""
    s = as_words(seed, device)
    if s.dim() < 2:
        s = s.reshape(-1)[:2]
        return s[0], s[1]
    return s[:, 0, None, None, None], s[:, 1, None, None, None]


def fused_noise(seed, B: int, K: int, N: int, sigma_z2: float,
                rx_base: int = 0, n_base: int = 0):
    """The kernels' receiver-noise draws as a separate term: (z_re,
    z_im), each float32 [B, K, N] ([S, B, K, N] for S seeds' words
    [S, 2]), keyed on stream `_TAG_NOISE` of rx ``rx_base + b`` at
    counter ``(k, n + n_base)``, on the seed's device.  Elementwise, so
    no blocking changes a draw."""
    s0, s1 = _seed_keys(seed)
    dev = s0.device
    rx = (torch.arange(B, device=dev) + rx_base)[:, None, None]
    kk = torch.arange(K, device=dev)[None, :, None]
    nn = (torch.arange(N, device=dev) + n_base)[None, None, :]
    zk0, zk1 = _stream_keys(s0, s1, rx, _TAG_NOISE)
    return _cx_normal(zk0, zk1, kk, nn, _sigma(sigma_z2))


def _block_sums(keys, t_re, t_im, amp, w, u0: int, u1: int, *, K: int,
                sigma_h: float, rx_base: int, u_base: int, n_base: int):
    """One u-block's sums over users u0 <= u < u1 of the tile: (pr_re,
    pr_im, pm_re, pm_im), each [B, K, N], or [S, B, K, N] for S seeds'
    keys (`_seed_keys`) and operands t [S, U, N], amp, w [S, B, U]."""
    s0, s1 = keys
    dev = t_re.device
    B, N = amp.shape[-2], t_re.shape[-1]
    rx = (torch.arange(B, device=dev) + rx_base)[:, None, None]
    kk = torch.arange(K, device=dev)[None, :, None]
    nn = (torch.arange(N, device=dev) + n_base)[None, None, :]
    # the keys with an axis for the users: [.., B, 1, 1, 1]
    hk0, hk1 = (k[..., None] for k in _stream_keys(s0, s1, rx, _TAG_CHAN))
    uu = torch.arange(u0, u1, device=dev) + u_base
    w0 = (_mul32(uu, _k_stride(K))[:, None, None] + kk) & MASK32  # [bu,K,1]
    g_re, g_im = _cx_normal(hk0, hk1, w0, nn, sigma_h)
    a = amp[..., u0:u1, None, None]
    wa = (w[..., u0:u1] * amp[..., u0:u1])[..., None, None]
    h_re, h_im = a * g_re, a * g_im                      # [B, bu, K, N]
    tr = t_re[..., None, u0:u1, None, :]
    ti = t_im[..., None, u0:u1, None, :]
    terms = (h_re * tr - h_im * ti, h_re * ti + h_im * tr, wa * g_re,
             wa * g_im)
    # added one user at a time, as the kernels add them: a torch
    # reduction's order would depend on the tile's width N
    sums = tuple(torch.zeros_like(x.select(-3, 0)) for x in terms)
    for j in range(u1 - u0):
        for acc, x in zip(sums, terms):
            acc += x.select(-3, j)
    return sums


_ROWS = 8   # the kernels' thread rows over the antennas


def _finalize(r_re, r_im, mf_re, mf_im):
    """y = sum_k conj(mf) * r: [.., B, K, N] -> (y_re, y_im) [.., B, N],
    in the kernels' order: row j sums k = j, j + 8, ... ascending, then
    the rows are added in order."""
    K = r_re.shape[-2]
    out = []
    for term in (mf_re * r_re + mf_im * r_im, mf_re * r_im - mf_im * r_re):
        y = torch.zeros_like(term.select(-2, 0))
        for j in range(min(_ROWS, K)):
            acc = torch.zeros_like(y)
            for k in range(j, K, _ROWS):
                acc += term.select(-2, k)
            y += acc
        out.append(y)
    return tuple(out)


def fused_mac_plain(seed, t_re, t_im, amp, w, *, K: int, sigma_h2: float,
                    sigma_z2: float, rx_base: int = 0, u_base: int = 0,
                    n_base: int = 0, block_u: int = 32):
    """The kernel's function in plain torch ops, on any device.

    r starts from the noise z and mf from zero; both accumulate over
    u-blocks of `block_u` users in ascending order, then
    ``y = sum_k conj(mf) * r``.  Same counters, same keys, same
    Box-Muller as the CUDA kernel and the JAX reference.  Seed-batched
    as `fused_mac` is: seed [S, 2] with operands [S, ...] gives
    [S, B, N]."""
    s = as_words(seed, t_re.device)
    B, U = amp.shape[-2:]
    N = t_re.shape[-1]
    r_re, r_im = fused_noise(s, B, K, N, sigma_z2, rx_base=rx_base,
                             n_base=n_base)
    mf_re = torch.zeros_like(r_re)
    mf_im = torch.zeros_like(r_im)
    bu = max(1, min(int(block_u), U))
    for u0 in range(0, U, bu):
        pr_re, pr_im, pm_re, pm_im = _block_sums(
            _seed_keys(s), t_re, t_im, amp, w, u0, min(u0 + bu, U), K=K,
            sigma_h=_sigma(sigma_h2), rx_base=rx_base, u_base=u_base,
            n_base=n_base)
        r_re += pr_re
        r_im += pr_im
        mf_re += pm_re
        mf_im += pm_im
    return _finalize(r_re, r_im, mf_re, mf_im)


# ---------------------------------------------------------------------------
# partial-combine mode: per-u-block sums + the pinned-order fold
# ---------------------------------------------------------------------------

def fused_mac_partials(seed, t_re: torch.Tensor, t_im: torch.Tensor,
                       amp: torch.Tensor, w: torch.Tensor, *, K: int,
                       sigma_h2: float, rx_base: int = 0, u_base: int = 0,
                       n_base: int = 0, block_u: int = 32):
    """Per-u-block pre-contraction sums of the fused combine.

    The inputs are `fused_mac`'s, for a tile of U users whose first one
    has global index `u_base`; U must be a multiple of `block_u`, so
    that the tile's blocks are blocks of the enclosing call.  Returns
    (pr_re, pr_im, pm_re, pm_im), each float32 [B, G, K, N] with
    G = U // block_u:

        pr[b, g, k, n] = sum_{u in block g} h[b,u,k,n] t[u,n]
        pm[b, g, k, n] = sum_{u in block g} w[b,u] h[b,u,k,n]

    No noise: `fused_partials_reduce` adds it when it folds the blocks.
    """
    _check(t_re, t_im, amp, w, K)
    dev = _device(t_re, "fused_mac_partials")
    B, U = amp.shape
    N = t_re.shape[1]
    if block_u < 1 or U % block_u:
        raise ValueError(f"fused_mac_partials needs U ({U}) divisible by "
                         f"block_u ({block_u}) so u-blocks align across "
                         f"tiles")
    if dev.type == "cpu":
        return fused_mac_partials_plain(
            seed, t_re, t_im, amp, w, K=K, sigma_h2=sigma_h2,
            rx_base=rx_base, u_base=u_base, n_base=n_base, block_u=block_u)
    G = U // block_u
    out = [torch.empty((B, G, K, N), dtype=torch.float32, device=dev)
           for _ in range(4)]
    _launch("fused_mac_partials_launch", dev,
            _launch_words(seed, rx_base, u_base, n_base, dev), t_re, t_im,
            amp, w, *out, B, U, K, N, int(block_u), _sigma(sigma_h2))
    fused_mac_partials.launches += 1
    return tuple(out)


fused_mac_partials.launches = 0


def fused_mac_partials_plain(seed, t_re, t_im, amp, w, *, K: int,
                             sigma_h2: float, rx_base: int = 0,
                             u_base: int = 0, n_base: int = 0,
                             block_u: int = 32):
    """`fused_mac_partials` in plain torch ops: `fused_mac_plain`'s block
    sums, each written to its own slot."""
    keys = _seed_keys(seed, t_re.device)
    U = amp.shape[1]
    blocks = [_block_sums(keys, t_re, t_im, amp, w, u0, u0 + block_u, K=K,
                          sigma_h=_sigma(sigma_h2), rx_base=rx_base,
                          u_base=u_base, n_base=n_base)
              for u0 in range(0, U, block_u)]
    return tuple(torch.stack(parts, dim=1) for parts in zip(*blocks))


def _check_partials(pr_re, pr_im, pm_re, pm_im, K: int) -> None:
    named = (("pr_re", pr_re), ("pr_im", pr_im), ("pm_re", pm_re),
             ("pm_im", pm_im))
    for name, x in named:
        if (x.dtype != torch.float32 or x.dim() != 4
                or not x.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous 4-D float32 "
                             f"tensor, got {x.dtype} {tuple(x.shape)}")
        if x.shape != pr_re.shape or x.device != pr_re.device:
            raise ValueError(f"{name} is {tuple(x.shape)} on {x.device}, "
                             f"pr_re {tuple(pr_re.shape)} on "
                             f"{pr_re.device}")
    if pr_re.shape[2] != K or K < 1:
        raise ValueError(f"partials carry {pr_re.shape[2]} antenna rows, "
                         f"K = {K}")


def fused_partials_reduce(seed, pr_re: torch.Tensor, pr_im: torch.Tensor,
                          pm_re: torch.Tensor, pm_im: torch.Tensor, *,
                          K: int, sigma_z2: float, rx_base: int = 0,
                          n_base: int = 0):
    """Pinned-order fold of per-u-block sums -> `fused_mac`'s y.

    pr/pm: float32 [B, G, K, N] block sums (`fused_mac_partials`),
    already laid out in ascending *global* block order and cut to
    exactly the blocks to fold.  r starts at the noise z (drawn here, at
    rx ``rx_base + b`` and symbols ``n + n_base``, as `fused_mac` draws
    it) and mf at zero; the blocks are added in ascending order, then
    ``y = sum_k conj(mf) * r``.  Returns (y_re, y_im), each [B, N]: on
    the card, bit for bit the `fused_mac` call over the enclosing user
    range.
    """
    _check_partials(pr_re, pr_im, pm_re, pm_im, K)
    dev = _device(pr_re, "fused_partials_reduce")
    if dev.type == "cpu":
        return fused_partials_reduce_plain(
            seed, pr_re, pr_im, pm_re, pm_im, K=K, sigma_z2=sigma_z2,
            rx_base=rx_base, n_base=n_base)
    B, G, _, N = pr_re.shape
    y_re = torch.empty((B, N), dtype=torch.float32, device=dev)
    y_im = torch.empty((B, N), dtype=torch.float32, device=dev)
    _launch("fused_partials_reduce_launch", dev,
            _launch_words(seed, rx_base, 0, n_base, dev), pr_re, pr_im,
            pm_re, pm_im, y_re, y_im, B, G, K, N, _sigma(sigma_z2))
    fused_partials_reduce.launches += 1
    return y_re, y_im


fused_partials_reduce.launches = 0


def fused_partials_reduce_plain(seed, pr_re, pr_im, pm_re, pm_im, *, K: int,
                                sigma_z2: float, rx_base: int = 0,
                                n_base: int = 0):
    """`fused_partials_reduce` in plain torch ops: `fused_noise`, then the
    blocks added one by one in ascending order, then `fused_mac_plain`'s
    finalize."""
    B, G, _, N = pr_re.shape
    r_re, r_im = fused_noise(as_words(seed, pr_re.device), B, K, N,
                             sigma_z2, rx_base=rx_base, n_base=n_base)
    mf_re = torch.zeros_like(r_re)
    mf_im = torch.zeros_like(r_im)
    for g in range(G):
        r_re += pr_re[:, g]
        r_im += pr_im[:, g]
        mf_re += pm_re[:, g]
        mf_im += pm_im[:, g]
    return _finalize(r_re, r_im, mf_re, mf_im)


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
