"""Counter PRNG (threefry2x32 + Box-Muller) and a `jax.random` emulation.

Two consumers share the threefry2x32 block cipher here:

- the fused OTA kernel's counter PRNG (`_stream_keys`, `_cx_normal`,
  `fused_channels`): every complex channel or noise draw is one
  threefry block keyed on ``(seed, rx, stream)`` with the counter
  ``(u * Kstride + k, n)``, so the draws depend on logical indices only;
- a bit-exact emulation of `jax.random` under the threefry2x32 impl with
  ``jax_threefry_partitionable=True`` (`PRNGKey`, `split`, `fold_in`,
  `random_bits`, `randint`, `uniform`, `normal`, `bernoulli`), so one
  integer seed reproduces a run of the JAX reference.

Words are uint32 values carried in int64 tensors: CPU torch has no
uint32 arithmetic, so every add, multiply and shift is masked back to
32 bits.  A key is an int64 tensor ``[..., 2]``; every emulated sampler
is batched over the leading key dims (``split(keys [C, M, 2], n)`` is
``[C, M, n, 2]``), which is how the round draws all users' minibatches
in one call instead of vmapping.
"""
from __future__ import annotations

import math
from typing import Sequence, Tuple, Union

import numpy as np
import torch

MASK32 = 0xFFFFFFFF

_GOLDEN = 0x9E3779B9    # odd -> multiplication is bijective mod 2^32
_STREAM = 0x85EBCA77
_TAG_CHAN = 1
_TAG_NOISE = 2
_TWO_PI = float(np.float32(2.0 * np.pi))
_U24 = 2.0 ** -24
_U23 = 2.0 ** -23


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def _k_stride(K: int) -> int:
    """Counter stride of the antenna axis: fixed per K (never per block
    size) so draws are invariant to blocking.  Uniqueness of the
    ``u * Kstride + k`` counter word requires U * Kstride < 2^32."""
    return _round_up(max(K, 1), 128)


def as_words(x, device=None) -> torch.Tensor:
    """Anything holding uint32 words (a torch tensor of any integer
    dtype, a numpy array, a list) -> int64 tensor of values in
    [0, 2^32)."""
    if isinstance(x, torch.Tensor):
        t = x.to(device=device, dtype=torch.int64)
    else:
        t = torch.as_tensor(np.asarray(x).astype(np.int64), device=device)
    return t & MASK32


def _mul32(a, b):
    """a * b mod 2^32 for words a (tensor) and b (int or tensor), with
    no int64 overflow: b is split into 16-bit halves."""
    lo = a * (b & 0xFFFF)
    hi = ((a * (b >> 16)) & MASK32) << 16
    return (lo + hi) & MASK32


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    """The 32-bit words of `x` rotated left by r."""
    return ((x << r) & MASK32) | (x >> (32 - r))


def _threefry2x32(k0, k1, x0, x1):
    """The 20-round threefry2x32 block cipher (jax.random's generator).
    Keys and counters are words (ints or int64 tensors) of any
    broadcastable shapes; returns the two output word tensors.  Every
    step writes a new tensor, so under `torch.func.vmap` a batched key
    or counter may meet an unbatched one anywhere."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + k0) & MASK32
    x1 = (x1 + k1) & MASK32
    rotations = ((13, 15, 26, 6), (17, 29, 16, 24))
    for i in range(5):
        for r in rotations[i % 2]:
            x0 = (x0 + x1) & MASK32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & MASK32
    return x0, x1


def _box_muller(b0, b1):
    """Two word tensors -> two independent N(0, 1) float32 draws."""
    # u1 in (0, 1] (log-safe), u2 in [0, 1); 24-bit mantissa precision
    u1 = 1.0 - (b0 >> 8).to(torch.float32) * _U24
    u2 = (b1 >> 8).to(torch.float32) * _U24
    r = torch.sqrt(-2.0 * torch.log(u1))
    theta = _TWO_PI * u2
    return r * torch.cos(theta), r * torch.sin(theta)


def _cx_normal(key0, key1, w0, w1, sigma: float):
    """Per-element CN(0, 2*sigma^2) draw: (re, im) each N(0, sigma^2)."""
    b0, b1 = _threefry2x32(key0, key1, w0, w1)
    n0, n1 = _box_muller(b0, b1)
    return sigma * n0, sigma * n1


def _stream_keys(s0, s1, rx, tag: int):
    """Fold (rx index, stream tag) into the seed words.  Distinct
    (rx, tag) pairs give distinct threefry keys, hence independent
    streams (threefry is a PRF over (key, counter))."""
    tagc = (int(tag) * _STREAM) & MASK32
    return (s0 + _mul32(rx, _GOLDEN)) & MASK32, (s1 + tagc) & MASK32


def fused_channels(seed, B: int, U: int, K: int, N: int, sigma_h2: float,
                   sigma_z2: float, rx_base: int = 0, u_base: int = 0,
                   n_base: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Materialize the exact channel realizations the fused kernel
    derives: g [B, U, K, N] complex64 ~ CN(0, sigma_h2) (unit amplitude;
    the caller applies amp) and z [B, K, N] ~ CN(0, sigma_z2), on the
    seed's device.  O(B*U*K*N) memory: for tests and small oracles.

    With counter bases (rb, ub, nb) the returned g equals the
    [rb:rb+B, ub:ub+U, :, nb:nb+N] slice of the base-0 generation
    (bit-exact; `assert_draw_invariance` checks it)."""
    s = as_words(seed).reshape(-1)[:2]
    dev = s.device
    rx = (torch.arange(B, device=dev) + rx_base)[:, None, None, None]
    uu = (torch.arange(U, device=dev) + u_base)[:, None, None]
    kk = torch.arange(K, device=dev)[None, :, None]
    nn = (torch.arange(N, device=dev) + n_base)[None, None, :]
    w0_h = (_mul32(uu, _k_stride(K)) + kk) & MASK32          # [U, K, 1]
    s_h = float(np.sqrt(sigma_h2 / 2.0))
    s_z = float(np.sqrt(sigma_z2 / 2.0))
    hk0, hk1 = _stream_keys(s[0], s[1], rx, _TAG_CHAN)       # [B, 1, 1, 1]
    zk0, zk1 = _stream_keys(s[0], s[1], rx[:, 0], _TAG_NOISE)  # [B, 1, 1]
    g = torch.complex(*_cx_normal(hk0, hk1, w0_h[None], nn[None], s_h))
    z = torch.complex(*_cx_normal(zk0, zk1, kk, nn, s_z))
    return g, z


def assert_draw_invariance(seed, B: int, U: int, K: int, N: int,
                           sigma_h2: float = 1.0, sigma_z2: float = 1.0,
                           *, rx_base: int = 0, u_base: int = 0,
                           n_base: int = 0) -> None:
    """Assert (bit-exact) that offset generation equals the matching
    slice of the enclosing full-range generation."""
    g_o, z_o = fused_channels(seed, B, U, K, N, sigma_h2, sigma_z2,
                              rx_base=rx_base, u_base=u_base, n_base=n_base)
    g_f, z_f = fused_channels(seed, rx_base + B, u_base + U, K, n_base + N,
                              sigma_h2, sigma_z2)
    ok_g = bool(torch.equal(g_o, g_f[rx_base:, u_base:, :, n_base:]))
    ok_z = bool(torch.equal(z_o, z_f[rx_base:, :, n_base:]))
    if not (ok_g and ok_z):
        raise AssertionError(
            f"counter-offset draws diverge from the full-range slice "
            f"(g ok={ok_g}, z ok={ok_z}) for bases "
            f"rx={rx_base}, u={u_base}, n={n_base}")


# ---------------------------------------------------------------------------
# jax.random emulation (threefry2x32, jax_threefry_partitionable=True)
# ---------------------------------------------------------------------------

Shape = Union[int, Sequence[int]]


def _shape(shape: Shape) -> Tuple[int, ...]:
    return (int(shape),) if isinstance(shape, int) else tuple(
        int(s) for s in shape)


def PRNGKey(seed: int, device=None) -> torch.Tensor:
    """`jax.random.PRNGKey(seed)`: the word pair (seed >> 32, seed)."""
    seed = int(seed)
    if seed < 0:
        raise ValueError(f"seed must be non-negative, got {seed}")
    return torch.tensor([(seed >> 32) & MASK32, seed & MASK32],
                        dtype=torch.int64, device=device)


def _iota_bits(key: torch.Tensor, shape: Tuple[int, ...], start: int = 0):
    """threefry2x32 of every key in `key [..., 2]` over the flat-index
    counters of `shape` (high word, low word): `iota_2x32_shape`; with
    `start`, over the counters start, start + 1, ... instead (a slice of
    a larger draw's flat counters)."""
    idx = torch.arange(start, start + math.prod(shape), dtype=torch.int64,
                       device=key.device).reshape(shape)
    lead = key.shape[:-1] + (1,) * len(shape)
    k0 = key[..., 0].reshape(lead)
    k1 = key[..., 1].reshape(lead)
    return _threefry2x32(k0, k1, idx >> 32, idx & MASK32)


def split(key: torch.Tensor, num: Shape = 2) -> torch.Tensor:
    """`jax.random.split`: keys [..., 2] -> [..., *num, 2]."""
    b0, b1 = _iota_bits(key, _shape(num))
    return torch.stack([b0, b1], dim=-1)


def fold_in(key: torch.Tensor, data: int) -> torch.Tensor:
    """`jax.random.fold_in(key, data)`: threefry2x32 of the keys [..., 2]
    on the counter pair (0, data), `data` taken as a uint32 (jax's
    `threefry_seed` of a 32-bit integer puts it in the low word)."""
    b0, b1 = _threefry2x32(key[..., 0], key[..., 1], 0, int(data) & MASK32)
    return torch.stack([b0, b1], dim=-1)


def random_bits(key: torch.Tensor, shape: Shape) -> torch.Tensor:
    """32-bit `jax.random.bits`: keys [..., 2] -> words [..., *shape]."""
    b0, b1 = _iota_bits(key, _shape(shape))
    return b0 ^ b1


_I32_MIN, _I32_MAX = -(2 ** 31), 2 ** 31 - 1


def randint(key: torch.Tensor, shape: Shape, minval: int,
            maxval: int) -> torch.Tensor:
    """int32 `jax.random.randint` in [minval, maxval), returned as
    int64 (ready for indexing): two bit arrays from ``split(key)``
    folded with jax's span/multiplier arithmetic."""
    minval, maxval = int(minval), int(maxval)
    if not (_I32_MIN <= minval <= _I32_MAX and _I32_MIN <= maxval <= _I32_MAX):
        raise ValueError("randint bounds must fit in int32")
    k = split(key)
    higher = random_bits(k[..., 0, :], shape)
    lower = random_bits(k[..., 1, :], shape)
    span = 1 if maxval <= minval else (maxval - minval) & MASK32
    multiplier = (2 ** 16) % span
    multiplier = ((multiplier * multiplier) & MASK32) % span
    off = (_mul32(higher % span, multiplier) + lower % span) & MASK32
    out = (off % span) + minval
    return ((out - _I32_MIN) & MASK32) + _I32_MIN     # int32 wrap


def uniform(key: torch.Tensor, shape: Shape, minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """float32 `jax.random.uniform` in [minval, maxval): 23 random
    mantissa bits under exponent 0, shifted and scaled.  The float 1.m
    less 1 is m * 2^-23 exactly, which is computed so: no view of the
    words' bits, which `torch.func.vmap` cannot batch."""
    return _uniform_of_bits(random_bits(key, shape), minval, maxval)


def _uniform_of_bits(bits: torch.Tensor, minval: float,
                     maxval: float) -> torch.Tensor:
    floats = (bits >> 9).to(torch.float32) * _U23
    lo, hi = np.float32(minval), np.float32(maxval)
    return torch.clamp_min(floats * float(hi - lo) + float(lo), float(lo))


# chlo.erf_inv's float32 expansion (Giles' approximation), which is what
# jax.random.normal lowers to
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)


def _erf_inv(x: torch.Tensor) -> torch.Tensor:
    """float32 erfinv, term for term as XLA expands it."""
    w = -torch.log1p(x * -x)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0)

    def coef(i):
        return torch.where(lt, float(np.float32(_ERFINV_LT5[i])),
                           float(np.float32(_ERFINV_GE5[i])))

    p = coef(0)
    for i in range(1, len(_ERFINV_LT5)):
        p = coef(i) + p * w
    return torch.where(x.abs() == 1.0, x * math.inf, p * x)


_NORMAL_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
_SQRT2 = float(np.float32(np.sqrt(2.0)))


def normal(key: torch.Tensor, shape: Shape) -> torch.Tensor:
    """float32 `jax.random.normal`: sqrt(2) * erfinv(u), u uniform on
    (nextafter(-1, +inf), 1)."""
    u = uniform(key, shape, _NORMAL_LO, 1.0)
    return _SQRT2 * _erf_inv(u)


def normal_slice(key: torch.Tensor, start: int, stop: int) -> torch.Tensor:
    """Elements [start, stop) of ``normal(key, shape).reshape(-1)``, for
    one key [2] and any shape of at least `stop` elements: a draw's
    counters are its flat indices, so a large draw can be made a slice
    at a time, with the same bits and a slice's working memory."""
    b0, b1 = _iota_bits(key, (stop - start,), start)
    return _SQRT2 * _erf_inv(_uniform_of_bits(b0 ^ b1, _NORMAL_LO, 1.0))


def normal_at(key: torch.Tensor, flat_idx: torch.Tensor) -> torch.Tensor:
    """The elements at `flat_idx` (an int64 tensor of any shape, each a
    flat index into the draw) of ``normal(key, shape).reshape(-1)``, for
    one key [2] and any shape past the largest index, in the shape of
    `flat_idx`: a strided shard of a draw (one rank's slice of a leaf
    split over a mesh axis) drawn alone with the full draw's bits."""
    b0, b1 = _threefry2x32(key[0], key[1], flat_idx >> 32,
                           flat_idx & MASK32)
    return _SQRT2 * _erf_inv(_uniform_of_bits(b0 ^ b1, _NORMAL_LO, 1.0))


def bernoulli(key: torch.Tensor, p: float, shape: Shape) -> torch.Tensor:
    """bool `jax.random.bernoulli` in its default mode ("low"):
    ``uniform(key, shape) < p`` with p rounded to float32, as a Python
    float enters it.  Batched over the leading key dims like `uniform`,
    and usable under `torch.func.vmap` with a batched key."""
    return uniform(key, shape) < float(np.float32(p))
