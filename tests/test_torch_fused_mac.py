"""The port's fused OTA combine against the JAX kernel and its oracle.

Tolerance: 1e-4 of the largest output magnitude, the JAX package's own
gate between `fused_mac` and `fused_mac_ref`.  Both sides draw the same
channels (the words are bit-equal; the normals differ by at most a few
ULP of libm) but sum over users and antennas in other orders, so only
float accumulation error separates them; it measures about 2e-7 here.

On the CPU the wrapper runs the plain PyTorch version; the CUDA kernel
itself is held to that plain version on the card by
``tests/test_torch_cuda.py`` and by ``chip_smoke.py``.
"""
import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import canonical_block_u as j_canonical_block_u
from repro.kernels import fused_mac as j_fused_mac
from repro.kernels import fused_mac_ref as j_fused_mac_ref
from repro_torch.kernels import (canonical_block_u, fused_mac,
                                 fused_mac_plain, fused_mac_ref)

fused_mac_module = importlib.import_module("repro_torch.kernels.fused_mac")

# one intra-op thread: test workers run side by side, and torch's
# default of one thread per core oversubscribes the CPU many times
torch.set_num_threads(1)

TOL = 1e-4
SEED = np.array([0xC0FFEE, 42], np.uint32)

SHAPES = [
    (1, 1, 1, 64, (0, 0, 0)),       # degenerate
    (1, 4, 8, 256, (0, 0, 0)),      # aligned
    (3, 5, 7, 130, (0, 0, 0)),      # unaligned everything
    (2, 33, 16, 513, (0, 0, 0)),    # prime-ish
    (1, 70, 100, 1000, (0, 0, 0)),  # paper-scale antennas
    (3, 5, 7, 130, (2, 3, 5)),      # nonzero rx/u/n counter bases
]


def _inputs(B, U, N, seed):
    rng = np.random.default_rng(seed)
    t_re = rng.standard_normal((U, N)).astype(np.float32)
    t_im = rng.standard_normal((U, N)).astype(np.float32)
    amp = rng.uniform(0.5, 2.0, (B, U)).astype(np.float32)
    w = rng.integers(0, 2, (B, U)).astype(np.float32)
    w[:, 0] = 1.0        # keep every station's output nonzero
    return t_re, t_im, amp, w


def _rel(ref, got) -> float:
    ref_re, ref_im = (np.asarray(r) for r in ref)
    scale = np.abs(ref_re + 1j * ref_im).max() + 1e-12
    return max(np.abs(ref_re - got[0].numpy()).max(),
               np.abs(ref_im - got[1].numpy()).max()) / scale


@pytest.mark.parametrize("B,U,K,N,bases", SHAPES)
def test_plain_matches_jax_kernel_and_oracle(B, U, K, N, bases):
    rb, ub, nb = bases
    arrs = _inputs(B, U, N, B * 100 + U + K + N)
    kw = dict(K=K, sigma_h2=1.0, sigma_z2=2.0, rx_base=rb, u_base=ub,
              n_base=nb)
    # jitted: one compile per shape instead of one per eager op
    ref_kernel = jax.jit(functools.partial(j_fused_mac, interpret=True,
                                           **kw))(jnp.asarray(SEED), *arrs)
    ref_oracle = jax.jit(functools.partial(j_fused_mac_ref, **kw))(
        jnp.asarray(SEED), *arrs)
    tens = [torch.as_tensor(a) for a in arrs]
    got = fused_mac(torch.as_tensor(SEED.astype(np.int64)), *tens, **kw)
    assert got[0].shape == (B, N) and got[0].dtype == torch.float32
    assert _rel(ref_kernel, got) <= TOL
    assert _rel(ref_oracle, got) <= TOL
    assert _rel(fused_mac_ref(SEED, *tens, **kw), got) <= TOL


def test_plain_blocking_changes_no_draw():
    """u-blocking changes float summation order only."""
    tens = [torch.as_tensor(a) for a in _inputs(2, 12, 300, 7)]
    kw = dict(K=24, sigma_h2=1.0, sigma_z2=1.0)
    y1 = fused_mac_plain(SEED, *tens, block_u=32, **kw)
    y2 = fused_mac_plain(SEED, *tens, block_u=5, **kw)
    assert _rel(y1, y2) <= 1e-6


def test_wrapper_uses_plain_version_on_cpu_without_launching():
    tens = [torch.as_tensor(a) for a in _inputs(2, 6, 200, 3)]
    before = fused_mac.launches
    got = fused_mac(SEED, *tens, K=4, sigma_h2=1.0, sigma_z2=1.0)
    want = fused_mac_plain(SEED, *tens, K=4, sigma_h2=1.0, sigma_z2=1.0)
    assert fused_mac.launches == before
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("bad", ["dtype", "shape", "K", "device",
                                 "strided"])
def test_wrapper_rejects_bad_inputs(bad):
    t_re, t_im, amp, w = (torch.as_tensor(a)
                          for a in _inputs(2, 6, 200, 3))
    K = 4
    if bad == "dtype":
        t_re = t_re.double()
    elif bad == "shape":
        amp = amp[:, :5]
    elif bad == "K":
        K = 0
    elif bad == "strided":
        amp = amp.t().contiguous().t()
    else:
        t_re = t_re.to("meta")
    with pytest.raises(ValueError):
        fused_mac(SEED, t_re, t_im, amp, w, K=K, sigma_h2=1.0, sigma_z2=1.0)


@pytest.mark.parametrize("seed,bases", [
    ((0xC0FFEE, 42), (0, 0, 0)),
    ((0xFFFFFFFF, 0x80000000), (2, 3, 5)),
    ((7, 0x9E3779B9), (2 ** 32 - 1, 2 ** 31, 1))])
def test_launch_words_are_the_uint32_bit_patterns(seed, bases):
    """The kernel's 8 launch words: the seed words, then the counter
    bases, then zeros, each as its uint32 bit pattern in int32."""
    words = fused_mac_module._launch_words(
        torch.tensor(seed, dtype=torch.int64), *bases, torch.device("cpu"))
    want = np.array(list(seed) + list(bases) + [0, 0, 0],
                    np.uint32).view(np.int32)
    assert words.dtype == torch.int32 and words.shape == (8,)
    assert words.tolist() == want.tolist()


@pytest.mark.parametrize("M", [1, 5, 64, 1024, 2048, 4096, 3000])
def test_canonical_block_u_matches_reference(M):
    assert canonical_block_u(M) == j_canonical_block_u(M)
