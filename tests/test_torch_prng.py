"""The port's counter PRNG and `jax.random` emulation against JAX.

Tolerances: every uint32 word (threefry outputs, keys, `split`,
`random_bits`, `randint`, the mantissa bits behind `uniform`) must be
bit-equal, since integer work has one right answer.  Float normals may
differ by libm: Box-Muller's log/sin/cos and XLA's float32 erfinv
expansion (log1p, and a polynomial XLA evaluates with fused
multiply-adds) round differently in torch, so normals are held within
4 float32 ULP; the largest gap measured on these draws is 3 ULP.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch import prng

# one intra-op thread: test workers run side by side, and torch's
# default of one thread per core oversubscribes the CPU many times
torch.set_num_threads(1)

jfm = importlib.import_module("repro.kernels.fused_mac")

MAX_ULP = 4


def _ulp(a, b) -> int:
    """Largest distance in float32 units in the last place."""
    def ordered(x):
        i = np.asarray(x, np.float32).view(np.int32).astype(np.int64)
        return np.where(i < 0, -(i & 0x7FFFFFFF), i)
    return int(np.abs(ordered(a) - ordered(b)).max())


def _words(x) -> np.ndarray:
    return np.asarray(x).astype(np.int64)


def test_threefry_words_bit_equal():
    rng = np.random.default_rng(0)
    keys = rng.integers(0, 2 ** 32, (6, 2), dtype=np.uint64)
    x = rng.integers(0, 2 ** 32, (2, 4096), dtype=np.uint64)
    x[:, :3] = [[0, 2 ** 32 - 1, 1], [0, 2 ** 32 - 1, 2 ** 31]]
    for k0, k1 in keys:
        ref = jfm._threefry2x32(jnp.uint32(k0), jnp.uint32(k1),
                                jnp.asarray(x[0], jnp.uint32),
                                jnp.asarray(x[1], jnp.uint32))
        got = prng._threefry2x32(int(k0), int(k1),
                                 prng.as_words(x[0].astype(np.int64)),
                                 prng.as_words(x[1].astype(np.int64)))
        for r, g in zip(ref, got):
            np.testing.assert_array_equal(_words(r), g.numpy())


@pytest.mark.parametrize("rx,tag", [(0, 1), (1, 2), (7, 1), (2 ** 32 - 1, 2)])
def test_stream_keys_bit_equal(rx, tag):
    s0, s1 = 0xC0FFEE, 0xFFFFFFF0
    ref = jfm._stream_keys(jnp.uint32(s0), jnp.uint32(s1), rx, tag)
    got = prng._stream_keys(s0, s1, torch.tensor(rx), tag)
    assert [int(r) for r in ref] == [int(g) for g in got]


@pytest.mark.parametrize("bases", [(0, 0, 0), (1, 3, 5), (2, 0, 130)])
def test_fused_channels_match_reference(bases):
    # variance 2 makes each component a unit normal, so the ULP count is
    # that of Box-Muller itself (scaling by sigma != 1 can move a value
    # into the next binade down and double its ULP count)
    rb, ub, nb = bases
    seed = np.array([0xC0FFEE, 42], np.uint32)
    g_j, z_j = jfm.fused_channels(jnp.asarray(seed), 2, 5, 7, 130, 2.0, 2.0,
                                  rx_base=rb, u_base=ub, n_base=nb)
    g_t, z_t = prng.fused_channels(seed, 2, 5, 7, 130, 2.0, 2.0,
                                   rx_base=rb, u_base=ub, n_base=nb)
    for ref, got in ((g_j, g_t), (z_j, z_t)):
        ref = np.asarray(ref)
        got = got.numpy()
        assert ref.shape == got.shape and got.dtype == np.complex64
        assert _ulp(ref.real, got.real) <= MAX_ULP
        assert _ulp(ref.imag, got.imag) <= MAX_ULP


@pytest.mark.parametrize("bases", [(0, 0, 0), (1, 2, 3), (3, 17, 250)])
def test_assert_draw_invariance_holds_in_port(bases):
    rb, ub, nb = bases
    prng.assert_draw_invariance([0xC0FFEE, 42], 2, 5, 7, 130,
                                rx_base=rb, u_base=ub, n_base=nb)


def test_draw_invariance_detects_mismatch(monkeypatch):
    real = prng.fused_channels

    def ignore_u_base(seed, B, U, K, N, *a, u_base=0, **kw):
        return real(seed, B, U, K, N, *a, **kw)

    monkeypatch.setattr(prng, "fused_channels", ignore_u_base)
    with pytest.raises(AssertionError):
        prng.assert_draw_invariance([1, 2], 1, 2, 3, 40, u_base=4)


@pytest.mark.parametrize("seed", [0, 1, 7, 2 ** 31 - 1])
def test_prngkey_and_split_bit_equal(seed):
    jk, tk = jax.random.PRNGKey(seed), prng.PRNGKey(seed)
    np.testing.assert_array_equal(_words(jk), tk.numpy())
    for num in (1, 2, 3, 20):
        np.testing.assert_array_equal(_words(jax.random.split(jk, num)),
                                      prng.split(tk, num).numpy())
    np.testing.assert_array_equal(
        _words(jax.random.split(jk, (2, 3))), prng.split(tk, (2, 3)).numpy())


@pytest.mark.parametrize("maxval", [4, 64, 1000, 7, 2 ** 31 - 1])
def test_randint_bit_equal(maxval):
    for seed in (0, 3, 12345):
        ref = jax.random.randint(jax.random.PRNGKey(seed), (500,), 0, maxval)
        got = prng.randint(prng.PRNGKey(seed), (500,), 0, maxval)
        np.testing.assert_array_equal(np.asarray(ref), got.numpy())
    ref = jax.random.randint(jax.random.PRNGKey(9), (3, 4), -5, 9)
    np.testing.assert_array_equal(
        np.asarray(ref), prng.randint(prng.PRNGKey(9), (3, 4), -5, 9).numpy())


def test_batched_keys_match_vmapped_jax():
    """The emulation batches over leading key dims the way the round
    vmaps over users: [C, M, 2] keys draw [C, M, ...] values."""
    jkeys = jax.random.split(jax.random.PRNGKey(3), 6).reshape(2, 3, 2)
    tkeys = prng.split(prng.PRNGKey(3), 6).reshape(2, 3, 2)
    per_user = jax.vmap(jax.vmap(lambda k: (
        jax.random.split(k, 4), jax.random.randint(k, (17,), 0, 50))))
    ref_split, ref_idx = per_user(jkeys)
    np.testing.assert_array_equal(_words(ref_split),
                                  prng.split(tkeys, 4).numpy())
    np.testing.assert_array_equal(np.asarray(ref_idx),
                                  prng.randint(tkeys, (17,), 0, 50).numpy())


def test_uniform_bit_equal_and_normal_within_ulp():
    for seed in range(4):
        jk, tk = jax.random.PRNGKey(seed), prng.PRNGKey(seed)
        np.testing.assert_array_equal(
            np.asarray(jax.random.uniform(jk, (4096,))),
            prng.uniform(tk, (4096,)).numpy())
        ref = np.asarray(jax.random.normal(jk, (20000,)))
        got = prng.normal(tk, (20000,))
        assert got.dtype == torch.float32
        assert _ulp(ref, got.numpy()) <= MAX_ULP


def test_erf_inv_edges():
    x = torch.tensor([-1.0, 1.0, 0.0], dtype=torch.float32)
    out = prng._erf_inv(x)
    assert out[0] == -np.inf and out[1] == np.inf and out[2] == 0.0
