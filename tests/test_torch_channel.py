"""The port's OTA hops against the JAX package's, fed the same key.

Tolerance: 1e-5 of the largest estimate magnitude for every hop.  The
same key gives the same draws (words bit-equal, normals within a few
ULP), and the folds differ only in float summation order (einsums, the
fused combine's user and antenna sums); measured gaps are below 1e-6.
"""
import jax
import numpy as np
import pytest
import torch

from repro.core import channel as jch
from repro.core.topology import random_topology as j_random_topology
from repro_torch import prng
from repro_torch.core import channel as tch
from repro_torch.core.topology import random_topology

# one intra-op thread: test workers run side by side, and torch's
# default of one thread per core oversubscribes the CPU many times
torch.set_num_threads(1)

TOL = 1e-5
P = float(np.float32(1.37))


def _topos(C, M, K=16, K_ps=8, sigma_z2=1.0):
    kw = dict(C=C, M=M, K=K, K_ps=K_ps, sigma_z2=sigma_z2)
    return j_random_topology(3, **kw), random_topology(3, **kw)


def _deltas(shape, seed=0):
    return (0.1 * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


def _close(ref, got, tol=TOL):
    ref = np.asarray(ref)
    got = got.numpy()
    assert got.shape == ref.shape and got.dtype == np.float32
    assert np.abs(ref - got).max() <= tol * np.abs(ref).max()


HOP_CFGS = [
    dict(mode="equivalent"),
    dict(mode="equivalent", interference=False),
    dict(mode="faithful", backend="fused"),
    dict(mode="faithful", backend="fused", interference=False),
    dict(mode="ideal"),
]


@pytest.mark.parametrize("cfg", HOP_CFGS)
def test_cluster_hop_matches_reference(cfg):
    jt, tt = _topos(C=3, M=4)
    d = _deltas((3, 4, 2 * 257), seed=1)
    ref = jax.jit(lambda k, x: jch.cluster_ota(
        k, x, jt, P, jch.OTAConfig(**cfg)))(jax.random.PRNGKey(5), d)
    got = tch.cluster_ota(prng.PRNGKey(5), torch.as_tensor(d), tt,
                          torch.tensor(P), tch.OTAConfig(**cfg))
    _close(ref, got)


@pytest.mark.parametrize("cfg", HOP_CFGS)
def test_global_hop_matches_reference(cfg):
    jt, tt = _topos(C=4, M=2)
    d = _deltas((4, 2 * 301), seed=2)
    ref = jax.jit(lambda k, x: jch.global_ota(
        k, x, jt, 20 * P, jch.OTAConfig(**cfg)))(jax.random.PRNGKey(6), d)
    got = tch.global_ota(prng.PRNGKey(6), torch.as_tensor(d), tt,
                         torch.tensor(20 * P), tch.OTAConfig(**cfg))
    _close(ref, got)


@pytest.mark.parametrize("cfg", [dict(mode="equivalent"),
                                 dict(mode="faithful", backend="fused"),
                                 dict(mode="ideal")])
def test_conventional_hop_matches_reference(cfg):
    jt, tt = _topos(C=2, M=3, K_ps=16)
    d = _deltas((2, 3, 2 * 129), seed=3)
    ref = jax.jit(lambda k, x: jch.conventional_ota(
        k, x, jt, P, jch.OTAConfig(**cfg)))(jax.random.PRNGKey(7), d)
    got = tch.conventional_ota(prng.PRNGKey(7), torch.as_tensor(d), tt,
                               torch.tensor(P), tch.OTAConfig(**cfg))
    _close(ref, got)


def test_static_geometry_is_built_once_per_topology_and_device():
    """The fused backend's amplitudes, masks and normalization sums are
    uploaded once, not on every hop."""
    _, tt = _topos(C=3, M=4)
    cfg = tch.OTAConfig(mode="faithful", backend="fused")
    dev = torch.device("cpu")
    first = tch._cluster_geometry(tt, cfg, dev)
    assert all(a is b for a, b in zip(first,
                                      tch._cluster_geometry(tt, cfg, dev)))
    no_int = tch._cluster_geometry(
        tt, tch.OTAConfig(mode="faithful", backend="fused",
                          interference=False), dev)
    assert not torch.equal(no_int[0], first[0])
    mac = tch._mac_geometry(tt.beta_is, dev)
    assert all(a is b for a, b in zip(mac, tch._mac_geometry(tt.beta_is,
                                                             dev)))
    np.testing.assert_array_equal(mac[0].numpy()[0],
                                  np.sqrt(tt.beta_is.astype(np.float32)))
    assert mac[1].shape == (1, 3) and float(mac[2]) == pytest.approx(
        float(tt.beta_is.astype(np.float32).sum()), rel=1e-6)


def test_packing_is_planar_not_interleaved():
    x = torch.arange(6, dtype=torch.float32)
    y = tch.pack_cx(x)
    assert torch.equal(y.real, torch.tensor([0.0, 1.0, 2.0]))
    assert torch.equal(y.imag, torch.tensor([3.0, 4.0, 5.0]))
    assert torch.equal(tch.unpack_cx(y), x)


def test_backend_registry_and_resolution():
    assert set(tch.list_backends()) == set(jch.list_backends())
    for mode in ("faithful", "equivalent"):
        assert (tch.resolve_backend(tch.OTAConfig(mode=mode))
                == jch.resolve_backend(jch.OTAConfig(mode=mode)))
    with pytest.raises(ValueError):
        tch.resolve_backend(tch.OTAConfig(mode="bogus"))
    with pytest.raises(KeyError):
        tch.get_backend("bogus")


def test_orthogonal_cluster_hop_is_not_ported_yet():
    """The orthogonalized hop (ROADMAP queue A, item 7) is ported: it
    gives one estimate per user on the per-user backends and the ideal
    channel, and the superposition kernels refuse it with the JAX
    package's error.  Its values against JAX are held by
    tests/test_torch_participation.py."""
    _, tt = _topos(C=2, M=2)
    d = torch.zeros((2, 2, 8))
    key = prng.PRNGKey(0)
    assert tch.orthogonal_cluster_ota(
        key, d, tt, 1.0, tch.OTAConfig(mode="ideal")) is d
    for backend in tch.ROBUST_CAPABLE_BACKENDS:
        est = tch.orthogonal_cluster_ota(
            key, d, tt, torch.tensor(1.0), tch.OTAConfig(backend=backend))
        assert est.shape == d.shape and bool(torch.isfinite(est).all())
    for backend in ("fused", "slab_kernel"):
        with pytest.raises(ValueError, match="per-user reception"):
            tch.orthogonal_cluster_ota(key, d, tt, 1.0,
                                       tch.OTAConfig(backend=backend))
