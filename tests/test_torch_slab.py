"""The port's faithful channel (``reference`` and ``slab_kernel``) and its
slab combine against the JAX package.

Tolerances, and why:

- the combine (`ota_combine_plain`, `mf_combine`) against the JAX
  kernels' einsum oracles at every shape and the kernels themselves in
  interpret mode at the shapes up to N = 513, fed the same numpy inputs:
  1e-5 of the largest output magnitude.  Only float summation order
  differs; the gaps measure below 1e-6.
- each hop of both backends against the JAX backend with the same key:
  1e-5 of the largest estimate magnitude.  The emulated draws are the
  reference's (words bit-equal, normals within a few ULP), and only the
  einsums' summation order differs; the gaps measure below 3e-7.
- the slice, ``fig2_iid`` quick at faithful fidelity for 4 rounds and 2
  seeds through both packages' `SweepRunner`: the bounds of
  ``tests/test_torch_slice.py`` (loss and power rtol 1e-5, accuracy
  within 1/n_test, the final model within 1e-4 of max |theta|).

On the CPU the wrapper runs the plain version; the CUDA kernel itself is
held to that plain version on the card by ``tests/test_torch_cuda.py``
and by ``chip_smoke.py``.
"""
import importlib.util
import json
import os

import jax
import numpy as np
import pytest
import torch

from repro.core import channel as jch
from repro.core.topology import random_topology as j_random_topology
from repro.kernels import mf_combine as j_mf_combine
from repro.kernels import ota_combine as j_ota_combine
from repro.kernels import ota_combine_batched as j_ota_combine_batched
from repro.kernels import ota_combine_ref as j_ota_combine_ref
from repro.kernels import ota_combine_ref_batched as j_ota_combine_ref_batched
from repro.sim.scenario import SCENARIOS as J_SCENARIOS
from repro.sim.sweep import SweepRunner as JSweepRunner
from repro_torch import prng
from repro_torch.core import channel as tch
from repro_torch.core.topology import random_topology
from repro_torch.kernels import mf_combine, ota_combine, ota_combine_plain
from repro_torch.sim import sweep
from repro_torch.sim.scenario import SCENARIOS

# one intra-op thread: test workers run side by side, and torch's
# default of one thread per core oversubscribes the CPU many times
torch.set_num_threads(1)

TOL = 1e-5
RTOL = 1e-5
THETA_RTOL = 1e-4
P = float(np.float32(1.37))
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# tests/test_kernels.py's shapes (U, K, N)
SHAPES = [(1, 1, 64), (5, 16, 256), (4, 7, 130), (20, 100, 1000),
          (64, 8, 2048), (3, 33, 513)]
# the JAX kernels run in interpret mode up to this N; above it they take
# seconds a call, and tests/test_kernels.py already holds them to their
# einsum oracles at those shapes, so the port is held to the oracle alone
INTERPRET_MAX_N = 513


def _cx(rng, shape):
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(np.complex64)


def _slab(B, U, K, N, seed):
    """numpy inputs (h, t, z, w); B = None gives the unbatched layout."""
    rng = np.random.default_rng(seed)
    lead = () if B is None else (B,)
    return (_cx(rng, lead + (U, K, N)), _cx(rng, (U, N)),
            _cx(rng, lead + (K, N)),
            rng.standard_normal(lead + (U,)).astype(np.float32))


def _planar(h, t, z, w):
    return (np.real(h), np.imag(h), np.real(t), np.imag(t), np.real(z),
            np.imag(z), w)


def _rel(ref, got: torch.Tensor) -> float:
    ref = np.asarray(ref)
    got = got.numpy()
    assert got.shape == ref.shape and got.dtype == np.complex64
    return float(np.abs(ref - got).max() / np.abs(ref).max())


@pytest.mark.parametrize("B", [None, 3])
@pytest.mark.parametrize("U,K,N", SHAPES)
def test_plain_matches_jax_kernel_and_oracle(B, U, K, N):
    """B = None is the unbatched TPU kernel `ota_combine`, B = 3 the
    batched `ota_combine_batched`."""
    h, t, z, w = _slab(B, U, K, N, seed=U * 1000 + K * 10 + N)
    args = _planar(h, t, z, w)
    kern, oracle = ((j_ota_combine, j_ota_combine_ref) if B is None else
                    (j_ota_combine_batched, j_ota_combine_ref_batched))
    refs = [oracle(*args)]
    if N <= INTERPRET_MAX_N:
        refs.append(kern(*args, interpret=True))
    got = ota_combine_plain(*(torch.as_tensor(a) for a in (h, t, z, w)))
    for yr, yi in refs:
        assert _rel(np.asarray(yr) + 1j * np.asarray(yi), got) <= TOL


@pytest.mark.parametrize("batched", [False, True])
@pytest.mark.parametrize("weights", [False, True])
def test_mf_combine_matches_reference(batched, weights):
    h, t, z, w = _slab(2 if batched else None, 6, 12, 200, seed=7)
    w = w if weights else None
    want = j_mf_combine(h, t, z, w)
    got = mf_combine(*(torch.as_tensor(a) if a is not None else None
                       for a in (h, t, z, w)))
    assert _rel(want, got) <= TOL
    if not weights:
        ones = torch.ones(h.shape[:-2])
        assert torch.equal(got, mf_combine(*(torch.as_tensor(a)
                                             for a in (h, t, z)), ones))


def test_wrapper_runs_plain_on_cpu_and_counts_no_launch():
    h, t, z, w = (torch.as_tensor(a) for a in _slab(2, 5, 7, 130, seed=1))
    before = ota_combine.launches
    y = ota_combine(h, t, z, w)
    assert ota_combine.launches == before
    assert torch.equal(y, ota_combine_plain(h, t, z, w))
    # an unbatched call is the batched call at B = 1
    assert torch.equal(ota_combine(h[0], t, z[0], w[0]),
                       ota_combine(h[:1], t, z[:1], w[:1])[0])


def test_wrapper_refuses_what_the_kernel_cannot_take():
    """Non-contiguous views (a `.real`-style strided slab or a transposed
    one), pending conjugation, wrong types and other devices raise on
    every device, so the CPU tests catch what the card would refuse."""
    h, t, z, w = (torch.as_tensor(a) for a in _slab(2, 5, 7, 130, seed=2))
    bad = [(h.transpose(2, 3).contiguous().transpose(2, 3), t, z, w),
           (h, t.conj(), z, w),
           (h, t, z, w.to(torch.float64)),
           (h, t, z[:, :, :64], w)]
    for args in bad:
        with pytest.raises(ValueError):
            ota_combine(*args)
    meta = [torch.empty_like(a, device="meta") for a in (h, t, z, w)]
    with pytest.raises(ValueError, match="cpu or cuda"):
        ota_combine(*meta)


def _topos(C, M, K, K_ps):
    kw = dict(C=C, M=M, K=K, K_ps=K_ps, sigma_z2=1.0)
    return j_random_topology(3, **kw), random_topology(3, **kw)


def _deltas(shape, seed):
    return (0.1 * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


@pytest.mark.parametrize("interference", [True, False])
@pytest.mark.parametrize("hop", ["cluster", "global", "conventional"])
@pytest.mark.parametrize("backend", ["reference", "slab_kernel"])
def test_faithful_hops_match_reference(backend, hop, interference):
    """K = K_ps = 12 is no multiple of the antenna chunk (8), so the
    reference folds chunks of 6."""
    jt, tt = _topos(C=3, M=4, K=12, K_ps=12)
    cfg = dict(mode="faithful", backend=backend, interference=interference)
    jcfg, tcfg = jch.OTAConfig(**cfg), tch.OTAConfig(**cfg)
    assert tch._chunk(12, tcfg.antenna_chunk) == 6
    d = _deltas((3, 4, 2 * 129), seed=len(hop))
    power = P
    if hop == "cluster":
        jfn, tfn = jch.cluster_ota, tch.cluster_ota
    elif hop == "global":
        jfn, tfn, d, power = jch.global_ota, tch.global_ota, d[:, 0], 20 * P
    else:
        jfn, tfn = jch.conventional_ota, tch.conventional_ota
    d = np.ascontiguousarray(d)
    ref = jax.jit(lambda k, x: jfn(k, x, jt, power, jcfg))(
        jax.random.PRNGKey(5), d)
    got = tfn(prng.PRNGKey(5), torch.as_tensor(d), tt, torch.tensor(power),
              tcfg)
    ref = np.asarray(ref)
    assert got.shape == ref.shape and got.dtype == torch.float32
    assert np.abs(ref - got.numpy()).max() <= TOL * np.abs(ref).max()


@pytest.fixture(scope="module", params=["slab_kernel", ""])
def faithful_runs(request):
    """``fig2_iid`` quick at faithful fidelity, 4 rounds, 2 seeds, through
    both packages; backend "" is the mode's default, ``reference``."""
    kw = dict(ota_mode="faithful", ota_backend=request.param)
    jsc = J_SCENARIOS["fig2_iid"].replace(**kw).quick().replace(total_IT=4)
    tsc = SCENARIOS["fig2_iid"].replace(**kw).quick().replace(total_IT=4)
    ref = JSweepRunner([jsc], seeds=2, batch="map", keep_state=True).run()[0]
    got = sweep.SweepRunner([tsc], seeds=2, keep_state=True,
                            batch="map", device="cpu").run()[0]
    return ref, got


def test_faithful_trajectories_match_reference(faithful_runs):
    ref, got = faithful_runs
    assert got.rounds == ref.rounds and got.seeds == ref.seeds
    np.testing.assert_allclose(got.acc, ref.acc, rtol=0,
                               atol=1.0 / ref.scenario.n_test)
    for key in ("loss", "edge_power", "is_power"):
        np.testing.assert_allclose(getattr(got, key), getattr(ref, key),
                                   rtol=RTOL, err_msg=key)


def test_faithful_final_model_matches_reference(faithful_runs):
    ref, got = faithful_runs
    for leaf in ("w", "b"):
        want = np.asarray(ref.final_state["theta"][leaf])
        have = got.final_state["theta"][leaf].numpy()
        assert have.shape == want.shape
        assert np.abs(have - want).max() <= THETA_RTOL * np.abs(want).max()


def test_fig2_driver_writes_the_sweep_document(tmp_path):
    spec = importlib.util.spec_from_file_location(
        "whfl_mnist_torch", os.path.join(REPO, "examples",
                                         "whfl_mnist_torch.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    out = tmp_path / "fig2.json"
    doc = mod.main(["--device", "cpu", "--quick", "--ota", "faithful",
                    "--backend", "slab_kernel", "--out", str(out)])
    assert json.loads(out.read_text()) == json.loads(json.dumps(doc))
    assert doc["schema"] == sweep.SCHEMA_VERSION and doc["dist"] == "iid"
    recs = doc["scenarios"]
    assert len(recs) == len(mod.SCHEMES) == 6
    for rec, (_, suffix) in zip(recs, mod.SCHEMES):
        assert tuple(rec) == sweep.RECORD_KEYS
        sc = rec["scenario"]
        assert sc["name"] == "fig2_iid" + suffix
        assert (sc["ota_mode"], sc["ota_backend"]) in (
            ("faithful", "slab_kernel"), ("ideal", ""))
        assert rec["exec"]["device"] == "cpu"
        assert np.all(np.isfinite(rec["metrics"]["loss"]))
