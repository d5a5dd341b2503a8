"""Partial participation and the robust cluster folds in the port, against
the JAX package and against the port's own invariances.

Against JAX (`repro.core.aggregation`, `repro.core.channel`,
`repro.core.whfl`), on inputs made from a numpy seed:

- `cotaf_precode` and `masked_median`: bit for bit (elementwise
  products, and a sort that picks values).  The masks hold an empty
  cluster and odd and even claimed counts.
- `attendance_rescale`: within rtol 1e-6, exactly 1 at full attendance
  and exactly 0 for an empty cluster.  XLA sums the five weights left to
  right, torch in another order (measured: up to 3 ULP).
- `masked_trimmed_mean` at trims {0, 0.2, 0.25, 0.4}: within 1e-6 of
  max |x| (its sum over the kept ranks may run in another order).
- `orthogonal_cluster_ota` on `reference` and `equivalent`: within 1e-5
  of max |est| (one single-user hop per user, each with the
  reference's key; normals within a few ULP, einsum order).
- `validate_participation`: the same errors, with the same messages
  (the port's module path in place of the reference's).
- the edge power with a byzantine scale of 3.0, which is not a power of
  two: within 1 ULP of the reference's formula, the power of the
  precoded symbols; the energy of the unprecoded flat times the
  multiplier squared is another number.

Port against port, bit for bit: a Bernoulli schedule at rate 1.0 and
the full schedule; a round in which a sampled-out user's data shard is
corrupted and one in which it is not.  Rate 0.0 on the ideal channel
leaves the model at its initial value with edge power exactly 0, and the
median fold bounds the accuracy a byzantine user takes from the mean
(the JAX package's own bounds, tests/test_participation.py).  The
sharded engine equals the single engine, and the chunked driver the
stepwise one, for `fig2_drop50` on the fused backend (both combines) and
`fig2_byzantine1_median` as registered, quick and cut to 4 rounds, 2
seeds, on meshes 1x1, 2x2, 2x4 and 3x2 (the last two pad users or
clusters in): every metric and every leaf of the final state.

The scenario runs against JAX are in tests/test_torch_participation_
runs.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import aggregation as jagg
from repro.core import channel as jch
from repro.core import whfl as jwhfl
from repro.core.topology import random_topology as j_random_topology
from repro.core.topology import uniform_topology as j_uniform_topology
from repro.fed import clients as jcl
from repro_torch import prng
from repro_torch.core import aggregation as agg
from repro_torch.core import channel as tch
from repro_torch.core.topology import random_topology, uniform_topology
from repro_torch.core.whfl import (CLUSTER_AGGREGATORS, WHFLConfig,
                                   init_round_state, make_round_body,
                                   make_round_fn, validate_participation)
from repro_torch.exec import ShardedSweepRunner
from repro_torch.fed import ParticipationSchedule
from repro_torch.optim import sgd
from repro_torch.sim import sweep
from repro_torch.sim.scenario import Scenario, get_scenario
from repro_torch.tree import tree_leaves

torch.set_num_threads(1)

RESCALE_RTOL = 1e-6
TRIM_ATOL = 1e-6     # of max |x|
HOP_ATOL = 1e-5      # of max |est|
ROUNDS = 4


def _fold_inputs(seed):
    rng = np.random.default_rng(seed)
    C, M, two_n = 5, 5, 34
    x = rng.standard_normal((C, M, two_n)).astype(np.float32)
    x[4, 1] = x[4, 3]                     # ties
    mask = np.ones((C, M), np.float32)
    mask[0] = 0.0                         # empty cluster
    mask[1] = [1, 1, 1, 0, 0]             # 3: odd
    mask[2] = [0, 1, 1, 1, 1]             # 4: even
    mask[3] = [0, 0, 1, 0, 0]             # 1
    return x, mask                        # cluster 4: all 5


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_precode_rescale_and_median_bitwise(seed):
    x, mask = _fold_inputs(seed)
    mult = mask * np.float32(-2.0)
    want = np.asarray(jagg.cotaf_precode(jnp.asarray(x), jnp.asarray(mult)))
    got = agg.cotaf_precode(torch.as_tensor(x), torch.as_tensor(mult))
    assert got.numpy().tobytes() == want.tobytes()

    w = np.random.default_rng(seed).uniform(0.1, 2.0, (5, 5)).astype(
        np.float32)
    want = np.asarray(jagg.attendance_rescale(w, jnp.asarray(mask)))
    got = agg.attendance_rescale(torch.as_tensor(w), torch.as_tensor(mask))
    np.testing.assert_allclose(got.numpy(), want, rtol=RESCALE_RTOL)
    assert float(got[0]) == 0.0 and float(got[4]) == 1.0

    want = np.asarray(jagg.masked_median(jnp.asarray(x), jnp.asarray(mask)))
    got = agg.masked_median(torch.as_tensor(x), torch.as_tensor(mask))
    assert got.numpy().tobytes() == want.tobytes()
    assert bool((got[0] == 0.0).all())


@pytest.mark.parametrize("trim", [0.0, 0.2, 0.25, 0.4])
def test_trimmed_mean_matches_reference(trim):
    x, mask = _fold_inputs(3)
    want = np.asarray(jagg.masked_trimmed_mean(jnp.asarray(x),
                                               jnp.asarray(mask), trim))
    got = agg.masked_trimmed_mean(torch.as_tensor(x), torch.as_tensor(mask),
                                  trim).numpy()
    assert np.abs(got - want).max() <= TRIM_ATOL * np.abs(x).max()
    assert (got[0] == 0.0).all()
    with pytest.raises(ValueError, match="trim"):
        agg.masked_trimmed_mean(torch.as_tensor(x), torch.as_tensor(mask),
                                0.5)


@pytest.mark.parametrize("backend", tch.ROBUST_CAPABLE_BACKENDS)
def test_orthogonal_hop_matches_reference(backend):
    assert tch.ROBUST_CAPABLE_BACKENDS == jch.ROBUST_CAPABLE_BACKENDS
    C, M, K = 2, 3, 8
    jt = j_random_topology(1, C=C, M=M, K=K, K_ps=K, sigma_z2=1.0)
    tt = random_topology(1, C=C, M=M, K=K, K_ps=K, sigma_z2=1.0)
    d = np.random.default_rng(4).standard_normal((C, M, 40)).astype(
        np.float32) * 1e-2
    P = np.float32(0.7)
    want = np.asarray(jch.orthogonal_cluster_ota(
        jax.random.PRNGKey(3), jnp.asarray(d), jt, P,
        jch.OTAConfig(backend=backend, antenna_chunk=4)))
    got = tch.orthogonal_cluster_ota(
        prng.PRNGKey(3), torch.as_tensor(d), tt, torch.tensor(P),
        tch.OTAConfig(backend=backend, antenna_chunk=4)).numpy()
    assert got.shape == want.shape == d.shape
    assert np.abs(got - want).max() <= HOP_ATOL * np.abs(want).max()


def test_orthogonal_hop_ideal_and_superposition_backends():
    tt = uniform_topology(C=2, M=3, K=4, K_ps=4)
    jt = j_uniform_topology(C=2, M=3, K=4, K_ps=4)
    d = torch.ones((2, 3, 6))
    assert tch.orthogonal_cluster_ota(prng.PRNGKey(0), d, tt, 1.0,
                                      tch.OTAConfig(mode="ideal")) is d
    for backend in ("fused", "slab_kernel"):
        with pytest.raises(ValueError) as want:
            jch.orthogonal_cluster_ota(
                jax.random.PRNGKey(0), jnp.ones((2, 3, 6)), jt, 1.0,
                jch.OTAConfig(mode="faithful", backend=backend))
        with pytest.raises(ValueError) as got:
            tch.orthogonal_cluster_ota(
                prng.PRNGKey(0), d, tt, 1.0,
                tch.OTAConfig(mode="faithful", backend=backend))
        assert str(got.value).replace("repro_torch.", "repro.") == str(
            want.value)


CONFIGS = {
    "default": dict(),
    "median on equivalent": dict(cluster_agg="median",
                                 ota=dict(mode="equivalent")),
    "trimmed on reference": dict(cluster_agg="trimmed_mean",
                                 ota=dict(mode="faithful")),
    "median on ideal fused": dict(cluster_agg="median",
                                  ota=dict(mode="ideal", backend="fused")),
    "unknown fold": dict(cluster_agg="krum"),
    "median conventional": dict(cluster_agg="median", mode="conventional"),
    "median on fused": dict(cluster_agg="median",
                            ota=dict(mode="faithful", backend="fused")),
    "trimmed on slab": dict(cluster_agg="trimmed_mean",
                            ota=dict(mode="equivalent",
                                     backend="slab_kernel")),
}


@pytest.mark.parametrize("case", list(CONFIGS))
def test_validate_participation_matches_reference(case):
    assert CLUSTER_AGGREGATORS == jwhfl.CLUSTER_AGGREGATORS
    kw = dict(CONFIGS[case])
    ota = kw.pop("ota", {})
    cfgs = (jwhfl.WHFLConfig(ota=jch.OTAConfig(**ota), **kw),
            WHFLConfig(ota=tch.OTAConfig(**ota), **kw))
    errs = []
    for validate, cfg in zip((jwhfl.validate_participation,
                              validate_participation), cfgs):
        try:
            validate(cfg)
            errs.append(None)
        except ValueError as e:
            errs.append(str(e).replace("repro_torch.", "repro."))
    assert errs[0] == errs[1]


def _f32_ulps(a, b) -> int:
    return abs(int(np.float32(a).view(np.int32))
               - int(np.float32(b).view(np.int32)))


def test_edge_power_of_the_precoded_symbols():
    """One round through the port's round body, its users' training
    replaced by a fixed flat, with one byzantine user per cluster at
    scale 3.0: the edge power is the reference's power of the precoded
    symbols (`repro.core.whfl`, `symbol_power` after `cotaf_precode`)."""
    C, M, two_n = 2, 3, 64
    flat = (np.random.default_rng(5).standard_normal((C, M, two_n))
            .astype(np.float32) * np.float32(1e-2))
    kw = dict(n_byzantine=1, byzantine_scale=3.0)
    topo = uniform_topology(C=C, M=M, K=4, K_ps=4)
    cfg = WHFLConfig(participation=ParticipationSchedule(**kw),
                     ota=tch.OTAConfig(mode="ideal"))
    params = {"w": torch.zeros(two_n)}
    spec = agg.make_flat_spec(params)
    flat_t = torch.as_tensor(flat)
    body = make_round_body(
        topo, cfg, spec, lambda th, st, k, step: (flat_t, st),
        lambda k, f, P: f.mean(dim=1), n_rx=C)
    P = np.float32(0.7)
    out = body(init_round_state(params, sgd(0.1), C, M), prng.PRNGKey(0),
               P, np.float32(10.0))
    got = float(out["power_edge"])

    js = jcl.ParticipationSchedule(**kw)
    mult = jnp.asarray(js.tx_base(C, M)) * js.present(0, C, M)
    want = float(jagg.symbol_power(
        jagg.cotaf_precode(jnp.asarray(flat), mult), P))
    assert _f32_ulps(got, want) <= 1
    # the energy of the unprecoded flat, scaled by m^2, rounds otherwise
    m = torch.as_tensor(np.array(mult))
    other = float(agg.symbol_power_from_energy(
        agg.user_energy(flat_t) * m ** 2, torch.tensor(P), two_n // 2))
    assert other != got


def _run(sc, seeds=1, **kw):
    return sweep.SweepRunner([sc], seeds=seeds, keep_state=True,
                             batch="map", device="cpu", **kw).run()[0]


def test_bernoulli_rate_one_equals_full_bitwise():
    """The whole partial path (mask, precode, rescale) at rate 1.0 lands
    on the full schedule's bits: the mask is all ones, ``x * 1.0`` and a
    ``full / got == 1.0`` rescale are identities."""
    for base in (get_scenario("fig2_iid").quick(),
                 get_scenario("fig2_iid").quick().replace(
                     ota_mode="faithful", ota_backend="fused"),
                 get_scenario("fig2_iid_conventional").quick()):
        base = base.replace(total_IT=4 * base.I)
        full = _run(base, seeds=2)
        b1 = _run(base.replace(participation="bernoulli",
                               participation_rate=1.0), seeds=2)
        for k in ("acc", "loss", "edge_power", "is_power"):
            assert getattr(full, k) == getattr(b1, k), (base.name, k)
        for leaf in ("w", "b"):
            assert torch.equal(full.final_state["theta"][leaf],
                               b1.final_state["theta"][leaf])


def test_zero_attendance_on_ideal_leaves_model_unchanged():
    sc = get_scenario("fig2_iid").quick().replace(
        participation="bernoulli", participation_rate=0.0,
        ota_mode="ideal", total_IT=2, eval_every=1)
    res = _run(sc)
    assert len(set(res.acc[0])) == 1
    assert res.edge_power[0] == [0.0, 0.0]
    theta0 = sc.task_fns()[0](prng.PRNGKey(0))
    for leaf in ("w", "b"):
        assert torch.equal(res.final_state["theta"][leaf][0], theta0[leaf])


def test_sampled_out_user_data_cannot_reach_the_model():
    C, M, n, d = 2, 3, 8, 6
    sched = ParticipationSchedule(kind="bernoulli", rate=0.4, seed=3)
    mask = sched.present(0, C, M).numpy()
    assert mask.min() == 0.0
    c_out, m_out = map(int, np.argwhere(mask == 0)[0])
    rng = np.random.default_rng(0)
    X = rng.standard_normal((C, M, n, d)).astype(np.float32)
    Y = rng.standard_normal((C, M, n)).astype(np.float32)
    X2 = X.copy()
    X2[c_out, m_out] = 1e3 * rng.standard_normal((n, d))

    topo = uniform_topology(C=C, M=M, K=4, K_ps=4)
    for ota in (tch.OTAConfig(mode="ideal"),
                tch.OTAConfig(mode="faithful", backend="fused")):
        cfg = WHFLConfig(tau=2, I=1, batch=4, participation=sched, ota=ota)
        params = {"w": torch.zeros(d)}
        spec = agg.make_flat_spec(params)
        opt = sgd(1e-2)

        def loss(p, x, y, r):
            return torch.mean((x @ p["w"] - y) ** 2)

        outs = []
        for Xv in (X, X2):
            rf = make_round_fn(loss, opt, topo, cfg, spec,
                               torch.as_tensor(Xv), torch.as_tensor(Y))
            outs.append(rf(init_round_state(params, opt, C, M),
                           prng.PRNGKey(7), 1.0, 20.0))
        a, b = outs
        assert torch.equal(a["theta"]["w"], b["theta"]["w"])
        assert float(a["power_edge"]) == float(b["power_edge"])
        assert float(a["power_is"]) == float(b["power_is"])


def test_median_bounds_byzantine_accuracy_loss():
    base = Scenario(name="byz_probe", dataset="mnist", partition="iid",
                    tau=1, I=1, batch=64, mode="whfl", ota_mode="ideal",
                    C=2, M=5, K=8, K_ps=8, total_IT=10, lr=5e-2,
                    n_train=2000, n_test=500, eval_every=10,
                    byzantine_scale=3.0)
    clean = _run(base.replace(name="byz_clean"))
    mean = _run(base.replace(name="byz_mean", n_byzantine=1))
    median = _run(base.replace(name="byz_median", n_byzantine=1,
                               cluster_agg="median"))
    acc_clean, acc_mean, acc_med = (r.acc[0][-1]
                                    for r in (clean, mean, median))
    assert acc_clean > 0.9
    assert acc_mean < acc_clean - 0.15
    assert acc_med > acc_clean - 0.05
    assert acc_med > acc_mean + 0.15


def _assert_same(a, b):
    assert a.rounds == b.rounds and a.seeds == b.seeds
    for k in ("acc", "loss", "edge_power", "is_power"):
        assert getattr(a, k) == getattr(b, k), k
    la, lb = list(tree_leaves(a.final_state)), list(tree_leaves(b.final_state))
    assert [p for p, _ in la] == [p for p, _ in lb]
    for (p, x), (_, y) in zip(la, lb):
        assert x.dtype == y.dtype and torch.equal(x, y), p


RUNS = {
    "drop50 fused gathered": ("fig2_drop50", dict(
        ota_mode="faithful", ota_backend="fused"), "gathered"),
    "drop50 fused u_sharded": ("fig2_drop50", dict(
        ota_mode="faithful", ota_backend="fused"), "u_sharded"),
    "byzantine1_median": ("fig2_byzantine1_median", {}, "gathered"),
}
_SINGLE = {}


def _single(run):
    name, kw, _ = RUNS[run]
    if run not in _SINGLE:
        sc = get_scenario(name).quick().replace(total_IT=ROUNDS, **kw)
        step = sweep.SweepRunner([sc], seeds=2, keep_state=True,
                                 batch="map", device="cpu").run()[0]
        chunk = sweep.SweepRunner([sc], seeds=2, keep_state=True,
                                  driver="chunked", batch="map",
                                  device="cpu").run()[0]
        _assert_same(step, chunk)
        _SINGLE[run] = (sc, step)
    return _SINGLE[run]


@pytest.mark.parametrize("mesh", ["1x1", "2x2", "2x4", "3x2"])
@pytest.mark.parametrize("run", list(RUNS))
def test_sharded_equals_single_both_drivers(run, mesh):
    sc, single = _single(run)
    combine = RUNS[run][2]
    for driver in ("stepwise", "chunked"):
        got = ShardedSweepRunner([sc], seeds=2, keep_state=True, mesh=mesh,
                                 combine=combine, driver=driver,
                                 device="cpu").run()[0]
        _assert_same(got, single)
        assert got.exec_info["mesh"] == mesh
        assert got.exec_info["driver"] == driver
