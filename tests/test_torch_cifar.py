"""The port's CIFAR CNN and the Fig. 3 scenario family, against the JAX
package and against the port's own single engine.

Inputs are made from a seed with numpy (or drawn from one integer seed
through both PRNGs).  Tolerances, and why:

- the flat vector, the parameter tree's leaf order and the dropout
  masks: byte for byte (the order decides which parameter each channel
  symbol, noise draw and Adam moment belongs to);
- `cifar_init`: within 4 ULP (the normals' erfinv, as in
  tests/test_torch_prng.py);
- logits: within 1e-5 of max |logit| (measured 3.1e-6 in eval mode and
  1.3e-6 with dropout; convolutions sum in another order);
- the loss's gradient with dropout: every entry within 1e-5 of the
  largest gradient entry, and every leaf but the conv biases within
  1e-5 of its own largest entry (measured 4e-6).  A conv bias sits ahead
  of batch norm, which subtracts the batch mean, so its gradient is zero
  in exact arithmetic: both sides return rounding noise (~1e-7 of the
  largest entry) that agrees in nothing but its size;
- round 1 of a cut ``fig3_cifar`` (C 2, M 2, batch 4, tau 2, 200
  training samples, K = K_ps = 2, so the plain fused combine takes
  half a second a hop): the final model, the opt state and the power
  accumulators within tests/test_torch_slice.py's rtol 1e-5, with SGD
  (measured 1e-7).  With the registered Adam the conv biases' rounding
  noise becomes steps of up to the learning rate (Adam divides the
  gradient by its own size), so they part from the reference by ~1e-2
  of their largest value, and the OTA hops, which pack coordinates n
  and n + N into one complex symbol, carry that into the noise of the
  partner coordinates (~1e-3 of conv[5].w and fc_w).  The Adam run is
  held on the error-free channel, where nothing couples coordinates:
  the conv biases within two learning-rate steps per local step
  (measured 2.7 lr at tau 2), every other entry within 0.1 lr (measured
  0.045 lr, on 3e-5 of conv[4].w's entries; elsewhere below 6e-4 lr):
  Adam's step is lr m/sqrt(v) whatever the gradient's size, so an entry
  whose gradient is near zero, and known only to a large relative
  error, can take a step that differs by a share of lr; the moments of
  every leaf but the conv biases within 1e-4 of the leaf's largest
  (tests/test_torch_slice.py's final-model bound; measured 7.4e-5: the
  second step's gradients are taken at models that differ so).  The
  power accumulators sum the conv biases' squares too (4.8e-5 apart
  here), so the SGD runs hold them;
- sharded against single: bit for bit.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.aggregation import flatten as j_flatten
from repro.core.aggregation import make_flat_spec as j_make_flat_spec
from repro.core.whfl import accuracy as j_accuracy
from repro.core.whfl import init_round_state as j_init_round_state
from repro.core.whfl import make_round_fn as j_make_round_fn
from repro.models import paper_models as jm
from repro.nn.core import split_params
from repro.optim import adam as j_adam
from repro.optim import sgd as j_sgd
from repro.sim.scenario import SCENARIOS as J_SCENARIOS
from repro.sim.scenario import TASKS as J_TASKS
from repro_torch import convert, prng
from repro_torch.core import aggregation as agg
from repro_torch.core import whfl
from repro_torch.exec import ShardedSweepRunner
from repro_torch.models import paper_models as tm
from repro_torch.optim import adam, sgd
from repro_torch.sim import sweep
from repro_torch.sim.scenario import TASKS, get_scenario
from repro_torch.tree import tree_leaves

# one intra-op thread: test workers run side by side, and torch's
# default of one thread per core oversubscribes the CPU many times
torch.set_num_threads(1)

RTOL = 1e-5
LOGIT_RTOL = 1e-5
FIG3 = ("fig3_cifar", "fig3_cifar_I2", "fig3_cifar_I4",
        "fig3_cifar_conventional", "fig3_cifar_ideal",
        "fig3_cifar_conv_ideal")
CUT = dict(C=2, M=2, batch=4, tau=2, n_train=200, n_test=50, K=2, K_ps=2)


@functools.lru_cache(maxsize=None)
def _j_px(seed):
    """The reference's `cifar_init` tree (with its Px wrappers)."""
    return jm.cifar_init(jax.random.PRNGKey(seed))


def _j_params(seed=0):
    return jax.device_get(split_params(_j_px(seed))[0])


def _leaves(tree):
    return [(p, x) for p, x in tree_leaves(tree)]


def _j_leaves(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    out = []
    for path, x in flat:
        out.append((tuple(getattr(k, "key", getattr(k, "idx", None))
                          for k in path), np.asarray(x)))
    return out


def test_flat_vector_and_leaf_order_equal_the_reference():
    jp = _j_params(3)
    tp = convert.params_from_jax(jp)
    spec = agg.make_flat_spec(tp)
    j_spec = j_make_flat_spec(jp)
    assert spec.two_n == j_spec.two_n == 308394
    assert tm.n_params(tp) == 308394 == jm.n_params(_j_px(3))
    # jax.tree's order: dicts by sorted key, the conv list by index
    assert [p for p, _ in _j_leaves(jp)] == list(spec.paths)
    assert spec.paths[:5] == (("conv", 0, "b"), ("conv", 0, "bn_bias"),
                              ("conv", 0, "bn_scale"), ("conv", 0, "w"),
                              ("conv", 1, "b"))
    assert spec.paths[-2:] == (("fc_b",), ("fc_w",))
    flat = agg.flatten(spec, tp)
    assert flat.numpy().tobytes() == np.asarray(
        j_flatten(j_spec, jp)).tobytes()
    back = agg.unflatten(spec, flat)
    assert isinstance(back["conv"], list) and len(back["conv"]) == 6
    assert back["conv"][0]["w"].shape == (3, 3, 3, 32)       # HWIO
    assert all(torch.equal(a, b) for (_, a), (_, b)
               in zip(_leaves(back), _leaves(tp)))
    # with a leading user axis, as the round flattens per-user trees
    lead = agg.flatten(spec, {"conv": [{k: v.expand(2, *v.shape)
                                        for k, v in c.items()}
                                       for c in tp["conv"]],
                              "fc_b": tp["fc_b"].expand(2, 10),
                              "fc_w": tp["fc_w"].expand(2, 2048, 10)})
    assert lead.shape == (2, 308394) and torch.equal(lead[1], flat)


def test_convert_round_trips_cnn_params_and_adam_state():
    jp = _j_params()
    back = convert.to_numpy(convert.params_from_jax(jp))
    for (pa, a), (pb, b) in zip(_j_leaves(jp), _leaves(back)):
        assert pa == pb and a.dtype == b.dtype and a.tobytes() == b.tobytes()
    state = jax.device_get(j_init_round_state(jp, j_adam(1e-3), 2, 3))
    t_state = convert.state_from_jax(state)
    assert isinstance(t_state["opt"]["m"]["conv"], list)
    assert t_state["opt"]["v"]["conv"][5]["w"].shape == (2, 3, 3, 3, 128,
                                                        128)
    mine = whfl.init_round_state(convert.params_from_jax(jp), adam(1e-3), 2,
                                 3)
    assert [p for p, _ in _leaves(mine["opt"])] == [
        p for p, _ in _leaves(t_state["opt"])]


def test_adam_on_the_cnn_tree_matches_reference():
    """`optim.adam` walks the CNN's tree through `tree_map` (lists
    included): one update from the same gradients and moments."""
    jp = _j_params()
    rng = np.random.default_rng(6)
    jg = jax.tree.map(lambda x: rng.standard_normal(x.shape).astype(
        np.float32), jp)
    j_opt = j_adam(1e-3)
    st = j_opt.init(jp)
    j_upd, j_st = j_opt.update(jg, st, jp, jnp.int32(0))
    j_upd, j_st = j_opt.update(jg, j_st, jp, jnp.int32(1))
    t_opt = adam(1e-3)
    tp, tg = convert.params_from_jax(jp), convert.params_from_jax(jg)
    t_st = t_opt.init(tp)
    t_upd, t_st = t_opt.update(tg, t_st, tp, torch.tensor(0))
    t_upd, t_st = t_opt.update(tg, t_st, tp, torch.tensor(1))
    for (pa, a), (pb, b) in zip(_j_leaves(jax.device_get(j_upd)),
                                _leaves(t_upd)):
        assert pa == pb
        np.testing.assert_allclose(b.numpy(), a, rtol=RTOL, atol=0)


@pytest.mark.parametrize("shape,p", [((5, 7), 0.8), ((3, 16, 16, 32), 0.7),
                                     ((128, 4, 4, 128), 0.6), ((1,), 0.5),
                                     ((33,), 0.999)])
def test_bernoulli_equals_jax(shape, p):
    key = jax.random.PRNGKey(11)
    want = np.asarray(jax.random.bernoulli(key, p, shape))
    got = prng.bernoulli(prng.PRNGKey(11), p, shape)
    assert got.dtype == torch.bool and got.shape == shape
    assert np.array_equal(got.numpy(), want)


def test_bernoulli_batched_and_under_vmap_equals_jax():
    keys = jax.random.split(jax.random.PRNGKey(5), 4)        # [U, 2]
    want = np.asarray(jax.vmap(
        lambda k: jax.random.bernoulli(k, 0.7, (6, 9)))(keys))
    t_keys = torch.as_tensor(np.asarray(keys).astype(np.int64))
    assert np.array_equal(prng.bernoulli(t_keys, 0.7, (6, 9)).numpy(), want)
    vm = torch.func.vmap(lambda k: prng.bernoulli(k, 0.7, (6, 9)))(t_keys)
    assert np.array_equal(vm.numpy(), want)


def test_dropout_masks_are_the_reference_draws():
    """`dropout_masks` draws what the reference's `cifar_apply` draws:
    after each pool ``rng, sub = split(rng)``, then bernoulli(1 - rate)
    in the NHWC shape; batched over users it gives each user's."""
    keys = jax.random.split(jax.random.PRNGKey(8), 3)
    t_keys = torch.as_tensor(np.asarray(keys).astype(np.int64))
    masks = tm.dropout_masks(t_keys, 4)
    for u in range(3):
        rng = keys[u]
        for j, (rate, shape) in enumerate(zip((0.2, 0.3, 0.4),
                                              tm.dropout_shapes(4))):
            rng, sub = jax.random.split(rng)
            want = np.asarray(jax.random.bernoulli(sub, 1 - rate, shape))
            assert masks[j][u].shape == shape
            assert np.array_equal(masks[j][u].numpy(), want)


def test_cifar_init_within_4_ulp():
    jp = _j_params(9)
    tp = tm.cifar_init(prng.PRNGKey(9))
    for (pa, a), (pb, b) in zip(_j_leaves(jp), _leaves(tp)):
        assert pa == pb and a.shape == tuple(b.shape)
        np.testing.assert_allclose(b.numpy(), a, rtol=4 * 2 ** -23, atol=0)


@pytest.mark.parametrize("train", [False, True])
def test_cifar_apply_matches_reference(train):
    jp = _j_params()
    tp = convert.params_from_jax(jp)
    x = np.random.default_rng(0).standard_normal((8, 32, 32, 3)).astype(
        np.float32)
    kw_j = dict(train=True, rng=jax.random.PRNGKey(9)) if train else {}
    kw_t = dict(train=True, rng=prng.PRNGKey(9)) if train else {}
    want = np.asarray(jm.cifar_apply(jp, jnp.asarray(x), **kw_j))
    got = tm.cifar_apply(tp, torch.as_tensor(x), **kw_t).numpy()
    assert got.shape == (8, 10)
    assert np.abs(got - want).max() <= LOGIT_RTOL * np.abs(want).max()
    if train:      # the drawn masks, handed in, give the same logits
        masks = tm.dropout_masks(prng.PRNGKey(9), 8)
        again = tm.cifar_apply(tp, torch.as_tensor(x), train=True,
                               rng=masks).numpy()
        assert again.tobytes() == got.tobytes()


def test_loss_gradient_with_dropout_matches_reference():
    jp = _j_params()
    tp = convert.params_from_jax(jp)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((4, 32, 32, 3)).astype(np.float32)
    y = rng.integers(0, 10, 4).astype(np.int32)
    j_loss, t_loss = J_TASKS["cifar"][2], TASKS["cifar"][2]
    jg = jax.device_get(jax.grad(j_loss)(jp, jnp.asarray(x), jnp.asarray(y),
                                         jax.random.PRNGKey(7)))
    tg = torch.func.grad(t_loss)(tp, torch.as_tensor(x), torch.as_tensor(y),
                                 prng.PRNGKey(7))
    top = max(np.abs(a).max() for _, a in _j_leaves(jg))
    for (pa, a), (pb, b) in zip(_j_leaves(jg), _leaves(tg)):
        assert pa == pb
        gap = np.abs(b.numpy() - a).max()
        assert gap <= RTOL * top, pa
        if pa[-1] != "b" or pa[0] != "conv":
            assert gap <= RTOL * np.abs(a).max(), pa


def _round_one(sc_name, backend, opt_name):
    """One round of the cut scenario through both packages from the same
    weights: (reference state, port state, port initial params)."""
    kw = dict(CUT, opt=opt_name)
    if backend:
        kw.update(ota_mode="faithful", ota_backend=backend)
    jsc = J_SCENARIOS[sc_name].replace(**kw)
    sc = get_scenario(sc_name).replace(**kw)
    X, Y, _, _ = jsc.make_data()
    topo = jsc.make_topology()
    jp = _j_params(0)
    j_opt = (j_adam if opt_name == "adam" else j_sgd)(jsc.lr)
    state = j_init_round_state(jp, j_opt, topo.C, topo.M)
    key = jax.random.split(jax.random.PRNGKey(1))[1]
    ref = jax.device_get(jax.jit(j_make_round_fn(
        jsc.task_fns()[2], j_opt, topo, jsc.whfl_config(),
        j_make_flat_spec(jp), X, Y))(state, key, 0.5, 10.0))
    tp = convert.params_from_jax(jp)
    t_opt = (adam if opt_name == "adam" else sgd)(sc.lr)
    round_fn = whfl.make_round_fn(
        sc.task_fns()[2], t_opt, sc.make_topology(), sc.whfl_config(),
        agg.make_flat_spec(tp), torch.as_tensor(X), torch.as_tensor(Y))
    got = round_fn(whfl.init_round_state(tp, t_opt, topo.C, topo.M),
                   prng.split(prng.PRNGKey(1))[1], 0.5, 10.0)
    return ref, got


@pytest.mark.parametrize("backend", ["", "fused"])
def test_round_one_matches_reference(backend):
    """`equivalent` (fig3's registered channel) and faithful with `fused`
    (the plain version here), with SGD (see the module docstring)."""
    ref, got = _round_one("fig3_cifar", backend, "sgd")
    for (pa, a), (pb, b) in zip(_j_leaves(ref["theta"]),
                                _leaves(got["theta"])):
        assert pa == pb
        assert np.abs(b.numpy() - a).max() <= RTOL * np.abs(a).max(), pa
    for k in ("power_edge", "power_is", "n_edge_tx", "n_is_tx"):
        np.testing.assert_allclose(float(got[k]), float(ref[k]), rtol=RTOL,
                                   err_msg=k)
    assert int(got["t"]) == int(ref["t"]) == 1


def test_round_one_with_adam_on_the_error_free_channel():
    """The registered Adam on ``fig3_cifar_ideal``, with the bounds in
    units of the learning rate given in the module docstring."""
    ref, got = _round_one("fig3_cifar_ideal", "", "adam")
    lr, tau = J_SCENARIOS["fig3_cifar_ideal"].lr, CUT["tau"]
    for tree in ("theta", "opt"):
        for (pa, a), (pb, b) in zip(_j_leaves(ref[tree]),
                                    _leaves(got[tree])):
            assert pa == pb
            gap = np.abs(b.numpy() - a).max()
            conv_bias = "conv" in pa and pa[-1] == "b"
            if tree == "theta":
                assert gap <= (2 * lr * tau if conv_bias else 0.1 * lr), pa
            elif not conv_bias:
                assert gap <= 1e-4 * np.abs(a).max(), pa
    assert int(got["t"]) == int(ref["t"]) == 1


@pytest.mark.parametrize("name", FIG3)
def test_every_fig3_scenario_runs_on_both_engines(name):
    """All six, cut to 1 round at the CUT sizes with tau 1 and 20 test samples: the single
    engine stepwise, the sharded one (2x2, u_sharded) chunked; the same
    bits."""
    sc = get_scenario(name).replace(**{**CUT, "tau": 1, "n_test": 20},
                                    total_IT=get_scenario(name).I)
    single = sweep.SweepRunner([sc], device="cpu", keep_state=True,
                               batch="map").run()[0]
    sharded = ShardedSweepRunner([sc], device="cpu", keep_state=True,
                                 mesh="2x2", combine="u_sharded",
                                 driver="chunked").run()[0]
    assert single.rounds == sharded.rounds == [1]
    assert np.all(np.isfinite(single.loss + single.edge_power))
    for k in ("acc", "loss", "edge_power", "is_power"):
        assert getattr(single, k) == getattr(sharded, k), k
    for (_, a), (_, b) in zip(_leaves(single.final_state),
                              _leaves(sharded.final_state)):
        assert torch.equal(a, b)


def test_quick_fig3_sweep_on_cpu(tmp_path):
    """``--quick`` fig3 through the sweep CLI's runner, cut to 2 rounds
    of batch 16 for the test's time: the reference's record schema,
    finite metrics."""
    sc = get_scenario("fig3_cifar").quick().replace(total_IT=2, batch=16)
    res = sweep.SweepRunner([sc], seeds=1, device="cpu").run()
    rec = sweep.sweep_to_json(res, quick=True)["scenarios"][0]
    assert tuple(rec) == sweep.RECORD_KEYS
    assert rec["rounds"] == [1, 2] and rec["scenario"]["dataset"] == "cifar"
    assert np.all(np.isfinite(np.asarray(rec["metrics"]["loss"])))
    assert 0.0 <= rec["final"]["acc_mean"] <= 1.0


@functools.lru_cache(maxsize=None)
def _fig3_fused_single():
    sc = get_scenario("fig3_cifar").replace(
        **CUT, total_IT=2, ota_mode="faithful", ota_backend="fused")
    return sc, sweep.SweepRunner([sc], device="cpu", keep_state=True,
                                 batch="map").run()[0]


@pytest.mark.parametrize("mesh", ["1x1", "2x2", "1x3"])
def test_sharded_equals_single_bitwise(mesh):
    """fig3 faithful/fused cut to CUT, 2 rounds; 1x3 pads a user into
    each cluster."""
    sc, single = _fig3_fused_single()
    sharded = ShardedSweepRunner([sc], device="cpu", keep_state=True,
                                 mesh=mesh, combine="u_sharded").run()[0]
    for k in ("acc", "loss", "edge_power", "is_power"):
        assert getattr(single, k) == getattr(sharded, k), k
    for (pa, a), (pb, b) in zip(_leaves(single.final_state),
                                _leaves(sharded.final_state)):
        assert pa == pb and torch.equal(a, b), pa


def test_accuracy_pads_the_last_batch_like_the_reference():
    """n % batch != 0: the last batch is padded with zero rows to the full
    batch (the CNN's batch statistics then are the reference's), and the
    padded rows are not counted."""
    jp = _j_params()
    tp = convert.params_from_jax(jp)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((21, 32, 32, 3)).astype(np.float32)
    y = rng.integers(0, 10, 21).astype(np.int32)
    seen = []

    def apply(params, xb):
        seen.append(xb.shape[0])
        return tm.cifar_apply(params, xb)

    got = whfl.accuracy(apply, tp, torch.as_tensor(x), torch.as_tensor(y),
                        batch=8)
    assert seen == [8, 8, 8]
    want = j_accuracy(jm.cifar_apply, jp, x, y, batch=8)
    assert got == want
    # the padded batch's statistics decide the last rows' logits
    logits = tm.cifar_apply(tp, torch.as_tensor(np.concatenate(
        [x[16:], np.zeros((3, 32, 32, 3), np.float32)])))[:5]
    alone = tm.cifar_apply(tp, torch.as_tensor(x[16:]))
    assert not torch.equal(logits, alone)
