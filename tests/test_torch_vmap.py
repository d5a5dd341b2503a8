"""The port's seed batching (``batch="vmap"``) against the JAX package's.

Under ``batch="vmap"`` the port runs a scenario's S seeds as one program:
the round and the eval under `torch.func.vmap` over the seed-stacked
state, the OTA kernels reached through custom ops whose vmap rule folds
the seeds into one seed-batched call (`repro_torch.kernels.ops`).  The
JAX package runs the same sweep under `jax.vmap`, its Pallas kernels in
interpret mode.  Tolerances, as the slice's others and why:

- every eval's loss, edge power and IS power within rtol 1e-5, accuracy
  within 1/n_test: the same weights, minibatches and channels, only
  float summation order differs;
- the final model within 1e-4 of the largest parameter magnitude (an
  elementwise rtol fails on weights that cancel to near zero).

Port against port the rules are bitwise: each seed's draws (minibatch
indices, participation masks, the kernels' words) equal its ``map``
run's; under vmap chunked == stepwise, resume == uninterrupted, and
telemetry or the guard on == off; a seed-batched plain kernel's draws
equal S separate calls' (its sums within 1e-6 of the largest output, as
a batched einsum may sum otherwise).
"""
import functools

import jax
import numpy as np
import pytest
import torch

from repro.core import OTAConfig as JOTAConfig
from repro.core import cluster_ota as j_cluster_ota
from repro.core import conventional_ota as j_conventional_ota
from repro.core import global_ota as j_global_ota
from repro.core import uniform_topology as j_uniform_topology
from repro.core import vmap_seeds as j_vmap_seeds
from repro.sim.scenario import SCENARIOS as J_SCENARIOS
from repro.sim.sweep import SweepRunner as JSweepRunner
from repro_torch import prng
from repro_torch.core import (OTAConfig, cluster_ota, conventional_ota,
                              global_ota, uniform_topology, vmap_seeds)
from repro_torch.exec import make_runner
from repro_torch.fed import ParticipationSchedule
from repro_torch.kernels import (fused_mac_plain, fused_noise,
                                 ota_combine_plain)
from repro_torch.sim import sweep
from repro_torch.sim.scenario import get_scenario
from repro_torch.tree import tree_leaves

# one intra-op thread: test workers run side by side, and torch's
# default of one thread per core oversubscribes the CPU many times
torch.set_num_threads(1)

RTOL = 1e-5
THETA_RTOL = 1e-4
PLAIN_RTOL = 1e-6
FIG3_CUT = dict(C=2, M=2, batch=4, tau=2, n_train=200, n_test=50, K=2,
                K_ps=2, total_IT=1, opt="sgd")
BACKENDS = {"equivalent": dict(ota_mode="equivalent", ota_backend=""),
            "fused": dict(ota_mode="faithful", ota_backend="fused"),
            "slab_kernel": dict(ota_mode="faithful",
                                ota_backend="slab_kernel"),
            "reference": dict(ota_mode="faithful",
                              ota_backend="reference")}


def _cases():
    """name -> (registry name, cut, seeds, quick)."""
    out = {b: ("fig2_iid", dict(total_IT=3, **kw), 3, True)
           for b, kw in BACKENDS.items()}
    out["fig2_drop50"] = ("fig2_drop50", dict(total_IT=3), 2, True)
    out["fig3_cifar sgd"] = ("fig3_cifar", FIG3_CUT, 2, False)
    return out


CASES = _cases()


def _scenario(get, name, cut, quick):
    sc = get(name)
    return (sc.quick() if quick else sc).replace(**cut)


@functools.lru_cache(maxsize=None)
def _port(case, **kw):
    name, cut, seeds, quick = CASES[case]
    return sweep.SweepRunner([_scenario(get_scenario, name, cut, quick)],
                             seeds=seeds, keep_state=True, device="cpu",
                             **dict(kw)).run()[0]


@pytest.mark.parametrize("case", list(CASES))
def test_vmap_sweep_matches_the_jax_vmap_sweep(case):
    """Every backend, participation and the CNN: the port's vmap run
    (its default) against the JAX package's (its default)."""
    name, cut, seeds, quick = CASES[case]
    ref = JSweepRunner([_scenario(J_SCENARIOS.__getitem__, name, cut,
                                  quick)], seeds=seeds,
                       keep_state=True).run()[0]
    got = _port(case)
    assert got.exec_info["batch"] == "vmap"
    assert got.rounds == ref.rounds and got.seeds == ref.seeds
    n_test = got.scenario.n_test
    np.testing.assert_allclose(got.acc, ref.acc, rtol=0, atol=1.0 / n_test)
    for key in ("loss", "edge_power", "is_power"):
        np.testing.assert_allclose(getattr(got, key), getattr(ref, key),
                                   rtol=RTOL, err_msg=key)
    want = jax.tree_util.tree_leaves(ref.final_state["theta"])
    have = [x for _, x in tree_leaves(got.final_state["theta"])]
    assert len(want) == len(have)
    scale = max(float(np.abs(np.asarray(w)).max()) for w in want)
    for w, h in zip(want, have):
        assert h.shape == w.shape
        assert np.abs(h.numpy() - np.asarray(w)).max() <= THETA_RTOL * scale


def _bitwise(a, b, keys=("acc", "loss", "edge_power", "is_power")):
    assert a.rounds == b.rounds
    for k in keys:
        assert getattr(a, k) == getattr(b, k), k
    la, lb = list(tree_leaves(a.final_state)), list(tree_leaves(b.final_state))
    assert [p for p, _ in la] == [p for p, _ in lb]
    for (p, x), (_, y) in zip(la, lb):
        assert torch.equal(x, y), p


@pytest.mark.parametrize("contract", ["chunked", "telemetry+guard",
                                      "resume"])
def test_vmap_port_contracts_are_bitwise(contract, tmp_path):
    """Under vmap, on the fused backend: the chunked driver, telemetry
    with the guard, and a resume from a mid-run checkpoint each give the
    plain stepwise run's bits."""
    plain = _port("fused")
    if contract == "chunked":
        _bitwise(plain, _port("fused", driver="chunked"))
        return
    if contract == "telemetry+guard":
        res = _port("fused", telemetry=True, guard="skip_round")
        assert res.exec_info["guard_trips"] == 0
        res.final_state = {k: v for k, v in res.final_state.items()
                           if k not in ("telemetry", "guard_trips")}
        _bitwise(plain, res)
        return
    name, cut, seeds, quick = CASES["fused"]
    sc = _scenario(get_scenario, name, cut, quick)
    ck = str(tmp_path / "ck")
    sweep.SweepRunner([sc], seeds=seeds, device="cpu",
                      checkpoint=ck).run()
    # keep only the save after round 1 (the first window's)
    import os
    scdir = os.path.join(ck, sc.name)
    for f in os.listdir(scdir):
        if f != "round_1.npz":
            os.unlink(os.path.join(scdir, f))
    res = sweep.SweepRunner([sc], seeds=seeds, device="cpu",
                            keep_state=True, checkpoint=ck,
                            resume=True).run()[0]
    assert res.exec_info["resumed_from"] == 1
    _bitwise(plain, res)


def test_vmap_checkpoint_resumes_under_map():
    """A checkpoint cut under vmap resumes under map (and the other way
    round) within the slice's tolerances: the payload is the same
    seed-stacked carry."""
    import tempfile
    name, cut, seeds, quick = CASES["fused"]
    sc = _scenario(get_scenario, name, cut, quick)
    plain = _port("fused")
    for cut_mode, resume_mode in (("vmap", "map"), ("map", "vmap")):
        with tempfile.TemporaryDirectory() as ck:
            sweep.SweepRunner([sc], seeds=seeds, device="cpu", checkpoint=ck,
                              batch=cut_mode).run()
            res = sweep.SweepRunner([sc], seeds=seeds, device="cpu",
                                    keep_state=True, checkpoint=ck,
                                    resume=True, batch=resume_mode
                                    ).run()[0]
        assert res.exec_info["batch"] == resume_mode
        np.testing.assert_allclose(res.loss, plain.loss, rtol=RTOL)
        np.testing.assert_allclose(res.acc, plain.acc, rtol=0,
                                   atol=1.0 / sc.n_test)


@pytest.mark.parametrize("hop,mode", [("cluster", "equivalent"),
                                      ("cluster", "fused"),
                                      ("global", "fused"),
                                      ("conventional", "equivalent")])
def test_vmap_seeds_matches_the_reference(hop, mode):
    """`vmap_seeds` against `repro.core.vmap_seeds`: S realizations in
    one vmap, each equal to its own key's call (bit for bit) and to the
    JAX package's batched hop."""
    S, C, M, N = 4, 2, 3, 64
    j_topo = j_uniform_topology(C=C, M=M, K=8, K_ps=8, sigma_z2=1.0)
    topo = uniform_topology(C=C, M=M, K=8, K_ps=8, sigma_z2=1.0)
    shape = (S, C, M, 2 * N) if hop != "global" else (S, C, 2 * N)
    deltas = np.random.default_rng(7).standard_normal(shape).astype(
        np.float32)
    j_keys = jax.random.split(jax.random.PRNGKey(8), S)
    keys = prng.split(prng.PRNGKey(8), S)
    assert keys.tolist() == np.asarray(j_keys).astype(np.int64).tolist()
    kw = (dict(mode="equivalent") if mode == "equivalent"
          else dict(mode="faithful", backend="fused"))
    fns = {"cluster": (j_cluster_ota, cluster_ota),
           "global": (j_global_ota, global_ota),
           "conventional": (j_conventional_ota, conventional_ota)}[hop]
    want = j_vmap_seeds(fns[0])(j_keys, jax.numpy.asarray(deltas), j_topo,
                                1.0, JOTAConfig(**kw))
    d = torch.as_tensor(deltas)
    got = vmap_seeds(fns[1])(keys, d, topo, torch.tensor(1.0),
                             OTAConfig(**kw))
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())
    for s in range(S):
        one = fns[1](keys[s], d[s], topo, torch.tensor(1.0), OTAConfig(**kw))
        np.testing.assert_allclose(got[s].numpy(), one.numpy(), rtol=0,
                                   atol=PLAIN_RTOL * float(one.abs().max()))


@pytest.mark.parametrize("kernel", ["fused_mac", "ota_combine"])
def test_plain_kernels_with_a_seed_axis_equal_separate_calls(kernel):
    """The plain versions with a leading seed axis (shared gains with a
    seed stride of 0) against S calls: the draws bit for bit, the sums
    within 1e-6 of the largest output."""
    S, B, U, K, N = 3, 2, 5, 7, 130
    rng = np.random.default_rng(11)
    f32 = lambda *s: torch.as_tensor(rng.standard_normal(s).astype(
        np.float32))
    if kernel == "fused_mac":
        seeds = torch.as_tensor(rng.integers(0, 2 ** 32, (S, 2)))
        t_re, t_im = f32(S, U, N), f32(S, U, N)
        amp = torch.as_tensor(rng.uniform(0.5, 2, (B, U)).astype(
            np.float32))
        kw = dict(K=K, sigma_h2=1.0, sigma_z2=2.0, block_u=2)
        got = fused_mac_plain(seeds, t_re, t_im, amp.expand(S, B, U),
                              amp.expand(S, B, U), **kw)
        for s in range(S):
            one = fused_mac_plain(seeds[s], t_re[s], t_im[s], amp, amp, **kw)
            for g, o in zip(got, one):
                assert (g[s] - o).abs().max() <= PLAIN_RTOL * o.abs().max()
        # the receiver noise the plain version starts from, seed-batched
        noise = fused_noise(seeds, B, K, N, 2.0)
        for s in range(S):
            for a, b in zip(noise, fused_noise(seeds[s], B, K, N, 2.0)):
                assert torch.equal(a[s], b)
        return
    cx = lambda *s: torch.complex(f32(*s), f32(*s))
    h, t, z = cx(S, B, U, K, N), cx(S, U, N), cx(S, B, K, N)
    w = torch.as_tensor(rng.uniform(0.5, 2, (B, U)).astype(np.float32))
    got = ota_combine_plain(h, t, z, w.expand(S, B, U))
    assert got.shape == (S, B, N)
    for s in range(S):
        one = ota_combine_plain(h[s], t[s], z[s], w)
        assert (got[s] - one).abs().max() <= PLAIN_RTOL * one.abs().max()


def test_draws_under_vmap_equal_each_seeds_map_draws():
    """Minibatch indices, dropout masks, participation masks and the
    fused kernel's seed words, drawn under a seed vmap, equal each seed's
    own draws bit for bit."""
    S = 3
    keys = prng.split(prng.PRNGKey(5), S)
    vm = torch.func.vmap
    idx = vm(lambda k: prng.randint(prng.split(k, 4), (16,), 0, 300))(keys)
    drop = vm(lambda k: prng.bernoulli(k, 0.7, (2, 8, 8, 4)))(keys)
    nrm = vm(lambda k: prng.normal(k, (5, 6)))(keys)
    for s in range(S):
        assert torch.equal(idx[s], prng.randint(prng.split(keys[s], 4),
                                                (16,), 0, 300))
        assert torch.equal(drop[s], prng.bernoulli(keys[s], 0.7,
                                                   (2, 8, 8, 4)))
        assert torch.equal(nrm[s], prng.normal(keys[s], (5, 6)))
    for sched in (ParticipationSchedule(kind="bernoulli", rate=0.5),
                  ParticipationSchedule(kind="stragglers")):
        steps = torch.tensor([0, 3, 4], dtype=torch.int32)
        masks = vm(lambda t: sched.present(t, 4, 5))(steps)
        for s, t in enumerate(steps):
            assert torch.equal(masks[s], sched.present(t, 4, 5))


def test_vmap_is_the_default_and_records_what_ran(monkeypatch):
    """The single engine, `make_runner` and the CLI run vmap by default
    and record it; the sharded engine runs map; under vmap one
    seed-batched combine serves all seeds of a hop."""
    import importlib
    import inspect

    fm = importlib.import_module("repro_torch.kernels.fused_mac")
    assert inspect.signature(sweep.SweepRunner).parameters[
        "batch"].default == "vmap"
    assert inspect.signature(make_runner).parameters[
        "batch"].default == "vmap"
    sc = get_scenario("fig2_iid").quick().replace(
        total_IT=1, ota_mode="faithful", ota_backend="fused")
    calls = []
    plain = fm.fused_mac_plain
    monkeypatch.setattr(fm, "fused_mac_plain", lambda seed, *a, **k: (
        calls.append(tuple(torch.as_tensor(seed).shape)), plain(
            seed, *a, **k))[1])
    res = make_runner("single", [sc], seeds=3, device="cpu").run()[0]
    assert res.exec_info["batch"] == "vmap"
    assert res.exec_info["cpu_threads"] == 1
    assert calls == [(3, 2), (3, 2)]          # cluster hop, IS -> PS hop
    calls.clear()
    res = make_runner("sharded", [sc], seeds=3, device="cpu",
                      mesh="1x1").run()[0]
    assert res.exec_info["batch"] == "map"
    # one seed's words a call: two hops of each of 3 seeds
    assert len(calls) == 2 * 3 and {np.prod(c) for c in calls} == {2}
    doc = sweep.main(["--scenarios", "fig2_iid", "--quick", "--device",
                      "cpu", "--seeds", "2"])
    assert doc["scenarios"][0]["exec"]["batch"] == "vmap"
    # a split and a round a round, an eval a window (5 windows of 8
    # rounds), once for both seeds
    assert doc["scenarios"][0]["exec"]["dispatches"] == 2 * 8 + 5
