"""The sharded W-HFL sweep with one process per shard (`repro_torch.exec.
ShardedSweepRunner(ranks="gloo")`, `launch.ranks.sweep_worker`,
`sharding.all_gather`), on gloo ranks on the CPU, at
``tests/test_torch_sharded.py``'s size: ``scale_u256`` cut to C 2, M 8,
K 4, 2 rounds, Adam, 2 seeds.

What is held, and to what:

- the collective on 4 ranks of a 2x2 ``("cluster", "user")`` mesh:
  `all_gather` over ``user``, ``cluster`` and both, along each axis,
  gives `jax.lax.all_gather(..., tiled=True)`'s results, written out in
  numpy (a group's members in mesh order), bit for bit, each one
  recorded once by `record_collectives` with its group's size;
- one round's collectives on each rank, in order, with their sizes: the
  flat block gathered over ``user`` then ``cluster``; then under
  ``gathered`` the fused hop's tiles gathered over ``user`` then
  ``cluster``, under ``u_sharded`` the partial sums over ``cluster`` and
  the folded estimate over ``user``; no more for the closed-form
  backend;
- ranks == the one-process sharded engine bit for bit (every metric,
  the final state): fused 2x2 gathered and u_sharded through both
  drivers, 2x3 u_sharded (users padded to 2x9) through both, the
  equivalent and the conventional hops on 2x2, and fig2_drop10 (partial
  participation) with telemetry on 2x2; each rank's metrics alike, and
  `peak_symbol_bytes` a rank's;
- ranks against the JAX package's `ShardedSweepRunner` (gathered, 2x2,
  on 4 forced host devices in a subprocess) to
  ``tests/test_torch_slice.py``'s bounds: loss and power rtol 1e-5,
  accuracy 1/n_test, the final model within 1e-4 of max |theta|;
- the sweep CLI with ``--ranks gloo``; a world of one in this process;
  the refusals: NCCL without a card a rank, ``--ranks`` without
  ``--exec sharded``, checkpoints and resume on ranks.

The ranks' launches run in a thread beside the one-process references
and the JAX subprocess; the file takes ~60 s alone on one core a
process.
"""
import os
import subprocess
import sys
import textwrap
import threading

import numpy as np
import pytest
import torch

from repro_torch.exec import ShardedSweepRunner, make_runner
from repro_torch.launch import ranks
from repro_torch.sim import sweep
from repro_torch.sim.scenario import get_scenario
from repro_torch.tree import tree_leaves

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL = 1e-5
THETA_RTOL = 1e-4
SMALL = dict(C=2, M=8, K=4, K_ps=4, total_IT=2, n_train=4 * 16 * 4)


def _small(**kw):
    """scale_u256 cut to C=2, M=8, K=4, 2 rounds (Adam, so that the
    optimizer state is not empty)."""
    return get_scenario("scale_u256").replace(**SMALL, opt="adam", **kw)


def _scenario(name):
    if name == "fused":
        return _small()
    if name == "equivalent":
        return _small(ota_mode="equivalent", ota_backend="")
    if name == "conventional":
        return _small(mode="conventional")
    return get_scenario("fig2_drop10").quick().replace(telemetry=True,
                                                       total_IT=2)


# (case, scenario, mesh, combine, driver): one launch per mesh
CASES = [
    ("fused 2x2 gathered stepwise", "fused", "2x2", "gathered", "stepwise"),
    ("fused 2x2 gathered chunked", "fused", "2x2", "gathered", "chunked"),
    ("fused 2x2 u_sharded stepwise", "fused", "2x2", "u_sharded",
     "stepwise"),
    ("fused 2x2 u_sharded chunked", "fused", "2x2", "u_sharded", "chunked"),
    ("equivalent 2x2", "equivalent", "2x2", "gathered", "stepwise"),
    ("conventional 2x2", "conventional", "2x2", "gathered", "stepwise"),
    ("drop10 telemetry 2x2", "drop10", "2x2", "u_sharded", "stepwise"),
    ("fused 2x3 u_sharded stepwise", "fused", "2x3", "u_sharded",
     "stepwise"),
    ("fused 2x3 u_sharded chunked", "fused", "2x3", "u_sharded", "chunked"),
]

_JAX_SCRIPT = """
import sys
import numpy as np
from repro.exec import ShardedSweepRunner
from repro.sim.scenario import SCENARIOS
sc = SCENARIOS["scale_u256"].replace(**{small!r}, opt="adam")
r = ShardedSweepRunner([sc], seeds=2, mesh="2x2", keep_state=True,
                       combine="gathered").run()[0]
out = {{k: np.asarray(getattr(r, k)) for k in ("rounds", "acc", "loss",
                                               "edge_power", "is_power")}}
for leaf in ("w", "b"):
    out["theta/" + leaf] = np.asarray(r.final_state["theta"][leaf])
np.savez(sys.argv[1], **out)
print("OK")
"""

# the gathers on 2x2: (names, axis)
COLLECTIVES = [
    ("user", 0),
    ("user", 1),
    ("user", -1),
    ("cluster", 0),
    ("cluster", 2),
    (("cluster", "user"), 1),
    (("cluster", "user"), 2),
]


def _x(rank):
    return (np.arange(24, dtype=np.float32).reshape(2, 3, 4)
            + 100.0 * rank)


def _members(rank, names):
    """The ranks of `rank`'s group over `names` on the 2x2 mesh, in mesh
    order (rank = ci * 2 + ui)."""
    ci, ui = divmod(rank, 2)
    names = (names,) if isinstance(names, str) else names
    if names == ("user",):
        return [ci * 2 + u for u in range(2)]
    if names == ("cluster",):
        return [c * 2 + ui for c in range(2)]
    return list(range(4))


def _lax(rank, names, axis):
    """`jax.lax.all_gather(..., tiled=True)` on rank `rank`, in numpy."""
    return np.concatenate([_x(m) for m in _members(rank, names)],
                          axis=axis)


def _round_collectives(sc, combine):
    """One round of `sc` on this rank's shard of the 2x2 mesh under
    `record_collectives`: [(op, axes, group size, numel)] in order."""
    from repro_torch import prng
    from repro_torch.core import aggregation as agg
    from repro_torch.core.whfl import init_round_state
    from repro_torch.exec import make_sharded_round_fn
    from repro_torch.optim import adam
    from repro_torch.sharding import record_collectives
    from repro_torch.sharding.api import current_axes

    init_fn, _, loss_fn = sc.task_fns()
    X, Y, _, _ = sc.make_data()
    params = init_fn(prng.PRNGKey(0, "cpu"))
    spec = agg.make_flat_spec(params)
    opt = adam(sc.lr)
    mesh = current_axes().mesh
    round_fn = make_sharded_round_fn(loss_fn, opt, sc.make_topology(),
                                     sc.whfl_config(), spec,
                                     torch.as_tensor(X), torch.as_tensor(Y),
                                     mesh, combine)
    state = init_round_state(params, opt, sc.C // 2, sc.M // 2)
    with record_collectives() as log:
        round_fn(state, prng.PRNGKey(1, "cpu"), torch.tensor(1.0),
                 torch.tensor(20.0))
    return [(r["op"], r["axes"], r["group_size"], r["numel"]) for r in log]


def _worker(rank, world, specs):
    """The collectives and one round's records (on 2x2), then the
    sweeps of `specs` (`ranks.sweep_worker`)."""
    from repro_torch.exec import make_rank_mesh
    from repro_torch.sharding import (P, all_gather, record_collectives,
                                      shard_map)

    torch.set_num_threads(1)
    out = {}
    if world == 4:
        def checks():
            res = []
            for names, axis in COLLECTIVES:
                with record_collectives() as log:
                    y = all_gather(torch.as_tensor(_x(rank)), names, axis)
                res.append((y.numpy(), [(r["op"], r["group_size"])
                                        for r in log]))
            rounds = {label: _round_collectives(_scenario(n), c)
                      for label, n, c in (
                          ("gathered", "fused", "gathered"),
                          ("u_sharded", "fused", "u_sharded"),
                          ("equivalent", "equivalent", "gathered"))}
            return res, rounds
        out["collectives"], out["rounds"] = shard_map(
            checks, make_rank_mesh((2, 2), "cpu"), P(), P())()
    out["sweeps"] = ranks.sweep_worker(rank, world, specs)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every case on its ranks (one launch a mesh, in a thread), the
    one-process references beside them, and the JAX run."""
    tmp = tmp_path_factory.mktemp("sweep_ranks")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.path.join(_REPO, "src"))
    proc = subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(_JAX_SCRIPT.format(
            small=SMALL)), str(tmp / "jax.npz")], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    launches = {}

    def launch_all():
        for mesh in ("2x2", "2x3"):
            cases = [c for c in CASES if c[2] == mesh]
            specs = [dict(scenarios=[_scenario(n)], seeds=[0, 1],
                          keep_state=True, mesh=tuple(map(int,
                                                          m.split("x"))),
                          combine=c, driver=d, device="cpu")
                     for _, n, m, c, d in cases]
            world = specs[0]["mesh"][0] * specs[0]["mesh"][1]
            launches[mesh] = (cases, ranks.launch(_worker, world, "gloo",
                                                  specs))

    thread = threading.Thread(target=launch_all)
    thread.start()
    refs = {}
    for _, n, mesh, combine, _ in CASES:
        if (n, mesh, combine) not in refs:
            refs[n, mesh, combine] = ShardedSweepRunner(
                [_scenario(n)], seeds=2, keep_state=True, device="cpu",
                mesh=mesh, combine=combine).run()[0]
    thread.join(timeout=900)
    assert not thread.is_alive(), "the launches of ranks did not end"
    stdout, stderr = proc.communicate(timeout=900)
    assert proc.returncode == 0, stdout + "\n" + stderr
    assert set(launches) == {"2x2", "2x3"}, "a launch of ranks failed"
    per_case = {}
    for cases, reps in launches.values():
        for i, case in enumerate(cases):
            per_case[case[0]] = [r["sweeps"][i] for r in reps]
    return {"cases": per_case, "refs": refs, "jax": dict(np.load(
        tmp / "jax.npz")), "workers": launches["2x2"][1]}


@pytest.mark.parametrize("i", range(len(COLLECTIVES)),
                         ids=[f"all_gather {names} {axis}"
                              for names, axis in COLLECTIVES])
def test_collectives_give_lax_results(runs, i):
    names, axis = COLLECTIVES[i]
    for rank, w in enumerate(runs["workers"]):
        got, log = w["collectives"][i]
        want = _lax(rank, names, axis)
        assert got.shape == want.shape and got.tobytes() == want.tobytes()
        assert log == [("all_gather", len(_members(rank, names)))], log


@pytest.mark.parametrize("combine", ["gathered", "u_sharded", "equivalent"])
def test_a_round_records_the_engine_collectives(runs, combine):
    sc = _small()
    two_n = 2 * 3925
    flat = [("all_gather", ["user"], 2, 1 * 4 * two_n),
            ("all_gather", ["cluster"], 2, 1 * 8 * two_n)]
    G_loc = sc.C // 2 * sc.M // 8              # canonical_block_u(8) = 8
    hop = {"gathered": [("all_gather", ["user"], 2, 2 * 1 * 1963),
                        ("all_gather", ["cluster"], 2, 2 * 1 * 3925)],
           "u_sharded": [("all_gather", ["cluster"], 2,
                          4 * 2 * G_loc * sc.K * 1963),
                         ("all_gather", ["user"], 2, 2 * 2 * 1963)],
           "equivalent": []}[combine]
    for w in runs["workers"]:
        got = [tuple(r) for r in w["rounds"][combine]]
        assert got == flat + hop, (combine, got)


@pytest.mark.parametrize("case", [c[0] for c in CASES])
def test_ranks_equal_one_process_bitwise(runs, case):
    _, name, mesh, combine, driver = next(c for c in CASES if c[0] == case)
    want = runs["refs"][name, mesh, combine]
    reps = runs["cases"][case]
    mc, mu = map(int, mesh.split("x"))
    assert len(reps) == mc * mu
    for rep in reps:
        (got,) = rep["results"]
        for key in ("rounds", "acc", "loss", "edge_power", "is_power"):
            assert getattr(got, key) == getattr(want, key), (rep["rank"],
                                                             key)
        la, lb = list(tree_leaves(want.final_state)), list(
            tree_leaves(got.final_state))
        assert [p for p, _ in la] == [p for p, _ in lb]
        for (p, x), (_, y) in zip(la, lb):
            assert x.dtype == y.dtype and torch.equal(x, y), (rep["rank"], p)
        if want.telemetry is not None:
            assert got.telemetry == want.telemetry
        info = got.exec_info
        assert (info["device_count"], info["ranks"], info["driver"],
                info["mesh"]) == (mc * mu, "gloo", driver, mesh)
        assert rep["coordinate"] == dict(zip(("cluster", "user"),
                                             divmod(rep["rank"], mu)))
        assert rep["launches"]["fused_mac"] == 0      # plain on the CPU
        assert rep["collective_seconds"] >= 0


def test_peak_symbol_bytes_are_a_ranks(runs):
    """gathered 2x2: the gathered flat block [C, M, 2N], the complex
    symbols of all U users and their two planes, the [U, N_loc] tile;
    u_sharded 2x2 adds its partial sums and every tile's."""
    U, N, N_loc, K = 16, 3925, 1963, 4
    base = 8 * U * N
    got = {c: runs["cases"][f"fused 2x2 {c} stepwise"][0]["results"][0]
           .exec_info["peak_symbol_bytes"] for c in ("gathered",
                                                     "u_sharded")}
    assert got["gathered"] == base + 16 * U * N + 8 * U * N_loc
    rows, G = 8, 2
    assert got["u_sharded"] == (base + 16 * rows * N + 8 * rows * N_loc
                                + 16 * 2 * (G + G // 2) * K * N_loc)
    one = runs["refs"]["fused", "2x2", "u_sharded"].exec_info
    assert one["peak_symbol_bytes"] != got["u_sharded"]


def test_ranks_match_jax_sharded_engine(runs):
    ref = runs["jax"]
    got = runs["cases"]["fused 2x2 gathered stepwise"][0]["results"][0]
    n_test = _small().n_test
    assert list(ref["rounds"]) == got.rounds
    np.testing.assert_allclose(got.acc, ref["acc"], rtol=0,
                               atol=1.0 / n_test)
    for key in ("loss", "edge_power", "is_power"):
        np.testing.assert_allclose(getattr(got, key), ref[key], rtol=RTOL,
                                   err_msg=key)
    for leaf in ("w", "b"):
        want = ref["theta/" + leaf]
        have = got.final_state["theta"][leaf].numpy()
        assert np.abs(have - want).max() <= THETA_RTOL * np.abs(want).max()


def test_cli_runs_the_sweep_on_ranks(tmp_path):
    doc = sweep.main(["--scenarios", "scale_u256", "--quick", "--seeds",
                      "1", "--device", "cpu", "--exec", "sharded",
                      "--mesh", "1x2", "--combine", "u_sharded", "--ranks",
                      "gloo", "--state-out", str(tmp_path / "s.json")])
    assert doc["schema"] == "repro.sim.sweep/v1"
    rec = doc["scenarios"][0]
    assert tuple(rec) == sweep.RECORD_KEYS
    assert (rec["exec"]["device_count"], rec["exec"]["ranks"],
            rec["exec"]["mesh"]) == (2, "gloo", "1x2")
    one = sweep.main(["--scenarios", "scale_u256", "--quick", "--seeds",
                      "1", "--device", "cpu", "--exec", "sharded",
                      "--mesh", "1x2", "--combine", "u_sharded"])
    assert one["scenarios"][0]["metrics"] == rec["metrics"]


def test_world_of_one_runs_in_this_process():
    sc = _small().replace(total_IT=1)
    runner = ShardedSweepRunner([sc], seeds=1, keep_state=True,
                                device="cpu", ranks="gloo")
    got = runner.run()[0]
    want = ShardedSweepRunner([sc], seeds=1, keep_state=True,
                              device="cpu").run()[0]
    (rep,) = runner.rank_reports
    assert rep["pid"] == os.getpid() and rep["collectives"] == []
    assert got.loss == want.loss and got.acc == want.acc
    for (p, x), (_, y) in zip(tree_leaves(want.final_state),
                              tree_leaves(got.final_state)):
        assert torch.equal(x, y), p


def test_ranks_refusals(tmp_path):
    with pytest.raises(ValueError, match="one CUDA card a rank"):
        ShardedSweepRunner(["scale_u256"], device="cpu", mesh="2x2",
                           ranks="nccl")
    with pytest.raises(ValueError, match="unknown rank backend"):
        ShardedSweepRunner(["scale_u256"], device="cpu", ranks="mpi")
    with pytest.raises(ValueError, match="sharded engine"):
        make_runner("single", ["scale_u256"], device="cpu", ranks="gloo")
    for kw in (dict(checkpoint=str(tmp_path)),
               dict(checkpoint=str(tmp_path), resume=True)):
        with pytest.raises(NotImplementedError,
                           match="ROADMAP queue A item 11"):
            ShardedSweepRunner(["scale_u256"], device="cpu", ranks="gloo",
                               **kw)
    for argv in (["--ranks", "gloo"],
                 ["--exec", "sharded", "--ranks", "gloo", "--checkpoint",
                  str(tmp_path)],
                 ["--exec", "sharded", "--ranks", "gloo", "--profile",
                  str(tmp_path)]):
        with pytest.raises(SystemExit):
            sweep.main(["--scenarios", "scale_u256", "--quick",
                        "--device", "cpu", *argv])
