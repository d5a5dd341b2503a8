"""The port's chunked round driver, against its stepwise driver and
against the JAX package's record schema.

Both drivers run one window loop (`repro_torch.core.whfl.
make_window_fn`): the stepwise driver eagerly, the chunked driver
through `make_chunk_fn`, which on the CPU runs it eagerly too (a CUDA
graph per window length on the card, held by tests/test_torch_cuda.py).
So chunked equals stepwise bit for bit: the final state and every
metric.
Cases: ``fig2_iid`` quick with a tail window (eval_every 3 over 8
rounds: windows 1, 3, 3, 1), ``scale_u256`` quick (the fused backend),
``fig3_cifar`` cut to C 2, M 2, batch 4, tau 2, K = K_ps = 2 (the CNN,
2 rounds), and the sharded engine on a 2x2 mesh.  ``--warmup`` runs the
window lengths on throwaway copies, so it changes no result either.
"""
import json

import numpy as np
import pytest
import torch

from repro.exec import ShardedSweepRunner as JShardedSweepRunner
from repro.sim.sweep import DRIVERS as J_DRIVERS
from repro.sim.scenario import SCENARIOS as J_SCENARIOS
from repro.sim.sweep import SweepRunner as JSweepRunner
from repro_torch.core import whfl
from repro_torch.exec import ShardedSweepRunner, make_runner
from repro_torch.sim import sweep
from repro_torch.sim.scenario import get_scenario
from repro_torch.tree import tree_leaves

# one intra-op thread: test workers run side by side, and torch's
# default of one thread per core oversubscribes the CPU many times
torch.set_num_threads(1)

FIG3_CUT = dict(C=2, M=2, batch=4, tau=2, n_train=200, n_test=20, K=2,
                K_ps=2, total_IT=2)
CASES = {
    "fig2_iid tail": ("single", get_scenario("fig2_iid").quick().replace(
        eval_every=3)),
    "scale_u256": ("single", get_scenario("scale_u256").quick()),
    "fig3_cifar": ("single", get_scenario("fig3_cifar").replace(
        **FIG3_CUT)),
    "scale_u256 sharded 2x2": ("sharded",
                               get_scenario("scale_u256").quick()),
}


def _run(engine, sc, driver, warmup=False, seeds=2):
    if engine == "single":
        runner = sweep.SweepRunner([sc], seeds=seeds, keep_state=True,
                                   driver=driver, warmup=warmup,
                                   device="cpu", batch="map")
    else:
        runner = ShardedSweepRunner([sc], seeds=seeds, keep_state=True,
                                    mesh="2x2", combine="u_sharded",
                                    driver=driver, warmup=warmup,
                                    device="cpu")
    return runner.run()[0]


def _assert_same(a, b):
    assert a.rounds == b.rounds and a.seeds == b.seeds
    for k in ("acc", "loss", "edge_power", "is_power"):
        assert getattr(a, k) == getattr(b, k), k
    la, lb = list(tree_leaves(a.final_state)), list(tree_leaves(b.final_state))
    assert [p for p, _ in la] == [p for p, _ in lb]
    for (p, x), (_, y) in zip(la, lb):
        assert x.dtype == y.dtype and torch.equal(x, y), p


@pytest.mark.parametrize("case", list(CASES))
def test_chunked_equals_stepwise_bitwise(case):
    engine, sc = CASES[case]
    step = _run(engine, sc, "stepwise")
    chunk = _run(engine, sc, "chunked")
    _assert_same(step, chunk)
    windows = whfl.eval_windows(sc.rounds, sc.eval_every)
    assert step.rounds == list(np.cumsum(windows))
    assert chunk.exec_info["dispatches"] == len(windows)
    # the reference's count: a split and a round per seed and round, an
    # eval per seed and window
    assert step.exec_info["dispatches"] == 2 * (2 * sc.rounds + len(windows))
    assert (step.exec_info["driver"], chunk.exec_info["driver"]) == (
        "stepwise", "chunked")


@pytest.mark.parametrize("driver", ["stepwise", "chunked"])
def test_warmup_changes_no_result(driver):
    sc = CASES["fig2_iid tail"][1]
    cold = _run("single", sc, driver, seeds=1)
    warm = _run("single", sc, driver, warmup=True, seeds=1)
    _assert_same(cold, warm)
    assert warm.exec_info["warmup"] and not cold.exec_info["warmup"]
    assert warm.exec_info["dispatches"] == cold.exec_info["dispatches"]


@pytest.mark.parametrize("make", [whfl.make_window_fn,
                                  whfl.make_chunk_fn])
def test_chunk_fn_runs_windows_of_every_length(make):
    """The window the stepwise driver runs eagerly (`make_window_fn`) and
    the chunked driver's executor (`make_chunk_fn`) on the CPU: every
    round of every seed with its powers, the eval stacked over seeds,
    the carry seed-stacked in and out."""
    calls = []

    def round_fn(state, key, P, P_is):
        calls.append((float(P), float(P_is)))
        return {"x": state["x"] + P * key[0].to(torch.float32)}

    chunk = make(round_fn, lambda st: st["x"][None])
    keys = torch.tensor([[0, 1], [0, 2]])
    states = whfl.stack_seeds([{"x": torch.zeros(())}, {"x": torch.ones(())}])
    P = torch.arange(5, dtype=torch.float32)
    states, keys, m = chunk(states, keys, P[:3], 2 * P[:3])
    states, keys, m = chunk(states, keys, P[3:], 2 * P[3:])
    assert m.shape == (2, 1)
    assert states["x"].shape == (2,) and keys.shape == (2, 2)
    # every round of every seed, in round-major order, with its powers
    assert calls == [(float(p), 2 * float(p)) for p in P for _ in range(2)]


def test_cli_records_both_drivers_with_the_reference_exec_keys(tmp_path):
    bench = tmp_path / "bench.json"
    doc = sweep.main(["--scenarios", "scale_u256", "--quick", "--device",
                      "cpu", "--driver", "stepwise,chunked", "--warmup",
                      "--bench-out", str(bench)])
    recs = doc["scenarios"]
    assert [r["exec"]["driver"] for r in recs] == ["stepwise", "chunked"]
    assert all(r["exec"]["warmup"] for r in recs)
    assert recs[0]["metrics"] == recs[1]["metrics"]
    assert sweep.DRIVERS == J_DRIVERS
    ref = JSweepRunner([J_SCENARIOS["fig2_iid"].quick().replace(
        total_IT=1)], batch="map", driver="chunked").run()[0]
    # the port also names the torch device that ran it and, on the
    # CPU, the intra-op threads it summed with
    assert set(recs[1]["exec"]) == set(ref.exec_info) | {"device",
                                                         "cpu_threads"}
    assert list(recs[1]["exec"])[-4:] == list(ref.exec_info)[-4:] == [
        "driver", "dispatches", "drive_seconds", "warmup"]
    # the sharded engine's extra keys, as the reference's engine names
    # them (its `_exec_info` with a topology)
    j_sc = J_SCENARIOS["scale_u256"].quick()
    j_info = JShardedSweepRunner([j_sc], mesh="1x1")._exec_info(
        j_sc.make_topology(), 7850)
    sc = get_scenario("scale_u256").quick()
    mine = make_runner("sharded", [sc], mesh="1x1", combine="u_sharded",
                       driver="chunked", device="cpu")
    assert set(mine._exec_info(sc.make_topology(), 7850)) == set(
        j_info) | {"device", "cpu_threads"}
    records = json.loads(bench.read_text())["records"]
    assert [r["dispatches"] for r in records] == [
        r["exec"]["dispatches"] for r in recs]


@pytest.mark.parametrize("argv", [["--driver", "scan"],
                                  ["--driver", "stepwise,turbo"]])
def test_cli_rejects_unknown_drivers(argv):
    with pytest.raises(SystemExit):
        sweep.main(["--scenarios", "scale_u256", "--quick", "--device",
                    "cpu", *argv])
