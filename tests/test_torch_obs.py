"""The port's observability layer (`repro_torch.obs`) against the JAX
package's `repro.obs`.

- **Telemetry.** `cluster_telemetry` and `is_telemetry` on the same
  flats (numpy, from a seed) within rtol 1e-6 of the reference's (their
  sums run in another order); the per-eval trajectories of ``fig2_iid``
  quick (equivalent and fused) and ``fig2_drop50`` quick within rtol
  1e-5 of the JAX sweep's (``batch="map"``, 2 seeds), attendance equal.
  Telemetry on leaves every other field bit for bit as telemetry off,
  on the single engine and on a padded 2x3 mesh, through both drivers;
  conventional mode zeroes the IS block.
- **Diff.** The port's `ulp_distance` and `diff_trees` give the
  reference's answers on tests/test_obs.py's cases, and its CLI the
  same exit codes; the tolerance mode; and the ``--out`` documents of
  ``fig2_iid`` quick from both sweep CLIs pass the port's ``diff --rtol
  1e-5`` with no leaf laid out differently.
- **Trace.** A journal the port's sweep writes through both drivers
  passes the reference's `repro.obs.trace.validate_trace` and the
  port's.
"""
import json

import jax
import numpy as np
import pytest
import torch

from repro.core.topology import random_topology as j_random_topology
from repro.obs import diff as j_diff
from repro.obs import telemetry as j_tele
from repro.obs import trace as j_trace
from repro.sim.scenario import SCENARIOS as J_SCENARIOS
from repro.sim.sweep import SweepRunner as JSweepRunner
from repro.sim.sweep import main as j_sweep_main
from repro_torch.core.topology import random_topology
from repro_torch.exec import ShardedSweepRunner
from repro_torch.obs import diff, telemetry, trace
from repro_torch.sim import sweep
from repro_torch.sim.scenario import get_scenario
from repro_torch.tree import tree_leaves

torch.set_num_threads(1)

RTOL = 1e-5


# ---------------------------------------------------------------------------
# telemetry: the block's formulas, port vs JAX on the same inputs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode,partial", [("whfl", False), ("whfl", True),
                                          ("conventional", False),
                                          ("conventional", True)])
def test_block_matches_reference(mode, partial):
    C, M, two_n = 3, 4, 58
    rng = np.random.default_rng(7)
    flat = (1e-2 * rng.standard_normal((C, M, two_n))).astype(np.float32)
    est_shape = (two_n,) if mode == "conventional" else (C, two_n)
    est = (1e-2 * rng.standard_normal(est_shape)).astype(np.float32)
    claimed = ((rng.random((C, M)) < 0.6).astype(np.float32) if partial
               else None)
    if partial:
        flat *= claimed[..., None]
    is_d = (1e-2 * rng.standard_normal((C, two_n))).astype(np.float32)
    kw = dict(C=C, M=M, K=16, K_ps=8, sigma_z2=10.0)
    j_topo, t_topo = j_random_topology(3, **kw), random_topology(3, **kw)
    want = j_tele.cluster_telemetry(flat, est, claimed, j_topo, 1.25,
                                    mode=mode)
    got = telemetry.cluster_telemetry(
        torch.as_tensor(flat), torch.as_tensor(est),
        None if claimed is None else torch.as_tensor(claimed), t_topo,
        torch.tensor(1.25), mode=mode)
    want.update(j_tele.is_telemetry(is_d, j_topo, 25.0))
    got.update(telemetry.is_telemetry(torch.as_tensor(is_d), t_topo,
                                      torch.tensor(25.0)))
    assert sorted(got) == sorted(telemetry.TELEMETRY_KEYS)
    assert telemetry.TELEMETRY_KEYS == j_tele.TELEMETRY_KEYS
    for k in telemetry.TELEMETRY_KEYS:
        w = np.asarray(want[k])
        assert got[k].dtype == torch.float32 and got[k].shape == w.shape, k
        np.testing.assert_allclose(got[k].numpy(), w, rtol=1e-6, err_msg=k)
    # pack/unpack round-trips the block in key order, bit for bit
    back = telemetry.unpack(telemetry.pack(got).numpy(), C)
    for k in telemetry.TELEMETRY_KEYS:
        assert np.array_equal(back[k], got[k].numpy()), k
    assert telemetry.pack(got).numel() == 1 + 7 * C + 2
    assert sorted(telemetry.summarize(got)) == sorted(
        j_tele.summarize({k: np.asarray(v) for k, v in want.items()}))


TRAJECTORY_CASES = {
    "fig2_iid": ("fig2_iid", {}),
    "fig2_iid fused": ("fig2_iid", dict(ota_mode="faithful",
                                        ota_backend="fused")),
    "fig2_drop50": ("fig2_drop50", {}),
}


@pytest.mark.parametrize("case", list(TRAJECTORY_CASES))
def test_trajectories_match_jax_sweep(case):
    name, cut = TRAJECTORY_CASES[case]
    ref = JSweepRunner([J_SCENARIOS[name].quick().replace(**cut)], seeds=2,
                       batch="map", telemetry=True).run()[0].to_record()
    got = sweep.SweepRunner([get_scenario(name).quick().replace(**cut)],
                            seeds=2, telemetry=True, batch="map",
                            device="cpu").run()[0].to_record()
    assert got["scenario"] == ref["scenario"]
    assert got["scenario"]["telemetry"] is True
    assert sorted(got["telemetry"]) == sorted(ref["telemetry"])
    assert got["telemetry"]["attendance"] == ref["telemetry"]["attendance"]
    for k in telemetry.TELEMETRY_KEYS:
        np.testing.assert_allclose(
            np.asarray(got["telemetry"][k], np.float64),
            np.asarray(ref["telemetry"][k], np.float64), rtol=RTOL,
            err_msg=k)
    if name == "fig2_drop50":
        assert min(np.asarray(got["telemetry"]["attendance"]).flat) < 1.0


def _run(engine, driver, tele, sc=None):
    sc = sc or get_scenario("fig2_iid").quick()
    if engine == "single":
        return sweep.SweepRunner([sc], seeds=2, keep_state=True,
                                 driver=driver, telemetry=tele,
                                 batch="map", device="cpu").run()[0]
    return ShardedSweepRunner([sc], seeds=2, keep_state=True, mesh="2x3",
                              combine="u_sharded", driver=driver,
                              telemetry=tele, device="cpu").run()[0]


def _same_state(a, b, drop=("telemetry",)):
    la = [(p, x) for p, x in tree_leaves(a) if p[0] not in drop]
    lb = [(p, x) for p, x in tree_leaves(b) if p[0] not in drop]
    assert [p for p, _ in la] == [p for p, _ in lb]
    for (p, x), (_, y) in zip(la, lb):
        assert x.dtype == y.dtype and torch.equal(x, y), p


@pytest.mark.parametrize("engine,driver", [
    ("single", "stepwise"), ("single", "chunked"),
    ("sharded", "stepwise"), ("sharded", "chunked")])
def test_telemetry_on_leaves_everything_else_bitwise(engine, driver):
    sc = get_scenario("fig2_iid").quick().replace(ota_mode="faithful",
                                                  ota_backend="fused")
    off = _run(engine, driver, False, sc)
    on = _run(engine, driver, True, sc)
    rec_off, rec_on = off.to_record(), on.to_record()
    assert tuple(rec_off) == sweep.RECORD_KEYS == tuple(rec_on)
    assert rec_off["telemetry"] is None
    assert rec_on["metrics"] == rec_off["metrics"]
    assert rec_on["final"] == rec_off["final"]
    assert set(on.final_state) == set(off.final_state) | {"telemetry"}
    _same_state(on.final_state, off.final_state)
    # one entry per eval and seed, a scalar or [C], on the real C
    for k in telemetry.TELEMETRY_KEYS:
        traj = rec_on["telemetry"][k]
        assert len(traj) == 2 and len(traj[0]) == len(on.rounds), k
        assert np.asarray(traj[0][0]).shape in ((), (sc.C,)), k
    if engine == "sharded":   # the same block as the single engine's
        single = _run("single", "stepwise", True, sc).to_record()
        assert single["telemetry"] == rec_on["telemetry"]


def test_conventional_mode_zeroes_is_block():
    sc = get_scenario("fig2_iid_conventional").quick()
    tele = sweep.SweepRunner([sc], seeds=1, telemetry=True,
                             device="cpu").run()[0].to_record()["telemetry"]
    for k in telemetry.IS_KEYS:
        assert np.all(np.asarray(tele[k]) == 0.0), k
    for k in ("snr", "rx_power"):
        assert np.all(np.asarray(tele[k]) > 0.0), k


# ---------------------------------------------------------------------------
# diff: the reference's verdicts, and the tolerance mode
# ---------------------------------------------------------------------------

def _doc(loss=0.5, seconds=1.0, extra=None):
    d = {"schema": "x/v1", "quick": True,
         "scenarios": [{"scenario": {"name": "sc", "tau": 2},
                        "rounds": [2, 4],
                        "metrics": {"loss": [[loss, 0.25]]},
                        "seconds": seconds}]}
    if extra:
        d["scenarios"][0].update(extra)
    return d


_f = lambda x: float(np.float32(x))
_next = lambda x, to: float(np.nextafter(np.float32(x), np.float32(to)))
ULP_PAIRS = [
    (1.0, 1.0), (1.0, _next(1, 2)), (1.0, _next(1, 0)),
    (-1.0, _next(-1, 0)), (0.0, -0.0), (float("nan"), float("nan")),
    (_next(0, 1), -_next(0, 1)), (1.0, 1.0 + 2.0 ** -40),
    (1.0, float(np.nextafter(1.0, 2.0))), (1e-300, 1e-300),
    (1e308, -1e308), ([_f(0.5), 1.0], [_next(0.5, 1), 1.0 + 2.0 ** -40]),
]


@pytest.mark.parametrize("i", range(len(ULP_PAIRS)))
def test_ulp_distance_equals_reference(i):
    a, b = ULP_PAIRS[i]
    assert np.array_equal(diff.ulp_distance(a, b), j_diff.ulp_distance(a, b))


def _tree_cases():
    a, b = _doc(), _doc()
    b["scenarios"][0]["rounds"] = [2]
    b["scenarios"][0]["scenario"]["name"] = "other"
    return [
        (_doc(), _doc(seconds=9.0)),
        (_doc(), _doc(loss=_next(0.5, 1))),
        (a, b),
        (_doc(), _doc(extra={"telemetry": None})),
        ({"n": [1, 2]}, {"n": [1, 3]}),
        ({"p": 1.0}, {"p": 1.0 + 2.0 ** -40}),
    ]


@pytest.mark.parametrize("i", range(6))
def test_diff_trees_verdicts_equal_reference(i):
    x, y = _tree_cases()[i]
    mine, ref = diff.diff_trees(x, y), j_diff.diff_trees(x, y)
    assert mine.ulps == ref.ulps and mine.errors == ref.errors
    assert mine.bitwise_paths() == ref.bitwise_paths()
    for m in (0, 1, 10):
        assert mine.verdict(m) == ref.verdict(m)
    assert diff.report(mine, 1) == j_diff.report(ref, 1)


def test_diff_cli_exit_codes_equal_reference(tmp_path, capsys):
    a, b, c = (tmp_path / n for n in ("a.json", "b.json", "c.json"))
    a.write_text(json.dumps(_doc()))
    b.write_text(json.dumps(_doc(loss=_next(0.5, 1))))
    c.write_text(json.dumps(_doc(seconds=2.0)))
    for args in ([a, a], [a, b], [a, b, "--max-ulp", "1"],
                 [a, b, "--ignore", "metrics"],
                 [a, c, "--no-default-ignore"]):
        args = [str(x) for x in args]
        assert diff.main(args) == j_diff.main(args), args


def test_diff_tolerance_mode(tmp_path, capsys):
    res = diff.diff_trees(_doc(loss=0.5), _doc(loss=0.5000004), rtol=1e-6)
    assert res.verdict() and not diff.diff_trees(_doc(loss=0.5),
                                                 _doc(loss=0.5000004)
                                                 ).verdict(0)
    (path,) = [p for p, g in res.abs_gap.items() if g > 0]
    assert path.endswith("metrics.loss[0]")
    assert res.rel_gap[path] == pytest.approx(8e-7, rel=1e-3)
    assert not diff.diff_trees(_doc(loss=0.5), _doc(loss=0.5001),
                               rtol=1e-5).verdict()
    assert diff.diff_trees(_doc(loss=0.5), _doc(loss=0.5001),
                           atol=2e-4).verdict()
    # a gap over an exact zero is relative inf; NaN against a number fails
    res = diff.diff_trees({"x": [1e-9, 1.0]}, {"x": [0.0, 1.0]}, rtol=1.0)
    assert not res.verdict() and res.rel_gap["$.x"] == np.inf
    assert not diff.diff_trees({"x": float("nan")}, {"x": 1.0},
                               atol=1.0).verdict()
    assert diff.diff_trees({"x": float("nan")}, {"x": float("nan")},
                           rtol=0.0).verdict()
    a, b = tmp_path / "a.json", tmp_path / "b.json"
    a.write_text(json.dumps(_doc(loss=0.5)))
    b.write_text(json.dumps(_doc(loss=0.5000004)))
    assert diff.main([str(a), str(b)]) == 1
    assert diff.main([str(a), str(b), "--rtol", "1e-6"]) == 0
    assert "max rel" in capsys.readouterr().out


def test_port_and_jax_documents_pass_rtol(tmp_path, capsys):
    """The two sweep CLIs' ``--out`` documents of fig2_iid quick with
    telemetry: every leaf the JAX document has, the port's has, laid
    out the same (the runtime keys -- ``exec``, ``seconds``,
    ``n_traces`` -- are diff's default ignores), within rtol 1e-5."""
    mine, ref = tmp_path / "port.json", tmp_path / "jax.json"
    args = ["--scenarios", "fig2_iid", "--quick", "--seeds", "2",
            "--telemetry"]
    sweep.main(args + ["--batch", "map", "--device", "cpu", "--out",
                       str(mine)])
    j_sweep_main(args + ["--batch", "map", "--out", str(ref)])
    res = diff.diff_trees(json.load(open(mine)), json.load(open(ref)),
                          rtol=RTOL)
    assert res.errors == [] and res.verdict(), diff.report(res)[0]
    assert any(".telemetry.snr" in p for p in res.ulps)
    assert diff.main([str(mine), str(ref), "--rtol", str(RTOL)]) == 0


# ---------------------------------------------------------------------------
# trace: the port's journal against the reference's validator
# ---------------------------------------------------------------------------

def test_sweep_journal_passes_reference_validator(tmp_path):
    path = str(tmp_path / "sweep.jsonl")
    with trace.TraceWriter(path, device="cpu") as w:
        for driver in ("stepwise", "chunked"):
            sweep.SweepRunner(["fig2_iid"], seeds=1, quick=True,
                              driver=driver, telemetry=True, trace=w,
                              device="cpu").run()
    for validate in (j_trace.validate_trace, trace.validate_trace):
        counts, errors = validate(path)
        assert errors == [], errors
        assert counts["scenario_start"] == counts["scenario_end"] == 2
        assert counts["window"] >= 2 and counts["telemetry"] >= 2
    events = [json.loads(line) for line in open(path)]
    assert events[0]["schema"] == j_trace.SCHEMA_VERSION
    assert events[0]["backend"] == "cpu"
    assert all(e["enqueue_only"] for e in events if e["event"] == "window")
    assert trace.EVENTS == j_trace.EVENTS
    assert trace.main([path]) == 0 and j_trace.main([path]) == 0


def test_validator_rejects_bad_journals(tmp_path):
    bad = tmp_path / "bad.jsonl"
    bad.write_text("not json at all\n")
    _, errors = trace.validate_trace(str(bad))
    assert errors and trace.main([str(bad)]) == 1
    crash = tmp_path / "crash.jsonl"
    w = trace.TraceWriter(str(crash), device="cpu")
    w.emit("scenario_start", scenario="sc")
    _, errors = trace.validate_trace(str(crash))
    assert any("run_end" in e for e in errors)
    assert any("unbalanced" in e for e in errors)
    _, errors = trace.validate_trace(str(crash), allow_truncated_tail=True)
    assert errors == []
    with pytest.raises(ValueError, match="unknown trace event"):
        w.emit("explode")
    w.close()
