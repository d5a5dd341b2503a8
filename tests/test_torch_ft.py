"""The port's fault tolerance (`repro_torch.ft`, the sweep's checkpoint,
resume, guard and fault paths) against the JAX package's `repro.ft` and
against itself.

Against the reference: `FaultPlan.parse` (accepted and refused specs),
`backoff_delay` (the counter PRNG's draws, bit for bit),
`scenario_fingerprint` of every registered scenario, `guard_estimate`
on estimates holding NaN and Inf, `check_manifest`'s refusals, and the
stop of a ``halt`` guard: the same eval as the JAX run.

Against itself, bit for bit (metrics and the whole final carry): a
guarded run without faults and a checkpointing run against the plain
one; a run resumed mid-way from a checkpoint against the uninterrupted
one, on both engines (single; sharded on a padded 2x3 mesh) and both
drivers; a checkpoint cut on 1x1 and resumed on 2x3; and through the
CLI, a process killed by ``--inject crash_round`` (exit 173) and run
again with ``--resume``, its ``--state-out`` against the uninterrupted
run's, on both drivers.  Subprocesses run with one intra-op thread: a
BLAS free to pick its thread count by the machine's load may sum in
another order.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.ft import FaultPlan as JFaultPlan
from repro.ft import backoff_delay as j_backoff_delay
from repro.ft import check_manifest as j_check_manifest
from repro.ft import guard_estimate as j_guard_estimate
from repro.ft import scenario_fingerprint as j_scenario_fingerprint
from repro.obs.trace import validate_trace as j_validate_trace
from repro.sim.scenario import SCENARIOS as J_SCENARIOS
from repro.sim.sweep import SweepRunner as JSweepRunner
from repro_torch.checkpoint import store
from repro_torch.exec import ShardedSweepRunner
from repro_torch.ft import (CRASH_EXIT_CODE, CheckpointManager, FaultPlan,
                            GradPoison, backoff_delay, check_manifest,
                            git_sha, guard_estimate, scenario_fingerprint,
                            validate_guard)
from repro_torch.sim import sweep
from repro_torch.sim.scenario import SCENARIOS, get_scenario
from repro_torch.tree import tree_leaves

torch.set_num_threads(1)

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _tiny(**kw):
    sc = get_scenario("fig2_iid").quick().replace(total_IT=6, eval_every=2)
    return sc.replace(**kw) if kw else sc


def _runner(sc, engine="single", mesh="2x3", **kw):
    kw = {"seeds": 2, "keep_state": True, "device": "cpu", **kw}
    if engine == "single":
        return sweep.SweepRunner([sc], batch="map", **kw)
    return ShardedSweepRunner([sc], mesh=mesh, combine="u_sharded", **kw)


def _same(a, b, drop=()):
    assert a.rounds == b.rounds
    for k in ("acc", "loss", "edge_power", "is_power"):
        assert getattr(a, k) == getattr(b, k), k
    la = [(p, x) for p, x in tree_leaves(a.final_state) if p[0] not in drop]
    lb = [(p, x) for p, x in tree_leaves(b.final_state) if p[0] not in drop]
    assert [p for p, _ in la] == [p for p, _ in lb]
    for (p, x), (_, y) in zip(la, lb):
        assert x.dtype == y.dtype and torch.equal(x, y), p


# ---------------------------------------------------------------------------
# units against the reference
# ---------------------------------------------------------------------------

PLAN_SPECS = ["crash_round=5,save_errors=2,poison=nan@4:0:1",
              "poison=inf@1:2:3", "crash_window=2", "", "save_errors=0"]
BAD_SPECS = ["crash_round", "crash_round=0", "whatever=3", "poison=nan",
             "poison=nan@1:2", "poison=bogus@1:2:3", "save_errors=-1"]


@pytest.mark.parametrize("spec", PLAN_SPECS)
def test_fault_plan_parse_equals_reference(spec):
    mine, ref = FaultPlan.parse(spec), JFaultPlan.parse(spec)
    for f in ("crash_round", "crash_window", "save_errors"):
        assert getattr(mine, f) == getattr(ref, f), f
    assert mine.is_empty == ref.is_empty
    if ref.poison is None:
        assert mine.poison is None
    else:
        assert (mine.poison.t, mine.poison.c, mine.poison.m,
                mine.poison.mode) == (ref.poison.t, ref.poison.c,
                                      ref.poison.m, ref.poison.mode)
        assert (np.float32(mine.poison.value).tobytes()
                == np.float32(ref.poison.value).tobytes())


@pytest.mark.parametrize("spec", BAD_SPECS)
def test_fault_plan_parse_refuses_what_reference_refuses(spec):
    with pytest.raises(ValueError):
        JFaultPlan.parse(spec)
    with pytest.raises(ValueError):
        FaultPlan.parse(spec)


def test_backoff_delay_equals_reference():
    for seed in (0, 1, 7):
        for a in range(5):
            assert (backoff_delay(a, 0.05, seed)
                    == j_backoff_delay(a, 0.05, seed)), (seed, a)
    d = [backoff_delay(a, base=0.05) for a in range(4)]
    for a, v in enumerate(d):   # base*2^a <= v < 2*base*2^a
        assert 0.05 * 2 ** a <= v < 0.05 * 2 ** (a + 1)


def test_scenario_fingerprint_equals_reference():
    assert sorted(SCENARIOS) == sorted(J_SCENARIOS)
    for name in SCENARIOS:
        for sc, jsc in ((SCENARIOS[name], J_SCENARIOS[name]),
                        (SCENARIOS[name].quick().replace(telemetry=True),
                         J_SCENARIOS[name].quick().replace(telemetry=True))):
            assert (scenario_fingerprint(sc.to_json())
                    == j_scenario_fingerprint(jsc.to_json())), name


@pytest.mark.parametrize("policy", ["zero_fill", "skip_round", "halt"])
def test_guard_estimate_equals_reference(policy):
    rng = np.random.default_rng(3)
    est = rng.standard_normal((3, 10)).astype(np.float32)
    est[0, 2], est[2, 7] = np.nan, np.inf
    for x in (est, est[1], est[1:2], np.array([-np.inf, 1.0], np.float32)):
        want, wtrip = j_guard_estimate(x, policy)
        got, trip = guard_estimate(torch.as_tensor(x), policy)
        assert trip.dtype == torch.int32 and int(trip) == int(wtrip)
        assert got.numpy().tobytes() == np.asarray(want).tobytes()
    ok = torch.tensor([1.0, -2.0, 0.5, -0.0])
    out, trip = guard_estimate(ok, policy)
    assert int(trip) == 0 and out.numpy().tobytes() == ok.numpy().tobytes()
    with pytest.raises(ValueError):
        guard_estimate(ok, "off")
    with pytest.raises(ValueError):
        validate_guard("explode")


def test_check_manifest_refuses_what_reference_refuses():
    fp = scenario_fingerprint(_tiny().to_json())
    man = {"schema": "repro.ft.ckpt/v1", "fingerprint": fp,
           "seeds": [0, 1], "rounds_total": 6, "torch_version": "0"}
    check_manifest(man, fp, [0, 1], 6)
    for args, match in ((([0, 1, 2], 6), "seed"), (([0, 1], 9), "total")):
        for fn in (check_manifest, j_check_manifest):
            with pytest.raises(ValueError, match=match):
                fn(man, fp, *args)
    for fn in (check_manifest, j_check_manifest):
        with pytest.raises(ValueError, match="scenario"):
            fn(man, "deadbeef00000000", [0, 1], 6)
        with pytest.raises(ValueError, match="schema"):
            fn({**man, "schema": "v0"}, fp, [0, 1], 6)
    with pytest.warns(UserWarning, match="torch"):
        check_manifest(man, fp, [0, 1], 6, torch_version="9.9")


def test_checkpoint_manager_retries_then_raises(tmp_path):
    naps, events = [], []
    mgr = CheckpointManager(str(tmp_path / "ok"), retries=3,
                            faults=FaultPlan(save_errors=2),
                            emit=lambda ev, **f: events.append((ev, f)),
                            sleep=naps.append)
    mgr.save(1, {"x": np.arange(3.0)}, {"round": 1})
    assert mgr.saves == 1 and mgr.io_retries == 2
    assert naps == [j_backoff_delay(0, 0.05), j_backoff_delay(1, 0.05)]
    assert [f.get("kind") for ev, f in events if ev == "fault"] == [
        "ckpt_io_error", "ckpt_io_error"]
    assert events[-1][0] == "checkpoint" and events[-1][1]["attempts"] == 3
    mgr = CheckpointManager(str(tmp_path / "bad"), retries=1,
                            faults=FaultPlan(save_errors=5),
                            sleep=lambda s: None)
    with pytest.raises(OSError, match="injected"):
        mgr.save(1, {"x": np.arange(3.0)}, {"round": 1})


def test_git_sha_without_git_directory_is_none(monkeypatch, tmp_path):
    from repro_torch.ft import ckpt
    monkeypatch.setattr(ckpt, "_ROOT", str(tmp_path))
    assert git_sha() is None


# ---------------------------------------------------------------------------
# the guard and the poison in the sweep
# ---------------------------------------------------------------------------

def test_guard_and_checkpoint_off_positions_change_nothing(tmp_path):
    sc = _tiny()
    plain = _runner(sc).run()[0]
    guarded = _runner(sc, guard="zero_fill").run()[0]
    ck = _runner(sc, checkpoint=str(tmp_path / "ck")).run()[0]
    _same(plain, ck)
    _same(plain, guarded, drop=("guard_trips",))
    assert int(guarded.final_state["guard_trips"].sum()) == 0
    assert guarded.exec_info["guard_trips"] == 0
    assert not guarded.exec_info["guard_halted"]
    assert ck.exec_info["ckpt_saves"] == len(plain.rounds)


def test_poison_without_guard_goes_non_finite():
    res = _runner(_tiny(), faults=FaultPlan.parse("poison=nan@2:0:1"),
                  seeds=1).run()[0]
    assert not np.isfinite(res.loss[0][-1])


@pytest.mark.parametrize("mode,driver", [("nan", "stepwise"),
                                         ("inf", "chunked")])
def test_poison_with_zero_fill_stays_finite(mode, driver):
    sc = _tiny()
    res = _runner(sc, guard="zero_fill", driver=driver,
                  faults=FaultPlan(poison=GradPoison(2, 0, 1, mode))
                  ).run()[0]
    assert np.isfinite(res.loss).all()
    # the poisoned round's cluster hop trips once per seed
    assert res.exec_info["guard_trips"] == 2
    assert not res.exec_info["guard_halted"]
    assert res.rounds[-1] == sc.rounds


@pytest.mark.parametrize("driver", ["stepwise", "chunked"])
def test_halt_stops_where_the_reference_stops(driver):
    sc, jsc = _tiny(), J_SCENARIOS["fig2_iid"].quick().replace(
        total_IT=6, eval_every=2)
    ref = JSweepRunner([jsc], seeds=1, batch="map", guard="halt",
                       driver=driver, faults=JFaultPlan.parse(
                           "poison=nan@2:0:1")).run_scenario(jsc)
    res = _runner(sc, seeds=1, guard="halt", driver=driver,
                  faults=FaultPlan.parse("poison=nan@2:0:1")).run()[0]
    assert res.exec_info["guard_halted"] and ref.exec_info["guard_halted"]
    assert res.rounds == ref.rounds and res.rounds[-1] < sc.rounds
    assert np.isfinite(res.loss).all()
    np.testing.assert_allclose(res.loss, ref.loss, rtol=1e-5)


def test_poison_out_of_range_raises():
    with pytest.raises(ValueError, match="poison"):
        _runner(_tiny(), faults=FaultPlan.parse("poison=nan@1:99:0")).run()


# ---------------------------------------------------------------------------
# checkpoint and resume, in the process
# ---------------------------------------------------------------------------

def _keep_only(ckdir, name, keep):
    d = os.path.join(ckdir, name)
    assert keep in os.listdir(d), os.listdir(d)
    for f in os.listdir(d):
        if f != keep:
            os.unlink(os.path.join(d, f))


@pytest.mark.parametrize("engine,driver", [
    ("single", "stepwise"), ("single", "chunked"),
    ("sharded", "stepwise"), ("sharded", "chunked")])
def test_resume_mid_run_is_bitwise(tmp_path, engine, driver):
    """Checkpoints every window (boundaries at rounds 1, 3, 5, 6), all
    but round 3's dropped, then a resume: metrics, telemetry and the
    whole final carry equal the uninterrupted run's."""
    sc = _tiny()
    ckdir = str(tmp_path / "ck")
    kw = dict(engine=engine, driver=driver, telemetry=True)
    ref = _runner(sc, **kw).run()[0]
    full = _runner(sc, checkpoint=ckdir, **kw).run()[0]
    _same(full, ref)
    # keep=3 has pruned round 1; round 3 is the oldest kept
    _keep_only(ckdir, sc.name, "round_3.npz")
    res = _runner(sc, checkpoint=ckdir, resume=True, **kw).run()[0]
    assert res.exec_info["resumed_from"] == 3
    _same(res, ref)
    assert res.to_record()["telemetry"] == ref.to_record()["telemetry"]


@pytest.mark.parametrize("batch", ["map", "vmap"])
def test_cpu_resume_under_four_ambient_threads_is_bitwise(tmp_path,
                                                          monkeypatch, batch):
    """A CPU run sums with one intra-op thread whatever its caller set:
    a run resumed under an ambient ``torch.set_num_threads(4)`` drives
    under one thread, equals the uninterrupted run bit for bit, and
    gives the caller its 4 threads back; the checkpoint's manifest and
    the record's ``exec`` carry ``cpu_threads``."""
    sc = _tiny()
    ckdir = str(tmp_path / "ck")
    kw = dict(seeds=2, keep_state=True, device="cpu", batch=batch)
    ref = sweep.SweepRunner([sc], **kw).run()[0]
    sweep.SweepRunner([sc], checkpoint=ckdir, **kw).run()
    _keep_only(ckdir, sc.name, "round_3.npz")
    man = store.read_meta(os.path.join(ckdir, sc.name,
                                       "round_3.npz"))["extra"]
    assert man["engine"]["cpu_threads"] == 1
    assert man["engine"]["batch"] == batch
    seen = []
    drive = sweep.SweepRunner._drive
    monkeypatch.setattr(sweep.SweepRunner, "_drive", lambda self, *a: (
        seen.append(torch.get_num_threads()), drive(self, *a))[1])
    before = torch.get_num_threads()
    torch.set_num_threads(4)
    try:
        res = sweep.SweepRunner([sc], checkpoint=ckdir, resume=True,
                                **kw).run()[0]
        after = torch.get_num_threads()
    finally:
        torch.set_num_threads(before)
    assert seen == [1] and after == 4
    assert res.exec_info["resumed_from"] == 3
    assert res.exec_info["cpu_threads"] == 1
    _same(res, ref)


@pytest.mark.parametrize("driver", ["stepwise", "chunked"])
def test_checkpoint_from_1x1_resumes_on_2x3(tmp_path, driver):
    sc = _tiny()
    ckdir = str(tmp_path / "ck")
    ref = _runner(sc, engine="sharded", mesh="1x1", driver=driver).run()[0]
    _runner(sc, engine="sharded", mesh="1x1", driver=driver,
            checkpoint=ckdir).run()
    _keep_only(ckdir, sc.name, "round_3.npz")
    res = _runner(sc, engine="sharded", mesh="2x3", driver=driver,
                  checkpoint=ckdir, resume=True).run()[0]
    assert res.exec_info["resumed_from"] == 3
    assert res.exec_info["padded"] == "2x3"
    _same(res, ref)


def test_resume_edges(tmp_path):
    sc = _tiny()
    ckdir = str(tmp_path / "ck")
    ref = _runner(sc, checkpoint=ckdir).run()[0]
    # from the final checkpoint: nothing left to drive
    res = _runner(sc, checkpoint=ckdir, resume=True).run()[0]
    assert res.exec_info["resumed_from"] == sc.rounds
    assert res.exec_info["dispatches"] == 0
    _same(res, ref)
    # no checkpoint: a fresh start
    fresh = _runner(sc, checkpoint=str(tmp_path / "empty"),
                    resume=True).run()[0]
    assert fresh.exec_info["resumed_from"] == 0
    _same(fresh, ref)
    with pytest.raises(ValueError, match="seed"):
        _runner(sc, checkpoint=ckdir, resume=True, seeds=3).run()
    with pytest.raises(ValueError, match="guard"):
        _runner(sc, checkpoint=ckdir, resume=True, guard="zero_fill").run()
    other = _tiny(lr=sc.lr * 2)
    with pytest.raises(ValueError, match="fingerprint"):
        _runner(other, checkpoint=ckdir, resume=True).run()


def test_runner_and_cli_refuse_orphan_knobs(tmp_path):
    sc = _tiny()
    with pytest.raises(ValueError, match="ckpt_every"):
        sweep.SweepRunner([sc], checkpoint="x", ckpt_every=0, device="cpu")
    with pytest.raises(ValueError, match="resume"):
        sweep.SweepRunner([sc], resume=True, device="cpu")
    with pytest.raises(ValueError, match="guard"):
        sweep.SweepRunner([sc], guard="sometimes", device="cpu")
    for args in (["--ckpt-every", "2"], ["--resume"],
                 ["--ckpt-every", "0", "--checkpoint", "ck"],
                 ["--checkpoint", "ck", "--driver", "stepwise,chunked"],
                 ["--inject", "poison=nan"]):
        with pytest.raises(SystemExit) as e:
            sweep.main(["--scenarios", "fig2_iid", "--quick", "--device",
                        "cpu"] + args)
        assert e.value.code == 2, args
    # a sweep that fails after the journal opened still closes it
    path = str(tmp_path / "t.jsonl")
    with pytest.raises(SystemExit):
        sweep.main(["--scenarios", "no_such_scenario", "--device", "cpu",
                    "--trace", path])
    lines = [json.loads(ln) for ln in open(path).read().splitlines()]
    assert lines[-1]["event"] == "run_end"


# ---------------------------------------------------------------------------
# the real thing: a hard crash in a subprocess, then --resume
# ---------------------------------------------------------------------------

def _cli(args, cwd):
    env = dict(os.environ, PYTHONPATH=os.path.join(_REPO, "src"),
               OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.sim.sweep", "--device", "cpu",
         "--scenarios", "fig2_iid", "--quick", "--seeds", "2"] + args,
        env=env, capture_output=True, text=True, cwd=str(cwd), timeout=600)


@pytest.mark.parametrize("driver", ["stepwise", "chunked"])
def test_kill_and_resume_through_the_cli_is_bitwise(tmp_path, driver):
    """``--inject crash_round=4`` exits with 173: the stepwise driver
    after round 4 (inside the window 4-5, the round-3 save the newest),
    the chunked one at the end of that window (after the round-5 save).
    ``--resume`` then finishes the sweep, and its records and
    ``--state-out`` equal the uninterrupted run's bit for bit.  The
    killed run's journal is torn: it fails strict validation and passes
    the post-crash audit."""
    d = ["--driver", driver]
    sweep.main(["--device", "cpu", "--scenarios", "fig2_iid", "--quick",
                "--seeds", "2", *d, "--out", str(tmp_path / "ref.json"),
                "--state-out", str(tmp_path / "ref_state.json")])
    crash = _cli(d + ["--checkpoint", "ck", "--inject", "crash_round=4",
                      "--trace", "crash.jsonl", "--out", "never.json"],
                 tmp_path)
    assert crash.returncode == CRASH_EXIT_CODE, crash.stderr
    assert not (tmp_path / "never.json").exists()
    newest = "round_3.npz" if driver == "stepwise" else "round_5.npz"
    assert newest in os.listdir(tmp_path / "ck" / "fig2_iid")
    journal = str(tmp_path / "crash.jsonl")
    assert j_validate_trace(journal)[1]
    counts, errors = j_validate_trace(journal, allow_truncated_tail=True)
    assert errors == [] and counts["fault"] == 1 and counts["checkpoint"]
    res = _cli(d + ["--checkpoint", "ck", "--resume", "--out", "res.json",
                    "--state-out", "res_state.json"], tmp_path)
    assert res.returncode == 0, res.stderr
    a, b = (json.load(open(tmp_path / f)) for f in ("ref.json", "res.json"))
    sa, sb = a["scenarios"][0], b["scenarios"][0]
    assert sa["metrics"] == sb["metrics"] and sa["rounds"] == sb["rounds"]
    assert sb["exec"]["resumed_from"] == int(newest[6:-4])
    a, b = (json.load(open(tmp_path / f))
            for f in ("ref_state.json", "res_state.json"))
    assert a["schema"] == "repro.sim.state/v1"
    assert a["scenarios"][0]["state"] == b["scenarios"][0]["state"]
