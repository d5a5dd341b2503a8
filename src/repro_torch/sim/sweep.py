"""Multi-seed scenario sweeps.

`SweepRunner` runs ``S seeds x M scenarios``: per scenario it builds the
W-HFL round (`repro_torch.core.whfl.make_round_fn`) once and drives every
seed through it round by round, in the reference's two seed modes:

- ``batch="vmap"`` (the default): the S seeds run as one program, the
  round and the eval under `torch.func.vmap` over the seed-stacked
  state, each op (the OTA kernels included) once for all seeds.  A
  batched GEMM may round a seed's floats otherwise than its run alone.
- ``batch="map"``: the seeds run one after the other, so each seed's
  trajectory is bit for bit the one it would have swept alone.

Either way every random draw follows the per-seed key exactly as in the
JAX package (model init from ``PRNGKey(s)``, the round keys from
``split`` of ``PRNGKey(s + 1)``).  On the CPU a scenario runs under one
intra-op thread (`repro_torch.device.pinned_cpu_threads`), so its sums'
order does not follow the host's load.

    python -m repro_torch.sim.sweep --scenarios fig2_iid --seeds 2 \
        --out sweep.json

``--exec sharded --mesh CxU [--combine u_sharded]`` drives the same
sweep through the sharded engine (`repro_torch.exec.ShardedSweepRunner`),
which overrides the runner's engine hooks; ``--ranks gloo|nccl`` runs
its shards as one process each.  ``--driver chunked`` replays
each eval window's rounds and eval as one CUDA graph
(`repro_torch.core.whfl.make_chunk_fn`) instead of issuing every round
from the host; ``--driver stepwise,chunked`` runs and records both.

Observability (`repro_torch.obs`): ``--telemetry`` records the
in-program diagnostics block per eval, ``--trace OUT_JSONL`` journals
the run (``repro.obs.trace/v1``), ``--profile DIR`` wraps the sweep in
`torch.profiler` and writes a Chrome trace.  Fault tolerance
(`repro_torch.ft`): ``--checkpoint DIR [--ckpt-every W] [--resume]``
saves the sweep's carry at eval-window boundaries and resumes from the
newest save bit for bit; ``--guard`` selects the non-finite guard;
``--inject`` plans faults (crashes exit with status 173);
``--state-out`` writes every scenario's final carry
(``repro.sim.state/v1``).  Each is off by default and then changes
nothing the round runs.

The entry points run on the CUDA card unless the caller asks for
another device (``device="cpu"``, ``--device cpu``); without a card
they raise.  The output documents keep the JAX package's schemas
(`SCHEMA_VERSION`, `BENCH_SCHEMA_VERSION`, `RECORD_KEYS`).
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import time
from dataclasses import dataclass, field, replace
from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch import prng
from repro_torch.core import aggregation as agg
from repro_torch.core.topology import power_schedule
from repro_torch.core.whfl import (BATCH_MODES, eval_windows,
                                   init_round_state, make_chunk_fn,
                                   make_round_fn, make_window_fn,
                                   stack_seeds)
from repro_torch.device import (CPU_THREADS, pinned_cpu_threads,
                                resolve_device)
from repro_torch.ft import ckpt as ft_ckpt
from repro_torch.ft.faults import FaultPlan, hard_crash
from repro_torch.ft.guard import GUARD_POLICIES, validate_guard
from repro_torch.obs import telemetry as tele_mod
from repro_torch.optim import adam, sgd
from repro_torch.sim.scenario import Scenario, get_scenario, list_scenarios
from repro_torch.tree import tree_leaves, tree_map

SCHEMA_VERSION = "repro.sim.sweep/v1"
BENCH_SCHEMA_VERSION = "repro.bench.sweep/v1"
STATE_SCHEMA_VERSION = "repro.sim.state/v1"

# Every per-scenario record carries exactly these keys.  "telemetry" is
# null unless the scenario ran with telemetry.
RECORD_KEYS = ("scenario", "seeds", "rounds", "metrics", "final",
               "n_traces", "seconds", "exec", "telemetry")
METRIC_KEYS = ("acc", "loss", "edge_power", "is_power")

# Round drivers: how the host feeds rounds to the device.
#   "stepwise" -- the host issues every round's ops, round by round
#                 (`repro_torch.core.whfl.make_window_fn`, eagerly);
#   "chunked"  -- `repro_torch.core.whfl.make_chunk_fn`: each eval
#                 window's rounds and eval replay as one CUDA graph (a
#                 plain loop per window on the CPU); the same bits.
DRIVERS = ("stepwise", "chunked")


def device_name(dev: torch.device) -> str:
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


@dataclass
class SweepResult:
    """One scenario x seed batch: trajectories are [S][n_evals] lists."""
    scenario: Scenario
    seeds: List[int]
    rounds: List[int]                 # global-round index of each eval
    acc: List[List[float]]
    loss: List[List[float]]
    edge_power: List[List[float]]     # running avg per-symbol edge power
    is_power: List[List[float]]
    n_traces: int                     # always 0: the port runs eagerly
    seconds: float
    exec_info: Dict = field(default_factory=dict)
    # field-major telemetry trajectories {key: [S][n_evals](scalar|[C])},
    # set iff the scenario ran with telemetry
    telemetry: Optional[Dict] = field(default=None, repr=False)
    final_state: Optional[dict] = field(default=None, repr=False)

    def to_record(self) -> Dict:
        fin = {
            "acc_mean": float(np.mean([a[-1] for a in self.acc])),
            "acc_std": float(np.std([a[-1] for a in self.acc])),
            "loss_mean": float(np.mean([l[-1] for l in self.loss])),
            "edge_power": float(np.mean([p[-1] for p in self.edge_power])),
            "is_power": float(np.mean([p[-1] for p in self.is_power])),
        }
        return {
            "scenario": self.scenario.to_json(),
            "seeds": list(self.seeds),
            "rounds": list(self.rounds),
            "metrics": {"acc": self.acc, "loss": self.loss,
                        "edge_power": self.edge_power,
                        "is_power": self.is_power},
            "final": fin,
            "n_traces": self.n_traces,
            "seconds": self.seconds,
            "exec": dict(self.exec_info),
            "telemetry": self.telemetry,
        }


class _FTContext:
    """One scenario's fault-tolerance context for the drive: where it
    resumes, when it saves, which faults it plans and how it reads the
    guard.  With every feature off (the default) the drive reads only
    these attributes: no host sync, no save, no change."""

    def __init__(self, guard_on: bool = False, guard_halt: bool = False,
                 ckpt=None, ckpt_every: int = 1, start_round: int = 0,
                 windows_done: int = 0, faults=None, save=None,
                 check_guard=None):
        self.guard_on = guard_on
        self.guard_halt = guard_halt
        self.ckpt = ckpt                   # CheckpointManager or None
        self.ckpt_every = ckpt_every
        self.start_round = start_round     # rounds already completed
        self.windows_done = windows_done   # eval windows already done
        self.faults = faults               # FaultPlan or None
        self.save = save                   # save(states, keys, cursor)
        self.check_guard = check_guard     # check_guard(states, round)
        self.halted = False                # guard policy "halt" fired
        self.trips = 0                     # guard trips, all seeds


def _keystr(path) -> str:
    """A leaf path as the JAX package spells it (`jax.tree_util.keystr`):
    ``['opt']['m']['w']``, a list index as ``[0]``."""
    return "".join(f"[{k!r}]" if isinstance(k, str) else f"[{k}]"
                   for k in path)


class SweepRunner:
    """Run a list of scenarios over a shared seed list on one device.

    scenarios: Scenario objects or registry names.
    seeds: int S (-> seeds 0..S-1) or an explicit list.
    quick: substitute each scenario's CI-sized `.quick()` variant.
    keep_state: keep each scenario's final round state, stacked over
      seeds, in `SweepResult.final_state`.
    batch: the seed mode: "vmap" (one program for all seeds, the
      default) or "map" (seed by seed, each seed bit for bit its run
      alone).  Records carry it in ``exec["batch"]``.
    driver: "stepwise" (the host issues every round) or "chunked" (one
      CUDA graph per eval window, `repro_torch.core.whfl.make_chunk_fn`;
      a plain loop per window on the CPU).  Both give the same bits.
    warmup: run each window length's graph (stepwise: the first window)
      once on throwaway copies before the timed drive, so
      ``drive_seconds`` holds no capture or first-call costs.
    device: None (the CUDA card) or a torch device string.
    telemetry: run every scenario with the telemetry block and record
      its per-eval trajectories (`SweepResult.telemetry`).
    trace: a `repro_torch.obs.trace.TraceWriter` (anything with
      ``emit(event, **fields)``) to journal the run, or None.
    checkpoint: a directory; each scenario saves its carry into its own
      subdirectory at eval-window boundaries (every `ckpt_every`
      windows, and the last); resume: start from the newest save there
      if there is one.
    guard: the non-finite guard policy (`repro_torch.ft.guard`).
    faults: a `repro_torch.ft.faults.FaultPlan` to inject, or None.
    """

    def __init__(self, scenarios: Sequence[Union[str, Scenario]],
                 seeds: Union[int, Sequence[int]] = 1,
                 quick: bool = False, keep_state: bool = False,
                 batch: str = "vmap", driver: str = "stepwise",
                 warmup: bool = False, device: Optional[str] = None,
                 telemetry: bool = False, trace=None,
                 checkpoint: Optional[str] = None, ckpt_every: int = 1,
                 resume: bool = False, guard: str = "off",
                 faults: Optional[FaultPlan] = None):
        self.device = resolve_device(device)
        self.scenarios = [get_scenario(s) if isinstance(s, str) else s
                          for s in scenarios]
        if quick:
            self.scenarios = [s.quick() for s in self.scenarios]
        # the flag rides in the scenario, so records carry it
        if telemetry:
            self.scenarios = [replace(s, telemetry=True)
                              for s in self.scenarios]
        self.trace = trace
        self.seeds = (list(range(seeds)) if isinstance(seeds, int)
                      else list(seeds))
        self.keep_state = keep_state
        if batch not in BATCH_MODES:
            raise ValueError(f"batch must be 'vmap' or 'map', got {batch!r}")
        self.batch = batch
        if driver not in DRIVERS:
            raise ValueError(f"driver must be one of {DRIVERS}, "
                             f"got {driver!r}")
        self.driver = driver
        self.warmup = warmup
        self.checkpoint = checkpoint
        if ckpt_every < 1:
            raise ValueError(f"ckpt_every must be >= 1, got {ckpt_every}")
        self.ckpt_every = ckpt_every
        if resume and checkpoint is None:
            raise ValueError("resume=True needs a checkpoint directory")
        self.resume = resume
        validate_guard(guard)
        self.guard = guard
        self.faults = faults

    def _emit(self, event: str, **fields) -> None:
        """Journal one `repro_torch.obs.trace` event (none without a
        trace)."""
        if self.trace is not None:
            self.trace.emit(event, **fields)

    # -- engine hooks (overridden by repro_torch.exec.ShardedSweepRunner) --

    def _init_states(self, params, opt, topo, cfg):
        """Per-seed initial round states.  The sharded engine sizes the
        per-user ``opt`` axes to its mesh's padded (Cp, Mp) grid."""
        return [init_round_state(p, opt, topo.C, topo.M,
                                 telemetry_C=topo.C if cfg.telemetry
                                 else None, guard=cfg.guard != "off")
                for p in params]

    def _build_round(self, loss_fn, opt, topo, cfg, spec, X, Y):
        """The per-seed round ``round_fn(state, key, P_t, P_is_t)``."""
        return make_round_fn(loss_fn, opt, topo, cfg, spec, X, Y)

    def _finalize_state(self, state, topo):
        """The seed-stacked state view stored as ``final_state`` and in
        checkpoints.  The sharded engine strips its inactive-user
        padding here, so a checkpoint resumes on any mesh."""
        return state

    def _restore_state(self, state, topo):
        """The inverse of `_finalize_state` for a resume.  The sharded
        engine pads the ``opt`` axes again."""
        return state

    def _exec_info(self, topo=None, two_n=None) -> Dict:
        """Execution-engine metadata recorded with every result;
        `topo`/`two_n` let the sharded engine add its padded shape and
        symbol-buffer bytes.  ``device_count`` is the number of torch
        devices the engine runs on; ``cpu_threads`` (CPU runs only) the
        intra-op threads the run summed with."""
        info = {"name": "single", "mesh": None, "device_count": 1,
                "batch": self.batch, "device": device_name(self.device)}
        if self.device.type == "cpu":
            info["cpu_threads"] = CPU_THREADS
        return info

    def _drive_range(self):
        """The named range around a drive, for profilers: it starts and
        ends synchronized, so the device work inside it is exactly the
        rounds' and evals'.  A profiler may wrap it to trace the drive
        alone (the chunked driver's captures lie before it)."""
        return torch.profiler.record_function("SweepRunner.drive")

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def run_scenario(self, sc: Scenario) -> SweepResult:
        with pinned_cpu_threads(self.device):
            return self._run_scenario(sc)

    def _run_scenario(self, sc: Scenario) -> SweepResult:
        t0 = time.perf_counter()
        dev = self.device
        cfg = sc.whfl_config()
        # the runner's guard and poison rewrite the round config (both
        # Python-level gates of the round body)
        if self.guard != "off":
            cfg = replace(cfg, guard=self.guard)
        if self.faults is not None and self.faults.poison is not None:
            cfg = replace(cfg, poison=self.faults.poison)
        init_fn, apply_fn, loss_fn = sc.task_fns()
        X, Y, xte, yte = sc.make_data()
        topo = sc.make_topology()
        opt = adam(sc.lr) if sc.opt == "adam" else sgd(sc.lr)
        self._emit("scenario_start", scenario=sc.name,
                   seeds=len(self.seeds), rounds=sc.rounds,
                   driver=self.driver, telemetry=cfg.telemetry,
                   exec_info=self._exec_info(topo))

        params = [init_fn(prng.PRNGKey(s, dev)) for s in self.seeds]
        spec = agg.make_flat_spec(params[0])
        # the carry, in both seed modes: the seed-stacked state and keys
        # [S, 2] (`make_window_fn`)
        states = stack_seeds(self._init_states(params, opt, topo, cfg))
        keys = torch.stack([prng.PRNGKey(s + 1, dev) for s in self.seeds])
        round_fn = self._build_round(loss_fn, opt, topo, cfg, spec,
                                     torch.as_tensor(X, device=dev),
                                     torch.as_tensor(Y, device=dev))
        xte_d = torch.as_tensor(xte, device=dev)
        yte_d = torch.as_tensor(yte, device=dev)
        tele_on = cfg.telemetry

        @torch.no_grad()
        def eval_state(st):
            """Float32 on the device: test accuracy, test loss, the
            running average edge and IS powers and, with telemetry, the
            round's block packed after them."""
            logits = apply_fn(st["theta"], xte_d)
            acc = torch.mean((logits.argmax(-1) == yte_d).to(torch.float32))
            logp = torch.log_softmax(logits, -1)
            loss = -torch.mean(logp.gather(-1, yte_d.long()[:, None]))
            pe = st["power_edge"] / torch.clamp_min(st["n_edge_tx"], 1.0)
            pi = st["power_is"] / torch.clamp_min(st["n_is_tx"], 1.0)
            out = torch.stack([acc, loss, pe, pi])
            if tele_on:
                out = torch.cat([out, tele_mod.pack(st["telemetry"])])
            return out

        S, T = len(self.seeds), sc.rounds
        rounds: List[int] = []
        acc_t, loss_t, pe_t, pi_t = ([[] for _ in range(S)]
                                     for _ in range(4))
        tele_acc: List[Dict] = []     # one {key: [S, ...]} per eval

        def record(m) -> None:
            """One eval's host metrics [S, 4 (+ telemetry)]."""
            for s in range(S):
                acc_t[s].append(m[s][0])
                loss_t[s].append(m[s][1])
                pe_t[s].append(m[s][2])
                pi_t[s].append(m[s][3])
            if tele_on:
                blocks = [tele_mod.unpack(m[s][4:], topo.C)
                          for s in range(S)]
                tele_acc.append({k: np.stack([b[k] for b in blocks])
                                 for k in tele_mod.TELEMETRY_KEYS})

        # -- fault tolerance: checkpoints, resume, the guard ---------------
        guard_on = cfg.guard != "off"
        ckpt_mgr = None
        if self.checkpoint is not None:
            ckpt_mgr = ft_ckpt.CheckpointManager(
                os.path.join(self.checkpoint, sc.name), faults=self.faults,
                emit=lambda ev, **f: self._emit(ev, scenario=sc.name, **f))
        fingerprint = ft_ckpt.scenario_fingerprint(sc.to_json())
        start_round, windows_done = 0, 0
        if self.resume and ckpt_mgr is not None:
            # the payload is the canonical (unpadded) carry, keys as the
            # reference's uint32 words
            template = {"state": self._finalize_state(states, topo),
                        "keys": np.zeros((S, 2), np.uint32)}

            def _check(man):
                ft_ckpt.check_manifest(man, fingerprint, self.seeds, T,
                                       torch.__version__)
                if man.get("guard", "off") != cfg.guard:
                    raise ValueError(
                        f"checkpoint was cut with guard="
                        f"{man.get('guard')!r}, this run uses "
                        f"{cfg.guard!r}")

            loaded = ckpt_mgr.load_latest(template, check=_check)
            if loaded is not None:
                payload, man = loaded
                states = self._restore_state(
                    tree_map(lambda a: torch.as_tensor(a, device=dev),
                             payload["state"]), topo)
                keys = torch.as_tensor(payload["keys"].astype(np.int64),
                                       device=dev)
                start_round = int(man["round"])
                ev = man["eval"]
                rounds.extend(int(r) for r in ev["rounds"])
                for s in range(S):
                    acc_t[s].extend(ev["metrics"]["acc"][s])
                    loss_t[s].extend(ev["metrics"]["loss"][s])
                    pe_t[s].extend(ev["metrics"]["edge_power"][s])
                    pi_t[s].extend(ev["metrics"]["is_power"][s])
                if ev.get("telemetry"):
                    tele_acc.extend(
                        {k: np.asarray(v, np.float32) for k, v in t.items()}
                        for t in ev["telemetry"])
                windows_done = len(ev["rounds"])
                self._emit("checkpoint", scenario=sc.name, resumed=True,
                           round=start_round, windows=windows_done)

        git_sha = ft_ckpt.git_sha() if ckpt_mgr is not None else None

        def save_ckpt(states_now, keys_now, cursor):
            manifest = {
                "scenario": sc.name, "fingerprint": fingerprint,
                "seeds": list(self.seeds), "round": int(cursor),
                "rounds_total": int(T), "git_sha": git_sha,
                "torch_version": torch.__version__,
                "engine": {**self._exec_info(topo), "driver": self.driver},
                "guard": cfg.guard, "telemetry": bool(cfg.telemetry),
                "eval": {
                    "rounds": [int(r) for r in rounds],
                    "metrics": {"acc": [list(a) for a in acc_t],
                                "loss": [list(v) for v in loss_t],
                                "edge_power": [list(p) for p in pe_t],
                                "is_power": [list(p) for p in pi_t]},
                    # the host's accumulators ride the JSON manifest
                    # (floats round-trip exactly), the carry the npz
                    "telemetry": ([{k: np.asarray(t[k]).tolist()
                                    for k in t} for t in tele_acc]
                                  if tele_on else None),
                },
            }
            ckpt_mgr.save(int(cursor), {
                "state": self._finalize_state(states_now, topo),
                "keys": keys_now.cpu().numpy().astype(np.uint32)}, manifest)

        ft = _FTContext(guard_on=guard_on, guard_halt=cfg.guard == "halt",
                        ckpt=ckpt_mgr, ckpt_every=self.ckpt_every,
                        start_round=start_round, windows_done=windows_done,
                        faults=self.faults, save=save_ckpt)

        def check_guard(states_now, round_idx):
            total = int(states_now["guard_trips"].sum())
            if total > ft.trips:
                ft.trips = total
                self._emit("guard", scenario=sc.name, round=round_idx,
                           trips=total, policy=cfg.guard)
            if ft.guard_halt and total > 0:
                ft.halted = True

        ft.check_guard = check_guard

        # the [T] schedule in float32 on the device: both drivers read a
        # round's powers from it, so a graph replays with its own window's
        P_all, P_is_all = (
            torch.as_tensor(np.asarray(p, np.float32), device=dev)
            for p in power_schedule(np.arange(T), cfg.power_base,
                                    cfg.power_slope, cfg.power_is_factor,
                                    cfg.power_low))
        windows = eval_windows(T, sc.eval_every)
        states, keys, dispatches, drive_s = self._drive(
            sc, round_fn, eval_state, states, keys, P_all, P_is_all,
            windows, rounds, record, ft)

        telemetry = None
        if tele_acc:
            telemetry = {
                k: [[np.asarray(t[k][s]).tolist() for t in tele_acc]
                    for s in range(S)]
                for k in tele_mod.TELEMETRY_KEYS}
            for rd, t in zip(rounds, tele_acc):
                self._emit("telemetry", scenario=sc.name, round=rd,
                           summary=tele_mod.summarize(t))

        exec_info = {**self._exec_info(topo, spec.two_n),
                     "driver": self.driver, "dispatches": dispatches,
                     "drive_seconds": drive_s, "warmup": self.warmup}
        if guard_on:
            ft.check_guard(states, rounds[-1] if rounds else start_round)
            exec_info.update(guard=cfg.guard, guard_trips=ft.trips,
                             guard_halted=ft.halted)
        if ckpt_mgr is not None:
            exec_info.update(
                ckpt_saves=ckpt_mgr.saves,
                ckpt_io_retries=ckpt_mgr.io_retries,
                ckpt_save_seconds=round(ckpt_mgr.save_seconds, 6),
                ckpt_load_seconds=round(ckpt_mgr.load_seconds, 6),
                ckpt_every=self.ckpt_every,
                resumed_from=start_round if self.resume else None)
        final = None
        if self.keep_state:
            final = self._finalize_state(states, topo)
        seconds = time.perf_counter() - t0
        self._emit("scenario_end", scenario=sc.name, seconds=seconds,
                   drive_seconds=drive_s, dispatches=dispatches,
                   n_traces=0,
                   final_acc_mean=float(np.mean([a[-1] for a in acc_t])))
        return SweepResult(
            scenario=sc, seeds=self.seeds, rounds=rounds, acc=acc_t,
            loss=loss_t, edge_power=pe_t, is_power=pi_t, n_traces=0,
            seconds=seconds, exec_info=exec_info, telemetry=telemetry,
            final_state=final)

    def _drive(self, sc, round_fn, eval_state, states, keys, P_all,
               P_is_all, windows, rounds, record, ft):
        """Every eval window from the resume point on through
        `make_window_fn`'s window: eagerly (stepwise: the host issues
        every round) or as a CUDA graph replay per window (chunked,
        `make_chunk_fn`).  Metrics stay on the device until one fetch at
        the end, or until a boundary needs the host's view: a due
        checkpoint, the guard (every boundary on the stepwise driver,
        as the reference reads it; on the chunked one only for
        ``halt``) or a planned crash.  With ``warmup`` each window
        length (stepwise: the first window) runs once first on
        throwaway copies.  Dispatches count a graph replay per window
        (chunked) or, as the reference counts its programs, a split and
        a round per round and an eval per window (stepwise), each once
        for all seeds under ``batch="vmap"`` and once per seed under
        ``"map"``."""
        T = sum(windows)
        # a checkpoint is cut at a window boundary, so a resume point is
        # the end of a prefix of the windows
        skip, done = 0, 0
        while done < ft.start_round and skip < len(windows):
            done += windows[skip]
            skip += 1
        if done != ft.start_round:
            raise ValueError(
                f"resume round {ft.start_round} is not an eval-window "
                f"boundary of T={T}, eval_every={sc.eval_every}")
        chunked = self.driver == "chunked"
        run = (make_chunk_fn if chunked else make_window_fn)(
            round_fn, eval_state, self.batch)
        todo = windows[skip:]
        if self.warmup and todo:
            # a graph per window length; eager rounds need one window
            lengths = sorted(set(todo)) if chunked else todo[:1]
            for w in lengths:
                run(tree_map(torch.clone, states), tree_map(torch.clone, keys),
                    P_all[:w], P_is_all[:w])
        programs = 1 if self.batch == "vmap" else len(self.seeds)
        faults = ft.faults
        pending, off, steps, driven = [], ft.start_round, 0, 0
        windows_done = ft.windows_done
        seen_captures = getattr(run, "captures", 0)

        def drain():
            if pending:
                for m in torch.stack(pending).cpu().tolist():
                    record(m)
                pending.clear()

        self._sync()
        t_drive = time.perf_counter()
        with self._drive_range():
            for w in todo:
                if (not chunked and faults is not None
                        and faults.crash_round is not None
                        and off < faults.crash_round < off + w):
                    # the stepwise driver stops at the round itself
                    k = faults.crash_round
                    make_window_fn(round_fn, batch=self.batch)(
                        states, keys, P_all[off:k], P_is_all[off:k])
                    self._sync()
                    self._emit("fault", scenario=sc.name,
                               kind="crash_round", round=k)
                    hard_crash(f"injected crash after round {k} "
                               f"({sc.name})")
                w_t0 = time.perf_counter()
                states, keys, m = run(states, keys, P_all[off:off + w],
                                      P_is_all[off:off + w])
                pending.append(m)
                off += w
                rounds.append(off)
                steps += programs * (2 * w + 1)
                driven += 1
                windows_done += 1
                captures = getattr(run, "captures", 0)
                if captures > seen_captures:
                    self._emit("compile", scenario=sc.name,
                               n_traces=captures,
                               new=captures - seen_captures)
                    seen_captures = captures
                self._emit("window", scenario=sc.name, round=off,
                           rounds=w, enqueue_only=True,
                           seconds=round(time.perf_counter() - w_t0, 6))
                due_ckpt = (ft.ckpt is not None
                            and (windows_done % ft.ckpt_every == 0
                                 or off == T))
                crash_due = faults is not None and (
                    faults.crash_window == windows_done
                    or (faults.crash_round is not None
                        and off >= faults.crash_round))
                read_guard = ft.guard_on and (not chunked or ft.guard_halt)
                if read_guard or due_ckpt or crash_due:
                    if ft.guard_on:
                        ft.check_guard(states, off)
                    if due_ckpt or (ft.halted and ft.ckpt is not None):
                        drain()   # a manifest holds the metrics so far
                        ft.save(states, keys, off)
                    if ft.halted:
                        break
                    if crash_due:
                        kind = ("crash_window"
                                if faults.crash_window == windows_done
                                else "crash_round")
                        self._emit("fault", scenario=sc.name, kind=kind,
                                   window=windows_done, round=off)
                        hard_crash(f"injected crash after window "
                                   f"{windows_done} / round {off} "
                                   f"({sc.name})")
            drain()
            self._sync()
        drive_s = time.perf_counter() - t_drive
        dispatches = driven if chunked else steps
        return states, keys, dispatches, drive_s

    def run(self) -> List[SweepResult]:
        return [self.run_scenario(sc) for sc in self.scenarios]


def sweep_to_json(results: Sequence[SweepResult],
                  quick: bool = False) -> Dict:
    return {
        "schema": SCHEMA_VERSION,
        "quick": quick,
        "scenarios": [r.to_record() for r in results],
    }


def bench_doc(results: Sequence[SweepResult]) -> Dict:
    """The ``BENCH_sweep.json`` throughput document: rounds/sec per
    scenario from the driving-loop wall time (``drive_seconds``, which
    ends in a device synchronize), with the engine metadata and the
    device that produced it."""
    records = []
    for r in results:
        rounds = r.rounds[-1] if r.rounds else 0
        drive_s = float(r.exec_info.get("drive_seconds", r.seconds))
        records.append({
            "scenario": r.scenario.name,
            "seeds": len(r.seeds),
            "rounds": rounds,
            "seconds": r.seconds,
            "drive_seconds": drive_s,
            "rounds_per_sec": (rounds / drive_s) if drive_s > 0 else 0.0,
            "driver": r.exec_info.get("driver", "stepwise"),
            "dispatches": r.exec_info.get("dispatches"),
            "exec": dict(r.exec_info),
        })
    return {"schema": BENCH_SCHEMA_VERSION,
            "backend": "torch",
            "device": results[0].exec_info.get("device") if results else None,
            "device_count": 1,
            "records": records}


def state_doc(results: Sequence[SweepResult]) -> Dict:
    """``--state-out``: every scenario's final carry as JSON
    (`STATE_SCHEMA_VERSION`), one entry per leaf, keyed as the JAX
    package keys it (`jax.tree_util.keystr`), its values the seed-stacked
    leaf as nested lists: floats round-trip exactly, so two documents
    compare bit for bit (``repro_torch.obs.diff --max-ulp 0``)."""
    scenarios = []
    for r in results:
        if r.final_state is None:
            raise ValueError(
                f"no final state for {r.scenario.name!r}: state_doc "
                f"needs keep_state=True")
        scenarios.append({
            "scenario": r.scenario.name,
            "state": {_keystr(path): v.detach().cpu().numpy().tolist()
                      for path, v in tree_leaves(r.final_state)},
        })
    return {"schema": STATE_SCHEMA_VERSION, "scenarios": scenarios}


def csv_lines(doc: Dict, prefix: str = "sweep") -> List[str]:
    """Benchmark-suite CSV convention: name,us_per_call,derived."""
    lines = []
    for rec in doc["scenarios"]:
        name = rec["scenario"]["name"]
        n_rounds = max(rec["rounds"][-1] if rec["rounds"] else 1, 1)
        us = 1e6 * rec["seconds"] / n_rounds
        fin = rec["final"]
        lines.append(
            f"{prefix}/{name},{us:.1f},"
            f"final_acc={fin['acc_mean']:.3f}"
            f"±{fin['acc_std']:.3f};edge_power={fin['edge_power']:.2e};"
            f"seeds={len(rec['seeds'])};traces={rec['n_traces']}")
    return lines


def _write_json(path: str, doc: Dict) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(doc, f, indent=1)
    print("wrote", path)


@contextlib.contextmanager
def _profiled(out_dir: Optional[str], device: str):
    """`torch.profiler` around the sweep, CUDA activity included on the
    card, written as ``OUT_DIR/trace.json`` (Chrome trace format); a
    no-op without a directory."""
    if not out_dir:
        yield
        return
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "trace.json")
    prof.export_chrome_trace(path)
    print("wrote", path)


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    ap = argparse.ArgumentParser(
        description="Multi-seed scenario sweep (PyTorch port)")
    ap.add_argument("--scenarios", default="fig2_iid",
                    help="comma-separated registry names (--list to see)")
    ap.add_argument("--seeds", type=int, default=1,
                    help="number of seeds (0..S-1)")
    ap.add_argument("--seed-list", default=None,
                    help="explicit comma-separated seeds (overrides --seeds)")
    ap.add_argument("--quick", action="store_true",
                    help="CI-sized scenario variants (seconds, not hours)")
    ap.add_argument("--batch", default="vmap", choices=list(BATCH_MODES),
                    help="seed mode: vmap (default) runs the seeds as one "
                         "program, every op (the OTA kernels included) "
                         "once for all seeds; map runs them one by one, "
                         "each seed bit for bit its run alone")
    ap.add_argument("--driver", default="stepwise",
                    help="round driver(s), comma-separated subset of "
                         "{stepwise, chunked}: stepwise = the host issues "
                         "every round; chunked = one CUDA graph replay "
                         "per eval window (a plain loop per window on "
                         "the CPU; bitwise == stepwise).  Listing both "
                         "runs both and records each, e.g. for driver "
                         "comparisons in --bench-out")
    ap.add_argument("--warmup", action="store_true",
                    help="run every round program (the eager round, or "
                         "each window's graph) once on throwaway copies "
                         "first, so recorded rounds/sec measure steady-"
                         "state dispatch+execution rather than capture "
                         "and first-call costs")
    ap.add_argument("--exec", default="single", dest="exec_name",
                    choices=["single", "sharded"],
                    help="execution engine: single (one pass over all "
                         "users) or sharded (a --mesh of shards, each "
                         "training its own users and launching the "
                         "cluster-hop kernels on its own tile; on one "
                         "card the shards run one after the other)")
    ap.add_argument("--mesh", default="1x1",
                    help="shard mesh CxU for --exec sharded, e.g. 2x4 "
                         "(clusters x users-per-cluster shards); the "
                         "axes need NOT divide the scenario's (C, M) -- "
                         "inactive users are padded in with amp = w = 0")
    ap.add_argument("--combine", default="gathered",
                    choices=["gathered", "u_sharded"],
                    help="fused cluster-hop distribution for --exec "
                         "sharded: gathered (default) runs the full "
                         "combine over all U users per shard; u_sharded "
                         "keeps each cluster-shard's own user tile, runs "
                         "the partial-combine kernel and folds the "
                         "per-tile sums in pinned global u-block order")
    ap.add_argument("--ranks", default=None, choices=["gloo", "nccl"],
                    help="with --exec sharded: run the mesh's shards as "
                         "one process each, joined in a process group of "
                         "this backend (gloo: CPU ranks, or ranks sharing "
                         "one card; nccl: one card a rank); without it "
                         "the shards run in this process")
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default: the CUDA card)")
    ap.add_argument("--telemetry", action="store_true",
                    help="compute the in-program diagnostics block every "
                         "round (repro_torch.obs.telemetry: per-hop SNR, "
                         "noise floor, update-norm ratio, attendance, "
                         "symbol energies) and record it per eval; off "
                         "(the default) adds no op to the round")
    ap.add_argument("--trace", default=None, metavar="OUT_JSONL",
                    help="write the run journal (repro.obs.trace/v1 "
                         "events: graph captures, windows, telemetry "
                         "summaries, checkpoints, faults) here")
    ap.add_argument("--profile", default=None, metavar="DIR",
                    help="wrap the sweep in torch.profiler (CUDA activity "
                         "on the card) and write DIR/trace.json, a Chrome "
                         "trace")
    ap.add_argument("--checkpoint", default=None, metavar="DIR",
                    help="save the sweep's carry (the seeds' states, "
                         "optimizer state, PRNG keys, the metrics so far) "
                         "into per-scenario subdirectories of DIR at "
                         "eval-window boundaries (repro.ft.ckpt/v1 "
                         "manifest, atomic npz)")
    ap.add_argument("--ckpt-every", type=int, default=1, metavar="W",
                    help="save every W eval windows (default 1; the last "
                         "window is always saved)")
    ap.add_argument("--resume", action="store_true",
                    help="resume from the newest checkpoint under "
                         "--checkpoint if there is one (a fresh start "
                         "otherwise); bit for bit the uninterrupted run")
    ap.add_argument("--guard", default="off",
                    choices=list(GUARD_POLICIES),
                    help="non-finite guard on the hops' estimates: off "
                         "(default; adds no op) | halt (skip the hop, "
                         "stop the scenario at the next eval boundary) | "
                         "skip_round (drop the hop's update) | zero_fill "
                         "(zero only the non-finite entries)")
    ap.add_argument("--inject", default=None, metavar="SPEC",
                    help="fault injection (repro_torch.ft.faults."
                         "FaultPlan), e.g. 'crash_round=5', "
                         "'crash_window=2', 'save_errors=2', "
                         "'poison=nan@4:0:1' (MODE@round:cluster:user), "
                         "comma-separated; crashes exit with status 173")
    ap.add_argument("--out", default=None, help="write JSON document here")
    ap.add_argument("--state-out", default=None, metavar="PATH",
                    help="write every scenario's final carry as JSON "
                         "(repro.sim.state/v1); compare two with "
                         "python -m repro_torch.obs.diff --max-ulp 0")
    ap.add_argument("--bench-out", default=None,
                    help="write the BENCH_sweep.json throughput document "
                         "(rounds/sec per scenario) here")
    ap.add_argument("--list", action="store_true",
                    help="list registered scenarios and exit")
    args = ap.parse_args(argv)

    if args.list:
        for name, sc in sorted(list_scenarios().items()):
            ota = sc.ota_mode + (f"[{sc.ota_backend}]" if sc.ota_backend
                                 else "")
            print(f"{name:28s} {sc.dataset}/{sc.partition} "
                  f"tau={sc.tau} I={sc.I} mode={sc.mode}/{ota}")
        return {}

    seeds = ([int(s) for s in args.seed_list.split(",")]
             if args.seed_list else args.seeds)
    faults = None
    if args.inject:
        try:
            faults = FaultPlan.parse(args.inject)
        except ValueError as e:
            ap.error(str(e))
    if args.checkpoint and len(args.driver.split(",")) > 1:
        ap.error("--checkpoint needs a single --driver (the round cursor "
                 "keys one driving schedule)")
    # a checkpoint knob that does nothing is a run its user believes is
    # protected: refuse it here
    if args.ckpt_every < 1:
        ap.error(f"--ckpt-every must be >= 1 windows, "
                 f"got {args.ckpt_every}")
    if args.resume and not args.checkpoint:
        ap.error("--resume needs --checkpoint DIR (nowhere to resume from)")
    if args.ckpt_every != 1 and not args.checkpoint:
        ap.error("--ckpt-every needs --checkpoint DIR (no checkpoints are "
                 "being cut)")
    if args.ranks and args.exec_name != "sharded":
        ap.error("--ranks needs --exec sharded (the single engine runs in "
                 "one process)")
    if args.ranks and args.profile:
        ap.error("--profile traces this process only, not the --ranks "
                 "processes")
    tracer = None
    if args.trace:
        from repro_torch.obs.trace import TraceWriter
        tracer = TraceWriter(args.trace, device=args.device)
    results = []
    # the journal is closed even when a scenario raises, so it ends with
    # run_end
    try:
        with _profiled(args.profile, args.device):
            for driver in args.driver.split(","):
                try:
                    # lazy import: repro_torch.exec builds on this module
                    from repro_torch.exec import make_runner
                    runner = make_runner(
                        args.exec_name, args.scenarios.split(","),
                        seeds=seeds, quick=args.quick, batch=args.batch,
                        mesh=args.mesh, combine=args.combine,
                        ranks=args.ranks,
                        driver=driver.strip(), warmup=args.warmup,
                        device=args.device, telemetry=args.telemetry,
                        trace=tracer, keep_state=bool(args.state_out),
                        checkpoint=args.checkpoint,
                        ckpt_every=args.ckpt_every, resume=args.resume,
                        guard=args.guard, faults=faults)
                except (KeyError, ValueError, RuntimeError) as e:
                    ap.error(str(e.args[0] if e.args else e))
                results.extend(runner.run())
    finally:
        if tracer is not None:
            tracer.close()
            print("wrote", args.trace)
    doc = sweep_to_json(results, quick=args.quick)
    for line in csv_lines(doc):
        print(line)
    if args.out:
        _write_json(args.out, doc)
    if args.state_out:
        _write_json(args.state_out, state_doc(results))
    if args.bench_out:
        _write_json(args.bench_out, bench_doc(results))
    return doc


if __name__ == "__main__":
    main()
