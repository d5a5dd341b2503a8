"""Multi-seed scenario sweeps.

`SweepRunner` runs ``S seeds x M scenarios``: per scenario it builds the
W-HFL round (`repro_torch.core.whfl.make_round_fn`) once and drives every
seed through it round by round.  Seeds run as a loop, which gives the
reference's ``batch="map"`` semantics: each seed's trajectory is the one
it would have swept alone, and every random draw follows the per-seed
key exactly as in the JAX package (model init from ``PRNGKey(s)``, the
round keys from ``split`` of ``PRNGKey(s + 1)``).

    python -m repro_torch.sim.sweep --scenarios fig2_iid --seeds 2 \
        --out sweep.json

``--exec sharded --mesh CxU [--combine u_sharded]`` drives the same
sweep through the sharded engine (`repro_torch.exec.ShardedSweepRunner`),
which overrides the runner's engine hooks.  ``--driver chunked`` replays
each eval window's rounds and eval as one CUDA graph
(`repro_torch.core.whfl.make_chunk_fn`) instead of issuing every round
from the host; ``--driver stepwise,chunked`` runs and records both.

The entry points run on the CUDA card unless the caller asks for
another device (``device="cpu"``, ``--device cpu``); without a card
they raise.  The output documents keep the JAX package's schemas
(`SCHEMA_VERSION`, `BENCH_SCHEMA_VERSION`, `RECORD_KEYS`).
"""
from __future__ import annotations

import argparse
import json
import os
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch import prng
from repro_torch.core import aggregation as agg
from repro_torch.core.topology import power_schedule
from repro_torch.core.whfl import (eval_windows, init_round_state,
                                   make_chunk_fn, make_round_fn,
                                   make_window_fn)
from repro_torch.optim import adam, sgd
from repro_torch.device import resolve_device
from repro_torch.sim.scenario import Scenario, get_scenario, list_scenarios
from repro_torch.tree import tree_map

SCHEMA_VERSION = "repro.sim.sweep/v1"
BENCH_SCHEMA_VERSION = "repro.bench.sweep/v1"

# Every per-scenario record carries exactly these keys.  "telemetry" is
# always null here (the port has no telemetry yet); the key stays so the
# schema keeps its fixed shape.
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
            "telemetry": None,
        }


class SweepRunner:
    """Run a list of scenarios over a shared seed list on one device.

    scenarios: Scenario objects or registry names.
    seeds: int S (-> seeds 0..S-1) or an explicit list.
    quick: substitute each scenario's CI-sized `.quick()` variant.
    keep_state: keep each scenario's final round state, stacked over
      seeds, in `SweepResult.final_state`.
    batch: the reference's seed-batch mode, "vmap" or "map".  Seeds run
      as a loop either way, which is "map"; records say so.
    driver: "stepwise" (the host issues every round) or "chunked" (one
      CUDA graph per eval window, `repro_torch.core.whfl.make_chunk_fn`;
      a plain loop per window on the CPU).  Both give the same bits.
    warmup: run each window length's graph (stepwise: the first window)
      once on throwaway copies before the timed drive, so
      ``drive_seconds`` holds no capture or first-call costs.
    device: None (the CUDA card) or a torch device string.
    """

    def __init__(self, scenarios: Sequence[Union[str, Scenario]],
                 seeds: Union[int, Sequence[int]] = 1,
                 quick: bool = False, keep_state: bool = False,
                 batch: str = "map", driver: str = "stepwise",
                 warmup: bool = False, device: Optional[str] = None):
        self.device = resolve_device(device)
        self.scenarios = [get_scenario(s) if isinstance(s, str) else s
                          for s in scenarios]
        if quick:
            self.scenarios = [s.quick() for s in self.scenarios]
        self.seeds = (list(range(seeds)) if isinstance(seeds, int)
                      else list(seeds))
        self.keep_state = keep_state
        if batch not in ("vmap", "map"):
            raise ValueError(f"batch must be 'vmap' or 'map', got {batch!r}")
        if driver not in DRIVERS:
            raise ValueError(f"driver must be one of {DRIVERS}, "
                             f"got {driver!r}")
        self.driver = driver
        self.warmup = warmup

    # -- engine hooks (overridden by repro_torch.exec.ShardedSweepRunner) --

    def _init_states(self, params, opt, topo):
        """Per-seed initial round states.  The sharded engine sizes the
        per-user ``opt`` axes to its mesh's padded (Cp, Mp) grid."""
        return [init_round_state(p, opt, topo.C, topo.M) for p in params]

    def _build_round(self, loss_fn, opt, topo, cfg, spec, X, Y):
        """The per-seed round ``round_fn(state, key, P_t, P_is_t)``."""
        return make_round_fn(loss_fn, opt, topo, cfg, spec, X, Y)

    def _finalize_state(self, state, topo):
        """The seed-stacked state view stored as ``final_state``.  The
        sharded engine strips its inactive-user padding here."""
        return state

    def _exec_info(self, topo=None, two_n=None) -> Dict:
        """Execution-engine metadata recorded with every result;
        `topo`/`two_n` let the sharded engine add its padded shape and
        symbol-buffer bytes.  ``device_count`` is the number of torch
        devices the engine runs on."""
        return {"name": "single", "mesh": None, "device_count": 1,
                "batch": "map", "device": device_name(self.device)}

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
        t0 = time.perf_counter()
        dev = self.device
        cfg = sc.whfl_config()
        init_fn, apply_fn, loss_fn = sc.task_fns()
        X, Y, xte, yte = sc.make_data()
        topo = sc.make_topology()
        opt = adam(sc.lr) if sc.opt == "adam" else sgd(sc.lr)

        params = [init_fn(prng.PRNGKey(s, dev)) for s in self.seeds]
        spec = agg.make_flat_spec(params[0])
        states = self._init_states(params, opt, topo)
        keys = [prng.PRNGKey(s + 1, dev) for s in self.seeds]
        round_fn = self._build_round(loss_fn, opt, topo, cfg, spec,
                                     torch.as_tensor(X, device=dev),
                                     torch.as_tensor(Y, device=dev))
        xte_d = torch.as_tensor(xte, device=dev)
        yte_d = torch.as_tensor(yte, device=dev)

        @torch.no_grad()
        def eval_state(st):
            """[4] float32 on the device: test accuracy, test loss and the
            running average edge and IS powers."""
            logits = apply_fn(st["theta"], xte_d)
            acc = torch.mean((logits.argmax(-1) == yte_d).to(torch.float32))
            logp = torch.log_softmax(logits, -1)
            loss = -torch.mean(logp.gather(-1, yte_d.long()[:, None]))
            pe = st["power_edge"] / torch.clamp_min(st["n_edge_tx"], 1.0)
            pi = st["power_is"] / torch.clamp_min(st["n_is_tx"], 1.0)
            return torch.stack([acc, loss, pe, pi])

        T = sc.rounds
        # the [T] schedule in float32 on the device: both drivers read a
        # round's powers from it, so a graph replays with its own window's
        P_all, P_is_all = (
            torch.as_tensor(np.asarray(p, np.float32), device=dev)
            for p in power_schedule(np.arange(T), cfg.power_base,
                                    cfg.power_slope, cfg.power_is_factor,
                                    cfg.power_low))
        windows = eval_windows(T, sc.eval_every)
        states, metrics, dispatches, drive_s = self._drive(
            round_fn, eval_state, states, keys, P_all, P_is_all, windows)

        S = len(self.seeds)
        rounds = list(np.cumsum(windows).tolist())
        acc_t, loss_t, pe_t, pi_t = (
            [[m[s][j] for m in metrics] for s in range(S)]
            for j in range(len(METRIC_KEYS)))
        final = None
        if self.keep_state:
            final = self._finalize_state(
                tree_map(lambda *xs: torch.stack(xs), *states), topo)
        return SweepResult(
            scenario=sc, seeds=self.seeds, rounds=rounds, acc=acc_t,
            loss=loss_t, edge_power=pe_t, is_power=pi_t, n_traces=0,
            seconds=time.perf_counter() - t0,
            exec_info={**self._exec_info(topo, spec.two_n),
                       "driver": self.driver, "dispatches": dispatches,
                       "drive_seconds": drive_s, "warmup": self.warmup},
            final_state=final)

    def _drive(self, round_fn, eval_state, states, keys, P_all, P_is_all,
               windows):
        """Every eval window through `make_window_fn`'s window, its
        metrics left on the device until one fetch at the end: eagerly
        (stepwise: the host issues every round) or as a CUDA graph replay
        per window (chunked, `make_chunk_fn`).  With ``warmup`` each
        window length (stepwise: the first window) runs once first on
        throwaway copies.  Dispatches count a graph replay per window
        (chunked) or, as the reference counts its programs, a split and a
        round per seed and round and an eval per seed and window
        (stepwise)."""
        run = (make_chunk_fn if self.driver == "chunked"
               else make_window_fn)(round_fn, eval_state)
        if self.warmup:
            # a graph per window length; eager rounds need one window
            lengths = (sorted(set(windows)) if self.driver == "chunked"
                       else windows[:1])
            for w in lengths:
                run([tree_map(torch.clone, st) for st in states],
                    [k.clone() for k in keys], P_all[:w], P_is_all[:w])
        S = len(states)
        pending, off, steps = [], 0, 0
        self._sync()
        t_drive = time.perf_counter()
        with self._drive_range():
            for w in windows:
                states, keys, m = run(states, keys, P_all[off:off + w],
                                      P_is_all[off:off + w])
                pending.append(m)
                off += w
                steps += S * (2 * w + 1)
            metrics = torch.stack(pending).cpu().tolist()
            self._sync()
        drive_s = time.perf_counter() - t_drive
        dispatches = len(windows) if self.driver == "chunked" else steps
        return states, metrics, dispatches, drive_s

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
    ap.add_argument("--batch", default="map", choices=["vmap", "map"],
                    help="the reference's seed-batch mode; the port runs "
                         "seeds as a loop, i.e. map, and records that")
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
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default: the CUDA card)")
    ap.add_argument("--out", default=None, help="write JSON document here")
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
    # lazy import: repro_torch.exec builds on this module
    from repro_torch.exec import make_runner
    results = []
    for driver in args.driver.split(","):
        try:
            runner = make_runner(args.exec_name, args.scenarios.split(","),
                                 seeds=seeds, quick=args.quick,
                                 batch=args.batch, mesh=args.mesh,
                                 combine=args.combine,
                                 driver=driver.strip(), warmup=args.warmup,
                                 device=args.device)
        except (KeyError, ValueError, RuntimeError) as e:
            ap.error(str(e.args[0] if e.args else e))
        results.extend(runner.run())
    doc = sweep_to_json(results, quick=args.quick)
    for line in csv_lines(doc):
        print(line)
    if args.out:
        _write_json(args.out, doc)
    if args.bench_out:
        _write_json(args.bench_out, bench_doc(results))
    return doc


if __name__ == "__main__":
    main()
