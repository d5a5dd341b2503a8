"""Multi-seed scenario sweeps on one device.

`SweepRunner` runs ``S seeds x M scenarios``: per scenario it builds the
W-HFL round (`repro_torch.core.whfl.make_round_fn`) once and drives every
seed through it round by round.  Seeds run as a loop, which gives the
reference's ``batch="map"`` semantics: each seed's trajectory is the one
it would have swept alone, and every random draw follows the per-seed
key exactly as in the JAX package (model init from ``PRNGKey(s)``, the
round keys from ``split`` of ``PRNGKey(s + 1)``).

    python -m repro_torch.sim.sweep --scenarios fig2_iid --seeds 2 \
        --out sweep.json

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
from repro_torch.core.whfl import init_round_state, make_round_fn
from repro_torch.optim import adam, sgd
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


def resolve_device(device: Optional[str]) -> torch.device:
    """The run's device: CUDA unless the caller names another.  Raises
    when CUDA is asked for (or defaulted to) and there is no card."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: the port runs on the card by default; "
            "pass device='cpu' (--device cpu) to run on the CPU")
    return dev


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
    device: None (the CUDA card) or a torch device string.
    """

    def __init__(self, scenarios: Sequence[Union[str, Scenario]],
                 seeds: Union[int, Sequence[int]] = 1,
                 quick: bool = False, keep_state: bool = False,
                 batch: str = "map", device: Optional[str] = None):
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

    def _exec_info(self) -> Dict:
        return {"name": "single", "mesh": None, "device_count": 1,
                "batch": "map", "device": device_name(self.device),
                "driver": "stepwise"}

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
        states = [init_round_state(p, opt, topo.C, topo.M) for p in params]
        keys = [prng.PRNGKey(s + 1, dev) for s in self.seeds]
        round_fn = make_round_fn(loss_fn, opt, topo, cfg, spec,
                                 torch.as_tensor(X, device=dev),
                                 torch.as_tensor(Y, device=dev))
        xte_d = torch.as_tensor(xte, device=dev)
        yte_d = torch.as_tensor(yte, device=dev)

        @torch.no_grad()
        def _eval(theta):
            logits = apply_fn(theta, xte_d)
            acc = torch.mean((logits.argmax(-1) == yte_d).to(torch.float32))
            logp = torch.log_softmax(logits, -1)
            loss = -torch.mean(logp.gather(-1, yte_d.long()[:, None]))
            return float(acc), float(loss)

        S, T = len(self.seeds), sc.rounds
        rounds: List[int] = []
        acc_t = [[] for _ in range(S)]
        loss_t = [[] for _ in range(S)]
        pe_t = [[] for _ in range(S)]
        pi_t = [[] for _ in range(S)]

        self._sync()
        t_drive = time.perf_counter()
        # a named range for profilers; it starts and ends synchronized,
        # so the device work inside it is exactly the rounds' and evals'
        with torch.profiler.record_function("SweepRunner.drive"):
            for t in range(T):
                P_t, P_is_t = power_schedule(
                    t, cfg.power_base, cfg.power_slope, cfg.power_is_factor,
                    cfg.power_low)
                for s in range(S):
                    keys[s], sub = prng.split(keys[s])
                    states[s] = round_fn(states[s], sub, P_t, P_is_t)
                if t % sc.eval_every == 0 or t == T - 1:
                    rounds.append(t + 1)
                    for s, st in enumerate(states):
                        a, l = _eval(st["theta"])
                        acc_t[s].append(a)
                        loss_t[s].append(l)
                        pe_t[s].append(float(
                            st["power_edge"]
                            / max(float(st["n_edge_tx"]), 1.0)))
                        pi_t[s].append(float(
                            st["power_is"]
                            / max(float(st["n_is_tx"]), 1.0)))
            self._sync()
        drive_s = time.perf_counter() - t_drive

        final = None
        if self.keep_state:
            final = tree_map(lambda *xs: torch.stack(xs), *states)
        return SweepResult(
            scenario=sc, seeds=self.seeds, rounds=rounds, acc=acc_t,
            loss=loss_t, edge_power=pe_t, is_power=pi_t, n_traces=0,
            seconds=time.perf_counter() - t0,
            exec_info={**self._exec_info(), "drive_seconds": drive_s},
            final_state=final)

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
            "dispatches": None,
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
    try:
        runner = SweepRunner(args.scenarios.split(","), seeds=seeds,
                             quick=args.quick, batch=args.batch,
                             device=args.device)
    except (KeyError, ValueError, RuntimeError) as e:
        ap.error(str(e.args[0] if e.args else e))
    results = runner.run()
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
