"""Time the one-process sharded engine of two or more trees against each
other on one card, in turns.

    PYTHONPATH=src python -m repro_torch.exec.ab TREE_A TREE_B

Each TREE is the root of a checkout of the repo (an older one from
``git archive <rev> | tar -x -C DIR``, in a directory the chip copy
carries).  Each tree runs every run of RUNS in one process of its own,
with ``PYTHONPATH=TREE/src``, in the order A, B, ..., B, A: a
`ShardedSweepRunner` run (warmed, seeds one by one) and its peak device
memory (``torch.cuda.max_memory_allocated`` from a reset just before
it, the process holding nothing else on the card) and its drive's
rounds/s.  Prints one JSON line per turn, tree and run, with whether its
metrics equal the first tree's bit for bit, and the card's name and
power limit.  Needs a CUDA card and nvcc.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

# (scenario, ota backend or None as registered, mesh, combine, seeds,
# driver)
RUNS = [("scale_u65536", None, "1x1", "u_sharded", 1, "stepwise"),
        ("scale_u65536", None, "1x1", "u_sharded", 1, "chunked"),
        ("scale_u256", None, "2x4", "u_sharded", 2, "stepwise"),
        ("scale_u256", None, "2x4", "u_sharded", 2, "chunked"),
        ("scale_u256", None, "2x4", "gathered", 2, "stepwise"),
        ("fig2_iid", "fused", "2x2", "u_sharded", 2, "stepwise")]

# one tree's runs, in its own process (it may predate this module)
CHILD = r"""
import json, sys
import torch
from repro_torch.exec import ShardedSweepRunner
from repro_torch.sim.scenario import get_scenario

out = []
for name, backend, mesh, combine, seeds, driver in json.loads(sys.argv[1]):
    sc = get_scenario(name)
    if backend:
        sc = sc.replace(ota_mode="faithful", ota_backend=backend)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    res = ShardedSweepRunner([sc], seeds=seeds, mesh=mesh, combine=combine,
                             driver=driver, warmup=True,
                             device="cuda").run()[0]
    out.append({"run": f"{name} {mesh} {combine} {driver}",
                "rounds_per_sec": res.rounds[-1]
                / res.exec_info["drive_seconds"],
                "max_memory_allocated_bytes":
                    torch.cuda.max_memory_allocated(),
                "metrics": [res.acc, res.loss, res.edge_power,
                            res.is_power]})
    del res
print(json.dumps(out))
"""


def run_tree(tree: Path) -> list:
    env = dict(os.environ, PYTHONPATH=str(tree / "src"))
    proc = subprocess.run([sys.executable, "-c", CHILD, json.dumps(RUNS)],
                          cwd=str(tree), env=env, capture_output=True,
                          text=True, timeout=1200)
    if proc.returncode != 0:
        raise SystemExit(f"{tree}: rc {proc.returncode}\n"
                         f"{proc.stderr[-3000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("trees", nargs="+", type=Path)
    a = ap.parse_args(argv)
    order = a.trees + a.trees[::-1]
    first = {}
    for turn, tree in enumerate(order):
        for r in run_tree(tree.resolve()):
            first.setdefault(r["run"], r["metrics"])
            print(json.dumps({"turn": turn, "tree": str(tree),
                              "run": r["run"],
                              "rounds_per_sec": r["rounds_per_sec"],
                              "max_memory_allocated_bytes":
                                  r["max_memory_allocated_bytes"],
                              "metrics_equal_first":
                                  r["metrics"] == first[r["run"]]}),
                  flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
