"""How often a `torch.profiler` trace loses the card's records of its
first kernels, with and without a pause at the trace's start.

    PYTHONPATH=src python -m repro_torch.kernels.trace_probe [--traces 250]

Builds qwen2-1.5b's float32 prefill (4 layers, B 1 x L 4096: the
smoke's hd-128 main path, weights from a seed) and traces one warm call
`--traces` times in each of two variants, in turns: the call right after
the trace starts, and the call after the card has been idle for
`--pause` seconds inside the trace (as `chip_smoke.py`'s `device_trace`
does).  Each trace starts with the card idle.  A trace is lossy when it
holds fewer device records than the most any trace held; for each lossy
trace the script prints how many it lost, whether they were the first
records of the call (a prefix), and whether the host-side records
(`cuda*` runtime calls) were all kept.  Then one JSON line per variant
and the card's name and power limit.  Needs a CUDA card and nvcc.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time


def main(argv=None) -> int:
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import prng
    from repro_torch.configs import INPUT_SHAPES, get_config
    from repro_torch.launch import serve
    from repro_torch.models import lm

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--traces", type=int, default=250)
    ap.add_argument("--pause", type=float, default=0.1)
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("trace_probe: this probe needs a CUDA card")
    dev = torch.device("cuda")
    cfg = get_config("qwen2-1.5b").with_(n_layers=4, compute_dtype="float32")
    shape = dataclasses.replace(INPUT_SHAPES["prefill_32k"], global_batch=1,
                                seq_len=4096)
    served = serve.compute_params(lm.init_params(prng.PRNGKey(0, dev), cfg),
                                  cfg)
    step, specs = serve.build_prefill_step(cfg, shape, device="cuda")
    spec = specs()["tokens"]
    tokens = prng.randint(prng.PRNGKey(2, dev), tuple(spec.shape), 0,
                          cfg.vocab).to(spec.dtype)
    step(served, {"tokens": tokens})

    def trace(pause: float):
        """(device record names, host-side runtime record count) of one
        traced call, in start order."""
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            if pause:
                time.sleep(pause)
            step(served, {"tokens": tokens})
            torch.cuda.synchronize()
        events = sorted(prof.events(), key=lambda e: e.time_range.start)
        return ([e.name for e in events if e.device_type == DeviceType.CUDA],
                sum(e.device_type == DeviceType.CPU
                    and e.name.startswith("cuda") for e in events))

    variants = {"no pause": 0.0, f"pause {a.pause} s": a.pause}
    runs = {v: [] for v in variants}
    for _ in range(a.traces):
        for v, pause in variants.items():
            runs[v].append(trace(pause))
    full = max((r for rs in runs.values() for r in rs),
               key=lambda r: len(r[0]))
    n_full, rt_full = len(full[0]), full[1]
    for v, rs in runs.items():
        lossy = [(i, r) for i, r in enumerate(rs) if len(r[0]) < n_full]
        for i, (names, rt) in lossy:
            lost = n_full - len(names)
            print(json.dumps({"variant": v, "trace": i,
                              "device_records": len(names), "lost": lost,
                              "lost_a_prefix": names == full[0][lost:],
                              "runtime_records_kept": rt == rt_full}),
                  flush=True)
        print(json.dumps({"variant": v, "traces": len(rs),
                          "lossy_traces": len(lossy),
                          "device_records_complete": n_full,
                          "runtime_records_complete": rt_full}), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
