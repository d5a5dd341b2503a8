"""Device traces of the card, and how often a trace loses records.

The helpers `chip_smoke.py` and the card tests (`tests/test_torch_cuda.py`)
count kernel launches with:

- `device_trace()`: a `torch.profiler` trace of the host and the card
  that starts with the card idle and waits `TRACE_PAUSE_S` before its
  body runs;
- `lead_in()`: `TRACE_LEAD_IN` throwaway spin kernels (`SPIN_KERNEL`),
  which the counts leave out: a trace can lose the device records of
  its first kernels;
- `lead_out()`: `TRACE_LEAD_OUT` spin kernels after the traced work,
  inside the trace, and the card idle `TRACE_PAUSE_S` after them: a
  trace loses a long CUDA graph replay's device records less often
  with them (see ``--replays`` below), though not never;
- `traced_drives(runner_cls, traces)`: every drive of a sweep runner
  class (`SweepRunner._drive_range`, a range that starts and ends
  synchronized) under a `device_trace` of its own, followed by the
  lead-out, and the launches its graph replays made
  (`core.whfl.REPLAYED_LAUNCHES`);
- `drive_kernel_counts(prof, kernels)`: the launches of each kernel a
  trace saw on the card inside the drive ranges;
- `count_drives(run, kernels, runner_cls)`: `run()` with its drives
  traced: the launches of each kernel in its warmed chunked drives,
  counted from the graphs (each graph's kernel nodes at its capture,
  times its replays: exact), and those the traces saw (at most as
  many: a trace loses records, see ``--replays``, and never makes one
  up).

The probe (needs a CUDA card and nvcc):

    PYTHONPATH=src python -m repro_torch.kernels.trace_probe [--traces 250]
    PYTHONPATH=src python -m repro_torch.kernels.trace_probe --replays [--traces 40] [--variants pause,lead-out]

The first builds qwen2-1.5b's float32 prefill (4 layers, B 1 x L 4096:
the smoke's hd-128 main path, weights from a seed) and traces one warm
call `--traces` times in each of two variants, in turns: the call right
after the trace starts, and the call after the card has been idle for
`--pause` seconds inside the trace.  A trace is lossy when it holds fewer
device records than the most any trace held; for each lossy trace the
script prints how many it lost, whether they were the first records of
the call (a prefix), and whether the host-side records (``cuda*``
runtime calls) were all kept.

``--replays`` traces the chunked drive of the card test
``test_captured_windows_equal_eager_rounds_on_card[sharded 2x2
u_sharded]`` (fig3_cifar faithful/fused cut to C 2, M 2, mesh 2x2,
u_sharded, 2 seeds, windows of 1 and 2 rounds, warmed: the drive holds
graph replays only) `--traces` times in each of four variants, in turns
(`REPLAY_VARIANTS`, or those `--variants` names): the pause alone, the
pause and the lead-in, the pause and the lead-out, and all three.  It
groups each trace's device records by the replay (``cudaGraphLaunch``)
they belong to, by correlation id, and prints them for each trace as it
goes; then, for each lossy trace, which replay lost records (the first,
the last or one in the middle), how many, whether the host-side launch
records were all kept, and how many lead-out spins were kept.

Then one JSON line per variant and the card's name and power limit.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import subprocess
import sys
import time
from collections import Counter

import torch

# The idle time a trace starts with before its body runs.
TRACE_PAUSE_S = 0.1
# A trace can lose the device records of the first ~30 kernels of the
# call it holds (seamless-m4t-medium's prefill in the smoke), so
# traces that count launches start with this many spin kernels
# (`torch.cuda._sleep`, named SPIN_KERNEL), which the counts leave out.
TRACE_LEAD_IN = 128
# A trace of a chunked drive loses device records of its longest graph
# replay less often (`--replays`) when it ends with this many spin
# kernels and a pause.
TRACE_LEAD_OUT = 128
SPIN_KERNEL = "spin_kernel"
# Traces of one call taken in all, at most, while they read short (the
# smoke's prefills and its `--profile` run; not the chunked drives,
# whose launches `count_drives` counts from the graphs).
TRACE_ATTEMPTS = 5
DRIVE_RANGE = "SweepRunner.drive"
# --replays: (lead-in before the drive, lead-out after it), each trace
# after the pause
REPLAY_VARIANTS = {"pause": (False, False), "lead-in": (True, False),
                   "lead-out": (False, True), "lead-in+out": (True, True)}
GRAPH_LAUNCH = "cudaGraphLaunch"


@contextlib.contextmanager
def device_trace():
    """A `torch.profiler` trace of the host and the card that starts with
    the card idle and waits TRACE_PAUSE_S before its body runs."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        time.sleep(TRACE_PAUSE_S)
        yield prof


def lead_in() -> None:
    """TRACE_LEAD_IN spin kernels of ~1,000 clocks each."""
    for _ in range(TRACE_LEAD_IN):
        torch.cuda._sleep(1000)


def lead_out() -> None:
    """TRACE_LEAD_OUT spin kernels of ~1,000 clocks each, then the card
    idle for TRACE_PAUSE_S."""
    for _ in range(TRACE_LEAD_OUT):
        torch.cuda._sleep(1000)
    torch.cuda.synchronize()
    time.sleep(TRACE_PAUSE_S)


def raw_events(prof):
    """A trace's events as kineto recorded them (`_KinetoEvent`), which
    read far faster than `prof.events()` for a trace of many rounds."""
    return prof.profiler.kineto_results.events()


def drive_ops(prof):
    """(every device op of a trace, the device ops that start inside one
    of the runners' drive ranges, the ranges found); spin kernels and
    annotations left out."""
    from torch.autograd import DeviceType

    events = raw_events(prof)
    drives = [(e.start_ns(), e.end_ns()) for e in events
              if e.name() == DRIVE_RANGE
              and e.device_type() == DeviceType.CPU]
    ops = [e for e in events if e.device_type() == DeviceType.CUDA
           and e.name() != DRIVE_RANGE
           and not e.is_user_annotation() and SPIN_KERNEL not in e.name()]
    inside = [e for e in ops
              if any(lo <= e.start_ns() <= hi for lo, hi in drives)]
    return ops, inside, drives


def drive_kernel_counts(prof, kernels) -> dict:
    """{name: launches} of each kernel of `kernels` ({name: a substring
    of its device function's name}) that a trace saw on the card inside
    the drive ranges."""
    _, inside, _ = drive_ops(prof)
    return {name: sum(fn in e.name() for e in inside)
            for name, fn in kernels.items()}


@contextlib.contextmanager
def traced_drives(runner_cls, traces, before: bool = False,
                  after: bool = True, replayed=None):
    """Every drive of a `runner_cls` (its subclasses too, also through
    the CLI) inside the block under a `device_trace` of its own (not the
    runs' set-up, warm-up or the chunked driver's captures), with the
    `lead_in` spins before it if `before` and the `lead_out` after it if
    `after`; the traces appended to `traces` as the drives end, and
    each drive's graph-replay launches ({kernel: launches},
    `core.whfl.REPLAYED_LAUNCHES`) to the list `replayed` if given."""
    from repro_torch.core.whfl import REPLAYED_LAUNCHES

    drive_range = runner_cls._drive_range

    @contextlib.contextmanager
    def traced(self):
        with device_trace() as prof:
            if before:
                lead_in()
            start = Counter(REPLAYED_LAUNCHES)
            with drive_range(self):
                yield
            if after:
                lead_out()
        traces.append(prof)
        if replayed is not None:
            replayed.append(dict(Counter(REPLAYED_LAUNCHES) - start))

    runner_cls._drive_range = traced
    try:
        yield
    finally:
        runner_cls._drive_range = drive_range


def count_drives(run, kernels: dict, runner_cls) -> tuple:
    """`run()` with every drive of `runner_cls` traced (`traced_drives`):
    returns (its output, {kernel: launches} of each kernel of `kernels`
    that the drives' graph replays made, counted from the graphs, and
    {kernel: launches} the traces saw on the card).  The drives must be
    chunked and warmed up, so that they hold graph replays only.  The
    first count is exact (each graph's kernel nodes at its capture,
    times its replays); the second is at most the first (a trace can
    lose a replay's device records and never makes one up)."""
    traces, replayed = [], []
    with traced_drives(runner_cls, traces, replayed=replayed):
        out = run()
    counts = {name: sum(r.get(name, 0) for r in replayed)
              for name in kernels}
    seen = {name: sum(drive_kernel_counts(p, kernels)[name]
                      for p in traces) for name in kernels}
    return out, counts, seen


def card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()


def prefill_probe(a) -> None:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import prng
    from repro_torch.configs import INPUT_SHAPES, get_config
    from repro_torch.launch import serve
    from repro_torch.models import lm

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


def replay_records(prof) -> tuple:
    """(device records of each graph replay inside the drive ranges, in
    launch order, by correlation id; device records inside the drive
    that no launch record claims; spin records after the drive)."""
    from torch.autograd import DeviceType

    _, inside, drives = drive_ops(prof)
    end = max(hi for _, hi in drives)
    spins = sum(e.device_type() == DeviceType.CUDA
                and SPIN_KERNEL in e.name() and e.start_ns() > end
                for e in raw_events(prof))
    launches = sorted(
        (e for e in raw_events(prof) if e.name() == GRAPH_LAUNCH
         and e.device_type() == DeviceType.CPU
         and any(lo <= e.start_ns() <= hi for lo, hi in drives)),
        key=lambda e: e.start_ns())
    by_id = Counter(e.correlation_id() for e in inside)
    per = [by_id.pop(e.correlation_id(), 0) for e in launches]
    return per, sum(by_id.values()), spins


def replay_probe(a) -> None:
    from repro_torch.exec import make_runner
    from repro_torch.sim import SweepRunner
    from repro_torch.sim.scenario import get_scenario

    sc = get_scenario("fig3_cifar").replace(
        C=2, M=2, batch=8, tau=2, n_train=400, n_test=64, K=4, K_ps=4,
        total_IT=3, eval_every=2, ota_mode="faithful", ota_backend="fused")
    runner = make_runner("sharded", [sc], seeds=2, mesh="2x2",
                         combine="u_sharded", driver="chunked", warmup=True,
                         device="cuda", batch="map")
    runner.run()
    variants = {v: REPLAY_VARIANTS[v] for v in a.variants.split(",")}
    runs = {v: [] for v in variants}
    for i in range(a.traces):
        for v, (before, after) in variants.items():
            traces = []
            with traced_drives(SweepRunner, traces, before, after):
                runner.run()
            per, unclaimed, kept = replay_records(traces[0])
            runs[v].append((per, unclaimed, kept))
            print(json.dumps({"variant": v, "trace": i,
                              "records_per_replay": per,
                              "unclaimed_device_records": unclaimed,
                              "lead_out_spins_kept": kept}), flush=True)
    full = max((r for rs in runs.values() for r in rs),
               key=lambda r: sum(r[0]))
    for v, rs in runs.items():
        lossy = 0
        for i, (per, unclaimed, kept) in enumerate(rs):
            short = [j for j, (n, m) in enumerate(zip(per, full[0]))
                     if n < m]
            if not short and len(per) == len(full[0]):
                continue
            lossy += 1
            where = ["first" if j == 0 else "last" if j == len(per) - 1
                     else "middle" for j in short]
            print(json.dumps({"variant": v, "trace": i,
                              "replays_short": where,
                              "lost": sum(full[0]) - sum(per),
                              "launch_records_kept":
                                  len(per) == len(full[0]),
                              "lead_out_spins_kept": kept}), flush=True)
        spins = [r[2] for r in rs]
        print(json.dumps({"variant": v, "traces": len(rs),
                          "lossy_traces": lossy,
                          "records_per_replay_complete": full[0],
                          "lead_out_spins": TRACE_LEAD_OUT
                          if variants[v][1] else 0,
                          "lead_out_spins_kept": [min(spins), max(spins)]}),
              flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--traces", type=int, default=250)
    ap.add_argument("--pause", type=float, default=TRACE_PAUSE_S)
    ap.add_argument("--replays", action="store_true",
                    help="trace the card test's chunked drive instead of "
                         "the prefill")
    ap.add_argument("--variants", default=",".join(REPLAY_VARIANTS),
                    help="--replays: the variants to trace, in turns")
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("trace_probe: this probe needs a CUDA card")
    (replay_probe if a.replays else prefill_probe)(a)
    print(card())
    return 0


if __name__ == "__main__":
    sys.exit(main())
