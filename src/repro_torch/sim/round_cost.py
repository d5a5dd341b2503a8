"""What a W-HFL round costs on the card, per option: wall ms and device
ops and device ms per round, on both drivers and both seed modes, and
the seconds of a checkpoint's save and load.

    python src/repro_torch/sim/round_cost.py --out cost.json
    python src/repro_torch/sim/round_cost.py --src OTHER/src --variants plain
    python src/repro_torch/sim/round_cost.py --variants plain \
        --batch vmap,map --seeds 1,4,8

Each (variant, driver, seed mode, seed count S) runs `fig2_iid` with the
fused backend at the paper's sizes (C 4, M 5, K = K_ps = 100, batch
500, n_train 20,000), S seeds (``--seeds``, default 1) in ``--batch``
mode (``vmap``: one program for all seeds; ``map``: seed by seed),
``--rounds`` rounds, once to warm up, once timed (wall ms a round:
``drive_seconds`` / T; rounds x seeds a second: S T /
``drive_seconds``) and under `torch.profiler` (the
device ops that start inside the runner's ``SweepRunner.drive`` range,
which begins and ends with a synchronize; the chunked driver's graphs
are captured before it; the fullest of three traces, since a trace can
lose device records).  Variants: ``plain``, ``telemetry``, ``guard``
(``skip_round``) and ``both``.  ``--ckpt`` adds a run that saves every
window (2 seeds) and one that resumes from its last save: seconds per
save and per load.

It is a script, not a module of the package: ``--src`` puts another
checkout's ``src`` first on the path, so one call on the card can time
two versions of the port in turns (a version without telemetry or the
guard takes ``--variants plain``).
"""
import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

TRACES = 3


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=None,
                    help="the checkout's src directory to import from "
                         "(default: this file's)")
    ap.add_argument("--rounds", type=int, default=20)
    ap.add_argument("--variants", default="plain,telemetry,guard,both")
    ap.add_argument("--drivers", default="stepwise,chunked")
    ap.add_argument("--batch", default="vmap",
                    help="seed modes, comma-separated subset of {vmap, map}")
    ap.add_argument("--seeds", default="1",
                    help="seed counts S, comma-separated")
    ap.add_argument("--ckpt", action="store_true")
    ap.add_argument("--label", default="")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    here = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    sys.path.insert(0, os.path.abspath(args.src or here))

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.sim import SweepRunner, get_scenario

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sc = get_scenario("fig2_iid").replace(
        total_IT=args.rounds, ota_mode="faithful", ota_backend="fused")
    T = sc.rounds
    opts = {"plain": {}, "telemetry": {"telemetry": True},
            "guard": {"guard": "skip_round"},
            "both": {"telemetry": True, "guard": "skip_round"}}
    import repro_torch
    out = {"label": args.label, "src": os.path.dirname(
               os.path.dirname(repro_torch.__file__)),
           "card": torch.cuda.get_device_name(0),
           "nvidia_smi": subprocess.run(
               ["nvidia-smi", "--query-gpu=name,power.limit",
                "--format=csv,noheader"], capture_output=True,
               text=True).stdout.strip(), "rounds": T, "runs": []}
    print(json.dumps({"card": out["nvidia_smi"]}), flush=True)

    def drive_device(prof):
        events = prof.profiler.kineto_results.events()
        drives = [(e.start_ns(), e.end_ns()) for e in events
                  if e.name() == "SweepRunner.drive"
                  and e.device_type() == DeviceType.CPU]
        ops = [e for e in events if e.device_type() == DeviceType.CUDA
               and not e.is_user_annotation()
               and any(lo <= e.start_ns() <= hi for lo, hi in drives)]
        return len(ops), sum(e.duration_ns() for e in ops) / 1e6

    cases = [(v, d, b, int(S)) for v in args.variants.split(",")
             for d in args.drivers.split(",")
             for b in args.batch.split(",") for S in args.seeds.split(",")]
    for variant, driver, batch, S in cases:
        runner = SweepRunner([sc], seeds=S, device="cuda",
                             driver=driver, warmup=True, batch=batch,
                             **opts[variant])
        run_sc = runner.scenarios[0]     # telemetry rides in it
        runner.run_scenario(run_sc)
        wall = runner.run_scenario(run_sc).exec_info["drive_seconds"]
        # a trace can lose device records, never gain them: the
        # fullest of TRACES is kept
        n_ops, dev_ms = 0, 0.0
        for _ in range(TRACES):
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                time.sleep(0.1)
                runner.run_scenario(run_sc)
            n_ops, dev_ms = max((n_ops, dev_ms), drive_device(prof))
        rec = {"variant": variant, "driver": driver, "batch": batch,
               "seeds": S, "wall_ms_per_round": 1e3 * wall / T,
               "rounds_seeds_per_sec": S * T / wall,
               "device_ops_per_round": n_ops / T if n_ops else
               "not measured",
               "device_ms_per_round": dev_ms / T if n_ops else
               "not measured"}
        out["runs"].append(rec)
        print(json.dumps(rec), flush=True)

    if args.ckpt:
        with tempfile.TemporaryDirectory() as d:
            save = SweepRunner([sc], seeds=2, device="cuda", checkpoint=d,
                               batch="map")
            info = save.run_scenario(sc).exec_info
            load = SweepRunner([sc], seeds=2, device="cuda", checkpoint=d,
                               resume=True, batch="map"
                               ).run_scenario(sc).exec_info
            nbytes = sum(os.path.getsize(os.path.join(r, f))
                         for r, _, fs in os.walk(d) for f in fs)
        rec = {"ckpt_saves": info["ckpt_saves"],
               "ckpt_save_seconds_each": info["ckpt_save_seconds"]
               / info["ckpt_saves"],
               "ckpt_load_seconds": load["ckpt_load_seconds"],
               "ckpt_dir_bytes": nbytes, "seeds": 2}
        out["ckpt"] = rec
        print(json.dumps(rec), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return out


if __name__ == "__main__":
    main()
