"""Smoke run of the PyTorch port on one CUDA card (an H100).

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:

1. the card's name and power limit (nvidia-smi); TF32 off for matmul
   and cuDNN, so float32 stays float32;
2. build every CUDA kernel of the main path from the sources in this
   checkout (``src/repro_torch/csrc``);
3. each kernel against its plain PyTorch version on the card, at every
   shape the main path gives it, with inputs built as the channel
   backend builds them, plus a few edge shapes (max |y_kernel - y_plain|
   / max |y_plain| <= 1e-4, and two launches give identical bits);
4. the main path through `repro_torch.sim.SweepRunner` on ``cuda`` at
   full width: ``scale_u256`` as registered, ``fig2_iid`` at the
   paper's sizes with the fused backend, and ``fig2_iid`` as registered
   (equivalent backend), 2 seeds each; the kernel's launch count must
   rise by exactly 2 per round per seed on the fused runs (one cluster
   hop, one IS->PS hop) and every metric must be finite;
5. the main path's output against a reference: ``scale_u256`` as
   registered, run on the CPU (plain version) with the same seeds, must
   agree with phase 4's run on the card (kernel);
6. where the time goes: one seed of each phase-4 run through
   `SweepRunner.run_scenario`, warm, then again under `torch.profiler`;
   wall ms per round from the runner's ``drive_seconds``, device time
   per round from the device ops inside the runner's
   ``SweepRunner.drive`` range;
7. kernel and plain times with CUDA events at the scale_u256 and
   scale_u1024 cluster-hop shapes, beside the least time the card could
   take for the same work (see ``fused_mac_bound_ms``);
8. one JSON line of kernel records, then the last line
   ``{"ok": true, "device": {...}}``.

Without CUDA, or without the rest of the repository beside it, it exits
non-zero before printing any result.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from collections import defaultdict
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
TOL = 1e-4
THETA_RTOL = 1e-4

# H100 SXM peaks at the full 700 W power limit and the 1.98 GHz boost
# clock: 132 SMs; per SM and clock 64 INT32 lanes, 128 FP32 lanes
# (67 TFLOP/s float32 outside the tensor cores, counting an FMA as 2)
# and 16 special-function lanes; 3.35 TB/s of HBM3.
INT32_OPS_PER_S = 132 * 64 * 1.98e9
SFU_OPS_PER_S = 132 * 16 * 1.98e9
HBM_BYTES_PER_S = 3.35e12
# per complex draw: one threefry2x32 block (20 rounds of add, rotate,
# xor plus 5 key injections and the counter: about 75 int32 ops) and
# Box-Muller's log, sqrt, sin and cos
INT32_OPS_PER_DRAW = 75
SFU_OPS_PER_DRAW = 4


def log(obj) -> None:
    print(json.dumps(obj) if isinstance(obj, dict) else obj, flush=True)


def fused_mac_bound_ms(B: int, U: int, K: int, N: int):
    """Least time for one fused_mac call on this card: the larger of
    its operations over the peak rates and its bytes over HBM's rate.
    Draws: B*U*K*N channel + B*K*N noise; bytes: t (2 x U*N), amp and w
    (2 x B*U) read once, y (2 x B*N) written once, all float32."""
    draws = B * U * K * N + B * K * N
    t_int = draws * INT32_OPS_PER_DRAW / INT32_OPS_PER_S
    t_sfu = draws * SFU_OPS_PER_DRAW / SFU_OPS_PER_S
    t_bytes = 4 * (2 * U * N + 2 * B * U + 2 * B * N) / HBM_BYTES_PER_S
    bound_by = "operations" if max(t_int, t_sfu) >= t_bytes else "bytes"
    return 1e3 * max(t_int, t_sfu, t_bytes), bound_by


def kernel_inputs(B, U, K, N, seed, dev):
    """Edge-shape inputs: transmit symbols, amplitudes and an
    own-cluster mask (all ones for B = 1)."""
    g = torch.Generator().manual_seed(seed)
    t_re = (1e-2 * torch.randn(U, N, generator=g)).to(dev)
    t_im = (1e-2 * torch.randn(U, N, generator=g)).to(dev)
    amp = (0.2 + torch.rand(B, U, generator=g)).to(dev)
    w = torch.zeros(B, U)
    M = max(U // B, 1)
    for b in range(B):
        w[b, b * M:(b + 1) * M] = 1.0
    if B == 1:
        w[:] = 1.0
    return dict(args=(t_re, t_im, amp, w.to(dev)), K=K, sigma_h2=1.0,
                sigma_z2=1.0, block_u=32)


def hop_inputs(sc, hop: str, seed: int, dev):
    """The kernel's inputs at one hop of `sc`'s round, built as
    `FusedBackend` builds them: transmit symbols P * pack(deltas) from
    random deltas at a round's scale, the topology's amplitudes and
    matched-filter weights, the round-0 power and the hop's antennas."""
    from repro_torch import prng
    from repro_torch.core import aggregation, channel
    from repro_torch.core.topology import power_schedule
    from repro_torch.kernels import canonical_block_u

    topo = sc.make_topology()
    cfg = sc.whfl_config()
    P_t, P_is_t = power_schedule(0, cfg.power_base, cfg.power_slope,
                                 cfg.power_is_factor, cfg.power_low)
    two_n = aggregation.make_flat_spec(
        sc.task_fns()[0](prng.PRNGKey(seed))).two_n
    g = torch.Generator().manual_seed(seed)
    if hop == "cluster":
        U = topo.C * topo.M
        P, K, block_u = P_t, topo.K, canonical_block_u(topo.M)
        amp, w, _ = channel._cluster_geometry(topo, cfg.ota, dev)
    else:
        U = topo.C
        P, K, block_u = P_is_t, topo.K_ps, 32
        amp, w, _ = channel._mac_geometry(topo.beta_is, dev)
    deltas = (1e-2 * torch.randn(U, two_n, generator=g)).to(dev)
    t = torch.as_tensor(P, dtype=torch.float32) * channel.pack_cx(deltas)
    return dict(args=(t.real.contiguous(), t.imag.contiguous(), amp, w),
                K=K, sigma_h2=topo.sigma_h2, sigma_z2=topo.sigma_z2,
                block_u=block_u)


def device_profile(runner, sc) -> dict:
    """One seed of `sc` through `runner.run_scenario`, warm, then under
    `torch.profiler`: wall ms per round from ``drive_seconds``, and the
    device ops that start inside the runner's ``SweepRunner.drive``
    range (the drive begins and ends with a device synchronize, so they
    are exactly the rounds' and evals' device work)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    runner.run_scenario(sc)                                   # warm-up
    T = sc.rounds
    wall_ms = 1e3 * runner.run_scenario(sc).exec_info["drive_seconds"] / T
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        runner.run_scenario(sc)
    events = prof.events()
    drive = [e for e in events if e.name == "SweepRunner.drive"
             and e.device_type == DeviceType.CPU]
    ops = [e for e in events if e.device_type == DeviceType.CUDA
           and e.name != "SweepRunner.drive"
           and not getattr(e, "is_user_annotation", False)]
    out = {"rounds": T, "seed": runner.seeds[0], "wall_ms_per_round": wall_ms,
           "device_ms_whole_call": sum(e.time_range.elapsed_us()
                                       for e in ops) / 1e3}
    if drive:
        lo, hi = drive[0].time_range.start, drive[0].time_range.end
        ops = [e for e in ops if lo <= e.time_range.start <= hi]
    if not drive or not ops:
        out["device_ms_per_round"] = "not measured"
        return out
    by_name = defaultdict(lambda: [0.0, 0])
    for e in ops:
        by_name[e.name][0] += e.time_range.elapsed_us() / 1e3 / T
        by_name[e.name][1] += 1
    device_ms = sum(ms for ms, _ in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:6]
    out.update(device_ms_per_round=device_ms,
               device_busy_share=device_ms / wall_ms,
               device_ops_per_round=len(ops) / T,
               top=[{"op": k[:72], "ms_per_round": ms, "calls_per_round": n / T}
                    for k, (ms, n) in top])
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this run needs a CUDA "
              "card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build, fused_mac, fused_mac_plain
    from repro_torch.sim import SweepRunner, get_scenario

    # -- phase 1: the card -------------------------------------------------
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    card = smi.splitlines()[0]
    log(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    log({"phase": "card", "kind": kind, "nvidia_smi": smi,
         "torch": torch.__version__, "cuda": torch.version.cuda,
         "python": sys.version.split()[0]})

    # -- phase 2: build ----------------------------------------------------
    t0 = time.perf_counter()
    build.load("fused_mac")
    build_s, nvcc_log = build.build_info("fused_mac")
    log({"phase": "build", "kernel": "fused_mac",
         "seconds": round(time.perf_counter() - t0, 3),
         "nvcc_seconds": round(build_s, 3),
         "ptxas": [ln.strip() for ln in nvcc_log.splitlines()
                   if "registers" in ln or "spill" in ln]})

    # -- phase 3: kernel vs plain at the main path's shapes ----------------
    seed = torch.tensor([0xC0FFEE, 42], dtype=torch.int64, device=dev)
    fig2 = get_scenario("fig2_iid").replace(total_IT=5)
    fig2_fused = fig2.replace(ota_mode="faithful", ota_backend="fused")
    u256 = get_scenario("scale_u256")
    cases = [("edge", (0, 0, 0), kernel_inputs(1, 1, 1, 64, 0, dev)),
             ("edge", (2, 3, 5), kernel_inputs(3, 5, 7, 130, 1, dev)),
             ("edge", (0, 0, 0), kernel_inputs(1, 70, 100, 1000, 2, dev))]
    for i, (sc, hop) in enumerate([(u256, "cluster"), (u256, "is_ps"),
                                   (fig2_fused, "cluster"),
                                   (fig2_fused, "is_ps")]):
        cases.append((f"{sc.name} {hop}", (0, 0, 0),
                      hop_inputs(sc, hop, 10 + i, dev)))
    max_abs = max_rel = 0.0
    for label, (rb, ub, nb), inp in cases:
        args = inp["args"]
        B, U = args[2].shape
        K, N = inp["K"], args[0].shape[1]
        kw = dict(K=K, sigma_h2=inp["sigma_h2"], sigma_z2=inp["sigma_z2"],
                  rx_base=rb, u_base=ub, n_base=nb)
        y1 = fused_mac(seed, *args, **kw)
        torch.cuda.synchronize()
        y2 = fused_mac(seed, *args, **kw)
        want = fused_mac_plain(seed, *args, block_u=inp["block_u"], **kw)
        torch.cuda.synchronize()
        same = torch.equal(y1[0], y2[0]) and torch.equal(y1[1], y2[1])
        err = max(float((y1[0] - want[0]).abs().max()),
                  float((y1[1] - want[1]).abs().max()))
        scale = float(torch.complex(*want).abs().max())
        rel = err / scale if scale > 0 else err
        max_abs, max_rel = max(max_abs, err), max(max_rel, rel)
        log({"phase": "kernel_vs_plain", "kernel": "fused_mac",
             "case": label, "shape_BUKN": [B, U, K, N],
             "bases": [rb, ub, nb], "max_abs_err": err, "max_rel_err": rel,
             "bitwise_repeat": same})
        if not (same and rel <= TOL and math.isfinite(rel)):
            raise SystemExit(f"fused_mac disagrees with its plain version "
                             f"at {label} {(B, U, K, N)}: rel {rel}, "
                             f"repeat {same}")

    # -- phase 4: the main path --------------------------------------------
    runs = [("scale_u256", u256, True), ("fig2_iid_fused", fig2_fused, True),
            ("fig2_iid", fig2, False)]
    main_launches = 0
    on_card = None
    for label, sc, fused in runs:
        fused_mac.launches = 0
        res = SweepRunner([sc], seeds=2, device="cuda",
                          keep_state=label == "scale_u256").run()[0]
        launches = fused_mac.launches
        on_card = res if label == "scale_u256" else on_card
        rounds = res.rounds[-1]
        want = 2 * rounds * len(res.seeds) if fused else 0
        metrics = [getattr(res, k) for k in ("acc", "loss", "edge_power",
                                             "is_power")]
        finite = bool(np.all(np.isfinite(np.asarray(metrics, np.float64))))
        rps = rounds / res.exec_info["drive_seconds"]
        log({"phase": "main_path", "run": label, "scenario": sc.name,
             "C": sc.C, "M": sc.M, "K": sc.K, "K_ps": sc.K_ps,
             "ota": f"{sc.ota_mode}/{sc.ota_backend}",
             "seeds": res.seeds, "rounds": rounds,
             "rounds_per_sec": rps,
             "drive_seconds": res.exec_info["drive_seconds"],
             "final_acc": [a[-1] for a in res.acc],
             "final_loss": [v[-1] for v in res.loss],
             "kernel_launches": launches, "expected_launches": want,
             "finite": finite})
        if launches != want or not finite:
            raise SystemExit(f"main path {label}: launches {launches} "
                             f"(want {want}), finite {finite}")
        main_launches += launches

    # -- phase 5: the main path's output against a reference ---------------
    t0 = time.perf_counter()
    on_cpu = SweepRunner([u256], seeds=2, device="cpu",
                         keep_state=True).run()[0]
    loss_rel = float(np.max(np.abs(np.subtract(on_card.loss, on_cpu.loss))
                            / np.abs(on_cpu.loss)))
    acc_gap = float(np.max(np.abs(np.subtract(on_card.acc, on_cpu.acc))))
    theta_rel = max(
        float((on_card.final_state["theta"][k].cpu()
               - on_cpu.final_state["theta"][k]).abs().max()
              / on_cpu.final_state["theta"][k].abs().max())
        for k in on_cpu.final_state["theta"])
    log({"phase": "reference", "scenario": u256.name,
         "what": "kernel on the card vs plain version on the CPU",
         "seeds": on_cpu.seeds, "rounds": on_cpu.rounds[-1],
         "loss_max_rel": loss_rel, "acc_max_abs": acc_gap,
         "theta_max_rel": theta_rel, "n_test": u256.n_test,
         "cpu_seconds": time.perf_counter() - t0})
    if not (loss_rel <= TOL and acc_gap <= 2.0 / u256.n_test
            and theta_rel <= THETA_RTOL):
        raise SystemExit("the card's run disagrees with the CPU reference")

    # -- phase 6: where the time goes --------------------------------------
    for label, sc, _ in runs:
        prof = device_profile(SweepRunner([sc], seeds=1, device="cuda"), sc)
        log({"phase": "profile", "run": label, "card": card, **prof})

    # -- phase 7: kernel times ---------------------------------------------
    def time_ms(fn, reps):
        fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    timings = {}
    for label, (B, U, K, N), bu in (("scale_u256", (4, 256, 16, 3925), 64),
                                    ("scale_u1024", (8, 1024, 16, 3925),
                                     128)):
        args = kernel_inputs(B, U, K, N, 7, dev)["args"]
        kw = dict(K=K, sigma_h2=1.0, sigma_z2=1.0)
        kern = lambda: fused_mac(seed, *args, **kw)
        plain = lambda: fused_mac_plain(seed, *args, block_u=bu, **kw)
        # in turns, within one process: plain, kernel, kernel, plain
        p1 = time_ms(plain, 3)
        k1 = time_ms(kern, 20)
        k2 = time_ms(kern, 20)
        p2 = time_ms(plain, 3)
        bound, bound_by = fused_mac_bound_ms(B, U, K, N)
        timings[label] = dict(ms=(k1 + k2) / 2, plain_ms=(p1 + p2) / 2,
                              bound_ms=bound, bound_by=bound_by)
        log({"phase": "times", "kernel": "fused_mac", "shape": label,
             "shape_BUKN": [B, U, K, N], "kernel_ms": [k1, k2],
             "plain_ms": [p1, p2], "bound_ms": bound, "bound_by": bound_by,
             "card": card})

    # -- phase 8: the records ----------------------------------------------
    t = timings["scale_u256"]
    log({"kernels": [{
        "name": "fused_mac", "route": "cuda",
        "source": "src/repro_torch/csrc/fused_mac.cu",
        "replaces": "src/repro/kernels/fused_mac.py:158",
        "launches": main_launches, "max_abs_err": max_abs,
        "max_rel_err": max_rel, "ms": t["ms"], "plain_ms": t["plain_ms"],
        "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
        "library_ms": None,
        "shape_BUKN": [4, 256, 16, 3925]}]})
    log({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
