"""End-to-end driver of the paper's Fig. 2 protocol, on the PyTorch port.

The counterpart of ``examples/whfl_mnist.py`` over `repro_torch.sim`:
the full paper setting (C=4 x M=5, K=K'=100, P_t = 1 + 1e-2 t,
P_IS = 20 P_t, sigma_z^2 = 10, normalized time IT) for one of the three
data distributions, with W-HFL at I in {1,2,4}, conventional FL and the
two error-free baselines, all seeds of a scheme through `SweepRunner`
as one vmapped program (``batch="vmap"``, the OTA kernels launched once
for all seeds).  It writes the same ``repro.sim.sweep/v1`` document.

    PYTHONPATH=src python examples/whfl_mnist_torch.py \\
        --dist iid --IT 400 --seeds 3 --out results/fig2_iid.json
    PYTHONPATH=src python examples/whfl_mnist_torch.py --device cpu \\
        --quick --ota faithful --backend slab_kernel

It runs on the CUDA card unless ``--device`` names another.  As in the
JAX driver, ``--exec sharded --mesh CxU`` runs the schemes on the
sharded engine (``--ranks gloo|nccl``: one process per shard) and
``--driver chunked`` replays each eval window as one CUDA graph
(`repro_torch.exec.make_runner`); all give the single engine's stepwise
bits.
"""
import argparse
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

from repro_torch.core.channel import BACKENDS  # noqa: E402
from repro_torch.exec import ENGINES, make_runner  # noqa: E402
from repro_torch.sim import (FIG2_FAMILIES, get_scenario,  # noqa: E402
                             sweep_to_json)
from repro_torch.sim.sweep import DRIVERS  # noqa: E402

# (display name, registry suffix): the six schemes of Fig. 2
SCHEMES = [
    ("whfl-I1", ""),
    ("whfl-I2", "_I2"),
    ("whfl-I4", "_I4"),
    ("conventional", "_conventional"),
    ("whfl-I1-errorfree", "_ideal"),
    ("conv-errorfree", "_conv_ideal"),
]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dist", default="iid", choices=sorted(FIG2_FAMILIES))
    ap.add_argument("--IT", type=int, default=400)
    ap.add_argument("--tau", type=int, default=None)
    ap.add_argument("--C", type=int, default=4)
    ap.add_argument("--M", type=int, default=5)
    ap.add_argument("--batch", type=int, default=500)
    ap.add_argument("--n-train", type=int, default=20000)
    ap.add_argument("--seed", type=int, default=0,
                    help="data/geometry seed and first training seed")
    ap.add_argument("--seeds", type=int, default=1,
                    help="training seeds per scheme (one vmapped "
                         "program; the sharded engine runs them one by "
                         "one)")
    ap.add_argument("--ota", default="equivalent",
                    choices=["equivalent", "faithful", "ideal"])
    ap.add_argument("--backend", default="",
                    choices=[""] + sorted(BACKENDS),
                    help="channel backend for the non-ideal schemes "
                         "('' = the --ota mode's default; see "
                         "repro_torch.core.channel.BACKENDS)")
    ap.add_argument("--exec", default="single", dest="exec_name",
                    choices=list(ENGINES),
                    help="execution engine (sharded runs the round as a "
                         "--mesh of shards, one after the other on the "
                         "card)")
    ap.add_argument("--mesh", default="1x1",
                    help="CxU shard mesh for --exec sharded, e.g. 4x1; "
                         "axes need not divide --C/--M (inactive users "
                         "are padded in, bit for bit the unpadded run)")
    ap.add_argument("--ranks", default=None, choices=["gloo", "nccl"],
                    help="with --exec sharded: one process per shard, "
                         "joined by this backend (gloo: the CPU or ranks "
                         "sharing one card; nccl: one card a rank)")
    ap.add_argument("--driver", default="stepwise", choices=list(DRIVERS),
                    help="round driver: stepwise (the host issues every "
                         "round) or chunked (one CUDA graph replay per "
                         "eval window; bit for bit stepwise)")
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default: the CUDA card)")
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    overrides = dict(total_IT=args.IT, C=args.C, M=args.M, batch=args.batch,
                     n_train=args.n_train, n_test=4000, data_seed=args.seed)
    if args.tau is not None:
        overrides["tau"] = args.tau

    named = []
    for name, suffix in SCHEMES:
        sc = get_scenario(FIG2_FAMILIES[args.dist] + suffix).replace(
            **overrides)
        if sc.ota_mode != "ideal":  # keep the error-free baselines ideal
            sc = sc.replace(ota_mode=args.ota, ota_backend=args.backend)
        named.append((name, sc))

    if args.ranks and args.exec_name != "sharded":
        ap.error("--ranks needs --exec sharded")
    seeds = list(range(args.seed, args.seed + args.seeds))
    try:
        runner = make_runner(args.exec_name, [sc for _, sc in named],
                             seeds=seeds, quick=args.quick, mesh=args.mesh,
                             driver=args.driver, device=args.device,
                             ranks=args.ranks)
    except (RuntimeError, ValueError) as e:   # e.g. no CUDA card and no
        ap.error(str(e))                      # --device cpu
    results = runner.run()

    doc = {"dist": args.dist, **sweep_to_json(results, quick=args.quick)}
    for (name, _), res in zip(named, results):
        fin = res.to_record()["final"]
        print(f"{name:18s} final_acc={fin['acc_mean']:.4f}"
              f"±{fin['acc_std']:.4f} "
              f"edge_power={fin['edge_power']:.4f} ({res.seconds:.0f}s)")

    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(doc, f, indent=1)
        print("wrote", args.out)
    return doc


if __name__ == "__main__":
    main()
