"""Federated LM pre-training with W-HFL on the PyTorch port: the
counterpart of ``examples/lm_federated.py``.

Trains a small GQA transformer (~5M parameters by default) on the
synthetic Markov corpus with `repro_torch.launch.train.build_train_step`
(the structural two-hop OTA aggregation) or, with ``--fused``,
`build_fused_train_step`.  The JAX example gives its host 8 fake
devices for 2 clusters x 2 users x 2-way model parallel; the port runs
every user on one device, or, with ``--ranks N`` (N = clusters x
users x ``--model``), one process per user (`repro_torch.launch.ranks`):
the hops as collectives over each rank's user and cluster groups,
through NCCL (one rank a card) or gloo (ranks on the CPU, or sharing one
card).  On ranks, ``--model 2`` splits each user's model over 2 of them
(tensor parallelism), ``--fsdp`` the parameters over the users' ranks
and ``--zero1`` AdamW's moments over them.  At ``--model 4`` the
model's 4 heads split beside its 2 KV heads replicated; ``--heads 6``
(which do not divide) replicates the attention, and ``--seq-shard``
splits its query rows over the model's ranks instead ("q_seq").

    PYTHONPATH=src python examples/lm_federated_torch.py --steps 50
    PYTHONPATH=src python examples/lm_federated_torch.py --device cpu \\
        --steps 3 --seq 64 --layers 2 --d-model 64
    PYTHONPATH=src python examples/lm_federated_torch.py --device cpu \\
        --steps 3 --seq 64 --layers 2 --d-model 64 --ranks 4 --backend gloo
    PYTHONPATH=src python examples/lm_federated_torch.py --device cpu \
        --steps 3 --seq 64 --layers 2 --d-model 64 --ranks 8 --backend gloo \
        --model 2 --fsdp --zero1
    PYTHONPATH=src python examples/lm_federated_torch.py --device cpu \
        --steps 3 --seq 64 --layers 2 --d-model 64 --clusters 1 --users 2 \
        --ranks 8 --backend gloo --model 4 --heads 6 --seq-shard
"""
import argparse
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

from repro_torch import prng  # noqa: E402
from repro_torch.checkpoint import save_step  # noqa: E402
from repro_torch.configs.base import ArchConfig, InputShape  # noqa: E402
from repro_torch.core.dist import OTADistConfig, uniform_geom  # noqa: E402
from repro_torch.data import lm_corpus  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.launch import ranks  # noqa: E402
from repro_torch.launch.train import (TrainConfig,  # noqa: E402
                                      build_fused_train_step,
                                      build_train_step)
from repro_torch.tree import tree_leaves  # noqa: E402


def batches(tokens, B, L, dev, seed=0):
    rng = np.random.default_rng(seed)
    n = len(tokens) - L - 1
    while True:
        idx = rng.integers(0, n, B)
        x = np.stack([tokens[i:i + L] for i in idx])
        y = np.stack([tokens[i + 1:i + L + 1] for i in idx])
        yield {"tokens": torch.as_tensor(x, device=dev),
               "labels": torch.as_tensor(y, device=dev)}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--clusters", type=int, default=2)
    ap.add_argument("--users", type=int, default=2,
                    help="users per cluster")
    ap.add_argument("--tau", type=int, default=1)
    ap.add_argument("--I", type=int, default=1)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--d-model", type=int, default=256)
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--vocab", type=int, default=8192)
    ap.add_argument("--ota", default="equivalent",
                    choices=["equivalent", "ideal"])
    ap.add_argument("--fused", action="store_true",
                    help="build_fused_train_step (needs tau = I = 1)")
    ap.add_argument("--ranks", type=int, default=0,
                    help="one process per user (clusters x users of "
                    "them); 0: every user on one device")
    ap.add_argument("--model", type=int, default=1,
                    help="ranks a user's model is split over (tensor "
                    "parallelism; with --ranks)")
    ap.add_argument("--heads", type=int, default=4,
                    help="query heads (over 2 KV heads, of d_model / 4 "
                    "each)")
    ap.add_argument("--seq-shard", action="store_true",
                    help="where the heads do not divide over --model, "
                    "split the attention's query rows over its ranks "
                    "(seq_shard_attn)")
    ap.add_argument("--fsdp", action="store_true",
                    help="the parameters split over the users' ranks")
    ap.add_argument("--zero1", action="store_true",
                    help="AdamW's moments split over the users' ranks")
    ap.add_argument("--backend", default="nccl", choices=["nccl", "gloo"],
                    help="the ranks' process group: nccl, one rank a "
                    "card; gloo, ranks on the CPU or sharing one card")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default: the CUDA card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    C, M = args.clusters, args.users
    print(f"device={dev} clusters={C} users/cluster={M}")

    cfg = ArchConfig(
        name="lm-small", family="dense", source="example",
        n_layers=args.layers, d_model=args.d_model, n_heads=args.heads,
        n_kv_heads=2, head_dim=args.d_model // 4, d_ff=4 * args.d_model,
        vocab=args.vocab, q_block=128, remat=False,
        seq_shard_attn=args.seq_shard)
    shape = InputShape("example", args.seq, args.batch, "train")
    # quiet radio for the demo: 1024 rx antennas, low noise floor (the
    # channel-noise/gradient SNR trade is explored in tests/benchmarks)
    geom = uniform_geom(C=C, M=M, K=1024, K_ps=1024, sigma_z2=1e-4)
    local = args.tau * args.I == 1
    tcfg = TrainConfig(tau=args.tau, I=args.I, users_per_cluster=M,
                       eta_local=1.0 if local else 5e-3,
                       outer="adamw" if local else "add",
                       outer_lr=3e-4, geom=geom, fsdp=args.fsdp,
                       zero1=args.zero1, ota=OTADistConfig(mode=args.ota))
    if args.ranks:
        return on_ranks(args, cfg, shape, tcfg)
    build = build_fused_train_step if args.fused else build_train_step
    step, init_fn = build(cfg, shape, {"data": C * M}, tcfg, device=dev)
    state, _ = init_fn(prng.PRNGKey(0))
    n_params = sum(t.numel() for _, t in tree_leaves(state["params"]))
    print(f"params: {n_params / 1e6:.1f}M")

    toks = lm_corpus(0, n_tokens=500_000, vocab=args.vocab)
    it = batches(toks, args.batch, args.seq, dev)
    t0 = time.time()
    for i in range(args.steps):
        state, m = step(state, next(it), prng.PRNGKey(i))
        if i % 10 == 0 or i == args.steps - 1:
            print(f"step {i:4d} loss={float(m['loss']):.4f} "
                  f"edge_power={float(m['edge_power']):.2e} "
                  f"({(time.time() - t0) / (i + 1):.2f}s/step)")
        if args.ckpt_dir and ((i + 1) % 100 == 0 or i == args.steps - 1):
            save_step(args.ckpt_dir, i + 1, state["params"])
    print(f"done: {args.steps} steps in {time.time() - t0:.0f}s")


def on_ranks(args, cfg, shape, tcfg):
    """The run with one process per user and model shard:
    `ranks.train_worker` on (pod, cluster, user, model) = (1, clusters,
    users, model), each rank cutting its own rows of every step's
    global batch."""
    world = args.clusters * args.users * args.model
    if args.ranks != world:
        raise SystemExit(f"--ranks {args.ranks}: need clusters x users x "
                         f"model = {world}")
    if args.ckpt_dir:
        raise SystemExit("--ckpt-dir saves from one device; drop --ranks")
    toks = lm_corpus(0, n_tokens=500_000, vocab=args.vocab)
    it = batches(toks, args.batch, args.seq, "cpu")
    spec = dict(cfg=cfg, shape=shape, tcfg=tcfg, fused=args.fused,
                mesh=(1, args.clusters, args.users, args.model),
                batches=[next(it) for _ in range(args.steps)],
                keys=list(range(args.steps)), log_every=10,
                device="cpu" if args.device == "cpu" else None)
    t0 = time.time()
    res = ranks.launch(ranks.train_worker, args.ranks, args.backend, spec)
    for r in res:
        print(f"rank {r['rank']} {r['coordinate']} on {r['device']}: "
              f"{sum(r['step_seconds']) / args.steps:.2f} s/step, "
              f"{sum(r['collective_seconds']) / args.steps:.2f} s/step in "
              f"collectives ({r['backend']})")
    print(f"done: {args.steps} steps on {args.ranks} ranks in "
          f"{time.time() - t0:.0f}s")


if __name__ == "__main__":
    main()
