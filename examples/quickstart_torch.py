"""Quickstart on the PyTorch port: W-HFL in ~50 lines.

The counterpart of ``examples/quickstart.py``: the paper's single-layer
MNIST model with hierarchical over-the-air aggregation (C=2 clusters x
M=3 users, the equivalent OTA channel), against conventional
single-hop OTA FL, through `repro_torch.core.whfl.WHFLTrainer`.

    PYTHONPATH=src python examples/quickstart_torch.py
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu

It runs on the CUDA card unless ``--device`` names another.
"""
import argparse
import os
import sys

import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

from repro_torch import prng  # noqa: E402
from repro_torch.core import OTAConfig, uniform_topology  # noqa: E402
from repro_torch.core.whfl import (WHFLConfig, WHFLTrainer,  # noqa: E402
                                   accuracy)
from repro_torch.data import partition_iid, synthetic_mnist  # noqa: E402
from repro_torch.models.paper_models import (mnist_apply,  # noqa: E402
                                             mnist_init)
from repro_torch.optim import sgd  # noqa: E402


def loss_fn(params, x, y, rng):
    logits = mnist_apply(params, x)
    onehot = (y[..., None] == torch.arange(10, device=y.device)).to(
        logits.dtype)
    return -torch.mean(torch.sum(torch.log_softmax(logits, -1) * onehot, -1))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default: the CUDA card)")
    ap.add_argument("--rounds", type=int, default=25)
    args = ap.parse_args(argv)

    C, M = 2, 3
    (xtr, ytr), (xte, yte) = synthetic_mnist(0, n_train=6000, n_test=1500)
    X, Y = partition_iid(0, xtr, ytr, C, M)
    topo = uniform_topology(C=C, M=M, K=64, K_ps=64, sigma_z2=1.0,
                            d_cluster=2.5)
    out = {}
    for mode, name in [("whfl", "W-HFL (hierarchical OTA)"),
                       ("conventional", "conventional OTA FL")]:
        cfg = WHFLConfig(tau=1, I=1, batch=128, mode=mode,
                         ota=OTAConfig(mode="equivalent"))
        try:
            trainer = WHFLTrainer(loss_fn, sgd(0.1), topo, cfg, X, Y,
                                  device=args.device)
        except RuntimeError as e:     # no CUDA card and no --device cpu
            ap.error(str(e))
        dev = trainer.device
        state = trainer.init_state(mnist_init(prng.PRNGKey(0, dev)))
        key = prng.PRNGKey(1, dev)
        for _ in range(args.rounds):
            key, sub = prng.split(key)
            state = trainer.round(state, sub)
        acc = accuracy(mnist_apply, state["theta"],
                       torch.as_tensor(xte, device=dev),
                       torch.as_tensor(yte, device=dev))
        print(f"{name:32s} acc={acc:.3f} "
              f"edge_power={trainer.avg_edge_power(state):.2e}")
        out[mode] = state
    return out


if __name__ == "__main__":
    main()
