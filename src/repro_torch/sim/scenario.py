"""Scenario specs + the registry of named paper scenarios.

The same registry as the JAX package's `repro.sim.scenario`: every
`Scenario` field and every registered name is identical, so
`Scenario.to_json()` is the reference's document.  A `Scenario` pins the
task (dataset/model/loss), the federated data partition, the network
topology, the W-HFL protocol config (tau, I, mode) and the OTA channel
mode.  Seeds are not part of a scenario: the sweep supplies them (model
init + minibatch sampling + channel noise follow the per-seed key;
geometry and the data partition follow `data_seed`).

Scenarios whose features the port has not reached yet (the CIFAR model,
partial participation, robust folds, telemetry) are registered all the
same; building their round raises and names the ROADMAP item.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, Tuple

import torch

from repro_torch.core import OTAConfig, random_topology, uniform_topology
from repro_torch.core.topology import Topology
from repro_torch.core.whfl import WHFLConfig
from repro_torch.data import get_partitioner, synthetic_cifar, synthetic_mnist
from repro_torch.models.paper_models import (cifar_apply, cifar_init,
                                             mnist_apply, mnist_init)


def _xent(apply_fn):
    """Mean softmax cross-entropy over 10 classes (vmap-safe one-hot)."""
    def loss(params, x, y, rng):
        logits = apply_fn(params, x)
        onehot = (y[..., None] == torch.arange(10, device=y.device)).to(
            logits.dtype)
        return -torch.mean(torch.sum(torch.log_softmax(logits, -1) * onehot,
                                     -1))
    return loss


# dataset -> (init_fn, apply_fn, loss_fn, make_data)
TASKS: Dict[str, Tuple] = {
    "mnist": (mnist_init, mnist_apply, _xent(mnist_apply), synthetic_mnist),
    "cifar": (cifar_init, cifar_apply, _xent(cifar_apply), synthetic_cifar),
}


@dataclass(frozen=True)
class Scenario:
    name: str
    dataset: str = "mnist"           # key into TASKS
    partition: str = "iid"           # key into data.PARTITIONERS
    # protocol
    tau: int = 1
    I: int = 1
    batch: int = 500
    mode: str = "whfl"               # "whfl" | "conventional"
    ota_mode: str = "equivalent"     # "equivalent" | "faithful" | "ideal"
    ota_backend: str = ""            # channel backend ("" = mode default;
    #                                  see core.channel.BACKENDS)
    # topology (paper §V defaults)
    topology: str = "random"         # "random" | "uniform"
    C: int = 4
    M: int = 5
    K: int = 100
    K_ps: int = 100
    sigma_z2: float = 10.0
    # training schedule
    total_IT: int = 400              # normalized time; rounds T = IT / I
    lr: float = 5e-2
    opt: str = "adam"                # "adam" | "sgd"
    n_train: int = 20000
    n_test: int = 2000
    data_seed: int = 0               # partition + geometry seed
    eval_every: int = 1
    # participation & robustness; the defaults are the paper's
    # full-attendance mean, the only setting the port runs so far
    participation: str = "full"      # "full" | "bernoulli" | "stragglers"
    participation_rate: float = 1.0  # bernoulli attendance probability
    participation_seed: int = 17
    straggler_every: int = 4
    straggler_frac: float = 0.25
    n_byzantine: int = 0             # per-cluster byzantine tail users
    byzantine_scale: float = 1.0
    n_free_riders: int = 0
    cluster_agg: str = "mean"        # "mean" | "median" | "trimmed_mean"
    agg_trim: float = 0.25
    # in-program diagnostics (not ported yet: must stay False)
    telemetry: bool = False

    # -- derived ------------------------------------------------------------

    @property
    def rounds(self) -> int:
        return max(1, self.total_IT // self.I)

    def whfl_config(self) -> WHFLConfig:
        """The round config; raises for features not ported yet."""
        if (self.participation != "full" or self.n_byzantine
                or self.n_free_riders):
            raise NotImplementedError(
                f"{self.name}: partial participation is not ported yet "
                f"(ROADMAP queue A, item 7)")
        if self.cluster_agg != "mean":
            raise NotImplementedError(
                f"{self.name}: robust cluster folds are not ported yet "
                f"(ROADMAP queue A, item 7)")
        if self.telemetry:
            raise NotImplementedError(
                f"{self.name}: telemetry is not ported yet "
                f"(ROADMAP queue A, item 9)")
        return WHFLConfig(tau=self.tau, I=self.I, batch=self.batch,
                          mode=self.mode,
                          ota=OTAConfig(mode=self.ota_mode,
                                        backend=self.ota_backend),
                          power_low=(self.I == 1))

    def make_topology(self) -> Topology:
        if self.topology == "uniform":
            return uniform_topology(C=self.C, M=self.M, K=self.K,
                                    K_ps=self.K_ps, sigma_z2=self.sigma_z2)
        return random_topology(self.data_seed, C=self.C, M=self.M, K=self.K,
                               K_ps=self.K_ps, sigma_z2=self.sigma_z2)

    def make_data(self):
        """-> (X [C,M,n,...], Y [C,M,n], xte, yte)."""
        _, _, _, data_fn = TASKS[self.dataset]
        (xtr, ytr), (xte, yte) = data_fn(self.data_seed,
                                         n_train=self.n_train,
                                         n_test=self.n_test)
        X, Y = get_partitioner(self.partition)(self.data_seed, xtr, ytr,
                                               self.C, self.M)
        return X, Y, xte, yte

    def task_fns(self):
        init_fn, apply_fn, loss_fn, _ = TASKS[self.dataset]
        return init_fn, apply_fn, loss_fn

    def replace(self, **kw) -> "Scenario":
        return dataclasses.replace(self, **kw)

    def quick(self) -> "Scenario":
        """CI-sized variant: same structure, minutes -> seconds."""
        kw = dict(total_IT=8 * self.I, n_train=1200, n_test=400,
                  batch=min(self.batch, 64), C=min(self.C, 2),
                  M=min(self.M, 2), K=min(self.K, 16),
                  K_ps=min(self.K_ps, 16), eval_every=2)
        if self.dataset == "cifar":
            kw.update(tau=min(self.tau, 2), n_train=800)
        return self.replace(**kw)

    def to_json(self) -> Dict:
        return dataclasses.asdict(self)


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

SCENARIOS: Dict[str, Scenario] = {}


def register_scenario(sc: Scenario, overwrite: bool = False) -> Scenario:
    if sc.name in SCENARIOS and not overwrite:
        raise ValueError(f"scenario {sc.name!r} already registered")
    SCENARIOS[sc.name] = sc
    return sc


def get_scenario(name: str) -> Scenario:
    try:
        return SCENARIOS[name]
    except KeyError:
        raise KeyError(f"unknown scenario {name!r}; known: "
                       f"{', '.join(sorted(SCENARIOS))}") from None


def list_scenarios() -> Dict[str, Scenario]:
    return dict(SCENARIOS)


def _register_family(base: Scenario, cluster_iters=(1, 2, 4),
                     baselines: bool = True) -> None:
    """The paper's per-figure scheme family: W-HFL at I in {1,2,4} plus
    the conventional single-hop and error-free baselines."""
    for I in cluster_iters:
        name = base.name if I == 1 else f"{base.name}_I{I}"
        register_scenario(base.replace(name=name, I=I))
    if baselines:
        register_scenario(base.replace(name=f"{base.name}_conventional",
                                       I=1, mode="conventional"))
        register_scenario(base.replace(name=f"{base.name}_ideal", I=1,
                                       ota_mode="ideal"))
        register_scenario(base.replace(
            name=f"{base.name}_conv_ideal", I=1, mode="conventional",
            ota_mode="ideal"))


# Fig. 2 — MNIST single-layer net, three data distributions.  Public
# mapping from the paper's distribution names to the scenario family
# base name (used by benchmarks/fig2_mnist.py and examples/).
FIG2_FAMILIES = {
    "iid": "fig2_iid",
    "noniid": "fig2_noniid",
    "cluster-noniid": "fig2_cluster_noniid",
}

_register_family(Scenario(name="fig2_iid", dataset="mnist",
                          partition="iid", tau=1, sigma_z2=10.0))
_register_family(Scenario(name="fig2_noniid", dataset="mnist",
                          partition="noniid", tau=3, sigma_z2=10.0))
_register_family(Scenario(name="fig2_cluster_noniid", dataset="mnist",
                          partition="cluster-noniid", tau=1, sigma_z2=10.0))

# Fig. 3 — CIFAR CNN, i.i.d., tau=5.
_register_family(Scenario(name="fig3_cifar", dataset="cifar",
                          partition="iid", tau=5, batch=128, lr=1e-3,
                          sigma_z2=1.0, n_test=1000),
                 baselines=True)

# Participation & robustness family — the Fig. 2 i.i.d. condition under
# realistic attendance (per-round Bernoulli dropout, periodic
# stragglers) and adversarial behavior (sign-flipping byzantine users),
# with optional robust cluster folds (the `_median` companions).
PARTICIPATION_FAMILIES = ("fig2_drop10", "fig2_drop50", "fig2_straggler",
                          "fig2_byzantine1", "fig2_byzantine3",
                          "fig2_byzantine1_median",
                          "fig2_byzantine3_median")

_fig2_part = Scenario(name="fig2_iid", dataset="mnist", partition="iid",
                      tau=1, sigma_z2=10.0)
register_scenario(_fig2_part.replace(
    name="fig2_drop10", participation="bernoulli",
    participation_rate=0.9))
register_scenario(_fig2_part.replace(
    name="fig2_drop50", participation="bernoulli",
    participation_rate=0.5))
register_scenario(_fig2_part.replace(
    name="fig2_straggler", participation="stragglers",
    straggler_frac=0.4, straggler_every=4))
for _nb in (1, 3):
    register_scenario(_fig2_part.replace(
        name=f"fig2_byzantine{_nb}", n_byzantine=_nb,
        byzantine_scale=2.0))
    register_scenario(_fig2_part.replace(
        name=f"fig2_byzantine{_nb}_median", n_byzantine=_nb,
        byzantine_scale=2.0, cluster_agg="median"))

# Scale family — beyond-paper user counts through the fused channel
# backend (channels generated inside the kernel; no [U, K, N] slab, so
# these run even where the slab/reference paths would exhaust memory).
# Deliberately tiny on every axis that is not U: the point is the OTA
# hop at U = C*M users, not convergence.
SCALE_FAMILIES = ("scale_u256", "scale_u256_bench", "scale_u1024",
                  "scale_u4096", "scale_u16384", "scale_u65536")

for _U, _C, _M in ((256, 4, 64), (1024, 8, 128), (4096, 16, 256)):
    register_scenario(Scenario(
        name=f"scale_u{_U}", dataset="mnist", partition="iid",
        tau=1, I=1, batch=16, mode="whfl", ota_mode="faithful",
        ota_backend="fused", C=_C, M=_M, K=16, K_ps=16, sigma_z2=1.0,
        total_IT=2, lr=5e-2, opt="sgd", n_train=4 * _U, n_test=512,
        eval_every=1))

# Driver-benchmark member of the scale family (equivalent backend,
# T=48, eval_every=8).
register_scenario(Scenario(
    name="scale_u256_bench", dataset="mnist", partition="iid",
    tau=1, I=1, batch=8, mode="whfl", ota_mode="equivalent",
    C=4, M=64, K=16, K_ps=16, sigma_z2=1.0,
    total_IT=48, lr=5e-2, opt="sgd", n_train=1024, n_test=256,
    eval_every=8))

# Sharded-engine tiers of the reference (the port's sharded engine is
# ROADMAP queue A, item 11).
register_scenario(Scenario(
    name="scale_u16384", dataset="mnist", partition="iid",
    tau=1, I=1, batch=8, mode="whfl", ota_mode="faithful",
    ota_backend="fused", C=16, M=1024, K=4, K_ps=4, sigma_z2=1.0,
    total_IT=1, lr=5e-2, opt="sgd", n_train=2 * 16384, n_test=128,
    eval_every=1))

register_scenario(Scenario(
    name="scale_u65536", dataset="mnist", partition="iid",
    tau=1, I=1, batch=8, mode="whfl", ota_mode="faithful",
    ota_backend="fused", C=16, M=4096, K=4, K_ps=4, sigma_z2=1.0,
    total_IT=1, lr=5e-2, opt="sgd", n_train=2 * 65536, n_test=128,
    eval_every=1))
