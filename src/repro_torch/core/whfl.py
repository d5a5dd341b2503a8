"""W-HFL federated round (paper §II-III protocol, Mode A: paper scale).

Per global round t:
  - every MU (c,m) runs `tau` local optimizer steps from its cluster
    model theta_IS[c]  (eq. 2),
  - each cluster OTA-aggregates the MU deltas at its IS (eqs. 8-13),
    repeated for `I` cluster iterations,
  - ISs OTA-transmit their accumulated deltas to the PS, which closes
    the round (eqs. 15-18).

`make_round_fn` builds the per-round function ``round_fn(state, key,
P_t, P_is_t) -> state``.  Local training runs batched over all C*M users
in one pass (`torch.func.vmap` of `torch.func.grad`), with every user's
minibatch indices drawn at once by the batched `jax.random` emulation,
so a seed reproduces the JAX package's round: keys split in the same
order, the same users draw the same indices, and the OTA hops get the
same keys.  Baselines: ``mode="conventional"`` (single-hop OTA FL) and
``OTAConfig(mode="ideal")`` (error-free).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable

import torch

from repro_torch import prng
from repro_torch.core import aggregation as agg
from repro_torch.core.channel import (OTAConfig, cluster_ota,
                                      conventional_ota, global_ota)
from repro_torch.core.topology import Topology
from repro_torch.optim import Optimizer, apply_updates
from repro_torch.tree import tree_leaves, tree_map

MODES = ("whfl", "conventional")


@dataclass(frozen=True)
class WHFLConfig:
    tau: int = 1                 # local (user) iterations per cluster round
    I: int = 1                   # cluster iterations per global round
    batch: int = 500
    mode: str = "whfl"           # "whfl" | "conventional"
    ota: OTAConfig = field(default_factory=OTAConfig)
    power_base: float = 1.0
    power_slope: float = 1e-2
    power_is_factor: float = 20.0
    power_low: bool = False      # P_t,low = 0.5 P_t (paper's I=1 runs)


def init_round_state(params, opt: Optimizer, C: int, M: int):
    """Fresh per-run round state: the global model, per-user optimizer
    state ``[C, M, ...]`` (carried across rounds), the round index and
    the transmit-power accumulators."""
    dev = next(tree_leaves(params))[1].device
    opt_state = tree_map(lambda x: x.expand(C, M, *x.shape).clone(),
                         opt.init(params))
    zero = torch.zeros((), device=dev)
    return {
        "theta": params,
        "opt": opt_state,
        "t": torch.zeros((), dtype=torch.int32, device=dev),
        "power_edge": zero.clone(),   # sum of per-symbol tx power, edge
        "power_is": zero.clone(),     # same, IS->PS hop
        "n_edge_tx": zero.clone(),    # transmissions counted
        "n_is_tx": zero.clone(),
    }


def make_local_train(loss_fn: Callable, opt: Optimizer,
                     cfg: WHFLConfig) -> Callable:
    """Build the batched local-training step ``local_train(theta,
    opt_state, X, Y, keys, step) -> (delta, opt_state)``: every user
    takes `cfg.tau` optimizer steps from its own `theta` on its own
    shard and returns the model difference (eq. 2).

    theta and opt_state carry a leading user axis [U, ...]; X [U, n,
    ...], Y [U, n]; keys [U, 2].  Per step each user splits its key into
    (kb, kd) and draws `cfg.batch` indices from kb, as the reference's
    per-user program does.
    """
    grad_fn = torch.func.vmap(torch.func.grad(loss_fn))

    def local_train(theta, opt_state, X, Y, keys, step):
        users = torch.arange(X.shape[0], device=X.device)[:, None]
        th, st = theta, opt_state
        step_keys = prng.split(keys, cfg.tau)                 # [U, tau, 2]
        for i in range(cfg.tau):
            kb, kd = prng.split(step_keys[:, i]).unbind(-2)
            idx = prng.randint(kb, (cfg.batch,), 0, X.shape[1])
            grads = grad_fn(th, X[users, idx], Y[users, idx], kd)
            upd, st = opt.update(grads, st, th, step)
            th = apply_updates(th, upd)
        return tree_map(lambda a, b: a - b, th, theta), st

    return local_train


def make_round_fn(loss_fn: Callable, opt: Optimizer, topo: Topology,
                  cfg: WHFLConfig, spec: agg.FlatSpec, X: torch.Tensor,
                  Y: torch.Tensor) -> Callable:
    """Build the per-round function ``round_fn(state, key, P_t, P_is_t)
    -> state``.

    X [C, M, n, ...] and Y [C, M, n] are the users' shards on the run's
    device.  P_t and P_is_t enter as float32 scalars, as they enter the
    reference's jitted round.
    """
    if cfg.mode not in MODES:
        raise ValueError(f"unknown mode {cfg.mode!r}; known: "
                         f"{', '.join(MODES)}")
    C, M = topo.C, topo.M
    U = C * M
    Xu = X.reshape(U, *X.shape[2:])
    Yu = Y.reshape(U, *Y.shape[2:])
    local_train = make_local_train(loss_fn, opt, cfg)

    def users_train(theta_IS, opt_state, key, step):
        """theta_IS: [C]-stacked cluster models -> flat deltas [C,M,2N]."""
        keys = prng.split(key, U)
        th_u = tree_map(lambda x: x[:, None].expand(C, M, *x.shape[1:])
                        .reshape(U, *x.shape[1:]), theta_IS)
        st_u = tree_map(lambda x: x.reshape(U, *x.shape[2:]), opt_state)
        deltas, st_u = local_train(th_u, st_u, Xu, Yu, keys, step)
        flat = agg.flatten(spec, deltas).reshape(C, M, -1)
        return flat, tree_map(lambda x: x.reshape(C, M, *x.shape[1:]), st_u)

    def round_fn(state, key, P_t, P_is_t):
        P_t = torch.as_tensor(P_t, dtype=torch.float32)
        P_is_t = torch.as_tensor(P_is_t, dtype=torch.float32)
        theta = state["theta"]
        step = state["t"]
        theta_IS = tree_map(lambda x: x.expand(C, *x.shape), theta)

        if cfg.mode == "conventional":
            k1, k2 = prng.split(key)
            flat, opt_state = users_train(theta_IS, state["opt"], k1, step)
            est = conventional_ota(k2, flat, topo, P_t, cfg.ota)
            return {**state, "theta": apply_updates(
                        theta, agg.unflatten(spec, est)),
                    "opt": opt_state, "t": step + 1,
                    "power_edge": state["power_edge"]
                    + agg.symbol_power(flat, P_t),
                    "n_edge_tx": state["n_edge_tx"] + 1.0}

        # --- W-HFL ---
        keys = prng.split(key, cfg.I + 1)
        opt_state = state["opt"]
        p_edge = torch.zeros((), device=step.device)
        for i in range(cfg.I):
            k1, k2 = prng.split(keys[i])
            flat, opt_state = users_train(theta_IS, opt_state, k1, step)
            est = cluster_ota(k2, flat, topo, P_t, cfg.ota)     # [C, 2N]
            theta_IS = apply_updates(theta_IS, agg.unflatten(spec, est))
            p_edge = p_edge + agg.symbol_power(flat, P_t)

        is_deltas = agg.flatten(
            spec, tree_map(lambda a, b: a - b, theta_IS, theta))
        est = global_ota(keys[-1], is_deltas, topo, P_is_t, cfg.ota)
        return {**state,
                "theta": apply_updates(theta, agg.unflatten(spec, est)),
                "opt": opt_state, "t": step + 1,
                "power_edge": state["power_edge"] + p_edge,
                "n_edge_tx": state["n_edge_tx"] + float(cfg.I),
                "power_is": state["power_is"]
                + agg.symbol_power(is_deltas, P_is_t),
                "n_is_tx": state["n_is_tx"] + 1.0}

    return round_fn


def eval_windows(T: int, eval_every: int) -> list:
    """Partition ``T`` rounds into the stepwise driver's eval windows:
    an eval follows round ``t`` whenever ``t % eval_every == 0 or
    t == T - 1``; the list holds the rounds between consecutive eval
    points (summing to T)."""
    e = max(1, int(eval_every))
    out, prev = [], -1
    for t in range(T):
        if t % e == 0 or t == T - 1:
            out.append(t - prev)
            prev = t
    return out


@torch.no_grad()
def accuracy(apply_fn, params, X: torch.Tensor, Y: torch.Tensor,
             batch: int = 2000) -> float:
    """Top-1 accuracy of `apply_fn(params, .)` over (X, Y), in batches."""
    n = len(X)
    if n == 0:
        return 0.0
    correct = 0
    for i in range(0, n, batch):
        logits = apply_fn(params, X[i:i + batch])
        correct += int((logits.argmax(-1) == Y[i:i + batch]).sum())
    return correct / n
