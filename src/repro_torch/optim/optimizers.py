"""Parameter-tree optimizers in the optax convention, as in the JAX package.

`Optimizer` is an (init, update) pair:
    state = opt.init(params)
    updates, state = opt.update(grads, state, params, step)
    params = apply_updates(params, updates)
Trees are nested dicts of tensors (`repro_torch.tree`); every function
works leafwise, so leaves may carry leading batch dims ([U, ...] for
per-user states).  Learning rates may be floats or callables of the
step.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Union

import torch

from repro_torch.tree import tree_map

Schedule = Union[float, Callable]


def _lr(lr: Schedule, step):
    return lr(step) if callable(lr) else lr


@dataclass(frozen=True)
class Optimizer:
    init: Callable
    update: Callable  # (grads, state, params, step) -> (updates, state)


def apply_updates(params, updates):
    return tree_map(lambda p, u: p + u.to(p.dtype), params, updates)


def sgd(lr: Schedule) -> Optimizer:
    def init(params):
        return {}

    def update(grads, state, params, step):
        eta = _lr(lr, step)
        return tree_map(lambda g: -eta * g, grads), state

    return Optimizer(init, update)


def _pow(base: float, t: torch.Tensor) -> torch.Tensor:
    """float32 base ** t, as the reference's jitted round computes it.
    The base is filled on t's device: uploading it from host memory
    would make the host wait for the card on every step."""
    return torch.pow(torch.full((), base, dtype=torch.float32,
                                device=t.device), t.to(torch.float32))


def adam(lr: Schedule, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8) -> Optimizer:
    """Adam with float32 moments.  `step` is an int tensor; the bias
    correction uses ``step + 1``."""
    def init(params):
        z = lambda p: torch.zeros_like(p, dtype=torch.float32)
        return {"m": tree_map(z, params), "v": tree_map(z, params)}

    def update(grads, state, params, step):
        eta = _lr(lr, step)
        t = step + 1
        m = tree_map(lambda mm, g: b1 * mm + (1 - b1) * g, state["m"], grads)
        v = tree_map(lambda vv, g: b2 * vv + (1 - b2) * torch.square(g),
                     state["v"], grads)
        bc1 = 1 - _pow(b1, t)
        bc2 = 1 - _pow(b2, t)
        upd = tree_map(lambda mm, vv: -eta * (mm / bc1)
                       / (torch.sqrt(vv / bc2) + eps), m, v)
        return upd, {"m": m, "v": v}

    return Optimizer(init, update)
