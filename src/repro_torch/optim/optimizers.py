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

from repro_torch.tree import tree_leaves, tree_map

Schedule = Union[float, Callable]


def _lr(lr: Schedule, step):
    return lr(step) if callable(lr) else lr


@dataclass(frozen=True)
class Optimizer:
    init: Callable
    update: Callable  # (grads, state, params, step) -> (updates, state)


def apply_updates(params, updates):
    return tree_map(lambda p, u: p + u.to(p.dtype), params, updates)


def global_norm(tree) -> torch.Tensor:
    """The float32 l2 norm of all leaves together."""
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for _, x in tree_leaves(tree)))


def clip_by_global_norm(tree, max_norm: float):
    """(tree scaled by min(1, max_norm / (norm + 1e-9)), norm)."""
    n = global_norm(tree)
    scale = torch.clamp_max(max_norm / (n + 1e-9), 1.0)
    return tree_map(lambda x: x * scale.to(x.dtype), tree), n


def sgd(lr: Schedule) -> Optimizer:
    def init(params):
        return {}

    def update(grads, state, params, step):
        eta = _lr(lr, step)
        return tree_map(lambda g: -eta * g, grads), state

    return Optimizer(init, update)


def momentum(lr: Schedule, beta: float = 0.9) -> Optimizer:
    """Heavy-ball momentum; the state is the velocity tree."""
    def init(params):
        return tree_map(torch.zeros_like, params)

    def update(grads, m, params, step):
        eta = _lr(lr, step)
        m = tree_map(lambda mm, g: beta * mm + g, m, grads)
        return tree_map(lambda mm: -eta * mm, m), m

    return Optimizer(init, update)


def _pow(base: float, t: torch.Tensor) -> torch.Tensor:
    """float32 base ** t, as the reference's jitted round computes it.
    The base is filled on t's device: uploading it from host memory
    would make the host wait for the card on every step."""
    return torch.pow(torch.full((), base, dtype=torch.float32,
                                device=t.device), t.to(torch.float32))


def adam(lr: Schedule, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8, moment_dtype=torch.float32) -> Optimizer:
    """Adam.  `step` is an int tensor; the bias correction uses
    ``step + 1``.  The moments are stored in `moment_dtype` (bfloat16
    halves the optimizer's memory); the update's arithmetic is float32."""
    def init(params):
        z = lambda p: torch.zeros_like(p, dtype=moment_dtype)
        return {"m": tree_map(z, params), "v": tree_map(z, params)}

    def update(grads, state, params, step):
        eta = _lr(lr, step)
        t = step + 1
        m = tree_map(lambda mm, g: (b1 * mm.float() + (1 - b1) * g.float()
                                    ).to(moment_dtype), state["m"], grads)
        v = tree_map(lambda vv, g: (b2 * vv.float() + (1 - b2)
                                    * torch.square(g.float())
                                    ).to(moment_dtype), state["v"], grads)
        bc1 = 1 - _pow(b1, t)
        bc2 = 1 - _pow(b2, t)
        upd = tree_map(lambda mm, vv: -eta * (mm.float() / bc1)
                       / (torch.sqrt(vv.float() / bc2) + eps), m, v)
        return upd, {"m": m, "v": v}

    return Optimizer(init, update)


def adamw(lr: Schedule, b1: float = 0.9, b2: float = 0.95,
          eps: float = 1e-8, weight_decay: float = 0.0,
          moment_dtype=torch.float32) -> Optimizer:
    """Adam with decoupled weight decay: Adam's update less
    ``lr * weight_decay * params``."""
    base = adam(lr, b1, b2, eps, moment_dtype=moment_dtype)

    def update(grads, state, params, step):
        upd, state2 = base.update(grads, state, params, step)
        if weight_decay:
            eta = _lr(lr, step)
            upd = tree_map(lambda u, p: u - eta * weight_decay * p.float(),
                           upd, params)
        return upd, state2

    return Optimizer(base.init, update)
