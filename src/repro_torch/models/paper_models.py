"""The paper's §V experiment models.

- MNIST: single-layer network, 784 -> 10 (2N = 7850 params incl. bias).
- CIFAR-10: the CNN is not ported yet (ROADMAP queue A, item 4); its
  entry points raise.

Parameters are plain dicts of tensors with the JAX package's leaf names
and layouts, initialized from the `jax.random` emulation so one seed
gives the reference's weights.
"""
from __future__ import annotations

import math

import torch

from repro_torch import prng


def mnist_init(key: torch.Tensor):
    """{"w": [784, 10], "b": [10]} on the key's device."""
    kw, = prng.split(key, 1)
    w = prng.normal(kw, (784, 10)) / math.sqrt(784.0)
    return {"w": w, "b": torch.zeros((10,), device=key.device)}


def mnist_apply(params, x: torch.Tensor, *, train: bool = False,
                rng=None) -> torch.Tensor:
    """x: [B, 784] -> logits [B, 10]."""
    return x @ params["w"] + params["b"]


def _cifar_not_ported(*args, **kwargs):
    raise NotImplementedError(
        "the CIFAR CNN is not ported yet (ROADMAP queue A, item 4: task "
        "layer, with the fig3 scenarios)")


cifar_init = cifar_apply = _cifar_not_ported
