"""The paper's §V experiment models.

- MNIST: single-layer network, 784 -> 10 (2N = 7850 params incl. bias).
- CIFAR-10: CNN with conv pairs 32/64/128 (3x3, same padding) + BN + ReLU,
  2x2 max-pool + dropout after each pair, FC softmax head.  2N = 308,394:
  the flat vector holds every leaf, the 896 batch-norm scales and biases
  included (N = 154,197 complex symbols per OTA hop).

Parameters are plain dicts (and, for the CNN's convolutions, a list) of
tensors with the JAX package's leaf names and layouts: conv weights are
HWIO ``[3, 3, cin, cout]`` and inputs NHWC, as there.  `cifar_apply`
computes in NCHW on views of them and permutes back to NHWC before the
FC layer, so ``fc_w``'s rows meet the features in the reference's
(h, w, c) order.  Weights come from the `jax.random` emulation, so one
seed gives the reference's weights.
"""
from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

from repro_torch import prng
from repro_torch.tree import tree_leaves


def mnist_init(key: torch.Tensor):
    """{"w": [784, 10], "b": [10]} on the key's device."""
    kw, = prng.split(key, 1)
    w = prng.normal(kw, (784, 10)) / math.sqrt(784.0)
    return {"w": w, "b": torch.zeros((10,), device=key.device)}


def mnist_apply(params, x: torch.Tensor, *, train: bool = False,
                rng=None) -> torch.Tensor:
    """x: [B, 784] -> logits [B, 10]."""
    return x @ params["w"] + params["b"]


# --- CIFAR-10 CNN -------------------------------------------------------------

_CHANNELS = [(3, 32), (32, 32), (32, 64), (64, 64), (64, 128), (128, 128)]
_DROPOUT = [0.2, 0.3, 0.4]
_SIDE = 32                      # input height and width


def _conv_init(key: torch.Tensor, cin: int, cout: int):
    k1, = prng.split(key, 1)
    fan_in = 3 * 3 * cin
    dev = key.device
    return {
        "w": prng.normal(k1, (3, 3, cin, cout)) * math.sqrt(2.0 / fan_in),
        "b": torch.zeros((cout,), device=dev),
        # batch norm over batch statistics, scale and bias learned
        "bn_scale": torch.ones((cout,), device=dev),
        "bn_bias": torch.zeros((cout,), device=dev),
    }


def cifar_init(key: torch.Tensor):
    """{"conv": [6 x {"w", "b", "bn_scale", "bn_bias"}], "fc_w": [2048,
    10], "fc_b": [10]} on the key's device."""
    keys = prng.split(key, len(_CHANNELS) + 1)
    p = {"conv": [_conv_init(k, ci, co)
                  for k, (ci, co) in zip(keys[:-1], _CHANNELS)]}
    d_fc = 4 * 4 * 128          # after three 2x2 pools: 32 -> 4
    p["fc_w"] = prng.normal(keys[-1], (d_fc, 10)) / math.sqrt(d_fc)
    p["fc_b"] = torch.zeros((10,), device=key.device)
    return p


def dropout_shapes(batch: int) -> Tuple[Tuple[int, ...], ...]:
    """The NHWC shapes of the three dropout masks for a batch."""
    return tuple((batch, _SIDE >> (j + 1), _SIDE >> (j + 1),
                  _CHANNELS[2 * j + 1][1]) for j in range(len(_DROPOUT)))


def dropout_masks(rng: torch.Tensor, batch: int) -> Tuple[torch.Tensor, ...]:
    """The keep masks `cifar_apply(train=True, rng=rng)` draws, each bool
    NHWC ``[..., B, H, W, C]``: after each pool ``rng, sub = split(rng)``
    and ``bernoulli(sub, 1 - rate, shape)``, as the reference draws them.
    Batched over the leading dims of ``rng [..., 2]``, so the round draws
    every user's masks in one call; `cifar_apply` takes the tuple in
    place of the key and gives the same result."""
    masks = []
    for rate, shape in zip(_DROPOUT, dropout_shapes(batch)):
        rng, sub = prng.split(rng).unbind(-2)
        masks.append(prng.bernoulli(sub, 1 - rate, shape))
    return tuple(masks)


def _conv_bn_relu(p, x: torch.Tensor) -> torch.Tensor:
    """x NCHW -> NCHW: 3x3 same convolution (the HWIO weight viewed as
    OIHW), batch norm over (N, H, W) with the population variance, scale
    and bias, ReLU."""
    y = F.conv2d(x, p["w"].permute(3, 2, 0, 1), padding=1) \
        + p["b"][:, None, None]
    mu = y.mean(dim=(0, 2, 3), keepdim=True)
    c = y - mu
    var = torch.square(c).mean(dim=(0, 2, 3), keepdim=True)
    y = c * torch.rsqrt(var + 1e-5)
    y = y * p["bn_scale"][:, None, None] + p["bn_bias"][:, None, None]
    return torch.relu(y)


def cifar_apply(params, x: torch.Tensor, *, train: bool = False,
                rng=None) -> torch.Tensor:
    """x: [B, 32, 32, 3] (NHWC) -> logits [B, 10].

    With ``train=True`` and an `rng`, dropout follows each pool: `rng` is
    a PRNG key (the masks are drawn here, as the reference draws them)
    or the tuple `dropout_masks` drew from such a key.  A kept value is
    divided by float32(1 - rate), as the reference's weak-typed constant
    divides it.
    """
    h = x.permute(0, 3, 1, 2)
    masks: Sequence = ()
    if train and rng is not None:
        masks = (rng if isinstance(rng, (tuple, list))
                 else dropout_masks(rng, x.shape[0]))
    for i, cp in enumerate(params["conv"]):
        h = _conv_bn_relu(cp, h)
        if i % 2 == 1:
            h = F.max_pool2d(h, 2, 2)
            if masks:
                rate = _DROPOUT[i // 2]
                keep = masks[i // 2].permute(0, 3, 1, 2)
                scale = torch.full((), 1 - rate, dtype=h.dtype,
                                   device=h.device)
                h = torch.where(keep, h / scale, 0.0)
    h = h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)
    return h @ params["fc_w"] + params["fc_b"]


def n_params(tree) -> int:
    """The number of values in a parameter tree (every leaf)."""
    return sum(int(x.numel()) for _, x in tree_leaves(tree))
