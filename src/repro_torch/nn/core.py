"""Minimal functional NN library (the port of `repro.nn.core`).

Parameters are plain nested dicts of tensors.  During init, leaves are
`Px` (a tensor and its logical sharding axes, `repro_torch.sharding`);
`split_params` separates the two trees, as in the JAX package.  On the
"meta" device (`launch.train.abstract_state`) the draws allocate
nothing and compute nothing: they return meta tensors of their shape.

`_normal` draws through `repro_torch.prng.normal`, the bit-exact
`jax.random` emulation, so one integer seed gives the JAX package's
weights: the same key words, and normals within a few ULP.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from repro_torch import prng


class Px(NamedTuple):
    value: torch.Tensor
    axes: Tuple[Optional[str], ...]


def split_params(tree):
    """Split a Px-leafed tree (nested dicts and lists) into (params,
    logical_axes) trees."""
    if isinstance(tree, Px):
        return tree.value, tree.axes
    if isinstance(tree, dict):
        pairs = {k: split_params(v) for k, v in tree.items()}
        return ({k: v[0] for k, v in pairs.items()},
                {k: v[1] for k, v in pairs.items()})
    pairs = [split_params(v) for v in tree]
    return [v[0] for v in pairs], [v[1] for v in pairs]


# ---------------------------------------------------------------------------
# Initializers
# ---------------------------------------------------------------------------

# a draw past this many elements is made this many at a time
# (`prng.normal_slice`): the emulation's int64 temporaries take ~50 bytes
# an element, 40 GB for one of qwen3-moe-235b-a22b's expert leaves whole
DRAW_SLICE = 1 << 25


def _normal(key: torch.Tensor, shape: Sequence[int], scale: float,
            dtype: torch.dtype) -> torch.Tensor:
    n = math.prod(shape)
    if key.device.type == "meta":
        return torch.empty(tuple(shape), dtype=dtype, device="meta")
    if n <= DRAW_SLICE:
        return (scale * prng.normal(key, shape)).to(dtype)
    out = torch.empty(n, dtype=dtype, device=key.device)
    for s in range(0, n, DRAW_SLICE):
        e = min(s + DRAW_SLICE, n)
        out[s:e] = (scale * prng.normal_slice(key, s, e)).to(dtype)
    return out.reshape(tuple(shape))


def dense_init(key: torch.Tensor, d_in: int, d_out: int, *,
               bias: bool = False,
               axes: Tuple[Optional[str], Optional[str]] = ("p_embed",
                                                            "p_ffn"),
               dtype: torch.dtype = torch.float32,
               scale: Optional[float] = None):
    scale = scale if scale is not None else 1.0 / math.sqrt(d_in)
    p = {"w": Px(_normal(key, (d_in, d_out), scale, dtype), axes)}
    if bias:
        p["b"] = Px(torch.zeros((d_out,), dtype=dtype, device=key.device),
                    (axes[1],))
    return p


def dense(p, x: torch.Tensor) -> torch.Tensor:
    """x @ w in x's dtype, the bias added in the product's dtype."""
    y = x @ p["w"].to(x.dtype)
    if "b" in p:
        y = y + p["b"].to(y.dtype)
    return y


def rmsnorm_init(d: int, *, axes=("embed",),
                 dtype: torch.dtype = torch.float32, device=None):
    return {"scale": Px(torch.ones((d,), dtype=dtype, device=device), axes)}


def rmsnorm(p, x: torch.Tensor, *, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm in float32, returned in x's dtype."""
    dt = x.dtype
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * p["scale"].float()).to(dt)


def embedding_init(key: torch.Tensor, vocab: int, d: int, *,
                   dtype: torch.dtype = torch.float32):
    return {"table": Px(_normal(key, (vocab, d), 0.02, dtype),
                        ("p_vocab", "embed"))}


def embed(p, ids: torch.Tensor, dtype: Optional[torch.dtype] = None
          ) -> torch.Tensor:
    """Rows `ids` of the table, cast to `dtype`.  The JAX package casts
    the whole table and then takes the rows; a cast is elementwise, so
    taking the rows first gives the same bits and casts only them."""
    rows = p["table"][ids]
    return rows if dtype is None else rows.to(dtype)
