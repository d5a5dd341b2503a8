"""Minimal functional NN library (the port of `repro.nn.core`).

Parameters are plain nested dicts of tensors.  During init, leaves are
`Px` (a tensor and its logical sharding axes, `repro_torch.sharding`);
`split_params` separates the two trees, as in the JAX package.  On the
"meta" device (`launch.train.abstract_state`) the draws allocate
nothing and compute nothing: they return meta tensors of their shape.

`_normal` draws through `repro_torch.prng.normal`, the bit-exact
`jax.random` emulation, so one integer seed gives the JAX package's
weights: the same key words, and normals within a few ULP.

Placements (`repro_torch.sharding`): under active rules inside the
per-rank runner, an initializer makes only this rank's shard of its
leaf (a draw through `prng.normal_at` at the shard's flat indices: the
whole draw's bits), `embed` looks its ids up in a table split over
"model" by vocabulary rows, and `column_input` / `row_output` put a
product split over "model" between replicated activations.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from repro_torch import prng
from repro_torch.sharding import api as sh


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


def _init_spec(axes) -> Optional[tuple]:
    """The spec of a leaf with logical `axes` under the active rules,
    where it splits the leaf on the mesh bound by the runner; else
    None (the whole leaf)."""
    rules = sh.current_rules()
    if axes is None or rules is None or sh.current_axes() is None:
        return None
    spec = sh.spec_for(axes, rules)
    return spec if sh.sharded(spec) else None


def _normal(key: torch.Tensor, shape: Sequence[int], scale: float,
            dtype: torch.dtype, spec: Optional[tuple] = None
            ) -> torch.Tensor:
    """``scale * normal(key, shape)`` in `dtype`; with `spec`, this
    rank's shard of it under that spec (`sharding.shard_index`'s flat
    indices drawn through `prng.normal_at`)."""
    local = tuple(shape) if spec is None else sh.shard_shape(shape, spec)
    n = math.prod(local)
    if key.device.type == "meta":
        return torch.empty(local, dtype=dtype, device="meta")
    if spec is None and n <= DRAW_SLICE:
        return (scale * prng.normal(key, shape)).to(dtype)
    idx = (None if spec is None else
           sh.shard_index(shape, spec, key.device).reshape(-1))
    out = torch.empty(n, dtype=dtype, device=key.device)
    for s in range(0, n, DRAW_SLICE):
        e = min(s + DRAW_SLICE, n)
        z = (prng.normal_slice(key, s, e) if idx is None
             else prng.normal_at(key, idx[s:e]))
        out[s:e] = (scale * z).to(dtype)
    return out.reshape(local)


def _zeros(shape: Sequence[int], axes, dtype: torch.dtype,
           device) -> torch.Tensor:
    spec = _init_spec(axes)
    local = tuple(shape) if spec is None else sh.shard_shape(shape, spec)
    return torch.zeros(local, dtype=dtype, device=device)


def dense_init(key: torch.Tensor, d_in: int, d_out: int, *,
               bias: bool = False,
               axes: Tuple[Optional[str], Optional[str]] = ("p_embed",
                                                            "p_ffn"),
               dtype: torch.dtype = torch.float32,
               scale: Optional[float] = None):
    scale = scale if scale is not None else 1.0 / math.sqrt(d_in)
    p = {"w": Px(_normal(key, (d_in, d_out), scale, dtype,
                         _init_spec(axes)), axes)}
    if bias:
        p["b"] = Px(_zeros((d_out,), (axes[1],), dtype, key.device),
                    (axes[1],))
    return p


def dense(p, x: torch.Tensor) -> torch.Tensor:
    """x @ w in x's dtype, the bias added in the product's dtype."""
    y = x @ p["w"].to(x.dtype)
    if "b" in p:
        y = y + p["b"].to(y.dtype)
    return y


def column_input(x: torch.Tensor, name: str) -> torch.Tensor:
    """Replicated `x` entering products whose output columns (logical
    axis `name`) the rules split over "model": `sharding.copy_to` (the
    gradient summed over the group), or `x` where they do not."""
    return sh.copy_to(x, "model") if sh.model_shards(name) > 1 else x


def row_output(y: torch.Tensor, name: str) -> torch.Tensor:
    """The partial product of a contraction over logical axis `name`
    split over "model", summed over the group (`sharding.reduce_from`),
    or `y` where the rules do not split it."""
    return sh.reduce_from(y, "model") if sh.model_shards(name) > 1 else y


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
    axes = ("p_vocab", "embed")
    return {"table": Px(_normal(key, (vocab, d), 0.02, dtype,
                                _init_spec(axes)), axes)}


def embed(p, ids: torch.Tensor, dtype: Optional[torch.dtype] = None
          ) -> torch.Tensor:
    """Rows `ids` of the table, cast to `dtype`.  The JAX package casts
    the whole table and then takes the rows; a cast is elementwise, so
    taking the rows first gives the same bits and casts only them.
    With the table split over "model" by rows (vocab-parallel), each
    rank looks up the ids its block holds, zeros elsewhere, and the
    group sums the rows (one nonzero term each: the same bits)."""
    table = p["table"]
    if sh.model_shards("p_vocab") == 1:
        rows = table[ids]
        return rows if dtype is None else rows.to(dtype)
    n_loc = table.shape[0]
    local = ids.long() - sh.axis_index("model") * n_loc
    hit = (local >= 0) & (local < n_loc)
    rows = torch.where(hit[..., None], table[local.clamp(0, n_loc - 1)],
                       torch.zeros((), dtype=table.dtype,
                                   device=table.device))
    return sh.reduce_from(rows if dtype is None else rows.to(dtype),
                          "model")
