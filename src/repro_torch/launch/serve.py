"""Serving steps: prefill and single-token decode (the port of
`repro.launch.serve`).

Serving needs no W-HFL: OTA aggregation is a training-time feature.
The JAX package jits each step on a production mesh with sharding
rules: the batch over the data axes, heads/experts/vocab over 'model'.
The port runs each step eagerly on one device.  Given a `mesh` (a
`DeviceMesh` or a shape mapping such as ``{"data": 16, "model": 16}``)
`build_prefill_step` and `build_decode_step` also return the
reference's placements, as specs over it
(`repro_torch.sharding`): ``(step, specs, shardings, rules)``, with
`cache_shardings` for the decode cache; running a step on several ranks
waits for tensor parallelism (ROADMAP queue A item 11).  Decode shapes
run `serve_step`, ONE new token against a KV cache of `seq_len`;
`long_500k` uses the sliding-window variant for attention archs (cache
size = window) and the O(1) state for SSM/hybrid.

The steps run on the CUDA card unless the caller passes
``device="cpu"``; without a card `build_prefill_step` and
`build_decode_step` raise.  Each step checks that its inputs lie on its
device.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ArchConfig, InputShape
from repro_torch.device import resolve_device
from repro_torch.models import lm
from repro_torch.sharding import P, make_rules, mesh_axes
from repro_torch.tree import tree_leaves


def _on(dev: torch.device, **tensors) -> None:
    for name, t in tensors.items():
        if t.device.type != dev.type:
            raise ValueError(f"{name} is on {t.device}; this step runs on "
                             f"{dev}")


def _data_axes(mesh):
    return tuple(a for a in ("pod", "cluster", "user", "data")
                 if a in mesh_axes(mesh))


def _n_data(mesh) -> int:
    sizes = mesh_axes(mesh)
    n = 1
    for a in _data_axes(mesh):
        n *= sizes[a]
    return n


def decode_window(cfg: ArchConfig, shape: InputShape) -> Optional[int]:
    """Sliding window used for attention caches at this shape."""
    if shape.seq_len > 65536 and cfg.family != "ssm":
        return cfg.long_context_window
    return cfg.sliding_window


def compute_params(params, cfg: ArchConfig):
    """The parameters as the steps use them: every leaf the model casts
    to the compute dtype before use (weights, biases, the embedding
    table) cast once; norm scales stay as they are (rmsnorm reads them
    in float32).  The steps give the same bits with this tree as with
    the float32 one, without casting the weights on every call."""
    cdt = cfg.cdt()

    def cast(tree):
        return {k: (cast(v) if isinstance(v, dict)
                    else v if k == "scale" else v.to(cdt))
                for k, v in tree.items()}
    return cast(params)


def build_prefill_step(cfg: ArchConfig, shape: InputShape, device=None,
                       *, mesh=None):
    """(prefill_step, batch_specs): prefill_step(params, batch) returns
    the last-position logits [B, vocab] float32; batch_specs() the batch
    it takes, as tensors on the "meta" device (shapes and dtypes): the
    tokens [B, L] int32, with the vlm's "patch_embeds" [B, n_patches, D]
    and the encdec's "src_frames" [B, enc_src_frames, D] in the compute
    dtype.  With a `mesh`, also `shardings()` -> (the batch's specs,
    the logits' spec) and the rules: four values, as the reference."""
    dev = resolve_device(device)

    def prefill_step(params, batch):
        _on(dev, **batch)
        return lm.prefill_logits(params, batch, cfg)

    def batch_specs():
        B, L = shape.global_batch, shape.seq_len
        b = {"tokens": torch.empty((B, L), dtype=torch.int32,
                                   device="meta")}
        if cfg.family == "vlm":
            b["patch_embeds"] = torch.empty(
                (B, cfg.n_patches, cfg.d_model), dtype=cfg.cdt(),
                device="meta")
        if cfg.family == "encdec":
            b["src_frames"] = torch.empty(
                (B, cfg.enc_src_frames, cfg.d_model), dtype=cfg.cdt(),
                device="meta")
        return b

    if mesh is None:
        return prefill_step, batch_specs
    rules = make_rules(mesh, fsdp=False, cfg=cfg)
    da = _data_axes(mesh)

    def shardings():
        return ({k: P(da) for k in batch_specs()},
                P(da, rules.physical("vocab")))      # logits [B, vocab]

    return prefill_step, batch_specs, shardings, rules


def cache_specs(cfg: ArchConfig, shape: InputShape):
    """The decode cache at (arch, shape), on the "meta" device."""
    w = decode_window(cfg, shape)
    return lm.init_decode_cache(cfg, shape.global_batch, shape.seq_len,
                                window=w, device="meta")


def cache_shardings(cfg: ArchConfig, shape: InputShape, mesh):
    """The decode cache's specs: the batch dim of every leaf over the
    data axes (where B divides over them); KV heads (and SSM heads) over
    'model' when they divide it, else replicated."""
    da = _data_axes(mesh)
    n_model = mesh_axes(mesh).get("model", 1)
    n_data = _n_data(mesh)
    B = shape.global_batch
    batch_ax = da if (B % max(n_data, 1) == 0 and B >= n_data) else None

    def leaf_spec(names, leaf):
        shp = leaf.shape
        # cache layouts: attn k/v [n_layers(, groups), B, S, KV, hd];
        # pos [..., B]; ssm h [..., B, H, P, N]; conv [..., B, K-1, C];
        # enc_out [B, L, D]
        spec = [None] * len(shp)
        # the batch dim: the first dim equal to B, from the left
        for i, n in enumerate(shp):
            if n == B:
                spec[i] = batch_ax
                break
        if names and names[-1] in ("k", "v") and len(shp) >= 2:
            if shp[-2] % n_model == 0 and shp[-2] >= n_model:
                spec[-2] = "model"
        if names and names[-1] == "h" and len(shp) >= 3:
            if shp[-3] % n_model == 0 and shp[-3] >= n_model:
                spec[-3] = "model"   # SSM heads
        return P(*spec)

    def walk(tree, names):
        if isinstance(tree, dict):
            return {k: walk(v, names + [k]) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return [walk(v, names + [""]) for v in tree]
        return leaf_spec(names, tree)

    return walk(cache_specs(cfg, shape), [])


def build_decode_step(cfg: ArchConfig, shape: InputShape, device=None, *,
                      mesh=None):
    """(serve_step, token_specs): serve_step(params, cache, tokens)
    returns (logits [B, vocab] float32, cache), the cache written in
    place (`lm.decode_step`); token_specs() the tokens it takes, [B, 1]
    int32 on the "meta" device.  With a `mesh`, also `shardings()` ->
    (the tokens' spec, `cache_shardings`, the logits' spec) and the
    rules: four values, as the reference."""
    dev = resolve_device(device)
    w = decode_window(cfg, shape)

    def serve_step(params, cache, tokens):
        _on(dev, tokens=tokens, **{"/".join(map(str, path)): t
                                    for path, t in tree_leaves(cache)})
        return lm.decode_step(params, cache, {"tokens": tokens}, cfg,
                              window=w)

    def token_specs():
        return torch.empty((shape.global_batch, 1), dtype=torch.int32,
                           device="meta")

    if mesh is None:
        return serve_step, token_specs
    rules = make_rules(mesh, fsdp=False, cfg=cfg)
    da = _data_axes(mesh)

    def shardings():
        n_data = _n_data(mesh)
        tok_spec = (P(da) if shape.global_batch % max(n_data, 1) == 0
                    and shape.global_batch >= n_data else P())
        return (tok_spec, cache_shardings(cfg, shape, mesh),
                P(tok_spec[0] if tok_spec else None,
                  rules.physical("vocab")))

    return serve_step, token_specs, shardings, rules
