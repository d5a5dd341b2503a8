"""Serving steps on one card: prefill and single-token decode (the port
of `repro.launch.serve`).

Serving needs no W-HFL: OTA aggregation is a training-time feature.
The JAX package jits each step on a production mesh with sharding
rules; the port runs eagerly on one device, so a `device` takes the
place of the mesh, and `cache_shardings` and `_data_axes` have no
counterpart (there is nothing to shard on one card).  Decode shapes run
`serve_step`, ONE new token against a KV cache of `seq_len`;
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
from repro_torch.tree import tree_leaves


def _on(dev: torch.device, **tensors) -> None:
    for name, t in tensors.items():
        if t.device.type != dev.type:
            raise ValueError(f"{name} is on {t.device}; this step runs on "
                             f"{dev}")


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


def build_prefill_step(cfg: ArchConfig, shape: InputShape, device=None):
    """(prefill_step, batch_specs): prefill_step(params, batch) returns
    the last-position logits [B, vocab] float32; batch_specs() the batch
    it takes, as tensors on the "meta" device (shapes and dtypes): the
    tokens [B, L] int32, with the vlm's "patch_embeds" [B, n_patches, D]
    and the encdec's "src_frames" [B, enc_src_frames, D] in the compute
    dtype."""
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

    return prefill_step, batch_specs


def cache_specs(cfg: ArchConfig, shape: InputShape):
    """The decode cache at (arch, shape), on the "meta" device."""
    w = decode_window(cfg, shape)
    return lm.init_decode_cache(cfg, shape.global_batch, shape.seq_len,
                                window=w, device="meta")


def build_decode_step(cfg: ArchConfig, shape: InputShape, device=None):
    """(serve_step, token_specs): serve_step(params, cache, tokens)
    returns (logits [B, vocab] float32, cache), the cache written in
    place (`lm.decode_step`); token_specs() the tokens it takes, [B, 1]
    int32 on the "meta" device."""
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

    return serve_step, token_specs
