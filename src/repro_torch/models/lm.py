"""The LM stack's dense family: a GQA decoder, prefill and single-token
decode (the port of `repro.models.lm`).

Parameters are the JAX package's tree as nested dicts of tensors: the
layers' leaves stacked on a leading axis under "layers", with the same
leaf keys, so `repro_torch.convert.params_from_jax` carries a JAX tree
across unchanged.  The JAX package scans over that axis; here the layer
loop is a Python loop over it.  `init_params` follows the JAX key splits
through the `jax.random` emulation, so one integer seed gives the JAX
package's weights.

Only the dense family is ported.  The moe, ssm, hybrid, encdec (with
its encoder and cross-attention) and vlm families, and `lm_loss`
(training), raise `NotImplementedError` naming their ROADMAP item.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch import prng
from repro_torch.configs.base import ArchConfig
from repro_torch.nn import attention, core, mlp
from repro_torch.tree import tree_map

_NOT_PORTED = {
    "moe": "the moe family (top-k experts)",
    "ssm": "the ssm family (Mamba2/SSD)",
    "hybrid": "the hybrid family (Zamba2)",
    "encdec": "the encdec family (SeamlessM4T)",
    "vlm": "the vlm family (LLaVA-NeXT)",
}


def _require_dense(cfg: ArchConfig) -> None:
    if cfg.family == "dense":
        return
    if cfg.family in _NOT_PORTED:
        raise NotImplementedError(
            f"{cfg.name}: {_NOT_PORTED[cfg.family]} is not ported yet "
            f"(ROADMAP queue A item 13); only the dense family runs")
    raise ValueError(f"unknown family {cfg.family!r}")


# ---------------------------------------------------------------------------
# Param construction
# ---------------------------------------------------------------------------

def _stack_layers(key: torch.Tensor, n: int, init_fn):
    keys = prng.split(key, n)
    ps = [init_fn(keys[i]) for i in range(n)]
    return tree_map(lambda *xs: torch.stack(xs), *ps)


def _attn_cfg(cfg: ArchConfig,
              window: Optional[int] = None) -> attention.AttnConfig:
    return attention.AttnConfig(
        d_model=cfg.d_model, n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
        head_dim=cfg.head_dim, qkv_bias=cfg.qkv_bias, qk_norm=cfg.qk_norm,
        rope_style=cfg.rope_style, rope_theta=cfg.rope_theta,
        window=window if window is not None else cfg.sliding_window,
        q_block=cfg.q_block, scores_f32=cfg.scores_f32,
        kv_block=cfg.kv_block)


def _init_tblock(key: torch.Tensor, cfg: ArchConfig):
    """One transformer block: ln1 + attn + ln2 + ffn."""
    ks = prng.split(key, 4)
    dt = cfg.pdt()
    return {
        "ln1": core.rmsnorm_init(cfg.d_model, dtype=dt, device=key.device),
        "attn": attention.init(ks[0], _attn_cfg(cfg), dtype=dt),
        "ln2": core.rmsnorm_init(cfg.d_model, dtype=dt, device=key.device),
        "mlp": mlp.swiglu_init(ks[1], cfg.d_model, cfg.d_ff, dtype=dt),
    }


def init_params(key: torch.Tensor, cfg: ArchConfig) -> Dict[str, Any]:
    """The parameter tree on `key`'s device (make the key with
    ``prng.PRNGKey(seed, device)``): the values of the JAX package's
    `split_params(init_params(PRNGKey(seed), cfg))[0]`."""
    _require_dense(cfg)
    k_emb, k_layers, k_head, _ = prng.split(key, 4)
    dt = cfg.pdt()
    return {
        "embed": core.embedding_init(k_emb, cfg.vocab, cfg.d_model, dtype=dt),
        "final_norm": core.rmsnorm_init(cfg.d_model, dtype=dt,
                                        device=key.device),
        "lm_head": core.dense_init(k_head, cfg.d_model, cfg.vocab, dtype=dt),
        "layers": _stack_layers(k_layers, cfg.n_layers,
                                lambda k: _init_tblock(k, cfg)),
    }


def _layer(params, i: int):
    """Layer i's parameters: views into the stacked leaves."""
    return tree_map(lambda t: t[i], params["layers"])


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------

def _tblock_fwd(p, x, positions, acfg):
    h = attention.prefill(p["attn"], core.rmsnorm(p["ln1"], x), positions,
                          acfg)
    x = x + h
    h = mlp.swiglu(p["mlp"], core.rmsnorm(p["ln2"], x))
    return x + h


def _tblock_decode(p, x, cache, acfg):
    h, new_cache = attention.decode(p["attn"], core.rmsnorm(p["ln1"], x),
                                    cache, acfg)
    x = x + h
    h = mlp.swiglu(p["mlp"], core.rmsnorm(p["ln2"], x))
    return x + h, new_cache


# ---------------------------------------------------------------------------
# Forward (prefill)
# ---------------------------------------------------------------------------

def _embed_inputs(params, batch, cfg: ArchConfig):
    """Token embed.  Returns (x [B, L, D] in the compute dtype,
    positions [B, L] int32)."""
    tokens = batch["tokens"]
    x = core.embed(params["embed"], tokens, dtype=cfg.cdt())
    B, L, _ = x.shape
    positions = torch.arange(L, dtype=torch.int32,
                             device=x.device)[None].expand(B, L)
    return x, positions


def backbone(params, batch, cfg: ArchConfig):
    """Runs the stack, returns (hidden [B, L, D], aux_loss), aux_loss a
    float32 zero: the dense family has no auxiliary loss."""
    _require_dense(cfg)
    x, positions = _embed_inputs(params, batch, cfg)
    acfg = _attn_cfg(cfg)
    for i in range(cfg.n_layers):
        x = _tblock_fwd(_layer(params, i), x, positions, acfg)
    x = core.rmsnorm(params["final_norm"], x)
    return x, torch.zeros((), dtype=torch.float32, device=x.device)


def lm_loss(params, batch, cfg: ArchConfig, **kw):
    raise NotImplementedError("training (lm_loss) is not ported yet "
                              "(ROADMAP queue A item 13)")


def prefill_logits(params, batch, cfg: ArchConfig) -> torch.Tensor:
    """Prefill forward; returns last-position logits [B, vocab] float32."""
    hidden, _ = backbone(params, batch, cfg)
    last = hidden[:, -1, :]
    logits = last @ params["lm_head"]["w"].to(last.dtype)
    return logits.float()


# ---------------------------------------------------------------------------
# Decode (single token against caches)
# ---------------------------------------------------------------------------

def init_decode_cache(cfg: ArchConfig, batch: int, seq_len: int, *,
                      window: Optional[int] = None, device=None):
    """The cache for `decode_step`: {"attn": {"k", "v": [n_layers, B, S,
    KV, hd] zeros in the compute dtype, "pos": [n_layers, B] int32 set to
    seq_len - 1}}, the JAX package's layout.  Unlike its broadcast
    zeros, every layer has storage of its own, since `decode_step`
    writes the cache in place; on the "meta" device it only describes
    the shapes."""
    _require_dense(cfg)
    acfg = _attn_cfg(cfg, window=window)
    one = attention.init_cache(batch, acfg, seq_len, dtype=cfg.cdt(),
                               prefilled=seq_len - 1, device="meta")
    n = cfg.n_layers
    return {"attn": {
        "k": torch.zeros((n,) + tuple(one["k"].shape), dtype=cfg.cdt(),
                         device=device),
        "v": torch.zeros((n,) + tuple(one["v"].shape), dtype=cfg.cdt(),
                         device=device),
        "pos": torch.full((n, batch), seq_len - 1, dtype=torch.int32,
                          device=device)}}


def decode_step(params, cache, batch, cfg: ArchConfig, *,
                window: Optional[int] = None):
    """One-token decode. batch: {"tokens": [B, 1]}.  Returns (logits
    [B, vocab] float32, cache).  The returned cache's "k" and "v" are
    the input's tensors, written in place at each row's slot (see
    `attention.decode`); its "pos" is a new tensor."""
    _require_dense(cfg)
    x = core.embed(params["embed"], batch["tokens"], dtype=cfg.cdt())
    acfg = _attn_cfg(cfg, window=window)
    c = cache["attn"]
    pos = []
    for i in range(cfg.n_layers):
        x, nc = _tblock_decode(_layer(params, i), x,
                               {"k": c["k"][i], "v": c["v"][i],
                                "pos": c["pos"][i]}, acfg)
        pos.append(nc["pos"])
    x = core.rmsnorm(params["final_norm"], x)[:, 0, :]
    logits = x @ params["lm_head"]["w"].to(x.dtype)
    new_cache = dict(cache)
    new_cache["attn"] = {"k": c["k"], "v": c["v"], "pos": torch.stack(pos)}
    return logits.float(), new_cache
