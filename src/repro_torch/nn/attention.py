"""GQA attention: prefill through the flash_mha kernel, and single-token
decode against a KV cache (the port of `repro.nn.attention`).

Features per the assigned architecture pool: grouped KV heads, optional
QKV bias (Qwen2), optional qk RMSNorm (Qwen3), NeoX / partial ("2-D",
ChatGLM) RoPE, optional sliding window (long-context variants).
Prefill computes the attention with
`repro_torch.kernels.flash_attention` (the hand-written CUDA kernel on
the card, its plain version on the CPU), for the JAX package's
``attn_impl`` "blocked" and "online" alike: both compute the same
softmax attention there, so the port's `AttnConfig` has no ``impl``
(nor the sharding knob ``seq_shard``).  A sliding window
(``cfg.window``: key j kept for position l when |l - j| < window, in a
causal and a bidirectional prefill alike) goes into the kernels, which
skip the key tiles outside it.

``scores_f32=False`` is the JAX package's bf16-score branch of `_sdpa`
(scores and exponentials in q's dtype, the row max and the denominator
summed in float32): decode and the encdec's cross-attention take it.
Prefill keeps the flash route whatever ``scores_f32`` says: the kernel
materializes no scores, so the knob, which halves the scores' memory
traffic in XLA, has nothing to halve there (as ``impl`` has no
counterpart); its float32 scores agree with the JAX package's bf16-score
prefill within the bf16 bound.

The gradient: prefill calls `flash_attention_autograd`, whose forward
is `flash_attention` (the same kernel launch and bits, for serving and
training alike) and whose backward recomputes the attention in float32
scores one ``q_block`` of queries at a time, over the keys its rows
keep, and differentiates that (`kernels.flash_attn.attention_vjp`), the
counterpart of the JAX package's gradient through its
`jax.checkpoint`ed, window-masked `_sdpa` per query block; causal and
bidirectional, with a window or without.

Tensor parallelism over "model" (the rules' heads and kv_heads on it,
inside the per-rank runner): q, k, v and the qkv bias are split by
heads (column-parallel), so each rank attends over its own heads
(`_qkv` reads the local counts) and the flash kernel runs on them;
`wo` is split by its input rows (row-parallel), its partial products
summed over the group.  `prefill` checks the placements with
`sharding.logical` at the JAX package's sites.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import torch

from repro_torch import prng
from repro_torch.kernels import flash_attention_autograd
from repro_torch.nn import core
from repro_torch.nn.rope import apply_rope
from repro_torch.sharding import api as sh

NEG_INF = -1e30


@dataclass(frozen=True)
class AttnConfig:
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_style: str = "neox"  # "neox" | "partial" | "none"
    rope_theta: float = 10000.0
    window: Optional[int] = None  # sliding window (None = full causal)
    causal: bool = True  # False -> bidirectional (encoder stacks)
    q_block: int = 512  # the plain flash version's query tile
    scores_f32: bool = True
    kv_block: int = 1024  # the plain flash version's key tile


def init(key: torch.Tensor, cfg: AttnConfig, dtype=torch.float32):
    kq, kk, kv, ko = prng.split(key, 4)
    D, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    p = {
        "wq": core.dense_init(kq, D, H * hd, bias=cfg.qkv_bias,
                              axes=("p_embed", "p_heads"), dtype=dtype),
        "wk": core.dense_init(kk, D, KV * hd, bias=cfg.qkv_bias,
                              axes=("p_embed", "p_kv_heads"), dtype=dtype),
        "wv": core.dense_init(kv, D, KV * hd, bias=cfg.qkv_bias,
                              axes=("p_embed", "p_kv_heads"), dtype=dtype),
        "wo": core.dense_init(ko, H * hd, D, axes=("p_heads", "p_embed"),
                              dtype=dtype, scale=1.0 / math.sqrt(H * hd)),
    }
    if cfg.qk_norm:
        p["q_norm"] = core.rmsnorm_init(hd, axes=("head_dim",), dtype=dtype,
                                        device=key.device)
        p["k_norm"] = core.rmsnorm_init(hd, axes=("head_dim",), dtype=dtype,
                                        device=key.device)
    return p


def _qkv(p, x: torch.Tensor, positions: torch.Tensor, cfg: AttnConfig):
    """q [B, L, H, hd], k and v [B, L, KV, hd], H and KV this rank's
    heads (all of them unless the rules split them over "model")."""
    B, L, _ = x.shape
    H = cfg.n_heads // sh.model_shards("heads")
    KV = cfg.n_kv_heads // sh.model_shards("kv_heads")
    hd = cfg.head_dim
    q = core.dense(p["wq"], x).reshape(B, L, H, hd)
    k = core.dense(p["wk"], x).reshape(B, L, KV, hd)
    v = core.dense(p["wv"], x).reshape(B, L, KV, hd)
    if cfg.qk_norm:
        q = core.rmsnorm(p["q_norm"], q)
        k = core.rmsnorm(p["k_norm"], k)
    if cfg.rope_style != "none":
        q = apply_rope(q, positions, theta=cfg.rope_theta, style=cfg.rope_style)
        k = apply_rope(k, positions, theta=cfg.rope_theta, style=cfg.rope_style)
    return q, k, v


def _sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
          mask: torch.Tensor, cfg: AttnConfig) -> torch.Tensor:
    """Plain attention. q: [B,Lq,H,hd]; k,v: [B,S,KV,hd]; mask:
    [B,Lq,S] bool (True = keep).  Scores in q's dtype; with
    ``cfg.scores_f32`` float32 for the mask and the softmax, whose
    weights go back to q's dtype; without, the JAX package's bf16-score
    branch: masked to NEG_INF in the scores' dtype, the row max taken in
    float32 and cast back, exp in the scores' dtype, the denominator
    summed in float32 and cast back."""
    B, Lq, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    qg = q.reshape(B, Lq, KV, G, hd)
    scale = 1.0 / math.sqrt(hd)
    scores = torch.einsum("blkgd,bskd->bklgs", qg, k) * scale
    keep = mask[:, None, :, None, :]
    if cfg.scores_f32:
        scores = scores.float().masked_fill(~keep, NEG_INF)
        w = torch.softmax(scores, dim=-1).to(q.dtype)
    else:
        scores = scores.masked_fill(~keep, NEG_INF)
        mx = scores.float().amax(-1, keepdim=True)
        e = torch.exp(scores - mx.to(scores.dtype))
        w = (e / e.float().sum(-1, keepdim=True).to(e.dtype)).to(q.dtype)
    out = torch.einsum("bklgs,bskd->blkgd", w, v)
    return out.reshape(B, Lq, H * hd)


def prefill(p, x: torch.Tensor, positions: torch.Tensor,
            cfg: AttnConfig) -> torch.Tensor:
    """Full-sequence attention through the flash_mha kernel.

    x: [B, L, D]; positions: [B, L], which must be arange(L) in every
    row, as the model's prefill gives them: RoPE reads `positions`, and
    the kernel masks by row index (key j kept for query i when j <= i
    if causal, and |i - j| < cfg.window with a window).  The attention
    goes through `flash_attention_autograd` (the kernel's launch, and a
    gradient where autograd records), whatever ``cfg.scores_f32`` says.
    Returns [B, L, D]."""
    q, k, v = _qkv(p, core.column_input(x, "heads"), positions, cfg)
    q = sh.logical(q, "batch", "seq", "heads", "head_dim")
    k = sh.logical(k, "batch", "seq", "kv_heads", "head_dim")
    v = sh.logical(v, "batch", "seq", "kv_heads", "head_dim")
    out = flash_attention_autograd(q, k, v, causal=cfg.causal,
                                   q_block=cfg.q_block,
                                   kv_block=cfg.kv_block, window=cfg.window)
    out = sh.logical(out, "batch", "seq", None)
    return core.row_output(core.dense(p["wo"], out), "heads")


def decode(p, x: torch.Tensor, cache, cfg: AttnConfig):
    """Single-token decode against a KV cache, in plain torch.

    x: [B, 1, D].  cache: {"k","v": [B, S, KV, hd], "pos": [B] int32
    count of tokens already in the cache}.  With a sliding window,
    S == window and slots are written round-robin.

    The new k and v are written into the cache's tensors IN PLACE
    (`index_copy_` at each row's slot, where the JAX package blends a
    one-hot mask: for finite values the same bits), so the returned
    cache's "k" and "v" are the input's tensors, updated; "pos" is a new
    tensor.  Callers that need the old cache keep a copy."""
    ck, cv = cache["k"], cache["v"]
    B, S, KV, hd = ck.shape
    pos = cache["pos"]  # [B]
    q, k, v = _qkv(p, x, pos[:, None], cfg)
    slot = pos % S if cfg.window is not None else torch.clamp(pos, max=S - 1)
    rows = torch.arange(B, device=pos.device) * S + slot.long()
    ck.view(B * S, KV, hd).index_copy_(0, rows, k[:, 0])
    cv.view(B * S, KV, hd).index_copy_(0, rows, v[:, 0])
    # positions held in each slot
    slot_idx = torch.arange(S, dtype=torch.int32, device=pos.device)[None, :]
    cur = pos[:, None]
    if cfg.window is not None:
        # slot i holds the latest position p <= pos with p % S == i
        k_pos = cur - torch.remainder(cur - slot_idx, S)
        valid = k_pos >= torch.clamp(cur - (S - 1), min=0)
        k_pos = torch.where(valid, k_pos, -1)
    else:
        k_pos = torch.where(slot_idx <= cur, slot_idx, -1)
    mask = (k_pos >= 0)[:, None, :]  # [B,1,S]
    out = _sdpa(q, ck, cv, mask, cfg)
    y = core.dense(p["wo"], out)
    return y, {"k": ck, "v": cv, "pos": pos + 1}


def init_cache(batch: int, cfg: AttnConfig, seq_len: int,
               dtype=torch.bfloat16, prefilled: int = 0, device=None):
    S = min(seq_len, cfg.window) if cfg.window is not None else seq_len
    shape = (batch, S, cfg.n_kv_heads, cfg.head_dim)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        "pos": torch.full((batch,), prefilled, dtype=torch.int32,
                          device=device),
    }
