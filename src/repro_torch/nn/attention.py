"""GQA attention: prefill through the flash_mha kernel, and single-token
decode against a KV cache (the port of `repro.nn.attention`).

Features per the assigned architecture pool: grouped KV heads, optional
QKV bias (Qwen2), optional qk RMSNorm (Qwen3), NeoX / partial ("2-D",
ChatGLM) RoPE, optional sliding window (long-context variants).
Prefill computes the attention with
`repro_torch.kernels.flash_attention` (the hand-written CUDA kernel on
the card, its plain version on the CPU), for the JAX package's
``attn_impl`` "blocked" and "online" alike: both compute the same
softmax attention there, so the port's `AttnConfig` has no ``impl``.
It has the sharding knob ``seq_shard`` (the architecture's
``seq_shard_attn``), which changes nothing on one device.  A sliding
window
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

Tensor parallelism over "model" (inside the per-rank runner), by how
the rules place the heads, at any "model" width:

- the heads and the KV heads split: q, k, v and the qkv bias are split
  by heads (column-parallel), so each rank attends over its own heads
  (`_qkv` reads the local counts) and the flash kernel runs on them;
  `wo` is split by its input rows (row-parallel), its partial products
  summed over the group;
- the heads split and the KV heads replicated (they do not divide):
  each rank takes the KV heads of its own q heads (h // G) from the
  replicated `wk`, `wv` and their bias, with G / rank q heads on each
  (K and V expanded to one per q head where a rank's heads spread
  unevenly over them: the same function through the same kernel);
- the heads replicated (they do not divide) with ``seq_shard``: the
  "q_seq" route, sequence-parallel.  Each rank computes q for its block
  of L / model rows (`sharding.seq_block`; RoPE at their positions), k
  and v for all L keys, the flash kernel with ``q_offset`` at the
  block's first position, and `wo` on its rows; `sharding.gather_from`
  puts the rows back together, its backward keeping the rank's rows of
  the (replicated) gradient;
- the heads replicated without ``seq_shard``: every rank computes the
  whole attention on the replicated weights, no collective.

Where a rank computes a share of a function of replicated weights (q
and k norms under split heads; `wk`, `wv` and their bias beside split
heads; every weight under "q_seq"), the weights enter through
`sharding.copy_to`, so their gradient is the sum of the shares over
"model"; x enters through it wherever the rank's share of its gradient
is partial.  `prefill` checks the placements with `sharding.logical` at
the JAX package's sites.
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
    seq_shard: bool = False  # the q rows over 'model' where heads cannot


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


def _shared(tree):
    """A replicated parameter (a dict of tensors) of which this rank
    computes a share: each leaf through `sharding.copy_to` over "model",
    so that its gradient is the group's sum."""
    return {name: sh.copy_to(t, "model") for name, t in tree.items()}


def _kv_columns(p, h0: int, H: int, cfg: AttnConfig):
    """(the columns of replicated `wk` and `wv` (and their bias) that
    hold the KV heads of q heads h0 .. h0 + H - 1, the index of each q
    head's KV head among them, or None where every one of those KV
    heads serves the same number of them: GQA's own grouping)."""
    G = cfg.n_heads // cfg.n_kv_heads
    kv0, kv1 = h0 // G, (h0 + H - 1) // G + 1
    hd = cfg.head_dim
    cut = lambda w: {name: (t[..., kv0 * hd:kv1 * hd])
                     for name, t in _shared(w).items()}
    which = [(h0 + j) // G - kv0 for j in range(H)]
    even = all(which.count(i) == H // (kv1 - kv0) for i in range(kv1 - kv0))
    return cut(p["wk"]), cut(p["wv"]), None if even else which


def _qkv(p, x: torch.Tensor, positions: torch.Tensor, cfg: AttnConfig,
         rows: Optional[tuple] = None):
    """q [B, Lq, H, hd], k and v [B, L, KV, hd], H and KV this rank's
    heads (all of them unless the rules split them over "model"; the KV
    heads of its q heads where those split and the KV heads do not, one
    per q head where they spread unevenly).  `rows` (first, count): the
    block of query rows q covers (all L by default), RoPE at their
    positions."""
    B, L, _ = x.shape
    r0, Lq = rows or (0, L)
    n = sh.model_shards("heads")
    H = cfg.n_heads // n
    hd = cfg.head_dim
    wq, wk, wv, expand = p["wq"], p["wk"], p["wv"], None
    q_norm, k_norm = p.get("q_norm"), p.get("k_norm")
    if n > 1 and sh.model_shards("kv_heads") == 1:
        wk, wv, expand = _kv_columns(p, sh.axis_index("model") * H, H, cfg)
    if n > 1 or Lq < L:
        # this rank's heads, or its rows: a share of the norms' gradient
        q_norm, k_norm = (None if t is None else _shared(t)
                          for t in (q_norm, k_norm))
    if Lq < L:
        wq, wk, wv = _shared(wq), _shared(wk), _shared(wv)
    q = core.dense(wq, x[:, r0:r0 + Lq]).reshape(B, Lq, H, hd)
    k = core.dense(wk, x).reshape(B, L, -1, hd)
    v = core.dense(wv, x).reshape(B, L, -1, hd)
    if cfg.qk_norm:
        q = core.rmsnorm(q_norm, q)
        k = core.rmsnorm(k_norm, k)
    if cfg.rope_style != "none":
        q = apply_rope(q, positions[:, r0:r0 + Lq], theta=cfg.rope_theta,
                       style=cfg.rope_style)
        k = apply_rope(k, positions, theta=cfg.rope_theta, style=cfg.rope_style)
    if expand is not None:
        idx = torch.tensor(expand, device=k.device)
        k, v = k[:, :, idx], v[:, :, idx]
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
    if causal, and |i - j| < cfg.window with a window; under "q_seq"
    the rank's rows from its first position on, ``q_offset``).  The
    attention goes through `flash_attention_autograd` (the kernel's
    launch, and a gradient where autograd records), whatever
    ``cfg.scores_f32`` says.  Returns [B, L, D]."""
    L = x.shape[1]
    q_seq = "q_seq" if cfg.seq_shard else "seq"
    r0, Lq = sh.seq_block(L) if cfg.seq_shard else (0, L)
    split = Lq < L or sh.model_shards("heads") > 1
    q, k, v = _qkv(p, sh.copy_to(x, "model") if split else x, positions,
                   cfg, (r0, Lq))
    q = sh.logical(q, "batch", q_seq, "heads", "head_dim",
                   sizes={"q_seq": L})
    k = sh.logical(k, "batch", "seq", "kv_heads", "head_dim")
    v = sh.logical(v, "batch", "seq", "kv_heads", "head_dim")
    out = flash_attention_autograd(q, k, v, causal=cfg.causal,
                                   q_block=cfg.q_block,
                                   kv_block=cfg.kv_block, window=cfg.window,
                                   q_offset=r0)
    out = sh.logical(out, "batch", q_seq, None, sizes={"q_seq": L})
    if Lq < L:
        return sh.gather_from(core.dense(_shared(p["wo"]), out), "model", 1)
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
