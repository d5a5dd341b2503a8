"""The LM over the assigned architecture families: prefill and
single-token decode (the port of `repro.models.lm`).

Families: dense (GQA), moe (top-k experts, optional dense residual),
ssm (Mamba2/SSD), hybrid (Zamba2: Mamba2 layers with one weight-shared
attention block after every `shared_attn_every` of them, and a tail of
Mamba2 layers when that does not divide the depth), encdec (the
SeamlessM4T backbone: a bidirectional encoder over stubbed frame
embeddings, a decoder with cross-attention) and vlm (the LLaVA-NeXT LM
backbone, stubbed patch embeddings put in front of the tokens).

Parameters are the JAX package's tree as nested dicts of tensors: the
layers' leaves stacked on a leading axis ("layers", "enc_layers",
"tail"; the hybrid's "groups" on two, group and layer), with the same
leaf keys, so `repro_torch.convert.params_from_jax` carries a JAX tree
across unchanged.  The JAX package scans over those axes; here the layer
loop is a Python loop over them.  `init_params` follows the JAX key
splits through the `jax.random` emulation, so one integer seed gives the
JAX package's weights.

`decode_step` writes the caches in place: the KV caches at each row's
slot (`attention.decode`), the SSM states and conv windows whole
(`ssm.decode`).

A sliding window (``cfg.sliding_window``, e.g. ``cfg.with_(
sliding_window=W)``) reaches every attention as in the JAX package:
prefill's flash kernels (causal, the encoder's bidirectional stack, the
hybrid's shared block, the vlm's patches and tokens alike), so
`prefill_logits` and `lm_loss`, and decode's ring cache of W slots
(`decode_step`'s ``window``, which `launch.serve` sets to
``long_context_window`` at long_500k).  ``cfg.scores_f32=False`` is
the bf16-score branch of `attention._sdpa`: decode and the encdec's
cross-attention; prefill keeps the flash kernels' float32 scores.

Training: `lm_loss` is the next-token cross-entropy of the JAX
package's `lm_loss`, in checkpointed blocks of positions, and autograd
differentiates it.  Where autograd records (grad enabled and a
parameter or input requires grad) and ``cfg.remat`` (the default), each
layer body the JAX package remats (`_maybe_remat`) runs under
`torch.utils.checkpoint` (non-reentrant), so its forward runs again in
the backward: an attention layer launches its flash kernel twice per
forward and backward.  Attention takes its gradient from
`nn.attention.prefill`'s autograd route; the MoE, the SSD scan and the
cross-attention are plain torch, which autograd differentiates as it
stands.

Placements (`repro_torch.sharding`, inside the per-rank runner of
`launch.train`): with the rules' "p_embed" on the data axes (FSDP) the
parameters come in as this rank's shards and are gathered where they
are used, under autograd (`sharding.gather_shards`, whose backward
leaves each rank its block of the gradient summed over the data
ranks): a layer's leaves inside its (rematerialized) body, so the
backward gathers them again, and the other leaves at the top.  Under a
"model" axis past 1 the dense stack runs tensor-parallel (`nn.core`,
`nn.attention`, `nn.mlp`), and the head is vocab-parallel: `lm_loss`
takes each block's maximum and sum of exponentials over the group and
the gold logit from the rank that holds it; `prefill_logits` gathers
the vocabulary.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import prng
from repro_torch.configs.base import ArchConfig
from repro_torch.nn import attention, core, mlp, ssm
from repro_torch.sharding import api as sh
from repro_torch.tree import tree_from_paths, tree_leaves, tree_map

_FAMILIES = ("dense", "moe", "ssm", "hybrid", "encdec", "vlm")


def _check_family(cfg: ArchConfig) -> str:
    if cfg.family not in _FAMILIES:
        raise ValueError(f"unknown family {cfg.family!r}")
    return cfg.family


# ---------------------------------------------------------------------------
# Param construction
# ---------------------------------------------------------------------------

def _stack_layers(key: torch.Tensor, n: int, init_fn):
    """n layers from `init_fn` (a Px tree) on the n keys of ``split(key,
    n)``, each leaf stacked on a new leading axis, its logical axes led
    by "layers".  The stack is allocated once and filled a layer at a
    time, so building it takes the stack and one layer of memory; on the
    "meta" device one layer gives the shapes."""
    keys = prng.split(key, n)
    first, axes = core.split_params(init_fn(keys[0]))
    out = tree_map(lambda t: t.new_empty((n,) + tuple(t.shape)), first)

    def put(i, tree):
        tree_map(lambda o, t: o[i].copy_(t), out, tree)

    if key.device.type != "meta":
        put(0, first)
        del first
        for i in range(1, n):
            put(i, core.split_params(init_fn(keys[i]))[0])
    return _join(out, axes, ("layers",))


def _join(values, axes, lead=()):
    """The Px tree of a values tree and its axes tree (each axes tuple
    led by `lead`)."""
    if isinstance(values, dict):
        return {k: _join(values[k], axes[k], lead) for k in values}
    return core.Px(values, lead + tuple(axes))


def _attn_cfg(cfg: ArchConfig,
              window: Optional[int] = None) -> attention.AttnConfig:
    return attention.AttnConfig(
        d_model=cfg.d_model, n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
        head_dim=cfg.head_dim, qkv_bias=cfg.qkv_bias, qk_norm=cfg.qk_norm,
        rope_style=cfg.rope_style, rope_theta=cfg.rope_theta,
        window=window if window is not None else cfg.sliding_window,
        q_block=cfg.q_block, scores_f32=cfg.scores_f32,
        kv_block=cfg.kv_block, seq_shard=cfg.seq_shard_attn)


def _moe_cfg(cfg: ArchConfig) -> mlp.MoEConfig:
    return mlp.MoEConfig(
        d_model=cfg.d_model, d_ff_expert=cfg.d_ff_expert,
        n_experts=cfg.n_experts, top_k=cfg.top_k,
        capacity_factor=cfg.capacity_factor,
        dense_residual_ff=cfg.dense_residual_ff,
        dispatch=cfg.moe_dispatch)


def _ssm_cfg(cfg: ArchConfig) -> ssm.SSMConfig:
    return ssm.SSMConfig(
        d_model=cfg.d_model, d_state=cfg.ssm_state,
        head_dim=cfg.ssm_head_dim, expand=cfg.ssm_expand,
        chunk=cfg.ssm_chunk)


def _init_tblock(key: torch.Tensor, cfg: ArchConfig, *, cross: bool = False):
    """One transformer block: ln1 + attn [+ lnx + xattn] + ln2 + ffn
    (the MoE where the config has experts, but never in a cross block)."""
    ks = prng.split(key, 4)
    dt = cfg.pdt()
    dev = key.device
    p = {
        "ln1": core.rmsnorm_init(cfg.d_model, dtype=dt, device=dev),
        "attn": attention.init(ks[0], _attn_cfg(cfg), dtype=dt),
        "ln2": core.rmsnorm_init(cfg.d_model, dtype=dt, device=dev),
    }
    if cfg.n_experts and not cross:
        p["moe"] = mlp.moe_init(ks[1], _moe_cfg(cfg), dtype=dt)
    else:
        p["mlp"] = mlp.swiglu_init(ks[1], cfg.d_model, cfg.d_ff, dtype=dt)
    if cross:
        p["lnx"] = core.rmsnorm_init(cfg.d_model, dtype=dt, device=dev)
        p["xattn"] = attention.init(ks[2], _attn_cfg(cfg), dtype=dt)
    return p


def _init_sblock(key: torch.Tensor, cfg: ArchConfig):
    dt = cfg.pdt()
    return {
        "ln": core.rmsnorm_init(cfg.d_model, dtype=dt, device=key.device),
        "ssm": ssm.init(key, _ssm_cfg(cfg), dtype=dt),
    }


def init_params(key: torch.Tensor, cfg: ArchConfig) -> Dict[str, Any]:
    """The parameter tree on `key`'s device (make the key with
    ``prng.PRNGKey(seed, device)``): the values of the JAX package's
    `split_params(init_params(PRNGKey(seed), cfg))[0]`."""
    return core.split_params(init_px(key, cfg))[0]


def param_axes(cfg: ArchConfig) -> Dict[str, Any]:
    """The parameters' logical axes tree (`init_px` on the "meta"
    device, nothing allocated)."""
    return core.split_params(init_px(prng.PRNGKey(0, "meta"), cfg))[1]


def init_px(key: torch.Tensor, cfg: ArchConfig) -> Dict[str, Any]:
    """The JAX package's `init_params`: a Px tree (values and logical
    axes; `nn.core.split_params` separates them)."""
    fam = _check_family(cfg)
    k_emb, k_layers, k_head, _ = prng.split(key, 4)
    dt = cfg.pdt()
    p: Dict[str, Any] = {
        "embed": core.embedding_init(k_emb, cfg.vocab, cfg.d_model, dtype=dt),
        "final_norm": core.rmsnorm_init(cfg.d_model, dtype=dt,
                                        device=key.device),
        "lm_head": core.dense_init(k_head, cfg.d_model, cfg.vocab,
                                   axes=("p_embed", "p_vocab"), dtype=dt),
    }
    if fam in ("dense", "vlm", "moe"):
        p["layers"] = _stack_layers(k_layers, cfg.n_layers,
                                    lambda k: _init_tblock(k, cfg))
    elif fam == "ssm":
        p["layers"] = _stack_layers(k_layers, cfg.n_layers,
                                    lambda k: _init_sblock(k, cfg))
    elif fam == "hybrid":
        every = cfg.shared_attn_every
        n_groups, tail = divmod(cfg.n_layers, every)
        kg, kt, ksh = prng.split(k_layers, 3)
        p["groups"] = _stack_layers(
            kg, n_groups, lambda k: _stack_layers(
                k, every, lambda k2: _init_sblock(k2, cfg)))
        if tail:
            p["tail"] = _stack_layers(kt, tail,
                                      lambda k: _init_sblock(k, cfg))
        p["shared"] = _init_tblock(ksh, cfg)
    else:                                                     # encdec
        ke, kd = prng.split(k_layers)
        p["enc_layers"] = _stack_layers(ke, cfg.n_enc_layers,
                                        lambda k: _init_tblock(k, cfg))
        p["layers"] = _stack_layers(
            kd, cfg.n_layers, lambda k: _init_tblock(k, cfg, cross=True))
        p["enc_norm"] = core.rmsnorm_init(cfg.d_model, dtype=dt,
                                          device=key.device)
    return p


def _unstack(tree, n: int) -> list:
    """The n trees along a stacked tree's leading axis, as views by
    `torch.unbind`: under autograd each leaf's n gradients then come back
    as one stacked tensor (indexing a layer at a time would make each
    layer's gradient a zero-filled tensor of the whole stack)."""
    cols = [(path, torch.unbind(t)) for path, t in tree_leaves(tree)]
    return [tree_from_paths([(path, ts[i]) for path, ts in cols])
            for i in range(n)]


def _at(tree, *idx):
    """The leaves of a stacked tree at `idx` on their leading axes
    (views)."""
    return tree_map(lambda t: t[idx], tree)


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------

def _ffn(p, hin: torch.Tensor, cfg: ArchConfig):
    """The block's feed-forward: (out, aux), aux a float32 zero for the
    dense MLP."""
    if "moe" in p:
        return mlp.moe(p["moe"], hin, _moe_cfg(cfg))
    return mlp.swiglu(p["mlp"], hin), torch.zeros(
        (), dtype=torch.float32, device=hin.device)


def _tblock_fwd(p, x, positions, cfg: ArchConfig, acfg, *, enc_out=None):
    h = attention.prefill(p["attn"], core.rmsnorm(p["ln1"], x), positions,
                          acfg)
    x = x + h
    if "xattn" in p:
        x = x + _cross_attn(p["xattn"], core.rmsnorm(p["lnx"], x), enc_out,
                            acfg)
    h, aux = _ffn(p, core.rmsnorm(p["ln2"], x), cfg)
    return x + h, aux


def _cross_attn(p, x, enc_out, acfg: attention.AttnConfig):
    """Full (non-causal) attention of decoder queries over the encoder's
    output, in plain attention (`attention._sdpa`) as the reference
    computes it."""
    B, L, _ = x.shape
    Se = enc_out.shape[1]
    H, KV, hd = acfg.n_heads, acfg.n_kv_heads, acfg.head_dim
    q = core.dense(p["wq"], x).reshape(B, L, H, hd)
    k = core.dense(p["wk"], enc_out).reshape(B, Se, KV, hd)
    v = core.dense(p["wv"], enc_out).reshape(B, Se, KV, hd)
    mask = torch.ones((B, L, Se), dtype=torch.bool, device=x.device)
    return core.dense(p["wo"], attention._sdpa(q, k, v, mask, acfg))


def _tblock_decode(p, x, cache, cfg: ArchConfig, acfg, *, enc_out=None):
    h, new_cache = attention.decode(p["attn"], core.rmsnorm(p["ln1"], x),
                                    cache, acfg)
    x = x + h
    if "xattn" in p:
        x = x + _cross_attn(p["xattn"], core.rmsnorm(p["lnx"], x), enc_out,
                            acfg)
    h, _ = _ffn(p, core.rmsnorm(p["ln2"], x), cfg)
    return x + h, new_cache


def _sblock_fwd(p, x, cfg: ArchConfig):
    return x + ssm.prefill(p["ssm"], core.rmsnorm(p["ln"], x), _ssm_cfg(cfg))


def _sblock_decode(p, x, cache, cfg: ArchConfig):
    h, _ = ssm.decode(p["ssm"], core.rmsnorm(p["ln"], x), cache,
                      _ssm_cfg(cfg))
    return x + h


# ---------------------------------------------------------------------------
# Forward (train / prefill)
# ---------------------------------------------------------------------------

def _records(params, batch) -> bool:
    """Whether autograd records this forward: grad enabled, and a
    parameter or a float input requires grad (training; serving runs
    with neither)."""
    return torch.is_grad_enabled() and any(
        t.requires_grad for tree in (params, batch)
        for _, t in tree_leaves(tree))


def _maybe_remat(fn, cfg: ArchConfig, train: bool):
    """`fn` under `torch.utils.checkpoint` (``use_reentrant=False``: its
    activations are dropped and recomputed in the backward) when
    ``cfg.remat`` and autograd records (`train`), as the JAX package
    wraps its layer bodies in `jax.checkpoint`; otherwise `fn` itself."""
    if not (cfg.remat and train):
        return fn
    fn = sh.carry_context(fn)
    return lambda *args: checkpoint(fn, *args, use_reentrant=False)


def _fsdp_axes():
    """The data axes the active rules split the weights' "p_embed" dims
    over inside the runner (FSDP), or ()."""
    rules = sh.current_rules()
    if rules is None or sh.current_axes() is None:
        return ()
    return sh.split_axes((rules.physical("p_embed"),))


def _gathered(tree, axes_tree, names):
    """`tree`'s FSDP shards over the data axes `names` gathered under
    autograd (`tree` itself with no names)."""
    if not names:
        return tree
    specs = sh.param_sharding_tree(axes_tree, sh.current_rules())
    return sh.gather_tree(tree, specs, names, differentiable=True)


def _layer_axes(axes_tree):
    """A stack's logical axes less the leading "layers"."""
    return sh.map_axes_tree(lambda a: a[1:], axes_tree)


def _embed_inputs(params, batch, cfg: ArchConfig):
    """Token embed, the vlm's patch embeddings [B, n_patches, D] put in
    front.  Returns (x [B, L, D] in the compute dtype, positions [B, L]
    int32)."""
    cdt = cfg.cdt()
    x = core.embed(params["embed"], batch["tokens"], dtype=cdt)
    if cfg.family == "vlm":
        x = torch.cat([batch["patch_embeds"].to(cdt), x], dim=1)
    B, L, _ = x.shape
    positions = torch.arange(L, dtype=torch.int32,
                             device=x.device)[None].expand(B, L)
    return sh.logical(x, "batch", "seq", "embed"), positions


def _encode(params, batch, cfg: ArchConfig):
    """The encoder stack over the stubbed frame embeddings
    batch["src_frames"] [B, Ls, D], bidirectional, through
    `flash_attention`.  Returns the normed output [B, Ls, D]."""
    x = batch["src_frames"].to(cfg.cdt())
    B, Ls, _ = x.shape
    pos = torch.arange(Ls, dtype=torch.int32,
                       device=x.device)[None].expand(B, Ls)
    acfg = dataclasses.replace(_attn_cfg(cfg), causal=False)

    layers = _unstack(params["enc_layers"], cfg.n_enc_layers)

    def body(h, i):
        lp = layers[i]
        h = h + attention.prefill(lp["attn"], core.rmsnorm(lp["ln1"], h),
                                  pos, acfg)
        return h + mlp.swiglu(lp["mlp"], core.rmsnorm(lp["ln2"], h))

    body = _maybe_remat(body, cfg, _records(params, batch))
    for i in range(cfg.n_enc_layers):
        x = body(x, i)
    return core.rmsnorm(params["enc_norm"], x)


def backbone(params, batch, cfg: ArchConfig):
    """Runs the stack, returns (hidden [B, L, D], aux_loss): aux_loss is
    the float32 sum of the MoE layers' load-balance losses (zero for the
    other families)."""
    fam = _check_family(cfg)
    train = _records(params, batch)
    fsdp = _fsdp_axes()
    layer = lambda i: layers[i]
    if fsdp:
        # the stack's leaves gathered inside a layer's body, the head's
        # by `_head`, the others here
        axes = param_axes(cfg)
        params = {k: v if k in ("layers", "lm_head") else
                  _gathered(v, axes[k], fsdp) for k, v in params.items()}
        if "layers" in params:
            lax = _layer_axes(axes["layers"])
            layer = lambda i: _gathered(layers[i], lax, fsdp)
    x, positions = _embed_inputs(params, batch, cfg)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    acfg = _attn_cfg(cfg)
    if fam in ("dense", "vlm", "moe", "encdec"):
        enc_out = _encode(params, batch, cfg) if fam == "encdec" else None
        layers = _unstack(params["layers"], cfg.n_layers)
        body = _maybe_remat(
            lambda h, i: _tblock_fwd(layer(i), h, positions, cfg, acfg,
                                     enc_out=enc_out), cfg, train)
        for i in range(cfg.n_layers):
            x, aux = body(x, i)
            aux_total = aux_total + aux
    elif fam == "ssm":
        layers = _unstack(params["layers"], cfg.n_layers)
        body = _maybe_remat(lambda h, i: _sblock_fwd(layer(i), h, cfg),
                            cfg, train)
        for i in range(cfg.n_layers):
            x = body(x, i)
    else:                                                     # hybrid
        every = cfg.shared_attn_every
        n_groups = cfg.n_layers // every
        n_tail = cfg.n_layers - n_groups * every
        groups = [_unstack(g, every)
                  for g in _unstack(params["groups"], n_groups)]
        tail = _unstack(params["tail"], n_tail) if n_tail else []

        def group_body(h, g):
            for lp in groups[g]:
                h = _sblock_fwd(lp, h, cfg)
            return _tblock_fwd(params["shared"], h, positions, cfg, acfg)[0]

        group_body = _maybe_remat(group_body, cfg, train)
        tail_body = _maybe_remat(lambda h, i: _sblock_fwd(tail[i], h, cfg),
                                 cfg, train)
        for g in range(n_groups):
            x = group_body(x, g)
        for i in range(n_tail):
            x = tail_body(x, i)
    x = core.rmsnorm(params["final_norm"], x)
    return x, aux_total


def lm_loss(params, batch, cfg: ArchConfig, *, loss_block: int = 256,
            example_weights: Optional[torch.Tensor] = None):
    """Next-token CE loss, computed in sequence blocks of `loss_block`
    positions to bound the logits' working set (vocab up to 256k): each
    block's logits are recomputed in the backward (`torch.utils.
    checkpoint`, as the JAX package's `jax.checkpoint`), and the ragged
    tail past ``(L // loss_block) * loss_block`` positions carries no
    loss, as there.  The vlm's image positions carry none either.

    batch: "tokens" and "labels" [B, L] (plus "patch_embeds" or
    "src_frames", as `prefill_logits` takes them).  `example_weights`
    ([B], summing to ~1) reweights the per-example losses (the fused
    W-HFL step folds the users' OTA gains in so); by default their mean.
    Returns (loss + 0.01 * aux, {"ce": the unweighted mean, "aux": the
    MoE's load-balance loss}), the metrics detached."""
    hidden, aux = backbone(params, batch, cfg)
    labels = batch["labels"]
    if cfg.family == "vlm":                 # image positions carry no loss
        hidden = hidden[:, batch["patch_embeds"].shape[1]:, :]
    B, L, _ = hidden.shape
    w = _head(params, cfg).to(hidden.dtype)
    LB = min(loss_block, L)
    nb = L // LB
    vocab_split = sh.model_shards("vocab") > 1
    hidden = core.column_input(hidden, "vocab")

    def block(h, y):
        logits = sh.logical((h @ w).float(), "batch", "seq", "vocab")
        if vocab_split:
            return _split_ce(logits, y)
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, y[..., None].long())[..., 0]
        return (lse - gold).sum(-1)                      # per example [B]

    if torch.is_grad_enabled() and hidden.requires_grad:
        block = functools.partial(checkpoint, sh.carry_context(block),
                                  use_reentrant=False)
    per_ex = torch.zeros((B,), dtype=torch.float32, device=hidden.device)
    for b in range(nb):
        s = slice(b * LB, (b + 1) * LB)
        per_ex = per_ex + block(hidden[:, s], labels[:, s])
    per_ex = per_ex / (nb * LB)                          # per-token mean
    ce_mean = per_ex.mean()
    loss = (ce_mean if example_weights is None
            else torch.sum(per_ex * example_weights.float()))
    return loss + 0.01 * aux, {"ce": ce_mean.detach(), "aux": aux.detach()}


def _head(params, cfg: ArchConfig) -> torch.Tensor:
    """The LM head's weight [D, vocab] (this rank's vocabulary columns
    under a vocab-parallel head), its FSDP shards gathered."""
    fsdp = _fsdp_axes()
    if not fsdp:
        return params["lm_head"]["w"]
    return _gathered(params["lm_head"], param_axes(cfg)["lm_head"],
                     fsdp)["w"]


def _split_ce(logits: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Per-example sums of lse - gold over a block's positions, the
    vocabulary split over "model" (logits [B, LB, V / n], this rank's
    columns): the maximum over the group (held constant: the softmax's
    gradient does not depend on it), the exponentials' sum over it, and
    the gold logit from the rank that holds the label."""
    n_loc = logits.shape[-1]
    m = sh.pmax(logits.detach().amax(-1), "model")
    se = sh.reduce_from(torch.exp(logits - m[..., None]).sum(-1), "model")
    local = y.long() - sh.axis_index("model") * n_loc
    hit = (local >= 0) & (local < n_loc)
    gold = torch.gather(logits, -1, local.clamp(0, n_loc - 1)[..., None])
    gold = sh.reduce_from(torch.where(hit, gold[..., 0], 0.0), "model")
    return (m + torch.log(se) - gold).sum(-1)


def prefill_logits(params, batch, cfg: ArchConfig) -> torch.Tensor:
    """Prefill forward; returns last-position logits [B, vocab] float32.
    batch: {"tokens": [B, L]}, with "patch_embeds" [B, n_patches, D]
    (vlm) or "src_frames" [B, Ls, D] (encdec).  A vocab-parallel head's
    columns are gathered over "model"."""
    hidden, _ = backbone(params, batch, cfg)
    last = hidden[:, -1, :]
    logits = sh.logical((last @ _head(params, cfg).to(last.dtype)).float(),
                        "batch", "vocab")
    if sh.model_shards("vocab") > 1:
        logits = sh.all_gather(logits, "model", -1)
    return logits


# ---------------------------------------------------------------------------
# Decode (single token against caches)
# ---------------------------------------------------------------------------

def init_decode_cache(cfg: ArchConfig, batch: int, seq_len: int, *,
                      window: Optional[int] = None, device=None):
    """The cache for `decode_step`, in the JAX package's layout:

    - "attn": {"k", "v": [n, B, S, KV, hd] zeros in the compute dtype,
      "pos": [n, B] int32 set to seq_len - 1}, n the attention layers
      (dense, moe, vlm, encdec) or the hybrid's groups;
    - "ssm" (ssm), "ssm_groups" and "ssm_tail" (hybrid): {"h": [..., B,
      H, P, N] float32, "conv": {"x", "B", "C": [..., B, K-1, C]}} zeros,
      on the layers' leading axes;
    - "enc_out" (encdec): [B, min(enc_src_frames, seq_len), D] zeros (the
      reference's too: a caller that decodes against encoded frames puts
      them there).

    Unlike the reference's broadcast zeros, every layer has storage of
    its own, since `decode_step` writes the caches in place; on the
    "meta" device it only describes the shapes."""
    fam = _check_family(cfg)
    cdt = cfg.cdt()
    acfg = _attn_cfg(cfg, window=window)

    def attn_caches(n):
        one = attention.init_cache(batch, acfg, seq_len, dtype=cdt,
                                   prefilled=seq_len - 1, device="meta")
        return {"k": torch.zeros((n,) + tuple(one["k"].shape), dtype=cdt,
                                 device=device),
                "v": torch.zeros((n,) + tuple(one["v"].shape), dtype=cdt,
                                 device=device),
                "pos": torch.full((n, batch), seq_len - 1,
                                  dtype=torch.int32, device=device)}

    def ssm_caches(*lead):
        one = ssm.init_cache(batch, _ssm_cfg(cfg), dtype=cdt, device="meta")
        return tree_map(lambda t: torch.zeros(lead + tuple(t.shape),
                                              dtype=t.dtype, device=device),
                        one)

    if fam in ("dense", "vlm", "moe"):
        return {"attn": attn_caches(cfg.n_layers)}
    if fam == "ssm":
        return {"ssm": ssm_caches(cfg.n_layers)}
    if fam == "hybrid":
        every = cfg.shared_attn_every
        n_groups, tail = divmod(cfg.n_layers, every)
        caches = {"ssm_groups": ssm_caches(n_groups, every),
                  "attn": attn_caches(n_groups)}
        if tail:
            caches["ssm_tail"] = ssm_caches(tail)
        return caches
    enc_len = min(cfg.enc_src_frames, seq_len)
    return {"attn": attn_caches(cfg.n_layers),
            "enc_out": torch.zeros((batch, enc_len, cfg.d_model), dtype=cdt,
                                   device=device)}


def decode_step(params, cache, batch, cfg: ArchConfig, *,
                window: Optional[int] = None):
    """One-token decode. batch: {"tokens": [B, 1]}.  Returns (logits
    [B, vocab] float32, cache).  The returned cache holds the input's
    tensors, written in place (the KV caches at each row's slot, see
    `attention.decode`; the SSM states and conv windows whole), but for
    "attn"'s "pos", a new tensor."""
    fam = _check_family(cfg)
    x = core.embed(params["embed"], batch["tokens"], dtype=cfg.cdt())
    acfg = _attn_cfg(cfg, window=window)
    new_cache = dict(cache)
    pos = []

    def attn_layer(p, x, i, enc_out=None):
        c = cache["attn"]
        x, nc = _tblock_decode(p, x, {"k": c["k"][i], "v": c["v"][i],
                                      "pos": c["pos"][i]}, cfg, acfg,
                               enc_out=enc_out)
        pos.append(nc["pos"])
        return x

    if fam in ("dense", "vlm", "moe", "encdec"):
        enc_out = cache.get("enc_out")
        for i in range(cfg.n_layers):
            x = attn_layer(_at(params["layers"], i), x, i, enc_out)
    elif fam == "ssm":
        for i in range(cfg.n_layers):
            x = _sblock_decode(_at(params["layers"], i), x,
                               _at(cache["ssm"], i), cfg)
    else:                                                     # hybrid
        every = cfg.shared_attn_every
        n_groups = cfg.n_layers // every
        for g in range(n_groups):
            for j in range(every):
                x = _sblock_decode(_at(params["groups"], g, j), x,
                                   _at(cache["ssm_groups"], g, j), cfg)
            x = attn_layer(params["shared"], x, g)
        for i in range(cfg.n_layers - n_groups * every):
            x = _sblock_decode(_at(params["tail"], i), x,
                               _at(cache["ssm_tail"], i), cfg)
    if pos:
        new_cache["attn"] = {"k": cache["attn"]["k"],
                             "v": cache["attn"]["v"],
                             "pos": torch.stack(pos)}
    x = core.rmsnorm(params["final_norm"], x)[:, 0, :]
    logits = x @ params["lm_head"]["w"].to(x.dtype)
    return logits.float(), new_cache
