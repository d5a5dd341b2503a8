"""Feed-forward blocks: the SwiGLU MLP and the capacity-based top-k MoE
(the port of `repro.nn.mlp`).

`swiglu` runs tensor-parallel where the rules put "ffn" on "model"
(inside the per-rank runner).  The JAX package also tags the MoE's
activations with logical sharding axes and can shard its experts and
tokens over "model"; the port has no counterpart of that sharding yet
(ROADMAP queue A item 11: `launch.train` refuses a MoE under a "model"
axis past 1).

The MoE routes as the reference does, integer for integer: the top K of
the router's float32 softmax (`torch.topk`, sorted), each (token,
choice) pair's place in its expert's queue from an exclusive prefix
count of one-hots in token-major order, pairs at or past the capacity
sent to a drop bucket.  The dispatch is a gather (each expert slot reads
the token that owns it, an empty slot a zero row), and the combine a
gather to [T, K, D], weighted and summed over K in choice order: the
reference's scatter-add into zeros, with ``tok_idx = repeat(arange(T),
K)``, adds each token's K terms in that order, and no atomics are
needed.  The expert products are batched matmuls over the experts.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch import prng
from repro_torch.nn import core
from repro_torch.sharding import api as sh


def swiglu_init(key: torch.Tensor, d_model: int, d_ff: int,
                dtype: torch.dtype = torch.float32):
    k1, k2, k3 = prng.split(key, 3)
    return {
        "w_gate": core.dense_init(k1, d_model, d_ff,
                                  axes=("p_embed", "p_ffn"), dtype=dtype),
        "w_up": core.dense_init(k2, d_model, d_ff, axes=("p_embed", "p_ffn"),
                                dtype=dtype),
        "w_down": core.dense_init(k3, d_ff, d_model,
                                  axes=("p_ffn", "p_embed"), dtype=dtype),
    }


def swiglu(p, x: torch.Tensor) -> torch.Tensor:
    """SiLU(x w_gate) * (x w_up), times w_down.  With the rules' "ffn"
    on "model": w_gate and w_up split by columns, w_down by rows, its
    partial products summed over the group."""
    x = core.column_input(x, "ffn")
    g = F.silu(core.dense(p["w_gate"], x))
    u = core.dense(p["w_up"], x)
    h = sh.logical(g * u, "batch", "seq", "ffn")
    return core.row_output(core.dense(p["w_down"], h), "ffn")


# ---------------------------------------------------------------------------
# Mixture of Experts (token-choice top-k, capacity + gather dispatch)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class MoEConfig:
    d_model: int
    d_ff_expert: int
    n_experts: int
    top_k: int
    capacity_factor: float = 1.25
    # Arctic-style parallel dense residual branch
    dense_residual_ff: Optional[int] = None
    # "global": one dispatch over all B*L tokens; "grouped": each
    # sequence routes into its own capacity buffer (cap per sequence)
    dispatch: str = "global"


def moe_init(key: torch.Tensor, cfg: MoEConfig,
             dtype: torch.dtype = torch.float32):
    """The reference's key splits (router, gate, up, down, dense); the
    router always in float32."""
    kr, k1, k2, k3, kd = prng.split(key, 5)
    E, D, Fe = cfg.n_experts, cfg.d_model, cfg.d_ff_expert
    scale = 1.0 / math.sqrt(D)
    ein = ("p_experts", "p_embed", "p_expert_ffn")
    eout = ("p_experts", "p_expert_ffn", "p_embed")
    p = {
        "router": core.dense_init(kr, D, E, axes=("p_embed", None),
                                  dtype=torch.float32),
        # the expert-internal ffn dim stays unsharded: the experts are the
        # unit of model ('expert') parallelism
        "w_gate": core.Px(core._normal(k1, (E, D, Fe), scale, dtype,
                                       core._init_spec(ein)), ein),
        "w_up": core.Px(core._normal(k2, (E, D, Fe), scale, dtype,
                                     core._init_spec(ein)), ein),
        "w_down": core.Px(core._normal(k3, (E, Fe, D), scale, dtype,
                                       core._init_spec(eout)), eout),
    }
    if cfg.dense_residual_ff is not None:
        p["dense"] = swiglu_init(kd, D, cfg.dense_residual_ff, dtype=dtype)
    return p


def capacity(cfg: MoEConfig, tokens: int) -> int:
    """Slots per expert for a dispatch over `tokens` tokens."""
    return int(max(1, round(cfg.capacity_factor * cfg.top_k * tokens
                            / cfg.n_experts)))


def route(p, xt: torch.Tensor, cfg: MoEConfig, cap: int) -> dict:
    """The router over G groups of T tokens, xt [G, T, D], each group
    dispatching into its own E x `cap` slots.  Returns, per group:
    "top_p" [G, T, K] (the renormalised top-K probabilities), "top_e"
    [G, T, K] int64 (the experts, in descending probability), "keep"
    [G, T*K] bool and "slot" [G, T*K] int64 (e * cap + place in e's
    queue, or the drop bucket E * cap) in token-major order, and "aux"
    [G] (Switch's load-balance loss E * sum_e f_e P_e)."""
    G, T, _ = xt.shape
    E, K = cfg.n_experts, cfg.top_k
    gates = core.dense(p["router"], xt.float())                # [G, T, E]
    probs = torch.softmax(gates, dim=-1)
    top_p, top_e = torch.topk(probs, K, dim=-1, sorted=True)
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)
    me = probs.mean(1)                                         # [G, E]
    flat_e = top_e.reshape(G, T * K)
    # one-hots expert-major, [G, E, T*K], so the prefix count below runs
    # along the innermost axis
    experts = torch.arange(E, device=xt.device)[None, :, None]
    oh = (flat_e[:, None, :] == experts).to(torch.int32)
    ce = oh.sum(2).float() / (T * K)
    aux = E * torch.sum(me * ce, dim=-1)
    # exclusive prefix count: each pair's place in its expert's queue
    pos_in_e = torch.cumsum(oh, dim=2, dtype=torch.int32) - oh
    flat_pos = torch.gather(pos_in_e, 1, flat_e[:, None, :])[:, 0].long()
    keep = flat_pos < cap
    slot = torch.where(keep, flat_e * cap + flat_pos,
                       torch.full_like(flat_e, E * cap))
    return {"top_p": top_p, "top_e": top_e, "keep": keep, "slot": slot,
            "aux": aux}


def _experts(p, eb: torch.Tensor) -> torch.Tensor:
    """The E experts' SwiGLU on their slots, eb [E, R, D] -> [E, R, D],
    in eb's dtype."""
    dt = eb.dtype
    g = F.silu(torch.bmm(eb, p["w_gate"].to(dt)))
    u = torch.bmm(eb, p["w_up"].to(dt))
    return torch.bmm(g * u, p["w_down"].to(dt))


def _dispatch_combine(p, xt: torch.Tensor, cfg: MoEConfig,
                      cap: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Route, dispatch, run the experts and combine, over G groups of T
    tokens xt [G, T, D].  Returns (y [G, T, D], aux [G])."""
    G, T, D = xt.shape
    E, K = cfg.n_experts, cfg.top_k
    r = route(p, xt, cfg, cap)
    slot, keep = r["slot"], r["keep"]
    dev = xt.device
    # dispatch: slot s of group g reads the token that owns it; a slot
    # no pair owns (and the drop bucket) reads a zero row, index T
    tok_idx = torch.arange(T, device=dev).repeat_interleave(K)
    owner = torch.full((G, E * cap + 1), T, dtype=torch.int64, device=dev)
    owner.scatter_(1, slot, tok_idx.expand(G, -1).contiguous())
    rows = torch.cat([xt, xt.new_zeros(G, 1, D)], dim=1)       # [G, T+1, D]
    eb = torch.gather(rows, 1, owner[:, :E * cap, None].expand(-1, -1, D))
    # [G, E, cap, D] -> [E, G*cap, D]: every group's slots of expert e
    eb = eb.reshape(G, E, cap, D).transpose(0, 1).reshape(E, G * cap, D)
    out = _experts(p, eb).reshape(E, G, cap, D).transpose(0, 1)
    flat_out = torch.cat([out.reshape(G, E * cap, D),
                          out.new_zeros(G, 1, D)], dim=1)
    gathered = torch.gather(flat_out, 1, slot[..., None].expand(-1, -1, D))
    w = (r["top_p"].reshape(G, T * K) * keep).to(xt.dtype)
    terms = (gathered * w[..., None]).reshape(G, T, K, D)
    y = terms[:, :, 0]
    for k in range(1, K):                # the scatter-add's order
        y = y + terms[:, :, k]
    return y, r["aux"]


def moe(p, x: torch.Tensor, cfg: MoEConfig
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: [B, L, D] -> (y [B, L, D], aux load-balance loss, a float32
    scalar).  Tokens past an expert's capacity are dropped (Switch /
    GShard semantics): their share of y is zero."""
    B, L, D = x.shape
    if cfg.dispatch == "grouped":
        return _moe_grouped(p, x, cfg)
    y, aux = _dispatch_combine(p, x.reshape(1, B * L, D), cfg,
                               capacity(cfg, B * L))
    y = y.reshape(B, L, D)
    if cfg.dense_residual_ff is not None:
        y = y + swiglu(p["dense"], x)
    return y, aux[0]


def _moe_grouped(p, x: torch.Tensor, cfg: MoEConfig
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Group-local dispatch (GShard/Switch): each sequence routes into
    its own capacity buffer (cap = c_f * K * L / E); aux is the mean of
    the sequences' losses."""
    y, auxs = _dispatch_combine(p, x, cfg, capacity(cfg, x.shape[1]))
    if cfg.dense_residual_ff is not None:
        y = y + swiglu(p["dense"], x)
    return y, auxs.mean()
