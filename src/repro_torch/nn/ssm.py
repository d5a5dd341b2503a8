"""Mamba2 (SSD, state-space duality, arXiv:2405.21060) block: the port of
`repro.nn.ssm`.

Chunked SSD scan for prefill, O(1)-state recurrent step for decode.
The z/x/B/C/dt projections stay split, as in the reference (whose
layout shards heads over a mesh; on one card that changes nothing).

`_ssd_chunked` is a Python loop over chunks: the [B, H, Q, Q] decay
matrix exists for one chunk at a time (over all chunks at once it is
O(L^2 / Q), 50 GiB at L 4k).  The state is float32; the chunk's
products run in float32, to which the reference's einsums promote their
bf16 operands.  `decode` writes the new state and conv windows into the
cache's tensors in place (the reference returns new ones), as the KV
cache's decode does; callers that need the old cache keep a copy.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import prng
from repro_torch.nn import core


@dataclass(frozen=True)
class SSMConfig:
    d_model: int
    d_state: int = 128
    head_dim: int = 64
    expand: int = 2
    conv_kernel: int = 4
    chunk: int = 256

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def n_heads(self) -> int:
        return self.d_inner // self.head_dim


def _linspace_f32(start: float, stop: float, num: int, device=None):
    """`jnp.linspace(start, stop, num, dtype=float32)` as JAX computes
    it: start * (1 - t) + stop * t with t = i / (num - 1) in float32,
    the last point `stop` itself."""
    t = torch.arange(num - 1, dtype=torch.float32, device=device) / float(
        num - 1)
    out = (np.float32(start) * (1 - t)) + (np.float32(stop) * t)
    return torch.cat([out, torch.full((1,), stop, dtype=torch.float32,
                                      device=device)])


def init(key: torch.Tensor, cfg: SSMConfig, dtype=torch.float32):
    k_z, k_x, k_B, k_C, k_dt, k_conv, k_out = prng.split(key, 7)
    D, Din, N, H = cfg.d_model, cfg.d_inner, cfg.d_state, cfg.n_heads
    Kc = cfg.conv_kernel
    dev = key.device
    root = float(np.sqrt(np.float32(Kc)))

    def conv_init(k, ch, axes):
        return core.Px((core._normal(k, (Kc, ch), 1.0, torch.float32)
                        / root).to(dtype), (None, axes))

    kcx, kcB, kcC = prng.split(k_conv, 3)
    Px = core.Px
    zeros = lambda n, dt=dtype: torch.zeros((n,), dtype=dt, device=dev)
    return {
        "w_z": core.dense_init(k_z, D, Din, axes=("p_embed", "p_heads"),
                               dtype=dtype),
        "w_x": core.dense_init(k_x, D, Din, axes=("p_embed", "p_heads"),
                               dtype=dtype),
        "w_B": core.dense_init(k_B, D, N, axes=("p_embed", None),
                               dtype=dtype),
        "w_C": core.dense_init(k_C, D, N, axes=("p_embed", None),
                               dtype=dtype),
        "w_dt": core.dense_init(k_dt, D, H, axes=("p_embed", "p_heads"),
                                dtype=dtype),
        "conv_x": conv_init(kcx, Din, "p_heads"),
        "conv_x_b": Px(zeros(Din), ("p_heads",)),
        "conv_B": conv_init(kcB, N, None),
        "conv_B_b": Px(zeros(N), (None,)),
        "conv_C": conv_init(kcC, N, None),
        "conv_C_b": Px(zeros(N), (None,)),
        "A_log": Px(torch.log(_linspace_f32(1.0, 16.0, H, dev)),
                    ("p_heads",)),
        "D": Px(torch.ones((H,), dtype=torch.float32, device=dev),
                ("p_heads",)),
        "dt_bias": Px(zeros(H, torch.float32), ("p_heads",)),
        "norm": core.rmsnorm_init(Din, axes=("heads",), dtype=dtype,
                                  device=dev),
        "w_out": core.dense_init(k_out, Din, D, axes=("p_heads", "p_embed"),
                                 dtype=dtype),
    }


def _segsum(x: torch.Tensor) -> torch.Tensor:
    """x: [..., Q] -> cumulative segment sums [..., Q, Q] (causal),
    -inf above the diagonal."""
    Q = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    seg = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=x.device))
    return seg.masked_fill(~mask, -math.inf)


def _ssd_chunked(x, dt, A, Bc, Cc, h0, cfg: SSMConfig):
    """Chunked SSD scan.

    x: [B, L, H, P]; dt: [B, L, H] float32 (post-softplus); A: [H]
    (negative); Bc, Cc: [B, L, N]; h0: [B, H, P, N] initial state.
    Returns (y [B, L, H, P] float32, h_final float32)."""
    Bsz, L, H, Pd = x.shape
    Q = min(cfg.chunk, L)
    assert L % Q == 0, f"seq {L} not divisible by chunk {Q}"
    dA = dt * A[None, None, :]                       # [B, L, H]
    xw = x * dt[..., None]                           # float32
    h = h0.float()
    ys = []
    for c0 in range(0, L, Q):
        xw_c = xw[:, c0:c0 + Q]                      # [B, Q, H, P]
        dA_c = dA[:, c0:c0 + Q]                      # [B, Q, H]
        B_c = Bc[:, c0:c0 + Q].to(xw.dtype)          # [B, Q, N]
        C_c = Cc[:, c0:c0 + Q].to(xw.dtype)
        dA_cs = torch.cumsum(dA_c, dim=1)
        Lmat = torch.exp(_segsum(dA_c.transpose(1, 2)))  # [B, H, Q, Q]
        # y_diag[b,q,h,p] = sum_k (C_q . B_k) L[b,h,q,k] xw[b,k,h,p]
        cb = C_c @ B_c.transpose(1, 2)               # [B, Q, Q]
        y = (cb[:, None] * Lmat) @ xw_c.permute(0, 2, 1, 3)  # [B, H, Q, P]
        # y_off[b,q,h,p] = (C_q . h[b,h,p,:]) exp(dA_cs[b,q,h])
        state_decay = torch.exp(dA_cs)               # [B, Q, H]
        y = y + (torch.einsum("bqn,bhpn->bhqp", C_c, h.to(xw.dtype))
                 * state_decay.transpose(1, 2)[..., None])
        ys.append(y.permute(0, 2, 1, 3))             # [B, Q, H, P]
        decay_states = torch.exp(dA_cs[:, -1:, :] - dA_cs)
        h = (h * torch.exp(dA_cs[:, -1, :]).float()[:, :, None, None]
             + torch.einsum("bkhp,bkn->bhpn",
                            xw_c * decay_states[..., None], B_c).float())
    return torch.cat(ys, dim=1), h


def _causal_conv(seq: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 cache=None):
    """seq: [B, L, C]; w: [K, C] depthwise; cache: the last K - 1 inputs
    [B, K-1, C] or None (zeros).  Returns (silu(conv + b) [B, L, C], the
    new cache [B, K-1, C]).  The K taps sum in float32 and round once to
    seq's dtype, then the bias adds in that dtype: the reference's
    einsum, then its add."""
    K = w.shape[0]
    B, L, C = seq.shape
    pad = (torch.zeros((B, K - 1, C), dtype=seq.dtype, device=seq.device)
           if cache is None else cache)
    full = torch.cat([pad, seq], dim=1)
    wf = w.to(seq.dtype).float()
    acc = full[:, 0:L].float() * wf[0]
    for k in range(1, K):
        acc = acc + full[:, k:k + L].float() * wf[k]
    out = acc.to(seq.dtype) + b.to(seq.dtype)
    return F.silu(out), full[:, L:]


def _project(p, xin: torch.Tensor, cfg: SSMConfig, conv_cache=None):
    """Shared projection + conv for prefill and decode.  Returns (z, x,
    Bc, Cc, dt_raw, new_conv_caches)."""
    z = core.dense(p["w_z"], xin)
    xi = core.dense(p["w_x"], xin)
    Bc = core.dense(p["w_B"], xin)
    Cc = core.dense(p["w_C"], xin)
    dt = core.dense(p["w_dt"], xin)
    cc = conv_cache or {}
    xi, ncx = _causal_conv(xi, p["conv_x"], p["conv_x_b"], cc.get("x"))
    Bc, ncB = _causal_conv(Bc, p["conv_B"], p["conv_B_b"], cc.get("B"))
    Cc, ncC = _causal_conv(Cc, p["conv_C"], p["conv_C_b"], cc.get("C"))
    return z, xi, Bc, Cc, dt, {"x": ncx, "B": ncB, "C": ncC}


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """`jax.nn.softplus`: logaddexp(x, 0)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))


def prefill(p, xin: torch.Tensor, cfg: SSMConfig) -> torch.Tensor:
    """xin: [B, L, D] -> [B, L, D], from a zero state."""
    Bsz, L, _ = xin.shape
    H, Pd, N = cfg.n_heads, cfg.head_dim, cfg.d_state
    z, xi, Bc, Cc, dt, _ = _project(p, xin, cfg)
    dt = _softplus(dt.float() + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    x_h = xi.reshape(Bsz, L, H, Pd)
    h0 = torch.zeros((Bsz, H, Pd, N), dtype=torch.float32,
                     device=xin.device)
    y, _ = _ssd_chunked(x_h, dt, A, Bc, Cc, h0, cfg)
    y = y + x_h.to(y.dtype) * p["D"].to(y.dtype)[None, None, :, None]
    y = y.reshape(Bsz, L, cfg.d_inner).to(xin.dtype)
    y = core.rmsnorm(p["norm"], y * F.silu(z))
    return core.dense(p["w_out"], y)


def decode(p, xin: torch.Tensor, cache, cfg: SSMConfig):
    """xin: [B, 1, D]; cache: {"h": [B, H, P, N] float32, "conv": {"x",
    "B", "C": [B, K-1, C]}}.  Returns (out [B, 1, D], cache), the
    cache's tensors written in place."""
    Bsz = xin.shape[0]
    H, Pd = cfg.n_heads, cfg.head_dim
    z, xi, Bc, Cc, dt, new_conv = _project(p, xin, cfg,
                                           conv_cache=cache["conv"])
    dt = _softplus(dt[:, 0].float() + p["dt_bias"])            # [B, H]
    A = -torch.exp(p["A_log"])
    x_h = xi[:, 0].reshape(Bsz, H, Pd).float()
    Bv = Bc[:, 0].float()                                      # [B, N]
    Cv = Cc[:, 0].float()
    dA = torch.exp(dt * A[None, :])                            # [B, H]
    h = cache["h"] * dA[:, :, None, None] + (
        (dt[:, :, None] * x_h)[..., None] * Bv[:, None, None, :])
    y = torch.einsum("bhpn,bn->bhp", h, Cv) + x_h * p["D"][None, :, None]
    y = y.reshape(Bsz, 1, cfg.d_inner).to(xin.dtype)
    y = core.rmsnorm(p["norm"], y * F.silu(z))
    out = core.dense(p["w_out"], y)
    cache["h"].copy_(h)
    for name, t in new_conv.items():
        cache["conv"][name].copy_(t)
    return out, cache


def init_cache(batch: int, cfg: SSMConfig, dtype=torch.bfloat16,
               device=None):
    Kc = cfg.conv_kernel - 1
    return {
        "h": torch.zeros((batch, cfg.n_heads, cfg.head_dim, cfg.d_state),
                         dtype=torch.float32, device=device),
        "conv": {
            "x": torch.zeros((batch, Kc, cfg.d_inner), dtype=dtype,
                             device=device),
            "B": torch.zeros((batch, Kc, cfg.d_state), dtype=dtype,
                             device=device),
            "C": torch.zeros((batch, Kc, cfg.d_state), dtype=dtype,
                             device=device),
        },
    }
