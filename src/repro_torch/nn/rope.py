"""Rotary position embeddings: NeoX-style full-dim and ChatGLM 2-D
(partial) (the port of `repro.nn.rope`)."""
from __future__ import annotations

import torch


def _angles(positions: torch.Tensor, rotary_dim: int,
            theta: float) -> torch.Tensor:
    """positions [..., L] -> angles [..., L, rotary_dim/2] (float32)."""
    exponent = torch.arange(0, rotary_dim, 2, dtype=torch.float32,
                            device=positions.device) / rotary_dim
    inv_freq = 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32,
                                            device=positions.device),
                               exponent)
    return positions.float()[..., None] * inv_freq


def _rotate(x: torch.Tensor, ang: torch.Tensor) -> torch.Tensor:
    """Rotate pairs (x[..., :d/2], x[..., d/2:]) by `ang` (NeoX split
    halves).  cos and sin are cast to x's dtype before the products, as
    the JAX package does: in bf16 that rounding is part of the result."""
    d2 = x.shape[-1] // 2
    x1, x2 = x[..., :d2], x[..., d2:]
    cos = torch.cos(ang).to(x.dtype)
    sin = torch.sin(ang).to(x.dtype)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, *,
               theta: float = 10000.0, style: str = "neox") -> torch.Tensor:
    """x: [B, L, H, hd]; positions: [B, L] (or [L]).

    style "neox": rotary over the full head dim (Qwen/Llama family).
    style "partial": rotary over the first half of the head dim only,
    the rest passes through (ChatGLM's 2-D RoPE realization).
    """
    if positions.dim() == 1:
        positions = positions[None, :]
    hd = x.shape[-1]
    rotary_dim = hd if style == "neox" else hd // 2
    ang = _angles(positions, rotary_dim, theta)[:, :, None, :]  # over heads
    if style == "neox":
        return _rotate(x, ang)
    if style == "partial":
        xr, xp = x[..., :rotary_dim], x[..., rotary_dim:]
        return torch.cat([_rotate(xr, ang), xp], dim=-1)
    raise ValueError(f"unknown rope style {style!r}")
