"""Feed-forward block: the SwiGLU MLP (the port of `repro.nn.mlp`'s
dense part).  The top-k MoE waits for ROADMAP queue A item 13."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch import prng
from repro_torch.nn import core


def swiglu_init(key: torch.Tensor, d_model: int, d_ff: int,
                dtype: torch.dtype = torch.float32):
    k1, k2, k3 = prng.split(key, 3)
    return {
        "w_gate": core.dense_init(k1, d_model, d_ff, dtype=dtype),
        "w_up": core.dense_init(k2, d_model, d_ff, dtype=dtype),
        "w_down": core.dense_init(k3, d_ff, d_model, dtype=dtype),
    }


def swiglu(p, x: torch.Tensor) -> torch.Tensor:
    g = F.silu(core.dense(p["w_gate"], x))
    u = core.dense(p["w_up"], x)
    return core.dense(p["w_down"], g * u)
