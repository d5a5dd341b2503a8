"""Architecture / input-shape config schema and registry.

The port's copy of `repro.configs.base`: the same fields, defaults,
registry and `reduced()` cut, with `pdt()` / `cdt()` returning torch
dtypes.  The configs are shapes only; the repo holds no weights.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, Optional

import torch


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | encdec | vlm
    source: str  # citation from the assignment table

    n_layers: int = 0
    d_model: int = 0
    n_heads: int = 0
    n_kv_heads: int = 0
    head_dim: int = 128
    d_ff: int = 0
    vocab: int = 0

    # dense-attention options
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_style: str = "neox"  # neox | partial | none
    rope_theta: float = 10000.0
    sliding_window: Optional[int] = None       # always-on window (if any)
    long_context_window: Optional[int] = 8192  # window used for long_500k

    # MoE
    n_experts: int = 0
    top_k: int = 0
    d_ff_expert: int = 0
    dense_residual_ff: Optional[int] = None
    capacity_factor: float = 1.25

    # SSM / hybrid
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    shared_attn_every: int = 0  # hybrid: shared attn block every k mamba layers

    # enc-dec
    n_enc_layers: int = 0
    enc_src_frames: int = 1024  # stubbed audio frontend output length (train)

    # VLM
    n_patches: int = 0  # stubbed vision frontend output length

    # numerics
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    norm_eps: float = 1e-6
    remat: bool = True
    q_block: int = 512
    ssm_chunk: int = 256
    # attention implementation (the JAX package's perf knobs; in the port
    # both "blocked" and "online" prefill run the flash_mha kernel)
    attn_impl: str = "blocked"   # "blocked" | "online"
    scores_f32: bool = True      # False: bf16 scores (f32 row-max/denominator)
    kv_block: int = 1024         # kv block for attn_impl="online"
    seq_shard_attn: bool = False # shard q-seq over 'model' when heads cannot
    moe_token_shard: bool = False  # token-sharded MoE dispatch/combine
    moe_dispatch: str = "global"   # "global" | "grouped" (per-seq capacity)

    def pdt(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)

    def cdt(self) -> torch.dtype:
        return getattr(torch, self.compute_dtype)

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    def with_(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)

    def reduced(self) -> "ArchConfig":
        """Smoke-test variant: 2 layers, d_model<=512, <=4 experts."""
        d = min(self.d_model, 256)
        hd = 32
        heads = max(2, min(self.n_heads, 4))
        kvh = max(1, min(self.n_kv_heads, heads))
        kw = dict(
            n_layers=2,
            d_model=d,
            n_heads=heads,
            n_kv_heads=kvh,
            head_dim=hd,
            d_ff=min(self.d_ff, 512) if self.d_ff else 0,
            vocab=min(self.vocab, 512),
            q_block=64,
            ssm_chunk=32,
            remat=False,
        )
        if self.n_experts:
            kw.update(n_experts=4, top_k=min(self.top_k, 2),
                      d_ff_expert=min(self.d_ff_expert, 128))
            if self.dense_residual_ff is not None:
                kw.update(dense_residual_ff=128)
        if self.family == "hybrid":
            kw.update(shared_attn_every=1, n_layers=2)
        if self.family == "encdec":
            kw.update(n_enc_layers=2, enc_src_frames=16)
        if self.family == "vlm":
            kw.update(n_patches=8)
        if self.ssm_state:
            kw.update(ssm_state=min(self.ssm_state, 32), ssm_head_dim=16)
        return self.with_(**kw)


@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


INPUT_SHAPES: Dict[str, InputShape] = {
    "train_4k": InputShape("train_4k", 4096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524288, 1, "decode"),
}


_REGISTRY: Dict[str, ArchConfig] = {}


def register(cfg: ArchConfig) -> ArchConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ArchConfig:
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_configs():
    return dict(_REGISTRY)
