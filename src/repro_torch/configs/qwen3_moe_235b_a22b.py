"""Qwen3-MoE-235B-A22B: 94L, 128 experts top-8, expert parallel over 'model' [hf:Qwen/Qwen3-30B-A3B]."""
from repro_torch.configs.base import ArchConfig, register

QWEN3_MOE_235B = register(ArchConfig(
    name="qwen3-moe-235b-a22b", family="moe", source="hf:Qwen/Qwen3-30B-A3B",
    n_layers=94, d_model=4096, n_heads=64, n_kv_heads=4, head_dim=128,
    d_ff=0, d_ff_expert=1536, n_experts=128, top_k=8, vocab=151936,
    qk_norm=True, rope_theta=1e6, param_dtype="bfloat16",
))
