"""Qwen2-0.5B: dense decoder, GQA (14H/kv2), QKV bias [arXiv:2407.10671]."""
from repro_torch.configs.base import ArchConfig, register

QWEN2_0_5B = register(ArchConfig(
    name="qwen2-0.5b", family="dense", source="arXiv:2407.10671",
    n_layers=24, d_model=896, n_heads=14, n_kv_heads=2, head_dim=64,
    d_ff=4864, vocab=151936, qkv_bias=True, rope_theta=1e6,
))
