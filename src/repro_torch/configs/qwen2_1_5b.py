"""Qwen2-1.5B: dense decoder, GQA (12H/kv2), QKV bias [arXiv:2407.10671]."""
from repro_torch.configs.base import ArchConfig, register

QWEN2_1_5B = register(ArchConfig(
    name="qwen2-1.5b", family="dense", source="arXiv:2407.10671",
    n_layers=28, d_model=1536, n_heads=12, n_kv_heads=2, head_dim=128,
    d_ff=8960, vocab=151936, qkv_bias=True, rope_theta=1e6,
))
