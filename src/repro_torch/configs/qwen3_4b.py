"""Qwen3-4B: dense decoder, GQA (32H/kv8), qk RMSNorm [hf:Qwen/Qwen3-8B]."""
from repro_torch.configs.base import ArchConfig, register

QWEN3_4B = register(ArchConfig(
    name="qwen3-4b", family="dense", source="hf:Qwen/Qwen3-8B",
    n_layers=36, d_model=2560, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=9728, vocab=151936, qk_norm=True, rope_theta=1e6,
))
