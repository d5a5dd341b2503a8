"""Zamba2-7B: Mamba2 backbone + weight-shared attention block every 6 layers [arXiv:2411.15242]."""
from repro_torch.configs.base import ArchConfig, register

ZAMBA2_7B = register(ArchConfig(
    name="zamba2-7b", family="hybrid", source="arXiv:2411.15242",
    n_layers=81, d_model=3584, n_heads=32, n_kv_heads=32, head_dim=112,
    d_ff=14336, vocab=32000, ssm_state=64, ssm_head_dim=64,
    shared_attn_every=6,
))
