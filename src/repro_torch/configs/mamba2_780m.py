"""Mamba2-780M: attention-free SSD (state-space duality), O(1)-state decode [arXiv:2405.21060]."""
from repro_torch.configs.base import ArchConfig, register

MAMBA2_780M = register(ArchConfig(
    name="mamba2-780m", family="ssm", source="arXiv:2405.21060",
    n_layers=48, d_model=1536, n_heads=0, n_kv_heads=0,
    d_ff=0, vocab=50280, ssm_state=128, ssm_head_dim=64,
))
