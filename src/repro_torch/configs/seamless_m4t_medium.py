"""SeamlessM4T-medium transformer backbone: 12L enc + 12L dec; mel/conv audio frontend stubbed [arXiv:2308.11596]."""
from repro_torch.configs.base import ArchConfig, register

SEAMLESS_M4T_MEDIUM = register(ArchConfig(
    name="seamless-m4t-medium", family="encdec", source="arXiv:2308.11596",
    n_layers=12, n_enc_layers=12, d_model=1024, n_heads=16, n_kv_heads=16,
    head_dim=64, d_ff=4096, vocab=256206, enc_src_frames=1024,
))
