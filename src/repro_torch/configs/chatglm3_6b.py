"""ChatGLM3-6B: 2-D (partial) RoPE, GQA kv=2 [arXiv:2406.12793]."""
from repro_torch.configs.base import ArchConfig, register

CHATGLM3_6B = register(ArchConfig(
    name="chatglm3-6b", family="dense", source="arXiv:2406.12793",
    n_layers=28, d_model=4096, n_heads=32, n_kv_heads=2, head_dim=128,
    d_ff=13696, vocab=65024, rope_style="partial",
))
