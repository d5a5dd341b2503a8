"""Snowflake Arctic 480B: 128 experts top-2 + parallel dense-residual FFN [hf:Snowflake/snowflake-arctic-base]."""
from repro_torch.configs.base import ArchConfig, register

ARCTIC_480B = register(ArchConfig(
    name="arctic-480b", family="moe", source="hf:Snowflake/snowflake-arctic-base",
    n_layers=35, d_model=7168, n_heads=56, n_kv_heads=8, head_dim=128,
    d_ff=0, d_ff_expert=4864, n_experts=128, top_k=2,
    dense_residual_ff=4864, vocab=32000, param_dtype="bfloat16",
))
