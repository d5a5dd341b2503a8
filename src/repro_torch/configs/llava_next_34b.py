"""LLaVA-NeXT-34B LM backbone; anyres vision frontend stubbed — input_specs() supplies projected patch embeddings [hf:llava-hf/llava-v1.6-mistral-7b-hf]."""
from repro_torch.configs.base import ArchConfig, register

LLAVA_NEXT_34B = register(ArchConfig(
    name="llava-next-34b", family="vlm",
    source="hf:llava-hf/llava-v1.6-mistral-7b-hf",
    n_layers=60, d_model=7168, n_heads=56, n_kv_heads=8, head_dim=128,
    d_ff=20480, vocab=64000, rope_theta=1e6,
    n_patches=2880,  # anyres: 5 tiles x 576 patches, projected (stub frontend)
    param_dtype="bfloat16",
))
