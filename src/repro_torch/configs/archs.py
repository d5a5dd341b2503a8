"""The 10 assigned architectures (+ the paper's own two models).

One module per architecture (src/repro_torch/configs/<id>.py), each citing its
source from the public-literature assignment pool; this module imports
them all for registration and keeps the paper's own experiment models.
"""
from repro_torch.configs.base import ArchConfig, register

from repro_torch.configs.qwen2_1_5b import QWEN2_1_5B
from repro_torch.configs.qwen3_4b import QWEN3_4B
from repro_torch.configs.llava_next_34b import LLAVA_NEXT_34B
from repro_torch.configs.seamless_m4t_medium import SEAMLESS_M4T_MEDIUM
from repro_torch.configs.qwen3_moe_235b_a22b import QWEN3_MOE_235B
from repro_torch.configs.qwen2_0_5b import QWEN2_0_5B
from repro_torch.configs.arctic_480b import ARCTIC_480B
from repro_torch.configs.chatglm3_6b import CHATGLM3_6B
from repro_torch.configs.zamba2_7b import ZAMBA2_7B
from repro_torch.configs.mamba2_780m import MAMBA2_780M

# Imported for registration side-effects and re-exported for callers that
# want the config constants by name.
__all__ = [
    "QWEN2_1_5B", "QWEN3_4B", "LLAVA_NEXT_34B", "SEAMLESS_M4T_MEDIUM",
    "QWEN3_MOE_235B", "QWEN2_0_5B", "ARCTIC_480B", "CHATGLM3_6B",
    "ZAMBA2_7B", "MAMBA2_780M", "MNIST_MLP", "CIFAR_CNN", "ASSIGNED",
]

# --- the paper's own experiment models (Section V) ---------------------------

MNIST_MLP = register(ArchConfig(
    name="mnist-mlp", family="paper-mlp", source="W-HFL paper §V (2N=7850)",
    n_layers=1, d_model=784, vocab=10, param_dtype="float32",
    compute_dtype="float32",
))

CIFAR_CNN = register(ArchConfig(
    name="cifar-cnn", family="paper-cnn", source="W-HFL paper §V (2N=307498)",
    n_layers=6, d_model=32, vocab=10, param_dtype="float32",
    compute_dtype="float32",
))

ASSIGNED = [
    "qwen2-1.5b", "qwen3-4b", "llava-next-34b", "seamless-m4t-medium",
    "qwen3-moe-235b-a22b", "qwen2-0.5b", "arctic-480b", "chatglm3-6b",
    "zamba2-7b", "mamba2-780m",
]
