"""PyTorch/CUDA port of the W-HFL reproduction (`repro`, in JAX).

The same subpackages as the JAX package, in PyTorch idiom: plain
functions on tensors, an explicit device, and parameters as plain dicts
of tensors.  Randomness follows a bit-exact emulation of `jax.random`
(`repro_torch.prng`), and the fused OTA combine runs as a hand-written
CUDA kernel for Hopper (`repro_torch.kernels`).  Nothing here imports
JAX or the JAX package.
"""
