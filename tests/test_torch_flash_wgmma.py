"""The tensor-core flash kernel (``csrc/flash_attn_wgmma.cu``): its route
and its rounding, on the CPU.

The kernel itself runs only on a card (``tests/test_torch_cuda.py`` and
``chip_smoke.py`` hold it to the plain version there).  Here:

- `flash_route` picks the implementation from the tensors alone:
  bfloat16 on CUDA -> the tensor-core kernel, at hd 16, 32, 64, 112 and
  128;
  float32 on CUDA -> the float32 tensor-core kernel (3xTF32,
  ``tests/test_torch_flash_tf32.py``), at every head dim; the CPU -> the
  plain version.  CUDA inputs are stand-ins that carry a device, a
  dtype and a shape (this machine has no card), so nothing launches.
- `emulate` repeats the kernel's arithmetic in torch: bf16 q, k and v
  upcast to float32; float32 scores over 128-key tiles in ascending
  order, scaled by 1/sqrt(hd) * log2(e) (the kernel's exp2 prescale);
  the online softmax in float32 with p = 2^(s - m); p split into bf16
  hi = bf16(p) and lo = bf16(p - hi), both P V products summed in
  float32.  At small qwen-like shapes (a fold that straddles the
  kernel's 128-row tile, keys not a multiple of its 128-key tile, S !=
  L, hd 64 and 128), at ``tests/test_flash_attn.py``'s hd-16 and hd-32
  shapes, at hd 16 and 32 over several key tiles (the reduced
  model's width) and at zamba2-7b's hd 112 (which the kernel runs on
  its hd-128 instance with zero columns, adding +0 to every product, so
  the emulation at hd 112 is the padded kernel's), it is held to the
  JAX package's Pallas
  `flash_attention` in interpret mode:
  its float32 output on the same values within 1e-5 of max |o|
  (``chip_smoke.py``'s FLASH_F32_RTOL), and its bf16 output within
  that plus one bf16 ULP of each value (the smoke's bf16 gate).
- With p rounded once to bf16 (cuDNN's and FA3's choice) the same
  emulation lands at least 10x farther from the Pallas kernel, past the
  1e-5 gate, and its bf16 output fails the smoke's bf16 gate against
  the Pallas kernel's bf16 output: the recorded reason for the split.
- The kernel's C entry point has the wrapper's prototype, `ARGTYPES`,
  and `model_strides` gives the model layout's strides.
"""
import ctypes
import re
import types
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import flash_attention as j_flash_attention
from repro_torch.kernels import (flash_attention, flash_attention_plain,
                                 flash_mha, flash_route)
from repro_torch.kernels import flash_attn as flash_module
from repro_torch.kernels.flash_attn import MIN_DENOMINATOR, NEG_INF

torch.set_num_threads(1)

RTOL = 1e-5          # chip_smoke.py's FLASH_F32_RTOL
KEY_TILE = 128       # the kernel's keys per tile

# (B, L, S, H, KV, hd, Pallas q_block, Pallas kv_block)
SHAPES = [
    (1, 200, 200, 14, 2, 64, 200, 40),     # 7 x 200 folded rows straddle
    (2, 256, 256, 14, 2, 64, 128, 128),    # qwen2-0.5b's heads
    (1, 96, 200, 12, 2, 128, 96, 40),      # S != L, 200 = 128 + 72 keys
    # tests/test_flash_attn.py's hd-16 and hd-32 shapes
    (2, 64, 64, 4, 2, 16, 32, 32),
    (2, 96, 96, 6, 2, 32, 32, 48),
    (1, 32, 32, 2, 1, 16, 64, 32),         # a q block straddles the fold
    # the reduced model's width over several key tiles: 320 = 2 x 128 + 64
    (1, 256, 320, 4, 2, 32, 128, 64),
    (2, 160, 160, 4, 1, 16, 160, 32),
    # zamba2-7b's head dim, a fold that straddles the 128-row tile
    (1, 96, 200, 4, 2, 112, 96, 40),
]


@pytest.mark.parametrize("device,dtype,hd,want", [
    ("cpu", torch.bfloat16, 64, "plain"),
    ("cpu", torch.float32, 128, "plain"),
    ("cpu", torch.bfloat16, 32, "plain"),
    ("cuda", torch.bfloat16, 16, "flash_attn_wgmma"),
    ("cuda", torch.bfloat16, 32, "flash_attn_wgmma"),
    ("cuda", torch.bfloat16, 64, "flash_attn_wgmma"),
    ("cuda", torch.bfloat16, 112, "flash_attn_wgmma"),
    ("cuda", torch.bfloat16, 128, "flash_attn_wgmma"),
    ("cuda", torch.float32, 16, "flash_attn_tf32"),
    ("cuda", torch.float32, 32, "flash_attn_tf32"),
    ("cuda", torch.float32, 64, "flash_attn_tf32"),
    ("cuda", torch.float32, 112, "flash_attn_tf32"),
    ("cuda", torch.float32, 128, "flash_attn_tf32"),
])
def test_route_by_device_dtype_and_head_dim(device, dtype, hd, want):
    shape = (1, 8, 2, hd)
    q = (torch.zeros(shape, dtype=dtype) if device == "cpu" else
         types.SimpleNamespace(device=torch.device(device), dtype=dtype,
                               shape=shape))
    assert flash_route(q) == want


@pytest.mark.parametrize("hd", [32, 64])
def test_cpu_bf16_runs_the_plain_version_and_launches_nothing(hd):
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(*s, generator=g).to(torch.bfloat16)
               for s in ((1, 40, 4, hd), (1, 40, 2, hd), (1, 40, 2, hd)))
    before = (flash_mha.wgmma_launches, flash_mha.tf32_launches)
    assert torch.equal(flash_attention(q, k, v),
                       flash_attention_plain(q, k, v))
    assert (flash_mha.wgmma_launches, flash_mha.tf32_launches) == before


def emulate(q, k, v, *, causal: bool, split: bool = True) -> torch.Tensor:
    """The tensor-core kernel's arithmetic on q [B, L, H, hd], k, v
    [B, S, KV, hd] (bf16 values), per query head with positions
    arange(L): float32 [B, L, H * hd] before the final rounding.
    `split` False rounds each softmax weight once to bf16 instead."""
    B, L, H, hd = q.shape
    S, KV = k.shape[1], k.shape[2]
    G = H // KV
    qf = q.float().permute(0, 2, 1, 3)                         # [B,H,L,hd]
    kf, vf = (x.float().repeat_interleave(G, dim=2).permute(0, 2, 1, 3)
              for x in (k, v))                                 # [B,H,S,hd]
    pos = torch.arange(L)[:, None]
    # the kernel's scale * log2(e), each a float32, multiplied in float32
    scale_log2 = (torch.tensor(1.0 / np.sqrt(hd), dtype=torch.float32)
                  * torch.tensor(np.log2(np.e), dtype=torch.float32))
    acc = torch.zeros(B, H, L, hd)
    m = torch.full((B, H, L, 1), NEG_INF)
    den = torch.zeros(B, H, L, 1)
    for j0 in range(0, S, KEY_TILE):
        j1 = min(j0 + KEY_TILE, S)
        s = (qf @ kf[:, :, j0:j1].transpose(-1, -2)) * scale_log2
        if causal:
            s = s.masked_fill(torch.arange(j0, j1)[None, :] > pos, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        corr = torch.exp2(m - m_new)
        p = torch.exp2(s - m_new)
        den = den * corr + p.sum(-1, keepdim=True)
        m = m_new
        hi = p.to(torch.bfloat16).float()
        pv = hi @ vf[:, :, j0:j1]
        if split:
            pv = pv + (p - hi).to(torch.bfloat16).float() @ vf[:, :, j0:j1]
        acc = acc * corr + pv
    o = acc / den.clamp_min(MIN_DENOMINATOR)
    return o.permute(0, 2, 1, 3).reshape(B, L, H * hd)


def _inputs(B, L, S, H, KV, hd, seed):
    """bf16 q, k, v from a numpy seed, as torch tensors."""
    rng = np.random.default_rng(seed)
    return [torch.as_tensor(rng.standard_normal(s).astype(np.float32))
            .to(torch.bfloat16)
            for s in ((B, L, H, hd), (B, S, KV, hd), (B, S, KV, hd))]


def _pallas(q, k, v, causal, qb, kb, dtype):
    """The JAX package's Pallas kernel in interpret mode on the same
    values, in `dtype`, as a float32 torch tensor."""
    to_j = lambda x: jnp.asarray(x.float().numpy(), dtype)
    out = j_flash_attention(to_j(q), to_j(k), to_j(v), causal=causal,
                            q_block=qb, kv_block=kb, interpret=True)
    return torch.as_tensor(np.array(out, np.float32))


def bf16_close(got: torch.Tensor, want: torch.Tensor) -> bool:
    """chip_smoke.py's bf16 gate: within RTOL of max |want| plus one bf16
    ULP of the larger magnitude."""
    big = torch.maximum(got.abs(), want.abs()).contiguous()
    ulp = (big.view(torch.int16) + 1).view(torch.bfloat16).float() - (
        big.float())
    gap = (got.float() - want.float()).abs()
    return bool((gap <= RTOL * want.float().abs().max() + ulp).all())


def _gap(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got - want).abs().max() / want.abs().max())


@pytest.mark.parametrize("B,L,S,H,KV,hd,qb,kb", SHAPES)
@pytest.mark.parametrize("causal", [True, False])
def test_split_emulation_matches_pallas_kernel(B, L, S, H, KV, hd, qb, kb,
                                               causal):
    q, k, v = _inputs(B, L, S, H, KV, hd, L + S + hd)
    got = emulate(q, k, v, causal=causal)
    assert _gap(got, _pallas(q, k, v, causal, qb, kb, jnp.float32)) <= RTOL
    want_bf16 = _pallas(q, k, v, causal, qb, kb, jnp.bfloat16).to(
        torch.bfloat16)
    assert bf16_close(got.to(torch.bfloat16), want_bf16)


@pytest.mark.parametrize("B,L,S,H,KV,hd,qb,kb", SHAPES)
def test_rounding_p_once_misses_by_ten_times_more(B, L, S, H, KV, hd, qb,
                                                  kb):
    q, k, v = _inputs(B, L, S, H, KV, hd, L + S + hd)
    want = _pallas(q, k, v, True, qb, kb, jnp.float32)
    split = _gap(emulate(q, k, v, causal=True), want)
    once = emulate(q, k, v, causal=True, split=False)
    assert _gap(once, want) >= 10 * split
    assert _gap(once, want) > RTOL
    want_bf16 = _pallas(q, k, v, True, qb, kb, jnp.bfloat16).to(
        torch.bfloat16)
    assert not bf16_close(once.to(torch.bfloat16), want_bf16)


_C_TYPES = {"const void*": ctypes.c_void_p, "void*": ctypes.c_void_p,
            "int": ctypes.c_int, "float": ctypes.c_float,
            "const long long*": ctypes.POINTER(ctypes.c_longlong)}


@pytest.mark.parametrize("name", ["flash_attn_wgmma"])
def test_entry_points_share_the_wrappers_prototype(name):
    src = (Path(flash_module.__file__).parent.parent / "csrc"
           / f"{name}.cu").read_text()
    params = re.search(rf'extern "C" int {name}_launch\((.*?)\)', src,
                       re.S).group(1)
    types_ = [_C_TYPES[" ".join(p.split()[:-1]).replace(" *", "*")]
              for p in params.split(",")]
    assert types_ == flash_module.ARGTYPES


def test_model_strides_are_the_contiguous_layouts():
    q = torch.empty(2, 40, 14, 64)
    k = torch.empty(2, 72, 2, 64)
    assert flash_module.model_strides(q, k) == (
        q.stride()[:3] + k.stride()[:3] * 2 + q.stride()[:3])


@pytest.mark.parametrize("hd", flash_module.HEAD_DIMS)
def test_entry_point_has_an_instance_of_every_head_dim(hd):
    """The route sends bfloat16 at every head dim here, so the entry point
    dispatches each to an instance of its own width, hd 112 to the
    hd-128 one with 112 columns (any other is refused)."""
    src = (Path(flash_module.__file__).parent.parent / "csrc"
           / "flash_attn_wgmma.cu").read_text()
    inst = "128, 112" if hd == 112 else f"{hd}"
    assert f"if (hd == {hd})\n    return launch<{inst}>(" in src
