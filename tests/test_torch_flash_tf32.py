"""The float32 tensor-core flash kernel (``csrc/flash_attn_tf32.cu``): its
route, its pre-pass and its rounding, on the CPU.

The kernel itself runs only on a card (``tests/test_torch_cuda.py`` and
``chip_smoke.py`` hold it to the plain version there).  Here:

- `flash_route` sends float32 on CUDA to the tf32 kernel at every head
  dim (16, 32, 64, 128) and bfloat16 to the bf16 tensor-core kernel
  (CUDA inputs are stand-ins that carry a device, a dtype and a shape:
  nothing launches).
- `tf32_prepass_plain`, the pre-pass's plain version: hi + lo gives x
  back within 2^-22 relative, hi and lo have their low 13 bits zero
  (``cvt.rna.tf32.f32``, ties away from zero), and V^T holds each group
  of 8 keys in the tf32 A fragment's column order, zeros past S; at hd
  16, K's columns and V^T's rows are zero-padded to 32.
- `emulate_tf32` repeats the kernel's arithmetic in torch: float32 q,
  k, v split into tf32 hi + lo by integer bit operations; scores over
  the kernel's key tiles (64 keys at hd 32 and 64, 32 at hd 128) in
  ascending order as hi hi + hi lo + lo hi, scaled by
  1/sqrt(hd) * log2(e) (the exp2 prescale); the online softmax in
  float32 with p = 2^(s - m); p split the same way and P V as three
  products; hd 16 optionally zero-padded to 32 and hd 112 to 128, as
  the kernel runs them.
  At the tensor-core kernels' test shapes (a fold that straddles the
  128-row tile, keys not a multiple of the key tile, S != L, hd 64 and
  128, and ``tests/test_flash_attn.py``'s hd-16 and hd-32 shapes and
  both widths over several key tiles), causal and bidirectional, it is
  held to the JAX package's Pallas `flash_attention` in interpret mode
  in float32 within 1e-5 of max |o| (``chip_smoke.py``'s
  FLASH_F32_RTOL).
- With every product in plain TF32 (one rounding, no lo terms) the same
  emulation lands at least 10x farther from the Pallas kernel and past
  that gate: the recorded reason for the split.
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
from repro_torch.kernels.flash_attn import (MIN_DENOMINATOR, NEG_INF,
                                            TF32_KEY_ORDER, TF32_KEY_TILE,
                                            TF32_MIN_HEAD_DIM,
                                            tf32_prepass_plain, tf32_rna,
                                            tf32_split, tf32_width)

torch.set_num_threads(1)

RTOL = 1e-5          # chip_smoke.py's FLASH_F32_RTOL
# the kernel's keys per tile at each of its instances' widths (its
# Cfg<HD>::KB); hd 16 runs the hd-32 instance, hd 112 the hd-128 one
KEY_TILES = {32: 64, 64: 64, 128: 32}

# (B, L, S, H, KV, hd, Pallas q_block, Pallas kv_block):
# tests/test_torch_flash_wgmma.py's shapes
SHAPES = [
    (1, 200, 200, 14, 2, 64, 200, 40),     # 7 x 200 folded rows straddle
    (2, 256, 256, 14, 2, 64, 128, 128),    # qwen2-0.5b's heads
    (1, 96, 200, 12, 2, 128, 96, 40),      # S != L, 200 = 3 x 64 + 8 keys
    # tests/test_flash_attn.py's hd-16 and hd-32 shapes
    (2, 64, 64, 4, 2, 16, 32, 32),
    (2, 96, 96, 6, 2, 32, 32, 48),
    (1, 32, 32, 2, 1, 16, 64, 32),         # a q block straddles the fold
    # zamba2-7b's head dim, on the hd-128 instance zero-padded
    (1, 96, 200, 4, 2, 112, 96, 40),
    # the reduced model's width over several key tiles: 320 = 5 x 64
    (1, 256, 320, 4, 2, 32, 128, 64),
    (2, 160, 160, 4, 1, 16, 160, 32),
]


@pytest.mark.parametrize("device,dtype,hd,want", [
    ("cpu", torch.float32, 64, "plain"),
    ("cpu", torch.float32, 32, "plain"),
    ("cuda", torch.float32, 16, "flash_attn_tf32"),
    ("cuda", torch.float32, 32, "flash_attn_tf32"),
    ("cuda", torch.float32, 64, "flash_attn_tf32"),
    ("cuda", torch.float32, 128, "flash_attn_tf32"),
    ("cuda", torch.bfloat16, 32, "flash_attn_wgmma"),
    ("cuda", torch.bfloat16, 64, "flash_attn_wgmma"),
])
def test_route_sends_float32_hd64_to_the_tf32_kernel(device, dtype, hd,
                                                     want):
    shape = (1, 8, 2, hd)
    q = (torch.zeros(shape, dtype=dtype) if device == "cpu" else
         types.SimpleNamespace(device=torch.device(device), dtype=dtype,
                               shape=shape))
    assert flash_route(q) == want


@pytest.mark.parametrize("hd", [16, 64])
def test_cpu_float32_hd64_runs_the_plain_version_and_launches_nothing(hd):
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(*s, generator=g)
               for s in ((1, 40, 4, hd), (1, 40, 2, hd), (1, 40, 2, hd)))
    before = (flash_mha.wgmma_launches, flash_mha.tf32_launches)
    assert torch.equal(flash_attention(q, k, v),
                       flash_attention_plain(q, k, v))
    assert (flash_mha.wgmma_launches, flash_mha.tf32_launches) == before


def test_tf32_rna_rounds_to_nearest_ties_away():
    ulp = 2.0 ** -10
    x = torch.tensor([1 + ulp / 2, -(1 + ulp / 2), 1 + 1.5 * ulp,
                      1 + ulp / 2 - 2 ** -23, 3.0, 0.0, -0.0],
                     dtype=torch.float32)
    want = [1 + ulp, -(1 + ulp), 1 + 2 * ulp, 1.0, 3.0, 0.0, -0.0]
    assert tf32_rna(x).tolist() == want


@pytest.mark.parametrize("hd", [16, 32, 64, 112, 128])
@pytest.mark.parametrize("N,S", [(3, 70), (2, 64), (1, 1)])
def test_prepass_plain_splits_and_lays_out_keys(N, S, hd):
    """At hd 16 the pre-pass pads K's columns and V^T's rows to 32 with
    zeros, at hd 112 to 128: the width of the instance that runs it."""
    rng = np.random.default_rng(N * 100 + S + hd)
    k, v = (torch.as_tensor(
        (rng.standard_normal((N, S, hd))
         * 10.0 ** rng.integers(-3, 4, (N, S, hd))).astype(np.float32))
        for _ in range(2))
    ks, vts = tf32_prepass_plain(k, v)
    s_pad = -(-S // TF32_KEY_TILE) * TF32_KEY_TILE
    hdp = tf32_width(hd)
    assert ks.shape == (2, N, s_pad, hdp) and vts.shape == (2, N, hdp, s_pad)
    assert flash_module.tf32_scratch(N, S, hd, "cpu").numel() == (
        ks.numel() + vts.numel())
    for part in (ks, vts):
        assert not bool((part.view(torch.int32) & 0x1FFF).any())
    rec = ks[0, :, :S, :hd] + ks[1, :, :S, :hd]
    assert bool(((rec - k).abs() <= 2.0 ** -22 * k.abs()).all())
    assert not bool(ks[:, :, S:].any())
    assert not bool(ks[:, :, :, hd:].any()) and not bool(vts[:, :, hd:].any())
    # stored position p of a group of 8 holds key TF32_KEY_ORDER[p]
    keys = [8 * (p // 8) + TF32_KEY_ORDER[p % 8] for p in range(s_pad)]
    for p, j in enumerate(keys):
        col = vts[:, :, :hd, p]
        if j < S:
            assert bool(((col[0] + col[1] - v[:, j]).abs()
                         <= 2.0 ** -22 * v[:, j].abs()).all())
            assert torch.equal(torch.stack(tf32_split(v[:, j])), col)
        else:
            assert not bool(col.any())


def emulate_tf32(q, k, v, *, causal: bool, split: bool = True,
                 pad: bool = False):
    """The tf32 kernel's arithmetic on float32 q [B, L, H, hd], k, v
    [B, S, KV, hd], per query head with positions arange(L): float32
    [B, L, H * hd].  `split` False runs every product in plain TF32 (hi
    only) instead of 3xTF32.  `pad` runs a head dim below
    TF32_MIN_HEAD_DIM as the kernel does: q, k and v zero-padded to it,
    the scale still 1/sqrt(hd), the first hd columns of o kept; hd 112
    likewise to 128."""
    B, L, H, hd = q.shape
    S, KV = k.shape[1], k.shape[2]
    G = H // KV
    scale = 1.0 / np.sqrt(hd)
    if pad and tf32_width(hd) != hd:
        q, k, v = (torch.nn.functional.pad(x, (0, tf32_width(hd) - hd))
                   for x in (q, k, v))
        o = _emulate_tf32(q, k, v, causal=causal, split=split, scale=scale)
        return o.reshape(B, L, H, -1)[..., :hd].reshape(B, L, H * hd)
    return _emulate_tf32(q, k, v, causal=causal, split=split, scale=scale)


def _emulate_tf32(q, k, v, *, causal: bool, split: bool, scale: float):
    """`emulate_tf32` at q's own width, with the given softmax scale."""
    B, L, H, hd = q.shape
    S, KV = k.shape[1], k.shape[2]
    G = H // KV
    qf = q.permute(0, 2, 1, 3).contiguous()                    # [B,H,L,hd]
    kf, vf = (x.repeat_interleave(G, dim=2).permute(0, 2, 1, 3)
              .contiguous() for x in (k, v))                   # [B,H,S,hd]
    (q_hi, q_lo), (k_hi, k_lo), (v_hi, v_lo) = (
        tf32_split(x) for x in (qf, kf, vf))
    pos = torch.arange(L)[:, None]
    # the kernel's scale * log2(e), each a float32, multiplied in float32
    scale_log2 = (torch.tensor(scale, dtype=torch.float32)
                  * torch.tensor(np.log2(np.e), dtype=torch.float32))
    acc = torch.zeros(B, H, L, hd)
    m = torch.full((B, H, L, 1), NEG_INF)
    den = torch.zeros(B, H, L, 1)
    kb = KEY_TILES[tf32_width(hd)]
    for j0 in range(0, S, kb):
        j1 = min(j0 + kb, S)
        kh, kl = (x[:, :, j0:j1].transpose(-1, -2) for x in (k_hi, k_lo))
        s = q_hi @ kh
        if split:
            s = s + q_hi @ kl + q_lo @ kh
        s = s * scale_log2
        if causal:
            s = s.masked_fill(torch.arange(j0, j1)[None, :] > pos, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        corr = torch.exp2(m - m_new)
        p = torch.exp2(s - m_new)
        den = den * corr + p.sum(-1, keepdim=True)
        m = m_new
        p_hi, p_lo = tf32_split(p)
        vh, vl = v_hi[:, :, j0:j1], v_lo[:, :, j0:j1]
        pv = p_hi @ vh
        if split:
            pv = pv + p_hi @ vl + p_lo @ vh
        acc = acc * corr + pv
    o = acc / den.clamp_min(MIN_DENOMINATOR)
    return o.permute(0, 2, 1, 3).reshape(B, L, H * hd)


def _inputs(B, L, S, H, KV, hd, seed):
    """float32 q, k, v from a numpy seed, as torch tensors."""
    rng = np.random.default_rng(seed)
    return [torch.as_tensor(rng.standard_normal(s).astype(np.float32))
            for s in ((B, L, H, hd), (B, S, KV, hd), (B, S, KV, hd))]


def _pallas(q, k, v, causal, qb, kb):
    """The JAX package's Pallas kernel in interpret mode on the same
    values, in float32, as a torch tensor."""
    to_j = lambda x: jnp.asarray(x.numpy(), jnp.float32)
    out = j_flash_attention(to_j(q), to_j(k), to_j(v), causal=causal,
                            q_block=qb, kv_block=kb, interpret=True)
    return torch.as_tensor(np.array(out, np.float32))


def _gap(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got - want).abs().max() / want.abs().max())


@pytest.mark.parametrize("B,L,S,H,KV,hd,qb,kb", SHAPES)
@pytest.mark.parametrize("causal", [True, False])
def test_3xtf32_emulation_matches_pallas_kernel(B, L, S, H, KV, hd, qb, kb,
                                                causal):
    q, k, v = _inputs(B, L, S, H, KV, hd, L + S + hd + causal)
    assert _gap(emulate_tf32(q, k, v, causal=causal, pad=True),
                _pallas(q, k, v, causal, qb, kb)) <= RTOL


@pytest.mark.parametrize("B,L,S,H,KV,hd,qb,kb",
                         [s for s in SHAPES if tf32_width(s[5]) != s[5]])
def test_zero_padding_leaves_the_emulation_unchanged(B, L, S, H, KV, hd, qb,
                                                     kb):
    """hd 16 on the hd-32 instance and hd 112 on the hd-128 one: zero
    columns add +0 to every score and every output column kept."""
    q, k, v = _inputs(B, L, S, H, KV, hd, L + S + hd)
    assert torch.equal(emulate_tf32(q, k, v, causal=True, pad=True),
                       emulate_tf32(q, k, v, causal=True))


@pytest.mark.parametrize("B,L,S,H,KV,hd,qb,kb", SHAPES)
def test_plain_tf32_misses_by_ten_times_more(B, L, S, H, KV, hd, qb, kb):
    q, k, v = _inputs(B, L, S, H, KV, hd, L + S + hd)
    want = _pallas(q, k, v, True, qb, kb)
    split = _gap(emulate_tf32(q, k, v, causal=True, pad=True), want)
    once = _gap(emulate_tf32(q, k, v, causal=True, split=False, pad=True),
                want)
    assert once >= 10 * split
    assert once > RTOL


_C_TYPES = {"const void*": ctypes.c_void_p, "void*": ctypes.c_void_p,
            "int": ctypes.c_int, "float": ctypes.c_float,
            "const long long*": ctypes.POINTER(ctypes.c_longlong)}


def test_entry_point_parses_against_the_wrappers_prototype():
    name = "flash_attn_tf32"
    src = (Path(flash_module.__file__).parent.parent / "csrc"
           / f"{name}.cu").read_text()
    params = re.search(rf'extern "C" int {name}_launch\((.*?)\)', src,
                       re.S).group(1)
    types_ = [_C_TYPES[" ".join(p.split()[:-1]).replace(" *", "*")]
              for p in params.split(",")]
    assert types_ == flash_module.TF32_ARGTYPES
    # the key padding, key tiles and key order the wrapper and the
    # emulation assume are the source's
    assert f"constexpr int kKeyPad = {TF32_KEY_TILE};" in src
    assert ("static constexpr int KB = HD == 128 ? "
            f"{KEY_TILES[128]} : {KEY_TILES[64]};") in src
    assert KEY_TILES[32] == KEY_TILES[64]
    assert f"constexpr int kMinHD = {TF32_MIN_HEAD_DIM};" in src
    assert "p < 4 ? 2 * p : 2 * (p - 4) + 1" in src
    assert list(TF32_KEY_ORDER) == [p * 2 if p < 4 else 2 * (p - 4) + 1
                                    for p in range(8)]


@pytest.mark.parametrize("hd", flash_module.HEAD_DIMS)
def test_entry_point_dispatches_every_head_dim(hd):
    """Each head dim goes to the instance of its width, hd 16 to the
    hd-32 one with 16 columns of q and o, hd 112 to the hd-128 one with
    112; any other is refused."""
    src = (Path(flash_module.__file__).parent.parent / "csrc"
           / "flash_attn_tf32.cu").read_text()
    width = tf32_width(hd)
    assert f"case {hd}:\n      return launch<{width}, {hd}>(" in src
