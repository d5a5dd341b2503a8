"""The port's flash attention (`repro_torch.kernels.flash_attn`) against
the JAX package's Pallas kernel.

Tolerances, and why:

- `flash_attention_plain` against the JAX `flash_attention` run in
  interpret mode at ``tests/test_flash_attn.py``'s five shapes, causal
  and bidirectional, fed the same numpy inputs: float32 within that
  test's rtol = atol = 2e-5 (the same loop nest and recurrence; only
  the products' summation order differs, and the gaps measure below
  2e-6), bfloat16 within its 5e-2 (both round the output once from
  float32).
- at a ragged shape the Pallas wrapper refuses (L not a multiple of the
  tiles), against the jnp oracle `ref.flash_attention_ref`: 2e-5.

On the CPU the wrappers run the plain versions; the CUDA kernel itself
is held to them on the card by ``tests/test_torch_cuda.py`` and by
``chip_smoke.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import flash_attention as j_flash_attention
from repro.kernels import flash_attention_ref as j_flash_attention_ref
from repro.kernels.flash_attn import flash_mha as j_flash_mha
from repro_torch.kernels import (flash_attention, flash_attention_plain,
                                 flash_mha, flash_mha_plain)

torch.set_num_threads(1)

SHAPES = [  # tests/test_flash_attn.py's: (B, L, H, KV, hd, qb, kb)
    (2, 64, 4, 2, 16, 32, 32),
    (1, 128, 8, 8, 64, 64, 32),
    (2, 96, 6, 2, 32, 32, 48),
    (1, 32, 2, 1, 16, 64, 32),     # q block straddles fold groups
    (1, 256, 2, 2, 128, 128, 128),
]


def _inputs(B, L, H, KV, hd, seed, S=None):
    rng = np.random.default_rng(seed)
    S = L if S is None else S
    return (rng.standard_normal((B, L, H, hd)).astype(np.float32),
            rng.standard_normal((B, S, KV, hd)).astype(np.float32),
            rng.standard_normal((B, S, KV, hd)).astype(np.float32))


@pytest.mark.parametrize("B,L,H,KV,hd,qb,kb", SHAPES)
@pytest.mark.parametrize("causal", [True, False])
def test_plain_matches_jax_kernel(B, L, H, KV, hd, qb, kb, causal):
    q, k, v = _inputs(B, L, H, KV, hd, B * 100 + L)
    want = j_flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             causal=causal, q_block=qb, kv_block=kb,
                             interpret=True)
    got = flash_attention(*map(torch.as_tensor, (q, k, v)), causal=causal,
                          q_block=qb, kv_block=kb)
    assert got.shape == (B, L, H * hd) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


def test_plain_bf16_matches_jax_kernel():
    q, k, v = (jnp.asarray(a, jnp.bfloat16)
               for a in _inputs(1, 64, 4, 2, 32, 0))
    want = j_flash_attention(q, k, v, q_block=32, kv_block=32,
                             interpret=True)
    tq, tk, tv = (torch.as_tensor(np.asarray(a, np.float32)).to(
        torch.bfloat16) for a in (q, k, v))
    got = flash_attention(tq, tk, tv, q_block=32, kv_block=32)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=5e-2,
                               atol=5e-2)


def test_folded_mha_matches_jax_kernel():
    """`flash_mha` on the folded layout with seq_len, as the GQA wrapper
    calls it: 3 query heads per KV head over 32 positions."""
    rng = np.random.default_rng(7)
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((2, 96, 32), (2, 32, 32), (2, 32, 32)))
    want = j_flash_mha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                       q_block=48, kv_block=16, interpret=True, seq_len=32)
    got = flash_mha(*map(torch.as_tensor, (q, k, v)), q_block=48,
                    kv_block=16, seq_len=32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


@pytest.mark.parametrize("causal", [True, False])
def test_plain_ragged_shape_matches_oracle(causal):
    """L = 50 with 16-row q tiles and 24-key tiles: the Pallas wrapper
    refuses it; the plain version ends in short tiles."""
    q, k, v = _inputs(2, 50, 6, 2, 32, 3)
    want = j_flash_attention_ref(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), causal=causal)
    got = flash_attention_plain(*map(torch.as_tensor, (q, k, v)),
                                causal=causal, q_block=16, kv_block=24)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


def test_tiles_do_not_change_the_result():
    """The plain version at other tiles, and with the q tile straddling
    fold groups, against itself: the exact skip drops only fully masked
    tiles."""
    q, k, v = map(torch.as_tensor, _inputs(1, 40, 4, 1, 16, 5))
    base = flash_attention_plain(q, k, v, q_block=40, kv_block=40)
    for qb, kb in ((7, 5), (16, 64), (160, 8)):
        got = flash_attention_plain(q, k, v, q_block=qb, kv_block=kb)
        torch.testing.assert_close(got, base, rtol=2e-6, atol=2e-6)


def test_wrappers_refuse_other_devices_and_layouts():
    """A tensor on neither the CPU nor a CUDA card is refused, not run
    through the plain version; so are strided views, mixed dtypes and
    head dims the kernel has no instance for."""
    m = torch.zeros((1, 8, 2, 16), device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        flash_attention(m, m[:, :, :1].contiguous(), m[:, :, :1].contiguous())
    with pytest.raises(ValueError, match="cpu or cuda"):
        flash_mha(m[0], m[0], m[0])
    q = torch.zeros((1, 8, 2, 16))
    kv = torch.zeros((1, 8, 1, 16))
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention(q.transpose(1, 2).contiguous().transpose(1, 2), kv,
                        kv)
    with pytest.raises(ValueError, match="dtype"):
        flash_attention(q, kv.to(torch.bfloat16), kv)
    with pytest.raises(ValueError, match="head_dim"):
        flash_attention(torch.zeros((1, 8, 2, 24)),
                        torch.zeros((1, 8, 1, 24)),
                        torch.zeros((1, 8, 1, 24)))
    with pytest.raises(ValueError, match="multiple of seq_len"):
        flash_mha(torch.zeros((1, 10, 16)), torch.zeros((1, 4, 16)),
                  torch.zeros((1, 4, 16)), seq_len=4)
    counts = lambda: (flash_mha.wgmma_launches, flash_mha.tf32_launches)
    before = counts()
    flash_attention(q, kv, kv)           # the CPU runs the plain version
    assert counts() == before
    assert torch.equal(flash_mha(q[0], q[0], q[0]),
                       flash_mha_plain(q[0], q[0], q[0]))
