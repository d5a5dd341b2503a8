"""The port's sliding-window attention and bf16 scores against the JAX
package, on the CPU: the plain flash versions and the attention's
gradient with a window, `attention.prefill` and `decode` with a window,
the LM families' `prefill_logits` and `lm_loss` with
``sliding_window``, and `_sdpa`'s ``scores_f32=False`` branch (decode,
the encdec's cross-attention).  Inputs are made from numpy seeds and
handed to both.

Tolerances, and why:

- float32: 1e-5 of the largest output (logit, gradient) magnitude: the
  same function in another summation order (the JAX reference runs a
  full masked softmax per query block, the port the online recurrence
  over key tiles).
- bfloat16: 5e-2 of the largest magnitude, the bound of
  ``tests/test_torch_lm.py``: the JAX model rounds its scores and
  softmax weights to bf16 where the flash path keeps them in float32,
  and the two frameworks round their bf16 products differently.  The
  bf16-score branch (``scores_f32=False``) is held to the same bound
  against JAX's bf16-score branch: both round the scores, the
  exponentials and the weights to bf16 at the same points.
- the attention's gradient: against autograd through
  `flash_attention_plain` within 1e-5 of max |g| at float32 and 2e-2
  at bf16 (each side rounds its output to bf16 once), as
  ``tests/test_torch_train.py`` holds the unwindowed one; against
  `jax.grad` of the reference's window-masked `_sdpa` per query block
  within 1e-5 at float32.
- a window of at least L keys masks nothing: bit for bit the call
  without one.
"""
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import lm as jlm
from repro.nn import attention as jattention
from repro.nn.core import split_params
from repro_torch import convert, prng
from repro_torch.configs import get_config
from repro_torch.kernels import (flash_attention, flash_attention_autograd,
                                 flash_attention_plain, flash_mha,
                                 flash_mha_plain)
from repro_torch.kernels.flash_attn import attention_vjp
from repro_torch.models import lm
from repro_torch.nn import attention
from repro_torch.tree import tree_leaves, tree_map

torch.set_num_threads(1)

TOL = {torch.float32: 1e-5, torch.bfloat16: 5e-2}
GRAD_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}
# (B, L, H, KV, hd, q_block, kv_block): G > 1, L ragged against both
# tiles, a q tile that straddles two fold groups
SHAPES = [(2, 333, 4, 2, 16, 64, 32), (1, 200, 6, 2, 32, 128, 48)]
B, L, W = 2, 96, 12       # the LM tests: 2 JAX query blocks of 64
ARCHS = ["qwen2-0.5b", "zamba2-7b", "seamless-m4t-medium", "llava-next-34b"]


def _gap(got: torch.Tensor, want) -> float:
    """max |got - want| / max |want|, in float32."""
    want = np.asarray(want, np.float32)
    return float(np.abs(got.float().detach().numpy() - want).max()
                 / np.abs(want).max())


def _qkv(shape, seed, dtype=torch.float32):
    b, l, h, kv, hd = shape[:5]
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal((b, l, n, hd)).astype(np.float32)
            for n in (h, kv, kv)]
    return arrs, [torch.tensor(a).to(dtype) for a in arrs]


def _jax_sdpa(arrs, window, causal, dtype, q_block=None):
    """The reference's `_sdpa` under `_causal_mask(..., window, causal)`,
    over the whole sequence or per query block of `q_block`."""
    q, k, v = (jnp.asarray(a).astype(JDT[dtype]) for a in arrs)
    b, l, h, hd = q.shape
    acfg = jattention.AttnConfig(d_model=h * hd, n_heads=h,
                                 n_kv_heads=k.shape[2], head_dim=hd,
                                 window=window, causal=causal)
    pos = jnp.broadcast_to(jnp.arange(l, dtype=jnp.int32)[None], (b, l))
    mask = jattention._causal_mask(pos, pos, window, causal)
    qb = q_block or l
    return jnp.concatenate([jattention._sdpa(q[:, q0:q0 + qb], k, v,
                                             mask[:, q0:q0 + qb], acfg)
                            for q0 in range(0, l, qb)], 1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("window", [1, 7, 100, "L"])
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_flash_window_matches_reference(shape, window, causal, dtype):
    """`flash_attention_plain(window=W)` and the CPU route of
    `flash_attention` against the reference's masked `_sdpa`."""
    W_ = shape[1] if window == "L" else window
    arrs, (q, k, v) = _qkv(shape, shape[1] + W_, dtype)
    qb, kb = shape[5:]
    got = flash_attention_plain(q, k, v, causal=causal, window=W_,
                                q_block=qb, kv_block=kb)
    assert got.dtype == dtype and got.shape == (shape[0], shape[1],
                                                shape[2] * shape[4])
    assert torch.equal(got, flash_attention(q, k, v, causal=causal,
                                            window=W_, q_block=qb,
                                            kv_block=kb))
    want = _jax_sdpa(arrs, W_, causal, dtype)
    assert _gap(got, want.astype(jnp.float32)) <= TOL[dtype]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", SHAPES)
def test_window_of_at_least_the_keys_is_bitwise_no_window(shape, dtype,
                                                          causal):
    """W >= max(L, S) masks nothing and skips no tile: the bits of no
    window."""
    _, (q, k, v) = _qkv(shape, 7, dtype)
    qb, kb = shape[5:]
    want = flash_attention_plain(q, k, v, causal=causal, q_block=qb,
                                 kv_block=kb)
    for w in (shape[1], shape[1] + 1, 10 ** 9):
        assert torch.equal(want, flash_attention_plain(
            q, k, v, causal=causal, window=w, q_block=qb, kv_block=kb))


@pytest.mark.parametrize("causal", [True, False])
def test_folded_flash_mha_window(causal):
    """`flash_mha` on the folded layout (3 heads folded over L = 50 in
    128-row tiles) against the model layout's result."""
    arrs, (q, k, v) = _qkv((1, 50, 3, 1, 16), 3)
    qf = q[0].permute(1, 0, 2).reshape(1, 150, 16)
    kf, vf = (t[:, :, 0].contiguous() for t in (k, v))
    got = flash_mha(qf, kf, vf, causal=causal, seq_len=50, window=9,
                    q_block=128, kv_block=32)
    assert torch.equal(got, flash_mha_plain(
        qf, kf, vf, causal=causal, seq_len=50, window=9, q_block=128,
        kv_block=32))
    want = _jax_sdpa(arrs, 9, causal, torch.float32)
    want = np.asarray(want).reshape(1, 50, 3, 16).transpose(0, 2, 1, 3)
    assert _gap(got, want.reshape(1, 150, 16)) <= 1e-5


@pytest.mark.parametrize("window", [0, -3, True, 2.0])
def test_window_must_be_a_positive_int(window):
    _, (q, k, v) = _qkv((1, 20, 2, 1, 16), 1)
    with pytest.raises(ValueError, match="window"):
        flash_attention(q, k, v, window=window)


def test_window_must_leave_every_row_a_key():
    """A position with no key in its window has no softmax: L < S + W."""
    rng = np.random.default_rng(0)
    q = torch.tensor(rng.standard_normal((1, 30, 2, 16)), dtype=torch.float32)
    kv = torch.tensor(rng.standard_normal((1, 10, 1, 16)),
                      dtype=torch.float32)
    with pytest.raises(ValueError, match="keeps none"):
        flash_attention(q, kv, kv, window=20)
    assert flash_attention(q, kv, kv, window=21).shape == (1, 30, 32)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window,qb", [(1, 32), (7, 32), (40, 64),
                                       (96, 512)])
def test_attention_vjp_window(window, qb, dtype, causal):
    """`flash_attention_autograd(window=W)`: its forward the bits of
    `flash_attention`, its gradient (`attention_vjp` over the keys each
    query block keeps) against autograd through the plain version and,
    at float32, `jax.grad` of the reference's window-masked `_sdpa` per
    query block."""
    shape = (2, 96, 4, 2, 32)
    arrs, ts = _qkv(shape, window + qb, dtype)
    ts = [t.requires_grad_() for t in ts]
    do = np.random.default_rng(5).standard_normal(
        (2, 96, 128)).astype(np.float32)
    tdo = torch.tensor(do).to(dtype)
    out = flash_attention_autograd(*ts, causal=causal, q_block=qb,
                                   window=window)
    with torch.no_grad():
        assert torch.equal(out, flash_attention(*ts, causal=causal,
                                                q_block=qb, window=window))
    got = torch.autograd.grad(out, ts, tdo)
    plain = torch.autograd.grad(flash_attention_plain(
        *ts, causal=causal, q_block=qb, kv_block=32, window=window), ts, tdo)
    for g, p in zip(got, plain):
        assert g.dtype == dtype and torch.isfinite(g).all()
        scale = max(float(p.float().abs().max()), 1e-30)
        assert float((g.float() - p.float()).abs().max()) <= (
            GRAD_TOL[dtype] * scale)
    if dtype == torch.bfloat16:
        return
    want = jax.grad(lambda *x: jnp.sum(_jax_sdpa(
        x, window, causal, dtype, q_block=qb) * jnp.asarray(do)),
        argnums=(0, 1, 2))(*[jnp.asarray(a) for a in arrs])
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert np.abs(g.numpy() - w).max() <= 1e-5 * max(np.abs(w).max(),
                                                          1e-30)


def test_attention_vjp_reads_only_the_window(monkeypatch):
    """A windowed backward multiplies each query block by the keys its
    rows keep, not by all L: the score blocks it forms have at most
    q_block + W - 1 keys (causal) or q_block + 2 W - 2 (bidirectional)."""
    seen = []
    real = torch.softmax

    def spy(x, dim=-1, **kw):
        seen.append(x.shape[-1])
        return real(x, dim=dim, **kw)

    monkeypatch.setattr(torch, "softmax", spy)
    _, (q, k, v) = _qkv((1, 400, 2, 1, 16), 4)
    do = torch.ones(1, 400, 32)
    for causal, most in ((True, 64 + 20 - 1), (False, 64 + 2 * 20 - 2)):
        seen.clear()
        attention_vjp(q, k, v, do, causal=causal, q_block=64, window=20)
        assert seen and max(seen) <= most


# -- attention.prefill and decode against the reference ------------------

def _attn_setup(window, causal=True, scores_f32=True, dtype=torch.float32,
                q_block=32, impl="blocked"):
    kw = dict(d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
              qkv_bias=True, window=window, causal=causal, q_block=q_block,
              scores_f32=scores_f32, kv_block=32)
    jcfg = jattention.AttnConfig(impl=impl, **kw)
    cfg = attention.AttnConfig(**kw)
    jp = jax.device_get(split_params(jattention.init(
        jax.random.PRNGKey(3), jcfg, dtype=JDT[dtype]))[0])
    return cfg, jcfg, jp, convert.params_from_jax(jp)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("impl", ["blocked", "online"])
@pytest.mark.parametrize("window", [5, 40])
def test_prefill_window_matches_reference(window, impl, causal):
    """L = 90 > q_block = 32: JAX scans three query blocks (its online
    impl also blocks the keys), the port runs the plain flash version."""
    cfg, jcfg, jp, tp = _attn_setup(window, causal, impl=impl)
    x = np.random.default_rng(window).standard_normal(
        (2, 90, 64)).astype(np.float32)
    pos = np.broadcast_to(np.arange(90, dtype=np.int32)[None], (2, 90))
    want = jattention.prefill(jp, jnp.asarray(x), jnp.asarray(pos), jcfg)
    got = attention.prefill(tp, torch.tensor(x), torch.tensor(pos), cfg)
    assert _gap(got, want) <= 1e-5


def _cache_pair(B_, S, seed, dtype):
    rng = np.random.default_rng(seed)
    k, v = (rng.standard_normal((B_, S, 2, 16)).astype(np.float32)
            for _ in "kv")
    jc = {"k": jnp.asarray(k).astype(JDT[dtype]),
          "v": jnp.asarray(v).astype(JDT[dtype]),
          "pos": jnp.zeros((B_,), jnp.int32)}
    tc = {"k": torch.tensor(k).to(dtype), "v": torch.tensor(v).to(dtype),
          "pos": torch.zeros((B_,), dtype=torch.int32)}
    return jc, tc


@pytest.mark.parametrize("scores_f32,dtype", [
    (True, torch.float32), (False, torch.float32), (False, torch.bfloat16)])
def test_windowed_decode_wraps_the_ring(scores_f32, dtype):
    """20 steps through a ring cache of W = 6 slots (the slot wraps three
    times), each step's output and the cache against the reference's."""
    cfg, jcfg, jp, tp = _attn_setup(6, scores_f32=scores_f32, dtype=dtype)
    jc, tc = _cache_pair(2, 6, 11, dtype)
    xs = np.random.default_rng(12).standard_normal(
        (20, 2, 1, 64)).astype(np.float32)
    for t in range(20):
        want, jc = jattention.decode(jp, jnp.asarray(xs[t]).astype(
            JDT[dtype]), jc, jcfg)
        got, tc = attention.decode(tp, torch.tensor(xs[t]).to(dtype), tc,
                                   cfg)
        assert _gap(got, want.astype(jnp.float32)) <= TOL[dtype], t
    assert tc["pos"].tolist() == [20, 20]
    for name in "kv":
        assert _gap(tc[name], jc[name].astype(jnp.float32)) <= TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("masked", [False, True])
def test_sdpa_bf16_scores_match_reference(masked, dtype):
    """`_sdpa` at ``scores_f32=False`` against the reference's branch,
    with a random mask (every row keeps a key) or none."""
    cfg, jcfg, _, _ = _attn_setup(None, scores_f32=False)
    rng = np.random.default_rng(21)
    q, k, v = (rng.standard_normal((2, n, h, 16)).astype(np.float32)
               for n, h in ((9, 4), (15, 2), (15, 2)))
    mask = rng.random((2, 9, 15)) < 0.5 if masked else np.ones(
        (2, 9, 15), bool)
    mask[:, :, 0] = True
    want = jattention._sdpa(*(jnp.asarray(a).astype(JDT[dtype])
                              for a in (q, k, v)), jnp.asarray(mask), jcfg)
    got = attention._sdpa(*(torch.tensor(a).to(dtype) for a in (q, k, v)),
                          torch.tensor(mask), cfg)
    assert got.dtype == dtype
    assert _gap(got, want.astype(jnp.float32)) <= TOL[dtype]


# -- the LM families ------------------------------------------------------

def _lm_configs(arch, cdt, **kw):
    kw = {"param_dtype": "float32", "compute_dtype": cdt, **kw}
    return (get_config(arch).reduced().with_(**kw),
            j_get_config(arch).reduced().with_(**kw))


@functools.lru_cache(maxsize=None)
def _jax_params(arch):
    _, jcfg = _lm_configs(arch, "float32")
    return jax.device_get(split_params(jlm.init_params(
        jax.random.PRNGKey(0), jcfg))[0])


def _lm_batch(cfg, seed=1, labels=False):
    rng = np.random.default_rng(seed)
    b = {"tokens": rng.integers(0, cfg.vocab, (B, L)).astype(np.int32)}
    if labels:
        b["labels"] = rng.integers(0, cfg.vocab, (B, L)).astype(np.int32)
    if cfg.family == "vlm":
        b["patch_embeds"] = rng.standard_normal(
            (B, cfg.n_patches, cfg.d_model)).astype(np.float32)
    if cfg.family == "encdec":
        b["src_frames"] = rng.standard_normal(
            (B, cfg.enc_src_frames, cfg.d_model)).astype(np.float32)
    ints = ("tokens", "labels")
    jb = {k: jnp.asarray(a) if k in ints else
          jnp.asarray(a).astype(jnp.dtype(cfg.compute_dtype))
          for k, a in b.items()}
    tb = {k: torch.as_tensor(a) if k in ints else
          torch.as_tensor(a).to(cfg.cdt()) for k, a in b.items()}
    return jb, tb


@pytest.mark.parametrize("cdt", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_logits_with_window(arch, cdt):
    """dense, hybrid (the shared attention), encdec (a bidirectional
    windowed encoder over 16 frames, W = 12) and vlm (patches and tokens
    in one window) with ``sliding_window`` = 12 < L = 96."""
    cfg, jcfg = _lm_configs(arch, cdt, sliding_window=W)
    jb, tb = _lm_batch(cfg)
    jp = _jax_params(arch)
    want = np.asarray(jlm.prefill_logits(jp, jb, jcfg))
    got = lm.prefill_logits(convert.params_from_jax(jp), tb, cfg)
    assert got.shape == want.shape and got.dtype == torch.float32
    assert _gap(got, want) <= TOL[getattr(torch, cdt)]


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "seamless-m4t-medium",
                                  "llava-next-34b"])
def test_lm_loss_and_gradient_with_window(arch):
    """`lm_loss` and its gradient with ``sliding_window`` = 12 at float32
    compute: the loss to 1e-5, each leaf within 1e-5 of max |g|."""
    cfg, jcfg = _lm_configs(arch, "float32", sliding_window=W)
    jb, tb = _lm_batch(cfg, labels=True)
    jp = _jax_params(arch)
    (j_loss, _), jg = jax.jit(jax.value_and_grad(
        lambda p: jlm.lm_loss(p, jb, jcfg, loss_block=40),
        has_aux=True))(jp)
    want = [np.asarray(g) for g in jax.tree.leaves(jg)]
    tp = tree_map(lambda t: t.requires_grad_(), convert.params_from_jax(jp))
    loss, _ = lm.lm_loss(tp, tb, cfg, loss_block=40)
    paths, leaves = zip(*tree_leaves(tp))
    got = torch.autograd.grad(loss, leaves)
    assert abs(float(loss.detach()) - float(j_loss)) <= 1e-5 * abs(
        float(j_loss))
    assert len(got) == len(want)
    g_max = max(np.abs(w).max() for w in want)
    for p, g, w in zip(paths, got, want):
        assert tuple(g.shape) == w.shape, p
        assert np.abs(g.numpy() - w).max() <= 1e-5 * g_max, p


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "seamless-m4t-medium"])
def test_bf16_scores_prefill_and_decode_step(arch):
    """``scores_f32=False`` at bf16 compute: `prefill_logits` (the
    port's flash prefill against the reference's bf16-score prefill; the
    encdec's cross-attention through the bf16-score `_sdpa` on both
    sides) and a `decode_step` from random caches (bf16-score `_sdpa`
    on both sides), within 5e-2 of max |logit|."""
    cfg, jcfg = _lm_configs(arch, "bfloat16", scores_f32=False)
    jb, tb = _lm_batch(cfg)
    jp = _jax_params(arch)
    tp = convert.params_from_jax(jp)
    want = np.asarray(jlm.prefill_logits(jp, jb, jcfg))
    assert _gap(lm.prefill_logits(tp, tb, cfg), want) <= 5e-2

    S, pos = 40, 25
    rng = np.random.default_rng(4)
    shape = (cfg.n_layers, B, S, cfg.n_kv_heads, cfg.head_dim)
    k, v = (rng.standard_normal(shape).astype(np.float32) for _ in "kv")
    jc = jlm.init_decode_cache(jcfg, B, S)
    tc = lm.init_decode_cache(cfg, B, S)
    jc["attn"] = {"k": jnp.asarray(k).astype(jnp.bfloat16),
                  "v": jnp.asarray(v).astype(jnp.bfloat16),
                  "pos": jnp.full((cfg.n_layers, B), pos, jnp.int32)}
    tc["attn"] = {"k": torch.tensor(k).to(torch.bfloat16),
                  "v": torch.tensor(v).to(torch.bfloat16),
                  "pos": torch.full((cfg.n_layers, B), pos,
                                    dtype=torch.int32)}
    if "enc_out" in tc:
        enc = rng.standard_normal(tuple(tc["enc_out"].shape)).astype(
            np.float32)
        jc["enc_out"] = jnp.asarray(enc).astype(jnp.bfloat16)
        tc["enc_out"] = torch.tensor(enc).to(torch.bfloat16)
    tok = np.asarray(jb["tokens"])[:, :1].copy().copy()
    want, _ = jlm.decode_step(jp, jc, {"tokens": jnp.asarray(tok)}, jcfg)
    got, _ = lm.decode_step(tp, tc, {"tokens": torch.as_tensor(tok)}, cfg)
    assert _gap(got, np.asarray(want)) <= 5e-2


def test_window_and_bf16_scores_run_where_they_raised():
    """Both options reach prefill, decode and `lm_loss` through the
    model's own entry points and give finite values of the right shape
    (they raised NotImplementedError before the window was ported)."""
    cfg = get_config("qwen2-0.5b").reduced().with_(compute_dtype="float32",
                                                   param_dtype="float32")
    params = lm.init_params(prng.PRNGKey(0), cfg)
    toks = {"tokens": torch.zeros((1, 8), dtype=torch.int32)}
    batch = {**toks, "labels": toks["tokens"]}
    for c in (cfg.with_(sliding_window=4), cfg.with_(scores_f32=False)):
        assert torch.isfinite(lm.prefill_logits(params, toks, c)).all()
        loss, _ = lm.lm_loss(params, batch, c, loss_block=8)
        assert math.isfinite(float(loss))
        cache = lm.init_decode_cache(c, 1, 8, window=c.sliding_window)
        logits, _ = lm.decode_step(params, cache, {"tokens": toks["tokens"][
            :, :1]}, c, window=c.sliding_window)
        assert logits.shape == (1, cfg.vocab)
        assert torch.isfinite(logits).all()
