"""The port's training pieces against the JAX package, on the CPU:
`models.lm.lm_loss` and its gradient for every family, the attention's
gradient route (`kernels.flash_attn.flash_attention_autograd`), remat,
the optimizers, `data.lm_corpus` and `prng.fold_in`.

Tolerances, and why:

- `lm_loss` and its gradient on the same converted weights (reduced
  configs, B 2, L 96, loss blocks of 40 positions, so the ragged tail of
  16 positions carries no loss): the loss to rtol 1e-5 at float32
  compute and 5e-3 at bf16; the gradient, leaf by leaf, within 1e-5 of
  the tree's max |g| at float32 and 5e-2 at bf16.  The exceptions:
  - zamba2-7b (the hybrid) at float32, within 2e-5: its embedding
    table's gradient, carried back through both SSD scans and the shared
    block twice, lies 1.27e-5 from JAX's (every other leaf within
    2.9e-6), and as far with the attention's gradient taken by autograd
    through the plain version, so it is the SSD's summation order (the
    forward's logits agree within 1e-5);
  - zamba2-7b's embedding table at bf16, by name (`BF16_SPREAD_HELD`),
    within JAX's own bf16-vs-float32 spread of that leaf: measured at
    this seed, of max |g|, port vs JAX 0.087 where JAX's bf16 lies 0.217
    from its float32 (every other leaf of every non-moe family within
    0.041 of JAX's);
  - the MoE at bf16, route by route: a top-k route parts from the other
    framework's at near ties (as ``tests/test_torch_lm_families.py``
    finds for the forward; here 1 to 5 of 192 tokens a layer), and a
    parted token sends its whole gradient to another expert.  So the
    gradient is held where the routes agree: each side's routes and
    drops are read layer by layer on its own activations, at most 3% of
    a layer's tokens may part, and the gradient of the CE over each
    row's leading positions whose experts and drops agree with JAX's in
    every layer (causal attention and a per-token combine carry no
    gradient to any other token's computation) is held leaf by leaf
    within 5e-2 (measured at this seed: 80 and 112 of 192 positions,
    qwen3-moe within 0.018 of max |g|, arctic within 0.021).  The
    load-balance term, which sums over every token,
    is left out of that gradient; its gradient is held at float32, where
    every route agrees, and the loss it adds at bf16 as above.
- remat on against off, port against port: bit for bit (the same ops on
  the same inputs, run again).
- the attention's gradient: against autograd through
  `flash_attention_plain` (the same function in another order) within
  1e-5 of max |g| at float32 and 2e-2 at bf16 (each side rounds its
  output to bf16 once); against `jax.grad` of the reference's `_sdpa`
  per query block within 1e-5 and 5e-2 (JAX rounds scores and weights to
  bf16).
- optimizers: within 1e-6 of max |update| (elementwise float32), the
  moments within the same of their largest value; at Adam's b2 = 0.999
  within 5e-5, since its bias correction ``1 - b2**t`` cancels: the two
  frameworks' ``b2**t`` may differ by an ULP, 3e-5 of ``1 - b2**t`` at
  t = 2 (AdamW's b2 = 0.95 keeps that under 1e-6).
- `lm_corpus` and `fold_in`: bit for bit.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.data import lm_corpus as j_lm_corpus
from repro.models import lm as jlm
from repro.nn import attention as jattention
from repro.nn import core as jcore
from repro.nn import mlp as jmlp
from repro.nn.core import split_params
from repro.optim import optimizers as jopt
from repro_torch import convert, prng
from repro_torch.configs import get_config
from repro_torch.data import lm_corpus
from repro_torch.kernels import (flash_attention, flash_attention_autograd,
                                 flash_attention_plain)
from repro_torch.models import lm
from repro_torch.nn import attention, core, mlp
from repro_torch.optim import optimizers as opt
from repro_torch.tree import tree_leaves, tree_map
from test_torch_lm_families import _jax_route

torch.set_num_threads(1)

B, L, LOSS_BLOCK = 2, 96, 40
ARCHS = ["qwen2-0.5b", "qwen3-moe-235b-a22b", "arctic-480b", "mamba2-780m",
         "zamba2-7b", "seamless-m4t-medium", "llava-next-34b"]
TOL = {"float32": 1e-5, "bfloat16": 5e-2}
LOSS_RTOL = {"float32": 1e-5, "bfloat16": 5e-3}
F32_TOL = {"zamba2-7b": 2e-5}
# at bf16, held within JAX's own bf16-vs-float32 spread of the leaf
BF16_SPREAD_HELD = {("zamba2-7b", ("embed", "table"))}
# the share of tokens a bf16 MoE layer may route apart from JAX's
MOE_BF16_PARTED = 0.03


def _configs(arch, cdt, **kw):
    kw = {"param_dtype": "float32", "compute_dtype": cdt, **kw}
    return (get_config(arch).reduced().with_(**kw),
            j_get_config(arch).reduced().with_(**kw))


@functools.lru_cache(maxsize=None)
def _jax_params(arch):
    _, jcfg = _configs(arch, "float32")
    return jax.device_get(split_params(jlm.init_params(
        jax.random.PRNGKey(0), jcfg))[0])


def _batch(cfg, seed=1):
    rng = np.random.default_rng(seed)
    b = {"tokens": rng.integers(0, cfg.vocab, (B, L)).astype(np.int32),
         "labels": rng.integers(0, cfg.vocab, (B, L)).astype(np.int32)}
    if cfg.family == "vlm":
        b["patch_embeds"] = rng.standard_normal(
            (B, cfg.n_patches, cfg.d_model)).astype(np.float32)
    if cfg.family == "encdec":
        b["src_frames"] = rng.standard_normal(
            (B, cfg.enc_src_frames, cfg.d_model)).astype(np.float32)
    ints = ("tokens", "labels")
    jb = {k: jnp.asarray(v) if k in ints else
          jnp.asarray(v).astype(jnp.dtype(cfg.compute_dtype))
          for k, v in b.items()}
    tb = {k: torch.as_tensor(v) if k in ints else
          torch.as_tensor(v).to(cfg.cdt()) for k, v in b.items()}
    return jb, tb


@functools.lru_cache(maxsize=None)
def _jax_loss_and_grad(arch, cdt, weighted=False):
    cfg, jcfg = _configs(arch, cdt)
    jb, _ = _batch(cfg)
    w = jnp.asarray([0.3, 0.7], jnp.float32) if weighted else None
    fn = jax.jit(jax.value_and_grad(
        lambda p: jlm.lm_loss(p, jb, jcfg, loss_block=LOSS_BLOCK,
                              example_weights=w), has_aux=True))
    (loss, metrics), g = fn(_jax_params(arch))
    return (float(loss), float(metrics["ce"]),
            [np.asarray(x, np.float32) for x in jax.tree.leaves(g)])


def _port_loss_and_grad(arch, cdt, weighted=False, **cfg_kw):
    cfg, _ = _configs(arch, cdt, **cfg_kw)
    _, tb = _batch(cfg)
    tp = tree_map(lambda t: t.requires_grad_(),
                  convert.params_from_jax(_jax_params(arch)))
    w = torch.tensor([0.3, 0.7]) if weighted else None
    loss, metrics = lm.lm_loss(tp, tb, cfg, loss_block=LOSS_BLOCK,
                               example_weights=w)
    paths, leaves = zip(*tree_leaves(tp))
    grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), metrics, [g.float().numpy() for g in grads], paths


def _moe_clean_prefix(arch, cdt):
    """Each row's leading positions whose experts and drops agree with
    JAX's in every layer, each model run layer by layer on its own
    activations (as ``tests/test_torch_lm_families.py`` reads them)."""
    cfg, jcfg = _configs(arch, cdt)
    jp = _jax_params(arch)
    tp = convert.params_from_jax(jp)
    jb, tb = _batch(cfg)
    jx, jpos = jlm._embed_inputs(jp, jb, jcfg)
    tx, tpos = lm._embed_inputs(tp, tb, cfg)
    jacfg, tacfg = jlm._attn_cfg(jcfg), lm._attn_cfg(cfg)
    jmcfg, mcfg = jlm._moe_cfg(jcfg), lm._moe_cfg(cfg)
    cap = mlp.capacity(mcfg, B * L)
    clean = np.full(B, L)
    with torch.no_grad():
        for i in range(cfg.n_layers):
            jl = jax.tree.map(lambda a: a[i], jp["layers"])
            tl = lm._at(tp["layers"], i)
            jx = jx + jattention.prefill(
                jl["attn"], jcore.rmsnorm(jl["ln1"], jx), jpos, jacfg)
            tx = tx + attention.prefill(
                tl["attn"], core.rmsnorm(tl["ln1"], tx), tpos, tacfg)
            jin = jcore.rmsnorm(jl["ln2"], jx)
            tin = core.rmsnorm(tl["ln2"], tx)
            _, j_e, j_keep, _ = _jax_route(jl["moe"], jin, jmcfg, cap)
            r = mlp.route(tl["moe"], tin.reshape(1, -1, cfg.d_model), mcfg,
                          cap)
            diff = (r["top_e"][0].numpy() != j_e).any(-1).reshape(B, L)
            assert diff.mean() <= MOE_BF16_PARTED
            diff |= (r["keep"][0].numpy() != j_keep).reshape(
                B, L, -1).any(-1)
            clean = np.minimum(clean, np.where(diff.any(-1),
                                               diff.argmax(-1), L))
            jx = jx + jmlp.moe(jl["moe"], jin, jmcfg)[0]
            tx = tx + mlp.moe(tl["moe"], tin, mcfg)[0]
    return clean


def _hold_moe_gradient_by_route(arch, cdt):
    """The gradient of the CE over each row's clean leading positions
    (`_moe_clean_prefix`), both models' backbones and heads, leaf by
    leaf within TOL of max |g|."""
    clean = _moe_clean_prefix(arch, cdt)
    assert clean.sum() > 0
    mask = (np.arange(L)[None, :] < clean[:, None]).astype(np.float32)
    cfg, jcfg = _configs(arch, cdt)
    jb, tb = _batch(cfg)
    jp = _jax_params(arch)

    def jfn(p):
        h = jlm.backbone(p, jb, jcfg)[0]
        logits = (h @ p["lm_head"]["w"].astype(h.dtype)).astype(jnp.float32)
        ce = jax.nn.logsumexp(logits, -1) - jnp.take_along_axis(
            logits, jb["labels"][..., None], -1)[..., 0]
        return jnp.sum(ce * mask) / mask.sum()

    want = [np.asarray(x, np.float32)
            for x in jax.tree.leaves(jax.jit(jax.grad(jfn))(jp))]
    tp = tree_map(lambda t: t.requires_grad_(), convert.params_from_jax(jp))
    h = lm.backbone(tp, tb, cfg)[0]
    logits = (h @ tp["lm_head"]["w"].to(h.dtype)).float()
    ce = torch.logsumexp(logits, -1) - torch.gather(
        logits, -1, tb["labels"][..., None].long())[..., 0]
    loss = torch.sum(ce * torch.as_tensor(mask)) / float(mask.sum())
    paths, leaves = zip(*tree_leaves(tp))
    got = torch.autograd.grad(loss, leaves)
    assert len(got) == len(want)
    g_max = max(np.abs(w).max() for w in want)
    for p, g, w in zip(paths, got, want):
        assert tuple(g.shape) == w.shape, p
        assert np.abs(g.float().numpy() - w).max() <= TOL[cdt] * g_max, p


@pytest.mark.parametrize("cdt", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_lm_loss_and_gradient_match_reference(arch, cdt):
    loss, metrics, got, paths = _port_loss_and_grad(arch, cdt)
    j_loss, j_ce, want = _jax_loss_and_grad(arch, cdt)
    assert abs(float(loss) - j_loss) <= LOSS_RTOL[cdt] * abs(j_loss)
    assert abs(float(metrics["ce"]) - j_ce) <= LOSS_RTOL[cdt] * abs(j_ce)
    assert not metrics["ce"].requires_grad
    assert len(got) == len(want)
    if cdt == "bfloat16" and get_config(arch).family == "moe":
        _hold_moe_gradient_by_route(arch, cdt)
        return
    g_max = max(np.abs(w).max() for w in want)
    tol = F32_TOL.get(arch, TOL[cdt]) if cdt == "float32" else TOL[cdt]
    for i, (p, g, w) in enumerate(zip(paths, got, want)):
        assert g.shape == w.shape, p
        bound = tol
        if cdt == "bfloat16" and (arch, p) in BF16_SPREAD_HELD:
            f = _jax_loss_and_grad(arch, "float32")[2][i]
            bound = np.abs(w - f).max() / g_max
        assert np.abs(g - w).max() / g_max <= bound, p


def test_example_weights_match_reference():
    loss, _, got, _ = _port_loss_and_grad("qwen2-0.5b", "float32", True)
    j_loss, _, want = _jax_loss_and_grad("qwen2-0.5b", "float32", True)
    assert abs(float(loss) - j_loss) <= 1e-5 * abs(j_loss)
    g_max = max(np.abs(w).max() for w in want)
    assert max(np.abs(g - w).max() for g, w in zip(got, want)) <= 1e-5 * g_max
    # the unweighted mean is the weights 1/B, up to rounding
    unw = _port_loss_and_grad("qwen2-0.5b", "float32")[0]
    cfg, _ = _configs("qwen2-0.5b", "float32")
    _, tb = _batch(cfg)
    tp = convert.params_from_jax(_jax_params("qwen2-0.5b"))
    half = lm.lm_loss(tp, tb, cfg, loss_block=LOSS_BLOCK,
                      example_weights=torch.full((B,), 1.0 / B))[0]
    assert abs(float(half) - float(unw)) <= 1e-6 * float(unw)


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "zamba2-7b:tail",
                                  "seamless-m4t-medium"])
def test_remat_is_bitwise_the_plain_backward(arch):
    """Port against port; the hybrid cut with a tail (2 groups of 3 Mamba2
    layers and the shared block, 1 more) remats groups and tail layers."""
    name, _, cut = arch.partition(":")
    kw = dict(n_layers=7, shared_attn_every=3) if cut else {}
    cfg, _ = _configs(name, "float32", **kw)
    _, tb = _batch(cfg)
    params = lm.init_params(prng.PRNGKey(0), cfg)
    outs = []
    for remat in (False, True):
        tp = tree_map(lambda t: t.clone().requires_grad_(), params)
        loss, _ = lm.lm_loss(tp, tb, cfg.with_(remat=remat),
                             loss_block=LOSS_BLOCK)
        outs.append((loss.detach(), torch.autograd.grad(
            loss, [t for _, t in tree_leaves(tp)])))
    assert torch.equal(outs[0][0], outs[1][0])
    for a, b in zip(outs[0][1], outs[1][1]):
        assert torch.equal(a, b)


def test_remat_runs_the_attention_forward_twice(monkeypatch):
    cfg, _ = _configs("qwen2-0.5b", "float32")
    _, tb = _batch(cfg)
    tp = tree_map(lambda t: t.requires_grad_(),
                  convert.params_from_jax(_jax_params("qwen2-0.5b")))
    calls = []
    real = flash_attention

    def counted(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr("repro_torch.kernels.flash_attn.flash_attention",
                        counted)
    for remat, want in ((False, cfg.n_layers), (True, 2 * cfg.n_layers)):
        calls.clear()
        loss, _ = lm.lm_loss(tp, tb, cfg.with_(remat=remat))
        loss.backward()
        assert len(calls) == want


def test_loss_blocks_and_the_ragged_tail():
    """L // loss_block blocks; positions past them carry no loss, and one
    block of all L positions gives the plain per-token mean."""
    cfg, _ = _configs("qwen2-0.5b", "float32")
    _, tb = _batch(cfg)
    tp = convert.params_from_jax(_jax_params("qwen2-0.5b"))
    with torch.no_grad():
        hidden, _ = lm.backbone(tp, tb, cfg)
        logits = (hidden @ tp["lm_head"]["w"]).float()
        ce = (torch.logsumexp(logits, -1) - torch.gather(
            logits, -1, tb["labels"][..., None].long())[..., 0])
        for lb, n in ((L, L), (LOSS_BLOCK, 80), (500, L)):
            loss, m = lm.lm_loss(tp, tb, cfg, loss_block=lb)
            want = ce[:, :n].mean()
            assert abs(float(loss) - float(want)) <= 1e-6 * float(want)
            assert float(m["aux"]) == 0.0


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("L,H,KV,hd,qb", [(96, 4, 2, 32, 32),
                                          (70, 4, 4, 16, 64),
                                          (40, 6, 2, 64, 512)])
def test_attention_gradient(L, H, KV, hd, qb, dtype, causal):
    rng = np.random.default_rng(L + H)
    arrs = [rng.standard_normal((2, L, n, hd)).astype(np.float32)
            for n in (H, KV, KV)]
    do = rng.standard_normal((2, L, H * hd)).astype(np.float32)
    ts = [torch.tensor(a).to(dtype).requires_grad_() for a in arrs]
    tdo = torch.tensor(do).to(dtype)
    out = flash_attention_autograd(*ts, causal=causal, q_block=qb)
    with torch.no_grad():
        assert torch.equal(out, flash_attention(*ts, causal=causal,
                                                q_block=qb))
    got = torch.autograd.grad(out, ts, tdo)
    plain = torch.autograd.grad(
        flash_attention_plain(*ts, causal=causal, q_block=qb, kv_block=32),
        ts, tdo)
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    for g, p in zip(got, plain):
        assert g.dtype == dtype
        assert float((g.float() - p.float()).abs().max()) <= tol * float(
            p.float().abs().max())
    # the reference's gradient: _sdpa per query block under jax.checkpoint
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    acfg = jattention.AttnConfig(d_model=H * hd, n_heads=H, n_kv_heads=KV,
                                 head_dim=hd, q_block=qb, causal=causal)

    def jfn(q, k, v):
        pos = jnp.broadcast_to(jnp.arange(L, dtype=jnp.int32)[None], (2, L))
        mask = jattention._causal_mask(pos, pos, None, causal)
        outs = []
        for q0 in range(0, L, qb):
            body = jax.checkpoint(lambda qi, mi: jattention._sdpa(
                qi, k, v, mi, acfg))
            outs.append(body(q[:, q0:q0 + qb], mask[:, q0:q0 + qb]))
        return jnp.sum(jnp.concatenate(outs, 1).astype(jnp.float32)
                       * jnp.asarray(do))

    want = jax.grad(jfn, argnums=(0, 1, 2))(
        *[jnp.asarray(a).astype(jdt) for a in arrs])
    tol = 1e-5 if dtype == torch.float32 else 5e-2
    for g, w in zip(got, want):
        w = np.asarray(w.astype(jnp.float32))
        assert np.abs(g.float().numpy() - w).max() <= tol * np.abs(w).max()


def test_serving_and_training_launch_the_same_kernel_calls(monkeypatch):
    """Prefill's attention is the kernel wrapper, once a layer, whether
    autograd records (training) or not (serving, with grad disabled or
    with nothing that requires grad), with the same output bits; remat
    (`test_remat_runs_the_attention_forward_twice`) adds the recompute."""
    calls = []
    real = flash_attention
    monkeypatch.setattr("repro_torch.kernels.flash_attn.flash_attention",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    cfg, _ = _configs("qwen2-0.5b", "float32")
    _, tb = _batch(cfg)
    tp = convert.params_from_jax(_jax_params("qwen2-0.5b"))
    with torch.no_grad():
        off = lm.prefill_logits(tp, tb, cfg)
    on = lm.prefill_logits(tp, tb, cfg.with_(remat=True))
    assert torch.equal(off, on) and len(calls) == 2 * cfg.n_layers
    calls.clear()
    lm.lm_loss(tree_map(lambda t: t.requires_grad_(), tp), tb,
               cfg)[0].backward()
    assert len(calls) == cfg.n_layers


def _opt_inputs(seed, zero_share=0.0):
    rng = np.random.default_rng(seed)
    mk = lambda *s: rng.standard_normal(s).astype(np.float32)
    params = {"a": mk(5, 7), "b": {"c": mk(11)}}
    grads = {"a": mk(5, 7), "b": {"c": mk(11)}}
    grads["a"][rng.random((5, 7)) < zero_share] = 0.0
    return params, grads


def _close(got, want, rel=1e-6):
    for (p, g), (_, w) in zip(tree_leaves(got), tree_leaves(want)):
        w = np.asarray(w, np.float32)
        g = g.float().numpy()
        assert g.shape == w.shape, p
        assert np.abs(g - w).max() <= rel * max(np.abs(w).max(), 1e-30), p


@pytest.mark.parametrize("name,kw", [
    ("sgd", dict(lr=0.1)),
    ("momentum", dict(lr=0.1, beta=0.9)),
    ("adam", dict(lr=1e-3)),
    ("adam", dict(lr=1e-3, moment_dtype="bfloat16")),
    ("adamw", dict(lr=2e-3, weight_decay=0.1)),
    ("adamw", dict(lr=3e-4, weight_decay=0.0)),
    ("adamw", dict(lr=2e-3, weight_decay=0.1, moment_dtype="bfloat16")),
])
def test_optimizers_match_reference(name, kw):
    """Three updates from the same inputs, a third of one leaf's
    gradients zero (the entries Adam moves by rounding noise alone)."""
    md = kw.pop("moment_dtype", None)
    jkw = dict(kw, **({"moment_dtype": jnp.bfloat16} if md else {}))
    tkw = dict(kw, **({"moment_dtype": torch.bfloat16} if md else {}))
    jo, to = getattr(jopt, name)(**jkw), getattr(opt, name)(**tkw)
    params, _ = _opt_inputs(0)
    tp = convert.params_from_jax(params)
    js, ts = jo.init(params), to.init(tp)
    for step in range(3):
        _, grads = _opt_inputs(step + 1, zero_share=0.3)
        ju, js = jo.update(grads, js, params, jnp.asarray(step, jnp.int32))
        tu, ts = to.update(convert.params_from_jax(grads), ts, tp,
                           torch.tensor(step, dtype=torch.int32))
        rel = 5e-5 if name == "adam" else 1e-6
        _close(tu, ju, rel)
        if js:
            _close(ts, js)
            if md:
                assert all(t.dtype == torch.bfloat16
                           for _, t in tree_leaves(ts))
        params = jopt.apply_updates(params, ju)
        tp = opt.apply_updates(tp, tu)


def test_global_norm_and_clip_match_reference():
    _, grads = _opt_inputs(4)
    tg = convert.params_from_jax(grads)
    assert abs(float(opt.global_norm(tg))
               - float(jopt.global_norm(grads))) <= 1e-6 * float(
        jopt.global_norm(grads))
    for max_norm in (0.5, 1e3):
        jc, jn = jopt.clip_by_global_norm(grads, max_norm)
        tc, tn = opt.clip_by_global_norm(tg, max_norm)
        assert abs(float(tn) - float(jn)) <= 1e-6 * float(jn)
        _close(tc, jc)


@pytest.mark.parametrize("seed,n,vocab", [(0, 20_000, 8192), (3, 5_000, 97)])
def test_lm_corpus_is_bitwise_the_reference(seed, n, vocab):
    got = lm_corpus(seed, n_tokens=n, vocab=vocab)
    want = j_lm_corpus(seed, n_tokens=n, vocab=vocab)
    assert got.dtype == want.dtype == np.int32
    assert np.array_equal(got, want)


@pytest.mark.parametrize("data", [17, 10_007, 0, 1, 3, 1_000_003, 1_000_004,
                                  2_000_003, 2_000_005, 3_000_017,
                                  2 ** 32 - 1])
@pytest.mark.parametrize("seed", [0, 10, 123_456_789])
def test_fold_in_is_bitwise_the_reference(seed, data):
    want = np.asarray(jax.random.fold_in(jax.random.PRNGKey(seed), data))
    got = prng.fold_in(prng.PRNGKey(seed), data)
    assert got.dtype == torch.int64
    assert np.array_equal(got.numpy(), want.astype(np.int64))
    keys = prng.split(prng.PRNGKey(seed), 3)
    jkeys = jax.random.split(jax.random.PRNGKey(seed), 3)
    for k, jk in zip(keys, jkeys):
        assert np.array_equal(prng.fold_in(k, data).numpy(), np.asarray(
            jax.random.fold_in(jk, data)).astype(np.int64))


def test_state_from_jax_carries_a_train_state():
    """A JAX train state ({"params", "opt", "step"}, AdamW moments after
    an update; SGD's empty state) converts to the port's, and the next
    AdamW update from it matches JAX's."""
    params, grads = _opt_inputs(5)
    jo, to = jopt.adamw(2e-3, weight_decay=0.1), opt.adamw(2e-3,
                                                          weight_decay=0.1)
    step = jnp.asarray(3, jnp.int32)
    _, moments = jo.update(grads, jo.init(params), params, step)
    state = convert.state_from_jax(jax.device_get(
        {"params": params, "opt": moments, "step": step}))
    assert set(state) == {"params", "opt", "step"}
    assert state["step"].dtype == torch.int32 and int(state["step"]) == 3
    _, grads2 = _opt_inputs(6)
    ju, js = jo.update(grads2, moments, params, step + 1)
    tu, ts = to.update(convert.params_from_jax(grads2), state["opt"],
                       state["params"], state["step"] + 1)
    _close(tu, ju)
    _close(ts, js)
    sgd_state = convert.state_from_jax(
        {"params": params, "opt": (), "step": np.int32(0)})
    assert sgd_state["opt"] == {}
