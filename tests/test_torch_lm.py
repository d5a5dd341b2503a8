"""The port's dense LM stack (`repro_torch.configs`, `nn`, `models.lm`,
`launch.serve`) against the JAX package, on reduced configs.

Tolerances, and why:

- `init_params` from one seed: the same tree, shapes and dtypes, values
  within 4 ULP (the `jax.random.normal` emulation's bound, as in
  ``tests/test_torch_prng.py``).
- `prefill_logits` and `decode_step` from the same converted weights, at
  float32 compute: 1e-5 of max |logit| against JAX's "blocked" and
  "online" attention (the gaps measure 1.1e-6 to 1.4e-6: summation
  order only).  At the default bfloat16 compute: 5e-2 of max |logit|
  (measured 1.4e-2 to 1.5e-2); the JAX model rounds its scores and
  softmax weights to bf16 where the flash path keeps them in float32,
  and the two frameworks round their bf16 products differently.
- the decode cache after a step: pos equal; k and v within 1e-5 of
  max |k|, |v| at float32, and 5e-2 at bfloat16 (one bf16 rounding of a
  float32 value that differs in the last bits).
- the port's decode against its own prefill (streamed cache vs flash
  prefill), float32: ``tests/test_arch_smoke.py``'s rtol = atol = 5e-3.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import INPUT_SHAPES as J_INPUT_SHAPES
from repro.configs import get_config as j_get_config
from repro.configs import list_configs as j_list_configs
from repro.launch.serve import cache_specs as j_cache_specs
from repro.launch.serve import decode_window as j_decode_window
from repro.models import lm as jlm
from repro.nn.core import split_params
from repro_torch import convert, prng
from repro_torch.configs import INPUT_SHAPES, get_config, list_configs
from repro_torch.launch import serve
from repro_torch.models import lm
from repro_torch.tree import tree_leaves

torch.set_num_threads(1)

ULP4 = 4 * 2 ** -23


def _configs(cdt="float32", impl="blocked"):
    kw = dict(compute_dtype=cdt, attn_impl=impl)
    return (get_config("qwen2-0.5b").reduced().with_(**kw),
            j_get_config("qwen2-0.5b").reduced().with_(**kw))


def _jax_params(jcfg):
    return jax.device_get(split_params(jlm.init_params(jax.random.PRNGKey(0),
                                                       jcfg))[0])


def test_configs_match_reference():
    """Every registered config, its reduced cut and the input shapes."""
    assert sorted(list_configs()) == sorted(j_list_configs())
    for name, jcfg in j_list_configs().items():
        for mine, ref in ((get_config(name), jcfg),
                          (get_config(name).reduced(), jcfg.reduced())):
            assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
            assert mine.cdt() == getattr(torch, ref.compute_dtype)
    assert {k: dataclasses.asdict(v) for k, v in INPUT_SHAPES.items()} == {
        k: dataclasses.asdict(v) for k, v in J_INPUT_SHAPES.items()}


def _walk(mine, ref, path=""):
    if isinstance(ref, dict):
        assert isinstance(mine, dict) and set(mine) == set(ref), path
        for k in ref:
            yield from _walk(mine[k], ref[k], f"{path}/{k}")
    else:
        yield path, mine, np.asarray(ref)


def test_init_params_matches_reference():
    cfg, jcfg = _configs()
    mine = lm.init_params(prng.PRNGKey(0), cfg)
    leaves = list(_walk(mine, _jax_params(jcfg)))
    assert len(leaves) == 15
    for path, t, ref in leaves:
        assert tuple(t.shape) == ref.shape and t.dtype == torch.float32, path
        np.testing.assert_allclose(t.numpy(), ref, rtol=ULP4, atol=0,
                                   err_msg=path)
    assert mine["layers"]["attn"]["wq"]["w"].shape == (2, 256, 128)


def test_convert_carries_a_bf16_tree():
    """A bf16 `param_dtype` tree (numpy's ml_dtypes bfloat16 leaves)
    converts to bf16 tensors with the same bits, and back."""
    cfg, jcfg = (c.with_(param_dtype="bfloat16") for c in _configs())
    ref = _jax_params(jcfg)
    mine = convert.params_from_jax(ref)
    back = convert.to_numpy(mine)
    for path, t, r in _walk(mine, ref):
        assert t.dtype == torch.bfloat16, path
    for path, a, r in _walk(back, ref):
        assert a.dtype == np.float32
        np.testing.assert_array_equal(a, r.astype(np.float32), err_msg=path)
    got = lm.init_params(prng.PRNGKey(0), cfg)["layers"]["mlp"]["w_up"]["w"]
    assert got.dtype == torch.bfloat16      # within one bf16 rounding
    torch.testing.assert_close(got.float(), mine["layers"]["mlp"]["w_up"][
        "w"].float(), rtol=2 ** -8, atol=0)


def _random_cache(jcfg, cfg, B, S, pos, seed):
    rng = np.random.default_rng(seed)
    shape = (jcfg.n_layers, B, S, jcfg.n_kv_heads, jcfg.head_dim)
    k, v = (rng.standard_normal(shape).astype(np.float32) for _ in "kv")
    p = np.full((jcfg.n_layers, B), pos, np.int32)
    jc = {"attn": {"k": jnp.asarray(k, jcfg.cdt()),
                   "v": jnp.asarray(v, jcfg.cdt()), "pos": jnp.asarray(p)}}
    tc = {"attn": {"k": torch.as_tensor(k).to(cfg.cdt()),
                   "v": torch.as_tensor(v).to(cfg.cdt()),
                   "pos": torch.as_tensor(p)}}
    return jc, tc


@pytest.mark.parametrize("cdt,impl,tol", [
    ("float32", "blocked", 1e-5),
    ("float32", "online", 1e-5),
    ("bfloat16", "blocked", 5e-2),
])
def test_prefill_and_decode_match_reference(cdt, impl, tol):
    """L = 80 > q_block = 64: JAX scans two query blocks, the port's
    plain flash version ends in a short tile."""
    cfg, jcfg = _configs(cdt, impl)
    jp = _jax_params(jcfg)
    tp = convert.params_from_jax(jp)
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg.vocab, (2, 80)).astype(np.int32)
    want = np.asarray(jlm.prefill_logits(jp, {"tokens": jnp.asarray(toks)},
                                         jcfg))
    got = lm.prefill_logits(tp, {"tokens": torch.as_tensor(toks)}, cfg)
    assert got.shape == (2, cfg.vocab) and got.dtype == torch.float32
    assert np.abs(got.numpy() - want).max() <= tol * np.abs(want).max()

    jc, tc = _random_cache(jcfg, cfg, 2, 96, 50, 2)
    want, jc = jlm.decode_step(jp, jc, {"tokens": jnp.asarray(toks[:, :1])},
                               jcfg)
    got, tc = lm.decode_step(tp, tc, {"tokens": torch.as_tensor(toks[:, :1])},
                             cfg)
    want = np.asarray(want)
    assert np.abs(got.numpy() - want).max() <= tol * np.abs(want).max()
    assert np.array_equal(tc["attn"]["pos"].numpy(),
                          np.asarray(jc["attn"]["pos"]))
    for name in ("k", "v"):
        ref = np.asarray(jc["attn"][name], np.float32)
        gap = np.abs(tc["attn"][name].float().numpy() - ref).max()
        assert gap <= tol * np.abs(ref).max(), name


def test_decode_writes_the_cache_in_place():
    cfg, _ = _configs()
    params = lm.init_params(prng.PRNGKey(0), cfg)
    cache = lm.init_decode_cache(cfg, 2, 8)
    cache["attn"]["pos"].zero_()
    k = cache["attn"]["k"]
    _, out = lm.decode_step(params, cache, {"tokens": torch.zeros(
        (2, 1), dtype=torch.int32)}, cfg)
    assert out["attn"]["k"] is k and bool(k[:, :, 0].abs().sum() > 0)
    assert not bool(k[:, :, 1:].abs().sum() > 0)
    assert out["attn"]["pos"].tolist() == [[1, 1], [1, 1]]


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "qwen2-1.5b", "qwen3-4b",
                                  "chatglm3-6b"])
def test_decode_matches_prefill(arch):
    """As tests/test_arch_smoke.py: T tokens fed one at a time through
    an empty cache against a prefill of the prefix (qk-norm, the partial
    rope and hd 32 through the plain flash path)."""
    cfg = get_config(arch).reduced().with_(compute_dtype="float32",
                                           param_dtype="float32")
    B, T = 2, 12
    params = lm.init_params(prng.PRNGKey(0), cfg)
    toks = prng.randint(prng.PRNGKey(1), (B, T), 0, cfg.vocab).to(
        torch.int32)
    want = lm.prefill_logits(params, {"tokens": toks}, cfg)
    cache = lm.init_decode_cache(cfg, B, T)
    cache["attn"]["pos"].zero_()
    for t in range(T):
        got, cache = lm.decode_step(params, cache,
                                    {"tokens": toks[:, t:t + 1]}, cfg)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=5e-3,
                               atol=5e-3)


def test_serve_specs_match_reference():
    """As tests/test_serve.py: the window at decode_32k and long_500k,
    and the cache's shapes and dtypes, for every cache layout."""
    for arch in ("qwen2-1.5b", "mamba2-780m"):
        for shape in ("decode_32k", "long_500k"):
            assert serve.decode_window(get_config(arch), INPUT_SHAPES[
                shape]) == j_decode_window(j_get_config(arch),
                                           J_INPUT_SHAPES[shape])
    cfg, jcfg = get_config("qwen2-1.5b"), j_get_config("qwen2-1.5b")
    for shape in ("decode_32k", "long_500k"):
        mine = serve.cache_specs(cfg, INPUT_SHAPES[shape])
        ref = j_cache_specs(jcfg, J_INPUT_SHAPES[shape])
        for name in ("k", "v", "pos"):
            t, r = mine["attn"][name], ref["attn"][name]
            assert t.device.type == "meta"
            assert tuple(t.shape) == r.shape, (shape, name)
            assert t.dtype == getattr(torch, str(r.dtype)), (shape, name)
    assert serve.cache_specs(cfg, INPUT_SHAPES["long_500k"])[
        "attn"]["k"].shape[2] == 8192
    # the ssm, hybrid and encdec caches: every leaf (SSM states and conv
    # windows on their layers' axes, the encoder's output)
    for arch in ("mamba2-780m", "zamba2-7b", "seamless-m4t-medium"):
        for shape in ("decode_32k", "long_500k"):
            mine = dict(tree_leaves(serve.cache_specs(
                get_config(arch), INPUT_SHAPES[shape])))
            ref = {path: r for path, r in tree_leaves(dict(j_cache_specs(
                j_get_config(arch), J_INPUT_SHAPES[shape])))}
            assert set(mine) == set(ref), (arch, shape)
            for path, r in ref.items():
                t = mine[path]
                assert t.device.type == "meta"
                assert tuple(t.shape) == r.shape, (arch, shape, path)
                assert t.dtype == getattr(torch, str(r.dtype)), (
                    arch, shape, path)


def test_serve_steps_run_on_the_cpu():
    cfg, _ = _configs("bfloat16")
    shape = dataclasses.replace(INPUT_SHAPES["decode_32k"], seq_len=16,
                                global_batch=2)
    params = serve.compute_params(lm.init_params(prng.PRNGKey(0), cfg), cfg)
    assert params["layers"]["ln1"]["scale"].dtype == torch.float32
    assert params["lm_head"]["w"].dtype == torch.bfloat16
    step, specs = serve.build_prefill_step(cfg, shape, device="cpu")
    assert specs()["tokens"].shape == (2, 16)
    toks = torch.zeros((2, 16), dtype=torch.int32)
    assert step(params, {"tokens": toks}).shape == (2, cfg.vocab)
    dstep, tspec = serve.build_decode_step(cfg, shape, device="cpu")
    cache = lm.init_decode_cache(cfg, 2, 16)
    logits, cache = dstep(params, cache, toks[:, :1])
    assert logits.shape == (2, cfg.vocab) and tspec().shape == (2, 1)
    assert torch.isfinite(logits).all()
    with pytest.raises(ValueError, match="meta"):
        step(params, {"tokens": toks.to("meta")})


def test_serve_defaults_to_cuda_and_raises_without_it():
    if torch.cuda.is_available():
        pytest.skip("this box has a CUDA card")
    cfg, _ = _configs()
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.build_prefill_step(cfg, INPUT_SHAPES["prefill_32k"])
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.build_decode_step(cfg, INPUT_SHAPES["decode_32k"])
