"""Tensor parallelism over "model" at every width for the dense family,
on the CPU: the flash kernels' query offset (``q_offset``, the plain
versions and `attention_vjp`), the three attention routes of
`nn.attention` where the heads or the KV heads do not divide over
"model", and the structural W-HFL step on gloo ranks spawned by
`ranks.launch` (joined through a `FileStore` under a temporary
directory).

What is held, and to what:

- `flash_attention_plain` and `flash_mha_plain` (GQA folded) on the
  query rows [q0, q0 + Lq) with ``q_offset=q0`` (q0 at 0, the middle
  and the last block of four) against the same rows of the JAX
  package's whole `flash_attention` / `flash_mha` call in interpret mode,
  causal and bidirectional, at ``tests/test_torch_flash.py``'s
  tolerance (float32 rtol = atol = 2e-5, bf16 5e-2); with a sliding
  window against the rows of the reference's whole window-masked
  `_sdpa` (``tests/test_torch_window.py``'s 1e-5 of the largest).
  `flash_attention` on CPU tensors is the plain version bit for bit.
- `attention_vjp` with an offset against `jax.grad` of the reference's
  whole masked `_sdpa` with the cotangent zero outside the rows: dq's
  rows, dk and dv within 1e-5 of the largest value of each.
- layer by layer, 4 gloo ranks at (pod, cluster, user, model) = (1, 1,
  1, 4) against the same code at "model" 1 in one process, at float32,
  ``tests/test_torch_tp.py``'s LAYER_TOL (1e-5 of the largest of each
  output and gradient): the attention of layer 0 and the whole
  `lm_loss`, for every route: (a) replicated attention (qwen2-0.5b
  ``.reduced()`` with 6 heads over 2 KV heads: neither divides by 4);
  (b) "q_seq" (the same with ``seq_shard_attn``; also with a sliding
  window of 24); (c) replicated KV heads beside split heads
  (``.reduced()`` as it is: 4 heads over 2 KV heads; and 12 heads over
  3, where a rank's 3 heads spread unevenly over 2 KV heads); and the
  q and k norms' gradient under split heads (qwen3-4b ``.reduced()``,
  4 KV heads split and 2 replicated).  Each route's collectives in the
  attention: none replicated, an all-gather over "model" under
  "q_seq", all-reduces under split heads.
- the structural step with AdamW, the equivalent channel, L 64, B 8, 2
  steps, on 8 ranks at (1, 1, 2, 4) (2 users, "model" 4), for routes
  (a), (b) and (c): against the JAX package's `build_train_step` on a
  (data 2, model 4) mesh of 8 forced host devices (one subprocess,
  from the port's initial parameters) and against the one-card port
  (``{"data": 2}``), each to ``tests/test_torch_ranks.py``'s bounds:
  loss and edge power rtol 1e-5 at every step, the update's norm rtol
  1e-3, entrywise within 1e-4 of max |theta| on all but a share 1e-3.
  Measured on the CPU: the loss and edge power within 3.4e-7 rel; every
  entry within 4.3e-4 (JAX) and 1.9e-5 (the one-card port) of max
  |theta|, at most a share 7.7e-7 past 1e-4 of it (AdamW's first steps
  move an entry whose gradient is rounding noise by its whole rate).
- `init_fn` under "model" 4 for each route: each rank's shards (the
  replicated attention leaves drawn whole) gather to the one-card
  `init_params` bit for bit.

The file takes ~3.5 min alone on one core a process (most of it the
JAX subprocess's three compiles, beside the ranks).
"""
import os
import subprocess
import sys
import textwrap
import threading
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import flash_attention as j_flash_attention
from repro.kernels.flash_attn import flash_mha as j_flash_mha
from repro.nn import attention as jattention
from repro_torch import prng
from repro_torch.configs import get_config
from repro_torch.configs.base import InputShape
from repro_torch.core import dist
from repro_torch.kernels import (flash_attention, flash_attention_plain,
                                 flash_mha_plain)
from repro_torch.kernels.flash_attn import attention_vjp
from repro_torch.launch import ranks, train
from repro_torch.models import lm
from repro_torch.nn import attention
from repro_torch.sharding import api as sh
from repro_torch.tree import tree_from_paths, tree_leaves, tree_map

torch.set_num_threads(1)

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLASH_TOL = {torch.float32: 2e-5, torch.bfloat16: 5e-2}
WINDOW_TOL = 1e-5
GRAD_TOL = 1e-5
LAYER_TOL = 1e-5
LOSS_RTOL = 1e-5
THETA_TOL = 1e-4
NORM_RTOL = 1e-3
ADAM_PARTED = 1e-3
JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}
# (B, L, H, KV, hd, q_block, kv_block): the JAX wrapper's tiles divide L
FLASH_SHAPES = [(2, 128, 4, 2, 16, 32, 32), (1, 96, 6, 2, 32, 32, 48)]
# the block of four a rank holds: the first, one in the middle, the last
BLOCKS = [0, 2, 3]


def _rows(L, block):
    Lq = L // 4
    return block * Lq, Lq


def _inputs(B, L, H, KV, hd, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, L, n, hd)).astype(np.float32)
            for n in (H, KV, KV)]


def _gap(got: torch.Tensor, want) -> float:
    """max |got - want| / max |want|, in float32."""
    want = np.asarray(want, np.float32)
    return float(np.abs(got.float().detach().numpy() - want).max()
                 / np.abs(want).max())


def _jax_sdpa(arrs, window, causal):
    """The reference's whole `_sdpa` under `_causal_mask(..., window,
    causal)` at float32."""
    q, k, v = (jnp.asarray(a) for a in arrs)
    b, l, h, hd = q.shape
    acfg = jattention.AttnConfig(d_model=h * hd, n_heads=h,
                                 n_kv_heads=k.shape[2], head_dim=hd,
                                 window=window, causal=causal)
    pos = jnp.broadcast_to(jnp.arange(l, dtype=jnp.int32)[None], (b, l))
    return jattention._sdpa(q, k, v, jattention._causal_mask(
        pos, pos, window, causal), acfg)


# ---------------------------------------------------------------------------
# the kernels' plain versions with a query offset
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("block", BLOCKS)
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", FLASH_SHAPES)
def test_plain_flash_rows_match_the_whole_jax_call(shape, causal, block,
                                                   dtype):
    B, L, H, KV, hd, qb, kb = shape
    arrs = _inputs(B, L, H, KV, hd, L + block)
    q0, Lq = _rows(L, block)
    jq, jk, jv = (jnp.asarray(a).astype(JDT[dtype]) for a in arrs)
    want = np.asarray(j_flash_attention(jq, jk, jv, causal=causal,
                                        q_block=qb, kv_block=kb,
                                        interpret=True), np.float32)
    want = want[:, q0:q0 + Lq]
    q, k, v = (torch.tensor(a).to(dtype) for a in arrs)
    qr = q[:, q0:q0 + Lq].contiguous()
    got = flash_attention_plain(qr, k, v, causal=causal, q_block=qb,
                                kv_block=kb, q_offset=q0)
    assert got.shape == (B, Lq, H * hd) and got.dtype == dtype
    assert torch.equal(got, flash_attention(qr, k, v, causal=causal,
                                            q_block=qb, kv_block=kb,
                                            q_offset=q0))
    np.testing.assert_allclose(got.float().numpy(), want,
                               rtol=FLASH_TOL[dtype], atol=FLASH_TOL[dtype])


@pytest.mark.parametrize("block", BLOCKS)
@pytest.mark.parametrize("causal", [True, False])
def test_folded_flash_mha_rows_match_the_whole_jax_call(causal, block):
    """`flash_mha_plain` on the folded layout (G = 3 query heads a KV
    head over a rank's Lq rows, ``seq_len=Lq``; 64-row q tiles that
    straddle two heads) against the rows of JAX's folded whole call."""
    N, G, L, hd = 2, 3, 128, 32
    q0, Lq = _rows(L, block)
    rng = np.random.default_rng(block)
    qf, kf, vf = (rng.standard_normal(s).astype(np.float32)
                  for s in ((N, G * L, hd), (N, L, hd), (N, L, hd)))
    want = np.asarray(j_flash_mha(jnp.asarray(qf), jnp.asarray(kf),
                                  jnp.asarray(vf), causal=causal,
                                  q_block=64, kv_block=32, interpret=True,
                                  seq_len=L))
    want = want.reshape(N, G, L, hd)[:, :, q0:q0 + Lq].reshape(
        N, G * Lq, hd)
    rows = torch.tensor(qf).reshape(N, G, L, hd)[:, :, q0:q0 + Lq]
    got = flash_mha_plain(rows.reshape(N, G * Lq, hd).contiguous(),
                          torch.tensor(kf), torch.tensor(vf), causal=causal,
                          q_block=64, kv_block=32, seq_len=Lq, q_offset=q0)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("window", [7, 40])
@pytest.mark.parametrize("block", BLOCKS)
@pytest.mark.parametrize("causal", [True, False])
def test_plain_flash_rows_with_a_window(causal, block, window):
    B, L, H, KV, hd, qb, kb = FLASH_SHAPES[1]
    arrs = _inputs(B, L, H, KV, hd, window + block)
    q0, Lq = _rows(L, block)
    want = np.asarray(_jax_sdpa(arrs, window, causal))[:, q0:q0 + Lq]
    q, k, v = map(torch.tensor, arrs)
    got = flash_attention_plain(q[:, q0:q0 + Lq].contiguous(), k, v,
                                causal=causal, q_block=16, kv_block=kb,
                                window=window, q_offset=q0)
    assert _gap(got, want) <= WINDOW_TOL


def test_q_offset_is_checked():
    """The offset is a count, and with a window every row of the block
    must keep a key: q_offset + Lq < S + W."""
    arrs = _inputs(1, 40, 2, 1, 16, 0)
    q, k, v = map(torch.tensor, arrs)
    for bad in (-1, True, 2.0):
        with pytest.raises(ValueError, match="q_offset"):
            flash_attention(q[:, :10].contiguous(), k, v, q_offset=bad)
    with pytest.raises(ValueError, match="keeps none"):
        flash_attention(q[:, :10].contiguous(), k[:, :20].contiguous(),
                        v[:, :20].contiguous(), window=5, q_offset=15)
    assert flash_attention(q[:, :10].contiguous(), k[:, :20].contiguous(),
                           v[:, :20].contiguous(), window=6,
                           q_offset=15).shape == (1, 10, 32)


@pytest.mark.parametrize("window", [None, 7])
@pytest.mark.parametrize("block", BLOCKS)
@pytest.mark.parametrize("causal", [True, False])
def test_attention_vjp_rows_match_jax_grad(causal, block, window):
    """(dq, dk, dv) of a rank's rows: `attention_vjp(q_offset=q0)` on
    them against `jax.grad` of the whole masked `_sdpa` with the
    cotangent zero outside those rows (dq's rows; dk and dv whole)."""
    B, L, H, KV, hd = 2, 96, 4, 2, 32
    arrs = _inputs(B, L, H, KV, hd, 11 + block)
    q0, Lq = _rows(L, block)
    do = np.zeros((B, L, H * hd), np.float32)
    do[:, q0:q0 + Lq] = np.random.default_rng(5).standard_normal(
        (B, Lq, H * hd))
    want = jax.grad(lambda *x: jnp.sum(_jax_sdpa(x, window, causal)
                                       * jnp.asarray(do)),
                    argnums=(0, 1, 2))(*[jnp.asarray(a) for a in arrs])
    want = [np.asarray(want[0])[:, q0:q0 + Lq]] + [np.asarray(w)
                                                   for w in want[1:]]
    q, k, v = map(torch.tensor, arrs)
    got = attention_vjp(q[:, q0:q0 + Lq].contiguous(), k, v,
                        torch.tensor(do[:, q0:q0 + Lq]), causal=causal,
                        q_block=16, window=window, q_offset=q0)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert np.abs(g.numpy() - w).max() <= GRAD_TOL * max(
            np.abs(w).max(), 1e-30)


def _source(name: str) -> str:
    return open(os.path.join(_REPO, "src", "repro_torch", "csrc",
                             f"{name}.cu")).read()


@pytest.mark.parametrize("name", ["flash_attn_wgmma", "flash_attn_tf32"])
def test_ab_picks_each_sources_flash_prototype(name):
    """`kernels/ab.py` reads a flash source's entry point and picks its
    prototype: this tree's (window and q_offset), one from before the
    query offset, one from before the window; each with as many
    arguments as the C parameter list declares."""
    from repro_torch.kernels import ab, flash_attn

    entry = f"{name}_launch"
    tf32 = name == "flash_attn_tf32"
    now = _source(name)
    no_offset = now.replace("int q_offset,", "")
    no_window = no_offset.replace("int window,", "")
    want = {now: (flash_attn.TF32_ARGTYPES if tf32 else flash_attn.ARGTYPES,
                  True, True),
            no_offset: (flash_attn.NO_OFFSET_TF32_ARGTYPES if tf32
                        else flash_attn.NO_OFFSET_ARGTYPES, True, False),
            no_window: (flash_attn.NO_WINDOW_TF32_ARGTYPES if tf32
                        else flash_attn.NO_WINDOW_ARGTYPES, False, False)}
    assert len({len(w[0]) for w in want.values()}) == 3
    for text, (argtypes, windowed, offset) in want.items():
        params = ab.entry_params(text, entry)
        assert params.count(",") + 1 == len(argtypes)
        assert ab.flash_argtypes(entry, params) == (argtypes, windowed,
                                                    offset)


def test_seq_block_cuts_a_ranks_rows():
    """`sharding.seq_block`: the rank's contiguous L / model query rows
    where the rules put "q_seq" on "model", all L elsewhere; a length
    that does not divide is refused."""
    cfg = _dense(n_heads=6)
    rules = sh.make_rules({"pod": 1, "cluster": 1, "user": 1, "model": 4},
                          cfg=cfg, inside_shardmap=True)
    with sh.set_rules(rules), sh.axes_bound(_fake_mesh(2)):
        assert sh.seq_block(64) == (32, 16)
        with pytest.raises(ValueError, match="does not divide"):
            sh.seq_block(66)
    split = sh.make_rules({"pod": 1, "cluster": 1, "user": 1, "model": 4},
                          cfg=_dense(), inside_shardmap=True)
    with sh.set_rules(split), sh.axes_bound(_fake_mesh(2)):
        assert sh.seq_block(66) == (0, 66)


# ---------------------------------------------------------------------------
# the routes, layer by layer at "model" 4 against "model" 1
# ---------------------------------------------------------------------------

def _dense(arch="qwen2-0.5b", **kw):
    return get_config(arch).reduced().with_(compute_dtype="float32", **kw)


# route -> the configuration that takes it at "model" 4
ROUTES = {
    "replicated": _dense(n_heads=6),
    "q_seq": _dense(n_heads=6, seq_shard_attn=True),
    "q_seq_window": _dense(n_heads=6, seq_shard_attn=True,
                           sliding_window=24),
    "kv_replicated": _dense(),
    "kv_uneven": _dense(n_heads=12, n_kv_heads=3),
    "qk_norm_kv_replicated": _dense("qwen3-4b", n_kv_heads=2),
    "qk_norm_split": _dense("qwen3-4b"),
}
# the collectives each route's attention makes over "model" (forward and
# backward)
ROUTE_OPS = {"replicated": set(), "q_seq": {"all_gather", "all_reduce"},
             "q_seq_window": {"all_gather", "all_reduce"},
             "kv_replicated": {"all_reduce"}, "kv_uneven": {"all_reduce"},
             "qk_norm_kv_replicated": {"all_reduce"},
             "qk_norm_split": {"all_reduce"}}
MODULES = ("attention", "lm_loss")
B_LAYER, L_LAYER = 2, 64


def _layer_inputs():
    rng = np.random.default_rng(11)
    out = {}
    for route, cfg in ROUTES.items():
        out[route] = {
            "params": lm.init_params(prng.PRNGKey(3), cfg),
            "x": torch.tensor(rng.standard_normal(
                (B_LAYER, L_LAYER, cfg.d_model)).astype(np.float32)),
            "w": torch.tensor(rng.standard_normal(
                (B_LAYER, L_LAYER, cfg.d_model)).astype(np.float32)),
            "batch": {k: torch.tensor(rng.integers(
                0, cfg.vocab, (B_LAYER, L_LAYER)), dtype=torch.int32)
                for k in ("tokens", "labels")}}
    return out


def _layer_runs(cfg, params, x, w, batch):
    """{module: (output, {name: gradient}, collectives)}: the attention
    of layer 0 with a fixed weighting of its output as the loss, and the
    whole `lm_loss`, on `params` (shards under active rules)."""
    acfg = lm._attn_cfg(cfg)
    pos = torch.arange(L_LAYER, dtype=torch.int32)[None].expand(B_LAYER,
                                                                L_LAYER)
    out = {}

    def run(name, fn, tree, inp=None):
        leaves = [(p, t.detach().clone().requires_grad_())
                  for p, t in tree_leaves(tree)]
        xs = None if inp is None else inp.clone().requires_grad_()
        with sh.record_collectives() as log:
            y = fn(tree_from_paths(leaves), xs)
            loss = y if y.ndim == 0 else torch.sum(y * w)
            loss.backward()
        grads = {"/".join(p): t.grad for p, t in leaves}
        if xs is not None:
            grads["x"] = xs.grad
        out[name] = (y.detach(), grads,
                     {r["op"] for r in log if r["axes"] == ["model"]})

    run("attention", lambda p, xs: attention.prefill(p, xs, pos, acfg),
        lm._at(params["layers"], 0)["attn"], x)
    run("lm_loss", lambda p, _: lm.lm_loss(p, batch, cfg)[0], params)
    return out


def _layer_worker(rank, world, data):
    from repro_torch.launch.mesh import make_mesh, refine_mesh

    torch.set_num_threads(1)
    rmesh = refine_mesh(make_mesh((1, 1, 1, 4), device_type="cpu"),
                        users_per_cluster=1)
    res = {"model": rmesh.get_local_rank("model")}
    for route, cfg in ROUTES.items():
        d = data[route]
        rules = sh.make_rules(rmesh, cfg=cfg, inside_shardmap=True)
        specs = sh.param_sharding_tree(lm.param_axes(cfg), rules)
        with sh.axes_bound(rmesh), sh.set_rules(rules):
            params = tree_map(torch.clone, sh.shard_tree(d["params"], specs))
            res[route] = _layer_runs(cfg, params, d["x"], d["w"],
                                     d["batch"])
    return res


@pytest.fixture(scope="module")
def layers():
    data = _layer_inputs()
    return data, ranks.launch(_layer_worker, 4, "gloo", data)


def _fake_mesh(model):
    sizes = {"pod": 1, "cluster": 1, "user": 1, "model": 4}
    coords = {"pod": 0, "cluster": 0, "user": 0, "model": model}
    return SimpleNamespace(mesh_dim_names=tuple(sizes),
                           shape=tuple(sizes.values()), get_group=None,
                           get_local_rank=lambda name: coords[name])


@pytest.mark.parametrize("module", MODULES)
@pytest.mark.parametrize("route", ROUTES)
def test_route_at_model_4_matches_model_1(layers, route, module):
    data, res = layers
    cfg, d = ROUTES[route], data[route]
    want_y, want_g, _ = _layer_runs(cfg, d["params"], d["x"], d["w"],
                                    d["batch"])[module]
    axes = lm.param_axes(cfg)
    sub = ((lambda t: lm._at(t["layers"], 0)["attn"]) if module ==
           "attention" else (lambda t: t))
    sub_axes = (lm._layer_axes(axes["layers"])["attn"] if module ==
                "attention" else axes)
    rules = sh.make_rules({"pod": 1, "cluster": 1, "user": 1, "model": 4},
                          cfg=cfg, inside_shardmap=True)
    specs = dict(zip(("/".join(p) for p, _ in tree_leaves(sub(
        d["params"]))), sh.spec_leaves(sh.param_sharding_tree(sub_axes,
                                                              rules))))
    for r in res:
        got_y, got_g, ops = r[route][module]
        if module == "attention":
            assert ops == ROUTE_OPS[route], (route, ops)
        scale = max(float(want_y.abs().max()), 1e-30)
        assert float((got_y - want_y).abs().max()) <= LAYER_TOL * scale
        for name, g in want_g.items():
            if name != "x":
                with sh.axes_bound(_fake_mesh(r["model"])):
                    g = sh.shard_tree(g, specs[name])
            assert got_g[name].shape == g.shape, name
            gap = float((got_g[name] - g).abs().max())
            assert gap <= LAYER_TOL * float(g.abs().max()), (route, module,
                                                             name)


# ---------------------------------------------------------------------------
# the structural step on 8 ranks at (1, 1, 2, 4)
# ---------------------------------------------------------------------------

SHAPE = InputShape("tiny", 64, 8, "train")
FIELDS = dict(tau=1, I=1, users_per_cluster=2, eta_local=1.0, outer="adamw",
              outer_lr=2e-3)
OTA = dict(mode="equivalent")
STEPS = 2
# route -> the architecture's overrides of qwen2-0.5b ``.reduced()``
STEP_ROUTES = {"replicated": dict(n_heads=6),
               "q_seq": dict(n_heads=6, seq_shard_attn=True),
               "kv_replicated": dict()}

_JAX_SCRIPT = """
import sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import AxisType
from repro.configs import get_config
from repro.configs.base import InputShape
from repro.core import dist
from repro.launch import train

fields, ota, routes, steps = {fields!r}, {ota!r}, {routes!r}, {steps!r}
inp = dict(np.load(sys.argv[1]))
mesh = jax.make_mesh((2, 4), ("data", "model"),
                     axis_types=(AxisType.Auto,) * 2)
B, L = inp["tokens"].shape
res = {{}}
for tag, over in routes.items():
    cfg = get_config("qwen2-0.5b").reduced().with_(compute_dtype="float32",
                                                   **over)
    step, init_fn, shardings_fn, _ = train.build_train_step(
        cfg, InputShape("tiny", L, B, "train"), mesh,
        train.TrainConfig(**fields, ota=dist.OTADistConfig(**ota)))
    state, axes = init_fn(jax.random.PRNGKey(0))
    sh = shardings_fn(axes)
    paths = jax.tree_util.tree_leaves_with_path(state["params"])
    params = jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(state["params"]),
        [jnp.asarray(inp[tag + "/theta0/" + "/".join(k.key for k in p)])
         for p, _ in paths])
    state = dict(state, params=jax.device_put(params,
                                              sh["state"]["params"]))
    jstep = jax.jit(step, in_shardings=(sh["state"], sh["batch"], sh["key"]),
                    out_shardings=(sh["state"], sh["metrics"]))
    batch = {{k: jnp.asarray(inp[k]) for k in ("tokens", "labels")}}
    for i in range(steps):
        state, m = jstep(state, batch, jax.random.PRNGKey(10 + i))
        res[f"{{tag}}/loss/{{i}}"] = np.asarray(m["loss"])
        res[f"{{tag}}/edge_power/{{i}}"] = np.asarray(m["edge_power"])
    for p, v in jax.tree_util.tree_leaves_with_path(
            jax.device_get(state["params"])):
        res[f"{{tag}}/params/" + "/".join(k.key for k in p)] = np.asarray(v)
np.savez(sys.argv[2], **res)
print("OK")
"""


def _step_cfg(route):
    return _dense(**STEP_ROUTES[route])


def _tcfg():
    return train.TrainConfig(**FIELDS, ota=dist.OTADistConfig(**OTA))


@pytest.fixture(scope="module")
def steps(tmp_path_factory):
    """Each route's run on 8 ranks at (1, 1, 2, 4) and on one device, an
    unstepped `init_fn` on the ranks, and the JAX package's runs."""
    g = torch.Generator().manual_seed(7)
    batch = {k: torch.randint(0, _step_cfg("q_seq").vocab,
                              (SHAPE.global_batch, SHAPE.seq_len),
                              generator=g, dtype=torch.int32)
             for k in ("tokens", "labels")}
    theta0 = {r: lm.init_params(prng.PRNGKey(0), _step_cfg(r))
              for r in STEP_ROUTES}
    tmp = tmp_path_factory.mktemp("qseq")
    inp = {f"{r}/theta0/{'/'.join(p)}": t.numpy()
           for r in STEP_ROUTES for p, t in tree_leaves(theta0[r])}
    inp.update({k: v.numpy() for k, v in batch.items()})
    np.savez(tmp / "inp.npz", **inp)
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu", PYTHONPATH=os.path.join(_REPO, "src"))
    proc = subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(_JAX_SCRIPT.format(
            fields=FIELDS, ota=OTA, routes=STEP_ROUTES, steps=STEPS)),
         str(tmp / "inp.npz"), str(tmp / "jax.npz")], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        specs = [dict(cfg=_step_cfg(r), shape=SHAPE, tcfg=_tcfg(),
                      mesh=(1, 1, 2, 4), batches=[batch],
                      keys=[10 + i for i in range(STEPS)], device="cpu",
                      params0=theta0[r], return_state=True)
                 for r in STEP_ROUTES]
        specs += [dict(s, keys=[], params0=None) for s in specs]
        out = {}
        thread = threading.Thread(target=lambda: out.update(
            r=ranks.launch(ranks.train_worker, 8, "gloo", specs)))
        thread.start()
        one = {}
        for r in STEP_ROUTES:
            step, init_fn = train.build_train_step(
                _step_cfg(r), SHAPE, {"data": 2}, _tcfg(), device="cpu")
            state, _ = init_fn(prng.PRNGKey(0))
            state["params"] = tree_map(torch.clone, theta0[r])
            ms = []
            for i in range(STEPS):
                state, m = step(state, batch, prng.PRNGKey(10 + i))
                ms.append({k: float(v) for k, v in m.items()})
            one[r] = (dict(tree_leaves(state["params"])), ms)
        thread.join()
        stdout, stderr = proc.communicate(timeout=900)
        assert proc.returncode == 0, stdout + "\n" + stderr
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert "r" in out, "the ranks' launch failed"
    ref = dict(np.load(tmp / "jax.npz"))
    jax_runs = {r: ({tuple(k.split("/")[2:]): torch.tensor(v)
                     for k, v in ref.items()
                     if k.startswith(f"{r}/params/")},
                    [{k: float(ref[f"{r}/{k}/{i}"])
                      for k in ("loss", "edge_power")}
                     for i in range(STEPS)]) for r in STEP_ROUTES}
    n = len(STEP_ROUTES)
    return {"ranks": {r: [res[i] for res in out["r"]]
                      for i, r in enumerate(STEP_ROUTES)},
            "init": {r: [res[n + i] for res in out["r"]]
                     for i, r in enumerate(STEP_ROUTES)},
            "one": one, "jax": jax_runs, "theta0": theta0}


def _within_bounds(got_params, got_metrics, want_params, want_metrics,
                   theta0):
    """`tests/test_torch_ranks.py`'s bounds against JAX (`want_params`:
    {path: leaf})."""
    for i, m in enumerate(want_metrics):
        for k in ("loss", "edge_power"):
            assert abs(got_metrics[i][k] - m[k]) <= LOSS_RTOL * abs(m[k]), (
                k, i)
    got, want = dict(tree_leaves(got_params)), want_params
    assert set(got) == set(want)
    p0 = dict(tree_leaves(theta0))
    theta_max = max(float(w.abs().max()) for w in want.values())
    gaps = np.concatenate([(got[p] - w).abs().flatten().numpy()
                           for p, w in want.items()])
    upd = lambda tr: torch.sqrt(sum(torch.sum((tr[p] - p0[p]) ** 2)
                                    for p in want))
    assert abs(float(upd(got)) - float(upd(want))) <= NORM_RTOL * float(
        upd(want))
    assert (gaps > THETA_TOL * theta_max).mean() <= ADAM_PARTED


@pytest.mark.parametrize("route", STEP_ROUTES)
def test_route_step_matches_reference(steps, route):
    want, ms = steps["jax"][route]
    assert len(steps["ranks"][route]) == 8
    for r in steps["ranks"][route]:
        _within_bounds(r["state"]["params"], r["metrics"], want, ms,
                       steps["theta0"][route])
        axes = {c["axes"] for c in r["collectives"]}
        assert {"model", "user"} <= axes, r["collectives"]
        assert set(r["coordinate"]) == {"pod", "cluster", "user", "model"}


@pytest.mark.parametrize("route", STEP_ROUTES)
def test_route_step_matches_one_card(steps, route):
    want, ms = steps["one"][route]
    for r in steps["ranks"][route]:
        _within_bounds(r["state"]["params"], r["metrics"], want, ms,
                       steps["theta0"][route])


@pytest.mark.parametrize("route", STEP_ROUTES)
def test_route_init_gathers_to_the_whole_init(steps, route):
    want = dict(tree_leaves(lm.init_params(prng.PRNGKey(0),
                                           _step_cfg(route))))
    for r in steps["init"][route]:
        got = dict(tree_leaves(r["state"]["params"]))
        assert set(got) == set(want)
        assert all(torch.equal(got[p].view(torch.uint8).reshape(-1),
                               want[p].view(torch.uint8).reshape(-1))
                   for p in want)
