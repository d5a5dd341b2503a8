"""Tensor parallelism over "model" on ranks (`nn.core`, `nn.attention`,
`nn.mlp`, `models.lm` under the rules of a "model" axis past 1;
`launch.train`'s structural step), on the CPU: gloo ranks spawned by
`ranks.launch`, joined through a `FileStore` under a temporary
directory.

What is held, and to what:

- Layer by layer, qwen2-0.5b ``.reduced()`` at float32 (4 heads over 2
  KV heads at hd 32, FFN 512, vocabulary 512) on 2 ranks at (1, 1, 1,
  2) against the same code at "model" 1 in one process: the attention
  (column-parallel q, k, v and bias, the flash route on 2 of 4 heads
  and 1 of 2 KV heads, row-parallel `wo`), `swiglu`, the vocab-parallel
  embedding and the whole `lm_loss` (its vocab-parallel cross-entropy):
  the forward and the gradient of every input and parameter shard
  within 1e-5 of the largest of each (``tests/test_torch_lm.py``'s
  float32 gradient bound); the placement checks pass at the local
  sizes.  At bf16 (4 layers, L 512) the split's `lm_loss` gradient
  within twice bf16's own spread (the one-card bf16 gradient against
  the float32 one) of both.
- The structural step with AdamW, L 64, B 8, on 4 ranks at (1, 1, 2,
  2) (2 users, "model" 2), `ideal` and `equivalent`, 2 steps: against
  the JAX package's `build_train_step` on a (data 2, model 2) mesh of 4
  forced host devices (a subprocess, from the port's initial
  parameters) and against the one-card port (`{"data": 2}`), each to
  ``tests/test_torch_ranks.py``'s bounds against JAX: loss and edge
  power rtol 1e-5 at every step; the update's norm rtol 1e-3;
  entrywise within 1e-4 of max |theta| on all but a share 1e-3.
  Measured on the CPU: the loss and edge power within 1.9e-6 rel;
  every entry within 2.9e-4 (JAX) and 5.2e-4 (the one-card port) of max
  |theta|, at most a share 4.0e-6 past 1e-4 of it (the ideal channel;
  AdamW's first steps move an entry whose gradient is rounding noise by
  its whole rate).  The collectives go over "model" (the products, the
  cross-entropy's maximum) and over "user" (the hops).
  `init_fn` under "model" 2 draws each rank's shards, which gather to
  the one-card `init_params` bit for bit.

The file takes ~90 s alone on one core a process.
"""
import os
import subprocess
import sys
import textwrap
import threading
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch import prng
from repro_torch.configs import get_config
from repro_torch.configs.base import InputShape
from repro_torch.core import dist
from repro_torch.launch import ranks, train
from repro_torch.models import lm
from repro_torch.nn import attention, core, mlp
from repro_torch.sharding import api as sh
from repro_torch.tree import tree_from_paths, tree_leaves, tree_map

torch.set_num_threads(1)

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LAYER_TOL = 1e-5
LOSS_RTOL = 1e-5
THETA_TOL = 1e-4
NORM_RTOL = 1e-3
ADAM_PARTED = 1e-3
SHAPE = InputShape("tiny", 64, 8, "train")
FIELDS = dict(tau=1, I=1, users_per_cluster=2, eta_local=1.0, outer="adamw",
              outer_lr=2e-3)
RUNS = {"ideal": dict(mode="ideal"), "equivalent": dict(mode="equivalent")}
STEPS = 2

_JAX_SCRIPT = """
import sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import AxisType
from repro.configs import get_config
from repro.configs.base import InputShape
from repro.core import dist
from repro.launch import train

fields, runs, steps = {fields!r}, {runs!r}, {steps!r}
inp = dict(np.load(sys.argv[1]))
cfg = get_config("qwen2-0.5b").reduced().with_(compute_dtype="float32")
mesh = jax.make_mesh((2, 2), ("data", "model"),
                     axis_types=(AxisType.Auto,) * 2)
B, L = inp["tokens"].shape
res = {{}}
for tag, ota in runs.items():
    step, init_fn, shardings_fn, _ = train.build_train_step(
        cfg, InputShape("tiny", L, B, "train"), mesh,
        train.TrainConfig(**fields, ota=dist.OTADistConfig(**ota)))
    state, axes = init_fn(jax.random.PRNGKey(0))
    sh = shardings_fn(axes)
    paths = jax.tree_util.tree_leaves_with_path(state["params"])
    params = jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(state["params"]),
        [jnp.asarray(inp["theta0/" + "/".join(k.key for k in p)])
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


def _cfg():
    return get_config("qwen2-0.5b").reduced().with_(compute_dtype="float32")


def _tcfg(ota):
    return train.TrainConfig(**FIELDS, ota=dist.OTADistConfig(**ota))


def _batch():
    g = torch.Generator().manual_seed(7)
    return {k: torch.randint(0, _cfg().vocab, (SHAPE.global_batch,
                                               SHAPE.seq_len),
                             generator=g, dtype=torch.int32)
            for k in ("tokens", "labels")}


# ---------------------------------------------------------------------------
# (f) layer by layer
# ---------------------------------------------------------------------------

def _bf16_cfg():
    """The bf16 case: qwen2-0.5b reduced at its bf16 compute, 4 layers."""
    return get_config("qwen2-0.5b").reduced().with_(n_layers=4)


def _loss_grads(params, batch, cfg) -> dict:
    """{leaf path: gradient} of `lm.lm_loss` at `params`."""
    leaves = [(p, t.detach().clone().requires_grad_())
              for p, t in tree_leaves(params)]
    lm.lm_loss(tree_from_paths(leaves), batch, cfg)[0].backward()
    return {p: t.grad for p, t in leaves}


def _layer_inputs():
    cfg = _cfg()
    rng = np.random.default_rng(11)
    B, L = 2, 64
    f32 = lambda *s: torch.tensor(rng.standard_normal(s).astype(np.float32))
    g = torch.Generator().manual_seed(1)
    return {"params4": lm.init_params(prng.PRNGKey(3), _bf16_cfg()),
            "batch512": {k: torch.randint(0, cfg.vocab, (1, 512),
                                          generator=g, dtype=torch.int32)
                         for k in ("tokens", "labels")},
            "params": lm.init_params(prng.PRNGKey(3), cfg),
            "x": f32(B, L, cfg.d_model), "w": f32(B, L, cfg.d_model),
            "ids": torch.tensor(rng.integers(0, cfg.vocab, (B, L))),
            "batch": {k: torch.tensor(rng.integers(0, cfg.vocab, (B, L)),
                                      dtype=torch.int32)
                      for k in ("tokens", "labels")}}


def _layer_runs(params, x, w, ids, batch):
    """{module: (output, {name: gradient})} of the attention of layer 0,
    its swiglu, the embedding and the whole `lm_loss`, each run on
    `params` (shards under active rules), with a fixed weighting of the
    output as the loss."""
    cfg = _cfg()
    acfg = lm._attn_cfg(cfg)
    L = x.shape[1]
    pos = torch.arange(L, dtype=torch.int32)[None].expand(x.shape[0], L)
    layer = lm._at(params["layers"], 0)
    out = {}

    def run(name, fn, tree, inp=None):
        leaves = [(p, t.detach().clone().requires_grad_())
                  for p, t in tree_leaves(tree)]
        xs = None if inp is None else inp.clone().requires_grad_()
        y = fn(tree_from_paths(leaves), xs)
        loss = y if y.ndim == 0 else torch.sum(y * w)
        loss.backward()
        grads = {"/".join(p): t.grad for p, t in leaves}
        if xs is not None:
            grads["x"] = xs.grad
        out[name] = (y.detach(), grads)

    run("attention", lambda p, xs: attention.prefill(p, xs, pos, acfg),
        layer["attn"], x)
    run("swiglu", lambda p, xs: mlp.swiglu(p, xs), layer["mlp"], x)
    run("embed", lambda p, _: core.embed(p, ids), params["embed"])
    run("lm_loss", lambda p, _: lm.lm_loss(p, batch, cfg)[0], params)
    return out


def _layer_worker(rank, world, data):
    from repro_torch.launch.mesh import make_mesh, refine_mesh

    torch.set_num_threads(1)
    cfg = _cfg()
    rmesh = refine_mesh(make_mesh((1, 1, 1, 2), device_type="cpu"),
                        users_per_cluster=1)
    rules = sh.make_rules(rmesh, cfg=cfg, inside_shardmap=True)
    specs = sh.param_sharding_tree(lm.param_axes(cfg), rules)
    with sh.axes_bound(rmesh), sh.set_rules(rules):
        params = tree_map(torch.clone,
                          sh.shard_tree(data["params"], specs))
        out = _layer_runs(params, data["x"], data["w"], data["ids"],
                          data["batch"])
    # the bf16 case's gradient, its shards gathered
    c16 = _bf16_cfg()
    rules = sh.make_rules(rmesh, cfg=c16, inside_shardmap=True)
    specs = sh.param_sharding_tree(lm.param_axes(c16), rules)
    with sh.axes_bound(rmesh), sh.set_rules(rules):
        g = _loss_grads(sh.shard_tree(data["params4"], specs),
                        data["batch512"], c16)
        g = sh.gather_tree(tree_from_paths(g.items()), specs)
    return {"model": rmesh.get_local_rank("model"), "out": out,
            "bf16": dict(tree_leaves(g))}


@pytest.fixture(scope="module")
def layers():
    data = _layer_inputs()
    return data, ranks.launch(_layer_worker, 2, "gloo", data)


def _fake_mesh(model):
    sizes = {"pod": 1, "cluster": 1, "user": 1, "model": 2}
    coords = {"pod": 0, "cluster": 0, "user": 0, "model": model}
    return SimpleNamespace(mesh_dim_names=tuple(sizes),
                           shape=tuple(sizes.values()), get_group=None,
                           get_local_rank=lambda name: coords[name])


@pytest.mark.parametrize("module", ["attention", "swiglu", "embed",
                                    "lm_loss"])
def test_layers_at_model_2_match_model_1(layers, module):
    data, res = layers
    cfg = _cfg()
    want_y, want_g = _layer_runs(data["params"], data["x"], data["w"],
                                 data["ids"], data["batch"])[module]
    axes = lm.param_axes(cfg)
    sub = {"attention": lambda t: lm._at(t["layers"], 0)["attn"],
           "swiglu": lambda t: lm._at(t["layers"], 0)["mlp"],
           "embed": lambda t: t["embed"], "lm_loss": lambda t: t}[module]
    layer_axes = lm._layer_axes(axes["layers"])
    sub_axes = {"attention": layer_axes["attn"], "swiglu": layer_axes["mlp"],
                "embed": axes["embed"], "lm_loss": axes}[module]
    specs = dict(zip(("/".join(p) for p, _ in tree_leaves(sub(
        data["params"]))), sh.spec_leaves(sh.param_sharding_tree(
            sub_axes, sh.make_rules({"pod": 1, "cluster": 1, "user": 1,
                                     "model": 2}, cfg=cfg,
                                    inside_shardmap=True)))))
    assert any("model" in s for s in specs.values())
    for r in res:
        got_y, got_g = r["out"][module]
        scale = max(float(want_y.abs().max()), 1e-30)
        assert float((got_y - want_y).abs().max()) <= LAYER_TOL * scale
        for name, g in want_g.items():
            if name != "x":
                with sh.axes_bound(_fake_mesh(r["model"])):
                    g = sh.shard_tree(g, specs[name])
            assert got_g[name].shape == g.shape, name
            gap = float((got_g[name] - g).abs().max())
            assert gap <= LAYER_TOL * float(g.abs().max()), (module, name)


def test_bf16_split_stays_within_bf16_spread(layers):
    """At bf16 compute the split's gradient lies from the one-card bf16
    gradient about as far as that lies from the float32 one: bf16's own
    rounding spread, which no bound tighter than it can hold the split
    to.  Held: the split within twice the spread of both (measured on
    the CPU: the spread 2.07e-2 of max |g|, the split 2.05e-2 from the
    float32 gradient and 2.06e-2 from the one-card bf16 one)."""
    data, res = layers
    c16 = _bf16_cfg()
    g16 = _loss_grads(data["params4"], data["batch512"], c16)
    g32 = _loss_grads(data["params4"], data["batch512"],
                      c16.with_(compute_dtype="float32"))
    g_max = max(float(g.abs().max()) for g in g32.values())
    gap = lambda a, b: max(float((a[p] - b[p]).abs().max())
                           for p in b) / g_max
    spread = gap(g16, g32)
    assert spread > 0
    for r in res:
        assert gap(r["bf16"], g32) <= 2 * spread
        assert gap(r["bf16"], g16) <= 2 * spread


# ---------------------------------------------------------------------------
# (e) the structural step
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def steps(tmp_path_factory):
    """The runs of RUNS on 4 ranks at (1, 1, 2, 2) and on one device, an
    unstepped `init_fn` on the ranks, and the JAX package's runs."""
    cfg = _cfg()
    theta0 = lm.init_params(prng.PRNGKey(0), cfg)
    batch = _batch()
    tmp = tmp_path_factory.mktemp("tp")
    inp = {f"theta0/{'/'.join(p)}": t.numpy() for p, t in
           tree_leaves(theta0)}
    inp.update({k: v.numpy() for k, v in batch.items()})
    np.savez(tmp / "inp.npz", **inp)
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=4",
               JAX_PLATFORMS="cpu", PYTHONPATH=os.path.join(_REPO, "src"))
    proc = subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(_JAX_SCRIPT.format(
            fields=FIELDS, runs=RUNS, steps=STEPS)), str(tmp / "inp.npz"),
         str(tmp / "jax.npz")], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        specs = [dict(cfg=cfg, shape=SHAPE, tcfg=_tcfg(ota),
                      mesh=(1, 1, 2, 2), batches=[batch],
                      keys=[10 + i for i in range(STEPS)], device="cpu",
                      params0=theta0, return_state=True)
                 for ota in RUNS.values()]
        specs.append(dict(specs[0], keys=[], params0=None))
        out = {}
        thread = threading.Thread(target=lambda: out.update(
            r=ranks.launch(ranks.train_worker, 4, "gloo", specs)))
        thread.start()
        one = {}
        for tag, ota in RUNS.items():
            step, init_fn = train.build_train_step(
                cfg, SHAPE, {"data": 2}, _tcfg(ota), device="cpu")
            state, _ = init_fn(prng.PRNGKey(0))
            state["params"] = tree_map(torch.clone, theta0)
            ms = []
            for i in range(STEPS):
                state, m = step(state, batch, prng.PRNGKey(10 + i))
                ms.append({k: float(v) for k, v in m.items()})
            one[tag] = (dict(tree_leaves(state["params"])), ms)
        thread.join()
        stdout, stderr = proc.communicate(timeout=900)
        assert proc.returncode == 0, stdout + "\n" + stderr
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert "r" in out, "the ranks' launch failed"
    ref = dict(np.load(tmp / "jax.npz"))
    jax_runs = {tag: ({tuple(k.split("/")[2:]): torch.tensor(v)
                       for k, v in ref.items()
                       if k.startswith(f"{tag}/params/")},
                      [{k: float(ref[f"{tag}/{k}/{i}"])
                        for k in ("loss", "edge_power")}
                       for i in range(STEPS)]) for tag in RUNS}
    per_run = {tag: [r[i] for r in out["r"]] for i, tag in enumerate(RUNS)}
    return {"ranks": per_run, "init": [r[len(RUNS)] for r in out["r"]],
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


@pytest.mark.parametrize("tag", RUNS)
def test_tensor_parallel_step_matches_reference(steps, tag):
    want, ms = steps["jax"][tag]
    assert len(steps["ranks"][tag]) == 4
    for r in steps["ranks"][tag]:
        _within_bounds(r["state"]["params"], r["metrics"], want, ms,
                       steps["theta0"])
        axes = {c["axes"] for c in r["collectives"]}
        assert {"model", "user"} <= axes, r["collectives"]
        assert set(r["coordinate"]) == {"pod", "cluster", "user", "model"}


@pytest.mark.parametrize("tag", RUNS)
def test_tensor_parallel_step_matches_one_card(steps, tag):
    want, ms = steps["one"][tag]
    for r in steps["ranks"][tag]:
        _within_bounds(r["state"]["params"], r["metrics"], want, ms,
                       steps["theta0"])


def test_tensor_parallel_init_gathers_to_the_whole_init(steps):
    want = dict(tree_leaves(lm.init_params(prng.PRNGKey(0), _cfg())))
    for r in steps["init"]:
        got = dict(tree_leaves(r["state"]["params"]))
        assert set(got) == set(want)
        assert all(torch.equal(got[p].view(torch.uint8).reshape(-1),
                               want[p].view(torch.uint8).reshape(-1))
                   for p in want)
