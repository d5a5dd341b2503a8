"""Placements executed on ranks (`repro_torch.sharding`: shards, the
collectives under autograd; `launch.train` with ``zero1`` and ``fsdp``),
on the CPU: gloo ranks spawned by `ranks.launch`, joined through a
`FileStore` under a temporary directory.

What is held, and to what:

- `convert.state_from_jax` with a spec tree: a rank's blocks of a numpy
  train state under ``zero1`` and ``fsdp`` on (1, 2, 2, 2).
- `prng.normal_at` at a shard's flat indices (`sharding.shard_index`)
  and `nn.core._normal` with a spec: a contiguous block, a strided one
  (the last dimension split), a 2-D one (both dimensions, one of them
  over two axes), each the same elements of `prng.normal`'s whole draw,
  bit for bit, on every coordinate.
- `psum_scatter` and the three collectives under autograd (`copy_to`,
  `reduce_from`, `gather_shards`) on 4 ranks at (1, 1, 2, 2): their
  values and gradients against the same sums made in one process, bit
  for bit (every group has two members).
- qwen2-0.5b ``.reduced()`` at float32, L 64, B 8 (local SGD: L 32, B
  16), outer AdamW, on 4 ranks at (1, 2, 2, 1): the structural step
  (`ideal` and `equivalent`) and local SGD (tau 2, I 2, `ideal`), each
  with ``zero1``, ``fsdp`` and both, 2 steps: the gathered state, the
  loss and `edge_power` equal the one-card port's (`{"data": 4}`, M 2)
  bit for bit, and the collectives include the data axes' gathers;
  ``init_fn`` under ``fsdp`` and ``zero1`` draws each rank's shards,
  which gather to the one-card `init_params` bit for bit (the moments
  zeros).  The fused step with ``fsdp`` (equivalent, `tx_power_proxy`
  1e-4, 2 steps) within ``tests/test_torch_ranks.py``'s fused bound:
  1e-6 of max |theta|, the loss and edge power rtol 1e-6 (measured on
  the CPU: 2.9e-7 of max |theta|).
- The JAX package's own case (`tests/test_dist.py`'s fused FSDP step on
  a (data 4, model 2) mesh): the port on 8 gloo ranks at (1, 2, 2, 2)
  against `build_fused_train_step` on ``jax.make_mesh((4, 2))`` of 8
  forced host devices (a subprocess, from the port's initial
  parameters), 2 steps, to ``tests/test_torch_ranks.py``'s bounds
  against JAX: loss and edge power rtol 1e-5 at every step; the
  update's norm rtol 1e-3; entrywise within 1e-4 of max |theta| on all
  but a share 1e-3 (measured on the CPU: every entry within 1.2e-5 of
  max |theta|, the loss and edge power within 1.4e-7 rel).

The file takes ~70 s alone on one core a process.
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
from repro_torch.nn import core
from repro_torch.sharding import api as sh
from repro_torch.tree import tree_leaves, tree_map

torch.set_num_threads(1)

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOSS_RTOL = 1e-5
THETA_TOL = 1e-4
NORM_RTOL = 1e-3
ADAM_PARTED = 1e-3
FUSED_TOL = 1e-6
SHAPES = {"b8": InputShape("tiny", 64, 8, "train"),
          "b16": InputShape("tiny", 32, 16, "train")}
ADAMW = dict(users_per_cluster=2, outer="adamw", outer_lr=2e-3)
# tag -> (batch, TrainConfig fields, steps)
STRUCT = {
    "ideal": ("b8", dict(ADAMW, tau=1, I=1, eta_local=1.0,
                         ota=dict(mode="ideal")), 2),
    "equivalent": ("b8", dict(ADAMW, tau=1, I=1, eta_local=1.0,
                              ota=dict(mode="equivalent")), 2),
    "local": ("b16", dict(ADAMW, tau=2, I=2, eta_local=5e-3,
                          ota=dict(mode="ideal")), 2),
}
PLACEMENTS = {"zero1": dict(zero1=True), "fsdp": dict(fsdp=True),
              "both": dict(zero1=True, fsdp=True)}
FUSED = ("b8", dict(ADAMW, tau=1, I=1, eta_local=1.0, fsdp=True,
                    ota=dict(mode="equivalent", tx_power_proxy=1e-4)), 2)

_JAX_SCRIPT = """
import sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import AxisType
from repro.configs import get_config
from repro.configs.base import InputShape
from repro.core import dist
from repro.launch import train

fields, steps = {fields!r}, {steps!r}
inp = dict(np.load(sys.argv[1]))
cfg = get_config("qwen2-0.5b").reduced().with_(compute_dtype="float32")
mesh = jax.make_mesh((4, 2), ("data", "model"),
                     axis_types=(AxisType.Auto,) * 2)
fields = dict(fields, ota=dist.OTADistConfig(**fields["ota"]))
B, L = inp["b8/tokens"].shape
step, init_fn, shardings_fn, _ = train.build_fused_train_step(
    cfg, InputShape("tiny", L, B, "train"), mesh,
    train.TrainConfig(**fields))
state, axes = init_fn(jax.random.PRNGKey(0))
sh = shardings_fn(axes)
paths = jax.tree_util.tree_leaves_with_path(state["params"])
params = jax.tree_util.tree_unflatten(
    jax.tree_util.tree_structure(state["params"]),
    [jnp.asarray(inp["theta0/" + "/".join(k.key for k in p)])
     for p, _ in paths])
state = dict(state, params=jax.device_put(params, sh["state"]["params"]))
jstep = jax.jit(step, in_shardings=(sh["state"], sh["batch"], sh["key"]),
                out_shardings=(sh["state"], sh["metrics"]))
batch = {{k: jnp.asarray(inp["b8/" + k]) for k in ("tokens", "labels")}}
res = {{}}
for i in range(steps):
    state, m = jstep(state, batch, jax.random.PRNGKey(10 + i))
    res[f"loss/{{i}}"] = np.asarray(m["loss"])
    res[f"edge_power/{{i}}"] = np.asarray(m["edge_power"])
for p, v in jax.tree_util.tree_leaves_with_path(
        jax.device_get(state["params"])):
    res["params/" + "/".join(k.key for k in p)] = np.asarray(v)
np.savez(sys.argv[2], **res)
print("OK")
"""


def _cfg():
    return get_config("qwen2-0.5b").reduced().with_(compute_dtype="float32")


def _tcfg(fields, **extra):
    return train.TrainConfig(**dict(fields, **extra, ota=dist.OTADistConfig(
        **fields["ota"])))


def _batches():
    cfg = _cfg()
    g = torch.Generator().manual_seed(7)
    return {b: {k: torch.randint(0, cfg.vocab, (s.global_batch, s.seq_len),
                                 generator=g, dtype=torch.int32)
                for k in ("tokens", "labels")} for b, s in SHAPES.items()}


def _bits(t):
    return t.contiguous().reshape(-1).view(torch.uint8)


def _same_bits(a, b) -> bool:
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        _bits(a), _bits(b))


def _one_card(b, fields, steps, theta0, batches, fused=False):
    build = train.build_fused_train_step if fused else train.build_train_step
    step, init_fn = build(_cfg(), SHAPES[b], {"data": 4}, _tcfg(fields),
                          device="cpu")
    state, _ = init_fn(prng.PRNGKey(0))
    state["params"] = tree_map(torch.clone, theta0)
    ms = []
    for i in range(steps):
        state, m = step(state, batches[b], prng.PRNGKey(10 + i))
        ms.append(m)
    return state, ms


# ---------------------------------------------------------------------------
# (a) draws at a shard's flat indices
# ---------------------------------------------------------------------------

def _fake_mesh(sizes, coords):
    """A mesh's names, sizes and this rank's coordinates: all that the
    shard helpers read (no process group)."""
    return SimpleNamespace(mesh_dim_names=tuple(sizes),
                           shape=tuple(sizes.values()), get_group=None,
                           get_local_rank=lambda name: coords[name])


DRAW_CASES = {
    "contiguous": ((12, 10), ("user", None)),
    "strided": ((6, 20), (None, "model")),
    "two_dims": ((8, 12), (("cluster", "user"), "model")),
}
SIZES = {"pod": 1, "cluster": 2, "user": 2, "model": 2}


@pytest.mark.parametrize("case", DRAW_CASES)
def test_normal_at_shards_equal_the_whole_draw_bitwise(case):
    shape, spec = DRAW_CASES[case]
    key = prng.PRNGKey(123)
    whole = prng.normal(key, shape)
    blocks = {}
    for c in range(2):
        for u in range(2):
            for m in range(2):
                coords = {"pod": 0, "cluster": c, "user": u, "model": m}
                with sh.axes_bound(_fake_mesh(SIZES, coords)):
                    want = sh.shard_tree(whole, sh.P(*spec))
                    idx = sh.shard_index(shape, spec)
                    got = prng.normal_at(key, idx)
                    drawn = core._normal(key, shape, 1.0, torch.float32,
                                         sh.P(*spec))
                assert got.shape == want.shape == idx.shape
                assert _same_bits(got, want.contiguous()), coords
                assert _same_bits(drawn, want.contiguous()), coords
                blocks[tuple(idx.reshape(-1).tolist())] = True
    # the shards cover the draw, each index once
    flat = [i for k in blocks for i in k]
    assert sorted(set(flat)) == list(range(whole.numel()))


def test_state_from_jax_gives_a_rank_its_shards():
    """`convert.state_from_jax` with the state's spec tree: each rank's
    blocks of the numpy state (the moments and parameters cut alike)."""
    from repro_torch import convert

    cfg = _cfg()
    rng = np.random.default_rng(2)
    params = tree_map(lambda t: rng.standard_normal(t.shape).astype(
        np.float32), lm.init_params(prng.PRNGKey(0, "meta"), cfg))
    state = {"params": params, "opt": {"m": params, "v": params},
             "step": np.int32(3)}
    sizes = {"pod": 1, "cluster": 2, "user": 2, "model": 2}
    specs = train.state_specs(
        cfg, SHAPES["b8"], sizes, _tcfg(STRUCT["ideal"][1], zero1=True,
                                        fsdp=True))
    for coords in ({"pod": 0, "cluster": 0, "user": 1, "model": 1},
                   {"pod": 0, "cluster": 1, "user": 0, "model": 0}):
        mesh = _fake_mesh(sizes, coords)
        got = convert.state_from_jax(state, specs=specs, mesh=mesh)
        assert int(got["step"]) == 3
        with sh.axes_bound(mesh):
            leaf_specs = dict(zip((q for q, _ in tree_leaves(params)),
                                  sh.spec_leaves(specs["params"])))
            for part in (got["params"], got["opt"]["m"]):
                for p, t in tree_leaves(part):
                    whole = torch.tensor(dict(tree_leaves(params))[p])
                    assert torch.equal(t, sh.shard_tree(
                        whole, leaf_specs[p])), p
        assert got["params"]["lm_head"]["w"].shape == (cfg.d_model // 4,
                                                       cfg.vocab // 2)


# ---------------------------------------------------------------------------
# (b) the collectives under autograd
# ---------------------------------------------------------------------------

def _collective_worker(rank, world, data):
    from repro_torch.launch.mesh import make_mesh, refine_mesh

    torch.set_num_threads(1)
    rmesh = refine_mesh(make_mesh((1, 1, 2, 2), device_type="cpu"),
                        users_per_cluster=2)
    u, m = rmesh.get_local_rank("user"), rmesh.get_local_rank("model")
    out = {"user": u, "model": m}
    with sh.axes_bound(rmesh):
        out["psum_scatter"] = sh.psum_scatter(data["x"][u], "user", 1)
        x = data["x"][u].clone().requires_grad_()
        y = sh.copy_to(x, "model")
        torch.sum(y * data["w"][m]).backward()
        out["copy_to"] = (y.detach(), x.grad)
        x = data["x"][m].clone().requires_grad_()
        y = sh.reduce_from(x, "model")
        torch.sum(y * data["w"][0]).backward()
        out["reduce_from"] = (y.detach(), x.grad)
        x = data["x"][u][:, 3 * u:3 * u + 3].clone().requires_grad_()
        y = sh.gather_shards(x, "user", 1)
        torch.sum(y * data["w"][u]).backward()
        out["gather_shards"] = (y.detach(), x.grad)
    return out


def test_psum_scatter_and_autograd_collectives_match_one_process():
    rng = np.random.default_rng(5)
    data = {k: torch.tensor(rng.standard_normal((2, 4, 6)).astype(
        np.float32)) for k in ("x", "w")}
    x, w = data["x"], data["w"]
    res = ranks.launch(_collective_worker, 4, "gloo", data)
    for r in res:
        u, m = r["user"], r["model"]
        assert torch.equal(r["psum_scatter"], (x[0] + x[1])[:, 3 * u:3 * u + 3])
        y, g = r["copy_to"]
        assert torch.equal(y, x[u]) and torch.equal(g, w[0] + w[1])
        y, g = r["reduce_from"]
        assert torch.equal(y, x[0] + x[1]) and torch.equal(g, w[0])
        y, g = r["gather_shards"]
        assert torch.equal(y, torch.cat([x[0][:, 0:3], x[1][:, 3:6]], 1))
        assert torch.equal(g, (w[0] + w[1])[:, 3 * u:3 * u + 3])


# ---------------------------------------------------------------------------
# (c), (d) the steps
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """The initial parameters and batches, and the JAX package's fused
    FSDP run on (data 4, model 2) from them, started here so that it
    compiles while the ranks run."""
    theta0 = lm.init_params(prng.PRNGKey(0), _cfg())
    batches = _batches()
    tmp = tmp_path_factory.mktemp("fsdp")
    inp = {f"theta0/{'/'.join(p)}": t.numpy() for p, t in
           tree_leaves(theta0)}
    inp.update({f"b8/{k}": v.numpy() for k, v in batches["b8"].items()})
    np.savez(tmp / "inp.npz", **inp)
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu", PYTHONPATH=os.path.join(_REPO, "src"))
    proc = subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(_JAX_SCRIPT.format(
            fields=FUSED[1], steps=FUSED[2])), str(tmp / "inp.npz"),
         str(tmp / "jax.npz")], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    yield theta0, batches, tmp, proc
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


def _spec(b, fields, steps, theta0, batches, mesh=(1, 2, 2, 1), **kw):
    return dict(cfg=_cfg(), shape=SHAPES[b], tcfg=_tcfg(fields, **kw.pop(
        "extra", {})), mesh=mesh, batches=[batches[b]],
        keys=[10 + i for i in range(steps)], device="cpu", params0=theta0,
        return_state=True, **kw)


@pytest.fixture(scope="module")
def runs(inputs):
    """Every structural run of STRUCT under each placement, the fused
    FSDP run and an unstepped ``init_fn`` under both placements, in one
    launch of 4 gloo ranks; the fused run on 8 ranks at (1, 2, 2, 2);
    the one-card runs beside them; the JAX run."""
    theta0, batches, tmp, proc = inputs
    specs, tags = [], []
    for tag, (b, fields, steps) in STRUCT.items():
        for place, extra in PLACEMENTS.items():
            specs.append(_spec(b, fields, steps, theta0, batches,
                               extra=extra))
            tags.append((tag, place))
    specs.append(_spec(*FUSED, theta0, batches, fused=True))
    tags.append(("fused", "fsdp"))
    init = _spec(*STRUCT["ideal"], None, batches,
                 extra=PLACEMENTS["both"])
    init["keys"] = []
    specs.append(init)
    tags.append(("init", "both"))
    out = {}

    def launch():
        out["4"] = ranks.launch(ranks.train_worker, 4, "gloo", specs)
        out["8"] = ranks.launch(ranks.train_worker, 8, "gloo", _spec(
            *FUSED, theta0, batches, mesh=(1, 2, 2, 2), fused=True))
    thread = threading.Thread(target=launch)
    thread.start()
    one = {tag: _one_card(b, fields, steps, theta0, batches)
           for tag, (b, fields, steps) in STRUCT.items()}
    one["fused"] = _one_card(*FUSED, theta0, batches, fused=True)
    thread.join()
    stdout, stderr = proc.communicate(timeout=900)
    assert proc.returncode == 0, stdout + "\n" + stderr
    assert "4" in out and "8" in out, "a launch failed"
    per_run = {t: [r[i] for r in out["4"]] for i, t in enumerate(tags)}
    return {"ranks": per_run, "eight": out["8"], "one": one,
            "theta0": theta0, "jax": dict(np.load(tmp / "jax.npz"))}


@pytest.mark.parametrize("place", PLACEMENTS)
@pytest.mark.parametrize("tag", STRUCT)
def test_zero1_and_fsdp_equal_the_one_card_step_bitwise(runs, tag, place):
    state, ms = runs["one"][tag]
    want = dict(tree_leaves(state))
    for r in runs["ranks"][tag, place]:
        got = dict(tree_leaves(r["state"]))
        assert set(got) == set(want)
        bad = [p for p in want if not _same_bits(got[p], want[p])]
        assert not bad, (tag, place, r["rank"], bad[:5])
        for i, m in enumerate(ms):
            for k in ("loss", "edge_power"):
                assert _same_bits(r["raw_metrics"][i][k], m[k]), (k, i)
        gathers = {c["axes"] for c in r["collectives"]
                   if c["op"] == "all_gather"}
        assert gathers == {"cluster/user"}, r["collectives"]


def test_sharded_init_gathers_to_the_whole_init(runs):
    cfg = _cfg()
    want = dict(tree_leaves(lm.init_params(prng.PRNGKey(0), cfg)))
    for r in runs["ranks"]["init", "both"]:
        got = r["state"]
        assert all(_same_bits(t, want[p]) for p, t in tree_leaves(
            got["params"]))
        assert set(dict(tree_leaves(got["params"]))) == set(want)
        for mom in ("m", "v"):
            assert all(torch.equal(t, torch.zeros_like(want[p])) for p, t
                       in tree_leaves(got["opt"][mom]))


def test_fused_fsdp_step_on_ranks_matches_one_card(runs):
    state, ms = runs["one"]["fused"]
    want = dict(tree_leaves(state["params"]))
    theta_max = max(float(w.abs().max()) for w in want.values())
    for r in runs["ranks"]["fused", "fsdp"]:
        got = dict(tree_leaves(r["state"]["params"]))
        gap = max(float((got[p] - w).abs().max()) for p, w in want.items())
        assert gap <= FUSED_TOL * theta_max, (r["rank"], gap / theta_max)
        for i, m in enumerate(ms):
            for k in ("loss", "edge_power"):
                assert abs(r["metrics"][i][k] - float(m[k])) <= (
                    FUSED_TOL * abs(float(m[k]))), (k, i)
        ops = {(c["op"], c["axes"]) for c in r["collectives"]}
        assert ("psum_scatter", "cluster/user") in ops
        assert ("all_gather", "cluster/user") in ops


def test_fused_fsdp_on_data_and_model_matches_reference(runs):
    """tests/test_dist.py's fused FSDP case on (data 4, model 2)."""
    ref = runs["jax"]
    p0 = dict(tree_leaves(runs["theta0"]))
    want = {tuple(k.split("/")[1:]): torch.tensor(v) for k, v in ref.items()
            if k.startswith("params/")}
    theta_max = max(float(w.abs().max()) for w in want.values())
    upd = lambda tr: torch.sqrt(sum(torch.sum((tr[p] - p0[p]) ** 2)
                                    for p in want))
    assert len(runs["eight"]) == 8
    for r in runs["eight"]:
        for i, m in enumerate(r["metrics"]):
            for k in ("loss", "edge_power"):
                w = float(ref[f"{k}/{i}"])
                assert abs(m[k] - w) <= LOSS_RTOL * abs(w), (k, i)
        got = dict(tree_leaves(r["state"]["params"]))
        assert set(got) == set(want)
        gaps = np.concatenate([(got[p] - w).abs().flatten().numpy()
                               for p, w in want.items()])
        assert abs(float(upd(got)) - float(upd(want))) <= NORM_RTOL * float(
            upd(want))
        assert (gaps > THETA_TOL * theta_max).mean() <= ADAM_PARTED
        axes = {c["axes"] for c in r["collectives"]}
        assert "model" in axes and "cluster/user" in axes
