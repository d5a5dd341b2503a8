"""The port's W-HFL training path (`repro_torch.core.dist`,
`repro_torch.launch.train`, `launch.mesh.mesh_counts`) against the JAX
package's, on the CPU.

The reference runs as `tests/test_dist.py` runs it: JAX's mesh (4, 2)
("data", "model") on 8 fake host devices in a subprocess, refined into
2 clusters x 2 users x model 2.  One module-scoped subprocess makes
every reference output (the hops on a two-leaf tree, three train-step
runs from one initial state) and writes them with their inputs to one
.npz; the port starts from the same state and inputs.

Tolerances, and why:

- the hops (`cluster_hop`, `global_hop`, `whfl_aggregate` structural
  and fused, per-element and scalar interference, without interference,
  ideal): within 1e-6 of the largest output.  The draws are the same
  normals (within the emulation's few ULP) and the sums the same
  products in at most another order.
- the train steps, at float32 compute (bf16 rounds the loss itself by
  ~2e-4 on the two frameworks differently): loss and edge power to rtol
  1e-5 at every step; the initial state within 4 ULP (`init_fn`, the
  `jax.random` emulation); under ``outer="add"`` the parameters within
  1e-4 of max |theta|.
- under AdamW, Adam turns rounding noise into whole steps wherever the
  pseudo-gradient's entry is about as small as its rounding (queue C's
  fig3 finding): such an entry steps by up to 2 lr apart on the two
  platforms (3 of the fused step's 131,072 embedding entries did).  So
  the update (theta - theta0) is held by its norm, to rtol 1e-3, and
  entry by entry within 1e-4 of max |theta| on all but a share 1e-3 of
  the entries; Adam's step alone on the same inputs is held in
  ``tests/test_torch_train.py``.  A later step's loss reads the
  parameters so moved, so the AdamW run is the structural one, whose
  entries did not part at this seed, and the fused and local-SGD runs
  apply their estimate directly ("add").
"""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch import prng
from repro_torch.configs import get_config
from repro_torch.configs.base import InputShape
from repro_torch.core import dist
from repro_torch.launch import train
from repro_torch.launch.mesh import mesh_counts
from repro_torch.tree import tree_from_paths, tree_leaves, tree_map

torch.set_num_threads(1)

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HOP_TOL = 1e-6
LOSS_RTOL = 1e-5
THETA_TOL = 1e-4
NORM_RTOL = 1e-3
ADAM_PARTED = 1e-3
MESH = {"data": 4, "model": 2}
GEOM = dict(C=2, M=2, K=16, K_ps=8, sigma_z2=0.5)
HOPS = {
    "per_element": dict(),
    "scalar": dict(per_element_interference=False),
    "no_interference": dict(interference=False),
    "ideal": dict(mode="ideal"),
    "fused": dict(fused=True),
    "fused_ideal": dict(mode="ideal", fused=True),
}
SHAPES = {"b8": InputShape("tiny", 64, 8, "train"),
          "b16": InputShape("tiny", 32, 16, "train")}
# tag -> (build, batch, TrainConfig fields, steps)
RUNS = {
    "struct_equivalent": ("build_train_step", "b8", dict(
        tau=1, I=1, users_per_cluster=2, eta_local=1.0, outer="adamw",
        outer_lr=2e-3, ota=dict(mode="equivalent")), 2),
    "local_ideal": ("build_train_step", "b16", dict(
        tau=2, I=2, users_per_cluster=2, eta_local=5e-3, outer="add",
        ota=dict(mode="ideal")), 1),
    "local_equivalent": ("build_train_step", "b16", dict(
        tau=2, I=2, users_per_cluster=2, eta_local=5e-3, outer="add",
        ota=dict(mode="equivalent")), 1),
    "fused_proxy": ("build_fused_train_step", "b8", dict(
        tau=1, I=1, users_per_cluster=2, eta_local=0.05, outer="add",
        grad_accum=2, ota=dict(tx_power_proxy=1e-4)), 2),
}

_SCRIPT = """
import sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import AxisType, PartitionSpec as P
from repro.configs import get_config
from repro.configs.base import InputShape
from repro.core import dist
from repro.launch import train
from repro.launch.mesh import refine_mesh
from repro.sharding import shard_map

HOPS, RUNS, GEOM = {hops!r}, {runs!r}, {geom!r}
res = {{}}
mesh = jax.make_mesh((4, 2), ("data", "model"),
                     axis_types=(AxisType.Auto,) * 2)
rmesh = refine_mesh(mesh, users_per_cluster=2)
U = ("pod", "cluster", "user")

def put(prefix, tree):
    for path, v in jax.tree_util.tree_leaves_with_path(jax.device_get(tree)):
        res[prefix + "/".join(k.key for k in path)] = np.asarray(v)

rng = np.random.default_rng(3)
tree = {{"b": {{"c": 0.1 * rng.standard_normal((4, 7)).astype(np.float32)}},
        "a": 0.1 * rng.standard_normal((4, 6, 5)).astype(np.float32)}}
put("hop_in/", tree)
geom = dist.uniform_geom(**GEOM)
for name, kw in HOPS.items():
    cfg = dist.OTADistConfig(**kw)

    def f(x, k, cfg=cfg):
        t = jax.tree.map(lambda v: v[0], x)
        lift = lambda tr: jax.tree.map(lambda v: v[None], tr)
        return (lift(dist.cluster_hop(t, geom, k, 1.0, cfg)),
                lift(dist.global_hop(t, geom, k, 20.0, cfg)),
                lift(dist.whfl_aggregate(t, geom, k, 1.0, 20.0, cfg)))
    fn = jax.jit(shard_map(f, mesh=rmesh, in_specs=(P(U), P()),
                           out_specs=(P(U), P(U), P(U)), check_vma=False))
    for tag, out in zip(("cluster", "global", "whfl"),
                        fn(tree, jax.random.PRNGKey(5))):
        put(f"hops/{{name}}/{{tag}}/", out)

cfg = get_config("qwen2-0.5b").reduced().with_(compute_dtype="float32")
for b, (L, B) in (("b8", (64, 8)), ("b16", (32, 16))):
    res[b + "/tokens"] = np.asarray(jax.random.randint(
        jax.random.PRNGKey(1), (B, L), 0, cfg.vocab))
    res[b + "/labels"] = np.asarray(jax.random.randint(
        jax.random.PRNGKey(2), (B, L), 0, cfg.vocab))
first = True
for tag, (build, b, fields, steps) in RUNS.items():
    fields = dict(fields, ota=dist.OTADistConfig(**fields["ota"]))
    B, L = res[b + "/tokens"].shape
    step, init_fn, shardings_fn, _ = getattr(train, build)(
        cfg, InputShape("tiny", L, B, "train"), mesh,
        train.TrainConfig(**fields))
    state, axes = init_fn(jax.random.PRNGKey(0))
    if first:
        put("init/", state["params"])
        first = False
    sh = shardings_fn(axes)
    jstep = jax.jit(step, in_shardings=(sh["state"], sh["batch"], sh["key"]),
                    out_shardings=(sh["state"], sh["metrics"]))
    batch = {{k: jnp.asarray(res[b + "/" + k]) for k in ("tokens", "labels")}}
    for i in range(steps):
        state, m = jstep(state, batch, jax.random.PRNGKey(10 + i))
        res[f"{{tag}}/loss/{{i}}"] = np.asarray(m["loss"])
        res[f"{{tag}}/edge_power/{{i}}"] = np.asarray(m["edge_power"])
    put(f"{{tag}}/params/", state["params"])
np.savez(sys.argv[1], **res)
print("OK")
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    out = tmp_path_factory.mktemp("dist_ref") / "ref.npz"
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    env["PYTHONPATH"] = os.path.join(_REPO, "src")
    script = textwrap.dedent(_SCRIPT.format(hops=HOPS, runs=RUNS, geom=GEOM))
    proc = subprocess.run([sys.executable, "-c", script, str(out)], env=env,
                          capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stdout + "\n" + proc.stderr
    return dict(np.load(out))


def _tree(ref, prefix):
    return tree_from_paths(
        (tuple(k[len(prefix):].split("/")), torch.tensor(v))
        for k, v in ref.items() if k.startswith(prefix))


def _rel(got, want) -> float:
    want = np.asarray(want)
    return float(np.abs(np.asarray(got) - want).max()
                 / max(np.abs(want).max(), 1e-30))


def _cfg():
    return get_config("qwen2-0.5b").reduced().with_(compute_dtype="float32")


def _tcfg(fields):
    return train.TrainConfig(**dict(fields, ota=dist.OTADistConfig(
        **fields["ota"])))


@pytest.mark.parametrize("name", list(HOPS))
def test_hops_match_reference(ref, name):
    """Per mesh coordinate (pod, cluster, user) = row u: the cluster hop's
    output is cluster u // M's estimate, the global hop's (each user's own
    delta standing as its cluster's) sums the clusters' rows of user
    u % M, and `whfl_aggregate` is the PS's estimate everywhere."""
    geom = dist.uniform_geom(**GEOM)
    cfg = dist.OTADistConfig(**HOPS[name])
    C, M = GEOM["C"], GEOM["M"]
    deltas = tree_map(lambda t: t.reshape((C, M) + t.shape[1:]),
                      _tree(ref, "hop_in/"))
    key = prng.PRNGKey(5)
    est_c = dist.cluster_hop(deltas, geom, key, 1.0, cfg)
    est_g = [dist.global_hop(tree_map(lambda t: t[:, m], deltas), geom, key,
                             20.0, cfg) for m in range(M)]
    est = dist.whfl_aggregate(deltas, geom, key, 1.0, 20.0, cfg)
    for path, _ in tree_leaves(deltas):
        leaf = "/".join(path)
        pick = lambda tr: dict(tree_leaves(tr))[path].numpy()
        for u in range(C * M):
            c, m = divmod(u, M)
            assert _rel(pick(est_c)[c],
                        ref[f"hops/{name}/cluster/{leaf}"][u]) <= HOP_TOL
            assert _rel(pick(est_g[m]),
                        ref[f"hops/{name}/global/{leaf}"][u]) <= HOP_TOL
            assert _rel(pick(est),
                        ref[f"hops/{name}/whfl/{leaf}"][u]) <= HOP_TOL


def test_init_fn_matches_reference(ref):
    step, init_fn = train.build_train_step(
        _cfg(), SHAPES["b8"], MESH, _tcfg(RUNS["struct_equivalent"][2]),
        device="cpu")
    state, axes = init_fn(prng.PRNGKey(0))
    assert set(state) == {"params", "opt", "step"}
    assert state["step"].dtype == torch.int32 and int(state["step"]) == 0
    want = dict(tree_leaves(_tree(ref, "init/")))
    got = dict(tree_leaves(state["params"]))
    assert set(got) == set(want)
    for path, w in want.items():
        assert got[path].shape == w.shape and got[path].dtype == w.dtype
        assert _rel(got[path].numpy(), w.numpy()) <= 4 * 2 ** -23, path
    opt = dict(tree_leaves(state["opt"]))
    assert set(opt) == {("m",) + p for p in want} | {("v",) + p
                                                      for p in want}
    assert all(float(t.abs().max()) == 0 for t in opt.values())


@pytest.mark.parametrize("tag", list(RUNS))
def test_train_step_matches_reference(ref, tag):
    build, b, fields, steps = RUNS[tag]
    tcfg = _tcfg(fields)
    step, init_fn = getattr(train, build)(_cfg(), SHAPES[b], MESH, tcfg,
                                            device="cpu")
    theta0 = _tree(ref, "init/")
    state = dict(init_fn(prng.PRNGKey(0))[0],
                 params=tree_map(torch.clone, theta0))
    batch = {k: torch.tensor(ref[f"{b}/{k}"]) for k in ("tokens", "labels")}
    for i in range(steps):
        state, m = step(state, batch, prng.PRNGKey(10 + i))
        for k in ("loss", "edge_power"):
            want = float(ref[f"{tag}/{k}/{i}"])
            assert abs(float(m[k]) - want) <= LOSS_RTOL * abs(want), (k, i)
    assert int(state["step"]) == steps
    want = dict(tree_leaves(_tree(ref, f"{tag}/params/")))
    got = dict(tree_leaves(state["params"]))
    p0 = dict(tree_leaves(theta0))
    theta_max = max(float(w.abs().max()) for w in want.values())
    gaps = np.concatenate([(got[p] - w).abs().flatten().numpy()
                           for p, w in want.items()])
    if tcfg.outer == "add":
        assert gaps.max() <= THETA_TOL * theta_max
        return
    upd = lambda tr: torch.sqrt(sum(torch.sum((tr[p] - p0[p]) ** 2)
                                    for p in want))
    assert abs(float(upd(got)) - float(upd(want))) <= NORM_RTOL * float(
        upd(want))
    assert (gaps > THETA_TOL * theta_max).mean() <= ADAM_PARTED


def test_structural_step_learns_a_fixed_batch():
    """As tests/test_dist.py::test_train_step_runs_and_learns holds the
    reference: the ideal channel, AdamW, 4 steps on one batch."""
    cfg = get_config("qwen2-0.5b").reduced()
    step, init_fn = train.build_train_step(
        cfg, InputShape("tiny", 64, 8, "train"), MESH,
        train.TrainConfig(tau=1, I=1, users_per_cluster=2, eta_local=1.0,
                          outer="adamw", outer_lr=2e-3,
                          ota=dist.OTADistConfig(mode="ideal")),
        device="cpu")
    state, _ = init_fn(prng.PRNGKey(0))
    g = torch.Generator().manual_seed(1)
    batch = {k: torch.randint(0, cfg.vocab, (8, 64), generator=g)
             for k in ("tokens", "labels")}
    losses = []
    for i in range(4):
        state, m = step(state, batch, prng.PRNGKey(i))
        losses.append(float(m["loss"]))
        assert np.isfinite(losses[-1]) and float(m["edge_power"]) >= 0
    assert losses[-1] < losses[0], losses


@pytest.mark.parametrize("mesh,M,want", [
    ({"data": 4, "model": 2}, 2, (1, 2, 2)),
    ({"data": 16, "model": 16}, 4, (1, 4, 4)),
    ({"pod": 2, "data": 16, "model": 16}, 4, (2, 8, 4)),
    ({"pod": 1, "cluster": 3, "user": 5, "model": 2}, 4, (1, 3, 5)),
])
def test_mesh_counts(mesh, M, want):
    assert mesh_counts(mesh, M) == want


def test_geom_from_topology_matches_reference():
    from repro.core import dist as jdist
    from repro.core.topology import random_topology as j_random_topology
    from repro_torch.core.topology import Topology
    jt = j_random_topology(C=3, M=4, K=16, K_ps=8, seed=2)
    tt = Topology(**{f: getattr(jt, f) for f in Topology.__dataclass_fields__})
    for pods in (1, 2):
        want = jdist.geom_from_topology(jt, n_pods=pods)
        got = dist.geom_from_topology(tt, n_pods=pods)
        for f in ("C", "M", "K", "K_ps", "sigma_h2", "sigma_z2"):
            assert getattr(got, f) == getattr(want, f)
        for f in ("beta_own", "beta_cross", "beta_is", "beta_bar_c"):
            assert np.array_equal(getattr(got, f), getattr(want, f)), f
        assert got.beta_bar == want.beta_bar


def test_make_batch_and_refusals():
    cfg = get_config("llava-next-34b").reduced()
    b = train.make_batch(cfg, InputShape("t", 32, 4, "train"))
    assert {k: (tuple(v.shape), v.dtype) for k, v in b.items()} == {
        "tokens": ((4, 32), torch.int32), "labels": ((4, 32), torch.int32),
        "patch_embeds": ((4, cfg.n_patches, cfg.d_model), cfg.cdt())}
    enc = get_config("seamless-m4t-medium").reduced()
    assert tuple(train.make_batch(enc, InputShape("t", 8, 2, "train"))[
        "src_frames"].shape) == (2, enc.enc_src_frames, enc.d_model)
    tcfg = train.TrainConfig(users_per_cluster=2)
    with pytest.raises(ValueError, match="not divisible by 4 users"):
        train.build_train_step(cfg, InputShape("t", 8, 6, "train"), MESH,
                               tcfg, device="cpu")
    with pytest.raises(ValueError, match="I\\*tau"):
        train.build_train_step(cfg, InputShape("t", 8, 4, "train"), MESH,
                               train.TrainConfig(users_per_cluster=2, tau=2),
                               device="cpu")
    with pytest.raises(ValueError, match="tau = I = 1"):
        train.build_fused_train_step(cfg, InputShape("t", 8, 8, "train"),
                                     MESH, train.TrainConfig(tau=2),
                                     device="cpu")


def test_train_steps_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("checks the default where there is no card")
    cfg = get_config("qwen2-0.5b").reduced()
    for build in (train.build_train_step, train.build_fused_train_step):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            build(cfg, InputShape("t", 8, 8, "train"), MESH,
                    train.TrainConfig(users_per_cluster=2))
