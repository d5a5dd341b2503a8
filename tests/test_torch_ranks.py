"""W-HFL training with one process per mobile user (`repro_torch.launch.
ranks`, `sharding.shard_map`, `core.dist`'s per-coordinate hops,
`launch.train` on a `DeviceMesh`), on the CPU: gloo ranks spawned by
`ranks.launch`, joined through a `FileStore` under a temporary
directory (no port, so xdist workers never collide).

What is held, and to what:

- the hops on 8 ranks, mesh (pod, cluster, user, model) = (2, 2, 2, 1)
  (4 clusters of 2 users): every cluster-hop collective goes over a
  `user` group of M = 2 ranks, every global-hop one over a `(pod,
  cluster)` group of pod x cluster = 4, every fused-hop one over all 8
  (counted by `sharding.record_collectives`, as ``tests/test_dist.py``
  counts the grouped all-reduces in the HLO); the cluster hop equals the
  one-card form bit for bit (its groups have two members); the global
  and the whole aggregation within 1e-6 of the largest output
  (``tests/test_torch_dist.py``'s hop tolerance: the same products
  summed over four clusters in the backend's order); the ideal
  aggregation is the exact mean within rtol 1e-6, as the reference's
  test holds it.
- the structural step on qwen2-0.5b ``.reduced()`` at float32 compute,
  L 64, B 8, outer AdamW, on 4 ranks at (1, 2, 2, 1), `ideal` and
  `equivalent`, 2 steps: the parameters, AdamW's moments, the loss and
  `edge_power` equal the one-card port's (`{"data": 4}`, M 2) bit for
  bit (every group has two members, and the scalar means are gathered
  and averaged as the one-card step averages its users); against the
  JAX package's `build_train_step` on a (4, 1) mesh of 4 forced host
  devices (a subprocess, started from the port's initial parameters)
  to ``tests/test_torch_dist.py``'s float32 bounds: loss and edge power
  rtol 1e-5 at every step; under AdamW the update by its norm (rtol
  1e-3) and entry by entry within 1e-4 of max |theta| on all but a
  share 1e-3.
- local SGD (tau 2, I 2, outer "add", B 16, L 32, the ideal channel:
  the equivalent one's draws cost seconds on the CPU and run in the
  structural cases) on (1, 2, 2, 1) and the structural step with two
  pods on (2, 1, 2, 1) (the equivalent channel, whose keys fold the
  global cluster index pod x clusters + cluster): bit for bit the
  one-card port; and both against the JAX package's `build_train_step`
  to the structural cases' bounds, the two pods on a (pod, data, model)
  = (2, 2, 1) mesh of 4 forced host devices (so a key-folding fault
  shared by the port's two forms shows there).  Measured on the CPU,
  all four JAX runs: loss and edge power within 8.6e-7 rel, the
  update's norm within 6.8e-8 rel, every entry within 2.9e-4 of max
  |theta| and at most a share 1.6e-6 past 1e-4 of it.
- the fused step (grad_accum 2) on 4 ranks: its one flat all-reduce
  over four ranks adds the users' gradients in gloo's order, and each
  rank's gradient sums its own rows only where the one-card backward
  sums all rows at once; so the parameters within 1e-6 of max |theta|
  and the loss and edge power within rtol 1e-6 of the one-card step's
  (measured on the CPU: 2.7e-8 of max |theta|, 12 of the 15 leaves
  apart in their bits; the loss and edge power equal).
- what runs and what stays refused on ranks: the sequence-parallel
  "q_seq" route (qwen2-0.5b ``.reduced()`` with 6 heads and
  ``seq_shard_attn`` over a "model" axis of 4) draws its state and
  takes a step, finite (held to JAX and the one-card step by
  ``tests/test_torch_qseq.py``), while a MoE under a "model" axis of 2
  raises `NotImplementedError` naming ROADMAP queue A item 11; for both
  `shardings` returns the specs (``fsdp``, ``zero1`` and a dense
  model's "model" axis run: ``tests/test_torch_fsdp.py``,
  ``tests/test_torch_tp.py``, ``tests/test_torch_qseq.py``).

The 4 ranks' runs take ~40 s of wall time, side by side with the
one-card runs and one JAX subprocess per reference run; the file ~75 s
alone on one core a process.
"""
import os
import subprocess
import sys
import textwrap
import threading

import numpy as np
import pytest
import torch

from repro_torch import prng
from repro_torch.configs import get_config
from repro_torch.configs.base import InputShape
from repro_torch.core import dist
from repro_torch.launch import ranks, train
from repro_torch.tree import tree_leaves, tree_map

torch.set_num_threads(1)

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HOP_TOL = 1e-6
MEAN_RTOL = 1e-6
LOSS_RTOL = 1e-5
THETA_TOL = 1e-4
NORM_RTOL = 1e-3
ADAM_PARTED = 1e-3
FUSED_TOL = 1e-6
HOP_GEOM = dict(C=4, M=2, K=16, K_ps=8, sigma_z2=0.5)
HOPS = {
    "per_element": dict(),
    "scalar": dict(per_element_interference=False),
    "ideal": dict(mode="ideal"),
    "fused": dict(fused=True),
}
SHAPES = {"b8": InputShape("tiny", 64, 8, "train"),
          "b16": InputShape("tiny", 32, 16, "train")}
# tag -> (fused, batch, (pod, cluster, user, model), TrainConfig fields,
# steps)
RUNS = {
    "struct_equivalent": (False, "b8", (1, 2, 2, 1), dict(
        tau=1, I=1, users_per_cluster=2, eta_local=1.0, outer="adamw",
        outer_lr=2e-3, ota=dict(mode="equivalent")), 2),
    "struct_ideal": (False, "b8", (1, 2, 2, 1), dict(
        tau=1, I=1, users_per_cluster=2, eta_local=1.0, outer="adamw",
        outer_lr=2e-3, ota=dict(mode="ideal")), 2),
    "local_ideal": (False, "b16", (1, 2, 2, 1), dict(
        tau=2, I=2, users_per_cluster=2, eta_local=5e-3, outer="add",
        ota=dict(mode="ideal")), 1),
    "pods_equivalent": (False, "b8", (2, 1, 2, 1), dict(
        tau=1, I=1, users_per_cluster=2, eta_local=1.0, outer="adamw",
        outer_lr=2e-3, ota=dict(mode="equivalent")), 1),
    "fused_proxy": (True, "b8", (1, 2, 2, 1), dict(
        tau=1, I=1, users_per_cluster=2, eta_local=0.05, outer="add",
        grad_accum=2, ota=dict(tx_power_proxy=1e-4)), 2),
}
JAX_RUNS = ("struct_equivalent", "struct_ideal", "pods_equivalent",
            "local_ideal")

_JAX_SCRIPT = """
import sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import AxisType
from repro.configs import get_config
from repro.configs.base import InputShape
from repro.core import dist
from repro.launch import train

RUNS, TAGS = {runs!r}, {tags!r}
inp = dict(np.load(sys.argv[1]))
res = {{}}
cfg = get_config("qwen2-0.5b").reduced().with_(compute_dtype="float32")
for tag in TAGS:
    _, b, (pod, cluster, user, model), fields, steps = RUNS[tag]
    shape, names = ((cluster * user, model), ("data", "model"))
    if pod > 1:
        shape, names = (pod,) + shape, ("pod",) + names
    mesh = jax.make_mesh(shape, names, axis_types=(AxisType.Auto,) * len(shape))
    fields = dict(fields, ota=dist.OTADistConfig(**fields["ota"]))
    B, L = inp[b + "/tokens"].shape
    step, init_fn, shardings_fn, _ = train.build_train_step(
        cfg, InputShape("tiny", L, B, "train"), mesh,
        train.TrainConfig(**fields))
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
    batch = {{k: jnp.asarray(inp[b + "/" + k]) for k in ("tokens", "labels")}}
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


def _tcfg(fields):
    return train.TrainConfig(**dict(fields, ota=dist.OTADistConfig(
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


def _one_card(tag, theta0, batches):
    """The run `tag` on one device: (final state, metrics a step)."""
    fused, b, mesh, fields, steps = RUNS[tag]
    build = train.build_fused_train_step if fused else \
        train.build_train_step
    pod, cluster, user, _ = mesh
    sizes = ({"data": cluster * user} if pod == 1 else
             {"pod": pod, "data": cluster * user})
    step, init_fn = build(_cfg(), SHAPES[b], sizes, _tcfg(fields),
                          device="cpu")
    state, _ = init_fn(prng.PRNGKey(0))
    state["params"] = tree_map(torch.clone, theta0)
    ms = []
    for i in range(steps):
        state, m = step(state, batches[b], prng.PRNGKey(10 + i))
        ms.append(m)
    return state, ms


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """The initial parameters and batches, and the JAX package's runs of
    JAX_RUNS from them: one subprocess a run, started here so that they
    compile while the hops' ranks run (each ~25 s, mostly XLA)."""
    from repro_torch.models import lm

    theta0 = lm.init_params(prng.PRNGKey(0), _cfg())
    batches = _batches()
    tmp = tmp_path_factory.mktemp("ranks")
    inp = {f"theta0/{'/'.join(p)}": t.numpy() for p, t in
           tree_leaves(theta0)}
    for b, batch in batches.items():
        inp.update({f"{b}/{k}": v.numpy() for k, v in batch.items()})
    np.savez(tmp / "inp.npz", **inp)
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.path.join(_REPO, "src")
    procs = {tag: subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(_JAX_SCRIPT.format(
            runs=RUNS, tags=(tag,))), str(tmp / "inp.npz"),
         str(tmp / f"jax_{tag}.npz")], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for tag in JAX_RUNS}
    yield theta0, batches, tmp, procs
    for proc in procs.values():
        if proc.poll() is None:
            proc.kill()
            proc.communicate()


@pytest.fixture(scope="module")
def runs(inputs):
    """Every run of RUNS on its ranks (one launch of 4 gloo ranks, each
    run on its own mesh) and on one device, side by side, and JAX_RUNS
    in JAX."""
    theta0, batches, tmp, procs = inputs
    cfg = _cfg()
    specs = [dict(cfg=cfg, shape=SHAPES[b], tcfg=_tcfg(fields), fused=fused,
                  mesh=mesh, batches=[batches[b]],
                  keys=[10 + i for i in range(steps)], device="cpu",
                  params0=theta0, return_state=True)
             for fused, b, mesh, fields, steps in RUNS.values()]
    out = {}
    thread = threading.Thread(target=lambda: out.update(
        ranks=ranks.launch(ranks.train_worker, 4, "gloo", specs)))
    thread.start()
    one = {tag: _one_card(tag, theta0, batches) for tag in RUNS}
    thread.join()
    ref = {}
    for tag, proc in procs.items():
        stdout, stderr = proc.communicate(timeout=900)
        assert proc.returncode == 0, stdout + "\n" + stderr
        ref.update(np.load(tmp / f"jax_{tag}.npz"))
    assert "ranks" in out, "the ranks' launch failed"
    per_run = {tag: [r[i] for r in out["ranks"]]
               for i, tag in enumerate(RUNS)}
    return {"ranks": per_run, "one": one, "theta0": theta0, "jax": ref}


def _hop_worker(rank, world, tree):
    """On (2, 2, 2, 1): each hop of HOPS on this user's row of `tree`,
    its output and its collectives; then the refusals."""
    from repro_torch.launch.mesh import make_mesh, refine_mesh
    from repro_torch.sharding import P, record_collectives, shard_map

    torch.set_num_threads(1)
    rmesh = refine_mesh(make_mesh((2, 2, 2, 1), device_type="cpu"),
                        users_per_cluster=2)
    geom = dist.uniform_geom(**HOP_GEOM)
    U = ("pod", "cluster", "user")
    out = {"hops": {}}
    for name, kw in HOPS.items():
        cfg = dist.OTADistConfig(**kw)

        def f(x, key):
            t = tree_map(lambda v: v[0], x)
            res = {}
            for hop, run in (
                    ("cluster", lambda: dist.cluster_hop(t, geom, key, 1.0,
                                                         cfg)),
                    ("global", lambda: dist.global_hop(t, geom, key, 20.0,
                                                       cfg)),
                    ("whfl", lambda: dist.whfl_aggregate(t, geom, key, 1.0,
                                                         20.0, cfg))):
                with record_collectives() as log:
                    res[hop] = (run(), [(r["axes"], r["group_size"])
                                        for r in log])
            return res
        out["hops"][name] = shard_map(f, rmesh, in_specs=(P(U), P()),
                                      out_specs=P())(tree, prng.PRNGKey(5))
    # what runs: the "q_seq" route (6 heads over a model axis of 4) on
    # (1, 1, 2, 4), its init and a step on 4 rows a user; what stays
    # refused: a MoE under a model axis of 2 on (1, 2, 2, 2)
    out["refusals"] = {}
    g = torch.Generator().manual_seed(rank)
    for label, cfg, sizes in (
            ("q_seq", _cfg().with_(n_heads=6, seq_shard_attn=True),
             (1, 1, 2, 4)),
            ("moe", get_config("qwen3-moe-235b-a22b").reduced(),
             (1, 2, 2, 2))):
        mesh = make_mesh(sizes, device_type="cpu")
        step, init_fn, shardings, rmesh2 = train.build_train_step(
            cfg, SHAPES["b8"], mesh, train.TrainConfig(
                users_per_cluster=2, outer="adamw"), device="cpu")
        rows = {k: torch.randint(0, cfg.vocab, (4, 64), generator=g,
                                 dtype=torch.int32)
                for k in ("tokens", "labels")}
        errors, metrics = [], None
        for call in (lambda: init_fn(prng.PRNGKey(0)),
                     lambda: step(init_fn(prng.PRNGKey(0))[0], rows,
                                  prng.PRNGKey(0))):
            try:
                res = call()
                errors.append(None)
            except NotImplementedError as e:
                errors.append(str(e))
        if errors[-1] is None:
            metrics = {k: float(v) for k, v in res[1].items()}
        from repro_torch.models import lm
        specs = shardings(lm.param_axes(cfg))["state"]["params"]
        out["refusals"][label] = (errors, specs["lm_head"]["w"],
                                  dict(zip(rmesh2.mesh_dim_names,
                                           rmesh2.shape)),
                                  specs["layers"]["attn"]["wq"]["w"],
                                  metrics)
    return out


@pytest.fixture(scope="module")
def hops(inputs):
    rng = np.random.default_rng(3)
    tree = {"b": {"c": torch.tensor(0.1 * rng.standard_normal(
        (8, 7)).astype(np.float32))},
            "a": torch.tensor(0.1 * rng.standard_normal(
                (8, 6, 5)).astype(np.float32))}
    return tree, ranks.launch(_hop_worker, 8, "gloo", tree)


def _rel(got, want) -> float:
    return float((got - want).abs().max() / max(float(want.abs().max()),
                                                1e-30))


def test_hops_reduce_over_the_user_and_cluster_groups(hops):
    tree, res = hops
    for r in res:
        for name, hop_out in r["hops"].items():
            groups = {hop: {(tuple(a), n) for a, n in log}
                      for hop, (_, log) in hop_out.items()}
            if name == "fused":
                assert groups["whfl"] == {(("pod", "cluster", "user"), 8)}
                continue
            assert groups["cluster"] == {(("user",), 2)}, name
            assert groups["global"] == {(("pod", "cluster"), 4)}, name
            assert groups["whfl"] == groups["cluster"] | groups["global"]


def test_hops_on_ranks_match_the_one_card_form(hops):
    tree, res = hops
    geom = dist.uniform_geom(**HOP_GEOM)
    C, M = HOP_GEOM["C"], HOP_GEOM["M"]
    deltas = tree_map(lambda t: t.reshape((C, M) + t.shape[1:]), tree)
    key = prng.PRNGKey(5)
    for name, kw in HOPS.items():
        cfg = dist.OTADistConfig(**kw)
        est_c = dist.cluster_hop(deltas, geom, key, 1.0, cfg)
        est_g = [dist.global_hop(tree_map(lambda t: t[:, m], deltas), geom,
                                 key, 20.0, cfg) for m in range(M)]
        est = dist.whfl_aggregate(deltas, geom, key, 1.0, 20.0, cfg)
        for u, r in enumerate(res):
            c, m = divmod(u, M)
            got = {hop: dict(tree_leaves(v)) for hop, (v, _) in
                   r["hops"][name].items()}
            for path, _ in tree_leaves(tree):
                pick = lambda tr: dict(tree_leaves(tr))[path]
                if not cfg.fused:
                    assert _same_bits(got["cluster"][path],
                                      pick(est_c)[c]), (name, path, u)
                    assert _rel(got["global"][path],
                                pick(est_g[m])) <= HOP_TOL
                assert _rel(got["whfl"][path], pick(est)) <= HOP_TOL


def test_ideal_aggregation_is_exact_mean(hops):
    tree, res = hops
    for r in res:
        got = dict(tree_leaves(r["hops"]["ideal"]["whfl"][0]))
        for path, t in tree_leaves(tree):
            np.testing.assert_allclose(got[path].numpy(),
                                       t.mean(0).numpy(), rtol=MEAN_RTOL,
                                       atol=0)


def test_fsdp_and_tensor_parallelism_refuse(hops):
    """What tensor parallelism does not execute yet refuses, naming the
    ROADMAP item: a MoE under "model" 2 (fsdp, zero1 and a dense model's
    "model" axis at any width run: tests/test_torch_fsdp.py,
    tests/test_torch_tp.py, tests/test_torch_qseq.py); the "q_seq"
    route, refused before, draws its state and takes a finite step.
    `shardings` returns the specs in full: under "q_seq" the attention
    replicated, the vocabulary split."""
    _, res = hops
    for r in res:
        q_errors, q_head, q_shape, q_wq, q_metrics = r["refusals"]["q_seq"]
        assert q_errors == [None, None]
        assert all(np.isfinite(v) for v in q_metrics.values()), q_metrics
        assert q_head == (None, "model") and q_wq == (None, None, None)
        assert q_shape == {"pod": 1, "cluster": 1, "user": 2, "model": 4}
        m_errors, _, m_shape, _, _ = r["refusals"]["moe"]
        assert all(e is not None and "ROADMAP queue A item 11" in e
                   for e in m_errors), m_errors
        assert "MoE" in m_errors[0]
        assert m_shape == {"pod": 1, "cluster": 2, "user": 2, "model": 2}


@pytest.mark.parametrize("tag", ["struct_equivalent", "struct_ideal",
                                 "local_ideal", "pods_equivalent"])
def test_structural_step_on_ranks_equals_one_card_bitwise(runs, tag):
    state, ms = runs["one"][tag]
    want = dict(tree_leaves(state))
    assert len(runs["ranks"][tag]) == 4
    for r in runs["ranks"][tag]:
        got = dict(tree_leaves(r["state"]))
        assert set(got) == set(want)
        bad = [p for p in want if not _same_bits(got[p], want[p])]
        assert not bad, (tag, r["rank"], bad[:5])
        for i, m in enumerate(ms):
            for k in ("loss", "edge_power"):
                assert _same_bits(r["raw_metrics"][i][k], m[k]), (k, i)
    if tag == "pods_equivalent":
        coords = [tuple(r["coordinate"].values())
                  for r in runs["ranks"][tag]]
        assert coords == [(0, 0, 0), (0, 0, 1), (1, 0, 0), (1, 0, 1)]


def test_world_of_one_runs_in_process_and_equals_one_card(inputs):
    """`ranks.launch` with a world of one runs the worker in this process
    (the card's NCCL case in `chip_smoke.py` phase 11): gloo here, the
    equivalent channel, AdamW, one step, bit for bit the one-card step
    at {"data": 1}, against an in-memory `ranks.reference`; twice, so
    that the second process group finds no stale groups."""
    theta0, batches, _, _ = inputs
    fields = dict(RUNS["struct_equivalent"][3], users_per_cluster=1)
    tcfg = _tcfg(fields)
    batch = {k: v[:1] for k, v in batches["b8"].items()}
    shape = InputShape("tiny", 64, 1, "train")
    step, init_fn = train.build_train_step(_cfg(), shape, {"data": 1}, tcfg,
                                           device="cpu")
    state, _ = init_fn(prng.PRNGKey(0))
    state["params"] = tree_map(torch.clone, theta0)
    state, m = step(state, batch, prng.PRNGKey(10))
    ref = ranks.reference(state, [m])
    spec = dict(cfg=_cfg(), shape=shape, tcfg=tcfg, mesh=(1, 1, 1, 1),
                batches=[batch], keys=[10], device="cpu", params0=theta0,
                reference=ref)
    for _ in range(2):
        (r,) = ranks.launch(ranks.train_worker, 1, "gloo", spec)
        assert r["vs_reference"]["unequal"] == [], r["vs_reference"]
        assert r["vs_reference"]["leaves"] == len(ref)
        assert r["collectives"] == [] and r["backend"] == "gloo"
        assert os.getpid() == r["pid"]


@pytest.mark.parametrize("tag", JAX_RUNS)
def test_structural_step_on_ranks_matches_reference(runs, tag):
    ref = runs["jax"]
    r = runs["ranks"][tag][0]
    for i, m in enumerate(r["metrics"]):
        for k in ("loss", "edge_power"):
            want = float(ref[f"{tag}/{k}/{i}"])
            assert abs(m[k] - want) <= LOSS_RTOL * abs(want), (k, i)
    got = dict(tree_leaves(r["state"]["params"]))
    want = {tuple(k.split("/")[2:]): torch.tensor(v) for k, v in ref.items()
            if k.startswith(f"{tag}/params/")}
    assert set(got) == set(want)
    p0 = dict(tree_leaves(runs["theta0"]))
    theta_max = max(float(w.abs().max()) for w in want.values())
    gaps = np.concatenate([(got[p] - w).abs().flatten().numpy()
                           for p, w in want.items()])
    upd = lambda tr: torch.sqrt(sum(torch.sum((tr[p] - p0[p]) ** 2)
                                    for p in want))
    assert abs(float(upd(got)) - float(upd(want))) <= NORM_RTOL * float(
        upd(want))
    assert (gaps > THETA_TOL * theta_max).mean() <= ADAM_PARTED


def test_fused_step_on_ranks_matches_one_card(runs):
    state, ms = runs["one"]["fused_proxy"]
    want = dict(tree_leaves(state["params"]))
    theta_max = max(float(w.abs().max()) for w in want.values())
    for r in runs["ranks"]["fused_proxy"]:
        got = dict(tree_leaves(r["state"]["params"]))
        gap = max(float((got[p] - w).abs().max()) for p, w in want.items())
        assert gap <= FUSED_TOL * theta_max, (r["rank"], gap / theta_max)
        for i, m in enumerate(ms):
            for k in ("loss", "edge_power"):
                assert abs(r["metrics"][i][k] - float(m[k])) <= (
                    FUSED_TOL * abs(float(m[k]))), (k, i)
        assert {c["axes"] for c in r["collectives"]
                if c["op"] == "all_reduce"} == {"pod/cluster/user"}
