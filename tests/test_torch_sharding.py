"""The port's sharding rules and placements (`repro_torch.sharding`,
`launch.mesh`, `launch.train`'s and `launch.serve`'s specs, the
parameters' logical axes) against the JAX package's, with no process
group in this test's process.

Every comparison here is exact: the tables, specs and axes are names,
so the port's must equal the reference's entry for entry.

- `make_rules`: the reference reads only ``mesh.axis_names`` and
  ``mesh.devices.shape``, so a namespace with a numpy array of that
  shape stands for a JAX mesh; the port takes the shape mapping.  Every
  architecture in ``ASSIGNED``, cfg or none, on 16x16, 2x16x16 and
  their refinements at M 4, `fsdp` and `inside_shardmap` on and off.
- The logical axes, `param_sharding_tree`, the train steps' and the
  serving steps' `shardings` and `cache_shardings`: the reference builds
  `NamedSharding`s, which need a JAX mesh of 256 or 512 devices, so one
  module-scoped subprocess runs it on 512 forced host devices (as
  ``tests/test_dist.py`` does) and writes every spec to JSON; the port
  builds its specs from shape mappings.  The axes come from the
  reference's `abstract_state` (`jax.eval_shape`) and the port's (the
  "meta" device), neither allocating.  With ``zero1`` and AdamW the
  reference's `shardings` raises a `TypeError` (it calls `outer_rules`
  without `cfg`, ROADMAP queue C), so the port's moments are held to
  the reference's `make_rules(rmesh, fsdp=True, cfg=cfg)` specs.
- `make_production_mesh` and `refine_mesh` on `DeviceMesh`es of 256 and
  512 ranks: a subprocess with torch's fake process group (one process
  standing for the world); the refined mesh keeps the production mesh's
  rank order.
"""
import json
import os
import subprocess
import sys
import textwrap
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch.configs import INPUT_SHAPES, get_config
from repro_torch.configs.archs import ASSIGNED
from repro_torch.launch import serve, train
from repro_torch.launch.mesh import mesh_counts, refine_mesh
from repro_torch.models import lm
from repro_torch.nn.core import Px, split_params
from repro_torch.sharding import (P, logical, make_rules,
                                  param_sharding_tree, placements,
                                  set_rules)
from repro_torch.sharding.api import map_axes_tree

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESHES = {"16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16}}
REFINED = {f"{k} M4": refine_mesh(v, users_per_cluster=4)
           for k, v in MESHES.items()}
# tag -> (build, TrainConfig fields)
TRAIN_VARIANTS = {
    "struct_adamw": ("build_train_step", dict(outer="adamw")),
    "struct_adamw_fsdp": ("build_train_step", dict(outer="adamw",
                                                   fsdp=True)),
    "struct_add": ("build_train_step", dict()),
    "fused_adamw_fsdp": ("build_fused_train_step", dict(outer="adamw",
                                                        fsdp=True)),
    "fused_add": ("build_fused_train_step", dict()),
}
SERVE_SHAPES = ("prefill_32k", "decode_32k", "long_500k")

_SCRIPT = """
import json, sys
import jax
from jax.sharding import NamedSharding
from repro.configs import INPUT_SHAPES, get_config
from repro.configs.archs import ASSIGNED
from repro.launch import serve, train
from repro.launch.mesh import make_production_mesh, refine_mesh
from repro.sharding import make_rules, param_sharding_tree

VARIANTS = {variants!r}
SERVE = {serve_shapes!r}
is_ns = lambda v: isinstance(v, NamedSharding)


def spec(s):
    return [list(e) if isinstance(e, tuple) else e for e in tuple(s.spec)]


def specs(tree):
    return jax.tree.map(spec, tree, is_leaf=is_ns)


def lists(tree):
    return jax.tree.map(list, tree, is_leaf=lambda v: isinstance(v, tuple))


meshes = {{"16x16": make_production_mesh(),
          "2x16x16": make_production_mesh(multi_pod=True)}}
out = {{}}
for arch in ASSIGNED:
    cfg = get_config(arch)
    shapes, axes = train.abstract_state(cfg, train.TrainConfig(
        outer="adamw"))
    rec = out[arch] = {{
        "axes": lists(axes),
        "shapes": {{"/".join(k.key for k in path): [list(v.shape),
                                                   str(v.dtype)]
                    for path, v in jax.tree_util.tree_leaves_with_path(
                        shapes)}},
        "train": {{}}, "serve": {{}}}}
    for mname, mesh in meshes.items():
        for tag, (build, fields) in VARIANTS.items():
            _, _, shardings, _ = getattr(train, build)(
                cfg, INPUT_SHAPES["train_4k"], mesh,
                train.TrainConfig(**fields))
            rec["train"][mname + "/" + tag] = specs(shardings(axes))
        # zero1 + AdamW raises TypeError in the reference's `shardings`:
        # the moments' intended specs
        rmesh = refine_mesh(mesh, users_per_cluster=4)
        rec["train"][mname + "/zero1_moments"] = specs(param_sharding_tree(
            axes, make_rules(rmesh, fsdp=True, cfg=cfg)))
        for sname, m in ((mname, mesh), (mname + " M4", rmesh)):
            for shape_name in SERVE:
                shape = INPUT_SHAPES[shape_name]
                if shape.kind == "prefill":
                    _, _, sh, _ = serve.build_prefill_step(cfg, shape, m)
                else:
                    _, _, sh, _ = serve.build_decode_step(cfg, shape, m)
                rec["serve"][sname + "/" + shape_name] = specs(sh())
json.dump(out, open(sys.argv[1], "w"))
print("OK")
"""

_FAKE_SCRIPT = """
import json, sys
import torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore
from repro_torch.launch.mesh import (make_production_mesh, mesh_counts,
                                     refine_mesh)
from repro_torch.sharding import make_rules, mesh_axes

out = {}
for world, multi in ((256, False), (512, True)):
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    mesh = make_production_mesh(multi_pod=multi, device_type="cpu")
    r = refine_mesh(mesh, users_per_cluster=4)
    try:
        refine_mesh(mesh, users_per_cluster=3)
        err = None
    except ValueError as e:
        err = str(e)
    out[world] = {
        "names": list(mesh.mesh_dim_names), "shape": list(mesh.shape),
        "ranks": mesh.mesh.flatten().tolist(),
        "r_names": list(r.mesh_dim_names), "r_shape": list(r.shape),
        "r_ranks": r.mesh.flatten().tolist(),
        "counts": list(mesh_counts(mesh)), "r_counts": list(mesh_counts(r)),
        "axes": mesh_axes(r),
        "table_same": make_rules(r).table == make_rules(mesh_axes(r)).table,
        "error": err}
    dist.destroy_process_group()
json.dump(out, open(sys.argv[1], "w"))
print("OK")
"""


def _subprocess(script, out, env_extra):
    env = dict(os.environ)
    env.update(env_extra)
    env["PYTHONPATH"] = os.path.join(_REPO, "src")
    proc = subprocess.run([sys.executable, "-c", textwrap.dedent(script),
                           str(out)], env=env, capture_output=True,
                          text=True, timeout=900)
    assert proc.returncode == 0, proc.stdout + "\n" + proc.stderr
    with open(out) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    out = tmp_path_factory.mktemp("sharding_ref") / "ref.json"
    return _subprocess(
        _SCRIPT.format(variants=TRAIN_VARIANTS, serve_shapes=SERVE_SHAPES),
        out, {"XLA_FLAGS": "--xla_force_host_platform_device_count=512",
              "JAX_PLATFORMS": "cpu"})


@pytest.fixture(scope="module")
def fake_meshes(tmp_path_factory):
    out = tmp_path_factory.mktemp("fake_pg") / "meshes.json"
    return _subprocess(_FAKE_SCRIPT, out, {})


def _json(tree):
    """A port spec or axes tree as the reference script writes it."""
    if isinstance(tree, dict):
        return {k: _json(v) for k, v in tree.items()}
    if isinstance(tree, P) or (isinstance(tree, tuple) and all(
            e is None or isinstance(e, str) for e in tree) and tree):
        return [list(e) if isinstance(e, tuple) else e for e in tree]
    if isinstance(tree, (list, tuple)):
        return [_json(v) for v in tree]
    return tree


def _jax_mesh(sizes):
    return SimpleNamespace(axis_names=tuple(sizes),
                           devices=np.zeros(tuple(sizes.values())))


@pytest.mark.parametrize("arch", ASSIGNED)
def test_make_rules_table_matches_reference(arch):
    from repro.configs import get_config as jget
    from repro.sharding import make_rules as jmake_rules

    for sizes in list(MESHES.values()) + list(REFINED.values()):
        for cfg, jcfg in ((None, None), (get_config(arch), jget(arch))):
            for fsdp in (True, False):
                for inside in (True, False):
                    want = jmake_rules(_jax_mesh(sizes), fsdp=fsdp, cfg=jcfg,
                                       inside_shardmap=inside)
                    got = make_rules(sizes, fsdp=fsdp, cfg=cfg,
                                     inside_shardmap=inside)
                    assert got.table == dict(want.table), (sizes, fsdp,
                                                           inside)
                    assert got.bare == want.bare


@pytest.mark.parametrize("arch", ASSIGNED)
def test_param_axes_and_abstract_state_match_reference(ref, arch):
    cfg = get_config(arch)
    axes = lm.param_axes(cfg)
    assert _json(axes) == ref[arch]["axes"]
    state, axes2 = train.abstract_state(cfg, train.TrainConfig(
        outer="adamw"))
    assert axes2 == axes
    got = {}

    def walk(tree, path):
        if isinstance(tree, dict):
            for k, v in tree.items():
                walk(v, path + [k])
        else:
            assert tree.device.type == "meta"
            got["/".join(path)] = [list(tree.shape),
                                   str(tree.dtype).replace("torch.", "")]
    walk(state, [])
    assert got == ref[arch]["shapes"]


@pytest.mark.parametrize("arch", ASSIGNED)
def test_train_shardings_match_reference(ref, arch):
    cfg = get_config(arch)
    axes = lm.param_axes(cfg)
    shape = INPUT_SHAPES["train_4k"]
    for mname, sizes in MESHES.items():
        for tag, (build, fields) in TRAIN_VARIANTS.items():
            got = train.make_shardings(
                cfg, shape, sizes, train.TrainConfig(**fields),
                fused=build == "build_fused_train_step")(axes)
            assert _json(got) == ref[arch]["train"][f"{mname}/{tag}"], tag
        want = ref[arch]["train"][f"{mname}/zero1_moments"]
        z = train.make_shardings(cfg, shape, sizes, train.TrainConfig(
            outer="adamw", zero1=True))(axes)
        assert _json(z["state"]["opt"]["m"]) == want
        assert _json(z["state"]["opt"]["v"]) == want
        rmesh = refine_mesh(sizes, users_per_cluster=4)
        assert _json(param_sharding_tree(axes, make_rules(
            rmesh, fsdp=True, cfg=cfg))) == want
        assert train.outer_rules(rmesh, cfg, fsdp=True).table == make_rules(
            rmesh, fsdp=True, cfg=cfg).table


@pytest.mark.parametrize("arch", ASSIGNED)
def test_serve_shardings_match_reference(ref, arch):
    cfg = get_config(arch)
    for mname, sizes in list(MESHES.items()) + list(REFINED.items()):
        for shape_name in SERVE_SHAPES:
            shape = INPUT_SHAPES[shape_name]
            if shape.kind == "prefill":
                _, _, sh, rules = serve.build_prefill_step(
                    cfg, shape, device="cpu", mesh=sizes)
            else:
                _, _, sh, rules = serve.build_decode_step(
                    cfg, shape, device="cpu", mesh=sizes)
                assert _json(serve.cache_shardings(cfg, shape, sizes)) == (
                    ref[arch]["serve"][f"{mname}/{shape_name}"][1])
            assert rules.table == make_rules(sizes, fsdp=False,
                                             cfg=cfg).table
            assert _json(sh()) == ref[arch]["serve"][f"{mname}/{shape_name}"]


def test_production_and_refined_device_meshes(fake_meshes):
    for world, pods in (("256", 1), ("512", 2)):
        got = fake_meshes[world]
        assert got["names"] == (["data", "model"] if pods == 1
                                else ["pod", "data", "model"])
        assert got["shape"] == [16, 16] if pods == 1 else [2, 16, 16]
        assert got["ranks"] == list(range(int(world)))
        assert got["r_names"] == ["pod", "cluster", "user", "model"]
        assert got["r_shape"] == [pods, 4, 4, 16]
        # the identical rank order: the refinement is a reshape
        assert got["r_ranks"] == got["ranks"]
        assert got["counts"] == got["r_counts"] == [pods, 4 * pods, 4]
        assert got["axes"] == {"pod": pods, "cluster": 4, "user": 4,
                               "model": 16}
        assert got["table_same"]
        assert got["error"] == "data axis 16 not divisible by M=3"


def test_refine_mesh_shapes_and_counts_match_reference():
    from repro.launch.mesh import mesh_counts as jmesh_counts

    for sizes in MESHES.values():
        for M in (1, 2, 4, 8, 16):
            r = refine_mesh(sizes, users_per_cluster=M)
            assert list(r) == ["pod", "cluster", "user", "model"]
            assert r["cluster"] * r["user"] == sizes["data"]
            assert mesh_counts(r) == mesh_counts(sizes, M) == jmesh_counts(
                _jax_mesh(sizes), M)
        with pytest.raises(ValueError, match="not divisible by M=5"):
            refine_mesh(sizes, users_per_cluster=5)


def test_logical_checks_rank_and_refuses_tensor_parallelism():
    """`logical` checks ranks; under a "model" axis past 1, the local
    size of every dimension the rules put on "model" (a `ValueError`
    naming the logical axis), the sequence-parallel route's rows
    ("q_seq", where the heads do not divide) among them: L / model of
    the length `sizes` gives, which must divide."""
    from repro_torch.configs import get_config

    x = torch.zeros(2, 3)
    assert logical(x, "batch", "embed") is x          # no rules: no-op
    with set_rules(make_rules({"data": 4, "model": 1})):
        assert logical(x, "batch", "embed") is x
        with pytest.raises(ValueError, match="rank mismatch"):
            logical(x, "batch")
    cfg = get_config("qwen2-0.5b")                    # 14 heads over 2 KV
    with set_rules(make_rules({"data": 2, "model": 2}, cfg=cfg)):
        assert logical(x, "batch", "embed") is x
        q = torch.zeros(1, 4, 7, 64)
        assert logical(q, "batch", "seq", "heads", "head_dim") is q
        with pytest.raises(ValueError, match="'heads'"):
            logical(torch.zeros(1, 4, 14, 64), "batch", "seq", "heads",
                    "head_dim")
        with pytest.raises(ValueError, match="'vocab'"):
            logical(torch.zeros(1, 4, cfg.vocab), "batch", "seq", "vocab")
        h = torch.zeros(1, 4, cfg.d_ff // 2)
        assert logical(h, "batch", "seq", "ffn") is h
    with set_rules(make_rules({"data": 2, "model": 4}, cfg=cfg)):
        q = torch.zeros(1, 4, 14, 64)
        axes = ("batch", "q_seq", "heads", "head_dim")
        assert logical(q, *axes, sizes={"q_seq": 16}) is q
        with pytest.raises(ValueError, match="'q_seq'"):
            logical(q, *axes, sizes={"q_seq": 32})
        with pytest.raises(ValueError, match="does not divide"):
            logical(q, *axes, sizes={"q_seq": 18})
        with pytest.raises(ValueError, match="sequence's length"):
            logical(q, *axes)
        assert logical(q, "batch", "seq", "heads", "head_dim") is q


def test_split_params_and_placements():
    tree = {"a": Px(torch.zeros(2, 3), ("p_embed", "p_ffn")),
            "b": [Px(torch.ones(4), ("embed",))]}
    params, axes = split_params(tree)
    assert params["a"].shape == (2, 3) and params["b"][0].shape == (4,)
    assert axes == {"a": ("p_embed", "p_ffn"), "b": [("embed",)]}
    specs = param_sharding_tree(axes, make_rules(
        {"pod": 1, "cluster": 2, "user": 2, "model": 1}, fsdp=True))
    assert specs == {"a": (("pod", "cluster", "user"), "model"),
                     "b": [(None,)]}
    assert map_axes_tree(len, axes) == {"a": 2, "b": [1]}
    from torch.distributed.tensor import Replicate, Shard

    mesh = SimpleNamespace(mesh_dim_names=("pod", "cluster", "user",
                                           "model"))
    assert placements(specs["a"], mesh) == [Shard(0), Shard(0), Shard(0),
                                            Shard(1)]
    assert placements((None, None), mesh) == [Replicate()] * 4


def test_shard_map_refuses_outputs_split_over_manual_axes():
    from repro_torch.sharding import shard_map

    mesh = SimpleNamespace(mesh_dim_names=("pod", "cluster", "user",
                                           "model"))
    with pytest.raises(NotImplementedError, match="manual axes"):
        shard_map(lambda x: x, mesh, P(), P("user"))
    with pytest.raises(NotImplementedError, match="manual axes"):
        shard_map(lambda x: x, mesh, P(), (P(), P(("pod", "cluster"))))
    # "model" is not manual here, and P() is replicated
    shard_map(lambda x: x, mesh, P(), (P(), P(None, "model")),
              axis_names=("pod", "cluster", "user"))
