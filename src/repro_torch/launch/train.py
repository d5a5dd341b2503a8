"""Federated LM training steps with W-HFL's hierarchical OTA aggregation
(the port of `repro.launch.train`).

`train_step(state, batch, key) -> (state, {"loss", "edge_power"})`
with ``state = {"params", "opt", "step"}``, as in the JAX package:

- Every (pod, cluster, user) coordinate of the mesh is one W-HFL mobile
  user; user u's data are the global batch's rows ``[u * b_user,
  (u + 1) * b_user)`` in (pod, cluster, user) order.
- `build_train_step` (structural): per round, `tau` local SGD steps per
  user on ``I * tau`` microbatches of its rows, the OTA cluster hop of
  the users' deltas, repeated for `I` cluster iterations, then the OTA
  global hop (`core.dist`); ``tau = I = 1`` is one gradient per user
  through `whfl_aggregate`.
- `build_fused_train_step`: ``tau = I = 1``, both hops folded into
  per-example loss weights (the users' OTA gains) plus one noise draw,
  with `grad_accum` microbatches.
- The aggregated delta is applied directly (``outer="add"``, the
  paper's theta += Delta) or through an outer AdamW.

`build_train_step` and `build_fused_train_step` take one of two
meshes:

- a `DeviceMesh` (production, `launch.mesh.make_production_mesh`, or
  refined, `refine_mesh`): one process per mesh coordinate, as the JAX
  package's `shard_map`; the step is returned with the reference's four
  values ``(train_step, init_fn, shardings, mesh)``.  Each rank's
  `train_step` takes only its own user's rows (``batch_shardings``:
  the batch over the data axes; `sharding.api.local_shard` cuts them
  from a global batch) and runs inside `sharding.shard_map`, so the
  hops' sums are collectives over its `user` and `(pod, cluster)`
  groups and the fused step's gradient one flat all-reduce over
  `(pod, cluster, user)`.  The losses and `edge_power` are means over
  all ranks.  A rank holds its shards of the state, as `shardings`
  places it (`state_specs`; `init_fn` draws only them): with ``fsdp``
  the weights' "p_embed" dims split over the data axes, with ``zero1``
  (AdamW, the structural step) the moments' too, and under a "model"
  axis past 1 the heads, FFN and vocabulary over "model" where they
  divide (tensor parallelism, the dense family at any width: `nn`,
  `models.lm`; the attention by the heads' placement, `nn.attention`:
  split heads, their KV heads taken from the replicated ones, the
  "q_seq" rows with ``seq_shard_attn``, or the whole attention
  replicated).  The structural
  step gathers FSDP's shards at entry, as the reference's `shard_map`
  with ``in_specs=P()``, and runs the outer update on each leaf's
  moments' slice, then gathers the new parameters back over the data
  axes where they are not split; the fused step gathers a layer's
  shards inside its body and takes their gradient from the gather's
  backward (`sharding.psum_scatter`).  Every update is elementwise, so
  a split update equals the replicated one bit for bit; the hops draw
  and reduce over the shards (`core.dist`; a replicated leaf's draws
  are the same on every "model" rank).  Still refused under a "model"
  axis past 1, with `NotImplementedError` naming ROADMAP queue A item
  11: every family but the dense one (the MoE's experts, SSM heads,
  the hybrid, encdec and vlm stacks).  A rank's device is ``cuda:{rank %
  device_count}`` unless ``device="cpu"``.  The backend (``"nccl"``
  across cards, ``"gloo"`` for CPU ranks or ranks sharing one card) is
  the caller's (`launch.ranks`).
- a mapping of axis names to sizes, e.g. ``{"data": 4, "model": 2}``
  (`launch.mesh.mesh_counts` reads it): every user in turn on one
  device, each leaf of the users' deltas stacked [C, M, ...].  The
  step comes as ``(train_step, init_fn)``; ``fsdp``, ``zero1`` and
  "model" place nothing on one device.  With at most two members per
  group, and "model" of 1, the two meshes give the same bits.

`init_fn(key)` returns ``(state, axes)``, the parameters' logical axes
beside the state, as the reference's does; `abstract_state` gives both
on the "meta" device, nothing allocated.  `TrainConfig.seed` is the
reference's field, which its steps do not read either.  The one-card
steps run on the CUDA card unless ``device="cpu"`` is passed;
`convert.state_from_jax` carries a JAX train state across.
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Optional

import numpy as np
import torch

from repro_torch import prng
from repro_torch.configs.base import ArchConfig, InputShape
from repro_torch.core.dist import (DistGeom, OTADistConfig, cluster_hop,
                                   draw_normal, global_hop, spec_list,
                                   tree_size, tree_sqsum, uniform_geom,
                                   user_id, whfl_aggregate)
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import mesh_counts, refine_mesh
from repro_torch.models import lm
from repro_torch.nn.core import split_params
from repro_torch.optim import adamw, sgd
from repro_torch.sharding import api as sh
from repro_torch.sharding import (P, Rules, make_rules, param_sharding_tree,
                                  set_rules, shard_map)
from repro_torch.tree import tree_from_paths, tree_leaves, tree_map

_DATA = ("pod", "cluster", "user")
ITEM_11 = "ROADMAP queue A item 11"


@dataclass(frozen=True)
class TrainConfig:
    tau: int = 1                   # local user iterations per cluster round
    I: int = 1                     # cluster iterations per global round
    users_per_cluster: int = 4
    eta_local: float = 1e-2        # local SGD step size
    outer: str = "add"             # "add" (paper) | "adamw" (server opt)
    outer_lr: float = 3e-4
    P_t: float = 1.0
    P_is_t: float = 20.0
    ota: OTADistConfig = field(default_factory=OTADistConfig)
    fsdp: bool = False             # shard params over data axes (fused only)
    moment_dtype: str = "float32"  # "bfloat16" halves optimizer memory
    grad_accum: int = 1            # microbatches per step (fused path)
    zero1: bool = False            # shard outer-opt moments over data axes
    geom: Optional[DistGeom] = None
    seed: int = 0


def _inner_rules(mesh, cfg: ArchConfig) -> Rules:
    """Logical-axis rules inside the runner (manual pod/cluster/user;
    only 'model' remains)."""
    return make_rules(mesh, cfg=cfg, inside_shardmap=True)


def outer_rules(mesh, cfg: ArchConfig, *, fsdp: bool) -> Rules:
    """Rules for the placement of params and optimizer state."""
    return make_rules(mesh, fsdp=fsdp, cfg=cfg)


def make_batch(cfg: ArchConfig, shape: InputShape):
    """One global training batch's tensors on the "meta" device (shapes
    and dtypes only)."""
    B, L = shape.global_batch, shape.seq_len
    meta = dict(device="meta")
    batch = {"tokens": torch.empty((B, L), dtype=torch.int32, **meta),
             "labels": torch.empty((B, L), dtype=torch.int32, **meta)}
    if cfg.family == "vlm":
        batch["patch_embeds"] = torch.empty((B, cfg.n_patches, cfg.d_model),
                                            dtype=cfg.cdt(), **meta)
    if cfg.family == "encdec":
        batch["src_frames"] = torch.empty(
            (B, cfg.enc_src_frames, cfg.d_model), dtype=cfg.cdt(), **meta)
    return batch


def batch_shardings(cfg: ArchConfig, shape: InputShape, mesh):
    """The batch's specs: every leaf's rows over the data axes."""
    data_axes = tuple(a for a in _DATA + ("data",) if a in sh.mesh_axes(
        mesh))
    spec = {"tokens": P(data_axes), "labels": P(data_axes)}
    if cfg.family == "vlm":
        spec["patch_embeds"] = P(data_axes)
    if cfg.family == "encdec":
        spec["src_frames"] = P(data_axes)
    return spec


def _state_shardings(axes_tree, tcfg: TrainConfig, p_rules: Rules,
                     z_rules: Rules, batch_sh):
    p_sh = param_sharding_tree(axes_tree, p_rules)
    # optimizer state mirrors the params (adamw: {m, v}); zero1 shards
    # the moments over the data axes too
    if tcfg.outer == "adamw":
        z_sh = param_sharding_tree(axes_tree, z_rules) if tcfg.zero1 else p_sh
        o_sh = {"m": z_sh, "v": z_sh}
    else:
        o_sh = ()
    rep = P()
    return {"state": {"params": p_sh, "opt": o_sh, "step": rep},
            "batch": batch_sh, "key": rep,
            "metrics": {"loss": rep, "edge_power": rep}}


def make_shardings(cfg: ArchConfig, shape: InputShape, mesh,
                   tcfg: TrainConfig, *, fused: bool = False):
    """The steps' `shardings(axes_tree)` -> {"state", "batch", "key",
    "metrics"} specs over `mesh` (a `DeviceMesh` or a shape mapping):
    the structural step's over the refined mesh (params by
    `outer_rules`; with ``zero1`` and AdamW the moments by
    ``make_rules(rmesh, fsdp=True, cfg=cfg)``), the fused step's over
    `mesh` itself (the moments mirroring the params)."""
    if fused:
        rules = make_rules(mesh, fsdp=tcfg.fsdp, cfg=cfg)
        return lambda axes_tree: _state_shardings(
            axes_tree, replace(tcfg, zero1=False), rules, rules,
            batch_shardings(cfg, shape, mesh))
    rmesh = (mesh if "cluster" in sh.mesh_axes(mesh)
             else refine_mesh(mesh, users_per_cluster=tcfg.users_per_cluster))
    p_rules = outer_rules(rmesh, cfg, fsdp=tcfg.fsdp)
    z_rules = make_rules(rmesh, fsdp=True, cfg=cfg)
    return lambda axes_tree: _state_shardings(
        axes_tree, tcfg, p_rules, z_rules,
        batch_shardings(cfg, shape, rmesh))


def abstract_state(cfg: ArchConfig, tcfg: TrainConfig):
    """(state tree of "meta"-device tensors, logical-axes tree): the
    shapes and dtypes of `init_fn`'s state, nothing allocated."""
    params, axes = split_params(lm.init_px(prng.PRNGKey(0, "meta"), cfg))
    opt = (adamw(tcfg.outer_lr, moment_dtype=getattr(
        torch, tcfg.moment_dtype)).init(params)
           if tcfg.outer == "adamw" else ())
    return {"params": params, "opt": opt,
            "step": torch.zeros((), dtype=torch.int32, device="meta")}, axes


def _symbol_power(delta_tree, P_t, specs=None) -> torch.Tensor:
    """Paper §V per-complex-symbol transmit power: P^2 * ||flat||^2 / N
    with N = n_real_params / 2, i.e. 2 P^2 mean(x^2); of the whole tree
    whose shards `delta_tree` holds under `specs` (inside the runner)."""
    leaves = list(tree_leaves(delta_tree))
    return 2.0 * (P_t ** 2) * tree_sqsum(leaves, specs) / float(
        max(tree_size(leaves, specs), 1))


def _tree_add(a, b):
    return tree_map(lambda x, y: (x.float() + y.float()).to(x.dtype), a, b)


def _rows(batch, start: int, n: int):
    return {k: v[start:start + n] for k, v in batch.items()}


def _grad(cfg: ArchConfig, params, mb, **kw):
    """(grads, metrics) of `lm.lm_loss` at `params` (a tree of the same
    structure, no graph kept)."""
    leaves = [(p, t.detach().requires_grad_()) for p, t in
              tree_leaves(params)]
    loss, metrics = lm.lm_loss(tree_from_paths(leaves), mb, cfg, **kw)
    grads = torch.autograd.grad(loss, [t for _, t in leaves])
    return tree_from_paths(zip([p for p, _ in leaves], grads)), metrics


def _outer(tcfg: TrainConfig):
    return (adamw(tcfg.outer_lr, weight_decay=0.1,
                  moment_dtype=getattr(torch, tcfg.moment_dtype))
            if tcfg.outer == "adamw" else sgd(1.0))


def _apply(tcfg: TrainConfig, outer_opt, params, opt_state, est, step):
    """The outer update: theta += Delta_hat (paper) or server AdamW on
    the pseudo-gradient -Delta_hat."""
    if tcfg.outer == "add":
        return _tree_add(params, est), opt_state
    upd, new_opt = outer_opt.update(tree_map(lambda x: -x, est), opt_state,
                                    params, step)
    return _tree_add(params, upd), new_opt


def _stacked_zeros(params, lead):
    return tree_map(lambda p: torch.zeros(lead + tuple(p.shape),
                                          dtype=torch.float32,
                                          device=p.device), params)


# `prng.fold_in` data of the keys of the structural step's hops: the
# degenerate round's whole aggregation, the global hop (a cluster hop
# of local round i folds in i)
_WHFL_KEY, _GLOBAL_KEY = 17, 10_007


def _sgd_delta(cfg: ArchConfig, eta: float, params, rows):
    """One user's delta of the degenerate round, -eta * grad, and its
    ce."""
    g, metrics = _grad(cfg, params, rows)
    return tree_map(lambda x: -eta * x.float(), g), metrics["ce"]


def _user_delta(cfg: ArchConfig, tcfg: TrainConfig, params, cdelta, rows,
                loss_acc):
    """One user's local SGD in a local round: tau steps from theta +
    `cdelta` (its cluster's delta so far) on the micro-batches
    ``rows(j)``.  (the user's delta from theta + cdelta, `loss_acc`
    plus each step's ce, added in step order)."""
    ud = _stacked_zeros(params, ())
    for j in range(tcfg.tau):
        p_eff = tree_map(lambda p, cd, x: (p.float() + cd + x).to(p.dtype),
                         params, cdelta, ud)
        g, metrics = _grad(cfg, p_eff, rows(j))
        del p_eff
        ud = tree_map(lambda x, gg: x - tcfg.eta_local * gg.float(), ud, g)
        del g
        loss_acc = loss_acc + metrics["ce"]
    return ud, loss_acc


def _init(cfg: ArchConfig, outer_opt, dev: torch.device):
    def init_fn(key: torch.Tensor):
        """(train state, logical axes) from a `prng.PRNGKey` (moved to
        the step's device): the JAX package's `init_fn(key)` values."""
        params, axes = split_params(lm.init_px(key.to(dev), cfg))
        return {"params": params, "opt": outer_opt.init(params),
                "step": torch.zeros((), dtype=torch.int32,
                                    device=dev)}, axes
    return init_fn


def _geometry(cfg, shape: InputShape, mesh, tcfg: TrainConfig,
              structural: bool):
    """(n_clusters, M, geom, b_user) of a step over `mesh`, with the
    reference's checks."""
    M = tcfg.users_per_cluster
    _, n_clusters, M = mesh_counts(mesh, M)
    geom = tcfg.geom or uniform_geom(C=n_clusters, M=M)
    n_users = n_clusters * M
    B = shape.global_batch
    if structural and B % n_users:
        raise ValueError(f"global batch {B} not divisible by {n_users} users")
    b_user = B // n_users
    if structural and b_user % (tcfg.I * tcfg.tau):
        raise ValueError(f"per-user batch {b_user} not divisible by "
                         f"I*tau={tcfg.I * tcfg.tau}")
    return n_clusters, M, geom, b_user


_FAMILY_TODO = {"moe": "the MoE's experts and tokens over 'model'",
                "ssm": "SSM heads over 'model'",
                "hybrid": "the hybrid family under a 'model' axis past 1",
                "encdec": "the encdec family under a 'model' axis past 1",
                "vlm": "the vlm family under a 'model' axis past 1"}


def _not_executed(cfg: ArchConfig, mesh) -> Optional[str]:
    """Why the port cannot run this configuration on ranks yet, or None:
    under a "model" axis past 1, every family but the dense one (which
    runs at any width: `nn.attention` by how the heads divide)."""
    n = sh.mesh_axes(mesh).get("model", 1)
    if not sh.is_device_mesh(mesh) or n == 1 or cfg.family not in (
            _FAMILY_TODO):
        return None
    return f"{_FAMILY_TODO[cfg.family]} is {ITEM_11}"


@dataclass(frozen=True)
class _Layout:
    """A ranked step's spec trees (over the refined mesh) of the
    parameters as stored (`params`), as the step's body computes on
    them (`inner`: "model" alone, the structural step; the stored ones,
    the fused step) and of AdamW's moments (`moments`)."""
    params: dict
    inner: dict
    moments: dict


def _layout(cfg: ArchConfig, tcfg: TrainConfig, rmesh, fused: bool
            ) -> _Layout:
    axes = lm.param_axes(cfg)
    p = param_sharding_tree(axes, make_rules(rmesh, fsdp=tcfg.fsdp,
                                             cfg=cfg))
    if fused:
        return _Layout(p, p, p)
    z = (param_sharding_tree(axes, make_rules(rmesh, fsdp=True, cfg=cfg))
         if tcfg.zero1 and tcfg.outer == "adamw" else p)
    return _Layout(p, param_sharding_tree(axes, _inner_rules(rmesh, cfg)), z)


def _reshard(tree, src, dst):
    """Each leaf of `tree` (laid out by spec tree `src`) laid out by
    `dst` over the data axes: cut to this rank's block where `dst`
    splits it and `src` does not, gathered where `src` does and `dst`
    does not, itself where both agree (inside the runner)."""
    def move(x, a, b):
        a_ax, b_ax = sh.split_axes(a, _DATA), sh.split_axes(b, _DATA)
        if a_ax == b_ax:
            return x
        if not a_ax:
            return sh.shard_tree(x, b, _DATA)
        if not b_ax:
            return sh.gather_tree(x, a, _DATA)
        raise ValueError(f"no move from {a} to {b}")
    return tree_from_paths(
        (path, move(x, a, b)) for (path, x), a, b in zip(
            tree_leaves(tree), sh.spec_leaves(src), sh.spec_leaves(dst)))


def _apply_ranked(tcfg: TrainConfig, outer_opt, params, opt_state, est,
                  step, lay: _Layout):
    """`_apply` on this rank's shards: the estimate (laid out as
    `lay.inner`) cut to the stored parameters' blocks; AdamW on the
    moments' blocks (ZeRO-1), its new parameters gathered back to the
    stored layout.  Elementwise throughout: the replicated update's
    bits."""
    est = _reshard(est, lay.inner, lay.params)
    if tcfg.outer == "add":
        return _apply(tcfg, outer_opt, params, opt_state, est, step)
    new, new_opt = _apply(tcfg, outer_opt,
                          _reshard(params, lay.params, lay.moments),
                          opt_state, _reshard(est, lay.params, lay.moments),
                          step)
    return _reshard(new, lay.moments, lay.params), new_opt


def _ranked_init(cfg: ArchConfig, outer_opt, dev, rmesh, tcfg, lay, refuse):
    def init_fn(key: torch.Tensor):
        """(this rank's shards of the train state, logical axes) from a
        `prng.PRNGKey`: each leaf's block of the JAX package's
        `init_fn(key)` values, drawn alone."""
        if refuse:
            raise NotImplementedError(refuse)
        rules = make_rules(rmesh, fsdp=tcfg.fsdp, cfg=cfg)
        with set_rules(rules), sh.axes_bound(rmesh):
            params, axes = split_params(lm.init_px(key.to(dev), cfg))
            opt = outer_opt.init(_reshard(params, lay.params, lay.moments))
        return {"params": params, "opt": opt,
                "step": torch.zeros((), dtype=torch.int32,
                                    device=dev)}, axes
    return init_fn


def state_specs(cfg: ArchConfig, shape: InputShape, rmesh,
                tcfg: TrainConfig, *, fused: bool = False):
    """The spec tree over the refined mesh of the state a ranked step
    keeps on each rank ({"params", "opt", "step"})."""
    return make_shardings(cfg, shape, rmesh, tcfg, fused=fused)(
        lm.param_axes(cfg))["state"]


def _rank_device(device) -> torch.device:
    """A rank's device: ``cuda:{rank % device_count}`` unless `device`
    names another."""
    import torch.distributed as dist

    if resolve_device(device).type != "cuda":
        return torch.device(device)
    return torch.device("cuda", dist.get_rank() % torch.cuda.device_count())


def _check_rows(batch, b_user: int) -> None:
    n = batch["tokens"].shape[0]
    if n != b_user:
        raise ValueError(
            f"a rank takes its own user's {b_user} rows, got {n} (cut them "
            "from the global batch with sharding.api.local_shard and "
            "batch_shardings)")


def build_train_step(cfg: ArchConfig, shape: InputShape, mesh,
                     tcfg: TrainConfig = TrainConfig(), *, device=None):
    """The structural W-HFL step over the mesh's clusters (`mesh_counts`)
    of ``tcfg.users_per_cluster`` users each.  On a `DeviceMesh`: this
    rank's ``(train_step, init_fn, shardings, refined mesh)``; on a shape
    mapping, every user on one device: ``(train_step, init_fn)``."""
    if sh.is_device_mesh(mesh):
        return _ranked_train_step(cfg, shape, mesh, tcfg, device)
    C, M, geom, b_user = _geometry(cfg, shape, mesh, tcfg, True)
    dev = resolve_device(device)
    n_users = C * M
    n_micro = tcfg.I * tcfg.tau
    b_micro = b_user // n_micro
    outer_opt = _outer(tcfg)

    def train_step(state, batch, key):
        params, step = state["params"], state["step"]
        key = key.to(dev)
        if tcfg.tau == 1 and tcfg.I == 1:
            # degenerate round: hierarchical OTA gradient aggregation
            deltas = _stacked_zeros(params, (C, M))
            ces, pws = [], []
            for c in range(C):
                for m in range(M):
                    delta, ce = _sgd_delta(cfg, tcfg.eta_local, params, _rows(
                        batch, (c * M + m) * b_user, b_user))
                    tree_map(lambda d, x: d[c, m].copy_(x), deltas, delta)
                    ces.append(ce)
                    pws.append(_symbol_power(delta, tcfg.P_t))
                    del delta
            est = whfl_aggregate(deltas, geom, prng.fold_in(key, _WHFL_KEY),
                                 tcfg.P_t, tcfg.P_is_t, tcfg.ota)
            del deltas
            loss = torch.stack(ces).mean()
            pw_edge = torch.stack(pws).mean()
        else:
            cdelta = _stacked_zeros(params, (C,))   # cluster delta vs theta
            loss_acc = [torch.zeros((), device=dev) for _ in range(n_users)]
            pw_acc = [torch.zeros((), device=dev) for _ in range(n_users)]
            for i in range(tcfg.I):
                udeltas = _stacked_zeros(params, (C, M))
                for c in range(C):
                    for m in range(M):
                        u = c * M + m
                        ud, loss_acc[u] = _user_delta(
                            cfg, tcfg, params,
                            tree_map(lambda cd: cd[c], cdelta),
                            lambda j: _rows(batch, u * b_user + (
                                i * tcfg.tau + j) * b_micro, b_micro),
                            loss_acc[u])
                        pw_acc[u] = pw_acc[u] + _symbol_power(ud, tcfg.P_t)
                        tree_map(lambda d, x: d[c, m].copy_(x), udeltas, ud)
                        del ud
                est = cluster_hop(udeltas, geom, prng.fold_in(key, i),
                                  tcfg.P_t, tcfg.ota)
                del udeltas
                cdelta = tree_map(lambda a, b: a + b, cdelta, est)
                del est
            est = global_hop(cdelta, geom, prng.fold_in(key, _GLOBAL_KEY),
                             tcfg.P_is_t, tcfg.ota)
            del cdelta
            loss = torch.stack([a / n_micro for a in loss_acc]).mean()
            pw_edge = torch.stack([a / tcfg.I for a in pw_acc]).mean()
        new_params, new_opt = _apply(tcfg, outer_opt, params, state["opt"],
                                     est, step)
        return ({"params": new_params, "opt": new_opt, "step": step + 1},
                {"loss": loss, "edge_power": pw_edge})

    return train_step, _init(cfg, outer_opt, dev)


def _ranked_train_step(cfg: ArchConfig, shape: InputShape, mesh,
                       tcfg: TrainConfig, device):
    """`build_train_step` on a `DeviceMesh`: this rank is one user (and,
    under a "model" axis past 1, one block of its model)."""
    M = tcfg.users_per_cluster
    rmesh = (mesh if "cluster" in sh.mesh_axes(mesh)
             else refine_mesh(mesh, users_per_cluster=M))
    _, _, geom, b_user = _geometry(cfg, shape, rmesh, tcfg, True)
    refuse = _not_executed(cfg, rmesh)
    dev = _rank_device(device)
    n_micro = tcfg.I * tcfg.tau
    b_micro = b_user // n_micro
    outer_opt = _outer(tcfg)
    irules = _inner_rules(rmesh, cfg)
    lay = _layout(cfg, tcfg, rmesh, fused=False)
    specs = lay.inner

    def per_user_step(stored, opt_state, batch, key, step):
        with set_rules(irules):
            # FSDP's shards gathered at entry (the reference's in_specs
            # P() over the manual axes)
            params = _reshard(stored, lay.params, lay.inner)
            if tcfg.tau == 1 and tcfg.I == 1:
                # degenerate round: hierarchical OTA gradient aggregation
                delta, ce = _sgd_delta(cfg, tcfg.eta_local, params, batch)
                est = whfl_aggregate(delta, geom,
                                     prng.fold_in(key, _WHFL_KEY),
                                     tcfg.P_t, tcfg.P_is_t, tcfg.ota,
                                     specs=specs)
                loss = sh.pmean(ce, _DATA)
                pw_edge = sh.pmean(_symbol_power(delta, tcfg.P_t, specs),
                                   _DATA)
                del delta
            else:
                cdelta = _stacked_zeros(params, ())  # cluster delta vs theta
                loss_acc = torch.zeros((), device=dev)
                pw_acc = torch.zeros((), device=dev)
                for i in range(tcfg.I):
                    ud, loss_acc = _user_delta(
                        cfg, tcfg, params, cdelta,
                        lambda j: _rows(batch, (i * tcfg.tau + j) * b_micro,
                                        b_micro),
                        loss_acc)
                    pw_acc = pw_acc + _symbol_power(ud, tcfg.P_t, specs)
                    # OTA cluster hop of the user deltas
                    est = cluster_hop(ud, geom, prng.fold_in(key, i),
                                      tcfg.P_t, tcfg.ota, specs=specs)
                    del ud
                    cdelta = tree_map(lambda a, b: a + b, cdelta, est)
                    del est
                est = global_hop(cdelta, geom,
                                 prng.fold_in(key, _GLOBAL_KEY),
                                 tcfg.P_is_t, tcfg.ota, specs=specs)
                del cdelta
                loss = sh.pmean(loss_acc / n_micro, _DATA)
                pw_edge = sh.pmean(pw_acc / tcfg.I, _DATA)
            del params
            new_params, new_opt = _apply_ranked(tcfg, outer_opt, stored,
                                                opt_state, est, step, lay)
            return new_params, new_opt, {"loss": loss, "edge_power": pw_edge}

    sharded_step = shard_map(per_user_step, rmesh, in_specs=P(),
                             out_specs=(P(), P(), P()), axis_names=_DATA)

    def train_step(state, batch, key):
        if refuse:
            raise NotImplementedError(refuse)
        _check_rows(batch, b_user)
        new_params, new_opt, metrics = sharded_step(
            state["params"], state["opt"], batch, key.to(dev),
            state["step"])
        return {"params": new_params, "opt": new_opt,
                "step": state["step"] + 1}, metrics

    return (train_step,
            _ranked_init(cfg, outer_opt, dev, rmesh, tcfg, lay, refuse),
            make_shardings(cfg, shape, rmesh, tcfg), rmesh)


def _fused_weights(geom: DistGeom, key, n_clusters: int, M: int,
                   b_user: int, dev):
    """(the per-example loss weights [B] folding both hops' per-user
    scalar gains, the noise key)."""
    f32 = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=dev)
    bo, bbc, bis = f32(geom.beta_own), f32(geom.beta_bar_c), f32(geom.beta_is)
    bb = float(geom.beta_bar)
    k_u, k_c, k_n = prng.split(key, 3)
    eps_m = prng.normal(k_u, (n_clusters, M)) / np.sqrt(geom.K)
    eps_c = prng.normal(k_c, (n_clusters,)) / np.sqrt(geom.K_ps)
    W = ((bo / bbc[:, None]) * (1.0 + eps_m)
         * ((bis / bb) * (1.0 + eps_c))[:, None])              # [C, M]
    # per-example weights: example e belongs to user e // b_user
    return torch.repeat_interleave(W.reshape(-1), b_user) / b_user, k_n


def _fused_noise(geom: DistGeom, tcfg: TrainConfig, delta, k_n, dev,
                 specs=None):
    """The estimate: `delta` plus one draw of the clusters' and the PS's
    noise (thermal exact, interference from the configured proxy
    power); of this rank's shards under `specs` inside the runner."""
    f32 = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=dev)
    bo, bbc, bis = f32(geom.beta_own), f32(geom.beta_bar_c), f32(geom.beta_is)
    bb = float(geom.beta_bar)
    pw = tcfg.ota.tx_power_proxy
    v_c = geom.sigma_z2 / (geom.K * (tcfg.P_t ** 2) * geom.sigma_h2 * bbc)
    if tcfg.ota.interference and pw is not None:
        v_c = v_c + (torch.sum(bo * (bbc[:, None] - bo), dim=1) * pw
                     / (geom.K * bbc ** 2))
    v_tot = (torch.sum((bis / bb) ** 2 * v_c)
             + geom.sigma_z2 / (geom.K_ps * (tcfg.P_is_t ** 2)
                                * geom.sigma_h2 * bb))
    std = torch.sqrt(v_tot / 2.0)
    leaves = list(tree_leaves(delta))
    keys = prng.split(k_n, len(leaves))
    return tree_from_paths(
        (p, l + std * draw_normal(kk, l.shape, spec))
        for kk, (p, l), spec in zip(keys, leaves,
                                    spec_list(specs, len(leaves))))


def _weighted_grad(cfg: ArchConfig, params, batch, w_ex, na: int, dev):
    """(float32 gradient of the weighted loss, mean CE) over `batch` in
    `na` microbatches."""
    if na == 1:
        g, metrics = _grad(cfg, params, batch, example_weights=w_ex)
        return tree_map(lambda x: x.float(), g), metrics["ce"]
    g, ce = None, torch.zeros((), device=dev)
    n = batch["tokens"].shape[0] // na
    for a in range(na):
        gi, metrics = _grad(cfg, params, _rows(batch, a * n, n),
                            example_weights=w_ex[a * n:(a + 1) * n])
        g = (tree_map(lambda b: b.float(), gi) if g is None else
             tree_map(lambda x, b: x + b.float(), g, gi))
        del gi
        ce = ce + metrics["ce"] / na
    return g, ce


def build_fused_train_step(cfg: ArchConfig, shape: InputShape, mesh,
                           tcfg: TrainConfig = TrainConfig(), *,
                           device=None):
    """W-HFL as a weighted gradient plus one noise draw.  Requires tau =
    I = 1.  The per-user OTA gain jitter is a per-user scalar folded into
    the per-example loss weights, and the interference noise uses
    ``tcfg.ota.tx_power_proxy`` as the users' power (None: thermal noise
    only), as in the reference.  On a `DeviceMesh`: ``(train_step,
    init_fn, shardings, mesh)``, each rank's gradient of its own rows
    all-reduced over (pod, cluster, user); on a shape mapping, one
    device: ``(train_step, init_fn)``."""
    if tcfg.tau != 1 or tcfg.I != 1:
        raise ValueError("fused path requires tau = I = 1")
    if sh.is_device_mesh(mesh):
        return _ranked_fused_step(cfg, shape, mesh, tcfg, device)
    n_clusters, M, geom, b_user = _geometry(cfg, shape, mesh, tcfg, False)
    dev = resolve_device(device)
    B = shape.global_batch
    na = tcfg.grad_accum
    if B % na:
        raise ValueError(f"global batch {B} not divisible by grad_accum "
                         f"{na}")
    outer_opt = _outer(tcfg)

    def train_step(state, batch, key):
        params, step = state["params"], state["step"]
        w_ex, k_n = _fused_weights(geom, key.to(dev), n_clusters, M, b_user,
                                   dev)
        g, ce = _weighted_grad(cfg, params, batch, w_ex, na, dev)
        delta = tree_map(lambda x: -tcfg.eta_local * x, g)
        del g
        est = _fused_noise(geom, tcfg, delta, k_n, dev)
        new_params, new_opt = _apply(tcfg, outer_opt, params, state["opt"],
                                     est, step)
        return ({"params": new_params, "opt": new_opt, "step": step + 1},
                {"loss": ce, "edge_power": _symbol_power(delta, tcfg.P_t)})

    return train_step, _init(cfg, outer_opt, dev)


def _ranked_fused_step(cfg: ArchConfig, shape: InputShape, mesh,
                       tcfg: TrainConfig, device):
    """`build_fused_train_step` on a `DeviceMesh`: this rank holds one
    user's rows; the gradient's one flat all-reduce goes over (pod,
    cluster, user), FSDP's split leaves' as the gathers' backward
    (`sharding.psum_scatter`).  The moments mirror the parameters, as
    the reference's shardings (``zero1`` places nothing more here).
    Returns the mesh it was given, as the reference."""
    M = tcfg.users_per_cluster
    rmesh = (mesh if "cluster" in sh.mesh_axes(mesh)
             else refine_mesh(mesh, users_per_cluster=M))
    n_clusters, M, geom, b_user = _geometry(cfg, shape, rmesh, tcfg, False)
    refuse = _not_executed(cfg, rmesh)
    dev = _rank_device(device)
    na = tcfg.grad_accum
    if b_user % na:
        raise ValueError(f"per-user batch {b_user} not divisible by "
                         f"grad_accum {na}")
    outer_opt = _outer(tcfg)
    rules = make_rules(rmesh, fsdp=tcfg.fsdp, cfg=cfg)
    lay = _layout(cfg, tcfg, rmesh, fused=True)
    specs = lay.params

    def per_user_step(params, opt_state, batch, key, step):
        with set_rules(rules):
            w_ex, k_n = _fused_weights(geom, key, n_clusters, M, b_user, dev)
            u = user_id()
            g, ce = _weighted_grad(cfg, params, batch,
                                   w_ex[u * b_user:(u + 1) * b_user], na,
                                   dev)
            # a leaf FSDP splits comes back summed and cut by its gathers'
            # backward; the others are summed here
            g = tree_from_paths(
                (p, x if sh.split_axes(spec, _DATA) else sh.psum(x, _DATA))
                for (p, x), spec in zip(tree_leaves(g),
                                        sh.spec_leaves(specs)))
            delta = tree_map(lambda x: -tcfg.eta_local * x, g)
            del g
            est = _fused_noise(geom, tcfg, delta, k_n, dev, specs)
            new_params, new_opt = _apply(tcfg, outer_opt, params, opt_state,
                                         est, step)
            return new_params, new_opt, {
                "loss": sh.pmean(ce, _DATA),
                "edge_power": _symbol_power(delta, tcfg.P_t, specs)}

    sharded_step = shard_map(per_user_step, rmesh, in_specs=P(),
                             out_specs=(P(), P(), P()), axis_names=_DATA)

    def train_step(state, batch, key):
        if refuse:
            raise NotImplementedError(refuse)
        _check_rows(batch, b_user)
        new_params, new_opt, metrics = sharded_step(
            state["params"], state["opt"], batch, key.to(dev),
            state["step"])
        return {"params": new_params, "opt": new_opt,
                "step": state["step"] + 1}, metrics

    return (train_step,
            _ranked_init(cfg, outer_opt, dev, rmesh, tcfg, lay, refuse),
            make_shardings(cfg, shape, mesh, tcfg, fused=True), mesh)
