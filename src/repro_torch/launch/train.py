"""Federated LM training steps with W-HFL's hierarchical OTA aggregation
(the port of `repro.launch.train`), on one card.

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

The JAX package runs one program per mesh coordinate under `shard_map`
on a device mesh; the port runs the users one after the other on one
card and takes the mesh as its shape alone (`launch.mesh.mesh_counts`:
a mapping such as ``{"data": 4, "model": 2}``).  So `shardings`,
`batch_shardings`, `outer_rules` and `abstract_state`, which place
arrays on a mesh, have no counterpart here; nor have `TrainConfig`'s
`fsdp` and `zero1` (sharding) and `seed` (which the reference's steps
do not read).  Several cards are ROADMAP queue A item 11.  `init_fn(key)` returns the
state alone (the reference also returns the logical axes, which the
port's parameters do not carry).  The steps run on the CUDA card unless
``device="cpu"`` is passed to `build_train_step` or
`build_fused_train_step`; `convert.state_from_jax` carries
a JAX train state across.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Mapping, Optional

import numpy as np
import torch

from repro_torch import prng
from repro_torch.configs.base import ArchConfig, InputShape
from repro_torch.core.dist import (DistGeom, OTADistConfig, cluster_hop,
                                   draw_normal, global_hop, uniform_geom,
                                   whfl_aggregate)
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import mesh_counts
from repro_torch.models import lm
from repro_torch.optim import adamw, sgd
from repro_torch.tree import tree_from_paths, tree_leaves, tree_map


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
    moment_dtype: str = "float32"  # "bfloat16" halves optimizer memory
    grad_accum: int = 1            # microbatches per step (fused path)
    geom: Optional[DistGeom] = None


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


def _symbol_power(delta_tree, P) -> torch.Tensor:
    """Paper §V per-complex-symbol transmit power: P^2 * ||flat||^2 / N
    with N = n_real_params / 2, i.e. 2 P^2 mean(x^2)."""
    leaves = [t for _, t in tree_leaves(delta_tree)]
    sq = sum(torch.sum(torch.square(t.float())) for t in leaves)
    n = sum(t.numel() for t in leaves)
    return 2.0 * (P ** 2) * sq / float(max(n, 1))


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


def _init(cfg: ArchConfig, outer_opt, dev: torch.device):
    def init_fn(key: torch.Tensor):
        """The train state from a `prng.PRNGKey` (moved to the step's
        device): the JAX package's `init_fn(key)[0]` values."""
        params = lm.init_params(key.to(dev), cfg)
        return {"params": params, "opt": outer_opt.init(params),
                "step": torch.zeros((), dtype=torch.int32, device=dev)}
    return init_fn


def build_train_step(cfg: ArchConfig, shape: InputShape,
                     mesh: Mapping[str, int],
                     tcfg: TrainConfig = TrainConfig(), *, device=None):
    """Returns (train_step, init_fn): the structural W-HFL step over
    the mesh's clusters (`mesh_counts`) of ``tcfg.users_per_cluster``
    users each."""
    dev = resolve_device(device)
    M = tcfg.users_per_cluster
    _, n_clusters, _ = mesh_counts(mesh, M)
    geom = tcfg.geom or uniform_geom(C=n_clusters, M=M)
    C = n_clusters
    n_users = C * M
    B = shape.global_batch
    if B % n_users:
        raise ValueError(f"global batch {B} not divisible by {n_users} users")
    b_user = B // n_users
    n_micro = tcfg.I * tcfg.tau
    if b_user % n_micro:
        raise ValueError(
            f"per-user batch {b_user} not divisible by I*tau={n_micro}")
    b_micro = b_user // n_micro
    outer_opt = _outer(tcfg)
    eta = tcfg.eta_local

    def train_step(state, batch, key):
        params, step = state["params"], state["step"]
        key = key.to(dev)
        if tcfg.tau == 1 and tcfg.I == 1:
            # degenerate round: hierarchical OTA gradient aggregation
            deltas = _stacked_zeros(params, (C, M))
            ces, pws = [], []
            for c in range(C):
                for m in range(M):
                    g, metrics = _grad(cfg, params, _rows(
                        batch, (c * M + m) * b_user, b_user))
                    delta = tree_map(lambda x: -eta * x.float(), g)
                    del g
                    tree_map(lambda d, x: d[c, m].copy_(x), deltas, delta)
                    ces.append(metrics["ce"])
                    pws.append(_symbol_power(delta, tcfg.P_t))
                    del delta
            est = whfl_aggregate(deltas, geom, prng.fold_in(key, 17),
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
                        ud = _stacked_zeros(params, ())
                        for j in range(tcfg.tau):
                            p_eff = tree_map(
                                lambda p, cd, x: (p.float() + cd[c] + x
                                                  ).to(p.dtype),
                                params, cdelta, ud)
                            s = u * b_user + (i * tcfg.tau + j) * b_micro
                            g, metrics = _grad(cfg, p_eff,
                                               _rows(batch, s, b_micro))
                            del p_eff
                            ud = tree_map(lambda x, gg: x - eta * gg.float(),
                                          ud, g)
                            del g
                            loss_acc[u] = loss_acc[u] + metrics["ce"]
                        pw_acc[u] = pw_acc[u] + _symbol_power(ud, tcfg.P_t)
                        tree_map(lambda d, x: d[c, m].copy_(x), udeltas, ud)
                        del ud
                est = cluster_hop(udeltas, geom, prng.fold_in(key, i),
                                  tcfg.P_t, tcfg.ota)
                del udeltas
                cdelta = tree_map(lambda a, b: a + b, cdelta, est)
                del est
            est = global_hop(cdelta, geom, prng.fold_in(key, 10_007),
                             tcfg.P_is_t, tcfg.ota)
            del cdelta
            loss = torch.stack([a / n_micro for a in loss_acc]).mean()
            pw_edge = torch.stack([a / tcfg.I for a in pw_acc]).mean()
        new_params, new_opt = _apply(tcfg, outer_opt, params, state["opt"],
                                     est, step)
        return ({"params": new_params, "opt": new_opt, "step": step + 1},
                {"loss": loss, "edge_power": pw_edge})

    return train_step, _init(cfg, outer_opt, dev)


def build_fused_train_step(cfg: ArchConfig, shape: InputShape,
                           mesh: Mapping[str, int],
                           tcfg: TrainConfig = TrainConfig(), *,
                           device=None):
    """Returns (train_step, init_fn): W-HFL as a weighted gradient plus
    one noise draw.  Requires tau = I = 1.  The per-user OTA gain jitter
    is a per-user scalar folded into the per-example loss weights, and
    the interference noise uses ``tcfg.ota.tx_power_proxy`` as the
    users' power (None: thermal noise only), as in the reference."""
    if tcfg.tau != 1 or tcfg.I != 1:
        raise ValueError("fused path requires tau = I = 1")
    dev = resolve_device(device)
    M = tcfg.users_per_cluster
    _, n_clusters, _ = mesh_counts(mesh, M)
    geom = tcfg.geom or uniform_geom(C=n_clusters, M=M)
    n_users = n_clusters * M
    B = shape.global_batch
    b_user = B // n_users
    na = tcfg.grad_accum
    if B % na:
        raise ValueError(f"global batch {B} not divisible by grad_accum "
                         f"{na}")
    outer_opt = _outer(tcfg)
    f32 = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=dev)
    bo, bbc, bis = f32(geom.beta_own), f32(geom.beta_bar_c), f32(geom.beta_is)
    bb = float(geom.beta_bar)

    def train_step(state, batch, key):
        params, step = state["params"], state["step"]
        k_u, k_c, k_n = prng.split(key.to(dev), 3)
        # per-user scalar OTA weights (both hops folded)
        eps_m = prng.normal(k_u, (n_clusters, M)) / np.sqrt(geom.K)
        eps_c = prng.normal(k_c, (n_clusters,)) / np.sqrt(geom.K_ps)
        W = ((bo / bbc[:, None]) * (1.0 + eps_m)
             * ((bis / bb) * (1.0 + eps_c))[:, None])          # [C, M]
        # per-example weights: example e belongs to user e // b_user
        w_ex = torch.repeat_interleave(W.reshape(-1), b_user) / b_user
        if na > 1:
            g, ce = None, torch.zeros((), device=dev)
            n = B // na
            for a in range(na):
                gi, metrics = _grad(cfg, params, _rows(batch, a * n, n),
                                    example_weights=w_ex[a * n:(a + 1) * n])
                g = (tree_map(lambda b: b.float(), gi) if g is None else
                     tree_map(lambda x, b: x + b.float(), g, gi))
                del gi
                ce = ce + metrics["ce"] / na
        else:
            g, metrics = _grad(cfg, params, batch, example_weights=w_ex)
            ce = metrics["ce"]
        delta = tree_map(lambda x: -tcfg.eta_local * x.float(), g)
        del g

        # channel noise: thermal (exact) + interference (proxy power)
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
        est = tree_from_paths(
            (p, l + std * draw_normal(kk, l.shape))
            for kk, (p, l) in zip(keys, leaves))
        new_params, new_opt = _apply(tcfg, outer_opt, params, state["opt"],
                                     est, step)
        return ({"params": new_params, "opt": new_opt, "step": step + 1},
                {"loss": ce, "edge_power": _symbol_power(delta, tcfg.P_t)})

    return train_step, _init(cfg, outer_opt, dev)
