"""The W-HFL round on a ``("cluster", "user")`` mesh of shards.

The counterpart of the JAX package's `repro.exec.round`, which runs the
round under `shard_map` with one device per shard.  The port runs it in
one of two ways (`repro_torch.exec.mesh`):

- on a `Mesh`: the mc x mu shards in one process, on the mesh's one
  torch device, phase by phase in row-major mesh order; each
  collective of the JAX engine is a concatenation or a slice in mesh
  order, and a value the JAX engine replicates is computed once;
- on a `DeviceMesh`: one process per shard, inside
  `repro_torch.sharding.shard_map`; each rank reads its shard's (ci,
  ui) from `axis_index` and the shards' data meet through
  `sharding.all_gather` between the ranks.  A value the JAX engine
  replicates is computed on every rank, on the same inputs.

Both give the same bits: every shard runs the same ops on the same
tile, and a gather only moves values.

Phase 1 -- local training.  Every shard trains only its own
``(C_loc, M_loc)`` block of users (`repro_torch.core.whfl.
make_local_train`, in vmapped passes of M users as on the single
engine, the last pass filled with zero users), from per-user keys split
over the *real* (C, M) grid and then padded.  The shards' deltas are
assembled into the real [C, M] block (on ranks: gathered over ``user``,
then ``cluster``, as the reference's ``_gather_cm`` gathers), and the
round body (`make_round_body`) precodes it with the round's
participation multipliers and takes the users' symbol energies for the
power fold over it: a row sum's order on the card (or over CPU
threads) follows the number of rows, so summing per shard would make
the power depend on the mesh.  The fused hop's tiles are cut from that
precoded block, so a sampled-out user enters them as a zero row,
exactly as an inactive pad slot does.  A robust cluster fold runs in
the body on the real block, as on the single engine.  (The reference
moves the transmit symbols to their tiles with an ``all_to_all`` over
symbols; the port, which holds the block already, cuts them out.)

Phase 2 -- the OTA hops.  With the ``fused`` backend the cluster hop
keeps its shard structure (`make_fused_cluster_hop`):

- ``gathered``: every shard launches `fused_mac` for its ``C_loc`` rx
  stations over all U users and its ``N_loc`` symbols, with its tile
  origin as the counter bases (``rx_base = ci*C_loc``,
  ``n_base = ui*N_loc``); the tiles gathered over ``user`` and
  ``cluster`` make the [Cp, N] estimate (the reference's ``collect``);
- ``u_sharded``: every shard launches `fused_mac_partials` for all Cp
  rx stations over only its own cluster-axis user tile
  (``u_base = ci*U_loc``) and its symbols; the tiles' blocks, gathered
  over ``cluster`` in global u-block order (the reference's
  ``order``), fold in one `fused_partials_reduce` per user-axis shard
  (on ranks: every rank folds its symbol slice, alike over
  ``cluster``), and a gather over ``user`` completes the estimate.

The counter PRNG keys on global (rx, u, k, n) indices only, so every
shard draws exactly the channels of the single-engine call, and the
kernels sum in a fixed block order, so both combines give the single
engine's estimate.  The other backends, the conventional baseline and
the IS -> PS hop run on the real block, once (one process) or on every
rank.

Uneven meshes: when the mesh does not divide (C, M) the workload is
padded with inactive users and clusters (`pad_plan_for`): padded users
train on zero dummy shards from zero keys, but every hop and the power
fold take the real ``[:C, :M]`` block only, and real users keep their
unpadded counter indices.
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F

from repro_torch import prng
from repro_torch.core import aggregation as agg
from repro_torch.core.channel import (OTAConfig, _cluster_geometry,
                                      _seed_words, cluster_ota,
                                      fused_estimate, pack_cx,
                                      resolve_backend)
from repro_torch.core.topology import Topology, pad_plan
from repro_torch.core.whfl import (WHFLConfig, make_local_train,
                                   make_round_body)
from repro_torch.kernels import (canonical_block_u, fused_mac,
                                 fused_mac_partials, fused_partials_reduce)
from repro_torch.optim import Optimizer
from repro_torch.sharding.api import all_gather, axis_index, is_device_mesh
from repro_torch.tree import tree_map

COMBINES = ("gathered", "u_sharded")


def _tile(x: torch.Tensor, r0: int, r1: int, c0: int,
          c1: int) -> torch.Tensor:
    """``x[r0:r1, c0:c1]`` of a 2-D tensor as a contiguous tensor,
    zero-filled where the window passes the edge of `x`."""
    out = x[r0:min(r1, x.shape[0]), c0:min(c1, x.shape[1])]
    pad_r, pad_c = r1 - r0 - out.shape[0], c1 - c0 - out.shape[1]
    if pad_r or pad_c:
        out = F.pad(out, (0, pad_c, 0, pad_r))
    return out.contiguous()


def mesh_shards(mesh) -> list:
    """The shards this process runs: every (ci, ui) of a `Mesh`, in
    row-major order, or this rank's of a `DeviceMesh` (inside
    `sharding.shard_map`)."""
    if is_device_mesh(mesh):
        return [(axis_index("cluster"), axis_index("user"))]
    return list(mesh.shards())


def make_fused_cluster_hop(topo: Topology, ota: OTAConfig, mesh, N: int,
                           combine: str = "gathered",
                           device=None) -> Callable:
    """Build the fused cluster hop of the sharded round,
    ``hop(key, deltas, P_t) -> est``: deltas [C, M, 2N] (the real
    users), est [Cp, 2N] (the padded rx stations' rows are zero).
    `mesh`: a `Mesh`, or a `DeviceMesh` of ranks (built and called
    inside `sharding.shard_map`; `device` the rank's).

    Both combines give `repro_torch.core.channel.FusedBackend.cluster`'s
    estimate in the real rows: the same draws, the same u-blocking
    (`canonical_block_u`), the same block order.
    """
    if combine not in COMBINES:
        raise ValueError(f"unknown combine {combine!r}; known: "
                         f"{', '.join(COMBINES)}")
    C, M, K = topo.C, topo.M, topo.K
    U = C * M
    mc, mu = tuple(mesh.shape)
    on_ranks = is_device_mesh(mesh)
    shards = mesh_shards(mesh)
    plan = pad_plan(C, M, (mc, mu))
    Cp = plan.Cp
    C_loc = Cp // mc
    U_loc = C_loc * M                       # u_sharded: users per tile
    N_loc = -(-N // mu)                     # symbols per user-axis shard
    bu = canonical_block_u(M)
    G_real = U // bu                        # the real users' u-blocks
    amp, own, bb = _cluster_geometry(topo, ota, device or mesh.device)
    amp, own = plan.pad_rx(amp), plan.pad_rx(own)       # [Cp, U]
    bb = plan.pad_rx(bb, fill=1.0)                      # [Cp]
    if combine == "gathered":
        # shard ci hears all U users at its C_loc rx stations
        geo = {ci: (amp[ci * C_loc:(ci + 1) * C_loc],
                    own[ci * C_loc:(ci + 1) * C_loc]) for ci, _ in shards}
    else:
        # virtual user axis [Cp * M]: real users keep their c * M + m
        # index, the padded clusters' users append as zero columns, and
        # cluster-axis shard ci owns the tile [ci * U_loc, ...)
        amp_v = F.pad(amp, (0, (Cp - C) * M))
        own_v = F.pad(own, (0, (Cp - C) * M))
        geo = {ci: (amp_v[:, ci * U_loc:(ci + 1) * U_loc].contiguous(),
                    own_v[:, ci * U_loc:(ci + 1) * U_loc].contiguous())
               for ci, _ in shards}

    def order(blocks):
        """Every cluster-axis shard's blocks [Cp, G_loc, K, N_loc] (or
        one tensor of them all), in global u-block order, cut to the
        real users' blocks (the padded clusters' blocks are strictly
        trailing)."""
        p = blocks[0] if len(blocks) == 1 else torch.cat(blocks, dim=1)
        return p if p.shape[1] == G_real else p[:, :G_real].contiguous()

    # u_sharded on ranks: a rank makes only its own tile's symbols
    own_tile = on_ranks and combine == "u_sharded"

    def hop(key, deltas, P_t):
        seed = _seed_words(key)
        cols = [(ui * N_loc, (ui + 1) * N_loc) for ui in range(mu)]
        r_lo = shards[0][0] * U_loc if own_tile else 0
        t = P_t * pack_cx(deltas.reshape(U, -1)[
            r_lo:r_lo + U_loc if own_tile else U])
        t_re, t_im = t.real, t.imag
        if combine == "gathered":
            tiles = {}
            for ci, ui in shards:
                c0, c1 = cols[ui]
                tiles[ci, ui] = fused_mac(
                    seed, _tile(t_re, 0, U, c0, c1),
                    _tile(t_im, 0, U, c0, c1), *geo[ci], K=K,
                    sigma_h2=topo.sigma_h2, sigma_z2=topo.sigma_z2,
                    rx_base=ci * C_loc, n_base=c0, block_u=bu)
            if on_ranks:                # [2, C_loc, N_loc] -> [2, Cp, N]
                y = all_gather(all_gather(torch.stack(tiles[shards[0]]),
                                          "user", 2)[..., :N], "cluster", 1)
                y = torch.complex(y[0], y[1])
            else:
                y = torch.cat([torch.cat([torch.complex(*tiles[ci, ui])
                                          for ui in range(mu)], 1)[:, :N]
                               for ci in range(mc)], 0)       # [Cp, N]
        else:
            parts = {}
            for ci, ui in shards:
                (c0, c1), r0 = cols[ui], ci * U_loc
                parts[ci, ui] = fused_mac_partials(
                    seed, _tile(t_re, r0 - r_lo, r0 - r_lo + U_loc, c0, c1),
                    _tile(t_im, r0 - r_lo, r0 - r_lo + U_loc, c0, c1),
                    *geo[ci], K=K, sigma_h2=topo.sigma_h2, u_base=r0,
                    n_base=c0, block_u=bu)
            if on_ranks:
                # the 4 planes [Cp, G_loc, K, N_loc] in one gather
                g = all_gather(torch.stack(parts[shards[0]]), "cluster", 2)
                folds = {shards[0][1]: [[p] for p in g.unbind(0)]}
            else:
                folds = {ui: [[parts[ci, ui][j] for ci in range(mc)]
                              for j in range(4)] for ui in range(mu)}
            ys = {ui: fused_partials_reduce(
                seed, *(order(b) for b in blocks), K=K,
                sigma_z2=topo.sigma_z2, n_base=cols[ui][0])
                for ui, blocks in folds.items()}
            if on_ranks:                # [2, Cp, N_loc] -> [2, Cp, N]
                y = all_gather(torch.stack(ys[shards[0][1]]), "user",
                               2)[..., :N]
                y = torch.complex(y[0], y[1])
            else:
                y = torch.cat([torch.complex(*ys[ui]) for ui in range(mu)],
                              dim=1)[:, :N]                   # [Cp, N]
        return fused_estimate(y, K, P_t, topo.sigma_h2, bb[:, None])

    return hop


def make_sharded_round_fn(loss_fn: Callable, opt: Optimizer, topo: Topology,
                          cfg: WHFLConfig, spec: agg.FlatSpec,
                          X: torch.Tensor, Y: torch.Tensor, mesh,
                          combine: str = "gathered") -> Callable:
    """Build ``round_fn(state, key, P_t, P_is_t) -> state`` running one
    W-HFL round sharded over `mesh`: a `Mesh` (every shard in this
    process) or a `DeviceMesh` of ranks (this rank's shard; build and
    call it inside `sharding.shard_map`).

    The round body is the single engine's
    (`repro_torch.core.whfl.make_round_body`); this engine supplies its
    per-shard training and its cluster hop.  The same contract as
    `repro_torch.core.whfl.make_round_fn`, for a state whose ``opt``
    axes are sized to the mesh's padded (Cp, Mp) grid on a `Mesh`
    (``init_round_state(params, opt, plan.Cp, plan.Mp)``), and to this
    rank's (C_loc, M_loc) block of it on ranks (the sharded runner does
    this); every other leaf is whole, and alike on every rank.  X [C,
    M, n, ...] and Y [C, M, n] are the users' shards on the run's
    device.
    """
    if combine not in COMBINES:
        raise ValueError(f"unknown combine {combine!r}; known: "
                         f"{', '.join(COMBINES)}")
    C, M = topo.C, topo.M
    mc, mu = tuple(mesh.shape)
    plan = pad_plan(C, M, (mc, mu))
    C_loc, M_loc = plan.Cp // mc, plan.Mp // mu
    N = spec.two_n // 2
    on_ranks = is_device_mesh(mesh)
    # passes of M users, as on the single engine: a user's gradient then
    # has the same bits whichever shard holds it
    local_train = make_local_train(loss_fn, opt, cfg, pass_width=M)
    backend = "" if cfg.ota.mode == "ideal" else resolve_backend(cfg.ota)
    fused_hop = (make_fused_cluster_hop(topo, cfg.ota, mesh, N, combine,
                                        device=X.device)
                 if cfg.mode != "conventional" and backend == "fused"
                 else None)
    shards = mesh_shards(mesh)

    def users(x, ci, ui):
        """Shard (ci, ui)'s block of a padded [Cp, Mp, ...] grid, as a
        [C_loc * M_loc, ...] user axis."""
        b = x[ci * C_loc:(ci + 1) * C_loc, ui * M_loc:(ui + 1) * M_loc]
        return b.reshape(C_loc * M_loc, *b.shape[2:])

    Xp, Yp = plan.pad_users(X), plan.pad_users(Y)   # inactive: zero shards
    data = {s: (users(Xp, *s), users(Yp, *s)) for s in shards}

    def assemble(grid):
        """Per-shard [C_loc, M_loc, ...] tensors -> the [Cp, Mp, ...]
        grid, in mesh order (the JAX engine's all_gathers)."""
        if on_ranks:
            return all_gather(all_gather(grid[shards[0]], "user", 1),
                              "cluster", 0)
        if len(grid) == 1:
            return grid[shards[0]]
        return torch.cat([torch.cat([grid[ci, ui] for ui in range(mu)], 1)
                          for ci in range(mc)], 0)

    def real(x):
        """The real users' [C, M, ...] block of a padded grid, laid out as
        the single engine lays it out."""
        return plan.unpad_users(x).contiguous()

    def users_train(theta_IS, opt_state, key, step):
        """Every shard trains its own users from the [Cp]-stacked
        cluster models.  Returns the real users' flat deltas [C, M, 2N]
        and the opt state ([Cp, Mp, ...], or this rank's [C_loc, M_loc,
        ...] block)."""
        keys = plan.pad_users(prng.split(key, C * M).reshape(C, M, 2))
        flats, states = {}, {}
        for ci, ui in shards:
            th = tree_map(
                lambda x: x[ci * C_loc:(ci + 1) * C_loc, None]
                .expand(C_loc, M_loc, *x.shape[1:])
                .reshape(C_loc * M_loc, *x.shape[1:]), theta_IS)
            st = tree_map(lambda x: x.reshape(C_loc * M_loc, *x.shape[2:])
                          if on_ranks else users(x, ci, ui), opt_state)
            deltas, st = local_train(th, st, *data[ci, ui],
                                     users(keys, ci, ui), step)
            flats[ci, ui] = agg.flatten(spec, deltas).reshape(C_loc, M_loc,
                                                              -1)
            states[ci, ui] = tree_map(
                lambda x: x.reshape(C_loc, M_loc, *x.shape[1:]), st)
        if on_ranks:
            return real(assemble(flats)), states[shards[0]]
        opt_state = tree_map(lambda *xs: assemble(dict(zip(shards, xs))),
                             *(states[s] for s in shards))
        return real(assemble(flats)), opt_state

    def cluster_estimate(key, flat, P_t):
        """[Cp, 2N]: the real rows are the single engine's estimate."""
        if fused_hop is not None:
            return fused_hop(key, flat, P_t)
        return plan.pad_rx(cluster_ota(key, flat, topo, P_t, cfg.ota))

    return make_round_body(topo, cfg, spec, users_train, cluster_estimate,
                           n_rx=plan.Cp)
