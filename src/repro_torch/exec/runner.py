"""`ShardedSweepRunner`: the sweep engine on a mesh of shards.

A `repro_torch.sim.SweepRunner` subclass -- same scenarios, same JSON
schema, its seeds always one by one (``batch="map"``) -- that swaps the
single-engine round for `repro_torch.exec.round.make_sharded_round_fn`
on a ``("cluster", "user")`` mesh: every shard in this process, on the
runner's one device, or, with ``ranks``, one process per shard
(`repro_torch.launch.ranks.sweep_worker`), as the JAX engine runs one
device per shard.

    python -m repro_torch.sim.sweep --scenarios scale_u256 --seeds 2 \
        --exec sharded --mesh 2x4 --combine u_sharded [--ranks gloo]
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Union

import torch

from repro_torch.core.topology import PadPlan, pad_plan
from repro_torch.core.whfl import init_round_state
from repro_torch.exec.mesh import make_device_mesh, parse_mesh
from repro_torch.exec.round import COMBINES, make_sharded_round_fn
from repro_torch.kernels import canonical_block_u
from repro_torch.sharding.api import P, all_gather, shard_map
from repro_torch.sim.scenario import Scenario
from repro_torch.sim.sweep import SweepResult, SweepRunner
from repro_torch.tree import tree_map

# The process-group backends a sweep on ranks takes: gloo (CPU ranks, or
# ranks sharing one card, which it stages through host memory) and NCCL
# (one rank a card).
RANK_BACKENDS = ("gloo", "nccl")
RANKS_TODO = "ROADMAP queue A item 11"


class ShardedSweepRunner(SweepRunner):
    """Run scenarios sharded over a ``(cluster, user)`` mesh.

    mesh: ``"CxU"`` string or ``(C_shards, U_shards)`` tuple.  A
    scenario need not divide the mesh: it is then padded with inactive
    users (amp = w = 0; `pad_plan_for`), the ``opt`` state axes are
    sized to the padded (Cp, Mp) grid here and stripped again before
    ``final_state`` is stored.  combine: the fused cluster hop's
    strategy, ``"gathered"`` or ``"u_sharded"``.  Seeds run one by one
    (``batch="map"``), as in the reference's sharded engine: the engine's
    contract is sharded == single bit for bit, which a seed vmap's
    batched GEMMs would break.  ``driver="chunked"`` replays each eval
    window as one CUDA graph of the whole sharded round (every shard's
    training, the partial kernels, the fold and the IS -> PS hop), as in
    the single engine.

    ranks: None (the shards in this process), or the backend, ``"gloo"``
    or ``"nccl"``, of mc x mu processes, one per shard
    (`repro_torch.launch.ranks.sweep_worker`): each rank trains its own
    users and launches the hop's kernels on its own tile, and the ranks
    meet in collectives (`repro_torch.sharding`).  Rank 0's results are
    returned (final states on the runner's device), after every rank's
    metrics are checked equal to them; `rank_reports` keeps each rank's
    launches, collectives, seconds and peak memory.  On CUDA gloo ranks
    share the card; NCCL takes one card a rank and raises with fewer.
    Checkpoints, resume, the journal and faults do not run on ranks yet
    (they raise `NotImplementedError`).
    """

    def __init__(self, scenarios: Sequence[Union[str, Scenario]],
                 seeds=1, quick: bool = False, keep_state: bool = False,
                 mesh: Union[str, tuple] = "1x1",
                 combine: str = "gathered", driver: str = "stepwise",
                 warmup: bool = False, device: Optional[str] = None,
                 ranks: Optional[str] = None, **ft_obs):
        if ranks is not None:
            if ranks not in RANK_BACKENDS:
                raise ValueError(f"unknown rank backend {ranks!r}; known: "
                                 f"{', '.join(RANK_BACKENDS)}")
            unported = [k for k in ("checkpoint", "trace", "faults")
                        if ft_obs.get(k) is not None]
            if ft_obs.get("resume"):
                unported.append("resume")
            if unported:
                raise NotImplementedError(
                    f"{', '.join(unported)} on ranks: {RANKS_TODO} (the "
                    f"sharded sweep on ranks)")
        super().__init__(scenarios, seeds=seeds, quick=quick,
                         keep_state=keep_state, batch="map", driver=driver,
                         warmup=warmup, device=device, **ft_obs)
        if combine not in COMBINES:
            raise ValueError(f"unknown combine {combine!r}; known: "
                             f"{', '.join(COMBINES)}")
        self.combine = combine
        self.mesh_shape = parse_mesh(mesh)
        self.mesh = make_device_mesh(self.mesh_shape, self.device)
        self.ranks = ranks
        self.rank_reports: Optional[List[dict]] = None
        world = self.mesh_shape[0] * self.mesh_shape[1]
        if ranks == "nccl" and (self.device.type != "cuda"
                                or torch.cuda.device_count() < world):
            raise ValueError(
                f"ranks='nccl' takes one CUDA card a rank: mesh "
                f"{world} ranks, {torch.cuda.device_count()} cards on "
                f"{self.device}; use ranks='gloo' for ranks that share "
                f"a card or the CPU")

    def run(self) -> List[SweepResult]:
        """Every scenario; with `ranks`, on mc x mu processes."""
        if self.ranks is None:
            return super().run()
        from repro_torch.launch.ranks import launch, sweep_worker

        if self.device.type == "cuda":
            # build once here, so the ranks load the libraries and do
            # not all run nvcc at once
            from repro_torch.kernels import build
            build.load_all(["fused_mac", "ota_combine"])
        spec = dict(scenarios=self.scenarios, seeds=self.seeds,
                    keep_state=self.keep_state, mesh=self.mesh_shape,
                    combine=self.combine, driver=self.driver,
                    warmup=self.warmup, device=str(self.device),
                    guard=self.guard)
        mc, mu = self.mesh_shape
        self.rank_reports = launch(sweep_worker, mc * mu, self.ranks, spec)
        results = self.rank_reports[0]["results"]
        for rep in self.rank_reports[1:]:
            for a, b in zip(results, rep["results"]):
                if any(getattr(a, k) != getattr(b, k) for k in (
                        "rounds", "acc", "loss", "edge_power", "is_power")):
                    raise RuntimeError(
                        f"{a.scenario.name}: rank {rep['rank']}'s metrics "
                        f"differ from rank 0's")
        for r in results:
            if r.final_state is not None:
                r.final_state = tree_map(lambda t: t.to(self.device),
                                         r.final_state)
        return results

    def _pad_plan(self, topo) -> PadPlan:
        return pad_plan(topo.C, topo.M, self.mesh_shape)

    def _init_states(self, params, opt, topo, cfg):
        plan = self._pad_plan(topo)
        # telemetry reads the real (C, M) block: its cluster axis is C
        return [init_round_state(p, opt, plan.Cp, plan.Mp,
                                 telemetry_C=topo.C if cfg.telemetry
                                 else None, guard=cfg.guard != "off")
                for p in params]

    def _finalize_state(self, state, topo):
        """Strip the padded opt rows/cols (the leading axis is the seed
        batch), so final states compare equal across engines and meshes
        and a checkpoint (which stores this view) resumes on any mesh."""
        if self._pad_plan(topo).is_identity:
            return state
        return {**state, "opt": tree_map(lambda x: x[:, :topo.C, :topo.M],
                                         state["opt"])}

    def _restore_state(self, state, topo):
        """The inverse of `_finalize_state` for a resume: the opt axes of
        a canonical (C, M) carry padded with zeros to this mesh's (Cp,
        Mp) grid.  A padded user's opt state is carried but never
        transmitted, and its gradient pass is as wide with any
        neighbours (`make_local_train`), so the real users continue bit
        for bit."""
        plan = self._pad_plan(topo)
        if plan.is_identity:
            return state

        def pad(x):   # [S, C, M, ...] -> [S, Cp, Mp, ...]
            out = x.new_zeros((x.shape[0], plan.Cp, plan.Mp, *x.shape[3:]))
            out[:, :topo.C, :topo.M] = x
            return out

        return {**state, "opt": tree_map(pad, state["opt"])}

    def _build_round(self, loss_fn, opt, topo, cfg, spec, X, Y):
        return make_sharded_round_fn(loss_fn, opt, topo, cfg, spec, X, Y,
                                     self.mesh, combine=self.combine)

    def _exec_info(self, topo=None, two_n=None) -> Dict:
        """``device_count`` is the number of torch devices that ran the
        shards (1); ``mesh`` gives the shard layout."""
        mc, mu = self.mesh_shape
        info = {**super()._exec_info(), "name": "sharded",
                "mesh": f"{mc}x{mu}", "padded": None,
                "combine": self.combine}
        if topo is not None:
            plan = self._pad_plan(topo)
            if not plan.is_identity:
                info["padded"] = f"{plan.Cp}x{plan.Mp}"
            if two_n is not None:
                info["peak_symbol_bytes"] = self._peak_symbol_bytes(
                    topo, plan, two_n)
        return info

    def _peak_symbol_bytes(self, topo, plan, two_n) -> int:
        """Per-shard bytes of the fused cluster hop's symbol-domain
        buffers (float32 transmit symbols and the partial sums):
        gathered holds the full [U, N_loc] symbol block per shard;
        u_sharded only the shard's own user tile plus the partial sums
        [Cp, G, K, N_loc] of every tile (G = Cp * M / block_u)."""
        mc, mu = self.mesh_shape
        N_loc = -(-(two_n // 2) // mu)
        if self.combine == "gathered":
            return 8 * topo.C * topo.M * N_loc
        G_tot = plan.Cp * topo.M // canonical_block_u(topo.M)
        return (8 * (plan.Cp // mc) * topo.M * N_loc
                + 16 * plan.Cp * G_tot * topo.K * N_loc)


class RankSweepRunner(ShardedSweepRunner):
    """One rank's share of a sweep on ranks (run by
    `repro_torch.launch.ranks.sweep_worker` in every process of the
    group): the round on the ``("cluster", "user")`` `DeviceMesh` `mesh`
    (`repro_torch.exec.mesh.make_rank_mesh`), inside
    `sharding.shard_map`.  Its state carries this rank's (C_loc, M_loc)
    block of the ``opt`` axes and every other leaf whole; the final
    state gathers the blocks and strips the padding, so it equals the
    one-process run's.  The keywords are `ShardedSweepRunner`'s, less
    ``mesh`` and ``ranks``."""

    def __init__(self, scenarios, mesh, backend: str, **kw):
        super().__init__(scenarios, mesh=tuple(mesh.shape), **kw)
        self.rank_mesh = mesh
        self.backend = backend

    def run(self) -> List[SweepResult]:
        return shard_map(lambda: SweepRunner.run(self), self.rank_mesh,
                         P(), P())()

    def _block(self, topo):
        plan = self._pad_plan(topo)
        mc, mu = self.mesh_shape
        return plan.Cp // mc, plan.Mp // mu

    def _init_states(self, params, opt, topo, cfg):
        C_loc, M_loc = self._block(topo)
        return [init_round_state(p, opt, C_loc, M_loc,
                                 telemetry_C=topo.C if cfg.telemetry
                                 else None, guard=cfg.guard != "off")
                for p in params]

    def _finalize_state(self, state, topo):
        """The ranks' opt blocks [S, C_loc, M_loc, ...] gathered over
        ``user`` and ``cluster`` (a collective: every rank calls it),
        then the padding stripped."""
        opt = tree_map(lambda x: all_gather(all_gather(x, "user", 2),
                                            "cluster", 1), state["opt"])
        return super()._finalize_state({**state, "opt": opt}, topo)

    def _restore_state(self, state, topo):
        raise NotImplementedError(f"resume on ranks: {RANKS_TODO}")

    def _build_round(self, loss_fn, opt, topo, cfg, spec, X, Y):
        return make_sharded_round_fn(loss_fn, opt, topo, cfg, spec, X, Y,
                                     self.rank_mesh, combine=self.combine)

    def _exec_info(self, topo=None, two_n=None) -> Dict:
        """As the one-process engine's, ``device_count`` the ranks (one
        process per shard, as the reference's one device per shard) and
        ``ranks`` their backend."""
        mc, mu = self.mesh_shape
        return {**super()._exec_info(topo, two_n), "device_count": mc * mu,
                "ranks": self.backend}

    def _peak_symbol_bytes(self, topo, plan, two_n) -> int:
        """Bytes of the float32 symbol-domain tensors one rank holds at
        its cluster hop: the gathered real block [C, M, 2N] of flat
        deltas, the complex transmit symbols of the users it sends (all
        U under gathered, its own tile's C_loc * M under u_sharded) with
        their real and imaginary planes, its [users, N_loc] tile, and
        under u_sharded its partial sums [Cp, G_loc, K, N_loc] and
        every tile's, gathered [Cp, G, K, N_loc]."""
        mc, mu = self.mesh_shape
        N = two_n // 2
        N_loc = -(-N // mu)
        U = topo.C * topo.M
        rows = U if self.combine == "gathered" else (plan.Cp // mc) * topo.M
        held = 8 * U * N + 16 * rows * N + 8 * rows * N_loc
        if self.combine == "u_sharded":
            G_tot = plan.Cp * topo.M // canonical_block_u(topo.M)
            held += 16 * plan.Cp * (G_tot + G_tot // mc) * topo.K * N_loc
        return held
