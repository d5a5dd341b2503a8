"""`ShardedSweepRunner`: the sweep engine on a mesh of shards.

A `repro_torch.sim.SweepRunner` subclass -- same scenarios, same JSON
schema, its seeds always one by one (``batch="map"``) -- that swaps the
single-engine round for `repro_torch.exec.round.make_sharded_round_fn`
on a ``("cluster", "user")`` mesh whose shards all run on the runner's
one device.

    python -m repro_torch.sim.sweep --scenarios scale_u256 --seeds 2 \
        --exec sharded --mesh 2x4 --combine u_sharded
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Union

from repro_torch.core.topology import PadPlan, pad_plan
from repro_torch.core.whfl import init_round_state
from repro_torch.exec.mesh import make_device_mesh, parse_mesh
from repro_torch.exec.round import COMBINES, make_sharded_round_fn
from repro_torch.kernels import canonical_block_u
from repro_torch.sim.scenario import Scenario
from repro_torch.sim.sweep import SweepRunner
from repro_torch.tree import tree_map


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
    """

    def __init__(self, scenarios: Sequence[Union[str, Scenario]],
                 seeds=1, quick: bool = False, keep_state: bool = False,
                 mesh: Union[str, tuple] = "1x1",
                 combine: str = "gathered", driver: str = "stepwise",
                 warmup: bool = False, device: Optional[str] = None,
                 **ft_obs):
        super().__init__(scenarios, seeds=seeds, quick=quick,
                         keep_state=keep_state, batch="map", driver=driver,
                         warmup=warmup, device=device, **ft_obs)
        if combine not in COMBINES:
            raise ValueError(f"unknown combine {combine!r}; known: "
                             f"{', '.join(COMBINES)}")
        self.combine = combine
        self.mesh_shape = parse_mesh(mesh)
        self.mesh = make_device_mesh(self.mesh_shape, self.device)

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
