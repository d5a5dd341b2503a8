"""`repro_torch.exec` -- execution engines for W-HFL rounds.

Two engines share one contract (the `repro_torch.sim` sweep API and
JSON schema):

- ``single`` -- `repro_torch.sim.SweepRunner`: the whole round on one
  device, the users' local training in vmapped passes of M users.
- ``sharded`` -- `ShardedSweepRunner`: the round on a ``("cluster",
  "user")`` mesh of shards (`repro_torch.exec.mesh`), each shard
  training its own users and launching the fused cluster-hop kernels on
  its own tile with per-shard counter bases
  (`repro_torch.exec.round`).  The shards run one after the other in
  one process, or, with ``ranks``, one process per shard, meeting in
  collectives (gloo on the CPU or on one shared card, NCCL one card a
  rank).  Meshes need not divide (C, M): uneven shapes pad inactive
  users in (amp = w = 0; `pad_plan_for`).

Select with ``python -m repro_torch.sim.sweep --exec sharded --mesh 2x4
[--combine u_sharded] [--ranks gloo|nccl]``.
"""
from __future__ import annotations

from typing import Optional, Sequence, Union

from repro_torch.exec.mesh import (MESH_AXES, Mesh, make_device_mesh,
                                   make_rank_mesh, pad_plan_for, parse_mesh,
                                   validate_mesh_for)
from repro_torch.exec.round import (COMBINES, make_fused_cluster_hop,
                                    make_sharded_round_fn)
from repro_torch.exec.runner import (RANK_BACKENDS, RankSweepRunner,
                                     ShardedSweepRunner)
from repro_torch.sim.scenario import Scenario
from repro_torch.sim.sweep import SweepRunner

ENGINES = ("single", "sharded")


def make_runner(exec_name: str, scenarios: Sequence[Union[str, Scenario]],
                *, seeds=1, quick: bool = False, batch: str = "vmap",
                mesh: Union[str, tuple] = "1x1", keep_state: bool = False,
                combine: str = "gathered", driver: str = "stepwise",
                warmup: bool = False, device=None,
                ranks: Optional[str] = None, **ft_obs) -> SweepRunner:
    """Engine factory behind the ``--exec`` CLI flag.  The single engine
    runs the seeds in `batch` mode (``vmap`` by default, or ``map``);
    the sharded one always runs them as ``map``, as the reference's
    does, in this process or, with `ranks` (``"gloo"`` or ``"nccl"``),
    one process per shard.  Both engines take both round drivers
    (``stepwise``, ``chunked``) and the runner's telemetry, trace,
    checkpoint and fault keywords (`ft_obs`:
    ``telemetry``, ``trace``, ``checkpoint``, ``ckpt_every``,
    ``resume``, ``guard``, ``faults``), passed through as they are."""
    if exec_name == "single":
        if ranks is not None:
            raise ValueError(
                f"ranks={ranks!r} requires the sharded engine (--exec "
                f"sharded): the single engine runs in one process")
        if combine != "gathered":
            raise ValueError(
                f"combine={combine!r} requires the sharded engine "
                f"(--exec sharded); the single engine has no user-axis "
                f"distribution to select")
        return SweepRunner(scenarios, seeds=seeds, quick=quick,
                           keep_state=keep_state, batch=batch,
                           driver=driver, warmup=warmup, device=device,
                           **ft_obs)
    if exec_name == "sharded":
        return ShardedSweepRunner(scenarios, seeds=seeds, quick=quick,
                                  keep_state=keep_state, mesh=mesh,
                                  combine=combine, driver=driver,
                                  warmup=warmup, device=device, ranks=ranks,
                                  **ft_obs)
    raise ValueError(
        f"unknown execution engine {exec_name!r}; known: "
        f"{', '.join(ENGINES)}")


__all__ = ["COMBINES", "ENGINES", "MESH_AXES", "Mesh", "RANK_BACKENDS",
           "RankSweepRunner", "ShardedSweepRunner", "SweepRunner",
           "make_device_mesh", "make_fused_cluster_hop", "make_rank_mesh",
           "make_runner", "make_sharded_round_fn",
           "pad_plan_for", "parse_mesh", "validate_mesh_for"]
