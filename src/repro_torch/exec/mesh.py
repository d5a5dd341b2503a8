"""Meshes for the sharded W-HFL execution engine.

The engine runs every round on a 2-D mesh with axes ``("cluster",
"user")``: the scenario's C clusters are block-sharded over the
``cluster`` axis and the M users of each cluster over the ``user``
axis.  The same two axes double as the OTA-hop work split -- receiving
stations over ``cluster``, transmit symbols over ``user`` -- so one
mesh shape describes both phases of the round (see
`repro_torch.exec.round`).

A mesh is one of two things:

- a `Mesh`, a layout of shards in one process: the mc x mu shards run
  one after the other in row-major mesh order, on one torch device
  (`Mesh.device`), the counterpart of the JAX package's
  ``host_device_recipe``, which forces host devices so that a CxU mesh
  runs on one CPU.  Each collective of the JAX engine becomes a
  concatenation or a slice in mesh order;
- a `DeviceMesh` of ranks (`make_rank_mesh`): one process per shard,
  as the JAX engine runs one device per shard.  Each rank reads its
  shard's (ci, ui) from `repro_torch.sharding.axis_index` inside
  `sharding.shard_map`, and the collectives run between the ranks.

Either way each shard does exactly its own work -- it trains its own
users and launches the kernels on its own tile with its tile origin as
the counter bases.

A mesh does NOT have to divide the workload: `pad_plan_for` embeds any
(C, M) into the mesh by padding inactive users/clusters
(`repro_torch.core.topology.PadPlan`, amp = w = 0), and the executor
computes every hop on the real block only.  `validate_mesh_for` is the
strict divide-or-die check for callers that want to reject padding.
"""
from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Iterator, Sequence, Tuple, Union

import torch

from repro_torch.core.topology import PadPlan, pad_plan

MESH_AXES = ("cluster", "user")

MeshShape = Union[str, Sequence[int], Tuple[int, int]]


@dataclass(frozen=True)
class Mesh:
    """A ``("cluster", "user")`` mesh of ``shape = (mc, mu)`` shards,
    all run on `device`."""

    shape: Tuple[int, int]
    device: torch.device
    axis_names = MESH_AXES

    def shards(self) -> Iterator[Tuple[int, int]]:
        """Every shard's (cluster index, user index), row-major."""
        mc, mu = self.shape
        return ((ci, ui) for ci in range(mc) for ui in range(mu))


def parse_mesh(spec: MeshShape) -> Tuple[int, int]:
    """``"2x4"`` (or ``(2, 4)``) -> ``(2, 4)``: #cluster-shards x
    #user-shards."""
    if isinstance(spec, str):
        m = re.fullmatch(r"(\d+)\s*[xX*]\s*(\d+)", spec.strip())
        if not m:
            raise ValueError(
                f"mesh spec {spec!r} is not of the form 'CxU' (e.g. '2x4')")
        shape = (int(m.group(1)), int(m.group(2)))
    else:
        shape = tuple(int(s) for s in spec)
    if len(shape) != 2 or shape[0] < 1 or shape[1] < 1:
        raise ValueError(f"mesh shape must be two positive ints, got {shape}")
    return shape


def make_device_mesh(shape: MeshShape, device="cuda") -> Mesh:
    """The ``("cluster", "user")`` mesh of `shape` on one torch device."""
    return Mesh(parse_mesh(shape), torch.device(device))


def make_rank_mesh(shape: MeshShape, device_type: str = "cuda"):
    """The ``("cluster", "user")`` `DeviceMesh` of `shape` on the current
    process group, whose world must be mc x mu: rank r holds shard
    ``divmod(r, mu)``."""
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(device_type, parse_mesh(shape),
                            mesh_dim_names=MESH_AXES)


def validate_mesh_for(mesh: Mesh, C: int, M: int) -> Tuple[int, int]:
    """Strict check that the (C clusters, M users/cluster) workload
    divides the mesh; returns the per-shard block ``(C_loc, M_loc)``.

    The error names each offending mesh axis and the padded shape that
    would make it divide -- the executor applies exactly that padding
    automatically via `pad_plan_for`, so this check is only for callers
    that explicitly refuse padded (inactive-user) layouts.
    """
    mc, mu = mesh.shape
    plan = pad_plan(C, M, (mc, mu))
    problems = []
    if C % mc:
        problems.append(
            f"cluster axis: C={C} is not a multiple of the mesh's "
            f"{mc} cluster shards (pad to C={plan.Cp})")
    if M % mu:
        problems.append(
            f"user axis: M={M} is not a multiple of the mesh's "
            f"{mu} user shards (pad to M={plan.Mp})")
    if problems:
        raise ValueError(
            f"scenario (C={C}, M={M}) does not divide mesh {mc}x{mu} -- "
            + "; ".join(problems)
            + f". The sharded engine pads inactive users automatically "
            f"(pad_plan_for -> {plan.Cp}x{plan.Mp}); use validate_mesh_for "
            f"only to reject padded layouts.")
    return C // mc, M // mu


def pad_plan_for(mesh: Mesh, C: int, M: int) -> PadPlan:
    """The `PadPlan` embedding a (C, M) workload into `mesh`; it never
    rejects: any mesh runs any scenario, with inactive users (amp = w =
    0) filling the remainder.  ``plan.Cp // mc`` and ``plan.Mp // mu``
    are the per-shard block sizes."""
    return pad_plan(C, M, mesh.shape)
