"""Production meshes (single-pod 16x16, multi-pod 2x16x16) and the
W-HFL refinement of the data axis into (cluster, user) sub-axes (the
port of `repro.launch.mesh`).

A mesh is a `torch.distributed.device_mesh.DeviceMesh` over the ranks
of the current process group (one process per card; several processes
may share one card under gloo), or, where only its shape matters
(`mesh_counts`, the sharding tables), a mapping of axis names to sizes
in mesh order, e.g. ``{"data": 4, "model": 2}``.  Functions, not
module-level constants: importing this module touches no process group.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.sharding.api import is_device_mesh, mesh_axes


def _device_type() -> str:
    return "cuda" if torch.cuda.is_available() else "cpu"


def make_production_mesh(*, multi_pod: bool = False, device_type=None):
    """(16, 16) over ("data", "model"), or (2, 16, 16) over ("pod",
    "data", "model"), on the current world (256 or 512 ranks), built with
    `init_device_mesh`."""
    from torch.distributed.device_mesh import init_device_mesh

    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return init_device_mesh(device_type or _device_type(), shape,
                            mesh_dim_names=axes)


def make_mesh(sizes, *, device_type=None):
    """A production-style mesh on the current world for (pod, cluster,
    user, model) sizes: ("data", "model") over (cluster x user, model),
    with a leading "pod" axis when there is more than one pod; their
    product must be the world size.  `refine_mesh` turns it into the
    (pod, cluster, user, model) mesh the train steps run on."""
    from torch.distributed.device_mesh import init_device_mesh

    n_pod, n_cluster, n_user, n_model = sizes
    shape = (n_cluster * n_user, n_model)
    names = ("data", "model")
    if n_pod > 1:
        shape, names = (n_pod,) + shape, ("pod",) + names
    return init_device_mesh(device_type or _device_type(), shape,
                            mesh_dim_names=names)


def refine_mesh(mesh, *, users_per_cluster: int = 4):
    """Refine `data` -> (cluster, user) over the identical rank order.

    Returns a mesh with axes ('pod', 'cluster', 'user', 'model'); a
    single-pod input gets a size-1 'pod' axis.  Rank placement equals the
    production mesh's, so a spec over ('cluster', 'user') places exactly
    as one over 'data'.  A `DeviceMesh` gives a `DeviceMesh` (building
    its process groups, a collective call), a shape mapping a mapping.
    """
    sizes = mesh_axes(mesh)
    n_pod, n_data, n_model = (sizes.get("pod", 1), sizes["data"],
                              sizes["model"])
    M = users_per_cluster
    if n_data % M:
        raise ValueError(f"data axis {n_data} not divisible by M={M}")
    names = ("pod", "cluster", "user", "model")
    shape = (n_pod, n_data // M, M, n_model)
    if not is_device_mesh(mesh):
        return dict(zip(names, shape))
    from torch.distributed.device_mesh import DeviceMesh

    return DeviceMesh(mesh.device_type, mesh.mesh.reshape(shape),
                      mesh_dim_names=names)


def mesh_counts(mesh, users_per_cluster: int = 4) -> Tuple[int, int, int]:
    """(n_pods, n_clusters_total, users_per_cluster) for a production
    mesh (axes "data", optionally "pod") or a refined one ("pod",
    "cluster", "user"): a `DeviceMesh` or a shape mapping."""
    sh = mesh_axes(mesh)
    n_pod = sh.get("pod", 1)
    if "cluster" in sh:
        return n_pod, n_pod * sh["cluster"], sh["user"]
    return n_pod, n_pod * (sh["data"] // users_per_cluster), users_per_cluster
