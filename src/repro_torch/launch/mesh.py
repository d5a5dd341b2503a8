"""The W-HFL reading of a device mesh's shape (the port of
`repro.launch.mesh`'s shape arithmetic).

The JAX package maps every (pod, cluster, user) coordinate of its
production mesh to one mobile user, refining the ``data`` axis into
(cluster, user).  The port trains on one card, so a mesh here is only
its shape: a mapping of axis names to sizes, e.g. ``{"data": 4,
"model": 2}`` or ``{"pod": 2, "data": 16, "model": 16}``, from which
`mesh_counts` derives the (n_pods, n_clusters, users_per_cluster) the
train step runs.  `refine_mesh` and `make_production_mesh`, which build
device meshes, wait for several cards (ROADMAP queue A item 11).
"""
from __future__ import annotations

from typing import Mapping, Tuple


def mesh_counts(mesh: Mapping[str, int],
                users_per_cluster: int = 4) -> Tuple[int, int, int]:
    """(n_pods, n_clusters_total, users_per_cluster) for a production
    mesh shape (axes "data", optionally "pod") or a refined one ("pod",
    "cluster", "user")."""
    sh = dict(mesh)
    n_pod = sh.get("pod", 1)
    if "cluster" in sh:
        return n_pod, n_pod * sh["cluster"], sh["user"]
    return n_pod, n_pod * (sh["data"] // users_per_cluster), users_per_cluster
