# The paper's primary contribution: W-HFL — hierarchical over-the-air
# federated learning (OTA aggregation at both the cluster and global hop).
from repro_torch.core.topology import (Topology, random_topology,
                                       uniform_topology)
from repro_torch.core.channel import (ChannelBackend, OTAConfig, cluster_ota,
                                      conventional_ota, get_backend,
                                      global_ota, list_backends,
                                      register_backend, resolve_backend,
                                      vmap_seeds)
from repro_torch.core import aggregation, bound, whfl

__all__ = [
    "Topology",
    "random_topology",
    "uniform_topology",
    "OTAConfig",
    "ChannelBackend",
    "register_backend",
    "get_backend",
    "list_backends",
    "resolve_backend",
    "cluster_ota",
    "global_ota",
    "conventional_ota",
    "vmap_seeds",
    "aggregation",
    "bound",
    "whfl",
]
