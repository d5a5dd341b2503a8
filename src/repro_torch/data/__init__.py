from repro_torch.data.datasets import synthetic_mnist, synthetic_cifar
from repro_torch.data.partition import (
    PARTITIONERS, get_partitioner,
    partition_iid, partition_noniid_shards, partition_cluster_noniid,
)

__all__ = [
    "synthetic_mnist", "synthetic_cifar",
    "PARTITIONERS", "get_partitioner",
    "partition_iid", "partition_noniid_shards", "partition_cluster_noniid",
]
