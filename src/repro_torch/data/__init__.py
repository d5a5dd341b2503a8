from repro_torch.data.datasets import (lm_corpus, synthetic_cifar,
                                      synthetic_mnist)
from repro_torch.data.partition import (
    PARTITIONERS, get_partitioner,
    partition_iid, partition_noniid_shards, partition_cluster_noniid,
)

__all__ = [
    "synthetic_mnist", "synthetic_cifar", "lm_corpus",
    "PARTITIONERS", "get_partitioner",
    "partition_iid", "partition_noniid_shards", "partition_cluster_noniid",
]
