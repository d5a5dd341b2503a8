"""Federated dataset partitioners (paper §V data distributions).

- iid: training data randomly & equally distributed across MUs.
- non-iid shards: data split into 3*M*C same-label groups; each MU gets
  3 random groups (paper's first non-iid case).
- cluster non-iid: labels distributed so cluster pairs share 6 labels;
  assigned labels spread randomly across the MUs of each cluster
  (paper's second non-iid case).

All partitioners return arrays shaped [C, M, n_per_user, ...] so the
trainer can vmap over (cluster, user).
"""
from __future__ import annotations

import numpy as np


def _stack_users(xs, ys, C: int, M: int):
    n = min(len(x) for x in xs)
    X = np.stack([x[:n] for x in xs]).reshape(C, M, n, *xs[0].shape[1:])
    Y = np.stack([y[:n] for y in ys]).reshape(C, M, n)
    return X, Y


def partition_iid(seed: int, X: np.ndarray, Y: np.ndarray, C: int, M: int):
    rng = np.random.default_rng(seed)
    idx = rng.permutation(len(X))
    parts = np.array_split(idx, C * M)
    return _stack_users([X[p] for p in parts], [Y[p] for p in parts], C, M)


def partition_noniid_shards(seed: int, X: np.ndarray, Y: np.ndarray,
                            C: int, M: int, shards_per_user: int = 3):
    rng = np.random.default_rng(seed)
    n_shards = shards_per_user * C * M
    order = np.argsort(Y, kind="stable")  # group identical labels
    shards = np.array_split(order, n_shards)
    assign = rng.permutation(n_shards).reshape(C * M, shards_per_user)
    xs, ys = [], []
    for u in range(C * M):
        pick = np.concatenate([shards[s] for s in assign[u]])
        pick = pick[rng.permutation(len(pick))]
        xs.append(X[pick])
        ys.append(Y[pick])
    return _stack_users(xs, ys, C, M)


def partition_cluster_noniid(seed: int, X: np.ndarray, Y: np.ndarray,
                             C: int, M: int, labels_per_cluster: int = 8,
                             n_classes: int = 10):
    """Each cluster sees a subset of labels; consecutive cluster pairs
    share `2*labels_per_cluster - n_classes - ...` labels — with the
    paper's numbers (10 classes, 8 labels/cluster, offset 2) every
    cluster pair shares 6 labels."""
    rng = np.random.default_rng(seed)
    offset = (n_classes - labels_per_cluster) if C > 1 else 0
    cluster_labels = [
        [(c * offset + j) % n_classes for j in range(labels_per_cluster)]
        for c in range(C)]
    by_label = {l: np.flatnonzero(Y == l) for l in range(n_classes)}
    for l in by_label:
        by_label[l] = by_label[l][rng.permutation(len(by_label[l]))]
    # how many clusters use each label -> split its pool
    usage = {l: 0 for l in range(n_classes)}
    for labs in cluster_labels:
        for l in labs:
            usage[l] += 1
    pools = {l: np.array_split(by_label[l], max(1, usage[l]))
             for l in range(n_classes)}
    taken = {l: 0 for l in range(n_classes)}
    xs, ys = [], []
    for c in range(C):
        pick = []
        for l in cluster_labels[c]:
            pick.append(pools[l][taken[l]])
            taken[l] += 1
        pick = np.concatenate(pick)
        pick = pick[rng.permutation(len(pick))]
        parts = np.array_split(pick, M)
        for p in parts:
            xs.append(X[p])
            ys.append(Y[p])
    return _stack_users(xs, ys, C, M)


# Canonical partitioner registry (paper §V names).  Scenario specs and
# the benchmark harness address partitioners through this table so a new
# data distribution is one entry + one function.
PARTITIONERS = {
    "iid": partition_iid,
    "noniid": partition_noniid_shards,
    "cluster-noniid": partition_cluster_noniid,
}


def get_partitioner(name: str):
    try:
        return PARTITIONERS[name]
    except KeyError:
        raise KeyError(f"unknown partition {name!r}; "
                       f"known: {sorted(PARTITIONERS)}") from None
