"""Parameter trees: nested dicts of tensors, walked in sorted-key order.

This is the order `jax.tree` gives a dict, so flat vectors, optimizer
states and exported leaves line up with the JAX package's.
"""
from __future__ import annotations

from typing import Iterator, Tuple

import torch

Path = Tuple[str, ...]


def tree_leaves(tree, prefix: Path = ()
                ) -> Iterator[Tuple[Path, torch.Tensor]]:
    """(path, leaf) pairs of a nested dict, in sorted-key order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_leaves(tree[k], prefix + (k,))
    else:
        yield prefix, tree


def tree_map(fn, *trees):
    """Apply `fn` leafwise over nested dicts of identical structure."""
    if isinstance(trees[0], dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)
