"""Parameter trees: nested dicts (walked in sorted-key order) and lists
(walked in index order) of tensors.

This is the order `jax.tree` gives such a tree, so flat vectors,
optimizer states and exported leaves line up with the JAX package's.
A list stays a list: the CIFAR CNN keeps its convolutions as
``{"conv": [6 dicts], "fc_b", "fc_w"}``, as the JAX package does.
"""
from __future__ import annotations

from typing import Iterator, Tuple, Union

import torch

Path = Tuple[Union[str, int], ...]


def tree_leaves(tree, prefix: Path = ()
                ) -> Iterator[Tuple[Path, torch.Tensor]]:
    """(path, leaf) pairs of a nested tree, dicts in sorted-key order and
    lists in index order (a list index enters the path as an int)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_leaves(tree[k], prefix + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from tree_leaves(v, prefix + (i,))
    else:
        yield prefix, tree


def tree_map(fn, *trees):
    """Apply `fn` leafwise over trees of identical structure (dicts and
    lists; a tuple comes back as a list)."""
    if isinstance(trees[0], dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    if isinstance(trees[0], (list, tuple)):
        return [tree_map(fn, *(t[i] for t in trees))
                for i in range(len(trees[0]))]
    return fn(*trees)


def tree_from_paths(items) -> Union[dict, list]:
    """Rebuild a tree from (path, leaf) pairs: a node whose keys are
    ints becomes a list in index order, any other a dict."""
    root: dict = {}
    for path, leaf in items:
        node = root
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf

    def build(node):
        if not isinstance(node, dict):
            return node
        if node and all(isinstance(k, int) for k in node):
            return [build(node[i]) for i in range(len(node))]
        return {k: build(v) for k, v in node.items()}

    return build(root)
