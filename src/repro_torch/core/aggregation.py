"""Parameter-tree <-> flat-vector plumbing and power accounting for OTA hops.

The OTA channel operates on flat R^{2N} vectors (eq. 7 packing).  These
helpers ravel a model's parameter tree (nested dicts of tensors) into a
padded even-length vector and account transmit power the way the paper
reports it (average per-symbol power at the edge).

Leaf order is sorted-key order, the order `jax.tree.flatten` gives a
dict: the MNIST vector is ``b`` (10) then ``w`` (7840), exactly as in
the JAX package, so every OTA estimate lands on the same parameters.
Every function takes leaves with any leading batch dims (``[C, M, ...]``
for per-user trees) in place of `vmap`.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

import torch

from repro_torch.tree import Path, tree_leaves


@dataclass(frozen=True)
class FlatSpec:
    paths: Tuple[Path, ...]
    shapes: Tuple[Tuple[int, ...], ...]
    sizes: Tuple[int, ...]
    dtypes: Tuple[torch.dtype, ...]
    two_n: int  # padded to even

    @property
    def n_params(self) -> int:
        return int(sum(self.sizes))


def make_flat_spec(tree) -> FlatSpec:
    leaves = list(tree_leaves(tree))
    shapes = tuple(tuple(x.shape) for _, x in leaves)
    sizes = tuple(x.numel() for _, x in leaves)
    total = int(sum(sizes))
    return FlatSpec(paths=tuple(p for p, _ in leaves), shapes=shapes,
                    sizes=sizes, dtypes=tuple(x.dtype for _, x in leaves),
                    two_n=total + (total % 2))


def flatten(spec: FlatSpec, tree) -> torch.Tensor:
    """tree (leaves [*lead, *shape]) -> [*lead, 2N] float32,
    zero-padded to even length."""
    leaves = [x for _, x in tree_leaves(tree)]
    lead = leaves[0].shape[:leaves[0].dim() - len(spec.shapes[0])]
    flat = torch.cat([x.reshape(*lead, -1).to(torch.float32)
                      for x in leaves], dim=-1)
    pad = spec.two_n - flat.shape[-1]
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad))
    return flat


def unflatten(spec: FlatSpec, vec: torch.Tensor) -> Dict:
    """[*lead, 2N] -> tree with leaves [*lead, *shape] (padding dropped)."""
    lead = vec.shape[:-1]
    out: Dict = {}
    off = 0
    for path, shape, size, dt in zip(spec.paths, spec.shapes, spec.sizes,
                                     spec.dtypes):
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = vec[..., off:off + size].reshape(
            *lead, *shape).to(dt)
        off += size
    return out


def user_energy(flat: torch.Tensor) -> torch.Tensor:
    """Per-transmission symbol energy ``sum(flat^2)`` over the last axis
    ([..., 2N] -> [...])."""
    return torch.sum(torch.square(flat), dim=-1)


def symbol_power_from_energy(pw: torch.Tensor, P, n: int) -> torch.Tensor:
    """Fold per-transmission energies into the paper's reported average
    per-symbol power ``mean(P^2 * pw / n)``.  P is a float32 scalar
    tensor, as it enters the reference's jitted round."""
    return torch.mean((P ** 2) * pw / n)


def symbol_power(flat: torch.Tensor, P) -> torch.Tensor:
    """Average transmit power per complex symbol for one transmission of
    the packed vector `flat` ([..., 2N]) with power multiplier P:
    P^2 * sum(flat^2)/N, averaged over leading axes (users)."""
    return symbol_power_from_energy(user_energy(flat), P,
                                    flat.shape[-1] // 2)
