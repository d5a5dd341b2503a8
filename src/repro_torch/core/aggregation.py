"""Parameter-tree <-> flat-vector plumbing and power accounting for OTA hops.

The OTA channel operates on flat R^{2N} vectors (eq. 7 packing).  These
helpers ravel a model's parameter tree (nested dicts and lists of
tensors) into a padded even-length vector and account transmit power the way the paper
reports it (average per-symbol power at the edge).

Leaf order is `jax.tree.flatten`'s: dicts in sorted-key order, lists in
index order.  The MNIST vector is ``b`` (10) then ``w`` (7840); the
CIFAR CNN's is ``conv[0].b``, ``conv[0].bn_bias``, ``conv[0].bn_scale``,
``conv[0].w``, ``conv[1].b``, ..., then ``fc_b`` and ``fc_w`` (308,394
values), exactly as in the JAX package, so every OTA estimate lands on
the same parameters.
Every function takes leaves with any leading batch dims (``[C, M, ...]``
for per-user trees) in place of `vmap`.

Partial participation adds the per-user precode (`cotaf_precode`), the
attendance rescale of the mean fold (`attendance_rescale`) and the
robust cluster folds over per-user receptions (`masked_median`,
`masked_trimmed_mean`), with the JAX package's semantics.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

from repro_torch.tree import Path, tree_from_paths, tree_leaves


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


def unflatten(spec: FlatSpec, vec: torch.Tensor):
    """[*lead, 2N] -> tree with leaves [*lead, *shape] (padding dropped);
    lists come back where the spec's tree has them."""
    lead = vec.shape[:-1]
    items = []
    off = 0
    for path, shape, size, dt in zip(spec.paths, spec.shapes, spec.sizes,
                                     spec.dtypes):
        items.append((path, vec[..., off:off + size].reshape(
            *lead, *shape).to(dt)))
        off += size
    return tree_from_paths(items)


def user_energy(flat: torch.Tensor) -> torch.Tensor:
    """Per-transmission symbol energy ``sum(flat^2)`` over the last axis
    ([..., 2N] -> [...])."""
    return torch.sum(torch.square(flat), dim=-1)


def symbol_power_from_energy(pw: torch.Tensor, P, n: int) -> torch.Tensor:
    """Fold per-transmission energies into the paper's reported average
    per-symbol power ``mean(P^2 * pw / n)``.  P is a float32 scalar
    tensor, as it enters the reference's jitted round."""
    return torch.mean((P ** 2) * pw / n)


# ---------------------------------------------------------------------------
# partial participation: COTAF-style precoding + attendance rescale
# ---------------------------------------------------------------------------

def cotaf_precode(flat: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Per-user transmit precoding: ``flat [..., C, M, 2N] * scale
    [..., C, M]`` over the symbol axis.  A sampled-out user or a free
    rider gets scale 0 (a sampled-out user is exactly an inactive pad
    slot), a byzantine one ``-byzantine_scale``, an honest one 1.  The
    round precodes before any hop and before the power fold."""
    return flat * scale[..., None]


def attendance_rescale(weights: torch.Tensor, claimed: torch.Tensor,
                       dim: int = -1) -> torch.Tensor:
    """The per-cluster correction ``full_sum / claimed_sum`` of the
    receive weights under partial attendance (COTAF, Sery et al.): the
    OTA folds normalize by the full weight sum, so with only the
    `claimed` users transmitting the estimate is rescaled to their
    weighted mean.  Exactly 1.0 at full attendance, and 0 where nobody
    claimed, so an empty cluster adds no update rather than amplified
    noise.

    weights: static receive weights on `claimed`'s device, e.g. the
    own-cluster gains ``beta_own [C, M]`` (ones for the ideal mean);
    claimed: {0, 1} mask of the same shape."""
    full = torch.sum(weights, dim=dim)
    got = torch.sum(weights * claimed, dim=dim)
    pos = got > 0
    return torch.where(pos, full / torch.where(pos, got, 1.0), 0.0)


# ---------------------------------------------------------------------------
# robust cluster folds (masked coordinate statistics, as in COMED)
# ---------------------------------------------------------------------------

def _claimed_sorted(x: torch.Tensor, mask: torch.Tensor):
    """Every cluster's users sorted per coordinate, the unclaimed ones
    to the +inf tail, and the claimed count n [C] (int32)."""
    xs = torch.sort(torch.where(mask[..., None] > 0, x, math.inf),
                    dim=1).values
    return xs, torch.sum(mask > 0, dim=1).to(torch.int32)


def masked_median(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Coordinate-wise median over the claimed users of each cluster.

    x: per-user estimates ``[C, M, 2N]``; mask: {0, 1} ``[C, M]``.  The
    median's ranks ``(n-1)//2`` and ``n//2`` follow the realized count
    n; a cluster with no claimed user returns 0 (no update)."""
    xs, n = _claimed_sorted(x, mask)
    lo = torch.clamp_min((n - 1) // 2, 0)
    hi = n // 2

    def take(idx):
        return torch.take_along_dim(xs, idx.long()[:, None, None],
                                    dim=1)[:, 0]

    med = 0.5 * (take(lo) + take(hi))
    return torch.where((n > 0)[:, None], med, 0.0)


def masked_trimmed_mean(x: torch.Tensor, mask: torch.Tensor,
                        trim: float = 0.25) -> torch.Tensor:
    """Coordinate-wise trimmed mean over the claimed users of each
    cluster: per coordinate, drop the ``floor(trim * n)`` smallest and
    largest claimed values and average the rest (``trim < 0.5``).  The
    trim count follows the realized count n; a cluster with no claimed
    user returns 0."""
    if not 0.0 <= trim < 0.5:
        raise ValueError(f"trim must be in [0, 0.5), got {trim}")
    M = x.shape[1]
    xs, n = _claimed_sorted(x, mask)
    n = n[:, None]                                              # [C, 1]
    k = torch.floor(float(np.float32(trim)) * n.to(torch.float32)).to(
        torch.int32)
    ranks = torch.arange(M, dtype=torch.int32, device=x.device)[None, :]
    keep = (ranks >= k) & (ranks < n - k)                       # [C, M]
    kept = torch.where(keep[..., None], xs, 0.0)
    cnt = torch.clamp_min(n - 2 * k, 1).to(torch.float32)
    return torch.where(n > 0, torch.sum(kept, dim=1) / cnt, 0.0)


def symbol_power(flat: torch.Tensor, P) -> torch.Tensor:
    """Average transmit power per complex symbol for one transmission of
    the packed vector `flat` ([..., 2N]) with power multiplier P:
    P^2 * sum(flat^2)/N, averaged over leading axes (users)."""
    return symbol_power_from_energy(user_energy(flat), P,
                                    flat.shape[-1] // 2)
