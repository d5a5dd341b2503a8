"""Move parameters and round state between the JAX package and the port.

The JAX package keeps parameters and round state as pytrees of arrays;
the port keeps nested dicts (and lists, where the reference has lists)
of tensors with the same leaf names.  These
helpers take the reference's trees as numpy arrays (``jax.device_get``
of them), so both packages can start from identical weights, and bring
the port's trees back for comparison.  uint32 words (PRNG keys) become
the port's int64 word tensors; bfloat16 arrays (numpy's `ml_dtypes`
type, which `torch.tensor` refuses) become bfloat16 tensors with the
same bits, and come back as float32 arrays (numpy has no bfloat16 of
its own).
"""
from __future__ import annotations

import numpy as np
import torch


def _tensor(x, device=None) -> torch.Tensor:
    a = np.asarray(x)
    if a.dtype == np.uint32:
        a = a.astype(np.int64)
    if a.dtype.name == "bfloat16":        # exact both ways
        return torch.tensor(a.astype(np.float32), device=device).to(
            torch.bfloat16)
    return torch.tensor(a, device=device)


def params_from_jax(tree, device=None):
    """A nested dict or list of arrays (the reference's model
    parameters) -> the same tree of tensors on `device`."""
    if isinstance(tree, dict):
        return {k: params_from_jax(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_from_jax(v, device) for v in tree]
    return _tensor(tree, device)


def state_from_jax(state, device=None, *, specs=None, mesh=None):
    """The reference's round state (`repro.core.whfl.init_round_state`
    layout, or a train state, as numpy) -> the port's.  SGD's empty
    optimizer state (an empty tuple there) becomes an empty dict.  With
    `specs` (the state's spec tree, e.g. `launch.train.state_specs`) and
    the rank's `DeviceMesh`, this rank's shards of it."""
    out = {}
    for k, v in state.items():
        if k == "opt" and isinstance(v, (tuple, list)) and not v:
            out[k] = {}
        elif specs is None:
            out[k] = params_from_jax(v, device)
        else:
            out[k] = _shards(v, specs[k], mesh, device)
    return out


def _shards(tree, specs, mesh, device):
    from repro_torch.sharding import axes_bound, shard_tree

    with axes_bound(mesh):
        cut = shard_tree(params_from_jax(tree), specs)
    return _map(lambda t: t.contiguous().to(device), cut)


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map(fn, v) for v in tree]
    return fn(tree)


def to_numpy(tree):
    """A nested dict or list of tensors -> the same tree of numpy
    arrays."""
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [to_numpy(v) for v in tree]
    t = tree.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
