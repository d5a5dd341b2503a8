"""Move parameters and round state between the JAX package and the port.

The JAX package keeps parameters and round state as pytrees of arrays;
the port keeps nested dicts of tensors with the same leaf names.  These
helpers take the reference's trees as numpy arrays (``jax.device_get``
of them), so both packages can start from identical weights, and bring
the port's trees back for comparison.  uint32 words (PRNG keys) become
the port's int64 word tensors.
"""
from __future__ import annotations

import numpy as np
import torch


def _tensor(x, device=None) -> torch.Tensor:
    a = np.asarray(x)
    if a.dtype == np.uint32:
        a = a.astype(np.int64)
    return torch.tensor(a, device=device)


def params_from_jax(tree, device=None):
    """A nested dict of arrays (the reference's model parameters) ->
    the same dict of tensors on `device`."""
    if isinstance(tree, dict):
        return {k: params_from_jax(v, device) for k, v in tree.items()}
    return _tensor(tree, device)


def state_from_jax(state, device=None):
    """The reference's round state (`repro.core.whfl.init_round_state`
    layout, as numpy) -> the port's.  SGD's empty optimizer state (an
    empty tuple there) becomes an empty dict."""
    out = {}
    for k, v in state.items():
        if k == "opt" and isinstance(v, (tuple, list)) and not v:
            out[k] = {}
        else:
            out[k] = params_from_jax(v, device)
    return out


def to_numpy(tree):
    """A nested dict of tensors -> the same dict of numpy arrays."""
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    return tree.detach().cpu().numpy()
