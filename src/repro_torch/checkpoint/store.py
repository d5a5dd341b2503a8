"""Tree checkpoints in one .npz.

The port's copy of `repro.checkpoint.store`.  A tree is nested dicts
(walked in sorted-key order), lists and tuples (in index order) of
arrays -- numpy arrays, numpy scalars or torch tensors (copied to the
host) -- as `repro_torch.tree` walks them.  Its leaves go into one .npz; a JSON description of the tree
(its structure, leaf count, dtypes and shapes) goes beside them and is
checked on load: a checkpoint written for one state cannot load into
another, and dtype, shape, leaf-count and structure mismatches raise
instead of casting.

`save` is atomic (a tempfile in the target directory, then
`os.replace`), so a crash mid-write leaves the previous checkpoint or
none, never a torn file.  ``save(meta=...)`` attaches a JSON document
to the same .npz (`read_meta`); `repro_torch.ft.ckpt` keeps its resume
manifest there.
"""
from __future__ import annotations

import json
import os
import tempfile
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.tree import tree_leaves


def _host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _spec(leaf) -> Tuple[np.dtype, tuple]:
    """A leaf's numpy dtype and shape, without copying a tensor."""
    if isinstance(leaf, torch.Tensor):
        return (torch.empty((), dtype=leaf.dtype).numpy().dtype,
                tuple(leaf.shape))
    a = np.asarray(leaf)
    return a.dtype, a.shape


def _structure(tree) -> Any:
    """The tree's shape as JSON: a dict maps its sorted keys, a list or
    tuple its items, and a leaf is ``"*"``."""
    if isinstance(tree, dict):
        return {"dict": [[k, _structure(tree[k])] for k in sorted(tree)]}
    if isinstance(tree, (list, tuple)):
        return {type(tree).__name__: [_structure(v) for v in tree]}
    return "*"


def _leaves(tree) -> List:
    return [leaf for _, leaf in tree_leaves(tree)]


def _rebuild(struct, leaves) -> Any:
    if struct == "*":
        return next(leaves)
    (kind, items), = struct.items()
    if kind == "dict":
        return {k: _rebuild(s, leaves) for k, s in items}
    out = [_rebuild(s, leaves) for s in items]
    return tuple(out) if kind == "tuple" else out


def _flatten(tree) -> Tuple[Dict[str, np.ndarray], Any]:
    flat = {f"leaf_{i}": _host(leaf)
            for i, leaf in enumerate(_leaves(tree))}
    return flat, _structure(tree)


def save(path: str, tree, meta: Optional[Dict] = None) -> None:
    """Atomic save of a tree of arrays to `path` (.npz); `meta`, any
    JSON-serializable document, is stored beside the leaves."""
    flat, struct = _flatten(tree)
    doc = {"treedef": struct, "n_leaves": len(flat),
           "dtypes": [str(a.dtype) for a in flat.values()],
           "shapes": [list(a.shape) for a in flat.values()]}
    if meta is not None:
        doc["extra"] = meta
    d = os.path.dirname(path) or "."
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, __meta__=json.dumps(doc), **flat)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def read_meta(path: str) -> Dict:
    """The stored description (treedef, n_leaves, dtypes, shapes) and
    the caller's ``"extra"`` document when `save` got `meta=`."""
    with np.load(path, allow_pickle=False) as z:
        return json.loads(str(z["__meta__"]))


def load(path: str, like):
    """Load into the structure of `like` (a template tree of arrays or
    tensors), as numpy arrays.  The stored structure, leaf count and
    each leaf's dtype and shape must match the template's exactly, or
    `ValueError` is raised."""
    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(str(z["__meta__"]))
        n = meta["n_leaves"]
        if len(z.files) - 1 != n:
            raise ValueError(
                f"corrupt checkpoint {path!r}: metadata claims {n} "
                f"leaves, file holds {len(z.files) - 1}")
        leaves = [z[f"leaf_{i}"] for i in range(n)]
    template = _leaves(like)
    if n != len(template):
        raise ValueError(
            f"checkpoint has {n} leaves, template has {len(template)}")
    struct = _structure(like)
    if meta["treedef"] != json.loads(json.dumps(struct)):
        raise ValueError(
            f"checkpoint treedef mismatch:\n  stored:   "
            f"{meta['treedef']}\n  template: {struct}")
    for i, (leaf, t) in enumerate(zip(leaves, template)):
        dtype, shape = _spec(t)
        if leaf.dtype != dtype:
            raise ValueError(f"checkpoint leaf_{i} dtype {leaf.dtype} != "
                             f"template {dtype}")
        if tuple(leaf.shape) != tuple(shape):
            raise ValueError(
                f"checkpoint leaf_{i} shape {tuple(leaf.shape)} != "
                f"template {tuple(shape)}")
    return _rebuild(struct, iter(leaves))


def _step_candidates(dirpath: str, prefix: str) -> List[str]:
    """``<prefix><int>.npz`` files in `dirpath`.  A file whose stem after
    the prefix is not an integer (a hand-copied ``ckpt_best.npz``) is
    not a step checkpoint: skipped here, never pruned by `save_step`."""
    out = []
    for f in os.listdir(dirpath):
        if not (f.startswith(prefix) and f.endswith(".npz")):
            continue
        stem = f[len(prefix):-4]
        if stem.isdigit() or (stem.startswith("-") and stem[1:].isdigit()):
            out.append(f)
    return out


def latest(dirpath: str, prefix: str = "ckpt_") -> Optional[str]:
    if not os.path.isdir(dirpath):
        return None
    cands = _step_candidates(dirpath, prefix)
    if not cands:
        return None
    return os.path.join(
        dirpath, max(cands, key=lambda f: int(f[len(prefix):-4])))


def save_step(dirpath: str, step: int, tree, keep: int = 3,
              prefix: str = "ckpt_", meta: Optional[Dict] = None) -> str:
    """Save ``<prefix><step>.npz`` and prune the same prefix's older
    checkpoints (numeric step order), keeping the newest `keep` (>= 1)."""
    if keep < 1:
        raise ValueError(f"save_step needs keep >= 1, got {keep}")
    path = os.path.join(dirpath, f"{prefix}{step}.npz")
    save(path, tree, meta=meta)
    cands = sorted(_step_candidates(dirpath, prefix),
                   key=lambda f: int(f[len(prefix):-4]))
    for f in cands[:-keep]:
        os.unlink(os.path.join(dirpath, f))
    return path
