"""The port's checkpoint store (`repro_torch.checkpoint.store`), held to
the contract tests/test_checkpoint.py pins for the JAX package's:

1. the leaf zoo of a round state (float32/float64/int64 arrays, bool
   masks, uint32 PRNG words, an int32 scalar, torch tensors) round-trips
   bit for bit with its dtype and shape;
2. every mismatch on load (dtype, shape, structure, leaf count) raises
   instead of casting;
3. `save` is atomic: a failing `os.replace` leaves the previous file
   and no temp litter;
4. `save_step` and `latest` keep custom prefixes, numeric step order,
   the `keep` window, and skip non-numeric names.

Plus the port's own case: the PRNG keys, int64 words masked to 32 bits
on the torch side, stored as uint32 (the JAX package's key dtype) and
restored exactly.
"""
import os

import jax
import numpy as np
import pytest
import torch

from repro_torch import prng
from repro_torch.checkpoint import latest, load, read_meta, save, save_step


def _tree():
    return {
        "theta": {"w": np.arange(12, dtype=np.float32).reshape(3, 4),
                  "b": np.linspace(-1, 1, 4).astype(np.float64)},
        "opt": [np.full((2, 2), 7, dtype=np.int64),
                np.array([True, False, True])],
        "key": np.asarray(jax.random.PRNGKey(3)),   # uint32 [2]
        "t": np.int32(5),
        "dev": torch.arange(6, dtype=torch.float32).reshape(2, 3),
    }


def _flat(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flat(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _flat(v)]
    return [tree]


def test_round_trip_bitwise_across_dtypes(tmp_path):
    tree = _tree()
    p = str(tmp_path / "ck.npz")
    save(p, tree)
    out = load(p, tree)
    assert sorted(out) == sorted(tree) and isinstance(out["opt"], list)
    for a, b in zip(_flat(out), _flat(tree)):
        b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    assert out["key"].dtype == np.uint32


def test_prng_keys_stored_as_uint32_restore_exactly(tmp_path):
    keys = torch.stack([prng.split(prng.PRNGKey(s, "cpu"))[1]
                        for s in range(4)])               # int64 words
    assert keys.dtype == torch.int64 and int(keys.max()) > 2 ** 31
    p = str(tmp_path / "keys.npz")
    save(p, {"keys": keys.numpy().astype(np.uint32)})
    out = load(p, {"keys": np.zeros((4, 2), np.uint32)})["keys"]
    assert out.dtype == np.uint32
    back = torch.as_tensor(out.astype(np.int64))
    assert torch.equal(back, keys)
    # the JAX package's words for the same seeds
    want = np.stack([np.asarray(jax.random.split(jax.random.PRNGKey(s))[1])
                     for s in range(4)])
    np.testing.assert_array_equal(out, want)


def test_meta_document_round_trips(tmp_path):
    p = str(tmp_path / "ck.npz")
    save(p, _tree(), meta={"round": 5, "loss": [0.125, 0.0625]})
    meta = read_meta(p)
    assert meta["n_leaves"] == len(_flat(_tree()))
    assert meta["extra"] == {"round": 5, "loss": [0.125, 0.0625]}


def test_load_raises_on_dtype_mismatch(tmp_path):
    tree = _tree()
    p = str(tmp_path / "ck.npz")
    save(p, tree)
    other = dict(tree, theta={"w": tree["theta"]["w"],
                              "b": tree["theta"]["b"].astype(np.float32)})
    with pytest.raises(ValueError, match="dtype"):
        load(p, other)
    with pytest.raises(ValueError, match="dtype"):
        load(p, dict(tree, dev=torch.zeros(2, 3, dtype=torch.float64)))


def test_load_raises_on_shape_mismatch(tmp_path):
    tree = _tree()
    p = str(tmp_path / "ck.npz")
    save(p, tree)
    other = dict(tree, theta={"w": np.zeros((4, 3), np.float32),
                              "b": tree["theta"]["b"]})
    with pytest.raises(ValueError, match="shape"):
        load(p, other)


def test_load_raises_on_treedef_mismatch(tmp_path):
    p = str(tmp_path / "ck.npz")
    save(p, {"a": np.zeros(2), "b": np.ones(3)})
    with pytest.raises(ValueError, match="treedef"):
        load(p, {"a": np.zeros(2), "c": np.ones(3)})
    with pytest.raises(ValueError, match="treedef"):
        load(p, [np.zeros(2), np.ones(3)])


def test_load_raises_on_leaf_count_mismatch(tmp_path):
    p = str(tmp_path / "ck.npz")
    save(p, {"a": np.zeros(2), "b": np.ones(3)})
    with pytest.raises(ValueError, match="leaves"):
        load(p, {"a": np.zeros(2)})


def test_atomic_save_survives_replace_failure(tmp_path, monkeypatch):
    p = str(tmp_path / "ck.npz")
    save(p, {"x": np.arange(4, dtype=np.float32)})

    def boom(src, dst):
        raise OSError("injected: disk full")

    monkeypatch.setattr(os, "replace", boom)
    with pytest.raises(OSError, match="disk full"):
        save(p, {"x": np.full(4, 9.0, np.float32)})
    monkeypatch.undo()
    out = load(p, {"x": np.zeros(4, np.float32)})
    np.testing.assert_array_equal(out["x"], np.arange(4, dtype=np.float32))
    assert [f for f in os.listdir(tmp_path) if f.endswith(".tmp")] == []


def test_latest_orders_steps_numerically(tmp_path):
    d = str(tmp_path)
    for step in (2, 10, 9):   # lexical order would pick "9"
        save(os.path.join(d, f"ckpt_{step}.npz"), {"s": np.int64(step)})
    assert latest(d).endswith("ckpt_10.npz")
    assert latest(str(tmp_path / "nope")) is None


def test_save_step_prunes_with_custom_prefix(tmp_path):
    d = str(tmp_path)
    for step in range(1, 6):
        save_step(d, step, {"s": np.int64(step)}, keep=2, prefix="ft_")
    kept = sorted(f for f in os.listdir(d) if f.endswith(".npz"))
    assert kept == ["ft_4.npz", "ft_5.npz"]
    save(os.path.join(d, "other_1.npz"), {"s": np.int64(0)})
    save_step(d, 6, {"s": np.int64(6)}, keep=2, prefix="ft_")
    assert os.path.exists(os.path.join(d, "other_1.npz"))
    assert latest(d, prefix="ft_").endswith("ft_6.npz")


def test_stray_non_numeric_checkpoints_are_skipped(tmp_path):
    d = str(tmp_path)
    save(os.path.join(d, "ckpt_best.npz"), {"s": np.int64(0)})
    save(os.path.join(d, "ckpt_best_7.npz"), {"s": np.int64(0)})
    assert latest(d) is None
    for step in (1, 2, 3):
        save_step(d, step, {"s": np.int64(step)}, keep=2)
    assert latest(d).endswith("ckpt_3.npz")
    kept = sorted(f for f in os.listdir(d) if f.endswith(".npz"))
    assert kept == ["ckpt_2.npz", "ckpt_3.npz", "ckpt_best.npz",
                    "ckpt_best_7.npz"]


@pytest.mark.parametrize("keep", [0, -2])
def test_save_step_rejects_keep_below_one(tmp_path, keep):
    with pytest.raises(ValueError, match="keep >= 1"):
        save_step(str(tmp_path), 1, {"s": np.int64(1)}, keep=keep)
