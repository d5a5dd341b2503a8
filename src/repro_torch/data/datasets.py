"""Offline synthetic datasets.

No network access in this environment, so MNIST/CIFAR-10 are replaced by
deterministic synthetic classification tasks of identical shapes
(28x28x1 / 32x32x3, 10 classes).  Each class has a smooth random
template; samples are template + structured distortion + pixel noise, so
the tasks are learnable but not trivial — adequate for reproducing the
paper's *relative* claims (W-HFL vs conventional FL vs error-free).
"""
from __future__ import annotations

from typing import Tuple

import numpy as np


def _smooth(rng, shape, passes: int = 3):
    x = rng.standard_normal(shape).astype(np.float32)
    for _ in range(passes):  # cheap separable blur
        x = 0.25 * (np.roll(x, 1, 0) + np.roll(x, -1, 0)
                    + np.roll(x, 1, 1) + np.roll(x, -1, 1))
    return x


def _make(template_seed: int, sample_seed: int, n: int, h: int, w: int,
          c: int, n_classes: int = 10, noise: float = 0.35,
          max_shift: int = 2) -> Tuple[np.ndarray, np.ndarray]:
    """Templates depend only on `template_seed` (shared between train and
    test splits); sample draws depend on `sample_seed`."""
    trng = np.random.default_rng(template_seed)
    templates = np.stack([_smooth(trng, (h, w, c)) for _ in range(n_classes)])
    templates /= np.abs(templates).max(axis=(1, 2, 3), keepdims=True)
    rng = np.random.default_rng(sample_seed)
    y = rng.integers(0, n_classes, n).astype(np.int32)
    # per-sample distortion: random shift + scale of the template
    shifts = rng.integers(-max_shift, max_shift + 1, (n, 2))
    scales = rng.uniform(0.7, 1.3, n).astype(np.float32)
    x = np.empty((n, h, w, c), np.float32)
    for i in range(n):
        t = templates[y[i]]
        t = np.roll(t, shifts[i], axis=(0, 1))
        x[i] = scales[i] * t
    x += noise * rng.standard_normal(x.shape).astype(np.float32)
    return x, y


def synthetic_mnist(seed: int = 0, n_train: int = 20000, n_test: int = 4000):
    xtr, ytr = _make(seed, seed + 1, n_train, 28, 28, 1)
    xte, yte = _make(seed, seed + 1_000_003, n_test, 28, 28, 1)
    # flatten for the paper's single-layer model
    return (xtr.reshape(n_train, 784), ytr), (xte.reshape(n_test, 784), yte)


def synthetic_cifar(seed: int = 0, n_train: int = 20000, n_test: int = 4000):
    xtr, ytr = _make(seed + 7, seed + 8, n_train, 32, 32, 3, noise=0.45)
    xte, yte = _make(seed + 7, seed + 1_000_011, n_test, 32, 32, 3,
                     noise=0.45)
    return (xtr, ytr), (xte, yte)

