"""Synthetic classification datasets standing in for the paper's benchmarks
(numpy; a copy of ``repro.data.synthetic``, so the port needs nothing of the
JAX package).

Adult/Epsilon/SUSY/MNIST-8M/ImageNet are stood in for by scalable synthetic
families with comparable structure: non-linearly-separable binary problems
(checker, spirals) that exercise the RBF kernel, and a c-class problem with a
tunable class count that exercises OVO scaling like MNIST/ImageNet.  Sizes
are parameters, so n scales the way the paper's tables scale data sets.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np


def train_test_split(x, y, test_frac: float = 0.25, seed: int = 0):
    n = x.shape[0]
    perm = np.random.default_rng(seed).permutation(n)
    k = int(n * (1.0 - test_frac))
    tr, te = perm[:k], perm[k:]
    return x[tr], y[tr], x[te], y[te]


def make_blobs(n: int, p: int = 8, n_classes: int = 2, sep: float = 2.0,
               seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(n_classes, p)) * sep
    y = rng.integers(0, n_classes, size=n)
    x = centers[y] + rng.normal(size=(n, p))
    return x.astype(np.float32), y.astype(np.int64)


def make_checker(n: int, cells: int = 4, noise: float = 0.05,
                 seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """2-D checkerboard — classic RBF-SVM stress test (non-linear boundary)."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, cells, size=(n, 2))
    y = ((np.floor(x[:, 0]) + np.floor(x[:, 1])) % 2).astype(np.int64)
    x = x + rng.normal(scale=noise, size=x.shape)
    return x.astype(np.float32), y


def make_two_spirals(n: int, noise: float = 0.1,
                     seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    rng = np.random.default_rng(seed)
    m = n // 2
    t = np.sqrt(rng.uniform(0.05, 1.0, size=m)) * 3.0 * np.pi
    s1 = np.stack([t * np.cos(t), t * np.sin(t)], axis=1)
    s2 = -s1
    x = np.concatenate([s1, s2]) / (3.0 * np.pi)
    x = x + rng.normal(scale=noise, size=x.shape)
    y = np.concatenate([np.zeros(m), np.ones(n - m)]).astype(np.int64)
    perm = rng.permutation(n)
    return x[perm].astype(np.float32), y[perm]


def make_multiclass(n: int, p: int = 16, n_classes: int = 10, sep: float = 1.6,
                    within: float = 0.9, seed: int = 0):
    """c-class gaussian mixture with overlapping clusters (OVO benchmark)."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(n_classes, p)) * sep
    y = rng.integers(0, n_classes, size=n)
    # two sub-clusters per class -> non-linear class regions
    sub = rng.integers(0, 2, size=n)
    offs = rng.normal(size=(n_classes, 2, p)) * within
    x = centers[y] + offs[y, sub] + rng.normal(scale=0.7, size=(n, p))
    return x.astype(np.float32), y.astype(np.int64)
