"""Datasets of the ported slices: the SSGD reference task, synthetic
classification data, and PageRank's graphs.

Port of the parts of ``tpu_distalg/utils/datasets.py`` that SSGD and
PageRank use; the generators draw from the same numpy streams, so both
packages make the same arrays from a seed. The SSGD reference trains
on breast-cancer with a fixed 70/30 split and a ones column appended
(the model has D+1 weights). The machine with the
card has no scikit-learn, so the data ships with the package
(``data/breast_cancer.csv``, copied from scikit-learn, BSD-3; see
``data/breast_cancer.NOTICE``) and the split is reproduced with numpy
alone: ``train_test_split(test_size=0.3, random_state=0,
shuffle=True)`` permutes the rows with ``RandomState(0)`` and takes
the first 171 as the test set and the next 398 as the training set.
"""

from __future__ import annotations

import math
import os

import numpy as np

BREAST_CANCER_CSV = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "data",
    "breast_cancer.csv")


def load_breast_cancer() -> tuple[np.ndarray, np.ndarray]:
    """``(X (569, 30) float64, y (569,) int64)``, as scikit-learn's
    ``load_breast_cancer(return_X_y=True)``."""
    with open(BREAST_CANCER_CSV) as f:
        n, d = (int(v) for v in f.readline().split(",")[:2])
        raw = np.loadtxt(f, delimiter=",", dtype=np.float64)
    if raw.shape != (n, d + 1):
        raise ValueError(f"{BREAST_CANCER_CSV}: expected {n} rows of "
                         f"{d + 1} columns, got {raw.shape}")
    return raw[:, :d], raw[:, d].astype(np.int64)


def breast_cancer_split(test_size: float = 0.3, random_state: int = 0):
    """Breast-cancer 70/30 split with the bias column appended — the
    reference task. Returns ``(X_train1, y_train, X_test1, y_test)``,
    float32, equal to the JAX package's ``breast_cancer_split``."""
    X, y = load_breast_cancer()
    n = X.shape[0]
    n_test = math.ceil(test_size * n)
    perm = np.random.RandomState(random_state).permutation(n)
    test, train = perm[:n_test], perm[n_test:]
    return (add_bias_column(X[train]), y[train].astype(np.float32),
            add_bias_column(X[test]), y[test].astype(np.float32))


def add_bias_column(X: np.ndarray) -> np.ndarray:
    return np.concatenate(
        [X, np.ones((X.shape[0], 1))], axis=1).astype(np.float32)


def synthetic_two_class(n_rows: int, n_features: int = 30, seed: int = 0,
                        separation: float = 2.0):
    """Linearly-separable-ish two-class Gaussian data for LR benchmarks
    (numpy only: the same arrays as the JAX package's)."""
    rng = np.random.default_rng(seed)
    w_true = rng.normal(size=(n_features,))
    X = rng.normal(size=(n_rows, n_features)).astype(np.float32)
    logits = X @ w_true * separation / np.sqrt(n_features)
    y = (logits + rng.logistic(size=n_rows) > 0).astype(np.float32)
    return X, y


def erdos_renyi_edges(
    n_vertices: int, avg_degree: float = 8.0, seed: int = 0
) -> np.ndarray:
    """Uniform-random directed edge list (src, dst), shape (E, 2), no
    self-loops — the 1M-node PageRank benchmark graph (BASELINE.json)."""
    rng = np.random.default_rng(seed)
    n_edges = int(n_vertices * avg_degree)
    src = rng.integers(0, n_vertices, size=n_edges, dtype=np.int64)
    dst = rng.integers(0, n_vertices - 1, size=n_edges, dtype=np.int64)
    dst = np.where(dst >= src, dst + 1, dst)  # avoid self-loops
    return np.stack([src, dst], axis=1)


def toy_graph_edges() -> np.ndarray:
    """The reference's 4-edge toy graph (``pagerank.py:35-38``,
    ``transitive_closure.py:18``), 0-indexed."""
    return np.array([[0, 1], [0, 2], [1, 2], [2, 0]], dtype=np.int64)
