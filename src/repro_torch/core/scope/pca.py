"""PCA projection of hidden states (MegaScope Fig. 6 — token trajectories).

A copy of ``repro.core.scope.pca`` (numpy only); the port keeps its own, as
it imports nothing of the JAX package.
"""

from __future__ import annotations

import numpy as np


def pca_fit(x: np.ndarray, k: int = 2) -> dict:
    """x [n, d] -> components [k, d], mean [d], explained variance ratio."""
    x = np.asarray(x, np.float32)
    mu = x.mean(0)
    xc = x - mu
    _, s, vt = np.linalg.svd(xc, full_matrices=False)
    var = (s ** 2) / max(len(x) - 1, 1)
    return {
        "components": vt[:k],
        "mean": mu,
        "explained": (var[:k] / var.sum()).tolist() if var.sum() > 0 else [0.0] * k,
    }


def pca_project(x: np.ndarray, fit: dict) -> np.ndarray:
    return (np.asarray(x, np.float32) - fit["mean"]) @ fit["components"].T
