"""Replayable vector-space transforms (PCA compression).

Reference: vectorian/embedding/transform.py — fits sklearn PCA once and
serializes it to ONNX so the *query-side* transform can be replayed
(PCACompression.apply:23-36).  Here the fitted transform is a plain
(mean, components) pair: one broadcast-subtract + one GEMM, trivially
replayable on TPU and serializable as two numpy arrays.
"""

from __future__ import annotations

import numpy as np


class Transform:
    @property
    def name(self):
        raise NotImplementedError()

    @property
    def ident(self):
        return self.name

    def fit(self, vectors: np.ndarray) -> "FittedTransform":
        raise NotImplementedError()


class FittedTransform:
    def apply(self, vectors: np.ndarray) -> np.ndarray:
        raise NotImplementedError()

    def save(self, grp):
        raise NotImplementedError()


class LinearProjection(FittedTransform):
    """y = (x - mean) @ components.T"""

    def __init__(self, mean: np.ndarray, components: np.ndarray):
        self.mean = np.asarray(mean, np.float32)
        self.components = np.asarray(components, np.float32)

    def apply(self, vectors: np.ndarray) -> np.ndarray:
        v = np.asarray(vectors, np.float32)
        return (v - self.mean[None, :]) @ self.components.T

    def save(self, grp):
        grp.create_dataset("mean", data=self.mean)
        grp.create_dataset("components", data=self.components)
        grp.attrs["kind"] = "linear-projection"

    @staticmethod
    def load(grp) -> "LinearProjection":
        return LinearProjection(np.asarray(grp["mean"]), np.asarray(grp["components"]))


class PCACompression(Transform):
    """PCA to n_dims (reference transform.py PCACompression)."""

    def __init__(self, n_dims: int):
        self._n_dims = n_dims

    @property
    def name(self):
        return f"pca-{self._n_dims}"

    @property
    def n_dims(self):
        return self._n_dims

    def fit(self, vectors: np.ndarray) -> LinearProjection:
        v = np.asarray(vectors, np.float64)
        mean = v.mean(axis=0)
        centered = v - mean
        # economy SVD; components = top right singular vectors
        _, _, vt = np.linalg.svd(centered, full_matrices=False)
        comps = vt[: self._n_dims]
        return LinearProjection(mean.astype(np.float32), comps.astype(np.float32))
