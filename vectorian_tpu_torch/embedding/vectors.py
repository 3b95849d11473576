"""Uniform vector containers (reference: vectorian/embedding/vectors.py).

A ``Vectors`` object exposes three views used throughout the engine:
``unmodified`` (raw), ``normalized`` (L2, eps-guarded — reference
vectors.py:71-80) and ``magnitudes`` (L2 norms, vectors.py:82-86).  All views
are numpy arrays that metric computation uploads as torch tensors;
persistence is handled by the corpus layer (h5).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

EPS = 1e-9


class AbstractVectors:
    @property
    def size(self) -> int:
        raise NotImplementedError()

    @property
    def unmodified(self):
        raise NotImplementedError()

    @property
    def normalized(self):
        raise NotImplementedError()

    @property
    def magnitudes(self):
        raise NotImplementedError()

    def transform(self, vectors: "Vectors") -> "Vectors":
        """Identity by default; PCA-compressed embeddings override."""
        return vectors


class Vectors(AbstractVectors):
    def __init__(self, unmodified: np.ndarray):
        self._unmodified = np.asarray(unmodified)
        self._normalized: Optional[np.ndarray] = None
        self._magnitudes: Optional[np.ndarray] = None

    @property
    def shape(self):
        return self._unmodified.shape

    @property
    def size(self):
        return self._unmodified.shape[0]

    @property
    def unmodified(self):
        return self._unmodified

    @property
    def magnitudes(self):
        if self._magnitudes is None:
            self._magnitudes = np.linalg.norm(self._unmodified, axis=-1)
        return self._magnitudes

    @property
    def normalized(self):
        if self._normalized is None:
            m = np.maximum(self.magnitudes, EPS)
            self._normalized = (self._unmodified / m[..., None]).astype(
                self._unmodified.dtype
            )
        return self._normalized

    def save(self, grp):
        """Persist all three datasets (reference vectors.py save:22-27)."""
        grp.create_dataset("unmodified", data=self.unmodified)
        grp.create_dataset("normalized", data=self.normalized)
        grp.create_dataset("magnitudes", data=self.magnitudes)

    @staticmethod
    def load(grp) -> "Vectors":
        v = Vectors(np.asarray(grp["unmodified"]))
        v._normalized = np.asarray(grp["normalized"])
        v._magnitudes = np.asarray(grp["magnitudes"])
        return v


class TransformedVectors(AbstractVectors):
    """Vectors with a replayable linear transform (PCA) applied.

    The reference serializes the sklearn PCA to ONNX so it can be replayed on
    query vectors (vectorian/embedding/vectors.py:89-129,
    embedding/transform.py:23-36); here the transform is a plain
    (mean, components) pair applied with one GEMM — replayable, serializable,
    and TPU-friendly.
    """

    def __init__(self, vectors: Vectors, tfm):
        self._v = vectors
        self._tfm = tfm

    @property
    def size(self):
        return self._v.size

    @property
    def unmodified(self):
        return self._v.unmodified

    @property
    def normalized(self):
        return self._v.normalized

    @property
    def magnitudes(self):
        return self._v.magnitudes

    def transform(self, vectors: Vectors) -> Vectors:
        return Vectors(self._tfm.apply(vectors.unmodified))


class MaskedVectors(AbstractVectors):
    def __init__(self, vectors: AbstractVectors, mask: np.ndarray):
        self._v = vectors
        self._mask = np.asarray(mask)

    @property
    def size(self):
        return int(self._mask.sum())

    @property
    def unmodified(self):
        return self._v.unmodified[self._mask]

    @property
    def normalized(self):
        return self._v.normalized[self._mask]

    @property
    def magnitudes(self):
        return self._v.magnitudes[self._mask]


class OpenedVectorsCache:
    """LRU cache of open h5 file handles for lazy vector references
    (reference OpenedVectorsCache, embedding/vectors.py:295-309)."""

    def __init__(self, maxsize: int = 8):
        self._maxsize = maxsize
        self._open: "OrderedDict" = __import__("collections").OrderedDict()

    def open(self, path: str):
        import h5py

        f = self._open.get(path)
        if f is not None and f.id.valid:
            self._open.move_to_end(path)
            return f
        f = h5py.File(path, "r")
        self._open[path] = f
        while len(self._open) > self._maxsize:
            _, old = self._open.popitem(last=False)
            try:
                old.close()
            except Exception:
                pass
        return f

    def close_all(self):
        for f in self._open.values():
            try:
                f.close()
            except Exception:
                pass
        self._open.clear()


_OPENED = OpenedVectorsCache()


class ExternalMemoryVectors:
    """A lazy h5-backed vector matrix (reference ExternalMemoryVectors +
    VectorsRef family, embedding/vectors.py:245-366): shape comes from h5
    metadata; data is read only on first access — session construction over
    a large stored corpus never touches contextual vector bytes."""

    def __init__(self, path: str, dataset: str):
        self._path = str(path)
        self._dataset = dataset
        self._data: Optional[np.ndarray] = None

    @property
    def shape(self):
        if self._data is not None:
            return self._data.shape
        return tuple(_OPENED.open(self._path)[self._dataset].shape)

    def __len__(self):
        return int(self.shape[0])

    def load(self) -> np.ndarray:
        if self._data is None:
            self._data = np.asarray(
                _OPENED.open(self._path)[self._dataset], np.float32
            )
        return self._data

    def __array__(self, dtype=None, copy=None):
        a = self.load()
        return a.astype(dtype) if dtype is not None else a

    def __getitem__(self, key):
        return self.load()[key]


class LazyVectors:
    """A row-subset view over a (possibly lazy) vector source, materialized
    on first data access — PreparedDocument keeps these so that binding a
    stored corpus to a session stays metadata-only."""

    def __init__(self, source, keep: np.ndarray):
        self._source = source
        self._keep = np.asarray(keep)
        self._data: Optional[np.ndarray] = None

    @property
    def shape(self):
        if self._data is not None:
            return self._data.shape
        src_shape = (
            self._source.shape
            if hasattr(self._source, "shape")
            else np.asarray(self._source).shape
        )
        return (int(self._keep.shape[0]),) + tuple(src_shape[1:])

    def __len__(self):
        return int(self._keep.shape[0])

    def materialize(self) -> np.ndarray:
        if self._data is None:
            self._data = np.asarray(self._source, np.float32)[self._keep]
        return self._data

    def __array__(self, dtype=None, copy=None):
        a = self.materialize()
        return a.astype(dtype) if dtype is not None else a

    def __getitem__(self, key):
        return self.materialize()[key]


class StackedVectors(AbstractVectors):
    """Horizontal stack over multiple embeddings (reference vectors.py:164)."""

    def __init__(self, vectors: Sequence[AbstractVectors]):
        self._vs = list(vectors)

    @property
    def size(self):
        return self._vs[0].size

    @property
    def unmodified(self):
        return np.hstack([v.unmodified for v in self._vs])

    @property
    def normalized(self):
        u = self.unmodified
        m = np.maximum(np.linalg.norm(u, axis=-1, keepdims=True), EPS)
        return u / m

    @property
    def magnitudes(self):
        return np.linalg.norm(self.unmodified, axis=-1)
