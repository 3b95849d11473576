"""Pairwise vector similarity strategies (reference: vectorian/sim/vector.py).

Each ``VectorSim`` computes a full [n_a, n_b] similarity matrix in one
batched expression; the cosine path is a single f32 GEMM — the reference's
per-query ``np.linalg.multi_dot`` (sim/vector.py:78) plus its optional cupy
dispatch collapse into this.

These are also the plugin point for custom user metrics: subclass
``VectorSim`` and implement ``compute`` with torch ops on the tensors it is
given (replaces the reference's C++->python callback at
metric/static.cpp:42-55).  Exact f32 products rely on TF32 being off, which
the package sets at import.
"""

from __future__ import annotations

from typing import List

import torch

from vectorian_tpu_torch.sim.kernel import Kernel, UnaryOperator


def _f32(x, like=None) -> torch.Tensor:
    """``x`` as an f32 tensor (on ``like``'s device when given)."""
    device = like.device if isinstance(like, torch.Tensor) else None
    return torch.as_tensor(x, dtype=torch.float32, device=device)


class VectorSim:
    """A strategy computing a similarity matrix from two sets of vectors."""

    def __call__(self, a, b):
        return self.compute(a, b)

    @property
    def ident(self):
        """Stable hashable identity of the metric; parameterized metrics
        must extend this."""
        return (type(self).__name__,)

    def __hash__(self):
        return hash(self.ident)

    def __eq__(self, other):
        return type(other) is type(self) and other.ident == self.ident

    def compute(self, a, b):
        """Given vectors ``a`` ([n_a, d]) and ``b`` ([n_b, d]) as
        AbstractVectors, return sim [n_a, n_b]; 0 = dissimilar, 1 = identical.
        """
        raise NotImplementedError()

    @property
    def name(self) -> str:
        raise NotImplementedError()


class CosineSim(VectorSim):
    """Cosine of the angle between vectors — one f32 GEMM."""

    def compute(self, a, b):
        an = _f32(a.normalized)
        return an @ _f32(b.normalized, an).T

    @property
    def name(self):
        return "cosine"


class FuzzyJaccardSim(VectorSim):
    """sum(min(a,b)) / sum(max(a,b)) (reference sim/vector.py:85-95)."""

    def compute(self, a, b):
        av = _f32(a.unmodified)
        bv = _f32(b.unmodified, av)
        p = torch.minimum(av[:, None, :], bv[None, :, :]).sum(-1)
        q = torch.maximum(av[:, None, :], bv[None, :, :]).sum(-1)
        return p / torch.where(q == 0, torch.ones_like(q), q)

    @property
    def name(self):
        return "fuzzy-jaccard"


class ImprovedSqrtCosineSim(VectorSim):
    """Sohangir & Wang 2017; non-negativized like the reference
    (sim/vector.py:98-132): each component is split into a positive and a
    negated-positive channel before the sqrt-cosine."""

    @staticmethod
    def _to_non_negative(x):
        t = torch.repeat_interleave(x, 2, dim=-1)
        sign = torch.tensor([1.0, -1.0], dtype=x.dtype, device=x.device)
        return torch.clamp_min(t * sign.repeat(x.shape[-1]), 0.0)

    def compute(self, a, b):
        av = _f32(a.unmodified)
        a_pos = self._to_non_negative(av)
        b_pos = self._to_non_negative(_f32(b.unmodified, av))
        # sqrt(a_i * b_j) summed over dims == <sqrt(a), sqrt(b)> — a GEMM.
        num = torch.sqrt(a_pos) @ torch.sqrt(b_pos).T
        x = torch.sqrt(a_pos.sum(-1))
        y = torch.sqrt(b_pos.sum(-1))
        denom = x[:, None] * y[None, :]
        safe = torch.where(denom == 0, torch.ones_like(denom), denom)
        return torch.where(denom > 0, num / safe, torch.zeros_like(num))

    @property
    def name(self):
        return "improved-sqrt-cosine"


class PNormDistance(VectorSim):
    """p-norm distance; combine with DistanceToSimilarity to get a
    similarity (reference sim/vector.py:135-160)."""

    def __init__(self, p: float = 2):
        self._p = p

    @property
    def ident(self):
        return (type(self).__name__, self._p)

    def compute(self, a, b):
        av = _f32(a.unmodified)
        bv = _f32(b.unmodified, av)
        if self._p == 2:
            # ||a-b||^2 = ||a||^2 + ||b||^2 - 2 a.b — GEMM form
            sq = (
                (av * av).sum(-1)[:, None]
                + (bv * bv).sum(-1)[None, :]
                - 2.0 * (av @ bv.T)
            )
            return torch.sqrt(torch.clamp_min(sq, 0.0))
        d = av[:, None, :] - bv[None, :, :]
        d = torch.pow(torch.abs(d), self._p).sum(-1)
        return torch.pow(d, 1.0 / self._p)

    @property
    def name(self):
        return f"p-norm({self._p})"


class EuclideanDistance(PNormDistance):
    def __init__(self):
        super().__init__(p=2)


class DirectionalDistance(VectorSim):
    """Projection of difference vectors onto a direction (reference
    sim/vector.py:170-177)."""

    def __init__(self, dir):
        import numpy as np

        self._dir = np.asarray(dir, np.float32)

    @property
    def ident(self):
        return (type(self).__name__, self._dir.tobytes())

    def compute(self, a, b):
        av = _f32(a.unmodified)
        d = av[:, None, :] - _f32(b.unmodified, av)[None, :, :]
        direction = _f32(self._dir, av).reshape(-1, d.shape[-1])
        return torch.einsum("abd,kd->ab", d, direction)

    @property
    def name(self):
        return "directional"


class LoggingSimilarity(VectorSim):
    """Records every (a, b) pair fed to the wrapped metric (reference
    sim/vector.py:48-60) — debugging/tracing aid."""

    def __init__(self, path, base):
        self._path = path
        self._base = base

    @property
    def ident(self):
        return (type(self).__name__, str(self._path), self._base.ident)

    def compute(self, a, b):
        import json

        with open(self._path, "a") as f:
            f.write(
                json.dumps(
                    {
                        "a": _f32(a.unmodified).cpu().tolist(),
                        "b": _f32(b.unmodified).cpu().tolist(),
                    }
                )
                + "\n"
            )
        return self._base(a, b)

    @property
    def name(self):
        return self._base.name


class ModifiedVectorSim(VectorSim):
    """VectorSim whose output is post-processed by unary operators."""

    def __init__(self, source: VectorSim, *operators: List[UnaryOperator]):
        self._source = source
        self._kernel = Kernel(operators)

    @property
    def ident(self):
        return (type(self).__name__, self._source.ident, self._kernel.ident)

    def compute(self, a, b):
        return self._kernel(self._source(a, b))

    @property
    def name(self):
        return self._kernel.name(self._source.name)
