"""Span similarity strategies -> index selection.

Reference: vectorian/sim/span.py — OptimizedSpanSim (token sim + Optimizer ->
BruteForceIndex; default LocalAlignment with zero gap cost, sim/span.py:28-32;
optional tag_weights -> tag-weighted alignment :53-71) and EmbeddedSpanSim
(span embedding + vector sim -> encoder index :74-88; the reference uses Faiss
for cosine — here the GEMM top-k index covers both).
"""

from __future__ import annotations

from typing import Dict, Optional

from vectorian_tpu_torch.alignment import LocalAlignment, Optimizer
from vectorian_tpu_torch.sim.token import TokenSim
from vectorian_tpu_torch.sim.vector import CosineSim, VectorSim


class SpanSim:
    """A strategy to compute similarity between two token spans."""

    def create_index(self, partition, **kwargs):
        raise NotImplementedError()

    def to_args(self, index):
        raise NotImplementedError()


class OptimizedSpanSim(SpanSim):
    """Span similarity via an optimization (alignment or transport) over
    token similarities — the brute-force path."""

    def __init__(
        self,
        token_sim: TokenSim,
        optimizer: Optional[Optimizer] = None,
        tag_weights: Optional[Dict[str, float]] = None,
        **kwargs,
    ):
        if optimizer is None:
            optimizer = LocalAlignment()
        self._token_sim = token_sim
        self._optimizer = optimizer
        self._tag_weights = tag_weights
        self._options = kwargs

    @property
    def token_sim(self):
        return self._token_sim

    @property
    def optimizer(self):
        return self._optimizer

    @property
    def tag_weights(self):
        return self._tag_weights

    def create_index(self, partition, **kwargs):
        from vectorian_tpu_torch.index import BruteForceIndex

        return BruteForceIndex(partition, self, **kwargs)

    def to_args(self, index):
        args = {
            "metric": {
                "name": self._token_sim.name,
                "token_sim": self._token_sim,
            },
            "alignment": self._optimizer.to_args(index.partition),
        }
        if self._tag_weights:
            args["tag_weights"] = dict(self._tag_weights)
            args["alignment"]["mode"] = "tag-weighted"
        else:
            args["alignment"]["mode"] = "isolated"
        args.update(self._options)
        return args


class EmbeddedSpanSim(SpanSim):
    """Span similarity via whole-span embedding vectors — no alignment;
    top-k by one GEMM (replaces the reference's Faiss/numpy scan paths,
    index.py:679-767)."""

    def __init__(self, span_embedding, vector_sim: Optional[VectorSim] = None):
        self._span_embedding = span_embedding
        self._vector_sim = vector_sim or CosineSim()

    @property
    def embedding(self):
        return self._span_embedding

    @property
    def vector_sim(self):
        return self._vector_sim

    def create_index(self, partition, approximate=None, **kwargs):
        """Default: exact GEMM top-k.  ``approximate={"nlist": .., "nprobe"
        : ..}`` selects the IVF-style shortlist index for very large span
        sets (the reference's Faiss factory option, index.py:753-765 —
        approximate recall, documented on ApproximateSpanIndex)."""
        from vectorian_tpu_torch.index import ApproximateSpanIndex, SpanEncoderIndex

        if approximate is not None:
            return ApproximateSpanIndex(
                partition, self, **{**approximate, **kwargs}
            )
        return SpanEncoderIndex(partition, self, **kwargs)

    def to_args(self, index):
        return None
