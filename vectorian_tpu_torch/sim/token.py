"""Token similarity specs binding an embedding to a vector metric.

Reference: vectorian/sim/token.py — there the spec compiles to a dict
consumed by the C++ ``create_strategy`` (query.cpp:156-218); here the spec
tree is evaluated directly by the similarity compiler
(vectorian_tpu_torch/ops/simmatrix.py) into batched torch computations.
"""

from __future__ import annotations

from vectorian_tpu_torch.sim.vector import CosineSim, VectorSim


class TokenSim:
    """Base class for token-to-token similarity strategies."""

    @property
    def is_modifier(self):
        return False

    @property
    def embeddings(self):
        raise NotImplementedError()

    @property
    def name(self):
        raise NotImplementedError()


class EmbeddingTokenSim(TokenSim):
    """Token similarity = vector metric over one embedding's vectors."""

    def __init__(self, embedding, metric: VectorSim = None):
        if metric is None:
            metric = CosineSim()
        self._embedding = embedding
        self._metric = metric

    @property
    def embedding(self):
        return self._embedding

    @property
    def metric(self):
        return self._metric

    @property
    def embeddings(self):
        return [self._embedding]

    @property
    def name(self):
        return f"{self._embedding.name}-{self._metric.name}"

    def to_args(self):
        return {
            "name": self.name,
            "embedding": self._embedding.name,
            "metric": self._metric,
        }
