"""Query similarity-matrix compiler, static embeddings.

Builds the (vocab x needle) similarity matrix — the replacement for the
reference's StaticEmbeddingSimilarityMatrixFactory
(vectorian/core/cpp/metric/static.cpp:9-78): one batched metric evaluation
(a single f32 GEMM for cosine) with the exact-token-match override
(static.cpp:58-67), the [0,1] clip (static.cpp:75, metric/metric.h:28-30)
and a zero PAD row.  Static modifier trees (mixed / extremum / unary chains
over several embeddings — reference metric/modifier.cpp) fold into ONE
[V, T] matrix when the plan compiles, so every consumer gathers the same
bits.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Sequence

import numpy as np
import torch

from vectorian_tpu_torch.embedding.vectors import Vectors
from vectorian_tpu_torch.sim.modifier import (
    MaximumTokenSimilarity,
    MinimumTokenSimilarity,
    MixedTokenSimilarity,
    TokenSimilarityModifier,
    UnaryTokenSimilarityModifier,
    extremum,
    mix,
    mixed_weights,
)
from vectorian_tpu_torch.sim.token import EmbeddingTokenSim


class CompiledEmbedding:
    """A session-compiled static embedding: vocab vectors on ``device``.

    Reference: EmbeddingManager.compile_static -> core.StaticEmbedding
    materializing the (vocab x dim) matrix once per session
    (vocabulary.h:251-258, embedding/static.cpp:18-27).
    """

    def __init__(self, name: str, encoder, vocab_strings: Sequence[str],
                 device="cuda"):
        self.name = name
        self.encoder = encoder
        self.device = torch.device(device)
        vectors = encoder.encode_tokens(vocab_strings)
        self.unmodified = self._put(vectors.unmodified)
        self.normalized = self._put(vectors.normalized)
        self.magnitudes = self._put(vectors.magnitudes)

    def _put(self, x) -> torch.Tensor:
        return torch.as_tensor(
            np.asarray(x, np.float32), device=self.device
        ).contiguous()

    @property
    def dimension(self):
        return int(self.unmodified.shape[1])

    def encode_query(self, token_strings: Sequence[str]) -> Vectors:
        return self.encoder.encode_tokens(token_strings)


class _DeviceVectors:
    """AbstractVectors facade over device tensors for VectorSim.compute."""

    def __init__(self, unmodified, normalized, magnitudes):
        self.unmodified = unmodified
        self.normalized = normalized
        self.magnitudes = magnitudes


def _leaf_matrix_device(metric, s, t, ids, needs_magnitudes: bool):
    """Leaf similarity [V, T] from vocab vectors ``s`` and needle vectors
    ``t`` (both _DeviceVectors on one device); ``ids`` [T] are the needle's
    corpus-vocab ids (-1 for OOV)."""
    matrix = metric.compute(s, t).to(torch.float32)  # [V, T]
    # exact-token-match override: needle token j IS vocab token k -> sim 1.0
    T = ids.shape[0]
    cols = torch.arange(T, device=matrix.device)
    valid = ids >= 0
    rows = torch.where(valid, ids, torch.zeros_like(ids))
    matrix[rows, cols] = torch.where(
        valid, torch.ones_like(matrix[0, cols]), matrix[0, cols]
    )
    matrix = torch.clamp(matrix, 0.0, 1.0)
    # PAD row (vocab id 0) must never contribute similarity
    matrix[0, :] = 0.0
    if needs_magnitudes:
        mag_t = torch.where(valid, s.magnitudes[rows], t.magnitudes)
    else:
        mag_t = t.magnitudes
    return matrix, mag_t


def _leaf_matrix(
    sim: EmbeddingTokenSim,
    compiled: Dict[str, CompiledEmbedding],
    needle_token_ids: np.ndarray,  # [T] corpus-vocab ids (or -1 for OOV)
    needle_strings: Sequence[str],
    needs_magnitudes: bool,
) -> dict:
    emb = compiled[sim.embedding.name]
    dev = emb.device
    t_vecs = emb.encode_query(needle_strings)
    t = _DeviceVectors(
        *(
            torch.as_tensor(np.asarray(x, np.float32), device=dev)
            for x in (t_vecs.unmodified, t_vecs.normalized, t_vecs.magnitudes)
        )
    )
    s = _DeviceVectors(emb.unmodified, emb.normalized, emb.magnitudes)
    ids = torch.as_tensor(
        np.asarray(needle_token_ids, np.int64), device=dev
    )
    matrix, mag_t = _leaf_matrix_device(sim.metric, s, t, ids, needs_magnitudes)
    out = {"similarity": matrix}
    if needs_magnitudes:
        out["magnitudes_s"] = emb.magnitudes
        out["magnitudes_t"] = mag_t
    return out


def compile_similarity(
    token_sim,
    compiled: Dict[str, CompiledEmbedding],
    needle_token_ids: np.ndarray,
    needle_strings: Sequence[str],
    needs_magnitudes: bool = False,
) -> dict:
    """Evaluate a TokenSim tree to {'similarity': [V, T], 'magnitudes_*'}.

    Mirrors Query::create_strategy's metric compilation walk
    (query.cpp:156-218): modifiers recurse into operands, leaves build
    per-embedding matrices.
    """
    if isinstance(token_sim, TokenSimilarityModifier):
        operands = [
            compile_similarity(
                op, compiled, needle_token_ids, needle_strings, needs_magnitudes
            )
            for op in token_sim.operands
        ]
        return token_sim.combine(operands)
    if isinstance(token_sim, EmbeddingTokenSim):
        _require_static(token_sim)
        return _leaf_matrix(
            token_sim, compiled, needle_token_ids, needle_strings, needs_magnitudes
        )
    raise TypeError(f"cannot compile token similarity {token_sim!r}")


def _require_static(sim: EmbeddingTokenSim) -> None:
    if not getattr(sim.embedding, "is_static", True):
        raise NotImplementedError(
            "contextual embeddings are not ported yet (ROADMAP.md port "
            "queue item 5: contextual, tree and span-embedding metrics)"
        )


@dataclass
class QueryPlan:
    """Everything needed to score buckets for one prepared query: the
    query's ONE folded [V, T] similarity matrix (the JAX package's
    ("static", 0) plan; contextual leaves are not ported yet)."""

    matrix: torch.Tensor  # [V, T]


def compile_plan(
    token_sim,
    compiled: Dict[str, CompiledEmbedding],
    needle_token_ids: np.ndarray,
    needle_strings: Sequence[str],
) -> QueryPlan:
    """Compile a static TokenSim tree into a QueryPlan: every leaf is one
    GEMM, and a modifier tree folds into one combined [V, T] matrix with
    the JAX package's per-cell ops (mixture weights normalized, extremum
    by argmax selection, unary kernels applied in order)."""

    def walk(node) -> torch.Tensor:
        if isinstance(node, EmbeddingTokenSim):
            _require_static(node)
            return _leaf_matrix(
                node, compiled, needle_token_ids, needle_strings, False
            )["similarity"]
        if isinstance(node, MixedTokenSimilarity):
            ops = [walk(c) for c in node.operands]
            w = mixed_weights(node._weights, ops[0].device)
            return mix(torch.stack(ops, 0), w)
        if isinstance(node, (MaximumTokenSimilarity, MinimumTokenSimilarity)):
            sign = 1.0 if isinstance(node, MaximumTokenSimilarity) else -1.0
            return extremum(torch.stack([walk(c) for c in node.operands], 0), sign)[0]
        if isinstance(node, UnaryTokenSimilarityModifier):
            return node._kernel(walk(node.operands[0]))
        raise TypeError(f"cannot compile token similarity {node!r}")

    return QueryPlan(matrix=walk(token_sim).contiguous())
