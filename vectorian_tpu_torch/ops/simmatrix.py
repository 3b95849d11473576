"""Query similarity-matrix compiler and query plans.

Builds the (vocab x needle) similarity matrix — the replacement for the
reference's StaticEmbeddingSimilarityMatrixFactory
(vectorian/core/cpp/metric/static.cpp:9-78): one batched metric evaluation
(a single f32 GEMM for cosine) with the exact-token-match override
(static.cpp:58-67), the [0,1] clip (static.cpp:75, metric/metric.h:28-30)
and a zero PAD row.  Static modifier trees (mixed / extremum / unary chains
over several embeddings — reference metric/modifier.cpp) fold into ONE
[V, T] matrix when the plan compiles, so every consumer gathers the same
bits.  A plan with a contextual leaf keeps its tree: each chunk of slices
evaluates it (``eval_plan_chunk``), the contextual leaf as one metric GEMM
of the chunk's per-token vectors against the needle's (the reference's
metric/contextual.cpp:26-99, per document there).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

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
    """Evaluate a static TokenSim tree to {'similarity': [V, T],
    'magnitudes_*'}.

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
        return _leaf_matrix(
            token_sim, compiled, needle_token_ids, needle_strings, needs_magnitudes
        )
    raise TypeError(f"cannot compile token similarity {token_sim!r}")


class _ChunkVectors:
    """AbstractVectors facade over [n, d] tensors of a chunk's rows."""

    def __init__(self, unmodified, normalized, magnitudes):
        self.unmodified = unmodified
        self.normalized = normalized
        self.magnitudes = magnitudes


def chunk_vectors(ctx: torch.Tensor) -> _ChunkVectors:
    """The per-token vectors [c, L, d] (the bf16 store's rows) of a chunk as
    f32 rows [c * L, d] with their norms and unit rows (the JAX package's
    eval_plan_chunk arithmetic: x / max(|x|, 1e-9))."""
    d = ctx.shape[-1]
    flat = ctx.to(torch.float32).reshape(-1, d)
    mags = torch.linalg.vector_norm(flat, dim=-1)
    normed = flat / torch.clamp_min(mags, 1e-9)[:, None]
    return _ChunkVectors(flat, normed, mags)


def query_vectors(d: dict, device) -> _ChunkVectors:
    """A needle's contextual {unmodified, normalized, magnitudes} (numpy,
    ``Session.encode_contextual_query``) as f32 tensors on ``device``."""
    return _ChunkVectors(*(
        torch.as_tensor(np.asarray(d[k], np.float32), device=device).contiguous()
        for k in ("unmodified", "normalized", "magnitudes")
    ))


def ctx_similarity(ctx: torch.Tensor, q: _ChunkVectors, metric,
                   rows_block: Optional[int] = None) -> torch.Tensor:
    """clip(metric(rows of ``ctx`` [c, L, d], q [W, d]), 0, 1) as [c * L, W]
    f32 (metric/metric.h:28-30).  ``rows_block``: evaluate the rows in
    blocks of exactly that many (the last zero-padded), so a row's bits do
    not depend on how many rows a call holds (the exact rescore's fixed
    shape); None evaluates the chunk at once (the ranking pass)."""
    if rows_block is None:
        return torch.clamp(metric.compute(chunk_vectors(ctx), q), 0.0, 1.0)
    d = ctx.shape[-1]
    rows = ctx.reshape(-1, d)
    n = rows.shape[0]
    pad = -n % rows_block
    if pad:
        rows = torch.cat([rows, rows.new_zeros((pad, d))])
    out = [
        torch.clamp(metric.compute(chunk_vectors(rows[r0 : r0 + rows_block]), q),
                    0.0, 1.0)
        for r0 in range(0, n + pad, rows_block)
    ]
    return torch.cat(out)[:n]


@dataclass
class QueryPlan:
    """Everything needed to score buckets for one prepared query.

    A static-only plan is ONE folded [V, T] similarity matrix (``matrix``;
    the JAX package's ("static", 0) plan).  A plan with a contextual leaf
    keeps its tree (the JAX package's hashable plan tuple): leaves
    ("static", k) gather ``static_sims[k]`` [V, T], ("ctx", k, metric)
    evaluate ``metric`` of the chunk's vectors of embedding
    ``ctx_names[k]`` against the needle's ``ctx_queries[k]`` (numpy dicts;
    ``ctx_vectors[k]`` the same on the device); nodes ("mixed", children,
    w_idx), ("max" | "min", children), ("unary", child, kernel)."""

    matrix: Optional[torch.Tensor] = None  # [V, T], static-only plans
    plan: tuple = ("static", 0)
    static_sims: List[torch.Tensor] = field(default_factory=list)
    # k -> the vocabulary's magnitudes [V] of static leaf k (plans compiled
    # with needs_magnitudes: the Word Rotator's Distance masses)
    static_mags: List[torch.Tensor] = field(default_factory=list)
    ctx_names: List[str] = field(default_factory=list)
    ctx_queries: List[dict] = field(default_factory=list)
    ctx_vectors: List[_ChunkVectors] = field(default_factory=list)
    mixed_weights: List[torch.Tensor] = field(default_factory=list)
    # the largest similarity any cell can take (plan_sim_upper)
    sim_upper: float = 1.0

    @property
    def is_static_only(self) -> bool:
        return not self.ctx_names

    @property
    def width(self) -> int:
        """The padded needle width T."""
        if self.matrix is not None:
            return int(self.matrix.shape[1])
        if self.static_sims:
            return int(self.static_sims[0].shape[1])
        return int(self.ctx_vectors[0].unmodified.shape[0])


def plan_to(qp: QueryPlan, device) -> QueryPlan:
    """``qp`` with its tensors on ``device`` (a tensor already there is
    shared, not copied)."""
    def mv(t):
        return t.to(device)

    return dataclasses.replace(
        qp,
        matrix=None if qp.matrix is None else mv(qp.matrix),
        static_sims=[mv(t) for t in qp.static_sims],
        static_mags=[mv(t) for t in qp.static_mags],
        ctx_vectors=[_ChunkVectors(mv(v.unmodified), mv(v.normalized), mv(v.magnitudes))
                     for v in qp.ctx_vectors],
        mixed_weights=[mv(t) for t in qp.mixed_weights],
    )


def _has_unary(node) -> bool:
    kind = node[0]
    if kind == "unary":
        return True
    if kind in ("mixed", "max", "min"):
        return any(_has_unary(c) for c in node[1])
    return False


def compile_plan(
    token_sim,
    compiled: Dict[str, CompiledEmbedding],
    needle_token_ids: np.ndarray,
    needle_strings: Sequence[str],
    query_ctx: Optional[Dict[str, dict]] = None,
    device=None,
    needs_magnitudes: bool = False,
) -> QueryPlan:
    """Compile a TokenSim tree into a QueryPlan.  Static leaves are one
    GEMM each; a static-only tree folds into one combined [V, T] matrix
    with the JAX package's per-cell ops (mixture weights normalized,
    extremum by argmax selection, unary kernels applied in order).  A
    contextual leaf defers to per-chunk evaluation with the needle's
    vectors ``query_ctx[name]`` (padded to the needle's width) on
    ``device`` (default: the first compiled embedding's).
    ``needs_magnitudes`` (the Word Rotator's Distance) keeps each static
    leaf's vocabulary magnitudes and the tree unfolded, as the JAX
    package does, so ``eval_plan_chunk`` can combine the magnitudes."""
    qp = QueryPlan()
    if device is None:
        device = next(iter(compiled.values())).device if compiled else "cpu"

    def walk(node) -> tuple:
        if isinstance(node, EmbeddingTokenSim):
            emb = node.embedding
            if getattr(emb, "is_static", True):
                qp.static_sims.append(_leaf_matrix(
                    node, compiled, needle_token_ids, needle_strings, False
                )["similarity"])
                if needs_magnitudes:
                    qp.static_mags.append(compiled[emb.name].magnitudes)
                return ("static", len(qp.static_sims) - 1)
            qp.ctx_names.append(emb.name)
            qp.ctx_queries.append(query_ctx[emb.name])
            qp.ctx_vectors.append(query_vectors(query_ctx[emb.name], device))
            return ("ctx", len(qp.ctx_names) - 1, node.metric)
        if isinstance(node, MixedTokenSimilarity):
            children = tuple(walk(c) for c in node.operands)
            qp.mixed_weights.append(mixed_weights(node._weights, device))
            return ("mixed", children, len(qp.mixed_weights) - 1)
        if isinstance(node, (MaximumTokenSimilarity, MinimumTokenSimilarity)):
            kind = "max" if isinstance(node, MaximumTokenSimilarity) else "min"
            return (kind, tuple(walk(c) for c in node.operands))
        if isinstance(node, UnaryTokenSimilarityModifier):
            return ("unary", walk(node.operands[0]), node._kernel)
        raise TypeError(f"cannot compile token similarity {node!r}")

    qp.plan = walk(token_sim)
    unary = _has_unary(qp.plan)
    if qp.is_static_only and needs_magnitudes:
        if qp.plan == ("static", 0):
            qp.matrix = qp.static_sims[0].contiguous()
        qp.sim_upper = float("inf") if unary else 1.0
        return qp
    if qp.is_static_only:
        # fold: every consumer then reads the same bits of ONE matrix
        if qp.plan == ("static", 0):
            matrix = qp.static_sims[0].contiguous()
        else:
            tok = torch.arange(qp.static_sims[0].shape[0],
                               device=qp.static_sims[0].device)[None]
            matrix = eval_plan_chunk(qp, tok, ())["similarity"][0].contiguous()
        return QueryPlan(
            matrix=matrix, static_sims=[matrix],
            sim_upper=float(matrix.max()) if unary else 1.0,
        )
    # a contextual tree with a unary kernel has no known ceiling
    qp.sim_upper = float("inf") if unary else 1.0
    return qp


def eval_plan_chunk(qp: QueryPlan, tok: torch.Tensor, ctx_chunks,
                    rows_block: Optional[int] = None,
                    needs_magnitudes: bool = False) -> dict:
    """Evaluate a plan's tree on one chunk of slices -> {'similarity': [c,
    L, T]}.  ``tok`` [c, L] token ids (static leaves gather their rows),
    ``ctx_chunks`` k -> [c, L, d] the chunk's vectors of ``ctx_names[k]``;
    ``rows_block`` as in ``ctx_similarity``.  Mirrors the reference's
    modifier application (metric/modifier.cpp:18-74) and the
    static-into-contextual broadcast (metric/static.cpp:142-195), with the
    JAX package's per-cell ops.  ``needs_magnitudes`` (a plan compiled
    with it) also returns 'magnitudes_s' [c, L]: a static leaf's
    vocabulary magnitudes, a contextual leaf's vector norms, mixed by the
    mixture weights, an extremum's averaged over the needle cells each
    operand won (the JAX package's arithmetic)."""
    c, L = tok.shape

    def rec(node):
        kind = node[0]
        if kind == "static":
            k = node[1]
            mag = qp.static_mags[k][tok.long()] if needs_magnitudes else None
            return qp.static_sims[k][tok.long()], mag  # [c, L, T]
        if kind == "ctx":
            _, k, metric = node
            S = ctx_similarity(ctx_chunks[k], qp.ctx_vectors[k], metric, rows_block)
            mag = None
            if needs_magnitudes:
                mag = torch.linalg.vector_norm(ctx_chunks[k].to(torch.float32), dim=-1)
            return S.reshape(c, L, -1), mag
        if kind == "mixed":
            _, children, w_idx = node
            ops = [rec(ch) for ch in children]
            w = qp.mixed_weights[w_idx]
            mag = (mix(torch.stack([o[1] for o in ops], 0), w)
                   if needs_magnitudes else None)
            return mix(torch.stack([o[0] for o in ops], 0), w), mag
        if kind in ("max", "min"):
            ops = [rec(ch) for ch in node[1]]
            sims = torch.stack([o[0] for o in ops], 0)
            S, sel = extremum(sims, 1.0 if kind == "max" else -1.0)
            mag = None
            if needs_magnitudes:
                counts = torch.stack([(sel == k).sum(-1) for k in range(len(ops))],
                                     0).to(torch.float32)  # [K, c, L]
                mags = torch.stack([o[1] for o in ops], 0)
                mag = (mags * counts).sum(0) / torch.clamp_min(counts.sum(0), 1.0)
            return S, mag
        if kind == "unary":
            S, mag = rec(node[1])
            return node[2](S), mag
        raise ValueError(node)

    S, mag = rec(qp.plan)
    # ``rec`` is a recursive closure (a reference cycle holding the chunk's
    # tensors until a garbage collection): break it, so a paged bucket's
    # store frees when the pass evicts it
    del rec
    out = {"similarity": S}
    if needs_magnitudes:
        out["magnitudes_s"] = mag
    return out


def plan_sim_upper(qp: QueryPlan) -> float:
    """Largest similarity the plan can yield for any (token, needle) cell:
    leaves are clipped to [0, 1] and mixed / extremum nodes keep that
    range, so a plan without unary kernels is bounded by 1.0; a static-only
    plan with unary kernels by the maximum of its folded matrix; a
    contextual one with unary kernels is unbounded (inf: callers must not
    trust closed-form bounds that assume sim <= token weight)."""
    return qp.sim_upper
