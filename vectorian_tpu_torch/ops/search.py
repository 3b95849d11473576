"""Brute-force batched search: similarity table -> alignment DP -> top-k.

Counterpart of vectorian_tpu/ops/search.py for the static path (resident
buckets; f32 ranking tables, or the int8 / bfloat16 ones of
``find_batch(sim_precision=...)``; affine or general gap models).  The
reference's matcher loop (MatcherImpl::match, vectorian/core/cpp/match/
matcher_impl.h:66-176 + ThreadPool fan-out index.py:530-560) becomes, per
length bucket, ONE launch of a DP kernel (ops/dp_kernels.py) — the affine
Gotoh kernel, or the Waterman-Smith-Beyer kernel for a general gap model —
which gathers the stacked [V, Tpad, Q] query table by slice token ids and
runs the DP for all Q queries; a device top-k fused with the exact f32
rescore of the selected rows then replaces the bounded min-heap
(result_set.h:40-60).  The kernel serves every corpus pass, Q=1 ``find``
included; the score-only rescores (the finalizer's extras round, one launch
a bucket a round, and ``rescore_many`` without flows) run the row-gather
kernels, which read each problem's rows from the stacked plan table.

Score normalization follows the reference (metric/alignment.h:84-106 +
match.h:295-336) with the default submatch_weight 0:
``score = raw / total`` where ``total`` is the needle length (the sum of
the needle's tag weights under tag weighting), times the slice's boost
under a booster.

The query options that ride these kernels (the JAX package's batch form,
ops/search.py there): tag weights rewrite the similarity block inside the
kernels (``dp_kernels.TagBlock``) and in the fused rescore's torch ops,
with the same arithmetic; a document-side filter compacts each bucket's
token and pos ids once per call (``compact_slices``), so every kernel reads
the filtered slices as they are; a booster multiplies the normalized
ranking scores after the kernel.

Plans with a contextual leaf (and mixed static + contextual trees) have no
vocab table: each chunk of a bucket's slices evaluates the plan
(``simmatrix.eval_plan_chunk``: the metric GEMM of the chunk's per-token
vectors, kept bf16 on the device by ``ensure_contextual``, against the
needle's), and the dense DP entries (``dp_kernels.affine_dp_scores_dense``
/ ``wsb_dp_scores_dense``) read the [c, L, T, Q] block where the GEMM wrote
it.  A chunk holds ``ctx_chunk`` slices, so its block stays in the card's
L2 between the GEMM and the DP.  The full-read paths (``score_all``,
``score_topk``) serve ``find``'s debug, submatch and contextual branches; the exact rescore of a contextual plan evaluates its
candidates' rows in blocks of ``RESCORE_ROWS`` (one GEMM shape), so a
slice's exact score has the same bits in every call.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F

from vectorian_tpu_torch import native
from vectorian_tpu_torch.ops.alignment import (
    align_matrices_scores,
    align_matrices_scores_general,
    gap_cost_closure,
    traceback,
    traceback_general,
)
from vectorian_tpu_torch.ops.dp_kernels import (
    TagBlock,
    affine_dp_scores,
    affine_dp_scores_dense,
    affine_dp_scores_rows,
    affine_table,
    tag_table,
    tag_weighted,
    wsb_dp_scores,
    wsb_dp_scores_dense,
    wsb_dp_scores_rows,
    wsb_table,
)
from vectorian_tpu_torch.ops.simmatrix import (
    QueryPlan,
    _ChunkVectors,
    eval_plan_chunk,
)
from vectorian_tpu_torch.utils import trace

NEG_SCORE = -1e30

# a contextual pass's chunk: its [c, L, T, Q] f32 similarity block at most
# CTX_BLOCK_BYTES (so it stays in an H100's 50 MB L2 between the metric GEMM
# that writes it and the dense DP that reads it) and its f32 vectors [c, L,
# d] at most CTX_INPUT_BYTES
CTX_BLOCK_BYTES = 32 << 20
CTX_INPUT_BYTES = 128 << 20
# the exact rescore of a contextual plan evaluates its rows in blocks of
# this many token rows (one GEMM shape, whatever the call's candidates)
RESCORE_ROWS = 2048


def ctx_chunk(L: int, Tpad: int, Q: int, d: int) -> int:
    """Slices a chunk of a contextual pass over a bucket of capacity L
    against Q needles padded to Tpad, vectors of d dimensions."""
    return max(1, min(CTX_BLOCK_BYTES // (L * Tpad * Q * 4),
                      CTX_INPUT_BYTES // (L * max(d, 1) * 4)))


def stack_ctx_queries(ctx_queries, len_ts, device):
    """Stack Q contextual needle dicts ({unmodified, normalized,
    magnitudes} numpy) into [Tpad * Q, d] rows, query minor (row t * Q +
    q), zero past each needle, Tpad the longest needle rounded up to 8 (the
    JAX package's layout: the metric GEMM's [c * L, Tpad * Q] output is the
    [c, L, Tpad, Q] block the dense DP reads).  Returns (the rows as
    _ChunkVectors on ``device``, Tpad)."""
    Q = len(ctx_queries)
    Tpad = -(-max(len_ts) // 8) * 8

    def stack(key):
        first = np.asarray(ctx_queries[0][key])
        out = np.zeros((Tpad, Q) + first.shape[1:], np.float32)
        for q, dq in enumerate(ctx_queries):
            v = np.asarray(dq[key], np.float32)
            out[: v.shape[0], q] = v
        return torch.as_tensor(out.reshape((Tpad * Q,) + out.shape[2:]),
                               device=device)

    return (_ChunkVectors(stack("unmodified"), stack("normalized"),
                          stack("magnitudes")), Tpad)


def stack_tree_plans(plans, len_ts, device):
    """Stack Q plans of one modifier tree (static and contextual leaves)
    into one plan over a Q-minor needle axis (the JAX package's
    ``stack_tree_plans``): each static leaf a [V, Tpad * Q] table (column t
    * Q + q, copies of each plan's columns, zero past its width), each
    contextual leaf the [Tpad * Q, d] rows of ``stack_ctx_queries`` (the
    vocabulary magnitudes of a WRD plan's static leaves as they are).  Every
    node of ``eval_plan_chunk`` is elementwise over the needle axis, so the
    stacked plan evaluates all Q needles of a chunk at once; its [c, L,
    Tpad * Q] block is the [c, L, Tpad, Q] block the dense DP reads.
    Returns (the stacked QueryPlan, Tpad)."""
    p0 = plans[0]
    if any(qp.plan != p0.plan for qp in plans):
        raise ValueError("stack_tree_plans: the plans' trees differ")
    Q = len(plans)
    Tpad = -(-max(len_ts) // 8) * 8
    statics = []
    for k in range(len(p0.static_sims)):
        V = int(p0.static_sims[k].shape[0])
        out = torch.zeros((V, Tpad, Q), dtype=torch.float32, device=device)
        for q, qp in enumerate(plans):
            m = qp.static_sims[k]
            out[:, : m.shape[1], q] = m
        statics.append(out.reshape(V, Tpad * Q))
    ctxs = []
    for k in range(len(p0.ctx_names)):
        qv, tp = stack_ctx_queries([qp.ctx_queries[k] for qp in plans], len_ts, device)
        if tp != Tpad:
            raise ValueError("stack_tree_plans: contextual width differs")
        ctxs.append(qv)
    stacked = QueryPlan(plan=p0.plan, static_sims=statics,
                        static_mags=[m.to(device) for m in p0.static_mags],
                        ctx_names=list(p0.ctx_names), ctx_vectors=ctxs,
                        mixed_weights=[w.to(device) for w in p0.mixed_weights])
    return stacked, Tpad


def tag_weighted_multi(S, pos, w, p, pen, thr):
    """The tag-weight rewrite of a multi-query block S [c, L, T, Q] with
    its rows' pos ids [c, L] and per query w, p [T, Q], pen, thr [Q] (the
    JAX package's ``_bucket_scores_multiquery_tree`` arithmetic in its
    order: w first, then S * w, then the threshold; a query without tag
    weights has w 1, penalty 0 and threshold -1, the identity)."""
    sel = torch.where(pos[:, :, None, None] == p[None, None], 1.0,
                      1.0 - pen[None, None, None, :])
    Sw = S * (w[None, None] * sel)
    return torch.where(Sw > thr[None, None, None, :], Sw, 0.0)


def reference_score(total: float, matched: float, submatch_weight: float) -> float:
    """The submatch normalization (metric/alignment.h:84-106): ``matched``
    of ``total`` needle weight aligned, the unmatched rest weighted by
    ((total - matched) / total) ** submatch_weight."""
    if total <= 0:
        return 1.0
    unmatched_weight = ((total - matched) / total) ** submatch_weight
    return matched + unmatched_weight * (total - matched)


def gap_vec(gap_cost_side, n1: int) -> np.ndarray:
    """THE single constructor for general-gap cost vectors (length ``n1``
    = padded width + 1; zeros placeholder when the side is None/affine).
    Every ranking / fused-rescore / stacked-rescore / traceback site must
    build through here: byte-equality across find/find_batch depends on
    the f32 values (and their min-plus closures) being identical at every
    site."""
    if gap_cost_side is None:
        return np.zeros((n1,), np.float32)
    return np.asarray(gap_cost_side.costs(n1), np.float32)


class GeneralGaps:
    """Cost vectors of a general (non-affine) gap model, built once per
    corpus pass or rescore: the needle side at one padded width (raw
    ``w_t`` for the global row 0, and its min-plus closure ``w_t_star``,
    computed once on the host), the document side per bucket capacity.
    Each is kept on the host, where it is built, and on ``device``: the
    WSB kernel's register route takes the host copies by value (reading
    the device copies back would wait for the stream).

    ``scale`` (np.float32): the vectors in the units of an int8 ranking
    table, each raw cost divided by it in f32 BEFORE the closure (the JAX
    package closes ``gap_vec_t / sim_scale``; closure(w / c) is not
    bitwise closure(w) / c)."""

    def __init__(self, gap_costs, n1_t: int, device, scale=None):
        self.gap_costs = gap_costs
        self.device = device
        self.scale = scale
        self.w_t_host = self._host_vec(gap_costs[1], n1_t)
        self.w_t_star_host = gap_cost_closure(self.w_t_host)
        self.w_t = self.w_t_host.to(device)
        self.w_t_star = self.w_t_star_host.to(device)
        self._w_s = {}  # capacity -> (host, device)

    def _host_vec(self, side, n1: int) -> torch.Tensor:
        w = gap_vec(side, n1)
        return torch.from_numpy(w if self.scale is None else w / self.scale)

    def _w_s_pair(self, capacity: int):
        if capacity not in self._w_s:
            host = self._host_vec(self.gap_costs[0], capacity + 1)
            self._w_s[capacity] = (host, host.to(self.device))
        return self._w_s[capacity]

    def vecs(self, capacity: int):
        """(w_s, w_t, w_t_star) on the device for a bucket of ``capacity``
        tokens."""
        return self._w_s_pair(capacity)[1], self.w_t, self.w_t_star

    def host_vecs(self, capacity: int):
        """The same three vectors on the host."""
        return self._w_s_pair(capacity)[0], self.w_t_host, self.w_t_star_host


@dataclass
class TagWeightingSpec:
    """Tag-weighted similarity of one query (reference TagWeightedSlice,
    slice/static.h:186-288): S'(i, j) = S(i, j) * t_pos_weights[j] * (1 -
    penalty * [pos_s(i) != pos_t(j)]), then 0 where it is not above the
    threshold.  A batch's specs reach the device stacked
    (``corpus_tag_columns``, ``stack_tag_slots``)."""

    t_pos_weights: np.ndarray  # [T] f32 per needle token
    pos_t: np.ndarray  # [T] i8 universal pos ids of needle tokens
    pos_mismatch_penalty: float
    similarity_threshold: float

    @property
    def total(self) -> float:
        return float(np.sum(self.t_pos_weights))


@dataclass
class DocFilterSpec:
    """Document-side token filtering (reference TokenFilter query.h:8-28 +
    FilteredSlice slice/static.h:104-184): drop document tokens by universal
    POS, fine tag, or explicit token string before alignment.  On the
    device each bucket's rows are compacted with a stable sort
    (``compact_slices``)."""

    pos_exclude: np.ndarray  # [n_pos] bool
    tag_exclude: np.ndarray  # [n_tags] bool
    token_exclude: np.ndarray  # [V] bool

    def device_args(self, device):
        """The three exclusion masks as bool tensors on ``device``."""
        return tuple(
            torch.as_tensor(np.asarray(m, bool), device=device)
            for m in (self.pos_exclude, self.tag_exclude, self.token_exclude)
        )


def compact_slices(tok, pos, tag, lengths, pos_ex, tag_ex, tok_ex):
    """Stable-compact the kept tokens of each row of ``tok`` [c, L] to its
    front (the JAX package's ``_compact_slices``): returns (perm [c, L]
    int64, the new lengths [c] int32, keep [c, L] bool); ``perm`` gathers
    original positions, dropped and padded ones go to the end in their
    order.  A gather commutes with a permutation of the rows, so compacting
    the token ids before a kernel gives it the block the JAX corpus pass
    compacts after its gather."""
    L = tok.shape[1]
    idx = torch.arange(L, device=tok.device)[None, :]
    valid = idx < lengths[:, None]
    # int32 indices: half the temporaries of int64 at 1M x 16 ids
    keep = (
        valid & ~pos_ex[pos.int()] & ~tag_ex[tag.int()] & ~tok_ex[tok.int()]
    )
    # stable sort: kept positions (key 0) before dropped ones (key 1)
    key = (~keep).to(torch.int32)
    perm = torch.sort(key, dim=1, stable=True).indices
    return perm, keep.sum(1, dtype=torch.int32), keep


def compact_rows(tokens, pos, tag, lengths, flt):
    """(tokens, pos, lengths) of rows compacted under a document-side
    filter's device masks ``flt`` (``compact_slices``): what a static pass's
    kernels read; ``pos`` None stays None."""
    perm, ln, _ = compact_slices(tokens, pos, tag, lengths, *flt)
    tokens = torch.gather(tokens, 1, perm).contiguous()
    if pos is not None:
        pos = torch.gather(pos, 1, perm).contiguous()
    return tokens, pos, ln


def corpus_tag_columns(tag_weights, Q: int, Tpad: int):
    """The corpus pass's per-query tag columns (numpy): weights [Q, Tpad]
    f32, needle pos ids [Q, Tpad] int8, penalty and threshold [Q] f32.  A
    query without tag weights stays identity, as in the JAX package:
    weight 1, pos -1, penalty 0 (the pos never matters), threshold -1 (a
    similarity of -1 or below becomes 0)."""
    w = np.ones((Q, Tpad), np.float32)
    p = np.full((Q, Tpad), -1, np.int8)
    pen = np.zeros((Q,), np.float32)
    thr = np.full((Q,), -1.0, np.float32)
    for qi, tw in enumerate(tag_weights):
        if tw is None:
            continue
        t = len(tw.t_pos_weights)
        w[qi, :t] = tw.t_pos_weights
        p[qi, :t] = tw.pos_t
        pen[qi] = tw.pos_mismatch_penalty
        thr[qi] = tw.similarity_threshold
    return w, p, pen, thr


def stack_tag_slots(tag_weights, Qp: int, Tmax: int):
    """The rescores' per-slot tag arrays (numpy, as ``corpus_tag_columns``)
    for the stacked plan table's ``Qp`` slots: a tagged slot's columns past
    its needle get weight 0 and pos -1 (the JAX package's ``_stack_tw``); an
    untagged slot keeps S as it is (weight 1, threshold -inf: S * 1 is S,
    and every finite S is above -inf)."""
    w = np.ones((Qp, Tmax), np.float32)
    p = np.full((Qp, Tmax), -1, np.int8)
    pen = np.zeros((Qp,), np.float32)
    thr = np.full((Qp,), -np.inf, np.float32)
    for si, tg in enumerate(tag_weights):
        if tg is None:
            continue
        T = len(tg.t_pos_weights)
        w[si] = 0.0
        w[si, :T] = tg.t_pos_weights
        p[si, :T] = tg.pos_t
        pen[si] = tg.pos_mismatch_penalty
        thr[si] = tg.similarity_threshold
    return w, p, pen, thr


def tag_arrays(cols):
    """A pass's tag columns (``corpus_tag_columns`` or ``stack_tag_slots``)
    and their weight table (``dp_kernels.tag_table``: the kernels' layout,
    built once a pass on the host, uploaded with the columns): the arrays
    of a ``TagBlock`` after its pos ids."""
    return tuple(cols) + tag_table(*cols[:3])


def _put_all(arrays, device):
    return tuple(torch.as_tensor(a, device=device) for a in arrays)


# the quantized ranking tables of ``find_batch(sim_precision=...)``
SIM_DTYPES = {"int8": torch.int8, "bfloat16": torch.bfloat16}


def stack_query_tables(plans, len_ts, sim_dtype=None):
    """Stack Q static query plans into the serving table [V, Tpad, Q]
    ((T, Q)-minor: a warp of the DP kernel reads one table row's Q
    consecutive elements), optionally quantized.  Tpad is the longest
    needle rounded up to 8; narrower plans are zero-padded (the DP masks
    columns past each query's len_t).

    ``sim_dtype``: None keeps f32; ``"bfloat16"`` rounds to nearest even;
    ``"int8"`` is ``round(table / sim_scale)`` (half to even) with the
    symmetric scale ``sim_scale = max_abs / 127`` in f32, ``max_abs =
    max(max|table|, 1e-9)`` over the zero-padded stack — max-plus
    homogeneity runs the quantized units through the unchanged DP with the
    gap costs divided by ``sim_scale`` (the JAX package's arithmetic, bit
    for bit).  Quantizing reads ``max_abs`` and ``sim_scale`` back to the
    host ONCE, after the quantization is enqueued: the kernels take the
    scaled costs by value, so no corpus pass is queued before it.  Returns
    (table, sim_scale np.float32 (1.0 unless int8), max_abs (a host float;
    None for f32), Tpad)."""
    Tmax = max(len_ts)
    Tpad = -(-Tmax // 8) * 8
    mats = [qp.matrix for qp in plans]
    table = torch.stack(
        [F.pad(m, (0, Tpad - int(m.shape[1]))) for m in mats], dim=2
    ).contiguous()
    if sim_dtype is None:
        return table, np.float32(1.0), None, Tpad
    if sim_dtype not in SIM_DTYPES:
        raise ValueError(f"unknown sim_dtype {sim_dtype!r}")
    max_abs = torch.clamp_min(table.abs().amax(), 1e-9)
    if sim_dtype == "int8":
        # device tensors on both sides: a CPU-scalar divisor would run as a
        # multiply by its reciprocal on the card
        scale = max_abs / torch.full_like(max_abs, 127.0)
        table = torch.round(table / scale).to(torch.int8)
    else:
        scale = torch.ones_like(max_abs)
        table = table.to(torch.bfloat16)
    with trace.span("topk.max_abs_read"):
        max_abs_h, scale_h = torch.stack((max_abs, scale)).tolist()
    return table, np.float32(scale_h), max_abs_h, Tpad


def quantization_entry_err(sim_dtype, max_abs) -> float:
    """Max per-entry absolute rounding of a quantized table (0.0 exact;
    ``max_abs`` as ``stack_query_tables`` returns it)."""
    if max_abs is None:
        return 0.0
    max_abs = float(max_abs)
    if sim_dtype == "int8":
        return max_abs / 127.0 / 2.0  # round-to-nearest
    # bf16 RN absolute error: half-ulp of max_abs's binade — the safe
    # upper bound is 2^-8 * max_abs (2^-9 relative only holds at the
    # binade's low end)
    return max_abs * 2.0 ** -8


def scaled_costs(gaps, gap_costs, sim_scale, Tpad: int, device):
    """A corpus pass's costs in its ranking table's units: (the affine
    ``gaps``, the GeneralGaps of ``gap_costs`` (None: affine), the scale
    as a 0-d f32 tensor on ``device`` or None).  At an int8 table's
    ``sim_scale`` the costs are divided by it going in (host f32 division,
    correctly rounded like the JAX package's device division) and the raw
    scores are multiplied by the returned tensor coming out; at 1.0 (f32
    and bf16 tables) nothing is scaled."""
    scaled = sim_scale != np.float32(1.0)
    scale_t = None
    if scaled:
        gaps = type(gaps)(*(g / sim_scale for g in gaps))
        scale_t = torch.full((), float(sim_scale), dtype=torch.float32, device=device)
    general = (
        None if gap_costs is None
        else GeneralGaps(gap_costs, Tpad + 1, device,
                         scale=sim_scale if scaled else None)
    )
    return gaps, general, scale_t


def order_by_score(packed, ids, scores) -> np.ndarray:
    """Positions of ``ids`` in the reference's deterministic match order:
    score desc, then doc id asc, then slice idx asc (match_impl.h:8-42).
    The single home of this tie-break — every top-k/merge path uses it."""
    # an empty candidate set must order to empty — np.asarray([]) is
    # float64 and would crash the integer indexing below
    ids = np.asarray(ids, np.int64)
    if ids.size == 0:
        return np.empty((0,), np.int64)
    return np.lexsort(
        (
            packed.slice_idx[ids],
            packed.slice_doc[ids],
            -np.asarray(scores).astype(np.float64),
        )
    )


def _bucket_scores_multiquery(
    tokens, lengths, sim_multi, len_t, gaps, norm_total, locality,
    general=None, sim_scale=None, tags=None, boost=None,
):
    """[n, Q] normalized scores of one bucket — Q queries in one corpus
    pass, one kernel launch (the gather of ``sim_multi`` by ``tokens`` is
    fused into the DP kernel).  ``general``: the GeneralGaps of a
    non-affine gap model (WSB kernel), else None; ``sim_multi`` may be the
    pass's ``AffineTable`` or ``WsbTable`` made from it and ``len_t``.  ``sim_scale``:
    a 0-d f32 tensor on the device for an int8 table, else None; ``gaps``
    and ``general`` are then in the table's units (divided by it), and the
    raw scores are multiplied by it coming out, before the normalization
    (the JAX package's order).  ``tags``: the tag-weighted block's
    ``TagBlock`` (the kernel rewrites S), else None; ``boost``: [n, Q] f32
    multipliers of the normalized scores, else None.  ``tokens`` and
    ``lengths`` are the compacted ones under a document-side filter: a
    slice the filter empties scores NEG_SCORE."""
    if general is None:
        raw = affine_dp_scores(sim_multi, tokens, lengths, len_t, gaps, locality,
                               tags=tags)
    else:
        capacity = int(tokens.shape[1])
        raw = wsb_dp_scores(
            sim_multi, tokens, lengths, len_t, *general.vecs(capacity),
            locality, host_costs=general.host_vecs(capacity), tags=tags,
        )
    if sim_scale is not None:
        raw = raw * sim_scale
    scores = raw / torch.clamp_min(norm_total, 1e-9)[None, :]
    if boost is not None:
        scores = scores * boost
    return scores.masked_fill(lengths[:, None] <= 0, NEG_SCORE)


class MultiQueryPass:
    """What a multi-query corpus pass over static plans holds on one
    device: the stacked ranking ``table`` (``stack_query_tables``; made the
    pass's ``AffineTable`` on the affine path, its ``WsbTable`` on the
    general one), the costs in its units
    (``scaled_costs``), the needles' lengths and norms, and the tag columns
    with their weight table (``corpus_tag_columns``, or None).  The
    single-device pass builds one on the engine's device; a mesh builds one
    per distinct device of its shards (``parallel/mesh.MeshSearch``)."""

    def __init__(self, table, sim_scale, len_ts, gaps, gap_costs, norm_totals,
                 device, tag_cols=None):
        Tpad = int(table.shape[1])
        self.gaps, self.general, self.scale_t = scaled_costs(
            gaps, gap_costs, sim_scale, Tpad, device)
        self.lt = torch.as_tensor(np.asarray(len_ts, np.int32), device=device)
        table = table.to(device)
        # the launches' per-needle split, once a pass
        if self.general is None:
            table = affine_table(table, self.lt, len_ts)
        else:
            table = wsb_table(table, self.lt, len_ts)
        self.table = table
        self.nt = torch.as_tensor(np.asarray(norm_totals, np.float32), device=device)
        self.tw = None if tag_cols is None else _put_all(tag_arrays(tag_cols), device)

    def scores(self, tokens, lengths, locality: str, pos=None, boost=None):
        """[n, Q] normalized scores of n rows (a bucket, or a mesh shard):
        one launch of kernel 1 or 3 (``_bucket_scores_multiquery``); ``pos``
        the rows' pos ids under tag weights."""
        return _bucket_scores_multiquery(
            tokens, lengths, self.table, self.lt, self.gaps, self.nt, locality,
            self.general, self.scale_t,
            None if self.tw is None else TagBlock(pos, *self.tw), boost,
        )


def _dense_raw(S, lengths, len_t, gaps, locality, general=None):
    """Raw scores [c, Q] of a dense block S [c, L, T, Q] f32 (one launch
    of a dense DP entry; len_s clamped to >= 1)."""
    if general is None:
        return affine_dp_scores_dense(S, lengths, len_t, gaps, locality)
    L = int(S.shape[1])
    return wsb_dp_scores_dense(S, lengths, len_t, *general.vecs(L), locality,
                               host_costs=general.host_vecs(L))


def _dense_scores(S, lengths, len_t, gaps, norm_total, locality, general=None,
                  boost=None):
    """Normalized scores [c, Q] of a dense block (the JAX contextual pass's
    order: raw / norm_total, times the boost, NEG_SCORE where a slice is
    empty)."""
    raw = _dense_raw(S, lengths, len_t, gaps, locality, general)
    scores = raw / torch.clamp_min(norm_total, 1e-9)[None, :]
    if boost is not None:
        scores = scores * boost
    return scores.masked_fill(lengths[:, None] <= 0, NEG_SCORE)


def dense_scores(view, block, Tpad: int, Q: int, d: int, lt, gaps, locality: str,
                 nt, general=None, flt=None, rewrite=None, boost=None):
    """[n, Q] normalized scores of the rows of ``view`` (a bucket as a
    dense pass reads it, ``BruteForceEngine._dense_view``, or a mesh
    shard's rows: "tokens", "lengths", and "pos" / "tag" where the filter
    or the rewrite reads them), chunk by chunk of ``ctx_chunk`` rows:
    ``block(view, c0, c1)`` makes the chunk's [c, L, Tpad, Q] similarity
    block; under a document-side filter (``flt``: its exclusion masks on
    the rows' device) the block's rows are compacted AFTER it is made (the
    store's rows stay in slice order, so the metric GEMM sees the JAX
    package's shapes); ``rewrite(S, pos)`` (the tag rewrite) sees the
    compacted block; then ONE launch of a dense DP entry.  ``boost`` [n, Q]
    or [n, 1] multiplies the scores."""
    n, L = int(view["tokens"].shape[0]), int(view["tokens"].shape[1])
    chunk = ctx_chunk(L, Tpad, Q, d)
    parts = []
    for c0 in range(0, n, chunk):
        c1 = min(c0 + chunk, n)
        S = block(view, c0, c1)
        ln = view["lengths"][c0:c1]
        pos = None
        if flt is not None or rewrite is not None:
            pos = view["pos"][c0:c1]
        if flt is not None:
            perm, ln, _ = compact_slices(view["tokens"][c0:c1], pos,
                                         view["tag"][c0:c1], ln, *flt)
            S = torch.gather(S, 1, perm[:, :, None, None].expand(-1, -1, Tpad, Q))
            pos = torch.gather(pos, 1, perm)
        if rewrite is not None:
            S = rewrite(S, pos)
        parts.append(_dense_scores(S.contiguous(), ln, lt, gaps, nt, locality,
                                   general, None if boost is None else boost[c0:c1]))
    return torch.cat(parts)


class TreePass:
    """What a multi-query pass of Q plans of one modifier tree with a
    contextual leaf holds on one device: the plans stacked
    (``stack_tree_plans``: every static leaf gathers its [V, Tpad * Q]
    table, every contextual leaf is one metric GEMM against its [Tpad * Q,
    d] stacked needles), the needles' lengths and norms, the general gap
    model's vectors, the document-side filter's masks and each query's tag
    rewrite of the combined similarity (``tag_weights``: a
    TagWeightingSpec or None a query).  ``scores(view)`` is one bucket's,
    or one mesh shard's, [n, Q] scores (``dense_scores``); a chunk's
    vectors count every contextual leaf's width.  The single-device pass
    builds one on the engine's device, a mesh one per distinct device of
    its shards."""

    def __init__(self, plans, len_ts, gaps, locality: str, norm_totals, device,
                 gap_costs=None, doc_filter=None, tag_weights=None):
        Q = len(plans)
        self.Q, self.gaps, self.locality = Q, gaps, locality
        self.sp, self.Tpad = sp, Tpad = stack_tree_plans(plans, len_ts, device)
        self.lt = torch.as_tensor(np.asarray(len_ts, np.int32), device=device)
        self.nt = torch.as_tensor(np.asarray(norm_totals, np.float32), device=device)
        self.general = (None if gap_costs is None
                        else GeneralGaps(gap_costs, Tpad + 1, device))
        self.flt = None if doc_filter is None else doc_filter.device_args(device)
        self.rewrite = None
        if tag_weights is not None and any(t is not None for t in tag_weights):
            tw_w = np.ones((Tpad, Q), np.float32)
            tw_p = np.full((Tpad, Q), -1, np.int8)
            tw_pen = np.zeros((Q,), np.float32)
            tw_thr = np.full((Q,), -1.0, np.float32)
            for qi, tw in enumerate(tag_weights):
                if tw is None:
                    continue
                t = min(len(tw.t_pos_weights), Tpad)
                tw_w[:t, qi] = tw.t_pos_weights[:t]
                tw_p[:t, qi] = tw.pos_t[:t]
                tw_pen[qi] = tw.pos_mismatch_penalty
                tw_thr[qi] = tw.similarity_threshold
            tw_args = _put_all((tw_w, tw_p, tw_pen, tw_thr), device)

            def rewrite(S, pos):
                return tag_weighted_multi(S, pos, *tw_args)

            self.rewrite = rewrite
        self.with_pos = self.flt is not None or self.rewrite is not None
        self.d = sum(int(v.unmodified.shape[1]) for v in sp.ctx_vectors)

    def block(self, view, c0: int, c1: int):
        ctx = tuple(view["ctx"][nm][c0:c1] for nm in self.sp.ctx_names)
        S = eval_plan_chunk(self.sp, view["tokens"][c0:c1], ctx)["similarity"]
        return S.reshape(c1 - c0, int(view["tokens"].shape[1]), self.Tpad, self.Q)

    def scores(self, view, boost=None):
        return dense_scores(view, self.block, self.Tpad, self.Q, self.d, self.lt,
                            self.gaps, self.locality, self.nt, self.general,
                            self.flt, self.rewrite, boost)


def _mq_similarity(tok, qidx, table, V: int):
    """Gather of multi-query rescore rows from the stacked [Q * V, Tmax]
    plan table (shared by the fused top-k rescore, the select-with-rescore
    and the stacked rescore, so their bits agree)."""
    return table[qidx[:, None].long() * V + tok.long()]  # [g, L, Tmax]


def _mq_blocks(tok, pos, qidx, table, V: int, tw=None):
    """``_mq_similarity``'s rows and their tag weights (the same arithmetic
    as the row-gather kernels' rewrite and its plain version, so their bits
    agree): (S weighted [g, L, Tmax], S unweighted).  ``tw``: the slots'
    (w, p, pen, thr) device arrays (``stack_tag_slots``; ``tag_arrays``
    adds the kernels' weight table after them) with ``pos`` [g, L] the
    rows' pos ids, else None (both are S)."""
    S = _mq_similarity(tok, qidx, table, V)
    if tw is None:
        return S, S
    w, p, pen, thr = tw[:4]
    q = qidx.long()
    return tag_weighted(S, pos, w[q], p[q], pen[q], thr[q]), S


def _mq_matrices_scores(S, ln, lt, gaps, locality, general=None):
    """H + raw for multi-query rescore rows, affine or general-gap (the
    general DP takes the index-level shared cost vectors; their values and
    min-plus closures are prefix-stable under needle padding, so the
    per-row len_t masks keep results bit-equal to per-query widths).
    Zero-length rows report NEG_SCORE (a local-DP 0.0 would otherwise
    surface as a fake match at negative min_score)."""
    if general is None:
        H, _, _, raw = align_matrices_scores(S, ln, lt, gaps, locality)
    else:
        w_s, w_t, w_t_star = general
        H, raw = align_matrices_scores_general(
            S, ln, lt, w_s, w_t, locality, w_t_star=w_t_star
        )
    return H, raw.masked_fill(ln <= 0, NEG_SCORE)


def _rows_scores(tokens, rows, qidx, table, V: int, ln, lt, gaps, locality,
                 general=None, pos=None, tw=None):
    """Score-only variant of _mq_matrices_scores on _mq_similarity's rows
    (same bits, same NEG_SCORE mask): ONE launch of the row-gather DP
    kernel, which reads each (row, query slot) problem's similarity rows
    from the stacked table itself, tag-weighted by ``tw`` with ``pos`` [n,
    L] (the bucket rows' pos ids) where given; its plain version on the
    CPU.  ``general``: the GeneralGaps of a non-affine model, else None."""
    i32 = torch.int32
    args = (tokens, rows.to(i32), qidx.to(i32), table, V, ln.to(i32), lt.to(i32))
    tags = None if tw is None else TagBlock(pos, *tw)
    if general is None:
        return affine_dp_scores_rows(*args, gaps, locality, tags=tags)
    capacity = int(tokens.shape[1])
    return wsb_dp_scores_rows(
        *args, *general.vecs(capacity), locality,
        host_costs=general.host_vecs(capacity), tags=tags,
    )


def _ec_general(ec, capacity: int):
    """The exact context's (w_s, w_t, w_t_star) for a bucket, or None on
    the affine path."""
    gg = ec["general"]
    return None if gg is None else gg.vecs(capacity)


def _rows_matrices(db, rows, qidx, ec):
    """The fused rescore of bucket rows ``rows`` against slots ``qidx``:
    (H, raw, S weighted, S unweighted or None when no query is tagged)."""
    tokens = db["tokens"]
    pos = db["pos"][rows] if ec["tw"] is not None else None
    S, Su = _mq_blocks(tokens[rows], pos, qidx, ec["table"], ec["V"], ec["tw"])
    H, raw = _mq_matrices_scores(
        S, db["lengths"][rows], ec["lt_q"][qidx], ec["gaps"], ec["locality"],
        _ec_general(ec, tokens.shape[1]),
    )
    return H, raw, S, (None if ec["tw"] is None else Su)


def _topk_exact_rescore(scores, db, ec, n: int, kk: int, kd: int):
    """Per-bucket device top-k FUSED with the exact f32 rescore and the
    traceback DP matrices of the selected rows: candidates reach the host
    already carrying their exact raw scores and flow payloads (H, the
    similarity block S the DP read, and under tag weights the unweighted
    block Su the edge similarities read).  ``kd`` >= kk deepens the (vals,
    ids, exact-raw) fetch past the payload depth, so boundary tie groups
    resolve host-side.  ``db``: the bucket as the corpus pass read it
    (compacted under a document-side filter).

    ``torch.topk`` promises no order among ties; the design does not need
    one: the (kd+1)-th value bounds every unfetched slice, and
    ``order_by_score`` alone breaks ties."""
    vals, idx = torch.topk(scores[:n].T, kd + 1, dim=1)  # [Q, kd+1]
    Q = idx.shape[0]
    rows = idx[:, :kd].reshape(-1)
    qidx = torch.arange(Q, device=idx.device).repeat_interleave(kd)
    H, raw, S, Su = _rows_matrices(db, rows, qidx, ec)
    if kd > kk:
        # flow payloads ship only to the kk payload depth; the deep tail
        # carries (score, id, raw) triples only
        def head(x):
            return None if x is None else x.reshape(Q, kd, *x.shape[1:])[
                :, :kk].reshape(Q * kk, *x.shape[1:])

        H, S, Su = head(H), head(S), head(Su)
    return vals, idx, raw.reshape(Q, kd), H, S, Su


def _full_exact_rescore(scores, db, ec, n: int):
    """Exact rescore + flow payloads for EVERY row of a small
    (fully-fetched) bucket for all Q queries."""
    Q = ec["lt_q"].shape[0]
    dev = scores.device
    rows = torch.arange(n, device=dev).repeat(Q)
    qidx = torch.arange(Q, device=dev).repeat_interleave(n)
    H, raw, S, Su = _rows_matrices(db, rows, qidx, ec)
    return scores[:n].T, raw.reshape(Q, n), H, S, Su


def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy()


class _HostCopies:
    """Device -> host copies of some tensors, queued now and waited on by
    ``wait()``: on a card each lands in pinned memory by a non_blocking
    copy behind an event, so the host can queue more work (a paged
    pass's next bucket) before it waits."""

    def __init__(self, tensors):
        self._event = None
        self._bufs = [t.detach() for t in tensors]
        if any(t.is_cuda for t in self._bufs):
            bufs = []
            for t in self._bufs:
                b = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                b.copy_(t, non_blocking=True)
                bufs.append(b)
            self._bufs = bufs
            self._event = torch.cuda.Event()
            self._event.record()

    def wait(self) -> List[np.ndarray]:
        if self._event is not None:
            self._event.synchronize()
        return [b.numpy() for b in self._bufs]


class _Pager:
    """The host -> device copies of a paged engine.  Host copies live in
    pinned memory (``pin``, once, when the engine is built); ``upload``
    queues a non_blocking copy on a copy stream of its own, makes the
    compute stream wait on an event recorded after it, and records the
    new tensor on the compute stream, so the caching allocator does not
    hand its memory out again while a read queued there is pending.  On
    the CPU the host tensor is the device tensor.  ``bytes`` counts what
    was uploaded."""

    def __init__(self, device):
        self.device = device
        self.stream = torch.cuda.Stream(device) if device.type == "cuda" else None
        self.bytes = 0

    def pin(self, arr) -> torch.Tensor:
        t = torch.from_numpy(np.ascontiguousarray(arr))
        return t.pin_memory() if self.stream is not None else t

    def empty(self, shape, dtype) -> torch.Tensor:
        return torch.empty(shape, dtype=dtype, pin_memory=self.stream is not None)

    def upload(self, host: torch.Tensor) -> torch.Tensor:
        self.bytes += host.numel() * host.element_size()
        if self.stream is None:
            return host
        compute = torch.cuda.current_stream(self.device)
        with torch.cuda.stream(self.stream):
            dev = host.to(self.device, non_blocking=True)
            ready = torch.cuda.Event()
            ready.record(self.stream)
        compute.wait_event(ready)
        dev.record_stream(compute)
        return dev


def _widen_u16(t: torch.Tensor) -> torch.Tensor:
    """int32 ids from the int16 bits of uint16 ones (torch's uint16 has
    few CUDA ops)."""
    return t.to(torch.int32) & 0xFFFF


def _widen_u8(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.int16)


def narrow_planes(bucket, pager):
    """{key: (pinned host tensor, widen fn or None)} of a packed bucket's
    device keys (the JAX package's narrow upload planes): token ids that
    all fit under 65,536 travel as 16 bits and tag ids under 256 as 8
    bits, widened on the device after the copy; pos ids (int8) and
    lengths (int32) as they are."""
    tok = np.ascontiguousarray(bucket.token_ids, np.int32)
    tag = np.ascontiguousarray(bucket.tag_ids, np.int16)
    planes = {
        "lengths": (pager.pin(np.asarray(bucket.lengths, np.int32)), None),
        "pos": (pager.pin(np.asarray(bucket.pos_ids, np.int8)), None),
    }
    if tok.size == 0 or (tok.min() >= 0 and tok.max() < 1 << 16):
        planes["tokens"] = (pager.pin(tok.astype(np.uint16).view(np.int16)), _widen_u16)
    else:
        planes["tokens"] = (pager.pin(tok), None)
    if tag.size == 0 or (tag.min() >= 0 and tag.max() < 1 << 8):
        planes["tag"] = (pager.pin(tag.astype(np.uint8)), _widen_u8)
    else:
        planes["tag"] = (pager.pin(tag), None)
    return planes


class _PagedBucket(dict):
    """A length bucket of a paged engine (the JAX package's
    ``_PagedBucket``): its host fields (bi, capacity, n, slice_index) are
    entries of the dict; its device keys — "tokens", "lengths", "pos",
    "tag" — upload from their pinned host planes (``narrow_planes``) at
    first touch, as does a contextual store through ``page``; ``evict``
    drops every uploaded tensor again."""

    DEVICE_KEYS = ("tokens", "lengths", "pos", "tag")

    def __init__(self, fields, planes, pager):
        super().__init__(fields)
        self._planes = planes
        self._pager = pager
        self._paged = []

    def __missing__(self, key):
        if key not in self.DEVICE_KEYS:
            raise KeyError(key)
        return self.page(key, *self._planes[key])

    def page(self, key, host: torch.Tensor, widen=None) -> torch.Tensor:
        """The device copy of ``host`` under ``key``, uploaded (and
        widened) at the first call until ``evict``."""
        if dict.__contains__(self, key):
            return dict.__getitem__(self, key)
        val = self._pager.upload(host)
        if widen is not None:
            val = widen(val)
        dict.__setitem__(self, key, val)
        self._paged.append(key)
        return val

    def evict(self) -> None:
        for key in self._paged:
            dict.pop(self, key, None)
        self._paged = []


class _LazyScores:
    """A paged corpus pass's deferred bucket (the JAX package's
    ``_LazyScores``): ``get()`` pages the bucket in and dispatches its
    scoring, -> (the bucket as the pass read it, its scores on the
    device); ``release()`` drops both and evicts the bucket.  A consumer
    reads what it needs of the scores to the host before it releases
    them; ``get()`` after ``release()`` pages the bucket in again."""

    __slots__ = ("_db", "_fn", "_out")

    def __init__(self, db: _PagedBucket, fn):
        self._db = db
        self._fn = fn
        self._out = None

    def get(self):
        if self._out is None:
            self._out = self._fn()
        return self._out

    def release(self) -> None:
        self._out = None
        self._db.evict()


def _drain(pending, read, span: str = "pass.fetch", dispatch_span=None) -> list:
    """The host arrays of ``read(view, scores)`` (a list of device tensors)
    for every entry of a corpus pass's pending list, in order; the waits
    for the device are traced as ``span``, and the time before the first
    wait as ``dispatch_span`` (when given).  Resident entries were
    dispatched together; their reads are fetched at the end.  A lazy
    (paged) entry is dispatched when it is reached, its reads are
    queued, then the next lazy entry's upload and dispatch, before the
    host waits for this one's copies and releases it: bucket i+1's upload
    and kernels run while the host waits for bucket i, and the device
    holds about two buckets at a time."""
    t0 = time.perf_counter()

    def wait():
        nonlocal dispatch_span
        if dispatch_span is not None:
            trace.add(dispatch_span, time.perf_counter() - t0)
            dispatch_span = None
        return trace.span(span)

    out = []
    for i, (db, s) in enumerate(pending):
        if not isinstance(s, _LazyScores):
            out.append(read(db, s))
            continue
        copies = _HostCopies(read(*s.get()))
        if i + 1 < len(pending) and isinstance(pending[i + 1][1], _LazyScores):
            pending[i + 1][1].get()
        with wait():
            out.append(copies.wait())
        s.release()
    with wait():
        return [[r if isinstance(r, np.ndarray) else _host(r) for r in refs]
                for refs in out]


def _pending_entry(db, fn, paged: bool):
    """One bucket's entry of a corpus pass's pending list: ``fn()`` ->
    (the bucket as the pass read it, its scores) dispatched now, or (the
    paged bucket, a ``_LazyScores`` of ``fn``)."""
    return (db, _LazyScores(db, fn)) if paged else fn()


class BucketTopKSource:
    """Device-side per-bucket top-k candidate source for a multi-query
    corpus pass: fetches only [Q, k+1] (value, id) pairs per bucket with
    their exact raw scores (the full [n_slices, Q] score matrix stays on the
    device).  The (k+1)-th value bounds every unfetched slice, and
    unsafe-cut extras select single score COLUMNS on demand.

    Candidate selection never decides the final order (the finalizer
    exactly rescores and ``order_by_score`` owns the tie-break), and the
    boundary bound covers truncated ties: a tied slice left unfetched keeps
    rest_max >= thresh, forcing the tie-bounded extras round that reads the
    column and recovers it."""

    # flow payloads (H/S) ride the initial fetch only up to this size;
    # bigger batches defer flows to the final-round rescore instead
    PAYLOAD_MAX_BYTES = 8 << 20
    # deep (score, id, raw) fetch depth at latency-serving Q (<=8): covers
    # Zipf boundary tie groups so the cut proves safe without a second
    # select round
    DEEP_K = 512
    # reduced depth for serving batches (the tail's rescore and transfer
    # scale with Q x depth)
    DEEP_K_LARGE_Q = 128
    # cap on the thresholded column select: extras are tie-bounded and
    # usually small; beyond it the whole column is read
    ABOVE_CAP = 8192

    def __init__(self, engine, pending, Q: int, k: int, exact_ctx=None):
        """``exact_ctx``: {table, V, Tmax, lt_q, gaps, general, locality,
        tw} — the top-k step also computes each selected row's exact f32 raw
        DP score (``general``: the GeneralGaps of a non-affine model, else
        None; ``tw``: the slots' tag arrays, else None); None (the
        transport metrics, which rescore on the host) fetches the device
        values alone.  ``pending``: (the bucket as its corpus pass read it,
        its [n, Q] scores)."""
        self._engine = engine
        self._pending = pending
        self.Q = Q
        self.k = k
        self.exact_ctx = ec = exact_ctx
        self._col_cache = {}
        if ec is None:
            self._init_values(pending, k)
            return
        metas = []
        pay_budget = self.PAYLOAD_MAX_BYTES  # WHOLE-FETCH budget
        deep = self.DEEP_K if Q <= 8 else self.DEEP_K_LARGE_Q
        # similarity blocks a payload row carries: S, and Su under tags
        blocks = 1 if ec["tw"] is None else 2

        def read(db, scores):
            # ``db`` is the bucket as the pass read it (the fused rescore
            # reads its rows while a paged bucket is on the device)
            nonlocal pay_budget
            n = db["n"]
            kk = min(k, n)
            kd = max(kk, min(deep, n - 1))
            pay_bytes = Q * kk * 4 * (
                (db["capacity"] + 1) * (ec["Tmax"] + 1)
                + blocks * db["capacity"] * ec["Tmax"]
            )
            with_pay = pay_bytes <= pay_budget
            if with_pay:
                pay_budget -= pay_bytes
            meta = {"db": pending[len(metas)][0], "pay": with_pay}
            metas.append(meta)
            if kd < n:
                vals, idx, raw, H, S, Su = _topk_exact_rescore(
                    scores, db, ec, n, kk, kd
                )
                meta.update(kk=kd, full=False)
                refs = [vals, idx, raw]
            else:
                vals, raw, H, S, Su = _full_exact_rescore(scores, db, ec, n)
                meta.update(kk=kk, full=True)
                refs = [vals, raw]
            if with_pay:
                refs.extend((H, S) if Su is None else (H, S, Su))
            return refs

        fetched = [r for refs in _drain(pending, read, "topk.fetch",
                                        "topk.rescore_dispatch") for r in refs]
        self._buckets = []
        pos = 0
        for m in metas:
            db = m["db"]
            if m["full"]:
                vals = fetched[pos]
                pos += 1
                m["vals"] = vals  # [Q, n]
                m["sids"] = np.broadcast_to(db["slice_index"][None, :], vals.shape)
                m["bound"] = np.full((self.Q,), -np.inf, np.float32)
            else:
                vals, idx = fetched[pos], fetched[pos + 1]
                pos += 2
                kk = m["kk"]
                m["vals"] = vals[:, :kk]
                m["sids"] = db["slice_index"][idx[:, :kk]]
                m["bound"] = vals[:, kk].astype(np.float32)
            m["exact"] = fetched[pos]  # [Q, kk] raw f32
            pos += 1
            if m["pay"]:
                for key in ("H", "S", "Su")[: 1 + blocks]:
                    m[key] = fetched[pos].reshape(self.Q, -1, *fetched[pos].shape[1:])
                    pos += 1
                if blocks == 1:
                    m["Su"] = m["S"]
            self._buckets.append(m)

    def _init_values(self, pending, k: int):
        """The per-bucket fetch without an exact rescore: the [Q, k + 1]
        best device values and their ids of a bucket (its (k+1)-th value
        bounds the rest), or the whole bucket where it holds at most k."""
        metas = []

        def read(db, scores):
            n = db["n"]
            kk = min(k, n)
            full = kk >= n
            metas.append({"db": pending[len(metas)][0], "kk": kk, "full": full})
            if full:
                return [scores[:n].T]
            return list(torch.topk(scores[:n].T, kk + 1, dim=1))

        fetched = [r for refs in _drain(pending, read, "topk.fetch") for r in refs]
        self._buckets = []
        pos = 0
        for m in metas:
            db = m["db"]
            if m["full"]:
                m["vals"] = fetched[pos]
                m["sids"] = np.broadcast_to(db["slice_index"][None, :], m["vals"].shape)
                m["bound"] = np.full((self.Q,), -np.inf, np.float32)
                pos += 1
            else:
                vals, idx = fetched[pos], fetched[pos + 1]
                pos += 2
                m["vals"] = vals[:, : m["kk"]]
                m["sids"] = db["slice_index"][idx[:, : m["kk"]]]
                m["bound"] = vals[:, m["kk"]].astype(np.float32)
            self._buckets.append(m)

    def score_map(self, qi: int, thresh: float):
        """({sid: device score} over the fetched entries >= ``thresh``, an
        upper bound on every unfetched score) of query ``qi``: the host
        merge of the entries' top-k."""
        smap = {}
        bound = float("-inf")
        with trace.span("topk.merge"):
            for b in self._buckets:
                vq = b["vals"][qi]
                keep = vq >= thresh
                for sid, sc in zip(b["sids"][qi][keep], vq[keep]):
                    smap[int(sid)] = float(sc)
                bound = max(bound, float(b["bound"][qi]))
        return smap, bound

    def top_k_exactly_many(self, qis, k: int, min_score: float,
                           slack: float = 0.0, pool: bool = False):
        """[(top ids, {sid: device score})] per query with
        ``BruteForceEngine.top_k``'s tie-complete semantics over the
        device score matrices: the pool is every slice scoring >= the k-th
        largest value less ``slack`` (and >= ``min_score``).  A pool the
        per-bucket fetch may have truncated is completed by ONE select
        round (``above_vals_many``) for all such queries; fetching
        everything >= the provisional cut can only raise the k-th value,
        so the completed pool covers every slice >= the true cut.
        ``pool=True`` returns (the whole ordered pool, smap, an inclusive
        upper bound on every slice outside smap) instead."""
        smaps, cuts, bounds, unsafe = {}, {}, {}, []
        for qi in qis:
            smap, bound = self.score_map(qi, min_score)
            smaps[qi] = smap
            bounds[qi] = bound
            if smap:
                vals = np.fromiter(smap.values(), np.float32, len(smap))
                thr = (float(-np.partition(-vals, k - 1)[k - 1]) - slack
                       if len(vals) >= k else min_score)
                cuts[qi] = max(thr, min_score)
            else:
                cuts[qi] = min_score
            if bound >= cuts[qi]:
                unsafe.append(qi)
        # unfetched <= rest: the completion below fetches everything >= cut
        rests = {qi: min(bounds[qi], cuts[qi]) for qi in qis}
        if unsafe:
            found = self.above_vals_many(
                [(self.qview(qi), cuts[qi], set(smaps[qi])) for qi in unsafe])
            for qi, (_ids, vmap) in zip(unsafe, found):
                smaps[qi].update(vmap)
                vals = np.fromiter(smaps[qi].values(), np.float32, len(smaps[qi]))
                if len(vals) >= k:
                    cuts[qi] = max(float(-np.partition(-vals, k - 1)[k - 1]) - slack,
                                   min_score)
        out = []
        for qi in qis:
            smap, cut = smaps[qi], cuts[qi]
            cand = np.asarray([sid for sid, sc in smap.items() if sc >= cut], np.int64)
            if cand.size == 0:
                out.append(([], smap, rests[qi]) if pool else ([], smap))
                continue
            cvals = np.asarray([smap[int(c)] for c in cand], np.float32)
            order = order_by_score(self._engine.packed, cand, cvals)
            ids = [int(c) for c in cand[order]]
            out.append((ids, smap, rests[qi]) if pool else (ids[:k], smap))
        return out

    def flows_payload(self, qi: int, sid: int):
        """(H [S1, T1], S [L, Tmax] as the DP read it, Su [L, Tmax]
        unweighted, slice_len) for a candidate that was fetched with flow
        payloads, else None (caller rescores).  Under a document-side
        filter the blocks are the compacted slice's, and its length is the
        caller's to take (``filtered_positions``)."""
        for m in self._buckets:
            if not m.get("pay"):
                continue
            hit = np.flatnonzero(m["sids"][qi] == sid)
            if hit.size:
                p = int(hit[0])
                if p >= m["H"].shape[1]:
                    # deep-fetched tail candidate: its flow payload did not
                    # ride the transfer
                    return None
                ln = int(self._engine.packed.slice_len[sid])
                return m["H"][qi, p], m["S"][qi, p], m["Su"][qi, p], ln
        return None

    def qview(self, qi: int) -> "TopKView":
        return TopKView(self, qi)

    def covers_all(self, m: int) -> bool:
        # full buckets alone are NOT enough: ``initial`` truncates the
        # merged candidate list to m, so slices can be dropped whenever the
        # total fetched count exceeds m (they stay covered by rest_max and
        # the extras round)
        return all(b["full"] for b in self._buckets) and (
            sum(b["db"]["n"] for b in self._buckets) <= m
        )

    def initial(self, qi: int, m: int, thresh: float):
        """(candidate ids >= thresh among the m best, upper bound on every
        score outside them, their exact raw scores, or None from a source
        without an exact rescore) — the host merge of every entry's
        fetched top-k and (k+1)-th value."""
        with trace.span("topk.merge"):
            vals = np.concatenate([b["vals"][qi] for b in self._buckets])
            sids = np.concatenate([b["sids"][qi] for b in self._buckets])
            exact = (None if self.exact_ctx is None
                     else np.concatenate([b["exact"][qi] for b in self._buckets]))
            bound = max(
                (float(b["bound"][qi]) for b in self._buckets),
                default=float("-inf"),
            )
            keep = vals >= thresh
            sel = np.flatnonzero(keep)
            rest_max = bound
            if len(vals) > len(sel):
                rest_max = max(rest_max, float(np.max(vals[~keep])))
            if len(sel) > m:
                ap = np.argpartition(-vals[sel], m)
                rest_max = max(rest_max, float(vals[sel[ap[m]]]))
                sel = sel[ap[:m]]
            return ([int(c) for c in sids[sel]], rest_max,
                    None if exact is None else exact[sel])

    def _bucket_scores(self, bi: int):
        """(the bucket as its pass read it, its scores, a release fn) of
        pending entry ``bi``: a paged bucket is paged in again and its
        scores recomputed (the JAX package's re-paging fallback, correct
        and memory-bounded at the price of a bucket's pass); the caller
        reads what it needs to the host, then releases."""
        db, s = self._pending[bi]
        if isinstance(s, _LazyScores):
            view, scores = s.get()
            return view, scores, s.release
        return db, s, lambda: None

    def _column(self, bi: int, qi: int):
        key = (bi, qi)
        if key not in self._col_cache:
            db, scores, release = self._bucket_scores(bi)
            self._col_cache[key] = _host(scores[: db["n"], qi])
            release()
        return self._col_cache[key]

    def above_exact_many(self, reqs):
        """Per request (view, thresh, exclude): the ids with device score
        >= thresh not in ``exclude``, and {sid: exact raw f32 DP score} for
        the ids the select rescored.  Ids missing from the map (tie groups
        past ABOVE_CAP; every id of a source without an exact rescore)
        still need the finalizer's rescore."""
        if self.exact_ctx is None:
            return [(ids, {}) for ids, _ in self.above_vals_many(reqs)]
        with trace.span("above.exact"):
            return self._above_exact_many(reqs)

    def above_many(self, reqs):
        """The ids of ``above_exact_many`` alone (the submatch finalizer
        rescores them with flows)."""
        return [ids for ids, _ in self.above_exact_many(reqs)]

    def above_vals_many(self, reqs):
        """Like ``above_exact_many``, with {sid: device score} for every id
        (the map is complete: a column read whole has the values too) — for
        callers that rank on the device values (the transport metrics)."""
        with trace.span("above.vals"):
            return self._above_select(reqs, "vals")

    def _select_bucket(self, bi: int, cols: dict, sel: dict, raws: dict,
                       mode: str = "exact"):
        """The round's selects of bucket ``bi`` ({qi: f32 threshold}): per
        column the rows with score >= its threshold (ascending) and their
        exact raw scores (``mode`` "exact", all columns in ONE row-gather
        launch) or their device scores ("vals"); a column past ABOVE_CAP
        rows is read whole instead.  Two waits for the device: the counts,
        then the results."""
        db, scores, release = self._bucket_scores(bi)
        try:
            self._select_in(bi, db, scores, cols, sel, raws, mode)
        finally:
            release()

    def _select_in(self, bi, db, scores, cols, sel, raws, mode):
        ec = self.exact_ctx
        n = db["n"]
        dev = scores.device
        qis = list(cols)
        q_t = torch.as_tensor(qis, dtype=torch.int64, device=dev)
        thr = torch.as_tensor([cols[q] for q in qis], dtype=torch.float32,
                              device=dev)
        mask = scores[:n, q_t].T >= thr[:, None]  # [columns, n]
        counts = _host(mask.sum(1))
        fits = counts <= min(self.ABOVE_CAP, n)
        for c in np.flatnonzero(~fits):
            # a column past the cap is read whole (from these scores: a
            # paged bucket is on the device now)
            self._col_cache[(bi, qis[c])] = _host(scores[:n, qis[c]])
        keep = np.flatnonzero(fits)
        total = int(counts[keep].sum())
        rows_h, raw_h = np.empty((0,), np.int64), np.empty((0,), np.float32)
        if total:
            if len(keep) < len(qis):
                keep_t = torch.as_tensor(keep, dtype=torch.int64, device=dev)
                mask, q_t = mask[keep_t], q_t[keep_t]
            # (column, row) pairs, rows ascending within a column; the size
            # is the fetched count, so nonzero_static does not wait for one
            nz = torch.nonzero_static(mask, size=total)
            rows, qidx = nz[:, 1], q_t[nz[:, 0]]
            if mode == "vals":
                raw = scores[rows, qidx]
            else:
                raw = _rows_scores(
                    db["tokens"], rows, qidx, ec["table"], ec["V"],
                    db["lengths"][rows], ec["lt_q"][qidx], ec["gaps"],
                    ec["locality"], ec["general"], db.get("pos"), ec["tw"],
                )
            rows_h, raw_h = _host(rows), _host(raw)
        ends = np.cumsum(counts[keep])
        for c, end in zip(keep, ends):
            cnt = int(counts[c])
            sel[(bi, qis[c])] = rows_h[end - cnt : end]
            raws[(bi, qis[c])] = raw_h[end - cnt : end]

    def _above_exact_many(self, reqs):
        return self._above_select(reqs, "exact")

    def _above_select(self, reqs, mode: str):
        # the (bucket, query) columns this round selects, with the first
        # request's threshold of each query
        want: Dict[int, dict] = {}
        for view, thresh, _ in reqs:
            qi = view.qi
            for bi, b in enumerate(self._buckets):
                cols = want.setdefault(bi, {})
                if (
                    b["full"]
                    or float(b["bound"][qi]) < thresh
                    or (bi, qi) in self._col_cache
                    or qi in cols
                ):
                    continue
                cols[qi] = float(np.float32(thresh))
        sel, raws = {}, {}
        for bi, cols in want.items():
            if cols:
                self._select_bucket(bi, cols, sel, raws, mode)
        out = []
        for view, thresh, excl in reqs:
            qi = view.qi
            seen = set(excl)
            ids = []
            rmap = {}
            for bi, b in enumerate(self._buckets):
                hit_raws = None
                if not b["full"] and float(b["bound"][qi]) >= thresh:
                    db = self._pending[bi][0]
                    if (bi, qi) in sel:
                        hit = db["slice_index"][sel[(bi, qi)]]
                        hit_raws = raws[(bi, qi)]
                    else:
                        col = self._column(bi, qi)
                        pos_hit = np.flatnonzero(col >= thresh)
                        hit = db["slice_index"][pos_hit]
                        if mode == "vals":
                            hit_raws = col[pos_hit]
                else:
                    keep = b["vals"][qi] >= thresh
                    hit = b["sids"][qi][keep]
                    hit_raws = b["vals" if mode == "vals" else "exact"][qi][keep]
                for p, c in enumerate(hit):
                    c = int(c)
                    if c not in seen:
                        seen.add(c)
                        ids.append(c)
                        if hit_raws is not None:
                            rmap[c] = float(hit_raws[p])
            out.append((ids, rmap))
        return out


class TopKView:
    """Per-query view over a shared BucketTopKSource (the finalizer's
    items are per query; column selects batch through the parent)."""

    def __init__(self, src: BucketTopKSource, qi: int):
        self._src = src
        self.qi = qi

    @property
    def parent(self):
        return self._src

    def covers_all(self, m: int) -> bool:
        return self._src.covers_all(m)

    def initial(self, m: int, thresh: float):
        """(cand, rest_max) of ``initial_exact``."""
        return self._src.initial(self.qi, m, thresh)[:2]

    def initial_exact(self, m: int, thresh: float):
        """(cand, rest_max, exact raw scores) — the exact scores arrive
        with the fused top-k step (None from a source without one)."""
        return self._src.initial(self.qi, m, thresh)

    def flows_payload(self, sid: int):
        return self._src.flows_payload(self.qi, sid)


def batch_tracebacks(H, Sw, lens, lts, gaps, locality, w_s=None, w_t=None):
    """Native batched DP traceback with the per-row python fallback — the
    ONE home for flow extraction (payload and rescore paths must share it
    bit-for-bit).  ``w_s``/``w_t``: the raw cost vectors of a general gap
    model (general traceback), else None (affine).  Returns a [B] list of
    mappings, each [lts[i]] int32."""
    if w_s is not None:
        nat = native.traceback_general_batch(H, Sw, lens, lts, w_s, w_t, locality)
    else:
        nat = native.traceback_affine_batch(H, Sw, lens, lts, gaps, locality)
    if nat is not None:
        return [nat[i, : int(lts[i])] for i in range(len(lens))]
    if w_s is not None:
        return [
            traceback_general(
                H[i], Sw[i], int(lens[i]), int(lts[i]), w_s, w_t, locality
            )
            for i in range(len(lens))
        ]
    return [
        traceback(H[i], Sw[i], int(lens[i]), int(lts[i]), gaps, locality)
        for i in range(len(lens))
    ]


def edge_sims_of(mapping, Su, len_t: int) -> np.ndarray:
    """Per-edge unmodified similarity for an injective mapping
    (ScoreComputer, metric/alignment.h:307-352)."""
    return np.where(
        mapping >= 0,
        Su[np.maximum(mapping, 0), np.arange(len_t)],
        np.float32(0.0),
    ).astype(np.float32)


def _stacked_rescore(tokens, rows, qidx, table, ln, lt, gaps, V, locality,
                     want_flows, general=None, pos=None, tw=None):
    """Similarity gather (+ tag weights: ``tw`` the slots' arrays, ``pos``
    the rows' pos ids [n, L]) + DP for the rescore rows of MANY queries in
    one pass (``general``: the GeneralGaps of a non-affine model).
    Bit-exact vs the per-query arithmetic: the table rows are copies of
    each query's compiled plan matrix, and the DP recurrence is
    column-prefix-causal with (len_s, len_t)-masked reductions, so the pad
    columns of narrower queries never perturb a real cell's bits.  Without
    flows the gather stays inside the row-gather kernel.  Returns (raw, H,
    S weighted, S unweighted), the last three None without flows."""
    if not want_flows:
        raw = _rows_scores(tokens, rows, qidx, table, V, ln, lt, gaps,
                           locality, general, pos, tw)
        return raw, None, None, None
    S, Su = _mq_blocks(
        tokens[rows], None if tw is None else pos[rows], qidx, table, V, tw
    )
    H, raw = _mq_matrices_scores(
        S, ln, lt, gaps, locality,
        None if general is None else general.vecs(int(tokens.shape[1])),
    )
    return raw, H, S, Su


class BruteForceEngine:
    """Scores a PackedCorpus against compiled query plans.  Resident mode
    keeps the bucket arrays on ``device``; their pos and tag ids go there
    at the first query that needs them (tag weights, a document-side
    filter).

    ``paged=True`` (the JAX package's paged mode, for corpora whose arrays
    pass the card's memory) keeps every bucket's arrays, and the
    contextual stores, in pinned host memory and streams them through the
    device one bucket at a time: each corpus pass uploads a bucket,
    dispatches its scoring, reads what it needs to the host and evicts it
    (``_PagedBucket``, ``_LazyScores``, ``_drain``), bucket i+1's upload
    and dispatch issued before the host waits for bucket i.  The row paths
    (rescores, similarity rows, span encodes) upload the host rows they
    read and never a whole bucket.  Results are byte-identical to resident
    mode: the arrays and kernels are the same."""

    def __init__(self, packed, device="cuda", paged: bool = False):
        self._packed = packed
        self.device = torch.device(device)
        self.paged = bool(paged)
        self._pager = _Pager(self.device) if self.paged else None
        # contextual embedding name -> per bucket [n, L, d] bf16 vectors
        # (pinned host tensors when paged)
        self._ctx_stores: Dict[str, list] = {}
        # the buckets' rows and stores sharded over a mesh, per device set
        # (MeshSearch.bucket_shards, ctx_shards)
        self.mesh_shards: dict = {}
        self._device_buckets = []
        # slice id -> (bucket index, row) for O(1) rescore lookups
        self._slice_loc = np.full((packed.n_slices, 2), -1, np.int32)
        for bi, b in enumerate(packed.buckets):
            self._slice_loc[b.slice_index, 0] = bi
            self._slice_loc[b.slice_index, 1] = np.arange(b.n, dtype=np.int32)
            fields = {"bi": bi, "capacity": b.capacity,
                      "slice_index": b.slice_index, "n": b.n}
            if self.paged:
                self._device_buckets.append(
                    _PagedBucket(fields, narrow_planes(b, self._pager), self._pager))
            else:
                fields.update(tokens=self._put(b.token_ids), lengths=self._put(b.lengths))
                self._device_buckets.append(fields)

    def _put(self, arr) -> torch.Tensor:
        return torch.as_tensor(
            np.ascontiguousarray(arr, np.int32), device=self.device
        )

    @property
    def uploaded_bytes(self) -> int:
        """Host -> device bytes a paged engine has uploaded (0 resident)."""
        return 0 if self._pager is None else self._pager.bytes

    def _bucket_ids(self, db, key: str) -> torch.Tensor:
        """The bucket's "pos" (int8) or "tag" (int16) ids [n, L] on the
        device, uploaded at the first call that needs them (a paged
        bucket's until it is evicted)."""
        if isinstance(db, _PagedBucket):
            return db[key]
        if key not in db:
            b = self._packed.buckets[db["bi"]]
            arr = b.pos_ids if key == "pos" else b.tag_ids
            db[key] = torch.as_tensor(np.ascontiguousarray(arr), device=self.device)
        return db[key]

    def _live_buckets(self):
        return [db for db in self._device_buckets if db["n"]]

    def _pass_view(self, db, flt, with_pos: bool) -> dict:
        """The bucket as one call's corpus pass reads it: its fields with
        "tokens", "lengths" and (with ``with_pos``) "pos", compacted under
        the filter's device masks ``flt`` (once a call: every query of a
        batch shares the filter)."""
        view = {k: db[k] for k in ("bi", "capacity", "slice_index", "n",
                                   "tokens", "lengths")}
        if with_pos or flt is not None:
            view["pos"] = self._bucket_ids(db, "pos")
        if flt is not None:
            view["tokens"], view["pos"], view["lengths"] = compact_rows(
                view["tokens"], view["pos"], self._bucket_ids(db, "tag"),
                view["lengths"], flt)
        return view

    def collect(self, pending, Q: int = 1) -> np.ndarray:
        """[n_slices, Q] host scores of a corpus pass's pending list of [n,
        Q] (or, Q = 1, [n]) scores, NEG_SCORE for an empty slice; paged
        buckets drained one at a time (the JAX package's
        ``_collect_pending``)."""
        out = np.full((self.n_slices, Q), NEG_SCORE, np.float32)
        for (db, _), (sc,) in zip(pending, _drain(pending, lambda db, sc: [sc])):
            out[db["slice_index"]] = sc.reshape(-1, Q)
        return out

    def count_tokens(self, mask) -> np.ndarray:
        """[n_slices] int64: per slice, how many of its tokens ``mask`` ([V]
        bool over token ids) holds, one gather a bucket where the buckets
        live (a booster's keyword counts; a paged bucket is paged in and
        evicted)."""
        m = torch.as_tensor(np.asarray(mask, bool), device=self.device)
        out = np.zeros((self.n_slices,), np.int64)
        for db in self._live_buckets():
            live = (torch.arange(db["capacity"], device=self.device)[None, :]
                    < db["lengths"][:, None])
            out[db["slice_index"]] = _host((m[db["tokens"]] & live).sum(1))
            if self.paged:
                db.evict()
        return out

    def rows_to_device(self, bi: int, key, rows) -> torch.Tensor:
        """Bucket ``bi``'s ``rows`` (host indices or a slice) of "tokens"
        (int32), "lengths", "pos", "tag" or ("ctx", name) uploaded from the
        host copies: the row paths of a paged engine, which never page a
        whole bucket for a few rows."""
        if isinstance(key, tuple):
            host = self._ctx_stores[key[1]][bi]
            idx = rows if isinstance(rows, slice) else torch.as_tensor(
                np.asarray(rows, np.int64))
            return host[idx].to(self.device)
        b = self._packed.buckets[bi]
        arr = {"tokens": b.token_ids, "lengths": b.lengths, "pos": b.pos_ids,
               "tag": b.tag_ids}[key]
        out = arr[rows] if isinstance(rows, slice) else arr[np.asarray(rows, np.int64)]
        if key in ("tokens", "lengths"):
            out = out.astype(np.int32)
        return torch.as_tensor(np.ascontiguousarray(out), device=self.device)

    def filtered_positions(self, sid: int, doc_filter) -> np.ndarray:
        """Host replica of the device compaction for one slice: the
        original in-slice offsets of its kept tokens."""
        ln = int(self._packed.slice_len[sid])
        if doc_filter is None:
            return np.arange(ln, dtype=np.int32)
        bi, r = self._slice_loc[sid]
        b = self._packed.buckets[bi]
        keep = (
            ~doc_filter.pos_exclude[b.pos_ids[r, :ln]]
            & ~doc_filter.tag_exclude[b.tag_ids[r, :ln]]
            & ~doc_filter.token_exclude[b.token_ids[r, :ln]]
        )
        return np.flatnonzero(keep).astype(np.int32)

    @property
    def packed(self):
        return self._packed

    @property
    def n_slices(self):
        return self._packed.n_slices

    def ensure_contextual(self, name: str, documents, dim: int):
        """Pack the per-token contextual vectors of ``name`` into one [n, L,
        d] store a bucket, bf16 on the device (the reference opens each
        document's vectors per query, metric/contextual.cpp:26-75); built
        once.  Every document's vectors concatenate into one flat f32 host
        matrix; each bucket then fills by one masked gather, a block of
        rows at a time, rounded to bf16 (nearest even, as the JAX package's
        store) as it goes up."""
        if name in self._ctx_stores:
            return
        packed = self._packed
        parts, offs, n_vecs, off = [], [], [], 0
        for pd in documents:
            vecs = pd.contextual.get(name)
            offs.append(off)
            n_vecs.append(0 if vecs is None else len(vecs))
            if vecs is not None and len(vecs):
                parts.append(np.asarray(vecs, np.float32))
                off += len(vecs)
        flat = np.concatenate(parts, 0) if parts else np.zeros((1, dim), np.float32)
        del parts
        offs = np.asarray(offs or [0], np.int64)
        n_vecs = np.asarray(n_vecs or [0], np.int64)
        # a document's vector table must cover its slices' tokens: a
        # clamped gather would read a neighbour's vectors
        ends = packed.slice_start + packed.slice_len
        bad = np.flatnonzero(
            (n_vecs[packed.slice_doc] > 0) & (ends > n_vecs[packed.slice_doc])
        )
        if bad.size:
            sid = int(bad[0])
            raise ValueError(
                f"contextual embedding {name!r}: document "
                f"{int(packed.slice_doc[sid])} has "
                f"{int(n_vecs[packed.slice_doc[sid]])} vectors but slice "
                f"{sid} needs tokens up to {int(ends[sid])}"
            )
        has = n_vecs > 0
        store = []
        for db in self._device_buckets:
            L, n = db["capacity"], db["n"]
            if self.paged:
                # pinned host bf16 (round to nearest even, as the card's
                # conversion: paged = resident bit for bit)
                out = self._pager.empty((n, L, dim), torch.bfloat16)
            else:
                out = torch.empty((n, L, dim), dtype=torch.bfloat16, device=self.device)
            step = max(1, (64 << 20) // (L * max(dim, 1) * 4))
            for r0 in range(0, n, step):
                sids = db["slice_index"][r0 : r0 + step]
                docs = packed.slice_doc[sids]
                starts = offs[docs] + packed.slice_start[sids]
                lens = packed.slice_len[sids] * has[docs]
                mask = np.arange(L)[None, :] < lens[:, None]
                idx = np.minimum(
                    np.where(mask, starts[:, None] + np.arange(L)[None, :], 0),
                    len(flat) - 1,
                )
                block = torch.from_numpy(
                    np.where(mask[:, :, None], flat[idx], np.float32(0.0)))
                out[r0 : r0 + len(sids)] = block.to(out.device).to(torch.bfloat16)
            store.append(out)
        self._ctx_stores[name] = store

    def _ctx_dev(self, name: str, bi: int) -> torch.Tensor:
        """Bucket ``bi``'s [n, L, d] bf16 store of embedding ``name`` on the
        device: a paged engine uploads it fresh, evicted with the bucket."""
        store = self._ctx_stores[name][bi]
        if self.paged:
            return self._device_buckets[bi].page(("ctx", name), store)
        return store

    def _dense_view(self, db, ctx_names, with_pos: bool, with_tag: bool) -> dict:
        """The bucket as a dense pass reads it (``dense_scores``' view): its
        fields, its contextual stores of ``ctx_names`` under "ctx", and its
        pos and tag ids where the pass reads them (a paged bucket pages
        each in)."""
        view = {k: db[k] for k in ("bi", "capacity", "slice_index", "n",
                                   "tokens", "lengths")}
        view["ctx"] = {nm: self._ctx_dev(nm, db["bi"]) for nm in ctx_names}
        if with_pos:
            view["pos"] = self._bucket_ids(db, "pos")
        if with_tag:
            view["tag"] = self._bucket_ids(db, "tag")
        return view

    def _dense_pass(self, run, ctx_names, with_pos: bool, with_tag: bool):
        """The pending list [(bucket, normalized scores [n, Q] on the
        device)] of a corpus pass over dense blocks (lazy entries when
        paged): ``run(view)`` of each live bucket's ``_dense_view``."""
        return [_pending_entry(db, lambda db=db: (db, run(self._dense_view(
                    db, ctx_names, with_pos, with_tag))), self.paged)
                for db in self._live_buckets()]

    def _plan_pass(self, qp, len_t: int, gaps, locality: str,
                   norm_total: float, gap_costs=None, tag_weights=None,
                   doc_filter=None, boost=None):
        """The single-query corpus pass of a plan with a contextual leaf:
        the pending list of ``_dense_pass`` at Q = 1 (scores [n, 1]), a
        chunk's block made by ``eval_plan_chunk`` — the JAX package's
        ``_bucket_scores`` arithmetic."""
        dev = self.device
        T = qp.width
        general = (None if gap_costs is None
                   else GeneralGaps(gap_costs, T + 1, dev))
        lt = torch.as_tensor([len_t], dtype=torch.int32, device=dev)
        nt = torch.as_tensor([norm_total], dtype=torch.float32, device=dev)
        rewrite = None
        if tag_weights is not None:
            tw = tuple(torch.as_tensor(np.asarray(a), device=dev) for a in (
                np.asarray(tag_weights.t_pos_weights, np.float32)[:T],
                np.asarray(tag_weights.pos_t, np.int8)[:T],
                np.float32(tag_weights.pos_mismatch_penalty),
                np.float32(tag_weights.similarity_threshold),
            ))

            def rewrite(S, pos):
                c = S.shape[0]
                return tag_weighted(S[..., 0], pos, tw[0].expand(c, T),
                                    tw[1].expand(c, T), tw[2].expand(c),
                                    tw[3].expand(c))[..., None]

        def block(view, c0, c1):
            ctx = tuple(view["ctx"][nm][c0:c1] for nm in qp.ctx_names)
            return eval_plan_chunk(qp, view["tokens"][c0:c1], ctx)["similarity"][..., None]

        bvec = (None if boost is None else
                torch.as_tensor(np.asarray(boost, np.float32), device=dev))
        d = max(int(v.unmodified.shape[1]) for v in qp.ctx_vectors)
        flt = None if doc_filter is None else doc_filter.device_args(dev)

        def run(view):
            b = None
            if bvec is not None:
                sids = torch.as_tensor(view["slice_index"], device=dev)
                b = bvec[sids.long()][:, None]
            return dense_scores(view, block, T, 1, d, lt, gaps, locality, nt,
                                general, flt, rewrite, b)

        return self._dense_pass(run, qp.ctx_names,
                                flt is not None or rewrite is not None, flt is not None)

    def score_all(self, qp, len_t: int, gaps, locality: str,
                  norm_total: float, boost=None, tag_weights=None,
                  doc_filter=None, gap_costs=None) -> np.ndarray:
        """Normalized device score of every slice ([n_slices] f32 on the
        host; NEG_SCORE for an empty one): one query's full-read corpus
        pass, on the kernels (a static plan: the gather entries at Q = 1;
        a contextual or mixed plan: ``_plan_pass``).  ``boost`` [n_slices]
        multiplies the normalized scores."""
        with trace.span("score_all"):
            if qp.is_static_only:
                return self.score_all_multi(
                    [qp], [len_t], gaps, locality, [norm_total],
                    tag_weights=None if tag_weights is None else [tag_weights],
                    gap_costs=gap_costs, doc_filter=doc_filter,
                    boosts=None if boost is None else [boost],
                )[:, 0]
            return self.collect(self._plan_pass(
                qp, len_t, gaps, locality, norm_total, gap_costs, tag_weights,
                doc_filter, boost))[:, 0]

    def score_all_multi(self, plans, len_ts, gaps, locality: str, norm_totals,
                        tag_weights=None, sim_dtype=None, with_err: bool = False,
                        gap_costs=None, doc_filter=None, boosts=None):
        """[n_slices, Q] normalized device scores of Q static plans in one
        corpus pass (``_dispatch_multi``: one kernel launch a bucket),
        fetched whole (NEG_SCORE for an empty slice); with ``with_err``
        also the ranking table's per-entry rounding bound."""
        pending, err = self._dispatch_multi(
            plans, len_ts, gaps, locality, norm_totals, gap_costs, sim_dtype,
            tag_weights, doc_filter, boosts,
        )
        out = self.collect(pending, len(plans))
        return (out, err) if with_err else out

    def score_topk(self, qp, len_t: int, gaps, locality: str,
                   norm_total: float, k: int, min_score: float = 0.2,
                   boost=None, tag_weights=None, doc_filter=None,
                   gap_costs=None, with_next: bool = False):
        """The k best slices by device score at or above ``min_score``, in
        the reference's order (score desc, doc, slice), from the full read
        (``score_all``): (ids, {id: score}); with ``with_next`` also the
        best device score of every slice NOT returned (-inf if none) — the
        overfetch-safety bound of the rescoring paths."""
        scores = self.score_all(qp, len_t, gaps, locality, norm_total, boost,
                                tag_weights, doc_filter, gap_costs)
        top = self.top_k(scores, k, min_score)
        score_map = {i: float(scores[i]) for i in top}
        if not with_next:
            return top, score_map
        rest = scores.copy()
        rest[np.asarray(top, np.int64)] = -np.inf
        return top, score_map, float(rest.max()) if rest.size else float("-inf")

    def top_k(self, scores: np.ndarray, k: int, min_score: float = 0.2) -> List[int]:
        """Deterministic top-k of a host score vector in the reference's
        order (score desc, doc, slice — match_impl.h:8-42): the pool is
        EVERY slice scoring >= the k-th largest value, so a tie group at the
        boundary resolves by the (doc, slice) order."""
        n = scores.shape[0]
        if n == 0 or k <= 0:
            return []
        k = min(k, n)
        thr = -np.partition(-scores, k - 1)[k - 1]
        cand = np.flatnonzero(scores >= max(thr, min_score))
        order = order_by_score(self._packed, cand, scores[cand])
        return [int(c) for c in cand[order][:k]]

    def top_k_with_next(self, scores: np.ndarray, m: int, thresh: float):
        """Unordered candidate ids with score >= ``thresh`` among the m
        largest, and the best score OUTSIDE the returned set (-inf when the
        set holds every slice above ``thresh``): any slice not returned
        scores at most that."""
        n = scores.shape[0]
        if m >= n:
            cand = np.flatnonzero(scores >= thresh)
            return [int(c) for c in cand], float("-inf")
        ap = np.argpartition(-scores, m)
        cand = ap[:m]
        kept = cand[scores[cand] >= thresh]
        if len(kept) < m:
            # the partition's boundary is below thresh: so is everything
            # it excluded
            return [int(c) for c in kept], float("-inf")
        return [int(c) for c in kept], float(scores[ap[m]])

    def tree_pass(self, plans, len_ts, gaps, locality: str, norm_totals,
                  gap_costs=None, doc_filter=None, tag_weights=None, boosts=None):
        """The pending list [(bucket, [n, Q] normalized scores on the
        device)] of Q plans of one modifier tree with a contextual leaf (one
        contextual embedding, or mixed static + contextual leaves) in one
        corpus pass (the JAX package's ``score_all_multi_tree``, and its
        ``score_all_multi_ctx`` for the one-leaf plan ("ctx", 0, metric):
        the same single GEMM a chunk, before the fetch):
        ``_dense_pass`` of a ``TreePass`` on the engine's device, the
        scores multiplied by ``boosts`` (as in ``_dispatch_multi``).  The
        contextual stores must be packed already."""
        tp = TreePass(plans, len_ts, gaps, locality, norm_totals, self.device,
                      gap_costs, doc_filter, tag_weights)

        def run(view):
            return tp.scores(view, None if boosts is None
                             else self._boost_matrix(view, boosts))

        with trace.span("tree.dispatch"):
            return self._dense_pass(run, tp.sp.ctx_names, tp.with_pos,
                                    tp.flt is not None)

    def _plan_rows_similarity(self, bi: int, rows, sels, qp, tag_weights=None):
        """(S weighted [g, L, T], S unweighted) of bucket ``bi``'s ``rows``
        under a plan (static or contextual), each row compacted to its kept positions
        ``sels`` (a document-side filter; None keeps the rows): the exact
        rescore's evaluation, in blocks of RESCORE_ROWS token rows."""
        db = self._device_buckets[bi]
        dev = self.device
        if self.paged:
            tok = self.rows_to_device(bi, "tokens", rows)
            ctx = [self.rows_to_device(bi, ("ctx", nm), rows) for nm in qp.ctx_names]
            pos = None if tag_weights is None else self.rows_to_device(bi, "pos", rows)
        else:
            rows_t = torch.as_tensor(np.asarray(rows, np.int64), device=dev)
            tok = db["tokens"][rows_t]
            ctx = [self._ctx_dev(nm, bi)[rows_t] for nm in qp.ctx_names]
            pos = None if tag_weights is None else self._bucket_ids(db, "pos")[rows_t]
        if sels is not None:
            sel_pad = np.zeros((len(sels), db["capacity"]), np.int64)
            for k, sel in enumerate(sels):
                sel_pad[k, : len(sel)] = sel
            sel_t = torch.as_tensor(sel_pad, device=dev)
            tok = torch.gather(tok, 1, sel_t)
            ctx = [torch.gather(c, 1, sel_t[:, :, None].expand(-1, -1, c.shape[2]))
                   for c in ctx]
            if pos is not None:
                pos = torch.gather(pos, 1, sel_t)
        S = eval_plan_chunk(qp, tok, tuple(ctx), rows_block=RESCORE_ROWS)["similarity"]
        if tag_weights is None:
            return S, S
        g, T = S.shape[0], S.shape[2]
        w, p, pen, thr = (torch.as_tensor(np.asarray(a), device=dev) for a in (
            np.asarray(tag_weights.t_pos_weights, np.float32)[:T],
            np.asarray(tag_weights.pos_t, np.int8)[:T],
            np.float32(tag_weights.pos_mismatch_penalty),
            np.float32(tag_weights.similarity_threshold),
        ))
        return tag_weighted(S, pos, w.expand(g, T), p.expand(g, T), pen.expand(g),
                            thr.expand(g)), S

    def batch_slice_similarity(self, sids, qp, tag_weights=None, sels=None):
        """[(S weighted [len_i, T], S unweighted)] host arrays of many
        slices, one evaluation a touched bucket (``sels``: each slice's
        kept positions under a document-side filter, else None)."""
        out = [None] * len(sids)
        by_bucket: Dict[int, list] = {}
        for j, sid in enumerate(sids):
            by_bucket.setdefault(int(self._slice_loc[sid, 0]), []).append(j)
        for bi, js in by_bucket.items():
            if bi < 0:
                raise KeyError(sids[js[0]])
            rows = [self._slice_loc[sids[j], 1] for j in js]
            S, Su = self._plan_rows_similarity(
                bi, rows, None if sels is None else [sels[j] for j in js],
                qp, tag_weights)
            S, Su = _host(S), _host(Su)
            for k, j in enumerate(js):
                ln = (len(sels[j]) if sels is not None
                      else int(self._packed.slice_len[sids[j]]))
                out[j] = (S[k, :ln], Su[k, :ln])
        return out

    def slice_similarity(self, sid: int, qp, tag_weights=None, sel=None):
        """(S weighted [len, T], S unweighted) of one slice (``sel``: its
        kept positions under a document-side filter)."""
        return self.batch_slice_similarity(
            [sid], qp, tag_weights, None if sel is None else [sel])[0]

    def rescore_scores(self, slice_ids, qp, len_t: int, gaps, locality: str,
                       tag_weights=None, doc_filter=None, gap_costs=None):
        """Exact f32 raw DP scores [k] of the chosen slices without flows —
        the score-only half of the finalizer; the same bits as
        ``rescore_with_flows``' scores."""
        (res,) = self.rescore_many(
            [{"slice_ids": slice_ids, "qp": qp, "len_t": len_t,
              "tag_weights": tag_weights, "want_flows": False}],
            gaps, locality, gap_costs=gap_costs, doc_filter=doc_filter,
        )
        return res[2]

    def rescore_with_flows(self, slice_ids, qp, len_t: int, gaps, locality: str,
                           tag_weights=None, doc_filter=None, gap_costs=None,
                           on_sims=None, with_scores: bool = False):
        """The DP matrices of the chosen slices and their injective flows by
        host traceback (the reference's finalizer pass,
        matcher_impl.h:172-174); mappings in original in-slice offsets
        under a document-side filter.  Returns (mappings, per-edge
        unmodified similarities); with ``with_scores`` also the exact f32
        raw scores.  ``on_sims(sid, S weighted, S unweighted)`` observes
        each slice's similarity block (``debug``'s hook)."""
        (res,) = self.rescore_many(
            [{"slice_ids": slice_ids, "qp": qp, "len_t": len_t,
              "tag_weights": tag_weights, "want_flows": True,
              "on_sims": on_sims}],
            gaps, locality, gap_costs=gap_costs, doc_filter=doc_filter,
        )
        mappings, edge_sims, raw = res
        return (mappings, edge_sims, raw) if with_scores else (mappings, edge_sims)

    def _dispatch_multi(self, plans, len_ts, gaps, locality, norm_totals,
                        gap_costs=None, sim_dtype=None, tag_weights=None,
                        doc_filter=None, boosts=None):
        """Dispatch half of the multi-query corpus pass: ([(bucket as the
        pass read it, scores [n, Q] left on the device)], one kernel launch
        per bucket; the quantization entry error, 0.0 for f32).  The
        index's gap model is shared by every query in the batch: ONE [L +
        1] / [Tpad + 1] cost-vector pair per bucket serves all Q (the DP
        masks columns past each query's len_t).  ``sim_dtype``: None (f32),
        "bfloat16" or "int8" ranking table (``stack_query_tables``).
        ``tag_weights``: a TagWeightingSpec or None per query (any set
        forces f32: ValueError with ``sim_dtype``); ``doc_filter``: the
        batch's DocFilterSpec; ``boosts``: per query an [n_slices] f32
        multiplier of its normalized ranking scores, or None."""
        with_tags = tag_weights is not None and any(
            tw is not None for tw in tag_weights
        )
        if sim_dtype is not None and with_tags:
            raise ValueError("quantized ranking requires tag_weights=None")
        with trace.span("topk.tables"):
            sim_multi, sim_scale, max_abs, Tpad = stack_query_tables(
                plans, len_ts, sim_dtype
            )
            mp = MultiQueryPass(
                sim_multi, sim_scale, len_ts, gaps, gap_costs, norm_totals,
                self.device,
                corpus_tag_columns(tag_weights, len(plans), Tpad) if with_tags else None,
            )
        flt = None if doc_filter is None else doc_filter.device_args(self.device)

        def run(db):
            view = self._pass_view(db, flt, with_tags)
            return view, mp.scores(
                view["tokens"], view["lengths"], locality, view.get("pos"),
                None if boosts is None else self._boost_matrix(db, boosts),
            )

        t_disp0 = time.perf_counter()
        pending = [_pending_entry(db, lambda db=db: run(db), self.paged)
                   for db in self._live_buckets()]
        trace.add("topk.dispatch", time.perf_counter() - t_disp0)
        return pending, quantization_entry_err(sim_dtype, max_abs)

    def _boost_matrix(self, db, boosts):
        """The bucket's [n, Q] boost multipliers: column q is ``boosts[q]``
        of the bucket's slices, 1 where a query has none (the JAX package's
        ``bmat[:n, q] = b[slice_index]``).  A booster's weights do not
        depend on the query, so the queries of a call share one array: one
        [n] upload a distinct array, spread over its columns on the
        device."""
        Q = len(boosts)
        bmat = torch.ones((db["n"], Q), dtype=torch.float32, device=self.device)
        done = set()
        for b in boosts:
            if b is None or id(b) in done:
                continue
            done.add(id(b))
            cols = [qi for qi, bq in enumerate(boosts) if bq is b]
            col = torch.as_tensor(
                np.asarray(b, np.float32)[db["slice_index"]], device=self.device
            )
            bmat[:, cols] = col[:, None]
        return bmat

    def score_topk_multi(
        self, plans, len_ts: List[int], gaps, locality: str,
        norm_totals: List[float], k: int, gap_costs=None, sim_dtype=None,
        with_err: bool = False, tag_weights=None, doc_filter=None,
        boosts=None,
    ):
        """Multi-query corpus pass with DEVICE-SIDE per-bucket top-k: only
        O(buckets * Q * k) (score, id, exact raw) triples reach the host.
        ``gap_costs``: (GapCost_s, GapCost_t) of a non-affine gap model
        (the WSB DP; ``gaps`` is then an unused placeholder), else None.
        ``sim_dtype``: the ranking table's type (None: f32, "bfloat16",
        "int8"); the fused rescore, the extras round and ``rescore_many``
        read the f32 plan table all the same, so every score that reaches a
        ``Match`` is exact.  ``tag_weights``, ``doc_filter`` and ``boosts``
        as in ``_dispatch_multi``; the fused rescore and the extras round
        read the same rewritten rows (the boosts stay out of the raw
        scores: the finalizer applies them).  Returns the
        ``BucketTopKSource`` the finalizer consumes, and with ``with_err``
        also the table's max per-entry rounding
        (``quantization_entry_err``; the finalizer's slack)."""
        pending, entry_err = self._dispatch_multi(
            plans, len_ts, gaps, locality, norm_totals, gap_costs, sim_dtype,
            tag_weights, doc_filter, boosts,
        )
        table, V, Tmax = self._stacked_plan_tables(plans)
        tw = None
        if tag_weights is not None and any(t is not None for t in tag_weights):
            tw = _put_all(tag_arrays(
                stack_tag_slots(tag_weights, len(plans), Tmax)), self.device)
        exact_ctx = {
            "table": table,
            "V": V,
            "Tmax": Tmax,
            "lt_q": torch.as_tensor(
                np.asarray(len_ts, np.int64), device=self.device
            ),
            "gaps": gaps,
            "general": (
                None if gap_costs is None
                else GeneralGaps(gap_costs, Tmax + 1, self.device)
            ),
            "locality": locality,
            "tw": tw,
        }
        src = BucketTopKSource(self, pending, len(plans), k, exact_ctx)
        return (src, entry_err) if with_err else src

    @staticmethod
    def _stacked_plan_tables(qps):
        """Stack the plans' [V, T] matrices into one flat [Q * V, Tmax]
        gather table (row ``slot * V + token``, slot = position in
        ``qps``); a single plan of the full width IS the table.  Pure
        copies, so gathered values are bit-identical to per-query gathers.
        Returns (table, V, Tmax)."""
        mats = [qp.matrix for qp in qps]
        V = int(mats[0].shape[0])
        if any(int(m.shape[0]) != V for m in mats):
            raise ValueError("query plans of different vocabularies")
        Tmax = max(int(m.shape[1]) for m in mats)
        if len(mats) == 1:
            return mats[0], V, Tmax
        table = torch.stack(
            [F.pad(m, (0, Tmax - int(m.shape[1]))) for m in mats], dim=0
        ).reshape(len(mats) * V, Tmax)
        return table, V, Tmax

    def rescore_many(self, requests: List[dict], gaps, locality: str,
                     chunk: int = 8192, gap_costs=None, doc_filter=None):
        with trace.span("rescore_many"):
            return self._rescore_many(requests, gaps, locality, chunk,
                                      gap_costs, doc_filter)

    def _rescore_many(self, requests, gaps, locality, chunk, gap_costs,
                      doc_filter):
        """Exact f32 rescore for MANY independent candidate sets (one per
        query): one gather + DP per touched bucket for the whole batch
        (``gap_costs`` as in ``score_topk_multi``).

        Each request: {slice_ids, qp, len_t, want_flows, tag_weights (a
        TagWeightingSpec, or None), on_sims (optional observer of each
        slice's (sid, S weighted, S unweighted))}.  ``doc_filter`` (the
        index-level DocFilterSpec, or None) compacts each slice on the host
        (``filtered_positions``; a slice it empties scores NEG_SCORE) and
        its mappings are translated back to original slice offsets.
        Static plans stack into one gather table (``_stacked_rescore``); a
        contextual plan's request evaluates its rows per bucket
        (``_plan_rows_similarity``) and runs the same DP.  Returns
        per-request (mappings, edge_sims, raw_scores); mappings/edge_sims
        are -1/0 placeholders for score-only requests."""
        slot = {}  # request index -> stacked table slot (live requests)
        states = []
        pairs = []  # (request index, candidate position, slice id)
        for ri, req in enumerate(requests):
            slice_ids = [int(s) for s in req["slice_ids"]]
            len_t = req["len_t"]
            k = len(slice_ids)
            sels = [self.filtered_positions(sid, doc_filter) for sid in slice_ids]
            states.append(
                {
                    "len_t": len_t,
                    "want_flows": req.get("want_flows", True),
                    "on_sims": req.get("on_sims"),
                    "slice_ids": slice_ids,
                    "mappings": [np.full((len_t,), -1, np.int32) for _ in range(k)],
                    "edge_sims": [np.zeros((len_t,), np.float32) for _ in range(k)],
                    "raw": np.full((k,), NEG_SCORE, np.float32),
                    "sels": sels,
                }
            )
            if k == 0:
                continue
            slot[ri] = len(slot)
            pairs.extend(
                (ri, j, sid) for j, sid in enumerate(slice_ids) if len(sels[j])
            )
        if not pairs:
            return [(st["mappings"], st["edge_sims"], st["raw"]) for st in states]
        if all(requests[ri]["qp"].is_static_only for ri in slot):
            groups = self._stacked_groups(requests, states, slot, pairs, gaps,
                                          locality, chunk, gap_costs, doc_filter)
        else:
            groups = self._plan_groups(requests, states, pairs, gaps, locality,
                                       chunk, gap_costs, doc_filter)

        with trace.span("rescore.fetch"):
            fetched = [
                (cap, Tw, pc, *(None if t is None else _host(t) for t in out))
                for cap, Tw, pc, out in groups
            ]
        for cap, Tw, pc, raw_np, H_np, Sw_np, Su_np in fetched:
            maps = None
            if H_np is not None:
                lens = np.asarray(
                    [len(states[ri]["sels"][j]) for ri, j, _ in pc], np.int32
                )
                lts = np.asarray([states[ri]["len_t"] for ri, _, _ in pc], np.int32)
                w_s = w_t = None
                if gap_costs is not None:
                    w_s = gap_vec(gap_costs[0], cap + 1)
                    w_t = gap_vec(gap_costs[1], Tw + 1)
                maps = batch_tracebacks(
                    H_np, Sw_np, lens, lts, gaps, locality, w_s=w_s, w_t=w_t
                )
            for pos_i, (ri, j, sid) in enumerate(pc):
                st = states[ri]
                st["raw"][j] = raw_np[pos_i]
                if not st["want_flows"]:
                    continue
                sel = st["sels"][j]
                if st["on_sims"] is not None:
                    st["on_sims"](sid, Sw_np[pos_i, : len(sel), : st["len_t"]],
                                  Su_np[pos_i, : len(sel), : st["len_t"]])
                mapping = maps[pos_i]
                st["edge_sims"][j] = edge_sims_of(mapping, Su_np[pos_i], st["len_t"])
                st["mappings"][j] = np.where(
                    mapping >= 0, sel[np.maximum(mapping, 0)], -1
                ).astype(np.int32)
        return [(st["mappings"], st["edge_sims"], st["raw"]) for st in states]

    def _stacked_groups(self, requests, states, slot, pairs, gaps, locality,
                        chunk, gap_costs, doc_filter):
        """The static requests' rescore: their plans stacked into one
        gather table, one gather + DP a touched bucket (a chunk) for all
        of them: [(capacity, Tmax, pairs, (raw, H, S weighted, S
        unweighted))]."""
        table, V, Tmax = self._stacked_plan_tables(
            [requests[ri]["qp"] for ri in slot]
        )
        general = (
            None if gap_costs is None
            else GeneralGaps(gap_costs, Tmax + 1, self.device)
        )
        tws = [requests[ri].get("tag_weights") for ri in slot]
        tw = None
        if any(t is not None for t in tws):
            tw = _put_all(tag_arrays(stack_tag_slots(tws, len(tws), Tmax)),
                          self.device)
        want_flows = any(states[ri]["want_flows"] for ri in slot)
        groups = []
        for bi, plist in self._by_bucket(pairs).items():
            db = self._device_buckets[bi]
            for c0 in range(0, len(plist), chunk):
                pc = plist[c0 : c0 + chunk]
                sels = [states[ri]["sels"][j] for ri, j, _ in pc]
                cols = {
                    "rows": [self._slice_loc[sid, 1] for _, _, sid in pc],
                    "qix": [slot[ri] for ri, _, _ in pc],
                    "ln": [len(sel) for sel in sels],
                    "lt": [requests[ri]["len_t"] for ri, _, _ in pc],
                }
                rows, qix, ln, lt = (
                    torch.as_tensor(np.asarray(cols[c], np.int64), device=self.device)
                    for c in ("rows", "qix", "ln", "lt")
                )
                if doc_filter is not None:
                    # the compacted rows, gathered on the host: kept tokens
                    # first, in order (the rows past a slice's length are
                    # never read)
                    tokens, pos = self._compacted_rows(bi, cols["rows"], sels,
                                                       tw is not None)
                    rows = torch.arange(len(pc), device=self.device)
                elif self.paged:
                    # the candidates' host rows, never the whole bucket
                    tokens = self.rows_to_device(bi, "tokens", cols["rows"])
                    pos = (None if tw is None
                           else self.rows_to_device(bi, "pos", cols["rows"]))
                    rows = torch.arange(len(pc), device=self.device)
                else:
                    tokens = db["tokens"]
                    pos = None if tw is None else self._bucket_ids(db, "pos")
                out = _stacked_rescore(
                    tokens, rows, qix, table, ln, lt, gaps, V,
                    locality, want_flows, general, pos, tw,
                )
                groups.append((db["capacity"], Tmax, pc, out))
        return groups

    def _plan_groups(self, requests, states, pairs, gaps, locality, chunk,
                     gap_costs, doc_filter):
        """The rescore of requests with contextual plans: per touched bucket
        (a chunk of pairs) each request's rows evaluated under its own plan
        (``_plan_rows_similarity``), zero-padded to the widest plan (the
        len_t masks keep the pad columns out of every real cell, as in
        ``_stacked_rescore``), then ONE DP over all of them: matrices and
        scores (``_mq_matrices_scores``) where a request wants flows, else
        a dense DP entry's launch a request: [(capacity, Tmax, pairs, (raw,
        H, S weighted, S unweighted))]."""
        Tmax = max(requests[ri]["qp"].width for ri in {pr[0] for pr in pairs})
        general = (None if gap_costs is None
                   else GeneralGaps(gap_costs, Tmax + 1, self.device))
        groups = []
        for bi, plist in self._by_bucket(pairs).items():
            cap = self._device_buckets[bi]["capacity"]
            for c0 in range(0, len(plist), chunk):
                pc = plist[c0 : c0 + chunk]
                runs = []  # (request, its consecutive pairs of the chunk)
                for pr in pc:
                    if runs and runs[-1][0] == pr[0]:
                        runs[-1][1].append(pr)
                    else:
                        runs.append((pr[0], [pr]))
                blocks = []
                for ri, run in runs:
                    req, st = requests[ri], states[ri]
                    sels = [st["sels"][j] for _, j, _ in run]
                    Sw, Su = self._plan_rows_similarity(
                        bi, [self._slice_loc[sid, 1] for _, _, sid in run],
                        None if doc_filter is None else sels, req["qp"],
                        req.get("tag_weights"),
                    )
                    pad = Tmax - int(Sw.shape[2])
                    blocks.append((F.pad(Sw, (0, pad)), F.pad(Su, (0, pad))))
                ln = torch.as_tensor(
                    [len(states[ri]["sels"][j]) for ri, j, _ in pc],
                    dtype=torch.int64, device=self.device)
                lt = torch.as_tensor([requests[ri]["len_t"] for ri, _, _ in pc],
                                     dtype=torch.int64, device=self.device)
                Sw = torch.cat([b[0] for b in blocks])
                if any(states[ri]["want_flows"] for ri, _ in runs):
                    H, raw = _mq_matrices_scores(
                        Sw, ln, lt, gaps, locality,
                        None if general is None else general.vecs(cap),
                    )
                    out = (raw, H, Sw, torch.cat([b[1] for b in blocks]))
                else:
                    raws, r0 = [], 0
                    for (ri, run), (bw, _) in zip(runs, blocks):
                        r1 = r0 + len(run)
                        lt1 = torch.as_tensor([requests[ri]["len_t"]],
                                              dtype=torch.int32, device=self.device)
                        raws.append(_dense_raw(bw[..., None].contiguous(),
                                               ln[r0:r1].int(), lt1, gaps, locality,
                                               general)[:, 0])
                        r0 = r1
                    out = (torch.cat(raws), None, None, None)
                groups.append((cap, Tmax, pc, out))
        return groups

    def _by_bucket(self, pairs) -> Dict[int, list]:
        """(request, position, slice id) pairs grouped by their bucket."""
        out: Dict[int, list] = {}
        for pr in pairs:
            bi = int(self._slice_loc[pr[2], 0])
            if bi < 0:
                raise KeyError(pr[2])
            out.setdefault(bi, []).append(pr)
        return out

    def _compacted_rows(self, bi: int, rows, sels, with_pos: bool):
        """Bucket ``bi``'s ``rows``, each row's kept positions ``sels``
        gathered to its front (the host compaction of
        ``filtered_positions``; the tail repeats position 0): (tokens [g,
        L] int32, pos [g, L] int8 or None) on the device."""
        b = self._packed.buckets[bi]
        sel_pad = np.zeros((len(rows), b.capacity), np.int64)
        for k, sel in enumerate(sels):
            sel_pad[k, : len(sel)] = sel
        rows = np.asarray(rows, np.int64)
        tok = np.take_along_axis(b.token_ids[rows], sel_pad, axis=1)
        pos = None
        if with_pos:
            pos = torch.as_tensor(
                np.take_along_axis(b.pos_ids[rows], sel_pad, axis=1),
                device=self.device,
            )
        return self._put(tok), pos
