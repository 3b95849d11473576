"""Word Mover's / Word Rotator's Distance ``find`` over packed corpora.

Reference: vectorian/core/cpp/alignment/wmd.h + wrd.h + bow.h.

The port of vectorian_tpu/ops/wmd.py's single-query half: the device
ranking passes and the host rescore behind ``WMDEngine.find``.  The JAX
package computes its ranking passes with jnp (no Pallas kernel), so the
port computes them with torch ops on the session's device, chunk by chunk
of each bucket, and evaluates the query's plan with ``eval_plan_chunk``
(static, contextual and mixed trees alike).

* BOW dedup (BOWBuilder::build, bow.h:204-275) is a masked-mass
  formulation: every slice position keeps its token, but only the first
  occurrence of each token id (of each (id, tag) under tag weights; every
  position of a contextual operand) carries the count mass.
* RelaxedSolver (wmd.h:273-417): each source token fills the target
  capacities in ascending-distance order, the capacity ahead of a target
  from a pairwise distance comparison (a stable sort past 128 targets);
  leftover mass costs the maximum distance 1.0.  Devices RANK only; the
  reported score is ``rwmd_score_host``'s float64 arithmetic, over a pool
  padded by RWMD_RANK_EPS, so membership is provably complete.
* FullSolver / WRD exact EMD (wmd.h:194-270, wrd.h:62-146): the device
  ranks with a provable upper bound on the exact score
  (``_emd_score_bound``) and the exact host EMD (ops/emd_exact) rescores
  candidates in descending-bound order until every remaining bound sits
  below the n-th exact score, so the top-k is the exhaustive exact-EMD
  oracle's.

The batch (``find_batch``) and multi-device halves of the JAX module are
not ported here.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from vectorian_tpu_torch.ops.dp_kernels import tag_weighted
from vectorian_tpu_torch.ops.emd_exact import emd_score_batch
from vectorian_tpu_torch.ops.search import (
    CTX_INPUT_BYTES,
    NEG_SCORE,
    BucketTopKSource,
    _host,
    order_by_score,
)
from vectorian_tpu_torch.ops.simmatrix import eval_plan_chunk
from vectorian_tpu_torch.utils import trace

MAX_SIMILARITY = 1.0
# absolute score slack covering device-f32 vs host-f64 drift in the
# provable-cut comparisons (greedy reductions over <=128 f32 terms drift
# ~1e-6 relative; near-balanced direction masking adds ~1e-6·mass/flow):
# the slack only ever ADDS candidates to the exact rescore, never drops one
CUT_EPS = 5e-4
# relaxed-WMD rank-vs-report drift guard: device passes rank in f32 with
# shape-dependent reduction orders; the reported value is
# rwmd_score_host's f64 arithmetic.  Pools and cut comparisons pad by
# multiples of this so candidate membership is provably complete — the
# slack only ever widens the host rescore set
RWMD_RANK_EPS = 1e-5
# a chunk's largest temporary (the [c, n1, n2, n2] comparison block of the
# greedy fill) stays within this many bytes
TRANSPORT_BLOCK_BYTES = 128 << 20


def _pool_from_vector(packed, scores, n: int, min_score: float, eps: float):
    """Tie-complete relaxed-WMD candidate pool over a COMPLETE host score
    vector: every slice within 3*eps of the n-th ranking value (and above
    min_score - eps), in deterministic (score desc, doc, slice) order —
    the vector-path mirror of top_k_exactly_many(slack=3*eps, pool=True)."""
    cand = np.flatnonzero(scores >= min_score - eps)
    if cand.size == 0:
        return []
    vals = scores[cand].astype(np.float32)
    if cand.size >= n:
        cut = max(
            float(-np.partition(-vals, n - 1)[n - 1]) - 3 * eps,
            min_score - eps,
        )
        keep = vals >= cut
        cand, vals = cand[keep], vals[keep]
    order = order_by_score(packed, cand, vals)
    return [int(c) for c in cand[order]]


def dedup_masses(ids, valid) -> np.ndarray:
    """Host-side: mass per position = count of equal ids at first occurrence,
    0 elsewhere (mirrors BOWBuilder dedup, bow.h:204-275).  ``ids`` is any
    sequence of hashables — (id, tag) tuples key the tagged variant
    (TaggedTokenFactory, bow.h:150-202)."""
    n = len(ids)
    mass = np.zeros((n,), np.float32)
    seen = {}
    for i in range(n):
        if not valid[i]:
            continue
        k = ids[i]
        if k in seen:
            mass[seen[k]] += 1.0
        else:
            seen[k] = i
            mass[i] = 1.0
    return mass


def _device_masses(tok, lengths, tag=None, keep=None) -> torch.Tensor:
    """[n, L] first-occurrence count masses on the device (O(L^2) a slice).
    With ``tag``, identity is (id, tag) — the reference's TaggedTokenFactory
    (bow.h:150-202).  ``keep`` (bool [n, L]) masks doc-filtered positions
    out of the bag (FilteredSlice: the token never enters the BOW)."""
    L = tok.shape[1]
    pos = torch.arange(L, device=tok.device)
    valid = pos[None, :] < lengths[:, None]
    if keep is not None:
        valid = valid & keep
    eq = (tok[:, :, None] == tok[:, None, :]) & valid[:, :, None] & valid[:, None, :]
    if tag is not None:
        eq = eq & (tag[:, :, None] == tag[:, None, :])
    counts = eq.sum(2, dtype=torch.int32).to(torch.float32)
    # the first index i equal to j (argmax returns the first maximum)
    first = torch.argmax(eq.to(torch.uint8), dim=1) == pos[None, :]
    return torch.where(first & valid, counts, 0.0)


def _greedy_fill_cost(w1, D, cap, injective: bool):
    """Relaxed WMD inner loop, batched.

    w1:  [B, n1]    source masses (0 = inactive)
    D:   [B, n1, n2] distances
    cap: [B, n2]    target capacities (0 = inactive)
    Returns total cost [B] = sum_i cost of moving w1[i] into capacities in
    ascending-distance order (or to the argmin target if injective);
    unplaceable mass costs MAX_SIMILARITY.
    """
    inf = torch.tensor(float("inf"), device=D.device)
    D = torch.where(cap[:, None, :] > 0, D, inf)  # inactive targets
    if injective:
        d_best = D.amin(2)  # [B, n1]
        d_best = torch.where(torch.isfinite(d_best), d_best, MAX_SIMILARITY)
        return (w1 * d_best).sum(1)
    n2 = D.shape[2]
    if n2 <= 128:
        # the capacity available before target j is the capacity of all
        # targets strictly closer (ties broken by index, as a stable sort)
        idx = torch.arange(n2, device=D.device)
        Dk = D[:, :, None, :]  # [B, n1, 1, n2] candidate k
        Dj = D[:, :, :, None]  # [B, n1, n2, 1] target j
        closer = (Dk < Dj) | ((Dk == Dj) & (idx[None, None, None, :]
                                            < idx[None, None, :, None]))
        prefix = (closer * cap[:, None, None, :]).sum(3)  # [B, n1, n2]
        moved = torch.minimum(torch.clamp_min(w1[:, :, None] - prefix, 0.0),
                              cap[:, None, :])
    else:
        order = torch.sort(D, dim=2, stable=True).indices  # ascending
        cap_sorted = torch.gather(cap[:, None, :].expand(D.shape), 2, order)
        before = torch.cumsum(cap_sorted, dim=2) - cap_sorted
        moved_sorted = torch.minimum(
            torch.clamp_min(w1[:, :, None] - before, 0.0), cap_sorted)
        # back to target order so the cost term below is uniform
        moved = torch.empty_like(moved_sorted).scatter_(2, order, moved_sorted)
    Df = torch.where(torch.isfinite(D), D, 0.0)
    cost = (moved * Df).sum(2)
    leftover = torch.clamp_min(w1 - moved.sum(2), 0.0)
    return (cost + leftover * MAX_SIMILARITY).sum(1)


def _emd_score_bound(m_t, m_s, Dts):
    """[B] provable upper bound on the exact FullSolver score.

    The exact score is ``1 - cost_real/flow`` (wmd.h:252 via emd_score):
    ``flow = min(sum(m_t), sum(m_s))`` is the real-to-real transported
    mass, and ``cost_real`` solves the LP whose LIGHTER side's marginals
    are exact while the heavier side's act as capacities (the emd_hat sink
    absorbs the imbalance at a constant cost, so the penalty never affects
    the real flows).  The greedy relaxed fill from the lighter side
    (per-source independent ascending-distance assignment — the exact RWMD
    kernel, wmd.h:339-376) is feasible-dominated by every real flow, hence
    ``greedy <= cost_real`` and ``1 - greedy/flow >= exact score``.

    Near-balanced masses (|sum difference| <= tol) take the max of both
    directions (tighter, like symmetric RWMD); the direction validity
    error this introduces is <= tol·max(D)/flow, absorbed by CUT_EPS at
    the cut comparisons.

    m_t: [B, T] query masses; m_s: [B, L] slice masses; Dts: [B, T, L].
    """
    st = m_t.sum(1)
    ss = m_s.sum(1)
    flow = torch.minimum(st, ss)
    tol = 1e-6 * torch.maximum(st, ss)
    g_ts = _greedy_fill_cost(m_t, Dts, m_s, False)
    g_st = _greedy_fill_cost(m_s, Dts.transpose(1, 2), m_t, False)
    neg = torch.tensor(float("-inf"), device=Dts.device)
    g = torch.maximum(
        torch.where(st <= ss + tol, g_ts, neg),
        torch.where(ss <= st + tol, g_st, neg),
    )
    return 1.0 - g / torch.clamp_min(flow, 1e-9)


def _transport_chunk(L: int, T: int, d: int) -> int:
    """Slices a chunk of a transport pass evaluates at once: the greedy
    fill's comparison block within TRANSPORT_BLOCK_BYTES, its contextual
    vectors within CTX_INPUT_BYTES."""
    n2 = max(L, T)
    per = 4 * T * L * (n2 if n2 <= 128 else 8)
    return max(1, min(TRANSPORT_BLOCK_BYTES // per,
                      CTX_INPUT_BYTES // (L * max(d, 1) * 4)))


class _ChunkArgs:
    """What a transport pass's chunk needs besides its rows: the plan, the
    tag rewrite's device arrays (or None) and the document filter's
    exclusion masks (or None)."""

    def __init__(self, engine, qp, tagw, doc_filter, T: int):
        self.engine = engine
        self.qp = qp
        self.tw = WMDEngine._tagw_args(tagw, T, engine.device)
        self.df = WMDEngine._df_args(doc_filter, engine.device)
        self.d = sum(int(v.unmodified.shape[1]) for v in qp.ctx_vectors)

    def chunks(self, db, with_tag: bool):
        """(tok, pos, tag, ln, ctx) of each chunk of bucket ``db``: pos and
        tag ids only where the tag rewrite, the (id, tag) BOW or the filter
        read them."""
        eng = self.engine
        n, L = db["n"], db["capacity"]
        need_pos = self.tw is not None or self.df is not None
        need_tag = with_tag or self.df is not None
        step = _transport_chunk(L, self.qp.width, self.d)
        for c0 in range(0, n, step):
            c1 = min(c0 + step, n)
            yield (
                db["tokens"][c0:c1],
                eng._bucket_ids(db, "pos")[c0:c1] if need_pos else None,
                eng._bucket_ids(db, "tag")[c0:c1] if need_tag else None,
                db["lengths"][c0:c1],
                tuple(eng._ctx_dev(nm, db["bi"])[c0:c1] for nm in self.qp.ctx_names),
            )

    def similarity(self, tok, pos, ctx, needs_magnitudes=False):
        out = eval_plan_chunk(self.qp, tok, ctx, needs_magnitudes=needs_magnitudes)
        S = out["similarity"]  # [c, L, T]
        if self.tw is not None:
            c, T = S.shape[0], S.shape[2]
            w, p, pen, thr = self.tw
            S = tag_weighted(S, pos, w.expand(c, T), p.expand(c, T), pen.expand(c),
                             thr.expand(c))
        return S, out.get("magnitudes_s")

    def keep(self, tok, pos, tag, valid):
        """Doc-side filter = FilteredSlice (slice/static.h:104-184):
        excluded tokens never enter the BOW; None without a filter."""
        if self.df is None:
            return None
        pos_ex, tag_ex, tok_ex = self.df
        return valid & ~(pos_ex[torch.clamp_min(pos.long(), 0)]
                         | tag_ex[torch.clamp_min(tag.long(), 0)]
                         | tok_ex[torch.clamp_min(tok.long(), 0)])


def _bucket_rwmd_scores(args: _ChunkArgs, db, mass_t, len_t: int, max_score_t: float,
                        injective: bool, symmetric: bool, normalize_bow: bool,
                        unique: bool, tagged: bool) -> torch.Tensor:
    """[n] relaxed-WMD ranking scores of bucket ``db`` on the device, chunk
    by chunk (the JAX package's ``_bucket_rwmd_scores``)."""
    dev = args.engine.device
    L = db["capacity"]
    T = int(mass_t.shape[0])
    w_sum_t = torch.clamp_min(torch.tensor(float(len_t), device=dev), 1e-9)
    # max_cost = max_sum_of_similarities in bow mode (wmd.h:411-412): len_t
    # untagged, the tag-weight sum when weighted
    max_cost = torch.tensor(1.0 if normalize_bow else float(max_score_t),
                            device=dev, dtype=torch.float32)
    out = []
    for tok, pos, tag, ln, ctx in args.chunks(db, tagged):
        c = tok.shape[0]
        valid = torch.arange(L, device=dev)[None, :] < ln[:, None]
        keep = args.keep(tok, pos, tag, valid)
        if unique:
            # contextual: every position is its own BOW entry (reference
            # UniqueTokensBOWBuilder, alignment/bow.h:278-334)
            mass_s = (keep if keep is not None else valid).to(torch.float32)
        else:
            mass_s = _device_masses(tok, ln, tag if tagged else None, keep=keep)
        eff_len = (keep.sum(1) if keep is not None else ln).to(torch.float32)
        w_sum_s = torch.clamp_min(eff_len, 1e-9)
        if normalize_bow:
            m_s = mass_s / w_sum_s[:, None]
            m_t = (mass_t[None, :] / w_sum_t).expand(c, T)
        else:
            m_s = mass_s
            m_t = mass_t[None, :].expand(c, T)
        S, _ = args.similarity(tok, pos, ctx)
        Dst = torch.clamp_min(MAX_SIMILARITY - S, 0.0)  # [c, L, T] s x t
        Dts = Dst.transpose(1, 2)  # [c, T, L]
        # direction 0: t -> s (reference computes this first, wmd.h:302)
        acc0 = _greedy_fill_cost(m_t, Dts, m_s, injective)
        if not normalize_bow:
            acc0 = acc0 / w_sum_t
        if symmetric:
            acc1 = _greedy_fill_cost(m_s, Dst, m_t, injective)
            if not normalize_bow:
                acc1 = acc1 / w_sum_s
            cost = torch.maximum(acc0, acc1)  # tighter bound (wmd.h:383-390)
        else:
            cost = acc0
        score = (max_cost - cost) / max_cost  # cost_to_score, wmd.h:139-141
        out.append(torch.where(eff_len > 0, score, NEG_SCORE))
    return torch.cat(out)


def _bucket_emd_scores(args: _ChunkArgs, db, mass_t, use_magnitudes: bool,
                       normalize_mass: bool, unique: bool,
                       tagged: bool) -> torch.Tensor:
    """[n] full WMD / WRD ranking scores of bucket ``db`` on the device:
    the provable exact-score upper bound (``_emd_score_bound``); the exact
    host EMD rescore, driven by the bound's cut, owns the reported scores
    and the top-k membership (the JAX package's ``_bucket_emd_scores``)."""
    dev = args.engine.device
    L = db["capacity"]
    T = int(mass_t.shape[0])
    out = []
    for tok, pos, tag, ln, ctx in args.chunks(db, tagged):
        c = tok.shape[0]
        S, mags = args.similarity(tok, pos, ctx, needs_magnitudes=use_magnitudes)
        valid = torch.arange(L, device=dev)[None, :] < ln[:, None]
        keep = args.keep(tok, pos, tag, valid)
        if keep is not None:
            valid = keep
        if use_magnitudes:
            # WRD: every position is its own entry, mass = |v| (wrd.h:62-146)
            m_s = torch.where(valid, mags, 0.0)
        elif unique:
            m_s = valid.to(torch.float32)
        else:
            m_s = _device_masses(tok, ln, tag if tagged else None, keep=keep)
        m_t = mass_t[None, :].expand(c, T)
        if normalize_mass:
            m_s = m_s / torch.clamp_min(m_s.sum(1, keepdim=True), 1e-9)
            m_t = m_t / torch.clamp_min(m_t.sum(1, keepdim=True), 1e-9)
        D = torch.clamp_min(MAX_SIMILARITY - S.transpose(1, 2), 0.0)  # [c, T, L]
        score = _emd_score_bound(m_t, m_s, D)
        out.append(torch.where(valid.sum(1) > 0, score, NEG_SCORE))
    return torch.cat(out)


def _greedy_cost_host(w1, D, cap) -> float:
    """f64 host greedy fill cost for ONE slice (mirrors
    ``_greedy_fill_cost``, same stable index tie-break): each source moves
    its mass into targets in ascending-distance order; unplaceable mass
    costs MAX_SIMILARITY.  w1: [n1], D: [n1, n2], cap: [n2], float64."""
    order = np.argsort(D, axis=1, kind="stable")
    Ds = np.take_along_axis(D, order, axis=1)
    caps = np.take_along_axis(np.broadcast_to(cap, D.shape), order, axis=1)
    before = np.cumsum(caps, axis=1) - caps
    moved = np.clip(w1[:, None] - before, 0.0, caps)
    leftover = np.maximum(w1 - moved.sum(axis=1), 0.0)
    return float((moved * Ds).sum() + leftover.sum() * MAX_SIMILARITY)


def _greedy_cost_host_injective(w1, D, cap) -> float:
    """f64 host injective fill: every source moves wholly to its nearest
    active target (cap > 0); no active target costs MAX_SIMILARITY."""
    active = cap > 0
    if not active.any():
        return float(w1.sum() * MAX_SIMILARITY)
    d_best = D[:, active].min(axis=1)
    return float((w1 * d_best).sum())


def rwmd_score_host(m_t, m_s, D_ts, injective: bool, symmetric: bool,
                    normalize_bow: bool, max_score: float) -> np.float32:
    """THE single home for REPORTED relaxed-WMD scores.

    Device passes (single-query, and the JAX package's multi-query and mesh
    shard kernels) RANK only: their f32 reductions differ with the shape,
    so reported scores come from one shape-independent arithmetic path —
    float64 greedy fill here, cast to f32 — exactly as the alignment
    finalizer and the full-WMD/WRD exact EMD rescore do.  Mirrors the
    kernel formula (wmd.h:139-141 cost_to_score, :383-390 symmetric max):
    masses normalized by their sums in nbow mode, costs divided by the
    source mass sum in bow mode, max_cost = 1 (nbow) or
    max_sum_of_similarities (bow)."""
    m_t = np.asarray(m_t, np.float64)
    m_s = np.asarray(m_s, np.float64)
    D = np.asarray(D_ts, np.float64)
    w_t = max(float(m_t.sum()), 1e-9)
    w_s = max(float(m_s.sum()), 1e-9)
    if normalize_bow:
        mt, ms = m_t / w_t, m_s / w_s
    else:
        mt, ms = m_t, m_s
    fill = _greedy_cost_host_injective if injective else _greedy_cost_host
    acc0 = fill(mt, D, ms)
    if not normalize_bow:
        acc0 /= w_t
    if symmetric:
        acc1 = fill(ms, np.ascontiguousarray(D.T), mt)
        if not normalize_bow:
            acc1 /= w_s
        cost = max(acc0, acc1)
    else:
        cost = acc0
    max_cost = 1.0 if normalize_bow else max(float(max_score), 1e-9)
    return np.float32((max_cost - cost) / max_cost)


def rwmd_flow_host(m_t, m_s, D_ts, injective: bool, normalize_bow: bool = True):
    """Replicate the greedy fill on host for one slice to extract flow edges
    [(t, s, flow, distance)] (wmd.h:393-409).  Direction t->s only (the
    direction the reference uses for flows when not symmetric-tighter-1).
    Per-source capacity is independent (the reference re-fills w2 for every
    source token, wmd.h:339-376).

    Flow normalization follows wmd.h:401-402 exactly: nbow keeps the raw
    moved mass (masses are already normalized); bow divides by the source's
    bow mass ``m_t[i]``."""
    edges = []
    for i in range(len(m_t)):
        w = float(m_t[i])
        if w <= 0:
            continue
        if injective:
            valid = np.flatnonzero(m_s > 0)
            if valid.size == 0:
                continue
            j = valid[np.argmin(D_ts[i, valid])]
            edges.append((i, int(j), w, float(D_ts[i, j])))
        else:
            order = np.argsort(D_ts[i])
            remaining = w
            for j in order:
                if m_s[j] <= 0:
                    continue
                take = min(remaining, float(m_s[j]))
                if take > 0:
                    edges.append((i, int(j), take, float(D_ts[i, j])))
                    remaining -= take
                if remaining <= 1e-12:
                    break
    if normalize_bow:
        return edges
    return [(t, s, f / max(float(m_t[t]), 1e-12), d) for (t, s, f, d) in edges]


class WMDEngine:
    """Transport-metric search over a BruteForceEngine's packed buckets
    (``find``; the batch is the JAX package's item 6b)."""

    def __init__(self, engine, alignment_args: dict):
        self._engine = engine
        self._args = alignment_args
        self._algorithm = alignment_args["algorithm"]

    def _query_masses(self, query, tagged: bool = False) -> np.ndarray:
        """Dedup query tokens by string (the reference interns OOV tokens in
        the query vocabulary, so duplicates share an id); by (string, tag)
        when tag-weighted (TaggedTokenFactory, bow.h:150-202)."""
        strings = query.token_strings
        valid = np.ones((len(strings),), bool)
        if tagged:
            ids = list(zip(strings, query.token_tag))
        else:
            ids = list(strings)
        return dedup_masses(ids, valid)

    def find(self, index, query, qp) -> List:
        opts = query.options
        n = int(opts.get("max_matches", 100))
        min_score = float(opts.get("min_score", 0.2))
        debug = opts.get("debug")
        booster = opts.get("booster")
        boost = None
        if booster is not None:
            # the reference multiplies the booster into EVERY match score,
            # transport included (Score(r.score, score_max, p_boost),
            # metric/alignment.h:598 WMD / :710 WRD) — rank on boosted
            # scores so top-k pruning sees the same ordering
            boost = index._compile_booster(booster)
        doc_filter = index._doc_filter(query)

        a = self._args
        relaxed = self._algorithm == "word-movers-distance" and a["relaxed"]
        use_device = boost is None and debug is None
        with trace.span("wmd.rank"):
            state = self._score(index, query, qp, doc_filter=doc_filter,
                                device=use_device)
        state["boost"] = boost
        packed = self._engine.packed

        if relaxed:
            # device passes RANK; rwmd_score_host REPORTS.  Pool slack
            # 3*eps makes membership provably complete: any slice whose
            # host score could reach the host n-th has device >= nth -
            # 2*eps, strictly above the pool cut AND the unfetched bound,
            # so one tie-complete pool fetch suffices
            eps = RWMD_RANK_EPS * (
                max(1.0, float(boost.max())) if boost is not None else 1.0
            )
            if use_device:
                src = BucketTopKSource(self._engine, state["scores"], 1, n)
                top, smap, _rest = src.top_k_exactly_many(
                    [0], n, min_score - eps, slack=3 * eps, pool=True
                )[0]
                state["scores"] = smap
            else:
                scores = state["scores"]
                if boost is not None:
                    valid = scores > NEG_SCORE * 0.5
                    scores = np.where(valid, scores * boost, NEG_SCORE).astype(
                        np.float32)
                    state["scores"] = scores
                if debug:
                    debug("scores", {"scores": scores})
                top = _pool_from_vector(packed, scores, n, min_score, eps)
            with trace.span("wmd.host_rescore"):
                return self._relaxed_finalize(
                    index, query, qp, state, top, n, min_score, debug
                )

        # full WMD / WRD: device scores are PROVABLE upper bounds on the
        # exact score (_emd_score_bound), so exact-rescoring candidates in
        # descending-bound order until every remaining bound sits below the
        # n-th exact score reproduces the reference's exhaustive exact-EMD
        # top-k (wmd.h:194-270) without solving every slice
        eps = CUT_EPS * (
            max(1.0, float(boost.max())) if boost is not None else 1.0
        )
        rank_min = min_score - eps
        if use_device:
            src = BucketTopKSource(self._engine, state["scores"], 1, n + 32)
            smap, rest = src.score_map(0, rank_min)
            state["scores"] = smap

            def fetch_all(cut):
                found = src.above_vals_many([(src.qview(0), cut, set(smap))])
                return found[0][1]

        else:
            scores = state["scores"]
            if boost is not None:
                valid = scores > NEG_SCORE * 0.5
                scores = np.where(valid, scores * boost, NEG_SCORE).astype(np.float32)
                state["scores"] = scores
            if debug:
                debug("scores", {"scores": scores})
            cand = np.flatnonzero(scores >= rank_min)
            smap = {int(c): float(scores[c]) for c in cand}
            rest = float("-inf")  # the host vector is already complete
            fetch_all = None
        with trace.span("wmd.host_rescore"):
            return self._rescore_with_cut(
                index, query, qp, state, smap, rest, n, min_score,
                fetch_all=fetch_all, debug=debug,
            )

    @staticmethod
    def _nth_cut(matches, n: int, min_score: float) -> float:
        """The score every further candidate must (weakly) reach: the n-th
        best exact score so far, or the threshold while fewer than n
        qualify."""
        if len(matches) < n:
            return min_score
        return sorted((m.score for m in matches), reverse=True)[n - 1]

    def _ordered_by_bound(self, d: dict) -> List[int]:
        """Candidate sids in descending-bound order ((doc, slice) breaking
        bound ties — the same deterministic order as the final ranking)."""
        if not d:
            return []
        ids = np.fromiter(d.keys(), np.int64, len(d))
        vals = np.asarray([d[int(i)] for i in ids], np.float64)
        o = order_by_score(self._engine.packed, ids, vals)
        return [int(i) for i in ids[o]]

    def _consume_ordered(
        self, index, query, qp, state, smap, cand, matches, n, min_score,
        eps, debug=None,
    ) -> None:
        """Exact-EMD rescore of bound-ordered candidates into ``matches``,
        in batches (each batch one batched similarity fetch), stopping once
        every remaining candidate's bound is provably below the n-th exact
        score: bound >= exact, so bound < nth - eps cannot displace or tie
        any reported match."""
        i = 0
        step = max(2 * n, 32)
        while i < len(cand):
            if (
                len(matches) >= n
                and smap[cand[i]] < self._nth_cut(matches, n, min_score) - eps
            ):
                return
            matches.extend(
                self._host_rescore(
                    index, query, qp, state, cand[i : i + step], min_score,
                    debug,
                )
            )
            i += step

    def _rescore_with_cut(
        self, index, query, qp, state, smap, rest, n, min_score,
        fetch_all=None, debug=None,
    ) -> List:
        """Provably complete full-WMD / WRD top-k (reference parity with
        wmd.h:194-270's exhaustive exact EMD): ``smap`` maps fetched sids to
        their provable score bounds, ``rest`` upper-bounds every unfetched
        slice, ``fetch_all(cut)`` returns the complete {sid: bound} map of
        everything >= cut (one device completion round; None when smap is
        already complete).  After the final pass every slice NOT exactly
        rescored has bound < nth - eps <= exact nth, so it can neither beat
        nor tie the reported top-k."""
        packed = self._engine.packed
        boost = state.get("boost")
        eps = CUT_EPS * (
            max(1.0, float(np.max(boost))) if boost is not None else 1.0
        )
        rank_min = min_score - eps
        matches: List = []
        cand0 = self._ordered_by_bound(
            {s: v for s, v in smap.items() if v >= rank_min}
        )
        self._consume_ordered(
            index, query, qp, state, smap, cand0, matches, n, min_score,
            eps, debug,
        )
        if fetch_all is not None:
            cut = max(self._nth_cut(matches, n, min_score) - eps, rank_min)
            if rest >= cut:
                extra = fetch_all(cut)
                new = {
                    int(s): float(v)
                    for s, v in extra.items()
                    if int(s) not in smap and v >= cut
                }
                smap.update({int(s): float(v) for s, v in extra.items()})
                self._consume_ordered(
                    index, query, qp, state, smap,
                    self._ordered_by_bound(new), matches, n, min_score,
                    eps, debug,
                )
        matches.sort(
            key=lambda m: (
                -m.score,
                int(packed.slice_doc[m.slice_id]),
                int(packed.slice_idx[m.slice_id]),
            )
        )
        return matches[:n]

    def _score(self, index, query, qp, doc_filter=None, device=False) -> dict:
        """Device ranking pass; returns scores plus the mass/tag/filter
        state the host rescore needs.  ``device=True`` leaves the per-bucket
        score vectors on the device (state["scores"] is then the pending
        list for BucketTopKSource instead of a host vector)."""
        T = query.n_tokens
        a = self._args
        # padded needle width (index._find_transport): the passes use
        # Tpad, masses beyond T are zero (masked by the transport solvers)
        Tpad = qp.width
        # contextual (per-position) operands -> position-unique BOW entries
        # (reference similarity_dependency()==POSITION selects
        # UniqueTokensBOWBuilder, metric/alignment.h:551-576)
        unique = not qp.is_static_only
        # tag-weighted similarity -> (id, tag) BOW identity
        # (similarity_dependency()==TAGS -> TaggedTokenFactory,
        # metric/alignment.h:558-563 + bow.h:150-202); position-unique
        # subsumes it when a contextual operand is present
        tagw = index._tag_weighting(query, Tpad)
        tagged = tagw is not None and not unique
        mass_t = (
            np.ones((T,), np.float32)
            if unique
            else self._query_masses(query, tagged=tagged)
        )
        mass_t = np.pad(mass_t, (0, Tpad - T))
        mass_t_mag = None

        if self._algorithm == "word-movers-distance" and a["relaxed"]:
            scores = self._score_buckets_rwmd(
                qp, mass_t, T, bool(a["injective"]), bool(a["symmetric"]),
                bool(a["normalize_bow"]), unique, tagw, tagged,
                doc_filter=doc_filter, device=device,
            )
        elif self._algorithm == "word-movers-distance":
            # bound masses MUST mirror the exact host rescore's (same
            # bow/nbow normalization) — _emd_score_bound's guarantee is
            # relative to the masses the LP actually solves
            scores = self._score_buckets_emd(
                qp, mass_t, use_magnitudes=False,
                normalize=bool(a["normalize_bow"]), unique=unique, tagw=tagw,
                tagged=tagged, doc_filter=doc_filter, device=device,
            )
        elif self._algorithm == "word-rotators-distance":
            mass_t_mag = np.asarray(qp.ctx_queries[0]["magnitudes"], np.float32) if (
                unique and qp.ctx_queries
            ) else None
            if mass_t_mag is None:
                # static: needle magnitudes from the embedding rows
                mass_t_mag = self._static_needle_magnitudes(qp, query, index)
            scores = self._score_buckets_emd(
                qp, mass_t_mag, use_magnitudes=True,
                normalize=bool(a.get("normalize_magnitudes", True)),
                unique=unique, tagw=tagw, tagged=tagged, doc_filter=doc_filter,
                device=device,
            )
        else:
            raise ValueError(self._algorithm)

        return {
            "scores": scores,
            "mass_t": mass_t,
            "mass_t_mag": mass_t_mag,
            "tagw": tagw,
            "tagged": tagged,
            "unique": unique,
            "T": T,
            "doc_filter": doc_filter,
        }

    def _fetch_slice_sims(self, top, qp, tagw):
        """[(Sw, Su)] per sid: one batched evaluation a touched bucket (the
        JAX package's prefetched map of the batch is item 6b's)."""
        return self._engine.batch_slice_similarity(top, qp, tag_weights=tagw)

    def _slice_row(self, sid: int):
        """(the slice's bucket on the host, its row)."""
        bi, r = self._engine._slice_loc[sid]
        return self._engine.packed.buckets[bi], r

    def _slice_bow(self, sid, ids, ln, state):
        """(m_s, keep) for one slice: the doc-side BOW masses (dedup by id,
        (id, tag) when tag-weighted, per-position when contextual-unique)
        with the doc filter's FilteredSlice exclusion applied."""
        doc_filter = state.get("doc_filter")
        keep = np.ones(ln, bool)
        b, r = self._slice_row(sid)
        if doc_filter is not None:
            # FilteredSlice: excluded doc tokens carry no mass and get
            # no flow edges (they render as gap regions)
            pos_h = b.pos_ids[r][:ln].astype(np.int64)
            tag_h = b.tag_ids[r][:ln].astype(np.int64)
            keep = ~(
                doc_filter.pos_exclude[np.maximum(pos_h, 0)]
                | doc_filter.tag_exclude[np.maximum(tag_h, 0)]
                | doc_filter.token_exclude[np.maximum(ids, 0)]
            )
        if state["unique"]:
            m_s = keep.astype(np.float32)
        elif state["tagged"]:
            tags = b.tag_ids[r][:ln]
            m_s = dedup_masses(list(zip(ids.tolist(), tags.tolist())), keep)
        else:
            m_s = dedup_masses(ids, keep)
        return m_s, keep

    def _slice_token_ids(self, sid: int, ln: int) -> np.ndarray:
        b, r = self._slice_row(sid)
        return b.token_ids[r][:ln]

    def _relaxed_finalize(
        self, index, query, qp, state, pool, n, min_score, debug,
    ) -> List:
        """Relaxed-WMD finalize: REPORTED scores for the whole candidate
        pool via ``rwmd_score_host`` (the single shape-independent home —
        device vectors rank only), deterministic (score desc, doc, slice)
        order, then Match + flow extraction for the kept top-n ONLY (pools
        carry boundary slack, so building flows for every member would pay
        the python flow loops for candidates the order drops).  Returns
        the final ordered, min_score-filtered, n-truncated match list."""
        from vectorian_tpu_torch.index import Match

        packed = self._engine.packed
        a = self._args
        if not pool:
            return []
        mass_t = state["mass_t"]
        tagw = state["tagw"]
        T = state["T"]
        token_sim_name = index._args["metric"]["token_sim"].name
        max_score = tagw.total if tagw is not None else float(T)
        sims_list = self._fetch_slice_sims(pool, qp, tagw)
        boost = state.get("boost")
        scores_arr = np.empty(len(pool), np.float64)
        per = {}
        for k, (sid, (Sw, Su)) in enumerate(zip(pool, sims_list)):
            ln = int(packed.slice_len[sid])
            ids = self._slice_token_ids(sid, ln)
            S = Sw[:, :T]  # [ln, T] (weighted == unmodified when no tags)
            D_ts = np.maximum(MAX_SIMILARITY - S.T, 0.0)  # [T, ln]
            m_s, _keep = self._slice_bow(sid, ids, ln, state)
            score = float(
                rwmd_score_host(
                    mass_t[:T], m_s, D_ts, bool(a["injective"]),
                    bool(a["symmetric"]), bool(a["normalize_bow"]),
                    max_score,
                )
            )
            if boost is not None:
                # boost multiplies every reported score (alignment.h:598);
                # the same f32 multiply the ranking applies on the device
                score = float(np.float32(score) * np.float32(boost[sid]))
            scores_arr[k] = score
            per[int(sid)] = (D_ts, m_s, score)
        order = order_by_score(packed, np.asarray(pool, np.int64), scores_arr)
        ordered = [int(pool[j]) for j in order]
        kept = [sid for sid in ordered if per[sid][2] > min_score][:n]
        matches = []
        for sid in (ordered if debug else kept):
            D_ts, m_s, score = per[sid]
            m_t = mass_t[:T].copy()
            m_s_use = m_s.copy()
            if a["normalize_bow"]:
                m_t = m_t / max(m_t.sum(), 1e-9)
                m_s_use = m_s_use / max(m_s_use.sum(), 1e-9)
            edges = rwmd_flow_host(
                m_t, m_s_use, D_ts, bool(a["injective"]),
                normalize_bow=bool(a["normalize_bow"]),
            )
            if debug:
                debug(
                    "alignment/" + self._algorithm + "/solver",
                    {"slice": sid, "D": D_ts, "score": score, "edges": edges},
                )
                if sid not in kept:
                    continue
            matches.append(
                Match(index, query, slice_id=sid, score=score,
                      metric=token_sim_name, edge_list=edges)
            )
        return matches

    def _host_rescore(
        self, index, query, qp, state, top, min_score, debug,
    ) -> List:
        """Exact host EMD rescore + flow extraction for the chosen slices
        (their similarities evaluated in one batch a touched bucket;
        relaxed WMD finalizes in ``_relaxed_finalize`` instead)."""
        from vectorian_tpu_torch.index import Match

        a = self._args
        mass_t = state["mass_t"]
        mass_t_mag = state["mass_t_mag"]
        tagw = state["tagw"]
        T = state["T"]

        matches = []
        token_sim_name = index._args["metric"]["token_sim"].name
        sims_list = self._fetch_slice_sims(top, qp, tagw)
        # phase 1: per-candidate problem prep (masses + cost matrices)
        specs = []
        for sid, (Sw, Su) in zip(top, sims_list):
            ln = int(self._engine.packed.slice_len[sid])
            ids = self._slice_token_ids(sid, ln)
            S = Sw[:, :T]  # [ln, T] (weighted == unmodified when no tags)
            D_ts = np.maximum(MAX_SIMILARITY - S.T, 0.0)  # [T, ln]
            m_s, keep = self._slice_bow(sid, ids, ln, state)
            # exact EMD rescore (the reference uses exact emd_hat)
            if self._algorithm == "word-rotators-distance":
                m_t = np.asarray(mass_t_mag[:T], np.float64)
                m_s_use = self._slice_magnitudes(qp, sid, ln)
                m_s_use = np.where(keep, m_s_use, 0.0)
                if a.get("normalize_magnitudes", True):
                    m_s_use = m_s_use / max(m_s_use.sum(), 1e-9)
                    m_t = m_t / max(m_t.sum(), 1e-9)
            else:
                m_t = mass_t[:T].copy()
                m_s_use = m_s
                if a["normalize_bow"]:
                    m_t = m_t / max(m_t.sum(), 1e-9)
                    m_s_use = m_s_use / max(m_s_use.sum(), 1e-9)
            specs.append((m_t, m_s_use, D_ts, a.get("extra_mass_penalty", -1)))
        # phase 2: ONE threaded native solve for all candidates
        solved = emd_score_batch(specs)
        # phase 3: flows -> Matches
        for (sid, (Sw, Su)), (m_t, _m_s, D_ts, _e), (score, r) in zip(
            zip(top, sims_list), specs, solved
        ):
            if state.get("boost") is not None:
                # the exact EMD rescore recomputes the unboosted score, so
                # the boost multiplies here (alignment.h:598)
                score *= float(state["boost"][sid])
            edges = []
            if r.success:
                for i in range(r.flow.shape[0]):
                    max_flow = max(m_t[i], 1e-12)
                    for jj in np.flatnonzero(r.flow[i] > 1e-9):
                        edges.append(
                            (i, int(jj), float(r.flow[i, jj] / max_flow),
                             float(D_ts[i, jj]))
                        )
            if debug:
                debug(
                    "alignment/" + self._algorithm + "/solver",
                    {"slice": sid, "D": D_ts, "score": score, "edges": edges},
                )
            if score <= min_score:  # strict (score > worst_score, alignment.h:284)
                continue
            matches.append(
                Match(index, query, slice_id=sid, score=score,
                      metric=token_sim_name, edge_list=edges)
            )
        return matches

    def _static_needle_magnitudes(self, qp, query, index) -> np.ndarray:
        """Needle-side WRD masses: the embedding-row magnitude per query
        token.  Corpus-OOV tokens keep their own encoder magnitude — the
        reference's query vocabulary interns every query token so none is
        massless (static.cpp fill_magnitudes_t over query-vocab ids)."""
        mags = _host(qp.static_mags[0])
        ids = np.asarray(query.token_ids)
        out = np.where(ids >= 0, mags[np.maximum(ids, 0)], 0.0).astype(np.float32)
        oov = np.flatnonzero(ids < 0)
        if len(oov):
            token_sim = index._args["metric"]["token_sim"]
            emb = token_sim.embeddings[0]
            comp = index.session.compiled_embeddings[emb.name]
            enc = comp.encode_query([query.token_strings[i] for i in oov])
            out[oov] = np.asarray(enc.magnitudes, np.float32)
        return np.pad(out, (0, max(qp.width - len(out), 0)))

    def _slice_magnitudes(self, qp, sid, ln) -> np.ndarray:
        if qp.is_static_only:
            if not hasattr(self, "_static_mags_np"):
                self._static_mags_np = _host(qp.static_mags[0])
            return self._static_mags_np[self._slice_token_ids(sid, ln)].astype(np.float64)
        bi, r = self._engine._slice_loc[sid]
        ctx = self._engine._ctx_dev(qp.ctx_names[0], bi)[r, :ln].float()
        return np.linalg.norm(_host(ctx), axis=-1).astype(np.float64)

    @staticmethod
    def _tagw_args(tagw, T: int, device):
        """The tag rewrite's device arrays (weights [T], needle pos ids
        [T], penalty, threshold) of a TagWeightingSpec; None without tag
        weights (the pass then skips the rewrite)."""
        if tagw is None:
            return None
        return tuple(torch.as_tensor(np.asarray(a), device=device) for a in (
            np.asarray(tagw.t_pos_weights, np.float32)[:T],
            np.asarray(tagw.pos_t, np.int8)[:T],
            np.float32(tagw.pos_mismatch_penalty),
            np.float32(tagw.similarity_threshold),
        ))

    @staticmethod
    def _df_args(doc_filter, device):
        """The document filter's exclusion masks (pos, tag, token) as bool
        tensors; None without a filter."""
        return None if doc_filter is None else doc_filter.device_args(device)

    def _buckets_pass(self, fn, device: bool):
        """``fn(db)`` -> [n] device scores of every non-empty bucket: the
        pending list of BucketTopKSource (``device``), else the [n_slices]
        host vector (NEG_SCORE where empty)."""
        engine = self._engine
        pending = [(db, fn(db)) for db in engine._device_buckets if db["n"]]
        if device:
            return [(db, scores[:, None]) for db, scores in pending]
        out = np.full((engine.packed.n_slices,), NEG_SCORE, np.float32)
        for db, scores in pending:
            out[db["slice_index"]] = _host(scores)
        return out

    def _score_buckets_rwmd(self, qp, mass_t, len_t, injective, symmetric,
                            normalize_bow, unique, tagw=None, tagged=False,
                            doc_filter=None, device=False):
        args = _ChunkArgs(self._engine, qp, tagw, doc_filter, qp.width)
        max_score_t = tagw.total if tagw is not None else float(len_t)
        m_t = torch.as_tensor(np.asarray(mass_t, np.float32), device=self._engine.device)
        return self._buckets_pass(
            lambda db: _bucket_rwmd_scores(
                args, db, m_t, len_t, max_score_t, injective, symmetric,
                normalize_bow, unique, tagged),
            device)

    def _score_buckets_emd(self, qp, mass_t, use_magnitudes, normalize, unique,
                           tagw=None, tagged=False, doc_filter=None, device=False):
        args = _ChunkArgs(self._engine, qp, tagw, doc_filter, qp.width)
        m_t = torch.as_tensor(np.asarray(mass_t, np.float32), device=self._engine.device)
        return self._buckets_pass(
            lambda db: _bucket_emd_scores(args, db, m_t, use_magnitudes, normalize,
                                          unique, tagged),
            device)
