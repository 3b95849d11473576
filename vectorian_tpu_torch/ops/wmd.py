"""Word Mover's / Word Rotator's Distance ``find`` and ``find_batch`` over
packed corpora.

Reference: vectorian/core/cpp/alignment/wmd.h + wrd.h + bow.h.

The port of vectorian_tpu/ops/wmd.py: the device ranking passes and the
host rescore behind ``WMDEngine.find`` and ``WMDEngine.find_batch``, whose
ranking pass a mesh shards (``WMDEngine._ranking_source``).  The JAX
package computes its ranking passes with jnp (no Pallas kernel), so the
port computes them with torch ops on
the session's device, chunk by chunk of each bucket: a query's plan
through ``eval_plan_chunk`` (static, contextual and mixed trees alike); a
batch's Q queries a chunk at once, the [c, L, T, Q] block gathered from
the static plans' stacked [V, T, Q] table or evaluated from the stacked
tree plan (``search.stack_tree_plans``).

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

The batch serves Q queries with one corpus pass; each query's host
rescore then runs as ``find``'s does, on similarity rows fetched for the
whole batch at once (``_sims_many_static`` / ``_sims_many_plan``), so a
batch reports, query by query, the bytes of ``find``.
"""

from __future__ import annotations

import copy
import functools
from typing import List

import numpy as np
import torch
import torch.nn.functional as F

from vectorian_tpu_torch.ops.dp_kernels import tag_weighted
from vectorian_tpu_torch.ops.emd_exact import emd_score_batch
from vectorian_tpu_torch.ops.search import (
    CTX_INPUT_BYTES,
    NEG_SCORE,
    BucketTopKSource,
    _HostCopies,
    _host,
    _pending_entry,
    order_by_score,
    stack_tree_plans,
    tag_weighted_multi,
)
from vectorian_tpu_torch.ops.simmatrix import eval_plan_chunk, plan_to
from vectorian_tpu_torch.parallel.mesh import MeshSearch
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


def _transport_chunk(L: int, T: int, d: int, Q: int = 1) -> int:
    """Slices a chunk of a transport pass over Q queries evaluates at once:
    the greedy fill's [c * Q, n1, n2, n2] comparison block within
    TRANSPORT_BLOCK_BYTES, the chunk's contextual vectors within
    CTX_INPUT_BYTES.  (The JAX package halves its chunk until chunk x Q <=
    4096, a TPU rule; the byte budget is the port's.)"""
    n2 = max(L, T)
    per = 4 * T * L * (n2 if n2 <= 128 else 8) * Q
    return max(1, min(TRANSPORT_BLOCK_BYTES // per,
                      CTX_INPUT_BYTES // (L * max(d, 1) * 4)))


class _ChunkArgs:
    """What a transport pass's chunk needs besides its rows: the plan, the
    tag rewrite's device arrays (or None) and the document filter's
    exclusion masks (or None)."""

    def __init__(self, engine, qp, tagw, doc_filter, T: int):
        self.engine = engine
        self.qp = qp
        self.ctx_names = list(qp.ctx_names)
        self.tw = WMDEngine._tagw_args(tagw, T, engine.device)
        self.df = WMDEngine._df_args(doc_filter, engine.device)
        self.d = sum(int(v.unmodified.shape[1]) for v in qp.ctx_vectors)

    def _step(self, L: int) -> int:
        return _transport_chunk(L, self.qp.width, self.d)

    def chunks(self, db, with_tag: bool):
        """(tok, pos, tag, ln, ctx) of each chunk of bucket ``db``: pos and
        tag ids only where the tag rewrite, the (id, tag) BOW or the filter
        read them."""
        n, L = db["n"], db["capacity"]
        need_pos = self.tw is not None or self.df is not None
        need_tag = with_tag or self.df is not None
        pos = self._ids(db, "pos") if need_pos else None
        tag = self._ids(db, "tag") if need_tag else None
        ctx = tuple(db["ctx"][nm] if "ctx" in db else self.engine._ctx_dev(nm, db["bi"])
                    for nm in self.ctx_names)
        step = self._step(L)
        for c0 in range(0, n, step):
            c1 = min(c0 + step, n)
            yield (
                db["tokens"][c0:c1],
                None if pos is None else pos[c0:c1],
                None if tag is None else tag[c0:c1],
                db["lengths"][c0:c1],
                tuple(c[c0:c1] for c in ctx),
            )

    def _ids(self, db, key: str):
        """The rows' "pos" or "tag" ids: a mesh shard's view carries them,
        an engine bucket uploads them at first use."""
        return db[key] if key in db else self.engine._bucket_ids(db, key)

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


class _MultiChunkArgs(_ChunkArgs):
    """``_ChunkArgs`` with a query axis: a batch's [c, L, T, Q] similarity
    block a chunk, and each query's tag rewrite.  The block is gathered
    from the static plans' stacked [V, T, Q] ``table`` by the chunk's
    token ids (the JAX package's ``_bucket_*_scores_multi``), else
    evaluated from the stacked tree plan ``sp`` (``stack_tree_plans``;
    its ``_bucket_*_scores_multi_plan``).  ``tw``: the [T, Q] / [Q] tag
    columns (``WMDEngine._tagw_args_multi``) or None; ``mags``: the
    vocabulary's magnitudes [V] of a static WRD batch."""

    def __init__(self, engine, table, sp, T: int, Q: int, tw, doc_filter,
                 mags=None, device=None):
        self.engine = engine
        self.device = torch.device(device) if device is not None else engine.device
        self.table = table
        self.qp = sp
        self.ctx_names = [] if sp is None else list(sp.ctx_names)
        self.T, self.Q = T, Q
        self.tw = tw
        self.df = WMDEngine._df_args(doc_filter, self.device)
        self.mags = mags
        self.d = (0 if sp is None
                  else sum(int(v.unmodified.shape[1]) for v in sp.ctx_vectors))

    def to(self, device) -> "_MultiChunkArgs":
        """These arguments with every tensor on ``device`` (a mesh shard's;
        itself on its own device)."""
        device = torch.device(device)
        if device == self.device:
            return self
        out = copy.copy(self)
        out.device = device
        out.table = None if self.table is None else self.table.to(device)
        out.qp = None if self.qp is None else plan_to(self.qp, device)
        out.tw = None if self.tw is None else tuple(t.to(device) for t in self.tw)
        out.df = None if self.df is None else tuple(t.to(device) for t in self.df)
        out.mags = None if self.mags is None else self.mags.to(device)
        return out

    def _step(self, L: int) -> int:
        return _transport_chunk(L, self.T, self.d, self.Q)

    def similarity(self, tok, pos, ctx, needs_magnitudes=False):
        c, L = tok.shape
        if self.table is not None:
            S = self.table[tok.long()]  # [c, L, T, Q]
            mags = self.mags[tok.long()] if needs_magnitudes else None
        else:
            out = eval_plan_chunk(self.qp, tok, ctx, needs_magnitudes=needs_magnitudes)
            S = out["similarity"].reshape(c, L, self.T, self.Q)
            mags = out.get("magnitudes_s")
        if self.tw is not None:
            S = tag_weighted_multi(S, pos, *self.tw)
        return S, mags


def _rwmd_chunk_scores_multi(S, tok, ln, tag, keep, mass_t, len_t, max_score_t,
                             injective: bool, symmetric: bool,
                             normalize_bow: bool, unique: bool, tagged: bool):
    """[c, Q] relaxed-WMD scores of one chunk against Q queries (the JAX
    package's ``_rwmd_chunk_scores_multi``): S [c, L, T, Q] the chunk's
    (tag-rewritten) block, ``keep`` the filter's mask or None, mass_t [T,
    Q] the queries' masses, len_t [Q] their lengths, max_score_t [Q] their
    bow-mode maximum costs.  Problem b = slice * Q + query."""
    c, L, T, Q = S.shape
    valid = torch.arange(L, device=S.device)[None, :] < ln[:, None]
    if unique:
        mass_s = (keep if keep is not None else valid).to(torch.float32)
    else:
        mass_s = _device_masses(tok, ln, tag if tagged else None, keep=keep)
    eff_len = (keep.sum(1) if keep is not None else ln).to(torch.float32)
    w_sum_s = torch.clamp_min(eff_len, 1e-9)  # [c]
    w_sum_t = torch.clamp_min(len_t.to(torch.float32), 1e-9)  # [Q]
    if normalize_bow:
        m_s = mass_s / w_sum_s[:, None]
        m_t = mass_t / w_sum_t[None, :]
    else:
        m_s, m_t = mass_s, mass_t
    D = torch.clamp_min(MAX_SIMILARITY - S, 0.0)
    Dts = D.permute(0, 3, 2, 1).reshape(c * Q, T, L)
    m_t_b = m_t.T[None].expand(c, Q, T).reshape(c * Q, T)
    m_s_b = m_s.repeat_interleave(Q, dim=0)  # [c * Q, L]
    acc0 = _greedy_fill_cost(m_t_b, Dts, m_s_b, injective)
    if not normalize_bow:
        acc0 = acc0 / w_sum_t.repeat(c)
    if symmetric:
        Dst = D.permute(0, 3, 1, 2).reshape(c * Q, L, T)
        acc1 = _greedy_fill_cost(m_s_b, Dst, m_t_b, injective)
        if not normalize_bow:
            acc1 = acc1 / w_sum_s.repeat_interleave(Q)
        cost = torch.maximum(acc0, acc1)
    else:
        cost = acc0
    # cost_to_score (wmd.h:139-141): max_cost 1 (nbow), else the bow
    # mode's max_sum_of_similarities (wmd.h:411-412)
    max_cost = 1.0 if normalize_bow else torch.clamp_min(max_score_t, 1e-9).repeat(c)
    score = ((max_cost - cost) / max_cost).reshape(c, Q)
    return torch.where(eff_len[:, None] > 0, score, NEG_SCORE)


def _emd_chunk_scores_multi(S, mags_s, tok, ln, tag, keep, mass_t,
                            use_magnitudes: bool, normalize_mass: bool,
                            unique: bool, tagged: bool):
    """[c, Q] full-WMD / WRD score bounds of one chunk against Q queries
    (the JAX package's ``_emd_chunk_scores_multi``): the masses mirror the
    host rescore's (the same normalization, (id, tag) identity and filter
    exclusions), so ``_emd_score_bound``'s guarantee carries to the
    reported scores.  ``mags_s`` [c, L]: the WRD document masses."""
    c, L, T, Q = S.shape
    valid = torch.arange(L, device=S.device)[None, :] < ln[:, None]
    if keep is not None:
        valid = keep
    if use_magnitudes:
        m_s = torch.where(valid, mags_s, 0.0)
    elif unique:
        m_s = valid.to(torch.float32)
    else:
        m_s = _device_masses(tok, ln, tag if tagged else None, keep=keep)
    m_t = mass_t.T[None].expand(c, Q, T).reshape(c * Q, T)
    m_s_b = m_s.repeat_interleave(Q, dim=0)
    if normalize_mass:
        m_s_b = m_s_b / torch.clamp_min(m_s_b.sum(1, keepdim=True), 1e-9)
        m_t = m_t / torch.clamp_min(m_t.sum(1, keepdim=True), 1e-9)
    D = torch.clamp_min(MAX_SIMILARITY - S, 0.0)
    Dts = D.permute(0, 3, 2, 1).reshape(c * Q, T, L)
    score = _emd_score_bound(m_t, m_s_b, Dts).reshape(c, Q)
    return torch.where((valid.sum(1) > 0)[:, None], score, NEG_SCORE)


def _boosted(scores, boost):
    """Valid scores times their slices' boosts ([n, Q] or None), the
    NEG_SCORE sentinels kept (the JAX package's arithmetic)."""
    if boost is None:
        return scores
    return torch.where(scores > NEG_SCORE * 0.5, scores * boost, NEG_SCORE)


def _bucket_rwmd_scores_multi(args: _MultiChunkArgs, db, mass_t, len_t, max_score_t,
                              injective: bool, symmetric: bool, normalize_bow: bool,
                              unique: bool, tagged: bool, boost=None) -> torch.Tensor:
    """[n, Q] relaxed-WMD scores of bucket ``db`` for a batch of Q queries
    in one pass (the JAX package's ``_bucket_rwmd_scores_multi`` and
    ``_bucket_rwmd_scores_multi_plan``), times ``boost`` [n, Q]."""
    out = []
    L = db["capacity"]
    for tok, pos, tag, ln, ctx in args.chunks(db, tagged):
        S, _ = args.similarity(tok, pos, ctx)
        valid = torch.arange(L, device=tok.device)[None, :] < ln[:, None]
        out.append(_rwmd_chunk_scores_multi(
            S, tok, ln, tag, args.keep(tok, pos, tag, valid), mass_t, len_t,
            max_score_t, injective, symmetric, normalize_bow, unique, tagged))
    return _boosted(torch.cat(out), boost)


def _bucket_emd_scores_multi(args: _MultiChunkArgs, db, mass_t, use_magnitudes: bool,
                             normalize_mass: bool, unique: bool, tagged: bool,
                             boost=None) -> torch.Tensor:
    """[n, Q] full-WMD / WRD score bounds of bucket ``db`` for a batch
    (the JAX package's ``_bucket_emd_scores_multi`` and
    ``_bucket_emd_scores_multi_plan``); a boost multiplies the bounds
    (bound * b >= exact * b for b >= 0: the cut stays provable)."""
    out = []
    L = db["capacity"]
    for tok, pos, tag, ln, ctx in args.chunks(db, tagged):
        S, mags = args.similarity(tok, pos, ctx, needs_magnitudes=use_magnitudes)
        valid = torch.arange(L, device=tok.device)[None, :] < ln[:, None]
        out.append(_emd_chunk_scores_multi(
            S, mags, tok, ln, tag, args.keep(tok, pos, tag, valid), mass_t,
            use_magnitudes, normalize_mass, unique, tagged))
    return _boosted(torch.cat(out), boost)


def _pairs_sims_static(tok, pos, qidx, table, tw):
    """(S weighted [p, L, T], S unweighted) of (slice, query) pairs: the
    rows ``tok`` [p, L] of the static plans' stacked [V, T, Q] ``table``
    at each pair's query ``qidx`` [p], tag-weighted with the pair's own
    column of ``tw`` (pos [p, L]) where given — the gather selects exact
    elements and the rewrite is ``tag_weighted``'s arithmetic, so the rows
    have the bits of ``find``'s (the JAX package's ``_pairs_sims_static``,
    which gathers from a [Q * V, T] stack of the table: indexing the table
    itself copies nothing)."""
    S = table[tok.long(), :, qidx.long()[:, None]]  # [p, L, T]
    if tw is None:
        return S, S
    w, p, pen, thr = tw
    q = qidx.long()
    sel = torch.where(pos[:, :, None] == p.T[q][:, None, :], 1.0,
                      1.0 - pen[q][:, None, None])
    Sw = S * (w.T[q][:, None, :] * sel)
    return torch.where(Sw > thr[q][:, None, None], Sw, 0.0), S


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
    """Transport-metric search over a BruteForceEngine's packed buckets:
    ``find`` and ``find_batch`` (the JAX package's; ``find_batch(mesh=)``
    shards the ranking pass)."""

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

    def find_batch(self, index, queries, qps, n: int, min_score: float,
                   tagws=None, boosts=None, doc_filter=None, mesh=None) -> List[List]:
        """Q queries in one corpus pass (the JAX package's ``find_batch``),
        then each query's host rescore as ``find``'s — every score a match
        reports is the host's (``rwmd_score_host``, or the exact EMD), so
        each query gets the bytes of its ``find``.  ``mesh`` (a
        ``parallel.mesh.Mesh`` or ``MeshSearch``) shards the ranking pass
        over its devices (``_ranking_source``); the host rescore, the consume
        rounds and the exact cut stay the single-device batch's.

        ``qps``: each query's plan at its padded width; static plans
        (("static", 0)) stack into one [V, T, Q] table, any other tree
        stacks per leaf (``stack_tree_plans``).  ``tagws``: per query a
        TagWeightingSpec or None (the rewrite, and the (id, tag) BOW
        identity); ``boosts``: per query an [n_slices] multiplier or None
        (ranking and reported scores); ``doc_filter``: the batch's
        document-side filter (excluded tokens carry no mass)."""
        engine = self._engine
        a = self._args
        mesh = None if mesh is None else MeshSearch.of(mesh)
        dev = engine.device
        Q = len(queries)
        tagws = list(tagws) if tagws is not None else [None] * Q
        widths = [qp.width for qp in qps]
        is_static = all(qp.plan == ("static", 0) for qp in qps)
        # a contextual operand anywhere in the tree: position-unique BOW
        # entries (reference metric/alignment.h:551-576), as in find
        unique = not qps[0].is_static_only
        if is_static:
            Tmax = max(widths)
            table = torch.stack([F.pad(qp.static_sims[0], (0, Tmax - w))
                                 for qp, w in zip(qps, widths)], dim=2)  # [V, T, Q]
            sp = None
        else:
            sp, Tmax = stack_tree_plans(qps, [max(q.n_tokens, 1) for q in queries], dev)
            table = None
        with_tags = any(tw is not None for tw in tagws)
        tagged = with_tags and not unique
        mass_t = np.zeros((Tmax, Q), np.float32)
        max_score_t = np.zeros((Q,), np.float32)
        states = []
        for qi, (query, qp) in enumerate(zip(queries, qps)):
            m = (np.ones((query.n_tokens,), np.float32) if unique
                 else self._query_masses(query, tagged=tagged))
            mass_t[: len(m), qi] = m
            tw = tagws[qi]
            max_score_t[qi] = tw.total if tw is not None else float(query.n_tokens)
            states.append({
                "mass_t": np.pad(m, (0, max(widths[qi] - len(m), 0))),
                "mass_t_mag": None, "tagw": tw, "tagged": tagged, "unique": unique,
                "T": query.n_tokens, "doc_filter": doc_filter,
                "boost": None if boosts is None else boosts[qi],
            })
        tw_args = self._tagw_args_multi(tagws, Tmax, Q, dev) if with_tags else None
        with_boost = boosts is not None and any(b is not None for b in boosts)
        mags = None
        if self._algorithm == "word-rotators-distance" and is_static:
            mags = qps[0].static_mags[0]
        args = _MultiChunkArgs(engine, table, sp, Tmax, Q, tw_args, doc_filter, mags)

        boosts = boosts if with_boost else None
        fetch = (table, tw_args) if is_static else None
        if not (self._algorithm == "word-movers-distance" and a["relaxed"]):
            return self._find_batch_emd(index, queries, qps, states, args, mass_t,
                                        unique, tagged, boosts, n, min_score, fetch,
                                        mesh)
        lt = np.asarray([q.n_tokens for q in queries], np.int32)

        @functools.cache
        def consts(device):
            return tuple(torch.as_tensor(x, device=device) for x in (mass_t, lt, max_score_t))

        def score(args, view, boost):
            return _bucket_rwmd_scores_multi(
                args, view, *consts(args.device), bool(a["injective"]),
                bool(a["symmetric"]), bool(a["normalize_bow"]), unique, tagged, boost)

        with trace.span("wmd.rank"):
            # the device top-k a bucket: only the pools reach the host;
            # their slack makes them tie-complete for the host's scores
            src = self._ranking_source(mesh, args, score, boosts, n + 32)
            eps = RWMD_RANK_EPS * (max(1.0, max(float(np.max(b)) for b in boosts
                                                if b is not None))
                                   if with_boost else 1.0)
            tops = src.top_k_exactly_many(range(Q), n, min_score - eps,
                                          slack=3 * eps, pool=True)
        with trace.span("wmd.sims_fetch"):
            sims_all = self._sims_many([(qi, tops[qi][0]) for qi in range(Q)],
                                       qps, states, fetch)
        results = []
        with trace.span("wmd.host_rescore"):
            for qi, (query, qp) in enumerate(zip(queries, qps)):
                top, smap, _rest = tops[qi]
                states[qi]["scores"] = smap
                results.append(self._relaxed_finalize(
                    index, query, qp, states[qi], top, n, min_score, None,
                    sims_map=sims_all[qi]))
        return results

    def _batch_emd_masses(self, index, queries, qps, states, Tmax: int, mass_t):
        """(the bound pass's masses [Tmax, Q], normalize, is_wrd) of a full
        WMD / WRD batch: the WRD needle magnitudes (a contextual plan's
        vector norms, else ``_static_needle_magnitudes``, also set as each
        state's "mass_t_mag"), else the bow counts ``mass_t`` — the exact
        rescore's masses (the provable cut needs them equal)."""
        a = self._args
        if self._algorithm != "word-rotators-distance":
            return mass_t, bool(a["normalize_bow"]), False
        mass = np.zeros((Tmax, len(queries)), np.float32)
        for qi, (query, qp) in enumerate(zip(queries, qps)):
            if qp.ctx_queries and not qp.is_static_only:
                mm = np.asarray(qp.ctx_queries[0]["magnitudes"], np.float32)
            else:
                mm = self._static_needle_magnitudes(qp, query, index)
            k = min(len(mm), Tmax)
            mass[:k, qi] = mm[:k]
            states[qi]["mass_t_mag"] = mm
        return mass, bool(a.get("normalize_magnitudes", True)), True

    def _find_batch_emd(self, index, queries, qps, states, args, mass_t, unique,
                        tagged, boosts, n: int, min_score: float, fetch, mesh=None):
        """Full WMD / WRD batch: one pass ranks Q queries by their provable
        bounds (``_emd_score_bound``: an upper bound on every exact score,
        on every shard of a mesh too), then ``_rescore_with_cut_many``
        solves each query's exact EMDs under its cut — the exhaustive
        exact-EMD oracle's top-k, the bytes of ``find``."""
        mass, normalize, is_wrd = self._batch_emd_masses(
            index, queries, qps, states, args.T, mass_t)

        @functools.cache
        def mass_on(device):
            return torch.as_tensor(mass, device=device)

        def score(args, view, boost):
            return _bucket_emd_scores_multi(args, view, mass_on(args.device), is_wrd,
                                            normalize, unique, tagged, boost)

        with trace.span("wmd.rank"):
            src = self._ranking_source(mesh, args, score, boosts, n + 32)
        return self._rescore_with_cut_many(index, queries, qps, states, src, n,
                                           min_score, fetch)

    def _rescore_with_cut_many(self, index, queries, qps, states, src, n: int,
                               min_score: float, fetch) -> List[List]:
        """The batch's provable cut (the JAX package's
        ``_rescore_with_cut_many``): each query consumes its fetched bound
        candidates in rounds (``_consume_rounds_many``); the queries whose
        unfetched bound can still reach their n-th exact score share ONE
        completion select, whose new candidates are consumed the same way."""
        packed = self._engine.packed
        Q = len(queries)
        # boosted bounds carry boost-scaled drift: the slack scales with it
        eps_q = [CUT_EPS * (max(1.0, float(np.max(st["boost"])))
                            if st.get("boost") is not None else 1.0)
                 for st in states]
        smaps, rests, cand_lists = [], [], []
        for qi in range(Q):
            rank_min = min_score - eps_q[qi]
            smap, rest = src.score_map(qi, rank_min)
            states[qi]["scores"] = smap
            smaps.append(smap)
            rests.append(rest)
            cand_lists.append(self._ordered_by_bound(
                {s: v for s, v in smap.items() if v >= rank_min}))
        sims_all = [dict() for _ in range(Q)]
        per_q = [[] for _ in range(Q)]
        pos = [0] * Q
        consume = (index, queries, qps, states, smaps, cand_lists, per_q, pos, n,
                   min_score, eps_q, sims_all, fetch)
        self._consume_rounds_many(*consume)
        unsafe, cuts = [], {}
        for qi in range(Q):
            cut = max(self._nth_cut(per_q[qi], n, min_score) - eps_q[qi],
                      min_score - eps_q[qi])
            if rests[qi] >= cut:
                unsafe.append(qi)
                cuts[qi] = cut
        if unsafe:
            with trace.span("wmd.rank"):
                found = src.above_vals_many(
                    [(src.qview(qi), cuts[qi], set(smaps[qi])) for qi in unsafe])
            for qi, (_ids, vmap) in zip(unsafe, found):
                new = {int(s): float(v) for s, v in vmap.items()
                       if int(s) not in smaps[qi] and v >= cuts[qi]}
                smaps[qi].update({int(s): float(v) for s, v in vmap.items()})
                # the consumed prefix's tail stayed below a cut that only
                # rises: only the new candidates need consuming
                cand_lists[qi] = self._ordered_by_bound(new)
                pos[qi] = 0
            self._consume_rounds_many(*consume, active=unsafe)
        results = []
        for matches in per_q:
            matches.sort(key=lambda m: (-m.score, int(packed.slice_doc[m.slice_id]),
                                        int(packed.slice_idx[m.slice_id])))
            results.append(matches[:n])
        return results

    def _consume_rounds_many(self, index, queries, qps, states, smaps, cand_lists,
                             per_q, pos, n, min_score, eps_q, sims_all, fetch,
                             active=None) -> None:
        """Batched ``_consume_ordered``: every active query advances one
        bound-ordered window a round, and the round's missing similarity
        rows of every query are fetched together; a query retires when its
        next candidate's bound is provably below its n-th exact score.
        Windows double up to ``step_cap`` (fewer rounds; an overshoot only
        costs host solves).

        Static plans (``fetch`` the stacked table and tag columns) keep the
        JAX package's speculation: the next window's rows are dispatched
        before this round's host solves and collected at the next round
        (the window assumes no query retires, so it is a superset of what
        the next round reads), and the handle left when the loop ends is
        collected.  Tree plans fetch at collect time, from the queries
        left after retirement (no speculation: their fetch is serial
        anyway), so they fetch no window of a retired query.  The windows
        consumed, and so the results, are the same either way."""
        step = max(2 * n, 32)
        step_cap = max(8 * step, 256)
        if active is None:
            active = range(len(queries))
        active = [qi for qi in active if pos[qi] < len(cand_lists[qi])]

        def build_items(act, start, stp):
            items = []
            for qi in act:
                window = cand_lists[qi][start(qi): start(qi) + stp]
                missing = [s for s in window if int(s) not in sims_all[qi]]
                if missing:
                    items.append((qi, missing))
            return items

        def retire(act):
            return [qi for qi in act if not (
                len(per_q[qi]) >= n and pos[qi] < len(cand_lists[qi])
                and smaps[qi][cand_lists[qi][pos[qi]]]
                < self._nth_cut(per_q[qi], n, min_score) - eps_q[qi])]

        def collect(fetched, items):
            for (qi, _), sm in zip(items, fetched):
                sims_all[qi].update(sm)

        active = retire(active)
        handle = None
        if fetch is not None and active:
            handle = self._sims_many_static_dispatch(
                build_items(active, lambda qi: pos[qi], step), *fetch)
        while active:
            with trace.span("wmd.sims_fetch"):
                if fetch is not None:
                    collect(*self._sims_many_static_collect(handle))
                    handle = None
                    nstep = min(2 * step, step_cap)
                    spec = [qi for qi in active if pos[qi] + step < len(cand_lists[qi])]
                    handle = self._sims_many_static_dispatch(
                        build_items(spec, lambda qi: pos[qi] + step, nstep), *fetch)
                else:
                    items = build_items(active, lambda qi: pos[qi], step)
                    collect(self._sims_many_plan(items, qps, states), items)
            nxt = []
            with trace.span("wmd.host_rescore"):
                for qi in active:
                    cand = cand_lists[qi]
                    per_q[qi].extend(self._host_rescore(
                        index, queries[qi], qps[qi], states[qi],
                        cand[pos[qi]: pos[qi] + step], min_score, None,
                        sims_map=sims_all[qi]))
                    pos[qi] += step
                    if pos[qi] < len(cand):
                        nxt.append(qi)
            step = min(2 * step, step_cap)
            active = retire(nxt)
        if handle is not None:
            # the last speculative window: collected (its rows may serve a
            # completion round), not left queued
            collect(*self._sims_many_static_collect(handle))

    def _sims_many(self, items, qps, states, fetch):
        """{sid: (Sw, Su)} per (qi, sids) item: the static plans' fused
        fetch, or the tree plans' (``_sims_many_plan``)."""
        if fetch is None:
            return self._sims_many_plan(items, qps, states)
        return self._sims_many_static_collect(
            self._sims_many_static_dispatch(items, *fetch))[0]

    def _sims_many_static_dispatch(self, items, table, tw):
        """Dispatch half of the static batch's fused similarity fetch (the
        JAX package's ``_sims_many_static_dispatch``): ``items`` [(qi,
        sids)] become (slice, query) pairs, one ``_pairs_sims_static`` a
        touched bucket on the rows gathered from the host copies (a paged
        engine pages nothing in for them), and their device -> host copies
        are queued.  Slices are gathered by token id in bucket order; the
        JAX package's sorted gather streams (a TPU gather-locality trick)
        change only the order of the memory reads, never a value.
        Returns the handle ``_sims_many_static_collect`` waits on."""
        engine = self._engine
        dev = engine.device
        refs, metas = [], []
        if items:
            sid_arr = np.concatenate([np.asarray(sids, np.int64) for _, sids in items])
            ii_arr = np.concatenate([np.full(len(sids), ii, np.int64)
                                     for ii, (_, sids) in enumerate(items)])
            qi_arr = np.concatenate([np.full(len(sids), qi, np.int64)
                                     for qi, sids in items])
            locs = engine._slice_loc[sid_arr]
            order = np.argsort(locs[:, 0], kind="stable")
            b_sorted = locs[order, 0]
            starts = np.flatnonzero(np.concatenate(([True], b_sorted[1:] != b_sorted[:-1])))
            for gi, g0 in enumerate(starts):
                g1 = starts[gi + 1] if gi + 1 < len(starts) else len(order)
                sel = order[g0:g1]
                b = engine.packed.buckets[int(b_sorted[g0])]
                rows = locs[sel, 1]
                tok = torch.as_tensor(b.token_ids[rows].astype(np.int32), device=dev)
                pos = (None if tw is None
                       else torch.as_tensor(b.pos_ids[rows], device=dev))
                qidx = torch.as_tensor(qi_arr[sel], device=dev)
                Sw, Su = _pairs_sims_static(tok, pos, qidx, table, tw)
                refs.extend((Sw,) if tw is None else (Sw, Su))
                metas.append((ii_arr[sel], sid_arr[sel]))
        # the copies start now: the collect only waits out what is left
        # of them after the host solves they ran under
        return {"copies": _HostCopies(refs), "metas": metas,
                "tagged": tw is not None, "items": items}

    def _sims_many_static_collect(self, handle):
        """The blocking half: (one {sid: (Sw, Su)} per item, the items)."""
        items = handle["items"]
        out = [dict() for _ in items]
        fetched = handle["copies"].wait()
        slice_len = self._engine.packed.slice_len
        k = 0
        for ii_sel, sid_sel in handle["metas"]:
            Sw = fetched[k]
            Su = fetched[k + 1] if handle["tagged"] else Sw
            k += 2 if handle["tagged"] else 1
            for r, (ii, sid) in enumerate(zip(ii_sel.tolist(), sid_sel.tolist())):
                ln = int(slice_len[sid])
                out[ii][sid] = (Sw[r, :ln], Su[r, :ln])
        return out, items

    def _sims_many_plan(self, items, qps, states):
        """The similarity rows of tree-plan batches: each (qi, sids) item
        through ``batch_slice_similarity`` under its own plan (the stacked
        pair table exists for static plans only); {sid: (Sw, Su)} maps."""
        engine = self._engine
        out = []
        for qi, sids in items:
            sids = list(sids)
            sims = engine.batch_slice_similarity(sids, qps[qi],
                                                 tag_weights=states[qi]["tagw"])
            out.append({int(s): sm for s, sm in zip(sids, sims)})
        return out

    @staticmethod
    def _tagw_args_multi(tagws, Tmax: int, Q: int, device):
        """The batch's tag columns on the device: weights and needle pos ids
        [Tmax, Q], penalty and threshold [Q]; a query without tag weights
        gets the identity columns (weight 1, pos -1, penalty 0, threshold
        -1), as in the JAX package."""
        tw_w = np.ones((Tmax, Q), np.float32)
        tw_p = np.full((Tmax, Q), -1, np.int8)
        pen = np.zeros((Q,), np.float32)
        thr = np.full((Q,), -1.0, np.float32)
        for qi, tw in enumerate(tagws):
            if tw is None:
                continue
            t = len(tw.t_pos_weights)
            tw_w[:t, qi] = tw.t_pos_weights
            tw_p[:t, qi] = tw.pos_t
            pen[qi] = tw.pos_mismatch_penalty
            thr[qi] = tw.similarity_threshold
        return tuple(torch.as_tensor(x, device=device) for x in (tw_w, tw_p, pen, thr))

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

    def _fetch_slice_sims(self, top, qp, tagw, sims_map=None):
        """[(Sw, Su)] per sid: one batched evaluation a touched bucket, or
        from ``sims_map`` ({sid: (Sw, Su)}, a batch's fused fetch), whose
        missing sids are evaluated and added to it."""
        engine = self._engine
        if sims_map is None:
            return engine.batch_slice_similarity(top, qp, tag_weights=tagw)
        missing = [sid for sid in top if int(sid) not in sims_map]
        if missing:
            for sid, sims in zip(missing, engine.batch_slice_similarity(
                    missing, qp, tag_weights=tagw)):
                sims_map[int(sid)] = sims
        return [sims_map[int(sid)] for sid in top]

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
        sims_map=None,
    ) -> List:
        """Relaxed-WMD finalize: REPORTED scores for the whole candidate
        pool via ``rwmd_score_host`` (the single shape-independent home —
        device vectors rank only), deterministic (score desc, doc, slice)
        order, then Match + flow extraction for the kept top-n ONLY (pools
        carry boundary slack, so building flows for every member would pay
        the python flow loops for candidates the order drops).  Returns
        the final ordered, min_score-filtered, n-truncated match list;
        ``sims_map`` as in ``_fetch_slice_sims``."""
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
        sims_list = self._fetch_slice_sims(pool, qp, tagw, sims_map)
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
        self, index, query, qp, state, top, min_score, debug, sims_map=None,
    ) -> List:
        """Exact host EMD rescore + flow extraction for the chosen slices
        (their similarities evaluated in one batch a touched bucket, or
        from a batch's ``sims_map``; relaxed WMD finalizes in
        ``_relaxed_finalize`` instead)."""
        from vectorian_tpu_torch.index import Match

        a = self._args
        mass_t = state["mass_t"]
        mass_t_mag = state["mass_t_mag"]
        tagw = state["tagw"]
        T = state["T"]

        matches = []
        token_sim_name = index._args["metric"]["token_sim"].name
        sims_list = self._fetch_slice_sims(top, qp, tagw, sims_map)
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
        eng = self._engine
        # a paged engine's store is on the host: read its row there
        store = (eng._ctx_stores[qp.ctx_names[0]][bi] if eng.paged
                 else eng._ctx_dev(qp.ctx_names[0], bi))
        return np.linalg.norm(_host(store[r, :ln].float()), axis=-1).astype(np.float64)

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

    def _ranking_source(self, mesh, args, score, boosts, k: int):
        """The batch's ranking pass as its ``BucketTopKSource`` (the
        per-entry top-k fetch): ``score(args, view, boost)`` -> the [n, Q]
        ranking scores of every live bucket on the engine's device (boost
        its [n, Q] multipliers, or None), or, with ``mesh`` (a
        MeshSearch), of every shard of every bucket on the shard's device
        (``MeshSearch.transport_scores``: ``args.to(device)``; each shard
        a pending entry of its own, ``MeshSearch.pending``, so the source
        merges the shards' local top-k and its completion selects read the
        shards' scores where they lie: the JAX package's
        ``_find_batch_mesh_rwmd`` / ``_find_batch_mesh_emd`` shard pass
        and merge)."""
        engine = self._engine
        if mesh is None:
            pending = self._buckets_pass(lambda db: score(
                args, db, None if boosts is None else engine._boost_matrix(db, boosts)))
        else:
            pending = mesh.pending(
                engine,
                lambda db, sh, boost, ctx: mesh.transport_scores(args, score, *sh, boost, ctx),
                boosts, args.ctx_names)
        return BucketTopKSource(engine, pending, args.Q, k)

    def _buckets_pass(self, fn):
        """``fn(db)`` -> [n, Q] device scores of every non-empty bucket: the
        pending list of BucketTopKSource (lazy entries when paged:
        ``_pending_entry``)."""
        engine = self._engine
        return [_pending_entry(db, lambda db=db: (db, fn(db)), engine.paged)
                for db in engine._live_buckets()]

    def _score_buckets_rwmd(self, qp, mass_t, len_t, injective, symmetric,
                            normalize_bow, unique, tagw=None, tagged=False,
                            doc_filter=None, device=False):
        """One query's pass: the pending list of its [n, 1] scores, or
        (``device`` False) the [n_slices] host vector."""
        args = _ChunkArgs(self._engine, qp, tagw, doc_filter, qp.width)
        max_score_t = tagw.total if tagw is not None else float(len_t)
        m_t = torch.as_tensor(np.asarray(mass_t, np.float32), device=self._engine.device)
        pending = self._buckets_pass(lambda db: _bucket_rwmd_scores(
            args, db, m_t, len_t, max_score_t, injective, symmetric, normalize_bow,
            unique, tagged)[:, None])
        return pending if device else self._engine.collect(pending)[:, 0]

    def _score_buckets_emd(self, qp, mass_t, use_magnitudes, normalize, unique,
                           tagw=None, tagged=False, doc_filter=None, device=False):
        """As ``_score_buckets_rwmd``, of the full WMD / WRD bounds."""
        args = _ChunkArgs(self._engine, qp, tagw, doc_filter, qp.width)
        m_t = torch.as_tensor(np.asarray(mass_t, np.float32), device=self._engine.device)
        pending = self._buckets_pass(lambda db: _bucket_emd_scores(
            args, db, m_t, use_magnitudes, normalize, unique, tagged)[:, None])
        return pending if device else self._engine.collect(pending)[:, 0]
