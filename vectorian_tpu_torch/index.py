"""Query construction, indexes and matches.

Reference: vectorian/index.py — Query/PreparedQuery (:25-106), Match ABC +
to_json (:249-292), CoreMatch region reconstruction (:295-379) and
BruteForceIndex thread fan-out (:509-560).

Port mapping (vectorian_tpu/index.py, alignment metrics, affine and
general gap models): the per-document ThreadPool disappears — the packed
corpus is scored in one batched device pass per bucket
(ops/search.BruteForceEngine); the bounded top-k heap becomes a device top-k
fused with the exact rescore of the selected rows; flows are recomputed for
the global top-k only.  A static ``find`` is ``find_batch`` with one query:
both run the same corpus pass and the same finalizer, so their (slice_id,
score) lists are byte-identical.  The query options tag weights,
``pos_filter`` / ``tag_filter`` / ``token_filter``, ``booster``,
``bidirectional`` and ``submatch_weight`` ride that pass in both.
``debug``, contextual and mixed-tree plans take ``find``'s full-read paths
(``score_topk`` / ``score_all`` and an exact rescore with flows), their
``find_batch`` the batched contextual or tree pass; both report the exact
rescore's scores under a provable cut, so they too are byte-equal.  The
transport metrics' ``find`` runs ops/wmd (a ranking pass on the device,
the reported scores on the host); span embeddings have indexes of their
own (``SpanEncoderIndex``, ``ApproximateSpanIndex``).  ``mesh=`` shards
each batch path's corpus pass over a ``parallel.mesh`` mesh of devices
and returns the single-device bytes (``MeshSearch.pending``).
"""

from __future__ import annotations

import dataclasses
import os
import time
from collections import namedtuple
from typing import Dict, List, Optional

import numpy as np
import torch

from vectorian_tpu_torch.alignment import resolve_affine_gaps
from vectorian_tpu_torch.ops.alignment import AffineGapParams
from vectorian_tpu_torch.ops.search import (
    BruteForceEngine,
    BucketTopKSource,
    DocFilterSpec,
    TagWeightingSpec,
    _host,
    batch_tracebacks,
    corpus_tag_columns,
    edge_sims_of,
    gap_vec,
    order_by_score,
    quantization_entry_err,
    reference_score,
    stack_query_tables,
)
from vectorian_tpu_torch.ops.simmatrix import (
    QueryPlan,
    compile_plan,
    plan_sim_upper,
    query_vectors,
)
from vectorian_tpu_torch.parallel.mesh import MeshSearch
from vectorian_tpu_torch.session import Result
from vectorian_tpu_torch.utils import trace
from vectorian_tpu_torch.vocabulary import UPOS


# per-query options find_batch serves through find, query by query (the JAX
# package's BATCH_HARD_OPTIONS): debug's payloads are per-query host
# diagnostics
BATCH_HARD_OPTIONS = frozenset({"debug"})


def _rev_rows(v, n_tokens: int) -> np.ndarray:
    """``v`` with its first ``n_tokens`` rows reversed, the rest kept."""
    v = np.asarray(v)
    return np.concatenate([v[:n_tokens][::-1], v[n_tokens:]], axis=0)


def _reverse_ctx_query(d: dict, n_tokens: int) -> dict:
    """A contextual needle dict with its first ``n_tokens`` rows reversed
    (bidirectional matching)."""
    return {k: _rev_rows(v, n_tokens) for k, v in d.items()}


def _reverse_plan(qp: QueryPlan, n_tokens: int) -> QueryPlan:
    """The plan with its first ``n_tokens`` needle columns reversed
    (bidirectional matching): static matrices' columns and contextual
    needle rows; the padding stays at the tail, so the len_t mask keeps
    working.  The columns are copies: the same bits."""

    def rev(m):
        return torch.cat([torch.flip(m[:, :n_tokens], dims=(1,)), m[:, n_tokens:]], 1)

    if qp.is_static_only:
        m = rev(qp.matrix)
        return dataclasses.replace(qp, matrix=m, static_sims=[m])
    ctx_q = [_reverse_ctx_query(q, n_tokens) for q in qp.ctx_queries]
    dev = qp.ctx_vectors[0].unmodified.device
    return dataclasses.replace(
        qp,
        static_sims=[rev(m) for m in qp.static_sims],
        ctx_queries=ctx_q,
        ctx_vectors=[query_vectors(q, dev) for q in ctx_q],
    )


def _reverse_tagw(tagw, n_tokens: int):
    """The TagWeightingSpec of the reversed needle (None stays None)."""
    if tagw is None:
        return None
    return dataclasses.replace(
        tagw, t_pos_weights=_rev_rows(tagw.t_pos_weights, n_tokens),
        pos_t=_rev_rows(tagw.pos_t, n_tokens),
    )


def _submatch_upper_bound(device_score, norm_total: float, w: float,
                          sim_max: float = 1.0):
    """Upper bound on the submatch-rescored score of any slice whose
    device-normalized score is <= ``device_score`` (no boost).

    exact = raw / reference_score(total, matched, w) with raw <= matched *
    sim_max and matched <= total; reference_score(m) = m + ((total - m) /
    total)^w (total - m) is least at m* = total (1 - (1 + w)^(-1/w)), so the
    least over m in [raw / sim_max, total] is ref(max(raw / sim_max, m*)):
    a bound monotone in the device score, which makes device-ranked
    overfetch + exact rescore provably complete (metric/alignment.h:84-106).
    """
    total = max(norm_total, 1e-9)
    sim_max = max(float(sim_max), 1e-9)
    d = np.asarray(device_score, np.float64)
    raw = np.maximum(d, 0.0) * total
    if w <= 0:
        return np.where(d < 0, d, np.minimum(d, sim_max))
    m_star = total * (1.0 - (1.0 / (1.0 + w)) ** (1.0 / w))
    m = np.minimum(np.maximum(raw / sim_max, m_star), total)
    ref = np.maximum(reference_score(total, m, w), 1e-12)
    ub = np.minimum(raw / ref, sim_max)
    return np.where(d < 0, d, ub)


def _bisect_thresh(f, t: float) -> float:
    """The largest d with f(d) < t for a monotone f with f(d) >= d, by 60
    bisection steps from [min(-1, t - 1), max(t, lo + 1)]; -inf when f is
    already >= t there."""
    lo = min(-1.0, float(t) - 1.0)
    hi = max(float(t), lo + 1.0)
    if f(lo) >= t:
        return -np.inf
    for _ in range(60):
        mid = 0.5 * (lo + hi)
        if f(mid) >= t:
            hi = mid
        else:
            lo = mid
    return lo


def _submatch_fetch_thresh(t: float, norm_total: float, w: float,
                           sim_max: float, eps_q: float) -> float:
    """The largest device score provably unable to reach a
    submatch-rescored score of ``t``: every slice that can reach t has a
    device score strictly above it (``eps_q`` covers device-vs-exact
    drift), so fetching everything >= it is a provably complete extras
    round; -inf when nothing can be excluded."""
    return _bisect_thresh(
        lambda d: float(_submatch_upper_bound(d + eps_q, norm_total, w, sim_max)), t
    )


def _submatch_bound_boosted(d, boost, norm_total: float, w: float,
                            sim_max: float, eps_q: float = 0.0) -> float:
    """Upper bound on the BOOSTED submatch-rescored score of any slice whose
    boosted device score is <= ``d``: max over the boost values b present
    of b * ub(d / b + eps_q) (the boost factors out of the exact score and
    the device multiply alike).  Non-positive boosts give <= 0; a negative
    one makes the bound vacuous (+inf: the caller reads everything)."""
    b = np.unique(np.asarray(boost, np.float64))
    if b.size and b[0] < 0:
        return np.inf
    b = b[b > 0]
    if not b.size:
        return 0.0
    vals = b * _submatch_upper_bound(
        np.asarray(d, np.float64) / b + eps_q, norm_total, w, sim_max
    )
    return float(np.max(vals))


def _submatch_fetch_thresh_boosted(t: float, boost, norm_total: float,
                                   w: float, sim_max: float,
                                   eps_q: float) -> float:
    """``_submatch_fetch_thresh`` of boosted scores: the bisected inverse
    of ``_submatch_bound_boosted``."""
    b = np.unique(np.asarray(boost, np.float64))
    if b.size and b[0] < 0:
        return -np.inf
    b = b[b > 0]
    if not b.size:
        # all-zero boosts: every boosted score is 0
        return np.inf if t > 0 else -np.inf
    return _bisect_thresh(
        lambda d: float(np.max(
            b * _submatch_upper_bound(d / b + eps_q, norm_total, w, sim_max)
        )), t,
    )


def _metric_ctx_names(token_sim):
    """Names of the contextual embeddings a token-sim tree uses."""
    return {
        e.name for e in token_sim.embeddings
        if not getattr(e, "is_static", True)
    }


def _pad_needle(query: "PreparedQuery", session=None, ctx_names=()):
    """Pad the needle to a multiple of 4 tokens (at least 4): padded ids
    are -1, strings empty, contextual rows zero.  Plans of one padded width
    give find() and find_batch() the same GEMM shape, hence the same bits.
    ``ctx_names``: the contextual embeddings to encode the needle with
    (``session``'s).  Returns (token_ids, strings, {name: needle dict},
    Tpad)."""
    T = query.n_tokens
    Tpad = max(4, -(-T // 4) * 4)
    pad_n = Tpad - T
    tok_ids = np.concatenate(
        [np.asarray(query.token_ids, np.int32), np.full((pad_n,), -1, np.int32)]
    )
    strings = list(query.token_strings) + [""] * pad_n
    ctx_q = {}
    if ctx_names:
        for name, d in query.contextual_vectors(session, names=ctx_names).items():
            ctx_q[name] = {
                k: np.pad(np.asarray(v),
                          ((0, pad_n),) + ((0, 0),) * (np.ndim(v) - 1))
                for k, v in d.items()
            }
    return tok_ids, strings, ctx_q, Tpad


class Query:
    """An unprepared query (reference index.py:25-54)."""

    def __init__(self, index, text: str, options: dict):
        self._index = index
        self._text = text
        self._options = options
        self._aborted = False

    def abort(self):
        """Cooperative cancellation (reference Query::abort, query.h:183-189;
        checked after the corpus pass here)."""
        self._aborted = True

    @property
    def aborted(self):
        return self._aborted

    @property
    def index(self):
        return self._index

    @property
    def text(self):
        return self._text

    @property
    def options(self):
        return self._options

    def prepare(self, nlp):
        return PreparedQuery(self, nlp)


class PreparedQuery:
    """NLP-parsed, normalized query bound to the session vocabulary
    (reference index.py:56-106 + core Query::initialize query.cpp:32-154)."""

    def __init__(self, query: Query, nlp):
        self._query = query
        session = query.index.session
        doc = nlp(query.text)
        self._sdoc = doc
        j = doc.to_json() if hasattr(doc, "to_json") else doc

        tokens = j["tokens"]
        table = {
            "text": [query.text[t["start"] : t["end"]] for t in tokens],
            "pos": [t.get("pos", "X") for t in tokens],
            "tag": [t.get("tag", "XX") for t in tokens],
        }
        char_spans = [(t["start"], t["end"]) for t in tokens]
        mask = session.normalization.apply(table)

        # query-side pos/tag filters (reference index.py:78-83): tokens whose
        # pos/tag is listed are excluded from the needle
        pos_filter = set(query.options.get("pos_filter") or ())
        tag_filter = set(query.options.get("tag_filter") or ())
        for i in range(len(tokens)):
            if table["pos"][i] in pos_filter or table["tag"][i] in tag_filter:
                mask[i] = False

        keep = np.flatnonzero(mask)
        self.token_strings = [table["text"][i] for i in keep]
        self.token_pos = [table["pos"][i] for i in keep]
        self.token_tag = [table["tag"][i] for i in keep]
        self.char_spans = [char_spans[i] for i in keep]
        self.all_char_spans = char_spans
        self.kept = keep
        # corpus vocab ids (-1 if OOV — the reference's incremental query
        # vocab; OOV tokens still get metric rows via their own vectors)
        self.token_ids = session.vocab.tokens.lookup_many(self.token_strings)
        self.pos_ids = np.asarray(
            [session.vocab.pos_id(p) for p in self.token_pos], np.int8
        )

    def contextual_vectors(self, session, names=None) -> dict:
        """name -> {unmodified, normalized, magnitudes} needle vectors of
        the session's contextual embeddings (the reference encodes the
        query through the same encoders, index.py:66-74); ``names``
        restricts it to the embeddings the metric uses."""
        out = {}
        for name in session.contextual_embeddings:
            if names is not None and name not in names:
                continue
            out[name] = session.encode_contextual_query(
                name, self._sdoc, self.text, self.kept
            )
        return out

    @property
    def query(self):
        return self._query

    @property
    def text(self):
        return self._query.text

    @property
    def options(self):
        return self._query.options

    @property
    def n_tokens(self):
        return len(self.token_strings)


Region = namedtuple("Region", ["s", "match", "gap_penalty"])
TokenMatch = namedtuple("TokenMatch", ["pos_s", "edges"])
TokenMatchEdge = namedtuple("TokenMatchEdge", ["t", "flow", "distance", "metric"])
TokenMatchT = namedtuple("TokenMatchT", ["text", "index", "pos"])


class _FlowResolver:
    """Deferred flow extraction for one query's top-n matches.

    Serving batches report exact scores from the fused fetch; the flow
    MAPPINGS of matches whose payload did not ride the transfer are only
    needed when a consumer actually reads regions/edges.  The first access
    to any member's mapping runs ONE batched rescore for the whole group
    and injects every member's flows — same rescore_many arithmetic, so
    resolved mappings are byte-identical to eager ones (the reference's
    finalizer computes flows for the top-k eagerly,
    matcher_impl.h:172-174; deferring to first access is a latency
    trade)."""

    def __init__(self, index, plan, len_t, tagw, gaps, locality, gap_costs,
                 doc_filter):
        self._index = index
        self._plan = plan
        self._len_t = len_t
        self._tagw = tagw
        self._gaps = gaps
        self._locality = locality
        self._gap_costs = gap_costs
        self._doc_filter = doc_filter
        self._members = []  # (match, sid)
        self._done = False

    def add(self, match, sid: int) -> None:
        self._members.append((match, sid))

    def resolve(self) -> None:
        if self._done:
            return
        self._done = True
        if not self._members:
            return
        (res,) = self._index._engine.rescore_many(
            [
                {
                    "slice_ids": [sid for _, sid in self._members],
                    "qp": self._plan,
                    "len_t": self._len_t,
                    "tag_weights": self._tagw,
                    "want_flows": True,
                }
            ],
            self._gaps,
            self._locality,
            gap_costs=self._gap_costs,
            doc_filter=self._doc_filter,
        )
        mappings, edge_sims, _raw = res
        for (m, _sid), mp, es in zip(self._members, mappings, edge_sims):
            m._set_flows(mp, es)


class Match:
    """A single search hit; JSON shape mirrors reference index.py:249-292."""

    def __init__(
        self,
        index: "Index",
        query: PreparedQuery,
        slice_id: int,
        score: float,
        metric: str = "",
        mapping: Optional[np.ndarray] = None,
        similarities: Optional[np.ndarray] = None,
        edge_list: Optional[list] = None,  # [(t, s, flow, distance)]
        level: str = "word",
        flow_resolver: Optional[_FlowResolver] = None,
    ):
        self._index = index
        self._query = query
        self._slice_id = int(slice_id)
        self._score = float(score)
        self._metric = metric
        self._mapping_v = mapping
        self._similarities_v = similarities
        self._edge_list = edge_list
        self._level = level
        self._flow_resolver = flow_resolver

    @property
    def _mapping(self):
        if self._mapping_v is None and self._flow_resolver is not None:
            self._flow_resolver.resolve()
        return self._mapping_v

    @property
    def _similarities(self):
        if self._similarities_v is None and self._flow_resolver is not None:
            self._flow_resolver.resolve()
        return self._similarities_v

    def _set_flows(self, mapping, similarities) -> None:
        self._mapping_v = np.asarray(mapping, np.int32)
        self._similarities_v = similarities
        self._flow_resolver = None

    @property
    def index(self):
        return self._index

    @property
    def query(self):
        return self._query

    @property
    def slice_id(self):
        return self._slice_id

    @property
    def score(self):
        return self._score

    @property
    def metric(self):
        return self._metric

    @property
    def level(self):
        return self._level

    @property
    def prepared_doc(self):
        packed = self._index.packed
        return self._index.session.documents[int(packed.slice_doc[self._slice_id])]

    @property
    def doc(self):
        return self.prepared_doc.doc

    @property
    def slice_span(self):
        """(token_start, token_len) of the matched slice in filtered space."""
        packed = self._index.packed
        return (
            int(packed.slice_start[self._slice_id]),
            int(packed.slice_len[self._slice_id]),
        )

    @property
    def span(self):
        """The matched slice as a browsable :class:`corpus.document.Span`
        of original document tokens (reference Span browsing objects,
        corpus/document.py:575-623)."""
        s, ln = self.slice_span
        return self.prepared_doc.span_from_filtered(s, s + ln)

    @property
    def flow(self):
        """Flow dict: injective (reference InjectiveFlow.to_py,
        match/flow.cpp:191-216) for alignments, sparse edge list (SparseFlow
        flow.cpp:243-258) for transport metrics."""
        if self._edge_list is not None:
            return {
                "type": "sparse",
                "edges": [
                    {"t": t, "s": s, "flow": f, "distance": d}
                    for (t, s, f, d) in self._edge_list
                ],
            }
        if self._mapping is None:
            return None
        t = np.asarray(self._mapping, np.int32)
        flow = (t >= 0).astype(np.float32)
        dist = np.where(
            t >= 0,
            1.0 - (self._similarities if self._similarities is not None else 0.0),
            1.0,
        ).astype(np.float32)
        return {"type": "injective", "target": t, "flow": flow, "distance": dist}

    def _edges_by_s(self) -> Dict[int, list]:
        """s offset -> [(t, flow, distance)] from whichever flow repr."""
        out: Dict[int, list] = {}
        if self._edge_list is not None:
            for t, s, f, d in self._edge_list:
                out.setdefault(int(s), []).append((int(t), float(f), float(d)))
        elif self._mapping is not None:
            for jt, s in enumerate(self._mapping):
                if s >= 0:
                    sim = (
                        float(self._similarities[jt])
                        if self._similarities is not None
                        else 0.0
                    )
                    out.setdefault(int(s), []).append((jt, 1.0, 1.0 - sim))
        return out

    @property
    def omitted(self) -> List[str]:
        matched_t = set()
        if self._edge_list is not None:
            matched_t = {t for (t, s, f, d) in self._edge_list}
        elif self._mapping is not None:
            matched_t = {jt for jt, s in enumerate(self._mapping) if s >= 0}
        else:
            return []
        out = []
        for jt in range(len(self._query.char_spans)):
            if jt not in matched_t:
                c0, c1 = self._query.char_spans[jt]
                out.append(self._query.text[c0:c1])
        return out

    def regions(self, context_size: int = 10) -> List[Region]:
        """Reconstruct text regions (reference Flow::py_regions,
        match/flow.cpp:8-167): context, gap runs with penalties, matched
        tokens with query-token edges."""
        pd = self.prepared_doc
        doc = pd.doc
        start, length = self.slice_span
        s_to_t = self._edges_by_s()  # s offset -> [(t, flow, distance)]

        def char_range(f_lo, f_hi):
            # filtered token positions [f_lo, f_hi) -> char range in doc text
            o_lo = pd.orig_index[start + f_lo]
            o_hi = pd.orig_index[start + f_hi - 1]
            c0 = int(doc.idx[o_lo])
            c1 = int(doc.idx[o_hi] + doc.len_[o_hi])
            return c0, c1

        regions: List[Region] = []
        text = doc.text
        if length == 0:
            return regions

        # leading context: context_size is measured in TOKENS (reference
        # py_regions last_anchor arithmetic, flow.cpp:44 + 157-164)
        c0, _ = char_range(0, 1)
        lead = min(context_size, start)
        if lead > 0:
            o_ctx = pd.orig_index[start - lead]
            ctx0 = int(doc.idx[o_ctx])
            if ctx0 < c0:
                regions.append(
                    Region(s=text[ctx0:c0], match=None, gap_penalty=0.0)
                )

        gaps = self._index.gap_costs()
        i = 0
        while i < length:
            if i in s_to_t:
                edges = []
                for jt, fl, dist in s_to_t[i]:
                    c0q, c1q = self._query.char_spans[jt]
                    edges.append(
                        TokenMatchEdge(
                            t=TokenMatchT(
                                text=self._query.text[c0q:c1q],
                                index=jt,
                                pos=self._query.token_pos[jt],
                            ),
                            flow=fl,
                            distance=dist,
                            metric=self._metric,
                        )
                    )
                c0, c1 = char_range(i, i + 1)
                o = pd.orig_index[start + i]
                pos_s = doc.pos[o]
                regions.append(
                    Region(
                        s=text[c0:c1],
                        match=TokenMatch(pos_s=pos_s, edges=edges),
                        gap_penalty=0.0,
                    )
                )
                i += 1
            else:
                i0 = i
                while i < length and i not in s_to_t:
                    i += 1
                c0, c1 = char_range(i0, i)
                gap_len = i - i0
                # a run counts as a PENALIZED gap only between matched
                # anchors (reference flow.cpp:103-112: p = 0 unless
                # last_matched); leading/trailing runs are plain context
                between = i0 > 0 and i < length
                penalty = (
                    float(gaps["s"].costs(gap_len + 1)[gap_len])
                    if gaps and between
                    else 0.0
                )
                regions.append(Region(s=text[c0:c1], match=None, gap_penalty=penalty))

        # trailing context, also token-measured
        _, c1 = char_range(length - 1, length)
        n_filtered = len(pd.orig_index)
        trail = min(context_size, n_filtered - (start + length))
        if trail > 0:
            o_ctx = pd.orig_index[start + length + trail - 1]
            ctx1 = int(doc.idx[o_ctx] + doc.len_[o_ctx])
            if c1 < ctx1:
                regions.append(
                    Region(s=text[c1:ctx1], match=None, gap_penalty=0.0)
                )
        return regions

    def to_json(self, context_size: int = 10) -> dict:
        packed = self._index.packed
        pd = self.prepared_doc
        slice_idx = int(packed.slice_idx[self._slice_id])
        location = dict(pd.doc.metadata)
        location.pop("locations", None)
        locations = pd.doc.metadata.get("locations")
        if locations and self._index.partition.level == "sentence":
            # importers record one location per SENTENCE; a windowed
            # partition's slice i starts at sentence i * window_step (the
            # window's location = its first sentence's, like the
            # reference's span metadata)
            sent_idx = slice_idx * self._index.partition.window_step
            if sent_idx < len(locations):
                location.update(locations[sent_idx])
        location["slice_start"] = int(packed.slice_start[self._slice_id])
        location["slice_len"] = int(packed.slice_len[self._slice_id])

        regions = []
        for region in self.regions(context_size):
            if region.match:
                regions.append(
                    dict(
                        s=region.s,
                        pos_s=region.match.pos_s,
                        edges=[
                            {
                                "t": {
                                    "text": e.t.text,
                                    "index": e.t.index,
                                    "pos": e.t.pos,
                                },
                                "flow": e.flow,
                                "distance": e.distance,
                                "metric": e.metric,
                            }
                            for e in region.match.edges
                        ],
                    )
                )
            else:
                regions.append(dict(s=region.s, gap_penalty=region.gap_penalty))

        return dict(
            slice=slice_idx,
            location=location,
            score=self._score,
            metric=self._metric,
            regions=regions,
            omitted=self.omitted,
            level=self._level,
        )


class Index:
    """Base index (reference index.py:406-506)."""

    def __init__(self, partition, nlp=None):
        self._partition = partition
        self._session = partition.session
        self._nlp = nlp if nlp is not None else self._session.nlp

    @property
    def partition(self):
        return self._partition

    @property
    def session(self):
        return self._session

    @property
    def packed(self):
        return self._session.packed_corpus(self._partition.spec)

    def make_query(self, text: str, n: int = 100, min_score: float = 0.2, **kwargs):
        """reference index.py:461-477: n -> max_matches."""
        options = dict(kwargs)
        options["max_matches"] = n
        options["min_score"] = min_score
        options["partition"] = self._partition.to_args()
        return Query(self, text, options)

    def find(
        self,
        text: str,
        n: int = 100,
        min_score: float = 0.2,
        debug=None,
        disable_progress=False,
        run_task=None,
        mesh=None,
        **kwargs,
    ) -> Result:
        """reference index.py:479-501.  ``mesh`` (a ``parallel.mesh.Mesh``
        or ``MeshSearch``): a ``BruteForceIndex`` serves the query over the
        mesh's devices; the span indexes' search is one GEMM on the
        session's device, which a mesh (checked) leaves as it is."""
        if mesh is not None:
            MeshSearch.of(mesh)
        start_time = time.time()
        with trace.span("find.prep"):
            query = self.make_query(
                text, n=n, min_score=min_score, debug=debug, **kwargs
            )
            prepared = query.prepare(self._nlp)
        matches = self._find(prepared)
        return Result(self, matches, time.time() - start_time)

    def _find(self, query: PreparedQuery) -> List[Match]:
        raise NotImplementedError()

    def gap_costs(self):
        return None


class BruteForceIndex(Index):
    """Index-free brute-force search over all slices — the reference's
    flagship path (index.py:509-560), executed as one batched device pass
    per length bucket through the affine-DP kernel, or the WSB kernel for a
    non-affine gap model."""

    # floor on the normalized-score slack of the cut proof: absorbs f32
    # drift between the device ranking scores and the exact rescore
    QUANT_SCORE_EPS = 1e-4

    def __init__(self, partition, span_sim, nlp=None, **kwargs):
        super().__init__(partition, nlp=nlp)
        self._span_sim = span_sim
        self._engine: BruteForceEngine = self._session.engine(partition.spec)
        args = span_sim.to_args(self)
        self._args = args
        alignment = args["alignment"]
        # "alignment", or a transport metric ("word-movers-distance",
        # "word-rotators-distance": ops/wmd's WMDEngine)
        self._algorithm = alignment["algorithm"]
        self._locality = alignment.get("locality", "local")
        self._gap_s = alignment.get("gap_s")
        self._gap_t = alignment.get("gap_t")
        if self._algorithm != "alignment":
            self._gap_costs, self._gaps = None, None
            return
        gaps = self._affine_gaps()
        if gaps is None:
            # non-affine gap model: the general-gap WSB DP takes per-length
            # cost vectors (one pair — the index's gap model is shared by
            # every query); the affine params become an unused placeholder
            # (reference alignment.py:54-55)
            self._gap_costs = (self._gap_s, self._gap_t)
            gaps = AffineGapParams.of(0, 0, 0, 0)
        else:
            self._gap_costs = None
        self._gaps = gaps

    def _affine_gaps(self) -> Optional[AffineGapParams]:
        """Affine params when the gap model is exactly affine (the Gotoh
        kernel), else None — the engine then runs the general-gap WSB DP."""
        affine = resolve_affine_gaps(self._gap_s, self._gap_t)
        if affine is None:
            return None
        return AffineGapParams.of(*affine)

    @property
    def span_sim(self):
        return self._span_sim

    def gap_costs(self):
        if self._gap_s is None:
            return None
        return {"s": self._gap_s, "t": self._gap_t}

    def find(self, text: str, n: int = 100, min_score: float = 0.2, debug=None,
             disable_progress=False, run_task=None, mesh=None, **kwargs) -> Result:
        """reference index.py:479-501.  ``mesh`` (a ``parallel.mesh.Mesh`` or
        ``MeshSearch``) serves this ONE query with every device of the
        mesh: it is ``find_batch([text], mesh=mesh)``, ``run_task`` and
        ``disable_progress`` forwarded, whose (slice_id, score) lists are
        the single-device ``find``'s bytes.  A ``debug`` query stays on the
        session's device (its payloads are host-side diagnostics)."""
        if mesh is not None and debug is None:
            return self.find_batch(
                [text], n=n, min_score=min_score, mesh=mesh,
                disable_progress=disable_progress, run_task=run_task, **kwargs,
            )[0]
        return super().find(text, n=n, min_score=min_score, debug=debug,
                            disable_progress=disable_progress, run_task=run_task,
                            mesh=mesh, **kwargs)

    def warmup(self, max_tokens: int = 12, n: int = 10) -> "BruteForceIndex":
        """Pay now what the first queries would otherwise wait for: on a card
        the nvcc build of the DP kernels (``dp_kernels.build``, minutes the
        first time), and the native host library; then one find for every
        padded needle width up to ``max_tokens`` (needles pad to a multiple
        of 4), so each width's launches and the finalizer have run.  Pass
        the ``n`` (max_matches) production queries will use.  Returns self
        for chaining."""
        from vectorian_tpu_torch import native
        from vectorian_tpu_torch.ops import dp_kernels

        if self._session.device.type == "cuda":
            dp_kernels.build()
        native.available()
        vocab_words = [
            w for w in self._session.vocab.tokens.strings[1:]
            if w and w.isalpha()  # survives the vanilla normalizer
        ][: max(max_tokens, 1)]
        if not vocab_words:
            return self
        # cover the width a max_tokens-token query actually pads to
        top_width = max(4, -(-max(max_tokens, 1) // 4) * 4)
        for t in range(4, top_width + 1, 4):
            words = [vocab_words[i % len(vocab_words)] for i in range(t)]
            # min_score low enough to keep >= 1 candidate: the finalizer
            # (similarity rows, fused DP matrices, traceback) runs too
            self.find(" ".join(words), n=n, min_score=-1e30)
        return self

    def _compile_plan(self, pq: PreparedQuery, ctx_names=(),
                      needs_magnitudes: bool = False):
        """The query's plan at its padded needle width (``qp.width``), the
        contextual leaves of ``ctx_names`` with the needle's vectors (their
        device stores packed at first use); ``needs_magnitudes`` as in
        ``compile_plan``."""
        tok_ids_p, strings_p, ctx_q, _ = _pad_needle(pq, self._session, ctx_names)
        qp = compile_plan(
            self._args["metric"]["token_sim"],
            self._session.compiled_embeddings,
            tok_ids_p,
            strings_p,
            ctx_q,
            device=self._session.device,
            needs_magnitudes=needs_magnitudes,
        )
        for name in qp.ctx_names:
            self._engine.ensure_contextual(
                name, self._session.documents, self._session._ctx_dims[name]
            )
        return qp

    def _doc_filter(self, query: PreparedQuery) -> Optional[DocFilterSpec]:
        """Document-side token filter from the query options: pos_filter /
        tag_filter drop document tokens by universal POS / fine tag
        (reference index.py:78-83 + query.cpp:220-257), token_filter by
        their (normalized) strings; None when no filter is set."""
        opts = query.options
        pos_filter = list(opts.get("pos_filter") or ())
        tag_filter = list(opts.get("tag_filter") or ())
        token_filter = list(opts.get("token_filter") or ())
        if not (pos_filter or tag_filter or token_filter):
            return None
        vocab = self._session.vocab
        pos_ex = np.zeros((len(UPOS),), bool)
        for p in pos_filter:
            pos_ex[vocab.pos_id(p)] = True
        tag_ex = np.zeros((max(len(vocab.tags), 1),), bool)
        for t in tag_filter:
            i = vocab.tags.get(t)
            if i >= 0:
                tag_ex[i] = True
        tok_ex = np.zeros((max(len(vocab.tokens), 1),), bool)
        for w in token_filter:
            nw = self._session.normalization.normalize_word(w)
            i = vocab.tokens.get(nw if nw else w)
            if i >= 0:
                tok_ex[i] = True
        return DocFilterSpec(pos_ex, tag_ex, tok_ex)

    def _tag_weighting(self, query: PreparedQuery,
                       width: int) -> Optional[TagWeightingSpec]:
        """The query's TagWeightingSpec under the index's tag weights (None
        without them): a needle token's weight is its fine tag's (1.0 for a
        tag the weights do not name, reference parse_tag_weights,
        match/instantiate.cpp:10-38); the padded columns up to ``width``
        get weight 0 and pos -1 (masked by len_t)."""
        tw = self._args.get("tag_weights")
        if not tw:
            return None
        weights = np.asarray(
            [float(tw.get(t, 1.0)) for t in query.token_tag], np.float32
        )
        pos_t = np.asarray(query.pos_ids, np.int8)
        if width > len(weights):
            d = width - len(weights)
            weights = np.concatenate([weights, np.zeros((d,), np.float32)])
            pos_t = np.concatenate([pos_t, np.full((d,), -1, np.int8)])
        return TagWeightingSpec(
            t_pos_weights=weights,
            pos_t=pos_t,
            pos_mismatch_penalty=float(self._args.get("pos_mismatch_penalty", 0.0)),
            similarity_threshold=float(self._args.get("similarity_threshold", 0.0)),
        )

    def _find(self, query: PreparedQuery) -> List[Match]:
        """One query, the JAX package's branches (reference index.py
        BruteForceIndex._find): a static plan without ``debug`` takes the
        fused device top-k (with ``bidirectional``, both orientations in
        one pass; with ``submatch_weight``, its closed-form overfetch); a
        contextual or mixed plan the full-read ``score_topk`` and an exact
        rescore with flows; ``debug``, and any cut those cannot prove, the
        full read of every slice's device score (``score_all``), whose
        extras are bounded by the exact n-th score."""
        opts = query.options
        debug = opts.get("debug")
        n = int(opts.get("max_matches", 100))
        min_score = float(opts.get("min_score", 0.2))
        submatch_weight = float(opts.get("submatch_weight") or 0.0)
        booster = opts.get("booster")
        bidirectional = bool(opts.get("bidirectional"))
        if query.n_tokens == 0:
            return []
        if self._algorithm != "alignment":
            return self._find_transport(query)
        token_sim = self._args["metric"]["token_sim"]
        T = query.n_tokens
        engine = self._engine
        with trace.span("find.plan"):
            qp = self._compile_plan(query, _metric_ctx_names(token_sim))
        if debug and qp.is_static_only:
            debug("static_similarity_matrix",
                  {"similarity": qp.matrix.detach().cpu().numpy()})
        with trace.span("find.plan"):
            tagw = self._tag_weighting(query, qp.width)
            norm_total = tagw.total if tagw is not None else float(T)
            boost = None if booster is None else self._compile_booster(booster)
            doc_filter = self._doc_filter(query)
        gaps, gap_costs = self._gaps, self._gap_costs
        t_match0 = time.time()

        def _exact_scores(top, raw):
            # the finalizer's exact f32 rescore in f32 arithmetic (the same
            # find_batch reports), so find and find_batch agree bit for bit
            nt = np.float32(max(norm_total, 1e-9))
            out = {}
            for j, sid in enumerate(top):
                sc = np.float32(raw[j]) / nt
                if boost is not None:
                    sc = sc * np.float32(boost[sid])
                out[sid] = float(sc)
            return out

        def _rescored_matches(top, qp_, tagw_, on_sims=None):
            mappings, edge_sims, raw = engine.rescore_with_flows(
                top, qp_, T, gaps, self._locality, tag_weights=tagw_,
                doc_filter=doc_filter, gap_costs=gap_costs, on_sims=on_sims,
                with_scores=True,
            )
            return self._build_matches(
                query, token_sim, top, mappings, edge_sims,
                _exact_scores(top, raw).__getitem__, submatch_weight, tagw_,
                norm_total, min_score, n, debug,
            )

        if debug is None and qp.is_static_only and (
            bidirectional or submatch_weight == 0.0
        ):
            # the serving machinery with Q=1 (Q=2 bidirectional: the
            # reversed needle rides the same pass as a second query): the
            # fused top-k step returns candidates WITH their exact f32 raw
            # scores (and flow payloads); find_batch runs the same pass and
            # finalizer, so the two are byte-identical by construction
            plans, tagws = [qp], [tagw]
            if bidirectional:
                plans.append(_reverse_plan(qp, T))
                tagws.append(_reverse_tagw(tagw, T))
            Q = len(plans)
            k_fetch = (4 * n + 32) if submatch_weight != 0.0 else (n + 32)
            with trace.span("find.topk"):
                src = engine.score_topk_multi(
                    plans, [T] * Q, gaps, self._locality, [norm_total] * Q,
                    k_fetch, gap_costs=gap_costs,
                    tag_weights=tagws if tagw is not None else None,
                    doc_filter=doc_filter,
                    boosts=[boost] * Q if boost is not None else None,
                )
            if query.query.aborted:
                return []
            items = [(src.qview(qi), plans[qi], query, norm_total, tagws[qi], boost)
                     for qi in range(Q)]
            with trace.span("find.finalize"):
                if submatch_weight != 0.0:
                    per_q = self._finalize_submatch_many(
                        items, gaps, n, min_score, 0.0, submatch_weight, doc_filter)
                else:
                    per_q = self._finalize_quantized_many(
                        items, gaps, self._metric_name, n, min_score, 0.0,
                        doc_filter)
            if Q == 2:
                return self._merge_bidirectional(per_q[0], per_q[1], query, n)
            return per_q[0]

        n_slices = engine.packed.n_slices
        if debug is None and not bidirectional:
            # a contextual or mixed plan (a static one without submatch took
            # the fused path): the device top-k of the full read with a
            # slack for the ranking's drift from the exact rescore
            if submatch_weight == 0.0:
                scale = 1e-6 if qp.is_static_only else self._ctx_floor(qp)

                def ulp(x):
                    return scale * max(1.0, abs(x))

                with trace.span("find.topk"):
                    top, _, rest = engine.score_topk(
                        qp, T, gaps, self._locality, norm_total, k=n + 32,
                        min_score=min_score - ulp(min_score), boost=boost,
                        tag_weights=tagw, doc_filter=doc_filter,
                        gap_costs=gap_costs, with_next=True,
                    )
                if query.query.aborted or not top:
                    return []
                matches = _rescored_matches(top, qp, tagw)
                s_n = matches[n - 1].score if len(matches) >= n else min_score
                if n + 32 >= n_slices or rest < s_n - ulp(s_n):
                    return matches
                # an unsafe cut (a boundary tie): the full read below
            else:
                # submatch rescoring can lift a slice past device-ranked
                # candidates: overfetch 4n and prove the cut through the
                # closed-form bound (scaled by the plan's similarity
                # ceiling; inf for an unknowable one)
                sim_max = plan_sim_upper(qp)
                with trace.span("find.topk"):
                    top, _, rest = engine.score_topk(
                        qp, T, gaps, self._locality, norm_total, k=4 * n,
                        min_score=-1e30, boost=boost, tag_weights=tagw,
                        doc_filter=doc_filter, gap_costs=gap_costs,
                        with_next=True,
                    )
                if query.query.aborted or not top:
                    return []
                matches = _rescored_matches(top, qp, tagw)
                if 4 * n >= n_slices:
                    return matches
                s_n = matches[n - 1].score if len(matches) >= n else min_score
                if not np.isfinite(sim_max):
                    ub = np.inf
                elif boost is not None:
                    ub = _submatch_bound_boosted(rest, boost, norm_total,
                                                 submatch_weight, sim_max, eps_q=1e-6)
                else:
                    ub = float(_submatch_upper_bound(rest, norm_total,
                                                     submatch_weight, sim_max))
                if ub < s_n - 1e-6:
                    return matches
                # unsafe: the full read's extras below, bounded over ALL
                # scores by the closed form

        with trace.span("find.score_all"):
            scores = engine.score_all(
                qp, T, gaps, self._locality, norm_total, boost=boost,
                tag_weights=tagw, doc_filter=doc_filter, gap_costs=gap_costs,
            )
        qp_rev = tagw_rev = None
        if bidirectional:
            # the reversed needle as well; the better orientation of a slice
            # is the better FINAL exact score (find_batch's merge)
            qp_rev = _reverse_plan(qp, T)
            tagw_rev = _reverse_tagw(tagw, T)
            scores_rev = engine.score_all(
                qp_rev, T, gaps, self._locality, norm_total, boost=boost,
                tag_weights=tagw_rev, doc_filter=doc_filter, gap_costs=gap_costs,
            )
            # the max over orientations bounds both exact scores
            scores = np.maximum(scores, scores_rev)
        if debug:
            debug("scores", {"scores": scores})
            debug("document/match_time",
                  {"elapsed_us": int((time.time() - t_match0) * 1e6)})
        if query.query.aborted:
            return []

        # membership guard: fetch with a plan-scaled slack and verify the
        # cut after the exact rescore
        fb_scale = 1e-6 if qp.is_static_only else self._ctx_floor(qp)

        def fb_eps(x):
            return fb_scale * max(1.0, abs(x))

        if submatch_weight == 0.0:
            first_top, rest_fb = engine.top_k_with_next(
                scores, n + 32, min_score - fb_eps(min_score))
            order0 = order_by_score(engine.packed, first_top, scores[first_top])
            first_top = [int(c) for c in np.asarray(first_top)[order0]]
        else:
            first_top = engine.top_k(scores, 4 * n, min_score=-1e30)
            rest_fb = None
        if not first_top:
            return []

        # the surviving slices' contextual similarity blocks, observed from
        # the rescore's own evaluation (reference contextual_similarity_
        # matrix hook, metric/contextual.cpp:77-99; per slice here)
        on_sims = None
        if debug and not qp.is_static_only:
            def on_sims(sid, Sw, Su):
                debug("contextual_similarity_matrix", {"slice": sid, "similarity": Su})

        def run(top):
            fwd = _rescored_matches(top, qp, tagw, on_sims)
            if qp_rev is None:
                return fwd
            # bidirectional: every candidate rescored in the reversed
            # orientation too, the better FINAL score kept
            rev = _rescored_matches(top, qp_rev, tagw_rev, on_sims)
            return self._merge_bidirectional(fwd, rev, query, n)

        def merge_cut(a, b):
            packed = engine.packed
            return sorted(a + b, key=lambda m: (
                -m.score, int(packed.slice_doc[m.slice_id]),
                int(packed.slice_idx[m.slice_id]),
            ))[:n]

        matches = run(first_top)
        s_n = matches[n - 1].score if len(matches) >= n else min_score
        seen = set(first_top)
        if submatch_weight == 0.0:
            # completeness: every slice whose device score could reach the
            # exact n-th (within the slack) must have been rescored
            thresh = s_n - fb_eps(s_n)
            extra = []
            if rest_fb is not None and rest_fb >= thresh:
                extra = [int(c) for c in np.flatnonzero(scores >= thresh)
                         if int(c) not in seen]
        else:
            # completeness of the rescored ranking: every slice whose
            # closed-form bound (boosted: with the slice's boost factored
            # out of its device score) could reach the exact n-th
            sim_max = plan_sim_upper(qp)
            if not np.isfinite(sim_max):
                ub_vec = np.full_like(scores, np.inf)
            elif boost is not None:
                b = np.asarray(boost, np.float64)
                if np.any(b < 0):
                    ub_vec = np.full_like(scores, np.inf)
                else:
                    d_u = scores / np.where(b > 0, b, 1.0)
                    # 1 ulp for the device boost multiply / host divide
                    d_u = d_u + 1e-6 * np.maximum(1.0, np.abs(d_u))
                    ub_vec = np.where(b > 0, b * _submatch_upper_bound(
                        d_u, norm_total, submatch_weight, sim_max), 0.0)
            else:
                ub_vec = _submatch_upper_bound(scores, norm_total,
                                               submatch_weight, sim_max)
            extra = [int(c) for c in np.flatnonzero(ub_vec >= s_n - 1e-6)
                     if int(c) not in seen]
        if extra:
            matches = merge_cut(matches, run(extra))
        return matches

    def _build_matches(self, query, token_sim, top, mappings, edge_sims,
                       score_of, submatch_weight, tagw, norm_total, min_score,
                       n, debug) -> List[Match]:
        """Matches of rescored candidates: their exact scores
        (``score_of``), under ``submatch_weight`` renormalized by
        reference_score over the matched needle weight (metric/
        alignment.h:84-106); each reported to ``debug`` ("alignment");
        sorted in the reference's order and cut STRICTLY above
        ``min_score`` (result_set.h:32-38)."""
        T = query.n_tokens
        packed = self._engine.packed
        matches = []
        for sid, mapping, sims in zip(top, mappings, edge_sims):
            score = score_of(sid)
            if submatch_weight != 0.0:
                # the spec is padded to the needle's width; mappings are
                # sized by its real token count
                max_sims = (tagw.t_pos_weights[:T] if tagw is not None
                            else np.ones((T,), np.float32))
                matched = float(np.sum(max_sims[mapping >= 0]))
                total = float(np.sum(max_sims))
                raw = score * norm_total  # the device normalization undone
                ref = reference_score(total, matched, submatch_weight)
                score = raw / ref if ref > 0 else 0.0
            if debug:
                debug("alignment", {"slice": sid, "flow": mapping, "score": score})
            matches.append(Match(
                self, query, slice_id=sid, score=score, metric=token_sim.name,
                mapping=mapping, similarities=sims,
            ))
        matches.sort(key=lambda m: (
            -m.score, int(packed.slice_doc[m.slice_id]),
            int(packed.slice_idx[m.slice_id]),
        ))
        return [m for m in matches if m.score > min_score][:n]

    def _compile_booster(self, booster) -> np.ndarray:
        """The booster's [n_slices] f32 weights (its ``compile`` does not
        depend on the query: once a call)."""
        with trace.span("booster.compile"):
            return np.asarray(
                booster.compile(self._session, self._partition), np.float32
            )

    def _merge_bidirectional(self, fwd, rev, pq, n: int) -> List["Match"]:
        """Exact-score max over the two needle orientations (reference
        'bidirectional' option, query.cpp:81-84): sorting is a total order
        ((score desc, doc, slice)), so every combined top-n member appears
        in its winning orientation's own top-n, and merging the two top-n
        lists is the combined top-n.  Forward wins score ties; a reversed
        orientation's mapping and similarities translate back to forward
        needle positions (``[::-1]``)."""
        packed = self._engine.packed
        best = {mt.slice_id: mt for mt in fwd}
        for mt in rev:
            cur = best.get(mt.slice_id)
            if cur is None or mt.score > cur.score:
                best[mt.slice_id] = Match(
                    self, pq, slice_id=mt.slice_id, score=mt.score,
                    metric=mt.metric,
                    mapping=np.asarray(mt._mapping)[::-1].copy(),
                    similarities=np.asarray(mt._similarities)[::-1].copy(),
                )
        out = sorted(
            best.values(),
            key=lambda mt: (
                -mt.score,
                int(packed.slice_doc[mt.slice_id]),
                int(packed.slice_idx[mt.slice_id]),
            ),
        )
        return out[:n]

    @property
    def _metric_name(self) -> str:
        return self._args["metric"]["token_sim"].name

    def find_batch(
        self,
        texts: List[str],
        n: int = 100,
        min_score: float = 0.2,
        sim_precision: Optional[str] = None,
        mesh=None,
        disable_progress=False,
        run_task=None,
        **kwargs,
    ) -> List[Result]:
        """Batched search: score Q queries in one corpus pass — the Q
        needle tables stack into one [V, Tpad, Q] table, so each bucket is
        one kernel launch for all of them.

        ``sim_precision``: ``"int8"`` (the default) ranks with a symmetric
        int8 similarity table (a quarter of the f32 table's bytes),
        ``"bfloat16"`` with a bf16 one (half), ``"float32"`` with the
        exact table; an explicit argument wins over the
        ``VECTORIAN_SIM_PRECISION`` environment default.  The corpus-pass
        kernels read the quantized table as it is.  Every query reports
        the finalizer's exact f32 scores under the provable cut, whose
        slack covers the table's per-entry rounding, so every precision
        returns byte-identical results, and the same as ``find()``.  Tag
        weights force f32 (the similarity threshold is a discontinuity no
        rounding bound survives).

        The query options ride the same pass (the JAX package's batch
        form): the tag-weighted block inside the kernels; a
        document-side filter (the batch's options are shared) compacts the
        buckets once; a booster, compiled once, multiplies the ranking and
        the exact scores alike; ``bidirectional`` appends each query's
        reversed needle to the batch and merges the two orientations by
        exact score; ``submatch_weight`` fetches the closed-form-bounded
        4n + 32 overfetch.  ``debug`` runs ``find`` query by query (its
        payloads are per-query diagnostics).

        A batch of plans with a contextual leaf (one contextual
        embedding, or a mixed static + contextual tree, with or without
        tag weights) runs the tree pass, ``_find_batch_dense`` (every leaf
        of the stacked plans a chunk, then each query's tag rewrite).  A
        transport metric's batch runs ``_find_batch_transport`` (one
        ranking pass for the batch, each query's host rescore;
        ``sim_precision`` does not apply).

        ``mesh`` (a ``parallel.mesh.Mesh`` or ``MeshSearch``; TypeError
        for anything else) shards the corpus pass over the mesh's devices
        on every path — static under every option above, contextual,
        tree and transport — and each query's (slice_id, score) list is
        the single-device batch's, byte for byte (``_find_batch_mesh``,
        ``MeshSearch.pending``, ``WMDEngine.find_batch``).  ``debug`` stays on the
        session's device.  ``disable_progress`` and ``run_task`` are
        ``find``'s (the port draws no progress)."""
        ms = None if mesh is None else MeshSearch.of(mesh)
        if self._algorithm != "alignment":
            return self._find_batch_transport(texts, n, min_score, mesh=ms, **kwargs)
        token_sim = self._args["metric"]["token_sim"]
        if not all(getattr(e, "is_static", True) for e in token_sim.embeddings):
            if BATCH_HARD_OPTIONS & set(kwargs):
                return [self.find(t, n=n, min_score=min_score, **kwargs)
                        for t in texts]
            return self._find_batch_dense(texts, n, min_score, mesh=ms, **kwargs)
        if BATCH_HARD_OPTIONS & set(kwargs):
            return [self.find(t, n=n, min_score=min_score, **kwargs) for t in texts]
        submatch_w = float(kwargs.get("submatch_weight") or 0.0)
        start_time = time.time()
        with trace.span("batch.prepare"):
            prepared, plans, len_ts, norm_totals, tagws, sim_dtype = (
                self._prepare_static_batch(texts, n, min_score, sim_precision, kwargs)
            )
            booster = kwargs.get("booster")
            boosts = None
            if booster is not None:
                boost = self._compile_booster(booster)
                boosts = [boost if pq.n_tokens else None for pq in prepared]
            doc_filter = None
            live = [pq for pq in prepared if pq.n_tokens]
            if live:
                doc_filter = self._doc_filter(live[0])
            Q0 = len(prepared)
            if kwargs.get("bidirectional"):
                plans = plans + [
                    _reverse_plan(qp, max(pq.n_tokens, 1))
                    for qp, pq in zip(plans, prepared)
                ]
                tagws = tagws + [
                    _reverse_tagw(tw, max(pq.n_tokens, 1))
                    for tw, pq in zip(tagws, prepared)
                ]
                prepared = prepared + prepared
                len_ts = len_ts + len_ts
                norm_totals = norm_totals + norm_totals
                if boosts is not None:
                    boosts = boosts + boosts
        any_tags = any(t is not None for t in tagws)
        # submatch rescoring can lift slices past device-ranked candidates:
        # the closed-form-bounded overfetch (find()'s k)
        k_fetch = (4 * n + 32) if submatch_w != 0.0 else (n + 32)
        with trace.span("batch.topk"):
            if ms is None:
                src, entry_err = self._engine.score_topk_multi(
                    plans, len_ts, self._gaps, self._locality, norm_totals, k_fetch,
                    gap_costs=self._gap_costs, sim_dtype=sim_dtype, with_err=True,
                    tag_weights=tagws if any_tags else None, doc_filter=doc_filter,
                    boosts=boosts,
                )
            else:
                src, entry_err = self._find_batch_mesh(
                    ms, plans, len_ts, norm_totals, tagws if any_tags else None,
                    sim_dtype, k_fetch, boosts, doc_filter)
        items, item_qis = [], []
        for qi, pq in enumerate(prepared):
            if pq.n_tokens == 0:
                continue
            items.append((
                src.qview(qi), plans[qi], pq, norm_totals[qi], tagws[qi],
                boosts[qi] if boosts is not None else None,
            ))
            item_qis.append(qi)
        if submatch_w != 0.0:
            per_q = self._finalize_submatch_many(
                items, self._gaps, n, min_score, entry_err, submatch_w, doc_filter)
        else:
            per_q = self._finalize_quantized_many(
                items, self._gaps, self._metric_name, n, min_score, entry_err,
                doc_filter,
            )
        matches_by_qi = dict(zip(item_qis, per_q))
        if len(prepared) > Q0:
            matches_by_qi = {
                qi: self._merge_bidirectional(
                    matches_by_qi.get(qi, []), matches_by_qi.get(qi + Q0, []),
                    prepared[qi], n,
                )
                for qi in range(Q0)
                if qi in matches_by_qi or (qi + Q0) in matches_by_qi
            }
        elapsed = time.time() - start_time
        return [
            Result(self, matches_by_qi[qi], elapsed)
            if qi in matches_by_qi
            else Result(self, [], 0.0)
            for qi in range(Q0)
        ]

    def _find_batch_mesh(self, ms, plans, len_ts, norm_totals, tag_weights,
                         sim_dtype, k: int, boosts, doc_filter):
        """The static batch's corpus pass over a mesh (the JAX package's
        ``_find_batch_mesh``): the batch's table at ``sim_dtype`` (int8,
        bf16 or f32; tag weights, a general gap model, boosts and a
        document-side filter ride it as they ride the single-device pass),
        each shard's launch of kernel 1 or 3 over its rows
        (``MeshSearch.static_scores``).  Returns what
        ``BruteForceEngine.score_topk_multi`` does with ``with_err``: the
        ``BucketTopKSource`` of the shards (``MeshSearch.pending``), values
        only, and the table's per-entry rounding."""
        with trace.span("topk.tables"):
            table, sim_scale, max_abs, Tpad = stack_query_tables(plans, len_ts, sim_dtype)
        tw_cols = (None if tag_weights is None
                   else corpus_tag_columns(tag_weights, len(plans), Tpad))
        cache = {}

        def scores_of(db, shards, boost, _ctx):
            tok, ln, pos, tag = shards
            return ms.static_scores(
                tok, ln, table, len_ts, self._gaps, norm_totals, self._locality,
                sim_scale, pos, tag, tw_cols, self._gap_costs, boost, doc_filter,
                cache)

        return (BucketTopKSource(self._engine, ms.pending(self._engine, scores_of, boosts),
                                 len(plans), k),
                quantization_entry_err(sim_dtype, max_abs))

    def _prepare_static_batch(self, texts, n, min_score, sim_precision, kwargs):
        """find_batch front half: prepare Q queries and compile each plan
        at the SAME padded needle width find() uses (so find()/find_batch()
        gather identical bits), and resolve ``sim_precision`` (None:
        ``$VECTORIAN_SIM_PRECISION``, else "int8"; ValueError past "int8",
        "bfloat16" and "float32").  Returns (prepared, plans, len_ts,
        norm_totals, tagws (each query's TagWeightingSpec at its padded
        width, or None), the ranking table's ``sim_dtype``: None for
        f32)."""
        if sim_precision is None:
            sim_precision = os.environ.get("VECTORIAN_SIM_PRECISION") or "int8"
        if sim_precision not in ("int8", "bfloat16", "float32"):
            raise ValueError(f"unknown sim_precision {sim_precision!r}")
        prepared, plans, len_ts, norm_totals, tagws = [], [], [], [], []
        for text in texts:
            pq = self.make_query(text, n=n, min_score=min_score, **kwargs).prepare(
                self._nlp
            )
            prepared.append(pq)
            qp = self._compile_plan(pq)
            plans.append(qp)
            len_ts.append(max(pq.n_tokens, 1))
            tagw = self._tag_weighting(pq, qp.width)
            tagws.append(tagw)
            norm_totals.append(
                tagw.total if tagw is not None else float(max(pq.n_tokens, 1))
            )
        # quantized ranking needs tag_weights=None (the tag threshold is a
        # discontinuity no rounding bound survives): tag weights force f32
        quantize = sim_precision != "float32" and not any(
            t is not None for t in tagws
        )
        sim_dtype = sim_precision if quantize else None
        return prepared, plans, len_ts, norm_totals, tagws, sim_dtype

    # contextual plans rank with another GEMM shape than the finalizer's
    # exact rescore (the reduction over d reorders: ~d * 2^-24 relative), so
    # their membership slack has a larger floor, scaled with the dimension
    # by _ctx_floor
    CTX_SCORE_EPS = 1e-3

    def _ctx_floor(self, qp) -> float:
        d = max(
            (int(np.asarray(q["unmodified"]).shape[-1]) for q in qp.ctx_queries),
            default=0,
        )
        return max(self.CTX_SCORE_EPS, 4.0 * d * 2.0 ** -24)

    def _quant_eps(self, entry_err: float, pq, norm_total: float,
                   plan=None) -> float:
        floor = (self.QUANT_SCORE_EPS if plan is None or plan.is_static_only
                 else self._ctx_floor(plan))
        return max(
            2.0 * entry_err * max(pq.n_tokens, 1) / max(norm_total, 1e-9), floor
        )

    def _finalize_quantized_many(
        self, items, gaps, metric_name, n: int, min_score: float,
        entry_err: float, doc_filter=None,
    ) -> List[List["Match"]]:
        """Batched finalizer: ``items`` is one (source, plan, pq,
        norm_total, tagw, boost) tuple per query (the source a
        ``BucketTopKSource`` view; ``tagw`` its TagWeightingSpec or None,
        ``boost`` the booster's [n_slices] weights or None: an exact score
        is raw / norm_total *
        boost, and the slack grows with the largest boost); ``doc_filter``
        the batch's DocFilterSpec or None.  Every device round runs ONCE for
        the whole batch.

        The cut is provable: the best device score OUTSIDE the candidate set
        must sit below the exact n-th score minus the drift slack ``eps``
        (``entry_err`` bounds per-entry table rounding; 0.0 for f32 tables,
        where the loop only guards (doc, slice) tie-breaks; a contextual
        plan's floor is ``_ctx_floor``).  Rounds: (1) candidates with their
        exact raw scores (from the fused top-k step, or one batched rescore
        with flows of a values-only source's candidates), (2) tie-bounded
        extras for queries whose cut is unsafe — selected (and rescored
        where the select can) on the device — and a score-only rescore of the rest, (3) flows for ONLY the final top-n
        (rescored, fetched payloads, else a deferred rescore on first
        access)."""
        engine = self._engine
        packed = engine.packed

        def key_of(sid, score):
            return (
                -score,
                int(packed.slice_doc[sid]),
                int(packed.slice_idx[sid]),
            )

        # round 1: candidates with exact raw scores
        meta = []
        reqs, req_qis = [], []
        _t_fin = time.perf_counter()
        for qi, (src, plan, pq, norm_total, tagw, boost) in enumerate(items):
            eps = self._quant_eps(entry_err, pq, norm_total, plan)
            if boost is not None:
                eps = eps * max(1.0, float(np.max(boost)))
            cand, rest_max, raw = src.initial_exact(n + 32, min_score - eps)
            if raw is None:
                reqs.append({"slice_ids": cand, "qp": plan, "len_t": pq.n_tokens,
                             "tag_weights": tagw, "want_flows": True})
                req_qis.append(qi)
            meta.append({"eps": eps, "cand": cand, "rest_max": rest_max,
                         "src": src, "raw": raw, "flows": {}})
        res1 = (
            engine.rescore_many(reqs, gaps, self._locality,
                                gap_costs=self._gap_costs, doc_filter=doc_filter)
            if reqs else []
        )
        for qi, (mappings, edge_sims, raw) in zip(req_qis, res1):
            m = meta[qi]
            m["raw"] = raw
            m["flows"] = {sid: (mp, es) for sid, mp, es in
                          zip(m["cand"], mappings, edge_sims)}
        for (src, plan, pq, norm_total, tagw, boost), m in zip(items, meta):
            cand = m["cand"]
            exact = m["raw"] / max(norm_total, 1e-9)
            if boost is not None:
                exact = exact * boost[np.asarray(cand, np.int64)]
            order = order_by_score(packed, cand, exact)
            keep = [j for j in order if exact[j] > min_score][:n]
            m["first_entries"] = [(cand[j], float(exact[j])) for j in keep]
        trace.add("fin.r1", time.perf_counter() - _t_fin)
        _t_fin = time.perf_counter()

        # round 2: cut-safety per query; unsafe cuts are tie-BOUNDED — the
        # source covers every slice reaching the exact n-th minus the slack
        above_calls = []  # (qi, view, thresh, seen)
        for qi, m in enumerate(meta):
            ents = m["first_entries"]
            s_n = ents[n - 1][1] if len(ents) >= n else min_score
            thresh = s_n - m["eps"]
            if m["src"].covers_all(n + 32) or m["rest_max"] < thresh:
                continue
            above_calls.append((qi, m["src"], thresh, set(m["cand"])))
        extra_reqs, extra_qis = [], []
        by_parent = {}
        for call in above_calls:
            by_parent.setdefault(id(call[1].parent), []).append(call)
        for calls in by_parent.values():
            found = calls[0][1].parent.above_exact_many(
                [(src, thresh, seen) for _, src, thresh, seen in calls])
            for (qi, _, _, _), (ids, rmap) in zip(calls, found):
                if not ids:
                    continue
                _, plan, pq, _, tagw, _ = items[qi]
                meta[qi]["extra"] = ids
                meta[qi]["extra_raws"] = rmap
                missing = [e for e in ids if e not in rmap]
                if missing:
                    meta[qi]["extra_missing"] = missing
                    extra_reqs.append(
                        {
                            "slice_ids": missing,
                            "qp": plan,
                            "len_t": pq.n_tokens,
                            "tag_weights": tagw,
                            "want_flows": False,
                        }
                    )
                    extra_qis.append(qi)
        res2 = (
            engine.rescore_many(
                extra_reqs, gaps, self._locality, gap_costs=self._gap_costs,
                doc_filter=doc_filter,
            )
            if extra_reqs
            else []
        )
        trace.add("fin.r2", time.perf_counter() - _t_fin)
        _t_fin = time.perf_counter()

        # round 3: merge extras by exact score; flows for ONLY the entries
        # of a final top-n
        for qi, res in zip(extra_qis, res2):
            meta[qi]["extra_raws"].update(
                zip(meta[qi]["extra_missing"], res[2])
            )
        for qi, m in enumerate(meta):
            entries = [(key_of(sid, s), sid, s) for sid, s in m["first_entries"]]
            if "extra" in m:
                _, _, _, norm_total, _, boost = items[qi]
                extra = m["extra"]
                raw_extra = np.asarray(
                    [m["extra_raws"][e] for e in extra], np.float32
                )
                exact_extra = raw_extra / max(norm_total, 1e-9)
                if boost is not None:
                    exact_extra = exact_extra * boost[np.asarray(extra, np.int64)]
                entries += [
                    (key_of(e, float(exact_extra[i])), e, float(exact_extra[i]))
                    for i, e in enumerate(extra)
                    if exact_extra[i] > min_score
                ]
                entries.sort(key=lambda t: t[0])
            m["entries"] = entries[:n]

        out = []
        for (_, plan, pq, _, tagw, _), m in zip(items, meta):
            # values-only sources' candidates were rescored with flows in
            # round 1; fused sources shipped flow payloads (H/S/Su) with the
            # initial fetch — traceback host-side, no extra round trip;
            # flows of the others are DEFERRED to one shared resolver per
            # query
            src = m["src"]
            resolver = None
            merged = []
            for _, sid, score in m["entries"]:
                flows = m["flows"].get(sid)
                pay = None
                if flows is None:
                    pay = src.flows_payload(sid)
                if pay is not None:
                    H, Sw, Su, ln = pay
                    sel = None
                    if doc_filter is not None:
                        # the payload holds the compacted slice; the host
                        # replica of the compaction gives its length and
                        # translates the mapping to original offsets
                        sel = engine.filtered_positions(sid, doc_filter)
                        ln = len(sel)
                    mp, es = self._flows_from_payload(
                        H, Sw, Su, ln, pq.n_tokens, gaps
                    )
                    if sel is not None:
                        mp = np.where(mp >= 0, sel[np.maximum(mp, 0)], -1).astype(
                            np.int32
                        )
                    flows = (mp, es)
                if flows is not None:
                    merged.append(
                        Match(
                            self, pq, slice_id=sid, score=score,
                            metric=metric_name, mapping=flows[0],
                            similarities=flows[1],
                        )
                    )
                    continue
                if resolver is None:
                    resolver = _FlowResolver(
                        self, plan, pq.n_tokens, tagw, gaps, self._locality,
                        self._gap_costs, doc_filter,
                    )
                mt = Match(
                    self, pq, slice_id=sid, score=score, metric=metric_name,
                    flow_resolver=resolver,
                )
                resolver.add(mt, sid)
                merged.append(mt)
            out.append(merged)
        trace.add("fin.r3", time.perf_counter() - _t_fin)
        return out

    def _submatch_matches(self, pq, cand, res, tagw, norm_total, submatch_w,
                          min_score, n, boost=None) -> List["Match"]:
        """Submatch-rescored matches of one ``rescore_many`` result: find's
        ``_exact_scores`` + ``_build_matches`` arithmetic (boost multiply
        included), so find and find_batch stay byte-equal."""
        mappings, edge_sims, raw = res
        nt = np.float32(max(norm_total, 1e-9))
        exact = {}
        for j, sid in enumerate(cand):
            sc = np.float32(raw[j]) / nt
            if boost is not None:
                sc = sc * np.float32(boost[sid])
            exact[sid] = float(sc)
        return self._build_matches(
            pq, self._args["metric"]["token_sim"], cand, mappings, edge_sims,
            exact.__getitem__, submatch_w, tagw, norm_total, min_score, n, None,
        )

    def _submatch_cut_from_rescore(self, res, cand, rest_max, pq, plan, tagw,
                                   norm_total, n: int, min_score: float,
                                   eps_q: float, submatch_w: float,
                                   boost=None) -> Optional[List["Match"]]:
        """The submatch cut of one rescored candidate set, proved on the
        rescored scale: the closed-form bound lifts the best device score
        outside the set (``rest_max``, drift-padded by ``eps_q``; boosted
        through ``_submatch_bound_boosted``) to a bound on any unfetched
        slice's rescored score.  The matches, or None when unsafe."""
        matches = self._submatch_matches(pq, cand, res, tagw, norm_total,
                                         submatch_w, min_score, n, boost)
        s_n = matches[n - 1].score if len(matches) >= n else min_score
        sim_max = plan_sim_upper(plan)
        if np.isfinite(sim_max):
            if boost is None:
                ub = float(_submatch_upper_bound(rest_max + eps_q, norm_total,
                                                 submatch_w, sim_max))
            else:
                ub = _submatch_bound_boosted(rest_max, boost, norm_total,
                                             submatch_w, sim_max, eps_q)
            if ub < s_n - 1e-6:
                return matches
        return None

    def _finalize_submatch_many(self, items, gaps, n: int, min_score: float,
                                entry_err: float, submatch_w: float,
                                doc_filter=None) -> List[List["Match"]]:
        """Batched finalizer of submatch-rescored queries (w != 0,
        reference_score semantics, metric/alignment.h:84-106).  Every
        candidate's exact score needs its flow mapping (the matched weight
        enters reference_score), so round 1 rescores the 4n + 32 overfetch
        with flows; the cut is proved through the closed-form bound on the
        device next-best value, and an unsafe query fetches the extras at
        the bound's bisected inverse threshold (provably complete) and
        rescores them with flows.  ``items`` as in
        ``_finalize_quantized_many``; boosted items prove their cut through
        the boost-factored bound."""
        engine = self._engine
        packed = engine.packed
        k0 = 4 * n + 32
        meta, reqs = [], []
        for (src, plan, pq, norm_total, tagw, boost) in items:
            cand, rest_max = src.initial(k0, -1e30)
            meta.append({"src": src, "cand": cand, "rest_max": rest_max})
            reqs.append({"slice_ids": cand, "qp": plan, "len_t": pq.n_tokens,
                         "tag_weights": tagw, "want_flows": True})
        res1 = engine.rescore_many(reqs, gaps, self._locality,
                                   gap_costs=self._gap_costs, doc_filter=doc_filter)
        above_calls = []
        for qi, (item, m, res) in enumerate(zip(items, meta, res1)):
            (_s, plan, pq, norm_total, tagw, boost) = item
            m["matches"] = self._submatch_matches(
                pq, m["cand"], res, tagw, norm_total, submatch_w, min_score, n,
                boost)
            if m["src"].covers_all(k0):
                continue
            matches = m["matches"]
            s_n = matches[n - 1].score if len(matches) >= n else min_score
            eps_q = self._quant_eps(entry_err, pq, norm_total, plan)
            sim_max = plan_sim_upper(plan)
            if np.isfinite(sim_max):
                if boost is None:
                    ub = float(_submatch_upper_bound(
                        m["rest_max"] + eps_q, norm_total, submatch_w, sim_max))
                else:
                    ub = _submatch_bound_boosted(m["rest_max"], boost, norm_total,
                                                 submatch_w, sim_max, eps_q)
                if ub < s_n - 1e-6:
                    continue
                if boost is None:
                    thr = _submatch_fetch_thresh(s_n - 1e-6, norm_total,
                                                 submatch_w, sim_max, eps_q)
                else:
                    thr = _submatch_fetch_thresh_boosted(
                        s_n - 1e-6, boost, norm_total, submatch_w, sim_max, eps_q)
            else:
                # unknowable similarity ceiling: every slice (still a
                # provable cut)
                thr = -np.inf
            above_calls.append((qi, m["src"], thr, set(int(c) for c in m["cand"])))

        extra_reqs, extra_qis = [], []
        by_parent = {}
        for call in above_calls:
            by_parent.setdefault(id(call[1].parent), []).append(call)
        for calls in by_parent.values():
            found = calls[0][1].parent.above_many(
                [(src, thr, seen) for _, src, thr, seen in calls])
            for (qi, _s, _t, _e), ids in zip(calls, found):
                if ids:
                    meta[qi]["extra"] = ids
        for qi, m in enumerate(meta):
            if "extra" not in m:
                continue
            (_s, plan, pq, _nt, tagw, _b) = items[qi]
            extra_reqs.append({"slice_ids": m["extra"], "qp": plan,
                               "len_t": pq.n_tokens, "tag_weights": tagw,
                               "want_flows": True})
            extra_qis.append(qi)
        res2 = (
            engine.rescore_many(extra_reqs, gaps, self._locality,
                                gap_costs=self._gap_costs, doc_filter=doc_filter)
            if extra_reqs else []
        )
        for qi, res in zip(extra_qis, res2):
            (_s, plan, pq, norm_total, tagw, boost) = items[qi]
            more = self._submatch_matches(pq, meta[qi]["extra"], res, tagw,
                                          norm_total, submatch_w, min_score, n,
                                          boost)
            meta[qi]["matches"] = sorted(
                meta[qi]["matches"] + more,
                key=lambda mt: (-mt.score, int(packed.slice_doc[mt.slice_id]),
                                int(packed.slice_idx[mt.slice_id])),
            )[:n]
        return [m["matches"] for m in meta]

    def _find_batch_dense(self, texts, n: int, min_score: float, mesh=None,
                          **kwargs) -> List[Result]:
        """Batched search over contextual plans (one contextual embedding
        or a mixed tree, tagged or not): per chunk of slices the stacked
        plans' leaves (a contextual leaf is one metric GEMM against the Q
        stacked needles) and each query's tag rewrite
        (``BruteForceEngine.tree_pass``, the JAX package's
        ``_find_batch_tree`` and ``_find_batch_ctx``).  The dense DP
        kernels score the block, and each bucket's per-query top-k is taken
        on the device (``BucketTopKSource``, values only); the host
        finalizer reports the exact rescore under the contextual
        membership floor (the batch's GEMM and the rescore's reduce in
        other orders).  Boosters (multiplied on the device), document-side
        filters, ``submatch_weight`` and ``bidirectional`` ride the batch
        as in the static one.  ``mesh`` (a MeshSearch) shards the pass:
        every bucket's rows and contextual stores over the mesh's devices
        (``MeshSearch.bucket_shards``, ``ctx_shards``), each shard the
        single-device pass over its rows (``MeshSearch.tree_scores``:
        chunks of ``ctx_chunk`` rows, the dense entries of kernels 1 and
        3) and a pending entry of the same source (``MeshSearch.pending``;
        the JAX package's ``_find_batch_tree_mesh`` and
        ``_find_batch_ctx_mesh`` in one)."""
        submatch_w = float(kwargs.get("submatch_weight") or 0.0)
        bidirectional = bool(kwargs.get("bidirectional"))
        booster = kwargs.get("booster")
        token_sim = self._args["metric"]["token_sim"]
        ctx_names = _metric_ctx_names(token_sim)
        start_time = time.time()
        prepared, plans, len_ts, norm_totals, tagws = [], [], [], [], []
        order, results = [], [None] * len(texts)
        with trace.span("batch.prepare"):
            for ti, text in enumerate(texts):
                pq = self.make_query(text, n=n, min_score=min_score,
                                     **kwargs).prepare(self._nlp)
                if pq.n_tokens == 0:
                    results[ti] = Result(self, [], 0.0)
                    continue
                order.append(ti)
                prepared.append(pq)
                # the padded needle, like find(): the plan's width is the
                # rescore's GEMM shape
                qp = self._compile_plan(pq, ctx_names)
                plans.append(qp)
                tagw = self._tag_weighting(pq, qp.width)
                tagws.append(tagw)
                len_ts.append(max(pq.n_tokens, 1))
                norm_totals.append(tagw.total if tagw is not None
                                   else float(max(pq.n_tokens, 1)))
        if not prepared:
            return [r if r is not None else Result(self, [], 0.0) for r in results]
        boosts = None
        if booster is not None:
            boost = self._compile_booster(booster)
            boosts = [boost] * len(prepared)
        doc_filter = self._doc_filter(prepared[0])
        Q0 = len(prepared)
        if bidirectional:
            plans = plans + [_reverse_plan(qp, max(pq.n_tokens, 1))
                             for qp, pq in zip(plans, prepared)]
            tagws = tagws + [_reverse_tagw(tw, max(pq.n_tokens, 1))
                             for tw, pq in zip(tagws, prepared)]
            prepared = prepared + prepared
            len_ts = len_ts + len_ts
            norm_totals = norm_totals + norm_totals
            if boosts is not None:
                boosts = boosts + boosts
        tree_tags = tagws if any(t is not None for t in tagws) else None
        with trace.span("batch.topk"):
            if mesh is None:
                pending = self._engine.tree_pass(
                    plans, len_ts, self._gaps, self._locality, norm_totals,
                    gap_costs=self._gap_costs, doc_filter=doc_filter,
                    tag_weights=tree_tags, boosts=boosts)
            else:
                cache = {}

                def scores_of(db, shards, boost, ctx):
                    tok, ln, pos, tag = shards
                    return mesh.tree_scores(
                        plans, tok, ln, ctx, len_ts, self._gaps, norm_totals,
                        self._locality, self._gap_costs, boost, pos, tag, doc_filter,
                        tree_tags, cache)

                pending = mesh.pending(self._engine, scores_of, boosts,
                                       plans[0].ctx_names)
            src = BucketTopKSource(self._engine, pending, len(plans),
                                   (4 * n + 32) if submatch_w != 0.0 else (n + 32))
        cols = [src.qview(qi) for qi in range(len(prepared))]
        items = [
            (cols[qi], plans[qi], pq, norm_totals[qi], tagws[qi],
             None if boosts is None else boosts[qi])
            for qi, pq in enumerate(prepared)
        ]
        if submatch_w != 0.0:
            per_q = self._finalize_submatch_many(
                items, self._gaps, n, min_score, 0.0, submatch_w, doc_filter)
        else:
            per_q = self._finalize_quantized_many(
                items, self._gaps, self._metric_name, n, min_score, 0.0,
                doc_filter)
        if bidirectional:
            per_q = [self._merge_bidirectional(per_q[qi], per_q[qi + Q0],
                                               prepared[qi], n)
                     for qi in range(Q0)]
        elapsed = time.time() - start_time
        for qi in range(Q0):
            results[order[qi]] = Result(self, per_q[qi], elapsed)
        return [r if r is not None else Result(self, [], 0.0) for r in results]

    def _find_batch_transport(self, texts, n: int, min_score: float, mesh=None,
                              **kwargs) -> List[Result]:
        """A transport metric's batch (the JAX package's
        ``_find_batch_transport``): Q queries share one ranking pass
        (``ops/wmd.WMDEngine.find_batch``) over static plans, contextual
        plans and mixed trees alike; tag weights, a booster and a
        document-side filter ride it, and ``mesh`` shards its ranking pass.
        ``debug`` (its payloads are
        per-query diagnostics) and a token similarity that is neither an
        ``EmbeddingTokenSim`` nor a modifier tree run ``find`` query by
        query."""
        from vectorian_tpu_torch.ops.wmd import WMDEngine
        from vectorian_tpu_torch.sim.modifier import TokenSimilarityModifier
        from vectorian_tpu_torch.sim.token import EmbeddingTokenSim

        token_sim = self._args["metric"]["token_sim"]
        if (not isinstance(token_sim, (EmbeddingTokenSim, TokenSimilarityModifier))
                or BATCH_HARD_OPTIONS & set(kwargs)):
            return [self.find(t, n=n, min_score=min_score, **kwargs) for t in texts]
        ctx_names = _metric_ctx_names(token_sim)
        start_time = time.time()
        booster = kwargs.get("booster")
        queries, plans, tagws, order = [], [], [], []
        results: List[Optional[Result]] = [None] * len(texts)
        with trace.span("batch.prepare"):
            for ti, text in enumerate(texts):
                pq = self.make_query(text, n=n, min_score=min_score,
                                     **kwargs).prepare(self._nlp)
                if pq.n_tokens == 0:
                    results[ti] = Result(self, [], 0.0)
                    continue
                qp = self._compile_plan(
                    pq, ctx_names,
                    needs_magnitudes=self._algorithm == "word-rotators-distance")
                queries.append(pq)
                plans.append(qp)
                tagws.append(self._tag_weighting(pq, qp.width))
                order.append(ti)
        if queries:
            # a booster's weights do not depend on the query: one compile
            boost = None if booster is None else self._compile_booster(booster)
            match_lists = WMDEngine(self._engine, self._args["alignment"]).find_batch(
                self, queries, plans, n, min_score, tagws=tagws,
                boosts=None if boost is None else [boost] * len(queries),
                doc_filter=self._doc_filter(queries[0]), mesh=mesh,
            )
            elapsed = time.time() - start_time
            for ti, ml in zip(order, match_lists):
                results[ti] = Result(self, ml, elapsed)
        return [r if r is not None else Result(self, [], 0.0) for r in results]

    def _find_transport(self, query: PreparedQuery) -> List[Match]:
        """A transport metric's find (the JAX package's
        ``_find_transport``): the needle padded like an alignment's (the
        transport passes mask its zero-mass columns), its plan (with the
        vocabulary's magnitudes for the Word Rotator's Distance), then
        ``ops/wmd.WMDEngine.find``."""
        from vectorian_tpu_torch.ops.wmd import WMDEngine

        token_sim = self._args["metric"]["token_sim"]
        qp = self._compile_plan(
            query, _metric_ctx_names(token_sim),
            needs_magnitudes=self._algorithm == "word-rotators-distance")
        return WMDEngine(self._engine, self._args["alignment"]).find(self, query, qp)

    def _flows_from_payload(self, H, Sw, Su, ln: int, len_t: int, gaps):
        """(mapping, edge_sims) from a fused-fetch flow payload — shares
        rescore_many's unpack helpers (batch_tracebacks/edge_sims_of), so
        payload and rescored flows are byte-identical: the traceback reads
        the block the DP read (``Sw``), the edge similarities the
        unweighted one (``Su``).  General gap models pass the index-level
        cost vectors (prefix-stable under the payload's padded widths)."""
        w_s = w_t = None
        if self._gap_costs is not None:
            w_s = gap_vec(self._gap_costs[0], Sw.shape[0] + 1)
            w_t = gap_vec(self._gap_costs[1], Sw.shape[1] + 1)
        (mapping,) = batch_tracebacks(
            H[None], Sw[None], np.asarray([ln], np.int32),
            np.asarray([len_t], np.int32), gaps, self._locality,
            w_s=w_s, w_t=w_t,
        )
        return np.asarray(mapping, np.int32), edge_sims_of(mapping, Su, len_t)


class SpanEncoderIndex(Index):
    """Span-embedding search: encode all slices once, then a query = one
    metric GEMM + top-k (reference SpanEncoderIndex index.py:679-730; also
    subsumes FaissCosineIndex :733-767).  The [n_slices, d] span matrix
    lives on the session's device (``embedding/span.SpanVectors``)."""

    def __init__(self, partition, span_sim, nlp=None, **kwargs):
        super().__init__(partition, nlp=nlp)
        self._span_sim = span_sim
        self._encoder = span_sim.embedding.create_encoder(self._session)
        self._corpus_vecs = None

    def _corpus_vectors(self):
        if self._corpus_vecs is None:
            with trace.span("span.encode_corpus"):
                self._corpus_vecs = self._encoder.encode_corpus(
                    self._session, self._partition)
        return self._corpus_vecs

    def _provenance(self):
        return (
            str(self._session._corpus_digest()),
            [self._partition.level, str(self._partition.window_size),
             str(self._partition.window_step)],
            str(getattr(self._encoder, "name", "")),
        )

    def save(self, path):
        """Persist the encoded corpus vectors WITH provenance metadata
        (reference SpanEncoderIndex.save npy dump, index.py:638-658; ``load``
        validates the dump against the live corpus, so a stale or foreign
        file is never searched)."""
        digest, partition, encoder = self._provenance()
        np.savez(path, vectors=self._corpus_vectors().numpy(),
                 corpus_digest=np.asarray(digest),
                 partition=np.asarray(partition), encoder=np.asarray(encoder))

    def load(self, path):
        from vectorian_tpu_torch.embedding.span import SpanVectors

        data = np.load(path, allow_pickle=False)
        if hasattr(data, "files"):  # .npz with provenance
            want = self._provenance()
            got = (
                str(data["corpus_digest"]),
                [str(x) for x in data["partition"]],
                str(data["encoder"]),
            )
            if got != want:
                raise ValueError(
                    f"span-index dump {path} does not match this index: "
                    f"saved {got}, live {want}"
                )
            vecs = data["vectors"]
        else:  # legacy raw .npy array
            vecs = data
        if vecs.shape[0] != self.packed.n_slices:
            raise ValueError(
                f"span-index dump has {vecs.shape[0]} rows, corpus has "
                f"{self.packed.n_slices} slices"
            )
        self._corpus_vecs = SpanVectors(torch.as_tensor(
            np.asarray(vecs, np.float32), device=self._session.device))
        return self

    def _find(self, query: PreparedQuery) -> List[Match]:
        opts = query.options
        n = int(opts.get("max_matches", 100))
        min_score = float(opts.get("min_score", 0.2))
        qv = self._encoder.encode_text(query.text)  # Vectors [1, d]
        return self._topk_from_query_vectors(qv, [query], n, min_score)[0]

    def _matches(self, query, ids, col, n: int, min_score: float) -> List[Match]:
        """Matches of candidate ``ids`` with scores ``col`` in the
        reference's order (score desc, doc, slice), cut strictly above
        ``min_score`` and to ``n``."""
        out = []
        for j in order_by_score(self.packed, ids, col):
            score = float(col[j])
            if score <= min_score:  # strict, like the reference
                continue
            out.append(Match(self, query, slice_id=int(ids[j]), score=score,
                             metric=self._span_sim.vector_sim.name, level="span"))
        return out[:n]

    def _topk_from_query_vectors(self, qv, queries, n, min_score):
        """One [S, Q] metric GEMM on the device, then per query the pool of
        every slice scoring >= its k-th largest value (boundary ties
        resolve by the reference's (doc, slice) order, as
        ``BruteForceEngine.top_k``); only the pool reaches the host."""
        sims = self._span_sim.vector_sim.compute(self._corpus_vectors(), qv)  # [S, Q]
        k = min(n, int(sims.shape[0]))
        if k <= 0:
            return [[] for _ in queries]
        thr = torch.topk(sims, k, dim=0).values[k - 1]  # [Q]
        rows, cols = torch.nonzero(sims >= thr[None, :], as_tuple=True)
        rows_h, cols_h, vals_h = (_host(t) for t in (rows, cols, sims[rows, cols]))
        out_all = []
        for qi, query in enumerate(queries):
            sel = cols_h == qi
            out_all.append(self._matches(query, rows_h[sel], vals_h[sel], n, min_score))
        return out_all

    def find_batch(
        self, texts: List[str], n: int = 100, min_score: float = 0.2, **kwargs
    ) -> List[Result]:
        """Batched span-encoder search: Q query spans encode and score in
        ONE corpus GEMM (the span-level analogue of the brute-force
        multi-query batching)."""
        from vectorian_tpu_torch.embedding.vectors import Vectors

        start_time = time.time()
        prepared, qvs = [], []
        for text in texts:
            q = self.make_query(text, n=n, min_score=min_score, **kwargs)
            prepared.append(q.prepare(self._nlp))
            qvs.append(self._encoder.encode_text(text))
        stacked = Vectors(
            np.concatenate([np.asarray(v.unmodified) for v in qvs], axis=0)
        )
        matches = self._topk_from_query_vectors(stacked, prepared, n, min_score)
        return [Result(self, ms, time.time() - start_time) for ms in matches]


class ApproximateSpanIndex(SpanEncoderIndex):
    """IVF-style sub-linear span search (the reference's Faiss factory
    option, index.py:753-765, rebuilt without faiss): k-means coarse
    centroids over the normalized span vectors; a query scores the
    ``nlist`` centroids, takes the ``nprobe`` nearest lists, and exactly
    rescores ONLY their members with the configured vector metric.

    APPROXIMATE by construction — a true neighbor assigned to an unprobed
    list is missed (recall rises with nprobe; nprobe=nlist degenerates to
    exact).  The spherical k-means is the JAX package's (its initial
    centroids drawn by ``default_rng(0)``, 10 iterations), run on the
    device; each centroid the normalized sum of its members."""

    def __init__(
        self, partition, span_sim, nlp=None, nlist: int = 64,
        nprobe: int = 8, **kwargs,
    ):
        super().__init__(partition, span_sim, nlp=nlp, **kwargs)
        self._nlist = int(nlist)
        self._nprobe = int(nprobe)
        self._centroids = None  # [nlist, d] L2-normalized, host
        self._invlists = None  # list of np.ndarray slice ids

    def _train(self):
        if self._centroids is not None:
            return
        with trace.span("span.kmeans"):
            vecs = self._corpus_vectors().normalized  # [S, d] on the device
            S = int(vecs.shape[0])
            nlist = max(1, min(self._nlist, S))
            rng = np.random.default_rng(0)
            init = torch.as_tensor(rng.choice(S, size=nlist, replace=False),
                                   device=vecs.device)
            cent = vecs[init].clone()
            for _ in range(10):  # spherical k-means (cosine coarse quantizer)
                assign = torch.argmax(vecs @ cent.T, dim=1)
                onehot = torch.nn.functional.one_hot(assign, nlist).to(vecs.dtype)
                sums = onehot.T @ vecs  # [nlist, d], a GEMM: deterministic
                counts = onehot.sum(0)
                norms = torch.clamp_min(torch.linalg.vector_norm(sums, dim=1), 1e-9)
                cent = torch.where(counts[:, None] > 0, sums / norms[:, None], cent)
            assign = _host(torch.argmax(vecs @ cent.T, dim=1))
            self._centroids = _host(cent)
            self._invlists = [np.flatnonzero(assign == c).astype(np.int64)
                              for c in range(nlist)]

    def _shortlist(self, q_normed: np.ndarray) -> np.ndarray:
        self._train()
        nprobe = max(1, min(self._nprobe, len(self._invlists)))
        sims = self._centroids @ q_normed
        probes = np.argpartition(-sims, nprobe - 1)[:nprobe]
        lists = [self._invlists[int(c)] for c in probes]
        return np.concatenate(lists) if lists else np.zeros((0,), np.int64)

    def _topk_from_query_vectors(self, qv, queries, n, min_score):
        from vectorian_tpu_torch.embedding.span import SpanVectors
        from vectorian_tpu_torch.embedding.vectors import Vectors

        corpus = self._corpus_vectors().unmodified
        q_norm = np.asarray(qv.normalized, np.float32)
        q_unmod = np.asarray(qv.unmodified)
        out_all = []
        for qi, query in enumerate(queries):
            cand = self._shortlist(q_norm[qi])
            if cand.size == 0:
                out_all.append([])
                continue
            sub = SpanVectors(corpus[torch.as_tensor(cand, device=corpus.device)])
            col = _host(self._span_sim.vector_sim.compute(
                sub, Vectors(q_unmod[qi : qi + 1])))[:, 0]
            k = min(n, col.shape[0])
            thr = -np.partition(-col, k - 1)[k - 1]
            keep = np.flatnonzero(col >= thr)
            out_all.append(self._matches(query, cand[keep], col[keep], n, min_score))
        return out_all
