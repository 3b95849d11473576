"""Query construction, indexes and matches.

Reference: vectorian/index.py — Query/PreparedQuery (:25-106), Match ABC +
to_json (:249-292), CoreMatch region reconstruction (:295-379) and
BruteForceIndex thread fan-out (:509-560).

Port mapping (static slice of vectorian_tpu/index.py, affine and general
gap models): the per-document ThreadPool disappears — the packed corpus is scored in one
batched device pass per bucket (ops/search.BruteForceEngine); the bounded
top-k heap becomes a device top-k fused with the exact rescore of the
selected rows; flows are recomputed for the global top-k only.  ``find`` is
``find_batch`` with one query: both run the same corpus pass and the same
finalizer, so their (slice_id, score) lists are byte-identical.  The query
options tag weights, ``pos_filter`` / ``tag_filter`` / ``token_filter``,
``booster`` and ``bidirectional`` ride that pass in both.
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
    DocFilterSpec,
    TagWeightingSpec,
    batch_tracebacks,
    edge_sims_of,
    gap_vec,
    order_by_score,
)
from vectorian_tpu_torch.ops.simmatrix import QueryPlan, compile_plan
from vectorian_tpu_torch.session import Result
from vectorian_tpu_torch.utils import trace
from vectorian_tpu_torch.vocabulary import UPOS


def _not_ported(what: str, item: str):
    return NotImplementedError(
        f"{what} is not ported to vectorian_tpu_torch yet (ROADMAP.md port "
        f"queue item {item})"
    )


_OPTIONS_ITEM = "4c: submatch_weight, debug and the full-read paths"
# per-query options of the JAX package that the port does not serve yet;
# each raises when set to anything but its neutral default
UNPORTED_OPTIONS = ("submatch_weight", "debug")


def _check_options(options: dict) -> None:
    for key in UNPORTED_OPTIONS:
        if options.get(key):
            raise _not_ported(f"query option {key!r}", _OPTIONS_ITEM)


def _reverse_plan(qp: QueryPlan, n_tokens: int) -> QueryPlan:
    """The plan with its first ``n_tokens`` needle columns reversed
    (bidirectional matching); the padding stays at the tail, so the len_t
    mask keeps working.  The columns are copies: the same bits."""
    m = qp.matrix
    return QueryPlan(
        matrix=torch.cat([torch.flip(m[:, :n_tokens], dims=(1,)), m[:, n_tokens:]], 1)
    )


def _reverse_tagw(tagw, n_tokens: int):
    """The TagWeightingSpec of the reversed needle (None stays None)."""
    if tagw is None:
        return None

    def rev(v):
        return np.concatenate([v[:n_tokens][::-1], v[n_tokens:]], axis=0)

    return dataclasses.replace(
        tagw, t_pos_weights=rev(tagw.t_pos_weights), pos_t=rev(tagw.pos_t)
    )


def _pad_needle(query: "PreparedQuery"):
    """Pad the needle to a multiple of 4 tokens (at least 4): padded ids
    are -1, strings empty.  Plans of one padded width give find() and
    find_batch() the same GEMM shape, hence the same bits.  Returns
    (token_ids, strings, Tpad)."""
    T = query.n_tokens
    Tpad = max(4, -(-T // 4) * 4)
    pad_n = Tpad - T
    tok_ids = np.concatenate(
        [np.asarray(query.token_ids, np.int32), np.full((pad_n,), -1, np.int32)]
    )
    strings = list(query.token_strings) + [""] * pad_n
    return tok_ids, strings, Tpad


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
        """reference index.py:479-501."""
        if mesh is not None:
            raise _not_ported("find(mesh=...)", "7: multi-device serving")
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
        if alignment["algorithm"] != "alignment":
            raise _not_ported(
                f"the {alignment['algorithm']!r} metric", "6: transport metrics"
            )
        self._locality = alignment.get("locality", "local")
        self._gap_s = alignment.get("gap_s")
        self._gap_t = alignment.get("gap_t")
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
        return {"s": self._gap_s, "t": self._gap_t}

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

    def _compile_plan(self, pq: PreparedQuery):
        tok_ids_p, strings_p, _ = _pad_needle(pq)
        return compile_plan(
            self._args["metric"]["token_sim"],
            self._session.compiled_embeddings,
            tok_ids_p,
            strings_p,
        )

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
        opts = query.options
        _check_options(opts)
        if query.n_tokens == 0:
            return []
        n = int(opts.get("max_matches", 100))
        min_score = float(opts.get("min_score", 0.2))
        T = query.n_tokens
        with trace.span("find.plan"):
            qp = self._compile_plan(query)
            tagw = self._tag_weighting(query, _pad_needle(query)[2])
            norm_total = tagw.total if tagw is not None else float(T)
            booster = opts.get("booster")
            boost = None if booster is None else self._compile_booster(booster)
            doc_filter = self._doc_filter(query)
        # the serving machinery with Q=1 (Q=2 for bidirectional: the
        # reversed needle rides the same pass as a second query): the fused
        # top-k step returns candidates WITH their exact f32 raw scores and
        # flow payloads; boundary ties resolve through tie-bounded device
        # column selects.  find_batch runs the same pass and finalizer, so
        # the two are byte-identical by construction.
        plans, tagws = [qp], [tagw]
        if opts.get("bidirectional"):
            plans.append(_reverse_plan(qp, T))
            tagws.append(_reverse_tagw(tagw, T))
        Q = len(plans)
        with trace.span("find.topk"):
            src = self._engine.score_topk_multi(
                plans, [T] * Q, self._gaps, self._locality, [norm_total] * Q,
                n + 32, gap_costs=self._gap_costs,
                tag_weights=tagws if tagw is not None else None,
                doc_filter=doc_filter,
                boosts=[boost] * Q if boost is not None else None,
            )
        if query.query.aborted:
            return []
        with trace.span("find.finalize"):
            per_q = self._finalize_quantized_many(
                [(src.qview(qi), plans[qi], query, norm_total, tagws[qi], boost)
                 for qi in range(Q)],
                self._gaps, self._metric_name, n, min_score, 0.0, doc_filter,
            )
        if Q == 2:
            return self._merge_bidirectional(per_q[0], per_q[1], query, n)
        return per_q[0]

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
        exact score."""
        if mesh is not None:
            raise _not_ported("find_batch(mesh=...)", "7: multi-device serving")
        _check_options(kwargs)
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
        with trace.span("batch.topk"):
            src, entry_err = self._engine.score_topk_multi(
                plans, len_ts, self._gaps, self._locality, norm_totals, n + 32,
                gap_costs=self._gap_costs, sim_dtype=sim_dtype, with_err=True,
                tag_weights=tagws if any_tags else None, doc_filter=doc_filter,
                boosts=boosts,
            )
        items, item_qis = [], []
        for qi, pq in enumerate(prepared):
            if pq.n_tokens == 0:
                continue
            items.append((
                src.qview(qi), plans[qi], pq, norm_totals[qi], tagws[qi],
                boosts[qi] if boosts is not None else None,
            ))
            item_qis.append(qi)
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
            plans.append(self._compile_plan(pq))
            len_ts.append(max(pq.n_tokens, 1))
            tagw = self._tag_weighting(pq, _pad_needle(pq)[2])
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

    def _quant_eps(self, entry_err: float, pq, norm_total: float) -> float:
        return max(
            2.0 * entry_err * max(pq.n_tokens, 1) / max(norm_total, 1e-9),
            self.QUANT_SCORE_EPS,
        )

    def _finalize_quantized_many(
        self, items, gaps, metric_name, n: int, min_score: float,
        entry_err: float, doc_filter=None,
    ) -> List[List["Match"]]:
        """Batched finalizer: ``items`` is one (source view, plan, pq,
        norm_total, tagw, boost) tuple per query (``tagw`` its
        TagWeightingSpec or None, ``boost`` the booster's [n_slices]
        weights or None: an exact score is raw / norm_total * boost, and
        the slack grows with the largest boost); ``doc_filter`` the batch's
        DocFilterSpec or None.  Every device round runs ONCE for the whole
        batch.

        The cut is provable: the best device score OUTSIDE the candidate set
        must sit below the exact n-th score minus the drift slack ``eps``
        (``entry_err`` bounds per-entry table rounding; 0.0 for f32 tables,
        where the loop only guards (doc, slice) tie-breaks).  Rounds: (1)
        candidates with their exact raw scores from the fused top-k step,
        (2) tie-bounded extras for queries whose cut is unsafe — selected
        and rescored on the device, a score-only rescore for any the select
        could not rescore, (3) flows for ONLY the final top-n (fetched
        payloads, else a deferred rescore on first access)."""
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
        _t_fin = time.perf_counter()
        for src, plan, pq, norm_total, tagw, boost in items:
            eps = self._quant_eps(entry_err, pq, norm_total)
            if boost is not None:
                eps = eps * max(1.0, float(np.max(boost)))
            cand, rest_max, raw = src.initial_exact(n + 32, min_score - eps)
            exact = raw / max(norm_total, 1e-9)
            if boost is not None:
                exact = exact * boost[np.asarray(cand, np.int64)]
            order = order_by_score(packed, cand, exact)
            keep = [j for j in order if exact[j] > min_score][:n]
            meta.append(
                {
                    "eps": eps,
                    "cand": cand,
                    "rest_max": rest_max,
                    "src": src,
                    "first_entries": [(cand[j], float(exact[j])) for j in keep],
                }
            )
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
                [(src, thresh, seen) for _, src, thresh, seen in calls]
            )
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
        for (src, plan, pq, _, tagw, _), m in zip(items, meta):
            # fused sources shipped flow payloads (H/S/Su) with the initial
            # fetch — traceback host-side, no extra round trip; flows of
            # the others are DEFERRED to one shared resolver per query
            resolver = None
            merged = []
            for _, sid, score in m["entries"]:
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
                    merged.append(
                        Match(
                            self, pq, slice_id=sid, score=score,
                            metric=metric_name, mapping=mp, similarities=es,
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
