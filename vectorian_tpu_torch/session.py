"""Session: binds corpus + embeddings + normalization; owns compiled state.

Reference: vectorian/session.py — Session.__init__ prepares all documents,
builds the core Vocabulary/EmbeddingManager and compiles static embeddings
once (session.py:165-198); Partition carries (level, window_size,
window_step) with frequencies and index construction (session.py:85-145).

Port mapping: "compiling" a static embedding materializes its (vocab x
dim) matrix as tensors on the session's device
(ops/simmatrix.CompiledEmbedding); a contextual one encodes every
document's per-token vectors once (and fits its PCA transforms on them);
"preparing" a partition packs the corpus into length-bucketed arrays
(corpus/packing) plus a BruteForceEngine holding them on the device — both
cached per (level, window_size, window_step).
"""

from __future__ import annotations

import hashlib
import os
import time
import zipfile
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from vectorian_tpu_torch.corpus.corpus import Corpus
from vectorian_tpu_torch.corpus.document import Document, PreparedDocument, prepare_document
from vectorian_tpu_torch.corpus.packing import Partition as PartitionSpec
from vectorian_tpu_torch.corpus.packing import (
    PackedCorpus,
    load_packed,
    pack_corpus,
    save_packed,
)
from vectorian_tpu_torch.normalization import VanillaNormalization
from vectorian_tpu_torch.ops.search import BruteForceEngine
from vectorian_tpu_torch.ops.simmatrix import CompiledEmbedding
from vectorian_tpu_torch.utils.nlp import SimpleNLP
from vectorian_tpu_torch.utils.progress import progress as _progress
from vectorian_tpu_torch.vocabulary import Vocabulary


class Result:
    """An ordered list of matches (reference session.py:24-55)."""

    def __init__(self, index, matches, duration: float):
        self._index = index
        self._matches = list(matches)
        self._duration = duration

    @property
    def index(self):
        return self._index

    @property
    def matches(self):
        return self._matches

    @property
    def duration(self):
        return self._duration

    def __len__(self):
        return len(self._matches)

    def __iter__(self):
        return iter(self._matches)

    def __getitem__(self, i):
        return self._matches[i]

    def extend(self, other: "Result", n: Optional[int] = None):
        """Merge matches from another result (the reference's
        ResultSet.extend seam for externally computed matches,
        result_set.h:70-93 + ExternalMatcher matcher.h:114-139); keeps the
        reference ordering (score desc, doc asc, slice asc)."""
        self._matches.extend(other._matches)
        self._matches.sort(key=lambda m: (-m.score, getattr(m, "slice_id", 0)))
        if n is not None:
            self._matches = self._matches[:n]
        return self

    def precision(self, relevant) -> float:
        """Fraction of returned matches that are relevant (reference
        GroundTruth/precision stubs, result_set.h:8-15, 106-112);
        ``relevant`` is a set of slice ids or (doc_index, slice_idx)."""
        if not self._matches:
            return 0.0
        hits = sum(1 for m in self._matches if self._is_relevant(m, relevant))
        return hits / len(self._matches)

    def recall(self, relevant) -> float:
        if not relevant:
            return 0.0
        hits = sum(1 for m in self._matches if self._is_relevant(m, relevant))
        return hits / len(relevant)

    def ndcg(self, gains, n: Optional[int] = None) -> float:
        """Normalized discounted cumulative gain over the match ranking —
        the reference's de-facto regression metric (its companion notebook
        suite validated releases by NDCG on known queries; see the h5py
        regression note, reference __init__.py:29-31).

        ``gains`` maps slice ids (or (doc_index, slice_idx) pairs, as in
        ``precision``) to graded relevance; a set/list counts as gain 1.0.
        Standard NDCG@k with k = ``n`` (or the number of returned matches):
        the ideal ranking is the k best gains, so a missed relevant slice
        lowers the score whenever its gain would have made that ideal cut —
        pass ``n`` >= len(gains) to penalize every miss (pure recall holes
        among equal top grades are invisible at smaller k, as usual for
        NDCG@k; use ``recall`` for those)."""
        if not isinstance(gains, dict):
            gains = {k: 1.0 for k in gains}
        if not gains:
            return 0.0
        matches = self._matches if n is None else self._matches[:n]
        k = len(matches) if n is None else n

        def gain(m):
            sid = getattr(m, "slice_id", None)
            if sid in gains:
                return float(gains[sid])
            idx = getattr(m, "index", None)
            if idx is not None and hasattr(idx, "packed"):
                packed = idx.packed
                key = (
                    int(packed.slice_doc[m.slice_id]),
                    int(packed.slice_idx[m.slice_id]),
                )
                return float(gains.get(key, 0.0))
            return 0.0

        dcg = sum(
            g / np.log2(i + 2.0)
            for i, g in enumerate(gain(m) for m in matches)
        )
        ideal = sorted((float(g) for g in gains.values()), reverse=True)[:k]
        idcg = sum(g / np.log2(i + 2.0) for i, g in enumerate(ideal))
        return float(dcg / idcg) if idcg > 0 else 0.0

    def _is_relevant(self, m, relevant) -> bool:
        if getattr(m, "slice_id", None) in relevant:
            return True
        idx = getattr(m, "index", None)
        if idx is not None and hasattr(idx, "packed"):
            packed = idx.packed
            key = (
                int(packed.slice_doc[m.slice_id]),
                int(packed.slice_idx[m.slice_id]),
            )
            return key in relevant
        return False

    def to_json(self, context_size=10):
        return [m.to_json(context_size) for m in self._matches]

    def format(self, render_spec) -> "Result":
        """The same matches with renderers picked by a spec string
        (reference LabResult.format, session.py:339-389): comma-separated
        names ("excerpt", "flow", "matrix") with '+annotation' arguments,
        e.g. "excerpt +tags, flow" — or a list of renderer instances.  An
        argument without '+' raises ValueError."""
        from vectorian_tpu_torch.render.excerpt import ExcerptRenderer
        from vectorian_tpu_torch.render.matrix import MatrixRenderer
        from vectorian_tpu_torch.render.sankey import FlowRenderer

        if isinstance(render_spec, (list, tuple)):
            renderers = list(render_spec)
        else:
            lookup = {
                "excerpt": ExcerptRenderer,
                "flow": FlowRenderer,
                "matrix": MatrixRenderer,
            }
            renderers = []
            for desc in render_spec.split(","):
                parts = desc.split()
                if not parts:
                    continue
                klass = lookup[parts[0]]
                for part in parts[1:]:
                    if not part.startswith("+"):
                        raise ValueError(part)
                renderers.append(klass(*(part[1:] for part in parts[1:])))
        out = Result(self._index, self._matches, self._duration)
        out._renderers = renderers
        return out

    def _repr_html_(self):
        """Notebook HTML: the renderers of ``format`` (an excerpt if none)
        in an isolated srcdoc iframe (render/render.py)."""
        from vectorian_tpu_torch.render.render import Renderer

        return Renderer(getattr(self, "_renderers", None)).to_html(self)


class Frequencies:
    """Per-PARTITION tf/df/tf-idf statistics (reference vocabulary.h:439-497
    + Frequencies::add vocabulary.cpp:97-126: the unit of 'document' is one
    SLICE of the partition — df counts slices containing the token and
    n_docs is the slice count)."""

    def __init__(self, session: "Session", partition: "Partition"):
        self._session = session
        self._partition = partition
        V = len(session.vocab)
        packed = session.packed_corpus(partition.spec)
        tf = np.zeros((V,), np.float64)
        df = np.zeros((V,), np.float64)
        n_slices = 0
        tok_by_doc = {
            d_i: pd.token_ids for d_i, pd in enumerate(session.documents)
        }
        for d_i, pd in enumerate(session.documents):
            sel = np.flatnonzero(packed.slice_doc == d_i)
            if sel.size == 0:
                continue
            ids = tok_by_doc[d_i]
            starts = packed.slice_start[sel]
            lens = packed.slice_len[sel]
            n_slices += int(sel.size)
            # (slice, token) pairs: tf per occurrence, df once per slice
            keys = []
            for s0, ln, sid in zip(starts, lens, sel):
                toks = ids[s0 : s0 + ln]
                tf += np.bincount(toks, minlength=V)
                keys.append(np.unique(toks))
            for u in keys:
                df[u] += 1.0
        self._tf = tf
        self._df = df
        self._n_docs = max(n_slices, 1)
        self._tf_idf = None

    @property
    def tf(self) -> np.ndarray:
        return self._tf

    @property
    def df(self) -> np.ndarray:
        return self._df

    @property
    def tf_idf(self) -> np.ndarray:
        """tf * log(n_docs / (1 + df)) — vocabulary.cpp:72-81 (cached like
        the reference's m_tf_idf_valid)."""
        if self._tf_idf is None:
            with np.errstate(divide="ignore"):
                self._tf_idf = self._tf * np.log(
                    self._n_docs / (1.0 + self._df)
                )
        return self._tf_idf

    def _token_id(self, token: str) -> int:
        # the session's normalization flavor applies, like word_vec
        w = self._session.normalization.normalize_word(token)
        return self._session.vocab.tokens.get(w) if w is not None else -1

    def token_tf(self, token: str) -> float:
        i = self._token_id(token)
        return float(self._tf[i]) if i >= 0 else 0.0

    def token_tf_idf(self, token: str) -> float:
        i = self._token_id(token)
        return float(self.tf_idf[i]) if i >= 0 else 0.0


class Partition:
    """A partition bound to a session (reference session.py:85-145)."""

    def __init__(self, session: "Session", level: str, window_size: int, window_step: int):
        self._session = session
        self._spec = PartitionSpec(level, window_size, window_step)

    @property
    def session(self):
        return self._session

    @property
    def spec(self) -> PartitionSpec:
        return self._spec

    @property
    def level(self):
        return self._spec.level

    @property
    def window_size(self):
        return self._spec.window_size

    @property
    def window_step(self):
        return self._spec.window_step

    @property
    def contiguous(self):
        return self._spec.contiguous

    @property
    def freq(self) -> Frequencies:
        # cached on the SESSION keyed by spec: session.partition() returns
        # a fresh Partition each call, so an instance cache never hits
        cache = getattr(self._session, "_freq_cache", None)
        if cache is None:
            cache = self._session._freq_cache = {}
        key = self.spec
        if key not in cache:
            cache[key] = Frequencies(self._session, self)
        return cache[key]

    def index(self, span_sim, nlp=None, **kwargs):
        """Create a searchable index over this partition (reference
        session.py:134-142)."""
        from vectorian_tpu_torch.sim.span import SpanSim
        from vectorian_tpu_torch.sim.token import TokenSim
        from vectorian_tpu_torch.sim.span import OptimizedSpanSim

        if isinstance(span_sim, TokenSim):
            span_sim = OptimizedSpanSim(span_sim)
        if not isinstance(span_sim, SpanSim):
            raise TypeError(f"expected SpanSim or TokenSim, got {span_sim!r}")
        return span_sim.create_index(self, nlp=nlp, **kwargs)

    def to_args(self):
        return {
            "level": self.level,
            "window_size": self.window_size,
            "window_step": self.window_step,
        }


class Session:
    """An interactive search session (reference session.py:165-198).

    ``device``: where the compiled embeddings, the packed corpus and every
    corpus pass live — ``"cuda"`` (the default) needs a CUDA card and
    raises without one; pass ``device="cpu"`` to run on the CPU.
    ``paged=True`` keeps every partition's length buckets (and contextual
    stores) in pinned host memory and streams them through the device a
    bucket at a time during each corpus pass, for corpora whose arrays
    pass the card's memory (``ops/search.BruteForceEngine``); results are
    byte-identical to resident mode.

    ``docs`` is a sequence of documents or a ``Corpus``.  A corpus whose
    stored flavor for ``normalization`` matches its documents restores the
    prepared arrays (no normalization or interning); otherwise the session
    prepares the documents and stores the flavor in the corpus."""

    def __init__(
        self,
        docs: "Sequence[Document] | Corpus",
        embeddings=(),
        normalization=None,
        nlp=None,
        device="cuda",
        paged: bool = False,
    ):
        self._paged = bool(paged)
        self._device = torch.device(device)
        if self._device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "Session(device='cuda') needs a CUDA device and none is "
                "available; pass device='cpu' to run on the CPU"
            )
        if normalization is None:
            normalization = VanillaNormalization()
        self._normalization = normalization
        self._nlp = nlp if nlp is not None else SimpleNLP()
        self._vocab = Vocabulary()

        self._embeddings = list(embeddings)

        self._documents: List[PreparedDocument] = []
        corpus = docs if isinstance(docs, Corpus) else None
        if corpus is not None:
            docs = corpus.docs
            flavor = corpus.load_flavor(normalization.ident)
            if flavor is not None and flavor["uids"] == [d.unique_id for d in docs]:
                self._restore_flavor(docs, flavor)
            else:
                self._prepare(docs)
                self._save_flavor(corpus, docs)
        else:
            self._prepare(list(docs))

        self._compiled: Dict[str, CompiledEmbedding] = {}
        self._ctx_embeddings: Dict[str, object] = {}
        self._ctx_fitted: Dict[str, list] = {}  # name -> fitted transforms
        self._ctx_dims: Dict[str, int] = {}
        vocab_strings = self._vocab.tokens.strings
        for emb in _progress(self._embeddings, desc="compiling embeddings"):
            if emb.is_static:
                encoder = emb.create_encoder(normalization)
                self._compiled[emb.name] = CompiledEmbedding(
                    emb.name, encoder, vocab_strings, device=self._device
                )
            else:
                self._compile_contextual(emb)

        self._packed_cache: Dict[PartitionSpec, PackedCorpus] = {}
        self._engine_cache: Dict[PartitionSpec, BruteForceEngine] = {}

    def _prepare(self, docs):
        """Normalize and intern every document (ids in frequency order)."""
        for i, doc in enumerate(_progress(docs, desc="preparing docs")):
            self._documents.append(
                prepare_document(doc, i, self._normalization, self._vocab)
            )
        self._reorder_vocab_by_frequency()

    def _restore_flavor(self, docs, flavor):
        """A stored corpus's persisted flavor (reference FlavorBuilder,
        corpus.py:68-192): the vocabulary, ids, keep masks and spans as
        saved — after the frequency reorder, so none runs here — with no
        normalization or interning; stored contextual vectors stay lazy."""
        from vectorian_tpu_torch.embedding.vectors import LazyVectors

        self._vocab = Vocabulary.from_strings(flavor["tokens"], flavor["tags"])
        for i, (doc, d) in enumerate(zip(docs, flavor["docs"])):
            contextual = {
                name: LazyVectors(vecs, d["orig_index"])
                for name, vecs in doc.contextual_embeddings.items()
                if len(vecs)
            }
            self._documents.append(PreparedDocument(
                doc=doc, doc_index=i, token_ids=d["token_ids"], pos_ids=d["pos_ids"],
                tag_ids=d["tag_ids"], orig_index=d["orig_index"], spans=d["spans"],
                contextual=contextual,
            ))

    def _save_flavor(self, corpus, docs):
        corpus.save_flavor(
            self._normalization.ident,
            [d.unique_id for d in docs],
            self._vocab.tokens.strings,
            self._vocab.tags.strings,
            [{"token_ids": pd.token_ids, "pos_ids": pd.pos_ids, "tag_ids": pd.tag_ids,
              "orig_index": pd.orig_index, "spans": pd.spans}
             for pd in self._documents],
        )

    def _reorder_vocab_by_frequency(self):
        """Assign token ids by descending corpus frequency (PAD stays 0):
        a frequency-major id space keeps the corpus pass's table reads in a
        small hot region of the similarity table on Zipf corpora.  Purely
        an id relabeling — scores are unaffected."""
        n = len(self._vocab.tokens)
        if n <= 2:
            return
        counts = np.zeros((n,), np.int64)
        for pd in self._documents:
            if len(pd.token_ids):
                counts += np.bincount(pd.token_ids, minlength=n)
        old = np.arange(1, n)
        # stable: count desc, then first-seen order
        order = old[np.lexsort((old, -counts[1:]))]
        perm = np.empty((n,), np.int32)
        perm[0] = 0
        perm[order] = np.arange(1, n, dtype=np.int32)
        for pd in self._documents:
            pd.token_ids = perm[pd.token_ids].astype(np.int32)
        self._vocab.tokens.reorder(perm)

    def _compile_contextual(self, emb):
        """Encode the per-document vectors a document lacks (the reference
        checks doc coverage, session.py:177-182), fit the embedding's PCA
        transforms on the corpus's vectors, and keep the transformed
        vectors in the prepared documents (host arrays; the engine packs
        them into device buckets at the first contextual query)."""
        self._ctx_embeddings[emb.name] = emb
        for pd in self._documents:
            if emb.name not in pd.contextual:
                sdoc = self._nlp(pd.doc.text)
                vecs = np.asarray(emb.encode_doc(sdoc, pd.doc.text), np.float32)
                if len(vecs) != pd.doc.n_tokens:
                    # pd.orig_index indexes the importer's token table: a
                    # session NLP that tokenizes differently would assign
                    # wrong per-token vectors
                    raise ValueError(
                        f"contextual embedding {emb.name!r}: session NLP "
                        f"produced {len(vecs)} token vectors for document "
                        f"{pd.doc.title!r} but its token table has "
                        f"{pd.doc.n_tokens} — use the same NLP pipeline for "
                        "importing and for the Session"
                    )
                pd.doc.contextual_embeddings[emb.name] = vecs
                pd.contextual[emb.name] = vecs[pd.orig_index]
        fitted = []
        for tfm in getattr(emb, "transforms", ()):
            all_vecs = np.concatenate(
                [
                    np.asarray(pd.contextual[emb.name], np.float32)
                    for pd in self._documents
                    if len(pd.contextual.get(emb.name, ()))
                ],
                axis=0,
            )
            ft = tfm.fit(all_vecs)
            for pd in self._documents:
                if len(pd.contextual.get(emb.name, ())):
                    pd.contextual[emb.name] = np.asarray(
                        ft.apply(np.asarray(pd.contextual[emb.name], np.float32)),
                        np.float32,
                    )
            fitted.append(ft)
        self._ctx_fitted[emb.name] = fitted
        dim = 0
        for pd in self._documents:
            v = pd.contextual.get(emb.name)
            if v is not None and len(v):
                dim = int(v.shape[1])
                break
        self._ctx_dims[emb.name] = dim

    @property
    def contextual_embeddings(self):
        return self._ctx_embeddings

    def cache_contextual_embeddings(self):
        """Preload every contextual vector (reference
        Session.cache_contextual_embeddings, session.py:237-239): lazy
        stored vectors are read, and the device stores of already-built
        partitions are packed, so the first contextual query pays no
        load."""
        for pd in _progress(self._documents, desc="loading vectors"):
            for name in self._ctx_embeddings:
                v = pd.contextual.get(name)
                if v is not None and hasattr(v, "materialize"):
                    v.materialize()
        for engine in self._engine_cache.values():
            for name in self._ctx_embeddings:
                engine.ensure_contextual(name, self._documents, self._ctx_dims[name])

    def encode_contextual_query(self, name: str, sdoc, text: str, keep) -> dict:
        """The needle's contextual vectors with the fitted transforms
        replayed (the reference's transform-on-query path,
        embedding/vectors.py:89-129): {unmodified, normalized, magnitudes}
        numpy arrays of the kept tokens."""
        emb = self._ctx_embeddings[name]
        vecs = np.asarray(emb.encode_doc(sdoc, text), np.float32)[keep]
        for ft in self._ctx_fitted.get(name, ()):
            vecs = np.asarray(ft.apply(vecs), np.float32)
        mags = np.linalg.norm(vecs, axis=-1)
        normed = vecs / np.maximum(mags, 1e-9)[:, None]
        return {"unmodified": vecs, "normalized": normed, "magnitudes": mags}

    @property
    def device(self) -> torch.device:
        return self._device

    @property
    def documents(self) -> List[PreparedDocument]:
        return self._documents

    @property
    def vocab(self) -> Vocabulary:
        return self._vocab

    @property
    def nlp(self):
        return self._nlp

    @property
    def normalization(self):
        return self._normalization

    @property
    def embeddings(self):
        return self._embeddings

    @property
    def compiled_embeddings(self) -> Dict[str, CompiledEmbedding]:
        return self._compiled

    def partition(self, level: str = "sentence", window_size: int = 1, window_step: int = 1) -> Partition:
        return Partition(self, level, window_size, window_step)

    def _corpus_digest(self) -> str:
        """Content digest over prepared token ids + flavor ident — keys the
        on-disk packed-corpus cache."""
        h = hashlib.sha256()
        h.update(repr(self._normalization.ident).encode())
        for pd in self._documents:
            h.update(pd.token_ids.tobytes())
            # pos/tag ids are part of the packed arrays the cache stores —
            # a tagger change with identical token texts must miss
            h.update(np.ascontiguousarray(pd.pos_ids).tobytes())
            h.update(np.ascontiguousarray(pd.tag_ids).tobytes())
            for arr in pd.spans.values():
                h.update(np.ascontiguousarray(arr).tobytes())
        return h.hexdigest()[:24]

    def packed_corpus(self, spec: PartitionSpec) -> PackedCorpus:
        packed = self._packed_cache.get(spec)
        if packed is None:
            packed = self._load_or_pack(spec)
            self._packed_cache[spec] = packed
        return packed

    def _load_or_pack(self, spec: PartitionSpec) -> PackedCorpus:
        """The packing of ``spec`` from the cache under ``cache_home()``
        (``$VECTORIAN_CACHE_HOME``), or packed and saved there; a file that
        does not load is packed again.  The save writes a temporary name
        and renames it into place, so no process reads a half-written
        file."""
        from vectorian_tpu_torch.embedding.static import cache_home

        cdir = cache_home() / "packed"
        cdir.mkdir(parents=True, exist_ok=True)
        key = f"{self._corpus_digest()}-{spec.level}-{spec.window_size}-{spec.window_step}"
        path = cdir / f"{key}.npz"
        if path.exists():
            try:
                return load_packed(path)
            except (OSError, ValueError, KeyError, EOFError, zipfile.BadZipFile):
                pass  # not a whole packing: pack it again
        packed = pack_corpus(self._documents, spec)
        tmp = cdir / f"{key}.{os.getpid()}.tmp.npz"
        try:
            save_packed(packed, tmp)
            os.replace(tmp, path)
        except OSError:
            tmp.unlink(missing_ok=True)
        return packed

    def engine(self, spec: PartitionSpec) -> BruteForceEngine:
        eng = self._engine_cache.get(spec)
        if eng is None:
            eng = BruteForceEngine(self.packed_corpus(spec), self._device,
                                   paged=self._paged)
            self._engine_cache[spec] = eng
        return eng

    # ---- introspection helpers (reference session.py:263-325) ----

    def word_vec(self, embedding, word: str) -> np.ndarray:
        comp = self._compiled.get(embedding.name)
        if comp is None:
            encoder = embedding.create_encoder(self._normalization)
            return encoder.word_vec(word)
        w = self._normalization.normalize_word(word)
        return np.asarray(comp.encoder.word_vec(w if w else word))

    def similarity(self, token_sim, a: str, b: str) -> float:
        """Similarity of two words under a token sim spec."""
        from vectorian_tpu_torch.embedding.vectors import Vectors
        from vectorian_tpu_torch.sim.token import EmbeddingTokenSim

        if isinstance(token_sim, EmbeddingTokenSim):
            va = self.word_vec(token_sim.embedding, a)[None]
            vb = self.word_vec(token_sim.embedding, b)[None]
            out = token_sim.metric.compute(Vectors(va), Vectors(vb))
            return float(out[0, 0])
        raise TypeError(token_sim)

    def run_query(self, find, query):
        start = time.time()
        matches = find(query)
        return Result(None, matches, time.time() - start)


class LabSession(Session):
    """Session with a notebook progress display (reference
    session.py:398-459): ``run_query`` shows an ipywidgets progress bar
    while the query runs where ipywidgets and IPython import, and is
    ``Session.run_query`` elsewhere."""

    def run_query(self, find, query):
        try:
            import ipywidgets
            from IPython.display import display
        except ImportError:
            return super().run_query(find, query)
        start = time.time()
        progress = ipywidgets.FloatProgress(value=0, min=0, max=1, description="")
        display(progress)
        try:
            matches = find(query)
        finally:
            progress.close()
        return Result(None, matches, time.time() - start)
