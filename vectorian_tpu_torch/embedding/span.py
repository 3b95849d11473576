"""Span (sentence/document) embeddings.

Reference: vectorian/embedding/span.py — SpanEmbedding aggregates token
embeddings (mean/min/max, AggregatedTokenImpl:27-93) or wraps pure-text
encoders (spaCy doc.vector / user lambda, _LambdaImpl:136), with a per-doc
disk+LRU cache keyed by (embedding, partition) (:219-324).

The port of vectorian_tpu/embedding/span.py: the corpus's spans are encoded
in one pass over the packed buckets on the session's device (a masked
mean, min or max over each slice's rows of the static table, or of the
contextual bf16 store that ``ensure_contextual`` packs) and kept there as
one [n_slices, d] matrix (``SpanVectors``); a query is one metric GEMM
against it and a top-k (index.SpanEncoderIndex).
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from vectorian_tpu_torch.embedding.vectors import EPS, AbstractVectors, Vectors

# rows of a bucket aggregated at once: their gathered [rows, L, d] f32
# vectors stay within this many bytes
ENCODE_BLOCK_BYTES = 256 << 20


class SpanVectors(AbstractVectors):
    """[n, d] span vectors held as a tensor on a device; ``normalized`` and
    ``magnitudes`` (the ``Vectors`` arithmetic: x / max(|x|, EPS)) are made
    there at first use."""

    def __init__(self, unmodified: torch.Tensor):
        self._unmodified = unmodified
        self._normalized = None
        self._magnitudes = None

    @property
    def size(self):
        return int(self._unmodified.shape[0])

    @property
    def unmodified(self) -> torch.Tensor:
        return self._unmodified

    @property
    def magnitudes(self) -> torch.Tensor:
        if self._magnitudes is None:
            self._magnitudes = torch.linalg.vector_norm(self._unmodified, dim=-1)
        return self._magnitudes

    @property
    def normalized(self) -> torch.Tensor:
        if self._normalized is None:
            m = torch.clamp_min(self.magnitudes, EPS)
            self._normalized = self._unmodified / m[:, None]
        return self._normalized

    def numpy(self) -> np.ndarray:
        return self._unmodified.detach().cpu().numpy()


class SpanEmbedding:
    """Embeds whole token spans into one vector."""

    def create_encoder(self, session):
        raise NotImplementedError()

    @property
    def name(self):
        raise NotImplementedError()


class AggregatedTokenEmbedding(SpanEmbedding):
    """agg(token vectors) over the span (reference span.py:27-93)."""

    def __init__(self, token_embedding, agg: str = "mean"):
        if agg not in ("mean", "min", "max"):
            raise ValueError(agg)
        self._token_embedding = token_embedding
        self._agg = agg

    @property
    def name(self):
        return f"{self._token_embedding.name}-{self._agg}"

    def create_encoder(self, session):
        return AggregatedSpanEncoder(self, session)


def _block(engine, db, table, name: str, rows: slice):
    """(vectors [r, L, d], lengths [r]) of a block of bucket ``db``'s rows:
    the static table gathered by their token ids (``table``), else the
    contextual store ``name``'s rows; a paged engine uploads the block's
    host rows, never the whole bucket."""
    if engine.paged:
        bi = db["bi"]
        ln = engine.rows_to_device(bi, "lengths", rows)
        if table is not None:
            return table[engine.rows_to_device(bi, "tokens", rows).long()], ln
        return engine.rows_to_device(bi, ("ctx", name), rows), ln
    if table is not None:
        return table[db["tokens"][rows].long()], db["lengths"][rows]
    return engine._ctx_dev(name, db["bi"])[rows], db["lengths"][rows]


def _aggregate(vecs: torch.Tensor, lengths: torch.Tensor, agg: str) -> torch.Tensor:
    """agg over each row's first ``lengths`` vectors of ``vecs`` [n, L, d]
    -> [n, d] f32.  The sum keeps ``vecs``' type (the JAX package sums the
    bf16 store into a bf16 result) before the f32 division; an empty row
    gives zeros."""
    L = vecs.shape[1]
    m = (torch.arange(L, device=vecs.device)[None, :] < lengths[:, None])[:, :, None]
    if agg == "mean":
        s = torch.where(m, vecs, torch.zeros((), dtype=vecs.dtype, device=vecs.device))
        return s.sum(1).float() / torch.clamp_min(lengths[:, None].float(), 1.0)
    fill = float("-inf") if agg == "max" else float("inf")
    v = torch.where(m, vecs, torch.full((), fill, dtype=vecs.dtype, device=vecs.device))
    v = (v.amax(1) if agg == "max" else v.amin(1)).float()
    return torch.where(torch.isfinite(v), v, torch.zeros((), device=v.device))


class AggregatedSpanEncoder:
    def __init__(self, spec: AggregatedTokenEmbedding, session):
        self._spec = spec
        self._session = session
        self._cache = {}

    @property
    def name(self):
        return self._spec.name

    def encode_corpus(self, session, partition) -> SpanVectors:
        """[n_slices, d] span vectors on the session's device, cached per
        partition spec: per bucket, blocks of rows gathered from the static
        table (or read from the contextual store) and aggregated."""
        key = partition.spec
        hit = self._cache.get(key)
        if hit is not None:
            return hit
        emb = self._spec._token_embedding
        agg = self._spec._agg
        engine = session.engine(partition.spec)
        if getattr(emb, "is_static", True):
            table = session.compiled_embeddings[emb.name].unmodified  # [V, d]
            d = int(table.shape[1])
        else:
            d = session._ctx_dims[emb.name]
            engine.ensure_contextual(emb.name, session.documents, d)
            table = None
        out = torch.zeros((engine.n_slices, d), dtype=torch.float32,
                          device=engine.device)
        for db in engine._device_buckets:
            n, L = db["n"], db["capacity"]
            if n == 0:
                continue
            step = max(1, ENCODE_BLOCK_BYTES // (L * d * 4))
            sids = torch.as_tensor(db["slice_index"], dtype=torch.int64,
                                   device=engine.device)
            for r0 in range(0, n, step):
                r1 = min(r0 + step, n)
                out[sids[r0:r1]] = _aggregate(*_block(engine, db, table, emb.name,
                                                      slice(r0, r1)), agg)
        result = SpanVectors(out)
        self._cache[key] = result
        return result

    def encode_text(self, text: str) -> Vectors:
        """Query-side: parse + normalize like a document, aggregate."""
        session = self._session
        emb = self._spec._token_embedding
        sdoc = session.nlp(text)
        j = sdoc.to_json()
        table = {
            "text": [text[t["start"] : t["end"]] for t in j["tokens"]],
            "pos": [t.get("pos", "X") for t in j["tokens"]],
            "tag": [t.get("tag", "XX") for t in j["tokens"]],
        }
        mask = session.normalization.apply(table)
        keep = np.flatnonzero(mask)
        strings = [table["text"][i] for i in keep]
        if getattr(emb, "is_static", True):
            comp = session.compiled_embeddings[emb.name]
            vecs = np.asarray(comp.encode_query(strings).unmodified)
        else:
            qd = session.encode_contextual_query(emb.name, sdoc, text, keep)
            vecs = qd["unmodified"]
        if len(vecs) == 0:
            d = vecs.shape[1] if vecs.ndim == 2 else 1
            return Vectors(np.zeros((1, d), np.float32))
        agg = self._spec._agg
        if agg == "mean":
            v = vecs.mean(axis=0)
        elif agg == "max":
            v = vecs.max(axis=0)
        else:
            v = vecs.min(axis=0)
        return Vectors(np.asarray(v, np.float32)[None])


class TextSpanEmbedding(SpanEmbedding):
    """Pure-text span encoder: user fn(text) -> [d] (reference
    _LambdaImpl:136 / spaCy doc.vector impl)."""

    def __init__(self, name: str, fn: Callable[[str], np.ndarray], dimension: int):
        self._name = name
        self._fn = fn
        self._dimension = dimension

    @property
    def name(self):
        return self._name

    def create_encoder(self, session):
        return TextSpanEncoder(self, session)


class TextSpanEncoder:
    def __init__(self, spec: TextSpanEmbedding, session):
        self._spec = spec
        self._session = session
        self._cache = {}

    @property
    def name(self):
        return self._spec.name

    def encode_corpus(self, session, partition) -> SpanVectors:
        """Each slice's text through the user's function on the host, the
        [n_slices, d] result uploaded once."""
        key = partition.spec
        hit = self._cache.get(key)
        if hit is not None:
            return hit
        packed = session.packed_corpus(partition.spec)
        out = np.zeros((packed.n_slices, self._spec._dimension), np.float32)
        for sid in range(packed.n_slices):
            d_i = int(packed.slice_doc[sid])
            pd = session.documents[d_i]
            s0 = int(packed.slice_start[sid])
            ln = int(packed.slice_len[sid])
            if ln == 0:
                continue
            o_lo = pd.orig_index[s0]
            o_hi = pd.orig_index[s0 + ln - 1]
            text = pd.doc.text[
                pd.doc.idx[o_lo] : pd.doc.idx[o_hi] + pd.doc.len_[o_hi]
            ]
            out[sid] = np.asarray(self._spec._fn(text), np.float32)
        result = SpanVectors(torch.as_tensor(out, device=session.device))
        self._cache[key] = result
        return result

    def encode_text(self, text: str) -> Vectors:
        return Vectors(np.asarray(self._spec._fn(text), np.float32)[None])


def SentenceEmbedding(token_embedding, agg="mean"):
    """Convenience alias (reference span.py:357)."""
    return AggregatedTokenEmbedding(token_embedding, agg)
