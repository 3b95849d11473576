"""Document model: token tables, spans, prepared (session-bound) documents.

Reference: vectorian/corpus/document.py — storage-backed token tables
(TokenTable:17), sliding-window span arithmetic (xspan:123-131), and
PreparedDocument (:626), which re-indexes sentence spans through the
normalization flavor's token mask (:641-649).

Here a Document is a plain struct of numpy columns; preparing it for a
session applies a normalization flavor (keep-mask + normalized token ids) and
yields filtered arrays ready for corpus packing (corpus/packing.py).
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np


def xspan(idxs, lens, i0, window_size, window_step):
    """Token range of window ``i0`` over span-start indices ``idxs``
    (reference corpus/document.py:123-131)."""
    i = i0 * window_step
    start = idxs[i]
    j = i + window_size
    if j <= len(idxs) - 1:
        end = idxs[j]
    else:
        end = idxs[-1] + lens[-1]
    return start, end


def n_windows(n_units: int, window_step: int) -> int:
    """Number of sliding windows (reference corpus/document.py:715-729)."""
    if n_units <= 0:
        return 0
    k = n_units // window_step
    if k * window_step < n_units:
        k += 1
    return k


class Token:
    """User-facing token handle (reference corpus/document.py:541-572):
    ``.text`` reads the ORIGINAL surface form out of the document text,
    ``.pos``/``.tag`` the NLP annotations, and the notebook repr renders
    the reference's pill style."""

    _css = "background:\t#F5F5F5; border-radius:0.25em;"
    _html_template = '<span style="{style}">{text}</span>'

    def __init__(self, doc: "Document", index: int):
        self._doc = doc
        self._index = int(index)

    @property
    def doc(self) -> "Document":
        return self._doc

    @property
    def index(self) -> int:
        return self._index

    def to_slice(self) -> slice:
        off = int(self._doc.idx[self._index])
        return slice(off, off + int(self._doc.len_[self._index]))

    @property
    def text(self) -> str:
        return self._doc.text[self.to_slice()]

    @property
    def pos(self) -> str:
        return self._doc.pos[self._index]

    @property
    def tag(self) -> str:
        return self._doc.tag[self._index]

    def __repr__(self):
        return f"Token({self.text!r})"

    def _repr_html_(self):
        import html

        return Token._html_template.format(
            style=Token._css, text=html.escape(self.text)
        )


class Span:
    """A contiguous token range of a document (reference
    corpus/document.py:575-623): iterable/indexable over :class:`Token`,
    with ``.text`` reconstructing the covered character range."""

    def __init__(self, doc: "Document", start: int, end: int):
        self._doc = doc
        self._start = int(start)
        self._end = int(end)

    @property
    def doc(self) -> "Document":
        return self._doc

    @property
    def start(self) -> int:
        return self._start

    @property
    def end(self) -> int:
        return self._end

    def __len__(self):
        return self._end - self._start

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]

    def __getitem__(self, i: int) -> Token:
        n = len(self)
        if i < 0 or i >= n:
            raise IndexError(f"{i} not in [0, {n}[")
        return Token(self._doc, self._start + i)

    @property
    def text(self) -> str:
        if self._end <= self._start:
            return ""
        i0 = int(self._doc.idx[self._start])
        i1 = int(
            self._doc.idx[self._end - 1] + self._doc.len_[self._end - 1]
        )
        return self._doc.text[i0:i1]

    def __repr__(self):
        return f"Span({self.text!r})"

    def _repr_html_(self):
        return " ".join(self[i]._repr_html_() for i in range(len(self)))


@dataclass
class Document:
    """An imported document: original text + token table + span tables.

    Columns: ``idx``/``len`` char offsets into ``text`` (i32), ``pos``/``tag``
    universal/fine POS strings per token; ``spans['sentence']`` holds
    (start, end) *token* indices per sentence.
    """

    text: str
    idx: np.ndarray  # [n] i32 char offset
    len_: np.ndarray  # [n] i32 char length
    pos: List[str]
    tag: List[str]
    spans: Dict[str, np.ndarray]  # level -> [m, 2] (token start, token end)
    metadata: dict = field(default_factory=dict)
    contextual_embeddings: dict = field(default_factory=dict)  # name -> [n, d]
    unique_id: Optional[str] = None

    @property
    def n_tokens(self) -> int:
        return int(self.idx.shape[0])

    def token_text(self, i: int) -> str:
        return self.text[self.idx[i] : self.idx[i] + self.len_[i]]

    def token_texts(self) -> List[str]:
        t = self.text
        return [t[i : i + l] for i, l in zip(self.idx, self.len_)]

    # --- user-facing browsing (reference corpus/document.py:541-623) ---

    def token(self, i: int) -> "Token":
        return Token(self, i)

    def span(self, level: str, i: int) -> "Span":
        """The i-th span of a span table (e.g. sentence i), as a
        browsable :class:`Span` of original tokens."""
        s, e = self.spans[level][i]
        return Span(self, int(s), int(e))

    def sentences(self) -> List["Span"]:
        table = self.spans.get("sentence")
        if table is None:
            return []
        return [Span(self, int(s), int(e)) for s, e in np.asarray(table)]

    @property
    def structure(self) -> str:
        """Prose outline of the document's span structure (reference
        Document.structure, corpus/document.py:503-515)."""
        lines = [f"document: {self.title or '(untitled)'}"]
        for j, sent in enumerate(self.sentences()):
            lines.append(f"  sentence {j + 1}:")
            lines.append("    " + sent.text)
        return "\n".join(lines)

    @property
    def title(self):
        return self.metadata.get("title", "")

    @property
    def author(self):
        return self.metadata.get("author", "")

    # --- persistence (h5 group) ---

    def save_to(self, grp):
        import h5py

        str_dt = h5py.string_dtype(encoding="utf-8")
        grp.create_dataset("idx", data=self.idx.astype(np.int32))
        grp.create_dataset("len", data=self.len_.astype(np.int32))
        grp.create_dataset("pos", data=np.asarray(self.pos, dtype=str_dt))
        grp.create_dataset("tag", data=np.asarray(self.tag, dtype=str_dt))
        sg = grp.create_group("spans")
        for level, arr in self.spans.items():
            sg.create_dataset(level, data=np.asarray(arr, np.int32))
        grp.attrs["metadata"] = json.dumps(self.metadata)
        if self.unique_id:
            grp.attrs["unique_id"] = self.unique_id
        if self.contextual_embeddings:
            eg = grp.create_group("contextual")
            for name, vecs in self.contextual_embeddings.items():
                eg.create_dataset(name, data=np.asarray(vecs, np.float32))

    @staticmethod
    def load_from(grp, text: str) -> "Document":
        spans = {k: np.asarray(v) for k, v in grp["spans"].items()}
        ctx = {}
        if "contextual" in grp:
            # lazy references: vector bytes are read only when a contextual
            # query first needs them (reference ExternalMemoryVectors,
            # embedding/vectors.py:245-292)
            from vectorian_tpu_torch.embedding.vectors import ExternalMemoryVectors

            fname = grp.file.filename
            base = grp.name
            ctx = {
                k: ExternalMemoryVectors(fname, f"{base}/contextual/{k}")
                for k in grp["contextual"]
            }
        return Document(
            text=text,
            idx=np.asarray(grp["idx"]),
            len_=np.asarray(grp["len"]),
            # one read a dataset: iterating an h5 dataset reads an element a
            # call (~0.1 ms each, minutes at a million sentences)
            pos=grp["pos"].asstr()[()].tolist(),
            tag=grp["tag"].asstr()[()].tolist(),
            spans=spans,
            metadata=json.loads(grp.attrs.get("metadata", "{}")),
            unique_id=grp.attrs.get("unique_id"),
            contextual_embeddings=ctx,
        )


@dataclass
class PreparedDocument:
    """A document bound to a session: flavor applied, tokens interned.

    ``token_ids`` are vocabulary ids of the *normalized* surviving tokens;
    ``orig_index`` maps each surviving token back to its original token index
    (for text region reconstruction); ``spans`` are re-indexed into the
    filtered token space (reference corpus/document.py:641-649).
    """

    doc: Document
    doc_index: int
    token_ids: np.ndarray  # [m] i32
    pos_ids: np.ndarray  # [m] i8
    tag_ids: np.ndarray  # [m] i16
    orig_index: np.ndarray  # [m] i32
    spans: Dict[str, np.ndarray]  # level -> [k, 2] filtered token ranges
    contextual: Dict[str, np.ndarray] = field(default_factory=dict)  # name -> [m, d]

    @property
    def n_tokens(self) -> int:
        return int(self.token_ids.shape[0])

    def n_spans(self, partition) -> int:
        if partition.level == "token":
            return n_windows(self.n_tokens, partition.window_step)
        if partition.level == "document":
            return 1 if self.n_tokens > 0 else 0
        starts = self.spans[partition.level][:, 0]
        n = starts.shape[0]
        while n > 0 and starts[n - 1] >= self.n_tokens:
            n -= 1
        return n_windows(n, partition.window_step)

    def token(self, i: int) -> "Token":
        """The i-th SURVIVING token, as a browsable handle over the
        original document text (reference PreparedDocument token access
        through the flavor mask, corpus/document.py:641-649)."""
        return Token(self.doc, int(self.orig_index[i]))

    def span(self, partition, i: int) -> "Span":
        """Slice ``i`` of ``partition`` as a browsable :class:`Span` of
        ORIGINAL tokens — the user-facing counterpart of the packed
        engine slice (same windowing arithmetic as span_ranges)."""
        s, e = self.span_ranges(partition)[i]
        return self.span_from_filtered(int(s), int(e))

    def span_from_filtered(self, s: int, e: int) -> "Span":
        """A browsable :class:`Span` from a FILTERED-token range (the
        engine's slice coordinates) mapped back to original tokens."""
        if e <= s:
            return Span(self.doc, 0, 0)
        o0 = int(self.orig_index[s])
        o1 = int(self.orig_index[e - 1]) + 1
        return Span(self.doc, o0, o1)

    def span_ranges(self, partition) -> np.ndarray:
        """[k, 2] (token_start, token_end) per slice of this partition."""
        k = self.n_spans(partition)
        out = np.zeros((k, 2), np.int32)
        if k == 0:
            return out
        if partition.level == "token":
            s = np.arange(k, dtype=np.int32) * partition.window_step
            out[:, 0] = s
            out[:, 1] = np.minimum(s + partition.window_size, self.n_tokens)
        elif partition.level == "document":
            out[0] = (0, self.n_tokens)
        else:
            table = self.spans[partition.level]
            idxs = table[:, 0]
            lens = table[:, 1] - table[:, 0]
            if partition.window_size == 1 and partition.window_step == 1:
                # the default sentence partition, vectorized with xspan's
                # exact semantics: window i ends at the NEXT span's start
                # (gap tokens stay in the earlier slice), last span ends at
                # its own end (reference corpus/document.py:123-131)
                out[:, 0] = idxs[:k]
                out[: k - 1, 1] = idxs[1:k]
                # the last KEPT window still ends at the next span's start
                # when trailing spans were trimmed (xspan clamps it to
                # n_tokens) — ending at its own span end would drop kept
                # gap tokens after the final surviving sentence
                out[k - 1, 1] = (
                    idxs[k] if k < len(idxs) else idxs[k - 1] + lens[k - 1]
                )
                np.minimum(out[:, 1], self.n_tokens, out=out[:, 1])
            else:
                for i in range(k):
                    s, e = xspan(
                        idxs, lens, i, partition.window_size, partition.window_step
                    )
                    out[i] = (s, min(e, self.n_tokens))
        return out


def prepare_document(
    doc: Document, doc_index: int, normalization, vocabulary
) -> PreparedDocument:
    """Apply a normalization flavor and intern tokens into the session
    vocabulary (reference Session prepare path, session.py:58-71 +
    FlavorBuilder corpus/corpus.py:68-192)."""
    table = {
        "text": doc.token_texts(),
        "pos": list(doc.pos),
        "tag": list(doc.tag),
    }
    mask = normalization.apply(table)
    keep = np.flatnonzero(mask).astype(np.int32)

    texts = [table["text"][i] for i in keep]
    pos = [table["pos"][i] for i in keep]
    tag = [table["tag"][i] for i in keep]

    token_ids = vocabulary.intern_tokens(texts)
    pos_ids = np.asarray([vocabulary.pos_id(p) for p in pos], np.int8)
    tag_ids = np.asarray([vocabulary.tag_id(t) for t in tag], np.int16)

    # re-index spans through the keep mask: new_start = #kept before start
    cum = np.zeros((doc.n_tokens + 1,), np.int32)
    np.cumsum(mask.astype(np.int32), out=cum[1:])
    spans = {}
    for level, arr in doc.spans.items():
        arr = np.asarray(arr, np.int32)
        spans[level] = np.stack([cum[arr[:, 0]], cum[arr[:, 1]]], axis=1)

    from vectorian_tpu_torch.embedding.vectors import LazyVectors

    contextual = {
        name: LazyVectors(vecs, keep)
        for name, vecs in doc.contextual_embeddings.items()
        if len(vecs)
    }

    return PreparedDocument(
        doc=doc,
        doc_index=doc_index,
        token_ids=token_ids,
        pos_ids=pos_ids,
        tag_ids=tag_ids,
        orig_index=keep,
        spans=spans,
        contextual=contextual,
    )
