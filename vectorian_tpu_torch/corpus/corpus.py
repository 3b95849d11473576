"""Persistent corpus storage.

Reference: vectorian/corpus/corpus.py — a corpus directory holding
``corpus.h5`` (token tables per doc), ``corpus.db`` sqlite (full text keyed
by content hash, dedup via Document.find_duplicates, document.py:403-415),
per-normalization flavor caches (FlavorBuilder:68-192) and an embeddings
catalog (EmbeddingCatalog:195-242).

The same layout is kept (h5 + sqlite), including persisted flavors:
``flavors/<ident-digest>.h5`` stores the session-ready prepared arrays
(vocabulary strings + per-doc normalized token/pos/tag ids, keep mask and
re-indexed spans, reference FlavorBuilder corpus.py:68-192) keyed by the
corpus content so a reopened corpus skips normalization and vocab
interning entirely.  File names, dataset names, dtypes and the flavor key
(a digest of ``repr(normalization.ident)``) are those of the JAX package's
corpus module, so a directory written by either package opens in the
other.  Document order is the h5 group's key order (sorted
uuid4 strings), not insertion order.  h5py is imported when a corpus is
opened, not with this module.
"""

from __future__ import annotations

import hashlib
import sqlite3
import tempfile
import uuid as uuid_mod
from pathlib import Path
from typing import Iterator, List, Optional

import numpy as np

from vectorian_tpu_torch.corpus.document import Document
from vectorian_tpu_torch.utils.progress import progress as _progress


def _sha256(text: str) -> str:
    return hashlib.sha256(text.encode("utf-8")).hexdigest()


class Corpus:
    """A persistent, deduplicating collection of documents."""

    def __init__(self, path):
        import h5py

        self._path = Path(path)
        self._path.mkdir(parents=True, exist_ok=True)
        self._db = sqlite3.connect(self._path / "corpus.db")
        self._db.execute(
            "CREATE TABLE IF NOT EXISTS text ("
            "unique_id TEXT PRIMARY KEY, content_hash TEXT, content TEXT)"
        )
        self._db.execute(
            "CREATE INDEX IF NOT EXISTS idx_hash ON text (content_hash)"
        )
        self._db.commit()
        self._h5 = h5py.File(self._path / "corpus.h5", "a")
        self._docs_grp = self._h5.require_group("documents")

    @property
    def path(self) -> Path:
        return self._path

    def __len__(self) -> int:
        return len(self._docs_grp)

    @property
    def uuids(self) -> List[str]:
        return list(self._docs_grp.keys())

    def find_duplicate(self, doc: Document) -> Optional[str]:
        """unique_id of an existing doc with identical text, if any
        (reference Document.find_duplicates, document.py:403-415)."""
        h = _sha256(doc.text)
        cur = self._db.execute(
            "SELECT unique_id, content FROM text WHERE content_hash=?", (h,)
        )
        for uid, content in cur.fetchall():
            if content == doc.text:
                return uid
        return None

    def add_doc(self, doc: Document) -> str:
        """Add (or dedup) a document; returns its unique id (reference
        corpus.py:383-407)."""
        existing = self.find_duplicate(doc)
        if existing is not None:
            return existing
        uid = str(uuid_mod.uuid4())
        doc.unique_id = uid
        # write the h5 token tables BEFORE committing the sqlite text row:
        # if anything fails mid-way, the h5 group is deleted so nothing
        # leaks (each retry uses a fresh uuid, so an orphan group would
        # never be revisited) and dedup never resolves the text to a
        # missing h5 group (an orphan db row would make the doc
        # un-addable)
        try:
            grp = self._docs_grp.create_group(uid)
            doc.save_to(grp)
            self._h5.flush()
            self._db.execute(
                "INSERT INTO text (unique_id, content_hash, content)"
                " VALUES (?,?,?)",
                (uid, _sha256(doc.text), doc.text),
            )
            self._db.commit()
        except Exception:
            if uid in self._docs_grp:
                del self._docs_grp[uid]
                self._h5.flush()
            raise
        return uid

    def get_doc(self, unique_id: str) -> Document:
        cur = self._db.execute(
            "SELECT content FROM text WHERE unique_id=?", (unique_id,)
        )
        row = cur.fetchone()
        if row is None:
            raise KeyError(unique_id)
        return Document.load_from(self._docs_grp[unique_id], row[0])

    def __iter__(self) -> Iterator[Document]:
        for uid in _progress(self.uuids, desc="loading corpus"):
            yield self.get_doc(uid)

    @property
    def docs(self) -> List[Document]:
        return list(self)

    # --- persisted normalization flavors (reference FlavorBuilder,
    # corpus/corpus.py:68-192: PREFLIGHT builds enum mappings, ADD writes
    # per-doc masked tables; here one h5 per flavor holds the session-ready
    # prepared arrays so reopening skips normalization + interning) ---

    def content_key(self) -> str:
        """Digest of the document set (uids + content hashes) — cheap (no
        text reload) and exactly what a flavor's validity depends on."""
        rows = sorted(
            self._db.execute(
                "SELECT unique_id, content_hash FROM text"
            ).fetchall()
        )
        h = hashlib.sha256()
        for uid, ch in rows:
            h.update(uid.encode())
            h.update(ch.encode())
        return h.hexdigest()[:24]

    def _flavor_path(self, ident) -> Path:
        d = self._path / "flavors"
        d.mkdir(exist_ok=True)
        return d / (_sha256(repr(ident))[:16] + ".h5")

    def load_flavor(self, ident) -> Optional[dict]:
        """Prepared-session arrays for a normalization flavor, or None on
        miss/stale.  Returns {"uids", "tokens", "tags", "docs"} where docs
        is a list of dicts with token_ids/pos_ids/tag_ids/orig_index/spans."""
        import h5py

        path = self._flavor_path(ident)
        if not path.exists():
            return None
        try:
            with h5py.File(path, "r") as f:
                if f.attrs.get("content_key") != self.content_key():
                    return None
                uids = [s.decode() for s in f["uids"][()]]
                tokens = [s.decode() for s in f["tokens"][()]]
                tags = [s.decode() for s in f["tags"][()]]
                docs = []
                dg = f["docs"]
                for i in range(len(uids)):
                    g = dg[str(i)]
                    spans = {
                        k: np.asarray(v) for k, v in g["spans"].items()
                    }
                    docs.append(
                        {
                            "token_ids": np.asarray(g["token_ids"]),
                            "pos_ids": np.asarray(g["pos_ids"]),
                            "tag_ids": np.asarray(g["tag_ids"]),
                            "orig_index": np.asarray(g["orig_index"]),
                            "spans": spans,
                        }
                    )
                return {
                    "uids": uids,
                    "tokens": tokens,
                    "tags": tags,
                    "docs": docs,
                }
        except (OSError, KeyError, ValueError):
            # not a whole flavor file (torn write, other layout): a miss
            return None

    def save_flavor(self, ident, uids, tokens, tags, docs) -> None:
        """Persist prepared-session arrays (see load_flavor); best-effort
        (read-only corpus dirs simply skip)."""
        import h5py

        path = self._flavor_path(ident)
        try:
            with h5py.File(path, "w") as f:
                str_dt = h5py.string_dtype(encoding="utf-8")
                f.attrs["content_key"] = self.content_key()
                f.attrs["ident"] = repr(ident)
                f.create_dataset("uids", data=np.asarray(uids, dtype=str_dt))
                f.create_dataset(
                    "tokens", data=np.asarray(tokens, dtype=str_dt)
                )
                f.create_dataset("tags", data=np.asarray(tags, dtype=str_dt))
                dg = f.create_group("docs")
                for i, d in enumerate(docs):
                    g = dg.create_group(str(i))
                    g.create_dataset(
                        "token_ids", data=np.asarray(d["token_ids"], np.int32)
                    )
                    g.create_dataset(
                        "pos_ids", data=np.asarray(d["pos_ids"], np.int8)
                    )
                    g.create_dataset(
                        "tag_ids", data=np.asarray(d["tag_ids"], np.int16)
                    )
                    g.create_dataset(
                        "orig_index",
                        data=np.asarray(d["orig_index"], np.int32),
                    )
                    sg = g.create_group("spans")
                    for level, arr in d["spans"].items():
                        sg.create_dataset(
                            level, data=np.asarray(arr, np.int32)
                        )
        except OSError:
            pass

    def close(self):
        self._h5.close()
        self._db.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class TemporaryCorpus(Corpus):
    """Corpus in a temp directory (reference corpus.py:428)."""

    def __init__(self):
        self._tmp = tempfile.TemporaryDirectory(prefix="vectorian_tpu_torch_corpus_")
        super().__init__(self._tmp.name)

    def close(self):
        super().close()
        self._tmp.cleanup()
