"""Static (keyed) word embeddings: loaders, normalization-aware caching,
encoders.

Reference: vectorian/embedding/token/keyed.py — gensim-based loaders with a
normalization-aware memmap cache (CachedWordEmbedding.create_encoder
keyed.py:144-198), OOV->0 (Encoder.word_vec:93-109), dedup+sampling
(embedding/utils.py:88-123), stacked embeddings (keyed.py:352).

gensim is not a dependency here: word2vec text/binary and GloVe text formats
are parsed directly (simple, stable formats), and fastText ngram vectors come
from vectorian_tpu_torch/embedding/fasttext.py.
"""

from __future__ import annotations

import hashlib
import json
import os
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np

from vectorian_tpu_torch.embedding.vectors import Vectors


def cache_home() -> Path:
    """~/.vectorian_tpu_torch or $VECTORIAN_CACHE_HOME (reference
    embedding/utils.py:21-35)."""
    root = os.environ.get("VECTORIAN_CACHE_HOME")
    p = Path(root) if root else Path.home() / ".vectorian_tpu_torch"
    p.mkdir(parents=True, exist_ok=True)
    return p


def normalize_word2vec(tokens, embeddings, normalizer, sampling="nearest"):
    """Dedup token list under a normalizer (reference
    embedding/utils.py:88-123): 'nearest' keeps tokens already in normal
    form; 'average' merges all variants by mean."""
    if sampling not in ("nearest", "average"):
        raise ValueError(f'expected "nearest" or "average", got "{sampling}"')
    embeddings = np.asarray(embeddings, np.float32)

    f_mask = np.zeros((embeddings.shape[0],), dtype=bool)
    f_tokens: List[str] = []
    token_to_ids: Dict[str, List[int]] = {}

    for i, t in enumerate(tokens):
        nt = normalizer(t) if normalizer else t
        if nt is None or nt == "":
            continue
        if sampling != "average" and nt != t:
            continue
        indices = token_to_ids.get(nt)
        if indices is None:
            token_to_ids[nt] = [i]
            f_tokens.append(nt)
            f_mask[i] = True
        else:
            indices.append(i)

    if sampling == "average":
        for indices in token_to_ids.values():
            if len(indices) > 1:
                embeddings[indices[0]] = np.mean(embeddings[indices], axis=0)

    return f_tokens, embeddings[f_mask]


# ---------------------------------------------------------------- loaders


def load_word2vec_text(path, max_words: Optional[int] = None):
    """word2vec .txt / .vec format: optional 'n d' header, then rows."""
    words, vecs = [], []
    with open(path, "r", encoding="utf-8", errors="replace") as f:
        first = f.readline().rstrip("\n")
        parts = first.split(" ")
        if len(parts) == 2 and all(p.isdigit() for p in parts):
            dim = int(parts[1])
        else:
            vals = parts[1:]
            dim = len(vals)
            words.append(parts[0])
            vecs.append(np.asarray(vals, np.float32))
        for line in f:
            parts = line.rstrip("\n").split(" ")
            if len(parts) < dim + 1:
                continue
            words.append(parts[0])
            vecs.append(np.asarray(parts[1 : dim + 1], np.float32))
            if max_words and len(words) >= max_words:
                break
    return words, np.vstack(vecs) if vecs else np.zeros((0, 0), np.float32)


def load_word2vec_binary(path, max_words: Optional[int] = None):
    """word2vec .bin format (header 'n d\\n', then <word> <sp> <d floats>)."""
    words, vecs = [], []
    with open(path, "rb") as f:
        header = f.readline().decode("utf-8")
        n, dim = (int(x) for x in header.split())
        if max_words:
            n = min(n, max_words)
        row_bytes = dim * 4
        for _ in range(n):
            w = bytearray()
            while True:
                c = f.read(1)
                if c == b" " or c == b"":
                    break
                if c != b"\n":
                    w.extend(c)
            words.append(w.decode("utf-8", errors="replace"))
            vecs.append(np.frombuffer(f.read(row_bytes), np.float32))
    return words, np.vstack(vecs) if vecs else np.zeros((0, 0), np.float32)


def load_glove_text(path, max_words: Optional[int] = None):
    """GloVe .txt (no header) — same row format as word2vec text."""
    return load_word2vec_text(path, max_words=max_words)


# ---------------------------------------------------------------- embeddings


class TokenEmbedding:
    """Base for all token embeddings (reference embedding/__init__.py)."""

    @property
    def name(self) -> str:
        raise NotImplementedError()

    @property
    def is_static(self) -> bool:
        raise NotImplementedError()

    @property
    def is_contextual(self) -> bool:
        return not self.is_static

    def create_encoder(self, normalization=None):
        raise NotImplementedError()


class StaticEmbeddingEncoder:
    """Maps token strings to vectors; unknown tokens -> zero vector
    (reference keyed.py:93-109)."""

    def __init__(self, name: str, words: Sequence[str], matrix: np.ndarray, transforms=()):
        self._name = name
        self._word_to_row = {w: i for i, w in enumerate(words)}
        self._matrix = np.asarray(matrix, np.float32)
        for tfm in transforms:
            self._matrix = np.asarray(tfm.apply(self._matrix), np.float32)
        self._transforms = tuple(transforms)

    @property
    def name(self):
        return self._name

    @property
    def dimension(self) -> int:
        return self._matrix.shape[1]

    @property
    def n_words(self) -> int:
        return self._matrix.shape[0]

    def word_vec(self, w: str) -> np.ndarray:
        i = self._word_to_row.get(w)
        if i is None:
            return np.zeros((self.dimension,), np.float32)
        return self._matrix[i]

    def encode_tokens(self, tokens: Sequence[str]) -> Vectors:
        # one fancy gather instead of a per-token row copy (the reference's
        # session-compile hot spot, keyed.py:104-109)
        get = self._word_to_row.get
        rows = np.fromiter((get(t, -1) for t in tokens), np.int64, len(tokens))
        out = np.zeros((len(tokens), self.dimension), np.float32)
        found = rows >= 0
        if found.any():
            out[found] = self._matrix[rows[found]]
        return Vectors(out)

    def transform_query(self, vectors: np.ndarray) -> np.ndarray:
        """Replay fitted transforms on query-side vectors."""
        v = np.asarray(vectors, np.float32)
        for tfm in self._transforms:
            v = np.asarray(tfm.apply(v), np.float32)
        return v


class StaticEmbedding(TokenEmbedding):
    @property
    def is_static(self):
        return True

    def to_token_sim(self, metric=None):
        from vectorian_tpu_torch.sim.token import EmbeddingTokenSim

        return EmbeddingTokenSim(self, metric)


class CachedWordEmbedding(StaticEmbedding):
    """Static embedding with a normalization-aware on-disk cache.

    The cache key is (embedding name, normalizer ident, sampling,
    transforms); the cached artifact is a float32 .npy matrix + token list —
    the reference's np.memmap .dat + json manifest + sqlite catalog
    (keyed.py:144-198) collapsed into content-addressed files.
    """

    def __init__(self, embedding_sampling: str = "nearest", transforms=()):
        self._sampling = embedding_sampling
        self._transforms = tuple(transforms)

    def _load(self):
        """Return (words, matrix) raw — implemented by subclasses."""
        raise NotImplementedError()

    def pca(self, n_dims: int) -> "CachedWordEmbedding":
        from vectorian_tpu_torch.embedding.transform import PCACompression

        clone = self.__class__.__new__(self.__class__)
        clone.__dict__.update(self.__dict__)
        clone._transforms = self._transforms + (PCACompression(n_dims),)
        return clone

    def create_encoder(self, normalization=None) -> StaticEmbeddingEncoder:
        norm_ident = normalization.ident if normalization is not None else None
        tf_ident = tuple(t.name for t in self._transforms)
        key = json.dumps(
            [self.name, repr(norm_ident), self._sampling, tf_ident], sort_keys=True
        )
        digest = hashlib.sha256(key.encode()).hexdigest()[:24]
        cdir = cache_home() / "embeddings"
        cdir.mkdir(parents=True, exist_ok=True)
        mat_path = cdir / f"{digest}.npy"
        words_path = cdir / f"{digest}.words.json"

        if mat_path.exists() and words_path.exists():
            matrix = np.load(mat_path, mmap_mode="r")
            with open(words_path) as f:
                words = json.load(f)
        else:
            words, matrix = self._load()
            normalizer = (
                normalization.normalize_word if normalization is not None else None
            )
            words, matrix = normalize_word2vec(
                words, matrix, normalizer, self._sampling
            )
            fitted = []
            for tfm in self._transforms:
                ft = tfm.fit(matrix)
                matrix = np.asarray(ft.apply(matrix), np.float32)
                fitted.append(ft)
            np.save(mat_path, matrix.astype(np.float32))
            with open(words_path, "w") as f:
                json.dump(list(words), f)
        # transforms already baked into the cached matrix; queries encode
        # through encode_tokens so no further transform replay is needed for
        # in-vocab tokens.
        return StaticEmbeddingEncoder(self.name, words, matrix)


class KeyedVectors(StaticEmbedding):
    """In-memory (words, matrix) embedding — also the adapter for anything
    gensim-like the user already has loaded (reference keyed.py:279)."""

    def __init__(self, name: str, words: Sequence[str], matrix: np.ndarray):
        self._name = name
        self._words = list(words)
        self._matrix = np.asarray(matrix, np.float32)

    @property
    def name(self):
        return self._name

    def create_encoder(self, normalization=None) -> StaticEmbeddingEncoder:
        normalizer = normalization.normalize_word if normalization is not None else None
        words, matrix = normalize_word2vec(self._words, self._matrix, normalizer)
        return StaticEmbeddingEncoder(self._name, words, matrix)


class Word2VecVectors(CachedWordEmbedding):
    """word2vec text or binary file (reference keyed.py:249)."""

    def __init__(self, name, path, binary: Optional[bool] = None, **kwargs):
        super().__init__(**kwargs)
        self._name_ = name
        self._path = Path(path)
        if binary is None:
            binary = self._path.suffix == ".bin"
        self._binary = binary

    @property
    def name(self):
        return f"word2vec-{self._name_}"

    def _load(self):
        if self._binary:
            return load_word2vec_binary(self._path)
        return load_word2vec_text(self._path)


class PretrainedGloVe(CachedWordEmbedding):
    """GloVe text file (reference keyed.py:330 downloads; here the file must
    exist locally or in the cache dir — zero-egress deployments)."""

    def __init__(self, name="6B", ndims=300, path=None, **kwargs):
        super().__init__(**kwargs)
        self._name_ = name
        self._ndims = ndims
        self._path = Path(path) if path else cache_home() / "glove" / f"glove.{name}.{ndims}d.txt"

    @property
    def name(self):
        return f"glove-{self._name_}-{self._ndims}"

    def _load(self):
        if not self._path.exists():
            raise FileNotFoundError(
                f"GloVe file not found: {self._path}. Download it manually "
                f"(zero-egress environment) or pass path=..."
            )
        return load_glove_text(self._path)


class OneHotEncoding(StaticEmbedding):
    """Degenerate test embedding: exact-match-only similarity
    (reference keyed.py:267)."""

    def __init__(self, words: Sequence[str], name="one-hot"):
        self._words = list(words)
        self._name = name

    @property
    def name(self):
        return self._name

    def create_encoder(self, normalization=None):
        n = len(self._words)
        return StaticEmbeddingEncoder(self._name, self._words, np.eye(n, dtype=np.float32))


class StackedEmbedding(StaticEmbedding):
    """hstack of several static embeddings (reference keyed.py:352)."""

    def __init__(self, embeddings: Sequence[StaticEmbedding], name=None):
        self._embeddings = list(embeddings)
        self._name = name or ("stacked-" + "-".join(e.name for e in embeddings))

    @property
    def name(self):
        return self._name

    def create_encoder(self, normalization=None):
        encoders = [e.create_encoder(normalization) for e in self._embeddings]

        class _Stacked:
            def __init__(self, name, encoders):
                self.name = name
                self._encoders = encoders
                self.dimension = sum(e.dimension for e in encoders)

            def word_vec(self, w):
                return np.concatenate([e.word_vec(w) for e in self._encoders])

            def encode_tokens(self, tokens):
                return Vectors(
                    np.hstack(
                        [e.encode_tokens(tokens).unmodified for e in self._encoders]
                    )
                )

            def transform_query(self, vectors):
                return vectors

        return _Stacked(self._name, encoders)
