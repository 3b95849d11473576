"""fastText embeddings: native .bin parsing + subword ngram hashing (the
port's own copy of the reference package's module: host-side numpy, no
device code; its vectors feed the session's compiled [V, d] matrix).

Reference: vectorian/embedding/token/fasttext.py — PretrainedFastText wraps
the fasttext package (`ft.get_word_vector`, fasttext.py:63-74) which handles
OOV words by construction via hashed character ngrams.

No fasttext package here: the .bin model format and the FNV-1a subword
hashing are implemented directly (they are stable, documented formats), so
arbitrary query tokens get vectors exactly like upstream fastText.  The hot
part — summing ngram rows for a batch of words — also has a C++ fast path in
native/ (ngram hashing is pure byte-crunching the CPython interpreter is bad
at).
"""

from __future__ import annotations

import struct
from pathlib import Path
from typing import List, Optional, Sequence

import numpy as np

from vectorian_tpu_torch.embedding.static import StaticEmbedding, cache_home
from vectorian_tpu_torch.embedding.vectors import Vectors

FASTTEXT_MAGIC = 793712314
EOS = "</s>"
BOW, EOW = "<", ">"


def fnv1a_hash(s: bytes) -> int:
    """fastText's dictionary hash: FNV-1a 32-bit over *sign-extended* bytes
    (upstream XORs int8_t values, so bytes >= 0x80 flip the high bits)."""
    h = 2166136261
    for b in s:
        h = h ^ (b if b < 0x80 else (0xFFFFFF00 | b))
        h = (h * 16777619) & 0xFFFFFFFF
    return h


def word_ngrams(word: str, minn: int, maxn: int) -> List[str]:
    """Character ngrams of '<word>' with length minn..maxn, matching
    fastText's computeSubwords exactly: the ONLY exclusion is single-char
    ngrams touching an edge (the bare '<' / '>'); the full '<word>' ngram
    IS included whenever minn <= len('<word>') <= maxn — e.g. '<the>'
    contributes for cc models (minn=3), and an OOV single-char word still
    gets its '<x>' vector."""
    w = BOW + word + EOW
    out = []
    n = len(w)
    for i in range(n):
        for l in range(minn, maxn + 1):
            if i + l <= n and not (l == 1 and (i == 0 or i + l == n)):
                out.append(w[i : i + l])
    return out


def _write_args(f, dim: int, bucket: int, minn: int, maxn: int) -> None:
    """fastText Args::save layout (12 int32 + one double)."""
    f.write(
        struct.pack(
            "<12i", dim, 5, 5, 5, 5, 1, 1, 1, bucket, minn, maxn, 100
        )
    )
    f.write(struct.pack("<d", 1e-4))


def _write_dictionary(f, words: Sequence[str], pruneidx=None) -> None:
    """fastText Dictionary::save layout: size/nwords/nlabels int32,
    ntokens/pruneidx_size int64, per-entry utf8+NUL + count(i64) +
    type(i8), then pruneidx (int32, int32) pairs.  pruneidx_size is -1
    when the dictionary is unpruned (fastText's sentinel; 0 means 'every
    ngram pruned away')."""
    f.write(struct.pack("<3i", len(words), len(words), 0))
    f.write(
        struct.pack(
            "<2q", len(words), -1 if pruneidx is None else len(pruneidx)
        )
    )
    for w in words:
        f.write(w.encode("utf-8") + b"\x00")
        f.write(struct.pack("<qb", 1, 0))
    if pruneidx:
        for a in sorted(pruneidx):
            f.write(struct.pack("<2i", a, pruneidx[a]))


class FacebookProductQuantizer:
    """fastText's ProductQuantizer (src/productquantizer.{h,cc}) data
    layout: header int32s dim/nsubq/dsub/lastdsub + a flat [dim * 256]
    f32 centroid vector; subquantizer ``m``'s centroid ``i`` lives at
    (m * 256 + i) * dsub, except the last subquantizer which packs its
    (possibly shorter) lastdsub-wide centroids at
    m * 256 * dsub + i * lastdsub."""

    KSUB = 256

    def __init__(self, dim, dsub, nsubq, lastdsub, centroids):
        self.dim = int(dim)
        self.dsub = int(dsub)
        self.nsubq = int(nsubq)
        self.lastdsub = int(lastdsub)
        self.centroids = np.asarray(centroids, np.float32).reshape(-1)
        assert self.centroids.size == self.dim * self.KSUB

    @staticmethod
    def read(f) -> "FacebookProductQuantizer":
        dim, nsubq, dsub, lastdsub = struct.unpack("<4i", f.read(16))
        cents = np.frombuffer(
            f.read(dim * FacebookProductQuantizer.KSUB * 4), np.float32
        ).copy()
        return FacebookProductQuantizer(dim, dsub, nsubq, lastdsub, cents)

    def write(self, f) -> None:
        f.write(
            struct.pack("<4i", self.dim, self.nsubq, self.dsub, self.lastdsub)
        )
        f.write(np.ascontiguousarray(self.centroids, np.float32).tobytes())

    def codebook(self, m: int) -> np.ndarray:
        """[256, d_m] centroid table of subquantizer ``m``."""
        off = m * self.KSUB * self.dsub
        d = self.lastdsub if m == self.nsubq - 1 else self.dsub
        return self.centroids[off : off + self.KSUB * d].reshape(self.KSUB, d)

    def decode(self, codes: np.ndarray) -> np.ndarray:
        """codes [rows, nsubq] u8 -> [rows, dim] f32."""
        return np.concatenate(
            [self.codebook(m)[codes[:, m]] for m in range(self.nsubq)], axis=1
        )

    def encode(self, data: np.ndarray) -> np.ndarray:
        """Nearest-centroid codes [rows, nsubq] for [rows, dim] data."""
        out = np.zeros((len(data), self.nsubq), np.uint8)
        lo = 0
        for m in range(self.nsubq):
            C = self.codebook(m)
            X = data[:, lo : lo + C.shape[1]]
            d2 = (C * C).sum(1)[None, :] - 2.0 * (X @ C.T)
            out[:, m] = np.argmin(d2, axis=1).astype(np.uint8)
            lo += C.shape[1]
        return out

    @staticmethod
    def train(
        data: np.ndarray, dsub: int = 2, n_iters: int = 12, seed: int = 0
    ) -> "FacebookProductQuantizer":
        dim = data.shape[1]
        nsubq, lastdsub = divmod(dim, dsub)
        if lastdsub == 0:
            lastdsub = dsub
        else:
            nsubq += 1
        pq = FacebookProductQuantizer(
            dim, dsub, nsubq, lastdsub, np.zeros((dim * 256,), np.float32)
        )
        rng = np.random.default_rng(seed)
        lo = 0
        for m in range(nsubq):
            d = lastdsub if m == nsubq - 1 else dsub
            C = _kmeans(
                np.ascontiguousarray(data[:, lo : lo + d]), pq.KSUB,
                n_iters, rng,
            )
            off = m * pq.KSUB * dsub
            pq.centroids[off : off + pq.KSUB * d] = C.reshape(-1)
            lo += d
        return pq


def _kmeans(X: np.ndarray, k: int, n_iters: int, rng) -> np.ndarray:
    """Plain k-means, returns [k, d] centroids (short inputs pad with
    duplicates so every code decodes to something sane)."""
    C = X[rng.choice(len(X), size=min(k, len(X)), replace=False)].astype(
        np.float32
    )
    if len(C) < k:
        C = np.concatenate([C, C[rng.integers(0, len(C), k - len(C))]])
    C = C.copy()
    for _ in range(n_iters):
        d2 = (C * C).sum(1)[None, :] - 2.0 * (X @ C.T)
        a = np.argmin(d2, axis=1)
        for j in range(k):
            m = a == j
            if m.any():
                C[j] = X[m].mean(axis=0)
    return C


class FastTextModel:
    """A parsed fastText .bin model (non-quantized input matrix)."""

    def __init__(self, words, word_count, dim, bucket, minn, maxn, input_matrix):
        self.words = words
        self.word_index = {w: i for i, w in enumerate(words)}
        self.nwords = word_count
        self.dim = dim
        self.bucket = bucket
        self.minn = minn
        self.maxn = maxn
        self.input_matrix = input_matrix  # [nwords + bucket, dim]

    @staticmethod
    def load(path):
        """Parse a fastText model file.  Returns a ``FastTextModel`` for
        dense .bin files or a ``FacebookQuantizedModel`` for
        facebook-quantized .ftz files (same duck-typed surface) — the
        reference consumes both through the fasttext package
        (vectorian/embedding/token/fasttext.py:63-74)."""
        with open(path, "rb") as f:
            magic, version = struct.unpack("<ii", f.read(8))
            if magic != FASTTEXT_MAGIC:
                raise ValueError(f"{path}: not a fastText model (magic {magic})")
            # args (fasttext/src/args.cc::load order)
            (dim, ws, epoch, min_count, neg, word_ngrams_n, loss, model,
             bucket, minn, maxn, lr_update_rate) = struct.unpack("<12i", f.read(48))
            (t,) = struct.unpack("<d", f.read(8))
            # dictionary
            size, nwords, nlabels = struct.unpack("<3i", f.read(12))
            ntokens, pruneidx_size = struct.unpack("<2q", f.read(16))
            words = []
            for _ in range(size):
                chars = bytearray()
                while True:
                    c = f.read(1)
                    if c == b"\x00":
                        break
                    chars.extend(c)
                words.append(chars.decode("utf-8", errors="replace"))
                _count = struct.unpack("<q", f.read(8))[0]
                _type = struct.unpack("<b", f.read(1))[0]
            # pruneidx: original ngram hash id -> compacted input-matrix
            # row (Dictionary::save pairs); -1 size = unpruned sentinel
            pruneidx = None if pruneidx_size < 0 else {}
            for _ in range(max(pruneidx_size, 0)):
                a, b = struct.unpack("<2i", f.read(8))
                pruneidx[a] = b
            # input matrix
            (quant,) = struct.unpack("<b", f.read(1))
            if quant:
                # facebook-quantized (.ftz): QuantMatrix::load layout
                (qnorm,) = struct.unpack("<b", f.read(1))
                m, n = struct.unpack("<2q", f.read(16))
                (codesize,) = struct.unpack("<i", f.read(4))
                codes = np.frombuffer(f.read(codesize), np.uint8).copy()
                pq = FacebookProductQuantizer.read(f)
                norm_pq = norm_codes = None
                if qnorm:
                    norm_codes = np.frombuffer(f.read(m), np.uint8).copy()
                    norm_pq = FacebookProductQuantizer.read(f)
                return FacebookQuantizedModel(
                    words[:nwords], dim, bucket, minn, maxn,
                    pq, codes.reshape(m, pq.nsubq),
                    norm_pq=norm_pq, norm_codes=norm_codes,
                    pruneidx=pruneidx,
                )
            m, n = struct.unpack("<2q", f.read(16))
            data = np.frombuffer(f.read(m * n * 4), dtype=np.float32).reshape(m, n)
        return FastTextModel(
            words[:nwords], nwords, dim, bucket, minn, maxn, data.copy()
        )

    def subword_ids(self, word: str) -> List[int]:
        ids = []
        wi = self.word_index.get(word)
        if wi is not None and wi < self.nwords:
            ids.append(wi)
        if word != EOS and self.maxn > 0:
            for ng in word_ngrams(word, self.minn, self.maxn):
                h = fnv1a_hash(ng.encode("utf-8"))
                ids.append(self.nwords + (h % self.bucket))
        return ids

    def word_vector(self, word: str) -> np.ndarray:
        """Mean of subword rows (fastText getWordVector semantics)."""
        ids = self.subword_ids(word)
        if not ids:
            return np.zeros((self.dim,), np.float32)
        return self.input_matrix[ids].mean(axis=0)

    def save(self, path) -> None:
        """Write a standard dense fastText .bin (FastText::saveModel
        layout; the output matrix is a zero block — this package and
        upstream inference never read it)."""
        with open(path, "wb") as f:
            f.write(struct.pack("<2i", FASTTEXT_MAGIC, 12))
            _write_args(f, self.dim, self.bucket, self.minn, self.maxn)
            _write_dictionary(f, self.words)
            f.write(struct.pack("<b", 0))  # input not quantized
            m, n = self.input_matrix.shape
            f.write(struct.pack("<2q", m, n))
            f.write(
                np.ascontiguousarray(self.input_matrix, np.float32).tobytes()
            )
            f.write(struct.pack("<b", 0))  # output not quantized
            f.write(struct.pack("<2q", self.nwords, self.dim))
            f.write(np.zeros((self.nwords, self.dim), np.float32).tobytes())


class FacebookQuantizedModel:
    """A facebook-quantized fastText model (.ftz / quantized .bin): the
    input matrix lives as PQ codes + codebooks, optionally with separately
    quantized row norms (``-qnorm``) and a pruned ngram dictionary
    (``-cutoff``).  Same duck-typed surface as ``FastTextModel``; rows
    decode on demand (a 2M-bucket cc model would be GBs dense).  The
    reference loads these via fasttext's own loader
    (vectorian/embedding/token/fasttext.py:15-46, 63-74)."""

    def __init__(self, words, dim, bucket, minn, maxn, pq, codes,
                 norm_pq=None, norm_codes=None, pruneidx=None):
        self.words = list(words)
        self.word_index = {w: i for i, w in enumerate(self.words)}
        self.nwords = len(self.words)
        self.dim = dim
        self.bucket = bucket
        self.minn = minn
        self.maxn = maxn
        self.pq = pq
        self.codes = codes  # [rows, nsubq] u8
        self.norm_pq = norm_pq
        self.norm_codes = norm_codes
        self.pruneidx = pruneidx  # {orig ngram id -> compact row} or None

    def subword_ids(self, word: str) -> List[int]:
        """Like FastTextModel.subword_ids, plus the pruned-dictionary
        remap: ngram rows surviving the quantization cutoff are compacted
        and addressed through pruneidx; pruned-away ngrams drop out
        (fastText Dictionary::pushHash)."""
        ids = []
        wi = self.word_index.get(word)
        if wi is not None:
            ids.append(wi)
        if word != EOS and self.maxn > 0:
            for ng in word_ngrams(word, self.minn, self.maxn):
                h = fnv1a_hash(ng.encode("utf-8")) % self.bucket
                if self.pruneidx is not None:
                    h = self.pruneidx.get(h, -1)
                    if h < 0:
                        continue
                ids.append(self.nwords + h)
        return ids

    def decode_rows(self, ids) -> np.ndarray:
        rows = self.pq.decode(self.codes[np.asarray(ids, np.int64)])
        if self.norm_pq is not None:
            norms = self.norm_pq.codebook(0)[
                self.norm_codes[np.asarray(ids, np.int64)], 0
            ]
            rows = rows * norms[:, None]
        return rows.astype(np.float32)

    def word_vector(self, word: str) -> np.ndarray:
        ids = self.subword_ids(word)
        if not ids:
            return np.zeros((self.dim,), np.float32)
        return self.decode_rows(ids).mean(axis=0)

    def save(self, path) -> None:
        """Write a .ftz (FastText::saveModel with quant_=true)."""
        with open(path, "wb") as f:
            f.write(struct.pack("<2i", FASTTEXT_MAGIC, 12))
            _write_args(f, self.dim, self.bucket, self.minn, self.maxn)
            _write_dictionary(f, self.words, pruneidx=self.pruneidx)
            f.write(struct.pack("<2b", 1, 1 if self.norm_pq is not None else 0))
            m, nsubq = self.codes.shape
            f.write(struct.pack("<2q", m, self.dim))
            f.write(struct.pack("<i", m * nsubq))
            f.write(np.ascontiguousarray(self.codes, np.uint8).tobytes())
            self.pq.write(f)
            if self.norm_pq is not None:
                f.write(
                    np.ascontiguousarray(self.norm_codes, np.uint8).tobytes()
                )
                self.norm_pq.write(f)
            f.write(struct.pack("<b", 0))  # output not quantized
            f.write(struct.pack("<2q", self.nwords, self.dim))
            f.write(np.zeros((self.nwords, self.dim), np.float32).tobytes())


def quantize_facebook(
    model: FastTextModel,
    dsub: int = 2,
    qnorm: bool = True,
    n_iters: int = 12,
    seed: int = 0,
) -> FacebookQuantizedModel:
    """PQ-quantize a dense model with fastText's own scheme (``quantize``
    in src/fasttext.cc): optionally split each row into its L2 norm (a
    separate 1-d 256-centroid quantizer) and PQ-code the normalized row
    with dsub-wide subquantizers.  The result round-trips through
    ``FacebookQuantizedModel.save`` as a standard .ftz."""
    data = np.asarray(model.input_matrix, np.float32).copy()
    norm_pq = norm_codes = None
    if qnorm:
        norms = np.linalg.norm(data, axis=1)
        safe = np.where(norms > 0, norms, 1.0)
        data = data / safe[:, None]
        norm_pq = FacebookProductQuantizer.train(
            norms[:, None].astype(np.float32), dsub=1, n_iters=n_iters,
            seed=seed,
        )
        norm_codes = norm_pq.encode(norms[:, None].astype(np.float32))[:, 0]
    pq = FacebookProductQuantizer.train(
        data, dsub=dsub, n_iters=n_iters, seed=seed
    )
    codes = pq.encode(data)
    return FacebookQuantizedModel(
        model.words, model.dim, model.bucket, model.minn, model.maxn,
        pq, codes, norm_pq=norm_pq, norm_codes=norm_codes,
    )


class FastTextEncoder:
    """Encoder with the StaticEmbeddingEncoder interface but OOV-capable."""

    def __init__(self, name: str, model: FastTextModel, normalizer=None):
        self._name = name
        self._model = model
        self._normalizer = normalizer
        self._cache = {}

    @property
    def name(self):
        return self._name

    @property
    def dimension(self):
        return self._model.dim

    def word_vec(self, w: str) -> np.ndarray:
        v = self._cache.get(w)
        if v is None:
            v = self._model.word_vector(w)
            self._cache[w] = v
        return v

    def encode_tokens(self, tokens: Sequence[str]) -> Vectors:
        if hasattr(self._model, "input_matrix"):  # dense model: C++ batch path
            try:
                from vectorian_tpu_torch.native import fasttext_encode_batch

                return Vectors(
                    fasttext_encode_batch(self._model, list(tokens))
                )
            except (ImportError, OSError):
                pass
        out = np.zeros((len(tokens), self._model.dim), np.float32)
        for i, t in enumerate(tokens):
            out[i] = self.word_vec(t)
        return Vectors(out)

    def transform_query(self, vectors):
        return vectors


class PretrainedFastText(StaticEmbedding):
    """cc.LANG.300.bin fastText model (reference fasttext.py:48-74); the
    file must be present locally (zero-egress) at ``path`` or in the cache
    dir as fasttext/cc.<lang>.300.bin.  Facebook product-quantized .ftz
    files load through the same path (FastTextModel.load dispatches on the
    in-file quant flag)."""

    def __init__(self, lang: str, path: Optional[str] = None):
        self._lang = lang
        self._path = (
            Path(path)
            if path
            else cache_home() / "fasttext" / f"cc.{lang}.300.bin"
        )
        self._model = None

    @property
    def name(self):
        return f"fasttext-{self._lang}"

    @property
    def model(self):
        if self._model is None:
            if not self._path.exists():
                raise FileNotFoundError(
                    f"fastText model not found: {self._path} (download "
                    f"cc.{self._lang}.300.bin manually; this environment has "
                    f"no network egress)"
                )
            self._model = FastTextModel.load(self._path)
        return self._model

    def create_encoder(self, normalization=None):
        return FastTextEncoder(self.name, self.model)


def pq_compress(
    matrix: np.ndarray,
    n_subvectors: int = 15,
    n_codes: int = 256,
    n_train: int = 65536,
    n_iters: int = 12,
    seed: int = 0,
):
    """Product-quantize a [rows, dim] matrix: split dim into
    ``n_subvectors`` blocks, k-means each block to ``n_codes`` centroids.
    Returns (codebooks [n_sub, n_codes, d_sub], codes [rows, n_sub] u8).
    ~dim*4/n_subvectors bytes-per-row compression (e.g. 300d f32 -> 15
    bytes, 80x)."""
    rows, dim = matrix.shape
    if dim % n_subvectors:
        raise ValueError(f"dim {dim} not divisible by {n_subvectors}")
    d_sub = dim // n_subvectors
    rng = np.random.default_rng(seed)
    train = matrix[rng.choice(rows, size=min(n_train, rows), replace=False)]
    codebooks = np.zeros((n_subvectors, n_codes, d_sub), np.float32)
    codes = np.zeros((rows, n_subvectors), np.uint8)
    for s in range(n_subvectors):
        X = np.ascontiguousarray(train[:, s * d_sub : (s + 1) * d_sub])
        C = X[rng.choice(len(X), size=min(n_codes, len(X)), replace=False)]
        if len(C) < n_codes:
            C = np.concatenate([C, np.zeros((n_codes - len(C), d_sub), np.float32)])
        for _ in range(n_iters):
            # assign: argmin ||x-c||^2 = argmin (||c||^2 - 2 x.c)
            d2 = (C * C).sum(1)[None, :] - 2.0 * (X @ C.T)
            a = np.argmin(d2, axis=1)
            for k in range(n_codes):
                m = a == k
                if m.any():
                    C[k] = X[m].mean(axis=0)
        codebooks[s] = C
        # encode all rows in chunks
        full = matrix[:, s * d_sub : (s + 1) * d_sub]
        for lo in range(0, rows, 262144):
            Xc = full[lo : lo + 262144]
            d2 = (C * C).sum(1)[None, :] - 2.0 * (Xc @ C.T)
            codes[lo : lo + 262144, s] = np.argmin(d2, axis=1).astype(np.uint8)
    return codebooks, codes


class QuantizedFastTextModel:
    """A product-quantized fastText model: the [nwords + bucket, dim] input
    matrix stored as PQ codes + codebooks (the package-free, device-friendly
    equivalent of compress_fasttext, reference fasttext.py:15-45 — decoding
    a row is one small gather + concat)."""

    def __init__(self, words, dim, bucket, minn, maxn, codebooks, codes):
        self.words = list(words)
        self.word_index = {w: i for i, w in enumerate(self.words)}
        self.nwords = len(self.words)
        self.dim = dim
        self.bucket = bucket
        self.minn = minn
        self.maxn = maxn
        self.codebooks = codebooks  # [n_sub, n_codes, d_sub]
        self.codes = codes  # [rows, n_sub] u8

    @staticmethod
    def compress(model: FastTextModel, **pq_kwargs) -> "QuantizedFastTextModel":
        codebooks, codes = pq_compress(model.input_matrix, **pq_kwargs)
        return QuantizedFastTextModel(
            model.words, model.dim, model.bucket, model.minn, model.maxn,
            codebooks, codes,
        )

    def decode_rows(self, ids) -> np.ndarray:
        """[k, dim] decoded rows: per subvector, one codebook gather."""
        ids = np.asarray(ids)
        parts = [
            self.codebooks[s][self.codes[ids, s]]
            for s in range(self.codebooks.shape[0])
        ]
        return np.concatenate(parts, axis=-1)

    def word_vector(self, word: str) -> np.ndarray:
        ids = []
        wi = self.word_index.get(word)
        if wi is not None:
            ids.append(wi)
        if word != EOS and self.maxn > 0:
            for ng in word_ngrams(word, self.minn, self.maxn):
                h = fnv1a_hash(ng.encode("utf-8"))
                ids.append(self.nwords + (h % self.bucket))
        if not ids:
            return np.zeros((self.dim,), np.float32)
        return self.decode_rows(np.asarray(ids)).mean(axis=0)

    def save(self, path):
        import json

        np.savez_compressed(
            path,
            words=np.asarray(self.words, dtype=object),
            meta=np.asarray(
                [json.dumps({"dim": self.dim, "bucket": self.bucket,
                             "minn": self.minn, "maxn": self.maxn})]
            ),
            codebooks=self.codebooks,
            codes=self.codes,
        )

    @staticmethod
    def load(path) -> "QuantizedFastTextModel":
        import json

        z = np.load(path, allow_pickle=True)
        meta = json.loads(str(z["meta"][0]))
        return QuantizedFastTextModel(
            [str(w) for w in z["words"]],
            meta["dim"], meta["bucket"], meta["minn"], meta["maxn"],
            z["codebooks"], z["codes"],
        )


class QuantizedFastText(StaticEmbedding):
    """Product-quantized fastText embedding (native equivalent of
    compress_fasttext models): load a ``.npz`` produced by
    ``QuantizedFastText.compress`` (~80x smaller than the .bin), still
    OOV-capable via hashed subwords."""

    def __init__(self, path, name: Optional[str] = None):
        self._path = Path(path)
        self._name = name or f"quantized-fasttext-{self._path.stem}"
        self._model: Optional[QuantizedFastTextModel] = None

    @staticmethod
    def compress(bin_path, out_path, **pq_kwargs) -> "QuantizedFastText":
        """One-time offline compression of a fastText .bin."""
        model = FastTextModel.load(bin_path)
        q = QuantizedFastTextModel.compress(model, **pq_kwargs)
        q.save(out_path)
        return QuantizedFastText(out_path)

    @property
    def name(self):
        return self._name

    @property
    def model(self) -> QuantizedFastTextModel:
        if self._model is None:
            self._model = QuantizedFastTextModel.load(self._path)
        return self._model

    def create_encoder(self, normalization=None):
        return FastTextEncoder(self.name, self.model)


def convert_compress_fasttext(kv, out_path=None, name=None, **pq_kwargs):
    """Convert a (compress_)fasttext keyed-vectors object into a native
    ``FastTextModel`` — and optionally a ``QuantizedFastText`` .npz.

    Duck-typed on the gensim ``FastTextKeyedVectors`` attribute surface
    (which compress_fasttext subclasses): ``index_to_key``,
    ``vector_size``, ``min_n``/``max_n``, ``bucket``, ``vectors_ngrams``
    [bucket, dim], and either ``vectors_vocab`` (raw per-word input rows)
    or ``vectors`` (final word vectors).  When only final vectors exist
    (compress_fasttext drops the vocab rows in its published models), the
    raw row is reconstructed exactly from

        final = mean([row_w] + ngram_rows)
          =>  row_w = (k+1) * final - sum(ngram_rows)

    so in-vocab lookups reproduce the source vectors bit-for-bit in exact
    arithmetic and OOV words keep the pure ngram-mean semantics.  The
    subword inventory/hash matches (gensim mirrors fastText's FNV-1a and
    computeSubwords).

    With ``out_path`` the dense model is additionally PQ-compressed to the
    native .npz and a ``QuantizedFastText`` is returned; otherwise the
    dense ``FastTextModel``.  Reference seam: embedding/token/fasttext.py
    :15-45 (CompressedFastTextVectors.load)."""
    words = list(kv.index_to_key)
    dim = int(kv.vector_size)
    bucket = int(kv.bucket)
    minn = int(kv.min_n)
    maxn = int(kv.max_n)

    def materialize(m, n_rows):
        try:
            arr = np.asarray(m, np.float32)
            if arr.ndim == 2:
                return arr
        except Exception:
            pass
        # compressed matrix types expose row __getitem__ only
        return np.stack(
            [np.asarray(m[i], np.float32) for i in range(n_rows)]
        )

    ngrams = materialize(kv.vectors_ngrams, bucket)
    vocab_rows = getattr(kv, "vectors_vocab", None)
    if vocab_rows is not None:
        rows = materialize(vocab_rows, len(words))
    else:
        finals = materialize(kv.vectors, len(words))
        rows = np.zeros((len(words), dim), np.float32)
        for i, w in enumerate(words):
            ids = [
                fnv1a_hash(ng.encode("utf-8")) % bucket
                for ng in (word_ngrams(w, minn, maxn) if w != EOS else [])
            ]
            k = len(ids)
            s = ngrams[ids].sum(axis=0) if k else 0.0
            rows[i] = (k + 1) * finals[i] - s
    model = FastTextModel(
        words, len(words), dim, bucket, minn, maxn,
        np.vstack([rows, ngrams]).astype(np.float32),
    )
    if out_path is None:
        return model
    q = QuantizedFastTextModel.compress(model, **pq_kwargs)
    q.save(out_path)
    return QuantizedFastText(out_path, name=name)


class CompressedFastTextVectors(StaticEmbedding):
    """compress_fasttext product-quantized models (reference
    fasttext.py:15-45).  With the compress_fasttext package installed the
    file loads directly; without it, one-time conversion via
    ``convert_compress_fasttext`` (run where the package exists) produces
    a native .npz this package loads standalone."""

    def __init__(self, path):
        self._path = Path(path)

    @property
    def name(self):
        return f"compressed-fasttext-{self._path.stem}"

    def create_encoder(self, normalization=None):
        try:
            import compress_fasttext
        except ImportError as e:
            raise ImportError(
                "CompressedFastTextVectors requires the compress_fasttext "
                "package; install it or use PretrainedFastText with a .bin "
                "model"
            ) from e
        kv = compress_fasttext.models.CompressedFastTextKeyedVectors.load(
            str(self._path)
        )

        class _Enc:
            name = self.name
            dimension = kv.vector_size

            def word_vec(self, w):
                return np.asarray(kv[w], np.float32)

            def encode_tokens(self, tokens):
                return Vectors(
                    np.stack([np.asarray(kv[t], np.float32) for t in tokens])
                )

            def transform_query(self, vectors):
                return vectors

        return _Enc()
