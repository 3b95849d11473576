"""ctypes bindings for the native host library (csrc/vectorian_native.cpp,
the port's own copy of the reference package's native/vectorian_native.cpp).

The port builds the library at first use: ``g++`` compiles the source (with
native/Makefile's flags) into vectorian_tpu_torch/_build/, named by a hash
of the source and the flags.  The build holds an exclusive lock on a file there and
writes a temporary name that it then renames into place, so processes that
start together all load a whole library: one builds, the others wait and
load its result.  Every entry point has a pure-python fallback, so the
package works without a compiler (``available()`` is then False, as it is
when ``VECTORIAN_NO_NATIVE`` is set) — the native paths are the
reference's C++-core equivalents for host-side byte-crunching (fastText
ngram encoding, vocabulary interning, the traceback)."""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

_LIB: Optional[ctypes.CDLL] = None
_LIB_TRIED = False

_PKG = Path(__file__).resolve().parent
BUILD_DIR = _PKG / "_build"
SOURCE = _PKG / "csrc" / "vectorian_native.cpp"
# native/Makefile's optimized build
CXXFLAGS = (
    "-O3", "-march=native", "-fPIC", "-std=c++17", "-ffp-contract=off",
    "-pthread", "-shared",
)


def library_path() -> Path:
    """Where the build of the checkout's source with CXXFLAGS lives."""
    digest = hashlib.sha256(
        SOURCE.read_bytes() + " ".join(CXXFLAGS).encode()
    ).hexdigest()[:16]
    return BUILD_DIR / f"libvectorian_native_{digest}.so"


def _build() -> Path:
    """The library, compiled first if this source has no build yet (under
    an exclusive lock; the compiler writes a temporary name, renamed into
    place when whole)."""
    out = library_path()
    if out.exists():
        return out
    cxx = shutil.which(os.environ.get("CXX", "g++"))
    if cxx is None:
        raise FileNotFoundError("no C++ compiler for the native library")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "native.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not out.exists():  # built by another process while this one waited
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            try:
                subprocess.run(
                    [cxx, *CXXFLAGS, "-o", str(tmp), str(SOURCE)],
                    check=True, capture_output=True, timeout=300,
                )
                os.replace(tmp, out)
            finally:
                tmp.unlink(missing_ok=True)
    return out


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.vn_ft_hash.restype = ctypes.c_uint32
    lib.vn_ft_hash.argtypes = [ctypes.c_char_p, ctypes.c_int64]
    lib.vn_ft_encode_batch.restype = None
    lib.vn_lexicon_new.restype = ctypes.c_void_p
    lib.vn_lexicon_free.argtypes = [ctypes.c_void_p]
    lib.vn_lexicon_size.restype = ctypes.c_int64
    lib.vn_lexicon_size.argtypes = [ctypes.c_void_p]
    lib.vn_lexicon_get.restype = ctypes.c_int64
    lib.vn_pack_fill.restype = None
    if hasattr(lib, "vn_emd_batch"):
        lib.vn_emd_batch.restype = None
    return lib


def _load() -> Optional[ctypes.CDLL]:
    global _LIB, _LIB_TRIED
    if _LIB is not None or _LIB_TRIED:
        return _LIB
    _LIB_TRIED = True
    if os.environ.get("VECTORIAN_NO_NATIVE"):
        return None
    try:
        _LIB = _bind(ctypes.CDLL(str(_build())))
    except (OSError, subprocess.SubprocessError, AttributeError):
        # no source or compiler, a failed build, or a library without
        # the entry points: the python fallbacks serve
        return None
    return _LIB


def available() -> bool:
    return _load() is not None


def _pack_words(words: Sequence[str]):
    blobs = [w.encode("utf-8") for w in words]
    offsets = np.zeros((len(blobs) + 1,), np.int64)
    np.cumsum([len(b) for b in blobs], out=offsets[1:])
    return b"".join(blobs), offsets


def fasttext_encode_batch(model, words: Sequence[str]) -> np.ndarray:
    """Batch fastText word vectors via the native ngram encoder.
    ``model``: vectorian_tpu_torch.embedding.fasttext.FastTextModel."""
    lib = _load()
    if lib is None:
        raise ImportError("native library unavailable")
    data, offsets = _pack_words(words)
    word_rows = np.asarray(
        [model.word_index.get(w, -1) for w in words], np.int64
    )
    mat = np.ascontiguousarray(model.input_matrix, np.float32)
    out = np.zeros((len(words), model.dim), np.float32)
    lib.vn_ft_encode_batch(
        ctypes.c_char_p(data),
        offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        word_rows.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        ctypes.c_int64(len(words)),
        mat.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        ctypes.c_int64(mat.shape[0]),
        ctypes.c_int64(mat.shape[1]),
        ctypes.c_int64(model.nwords),
        ctypes.c_int64(model.bucket),
        ctypes.c_int32(model.minn),
        ctypes.c_int32(model.maxn),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
    )
    return out


def pack_fill(flat_tok, flat_pos, flat_tag, starts, lens, cap: int):
    """Fill padded [n, cap] slice matrices from flat corpus arrays via the
    C++ row-memcpy loop (reference Spans::iterate, document.h:147-169).
    Returns (tok, pos, tag); raises ImportError when the lib is missing."""
    lib = _load()
    if lib is None:
        raise ImportError("native library unavailable")
    n = len(starts)
    flat_tok = np.ascontiguousarray(flat_tok, np.int32)
    flat_pos = np.ascontiguousarray(flat_pos, np.int8)
    flat_tag = np.ascontiguousarray(flat_tag, np.int16)
    starts = np.ascontiguousarray(starts, np.int64)
    lens = np.ascontiguousarray(lens, np.int32)
    tok = np.zeros((n, cap), np.int32)
    pos = np.zeros((n, cap), np.int8)
    tag = np.zeros((n, cap), np.int16)
    lib.vn_pack_fill(
        flat_tok.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        flat_pos.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
        flat_tag.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
        starts.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        ctypes.c_int64(n),
        ctypes.c_int64(cap),
        tok.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        pos.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
        tag.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
    )
    return tok, pos, tag


def emd(w1: np.ndarray, w2: np.ndarray, C: np.ndarray):
    """Exact balanced transportation solve via the native successive-
    shortest-path solver (native vn_emd); returns (flow [n1, n2] f64,
    cost) or None when the lib is missing / the instance is rejected
    (unbalanced, negative costs, degenerate stall) — callers fall back
    to scipy HiGHS (ops/emd_exact.exact_emd)."""
    lib = _load()
    if lib is None or not hasattr(lib, "vn_emd"):
        return None
    w1 = np.ascontiguousarray(w1, np.float64)
    w2 = np.ascontiguousarray(w2, np.float64)
    C = np.ascontiguousarray(C, np.float64)
    n1, n2 = C.shape
    flow = np.zeros((n1, n2), np.float64)
    cost = ctypes.c_double(0.0)
    rc = lib.vn_emd(
        w1.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        w2.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        C.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        ctypes.c_int64(n1),
        ctypes.c_int64(n2),
        flow.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        ctypes.byref(cost),
    )
    if rc != 0:
        return None
    return flow, float(cost.value)


def emd_batch(problems, n_threads: int = 0):
    """Threaded batch of exact EMD solves (native vn_emd_batch): the
    transport serving batch rescores hundreds of small independent
    (query x candidate) problems per consume round, and the SSP solves
    share nothing — threads partition them.  ``problems``: list of
    (w1 [n1], w2 [n2], C [n1, n2]) float64 triples (variable sizes).
    Returns a list of (flow [n1, n2], cost) | None per problem, or None
    when the lib is unavailable (caller falls back per problem)."""
    lib = _load()
    if lib is None or not hasattr(lib, "vn_emd_batch"):
        return None
    B = len(problems)
    if B == 0:
        return []
    n1s = np.empty((B,), np.int64)
    n2s = np.empty((B,), np.int64)
    a_off = np.empty((B,), np.int64)
    b_off = np.empty((B,), np.int64)
    c_off = np.empty((B,), np.int64)
    ta = tb = tc = 0
    for k, (w1, w2, C) in enumerate(problems):
        n1, n2 = C.shape
        n1s[k], n2s[k] = n1, n2
        a_off[k], b_off[k], c_off[k] = ta, tb, tc
        ta += n1
        tb += n2
        tc += n1 * n2
    a = np.empty((ta,), np.float64)
    b = np.empty((tb,), np.float64)
    c = np.empty((tc,), np.float64)
    for k, (w1, w2, C) in enumerate(problems):
        a[a_off[k] : a_off[k] + n1s[k]] = w1
        b[b_off[k] : b_off[k] + n2s[k]] = w2
        c[c_off[k] : c_off[k] + n1s[k] * n2s[k]] = np.asarray(
            C, np.float64
        ).reshape(-1)
    flow = np.zeros((tc,), np.float64)
    costs = np.zeros((B,), np.float64)
    rcs = np.zeros((B,), np.int32)
    dp = ctypes.POINTER(ctypes.c_double)
    ip = ctypes.POINTER(ctypes.c_int64)
    lib.vn_emd_batch(
        a.ctypes.data_as(dp),
        b.ctypes.data_as(dp),
        c.ctypes.data_as(dp),
        n1s.ctypes.data_as(ip),
        n2s.ctypes.data_as(ip),
        a_off.ctypes.data_as(ip),
        b_off.ctypes.data_as(ip),
        c_off.ctypes.data_as(ip),
        ctypes.c_int64(B),
        ctypes.c_int64(n_threads),
        flow.ctypes.data_as(dp),
        costs.ctypes.data_as(dp),
        rcs.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
    )
    out = []
    for k in range(B):
        if rcs[k] != 0:
            out.append(None)
            continue
        n1, n2 = int(n1s[k]), int(n2s[k])
        out.append(
            (
                flow[c_off[k] : c_off[k] + n1 * n2].reshape(n1, n2),
                float(costs[k]),
            )
        )
    return out


_LOCALITY_CODE = {"local": 0, "global": 1, "semiglobal": 2}


def _tb_common(H, S, len_s, len_t, end_cells):
    H = np.ascontiguousarray(H, np.float32)
    S = np.ascontiguousarray(S, np.float32)
    B, S1, T1 = H.shape
    _, Ls, Lt = S.shape
    ls = np.ascontiguousarray(len_s, np.int32)
    lt = np.ascontiguousarray(len_t, np.int32)
    mapping = np.empty((B, Lt), np.int32)
    if end_cells is not None:
        ec = np.ascontiguousarray(end_cells, np.int32)
        ec_ptr = ec.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))
    else:
        ec = None
        ec_ptr = None
    return H, S, ls, lt, mapping, ec, ec_ptr, B, S1, T1, Ls, Lt


def traceback_affine_batch(
    H, S, len_s, len_t, gaps, locality: str, end_cells=None
):
    """Batched affine-gap DP traceback (bit-exact mirror of
    ops/alignment.traceback, fuzz-tested); returns [B, Lt] mappings or None
    when the native lib is unavailable.  H: [B, S1, T1], S: [B, Ls, Lt]."""
    lib = _load()
    if lib is None or not hasattr(lib, "vn_traceback_affine_batch"):
        return None
    H, S, ls, lt, mapping, ec, ec_ptr, B, S1, T1, Ls, Lt = _tb_common(
        H, S, len_s, len_t, end_cells
    )
    lib.vn_traceback_affine_batch(
        H.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        S.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        ls.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        lt.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        ctypes.c_int64(B),
        ctypes.c_int64(S1),
        ctypes.c_int64(T1),
        ctypes.c_int64(Ls),
        ctypes.c_int64(Lt),
        ctypes.c_double(float(gaps.open_s)),
        ctypes.c_double(float(gaps.extend_s)),
        ctypes.c_double(float(gaps.open_t)),
        ctypes.c_double(float(gaps.extend_t)),
        ctypes.c_int(_LOCALITY_CODE[locality]),
        ec_ptr,
        mapping.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
    )
    return mapping


def traceback_general_batch(
    H, S, len_s, len_t, w_s, w_t, locality: str, end_cells=None
):
    """Batched general-gap DP traceback (mirror of
    ops/alignment.traceback_general); returns [B, Lt] mappings or None."""
    lib = _load()
    if lib is None or not hasattr(lib, "vn_traceback_general_batch"):
        return None
    H, S, ls, lt, mapping, ec, ec_ptr, B, S1, T1, Ls, Lt = _tb_common(
        H, S, len_s, len_t, end_cells
    )
    w_s = np.ascontiguousarray(w_s, np.float32)
    w_t = np.ascontiguousarray(w_t, np.float32)
    lib.vn_traceback_general_batch(
        H.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        S.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        ls.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        lt.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        ctypes.c_int64(B),
        ctypes.c_int64(S1),
        ctypes.c_int64(T1),
        ctypes.c_int64(Ls),
        ctypes.c_int64(Lt),
        w_s.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        w_t.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        ctypes.c_int(_LOCALITY_CODE[locality]),
        ec_ptr,
        mapping.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
    )
    return mapping


class NativeLexicon:
    """String-interning lexicon backed by the C++ library (reference
    vocabulary.h StringStorage/LexiconImpl); drop-in for the hot part of
    vocabulary.Lexicon.

    NOT wired into the production Session: measured ~2.5x SLOWER than the
    python dict path for batch interning (the ctypes string marshalling
    outweighs the arena's win).  Kept as the benchmarked alternative
    backend and exercised by tests."""

    def __init__(self):
        lib = _load()
        if lib is None:
            raise ImportError("native library unavailable")
        self._lib = lib
        self._h = lib.vn_lexicon_new()

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.vn_lexicon_free(self._h)
            self._h = None

    def __len__(self):
        return int(self._lib.vn_lexicon_size(self._h))

    def add_many(self, words: Sequence[str]) -> np.ndarray:
        data, offsets = _pack_words(words)
        out = np.zeros((len(words),), np.int32)
        self._lib.vn_lexicon_add_many(
            ctypes.c_void_p(self._h),
            ctypes.c_char_p(data),
            offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            ctypes.c_int64(len(words)),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        )
        return out

    def lookup_many(self, words: Sequence[str]) -> np.ndarray:
        data, offsets = _pack_words(words)
        out = np.zeros((len(words),), np.int32)
        self._lib.vn_lexicon_lookup_many(
            ctypes.c_void_p(self._h),
            ctypes.c_char_p(data),
            offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            ctypes.c_int64(len(words)),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        )
        return out

    def to_str(self, i: int) -> str:
        n = self._lib.vn_lexicon_get(
            ctypes.c_void_p(self._h), ctypes.c_int64(i), None, 0
        )
        if n < 0:
            raise IndexError(i)
        buf = ctypes.create_string_buffer(int(n))
        self._lib.vn_lexicon_get(
            ctypes.c_void_p(self._h), ctypes.c_int64(i), buf, n
        )
        return buf.raw[:n].decode("utf-8")
