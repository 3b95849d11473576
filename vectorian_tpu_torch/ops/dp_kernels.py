"""Hand-written CUDA kernels of the alignment DP (counterpart of
vectorian_tpu/ops/pallas_dp.py), their plain torch versions and launch
counts.

``affine_dp_scores`` is the corpus-pass scorer: the gather of the stacked
serving table ``[V, Tpad, Q]`` by each slice's token ids fused with the
affine Gotoh DP (csrc/affine_dp.cu).  A CUDA tensor always goes to the
kernel — a build or launch failure raises, nothing falls back; only tensors
on the CPU take the plain version, ``affine_dp_scores_reference`` (the
gather, then the torch scan of ops/alignment.py).

The kernel is built at first use with ``nvcc`` into a shared library with a
plain C interface (loaded with ctypes) under ``vectorian_tpu_torch/_build``,
named by a hash of its source and flags so an edit never loads a stale
build.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional

import torch

from vectorian_tpu_torch.ops.alignment import LOCALITIES, align_scores

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "affine_dp.cu"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
)
# the largest padded needle width the kernel's register rows take
MAX_TPAD = 128

# kernel launches since the last reset (one per launched bucket pass)
LAUNCHES = {"affine_dp": 0}

_lib: Optional[ctypes.CDLL] = None


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the affine DP kernel cannot be built")


def _library_path() -> Path:
    digest = hashlib.sha256(
        SOURCE.read_bytes() + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    return BUILD_DIR / f"libaffine_dp_{digest}.so"


def build(verbose: bool = False) -> Path:
    """Compile csrc/affine_dp.cu (no-op when this source is already built);
    returns the library path.  ``verbose`` adds ``-Xptxas -v`` and returns
    after printing the compiler's register and spill report."""
    out = _library_path()
    if out.exists() and not verbose:
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)]
    if verbose:
        cmd[1:1] = ["-Xptxas", "-v"]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({res.returncode}):\n{res.stdout}\n{res.stderr}"
        )
    if verbose:
        print(res.stderr, end="")
    os.replace(tmp, out)
    return out


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        fn = lib.vt_affine_dp_scores
        fn.restype = ctypes.c_int
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_float, ctypes.c_float, ctypes.c_float,
            ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
        ]
        _lib = lib
    return _lib


def affine_dp_scores_reference(
    table, tokens, len_s, len_t, gaps, locality, max_bytes: int = 1 << 29
):
    """Plain torch version of ``affine_dp_scores``: ``table[tokens]`` and
    the torch scan, chunked over slices so the gathered [c, L, Tpad, Q]
    block stays under ``max_bytes``."""
    n, L = tokens.shape
    _, Tpad, Q = table.shape
    ln1 = torch.clamp_min(len_s, 1)
    out = torch.empty((n, Q), dtype=torch.float32, device=table.device)
    chunk = max(1, max_bytes // max(L * Tpad * Q * 4, 1))
    for c0 in range(0, n, chunk):
        tok = tokens[c0 : c0 + chunk].long()
        c = tok.shape[0]
        S = table[tok]  # [c, L, Tpad, Q]
        S2 = S.permute(0, 3, 1, 2).reshape(c * Q, L, Tpad)
        raw = align_scores(
            S2,
            ln1[c0 : c0 + c].repeat_interleave(Q),
            len_t.repeat(c),
            gaps,
            locality,
        )
        out[c0 : c0 + c] = raw.reshape(c, Q)
    return out


def affine_dp_scores(table, tokens, len_s, len_t, gaps, locality):
    """Raw affine-DP scores [n, Q] f32 of every slice against every query.

    table [V, Tpad, Q] f32 (query q's similarity of vocab row v to its
    needle token j), tokens [n, L] i32 (< V), len_s [n] i32 (clamped to
    >= 1, like the JAX corpus pass), len_t [Q] i32 (1 <= len_t <= Tpad),
    ``gaps`` an AffineGapParams of host floats (passed by value: changing
    them rebuilds and uploads nothing)."""
    if locality not in LOCALITIES:
        raise ValueError(f"unknown locality {locality!r}")
    dev = table.device
    if dev.type == "cpu":
        return affine_dp_scores_reference(
            table, tokens, len_s, len_t, gaps, locality
        )
    if dev.type != "cuda":
        raise ValueError(f"affine_dp_scores: unsupported device {dev}")
    if table.dtype != torch.float32 or table.dim() != 3:
        raise ValueError("table must be a [V, Tpad, Q] float32 tensor")
    if tokens.dtype != torch.int32 or tokens.dim() != 2:
        raise ValueError("tokens must be an [n, L] int32 tensor")
    n, L = tokens.shape
    _, Tpad, Q = table.shape
    if len_s.dtype != torch.int32 or tuple(len_s.shape) != (n,):
        raise ValueError("len_s must be an [n] int32 tensor")
    if len_t.dtype != torch.int32 or tuple(len_t.shape) != (Q,):
        raise ValueError("len_t must be a [Q] int32 tensor")
    for name, t in (("table", table), ("tokens", tokens), ("len_s", len_s),
                    ("len_t", len_t)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, table on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if Tpad > MAX_TPAD:
        raise ValueError(
            f"needles padded to {Tpad} > {MAX_TPAD} tokens exceed the "
            "affine DP kernel's register rows"
        )
    out = torch.empty((n, Q), dtype=torch.float32, device=dev)
    if n == 0:
        return out
    ln1 = torch.clamp_min(len_s, 1)
    lib = _load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.vt_affine_dp_scores(
            table.data_ptr(), tokens.data_ptr(), ln1.data_ptr(),
            len_t.data_ptr(), out.data_ptr(), n, L, Tpad, Q,
            float(gaps[0]), float(gaps[1]), float(gaps[2]), float(gaps[3]),
            LOCALITIES.index(locality), stream,
        )
    if rc != 0:
        raise RuntimeError(f"affine_dp kernel launch failed (error {rc})")
    LAUNCHES["affine_dp"] += 1
    return out
