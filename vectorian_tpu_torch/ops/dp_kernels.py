"""Hand-written CUDA kernels of the alignment DP (counterpart of
vectorian_tpu/ops/pallas_dp.py), their plain torch versions and launch
counts.

- ``affine_dp_scores``: the affine corpus pass, the gather of the stacked
  serving table ``[V, Tpad, Q]`` (f32, or a quantized bf16 / int8 ranking
  table, read in its own type from a query-major copy, packed rows of 8
  columns a load: ``affine_kernel_table``) by each slice's token ids fused
  with the Gotoh DP
  (csrc/affine_dp.cu; replaces ``pallas_align_scores_multi_nt``).  Routes
  (``affine_launch_plan``): "registers" (one thread a problem, its rows in
  registers) for needles up to AFFINE_REG_MAX_T; past it "wide_regs" (one
  warp a problem, its columns in the lanes' registers) up to
  AFFINE_WIDE_REGS_MAX_T, and "wide_shared" / "wide_scratch" (one warp a
  problem, its rows in shared memory or a scratch buffer) past that: any
  width is served.  A launch is split by each needle's own width
  (``needle_split``, ``affine_table`` once a corpus pass): the short
  needles of a batch padded to a long one take the register route, only
  the long ones a wide route.
- ``affine_dp_scores_rows``: the affine score-only rescore of (bucket row,
  query slot) problems, each reading its similarity rows from the stacked
  ``[slots * V, Tmax]`` plan table (csrc/affine_dp.cu; replaces
  ``pallas_align_scores`` on the gathered block), on the same routes
  ("rows_registers", ...);
  ``affine_dp_scores_flat`` runs the same kernel on a flat [B, L, T] batch.
- ``affine_dp_scores_dense``: the affine DP of a dense similarity block
  ``[c, L, Tpad, Q]`` f32 (a contextual or modifier-tree chunk's evaluated
  block, read where the metric GEMM wrote it; replaces
  ``pallas_align_scores_multi_nt`` on the contextual batch's block):
  "lanes" (a group of lanes a problem) for launches of few problems, else
  the gather entry's routes (``affine_dense_plan``).
- ``wsb_dp_scores``: the general-gap (Waterman-Smith-Beyer) corpus pass,
  gather fused as above, any of the three table types (csrc/wsb_dp.cu;
  replaces the corpus-pass use of ``pallas_align_scores_general``).
  Five routes (``wsb_launch_plan``):
  "registers" (one lane a needle column, column histories in registers)
  for buckets up to WSB_REG_MAX_L tokens and needles up to WSB_REG_MAX_T
  (gap models whose closure is non-negative), "long" (the same lane
  groups, column histories in shared memory, rows in blocks) for buckets
  up to WSB_LONG_MAX_L against the same needles and gap models, "wide"
  (one warp a problem, a lane's columns in register slots, the column
  histories in shared memory) for needles of WSB_REG_MAX_T + 1 to
  WSB_WIDE_MAX_T columns where they fit (``wsb_wide_shape``), else one
  thread a problem with its rows in "shared" memory or in a "scratch"
  buffer.  A launch is split by each needle's own width (``wsb_table``,
  once a corpus pass): the short needles of a batch padded to a long one
  take the lane routes over their own columns, only the long ones "wide".
- ``wsb_dp_scores_rows``: the WSB score-only rescore of (bucket row, query
  slot) problems, on the same five routes ("rows_registers", ...);
  ``wsb_dp_scores_flat`` runs it on a flat [B, L, T] batch (both replace
  ``pallas_align_scores_general``).
- ``wsb_dp_scores_dense``: the WSB DP of a dense ``[c, L, T, Q]`` f32
  block, on the gather entry's five routes.

The four gather and row-gather entries also read the tag-weighted block
(``tags``, a ``TagBlock``; f32 tables only): each similarity becomes the JAX
package's tag-weighted value (ops/search.py ``_apply_tag_weights``) before
the DP step that consumes it, inside the kernel (``tag_weighted`` is the
plain version of that rewrite); the thread-a-problem routes read the
block's weight table (``tag_table``, made once a corpus pass).

A CUDA tensor always goes to the kernel — a build or launch failure raises,
nothing falls back; only tensors on the CPU take the plain version (the
``*_reference`` function beside each wrapper: the torch scans of
ops/alignment.py).

Each source is built at first use with ``nvcc`` into a shared library with a
plain C interface (loaded with ctypes) under ``vectorian_tpu_torch/_build``,
named by a hash of its source and flags so an edit never loads a stale
build.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path
from typing import Dict, NamedTuple, Optional

import torch

from vectorian_tpu_torch.ops.alignment import (
    LOCALITIES,
    NEG,
    align_scores,
    align_scores_general,
)

_PKG = Path(__file__).resolve().parent.parent
SOURCES = {
    "affine_dp": _PKG / "csrc" / "affine_dp.cu",
    "wsb_dp": _PKG / "csrc" / "wsb_dp.cu",
}
BUILD_DIR = _PKG / "_build"
# --split-compile 0: nvcc spreads a source's kernels over the host's cores
# (about half the build time; chip_smoke.py --build-ab, PERF.md)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-shared", "-Xcompiler", "-fPIC", "--split-compile", "0",
)
# the widest padded needle the affine register route takes (its templates
# end at T1P = 65: past 64 the wide route was as fast or faster, and T1P =
# 129 spilled); wider needles take the wide route, one warp a problem with
# its rows in shared memory while one block of AFFINE_WIDE_WARPS warps fits
# there (up to Tpad 1,815), else in a scratch buffer (csrc/affine_dp.cu
# WIDE_WARPS)
AFFINE_REG_MAX_T = 64
# the register-resident wide route ("wide_regs"): one warp a problem, a
# lane's AFFINE_WIDE_CPL columns in its registers (csrc/affine_dp.cu
# WIDE_CPL_MAX), so needles up to 32 x 16 = 512 columns; past that the
# shared / scratch rows
AFFINE_WIDE_CPL = (4, 8, 16)
AFFINE_WIDE_REGS_MAX_T = 32 * AFFINE_WIDE_CPL[-1]
AFFINE_WIDE_REGS_WARPS = 4
# the dense entry's register route ends at 32 columns where a row's columns
# are Q floats apart (Q > 1: its T1P = 65 templates spilled); float4 rows
# (Q = 1, Tpad % 4 == 0) go to AFFINE_REG_MAX_T
AFFINE_DENSE_REG_MAX_T = 32
AFFINE_REG_THREADS = 128
AFFINE_WIDE_WARPS = 8
# shared memory of an H100 SM (1 KB of it reserved a resident block) and
# the most one block can have
SM_SMEM = 228 * 1024
WSB_SMEM_MAX = 227 * 1024
# WSB rows of the thread-a-problem body stay in shared memory while at least
# WSB_MIN_RESIDENT threads an SM fit there, or while the launch's problems
# fit in one wave of resident blocks on WSB_SMS SMs; past both they live in
# a device scratch buffer sized to the threads in flight, at most
# WSB_SCRATCH_MAX bytes (the affine wide route's scratch has the same cap).
# Measured on an H100 (chip_smoke.py phase 3's ``wsb_shared_crossover`` and
# long-shape turns, PERF.md): shared rows ran 0.73x scratch's time at 352
# threads resident, 1.006x at 192 and 1.19-2.71x at 96 and fewer over
# 65,536 problems (several waves: scratch keeps more threads in flight),
# but 0.59-0.86x at 96 and 32 resident where every block fit in one wave.
WSB_MIN_RESIDENT = 256
WSB_SMS = 132
WSB_SCRATCH_MAX = 256 << 20
WSB_SCRATCH_THREADS = 64
# the register route of the WSB entries: bucket capacities and padded
# needle widths its templates take (csrc/wsb_dp.cu), and its block size
WSB_REG_MAX_L = 32
WSB_REG_MAX_T = 32
WSB_REG_THREADS = 128
# the long route (csrc/wsb_dp.cu LONG_MAX_L, LONG_R): bucket capacities up
# to 256 against the register route's needles; DP rows a row block
WSB_LONG_MAX_L = 256
WSB_LONG_R = 8
# the wide route (csrc/wsb_dp.cu WIDE_MAX_T, WIDE_XP): padded needles of 33
# to 512 columns, 2, 4, 8 or 16 register slots a lane; it takes a shape
# while a warp's column history (L x T floats) and C row leave at least
# WSB_WIDE_MIN_WARPS warps resident an SM
WSB_WIDE_MAX_T = 512
WSB_WIDE_XP = 36
WSB_WIDE_MIN_WARPS = 4
# the affine dense entry's lane route (csrc/affine_dp.cu "dense_lanes", a
# group of lanes a problem, a lane a column): buckets and padded needles up
# to 32, for launches of at most AFFINE_DENSE_LANES_MAX_PROBLEMS problems.
# Timed against a thread a problem on the device (chip_smoke.py 3d, bucket
# 16's length mix and its random lengths, PERF.md): the lanes took
# 0.69-0.94x its time at 8,192 problems, 0.93x (L 16) and 1.24x (L 8) at
# 16,384, 1.23-1.82x at 32,768.
AFFINE_LANES_MAX_L = 32
AFFINE_LANES_MAX_T = 32
AFFINE_DENSE_LANES_MAX_PROBLEMS = 8_192

# the table types of the corpus-pass (gather) entries, by the code their C
# entries take (csrc/*.cu TableDtype); a bf16 or int8 table's launches count
# under "<kernel>[bf16]" / "<kernel>[int8]"
TABLE_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_DTYPE_TAGS = {torch.float32: "", torch.bfloat16: "[bf16]", torch.int8: "[int8]"}
# kernel launches since the last reset (one per launch of each kernel: the
# row-gather entries and their flat-batch wrappers count as "*_flat"; a
# launch on the tag-weighted block as "<kernel>[tagged]", on a dense block
# as "<kernel>[dense]"), and the launches of the entries by route (a dense
# launch's route prefixed "dense_")
LAUNCHES = {
    "affine_dp": 0, "affine_dp[bf16]": 0, "affine_dp[int8]": 0,
    "affine_dp[tagged]": 0, "affine_dp[dense]": 0, "affine_dp_flat": 0,
    "affine_dp_flat[tagged]": 0,
    "wsb_dp": 0, "wsb_dp[bf16]": 0, "wsb_dp[int8]": 0, "wsb_dp[tagged]": 0,
    "wsb_dp[dense]": 0, "wsb_dp_flat": 0, "wsb_dp_flat[tagged]": 0,
}
WSB_ROUTE_LAUNCHES = {
    "registers": 0, "long": 0, "wide": 0, "shared": 0, "scratch": 0,
    "rows_registers": 0, "rows_long": 0, "rows_wide": 0, "rows_shared": 0,
    "rows_scratch": 0,
    "dense_registers": 0, "dense_long": 0, "dense_wide": 0, "dense_shared": 0,
    "dense_scratch": 0,
}
AFFINE_ROUTE_LAUNCHES = {
    "registers": 0, "wide_regs": 0, "wide_shared": 0, "wide_scratch": 0,
    "rows_registers": 0, "rows_wide_regs": 0, "rows_wide_shared": 0,
    "rows_wide_scratch": 0,
    "dense_lanes": 0, "dense_registers": 0, "dense_wide_regs": 0,
    "dense_wide_shared": 0, "dense_wide_scratch": 0,
}
# the ptxas report of each source's last verbose build
PTXAS_REPORTS: Dict[str, str] = {}

class _TagArgs(ctypes.Structure):
    """csrc/*.cu ``TagArgs``: the tag-weighted block's device pointers (a
    ``TagBlock``'s), the row stride ``qs`` of its [Q, T] weights and needle
    pos ids, and the strides of its weight table (row r, query k, column j
    at r * wr + k * wq + j)."""

    _fields_ = [
        ("pos", ctypes.c_void_p), ("w", ctypes.c_void_p), ("p", ctypes.c_void_p),
        ("pen", ctypes.c_void_p), ("thr", ctypes.c_void_p), ("wt", ctypes.c_void_p),
        ("rmap", ctypes.c_void_p), ("qs", ctypes.c_int), ("wr", ctypes.c_int),
        ("wq", ctypes.c_int),
    ]


_P, _I, _I64, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_float
_T = ctypes.POINTER(_TagArgs)
_SIGNATURES = {
    "affine_dp": {
        "vt_affine_dp_scores": [
            _P, _I, _P, _P, _P, _P, _I64, _I, _I, _I, _F, _F, _F, _F, _I,
            _I, _I, _I, _P, _T, _P,
        ],
        "vt_affine_dp_scores_rows": [
            _P, _P, _P, _P, _P, _P, _P, _I64, _I, _I, _I64, _F, _F, _F, _F,
            _I, _I, _I, _I, _I, _P, _T, _P,
        ],
        "vt_affine_dp_scores_dense": [
            _P, _P, _P, _P, _I64, _I, _I, _I, _F, _F, _F, _F, _I, _I, _I, _I,
            _P, _P,
        ],
        "vt_affine_dp_scores_dense_lanes": [
            _P, _P, _P, _P, _I64, _I, _I, _I, _F, _F, _F, _F, _I, _I, _P,
        ],
    },
    "wsb_dp": {
        "vt_wsb_dp_scores": [
            _P, _I, _P, _P, _P, _P, _P, _P, _P, _P, _I64, _I, _I, _I, _I, _I,
            _I, _I, _T, _P,
        ],
        "vt_wsb_dp_scores_regs": [
            _P, _I, _P, _P, _P, _P, _I, _P, _P, _I, _P, _I64, _I, _I, _I, _I,
            _I, _T, _P,
        ],
        "vt_wsb_dp_scores_rows": [
            _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I64, _I, _I, _I64,
            _I, _I, _I, _I, _I, _T, _P,
        ],
        "vt_wsb_dp_scores_rows_regs": [
            _P, _P, _P, _P, _P, _P, _P, _I, _P, _P, _I, _P, _I64, _I, _I,
            _I64, _I, _I, _I, _T, _P,
        ],
        "vt_wsb_dp_scores_dense": [
            _P, _P, _P, _P, _P, _P, _P, _P, _I64, _I, _I, _I, _I, _I, _I, _I,
            _P,
        ],
        "vt_wsb_dp_scores_dense_regs": [
            _P, _P, _P, _P, _I, _P, _P, _I, _P, _I64, _I, _I, _I, _I, _I, _P,
        ],
        "vt_wsb_dp_scores_long": [
            _P, _I, _P, _P, _P, _P, _P, _P, _P, _I64, _I, _I, _I, _I, _I, _I,
            _I, _P,
        ],
        "vt_wsb_dp_scores_rows_long": [
            _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I64, _I, _I, _I64, _I,
            _I, _I, _I, _I, _P,
        ],
        "vt_wsb_dp_scores_dense_long": [
            _P, _P, _P, _P, _P, _P, _P, _I64, _I, _I, _I, _I, _I, _I, _I, _P,
        ],
    },
}
# the wide entries take the long entries' arguments
_SIGNATURES["wsb_dp"].update({
    f"vt_wsb_dp_scores{e}_wide": _SIGNATURES["wsb_dp"][f"vt_wsb_dp_scores{e}_long"]
    for e in ("", "_rows", "_dense")})
_libs: Dict[str, ctypes.CDLL] = {}


def reset_launches() -> None:
    for counts in (LAUNCHES, WSB_ROUTE_LAUNCHES, AFFINE_ROUTE_LAUNCHES):
        for k in counts:
            counts[k] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the DP kernels cannot be built")


def _library_path(name: str) -> Path:
    digest = hashlib.sha256(
        SOURCES[name].read_bytes() + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}_{digest}.so"


def _build_one(name: str, verbose: bool) -> Path:
    out = _library_path(name)
    if out.exists() and not verbose:
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCES[name])]
    if verbose:
        cmd[1:1] = ["-Xptxas", "-v"]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(
            f"nvcc failed on {SOURCES[name].name} ({res.returncode}):\n"
            f"{res.stdout}\n{res.stderr}"
        )
    if verbose:
        PTXAS_REPORTS[name] = res.stderr
        print(f"--- ptxas report, {SOURCES[name].name}", flush=True)
        print(res.stderr, end="", flush=True)
    os.replace(tmp, out)
    return out


def build(verbose: bool = False) -> Dict[str, Path]:
    """Compile every csrc/*.cu of the port (one nvcc per source, all
    started together; a source already built is a no-op); returns
    {name: library path}.  ``verbose`` adds ``-Xptxas -v``, rebuilds and
    prints the compiler's register and spill report of each source."""
    with concurrent.futures.ThreadPoolExecutor(len(SOURCES)) as pool:
        futs = {n: pool.submit(_build_one, n, verbose) for n in SOURCES}
        return {n: f.result() for n, f in futs.items()}


_PTXAS_ENTRY = re.compile(
    r"Compiling entry function '(\S+)'(.*?)(?=Compiling entry function|\Z)", re.S
)
_PTXAS_FRAME = re.compile(
    r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads"
)
_PTXAS_REGS = re.compile(r"Used (\d+) registers")


def ptxas_entries(report: str) -> Dict[str, dict]:
    """{mangled kernel name: {"registers", "stack", "spill_stores",
    "spill_loads"}} of every entry function in a ``-Xptxas -v`` report."""
    out: Dict[str, dict] = {}
    for m in _PTXAS_ENTRY.finditer(report):
        frame = _PTXAS_FRAME.search(m.group(2))
        regs = _PTXAS_REGS.search(m.group(2))
        if frame is None or regs is None:
            continue
        out[m.group(1)] = {
            "registers": int(regs.group(1)),
            "stack": int(frame.group(1)),
            "spill_stores": int(frame.group(2)),
            "spill_loads": int(frame.group(3)),
        }
    return out


def _load(name: str) -> ctypes.CDLL:
    lib = _libs.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(_build_one(name, False)))
        for fn_name, argtypes in _SIGNATURES[name].items():
            fn = getattr(lib, fn_name)
            fn.restype = ctypes.c_int
            fn.argtypes = argtypes
        _libs[name] = lib
    return lib


def _check_locality(locality):
    if locality not in LOCALITIES:
        raise ValueError(f"unknown locality {locality!r}")


def _check_cuda(fn: str, dev, **tensors):
    """Device, contiguity and type checks of a kernel launch's tensors
    (``name=(tensor, dtype)``, or ``(tensor, (dtype, ...))`` where several
    types are allowed)."""
    if dev.type != "cuda":
        raise ValueError(f"{fn}: unsupported device {dev}")
    for name, (t, dtypes) in tensors.items():
        if t.device != dev:
            raise ValueError(f"{fn}: {name} is on {t.device}, not {dev}")
        if not isinstance(dtypes, tuple):
            dtypes = (dtypes,)
        if t.dtype not in dtypes:
            want = " or ".join(str(d) for d in dtypes)
            raise ValueError(f"{fn}: {name} must be {want}, not {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{fn}: {name} must be contiguous")


def _check_gap_vecs(L: int, T: int, w_s, w_t, w_t_star):
    if w_s.dim() != 1 or w_s.shape[0] < L + 1:
        raise ValueError(f"w_s must hold at least L + 1 = {L + 1} costs")
    for name, w in (("w_t", w_t), ("w_t_star", w_t_star)):
        if w.dim() != 1 or w.shape[0] < T + 1:
            raise ValueError(f"{name} must hold at least T + 1 = {T + 1} costs")


class TagBlock(NamedTuple):
    """The tag-weighted similarity block's inputs (the JAX package's
    ``_apply_tag_weights``): S[i, j] of query (or table slot) q becomes
    ``S * w`` with ``w = w[q, j] * (1 if pos[r, i] == p[q, j] else 1 -
    pen[q])``, then 0 wherever ``S * w <= thr[q]``.

    pos [n, L] int8: the pos ids of the rows ``tokens`` holds (compacted
    with them under a document-side filter); w [Q, T] f32 and p [Q, T]
    int8: each query's (row-gather: each table slot's) needle weights and
    pos ids; pen, thr [Q] f32.  ``wt`` [R, Q, >= T] f32 and ``rmap`` [256]
    int32: the same weights as a table (``tag_table``), which the kernels
    of the thread-a-problem routes read; made once a corpus pass, needed
    on the card only (the plain versions read w, p and pen)."""

    pos: torch.Tensor
    w: torch.Tensor
    p: torch.Tensor
    pen: torch.Tensor
    thr: torch.Tensor
    wt: Optional[torch.Tensor] = None
    rmap: Optional[torch.Tensor] = None


def tag_table(w, p, pen):
    """The weight table of needle weights ``w`` [Q, T] f32, needle pos ids
    ``p`` [Q, T] int8 and penalties ``pen`` [Q] f32 (numpy, on the host,
    once a corpus pass): (W [R, Q, T4] f32, rmap [256] int32) with W[rmap[v
    & 255], q, j] = ``w[q, j] * (1 if v == p[q, j] else 1 - pen[q])`` for
    every int8 pos id v, each product and difference rounded once in f32,
    as ``tag_weighted`` rounds them (w * 1 is w).  R - 1 rows hold the
    distinct values of ``p`` and the last one every other pos id, so the
    table is exact for any pos id and small (R = 2 ... Q * T + 1; the
    needles' pos ids, a few tags, in practice).  A (row, query)'s columns
    are contiguous, T4 = T rounded up to 4 (zeros past T): the kernels
    read them 16 bytes at a time."""
    import numpy as np

    w = np.asarray(w, np.float32)
    p = np.asarray(p, np.int8)
    pen = np.asarray(pen, np.float32)
    vals = np.unique(p)
    Q, T = w.shape
    off = w * (np.float32(1.0) - pen)[:, None]  # [Q, T], f32 throughout
    W = np.zeros((len(vals) + 1, Q, -(-T // 4) * 4), np.float32)
    W[:-1, :, :T] = np.where(p[None] == vals[:, None, None], w[None], off[None])
    W[-1, :, :T] = off
    rmap = np.full((256,), len(vals), np.int32)
    rmap[vals.astype(np.uint8)] = np.arange(len(vals), dtype=np.int32)
    return W, rmap


def tag_weighted(S, pos, w, p, pen, thr):
    """The plain tag-weight rewrite of a block S [B, L, T] f32 with its
    rows' pos ids [B, L] and each problem's w, p [B, T] and pen, thr [B]:
    the JAX package's arithmetic in its order (w first, then S * w, then
    the threshold)."""
    sel = torch.where(
        pos[:, :, None] == p[:, None, :], 1.0, 1.0 - pen[:, None, None]
    )
    Sw = S * (w[:, None, :] * sel)
    return torch.where(Sw > thr[:, None, None], Sw, 0.0)


def _check_tags(fn, tags, table, tokens, slots: int, T: int):
    """Shapes and types of a ``TagBlock`` beside its launch's table
    (f32 only: tag weights force f32 ranking) and tokens."""
    if table.dtype != torch.float32:
        raise ValueError(f"{fn}: tag weights need an f32 table, not {table.dtype}")
    if tuple(tags.pos.shape) != tuple(tokens.shape):
        raise ValueError(f"{fn}: tags.pos must be {tuple(tokens.shape)}")
    for name in ("w", "p"):
        t = getattr(tags, name)
        if t.dim() != 2 or t.shape[0] != slots or t.shape[1] < T:
            raise ValueError(f"{fn}: tags.{name} must be [{slots}, >= {T}]")
    for name in ("pen", "thr"):
        if tuple(getattr(tags, name).shape) != (slots,):
            raise ValueError(f"{fn}: tags.{name} must be [{slots}]")
    if tags.wt is not None:
        wt = tags.wt
        if wt.dim() != 3 or wt.shape[1] != slots or wt.shape[2] < T:
            raise ValueError(f"{fn}: tags.wt must be [R, {slots}, >= {T}]")
        if tags.rmap is None or tuple(tags.rmap.shape) != (256,):
            raise ValueError(f"{fn}: tags.rmap must be [256] beside tags.wt")


def _tag_args(fn, tags, dev):
    """(the C ``TagArgs`` pointer or None, the tensors it points into),
    read where they lie: w and p as rows of stride ``qs`` (the same for
    both), the weight table's (row, query) columns as 16-byte aligned
    rows.  A TagBlock on the card must hold its weight table
    (``tag_table``, made once a pass)."""
    if tags is None:
        return None, ()
    if tags.wt is None:
        raise ValueError(f"{fn}: a TagBlock on the card needs its weight table "
                         "(tags.wt, tags.rmap: dp_kernels.tag_table)")
    held = tuple(tags)
    _check_cuda(fn, dev, **{f"tags.{n}": (getattr(tags, n), d) for n, d in (
        ("pos", torch.int8), ("pen", torch.float32), ("thr", torch.float32),
        ("rmap", torch.int32))})
    for name, t, dtype in (("w", tags.w, torch.float32), ("p", tags.p, torch.int8),
                           ("wt", tags.wt, torch.float32)):
        if t.device != dev or t.dtype != dtype:
            raise ValueError(f"{fn}: tags.{name} must be {dtype} on {dev}")
        if t.shape[-1] > 1 and t.stride(-1) != 1:
            raise ValueError(f"{fn}: tags.{name}'s last dimension must be contiguous")
    if tags.w.stride(0) != tags.p.stride(0):
        raise ValueError(f"{fn}: tags.w and tags.p must share a row stride")
    wt = tags.wt
    if wt.data_ptr() % 16 or wt.stride(0) % 4 or wt.stride(1) % 4:
        raise ValueError(f"{fn}: tags.wt's rows must be 16-byte aligned")
    args = _TagArgs(*(t.data_ptr() for t in held), tags.w.stride(0), wt.stride(0),
                    wt.stride(1))
    return ctypes.pointer(args), held


def _raise_on(rc: int, name: str):
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed (error {rc})")


class LaunchPlan(NamedTuple):
    """A kernel launch: its route (with a "rows_" prefix for a row-gather
    entry), grid, block, shared bytes a block and scratch floats."""

    route: str
    blocks: int
    threads: int
    smem: int
    floats: int


def lane_group_width(T: int) -> int:
    """Lanes a problem takes where a group of lanes holds a needle's columns
    (the WSB register routes, the affine dense "lanes" route): the power of
    two >= T (at least 8)."""
    return 8 if T <= 8 else 16 if T <= 16 else 32


def _scratch(dev, floats: int):
    """A scratch buffer of ``floats`` f32 and its pointer (None, 0 when
    the launch needs none)."""
    if floats == 0:
        return None, 0
    buf = torch.empty((floats,), dtype=torch.float32, device=dev)
    return buf, buf.data_ptr()


# ---------------------------------------------------------------------------
# affine DP
# ---------------------------------------------------------------------------


def affine_launch_plan(problems: int, Tpad: int, rows: bool = False,
                       route=None, reg_max_t: int = AFFINE_REG_MAX_T) -> LaunchPlan:
    """The launch of an affine DP of ``problems`` problems against needles
    padded to ``Tpad``; ``rows``: the row-gather entry (routes prefixed
    "rows_").  ``route`` None picks "registers" up to ``reg_max_t`` (one
    thread a problem), else "wide_regs" up to AFFINE_WIDE_REGS_MAX_T (one
    warp a problem, AFFINE_WIDE_REGS_WARPS warps a block, a lane's
    ``affine_wide_cpl(Tpad)`` columns in its registers), else the wide
    route (AFFINE_WIDE_WARPS warps a block) with its 4 x (Tpad + 1) f32
    rows in "wide_shared" memory while a block's rows fit there, else in a
    "wide_scratch" buffer sized to the warps in flight (the grid walking
    over the problems).  A width is never refused.  A named ``route``
    forces that one (ValueError where it cannot run)."""
    prefix = "rows_" if rows else ""
    if route is None and Tpad <= reg_max_t:
        route = "registers"
    if route is None and Tpad <= AFFINE_WIDE_REGS_MAX_T:
        route = "wide_regs"
    if route == "registers":
        if Tpad > reg_max_t:
            raise ValueError(f"the register route does not take Tpad={Tpad}")
        blocks = -(-problems // AFFINE_REG_THREADS)
        return LaunchPlan(prefix + "registers", blocks, AFFINE_REG_THREADS, 0, 0)
    if route == "wide_regs":
        if Tpad > AFFINE_WIDE_REGS_MAX_T:
            raise ValueError(f"the wide_regs route does not take Tpad={Tpad}")
        blocks = min(-(-problems // AFFINE_WIDE_REGS_WARPS), 0x7FFFFFFF)
        return LaunchPlan(prefix + "wide_regs", blocks, 32 * AFFINE_WIDE_REGS_WARPS,
                          0, 0)
    threads = 32 * AFFINE_WIDE_WARPS
    blocks = min(-(-problems // AFFINE_WIDE_WARPS), 0x7FFFFFFF)
    if route not in (None, "wide_shared", "wide_scratch"):
        raise ValueError(f"unknown affine route {route!r}")
    smem = AFFINE_WIDE_WARPS * 4 * (Tpad + 1) * 4
    fits = smem <= WSB_SMEM_MAX
    if route == "wide_shared" and not fits:
        raise ValueError(f"rows of Tpad={Tpad} do not fit in shared memory")
    if route == "wide_shared" or (route is None and fits):
        return LaunchPlan(prefix + "wide_shared", blocks, threads, smem, 0)
    blocks = max(1, min(blocks, WSB_SCRATCH_MAX // smem))
    return LaunchPlan(prefix + "wide_scratch", blocks, threads, 0,
                      blocks * smem // 4)


def affine_wide_cpl(Tpad: int) -> int:
    """The DP columns a lane holds on the wide_regs route: the least of
    AFFINE_WIDE_CPL that covers a needle padded to ``Tpad``."""
    return next(c for c in AFFINE_WIDE_CPL if 32 * c >= Tpad)


def _wide_args(plan: LaunchPlan, Tpad: int):
    """(blocks, columns a lane, shared bytes) of a launch for the C
    entries: blocks 0 on the register route, columns 0 off wide_regs."""
    wide = not plan.route.endswith("registers")
    cpl = affine_wide_cpl(Tpad) if plan.route.endswith("wide_regs") else 0
    return (plan.blocks if wide else 0), cpl, plan.smem


class NeedleSplit(NamedTuple):
    """A launch's queries by their own needle width: ``short`` (len_t <=
    the short routes' widest needle) read the table at ``short_T`` columns
    (kernel 1's register route, kernel 3's lane routes); ``long`` take a
    wide route at the full padded width.  Either may be empty, not both."""

    short: list
    short_T: int
    long: list


def needle_split(len_t, Tpad: int, max_t: int = AFFINE_REG_MAX_T):
    """The split of a launch whose needles ``len_t`` (host ints) are padded
    to ``Tpad``, or None where one launch serves them all as they are
    (Tpad within ``max_t``, the widest needle of the short routes:
    AFFINE_REG_MAX_T for kernel 1, WSB_REG_MAX_T for kernel 3; or every
    needle past it).  A problem's score depends only on its needle's
    columns up to its len_t (csrc/affine_dp.cu, csrc/wsb_dp.cu), so each
    group reads a narrower or smaller table and returns the bits of the
    unsplit launch; ``short_T`` is the short needles' longest rounded up to
    8 (at least 8, at most Tpad)."""
    if Tpad <= max_t:
        return None
    short = [q for q, lt in enumerate(len_t) if lt <= max_t]
    if not short:
        return None
    long = [q for q, lt in enumerate(len_t) if lt > max_t]
    widest = max(len_t[q] for q in short)
    short_T = min(Tpad, max(8, -(-widest // 8) * 8))
    return NeedleSplit(short, short_T, long)


def _split_index(len_t, split: NeedleSplit, max_t: int = AFFINE_REG_MAX_T):
    """The split's (short, long) query indices as long tensors beside
    ``len_t``, ascending: a stable sort of its long flags, so no index list
    is copied to the card (a blocking copy waits for the stream)."""
    perm = torch.argsort((len_t > max_t).to(torch.int32), stable=True)
    return perm[:len(split.short)], perm[len(split.short):]


def _host_lengths(len_t, len_t_host):
    """The needle lengths as host ints: ``len_t_host`` where the caller
    has them, else one read of ``len_t`` (a wait for the device)."""
    if len_t_host is None:
        return [int(x) for x in len_t.tolist()]
    host = [int(x) for x in len_t_host]
    if len(host) != len_t.shape[0]:
        raise ValueError(f"len_t_host holds {len(host)} lengths, len_t {len_t.shape[0]}")
    return host


def _gathered_block(table, tok, tags, c0):
    """The corpus pass's similarity problems of slices ``tok`` [c, L]
    (the ``c0``-th on): ``table[tok]`` cast to f32 (a quantized table's
    exact values, as the JAX corpus pass casts its gathered block), as [c *
    Q, L, Tpad] (problem s * Q + q), tag-weighted where ``tags`` is given."""
    c, L = tok.shape
    _, Tpad, Q = table.shape
    S2 = table[tok].float().permute(0, 3, 1, 2).reshape(c * Q, L, Tpad)
    if tags is None:
        return S2
    return tag_weighted(
        S2, tags.pos[c0 : c0 + c].repeat_interleave(Q, 0),
        tags.w[:, :Tpad].repeat(c, 1), tags.p[:, :Tpad].repeat(c, 1),
        tags.pen.repeat(c), tags.thr.repeat(c),
    )


def affine_dp_scores_reference(
    table, tokens, len_s, len_t, gaps, locality, max_bytes: int = 1 << 29,
    tags=None,
):
    """Plain torch version of ``affine_dp_scores``: the gathered block
    (``table[tokens]`` as f32, tag-weighted with ``tags``) and the torch
    scan, chunked over slices so the gathered [c, L, Tpad, Q] f32 block
    stays under ``max_bytes``."""
    n, L = tokens.shape
    _, Tpad, Q = table.shape
    ln1 = torch.clamp_min(len_s, 1)
    out = torch.empty((n, Q), dtype=torch.float32, device=table.device)
    chunk = max(1, max_bytes // max(L * Tpad * Q * 4, 1))
    for c0 in range(0, n, chunk):
        tok = tokens[c0 : c0 + chunk].long()
        c = tok.shape[0]
        S2 = _gathered_block(table, tok, tags, c0)
        raw = align_scores(
            S2,
            ln1[c0 : c0 + c].repeat_interleave(Q),
            len_t.repeat(c),
            gaps,
            locality,
        )
        out[c0 : c0 + c] = raw.reshape(c, Q)
    return out


class _GatherGroup(NamedTuple):
    """One launch of the gather entry over a group of a pass's queries:
    their columns of the [n, Q] output (``qi``, None for all of them),
    their table as the kernel of the ``route`` reads it (the [V, T, Qg]
    columns on the CPU; on the card ``affine_kernel_table``) and their
    ``len_t``."""

    qi: Optional[torch.Tensor]
    table: torch.Tensor
    len_t: torch.Tensor
    route: str


class AffineTable(NamedTuple):
    """A corpus pass's ranking ``table`` [V, Tpad, Q] as the gather
    entry's launches read it (``affine_table``): made once a pass and
    passed to ``affine_dp_scores`` for each bucket, so the split's sort
    and the groups' tables are not remade a bucket.  ``len_t`` is the
    tensor it was made from."""

    table: torch.Tensor
    len_t: torch.Tensor
    groups: tuple


def affine_kernel_table(table, route: str = "registers"):
    """A [V, Tpad, Q] ``table`` as the gather entry's kernel reads it on
    ``route``: an f32 table on the register route as it is (a warp's
    consecutive queries read one row's Q consecutive elements); any other
    query-major, [V, Q, Tpad] (a (vocab row, query)'s Tpad elements
    contiguous; at Q = 1 the same memory, not a copy).  A bf16 or int8
    table on the register route loads its rows packed, 8 columns a load
    (csrc/affine_dp.cu ``load_packed``): its columns are padded with zeros
    to a multiple of 8 (the kernel reads columns past Tpad as zeros
    anyway) and its start is 16-byte aligned."""
    packed = route == "registers" and table.dtype != torch.float32
    if route == "registers" and not packed:
        return table.contiguous()
    if packed and table.shape[1] % 8:
        V, Tpad, Q = table.shape
        table = torch.cat([table, table.new_zeros((V, -Tpad % 8, Q))], dim=1)
    out = table.transpose(1, 2).contiguous()
    if packed and out.data_ptr() % 16:
        out = out.clone()
    return out


def _gather_group(qi, table, len_t, route) -> _GatherGroup:
    route = affine_launch_plan(1, table.shape[1], route=route).route
    if table.device.type != "cpu":
        table = affine_kernel_table(table, route)
    return _GatherGroup(qi, table.contiguous(), len_t, route)


def affine_table(table, len_t, len_t_host=None, route=None) -> AffineTable:
    """The gather entry's launches of a [V, Tpad, Q] ``table`` against
    needles ``len_t`` [Q] i32: one over the whole table, or, past the
    register route's width, split by each query's own needle
    (``needle_split``, on the CPU too) — the short ones on the register
    route over their first ``short_T`` columns, the long ones on a wide
    route.  ``len_t_host`` (len_t as host ints) spares a read of len_t;
    ``route`` forces one launch on that route."""
    _, Tpad, Q = table.shape
    split = None
    if route is None and Tpad > AFFINE_REG_MAX_T and Q:
        split = needle_split(_host_lengths(len_t, len_t_host), Tpad)
    if split is None:
        return AffineTable(table, len_t, (_gather_group(None, table, len_t, route),))
    qs = _split_index(len_t, split)
    groups = tuple(
        _gather_group(qi, table[:, :T, qi], len_t[qi], None)
        for qi, T, k in zip(qs, (split.short_T, Tpad), (split.short, split.long)) if k
    )
    return AffineTable(table, len_t, groups)


def _affine_gather_launch(group: _GatherGroup, tokens, len_s, gaps, locality, tags):
    """One launch of the gather entry (its plain version for CPU
    tensors)."""
    table, len_t = group.table, group.len_t
    dev = table.device
    n, L = tokens.shape
    if dev.type == "cpu":
        return affine_dp_scores_reference(
            table, tokens, len_s, len_t, gaps, locality, tags=tags
        )
    if group.route != "registers" or table.dtype != torch.float32:
        _, Q, Tpad = table.shape  # query-major (affine_kernel_table)
    else:
        _, Tpad, Q = table.shape
    out = torch.empty((n, Q), dtype=torch.float32, device=dev)
    if n == 0 or Q == 0:
        return out
    ln1 = torch.clamp_min(len_s, 1)
    plan = affine_launch_plan(n * Q, Tpad, route=group.route)
    tag_ptr, held = _tag_args("affine_dp_scores", tags, dev)
    scratch, scratch_ptr = _scratch(dev, plan.floats)
    lib = _load("affine_dp")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.vt_affine_dp_scores(
            table.data_ptr(), TABLE_DTYPES[table.dtype], tokens.data_ptr(),
            ln1.data_ptr(), len_t.data_ptr(), out.data_ptr(), n, L, Tpad, Q,
            float(gaps[0]), float(gaps[1]), float(gaps[2]), float(gaps[3]),
            LOCALITIES.index(locality), *_wide_args(plan, Tpad), scratch_ptr,
            tag_ptr, stream,
        )
    # the caching allocator orders any reuse of these after the launch
    del scratch, held
    _raise_on(rc, "affine_dp")
    LAUNCHES["affine_dp" + ("[tagged]" if tags is not None else
                            _DTYPE_TAGS[table.dtype])] += 1
    AFFINE_ROUTE_LAUNCHES[plan.route] += 1
    return out


def affine_dp_scores(table, tokens, len_s, len_t, gaps, locality,
                     tags=None, len_t_host=None, _route=None):
    """Raw affine-DP scores [n, Q] f32 of every slice against every query.

    table [V, Tpad, Q] (query q's similarity of vocab row v to its needle
    token j) f32, or a quantized ranking table of bf16 or int8 (its units:
    ``gaps`` must be in them too, ops/search.stack_query_tables), read by
    the kernel in its own type (``affine_kernel_table``: a quantized table
    from a query-major copy made once a call, or once a pass where the
    ``AffineTable`` is made), or the ``AffineTable`` made from it and this
    ``len_t`` (a corpus pass's buckets share one); tokens [n, L] i32 (<
    V), len_s [n] i32 (clamped to >= 1, like the JAX corpus pass), len_t
    [Q] i32 (1 <= len_t <= Tpad), ``gaps`` an AffineGapParams of host
    floats (passed by value: changing them rebuilds and uploads nothing).
    Any needle width is served (``affine_launch_plan`` picks the route;
    the wide routes read a query-major [V, Q, Tpad] copy of the table,
    whose rows are contiguous).  Past the register route's width the
    queries split by their own needle (``affine_table``, on the CPU too):
    the short ones on the register route over their columns of the table,
    the long ones on a wide route; ``len_t_host`` (len_t as host ints)
    spares the split a read of len_t.  ``tags``: a ``TagBlock`` (f32
    table; pos [n, L], w and p [Q, >= Tpad], pen and thr [Q]), or None.
    ``_route`` forces one launch on a route, for comparing them."""
    _check_locality(locality)
    prepared = table if isinstance(table, AffineTable) else None
    if prepared is not None:
        if prepared.len_t is not len_t or _route is not None:
            raise ValueError("an AffineTable is read with the len_t it was made "
                             "from, on the routes it chose")
        table = prepared.table
    dev = table.device
    if table.dim() != 3 or tokens.dim() != 2:
        raise ValueError("table must be [V, Tpad, Q] and tokens [n, L]")
    n, L = tokens.shape
    _, Tpad, Q = table.shape
    if tags is not None:
        _check_tags("affine_dp_scores", tags, table, tokens, Q, Tpad)
    if dev.type != "cpu":
        if tuple(len_s.shape) != (n,) or tuple(len_t.shape) != (Q,):
            raise ValueError("len_s must be [n] and len_t [Q]")
        _check_cuda(
            "affine_dp_scores", dev, table=(table, tuple(TABLE_DTYPES)),
            tokens=(tokens, torch.int32), len_s=(len_s, torch.int32),
            len_t=(len_t, torch.int32),
        )
    if prepared is None:
        prepared = affine_table(table, len_t, len_t_host, _route)
    first = prepared.groups[0]
    if first.qi is None:
        return _affine_gather_launch(first, tokens, len_s, gaps, locality, tags)
    # each group's scores written into its columns
    out = torch.empty((n, Q), dtype=torch.float32, device=dev)
    for g in prepared.groups:
        tg = None if tags is None else TagBlock(
            tags.pos, tags.w[g.qi], tags.p[g.qi], tags.pen[g.qi], tags.thr[g.qi],
            None if tags.wt is None else tags.wt.index_select(1, g.qi), tags.rmap)
        out.index_copy_(1, g.qi, _affine_gather_launch(g, tokens, len_s, gaps, locality, tg))
    return out


def _gather_rows(tokens, rows, qslot, table, V: int, tags=None):
    """The similarity blocks [B, L, Tmax] of row-gather problems:
    ``table[qslot * V + tokens[rows]]`` (the plain versions' gather),
    tag-weighted where ``tags`` is given."""
    S = table[qslot.long()[:, None] * V + tokens[rows.long()].long()]
    if tags is None:
        return S
    T, k = S.shape[2], qslot.long()
    return tag_weighted(S, tags.pos[rows.long()], tags.w[k, :T], tags.p[k, :T],
                        tags.pen[k], tags.thr[k])


def _check_rows(fn, tokens, rows, qslot, table, len_s, len_t):
    """Shapes of a row-gather launch; returns (B, L, Tmax)."""
    if table.dim() != 2 or tokens.dim() != 2:
        raise ValueError(f"{fn}: table must be [slots * V, Tmax] and tokens [n, L]")
    B = rows.shape[0]
    for name, t in (("rows", rows), ("qslot", qslot), ("len_s", len_s),
                    ("len_t", len_t)):
        if tuple(t.shape) != (B,):
            raise ValueError(f"{fn}: {name} must be [B] = [{B}]")
    return B, tokens.shape[1], table.shape[1]


def _rows_ptrs(tokens, rows, qslot):
    """Pointers of a row-gather launch; None (null) for the flat batch."""
    return tuple(None if t is None else t.data_ptr() for t in (tokens, rows, qslot))


def affine_dp_scores_rows_reference(tokens, rows, qslot, table, V, len_s,
                                    len_t, gaps, locality, tags=None):
    """Plain torch version of ``affine_dp_scores_rows``: the gather (and
    the tag weights), the torch scan, then the empty-slice mask."""
    S = _gather_rows(tokens, rows, qslot, table, V, tags)
    return align_scores(S, len_s, len_t, gaps, locality).masked_fill(len_s <= 0, NEG)


def _affine_rows_launch(table, tokens, rows, qslot, V, L, len_s, len_t, gaps,
                        locality, mask_empty, route=None, tags=None):
    B, T = len_s.shape[0], table.shape[1]
    dev = table.device
    out = torch.empty((B,), dtype=torch.float32, device=dev)
    if B == 0:
        return out
    plan = affine_launch_plan(B, T, rows=True, route=route)
    tag_ptr, held = _tag_args("affine_dp_scores_rows", tags, dev)
    scratch, scratch_ptr = _scratch(dev, plan.floats)
    lib = _load("affine_dp")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.vt_affine_dp_scores_rows(
            table.data_ptr(), *_rows_ptrs(tokens, rows, qslot),
            len_s.data_ptr(), len_t.data_ptr(), out.data_ptr(), B, L, T, V,
            float(gaps[0]), float(gaps[1]), float(gaps[2]), float(gaps[3]),
            LOCALITIES.index(locality), int(mask_empty), *_wide_args(plan, T),
            scratch_ptr, tag_ptr, stream,
        )
    del scratch, held
    _raise_on(rc, "affine_dp_flat")
    LAUNCHES["affine_dp_flat" + ("[tagged]" if tags is not None else "")] += 1
    AFFINE_ROUTE_LAUNCHES[plan.route] += 1
    return out


def affine_dp_scores_rows(tokens, rows, qslot, table, V, len_s, len_t, gaps,
                          locality, tags=None, _route=None):
    """Raw affine-DP scores [B] f32 of (bucket row, query slot) problems,
    the gather fused in: problem b aligns bucket row ``rows[b]`` of
    ``tokens`` [n, L] i32 against table slot ``qslot[b]`` of ``table``
    [slots * V, Tmax] f32 (similarity row i = table[qslot[b] * V +
    tokens[rows[b], i]]); rows, qslot, len_s (0 allowed) and len_t (1 <=
    len_t <= Tmax) [B] i32.  A problem with len_s <= 0 scores -1e30 (the
    rescore's empty-slice mask).  ``tags``: a ``TagBlock`` whose pos rows
    index like ``tokens`` and whose w, p [slots, >= Tmax], pen, thr
    [slots] index like the table's slots, or None.  Routes as
    ``affine_launch_plan(..., rows=True)`` picks them (``_route`` forces
    one, for comparing them): one launch at the table's width, its
    problems not split by their own len_t (the split measured slower than
    one wide_regs launch, PERF.md)."""
    _check_locality(locality)
    _, L, T = _check_rows("affine_dp_scores_rows", tokens, rows, qslot, table,
                          len_s, len_t)
    if tags is not None:
        _check_tags("affine_dp_scores_rows", tags, table, tokens,
                    tags.w.shape[0], T)
    if table.device.type == "cpu":
        return affine_dp_scores_rows_reference(
            tokens, rows, qslot, table, V, len_s, len_t, gaps, locality, tags
        )
    _check_cuda(
        "affine_dp_scores_rows", table.device, table=(table, torch.float32),
        tokens=(tokens, torch.int32), rows=(rows, torch.int32),
        qslot=(qslot, torch.int32), len_s=(len_s, torch.int32),
        len_t=(len_t, torch.int32),
    )
    return _affine_rows_launch(table, tokens, rows, qslot, V, L, len_s, len_t,
                               gaps, locality, True, _route, tags)


def affine_dp_scores_flat_reference(S, len_s, len_t, gaps, locality):
    """Plain torch version of ``affine_dp_scores_flat``: the torch scan."""
    return align_scores(S, len_s, len_t, gaps, locality)


def affine_dp_scores_flat(S, len_s, len_t, gaps, locality):
    """Raw affine-DP scores [B] f32 of a flat batch of problems (the port
    of ``pallas_align_scores``): the row-gather kernel reading S as its
    table, row b * L + i.

    S [B, L, T] f32, len_s [B] i32 (0 <= len_s <= L: a
    zero-length problem scores its initial value, as the JAX kernel does),
    len_t [B] i32 (1 <= len_t <= T), ``gaps`` an AffineGapParams."""
    _check_locality(locality)
    dev = S.device
    if dev.type == "cpu":
        return affine_dp_scores_flat_reference(S, len_s, len_t, gaps, locality)
    if S.dim() != 3:
        raise ValueError("S must be a [B, L, T] tensor")
    B, L, T = S.shape
    if tuple(len_s.shape) != (B,) or tuple(len_t.shape) != (B,):
        raise ValueError("len_s and len_t must be [B]")
    _check_cuda(
        "affine_dp_scores_flat", dev, S=(S, torch.float32),
        len_s=(len_s, torch.int32), len_t=(len_t, torch.int32),
    )
    return _affine_rows_launch(S.view(B * L, T), None, None, None, B * L, L,
                               len_s, len_t, gaps, locality, False)


def _check_dense(fn, S, len_s, len_t):
    """Shapes of a dense launch; returns (c, L, Tpad, Q)."""
    if S.dim() != 4:
        raise ValueError(f"{fn}: S must be a [c, L, Tpad, Q] block")
    c, L, Tpad, Q = S.shape
    if tuple(len_s.shape) != (c,) or tuple(len_t.shape) != (Q,):
        raise ValueError(f"{fn}: len_s must be [c] and len_t [Q]")
    return c, L, Tpad, Q


def _dense_problems(S, len_s, len_t):
    """The dense block's problems as the JAX contextual batch flattens them:
    (S [c * Q, L, Tpad], problem s * Q + q; len_s clamped to >= 1 and
    repeated, len_t tiled)."""
    c, L, Tpad, Q = S.shape
    S2 = S.permute(0, 3, 1, 2).reshape(c * Q, L, Tpad)
    return S2, torch.clamp_min(len_s, 1).repeat_interleave(Q), len_t.repeat(c)


def affine_dp_scores_dense_reference(S, len_s, len_t, gaps, locality):
    """Plain torch version of ``affine_dp_scores_dense``: the torch scan
    over the block's (slice, query) problems."""
    c, _, _, Q = S.shape
    return align_scores(*_dense_problems(S, len_s, len_t), gaps,
                        locality).reshape(c, Q)


def affine_lanes_shape(L: int, Tpad: int) -> bool:
    """Whether the affine dense entry's lane route takes a bucket of
    capacity L against needles padded to Tpad."""
    return 1 <= L <= AFFINE_LANES_MAX_L and 1 <= Tpad <= AFFINE_LANES_MAX_T


def affine_dense_plan(c: int, L: int, Tpad: int, Q: int, vec: bool = False,
                      route=None) -> LaunchPlan:
    """The launch of the affine dense entry on a [c, L, Tpad, Q] block.
    ``route`` None picks "lanes" (a group of ``lane_group_width(Tpad)``
    lanes a problem, AFFINE_REG_THREADS threads a block) for at most
    AFFINE_DENSE_LANES_MAX_PROBLEMS problems where ``affine_lanes_shape``
    holds, else the gather entry's routes (``affine_launch_plan``: "registers",
    one thread a problem, up to AFFINE_DENSE_REG_MAX_T columns, or
    AFFINE_REG_MAX_T where ``vec``: a row's columns are contiguous and
    16-byte aligned, Q = 1; then the wide routes).  A named ``route``
    forces that one (ValueError where it cannot run)."""
    problems = c * Q
    if (route is None and problems <= AFFINE_DENSE_LANES_MAX_PROBLEMS
            and affine_lanes_shape(L, Tpad)):
        route = "lanes"
    if route == "lanes":
        if not affine_lanes_shape(L, Tpad):
            raise ValueError(f"the lanes route does not take L={L}, Tpad={Tpad}")
        blocks = -(-problems * lane_group_width(Tpad) // AFFINE_REG_THREADS)
        return LaunchPlan("lanes", blocks, AFFINE_REG_THREADS, 0, 0)
    return affine_launch_plan(
        problems, Tpad, route=route,
        reg_max_t=AFFINE_REG_MAX_T if vec else AFFINE_DENSE_REG_MAX_T,
    )


def affine_dp_scores_dense(S, len_s, len_t, gaps, locality, _route=None):
    """Raw affine-DP scores [c, Q] f32 of a dense similarity block.

    S [c, L, Tpad, Q] f32 contiguous (slice s's row i, needle column j of
    query q at S[s, i, j, q]: the [c * L, Tpad * Q] output of a chunk's
    metric GEMM, read in place), len_s [c] i32 (clamped to >= 1, like the
    JAX corpus pass: inside the kernel, so a call is one launch), len_t
    [Q] i32 (1 <= len_t <= Tpad), ``gaps`` an AffineGapParams of host
    floats.  Routes as ``affine_dense_plan`` picks them: "lanes" for a
    launch of few problems (a find's Q = 1 chunk), else the gather
    entry's (registers up to Tpad 32, or 64 where a row's
    columns are contiguous, Q = 1; the wide routes read the block in
    place, a row's columns Q floats apart), one launch whose queries are
    not split by their own needle (the split measured slower than one
    wide_regs launch, PERF.md); ``_route`` forces one (refused where it
    cannot run, on the CPU too)."""
    _check_locality(locality)
    c, L, Tpad, Q = _check_dense("affine_dp_scores_dense", S, len_s, len_t)
    dev = S.device
    if dev.type == "cpu":
        if _route is not None:
            affine_dense_plan(c, L, Tpad, Q, route=_route)
        return affine_dp_scores_dense_reference(S, len_s, len_t, gaps, locality)
    _check_cuda(
        "affine_dp_scores_dense", dev, S=(S, torch.float32),
        len_s=(len_s, torch.int32), len_t=(len_t, torch.int32),
    )
    out = torch.empty((c, Q), dtype=torch.float32, device=dev)
    if c == 0 or Q == 0:
        return out
    vec = Q == 1 and Tpad % 4 == 0 and S.data_ptr() % 16 == 0
    plan = affine_dense_plan(c, L, Tpad, Q, vec, route=_route)
    scratch, scratch_ptr = _scratch(dev, plan.floats)
    lib = _load("affine_dp")
    gap_args = (float(gaps[0]), float(gaps[1]), float(gaps[2]), float(gaps[3]),
                LOCALITIES.index(locality))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if plan.route == "lanes":
            rc = lib.vt_affine_dp_scores_dense_lanes(
                S.data_ptr(), len_s.data_ptr(), len_t.data_ptr(), out.data_ptr(), c,
                L, Tpad, Q, *gap_args, plan.blocks, stream,
            )
        else:
            rc = lib.vt_affine_dp_scores_dense(
                S.data_ptr(), len_s.data_ptr(), len_t.data_ptr(), out.data_ptr(), c,
                L, Tpad, Q, *gap_args, *_wide_args(plan, Tpad), scratch_ptr, stream,
            )
    del scratch
    _raise_on(rc, "affine_dp[dense]")
    LAUNCHES["affine_dp[dense]"] += 1
    AFFINE_ROUTE_LAUNCHES["dense_" + plan.route] += 1
    return out


# ---------------------------------------------------------------------------
# general-gap (WSB) DP
# ---------------------------------------------------------------------------


def wsb_register_shape(L: int, T: int) -> bool:
    """Whether the register route takes a bucket of capacity L against
    needles padded to T."""
    return 1 <= L <= WSB_REG_MAX_L and 1 <= T <= WSB_REG_MAX_T


def wsb_long_shape(L: int, T: int) -> bool:
    """Whether the long route takes a bucket of capacity L against needles
    padded to T (any capacity the register route takes, too)."""
    return 1 <= L <= WSB_LONG_MAX_L and 1 <= T <= WSB_REG_MAX_T


def wsb_long_smem(L: int, threads: int) -> int:
    """Shared bytes a block of the long route needs: w_s[1 ..] and each
    thread's column history, L rounded up to WSB_LONG_R rows
    (csrc/wsb_dp.cu long_smem_bytes)."""
    Lr = -(-L // WSB_LONG_R) * WSB_LONG_R
    return (Lr + WSB_LONG_R + Lr * threads) * 4


def _resident(smem: int, threads: int) -> int:
    """Threads of blocks of ``threads`` threads and ``smem`` shared bytes
    resident an SM (1 KB reserved a block, at most 32 blocks and 2,048
    threads); 0 where one block does not fit."""
    if smem > WSB_SMEM_MAX:
        return 0
    return min(min(SM_SMEM // (smem + 1024), 32) * threads, 2048)


def wsb_wide_smem(L: int, T: int, warps: int) -> int:
    """Shared bytes a block of ``warps`` warps of the wide route needs: the
    closure's copy (WSB_WIDE_XP +inf costs, then T rounded up to 32, 4
    more), w_s[0 .. L] (to a multiple of 4), and each warp's C row and
    column history (L x T floats) (csrc/wsb_dp.cu wide_smem_floats)."""
    tc = -(-T // 32) * 32
    per_warp = tc + 4 + -(-(L * T) // 4) * 4
    return (WSB_WIDE_XP + tc + 4 + (L + 4) // 4 * 4 + warps * per_warp) * 4


def _wide_block(L: int, T: int):
    """(threads resident an SM, threads a block) of the wide route's block
    size (32, 64 or 128 threads) that keeps the most resident."""
    return max((_resident(wsb_wide_smem(L, T, t // 32), t), t) for t in (128, 64, 32))


def wsb_wide_shape(L: int, T: int) -> bool:
    """Whether the wide route takes a bucket of capacity L against needles
    padded to T: 33 to WSB_WIDE_MAX_T columns, while blocks of its column
    histories keep at least WSB_WIDE_MIN_WARPS warps resident an SM (L 16
    x T 512, L 64 x T 160 and L 256 x T 48 do; L 64 x T 256 does not)."""
    return (L >= 1 and WSB_REG_MAX_T < T <= WSB_WIDE_MAX_T
            and _wide_block(L, T)[0] >= 32 * WSB_WIDE_MIN_WARPS)


def wsb_launch_plan(problems: int, L: int, T: int, registers: bool = True,
                    route=None, Q: int = 1, rows: bool = False,
                    wide: bool = True) -> LaunchPlan:
    """The launch of a WSB DP of ``problems`` problems (``Q`` queries a
    slice), bucket capacity L, needles padded to T; ``rows``: the
    row-gather entry (its routes are named "rows_registers", "rows_long",
    "rows_wide", "rows_shared" and "rows_scratch").  ``registers``: the
    lane routes may run (a closure of non-negative costs and a table under
    2^32 elements); ``wide``: the wide route may run (an untagged launch).
    ``route`` None picks: "registers" where ``wsb_register_shape`` holds (a
    group of G = ``lane_group_width(T)`` lanes takes one problem — two
    consecutive queries of a slice in the gather entry where Q is even;
    WSB_REG_THREADS threads a block); else "long" where ``wsb_long_shape``
    holds (a group of G lanes a problem, its column histories in shared
    memory: the block size of 32, 64 or 128 threads that keeps the most
    threads resident an SM); else "wide" where ``wsb_wide_shape`` holds (a
    warp a problem, its column histories in shared memory; the block size
    that keeps the most warps resident); else a problem's (L + 1) x (T + 1)
    rows go to "shared" memory when blocks of 32, 64 or 128 threads keep
    at least WSB_MIN_RESIDENT threads resident an SM or hold every problem
    in one wave on WSB_SMS SMs (the block size that keeps the most), else
    to a "scratch" buffer sized to the threads in flight (the grid then
    walks over the problems): the thread-a-problem body, which keeps
    buckets past WSB_LONG_MAX_L, shapes past the wide route's shared memory,
    closures with a negative cost at needles of at most WSB_REG_MAX_T
    columns and tagged launches past the register route.  A named
    ``route`` ("registers", "long", "wide", "shared" or "scratch") forces
    that one (ValueError where it cannot run)."""
    prefix = "rows_" if rows else ""
    if route is None and registers:
        if wsb_register_shape(L, T):
            route = "registers"
        elif wsb_long_shape(L, T):
            route = "long"
    if route is None and wide and wsb_wide_shape(L, T):
        route = "wide"
    if route == "registers":
        if not (registers and wsb_register_shape(L, T)):
            raise ValueError(f"the register route does not take L={L}, T={T}")
        threads = WSB_REG_THREADS
        groups = -(-problems // (2 if Q % 2 == 0 and not rows else 1))
        blocks = -(-groups * lane_group_width(T) // threads)
        return LaunchPlan(prefix + "registers", blocks, threads, 0, 0)
    if route == "long":
        if not (registers and wsb_long_shape(L, T)):
            raise ValueError(f"the long route does not take L={L}, T={T}")
        _, threads = max((_resident(wsb_long_smem(L, t), t), t) for t in (128, 64, 32))
        blocks = -(-problems * lane_group_width(T) // threads)
        return LaunchPlan(prefix + "long", blocks, threads, wsb_long_smem(L, threads), 0)
    if route == "wide":
        if not (wide and wsb_wide_shape(L, T)):
            raise ValueError(f"the wide route does not take L={L}, T={T}")
        threads = _wide_block(L, T)[1]
        blocks = -(-problems // (threads // 32))
        return LaunchPlan(prefix + "wide", blocks, threads,
                          wsb_wide_smem(L, T, threads // 32), 0)
    per = (L + 1) * (T + 1) * 4
    resident, threads = max((_resident(t * per, t), t) for t in (128, 64, 32))
    if route not in (None, "shared", "scratch"):
        raise ValueError(f"unknown WSB route {route!r}")
    if route == "shared" and resident == 0:
        raise ValueError(f"rows of L={L}, T={T} do not fit in shared memory")
    if route == "shared" or (route is None and resident > 0 and (
            resident >= WSB_MIN_RESIDENT or problems <= resident * WSB_SMS)):
        return LaunchPlan(prefix + "shared", -(-problems // threads), threads,
                       threads * per, 0)
    threads = WSB_SCRATCH_THREADS
    blocks = max(1, min(-(-problems // threads),
                        WSB_SCRATCH_MAX // (threads * per)))
    return LaunchPlan(prefix + "scratch", blocks, threads, 0,
                   blocks * threads * per // 4)


def wsb_register_table(table: torch.Tensor) -> torch.Tensor:
    """The register route's table layout: [V, Tpad, Q] -> [V, Q, Tpad] of
    the same type, so the G lanes of a problem (and a warp's consecutive
    queries) read one contiguous segment.  At Q = 1 it is the same memory,
    not a copy.  A bf16 or int8 table at an even Q is paired instead, [V, Q
    / 2, Tpad, 2]: queries 2m and 2m + 1's elements of a column side by
    side, so a lane group of the two reads both with one load."""
    V, T, Q = table.shape
    if table.dtype == torch.float32 or Q % 2:
        return table.transpose(1, 2).contiguous()
    out = table.permute(0, 2, 1).reshape(V, Q // 2, 2, T).transpose(2, 3).contiguous()
    # a pair loads as one 2- or 4-byte word (at T = 1 the table's own memory)
    return out.clone() if out.data_ptr() % 4 else out


def _register_costs(L: int, T: int, table, vecs, host_costs, tagged: bool = False):
    """The host cost vectors the register route passes by value, or None
    where neither lane route ("registers", "long") can take the launch: a
    shape they do not take, a table (of any type) of 2^32 elements or more,
    a closure w_t*[1..T] with a negative cost (their shuffles need w_t* >=
    0), or (``tagged``) a tag-weighted launch past the register route's
    shapes (the long route has no tagged kernels).  Without ``host_costs``
    the device vectors are copied back, which waits for the stream."""
    if not (wsb_register_shape(L, T) if tagged else wsb_long_shape(L, T)):
        return None
    if table.numel() >= 2**32:
        return None
    hs = host_costs if host_costs is not None else vecs
    hs = [w.detach().to("cpu", torch.float32).contiguous() for w in hs]
    _check_gap_vecs(L, T, *hs)
    # numpy: a few microseconds less host time a launch than torch ops
    return hs if hs[2].numpy()[1 : T + 1].min() >= 0 else None


def wsb_dp_scores_reference(
    table, tokens, len_s, len_t, w_s, w_t, w_t_star, locality,
    max_bytes: int = 1 << 28, tags=None,
):
    """Plain torch version of ``wsb_dp_scores``: the gathered block (as
    in ``affine_dp_scores_reference``) and the torch WSB scan, chunked over
    slices so the scan's resident rows ([L + 1, c * Q, Tpad + 1] f32, about
    as large as its temporaries) stay under ``max_bytes``."""
    n, L = tokens.shape
    _, Tpad, Q = table.shape
    ln1 = torch.clamp_min(len_s, 1)
    out = torch.empty((n, Q), dtype=torch.float32, device=table.device)
    chunk = max(1, max_bytes // max((L + 1) * (Tpad + 1) * Q * 4, 1))
    for c0 in range(0, n, chunk):
        tok = tokens[c0 : c0 + chunk].long()
        c = tok.shape[0]
        S2 = _gathered_block(table, tok, tags, c0)
        raw = align_scores_general(
            S2,
            ln1[c0 : c0 + c].repeat_interleave(Q),
            len_t.repeat(c),
            w_s[: L + 1],
            w_t[: Tpad + 1],
            locality,
            w_t_star=w_t_star[: Tpad + 1],
        )
        out[c0 : c0 + c] = raw.reshape(c, Q)
    return out


class _WsbGroup(NamedTuple):
    """One launch of the WSB gather entry over a group of a pass's
    queries: their columns of the [n, Q] output (``qi``, None for all of
    them), their [V, T, Qg] table and ``len_t``, and the copies of that
    table the routes read on the card (``layouts``: "register", the
    register route's ``wsb_register_table``; "query_major", the long and
    wide routes' [V, Qg, T]), each made at its first launch and kept for
    the pass's other buckets."""

    qi: Optional[torch.Tensor]
    table: torch.Tensor
    len_t: torch.Tensor
    layouts: dict


class WsbTable(NamedTuple):
    """A corpus pass's ranking ``table`` [V, Tpad, Q] as kernel 3's gather
    launches read it (``wsb_table``): made once a pass and passed to
    ``wsb_dp_scores`` for each bucket, so the split and the groups' tables
    are not remade a bucket.  ``len_t`` is the tensor it was made from."""

    table: torch.Tensor
    len_t: torch.Tensor
    groups: tuple


def wsb_table(table, len_t, len_t_host=None, route=None) -> WsbTable:
    """Kernel 3's gather launches of a [V, Tpad, Q] ``table`` against
    needles ``len_t`` [Q] i32: one over the whole table, or, past
    WSB_REG_MAX_T columns, split by each query's own needle
    (``needle_split``, on the CPU too) — the short ones over their first
    ``short_T`` columns (the register or long route, by the bucket), the
    long ones at the full width (the wide route where ``wsb_wide_shape``
    holds).  Where every needle is short or every one is long, one launch.
    ``len_t_host`` (len_t as host ints) spares a read of len_t; ``route``
    forces one launch (no split)."""
    _, Tpad, Q = table.shape
    split = None
    if route is None and Tpad > WSB_REG_MAX_T and Q:
        split = needle_split(_host_lengths(len_t, len_t_host), Tpad, WSB_REG_MAX_T)
    if split is None:
        return WsbTable(table, len_t, (_WsbGroup(None, table, len_t, {}),))
    qs = _split_index(len_t, split, WSB_REG_MAX_T)
    groups = tuple(
        _WsbGroup(qi, table[:, :T, qi], len_t[qi], {})
        for qi, T, k in zip(qs, (split.short_T, Tpad), (split.short, split.long)) if k
    )
    return WsbTable(table, len_t, groups)


def _group_layout(group: _WsbGroup, kind: str):
    """The group's table as the route reads it (made once, then kept)."""
    out = group.layouts.get(kind)
    if out is None:
        out = (wsb_register_table(group.table) if kind == "register"
               else group.table.transpose(1, 2).contiguous())
        group.layouts[kind] = out
    return out


def _wsb_gather_launch(group: _WsbGroup, tokens, len_s, vecs, locality,
                       host_costs, tags, route):
    """One launch of the WSB gather entry over a group (its plain version
    for CPU tensors)."""
    table, len_t = group.table, group.len_t
    w_s, w_t, w_t_star = vecs
    dev = table.device
    if dev.type == "cpu":
        return wsb_dp_scores_reference(
            table, tokens, len_s, len_t, w_s, w_t, w_t_star, locality, tags=tags,
        )
    n, L = tokens.shape
    _, Tpad, Q = table.shape
    out = torch.empty((n, Q), dtype=torch.float32, device=dev)
    if n == 0 or Q == 0:
        return out
    ln1 = torch.clamp_min(len_s, 1)
    hs = _register_costs(L, Tpad, table, vecs, host_costs, tagged=tags is not None)
    plan = wsb_launch_plan(n * Q, L, Tpad, registers=hs is not None,
                           route=route, Q=Q, wide=tags is None)
    lib = _load("wsb_dp")
    code = TABLE_DTYPES[table.dtype]
    loc = LOCALITIES.index(locality)
    tag_ptr, held = _tag_args("wsb_dp_scores", tags, dev)
    scratch = None
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if plan.route == "registers":
            tq = _group_layout(group, "register")
            rc = lib.vt_wsb_dp_scores_regs(
                tq.data_ptr(), code, tokens.data_ptr(), ln1.data_ptr(),
                len_t.data_ptr(), hs[0].data_ptr(), hs[0].numel(),
                hs[1].data_ptr(), hs[2].data_ptr(), min(hs[1].numel(), hs[2].numel()),
                out.data_ptr(), n, L, Tpad, Q, loc, plan.blocks, tag_ptr, stream,
            )
        elif plan.route in ("long", "wide"):
            tq = _group_layout(group, "query_major")  # [V, Q, Tpad], unpaired
            entry = (lib.vt_wsb_dp_scores_long if plan.route == "long"
                     else lib.vt_wsb_dp_scores_wide)
            rc = entry(
                tq.data_ptr(), code, tokens.data_ptr(), ln1.data_ptr(),
                len_t.data_ptr(), w_s.data_ptr(), w_t.data_ptr(),
                w_t_star.data_ptr(), out.data_ptr(), n, L, Tpad, Q, loc,
                plan.blocks, plan.threads, plan.smem, stream,
            )
        else:
            scratch, scratch_ptr = _scratch(dev, plan.floats)
            rc = lib.vt_wsb_dp_scores(
                table.data_ptr(), code, tokens.data_ptr(), ln1.data_ptr(),
                len_t.data_ptr(), w_s.data_ptr(), w_t.data_ptr(),
                w_t_star.data_ptr(), out.data_ptr(), scratch_ptr, n, L, Tpad,
                Q, loc, plan.blocks, plan.threads, plan.smem, tag_ptr, stream,
            )
    # the host costs were copied into the launch; the caching allocator
    # orders any reuse of the scratch buffer after it on this stream
    del scratch, held
    _raise_on(rc, "wsb_dp")
    LAUNCHES["wsb_dp" + ("[tagged]" if tags is not None else
                         _DTYPE_TAGS[table.dtype])] += 1
    WSB_ROUTE_LAUNCHES[plan.route] += 1
    return out


def wsb_dp_scores(table, tokens, len_s, len_t, w_s, w_t, w_t_star, locality,
                  host_costs=None, tags=None, len_t_host=None, _route=None):
    """Raw WSB-DP scores [n, Q] f32 of every slice against every query.

    table [V, Tpad, Q] f32, bf16 or int8 (as in ``affine_dp_scores``: the
    costs in the table's units), or the ``WsbTable`` made from it and this
    ``len_t`` (a corpus pass's buckets share one); tokens [n, L] i32 (<
    V), len_s [n] i32 (clamped to >= 1, like the JAX corpus pass), len_t
    [Q] i32 (1 <= len_t <= Tpad); w_s [>= L + 1] raw document-side gap
    costs, w_t [>= Tpad + 1] raw needle-side costs (the global row 0) and
    w_t_star their min-plus closure (ops/alignment.gap_cost_closure), all
    f32 on the table's device.
    ``host_costs``: the same three vectors on the host (``GeneralGaps.
    host_vecs``); the register route passes the costs by value, and without
    them it copies the device vectors back first, which waits for the
    stream.  ``tags``: a ``TagBlock`` as in ``affine_dp_scores``, or None.
    Any bucket capacity and needle width is served (``wsb_launch_plan``
    picks the route).  Past WSB_REG_MAX_T columns the queries split by
    their own needle (``wsb_table``, on the CPU too): the short ones on the
    lane routes over their columns of the table, the long ones on the wide
    route; ``len_t_host`` (len_t as host ints) spares the split a read of
    len_t.  ``_route`` forces one launch on a route, for comparing the
    routes."""
    _check_locality(locality)
    prepared = table if isinstance(table, WsbTable) else None
    if prepared is not None:
        if prepared.len_t is not len_t or _route is not None:
            raise ValueError("a WsbTable is read with the len_t it was made from, "
                             "on the routes it chose")
        table = prepared.table
    dev = table.device
    if table.dim() != 3 or tokens.dim() != 2:
        raise ValueError("table must be [V, Tpad, Q] and tokens [n, L]")
    n, L = tokens.shape
    _, Tpad, Q = table.shape
    _check_gap_vecs(L, Tpad, w_s, w_t, w_t_star)
    if tags is not None:
        _check_tags("wsb_dp_scores", tags, table, tokens, Q, Tpad)
    if dev.type != "cpu":
        if tuple(len_s.shape) != (n,) or tuple(len_t.shape) != (Q,):
            raise ValueError("len_s must be [n] and len_t [Q]")
        _check_cuda(
            "wsb_dp_scores", dev, table=(table, tuple(TABLE_DTYPES)),
            tokens=(tokens, torch.int32), len_s=(len_s, torch.int32),
            len_t=(len_t, torch.int32), w_s=(w_s, torch.float32),
            w_t=(w_t, torch.float32), w_t_star=(w_t_star, torch.float32),
        )
    if prepared is None:
        prepared = wsb_table(table, len_t, len_t_host, _route)
    vecs = (w_s, w_t, w_t_star)
    first = prepared.groups[0]
    if first.qi is None:
        return _wsb_gather_launch(first, tokens, len_s, vecs, locality, host_costs,
                                  tags, _route)
    # each group's scores written into its columns
    out = torch.empty((n, Q), dtype=torch.float32, device=dev)
    for g in prepared.groups:
        tg = None if tags is None else TagBlock(
            tags.pos, tags.w[g.qi], tags.p[g.qi], tags.pen[g.qi], tags.thr[g.qi],
            None if tags.wt is None else tags.wt.index_select(1, g.qi), tags.rmap)
        out.index_copy_(1, g.qi, _wsb_gather_launch(g, tokens, len_s, vecs, locality,
                                                     host_costs, tg, None))
    return out


def _wsb_general_scores(S, len_s, len_t, w_s, w_t, w_t_star, locality):
    L, T = S.shape[1], S.shape[2]
    return align_scores_general(
        S, len_s, len_t, w_s[: L + 1], w_t[: T + 1], locality,
        w_t_star=w_t_star[: T + 1],
    )


def wsb_dp_scores_rows_reference(tokens, rows, qslot, table, V, len_s, len_t,
                                 w_s, w_t, w_t_star, locality, tags=None):
    """Plain torch version of ``wsb_dp_scores_rows``: the gather (and the
    tag weights), the torch WSB scan, then the empty-slice mask."""
    S = _gather_rows(tokens, rows, qslot, table, V, tags)
    raw = _wsb_general_scores(S, len_s, len_t, w_s, w_t, w_t_star, locality)
    return raw.masked_fill(len_s <= 0, NEG)


def _wsb_rows_launch(table, tokens, rows, qslot, V, L, len_s, len_t, vecs,
                     locality, host_costs, route, mask_empty, tags=None):
    B, T = len_s.shape[0], table.shape[1]
    dev = table.device
    out = torch.empty((B,), dtype=torch.float32, device=dev)
    if B == 0:
        return out
    hs = _register_costs(L, T, table, vecs, host_costs, tagged=tags is not None)
    plan = wsb_launch_plan(B, L, T, registers=hs is not None, route=route,
                           rows=True, wide=tags is None)
    lib = _load("wsb_dp")
    ptrs = (table.data_ptr(), *_rows_ptrs(tokens, rows, qslot),
            len_s.data_ptr(), len_t.data_ptr())
    loc = LOCALITIES.index(locality)
    tag_ptr, held = _tag_args("wsb_dp_scores_rows", tags, dev)
    scratch = None
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if plan.route == "rows_registers":
            rc = lib.vt_wsb_dp_scores_rows_regs(
                *ptrs, hs[0].data_ptr(), hs[0].numel(), hs[1].data_ptr(),
                hs[2].data_ptr(), min(hs[1].numel(), hs[2].numel()),
                out.data_ptr(), B, L, T, V, loc, int(mask_empty), plan.blocks,
                tag_ptr, stream,
            )
        elif plan.route in ("rows_long", "rows_wide"):
            entry = (lib.vt_wsb_dp_scores_rows_long if plan.route == "rows_long"
                     else lib.vt_wsb_dp_scores_rows_wide)
            rc = entry(
                *ptrs, *(w.data_ptr() for w in vecs), out.data_ptr(), B, L,
                T, V, loc, int(mask_empty), plan.blocks, plan.threads,
                plan.smem, stream,
            )
        else:
            scratch, scratch_ptr = _scratch(dev, plan.floats)
            rc = lib.vt_wsb_dp_scores_rows(
                *ptrs, *(w.data_ptr() for w in vecs), out.data_ptr(),
                scratch_ptr, B, L, T, V, loc, int(mask_empty), plan.blocks,
                plan.threads, plan.smem, tag_ptr, stream,
            )
    del scratch, held
    _raise_on(rc, "wsb_dp_flat")
    LAUNCHES["wsb_dp_flat" + ("[tagged]" if tags is not None else "")] += 1
    WSB_ROUTE_LAUNCHES[plan.route] += 1
    return out


def wsb_dp_scores_rows(tokens, rows, qslot, table, V, len_s, len_t, w_s, w_t,
                       w_t_star, locality, host_costs=None, tags=None):
    """Raw WSB-DP scores [B] f32 of (bucket row, query slot) problems, the
    gather fused in (inputs as in ``affine_dp_scores_rows``; a problem with
    len_s <= 0 scores -1e30).  Cost vectors as in ``wsb_dp_scores``
    (w_s [>= L + 1], w_t and w_t_star [>= Tmax + 1]; ``host_costs`` their
    host copies for the register route, ``GeneralGaps.host_vecs``).
    ``tags`` as in ``affine_dp_scores_rows``.  Routes as
    ``wsb_launch_plan(..., rows=True)`` picks them: one launch at the
    table's width ("rows_wide" past WSB_REG_MAX_T columns, untagged), its
    problems not split by their own len_t."""
    _check_locality(locality)
    _, L, T = _check_rows("wsb_dp_scores_rows", tokens, rows, qslot, table,
                          len_s, len_t)
    _check_gap_vecs(L, T, w_s, w_t, w_t_star)
    if tags is not None:
        _check_tags("wsb_dp_scores_rows", tags, table, tokens,
                    tags.w.shape[0], T)
    dev = table.device
    if dev.type == "cpu":
        return wsb_dp_scores_rows_reference(
            tokens, rows, qslot, table, V, len_s, len_t, w_s, w_t, w_t_star,
            locality, tags,
        )
    _check_cuda(
        "wsb_dp_scores_rows", dev, table=(table, torch.float32),
        tokens=(tokens, torch.int32), rows=(rows, torch.int32),
        qslot=(qslot, torch.int32), len_s=(len_s, torch.int32),
        len_t=(len_t, torch.int32), w_s=(w_s, torch.float32),
        w_t=(w_t, torch.float32), w_t_star=(w_t_star, torch.float32),
    )
    return _wsb_rows_launch(table, tokens, rows, qslot, V, L, len_s, len_t,
                            (w_s, w_t, w_t_star), locality, host_costs,
                            None, True, tags)


def wsb_dp_scores_flat_reference(S, len_s, len_t, w_s, w_t, w_t_star,
                                 locality):
    """Plain torch version of ``wsb_dp_scores_flat``: the torch WSB scan."""
    return _wsb_general_scores(S, len_s, len_t, w_s, w_t, w_t_star, locality)


def wsb_dp_scores_flat(S, len_s, len_t, w_s, w_t, w_t_star, locality,
                       host_costs=None, _route=None):
    """Raw WSB-DP scores [B] f32 of a flat batch of problems (the port of
    ``pallas_align_scores_general``): the row-gather kernel reading S as
    its table, row b * L + i.

    S [B, L, T] f32, len_s [B] i32 (0 <= len_s <= L: a zero-length problem
    scores its initial value, as the JAX kernel does), len_t [B] i32
    (1 <= len_t <= T), cost vectors and ``host_costs`` as in
    ``wsb_dp_scores_rows``; ``_route`` forces a route of
    ``wsb_launch_plan(..., rows=True)``, for comparing the routes."""
    _check_locality(locality)
    dev = S.device
    if S.dim() != 3:
        raise ValueError("S must be a [B, L, T] tensor")
    B, L, T = S.shape
    _check_gap_vecs(L, T, w_s, w_t, w_t_star)
    if dev.type == "cpu":
        return wsb_dp_scores_flat_reference(
            S, len_s, len_t, w_s, w_t, w_t_star, locality
        )
    if tuple(len_s.shape) != (B,) or tuple(len_t.shape) != (B,):
        raise ValueError("len_s and len_t must be [B]")
    _check_cuda(
        "wsb_dp_scores_flat", dev, S=(S, torch.float32),
        len_s=(len_s, torch.int32), len_t=(len_t, torch.int32),
        w_s=(w_s, torch.float32), w_t=(w_t, torch.float32),
        w_t_star=(w_t_star, torch.float32),
    )
    return _wsb_rows_launch(S.view(B * L, T), None, None, None, B * L, L,
                            len_s, len_t, (w_s, w_t, w_t_star), locality,
                            host_costs, _route, False)


def wsb_dp_scores_dense_reference(S, len_s, len_t, w_s, w_t, w_t_star,
                                  locality):
    """Plain torch version of ``wsb_dp_scores_dense``: the torch WSB scan
    over the block's (slice, query) problems."""
    c, _, _, Q = S.shape
    return _wsb_general_scores(*_dense_problems(S, len_s, len_t), w_s, w_t,
                               w_t_star, locality).reshape(c, Q)


def wsb_dp_scores_dense(S, len_s, len_t, w_s, w_t, w_t_star, locality,
                        host_costs=None, _route=None):
    """Raw WSB-DP scores [c, Q] f32 of a dense similarity block S [c, L, T,
    Q] f32 (as in ``affine_dp_scores_dense``); cost vectors and
    ``host_costs`` as in ``wsb_dp_scores``.  The gather entry's routes
    (``wsb_launch_plan``; the register route reads lane k's column Q
    floats apart, the wide route a slot's columns Q floats apart, no
    transposed copy; len_s is clamped to >= 1 inside the kernels, so a
    call is one launch, not split by needle); ``_route`` forces one
    (refused where it cannot run, on the CPU too)."""
    _check_locality(locality)
    c, L, T, Q = _check_dense("wsb_dp_scores_dense", S, len_s, len_t)
    _check_gap_vecs(L, T, w_s, w_t, w_t_star)
    dev = S.device
    if dev.type == "cpu":
        if _route is not None:
            hs = _register_costs(L, T, S, (w_s, w_t, w_t_star), host_costs)
            wsb_launch_plan(c * Q, L, T, registers=hs is not None, route=_route, Q=Q)
        return wsb_dp_scores_dense_reference(S, len_s, len_t, w_s, w_t,
                                             w_t_star, locality)
    _check_cuda(
        "wsb_dp_scores_dense", dev, S=(S, torch.float32),
        len_s=(len_s, torch.int32), len_t=(len_t, torch.int32),
        w_s=(w_s, torch.float32), w_t=(w_t, torch.float32),
        w_t_star=(w_t_star, torch.float32),
    )
    out = torch.empty((c, Q), dtype=torch.float32, device=dev)
    if c == 0 or Q == 0:
        return out
    hs = _register_costs(L, T, S, (w_s, w_t, w_t_star), host_costs)
    plan = wsb_launch_plan(c * Q, L, T, registers=hs is not None,
                           route=_route, Q=Q)
    lib = _load("wsb_dp")
    loc = LOCALITIES.index(locality)
    scratch = None
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if plan.route == "registers":
            rc = lib.vt_wsb_dp_scores_dense_regs(
                S.data_ptr(), len_s.data_ptr(), len_t.data_ptr(),
                hs[0].data_ptr(), hs[0].numel(), hs[1].data_ptr(),
                hs[2].data_ptr(), min(hs[1].numel(), hs[2].numel()),
                out.data_ptr(), c, L, T, Q, loc, plan.blocks, stream,
            )
        elif plan.route in ("long", "wide"):
            entry = (lib.vt_wsb_dp_scores_dense_long if plan.route == "long"
                     else lib.vt_wsb_dp_scores_dense_wide)
            rc = entry(
                S.data_ptr(), len_s.data_ptr(), len_t.data_ptr(), w_s.data_ptr(),
                w_t.data_ptr(), w_t_star.data_ptr(), out.data_ptr(), c, L, T, Q,
                loc, plan.blocks, plan.threads, plan.smem, stream,
            )
        else:
            scratch, scratch_ptr = _scratch(dev, plan.floats)
            rc = lib.vt_wsb_dp_scores_dense(
                S.data_ptr(), len_s.data_ptr(), len_t.data_ptr(), w_s.data_ptr(),
                w_t.data_ptr(), w_t_star.data_ptr(), out.data_ptr(),
                scratch_ptr, c, L, T, Q, loc, plan.blocks, plan.threads,
                plan.smem, stream,
            )
    del scratch
    _raise_on(rc, "wsb_dp[dense]")
    LAUNCHES["wsb_dp[dense]"] += 1
    WSB_ROUTE_LAUNCHES["dense_" + plan.route] += 1
    return out
