"""Corpus packing: prepared documents -> padded, length-bucketed device arrays.

This is the TPU-native replacement for the reference's per-slice iteration
(Spans::iterate, vectorian/core/cpp/document.h:147-169): instead of walking
sentence windows one at a time on CPU threads, every slice of a Partition
becomes one row of a padded [N, L] int32 token matrix, bucketed by length so
padding waste stays bounded.  The whole corpus then lives in HBM and a single
batched gather + DP kernel scores thousands of slices at once.

Packing is done once per (corpus, normalization, partition) and reused for
every query — preserving the reference's index-free interactivity
(README.md:17-19).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np


@dataclass(frozen=True)
class Partition:
    """(level, window_size, window_step) — reference session.py:85-145."""

    level: str = "sentence"
    window_size: int = 1
    window_step: int = 1

    @property
    def contiguous(self) -> bool:
        return self.window_step <= self.window_size

    def to_args(self):
        return [self.level, self.window_size, self.window_step]


DEFAULT_BUCKETS = (8, 16, 32, 64, 128, 256, 512, 1024)


@dataclass
class PackedBucket:
    """All slices whose token length fits this bucket's capacity."""

    capacity: int
    token_ids: np.ndarray  # [N, L] i32, PAD=0
    pos_ids: np.ndarray  # [N, L] i8
    tag_ids: np.ndarray  # [N, L] i16
    lengths: np.ndarray  # [N] i32
    slice_index: np.ndarray  # [N] i32 — global slice ids into the slice table

    @property
    def n(self) -> int:
        return int(self.token_ids.shape[0])


@dataclass
class PackedCorpus:
    """Packed slice arrays for one (corpus, flavor, partition).

    The global slice table maps slice id -> (doc, slice index within doc,
    token start, token length) for result reconstruction.
    """

    partition: Partition
    buckets: List[PackedBucket]
    slice_doc: np.ndarray  # [S] i32 document index
    slice_idx: np.ndarray  # [S] i32 window index within the document
    slice_start: np.ndarray  # [S] i32 token start (filtered token space)
    slice_len: np.ndarray  # [S] i32
    n_docs: int

    @property
    def n_slices(self) -> int:
        return int(self.slice_doc.shape[0])

    @property
    def n_tokens(self) -> int:
        return int(self.slice_len.sum())

    @property
    def max_len(self) -> int:
        return int(self.slice_len.max()) if self.n_slices else 0


def save_packed(packed: PackedCorpus, path):
    """Persist packed arrays (npz) — the cache layer that keeps the
    reference's fast-loading contract (SURVEY §5 checkpoint hierarchy)."""
    data = {
        "partition": np.asarray(
            [packed.partition.window_size, packed.partition.window_step]
        ),
        "level": np.asarray([packed.partition.level]),
        "slice_doc": packed.slice_doc,
        "slice_idx": packed.slice_idx,
        "slice_start": packed.slice_start,
        "slice_len": packed.slice_len,
        "n_docs": np.asarray([packed.n_docs]),
        "n_buckets": np.asarray([len(packed.buckets)]),
    }
    for i, b in enumerate(packed.buckets):
        data[f"b{i}_cap"] = np.asarray([b.capacity])
        data[f"b{i}_tok"] = b.token_ids
        data[f"b{i}_pos"] = b.pos_ids
        data[f"b{i}_tag"] = b.tag_ids
        data[f"b{i}_len"] = b.lengths
        data[f"b{i}_idx"] = b.slice_index
    np.savez_compressed(path, **data)


def load_packed(path) -> PackedCorpus:
    z = np.load(path, allow_pickle=False)
    level = str(z["level"][0])
    ws, step = (int(x) for x in z["partition"])
    buckets = []
    for i in range(int(z["n_buckets"][0])):
        buckets.append(
            PackedBucket(
                capacity=int(z[f"b{i}_cap"][0]),
                token_ids=z[f"b{i}_tok"],
                pos_ids=z[f"b{i}_pos"],
                tag_ids=z[f"b{i}_tag"],
                lengths=z[f"b{i}_len"],
                slice_index=z[f"b{i}_idx"],
            )
        )
    return PackedCorpus(
        partition=Partition(level, ws, step),
        buckets=buckets,
        slice_doc=z["slice_doc"],
        slice_idx=z["slice_idx"],
        slice_start=z["slice_start"],
        slice_len=z["slice_len"],
        n_docs=int(z["n_docs"][0]),
    )


def pack_corpus(
    prepared_docs: Sequence,
    partition: Partition,
    bucket_sizes: Sequence[int] = DEFAULT_BUCKETS,
    max_len: Optional[int] = None,
) -> PackedCorpus:
    """Build the packed arrays.  Slices longer than the largest bucket (or
    ``max_len``) are truncated with a warning-free clamp — the reference caps
    DP indices at int16 and token lengths at uint8 similarly
    (corpus/document.py:49-51, match/matcher.h:58)."""
    cap = max_len or bucket_sizes[-1]

    doc_parts, idx_parts, start_parts, len_parts = [], [], [], []
    for pd in prepared_docs:
        ranges = np.asarray(pd.span_ranges(partition), np.int32).reshape(-1, 2)
        k = len(ranges)
        if k == 0:
            continue
        doc_parts.append(np.full((k,), pd.doc_index, np.int32))
        idx_parts.append(np.arange(k, dtype=np.int32))
        start_parts.append(ranges[:, 0])
        len_parts.append(np.minimum(ranges[:, 1] - ranges[:, 0], cap))

    if doc_parts:
        slice_doc = np.concatenate(doc_parts)
        slice_idx = np.concatenate(idx_parts)
        slice_start = np.concatenate(start_parts)
        slice_len = np.concatenate(len_parts).astype(np.int32)
    else:
        slice_doc = np.zeros((0,), np.int32)
        slice_idx = np.zeros((0,), np.int32)
        slice_start = np.zeros((0,), np.int32)
        slice_len = np.zeros((0,), np.int32)

    # flat corpus columns + absolute per-slice offsets: bucket fills become
    # row memcpys (native) or one fancy gather (numpy) instead of a
    # per-slice python loop — the reference does this walk in C++
    # (Spans::iterate document.h:147-169, unpack_tokens vocabulary.cpp:8-54)
    doc_offsets = {}
    off = 0
    flat_tok_parts, flat_pos_parts, flat_tag_parts = [], [], []
    for pd in prepared_docs:
        doc_offsets[pd.doc_index] = off
        flat_tok_parts.append(np.asarray(pd.token_ids, np.int32))
        flat_pos_parts.append(np.asarray(pd.pos_ids, np.int8))
        flat_tag_parts.append(np.asarray(pd.tag_ids, np.int16))
        off += len(pd.token_ids)
    flat_tok = np.concatenate(flat_tok_parts) if flat_tok_parts else np.zeros(0, np.int32)
    flat_pos = np.concatenate(flat_pos_parts) if flat_pos_parts else np.zeros(0, np.int8)
    flat_tag = np.concatenate(flat_tag_parts) if flat_tag_parts else np.zeros(0, np.int16)
    n_doc_ids = max(doc_offsets, default=-1) + 1
    off_by_doc = np.zeros((max(n_doc_ids, 1),), np.int64)
    for d, o in doc_offsets.items():
        off_by_doc[d] = o
    abs_start = off_by_doc[slice_doc] + slice_start

    try:
        from vectorian_tpu_torch.native import available as _native_available
        from vectorian_tpu_torch.native import pack_fill as _native_pack_fill

        use_native = _native_available()
    except ImportError:  # pragma: no cover
        use_native = False

    buckets: List[PackedBucket] = []
    nonempty = np.flatnonzero(slice_len > 0)
    lens_ne = slice_len[nonempty]
    order = np.argsort(lens_ne, kind="stable")
    sorted_ids = nonempty[order]
    sorted_lens = lens_ne[order]

    # effective bucket capacities: every slice length was clamped to
    # ``cap``, so the LAST capacity must equal cap — otherwise lengths in
    # (largest bucket <= cap, cap] would never be assigned a bucket and
    # those slices would silently never be scored
    caps = [b for b in bucket_sizes if b <= cap]
    if not caps or caps[-1] < cap:
        caps.append(cap)
    lo = 0
    for cap_i in caps:
        hi = int(np.searchsorted(sorted_lens, cap_i, side="right"))
        ids = sorted_ids[lo:hi]
        lo = hi
        if ids.size == 0:
            continue
        starts_b = abs_start[ids]
        lens_b = slice_len[ids]
        if use_native:
            tok, pos, tag = _native_pack_fill(
                flat_tok, flat_pos, flat_tag, starts_b, lens_b, cap_i
            )
        else:
            idx = starts_b[:, None] + np.arange(cap_i, dtype=np.int64)[None, :]
            mask = np.arange(cap_i)[None, :] < lens_b[:, None]
            idx = np.minimum(idx, max(len(flat_tok) - 1, 0))
            tok = np.where(mask, flat_tok[idx], 0).astype(np.int32)
            pos = np.where(mask, flat_pos[idx], 0).astype(np.int8)
            tag = np.where(mask, flat_tag[idx], 0).astype(np.int16)
        buckets.append(
            PackedBucket(
                capacity=cap_i,
                token_ids=tok,
                pos_ids=pos,
                tag_ids=tag,
                lengths=lens_b,
                slice_index=ids.astype(np.int32),
            )
        )

    return PackedCorpus(
        partition=partition,
        buckets=buckets,
        slice_doc=slice_doc,
        slice_idx=slice_idx,
        slice_start=slice_start,
        slice_len=slice_len,
        n_docs=len(prepared_docs),
    )
