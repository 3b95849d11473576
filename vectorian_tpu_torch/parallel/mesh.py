"""Multi-device data-parallel search over a list of torch devices.

Counterpart of vectorian_tpu/parallel/mesh.py.  The JAX package shards the
packed slice arrays over a JAX device mesh: each chip scores its
shard of slices against the replicated query tables, takes a local top-k,
and one all-gather of (score, slice) pairs merges them (the reference's
``ResultSet.extend``, result_set.h:70-93).  The port keeps the single
controller: a mesh is a list of torch devices in which a device may repeat
(``Mesh``), a sharded array one block of rows a device (``Sharded``), a
replicated one a copy a distinct device (``Replicated``).  The same code
serves k distinct cards and k shards on one card.

Each shard runs the kernels the single-device corpus pass runs, through the
same functions: ``search.MultiQueryPass`` for static plans (kernels 1 and 3
over the gathered table, at the f32, bf16 and int8 tables and with the
tag-weighted block), ``search.TreePass`` for contextual plans and mixed
trees (their dense entries), and ``wmd._bucket_rwmd_scores_multi`` /
``_bucket_emd_scores_multi`` for the transport metrics (the ``*_scores``
methods).  Every shard of a call is dispatched before any is read, so on
k distinct cards the k passes run at once.  No shard's scores leave its
device: each hands back its local top-k (values and row ids, queued to
the host behind its own kernels), and the host merges them.  The
``*_topk_multiquery`` methods return that merge (``_merge_local_topk``,
the JAX package's semantics); the index's batches hand the shards to the
single-device finalizers' candidate source instead (``MeshSearch.pending``:
a shard an entry of ``search.BucketTopKSource``, the same local top-k and
host merge), whose extras rounds select on the shards in place.
"""

from __future__ import annotations

import contextlib
from typing import List, Optional

import numpy as np
import torch

from vectorian_tpu_torch.ops.search import (
    NEG_SCORE,
    MultiQueryPass,
    TreePass,
    _HostCopies,
    compact_rows,
)
from vectorian_tpu_torch.ops.simmatrix import QueryPlan
from vectorian_tpu_torch.utils import trace


def _device(d) -> torch.device:
    """``d`` as a torch.device with its index (a bare "cuda" is the current
    card)."""
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


class Mesh:
    """An ordered list of devices, one shard each; a device may repeat."""

    def __init__(self, devices):
        self.devices = tuple(_device(d) for d in devices)
        if not self.devices:
            raise ValueError("a mesh needs at least one device")

    def __len__(self) -> int:
        return len(self.devices)

    def __repr__(self) -> str:
        return f"Mesh({[str(d) for d in self.devices]})"


def make_mesh(devices=None) -> Mesh:
    """A mesh over ``devices`` (torch devices or their names, in shard
    order; a device may repeat), by default every visible CUDA card.  It
    never falls back to the CPU on its own: with no card and no
    ``devices`` it raises."""
    if devices is None:
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if count == 0:
            raise RuntimeError(
                "make_mesh() takes every visible CUDA device and none is "
                "available; pass the devices, e.g. make_mesh(['cpu'] * k)"
            )
        devices = [torch.device("cuda", i) for i in range(count)]
    return Mesh(devices)


def _on(dev: torch.device):
    """The context a shard's work is queued under: its card as the current
    device (its current stream), nothing on the CPU."""
    return torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext()


def _to(x, dev: torch.device) -> torch.Tensor:
    """``x`` (numpy, a tensor, or a ``Replicated``) on ``dev``; a tensor
    already there is returned as it is (a row block of it stays a view)."""
    if isinstance(x, Replicated):
        return x.copies[dev]
    if isinstance(x, torch.Tensor):
        return x.to(dev)
    return torch.as_tensor(np.ascontiguousarray(x), device=dev)


class Sharded:
    """The rows of an [N, ...] array over a mesh: shard i holds rows
    [i * shard_n, min((i + 1) * shard_n, N)) on the mesh's i-th device,
    shard_n = ceil(N / devices).  The JAX package pads the rows with zeros
    to a multiple of the mesh; here the pad rows are implicit: the last
    shards hold fewer real rows (or none), and in a merge a pad row is an
    empty slice's score (``shape`` counts them, as the JAX package's
    padded arrays do)."""

    def __init__(self, parts: List[torch.Tensor], n_rows: int, shard_n: int):
        self.parts = parts
        self.n_rows = n_rows
        self.shard_n = shard_n

    @property
    def shape(self):
        return (self.shard_n * len(self.parts),) + tuple(self.parts[0].shape[1:])

    def bounds(self, i: int):
        """Shard i's real rows: [r0, r1) of the array."""
        r0 = min(i * self.shard_n, self.n_rows)
        return r0, min(r0 + self.shard_n, self.n_rows)


class Replicated:
    """One copy of an array a distinct device of a mesh."""

    def __init__(self, copies: dict):
        self.copies = copies


def _local_topk(scores, k: int, shard_n: int, with_next: bool):
    """A shard's local top of its [rows, Q] scores on its device: (values,
    row ids) [Q, min(kf, rows)] with kf = min(ks + 1, shard_n) where
    ``with_next`` (the (ks+1)-th bounds the shard's rest) else ks, ks =
    min(k, shard_n)."""
    ks = min(k, shard_n)
    kf = min(ks + 1, shard_n) if with_next else ks
    return torch.topk(scores.T, min(kf, int(scores.shape[0])), dim=1)


def _merge_local_topk(local, rows, shard_n: int, k: int, with_next: bool,
                      pad: float = -np.inf):
    """The host merge of the shards' local top-k (the JAX package's
    ``_merge_local_topk`` after its all-gather).  ``local[i]``: shard i's
    (values, row ids) of ``_local_topk`` as host arrays, None for a shard
    without real rows; ``rows[i]`` its real rows, the rest of its shard_n
    pad rows scoring ``pad`` (-inf: an empty slice of the alignment
    passes; the transport passes' NEG_SCORE).  Returns ([Q, kout] scores,
    [Q, kout] global row ids[, [Q] next_best]) with ks = min(k, shard_n)
    a shard's share and kout = min(k, devices * ks): a k at or past the
    padded rows returns every row.  ``next_best`` bounds every score
    outside the returned set: the best of each shard's (ks+1)-th and of
    the merge's (kout+1)-th, -inf where there is none."""
    n_dev = len(rows)
    ks = min(k, shard_n)
    kout = min(k, n_dev * ks)
    kf = min(ks + 1, shard_n) if with_next else ks
    Q = next(vals.shape[0] for vals, _ in filter(None, local))
    S = np.full((Q, n_dev, kf), pad, np.float32)
    ids = np.zeros((Q, n_dev, kf), np.int64)
    for i in range(n_dev):
        base, c = i * shard_n, 0
        if local[i] is not None:
            vals, idx = local[i]
            c = vals.shape[1]
            S[:, i, :c] = vals
            ids[:, i, :c] = idx + base
        # the shard's pad rows follow its real ones
        ids[:, i, c:] = base + rows[i] + np.arange(kf - c)
    shard_next = None
    if with_next:
        shard_next = (S[:, :, ks].max(axis=1) if kf > ks
                      else np.full((Q,), -np.inf, np.float32))
        S, ids = S[:, :, :ks], ids[:, :, :ks]
    all_s = S.reshape(Q, n_dev * ks)
    all_i = ids.reshape(Q, n_dev * ks)
    kk = min(kout + 1, n_dev * ks) if with_next else kout
    sel = np.argsort(-all_s, axis=1, kind="stable")[:, :kk]
    top_s = np.take_along_axis(all_s, sel, axis=1)
    top_i = np.take_along_axis(all_i, sel[:, :kout], axis=1)
    if not with_next:
        return top_s, top_i
    merge_next = top_s[:, kout] if kk > kout else np.full((Q,), -np.inf, np.float32)
    return top_s[:, :kout], top_i, np.maximum(shard_next, merge_next)


def _empty_to_neg_inf(scores):
    """An alignment pass's scores with its empty slices (NEG_SCORE) at -inf,
    the JAX mesh's value for them."""
    return scores.masked_fill(scores <= NEG_SCORE, -np.inf)


class MeshSearch:
    """Data-parallel bucket scoring and global top-k over a ``Mesh``."""

    def __init__(self, mesh: Optional[Mesh] = None):
        if mesh is None:
            mesh = make_mesh()
        if not isinstance(mesh, Mesh):
            raise TypeError(f"MeshSearch takes a Mesh (make_mesh), not "
                            f"{type(mesh).__name__}")
        self._mesh = mesh
        self._distinct = tuple(dict.fromkeys(mesh.devices))

    @classmethod
    def of(cls, mesh) -> "MeshSearch":
        """``mesh`` itself if it is a MeshSearch, else a MeshSearch over it
        (TypeError for anything but a Mesh)."""
        return mesh if isinstance(mesh, MeshSearch) else cls(mesh)

    @property
    def mesh(self) -> Mesh:
        return self._mesh

    @property
    def n_devices(self) -> int:
        return len(self._mesh.devices)

    def shard_rows(self, x) -> Sharded:
        """The rows of ``x`` (numpy or a tensor) split over the mesh, each
        block put on its device; a block of a tensor already on its device
        is a view of it, not a copy."""
        n = int(x.shape[0])
        shard_n = max(1, -(-n // self.n_devices))
        parts = []
        for i, dev in enumerate(self._mesh.devices):
            r0 = min(i * shard_n, n)
            parts.append(_to(x[r0:min(r0 + shard_n, n)], dev))
        return Sharded(parts, n, shard_n)

    def shard_bucket(self, token_ids, lengths):
        """A bucket's token ids and lengths (int32) sharded along the slice
        axis."""
        return (self.shard_rows(np.asarray(token_ids, np.int32)),
                self.shard_rows(np.asarray(lengths, np.int32)))

    def put_replicated(self, x) -> Replicated:
        """One copy of ``x`` on each distinct device of the mesh."""
        return Replicated({d: _to(x, d) for d in self._distinct})

    def bucket_shards(self, engine):
        """[(bucket, (token ids, lengths, pos ids, tag ids) ``Sharded``)] of
        every live bucket of ``engine`` (a ``search.BruteForceEngine``)
        over this mesh, built from the packing's host arrays
        (``packed.buckets[bi]``) and kept on the engine per device set: the
        corpus goes up once.  A ``Session(paged=True)`` serves a mesh from
        these shards too, resident on the mesh's devices."""
        key = ("tokens", self._mesh.devices)
        if key not in engine.mesh_shards:
            buckets = engine.packed.buckets
            engine.mesh_shards[key] = [
                (db, tuple(self.shard_rows(np.ascontiguousarray(a)) for a in (
                    buckets[db["bi"]].token_ids.astype(np.int32, copy=False),
                    buckets[db["bi"]].lengths.astype(np.int32, copy=False),
                    buckets[db["bi"]].pos_ids, buckets[db["bi"]].tag_ids)))
                for db in engine._live_buckets()
            ]
        return engine.mesh_shards[key]

    def ctx_shards(self, engine, name: str):
        """{bucket index: its [n, L, d] bf16 store of contextual embedding
        ``name`` ``Sharded`` over this mesh} (the JAX package's
        ``_ctx_mesh_shards``), kept like ``bucket_shards``: a shard on the
        engine's device is a view of the engine's store's rows, not a copy;
        a paged engine's store (pinned host memory) is copied to each
        shard's device."""
        key = ("ctx", name, self._mesh.devices)
        if key not in engine.mesh_shards:
            stores = engine._ctx_stores[name]
            engine.mesh_shards[key] = {db["bi"]: self.shard_rows(stores[db["bi"]])
                                       for db in engine._live_buckets()}
        return engine.mesh_shards[key]

    def pending(self, engine, scores_of, boosts=None, ctx_names=()):
        """A corpus pass of ``engine`` over this mesh as the pending list of
        ``search.BucketTopKSource``: ``scores_of(bucket, its shards (token
        ids, lengths, pos ids, tag ids), its [n, Q] boosts ``Sharded`` or
        None, its contextual shards of ``ctx_names``)`` -> [(shard i, its
        [rows, Q] scores on its device)] is dispatched for every live
        bucket before any score is read.  Each shard's rows are an entry of
        their own, so the source's per-entry top-(k+1) fetch is the mesh's
        local top-k and its ``initial`` the host merge (the JAX package's
        ``_merge_local_topk``, with its next-best bound), and its extras
        rounds select on the shards' scores where they lie.  The boosts are
        ``engine._boost_matrix``'s, sharded on the device.  (The JAX
        package's mesh runs a full-coverage round after an unsafe cut
        instead, every shard's rows to the host: a batch of 32 queries over
        1M slices at int8 took 9.2 s that way against 0.05 s on one NVIDIA
        H100 80GB HBM3 at 700 W, chip_smoke.py's phase 4m.)"""
        out = []
        with trace.span("mesh.dispatch"):
            for db, sh in self.bucket_shards(engine):
                boost = (None if boosts is None
                         else self.shard_rows(engine._boost_matrix(db, boosts)))
                ctx = [self.ctx_shards(engine, nm)[db["bi"]] for nm in ctx_names]
                for i, scores in scores_of(db, sh, boost, ctx):
                    r0, r1 = sh[0].bounds(i)
                    out.append(({"n": r1 - r0, "capacity": db["capacity"],
                                 "slice_index": db["slice_index"][r0:r1]}, scores))
        return out

    def _dispatch(self, state_of, run, ref: Sharded, *sharded):
        """[(i, run(state_of(device), *the shard's blocks))] of every shard
        i with real rows of ``ref``, in mesh order, each queued under its
        device; ``state_of`` is called once a distinct device.  Nothing is
        read back."""
        out, states = [], {}
        for i, dev in enumerate(self._mesh.devices):
            r0, r1 = ref.bounds(i)
            if r1 <= r0:
                continue
            with _on(dev):
                if dev not in states:
                    states[dev] = state_of(dev)
                parts = [None if s is None else s.parts[i] for s in sharded]
                out.append((i, run(states[dev], ref.parts[i], *parts)))
        return out

    def _topk(self, outs, ref: Sharded, k: int, with_next: bool, pad: float):
        """The merge of ``outs`` ([(i, [rows, Q] scores)]): each shard's
        local top-k queued to the host behind its own work (every shard's
        before any is waited for), then ``_merge_local_topk``."""
        copies = {}
        for i, scores in outs:
            with _on(self._mesh.devices[i]):
                copies[i] = _HostCopies(_local_topk(scores, k, ref.shard_n, with_next))
        rows = [r1 - r0 for r0, r1 in map(ref.bounds, range(self.n_devices))]
        with trace.span("mesh.wait"):
            local = [copies[i].wait() if i in copies else None for i in range(len(rows))]
        with trace.span("mesh.merge"):
            return _merge_local_topk(local, rows, ref.shard_n, k, with_next, pad)

    def static_scores(
        self, token_ids: Sharded, lengths: Sharded, sim_multi, len_t, gaps,
        norm_total, locality: str = "local", sim_scale=1.0,
        pos_ids: Optional[Sharded] = None, tag_ids: Optional[Sharded] = None,
        tw_args=None, gap_costs=None, boost: Optional[Sharded] = None,
        doc_filter=None, cache: Optional[dict] = None,
    ):
        """[(shard i, its [rows, Q] normalized scores on its device)] of a
        static pass over the mesh: each shard runs the single-device pass's
        launch of kernel 1 or 3 over its rows (``MultiQueryPass.scores``;
        an empty slice NEG_SCORE), every shard dispatched before any is
        read.  ``sim_multi`` [V, Tpad, Q]: the stacked ranking table (f32,
        bf16 or int8 with its unit ``sim_scale``: ``search.
        stack_query_tables``); ``len_t``, ``norm_total`` [Q] on the host;
        ``gaps`` the affine costs in f32 units, or ``gap_costs`` a general
        model's (GapCost_s, GapCost_t) pair (kernel 3).  ``tw_args``: the
        tag columns (``search.corpus_tag_columns``) with ``pos_ids``;
        ``boost``: the [N, Q] per-slice multipliers; ``doc_filter``: a
        DocFilterSpec, compacting each shard's rows with ``pos_ids`` and
        ``tag_ids``.  ``cache``: a dict the caller passes to each bucket's
        call of one batch, so a distinct device builds its pass once."""
        len_t = [int(x) for x in np.asarray(len_t).reshape(-1)]
        norm_total = np.asarray(norm_total, np.float32).reshape(-1)
        table = sim_multi if isinstance(sim_multi, (torch.Tensor, Replicated)) else \
            torch.as_tensor(np.asarray(sim_multi))
        cache = {} if cache is None else cache

        def state_of(dev):
            if dev not in cache:
                cache[dev] = (
                    MultiQueryPass(_to(table, dev), np.float32(sim_scale), len_t, gaps,
                                   gap_costs, norm_total, dev, tw_args),
                    None if doc_filter is None else doc_filter.device_args(dev),
                )
            return cache[dev]

        def run(state, tok, ln, pos, tag, bst):
            mp, flt = state
            if flt is not None:
                tok, pos, ln = compact_rows(tok, pos, tag, ln, flt)
            return mp.scores(tok, ln, locality, pos, bst)

        return self._dispatch(state_of, run, token_ids, lengths, pos_ids, tag_ids, boost)

    def score_topk_multiquery(self, token_ids: Sharded, lengths: Sharded, sim_multi,
                              len_t, gaps, norm_total, locality: str = "local",
                              k: int = 10, sim_scale=1.0, with_next: bool = False,
                              **kw):
        """Serving-batch scale-out of a static pass (the JAX package's
        method of this name): ``static_scores`` (its arguments), each
        shard's local top-min(k, shard_n) per query, merged on the host.
        Returns ([Q, kout] scores, [Q, kout] row ids) with kout = min(k,
        devices * min(k, shard_n)), plus a [Q] ``next_best`` bound with
        ``with_next``; an empty (or pad) row scores -inf."""
        outs = self.static_scores(token_ids, lengths, sim_multi, len_t, gaps,
                                  norm_total, locality, sim_scale, **kw)
        return self._topk([(i, _empty_to_neg_inf(s)) for i, s in outs], token_ids, k,
                          with_next, -np.inf)

    def score_topk(self, token_ids: Sharded, lengths: Sharded, sim_vocab, len_t,
                   gaps, norm_total, locality: str = "local", k: int = 10):
        """One query's global top-k over the mesh: ([k] scores, [k] row
        ids) of ``score_topk_multiquery`` with the [V, T] table as its one
        column."""
        table = torch.as_tensor(np.asarray(sim_vocab, np.float32))[:, :, None]
        s, i = self.score_topk_multiquery(
            token_ids, lengths, table, [int(np.asarray(len_t))], gaps,
            [float(np.asarray(norm_total))], locality=locality, k=k)
        return s[0], i[0]

    # the JAX package's explicit-collective variant of score_topk: here both
    # are the one local-top-k-and-merge path
    score_topk_shardmap = score_topk

    def tree_scores(
        self, plans, token_ids: Sharded, lengths: Sharded, ctx_stores, len_t, gaps,
        norm_total, locality: str = "local", gap_costs=None,
        boost: Optional[Sharded] = None, pos_ids: Optional[Sharded] = None,
        tag_ids: Optional[Sharded] = None, doc_filter=None, tag_weights=None,
        cache: Optional[dict] = None,
    ):
        """[(shard i, its [rows, Q] normalized scores on its device)] of a
        contextual or mixed-tree pass over the mesh: each shard runs the
        single-device pass over its rows (``TreePass.scores``: each chunk's
        stacked-plan evaluation, the filter's compaction, the tag rewrite,
        one launch of a dense DP entry).  ``plans``: the Q queries'
        QueryPlans of one tree; ``ctx_stores``: per contextual leaf of the
        tree (``plans[0].ctx_names``) the bucket's [N, L, d] store,
        sharded; ``cache`` as in ``static_scores``."""
        names = list(plans[0].ctx_names)
        len_t = [int(x) for x in np.asarray(len_t).reshape(-1)]
        cache = {} if cache is None else cache

        def state_of(dev):
            if dev not in cache:
                cache[dev] = TreePass(plans, len_t, gaps, locality, norm_total, dev,
                                      gap_costs, doc_filter, tag_weights)
            return cache[dev]

        def run(tp, tok, ln, pos, tag, bst, *ctx):
            view = {"tokens": tok, "lengths": ln, "pos": pos, "tag": tag,
                    "ctx": dict(zip(names, ctx))}
            return tp.scores(view, bst)

        return self._dispatch(state_of, run, token_ids, lengths, pos_ids, tag_ids,
                              boost, *ctx_stores)

    def tree_score_topk_multiquery(self, plans, token_ids: Sharded, lengths: Sharded,
                                   ctx_stores, len_t, gaps, norm_total,
                                   locality: str = "local", k: int = 10,
                                   with_next: bool = False, **kw):
        """The contextual and mixed-tree serving batch over the mesh (the
        JAX package's ``tree_score_topk_multiquery``; its
        ``ctx_score_topk_multiquery`` is the one-leaf tree): ``tree_scores``
        (its arguments), merged as in ``score_topk_multiquery``."""
        outs = self.tree_scores(plans, token_ids, lengths, ctx_stores, len_t, gaps,
                                norm_total, locality, **kw)
        return self._topk([(i, _empty_to_neg_inf(s)) for i, s in outs], token_ids, k,
                          with_next, -np.inf)

    def ctx_score_topk_multiquery(
        self, ctx_store: Sharded, lengths: Sharded, q_norm, q_unmod, q_mags, len_t,
        gaps, norm_total, metric, locality: str = "local", k: int = 10,
        with_next: bool = False, gap_costs=None, boost: Optional[Sharded] = None,
        token_ids: Optional[Sharded] = None, pos_ids: Optional[Sharded] = None,
        tag_ids: Optional[Sharded] = None, doc_filter=None,
    ):
        """The contextual serving batch over the mesh (the JAX package's
        method of this name): the stacked [T * Q, d] needle rows (row t * Q
        + q) split into Q one-leaf plans ("ctx", 0, ``metric``) and served
        by ``tree_score_topk_multiquery``.  ``token_ids`` (the pass reads
        them for the filter alone) default to zeros."""
        Q = len(np.asarray(len_t).reshape(-1))
        vecs = {key: np.asarray(v.cpu() if isinstance(v, torch.Tensor) else v, np.float32)
                for key, v in (("unmodified", q_unmod), ("normalized", q_norm),
                               ("magnitudes", q_mags))}
        T = vecs["magnitudes"].shape[0] // Q
        plans = [QueryPlan(plan=("ctx", 0, metric), ctx_names=["ctx"],
                           ctx_queries=[{key: v.reshape((T, Q) + v.shape[1:])[:, q]
                                         for key, v in vecs.items()}])
                 for q in range(Q)]
        if token_ids is None:
            L = int(ctx_store.parts[0].shape[1])
            token_ids = self.shard_rows(np.zeros((lengths.n_rows, L), np.int32))
        return self.tree_score_topk_multiquery(
            plans, token_ids, lengths, (ctx_store,), len_t, gaps, norm_total,
            locality=locality, k=k, with_next=with_next, gap_costs=gap_costs,
            boost=boost, pos_ids=pos_ids, tag_ids=tag_ids, doc_filter=doc_filter)

    def transport_scores(self, args, score, token_ids: Sharded, lengths: Sharded,
                         pos_ids: Optional[Sharded] = None,
                         tag_ids: Optional[Sharded] = None,
                         boost: Optional[Sharded] = None, ctx_stores=()):
        """[(shard i, its [rows, Q] ranking scores on its device)] of a
        transport pass: ``score(args.to(device), view, boost)`` with
        ``args`` the pass's ``wmd._MultiChunkArgs`` and ``view`` the
        shard's rows (their contextual stores of ``args.ctx_names`` under
        "ctx"); every shard dispatched before any is read."""
        def run(a, tok, ln, pos, tag, bst, *ctx):
            view = {"n": int(tok.shape[0]), "capacity": int(tok.shape[1]),
                    "tokens": tok, "lengths": ln, "ctx": dict(zip(a.ctx_names, ctx))}
            if pos is not None:
                view["pos"] = pos
            if tag is not None:
                view["tag"] = tag
            return score(a, view, bst)

        return self._dispatch(args.to, run, token_ids, lengths, pos_ids, tag_ids,
                              boost, *ctx_stores)

    def _transport_topk(self, args, score, token_ids, lengths, k, with_next,
                        pos_ids, tag_ids, boost, ctx_stores):
        outs = self.transport_scores(args, score, token_ids, lengths, pos_ids,
                                     tag_ids, boost, ctx_stores)
        return self._topk(outs, token_ids, k, with_next, NEG_SCORE)

    def rwmd_topk_multiquery(
        self, token_ids: Sharded, lengths: Sharded, sim_multi, mass_t, len_t,
        injective: bool, symmetric: bool, normalize_bow: bool, k: int = 10,
        with_next: bool = False, max_score_t=None, pos_ids=None, tag_ids=None,
        boost=None, tw_args=None, doc_filter=None, tagged: bool = False,
    ):
        """The relaxed-WMD serving batch over the mesh (the JAX package's
        method of this name): each shard's greedy-fill ranking scores
        (``wmd._bucket_rwmd_scores_multi``, the single-device batch's) and
        the merge, an empty (or pad) row at NEG_SCORE.  ``sim_multi`` [V,
        T, Q] the stacked static tables, ``mass_t`` [T, Q] the needles'
        masses, ``len_t`` / ``max_score_t`` [Q]; ``tw_args`` the tag
        columns of ``WMDEngine._tagw_args_multi`` ([T, Q] weights and pos
        ids, [Q] penalty and threshold) with ``pos_ids``; ``tagged``: the
        (id, tag) BOW identity (reads ``tag_ids``)."""
        from vectorian_tpu_torch.ops.wmd import _bucket_rwmd_scores_multi

        args = self._transport_args(sim_multi, None, tw_args, doc_filter)
        len_t = np.asarray(len_t, np.int32).reshape(-1)
        mst = (len_t.astype(np.float32) if max_score_t is None
               else np.asarray(max_score_t, np.float32).reshape(-1))
        consts = self._per_device(np.asarray(mass_t, np.float32), len_t, mst)

        def score(a, view, bst):
            return _bucket_rwmd_scores_multi(a, view, *consts(a.device), injective,
                                             symmetric, normalize_bow, False, tagged, bst)

        return self._transport_topk(args, score, token_ids, lengths, k, with_next,
                                    pos_ids, tag_ids, boost, ())

    def emd_topk_multiquery(
        self, token_ids: Sharded, lengths: Sharded, sim_multi, mags_vocab, mass_t,
        use_magnitudes: bool, normalize_mass: bool, k: int = 10,
        with_next: bool = False, pos_ids=None, tag_ids=None, boost=None,
        tw_args=None, doc_filter=None, tagged: bool = False,
    ):
        """The full-WMD / WRD serving batch over the mesh (the JAX package's
        method of this name): each shard's provable exact-score upper
        bounds (``wmd._bucket_emd_scores_multi``: ``_emd_score_bound`` on
        every shard) and the merge; ``next_best`` then bounds every exact
        score outside the returned set.  ``mags_vocab`` [V]: the
        vocabulary's magnitudes (the WRD document masses)."""
        from vectorian_tpu_torch.ops.wmd import _bucket_emd_scores_multi

        args = self._transport_args(sim_multi, mags_vocab, tw_args, doc_filter)
        consts = self._per_device(np.asarray(mass_t, np.float32))

        def score(a, view, bst):
            return _bucket_emd_scores_multi(a, view, *consts(a.device), use_magnitudes,
                                            normalize_mass, False, tagged, bst)

        return self._transport_topk(args, score, token_ids, lengths, k, with_next,
                                    pos_ids, tag_ids, boost, ())

    def plan_transport_topk_multiquery(
        self, plans, token_ids: Sharded, lengths: Sharded, ctx_stores, mass_t, len_t,
        max_score_t, relaxed: bool, injective: bool = False, symmetric: bool = False,
        normalize_bow: bool = True, use_magnitudes: bool = False,
        normalize_mass: bool = True, k: int = 10, with_next: bool = False,
        pos_ids=None, tag_ids=None, boost=None, tw_args=None, doc_filter=None,
    ):
        """The contextual / mixed-tree transport serving batch over the mesh
        (the JAX package's method of this name): the Q plans of one tree
        stacked (``search.stack_tree_plans``), each shard's relaxed
        (``relaxed``) or exact-bound ranking with position-unique BOW
        masses, merged.  ``ctx_stores``: per contextual leaf the bucket's
        store, sharded."""
        from vectorian_tpu_torch.ops.search import stack_tree_plans
        from vectorian_tpu_torch.ops.wmd import (
            _bucket_emd_scores_multi,
            _bucket_rwmd_scores_multi,
        )

        len_t = np.asarray(len_t, np.int32).reshape(-1)
        dev = self._mesh.devices[0]
        sp, T = stack_tree_plans(plans, [max(int(x), 1) for x in len_t], dev)
        args = self._transport_args(None, None, tw_args, doc_filter, sp, T, len(plans))
        mass = np.zeros((T, len(plans)), np.float32)
        m = np.asarray(mass_t, np.float32)[:T]
        mass[: m.shape[0]] = m
        mst = np.asarray(max_score_t, np.float32).reshape(-1)
        consts = self._per_device(mass, len_t, mst)

        def score(a, view, bst):
            c = consts(a.device)
            if relaxed:
                return _bucket_rwmd_scores_multi(a, view, *c, injective, symmetric,
                                                 normalize_bow, True, False, bst)
            return _bucket_emd_scores_multi(a, view, c[0], use_magnitudes,
                                            normalize_mass, True, False, bst)

        return self._transport_topk(args, score, token_ids, lengths, k, with_next,
                                    pos_ids, tag_ids, boost, tuple(ctx_stores))

    def _transport_args(self, sim_multi, mags, tw_args, doc_filter, sp=None,
                        T=None, Q=None):
        """A transport pass's ``_MultiChunkArgs`` on the mesh's first
        device (``args.to`` moves them to each shard's): over the stacked
        static table ``sim_multi`` [V, T, Q], or the stacked tree plan
        ``sp`` of Q needles padded to T."""
        from vectorian_tpu_torch.ops.wmd import _MultiChunkArgs

        dev = self._mesh.devices[0]
        table = None if sim_multi is None else _to(sim_multi, dev)
        if table is not None:
            T, Q = int(table.shape[1]), int(table.shape[2])
        tw = None if tw_args is None else tuple(_to(x, dev) for x in tw_args)
        return _MultiChunkArgs(None, table, sp, T, Q, tw, doc_filter,
                               None if mags is None else _to(mags, dev), device=dev)

    @staticmethod
    def _per_device(*arrays):
        """device -> the ``arrays`` as tensors there, made once a device."""
        cache = {}

        def get(dev):
            if dev not in cache:
                cache[dev] = tuple(torch.as_tensor(a, device=dev) for a in arrays)
            return cache[dev]

        return get
