"""Multi-device serving of the port (``parallel/mesh.py``) against the JAX
package's mesh, on the CPU.

The port's mesh is a list of torch devices (here ``["cpu"] * k``); the JAX
package's is the conftest's 8 virtual CPU devices.  With the same seeded
numpy inputs, ``_merge_local_topk`` and ``MeshSearch.score_topk_multiquery``
/ ``score_topk`` / ``score_topk_shardmap`` return what the JAX package's
return: the same candidate sets, scores within 1e-6 (bit-equal for an f32
table under affine gaps), the same ``next_best``; over the quantized tables
and the tagged, general-gap, boosted and filtered shard forms.  Then the
index: ``find_batch(mesh=)`` and ``find(mesh=)`` give the port's
single-device (slice_id, score) lists byte for byte at mesh sizes 1, 3 (it
divides no bucket) and 8, under int8 and f32 ranking, affine and general
gaps and the query options, and agree with the JAX package's
``find_batch(mesh=)`` within 1e-6 (ids may differ only inside bands of
tied scores).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

import vectorian_tpu as vj
import vectorian_tpu_torch as vt
from vectorian_tpu.alignment import ExponentialGapCost as JaxExponential
from vectorian_tpu.alignment import LocalAlignment as JaxLocal
from vectorian_tpu.metrics import EmbeddingTokenSim as JaxTokenSim
from vectorian_tpu.metrics import OptimizedSpanSim as JaxSpanSim
from vectorian_tpu.ops.alignment import AffineGapParams as JaxGaps
from vectorian_tpu.ops.search import gap_vec as jax_gap_vec
from vectorian_tpu.parallel import mesh as jax_mesh
from vectorian_tpu_torch.alignment import ExponentialGapCost, LocalAlignment
from vectorian_tpu_torch.metrics import EmbeddingTokenSim, OptimizedSpanSim
from vectorian_tpu_torch.ops.alignment import AffineGapParams
from vectorian_tpu_torch.ops.search import DocFilterSpec
from vectorian_tpu_torch.parallel import mesh as port_mesh

from tests.test_torch_slice import _assert_same_ranking, _corpus, _pairs

torch.set_num_threads(2)

SIZES = [1, 3, 8]


@pytest.fixture(scope="module")
def jax_ms():
    assert len(jax.devices()) == 8, jax.devices()
    return jax_mesh.MeshSearch(jax_mesh.make_mesh())


def _port_ms(k=8):
    return vt.MeshSearch(vt.make_mesh(["cpu"] * k))


# ---- the mesh itself -------------------------------------------------------


def test_make_mesh_takes_the_devices_it_is_given():
    m = vt.make_mesh(["cpu", torch.device("cpu"), "cpu"])
    assert len(m) == 3 and all(d == torch.device("cpu") for d in m.devices)
    ms = vt.MeshSearch(m)
    assert ms.n_devices == 3 and ms.mesh is m
    assert vt.MeshSearch.of(ms) is ms
    with pytest.raises(ValueError):
        vt.make_mesh([])
    with pytest.raises(TypeError):
        vt.MeshSearch(object())


def test_make_mesh_without_a_card_raises_and_never_takes_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match=r"make_mesh\(\['cpu'\] \* k\)"):
        vt.make_mesh()
    with pytest.raises(RuntimeError):
        vt.MeshSearch()


def test_shards_and_replicas():
    ms = _port_ms(3)
    x = np.arange(14 * 2, dtype=np.int32).reshape(14, 2)
    sh = ms.shard_rows(x)
    assert sh.shard_n == 5 and sh.shape == (15, 2)
    assert [tuple(p.shape) for p in sh.parts] == [(5, 2), (5, 2), (4, 2)]
    assert [sh.bounds(i) for i in range(3)] == [(0, 5), (5, 10), (10, 14)]
    assert np.array_equal(torch.cat(sh.parts).numpy(), x)
    # a tensor on the shard's device is sharded by views, not copies
    t = torch.arange(20.0).reshape(10, 2)
    tv = ms.shard_rows(t)
    assert all(p.data_ptr() == t[r0:].data_ptr()
               for p, (r0, _) in zip(tv.parts, map(tv.bounds, range(3))))
    # more devices than rows: the last shards hold none
    tiny = vt.MeshSearch(vt.make_mesh(["cpu"] * 8)).shard_rows(x[:3])
    assert [int(p.shape[0]) for p in tiny.parts] == [1, 1, 1, 0, 0, 0, 0, 0]
    rep = ms.put_replicated(x)
    assert list(rep.copies) == [torch.device("cpu")]
    assert np.array_equal(rep.copies[torch.device("cpu")].numpy(), x)


def _jax_merge(jax_ms, scores, shard_n, k, with_next):
    try:
        from jax import shard_map
    except ImportError:  # older jax
        from jax.experimental.shard_map import shard_map
    n_dev = jax_ms.n_devices
    fn = shard_map(
        lambda s: jax_mesh._merge_local_topk(s, "data", shard_n, n_dev, k, with_next),
        mesh=jax_ms.mesh, in_specs=(P("data"),),
        out_specs=(P(),) * (3 if with_next else 2), check_vma=False)
    return [np.asarray(x) for x in fn(jnp.asarray(scores))]


def _same_candidates(a_s, a_i, b_s, b_i):
    """Equal scores column by column; equal (id, score) sets among the
    finite entries (random floats have no ties)."""
    np.testing.assert_array_equal(a_s, b_s)
    for q in range(a_s.shape[0]):
        fa, fb = np.isfinite(a_s[q]), np.isfinite(b_s[q])
        assert set(zip(a_i[q][fa].tolist(), a_s[q][fa].tolist())) == set(
            zip(b_i[q][fb].tolist(), b_s[q][fb].tolist()))


@pytest.mark.parametrize("n_rows,k", [(64, 5), (61, 5), (61, 8), (13, 4), (13, 40)])
@pytest.mark.parametrize("with_next", [False, True])
def test_merge_local_topk_matches_jax(jax_ms, n_rows, k, with_next):
    """The host merge of the shards' local top-k = the JAX package's
    all-gather merge: kout, the candidates, ``next_best``; empty slices
    (-inf) and the pad rows of a mesh that divides no bucket included."""
    rng = np.random.default_rng(n_rows + k)
    Q, n_dev = 3, 8
    shard_n = -(-n_rows // n_dev)
    scores = rng.uniform(0, 1, size=(n_rows, Q)).astype(np.float32)
    scores[rng.integers(0, n_rows, size=3)] = -np.inf
    padded = np.full((shard_n * n_dev, Q), -np.inf, np.float32)
    padded[:n_rows] = scores
    want = _jax_merge(jax_ms, padded, shard_n, min(k, shard_n * n_dev), with_next)
    ms = _port_ms(n_dev)
    sh = ms.shard_rows(scores)
    local, rows = [], []
    for i, part in enumerate(sh.parts):
        r0, r1 = sh.bounds(i)
        rows.append(r1 - r0)
        local.append(None if r1 == r0 else tuple(
            t.numpy() for t in port_mesh._local_topk(part, min(k, shard_n * n_dev),
                                                      shard_n, with_next)))
    got = port_mesh._merge_local_topk(local, rows, shard_n,
                                      min(k, shard_n * n_dev), with_next)
    assert len(got) == len(want)
    _same_candidates(got[0], got[1], want[0], want[1])
    if with_next:
        np.testing.assert_array_equal(got[2], want[2])


@pytest.mark.parametrize("n_rows,k", [(64, 5), (61, 5), (61, 8), (13, 4), (13, 40)])
@pytest.mark.parametrize("n_dev", [1, 3, 8])
def test_serving_merge_is_merge_local_topk(n_rows, k, n_dev):
    """The serving batches' merge (each shard a pending entry of
    ``BucketTopKSource``, as ``MeshSearch.pending`` makes them; its
    ``initial`` over the entries' top-(k+1)) returns the candidates and the
    next-best bound of ``_merge_local_topk`` on the same shard outputs."""
    from vectorian_tpu_torch.ops.search import BucketTopKSource

    rng = np.random.default_rng(n_rows * n_dev + k)
    Q = 3
    scores = rng.uniform(0, 1, size=(n_rows, Q)).astype(np.float32)
    scores[rng.integers(0, n_rows, size=3)] = -np.inf
    ms = _port_ms(n_dev)
    sh = ms.shard_rows(torch.as_tensor(scores))
    shard_n = sh.shard_n
    kk = min(k, shard_n * n_dev)
    local, rows, pending = [], [], []
    for i, part in enumerate(sh.parts):
        r0, r1 = sh.bounds(i)
        rows.append(r1 - r0)
        local.append(None if r1 == r0 else tuple(
            t.numpy() for t in port_mesh._local_topk(part, kk, shard_n, True)))
        if r1 > r0:
            pending.append(({"n": r1 - r0, "capacity": 1,
                             "slice_index": np.arange(r0, r1)}, part))
    top_s, top_i, next_best = port_mesh._merge_local_topk(local, rows, shard_n, kk, True)
    src = BucketTopKSource(None, pending, Q, k)
    for q in range(Q):
        ids, rest_max, exact = src.initial(q, k, -np.inf)
        assert exact is None
        fin = np.isfinite(top_s[q])
        assert {i for i in ids if np.isfinite(scores[i, q])} == set(top_i[q][fin].tolist())
        assert rest_max == next_best[q]


# ---- MeshSearch against the JAX package's -----------------------------------


def _problem(rng, N=64, L=12, T=8, Q=4, V=300):
    tokens = rng.integers(1, V, size=(N, L)).astype(np.int32)
    lengths = rng.integers(0, L + 1, size=N).astype(np.int32)
    sim = rng.uniform(0, 1, size=(V, T, Q)).astype(np.float32)
    len_t = rng.integers(1, T + 1, size=Q).astype(np.int32)
    pos = rng.integers(0, 6, size=(N, L)).astype(np.int8)
    tag = rng.integers(0, 9, size=(N, L)).astype(np.int16)
    return tokens, lengths, sim, len_t, pos, tag


def _quantized(sim, form):
    """The stacked table at ``form``'s precision for the JAX package and
    for the port, and its unit (the JAX package's stack_query_tables
    arithmetic; bf16 rounds to nearest even in both)."""
    if form == "int8":
        scale = np.float32(max(float(np.abs(sim).max()), 1e-9) / np.float32(127.0))
        q = np.round(sim / scale).astype(np.int8)
        return q, torch.from_numpy(q), scale
    if form == "bfloat16":
        return (np.asarray(jnp.asarray(sim, jnp.bfloat16)),
                torch.from_numpy(sim).to(torch.bfloat16), np.float32(1.0))
    return sim, torch.from_numpy(sim), np.float32(1.0)


FORMS = ["float32", "int8", "bfloat16", "tagged", "general", "boost", "filter"]


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("with_next", [False, True])
def test_score_topk_multiquery_matches_jax(jax_ms, form, with_next):
    rng = np.random.default_rng(FORMS.index(form))
    N, L, T, Q, k = 61, 12, 8, 4, 6
    tokens, lengths, sim, len_t, pos, tag = _problem(rng, N=N, L=L, T=T, Q=Q)
    nt = len_t.astype(np.float32) + np.float32(0.5)
    g = (0.2, 0.1, 0.2, 0.1)
    table, table_t, scale = _quantized(sim, form)
    kw_j, kw_t = {}, {}
    if form == "tagged":
        w = rng.uniform(0.2, 1.0, size=(T, Q)).astype(np.float32)
        p = rng.integers(0, 6, size=(T, Q)).astype(np.int8)
        pen = rng.uniform(0, 0.5, size=Q).astype(np.float32)
        thr = rng.uniform(0, 0.2, size=Q).astype(np.float32)
        kw_j = dict(tw_args=tuple(jax_ms.put_replicated(a) for a in (w, p, pen, thr)),
                    with_tags=True)
        kw_t = dict(tw_args=(w.T.copy(), p.T.copy(), pen, thr))
    elif form == "general":
        kw_j = dict(gap_vecs=(jax_ms.put_replicated(jax_gap_vec(JaxExponential(3.0), L + 1)),
                              jax_ms.put_replicated(jax_gap_vec(JaxExponential(3.0), T + 1))),
                    general_gaps=True)
        kw_t = dict(gap_costs=(ExponentialGapCost(3.0), ExponentialGapCost(3.0)))
    elif form == "boost":
        boost = rng.uniform(0.5, 1.6, size=(N, Q)).astype(np.float32)
        bpad = np.ones((-(-N // 8) * 8, Q), np.float32)
        bpad[:N] = boost
        kw_j = dict(boost=jax.device_put(bpad, jax_ms._sharded), with_boost=True)
        kw_t = dict(boost=_port_ms().shard_rows(boost))
    elif form == "filter":
        masks = (np.arange(6) == 2, np.arange(9) == 5, np.arange(300) % 7 == 0)
        kw_j = dict(flt_args=tuple(jax_ms.put_replicated(m) for m in masks),
                    with_filter=True)
        kw_t = dict(doc_filter=DocFilterSpec(*masks))
    if form in ("tagged", "filter"):
        pad = (-N) % 8
        kw_j["pos_ids"] = jax.device_put(np.pad(pos, ((0, pad), (0, 0))), jax_ms._sharded)
        kw_j["tag_ids"] = jax.device_put(np.pad(tag, ((0, pad), (0, 0))), jax_ms._sharded)
        kw_t["pos_ids"] = _port_ms().shard_rows(pos)
        kw_t["tag_ids"] = _port_ms().shard_rows(tag)
    tok_j, len_j = jax_ms.shard_bucket(tokens, lengths)
    want = jax_ms.score_topk_multiquery(
        tok_j, len_j, jax_ms.put_replicated(table), jnp.asarray(len_t),
        JaxGaps.of(*g), jnp.asarray(nt), locality="local", k=k,
        sim_scale=jnp.asarray(scale), with_next=with_next, **kw_j)
    ms = _port_ms()
    tok_t, len_t_sh = ms.shard_bucket(tokens, lengths)
    got = ms.score_topk_multiquery(
        tok_t, len_t_sh, table_t, len_t, AffineGapParams.of(*g), nt,
        locality="local", k=k, sim_scale=scale, with_next=with_next, **kw_t)
    want = [np.asarray(x) for x in want]
    assert got[0].shape == want[0].shape == (Q, k)
    if form == "float32":
        _same_candidates(got[0], got[1], want[0], want[1])
    else:
        np.testing.assert_allclose(got[0], want[0], rtol=1e-6, atol=1e-7)
        for q in range(Q):
            f = np.isfinite(want[0][q])
            assert set(got[1][q][f].tolist()) == set(want[1][q][f].tolist())
    if with_next:
        np.testing.assert_allclose(got[2], want[2], rtol=1e-6, atol=1e-7)


def test_score_topk_and_shardmap_match_jax(jax_ms):
    rng = np.random.default_rng(7)
    tokens, lengths, sim, _, _, _ = _problem(rng, N=128, T=4, Q=1)
    sim = sim[:, :, 0]
    g = (0.1, 0.05, 0.1, 0.05)
    tok_j, len_j = jax_ms.shard_bucket(tokens, lengths)
    ms = _port_ms()
    tok_t, len_t = ms.shard_bucket(tokens, lengths)
    for fn in ("score_topk", "score_topk_shardmap"):
        want = getattr(jax_ms, fn)(
            tok_j, len_j, jax_ms.put_replicated(sim), jnp.asarray(4, jnp.int32),
            JaxGaps.of(*g), jnp.asarray(4.0, jnp.float32), locality="local", k=8)
        got = getattr(ms, fn)(tok_t, len_t, sim, 4, AffineGapParams.of(*g), 4.0,
                              locality="local", k=8)
        _same_candidates(got[0][None], got[1][None], np.asarray(want[0])[None],
                         np.asarray(want[1])[None])


# ---- the index ------------------------------------------------------------


@pytest.fixture(scope="module")
def both():
    words, mat, texts, queries = _corpus()
    sj = vj.Session(
        [vj.StringImporter()(t, title=f"d{i}") for i, t in enumerate(texts)],
        embeddings=[vj.KeyedVectors("toy", words, mat)],
    )
    st = vt.Session(
        [vt.StringImporter()(t, title=f"d{i}") for i, t in enumerate(texts)],
        embeddings=[vt.KeyedVectors("toy", words, mat)], device="cpu",
    )
    return sj, st, queries


def _indexes(sj, st, general=False, **span):
    ij = sj.partition("sentence").index(JaxSpanSim(
        JaxTokenSim(sj.embeddings[0]),
        JaxLocal(JaxExponential(3.0)) if general else JaxLocal(), **span))
    it = st.partition("sentence").index(OptimizedSpanSim(
        EmbeddingTokenSim(st.embeddings[0]),
        LocalAlignment(ExponentialGapCost(3.0)) if general else LocalAlignment(), **span))
    return ij, it


def _batch(ix, queries, **kw):
    return [_pairs(r) for r in ix.find_batch(queries, **kw)]


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("precision", ["int8", "float32"])
@pytest.mark.parametrize("general", [False, True])
def test_find_batch_mesh_is_the_single_device_batch(both, jax_ms, size, precision,
                                                    general):
    sj, st, queries = both
    ij, it = _indexes(sj, st, general)
    qs = queries + [""]
    kw = dict(n=5, min_score=0.1, sim_precision=precision)
    want = _batch(it, qs, **kw)
    assert any(want)
    got = _batch(it, qs, mesh=vt.make_mesh(["cpu"] * size), **kw)
    assert got == want
    assert got[-1] == []
    if size == 8:
        for w, g in zip(_batch(ij, qs, mesh=jax_ms, **kw), got):
            _assert_same_ranking(w, g, 0.1)


@pytest.mark.parametrize("size", SIZES)
def test_find_mesh_is_find(both, size):
    """find(mesh=) serves one query over the mesh: find's bytes, the
    query options (bidirectional + submatch) riding through."""
    _, st, queries = both
    it = _indexes_port(st)
    ms = vt.MeshSearch(vt.make_mesh(["cpu"] * size))
    for q in queries[:3] + [""]:
        assert _pairs(it.find(q, n=5, min_score=0.1, mesh=ms)) == _pairs(
            it.find(q, n=5, min_score=0.1))
    kw = dict(n=4, min_score=0.0, bidirectional=True, submatch_weight=0.5)
    for q in queries[:3]:
        assert _pairs(it.find(q, mesh=ms, **kw)) == _pairs(it.find(q, **kw))


def _indexes_port(st, general=False, **span):
    return st.partition("sentence").index(OptimizedSpanSim(
        EmbeddingTokenSim(st.embeddings[0]),
        LocalAlignment(ExponentialGapCost(3.0)) if general else LocalAlignment(), **span))


def test_find_mesh_forwards_run_task_and_disable_progress(both, monkeypatch):
    _, st, queries = both
    it = _indexes_port(st)
    seen = {}
    real = type(it).find_batch

    def spy(self, texts, **kw):
        seen.update(kw)
        return real(self, texts, **kw)

    monkeypatch.setattr(type(it), "find_batch", spy)
    task = object()
    mesh = vt.make_mesh(["cpu"] * 2)
    it.find(queries[0], n=3, mesh=mesh, run_task=task, disable_progress=True)
    assert seen["run_task"] is task and seen["disable_progress"] is True
    assert seen["mesh"] is mesh


def test_find_batch_mesh_debug_stays_on_the_device(both):
    """debug's payloads are per-query host diagnostics: find_batch serves
    them query by query on the session's device, a mesh argument
    notwithstanding, and the bytes are find's."""
    _, st, queries = both
    it = _indexes_port(st)
    seen = []
    got = _batch(it, queries[:2], n=3, mesh=vt.make_mesh(["cpu"] * 3),
                 debug=lambda name, payload: seen.append(name))
    assert seen and got == [_pairs(it.find(q, n=3)) for q in queries[:2]]


OPTIONS = {
    "filter": {"token_filter": ["the", "sun"]},
    "bidirectional": {"bidirectional": True},
    "submatch": {"submatch_weight": 0.5},
}


@pytest.mark.parametrize("size", [3, 8])
@pytest.mark.parametrize("option", sorted(OPTIONS) + ["booster"])
@pytest.mark.parametrize("general", [False, True])
def test_find_batch_mesh_options(both, size, option, general):
    _, st, queries = both
    it = _indexes_port(st, general)
    kw = dict(OPTIONS.get(option, {}))
    if option == "booster":
        kw["booster"] = vt.Saliency(0.7).add_signal(vt.KeywordSignal("sun"), 1.0)
    kw.update(n=4, min_score=0.05)
    want = _batch(it, queries, **kw)
    assert any(want)
    assert _batch(it, queries, mesh=vt.make_mesh(["cpu"] * size), **kw) == want


@pytest.mark.parametrize("size", SIZES)
def test_find_batch_mesh_tag_weighted(both, jax_ms, size):
    sj, st, queries = both
    tw = dict(tag_weights={"NN": 1.0, "VB": 0.9, "JJ": 0.7, "DT": 0.2},
              pos_mismatch_penalty=0.2, similarity_threshold=0.1)
    ij, it = _indexes(sj, st, **tw)
    kw = dict(n=5, min_score=-5.0)
    want = _batch(it, queries, **kw)
    got = _batch(it, queries, mesh=vt.make_mesh(["cpu"] * size), **kw)
    assert got == want
    if size == 8:
        for w, g in zip(_batch(ij, queries, mesh=jax_ms, **kw), got):
            _assert_same_ranking(w, g, -5.0)


def _ties_session():
    """Few distinct sentences, each repeated: every candidate set's n-th
    score ties with slices outside it, so every cut is unsafe."""
    words = ["sun", "moon", "shines", "over", "the", "sea", "stars", "night"]
    mat = np.random.default_rng(3).normal(size=(len(words), 8)).astype(np.float32)
    sents = ["the sun shines over the sea.", "stars at night.", "the moon shines."]
    texts = [" ".join(sents * 20) for _ in range(5)]
    return vt.Session([vt.StringImporter()(t, title=f"d{i}") for i, t in enumerate(texts)],
                      embeddings=[vt.KeyedVectors("toy", words, mat)], device="cpu")


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("submatch", [False, True])
def test_unsafe_cut_selects_on_the_shards(monkeypatch, size, submatch):
    """Ties across the overfetch make the merged cut unsafe: the
    finalizer's tie-bounded extras round selects on the shards' scores
    where they lie (one select a round, never a full read), and the bytes
    stay the single-device batch's."""
    from vectorian_tpu_torch.ops.search import BucketTopKSource

    st = _ties_session()
    it = _indexes_port(st)
    kw = dict(n=2, min_score=0.1)
    if submatch:
        kw["submatch_weight"] = 0.5
    queries = ["the sun shines", "stars at night"]
    want = _batch(it, queries, **kw)
    selects = []
    real = BucketTopKSource.above_vals_many

    def count(self, reqs):
        selects.append(len(self._pending))
        return real(self, reqs)

    monkeypatch.setattr(BucketTopKSource, "above_vals_many", count)
    ms = vt.MeshSearch(vt.make_mesh(["cpu"] * size))
    got = _batch(it, queries, mesh=ms, **kw)
    assert got == want
    # one pending entry a shard with rows
    n_entries = sum(sum(int(p.shape[0]) > 0 for p in sh[0].parts)
                    for _, sh in ms.bucket_shards(it._engine))
    assert selects == [n_entries]


def test_paged_session_serves_the_mesh(both):
    """A paged session's mesh serves from shards resident on the mesh's
    devices, with resident mode's bytes."""
    words, mat, texts, queries = _corpus()
    sp = vt.Session([vt.StringImporter()(t, title=f"d{i}") for i, t in enumerate(texts)],
                    embeddings=[vt.KeyedVectors("toy", words, mat)], device="cpu",
                    paged=True)
    _, st, _ = both
    want = _batch(_indexes_port(st), queries, n=5, min_score=0.1)
    ip = _indexes_port(sp)
    assert _batch(ip, queries, n=5, min_score=0.1, mesh=vt.make_mesh(["cpu"] * 3)) == want
