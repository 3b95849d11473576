"""The transport metrics' batch over a mesh of CPU devices.

tests/test_torch_transport.py's corpora: relaxed WMD (nbow, bow/fast,
the default), full WMD and the Word Rotator's Distance over static,
contextual and mixed-tree plans, with tag weights, a document-side filter
and a booster.  ``find_batch(mesh=)`` shards the ranking pass; the host
rescore, the consume rounds and the exact cut are the single-device
batch's, so each query's list is the single-device batch's byte for byte
at mesh sizes 1, 3 and 8, and agrees with the JAX package's
``find_batch(mesh=)`` within 1e-6 (ids may differ only inside bands of
tied scores).  ``MeshSearch``'s relaxed and exact-bound methods hold the
JAX package's within 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vectorian_tpu_torch as vt
from vectorian_tpu.parallel import mesh as jax_mesh
from vectorian_tpu.saliency import KeywordSignal as JaxKeywordSignal
from vectorian_tpu.saliency import Saliency as JaxSaliency

from tests.test_torch_slice import _assert_same_ranking, _pairs
from tests.test_torch_transport import (
    CTX_QUERIES,
    _base_words,
    _indexes,
    cut,  # noqa: F401  (fixture)
    ctx,  # noqa: F401  (fixture)
)

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def jax_ms():
    assert len(jax.devices()) == 8, jax.devices()
    return jax_mesh.MeshSearch(jax_mesh.make_mesh())


def _batch(ix, queries, **kw):
    return [_pairs(r) for r in ix.find_batch(queries, **kw)]


@pytest.mark.parametrize("size", [1, 3, 8])
@pytest.mark.parametrize("name", ["rwmd/nbow", "rwmd/bow/fast", "rwmd/default",
                                  "wmd/nbow", "wmd/bow", "wrd"])
def test_static_mesh_batch_is_the_single_device_batch(cut, jax_ms, size, name):
    sj, st, queries = cut
    ij, it = _indexes(sj, st, name)
    qs = queries + [queries[0], ""]
    kw = dict(n=5, min_score=0.05)
    want = _batch(it, qs, **kw)
    assert any(want) and want[-1] == []
    got = _batch(it, qs, mesh=vt.make_mesh(["cpu"] * size), **kw)
    assert got == want
    if size == 8:
        for w, g in zip(_batch(ij, qs, mesh=jax_ms, **kw), got):
            _assert_same_ranking(w, g, 0.05)


@pytest.mark.parametrize("name", ["rwmd/nbow", "rwmd/bow/fast", "wmd/nbow", "wrd"])
@pytest.mark.parametrize("option", ["tags", "filter", "booster"])
def test_mesh_batch_options(cut, jax_ms, name, option):
    sj, st, queries = cut
    span, kw_j, kw_t = {}, {}, {}
    if option == "tags":
        span = {"tag_weights": {"NN": 1.0, "VB": 0.5, "JJ": 0.7},
                "pos_mismatch_penalty": 0.2, "similarity_threshold": 0.1}
    elif option == "filter":
        kw_j = kw_t = {"token_filter": [_base_words()[1]]}
    else:
        word = _base_words()[2]
        kw_j = {"booster": JaxSaliency(0.5).add_signal(JaxKeywordSignal(word), 1.0)}
        kw_t = {"booster": vt.Saliency(0.5).add_signal(vt.KeywordSignal(word), 1.0)}
    ij, it = _indexes(sj, st, name, **span)
    kw = dict(n=5, min_score=0.05)
    want = _batch(it, queries, **kw, **kw_t)
    assert any(want)
    got = _batch(it, queries, mesh=vt.make_mesh(["cpu"] * 3), **kw, **kw_t)
    assert got == want
    if option == "tags":
        for w, g in zip(_batch(ij, queries, mesh=jax_ms, **kw, **kw_j), got):
            _assert_same_ranking(w, g, 0.05)


@pytest.mark.parametrize("size", [1, 3, 8])
@pytest.mark.parametrize("plan", ["ctx", "mixed"])
@pytest.mark.parametrize("name", ["rwmd/nbow", "wmd/nbow", "wrd"])
def test_tree_mesh_batch_is_the_single_device_batch(ctx, size, plan, name):
    sj, st = ctx
    _, it = _indexes(sj, st, name, plan=plan)
    kw = dict(n=4, min_score=0.1)
    want = _batch(it, CTX_QUERIES, **kw)
    assert any(want)
    assert _batch(it, CTX_QUERIES, mesh=vt.make_mesh(["cpu"] * size), **kw) == want


def test_tree_mesh_batch_options(ctx):
    sj, st = ctx
    span = {"tag_weights": {"NN": 1.0, "VB": 0.5}, "pos_mismatch_penalty": 0.2,
            "similarity_threshold": 0.1}
    _, it = _indexes(sj, st, "wmd/nbow", plan="ctx", **span)
    kw = dict(n=4, min_score=0.1, token_filter=["the"])
    assert _batch(it, CTX_QUERIES, mesh=vt.make_mesh(["cpu"] * 3), **kw) == _batch(
        it, CTX_QUERIES, **kw)


@pytest.mark.parametrize("name", ["rwmd/nbow", "wrd"])
def test_find_mesh_of_a_transport_metric_is_find(cut, name):
    sj, st, queries = cut
    _, it = _indexes(sj, st, name)
    mesh = vt.make_mesh(["cpu"] * 3)
    for q in queries:
        assert _pairs(it.find(q, n=5, min_score=0.05, mesh=mesh)) == _pairs(
            it.find(q, n=5, min_score=0.05))


def _transport_problem(rng, N=61, L=7, T=5, Q=3, V=40):
    tokens = rng.integers(1, V, size=(N, L)).astype(np.int32)
    lengths = rng.integers(0, L + 1, size=N).astype(np.int32)
    sim = np.round(rng.uniform(0.0, 1.0, size=(V, T, Q)), 3).astype(np.float32)
    mass_t = rng.integers(0, 3, size=(T, Q)).astype(np.float32)
    mass_t[0] = 1.0
    len_t = np.asarray([T, T - 1, 2][:Q], np.int32)
    return tokens, lengths, sim, mass_t, len_t


@pytest.mark.parametrize("injective,symmetric,normalize", [
    (False, False, True), (True, False, True), (False, True, False)])
def test_rwmd_topk_multiquery_matches_jax(jax_ms, injective, symmetric, normalize):
    rng = np.random.default_rng(11)
    tokens, lengths, sim, mass_t, len_t = _transport_problem(rng)
    tok_j, len_j = jax_ms.shard_bucket(tokens, lengths)
    want = [np.asarray(x) for x in jax_ms.rwmd_topk_multiquery(
        tok_j, len_j, jax_ms.put_replicated(sim), jnp.asarray(mass_t),
        jnp.asarray(len_t), injective, symmetric, normalize, k=6, with_next=True)]
    ms = vt.MeshSearch(vt.make_mesh(["cpu"] * 8))
    tok_t, len_tt = ms.shard_bucket(tokens, lengths)
    got = ms.rwmd_topk_multiquery(tok_t, len_tt, sim, mass_t, len_t, injective,
                                  symmetric, normalize, k=6, with_next=True)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got[2], want[2], rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("use_magnitudes", [False, True])
def test_emd_topk_multiquery_matches_jax(jax_ms, use_magnitudes):
    rng = np.random.default_rng(12)
    tokens, lengths, sim, mass_t, _ = _transport_problem(rng, N=64)
    mags = rng.uniform(0.5, 2.0, size=(sim.shape[0],)).astype(np.float32)
    tok_j, len_j = jax_ms.shard_bucket(tokens, lengths)
    want = [np.asarray(x) for x in jax_ms.emd_topk_multiquery(
        tok_j, len_j, jax_ms.put_replicated(sim), jax_ms.put_replicated(mags),
        jnp.asarray(mass_t), use_magnitudes, True, k=6, chunk=8, with_next=True)]
    ms = vt.MeshSearch(vt.make_mesh(["cpu"] * 8))
    tok_t, len_tt = ms.shard_bucket(tokens, lengths)
    got = ms.emd_topk_multiquery(tok_t, len_tt, sim, mags, mass_t, use_magnitudes,
                                 True, k=6, with_next=True)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got[2], want[2], rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("relaxed", [True, False])
def test_plan_transport_topk_multiquery_is_the_bucket_pass(ctx, relaxed):
    """MeshSearch.plan_transport_topk_multiquery over a mixed tree's
    stacked plans = the top-k of the single-device pass
    (``_bucket_*_scores_multi``) over the same bucket, within 1e-6 (the
    shards' chunks evaluate the metric GEMM at other shapes)."""
    from vectorian_tpu_torch.ops import wmd
    from vectorian_tpu_torch.ops.search import stack_tree_plans

    sj, st = ctx
    _, it = _indexes(sj, st, "rwmd/nbow" if relaxed else "wmd/nbow", plan="mixed")
    pqs = [it.make_query(q).prepare(it._nlp) for q in CTX_QUERIES]
    qps = [it._compile_plan(pq, {"ctx"}) for pq in pqs]
    eng = it._engine
    db = max(eng._live_buckets(), key=lambda b: b["n"])
    lts = [max(pq.n_tokens, 1) for pq in pqs]
    sp, T = stack_tree_plans(qps, lts, eng.device)
    Q = len(qps)
    mass = np.zeros((T, Q), np.float32)
    for q, pq in enumerate(pqs):
        mass[: pq.n_tokens, q] = 1.0
    mst = np.asarray(lts, np.float32)
    args = wmd._MultiChunkArgs(eng, None, sp, T, Q, None, None)
    m_t = torch.as_tensor(mass)
    if relaxed:
        want = wmd._bucket_rwmd_scores_multi(
            args, db, m_t, torch.as_tensor(np.asarray(lts, np.int32)),
            torch.as_tensor(mst), False, False, True, True, False)
    else:
        want = wmd._bucket_emd_scores_multi(args, db, m_t, False, True, True, False)
    want = -np.sort(-want.numpy().T, axis=1)[:, :5]
    ms = vt.MeshSearch(vt.make_mesh(["cpu"] * 3))
    b = eng.packed.buckets[db["bi"]]
    got = ms.plan_transport_topk_multiquery(
        qps, ms.shard_rows(b.token_ids.astype(np.int32)),
        ms.shard_rows(b.lengths.astype(np.int32)),
        [ms.shard_rows(eng._ctx_stores["ctx"][db["bi"]])], mass, lts, mst, relaxed,
        normalize_bow=True, k=5, with_next=True)
    np.testing.assert_allclose(got[0], want, rtol=1e-6, atol=1e-6)
    assert np.all(got[2] <= got[0][:, -1] + 1e-6)
