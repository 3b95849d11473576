"""Contextual embeddings in the port against the JAX package, on the CPU.

The fixture of tests/test_contextual.py (``ctx_fn``: a word vector plus a
0.2 mix of its neighbours', DIM 24) over a few hundred sentences goes
through both packages: the sessions' per-token vectors and stores, the
needle's vectors, the plan's chunk evaluation and the batched contextual
pass, then ``find`` (contextual and mixed static + contextual trees) and
``find_batch`` (one contextual embedding) under affine and general gaps,
with a booster, a document-side filter, ``submatch_weight``,
``bidirectional`` and ``.pca(8)``.  Tolerance: scores within 1e-6 relative
and the same slices except inside bands of tied scores (the metric GEMMs
sum in other orders); inside the port ``find`` = ``find_batch`` byte for
byte, and ``debug`` reports the JAX package's hook sequence.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import vectorian_tpu as vj
import vectorian_tpu_torch as vt
from vectorian_tpu.alignment import ExponentialGapCost as JaxExponential
from vectorian_tpu.alignment import LocalAlignment as JaxLocal
from vectorian_tpu.embedding.contextual import LambdaContextualEmbedding as JaxLambda
from vectorian_tpu.ops.simmatrix import eval_plan_chunk as jax_eval_plan_chunk
from vectorian_tpu.saliency import KeywordSignal as JaxKeywordSignal
from vectorian_tpu.saliency import Saliency as JaxSaliency
from vectorian_tpu.sim.modifier import MaximumTokenSimilarity as JaxMaximum
from vectorian_tpu.sim.modifier import MixedTokenSimilarity as JaxMixed
from vectorian_tpu.sim.span import OptimizedSpanSim as JaxSpanSim
from vectorian_tpu.sim.token import EmbeddingTokenSim as JaxTokenSim
from vectorian_tpu_torch.alignment import ExponentialGapCost, LocalAlignment
from vectorian_tpu_torch.convert import contextual_from_numpy
from vectorian_tpu_torch.ops import dp_kernels
from vectorian_tpu_torch.ops.simmatrix import QueryPlan, eval_plan_chunk
from vectorian_tpu_torch.sim.modifier import MaximumTokenSimilarity, MixedTokenSimilarity
from vectorian_tpu_torch.sim.span import OptimizedSpanSim
from vectorian_tpu_torch.sim.token import EmbeddingTokenSim

from tests.helpers import word_vector
from tests.test_contextual import DIM, ctx_fn
from tests.test_torch_slice import _assert_same_ranking, _pairs

torch.set_num_threads(2)

WORDS = ["the", "old", "king", "rides", "grey", "horse", "cat", "sleeps",
         "dog", "runs", "fast", "a", "bird", "sings", "loud"]
QUERIES = ["the old king rides", "a bird sings loud", "cat sleeps fast",
           "grey horse runs"]


def _texts(seed=3):
    rng = np.random.default_rng(seed)
    texts = ["the old king rides the grey horse. a cat sleeps.",
             "the dog runs fast. a bird sings loud."]
    for _ in range(4):
        texts.append(" ".join(
            " ".join(rng.choice(WORDS, size=int(rng.integers(2, 9)))) + "."
            for _ in range(40)
        ))
    return texts


def _sessions(pca=None):
    texts = _texts()
    cj, ct = JaxLambda("ctx", ctx_fn, DIM), vt.LambdaContextualEmbedding("ctx", ctx_fn, DIM)
    if pca:
        cj, ct = cj.pca(pca), ct.pca(pca)
    mat = np.stack([word_vector(w, 16) for w in WORDS])
    sj = vj.Session([vj.StringImporter()(t, title=f"d{i}") for i, t in enumerate(texts)],
                    embeddings=[vj.KeyedVectors("static", WORDS, mat), cj])
    st = vt.Session([vt.StringImporter()(t, title=f"d{i}") for i, t in enumerate(texts)],
                    embeddings=[vt.KeyedVectors("static", WORDS, mat), ct], device="cpu")
    return sj, st


@pytest.fixture(scope="module")
def both():
    return _sessions()


@pytest.fixture(scope="module")
def both_pca():
    return _sessions(pca=8)


def _ctx_indexes(sj, st, general=False, tree=None, **span):
    sj_static, sj_ctx = sj.embeddings
    st_static, st_ctx = st.embeddings
    if tree is None:
        tj, tt = JaxTokenSim(sj_ctx), EmbeddingTokenSim(st_ctx)
    elif tree == "mixed":
        tj = JaxMixed([JaxTokenSim(sj_static), JaxTokenSim(sj_ctx)], [0.6, 0.4])
        tt = MixedTokenSimilarity([EmbeddingTokenSim(st_static),
                                   EmbeddingTokenSim(st_ctx)], [0.6, 0.4])
    else:
        tj = JaxMaximum([JaxTokenSim(sj_static), JaxTokenSim(sj_ctx)])
        tt = MaximumTokenSimilarity([EmbeddingTokenSim(st_static),
                                     EmbeddingTokenSim(st_ctx)])
    ij = sj.partition("sentence").index(JaxSpanSim(
        tj, JaxLocal(JaxExponential(3.0)) if general else JaxLocal(), **span))
    it = st.partition("sentence").index(OptimizedSpanSim(
        tt, LocalAlignment(ExponentialGapCost(3.0)) if general else LocalAlignment(),
        **span))
    return ij, it


def test_prepared_vectors_and_stores_equal_jax(both):
    """The per-document vectors, the bf16 device stores (both round to
    nearest even) and a needle's vectors."""
    sj, st = both
    for a, b in zip(sj.documents, st.documents):
        assert np.array_equal(a.contextual["ctx"], b.contextual["ctx"])
    assert sj._ctx_dims == st._ctx_dims == {"ctx": DIM}
    ij, it = _ctx_indexes(sj, st)
    ij._engine.ensure_contextual("ctx", sj.documents, DIM)
    it._engine.ensure_contextual("ctx", st.documents, DIM)
    for bj, bt in zip(ij._engine._ctx_stores["ctx"], it._engine._ctx_stores["ctx"]):
        n = bt.shape[0]
        want = np.asarray(jnp.asarray(bj[:n], jnp.float32))
        assert np.array_equal(bt.float().numpy(), want)
    qj = ij.make_query(QUERIES[0]).prepare(ij._nlp)
    qt = it.make_query(QUERIES[0]).prepare(it._nlp)
    vj_, vt_ = qj.contextual_vectors(sj), qt.contextual_vectors(st)
    for key in ("unmodified", "normalized", "magnitudes"):
        assert np.array_equal(vt_["ctx"][key], vj_["ctx"][key])


@pytest.mark.parametrize("tree", [None, "mixed", "max"])
def test_plan_chunk_evaluation_matches_jax(both, tree):
    """eval_plan_chunk on a bucket's chunk: the contextual leaf's metric
    GEMM, the static gather and the tree's per-cell ops (1e-6), and the
    exact rescore's fixed-shape blocks give the chunk's own bits."""
    sj, st = both
    ij, it = _ctx_indexes(sj, st, tree=tree)
    qj = ij.make_query(QUERIES[1]).prepare(ij._nlp)
    qt = it.make_query(QUERIES[1]).prepare(it._nlp)
    from vectorian_tpu.index import _pad_needle as jax_pad
    from vectorian_tpu.ops.simmatrix import compile_plan as jax_compile

    tok, strings, ctx_q, _ = jax_pad(qj, sj, ctx_names={"ctx"})
    plan_j = jax_compile(ij._args["metric"]["token_sim"], sj.compiled_embeddings,
                         tok, strings, ctx_q)
    plan_t = it._compile_plan(qt, {"ctx"})
    assert plan_t.width == 4 and not plan_t.is_static_only
    ij._engine.ensure_contextual("ctx", sj.documents, DIM)
    db_t = it._engine._device_buckets[0]
    n = db_t["n"]
    store_j = ij._engine._ctx_stores["ctx"][0][:n]
    want = np.asarray(jax_eval_plan_chunk(
        plan_j.plan, jnp.asarray(db_t["tokens"].numpy()), tuple(plan_j.static_sims),
        tuple(plan_j.static_mags), (store_j,), tuple(plan_j.ctx_queries),
        tuple(plan_j.mixed_weights))["similarity"])
    got = eval_plan_chunk(plan_t, db_t["tokens"], (it._engine._ctx_stores["ctx"][0],))
    assert np.allclose(got["similarity"].numpy(), want, rtol=1e-6, atol=1e-6)
    blocked = eval_plan_chunk(plan_t, db_t["tokens"][:5],
                              (it._engine._ctx_stores["ctx"][0][:5],), rows_block=8)
    again = eval_plan_chunk(plan_t, db_t["tokens"][3:5],
                            (it._engine._ctx_stores["ctx"][0][3:5],), rows_block=8)
    assert torch.equal(blocked["similarity"][3:5], again["similarity"])


@pytest.mark.parametrize("general", [False, True])
def test_batched_contextual_pass_matches_jax(both, general):
    """The [n_slices, Q] ranking scores of the batched contextual pass
    (the port's tree pass over the one-leaf plan ("ctx", 0, metric): one
    GEMM against the stacked needles, the dense DP kernels' plain
    versions) against the JAX package's score_all_multi_ctx (1e-6)."""
    sj, st = both
    ij, it = _ctx_indexes(sj, st, general=general)
    qj = [ij.make_query(q).prepare(ij._nlp) for q in QUERIES]
    qt = [it.make_query(q).prepare(it._nlp) for q in QUERIES]
    from vectorian_tpu.index import _pad_needle as jax_pad
    from vectorian_tpu_torch.index import _pad_needle as port_pad

    ctx_j = [jax_pad(q, sj, ctx_names={"ctx"})[2]["ctx"] for q in qj]
    ctx_t = [port_pad(q, st, {"ctx"})[2]["ctx"] for q in qt]
    lts = [q.n_tokens for q in qt]
    from vectorian_tpu.ops.alignment import AffineGapParams as JaxGaps

    gaps_j = ij._affine_gaps() or JaxGaps.of(0, 0, 0, 0)
    args_j = {"gap_costs": (ij._gap_s, ij._gap_t) if general else None}
    ij._engine.ensure_contextual("ctx", sj.documents, DIM)
    it._engine.ensure_contextual("ctx", st.documents, DIM)
    dp_kernels.reset_launches()
    want = ij._engine.score_all_multi_ctx(
        "ctx", ij._args["metric"]["token_sim"].metric, ctx_j, lts, gaps_j, "local",
        [float(x) for x in lts], **args_j)
    metric_t = it._args["metric"]["token_sim"].metric
    plans_t = [QueryPlan(plan=("ctx", 0, metric_t), ctx_names=["ctx"], ctx_queries=[c])
               for c in ctx_t]
    got = it._engine.collect(it._engine.tree_pass(
        plans_t, lts, it._gaps, "local", [float(x) for x in lts],
        gap_costs=it._gap_costs), len(QUERIES))
    assert got.shape == want.shape == (it._engine.n_slices, len(QUERIES))
    assert np.allclose(got, want, rtol=1e-6, atol=1e-6)
    # tensors on the CPU take the plain versions: no launch counted
    assert not any(dp_kernels.LAUNCHES.values())


CTX_OPTIONS = {
    "plain": {},
    "booster": {"booster": "keyword"},
    "filter": {"token_filter": ["the"]},
    "submatch": {"submatch_weight": 0.5},
    "bidirectional": {"bidirectional": True},
}


def _options(name, pkg):
    kw = dict(CTX_OPTIONS[name])
    if kw.get("booster") == "keyword":
        Sal, KS = (JaxSaliency, JaxKeywordSignal) if pkg == "jax" else (
            vt.Saliency, vt.KeywordSignal)
        kw["booster"] = Sal(0.7).add_signal(KS("horse"), 1.0)
    return kw


def _check_find_and_batch(ij, it, kw_j, kw_t, n=4, min_score=0.1):
    port_find = []
    for q in QUERIES:
        want = _pairs(ij.find(q, n=n, min_score=min_score, **kw_j))
        got = _pairs(it.find(q, n=n, min_score=min_score, **kw_t))
        assert got
        _assert_same_ranking(want, got, min_score)
        port_find.append(got)
    got_b = [_pairs(r) for r in it.find_batch(QUERIES, n=n, min_score=min_score, **kw_t)]
    assert got_b == port_find
    for w, g in zip(ij.find_batch(QUERIES, n=n, min_score=min_score, **kw_j), got_b):
        _assert_same_ranking(_pairs(w), g, min_score)


@pytest.mark.parametrize("option", sorted(CTX_OPTIONS))
@pytest.mark.parametrize("general", [False, True])
def test_contextual_find_and_find_batch_match_jax(both, general, option):
    sj, st = both
    ij, it = _ctx_indexes(sj, st, general=general)
    _check_find_and_batch(ij, it, _options(option, "jax"), _options(option, "port"))


@pytest.mark.parametrize("general", [False, True])
def test_pca_contextual_matches_jax(both_pca, general):
    """.pca(8): the projection fitted on the corpus and replayed on the
    needle; the carried state (convert.contextual_from_numpy) gives the
    same results."""
    sj, st = both_pca
    for a, b in zip(sj.documents, st.documents):
        assert a.contextual["ctx"].shape[1] == 8
        assert np.allclose(b.contextual["ctx"], a.contextual["ctx"], rtol=1e-5, atol=1e-6)
    ij, it = _ctx_indexes(sj, st, general=general)
    _check_find_and_batch(ij, it, {}, {})
    before = [_pairs(it.find(q, n=4, min_score=0.1)) for q in QUERIES]
    (fj,) = sj._ctx_fitted["ctx"]
    contextual_from_numpy(st, "ctx", [pd.contextual["ctx"] for pd in sj.documents],
                          [(fj.mean, fj.components)])
    it2 = _ctx_indexes(sj, st, general=general)[1]
    carried = [_pairs(it2.find(q, n=4, min_score=0.1)) for q in QUERIES]
    for want, got in zip(before, carried):
        _assert_same_ranking(want, got, 0.1)
    with pytest.raises(ValueError, match="vector arrays"):
        contextual_from_numpy(st, "ctx", [])


@pytest.mark.parametrize("tree", ["mixed", "max"])
@pytest.mark.parametrize("general", [False, True])
def test_mixed_tree_find_matches_jax(both, tree, general):
    """A mixed static + contextual tree through find (the full-read paths
    evaluate any plan), with submatch_weight as well."""
    sj, st = both
    ij, it = _ctx_indexes(sj, st, general=general, tree=tree)
    for kw in ({}, {"submatch_weight": 0.5}, {"bidirectional": True}):
        for q in QUERIES:
            want = _pairs(ij.find(q, n=4, min_score=0.1, **kw))
            got = _pairs(it.find(q, n=4, min_score=0.1, **kw))
            assert got
            _assert_same_ranking(want, got, 0.1)


def test_find_batch_of_trees_and_tag_weights_is_item_5b(both):
    """The two batches item 5b ported: a mixed static + contextual tree and
    a contextual metric with tag weights, each against the JAX package's
    batch and the port's find (byte for byte); debug makes find_batch run
    find query by query."""
    sj, st = both
    for kw in ({"tree": "mixed"}, {"tag_weights": {"NN": 1.0, "VB": 0.5}}):
        ij, it = _ctx_indexes(sj, st, **kw)
        got = [_pairs(r) for r in it.find_batch(QUERIES[:2], n=3, min_score=0.1)]
        assert got == [_pairs(it.find(q, n=3, min_score=0.1)) for q in QUERIES[:2]]
        assert all(got)
        for w, g in zip(ij.find_batch(QUERIES[:2], n=3, min_score=0.1), got):
            _assert_same_ranking(_pairs(w), g, 0.1)
    got = it.find_batch(QUERIES[:2], n=3, min_score=0.1, debug=lambda *a: None)
    assert [_pairs(r) for r in got] == [
        _pairs(it.find(q, n=3, min_score=0.1)) for q in QUERIES[:2]]


@pytest.mark.parametrize("kwargs", [{}, {"bidirectional": True}],
                         ids=["plain", "bidirectional"])
def test_contextual_debug_hooks_match_jax(both, kwargs):
    """A contextual find(debug=...): scores, document/match_time, then a
    contextual_similarity_matrix and an alignment per rescored slice (two
    each under bidirectional), as in the JAX package; the similarity
    payloads agree (1e-6)."""
    sj, st = both
    ij, it = _ctx_indexes(sj, st)
    for q in QUERIES[:2]:
        hj, ht = [], []
        rj = ij.find(q, n=3, min_score=0.3, debug=lambda k, p: hj.append((k, p)), **kwargs)
        rt = it.find(q, n=3, min_score=0.3, debug=lambda k, p: ht.append((k, p)), **kwargs)
        assert [(k, sorted(p)) for k, p in ht] == [(k, sorted(p)) for k, p in hj]
        assert ht[0][0] == "scores"
        assert any(k == "contextual_similarity_matrix" for k, _ in ht)
        # per slice, its blocks in order (forward, then reversed)
        sims_j = {}
        for k, p in hj:
            if k == "contextual_similarity_matrix":
                sims_j.setdefault(p["slice"], []).append(p["similarity"])
        for k, p in ht:
            if k == "contextual_similarity_matrix":
                assert np.allclose(p["similarity"], sims_j[p["slice"]].pop(0),
                                   rtol=1e-6, atol=1e-6)
        _assert_same_ranking(_pairs(rj), _pairs(rt), 0.3)


def test_contextual_match_json_matches_jax(both):
    sj, st = both
    ij, it = _ctx_indexes(sj, st)
    from tests.test_torch_slice import _assert_json_close

    mj = ij.find(QUERIES[0], n=3, min_score=0.1)
    mt = it.find(QUERIES[0], n=3, min_score=0.1)
    for a, b in zip(mj, mt):
        if a.slice_id == b.slice_id:
            _assert_json_close(a.to_json(), b.to_json())
    assert mt[0].score == pytest.approx(1.0, abs=0.01)


def test_cache_contextual_embeddings_packs_the_stores(both):
    _, st = both
    it = st.partition("sentence").index(EmbeddingTokenSim(st.embeddings[1]))
    it._engine._ctx_stores.pop("ctx", None)
    st.cache_contextual_embeddings()
    stores = it._engine._ctx_stores["ctx"]
    assert [s.dtype for s in stores] == [torch.bfloat16] * len(stores)
    assert [tuple(s.shape[:2]) for s in stores] == [
        (db["n"], db["capacity"]) for db in it._engine._device_buckets]
