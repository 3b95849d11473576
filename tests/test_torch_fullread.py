"""The port's full-read find paths, ``submatch_weight`` and ``debug``, and the
dense DP entries against the JAX package, on the CPU.

Inputs come from seeded numpy generators and go through both packages:

- the dense entries' plain versions (the CPU path of
  ``dp_kernels.affine_dp_scores_dense`` / ``wsb_dp_scores_dense``) against
  the Pallas kernels in interpret mode, BIT for bit;
- the submatch bounds, the host top-k and ``reference_score`` against the
  JAX functions: equal;
- ``find`` and ``find_batch`` under ``submatch_weight`` (with
  ``bidirectional``, a booster and a document-side filter) and ``debug``
  against the JAX package: the same slices, scores within 1e-6 relative
  (ids may swap inside bands of tied scores; the similarity GEMM sums in
  another order), and inside the port ``find`` = ``find_batch`` byte for
  byte; ``debug`` reports the JAX package's hook sequence, each payload
  with its keys.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import vectorian_tpu as vj
import vectorian_tpu_torch as vt
import vectorian_tpu.index as jax_index
import vectorian_tpu_torch.index as port_index
from vectorian_tpu.alignment import ExponentialGapCost as JaxExponential
from vectorian_tpu.alignment import LocalAlignment as JaxLocal
from vectorian_tpu.metrics import EmbeddingTokenSim as JaxTokenSim
from vectorian_tpu.metrics import OptimizedSpanSim as JaxSpanSim
from vectorian_tpu.ops.alignment import AffineGapParams as JaxGaps
from vectorian_tpu.ops.pallas_dp import (
    pallas_align_scores_general,
    pallas_align_scores_multi_nt,
)
from vectorian_tpu.ops.search import BruteForceEngine as JaxEngine
from vectorian_tpu.ops.search import reference_score as jax_reference_score
from vectorian_tpu.saliency import KeywordSignal as JaxKeywordSignal
from vectorian_tpu.saliency import Saliency as JaxSaliency
from vectorian_tpu_torch.alignment import ExponentialGapCost, LocalAlignment
from vectorian_tpu_torch.metrics import EmbeddingTokenSim, OptimizedSpanSim
from vectorian_tpu_torch.ops import dp_kernels, search
from vectorian_tpu_torch.ops.alignment import AffineGapParams, gap_cost_closure

from tests.test_torch_slice import _assert_same_ranking, _corpus, _pairs

torch.set_num_threads(2)

LOCALITIES = ["local", "global", "semiglobal"]
AFFINE_GAPSETS = [(0.0, 0.0, 0.0, 0.0), (0.37, 0.113, 0.29, 0.071)]


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _dense_inputs(seed, c, L, Tp, Q):
    rng = np.random.default_rng(seed)
    S = rng.uniform(-0.4, 1.0, size=(c, L, Tp, Q)).astype(np.float32)
    len_s = rng.integers(0, L + 1, size=c).astype(np.int32)
    len_s[0], len_s[1] = 0, L  # an empty slice and a full one
    len_t = rng.integers(1, Tp + 1, size=Q).astype(np.int32)
    len_t[0] = Tp
    return rng, S, len_s, len_t


@pytest.mark.parametrize("gapset", AFFINE_GAPSETS)
@pytest.mark.parametrize("Tp", [8, 132])
@pytest.mark.parametrize("locality", LOCALITIES)
def test_affine_dense_plain_bit_equal_to_pallas(locality, Tp, gapset):
    """The contextual batch's block [c, L, Tp, Q] (the JAX package hands
    Pallas its [L, c, Tp, Q] transpose, len_s clamped to >= 1)."""
    c, L, Q = 12, 7, 3
    _, S, len_s, len_t = _dense_inputs(Tp, c, L, Tp, Q)
    got = dp_kernels.affine_dp_scores_dense(
        _t(S), _t(len_s), _t(len_t), AffineGapParams.of(*gapset), locality
    ).numpy()
    assert got.shape == (c, Q) and got.dtype == np.float32
    want = np.asarray(pallas_align_scores_multi_nt(
        jnp.asarray(S.transpose(1, 0, 2, 3)), jnp.asarray(np.maximum(len_s, 1)),
        jnp.asarray(len_t), JaxGaps.of(*gapset), locality, interpret=True,
    ))
    assert np.array_equal(got, want)


@pytest.mark.parametrize("kind", ["exp", "rand"])
@pytest.mark.parametrize("Tp", [8, 132])
@pytest.mark.parametrize("locality", LOCALITIES)
def test_wsb_dense_plain_bit_equal_to_pallas(locality, Tp, kind):
    """The general-gap DP of the block, flattened as the JAX contextual
    batch flattens it ([c * Q, L, Tp], problem s * Q + q)."""
    c, L, Q = 10, 7, 3
    rng, S, len_s, len_t = _dense_inputs(Tp + 1, c, L, Tp, Q)
    k = np.arange(max(L, Tp) + 1, dtype=np.float32)
    if kind == "exp":
        w = (1.0 - np.power(2.0, -k / 3.0)).astype(np.float32)
    else:
        w = np.sort(rng.uniform(0, 1.5, size=k.size)).astype(np.float32)
        w[0] = 0.0
    w_s, w_t = w[: L + 1].copy(), w[: Tp + 1].copy()
    vecs = (_t(w_s), _t(w_t), gap_cost_closure(_t(w_t)))
    got = dp_kernels.wsb_dp_scores_dense(
        _t(S), _t(len_s), _t(len_t), *vecs, locality, host_costs=vecs
    ).numpy()
    assert got.shape == (c, Q)
    S2 = S.transpose(0, 3, 1, 2).reshape(c * Q, L, Tp)
    want = np.asarray(pallas_align_scores_general(
        jnp.asarray(S2), jnp.asarray(np.repeat(np.maximum(len_s, 1), Q)),
        jnp.asarray(np.tile(len_t, c)), jnp.asarray(w_s), jnp.asarray(w_t),
        locality, interpret=True,
    )).reshape(c, Q)
    assert np.array_equal(got, want)


def test_dense_wrappers_check_their_inputs():
    S = torch.zeros((4, 3, 8, 2))
    ln, lt = torch.ones((4,), dtype=torch.int32), torch.ones((2,), dtype=torch.int32)
    with pytest.raises(ValueError, match="block"):
        dp_kernels.affine_dp_scores_dense(S[0], ln, lt, AffineGapParams.of(0, 0, 0, 0),
                                          "local")
    with pytest.raises(ValueError, match="len_s"):
        dp_kernels.affine_dp_scores_dense(S, ln[:3], lt, AffineGapParams.of(0, 0, 0, 0),
                                          "local")
    with pytest.raises(ValueError, match="locality"):
        dp_kernels.affine_dp_scores_dense(S, ln, lt, AffineGapParams.of(0, 0, 0, 0),
                                          "nowhere")
    w = torch.zeros((9,))
    with pytest.raises(ValueError, match="w_s"):
        dp_kernels.wsb_dp_scores_dense(S, ln, lt, w[:3], w, w, "local")


@pytest.mark.parametrize("w", [0.25, 0.5, 2.0])
@pytest.mark.parametrize("sim_max", [1.0, 1.7])
def test_submatch_bounds_equal_jax(w, sim_max):
    d = np.linspace(-0.5, 1.5, 41)
    for total in (1.0, 3.0, 7.5):
        assert np.array_equal(
            port_index._submatch_upper_bound(d, total, w, sim_max),
            jax_index._submatch_upper_bound(d, total, w, sim_max),
        )
        for t in (0.05, 0.4, 0.9):
            for eps in (0.0, 1e-6, 1e-4):
                assert port_index._submatch_fetch_thresh(
                    t, total, w, sim_max, eps
                ) == jax_index._submatch_fetch_thresh(t, total, w, sim_max, eps)
        boost = np.asarray([1.0, 1.25, 0.5, 1.25, 0.0], np.float32)
        for t in (0.05, 0.4, 0.9):
            assert port_index._submatch_fetch_thresh_boosted(
                t, boost, total, w, sim_max, 1e-6
            ) == jax_index._submatch_fetch_thresh_boosted(t, boost, total, w, sim_max, 1e-6)
        for dd in (0.1, 0.6):
            assert port_index._submatch_bound_boosted(
                dd, boost, total, w, sim_max, 1e-6
            ) == jax_index._submatch_bound_boosted(dd, boost, total, w, sim_max, 1e-6)
    for total, matched in ((4.0, 0.0), (4.0, 2.5), (4.0, 4.0), (0.0, 0.0)):
        assert search.reference_score(total, matched, w) == jax_reference_score(
            total, matched, w)


@pytest.fixture(scope="module")
def both():
    words, mat, texts, queries = _corpus()
    sj = vj.Session(
        [vj.StringImporter()(t, title=f"d{i}") for i, t in enumerate(texts)],
        embeddings=[vj.KeyedVectors("toy", words, mat)],
    )
    st = vt.Session(
        [vt.StringImporter()(t, title=f"d{i}") for i, t in enumerate(texts)],
        embeddings=[vt.KeyedVectors("toy", words, mat)],
        device="cpu",
    )
    return sj, st, queries


def test_host_top_k_equals_jax(both):
    """top_k (the reference's tie order) and top_k_with_next on one score
    vector with ties."""
    sj, st, _ = both
    ej = sj.engine(sj.partition("sentence").spec)
    et = st.engine(st.partition("sentence").spec)
    rng = np.random.default_rng(4)
    scores = rng.choice(np.linspace(0, 1, 9), size=et.n_slices).astype(np.float32)
    for k in (1, 5, 40, et.n_slices + 3):
        for ms in (0.0, 0.5, 2.0):
            assert et.top_k(scores, k, ms) == JaxEngine.top_k(ej, scores, k, ms)
    for m in (3, 30, et.n_slices):
        for thr in (0.0, 0.5):
            a, ra = et.top_k_with_next(scores, m, thr)
            b, rb = JaxEngine.top_k_with_next(ej, scores, m, thr)
            assert sorted(a) == sorted(b) and ra == rb


def _indexes(sj, st, general):
    ij = sj.partition("sentence").index(JaxSpanSim(
        JaxTokenSim(sj.embeddings[0]),
        JaxLocal(JaxExponential(3.0)) if general else JaxLocal(),
    ))
    it = st.partition("sentence").index(OptimizedSpanSim(
        EmbeddingTokenSim(st.embeddings[0]),
        LocalAlignment(ExponentialGapCost(3.0)) if general else LocalAlignment(),
    ))
    return ij, it


SUBMATCH_OPTIONS = {
    "plain": {},
    "bidirectional": {"bidirectional": True},
    "booster": {"booster": "keyword"},
    "filter": {"token_filter": ["the", "sea"]},
}


def _options(name, pkg):
    kw = dict(SUBMATCH_OPTIONS[name])
    if kw.get("booster") == "keyword":
        Sal, KS = (JaxSaliency, JaxKeywordSignal) if pkg == "jax" else (
            vt.Saliency, vt.KeywordSignal)
        kw["booster"] = Sal(0.6).add_signal(KS("sun"), 1.0)
    return kw


@pytest.mark.parametrize("option", sorted(SUBMATCH_OPTIONS))
@pytest.mark.parametrize("general", [False, True])
def test_submatch_find_and_find_batch_match_jax(both, general, option):
    """submatch_weight through the fused branch (bidirectional), the
    score_topk branch and its full-read fallback (find), the batch's
    closed-form overfetch (find_batch): the JAX package's slices and
    scores, and find = find_batch byte for byte in the port."""
    sj, st, queries = both
    ij, it = _indexes(sj, st, general)
    n, min_score = 4, 0.1
    kw_j, kw_t = _options(option, "jax"), _options(option, "port")
    port_find = []
    for q in queries:
        want = _pairs(ij.find(q, n=n, min_score=min_score, submatch_weight=0.5, **kw_j))
        got = _pairs(it.find(q, n=n, min_score=min_score, submatch_weight=0.5, **kw_t))
        _assert_same_ranking(want, got, min_score)
        port_find.append(got)
    got_b = it.find_batch(queries, n=n, min_score=min_score, submatch_weight=0.5, **kw_t)
    assert [_pairs(r) for r in got_b] == port_find
    want_b = ij.find_batch(queries, n=n, min_score=min_score, submatch_weight=0.5,
                           sim_precision="float32", **kw_j)
    for w, g in zip(want_b, got_b):
        _assert_same_ranking(_pairs(w), _pairs(g), min_score)
    # the submatch normalization bites: some score differs from w = 0's
    plain = [_pairs(it.find(q, n=n, min_score=min_score, **kw_t)) for q in queries]
    assert plain != port_find


def test_submatch_unsafe_cut_takes_the_full_read(both, monkeypatch):
    """A 4n overfetch the closed-form bound cannot prove falls through to
    score_all's extras (n=1 on a Zipf corpus), with the JAX package's
    result."""
    sj, st, queries = both
    ij, it = _indexes(sj, st, False)
    calls = []
    real = it._engine.top_k  # the full read's 4n candidates

    def spy(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(it._engine, "top_k", spy)
    for q in queries:
        want = _pairs(ij.find(q, n=1, min_score=0.0, submatch_weight=2.0))
        got = _pairs(it.find(q, n=1, min_score=0.0, submatch_weight=2.0))
        _assert_same_ranking(want, got, 0.0)
    assert calls


def _hooks(index, q, **kw):
    seen = []
    result = index.find(q, debug=lambda name, payload: seen.append(
        (name, sorted(payload))), **kw)
    return seen, _pairs(result)


@pytest.mark.parametrize("kwargs", [{}, {"bidirectional": True},
                                    {"submatch_weight": 0.5}],
                         ids=["plain", "bidirectional", "submatch"])
@pytest.mark.parametrize("general", [False, True])
def test_debug_hooks_match_jax(both, general, kwargs):
    """find(debug=...) takes the full read: the JAX package's hook names in
    its order (static_similarity_matrix, scores, document/match_time, one
    alignment a rescored candidate — both orientations' under
    bidirectional) and each payload's keys; the results agree."""
    sj, st, queries = both
    ij, it = _indexes(sj, st, general)
    for q in queries[:3]:
        hj, rj = _hooks(ij, q, n=3, min_score=0.3, **kwargs)
        ht, rt = _hooks(it, q, n=3, min_score=0.3, **kwargs)
        assert ht == hj
        assert [h[0] for h in ht[:3]] == [
            "static_similarity_matrix", "scores", "document/match_time"]
        _assert_same_ranking(rj, rt, 0.3)
        # the results are those of the search without debug
        assert rt == _pairs(it.find(q, n=3, min_score=0.3, **kwargs))
    # find_batch serves debug query by query through find
    got = it.find_batch(queries[:3], n=3, min_score=0.3, debug=lambda *a: None,
                        **kwargs)
    assert [_pairs(r) for r in got] == [
        _pairs(it.find(q, n=3, min_score=0.3, **kwargs)) for q in queries[:3]]


def test_debug_payloads_match_jax(both):
    """The payloads' values: the [V, T] similarity matrix, the full read's
    device scores (1e-6), and each alignment's slice, flow and score."""
    sj, st, queries = both
    ij, it = _indexes(sj, st, False)
    pj, pt = [], []
    ij.find(queries[0], n=3, min_score=0.3, debug=lambda k, p: pj.append((k, p)))
    it.find(queries[0], n=3, min_score=0.3, debug=lambda k, p: pt.append((k, p)))
    (_, mj), (_, mt) = pj[0], pt[0]
    assert mt["similarity"].shape == np.asarray(mj["similarity"]).shape
    assert np.allclose(mt["similarity"], mj["similarity"], rtol=1e-6, atol=1e-6)
    assert np.allclose(pt[1][1]["scores"], pj[1][1]["scores"], rtol=1e-6, atol=1e-6)
    aj = {p["slice"]: p for k, p in pj if k == "alignment"}
    at = {p["slice"]: p for k, p in pt if k == "alignment"}
    assert aj.keys() == at.keys()
    for sid, p in at.items():
        assert abs(p["score"] - aj[sid]["score"]) <= 1e-6 * max(1.0, abs(p["score"]))
        assert np.array_equal(p["flow"], aj[sid]["flow"])


def test_score_all_matches_jax(both):
    """The full read of one query's device scores: the kernels at Q = 1
    against the JAX package's _bucket_scores (1e-6), with tag weights, a
    booster and a filter."""
    sj, st, queries = both
    ij, it = _indexes(sj, st, False)
    qj = ij.make_query(queries[0]).prepare(ij._nlp)
    qt = it.make_query(queries[0]).prepare(it._nlp)
    tok, strings, ctx, _ = jax_index._pad_needle(qj, sj)
    plan_j = jax_index.compile_plan(ij._args["metric"]["token_sim"],
                                    sj.compiled_embeddings, tok, strings, ctx)
    plan_t = it._compile_plan(qt)
    T = qt.n_tokens
    rng = np.random.default_rng(2)
    boost = rng.uniform(0.5, 1.5, size=it._engine.n_slices).astype(np.float32)
    flt_j = jax_index.BruteForceIndex._doc_filter(
        ij, ij.make_query(queries[0], token_filter=["the"]).prepare(ij._nlp))
    flt_t = it._doc_filter(it.make_query(queries[0], token_filter=["the"]).prepare(it._nlp))
    for kw_j, kw_t in (({}, {}), ({"boost": boost}, {"boost": boost}),
                       ({"doc_filter": flt_j}, {"doc_filter": flt_t})):
        want = ij._engine.score_all(plan_j, T, JaxGaps.of(0, 0, 0, 0), "local",
                                    float(T), **kw_j)
        got = it._engine.score_all(plan_t, T, it._gaps, "local", float(T), **kw_t)
        assert np.allclose(got, want, rtol=1e-6, atol=1e-7)
        assert (got > -1e29).sum() == (want > -1e29).sum()


def test_slice_similarity_and_rescores_match_jax(both):
    """The exact rescore's similarity blocks of chosen slices (weighted and
    unweighted, under tag weights and a filter's kept positions) against
    the JAX package's, and the score-only rescore equal to the flows
    rescore's scores."""
    sj, st, queries = both
    ij, it = _indexes(sj, st, False)
    qj = ij.make_query(queries[0]).prepare(ij._nlp)
    qt = it.make_query(queries[0]).prepare(it._nlp)
    tok, strings, ctx, _ = jax_index._pad_needle(qj, sj)
    plan_j = jax_index.compile_plan(ij._args["metric"]["token_sim"],
                                    sj.compiled_embeddings, tok, strings, ctx)
    plan_t = it._compile_plan(qt)
    sids = [0, 3, 17, 40, 41]
    W = plan_t.width
    tw = search.TagWeightingSpec(
        np.resize(np.asarray([0.5, 1.0, 0.8, 0.2], np.float32), W),
        np.resize(np.asarray([0, 1, 2, 3], np.int8), W), 0.25, 0.05)
    from vectorian_tpu.ops.search import TagWeightingSpec as JaxTW

    tw_j = JaxTW(tw.t_pos_weights, tw.pos_t, 0.25, 0.05)
    sels = [np.asarray([0, 1], np.int32)] * len(sids)
    for kw_t, kw_j in (({}, {}), ({"tag_weights": tw}, {"tag_weights": tw_j}),
                       ({"sels": sels}, {"sels": sels})):
        got = it._engine.batch_slice_similarity(sids, plan_t, **kw_t)
        want = ij._engine.batch_slice_similarity(sids, plan_j, **kw_j)
        for (sw, su), (wj, uj) in zip(got, want):
            assert sw.shape == np.asarray(wj).shape
            assert np.allclose(sw, wj, rtol=1e-6, atol=1e-6)
            assert np.allclose(su, uj, rtol=1e-6, atol=1e-6)
    one = it._engine.slice_similarity(sids[2], plan_t)
    assert all(np.array_equal(a, b) for a, b in zip(
        one, it._engine.batch_slice_similarity([sids[2]], plan_t)[0]))
    _, _, raw = it._engine.rescore_with_flows(sids, plan_t, qt.n_tokens, it._gaps,
                                              "local", with_scores=True)
    assert np.array_equal(it._engine.rescore_scores(sids, plan_t, qt.n_tokens,
                                                    it._gaps, "local"), raw)


@pytest.mark.parametrize("sim_dtype", [None, "int8"])
def test_score_all_multi_matches_jax(both, sim_dtype):
    """The full read of Q static plans' [n_slices, Q] device scores (the
    gather kernels' plain versions) against the JAX package's (1e-6), with
    the quantized table's entry error."""
    sj, st, queries = both
    ij, it = _indexes(sj, st, True)
    plans_j, plans_t, lts = [], [], []
    for q in queries:
        pj = ij.make_query(q).prepare(ij._nlp)
        tok, strings, ctx, _ = jax_index._pad_needle(pj, sj)
        plans_j.append(jax_index.compile_plan(
            ij._args["metric"]["token_sim"], sj.compiled_embeddings, tok, strings, ctx))
        plans_t.append(it._compile_plan(it.make_query(q).prepare(it._nlp)))
        lts.append(max(pj.n_tokens, 1))
    nts = [float(x) for x in lts]
    want, err_j = ij._engine.score_all_multi(
        plans_j, lts, JaxGaps.of(0, 0, 0, 0), "local", nts, sim_dtype=sim_dtype,
        with_err=True, gap_costs=(ij._gap_s, ij._gap_t))
    got, err_t = it._engine.score_all_multi(
        plans_t, lts, it._gaps, "local", nts, sim_dtype=sim_dtype, with_err=True,
        gap_costs=it._gap_costs)
    assert got.shape == want.shape == (it._engine.n_slices, len(queries))
    assert np.allclose(got, want, rtol=1e-6, atol=1e-6)
    assert err_t == pytest.approx(err_j, rel=1e-6)
