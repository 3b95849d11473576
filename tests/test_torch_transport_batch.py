"""The transport metrics' ``find_batch`` in the port against the JAX
package, on the CPU.

One ranking pass serves Q queries, then each query's host rescore runs as
``find``'s does.  Relaxed WMD (injective or not, symmetric or not, bow and
nbow), full WMD and the Word Rotator's Distance over static, contextual
and mixed-tree plans and a ``MaximumTokenSimilarity``, with tag weights, a
document-side filter, a booster and ``debug``: the reported scores within
1e-6 relative of the JAX package's ``find_batch``, the same slices except
inside bands of tied scores; inside the port each query's batch result has
the bytes of its ``find``; full WMD and WRD batches equal the exhaustive
exact-EMD oracle (tests/test_wmd_provable_cut.py's batch half).  The
multi-query ranking functions hold the JAX package's within 1e-6, the
pair gather bit for bit; the consume loop fetches no more similarity rows
than the JAX package's.
"""

import itertools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import vectorian_tpu_torch as vt
from vectorian_tpu.ops import wmd as jax_wmd
from vectorian_tpu.saliency import KeywordSignal as JaxKeywordSignal
from vectorian_tpu.saliency import Saliency as JaxSaliency
from vectorian_tpu.sim.modifier import MaximumTokenSimilarity as JaxMax
from vectorian_tpu.sim.span import OptimizedSpanSim as JaxSpanSim
from vectorian_tpu.sim.token import EmbeddingTokenSim as JaxTokenSim
from vectorian_tpu_torch.alignment import WordMoversDistance
from vectorian_tpu_torch.ops import wmd
from vectorian_tpu_torch.sim.modifier import MaximumTokenSimilarity
from vectorian_tpu_torch.sim.span import OptimizedSpanSim
from vectorian_tpu_torch.sim.token import EmbeddingTokenSim

from tests.test_torch_slice import _assert_same_ranking, _pairs
from tests.test_torch_transport import (
    BY_NAME,
    CTX_QUERIES,
    IDS,
    _base_words,
    _indexes,
    cut,  # noqa: F401  (fixture)
    ctx,  # noqa: F401  (fixture)
)

torch.set_num_threads(2)


def _batch_queries(queries):
    # a 3-, 5- and 7-token query and a repeat (two queries of one plan)
    return list(queries) + [queries[0]]


def _check_batch(ij, it, queries, n=5, min_score=0.1, kw_j=None, kw_t=None):
    """JAX batch ~ port batch (ranking rule), port batch == port find."""
    kw_j = kw_j or {}
    kw_t = kw_t if kw_t is not None else kw_j
    bj = ij.find_batch(queries, n=n, min_score=min_score, **kw_j)
    bt = it.find_batch(queries, n=n, min_score=min_score, **kw_t)
    assert len(bt) == len(queries)
    assert any(len(r) for r in bt)
    for rj, rt in zip(bj, bt):
        _assert_same_ranking(_pairs(rj), _pairs(rt), min_score)
    finds = [_pairs(it.find(q, n=n, min_score=min_score, **kw_t)) for q in queries]
    assert [_pairs(r) for r in bt] == finds
    return bt


# ---- the multi-query device functions --------------------------------------


def _chunk_inputs(rng, c=6, L=7, T=5, Q=3):
    tok = rng.integers(0, 6, size=(c, L)).astype(np.int32)
    ln = rng.integers(0, L + 1, size=c).astype(np.int32)
    tag = rng.integers(0, 3, size=(c, L)).astype(np.int16)
    pos = rng.integers(-1, 4, size=(c, L)).astype(np.int8)
    S = np.round(rng.uniform(-0.2, 1.0, size=(c, L, T, Q)), 2).astype(np.float32)
    mass_t = rng.integers(0, 3, size=(T, Q)).astype(np.float32)
    mass_t[0] = 1.0
    len_t = np.asarray([T, T - 1, 2][:Q], np.int32)
    max_t = np.asarray([3.5, 2.0, 1.0][:Q], np.float32)
    keep = rng.uniform(size=(c, L)) > 0.2
    return tok, ln, tag, pos, S, mass_t, len_t, max_t, keep


@pytest.mark.parametrize("injective,symmetric,normalize", list(
    itertools.product([False, True], repeat=3)))
@pytest.mark.parametrize("variant", ["plain", "tagged", "unique", "filter"])
def test_rwmd_chunk_scores_multi_match_jax(injective, symmetric, normalize, variant):
    rng = np.random.default_rng(3)
    tok, ln, tag, pos, S, mass_t, len_t, max_t, keep = _chunk_inputs(rng)
    c, L, T, Q = S.shape
    tagged, unique = variant == "tagged", variant == "unique"
    valid = np.arange(L)[None, :] < ln[:, None]
    kp = (valid & keep) if variant == "filter" else None
    # the JAX chunk function reads [L, c] rows and an [L, c, T, Q] block,
    # and makes its filter from exclusion tables: under the filter each
    # position gets an id of its own, excluded by a table that reproduces
    # ``keep``
    ids = np.arange(c * L, dtype=np.int32).reshape(c, L) if kp is not None else tok
    tok_ex = ~keep.reshape(-1) if kp is not None else np.zeros((c * L,), bool)
    got = wmd._rwmd_chunk_scores_multi(
        torch.as_tensor(S), torch.as_tensor(ids), torch.as_tensor(ln),
        torch.as_tensor(tag), None if kp is None else torch.as_tensor(kp),
        torch.as_tensor(mass_t), torch.as_tensor(len_t), torch.as_tensor(max_t),
        injective, symmetric, normalize, unique, tagged).numpy()
    want = np.asarray(jax_wmd._rwmd_chunk_scores_multi(
        jnp.asarray(ids.T), jnp.asarray(ln), jnp.asarray(pos.T), jnp.asarray(tag.T),
        None, jnp.asarray(mass_t), jnp.asarray(len_t), jnp.asarray(max_t),
        jnp.ones((T, Q)), jnp.full((T, Q), -1, jnp.int8), jnp.zeros((Q,)),
        jnp.full((Q,), -1.0), jnp.zeros((8,), bool), jnp.zeros((8,), bool),
        jnp.asarray(tok_ex), injective, symmetric, normalize, tagged,
        kp is not None, S=jnp.asarray(S.transpose(1, 0, 2, 3)), unique=unique))
    assert np.allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("use_magnitudes,normalize", [(False, True), (False, False),
                                                      (True, True)])
@pytest.mark.parametrize("variant", ["plain", "tagged", "unique", "filter"])
def test_emd_chunk_scores_multi_match_jax(use_magnitudes, normalize, variant):
    rng = np.random.default_rng(4)
    tok, ln, tag, pos, S, mass_t, len_t, max_t, keep = _chunk_inputs(rng)
    c, L, T, Q = S.shape
    tagged, unique = variant == "tagged", variant == "unique"
    valid = np.arange(L)[None, :] < ln[:, None]
    kp = (valid & keep) if variant == "filter" else None
    ids = np.arange(c * L, dtype=np.int32).reshape(c, L) if kp is not None else tok
    mags_vocab = rng.uniform(0.5, 2.0, size=c * L).astype(np.float32)
    mags_s = mags_vocab[ids]
    got = wmd._emd_chunk_scores_multi(
        torch.as_tensor(S), torch.as_tensor(mags_s), torch.as_tensor(ids),
        torch.as_tensor(ln), torch.as_tensor(tag),
        None if kp is None else torch.as_tensor(kp), torch.as_tensor(mass_t),
        use_magnitudes, normalize, unique, tagged).numpy()
    tok_ex = ~keep.reshape(-1) if kp is not None else np.zeros((c * L,), bool)
    want = np.asarray(jax_wmd._emd_chunk_scores_multi(
        jnp.asarray(ids.T), jnp.asarray(ln), jnp.asarray(pos.T), jnp.asarray(tag.T),
        None, jnp.asarray(mags_vocab), jnp.asarray(mass_t),
        jnp.ones((T, Q)), jnp.full((T, Q), -1, jnp.int8), jnp.zeros((Q,)),
        jnp.full((Q,), -1.0), jnp.zeros((8,), bool), jnp.zeros((8,), bool),
        jnp.asarray(tok_ex), use_magnitudes, normalize, tagged, kp is not None,
        S=jnp.asarray(S.transpose(1, 0, 2, 3)), unique=unique))
    assert np.allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("tagged", [False, True])
def test_pairs_sims_static_is_jax_bit_for_bit(tagged):
    rng = np.random.default_rng(6)
    V, T, Q, p, L = 9, 8, 3, 11, 6
    sim = rng.uniform(-1, 1, size=(V, T, Q)).astype(np.float32)
    tok = rng.integers(0, V, size=(p, L)).astype(np.int32)
    pos = rng.integers(-1, 4, size=(p, L)).astype(np.int8)
    qidx = rng.integers(0, Q, size=p).astype(np.int32)
    tw = (rng.uniform(0.2, 1.5, size=(T, Q)).astype(np.float32),
          rng.integers(-1, 4, size=(T, Q)).astype(np.int8),
          np.asarray([0.0, 0.3, 0.7], np.float32),
          np.asarray([-1.0, 0.1, 0.2], np.float32))
    want_w, want_u = jax_wmd._pairs_sims_static(
        jnp.asarray(tok), jnp.asarray(pos), jnp.asarray(qidx), jnp.asarray(sim),
        *(jnp.asarray(a) for a in tw), V=V, with_tags=tagged)
    got_w, got_u = wmd._pairs_sims_static(
        torch.as_tensor(tok), torch.as_tensor(pos), torch.as_tensor(qidx),
        torch.as_tensor(sim), tuple(torch.as_tensor(a) for a in tw) if tagged else None)
    assert got_w.numpy().tobytes() == np.asarray(want_w).tobytes()
    assert got_u.numpy().tobytes() == np.asarray(want_u).tobytes()


def test_batch_ranking_pass_column_matches_find_pass(cut):
    """Each query's column of the batch pass equals its own single-query
    pass (which tests/test_torch_transport.py holds against the JAX
    package's) within 1e-6, relaxed and full WMD."""
    sj, st, queries = cut
    for name in ("rwmd/nbow", "rwmd/bow/fast", "wmd/nbow", "wrd"):
        _, it = _indexes(sj, st, name)
        eng = wmd.WMDEngine(it._engine, it._args["alignment"])
        pqs = [it.make_query(q).prepare(it._nlp) for q in queries]
        qps = [it._compile_plan(pq, (), needs_magnitudes=name == "wrd") for pq in pqs]
        seen = {}
        orig = wmd.WMDEngine._buckets_pass

        def spy(self, fn):
            out = orig(self, fn)
            if "scores" not in seen:  # the batch's pass
                seen["scores"] = self._engine.collect(out, len(qps))
            return out

        wmd.WMDEngine._buckets_pass = spy
        try:
            eng.find_batch(it, pqs, qps, 5, 0.1)
        finally:
            wmd.WMDEngine._buckets_pass = orig
        for qi, (pq, qp) in enumerate(zip(pqs, qps)):
            col = eng._score(it, pq, qp)["scores"]
            assert np.allclose(seen["scores"][:, qi], col, rtol=1e-6, atol=1e-6), name


# ---- find_batch ------------------------------------------------------------


@pytest.mark.parametrize("name", IDS)
def test_static_batch_matches_jax(cut, name):
    sj, st, queries = cut
    ij, it = _indexes(sj, st, name)
    _check_batch(ij, it, _batch_queries(queries))


@pytest.mark.parametrize("name,plan", [(m, "ctx") for m in IDS]
                         + [(m, "mixed") for m in IDS if m != "wrd"])
def test_contextual_batch_matches_jax(ctx, name, plan):
    """Contextual and mixed-tree plans stack per leaf (stack_tree_plans);
    WRD of a mixed tree is left out as in find's test."""
    sj, st = ctx
    ij, it = _indexes(sj, st, name, plan=plan)
    _check_batch(ij, it, CTX_QUERIES, n=4, min_score=0.2)


@pytest.mark.parametrize("name", ["rwmd/nbow", "wmd/nbow", "wrd"])
@pytest.mark.parametrize("plan", ["static", "ctx"])
def test_max_tree_batch_matches_jax(cut, ctx, name, plan):
    """A MaximumTokenSimilarity of two leaves: a static tree folds into one
    table (WRD keeps it unfolded: the stacked plan), a contextual one
    stacks per leaf."""
    sj, st = (cut[0], cut[1]) if plan == "static" else ctx
    _, mk_j, mk_t = BY_NAME[name]
    if plan == "static":
        tj = JaxMax([JaxTokenSim(sj.embeddings[0]), JaxTokenSim(sj.embeddings[0])])
        tt = MaximumTokenSimilarity([EmbeddingTokenSim(st.embeddings[0]),
                                     EmbeddingTokenSim(st.embeddings[0])])
        queries, n, msc = cut[2], 5, 0.1
    else:
        tj = JaxMax([JaxTokenSim(sj.embeddings[0]), JaxTokenSim(sj.embeddings[1])])
        tt = MaximumTokenSimilarity([EmbeddingTokenSim(st.embeddings[0]),
                                     EmbeddingTokenSim(st.embeddings[1])])
        queries, n, msc = CTX_QUERIES, 4, 0.2
    ij = sj.partition("sentence").index(JaxSpanSim(tj, mk_j()))
    it = st.partition("sentence").index(OptimizedSpanSim(tt, mk_t()))
    _check_batch(ij, it, queries, n=n, min_score=msc)


@pytest.mark.parametrize("name", ["rwmd/nbow", "rwmd/bow/fast", "wmd/nbow", "wrd"])
@pytest.mark.parametrize("option", ["tags", "filter", "booster"])
def test_batch_options_match_jax(cut, name, option):
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
    _check_batch(ij, it, _batch_queries(queries), min_score=0.05, kw_j=kw_j, kw_t=kw_t)


@pytest.mark.parametrize("name", ["rwmd/nbow", "wmd/nbow", "wrd"])
def test_contextual_batch_options_match_jax(ctx, name):
    """Tag weights and a filter on a contextual batch (position-unique
    entries subsume the (id, tag) identity)."""
    sj, st = ctx
    span = {"tag_weights": {"NN": 1.0, "VB": 0.5}, "pos_mismatch_penalty": 0.2,
            "similarity_threshold": 0.1}
    ij, it = _indexes(sj, st, name, plan="ctx", **span)
    _check_batch(ij, it, CTX_QUERIES, n=4, min_score=0.1,
                 kw_j={"token_filter": ["the"]})


@pytest.mark.parametrize("name", ["rwmd/nbow", "wmd/nbow", "wrd"])
def test_batch_debug_runs_find(cut, name):
    """debug: find query by query, the hooks of each query in turn."""
    sj, st, queries = cut
    ij, it = _indexes(sj, st, name)
    hj, ht = [], []
    bj = ij.find_batch(queries, n=4, min_score=0.1, debug=lambda k, p: hj.append(k))
    bt = it.find_batch(queries, n=4, min_score=0.1, debug=lambda k, p: ht.append(k))
    assert ht == hj and ht.count("scores") == len(queries)
    for rj, rt in zip(bj, bt):
        _assert_same_ranking(_pairs(rj), _pairs(rt), 0.1)


@pytest.mark.parametrize("name", ["wmd/nbow", "wmd/bow", "wrd"])
def test_full_transport_batch_is_the_exhaustive_oracle(cut, name):
    """A full WMD / WRD batch returns each query's exhaustive exact-EMD
    top-k (tests/test_wmd_provable_cut.py's batch half)."""
    _, st, queries = cut
    _, _, mk = BY_NAME[name]
    ix = st.partition("sentence").index(OptimizedSpanSim(
        EmbeddingTokenSim(st.embeddings[0]), mk()))
    n_slices = int(ix.packed.n_slices)
    exhaustive = [ix.find(q, n=n_slices + 8, min_score=-1.0) for q in queries]
    for n, msc in ((3, -1.0), (5, 0.3), (10, 0.05)):
        got = [_pairs(r) for r in ix.find_batch(queries, n=n, min_score=msc)]
        want = [[(m.slice_id, m.score) for m in ex if m.score > msc][:n]
                for ex in exhaustive]
        assert got == want, (n, msc)


def _count_pairs(monkeypatch, module, names):
    counts = {"pairs": 0}
    for name in names:
        orig = getattr(module.WMDEngine, name)

        def spy(self, items, *a, _orig=orig, **kw):
            counts["pairs"] += sum(len(s) for _, s in items)
            return _orig(self, items, *a, **kw)

        monkeypatch.setattr(module.WMDEngine, name, spy)
    return counts


@pytest.mark.parametrize("name", ["wmd/nbow", "wrd"])
@pytest.mark.parametrize("plan", ["static", "ctx"])
def test_consume_loop_fetches_no_more_than_jax(cut, ctx, monkeypatch, name, plan):
    """The consume rounds fetch no more (slice, query) similarity rows than
    the JAX package's: the tree path fetches at collect time from the
    queries left after retirement (the JAX loop also fetches windows of
    queries it then retires), the static path keeps its speculation."""
    if plan == "static":
        sj, st, queries = cut
        n, msc = 2, 0.1
    else:
        sj, st = ctx
        queries, n, msc = CTX_QUERIES, 2, 0.1
    ij, it = _indexes(sj, st, name, plan=plan)
    if plan == "static":
        cj = _count_pairs(monkeypatch, jax_wmd, ["_sims_many_static_dispatch"])
        ct = _count_pairs(monkeypatch, wmd, ["_sims_many_static_dispatch"])
    else:
        cj = _count_pairs(monkeypatch, jax_wmd, ["_sims_many_plan"])
        ct = _count_pairs(monkeypatch, wmd, ["_sims_many_plan"])
    bj = ij.find_batch(queries, n=n, min_score=msc)
    bt = it.find_batch(queries, n=n, min_score=msc)
    for rj, rt in zip(bj, bt):
        _assert_same_ranking(_pairs(rj), _pairs(rt), msc)
    assert 0 < ct["pairs"] <= cj["pairs"], (ct, cj)


def test_empty_and_mesh_queries(cut):
    """An empty query returns an empty result in its place; mesh= (a
    make_mesh of CPU devices) returns the unsharded bytes, and a non-mesh
    object raises TypeError."""
    _, st, queries = cut
    ix = st.partition("sentence").index(OptimizedSpanSim(
        EmbeddingTokenSim(st.embeddings[0]), WordMoversDistance()))
    res = ix.find_batch(["", queries[0], "..."], n=3, min_score=0.1)
    assert len(res) == 3 and not len(res[0]) and not len(res[2])
    assert _pairs(res[1]) == _pairs(ix.find(queries[0], n=3, min_score=0.1))
    mesh = vt.make_mesh(["cpu"] * 3)
    assert [_pairs(r) for r in ix.find_batch(queries, n=3, min_score=0.1, mesh=mesh)] == [
        _pairs(r) for r in ix.find_batch(queries, n=3, min_score=0.1)]
    with pytest.raises(TypeError):
        ix.find_batch(queries, mesh=object())
