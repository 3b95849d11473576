"""The transport metrics' ``find`` in the port against the JAX package, on
the CPU.

Relaxed WMD (injective or not, symmetric or not, bow and nbow), full WMD
and the Word Rotator's Distance over static and contextual plans (and a
mixed tree for the WMD variants), with tag weights, a document-side
filter, a booster and ``debug``: the device ranking passes within 1e-6 of
the JAX package's, the reported scores within 1e-6 relative with the same
slices except inside bands of tied scores.  The host arithmetic that
reports the scores is bit-equal given equal inputs (``rwmd_score_host``,
the native SSP EMD, ``order_by_score``); full WMD and WRD ``find`` return
the exhaustive exact-EMD oracle's top-k (``find(q, n=n_slices + 8,
min_score=-1.0)`` solves every slice, as tests/test_wmd_provable_cut.py
drives it).  ``find_batch`` is held in tests/test_torch_transport_batch.py.
"""

import itertools
import string

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import vectorian_tpu as vj
import vectorian_tpu_torch as vt
from vectorian_tpu import native as jax_native
from vectorian_tpu.alignment import WordMoversDistance as JaxWMD
from vectorian_tpu.alignment import WordRotatorsDistance as JaxWRD
from vectorian_tpu.ops import emd_exact as jax_emd
from vectorian_tpu.ops import wmd as jax_wmd
from vectorian_tpu.ops.sinkhorn import sinkhorn_emd_score as jax_sinkhorn_score
from vectorian_tpu.saliency import KeywordSignal as JaxKeywordSignal
from vectorian_tpu.saliency import Saliency as JaxSaliency
from vectorian_tpu.sim.modifier import MixedTokenSimilarity as JaxMixed
from vectorian_tpu.sim.span import OptimizedSpanSim as JaxSpanSim
from vectorian_tpu.sim.token import EmbeddingTokenSim as JaxTokenSim
from vectorian_tpu_torch.alignment import WordMoversDistance, WordRotatorsDistance
from vectorian_tpu_torch.ops import emd_exact, wmd
from vectorian_tpu_torch.ops.search import order_by_score
from vectorian_tpu_torch.ops.sinkhorn import sinkhorn_emd_score
from vectorian_tpu_torch.sim.modifier import MixedTokenSimilarity
from vectorian_tpu_torch.sim.span import OptimizedSpanSim
from vectorian_tpu_torch.sim.token import EmbeddingTokenSim

from tests.test_torch_contextual import _sessions as _ctx_sessions
from tests.test_torch_slice import _assert_same_ranking, _pairs

torch.set_num_threads(2)

# (name, JAX optimizer, port optimizer)
METRICS = [
    ("rwmd/nbow", lambda: JaxWMD.rwmd("nbow"), lambda: WordMoversDistance.rwmd("nbow")),
    ("rwmd/nbow/distributed", lambda: JaxWMD.rwmd("nbow/distributed"),
     lambda: WordMoversDistance.rwmd("nbow/distributed")),
    ("rwmd/bow/fast", lambda: JaxWMD.rwmd("bow/fast"),
     lambda: WordMoversDistance.rwmd("bow/fast")),
    ("rwmd/default", lambda: JaxWMD(), lambda: WordMoversDistance()),
    ("rwmd/greedy/bow", lambda: JaxWMD(True, False, False, False),
     lambda: WordMoversDistance(True, False, False, False)),
    ("wmd/nbow", lambda: JaxWMD.wmd("nbow"), lambda: WordMoversDistance.wmd("nbow")),
    ("wmd/bow", lambda: JaxWMD.wmd("bow"), lambda: WordMoversDistance.wmd("bow")),
    ("wrd", lambda: JaxWRD(), lambda: WordRotatorsDistance()),
]
IDS = [m[0] for m in METRICS]
BY_NAME = {m[0]: m for m in METRICS}


def _base_words():
    return ["".join(p) for p in itertools.product(string.ascii_lowercase[:5], repeat=3)][:24]


def _cut_texts():
    """tests/test_wmd_provable_cut.py's corpus: heavy word repetition and
    clustered vectors, so the bound order and the exact order diverge."""
    rng = np.random.default_rng(31)
    base = _base_words()
    centers = rng.normal(size=(4, 12)).astype("float32")
    vecs = (centers[rng.integers(0, 4, size=len(base))]
            + 0.25 * rng.normal(size=(len(base), 12)).astype("float32")).astype("float32")
    sents = [" ".join(rng.choice(base[:12], size=int(rng.integers(3, 9)))) + "."
             for _ in range(60)]
    texts = [" ".join(sents[i : i + 15]) for i in range(0, 60, 15)]
    return base, vecs, texts


@pytest.fixture(scope="module")
def cut():
    base, vecs, texts = _cut_texts()
    sj = vj.Session([vj.StringImporter()(t, title=f"d{i}") for i, t in enumerate(texts)],
                    embeddings=[vj.KeyedVectors("pc", base, vecs)])
    st = vt.Session([vt.StringImporter()(t, title=f"d{i}") for i, t in enumerate(texts)],
                    embeddings=[vt.KeyedVectors("pc", base, vecs)], device="cpu")
    rng = np.random.default_rng(17)
    queries = [" ".join(rng.choice(base[:12], size=k)) for k in (3, 5, 7)]
    return sj, st, queries


@pytest.fixture(scope="module")
def ctx():
    return _ctx_sessions()


CTX_QUERIES = ["the old king rides", "a bird sings loud", "cat sleeps fast"]


def _indexes(sj, st, name, plan="static", **span):
    _, mk_j, mk_t = BY_NAME[name]
    if plan == "static":
        tj, tt = JaxTokenSim(sj.embeddings[0]), EmbeddingTokenSim(st.embeddings[0])
    elif plan == "ctx":
        tj, tt = JaxTokenSim(sj.embeddings[1]), EmbeddingTokenSim(st.embeddings[1])
    else:
        tj = JaxMixed([JaxTokenSim(sj.embeddings[0]), JaxTokenSim(sj.embeddings[1])],
                      [0.6, 0.4])
        tt = MixedTokenSimilarity([EmbeddingTokenSim(st.embeddings[0]),
                                   EmbeddingTokenSim(st.embeddings[1])], [0.6, 0.4])
    ij = sj.partition("sentence").index(JaxSpanSim(tj, mk_j(), **span))
    it = st.partition("sentence").index(OptimizedSpanSim(tt, mk_t(), **span))
    return ij, it


def _edges_close(mj, mt):
    """The same flow edges, flows and distances within 1e-6."""
    ej = sorted(mj._edge_list, key=lambda e: e[:2])
    et = sorted(mt._edge_list, key=lambda e: e[:2])
    assert [e[:2] for e in ej] == [e[:2] for e in et]
    for a, b in zip(ej, et):
        assert a[2] == pytest.approx(b[2], rel=1e-6, abs=1e-6)
        assert a[3] == pytest.approx(b[3], rel=1e-6, abs=1e-6)


def _edge_cost(match, m_t):
    """A match's transport cost: sum of flow x distance over its edges
    (an edge's flow is stored as a share of its needle token's mass)."""
    return sum(f * max(float(m_t[t]), 1e-12) * d for t, _, f, d in match._edge_list)


def _transport_close(mj, mt, solved):
    """Where the two packages may have run different exact solvers (the
    JAX package's HiGHS fallback can return another optimal flow at a
    degenerate optimum): the same transport cost (1e-6), and the port's
    flow within both marginals of its masses (a lighter side's mass moves
    whole, a heavier side's up to its mass)."""
    (m_t, m_s, D, _), r = solved
    m_t, m_s = np.asarray(m_t, np.float64), np.asarray(m_s, np.float64)
    G = np.asarray(r.flow, np.float64)
    tol = 1e-6
    assert np.all(G.sum(1) <= m_t + tol) and np.all(G.sum(0) <= m_s + tol)
    assert abs(G.sum() - min(m_t.sum(), m_s.sum())) <= tol
    cost = float(np.sum(G * np.asarray(D, np.float64)))
    assert _edge_cost(mt, m_t) == pytest.approx(cost, rel=tol, abs=tol)
    assert _edge_cost(mj, m_t) == pytest.approx(cost, rel=tol, abs=tol)


def _record_exact_solves(monkeypatch):
    """{slice id: ((m_t, m_s, D, penalty), EMDResult)} of every exact solve
    of the port's find calls from here on (``_host_rescore`` solves its
    candidates ``top`` in one batch, in their order)."""
    solved, batches = {}, []
    real_batch, real_rescore = wmd.emd_score_batch, wmd.WMDEngine._host_rescore

    def batch(specs):
        out = real_batch(specs)
        batches.append((list(specs), out))
        return out

    def rescore(self, index, query, qp, state, top, *a, **kw):
        n0 = len(batches)
        res = real_rescore(self, index, query, qp, state, top, *a, **kw)
        for specs, out in batches[n0:]:
            for sid, spec, (_, r) in zip(top, specs, out):
                solved[int(sid)] = (spec, r)
        return res

    monkeypatch.setattr(wmd, "emd_score_batch", batch)
    monkeypatch.setattr(wmd.WMDEngine, "_host_rescore", rescore)
    return solved


def _check_find(ij, it, queries, monkeypatch, n=5, min_score=0.1, **kw):
    """The port's find against the JAX package's: the same ranking (1e-6,
    tie bands aside) and, a shared match, the same flow edges — exactly
    where both packages ran the same solver (the relaxed flows' host code;
    the native SSP solver on both sides), else the transport cost and
    marginals of ``_transport_close``.  The solver check runs here, not
    at import: the JAX package's native library may fail to load in one
    test worker and not in another."""
    from vectorian_tpu_torch import native as port_native

    same_solver = jax_native.available() and port_native.available()
    solved = _record_exact_solves(monkeypatch)
    for q in queries:
        rj = ij.find(q, n=n, min_score=min_score, **kw)
        solved.clear()
        rt = it.find(q, n=n, min_score=min_score, **kw)
        assert len(rt), q
        _assert_same_ranking(_pairs(rj), _pairs(rt), min_score)
        by_sid = {m.slice_id: m for m in rj}
        for m in rt:
            if m.slice_id not in by_sid:
                continue
            if same_solver or m.slice_id not in solved:
                _edges_close(by_sid[m.slice_id], m)
            else:
                _transport_close(by_sid[m.slice_id], m, solved[m.slice_id])


# ---- host functions: bit-equal given equal inputs -------------------------


@pytest.mark.parametrize("injective,symmetric,normalize", list(
    itertools.product([False, True], repeat=3)))
def test_rwmd_score_host_is_jax_bit_for_bit(injective, symmetric, normalize):
    rng = np.random.default_rng(5)
    for _ in range(20):
        T, L = int(rng.integers(1, 9)), int(rng.integers(1, 17))
        m_t = rng.integers(0, 3, size=T).astype(np.float32)
        m_s = rng.integers(0, 3, size=L).astype(np.float32)
        D = rng.uniform(0, 1, size=(T, L)).astype(np.float32)
        D[:, rng.integers(0, L)] = D[0, 0]  # ties
        args = (m_t, m_s, D, injective, symmetric, normalize, float(T))
        got, want = wmd.rwmd_score_host(*args), jax_wmd.rwmd_score_host(*args)
        assert got.dtype == want.dtype == np.float32
        assert got.tobytes() == want.tobytes()
        assert (wmd.rwmd_flow_host(m_t, m_s, D, injective, normalize)
                == jax_wmd.rwmd_flow_host(m_t, m_s, D, injective, normalize))
    ids = list(rng.integers(0, 4, size=12))
    valid = rng.uniform(size=12) > 0.2
    assert np.array_equal(wmd.dedup_masses(ids, valid), jax_wmd.dedup_masses(ids, valid))


def _emd_specs(rng, k=40):
    specs = []
    for i in range(k):
        n1, n2 = int(rng.integers(1, 9)), int(rng.integers(1, 13))
        w1 = rng.uniform(0, 1, size=n1)
        w2 = rng.uniform(0, 1, size=n2)
        if i % 2:  # balanced
            w2 = w2 * (w1.sum() / w2.sum())
        specs.append((w1, w2, rng.uniform(0, 1, size=(n1, n2)),
                      -1.0 if i % 3 else 0.25))
    specs.append((np.zeros(3), np.ones(2), np.ones((3, 2)), -1.0))  # no mass
    return specs


def test_exact_emd_batch_matches_jax():
    """The port's copy of the native SSP solver, batched and threaded: the
    same flows and costs as its sequential solve bit for bit, and as the
    JAX package's (the same C++: bit for bit where the JAX package's
    native library loaded, else its scipy HiGHS fallback's cost)."""
    specs = _emd_specs(np.random.default_rng(9))
    got = emd_exact.exact_emd_batch(specs)
    want = jax_emd.exact_emd_batch(specs)
    jax_native_ok = jax_native.available()
    for spec, g, w in zip(specs, got, want):
        seq = emd_exact.exact_emd(*spec)
        assert g.success == w.success == seq.success
        assert g.cost == seq.cost and np.array_equal(g.flow, seq.flow)
        if jax_native_ok:
            assert g.cost == w.cost and np.array_equal(g.flow, w.flow)
        else:
            assert g.cost == pytest.approx(w.cost, rel=1e-9, abs=1e-12)
    scores = emd_exact.emd_score_batch(specs)
    for (s, _), (sj, _) in zip(scores, jax_emd.emd_score_batch(specs)):
        assert s == pytest.approx(sj, rel=1e-12, abs=1e-15)


def test_sinkhorn_matches_jax():
    rng = np.random.default_rng(2)
    B, n1, n2 = 16, 5, 7
    w1 = rng.uniform(0, 1, size=(B, n1)).astype(np.float32)
    w2 = rng.uniform(0, 1, size=(B, n2)).astype(np.float32)
    w2[:, -1] = 0.0  # a masked column
    D = rng.uniform(0, 1, size=(B, n1, n2)).astype(np.float32)
    want = np.asarray(jax_sinkhorn_score(jnp.asarray(w1), jnp.asarray(w2), jnp.asarray(D)))
    got = sinkhorn_emd_score(*(torch.as_tensor(a) for a in (w1, w2, D))).numpy()
    assert np.allclose(got, want, rtol=1e-6, atol=1e-6)
    # against the exact score it approximates (the JAX package's own check)
    exact = [emd_exact.emd_score(w1[b] / w1[b].sum(), w2[b] / w2[b].sum(), D[b])[0]
             for b in range(B)]
    assert np.allclose(got, exact, atol=0.05)


def test_greedy_fill_and_bound_match_jax():
    """The device ranking's torch ops against their jnp twins (1e-6), on
    both of the greedy fill's routes (comparison block, and the stable
    sort past 128 targets), with ties."""
    rng = np.random.default_rng(8)
    for n2 in (7, 130):
        B, n1 = 12, 5
        w1 = rng.integers(0, 3, size=(B, n1)).astype(np.float32)
        cap = rng.integers(0, 3, size=(B, n2)).astype(np.float32) / 2
        D = np.round(rng.uniform(0, 1, size=(B, n1, n2)), 2).astype(np.float32)
        for inj in (False, True):
            want = np.asarray(jax_wmd._greedy_fill_cost(
                jnp.asarray(w1), jnp.asarray(D), jnp.asarray(cap), inj))
            got = wmd._greedy_fill_cost(torch.as_tensor(w1), torch.as_tensor(D),
                                        torch.as_tensor(cap), inj).numpy()
            assert np.allclose(got, want, rtol=1e-6, atol=1e-6), (n2, inj)
        want = np.asarray(jax_wmd._emd_score_bound(jnp.asarray(w1), jnp.asarray(cap),
                                                   jnp.asarray(D)))
        got = wmd._emd_score_bound(torch.as_tensor(w1), torch.as_tensor(cap),
                                   torch.as_tensor(D)).numpy()
        assert np.allclose(got, want, rtol=1e-6, atol=1e-6)


def test_order_by_score_is_jax_bit_for_bit(cut):
    from vectorian_tpu.ops.search import order_by_score as jax_order

    sj, st, _ = cut
    packed = st.partition("sentence").index(EmbeddingTokenSim(st.embeddings[0])).packed
    rng = np.random.default_rng(1)
    ids = rng.permutation(packed.n_slices)[:30]
    scores = np.round(rng.uniform(size=30), 1).astype(np.float32)
    assert np.array_equal(order_by_score(packed, ids, scores),
                          jax_order(packed, ids, scores))


# ---- the device ranking passes --------------------------------------------


@pytest.mark.parametrize("name", IDS)
@pytest.mark.parametrize("variant", ["plain", "tags", "filter"])
def test_ranking_pass_matches_jax(cut, name, variant):
    """WMDEngine._score's [n_slices] ranking vector (host form) against the
    JAX package's (1e-6)."""
    sj, st, queries = cut
    span = ({"tag_weights": {"NN": 1.0, "VB": 0.5}, "pos_mismatch_penalty": 0.3,
             "similarity_threshold": 0.1} if variant == "tags" else {})
    ij, it = _indexes(sj, st, name, **span)
    kw = {"token_filter": [_base_words()[0]]} if variant == "filter" else {}
    for q in queries[:2]:
        pj = ij.make_query(q, **kw).prepare(ij._nlp)
        pt = it.make_query(q, **kw).prepare(it._nlp)
        from vectorian_tpu.index import _pad_needle as jax_pad
        from vectorian_tpu.ops.simmatrix import compile_plan as jax_compile

        tok, strings, ctx_q, _ = jax_pad(pj, sj, ctx_names=set())
        qp_j = jax_compile(ij._args["metric"]["token_sim"], sj.compiled_embeddings,
                           tok, strings, ctx_q, needs_magnitudes=name == "wrd")
        qp_t = it._compile_plan(pt, (), needs_magnitudes=name == "wrd")
        ej = jax_wmd.WMDEngine(ij._engine, ij._args["alignment"])
        et = wmd.WMDEngine(it._engine, it._args["alignment"])
        want = ej._score(ij, pj, qp_j, doc_filter=ij._doc_filter(pj))
        got = et._score(it, pt, qp_t, doc_filter=it._doc_filter(pt))
        assert np.allclose(got["scores"], want["scores"], rtol=1e-6, atol=1e-6)
        assert np.array_equal(got["mass_t"], want["mass_t"])
        if name == "wrd":
            assert np.allclose(got["mass_t_mag"], want["mass_t_mag"], rtol=1e-6)


# ---- find ------------------------------------------------------------------


@pytest.mark.parametrize("name", IDS)
def test_static_find_matches_jax(cut, name, monkeypatch):
    sj, st, queries = cut
    ij, it = _indexes(sj, st, name)
    _check_find(ij, it, queries, monkeypatch)


@pytest.mark.parametrize("name", IDS)
def test_static_find_matches_jax_without_its_native_library(cut, name, monkeypatch):
    """The JAX package's fallback path, forced: without its native library
    it solves exact EMD with scipy's HiGHS, whose optimal flow may differ
    from the native SSP solver's at a degenerate optimum; the port's find
    still agrees in ranking, transport cost and marginals."""
    from vectorian_tpu import native as jax_native_mod

    monkeypatch.setattr(jax_native_mod, "_LIB", None)
    monkeypatch.setattr(jax_native_mod, "_LIB_TRIED", True)
    assert not jax_native.available()
    sj, st, queries = cut
    ij, it = _indexes(sj, st, name)
    _check_find(ij, it, queries, monkeypatch)


# WRD of a mixed tree is left out: the JAX package ranks it with the tree's
# combined magnitudes but rescores with the first contextual leaf's norms
@pytest.mark.parametrize("name,plan", [(m, "ctx") for m in IDS]
                         + [(m, "mixed") for m in IDS if m != "wrd"])
def test_contextual_find_matches_jax(ctx, name, plan, monkeypatch):
    """Contextual operands: position-unique BOW entries (and the store's
    norms as WRD masses); a mixed tree for the WMD variants."""
    sj, st = ctx
    ij, it = _indexes(sj, st, name, plan=plan)
    _check_find(ij, it, CTX_QUERIES, monkeypatch, n=4, min_score=0.2)


@pytest.mark.parametrize("name", ["rwmd/nbow", "rwmd/bow/fast", "wmd/nbow", "wrd"])
@pytest.mark.parametrize("option", ["tags", "filter", "booster"])
def test_find_options_match_jax(cut, name, option):
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
    for q in queries:
        rj = ij.find(q, n=5, min_score=0.05, **kw_j)
        rt = it.find(q, n=5, min_score=0.05, **kw_t)
        assert len(rt)
        _assert_same_ranking(_pairs(rj), _pairs(rt), 0.05)


@pytest.mark.parametrize("name", ["rwmd/nbow", "wmd/nbow", "wrd"])
def test_debug_hooks_match_jax(cut, name):
    """find(debug=...): the ranking vector, then one solver payload a
    candidate, in the JAX package's sequence; the matches agree."""
    sj, st, queries = cut
    ij, it = _indexes(sj, st, name)
    hj, ht = [], []
    rj = ij.find(queries[1], n=4, min_score=0.1, debug=lambda k, p: hj.append((k, p)))
    rt = it.find(queries[1], n=4, min_score=0.1, debug=lambda k, p: ht.append((k, p)))
    assert [k for k, _ in ht] == [k for k, _ in hj]
    assert ht[0][0] == "scores"
    assert np.allclose(ht[0][1]["scores"], hj[0][1]["scores"], rtol=1e-6, atol=1e-6)
    assert {p["slice"] for k, p in ht[1:]} == {p["slice"] for k, p in hj[1:]}
    _assert_same_ranking(_pairs(rj), _pairs(rt), 0.1)


@pytest.mark.parametrize("name", ["wmd/nbow", "wmd/bow", "wrd"])
def test_full_transport_is_the_exhaustive_oracle(cut, name, monkeypatch):
    """The port's full WMD / WRD find returns the exhaustive exact-EMD
    oracle's top-k (membership, scores, order) while solving only a part
    of the corpus (tests/test_wmd_provable_cut.py's drive)."""
    _, st, queries = cut
    _, _, mk = BY_NAME[name]
    ix = st.partition("sentence").index(OptimizedSpanSim(
        EmbeddingTokenSim(st.embeddings[0]), mk()))
    n_slices = int(ix.packed.n_slices)
    solved = {"n": 0}
    orig = wmd.WMDEngine._host_rescore

    def spy(self, index, query, qp, state, top, *a, **kw):
        solved["n"] += len(top)
        return orig(self, index, query, qp, state, top, *a, **kw)

    monkeypatch.setattr(wmd.WMDEngine, "_host_rescore", spy)
    for q in queries:
        solved["n"] = 0
        exhaustive = ix.find(q, n=n_slices + 8, min_score=-1.0)
        assert solved["n"] >= n_slices
        for n, msc in ((3, -1.0), (5, 0.3), (10, 0.05)):
            want = [(m.slice_id, m.score) for m in exhaustive if m.score > msc][:n]
            solved["n"] = 0
            assert _pairs(ix.find(q, n=n, min_score=msc)) == want, (q, n, msc)
            assert solved["n"] < n_slices


def test_transport_match_json_and_regions(cut):
    """A transport match's JSON: sparse flow edges, regions without gap
    penalties (a transport index has no gap model)."""
    sj, st, queries = cut
    ij, it = _indexes(sj, st, "wmd/nbow")
    assert it.gap_costs() is None
    mj = ij.find(queries[2], n=2, min_score=0.1)
    mt = it.find(queries[2], n=2, min_score=0.1)
    from tests.test_torch_slice import _assert_json_close

    for a, b in zip(mj, mt):
        if a.slice_id == b.slice_id:
            _assert_json_close(a.to_json(), b.to_json())
            assert b.flow["type"] == "sparse"


def test_transport_find_batch_is_item_6b(cut):
    """The batches this test once expected to raise (item 6b, now served):
    WordMoversDistance() and WordRotatorsDistance() batches, with and
    without debug, against the JAX package's batch (the ranking rule) and
    the port's find (bytes)."""
    sj, st, queries = cut
    for mk_j, mk in ((JaxWMD, WordMoversDistance), (JaxWRD, WordRotatorsDistance)):
        ij = sj.partition("sentence").index(JaxSpanSim(
            JaxTokenSim(sj.embeddings[0]), mk_j()))
        ix = st.partition("sentence").index(OptimizedSpanSim(
            EmbeddingTokenSim(st.embeddings[0]), mk()))
        for kw in ({}, {"debug": lambda *a: None}):
            bj = ij.find_batch(queries, n=3, **kw)
            bt = ix.find_batch(queries, n=3, **kw)
            assert any(len(r) for r in bt)
            for rj, rt in zip(bj, bt):
                _assert_same_ranking(_pairs(rj), _pairs(rt), 0.2)
            assert [_pairs(r) for r in bt] == [
                _pairs(ix.find(q, n=3, **kw)) for q in queries]
