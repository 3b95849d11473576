"""The port's static search slice against the JAX package, end to end.

A toy corpus (the verify-skill drive plus a few hundred random Zipf
sentences) goes through both packages on the CPU: the carried state must be
identical, the [V, T] similarity tables agree to GEMM summation order, and
find/find_batch return the same slices with scores within 1e-6 relative
(ids may differ only inside bands of tied scores), under affine and general
(Waterman-Smith-Beyer) gap models.  Inside the port, find and find_batch
are byte-identical.
"""

import numpy as np
import pytest
import torch

import vectorian_tpu as vj
import vectorian_tpu_torch as vt
from vectorian_tpu.alignment import AffineGapCost as JaxAffine
from vectorian_tpu.alignment import CustomGapCost as JaxCustom
from vectorian_tpu.alignment import ExponentialGapCost as JaxExponential
from vectorian_tpu.alignment import GlobalAlignment as JaxGlobal
from vectorian_tpu.alignment import LocalAlignment as JaxLocal
from vectorian_tpu.alignment import SemiGlobalAlignment as JaxSemiGlobal
from vectorian_tpu.metrics import EmbeddingTokenSim as JaxTokenSim
from vectorian_tpu.metrics import OptimizedSpanSim as JaxSpanSim
from vectorian_tpu.ops.simmatrix import compile_similarity as jax_compile_similarity
from vectorian_tpu_torch.alignment import (
    AffineGapCost,
    CustomGapCost,
    ExponentialGapCost,
    GlobalAlignment,
    LocalAlignment,
    SemiGlobalAlignment,
)
from vectorian_tpu_torch.ops import dp_kernels
from vectorian_tpu_torch.convert import state_from_numpy
from vectorian_tpu_torch.metrics import EmbeddingTokenSim, OptimizedSpanSim
from vectorian_tpu_torch.ops.simmatrix import compile_similarity

torch.set_num_threads(2)

REL = 1e-6  # scores: the similarity GEMM sums in another order


def _corpus(seed=1):
    rng = np.random.default_rng(seed)
    words = ["sun", "moon", "shines", "over", "the", "sea"] + [
        "".join(chr(97 + int(c)) for c in rng.integers(0, 26, size=4 + i % 3))
        for i in range(54)
    ]
    mat = rng.normal(size=(len(words), 16)).astype(np.float32)
    p = 1.0 / np.arange(1, len(words) + 1) ** 1.1
    p /= p.sum()
    texts = ["The sun shines over the sea. Stars at night."]
    for _ in range(4):
        sents = [
            " ".join(rng.choice(words, size=int(rng.integers(1, 12)), p=p)) + "."
            for _ in range(60)
        ]
        texts.append(" ".join(sents))
    queries = ["the sun shines over the sea"] + [
        " ".join(rng.choice(words, size=int(rng.integers(1, 9)), p=p))
        for _ in range(5)
    ]
    return words, mat, texts, queries


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


def _indexes(sj, st, locality):
    if locality == "local":
        opt_j, opt_t = JaxLocal(), LocalAlignment()
    else:
        opt_j = JaxGlobal(JaxAffine(0.37, 0.113))
        opt_t = GlobalAlignment(AffineGapCost(0.37, 0.113))
    ij = sj.partition("sentence").index(
        JaxSpanSim(JaxTokenSim(sj.embeddings[0]), opt_j)
    )
    it = st.partition("sentence").index(
        OptimizedSpanSim(EmbeddingTokenSim(st.embeddings[0]), opt_t)
    )
    return ij, it


def _pairs(result):
    return [(m.slice_id, m.score) for m in result]


def _assert_same_ranking(want, got, min_score):
    """Same slices and scores within REL, except inside tied bands: ids may
    swap where scores tie, and at the cut or at min_score a tied slice may
    be in one list only."""

    def tol(s):
        return REL * max(1.0, abs(s))

    for (_, a), (_, b) in zip(want, got):
        assert abs(a - b) <= tol(a)
    smap_w, smap_g = dict(want), dict(got)
    for sid in smap_w.keys() & smap_g.keys():
        assert abs(smap_w[sid] - smap_g[sid]) <= tol(smap_w[sid])
    for mine, other in ((want, got), (got, want)):
        ids_other = {sid for sid, _ in other}
        edge = other[-1][1] if other else min_score
        for sid, s in mine:
            if sid not in ids_other:
                assert abs(s - edge) <= tol(s) or abs(s - min_score) <= tol(s)


def test_carried_state_is_identical(both):
    sj, st, _ = both
    spec = sj.partition("sentence").spec
    pj = sj.packed_corpus(spec)
    arrays = {
        "vocab": list(sj.vocab.tokens.strings),
        "embeddings": {
            name: np.asarray(ce.unmodified)
            for name, ce in sj.compiled_embeddings.items()
        },
        "buckets": [
            {
                "capacity": b.capacity, "tokens": b.token_ids, "pos": b.pos_ids,
                "tag": b.tag_ids, "lengths": b.lengths,
                "slice_index": b.slice_index,
            }
            for b in pj.buckets
        ],
        "slice_doc": pj.slice_doc, "slice_idx": pj.slice_idx,
        "slice_start": pj.slice_start, "slice_len": pj.slice_len,
        "partition": (spec.level, spec.window_size, spec.window_step),
        "n_docs": pj.n_docs,
    }
    packed, compiled = state_from_numpy(arrays, device="cpu")
    assert list(st.vocab.tokens.strings) == arrays["vocab"]
    own = st.packed_corpus(st.partition("sentence").spec)
    for p in (packed, own):
        assert len(p.buckets) == len(pj.buckets)
        for b, bj in zip(p.buckets, pj.buckets):
            assert b.capacity == bj.capacity
            for f in ("token_ids", "pos_ids", "tag_ids", "lengths", "slice_index"):
                assert np.array_equal(getattr(b, f), getattr(bj, f)), f
        for f in ("slice_doc", "slice_idx", "slice_start", "slice_len"):
            assert np.array_equal(getattr(p, f), getattr(pj, f)), f
    for name, ce in compiled.items():
        mine = st.compiled_embeddings[name]
        for f in ("unmodified", "normalized", "magnitudes"):
            assert torch.equal(getattr(ce, f), getattr(mine, f)), f


def test_similarity_matrix_matches(both):
    sj, st, queries = both
    tsj = JaxTokenSim(sj.embeddings[0])
    tst = EmbeddingTokenSim(st.embeddings[0])
    for q in queries:
        toks = q.split() + ["unknownword"]
        ids_j = sj.vocab.tokens.lookup_many(toks)
        ids_t = st.vocab.tokens.lookup_many(toks)
        assert np.array_equal(ids_j, ids_t)
        want = np.asarray(
            jax_compile_similarity(tsj, sj.compiled_embeddings, ids_j, toks)[
                "similarity"
            ]
        )
        got = compile_similarity(tst, st.compiled_embeddings, ids_t, toks)[
            "similarity"
        ].numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("locality", ["local", "global"])
def test_find_and_find_batch_match_jax(both, locality):
    sj, st, queries = both
    ij, it = _indexes(sj, st, locality)
    n, min_score = 5, 0.1
    port_find = []
    for q in queries:
        want = _pairs(ij.find(q, n=n, min_score=min_score))
        got = _pairs(it.find(q, n=n, min_score=min_score))
        assert got, q
        _assert_same_ranking(want, got, min_score)
        port_find.append(got)
    want_b = ij.find_batch(queries, n=n, min_score=min_score, sim_precision="float32")
    got_b = it.find_batch(queries, n=n, min_score=min_score)
    for w, g in zip(want_b, got_b):
        _assert_same_ranking(_pairs(w), _pairs(g), min_score)
    # inside the port: find and find_batch are byte-identical
    assert [_pairs(r) for r in got_b] == port_find


def _assert_json_close(a, b):
    """Equal JSON, floats within REL (flow distances are 1 - similarity,
    which carries the GEMM's last-bit differences)."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and a.keys() == b.keys()
        for k in a:
            _assert_json_close(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert isinstance(b, (list, tuple)) and len(a) == len(b)
        for x, y in zip(a, b):
            _assert_json_close(x, y)
    elif isinstance(a, float):
        assert abs(a - b) <= REL * max(1.0, abs(a))
    else:
        assert a == b


def test_match_json_matches_jax(both):
    sj, st, queries = both
    ij, it = _indexes(sj, st, "local")
    for q in queries:
        mj = ij.find(q, n=3, min_score=0.1)
        mt = it.find(q, n=3, min_score=0.1)
        for a, b in zip(mj, mt):
            if a.slice_id != b.slice_id:
                continue  # a tied band swapped them
            _assert_json_close(a.to_json(), b.to_json())


def test_unported_options_raise(both):
    """mesh= (a make_mesh of CPU devices) returns the unsharded bytes and a
    non-mesh object raises TypeError; paged mode (Session(paged=True))
    serves the bytes of resident mode; submatch_weight and debug are
    served (find's full-read paths; find_batch takes debug query by query
    through find), under affine and general gap models."""
    _, st, queries = both
    it = st.partition("sentence").index(
        OptimizedSpanSim(EmbeddingTokenSim(st.embeddings[0]), LocalAlignment())
    )
    mesh = vt.make_mesh(["cpu"] * 2)
    assert [_pairs(r) for r in it.find_batch(queries[:2], mesh=mesh)] == [
        _pairs(r) for r in it.find_batch(queries[:2])]
    assert _pairs(it.find(queries[0], mesh=mesh)) == _pairs(it.find(queries[0]))
    with pytest.raises(TypeError):
        it.find_batch(queries[:2], mesh=object())
    with pytest.raises(TypeError):
        it.find(queries[0], mesh=object())
    words, mat, texts, _ = _corpus()
    sp = vt.Session(
        [vt.StringImporter()(t, title=f"d{i}") for i, t in enumerate(texts)],
        embeddings=[vt.KeyedVectors("toy", words, mat)], device="cpu", paged=True,
    )
    ip = sp.partition("sentence").index(
        OptimizedSpanSim(EmbeddingTokenSim(sp.embeddings[0]), LocalAlignment())
    )
    assert ip._engine.paged
    assert [_pairs(ip.find(q, n=3, min_score=0.1)) for q in queries] == [
        _pairs(it.find(q, n=3, min_score=0.1)) for q in queries]
    assert [_pairs(r) for r in ip.find_batch(queries, n=3, min_score=0.1)] == [
        _pairs(r) for r in it.find_batch(queries, n=3, min_score=0.1)]
    # a non-affine gap model is served (the general-gap WSB path), and so
    # are every query option, submatch_weight and debug included
    ig = st.partition("sentence").index(
        OptimizedSpanSim(
            EmbeddingTokenSim(st.embeddings[0]),
            LocalAlignment(ExponentialGapCost(0.5)),
        )
    )
    assert _pairs(ig.find(queries[0], n=3, min_score=0.1))
    for opt in ({"bidirectional": True}, {"token_filter": ["sun"]}):
        assert _pairs(ig.find(queries[0], n=3, min_score=0.1, **opt))
    hooks = []
    for index in (it, ig):
        for opt in ({"submatch_weight": 0.5},
                    {"debug": lambda name, payload: hooks.append(name)}):
            got = [_pairs(index.find(q, n=3, min_score=0.1, **opt))
                   for q in queries[:2]]
            assert got[0]
            batch = index.find_batch(queries[:2], n=3, min_score=0.1, **opt)
            assert [_pairs(r) for r in batch] == got
    assert {"static_similarity_matrix", "scores", "alignment"} <= set(hooks)


LOCALITY_CLASSES = {
    "local": (JaxLocal, LocalAlignment),
    "global": (JaxGlobal, GlobalAlignment),
    "semiglobal": (JaxSemiGlobal, SemiGlobalAlignment),
}
GENERAL_GAPS = {
    "exponential": (lambda: JaxExponential(3.0), lambda: ExponentialGapCost(3.0)),
    "custom": (
        lambda: JaxCustom(lambda k: 0.1 * k ** 0.5),
        lambda: CustomGapCost(lambda k: 0.1 * k ** 0.5),
    ),
}


def _general_indexes(sj, st, locality, gap_model):
    opt_j, opt_t = LOCALITY_CLASSES[locality]
    gap_j, gap_t = GENERAL_GAPS[gap_model]
    ij = sj.partition("sentence").index(
        JaxSpanSim(JaxTokenSim(sj.embeddings[0]), opt_j(gap_j()))
    )
    it = st.partition("sentence").index(
        OptimizedSpanSim(EmbeddingTokenSim(st.embeddings[0]), opt_t(gap_t()))
    )
    return ij, it


@pytest.mark.parametrize("gap_model", sorted(GENERAL_GAPS))
@pytest.mark.parametrize("locality", sorted(LOCALITY_CLASSES))
def test_general_gaps_find_and_find_batch_match_jax(both, locality, gap_model):
    """Non-affine gap models (the WSB DP): find/find_batch agree with the
    JAX package, find == find_batch byte for byte inside the port, and
    Match.to_json agrees (gap penalties come from GapCost.costs)."""
    sj, st, queries = both
    ij, it = _general_indexes(sj, st, locality, gap_model)
    n = 5
    # global scores go negative: keep every slice in play
    min_score = -10.0 if locality == "global" else 0.1
    dp_kernels.reset_launches()
    port_find = []
    for q in queries:
        want = _pairs(ij.find(q, n=n, min_score=min_score))
        got = _pairs(it.find(q, n=n, min_score=min_score))
        assert got, q
        _assert_same_ranking(want, got, min_score)
        port_find.append(got)
    want_b = ij.find_batch(queries, n=n, min_score=min_score, sim_precision="float32")
    got_b = it.find_batch(queries, n=n, min_score=min_score)
    for w, g in zip(want_b, got_b):
        _assert_same_ranking(_pairs(w), _pairs(g), min_score)
    assert [_pairs(r) for r in got_b] == port_find
    # tensors on the CPU take the plain versions: no kernel launch counted
    assert not any(dp_kernels.LAUNCHES.values())
    # "the sun over the sea" aligns to slice 0 around the unmatched
    # "shines": a gap between matched anchors, priced by GapCost.costs
    penalties = []
    for q in ["the sun over the sea"] + queries[:3]:
        mj = ij.find(q, n=3, min_score=min_score)
        mt = it.find(q, n=3, min_score=min_score)
        for a, b in zip(mj, mt):
            if a.slice_id != b.slice_id:
                continue  # a tied band swapped them
            ja, jb = a.to_json(), b.to_json()
            _assert_json_close(ja, jb)
            penalties += [r.get("gap_penalty", 0.0) for r in jb["regions"]]
    assert max(penalties) > 0.0


@pytest.fixture(scope="module")
def duplicates():
    """A corpus where one sentence repeats 600 times: the top score ties
    far past the fused top-k's deep fetch, so every query's cut is unsafe
    and the finalizer's extras round (column select + score-only rescore)
    runs."""
    words, mat, _, _ = _corpus()
    rng = np.random.default_rng(5)
    sents = ["the sun shines over the sea."] * 600 + [
        " ".join(rng.choice(words, size=int(rng.integers(2, 9)))) + "."
        for _ in range(200)
    ]
    rng.shuffle(sents)
    texts = [" ".join(sents[i : i + 100]) for i in range(0, len(sents), 100)]
    sj = vj.Session(
        [vj.StringImporter()(t, title=f"d{i}") for i, t in enumerate(texts)],
        embeddings=[vj.KeyedVectors("toy", words, mat)],
    )
    st = vt.Session(
        [vt.StringImporter()(t, title=f"d{i}") for i, t in enumerate(texts)],
        embeddings=[vt.KeyedVectors("toy", words, mat)],
        device="cpu",
    )
    queries = ["the sun shines over the sea", "sun shines", "the sea"] + [
        " ".join(rng.choice(words, size=4)) for _ in range(9)
    ]
    return sj, st, queries


@pytest.mark.parametrize("gap_model", ["affine", "exponential"])
def test_unsafe_cut_extras_match_jax(duplicates, gap_model, monkeypatch):
    """The tie-bounded extras round runs the score-only rescore (the
    row-gather DP entry of the gap model) in find and find_batch, and the
    results still match the JAX package."""
    from vectorian_tpu_torch.ops import search

    sj, st, queries = duplicates
    if gap_model == "affine":
        ij, it = _indexes(sj, st, "local")
        entry = "affine_dp_scores_rows"
    else:
        ij, it = _general_indexes(sj, st, "local", gap_model)
        entry = "wsb_dp_scores_rows"
    calls = []
    real = getattr(search, entry)
    monkeypatch.setattr(
        search, entry,
        lambda *a, **k: calls.append(a[1].shape) or real(*a, **k),
    )
    n, min_score = 10, 0.1
    got_f = [_pairs(it.find(q, n=n, min_score=min_score)) for q in queries[:3]]
    calls_find = len(calls)
    got_b = [_pairs(r) for r in it.find_batch(queries, n=n, min_score=min_score)]
    assert calls_find > 0 and len(calls) > calls_find
    want_f = [_pairs(ij.find(q, n=n, min_score=min_score)) for q in queries[:3]]
    want_b = ij.find_batch(queries, n=n, min_score=min_score, sim_precision="float32")
    # 600 tied copies: the top-n are n copies of one score
    assert len(got_f[0]) == n and len({s for _, s in got_f[0]}) == 1
    for w, g in zip(want_f, got_f):
        _assert_same_ranking(w, g, min_score)
    for w, g in zip(want_b, got_b):
        _assert_same_ranking(_pairs(w), g, min_score)
    assert got_b[:3] == got_f
