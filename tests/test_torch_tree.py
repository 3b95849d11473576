"""Mixed static + contextual trees and tagged contextual batches through
the port's ``find_batch``, against the JAX package on the CPU.

tests/test_torch_contextual.py's fixture (a static and a contextual
embedding over a few hundred sentences) under MixedTokenSimilarity and
MaximumTokenSimilarity trees, affine and general gaps: the stacked plans'
evaluation (``stack_tree_plans``) and the tree pass's [n_slices, Q] scores
(``tree_pass``, the dense DP kernels' plain versions) within
1e-6 of the JAX package's; then ``find`` and ``find_batch`` with a booster,
a document-side filter, ``submatch_weight`` and ``bidirectional``, and a
contextual metric with tag weights.  Tolerance: scores within 1e-6
relative and the same slices except inside bands of tied scores; inside
the port ``find`` = ``find_batch`` byte for byte at every
``sim_precision``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vectorian_tpu.index import _pad_needle as jax_pad
from vectorian_tpu.ops.alignment import AffineGapParams as JaxGaps
from vectorian_tpu.ops.search import stack_tree_plans as jax_stack_tree_plans
from vectorian_tpu.ops.simmatrix import compile_plan as jax_compile
from vectorian_tpu.ops.simmatrix import eval_plan_chunk as jax_eval_plan_chunk
from vectorian_tpu_torch.ops import dp_kernels
from vectorian_tpu_torch.ops.search import stack_tree_plans
from vectorian_tpu_torch.ops.simmatrix import eval_plan_chunk

from tests.test_contextual import DIM
from tests.test_torch_contextual import (
    CTX_OPTIONS,
    QUERIES,
    _check_find_and_batch,
    _ctx_indexes,
    _options,
    _sessions,
)
from tests.test_torch_slice import _assert_same_ranking, _pairs

torch.set_num_threads(2)

TAGS = {"tag_weights": {"NN": 1.0, "VB": 0.5, "DT": 0.2},
        "pos_mismatch_penalty": 0.3, "similarity_threshold": 0.05}


@pytest.fixture(scope="module")
def both():
    return _sessions()


def _plans(ij, it, sj, st, queries):
    qj = [ij.make_query(q).prepare(ij._nlp) for q in queries]
    qt = [it.make_query(q).prepare(it._nlp) for q in queries]
    token_sim = ij._args["metric"]["token_sim"]
    plans_j = []
    for q in qj:
        tok, strings, ctx_q, _ = jax_pad(q, sj, ctx_names={"ctx"})
        plans_j.append(jax_compile(token_sim, sj.compiled_embeddings, tok, strings, ctx_q))
    plans_t = [it._compile_plan(q, {"ctx"}) for q in qt]
    ij._engine.ensure_contextual("ctx", sj.documents, DIM)
    it._engine.ensure_contextual("ctx", st.documents, DIM)
    return qj, qt, plans_j, plans_t


@pytest.mark.parametrize("tree", ["mixed", "max"])
def test_stacked_plans_evaluate_as_jax(both, tree):
    """A bucket's chunk through the stacked plans: the static leaves'
    [V, Tpad * Q] tables hold each plan's columns bit for bit, and the
    [c, L, Tpad * Q] evaluation agrees with the JAX package's (1e-6)."""
    sj, st = both
    ij, it = _ctx_indexes(sj, st, tree=tree)
    qj, qt, plans_j, plans_t = _plans(ij, it, sj, st, QUERIES)
    lts = [max(q.n_tokens, 1) for q in qt]
    sp, Tpad = stack_tree_plans(plans_t, lts, torch.device("cpu"))
    statics_j, ctx_j, weights_j, Tpad_j = jax_stack_tree_plans(plans_j, lts)
    assert Tpad == Tpad_j == 8
    Q = len(QUERIES)
    for q, qp in enumerate(plans_t):
        m = qp.static_sims[0]
        block = sp.static_sims[0].reshape(-1, Tpad, Q)[:, :, q]
        assert torch.equal(block[:, : m.shape[1]], m)
        assert not block[:, m.shape[1]:].any()
    db = it._engine._device_buckets[0]
    n = db["n"]
    store_j = ij._engine._ctx_stores["ctx"][0][:n]
    want = np.asarray(jax_eval_plan_chunk(
        plans_j[0].plan, jnp.asarray(db["tokens"].numpy()), statics_j,
        tuple(plans_j[0].static_mags), (store_j,), ctx_j, weights_j)["similarity"])
    got = eval_plan_chunk(sp, db["tokens"], (it._engine._ctx_stores["ctx"][0],))
    assert got["similarity"].shape == (n, db["capacity"], Tpad * Q)
    assert np.allclose(got["similarity"].numpy(), want, rtol=1e-6, atol=1e-6)
    other = _ctx_indexes(sj, st, tree="max" if tree == "mixed" else "mixed")[1]
    with pytest.raises(ValueError, match="trees differ"):
        stack_tree_plans([plans_t[0], other._compile_plan(qt[1], {"ctx"})], lts[:2], "cpu")


@pytest.mark.parametrize("tags", [False, True], ids=["untagged", "tagged"])
@pytest.mark.parametrize("tree", ["mixed", "max"])
@pytest.mark.parametrize("general", [False, True])
def test_tree_pass_scores_match_jax(both, tree, general, tags):
    """tree_pass: the [n_slices, Q] ranking scores of the tree
    pass (tag rewrite on the combined similarity; a query without tags
    stays the identity) against the JAX package's (1e-6); on the CPU the
    dense entries take their plain versions and count no launch."""
    sj, st = both
    span = TAGS if tags else {}
    ij, it = _ctx_indexes(sj, st, general=general, tree=tree, **span)
    qj, qt, plans_j, plans_t = _plans(ij, it, sj, st, QUERIES)
    lts = [max(q.n_tokens, 1) for q in qt]
    tw_t = [it._tag_weighting(q, p.width) for q, p in zip(qt, plans_t)]
    tw_j = [ij._tag_weighting(q, width=p.width) for q, p in zip(qj, plans_t)]
    if tags:  # one query of the batch without tag weights
        tw_t[1] = tw_j[1] = None
    nts = [float(x) for x in lts]
    gaps_j = ij._affine_gaps() or JaxGaps.of(0, 0, 0, 0)
    dp_kernels.reset_launches()
    want = ij._engine.score_all_multi_tree(
        plans_j, lts, gaps_j, "local", nts,
        gap_costs=(ij._gap_s, ij._gap_t) if general else None,
        tag_weights=tw_j if tags else None)
    got = it._engine.collect(it._engine.tree_pass(
        plans_t, lts, it._gaps, "local", nts, gap_costs=it._gap_costs,
        tag_weights=tw_t if tags else None), len(QUERIES))
    assert got.shape == want.shape == (it._engine.n_slices, len(QUERIES))
    assert np.allclose(got, want, rtol=1e-6, atol=1e-6)
    assert not any(dp_kernels.LAUNCHES.values())


@pytest.mark.parametrize("option", sorted(CTX_OPTIONS))
@pytest.mark.parametrize("tree", ["mixed", "max"])
@pytest.mark.parametrize("general", [False, True])
def test_tree_find_and_find_batch_match_jax(both, tree, general, option):
    """find and find_batch of a mixed tree against the JAX package's, and
    the port's find = find_batch byte for byte, under each query option."""
    sj, st = both
    ij, it = _ctx_indexes(sj, st, general=general, tree=tree)
    _check_find_and_batch(ij, it, _options(option, "jax"), _options(option, "port"))


@pytest.mark.parametrize("tree", [None, "mixed"], ids=["contextual", "mixed"])
@pytest.mark.parametrize("general", [False, True])
def test_tagged_batch_matches_jax(both, tree, general):
    """A contextual metric (and a mixed tree) with tag weights: the JAX
    package routes its batch to the tree pass, and so does the port."""
    sj, st = both
    ij, it = _ctx_indexes(sj, st, general=general, tree=tree, **TAGS)
    _check_find_and_batch(ij, it, {}, {})


@pytest.mark.parametrize("tree", [None, "mixed", "max"])
def test_find_batch_is_find_at_every_precision(both, tree):
    """The tree and tagged batches rank in f32 whatever ``sim_precision``
    asks (the contextual block has no quantized table): every precision
    returns find's bytes."""
    sj, st = both
    span = TAGS if tree is None else {}
    _, it = _ctx_indexes(sj, st, tree=tree, **span)
    want = [_pairs(it.find(q, n=4, min_score=0.1)) for q in QUERIES]
    assert any(want)
    for prec in ("int8", "bfloat16", "float32"):
        got = [_pairs(r) for r in it.find_batch(QUERIES, n=4, min_score=0.1,
                                                sim_precision=prec)]
        assert got == want, prec


def test_tree_batch_runs_the_tree_pass(both, monkeypatch):
    """Every contextual batch makes ONE tree pass for all its queries: a
    mixed tree's, a contextual batch with tag weights, and the untagged
    single-embedding batch (its plan is the one-leaf tree)."""
    sj, st = both
    calls = {"tree": 0, "Q": []}
    eng_cls = type(_ctx_indexes(sj, st)[1]._engine)
    orig_tree = eng_cls.tree_pass

    def tree(self, plans, *a, **kw):
        calls["tree"] += 1
        calls["Q"].append(len(plans))
        return orig_tree(self, plans, *a, **kw)

    monkeypatch.setattr(eng_cls, "tree_pass", tree)
    for kind, span in ((None, {}), (None, TAGS), ("mixed", {})):
        calls.update(tree=0, Q=[])
        _, it = _ctx_indexes(sj, st, tree=kind, **span)
        it.find_batch(QUERIES, n=3, min_score=0.1)
        assert calls == {"tree": 1, "Q": [len(QUERIES)]}, (kind, span)


def test_tree_empty_and_unknown_queries(both):
    """Queries without a kept token get empty results in their place."""
    sj, st = both
    ij, it = _ctx_indexes(sj, st, tree="mixed")
    texts = ["...", QUERIES[0], ""]
    got = it.find_batch(texts, n=3, min_score=0.1)
    want = ij.find_batch(texts, n=3, min_score=0.1)
    assert [len(r) for r in got][0::2] == [0, 0]
    _assert_same_ranking(_pairs(want[1]), _pairs(got[1]), 0.1)


@pytest.fixture(scope="module")
def config4(tmp_path_factory):
    """tests/test_baseline_config4.py's configuration in both packages: a
    fastText model product-quantized by the port's
    QuantizedFastTextModel.compress (the JAX package loads the same .npz)
    and a PCA-compressed contextual embedding."""
    import vectorian_tpu as vj
    import vectorian_tpu_torch as vt
    from vectorian_tpu.embedding.contextual import LambdaContextualEmbedding as JaxLambda
    from vectorian_tpu.embedding.fasttext import QuantizedFastText as JaxQFT
    from vectorian_tpu_torch.embedding.fasttext import (
        FastTextModel,
        QuantizedFastText,
        QuantizedFastTextModel,
    )

    from tests.test_contextual import ctx_fn
    from tests.test_fasttext import write_fake_bin

    tmp = tmp_path_factory.mktemp("cfg4")
    words = ["the", "old", "king", "rides", "grey", "horse", "cat", "sleeps",
             "sun", "shines", "over", "sea", "a"]
    write_fake_bin(tmp / "ft.bin", words, dim=16, bucket=128)
    QuantizedFastTextModel.compress(
        FastTextModel.load(tmp / "ft.bin"), n_subvectors=4, n_codes=32, n_train=1000,
        n_iters=8).save(tmp / "ft.quant.npz")
    text = ("the old king rides the grey horse. a cat sleeps. the sun shines over "
            "the sea. the grey cat rides over the old sea. a king sleeps.")
    sj = vj.Session([vj.StringImporter()(text, title="d0")],
                    embeddings=[JaxQFT(tmp / "ft.quant.npz", name="qft"),
                                JaxLambda("cfg4-ctx", ctx_fn, DIM).pca(8)])
    st = vt.Session([vt.StringImporter()(text, title="d0")],
                    embeddings=[QuantizedFastText(tmp / "ft.quant.npz", name="qft"),
                                vt.LambdaContextualEmbedding("cfg4-ctx", ctx_fn, DIM).pca(8)],
                    device="cpu")
    return sj, st


@pytest.mark.parametrize("general", [False, True])
def test_config4_mixed_compressed_search(config4, general):
    """BASELINE config 4 on the port: the mixed (compressed-ngram static,
    PCA contextual) metric finds the planted sentence near 1.0, OOV query
    words get n-gram vectors, the mixture lies between the pure metrics,
    and find / find_batch (the tree pass) match the JAX package's."""
    from vectorian_tpu.alignment import ExponentialGapCost as JaxExponential
    from vectorian_tpu.alignment import LocalAlignment as JaxLocal
    from vectorian_tpu.sim.modifier import MixedTokenSimilarity as JaxMixed
    from vectorian_tpu.sim.span import OptimizedSpanSim as JaxSpanSim
    from vectorian_tpu.sim.token import EmbeddingTokenSim as JaxTokenSim
    from vectorian_tpu_torch.alignment import ExponentialGapCost, LocalAlignment
    from vectorian_tpu_torch.sim.modifier import MixedTokenSimilarity
    from vectorian_tpu_torch.sim.span import OptimizedSpanSim
    from vectorian_tpu_torch.sim.token import EmbeddingTokenSim

    sj, st = config4
    qft, ctx = st.embeddings
    p = st.partition("sentence")
    mixed = MixedTokenSimilarity([EmbeddingTokenSim(qft), EmbeddingTokenSim(ctx)],
                                 [0.5, 0.5])
    align = LocalAlignment(ExponentialGapCost(3.0)) if general else LocalAlignment()
    ix = p.index(OptimizedSpanSim(mixed, align))
    r = ix.find("the old king rides the grey horse", n=3, min_score=-5.0)
    assert r[0].score == pytest.approx(1.0, abs=0.02)
    assert r[0].to_json()["regions"]
    assert len(ix.find("kingz ridez horze", n=3, min_score=-5.0)) >= 1
    q = "old cat over the sea"
    sm = {m.slice_id: m.score for m in ix.find(q, n=5, min_score=-5.0)}
    ss = {m.slice_id: m.score for m in p.index(OptimizedSpanSim(
        EmbeddingTokenSim(qft), align)).find(q, n=5, min_score=-5.0)}
    sc = {m.slice_id: m.score for m in p.index(OptimizedSpanSim(
        EmbeddingTokenSim(ctx), align)).find(q, n=5, min_score=-5.0)}
    sid = next(iter(sm))
    lo, hi = sorted([ss[sid], sc[sid]])
    assert lo - 0.05 <= sm[sid] <= hi + 0.05
    for pd in st.documents:
        assert pd.contextual["cfg4-ctx"].shape[1] == 8

    jq, jc = sj.embeddings
    ij = sj.partition("sentence").index(JaxSpanSim(
        JaxMixed([JaxTokenSim(jq), JaxTokenSim(jc)], [0.5, 0.5]),
        JaxLocal(JaxExponential(3.0)) if general else JaxLocal()))
    qs = ["the old king rides the grey horse", q, "kingz ridez horze", "a cat sleeps"]
    got = [_pairs(rr) for rr in ix.find_batch(qs, n=3, min_score=0.0)]
    assert got == [_pairs(ix.find(x, n=3, min_score=0.0)) for x in qs]
    for w, g in zip(ij.find_batch(qs, n=3, min_score=0.0), got):
        _assert_same_ranking(_pairs(w), g, 0.0)
