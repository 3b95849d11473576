"""Span embeddings in the port against the JAX package, on the CPU.

SentenceEmbedding (mean, min, max of a static embedding's rows and of the
contextual bf16 store), TextSpanEmbedding and SpacySpanEmbedding through
EmbeddedSpanSim's exact index (``SpanEncoderIndex``: one metric GEMM and a
tie-complete top-k) and approximate one (``ApproximateSpanIndex``: the
spherical k-means from ``default_rng(0)``, then the probed lists): the
corpus's span vectors within 1e-6, the same shortlist, scores within 1e-6
relative with the same slices except inside bands of tied scores; ``save``
/ ``load`` with the provenance check; ``decompose_nlp`` with a fake
pipeline.
"""

import numpy as np
import pytest
import torch

import vectorian_tpu as vj
import vectorian_tpu_torch as vt
from vectorian_tpu.embedding import pipeline as jax_pipeline
from vectorian_tpu.sim.span import EmbeddedSpanSim as JaxEmbeddedSpanSim
from vectorian_tpu_torch.embedding import pipeline
from vectorian_tpu_torch.embedding.span import SpanVectors
from vectorian_tpu_torch.index import ApproximateSpanIndex, SpanEncoderIndex
from vectorian_tpu_torch.sim.span import EmbeddedSpanSim

from tests.helpers import WORDS, make_corpus_texts, word_vector
from tests.test_pipeline import SentenceBert, _FakeNLP
from tests.test_torch_contextual import _sessions as _ctx_sessions
from tests.test_torch_slice import _assert_json_close, _assert_same_ranking, _pairs

torch.set_num_threads(2)

QUERIES = ["the old king rides a horse", "the sea storm breaks the ship",
           "a bird sings at night", "happy queen walks slowly"]


@pytest.fixture(scope="module")
def both():
    rng = np.random.default_rng(12)
    texts, _ = make_corpus_texts(rng, n_docs=4, sents_per_doc=60)
    mat = np.stack([word_vector(w, 24) for w in WORDS])
    sj = vj.Session([vj.StringImporter()(t, title=f"d{i}") for i, t in enumerate(texts)],
                    embeddings=[vj.KeyedVectors("sv", WORDS, mat)])
    st = vt.Session([vt.StringImporter()(t, title=f"d{i}") for i, t in enumerate(texts)],
                    embeddings=[vt.KeyedVectors("sv", WORDS, mat)], device="cpu")
    return sj, st


@pytest.fixture(scope="module")
def ctx():
    return _ctx_sessions()


def _span_indexes(sj, st, agg="mean", emb=0, **kw):
    ij = sj.partition("sentence").index(
        JaxEmbeddedSpanSim(vj.SentenceEmbedding(sj.embeddings[emb], agg)), **kw)
    it = st.partition("sentence").index(
        EmbeddedSpanSim(vt.SentenceEmbedding(st.embeddings[emb], agg)), **kw)
    return ij, it


def _check(ij, it, queries, n=5, min_score=0.2):
    for q in queries:
        want, got = _pairs(ij.find(q, n=n, min_score=min_score)), _pairs(
            it.find(q, n=n, min_score=min_score))
        assert got
        _assert_same_ranking(want, got, min_score)
    # one GEMM for the batch: its bits depend on Q, as the JAX package's do
    got_b = [_pairs(r) for r in it.find_batch(queries, n=n, min_score=min_score)]
    for q, g in zip(queries, got_b):
        _assert_same_ranking(_pairs(it.find(q, n=n, min_score=min_score)), g, min_score)
    for w, g in zip(ij.find_batch(queries, n=n, min_score=min_score), got_b):
        _assert_same_ranking(_pairs(w), g, min_score)


@pytest.mark.parametrize("agg", ["mean", "min", "max"])
@pytest.mark.parametrize("kind", ["static", "contextual"])
def test_corpus_encode_matches_jax(both, ctx, agg, kind):
    """The masked mean / min / max over each slice's rows, on the device
    (the static table, or the contextual bf16 store), and a query's
    encode (parsed and normalized like a document)."""
    sj, st = both if kind == "static" else ctx
    ij, it = _span_indexes(sj, st, agg, emb=0 if kind == "static" else 1)
    want = np.asarray(ij._corpus_vectors().unmodified)
    got = it._corpus_vectors()
    assert isinstance(got, SpanVectors)
    assert got.unmodified.shape == want.shape
    assert np.allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    q = QUERIES[0] if kind == "static" else "the old king rides"
    assert np.allclose(it._encoder.encode_text(q).unmodified,
                       ij._encoder.encode_text(q).unmodified, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("agg", ["mean", "max"])
def test_exact_index_matches_jax(both, agg):
    sj, st = both
    ij, it = _span_indexes(sj, st, agg)
    assert isinstance(it, SpanEncoderIndex)
    _check(ij, it, QUERIES)
    m = it.find(QUERIES[0], n=2, min_score=0.0)[0]
    assert m.level == "span" and m.metric == "cosine"
    _assert_json_close(ij.find(QUERIES[0], n=2, min_score=0.0)[0].to_json(), m.to_json())


def test_contextual_exact_index_matches_jax(ctx):
    sj, st = ctx
    ij, it = _span_indexes(sj, st, "mean", emb=1)
    _check(ij, it, ["the old king rides", "a bird sings loud", "cat sleeps fast"])


@pytest.mark.parametrize("nlist,nprobe", [(8, 2), (16, 4), (8, 8)])
def test_approximate_index_matches_jax(both, nlist, nprobe):
    """The same k-means shortlist as the JAX package's; nprobe = nlist is
    the exact index."""
    sj, st = both
    approx = {"approximate": {"nlist": nlist, "nprobe": nprobe}}
    ij, it = _span_indexes(sj, st, **approx)
    assert isinstance(it, ApproximateSpanIndex)
    for q in QUERIES:
        qn_j = np.asarray(ij._encoder.encode_text(q).normalized, np.float32)[0]
        qn_t = np.asarray(it._encoder.encode_text(q).normalized, np.float32)[0]
        assert np.array_equal(np.sort(it._shortlist(qn_t)), np.sort(ij._shortlist(qn_j)))
    assert np.allclose(it._centroids, ij._centroids, rtol=1e-5, atol=1e-6)
    _check(ij, it, QUERIES)
    if nprobe == nlist:
        exact = _span_indexes(sj, st)[1]
        for q in QUERIES:
            assert _pairs(it.find(q, n=5)) == _pairs(exact.find(q, n=5))


def test_save_and_load(both, tmp_path):
    """The dump holds the vectors with their provenance; ``load`` refuses a
    dump of another corpus, partition or encoder, or of another size."""
    sj, st = both
    _, it = _span_indexes(sj, st)
    want = [_pairs(it.find(q, n=5)) for q in QUERIES]
    path = tmp_path / "spans.npz"
    it.save(path)
    _, fresh = _span_indexes(sj, st)
    assert [_pairs(fresh.load(path).find(q, n=5)) for q in QUERIES] == want
    # a dump the JAX package wrote of the same corpus loads too
    ij, _ = _span_indexes(sj, st)
    ij.save(tmp_path / "jax.npz")
    _, from_jax = _span_indexes(sj, st)
    for q, w in zip(QUERIES, want):
        _assert_same_ranking(w, _pairs(from_jax.load(tmp_path / "jax.npz").find(q, n=5)),
                             0.2)
    # stale: another corpus
    other = vt.Session([vt.StringImporter()("the sea. the king.", title="x")],
                       embeddings=[st.embeddings[0]], device="cpu")
    stale = other.partition("sentence").index(
        EmbeddedSpanSim(vt.SentenceEmbedding(st.embeddings[0])))
    with pytest.raises(ValueError, match="does not match"):
        stale.load(path)
    # another aggregation (encoder name)
    _, max_ix = _span_indexes(sj, st, "max")
    with pytest.raises(ValueError, match="does not match"):
        max_ix.load(path)
    # a legacy raw array of the wrong size
    np.save(tmp_path / "raw.npy", np.zeros((3, 24), np.float32))
    with pytest.raises(ValueError, match="rows"):
        fresh.load(tmp_path / "raw.npy")


def _text_fn(text):
    words = text.split()
    if not words:
        return np.zeros(16, np.float32)
    return np.stack([word_vector(w.strip(".").lower(), 16) for w in words]).mean(0)


def test_text_span_embedding_matches_jax(both):
    sj, st = both
    ij = sj.partition("sentence").index(
        JaxEmbeddedSpanSim(vj.TextSpanEmbedding("fn", _text_fn, 16)))
    it = st.partition("sentence").index(
        EmbeddedSpanSim(vt.TextSpanEmbedding("fn", _text_fn, 16)))
    assert np.array_equal(it._corpus_vectors().numpy(),
                          np.asarray(ij._corpus_vectors().unmodified))
    _check(ij, it, QUERIES)


def test_decompose_nlp_and_spacy_span_embedding(both, monkeypatch):
    """decompose_nlp's two built-in decomposers and a registered one, as
    the JAX package's; SpacySpanEmbedding encodes nlp(text).vector."""
    monkeypatch.setattr(pipeline, "_decomposers", list(pipeline._decomposers))
    sbert = _FakeNLP(meta={"lang": "en", "vectors": {"width": 16}},
                     pipeline=[("sbert", SentenceBert("para"))])
    meta = _FakeNLP(meta={"vectors": {"name": "core-vectors", "width": 16}})
    bare = _FakeNLP()
    for nlp in (sbert, meta, bare):
        got, want = pipeline.decompose_nlp(nlp), jax_pipeline.decompose_nlp(nlp)
        assert (got is None) == (want is None)
        if got is not None:
            assert (got.name, got.dimension) == (want.name, want.dimension)
    with pytest.raises(RuntimeError, match="decompose"):
        vt.SpacySpanEmbedding(bare)
    vt.register_decomposer(lambda nlp: pipeline.PipelineStats("custom", 16))
    assert pipeline.decompose_nlp(bare).name == "custom"
    emb = vt.SpacySpanEmbedding(sbert)
    assert isinstance(emb, vt.TextSpanEmbedding) and emb.name == "sentence-bert-en-para"
    sj, st = both
    it = st.partition("sentence").index(EmbeddedSpanSim(emb))
    ij = sj.partition("sentence").index(
        JaxEmbeddedSpanSim(jax_pipeline.SpacySpanEmbedding(sbert)))
    _check(ij, it, QUERIES[:2])
