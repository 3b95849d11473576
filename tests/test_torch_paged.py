"""Paged serving in the port (``Session(paged=True)``,
``BruteForceEngine(paged=True)``) against resident mode and the JAX
package's paged engine, on the CPU.

A paged engine keeps each bucket's arrays (and the contextual stores) on
the host and streams them through the device a bucket at a time; it must
return the bytes of a resident engine on every path of
tests/test_paged.py — find, find_batch at every sim_precision, the
options, submatch, contextual and tree batches — and on the transport
batch and an unsafe cut's extras round, which pages buckets in again.
After a pass no paged bucket holds a device tensor.  The JAX package's
paged engine serves the same queries: the port's results follow the
ranking rule against it (1e-6, ties aside).  On the CPU the host tensor is
the device tensor; the card's copy stream and pinned memory run only in
chip_smoke.py.
"""

import numpy as np
import pytest
import torch

import vectorian_tpu as vj
import vectorian_tpu_torch as vt
from vectorian_tpu.alignment import GlobalAlignment as JaxGlobal
from vectorian_tpu.alignment import WordMoversDistance as JaxWMD
from vectorian_tpu.alignment import WordRotatorsDistance as JaxWRD
from vectorian_tpu.saliency import KeywordSignal as JaxKeywordSignal
from vectorian_tpu.saliency import Saliency as JaxSaliency
from vectorian_tpu.sim.modifier import MixedTokenSimilarity as JaxMixed
from vectorian_tpu.sim.span import OptimizedSpanSim as JaxSpanSim
from vectorian_tpu.sim.token import EmbeddingTokenSim as JaxTokenSim
from vectorian_tpu_torch.alignment import (
    ExponentialGapCost,
    GlobalAlignment,
    LocalAlignment,
    WordMoversDistance,
    WordRotatorsDistance,
)
from vectorian_tpu_torch.ops import search
from vectorian_tpu_torch.ops.search import (
    BruteForceEngine,
    _LazyScores,
    _PagedBucket,
    narrow_planes,
)
from vectorian_tpu_torch.sim.modifier import MixedTokenSimilarity
from vectorian_tpu_torch.sim.span import EmbeddedSpanSim, OptimizedSpanSim
from vectorian_tpu_torch.sim.token import EmbeddingTokenSim

from tests.helpers import WORDS, make_corpus_texts, word_vector
from tests.test_torch_contextual import _sessions as _ctx_pair
from tests.test_torch_slice import _assert_same_ranking, _pairs

torch.set_num_threads(2)

QS = [
    "the old king rides the grey horse",
    "a bird sings in the night",
    "water under the stone road",
    "the cat sleeps",
]


def _docs(mod, texts):
    return [mod.StringImporter()(t, title=f"d{i}") for i, t in enumerate(texts)]


@pytest.fixture(scope="module")
def trio():
    """(JAX paged session, port resident session, port paged session) over
    tests/test_paged.py's corpus: a duplicated document makes the scores
    tie-heavy, so unsafe cuts page buckets in again."""
    rng = np.random.default_rng(7)
    texts, _ = make_corpus_texts(rng, n_docs=6, sents_per_doc=20,
                                 planted=["the old king rides the grey horse"])
    texts.append(texts[0])
    words = sorted(set(WORDS) | {"old", "king", "rides", "grey", "horse", "sings",
                                 "in", "the"})
    mat = np.stack([word_vector(w, 32) for w in words])
    sj = vj.Session(_docs(vj, texts), embeddings=[vj.KeyedVectors("e", words, mat)],
                    paged=True)
    sr = vt.Session(_docs(vt, texts), embeddings=[vt.KeyedVectors("e", words, mat)],
                    device="cpu")
    sp = vt.Session(_docs(vt, texts), embeddings=[vt.KeyedVectors("e", words, mat)],
                    device="cpu", paged=True)
    return sj, sr, sp


def _ix(session, alignment=None, jax=False):
    if jax:
        tok = JaxTokenSim(session.embeddings[0])
        span = tok if alignment is None else JaxSpanSim(tok, alignment)
    else:
        tok = EmbeddingTokenSim(session.embeddings[0])
        span = tok if alignment is None else OptimizedSpanSim(tok, alignment)
    return session.partition("sentence").index(span)


def _assert_evicted(engine):
    """After a pass no paged bucket holds a device tensor."""
    assert engine.paged
    for db in engine._device_buckets:
        assert isinstance(db, _PagedBucket)
        for key, val in dict.items(db):
            assert not isinstance(val, torch.Tensor), f"{key} still on the device"


def _same(got_p, got_r, got_j, min_score):
    assert got_p == got_r
    assert any(got_p)
    for a, b in zip(got_j, got_p):
        _assert_same_ranking(a, b, min_score)


def test_paged_find_matches_resident(trio):
    sj, sr, sp = trio
    ij, ir, ip = _ix(sj, jax=True), _ix(sr), _ix(sp)
    got = [_pairs(ip.find(q, n=5, min_score=0.05)) for q in QS]
    _assert_evicted(ip._engine)
    _same(got, [_pairs(ir.find(q, n=5, min_score=0.05)) for q in QS],
          [_pairs(ij.find(q, n=5, min_score=0.05)) for q in QS], 0.05)


@pytest.mark.parametrize("prec", ["float32", "int8", "bfloat16"])
def test_paged_find_batch_matches_resident(trio, prec):
    sj, sr, sp = trio
    ij, ir, ip = _ix(sj, jax=True), _ix(sr), _ix(sp)
    got = [_pairs(r) for r in ip.find_batch(QS, n=5, min_score=0.05, sim_precision=prec)]
    _assert_evicted(ip._engine)
    _same(got, [_pairs(r) for r in ir.find_batch(QS, n=5, min_score=0.05,
                                                  sim_precision=prec)],
          [_pairs(r) for r in ij.find_batch(QS, n=5, min_score=0.05,
                                             sim_precision=prec)], 0.05)


@pytest.mark.parametrize("option", ["booster", "submatch", "global", "general",
                                    "tags", "filter", "bidirectional", "debug"])
def test_paged_options_match_resident(trio, option):
    """The options ride the paged engine's passes (a keyword booster counts
    its keywords a paged bucket at a time) and its row paths."""
    sj, sr, sp = trio
    kw_j, kw_t, span, al_j, al_t = {}, {}, {}, None, None
    if option == "booster":
        kw_j = {"booster": JaxSaliency(0.9).add_signal(JaxKeywordSignal("horse"), 1.0)}
        kw_t = {"booster": vt.Saliency(0.9).add_signal(vt.KeywordSignal("horse"), 1.0)}
    elif option == "submatch":
        kw_j = kw_t = {"submatch_weight": 0.5}
    elif option == "global":
        al_j, al_t = JaxGlobal(), GlobalAlignment()
    elif option == "general":
        from vectorian_tpu.alignment import ExponentialGapCost as JaxExp
        from vectorian_tpu.alignment import LocalAlignment as JaxLocal

        al_j, al_t = JaxLocal(JaxExp(0.5)), LocalAlignment(ExponentialGapCost(0.5))
    elif option == "tags":
        span = {"tag_weights": {"NN": 1.0, "VB": 0.5}, "pos_mismatch_penalty": 0.3,
                "similarity_threshold": 0.1}
    elif option == "filter":
        kw_j = kw_t = {"token_filter": ["the"]}
    elif option == "bidirectional":
        kw_j = kw_t = {"bidirectional": True}
    else:
        kw_j = kw_t = {"debug": lambda *a: None}
    if span:
        from vectorian_tpu.alignment import LocalAlignment as JaxLocal

        al_j, al_t = JaxLocal(), LocalAlignment()

    def index(session, jax):
        tok = (JaxTokenSim if jax else EmbeddingTokenSim)(session.embeddings[0])
        al = al_j if jax else al_t
        if al is None and not span:
            return session.partition("sentence").index(tok)
        cls = JaxSpanSim if jax else OptimizedSpanSim
        return session.partition("sentence").index(cls(tok, al, **span))

    ij, ir, ip = index(sj, True), index(sr, False), index(sp, False)
    got = [_pairs(ip.find(q, n=4, min_score=0.01, **kw_t)) for q in QS[:2]]
    got += [_pairs(r) for r in ip.find_batch(QS, n=4, min_score=0.01, **kw_t)]
    _assert_evicted(ip._engine)
    want = [_pairs(ir.find(q, n=4, min_score=0.01, **kw_t)) for q in QS[:2]]
    want += [_pairs(r) for r in ir.find_batch(QS, n=4, min_score=0.01, **kw_t)]
    jax = [_pairs(ij.find(q, n=4, min_score=0.01, **kw_j)) for q in QS[:2]]
    jax += [_pairs(r) for r in ij.find_batch(QS, n=4, min_score=0.01, **kw_j)]
    _same(got, want, jax, 0.01)


def test_paged_bucket_lazy_upload_and_evict():
    """A paged bucket uploads a device key at its first touch (narrow
    planes widened) and drops it on evict; its host planes stay."""
    from vectorian_tpu_torch.corpus.packing import PackedBucket

    tok = np.arange(12, dtype=np.int32).reshape(4, 3)
    b = PackedBucket(capacity=3, token_ids=tok, pos_ids=np.zeros((4, 3), np.int8),
                     tag_ids=np.ones((4, 3), np.int16), lengths=np.full(4, 3, np.int32),
                     slice_index=np.arange(4))
    pager = search._Pager(torch.device("cpu"))
    db = _PagedBucket({"bi": 0, "n": 4, "capacity": 3}, narrow_planes(b, pager), pager)
    assert "tokens" not in dict.keys(db)
    dev = db["tokens"]
    assert dev.dtype == torch.int32 and "tokens" in dict.keys(db)
    assert np.array_equal(dev.numpy(), tok)
    assert db["tag"].dtype == torch.int16
    assert pager.bytes == 12 * 2 + 12 * 1  # a 16-bit and an 8-bit plane
    db.evict()
    assert "tokens" not in dict.keys(db) and "tag" not in dict.keys(db)
    assert np.array_equal(db["tokens"].numpy(), tok)  # pages in again
    with pytest.raises(KeyError):
        db["not_a_key"]


@pytest.mark.parametrize("high", [False, True])
def test_narrow_plane_round_trip(high):
    """Token ids under 65,536 travel as 16 bits and tags under 256 as 8;
    the widened tensors equal the full-width ones (ids past the narrow
    range travel at full width)."""
    from vectorian_tpu_torch.corpus.packing import PackedBucket

    rng = np.random.default_rng(2)
    top = 70_000 if high else 65_535
    tok = rng.integers(0, 65_536, size=(9, 5)).astype(np.int32)
    tok[0, 0], tok[1, 1] = 0, top
    tag = rng.integers(0, 256 if not high else 300, size=(9, 5)).astype(np.int16)
    tag[0, 0] = 255
    b = PackedBucket(capacity=5, token_ids=tok, pos_ids=np.zeros((9, 5), np.int8),
                     tag_ids=tag, lengths=np.full(9, 5, np.int32), slice_index=np.arange(9))
    planes = narrow_planes(b, search._Pager(torch.device("cpu")))
    host_tok, widen_tok = planes["tokens"]
    host_tag, widen_tag = planes["tag"]
    assert (host_tok.element_size(), host_tag.element_size()) == (
        (4, 2) if high else (2, 1))
    for (host, widen), full in ((planes["tokens"], tok), (planes["tag"], tag)):
        got = host if widen is None else widen(host)
        assert got.dtype == torch.as_tensor(full).dtype
        assert np.array_equal(got.numpy(), full)


@pytest.mark.parametrize("tree", ["ctx", "mixed"])
@pytest.mark.parametrize("gap", ["affine", "general"])
def test_paged_contextual_matches_resident(tree, gap):
    """Contextual and mixed-tree serving: the bf16 stores stay on the host
    (pinned on a card) and page in with their bucket; paged = resident
    byte for byte, find and find_batch."""
    sj, sr = _ctx_pair()
    sp = _paged_ctx_session()
    qs = ["the old king rides", "a bird sings loud"]
    from vectorian_tpu.alignment import ExponentialGapCost as JaxExp
    from vectorian_tpu.alignment import LocalAlignment as JaxLocal

    def index(session, jax):
        E = JaxTokenSim if jax else EmbeddingTokenSim
        if tree == "ctx":
            tok = E(session.embeddings[1])
        else:
            tok = (JaxMixed if jax else MixedTokenSimilarity)(
                [E(session.embeddings[0]), E(session.embeddings[1])], [0.5, 0.5])
        if gap == "affine":
            return session.partition("sentence").index(tok)
        al = JaxLocal(JaxExp(0.5)) if jax else LocalAlignment(ExponentialGapCost(0.5))
        return session.partition("sentence").index(
            (JaxSpanSim if jax else OptimizedSpanSim)(tok, al))

    ir, ip, ij = index(sr, False), index(sp, False), index(sj, True)
    got = [_pairs(r) for r in ip.find_batch(qs, n=4, min_score=-1.0)]
    got += [_pairs(ip.find(q, n=4, min_score=-1.0)) for q in qs]
    _assert_evicted(ip._engine)
    for store in ip._engine._ctx_stores.values():
        assert all(t.device.type == "cpu" for t in store)
    want = [_pairs(r) for r in ir.find_batch(qs, n=4, min_score=-1.0)]
    want += [_pairs(ir.find(q, n=4, min_score=-1.0)) for q in qs]
    jax = [_pairs(r) for r in ij.find_batch(qs, n=4, min_score=-1.0)]
    jax += [_pairs(ij.find(q, n=4, min_score=-1.0)) for q in qs]
    _same(got, want, jax, -1.0)


def _paged_ctx_session():
    """A paged port session over the contextual pair's corpus."""
    from tests.test_torch_contextual import DIM, WORDS as CWORDS, _texts, ctx_fn

    mat = np.stack([word_vector(w, 16) for w in CWORDS])
    return vt.Session(_docs(vt, _texts()),
                      embeddings=[vt.KeyedVectors("static", CWORDS, mat),
                                  vt.LambdaContextualEmbedding("ctx", ctx_fn, DIM)],
                      device="cpu", paged=True)


def test_session_paged_kwarg():
    """Session(paged=True) builds paged engines for every partition."""
    docs = _docs(vt, ["the cat sleeps. a dog runs."])
    words = ["the", "cat", "sleeps", "a", "dog", "runs"]
    emb = vt.KeyedVectors("e", words, np.stack([word_vector(w, 32) for w in words]))
    session = vt.Session(docs, embeddings=[emb], device="cpu", paged=True)
    ix = session.partition("sentence").index(EmbeddingTokenSim(emb))
    assert all(isinstance(db, _PagedBucket) for db in ix._engine._device_buckets)
    assert len(ix.find("the cat sleeps", n=2, min_score=0.1)) >= 1
    _assert_evicted(ix._engine)
    assert ix._engine.uploaded_bytes > 0


@pytest.mark.parametrize("gap", ["affine", "general"])
def test_paged_extras_round_matches_resident(gap, monkeypatch):
    """A tie-heavy corpus (one sentence 600 times): every cut is unsafe, so
    the extras round selects columns of buckets that were released — a
    paged engine pages them in again and recomputes their scores — and
    the results are the resident engine's bytes."""
    from tests.test_torch_slice import _corpus

    words, mat, _, _ = _corpus()
    rng = np.random.default_rng(5)
    sents = ["the sun shines over the sea."] * 600 + [
        " ".join(rng.choice(words, size=int(rng.integers(2, 9)))) + "."
        for _ in range(200)]
    rng.shuffle(sents)
    texts = [" ".join(sents[i: i + 100]) for i in range(0, len(sents), 100)]
    queries = ["the sun shines over the sea", "sun shines", "the sea"]
    al = LocalAlignment() if gap == "affine" else LocalAlignment(ExponentialGapCost(0.5))
    sr = vt.Session(_docs(vt, texts), embeddings=[vt.KeyedVectors("toy", words, mat)],
                    device="cpu")
    sp = vt.Session(_docs(vt, texts), embeddings=[vt.KeyedVectors("toy", words, mat)],
                    device="cpu", paged=True)
    ir, ip = _ix(sr, al), _ix(sp, al)
    repaged = {"n": 0}
    orig = search.BucketTopKSource._bucket_scores

    def spy(self, bi):
        if isinstance(self._pending[bi][1], _LazyScores):
            repaged["n"] += 1
        return orig(self, bi)

    monkeypatch.setattr(search.BucketTopKSource, "_bucket_scores", spy)
    for prec in ("float32", "int8"):
        got = [_pairs(r) for r in ip.find_batch(queries, n=5, min_score=0.1,
                                                 sim_precision=prec)]
        got += [_pairs(ip.find(q, n=5, min_score=0.1)) for q in queries]
        want = [_pairs(r) for r in ir.find_batch(queries, n=5, min_score=0.1,
                                                  sim_precision=prec)]
        want += [_pairs(ir.find(q, n=5, min_score=0.1)) for q in queries]
        assert got == want and any(got)
    assert repaged["n"] > 0
    _assert_evicted(ip._engine)


@pytest.mark.parametrize("metric", ["rwmd", "wmd", "wrd"])
@pytest.mark.parametrize("plan", ["static", "ctx"])
def test_paged_transport_batch_matches_resident(trio, metric, plan):
    """The transport batch (and find) on a paged engine: its ranking
    passes page each bucket in, the host rescore reads host rows."""
    mk_t = {"rwmd": WordMoversDistance, "wmd": lambda: WordMoversDistance(relaxed=False),
            "wrd": WordRotatorsDistance}[metric]
    mk_j = {"rwmd": JaxWMD, "wmd": lambda: JaxWMD(relaxed=False),
            "wrd": JaxWRD}[metric]
    if plan == "static":
        sj, sr, sp = trio
        k, qs, msc = 0, QS, 0.1
    else:
        sj, sr = _ctx_pair()
        sp = _paged_ctx_session()
        k, qs, msc = 1, ["the old king rides", "a bird sings loud"], 0.1
    ir = sr.partition("sentence").index(OptimizedSpanSim(
        EmbeddingTokenSim(sr.embeddings[k]), mk_t()))
    ip = sp.partition("sentence").index(OptimizedSpanSim(
        EmbeddingTokenSim(sp.embeddings[k]), mk_t()))
    ij = sj.partition("sentence").index(JaxSpanSim(JaxTokenSim(sj.embeddings[k]), mk_j()))
    got = [_pairs(r) for r in ip.find_batch(qs, n=5, min_score=msc)]
    got += [_pairs(ip.find(q, n=5, min_score=msc)) for q in qs]
    _assert_evicted(ip._engine)
    want = [_pairs(r) for r in ir.find_batch(qs, n=5, min_score=msc)]
    want += [_pairs(ir.find(q, n=5, min_score=msc)) for q in qs]
    jax = [_pairs(r) for r in ij.find_batch(qs, n=5, min_score=msc)]
    jax += [_pairs(ij.find(q, n=5, min_score=msc)) for q in qs]
    _same(got, want, jax, msc)


def test_paged_span_encode_matches_resident(trio):
    """A span index's corpus encode uploads each block's host rows."""
    _, sr, sp = trio

    def index(session):
        return session.partition("sentence").index(
            EmbeddedSpanSim(vt.SentenceEmbedding(session.embeddings[0], "mean")))

    ir, ip = index(sr), index(sp)
    assert torch.equal(ip._corpus_vectors().unmodified, ir._corpus_vectors().unmodified)
    assert [_pairs(ip.find(q, n=4, min_score=0.1)) for q in QS] == [
        _pairs(ir.find(q, n=4, min_score=0.1)) for q in QS]
    _assert_evicted(sp.engine(sp.partition("sentence").spec))


def test_paged_engine_direct(trio):
    """BruteForceEngine(paged=True) over a session's packing (the JAX
    test's construction): its score_all_multi is the resident engine's."""
    _, sr, _ = trio
    ir = _ix(sr)
    packed = ir.packed
    eng = BruteForceEngine(packed, "cpu", paged=True)
    pqs = [ir.make_query(q).prepare(ir._nlp) for q in QS]
    plans = [ir._compile_plan(pq) for pq in pqs]
    args = (plans, [pq.n_tokens for pq in pqs], ir._gaps, "local",
            [float(pq.n_tokens) for pq in pqs])
    got = eng.score_all_multi(*args)
    want = ir._engine.score_all_multi(*args)
    assert got.tobytes() == want.tobytes()
    _assert_evicted(eng)
    assert eng.uploaded_bytes >= sum(b.token_ids.size * 2 for b in packed.buckets)
