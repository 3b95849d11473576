"""The port's fastText embedding (vectorian_tpu_torch.embedding.fasttext)
against the JAX package's, on synthetic models written into tmp_path.

Everything here is host-side numpy in both packages, so the port is held
to the reference bit for bit: hashing, subword ids, word vectors, the
.ftz format and both product quantizers under the same seed.  A session
over a synthetic .bin returns the reference's matches (scores within 1e-6
relative: the [V, T] similarity GEMM sums in another order; ids may swap
only inside bands of tied scores), and inside the port find and
find_batch are byte-identical.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import vectorian_tpu as vj
import vectorian_tpu.embedding.fasttext as jft
import vectorian_tpu_torch as vt
import vectorian_tpu_torch.embedding.fasttext as tft
from tests.test_fasttext import write_fake_bin
from vectorian_tpu.metrics import EmbeddingTokenSim as JaxTokenSim
from vectorian_tpu.metrics import OptimizedSpanSim as JaxSpanSim
from vectorian_tpu.alignment import LocalAlignment as JaxLocal
from vectorian_tpu_torch import native
from vectorian_tpu_torch.alignment import LocalAlignment
from vectorian_tpu_torch.convert import state_from_numpy
from vectorian_tpu_torch.metrics import EmbeddingTokenSim, OptimizedSpanSim

torch.set_num_threads(2)

REL = 1e-6
WORDS = [tft.EOS, "king", "queen", "horse", "rides", "the", "old", "grey", "café"]
PROBES = ["king", "kingdom", "queens", tft.EOS, "x", "café", "日本語", "zzq", ""]


@pytest.fixture
def bin_path(tmp_path):
    path = tmp_path / "cc.xx.300.bin"
    write_fake_bin(path, WORDS, dim=16, bucket=128, minn=2, maxn=4)
    return path


@pytest.mark.parametrize("word", ["", "a", "ab", "king", "café", "日本", "Straße"])
def test_hash_and_ngrams_equal(word):
    for minn, maxn in ((1, 2), (2, 4), (3, 6), (5, 5)):
        ngrams = tft.word_ngrams(word, minn, maxn)
        assert ngrams == jft.word_ngrams(word, minn, maxn)
        for ng in ngrams + [word]:
            b = ng.encode("utf-8")
            assert tft.fnv1a_hash(b) == jft.fnv1a_hash(b)


def test_subword_ids_and_word_vector_bit_equal(bin_path):
    mt, mj = tft.FastTextModel.load(bin_path), jft.FastTextModel.load(bin_path)
    assert (mt.words, mt.nwords, mt.dim, mt.bucket, mt.minn, mt.maxn) == (
        mj.words, mj.nwords, mj.dim, mj.bucket, mj.minn, mj.maxn)
    assert np.array_equal(mt.input_matrix, mj.input_matrix)
    for w in PROBES:
        assert mt.subword_ids(w) == mj.subword_ids(w), w
        assert np.array_equal(mt.word_vector(w), mj.word_vector(w)), w


def test_encoder_equal_and_native_batch_bit_equal_to_python(bin_path):
    """The batch encoder (native where it builds) gives the python path's
    bits, and the reference encoder's vectors."""
    mt = tft.FastTextModel.load(bin_path)
    if native.available():
        got = native.fasttext_encode_batch(mt, PROBES)
        for i, w in enumerate(PROBES):
            assert np.array_equal(got[i], mt.word_vector(w)), w
    enc_t = tft.FastTextEncoder("ft", mt).encode_tokens(PROBES)
    enc_j = jft.FastTextEncoder("ft", jft.FastTextModel.load(bin_path)).encode_tokens(PROBES)
    assert enc_t.unmodified.shape == (len(PROBES), 16)
    np.testing.assert_allclose(enc_t.unmodified, enc_j.unmodified, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("qnorm", [True, False])
def test_ftz_round_trip_equal(tmp_path, qnorm):
    """quantize_facebook under the same seed gives the reference's codes and
    codebooks; the port's .ftz loads in both packages to the same rows."""
    rng = np.random.default_rng(3)
    words = [tft.EOS, "king", "queen", "horse", "rides"]
    dim, bucket = 8, 32
    protos = rng.normal(size=(16, dim)).astype(np.float32)
    rows = protos[rng.integers(0, 16, size=len(words) + bucket)]
    dense_t = tft.FastTextModel(words, len(words), dim, bucket, 2, 3, rows.copy())
    dense_j = jft.FastTextModel(words, len(words), dim, bucket, 2, 3, rows.copy())
    qt = tft.quantize_facebook(dense_t, dsub=2, qnorm=qnorm)
    qj = jft.quantize_facebook(dense_j, dsub=2, qnorm=qnorm)
    assert np.array_equal(qt.codes, qj.codes)
    assert np.array_equal(qt.pq.centroids, qj.pq.centroids)
    ftz = tmp_path / "m.ftz"
    qt.save(ftz)
    lt, lj = tft.FastTextModel.load(ftz), jft.FastTextModel.load(ftz)
    assert isinstance(lt, tft.FacebookQuantizedModel)
    ids = np.arange(len(words) + bucket)
    assert np.array_equal(lt.decode_rows(ids), lj.decode_rows(ids))
    assert np.array_equal(lt.decode_rows(ids), qt.decode_rows(ids))
    np.testing.assert_allclose(lt.decode_rows(ids), rows, atol=1e-4)
    for w in ["king", "kingdom", tft.EOS]:
        assert np.array_equal(lt.word_vector(w), lj.word_vector(w)), w


def test_ftz_pruned_dictionary_equal(tmp_path):
    rng = np.random.default_rng(5)
    words = [tft.EOS, "ab"]
    dim, bucket, minn, maxn = 4, 64, 2, 3
    hashes = sorted({tft.fnv1a_hash(ng.encode()) % bucket
                     for ng in tft.word_ngrams("ab", minn, maxn)})
    pruneidx = {h: i for i, h in enumerate(hashes[:2])}
    rows = rng.normal(size=(len(words) + 2, dim)).astype(np.float32)
    q = tft.quantize_facebook(
        tft.FastTextModel(words, len(words), dim, bucket, minn, maxn, rows), dsub=2)
    q.pruneidx = pruneidx
    p = tmp_path / "p.ftz"
    q.save(p)
    lt, lj = tft.FastTextModel.load(p), jft.FastTextModel.load(p)
    assert lt.pruneidx == lj.pruneidx == pruneidx
    assert lt.subword_ids("ab") == lj.subword_ids("ab") == q.subword_ids("ab")
    assert np.array_equal(lt.word_vector("ab"), lj.word_vector("ab"))


def test_pq_compress_bit_equal(bin_path, tmp_path):
    """pq_compress / QuantizedFastTextModel under the same seed: the
    reference's codebooks and codes; the port's .npz loads in both."""
    kw = dict(n_subvectors=4, n_codes=32, n_train=1000, n_iters=8)
    qt = tft.QuantizedFastTextModel.compress(tft.FastTextModel.load(bin_path), **kw)
    qj = jft.QuantizedFastTextModel.compress(jft.FastTextModel.load(bin_path), **kw)
    assert np.array_equal(qt.codebooks, qj.codebooks)
    assert np.array_equal(qt.codes, qj.codes)
    npz = tmp_path / "m.npz"
    qt.save(npz)
    lt = tft.QuantizedFastText(npz, name="q").model
    lj = jft.QuantizedFastText(npz, name="q").model
    for w in PROBES:
        assert np.array_equal(lt.word_vector(w), lj.word_vector(w)), w


def test_convert_compress_fasttext_equal_and_missing_package(tmp_path):
    """The converter gives the reference's dense model bit for bit; the
    compress_fasttext package is absent here, so CompressedFastTextVectors
    raises ImportError in both packages when asked for an encoder."""
    rng = np.random.default_rng(3)
    words = ["the", "cat", "café", "日本"]
    dim, bucket = 8, 64
    ngrams = rng.normal(size=(bucket, dim)).astype(np.float32)
    finals = rng.normal(size=(len(words), dim)).astype(np.float32)
    kv = SimpleNamespace(index_to_key=words, vector_size=dim, bucket=bucket,
                         min_n=3, max_n=6, vectors_ngrams=ngrams, vectors=finals)
    mt, mj = tft.convert_compress_fasttext(kv), jft.convert_compress_fasttext(kv)
    assert np.array_equal(mt.input_matrix, mj.input_matrix)
    for w in words + ["zzunknown"]:
        assert np.array_equal(mt.word_vector(w), mj.word_vector(w)), w
    path = tmp_path / "x.bin"
    for cls in (tft.CompressedFastTextVectors, jft.CompressedFastTextVectors):
        with pytest.raises(ImportError, match="compress_fasttext"):
            cls(path).create_encoder()
    assert vt.CompressedFastTextVectors is tft.CompressedFastTextVectors
    assert vt.PretrainedFastText is tft.PretrainedFastText


TEXT = ("the king rides the horse. the queen sleeps. an old grey horse "
        "rides. kings and queens ride horses. the café is old.")
QUERIES = ["the king rides the horse", "kings rides horses", "zzq grey horsey",
           "queen café", "old old king"]


@pytest.fixture
def sessions(bin_path):
    fj, ft = vj.PretrainedFastText("xx", path=bin_path), vt.PretrainedFastText("xx", path=bin_path)
    sj = vj.Session([vj.StringImporter()(TEXT, title="d")], embeddings=[fj])
    st = vt.Session([vt.StringImporter()(TEXT, title="d")], embeddings=[ft], device="cpu")
    return sj, st


def _pairs(result):
    return [(m.slice_id, m.score) for m in result]


def _same_ranking(want, got, min_score):
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


@pytest.mark.parametrize("aligned", [False, True])
def test_session_find_and_find_batch_match_jax(sessions, aligned):
    """OOV query words get vectors from their ngrams in both packages."""
    sj, st = sessions
    if aligned:
        ij = sj.partition("sentence").index(
            JaxSpanSim(JaxTokenSim(sj.embeddings[0]), JaxLocal()))
        it = st.partition("sentence").index(
            OptimizedSpanSim(EmbeddingTokenSim(st.embeddings[0]), LocalAlignment()))
    else:
        ij = sj.partition("sentence").index(JaxTokenSim(sj.embeddings[0]))
        it = st.partition("sentence").index(EmbeddingTokenSim(st.embeddings[0]))
    n, min_score = 4, 0.0
    finds = []
    for q in QUERIES:
        got = _pairs(it.find(q, n=n, min_score=min_score))
        assert got, q
        _same_ranking(_pairs(ij.find(q, n=n, min_score=min_score)), got, min_score)
        finds.append(got)
    want_b = ij.find_batch(QUERIES, n=n, min_score=min_score, sim_precision="float32")
    for prec in (None, "float32"):
        got_b = [_pairs(r) for r in it.find_batch(QUERIES, n=n, min_score=min_score,
                                                  sim_precision=prec)]
        for w, g in zip(want_b, got_b):
            _same_ranking(_pairs(w), g, min_score)
        assert got_b == finds


def test_state_from_numpy_carries_fasttext_matrix(sessions):
    """The reference session's compiled fastText matrix is carried over by
    state_from_numpy bit for bit, and agrees with the port's own to 1e-6
    relative (the reference's native encoder multiplies the subword sum by
    the count's reciprocal, the port divides as numpy's mean does: 1 ulp)."""
    sj, st = sessions
    spec = sj.partition("sentence").spec
    pj = sj.packed_corpus(spec)
    arrays = {
        "vocab": list(sj.vocab.tokens.strings),
        "embeddings": {name: np.asarray(ce.unmodified)
                       for name, ce in sj.compiled_embeddings.items()},
        "buckets": [{"capacity": b.capacity, "tokens": b.token_ids, "pos": b.pos_ids,
                     "tag": b.tag_ids, "lengths": b.lengths, "slice_index": b.slice_index}
                    for b in pj.buckets],
        "slice_doc": pj.slice_doc, "slice_idx": pj.slice_idx,
        "slice_start": pj.slice_start, "slice_len": pj.slice_len,
        "partition": (spec.level, spec.window_size, spec.window_step),
        "n_docs": pj.n_docs,
    }
    _, compiled = state_from_numpy(arrays, device="cpu")
    assert list(st.vocab.tokens.strings) == arrays["vocab"]
    assert set(compiled) == set(st.compiled_embeddings) == {"fasttext-xx"}
    for name, ce in compiled.items():
        assert np.array_equal(ce.unmodified.numpy(), arrays["embeddings"][name])
        mine = st.compiled_embeddings[name]
        for f in ("unmodified", "normalized", "magnitudes"):
            np.testing.assert_allclose(getattr(ce, f).numpy(), getattr(mine, f).numpy(),
                                       rtol=REL, atol=1e-7, err_msg=f)
