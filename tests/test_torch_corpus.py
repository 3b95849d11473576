"""The port's stored corpora (``Corpus``, ``TemporaryCorpus``) and the
session's stored-flavor path against the JAX package, on the CPU.

The cases of tests/test_components.py's corpus tests run on the port:
persistence, dedup, a flavor hit with ``prepare_document`` patched to
raise, a miss under another normalization, the content key's
invalidation and ``TemporaryCorpus`` cleanup.  Interop runs both packages
on ONE directory (a corpus's document order is its sorted uuid4 keys, so
two directories of the same documents order them differently): a corpus
and flavor written by the JAX package open in the port with a flavor hit
and the JAX package's ``find`` / ``find_batch`` slices with scores within
1e-6 relative, and the reverse.  A corpus whose documents carry
contextual vectors is reopened and searched without encoding again.
"""

import sqlite3

import numpy as np
import pytest
import torch

import vectorian_tpu as vj
import vectorian_tpu.session as jax_session_mod
import vectorian_tpu_torch as vt
import vectorian_tpu_torch.session as session_mod
from vectorian_tpu.alignment import ExponentialGapCost as JaxExponential
from vectorian_tpu.alignment import LocalAlignment as JaxLocal
from vectorian_tpu.corpus.corpus import Corpus as JaxCorpus
from vectorian_tpu.embedding.contextual import LambdaContextualEmbedding as JaxLambda
from vectorian_tpu.sim.span import OptimizedSpanSim as JaxSpanSim
from vectorian_tpu.sim.token import EmbeddingTokenSim as JaxTokenSim
from vectorian_tpu_torch.alignment import ExponentialGapCost, LocalAlignment
from vectorian_tpu_torch.corpus.corpus import Corpus, TemporaryCorpus
from vectorian_tpu_torch.normalization import LowercaseNormalization, VanillaNormalization
from vectorian_tpu_torch.sim.span import OptimizedSpanSim
from vectorian_tpu_torch.sim.token import EmbeddingTokenSim
from vectorian_tpu_torch.utils.nlp import SimpleNLP

from tests.helpers import WORDS, make_corpus_texts, word_vector
from tests.test_contextual import DIM, ctx_fn
from tests.test_torch_slice import _assert_same_ranking, _pairs

torch.set_num_threads(2)

QUERIES = ["the old king rides the grey horse", "a bird sees the sea", "storm wave shore"]
VOCAB = sorted(set(WORDS) | {"grey", "horse", "sings", "another", "text", "entirely"})


@pytest.fixture(autouse=True)
def cache_home(tmp_path, monkeypatch):
    monkeypatch.setenv("VECTORIAN_CACHE_HOME", str(tmp_path / "cache"))


def _texts():
    rng = np.random.default_rng(7)
    texts, _ = make_corpus_texts(rng, n_docs=4, sents_per_doc=10,
                                 planted=["the old king rides the grey horse"])
    return texts


def _emb(pkg):
    return pkg.KeyedVectors("toy", VOCAB, np.stack([word_vector(w, 16) for w in VOCAB]))


def _fill(corpus, pkg, texts=None):
    imp = pkg.StringImporter()
    return [corpus.add_doc(imp(t, title=f"t{i}")) for i, t in enumerate(texts or _texts())]


def _forbid_prepare(monkeypatch, module):
    def boom(*args, **kwargs):
        raise AssertionError("normalization ran on a flavor-cached corpus")

    monkeypatch.setattr(module, "prepare_document", boom)


def _index(session, general=False):
    tok = EmbeddingTokenSim(session.embeddings[0])
    gap = LocalAlignment(ExponentialGapCost(3.0)) if general else LocalAlignment()
    return session.partition("sentence").index(OptimizedSpanSim(tok, gap))


def _jax_index(session, general=False):
    tok = JaxTokenSim(session.embeddings[0])
    gap = JaxLocal(JaxExponential(3.0)) if general else JaxLocal()
    return session.partition("sentence").index(JaxSpanSim(tok, gap))


def _lists(index):
    finds = [_pairs(index.find(q, n=4, min_score=0.1)) for q in QUERIES]
    batch = [_pairs(r) for r in index.find_batch(QUERIES, n=4, min_score=0.1)]
    return finds, batch


def test_corpus_persistence_and_dedup(tmp_path):
    imp = vt.StringImporter()
    d1 = imp("The king rides. The queen sleeps.", title="t1", author="a")
    d2 = imp("Another text entirely.", title="t2")
    with Corpus(tmp_path / "c") as corpus:
        uid1 = corpus.add_doc(d1)
        uid2 = corpus.add_doc(d2)
        assert uid1 != uid2 and d1.unique_id == uid1
        # dedup: the same text gets the same uid
        assert corpus.add_doc(imp("The king rides. The queen sleeps.", title="copy")) == uid1
        assert len(corpus) == 2 and corpus.uuids == sorted([uid1, uid2])
        assert corpus.find_duplicate(imp("Fresh.", title="x")) is None

    with Corpus(tmp_path / "c") as corpus:
        assert len(corpus) == 2
        doc = corpus.get_doc(uid1)
        assert doc.text == d1.text and doc.unique_id == uid1
        assert doc.metadata["title"] == "t1" and doc.metadata["author"] == "a"
        np.testing.assert_array_equal(doc.idx, d1.idx)
        np.testing.assert_array_equal(doc.len_, d1.len_)
        assert doc.pos == d1.pos and doc.tag == d1.tag
        np.testing.assert_array_equal(doc.spans["sentence"], d1.spans["sentence"])
        with pytest.raises(KeyError):
            corpus.get_doc("no-such-uid")
        # a session can be built straight from a reloaded corpus's documents
        session = vt.Session(corpus.docs, embeddings=[_emb(vt)], device="cpu")
        r = _index(session).find("The king rides", n=2)
        assert len(r) >= 1 and r[0].score > 0.9


def test_a_failed_add_leaves_no_document(tmp_path, monkeypatch):
    imp = vt.StringImporter()
    with Corpus(tmp_path / "c") as corpus:
        doc = imp("The king rides.", title="t")

        def broken(grp):
            grp.create_dataset("idx", data=np.zeros(1))
            raise OSError("disk full")

        monkeypatch.setattr(doc, "save_to", broken)
        with pytest.raises(OSError):
            corpus.add_doc(doc)
        assert len(corpus) == 0 and corpus.find_duplicate(doc) is None
        monkeypatch.undo()
        assert corpus.add_doc(imp("The king rides.", title="t")) in corpus.uuids


def test_flavor_persistence_skips_normalization(tmp_path, monkeypatch):
    """A reopened corpus's session loads the stored flavor: no
    normalization or interning, the same prepared and packed arrays and
    byte-identical results; another normalization misses and stores a
    flavor of its own; a new document invalidates every stored flavor."""
    emb = _emb(vt)
    with Corpus(tmp_path / "c") as corpus:
        _fill(corpus, vt)
        s1 = vt.Session(corpus, embeddings=[emb], device="cpu")
        assert len(list((tmp_path / "c" / "flavors").glob("*.h5"))) == 1
        want = _lists(_index(s1)), _lists(_index(s1, general=True))
        tok1 = [pd.token_ids.copy() for pd in s1.documents]
        vocab1 = list(s1.vocab.tokens.strings)
        p1 = s1.packed_corpus(s1.partition("sentence").spec)

    _forbid_prepare(monkeypatch, session_mod)
    with Corpus(tmp_path / "c") as corpus:
        s2 = vt.Session(corpus, embeddings=[emb], device="cpu")
        assert [pd.token_ids.tolist() for pd in s2.documents] == [t.tolist() for t in tok1]
        assert list(s2.vocab.tokens.strings) == vocab1
        for a, b in zip(s1.documents, s2.documents):
            assert a.doc.unique_id == b.doc.unique_id and a.doc_index == b.doc_index
            np.testing.assert_array_equal(a.orig_index, b.orig_index)
            np.testing.assert_array_equal(a.pos_ids, b.pos_ids)
            np.testing.assert_array_equal(a.tag_ids, b.tag_ids)
            assert a.spans.keys() == b.spans.keys()
            for level in a.spans:
                np.testing.assert_array_equal(a.spans[level], b.spans[level])
        p2 = s2.packed_corpus(s2.partition("sentence").spec)
        np.testing.assert_array_equal(p1.slice_doc, p2.slice_doc)
        np.testing.assert_array_equal(p1.buckets[0].token_ids, p2.buckets[0].token_ids)
        assert (_lists(_index(s2)), _lists(_index(s2, general=True))) == want

    monkeypatch.undo()
    with Corpus(tmp_path / "c") as corpus:
        s3 = vt.Session(corpus, embeddings=[emb], normalization=LowercaseNormalization(),
                        device="cpu")
        assert len(s3.documents) == 4
        assert len(list((tmp_path / "c" / "flavors").glob("*.h5"))) == 2
        key = corpus.content_key()
        corpus.add_doc(vt.StringImporter()("Fresh content.", title="t9"))
        assert corpus.content_key() != key
        assert corpus.load_flavor(VanillaNormalization().ident) is None
        s4 = vt.Session(corpus, embeddings=[emb], device="cpu")
        assert len(s4.documents) == 5
        assert corpus.load_flavor(VanillaNormalization().ident)["uids"] == corpus.uuids


def test_a_torn_flavor_file_is_a_miss(tmp_path):
    with Corpus(tmp_path / "c") as corpus:
        _fill(corpus, vt)
        vt.Session(corpus, embeddings=[_emb(vt)], device="cpu")
        ident = VanillaNormalization().ident
        path = corpus._flavor_path(ident)
        path.write_bytes(path.read_bytes()[:100])
        assert corpus.load_flavor(ident) is None
        s = vt.Session(corpus, embeddings=[_emb(vt)], device="cpu")
        assert len(s.documents) == 4 and corpus.load_flavor(ident) is not None


def test_temporary_corpus_cleans_up():
    corpus = TemporaryCorpus()
    corpus.add_doc(vt.StringImporter()("Some text here.", title="x"))
    assert len(corpus) == 1
    path = corpus.path
    assert (path / "corpus.h5").exists() and (path / "corpus.db").exists()
    corpus.close()
    assert not path.exists()
    with TemporaryCorpus() as corpus:
        path = corpus.path
    assert not path.exists()


@pytest.mark.parametrize("normalization", ["vanilla", "lowercase"])
def test_flavor_keys_match_jax(tmp_path, normalization):
    """The flavor file of a normalization has the JAX package's name: a
    digest of ``repr(normalization.ident)``."""
    norm_t = {"vanilla": VanillaNormalization, "lowercase": LowercaseNormalization}[normalization]
    norm_j = {"vanilla": vj.VanillaNormalization,
              "lowercase": vj.LowercaseNormalization}[normalization]
    assert repr(norm_t().ident) == repr(norm_j().ident)
    with Corpus(tmp_path / "t") as ct, JaxCorpus(tmp_path / "j") as cj:
        assert ct._flavor_path(norm_t().ident).name == cj._flavor_path(norm_j().ident).name


def test_a_jax_written_corpus_opens_in_the_port(tmp_path, monkeypatch):
    """The JAX package writes the corpus and its flavor; the port opens the
    same directory: the same uuids and texts, a flavor hit (no
    ``prepare_document``) and the JAX package's slices and scores."""
    with JaxCorpus(tmp_path / "c") as cj:
        uids = _fill(cj, vj)
        sj = vj.Session(cj, embeddings=[_emb(vj)])
        want = {g: _lists(_jax_index(sj, general=g)) for g in (False, True)}
        texts = {u: cj.get_doc(u).text for u in uids}

    _forbid_prepare(monkeypatch, session_mod)
    with Corpus(tmp_path / "c") as ct:
        assert ct.uuids == sorted(uids)
        assert {u: ct.get_doc(u).text for u in uids} == texts
        st = vt.Session(ct, embeddings=[_emb(vt)], device="cpu")
        assert [pd.doc.unique_id for pd in st.documents] == ct.uuids
        assert list(st.vocab.tokens.strings) == list(sj.vocab.tokens.strings)
        for general in (False, True):
            finds, batch = _lists(_index(st, general=general))
            assert batch == finds
            for w, g in zip(want[general][0], finds):
                assert g
                _assert_same_ranking(w, g, 0.1)


def test_a_port_written_corpus_opens_in_jax(tmp_path, monkeypatch):
    with Corpus(tmp_path / "c") as ct:
        uids = _fill(ct, vt)
        st = vt.Session(ct, embeddings=[_emb(vt)], device="cpu")
        want = {g: _lists(_index(st, general=g)) for g in (False, True)}
        texts = {u: ct.get_doc(u).text for u in uids}

    _forbid_prepare(monkeypatch, jax_session_mod)
    with JaxCorpus(tmp_path / "c") as cj:
        assert cj.uuids == sorted(uids)
        assert {u: cj.get_doc(u).text for u in uids} == texts
        sj = vj.Session(cj, embeddings=[_emb(vj)])
        assert list(sj.vocab.tokens.strings) == list(st.vocab.tokens.strings)
        for general in (False, True):
            finds, _ = _lists(_jax_index(sj, general=general))
            for w, g in zip(want[general][0], finds):
                _assert_same_ranking(g, w, 0.1)
    # the sqlite table is the reference's: one row a document
    with sqlite3.connect(tmp_path / "c" / "corpus.db") as db:
        assert sorted(r[0] for r in db.execute("SELECT unique_id FROM text")) == sorted(uids)


def _ctx_docs(pkg):
    """The documents with their contextual vectors stored in them (as a
    session's NLP tokenizes them)."""
    texts = _texts()[:3]
    docs = [pkg.StringImporter()(t, title=f"t{i}") for i, t in enumerate(texts)]
    enc = vt.LambdaContextualEmbedding("ctx", ctx_fn, DIM)
    for doc in docs:
        doc.contextual_embeddings["ctx"] = enc.encode_doc(SimpleNLP()(doc.text), doc.text)
    return docs


def _queries_only(tokens, text):
    """ctx_fn for a query; a stored document's text must not reach it."""
    if text not in QUERIES:
        raise AssertionError("a stored contextual vector was encoded again")
    return ctx_fn(tokens, text)


@pytest.mark.parametrize("general", [False, True])
def test_stored_contextual_vectors_reopen_and_search(tmp_path, monkeypatch, general):
    """A corpus whose documents carry LambdaContextualEmbedding vectors:
    the cold session (prepare, store the flavor) and the reopened one
    (flavor hit, vectors read lazily from corpus.h5, no encoding) return
    the same bytes, and the JAX package on the same directory the same
    slices with scores within 1e-6."""
    static_t = _emb(vt)
    with Corpus(tmp_path / "c") as ct:
        for doc in _ctx_docs(vt):
            ct.add_doc(doc)
        cold = vt.Session(ct, embeddings=[static_t, vt.LambdaContextualEmbedding(
            "ctx", _queries_only, DIM)], device="cpu")
        gap = LocalAlignment(ExponentialGapCost(3.0)) if general else LocalAlignment()
        ix = cold.partition("sentence").index(
            OptimizedSpanSim(EmbeddingTokenSim(cold.embeddings[1]), gap))
        want = _lists(ix)
        assert want[0] == want[1] and any(want[0])

    _forbid_prepare(monkeypatch, session_mod)
    with Corpus(tmp_path / "c") as ct:
        warm = vt.Session(ct, embeddings=[static_t, vt.LambdaContextualEmbedding(
            "ctx", _queries_only, DIM)], device="cpu")
        lazy = warm.documents[0].contextual["ctx"]
        assert type(lazy).__name__ == "LazyVectors"
        ix = warm.partition("sentence").index(
            OptimizedSpanSim(EmbeddingTokenSim(warm.embeddings[1]), gap))
        assert _lists(ix) == want
    monkeypatch.undo()

    with JaxCorpus(tmp_path / "c") as cj:
        sj = vj.Session(cj, embeddings=[_emb(vj), JaxLambda("ctx", _queries_only, DIM)])
        jgap = JaxLocal(JaxExponential(3.0)) if general else JaxLocal()
        ij = sj.partition("sentence").index(JaxSpanSim(JaxTokenSim(sj.embeddings[1]), jgap))
        for w, g in zip(_lists(ij)[0], want[0]):
            _assert_same_ranking(w, g, 0.1)
