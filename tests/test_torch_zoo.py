"""The port's embedding registry (``embedding/zoo.py``) and its download
machinery (``embedding/utils.py``) against the JAX package, on the CPU.

No test reaches the network: every fetch goes through a fake fetcher that
serves bytes the test wrote.  ``Zoo.list()`` and ``url()`` equal the JAX
package's; the download pipeline (sha256 check, idempotence, no torn file,
gzip and zip) and the numberbatch extraction produce files byte-equal to
the JAX package's from the same bytes; ``Zoo.fetch`` / ``load`` give
loadable embeddings; the PCA helper agrees with the JAX package's within
1e-5.
"""

import gzip
import hashlib
import io
import zipfile

import numpy as np
import pytest

from vectorian_tpu.embedding import utils as jutils
from vectorian_tpu.embedding.zoo import Zoo as JaxZoo
from vectorian_tpu_torch.embedding import utils
from vectorian_tpu_torch.embedding.fasttext import PretrainedFastText
from vectorian_tpu_torch.embedding.static import PretrainedGloVe, Word2VecVectors
from vectorian_tpu_torch.embedding.zoo import Zoo
from vectorian_tpu_torch.normalization import VanillaNormalization


def _serve(data):
    return lambda url: iter([data])


def _files(root):
    return {p.relative_to(root).as_posix(): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()}


def test_zoo_list_url_and_path_match_jax(tmp_path, monkeypatch):
    monkeypatch.setenv("VECTORIAN_CACHE_HOME", str(tmp_path))
    names = Zoo.list()
    assert names == JaxZoo.list()
    assert "fasttext-en" in names and "glove-6B-300" in names
    assert "numberbatch-19.08-de" in names
    assert [Zoo.url(n) for n in names] == [JaxZoo.url(n) for n in names]
    assert [Zoo.path(n) for n in names] == [JaxZoo.path(n) for n in names]
    assert all(Zoo.url(n).startswith("https://") for n in names)
    with pytest.raises(KeyError):
        Zoo.load("nope")
    with pytest.raises(KeyError):
        Zoo.url("nope")


@pytest.mark.parametrize("name,cls", [("fasttext-en", PretrainedFastText),
                                      ("glove-6B-50", PretrainedGloVe),
                                      ("numberbatch-19.08-en", Word2VecVectors)])
def test_zoo_load_names_the_port_embedding(tmp_path, monkeypatch, name, cls):
    monkeypatch.setenv("VECTORIAN_CACHE_HOME", str(tmp_path))
    emb = Zoo.load(name)
    assert isinstance(emb, cls) and emb.name == JaxZoo.load(name).name


def _download_cases(root, mod):
    """Every case of the reference's download test; returns what raised."""
    data = b"hello embedding bytes"
    out = mod.download("http://host/y/plain.txt", root, fetcher=_serve(data),
                       checksum=hashlib.sha256(data).hexdigest())
    assert out == root / "plain.txt" and out.read_bytes() == data

    def refetch(url):
        raise AssertionError("an existing artifact must not be fetched again")

    assert mod.download("http://host/y/plain.txt", root, fetcher=refetch) == out
    raised = []
    with pytest.raises(ValueError) as e:
        mod.download("http://host/y/bad.txt", root, fetcher=_serve(data), checksum="0" * 64)
    raised.append(str(e.value))
    assert not (root / "bad.txt").exists()

    def torn(url):
        yield b"partial"
        raise IOError("connection reset")

    with pytest.raises(IOError):
        mod.download("http://host/y/torn.txt", root, fetcher=torn)
    assert not (root / "torn.txt").exists()

    out = mod.download("http://host/z/file.txt.gz", root,
                       fetcher=_serve(gzip.compress(b"unzipped!")))
    assert out == root / "file.txt" and out.read_bytes() == b"unzipped!"
    assert not (root / "file.txt.gz").exists()

    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w") as zf:
        zf.writestr("nested/glove.6B.50d.txt", "the 1 0\n")
        zf.writestr("nested/glove.6B.100d.txt", "the 1 0 0 0\n")
    mod.download("http://host/glove.6B.zip", root / "z2", fetcher=_serve(buf.getvalue()))
    assert not (root / "z2" / "glove.6B.zip").exists()
    # a single-member zip is renamed to the archive's stem
    one = io.BytesIO()
    with zipfile.ZipFile(one, "w") as zf:
        zf.writestr("deep/dir/vectors.txt", "a 1\n")
    out = mod.download("http://host/single.zip", root / "z3", fetcher=_serve(one.getvalue()))
    assert out == root / "z3" / "single" and out.read_bytes() == b"a 1\n"
    return raised


def test_download_machinery_matches_jax(tmp_path):
    raised_t = _download_cases(tmp_path / "t", utils)
    raised_j = _download_cases(tmp_path / "j", jutils)
    assert raised_t == raised_j
    files = _files(tmp_path / "t")
    assert files == _files(tmp_path / "j")
    assert {"z2/glove.6B.50d.txt", "z2/glove.6B.100d.txt", "file.txt", "plain.txt"} <= set(files)
    assert utils.sha256_file(tmp_path / "t" / "plain.txt") == jutils.sha256_file(
        tmp_path / "j" / "plain.txt")


def _numberbatch_dump():
    lines = ["9 4"]
    for lang in ("en", "de", "fr"):
        for i, w in enumerate(("sun", "moon", "sea2")):
            lines.append(f"/c/{lang}/{w} {i}.0 1.0 2.0 3.0")
    return "\n".join(lines) + "\n"


def test_extract_numberbatch_matches_jax(tmp_path):
    for d in ("t", "j"):
        (tmp_path / d).mkdir()
        (tmp_path / d / "numberbatch-19.08.txt").write_text(_numberbatch_dump())
    got = utils.extract_numberbatch(tmp_path / "t" / "numberbatch-19.08.txt", ["en", "de"])
    want = jutils.extract_numberbatch(tmp_path / "j" / "numberbatch-19.08.txt", ["en", "de"])
    assert [p.name for p in got] == [p.name for p in want] == [
        "numberbatch-en-19.08.txt", "numberbatch-de-19.08.txt"]
    assert _files(tmp_path / "t") == _files(tmp_path / "j")
    # isalpha keys only, as the reference keeps them
    assert got[0].read_text().splitlines() == ["2 4", "sun 0.0 1.0 2.0 3.0", "moon 1.0 1.0 2.0 3.0"]


def _glove_zip(rng):
    def lines(d):
        return "\n".join(w + " " + " ".join(f"{x:.3f}" for x in rng.normal(size=d))
                         for w in ("king", "queen", "horse")) + "\n"

    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w") as zf:
        zf.writestr("glove.6B.50d.txt", lines(50))
        zf.writestr("glove.6B.100d.txt", lines(100))
    return buf.getvalue()


def test_zoo_fetch_glove_and_numberbatch_match_jax(tmp_path, monkeypatch):
    """Zoo.fetch runs the pipeline from bytes the test serves: a glove zip
    that PretrainedGloVe loads, a numberbatch gz dump extracted to the
    word2vec text Word2VecVectors loads; the cache directory holds the JAX
    package's bytes."""
    glove = _glove_zip(np.random.default_rng(0))
    nb = gzip.compress(_numberbatch_dump().encode())
    for d, zoo in (("j", JaxZoo), ("t", Zoo)):
        monkeypatch.setenv("VECTORIAN_CACHE_HOME", str(tmp_path / d))
        assert zoo.fetch("glove-6B-50", fetcher=_serve(glove)).exists()
        path = zoo.fetch("numberbatch-19.08-en", fetcher=_serve(nb))
        assert path.name == "numberbatch-en-19.08.txt"

        def refetch(url):
            raise AssertionError("a fetched artifact must not be fetched again")

        assert zoo.fetch("glove-6B-50", fetcher=refetch) == zoo.path("glove-6B-50")
    assert _files(tmp_path / "t") == _files(tmp_path / "j")

    enc = Zoo.load("glove-6B-50").create_encoder(VanillaNormalization())
    assert enc.word_vec("king").shape == (50,) and np.abs(enc.word_vec("king")).sum() > 0
    enc = Zoo.load("numberbatch-19.08-en", fetch=True, fetcher=None).create_encoder(
        VanillaNormalization())
    assert enc.word_vec("moon").shape == (4,) and enc.word_vec("moon")[0] == pytest.approx(1.0)
    # force fetches again over the existing artifact
    assert Zoo.fetch("glove-6B-50", fetcher=_serve(glove), force=True).exists()
    with pytest.raises(ValueError):
        Zoo.fetch("glove-6B-100", fetcher=_serve(glove), force=True, checksum="0" * 64)


def test_zoo_fetch_that_produces_nothing_raises(tmp_path, monkeypatch):
    monkeypatch.setenv("VECTORIAN_CACHE_HOME", str(tmp_path))
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w") as zf:
        zf.writestr("other-a.txt", "x\n")
        zf.writestr("other-b.txt", "y\n")
    with pytest.raises(FileNotFoundError):
        Zoo.fetch("glove-6B-200", fetcher=_serve(buf.getvalue()))


def test_compress_keyed_vectors_matches_jax():
    rng = np.random.default_rng(5)
    words = [f"w{i}" for i in range(40)]
    mat = rng.normal(size=(40, 12)).astype(np.float32)
    got_w, got = utils.compress_keyed_vectors(words, mat, 4)
    want_w, want = jutils.compress_keyed_vectors(words, mat, 4)
    assert got_w == want_w == words and got.shape == (40, 4) and got.dtype == np.float32
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-5)
