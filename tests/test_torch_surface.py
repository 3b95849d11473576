"""The rest of the port's public surface: the reference package's public
names (every one a port object), ``compile`` / ``backend_build_time``, ``BruteForceIndex.warmup``,
the on-disk packed-corpus cache and the native library's loader."""

import ast
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import vectorian_tpu as vj
import vectorian_tpu_torch as vt
import vectorian_tpu_torch.session as tsession
from vectorian_tpu_torch import native
from vectorian_tpu_torch.alignment import LocalAlignment
from vectorian_tpu_torch.metrics import EmbeddingTokenSim, OptimizedSpanSim

torch.set_num_threads(2)


def _reference_public_names():
    """The public names the reference's __init__.py defines or imports (its
    module's dir() also holds submodules other tests happen to import)."""
    tree = ast.parse(Path(vj.__file__).read_text())
    names = set()
    for node in tree.body:
        if isinstance(node, ast.ImportFrom) and (node.module or "").startswith("vectorian_tpu"):
            names |= {a.asname or a.name for a in node.names}
        elif isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            names |= {t.id for t in node.targets if isinstance(t, ast.Name)}
    return sorted(n for n in names if not n.startswith("_"))


def test_every_public_name_of_the_reference_exists():
    names = _reference_public_names()
    assert {"Session", "PretrainedFastText", "compile", "Zoo", "make_mesh"} <= set(names)
    assert not [n for n in names if not hasattr(vt, n)]
    # the storage and notebook layer's names are the port's own classes
    for name in ("Corpus", "TemporaryCorpus", "LabSession", "Zoo"):
        obj = getattr(vt, name)
        assert isinstance(obj, type) and obj.__module__.startswith("vectorian_tpu_torch."), name
    assert not hasattr(vt, "UNPORTED") and not hasattr(vt, "_Unported")


def test_compile_and_backend_build_time():
    assert vt.compile() is native.available()
    when = vt.backend_build_time()
    if native.available():
        assert when is not None and when.timestamp() <= time.time() + 1
        assert native.library_path().parent == native.BUILD_DIR
        assert native.BUILD_DIR.name == "_build" and native.BUILD_DIR.parent.name == (
            "vectorian_tpu_torch")
    else:
        assert when is None


TEXT = ("the sun shines over the sea. stars shine at night. the moon rises "
        "over the quiet sea. a ship sails at night under the stars.")
QUERIES = ["the sun over the sea", "stars at night", "a moon sails"]


def _session(normalization=None):
    words = ["the", "sun", "shines", "over", "sea", "stars", "shine", "at", "night",
             "moon", "rises", "quiet", "a", "ship", "sails", "under"]
    mat = np.random.default_rng(4).normal(size=(len(words), 16)).astype(np.float32)
    emb = vt.KeyedVectors("toy", words, mat)
    kw = {} if normalization is None else {"normalization": normalization}
    return vt.Session([vt.StringImporter()(TEXT, title="d")], embeddings=[emb],
                      device="cpu", **kw)


def _matches(session):
    emb = session.embeddings[0]
    index = session.partition("sentence").index(
        OptimizedSpanSim(EmbeddingTokenSim(emb), LocalAlignment()))
    return [[(m.slice_id, m.score) for m in r]
            for r in index.find_batch(QUERIES, n=3, min_score=0.0)], index


def test_warmup_returns_the_index_and_changes_no_result(tmp_path, monkeypatch):
    monkeypatch.setenv("VECTORIAN_CACHE_HOME", str(tmp_path))
    session = _session()
    before, index = _matches(session)
    singles = [[(m.slice_id, m.score) for m in index.find(q, n=3, min_score=0.0)]
               for q in QUERIES]
    assert index.warmup(max_tokens=9, n=3) is index
    assert _matches(session)[0] == before == singles


@pytest.fixture
def cache_home(tmp_path, monkeypatch):
    monkeypatch.setenv("VECTORIAN_CACHE_HOME", str(tmp_path))
    return tmp_path / "packed"


def _count_packs(monkeypatch):
    calls = []
    real = tsession.pack_corpus

    def counting(*args, **kwargs):
        calls.append(args[1])
        return real(*args, **kwargs)

    monkeypatch.setattr(tsession, "pack_corpus", counting)
    return calls


def test_packed_cache_hit_loads_without_packing(cache_home, monkeypatch):
    want, _ = _matches(_session())
    files = sorted(cache_home.glob("*.npz"))
    assert len(files) == 1 and files[0].name.endswith("-sentence-1-1.npz")

    def refuse(*args, **kwargs):
        raise AssertionError("a cache hit must not pack the corpus")

    monkeypatch.setattr(tsession, "pack_corpus", refuse)
    got, index = _matches(_session())
    assert got == want
    assert index.packed.n_slices == 4


def test_packed_cache_misses_on_another_normalization(cache_home, monkeypatch):
    _matches(_session())
    calls = _count_packs(monkeypatch)
    _matches(_session(vt.LowercaseNormalization()))
    assert len(calls) == 1
    assert len(list(cache_home.glob("*.npz"))) == 2


@pytest.mark.parametrize("damage", ["garbage", "truncated"])
def test_corrupt_packed_cache_is_packed_again(cache_home, monkeypatch, damage):
    want, _ = _matches(_session())
    (path,) = cache_home.glob("*.npz")
    whole = path.read_bytes()
    path.write_bytes(b"not a zip archive" if damage == "garbage" else whole[: len(whole) // 2])
    calls = _count_packs(monkeypatch)
    got, _ = _matches(_session())
    assert len(calls) == 1 and got == want
    # the repacked file replaced the corrupt one, and loads
    monkeypatch.setattr(tsession, "pack_corpus", None)
    assert _matches(_session())[0] == want
    assert not list(cache_home.glob("*.tmp*"))


LOADER = r"""
import importlib.util, sys, time
from pathlib import Path
spec = importlib.util.spec_from_file_location("port_native", sys.argv[1])
mod = importlib.util.module_from_spec(spec)
spec.loader.exec_module(mod)
go = Path(sys.argv[2])
deadline = time.time() + 60
while not go.exists() and time.time() < deadline:
    time.sleep(0.01)
ok = mod.available() and mod._load().vn_ft_hash(b"a", 1) == 0xE40C292C
print("LOADED" if ok else "UNAVAILABLE", flush=True)
"""


def _native_copy(tmp_path):
    """The port's native.py and its C++ source in a package directory of
    their own, so its build directory starts empty."""
    pkg = tmp_path / "pkg"
    (pkg / "csrc").mkdir(parents=True)
    shutil.copy(native.__file__, pkg / "native.py")
    shutil.copy(native.SOURCE, pkg / "csrc" / native.SOURCE.name)
    return pkg


def test_processes_starting_together_all_load_the_library(tmp_path):
    if shutil.which("g++") is None:
        pytest.skip("no C++ compiler here")
    pkg = _native_copy(tmp_path)
    go = tmp_path / "go"
    procs = [subprocess.Popen([sys.executable, "-c", LOADER, str(pkg / "native.py"), str(go)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(4)]
    time.sleep(0.5)
    go.touch()
    outs = [p.communicate(timeout=300) for p in procs]
    assert [o.strip() for o, _ in outs] == ["LOADED"] * 4, [e[-2000:] for _, e in outs]
    built = sorted(p.name for p in (pkg / "_build").iterdir())
    assert len([b for b in built if b.endswith(".so")]) == 1, built
    assert not [b for b in built if ".tmp" in b], built


def test_no_library_without_compiler_or_when_disabled(tmp_path):
    pkg = _native_copy(tmp_path)
    go = tmp_path / "go"
    go.touch()
    clean = {k: v for k, v in os.environ.items() if k not in ("CXX", "VECTORIAN_NO_NATIVE")}
    for env in ({"CXX": "no-such-compiler-anywhere"}, {"VECTORIAN_NO_NATIVE": "1"}):
        res = subprocess.run([sys.executable, "-c", LOADER, str(pkg / "native.py"), str(go)],
                             capture_output=True, text=True, timeout=120, env={**clean, **env})
        assert res.stdout.strip() == "UNAVAILABLE", res.stderr[-2000:]
    assert not list(pkg.rglob("*.so"))


def test_transformer_embedding_defaults_to_the_card(monkeypatch):
    """TransformerContextualEmbedding runs on the card unless asked for the
    CPU: with no card its default raises naming ``device="cpu"``, as
    ``Session`` does; ``device="cpu"`` constructs (no weights are read)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match=r"device='cpu'"):
        vt.TransformerContextualEmbedding("some/model")
    with pytest.raises(RuntimeError, match=r"device='cpu'"):
        vt.TransformerContextualEmbedding("some/model", device="cuda:0")
    emb = vt.TransformerContextualEmbedding("some/model", device="cpu")
    assert emb.name == "trf-some-model" and not emb.is_static
    assert emb.pca(8).transforms[-1].__class__.__name__ == "PCACompression"
