"""The port stands alone: no JAX and nothing of the JAX package, and no
silent CPU path when a card was asked for."""

import ast
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import vectorian_tpu_torch as vt

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent

DRIVE = r"""
import sys
sys.modules["jax"] = None  # any import of jax now fails
sys.modules["vectorian_tpu"] = None
import numpy as np
import torch
torch.set_num_threads(2)
import vectorian_tpu_torch as vt
from vectorian_tpu_torch.alignment import LocalAlignment
from vectorian_tpu_torch.embedding.static import KeyedVectors
from vectorian_tpu_torch.metrics import EmbeddingTokenSim, OptimizedSpanSim

words = ["sun", "moon", "shines", "over", "the", "sea"]
emb = KeyedVectors(
    "toy", words,
    np.random.default_rng(0).normal(size=(len(words), 16)).astype("float32"),
)
docs = [vt.StringImporter()("The sun shines over the sea. Stars at night.", title="d0")]
session = vt.Session(docs, embeddings=[emb], device="cpu")
index = session.partition("sentence").index(
    OptimizedSpanSim(EmbeddingTokenSim(emb), LocalAlignment())
)
r = index.find("the sun shines over the sea", n=3)
j = r[0].to_json()
assert j["slice"] == 0 and j["score"] > 0.8, j
assert [m.slice_id for m in index.find_batch(["the sun shines"], n=3)[0]] == [0]
from vectorian_tpu_torch.alignment import ExponentialGapCost
general = session.partition("sentence").index(
    OptimizedSpanSim(EmbeddingTokenSim(emb), LocalAlignment(ExponentialGapCost(3.0)))
)
jg = general.find("the sun over the sea", n=3)[0].to_json()
assert jg["slice"] == 0 and any("gap_penalty" in r for r in jg["regions"]), jg
assert not [k for k in sys.modules if k == "jax" or k.startswith("jax.")
            if sys.modules[k] is not None]
print("DRIVE_OK", j["score"])
"""


def test_port_runs_without_jax():
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run(
        [sys.executable, "-c", DRIVE], capture_output=True, text=True,
        env=env, cwd=str(ROOT), timeout=300,
    )
    assert res.returncode == 0, res.stderr[-3000:]
    assert "DRIVE_OK" in res.stdout


def _sources():
    files = sorted((ROOT / "vectorian_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    return files


@pytest.mark.parametrize("path", _sources(), ids=lambda p: p.name)
def test_no_jax_or_jax_package_in_source(path):
    text = path.read_text()
    assert not re.search(r"\bjax\b", text), path
    assert not re.search(r"\bvectorian_tpu\.", text), path
    for node in ast.walk(ast.parse(text)):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            names = [node.module]
        for name in names:
            root = name.split(".")[0]
            assert root not in ("jax", "jaxlib", "vectorian_tpu"), (path, name)


def test_session_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    doc = vt.StringImporter()("The sun shines.", title="d0")
    with pytest.raises(RuntimeError, match="CUDA"):
        vt.Session([doc])
