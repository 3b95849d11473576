"""Token, document and sentence windows through the port's ``find`` and
``find_batch`` against the JAX package, on the CPU: the partitions of the
reference's tests/test_partitions.py and the sentence windows of several
sentences (``partition("sentence", 2, 2)``, ``("sentence", 3, 1)``), under
local, global affine and ``ExponentialGapCost(3.0)`` alignment.  The same
slices and scores within 1e-6 except inside bands of tied scores, the same
packing (slice counts and lengths), and inside the port ``find`` =
``find_batch`` byte for byte.
"""

import numpy as np
import pytest
import torch

import vectorian_tpu as vj
import vectorian_tpu_torch as vt
from vectorian_tpu.alignment import AffineGapCost as JaxAffine
from vectorian_tpu.alignment import ExponentialGapCost as JaxExponential
from vectorian_tpu.alignment import GlobalAlignment as JaxGlobal
from vectorian_tpu.alignment import LocalAlignment as JaxLocal
from vectorian_tpu.metrics import EmbeddingTokenSim as JaxTokenSim
from vectorian_tpu.metrics import OptimizedSpanSim as JaxSpanSim
from vectorian_tpu_torch.alignment import (
    AffineGapCost,
    ExponentialGapCost,
    GlobalAlignment,
    LocalAlignment,
)
from vectorian_tpu_torch.metrics import EmbeddingTokenSim, OptimizedSpanSim

from tests.test_torch_slice import _assert_same_ranking, _corpus, _pairs

torch.set_num_threads(2)

PARTITIONS = [("token", 4, 2), ("token", 6, 3), ("document",), ("sentence", 2, 2),
              ("sentence", 3, 1)]
ALIGNMENTS = {
    "local": (JaxLocal, LocalAlignment),
    "global": (lambda: JaxGlobal(JaxAffine(0.37, 0.113)),
               lambda: GlobalAlignment(AffineGapCost(0.37, 0.113))),
    "exponential": (lambda: JaxLocal(JaxExponential(3.0)),
                    lambda: LocalAlignment(ExponentialGapCost(3.0))),
}


@pytest.fixture(scope="module")
def both():
    words, mat, texts, queries = _corpus(seed=4)
    sj = vj.Session([vj.StringImporter()(t, title=f"d{i}") for i, t in enumerate(texts)],
                    embeddings=[vj.KeyedVectors("toy", words, mat)])
    st = vt.Session([vt.StringImporter()(t, title=f"d{i}") for i, t in enumerate(texts)],
                    embeddings=[vt.KeyedVectors("toy", words, mat)], device="cpu")
    return sj, st, queries[:4]


@pytest.mark.parametrize("alignment", sorted(ALIGNMENTS))
@pytest.mark.parametrize("partition", PARTITIONS, ids=lambda p: "-".join(map(str, p)))
def test_partition_find_matches_jax(both, partition, alignment):
    sj, st, queries = both
    mk_j, mk_t = ALIGNMENTS[alignment]
    pj, pt = sj.partition(*partition), st.partition(*partition)
    ij = pj.index(JaxSpanSim(JaxTokenSim(sj.embeddings[0]), mk_j()))
    it = pt.index(OptimizedSpanSim(EmbeddingTokenSim(st.embeddings[0]), mk_t()))
    packed_j, packed_t = ij.packed, it.packed
    assert packed_t.n_slices == packed_j.n_slices
    assert np.array_equal(np.asarray(packed_t.slice_len), np.asarray(packed_j.slice_len))
    n, min_score = 5, -1.0 if alignment == "global" else 0.1
    finds = []
    for q in queries:
        got = _pairs(it.find(q, n=n, min_score=min_score))
        assert got, q
        _assert_same_ranking(_pairs(ij.find(q, n=n, min_score=min_score)), got, min_score)
        finds.append(got)
    assert [_pairs(r) for r in it.find_batch(queries, n=n, min_score=min_score,
                                             sim_precision="float32")] == finds
