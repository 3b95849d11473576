"""The port's general-gap (Waterman-Smith-Beyer) search on a length-mixed
corpus against the JAX package, on the CPU.

Sentence lengths are drawn log-normal (sigma 0.55 as in chip_smoke.py's
phase 4r, the median raised from 18 to 40 tokens so that a few hundred
sentences fill the buckets of 64, 128 and 256 tokens too), their words
Zipf-like over a small vocabulary, all from a seeded numpy generator.
Both packages search the same corpus: find and find_batch return the same
slices with scores within 1e-6 relative (ids may differ only inside bands
of tied scores), and inside the port find == find_batch byte for byte at
the f32 and int8 ranking precisions.  On the CPU the wrappers take their
plain versions; the long route's kernel itself is held against them on
the card by chip_smoke.py.
"""

import numpy as np
import pytest
import torch

import vectorian_tpu as vj
import vectorian_tpu_torch as vt
from vectorian_tpu.alignment import CustomGapCost as JaxCustom
from vectorian_tpu.alignment import ExponentialGapCost as JaxExponential
from vectorian_tpu.alignment import GlobalAlignment as JaxGlobal
from vectorian_tpu.alignment import LocalAlignment as JaxLocal
from vectorian_tpu.alignment import SemiGlobalAlignment as JaxSemiGlobal
from vectorian_tpu.metrics import EmbeddingTokenSim as JaxTokenSim
from vectorian_tpu.metrics import OptimizedSpanSim as JaxSpanSim
from vectorian_tpu_torch.alignment import (
    CustomGapCost,
    ExponentialGapCost,
    GlobalAlignment,
    LocalAlignment,
    SemiGlobalAlignment,
)
from vectorian_tpu_torch.metrics import EmbeddingTokenSim, OptimizedSpanSim
from vectorian_tpu_torch.ops import dp_kernels

torch.set_num_threads(2)

REL = 1e-6  # scores: the similarity GEMM sums in another order
SENTENCES = 180
MEDIAN, SIGMA, CLIP = 40, 0.55, (3, 250)
LONG_CAPACITIES = (64, 128, 256)

# (locality, gap model) of each case: local exponential, global custom,
# semiglobal exponential
CASES = {
    "local-exponential": (JaxLocal, LocalAlignment, lambda: JaxExponential(3.0),
                          lambda: ExponentialGapCost(3.0)),
    "global-custom": (JaxGlobal, GlobalAlignment, lambda: JaxCustom(lambda k: 0.1 * k ** 0.5),
                      lambda: CustomGapCost(lambda k: 0.1 * k ** 0.5)),
    "semiglobal-exponential": (JaxSemiGlobal, SemiGlobalAlignment,
                               lambda: JaxExponential(3.0), lambda: ExponentialGapCost(3.0)),
}


def _corpus(seed=18):
    rng = np.random.default_rng(seed)
    words = ["".join(chr(97 + int(c)) for c in rng.integers(0, 26, size=4 + i % 3))
             for i in range(60)]
    mat = rng.normal(size=(len(words), 16)).astype(np.float32)
    p = 1.0 / np.arange(1, len(words) + 1) ** 1.1
    p /= p.sum()
    lengths = np.clip(np.rint(rng.lognormal(np.log(MEDIAN), SIGMA, size=SENTENCES)), *CLIP)
    # one sentence past 128 tokens, so the bucket of 256 holds a slice
    lengths[0] = 200
    sents = [" ".join(rng.choice(words, size=int(n), p=p)) + "." for n in lengths]
    texts = [" ".join(sents[i:i + 45]) for i in range(0, SENTENCES, 45)]
    queries = [" ".join(rng.choice(words, size=int(rng.integers(2, 8)), p=p))
               for _ in range(5)]
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


def _indexes(sj, st, case):
    opt_j, opt_t, gap_j, gap_t = CASES[case]
    ij = sj.partition("sentence").index(
        JaxSpanSim(JaxTokenSim(sj.embeddings[0]), opt_j(gap_j())))
    it = st.partition("sentence").index(
        OptimizedSpanSim(EmbeddingTokenSim(st.embeddings[0]), opt_t(gap_t())))
    return ij, it


def test_long_buckets_hold_slices(both):
    """The mix fills every bucket the long route serves (33-256 tokens) in
    both packages, with the same lengths."""
    sj, st, _ = both
    spec = sj.partition("sentence").spec
    bj = {b.capacity: np.asarray(b.lengths) for b in sj.packed_corpus(spec).buckets}
    bt = {b.capacity: np.asarray(b.lengths) for b in st.packed_corpus(spec).buckets}
    assert bj.keys() == bt.keys()
    for cap in LONG_CAPACITIES:
        assert len(bt.get(cap, ())) > 0, cap
        assert np.array_equal(bj[cap], bt[cap])
        assert (bt[cap] > cap // 2).all() and (bt[cap] <= cap).all()
        # on the card this bucket takes the long route (a closure >= 0,
        # needles up to 32 columns)
        assert dp_kernels.wsb_launch_plan(len(bt[cap]) * 32, cap, 8, Q=32).route == "long"


@pytest.mark.parametrize("case", sorted(CASES))
def test_long_buckets_find_and_find_batch_match_jax(both, case):
    """find and find_batch (f32) agree with the JAX package on the
    length-mixed corpus; inside the port find == find_batch byte for byte."""
    sj, st, queries = both
    ij, it = _indexes(sj, st, case)
    n = 6
    # global scores go negative: keep every slice in play
    min_score = -100.0 if case.startswith("global") else 0.1
    dp_kernels.reset_launches()
    port_find = []
    for q in queries:
        want = _pairs(ij.find(q, n=n, min_score=min_score))
        got = _pairs(it.find(q, n=n, min_score=min_score))
        assert got, q
        _assert_same_ranking(want, got, min_score)
        port_find.append(got)
    want_b = ij.find_batch(queries, n=n, min_score=min_score, sim_precision="float32")
    got_b = it.find_batch(queries, n=n, min_score=min_score, sim_precision="float32")
    for w, g in zip(want_b, got_b):
        _assert_same_ranking(_pairs(w), _pairs(g), min_score)
    assert [_pairs(r) for r in got_b] == port_find
    # tensors on the CPU take the plain versions: no kernel launch counted
    assert not any(dp_kernels.LAUNCHES.values())
    assert not any(dp_kernels.WSB_ROUTE_LAUNCHES.values())


@pytest.mark.parametrize("precision", ["float32", "int8"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_long_buckets_find_batch_bytes_equal_find(both, case, precision):
    """Inside the port, find_batch at the f32 and the int8 ranking
    precisions returns find's bytes on the length-mixed corpus."""
    _, st, queries = both
    _, opt_t, _, gap_t = CASES[case]
    it = st.partition("sentence").index(
        OptimizedSpanSim(EmbeddingTokenSim(st.embeddings[0]), opt_t(gap_t())))
    min_score = -100.0 if case.startswith("global") else 0.1
    finds = [_pairs(it.find(q, n=4, min_score=min_score)) for q in queries]
    assert all(finds)
    batch = it.find_batch(queries, n=4, min_score=min_score, sim_precision=precision)
    assert [_pairs(r) for r in batch] == finds
