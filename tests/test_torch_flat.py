"""The port's score-only rescore: the row-gather DP entries and the
extras round that batches them, against the JAX package and against the
per-column form they replace.

Inputs come from a seeded numpy generator.  The row-gather entries'
plain versions (their CPU path) are held bit for bit against the JAX Pallas
kernels in interpret mode on the gathered similarity block
``table[qslot * V + tokens[rows]]``, with the rescore's empty-slice mask.
The extras round (``BucketTopKSource._above_exact_many``, one row-gather
launch a bucket a round) must return byte-identical ``(ids, rmap)`` to a
per-column loop written here: ``torch.nonzero`` of each column, the gather
and the flat-batch entry's plain version.
"""

import numpy as np
import pytest
import torch

from vectorian_tpu.ops.alignment import AffineGapParams as JaxGaps
from vectorian_tpu.ops.pallas_dp import pallas_align_scores, pallas_align_scores_general
import vectorian_tpu_torch as vt
from vectorian_tpu_torch.alignment import (
    CustomGapCost,
    ExponentialGapCost,
    LocalAlignment,
    SemiGlobalAlignment,
)
from vectorian_tpu_torch.metrics import EmbeddingTokenSim, OptimizedSpanSim
from vectorian_tpu_torch.ops import dp_kernels, search
from vectorian_tpu_torch.ops.alignment import AffineGapParams, gap_cost_closure

torch.set_num_threads(2)

LOCALITIES = ["local", "global", "semiglobal"]
NEG = np.float32(-1e30)
_STEPS = np.cumsum(np.random.default_rng(7).uniform(0.0, 0.35, size=128)).astype(np.float32)
MODELS = {
    "affine_zero": (0.0, 0.0, 0.0, 0.0),
    "affine": (0.37, 0.113, 0.29, 0.071),
    "exponential": ExponentialGapCost(3.0),
    "custom": CustomGapCost(lambda k: float(_STEPS[int(k)])),
    # a gap bonus: its closure is negative, so no register route takes it
    "gap_bonus": CustomGapCost(lambda k: -0.05 * k),
}


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _rows_inputs(seed, L, T, B=40, n=17, V=29, slots=3):
    """A stacked [slots * V, T] table, a bucket's [n, L] token ids and B
    (row, slot) problems; len_s holds 0, 1 and L, len_t 1 and T."""
    rng = np.random.default_rng(seed)
    table = rng.uniform(-0.4, 1.0, size=(slots * V, T)).astype(np.float32)
    tokens = rng.integers(0, V, size=(n, L)).astype(np.int32)
    rows = rng.integers(0, n, size=B).astype(np.int32)
    qslot = rng.integers(0, slots, size=B).astype(np.int32)
    len_s = rng.integers(0, L + 1, size=B).astype(np.int32)
    len_s[:3] = (0, 1, L)
    len_t = rng.integers(1, T + 1, size=B).astype(np.int32)
    len_t[3:5] = (T, 1)
    return table, tokens, rows, qslot, len_s, len_t, V


@pytest.mark.parametrize("shape", [(8, 6), (16, 12), (40, 33)])
@pytest.mark.parametrize("model", sorted(MODELS))
@pytest.mark.parametrize("locality", LOCALITIES)
def test_rows_plain_bit_equal_to_pallas(locality, model, shape):
    """``*_dp_scores_rows`` on the CPU equal the Pallas kernel on the
    gathered block, masked where len_s <= 0, bit for bit, and equal the
    rescore's former composition (``_mq_similarity`` + the flat entry's
    plain version + the mask).  (40, 33) is outside the register route."""
    L, T = shape
    table, tokens, rows, qslot, len_s, len_t, V = _rows_inputs(L * 100 + T, L, T)
    S = table[qslot[:, None] * V + tokens[rows]]  # [B, L, T]
    jargs = (S, len_s, len_t)
    args = (_t(tokens), _t(rows), _t(qslot), _t(table), V, _t(len_s), _t(len_t))
    S_t = search._mq_similarity(_t(tokens)[_t(rows).long()], _t(qslot), _t(table), V)
    cost = MODELS[model]
    if isinstance(cost, tuple):
        got = dp_kernels.affine_dp_scores_rows(*args, AffineGapParams.of(*cost), locality)
        want = pallas_align_scores(*jargs, JaxGaps.of(*cost), locality, interpret=True)
        flat = dp_kernels.affine_dp_scores_flat_reference(
            S_t, _t(len_s), _t(len_t), AffineGapParams.of(*cost), locality)
    else:
        w_s, w_t = cost.costs(L + 1), cost.costs(T + 1)
        vecs = (_t(w_s), _t(w_t), gap_cost_closure(_t(w_t)))
        got = dp_kernels.wsb_dp_scores_rows(*args, *vecs, locality, host_costs=vecs)
        want = pallas_align_scores_general(*jargs, w_s, w_t, locality, interpret=True)
        flat = dp_kernels.wsb_dp_scores_flat_reference(
            S_t, _t(len_s), _t(len_t), *vecs, locality)
    got = got.numpy()
    assert got.shape == (len(rows),) and got.dtype == np.float32
    assert np.array_equal(got, np.where(len_s > 0, np.asarray(want), NEG))
    assert np.array_equal(got, flat.masked_fill(_t(len_s) <= 0, search.NEG_SCORE).numpy())
    assert (got[len_s == 0] == NEG).all()


@pytest.mark.parametrize("model", ["affine", "exponential", "gap_bonus"])
@pytest.mark.parametrize("locality", LOCALITIES)
def test_stacked_rescore_score_only_matches_flows(locality, model):
    """``rescore_many``'s score-only pass (row-gather entry) gives the bits
    of the flows pass (gather + the torch DP that also returns H)."""
    L, T = 16, 8
    table, tokens, rows, qslot, len_s, len_t, V = _rows_inputs(3, L, T, B=60)
    cost = MODELS[model]
    if isinstance(cost, tuple):
        gaps, general = AffineGapParams.of(*cost), None
    else:
        gaps = AffineGapParams.of(0, 0, 0, 0)
        general = search.GeneralGaps((cost, cost), T + 1, torch.device("cpu"))
    args = (_t(tokens), _t(rows).long(), _t(qslot).long(), _t(table),
            _t(len_s).long(), _t(len_t).long(), gaps, V, locality)
    raw, H, S, Su = search._stacked_rescore(*args, False, general)
    assert H is None and S is None and Su is None
    raw_f, H_f, S_f, Su_f = search._stacked_rescore(*args, True, general)
    assert H_f.shape[0] == len(rows) and S_f.shape == (len(rows), L, T)
    assert Su_f is S_f  # untagged: the DP read the unweighted block
    assert np.array_equal(raw.numpy(), raw_f.numpy())


def test_rows_wrappers_check_their_inputs():
    table, tokens, rows, qslot, len_s, len_t, V = _rows_inputs(1, 8, 6)
    gaps = AffineGapParams.of(0, 0, 0, 0)
    args = [_t(tokens), _t(rows), _t(qslot), _t(table), V, _t(len_s), _t(len_t)]
    with pytest.raises(ValueError, match="qslot"):
        dp_kernels.affine_dp_scores_rows(*args[:2], _t(qslot[:-1]), *args[3:], gaps, "local")
    with pytest.raises(ValueError, match="locality"):
        dp_kernels.affine_dp_scores_rows(*args, gaps, "sideways")
    w = torch.zeros(9)
    with pytest.raises(ValueError, match="w_t"):
        dp_kernels.wsb_dp_scores_rows(*args, w, w[:3], w, "local")
    # a tensor on neither the CPU nor a card never takes the plain version
    args[3] = args[3].to("meta")
    with pytest.raises(ValueError, match="device"):
        dp_kernels.affine_dp_scores_rows(*args, gaps, "local")
    with pytest.raises(ValueError, match="device"):
        dp_kernels.wsb_dp_scores_rows(*args, w, w, w, "local")


# ---------------------------------------------------------------------------
# the extras round
# ---------------------------------------------------------------------------


def _per_column_above(src, reqs):
    """The extras round one column at a time: ``torch.nonzero`` of the
    column, ``_mq_similarity`` and the flat-batch entry's plain version
    with the empty-slice mask a column; a column past ABOVE_CAP rows is read
    whole.  Returns (per request (ids, rmap), buckets with a selected row,
    columns read whole)."""
    ec = src.exact_ctx
    sel, raws = {}, {}
    buckets, whole = set(), 0
    for view, thresh, _ in reqs:
        qi = view.qi
        for bi, b in enumerate(src._buckets):
            if (b["full"] or float(b["bound"][qi]) < thresh
                    or (bi, qi) in src._col_cache or (bi, qi) in sel):
                continue
            db, scores = src._pending[bi]
            n = db["n"]
            idx = torch.nonzero(scores[:n, qi] >= float(np.float32(thresh))).flatten()
            if idx.numel() > min(src.ABOVE_CAP, n):
                src._column(bi, qi)
                whole += 1
                continue
            qvec = torch.full_like(idx, qi)
            S = search._mq_similarity(db["tokens"][idx], qvec, ec["table"], ec["V"])
            ln, lt = db["lengths"][idx], ec["lt_q"][qvec].to(torch.int32)
            if ec["general"] is None:
                raw = dp_kernels.affine_dp_scores_flat_reference(
                    S, ln, lt, ec["gaps"], ec["locality"])
            else:
                raw = dp_kernels.wsb_dp_scores_flat_reference(
                    S, ln, lt, *ec["general"].vecs(db["capacity"]), ec["locality"])
            sel[(bi, qi)] = idx.numpy()
            raws[(bi, qi)] = raw.masked_fill(ln <= 0, search.NEG_SCORE).numpy()
            if idx.numel():
                buckets.add(bi)
    out = []
    for view, thresh, excl in reqs:
        qi = view.qi
        seen, ids, rmap = set(excl), [], {}
        for bi, b in enumerate(src._buckets):
            hit_raws = None
            if not b["full"] and float(b["bound"][qi]) >= thresh:
                db = src._pending[bi][0]
                if (bi, qi) in sel:
                    hit = db["slice_index"][sel[(bi, qi)]]
                    hit_raws = raws[(bi, qi)]
                else:
                    col = src._column(bi, qi)
                    hit = db["slice_index"][np.flatnonzero(col >= thresh)]
            else:
                keep = b["vals"][qi] >= thresh
                hit, hit_raws = b["sids"][qi][keep], b["exact"][qi][keep]
            for p, c in enumerate(hit):
                c = int(c)
                if c not in seen:
                    seen.add(c)
                    ids.append(c)
                    if hit_raws is not None:
                        rmap[c] = float(hit_raws[p])
        out.append((ids, rmap))
    return out, len(buckets), whole


@pytest.fixture(scope="module")
def tie_session():
    """Two sentences repeated 700 and 600 times (6 and 14 tokens: the
    buckets of capacity 8 and 16) among random ones: the top scores tie far
    past the fused top-k's deep fetch, so every cut near them is unsafe and
    the extras round runs, over both buckets."""
    rng = np.random.default_rng(11)
    words = ["sun", "moon", "shines", "over", "the", "sea", "night", "stars"] + [
        "".join(chr(97 + int(c)) for c in rng.integers(0, 26, size=5))
        for _ in range(40)
    ]
    mat = rng.normal(size=(len(words), 16)).astype(np.float32)
    long_a = "the sun shines over the sea at night under the stars and the moon"
    sents = (["the sun shines over the sea."] * 700 + [long_a + "."] * 600 + [
        " ".join(rng.choice(words, size=int(rng.integers(2, 20)))) + "."
        for _ in range(300)
    ])
    rng.shuffle(sents)
    texts = [" ".join(sents[i : i + 100]) for i in range(0, len(sents), 100)]
    session = vt.Session(
        [vt.StringImporter()(t, title=f"d{i}") for i, t in enumerate(texts)],
        embeddings=[vt.KeyedVectors("toy", words, mat)],
        device="cpu",
    )
    queries = ["the sun shines over the sea", "sun shines", long_a,
               "the stars and the moon"] + [
        " ".join(rng.choice(words, size=4)) for _ in range(6)]
    return session, queries


def _extras_index(session, gap_model):
    emb = session.embeddings[0]
    if gap_model == "affine":
        return session.partition("sentence").index(EmbeddingTokenSim(emb))
    opt = (LocalAlignment(ExponentialGapCost(3.0)) if gap_model == "exponential"
           else SemiGlobalAlignment(MODELS["custom"]))
    return session.partition("sentence").index(OptimizedSpanSim(EmbeddingTokenSim(emb), opt))


@pytest.mark.parametrize("cap", [8192, 650])
@pytest.mark.parametrize("gap_model", ["affine", "exponential", "custom"])
def test_extras_round_one_launch_a_bucket(tie_session, gap_model, cap, monkeypatch):
    """The batched extras round returns byte-identical (ids, rmap) to the
    per-column loop, with one row-gather call a (round, bucket) that has a
    selected row; at ABOVE_CAP = 650 the 700-row tie columns are read whole
    (their ids then go through ``rescore_many``'s score-only pass), the
    600-row ones still selected, and find / find_batch return what they
    return at the default cap."""
    session, queries = tie_session
    index = _extras_index(session, gap_model)
    entry = "affine_dp_scores_rows" if gap_model == "affine" else "wsb_dp_scores_rows"
    real_entry = getattr(search, entry)
    calls = []
    monkeypatch.setattr(search, entry,
                        lambda *a, **k: calls.append(a[1].shape[0]) or real_entry(*a, **k))
    real_round = search.BucketTopKSource._above_exact_many
    rounds = []

    def checked(self, reqs):
        cache = dict(self._col_cache)
        want, buckets, whole = _per_column_above(self, reqs)
        self._col_cache = cache
        before = len(calls)
        got = real_round(self, reqs)
        rounds.append((len(calls) - before, buckets, whole))
        assert got == want
        return got

    monkeypatch.setattr(search.BucketTopKSource, "_above_exact_many", checked)
    monkeypatch.setattr(search.BucketTopKSource, "ABOVE_CAP", cap)
    n, min_score = 10, 0.1
    got_f = [[(m.slice_id, m.score) for m in index.find(q, n=n, min_score=min_score)]
             for q in queries[:4]]
    got_b = [[(m.slice_id, m.score) for m in r]
             for r in index.find_batch(queries, n=n, min_score=min_score)]
    assert got_b[:4] == got_f
    assert len(rounds) >= 5
    assert all(launches == buckets for launches, buckets, _ in rounds)
    assert max(buckets for _, buckets, _ in rounds) == (1 if cap == 650 else 2)
    assert any(whole for *_, whole in rounds) == (cap == 650)
    if cap == 650:
        monkeypatch.setattr(search.BucketTopKSource, "ABOVE_CAP", 8192)
        want_b = [[(m.slice_id, m.score) for m in r]
                  for r in index.find_batch(queries, n=n, min_score=min_score)]
        assert got_b == want_b
