"""The query options that ride the batch kernels — tag weights, the
document-side filters, boosters and ``bidirectional`` — in the port against
the JAX package, on the CPU.

The corpus's word vectors have entries k / 8 with sum k^2 = 64 (unit
length, dyadic), so every cosine is a multiple of 1/64 and the similarity
GEMM is exact in any summation order: the two packages gather the same
bits, and the port is held to BYTE equality end to end ((slice_id, score)
lists and ``Match.to_json``), not to a tolerance.  The kernels' plain
versions on the tag-weighted block are held bit for bit against the JAX
package's ``_apply_tag_weights`` followed by its Pallas kernels in
interpret mode.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import vectorian_tpu as vj
import vectorian_tpu_torch as vt
from vectorian_tpu.alignment import AffineGapCost as JaxAffine
from vectorian_tpu.alignment import ExponentialGapCost as JaxExponential
from vectorian_tpu.alignment import GlobalAlignment as JaxGlobal
from vectorian_tpu.alignment import LocalAlignment as JaxLocal
from vectorian_tpu.alignment import SemiGlobalAlignment as JaxSemiGlobal
from vectorian_tpu.metrics import EmbeddingTokenSim as JaxTokenSim
from vectorian_tpu.metrics import OptimizedSpanSim as JaxSpanSim
from vectorian_tpu.ops.alignment import AffineGapParams as JaxGaps
from vectorian_tpu.ops.alignment import align_scores as jax_align_scores
from vectorian_tpu.ops.alignment import align_scores_general as jax_asg
from vectorian_tpu.ops.pallas_dp import (
    pallas_align_scores_general,
    pallas_align_scores_multi_nt,
)
from vectorian_tpu.ops.search import _apply_tag_weights as jax_apply_tag_weights
from vectorian_tpu.ops.search import _compact_slices as jax_compact_slices
from vectorian_tpu.ops.search import _mq_similarity as jax_mq_similarity
from vectorian_tpu.ops.search import _stack_tw as jax_stack_tw
from vectorian_tpu.saliency import KeywordSignal as JaxKeywordSignal
from vectorian_tpu.saliency import Saliency as JaxSaliency
from vectorian_tpu_torch.alignment import (
    AffineGapCost,
    ExponentialGapCost,
    GlobalAlignment,
    LocalAlignment,
    SemiGlobalAlignment,
)
from vectorian_tpu_torch.metrics import EmbeddingTokenSim, OptimizedSpanSim
from vectorian_tpu_torch.ops import dp_kernels, search
from vectorian_tpu_torch.ops.alignment import AffineGapParams, gap_cost_closure

torch.set_num_threads(2)

# words the port's and the reference's SimpleNLP tag as DET, ADP, NOUN,
# VERB, ADV, ADJ and CCONJ, and random ones with those suffixes
BASE_WORDS = [
    "the", "a", "over", "in", "sun", "moon", "sea", "river", "stone",
    "shining", "walked", "quickly", "slowly", "golden", "famous",
    "beautiful", "and", "or",
]
SUFFIXES = ["", "ly", "ed", "ous", "ing", "ful"]
# a sentence of DET and ADP tokens only: pos_filter ["DET", "ADP"] empties it
EMPTIED = "The over the in a."


def _unit_dyadic(rng, dim=16):
    while True:
        v = rng.integers(-5, 6, dim)
        if int((v * v).sum()) == 64:
            return (v / 8).astype(np.float32)


def _corpus(seed=11):
    rng = np.random.default_rng(seed)
    words = list(BASE_WORDS) + [
        "".join(chr(97 + int(c)) for c in rng.integers(0, 26, 4)) + sfx
        for sfx in SUFFIXES for _ in range(7)
    ]
    mat = np.stack([_unit_dyadic(rng) for _ in words])
    p = 1.0 / np.arange(1, len(words) + 1) ** 0.9
    p /= p.sum()
    texts = []
    for d in range(4):
        sents = [
            " ".join(rng.choice(words, size=int(rng.integers(2, 12)), p=p)) + "."
            for _ in range(70)
        ]
        sents.insert(5 + d, EMPTIED)
        texts.append(" ".join(sents))
    queries = ["the golden sun shining over the sea"] + [
        " ".join(rng.choice(words, size=int(rng.integers(2, 9)), p=p))
        for _ in range(5)
    ]
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


LOCALITIES = {
    "local": (JaxLocal, LocalAlignment),
    "global": (JaxGlobal, GlobalAlignment),
    "semiglobal": (JaxSemiGlobal, SemiGlobalAlignment),
}
GAPS = {
    "affine": (lambda: JaxAffine(0.37, 0.113), lambda: AffineGapCost(0.37, 0.113)),
    "exponential": (lambda: JaxExponential(3.0), lambda: ExponentialGapCost(3.0)),
}
TAG_ARGS = dict(
    tag_weights={"NN": 0.8, "JJ": 0.4, "VB": 0.6, "RB": 1.3},
    pos_mismatch_penalty=0.25,
    similarity_threshold=0.1,
)


def _indexes(both, locality="local", gap="affine", tagged=False):
    sj, st, _ = both
    loc_j, loc_t = LOCALITIES[locality]
    gap_j, gap_t = GAPS[gap]
    extra = TAG_ARGS if tagged else {}
    ij = sj.partition("sentence").index(
        JaxSpanSim(JaxTokenSim(sj.embeddings[0]), loc_j(gap_j()), **extra)
    )
    it = st.partition("sentence").index(
        OptimizedSpanSim(EmbeddingTokenSim(st.embeddings[0]), loc_t(gap_t()), **extra)
    )
    return ij, it


def _pairs(result):
    return [(m.slice_id, m.score) for m in result]


def _assert_same_as_jax(ij, it, queries, n, min_score, kw_j, kw_t,
                        precision="float32"):
    """find: (slice_id, score) lists and to_json equal to the JAX
    package's; find_batch equal to JAX's f32 batch and to the port's own
    find, byte for byte.  Returns the port's find lists."""
    got_f = []
    for q in queries:
        want = ij.find(q, n=n, min_score=min_score, **kw_j)
        got = it.find(q, n=n, min_score=min_score, **kw_t)
        assert _pairs(got) == _pairs(want), q
        assert [m.to_json() for m in got] == [m.to_json() for m in want], q
        got_f.append(_pairs(got))
    want_b = ij.find_batch(queries, n=n, min_score=min_score,
                           sim_precision="float32", **kw_j)
    got_b = it.find_batch(queries, n=n, min_score=min_score,
                          sim_precision=precision, **kw_t)
    assert [_pairs(r) for r in got_b] == [_pairs(r) for r in want_b]
    assert [_pairs(r) for r in got_b] == got_f
    for rb, rf in zip(got_b, got_f):
        for m in rb:
            assert m.to_json()["regions"] is not None
    return got_f


@pytest.mark.parametrize("gap", sorted(GAPS))
@pytest.mark.parametrize("locality", sorted(LOCALITIES))
def test_tag_weights_match_jax(both, locality, gap):
    ij, it = _indexes(both, locality, gap, tagged=True)
    min_score = -10.0 if locality == "global" else 0.05
    got = _assert_same_as_jax(ij, it, both[2], 5, min_score, {}, {})
    assert sum(map(len, got)) > 0


FILTERS = {
    "pos": {"pos_filter": ["DET"]},
    "tag": {"tag_filter": ["JJ", "RB"]},
    "token": {"token_filter": ["sun", "the", "river"]},
    "all": {"pos_filter": ["DET", "ADP"], "tag_filter": ["RB"],
            "token_filter": ["golden"]},
}


@pytest.mark.parametrize("gap", sorted(GAPS))
@pytest.mark.parametrize("flt", sorted(FILTERS))
def test_doc_filters_match_jax(both, flt, gap):
    """Each filter alone and all three at once; under "all" (global
    alignment, every slice in play) the sentence of DET and ADP tokens
    is emptied: it scores NEG_SCORE and never surfaces."""
    locality = "global" if flt == "all" else "local"
    ij, it = _indexes(both, locality, gap)
    min_score = -10.0 if flt == "all" else 0.05
    kw = FILTERS[flt]
    got = _assert_same_as_jax(ij, it, both[2], 6, min_score, kw, kw)
    assert sum(map(len, got)) > 0
    pq = it.make_query(both[2][0], **kw).prepare(it._nlp)
    spec = it._doc_filter(pq)
    flt = spec.device_args(it._engine.device)
    views = [it._engine._pass_view(db, flt, False) for db in it._engine._live_buckets()]
    emptied = np.concatenate([
        v["slice_index"][(v["lengths"] == 0).numpy()] for v in views
    ])
    packed = it.packed
    if flt == "all":
        assert len(emptied) >= 4 and (packed.slice_len[emptied] > 0).all()
        assert not set(emptied) & {sid for r in got for sid, _ in r}
    # the host replica of the compaction agrees with the device's lengths
    for v in views:
        for r in range(0, v["n"], 7):
            sid = int(v["slice_index"][r])
            sel = it._engine.filtered_positions(sid, spec)
            assert len(sel) == int(v["lengths"][r])


@pytest.mark.parametrize("gap", sorted(GAPS))
@pytest.mark.parametrize("precision", ["int8", "bfloat16", "float32"])
def test_booster_matches_jax_at_every_precision(both, precision, gap):
    ij, it = _indexes(both, "local", gap)
    kw_j = {"booster": JaxSaliency(strength=0.7).add_signal(
        JaxKeywordSignal("sun", "river"), 1.0)}
    kw_t = {"booster": vt.Saliency(strength=0.7).add_signal(
        vt.KeywordSignal("sun", "river"), 1.0)}
    got = _assert_same_as_jax(ij, it, both[2], 5, 0.05, kw_j, kw_t, precision)
    assert sum(map(len, got)) > 0


@pytest.mark.parametrize("gap", sorted(GAPS))
@pytest.mark.parametrize("tagged", [False, True])
def test_bidirectional_matches_jax(both, tagged, gap):
    ij, it = _indexes(both, "local", gap, tagged=tagged)
    kw = {"bidirectional": True}
    got = _assert_same_as_jax(ij, it, both[2], 5, 0.05, kw, kw)
    assert sum(map(len, got)) > 0


def test_options_together_and_tags_force_f32(both, monkeypatch):
    """Tag weights, a filter, a booster and bidirectional at once; a
    tagged batch ranks with f32 whatever the precision asked for, and the
    corpus pass refuses a quantized table with tag weights."""
    ij, it = _indexes(both, "local", "affine", tagged=True)
    seen = []
    real = it._engine.score_topk_multi
    monkeypatch.setattr(
        it._engine, "score_topk_multi",
        lambda *a, **k: seen.append(k.get("sim_dtype")) or real(*a, **k),
    )
    kw_j = {"token_filter": ["the"], "bidirectional": True,
            "booster": JaxSaliency(0.5).add_signal(JaxKeywordSignal("sea"))}
    kw_t = {"token_filter": ["the"], "bidirectional": True,
            "booster": vt.Saliency(0.5).add_signal(vt.KeywordSignal("sea"))}
    _assert_same_as_jax(ij, it, both[2][:3], 4, 0.05, kw_j, kw_t, "int8")
    assert seen and set(seen) == {None}
    plans = [it._compile_plan(it.make_query(both[2][0]).prepare(it._nlp))]
    tw = it._tag_weighting(it.make_query(both[2][0]).prepare(it._nlp), 8)
    with pytest.raises(ValueError, match="tag_weights"):
        it._engine.score_topk_multi(
            plans, [3], it._gaps, "local", [1.0], 5, sim_dtype="int8",
            tag_weights=[tw],
        )


SIGNALS = {
    "keyword": lambda m: m.KeywordSignal("sun", "sea", "nowhere"),
    "keyword_count2": lambda m: m.KeywordSignal("the", "sun", max_count=2),
    # a ``same`` callable: the per-token string path
    "keyword_same": lambda m: m.KeywordSignal(
        "su", "ri", same=lambda x, y: x.startswith(y)),
    "smoothed_max": lambda m: m.KeywordSignal("river").smoothed(3, "max"),
    "smoothed_gauss": lambda m: m.KeywordSignal("stone").smoothed(5, "gauss"),
}


@pytest.mark.parametrize("strength", [0.0, 0.35, 1.0])
@pytest.mark.parametrize("signal", sorted(SIGNALS))
def test_saliency_compile_bit_equal(both, signal, strength):
    import vectorian_tpu.saliency as jsal
    import vectorian_tpu_torch.saliency as tsal

    sj, st, _ = both
    want = jsal.Saliency(strength).add_signal(SIGNALS[signal](jsal), 1.0).add_signal(
        jsal.KeywordSignal("moon"), 0.5
    ).compile(sj, sj.partition("sentence"))
    got = tsal.Saliency(strength).add_signal(SIGNALS[signal](tsal), 1.0).add_signal(
        tsal.KeywordSignal("moon"), 0.5
    ).compile(st, st.partition("sentence"))
    assert got.dtype == np.float32 and np.array_equal(got, want)
    assert np.array_equal(
        tsal.Saliency().compile(st, st.partition("sentence")),
        np.ones_like(want),
    )


def test_compact_slices_matches_jax():
    rng = np.random.default_rng(4)
    c, L, n_pos, n_tags, V = 40, 12, 17, 9, 30
    tok = rng.integers(0, V, (c, L)).astype(np.int32)
    pos = rng.integers(0, n_pos, (c, L)).astype(np.int8)
    tag = rng.integers(0, n_tags, (c, L)).astype(np.int16)
    ln = rng.integers(0, L + 1, c).astype(np.int32)
    masks = (rng.random(n_pos) < 0.3, rng.random(n_tags) < 0.3, rng.random(V) < 0.3)
    want = jax_compact_slices(*(jnp.asarray(x) for x in (tok, pos, tag, ln, *masks)))
    got = search.compact_slices(*(torch.from_numpy(np.asarray(x))
                                  for x in (tok, pos, tag, ln, *masks)))
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))


def _tag_inputs(seed, c, L, T, Q):
    rng = np.random.default_rng(seed)
    pos = rng.integers(0, 6, (c, L)).astype(np.int8)
    w = (rng.random((Q, T)) + 0.2).astype(np.float32)
    p = rng.integers(-1, 6, (Q, T)).astype(np.int8)
    pen = (rng.random(Q) * 0.5).astype(np.float32)
    thr = (rng.random(Q) * 0.3 - 0.1).astype(np.float32)
    return pos, w, p, pen, thr


def _jax_tagged_block(table, tok, tag_in):
    """The JAX corpus pass's gathered block [L, c, Tp, Q], each query's
    [c, L, Tp] slice rewritten by ``_apply_tag_weights``."""
    pos, w, p, pen, thr = tag_in
    S = table[tok]  # [c, L, Tp, Q]
    cols = [
        np.asarray(jax_apply_tag_weights(
            jnp.asarray(S[..., q]), jnp.asarray(pos), jnp.asarray(w[q]),
            jnp.asarray(p[q]), jnp.asarray(pen[q]), jnp.asarray(thr[q]),
        ))
        for q in range(S.shape[-1])
    ]
    return np.transpose(np.stack(cols, -1), (1, 0, 2, 3))


GAPSETS = [(0.0, 0.0, 0.0, 0.0), (0.37, 0.113, 0.29, 0.071)]


@pytest.mark.parametrize("Q", [1, 3])
@pytest.mark.parametrize("gapset", GAPSETS)
@pytest.mark.parametrize("locality", sorted(LOCALITIES))
def test_tagged_affine_plain_bit_equal_to_pallas(locality, gapset, Q):
    V, L, c, Tp = 37, 9, 20, 8
    rng = np.random.default_rng(Q)
    table = rng.uniform(-0.4, 1.0, size=(V, Tp, Q)).astype(np.float32)
    tok = rng.integers(0, V, size=(c, L)).astype(np.int32)
    len_s = rng.integers(0, L + 1, size=c).astype(np.int32)
    len_s[0], len_s[1] = 0, L
    len_t = rng.integers(1, Tp + 1, size=Q).astype(np.int32)
    len_t[0] = Tp
    tag_in = _tag_inputs(5 + Q, c, L, Tp, Q)
    tags = dp_kernels.TagBlock(*(torch.from_numpy(x) for x in tag_in))
    got = dp_kernels.affine_dp_scores(
        torch.from_numpy(table), torch.from_numpy(tok), torch.from_numpy(len_s),
        torch.from_numpy(len_t), AffineGapParams.of(*gapset), locality, tags=tags,
    ).numpy()
    S = _jax_tagged_block(table, tok, tag_in)
    want = np.asarray(pallas_align_scores_multi_nt(
        jnp.asarray(S), jnp.asarray(np.maximum(len_s, 1)), jnp.asarray(len_t),
        JaxGaps.of(*gapset), locality, interpret=True,
    ))
    assert np.abs(got - want).max() == 0.0
    untagged = dp_kernels.affine_dp_scores(
        torch.from_numpy(table), torch.from_numpy(tok), torch.from_numpy(len_s),
        torch.from_numpy(len_t), AffineGapParams.of(*gapset), locality,
    ).numpy()
    assert not np.array_equal(got, untagged)  # the rewrite changed scores


@pytest.mark.parametrize("locality", sorted(LOCALITIES))
def test_tagged_wsb_plain_bit_equal_to_pallas(locality):
    V, L, c, Tp, Q = 23, 7, 20, 8, 3
    rng = np.random.default_rng(17)
    table = rng.uniform(-0.4, 1.0, size=(V, Tp, Q)).astype(np.float32)
    tok = rng.integers(0, V, size=(c, L)).astype(np.int32)
    len_s = rng.integers(0, L + 1, size=c).astype(np.int32)
    len_t = np.asarray([Tp, 3, 1], np.int32)
    w_s = np.asarray(ExponentialGapCost(3.0).costs(L + 1), np.float32)
    w_t = np.asarray(ExponentialGapCost(3.0).costs(Tp + 1), np.float32)
    tag_in = _tag_inputs(3, c, L, Tp, Q)
    tags = dp_kernels.TagBlock(*(torch.from_numpy(x) for x in tag_in))
    vecs = (torch.from_numpy(w_s), torch.from_numpy(w_t),
            gap_cost_closure(torch.from_numpy(w_t)))
    got = dp_kernels.wsb_dp_scores(
        torch.from_numpy(table), torch.from_numpy(tok), torch.from_numpy(len_s),
        torch.from_numpy(len_t), *vecs, locality, host_costs=vecs, tags=tags,
    ).numpy()
    S = _jax_tagged_block(table, tok, tag_in)  # [L, c, Tp, Q]
    S2 = np.transpose(S, (1, 3, 0, 2)).reshape(c * Q, L, Tp)
    args = (jnp.asarray(S2), jnp.asarray(np.repeat(np.maximum(len_s, 1), Q)),
            jnp.asarray(np.tile(len_t, c)), jnp.asarray(w_s), jnp.asarray(w_t),
            locality)
    want = np.asarray(pallas_align_scores_general(*args, interpret=True))
    assert np.abs(got - want.reshape(c, Q)).max() == 0.0
    assert np.array_equal(got, np.asarray(jax_asg(*args)).reshape(c, Q))


@pytest.mark.parametrize("kernel", ["affine", "wsb"])
@pytest.mark.parametrize("locality", sorted(LOCALITIES))
def test_tagged_rows_plain_bit_equal_to_jax(locality, kernel):
    """The row-gather entries on tag-weighted slots: the JAX package's
    stacked rescore (``_stack_tw`` + ``_mq_similarity``, one slot
    untagged) and its scan, against the port's slot arrays
    (``stack_tag_slots``) through the entry's plain version."""
    rng = np.random.default_rng(23)
    n, L, T, slots, V, B = 30, 9, 8, 3, 19, 50
    tok = rng.integers(0, V, (n, L)).astype(np.int32)
    pos = rng.integers(0, 6, (n, L)).astype(np.int8)
    table = rng.uniform(-0.4, 1.0, (slots * V, T)).astype(np.float32)
    rows = rng.integers(0, n, B).astype(np.int32)
    qslot = rng.integers(0, slots, B).astype(np.int32)
    len_s = rng.integers(0, L + 1, B).astype(np.int32)
    len_t = rng.integers(1, T + 1, B).astype(np.int32)
    tws = [
        search.TagWeightingSpec(
            (rng.random(T) + 0.2).astype(np.float32),
            rng.integers(-1, 6, T).astype(np.int8), 0.3, 0.05,
        ),
        None,
        search.TagWeightingSpec(
            (rng.random(4) + 0.2).astype(np.float32),
            rng.integers(-1, 6, 4).astype(np.int8), 0.1, -0.2,
        ),
    ]
    S_j, _ = jax_mq_similarity(
        jnp.asarray(tok[rows]), jnp.asarray(pos[rows]), jnp.asarray(qslot),
        jnp.asarray(table), *jax_stack_tw(tws, slots, T), V, True,
    )
    ln1 = np.asarray(len_s)
    tw = tuple(torch.from_numpy(x) for x in search.stack_tag_slots(tws, slots, T))
    tags = dp_kernels.TagBlock(torch.from_numpy(pos), *tw)
    args = (torch.from_numpy(tok), torch.from_numpy(rows), torch.from_numpy(qslot),
            torch.from_numpy(table), V, torch.from_numpy(len_s),
            torch.from_numpy(len_t))
    if kernel == "affine":
        gapset = (0.37, 0.113, 0.29, 0.071)
        got = dp_kernels.affine_dp_scores_rows(
            *args, AffineGapParams.of(*gapset), locality, tags=tags).numpy()
        want = np.asarray(jax_align_scores(
            S_j, ln1, len_t, JaxGaps.of(*gapset), locality))
    else:
        w_s = np.asarray(ExponentialGapCost(3.0).costs(L + 1), np.float32)
        w_t = np.asarray(ExponentialGapCost(3.0).costs(T + 1), np.float32)
        vecs = (torch.from_numpy(w_s), torch.from_numpy(w_t),
                gap_cost_closure(torch.from_numpy(w_t)))
        got = dp_kernels.wsb_dp_scores_rows(
            *args, *vecs, locality, host_costs=vecs, tags=tags).numpy()
        want = np.asarray(jax_asg(S_j, ln1, len_t, jnp.asarray(w_s),
                                  jnp.asarray(w_t), locality))
    want = np.where(len_s > 0, want, np.float32(-1e30))
    assert np.abs(got - want).max() == 0.0
    # the fused rescore's torch rewrite reads the same rows, bit for bit
    S_t, Su_t = search._mq_blocks(
        torch.from_numpy(tok[rows]), torch.from_numpy(pos[rows]),
        torch.from_numpy(qslot), torch.from_numpy(table), V, tw,
    )
    assert np.array_equal(S_t.numpy(), np.asarray(S_j))
    assert np.array_equal(Su_t.numpy(), table[qslot[:, None] * V + tok[rows]])


def test_tag_block_checks():
    table = torch.zeros((5, 8, 2), dtype=torch.int8)
    tok = torch.zeros((3, 4), dtype=torch.int32)
    tags = dp_kernels.TagBlock(
        torch.zeros((3, 4), dtype=torch.int8), torch.ones((2, 8)),
        torch.zeros((2, 8), dtype=torch.int8), torch.zeros(2), torch.zeros(2),
    )
    ln = torch.ones(3, dtype=torch.int32)
    lt = torch.ones(2, dtype=torch.int32)
    gaps = AffineGapParams.of(0, 0, 0, 0)
    with pytest.raises(ValueError, match="f32 table"):
        dp_kernels.affine_dp_scores(table, tok, ln, lt, gaps, "local", tags=tags)
    bad = tags._replace(pos=torch.zeros((3, 5), dtype=torch.int8))
    with pytest.raises(ValueError, match="tags.pos"):
        dp_kernels.affine_dp_scores(table.float(), tok, ln, lt, gaps, "local",
                                    tags=bad)


@pytest.mark.parametrize("gap", sorted(GAPS))
def test_deferred_flows_match_fetched_payloads(both, gap, monkeypatch):
    """With no flow payload on the fused fetch, every match's flows come
    from the deferred rescore (``rescore_many`` with flows: the host
    compaction of a filtered slice, the tag-weighted rows, the mapping
    translated back): the same JSON as with payloads, and as the JAX
    package's, under tag weights and all three filters."""
    from vectorian_tpu_torch.ops.search import BucketTopKSource

    ij, it = _indexes(both, "local", gap, tagged=True)
    kw = {"token_filter": ["sun", "the"], "tag_filter": ["RB"], "pos_filter": ["ADP"]}
    queries = both[2]
    with_pay = [[m.to_json() for m in it.find(q, n=5, min_score=0.05, **kw)]
                for q in queries]
    monkeypatch.setattr(BucketTopKSource, "PAYLOAD_MAX_BYTES", 0)
    flows = []
    real = it._engine.rescore_many
    monkeypatch.setattr(it._engine, "rescore_many", lambda reqs, *a, **k: flows.extend(
        r["want_flows"] for r in reqs) or real(reqs, *a, **k))
    deferred = [[m.to_json() for m in it.find(q, n=5, min_score=0.05, **kw)]
                for q in queries]
    assert any(flows)  # the deferred rescore with flows ran
    batch = [[m.to_json() for m in r]
             for r in it.find_batch(queries, n=5, min_score=0.05, **kw)]
    want = [[m.to_json() for m in ij.find(q, n=5, min_score=0.05, **kw)]
            for q in queries]
    assert deferred == with_pay == want == batch
    assert sum(map(len, want)) > 0
