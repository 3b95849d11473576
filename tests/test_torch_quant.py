"""The port's quantized ranking tables (``find_batch(sim_precision=...)``)
against the JAX package.

Inputs come from a seeded numpy generator and go through both packages.
Quantizing and the scaled DP are f32 divisions, roundings and the same
max-plus DP, so the port is held to BIT equality on the same f32 plan
matrices: the int8 / bf16 table, its scale and entry error, and the
corpus pass's ranking scores (the plain versions of the kernel wrappers,
the CPU path) against the JAX package's jnp corpus pass.  End to end, every
precision returns byte-identical matches, equal to ``find()``, and the
same ranking as the JAX package's ``find_batch`` at that precision (scores
within 1e-6 relative: the similarity GEMM sums in another order).
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import vectorian_tpu as vj
import vectorian_tpu_torch as vt
from tests.test_torch_slice import (
    _assert_same_ranking,
    _corpus,
    _general_indexes,
    _indexes,
    _pairs,
)
from vectorian_tpu.ops.alignment import AffineGapParams as JaxGaps
from vectorian_tpu.ops.search import _bucket_scores_multiquery as jax_bucket_scores
from vectorian_tpu.ops.search import gap_vec as jax_gap_vec
from vectorian_tpu.ops.search import quantization_entry_err as jax_entry_err
from vectorian_tpu.ops.search import stack_query_tables as jax_stack
from vectorian_tpu_torch.alignment import CustomGapCost, ExponentialGapCost
from vectorian_tpu_torch.ops import search
from vectorian_tpu_torch.ops.alignment import AffineGapParams
from vectorian_tpu_torch.ops.search import (
    BruteForceEngine,
    quantization_entry_err,
    stack_query_tables,
)

torch.set_num_threads(2)

LOCALITIES = ["local", "global", "semiglobal"]
PRECISIONS = ["int8", "bfloat16"]
AFFINE = (0.37, 0.113, 0.29, 0.071)  # no short binary form: exercises rounding
# not subadditive: its min-plus closure tightens entries, so the closure
# of the scaled vector is not the scaled closure bit for bit
_JUMPS = np.cumsum(np.random.default_rng(9).uniform(0, 0.3, size=64)).astype(np.float32)
_JUMPS[0] = 0.0
_JUMPS[3::4] += 1.0
GAP_MODELS = {
    "affine": None,
    "exponential": ExponentialGapCost(3.0),
    "custom": CustomGapCost(lambda k: 0.1 * k ** 0.5),
    "jumps": CustomGapCost(lambda k: float(_JUMPS[int(k)])),
}


def _plans(mats):
    """The same [V, T] f32 plan matrices as the port's plans (``matrix``)
    and as the JAX package's static plans (``static_sims``)."""
    port = [SimpleNamespace(matrix=torch.from_numpy(m)) for m in mats]
    jax = [
        SimpleNamespace(is_static_only=True, plan=("static", 0),
                        static_sims=[jnp.asarray(m)])
        for m in mats
    ]
    return port, jax


def _random_mats(seed, V=37, widths=(7, 3, 12, 1, 9)):
    rng = np.random.default_rng(seed)
    return [rng.uniform(-0.4, 1.0, size=(V, t)).astype(np.float32) for t in widths]


def _tie_mats():
    """Entries at exact halves of the int8 unit: max|sim| = 127 * 2^-7, so
    sim_scale = 2^-7 and (k + 0.5) * 2^-7 rounds half to even."""
    k = np.arange(-127, 127, dtype=np.float32)
    m = ((k + 0.5) * np.float32(2.0 ** -7)).reshape(-1, 2).astype(np.float32)
    m[0, 0] = np.float32(127 * 2.0 ** -7)
    return [m, -m[:, :1].copy()]


def _bits(x):
    """A table's raw bits: int8 as it is, bf16 as uint16."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16)
        return x.numpy()
    x = np.asarray(x)
    return x.view(np.uint16) if x.dtype.itemsize == 2 else x


@pytest.mark.parametrize("mats", ["random", "ties"])
@pytest.mark.parametrize("precision", PRECISIONS)
def test_stack_query_tables_match_jax(precision, mats):
    """Exact: the quantized [V, Tpad, Q] table, sim_scale (f32) and the
    entry error are the JAX package's, bit for bit."""
    mats = _random_mats(1) if mats == "random" else _tie_mats()
    port_plans, jax_plans = _plans(mats)
    len_ts = [m.shape[1] for m in mats]
    table, scale, max_abs, Tpad = stack_query_tables(port_plans, len_ts, precision)
    want, want_scale, want_max, want_Tpad = jax_stack(jax_plans, len_ts, precision)
    assert Tpad == want_Tpad
    assert table.dtype == search.SIM_DTYPES[precision]
    assert np.array_equal(_bits(table), _bits(want))
    assert scale.dtype == np.float32
    assert scale == np.float32(want_scale)
    assert max_abs == float(want_max)
    assert quantization_entry_err(precision, max_abs) == jax_entry_err(precision, want_max)
    # f32: the stack itself, no scale, no rounding
    table32, scale32, none, _ = stack_query_tables(port_plans, len_ts)
    assert scale32 == 1.0 and none is None and quantization_entry_err(None, none) == 0.0
    assert np.array_equal(table32.numpy(), np.asarray(jax_stack(jax_plans, len_ts)[0]))
    with pytest.raises(ValueError):
        stack_query_tables(port_plans, len_ts, "float16")


def _engine(tokens, lengths):
    """A BruteForceEngine on the CPU over one bucket of ``tokens``."""
    n, L = tokens.shape
    bucket = SimpleNamespace(capacity=L, slice_index=np.arange(n), n=n,
                             token_ids=tokens, lengths=lengths)
    return BruteForceEngine(SimpleNamespace(n_slices=n, buckets=[bucket]), device="cpu")


@pytest.mark.parametrize("gap_model", sorted(GAP_MODELS))
@pytest.mark.parametrize("locality", LOCALITIES)
@pytest.mark.parametrize("precision", PRECISIONS)
def test_corpus_pass_on_quantized_tables_matches_jax(precision, locality, gap_model):
    """Exact: the port's corpus pass on an int8 / bf16 table (the scaled
    gap costs, the plain versions of affine_dp_scores / wsb_dp_scores, the
    raw scores times sim_scale, the normalization) returns the JAX
    package's jnp corpus pass's ranking scores bit for bit, and its entry
    error."""
    _check_corpus_pass(precision, locality, gap_model, _random_mats(2))


# needles padded to 32 and 64 columns: the widths where kernel 1's packed
# quantized rows take its T1P = 33 and 65 templates (16 above)
WIDE_NEEDLES = {32: (29, 3, 17, 1, 25), 64: (57, 3, 40, 1, 64)}


@pytest.mark.parametrize("gap_model", ["affine", "exponential"])
@pytest.mark.parametrize("locality", ["local", "semiglobal"])
@pytest.mark.parametrize("precision", PRECISIONS)
@pytest.mark.parametrize("Tpad", sorted(WIDE_NEEDLES))
def test_corpus_pass_on_wide_quantized_tables_matches_jax(Tpad, precision, locality,
                                                          gap_model):
    """Exact, as above, at needles padded to 32 and 64 columns."""
    _check_corpus_pass(precision, locality, gap_model,
                       _random_mats(Tpad, widths=WIDE_NEEDLES[Tpad]), Tpad)


def _check_corpus_pass(precision, locality, gap_model, mats, want_Tpad=16):
    port_plans, jax_plans = _plans(mats)
    len_ts = [m.shape[1] for m in mats]
    Q, V = len(mats), mats[0].shape[0]
    rng = np.random.default_rng(3)
    n, L = 24, 11
    tokens = rng.integers(0, V, size=(n, L)).astype(np.int32)
    lengths = rng.integers(0, L + 1, size=n).astype(np.int32)
    lengths[:3] = (0, 1, L)
    norm_totals = [float(t) for t in len_ts]
    cost = GAP_MODELS[gap_model]
    gap_costs = None if cost is None else (cost, cost)
    gapset = AFFINE if cost is None else (0.0, 0.0, 0.0, 0.0)

    pending, entry_err = _engine(tokens, lengths)._dispatch_multi(
        port_plans, len_ts, AffineGapParams.of(*gapset), locality, norm_totals,
        gap_costs, precision,
    )
    (_, got), = pending

    sim_multi, sim_scale, max_abs, Tpad = jax_stack(jax_plans, len_ts, precision)
    assert Tpad == want_Tpad
    zeros = np.zeros((n, L), np.int32)
    want = jax_bucket_scores(
        jnp.asarray(tokens), jnp.asarray(zeros.astype(np.int8)),
        jnp.asarray(zeros.astype(np.int16)), jnp.asarray(lengths), sim_multi,
        jnp.asarray(len_ts, jnp.int32), JaxGaps.of(*gapset),
        jnp.asarray(norm_totals, jnp.float32), jnp.ones((n, 1), jnp.float32),
        jnp.ones((Tpad, Q), jnp.float32), jnp.full((Tpad, Q), -1, jnp.int8),
        jnp.zeros((Q,), jnp.float32), jnp.full((Q,), -1.0, jnp.float32),
        *(jnp.zeros((1,), bool),) * 3,
        jnp.asarray(jax_gap_vec(cost, L + 1)), jnp.asarray(jax_gap_vec(cost, Tpad + 1)),
        locality=locality, chunk=n, n_queries=Q, use_pallas=False,
        general_gaps=cost is not None, sim_scale=sim_scale,
    )
    assert got.dtype == torch.float32 and tuple(got.shape) == (n, Q)
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert entry_err == jax_entry_err(precision, max_abs) > 0.0


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


@pytest.mark.parametrize("kind", ["affine_local", "exponential_global", "custom_semiglobal"])
def test_find_batch_precisions_byte_identical_and_match_jax(both, kind, monkeypatch):
    """Exact inside the port: find_batch at None (int8), "int8",
    "bfloat16" and "float32" returns byte-identical (slice_id, score)
    lists, equal to find(); against the JAX package's int8 and bf16
    find_batch, the same ranking with scores within 1e-6 relative."""
    sj, st, queries = both
    monkeypatch.delenv("VECTORIAN_SIM_PRECISION", raising=False)
    gap_model, locality = kind.split("_")
    if gap_model == "affine":
        ij, it = _indexes(sj, st, locality)
    else:
        ij, it = _general_indexes(sj, st, locality, gap_model)
    n = 5
    min_score = -10.0 if locality == "global" else 0.1
    want_f = [_pairs(it.find(q, n=n, min_score=min_score)) for q in queries]
    assert all(want_f)
    for precision in (None, "int8", "bfloat16", "float32"):
        got = [_pairs(r) for r in
               it.find_batch(queries, n=n, min_score=min_score, sim_precision=precision)]
        assert got == want_f, precision
        if precision in PRECISIONS:  # float32: tests/test_torch_slice.py
            jax_b = ij.find_batch(queries, n=n, min_score=min_score,
                                  sim_precision=precision)
            for w, g in zip(jax_b, got):
                _assert_same_ranking(_pairs(w), g, min_score)


@pytest.fixture(scope="module")
def duplicates():
    """The duplicates corpus of test_torch_slice.py: one sentence repeated
    600 times, so every query's cut near it is unsafe and the extras round
    runs."""
    words, mat, _, _ = _corpus()
    rng = np.random.default_rng(5)
    sents = ["the sun shines over the sea."] * 600 + [
        " ".join(rng.choice(words, size=int(rng.integers(2, 9)))) + "."
        for _ in range(200)
    ]
    rng.shuffle(sents)
    texts = [" ".join(sents[i : i + 100]) for i in range(0, len(sents), 100)]
    sj = vj.Session(
        [vj.StringImporter()(t, title=f"d{i}") for i, t in enumerate(texts)],
        embeddings=[vj.KeyedVectors("toy", words, mat)],
    )
    st = vt.Session(
        [vt.StringImporter()(t, title=f"d{i}") for i, t in enumerate(texts)],
        embeddings=[vt.KeyedVectors("toy", words, mat)],
        device="cpu",
    )
    queries = ["the sun shines over the sea", "sun shines", "the sea"] + [
        " ".join(rng.choice(words, size=4)) for _ in range(9)
    ]
    return sj, st, queries


@pytest.mark.parametrize("gap_model", ["affine", "exponential"])
def test_int8_extras_round_matches_f32_and_jax(duplicates, gap_model, monkeypatch):
    """Exact inside the port: at int8 the finalizer's slack (2 x the entry
    error) is nonzero, the extras round runs the row-gather entry on the
    f32 plan table, and the matches are byte-identical to float32 and to
    find(); the JAX package's int8 find_batch ranks the same (1e-6
    relative)."""
    sj, st, queries = duplicates
    if gap_model == "affine":
        ij, it = _indexes(sj, st, "local")
        entry = "affine_dp_scores_rows"
    else:
        ij, it = _general_indexes(sj, st, "local", gap_model)
        entry = "wsb_dp_scores_rows"
    errs, calls = [], []
    real_score = search.BruteForceEngine.score_topk_multi
    real_entry = getattr(search, entry)

    def score(self, *a, **k):
        out = real_score(self, *a, **k)
        if k.get("with_err"):
            errs.append(out[1])
        return out

    monkeypatch.setattr(search.BruteForceEngine, "score_topk_multi", score)
    monkeypatch.setattr(search, entry,
                        lambda *a, **k: calls.append(a[3].dtype) or real_entry(*a, **k))
    n, min_score = 10, 0.1
    got = [_pairs(r) for r in
           it.find_batch(queries, n=n, min_score=min_score, sim_precision="int8")]
    assert len(errs) == 1 and errs[0] > 0.0
    assert calls and set(calls) == {torch.float32}
    assert got == [_pairs(r) for r in
                   it.find_batch(queries, n=n, min_score=min_score, sim_precision="float32")]
    assert got[:3] == [_pairs(it.find(q, n=n, min_score=min_score)) for q in queries[:3]]
    assert len(got[0]) == n and len({s for _, s in got[0]}) == 1
    jax_b = ij.find_batch(queries, n=n, min_score=min_score, sim_precision="int8")
    for w, g in zip(jax_b, got):
        _assert_same_ranking(_pairs(w), g, min_score)


def test_sim_precision_resolution(both, monkeypatch):
    """As in the JAX package: None -> $VECTORIAN_SIM_PRECISION, else
    "int8"; an explicit argument wins; anything else raises ValueError."""
    sj, st, queries = both
    ij, it = _indexes(sj, st, "local")
    seen = []
    real = search.stack_query_tables
    monkeypatch.setattr(
        search, "stack_query_tables",
        lambda plans, len_ts, sim_dtype=None: seen.append(sim_dtype)
        or real(plans, len_ts, sim_dtype),
    )
    qs = queries[:2]
    monkeypatch.delenv("VECTORIAN_SIM_PRECISION", raising=False)
    it.find_batch(qs, n=3)
    monkeypatch.setenv("VECTORIAN_SIM_PRECISION", "bfloat16")
    it.find_batch(qs, n=3)
    it.find_batch(qs, n=3, sim_precision="float32")
    it.find(qs[0], n=3)  # find() ranks with f32 tables
    assert seen == ["int8", "bfloat16", None, None]
    for bad in ("float16", "fp8"):
        with pytest.raises(ValueError, match="sim_precision"):
            it.find_batch(qs, n=3, sim_precision=bad)
        with pytest.raises(ValueError, match="sim_precision"):
            ij.find_batch(qs, n=3, sim_precision=bad)
    monkeypatch.setenv("VECTORIAN_SIM_PRECISION", "int4")
    with pytest.raises(ValueError, match="sim_precision"):
        it.find_batch(qs, n=3)
    with pytest.raises(ValueError, match="sim_precision"):
        ij.find_batch(qs, n=3)
