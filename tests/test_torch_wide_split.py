"""The per-needle split of the affine gather entry (ops/dp_kernels.py
``needle_split``, ``affine_table``): past the register route's width, a
launch's short needles take the register route over their own columns of the
table and only the long ones a wide route; a corpus pass makes the split
once and its buckets share it.  On the CPU each group goes to the plain
version, so these tests reach the split's bookkeeping: the route plan for
mixes of needle widths, the groups' tables, and the assembled output,
bit-equal to the unsplit plain version and to the JAX package's Pallas
kernel (interpret mode) — f32, bf16, int8 tables, with and without tags, 3
localities x 2 gap sets.  The rows and dense entries are not split (one
wide_regs launch past the register width): the same bit-equality for their
one launch.  Then ``find_batch`` of a 129-token query among short ones
against the JAX package.  The card holds each route against the same plain
version (chip_smoke.py phase 3 and the long-query phase).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import vectorian_tpu as vj
import vectorian_tpu_torch as vt
from vectorian_tpu.alignment import AffineGapCost as JaxAffine
from vectorian_tpu.alignment import GlobalAlignment as JaxGlobal
from vectorian_tpu.alignment import LocalAlignment as JaxLocal
from vectorian_tpu.metrics import EmbeddingTokenSim as JaxTokenSim
from vectorian_tpu.metrics import OptimizedSpanSim as JaxSpanSim
from vectorian_tpu.ops.alignment import AffineGapParams as JaxGaps
from vectorian_tpu.ops.pallas_dp import pallas_align_scores, pallas_align_scores_multi_nt
from vectorian_tpu_torch.alignment import AffineGapCost, GlobalAlignment, LocalAlignment
from vectorian_tpu_torch.metrics import EmbeddingTokenSim, OptimizedSpanSim
from vectorian_tpu_torch.ops import dp_kernels, search
from vectorian_tpu_torch.ops.alignment import NEG, AffineGapParams

from tests.test_torch_wide import _same_ranking

torch.set_num_threads(2)

LOCALITIES = ["local", "global", "semiglobal"]
GAPSETS = [(0.0, 0.0, 0.0, 0.0), (0.37, 0.113, 0.29, 0.071)]
# a batch padded to its 136-token needle: short needles (<= 64), the
# boundaries 64 / 65 / 128 / 129, and the longest
MIX = [7, 64, 65, 3, 128, 1, 129, 136, 40]
TPAD = 136


# ---- the route plan ---------------------------------------------------------


@pytest.mark.parametrize("lens,Tpad,want", [
    ([3, 7, 8], 8, None),                                 # all short, in the register route
    ([7, 7, 64], 72, ([0, 1, 2], 64, [])),                # all short, padded past it
    ([65, 129, 160], 160, None),                          # all long
    ([64, 65, 128, 129], 136, ([0], 64, [1, 2, 3])),      # the boundaries
    ([0, 7, 150], 152, ([0, 1], 8, [2])),                 # an empty needle
    ([160], 160, None),                                   # Q = 1, long
    ([50], 72, ([0], 56, [])),                            # Q = 1, short, padded past
    ([9, 140, 2], 144, ([0, 2], 16, [1])),                # short width rounded to 8
])
def test_needle_split(lens, Tpad, want):
    split = dp_kernels.needle_split(lens, Tpad)
    if want is None:
        assert split is None
    else:
        assert tuple(split) == want
        assert split.short_T % 8 == 0 and split.short_T <= dp_kernels.AFFINE_REG_MAX_T
        assert all(lens[q] <= split.short_T for q in split.short)


def test_needle_split_dense_threshold():
    """The dense entry's register route ends at 32 columns (Q > 1); past
    it one wide_regs launch takes the whole block, however short its
    needles (the dense entry does not split)."""
    reg = dp_kernels.AFFINE_DENSE_REG_MAX_T
    for Tpad, route in ((32, "registers"), (33, "wide_regs"), (64, "wide_regs"),
                        (512, "wide_regs"), (513, "wide_shared")):
        assert dp_kernels.affine_launch_plan(7 * 4, Tpad, reg_max_t=reg).route == route


@pytest.mark.parametrize("Tpad,route,cpl", [
    (64, "registers", 0), (65, "wide_regs", 4), (128, "wide_regs", 4),
    (129, "wide_regs", 8), (160, "wide_regs", 8), (256, "wide_regs", 8),
    (257, "wide_regs", 16), (512, "wide_regs", 16), (513, "wide_shared", 0),
])
def test_wide_regs_columns_a_lane(Tpad, route, cpl):
    """A lane holds the least of 4, 8, 16 columns that covers the needle;
    past 32 x 16 the shared-memory rows take over."""
    for rows in (False, True):
        plan = dp_kernels.affine_launch_plan(1 << 20, Tpad, rows=rows)
        assert plan.route == ("rows_" if rows else "") + route
    if cpl:
        assert dp_kernels.affine_wide_cpl(Tpad) == cpl


def _record_launches(monkeypatch, name):
    """Each launch of ``name`` (the gather entry's one-launch helper, or a
    plain version taking (S, len_s, len_t, ...)): (table shape, len_t) in
    order, the launch still run."""
    seen = []
    real = getattr(dp_kernels, name)

    def rec(first, *args, **kw):
        if name == "_affine_gather_launch":
            seen.append((tuple(first.table.shape), first.len_t.tolist()))
        else:
            seen.append((tuple(first.shape), args[1].tolist()))
        return real(first, *args, **kw)

    monkeypatch.setattr(dp_kernels, name, rec)
    return seen


def test_gather_groups_take_their_routes(monkeypatch):
    """The mixed batch: one launch of the short needles over their first
    64 columns (the register route at that width), one of the long ones
    over the whole width (the wide_regs route)."""
    table, tokens, len_s, len_t = _gather_inputs(np.random.default_rng(1), torch.float32)
    seen = _record_launches(monkeypatch, "_affine_gather_launch")
    dp_kernels.affine_dp_scores(table, tokens, len_s, len_t, AffineGapParams.of(*GAPSETS[1]),
                                "local")
    short = [lt for lt in MIX if lt <= 64]
    long = [lt for lt in MIX if lt > 64]
    V = table.shape[0]
    assert seen == [((V, 64, len(short)), short), ((V, TPAD, len(long)), long)]
    prepared = dp_kernels.affine_table(table, len_t)
    assert [g.route for g in prepared.groups] == ["registers", "wide_regs"]
    assert [g.qi.tolist() for g in prepared.groups] == [
        [q for q, lt in enumerate(MIX) if lt <= 64], [q for q, lt in enumerate(MIX) if lt > 64]]
    # a forced route is one launch of the whole table
    seen.clear()
    dp_kernels.affine_dp_scores(table, tokens, len_s, len_t, AffineGapParams.of(*GAPSETS[1]),
                                "local", _route="wide_regs")
    assert seen == [((V, TPAD, len(MIX)), MIX)]


def test_prepared_table_is_read_as_the_table():
    """A pass's ``AffineTable`` gives the bits of the table itself, is
    read only with the len_t it was made from, and forces no route."""
    table, tokens, len_s, len_t = _gather_inputs(np.random.default_rng(3), torch.float32)
    gaps = AffineGapParams.of(*GAPSETS[1])
    prepared = dp_kernels.affine_table(table, len_t, MIX)
    got = dp_kernels.affine_dp_scores(prepared, tokens, len_s, len_t, gaps, "semiglobal")
    assert torch.equal(got, dp_kernels.affine_dp_scores(table, tokens, len_s, len_t, gaps,
                                                        "semiglobal"))
    with pytest.raises(ValueError):
        dp_kernels.affine_dp_scores(prepared, tokens, len_s, len_t.clone(), gaps, "local")
    with pytest.raises(ValueError):
        dp_kernels.affine_dp_scores(prepared, tokens, len_s, len_t, gaps, "local",
                                    _route="wide_regs")
    # an empty bucket reads the prepared table too
    assert dp_kernels.affine_dp_scores(prepared, tokens[:0], len_s[:0], len_t, gaps,
                                       "local").shape == (0, len(MIX))


# ---- bit equality ------------------------------------------------------------


def _gather_inputs(rng, dtype, V=23, L=6, c=9):
    """A [V, TPAD, Q] table of ``dtype`` (bf16 rounded, int8 integers), the
    tokens of c slices and their lengths (0 and L among them), MIX."""
    table = rng.uniform(-0.4, 1.0, size=(V, TPAD, len(MIX))).astype(np.float32)
    if dtype == torch.int8:
        t = torch.from_numpy(np.round(table * 120.0).astype(np.int8))
    else:
        t = torch.from_numpy(table).to(dtype)
    tok = rng.integers(0, V, size=(c, L)).astype(np.int32)
    len_s = rng.integers(0, L + 1, size=c).astype(np.int32)
    len_s[:2] = (0, L)
    return t, torch.from_numpy(tok), torch.from_numpy(len_s), torch.tensor(MIX, dtype=torch.int32)


def _tags(rng, n, L, Q, T):
    return dp_kernels.TagBlock(
        torch.from_numpy(rng.integers(0, 4, size=(n, L)).astype(np.int8)),
        torch.from_numpy(rng.uniform(0.3, 1.0, size=(Q, T)).astype(np.float32)),
        torch.from_numpy(rng.integers(0, 4, size=(Q, T)).astype(np.int8)),
        torch.from_numpy(rng.uniform(0.0, 0.5, size=Q).astype(np.float32)),
        torch.from_numpy(rng.uniform(-0.2, 0.2, size=Q).astype(np.float32)),
    )


@pytest.mark.parametrize("locality", LOCALITIES)
@pytest.mark.parametrize("variant", ["f32", "bf16", "int8", "tagged"])
def test_gather_split_bit_equal(variant, locality):
    """The split gather entry = the unsplit plain version = the Pallas
    kernel on the gathered (tag-weighted) block, bit for bit."""
    dtype = {"bf16": torch.bfloat16, "int8": torch.int8}.get(variant, torch.float32)
    rng = np.random.default_rng(len(variant))
    table, tokens, len_s, len_t = _gather_inputs(rng, dtype)
    n, L = tokens.shape
    tags = _tags(rng, n, L, len(MIX), TPAD) if variant == "tagged" else None
    S = dp_kernels._gathered_block(table, tokens.long(), tags, 0)  # [n * Q, L, Tpad]
    S = S.reshape(n, len(MIX), L, TPAD).permute(2, 0, 3, 1).numpy()  # [L, n, Tpad, Q]
    ln1 = np.maximum(len_s.numpy(), 1)
    for gs in GAPSETS:
        gaps = AffineGapParams.of(*gs)
        got = dp_kernels.affine_dp_scores(table, tokens, len_s, len_t, gaps, locality, tags=tags,
                                          len_t_host=MIX)
        unsplit = dp_kernels.affine_dp_scores_reference(table, tokens, len_s, len_t, gaps,
                                                        locality, tags=tags)
        want = np.asarray(pallas_align_scores_multi_nt(
            jnp.asarray(S), jnp.asarray(ln1), jnp.asarray(len_t.numpy()), JaxGaps.of(*gs),
            locality, interpret=True))
        assert got.shape == (n, len(MIX))
        assert torch.equal(got, unsplit), gs
        assert np.array_equal(got.numpy(), want), gs


def _rows_inputs(rng, L=6, B=60, n=11, V=17):
    """A stacked [slots * V, TPAD] table whose slots hold MIX's needles;
    problem b's len_t is its slot's (the rescore's rule)."""
    slots = len(MIX)
    table = rng.uniform(-0.4, 1.0, size=(slots * V, TPAD)).astype(np.float32)
    tokens = rng.integers(0, V, size=(n, L)).astype(np.int32)
    rows = rng.integers(0, n, size=B).astype(np.int32)
    qslot = (np.arange(B) % slots).astype(np.int32)
    len_s = rng.integers(0, L + 1, size=B).astype(np.int32)
    len_s[:3] = (0, 1, L)
    len_t = np.asarray(MIX, np.int32)[qslot]
    return tuple(torch.from_numpy(x) for x in (table, tokens, rows, qslot, len_s, len_t)) + (V,)


@pytest.mark.parametrize("locality", LOCALITIES)
@pytest.mark.parametrize("tagged", [False, True])
def test_rows_split_bit_equal(tagged, locality, monkeypatch):
    """The rows entry past 64 columns is one launch over the whole table
    (wide_regs on the card, not split by needle), = its plain version =
    the Pallas kernel on the gathered block, masked where len_s <= 0."""
    rng = np.random.default_rng(7 + tagged)
    table, tokens, rows, qslot, len_s, len_t, V = _rows_inputs(rng)
    tags = _tags(rng, tokens.shape[0], tokens.shape[1], len(MIX), TPAD) if tagged else None
    S = dp_kernels._gather_rows(tokens, rows, qslot, table, V, tags).numpy()
    seen = []
    real = dp_kernels.affine_dp_scores_rows_reference
    monkeypatch.setattr(dp_kernels, "affine_dp_scores_rows_reference",
                        lambda *a, **kw: seen.append((a[3].shape[1], a[6].tolist()))
                        or real(*a, **kw))
    for gs in GAPSETS:
        seen.clear()
        args = (tokens, rows, qslot, table, V, len_s, len_t, AffineGapParams.of(*gs), locality)
        got = dp_kernels.affine_dp_scores_rows(*args, tags=tags)
        assert seen == [(TPAD, len_t.tolist())]
        assert dp_kernels.affine_launch_plan(len(seen), TPAD, rows=True).route == "rows_wide_regs"
        unsplit = real(*args, tags=tags)
        want = pallas_align_scores(S, len_s.numpy(), len_t.numpy(), JaxGaps.of(*gs), locality,
                                   interpret=True)
        assert torch.equal(got, unsplit), gs
        assert np.array_equal(got.numpy(), np.where(len_s.numpy() > 0, np.asarray(want), NEG))


@pytest.mark.parametrize("locality", LOCALITIES)
def test_dense_split_bit_equal(locality, monkeypatch):
    """The dense entry past 32 columns at Q > 1, short needles among long
    ones: one launch over the block in place (wide_regs on the card, not
    split by needle) = its plain version = the Pallas kernel on the
    block."""
    rng = np.random.default_rng(5)
    c, L = 7, 5
    lens = [33, 7, 64, 32, 100, 1]
    Tpad = 104
    S = torch.from_numpy(rng.uniform(-0.4, 1.0, size=(c, L, Tpad, len(lens))).astype(np.float32))
    len_s = torch.from_numpy(rng.integers(0, L + 1, size=c).astype(np.int32))
    len_t = torch.tensor(lens, dtype=torch.int32)
    seen = _record_launches(monkeypatch, "affine_dp_scores_dense_reference")
    ln1 = np.maximum(len_s.numpy(), 1)
    for gs in GAPSETS:
        seen.clear()
        gaps = AffineGapParams.of(*gs)
        got = dp_kernels.affine_dp_scores_dense(S, len_s, len_t, gaps, locality)
        assert seen == [((c, L, Tpad, len(lens)), lens)]
        assert dp_kernels.affine_launch_plan(
            c * len(lens), Tpad, reg_max_t=dp_kernels.AFFINE_DENSE_REG_MAX_T).route == "wide_regs"
        unsplit = dp_kernels.affine_dp_scores_dense_reference(S, len_s, len_t, gaps, locality)
        want = pallas_align_scores_multi_nt(
            jnp.asarray(S.permute(1, 0, 2, 3).numpy()), jnp.asarray(ln1), jnp.asarray(lens),
            JaxGaps.of(*gs), locality, interpret=True)
        assert torch.equal(got, unsplit), gs
        assert np.array_equal(got.numpy(), np.asarray(want)), gs


# ---- find_batch ----------------------------------------------------------------


def _corpus():
    rng = np.random.default_rng(23)
    words = ["w" + "".join(chr(97 + int(c)) for c in rng.integers(0, 26, size=4))
             for _ in range(30)]
    mat = rng.normal(size=(len(words), 16)).astype(np.float32)
    texts = [" ".join(" ".join(rng.choice(words, size=int(rng.integers(3, 12)))) + "."
                      for _ in range(30)) for _ in range(3)]
    queries = [" ".join(rng.choice(words, size=k)) for k in (6, 129, 3, 9, 7)]
    return words, mat, texts, queries


@pytest.fixture(scope="module")
def both():
    words, mat, texts, queries = _corpus()
    sj = vj.Session([vj.StringImporter()(t, title=f"d{i}") for i, t in enumerate(texts)],
                    embeddings=[vj.KeyedVectors("toy", words, mat)])
    st = vt.Session([vt.StringImporter()(t, title=f"d{i}") for i, t in enumerate(texts)],
                    embeddings=[vt.KeyedVectors("toy", words, mat)], device="cpu")
    return sj, st, queries


def _pairs(result):
    return [(m.slice_id, m.score) for m in result]


@pytest.mark.parametrize("precision", [None, "bfloat16", "float32"])
@pytest.mark.parametrize("locality", ["local", "global"])
def test_find_batch_long_among_short_matches_jax(both, locality, precision, monkeypatch):
    """One 129-token query among four short ones: the batch's corpus pass
    splits (the short needles' launch and the long one's), its results
    match the JAX package's within 1e-6 with the same slices outside tie
    bands, and equal the port's own ``find`` of each query byte for
    byte."""
    sj, st, queries = both
    if locality == "local":
        opt_j, opt_t = JaxLocal(), LocalAlignment()
    else:
        opt_j = JaxGlobal(JaxAffine(0.37, 0.113))
        opt_t = GlobalAlignment(AffineGapCost(0.37, 0.113))
    ij = sj.partition("sentence").index(JaxSpanSim(JaxTokenSim(sj.embeddings[0]), opt_j))
    it = st.partition("sentence").index(
        OptimizedSpanSim(EmbeddingTokenSim(st.embeddings[0]), opt_t))
    n, min_score = 4, -1.0 if locality == "global" else 0.05
    seen = _record_launches(monkeypatch, "_affine_gather_launch")
    tables = []
    real_table = search.affine_table
    monkeypatch.setattr(search, "affine_table",
                        lambda *a, **kw: tables.append(a[0].shape) or real_table(*a, **kw))
    got = [_pairs(r) for r in it.find_batch(queries, n=n, min_score=min_score,
                                             sim_precision=precision)]
    widths = sorted(len(lt) for _, lt in seen)
    assert widths[-1] == 4 and 1 in widths, seen  # the short group, the long needle
    # one split a pass, shared by its buckets' launches
    assert len(tables) == 1 and len(seen) == 2 * len(it._engine._live_buckets()), (tables, seen)
    want = ij.find_batch(queries, n=n, min_score=min_score, sim_precision="float32")
    for w, g in zip(want, got):
        assert g
        _same_ranking(_pairs(w), g, min_score)
    assert got == [_pairs(it.find(q, n=n, min_score=min_score)) for q in queries]
