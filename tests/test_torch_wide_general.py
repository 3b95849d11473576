"""Kernel 3's wide needles (general gaps, needles padded to 33-512 columns)
and the per-needle split of its gather entry (ops/dp_kernels.py
``wsb_launch_plan``'s "wide" route, ``needle_split``, ``wsb_table``).

Past WSB_REG_MAX_T columns a launch's short needles take the lane routes
over their own columns of the table and only the long ones the wide route;
a corpus pass makes the split once and its buckets share it.  On the CPU
each group goes to the plain version, so these tests reach the plan and the
split's bookkeeping: the routes for shapes the wide route takes and those
past its shared memory, the groups for mixes of needle widths, and the
assembled output, bit-equal to the unsplit plain version and to the JAX
package's Pallas kernel (interpret mode) at f32, bf16 and int8 tables, 3
localities, ExponentialGapCost(3.0) and a concave CustomGapCost.  The rows
and dense entries are not split (one launch at their width).  Then find and
find_batch with 40- and 129-token queries among short ones against the JAX
package.  The card holds the wide kernel itself against the same plain
versions (chip_smoke.py phase 3 and the general long-query phase).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import vectorian_tpu as vj
import vectorian_tpu_torch as vt
from vectorian_tpu.alignment import CustomGapCost as JaxCustom
from vectorian_tpu.alignment import ExponentialGapCost as JaxExponential
from vectorian_tpu.alignment import GlobalAlignment as JaxGlobal
from vectorian_tpu.alignment import LocalAlignment as JaxLocal
from vectorian_tpu.alignment import SemiGlobalAlignment as JaxSemiGlobal
from vectorian_tpu.metrics import EmbeddingTokenSim as JaxTokenSim
from vectorian_tpu.metrics import OptimizedSpanSim as JaxSpanSim
from vectorian_tpu.ops.pallas_dp import pallas_align_scores_general
from vectorian_tpu_torch.alignment import (
    CustomGapCost,
    ExponentialGapCost,
    GlobalAlignment,
    LocalAlignment,
    SemiGlobalAlignment,
)
from vectorian_tpu_torch.metrics import EmbeddingTokenSim, OptimizedSpanSim
from vectorian_tpu_torch.ops import dp_kernels, search
from vectorian_tpu_torch.ops.alignment import NEG
from vectorian_tpu_torch.ops.search import GeneralGaps

from tests.test_torch_wide import _same_ranking

torch.set_num_threads(2)

LOCALITIES = ["local", "global", "semiglobal"]
MODELS = {"exponential": ExponentialGapCost(3.0),
          "concave": CustomGapCost(lambda k: 0.1 * k ** 0.5)}
# a batch padded to its 72-token needle: short needles (<= 32), the
# boundaries 32 / 33 / 64 / 65 and the longest
MIX = [7, 32, 33, 3, 64, 1, 65, 72, 40]
TPAD = 72


# ---- the route plan ---------------------------------------------------------


@pytest.mark.parametrize("L,T,route", [
    (16, 40, "wide"), (16, 64, "wide"), (16, 136, "wide"), (16, 160, "wide"),
    (16, 512, "wide"), (8, 256, "wide"), (64, 40, "wide"), (64, 136, "wide"),
    (64, 160, "wide"), (256, 48, "wide"), (1024, 40, "scratch"),
    (64, 256, "scratch"), (64, 512, "scratch"), (256, 64, "scratch"),
    (16, 513, "scratch"), (16, 32, "registers"), (64, 32, "long"),
])
def test_wsb_plan_takes_wide_needles(L, T, route):
    """Needles of 33-512 columns take "wide" ("rows_wide", "wide" for the
    dense entry) while a warp's column history leaves WSB_WIDE_MIN_WARPS
    warps resident an SM, whatever the closure; past that the
    thread-a-problem body; up to 32 columns the lane routes as before."""
    problems = 1_000_000
    for rows in (False, True):
        prefix = "rows_" if rows else ""
        plan = dp_kernels.wsb_launch_plan(problems, L, T, rows=rows, Q=32)
        assert plan.route == prefix + route
        # a closure with a negative cost: the lane routes refuse it
        plan = dp_kernels.wsb_launch_plan(problems, L, T, registers=False, rows=True, Q=32)
        assert plan.route in (("rows_wide",) if route == "wide" else
                              ("rows_shared", "rows_scratch"))
    plan = dp_kernels.wsb_launch_plan(problems, L, T)
    assert dp_kernels.wsb_wide_shape(L, T) == (route == "wide")
    if route == "wide":
        warps = plan.threads // 32
        assert plan.smem == dp_kernels.wsb_wide_smem(L, T, warps) <= dp_kernels.WSB_SMEM_MAX
        assert plan.blocks * warps >= problems and plan.floats == 0
        resident = dp_kernels._resident(plan.smem, plan.threads)
        assert resident >= 32 * dp_kernels.WSB_WIDE_MIN_WARPS
        # the history a warp keeps: L x T floats
        assert plan.smem >= warps * L * T * 4
        # tagged launches stay on the body
        assert dp_kernels.wsb_launch_plan(problems, L, T, wide=False).route in (
            "shared", "scratch")
    else:
        with pytest.raises(ValueError, match="wide route"):
            dp_kernels.wsb_launch_plan(problems, L, T, route="wide")


# ---- the split ----------------------------------------------------------------


@pytest.mark.parametrize("lens,Tpad,groups", [
    ([3, 7, 8], 8, None),                                  # all short, one launch
    ([7, 7, 30], 40, [([0, 1, 2], 32)]),                   # all short, padded past 32
    ([33, 129, 160], 160, None),                           # all wide, one launch
    ([32, 33, 64, 65], 72, [([0], 32), ([1, 2, 3], 72)]),  # the boundaries
    ([7] * 31 + [160], 160, [(list(range(31)), 8), ([31], 160)]),  # one wide among 31
    ([160] + [7] * 31, 160, [(list(range(1, 32)), 8), ([0], 160)]),
    ([9, 140, 2], 144, [([0, 2], 16), ([1], 144)]),        # short width rounded to 8
    ([40], 40, None),                                      # a find's Q = 1
])
def test_wsb_table_groups(lens, Tpad, groups):
    """The split's groups for mixes of needle widths: one launch where every
    needle is short or every one is wide, else the short ones over their
    own columns (rounded up to 8) and the wide ones at the full width;
    each group's table holds its queries' columns of the table."""
    V = 11
    table = torch.arange(V * Tpad * len(lens), dtype=torch.float32).reshape(V, Tpad, len(lens))
    len_t = torch.tensor(lens, dtype=torch.int32)
    prepared = dp_kernels.wsb_table(table, len_t, lens)
    assert prepared.table is table and prepared.len_t is len_t
    if groups is None:
        (g,) = prepared.groups
        assert g.qi is None and g.table is table and g.len_t is len_t
        return
    assert [(g.qi.tolist(), g.table.shape[1]) for g in prepared.groups] == groups
    for g in prepared.groups:
        assert torch.equal(g.table, table[:, :g.table.shape[1], g.qi])
        assert g.len_t.tolist() == [lens[q] for q in g.qi.tolist()]
    # read back from len_t when the host lengths are not given
    again = dp_kernels.wsb_table(table, len_t)
    assert [g.qi.tolist() for g in again.groups] == [g.qi.tolist() for g in prepared.groups]
    # a forced route is one launch of the whole table
    (g,) = dp_kernels.wsb_table(table, len_t, lens, route="wide").groups
    assert g.qi is None


def _record_launches(monkeypatch):
    """Each gather launch (the one-launch helper): (table shape, len_t), the
    launch still run."""
    seen = []
    real = dp_kernels._wsb_gather_launch

    def rec(group, *args, **kw):
        seen.append((tuple(group.table.shape), group.len_t.tolist()))
        return real(group, *args, **kw)

    monkeypatch.setattr(dp_kernels, "_wsb_gather_launch", rec)
    return seen


def _vecs(model, L, T):
    """(device vectors, host vectors, raw w_s, raw w_t) of ``model`` on both
    sides at (L, T), as a corpus pass builds them."""
    gg = GeneralGaps((model, model), T + 1, torch.device("cpu"))
    w_s, w_t, _ = gg.host_vecs(L)
    return gg.vecs(L), gg.host_vecs(L), w_s.numpy(), w_t.numpy()


def _gather_inputs(rng, dtype, V=19, L=6, c=7):
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


def test_gather_groups_take_their_launches(monkeypatch):
    """The mixed batch: one launch of the short needles over their first
    32 columns, one of the wide ones over the whole width; a pass's
    ``WsbTable`` gives the same bits, is read only with its len_t and
    forces no route."""
    table, tokens, len_s, len_t = _gather_inputs(np.random.default_rng(1), torch.float32)
    vecs, host, _, _ = _vecs(MODELS["exponential"], tokens.shape[1], TPAD)
    seen = _record_launches(monkeypatch)
    got = dp_kernels.wsb_dp_scores(table, tokens, len_s, len_t, *vecs, "local",
                                   host_costs=host)
    short = [lt for lt in MIX if lt <= 32]
    wide = [lt for lt in MIX if lt > 32]
    V = table.shape[0]
    assert seen == [((V, 32, len(short)), short), ((V, TPAD, len(wide)), wide)]
    seen.clear()
    prepared = dp_kernels.wsb_table(table, len_t, MIX)
    again = dp_kernels.wsb_dp_scores(prepared, tokens, len_s, len_t, *vecs, "local",
                                     host_costs=host)
    assert torch.equal(got, again) and len(seen) == 2
    with pytest.raises(ValueError):
        dp_kernels.wsb_dp_scores(prepared, tokens, len_s, len_t.clone(), *vecs, "local")
    with pytest.raises(ValueError):
        dp_kernels.wsb_dp_scores(prepared, tokens, len_s, len_t, *vecs, "local",
                                 _route="wide")
    # a forced route is one launch of the whole table
    seen.clear()
    dp_kernels.wsb_dp_scores(table, tokens, len_s, len_t, *vecs, "local", _route="wide")
    assert seen == [((V, TPAD, len(MIX)), MIX)]
    # an empty bucket reads the prepared table too
    assert dp_kernels.wsb_dp_scores(prepared, tokens[:0], len_s[:0], len_t, *vecs,
                                    "local").shape == (0, len(MIX))


# ---- bit equality ------------------------------------------------------------


def _tags(rng, n, L, Q, T):
    return dp_kernels.TagBlock(
        torch.from_numpy(rng.integers(0, 4, size=(n, L)).astype(np.int8)),
        torch.from_numpy(rng.uniform(0.3, 1.0, size=(Q, T)).astype(np.float32)),
        torch.from_numpy(rng.integers(0, 4, size=(Q, T)).astype(np.int8)),
        torch.from_numpy(rng.uniform(0.0, 0.5, size=Q).astype(np.float32)),
        torch.from_numpy(rng.uniform(-0.2, 0.2, size=Q).astype(np.float32)),
    )


@pytest.mark.parametrize("model", sorted(MODELS))
@pytest.mark.parametrize("locality", LOCALITIES)
@pytest.mark.parametrize("variant", ["f32", "bf16", "int8", "tagged"])
def test_gather_split_bit_equal(variant, locality, model):
    """The split gather entry = the unsplit plain version = the Pallas
    kernel on the gathered (tag-weighted) block (len_s clamped to >= 1),
    bit for bit; a tagged launch splits too (its wide group then takes the
    thread-a-problem body on the card)."""
    dtype = {"bf16": torch.bfloat16, "int8": torch.int8}.get(variant, torch.float32)
    rng = np.random.default_rng(len(variant) + len(model))
    table, tokens, len_s, len_t = _gather_inputs(rng, dtype)
    n, L = tokens.shape
    Q = len(MIX)
    tags = _tags(rng, n, L, Q, TPAD) if variant == "tagged" else None
    vecs, host, w_s, w_t = _vecs(MODELS[model], L, TPAD)
    got = dp_kernels.wsb_dp_scores(table, tokens, len_s, len_t, *vecs, locality,
                                   host_costs=host, tags=tags)
    unsplit = dp_kernels.wsb_dp_scores_reference(table, tokens, len_s, len_t, *vecs,
                                                 locality, tags=tags)
    S = dp_kernels._gathered_block(table, tokens.long(), tags, 0).numpy()  # [n * Q, L, Tpad]
    want = pallas_align_scores_general(
        jnp.asarray(S), jnp.asarray(np.repeat(np.maximum(len_s.numpy(), 1), Q)),
        jnp.asarray(np.tile(len_t.numpy(), n)), jnp.asarray(w_s), jnp.asarray(w_t),
        locality, interpret=True)
    assert got.shape == (n, Q)
    assert torch.equal(got, unsplit)
    assert np.array_equal(got.numpy(), np.asarray(want).reshape(n, Q))


def _rows_inputs(rng, L=6, B=40, n=9, V=13):
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


@pytest.mark.parametrize("model", sorted(MODELS))
@pytest.mark.parametrize("locality", LOCALITIES)
def test_rows_wide_bit_equal(locality, model, monkeypatch):
    """The rows entry past 32 columns is one launch over the whole table
    ("rows_wide" on the card, not split by needle), = its plain version =
    the Pallas kernel on the gathered block, masked where len_s <= 0."""
    rng = np.random.default_rng(7)
    table, tokens, rows, qslot, len_s, len_t, V = _rows_inputs(rng)
    L = tokens.shape[1]
    vecs, host, w_s, w_t = _vecs(MODELS[model], L, TPAD)
    S = dp_kernels._gather_rows(tokens, rows, qslot, table, V).numpy()
    seen = []
    real = dp_kernels.wsb_dp_scores_rows_reference
    monkeypatch.setattr(dp_kernels, "wsb_dp_scores_rows_reference",
                        lambda *a, **kw: seen.append((a[3].shape[1], a[6].tolist()))
                        or real(*a, **kw))
    args = (tokens, rows, qslot, table, V, len_s, len_t, *vecs, locality)
    got = dp_kernels.wsb_dp_scores_rows(*args, host_costs=host)
    assert seen == [(TPAD, len_t.tolist())]
    assert dp_kernels.wsb_launch_plan(len(len_s), L, TPAD, rows=True).route == "rows_wide"
    want = pallas_align_scores_general(
        jnp.asarray(S), jnp.asarray(len_s.numpy()), jnp.asarray(len_t.numpy()),
        jnp.asarray(w_s), jnp.asarray(w_t), locality, interpret=True)
    assert torch.equal(got, real(*args))
    assert np.array_equal(got.numpy(), np.where(len_s.numpy() > 0, np.asarray(want), NEG))


@pytest.mark.parametrize("model", sorted(MODELS))
@pytest.mark.parametrize("locality", LOCALITIES)
def test_dense_wide_bit_equal(locality, model):
    """The dense entry past 32 columns, short needles among wide ones: one
    launch over the block in place ("dense_wide" on the card) = its plain
    version = the Pallas kernel on the block."""
    rng = np.random.default_rng(5)
    c, L = 6, 5
    lens = [33, 7, 64, 32, 100, 1]
    Tpad = 104
    S = torch.from_numpy(rng.uniform(-0.4, 1.0, size=(c, L, Tpad, len(lens))).astype(np.float32))
    len_s = torch.from_numpy(rng.integers(0, L + 1, size=c).astype(np.int32))
    len_t = torch.tensor(lens, dtype=torch.int32)
    vecs, host, w_s, w_t = _vecs(MODELS[model], L, Tpad)
    got = dp_kernels.wsb_dp_scores_dense(S, len_s, len_t, *vecs, locality, host_costs=host)
    assert dp_kernels.wsb_launch_plan(c * len(lens), L, Tpad, Q=len(lens)).route == "wide"
    # the route forced is accepted on the CPU too
    forced = dp_kernels.wsb_dp_scores_dense(S, len_s, len_t, *vecs, locality,
                                            host_costs=host, _route="wide")
    S2 = S.permute(0, 3, 1, 2).reshape(c * len(lens), L, Tpad).numpy()
    want = pallas_align_scores_general(
        jnp.asarray(S2), jnp.asarray(np.repeat(np.maximum(len_s.numpy(), 1), len(lens))),
        jnp.asarray(np.tile(lens, c)), jnp.asarray(w_s), jnp.asarray(w_t), locality,
        interpret=True)
    assert torch.equal(got, forced)
    assert torch.equal(got, dp_kernels.wsb_dp_scores_dense_reference(
        S, len_s, len_t, *vecs, locality))
    assert np.array_equal(got.numpy(), np.asarray(want).reshape(c, len(lens)))


# ---- find and find_batch --------------------------------------------------------


def _corpus():
    rng = np.random.default_rng(29)
    words = ["w" + "".join(chr(97 + int(c)) for c in rng.integers(0, 26, size=4))
             for _ in range(30)]
    mat = rng.normal(size=(len(words), 16)).astype(np.float32)
    texts = [" ".join(" ".join(rng.choice(words, size=int(rng.integers(3, 12)))) + "."
                      for _ in range(30)) for _ in range(3)]
    queries = [" ".join(rng.choice(words, size=k)) for k in (6, 40, 3, 129, 9, 7)]
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


CASES = {
    "local": (JaxLocal, LocalAlignment, lambda: JaxExponential(3.0),
              lambda: ExponentialGapCost(3.0)),
    "global": (JaxGlobal, GlobalAlignment, lambda: JaxCustom(lambda k: 0.1 * k ** 0.5),
               lambda: CustomGapCost(lambda k: 0.1 * k ** 0.5)),
    "semiglobal": (JaxSemiGlobal, SemiGlobalAlignment, lambda: JaxExponential(3.0),
                   lambda: ExponentialGapCost(3.0)),
}


# the default int8 ranking once (its extras rounds run the plain row-gather
# scan at 136 columns: the slowest case on the CPU), f32 in every locality
@pytest.mark.parametrize("case,precision", [
    ("local", None), ("local", "float32"), ("global", "float32"), ("semiglobal", "float32"),
])
def test_find_batch_wide_among_short_matches_jax(both, case, precision, monkeypatch):
    """A 40- and a 129-token query among four short ones under general gaps:
    the batch's corpus pass splits once (the short needles' launch and the
    wide ones' a bucket), find and find_batch return the JAX package's
    slices with scores within 1e-6, and find_batch equals the port's own
    ``find`` of each query byte for byte."""
    sj, st, queries = both
    opt_j, opt_t, gap_j, gap_t = CASES[case]
    ij = sj.partition("sentence").index(JaxSpanSim(JaxTokenSim(sj.embeddings[0]),
                                                   opt_j(gap_j())))
    it = st.partition("sentence").index(OptimizedSpanSim(EmbeddingTokenSim(st.embeddings[0]),
                                                         opt_t(gap_t())))
    # the 129-token needle aligns at most a sentence of 11 tokens: low scores
    n, min_score = 4, -100.0 if case == "global" else 1e-3
    seen = _record_launches(monkeypatch)
    tables = []
    real_table = search.wsb_table
    monkeypatch.setattr(search, "wsb_table",
                        lambda *a, **kw: tables.append(a[0].shape) or real_table(*a, **kw))
    got = [_pairs(r) for r in it.find_batch(queries, n=n, min_score=min_score,
                                             sim_precision=precision)]
    widths = sorted(len(lt) for _, lt in seen)
    assert widths[0] == 2 and widths[-1] == 4, seen  # the wide pair, the short group
    assert all(shape[1] == 16 for shape, lt in seen if len(lt) == 4), seen  # 9 -> 16
    # one split a pass, shared by its buckets' launches
    assert len(tables) == 1 and len(seen) == 2 * len(it._engine._live_buckets()), (tables, seen)
    want = ij.find_batch(queries, n=n, min_score=min_score, sim_precision="float32")
    for w, g in zip(want, got):
        assert g
        _same_ranking(_pairs(w), g, min_score)
    finds = [_pairs(it.find(q, n=n, min_score=min_score)) for q in queries]
    assert got == finds
    for q, f in zip(queries, finds):
        if len(q.split()) > 32:
            _same_ranking(_pairs(ij.find(q, n=n, min_score=min_score)), f, min_score)
    # tensors on the CPU take the plain versions: no kernel launch counted
    assert not any(dp_kernels.WSB_ROUTE_LAUNCHES.values())
