"""The tag weights' table layout (``dp_kernels.tag_table``), which the
tagged kernels of the thread-a-problem routes read, against the plain
rewrite (``dp_kernels.tag_weighted``) and the JAX package's
``_apply_tag_weights``, bit for bit, on the CPU.

The table holds ``w[q, j] * (1 if pos == p[q, j] else 1 - pen[q])`` at
[``rmap[pos & 255]``, q, j]: the tests apply it in torch as the kernels do
(``S * W``, then the threshold) for every int8 pos id, and check that a
corpus pass builds it once, that the tagged entries' plain versions still
equal the JAX DP on the rewritten block, and that a split launch slices it
per needle group.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vectorian_tpu.ops.alignment import AffineGapParams as JaxGaps
from vectorian_tpu.ops.alignment import align_scores as jax_align_scores
from vectorian_tpu.ops.alignment import align_scores_general as jax_asg
from vectorian_tpu.ops.search import _apply_tag_weights as jax_apply_tag_weights
from vectorian_tpu.ops.search import _stack_tw as jax_stack_tw
import vectorian_tpu_torch as vt
from vectorian_tpu_torch.alignment import (
    AffineGapCost,
    ExponentialGapCost,
    LocalAlignment,
)
from vectorian_tpu_torch.metrics import EmbeddingTokenSim, OptimizedSpanSim
from vectorian_tpu_torch.ops import dp_kernels, search
from vectorian_tpu_torch.ops.alignment import AffineGapParams, gap_cost_closure

torch.set_num_threads(2)

LOCALITIES = ("local", "global", "semiglobal")
GAPSET = (0.37, 0.113, 0.29, 0.071)
# every int8 pos id a slice row can hold
ALL_POS = np.arange(-128, 128, dtype=np.int8)


def _bits(x):
    return np.asarray(x, np.float32).view(np.uint32)


def _table_rewrite(S, pos, wt, rmap, k, thr):
    """The kernels' use of the table, in torch: S [B, L, T] f32 of
    problems reading query / slot ``k`` [B], rows' pos ids [B, L] int8:
    ``S * W[rmap[pos & 255], k, j]``, then 0 wherever it is <= thr[k]."""
    T = S.shape[2]
    r = rmap[pos.long() & 255]  # [B, L]
    W = wt[r, k[:, None].expand_as(r), :T]  # [B, L, T]
    Sw = S * W
    return torch.where(Sw > thr[k][:, None, None], Sw, 0.0)


def _columns(rng, Q, T, pen, thr):
    """Needle weights (one negative), pos ids with -1, 127 and -128
    among them, and the given penalty and threshold for every query."""
    w = (rng.random((Q, T)) + 0.2).astype(np.float32)
    w[0, 0] = -0.75
    p = rng.integers(-1, 6, size=(Q, T)).astype(np.int8)
    p[0, 1], p[-1, -1] = 127, -128
    return (w, p, np.full(Q, pen, np.float32), np.full(Q, thr, np.float32))


@pytest.mark.parametrize("thr", [-np.inf, -1.0, 0.1])
@pytest.mark.parametrize("pen", [0.0, 0.3, 1.0, 1.5])
def test_table_rewrite_bit_equal_to_plain_and_jax(pen, thr):
    """Every int8 slice pos id, negative similarities, each penalty and
    threshold: the table's rewrite = ``tag_weighted`` = JAX's
    ``_apply_tag_weights``, bit for bit."""
    rng = np.random.default_rng(int(pen * 10) + 7)
    Q, T, L = 3, 8, 16
    w, p, pen_a, thr_a = _columns(rng, Q, T, pen, thr)
    pos = np.resize(ALL_POS, (16, L))  # 16 rows x 16 = all 256 ids
    S = rng.uniform(-0.6, 1.0, size=(Q, 16, L, T)).astype(np.float32)
    S[:, :, :, 0] = 0.0  # S = 0 against a negative weight: -0.0
    wt, rmap = (torch.from_numpy(x) for x in dp_kernels.tag_table(w, p, pen_a))
    for q in range(Q):
        k = torch.full((16,), q, dtype=torch.long)
        got = _table_rewrite(torch.from_numpy(S[q]), torch.from_numpy(pos), wt, rmap, k,
                             torch.from_numpy(thr_a)).numpy()
        plain = dp_kernels.tag_weighted(
            torch.from_numpy(S[q]), torch.from_numpy(pos),
            torch.from_numpy(np.repeat(w[q : q + 1], 16, 0)),
            torch.from_numpy(np.repeat(p[q : q + 1], 16, 0)),
            torch.full((16,), float(pen_a[q])), torch.full((16,), float(thr_a[q])),
        ).numpy()
        want = np.asarray(jax_apply_tag_weights(
            jnp.asarray(S[q]), jnp.asarray(pos), jnp.asarray(w[q]), jnp.asarray(p[q]),
            jnp.asarray(pen_a[q]), jnp.asarray(thr_a[q])))
        assert np.array_equal(_bits(got), _bits(plain))
        assert np.array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("pen", [0.0, 0.3, 1.5])
def test_table_rewrite_of_stacked_slots(pen):
    """``stack_tag_slots``' arrays (a tagged slot's columns past its needle
    weight 0 with pos -1, an untagged slot weight 1 under threshold -inf)
    through the table = JAX's ``_stack_tw`` columns through
    ``_apply_tag_weights`` (an untagged slot: S, as JAX's mask selects),
    every int8 pos id."""
    rng = np.random.default_rng(3)
    T, L = 8, 16
    tws = [
        search.TagWeightingSpec((rng.random(5) + 0.2).astype(np.float32),
                                rng.integers(-1, 6, 5).astype(np.int8), pen, 0.05),
        None,
        search.TagWeightingSpec((rng.random(T) + 0.2).astype(np.float32),
                                rng.integers(-1, 6, T).astype(np.int8), pen, -0.2),
    ]
    cols = search.stack_tag_slots(tws, 3, T)
    wt, rmap = (torch.from_numpy(x) for x in dp_kernels.tag_table(*cols[:3]))
    jw, jp, jpen, jthr, tagged = (np.asarray(x) for x in jax_stack_tw(tws, 3, T))
    pos = np.resize(ALL_POS, (16, L))
    S = rng.uniform(-0.6, 1.0, size=(16, L, T)).astype(np.float32)
    for k in range(3):
        got = _table_rewrite(torch.from_numpy(S), torch.from_numpy(pos), wt, rmap,
                             torch.full((16,), k, dtype=torch.long),
                             torch.from_numpy(cols[3])).numpy()
        want = S  # JAX selects an untagged slot's S by its mask
        if tagged[k]:
            want = np.asarray(jax_apply_tag_weights(
                jnp.asarray(S), jnp.asarray(pos), jnp.asarray(jw[k]), jnp.asarray(jp[k]),
                jnp.asarray(jpen[k]), jnp.asarray(jthr[k])))
        assert np.array_equal(_bits(got), _bits(want))


def test_table_is_exact_for_every_pos_id():
    """Row ``rmap[v & 255]`` of the table holds w * (1 or 1 - pen) of pos
    id v for all 256 int8 values, with R - 1 rows for the needles'
    distinct pos ids and one for every other id; a (row, query)'s columns
    run to a multiple of 4, zero past the needle."""
    rng = np.random.default_rng(5)
    w, p, pen, _ = _columns(rng, 4, 7, 0.3, 0.0)
    pen[2] = 1.5
    wt, rmap = dp_kernels.tag_table(w, p, pen)
    assert wt.shape == (len(np.unique(p)) + 1, 4, 8) and rmap.dtype == np.int32
    assert not wt[:, :, 7].any()
    for v in ALL_POS:
        sel = np.where(p == v, np.float32(1.0), np.float32(1.0) - pen[:, None])
        assert np.array_equal(_bits(wt[rmap[np.uint8(v)], :, :7]), _bits(w * sel))


def _gather_case(rng, n, L, Tpad, Q, V=29):
    table = rng.uniform(-0.4, 1.0, size=(V, Tpad, Q)).astype(np.float32)
    tok = rng.integers(0, V, size=(n, L)).astype(np.int32)
    len_s = rng.integers(0, L + 1, size=n).astype(np.int32)
    len_s[:2] = (0, L)
    len_t = rng.integers(1, Tpad + 1, size=Q).astype(np.int32)
    len_t[0] = Tpad
    w, p, pen, thr = _columns(rng, Q, Tpad, 0.3, 0.05)
    pen[:] = rng.random(Q).astype(np.float32) * 1.2
    pos = rng.integers(-1, 6, size=(n, L)).astype(np.int8)
    pos[0, :3] = (127, -128, -1)
    cols = (w, p, pen, thr)
    tags = dp_kernels.TagBlock(
        torch.from_numpy(pos),
        *(torch.from_numpy(x) for x in cols + dp_kernels.tag_table(w, p, pen)))
    return table, tok, len_s, len_t, tags


def _jax_block(table, tok, tags):
    """JAX's rewritten block [n * Q, L, Tpad] (problem s * Q + q) of the
    gather ``table[tok]``."""
    n, L = tok.shape
    Q = table.shape[2]
    S = table[tok]  # [n, L, Tpad, Q]
    blocks = [
        np.asarray(jax_apply_tag_weights(
            jnp.asarray(S[..., q]), jnp.asarray(tags.pos.numpy()),
            jnp.asarray(tags.w[q].numpy()), jnp.asarray(tags.p[q].numpy()),
            jnp.asarray(tags.pen[q].numpy()), jnp.asarray(tags.thr[q].numpy())))
        for q in range(Q)
    ]
    return np.stack(blocks, 1).reshape(n * Q, L, -1)


@pytest.mark.parametrize("Q", [32, 1])
@pytest.mark.parametrize("locality", LOCALITIES)
@pytest.mark.parametrize("kernel", ["affine", "wsb"])
def test_tagged_entries_equal_jax_dp(kernel, locality, Q):
    """The tagged gather entries' CPU route (a TagBlock with its table) =
    the JAX DP (``align_scores`` / ``align_scores_general``) on the block
    JAX rewrites, bit for bit."""
    rng = np.random.default_rng(Q + len(locality))
    n, L, Tpad = 24, 9, 8
    table, tok, len_s, len_t, tags = _gather_case(rng, n, L, Tpad, Q)
    S = _jax_block(table, tok, tags)
    ln = np.repeat(np.maximum(len_s, 1), Q)
    lt = np.tile(len_t, n)
    args = (torch.from_numpy(table), torch.from_numpy(tok), torch.from_numpy(len_s),
            torch.from_numpy(len_t))
    if kernel == "affine":
        got = dp_kernels.affine_dp_scores(*args, AffineGapParams.of(*GAPSET), locality,
                                          tags=tags).numpy()
        want = jax_align_scores(jnp.asarray(S), jnp.asarray(ln), jnp.asarray(lt),
                                JaxGaps.of(*GAPSET), locality)
    else:
        w_s = np.asarray(ExponentialGapCost(3.0).costs(L + 1), np.float32)
        w_t = np.asarray(ExponentialGapCost(3.0).costs(Tpad + 1), np.float32)
        vecs = (torch.from_numpy(w_s), torch.from_numpy(w_t),
                gap_cost_closure(torch.from_numpy(w_t)))
        got = dp_kernels.wsb_dp_scores(*args, *vecs, locality, host_costs=vecs,
                                       tags=tags).numpy()
        want = jax_asg(jnp.asarray(S), jnp.asarray(ln), jnp.asarray(lt),
                       jnp.asarray(w_s), jnp.asarray(w_t), locality)
    assert np.array_equal(_bits(got), _bits(np.asarray(want).reshape(n, Q)))


def test_split_launch_slices_the_table(monkeypatch):
    """Past the register width the gather entry splits its queries by
    needle width: each group's TagBlock holds its queries' columns of the
    table, which weight every pos id as the group's own w, p and pen do;
    the split's scores = the unsplit plain version's."""
    rng = np.random.default_rng(9)
    n, L, Tpad, Q = 12, 6, 80, 5
    table, tok, len_s, len_t, tags = _gather_case(rng, n, L, Tpad, Q)
    len_t[:] = (80, 3, 70, 8, 1)
    seen = []
    launch = dp_kernels._affine_gather_launch

    def spy(group, *a, **kw):
        seen.append((group, a[-1]))
        return launch(group, *a, **kw)

    monkeypatch.setattr(dp_kernels, "_affine_gather_launch", spy)
    args = (torch.from_numpy(table), torch.from_numpy(tok), torch.from_numpy(len_s),
            torch.from_numpy(len_t), AffineGapParams.of(*GAPSET), "local")
    got = dp_kernels.affine_dp_scores(*args, tags=tags)
    assert len(seen) == 2
    for group, tg in seen:
        qi = group.qi.numpy()
        assert tg.wt.shape == (tags.wt.shape[0], len(qi), Tpad)
        w, p, pen = (getattr(tags, f).numpy()[qi] for f in ("w", "p", "pen"))
        for v in ALL_POS:
            sel = np.where(p == v, np.float32(1.0), np.float32(1.0) - pen[:, None])
            row = tg.wt[int(tg.rmap[np.uint8(v)])].numpy()
            assert np.array_equal(_bits(row), _bits(w * sel))
    want = dp_kernels.affine_dp_scores_reference(*args, tags=tags)
    assert torch.equal(got, want)


def test_tag_table_checks():
    """A weight table of the wrong shape is refused where the block is
    checked, on the CPU too."""
    rng = np.random.default_rng(1)
    table, tok, len_s, len_t, tags = _gather_case(rng, 4, 5, 8, 3)
    args = (torch.from_numpy(table), torch.from_numpy(tok), torch.from_numpy(len_s),
            torch.from_numpy(len_t), AffineGapParams.of(*GAPSET), "local")
    bad = tags._replace(wt=tags.wt[:, :2])
    with pytest.raises(ValueError, match="tags.wt"):
        dp_kernels.affine_dp_scores(*args, tags=bad)
    with pytest.raises(ValueError, match="tags.rmap"):
        dp_kernels.affine_dp_scores(*args, tags=tags._replace(rmap=None))


@pytest.mark.parametrize("gap", ["affine", "exponential"])
def test_corpus_pass_builds_the_table_once(monkeypatch, gap):
    """A tagged find_batch's corpus pass hands every bucket's launch the
    same weight table, made from its tag columns (``tag_arrays``), and the
    batch's results equal a loop of find."""
    rng = np.random.default_rng(2)
    words = ["".join(chr(97 + int(c)) for c in rng.integers(0, 26, 5)) for _ in range(40)]
    mat = rng.normal(size=(40, 8)).astype(np.float32)
    texts = [" ".join(" ".join(rng.choice(words, size=int(rng.integers(2, 14))))
                      + "." for _ in range(30)) for _ in range(3)]
    session = vt.Session([vt.StringImporter()(t, title=f"d{i}") for i, t in enumerate(texts)],
                         embeddings=[vt.KeyedVectors("toy", words, mat)], device="cpu")
    g = AffineGapCost(0.37, 0.113) if gap == "affine" else ExponentialGapCost(3.0)
    index = session.partition("sentence").index(OptimizedSpanSim(
        EmbeddingTokenSim(session.embeddings[0]), LocalAlignment(g),
        tag_weights={"NN": 0.8, "JJ": 0.4}, pos_mismatch_penalty=0.3,
        similarity_threshold=0.05))
    name = "affine_dp_scores" if gap == "affine" else "wsb_dp_scores"
    entry = getattr(search, name)
    seen = []

    def spy(*a, tags=None, **kw):
        if tags is not None:
            seen.append((a[1].shape[1], tags))
        return entry(*a, tags=tags, **kw)

    monkeypatch.setattr(search, name, spy)
    queries = [" ".join(words[i : i + k]) for i, k in ((1, 4), (5, 3), (8, 5))]
    got = index.find_batch(queries, n=5, min_score=-1.0, sim_precision="float32")
    assert len({L for L, _ in seen}) >= 2  # several buckets
    first = seen[0][1]
    for _, tags in seen:
        assert tags.wt is first.wt and tags.rmap is first.rmap
    cols = tuple(x.numpy() for x in first[1:5])
    wt, rmap = dp_kernels.tag_table(*cols[:3])
    assert np.array_equal(_bits(first.wt.numpy()), _bits(wt))
    assert np.array_equal(first.rmap.numpy(), rmap)
    for q, r in zip(queries, got):
        want = index.find(q, n=5, min_score=-1.0)
        assert [(m.slice_id, m.score) for m in r] == [(m.slice_id, m.score) for m in want]
