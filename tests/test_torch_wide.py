"""Long needles (more than 128 padded tokens; the affine register templates
end at 64): the port's plain affine DP against the JAX package's Pallas kernel
(interpret mode) bit for bit, find and find_batch of a 129-token query
against the JAX package, and the route function that sends such needles to
the wide routes (csrc/affine_dp.cu ``affine_dp_wide_regs_kernel``, then
``affine_dp_wide_kernel``), which the card holds bit for bit against the
same plain version (chip_smoke.py phase 3).
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
from vectorian_tpu.ops.pallas_dp import pallas_align_scores_multi_nt
from vectorian_tpu_torch.alignment import AffineGapCost, GlobalAlignment, LocalAlignment
from vectorian_tpu_torch.metrics import EmbeddingTokenSim, OptimizedSpanSim
from vectorian_tpu_torch.ops import dp_kernels
from vectorian_tpu_torch.ops.alignment import AffineGapParams

torch.set_num_threads(2)

REL = 1e-6
LOCALITIES = ["local", "global", "semiglobal"]
GAPSETS = [(0.0, 0.0, 0.0, 0.0), (0.37, 0.113, 0.29, 0.071)]


@pytest.mark.parametrize("Tp", [132, 256])
@pytest.mark.parametrize("locality", LOCALITIES)
def test_plain_dp_bit_equal_to_pallas_past_128(locality, Tp):
    V, L, c, Q = 23, 6, 9, 2
    rng = np.random.default_rng(Tp)
    table = rng.uniform(-0.4, 1.0, size=(V, Tp, Q)).astype(np.float32)
    tok = rng.integers(0, V, size=(c, L)).astype(np.int32)
    len_s = rng.integers(0, L + 1, size=c).astype(np.int32)
    len_s[:2] = (0, L)
    len_t = np.asarray([Tp, 129], np.int32)
    S = table[tok.T]  # [L, c, Tp, Q], the JAX corpus pass's gather
    ln1 = np.maximum(len_s, 1)
    for gs in GAPSETS:
        got = dp_kernels.affine_dp_scores(
            torch.from_numpy(table), torch.from_numpy(tok), torch.from_numpy(len_s),
            torch.from_numpy(len_t), AffineGapParams.of(*gs), locality,
        ).numpy()
        want = np.asarray(pallas_align_scores_multi_nt(
            jnp.asarray(S), jnp.asarray(ln1), jnp.asarray(len_t), JaxGaps.of(*gs),
            locality, interpret=True,
        ))
        assert got.shape == (c, Q)
        assert np.array_equal(got, want), gs


@pytest.mark.parametrize("Tpad", [4, 8, 64, 128, 132, 256, 1_024, 1_815, 1_816, 4_096, 100_000])
def test_route_serves_every_width(Tpad):
    """Registers up to AFFINE_REG_MAX_T; past it the register-resident wide
    route (a lane's columns in registers) up to AFFINE_WIDE_REGS_MAX_T;
    past that the wide route's rows in shared memory while a block of them
    fits with enough warps an SM, else a scratch buffer within its cap.  No
    width raises, and any can be forced onto the scratch route."""
    for rows in (False, True):
        prefix = "rows_" if rows else ""
        for problems in (1, 700, 1 << 25):
            plan = dp_kernels.affine_launch_plan(problems, Tpad, rows=rows)
            per_warp = 16 * (Tpad + 1)
            forced = dp_kernels.affine_launch_plan(problems, Tpad, rows=rows,
                                                   route="wide_scratch")
            assert forced.route == prefix + "wide_scratch"
            if Tpad <= dp_kernels.AFFINE_REG_MAX_T:
                assert plan.route == prefix + "registers"
                assert plan.blocks * plan.threads >= problems
                continue
            if Tpad <= dp_kernels.AFFINE_WIDE_REGS_MAX_T:
                assert plan.route == prefix + "wide_regs"
                assert plan.threads == 32 * dp_kernels.AFFINE_WIDE_REGS_WARPS
                assert plan.smem == 0 and plan.floats == 0
                cpl = dp_kernels.affine_wide_cpl(Tpad)
                assert cpl in dp_kernels.AFFINE_WIDE_CPL and 32 * cpl >= Tpad
                assert cpl == dp_kernels.AFFINE_WIDE_CPL[0] or 16 * cpl < Tpad
                assert plan.blocks * dp_kernels.AFFINE_WIDE_REGS_WARPS >= problems
                continue
            assert plan.threads == 32 * dp_kernels.AFFINE_WIDE_WARPS
            if plan.route == prefix + "wide_shared":
                assert plan.smem == dp_kernels.AFFINE_WIDE_WARPS * per_warp
                assert plan.smem <= dp_kernels.WSB_SMEM_MAX and plan.floats == 0
                assert plan.blocks * dp_kernels.AFFINE_WIDE_WARPS >= problems
            else:
                assert plan.route == prefix + "wide_scratch"
                assert plan.smem == 0 and plan.blocks >= 1
                assert plan.floats * 4 == plan.blocks * dp_kernels.AFFINE_WIDE_WARPS * per_warp
                assert plan.floats * 4 <= max(dp_kernels.WSB_SCRATCH_MAX,
                                              dp_kernels.AFFINE_WIDE_WARPS * per_warp)
            fits = dp_kernels.AFFINE_WIDE_WARPS * per_warp <= dp_kernels.WSB_SMEM_MAX
            assert (plan.route == prefix + "wide_shared") == fits
    if Tpad > dp_kernels.AFFINE_REG_MAX_T:
        with pytest.raises(ValueError):
            dp_kernels.affine_launch_plan(8, Tpad, route="registers")
    if Tpad > dp_kernels.AFFINE_WIDE_REGS_MAX_T:
        with pytest.raises(ValueError):
            dp_kernels.affine_launch_plan(8, Tpad, route="wide_regs")
    else:
        assert dp_kernels.affine_launch_plan(8, Tpad, route="wide_regs").route == "wide_regs"
    if Tpad >= 1_816:
        with pytest.raises(ValueError):
            dp_kernels.affine_launch_plan(8, Tpad, route="wide_shared")


def _corpus():
    rng = np.random.default_rng(11)
    words = ["w" + "".join(chr(97 + int(c)) for c in rng.integers(0, 26, size=4))
             for _ in range(40)]
    mat = rng.normal(size=(len(words), 16)).astype(np.float32)
    texts = [" ".join(" ".join(rng.choice(words, size=int(rng.integers(3, 14)))) + "."
                      for _ in range(40)) for _ in range(3)]
    long_q = " ".join(rng.choice(words, size=129))
    queries = [long_q, " ".join(rng.choice(words, size=5)), " ".join(rng.choice(words, size=9))]
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


def _same_ranking(want, got, min_score):
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


@pytest.mark.parametrize("locality", ["local", "global"])
def test_long_query_find_and_find_batch_match_jax(both, locality):
    """A 129-token query (padded to 132) through find, and a find_batch that
    holds it (every needle padded to 132), against the JAX package; inside
    the port find and find_batch are byte-identical."""
    sj, st, queries = both
    if locality == "local":
        opt_j, opt_t = JaxLocal(), LocalAlignment()
    else:
        opt_j = JaxGlobal(JaxAffine(0.37, 0.113))
        opt_t = GlobalAlignment(AffineGapCost(0.37, 0.113))
    ij = sj.partition("sentence").index(JaxSpanSim(JaxTokenSim(sj.embeddings[0]), opt_j))
    it = st.partition("sentence").index(
        OptimizedSpanSim(EmbeddingTokenSim(st.embeddings[0]), opt_t))
    n, min_score = 5, -1.0 if locality == "global" else 0.05
    assert len(queries[0].split()) == 129
    finds = []
    for q in queries:
        got = _pairs(it.find(q, n=n, min_score=min_score))
        assert got, q
        _same_ranking(_pairs(ij.find(q, n=n, min_score=min_score)), got, min_score)
        finds.append(got)
    want_b = ij.find_batch(queries, n=n, min_score=min_score, sim_precision="float32")
    for prec in (None, "bfloat16", "float32"):
        got_b = [_pairs(r) for r in it.find_batch(queries, n=n, min_score=min_score,
                                                  sim_precision=prec)]
        for w, g in zip(want_b, got_b):
            _same_ranking(_pairs(w), g, min_score)
        assert got_b == finds, prec
