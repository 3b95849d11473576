"""The port's general-gap (Waterman-Smith-Beyer) DP and the flat-batch DP
entries against the JAX package.

Inputs come from a seeded numpy generator and go through both packages.
The WSB DP is adds, subtractions and maxes only, so the port is held to BIT
equality: its scans against the jnp scans, and the plain versions of the
kernel wrappers (their CPU path) against the Pallas kernels in interpret
mode and the jnp scans.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vectorian_tpu.ops.alignment import AffineGapParams as JaxGaps
from vectorian_tpu.ops.alignment import align_matrices_general as jax_amg
from vectorian_tpu.ops.alignment import align_matrices_scores_general as jax_amsg
from vectorian_tpu.ops.alignment import align_scores as jax_align_scores
from vectorian_tpu.ops.alignment import align_scores_general as jax_asg
from vectorian_tpu.ops.alignment import gap_cost_closure as jax_closure
from vectorian_tpu.ops.alignment import traceback_general as jax_traceback_general
from vectorian_tpu.ops.pallas_dp import pallas_align_scores, pallas_align_scores_general
from vectorian_tpu.ops.search import gap_vec as jax_gap_vec
from vectorian_tpu_torch.alignment import CustomGapCost, ExponentialGapCost
from vectorian_tpu_torch.corpus.packing import DEFAULT_BUCKETS
from vectorian_tpu_torch.ops import dp_kernels
from vectorian_tpu_torch.ops.search import GeneralGaps
from vectorian_tpu_torch.ops.alignment import (
    AffineGapParams,
    align_matrices_general,
    align_matrices_scores_general,
    align_scores_general,
    gap_cost_closure,
    traceback_general,
)

torch.set_num_threads(2)

LOCALITIES = ["local", "global", "semiglobal"]
KINDS = ["exp", "rand"]
AFFINE_GAPSETS = [(0.0, 0.0, 0.0, 0.0), (0.37, 0.113, 0.29, 0.071)]


def _gap_vec(rng, n1, kind):
    """ExponentialGapCost(3.0)'s costs, or a seeded random non-decreasing
    vector (not subadditive: its closure differs from it)."""
    if kind == "exp":
        k = np.arange(n1, dtype=np.float32)
        return (1.0 - np.power(2.0, -k / 3.0)).astype(np.float32)
    w = np.sort(rng.uniform(0, 1.5, size=n1)).astype(np.float32)
    w[0] = 0.0
    return w


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _flat_inputs(seed, B, L, T):
    rng = np.random.default_rng(seed)
    S = rng.uniform(-0.4, 1.0, size=(B, L, T)).astype(np.float32)
    len_s = rng.integers(0, L + 1, size=B).astype(np.int32)
    len_s[0], len_s[1] = 0, L  # a zero-length problem and a full one
    len_t = rng.integers(1, T + 1, size=B).astype(np.int32)
    len_t[2] = T
    return rng, S, len_s, len_t


@pytest.mark.parametrize("widths", [(5, 9), (9, 33), (256, 257)])
def test_gap_cost_closure_bit_equal_and_prefix_stable(widths):
    a, b = widths
    rng = np.random.default_rng(a)
    base = np.cumsum(rng.uniform(0, 0.3, size=b + 1)).astype(np.float32)
    base[0] = 0.0
    base[3::4] += 1.0  # not subadditive: the closure tightens entries
    got_a = gap_cost_closure(_t(base[: a + 1])).numpy()
    got_b = gap_cost_closure(_t(base[: b + 1])).numpy()
    assert np.array_equal(got_a, np.asarray(jax_closure(jnp.asarray(base[: a + 1]))))
    assert np.array_equal(got_b, np.asarray(jax_closure(jnp.asarray(base[: b + 1]))))
    assert np.array_equal(got_a, got_b[: a + 1])
    assert (got_b <= base[: b + 1]).all() and (got_b < base[: b + 1]).any()


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("locality", LOCALITIES)
def test_align_scores_general_bit_equal(locality, kind):
    rng, S, len_s, len_t = _flat_inputs(11, 13, 9, 6)
    w_s, w_t = _gap_vec(rng, 10, kind), _gap_vec(rng, 7, kind)
    args_j = (S, len_s, len_t, jnp.asarray(w_s), jnp.asarray(w_t), locality)
    args_t = (_t(S), _t(len_s), _t(len_t), _t(w_s), _t(w_t), locality)
    raw, pos = align_scores_general(*args_t, with_position=True)
    raw_j, pos_j = jax_asg(*args_j, with_position=True)
    assert np.array_equal(raw.numpy(), np.asarray(raw_j))
    assert np.array_equal(pos.numpy(), np.asarray(pos_j))
    H, raw2 = align_matrices_scores_general(*args_t)
    H_j, raw2_j = jax_amsg(*args_j)
    assert np.array_equal(H.numpy(), np.asarray(H_j))
    assert np.array_equal(raw2.numpy(), np.asarray(raw2_j))
    assert np.array_equal(raw2.numpy(), raw.numpy())
    assert np.array_equal(
        align_matrices_general(_t(S), _t(w_s), _t(w_t), locality).numpy(),
        np.asarray(jax_amg(S, jnp.asarray(w_s), jnp.asarray(w_t), locality)),
    )


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("locality", LOCALITIES)
def test_wsb_flat_plain_bit_equal_to_pallas_and_jnp(locality, kind):
    # B = 60: not a multiple of the Pallas kernel's 128-problem block
    B, L, T = 60, 7, 8
    rng, S, len_s, len_t = _flat_inputs(3, B, L, T)
    w_s, w_t = _gap_vec(rng, L + 1, kind), _gap_vec(rng, T + 1, kind)
    got = dp_kernels.wsb_dp_scores_flat(
        _t(S), _t(len_s), _t(len_t), _t(w_s), _t(w_t),
        gap_cost_closure(_t(w_t)), locality,
    ).numpy()
    assert got.shape == (B,) and got.dtype == np.float32
    args = (jnp.asarray(S), jnp.asarray(len_s), jnp.asarray(len_t),
            jnp.asarray(w_s), jnp.asarray(w_t), locality)
    assert np.array_equal(got, np.asarray(pallas_align_scores_general(*args, interpret=True)))
    assert np.array_equal(got, np.asarray(jax_asg(*args)))


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("locality", LOCALITIES)
def test_wsb_gather_plain_bit_equal_to_pallas_and_jnp(locality, kind):
    """The corpus-pass entry: the JAX corpus pass gathers table[tok],
    flattens it to [c * Q, L, Tp] and runs the WSB DP on it (Pallas on the
    TPU, the jnp scan on the CPU), len_s clamped to >= 1."""
    V, L, c, Tp, Q = 23, 7, 20, 8, 3
    rng = np.random.default_rng(17)
    table = rng.uniform(-0.4, 1.0, size=(V, Tp, Q)).astype(np.float32)
    tok = rng.integers(0, V, size=(c, L)).astype(np.int32)
    len_s = rng.integers(0, L + 1, size=c).astype(np.int32)
    len_s[0], len_s[1] = 0, L
    len_t = np.asarray([Tp, 3, 1], np.int32)
    w_s, w_t = _gap_vec(rng, L + 1, kind), _gap_vec(rng, Tp + 1, kind)
    vecs = (_t(w_s), _t(w_t), gap_cost_closure(_t(w_t)))
    got = dp_kernels.wsb_dp_scores(
        _t(table), _t(tok), _t(len_s), _t(len_t), *vecs, locality,
        host_costs=vecs,
    ).numpy()
    assert got.shape == (c, Q)
    S2 = np.transpose(table[tok], (0, 3, 1, 2)).reshape(c * Q, L, Tp)
    args = (jnp.asarray(S2), jnp.asarray(np.repeat(np.maximum(len_s, 1), Q)),
            jnp.asarray(np.tile(len_t, c)), jnp.asarray(w_s), jnp.asarray(w_t),
            locality)
    want_p = np.asarray(pallas_align_scores_general(*args, interpret=True))
    assert np.array_equal(got, want_p.reshape(c, Q))
    assert np.array_equal(got, np.asarray(jax_asg(*args)).reshape(c, Q))
    # a w_t* longer than the table's width (a wider batch's vector) is a
    # prefix-stable closure: same bits
    w_t_wide = np.concatenate([w_t, w_t[-1] + np.arange(1, 9, dtype=np.float32)])
    got_wide = dp_kernels.wsb_dp_scores(
        _t(table), _t(tok), _t(len_s), _t(len_t), _t(w_s), _t(w_t_wide),
        gap_cost_closure(_t(w_t_wide)), locality,
    ).numpy()
    assert np.array_equal(got, got_wide)


@pytest.mark.parametrize("gapset", AFFINE_GAPSETS)
@pytest.mark.parametrize("locality", LOCALITIES)
def test_affine_flat_plain_bit_equal_to_pallas_and_jnp(locality, gapset):
    # B = 300: not a multiple of the Pallas kernel's 256-problem block
    B, L, T = 300, 7, 8
    _, S, len_s, len_t = _flat_inputs(5, B, L, T)
    got = dp_kernels.affine_dp_scores_flat(
        _t(S), _t(len_s), _t(len_t), AffineGapParams.of(*gapset), locality
    ).numpy()
    assert got.shape == (B,) and got.dtype == np.float32
    gaps = JaxGaps.of(*gapset)
    args = (jnp.asarray(S), jnp.asarray(len_s), jnp.asarray(len_t))
    assert np.array_equal(got, np.asarray(
        pallas_align_scores(*args, gaps, locality, interpret=True)))
    assert np.array_equal(got, np.asarray(jax_align_scores(*args, gaps, locality)))


@pytest.mark.parametrize("locality", LOCALITIES)
def test_traceback_general_matches_jax(locality):
    rng = np.random.default_rng(29)
    B, Ls, Lt = 8, 9, 5
    S = rng.uniform(-0.3, 1.0, size=(B, Ls, Lt)).astype(np.float32)
    w_s, w_t = _gap_vec(rng, Ls + 1, "rand"), _gap_vec(rng, Lt + 1, "exp")
    H = align_matrices_general(_t(S), _t(w_s), _t(w_t), locality).numpy()
    for b in range(B):
        ls, lt = int(rng.integers(1, Ls + 1)), int(rng.integers(1, Lt + 1))
        got = traceback_general(H[b], S[b], ls, lt, w_s, w_t, locality)
        want = jax_traceback_general(H[b], S[b], ls, lt, w_s, w_t, locality)
        assert np.array_equal(got, want)
        assert (np.diff(got[got >= 0]) > 0).all()  # injective, in order


@pytest.mark.parametrize("T", [8, 16, 24, 32, 64, 128])
@pytest.mark.parametrize("L", list(DEFAULT_BUCKETS))
def test_wsb_launch_plan_serves_every_bucket_shape(L, T):
    """Each (capacity, width) has exactly one route: "registers" for the
    gather entry where its templates take the shape (every default bucket
    up to WSB_REG_MAX_L x needles up to WSB_REG_MAX_T), "long" for the
    buckets past it up to WSB_LONG_MAX_L against the same needles (lane
    groups, a block's column histories in shared memory), "wide" for
    needles past WSB_REG_MAX_T where a warp's column history leaves
    WSB_WIDE_MIN_WARPS warps resident an SM, else the thread-a-problem
    body: shared memory where blocks of rows keep WSB_MIN_RESIDENT threads
    resident an SM, else a scratch buffer sized to the threads in flight —
    never sized to all problems."""
    problems = 1_000_000 * 32 if L <= 32 else 1_000_000
    plan = dp_kernels.wsb_launch_plan(problems, L, T)
    rows = dp_kernels.wsb_launch_plan(problems, L, T, registers=False, wide=False)
    per = (L + 1) * (T + 1) * 4
    assert rows.route in ("shared", "scratch")
    G = dp_kernels.lane_group_width(T)
    if L <= dp_kernels.WSB_REG_MAX_L and T <= dp_kernels.WSB_REG_MAX_T:
        assert G in (8, 16, 32) and T <= G
        threads = dp_kernels.WSB_REG_THREADS
        assert plan == ("registers", -(-problems * G // threads), threads, 0, 0)
        assert dp_kernels.wsb_launch_plan(problems, L, T, route="registers") == plan
        # even Q: two queries of a slice a group, half the groups
        for Q in (2, 32):
            paired = dp_kernels.wsb_launch_plan(problems + Q, L, T, Q=Q)
            assert paired.blocks == -(-(problems + Q) // 2 * G // threads)
            assert paired.blocks * (threads // G) * 2 >= problems + Q
    elif L <= dp_kernels.WSB_LONG_MAX_L and T <= dp_kernels.WSB_REG_MAX_T:
        assert plan.route == "long" and plan.floats == 0 and T <= G
        assert plan.threads in (32, 64, 128) and plan.threads % G == 0
        assert plan.smem == dp_kernels.wsb_long_smem(L, plan.threads) <= dp_kernels.WSB_SMEM_MAX
        assert plan.blocks == -(-problems * G // plan.threads)
        # one problem a group whatever Q
        assert dp_kernels.wsb_launch_plan(problems, L, T, Q=32) == plan
        assert dp_kernels.wsb_launch_plan(problems, L, T, route="long") == plan
        with pytest.raises(ValueError, match="register route"):
            dp_kernels.wsb_launch_plan(problems, L, T, route="registers")
    elif dp_kernels.wsb_wide_shape(L, T):
        assert plan.route == "wide" and plan.floats == 0 and plan.threads in (32, 64, 128)
        assert plan.smem == dp_kernels.wsb_wide_smem(L, T, plan.threads // 32)
        assert plan.blocks == -(-problems // (plan.threads // 32))
        # any closure (no host costs needed) and any Q
        assert dp_kernels.wsb_launch_plan(problems, L, T, registers=False, Q=32) == plan
        with pytest.raises(ValueError, match="long route"):
            dp_kernels.wsb_launch_plan(problems, L, T, route="long")
    else:
        assert plan == rows
        with pytest.raises(ValueError, match="register route"):
            dp_kernels.wsb_launch_plan(problems, L, T, route="registers")
        with pytest.raises(ValueError, match="long route"):
            dp_kernels.wsb_launch_plan(problems, L, T, route="long")
        with pytest.raises(ValueError, match="wide route"):
            dp_kernels.wsb_launch_plan(problems, L, T, route="wide")
    # the thread-a-problem body: shared rows by the measured crossover
    resident = max(dp_kernels._resident(t * per, t) for t in (32, 64, 128))
    assert (rows.route == "shared") == (resident > 0 and (
        resident >= dp_kernels.WSB_MIN_RESIDENT or problems <= resident * dp_kernels.WSB_SMS))
    if rows.route == "shared":
        assert rows.floats == 0 and per * rows.threads == rows.smem
        assert rows.smem <= dp_kernels.WSB_SMEM_MAX
        assert rows.blocks * rows.threads >= problems
    else:
        assert rows.smem == 0 and rows.floats == rows.blocks * rows.threads * per // 4
        assert rows.floats * 4 <= dp_kernels.WSB_SCRATCH_MAX and rows.blocks >= 1
    # the row-gather entry: the same routes under "rows_" names, one problem
    # a lane group whatever Q (each has its own needle length)
    for Q in (1, 2, 32):
        got = dp_kernels.wsb_launch_plan(problems, L, T, Q=Q, rows=True)
        if plan.route in ("registers", "long", "wide"):
            assert got == ("rows_" + plan.route, plan.blocks, *plan[2:])
        else:
            assert got == ("rows_" + rows.route, *rows[1:])
    assert dp_kernels.wsb_launch_plan(problems, L, T, registers=False, wide=False,
                                      rows=True) == ("rows_" + rows.route, *rows[1:])
    scratch = dp_kernels.wsb_launch_plan(problems, L, T, route="scratch")
    assert scratch.route == "scratch" and scratch.floats > 0
    if per * 32 > dp_kernels.WSB_SMEM_MAX:
        with pytest.raises(ValueError, match="shared memory"):
            dp_kernels.wsb_launch_plan(problems, L, T, route="shared")


@pytest.mark.parametrize("L,T", [(16, 8), (32, 16), (64, 8), (64, 16), (128, 8), (16, 40)])
def test_wsb_shared_rows_by_the_measured_crossover(L, T):
    """The thread-a-problem body keeps its rows in shared memory where
    blocks of them keep WSB_MIN_RESIDENT threads resident an SM, or where
    the launch fits in one wave of resident blocks; past both, scratch."""
    per = (L + 1) * (T + 1) * 4
    resident, threads = max((dp_kernels._resident(t * per, t), t) for t in (128, 64, 32))
    wave = resident * dp_kernels.WSB_SMS
    for problems in (max(wave, 1), wave + 1, 65_536, 1_000_000):
        plan = dp_kernels.wsb_launch_plan(problems, L, T, registers=False, wide=False)
        shared = resident >= dp_kernels.WSB_MIN_RESIDENT or (0 < problems <= wave)
        assert plan.route == ("shared" if shared else "scratch"), problems
        if shared:
            assert plan.threads == threads and plan.blocks == -(-problems // threads)
            assert plan.blocks <= -(-wave // threads) or resident >= dp_kernels.WSB_MIN_RESIDENT


@pytest.mark.parametrize("L", [16, 64, 128, 256, 512])
@pytest.mark.parametrize("kind", ["exp", "bonus", "tagged"])
def test_wsb_lane_routes_refuse_negative_closures_and_tags(kind, L):
    """``_register_costs`` lets a launch onto the lane routes only with a
    closure w_t* >= 0 and, tagged, only at the register route's shapes (the
    long route has no tagged kernels); a negative closure (a gap bonus) and
    a tagged long bucket stay on the thread-a-problem body, and so does
    every bucket past WSB_LONG_MAX_L."""
    T = 8
    table = torch.zeros((5, T, 2))
    w = np.arange(max(L, T) + 1, dtype=np.float32) * (-0.05 if kind == "bonus" else 0.1)
    vecs = tuple(_t(w) for w in (w[: L + 1], w[: T + 1], w[: T + 1]))
    hs = dp_kernels._register_costs(L, T, table, vecs, vecs, tagged=kind == "tagged")
    lanes = (kind == "exp" and L <= dp_kernels.WSB_LONG_MAX_L) or (
        kind == "tagged" and L <= dp_kernels.WSB_REG_MAX_L)
    assert (hs is not None) == lanes
    plan = dp_kernels.wsb_launch_plan(64, L, T, registers=hs is not None, Q=2)
    if lanes:
        assert plan.route == ("registers" if L <= dp_kernels.WSB_REG_MAX_L else "long")
    else:
        assert plan.route in ("shared", "scratch")
        for route, says in (("registers", "register route"), ("long", "long route")):
            with pytest.raises(ValueError, match=says):
                dp_kernels.wsb_launch_plan(64, L, T, registers=hs is not None, route=route)


@pytest.mark.parametrize("capacity", [8, 16, 32, 64, 128, 256])
@pytest.mark.parametrize("kind", ["exp", "custom"])
def test_general_gaps_host_vecs_match_device_and_jax(kind, capacity):
    """The host copies the lane routes decide on (the register route passes
    them by value) are the device vectors' bits, and the JAX package's
    gap_vec / gap_cost_closure, at every capacity the lane routes take."""
    rng = np.random.default_rng(capacity)
    steps = np.cumsum(rng.uniform(0.0, 0.35, size=300)).astype(np.float32)
    cost = (ExponentialGapCost(3.0) if kind == "exp"
            else CustomGapCost(lambda k: float(steps[int(k)])))
    Tpad = 8 if capacity == 8 else 24
    gg = GeneralGaps((cost, cost), Tpad + 1, torch.device("cpu"))
    host, dev = gg.host_vecs(capacity), gg.vecs(capacity)
    for h, d in zip(host, dev):
        assert h.device.type == "cpu" and h.dtype == torch.float32
        assert np.array_equal(h.numpy(), d.cpu().numpy())
    w_s, w_t, w_t_star = (h.numpy() for h in host)
    assert w_s.shape == (capacity + 1,) and w_t.shape == (Tpad + 1,)
    assert np.array_equal(w_s, jax_gap_vec(cost, capacity + 1))
    assert np.array_equal(w_t, jax_gap_vec(cost, Tpad + 1))
    assert np.array_equal(w_t_star, np.asarray(jax_closure(jnp.asarray(w_t))))


@pytest.mark.parametrize("Q", [1, 3, 32])
def test_wsb_register_table_layout(Q):
    """The register route reads [V, Q, Tpad]: element (v, q, j) is the
    stacked table's (v, j, q), contiguous; at Q = 1 the same memory."""
    table = torch.from_numpy(
        np.random.default_rng(Q).uniform(size=(11, 8, Q)).astype(np.float32)
    )
    got = dp_kernels.wsb_register_table(table)
    assert got.shape == (11, Q, 8) and got.is_contiguous()
    assert torch.equal(got, table.permute(0, 2, 1))
    assert float(got[4, Q - 1, 5]) == float(table[4, 5, Q - 1])
    assert (got.data_ptr() == table.data_ptr()) == (Q == 1)


def test_wrappers_check_their_inputs():
    S = torch.zeros((4, 5, 3))
    ln = torch.ones(4, dtype=torch.int32)
    w = torch.zeros(6)
    with pytest.raises(ValueError, match="w_s"):
        dp_kernels.wsb_dp_scores_flat(S, ln, ln, w[:5], w, w, "local")
    with pytest.raises(ValueError, match="w_t"):
        dp_kernels.wsb_dp_scores_flat(S, ln, ln, w, w[:3], w, "local")
    with pytest.raises(ValueError, match="locality"):
        dp_kernels.wsb_dp_scores_flat(S, ln, ln, w, w, w, "sideways")
    # a tensor on neither the CPU nor a card never takes the plain version
    meta = S.to("meta")
    with pytest.raises(ValueError, match="device"):
        dp_kernels.wsb_dp_scores_flat(meta, ln, ln, w, w, w, "local")
    with pytest.raises(ValueError, match="device"):
        dp_kernels.affine_dp_scores_flat(
            meta, ln, ln, AffineGapParams.of(0, 0, 0, 0), "local"
        )
