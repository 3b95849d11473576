"""The dense DP entries' launch plans, forced routes and launch counters,
and the entries on the CPU against the JAX package, at the contextual and
tree passes' shapes (a [c, L, Tpad, Q] block of L 16, Tpad 8: Q = 32 for
find_batch, Q = 1 for find).

- ``affine_dense_plan`` / ``wsb_launch_plan``: the route each picks at the
  paths' chunks (``search.ctx_chunk``) and the launch's grid, the affine
  plan's problem threshold;
- a forced ``_route`` is accepted or refused (ValueError) by the plan and
  by the wrapper, on the CPU too;
- every route a plan names has its counter in ``AFFINE_ROUTE_LAUNCHES`` /
  ``WSB_ROUTE_LAUNCHES``, and the CPU's plain version counts no launch;
- ``affine_dp_scores_dense`` / ``wsb_dp_scores_dense`` on the CPU against
  ``vectorian_tpu.ops.alignment.align_scores`` / ``align_scores_general``
  on the same flattened problems (problem s * Q + q, len_s clamped to >= 1),
  a seeded numpy block at Q 32 and Q 1, three localities: BIT for bit.
"""

import numpy as np
import pytest
import torch

from vectorian_tpu.ops.alignment import AffineGapParams as JaxGaps
from vectorian_tpu.ops.alignment import align_scores as jax_align_scores
from vectorian_tpu.ops.alignment import align_scores_general as jax_align_scores_general
from vectorian_tpu_torch.ops import dp_kernels
from vectorian_tpu_torch.ops.alignment import AffineGapParams, gap_cost_closure
from vectorian_tpu_torch.ops.search import ctx_chunk

torch.set_num_threads(2)

LOCALITIES = ["local", "global", "semiglobal"]
AFFINE_GAPSETS = [(0.0, 0.0, 0.0, 0.0), (0.37, 0.113, 0.29, 0.071)]
# the contextual pass's chunk: bucket capacity 16, needles padded to 8,
# d = 256 (chip_smoke.py 4f / 4h)
L, TPAD, DIM = 16, 8, 256


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _block(seed, c, L, Tp, Q):
    """A seeded [c, L, Tp, Q] f32 block and its lengths (an empty slice, a
    full one; a full needle and, where Q > 1, a one-token one)."""
    rng = np.random.default_rng(seed)
    S = rng.uniform(-0.4, 1.0, size=(c, L, Tp, Q)).astype(np.float32)
    len_s = rng.integers(0, L + 1, size=c).astype(np.int32)
    len_s[:2] = (0, L)
    len_t = rng.integers(1, Tp + 1, size=Q).astype(np.int32)
    len_t[0] = Tp
    if Q > 1:
        len_t[1] = 1
    return S, len_s, len_t


def _flat(S, len_s, len_t):
    """The block's problems as the JAX contextual batch flattens them."""
    c, L, Tp, Q = S.shape
    return (S.transpose(0, 3, 1, 2).reshape(c * Q, L, Tp),
            np.repeat(np.maximum(len_s, 1), Q), np.tile(len_t, c))


def _wsb_costs(L, Tp, kind):
    """w_s, w_t and the closure of w_t: ExponentialGapCost(3.0)'s costs,
    or a gap bonus (a negative closure: no register route takes it)."""
    k = np.arange(max(L, Tp) + 1, dtype=np.float32)
    if kind == "exp":
        w = (1.0 - np.power(2.0, -k / 3.0)).astype(np.float32)
    else:
        w = (-0.05 * k).astype(np.float32)
    w_s, w_t = w[: L + 1].copy(), w[: Tp + 1].copy()
    return w_s, w_t, gap_cost_closure(_t(w_t)).numpy()


# ---- plans ------------------------------------------------------------------


def test_path_chunks_are_the_plans_shapes():
    """The batch's chunk is 2,048 slices of 32 queries, the find's 8,192
    slices of one: the shapes the plans below are read at."""
    assert ctx_chunk(L, TPAD, 32, DIM) == 2_048
    assert ctx_chunk(L, TPAD, 1, DIM) == 8_192


@pytest.mark.parametrize("c,Q,vec,route", [
    (2_048, 32, False, "registers"),   # find_batch's chunk: a thread a problem
    (8_192, 1, True, "lanes"),         # find's chunk: a group of lanes a problem
    (8_192, 1, False, "lanes"),
    (256, 32, False, "lanes"),         # a bucket's short last chunk
    (1_024, 32, False, "registers"),
    (40, 1, True, "lanes"),
])
def test_affine_dense_plan_at_path_shapes(c, Q, vec, route):
    plan = dp_kernels.affine_dense_plan(c, L, TPAD, Q, vec)
    assert plan.route == route
    assert "dense_" + plan.route in dp_kernels.AFFINE_ROUTE_LAUNCHES
    problems = c * Q
    if route == "lanes":
        G = dp_kernels.lane_group_width(TPAD)
        assert plan.threads == dp_kernels.AFFINE_REG_THREADS
        assert plan.blocks * (plan.threads // G) >= problems
        assert (plan.blocks - 1) * (plan.threads // G) < problems
    else:
        assert plan == dp_kernels.affine_launch_plan(
            problems, TPAD, reg_max_t=dp_kernels.AFFINE_DENSE_REG_MAX_T)


@pytest.mark.parametrize("Tpad,Q,route", [
    (16, 1, "lanes"), (32, 1, "lanes"), (33, 32, "wide_regs"), (64, 32, "wide_regs"),
    (40, 1, "wide_regs"),
])
def test_affine_dense_plan_past_the_lanes(Tpad, Q, route):
    """The lane route ends at 32 columns (a column a lane, a group of at
    most a warp); wider needles keep the gather entry's routes, the float4
    register rows at Q = 1 up to 64 columns."""
    plan = dp_kernels.affine_dense_plan(64, L, Tpad, Q)
    assert plan.route == route
    assert dp_kernels.affine_dense_plan(64, L, 40, 1, vec=True).route == "registers"
    assert dp_kernels.affine_dense_plan(64, 33, 8, 1).route == "registers"


def test_affine_dense_plan_threshold():
    """"lanes" up to AFFINE_DENSE_LANES_MAX_PROBLEMS problems, whatever
    their split into slices and queries; one more takes the register
    route."""
    most = dp_kernels.AFFINE_DENSE_LANES_MAX_PROBLEMS
    for Q in (1, 32):
        assert dp_kernels.affine_dense_plan(most // Q, L, TPAD, Q).route == "lanes"
        assert dp_kernels.affine_dense_plan(most // Q + 1, L, TPAD, Q).route == "registers"


@pytest.mark.parametrize("c,Lc,T,Q,registers,route", [
    (2_048, 16, 8, 32, True, "registers"),  # find_batch's chunk: the lane groups
    (8_192, 16, 8, 1, True, "registers"),   # find's chunk
    (1_024, 16, 8, 32, True, "registers"),  # a short last chunk
    (4_096, 8, 8, 32, True, "registers"),
    (2_048, 32, 8, 32, True, "registers"),
    (1_024, 16, 16, 32, True, "registers"),
    (256, 32, 32, 32, True, "registers"),
    (2_048, 16, 8, 32, False, "shared"),    # a negative closure
    (512, 64, 8, 32, True, "long"),         # past the register shapes
    (512, 128, 8, 32, True, "long"),
    (2_048, 256, 16, 1, True, "long"),
    (512, 64, 40, 32, True, "wide"),        # past the lane routes' needles
    (512, 64, 40, 32, False, "wide"),       # ... any closure
    (512, 64, 256, 32, True, "scratch"),    # past the wide route's shared memory
    (512, 512, 8, 32, True, "scratch"),     # past the long route's buckets
])
def test_wsb_dense_plan_at_path_shapes(c, Lc, T, Q, registers, route):
    """The WSB dense entry takes the gather entry's plan on its c * Q
    problems: two queries a lane group where Q is even on the register
    route, one on the long route, a warp a problem on the wide route."""
    plan = dp_kernels.wsb_launch_plan(c * Q, Lc, T, registers=registers, Q=Q)
    assert plan.route == route
    assert "dense_" + plan.route in dp_kernels.WSB_ROUTE_LAUNCHES
    G = dp_kernels.lane_group_width(T)
    if route == "registers":
        groups = c * Q // 2 if Q % 2 == 0 else c * Q
        assert plan.threads == dp_kernels.WSB_REG_THREADS
        assert plan.blocks == -(-groups * G // plan.threads)
    elif route == "long":
        assert plan.blocks == -(-c * Q * G // plan.threads)
        assert plan.smem == dp_kernels.wsb_long_smem(Lc, plan.threads)
    elif route == "wide":
        assert plan.blocks == -(-c * Q // (plan.threads // 32))
        assert plan.smem == dp_kernels.wsb_wide_smem(Lc, T, plan.threads // 32)


# ---- forced routes ----------------------------------------------------------


@pytest.mark.parametrize("route,Lc,Tpad,ok", [
    ("lanes", 16, 8, True), ("lanes", 32, 32, True), ("lanes", 33, 8, False),
    ("lanes", 16, 33, False), ("registers", 16, 8, True), ("registers", 16, 40, False),
    ("wide_regs", 16, 8, True), ("wide_shared", 16, 8, True), ("wide_scratch", 16, 8, True),
    ("threads", 16, 8, False), ("nowhere", 16, 8, False),
])
def test_affine_forced_route_accepted_or_refused(route, Lc, Tpad, ok):
    """A forced route the plan refuses raises in the wrapper as well, on
    the CPU too; one it takes returns the plain version's scores."""
    S, len_s, len_t = _block(3, 5, Lc, Tpad, 2)
    gaps = AffineGapParams.of(*AFFINE_GAPSETS[1])
    args = (_t(S), _t(len_s), _t(len_t), gaps, "local")
    if ok:
        assert dp_kernels.affine_dense_plan(5, Lc, Tpad, 2, route=route).route == route
        got = dp_kernels.affine_dp_scores_dense(*args, _route=route)
        assert torch.equal(got, dp_kernels.affine_dp_scores_dense_reference(*args))
    else:
        with pytest.raises(ValueError):
            dp_kernels.affine_dense_plan(5, Lc, Tpad, 2, route=route)
        with pytest.raises(ValueError):
            dp_kernels.affine_dp_scores_dense(*args, _route=route)


@pytest.mark.parametrize("route,Lc,T,kind,ok", [
    ("threads", 16, 8, "exp", False), ("threads", 8, 8, "exp", False),
    ("threads", 16, 8, "bonus", False), ("lanes", 16, 8, "exp", False),
    ("registers", 16, 8, "exp", True), ("registers", 32, 32, "exp", True),
    ("registers", 64, 8, "exp", False), ("registers", 16, 8, "bonus", False),
    ("shared", 16, 8, "bonus", True), ("scratch", 64, 8, "exp", True),
    ("wide_regs", 16, 8, "exp", False),
    ("long", 64, 8, "exp", True), ("long", 16, 8, "exp", True),
    ("long", 64, 8, "bonus", False), ("long", 64, 40, "exp", False),
])
def test_wsb_forced_route_accepted_or_refused(route, Lc, T, kind, ok):
    S, len_s, len_t = _block(4, 5, Lc, T, 2)
    w_s, w_t, w_ts = _wsb_costs(Lc, T, kind)
    vecs = (_t(w_s), _t(w_t), _t(w_ts))
    args = (_t(S), _t(len_s), _t(len_t), *vecs, "local")
    registers = kind == "exp"
    if ok:
        assert dp_kernels.wsb_launch_plan(10, Lc, T, registers, route=route, Q=2).route == route
        got = dp_kernels.wsb_dp_scores_dense(*args, host_costs=vecs, _route=route)
        assert torch.equal(got, dp_kernels.wsb_dp_scores_dense_reference(*args))
    else:
        with pytest.raises(ValueError):
            dp_kernels.wsb_launch_plan(10, Lc, T, registers, route=route, Q=2)
        with pytest.raises(ValueError):
            dp_kernels.wsb_dp_scores_dense(*args, host_costs=vecs, _route=route)


# ---- launch counters --------------------------------------------------------


def test_dense_routes_have_counters_and_cpu_counts_nothing():
    for route in ("lanes", "registers", "wide_regs", "wide_shared", "wide_scratch"):
        assert "dense_" + route in dp_kernels.AFFINE_ROUTE_LAUNCHES
    for route in ("registers", "shared", "scratch"):
        assert "dense_" + route in dp_kernels.WSB_ROUTE_LAUNCHES
    for counts in (dp_kernels.LAUNCHES, dp_kernels.AFFINE_ROUTE_LAUNCHES,
                   dp_kernels.WSB_ROUTE_LAUNCHES):
        counts[next(iter(counts))] += 3
    dp_kernels.reset_launches()
    assert not any(dp_kernels.LAUNCHES.values())
    assert not any(dp_kernels.AFFINE_ROUTE_LAUNCHES.values())
    assert not any(dp_kernels.WSB_ROUTE_LAUNCHES.values())
    S, len_s, len_t = _block(5, 6, L, TPAD, 32)
    dp_kernels.affine_dp_scores_dense(_t(S), _t(len_s), _t(len_t),
                                      AffineGapParams.of(*AFFINE_GAPSETS[0]), "local")
    vecs = tuple(_t(w) for w in _wsb_costs(L, TPAD, "exp"))
    dp_kernels.wsb_dp_scores_dense(_t(S), _t(len_s), _t(len_t), *vecs, "local",
                                   host_costs=vecs)
    assert dp_kernels.LAUNCHES["affine_dp[dense]"] == 0
    assert dp_kernels.LAUNCHES["wsb_dp[dense]"] == 0
    assert not any(dp_kernels.AFFINE_ROUTE_LAUNCHES.values())
    assert not any(dp_kernels.WSB_ROUTE_LAUNCHES.values())


# ---- the entries against the JAX package --------------------------------------


@pytest.mark.parametrize("Q,c", [(32, 6), (1, 48)])
@pytest.mark.parametrize("locality", LOCALITIES)
def test_affine_dense_equals_jax_align_scores(locality, Q, c):
    S, len_s, len_t = _block(10 + Q, c, L, TPAD, Q)
    S2, ln, lt = _flat(S, len_s, len_t)
    for gs in AFFINE_GAPSETS:
        got = dp_kernels.affine_dp_scores_dense(
            _t(S), _t(len_s), _t(len_t), AffineGapParams.of(*gs), locality).numpy()
        want = np.asarray(jax_align_scores(S2, ln, lt, JaxGaps.of(*gs), locality))
        assert got.shape == (c, Q) and got.dtype == np.float32
        assert np.array_equal(got, want.reshape(c, Q)), gs


@pytest.mark.parametrize("Q,c", [(32, 6), (1, 48)])
@pytest.mark.parametrize("locality", LOCALITIES)
def test_wsb_dense_equals_jax_align_scores_general(locality, Q, c):
    S, len_s, len_t = _block(20 + Q, c, L, TPAD, Q)
    S2, ln, lt = _flat(S, len_s, len_t)
    for kind in ("exp", "bonus"):
        w_s, w_t, w_ts = _wsb_costs(L, TPAD, kind)
        vecs = (_t(w_s), _t(w_t), _t(w_ts))
        got = dp_kernels.wsb_dp_scores_dense(
            _t(S), _t(len_s), _t(len_t), *vecs, locality, host_costs=vecs).numpy()
        want = np.asarray(jax_align_scores_general(S2, ln, lt, w_s, w_t, locality))
        assert got.shape == (c, Q)
        assert np.array_equal(got, want.reshape(c, Q)), kind
