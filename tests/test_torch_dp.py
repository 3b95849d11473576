"""The port's affine DP (vectorian_tpu_torch.ops) against the JAX package.

Inputs come from a seeded numpy generator and go through both packages.
Max-plus DP is exact in any order as long as every add, subtract and
multiply happens in the same order, so the port is held to BIT equality:
its plain DP (the CPU path of the affine-DP kernel wrapper) against the
Pallas kernel in interpret mode and against the jnp scan.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tests.oracle import gotoh_align
from vectorian_tpu.ops.alignment import AffineGapParams as JaxGaps
from vectorian_tpu.ops.alignment import align_matrices_scores as jax_ams
from vectorian_tpu.ops.alignment import align_scores as jax_align_scores
from vectorian_tpu.ops.pallas_dp import pallas_align_scores_multi_nt
from vectorian_tpu_torch.ops import dp_kernels
from vectorian_tpu_torch.ops.alignment import (
    AffineGapParams,
    align_matrices,
    align_matrices_scores,
    traceback,
)

torch.set_num_threads(2)

LOCALITIES = ["local", "global", "semiglobal"]
# the last set has no short binary form, so it exercises rounding
GAPSETS = [
    (0.0, 0.0, 0.0, 0.0),
    (0.5, 0.1, 0.3, 0.2),
    (0.1, 0.4, 0.2, 0.6),
    (0.37, 0.113, 0.29, 0.071),
]


def _dp_inputs(seed, V, L, c, Tp, Q):
    rng = np.random.default_rng(seed)
    table = rng.uniform(-0.4, 1.0, size=(V, Tp, Q)).astype(np.float32)
    tok = rng.integers(0, V, size=(c, L)).astype(np.int32)
    len_s = rng.integers(0, L + 1, size=c).astype(np.int32)
    len_s[0], len_s[1] = 0, L  # an empty slice and a full one
    len_t = rng.integers(1, Tp + 1, size=Q).astype(np.int32)
    len_t[0] = Tp  # a needle of the full padded width
    return table, tok, len_s, len_t


def _port_scores(table, tok, len_s, len_t, gapset, locality):
    return dp_kernels.affine_dp_scores(
        torch.from_numpy(table),
        torch.from_numpy(tok),
        torch.from_numpy(len_s),
        torch.from_numpy(len_t),
        AffineGapParams.of(*gapset),
        locality,
    ).numpy()


@pytest.mark.parametrize("Q", [1, 3, 128])
@pytest.mark.parametrize("gapset", GAPSETS)
@pytest.mark.parametrize("locality", LOCALITIES)
def test_plain_dp_bit_equal_to_pallas_and_jnp(locality, gapset, Q):
    # c = 20 slices: not a multiple of the Pallas kernel's 8-slice block
    V, L, c, Tp = 37, 11, 20, 8
    table, tok, len_s, len_t = _dp_inputs(Q, V, L, c, Tp, Q)
    got = _port_scores(table, tok, len_s, len_t, gapset, locality)
    assert got.shape == (c, Q) and got.dtype == np.float32

    S = table[tok.T]  # [L, c, Tp, Q], the JAX corpus pass's gather
    ln1 = np.maximum(len_s, 1)  # the corpus pass clamps len_s
    gaps = JaxGaps.of(*gapset)
    want_pallas = np.asarray(
        pallas_align_scores_multi_nt(
            jnp.asarray(S), jnp.asarray(ln1), jnp.asarray(len_t), gaps,
            locality, interpret=True,
        )
    )
    S2 = np.transpose(S, (1, 3, 0, 2)).reshape(c * Q, L, Tp)
    want_jnp = np.asarray(
        jax_align_scores(S2, np.repeat(ln1, Q), np.tile(len_t, c), gaps, locality)
    ).reshape(c, Q)
    assert np.array_equal(got, want_pallas)
    assert np.array_equal(got, want_jnp)


@pytest.mark.parametrize("gapset", GAPSETS)
@pytest.mark.parametrize("locality", LOCALITIES)
def test_align_matrices_scores_bit_equal(locality, gapset):
    rng = np.random.default_rng(7)
    B, Ls, Lt = 9, 7, 6
    S = rng.uniform(-0.4, 1.0, size=(B, Ls, Lt)).astype(np.float32)
    len_s = rng.integers(1, Ls + 1, size=B).astype(np.int32)
    len_t = rng.integers(1, Lt + 1, size=B).astype(np.int32)
    H, E, F, raw = align_matrices_scores(
        torch.from_numpy(S), torch.from_numpy(len_s), torch.from_numpy(len_t),
        AffineGapParams.of(*gapset), locality,
    )
    want = jax_ams(S, len_s, len_t, JaxGaps.of(*gapset), locality)
    for got_x, want_x in zip((H, E, F, raw), want):
        assert np.array_equal(got_x.numpy(), np.asarray(want_x))


@pytest.mark.parametrize("locality", LOCALITIES)
def test_matrices_and_traceback_vs_oracle(locality):
    """The port's H matches the scalar Gotoh oracle, and (local) the
    traceback's mapping re-scores to the oracle's optimum."""
    rng = np.random.default_rng(3)
    os_, es, ot, et = 0.5, 0.2, 0.4, 0.15
    gaps = AffineGapParams.of(os_, es, ot, et)
    B, Ls, Lt = 6, 10, 5
    S = rng.uniform(-0.3, 1.0, size=(B, Ls, Lt)).astype(np.float32)
    H, _, _ = align_matrices(torch.from_numpy(S), gaps, locality)
    H = H.numpy()
    for b in range(B):
        score, H_ref, _, _ = gotoh_align(
            S[b].astype(np.float64), os_, es, ot, et, locality
        )
        np.testing.assert_allclose(H[b], H_ref, atol=1e-5)
        mapping = traceback(H[b], S[b], Ls, Lt, gaps, locality)
        matched = np.flatnonzero(mapping >= 0)
        tgts = mapping[matched]
        assert (np.diff(tgts) > 0).all()  # injective, order-preserving
        if locality != "local":
            continue
        # re-score the path: matched sims minus the gaps between matches
        # (a gap of k costs open + (k-1) * min(open, extend): Gotoh may
        # re-open a gap mid-run)
        implied = float(sum(S[b][mapping[j], j] for j in matched))
        for (j0, j1) in zip(matched[:-1], matched[1:]):
            di = mapping[j1] - mapping[j0] - 1
            dj = j1 - j0 - 1
            if di:
                implied -= os_ + (di - 1) * min(os_, es)
            if dj:
                implied -= ot + (dj - 1) * min(ot, et)
        assert implied == pytest.approx(score, abs=1e-5)


_PTXAS_REPORT = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_116affine_dp_kernelILi9ELi0ELb0ELb1EEEvPKf' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_116affine_dp_kernelILi9ELi0ELb0ELb1EEEvPKf
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 72 registers, used 0 barriers, 428 bytes cmem[0]
ptxas info    : Compile time = 12.345 ms
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_116affine_dp_kernelILi129ELi2ELb1ELb0EEEvPKf' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_116affine_dp_kernelILi129ELi2ELb1ELb0EEEvPKf
    952 bytes stack frame, 1604 bytes spill stores, 952 bytes spill loads
ptxas info    : Used 255 registers, used 0 barriers, 428 bytes cmem[0]
"""


def test_ptxas_entries_reads_registers_stack_and_spills():
    """The report parser chip_smoke.py's stack-frame and spill gate reads."""
    got = dp_kernels.ptxas_entries(_PTXAS_REPORT)
    assert got == {
        "_ZN12_GLOBAL__N_116affine_dp_kernelILi9ELi0ELb0ELb1EEEvPKf": {
            "registers": 72, "stack": 0, "spill_stores": 0, "spill_loads": 0,
        },
        "_ZN12_GLOBAL__N_116affine_dp_kernelILi129ELi2ELb1ELb0EEEvPKf": {
            "registers": 255, "stack": 952, "spill_stores": 1604,
            "spill_loads": 952,
        },
    }
    assert dp_kernels.ptxas_entries("") == {}
