"""Exact earth mover's distance on host (reference parity backend).

The reference uses pyemd's ``emd_hat_gd_metric<double>`` (vendored submodule,
vectorian/core/cpp/alignment/pyemd.h:11-17, transport.h:91-145) for full WMD
and WRD.  Here exact EMD is solved as a linear program with scipy's HiGHS —
used for (a) golden tests of the device transport ranking and (b) exact
re-scoring of the bound-ranked candidates (ops/wmd._emd_score_bound's
provable cut), so final scores AND top-k membership match the exact-EMD
reference while the corpus-wide ranking runs on the card.

emd_hat semantics for unbalanced problems: the lighter side receives a
virtual sink; moving mass to the sink costs ``extra_mass_penalty`` (or the
maximum distance in the matrix when penalty < 0).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np


class EMDResult(NamedTuple):
    cost: float
    flow: np.ndarray  # [n1, n2] transported mass (excluding sink)
    success: bool


def exact_emd(
    w1: np.ndarray,  # [n1] supply
    w2: np.ndarray,  # [n2] demand
    D: np.ndarray,  # [n1, n2] cost
    extra_mass_penalty: float = -1.0,
) -> EMDResult:
    w1 = np.asarray(w1, np.float64)
    w2 = np.asarray(w2, np.float64)
    D = np.asarray(D, np.float64)
    n1, n2 = D.shape

    s1, s2 = w1.sum(), w2.sum()
    if s1 <= 0 or s2 <= 0:
        return EMDResult(0.0, np.zeros((n1, n2)), False)

    penalty = float(extra_mass_penalty)
    if penalty < 0:
        penalty = float(D.max())

    # pad with a sink on the lighter side so the LP is balanced
    extra = abs(s1 - s2)
    if s1 < s2 - 1e-12:
        w1p = np.concatenate([w1, [extra]])
        w2p = w2
        Dp = np.vstack([D, np.full((1, n2), penalty)])
    elif s2 < s1 - 1e-12:
        w1p = w1
        w2p = np.concatenate([w2, [extra]])
        Dp = np.hstack([D, np.full((n1, 1), penalty)])
    else:
        w1p, w2p, Dp = w1, w2, D

    # native successive-shortest-path solver first (a scipy HiGHS LP costs
    # ~ms per candidate in setup alone; the SSP solve is ~µs at these
    # sizes) — same optimal cost, one deterministic optimal flow vertex
    from vectorian_tpu_torch import native

    r = native.emd(w1p, w2p, Dp)
    if r is not None:
        G = r[0][:n1, :n2]
        return EMDResult(float(np.sum(G * D)), G, True)

    from scipy.optimize import linprog
    from scipy.sparse import lil_matrix

    m1, m2 = Dp.shape
    c = Dp.reshape(-1)

    A = lil_matrix((m1 + m2, m1 * m2))
    for i in range(m1):
        A[i, i * m2 : (i + 1) * m2] = 1.0
    for j in range(m2):
        A[m1 + j, j::m2] = 1.0
    b = np.concatenate([w1p, w2p])

    res = linprog(c, A_eq=A.tocsr(), b_eq=b, bounds=(0, None), method="highs")
    if not res.success:
        return EMDResult(0.0, np.zeros((n1, n2)), False)
    G = res.x.reshape(m1, m2)[:n1, :n2]
    cost = float(np.sum(G * D))
    return EMDResult(cost, G, True)


def emd_score(w1, w2, D, extra_mass_penalty=-1.0) -> tuple:
    """Reference FullSolver scoring: score = sum((1-D)*G) / sum(G)
    (vectorian/core/cpp/alignment/wmd.h:252)."""
    r = exact_emd(w1, w2, D, extra_mass_penalty)
    return _score_of(r, D), r


def _score_of(r: EMDResult, D) -> float:
    if not r.success or r.flow.sum() <= 0:
        return 0.0
    return float(np.sum((1.0 - np.asarray(D)) * r.flow) / r.flow.sum())


def exact_emd_batch(specs) -> list:
    """Batched ``exact_emd``: ONE threaded native vn_emd_batch call over
    all problems (the transport serving batch rescores hundreds of small
    independent candidates per consume round — a python-loop of per-call
    solves ran single-threaded), with the identical per-problem sink
    padding and the scipy fallback per rejected problem.  Same SSP
    routine as exact_emd, so flows and costs are bit-identical to the
    sequential path.  ``specs``: [(w1, w2, D, extra_mass_penalty)]."""
    from vectorian_tpu_torch import native

    n = len(specs)
    results = [None] * n
    padded, idxs, metas = [], [], []
    for i, (w1, w2, D, emp) in enumerate(specs):
        w1 = np.asarray(w1, np.float64)
        w2 = np.asarray(w2, np.float64)
        D = np.asarray(D, np.float64)
        n1, n2 = D.shape
        s1, s2 = w1.sum(), w2.sum()
        if s1 <= 0 or s2 <= 0:
            results[i] = EMDResult(0.0, np.zeros((n1, n2)), False)
            continue
        penalty = float(emp)
        if penalty < 0:
            penalty = float(D.max())
        if s1 < s2 - 1e-12:
            w1p = np.concatenate([w1, [abs(s1 - s2)]])
            w2p = w2
            Dp = np.vstack([D, np.full((1, n2), penalty)])
        elif s2 < s1 - 1e-12:
            w1p = w1
            w2p = np.concatenate([w2, [abs(s1 - s2)]])
            Dp = np.hstack([D, np.full((n1, 1), penalty)])
        else:
            w1p, w2p, Dp = w1, w2, D
        padded.append((w1p, w2p, Dp))
        idxs.append(i)
        metas.append((n1, n2, D))
    if padded:
        res = native.emd_batch(padded)
        if res is None:
            res = [None] * len(padded)
        for i, (n1, n2, D), r in zip(idxs, metas, res):
            if r is None:
                w1, w2, _, emp = specs[i]
                results[i] = exact_emd(w1, w2, D, emp)
            else:
                G = r[0][:n1, :n2]
                results[i] = EMDResult(float(np.sum(G * D)), G, True)
    return results


def emd_score_batch(specs) -> list:
    """Batched ``emd_score``: [(score, EMDResult)] per
    (w1, w2, D, extra_mass_penalty) spec."""
    return [
        (_score_of(r, spec[2]), r)
        for r, spec in zip(exact_emd_batch(specs), specs)
    ]
