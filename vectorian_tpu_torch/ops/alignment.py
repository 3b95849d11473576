"""Batched affine-gap sequence-alignment DP in torch.

Counterpart of vectorian_tpu/ops/alignment.py (affine subset): the
reference's per-slice pyalign solvers (vectorian/core/cpp/metric/
alignment.h:242-304) become one batched scan over document-token rows,
every (slice x query) problem a row of the batch axis.

Gotoh recurrence with ``H = max(C, E)``, ``C = max(diag, F[, 0 if local])``
and the horizontal gap ``E`` as a decayed prefix maximum solved by doubling
(``_decayed_prefix_max``).  The op order is the JAX package's, step for
step — ``- decay * shift`` in the doubling, ``NEG`` padding, boundary costs
``-(open + (i - 1) * extend)`` as one fused multiply-add — so f32 results
are bit-equal to it.  This scan is the CPU path of the port and the plain
version of the affine DP kernel (ops/dp_kernels.py); on the card it serves
the small top-k rescore batches, which also need the full H matrix for the
traceback.

Localities (reference metric/alignment.h:803-814): ``local`` (zero floor,
max over all cells), ``global`` (H[len_s, len_t]) and ``semiglobal`` (max
over the last row and last column).  Gap parameters are host scalars, so
changing them never rebuilds anything.
"""

from __future__ import annotations

import functools
from fractions import Fraction
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

NEG = -1e30

LOCAL = "local"
GLOBAL = "global"
SEMIGLOBAL = "semiglobal"
LOCALITIES = (LOCAL, GLOBAL, SEMIGLOBAL)


class AffineGapParams(NamedTuple):
    """Affine gap parameters per side; cost(k) = open + extend * (k-1).

    ``s`` is the document side (gap = unaligned document token), ``t`` the
    query side (reference vectorian/alignment.py:78-97 {'s':..,'t':..}).
    Entries are host ``np.float32`` scalars: the finalizer reads them per
    survivor (native traceback), which must never cost a device read.
    """

    open_s: np.float32
    extend_s: np.float32
    open_t: np.float32
    extend_t: np.float32

    @staticmethod
    def of(open_s, extend_s, open_t, extend_t) -> "AffineGapParams":
        return AffineGapParams(
            *(np.float32(float(g)) for g in (open_s, extend_s, open_t, extend_t))
        )


def _gap_scalars(gaps, device):
    """The four gap costs as 0-d f32 tensors on ``device`` (every DP op
    then runs in f32, like the JAX package's traced scalars)."""
    return tuple(
        torch.tensor(float(g), dtype=torch.float32, device=device) for g in gaps
    )


def _round_f32(x: Fraction) -> np.float32:
    """The f32 nearest to the exact rational ``x`` (ties to even)."""
    f = np.float32(float(x))
    cands = (
        np.nextafter(f, np.float32(-np.inf)), f,
        np.nextafter(f, np.float32(np.inf)),
    )
    return min(
        cands,
        key=lambda c: (abs(Fraction(float(c)) - x), int(c.view(np.uint32)) & 1),
    )


@functools.lru_cache(maxsize=256)
def _gap_run_costs(open_: float, extend_: float, n: int) -> tuple:
    """(cost(1), ..., cost(n)), cost(k) = open + (k - 1) * extend rounded
    ONCE to f32 — a fused multiply-add.  The JAX package's boundary costs
    compile (XLA CPU) to exactly that FMA, and the global DP's boundary
    must match it bit for bit; the CUDA kernel uses __fmaf_rn."""
    o, e = Fraction(open_), Fraction(extend_)
    return tuple(float(_round_f32(o + (k - 1) * e)) for k in range(1, n + 1))


def _boundary_costs(n1: int, open_, extend_, device) -> torch.Tensor:
    """[0, cost(1), cost(2), ...] of length n1 (cost(k)=open+(k-1)*extend)."""
    costs = np.zeros((n1,), np.float32)
    costs[1:] = _gap_run_costs(float(open_), float(extend_), n1 - 1)
    return torch.from_numpy(costs).to(device)


def _decayed_prefix_max(x: torch.Tensor, decay: torch.Tensor) -> torch.Tensor:
    """out[..., j] = max_{k<=j} (x[..., k] - decay * (j - k)).

    Exact associative doubling: log2(n) vector steps.
    """
    n = x.shape[-1]
    out = x
    shift = 1
    while shift < n:
        shifted = F.pad(out[..., :-shift], (shift, 0), value=NEG)
        out = torch.maximum(out, shifted - decay * shift)
        shift *= 2
    return out


def _scan(similarity, len_s, len_t, gaps, locality, with_matrices):
    """The row scan shared by every entry point: raw scores [B] and, with
    ``with_matrices``, the per-row H/E/F stacks ([B, Ls, Lt+1] each)."""
    if locality not in LOCALITIES:
        raise ValueError(f"unknown locality {locality!r}")
    S = similarity.to(torch.float32)
    B, Ls, Lt = S.shape
    T1 = Lt + 1
    dev = S.device
    open_s, extend_s, open_t, extend_t = _gap_scalars(gaps, dev)
    decay_t = torch.minimum(open_t, extend_t)

    if locality == GLOBAL:
        H = (-_boundary_costs(T1, gaps[2], gaps[3], dev))[None, :].expand(B, T1)
        col0 = -_boundary_costs(Ls + 1, gaps[0], gaps[1], dev)
    else:
        H = torch.zeros((B, T1), dtype=torch.float32, device=dev)
    Fm = torch.full((B, T1), NEG, dtype=torch.float32, device=dev)
    best = torch.full(
        (B,), NEG if locality == GLOBAL else 0.0, dtype=torch.float32, device=dev
    )
    negcol = torch.full((B, 1), NEG, dtype=torch.float32, device=dev)
    if len_s is not None:
        len_s = len_s.to(device=dev, dtype=torch.int64)
        len_t = len_t.to(device=dev, dtype=torch.int64)
        jj = torch.arange(T1, device=dev)
        jmask = (jj[None, :] >= 1) & (jj[None, :] <= len_t[:, None])
        neg = torch.full((), NEG, dtype=torch.float32, device=dev)
    Hs, Es, Fs = [], [], []

    for i in range(1, Ls + 1):
        # Diagonal move into (i, j): H[i-1, j-1] + S[i-1, j-1]
        M = torch.cat([negcol, H[:, :-1] + S[:, i - 1, :]], dim=1)
        # Vertical move (gap in s): from row i-1, same column.
        Fm = torch.maximum(H - open_s, Fm - extend_s)
        C = torch.maximum(M, Fm)
        if locality == LOCAL:
            C = torch.clamp_min(C, 0.0)
        # Boundary column j = 0.
        if locality == GLOBAL:
            C[:, 0] = col0[i]
        else:
            C[:, 0] = 0.0
        # Horizontal moves (gap in t) via decayed prefix max, exact Gotoh.
        X = torch.cat([negcol, C[:, :-1] - open_t], dim=1)
        E = _decayed_prefix_max(X, decay_t)
        H = torch.maximum(C, E)
        if with_matrices:
            Hs.append(H)
            Es.append(E)
            Fs.append(Fm)
        if len_s is None:
            continue

        # --- score reductions ---
        row_valid = i <= len_s
        if locality != GLOBAL:
            row_max = torch.where(jmask, H, neg).max(dim=1).values
        if locality == LOCAL:
            best = torch.where(row_valid & (row_max > best), row_max, best)
        else:
            h_end = H.gather(1, len_t[:, None])[:, 0]
            if locality == GLOBAL:
                best = torch.where(i == len_s, h_end, best)
            else:  # SEMIGLOBAL: max over last row and last column
                best = torch.where(row_valid & (h_end > best), h_end, best)
                best = torch.where((i == len_s) & (row_max > best), row_max, best)
    mats = None
    if with_matrices:
        if not Hs:
            empty = torch.zeros((B, 0, T1), dtype=torch.float32, device=dev)
            mats = (empty, empty, empty)
        else:
            mats = tuple(torch.stack(m, dim=1) for m in (Hs, Es, Fs))
    return best, mats


def align_scores(similarity, len_s, len_t, gaps, locality: str = LOCAL):
    """Raw alignment scores [B] for a batch of independent DP problems.

    similarity [B, Ls, Lt] f32, len_s [B] (1 <= len_s <= Ls), len_t [B]
    (1 <= len_t <= Lt)."""
    best, _ = _scan(similarity, len_s, len_t, gaps, locality, False)
    return best


def _with_row0(similarity, gaps, locality, mats):
    """Prepend DP row 0 to the per-row H/E/F stacks ([B, Ls+1, Lt+1])."""
    Hs, Es, Fs = mats
    B, _, Lt = similarity.shape
    T1 = Lt + 1
    dev = Hs.device
    if locality == GLOBAL:
        row0 = (-_boundary_costs(T1, gaps[2], gaps[3], dev))[None, :].expand(B, T1)
    else:
        row0 = torch.zeros((B, T1), dtype=torch.float32, device=dev)
    neg0 = torch.full((B, 1, T1), NEG, dtype=torch.float32, device=dev)
    return (
        torch.cat([row0[:, None, :], Hs], dim=1),
        torch.cat([neg0, Es], dim=1),
        torch.cat([neg0, Fs], dim=1),
    )


def align_matrices(similarity, gaps, locality: str = LOCAL):
    """Full H/E/F DP matrices ([B, Ls+1, Lt+1]) for traceback — only for
    the small top-k rescore batch (the reference's finalizer trick,
    vectorian/core/cpp/match/matcher_impl.h:172-174)."""
    _, mats = _scan(similarity, None, None, gaps, locality, True)
    return _with_row0(similarity, gaps, locality, mats)


def align_matrices_scores(similarity, len_s, len_t, gaps, locality=LOCAL):
    """H/E/F matrices AND raw scores from ONE scan (the finalizer needs
    both).  The scores come from the same recurrence as ``align_scores``,
    so they are bit-identical to the scoring path."""
    raw, mats = _scan(similarity, len_s, len_t, gaps, locality, True)
    H, E, Fm = _with_row0(similarity, gaps, locality, mats)
    return H, E, Fm, raw


def traceback(
    H: np.ndarray,  # [Ls+1, Lt+1]
    S: np.ndarray,  # [Ls, Lt]
    len_s: int,
    len_t: int,
    gaps,
    locality: str,
    end_cell=None,
) -> np.ndarray:
    """Recover the injective mapping t-index -> s-index (or -1).

    Host-side, run only for the global top-k matches.  Returns an int array
    ``mapping`` of length ``len_t`` (reference: InjectiveFlow mapping,
    vectorian/core/cpp/match/match.h:52-133).
    """
    open_s = float(gaps.open_s)
    extend_s = float(gaps.extend_s)
    open_t = float(gaps.open_t)
    extend_t = float(gaps.extend_t)
    decay_t = min(open_t, extend_t)

    mapping = np.full((len_t,), -1, dtype=np.int32)

    if end_cell is None:
        if locality == GLOBAL:
            i, j = len_s, len_t
        elif locality == LOCAL:
            sub = H[1 : len_s + 1, 1 : len_t + 1]
            flat = int(np.argmax(sub))
            i = flat // len_t + 1
            j = flat % len_t + 1
        else:
            # max over last row / last col
            col = H[: len_s + 1, len_t]
            row = H[len_s, : len_t + 1]
            if col.max() >= row.max():
                i, j = int(np.argmax(col)), len_t
            else:
                i, j = len_s, int(np.argmax(row))
    else:
        i, j = int(end_cell[0]), int(end_cell[1])

    eps = 1e-4
    while i > 0 and j > 0:
        h = H[i, j]
        if locality == LOCAL and h <= 0.0 + 1e-9:
            break
        # diagonal?
        if abs(H[i - 1, j - 1] + S[i - 1, j - 1] - h) <= eps:
            mapping[j - 1] = i - 1
            i -= 1
            j -= 1
            continue
        # horizontal run (gap in t): came from H[i, j-g] - (open_t +
        # (g-1)*decay_t)
        matched = False
        for g in range(1, j + 1):
            cost = open_t + (g - 1) * decay_t
            if abs(H[i, j - g] - cost - h) <= eps:
                j -= g
                matched = True
                break
        if matched:
            continue
        # gap in s of length g
        for g in range(1, i + 1):
            cost = open_s + (g - 1) * min(open_s, extend_s)
            if abs(H[i - g, j] - cost - h) <= eps:
                i -= g
                matched = True
                break
        if matched:
            continue
        # numerical fallback: pick the best-looking predecessor
        cands = []
        if i >= 1 and j >= 1:
            cands.append((H[i - 1, j - 1] + S[i - 1, j - 1], "d"))
        if j >= 1:
            cands.append((H[i, j - 1] - decay_t, "t"))
        if i >= 1:
            cands.append((H[i - 1, j] - min(open_s, extend_s), "s"))
        _, move = max(cands, key=lambda c: c[0])
        if move == "d":
            mapping[j - 1] = i - 1
            i -= 1
            j -= 1
        elif move == "t":
            j -= 1
        else:
            i -= 1
    return mapping
