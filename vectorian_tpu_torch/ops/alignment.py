"""Batched sequence-alignment DP in torch: affine (Gotoh) and general
(Waterman-Smith-Beyer) gap models.

Counterpart of vectorian_tpu/ops/alignment.py: the reference's per-slice
pyalign solvers (vectorian/core/cpp/metric/alignment.h:242-304) become one
batched scan over document-token rows, every (slice x query) problem a row
of the batch axis.

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

The general-gap half (``align_scores_general`` and friends) takes per-length
cost vectors; it is only adds, subtractions and maxes in f32, so it is
bit-equal to the JAX package in any order of the maxes.  It is the plain
version of the WSB kernels (ops/dp_kernels.py) and serves the top-k
rescore's DP matrices on the card.
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


# ---------------------------------------------------------------------------
# General gap models: Waterman-Smith-Beyer DP with per-length cost vectors
# ---------------------------------------------------------------------------


def gap_cost_closure(w: torch.Tensor) -> torch.Tensor:
    """Min-plus transitive closure of a gap-cost vector: W*[g] = min over
    compositions g = g1+..+gk of sum w[gi].

    WSB semantics allow a "gap" to be any chain of gaps (the recurrence
    maxes over *final* H values, which may themselves end in gaps).
    Replacing w by W* makes a single shifted-max pass over gap lengths
    exact.  O(n^2 log n), tiny (n = padded length + 1)."""
    W = w.to(torch.float32)
    n1 = W.shape[0]
    idx = torch.arange(n1, device=W.device)
    diff = idx[None, :] - idx[:, None]  # [a, g] -> g - a
    valid = (diff >= 1) & (idx[:, None] >= 1)
    src = torch.clamp_min(diff, 0)
    inf = torch.tensor(float("inf"), dtype=torch.float32, device=W.device)
    # CONSTANT round count for every width: each round is prefix-causal
    # (W[g] reads only W[0..g]), so equal counts make closure prefixes
    # bit-identical across padded widths — find() (own needle width) and
    # find_batch() (batch-padded width) then rescore to the same bits.  16
    # rounds close every gap length up to 2^16; wider vectors take the
    # width-derived count, as in the JAX package.
    rounds = max(int(np.ceil(np.log2(max(n1 - 1, 1)))), 1)
    rounds = 16 if n1 - 1 <= (1 << 16) else rounds
    for _ in range(rounds):
        # Z[a, g] = W[a] + W[g-a] for 1 <= a < g
        Z = torch.where(valid, W[:, None] + W[src], inf)
        W = torch.minimum(W, Z.amin(dim=0))
    return W


def _general_row_h(C, w_closure, T1):
    """H = max(C, max_g shift(C, g) - W*[g]) along the last axis — the
    single-pass horizontal-gap solution (exact given closure costs)."""
    H = C
    for g in range(1, T1):
        shifted = F.pad(C[..., :-g], (g, 0), value=NEG)
        H = torch.maximum(H, shifted - w_closure[g])
    return H


def _general_scan(similarity, len_s, len_t, gap_vec_s, gap_vec_t, locality,
                  w_t_star, with_position, with_matrices):
    """The WSB row scan shared by every general entry point: raw scores [B]
    (or None without lengths), best cells [B, 2] (with_position) and the
    full H stack [B, Ls+1, Lt+1] (with_matrices)."""
    if locality not in LOCALITIES:
        raise ValueError(f"unknown locality {locality!r}")
    S = similarity.to(torch.float32)
    B, Ls, Lt = S.shape
    T1, S1 = Lt + 1, Ls + 1
    dev = S.device
    w_s = gap_vec_s.to(device=dev, dtype=torch.float32)
    w_t = gap_vec_t.to(device=dev, dtype=torch.float32)
    if w_t_star is None:
        w_t_star = gap_cost_closure(w_t)
    w_t_star = w_t_star.to(device=dev, dtype=torch.float32)

    if locality == GLOBAL:
        init_row = (-w_t[:T1])[None, :].expand(B, T1).clone()
        init_row[:, 0] = 0.0
    else:
        init_row = torch.zeros((B, T1), dtype=torch.float32, device=dev)
    # all previous rows: Hall [S1, B, T1]
    Hall = torch.full((S1, B, T1), NEG, dtype=torch.float32, device=dev)
    Hall[0] = init_row
    negcol = torch.full((B, 1), NEG, dtype=torch.float32, device=dev)

    scoring = len_s is not None
    if scoring:
        len_s = len_s.to(device=dev, dtype=torch.int64)
        len_t = len_t.to(device=dev, dtype=torch.int64)
        jj = torch.arange(T1, device=dev)
        jmask = (jj[None, :] >= 1) & (jj[None, :] <= len_t[:, None])
        best = torch.full(
            (B,), NEG if locality == GLOBAL else 0.0, dtype=torch.float32,
            device=dev,
        )
        best_pos = torch.zeros((B, 2), dtype=torch.int64, device=dev)

    for i in range(1, Ls + 1):
        # vertical: max over r < i of Hall[r] - w_s[i - r] (chains of
        # vertical gaps are exact through the stored final rows)
        cost_r = w_s[i - torch.arange(i, device=dev)]
        V = (Hall[:i] - cost_r[:, None, None]).amax(dim=0)  # [B, T1]
        M = torch.cat([negcol, Hall[i - 1][:, :-1] + S[:, i - 1, :]], dim=1)
        C = torch.maximum(M, V)
        if locality == LOCAL:
            C = torch.clamp_min(C, 0.0)
        if locality == GLOBAL:
            C[:, 0] = -w_s[min(i, Ls)]
        else:
            C[:, 0] = 0.0
        H = _general_row_h(C, w_t_star, T1)
        Hall[i] = H
        if not scoring:
            continue

        Hm = torch.where(jmask, H, NEG)
        row_valid = i <= len_s
        ivec = torch.full((B,), i, dtype=torch.int64, device=dev)
        if locality == LOCAL:
            row_max, row_arg = Hm.max(dim=1)
            improved = row_valid & (row_max > best)
            best = torch.where(improved, row_max, best)
            if with_position:
                best_pos = torch.where(
                    improved[:, None], torch.stack([ivec, row_arg], 1), best_pos
                )
        elif locality == GLOBAL:
            h_end = H.gather(1, len_t[:, None])[:, 0]
            hit = i == len_s
            best = torch.where(hit, h_end, best)
            if with_position:
                best_pos = torch.where(
                    hit[:, None], torch.stack([len_s, len_t], 1), best_pos
                )
        else:
            h_lastcol = H.gather(1, len_t[:, None])[:, 0]
            improved_c = row_valid & (h_lastcol > best)
            best = torch.where(improved_c, h_lastcol, best)
            if with_position:
                best_pos = torch.where(
                    improved_c[:, None], torch.stack([ivec, len_t], 1), best_pos
                )
            row_max, row_arg = Hm.max(dim=1)
            improved_r = (i == len_s) & (row_max > best)
            best = torch.where(improved_r, row_max, best)
            if with_position:
                best_pos = torch.where(
                    improved_r[:, None], torch.stack([ivec, row_arg], 1),
                    best_pos,
                )
    raw = best if scoring else None
    pos = best_pos.to(torch.int32) if scoring and with_position else None
    mats = Hall.permute(1, 0, 2) if with_matrices else None
    return raw, pos, mats


def align_scores_general(
    similarity, len_s, len_t, gap_vec_s, gap_vec_t, locality: str = LOCAL,
    with_position: bool = False, w_t_star=None,
):
    """Waterman-Smith-Beyer alignment with *arbitrary* per-length gap costs
    (the reference's O(n^3) general-gap case, alignment.py:54-55 and the
    pyalign GeneralGapCost solvers):

    H[i,j] = max(diag, max_g H[i-g,j] - w_s[g], max_g H[i,j-g] - w_t[g]
                 [, 0 local]).

    similarity [B, Ls, Lt], len_s/len_t [B], gap_vec_s [Ls+1] and gap_vec_t
    [Lt+1] raw costs; ``w_t_star`` the ready-made closure of gap_vec_t
    (computed here when None).  Returns raw scores [B] and, with
    ``with_position``, the best cells [B, 2] int32."""
    raw, pos, _ = _general_scan(
        similarity, len_s, len_t, gap_vec_s, gap_vec_t, locality, w_t_star,
        with_position, False,
    )
    if with_position:
        return raw, pos
    return raw


def align_matrices_general(similarity, gap_vec_s, gap_vec_t,
                           locality: str = LOCAL, w_t_star=None):
    """Full H matrix of the general-gap DP ([B, Ls+1, Lt+1]) — traceback
    support for the top-k finalizer."""
    _, _, H = _general_scan(
        similarity, None, None, gap_vec_s, gap_vec_t, locality, w_t_star,
        False, True,
    )
    return H


def align_matrices_scores_general(similarity, len_s, len_t, gap_vec_s,
                                  gap_vec_t, locality=LOCAL, w_t_star=None):
    """General-gap analogue of align_matrices_scores: (H, raw) from ONE
    scan, the scores bit-identical to ``align_scores_general``."""
    raw, _, H = _general_scan(
        similarity, len_s, len_t, gap_vec_s, gap_vec_t, locality, w_t_star,
        False, True,
    )
    return H, raw


def traceback_general(H, S, len_s, len_t, w_s, w_t, locality, end_cell=None):
    """Traceback for the general-gap DP: probe all gap lengths against the
    cost vectors (host-side, numpy)."""
    mapping = np.full((len_t,), -1, dtype=np.int32)
    if end_cell is None:
        if locality == GLOBAL:
            i, j = len_s, len_t
        elif locality == LOCAL:
            sub = H[1 : len_s + 1, 1 : len_t + 1]
            flat = int(np.argmax(sub))
            i, j = flat // len_t + 1, flat % len_t + 1
        else:
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
        if locality == LOCAL and h <= 1e-9:
            break
        if abs(H[i - 1, j - 1] + S[i - 1, j - 1] - h) <= eps:
            mapping[j - 1] = i - 1
            i -= 1
            j -= 1
            continue
        moved = False
        for g in range(1, j + 1):
            if abs(H[i, j - g] - w_t[g] - h) <= eps:
                j -= g
                moved = True
                break
        if moved:
            continue
        for g in range(1, i + 1):
            if abs(H[i - g, j] - w_s[g] - h) <= eps:
                i -= g
                moved = True
                break
        if moved:
            continue
        # numerical fallback
        mapping[j - 1] = i - 1
        i -= 1
        j -= 1
    return mapping
