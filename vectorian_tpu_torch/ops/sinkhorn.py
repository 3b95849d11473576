"""Batched entropic optimal transport (Sinkhorn) as torch ops.

The port of vectorian_tpu/ops/sinkhorn.py: log-domain batched Sinkhorn for
many independent small transport problems at once, elementwise and
reduction work only (the device-side analogue of the reference's exact
EMD, pyemd emd_hat, vectorian/core/cpp/alignment/transport.h:91-145).  The
JAX package has no Pallas kernel here, and the port has no hand-written
kernel either.

It is not the full-WMD / WRD ranking path: that ranks with the provable
exact-score bound of ops/wmd (``_emd_score_bound``) and rescores with the
exact native EMD (ops/emd_exact).  The JAX package's one serving use of
entropic transport, its opt-in Sinkhorn-dual consume filter, is not in the
port (it measured slower than the exact solves it skips).  This module is
the entropic solver for callers that want approximate dense transport on
the device.

Masses may be unnormalized or unbalanced; problems are normalized
internally and masked rows/columns (zero mass, padding) get log masses of
NEG.
"""

from __future__ import annotations

import torch

NEG = -1e30


def sinkhorn_log(w1: torch.Tensor, w2: torch.Tensor, D: torch.Tensor,
                 eps: float = 0.02, n_iters: int = 100) -> torch.Tensor:
    """Transport plans G [B, n1, n2] with marginals ~ (w1/s1, w2/s2) for
    supplies ``w1`` [B, n1] and demands ``w2`` [B, n2] (>= 0; zero =
    masked) under costs ``D`` [B, n1, n2].  Log-domain Sinkhorn in f32;
    per-problem masses are normalized to 1 so ``eps`` has one scale across
    the batch."""
    f32 = torch.float32
    w1, w2, D = w1.to(f32), w2.to(f32), D.to(f32)
    eps = torch.as_tensor(eps, dtype=f32, device=D.device)
    a = w1 / torch.clamp_min(w1.sum(1, keepdim=True), 1e-20)
    b = w2 / torch.clamp_min(w2.sum(1, keepdim=True), 1e-20)
    neg = torch.full((), NEG, dtype=f32, device=D.device)
    log_a = torch.where(a > 0, torch.log(torch.clamp_min(a, 1e-20)), neg)
    log_b = torch.where(b > 0, torch.log(torch.clamp_min(b, 1e-20)), neg)
    # impossible cells never receive mass
    valid = (a[:, :, None] > 0) & (b[:, None, :] > 0)
    K = torch.where(valid, -D / eps, neg)  # log kernel
    u = torch.zeros_like(log_a)
    v = torch.zeros_like(log_b)
    for _ in range(n_iters):
        # u_i = log a_i - logsumexp_j (K_ij + v_j)
        u = torch.where(log_a > NEG * 0.5,
                        log_a - torch.logsumexp(K + v[:, None, :], dim=2), neg)
        v = torch.where(log_b > NEG * 0.5,
                        log_b - torch.logsumexp(K + u[:, :, None], dim=1), neg)
    logG = K + u[:, :, None] + v[:, None, :]
    return torch.where(valid, torch.exp(torch.clamp_min(logG, -80.0)),
                       torch.zeros((), dtype=f32, device=D.device))


def sinkhorn_emd_score(w1: torch.Tensor, w2: torch.Tensor, D: torch.Tensor,
                       eps: float = 0.02, n_iters: int = 100) -> torch.Tensor:
    """The reference FullSolver score per problem, sum((1 - D) G) / sum(G)
    (wmd.h:252, wrd.h:123-142), of the entropic plan: [B] f32."""
    G = sinkhorn_log(w1, w2, D, eps, n_iters)
    num = ((1.0 - D.to(torch.float32)) * G).sum((1, 2))
    return num / torch.clamp_min(G.sum((1, 2)), 1e-20)
