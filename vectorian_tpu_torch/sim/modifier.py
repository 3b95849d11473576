"""Token-similarity modifiers combining several embeddings.

Reference: vectorian/sim/modifier.py — invoked there from C++
(ModifiedSimilarityMatrixFactory, metric/modifier.cpp:18-74) on numpy dicts;
here each modifier is a pure function over operand dicts of tensors
({"similarity", "magnitudes_s", "magnitudes_t"}).
"""

from __future__ import annotations

from typing import List

import torch

from vectorian_tpu_torch.sim.kernel import Kernel, UnaryOperator
from vectorian_tpu_torch.sim.token import TokenSim


class TokenSimilarityModifier(TokenSim):
    @property
    def is_modifier(self):
        return True

    @property
    def operands(self):
        raise NotImplementedError()

    def combine(self, operands: List[dict]) -> dict:
        """operands: list of dicts with 'similarity' [S, T] and optionally
        'magnitudes_s' [S] / 'magnitudes_t' [T]; returns combined dict."""
        raise NotImplementedError()


class UnaryTokenSimilarityModifier(TokenSimilarityModifier):
    def __init__(self, operand, operators: List[UnaryOperator]):
        self._operand = operand
        self._kernel = Kernel(operators)

    @property
    def operands(self):
        return [self._operand]

    def combine(self, operands):
        out = dict(operands[0])
        out["similarity"] = self._kernel(out["similarity"])
        return out

    @property
    def embeddings(self):
        return self._operand.embeddings

    @property
    def name(self):
        return self._kernel.name(self._operand.name)


def mixed_weights(weights, device) -> torch.Tensor:
    """Normalized f32 mixture weights (w / sum(w))."""
    w = torch.as_tensor(weights, dtype=torch.float32, device=device)
    return w / w.sum()


def mix(stack: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Weighted sum over the leading K axis of ``stack``."""
    wb = w.reshape((-1,) + (1,) * (stack.ndim - 1))
    return (stack * wb).sum(0)


def extremum(sims: torch.Tensor, sign: float):
    """(per-cell max (sign 1) or min (sign -1) over the leading K axis,
    index of the winning operand)."""
    sel = torch.argmax(sign * sims, dim=0)
    return torch.gather(sims, 0, sel[None])[0], sel


class MixedTokenSimilarity(TokenSimilarityModifier):
    """Weighted average across embeddings (reference modifier.py:50-76)."""

    def __init__(self, metrics, weights):
        self._metrics = list(metrics)
        self._weights = [float(w) for w in weights]

    @property
    def operands(self):
        return self._metrics

    def combine(self, operands):
        device = operands[0]["similarity"].device
        w = mixed_weights(self._weights, device)
        return {
            k: mix(torch.stack([o[k] for o in operands], 0), w)
            for k in operands[0].keys()
        }

    @property
    def embeddings(self):
        return [e for m in self._metrics for e in m.embeddings]

    @property
    def name(self):
        total = sum(self._weights)
        terms = [f"{w / total} * {m.name}" for m, w in zip(self._metrics, self._weights)]
        return f'({" + ".join(terms)})'


class ExtremumTokenSimilarity(TokenSimilarityModifier):
    """Pick per-cell max (or min) similarity across embeddings; magnitudes
    are re-weighted by per-row selection counts (reference modifier.py:79-107)."""

    _sign = 1.0
    _name_ = "extremum"

    def __init__(self, metrics):
        self._metrics = list(metrics)

    @property
    def operands(self):
        return self._metrics

    def combine(self, operands):
        sims = torch.stack([o["similarity"] for o in operands], 0)  # [K, S, T]
        best, sel = extremum(sims, self._sign)
        out = {"similarity": best}
        K = sims.shape[0]
        for key, axis in (("magnitudes_s", 1), ("magnitudes_t", 0)):
            if key not in operands[0]:
                continue
            # per-row (s) / per-column (t) histogram of which embedding won,
            # used as weights
            counts = torch.stack(
                [(sel == k).sum(axis) for k in range(K)], 0
            ).to(torch.float32)
            mags = torch.stack([o[key] for o in operands], 0)
            denom = torch.clamp_min(counts.sum(0), 1.0)
            out[key] = (mags * counts).sum(0) / denom
        return out

    @property
    def embeddings(self):
        return [e for m in self._metrics for e in m.embeddings]

    @property
    def name(self):
        return f'{self._name_}({", ".join(x.name for x in self._metrics)})'


class MaximumTokenSimilarity(ExtremumTokenSimilarity):
    _sign = 1.0
    _name_ = "maximum"


class MinimumTokenSimilarity(ExtremumTokenSimilarity):
    _sign = -1.0
    _name_ = "minimum"
