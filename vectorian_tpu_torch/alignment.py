"""Declarative alignment / transport optimizer specs.

Reference: vectorian/alignment.py (GlobalAlignment:50, SemiGlobalAlignment:100,
LocalAlignment:133, WordMoversDistance:190, WordRotatorsDistance:286) plus the
pyalign gap-cost models the reference imports (alignment.py:6).

Specs compile to plain arg dicts consumed by the engine (the reference's
``to_args`` contract), with gap costs resolved to affine (open, extend)
runtime scalars where exact — constant, linear and affine gap models are
solved exactly by the Gotoh kernel; ``cost(k) = open + (k-1) * extend``.
Non-affine models (exponential/custom) expose their cost vectors and are
handled by the general-gap slow path.
"""

from __future__ import annotations

from typing import Dict, Optional, Union

import numpy as np


class GapCost:
    """Base gap-cost model; ``costs(n)`` returns costs for lengths 0..n-1."""

    def costs(self, n: int) -> np.ndarray:
        raise NotImplementedError()

    def to_affine(self):
        """(open, extend) if this model is exactly affine, else None."""
        return None

    def to_description(self):
        return self.__class__.__name__

    def _ipython_display_(self):  # pragma: no cover
        try:
            import matplotlib.pyplot as plt

            c = self.costs(32)
            plt.plot(np.arange(len(c)), c)
            plt.xlabel("gap length")
            plt.ylabel("cost")
        except ImportError:
            print(self.to_description())


class ConstantGapCost(GapCost):
    """cost(k) = c for any k >= 1 (pyalign ConstantGapCost)."""

    def __init__(self, cost: float):
        self._cost = float(cost)

    def costs(self, n: int) -> np.ndarray:
        out = np.full((n,), self._cost, np.float32)
        if n > 0:
            out[0] = 0.0
        return out

    def to_affine(self):
        return (self._cost, 0.0)

    def to_description(self):
        return f"ConstantGapCost({self._cost})"


class LinearGapCost(GapCost):
    """cost(k) = k * step (pyalign LinearGapCost)."""

    def __init__(self, step: float):
        self._step = float(step)

    def costs(self, n: int) -> np.ndarray:
        return np.arange(n, dtype=np.float32) * self._step

    def to_affine(self):
        return (self._step, self._step)

    def to_description(self):
        return f"LinearGapCost({self._step})"


class AffineGapCost(GapCost):
    """cost(k) = open + (k-1) * extend."""

    def __init__(self, open: float, extend: float):
        self._open = float(open)
        self._extend = float(extend)

    def costs(self, n: int) -> np.ndarray:
        k = np.arange(n, dtype=np.float32)
        return np.where(k > 0, self._open + (k - 1) * self._extend, 0.0).astype(
            np.float32
        )

    def to_affine(self):
        return (self._open, self._extend)

    def to_description(self):
        return f"AffineGapCost({self._open}, {self._extend})"


class ExponentialGapCost(GapCost):
    """cost(k) = 1 - 2^(-k / cutoff) — approaches 1 at large k; cutoff is
    the half-cost length (pyalign exponential / smooth gap cost)."""

    def __init__(self, cutoff: float):
        self._cutoff = float(cutoff)

    def costs(self, n: int) -> np.ndarray:
        k = np.arange(n, dtype=np.float32)
        if self._cutoff <= 0:
            return (k > 0).astype(np.float32)
        return (1.0 - np.power(2.0, -k / self._cutoff)).astype(np.float32)

    def to_description(self):
        return f"ExponentialGapCost({self._cutoff})"


def smooth_gap_cost(cutoff: float) -> ExponentialGapCost:
    return ExponentialGapCost(cutoff)


class CustomGapCost(GapCost):
    """User-defined cost function k -> cost (pyalign user GapCost)."""

    def __init__(self, costs_fn):
        self._fn = costs_fn

    def costs(self, n: int) -> np.ndarray:
        k = np.arange(n, dtype=np.float32)
        out = np.asarray([self._fn(float(x)) for x in k], np.float32)
        out[0] = 0.0
        return out

    def to_description(self):
        return "CustomGapCost"


class Optimizer:
    """Base strategy for matching two token sequences."""

    def to_description(self, partition):
        raise NotImplementedError()

    def to_args(self, partition) -> dict:
        raise NotImplementedError()


def coalesce_default_gap(gap):
    return ConstantGapCost(0) if gap is None else gap


def split_gap(gap: Union[GapCost, Dict[str, GapCost], None]):
    """Per-side gap dict {'s':…, 't':…} or a single cost for both sides
    (reference alignment.py:78-97)."""
    gap = coalesce_default_gap(gap)
    if isinstance(gap, dict):
        if not all(k in ("s", "t") for k in gap.keys()):
            raise ValueError(gap)
        return (
            coalesce_default_gap(gap.get("s")),
            coalesce_default_gap(gap.get("t")),
        )
    return gap, gap


class Alignment(Optimizer):
    """Order-preserving matching through insertions/deletions."""

    _locality: str = ""

    def __init__(self, gap: Union[GapCost, Dict[str, GapCost]] = None):
        self._gap_s, self._gap_t = split_gap(gap)

    @property
    def gap(self):
        return {"s": self._gap_s, "t": self._gap_t}

    def to_description(self, partition):
        return {
            self.__class__.__name__: {
                "gap_s": self._gap_s.to_description(),
                "gap_t": self._gap_t.to_description(),
            }
        }

    def to_args(self, partition) -> dict:
        return {
            "algorithm": "alignment",
            "locality": self._locality,
            "gap_s": self._gap_s,
            "gap_t": self._gap_t,
        }


class GlobalAlignment(Alignment):
    """Needleman-Wunsch / Sankoff global alignment (reference
    alignment.py:50-97)."""

    _locality = "global"


class SemiGlobalAlignment(Alignment):
    """End-gaps-free alignment (reference alignment.py:100-130)."""

    _locality = "semiglobal"


class LocalAlignment(Alignment):
    """Smith-Waterman(-Beyer) local alignment — the engine default
    (reference alignment.py:133-187, sim/span.py:28-32)."""

    _locality = "local"


class OptimalTransport(Optimizer):
    """Order-free matching as a transport problem."""


class WordMoversDistance(OptimalTransport):
    """WMD variants (reference alignment.py:190-283): full WMD (Kusner 2015)
    and relaxed RWMD (Atasu 2017 / Kusner lower bound), bow/nbow weighting."""

    @staticmethod
    def wmd(variant="nbow", **kwargs):
        kwargs["builtin"] = f"wmd/{variant}"
        if variant == "bow":
            return WordMoversDistance(False, False, False, True, **kwargs)
        elif variant == "nbow":
            return WordMoversDistance(False, False, False, False, **kwargs)
        raise ValueError(variant)

    @staticmethod
    def rwmd(variant="nbow", **kwargs):
        kwargs["builtin"] = f"rwmd/{variant}"
        if variant == "nbow":
            return WordMoversDistance(True, True, True, True, **kwargs)
        elif variant == "nbow/distributed":
            return WordMoversDistance(True, False, True, True, **kwargs)
        elif variant == "bow/fast":
            return WordMoversDistance(True, True, False, False, **kwargs)
        raise ValueError(variant)

    def __init__(
        self,
        relaxed=True,
        injective=True,
        symmetric=False,
        normalize_bow=False,
        extra_mass_penalty=-1,
        builtin=None,
    ):
        self._options = {
            "relaxed": relaxed,
            "injective": injective,
            "normalize_bow": normalize_bow,
            "symmetric": symmetric,
            "extra_mass_penalty": extra_mass_penalty,
        }
        self._builtin_name = builtin

    @property
    def builtin_name(self):
        return self._builtin_name

    def to_description(self, partition):
        return {"WordMoversDistance": self._options}

    def to_args(self, partition) -> dict:
        return {"algorithm": "word-movers-distance", **self._options}


class WordRotatorsDistance(OptimalTransport):
    """Word Rotator's Distance (Yokoi et al. 2020) — magnitudes as mass,
    cosine cost (reference alignment.py:286-313)."""

    def __init__(self, normalize_magnitudes=True, extra_mass_penalty=-1):
        self._normalize_magnitudes = normalize_magnitudes
        self._extra_mass_penalty = extra_mass_penalty

    def to_description(self, partition):
        return {
            "WordRotatorsDistance": {
                "normalize_magnitudes": self._normalize_magnitudes,
                "extra_mass_penalty": self._extra_mass_penalty,
            }
        }

    def to_args(self, partition) -> dict:
        return {
            "algorithm": "word-rotators-distance",
            "normalize_magnitudes": self._normalize_magnitudes,
            "extra_mass_penalty": self._extra_mass_penalty,
        }


def resolve_affine_gaps(gap_s: GapCost, gap_t: GapCost):
    """Resolve two GapCost specs into AffineGapParams-compatible scalars;
    returns None if either side is not exactly affine."""
    a_s = gap_s.to_affine()
    a_t = gap_t.to_affine()
    if a_s is None or a_t is None:
        return None
    return (a_s[0], a_s[1], a_t[0], a_t[1])
