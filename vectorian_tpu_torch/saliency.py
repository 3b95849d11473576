"""Saliency boosters: per-slice boost weights mixed from keyword signals.

Reference: vectorian/saliency.py — keyword count signals (fast C++
count_keywords path :70-82), smoothing filters (GaussFilter:32,
MaxFilter:39), weighted mixture compiled into a core.Booster
(Saliency.compile:141-154) whose weights multiply match scores
(Score{raw,max,boost}, match/match.h:295-336).

Port of vectorian_tpu/saliency.py (plain numpy, kept as the port's own
copy): the booster compiles to a [n_slices] float array that the engine
multiplies into the normalized scores on the device.  ``compile`` selects
each document's slices from one stable grouping of the slice table instead
of one scan of it a document, and a booster of plain ``KeywordSignal``s
has the engine count every slice's keywords at once in its resident
buckets; the weights are the same, bit for bit."""

from __future__ import annotations

from typing import Callable, List, Optional

import numpy as np


class Filter:
    def __call__(self, x: np.ndarray) -> np.ndarray:
        raise NotImplementedError()


class ConvFilter(Filter):
    def __init__(self, pulse: np.ndarray):
        pulse = np.asarray(pulse, np.float64)
        self._pulse = pulse / np.sum(pulse)

    def __call__(self, x):
        if self._pulse.shape[0] <= x.shape[0]:
            return np.convolve(x, self._pulse, mode="same")
        return x


class GaussFilter(ConvFilter):
    def __init__(self, width: int, fc: float = 1.0):
        import scipy.signal

        t = np.linspace(-1, 1, width, endpoint=True)
        _, e = scipy.signal.gausspulse(t, fc=fc, retenv=True)
        super().__init__(e)


class MaxFilter(Filter):
    def __init__(self, width: int):
        self._size = width

    def __call__(self, x):
        import scipy.ndimage

        return scipy.ndimage.maximum_filter(x, size=self._size)


class Signal:
    """Per-document, per-slice signal in [0, 1]."""

    _filters = {"gauss": GaussFilter, "max": MaxFilter}

    def __call__(self, prepared_doc, partition) -> np.ndarray:
        raise NotImplementedError()

    def smoothed(self, width: int, method: str = "max") -> "SmoothedSignal":
        return SmoothedSignal(self, Signal._filters[method](width))


class SmoothedSignal(Signal):
    def __init__(self, base: Signal, filter_: Filter):
        self._base = base
        self._filter = filter_

    def __call__(self, prepared_doc, partition):
        return self._filter(self._base(prepared_doc, partition))


class CustomSignal(Signal):
    def spans_to_signal(self, token_lists) -> np.ndarray:
        raise NotImplementedError()

    def __call__(self, prepared_doc, partition):
        ranges = prepared_doc.span_ranges(partition.spec)
        vocab = partition.session.vocab
        spans = []
        for s, e in ranges:
            spans.append(
                [vocab.tokens.to_str(int(i)) for i in prepared_doc.token_ids[s:e]]
            )
        signal = self.spans_to_signal(spans)
        assert np.max(signal, initial=0) <= 1
        assert np.min(signal, initial=0) >= 0
        return signal


class KeywordSignal(CustomSignal):
    """Fraction (capped) of keyword hits per slice (reference
    saliency.py:97-123); keywords are matched against *normalized* token
    strings."""

    def __init__(self, *keywords, max_count: int = 1, same: Optional[Callable] = None):
        self._keywords = set(keywords)
        self._max_count = max_count
        self._same = same

    def _check(self, x: str) -> bool:
        if self._same is None:
            return x in self._keywords
        return any(self._same(x, y) for y in self._keywords)

    def spans_to_signal(self, token_lists):
        w = np.zeros((len(token_lists),), np.float32)
        for i, toks in enumerate(token_lists):
            w[i] = sum(1 for t in toks if self._check(t))
        w = np.minimum(w, self._max_count)
        return w / self._max_count

    def corpus_signal(self, session, partition, packed):
        """The signal of every slice of ``packed`` (the partition's packing)
        at once, its keyword counts taken by the engine from the resident
        buckets (``BruteForceEngine.count_tokens``): the values
        ``spans_to_signal`` gives document by document.  None where the
        documents' path must serve: a ``same`` callable, or a slice the
        packing may have clamped to its bucket (as long as the largest
        capacity)."""
        if self._same is not None or not packed.buckets:
            return None
        if int(packed.slice_len.max()) >= max(b.capacity for b in packed.buckets):
            return None
        tokens = session.vocab.tokens
        keyword = np.zeros((len(tokens),), bool)
        keyword[[i for i in (tokens.get(k) for k in self._keywords) if i >= 0]] = True
        counts = session.engine(partition.spec).count_tokens(keyword)
        w = np.minimum(counts.astype(np.float32), self._max_count)
        return w / self._max_count


class Saliency:
    """Weighted mixture of signals -> per-slice boost (reference
    saliency.py:126-154): boost = (1-strength)*1 + strength*avg(signals)."""

    def __init__(self, strength: float = 0.5):
        if not 0 <= strength <= 1:
            raise ValueError(f"strength has illegal value {strength}")
        self._f: List[Signal] = []
        self._w: List[float] = []
        self._strength = strength

    def add_signal(self, signal: Signal, weight: float = 1.0):
        self._f.append(signal)
        self._w.append(weight)
        return self

    def compile(self, session, partition, query=None) -> np.ndarray:
        """[n_slices] boost weights across the whole packed corpus (the
        query does not enter them)."""
        packed = session.packed_corpus(partition.spec)
        out = np.ones((packed.n_slices,), np.float32)
        if not self._f:
            return out
        w_sum = float(np.sum(self._w))
        normal_w = np.asarray(self._w, np.float64) / w_sum
        weights = [1.0 - self._strength] + (normal_w * self._strength).tolist()

        # keyword signals: every slice at once (a slice's mixture reads its
        # own column only, so the values are the documents' path's)
        cols = [f.corpus_signal(session, partition, packed)
                if isinstance(f, KeywordSignal) else None for f in self._f]
        if all(c is not None for c in cols):
            signals = np.stack([out] + cols)
            return np.average(signals, axis=0, weights=weights).astype(np.float32)

        # each document's slices, ascending: one stable sort of the slice
        # table, then a binary search a document
        order = np.argsort(packed.slice_doc, kind="stable")
        docs_sorted = packed.slice_doc[order]
        for pd in session.documents:
            lo, hi = np.searchsorted(docs_sorted, [pd.doc_index, pd.doc_index + 1])
            if hi <= lo:
                continue
            sel = order[lo:hi]
            signals = [np.ones((sel.size,), np.float32)]
            for f in self._f:
                sig = np.asarray(f(pd, partition), np.float32)
                if sig.shape[0] != sel.size:
                    # a silently resized signal would boost the WRONG
                    # slices — signals must be per-slice of this partition
                    raise ValueError(
                        f"saliency signal {f!r} returned {sig.shape[0]} "
                        f"values for document {pd.doc.title!r} but the "
                        f"partition has {sel.size} slices"
                    )
                signals.append(sig)
            out[sel] = np.average(np.stack(signals), axis=0, weights=weights)
        return out
