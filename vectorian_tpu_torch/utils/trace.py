"""Lightweight phase tracing for latency instrumentation.

The reference's tracing system is the per-query ``debug`` hook with
per-document microsecond match timing (matcher_impl.h:137-154); this is
the engine-side analogue for the TPU serving path: named wall-clock spans
recorded only while a collector is active (zero overhead otherwise — one
global ``is None`` check per span).

Usage::

    from vectorian_tpu_torch.utils import trace
    trace.start()
    index.find("query")
    for name, dt in trace.stop():
        ...

Span names are dotted (``find.topk.fetch``); nested spans both record, so
aggregations should group by the hierarchy.  Not thread-safe by design —
latency breakdowns are single-threaded drives.
"""

from __future__ import annotations

import contextlib
import time
from typing import List, Optional, Tuple

_events: Optional[List[Tuple[str, float]]] = None


def active() -> bool:
    return _events is not None


def start() -> None:
    """Begin collecting spans (resets any previous collection)."""
    global _events
    _events = []


def stop() -> List[Tuple[str, float]]:
    """End collection, returning [(name, seconds)] in completion order."""
    global _events
    ev, _events = _events or [], None
    return ev


@contextlib.contextmanager
def span(name: str):
    if _events is None:
        yield
        return
    t0 = time.perf_counter()
    try:
        yield
    finally:
        if _events is not None:
            _events.append((name, time.perf_counter() - t0))


def add(name: str, seconds: float) -> None:
    """Record an externally-timed span."""
    if _events is not None:
        _events.append((name, seconds))
