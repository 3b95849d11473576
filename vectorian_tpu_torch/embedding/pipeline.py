"""Span-embedding auto-detection for spaCy-style NLP pipelines.

Given an ``nlp`` object, derive a stable span-embedding *name* and vector
*dimension* without the caller spelling them out (reference
embedding/pipeline.py:15-77, used by span.py:121's ``_SpacyImpl``).  Two
built-in decomposers run in order — a sentence-BERT pipe detector and a
plain ``meta['vectors']`` reader — and users can append their own with
:func:`register_decomposer`.

Detection is duck-typed (a pipe counts as sentence-BERT when it exposes a
``model_name`` and its class is named ``SentenceBert``), so it works with
``spacy_sentence_bert`` when installed and with any compatible wrapper
otherwise — this repo's environment ships neither spaCy nor
spacy_sentence_bert, and nothing here imports them.
"""

from dataclasses import dataclass


@dataclass(frozen=True)
class PipelineStats:
    """What a span encoder needs to know about an NLP pipeline."""

    name: str
    dimension: int


def _probe_dimension(nlp, meta):
    width = (meta.get("vectors") or {}).get("width")
    if width:
        return int(width)
    return int(nlp("").vector.shape[0])


def stats_from_sentence_bert(nlp):
    """Detect exactly one sentence-BERT pipe (reference pipeline.py:15-41).

    Returns ``None`` unless the pipeline holds precisely one component
    whose class is named ``SentenceBert`` with a ``model_name`` attribute;
    the derived name is ``sentence-bert-<lang>-<model_name>``.
    """
    found = None
    for _, pipe in getattr(nlp, "pipeline", []):
        if type(pipe).__name__ == "SentenceBert" and hasattr(
            pipe, "model_name"
        ):
            if found is not None:
                return None  # ambiguous: two sentence-BERT pipes
            found = pipe
    if found is None:
        return None
    meta = getattr(nlp, "meta", {}) or {}
    lang = meta.get("lang", "xx")
    return PipelineStats(
        name=f"sentence-bert-{lang}-{found.model_name}",
        dimension=_probe_dimension(nlp, meta),
    )


def stats_from_meta(nlp):
    """Fall back to the pipeline's own vector metadata (reference
    pipeline.py:44-58): ``meta['vectors']`` must carry a name."""
    meta = getattr(nlp, "meta", {}) or {}
    vectors = meta.get("vectors")
    if not vectors or not vectors.get("name"):
        return None
    return PipelineStats(
        name=str(vectors["name"]), dimension=_probe_dimension(nlp, meta)
    )


_decomposers = [stats_from_sentence_bert, stats_from_meta]


def register_decomposer(fn):
    """Append a custom ``nlp -> PipelineStats | None`` decomposer
    (reference pipeline.py:66-67)."""
    _decomposers.append(fn)


def decompose_nlp(nlp):
    """First decomposer that recognises ``nlp`` wins (reference
    pipeline.py:70-76); ``None`` when nothing does."""
    for fn in _decomposers:
        stats = fn(nlp)
        if stats is not None:
            return stats
    return None


def SpacySpanEmbedding(nlp):
    """Lambda-free span embedding from an NLP pipeline: the name and
    dimension come from :func:`decompose_nlp`, encoding runs
    ``nlp(text).vector`` per span (reference span.py:116-132)."""
    from vectorian_tpu_torch.embedding.span import TextSpanEmbedding

    stats = decompose_nlp(nlp)
    if stats is None:
        raise RuntimeError(
            f"failed to decompose NLP pipeline {getattr(nlp, 'pipeline', nlp)!r}; "
            "pass a TextSpanEmbedding(name, fn, dimension) explicitly or "
            "register_decomposer() a custom detector"
        )

    def encode(text):
        return nlp(text).vector

    return TextSpanEmbedding(stats.name, encode, stats.dimension)
