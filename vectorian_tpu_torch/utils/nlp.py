"""Minimal spaCy-compatible NLP fallback.

The reference requires spaCy>=3 for importing documents
(vectorian/importers.py:158-252).  spaCy is not available in every
deployment, so we provide a small tokenizer/sentencizer producing the same
token attributes the engine consumes (text offsets, universal POS, fine tag,
sentence boundaries).

NLP PROTOCOL CONTRACT — any object satisfying this duck type serves as
the ``nlp`` argument throughout the package (Importers, Session, Index),
including a real spaCy>=3 pipeline:

- ``nlp(text) -> doc``: parse one string.
- ``nlp.pipe(texts, **kwargs) -> iterable[doc]``: parse many (extra
  kwargs like spaCy's ``disable=[...]`` must be tolerated; the importers
  pass ``disable=["ner", "lemmatizer"]`` when supported and fall back to
  plain ``pipe(texts)`` on TypeError).
- ``doc.to_json() -> dict`` with at least:
  - ``"tokens"``: list of ``{"start": int, "end": int, "pos": str,
    "tag": str}`` — character offsets into the ORIGINAL text (token text
    is recovered as ``text[start:end]``), ``pos`` a Universal POS tag
    (spaCy ``token.pos_``), ``tag`` a fine-grained tag (``token.tag_``;
    may equal ``pos``).
  - ``"sents"``: list of ``{"start": int, "end": int}`` character spans
    covering the sentences in order.

This is exactly the subset of spaCy's ``Doc.to_json()`` the reference
consumes (importers.py:188-202), so ``spacy.load("en_core_web_sm")`` is
a drop-in; ``tests/test_nlp_protocol.py`` pins the contract (and runs an
opt-in end-to-end check whenever spaCy + a model are installed).
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import List

_TOKEN_RE = re.compile(r"\w+(?:'\w+)?|[^\w\s]", re.UNICODE)
_SENT_END_RE = re.compile(r"([.!?]+)(\s+|$)")

_DET = {"the", "a", "an", "this", "that", "these", "those"}
_PRON = {"i", "you", "he", "she", "it", "we", "they", "me", "him", "her",
         "us", "them", "my", "your", "his", "its", "our", "their"}
_ADP = {"of", "in", "on", "at", "by", "with", "from", "to", "for", "into",
        "over", "under", "about", "through"}
_CCONJ = {"and", "or", "but", "nor", "yet"}
_AUX = {"is", "are", "was", "were", "be", "been", "am", "has", "have", "had",
        "do", "does", "did", "will", "would", "shall", "should", "can",
        "could", "may", "might", "must"}

_POS_TO_TAG = {
    "NOUN": "NN", "PROPN": "NNP", "VERB": "VB", "ADJ": "JJ", "ADV": "RB",
    "PRON": "PRP", "DET": "DT", "ADP": "IN", "NUM": "CD", "PUNCT": ".",
    "CCONJ": "CC", "AUX": "MD", "X": "XX", "SYM": "SYM",
}


def _guess_pos(tok: str, is_sent_start: bool) -> str:
    if not tok:
        return "X"
    c0 = tok[0]
    if not (c0.isalnum() or c0 == "_"):
        return "PUNCT"
    low = tok.lower()
    if tok.replace(".", "").replace(",", "").isdigit():
        return "NUM"
    if low in _DET:
        return "DET"
    if low in _PRON:
        return "PRON"
    if low in _ADP:
        return "ADP"
    if low in _CCONJ:
        return "CCONJ"
    if low in _AUX:
        return "AUX"
    if tok[0].isupper() and not is_sent_start:
        return "PROPN"
    if low.endswith(("ly",)):
        return "ADV"
    if low.endswith(("ing", "ed", "ize", "ise")):
        return "VERB"
    if low.endswith(("ous", "ful", "ive", "able", "al", "ish")):
        return "ADJ"
    return "NOUN"


@dataclass
class SimpleDoc:
    text: str
    tokens: List[dict] = field(default_factory=list)  # {start,end,pos,tag}
    sents: List[dict] = field(default_factory=list)  # {start,end} char offsets

    def to_json(self):
        return {"text": self.text, "tokens": self.tokens, "sents": self.sents}


class SimpleNLP:
    """Regex tokenizer + heuristic POS tagger + punctuation sentencizer."""

    def __call__(self, text: str) -> SimpleDoc:
        doc = SimpleDoc(text=text)
        # sentence boundaries
        sent_bounds = []
        pos0 = 0
        for m in _SENT_END_RE.finditer(text):
            end = m.end(1)
            if end > pos0:
                sent_bounds.append((pos0, end))
            pos0 = m.end()
        if pos0 < len(text) and text[pos0:].strip():
            sent_bounds.append((pos0, len(text)))
        if not sent_bounds and text.strip():
            sent_bounds.append((0, len(text)))

        sent_starts = set()
        for s0, s1 in sent_bounds:
            doc.sents.append({"start": s0, "end": s1})

        # first token of each sentence
        for s0, s1 in sent_bounds:
            m = _TOKEN_RE.search(text, s0, s1)
            if m:
                sent_starts.add(m.start())

        for m in _TOKEN_RE.finditer(text):
            tok = m.group(0)
            pos = _guess_pos(tok, m.start() in sent_starts)
            doc.tokens.append(
                {
                    "start": m.start(),
                    "end": m.end(),
                    "pos": pos,
                    "tag": _POS_TO_TAG.get(pos, "XX"),
                }
            )
        return doc

    def pipe(self, texts, **kwargs):
        for t in texts:
            yield self(t)

    @property
    def meta(self):
        return {"name": "simple-nlp", "lang": "xx"}
