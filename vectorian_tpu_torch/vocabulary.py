"""String-interning vocabularies.

Reference: vectorian/core/cpp/vocabulary.h — StringStorage arena + LexiconImpl
(str<->id), with an IncrementalLexicon layered on a frozen base so each query
can add out-of-corpus tokens without recompiling corpus data
(vocabulary.h:152-175, QueryVocabulary vocabulary.h:500-560).

Here the corpus vocabulary is a host-side python intern table (measured
FASTER than the native C++ arena through ctypes — string marshalling costs
more than dict interning saves; native.NativeLexicon exists as the
benchmarked alternative backend but is deliberately not wired in), and the
*query* extension appends rows to the query-side similarity matrix instead
of touching any device corpus array — preserving the reference's
incremental-vocab design on TPU.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Sequence

import numpy as np


class Lexicon:
    """Bidirectional str<->int32 intern table; id 0 is reserved for PAD."""

    PAD = 0

    def __init__(self, strings: Sequence[str] = ()):
        self._to_id: Dict[str, int] = {"<pad>": 0}
        self._strings: List[str] = ["<pad>"]
        for s in strings:
            self.add(s)

    def __len__(self):
        return len(self._strings)

    def add(self, s: str) -> int:
        i = self._to_id.get(s)
        if i is None:
            i = len(self._strings)
            self._to_id[s] = i
            self._strings.append(s)
        return i

    def add_many(self, strings: Iterable[str]) -> np.ndarray:
        return np.fromiter(
            (self.add(s) for s in strings), dtype=np.int32
        )

    def get(self, s: str, default: int = -1) -> int:
        return self._to_id.get(s, default)

    def lookup_many(self, strings: Iterable[str]) -> np.ndarray:
        g = self._to_id.get
        return np.fromiter((g(s, -1) for s in strings), dtype=np.int32)

    def to_str(self, i: int) -> str:
        return self._strings[i]

    @property
    def strings(self) -> List[str]:
        return self._strings

    def reorder(self, perm: np.ndarray) -> None:
        """Relabel ids: new_id = perm[old_id] (perm[0] must be 0 — PAD is
        pinned).  Used to assign ids by corpus frequency so that vocab-row
        gathers on TPU hit a small hot region (Zipf locality)."""
        assert perm[0] == 0
        new_strings: List[str] = [""] * len(self._strings)
        for old_id, s in enumerate(self._strings):
            new_strings[int(perm[old_id])] = s
        self._strings = new_strings
        self._to_id = {s: i for i, s in enumerate(new_strings)}

    def freeze(self) -> "FrozenLexicon":
        return FrozenLexicon(self)


class FrozenLexicon:
    """Read-only snapshot used while a session is live."""

    def __init__(self, lex: Lexicon):
        self._lex = lex
        self._size = len(lex)

    def __len__(self):
        return self._size

    def get(self, s: str, default: int = -1) -> int:
        i = self._lex.get(s, default)
        return i if i < self._size else default

    def to_str(self, i: int) -> str:
        return self._lex.to_str(i)

    @property
    def strings(self):
        return self._lex.strings[: self._size]


class IncrementalLexicon:
    """Per-query extension over a frozen base (vocabulary.h:152-175):
    tokens unknown to the corpus get temporary ids >= len(base)."""

    def __init__(self, base: FrozenLexicon):
        self._base = base
        self._extra: Dict[str, int] = {}
        self._extra_strings: List[str] = []

    @property
    def base_size(self) -> int:
        return len(self._base)

    def __len__(self):
        return len(self._base) + len(self._extra_strings)

    def add(self, s: str) -> int:
        i = self._base.get(s, -1)
        if i >= 0:
            return i
        i = self._extra.get(s)
        if i is None:
            i = len(self._base) + len(self._extra_strings)
            self._extra[s] = i
            self._extra_strings.append(s)
        return i

    def add_many(self, strings: Iterable[str]) -> np.ndarray:
        return np.fromiter((self.add(s) for s in strings), dtype=np.int32)

    def to_str(self, i: int) -> str:
        if i < len(self._base):
            return self._base.to_str(i)
        return self._extra_strings[i - len(self._base)]

    @property
    def extra_strings(self) -> List[str]:
        return self._extra_strings


# Universal POS tags (spaCy/UD inventory) — fixed small lexicons so pos/tag
# ids are stable across sessions (reference interns them per-session,
# vocabulary.h:275-366; fixing them is simpler and equivalent).
UPOS = [
    "<pad>", "ADJ", "ADP", "ADV", "AUX", "CCONJ", "DET", "INTJ", "NOUN",
    "NUM", "PART", "PRON", "PROPN", "PUNCT", "SCONJ", "SYM", "VERB", "X",
    "SPACE",
]
UPOS_TO_ID = {p: i for i, p in enumerate(UPOS)}


class Vocabulary:
    """Session-level vocabulary: token lexicon + fixed pos lexicon + a
    dynamic tag (fine POS) lexicon."""

    def __init__(self):
        self.tokens = Lexicon()
        self.tags = Lexicon()

    @classmethod
    def from_strings(cls, tokens: Sequence[str], tags: Sequence[str]):
        """Rebuild a vocabulary from persisted lexicon strings (index 0 is
        the PAD entry both lexicons create themselves)."""
        v = cls()
        for s in tokens[1:]:
            v.tokens.add(s)
        for s in tags[1:]:
            v.tags.add(s)
        return v

    def pos_id(self, pos: str) -> int:
        return UPOS_TO_ID.get(pos, UPOS_TO_ID["X"])

    def tag_id(self, tag: str) -> int:
        return self.tags.add(tag)

    def intern_tokens(self, strings: Iterable[str]) -> np.ndarray:
        return self.tokens.add_many(strings)

    def __len__(self):
        return len(self.tokens)
