"""Two-stage token normalization ("flavors").

Reference: vectorian/normalization.py — text-level normalizers
(lower/strip/regex-sub/filter, TextNormalizer:99-122) and token-level
normalizers (POS rewrite + ignore masks, SimpleTokenNormalizer:139-159).
The default ("vanilla") flavor strips non-word characters, requires isalpha,
rewrites PROPN->NOUN / NNP->NN / NNPS->NNS and drops PUNCT
(vanilla_normalizers:162-191).

Normalizers carry a stable ``ident`` so embedding caches can be keyed by the
normalization they were built under (CachableCallable, normalization.py:17-36).
"""

from __future__ import annotations

import re
from typing import Callable, Dict, List, Optional

import numpy as np


def chain(callables):
    def call(arg):
        for f in callables:
            arg = f(arg)
            if arg is None:
                break
        return arg

    return call


class CachableCallable:
    """A callable with a stable identity used as a cache key."""

    def __init__(self, ident, callable_: Callable):
        self._ident = ident
        self._callable = callable_

    @property
    def ident(self):
        return self._ident

    def __call__(self, *args, **kwargs):
        return self._callable(*args, **kwargs)

    def unpack(self):
        return self._callable

    @staticmethod
    def chain(callables):
        ident = tuple(x.ident for x in callables)
        unpacked = [x.unpack() for x in callables]
        return CachableCallable(ident, chain(unpacked))


class TextNormalizer:
    """Per-token-text normalization pipeline; returning None drops a token."""

    def __init__(self):
        self._f: List[CachableCallable] = []

    def add(self, name, f):
        self._f.append(CachableCallable(name, f))

    def to_callable(self) -> CachableCallable:
        return CachableCallable.chain(self._f)

    def lower(self):
        self.add("lower", lambda s: s.lower())

    def strip(self):
        self.add("strip", lambda s: s.strip())

    def sub(self, pattern=r"\W", replacement=""):
        c = re.compile(pattern)
        self.add(("sub", pattern, replacement), lambda s: c.sub(replacement, s))

    def filter(self, k):
        self.add(("filter", k), lambda s: s if getattr(s, k)() else None)


class Rewrite:
    """Column-value rewrites, e.g. {'pos': {'PROPN': 'NOUN'}}."""

    def __init__(self, rules: Optional[Dict[str, Dict[str, str]]]):
        self._rules = rules or {}

    @property
    def ident(self):
        return tuple(sorted((k, tuple(sorted(v.items()))) for k, v in self._rules.items()))

    def transform_table(self, table: Dict[str, list]):
        for attr, rewrites in self._rules.items():
            values = table.get(attr)
            if values is None:
                continue
            table[attr] = [rewrites.get(v, v) for v in values]


class Ignore:
    """Row masks by column values, e.g. {'pos': ['PUNCT']}."""

    def __init__(self, rules: Optional[Dict[str, List[str]]]):
        self._rules = rules or {}

    @property
    def ident(self):
        return tuple(sorted((k, tuple(sorted(v))) for k, v in self._rules.items()))

    def keep_mask(self, table: Dict[str, list], n: int) -> np.ndarray:
        mask = np.ones((n,), dtype=bool)
        for k, vs in self._rules.items():
            values = table.get(k)
            if values is None:
                continue
            bad = set(vs)
            mask &= np.fromiter((v not in bad for v in values), dtype=bool, count=n)
        return mask


class TokenNormalizer:
    def normalize_table(self, text_f, table: Dict[str, list]) -> np.ndarray:
        """Mutates ``table`` (rewrites + normalized 'text'), returns the keep
        mask.  ``table`` holds python-list columns 'text', 'pos', 'tag'."""
        raise NotImplementedError()

    @property
    def ident(self):
        raise NotImplementedError()


class SimpleTokenNormalizer(TokenNormalizer):
    def __init__(self, rewrite=None, ignore=None):
        self._rewrite = Rewrite(rewrite)
        self._ignore = Ignore(ignore)

    @property
    def ident(self):
        return ("simple", self._rewrite.ident, self._ignore.ident)

    def normalize_table(self, text_f, table):
        n = len(table["text"])
        self._rewrite.transform_table(table)
        mask = self._ignore.keep_mask(table, n)
        if text_f is not None:
            texts = []
            for i, t in enumerate(table["text"]):
                t2 = text_f(t)
                if t2 is None or t2 == "":
                    mask[i] = False
                    texts.append("")
                else:
                    texts.append(t2)
            table["text"] = texts
        return mask


def vanilla_normalizers():
    """The Vectorian's default mappings (normalization.py:162-191)."""
    text = TextNormalizer()
    text.sub(r"\W", "")
    text.filter("isalpha")

    tokens = SimpleTokenNormalizer(
        rewrite={
            "pos": {"PROPN": "NOUN"},
            "tag": {"NNP": "NN", "NNPS": "NNS"},
        },
        ignore={"pos": ["PUNCT"]},
    )
    return {"text": text, "token": tokens}


def lowercase_normalizers():
    """Vanilla plus lowercasing — useful for uncased embeddings (GloVe)."""
    text = TextNormalizer()
    text.lower()
    text.sub(r"\W", "")
    text.filter("isalpha")

    tokens = SimpleTokenNormalizer(
        rewrite={
            "pos": {"PROPN": "NOUN"},
            "tag": {"NNP": "NN", "NNPS": "NNS"},
        },
        ignore={"pos": ["PUNCT"]},
    )
    return {"text": text, "token": tokens}


class AbstractNormalization:
    def __init__(self, name, normalizers):
        self._name = name
        self._normalizers = normalizers

    @property
    def name(self):
        return self._name

    @property
    def normalizers(self):
        return self._normalizers

    @property
    def ident(self):
        text = self._normalizers.get("text")
        token = self._normalizers.get("token")
        return (
            self._name,
            text.to_callable().ident if text is not None else None,
            token.ident if token is not None else None,
        )

    def apply(self, table: Dict[str, list]) -> np.ndarray:
        """Normalize a token table in place; return the keep mask."""
        text = self._normalizers.get("text")
        token = self._normalizers.get("token")
        text_f = text.to_callable() if text is not None else None
        if token is not None:
            return token.normalize_table(text_f, table)
        n = len(table["text"])
        mask = np.ones((n,), dtype=bool)
        if text_f is not None:
            texts = []
            for i, t in enumerate(table["text"]):
                t2 = text_f(t)
                if t2 is None or t2 == "":
                    mask[i] = False
                    texts.append("")
                else:
                    texts.append(t2)
            table["text"] = texts
        return mask

    def normalize_word(self, w: str) -> Optional[str]:
        """Normalize a single word (used for embedding-table dedup)."""
        text = self._normalizers.get("text")
        if text is None:
            return w
        return text.to_callable()(w)


class VanillaNormalization(AbstractNormalization):
    def __init__(self):
        super().__init__("vanilla", vanilla_normalizers())


class LowercaseNormalization(AbstractNormalization):
    def __init__(self):
        super().__init__("lowercase", lowercase_normalizers())


class Normalization(AbstractNormalization):
    pass
