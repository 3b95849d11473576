"""Location formatting for matches (reference: vectorian/render/location.py).

Formats the per-slice location metadata emitted by the importers
(play act/scene/speaker, book/chapter, markdown heading, plain text)."""

from __future__ import annotations

from collections import namedtuple

Location = namedtuple("Location", ["speaker", "location"])

_ROMAN = [
    (1000, "M"), (900, "CM"), (500, "D"), (400, "CD"), (100, "C"),
    (90, "XC"), (50, "L"), (40, "XL"), (10, "X"), (9, "IX"), (5, "V"),
    (4, "IV"), (1, "I"),
]


def to_roman(n: int) -> str:
    out = []
    for v, s in _ROMAN:
        while n >= v:
            out.append(s)
            n -= v
    return "".join(out)


class PlayLocationFormatter:
    def __call__(self, document, location):
        speaker = location.get("speaker")
        if speaker:
            act = location.get("act", 0)
            scene = location.get("scene", 0)
            if act > 0:
                return Location(speaker, f"{to_roman(act)}.{scene}")
            return Location(speaker, "")
        return None


class MarkdownLocationFormatter:
    def __call__(self, document, location):
        heading = location.get("heading")
        if heading is not None:
            return Location("", heading)
        return None


class BookLocationFormatter:
    def __call__(self, document, location):
        chapter = location.get("chapter", 0)
        if chapter > 0:
            book = location.get("book", 0)
            if book <= 0:
                return Location("", f"Chapter {chapter}")
            return Location("", f"Book {book}, Chapter {chapter}")
        return None


class TextLocationFormatter:
    def __call__(self, document, location):
        slice_start = location.get("slice_start")
        if slice_start is not None:
            return Location("", f"token {slice_start}")
        return None


class LocationFormatter:
    def __init__(self):
        self._formatters = [
            PlayLocationFormatter(),
            BookLocationFormatter(),
            MarkdownLocationFormatter(),
            TextLocationFormatter(),
        ]

    def add(self, formatter):
        self._formatters.insert(0, formatter)

    def __call__(self, document, location):
        for f in self._formatters:
            out = f(document, location)
            if out is not None:
                return out
        return None
