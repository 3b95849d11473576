"""Importers: text -> Document (reference: vectorian/importers.py).

An Importer runs an NLP pipeline (spaCy or the built-in SimpleNLP fallback)
over text partitions, accumulates char offsets, and produces a Document with
a token table and sentence spans (reference Importer._make_doc
importers.py:158-252, compile_spans:39-77).

Importer variants mirror the reference: plain text (TextImporter:261),
chapter-structured novels (NovelImporter:296), PlayShakespeare XML
(PlayShakespeareImporter:380) and markdown (MarkdownImporter:453).
"""

from __future__ import annotations

import re
from typing import List, Optional

import numpy as np

from vectorian_tpu_torch.corpus.document import Document
from vectorian_tpu_torch.utils.nlp import SimpleNLP


def compile_token_spans(char_spans, token_idx, token_len):
    """Map char spans -> [start_token, end_token) index spans (reference
    importers.py:39-77)."""
    token_starts = np.asarray(token_idx)
    token_ends = token_starts + np.asarray(token_len)
    out = []
    for c0, c1 in char_spans:
        i0 = int(np.searchsorted(token_ends, c0, side="right"))
        i1 = int(np.searchsorted(token_starts, c1, side="left"))
        if i1 > i0:
            out.append((i0, i1))
    if not out:
        return np.zeros((0, 2), np.int32)
    return np.asarray(out, np.int32)


class Importer:
    def __init__(self, nlp=None, batch_size: int = 1):
        self._nlp = nlp if nlp is not None else SimpleNLP()
        self._batch_size = batch_size

    def _make_doc(
        self,
        partitions: List[str],
        locations: Optional[List[dict]] = None,
        metadata: Optional[dict] = None,
        contextual_encoders=(),
    ) -> Document:
        """NLP-process text partitions and assemble one Document; char
        offsets of later partitions are shifted by the accumulated text."""
        idx, lens, pos, tag = [], [], [], []
        sent_spans_chars = []
        loc_per_sent = []
        text_parts = []
        offset = 0
        ctx_chunks = {enc.name: [] for enc in contextual_encoders}

        if hasattr(self._nlp, "pipe"):
            try:
                docs = self._nlp.pipe(partitions, batch_size=self._batch_size)
            except TypeError:  # pipe() without a batch_size parameter
                docs = self._nlp.pipe(partitions)
        else:
            docs = map(self._nlp, partitions)
        for p_i, sdoc in enumerate(docs):
            j = sdoc.to_json() if hasattr(sdoc, "to_json") else sdoc
            text = j.get("text", partitions[p_i])
            for t in j["tokens"]:
                idx.append(t["start"] + offset)
                lens.append(t["end"] - t["start"])
                pos.append(t.get("pos", "X"))
                tag.append(t.get("tag", "XX"))
            for s in j["sents"]:
                sent_spans_chars.append((s["start"] + offset, s["end"] + offset))
                if locations is not None:
                    loc_per_sent.append(locations[p_i])
            for enc in contextual_encoders:
                ctx_chunks[enc.name].append(enc.encode_doc(sdoc, text))
            text_parts.append(text)
            offset += len(text) + 1  # separator newline

        full_text = "\n".join(text_parts)
        idx = np.asarray(idx, np.int32)
        lens = np.asarray(lens, np.int32)
        sent_tok = compile_token_spans(sent_spans_chars, idx, lens)

        md = dict(metadata or {})
        if locations is not None:
            md["locations"] = loc_per_sent

        ctx = {
            name: np.concatenate(chunks, axis=0) if chunks else np.zeros((0, 0))
            for name, chunks in ctx_chunks.items()
        }
        return Document(
            text=full_text,
            idx=idx,
            len_=lens,
            pos=pos,
            tag=tag,
            spans={"sentence": sent_tok},
            metadata=md,
            contextual_embeddings=ctx,
        )

    def __call__(self, text: str, **kwargs) -> Document:
        raise NotImplementedError()


class StringImporter(Importer):
    """Import a plain string (reference StringImporter)."""

    def __call__(self, text: str, title: str = "", author: str = "", **kwargs):
        return self._make_doc(
            [text], metadata={"title": title, "author": author, "origin": "str"},
            contextual_encoders=kwargs.get("contextual_encoders", ()),
        )


class TextImporter(Importer):
    """Import a plain .txt file (reference TextImporter:261)."""

    def __call__(self, path, title=None, author="", **kwargs):
        with open(path, "r", encoding="utf-8") as f:
            text = f.read()
        if title is None:
            title = str(path)
        return self._make_doc(
            [text], metadata={"title": title, "author": author, "origin": str(path)},
            contextual_encoders=kwargs.get("contextual_encoders", ()),
        )


class NovelImporter(Importer):
    """Chapter-structured plain text (reference NovelImporter:296): detects
    'CHAPTER <n>' style headings and records (book, chapter) locations."""

    _chapters = re.compile(
        r"\n\s*(chapter|book|part)\s+([0-9ivxlc]+)[^\n]*\n", re.IGNORECASE
    )

    def __call__(self, path, title=None, author="", **kwargs):
        with open(path, "r", encoding="utf-8") as f:
            text = f.read()
        if title is None:
            title = str(path)

        partitions, locations = [], []
        last = 0
        chapter = 0
        book = 0
        for m in self._chapters.finditer(text):
            if m.start() > last:
                partitions.append(text[last : m.start()])
                locations.append({"book": book, "chapter": chapter})
            kind = m.group(1).lower()
            if kind in ("book", "part"):
                book += 1
                chapter = 0
            else:
                chapter += 1
            last = m.end()
        if last < len(text):
            partitions.append(text[last:])
            locations.append({"book": book, "chapter": chapter})
        if not partitions:
            partitions = [text]
            locations = [{"book": 0, "chapter": 0}]

        return self._make_doc(
            partitions,
            locations=locations,
            metadata={"title": title, "author": author, "origin": str(path)},
            contextual_encoders=kwargs.get("contextual_encoders", ()),
        )


class PlayShakespeareImporter(Importer):
    """PlayShakespeare.com XML (reference :380): extracts acts/scenes/speech
    with speaker metadata per line."""

    def __call__(self, path, **kwargs):
        import xml.etree.ElementTree as ET

        tree = ET.parse(path)
        root = tree.getroot()
        title_el = root.find(".//title")
        title = title_el.text if title_el is not None else str(path)

        partitions, locations = [], []
        for act_i, act in enumerate(root.iter("act"), 1):
            for scene_i, scene in enumerate(act.iter("scene"), 1):
                for speech in scene.iter("speech"):
                    speaker_el = speech.find("speaker")
                    speaker = (
                        (speaker_el.text or "").strip() if speaker_el is not None else ""
                    )
                    lines = [
                        (line.text or "").strip()
                        for line in speech.iter("line")
                    ]
                    body = " ".join(x for x in lines if x)
                    if body:
                        partitions.append(body)
                        locations.append(
                            {"act": act_i, "scene": scene_i, "speaker": speaker}
                        )

        return self._make_doc(
            partitions,
            locations=locations,
            metadata={
                "title": title,
                "author": "William Shakespeare",
                "origin": str(path),
            },
            contextual_encoders=kwargs.get("contextual_encoders", ()),
        )


class MarkdownImporter(Importer):
    """Markdown (reference :453): strips formatting, keeps heading path as
    location metadata."""

    _heading = re.compile(r"^(#{1,6})\s+(.*)$", re.MULTILINE)
    _strip = [
        (re.compile(r"`{1,3}[^`]*`{1,3}"), ""),
        (re.compile(r"\*\*?|__?"), ""),
        (re.compile(r"\[([^\]]*)\]\([^)]*\)"), r"\1"),
    ]

    def __call__(self, path_or_text, title=None, author="", **kwargs):
        try:
            with open(path_or_text, "r", encoding="utf-8") as f:
                text = f.read()
            origin = str(path_or_text)
        except (OSError, ValueError):
            text = path_or_text
            origin = "str"
        if title is None:
            title = origin

        partitions, locations = [], []
        last = 0
        heading = ""
        for m in self._heading.finditer(text):
            chunk = text[last : m.start()].strip()
            if chunk:
                partitions.append(self._clean(chunk))
                locations.append({"heading": heading})
            heading = m.group(2).strip()
            last = m.end()
        chunk = text[last:].strip()
        if chunk:
            partitions.append(self._clean(chunk))
            locations.append({"heading": heading})
        if not partitions:
            partitions = [self._clean(text)]
            locations = [{"heading": ""}]

        return self._make_doc(
            partitions,
            locations=locations,
            metadata={"title": title, "author": author, "origin": origin},
            contextual_encoders=kwargs.get("contextual_encoders", ()),
        )

    def _clean(self, chunk: str) -> str:
        for pat, repl in self._strip:
            chunk = pat.sub(repl, chunk)
        return chunk
