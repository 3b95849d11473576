"""Named registry of pretrained embeddings.

Reference: vectorian/embedding/zoo.py — fasttext-LANG (+mini zenodo
variants), numberbatch-19.08-LANG, glove-6B/42B/840B/twitter
(Zoo._init:26-68, list/load:80-93).

``Zoo.load`` resolves names to loaders over files in
$VECTORIAN_CACHE_HOME; ``Zoo.fetch`` runs the full download pipeline
(streaming fetch, sha256 verification, unzip/gunzip, numberbatch
extraction — embedding/utils.py) into the cache dir.  The network call is
injectable (``fetcher``) so zero-egress environments and tests drive the
pipeline from local fixtures."""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Optional

from vectorian_tpu_torch.embedding.fasttext import PretrainedFastText
from vectorian_tpu_torch.embedding.static import PretrainedGloVe, Word2VecVectors, cache_home


class Zoo:
    _entries: Dict[str, dict] = {}

    @staticmethod
    def _init():
        if Zoo._entries:
            return
        e = Zoo._entries
        for lang in ("en", "de", "fr", "es", "it", "nl", "pt", "ru", "zh"):
            e[f"fasttext-{lang}"] = {
                "factory": lambda lang=lang: PretrainedFastText(lang),
                "url": f"https://dl.fbaipublicfiles.com/fasttext/vectors-crawl/cc.{lang}.300.bin.gz",
                "subdir": "fasttext",
                "file": f"cc.{lang}.300.bin",
            }
        for lang in ("en", "de"):
            e[f"numberbatch-19.08-{lang}"] = {
                "factory": lambda lang=lang: Word2VecVectors(
                    f"numberbatch-19.08-{lang}",
                    cache_home() / "numberbatch" / f"numberbatch-{lang}-19.08.txt",
                ),
                "url": "https://conceptnet.s3.amazonaws.com/downloads/2019/numberbatch/numberbatch-19.08.txt.gz",
                "subdir": "numberbatch",
                "file": f"numberbatch-{lang}-19.08.txt",
                "extract_lang": lang,
            }
        for name, dims in (
            ("6B", (50, 100, 200, 300)),
            ("42B", (300,)),
            ("840B", (300,)),
            ("twitter.27B", (25, 50, 100, 200)),
        ):
            for d in dims:
                e[f"glove-{name}-{d}"] = {
                    "factory": lambda name=name, d=d: PretrainedGloVe(name, d),
                    "url": f"https://nlp.stanford.edu/data/glove.{name}.zip",
                    "subdir": "glove",
                    "file": f"glove.{name}.{d}d.txt",
                }

    @staticmethod
    def list() -> List[str]:
        Zoo._init()
        return sorted(Zoo._entries.keys())

    @staticmethod
    def _entry(name: str) -> dict:
        Zoo._init()
        entry = Zoo._entries.get(name)
        if entry is None:
            raise KeyError(
                f"unknown zoo embedding {name!r}; known: {Zoo.list()}"
            )
        return entry

    @staticmethod
    def path(name: str) -> Path:
        """Where the artifact lives once fetched."""
        e = Zoo._entry(name)
        return cache_home() / e["subdir"] / e["file"]

    @staticmethod
    def fetch(
        name: str,
        fetcher=None,
        force: bool = False,
        checksum: Optional[str] = None,
    ) -> Path:
        """Download + post-process the artifact for ``name`` into the cache
        dir (reference embedding/utils.py:42-85 download path + numberbatch
        extraction :152-183).  Idempotent: an existing artifact
        short-circuits unless ``force``."""
        from vectorian_tpu_torch.embedding.utils import (
            download,
            extract_numberbatch,
        )

        e = Zoo._entry(name)
        target = Zoo.path(name)
        if target.exists() and not force:
            return target
        got = download(
            e["url"],
            target.parent,
            force_download=force,
            checksum=checksum,
            fetcher=fetcher,
        )
        lang = e.get("extract_lang")
        if lang is not None and got is not None and got != target:
            # multilingual dump -> per-language word2vec text files
            extract_numberbatch(got, [lang])
        if not target.exists():
            raise FileNotFoundError(
                f"zoo fetch for {name!r} did not produce {target}"
            )
        return target

    @staticmethod
    def load(name: str, fetch: bool = False, fetcher=None):
        """Instantiate the named embedding; with ``fetch=True`` the missing
        artifact is downloaded first (Zoo.fetch)."""
        e = Zoo._entry(name)
        if fetch and not Zoo.path(name).exists():
            Zoo.fetch(name, fetcher=fetcher)
        return e["factory"]()

    @staticmethod
    def url(name: str) -> str:
        return Zoo._entry(name)["url"]
