"""Download + extraction machinery for pretrained embedding artifacts.

Reference: vectorian/embedding/utils.py — download+unzip (:42-85) and
numberbatch extraction (:152-183).  Differences by design:

* checksum verification (sha256) — the reference trusts the network;
* an injectable ``fetcher`` (url -> byte-chunk iterator) so zero-egress
  environments and unit tests exercise the full pipeline against local
  fixtures (the network call is the ONLY part that needs egress);
* gzip decompression (fasttext cc bins ship as .bin.gz);
* numberbatch extraction emits plain word2vec-text files loadable by
  ``Word2VecVectors`` (the reference writes gensim .kv files).
"""

from __future__ import annotations

import gzip
import hashlib
import shutil
import urllib.parse
import zipfile
from pathlib import Path
from typing import Callable, Iterable, Iterator, Optional, Sequence

import numpy as np

from vectorian_tpu_torch.utils.progress import progress as _progress


def _default_fetcher(url: str) -> Iterator[bytes]:
    """Stream a URL in chunks (urllib — no extra dependency)."""
    import urllib.request

    with urllib.request.urlopen(url) as resp:  # noqa: S310
        while True:
            chunk = resp.read(1 << 16)
            if not chunk:
                return
            yield chunk


def sha256_file(path) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def download(
    url: str,
    path,
    force_download: bool = False,
    checksum: Optional[str] = None,
    fetcher: Optional[Callable[[str], Iterable[bytes]]] = None,
) -> Optional[Path]:
    """Fetch ``url`` into directory ``path`` and post-process archives.

    Returns the result path (reference utils.py:42-85 semantics):
    ``x.zip`` extracts next to the archive — a single member is renamed to
    ``path/x`` — and the archive is removed; ``x.gz`` decompresses to
    ``path/x``; anything else stays as downloaded.  An existing result
    short-circuits unless ``force_download``.  ``checksum`` (sha256 hex of
    the downloaded artifact) deletes-and-raises on mismatch, so a torn or
    tampered download can never be cached."""
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    fname = urllib.parse.urlparse(url).path.split("/")[-1]
    download_path = path / fname
    if download_path.suffix in (".zip", ".gz"):
        result_path = path / download_path.stem
    else:
        result_path = download_path

    if result_path.exists() and not force_download:
        return result_path

    fetch = fetcher if fetcher is not None else _default_fetcher
    try:
        with open(download_path, "wb") as f:
            for chunk in _progress(
                fetch(url), desc=f"downloading {fname}"
            ):
                f.write(chunk)
    except Exception:
        download_path.unlink(missing_ok=True)
        raise

    if checksum is not None:
        got = sha256_file(download_path)
        if got != checksum:
            download_path.unlink(missing_ok=True)
            raise ValueError(
                f"checksum mismatch for {url}: expected {checksum}, "
                f"got {got}"
            )

    if download_path.suffix == ".zip":
        extracted = []
        with zipfile.ZipFile(download_path) as zf:
            for info in zf.infolist():
                if info.filename.endswith("/"):
                    continue
                # flatten: archives nest under arbitrary top-level dirs
                target = path / Path(info.filename).name
                with zf.open(info) as src, open(target, "wb") as dst:
                    shutil.copyfileobj(src, dst)
                extracted.append(target)
        if len(extracted) == 1 and extracted[0] != result_path:
            extracted[0].replace(result_path)
        download_path.unlink()
    elif download_path.suffix == ".gz":
        with gzip.open(download_path, "rb") as src, open(
            result_path, "wb"
        ) as dst:
            shutil.copyfileobj(src, dst)
        download_path.unlink()

    return result_path if result_path.exists() else None


def extract_numberbatch(path, languages: Sequence[str]) -> list:
    """Split a multilingual ConceptNet numberbatch text dump into per-
    language word2vec-text files next to it (reference utils.py:152-183;
    keys filtered to isalpha like the reference).  Input lines look like
    ``/c/en/word 0.1 0.2 ...``.  Returns the written paths; each loads
    with ``Word2VecVectors(name, path)``."""
    path = Path(path)
    languages = list(languages)
    want = set(languages)
    rows = {lang: [] for lang in languages}
    with open(path, "r", encoding="utf-8") as f:
        header = f.readline().split()
        n_lines = int(header[0])
        for _ in _progress(range(n_lines), desc="extracting numberbatch"):
            line = f.readline()
            if not line.startswith("/c/"):
                continue
            rest = line[3:]
            lang, _, rest = rest.partition("/")
            if lang not in want:
                continue
            key, _, vec = rest.partition(" ")
            if key.isalpha():
                rows[lang].append((key, vec.strip()))

    parts = path.stem.split("-")
    version = parts[1] if len(parts) > 1 else "x"
    out_paths = []
    for lang in languages:
        out = path.parent / f"{parts[0]}-{lang}-{version}.txt"
        with open(out, "w", encoding="utf-8") as f:
            dim = len(rows[lang][0][1].split()) if rows[lang] else 0
            f.write(f"{len(rows[lang])} {dim}\n")
            for key, vec in rows[lang]:
                f.write(f"{key} {vec}\n")
        out_paths.append(out)
    return out_paths


def compress_keyed_vectors(words, matrix: np.ndarray, n_dims: int):
    """PCA-compress an embedding matrix (reference utils.py:186-199,
    without the gensim container): returns (words, [n, n_dims] f32)."""
    from vectorian_tpu_torch.embedding.transform import PCACompression

    pca = PCACompression(n_dims).fit(np.asarray(matrix, np.float32))
    return list(words), np.asarray(pca.apply(matrix), np.float32)
