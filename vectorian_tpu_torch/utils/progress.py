"""Progress bars gated by VECTORIAN_VERBOSE (reference vectorian/tqdm.py)."""

import os


def verbose() -> bool:
    return os.environ.get("VECTORIAN_VERBOSE", "") not in ("", "0", "false")


def set_verbose(v: bool):
    os.environ["VECTORIAN_VERBOSE"] = "1" if v else "0"


def progress(iterable, desc: str = "", total=None):
    if not verbose():
        return iterable
    try:
        from tqdm import tqdm

        return tqdm(iterable, desc=desc, total=total)
    except ImportError:  # pragma: no cover
        return iterable
