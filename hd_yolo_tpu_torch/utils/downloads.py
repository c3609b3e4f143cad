"""Weight and artifact resolution without a network (port of
``hd_yolo_tpu/utils/downloads.py``, the resolver behind ``train.py
--weights``).

An artifact resolves from local search paths, in this order:

  1. the path itself (absolute or relative to the working directory),
  2. ``$HD_YOLO_WEIGHTS_DIR``,
  3. ``<repo>/weights/``,
  4. ``$HD_YOLO_CACHE_DIR``, else ``~/.cache/hd_yolo_tpu/``.

An optional sha256 pin guards against a corrupt or stale file.  A
``scheme://...`` name goes through a fetcher a deployment registers
(``register_fetcher``) and lands in the cache; nothing here opens a socket.
"""

from __future__ import annotations

import hashlib
import os
import shutil
from pathlib import Path
from typing import Callable, Dict, Optional

from .. import LOGGER

_FETCHERS: Dict[str, Callable[[str, Path], None]] = {}


def cache_dir() -> Path:
    d = Path(os.environ.get("HD_YOLO_CACHE_DIR", "~/.cache/hd_yolo_tpu")).expanduser()
    d.mkdir(parents=True, exist_ok=True)
    return d


def register_fetcher(scheme: str, fn: Callable[[str, Path], None]) -> None:
    """Register a loader for ``scheme://...`` artifact names (e.g. a
    deployment's blob store); ``fn(uri, dest_path)`` writes the file."""
    _FETCHERS[scheme] = fn


def sha256_of(path: Path, chunk: int = 1 << 20) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for b in iter(lambda: f.read(chunk), b""):
            h.update(b)
    return h.hexdigest()


def _search_paths(name: str):
    yield Path(name)
    env = os.environ.get("HD_YOLO_WEIGHTS_DIR")
    if env:
        yield Path(env) / name
    yield Path(__file__).resolve().parents[2] / "weights" / name
    yield cache_dir() / name


def attempt_download(name: str, sha256: Optional[str] = None) -> Path:
    """The first existing path of ``name`` in the search order; a
    ``scheme://...`` name is fetched into the cache by its registered
    fetcher once.  Raises ``FileNotFoundError`` listing the places searched,
    and ``IOError`` when the file's sha256 is not ``sha256``."""
    if "://" in str(name):
        scheme, rest = str(name).split("://", 1)
        dest = cache_dir() / Path(rest).name
        if not dest.exists():
            if scheme not in _FETCHERS:
                raise FileNotFoundError(
                    f"no fetcher registered for scheme {scheme!r} (nothing is downloaded: "
                    f"register one with register_fetcher)")
            _FETCHERS[scheme](str(name), dest)
        return _verify(dest, sha256)

    tried = []
    for p in _search_paths(str(name)):
        tried.append(str(p))
        if p.is_file():
            return _verify(p, sha256)
    raise FileNotFoundError(f"artifact {name!r} not found; searched: {tried}. "
                            f"Place it in $HD_YOLO_WEIGHTS_DIR or {cache_dir()}")


def _verify(path: Path, sha256: Optional[str]) -> Path:
    if sha256:
        got = sha256_of(path)
        if got != sha256:
            raise IOError(f"{path}: sha256 mismatch (got {got[:12]}…, want {sha256[:12]}…)")
    LOGGER.debug(f"resolved artifact {path}")
    return path


def stage_artifact(src: str, name: Optional[str] = None) -> Path:
    """Copy a local file into the cache under ``name``."""
    srcp = Path(src)
    dest = cache_dir() / (name or srcp.name)
    if srcp.resolve() != dest.resolve():
        shutil.copy2(srcp, dest)
    return dest
