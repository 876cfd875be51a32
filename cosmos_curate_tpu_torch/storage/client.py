"""Storage over local disk (port of ``cosmos_curate_tpu/storage/client.py``,
its local backend).

One path model: the module-level helpers dispatch on the path. The port
serves local paths only. A remote URL (``s3://``, ``gs://``, ``az://``)
raises ``NotImplementedError``: the reference's S3, GCS and Azure clients
wait for ROADMAP queue A item 10, and a remote path never falls back to a
local file of the same name.
"""

from __future__ import annotations

import os
import shutil
from dataclasses import dataclass
from pathlib import Path
from typing import Iterator

_REMOTE_SCHEMES = ("s3://", "gs://", "az://")
REMOTE_NOT_PORTED = "the remote storage clients (S3, GCS, Azure) are not ported yet (ROADMAP queue A item 10)"


def is_remote_path(path: str | os.PathLike[str]) -> bool:
    return str(path).startswith(_REMOTE_SCHEMES)


def relative_to_prefix(path: str, prefix: str) -> str | None:
    """``path`` relative to ``prefix``, or None when not under it.

    Exact string prefix for remote URLs; local paths are normalized first
    (a listing of ``./videos`` yields ``videos/...`` entries — a naive
    startswith would misattribute every file)."""
    base = prefix.rstrip("/")
    if path.startswith(base + "/"):
        return path[len(base) + 1:]
    if is_remote_path(prefix):
        return None
    norm_base = os.path.normpath(base)
    norm_path = os.path.normpath(path)
    if norm_path.startswith(norm_base + os.sep):
        return norm_path[len(norm_base) + 1:]
    return None


@dataclass(frozen=True)
class ObjectInfo:
    path: str
    size: int


class LocalStorageClient:
    """Byte-level storage operations on the local filesystem."""

    def read_bytes(self, path: str) -> bytes:
        return Path(path).read_bytes()

    def write_bytes(self, path: str, data: bytes) -> None:
        p = Path(path)
        p.parent.mkdir(parents=True, exist_ok=True)
        tmp = p.with_name(p.name + ".tmp")
        tmp.write_bytes(data)
        tmp.replace(p)  # atomic on POSIX

    def exists(self, path: str) -> bool:
        return Path(path).exists()

    def delete(self, path: str) -> None:
        p = Path(path)
        if p.is_dir():
            shutil.rmtree(p)
        elif p.exists():
            p.unlink()

    def list_files(
        self, prefix: str, *, suffixes: tuple[str, ...] | None = None, recursive: bool = True
    ) -> Iterator[ObjectInfo]:
        base = Path(prefix)
        if base.is_file():
            yield ObjectInfo(str(base), base.stat().st_size)
            return
        if not base.exists():
            return
        pattern = "**/*" if recursive else "*"
        for p in sorted(base.glob(pattern)):
            if p.is_file() and (suffixes is None or p.suffix.lower() in suffixes):
                yield ObjectInfo(str(p), p.stat().st_size)


_LOCAL = LocalStorageClient()


def get_storage_client(path: str | os.PathLike[str]) -> LocalStorageClient:
    if is_remote_path(path):
        raise NotImplementedError(f"{path}: {REMOTE_NOT_PORTED}")
    return _LOCAL


def read_bytes(path: str | os.PathLike[str]) -> bytes:
    p = str(path)
    return get_storage_client(p).read_bytes(p)


def write_bytes(path: str | os.PathLike[str], data: bytes) -> None:
    p = str(path)
    get_storage_client(p).write_bytes(p, data)
