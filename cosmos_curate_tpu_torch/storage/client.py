"""Storage over local disk and object stores (port of
``cosmos_curate_tpu/storage/client.py``).

One path model: local paths and ``s3://``, ``gs://`` and ``az://`` URLs,
one ``StorageClient`` per backend, and module-level helpers that dispatch on
the path. ``get_storage_client`` builds a client per call (no client holds a
connection across calls or processes, so the streaming engine's spawned
workers reach a store through the environment they inherit), in the
reference's order of choice:

- ``s3://``: ``storage/s3.py`` where ``boto3`` imports, else the REST
  backend ``storage/s3_rest.py``;
- ``gs://``: ``storage/gcs.py`` where ``google.cloud.storage`` imports, else
  ``storage/gcs_rest.py``;
- ``az://``: ``storage/azure_rest.py``;

and where a backend cannot be built (no credentials), a gated client whose
construction raises ``RuntimeError`` naming what is missing. A remote path
is never read as a local file of the same name.

The module-level ``read_bytes`` / ``write_bytes`` open one ``storage.read``
/ ``storage.write`` span per request (observability/tracing.py), free when
tracing is off; the backends' attempt loops add the retries to it
(storage/retry.py). ``BackgroundUploader`` runs writes on a thread, each in
its submitter's ``contextvars`` context.

Host code: this package imports no torch.
"""

from __future__ import annotations

import abc
import contextvars
import os
import queue
import shutil
import threading
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Iterator

from cosmos_curate_tpu_torch.observability.tracing import traced_span
from cosmos_curate_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

_REMOTE_SCHEMES = ("s3://", "gs://", "az://")


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


class StorageClient(abc.ABC):
    """Byte-level storage operations, whatever the backend."""

    @abc.abstractmethod
    def read_bytes(self, path: str) -> bytes: ...

    @abc.abstractmethod
    def write_bytes(self, path: str, data: bytes) -> None: ...

    @abc.abstractmethod
    def exists(self, path: str) -> bool: ...

    @abc.abstractmethod
    def delete(self, path: str) -> None: ...

    @abc.abstractmethod
    def list_files(
        self, prefix: str, *, suffixes: tuple[str, ...] | None = None, recursive: bool = True
    ) -> Iterator[ObjectInfo]: ...

    def list_relative(self, prefix: str, *, suffixes: tuple[str, ...] | None = None) -> list[str]:
        """Paths under ``prefix``, relative to it."""
        out = []
        for info in self.list_files(prefix, suffixes=suffixes):
            rel = relative_to_prefix(info.path, prefix)
            out.append(rel if rel is not None else info.path)
        return out


class LocalStorageClient(StorageClient):
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


class _GatedClient(StorageClient):
    """A backend that cannot be built here: constructing it raises, naming
    the scheme and what is missing."""

    scheme = ""
    reason = ""

    def __init__(self) -> None:
        raise RuntimeError(f"{self.scheme} storage unavailable: {self.reason}")

    def read_bytes(self, path): ...  # pragma: no cover
    def write_bytes(self, path, data): ...  # pragma: no cover
    def exists(self, path): ...  # pragma: no cover
    def delete(self, path): ...  # pragma: no cover
    def list_files(self, prefix, *, suffixes=None, recursive=True): ...  # pragma: no cover


def _gated(scheme: str, reason: str) -> StorageClient:
    return type("Gated", (_GatedClient,), {"scheme": scheme, "reason": reason})()


def _make_s3_client() -> StorageClient:
    try:
        import boto3  # noqa: F401
    except ImportError:
        from cosmos_curate_tpu_torch.storage.s3_rest import S3RestClient

        try:
            return S3RestClient()
        except RuntimeError as e:
            return _gated("s3://", f"{e} (installing boto3 also works)")
    from cosmos_curate_tpu_torch.storage.s3 import S3StorageClient

    return S3StorageClient()


def _make_gcs_client() -> StorageClient:
    try:
        import google.cloud.storage  # noqa: F401
    except ImportError:
        from cosmos_curate_tpu_torch.storage.gcs_rest import GcsRestClient

        try:
            return GcsRestClient()
        except RuntimeError as e:
            return _gated("gs://", f"{e} (installing google-cloud-storage also works)")
    from cosmos_curate_tpu_torch.storage.gcs import GcsStorageClient

    return GcsStorageClient()


def _make_azure_client() -> StorageClient:
    # no SDK path: the REST backend is the Azure client
    from cosmos_curate_tpu_torch.storage.azure_rest import AzureRestClient

    try:
        return AzureRestClient()
    except RuntimeError as e:
        return _gated("az://", str(e))


_LOCAL = LocalStorageClient()


def get_storage_client(path: str | os.PathLike[str]) -> StorageClient:
    s = str(path)
    if s.startswith("s3://"):
        return _make_s3_client()
    if s.startswith("gs://"):
        return _make_gcs_client()
    if s.startswith("az://"):
        return _make_azure_client()
    return _LOCAL


def backend_name(path: str | os.PathLike[str]) -> str:
    s = str(path)
    for scheme in _REMOTE_SCHEMES:
        if s.startswith(scheme):
            return scheme[:-3]  # "s3://" -> "s3"
    return "local"


def read_bytes(path: str | os.PathLike[str]) -> bytes:
    """Read with one trace span per request (backend, path and bytes)."""
    p = str(path)
    with traced_span("storage.read", backend=backend_name(p), path=p) as span:
        data = get_storage_client(p).read_bytes(p)
        span.set_attribute("bytes", len(data))
        return data


def write_bytes(path: str | os.PathLike[str], data: bytes) -> None:
    """Write with one trace span per request (see :func:`read_bytes`)."""
    p = str(path)
    with traced_span("storage.write", backend=backend_name(p), path=p, bytes=len(data)):
        get_storage_client(p).write_bytes(p, data)


class BackgroundUploader:
    """Writes queued to a background thread, so a hot loop never waits on
    storage. Each write runs in its submitter's ``contextvars`` context, so
    its ``storage.write`` span parents onto the submitting stage's trace."""

    def __init__(self, max_queue: int = 64) -> None:
        self._q: queue.Queue[tuple[str, bytes, Any] | None] = queue.Queue(maxsize=max_queue)
        self._errors: list[tuple[str, Exception]] = []
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self) -> None:
        while True:
            item = self._q.get()
            if item is None:
                return
            path, data, ctx = item
            try:
                ctx.run(write_bytes, path, data)
            except Exception as e:  # recorded for close(); the thread keeps draining
                logger.exception("background upload failed: %s", path)
                self._errors.append((path, e))

    def submit(self, path: str, data: bytes) -> None:
        self._q.put((path, data, contextvars.copy_context()))

    def close(self) -> list[tuple[str, Exception]]:
        """Drain, stop, and return any failures."""
        self._q.put(None)
        self._thread.join()
        return self._errors
