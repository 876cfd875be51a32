"""Zip transport: whole directories through storage paths or presigned URLs
(port of ``cosmos_curate_tpu/storage/zip_transport.py``).

Zip and unzip are local CPU work. The bytes go through the storage layer for
``s3://``, ``gs://``, ``az://`` and local destinations, and through plain
HTTP(S) for presigned URLs, the credential-less path a job service uses when
its callers hand it URLs instead of bucket credentials. A presigned
multipart upload (:class:`PresignedMultipart`) re-sends only a failed part.
Every node of a multi-node run calls :func:`download_and_extract` itself: the
object store is the rendezvous.
"""

from __future__ import annotations

import http.client
import io
import os
import shutil
import tempfile
import urllib.request
import zipfile
from dataclasses import dataclass, field
from pathlib import Path

from cosmos_curate_tpu_torch.storage.client import read_bytes, write_bytes
from cosmos_curate_tpu_torch.storage.retry import chaos_storage_fault, sleep_backoff
from cosmos_curate_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

_HTTP = ("http://", "https://")


@dataclass
class PresignedMultipart:
    """A presigned S3 multipart upload, as a job's submitter hands it out:
    the submitter starts the upload with its own credentials and presigns
    one URL per part, the completion and optionally the abort; the uploader
    never sees a credential."""

    part_urls: list[str] = field(default_factory=list)  # part 1 first
    complete_url: str = ""
    abort_url: str | None = None
    part_size: int = 64 * 1024 * 1024  # S3's least part is 5 MiB

    @classmethod
    def from_dict(cls, d: dict) -> "PresignedMultipart":
        return cls(part_urls=list(d["part_urls"]), complete_url=d["complete_url"], abort_url=d.get("abort_url"),
                   part_size=int(d.get("part_size", 64 * 1024 * 1024)))


def zip_directory_to_file(src_dir: str | Path, zip_path: str | Path) -> int:
    """A deterministic zip of a directory tree (sorted entries, fixed
    mtimes), streamed to a file one member at a time. Returns its size."""
    root = Path(src_dir)
    with zipfile.ZipFile(zip_path, "w", zipfile.ZIP_DEFLATED) as zf:
        for f in sorted(root.rglob("*")):
            if f.is_file():
                info = zipfile.ZipInfo(str(f.relative_to(root)))
                with f.open("rb") as src, zf.open(info, "w") as dst:
                    shutil.copyfileobj(src, dst, length=1 << 20)
    return os.path.getsize(zip_path)


def zip_directory(src_dir: str | Path) -> bytes:
    """The zip of a small directory, in memory."""
    with tempfile.NamedTemporaryFile(suffix=".zip") as f:
        zip_directory_to_file(src_dir, f.name)
        f.seek(0)
        return f.read()


def zip_and_upload_directory(src_dir: str | Path, dest: "str | PresignedMultipart") -> int:
    """Zip ``src_dir`` and upload it to ``dest``: a storage path, a presigned
    HTTP URL or a :class:`PresignedMultipart`. Returns the zip's size. The
    archive is staged on local disk; a local destination takes it by a
    rename, a multipart upload holds one part in memory at a time."""
    fd, tmp = tempfile.mkstemp(suffix=".zip")
    os.close(fd)
    try:
        size = zip_directory_to_file(src_dir, tmp)
        if isinstance(dest, PresignedMultipart):
            _multipart_put(tmp, size, dest)
        elif dest.startswith(_HTTP):
            with open(tmp, "rb") as f:
                _http_request(dest, f.read(), method="PUT", retries=1)
        elif "://" not in dest:
            Path(dest).parent.mkdir(parents=True, exist_ok=True)
            shutil.move(tmp, dest)
            tmp = None  # consumed
        else:
            with open(tmp, "rb") as f:
                write_bytes(dest, f.read())
        logger.info("uploaded %s (%d bytes) -> %s", src_dir, size, _redact_dest(dest))
        return size
    finally:
        if tmp is not None and os.path.exists(tmp):
            os.unlink(tmp)


def _multipart_put(zip_path: str, size: int, spec: PresignedMultipart, *, retries: int = 3) -> None:
    """The staged zip through the presigned part URLs, each part retried on
    its own, then the completion (S3's CompleteMultipartUpload XML with the
    collected ETags). A failure aborts the upload where an abort URL was
    given."""
    n_parts = max(1, -(-size // spec.part_size))
    if n_parts > len(spec.part_urls):
        raise ValueError(f"zip needs {n_parts} parts of {spec.part_size} B but only "
                         f"{len(spec.part_urls)} presigned part URLs were provided")
    etags: list[str] = []
    try:
        with open(zip_path, "rb") as f:
            for i in range(n_parts):
                etags.append(_put_part(spec.part_urls[i], f.read(spec.part_size), retries=retries))
        parts_xml = "".join(f"<Part><PartNumber>{i + 1}</PartNumber><ETag>{e}</ETag></Part>"
                            for i, e in enumerate(etags))
        xml = f"<CompleteMultipartUpload>{parts_xml}</CompleteMultipartUpload>"
        _http_request(spec.complete_url, xml.encode(), method="POST", retries=retries)
        logger.info("multipart upload complete: %d parts, %d bytes", n_parts, size)
    except Exception:
        if spec.abort_url:
            try:
                _http_request(spec.abort_url, None, method="DELETE", retries=1)
                logger.info("aborted multipart upload after failure")
            except RuntimeError:
                logger.exception("multipart abort also failed; upload may leak parts")
        raise


def _put_part(url: str, data: bytes, *, retries: int) -> str:
    headers = _http_request(url, data, method="PUT", retries=retries)
    etag = next((v for k, v in headers.items() if k.lower() == "etag"), "")
    if not etag:
        # fail on the first part: a completion with an empty <ETag> would be
        # refused only after every byte was sent
        raise RuntimeError(f"part PUT returned no ETag header: {_redact(url)}")
    return etag


def download_and_extract(src: str, dest_dir: str | Path) -> list[str]:
    """GET a zip from a storage path or presigned URL and extract it into
    ``dest_dir``. An entry that would land outside it raises ``ValueError``
    (zip slip)."""
    dest = Path(dest_dir)
    dest.mkdir(parents=True, exist_ok=True)
    extracted: list[str] = []
    if "://" in src:
        zf_source = io.BytesIO(_http_get(src) if src.startswith(_HTTP) else read_bytes(src))
    else:
        zf_source = src  # a local path: zipfile streams from disk
    with zipfile.ZipFile(zf_source) as zf:
        for info in zf.infolist():
            if info.is_dir():
                continue
            target = dest / info.filename
            if not target.resolve().is_relative_to(dest.resolve()):
                raise ValueError(f"zip entry escapes destination: {info.filename!r}")
            target.parent.mkdir(parents=True, exist_ok=True)
            with zf.open(info) as src_f, open(target, "wb") as dst_f:
                shutil.copyfileobj(src_f, dst_f, length=1 << 20)
            extracted.append(str(target))
    logger.info("extracted %d files from %s", len(extracted), _redact(src))
    return extracted


def _http_request(url: str, data: bytes | None, *, method: str, retries: int) -> dict[str, str]:
    """The response headers of a request to a presigned URL, retried with
    this transport's slower backoff (presigned uploads are long calls)."""
    last: Exception | None = None
    for attempt in range(retries):
        try:
            chaos_storage_fault()
            req = urllib.request.Request(url, data=data, method=method)
            if method == "PUT":
                req.add_header("Content-Type", "application/zip")
            with urllib.request.urlopen(req, timeout=600) as resp:
                if resp.status >= 300:
                    raise RuntimeError(f"{method} failed with {resp.status}")
                return dict(resp.headers)
        # urllib's HTTP and connection errors are OSErrors; a torn response
        # is an HTTPException
        except (OSError, RuntimeError, http.client.HTTPException) as e:
            last = e
            if attempt + 1 < retries:
                sleep_backoff(attempt, base=1.0, cap=8.0)
    raise RuntimeError(f"{method} {_redact(url)} failed after {retries} attempts: {last}")


def _http_get(url: str) -> bytes:
    with urllib.request.urlopen(url, timeout=600) as resp:
        return resp.read()


def _redact(url: str) -> str:
    """A presigned URL carries its signature in the query: never log it."""
    return url.split("?", 1)[0] if url.startswith(_HTTP) else url


def _redact_dest(dest: "str | PresignedMultipart") -> str:
    if isinstance(dest, PresignedMultipart):
        return f"<multipart x{len(dest.part_urls)}: {_redact(dest.complete_url)}>"
    return _redact(dest)
