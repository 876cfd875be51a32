"""S3 over its REST API, standard library only (port of
``cosmos_curate_tpu/storage/s3_rest.py``).

Byte reads (whole and ranged), object sizes, retried writes, existence
probes, paginated ListObjectsV2 and multipart upload at or above
``MULTIPART_THRESHOLD`` in parts of ``MULTIPART_CHUNK``. Every request is
signed with SigV4 (``storage/sigv4.py``). No SDK: ``storage/client.py``
serves ``s3://`` with this backend wherever ``boto3`` does not import.

Credentials come from the constructor's arguments, then the user config's
``s3`` section (``utils/user_config.py``), then ``AWS_ACCESS_KEY_ID``,
``AWS_SECRET_ACCESS_KEY`` and ``AWS_SESSION_TOKEN``. An explicit endpoint
(argument, ``s3.endpoint_url`` or ``AWS_ENDPOINT_URL``) is addressed
path-style, as MinIO and the test fake are; without one, the virtual-hosted
AWS endpoint of the region (``AWS_DEFAULT_REGION``, else ``us-east-1``).
A client holds no connection between calls: every request opens its own.
"""

from __future__ import annotations

import os
import urllib.parse
import xml.etree.ElementTree as ET
from typing import Iterator

from cosmos_curate_tpu_torch.storage.client import ObjectInfo, StorageClient
from cosmos_curate_tpu_torch.storage.retry import urlopen_with_retries
from cosmos_curate_tpu_torch.storage.sigv4 import Credentials, payload_hash, sign_request
from cosmos_curate_tpu_torch.utils.user_config import get_section

MULTIPART_THRESHOLD = 64 * 1024 * 1024
MULTIPART_CHUNK = 32 * 1024 * 1024
_RETRIES = 4


class S3Error(RuntimeError):
    def __init__(self, status: int, body: str, context: str) -> None:
        super().__init__(f"S3 {context} failed: HTTP {status}: {body[:500]}")
        self.status = status


def _split(path: str) -> tuple[str, str]:
    bucket, _, key = path[len("s3://"):].partition("/")
    return bucket, key


def _xml_ns(root: ET.Element) -> str:
    return root.tag[: root.tag.index("}") + 1] if root.tag.startswith("{") else ""


class S3RestClient(StorageClient):
    def __init__(
        self,
        *,
        access_key_id: str | None = None,
        secret_access_key: str | None = None,
        session_token: str = "",
        region: str | None = None,
        endpoint_url: str | None = None,
    ) -> None:
        cfg = get_section("s3")
        self._creds = Credentials(
            access_key_id=access_key_id or cfg.get("access_key_id") or os.environ.get("AWS_ACCESS_KEY_ID", ""),
            secret_access_key=secret_access_key or cfg.get("secret_access_key")
            or os.environ.get("AWS_SECRET_ACCESS_KEY", ""),
            session_token=session_token or os.environ.get("AWS_SESSION_TOKEN", ""),
        )
        self._region = region or cfg.get("region") or os.environ.get("AWS_DEFAULT_REGION") or "us-east-1"
        self._endpoint = (endpoint_url or cfg.get("endpoint_url") or os.environ.get("AWS_ENDPOINT_URL") or "").rstrip("/")
        if not self._creds.access_key_id or not self._creds.secret_access_key:
            raise RuntimeError(
                "s3:// access needs credentials: set s3.access_key_id/secret_access_key "
                "in the user config or AWS_ACCESS_KEY_ID/AWS_SECRET_ACCESS_KEY"
            )

    # -- wire helpers ------------------------------------------------------

    def _url_parts(self, bucket: str, key: str) -> tuple[str, str, str]:
        """(scheme, host, URI-encoded path); the path keeps any prefix of a
        custom endpoint (MinIO behind a reverse proxy's path)."""
        enc_key = urllib.parse.quote(key, safe="/-_.~")
        if self._endpoint:
            u = urllib.parse.urlparse(self._endpoint)
            prefix = u.path.rstrip("/")
            path = f"{prefix}/{bucket}/{enc_key}" if key else f"{prefix}/{bucket}"
            return u.scheme, u.netloc, path
        return "https", f"{bucket}.s3.{self._region}.amazonaws.com", f"/{enc_key}"

    def _request(
        self,
        method: str,
        bucket: str,
        key: str,
        *,
        query: dict[str, str] | None = None,
        data: bytes = b"",
        headers: dict[str, str] | None = None,
        context: str = "",
        retryable: bool = True,
    ) -> tuple[int, bytes, dict[str, str]]:
        query = query or {}
        scheme, host, url_path = self._url_parts(bucket, key)
        signed = sign_request(method=method, host=host, path=url_path, query=query, headers=headers or {},
                              payload_sha256=payload_hash(data), creds=self._creds, region=self._region)
        qs = urllib.parse.urlencode(sorted(query.items()), quote_via=urllib.parse.quote)
        url = f"{scheme}://{host}{url_path}" + (f"?{qs}" if qs else "")
        # an empty-body PUT or POST still sends Content-Length: 0 (data=None
        # would omit it, and some endpoints reject the request without it)
        body = data if data or method.upper() in ("PUT", "POST") else None
        return urlopen_with_retries(url, method=method.upper(), data=body,
                                    headers={k: v for k, v in signed.items() if k != "host"}, retries=_RETRIES,
                                    retryable=retryable, label=f"S3 {context or method}")

    # -- StorageClient -----------------------------------------------------

    def read_bytes(self, path: str) -> bytes:
        bucket, key = _split(path)
        status, body, _ = self._request("GET", bucket, key, context=f"get {path}")
        if status == 404:
            # the local backend's contract, so callers' missing-file handling
            # holds on every backend
            raise FileNotFoundError(path)
        if status != 200:
            raise S3Error(status, body.decode(errors="replace"), f"get {path}")
        return body

    def read_range(self, path: str, start: int, end: int) -> bytes:
        """The inclusive byte range ``[start, end]``."""
        bucket, key = _split(path)
        status, body, _ = self._request("GET", bucket, key, headers={"range": f"bytes={start}-{end}"},
                                        context=f"get {path}")
        if status not in (200, 206):
            raise S3Error(status, body.decode(errors="replace"), f"ranged get {path}")
        if status == 200:  # the endpoint ignored the range and sent the whole object
            return body[start : end + 1]
        return body

    def write_bytes(self, path: str, data: bytes) -> None:
        bucket, key = _split(path)
        if len(data) >= MULTIPART_THRESHOLD:
            self._multipart_upload(bucket, key, data)
            return
        status, body, _ = self._request("PUT", bucket, key, data=data, context=f"put {path}")
        if status not in (200, 201):
            raise S3Error(status, body.decode(errors="replace"), f"put {path}")

    def exists(self, path: str) -> bool:
        bucket, key = _split(path)
        status, _, _ = self._request("HEAD", bucket, key, context=f"head {path}")
        if status == 200:
            return True
        if status == 404:
            return False
        # an auth failure or a lasting outage surfaces; it never reads as absent
        raise S3Error(status, "", f"head {path}")

    def size(self, path: str) -> int:
        bucket, key = _split(path)
        status, _, headers = self._request("HEAD", bucket, key, context=f"head {path}")
        if status != 200:
            raise S3Error(status, "", f"head {path}")
        lower = {k.lower(): v for k, v in headers.items()}
        return int(lower.get("content-length", "0"))

    def delete(self, path: str) -> None:
        bucket, key = _split(path)
        status, body, _ = self._request("DELETE", bucket, key, context=f"delete {path}")
        if status not in (200, 204):
            raise S3Error(status, body.decode(errors="replace"), f"delete {path}")

    def list_files(
        self, prefix: str, *, suffixes: tuple[str, ...] | None = None, recursive: bool = True
    ) -> Iterator[ObjectInfo]:
        bucket, key = _split(prefix)
        token = ""
        while True:
            query = {"list-type": "2", "prefix": key, "max-keys": "1000"}
            if not recursive:
                query["delimiter"] = "/"
            if token:
                query["continuation-token"] = token
            status, body, _ = self._request("GET", bucket, "", query=query, context=f"list {prefix}")
            if status != 200:
                raise S3Error(status, body.decode(errors="replace"), f"list {prefix}")
            root = ET.fromstring(body)
            ns = _xml_ns(root)
            for el in root.findall(f"{ns}Contents"):
                p = f"s3://{bucket}/{el.findtext(f'{ns}Key') or ''}"
                if suffixes is None or p.lower().endswith(suffixes):
                    yield ObjectInfo(p, int(el.findtext(f"{ns}Size") or 0))
            if (root.findtext(f"{ns}IsTruncated") or "false") != "true":
                return
            token = root.findtext(f"{ns}NextContinuationToken") or ""
            if not token:
                return

    # -- multipart ---------------------------------------------------------

    def _multipart_upload(self, bucket: str, key: str, data: bytes) -> None:
        status, body, _ = self._request("POST", bucket, key, query={"uploads": ""}, context="create multipart")
        if status != 200:
            raise S3Error(status, body.decode(errors="replace"), "create multipart")
        root = ET.fromstring(body)
        upload_id = root.findtext(f"{_xml_ns(root)}UploadId") or ""
        etags: list[str] = []
        try:
            for i in range(0, len(data), MULTIPART_CHUNK):
                part = len(etags) + 1
                status, body, headers = self._request(
                    "PUT", bucket, key, query={"partNumber": str(part), "uploadId": upload_id},
                    data=data[i : i + MULTIPART_CHUNK], context=f"upload part {part}")
                if status != 200:
                    raise S3Error(status, body.decode(errors="replace"), f"part {part}")
                lower = {k.lower(): v for k, v in headers.items()}
                etags.append(lower.get("etag", '""').strip('"'))
            parts_xml = "".join(f'<Part><PartNumber>{n}</PartNumber><ETag>"{e}"</ETag></Part>'
                                for n, e in enumerate(etags, 1))
            payload = f"<CompleteMultipartUpload>{parts_xml}</CompleteMultipartUpload>".encode()
            status, body, _ = self._request("POST", bucket, key, query={"uploadId": upload_id}, data=payload,
                                            context="complete multipart")
            # S3 can answer 200 with an <Error> body when completion fails
            if status != 200 or b"<Error>" in body:
                raise S3Error(status, body.decode(errors="replace"), "complete multipart")
        except Exception:
            self._request("DELETE", bucket, key, query={"uploadId": upload_id}, context="abort multipart",
                          retryable=False)
            raise
