"""Google Cloud Storage over its JSON API, standard library only (port of
``cosmos_curate_tpu/storage/gcs_rest.py``).

``storage/client.py`` serves ``gs://`` with this backend wherever
``google.cloud.storage`` does not import. Authentication is a bearer token
(``GCS_OAUTH_TOKEN``, else the user config's ``gcs.oauth_token``);
``STORAGE_EMULATOR_HOST`` selects an unauthenticated emulator endpoint, as
Google's own client libraries do.
"""

from __future__ import annotations

import json
import os
import urllib.parse
from typing import Iterator

from cosmos_curate_tpu_torch.storage.client import ObjectInfo, StorageClient
from cosmos_curate_tpu_torch.storage.retry import urlopen_with_retries
from cosmos_curate_tpu_torch.utils.user_config import get_section

_RETRIES = 4


class GcsError(RuntimeError):
    def __init__(self, status: int, body: str, context: str) -> None:
        super().__init__(f"GCS {context} failed: HTTP {status}: {body[:500]}")
        self.status = status


def _split(path: str) -> tuple[str, str]:
    bucket, _, key = path[len("gs://"):].partition("/")
    return bucket, key


class GcsRestClient(StorageClient):
    def __init__(self, *, host: str | None = None, token: str | None = None) -> None:
        cfg = get_section("gcs")
        self._host = (host or os.environ.get("STORAGE_EMULATOR_HOST") or "https://storage.googleapis.com").rstrip("/")
        if not self._host.startswith("http"):
            self._host = f"http://{self._host}"
        self._token = token or os.environ.get("GCS_OAUTH_TOKEN") or cfg.get("oauth_token") or ""
        emulator = "STORAGE_EMULATOR_HOST" in os.environ or host is not None
        if not self._token and not emulator:
            raise RuntimeError(
                "gs:// access needs an OAuth token (GCS_OAUTH_TOKEN / gcs.oauth_token) or STORAGE_EMULATOR_HOST"
            )

    def _request(
        self,
        method: str,
        url: str,
        *,
        data: bytes = b"",
        content_type: str = "application/octet-stream",
        context: str = "",
    ) -> tuple[int, bytes]:
        headers = {}
        if self._token:
            headers["authorization"] = f"Bearer {self._token}"
        if data:
            headers["content-type"] = content_type
        # an empty-body POST (a zero-byte object) still sends
        # Content-Length: 0; data=None would omit it
        body = data if data or method.upper() == "POST" else None
        status, payload, _ = urlopen_with_retries(url, method=method, data=body, headers=headers, retries=_RETRIES,
                                                  label=f"GCS {context or method}")
        return status, payload

    def _obj_url(self, bucket: str, key: str, **params: str) -> str:
        qs = urllib.parse.urlencode(params)
        return f"{self._host}/storage/v1/b/{bucket}/o/{urllib.parse.quote(key, safe='')}" + (f"?{qs}" if qs else "")

    def read_bytes(self, path: str) -> bytes:
        bucket, key = _split(path)
        status, body = self._request("GET", self._obj_url(bucket, key, alt="media"), context=f"get {path}")
        if status == 404:
            # the local backend's contract, so callers' missing-file handling
            # holds on every backend
            raise FileNotFoundError(path)
        if status != 200:
            raise GcsError(status, body.decode(errors="replace"), f"get {path}")
        return body

    def write_bytes(self, path: str, data: bytes) -> None:
        bucket, key = _split(path)
        url = f"{self._host}/upload/storage/v1/b/{bucket}/o?" + urllib.parse.urlencode(
            {"uploadType": "media", "name": key})
        status, body = self._request("POST", url, data=data, context=f"put {path}")
        if status != 200:
            raise GcsError(status, body.decode(errors="replace"), f"put {path}")

    def exists(self, path: str) -> bool:
        bucket, key = _split(path)
        status, body = self._request("GET", self._obj_url(bucket, key), context=f"stat {path}")
        if status == 200:
            return True
        if status == 404:
            return False
        # an auth failure or a lasting outage surfaces; it never reads as absent
        raise GcsError(status, body.decode(errors="replace"), f"stat {path}")

    def delete(self, path: str) -> None:
        bucket, key = _split(path)
        status, body = self._request("DELETE", self._obj_url(bucket, key), context=f"delete {path}")
        if status not in (200, 204, 404):
            raise GcsError(status, body.decode(errors="replace"), f"delete {path}")

    def list_files(
        self, prefix: str, *, suffixes: tuple[str, ...] | None = None, recursive: bool = True
    ) -> Iterator[ObjectInfo]:
        bucket, key = _split(prefix)
        token = ""
        while True:
            params = {"prefix": key, "maxResults": "1000"}
            if not recursive:
                params["delimiter"] = "/"
            if token:
                params["pageToken"] = token
            url = f"{self._host}/storage/v1/b/{bucket}/o?" + urllib.parse.urlencode(params)
            status, body = self._request("GET", url, context=f"list {prefix}")
            if status != 200:
                raise GcsError(status, body.decode(errors="replace"), f"list {prefix}")
            payload = json.loads(body or b"{}")
            for item in payload.get("items", []):
                p = f"gs://{bucket}/{item['name']}"
                if suffixes is None or p.lower().endswith(suffixes):
                    yield ObjectInfo(p, int(item.get("size", 0)))
            token = payload.get("nextPageToken", "")
            if not token:
                return
