"""Azure Blob storage over its REST API, standard library only (port of
``cosmos_curate_tpu/storage/azure_rest.py``).

Byte reads (whole and ranged), blob sizes, retried writes, existence
probes, container listing with markers, and block-list upload at or above
``BLOCK_THRESHOLD`` in blocks of ``BLOCK_CHUNK``. No SDK: this backend is the
port's ``az://`` client on every machine.

Paths are ``az://<container>/<blob>``; the account comes from the
constructor, then the user config's ``azure`` section, then
``AZURE_STORAGE_ACCOUNT``. Authentication: Shared Key
(``storage/azure_shared_key.py``) with ``account_key`` /
``AZURE_STORAGE_KEY``, else a SAS token (``sas_token`` /
``AZURE_STORAGE_SAS_TOKEN``) appended to every request. An explicit
endpoint (``endpoint_url`` / ``AZURE_STORAGE_ENDPOINT``) is addressed as
Azurite is, ``http://host:port/<account>/<container>/<blob>``; without one,
``https://<account>.blob.core.windows.net``.
"""

from __future__ import annotations

import base64
import os
import urllib.parse
import xml.etree.ElementTree as ET
from typing import Iterator

from cosmos_curate_tpu_torch.storage.azure_shared_key import AzureCredentials, sign_request
from cosmos_curate_tpu_torch.storage.client import ObjectInfo, StorageClient
from cosmos_curate_tpu_torch.storage.retry import urlopen_with_retries
from cosmos_curate_tpu_torch.utils.user_config import get_section

BLOCK_THRESHOLD = 64 * 1024 * 1024
BLOCK_CHUNK = 32 * 1024 * 1024
_RETRIES = 4


class AzureError(RuntimeError):
    def __init__(self, status: int, body: str, context: str) -> None:
        super().__init__(f"Azure {context} failed: HTTP {status}: {body[:500]}")
        self.status = status


def _split(path: str) -> tuple[str, str]:
    container, _, blob = path[len("az://"):].partition("/")
    return container, blob


class AzureRestClient(StorageClient):
    def __init__(
        self,
        *,
        account_name: str | None = None,
        account_key: str | None = None,
        sas_token: str | None = None,
        endpoint_url: str | None = None,
    ) -> None:
        cfg = get_section("azure")
        self._account = account_name or cfg.get("account_name") or os.environ.get("AZURE_STORAGE_ACCOUNT", "")
        self._key = account_key or cfg.get("account_key") or os.environ.get("AZURE_STORAGE_KEY", "")
        self._sas = (sas_token or cfg.get("sas_token") or os.environ.get("AZURE_STORAGE_SAS_TOKEN", "")).lstrip("?")
        self._endpoint = (endpoint_url or cfg.get("endpoint_url") or os.environ.get("AZURE_STORAGE_ENDPOINT", "")
                          ).rstrip("/")
        if not self._account:
            raise RuntimeError(
                "az:// access needs an account: set azure.account_name in the user config or AZURE_STORAGE_ACCOUNT"
            )
        if not self._key and not self._sas:
            raise RuntimeError(
                "az:// access needs credentials: set azure.account_key or azure.sas_token "
                "(or AZURE_STORAGE_KEY / AZURE_STORAGE_SAS_TOKEN)"
            )

    # -- wire helpers ------------------------------------------------------

    def _url_parts(self, container: str, blob: str) -> tuple[str, str, str]:
        """(scheme, host, URI-encoded path)."""
        enc = urllib.parse.quote(blob, safe="/-_.~")
        tail = f"/{container}" + (f"/{enc}" if blob else "")
        if self._endpoint:
            u = urllib.parse.urlparse(self._endpoint)
            prefix = u.path.rstrip("/")
            if not prefix.endswith(f"/{self._account}"):
                prefix = f"{prefix}/{self._account}"
            return u.scheme, u.netloc, prefix + tail
        return "https", f"{self._account}.blob.core.windows.net", tail

    def _request(
        self,
        method: str,
        container: str,
        blob: str,
        *,
        query: dict[str, str] | None = None,
        data: bytes = b"",
        headers: dict[str, str] | None = None,
        context: str = "",
        retryable: bool = True,
    ) -> tuple[int, bytes, dict[str, str]]:
        query = {k.lower(): v for k, v in (query or {}).items()}
        scheme, host, url_path = self._url_parts(container, blob)
        headers = dict(headers or {})
        # an empty-body PUT or POST still sends Content-Length: 0 (Azure
        # answers 411 without it); data=None would omit it
        body = data if data or method.upper() in ("PUT", "POST") else None
        if body is not None:
            # urllib adds a content-type of its own to a request with a body:
            # pin it, so the signed and the sent values agree
            headers.setdefault("content-type", "application/octet-stream")
        if self._key:
            headers = sign_request(method=method, account=self._account, path=url_path, query=query,
                                   headers=headers, content_length=len(data),
                                   creds=AzureCredentials(self._account, self._key))
        qs = urllib.parse.urlencode(sorted(query.items()), quote_via=urllib.parse.quote)
        if self._sas and not self._key:
            # SAS only without a key: its parameters outside the signed
            # resource would void a Shared Key signature
            qs = f"{qs}&{self._sas}" if qs else self._sas
        url = f"{scheme}://{host}{url_path}" + (f"?{qs}" if qs else "")
        return urlopen_with_retries(url, method=method.upper(), data=body, headers=headers, retries=_RETRIES,
                                    retryable=retryable, label=f"Azure {context or method}")

    # -- StorageClient -----------------------------------------------------

    def read_bytes(self, path: str) -> bytes:
        container, blob = _split(path)
        status, body, _ = self._request("GET", container, blob, context=f"get {path}")
        if status == 404:
            # the local backend's contract, so callers' missing-file handling
            # holds on every backend
            raise FileNotFoundError(path)
        if status != 200:
            raise AzureError(status, body.decode(errors="replace"), f"get {path}")
        return body

    def read_range(self, path: str, start: int, end: int) -> bytes:
        """The inclusive byte range ``[start, end]``."""
        container, blob = _split(path)
        status, body, _ = self._request("GET", container, blob, headers={"range": f"bytes={start}-{end}"},
                                        context=f"get {path}")
        if status not in (200, 206):
            raise AzureError(status, body.decode(errors="replace"), f"ranged get {path}")
        if status == 200:
            return body[start : end + 1]
        return body

    def write_bytes(self, path: str, data: bytes) -> None:
        container, blob = _split(path)
        if len(data) >= BLOCK_THRESHOLD:
            self._block_upload(container, blob, data)
            return
        status, body, _ = self._request("PUT", container, blob, data=data, headers={"x-ms-blob-type": "BlockBlob"},
                                        context=f"put {path}")
        if status != 201:
            raise AzureError(status, body.decode(errors="replace"), f"put {path}")

    def exists(self, path: str) -> bool:
        container, blob = _split(path)
        status, _, _ = self._request("HEAD", container, blob, context=f"head {path}")
        if status == 200:
            return True
        if status == 404:
            return False
        raise AzureError(status, "", f"head {path}")

    def size(self, path: str) -> int:
        container, blob = _split(path)
        status, _, headers = self._request("HEAD", container, blob, context=f"head {path}")
        if status != 200:
            raise AzureError(status, "", f"head {path}")
        lower = {k.lower(): v for k, v in headers.items()}
        return int(lower.get("content-length", "0"))

    def delete(self, path: str) -> None:
        container, blob = _split(path)
        status, body, _ = self._request("DELETE", container, blob, context=f"delete {path}")
        if status not in (200, 202, 204):
            raise AzureError(status, body.decode(errors="replace"), f"delete {path}")

    def list_files(
        self, prefix: str, *, suffixes: tuple[str, ...] | None = None, recursive: bool = True
    ) -> Iterator[ObjectInfo]:
        container, blob_prefix = _split(prefix)
        marker = ""
        while True:
            query = {"restype": "container", "comp": "list", "prefix": blob_prefix, "maxresults": "1000"}
            if not recursive:
                query["delimiter"] = "/"
            if marker:
                query["marker"] = marker
            status, body, _ = self._request("GET", container, "", query=query, context=f"list {prefix}")
            if status != 200:
                raise AzureError(status, body.decode(errors="replace"), f"list {prefix}")
            root = ET.fromstring(body)
            for el in root.iter("Blob"):
                p = f"az://{container}/{el.findtext('Name') or ''}"
                if suffixes is None or p.lower().endswith(suffixes):
                    yield ObjectInfo(p, int(el.findtext("Properties/Content-Length") or 0))
            marker = root.findtext("NextMarker") or ""
            if not marker:
                return

    # -- block-list upload -------------------------------------------------

    def _block_upload(self, container: str, blob: str, data: bytes) -> None:
        """Put Block per chunk, then commit them with Put Block List (Azure's
        counterpart of an S3 multipart upload)."""
        block_ids: list[str] = []
        for i in range(0, len(data), BLOCK_CHUNK):
            bid = base64.b64encode(f"block-{len(block_ids):08d}".encode()).decode()
            status, body, _ = self._request("PUT", container, blob, query={"comp": "block", "blockid": bid},
                                            data=data[i : i + BLOCK_CHUNK], context=f"put block {len(block_ids)}")
            if status != 201:
                raise AzureError(status, body.decode(errors="replace"), f"put block {len(block_ids)}")
            block_ids.append(bid)
        blocks_xml = "".join(f"<Latest>{b}</Latest>" for b in block_ids)
        payload = f'<?xml version="1.0" encoding="utf-8"?><BlockList>{blocks_xml}</BlockList>'.encode()
        status, body, _ = self._request("PUT", container, blob, query={"comp": "blocklist"}, data=payload,
                                        context="put block list")
        if status != 201:
            raise AzureError(status, body.decode(errors="replace"), "put block list")
