"""Google Cloud Storage through ``google-cloud-storage`` (port of
``cosmos_curate_tpu/storage/gcs.py``).

``storage/client.py`` builds this backend only where
``google.cloud.storage`` imports, and ``storage/gcs_rest.py`` otherwise.
The SDK honours ``STORAGE_EMULATOR_HOST``, so the tests hold this backend
against the same fake server as the REST one.
"""

from __future__ import annotations

from typing import Iterator

from cosmos_curate_tpu_torch.storage.client import ObjectInfo, StorageClient


def _split(path: str) -> tuple[str, str]:
    bucket, _, key = path[len("gs://"):].partition("/")
    return bucket, key


class GcsStorageClient(StorageClient):
    def __init__(self, **client_kwargs) -> None:
        from google.cloud import storage

        self._client = storage.Client(**client_kwargs)

    def read_bytes(self, path: str) -> bytes:
        from google.api_core.exceptions import NotFound

        bucket, key = _split(path)
        try:
            return self._client.bucket(bucket).blob(key).download_as_bytes()
        except NotFound as e:
            # a missing object raises FileNotFoundError, as on every backend
            raise FileNotFoundError(path) from e

    def write_bytes(self, path: str, data: bytes) -> None:
        bucket, key = _split(path)
        self._client.bucket(bucket).blob(key).upload_from_string(data, content_type="application/octet-stream")

    def exists(self, path: str) -> bool:
        bucket, key = _split(path)
        return self._client.bucket(bucket).blob(key).exists()

    def delete(self, path: str) -> None:
        bucket, key = _split(path)
        blob = self._client.bucket(bucket).blob(key)
        if blob.exists():
            blob.delete()

    def list_files(
        self, prefix: str, *, suffixes: tuple[str, ...] | None = None, recursive: bool = True
    ) -> Iterator[ObjectInfo]:
        bucket, key = _split(prefix)
        for blob in self._client.list_blobs(bucket, prefix=key):
            p = f"gs://{bucket}/{blob.name}"
            if suffixes is None or p.lower().endswith(suffixes):
                yield ObjectInfo(p, blob.size or 0)
