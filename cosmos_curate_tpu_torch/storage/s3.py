"""S3 through ``boto3`` (port of ``cosmos_curate_tpu/storage/s3.py``).

``storage/client.py`` builds this backend only where ``boto3`` imports, and
``storage/s3_rest.py`` otherwise. The session's keyword arguments come from
the user config's ``s3`` section; without them boto3's own chain of
environment variables and files applies.
"""

from __future__ import annotations

from typing import Iterator

from cosmos_curate_tpu_torch.storage.client import ObjectInfo, StorageClient
from cosmos_curate_tpu_torch.utils.user_config import s3_session_kwargs


def _split(path: str) -> tuple[str, str]:
    bucket, _, key = path[len("s3://"):].partition("/")
    return bucket, key


class S3StorageClient(StorageClient):
    def __init__(self, **session_kwargs) -> None:
        import boto3

        if not session_kwargs:
            session_kwargs = s3_session_kwargs()
        endpoint = session_kwargs.pop("endpoint_url", None)
        self._s3 = boto3.session.Session(**session_kwargs).client("s3", endpoint_url=endpoint)

    def read_bytes(self, path: str) -> bytes:
        bucket, key = _split(path)
        try:
            return self._s3.get_object(Bucket=bucket, Key=key)["Body"].read()
        except self._s3.exceptions.ClientError as e:
            # a missing object raises FileNotFoundError, as on every backend
            if e.response.get("Error", {}).get("Code", "") in ("NoSuchKey", "404", "NotFound"):
                raise FileNotFoundError(path) from e
            raise

    def write_bytes(self, path: str, data: bytes) -> None:
        bucket, key = _split(path)
        self._s3.put_object(Bucket=bucket, Key=key, Body=data)

    def exists(self, path: str) -> bool:
        bucket, key = _split(path)
        try:
            self._s3.head_object(Bucket=bucket, Key=key)
            return True
        except self._s3.exceptions.ClientError:
            return False

    def delete(self, path: str) -> None:
        bucket, key = _split(path)
        self._s3.delete_object(Bucket=bucket, Key=key)

    def list_files(
        self, prefix: str, *, suffixes: tuple[str, ...] | None = None, recursive: bool = True
    ) -> Iterator[ObjectInfo]:
        bucket, key = _split(prefix)
        for page in self._s3.get_paginator("list_objects_v2").paginate(Bucket=bucket, Prefix=key):
            for obj in page.get("Contents", []):
                p = f"s3://{bucket}/{obj['Key']}"
                if suffixes is None or p.lower().endswith(suffixes):
                    yield ObjectInfo(p, obj["Size"])
