"""Webdataset tar shard writing (a copy of
``cosmos_curate_tpu/dataset/webdataset.py``).

Samples are groups of same-basename files inside sequentially numbered
tars (``<bucket>/shard-00000.tar`` with ``<uuid>.mp4``, ``<uuid>.json``,
``<uuid>.txt``, ``<uuid>.<name>.npy`` members), the format webdataset
loaders read. Written with the standard library's ``tarfile``. Each
member's ``mtime`` is the time of writing, so two runs' tars differ in
those bytes; their members and member bytes do not.
"""

from __future__ import annotations

import io
import json
import tarfile
import time
from typing import Any, Iterator

import numpy as np

from cosmos_curate_tpu_torch.storage.client import write_bytes


class ShardWriter:
    """Accumulates samples into size-capped tar shards."""

    def __init__(
        self,
        output_prefix: str,
        *,
        max_bytes_per_shard: int = 256 << 20,
        max_samples_per_shard: int = 512,
    ) -> None:
        self.output_prefix = output_prefix.rstrip("/")
        self.max_bytes = max_bytes_per_shard
        self.max_samples = max_samples_per_shard
        self.shard_index = 0
        self.shard_paths: list[str] = []
        self._buf: io.BytesIO | None = None
        self._tar: tarfile.TarFile | None = None
        self._samples = 0

    def _ensure_open(self) -> None:
        if self._tar is None:
            self._buf = io.BytesIO()
            self._tar = tarfile.open(fileobj=self._buf, mode="w")
            self._samples = 0

    def add_sample(self, key: str, parts: dict[str, bytes]) -> None:
        """parts: extension (e.g. "mp4", "json", "npy") -> bytes."""
        self._ensure_open()
        for ext, data in parts.items():
            info = tarfile.TarInfo(name=f"{key}.{ext}")
            info.size = len(data)
            info.mtime = int(time.time())
            self._tar.addfile(info, io.BytesIO(data))
        self._samples += 1
        if self._samples >= self.max_samples or self._buf.tell() >= self.max_bytes:
            self._flush()

    def _flush(self) -> None:
        if self._tar is None or self._samples == 0:
            return
        self._tar.close()
        path = f"{self.output_prefix}/shard-{self.shard_index:05d}.tar"
        write_bytes(path, self._buf.getvalue())
        self.shard_paths.append(path)
        self.shard_index += 1
        self._tar = None
        self._buf = None

    def close(self) -> list[str]:
        self._flush()
        return self.shard_paths


def encode_sample_parts(
    *,
    mp4: bytes | None = None,
    meta: dict[str, Any] | None = None,
    arrays: dict[str, np.ndarray] | None = None,
    text: str | None = None,
) -> dict[str, bytes]:
    parts: dict[str, bytes] = {}
    if mp4 is not None:
        parts["mp4"] = mp4
    if meta is not None:
        parts["json"] = json.dumps(meta).encode()
    if text is not None:
        parts["txt"] = text.encode()
    for name, arr in (arrays or {}).items():
        sink = io.BytesIO()
        np.save(sink, arr)
        parts[f"{name}.npy"] = sink.getvalue()
    return parts


def iter_tar_samples(data: bytes) -> Iterator[tuple[str, dict[str, bytes]]]:
    """Read back samples grouped by basename (for tests/verification)."""
    groups: dict[str, dict[str, bytes]] = {}
    order: list[str] = []
    with tarfile.open(fileobj=io.BytesIO(data)) as tar:
        for member in tar.getmembers():
            key, _, ext = member.name.partition(".")
            if key not in groups:
                groups[key] = {}
                order.append(key)
            groups[key][ext] = tar.extractfile(member).read()
    for key in order:
        yield key, groups[key]
