"""Crash-safe artifact collection and delivery (port of
``cosmos_curate_tpu/observability/artifacts.py``).

Processes write to node-local staging dirs during the run; collection
happens after the pipeline, so artifacts survive a killed worker. The
storage layer is the rendezvous: each node's **collector** pushes its
staging tree to ``<output>/profile/collected/node<rank>/`` with

- **chunked transfer**: a file above ``chunk_bytes`` goes up as numbered
  chunk objects, so peak memory is one chunk, not one file;
- **bounded in-flight uploads**: a small thread pool fed by a bounded queue;
- **a per-node manifest** (sizes and CRC32 per file, errors per file)
  written last and atomically: a node that dies mid-collect leaves no
  manifest and can be collected again.

The **driver** then runs delivery's finalize phase: it merges the node
manifests into one run index, verifies chunk counts and CRCs, and
reassembles chunked files where the destination is local. The port runs
one node; several nodes wait for ROADMAP queue A item 15.
"""

from __future__ import annotations

import json
import os
import queue
import threading
import zlib
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any

from cosmos_curate_tpu_torch.storage.client import get_storage_client, write_bytes
from cosmos_curate_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

DEFAULT_CHUNK_BYTES = 8 * 1024 * 1024
MANIFEST_NAME = "_manifest.json"
INDEX_NAME = "index.json"


@dataclass
class CollectResult:
    node: str
    files: int = 0
    bytes: int = 0
    errors: list[str] = field(default_factory=list)


def _collected_root(output_path: str) -> str:
    return f"{output_path.rstrip('/')}/profile/collected"


class ArtifactCollector:
    """Per-node phase: push one node's staging dirs to the shared prefix."""

    def __init__(
        self,
        output_path: str,
        *,
        node_tag: str | None = None,
        chunk_bytes: int = DEFAULT_CHUNK_BYTES,
        max_in_flight: int = 4,
    ) -> None:
        self.output_path = output_path
        self.node = node_tag or os.environ.get("CURATE_NODE_RANK", "0")
        self.chunk_bytes = chunk_bytes
        self.max_in_flight = max(1, max_in_flight)
        self.dest_root = f"{_collected_root(output_path)}/node{self.node}"

    # -- upload pool -------------------------------------------------------

    def _uploader(self, q: "queue.Queue", errors: list[str], lock: threading.Lock) -> None:
        while True:
            item = q.get()
            if item is None:
                return
            rel, dest, data = item
            try:
                write_bytes(dest, data)
            except Exception as e:  # per-file isolation: record, keep going
                with lock:
                    errors.append(f"{rel}: {e!r}")

    def collect(
        self, staging_dirs: tuple[str, ...] | None = None, *, cleanup: bool = True
    ) -> CollectResult:
        if staging_dirs is None:
            from cosmos_curate_tpu_torch.observability.tracing import default_staging_dir

            staging_dirs = (default_staging_dir(),)

        result = CollectResult(node=self.node)
        manifest: dict[str, Any] = {"node": self.node, "files": {}, "errors": []}
        # bounded queue = backpressure: the walker blocks once max_in_flight
        # chunks are queued, so peak memory stays ~chunk_bytes * max_in_flight
        q: "queue.Queue" = queue.Queue(maxsize=self.max_in_flight)
        errors: list[str] = []
        lock = threading.Lock()
        workers = [
            threading.Thread(target=self._uploader, args=(q, errors, lock), daemon=True)
            for _ in range(self.max_in_flight)
        ]
        for w in workers:
            w.start()

        collected_paths: list[Path] = []
        try:
            for staging in staging_dirs:
                root = Path(staging)
                if not root.is_dir():
                    continue
                for f in sorted(root.rglob("*")):
                    if not f.is_file() or f.name == MANIFEST_NAME:
                        continue
                    rel = f"{root.name}/{f.relative_to(root)}"
                    try:
                        entry = self._submit_file(f, rel, q)
                    except Exception as e:
                        manifest["errors"].append(f"{rel}: {e!r}")
                        result.errors.append(f"{rel}: {e!r}")
                        continue
                    manifest["files"][rel] = entry
                    result.files += 1
                    result.bytes += entry["size"]
                    collected_paths.append(f)
        finally:
            for _ in workers:
                q.put(None)
            for w in workers:
                w.join()

        manifest["errors"].extend(errors)
        result.errors.extend(errors)
        # manifest last + atomic: its presence marks a complete collection
        write_bytes(
            f"{self.dest_root}/{MANIFEST_NAME}", json.dumps(manifest, indent=1).encode()
        )
        if cleanup:
            failed = {e.split(":", 1)[0] for e in manifest["errors"]}
            for staging in staging_dirs:
                root = Path(staging)
                for f in collected_paths:
                    try:
                        rel = f"{root.name}/{f.relative_to(root)}"
                    except ValueError:
                        continue
                    if rel not in failed and f.exists():
                        f.unlink()
        if result.files or result.errors:
            logger.info(
                "node %s: collected %d artifacts (%d bytes, %d errors) -> %s",
                self.node, result.files, result.bytes, len(result.errors), self.dest_root,
            )
        return result

    def _submit_file(self, f: Path, rel: str, q: "queue.Queue") -> dict[str, Any]:
        size = f.stat().st_size
        crc = 0
        if size <= self.chunk_bytes:
            data = f.read_bytes()
            crc = zlib.crc32(data)
            q.put((rel, f"{self.dest_root}/{rel}", data))
            return {"size": size, "crc32": crc, "chunks": 0}
        # chunked: stream the file so only one chunk is resident at a time
        n = 0
        with open(f, "rb") as fh:
            while True:
                data = fh.read(self.chunk_bytes)
                if not data:
                    break
                crc = zlib.crc32(data, crc)
                q.put((rel, f"{self.dest_root}/{rel}.chunk{n:05d}", data))
                n += 1
        return {"size": size, "crc32": crc, "chunks": n}


@dataclass
class DeliveryReport:
    nodes: list[str]
    files: int
    bytes: int
    errors: list[str]
    missing_nodes: list[str]

    @property
    def ok(self) -> bool:
        return not self.errors and not self.missing_nodes


def finalize_delivery(
    output_path: str,
    *,
    expected_nodes: list[str] | None = None,
    reassemble: bool = True,
) -> DeliveryReport:
    """Driver phase: merge node manifests into one run index, verify chunked
    files, and (for local destinations) reassemble chunks in place."""
    root = _collected_root(output_path)
    client = get_storage_client(root)
    is_local = "://" not in output_path

    manifests: dict[str, dict] = {}
    for info in client.list_files(root):
        # node manifests live at exactly <root>/node<tag>/_manifest.json;
        # staged artifacts are always at least one level deeper
        rel = info.path[len(root):].lstrip("/")
        parts = rel.split("/")
        if len(parts) != 2 or parts[1] != MANIFEST_NAME or not parts[0].startswith("node"):
            continue
        node = parts[0].removeprefix("node")
        try:
            manifests[node] = json.loads(client.read_bytes(info.path))
        except Exception as e:
            manifests[node] = {"files": {}, "errors": [f"unreadable manifest: {e!r}"]}

    errors: list[str] = []
    files = 0
    total = 0
    for node, man in sorted(manifests.items()):
        node_root = f"{root}/node{node}"
        errors.extend(f"node{node}: {e}" for e in man.get("errors", []))
        for rel, entry in man.get("files", {}).items():
            files += 1
            total += entry["size"]
            if entry.get("chunks"):
                chunk_paths = [
                    f"{node_root}/{rel}.chunk{i:05d}" for i in range(entry["chunks"])
                ]
                missing = [p for p in chunk_paths if not client.exists(p)]
                if missing:
                    errors.append(f"node{node}: {rel} missing {len(missing)} chunks")
                    continue
                if reassemble and is_local:
                    crc = 0
                    dest = Path(f"{node_root}/{rel}")
                    tmp = dest.with_name(dest.name + ".tmp")
                    with open(tmp, "wb") as out:
                        for p in chunk_paths:
                            data = client.read_bytes(p)
                            crc = zlib.crc32(data, crc)
                            out.write(data)
                    if crc != entry["crc32"]:
                        errors.append(f"node{node}: {rel} CRC mismatch after reassembly")
                        tmp.unlink()
                        continue
                    tmp.replace(dest)
                    for p in chunk_paths:
                        client.delete(p)

    missing_nodes = [
        n for n in (expected_nodes or []) if str(n).removeprefix("node") not in manifests
    ]
    errors.extend(f"node{n}: no manifest (node crashed before collect?)" for n in missing_nodes)

    index = {
        "nodes": sorted(manifests),
        "files": files,
        "bytes": total,
        "errors": errors,
        "missing_nodes": missing_nodes,
    }
    write_bytes(f"{root}/{INDEX_NAME}", json.dumps(index, indent=1).encode())
    return DeliveryReport(sorted(manifests), files, total, errors, missing_nodes)


def collect_artifacts(
    output_path: str,
    *,
    staging_dirs: tuple[str, ...] | None = None,
    node_tag: str | None = None,
    cleanup: bool = True,
) -> int:
    """One-node convenience wrapper (original API): collect this node's
    staging dirs and return the number of files pushed."""
    collector = ArtifactCollector(output_path, node_tag=node_tag)
    return collector.collect(staging_dirs, cleanup=cleanup).files
