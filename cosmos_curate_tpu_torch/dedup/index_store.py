"""Persistent storage of the sharded corpus embedding index (port of
``cosmos_curate_tpu/dedup/index_store.py``, its parquet backend).

Layout, the reference's byte for byte, so an index written by either
package opens in the other:

    <root>/meta.json                        index metadata (model, dim, k, counts, backend)
    <root>/centroids.npy                    [K, D] float32 L2-normalised centroids
    <root>/pending/<tag>.parquet            in-pipeline fragment appends
    <root>/clusters/c<cid>/<frag>.parquet   per-cluster vector shards
    <root>/manifests/gen-<NNNNNN>.json      immutable snapshot manifests
    <root>/MANIFEST.json                    pointer: the current published generation
    <root>/centroids-<NNNNNN>.npy           per-generation centroids (compaction)

Every fragment has the columns ``clip_uuid`` (string), ``embedding``
(``list<double>``), ``model`` and ``provenance`` (string). The reference
builds the embedding column from one Python float per value; the port builds
the same column, and the same file bytes, from the numpy buffer
(``_embedding_column``) and reads it back through the values buffer.

``ClipWriterStage`` appends *pending* fragments during a run; the end-of-run
consolidation routes them into per-cluster shards (dedup/corpus_index.py).
Vectors are stored L2-normalised with a ``provenance`` column per row:
"random" rows (embeddings of unstaged seeded weights) are refused at
consolidation unless ``CURATE_INDEX_ALLOW_RANDOM`` opts in.

Manifests make reads snapshot-isolated for the serving path
(dedup/index_server.py): a manifest pins one generation's fragment set and
centroids file. Publication writes the immutable ``manifests/gen-<N>.json``
first, then the small ``MANIFEST.json`` pointer (an atomic rename), so a
reader sees the old or the new generation, never half of one. Compaction
(dedup/compaction.py) is the only writer of manifests.

Only the parquet backend is ported: at a local root, an index whose
``meta.json`` pins ``lance``, lance fragments, or ``backend="lance"`` raise
``NotImplementedError`` (ROADMAP queue A item 21). A remote root (``s3://``,
``gs://``, ``az://``) is parquet in both packages: lance falls back to it
with a warning, as in the reference.
"""

from __future__ import annotations

import hashlib
import io
import json
import os
from pathlib import Path

import numpy as np

from cosmos_curate_tpu_torch.storage.client import get_storage_client, is_remote_path, read_bytes, write_bytes
from cosmos_curate_tpu_torch.storage.writers import write_json, write_npy
from cosmos_curate_tpu_torch.utils import schema_stamp
from cosmos_curate_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

ALLOW_RANDOM_ENV = "CURATE_INDEX_ALLOW_RANDOM"
LANCE_NOT_PORTED = "the corpus index's lance backend is not ported yet (ROADMAP queue A item 21)"


def allow_random_provenance() -> bool:
    """Opt-in: index (and query with) vectors whose weights provenance is
    "random" anyway (tests, architecture-only runs). The default refuses: an
    index of noise silently dedups real clips against garbage."""
    return os.environ.get(ALLOW_RANDOM_ENV, "").lower() in ("1", "true", "on")


def normalize_rows(vecs: np.ndarray) -> np.ndarray:
    vecs = np.asarray(vecs, np.float32)
    return vecs / np.maximum(np.linalg.norm(vecs, axis=1, keepdims=True), 1e-8)


def _embedding_column(vecs: np.ndarray):
    """``[N, D]`` float32 -> the reference's ``list<double>`` column, built
    from the buffer: the float32 values widened to float64 (exactly what
    ``v.tolist()`` gives) under int32 offsets."""
    import pyarrow as pa

    n, d = vecs.shape
    offsets = pa.array(np.arange(0, n * d + 1, d, dtype=np.int32))
    return pa.ListArray.from_arrays(offsets, pa.array(vecs.astype(np.float64).reshape(-1)))


def _decode_embedding_column(column, n: int) -> np.ndarray:
    """``list<double>`` column -> ``[N, D]`` float32 through the arrow
    values buffer (per-row ``to_pylist`` is ~100x slower)."""
    if n == 0:
        return np.zeros((0, 0), np.float32)
    arr = column.combine_chunks() if hasattr(column, "combine_chunks") else column
    return np.asarray(arr.values, dtype=np.float32).reshape(n, -1)


def _has_lance_fragments(root: str) -> bool:
    base = Path(root)
    return any(base.glob("pending/*.lance")) or any(base.glob("clusters/*/*.lance"))


class IndexStore:
    """Fragment-level IO for one index root."""

    def __init__(self, root: str, *, backend: str | None = None) -> None:
        self.root = str(root).rstrip("/")
        meta = self.load_meta()
        backend = backend or meta.get("backend") or "parquet"
        if backend not in ("lance", "parquet"):
            raise ValueError(f"unknown index backend {backend!r}")
        if is_remote_path(self.root):
            # lance writes local roots only, in the reference too: a remote
            # index is parquet, and its root is never globbed as a local path
            if backend == "lance":
                logger.warning("lance backend unavailable for %s; falling back to parquet", self.root)
                backend = "parquet"
        elif backend == "lance" or _has_lance_fragments(self.root):
            raise NotImplementedError(f"{self.root}: {LANCE_NOT_PORTED}")
        self.backend = backend

    # -- paths ---------------------------------------------------------------

    @property
    def meta_path(self) -> str:
        return f"{self.root}/meta.json"

    @property
    def centroids_path(self) -> str:
        return f"{self.root}/centroids.npy"

    def _fragment_path(self, *parts: str) -> str:
        return f"{self.root}/{'/'.join(parts)}.parquet"

    @staticmethod
    def cluster_dir(cid: int) -> str:
        return f"c{cid:05d}"

    # -- meta / centroids ----------------------------------------------------

    def exists(self) -> bool:
        client = get_storage_client(self.root)
        return client.exists(self.meta_path) and client.exists(self.centroids_path)

    def load_meta(self) -> dict:
        client = get_storage_client(self.root)
        if not client.exists(self.meta_path):
            return {}
        try:
            return json.loads(client.read_bytes(self.meta_path))
        except (OSError, ValueError) as e:
            raise RuntimeError(f"unreadable index meta at {self.root}: {e}") from e

    def save_meta(self, meta: dict) -> None:
        write_json(self.meta_path, {**meta, "backend": self.backend})

    def load_centroids(self, rel: str | None = None) -> np.ndarray:
        """Centroids of ``rel`` (a manifest's pinned centroids file, relative
        to the root), else the live ``centroids.npy``."""
        path = f"{self.root}/{rel}" if rel else self.centroids_path
        return np.load(io.BytesIO(read_bytes(path)))

    def save_centroids(self, centroids: np.ndarray, *, generation: int | None = None) -> str:
        """Write centroids; a ``generation`` writes the immutable
        ``centroids-<N>.npy`` a manifest pins. Returns the root-relative
        path."""
        rel = f"centroids-{generation:06d}.npy" if generation else "centroids.npy"
        write_npy(f"{self.root}/{rel}", np.asarray(centroids, np.float32))
        return rel

    # -- manifests (snapshot-isolated read generations) ----------------------

    @property
    def manifest_pointer_path(self) -> str:
        return f"{self.root}/MANIFEST.json"

    def manifest_path(self, generation: int) -> str:
        return f"{self.root}/manifests/gen-{generation:06d}.json"

    def current_generation(self) -> int:
        """The published generation, or 0 (the live, unpinned view) when no
        manifest exists yet."""
        client = get_storage_client(self.root)
        if not client.exists(self.manifest_pointer_path):
            return 0
        try:
            return int(json.loads(client.read_bytes(self.manifest_pointer_path))["generation"])
        except (OSError, ValueError, KeyError, TypeError) as e:
            raise RuntimeError(f"unreadable manifest pointer at {self.root}: {e}") from e

    def read_manifest(self, generation: int | None = None) -> dict:
        """The manifest of ``generation`` (default: current). Generation 0
        synthesizes a live manifest from the current fragment listing. An
        unreadable manifest, or one published by a newer build, raises
        ``RuntimeError``."""
        gen = self.current_generation() if generation is None else generation
        if gen <= 0:
            return self.build_live_manifest()
        client = get_storage_client(self.root)
        try:
            return schema_stamp.upgrade(json.loads(client.read_bytes(self.manifest_path(gen))), "index-manifest")
        except (OSError, ValueError) as e:
            raise RuntimeError(f"unreadable manifest gen {gen} at {self.root}: {e}") from e

    def build_live_manifest(self) -> dict:
        """The generation-0 view: the current fragment listing shaped like a
        published manifest. Not isolated: concurrent writers are visible."""
        clusters: dict[str, dict] = {}
        for cid in self.cluster_fragment_counts():
            frags = self.fragment_info(f"clusters/{self.cluster_dir(cid)}")
            clusters[str(cid)] = {
                "fragments": [rel for rel, _sz in frags],
                "bytes": int(sum(sz for _rel, sz in frags)),
                "rows": 0,  # unknown without reading; compaction fills it
            }
        return schema_stamp.stamp(
            {"generation": 0, "centroids": "centroids.npy", "meta": self.load_meta(), "clusters": clusters},
            "index-manifest",
        )

    def publish_manifest(self, manifest: dict) -> int:
        """Write the immutable generation file, then flip the pointer (an
        atomic rename: readers see the old pointer or the new one)."""
        gen = int(manifest["generation"])
        if gen <= 0:
            raise ValueError("published generations start at 1")
        write_json(self.manifest_path(gen), schema_stamp.stamp(dict(manifest), "index-manifest"))
        write_bytes(
            self.manifest_pointer_path,
            json.dumps(schema_stamp.stamp({"generation": gen}, "index-manifest")).encode(),
        )
        return gen

    def list_manifests(self) -> list[int]:
        base = f"{self.root}/manifests"
        gens = []
        for info in get_storage_client(base).list_files(base, suffixes=(".json",)):
            name = info.path.rsplit("/", 1)[-1]
            if name.startswith("gen-") and name[4:-5].isdigit():
                gens.append(int(name[4:-5]))
        return sorted(gens)

    def delete_manifest(self, generation: int) -> None:
        get_storage_client(self.root).delete(self.manifest_path(generation))

    # -- fragment IO ---------------------------------------------------------

    def _write_rows(self, path: str, ids: list[str], vecs: np.ndarray, *, model: str = "",
                    provenance: str = "") -> None:
        import pyarrow as pa
        import pyarrow.parquet as pq

        n = len(ids)
        table = pa.table({"clip_uuid": pa.array([str(i) for i in ids], pa.string()),
                          "embedding": _embedding_column(np.asarray(vecs, np.float32)),
                          "model": pa.array([model] * n, pa.string()),
                          "provenance": pa.array([provenance] * n, pa.string())})
        sink = io.BytesIO()
        pq.write_table(table, sink)
        write_bytes(path, sink.getvalue())

    def _read_rows(self, path: str) -> tuple[list[str], np.ndarray, list[str], list[str]]:
        import pyarrow.parquet as pq

        table = pq.read_table(io.BytesIO(read_bytes(path)))
        ids = [str(u) for u in table.column("clip_uuid").to_pylist()]
        vecs = _decode_embedding_column(table.column("embedding"), len(ids))
        names = table.column_names
        models = table.column("model").to_pylist() if "model" in names else [""] * len(ids)
        provs = table.column("provenance").to_pylist() if "provenance" in names else [""] * len(ids)
        return ids, vecs, models, provs

    def _list_fragments(self, subdir: str) -> list[str]:
        base = f"{self.root}/{subdir}"
        return sorted(info.path for info in get_storage_client(base).list_files(base, suffixes=(".parquet",)))

    def _relpath(self, path: str) -> str:
        """Root-relative form of a fragment path (manifests store relative
        paths, so an index directory is relocatable)."""
        path = str(path)
        prefix = f"{self.root}/"
        return path[len(prefix):] if path.startswith(prefix) else path

    def fragment_info(self, subdir: str) -> list[tuple[str, int]]:
        """(root-relative path, size in bytes) per fragment under ``subdir``."""
        base = f"{self.root}/{subdir}"
        return [(self._relpath(info.path), int(info.size))
                for info in sorted(get_storage_client(base).list_files(base, suffixes=(".parquet",)),
                                   key=lambda i: i.path)]

    def read_fragments(self, rel_paths: list[str]) -> tuple[list[str], np.ndarray]:
        """Read a pinned fragment set (root-relative manifest entries) as one
        (ids, ``[N, D]``) pair. A fragment deleted after its manifest was
        superseded raises, which is why GC waits for readers to drop it."""
        ids: list[str] = []
        chunks: list[np.ndarray] = []
        for rel in rel_paths:
            i, v, _m, _p = self._read_rows(f"{self.root}/{rel}")
            ids.extend(i)
            chunks.append(v)
        vecs = np.concatenate(chunks) if chunks else np.zeros((0, 0), np.float32)
        return ids, vecs

    def delete_fragments(self, rel_paths: list[str]) -> int:
        """Delete superseded fragments (compaction GC). Missing files are
        fine: a crashed earlier GC may have removed some already."""
        n = 0
        for rel in rel_paths:
            try:
                get_storage_client(self.root).delete(f"{self.root}/{rel}")
                n += 1
            except OSError:
                logger.debug("fragment already gone: %s", rel)
        return n

    # -- pending fragments (in-pipeline appends) -----------------------------

    def write_pending_fragment(self, tag: str, ids: list[str], vecs: np.ndarray, *, model: str = "",
                               provenance: str = "") -> str:
        """One append-only fragment under ``pending/`` (``ClipWriterStage``).
        Tags are chunk-scoped, so concurrent writers touch disjoint files.
        Vectors are normalised at write."""
        path = self._fragment_path("pending", tag)
        self._write_rows(path, ids, normalize_rows(vecs), model=model, provenance=provenance)
        return path

    def list_pending(self) -> list[str]:
        return self._list_fragments("pending")

    def read_pending(self) -> tuple[list[str], np.ndarray, list[str], list[str]]:
        """All pending rows concatenated: (ids, vecs ``[N, D]``, models,
        provenances)."""
        ids: list[str] = []
        chunks: list[np.ndarray] = []
        models: list[str] = []
        provs: list[str] = []
        for path in self.list_pending():
            i, v, m, p = self._read_rows(path)
            ids.extend(i)
            chunks.append(v)
            models.extend(m)
            provs.extend(p)
        vecs = np.concatenate(chunks) if chunks else np.zeros((0, 0), np.float32)
        return ids, vecs, models, provs

    def clear_pending(self) -> int:
        paths = self.list_pending()
        for path in paths:
            get_storage_client(path).delete(path)
        return len(paths)

    # -- per-cluster shards --------------------------------------------------

    def append_cluster(self, cid: int, ids: list[str], vecs: np.ndarray) -> str:
        """Append one fragment to cluster ``cid``. Fragment names derive
        from the ids, so re-running a consolidation over the same rows
        overwrites rather than duplicates."""
        tag = hashlib.sha256("|".join(map(str, ids)).encode()).hexdigest()[:16]
        path = self._fragment_path("clusters", self.cluster_dir(cid), tag)
        self._write_rows(path, ids, normalize_rows(vecs))
        return path

    def read_cluster(self, cid: int) -> tuple[list[str], np.ndarray]:
        ids, vecs = self.read_fragments(
            [rel for rel, _sz in self.fragment_info(f"clusters/{self.cluster_dir(cid)}")])
        if len(set(ids)) != len(ids):
            # the live view can see a row twice between a compaction publish
            # and GC (the new fragment and its superseded source): keep the
            # first, or duplicates eat per-shard top-k slots
            seen: set[str] = set()
            keep = [i for i, u in enumerate(ids) if not (u in seen or seen.add(u))]
            ids = [ids[i] for i in keep]
            vecs = vecs[keep]
        return ids, vecs

    def cluster_fragment_counts(self) -> dict[int, int]:
        """cid -> fragment count, for clusters that have any data."""
        base = f"{self.root}/clusters"
        out: dict[int, int] = {}
        for info in get_storage_client(base).list_files(base, suffixes=(".parquet",)):
            head = info.path[len(base):].lstrip("/").split("/", 1)[0]
            if head.startswith("c") and head[1:].isdigit():
                cid = int(head[1:])
                out[cid] = out.get(cid, 0) + 1
        return out
