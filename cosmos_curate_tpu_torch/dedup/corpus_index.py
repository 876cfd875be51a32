"""Persistent sharded IVF corpus index: dedup by query instead of per-run
k-means (port of ``cosmos_curate_tpu/dedup/corpus_index.py``).

- **centroids** come from the port's ``kmeans_fit`` on ``device`` ("cuda"
  unless the caller asks for the CPU);
- **corpus vectors** live in per-cluster parquet shards
  (dedup/index_store.py), appended in-pipeline by ``ClipWriterStage`` and
  consolidated at the end of a run;
- **queries** are routed on the host to their top-``nprobe`` clusters by
  one centroid product (``route_queries``, numpy, as in the reference), then
  scored on the card: per probed shard, ``q @ shard.T`` and a per-row top-k
  in fp32 with TF32 off (``DeviceTopK``). The dedup threshold compares
  similarities at ``1 - eps`` (0.93 by default); TF32's 10-bit mantissa
  would move that decision. The top-k keeps ``jax.lax.top_k``'s tie order,
  lower index first (a stable descending sort), which ``torch.topk`` does
  not promise.

The reference pads each shard's query group to a power of two to bound
XLA's compile cache; the port has no such cache and scores the group as it
is. Its ``mesh`` becomes ``device``: sharding queries over several cards
waits for ROADMAP queue A item 7. Operations fold into stage_timer's index
aggregate (``record_index_ops``) and the shard cache's byte traffic into its
search aggregate (``record_search``), under the caller's ``metrics_name``,
as in the reference; each index also keeps the same counts on itself
(``CorpusIndex.ops``, in ``stats()``).
"""

from __future__ import annotations

import os
import threading
import time

import numpy as np
import torch

from cosmos_curate_tpu_torch.core.model import model_device
from cosmos_curate_tpu_torch.dedup.index_store import IndexStore, allow_random_provenance, normalize_rows
from cosmos_curate_tpu_torch.dedup.kmeans import _fp32, kmeans_fit
from cosmos_curate_tpu_torch.observability.stage_timer import record_index_ops, record_search
from cosmos_curate_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

DEFAULT_NPROBE = 8
DEFAULT_TOP_K = 8
# Loaded cluster shards cached per index instance, evicted by BYTES (a
# skewed corpus has 4 GB clusters beside 2 MB ones); the entry cap is a
# secondary bound for many-tiny-shard layouts. The budget should exceed the
# typical probe union (about min(Q * nprobe, K) shards), or every query
# batch re-reads its shards.
CLUSTER_CACHE_ENTRIES_ENV = "CURATE_INDEX_CACHE_SHARDS"
DEFAULT_CLUSTER_CACHE_ENTRIES = 512
CLUSTER_CACHE_BYTES_ENV = "CURATE_INDEX_CACHE_BYTES"
DEFAULT_CLUSTER_CACHE_BYTES = 256 << 20


def _cluster_cache_entries() -> int:
    return max(1, int(os.environ.get(CLUSTER_CACHE_ENTRIES_ENV, "") or DEFAULT_CLUSTER_CACHE_ENTRIES))


def cluster_cache_bytes() -> int:
    return max(1, int(os.environ.get(CLUSTER_CACHE_BYTES_ENV, "") or DEFAULT_CLUSTER_CACHE_BYTES))


def shard_nbytes(ids: list[str], mat: np.ndarray) -> int:
    """Host-memory estimate of one loaded shard: the matrix plus a rough
    per-id string overhead."""
    return int(mat.nbytes) + 64 * len(ids)


class Counts:
    """Thread-safe named counters: what the reference records through its
    stage timer, kept on the object that counts."""

    def __init__(self, *names: str) -> None:
        self._lock = threading.Lock()
        self._counts = dict.fromkeys(names, 0)

    def add(self, **deltas) -> None:
        with self._lock:
            for k, v in deltas.items():
                self._counts[k] += v

    def snapshot(self) -> dict:
        with self._lock:
            return dict(self._counts)


class ShardCache:
    """Byte-budgeted LRU over loaded cluster shards, keyed by
    ``(generation, cluster_id)``: shared by the batch path
    (:class:`CorpusIndex`, generation 0 = the live view) and the serving
    path (dedup/index_server.py snapshots).

    Admission and eviction are sized by :func:`shard_nbytes` (budget: the
    constructor's, else ``CURATE_INDEX_CACHE_BYTES`` read per access).
    ``pinned`` keys (the in-flight batch's probe union) are never evicted
    mid-batch; a shard larger than the whole budget is never cached.
    ``max_entries`` (int or callable) bounds the entry count too.
    ``drop_generation`` purges a superseded snapshot's shards when its
    refcount drains; ``invalidate`` drops one entry after an append.
    Thread-safe; hit / miss / evicted bytes are kept in ``stats()`` and
    folded into stage_timer's search aggregate under ``metrics_name``."""

    def __init__(self, budget_bytes: int | None = None, *, metrics_name: str = "index_server",
                 max_entries=None) -> None:
        self._budget_fixed = int(budget_bytes) if budget_bytes else None
        self._max_entries = max_entries
        self.metrics_name = metrics_name
        self._lock = threading.Lock()
        # insertion-ordered: oldest first = LRU victim order
        self._entries: dict[tuple[int, int], tuple[list[str], np.ndarray, int]] = {}
        self.bytes = 0
        self.hit_bytes = 0
        self.miss_bytes = 0
        self.evicted_bytes = 0

    @property
    def budget(self) -> int:
        return self._budget_fixed or cluster_cache_bytes()

    def _entry_cap(self) -> int | None:
        cap = self._max_entries
        return cap() if callable(cap) else cap

    def get(self, generation: int, cid: int, loader,
            pinned: frozenset[tuple[int, int]] = frozenset()) -> tuple[list[str], np.ndarray]:
        key = (generation, cid)
        with self._lock:
            entry = self._entries.get(key)
            if entry is not None:
                self._entries[key] = self._entries.pop(key)  # LRU touch
                self.hit_bytes += entry[2]
                _record_search_bytes(self.metrics_name, cache_hit_bytes=entry[2])
                return entry[0], entry[1]
        ids, mat = loader()
        nbytes = shard_nbytes(ids, mat)
        budget = self.budget
        cap = self._entry_cap()
        with self._lock:
            self.miss_bytes += nbytes
            _record_search_bytes(self.metrics_name, cache_miss_bytes=nbytes)
            if nbytes > budget:
                return ids, mat  # never cache what cannot fit
            evicted = 0
            for victim in [k for k in self._entries if k not in pinned]:
                if self.bytes + nbytes <= budget and (cap is None or len(self._entries) < cap):
                    break
                vbytes = self._entries.pop(victim)[2]
                self.bytes -= vbytes
                evicted += vbytes
            if evicted:
                self.evicted_bytes += evicted
                _record_search_bytes(self.metrics_name, cache_evicted_bytes=evicted)
            if (self.bytes + nbytes <= budget and (cap is None or len(self._entries) < cap)
                    and key not in self._entries):
                self._entries[key] = (ids, mat, nbytes)
                self.bytes += nbytes
        return ids, mat

    def invalidate(self, generation: int, cid: int) -> None:
        """Drop one entry (its backing shard grew; reload on demand)."""
        with self._lock:
            entry = self._entries.pop((generation, cid), None)
            if entry is not None:
                self.bytes -= entry[2]

    def drop_generation(self, generation: int) -> int:
        """Purge every shard of a drained generation; returns bytes freed."""
        with self._lock:
            victims = [k for k in self._entries if k[0] == generation]
            freed = sum(self._entries.pop(key)[2] for key in victims)
            self.bytes -= freed
        if freed:
            logger.info("shard cache: drained generation %d (%d shards, %.1f MB)", generation, len(victims),
                        freed / 2**20)
        return freed

    def stats(self) -> dict:
        with self._lock:
            return {"budget_bytes": self.budget, "resident_bytes": self.bytes,
                    "resident_shards": len(self._entries), "hit_bytes": self.hit_bytes,
                    "miss_bytes": self.miss_bytes, "evicted_bytes": self.evicted_bytes}


def topk_rows(sims: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-row top-``k`` of ``sims`` in ``jax.lax.top_k``'s order: values
    descending, equal values lower index first (a stable descending sort;
    ``torch.topk`` promises no tie order)."""
    vals, idxs = torch.sort(sims, dim=1, descending=True, stable=True)
    return vals[:, :k], idxs[:, :k]


class DeviceTopK:
    """The scoring products on ``device`` ("cuda" unless the caller asks
    for the CPU), shared by the batch path (``CorpusIndex``) and the
    snapshot reader (index_server.py).

    One call scores a query batch against many shards: each job is (rows of
    ``q``, shard ``[N, D]``, k), and every job's product and top-k are
    launched before the first result is read back, so the host waits for
    the device once a call."""

    def __init__(self, device: str | torch.device = "cuda") -> None:
        self.device = model_device(device, "the corpus index's scoring")

    def __call__(self, q: np.ndarray,
                 jobs: list[tuple[list[int], np.ndarray, int]]) -> list[tuple[np.ndarray, np.ndarray]]:
        """Host (vals ``[m, k]`` float32, idxs ``[m, k]`` int64) per job: the
        per-row top-k of ``q[rows] @ shard.T``."""
        dev = self.device
        out = []
        with torch.inference_mode(), _fp32(dev):
            q_dev = torch.from_numpy(np.ascontiguousarray(q, np.float32)).to(dev)
            for rows, shard, k in jobs:
                sub = q_dev[torch.as_tensor(rows, dtype=torch.long).to(dev)]
                mat = torch.from_numpy(np.ascontiguousarray(shard, np.float32)).to(dev)
                out.append(topk_rows(sub @ mat.T, k))
            return [(v.cpu().numpy(), i.cpu().numpy()) for v, i in out]


def route_queries(q: np.ndarray, centroids: np.ndarray, nprobe: int) -> dict[int, list[int]]:
    """The routing product, on the host: cluster id -> query row indices
    that probe it (each query takes its top-``nprobe`` centroids).
    ``nprobe`` clamps to [1, K]."""
    cent_sims = q @ centroids.T  # [Q, K]
    nprobe = max(1, min(nprobe, centroids.shape[0]))
    probed = np.argpartition(cent_sims, -nprobe, axis=1)[:, -nprobe:]
    by_cluster: dict[int, list[int]] = {}
    for qi in range(len(q)):
        for cid in probed[qi]:
            by_cluster.setdefault(int(cid), []).append(qi)
    return by_cluster


def score_shards(q: np.ndarray, by_cluster: dict[int, list[int]],
                 loaded: list[tuple[int, list[str], np.ndarray]], top_k: int,
                 device_topk: DeviceTopK) -> list[list[tuple[str, float]]]:
    """One product per probed shard over the queries that probed it (one
    ``device_topk`` call for all of them); candidates merge on the host as
    arrays, an id that surfaces from several shards once. Shared by the
    batch path and the snapshot reader."""
    n = len(q)
    per_q_vals: list[list[np.ndarray]] = [[] for _ in range(n)]
    per_q_ids: list[list[np.ndarray]] = [[] for _ in range(n)]
    jobs = [(by_cluster[cid], mat, min(top_k, len(cids))) for cid, cids, mat in loaded]
    for (cid, cids, _mat), (vals, idxs) in zip(loaded, device_topk(q, jobs), strict=True):
        hit_ids = np.asarray(cids, object)[idxs]  # [m, kk] of id strings
        for row, qi in enumerate(by_cluster[cid]):
            per_q_vals[qi].append(vals[row])
            per_q_ids[qi].append(hit_ids[row])
    results: list[list[tuple[str, float]]] = []
    for qi in range(n):
        if not per_q_vals[qi]:
            results.append([])
            continue
        v = np.concatenate(per_q_vals[qi])
        ids_q = np.concatenate(per_q_ids[qi])
        row: list[tuple[str, float]] = []
        seen: set[str] = set()
        for j in np.argsort(-v):
            hid = ids_q[j]
            if hid in seen:
                continue
            seen.add(hid)
            row.append((str(hid), float(v[j])))
            if len(row) == top_k:
                break
        results.append(row)
    return results


class CorpusIndex:
    """One opened index: centroids and meta in memory, cluster shards loaded
    (and cached) on demand. ``build`` / ``open`` are the entry points."""

    def __init__(self, store: IndexStore, meta: dict, centroids: np.ndarray, *,
                 device: str | torch.device = "cuda", metrics_name: str = "corpus_index") -> None:
        self.store = store
        self.meta = meta
        self.centroids = np.asarray(centroids, np.float32)
        self._topk = DeviceTopK(device)
        self.device = self._topk.device
        self.metrics_name = metrics_name
        self.cache = ShardCache(metrics_name=metrics_name, max_entries=_cluster_cache_entries)
        self.ops = Counts("adds", "add_s", "queries", "probes", "query_s", "duplicates")

    # -- lifecycle -----------------------------------------------------------

    @staticmethod
    def exists(root: str) -> bool:
        return IndexStore(root).exists()

    @classmethod
    def open(cls, root: str, *, device: str | torch.device = "cuda",
             metrics_name: str = "corpus_index") -> "CorpusIndex":
        store = IndexStore(root)
        if not store.exists():
            raise FileNotFoundError(f"no corpus index at {root} (run `index build` first)")
        return cls(store, store.load_meta(), store.load_centroids(), device=device, metrics_name=metrics_name)

    @classmethod
    def build(cls, root: str, ids: list[str], vecs: np.ndarray, *, model: str = "", k: int | None = None,
              iters: int = 20, seed: int = 0, device: str | torch.device = "cuda", provenance: str = "",
              backend: str | None = None, metrics_name: str = "corpus_index") -> "CorpusIndex":
        """Train centroids on ``vecs`` (the port's k-means on ``device``) and
        write the initial per-cluster shards."""
        if len(ids) == 0:
            raise ValueError("cannot build an index from zero vectors")
        t0 = time.monotonic()
        normed = normalize_rows(vecs)
        k = k or max(1, int(np.sqrt(len(ids))))
        centroids, assign = kmeans_fit(normed, k, iters=iters, seed=seed, device=device)
        store = IndexStore(root, backend=backend)
        store.save_centroids(centroids)
        for cid in np.unique(assign):
            members = np.flatnonzero(assign == cid)
            store.append_cluster(int(cid), [ids[m] for m in members], normed[members])
        meta = {
            "version": 1,
            "model": model,
            "dim": int(normed.shape[1]),
            "k": int(centroids.shape[0]),
            "num_vectors": len(ids),
            "nprobe_default": DEFAULT_NPROBE,
            "provenance": provenance,
        }
        store.save_meta(meta)
        logger.info("built corpus index at %s: %d vectors, %d clusters, dim %d", root, len(ids), meta["k"],
                    meta["dim"])
        index = cls(store, store.load_meta(), centroids, device=device, metrics_name=metrics_name)
        add_s = time.monotonic() - t0
        index.ops.add(adds=len(ids), add_s=add_s)
        _record_index_ops(metrics_name, adds=len(ids), add_s=add_s)
        return index

    # -- writes --------------------------------------------------------------

    def add(self, ids: list[str], vecs: np.ndarray, *, normalized: bool = False) -> int:
        """Route ``vecs`` to their nearest centroids (on the host) and append
        per-cluster fragments: no re-clustering."""
        if len(ids) == 0:
            return 0
        t0 = time.monotonic()
        normed = np.asarray(vecs, np.float32) if normalized else normalize_rows(vecs)
        if normed.shape[1] != self.meta["dim"]:
            raise ValueError(f"vector dim {normed.shape[1]} != index dim {self.meta['dim']}")
        assign = np.argmax(normed @ self.centroids.T, axis=1)
        for cid in np.unique(assign):
            members = np.flatnonzero(assign == cid)
            self.store.append_cluster(int(cid), [ids[m] for m in members], normed[members])
            self.cache.invalidate(0, int(cid))  # the shard grew; reload on demand
        self.meta["num_vectors"] = int(self.meta.get("num_vectors", 0)) + len(ids)
        self.store.save_meta(self.meta)
        add_s = time.monotonic() - t0
        self.ops.add(adds=len(ids), add_s=add_s)
        _record_index_ops(self.metrics_name, adds=len(ids), add_s=add_s)
        return len(ids)

    # -- queries -------------------------------------------------------------

    def _load_cluster(self, cid: int,
                      pinned: frozenset[tuple[int, int]] = frozenset()) -> tuple[list[str], np.ndarray]:
        """One cluster shard through the byte-budgeted LRU (generation 0,
        the live view); ``pinned`` keys (this batch's probe union) are
        never evicted."""
        return self.cache.get(0, cid, lambda: self.store.read_cluster(cid), pinned)

    def query(self, vecs: np.ndarray, *, top_k: int = DEFAULT_TOP_K, nprobe: int | None = None,
              normalized: bool = False) -> list[list[tuple[str, float]]]:
        """Batched ANN search: per query, the ``top_k`` most similar indexed
        vectors (id, cosine similarity), sorted descending, drawn from its
        top-``nprobe`` centroid clusters."""
        n = len(vecs)
        if n == 0:
            return []
        t0 = time.monotonic()
        q = np.asarray(vecs, np.float32) if normalized else normalize_rows(vecs)
        nprobe = nprobe or int(self.meta.get("nprobe_default", DEFAULT_NPROBE))
        by_cluster = route_queries(q, self.centroids, nprobe)
        pinned = frozenset((0, cid) for cid in by_cluster)
        loaded = []
        for cid in sorted(by_cluster):
            cids, mat = self._load_cluster(cid, pinned)
            if cids:
                loaded.append((cid, cids, mat))
        # per-query probes of non-empty shards (~ n * nprobe)
        probes = sum(len(by_cluster[cid]) for cid, _cids, _mat in loaded)
        results = score_shards(q, by_cluster, loaded, top_k, self._topk) if loaded else [[] for _ in range(n)]
        query_s = time.monotonic() - t0
        self.ops.add(queries=n, probes=probes, query_s=query_s)
        _record_index_ops(self.metrics_name, queries=n, probes=probes, query_s=query_s)
        return results

    def stats(self) -> dict:
        frags = self.store.cluster_fragment_counts()
        return {
            **self.meta,
            "index_path": self.store.root,
            "backend": self.store.backend,
            "clusters_with_data": len(frags),
            "fragments": int(sum(frags.values())),
            "pending_fragments": len(self.store.list_pending()),
            "ops": self.ops.snapshot(),
            "cache": self.cache.stats(),
        }


# -- dedup on top of the index ------------------------------------------------


def incremental_dedup(index: CorpusIndex, ids: list[str], vecs: np.ndarray, *, eps: float = 0.07,
                      nprobe: int | None = None, top_k: int = DEFAULT_TOP_K) -> dict:
    """SemDeDup-style pruning of a NEW batch against the indexed corpus,
    with ``semantic_dedup``'s greedy keep-first semantics: a batch item is a
    duplicate when an eligible neighbour lies within ``eps`` cosine
    distance; eligible means an indexed item, or an EARLIER batch item that
    was itself kept (an exact pass over the kept set catches batch-internal
    duplicates the index cannot see). Returns ``semantic_dedup``'s shape."""
    n = len(ids)
    if n == 0:
        return {"kept": [], "removed": [], "duplicate_of": {}}
    normed = normalize_rows(vecs)
    hits = index.query(normed, top_k=top_k, nprobe=nprobe, normalized=True)
    threshold = 1.0 - eps
    pos = {cid: i for i, cid in enumerate(ids)}
    kept: list[str] = []
    removed: list[str] = []
    duplicate_of: dict[str, str] = {}
    removed_set: set[str] = set()
    kept_rows: list[int] = []
    for i, qid in enumerate(ids):
        dup = None
        for hid, sim in hits[i]:
            if sim <= threshold:
                break  # hits sorted descending: nothing closer follows
            if hid == qid or hid in removed_set:
                continue
            if pos.get(hid, -1) > i:
                # a LATER batch item (the index may already hold this very
                # batch): keep-first says it defers to us
                continue
            dup = hid
            break
        if dup is None and kept_rows:
            sims = normed[kept_rows] @ normed[i]
            j = int(np.argmax(sims))
            if float(sims[j]) > threshold:
                dup = ids[kept_rows[j]]
        if dup is None:
            kept.append(qid)
            kept_rows.append(i)
        else:
            removed.append(qid)
            duplicate_of[qid] = dup
            removed_set.add(qid)
    index.ops.add(duplicates=len(removed))
    _record_index_ops(index.metrics_name, duplicates=len(removed))
    return {"kept": kept, "removed": removed, "duplicate_of": duplicate_of}


def consolidate_index(root: str, *, k: int | None = None, iters: int = 20,
                      device: str | torch.device = "cuda", metrics_name: str = "consolidate") -> dict:
    """End-of-run consolidation: fold the pending fragments
    ``ClipWriterStage`` appended into per-cluster shards, training
    centroids (k-means on ``device``) when the index does not exist yet,
    routing against the existing centroids otherwise. "random"-provenance
    rows are refused (counted) unless ``CURATE_INDEX_ALLOW_RANDOM`` opts
    in; rows of another embedding model than the index's are dropped."""
    device = model_device(device, "consolidate_index")
    store = IndexStore(root)
    ids, vecs, models, provs = store.read_pending()
    skipped = 0
    if ids and not allow_random_provenance():
        keep = [i for i, p in enumerate(provs) if p != "random"]
        skipped = len(ids) - len(keep)
        if skipped:
            logger.warning("index consolidation: refusing %d random-provenance vectors (set %s=1 to override)",
                           skipped, "CURATE_INDEX_ALLOW_RANDOM")
        ids = [ids[i] for i in keep]
        models = [models[i] for i in keep]
        vecs = vecs[keep] if len(keep) else np.zeros((0, 0), np.float32)
    result = {"consolidated": 0, "skipped_random": skipped, "pending_cleared": 0}
    if not ids:
        result["pending_cleared"] = store.clear_pending() if skipped else 0
        return result
    # one embedding space per index: an existing index pins the model,
    # otherwise the fragments elect it
    model = store.load_meta().get("model") or next((m for m in models if m), "")
    if model:
        keep = [i for i, m in enumerate(models) if m in (model, "")]
        if len(keep) != len(ids):
            logger.warning("index consolidation: dropping %d rows from other embedding models (index model: %s)",
                           len(ids) - len(keep), model)
        ids = [ids[i] for i in keep]
        vecs = vecs[keep]
    if store.exists():
        CorpusIndex.open(root, device=device, metrics_name=metrics_name).add(ids, vecs, normalized=True)
    else:
        CorpusIndex.build(root, ids, vecs, model=model, k=k, iters=iters, device=device, metrics_name=metrics_name)
    result["consolidated"] = len(ids)
    result["pending_cleared"] = store.clear_pending()
    return result


def _record_search_bytes(name: str, **deltas) -> None:
    try:
        record_search(name, **deltas)
    except Exception:  # metrics must never take down the read path
        logger.debug("search cache metrics recording failed", exc_info=True)


def _record_index_ops(name: str, **deltas) -> None:
    try:
        record_index_ops(name, **deltas)
    except Exception:  # metrics must never take down an index operation
        logger.debug("index metrics recording failed", exc_info=True)
