"""Index-server read path: warm shard cache, snapshot-isolated queries,
micro-batched similarity search (port of
``cosmos_curate_tpu/dedup/index_server.py``).

- :class:`IndexSnapshot`: one published manifest generation
  (dedup/index_store.py), pinned: its fragment set, centroids and meta never
  change while it lives, so reads never contend with ingest or compaction.
  Refcounted: the last release of a superseded snapshot drains its shards
  from the cache (and, with ``gc_drained``, deletes its fragments).
- :class:`IndexServer`: concurrent ``search()`` calls queue; one worker
  thread drains them in micro-batches into one routing product and one
  ``DeviceTopK`` call on ``device`` ("cuda" unless the caller asks for the
  CPU), warms the largest clusters at boot, and adopts newer generations
  between batches. Clip-to-clip queries take an embedding or an indexed
  clip uuid; text-to-clip embeds the query through the port's
  ``CLIPTextEmbeddings`` on ``device`` (on the card, the flash kernel's
  causal branch). Text on seeded weights is refused (:class:`ProvenanceError`)
  unless ``CURATE_INDEX_ALLOW_RANDOM=1``.

The reference's latency histogram and gauges (``record_search``,
``engine.metrics``) wait for ROADMAP queue A item 14; the server keeps the
same counts (``stats()["counts"]``). ``pyarrow.parquet`` is imported in the
constructing thread before the worker starts: pyarrow imported first in a
worker thread has crashed a later read in the main thread.
"""

from __future__ import annotations

import os
import queue as queue_mod
import threading
import time

import numpy as np
import torch

from cosmos_curate_tpu_torch.dedup.corpus_index import (
    DEFAULT_NPROBE,
    DEFAULT_TOP_K,
    Counts,
    DeviceTopK,
    ShardCache,
    route_queries,
    score_shards,
    shard_nbytes,
)
from cosmos_curate_tpu_torch.dedup.index_store import IndexStore, allow_random_provenance, normalize_rows
from cosmos_curate_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

WARMUP_BYTES_ENV = "CURATE_INDEX_WARMUP_BYTES"


class ProvenanceError(RuntimeError):
    """A query path would run on random-init weights (refused: similarity
    against noise is not search). ``CURATE_INDEX_ALLOW_RANDOM=1`` opts in."""


def warmup_bytes_default(cache_budget: int) -> int:
    env = os.environ.get(WARMUP_BYTES_ENV, "")
    return max(0, int(env)) if env else cache_budget // 2


class IndexSnapshot:
    """One manifest generation, pinned. Refcounted: the server retains it
    per batch and drops the owner ref when it adopts a newer generation;
    the last release fires ``on_drain``."""

    def __init__(self, store: IndexStore, manifest: dict, *, topk: DeviceTopK, cache: ShardCache) -> None:
        self.store = store
        self.manifest = manifest
        self.generation = int(manifest.get("generation", 0))
        self.meta = dict(manifest.get("meta") or store.load_meta())
        self.centroids = np.asarray(store.load_centroids(manifest.get("centroids") or None), np.float32)
        self.clusters: dict[int, dict] = {int(cid): info for cid, info in (manifest.get("clusters") or {}).items()}
        self._topk = topk
        self.cache = cache
        self._lock = threading.Lock()
        self._refs = 1  # the owner's ref
        self.on_drain = None
        # clip uuid -> cluster id, from every shard loaded; resolve_uuid scans
        # not-yet-seen clusters (largest first) on a miss
        self._uuid_to_cid: dict[str, int] = {}
        self._unscanned: list[int] = sorted(self.clusters, key=lambda c: -int(self.clusters[c].get("bytes", 0)))

    # -- lifecycle -----------------------------------------------------------

    def retain(self) -> "IndexSnapshot":
        with self._lock:
            self._refs += 1
        return self

    def release(self) -> None:
        with self._lock:
            self._refs -= 1
            drained = self._refs <= 0
        if drained:
            self.cache.drop_generation(self.generation)
            cb, self.on_drain = self.on_drain, None
            if cb is not None:
                try:
                    cb(self)
                except Exception:  # GC must never take down the read path
                    logger.exception("snapshot drain callback failed")

    # -- reads ---------------------------------------------------------------

    def _load_cluster(self, cid: int, pinned: frozenset[tuple[int, int]]) -> tuple[list[str], np.ndarray]:
        info = self.clusters.get(cid)
        if info is None:
            return [], np.zeros((0, 0), np.float32)
        ids, mat = self.cache.get(self.generation, cid,
                                  lambda: self.store.read_fragments(list(info.get("fragments") or [])), pinned)
        with self._lock:
            for u in ids:
                self._uuid_to_cid.setdefault(u, cid)
            if cid in self._unscanned:
                self._unscanned.remove(cid)  # even when empty: resolve_uuid must end
        return ids, mat

    def query(self, vecs: np.ndarray, *, top_k: int = DEFAULT_TOP_K, nprobe: int | None = None,
              normalized: bool = False) -> list[list[tuple[str, float]]]:
        """Batched ANN search against this generation only (the semantics
        and device path of ``CorpusIndex.query``)."""
        n = len(vecs)
        if n == 0:
            return []
        q = np.asarray(vecs, np.float32) if normalized else normalize_rows(vecs)
        nprobe = nprobe or int(self.meta.get("nprobe_default", DEFAULT_NPROBE))
        by_cluster = route_queries(q, self.centroids, nprobe)
        pinned = frozenset((self.generation, cid) for cid in by_cluster)
        loaded = []
        for cid in sorted(by_cluster):
            cids, mat = self._load_cluster(cid, pinned)
            if cids:
                loaded.append((cid, cids, mat))
        if not loaded:
            return [[] for _ in range(n)]
        return score_shards(q, by_cluster, loaded, top_k, self._topk)

    def resolve_uuid(self, clip_uuid: str) -> np.ndarray | None:
        """The indexed embedding of ``clip_uuid``, or None: the uuid map
        first, then not-yet-loaded clusters, largest first, through the
        cache (resolution doubles as warmup)."""
        pinned: frozenset[tuple[int, int]] = frozenset()
        while True:
            with self._lock:
                cid = self._uuid_to_cid.get(clip_uuid)
                nxt = self._unscanned[0] if self._unscanned else None
            if cid is not None:
                ids, mat = self._load_cluster(cid, pinned)
                try:
                    return mat[ids.index(clip_uuid)]
                except ValueError:
                    return None  # the map raced a drop: absent
            if nxt is None:
                return None
            self._load_cluster(nxt, pinned)

    def warm(self, budget_bytes: int) -> int:
        """Boot warmup: load the largest clusters until ``budget_bytes`` of
        shards are resident. Returns the bytes warmed."""
        warmed = 0
        for cid in sorted(self.clusters, key=lambda c: -int(self.clusters[c].get("bytes", 0))):
            if warmed >= budget_bytes:
                break
            ids, mat = self._load_cluster(cid, frozenset())
            warmed += shard_nbytes(ids, mat)
        return warmed

    def num_vectors(self) -> int:
        return int(self.meta.get("num_vectors", 0))


class _SearchRequest:
    __slots__ = ("mode", "payload", "top_k", "nprobe", "event", "results", "generation", "error", "t0")

    def __init__(self, mode: str, payload, top_k: int, nprobe: int | None) -> None:
        self.mode = mode  # "clip" | "uuid" | "text"
        self.payload = payload  # [n, D] vecs | uuid str | text str
        self.top_k = top_k
        self.nprobe = nprobe
        self.event = threading.Event()
        self.results = None
        self.generation = -1
        self.error: BaseException | None = None
        self.t0 = time.monotonic()


class IndexServer:
    """The serving read path over one index root.

    Concurrent ``search()`` calls enqueue; one worker thread drains the
    queue in micro-batches (``batch_window_s`` linger, ``max_batch`` cap),
    resolves uuid and text payloads to embeddings, and answers every request
    of a batch from ONE retained snapshot, so a batch is
    generation-consistent and adoption happens strictly between batches."""

    def __init__(
        self,
        root: str,
        *,
        device: str | torch.device = "cuda",
        cache_bytes: int | None = None,
        warmup: bool = True,
        warmup_budget: int | None = None,
        text_model: str = "clip-text-b-tpu",
        batch_window_s: float = 0.002,
        max_batch: int = 64,
        adopt_interval_s: float = 1.0,
        gc_drained: bool = False,
    ) -> None:
        import pyarrow.parquet  # noqa: F401  (in this thread, before the worker reads)

        self.store = IndexStore(root)
        if not self.store.exists():
            raise FileNotFoundError(f"no corpus index at {root} (run `index build` first)")
        self.text_model = text_model
        self.batch_window_s = batch_window_s
        self.max_batch = max_batch
        self.adopt_interval_s = adopt_interval_s
        self.gc_drained = gc_drained
        self._topk = DeviceTopK(device)
        self.device = self._topk.device
        self.cache = ShardCache(cache_bytes)
        self.counts = Counts("searches", "queries", "batches", "batched_requests", "search_s",
                             "generations_adopted")
        self._snapshot = self._open_snapshot(self.store.current_generation())
        self._snap_lock = threading.Lock()
        self._last_adopt_check = time.monotonic()
        self._text_tower = None
        self._text_lock = threading.Lock()
        self._queue: queue_mod.Queue[_SearchRequest | None] = queue_mod.Queue()
        # guards the closed-check + enqueue pair: once close() sets the flag
        # and enqueues the sentinel, no request lands behind the sentinel
        self._submit_lock = threading.Lock()
        self._closed = False
        self.warmed_bytes = 0
        if warmup:
            budget = warmup_budget if warmup_budget is not None else warmup_bytes_default(self.cache.budget)
            t0 = time.monotonic()
            self.warmed_bytes = self._snapshot.warm(budget)
            logger.info("index server warmup: %.1f MB of shards resident in %.2fs (generation %d, %d vectors)",
                        self.warmed_bytes / 2**20, time.monotonic() - t0, self._snapshot.generation,
                        self._snapshot.num_vectors())
        self._worker = threading.Thread(target=self._serve_loop, name="index-server", daemon=True)
        self._worker.start()

    # -- snapshot lifecycle --------------------------------------------------

    def _open_snapshot(self, generation: int) -> IndexSnapshot:
        return IndexSnapshot(self.store, self.store.read_manifest(generation), topk=self._topk, cache=self.cache)

    @property
    def generation(self) -> int:
        return self._snapshot.generation

    def maybe_adopt(self) -> bool:
        """Adopt the latest published generation (between batches). The old
        snapshot's owner ref drops; its shards drain when the last
        in-flight reader releases it."""
        try:
            latest = self.store.current_generation()
        except RuntimeError as e:
            logger.warning("manifest pointer unreadable; keeping generation %d (%s)", self._snapshot.generation, e)
            return False
        if latest <= self._snapshot.generation:
            return False
        new = self._open_snapshot(latest)
        with self._snap_lock:
            old, self._snapshot = self._snapshot, new
        if self.gc_drained:
            old.on_drain = self._gc_snapshot
        old.release()  # the owner ref; in-flight batches still hold theirs
        self.counts.add(generations_adopted=1)
        logger.info("index server adopted generation %d (was %d)", latest, old.generation)
        return True

    def _gc_snapshot(self, old: IndexSnapshot) -> None:
        """Drain-time GC: delete the fragments only the superseded manifest
        referenced."""
        from cosmos_curate_tpu_torch.dedup.compaction import gc_superseded

        gc_superseded(self.store, old.manifest, self._snapshot.manifest)

    def _current_snapshot(self) -> IndexSnapshot:
        with self._snap_lock:
            return self._snapshot.retain()

    # -- public API ----------------------------------------------------------

    def search(self, vecs: np.ndarray | None = None, *, clip_uuid: str | None = None, text: str | None = None,
               top_k: int = DEFAULT_TOP_K, nprobe: int | None = None) -> tuple[list[list[tuple[str, float]]], int]:
        """Blocking search; exactly one of ``vecs`` (``[n, D]`` or ``[D]``),
        ``clip_uuid``, ``text``. Returns (per-query hit lists, the generation
        that answered). Thread-safe: concurrent callers micro-batch."""
        if sum(x is not None for x in (vecs, clip_uuid, text)) != 1:
            raise ValueError("exactly one of vecs/clip_uuid/text")
        if vecs is not None:
            q = np.asarray(vecs, np.float32)
            if q.ndim == 1:
                q = q[None]
            if q.ndim != 2 or q.shape[1] != int(self._snapshot.meta.get("dim", q.shape[1])):
                raise ValueError(f"query dim {q.shape[-1]} != index dim {self._snapshot.meta.get('dim')}")
            req = _SearchRequest("clip", normalize_rows(q), top_k, nprobe)
        elif clip_uuid is not None:
            req = _SearchRequest("uuid", str(clip_uuid), top_k, nprobe)
        else:
            req = _SearchRequest("text", str(text), top_k, nprobe)
        with self._submit_lock:
            if self._closed:
                raise RuntimeError("index server is closed")
            self._queue.put(req)
        req.event.wait()
        if req.error is not None:
            raise req.error
        self.counts.add(searches=1, queries=len(req.results))
        return req.results, req.generation

    def stats(self) -> dict:
        snap = self._snapshot
        return {"generation": snap.generation, "num_vectors": snap.num_vectors(), "clusters": len(snap.clusters),
                "warmed_bytes": self.warmed_bytes, "cache": self.cache.stats(), "text_model": self.text_model,
                "counts": self.counts.snapshot()}

    def close(self) -> None:
        with self._submit_lock:
            if self._closed:
                return
            self._closed = True
            self._queue.put(None)  # the sentinel is the LAST queue entry
        self._worker.join(timeout=10.0)
        self._fail_pending()  # the worker died or hung: nobody may wait forever
        with self._snap_lock:
            self._snapshot.release()

    def _fail_pending(self) -> None:
        """Fail every queued request (shutdown drain)."""
        while True:
            try:
                req = self._queue.get_nowait()
            except queue_mod.Empty:
                return
            if req is None:
                continue
            req.error = RuntimeError("index server is closed")
            req.event.set()

    # -- text tower ----------------------------------------------------------

    def _text_embeddings(self, texts: list[str]) -> np.ndarray:
        with self._text_lock:
            tower = self._text_tower
            if tower is None:
                from cosmos_curate_tpu_torch.models import registry
                from cosmos_curate_tpu_torch.models.clip_text import CLIPTextEmbeddings

                if registry.weights_provenance(self.text_model) == "random" and not allow_random_provenance():
                    raise ProvenanceError(
                        f"text tower {self.text_model!r} has no staged weights: text-to-clip search on random "
                        "projections is refused (set CURATE_INDEX_ALLOW_RANDOM=1 for architecture-only runs)")
                tower = CLIPTextEmbeddings(self.text_model, device=self.device)
                tower.setup()
                dim = int(self._snapshot.meta.get("dim", tower.embedding_dim))
                if tower.embedding_dim != dim:
                    raise ValueError(f"text tower dim {tower.embedding_dim} != index dim {dim} (text-to-clip "
                                     "needs the paired tower of the index's embedding space)")
                self._text_tower = tower
            return tower.encode_texts(texts)

    # -- the serving loop ----------------------------------------------------

    def _serve_loop(self) -> None:
        while True:
            req = self._queue.get()
            if req is None:
                self._fail_pending()
                return
            batch = [req]
            deadline = time.monotonic() + self.batch_window_s
            while len(batch) < self.max_batch:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                try:
                    nxt = self._queue.get(timeout=remaining)
                except queue_mod.Empty:
                    break
                if nxt is None:
                    self._queue.put(None)  # re-arm shutdown for after this batch
                    break
                batch.append(nxt)
            # adoption strictly BETWEEN batches
            if time.monotonic() - self._last_adopt_check >= self.adopt_interval_s:
                self._last_adopt_check = time.monotonic()
                try:
                    self.maybe_adopt()
                except Exception:
                    logger.exception("snapshot adoption failed; serving the old generation")
            snap = self._current_snapshot()
            t0 = time.monotonic()
            try:
                self._serve_batch(snap, batch)
            finally:
                snap.release()
            self.counts.add(batches=1, batched_requests=len(batch), search_s=time.monotonic() - t0)

    def _serve_batch(self, snap: IndexSnapshot, batch: list[_SearchRequest]) -> None:
        rows: list[np.ndarray] = []
        spans: list[tuple[_SearchRequest, int, int]] = []
        texts = [r for r in batch if r.mode == "text"]
        text_vecs: dict[int, np.ndarray] = {}
        if texts:
            try:
                embedded = self._text_embeddings([r.payload for r in texts])
                for i, r in enumerate(texts):
                    text_vecs[id(r)] = embedded[i][None]
            except Exception as e:  # fail the text requests only
                for r in texts:
                    r.error, r.generation = e, snap.generation
                    r.event.set()
                batch = [r for r in batch if r.mode != "text"]
        for req in batch:
            try:
                if req.mode == "clip":
                    q = req.payload
                elif req.mode == "uuid":
                    vec = snap.resolve_uuid(req.payload)
                    if vec is None:
                        raise KeyError(f"clip_uuid {req.payload!r} is not indexed")
                    q = vec[None]
                else:
                    q = normalize_rows(text_vecs[id(req)])
            except Exception as e:
                req.error, req.generation = e, snap.generation
                req.event.set()
                continue
            spans.append((req, len(rows), len(rows) + len(q)))
            rows.extend(q)
        if not spans:
            return
        # one snapshot.query per distinct (top_k, nprobe)
        groups: dict[tuple[int, int | None], list[tuple[_SearchRequest, int, int]]] = {}
        for item in spans:
            groups.setdefault((item[0].top_k, item[0].nprobe), []).append(item)
        all_rows = np.asarray(rows, np.float32)
        for (top_k, nprobe), items in groups.items():
            idx = np.concatenate([np.arange(a, b) for _r, a, b in items])
            try:
                results = snap.query(all_rows[idx], top_k=top_k, nprobe=nprobe, normalized=True)
            except Exception as e:
                for r, _a, _b in items:
                    r.error, r.generation = e, snap.generation
                    r.event.set()
                continue
            pos = 0
            for r, a, b in items:
                r.results = results[pos:pos + b - a]
                r.generation = snap.generation
                pos += b - a
                r.event.set()
