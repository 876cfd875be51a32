"""Background index compaction: fold pending fragments, rebalance skewed
clusters, refresh stale centroids, publish a new manifest generation (port
of ``cosmos_curate_tpu/dedup/compaction.py``).

1. **Fold pending** without duplicates: the pending set is snapshotted at
   entry; rows are provenance- and model-gated as in ``consolidate_index``,
   deduplicated against the indexed ids and within the fold, routed to the
   current centroids (on the host) and appended to their clusters.
2. **Rebalance skew**: a cluster holding more than ``rebalance_factor`` x
   the mean row count splits in two by ``kmeans_fit(members, 2,
   seed=cid)`` on ``device`` ("cuda" unless the caller asks for the CPU).
3. **Refresh centroids**: each cluster's normalised member mean; the
   manifest pins the refreshed set as ``centroids-<gen>.npy`` (the live
   ``centroids.npy`` and ``meta.json`` follow, for batch readers and
   ``add``'s routing).
4. **Publish atomically**: ``manifests/gen-<N>.json`` with the exact
   post-compaction fragment set, then the ``MANIFEST.json`` pointer. Nothing
   is published unless something changed (a fold, a split, or centroid
   drift above ``drift_tol``).

Superseded fragments are not deleted at publish (in-flight snapshot readers
still hold them): :func:`gc_superseded` (the server's drain callback) or
:func:`gc_index` (a full sweep with no readers) reclaim them. One compactor
per index root at a time. The reference's compaction metrics wait for ROADMAP
queue A item 14; the report holds the same counts.
"""

from __future__ import annotations

import threading
import time

import numpy as np
import torch

from cosmos_curate_tpu_torch.core.model import model_device
from cosmos_curate_tpu_torch.dedup.index_store import IndexStore, allow_random_provenance, normalize_rows
from cosmos_curate_tpu_torch.dedup.kmeans import kmeans_fit
from cosmos_curate_tpu_torch.ops._build import DEVICE_FAULTS
from cosmos_curate_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

DEFAULT_REBALANCE_FACTOR = 4.0
DEFAULT_MIN_SPLIT_ROWS = 16
DEFAULT_DRIFT_TOL = 1e-3


def _append(clusters: dict, cid: int, ids: list[str], vecs: np.ndarray) -> None:
    old_ids, old_vecs = clusters.get(cid, ([], None))
    clusters[cid] = (list(old_ids) + ids, np.concatenate([old_vecs, vecs]) if len(old_ids) else vecs)


def compact_index(
    root: str,
    *,
    device: str | torch.device = "cuda",
    fold_pending: bool = True,
    rebalance: bool = True,
    rebalance_factor: float = DEFAULT_REBALANCE_FACTOR,
    min_split_rows: int = DEFAULT_MIN_SPLIT_ROWS,
    refresh_centroids: bool = True,
    drift_tol: float = DEFAULT_DRIFT_TOL,
    force: bool = False,
    gc: bool = False,
) -> dict:
    """One compaction pass over the index at ``root``. Returns a report;
    ``report["published"]`` is False when nothing needed doing."""
    t0 = time.monotonic()
    device = model_device(device, "compact_index's rebalance")
    store = IndexStore(root)
    if not store.exists():
        raise FileNotFoundError(f"no corpus index at {root} (run `index build` first)")
    base_gen = store.current_generation()
    base_manifest = store.read_manifest(base_gen)
    base_clusters = base_manifest.get("clusters") or {}
    centroids = np.asarray(store.load_centroids(base_manifest.get("centroids") or None), np.float32)
    meta = dict(base_manifest.get("meta") or store.load_meta())
    report = {
        "index_path": store.root,
        "base_generation": base_gen,
        "published": False,
        "generation": base_gen,
        "folded": 0,
        "absorbed": 0,  # live post-publish `add` fragments pulled into the manifest
        "skipped_random": 0,
        "model_dropped": 0,
        "duplicates_dropped": 0,
        "clusters_split": 0,
        "rows_moved": 0,
        "centroid_drift": 0.0,
        "pending_cleared": 0,
        "gc_deleted": 0,
    }

    # the pinned cluster contents: compaction is the one pass that reads the
    # whole index
    clusters: dict[int, tuple[list[str], np.ndarray]] = {}
    for cid_s, info in base_clusters.items():
        ids, vecs = store.read_fragments(list(info.get("fragments") or []))
        if ids:
            clusters[int(cid_s)] = (ids, vecs)
    indexed_ids = {u for ids, _v in clusters.values() for u in ids}
    changed: set[int] = set()  # clusters whose fragment set is rewritten

    # Absorb live fragments the base manifest does not pin: rows ``add``
    # appended after the base generation was published would otherwise
    # never enter a manifest (and a later GC would delete them). Superseded
    # leftovers surface here too and dedup away against indexed_ids.
    if base_gen > 0:
        pinned_frags = {f for info in base_clusters.values() for f in (info.get("fragments") or [])}
        for cid in sorted(store.cluster_fragment_counts()):
            extras = [rel for rel, _sz in store.fragment_info(f"clusters/{store.cluster_dir(cid)}")
                      if rel not in pinned_frags]
            if not extras:
                continue
            e_ids, e_vecs = store.read_fragments(extras)
            novel = []
            for i, u in enumerate(e_ids):
                if u not in indexed_ids:
                    novel.append(i)
                    indexed_ids.add(u)
            if not novel:
                continue
            _append(clusters, cid, [e_ids[i] for i in novel], e_vecs[novel])
            changed.add(cid)
            report["absorbed"] += len(novel)

    # -- 1. fold pending (duplicate-free) ------------------------------------
    pending_rel = [store._relpath(p) for p in store.list_pending()] if fold_pending else []
    if pending_rel:
        p_ids, p_vecs, p_models, p_provs = store.read_pending()
        keep = list(range(len(p_ids)))
        if not allow_random_provenance():
            report["skipped_random"] = sum(p_provs[i] == "random" for i in keep)
            keep = [i for i in keep if p_provs[i] != "random"]
        model = meta.get("model") or next((m for m in p_models if m), "")
        if model:
            dropped = [i for i in keep if p_models[i] not in (model, "")]
            if dropped:
                logger.warning("compaction: dropping %d pending rows from other embedding models (index model: %s)",
                               len(dropped), model)
                report["model_dropped"] = len(dropped)
            keep = [i for i in keep if p_models[i] in (model, "")]
        seen_fold: set[str] = set()
        fold_rows: list[int] = []
        for i in keep:
            if p_ids[i] in indexed_ids or p_ids[i] in seen_fold:
                report["duplicates_dropped"] += 1
                continue
            seen_fold.add(p_ids[i])
            fold_rows.append(i)
        if fold_rows:
            f_ids = [p_ids[i] for i in fold_rows]
            f_vecs = normalize_rows(p_vecs[fold_rows])
            assign = np.argmax(f_vecs @ centroids.T, axis=1)
            for cid in np.unique(assign):
                members = np.flatnonzero(assign == cid)
                _append(clusters, int(cid), [f_ids[m] for m in members], f_vecs[members])
                changed.add(int(cid))
            indexed_ids.update(f_ids)
            report["folded"] = len(fold_rows)

    # -- 2. rebalance skewed clusters ----------------------------------------
    new_centroids: dict[int, np.ndarray] = {}
    if rebalance and clusters:
        mean_rows = sum(len(ids) for ids, _v in clusters.values()) / len(clusters)
        next_cid = max(max(clusters), centroids.shape[0] - 1) + 1
        for cid in sorted(clusters):
            ids, vecs = clusters[cid]
            if len(ids) < max(min_split_rows, int(rebalance_factor * mean_rows)):
                continue
            subc, sub_assign = kmeans_fit(vecs, 2, iters=10, seed=cid, device=device)
            a = np.flatnonzero(sub_assign == 0)
            b = np.flatnonzero(sub_assign == 1)
            if len(a) == 0 or len(b) == 0:
                continue  # degenerate split: all rows are one point
            clusters[cid] = ([ids[m] for m in a], vecs[a])
            clusters[next_cid] = ([ids[m] for m in b], vecs[b])
            new_centroids[cid] = subc[0]
            new_centroids[next_cid] = subc[1]
            changed.update((cid, next_cid))
            report["clusters_split"] += 1
            report["rows_moved"] += len(b)
            logger.info("compaction: split cluster %d (%d rows) -> %d + %d", cid, len(ids), len(a), len(b))
            next_cid += 1

    # -- 3. refresh centroids ------------------------------------------------
    k_new = max(max(clusters) + 1 if clusters else 1, centroids.shape[0])
    refreshed = np.zeros((k_new, centroids.shape[1]), np.float32)
    refreshed[: centroids.shape[0]] = centroids
    drift = 0.0
    for cid, (ids, vecs) in clusters.items():
        if cid in new_centroids:
            refreshed[cid] = new_centroids[cid]
            continue
        if refresh_centroids and len(ids):
            fresh = normalize_rows(vecs.mean(axis=0, keepdims=True))[0]
            if cid < centroids.shape[0]:
                drift = max(drift, float(1.0 - fresh @ centroids[cid]))
            refreshed[cid] = fresh
    report["centroid_drift"] = round(drift, 6)

    if not (force or report["folded"] or report["absorbed"] or report["clusters_split"]
            or (refresh_centroids and drift > drift_tol)):
        # nothing changed: no new generation. Pending fragments whose rows
        # were all consumed anyway (duplicates, refused rows) still clear,
        # or every later pass would re-read them.
        consumed = report["duplicates_dropped"] + report["skipped_random"] + report["model_dropped"]
        if pending_rel and consumed > 0:
            report["pending_cleared"] = store.delete_fragments(pending_rel)
        return report

    # -- 4. write fragments + publish the generation -------------------------
    gen = max([base_gen] + store.list_manifests()) + 1
    manifest_clusters: dict[str, dict] = {}
    for cid in sorted(clusters):
        ids, vecs = clusters[cid]
        if not ids:
            continue
        if cid in changed or str(cid) not in base_clusters:
            # one fragment per touched cluster: many appends fold into one read
            frags = [store._relpath(store.append_cluster(cid, ids, vecs))]
            nbytes = sum(sz for rel, sz in store.fragment_info(f"clusters/{store.cluster_dir(cid)}") if rel in frags)
        else:
            info = base_clusters[str(cid)]
            frags = list(info.get("fragments") or [])
            nbytes = int(info.get("bytes", 0))
        manifest_clusters[str(cid)] = {"fragments": frags, "rows": len(ids), "bytes": nbytes}
    cent_rel = store.save_centroids(refreshed, generation=gen)
    store.save_centroids(refreshed)  # the live copy: batch readers + add routing
    num_vectors = sum(int(c["rows"]) for c in manifest_clusters.values())
    meta.update({"k": int(refreshed.shape[0]), "num_vectors": num_vectors})
    store.save_meta(meta)
    meta = store.load_meta()  # re-read: save_meta stamps the backend
    new_frag_set = {f for c in manifest_clusters.values() for f in c["fragments"]}
    superseded = sorted({f for c in base_clusters.values() for f in (c.get("fragments") or [])
                         if f not in new_frag_set})
    store.publish_manifest({
        "generation": gen,
        "centroids": cent_rel,
        "meta": meta,
        "clusters": manifest_clusters,
        "superseded": superseded,
        "base_generation": base_gen,
    })
    report["published"] = True
    report["generation"] = gen
    # clear ONLY the pending fragments this pass read: the writer's newer
    # ones wait for the next pass
    if pending_rel:
        report["pending_cleared"] = store.delete_fragments(pending_rel)
    if gc:
        report["gc_deleted"] = gc_index(store)
    logger.info("compaction published generation %d: folded %d, split %d cluster(s), drift %.4f, %d vectors (%.2fs)",
                gen, report["folded"], report["clusters_split"], drift, num_vectors, time.monotonic() - t0)
    return report


# ---------------------------------------------------------------------------
# garbage collection


def gc_superseded(store: IndexStore, old_manifest: dict, current_manifest: dict) -> int:
    """Drain-time GC: delete the fragments the superseded manifest
    referenced that the current one does not, and its manifest file."""
    keep = {f for c in (current_manifest.get("clusters") or {}).values() for f in (c.get("fragments") or [])}
    victims = [f for c in (old_manifest.get("clusters") or {}).values() for f in (c.get("fragments") or [])
               if f not in keep]
    n = store.delete_fragments(victims)
    old_gen = int(old_manifest.get("generation", 0))
    if old_gen > 0:
        store.delete_manifest(old_gen)
    if n:
        logger.info("gc: reclaimed %d fragment(s) of generation %d", n, old_gen)
    return n


def gc_index(store: IndexStore) -> int:
    """Full sweep (safe only with no snapshot readers): delete every cluster
    fragment the current manifest does not reference, and older manifests."""
    current_gen = store.current_generation()
    if current_gen <= 0:
        return 0  # the live view: everything on disk is the index
    manifest = store.read_manifest(current_gen)
    keep = {f for c in (manifest.get("clusters") or {}).values() for f in (c.get("fragments") or [])}
    victims = [rel for cid in store.cluster_fragment_counts()
               for rel, _sz in store.fragment_info(f"clusters/{store.cluster_dir(cid)}") if rel not in keep]
    n = store.delete_fragments(victims)
    for gen in store.list_manifests():
        if gen < current_gen:
            store.delete_manifest(gen)
    return n


# ---------------------------------------------------------------------------
# background thread


class CompactionThread(threading.Thread):
    """In-service compactor: one pass every ``interval_s``, publishing only
    when something changed. The paired ``IndexServer`` adopts new
    generations between batches; its drain callback (``gc_drained=True``)
    reclaims superseded fragments. A failed pass is logged and the index
    left unchanged, except a device fault, which ends the thread."""

    def __init__(self, root: str, *, interval_s: float = 30.0, device: str | torch.device = "cuda",
                 **compact_kw) -> None:
        import pyarrow.parquet  # noqa: F401  (in this thread, before the compactor reads)

        super().__init__(name="index-compactor", daemon=True)
        self.root = root
        self.interval_s = interval_s
        self.device = model_device(device, "CompactionThread")
        self.compact_kw = compact_kw
        self._stop_event = threading.Event()
        self.passes = 0
        self.last_report: dict | None = None

    def run(self) -> None:
        while not self._stop_event.wait(self.interval_s):
            self.run_once()

    def run_once(self) -> dict | None:
        try:
            self.last_report = compact_index(self.root, device=self.device, **self.compact_kw)
        except DEVICE_FAULTS:
            raise
        except Exception:
            logger.exception("compaction pass failed; index unchanged")
            return None
        self.passes += 1
        return self.last_report

    def stop(self, timeout: float = 30.0) -> None:
        self._stop_event.set()
        self.join(timeout=timeout)
