"""Semantic dedup pipeline: the split's embedding parquets -> a pruned clip
set (port of ``cosmos_curate_tpu/pipelines/video/dedup.py``).

``run_dedup`` reads every embeddings parquet under the split output (one
embedding model), runs ``semantic_dedup`` (k-means on ``device``, "cuda"
unless the caller asks for the CPU) and writes
``<output>/dedup_summary_<eps>.csv`` (removed rows first, then kept) and
``<output>/summary.json``, with the reference's rows and keys.

Fast path: where a persistent corpus index exists (``<input>/index`` or
``index_path``, built by ``run_split(corpus_index=True)``), ``run_dedup``
queries it (``incremental_dedup``, scored on ``device``) instead of
reclustering: O(probed shards) against the whole curated corpus. An index of
another embedding model, or ``use_index=False``, reclusters. The parquet
fetches fold into stage_timer's object-plane aggregate as store reads, as
in the reference.
"""

from __future__ import annotations

import io
import os
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass

import numpy as np

from cosmos_curate_tpu_torch.core.model import model_device
from cosmos_curate_tpu_torch.dedup.corpus_index import CorpusIndex, incremental_dedup
from cosmos_curate_tpu_torch.dedup.kmeans import semantic_dedup
from cosmos_curate_tpu_torch.observability.stage_timer import record_object_plane
from cosmos_curate_tpu_torch.storage.client import get_storage_client, read_bytes
from cosmos_curate_tpu_torch.storage.writers import write_csv, write_json
from cosmos_curate_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

# bounded fan-out for per-chunk parquet fetches
FETCH_THREADS_ENV = "CURATE_WORKER_FETCH_THREADS"


@dataclass
class DedupPipelineArgs:
    """The reference's fields and defaults (a test pins them), plus
    ``device``."""

    input_path: str = ""  # split output root (with embeddings/<model>/)
    output_path: str = ""  # defaults to <input>/dedup
    embedding_model: str = ""  # "" = first found
    eps: float = 0.07
    n_clusters: int = 0  # 0 = sqrt(N)
    max_iters: int = 20
    # a mesh of one card is the single-device path: the flag changes nothing
    use_mesh: bool = True
    # corpus-index fast path: query instead of recluster where one exists
    use_index: bool = True
    index_path: str = ""  # "" = <input>/index
    nprobe: int = 0  # 0 = the index's default
    # where k-means and the index's products run: "cuda" unless the caller
    # asks for "cpu"
    device: str = "cuda"


def load_embeddings(input_path: str, model: str = "") -> tuple[list[str], np.ndarray, str]:
    """Every per-chunk embedding parquet under the split output, of one
    model (``model``, else the first found): (clip ids, ``[N, D]`` float32,
    model). Fetches and decodes fan out over a bounded thread pool
    (``CURATE_WORKER_FETCH_THREADS``, default 4); the order is the sorted
    file listing's either way."""
    # imported here, in the caller's thread, before the fetch pool: pyarrow
    # 25 imported first in a worker thread crashed a later read elsewhere
    import pyarrow.parquet as pq

    client = get_storage_client(input_path)
    root = f"{input_path.rstrip('/')}/embeddings"
    files = list(client.list_files(root, suffixes=(".parquet",)))
    if model:
        files = [f for f in files if f"/embeddings/{model}/" in f.path]
    if not files:
        raise FileNotFoundError(f"no embedding parquets under {root}")
    found_model = files[0].path.rsplit("/embeddings/", 1)[1].split("/", 1)[0]
    # one embedding space only: vectors of two models do not compare
    files = [f for f in files if f"/embeddings/{found_model}/" in f.path]

    def fetch(path: str) -> tuple[list[str], list[np.ndarray], int]:
        data = read_bytes(path)
        table = pq.read_table(io.BytesIO(data))
        return (
            table.column("clip_uuid").to_pylist(),
            [np.asarray(v, np.float32) for v in table.column("embedding").to_pylist()],
            len(data),
        )

    workers = max(1, int(os.environ.get(FETCH_THREADS_ENV, "4") or 4))
    t0 = time.monotonic()
    if len(files) == 1 or workers == 1:
        parts = [fetch(f.path) for f in files]
    else:
        with ThreadPoolExecutor(max_workers=min(workers, len(files)), thread_name_prefix="embed-fetch") as pool:
            parts = list(pool.map(fetch, (f.path for f in files)))
    elapsed = time.monotonic() - t0
    ids: list[str] = []
    vecs: list[np.ndarray] = []
    total_bytes = 0
    for chunk_ids, chunk_vecs, nbytes in parts:
        ids.extend(chunk_ids)
        vecs.extend(chunk_vecs)
        total_bytes += nbytes
    try:
        record_object_plane(store_reads=len(files), store_read_bytes=total_bytes, store_read_wait_s=elapsed)
    except Exception:  # metrics must never take down the load path
        logger.debug("object-plane recording failed", exc_info=True)
    logger.info(
        "loaded %d embeddings from %d parquets (%.1f MB) in %.2fs (%d fetch threads)",
        len(ids), len(files), total_bytes / 1e6, elapsed, min(workers, len(files)),
    )
    return ids, np.stack(vecs), found_model


def _open_index(args: DedupPipelineArgs, device, model: str) -> CorpusIndex | None:
    """The corpus index this run should query, or None (absent, disabled or
    of another embedding model: one embedding space per index, so a model
    mismatch reclusters instead of comparing incompatible vectors)."""
    if not args.use_index:
        return None
    root = (args.index_path or f"{args.input_path.rstrip('/')}/index").rstrip("/")
    try:
        if not CorpusIndex.exists(root):
            return None
        index = CorpusIndex.open(root, device=device, metrics_name="run_dedup")
    except Exception as e:  # an index that does not open reclusters, as in the reference
        logger.warning("corpus index at %s unusable (%s); re-clustering", root, e)
        return None
    index_model = index.meta.get("model", "")
    if index_model and model and index_model != model:
        logger.warning("corpus index at %s holds %r embeddings but this run used %r; re-clustering instead", root,
                       index_model, model)
        return None
    return index


def run_dedup(args: DedupPipelineArgs) -> dict:
    t0 = time.monotonic()
    device = model_device(args.device, "run_dedup's k-means")
    out = (args.output_path or f"{args.input_path.rstrip('/')}/dedup").rstrip("/")
    ids, embeddings, model = load_embeddings(args.input_path, args.embedding_model)
    logger.info("dedup: %d embeddings (%s, dim %d)", len(ids), model, embeddings.shape[1])
    index = _open_index(args, device, model)
    if index is not None:
        # the index may already hold this very run (the writer's fragments):
        # incremental_dedup's keep-first order handles self-matches
        method = "index_query"
        logger.info("dedup fast path: querying corpus index at %s (%d indexed vectors)", index.store.root,
                    index.meta.get("num_vectors", 0))
        result = incremental_dedup(index, ids, embeddings, eps=args.eps, nprobe=args.nprobe or None)
    else:
        method = "recluster"
        result = semantic_dedup(embeddings, ids, n_clusters=args.n_clusters or None, eps=args.eps,
                                iters=args.max_iters, device=device)
    rows = [
        {"clip_uuid": cid, "action": "removed", "duplicate_of": result["duplicate_of"].get(cid, "")}
        for cid in result["removed"]
    ] + [{"clip_uuid": cid, "action": "kept", "duplicate_of": ""} for cid in result["kept"]]
    write_csv(f"{out}/dedup_summary_{args.eps:g}.csv", rows, ["clip_uuid", "action", "duplicate_of"])
    summary = {
        "embedding_model": model,
        "eps": args.eps,
        "method": method,
        "index_path": index.store.root if index is not None else "",
        "num_embeddings": len(ids),
        "num_kept": len(result["kept"]),
        "num_removed": len(result["removed"]),
        "elapsed_s": time.monotonic() - t0,
    }
    write_json(f"{out}/summary.json", summary)
    logger.info("dedup done: kept %d / removed %d in %.1fs", summary["num_kept"], summary["num_removed"],
                summary["elapsed_s"])
    return summary
