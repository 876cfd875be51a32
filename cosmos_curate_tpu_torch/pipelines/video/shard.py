"""Shard-dataset pipeline: curated clips -> bucketed webdataset tars (port
of ``cosmos_curate_tpu/pipelines/video/shard.py``).

Reads the split output (``clips/``, ``metas/v0/``, ``embeddings/``), keeps
the clips a dedup CSV marks ``kept`` (all of them without one), buckets
each clip by its dimensions, and writes ``<output>/<bucket>/shard-NNNNN.tar``
webdataset shards and ``<output>/index.json``. Host work only: no model
and no device.
"""

from __future__ import annotations

import json
import time
from collections import defaultdict
from dataclasses import dataclass

import numpy as np

from cosmos_curate_tpu_torch.dataset.dimensions import bucket_for
from cosmos_curate_tpu_torch.dataset.webdataset import ShardWriter, encode_sample_parts
from cosmos_curate_tpu_torch.storage.client import get_storage_client, read_bytes
from cosmos_curate_tpu_torch.storage.writers import write_json
from cosmos_curate_tpu_torch.utils.logging import get_logger
from cosmos_curate_tpu_torch.video.decode import extract_video_metadata

logger = get_logger(__name__)


@dataclass
class ShardPipelineArgs:
    input_path: str = ""  # split output root
    output_path: str = ""
    dedup_csv: str = ""  # optional dedup_summary csv; "" = keep all
    max_samples_per_shard: int = 512
    max_bytes_per_shard: int = 256 << 20
    include_embeddings: bool = True


def _kept_ids(dedup_csv: str) -> set[str] | None:
    if not dedup_csv:
        return None
    import csv as csv_mod
    import io

    text = read_bytes(dedup_csv).decode()
    return {
        row["clip_uuid"]
        for row in csv_mod.DictReader(io.StringIO(text))
        if row["action"] == "kept"
    }


def _load_embedding_index(input_path: str) -> dict[str, np.ndarray]:
    import io

    import pyarrow.parquet as pq

    client = get_storage_client(input_path)
    out: dict[str, np.ndarray] = {}
    for f in client.list_files(f"{input_path.rstrip('/')}/embeddings", suffixes=(".parquet",)):
        table = pq.read_table(io.BytesIO(read_bytes(f.path)))
        for cid, vec in zip(
            table.column("clip_uuid").to_pylist(), table.column("embedding").to_pylist()
        ):
            out[cid] = np.asarray(vec, np.float32)
    return out


def run_shard(args: ShardPipelineArgs) -> dict:
    t0 = time.monotonic()
    root = args.input_path.rstrip("/")
    out_root = args.output_path.rstrip("/")
    client = get_storage_client(root)
    kept = _kept_ids(args.dedup_csv)
    embeddings = _load_embedding_index(root) if args.include_embeddings else {}

    writers: dict[str, ShardWriter] = {}
    counts: dict[str, int] = defaultdict(int)
    skipped = 0
    for meta_info in client.list_files(f"{root}/metas/v0", suffixes=(".json",)):
        meta = json.loads(read_bytes(meta_info.path))
        cid = meta["uuid"]
        if kept is not None and cid not in kept:
            skipped += 1
            continue
        clip_path = f"{root}/clips/{cid}.mp4"
        if not client.exists(clip_path):
            continue
        mp4 = read_bytes(clip_path)
        vm = extract_video_metadata(mp4)
        bucket = bucket_for(vm.width, vm.height, vm.num_frames).key
        if bucket not in writers:
            writers[bucket] = ShardWriter(
                f"{out_root}/{bucket}",
                max_bytes_per_shard=args.max_bytes_per_shard,
                max_samples_per_shard=args.max_samples_per_shard,
            )
        # any produced caption variant counts ("default" preferred)
        captions = []
        for w in meta.get("windows", []):
            caps = w.get("captions") or {}
            text = caps.get("default") or next((v for v in caps.values() if v), "")
            if text:
                captions.append(text)
        arrays = {}
        if cid in embeddings:
            arrays["embedding"] = embeddings[cid]
        writers[bucket].add_sample(
            cid,
            encode_sample_parts(
                mp4=mp4,
                meta=meta,
                arrays=arrays,
                text="\n".join(c for c in captions if c) or None,
            ),
        )
        counts[bucket] += 1

    index = {}
    for bucket, writer in writers.items():
        index[bucket] = {"num_samples": counts[bucket], "shards": writer.close()}
    summary = {
        "num_samples": sum(counts.values()),
        "num_buckets": len(writers),
        "num_skipped_by_dedup": skipped,
        "elapsed_s": time.monotonic() - t0,
        "buckets": index,
    }
    write_json(f"{out_root}/index.json", summary)
    logger.info(
        "shard done: %d samples into %d buckets in %.1fs",
        summary["num_samples"], summary["num_buckets"], summary["elapsed_s"],
    )
    return summary
