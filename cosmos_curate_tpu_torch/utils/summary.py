"""Run summary: the artifact a benchmark reads (port of
``cosmos_curate_tpu/utils/summary.py``).

The headline metric is ``video_hours_per_day_per_chip``: hours of source
video a chip (here one CUDA device) would process in a day at this run's
rate. ``merge_node_summaries`` folds a multi-node run's per-node summaries
(``summary.json`` of rank 0, ``summary-node<rank>.json`` of the others)
into ``summary-merged.json``.
"""

from __future__ import annotations

import glob
import json
import os
import time
from dataclasses import asdict
from typing import Sequence

from cosmos_curate_tpu_torch.data.model import ClipStats, SplitPipeTask
from cosmos_curate_tpu_torch.storage.writers import write_json


def build_summary(
    tasks: Sequence[SplitPipeTask],
    *,
    pipeline_run_time_s: float,
    num_chips: int = 1,
    extra: dict | None = None,
) -> dict:
    stats = ClipStats()
    total_video_duration_s = 0.0
    num_errors = 0
    videos: set[str] = set()
    provenance: dict[str, str] = {}
    for t in tasks:
        if t.stats is not None:
            stats.combine(t.stats)
        # per-model weights provenance stamped by the writer
        provenance.update(t.stage_perf.get("weights_provenance") or {})
        if t.video.path not in videos:
            videos.add(t.video.path)
            total_video_duration_s += t.video.metadata.duration_s
            # video-level errors are copied into every chunk; count them once
            num_errors += len(t.video.errors)
        num_errors += sum(len(c.errors) for c in (*t.video.clips, *t.video.filtered_clips))
    video_hours = total_video_duration_s / 3600.0
    run_days = pipeline_run_time_s / 86400.0 if pipeline_run_time_s > 0 else 0.0
    per_chip = (video_hours / run_days / num_chips) if run_days > 0 and num_chips else 0.0
    summary = {
        "timestamp": time.time(),
        "num_videos": len(videos),
        "total_video_duration_s": total_video_duration_s,
        "pipeline_run_time_s": pipeline_run_time_s,
        "num_chips": num_chips,
        "video_hours_per_day_per_chip": per_chip,
        "num_errors": num_errors,
        **asdict(stats),
    }
    if provenance:
        summary["weights_provenance"] = provenance
    if extra:
        summary.update(extra)
    return summary


def write_summary(path: str, summary: dict) -> None:
    write_json(path, summary)


# Counter fields summed across node summaries; the rest are recomputed or
# taken max-wise (run time = wall clock of the slowest node).
_ADDITIVE = (
    "num_videos",
    "total_video_duration_s",
    "num_errors",
    "num_clips",
    "num_filtered_by_motion",
    "num_filtered_by_aesthetic",
    "num_filtered_by_text",
    "num_filtered_by_semantic",
    "num_filtered_by_dedup",
    "num_transcoded",
    "num_with_embeddings",
    "num_with_captions",
    "num_with_webp",
    "total_clip_duration_s",
)


def merge_node_summaries(output_path: str) -> dict | None:
    """Combine ``summary.json`` (rank 0) + ``summary-node*.json`` into one
    merged ``summary.json`` (reference: the driver node aggregates partition
    results, client/slurm_cli/slurm.py:797). Safe to run repeatedly; returns
    the merged summary or None when no summaries exist yet."""
    root = output_path.rstrip("/")
    paths = sorted(
        p
        for p in glob.glob(os.path.join(root, "summary*.json"))
        if not p.endswith("summary-merged.json")
    )
    if not paths:
        return None
    summaries = []
    for p in paths:
        with open(p) as f:
            summaries.append(json.load(f))
    merged = dict(summaries[0])
    for s in summaries[1:]:
        for k in _ADDITIVE:
            if k in s:
                merged[k] = merged.get(k, 0) + s[k]
        if s.get("weights_provenance"):
            merged.setdefault("weights_provenance", {}).update(s["weights_provenance"])
        merged["pipeline_run_time_s"] = max(
            merged.get("pipeline_run_time_s", 0.0), s.get("pipeline_run_time_s", 0.0)
        )
        merged["max_clip_duration_s"] = max(
            merged.get("max_clip_duration_s", 0.0), s.get("max_clip_duration_s", 0.0)
        )
        merged["num_chips"] = merged.get("num_chips", 1) + s.get("num_chips", 1)
    video_hours = merged.get("total_video_duration_s", 0.0) / 3600.0
    run_days = merged.get("pipeline_run_time_s", 0.0) / 86400.0
    chips = max(1, merged.get("num_chips", 1))
    merged["video_hours_per_day_per_chip"] = (
        video_hours / run_days / chips if run_days > 0 else 0.0
    )
    merged["merged_from"] = [os.path.basename(p) for p in paths]
    write_json(os.path.join(root, "summary-merged.json"), merged)
    return merged
