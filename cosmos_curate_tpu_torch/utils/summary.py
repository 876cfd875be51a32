"""Run summary: the artifact a benchmark reads (port of
``cosmos_curate_tpu/utils/summary.py``).

The headline metric is ``video_hours_per_day_per_chip``: hours of source
video a chip (here one CUDA device) would process in a day at this run's
rate.

Not ported: ``merge_node_summaries``, which waits for multi-node runs
(ROADMAP queue A item 15).
"""

from __future__ import annotations

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
    return summary


def write_summary(path: str, summary: dict) -> None:
    write_json(path, summary)
