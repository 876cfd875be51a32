"""Input discovery with resume (port of
``cosmos_curate_tpu/pipelines/video/input_discovery.py``).

Lists candidate videos under the input prefix, skips any whose
``processed_videos/`` records are complete (all chunks present), and builds
a ``SplitPipeTask`` for each of the rest: one a video, or, for multicam
input, one a session directory of time-aligned cameras
(``discover_multicam_tasks``).
"""

from __future__ import annotations

import json
from collections import defaultdict
from pathlib import PurePath

from cosmos_curate_tpu_torch.data.model import SplitPipeTask, Video
from cosmos_curate_tpu_torch.pipelines.video.stages.writer import video_record_id
from cosmos_curate_tpu_torch.storage.client import get_storage_client, relative_to_prefix
from cosmos_curate_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

VIDEO_SUFFIXES = (".mp4", ".mov", ".avi", ".mkv", ".webm", ".m4v")


def _processed_video_ids(output_path: str) -> set[str]:
    """Video ids whose chunk records are complete."""
    client = get_storage_client(output_path)
    prefix = f"{output_path.rstrip('/')}/processed_videos"
    chunks: dict[str, list[str]] = {}
    for info in client.list_files(prefix, suffixes=(".json",)):
        parts = info.path.replace("\\", "/").split("/")
        if len(parts) < 2:
            continue
        chunks.setdefault(parts[-2], []).append(info.path)
    done: set[str] = set()
    for vid, files in chunks.items():
        try:
            rec = json.loads(client.read_bytes(files[0]))
            if len(files) >= int(rec.get("num_chunks", 1)):
                done.add(vid)
        except (OSError, ValueError, TypeError, AttributeError):
            logger.warning("unreadable resume record under %s; will reprocess", vid)
    return done


def discover_split_tasks(input_path: str, output_path: str | None = None, *, limit: int = 0) -> list[SplitPipeTask]:
    """List videos under ``input_path``; skip completed ones when
    ``output_path`` holds resume records; cap at ``limit`` when > 0."""
    client = get_storage_client(input_path)
    done = _processed_video_ids(output_path) if output_path else set()
    tasks: list[SplitPipeTask] = []
    skipped = 0
    for info in client.list_files(input_path, suffixes=VIDEO_SUFFIXES):
        if video_record_id(info.path) in done:
            skipped += 1
            continue
        tasks.append(SplitPipeTask(video=Video(path=info.path)))
        if limit and len(tasks) >= limit:
            break
    logger.info("discovered %d videos under %s (%d already processed, skipped)", len(tasks), input_path, skipped)
    return tasks


def discover_multicam_tasks(
    input_path: str,
    output_path: str | None = None,
    *,
    primary_camera: str = "",
    limit: int = 0,
) -> list[SplitPipeTask]:
    """Session-based multicam discovery: a session is a subdirectory of
    ``input_path`` and its video files are time-aligned cameras
    (``<session>/<camera>.mp4``); files directly under ``input_path`` are
    warned about and skipped. The primary camera is the one whose filename
    stem is ``primary_camera``, else the lexicographically first. Resume
    goes by the primary's record id."""
    client = get_storage_client(input_path)
    done = _processed_video_ids(output_path) if output_path else set()
    sessions: dict[str, list[str]] = defaultdict(list)
    for info in client.list_files(input_path, suffixes=VIDEO_SUFFIXES):
        rel = relative_to_prefix(info.path, input_path)
        parts = PurePath(rel).parts if rel else ()
        if len(parts) < 2:
            logger.warning("skipping %s: multicam input expects <session>/<camera>", info.path)
            continue
        sessions[parts[0]].append(info.path)

    tasks: list[SplitPipeTask] = []
    skipped = 0
    for session_id in sorted(sessions):
        paths = sorted(sessions[session_id])
        stems = {PurePath(p).stem: p for p in paths}
        primary_path = stems.get(primary_camera)
        if primary_path is None:
            if primary_camera:
                logger.warning("session %s has no %r camera; using %s as primary", session_id, primary_camera,
                               PurePath(paths[0]).stem)
            primary_path = paths[0]
        if video_record_id(primary_path) in done:
            skipped += 1
            continue
        videos = [Video(path=primary_path, camera=PurePath(primary_path).stem)]
        videos += [Video(path=p, camera=PurePath(p).stem) for p in paths if p != primary_path]
        tasks.append(SplitPipeTask(video=videos[0], aux_videos=videos[1:], session_id=session_id))
        if limit and len(tasks) >= limit:
            break
    logger.info("discovered %d multicam sessions under %s (%d already processed, skipped)", len(tasks), input_path,
                skipped)
    return tasks
