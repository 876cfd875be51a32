"""Span math for clip extraction (port of ``cosmos_curate_tpu/video/splitter.py``):
fixed-stride spans, and the scene spans that shot detection's per-frame
transition probabilities give.
"""

from __future__ import annotations

import numpy as np

from cosmos_curate_tpu_torch.data.model import Clip, deterministic_id


def fixed_stride_spans(
    duration_s: float,
    *,
    clip_len_s: float = 10.0,
    stride_s: float | None = None,
    min_clip_len_s: float = 2.0,
) -> list[tuple[float, float]]:
    """Fixed-duration spans over ``[0, duration_s)``; the last partial span is
    kept only if at least ``min_clip_len_s`` long."""
    if duration_s <= 0 or clip_len_s <= 0:
        return []
    stride = stride_s if stride_s is not None else clip_len_s
    if stride <= 0:
        raise ValueError("stride must be positive")
    spans = []
    t = 0.0
    while t < duration_s:
        end = min(t + clip_len_s, duration_s)
        if end - t >= min_clip_len_s:
            spans.append((t, end))
        t += stride
    return spans


def scene_spans_from_predictions(
    predictions: np.ndarray,
    fps: float,
    *,
    threshold: float = 0.4,
    min_scene_len_s: float = 2.0,
    max_scene_len_s: float = 60.0,
    crop_s: float = 0.0,
    timestamps_s: np.ndarray | None = None,
) -> list[tuple[float, float]]:
    """Per-frame shot-transition probabilities -> scene spans in seconds.

    Frames with probability >= ``threshold`` are cut points; scenes shorter
    than ``min_scene_len_s`` are dropped, longer than ``max_scene_len_s``
    split into max-length pieces; ``crop_s`` is trimmed off both ends.
    ``timestamps_s`` (per-frame PTS, one per prediction) makes the frame to
    time map exact on variable-frame-rate sources; without it the constant
    ``fps`` map is used."""
    if predictions.size == 0:
        return []
    n = int(predictions.size)
    if timestamps_s is not None and len(timestamps_s) == n:
        tail = float(np.median(np.diff(timestamps_s))) if n > 1 else 1.0 / max(fps, 1.0)
        frame_time = np.append(np.asarray(timestamps_s, np.float64), timestamps_s[-1] + tail)
    elif fps > 0:
        frame_time = np.arange(n + 1, dtype=np.float64) / fps
    else:
        return []
    cuts = np.flatnonzero(predictions >= threshold)
    boundaries = [0, *(int(c) + 1 for c in cuts), n]
    spans: list[tuple[float, float]] = []
    for a, b in zip(boundaries[:-1], boundaries[1:]):
        if b <= a:
            continue
        start, end = float(frame_time[a]) + crop_s, float(frame_time[b]) - crop_s
        if end - start < min_scene_len_s:
            continue
        while end - start > max_scene_len_s:
            spans.append((start, start + max_scene_len_s))
            start += max_scene_len_s
        if end - start >= min_scene_len_s:
            spans.append((start, end))
    return spans


def make_clips(source_video: str, spans: list[tuple[float, float]]) -> list[Clip]:
    """``Clip`` objects with deterministic uuid5 ids, so re-runs and resume
    produce identical identities."""
    return [
        Clip(uuid=deterministic_id(source_video, f"{s:.6f}-{e:.6f}"), source_video=source_video, span=(s, e))
        for s, e in spans
    ]
