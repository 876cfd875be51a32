"""Span math for clip extraction (port of ``cosmos_curate_tpu/video/splitter.py``,
its fixed-stride part).

Not ported: ``scene_spans_from_predictions``, which turns shot-detection
scores into spans and waits for shot detection (ROADMAP queue A item 8).
"""

from __future__ import annotations

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


def make_clips(source_video: str, spans: list[tuple[float, float]]) -> list[Clip]:
    """``Clip`` objects with deterministic uuid5 ids, so re-runs and resume
    produce identical identities."""
    return [
        Clip(uuid=deterministic_id(source_video, f"{s:.6f}-{e:.6f}"), source_video=source_video, span=(s, e))
        for s, e in spans
    ]
