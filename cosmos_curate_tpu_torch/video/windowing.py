"""Caption-window math (port of ``cosmos_curate_tpu/video/windowing.py``,
``compute_windows``): a clip's frames are cut into fixed windows (default
256 frames); a trailing remainder shorter than ``remainder_threshold``
merges into the previous window instead of forming a runt.
``overlapping_windows`` gives super resolution's overlapped windows."""

from __future__ import annotations


def compute_windows(
    num_frames: int,
    *,
    window_len: int = 256,
    remainder_threshold: int = 128,
) -> list[tuple[int, int]]:
    """Return [start, end) frame windows covering ``num_frames``. The final
    window absorbs a short remainder (< threshold); a remainder >=
    threshold becomes its own window."""
    if num_frames <= 0 or window_len <= 0:
        return []
    if remainder_threshold > window_len:
        raise ValueError("remainder_threshold must be <= window_len")
    windows = []
    start = 0
    while start + window_len <= num_frames:
        windows.append((start, start + window_len))
        start += window_len
    rem = num_frames - start
    if rem > 0:
        if windows and rem < remainder_threshold:
            windows[-1] = (windows[-1][0], num_frames)
        else:
            windows.append((start, num_frames))
    return windows


def overlapping_windows(num_frames: int, *, window_len: int = 128, overlap: int = 64) -> list[tuple[int, int]]:
    """[start, end) windows of ``window_len`` frames, each starting
    ``window_len - overlap`` after the last, the final one cut at
    ``num_frames`` (super resolution blends the overlaps)."""
    if num_frames <= 0:
        return []
    if overlap >= window_len:
        raise ValueError("overlap must be < window_len")
    step = window_len - overlap
    windows = []
    start = 0
    while True:
        end = min(start + window_len, num_frames)
        windows.append((start, end))
        if end >= num_frames:
            break
        start += step
    return windows
