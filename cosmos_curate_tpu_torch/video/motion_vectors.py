"""Codec motion-vector motion scores (port of
``cosmos_curate_tpu/video/motion_vectors.py``).

The native binding (native/mv_extract.c, libavcodec ``export_mvs``)
aggregates each inter frame's vectors into a ``grid x grid`` field of mean
|mv| in pixels; this module turns the field into the motion filter's two
scores. A decode without motion-vector side data (an all-intra stream), or
a host without libavcodec (the binding does not build), gives ``None``, and
the filter scores by frame difference instead.

Score scale: per-frame mean |mv| in pixels over the frame height, the
fraction of the frame the content moves per frame. A static encode's skip
blocks carry no vectors, so static clips score exactly 0.

The stream reaches libavformat through a memfd path (utils/memfd.py), never
through a file on disk.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import numpy as np

from cosmos_curate_tpu_torch.utils.memfd import buffer_as_path

MV_PATCH_GRID = 8
_MAX_FRAMES = 2048


@dataclass
class MVField:
    """Per-frame mean-|mv| grids (pixels) for one clip's inter frames."""

    field: np.ndarray  # float32 [T, grid, grid]
    has_mv: np.ndarray  # bool [T]
    width: int
    height: int


def extract_mv_field(video_bytes: bytes, *, grid: int = MV_PATCH_GRID, max_frames: int = _MAX_FRAMES) -> MVField | None:
    """Decode ``video_bytes`` and return the per-frame MV field, or None
    when the native binding is unavailable or the stream yields no frames."""
    from cosmos_curate_tpu_torch.native import load_mv

    lib = load_mv()
    if lib is None:
        return None
    field = np.zeros((max_frames, grid, grid), np.float32)
    has = np.zeros(max_frames, np.uint8)
    w = ctypes.c_int(0)
    h = ctypes.c_int(0)
    with buffer_as_path(video_bytes) as path:
        n = lib.curate_mv_field(
            path.encode(),
            grid,
            field.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            has.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
            max_frames,
            ctypes.byref(w),
            ctypes.byref(h),
        )
    if n <= 0 or w.value <= 0 or h.value <= 0:
        return None
    return MVField(field=field[:n], has_mv=has[:n].astype(bool), width=w.value, height=h.value)


def mv_motion_scores(mv: MVField) -> tuple[float, float] | None:
    """(global_score, per_patch_min) from the MV field, or None when the
    clip has no inter frames to score.

    global: mean over inter frames of the frame's mean cell |mv| / height.
    per_patch_min: min over grid cells of that cell's time-mean |mv| /
    height (a clip where one region never moves scores about 0 here even
    if something else moves)."""
    inter = mv.field[mv.has_mv]
    if inter.shape[0] == 0:
        return None
    norm = float(mv.height)
    global_score = float(inter.mean()) / norm
    per_patch = inter.mean(axis=0) / norm
    return global_score, float(per_patch.min())
