"""Video frame index: per-frame timestamps for sensor construction (port of
``cosmos_curate_tpu/sensors/video_index.py``).

A nanosecond timestamp for every frame of a video, so a bare video becomes
a ``CameraSensor`` without a sidecar log. ISO-BMFF files (mp4, mov) take
their exact presentation times from the container's sample tables
(``video/mp4_index.py``, variable frame rates included); other containers
fall back to a constant rate from cv2's fps and frame count. Timestamps are
anchored at a caller-supplied capture start.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from cosmos_curate_tpu_torch.sensors.sampling import NS


@dataclass(frozen=True)
class VideoIndex:
    path: str
    fps: float
    frame_count: int
    timestamps_ns: np.ndarray  # int64 [frame_count], anchored at t0_ns

    @property
    def duration_s(self) -> float:
        return self.frame_count / self.fps if self.fps > 0 else 0.0


def index_video(path: str, *, t0_ns: int = 0) -> VideoIndex:
    # exact per-frame PTS from the container's sample tables when the file
    # is ISO-BMFF (correct for VFR too); constant-rate fallback otherwise
    from cosmos_curate_tpu_torch.video.mp4_index import Mp4ParseError, parse_mp4_video_index

    try:
        idx = parse_mp4_video_index(path)
    except (Mp4ParseError, OSError):
        idx = None
    if idx is not None and idx.frame_count > 0:
        ts = t0_ns + np.round(idx.pts_s * NS).astype(np.int64)
        fps = idx.frame_count / idx.duration_s if idx.duration_s > 0 else 0.0
        return VideoIndex(
            path=path, fps=float(fps), frame_count=idx.frame_count, timestamps_ns=ts
        )
    import cv2

    cap = cv2.VideoCapture(path)
    try:
        if not cap.isOpened():
            raise FileNotFoundError(f"unreadable video {path}")
        fps = cap.get(cv2.CAP_PROP_FPS) or 0.0
        count = int(cap.get(cv2.CAP_PROP_FRAME_COUNT) or 0)
    finally:
        cap.release()
    if fps <= 0 or count <= 0:
        raise ValueError(f"video {path} has no usable fps/frame count ({fps}, {count})")
    ts = t0_ns + (np.arange(count, dtype=np.int64) * round(NS / fps)).astype(np.int64)
    return VideoIndex(path=path, fps=float(fps), frame_count=count, timestamps_ns=ts)


def camera_frame_refs(camera: str, path: str, *, t0_ns: int = 0) -> list:
    """CameraFrameRef list for a bare mp4 — feed straight to CameraSensor."""
    from cosmos_curate_tpu_torch.sensors.data import CameraFrameRef

    index = index_video(path, t0_ns=t0_ns)
    return [
        CameraFrameRef(
            camera=camera,
            video_path=path,
            frame_index=i,
            timestamp_s=float(index.timestamps_ns[i]) / NS,
        )
        for i in range(index.frame_count)
    ]
