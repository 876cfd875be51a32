"""CPU video decode: metadata probing and frame extraction (port of
``cosmos_curate_tpu/video/decode.py``: the entry points the split
pipeline's stages call, and ``decode_frame_ids`` for the camera sensors).

Built on OpenCV's FFmpeg backend. Decode stays on the host: throughput comes
from decode threads feeding batched device stages. Every entry point
accepts a path or encoded ``bytes`` (served through a memfd, so nothing
touches disk).
"""

from __future__ import annotations

import contextlib
from typing import Iterator

import cv2
import numpy as np

from cosmos_curate_tpu_torch.data.model import FrameExtractionSignature, VideoMetadata
from cosmos_curate_tpu_torch.utils.memfd import buffer_as_path


@contextlib.contextmanager
def _open_capture(source: str | bytes) -> Iterator[cv2.VideoCapture]:
    with contextlib.ExitStack() as stack:
        if isinstance(source, (bytes, bytearray, memoryview)):
            path = stack.enter_context(buffer_as_path(bytes(source)))
        else:
            path = str(source)
        cap = cv2.VideoCapture(path)
        try:
            if not cap.isOpened():
                what = len(source) if isinstance(source, (bytes, bytearray)) else path
                raise ValueError(f"could not open video source ({what})")
            yield cap
        finally:
            cap.release()


def extract_video_metadata(source: str | bytes) -> VideoMetadata:
    """Probe width/height/fps/frame-count/duration."""
    size = len(source) if isinstance(source, (bytes, bytearray)) else 0
    with _open_capture(source) as cap:
        fps = float(cap.get(cv2.CAP_PROP_FPS)) or 0.0
        n = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
        fourcc = int(cap.get(cv2.CAP_PROP_FOURCC))
        codec = "".join(chr((fourcc >> (8 * i)) & 0xFF) for i in range(4)).strip("\x00 ")
        return VideoMetadata(
            width=int(cap.get(cv2.CAP_PROP_FRAME_WIDTH)),
            height=int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT)),
            fps=fps,
            num_frames=n,
            duration_s=(n / fps) if fps > 0 else 0.0,
            codec=codec,
            size_bytes=size,
        )


def decode_frames(
    source: str | bytes,
    *,
    start_frame: int = 0,
    num_frames: int | None = None,
    stride: int = 1,
    resize_hw: tuple[int, int] | None = None,
) -> np.ndarray:
    """Decode frames to RGB uint8 ``[T, H, W, 3]``, every ``stride``-th from
    ``start_frame``, resized (``INTER_AREA``) to ``resize_hw`` when given.
    Frames are grabbed in order (seeking by frame index is unreliable
    across codecs)."""
    frames: list[np.ndarray] = []
    with _open_capture(source) as cap:
        idx = 0
        wanted = start_frame
        while True:
            ok = cap.grab()
            if not ok:
                break
            if idx == wanted:
                ok, bgr = cap.retrieve()
                if not ok:
                    break
                if resize_hw is not None:
                    bgr = cv2.resize(bgr, (resize_hw[1], resize_hw[0]), interpolation=cv2.INTER_AREA)
                frames.append(cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB))
                if num_frames is not None and len(frames) >= num_frames:
                    break
                wanted += stride
            idx += 1
    if not frames:
        return np.zeros((0, 0, 0, 3), np.uint8)
    return np.stack(frames)


def decode_frame_ids(
    source: str | bytes,
    frame_ids: list[int],
    *,
    resize_hw: tuple[int, int] | None = None,
) -> np.ndarray:
    """Decode the frames at ``frame_ids`` to RGB uint8 ``[T, H, W, 3]``, one
    per unique id, in sorted-id order (resized with ``INTER_AREA`` to
    ``resize_hw`` when given). Ids past the end are left out."""
    targets = sorted(set(frame_ids))
    out: dict[int, np.ndarray] = {}
    with _open_capture(source) as cap:
        idx = 0
        ti = 0
        while ti < len(targets):
            ok = cap.grab()
            if not ok:
                break
            if idx == targets[ti]:
                ok, bgr = cap.retrieve()
                if not ok:
                    break
                if resize_hw is not None:
                    bgr = cv2.resize(bgr, (resize_hw[1], resize_hw[0]), interpolation=cv2.INTER_AREA)
                out[idx] = cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB)
                ti += 1
            idx += 1
    if not out:
        return np.zeros((0, 0, 0, 3), np.uint8)
    return np.stack([out[i] for i in targets if i in out])


def extract_frames_multi(
    source: str | bytes,
    signatures: tuple[FrameExtractionSignature, ...] | list[FrameExtractionSignature],
    *,
    resize_hw: tuple[int, int] | None = None,
) -> dict[str, np.ndarray]:
    """Serve every ``FrameExtractionSignature`` from ONE decode pass.

    The capture opens once, every source frame is decoded at most once, and
    resize + BGR→RGB conversion run once per retrieved frame, shared by
    every signature that samples it. Returns ``{sig.key(): [T, H, W, 3]
    uint8}``, an empty ``(0, 0, 0, 3)`` array for a signature nothing was
    decoded for. Duplicate keys collapse.
    """
    sigs = list(signatures)
    empty = np.zeros((0, 0, 0, 3), np.uint8)
    if not sigs:
        return {}
    frames: dict[str, list[np.ndarray]] = {}
    for s in sigs:
        frames.setdefault(s.key(), [])
    try:
        with _open_capture(source) as cap:
            fps = float(cap.get(cv2.CAP_PROP_FPS))
            if fps <= 0:
                return {k: empty for k in frames}
            stride = {s.key(): max(1, round(fps / s.target_fps)) for s in sigs}
            wanted = {k: 0 for k in frames}
            idx = 0
            while True:
                ok = cap.grab()
                if not ok:
                    break
                takers = [k for k, w in wanted.items() if w == idx]
                if takers:
                    ok, bgr = cap.retrieve()
                    if not ok:
                        break
                    if resize_hw is not None:
                        bgr = cv2.resize(bgr, (resize_hw[1], resize_hw[0]), interpolation=cv2.INTER_AREA)
                    rgb = cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB)
                    for k in takers:
                        frames[k].append(rgb)
                        wanted[k] += stride[k]
                idx += 1
    except ValueError:
        return {k: empty for k in frames}
    return {k: (np.stack(v) if v else empty) for k, v in frames.items()}


def extract_frames_at_fps(
    source: str | bytes, *, target_fps: float = 1.0, resize_hw: tuple[int, int] | None = None
) -> np.ndarray:
    """Frames sampled uniformly at ``target_fps``: one signature of
    ``extract_frames_multi``, so the two never diverge."""
    sig = FrameExtractionSignature("fps", target_fps)
    return extract_frames_multi(source, (sig,), resize_hw=resize_hw)[sig.key()]


def get_frame_timestamps(source: str | bytes) -> np.ndarray:
    """Per-frame presentation timestamps in seconds.

    Exact for mp4/mov: the container's sample tables are parsed directly
    (video/mp4_index.py), correct for variable frame rates too. Other
    containers fall back to a constant rate from the probed fps."""
    from cosmos_curate_tpu_torch.video.mp4_index import Mp4ParseError, parse_mp4_video_index

    try:
        return parse_mp4_video_index(source).pts_s
    except (Mp4ParseError, OSError):
        pass
    meta = extract_video_metadata(source)
    if meta.fps <= 0:
        return np.zeros(0, np.float64)
    return np.arange(meta.num_frames, dtype=np.float64) / meta.fps
