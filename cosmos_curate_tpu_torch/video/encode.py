"""CPU video encode and per-clip transcode (port of
``cosmos_curate_tpu/video/encode.py``).

Cuts each clip's span out of its source and re-encodes it as a standalone
mp4. The native H264 writer (video/h264.py) goes first; without it, cv2's
FFmpeg writer with the first codec of ``_CODEC_PREFERENCE`` that opens,
because encoder availability differs per cv2 build. The negotiation runs
once per process, under a lock, since transcode threads call it at once.
"""

from __future__ import annotations

import os
import tempfile
import threading

import cv2
import numpy as np

from cosmos_curate_tpu_torch.video.decode import _open_capture
from cosmos_curate_tpu_torch.video.h264 import NativeH264Writer, h264_available

_CODEC_PREFERENCE = ("avc1", "mp4v")
_negotiate_lock = threading.Lock()
_negotiated: str | None = None


def _pick_codec() -> str:
    global _negotiated
    with _negotiate_lock:
        if _negotiated is not None:
            return _negotiated
        try:
            prev = cv2.utils.logging.getLogLevel()
            cv2.utils.logging.setLogLevel(cv2.utils.logging.LOG_LEVEL_SILENT)
        except AttributeError:
            prev = None
        try:
            with tempfile.NamedTemporaryFile(suffix=".mp4") as f:
                for cc in _CODEC_PREFERENCE:
                    w = cv2.VideoWriter(f.name, cv2.VideoWriter_fourcc(*cc), 24.0, (16, 16))
                    ok = w.isOpened()
                    w.release()
                    if ok:
                        _negotiated = cc
                        return cc
        finally:
            if prev is not None:
                cv2.utils.logging.setLogLevel(prev)
    raise RuntimeError("no usable mp4 encoder in cv2 build")


def negotiated_codec() -> str:
    """The codec clips will actually be written with: native H264 when the
    binding is live, else cv2's negotiated fallback."""
    return "avc1" if h264_available() else _pick_codec()


def make_writer(path: str, fps: float, w: int, h: int):
    """(writer, codec); the writer has the cv2.VideoWriter call surface."""
    if h264_available():
        writer = NativeH264Writer(path, fps, (w, h))
        if writer.isOpened():
            return writer, "avc1"
    codec = _pick_codec()
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*codec), fps, (w, h))
    return writer, codec


def encode_frames(frames: np.ndarray, fps: float) -> bytes:
    """Encode RGB uint8 ``[T, H, W, 3]`` frames into an mp4 container."""
    if frames.ndim != 4 or frames.shape[-1] != 3:
        raise ValueError(f"expected [T,H,W,3] RGB frames, got {frames.shape}")
    t, h, w, _ = frames.shape
    # the writers require a real file path (no memfd: re-opened by name)
    fd, path = tempfile.mkstemp(suffix=".mp4")
    os.close(fd)
    try:
        writer, codec = make_writer(path, fps, w, h)
        if not writer.isOpened():
            raise RuntimeError(f"encoder {codec} failed to open for {w}x{h}@{fps}")
        for i in range(t):
            writer.write(cv2.cvtColor(frames[i], cv2.COLOR_RGB2BGR))
        writer.release()
        with open(path, "rb") as f:
            return f.read()
    finally:
        os.unlink(path)


class _ClipWriter:
    """One open encoder + temp file for a span being cut."""

    def __init__(self, start_f: int, end_f: int):
        self.start_f = start_f
        self.end_f = end_f
        self.path: str | None = None
        self.writer = None

    def open(self, fps: float, w: int, h: int) -> str:
        fd, self.path = tempfile.mkstemp(suffix=".mp4")
        os.close(fd)
        self.writer, codec = make_writer(self.path, fps, w, h)
        if not self.writer.isOpened():
            raise RuntimeError(f"encoder {codec} failed to open for {w}x{h}@{fps}")
        return codec

    def finish(self) -> bytes:
        data = b""
        if self.writer is not None:
            self.writer.release()
            self.writer = None
        if self.path is not None:
            with open(self.path, "rb") as f:
                data = f.read()
            os.unlink(self.path)
            self.path = None
        return data

    def abort(self) -> None:
        if self.writer is not None:
            self.writer.release()
            self.writer = None
        if self.path is not None:
            os.unlink(self.path)
            self.path = None


def transcode_clips(
    source: str | bytes,
    spans_s: list[tuple[float, float]],
    *,
    timestamps_s=None,
) -> list[tuple[bytes, str]]:
    """Cut every span of ``source`` in ONE sequential decode pass.

    The source is opened once, each frame is decoded once, and every
    encoder whose span covers it receives it (overlapping spans supported).
    ``timestamps_s`` (per-frame PTS) maps span seconds to frames exactly;
    without it the probed fps does. Returns (mp4_bytes, codec) per span, in
    input order; spans past end-of-stream yield empty bytes.
    """
    codec = negotiated_codec()
    if not spans_s:
        return []
    with _open_capture(source) as cap:
        fps = float(cap.get(cv2.CAP_PROP_FPS)) or 24.0
        if timestamps_s is not None and len(timestamps_s) > 0:
            ts = np.asarray(timestamps_s, np.float64)
            clips = []
            for a, b in spans_s:
                start = int(np.searchsorted(ts, a, side="left"))
                clips.append(_ClipWriter(start, max(start + 1, int(np.searchsorted(ts, b, side="left")))))
        else:
            clips = [_ClipWriter(int(a * fps), int(b * fps)) for a, b in spans_s]
        # sorted view by start frame for an O(1) active set sweep
        pending = sorted(range(len(clips)), key=lambda i: clips[i].start_f)
        active: list[int] = []
        results: list[bytes] = [b""] * len(clips)
        max_end = max(c.end_f for c in clips)
        p = 0
        idx = 0
        try:
            while idx < max_end:
                ok = cap.grab()
                if not ok:
                    break
                while p < len(pending) and clips[pending[p]].start_f <= idx:
                    active.append(pending[p])
                    p += 1
                done = [i for i in active if clips[i].end_f <= idx]
                for i in done:
                    results[i] = clips[i].finish()
                    active.remove(i)
                if active:
                    ok, bgr = cap.retrieve()
                    if not ok:
                        break
                    h, w = bgr.shape[:2]
                    for i in active:
                        c = clips[i]
                        if c.writer is None:
                            codec = c.open(fps, w, h)
                        c.writer.write(bgr)
                idx += 1
            for i in active:
                results[i] = clips[i].finish()
        finally:
            for c in clips:
                c.abort()
        return [(r, codec) for r in results]
