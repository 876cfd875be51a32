"""cv2.VideoWriter-compatible wrapper over the native H264 encoder (port of
``cosmos_curate_tpu/video/h264.py``).

The reference guarantees H264 clip output; where cv2 has no H264 encoder,
``video/encode.py`` prefers this writer (libx264 through the system ffmpeg
libraries, bound in ``cosmos_curate_tpu_torch/native/h264_encoder.c``) and
only then negotiates down. ``h264_status()`` says which, and why.
"""

from __future__ import annotations

import ctypes
import os
import tempfile
import threading

import numpy as np

from cosmos_curate_tpu_torch.native import h264_error, load_h264

_probe_lock = threading.Lock()
_probe_result: bool | None = None


class NativeH264Writer:
    """Same call surface as cv2.VideoWriter (isOpened/write/release);
    ``write`` takes BGR uint8 frames like cv2."""

    def __init__(
        self,
        path: str,
        fps: float,
        size_wh: tuple[int, int],
        *,
        crf: int = 23,
        preset: str = "veryfast",
    ) -> None:
        self._lib = load_h264()
        self._ctx = None
        self._w, self._h = size_wh
        if self._lib is not None:
            self._ctx = self._lib.curate_h264_open(path.encode(), self._w, self._h, float(fps), crf, preset.encode())

    def isOpened(self) -> bool:
        return self._ctx is not None

    def write(self, frame_bgr: np.ndarray) -> None:
        if self._ctx is None:
            raise RuntimeError("writer not open")
        if frame_bgr.shape[:2] != (self._h, self._w) or frame_bgr.dtype != np.uint8:
            raise ValueError(f"expected uint8 [{self._h}, {self._w}, 3], got {frame_bgr.dtype} {frame_bgr.shape}")
        frame = np.ascontiguousarray(frame_bgr)
        rc = self._lib.curate_h264_write(self._ctx, frame.ctypes.data_as(ctypes.c_void_p))
        if rc != 0:
            raise RuntimeError(f"H264 encode failed rc={rc}")

    def release(self) -> None:
        if self._ctx is not None:
            self._lib.curate_h264_close(self._ctx)
            self._ctx = None

    def __del__(self) -> None:
        self.release()


def h264_available() -> bool:
    """One-time probe: can the native encoder actually open a file here?"""
    global _probe_result
    with _probe_lock:
        if _probe_result is None:
            ok = False
            if load_h264() is not None:
                fd, path = tempfile.mkstemp(suffix=".mp4")
                os.close(fd)
                try:
                    w = NativeH264Writer(path, 24.0, (32, 32))
                    ok = w.isOpened()
                    if ok:
                        w.write(np.zeros((32, 32, 3), np.uint8))
                    w.release()
                except (RuntimeError, ValueError):
                    ok = False
                finally:
                    os.unlink(path)
            _probe_result = ok
        return _probe_result


def h264_status() -> str:
    """``"available"``, or ``"unavailable: <reason>"``."""
    if h264_available():
        return "available"
    return f"unavailable: {h264_error() or 'the library loaded but its encoder did not open a file'}"
