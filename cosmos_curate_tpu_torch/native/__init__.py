"""ctypes binding of the port's native H.264 clip writer (port of the
``h264_encoder.c`` binding of ``cosmos_curate_tpu/native/__init__.py``).

``h264_encoder.c`` (this package's own copy) is compiled with ``gcc`` on
first use into ``<repo>/build/native/``, cached under a hash of its source
and rebuilt when the source changes or the cached library does not load
(one built on another host). The build runs once per process under
a lock and lands through an atomic rename, so concurrent stage threads and
processes never load a half-written library. Where the build or the load
fails (no libavcodec headers, no libx264), ``load_h264`` returns None, logs
why once, and keeps the reason in ``h264_error()``; the encoder then falls
back to cv2's negotiated codec (video/encode.py).

Not ported: the streaming engine's object-store framing
(``curate_native.cpp``, ROADMAP queue A item 9) and the motion-vector
extractor (``mv_extract.c``, item 16).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

from cosmos_curate_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "native"
_BUILD_TIMEOUT_S = 120


def _configure_h264(lib: ctypes.CDLL) -> None:
    lib.curate_h264_open.restype = ctypes.c_void_p
    lib.curate_h264_open.argtypes = [
        ctypes.c_char_p,
        ctypes.c_int,
        ctypes.c_int,
        ctypes.c_double,
        ctypes.c_int,
        ctypes.c_char_p,
    ]
    lib.curate_h264_write.restype = ctypes.c_int
    lib.curate_h264_write.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.curate_h264_close.restype = ctypes.c_int
    lib.curate_h264_close.argtypes = [ctypes.c_void_p]


SOURCE = Path(__file__).parent / "h264_encoder.c"
_STEM = "libcurate_h264"
_LIBS = ["-lavformat", "-lavcodec", "-lavutil", "-lswscale"]
_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_error: str | None = None  # why the library is unavailable


def _build(so: Path) -> None:
    """Compile ``SOURCE`` into ``so``: to a process-unique temp, then an
    atomic rename."""
    tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp.so")
    cmd = ["gcc", "-O2", "-shared", "-fPIC", "-o", str(tmp), str(SOURCE), *_LIBS]
    try:
        subprocess.run(cmd, check=True, capture_output=True, text=True, timeout=_BUILD_TIMEOUT_S)
        tmp.replace(so)
    finally:
        tmp.unlink(missing_ok=True)  # a failed build leaves nothing
    logger.info("built native library %s", so.name)


def load_h264() -> ctypes.CDLL | None:
    """The libx264 encoder binding; None -> cv2's negotiated codec."""
    global _lib, _error
    if _lib is not None or _error is not None:
        return _lib
    with _lock:  # every concurrent caller waits here for the one build
        if _lib is not None or _error is not None:
            return _lib
        try:
            tag = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:16]
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            so = BUILD_DIR / f"{_STEM}-{tag}.so"
            lib = None
            if so.exists():
                try:
                    lib = ctypes.CDLL(str(so))
                except OSError as e:
                    # built on another host (a copied tree): rebuild here,
                    # so a failure reports this host's reason
                    logger.info("cached %s does not load (%s); rebuilding", so.name, e)
                    so.unlink(missing_ok=True)
            if lib is None:
                _build(so)
                lib = ctypes.CDLL(str(so))
            _configure_h264(lib)
            _lib = lib
        except subprocess.CalledProcessError as e:
            first = (e.stderr or "").strip().splitlines()
            _fail(f"gcc failed: {first[0] if first else e}")
        except (OSError, AttributeError, subprocess.TimeoutExpired) as e:
            _fail(f"{type(e).__name__}: {e}")
    return _lib


def _fail(reason: str) -> None:
    global _error
    _error = reason
    logger.warning("%s unavailable (%s); falling back to cv2's negotiated codec", _STEM, reason)


def h264_error() -> str | None:
    """Why ``load_h264`` returned None (None when it loaded or was not tried)."""
    return _error
