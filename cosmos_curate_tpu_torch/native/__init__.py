"""ctypes bindings of the port's native libraries (port of the
``h264_encoder.c`` and ``mv_extract.c`` bindings of
``cosmos_curate_tpu/native/__init__.py``).

- ``h264_encoder.c``: the libx264 clip writer (``load_h264``);
- ``mv_extract.c``: codec motion vectors over libavcodec's ``export_mvs``
  (``load_mv``, video/motion_vectors.py).

Each source (this package's own copy) is compiled with ``gcc`` on first use
into ``<repo>/build/native/``, cached under a hash of its source and
rebuilt when the source changes or the cached library does not load (one
built on another host). The build runs once per process under a lock and
lands through an atomic rename, so concurrent stage threads and processes
never load a half-written library. Where the build or the load fails (no
libavcodec headers, no libx264), the loader returns None, logs why once,
and keeps the reason (``h264_error()``, ``mv_error()``); the encoder then
falls back to cv2's negotiated codec (video/encode.py) and the motion
filter to its frame-difference estimator.

Not ported: the streaming engine's object-store framing
(``curate_native.cpp``, ROADMAP queue A item 9b).
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


def _configure_mv(lib: ctypes.CDLL) -> None:
    lib.curate_mv_field.restype = ctypes.c_int
    lib.curate_mv_field.argtypes = [
        ctypes.c_char_p,
        ctypes.c_int,
        ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_ubyte),
        ctypes.c_int,
        ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int),
    ]


_AV_LIBS = ["-lavformat", "-lavcodec", "-lavutil"]
SOURCE = Path(__file__).parent / "h264_encoder.c"
_STEM = "libcurate_h264"
_LIBS = [*_AV_LIBS, "-lswscale"]
MV_SOURCE = Path(__file__).parent / "mv_extract.c"
_MV_STEM = "libcurate_mv"
_MV_LIBS = [*_AV_LIBS, "-lm"]
_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_error: str | None = None  # why the library is unavailable
_mv_lib: ctypes.CDLL | None = None
_mv_error: str | None = None


def _build(so: Path, source: Path, libs: list[str]) -> None:
    """Compile ``source`` into ``so``: to a process-unique temp, then an
    atomic rename."""
    tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp.so")
    cmd = ["gcc", "-O2", "-shared", "-fPIC", "-o", str(tmp), str(source), *libs]
    try:
        subprocess.run(cmd, check=True, capture_output=True, text=True, timeout=_BUILD_TIMEOUT_S)
        tmp.replace(so)
    finally:
        tmp.unlink(missing_ok=True)  # a failed build leaves nothing
    logger.info("built native library %s", so.name)


def _load(source: Path, stem: str, libs: list[str], configure) -> tuple[ctypes.CDLL | None, str | None]:
    """(library, None) once built and loaded, else (None, the reason)."""
    try:
        tag = hashlib.sha256(source.read_bytes()).hexdigest()[:16]
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        so = BUILD_DIR / f"{stem}-{tag}.so"
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
            _build(so, source, libs)
            lib = ctypes.CDLL(str(so))
        configure(lib)
        return lib, None
    except subprocess.CalledProcessError as e:
        first = (e.stderr or "").strip().splitlines()
        return None, f"gcc failed: {first[0] if first else e}"
    except (OSError, AttributeError, subprocess.TimeoutExpired) as e:
        return None, f"{type(e).__name__}: {e}"


def load_h264() -> ctypes.CDLL | None:
    """The libx264 encoder binding; None -> cv2's negotiated codec."""
    global _lib, _error
    if _lib is not None or _error is not None:
        return _lib
    with _lock:  # every concurrent caller waits here for the one build
        if _lib is None and _error is None:
            _lib, _error = _load(SOURCE, _STEM, _LIBS, _configure_h264)
            if _error is not None:
                logger.warning("%s unavailable (%s); falling back to cv2's negotiated codec", _STEM, _error)
    return _lib


def h264_error() -> str | None:
    """Why ``load_h264`` returned None (None when it loaded or was not tried)."""
    return _error


def load_mv() -> ctypes.CDLL | None:
    """The motion-vector extraction binding; None -> the frame-difference
    estimator."""
    global _mv_lib, _mv_error
    if _mv_lib is not None or _mv_error is not None:
        return _mv_lib
    with _lock:
        if _mv_lib is None and _mv_error is None:
            _mv_lib, _mv_error = _load(MV_SOURCE, _MV_STEM, _MV_LIBS, _configure_mv)
            if _mv_error is not None:
                logger.warning("%s unavailable (%s); motion scores by frame difference", _MV_STEM, _mv_error)
    return _mv_lib


def mv_error() -> str | None:
    """Why ``load_mv`` returned None (None when it loaded or was not tried)."""
    return _mv_error
