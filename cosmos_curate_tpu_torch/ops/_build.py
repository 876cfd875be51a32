"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into its own
shared library under ``<repo>/build/torch_kernels/`` on first use, and loads
with ``ctypes`` (plain C interface: no PyTorch headers, so a build takes
seconds). The library name carries a hash of its sources and flags, so an
edited kernel rebuilds and a stale library is never loaded. ``build_all``
starts one ``nvcc`` per source, all at once.

Nothing here runs at import: the CPU tests import every module of the port
on a machine without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


class KernelError(RuntimeError):
    """A hand-written kernel could not be built, refused its inputs, or
    failed to launch. Callers let it propagate: it is never one request's
    fault."""


class KernelInputError(KernelError, ValueError):
    """A kernel wrapper refused its tensors (device, dtype, shape, layout)."""


class KernelLaunchError(KernelError):
    """A kernel launch returned a nonzero ``cudaGetLastError``."""


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise KernelError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is")


def _library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _start_build(name: str) -> tuple[Path, Path, subprocess.Popen] | None:
    out = _library_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return out, tmp, proc


def _finish_build(out: Path, tmp: Path, proc: subprocess.Popen) -> None:
    log, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise KernelError(f"nvcc failed for {out.name} (exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)


def build_all() -> None:
    """Compile every kernel library (one per ``csrc/*.cu``) in parallel; a
    no-op for those already built."""
    names = sorted(p.stem for p in CSRC.glob("*.cu"))
    with _lock:
        started = [b for b in (_start_build(n) for n in names) if b is not None]
        errors = []
        for out, tmp, proc in started:
            try:
                _finish_build(out, tmp, proc)
            except KernelError as e:
                errors.append(str(e))
        if errors:
            raise KernelError("\n".join(errors))


def load(name: str) -> ctypes.CDLL:
    """The loaded ``lib<name>`` library, building it first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is not None:
            return lib
        started = _start_build(name)
        if started is not None:
            _finish_build(*started)
        lib = ctypes.CDLL(str(_library_path(name)))
        _libs[name] = lib
        return lib


class CudaKernel:
    """One C entry point of a kernel library, with its launch counter.

    ``launches`` counts the launches made through :meth:`launch` and nothing
    else: a run zeroes it, drives its path, and reads it back to prove the
    path went through the kernel."""

    def __init__(self, library: str, symbol: str, argtypes: list) -> None:
        self.library = library
        self.symbol = symbol
        self._argtypes = argtypes
        self._fn = None
        self._count_lock = threading.Lock()
        self.launches = 0

    def _resolve(self):
        if self._fn is None:
            fn = getattr(load(self.library), self.symbol)
            fn.argtypes = self._argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        return self._fn

    def launch(self, *args) -> None:
        rc = self._resolve()(*args)
        if rc != 0:
            raise KernelLaunchError(f"{self.symbol} launch failed: cudaError {rc}")
        with self._count_lock:
            self.launches += 1
