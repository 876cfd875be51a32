"""File-based inter-process lock (port of
``cosmos_curate_tpu/utils/file_lock.py``): serialises a critical section
across the processes of one host, such as the weight staging of
``models/registry.py``, through ``flock``."""

from __future__ import annotations

import contextlib
import fcntl
import os
import time
from pathlib import Path
from typing import Iterator


@contextlib.contextmanager
def file_lock(path: str | Path, *, timeout_s: float = 60.0) -> Iterator[None]:
    """Exclusive flock on ``path`` (created if absent); raises TimeoutError
    if not acquired within ``timeout_s``."""
    p = Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    fd = os.open(p, os.O_CREAT | os.O_RDWR, 0o600)
    deadline = time.monotonic() + timeout_s
    try:
        while True:
            try:
                fcntl.flock(fd, fcntl.LOCK_EX | fcntl.LOCK_NB)
                break
            except BlockingIOError:
                if time.monotonic() >= deadline:
                    raise TimeoutError(f"could not acquire lock {p} within {timeout_s}s")
                time.sleep(0.05)
        yield
    finally:
        try:
            fcntl.flock(fd, fcntl.LOCK_UN)
        finally:
            os.close(fd)
