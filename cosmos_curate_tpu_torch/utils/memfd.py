"""In-memory file paths: feed byte buffers to path-only APIs without disk IO
(copy of ``cosmos_curate_tpu/utils/memfd.py``).

Wraps ``os.memfd_create`` so decoders that only accept file paths (cv2's
FFmpeg backend) can read encoded video straight from RAM.
"""

from __future__ import annotations

import contextlib
import os
import tempfile
from typing import Iterator


@contextlib.contextmanager
def buffer_as_path(data: bytes, suffix: str = ".mp4") -> Iterator[str]:
    """Yield a readable path for ``data`` with no disk write when possible.

    Uses a memfd (`/proc/self/fd/N`) on Linux; falls back to a temp file.
    """
    try:
        fd = os.memfd_create("curate-buf")
    except (AttributeError, OSError):
        fd = -1
    if fd >= 0:
        try:
            view = memoryview(data)
            written = 0
            while written < len(view):  # os.write caps at ~2 GiB per call
                written += os.write(fd, view[written:])
            yield f"/proc/self/fd/{fd}"
        finally:
            os.close(fd)
        return
    with tempfile.NamedTemporaryFile(suffix=suffix) as f:
        f.write(data)
        f.flush()
        yield f.name
