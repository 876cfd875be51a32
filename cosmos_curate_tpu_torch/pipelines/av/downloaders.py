"""The AV download plane: concurrent clip fetch and a state database kept
in object storage (port of ``cosmos_curate_tpu/pipelines/av/downloaders.py``;
host code, no torch).

The caption and packaging steps may run on other hosts than the split, so
clips and session state arrive through the storage layer (the port's
storage clients: local paths, ``s3://``, ``gs://``, ``az://``).
``prefetch_clips`` fetches and decodes clips on a thread pool so the
caption engine on the card never waits on IO; ``RemoteSyncedStateDB`` is a
sqlite state database pulled from object storage at open and pushed back
on close.
"""

from __future__ import annotations

import hashlib
import os
import queue
import tempfile
import threading
from pathlib import Path
from typing import Callable, Generator, Iterable

from cosmos_curate_tpu_torch.pipelines.av.state_db import AVStateDB
from cosmos_curate_tpu_torch.storage.client import get_storage_client, read_bytes
from cosmos_curate_tpu_torch.utils.logging import get_logger
from cosmos_curate_tpu_torch.video.decode import extract_frames_at_fps

logger = get_logger(__name__)

_REMOTE = ("s3://", "gs://", "az://")


def prefetch_clips(
    rows: Iterable,
    root: str,
    *,
    target_fps: float = 1.0,
    resize_hw: tuple[int, int] = (224, 224),
    workers: int = 4,
    decode: Callable | None = None,
) -> Generator[tuple[str, "object"], None, None]:
    """Yield ``(clip_uuid, frames)`` with download+decode overlapped.

    A small thread pool fetches ``{root}/clips/<uuid>.mp4`` through the
    URL-aware storage client and decodes; results stream out in completion
    order with bounded buffering (2x workers), so the consumer (the caption
    engine) overlaps with IO instead of alternating. Per-clip failures are
    logged and skipped: one missing clip never kills the run."""
    decode = decode or (
        lambda data: extract_frames_at_fps(data, target_fps=target_fps, resize_hw=resize_hw)
    )
    rows = list(rows)
    if not rows:
        return
    workers = max(1, min(workers, len(rows)))
    out: queue.Queue = queue.Queue(maxsize=2 * workers)
    idx_lock = threading.Lock()
    it = iter(rows)
    _DONE = object()
    cancelled = threading.Event()

    def _put(item) -> bool:
        # Bounded put that gives up when the consumer abandoned the
        # generator, so worker threads (and their decoded-frame payloads)
        # don't leak for the life of the process.
        while not cancelled.is_set():
            try:
                out.put(item, timeout=0.2)
                return True
            except queue.Full:
                continue
        return False

    def work() -> None:
        while not cancelled.is_set():
            with idx_lock:
                row = next(it, None)
            if row is None:
                break
            uuid = getattr(row, "clip_uuid", row)
            path = f"{root.rstrip('/')}/clips/{uuid}.mp4"
            try:
                frames = decode(read_bytes(path))
            except FileNotFoundError:
                logger.warning("clip %s missing at %s; skipping", uuid, path)
                continue
            except Exception:
                logger.exception("clip %s failed to fetch/decode; skipping", uuid)
                continue
            if not _put((uuid, frames)):
                return
        _put(_DONE)

    threads = [threading.Thread(target=work, daemon=True) for _ in range(workers)]
    for t in threads:
        t.start()
    try:
        done = 0
        while done < workers:
            item = out.get()
            if item is _DONE:
                done += 1
                continue
            yield item
    finally:
        cancelled.set()
        # Drain so any worker blocked on a full queue can observe the flag.
        try:
            while True:
                out.get_nowait()
        except queue.Empty:
            pass
        for t in threads:
            t.join(timeout=5.0)


class RemoteSyncedStateDB:
    """A state DB whose sqlite file lives in object storage: pulled down at
    open, pushed back on close. One writer a DB file: two simultaneous
    writers would lose one side's updates."""

    def __init__(self, remote_path: str, *, cache_dir: str | None = None) -> None:
        # last-writer-wins push: on a multi-node launch (slurm runs the SAME
        # command on every node) concurrent pushes silently drop rows —
        # fail loud instead. Use postgres:// for shared multi-node state.
        num_nodes = int(os.environ.get("CURATE_NUM_NODES", "1"))
        if num_nodes > 1 and not os.environ.get("CURATE_ALLOW_REMOTE_DB_MULTINODE"):
            raise RuntimeError(
                f"remote sqlite state ({remote_path}) is single-writer but "
                f"CURATE_NUM_NODES={num_nodes}; use a postgres:// DSN for "
                "multi-node runs (or set CURATE_ALLOW_REMOTE_DB_MULTINODE=1 "
                "if each node uses a distinct db path)"
            )

        self._remote = remote_path
        self._client = get_storage_client(remote_path)
        digest = hashlib.sha256(remote_path.encode()).hexdigest()[:16]
        base = Path(cache_dir or tempfile.gettempdir()) / "curate_av_state"
        base.mkdir(parents=True, exist_ok=True)
        # Per-process local name: a stale file from a crashed run (or a
        # concurrent same-host process on the same remote path) must never
        # be silently reopened as if it were the remote's current state.
        self._local = base / f"{digest}.{os.getpid()}.sqlite"
        if self._local.exists():
            self._local.unlink()
        if self._client.exists(remote_path):
            self._local.write_bytes(self._client.read_bytes(remote_path))
            logger.info("pulled state db %s -> %s", remote_path, self._local)
        self._db = AVStateDB(str(self._local))
        self._closed = False

    def __getattr__(self, name):
        return getattr(self._db, name)

    def close(self) -> None:
        if self._closed:
            return
        self._db.close()
        self._client.write_bytes(self._remote, self._local.read_bytes())
        logger.info("pushed state db %s -> %s", self._local, self._remote)
        self._local.unlink(missing_ok=True)
        self._closed = True


def is_remote(path: str) -> bool:
    return path.startswith(_REMOTE)
