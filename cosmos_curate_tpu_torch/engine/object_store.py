"""Shared-memory object store of the streaming engine (port of
``cosmos_curate_tpu/engine/object_store.py``, its single-host part).

An object is pickled with protocol 5 (cloudpickle, so tasks whose classes
live in a driver script travel by value); its large buffers (numpy arrays,
bytes) go out of band into one POSIX shared-memory segment per object, and
only a small ``ObjectRef`` travels through the engine's queues. A consumer
reads the segment once and rebuilds the object with zero-copy views for
the large buffers.

The segment layout is the reference's, byte for byte, so a segment either
package writes reads back through the other's ``get``::

    [u64 len(payload)][payload][u64 nbuf][u64 size]*nbuf [buffers...]

``put`` frames through the native library (native/curate_native.cpp:
``shm_open``, ``ftruncate``, ``mmap`` and one gather pass) when it builds,
else through ``multiprocessing.shared_memory`` in Python, as the reference
falls back (object_store.py:44-69). The framing is host code. ``stats()``
counts this process's puts, bytes and native puts.

Ownership: segments are named ``cur<owner pid>-<hex>`` after the
coordinator (``CURATE_STORE_OWNER``), so a recycled worker leaves live data
behind for downstream stages and ``cleanup_stale_segments`` reclaims the
segments of dead coordinators. ``StoreBudget`` accounts the bytes in flight
and gates new inputs when the budget is full; its ``deleter`` is where the
cross-node runner puts the location-aware delete (agent-owned segments are
released at their owner) and the lineage tracker in front of it.
``put_raw_chunks``, ``segment_path`` and ``valid_segment_name`` serve the
cross-node object channel (engine/object_channel.py).
"""

from __future__ import annotations

import ctypes
import os
import pickle
import re
import threading
import uuid
from dataclasses import dataclass
from multiprocessing import shared_memory

import numpy as np

from cosmos_curate_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

_HEADER = 8  # u64 pickle-bytes length prefix
_SHM_DIR = "/dev/shm"
_COPY_THRESHOLD = 1 << 20  # buffers below 1 MiB are copied out of the view
_SEGMENT_RE = re.compile(r"cur(\d+)-[0-9a-f]+")

_STATS_LOCK = threading.Lock()
_STATS = {"puts": 0, "put_bytes": 0, "native_puts": 0}


@dataclass(frozen=True)
class ObjectRef:
    """The handle that travels through the engine's queues."""

    shm_name: str
    total_size: int
    num_buffers: int

    def __repr__(self) -> str:
        return f"ObjectRef({self.shm_name}, {self.total_size}B)"


def stats() -> dict:
    """This process's puts, their bytes, and how many took the native
    framing."""
    with _STATS_LOCK:
        return dict(_STATS)


def _count_put(total: int, native: bool) -> None:
    with _STATS_LOCK:
        _STATS["puts"] += 1
        _STATS["put_bytes"] += total
        _STATS["native_puts"] += int(native)


def _native_put(name: str, payload: bytes, views: list, total: int) -> bool:
    """One native framing pass (native/curate_native.cpp); False = take the
    Python framing. numpy wraps each buffer for a stable pointer without a
    copy (read-only buffers too)."""
    from cosmos_curate_tpu_torch.native import load_native

    lib = load_native()
    if lib is None:
        return False
    n = len(views)
    ptrs = (ctypes.c_void_p * max(1, n))()
    szs = (ctypes.c_uint64 * max(1, n))()
    arrs = []  # kept alive until the call returns
    for i, v in enumerate(views):
        a = np.frombuffer(v.cast("B"), np.uint8)
        arrs.append(a)
        ptrs[i] = a.ctypes.data
        szs[i] = a.nbytes
    return lib.cn_put(f"/{name}".encode(), payload, len(payload), ptrs, szs, n, total) == 0


def put(obj, *, prefix: str | None = None) -> ObjectRef:
    """Serialize ``obj`` into a fresh segment; returns its ref. Segments
    carry the coordinator's pid (``CURATE_STORE_OWNER``), never a worker's:
    a recycled or crashed worker leaves data downstream stages still read."""
    import cloudpickle

    if prefix is None:
        prefix = f"cur{os.environ.get('CURATE_STORE_OWNER', os.getpid())}"
    buffers: list[pickle.PickleBuffer] = []
    payload = cloudpickle.dumps(obj, protocol=5, buffer_callback=buffers.append)
    views = [b.raw() for b in buffers]
    sizes = [len(v) for v in views]
    meta = len(sizes).to_bytes(8, "little") + b"".join(s.to_bytes(8, "little") for s in sizes)
    total = _HEADER + len(payload) + len(meta) + sum(sizes)
    name = f"{prefix}-{uuid.uuid4().hex[:16]}"
    if _native_put(name, payload, views, max(total, 16)):
        for b in buffers:
            b.release()
        _count_put(total, native=True)
        return ObjectRef(shm_name=name, total_size=total, num_buffers=len(sizes))
    seg = shared_memory.SharedMemory(name=name, create=True, size=max(total, 16))
    # the resource tracker would unlink the segment when THIS process exits;
    # the coordinator owns it (StoreBudget.release and the stale-segment
    # janitor delete it)
    try:
        from multiprocessing import resource_tracker

        resource_tracker.unregister(seg._name, "shared_memory")
    except Exception:
        pass
    try:
        mv = seg.buf
        try:
            mv[:_HEADER] = len(payload).to_bytes(8, "little")
            off = _HEADER
            mv[off : off + len(payload)] = payload
            off += len(payload)
            mv[off : off + len(meta)] = meta
            off += len(meta)
            for v in views:
                n = v.nbytes
                mv[off : off + n] = v.cast("B") if v.ndim != 1 or v.format != "B" else v
                off += n
        finally:
            del mv  # release the exported pointer before close
    finally:
        for b in buffers:
            b.release()
        seg.close()
    _count_put(total, native=False)
    return ObjectRef(shm_name=name, total_size=total, num_buffers=len(sizes))


def get(ref: ObjectRef):
    """Rebuild the object: ONE read of the whole segment, then zero-copy
    slices feed pickle's out-of-band buffers. The segment file is read
    directly: attaching through ``multiprocessing.shared_memory`` would
    register it with this process's resource tracker, which unlinks it at
    exit while other processes still need it."""
    path = os.path.join(_SHM_DIR, ref.shm_name)
    try:
        with open(path, "rb") as f:
            data = f.read()
    except FileNotFoundError as e:
        raise FileNotFoundError(f"object store segment {ref.shm_name} missing") from e
    return loads_segment(data)


def loads_segment(data: bytes):
    """Rebuild an object from a segment's bytes (the store's format)."""
    mv = memoryview(data)
    plen = int.from_bytes(mv[:_HEADER], "little")
    off = _HEADER
    payload = mv[off : off + plen]
    off += plen
    nbuf = int.from_bytes(mv[off : off + 8], "little")
    off += 8
    sizes = [int.from_bytes(mv[off + 8 * i : off + 8 * (i + 1)], "little") for i in range(nbuf)]
    off += 8 * nbuf
    # small buffers are copied out, so a kept small array does not pin the
    # whole segment's bytes; large ones stay views
    bufs = []
    for s in sizes:
        chunk = mv[off : off + s]
        bufs.append(bytes(chunk) if s < _COPY_THRESHOLD else chunk)
        off += s
    return pickle.loads(payload, buffers=bufs)


def delete(ref: ObjectRef) -> None:
    try:
        os.unlink(os.path.join(_SHM_DIR, ref.shm_name))
    except FileNotFoundError:
        pass


def segment_path(name: str) -> str:
    return os.path.join(_SHM_DIR, name)


def valid_segment_name(name: str) -> bool:
    """Only store-shaped names may cross the object channel (a hostile GET
    must not read arbitrary /dev/shm files, nor carry path separators)."""
    return _SEGMENT_RE.fullmatch(name) is not None


def put_raw_chunks(chunks, total_size: int, num_buffers: int, *, prefix: str | None = None) -> ObjectRef:
    """Write raw segment bytes (the store's format, e.g. streamed from
    another node's store) into a LOCAL segment under the local owner's name:
    the source's name is not reused, since the stale-segment janitor
    reclaims segments whose embedded pid is dead on THIS host. Constant
    memory: ``chunks`` is an iterable of byte chunks. A failed or short
    transfer never becomes a visible segment (write to ``.tmp``, then
    rename)."""
    if prefix is None:
        prefix = f"cur{os.environ.get('CURATE_STORE_OWNER', os.getpid())}"
    name = f"{prefix}-{uuid.uuid4().hex[:16]}"
    tmp = segment_path(name) + ".tmp"
    written = 0
    try:
        with open(tmp, "wb") as f:
            for chunk in chunks:
                f.write(chunk)
                written += len(chunk)
        if written != total_size:
            raise ConnectionError(f"object transfer truncated: got {written} of {total_size} bytes")
    except BaseException:
        # a .tmp left behind would pin /dev/shm: the janitor's pattern never
        # matches it
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    os.replace(tmp, segment_path(name))
    return ObjectRef(shm_name=name, total_size=total_size, num_buffers=num_buffers)


def cleanup_stale_segments(shm_dir: str = _SHM_DIR) -> int:
    """Unlink ``cur<pid>-*`` segments whose coordinator is gone (a crashed
    or killed run must not leak shared memory). Returns how many were
    reclaimed; segments of live pids, and of pids this process may not
    signal, are left alone."""
    n = 0
    try:
        names = os.listdir(shm_dir)
    except OSError:
        return 0
    for name in names:
        m = _SEGMENT_RE.fullmatch(name)
        if not m:
            continue
        try:
            os.kill(int(m.group(1)), 0)
            continue  # owner alive
        except ProcessLookupError:
            pass
        except PermissionError:
            continue  # another pid namespace's
        try:
            os.unlink(os.path.join(shm_dir, name))
            n += 1
        except OSError:
            pass
    if n:
        logger.info("reclaimed %d stale object-store segments", n)
    return n


class StoreBudget:
    """Coordinator-side accounting of the bytes in flight.

    ``account`` always records (stage outputs exist already, so ``used``
    may pass the capacity); ``has_headroom`` then gates new inputs until
    consumers ``release``, which frees the segment through ``deleter``
    (default: unlink the local segment)."""

    def __init__(self, capacity_bytes: int, *, deleter=None) -> None:
        self.capacity = capacity_bytes
        self._used = 0
        self._live: dict[str, int] = {}
        self._cv = threading.Condition()
        self._deleter = deleter or delete

    @property
    def used(self) -> int:
        return self._used

    def account(self, ref: ObjectRef) -> None:
        with self._cv:
            self._live[ref.shm_name] = ref.total_size
            self._used += ref.total_size

    def has_headroom(self) -> bool:
        with self._cv:
            return self._used < self.capacity or not self._live

    def tracks(self, ref: ObjectRef) -> bool:
        """Whether ``ref`` is in the ledger (accounted, not yet released):
        reconstruction releases exactly the refs it accounted at adoption."""
        with self._cv:
            return ref.shm_name in self._live

    def release(self, ref: ObjectRef) -> None:
        with self._cv:
            size = self._live.pop(ref.shm_name, 0)
            self._used -= size
            self._cv.notify_all()
        self._deleter(ref)
