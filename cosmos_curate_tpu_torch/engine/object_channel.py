"""Peer-to-peer object transfer for the cross-node engine plane (port of
``cosmos_curate_tpu/engine/object_channel.py``: the reference's request,
stream and MAC, over the port's segments).

The central loop moves small refs; DATA moves directly between the nodes
that produce and consume it: every engine
process (driver and each node agent) runs an ``ObjectServer`` over its
local shared-memory store, and consumers pull segments straight from the
owner. The driver's control socket carries only ref descriptors; segment
RELEASE also rides the control link (remote_plane.ReleaseObjects), so this
channel is read-only.

Wire protocol (per connection, authenticated with the cluster token):
- request: one MAC'd control frame (remote_plane.send_msg) —
  ``("get", shm_name, nonce16)``, optionally extended with the caller's
  W3C traceparent (``("get", shm_name, nonce16, traceparent)``) so the
  OWNER's serve span joins the fetcher's trace instead of fragmenting.
- response: ``status u8 | total u64 | data stream | hmac-sha256`` where
  the MAC covers ``shm_name || nonce || data`` — binding the stream to
  THIS request, so a recorded stream of a different segment (or an old
  stream of the same name) cannot be replayed as the answer. The MAC is
  computed incrementally on both sides: transfers are constant-memory
  with no frame-size cap, so large batches stream instead of hitting a
  control-frame cliff.
"""

from __future__ import annotations

import contextlib
import hashlib
import hmac
import os
import socket
import struct
import threading
from typing import Iterator

from cosmos_curate_tpu_torch import chaos
from cosmos_curate_tpu_torch.engine import object_store
from cosmos_curate_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

_CHUNK = 1 << 20
_OK = b"\x01"
_MISSING = b"\x02"
_DENIED = b"\x03"


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(min(1 << 20, n - len(buf)))
        if not chunk:
            raise ConnectionError("object channel peer closed")
        buf += chunk
    return bytes(buf)


def _stream_mac(token: bytes, name: str, nonce: bytes) -> "hmac.HMAC":
    mac = hmac.new(token, digestmod=hashlib.sha256)
    mac.update(name.encode())
    mac.update(nonce)
    return mac


class ObjectServer:
    """Serves GETs for the local object store. One thread per request —
    transfers are IO-bound and overlap; the store is just files in
    /dev/shm, so there is no shared mutable state to lock."""

    def __init__(self, token: bytes, *, host: str = "0.0.0.0") -> None:
        self._token = token
        self._server = socket.create_server((host, 0))
        self.port = self._server.getsockname()[1]
        self._closed = False
        # one request thread per GET: the counters are mutated concurrently
        self._stats_lock = threading.Lock()
        self.gets_served = 0  # observability + tests
        self.bytes_served = 0
        threading.Thread(target=self._accept_loop, daemon=True).start()

    def _accept_loop(self) -> None:
        while not self._closed:
            try:
                sock, _ = self._server.accept()
            except OSError:
                return
            threading.Thread(target=self._serve_one, args=(sock,), daemon=True).start()

    def _serve_one(self, sock: socket.socket) -> None:
        from cosmos_curate_tpu_torch.engine.remote_plane import recv_msg

        try:
            # a wedged/half-open peer must not pin this thread forever
            sock.settimeout(30)
            req = recv_msg(sock, self._token, max_bytes=1 << 20)
            if (
                isinstance(req, tuple)
                and len(req) in (3, 4)
                and req[0] == "get"
                and isinstance(req[2], bytes)
            ):
                tp = req[3] if len(req) == 4 and isinstance(req[3], str) else ""
                self._serve_get(sock, req[1], req[2], tp)
        except (ConnectionError, OSError):
            pass
        except Exception:
            logger.exception("object server request failed")
        finally:
            try:
                sock.close()
            except OSError:
                pass

    def _serve_get(
        self, sock: socket.socket, name, nonce: bytes, traceparent: str = ""
    ) -> None:
        from cosmos_curate_tpu_torch.observability.tracing import traced_span

        # kind=error: the connection resets before any bytes are served —
        # consumers see a dropped transfer, exactly like a mid-GET peer death
        chaos.fire(chaos.SITE_OBJECT_CHANNEL_SERVE)
        if not isinstance(name, str) or not object_store.valid_segment_name(name):
            sock.sendall(_DENIED + struct.pack(">Q", 0))
            return
        # serve threads have no ambient context, so an un-traced peer's pull
        # records nothing (a span without the incoming traceparent could
        # only start a one-span fragment). The span opens BEFORE the
        # segment lookup: a missing segment (release race, premature
        # eviction) is exactly the serve outcome worth tracing
        with contextlib.ExitStack() as stack:
            if traceparent:
                span = stack.enter_context(
                    traced_span(
                        "object_channel.serve", traceparent=traceparent, segment=name
                    )
                )
            else:
                span = None
            try:
                f = open(object_store.segment_path(name), "rb")
            except FileNotFoundError:
                if span is not None:
                    span.set_attribute("result", "missing")
                sock.sendall(_MISSING + struct.pack(">Q", 0))
                return
            stack.enter_context(f)
            f.seek(0, 2)
            total = f.tell()
            f.seek(0)
            if span is not None:
                span.set_attribute("bytes", total)
            sock.sendall(_OK + struct.pack(">Q", total))
            mac = _stream_mac(self._token, name, nonce)
            while True:
                chunk = f.read(_CHUNK)
                if not chunk:
                    break
                mac.update(chunk)
                sock.sendall(chunk)
            sock.sendall(mac.digest())
        with self._stats_lock:
            self.gets_served += 1
            self.bytes_served += total

    def close(self) -> None:
        self._closed = True
        try:
            self._server.close()
        except OSError:
            pass


def _open_get(
    addr: tuple[str, int], token: bytes, name: str
) -> tuple[socket.socket, int, "Iterator[bytes]"]:
    from cosmos_curate_tpu_torch.engine.remote_plane import send_msg
    from cosmos_curate_tpu_torch.observability.tracing import format_traceparent

    # kind=error: the dial/transfer fails as a ConnectionError, flowing
    # through the same localize/fetch retry paths a real drop would
    chaos.fire(chaos.SITE_OBJECT_CHANNEL_FETCH)
    nonce = os.urandom(16)
    sock = socket.create_connection(addr, timeout=30)
    try:
        # the traceparent rides the request so the OWNER's serve span joins
        # this fetch's trace (the caller's fetch span is ambient here).
        # Untraced requests keep the legacy 3-tuple. Version skew is no
        # longer this tuple's problem: every peer on the plane passed the
        # PROTOCOL_VERSION handshake (remote_plane.Hello/HelloAck), so a
        # mixed-version fleet is rejected at connect rather than reaching
        # this request — the old "tracing requires same-version peers"
        # caveat is now enforced, not documented. Changing the tuple's
        # arity or element types requires a PROTOCOL_VERSION bump.
        tp = format_traceparent()
        req = ("get", name, nonce, tp) if tp else ("get", name, nonce)
        send_msg(sock, req, token)
        head = _recv_exact(sock, 1 + 8)
        status = head[:1]
        (total,) = struct.unpack(">Q", head[1:])
        if status == _MISSING:
            raise FileNotFoundError(f"object {name} not on owner")
        if status != _OK:
            raise ConnectionError(f"object fetch for {name} denied")
    except BaseException:
        sock.close()
        raise

    def chunks() -> "Iterator[bytes]":
        mac = _stream_mac(token, name, nonce)
        left = total
        while left:
            chunk = sock.recv(min(_CHUNK, left))
            if not chunk:
                raise ConnectionError("object stream truncated")
            mac.update(chunk)
            left -= len(chunk)
            yield chunk
        trailer = _recv_exact(sock, 32)
        if not hmac.compare_digest(trailer, mac.digest()):
            raise ConnectionError(f"object {name} failed stream authentication")

    return sock, total, chunks()


def fetch_object(
    addr: tuple[str, int], token: bytes, ref: object_store.ObjectRef
) -> object_store.ObjectRef:
    """Pull a segment from its owner into the LOCAL store; returns the
    local ref. Constant-memory streaming; the request-bound trailing MAC
    authenticates the whole stream. The .tmp-then-rename in put_raw_chunks
    means a truncated/forged transfer never becomes a visible segment."""
    from cosmos_curate_tpu_torch.observability.tracing import traced_span

    with traced_span(
        "object_channel.fetch",
        segment=ref.shm_name,
        owner=f"{addr[0]}:{addr[1]}",
    ) as span:
        sock, total, chunks = _open_get(addr, token, ref.shm_name)
        span.set_attribute("bytes", total)
        try:
            return object_store.put_raw_chunks(chunks, total, ref.num_buffers)
        finally:
            try:
                sock.close()
            except OSError:
                pass


def fetch_value(addr: tuple[str, int], token: bytes, ref: object_store.ObjectRef):
    """Pull a segment and reconstruct the object WITHOUT creating a local
    segment (final-sink materialization)."""
    from cosmos_curate_tpu_torch.observability.tracing import traced_span

    with traced_span(
        "object_channel.fetch_value",
        segment=ref.shm_name,
        owner=f"{addr[0]}:{addr[1]}",
    ) as span:
        sock, total, chunks = _open_get(addr, token, ref.shm_name)
        span.set_attribute("bytes", total)
        try:
            # chunks() delivers exactly `total` bytes or raises (truncation
            # and MAC failures surface from the generator)
            return object_store.loads_segment(b"".join(chunks))
        finally:
            try:
                sock.close()
            except OSError:
                pass
