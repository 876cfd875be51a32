"""Cross-node control plane of the streaming engine (port of
``cosmos_curate_tpu/engine/remote_plane.py``: the reference's frames,
framing, handshake and protocol version; the same message and token frame
to the same bytes).

The central loop moves small refs between nodes' per-stage pools; DATA
moves producer to consumer. Worker processes on REMOTE hosts join a CPU
stage's pool; ``SubmitBatch`` frames carry location-aware ref descriptors
and results return as descriptors too: the bytes ride the peer-to-peer
object channel (engine/object_channel.py) between whichever nodes produce
and consume them, so the driver's NIC never gates data volume. The
orchestration loop, retries, autoscaler and object store are unchanged;
dispatch prefers the worker whose node already owns a batch's input bytes.

Topology: the driver (node rank 0) listens on ``CURATE_ENGINE_DRIVER_PORT``;
every other node runs ``python -m cosmos_curate_tpu_torch.engine.remote_agent
--driver host:port`` (or ``cosmos-curate-tpu-torch agent``), which spawns
the same workers (engine/worker.py) the driver spawns locally and relays
their queues over the socket. GPU stages never place remotely: a host's
cards belong to that host's engine process; host-level GPU scale stays with
the partition and work-stealing modes (parallel/).

Wire format: length-prefixed frames authenticated with
HMAC-SHA256(``CURATE_ENGINE_TOKEN``). A frame that fails the MAC is dropped
before any unpickling, and the plane refuses to run without a shared token.
"""

from __future__ import annotations

import hashlib
import hmac
import os
import socket
import struct
import threading
import time
from dataclasses import dataclass, field
from typing import Any

import cloudpickle

from cosmos_curate_tpu_torch import chaos
from cosmos_curate_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

TOKEN_ENV = "CURATE_ENGINE_TOKEN"
DRIVER_PORT_ENV = "CURATE_ENGINE_DRIVER_PORT"
WAIT_NODES_ENV = "CURATE_ENGINE_WAIT_NODES"
WAIT_S_ENV = "CURATE_ENGINE_WAIT_S"
# driver-side failure detector: an agent that misses HEARTBEAT_MISSES
# consecutive heartbeat windows (the agent's watchdog ships AgentStats —
# possibly empty — every HEARTBEAT_S) is declared dead deterministically,
# instead of whenever a TCP send happens to fail. 0 disables the deadline
# (link errors still mark agents dead, as before).
HEARTBEAT_S_ENV = "CURATE_AGENT_HEARTBEAT_S"
HEARTBEAT_MISSES_ENV = "CURATE_AGENT_HEARTBEAT_MISSES"
DEFAULT_HEARTBEAT_S = 3.0
DEFAULT_HEARTBEAT_MISSES = 5

_MAGIC = b"CRPL"

# Control-plane protocol version. Frames are unversioned cloudpickle'd
# dataclasses, so two builds whose frame schemas drifted would not fail
# cleanly — they would MISDECODE each other mid-run (missing attributes
# surfacing as AttributeErrors deep in the orchestration loop, or worse,
# defaults silently papering over renamed fields). Instead the version
# rides the Hello/HelloAck handshake and mismatched peers are rejected at
# CONNECT time with an error that names both versions. Bump this whenever
# any frame in this module (or the object-channel request tuple) changes
# shape.
#
# v1: the unversioned plane (pre-handshake-check builds send no version
#     and read as v0/v1 — rejected).
# v2: Hello/HelloAck carry protocol_version; object-channel GET requests
#     may carry a traceparent 4th element (peers are handshake-matched, so
#     the old "tracing requires same-version peers" caveat is enforced
#     rather than documented).
PROTOCOL_VERSION = 2


def skew_error(peer_version: int, *, peer: str) -> str:
    """The one message both rejection paths log/raise: names both versions
    and the fix, because 'connection closed' during a rolling upgrade is a
    debugging session while this string is a shrug-and-upgrade."""
    return (
        f"protocol version skew: {peer} speaks v{peer_version}, this process "
        f"speaks v{PROTOCOL_VERSION}; refusing at handshake (mixed-version "
        "engine planes misdecode frames mid-run — upgrade the older side)"
    )


class ProtocolSkewError(ConnectionError):
    """Handshake rejected for a VERSION mismatch. Distinct from transient
    ConnectionErrors so the agent's reconnect loop fails fast (redialing a
    skewed driver every 0.5 s until the window expires helps nobody) while
    still flowing through every existing ConnectionError handler."""


def frame_version(frame: object) -> int:
    """The protocol version a handshake frame ACTUALLY carries. Must read
    the instance dict, never getattr: unpickling restores only the
    sender's fields, and on a missing attribute getattr falls back to the
    receiver's CLASS default — which is the receiver's own version, so a
    pre-versioning peer would masquerade as current. ``vars()`` makes the
    missing field read as 0 (pre-versioning) as intended."""
    return int(vars(frame).get("protocol_version", 0))


# -- messages ---------------------------------------------------------------


@dataclass
class Hello:
    node_id: str
    num_cpus: float
    # the agent's ObjectServer port (engine/object_channel.py): peers pull
    # this node's segments directly from here
    object_port: int = 0
    # host RAM in GiB for the per-node planner's memory fit check
    # (0 = unknown: the planner then fits on CPUs alone)
    memory_gb: float = 0.0
    # agent process pid (0 = unknown/old agent): on a reconnect the driver
    # uses it to tell a same-process link blip (segments survived — re-point
    # their locations) from a BOUNCED agent process (its stale-segment
    # janitor reclaimed the old pid's segments — leave locations on the
    # dead link so consumers reconstruct instead of fetching ghosts)
    pid: int = 0
    # handshake version gate: a peer built before versioning restores with
    # the attribute missing entirely (pickle state dicts carry only the
    # sender's fields), so the driver reads it as 0 and rejects cleanly
    protocol_version: int = PROTOCOL_VERSION


@dataclass
class StartWorker:
    worker_key: str
    stage_pickle: bytes
    meta_pickle: bytes
    env: dict[str, str]


@dataclass(frozen=True)
class RefSpec:
    """Location-aware object descriptor — what SubmitBatch carries instead
    of task payloads (the central loop moves refs; data moves
    producer→consumer). ``owner_node`` is '' when
    the driver's store owns the segment (the agent then dials the driver's
    control host at ``owner_port``)."""

    shm_name: str
    total_size: int
    num_buffers: int
    owner_node: str = ""
    owner_host: str = ""
    owner_port: int = 0


@dataclass
class SubmitBatch:
    worker_key: str
    batch_id: int
    refs: list  # list[RefSpec]
    # StageSpec.batch_timeout_s; 0 = no deadline. The AGENT's watchdog
    # enforces it (the driver cannot signal a process on another host):
    # an expired worker is killed and reported as WorkerDied, and the
    # driver's normal reap requeues the batch.
    timeout_s: float = 0.0
    # W3C trace context of the driver-side stage span: crosses the control
    # socket so the remote worker's spans parent onto the driver's trace
    # instead of starting a per-host fragment. '' = tracing off.
    traceparent: str = ""


@dataclass
class StopWorker:
    worker_key: str


@dataclass
class ReleaseObjects:
    """Driver → agent: these agent-owned segments have no remaining
    consumers — free them (the driver's StoreBudget.release for local
    segments, forwarded to the owner)."""

    names: list  # list[str]


@dataclass
class PrefetchObjects:
    """Driver → agent push-ahead: the router has decided the NEXT stage's
    batches will run on this node, so start pulling these segments from
    their owners NOW — into the agent's bounded prefetch cache — instead
    of waiting for the demand pull inside SubmitBatch input resolution.
    The transfer overlaps the node's current compute; a later SubmitBatch
    naming these segments resolves them as cache hits with ~zero wait.
    Purely advisory: a dropped or evicted prefetch degrades to the demand
    fetch, never to an error."""

    refs: list  # list[RefSpec]


@dataclass
class AgentStats:
    """Agent → driver (periodic, from the watchdog thread): object-plane
    transfer DELTAS since the last frame (stage_timer.OBJECT_PLANE_KEYS
    schema). Deltas, not totals, so the driver's per-node fold stays
    correct across link blips and reconnects."""

    object_plane: dict


@dataclass
class AgentReady:
    worker_key: str
    error: str | None = None


@dataclass
class AgentResult:
    worker_key: str
    batch_id: int
    # (shm_name, total_size, num_buffers) per output — the segments STAY in
    # the agent's store; consumers pull them over the object channel
    out_refs: list | None = None
    error: str | None = None
    process_time_s: float = 0.0
    deserialize_time_s: float = 0.0
    # the error is an INPUT LOSS (object-channel fetch failed: owner dead
    # or segment gone), not a user-code exception — the driver routes it to
    # lineage reconstruction / the node-death budget instead of burning the
    # batch's num_run_attempts
    input_loss: bool = False


@dataclass
class WorkerDied:
    """Agent → driver: a remote worker PROCESS died (the link is fine).

    The driver marks the worker dead so the orchestration loop's normal
    dead-worker reap requeues its in-flight batch — remote crashes recover
    through the same path as local ones."""

    worker_key: str


@dataclass
class Bye:
    pass


@dataclass
class HelloAck:
    """Driver's handshake reply: echoes the agent's session nonce (inside
    the MAC'd frame, so the binding cannot be forged) and contributes the
    driver's own nonce. The channel session id is the concatenation — BOTH
    sides contribute fresh randomness, so neither direction of a recorded
    session can be replayed into a later one. Also advertises the driver's
    ObjectServer port so agents can pull driver-owned segments."""

    agent_sid: bytes
    driver_object_port: int = 0
    # stable for one RemoteWorkerManager lifetime: agents use it to tell a
    # transient link blip (same run — keep output segments, the driver still
    # references them) from a driver restart (new run — the old outputs are
    # unreferenced dead weight)
    run_id: bytes = b""
    # the driver's protocol version: the agent verifies it in
    # connect_channel and refuses a skewed driver with a clear error
    protocol_version: int = PROTOCOL_VERSION


# Every dataclass that rides the control socket: add a frame here when you
# add one, and bump PROTOCOL_VERSION whenever
# any listed frame changes shape. Driver-local bookkeeping dataclasses
# (AgentLink) are deliberately absent — they never cross a process.
WIRE_FRAMES: tuple[type, ...] = (
    Hello, HelloAck, StartWorker, StopWorker, RefSpec, SubmitBatch,
    ReleaseObjects, PrefetchObjects, AgentStats, AgentReady, AgentResult,
    WorkerDied, Bye,
)


# -- framing ----------------------------------------------------------------


def _token() -> bytes:
    tok = os.environ.get(TOKEN_ENV, "")
    if not tok:
        raise RuntimeError(
            f"the cross-node engine plane requires {TOKEN_ENV} (shared "
            "cluster secret; frames are HMAC-authenticated before unpickling)"
        )
    return tok.encode()


MAX_FRAME_BYTES = 1 << 31


def _pack_meta(sid: bytes, direction: bytes, seq: int) -> bytes:
    return struct.pack(">H", len(sid)) + sid + direction + struct.pack(">Q", seq)


def _unpack_meta(meta: bytes) -> tuple[bytes, bytes, int]:
    if len(meta) < 2:
        raise ConnectionError("malformed frame meta")
    (n,) = struct.unpack(">H", meta[:2])
    if len(meta) != 2 + n + 3 + 8:
        raise ConnectionError("malformed frame meta")
    sid = meta[2 : 2 + n]
    direction = meta[2 + n : 5 + n]
    (seq,) = struct.unpack(">Q", meta[5 + n :])
    return sid, direction, seq


def send_msg(sock: socket.socket, msg: Any, token: bytes, *, meta: bytes = b"") -> int:
    """One MAC'd frame: [meta_len u16][meta][cloudpickle payload]. ``meta``
    carries freshness fields (session id, direction, sequence) OUTSIDE the
    pickle so the receiver verifies them before deserializing anything."""
    payload = cloudpickle.dumps(msg)
    body = struct.pack(">H", len(meta)) + meta + payload
    if len(body) > MAX_FRAME_BYTES:
        # enforce the receiver's cap at the SENDER: an oversized frame must
        # fail as one batch error, not sever the link when the peer rejects
        raise ValueError(
            f"frame of {len(body)} bytes exceeds the plane's "
            f"{MAX_FRAME_BYTES}-byte cap; shrink the stage batch size"
        )
    mac = hmac.new(token, body, hashlib.sha256).digest()
    header = _MAGIC + struct.pack(">Q", len(body)) + mac
    sock.sendall(header + body)
    return len(header) + len(body)


def send_frame(
    sock: socket.socket, token: bytes, sid: bytes, direction: bytes, seq: int, msg: Any
) -> int:
    return send_msg(sock, msg, token, meta=_pack_meta(sid, direction, seq))


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("peer closed")
        buf += chunk
    return bytes(buf)


def recv_msg_raw(
    sock: socket.socket, token: bytes, *, max_bytes: int = MAX_FRAME_BYTES
) -> tuple[bytes, bytes]:
    """MAC-verified (meta, pickled_payload) WITHOUT deserializing the
    payload — freshness checks must gate cloudpickle.loads, not follow it."""
    header = _recv_exact(sock, 4 + 8 + 32)
    if header[:4] != _MAGIC:
        raise ConnectionError("bad frame magic")
    (length,) = struct.unpack(">Q", header[4:12])
    if length > max_bytes:
        raise ConnectionError(f"frame too large: {length}")
    mac = header[12:44]
    body = _recv_exact(sock, length)
    want = hmac.new(token, body, hashlib.sha256).digest()
    if not hmac.compare_digest(mac, want):
        raise ConnectionError("frame failed authentication")
    if len(body) < 2:
        raise ConnectionError("malformed frame body")
    (n,) = struct.unpack(">H", body[:2])
    if len(body) < 2 + n:
        raise ConnectionError("malformed frame meta length")
    return body[2 : 2 + n], body[2 + n :]


def recv_msg(sock: socket.socket, token: bytes, *, max_bytes: int = MAX_FRAME_BYTES) -> Any:
    _, payload = recv_msg_raw(sock, token, max_bytes=max_bytes)
    return cloudpickle.loads(payload)


def recv_frame(
    sock: socket.socket, token: bytes, *, max_bytes: int = MAX_FRAME_BYTES
) -> tuple[bytes, bytes, int, Any]:
    meta, payload = recv_msg_raw(sock, token, max_bytes=max_bytes)
    sid, direction, seq = _unpack_meta(meta)
    return sid, direction, seq, cloudpickle.loads(payload)


class SecureChannel:
    """Replay-bound framing over one connection.

    The HMAC alone authenticates bytes but not freshness or direction: an
    on-path recorder could replay a StartWorker/SubmitBatch frame verbatim
    and re-execute its cloudpickle payload. Every frame therefore carries
    ``(session_id, direction, sequence)`` INSIDE the MAC'd payload: the
    session id is random per agent connection (a replayed frame from an
    old session cannot match a new session's id), the per-direction
    sequence must advance exactly by one (an in-session replay or
    reordering drops the link), and the direction tag stops reflecting a
    peer's own frames back at it. The freshness fields ride a fixed
    header INSIDE the MAC'd frame but OUTSIDE the pickled payload, so a
    stale or reflected frame is rejected BEFORE any object is
    deserialized."""

    A2D = b"a2d"  # agent -> driver
    D2A = b"d2a"  # driver -> agent

    def __init__(
        self,
        sock: socket.socket,
        token: bytes,
        sid: bytes,
        send_dir: bytes,
        recv_dir: bytes,
        *,
        send_seq_start: int = 0,
        recv_seq_start: int = 0,
    ) -> None:
        self.sock = sock
        self._token = token
        self.sid = sid
        self._send_dir = send_dir
        self._recv_dir = recv_dir
        self._send_seq = send_seq_start
        self._recv_seq = recv_seq_start
        self._lock = threading.Lock()
        # control-plane byte accounting: with the P2P object channel these
        # must stay O(refs) regardless of data volume (tests assert it)
        self.bytes_sent = 0
        self.bytes_received = 0

    def send(self, msg: Any) -> None:
        # kind=error: the control link drops mid-send (InjectedFault is a
        # ConnectionError, so the agent/driver reconnect paths engage)
        chaos.fire(chaos.SITE_REMOTE_PLANE_SEND)
        with self._lock:
            self.bytes_sent += send_frame(
                self.sock, self._token, self.sid, self._send_dir, self._send_seq, msg
            )
            self._send_seq += 1

    def recv(self, *, max_bytes: int = MAX_FRAME_BYTES) -> Any:
        chaos.fire(chaos.SITE_REMOTE_PLANE_RECV)  # kind=error: link reset
        meta, payload = recv_msg_raw(self.sock, self._token, max_bytes=max_bytes)
        self.bytes_received += len(meta) + len(payload) + 44
        sid, direction, seq = _unpack_meta(meta)
        # freshness gates deserialization: a replayed/cross-session frame is
        # rejected before its payload objects are ever reconstructed
        if sid != self.sid:
            raise ConnectionError("frame from a different session (replay?)")
        if direction != self._recv_dir:
            raise ConnectionError("frame direction mismatch (reflection?)")
        if seq != self._recv_seq:
            raise ConnectionError(
                f"frame out of order: got seq {seq}, expected {self._recv_seq} (replay?)"
            )
        self._recv_seq += 1
        return cloudpickle.loads(payload)


def accept_channel(
    sock: socket.socket, token: bytes, *, object_port: int = 0, run_id: bytes = b""
) -> tuple["SecureChannel", Any]:
    """Driver side of the handshake: read the agent's bootstrap frame,
    reply with the driver's own nonce (HelloAck, binding the agent's), and
    return (channel over the COMBINED session id, hello_msg). A recorded
    agent session replayed wholesale dies here: the driver's fresh nonce
    changes the combined id, so every post-handshake replayed frame is
    rejected."""
    meta, payload = recv_msg_raw(sock, token)
    agent_sid, direction, seq = _unpack_meta(meta)
    if direction != SecureChannel.A2D or seq != 0:
        raise ConnectionError("bad channel bootstrap frame")
    msg = cloudpickle.loads(payload)
    driver_sid = os.urandom(16)
    send_frame(
        sock, token, driver_sid, SecureChannel.D2A, 0,
        HelloAck(agent_sid, driver_object_port=object_port, run_id=run_id),
    )
    chan = SecureChannel(
        sock,
        token,
        agent_sid + driver_sid,
        SecureChannel.D2A,
        SecureChannel.A2D,
        send_seq_start=1,
        recv_seq_start=1,
    )
    return chan, msg


def connect_channel(
    sock: socket.socket, token: bytes, hello: Any
) -> tuple["SecureChannel", "HelloAck"]:
    """Agent side of the handshake: send the bootstrap Hello under a fresh
    nonce, verify the driver's ack binds it, and return (channel over the
    combined session id, the driver's ack)."""
    agent_sid = os.urandom(16)
    send_frame(sock, token, agent_sid, SecureChannel.A2D, 0, hello)
    meta, payload = recv_msg_raw(sock, token)
    driver_sid, direction, seq = _unpack_meta(meta)
    if direction != SecureChannel.D2A or seq != 0:
        raise ConnectionError("bad handshake ack from driver")
    ack = cloudpickle.loads(payload)
    if not isinstance(ack, HelloAck) or ack.agent_sid != agent_sid:
        raise ConnectionError("bad handshake ack from driver")
    # version gate BEFORE any post-handshake frame: a skewed driver must
    # fail here, at connect, with a message naming both versions — never
    # as a misdecoded StartWorker three frames later
    ack_version = frame_version(ack)
    if ack_version != PROTOCOL_VERSION:
        raise ProtocolSkewError(skew_error(ack_version, peer="driver"))
    chan = SecureChannel(
        sock,
        token,
        agent_sid + driver_sid,
        SecureChannel.A2D,
        SecureChannel.D2A,
        send_seq_start=1,
        recv_seq_start=1,
    )
    return chan, ack


# -- driver side ------------------------------------------------------------


class _RemoteProc:
    """Stands in for mp.Process in WorkerHandle: liveness = agent link AND
    the worker process on the agent (WorkerDied marks the latter)."""

    exitcode = "remote"  # runner logs this; remote exit codes stay remote

    def __init__(self, agent: "AgentLink", worker_key: str) -> None:
        self._agent = agent
        self._key = worker_key

    def is_alive(self) -> bool:
        return self._agent.alive and self._key not in self._agent.dead_workers

    def join(self, timeout: float | None = None) -> None:  # noqa: ARG002
        return

    def terminate(self) -> None:
        return


class _RemoteInQ:
    """Stands in for the worker's mp in-queue.

    ``put`` only ENQUEUES — materialization, pickling and the socket send
    happen on the manager's sender thread, so a large batch or a slow agent
    link never stalls the orchestration loop (the local path's mp.Queue has
    the same non-blocking property via its feeder thread)."""

    def __init__(self, mgr: "RemoteWorkerManager", agent: "AgentLink", worker_key: str) -> None:
        self._mgr = mgr
        self._agent = agent
        self._key = worker_key

    def put(self, msg: Any) -> None:
        from cosmos_curate_tpu_torch.engine.worker import ProcessMsg, ShutdownMsg

        if isinstance(msg, (ShutdownMsg, ProcessMsg)):
            self._mgr.enqueue_send(self._agent, self._key, msg)
            return
        raise TypeError(f"unexpected message for remote worker: {type(msg)}")


@dataclass
class AgentLink:
    node_id: str
    num_cpus: float
    sock: socket.socket
    token: bytes
    memory_gb: float = 0.0
    chan: "SecureChannel | None" = None
    alive: bool = True
    # the agent's ObjectServer endpoint (peer IP from the control socket +
    # the Hello's object_port): where this node's segments are pulled from
    object_addr: tuple = ("", 0)
    # worker_key -> cpu cost; accounting is in CPU units, matching the
    # autoscaler's per-worker resources.cpus
    worker_costs: dict = field(default_factory=dict)
    dead_workers: set = field(default_factory=set)
    # failure-detector state: agent process pid (Hello), when the last
    # frame arrived (any frame counts — results ARE liveness), and whether
    # this link's death was already surfaced as a node event (one event
    # per link, however many paths notice the death)
    pid: int = 0
    last_seen: float = field(default_factory=time.monotonic)
    death_recorded: bool = False

    @property
    def cpus_used(self) -> float:
        return sum(self.worker_costs.values())

    def send(self, msg: Any) -> None:
        if self.chan is None:
            return
        try:
            self.chan.send(msg)
        except OSError:
            self.alive = False


class RemoteWorkerManager:
    """Driver-side registry of connected node agents.

    ``results_q`` receives ReadyMsg/ResultMsg exactly as local pools emit
    them; remote outputs are put() into the driver's object store first, so
    downstream stages cannot tell where a batch ran."""

    def __init__(self, port: int, results_q, *, local_cpu_budget: float) -> None:
        from cosmos_curate_tpu_torch.engine.object_channel import ObjectServer

        self.token = _token()
        self.results_q = results_q
        self.local_cpu_budget = local_cpu_budget
        self.local_cpus_used = 0.0  # all pools' locally placed workers (cpu units)
        self.agents: list[AgentLink] = []
        self._lock = threading.Lock()
        # P2P object plane: the driver serves ITS segments from here, and
        # tracks which agent owns every remote segment (shm_name -> link)
        self.object_server = ObjectServer(self.token)
        self._locations: dict[str, AgentLink] = {}
        # shm_name -> EVERY node a push-ahead copy was sent to (a replan
        # can redirect a stage mid-run, pushing the same segment to a
        # second target): release must purge every target's prefetch
        # cache, or never-adopted copies sit in /dev/shm until cap
        # eviction (bounded; cleared wholesale past the cap)
        self._pushed_to: dict[str, list[AgentLink]] = {}
        # releases addressed to a currently-dead link wait here (node_id ->
        # segment names) and flush when that node rejoins — a transient blip
        # must not leak the agent's segments for the rest of the run
        self._pending_releases: dict[str, list] = {}
        # failure detector: per-agent heartbeat deadline (the agent's
        # watchdog ships an AgentStats frame — empty deltas included —
        # every heartbeat_s; see remote_agent._watchdog). Newly-declared
        # deaths queue here for the runner's live-replan poll.
        self.heartbeat_s = float(os.environ.get(HEARTBEAT_S_ENV, str(DEFAULT_HEARTBEAT_S)))
        self.heartbeat_misses = max(
            1, int(os.environ.get(HEARTBEAT_MISSES_ENV, str(DEFAULT_HEARTBEAT_MISSES)))
        )
        self._node_deaths: list[dict] = []
        self.run_id = os.urandom(16)
        self._server = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        # a restarted driver must rebind the well-known port: SO_REUSEADDR
        # covers TIME_WAIT, and a short retry covers the window where a
        # predecessor's accepted connections are still tearing down
        # (agents keep dialing, so seconds of delay cost nothing)
        self._server.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        import errno

        deadline = time.monotonic() + 20.0
        while True:
            try:
                self._server.bind(("0.0.0.0", port))
                break
            except OSError as e:
                # only the predecessor-teardown race is transient; EACCES
                # etc. are deterministic and must surface immediately
                if e.errno != errno.EADDRINUSE or time.monotonic() >= deadline:
                    raise
                time.sleep(0.5)
        self._server.listen(8)
        self._closed = False
        # async sender: materialize+pickle+send off the orchestration loop
        import queue as _queue

        self._send_q: "_queue.Queue" = _queue.Queue()
        threading.Thread(target=self._sender_loop, daemon=True).start()
        threading.Thread(target=self._accept_loop, daemon=True).start()
        logger.info("engine driver listening for node agents on :%d", port)

    def enqueue_send(self, agent: AgentLink, worker_key: str, msg) -> None:
        self._send_q.put((agent, worker_key, msg))

    def _sender_loop(self) -> None:
        import queue as _queue

        from cosmos_curate_tpu_torch.engine.worker import ProcessMsg, ShutdownMsg

        while not self._closed:
            try:
                agent, key, msg = self._send_q.get(timeout=0.2)
            except _queue.Empty:
                continue
            if isinstance(msg, ShutdownMsg):
                agent.send(StopWorker(key))
                with self._lock:
                    agent.worker_costs.pop(key, None)
                continue
            if isinstance(msg, (ReleaseObjects, PrefetchObjects)):
                agent.send(msg)
                continue
            if not isinstance(msg, ProcessMsg):
                continue
            # refs only — no payloads on the driver socket. The consumer
            # agent pulls each segment straight from its owner (this node's
            # ObjectServer, or a peer agent's) over the object channel.
            agent.send(
                SubmitBatch(
                    key, msg.batch_id, [self._spec_for(r) for r in msg.refs],
                    timeout_s=msg.timeout_s,
                    traceparent=getattr(msg, "traceparent", ""),
                )
            )

    def _spec_for(self, ref) -> RefSpec:
        with self._lock:
            link = self._locations.get(ref.shm_name)
        if link is None:  # driver-owned: agents dial the control host
            return RefSpec(
                ref.shm_name, ref.total_size, ref.num_buffers,
                owner_node="", owner_host="", owner_port=self.object_server.port,
            )
        return RefSpec(
            ref.shm_name, ref.total_size, ref.num_buffers,
            owner_node=link.node_id,
            owner_host=link.object_addr[0],
            owner_port=link.object_addr[1],
        )

    # -- connection handling -------------------------------------------
    def _accept_loop(self) -> None:
        while not self._closed:
            try:
                sock, addr = self._server.accept()
            except OSError:
                return
            if self._closed:
                # close() does not wake a thread already blocked in accept()
                # — the kernel listener stays alive until the NEXT dial, and
                # that dial is returned here after shutdown began. Serving
                # it would park the agent on a dead driver's socket (it
                # blocks in recv instead of redialing the successor), so
                # drop it: the agent's connect loop retries and reaches the
                # live driver.
                try:
                    sock.close()
                except OSError:
                    pass
                return
            threading.Thread(
                target=self._serve_agent, args=(sock, addr), daemon=True
            ).start()

    def _serve_agent(self, sock: socket.socket, addr) -> None:
        try:
            chan, hello = accept_channel(
                sock, self.token,
                object_port=self.object_server.port, run_id=self.run_id,
            )
        except (ConnectionError, OSError) as e:
            logger.warning("rejected agent connection from %s: %s", addr, e)
            sock.close()
            return
        if not isinstance(hello, Hello):
            sock.close()
            return
        hello_version = frame_version(hello)
        if hello_version != PROTOCOL_VERSION:
            # reject at connect: the HelloAck already carried the driver's
            # version (sent in accept_channel), so the agent's own gate in
            # connect_channel raises the same clear error on its side
            logger.warning(
                "rejected agent %s from %s: %s",
                hello.node_id, addr, skew_error(hello_version, peer="agent"),
            )
            sock.close()
            return
        link = AgentLink(
            hello.node_id, hello.num_cpus, sock, self.token, chan=chan,
            memory_gb=getattr(hello, "memory_gb", 0.0),
            object_addr=(addr[0], hello.object_port),
            pid=getattr(hello, "pid", 0),
        )
        # Hello dedup: links are keyed by node_id — an agent that bounced
        # (or healed from a partition) before the driver noticed must not
        # appear as TWO NodeBudgets or leave the stale link reachable from
        # the sender loop. The stale link is declared dead (quarantined,
        # one node event) and dropped from the registry; the reconnecting
        # agent joins as a FRESH node.
        with self._lock:
            stale_links = [a for a in self.agents if a.node_id == hello.node_id]
        for old in stale_links:
            self.note_agent_dead(old, reason="superseded by a reconnecting agent")
        with self._lock:
            self.agents = [a for a in self.agents if a.node_id != hello.node_id]
            self.agents.append(link)
            # REJOIN of the SAME agent process (link blip): the node kept
            # its segments (same run_id, same pid), so re-point their
            # location entries at the live link. A BOUNCED process (new
            # pid) reclaimed the old pid's segments at startup — its
            # entries stay on the dead link, so consumers see a dead owner
            # and reconstruct instead of fetching ghosts.
            for name, old in list(self._locations.items()):
                if (
                    old.node_id == hello.node_id
                    and old is not link
                    and link.pid
                    and old.pid == link.pid
                ):
                    self._locations[name] = link
            stale = self._pending_releases.pop(hello.node_id, [])
        if stale:
            with self._lock:
                for name in stale:
                    self._locations.pop(name, None)
            self._send_q.put((link, "", ReleaseObjects(stale)))
        logger.info(
            "node agent joined: %s (%.0f cpus) from %s", hello.node_id, hello.num_cpus, addr
        )
        try:
            while True:
                msg = chan.recv()
                link.last_seen = time.monotonic()  # any frame is a heartbeat
                self._on_agent_msg(link, msg)
        except (ConnectionError, OSError):
            link.alive = False
            logger.warning("node agent %s disconnected", link.node_id)

    def _on_agent_msg(self, link: AgentLink, msg: Any) -> None:
        from cosmos_curate_tpu_torch.engine import object_store
        from cosmos_curate_tpu_torch.engine.worker import ReadyMsg, ResultMsg

        if isinstance(msg, AgentStats):
            # fold the agent's object-plane deltas under its node id — the
            # driver is the only process with a metrics exporter, so the
            # pipeline_object_plane_* series covers every node's traffic
            from cosmos_curate_tpu_torch.observability.stage_timer import (
                record_node_object_plane,
            )

            if msg.object_plane:
                record_node_object_plane(link.node_id, msg.object_plane)
        elif isinstance(msg, WorkerDied):
            with self._lock:
                link.dead_workers.add(msg.worker_key)
                link.worker_costs.pop(msg.worker_key, None)
        elif isinstance(msg, AgentReady):
            self.results_q.put(ReadyMsg(worker_id=msg.worker_key, error=msg.error))
        elif isinstance(msg, AgentResult):
            if msg.error is not None:
                self.results_q.put(
                    ResultMsg(
                        msg.batch_id,
                        error=msg.error,
                        process_time_s=msg.process_time_s,
                        worker_id=msg.worker_key,
                        input_loss=getattr(msg, "input_loss", False),
                    )
                )
                return
            # outputs stay in the AGENT's store: register their location and
            # hand the orchestration loop ordinary refs — data only moves
            # when (and to where) a consumer needs it
            refs = []
            with self._lock:
                for name, size, nbuf in msg.out_refs or []:
                    refs.append(object_store.ObjectRef(name, size, nbuf))
                    self._locations[name] = link
            self.results_q.put(
                ResultMsg(
                    msg.batch_id,
                    out_refs=refs,
                    process_time_s=msg.process_time_s,
                    deserialize_time_s=msg.deserialize_time_s,
                    worker_id=msg.worker_key,
                )
            )

    def push_ahead(self, refs: list, node_id: str) -> int:
        """Ask ``node_id``'s agent to prefetch these segments from their
        owners (router push-ahead: the consumer node starts pulling while
        the producer's compute continues). Segments the target already
        owns are skipped. Returns how many were requested; 0 when the
        target is unknown/dead (the demand pull still works)."""
        with self._lock:
            link = next(
                (a for a in self.agents if a.alive and a.node_id == node_id), None
            )
        if link is None:
            return 0
        specs = [
            self._spec_for(r) for r in refs if self.owner_node(r) != node_id
        ]
        if specs:
            with self._lock:
                if len(self._pushed_to) > 65536:
                    self._pushed_to.clear()  # worst case: one missed purge
                for s in specs:
                    targets = self._pushed_to.setdefault(s.shm_name, [])
                    if link not in targets:
                        targets.append(link)
            self._send_q.put((link, "", PrefetchObjects(specs)))
        return len(specs)

    def node_budgets(self) -> list:
        """Live agents as ``(node_id, num_cpus, memory_gb)`` for the
        per-node planner (the driver's own NodeBudget is the runner's to
        build)."""
        with self._lock:
            return [
                (a.node_id, a.num_cpus, a.memory_gb)
                for a in self.agents
                if a.alive
            ]

    def heartbeat_ages(self, now: float | None = None) -> dict:
        """node_id -> heartbeat freshness for every registered link — the
        live-status snapshot's node-health section (the anomaly detector
        flags ``heartbeat_degraded`` from these ages BEFORE the failure
        detector's declare-dead deadline fires)."""
        now = time.monotonic() if now is None else now
        with self._lock:
            return {
                a.node_id: {
                    "heartbeat_age_s": round(max(0.0, now - a.last_seen), 3),
                    "alive": bool(a.alive),
                    "workers": len(a.worker_costs),
                }
                for a in self.agents
            }

    # -- failure detector ----------------------------------------------
    def note_agent_dead(self, link: AgentLink, *, reason: str = "declared dead") -> bool:
        """Declare one agent dead: quarantine the link (socket closed, so a
        hung/partitioned recv thread unblocks and a late frame from the old
        session can never resurrect stale state), record ONE node event for
        the runner's live-replan poll, and let the normal dead-worker reap
        fail its in-flight SubmitBatches as worker deaths (``_RemoteProc.
        is_alive`` keys on ``link.alive``). Idempotent per link; returns
        True the first time."""
        with self._lock:
            if link.death_recorded:
                link.alive = False
                return False
            link.death_recorded = True
            link.alive = False
            self._node_deaths.append(
                {
                    "node": link.node_id,
                    "reason": reason,
                    "at": time.time(),
                    "workers_lost": len(link.worker_costs),
                }
            )
        logger.warning("node %s declared dead: %s", link.node_id, reason)
        try:
            if link.sock is not None:
                link.sock.close()
        except OSError:
            pass
        return True

    def check_heartbeats(self, now: float | None = None) -> None:
        """Sweep the registry: links past their heartbeat deadline are
        declared dead; links some send/recv path already marked ``alive =
        False`` get their (single) node event recorded here. Cheap — a
        float compare per agent — so the runner calls it every loop tick."""
        now = time.monotonic() if now is None else now
        deadline = self.heartbeat_s * self.heartbeat_misses
        with self._lock:
            links = list(self.agents)
        for link in links:
            if not link.alive:
                if not link.death_recorded:
                    self.note_agent_dead(link, reason="link lost")
                continue
            if self.heartbeat_s > 0 and now - link.last_seen > deadline:
                self.note_agent_dead(
                    link,
                    reason=(
                        f"missed {self.heartbeat_misses} heartbeats "
                        f"(silent {now - link.last_seen:.1f}s > {deadline:.1f}s)"
                    ),
                )

    def poll_node_deaths(self) -> list[dict]:
        """Sweep heartbeats, then drain newly-recorded node-death events
        (the runner replans immediately on a non-empty result)."""
        self.check_heartbeats()
        with self._lock:
            out, self._node_deaths = self._node_deaths, []
        return out

    def owner_dead(self, ref) -> bool:
        """True when the segment's owning agent is registered but dead —
        the signal that a failed fetch is a NODE loss (reconstruct via
        lineage) rather than a transient error (retry)."""
        with self._lock:
            link = self._locations.get(ref.shm_name)
        return link is not None and not link.alive

    def node_of(self, name: str) -> str:
        """The node id registered as owning segment ``name`` (dead links
        included — DLQ entries stamp the LOST node); '' when unknown or
        driver-owned."""
        with self._lock:
            link = self._locations.get(name)
        return link.node_id if link is not None else ""

    def place_for(self, node_id: str, cpu_cost: float) -> "AgentLink | None":
        """Planner-directed placement: ``node_id == ''`` places locally;
        otherwise the named agent, falling back to the legacy least-loaded
        ``place`` when that agent is gone (an allocation plan must not
        wedge worker startup on a node that just died)."""
        if node_id == "":
            return None  # local; start_worker books note_local_start
        with self._lock:
            link = next(
                (a for a in self.agents if a.alive and a.node_id == node_id), None
            )
        if link is not None:
            return link
        return self.place(cpu_cost)

    # -- P2P data plane -------------------------------------------------
    def owner_node(self, ref) -> str:
        """'' when the driver's store owns the segment, else the agent's
        node id (dispatch affinity keys on this)."""
        with self._lock:
            link = self._locations.get(ref.shm_name)
        return link.node_id if link is not None else ""

    def localize(self, ref):
        """Pull an agent-owned segment into the DRIVER's store (a local
        consumer needs the bytes); returns the local ref. Driver-owned refs
        return unchanged."""
        from cosmos_curate_tpu_torch.engine import object_channel

        with self._lock:
            link = self._locations.get(ref.shm_name)
        if link is None:
            return ref
        return object_channel.fetch_object(link.object_addr, self.token, ref)

    def fetch_value_if_remote(self, ref):
        """Materialize a ref wherever it lives (final-sink path): remote
        refs stream from their owner without creating a local segment."""
        from cosmos_curate_tpu_torch.engine import object_channel, object_store

        with self._lock:
            link = self._locations.get(ref.shm_name)
        if link is None:
            return object_store.get(ref)
        return object_channel.fetch_value(link.object_addr, self.token, ref)

    def release_data(self, ref) -> None:
        """Location-aware delete: local segments unlink here; agent-owned
        segments release at their owner (via the control link's sender
        thread — never the orchestration loop). A dead link's releases are
        parked and flushed when that node rejoins."""
        from cosmos_curate_tpu_torch.engine import object_store

        with self._lock:
            link = self._locations.get(ref.shm_name)
            if link is not None and not link.alive:
                self._pending_releases.setdefault(link.node_id, []).append(
                    ref.shm_name
                )
                return
            self._locations.pop(ref.shm_name, None)
            pushed = self._pushed_to.pop(ref.shm_name, None) or []
        for target in pushed:
            if target is not link and target.alive:
                # a push-ahead target that never consumed its copy (the
                # batch was routed elsewhere, or a replan superseded the
                # target): purge its prefetch cache too — the name can
                # never be demanded again
                self._send_q.put((target, "", ReleaseObjects([ref.shm_name])))
        if link is None:
            object_store.delete(ref)
        else:
            self._send_q.put((link, "", ReleaseObjects([ref.shm_name])))

    # -- placement (all accounting in CPU units: a worker costs its
    # stage's resources.cpus, matching the autoscaler's budget math) ----
    def remote_cpus(self) -> float:
        with self._lock:
            return sum(a.num_cpus for a in self.agents if a.alive)

    def place(self, cpu_cost: float) -> AgentLink | None:
        """None = place locally. Local CPUs fill first (no network hop),
        then the least-loaded live agent with room for this worker."""
        cost = max(0.25, cpu_cost)  # zero-cost stages still occupy budget
        with self._lock:
            if self.local_cpus_used + cost <= self.local_cpu_budget + 1e-9:
                return None
            candidates = [
                a
                for a in self.agents
                if a.alive and a.cpus_used + cost <= a.num_cpus + 1e-9
            ]
            if not candidates:
                return None
            return min(candidates, key=lambda a: a.cpus_used)

    def note_local_start(self, cpu_cost: float) -> None:
        with self._lock:
            self.local_cpus_used += max(0.25, cpu_cost)

    def note_local_stop(self, cpu_cost: float) -> None:
        with self._lock:
            self.local_cpus_used = max(0.0, self.local_cpus_used - max(0.25, cpu_cost))

    def note_remote_gone(self, proc: _RemoteProc) -> None:
        with self._lock:
            proc._agent.worker_costs.pop(proc._key, None)
            proc._agent.dead_workers.discard(proc._key)

    def start_remote_worker(
        self,
        agent: AgentLink,
        worker_key: str,
        stage_pickle: bytes,
        meta_pickle: bytes,
        env: dict,
        *,
        cpu_cost: float = 1.0,
    ):
        with self._lock:
            agent.worker_costs[worker_key] = max(0.25, cpu_cost)
        agent.send(StartWorker(worker_key, stage_pickle, meta_pickle, env))
        return _RemoteInQ(self, agent, worker_key), _RemoteProc(agent, worker_key)

    def wait_for_agents(self, n: int, timeout_s: float) -> int:
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            with self._lock:
                live = sum(1 for a in self.agents if a.alive)
            if live >= n:
                return live
            time.sleep(0.1)
        with self._lock:
            return sum(1 for a in self.agents if a.alive)

    def stats(self) -> dict:
        with self._lock:
            return {
                a.node_id: {
                    "cpus": a.num_cpus,
                    "workers": len(a.worker_costs),
                    "cpus_used": a.cpus_used,
                    # control-link bytes: O(refs), never O(data)
                    "ctrl_bytes_sent": a.chan.bytes_sent if a.chan else 0,
                    "ctrl_bytes_received": a.chan.bytes_received if a.chan else 0,
                }
                for a in self.agents
            }

    def shutdown(self, *, drain_s: float = 0.5) -> None:
        self._closed = True
        with self._lock:
            agents = list(self.agents)
        for a in agents:
            a.send(Bye())
        if agents and drain_s > 0:
            # agents answer Bye with a forced final AgentStats flush; keep
            # their sockets open long enough for the per-agent recv threads
            # to fold those last object-plane deltas — closing immediately
            # would systematically drop every run's tail-window transfers
            time.sleep(drain_s)
        for a in agents:
            if a.sock is not None:
                try:
                    a.sock.close()
                except OSError:
                    pass
        try:
            self._server.close()
        except OSError:
            pass
        self.object_server.close()


def maybe_create_manager(results_q, *, local_cpu_budget: float) -> RemoteWorkerManager | None:
    """Driver-side entry: active only when the env contract is present."""
    port = os.environ.get(DRIVER_PORT_ENV)
    if not port:
        return None
    mgr = RemoteWorkerManager(int(port), results_q, local_cpu_budget=local_cpu_budget)
    want = int(os.environ.get(WAIT_NODES_ENV, "0"))
    if want:
        got = mgr.wait_for_agents(want, float(os.environ.get(WAIT_S_ENV, "30")))
        logger.info("engine plane: %d/%d node agents connected", got, want)
    return mgr
