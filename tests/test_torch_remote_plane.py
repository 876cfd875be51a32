"""Port parity: the cross-node plane's wire (``engine/remote_plane.py``), the
object channel (``engine/object_channel.py``) and a loopback agent
(``engine/remote_agent.py``) joining the streaming engine.

- Framing: ``send_frame`` of the same message, token, session id,
  direction and sequence writes the same bytes in both packages (read back
  from a socket pair); a frame with one MAC byte flipped is refused before
  its payload is unpickled (a payload whose unpickling leaves a mark leaves
  none), in both packages; a replayed or reflected frame is refused.
- The frames: every dataclass of ``WIRE_FRAMES`` has the reference's fields
  and defaults, and ``PROTOCOL_VERSION`` is the reference's.
- The handshake: a driver at another ``PROTOCOL_VERSION`` makes
  ``connect_channel`` raise ``ProtocolSkewError`` with the reference's
  message; an agent at another version is dropped by the driver; a frame
  under the wrong token registers no agent; without ``CURATE_ENGINE_TOKEN``
  neither the driver nor an agent starts.
- The object channel: a segment the port put is served by the port's
  ``ObjectServer`` to either package's ``fetch_object`` / ``fetch_value``
  (the request, stream and MAC are the reference's), and the reference's
  server to the port's fetch; a name that is not a segment is denied; a
  wrong token fails the stream.
- A loopback agent (``python -m cosmos_curate_tpu_torch.engine.remote_agent``
  on 127.0.0.1, the driver's port from a socket bound to port 0) joins a
  ``StreamingRunner`` whose driver has 0.1 CPUs: the CPU stages place on
  it, the outputs are the single-host run's, the per-node plan and the
  object plane name it.
"""

from __future__ import annotations

import dataclasses
import os
import queue
import socket
import subprocess
import sys
import threading
import time
from pathlib import Path

import pytest

from cosmos_curate_tpu.engine import object_channel as jchannel
from cosmos_curate_tpu.engine import object_store as jstore
from cosmos_curate_tpu.engine import remote_plane as jplane
from cosmos_curate_tpu_torch.core.pipeline import PipelineConfig, PipelineSpec
from cosmos_curate_tpu_torch.core.stage import StageSpec
from cosmos_curate_tpu_torch.engine import object_channel as tchannel
from cosmos_curate_tpu_torch.engine import object_store as tstore
from cosmos_curate_tpu_torch.engine import remote_agent as tagent
from cosmos_curate_tpu_torch.engine import remote_plane as tplane
from cosmos_curate_tpu_torch.engine.runner import StreamingRunner
from tests.fixtures import engine_stages_torch as ts
from tests.fixtures.ports import free_port

REPO = Path(__file__).resolve().parents[1]
MARKS: list[str] = []



def _wire(plane, token: bytes, sid: bytes, direction: bytes, seq: int, msg) -> bytes:
    a, b = socket.socketpair()
    with a, b:
        n = plane.send_frame(a, token, sid, direction, seq, msg)
        a.shutdown(socket.SHUT_WR)
        data = b.recv(n + 1, socket.MSG_WAITALL)
    assert len(data) == n  # and nothing after the frame
    return data


MESSAGES = {
    "empty-bytes": b"",
    "bytes": bytes(range(256)) * 3,
    "get-request": ("get", "cur123-00ff", b"\x01" * 16),
    "get-request-traced": ("get", "cur123-00ff", b"\x02" * 16, "00-" + "a" * 32 + "-" + "b" * 16 + "-01"),
    "names": ["cur1-a", "cur1-b"],
}


@pytest.mark.parametrize("case", list(MESSAGES), ids=list(MESSAGES))
@pytest.mark.parametrize("token,sid,seq", [(b"secret", b"s" * 32, 0), (b"another-token", os.urandom(32), 7)],
                         ids=["seq0", "seq7"])
def test_send_frame_bytes_match_jax(case, token, sid, seq):
    msg = MESSAGES[case]
    got = _wire(tplane, token, sid, tplane.SecureChannel.A2D, seq, msg)
    assert got == _wire(jplane, token, sid, jplane.SecureChannel.A2D, seq, msg)
    # and either package reads the other's frame back
    a, b = socket.socketpair()
    with a, b:
        a.sendall(got)
        assert jplane.recv_frame(b, token)[1:] == (tplane.SecureChannel.A2D, seq, msg)


def _mark(what: str) -> None:
    MARKS.append(what)


class _Marker:
    """Unpickling it leaves a mark: a frame refused before unpickling
    leaves none."""

    def __reduce__(self):
        return (_mark, ("unpickled",))


@pytest.mark.parametrize("plane", [jplane, tplane], ids=["jax", "torch"])
@pytest.mark.parametrize("where", [12, 20, 43], ids=["mac-first", "mac-mid", "mac-last"])
def test_flipped_mac_is_refused_before_unpickling(plane, where):
    MARKS.clear()
    frame = bytearray(_wire(plane, b"tok", b"s" * 32, plane.SecureChannel.D2A, 0, _Marker()))
    assert MARKS == []
    frame[where] ^= 0x01  # the header is magic (4) | length (8) | mac (32)
    a, b = socket.socketpair()
    with a, b:
        a.sendall(bytes(frame))
        with pytest.raises(ConnectionError, match="authentication"):
            plane.recv_frame(b, b"tok")
    assert MARKS == []
    # the untouched frame does unpickle
    a, b = socket.socketpair()
    with a, b:
        frame[where] ^= 0x01
        a.sendall(bytes(frame))
        plane.recv_frame(b, b"tok")
    assert MARKS == ["unpickled"]


@pytest.mark.parametrize("fault", ["replay", "reflect", "other-session"])
def test_secure_channel_refuses_stale_frames(fault):
    MARKS.clear()
    a, b = socket.socketpair()
    with a, b:
        sid = b"x" * 32
        send = tplane.SecureChannel(a, b"t", sid, tplane.SecureChannel.D2A, tplane.SecureChannel.A2D)
        recv = tplane.SecureChannel(b, b"t", sid, tplane.SecureChannel.A2D, tplane.SecureChannel.D2A)
        send.send("first")
        assert recv.recv() == "first"
        if fault == "replay":
            a.sendall(_wire(tplane, b"t", sid, tplane.SecureChannel.D2A, 0, _Marker()))
        elif fault == "reflect":
            a.sendall(_wire(tplane, b"t", sid, tplane.SecureChannel.A2D, 1, _Marker()))
        else:
            a.sendall(_wire(tplane, b"t", b"y" * 32, tplane.SecureChannel.D2A, 1, _Marker()))
        with pytest.raises(ConnectionError):
            recv.recv()
    assert MARKS == []


@pytest.mark.parametrize("frame", [f.__name__ for f in jplane.WIRE_FRAMES])
def test_wire_frames_match_jax(frame):
    assert [f.__name__ for f in tplane.WIRE_FRAMES] == [f.__name__ for f in jplane.WIRE_FRAMES]
    jf, tf = getattr(jplane, frame), getattr(tplane, frame)

    def fields(cls):
        return [(f.name, f.default if f.default is not dataclasses.MISSING else None) for f in dataclasses.fields(cls)]

    assert fields(tf) == fields(jf)
    assert tplane.PROTOCOL_VERSION == jplane.PROTOCOL_VERSION


def _skewed_driver(server: socket.socket, version: int) -> None:
    sock, _ = server.accept()
    with sock:
        meta, _ = tplane.recv_msg_raw(sock, b"k")
        agent_sid, _, _ = tplane._unpack_meta(meta)
        tplane.send_frame(sock, b"k", os.urandom(16), tplane.SecureChannel.D2A, 0,
                          tplane.HelloAck(agent_sid, protocol_version=version))


def test_skewed_driver_raises_protocol_skew():
    with socket.create_server(("127.0.0.1", 0)) as server:
        t = threading.Thread(target=_skewed_driver, args=(server, tplane.PROTOCOL_VERSION + 1), daemon=True)
        t.start()
        with socket.create_connection(server.getsockname(), timeout=10) as sock:
            with pytest.raises(tplane.ProtocolSkewError) as err:
                tplane.connect_channel(sock, b"k", tplane.Hello("n1", 1.0))
        t.join(timeout=10)
    want = jplane.skew_error(jplane.PROTOCOL_VERSION + 1, peer="driver")
    assert str(err.value) == want == tplane.skew_error(tplane.PROTOCOL_VERSION + 1, peer="driver")
    assert isinstance(err.value, ConnectionError)


def _manager(monkeypatch, token: str = "plane-secret"):
    monkeypatch.setenv("CURATE_ENGINE_TOKEN", token)
    port = free_port()
    return port, tplane.RemoteWorkerManager(port, queue.Queue(), local_cpu_budget=1.0)


@pytest.mark.parametrize("peer", ["skewed-agent", "wrong-token", "good-agent"])
def test_driver_admits_only_authenticated_current_agents(peer, monkeypatch):
    port, mgr = _manager(monkeypatch)
    try:
        with socket.create_connection(("127.0.0.1", port), timeout=10) as sock:
            if peer == "wrong-token":
                tplane.send_frame(sock, b"not-the-secret", b"s" * 16, tplane.SecureChannel.A2D, 0,
                                  tplane.Hello("n1", 2.0))
                with pytest.raises(ConnectionError):
                    tplane.recv_msg_raw(sock, b"plane-secret")
            else:
                hello = tplane.Hello("n1", 2.0, protocol_version=1 if peer == "skewed-agent" else
                                     tplane.PROTOCOL_VERSION)
                chan, ack = tplane.connect_channel(sock, b"plane-secret", hello)
                assert ack.driver_object_port == mgr.object_server.port
            time.sleep(0.3)
            want = [("n1", 2.0, 0.0)] if peer == "good-agent" else []
            assert mgr.node_budgets() == want
    finally:
        mgr.shutdown(drain_s=0)


def test_plane_refuses_without_token(monkeypatch):
    monkeypatch.delenv("CURATE_ENGINE_TOKEN", raising=False)
    monkeypatch.setenv("CURATE_ENGINE_DRIVER_PORT", str(free_port()))
    errors = []
    for make in (lambda: tplane.maybe_create_manager(queue.Queue(), local_cpu_budget=1.0),
                 lambda: jplane.maybe_create_manager(queue.Queue(), local_cpu_budget=1.0),
                 lambda: tagent.NodeAgent("127.0.0.1:1")):
        with pytest.raises(RuntimeError, match="CURATE_ENGINE_TOKEN") as err:
            make()
        errors.append(str(err.value))
    assert errors[0] == errors[1] == errors[2]
    monkeypatch.delenv("CURATE_ENGINE_DRIVER_PORT")
    assert tplane.maybe_create_manager(queue.Queue(), local_cpu_budget=1.0) is None


# -- the object channel ----------------------------------------------------------


@pytest.fixture
def segment(monkeypatch):
    import numpy as np

    monkeypatch.setenv("CURATE_STORE_OWNER", str(os.getpid()))
    value = {"frames": np.arange(3 * 64 * 64, dtype=np.uint8).reshape(3, 64, 64), "name": "clip", "n": 7}
    ref = tstore.put(value)
    yield ref, value
    tstore.delete(ref)


def _same(a, b) -> bool:
    import numpy as np

    return a.keys() == b.keys() and all(np.array_equal(a[k], b[k]) if isinstance(a[k], np.ndarray) else a[k] == b[k]
                                        for k in a)


@pytest.mark.parametrize("server_pkg,fetch_pkg", [("torch", "torch"), ("torch", "jax"), ("jax", "torch")])
def test_object_channel_matches_jax(segment, server_pkg, fetch_pkg):
    ref, value = segment
    server = (tchannel if server_pkg == "torch" else jchannel).ObjectServer(b"chan-secret", host="127.0.0.1")
    channel, store = (tchannel, tstore) if fetch_pkg == "torch" else (jchannel, jstore)
    try:
        addr = ("127.0.0.1", server.port)
        fref = store.ObjectRef(ref.shm_name, ref.total_size, ref.num_buffers)
        assert _same(channel.fetch_value(addr, b"chan-secret", fref), value)
        copy = channel.fetch_object(addr, b"chan-secret", fref)
        try:
            assert copy.shm_name != ref.shm_name and copy.total_size == ref.total_size
            assert _same(tstore.get(tstore.ObjectRef(copy.shm_name, copy.total_size, copy.num_buffers)), value)
        finally:
            store.delete(copy)
        with pytest.raises(FileNotFoundError):
            channel.fetch_value(addr, b"chan-secret", store.ObjectRef("cur1-0123abcd", 8, 0))
        with pytest.raises(ConnectionError, match="denied"):
            channel.fetch_value(addr, b"chan-secret", store.ObjectRef("../etc/passwd", 8, 0))
        with pytest.raises(ConnectionError):
            channel.fetch_value(addr, b"wrong-secret", fref)
        assert server.gets_served == 2
    finally:
        server.close()


def test_truncated_transfer_leaves_no_segment(tmp_path, monkeypatch):
    monkeypatch.setenv("CURATE_STORE_OWNER", str(os.getpid()))
    before = set(os.listdir("/dev/shm"))
    with pytest.raises(ConnectionError, match="truncated"):
        tstore.put_raw_chunks([b"abc"], 10, 0)
    assert set(os.listdir("/dev/shm")) == before
    ref = tstore.put_raw_chunks([b"abc", b"defg"], 7, 0)
    try:
        assert tstore.valid_segment_name(ref.shm_name) and Path(tstore.segment_path(ref.shm_name)).read_bytes() == \
            b"abcdefg"
        assert not tstore.valid_segment_name("cur1-xyz/../a") and tstore.valid_segment_name("cur1-00ff")
    finally:
        tstore.delete(ref)


# -- the loopback plane --------------------------------------------------------------


def test_loopback_agent_joins_the_streaming_runner(monkeypatch, tmp_path):
    port = free_port()
    for k, v in {"CURATE_ENGINE_TOKEN": "loop-secret", "CURATE_ENGINE_DRIVER_PORT": str(port),
                 "CURATE_ENGINE_WAIT_NODES": "1", "CURATE_ENGINE_WAIT_S": "60", "CURATE_PREWARM": "0",
                 "CURATE_DLQ_DIR": str(tmp_path / "dlq")}.items():
        monkeypatch.setenv(k, v)
    monkeypatch.delenv("CURATE_RUNNER", raising=False)
    agent = subprocess.Popen([sys.executable, "-m", "cosmos_curate_tpu_torch.engine.remote_agent", "--driver",
                              f"127.0.0.1:{port}", "--node-id", "agent-a", "--num-cpus", "4"],
                             env={**os.environ, "PYTHONPATH": str(REPO)}, cwd=REPO, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True)
    try:
        runner = StreamingRunner(poll_interval_s=0.01)
        tasks = [ts.Item(value=i) for i in range(16)]
        stages = [StageSpec(ts.NodeStampStage(0.1), num_workers=2), StageSpec(ts.AddStage(3), num_workers=1)]
        out = runner.run(PipelineSpec(input_data=tasks, stages=stages,
                                      config=PipelineConfig(num_cpus=0.1, return_last_stage_outputs=True)))
        log, _ = agent.communicate(timeout=60)
        assert agent.returncode == 0, log[-3000:]
    finally:
        if agent.poll() is None:
            agent.kill()
            agent.communicate(timeout=30)
    assert sorted(t.value for t in out) == [i + 4 for i in range(16)]
    assert {t.trail[0] for t in out} == {"agent-a"}  # every batch of stage 0 ran on the agent
    assert runner.node_plan == {"NodeStampStage": {"agent-a": 2}, "AddStage": {"agent-a": 1}}
    assert runner.remote_stats["agent-a"]["workers"] == 3 and len(runner.worker_ready_s) == 3
    assert "agent-a" in runner.object_plane and runner.stage_counts["AddStage"]["completed"] == 16
    assert all(c["dead_lettered"] == 0 for c in runner.stage_counts.values())
