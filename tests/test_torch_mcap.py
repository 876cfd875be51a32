"""Port parity: the SDK-free MCAP reader and writer (``sensors/mcap.py``) and
the MCAP camera sensor with its capture (``sensors/mcap_camera_sensor.py``).

Both ways: the port's writer gives the JAX writer's bytes for the same
calls, and each package's reader reads the other's file to the same
summary, messages, metadata and timelines. The reference's cases
(``tests/pipelines/test_mcap.py``) run through both packages: round trips
with and without zstd, time windows (start inclusive, end exclusive), chunk
index skipping, metadata helpers, reverse order, the summary scan of a file
without a footer, the bad magic, the camera sensor and burst captures. A
hand-built ``lz4`` chunk raises ``McapError`` in both where ``lz4`` is
absent, as do unknown codecs, CRC mismatches and truncated records. Bars:
bytes, integers, uint8 frames and int64 timestamps equal.
"""

import dataclasses
import io
import struct
import sys
import zlib

import numpy as np
import pytest

from cosmos_curate_tpu.sensors import mcap as jm
from cosmos_curate_tpu.sensors import mcap_camera_sensor as jcam
from cosmos_curate_tpu.sensors import sampling as jsamp
from cosmos_curate_tpu_torch.sensors import mcap as tm
from cosmos_curate_tpu_torch.sensors import mcap_camera_sensor as tcam
from cosmos_curate_tpu_torch.sensors import sampling as tsamp
from tests.fixtures.media import make_scene_video

PACKAGES = {"jax": (jm, jcam, jsamp), "torch": (tm, tcam, tsamp)}


def plain(obj):
    """A record of either package as plain data (class name kept), for
    comparing across packages."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return (type(obj).__name__, {f.name: plain(getattr(obj, f.name)) for f in dataclasses.fields(obj)})
    if isinstance(obj, dict):
        return {k: plain(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [plain(v) for v in obj]
    if isinstance(obj, np.ndarray):
        return ("ndarray", str(obj.dtype), obj.shape, obj.tobytes())
    return obj


def build(mod, compression: str = "zstd", chunk_size: int = 4 << 20) -> bytes:
    """The reference test's capture: two channels, one schema, a metadata
    record."""
    buf = io.BytesIO()
    with mod.McapWriter(buf, compression=compression, chunk_size=chunk_size) as w:
        sid = w.register_schema("frame", "none", b"")
        cam = w.register_channel("/camera/rgb", "rgb8", sid, {"width": "4", "height": "2"})
        imu = w.register_channel("/imu", "jsonl", sid)
        for i in range(50):
            w.add_message(cam, 1000 + i * 10, bytes([i]) * 24)
            if i % 5 == 0:
                w.add_message(imu, 1001 + i * 10, b"{}")
        w.add_metadata("session.info", {"vehicle": "v1", "run": "42"})
    return buf.getvalue()


def build_rich(mod, compression: str, chunk_size: int) -> bytes:
    """Every writer call: two schemas, channels with and without metadata,
    out-of-order log times, publish times and sequences, metadata records
    between chunks, an explicit flush, the profile and library strings."""
    buf = io.BytesIO()
    w = mod.McapWriter(buf, profile="ros2", library="rig-capture 1.0", compression=compression,
                       chunk_size=chunk_size)
    s1 = w.register_schema("sensor_msgs/Image", "ros2msg", b"uint32 height\nuint32 width\n")
    s2 = w.register_schema("gps", "jsonschema", b'{"type": "object"}')
    a = w.register_channel("/front", "rgb8", s1, {"width": "3", "height": "2", "frame_id": "front"})
    b = w.register_channel("/gps", "json", s2)
    c = w.register_channel("/raw", "bytes")
    rng = np.random.default_rng(0)
    for i in range(40):
        w.add_message(a, 5_000 + 33 * i + int(rng.integers(0, 3)), rng.integers(0, 256, 18, np.uint8).tobytes(),
                      publish_time=6_000 + i, sequence=i)
        if i % 3 == 0:
            w.add_message(b, 4_990 + 100 * (i // 3), b'{"lat": %d}' % i, sequence=i // 3)
        if i == 20:
            w.add_metadata("calibration", {"fx": "1000.5", "note": "été"})
            w.flush_chunk()
    w.add_message(c, 1, b"")  # the earliest message, last
    w.add_metadata("cosmos_curate.video_metadata.v1", {"num_frames": "40"})
    w.finish()
    w.finish()  # idempotent
    return buf.getvalue()


def read_all(mod, data: bytes) -> dict:
    r = mod.make_reader(io.BytesIO(data))
    summary = r.get_summary()
    out = {"summary": plain(summary), "metadata": plain(list(r.iter_metadata()))}
    for topics in (None, "/front", ["/gps", "/raw"], "/camera/rgb", "/imu"):
        key = str(topics)
        out[key, "times"] = list(r.iter_message_times(topics=topics))
        for start, end in ((None, None), (5_000, 5_500), (1_100, 1_200), (1_400, 1_450), (0, 2)):
            for order, reverse in ((True, False), (True, True), (False, False), (False, True)):
                out[key, start, end, order, reverse] = plain(list(r.iter_messages(
                    topics, start, end, log_time_order=order, reverse=reverse)))
    for topic in ("/front", "/gps", "/camera/rgb", "/imu", "/nope"):
        out[topic, "channel"] = plain(mod.channel_for_topic(summary, topic))
        try:
            out[topic, "timeline"] = plain(mod.load_timeline(r, topic)), mod.load_start_end_ns(r, topic)
        except mod.McapError as e:
            out[topic, "timeline"] = ("McapError", str(e))
    for name in ("calibration", "session.info", "missing.record"):
        try:
            out[name] = mod.get_metadata_record(r, name)
        except mod.McapError as e:
            out[name] = ("McapError", str(e))
    return out


@pytest.mark.parametrize("compression", ["", "none", "zstd"])
@pytest.mark.parametrize("chunk_size", [256, 4 << 20])
def test_the_writer_writes_the_references_bytes(compression, chunk_size):
    assert build(tm, compression, chunk_size) == build(jm, compression, chunk_size)
    assert build_rich(tm, compression, chunk_size) == build_rich(jm, compression, chunk_size)


@pytest.mark.parametrize("capture", ["reference", "rich"])
@pytest.mark.parametrize("compression", ["", "zstd"])
@pytest.mark.parametrize("chunk_size", [256, 4 << 20])
def test_each_reader_reads_the_others_file(capture, compression, chunk_size):
    make = build if capture == "reference" else build_rich
    files = {name: make(mods[0], compression, chunk_size) for name, mods in PACKAGES.items()}
    reads = {(reader, writer): read_all(PACKAGES[reader][0], data)
             for reader in PACKAGES for writer, data in files.items()}
    want = reads["jax", "jax"]
    for key, got in reads.items():
        assert got == want, key
    if capture == "reference":
        msgs = want["/camera/rgb", None, None, True, False]
        assert len(msgs) == 50 and want["summary"][1]["statistics"][1]["message_count"] == 60
        assert [m[1]["log_time"] for _, _, m in want["/camera/rgb", 1_100, 1_200, True, False]] == \
            [1100 + 10 * i for i in range(10)]
        assert want["session.info"] == {"vehicle": "v1", "run": "42"}
        assert want["/camera/rgb", "timeline"][1] == (1000, 1490)
        if chunk_size == 256:
            assert len(want["summary"][1]["chunk_indexes"]) > 3


def test_the_summary_scan_without_a_footer():
    """A file cut before its summary still yields its channels and schemas
    through the data-section scan."""
    data = build(jm)
    cut = data[: data.rindex(b"\x0f")]
    got = {name: plain(mods[0].McapReader(io.BytesIO(cut)).get_summary()) for name, mods in PACKAGES.items()}
    assert got["torch"] == got["jax"]
    assert {c[1]["topic"] for c in got["torch"][1]["channels"].values()} == {"/camera/rgb", "/imu"}
    msgs = {name: plain(list(mods[0].McapReader(io.BytesIO(cut)).iter_messages("/imu")))
            for name, mods in PACKAGES.items()}
    assert msgs["torch"] == msgs["jax"] and len(msgs["torch"]) == 10


def raises_alike(fn) -> str:
    """``fn(package)`` raises ``McapError`` with one message in both."""
    messages = []
    for mods in PACKAGES.values():
        with pytest.raises(mods[0].McapError) as e:
            fn(mods[0])
        messages.append(str(e.value))
    assert messages[0] == messages[1]
    return messages[0]


def chunked_file(compression: str, payload: bytes, uncompressed: bytes, crc: int | None = None) -> bytes:
    """A minimal MCAP file whose data section is one hand-built chunk of
    ``compression`` holding ``payload``."""
    rec = lambda op, content: bytes([op]) + struct.pack("<Q", len(content)) + content  # noqa: E731
    string = lambda s: struct.pack("<I", len(s)) + s.encode()  # noqa: E731
    chunk = (struct.pack("<QQQI", 0, 0, len(uncompressed), zlib.crc32(uncompressed) if crc is None else crc)
             + string(compression) + struct.pack("<Q", len(payload)) + payload)
    return (jm.MAGIC + rec(jm.OP_HEADER, string("") + string("hand"))
            + rec(jm.OP_CHUNK, chunk) + rec(jm.OP_DATA_END, struct.pack("<I", 0)))


def inner_records() -> bytes:
    rec = lambda op, content: bytes([op]) + struct.pack("<Q", len(content)) + content  # noqa: E731
    string = lambda s: struct.pack("<I", len(s)) + s.encode()  # noqa: E731
    channel = struct.pack("<HH", 0, 0) + string("/camera/rgb") + string("rgb8") + struct.pack("<I", 0)
    message = struct.pack("<HIQQ", 0, 0, 7, 7) + b"\x01\x02"
    return rec(jm.OP_CHANNEL, channel) + rec(jm.OP_MESSAGE, message)


def test_an_lz4_chunk_raises_where_lz4_is_absent(monkeypatch):
    monkeypatch.setitem(sys.modules, "lz4", None)
    monkeypatch.setitem(sys.modules, "lz4.frame", None)
    data = chunked_file("lz4", b"\x04\x22\x4d\x18not-really-lz4", inner_records())
    for call in (lambda mod: list(mod.make_reader(io.BytesIO(data)).iter_messages()),
                 lambda mod: mod.McapReader(io.BytesIO(data)).get_summary(),
                 lambda mod: list(mod.make_reader(io.BytesIO(data)).iter_message_times())):
        assert raises_alike(call) == "lz4-compressed MCAP chunk but lz4 is not installed"


def test_unknown_codecs_crcs_and_truncation_raise_alike():
    inner = inner_records()
    assert "unknown MCAP chunk compression 'brotli'" in raises_alike(
        lambda mod: list(mod.make_reader(io.BytesIO(chunked_file("brotli", inner, inner))).iter_messages()))
    assert raises_alike(lambda mod: list(mod.make_reader(io.BytesIO(chunked_file("", inner, inner, crc=1)))
                                         .iter_messages())) == "MCAP chunk CRC mismatch"
    # a CRC of 0 means "not computed": the chunk reads
    for mods in PACKAGES.values():
        msgs = list(mods[0].make_reader(io.BytesIO(chunked_file("", inner, inner, crc=0))).iter_messages())
        assert [(c.topic, m.log_time, m.data) for _, c, m in msgs] == [("/camera/rgb", 7, b"\x01\x02")]
    data = build(jm, "")
    assert "truncated record" in raises_alike(lambda mod: list(mod.make_reader(io.BytesIO(data[:200]))
                                                               .iter_messages()))
    assert raises_alike(lambda mod: mod.McapReader(io.BytesIO(b"not an mcap file at all"))) == \
        "not an MCAP file (bad leading magic)"

    def lz4_writer(mod):
        w = mod.McapWriter(io.BytesIO(), compression="lz4")
        w.register_channel("/x", "bytes")
        w.flush_chunk()

    assert raises_alike(lz4_writer) == "unsupported writer compression 'lz4'"
    assert raises_alike(lambda mod: mod.McapWriter(io.BytesIO()).add_message(3, 0, b"")) == "unknown channel id 3"


def test_a_reader_keeps_the_channel_topic_check():
    buf = io.BytesIO()
    with tm.McapWriter(buf) as w:
        w.register_channel("/camera/rgb", "rgb8")
        w.register_channel("/camera/rgb", "rgb8")
    data = buf.getvalue()
    assert "expected exactly one MCAP channel" in raises_alike(
        lambda mod: mod.channel_for_topic(mod.make_reader(io.BytesIO(data)).get_summary(), "/camera/rgb"))


# -- the camera sensor over MCAP --------------------------------------------------


def sample_all(sensor, samp, tolerance_ns=None, **grid):
    policy = None if tolerance_ns is None else samp.SamplingPolicy(tolerance_ns)
    spec = samp.SamplingSpec(grid=samp.SamplingGrid.from_rate(**grid), policy=policy)
    return [plain(b) for b in sensor.sample(spec)]


@pytest.mark.parametrize("compression", ["none", "zstd"])
@pytest.mark.parametrize("resize_hw", [None, (32, 48)])
def test_capture_and_sample_match(compression, resize_hw, tmp_path):
    video = make_scene_video(tmp_path / "cap.mp4", num_scenes=2, scene_len_frames=12)
    files, samples = {}, {}
    for name, (mod, cam, samp) in PACKAGES.items():
        path = tmp_path / f"{name}.mcap"
        n = cam.make_mcap_from_video(video, path, compression=compression, resize_hw=resize_hw, start_ns=123)
        assert n == 24
        files[name] = path.read_bytes()
        with cam.McapCameraSensor(path) as sensor:
            assert (sensor.width, sensor.height) == ((48, 32) if resize_hw else (96, 64))
            start = sensor.start_ns
            samples[name] = (sensor.video_metadata, plain(sensor.timestamps_ns),
                             sample_all(sensor, samp, start_ns=start, sample_rate_hz=12.0,
                                        exclusive_end_ns=sensor.end_ns + 1, window_size=6),
                             sample_all(sensor, samp, start_ns=start - 10**8, sample_rate_hz=30.0,
                                        end_ns=sensor.end_ns + 10**8, window_size=8))
    assert files["torch"] == files["jax"]
    assert samples["torch"] == samples["jax"]
    meta, _, half_rate, _ = samples["torch"]
    assert meta["num_frames"] == "24" and meta["source"] == video
    first = half_rate[0][1]
    assert first["frames"][1:3] == ("uint8", (6, 32, 48, 3) if resize_hw else (6, 64, 96, 3))
    assert np.frombuffer(first["frame_indices"][3], np.int64)[:3].tolist() == [0, 2, 4]


def test_each_sensor_reads_the_others_capture(tmp_path):
    video = make_scene_video(tmp_path / "cap.mp4", num_scenes=1, scene_len_frames=10)
    jcam.make_mcap_from_video(video, tmp_path / "j.mcap")
    tcam.make_mcap_from_video(video, tmp_path / "t.mcap")
    got = {}
    for reader, (_, cam, samp) in PACKAGES.items():
        for writer in ("j", "t"):
            with cam.McapCameraSensor(tmp_path / f"{writer}.mcap") as sensor:
                got[reader, writer] = sample_all(sensor, samp, start_ns=0, sample_rate_hz=24.0,
                                                 end_ns=sensor.end_ns, window_size=4, tolerance_ns=1000)
    assert len({str(v) for v in got.values()}) == 1


def test_burst_captures_keep_both_payloads(tmp_path):
    """Two frames sharing one log_time both surface with their own
    payloads, in both packages."""
    got = {}
    for name, (mod, cam, samp) in PACKAGES.items():
        buf = io.BytesIO()
        with mod.McapWriter(buf) as w:
            cid = w.register_channel("/camera/rgb", "rgb8", 0, {"width": "2", "height": "1"})
            w.add_message(cid, 1_000, bytes([1] * 6))
            w.add_message(cid, 1_000, bytes([2] * 6))
            w.add_message(cid, 2_000, bytes([3] * 6))
            w.add_metadata("cosmos_curate.video_metadata.v1", {"num_frames": "3"})
        path = tmp_path / f"{name}.mcap"
        path.write_bytes(buf.getvalue())
        sensor = cam.McapCameraSensor(path)
        assert list(sensor.timestamps_ns) == [1_000, 1_000, 2_000]
        (batch,) = list(sensor.sample(samp.SamplingSpec(grid=samp.SamplingGrid.from_rate(
            1_000, sample_rate_hz=1e9 / 500, exclusive_end_ns=2_001, window_size=8))))
        sensor.close()
        got[name] = plain(batch)
        assert 1 in batch.frames.reshape(len(batch), -1)[:, 0] and 2 in batch.frames.reshape(len(batch), -1)[:, 0]
    assert got["torch"] == got["jax"]


@pytest.mark.parametrize("case", ["no_topic", "not_rgb8", "no_size", "zero_size", "no_metadata_record"])
def test_sensor_refusals_match(case, tmp_path):
    buf = io.BytesIO()
    with jm.McapWriter(buf) as w:
        encoding, meta = {"not_rgb8": ("jpeg", {"width": "2", "height": "1"}), "no_size": ("rgb8", {"width": "2"}),
                          "zero_size": ("rgb8", {"width": "0", "height": "1"})}.get(case,
                                                                                     ("rgb8", {"width": "2",
                                                                                               "height": "1"}))
        cid = w.register_channel("/other" if case == "no_topic" else "/camera/rgb", encoding, 0, meta)
        w.add_message(cid, 5, bytes(6))
    path = tmp_path / "x.mcap"
    path.write_bytes(buf.getvalue())
    if case == "no_metadata_record":
        assert raises_alike(lambda mod: PACKAGES["jax" if mod is jm else "torch"][1].McapCameraSensor(path)
                            .video_metadata) == \
            "required MCAP metadata record 'cosmos_curate.video_metadata.v1' not found"
    else:
        raises_alike(lambda mod: PACKAGES["jax" if mod is jm else "torch"][1].McapCameraSensor(path))
