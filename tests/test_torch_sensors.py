"""Port parity: the sensor rigs (``sensors/``: validation, sampling, the data
model and alignment, the video index, the camera, image and MCAP camera
sensors, the sensor group) and ``video.decode.decode_frame_ids``.

The reference's cases (``tests/pipelines/test_sensor_sampling.py``,
``test_sensor_group.py`` and ``test_av_and_sensors.py::TestSensors``) run
through both packages on the same inputs, and their outputs are compared:
integers, int64 timestamps and uint8 frames equal, errors of one type with
one message. A ``hypothesis`` property holds ``make_ts_grid``,
``find_closest_indices`` and ``sample_window_indices`` equal across the
packages on random strictly increasing int64 timestamps and policies. The
slice as a whole: a three-camera rig of ``make_scene_video`` videos, one
camera cut short, through ``make_mcap_from_video``, ``SensorGroup.sample``
over ``McapCameraSensor`` and ``CameraSensor`` and ``align`` over its frame
refs gives the same batches in both packages.
"""

import dataclasses
import json
import math
from pathlib import Path

import cv2
import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from cosmos_curate_tpu.sensors import alignment as jalign
from cosmos_curate_tpu.sensors import camera_sensor as jcamera
from cosmos_curate_tpu.sensors import data as jdata
from cosmos_curate_tpu.sensors import group as jgroup
from cosmos_curate_tpu.sensors import image_sensor as jimage
from cosmos_curate_tpu.sensors import mcap_camera_sensor as jmcam
from cosmos_curate_tpu.sensors import sampling as jsamp
from cosmos_curate_tpu.sensors import validation as jval
from cosmos_curate_tpu.sensors import video_index as jvidx
from cosmos_curate_tpu.video import decode as jdecode
from cosmos_curate_tpu_torch.sensors import alignment as talign
from cosmos_curate_tpu_torch.sensors import camera_sensor as tcamera
from cosmos_curate_tpu_torch.sensors import data as tdata
from cosmos_curate_tpu_torch.sensors import group as tgroup
from cosmos_curate_tpu_torch.sensors import image_sensor as timage
from cosmos_curate_tpu_torch.sensors import mcap_camera_sensor as tmcam
from cosmos_curate_tpu_torch.sensors import sampling as tsamp
from cosmos_curate_tpu_torch.sensors import validation as tval
from cosmos_curate_tpu_torch.sensors import video_index as tvidx
from cosmos_curate_tpu_torch.video import decode as tdecode
from tests.fixtures.media import make_scene_video

NS = tsamp.NS


def plain(obj):
    """A value of either package as plain data (class names kept, arrays as
    dtype, shape, bytes and the writeable flag)."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return (type(obj).__name__, {f.name: plain(getattr(obj, f.name)) for f in dataclasses.fields(obj)})
    if isinstance(obj, dict):
        return {k: plain(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [plain(v) for v in obj]
    if isinstance(obj, np.ndarray):
        return ("ndarray", str(obj.dtype), obj.shape, obj.tobytes(), obj.flags.writeable)
    if isinstance(obj, np.generic):
        return ("scalar", str(obj.dtype), obj.item())
    return obj


def outcome(fn, *args, **kw):
    """``fn``'s result as plain data, or its error's type name and message."""
    try:
        return "ok", plain(fn(*args, **kw))
    except Exception as e:  # noqa: BLE001  (the error itself is the outcome compared)
        return type(e).__name__, str(e)


def same(jfn, tfn, *args, **kw):
    want = outcome(jfn, *args, **kw)
    assert outcome(tfn, *args, **kw) == want
    return want


# -- validation ----------------------------------------------------------------------


@pytest.mark.parametrize("name", ["require_1d", "require_finite", "require_strictly_increasing",
                                  "require_nondecreasing", "strictly_increasing_int64"])
@pytest.mark.parametrize("values", [[1, 2, 3], [1, 2, 2], [3, 1], [[1, 2]], [1.0, np.nan], [1.0, np.inf, 2.0], [],
                                    [5], np.array([1, 5, 9], np.int32)])
def test_validation_matches(name, values):
    same(getattr(jval, name), getattr(tval, name), "ts", values)


@pytest.mark.parametrize("dtype", [np.int64, np.float32, None])
def test_require_1d_dtype_matches(dtype):
    for values in (np.arange(4, dtype=np.int64), np.arange(4, dtype=np.float32), np.zeros((2, 2))):
        same(jval.require_1d, tval.require_1d, "ts", values, dtype)


# -- sampling -----------------------------------------------------------------------


GRID_CASES = [
    dict(start_ns=0, end_ns=NS, sample_rate_hz=4.0),
    dict(start_ns=0, sample_rate_hz=4.0, exclusive_end_ns=NS),
    dict(start_ns=0, end_ns=int(0.3 * NS), sample_rate_hz=4.0),
    dict(start_ns=1_700_000_000_123_456_789, end_ns=1_700_000_004_000_000_000, sample_rate_hz=24.0),
    dict(start_ns=5, end_ns=5, sample_rate_hz=10.0),
    dict(start_ns=0, end_ns=30, sample_rate_hz=1e9 / 3),
    dict(start_ns=0, end_ns=10, sample_rate_hz=3e9),  # rounds to a non-increasing grid
    dict(start_ns=0, end_ns=NS, sample_rate_hz=0),
    dict(start_ns=0, end_ns=NS, sample_rate_hz=2.0, exclusive_end_ns=NS),
    dict(start_ns=0, sample_rate_hz=2.0),
    dict(start_ns=NS, end_ns=0, sample_rate_hz=2.0),
    dict(start_ns=NS, sample_rate_hz=2.0, exclusive_end_ns=NS),
]


@pytest.mark.parametrize("case", GRID_CASES, ids=range(len(GRID_CASES)))
def test_make_ts_grid_matches(case):
    kw = dict(case)
    start = kw.pop("start_ns")
    end = kw.pop("end_ns", None)
    rate = kw.pop("sample_rate_hz")
    status, got = same(jsamp.make_ts_grid, tsamp.make_ts_grid, start, end, rate, **kw)
    if status == "ok" and start == 0 and rate == 4.0:
        _, excl, ts = tsamp.make_ts_grid(start, end, rate, **kw)
        assert ts[0] == 0 and ts[-1] < excl and not ts.flags.writeable


@pytest.mark.parametrize("window_size", [1, 4, 64])
@pytest.mark.parametrize("bounds", [dict(end_ns=NS), dict(exclusive_end_ns=NS), dict(end_ns=7 * NS // 3)])
def test_sampling_grid_windows_match(window_size, bounds):
    grids = [mod.SamplingGrid.from_rate(0, sample_rate_hz=10.0, window_size=window_size, **bounds)
             for mod in (jsamp, tsamp)]
    assert plain(grids[1]) == plain(grids[0])
    assert len(grids[1]) == len(grids[0])
    windows = [plain(list(g)) for g in grids]
    assert windows[1] == windows[0]
    ws = list(grids[1])
    assert sum(len(w) for w in ws) == len(grids[1].timestamps_ns)
    for a, b in zip(ws, ws[1:]):
        assert a.exclusive_end_ns == b.timestamps_ns[0]
    assert ws[-1].exclusive_end_ns == grids[1].exclusive_end_ns


def test_an_empty_grid_yields_one_empty_window():
    grids = [mod.SamplingGrid(0, 10, np.zeros(0, np.int64), 4) for mod in (jsamp, tsamp)]
    assert plain(list(grids[1])) == plain(list(grids[0])) and len(grids[1]) == len(grids[0]) == 1


def test_policy_refuses_a_negative_tolerance():
    same(jsamp.SamplingPolicy, tsamp.SamplingPolicy, -1)
    same(jsamp.SamplingPolicy, tsamp.SamplingPolicy, 0)


@pytest.mark.parametrize("canonical,grid,end,tolerance", [
    ([0, 100, 200, 300], [10, 149, 151, 290], 400, None),
    ([0, 1000], [0, 10, 20, 990], 2000, None),
    ([0, 1000], [0, 400, 990], 2000, 50),
    ([100], [99, 100], 200, 0),
    ([100], [99, 100], 200, None),
    ([0, 100, 200], [50, 150], 300, None),  # exact midpoints choose the left
    ([], [1, 2], 3, None),
    ([5, 9], [], 3, None),
])
def test_closest_and_window_indices_match(canonical, grid, end, tolerance):
    c, g = np.asarray(canonical, np.int64), np.asarray(grid, np.int64)
    if len(c) and len(g):
        same(jsamp.find_closest_indices, tsamp.find_closest_indices, c, g)
    pols = [None if tolerance is None else mod.SamplingPolicy(tolerance) for mod in (jsamp, tsamp)]
    want = plain(jsamp.sample_window_indices(c, jsamp.SamplingWindow(g, end), policy=pols[0]))
    assert plain(tsamp.sample_window_indices(c, tsamp.SamplingWindow(g, end), policy=pols[1])) == want


@st.composite
def timelines(draw):
    start = draw(st.integers(-10**15, 10**15))
    gaps = draw(st.lists(st.integers(1, 10**9), min_size=1, max_size=40))
    canonical = np.cumsum(np.asarray([start] + gaps, np.int64))
    lo, hi = int(canonical[0]), int(canonical[-1])
    rate = draw(st.sampled_from([0.5, 1.0, 3.0, 10.0, 24.0, 29.97, 30.0, 100.0, 1000.0]))
    grid_start = draw(st.integers(lo - 10**9, hi))
    grid_span = draw(st.integers(0, 4 * 10**9))
    exclusive = draw(st.booleans())
    tolerance = draw(st.one_of(st.none(), st.integers(0, 10**9)))
    window = draw(st.integers(1, 80))
    return canonical, grid_start, grid_span, rate, exclusive, tolerance, window


@settings(max_examples=200, deadline=None, derandomize=True)
@given(timelines())
def test_sampling_agrees_on_random_timelines(case):
    canonical, start, span, rate, exclusive, tolerance, window = case
    kw = dict(exclusive_end_ns=start + span + 1) if exclusive else dict(end_ns=start + span)
    status, grid = same(jsamp.make_ts_grid, tsamp.make_ts_grid, start, sample_rate_hz=rate, **kw)
    if status != "ok":
        return
    grids = [mod.SamplingGrid.from_rate(start, sample_rate_hz=rate, window_size=window, **kw)
             for mod in (jsamp, tsamp)]
    ts = grids[1].timestamps_ns
    assert ts.dtype == np.int64 and ts[0] == start and np.all(np.diff(ts) > 0)
    same(jsamp.find_closest_indices, tsamp.find_closest_indices, canonical, ts)
    pols = [None if tolerance is None else mod.SamplingPolicy(tolerance) for mod in (jsamp, tsamp)]
    for jw, tw in zip(grids[0], grids[1], strict=True):
        assert plain(tw) == plain(jw)
        want = plain(jsamp.sample_window_indices(canonical, jw, policy=pols[0]))
        assert plain(tsamp.sample_window_indices(canonical, tw, policy=pols[1])) == want


# -- decode_frame_ids -------------------------------------------------------------------


@pytest.fixture(scope="module")
def scene_video(tmp_path_factory):
    return make_scene_video(tmp_path_factory.mktemp("sensors") / "cam.mp4", num_scenes=2, scene_len_frames=12)


@pytest.mark.parametrize("ids", [[0], [5, 1, 5, 3], list(range(24)), [22, 23, 24, 40], [30], []])
@pytest.mark.parametrize("resize_hw", [None, (32, 40)])
def test_decode_frame_ids_matches(ids, resize_hw, scene_video):
    got = tdecode.decode_frame_ids(scene_video, ids, resize_hw=resize_hw)
    want = jdecode.decode_frame_ids(scene_video, ids, resize_hw=resize_hw)
    assert plain(got) == plain(want)
    present = [i for i in sorted(set(ids)) if i < 24]
    assert len(got) == len(present)
    if present:
        full = tdecode.decode_frames(scene_video, resize_hw=resize_hw)
        np.testing.assert_array_equal(got, full[present])


def test_decode_frame_ids_from_bytes(scene_video):
    data = Path(scene_video).read_bytes()
    np.testing.assert_array_equal(tdecode.decode_frame_ids(data, [3, 7]), jdecode.decode_frame_ids(data, [3, 7]))


# -- the camera sensor ----------------------------------------------------------------------


def camera_pair(video: str, n: int, camera: str = "front", **kw):
    return [mod.CameraSensor(camera, [data.CameraFrameRef(camera, str(video), i, i / 24.0) for i in range(n)], **kw)
            for mod, data in ((jcamera, jdata), (tcamera, tdata))]


def sample_both(pair, grid_kw, tolerance=None):
    out = []
    for sensor, samp in zip(pair, (jsamp, tsamp), strict=True):
        grid = samp.SamplingGrid.from_rate(**grid_kw)
        policy = None if tolerance is None else samp.SamplingPolicy(tolerance_ns=tolerance)
        out.append([plain(b) for b in sensor.sample(samp.SamplingSpec(grid, policy))])
    assert out[1] == out[0]
    return out[1]


def test_camera_index_properties_match(scene_video):
    j, t = camera_pair(scene_video, 24)
    for prop in ("timestamps_ns", "start_ns", "end_ns", "max_gap_ns"):
        assert plain(getattr(t, prop)) == plain(getattr(j, prop))
    assert t.start_ns == 0 and t.end_ns == round(23 / 24.0 * NS)
    assert t.max_gap_ns == pytest.approx(NS / 24, rel=1e-6)


@pytest.mark.parametrize("rate,window,tolerance", [(8.0, 4, NS // 10), (24.0, 64, None), (48.0, 5, NS // 100),
                                                   (3.0, 2, 0)])
def test_camera_sample_matches(rate, window, tolerance, scene_video):
    pair = camera_pair(scene_video, 24)
    batches = sample_both(pair, dict(start_ns=pair[1].start_ns, sample_rate_hz=rate, end_ns=pair[1].end_ns,
                                     window_size=window), tolerance)
    assert len(batches) == math.ceil(len(tsamp.SamplingGrid.from_rate(
        0, sample_rate_hz=rate, end_ns=pair[1].end_ns).timestamps_ns) / window)
    for _, b in batches:
        if b["frames"][2][0]:
            assert b["frames"][1] == "uint8" and b["sensor_timestamps_ns"][1] == "int64"


def test_camera_empty_windows_and_resize_match(scene_video):
    pair = camera_pair(scene_video, 24)
    batches = sample_both(pair, dict(start_ns=10 * NS, sample_rate_hz=4.0, end_ns=11 * NS, window_size=8), NS // 100)
    assert all(b["frames"][2] == (0, 0, 0, 3) for _, b in batches)
    sample_both(camera_pair(scene_video, 24, resize_hw=(16, 24)),
                dict(start_ns=0, sample_rate_hz=12.0, end_ns=NS, window_size=3))


def test_camera_over_two_videos_matches(tmp_path, scene_video):
    """A camera whose frames span two files decodes each file's frames in
    one pass and keeps the refs' order."""
    second = make_scene_video(tmp_path / "b.mp4", num_scenes=1, scene_len_frames=10, moving_box=False)
    pair = []
    for mod, data in ((jcamera, jdata), (tcamera, tdata)):
        refs = [data.CameraFrameRef("front", scene_video, i, i / 24.0) for i in range(24)]
        refs += [data.CameraFrameRef("front", second, i, 1.0 + i / 24.0) for i in range(10)]
        pair.append(mod.CameraSensor("front", list(reversed(refs))))
    sample_both(pair, dict(start_ns=0, sample_rate_hz=30.0, end_ns=pair[1].end_ns, window_size=16), NS // 20)


def test_camera_refusals_match(scene_video):
    same(jcamera.CameraSensor, tcamera.CameraSensor, "front", [])
    refs = {name: [data.CameraFrameRef("front", scene_video, i, t) for i, t in enumerate((0.0, 0.1, 0.1))]
            for name, data in (("j", jdata), ("t", tdata))}
    assert outcome(tcamera.CameraSensor, "front", refs["t"]) == outcome(jcamera.CameraSensor, "front", refs["j"])
    assert outcome(tcamera.CameraSensor, "front", refs["t"])[0] == "ValueError"


def test_camera_from_session_matches(scene_video):
    sessions = []
    for data in (jdata, tdata):
        session = data.SensorSession(session_id="s")
        session.cameras["left"] = [data.CameraFrameRef("left", scene_video, i, i / 24.0) for i in range(8)]
        session.intrinsics["left"] = data.CameraIntrinsics(1000, 1000, 48, 32, 96, 64)
        sessions.append(session)
    j = jcamera.CameraSensor.from_session(sessions[0], "left")
    t = tcamera.CameraSensor.from_session(sessions[1], "left")
    assert t.camera == "left" and len(t.timestamps_ns) == 8
    assert plain(t.intrinsics) == plain(j.intrinsics)
    sample_both([j, t], dict(start_ns=0, sample_rate_hz=24.0, end_ns=t.end_ns, window_size=4))


# -- the video index ---------------------------------------------------------------------


def test_video_index_and_refs_match(tmp_path):
    path = str(tmp_path / "v.mp4")
    w = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 24.0, (64, 48))
    for i in range(48):
        w.write(np.full((48, 64, 3), i * 5 % 255, np.uint8))
    w.release()
    for t0 in (0, 1000, 1_700_000_000_000_000_000):
        assert plain(tvidx.index_video(path, t0_ns=t0)) == plain(jvidx.index_video(path, t0_ns=t0))
        assert plain(tvidx.camera_frame_refs("front", path, t0_ns=t0)) == \
            plain(jvidx.camera_frame_refs("front", path, t0_ns=t0))
    idx = tvidx.index_video(path, t0_ns=1000)
    assert idx.frame_count == 48 and idx.timestamps_ns[0] == 1000
    assert idx.fps == pytest.approx(24.0, abs=0.1) and idx.duration_s == pytest.approx(2.0, abs=0.05)


def test_video_index_without_a_container_index_matches(tmp_path, monkeypatch):
    """Where the mp4 index does not parse, both fall back to cv2's constant
    rate."""
    from cosmos_curate_tpu.video import mp4_index as jmp4
    from cosmos_curate_tpu_torch.video import mp4_index as tmp4

    path = make_scene_video(tmp_path / "v.mp4", num_scenes=1, scene_len_frames=9)
    for mod in (jmp4, tmp4):
        monkeypatch.setattr(mod, "parse_mp4_video_index", lambda p, mod=mod: (_ for _ in ()).throw(
            mod.Mp4ParseError("no index")))
    assert plain(tvidx.index_video(path, t0_ns=7)) == plain(jvidx.index_video(path, t0_ns=7))
    assert tvidx.index_video(path).frame_count == 9


def test_video_index_refusals_match(tmp_path):
    same(jvidx.index_video, tvidx.index_video, str(tmp_path / "missing.mp4"))
    (tmp_path / "junk.mp4").write_bytes(b"not a video")
    same(jvidx.index_video, tvidx.index_video, str(tmp_path / "junk.mp4"))


# -- the image sensor ---------------------------------------------------------------------


def write_images(directory: Path, times_ns, size=(24, 32), suffix=".png"):
    directory.mkdir(parents=True, exist_ok=True)
    paths = []
    for i, t in enumerate(times_ns):
        p = directory / f"cam_{t}{suffix}"
        img = np.full((*size, 3), (i * 40) % 255, np.uint8)
        img[:, : size[1] // 2, 0] = 200
        cv2.imwrite(str(p), img)
        paths.append(p)
    return paths


@pytest.mark.parametrize("name", ["frame_170000.jpg", "170000.png", "noindex.jpg", "a_b_12.webp", "x_-3.png"])
def test_timestamp_from_name_matches(name):
    same(jimage.timestamp_from_name, timage.timestamp_from_name, Path(name))


@pytest.mark.parametrize("tolerance,window,resize", [(None, 2, None), (NS // 2, 4, None), (0, 3, (12, 16))])
def test_image_sensor_sample_matches(tolerance, window, resize, tmp_path):
    write_images(tmp_path, [0, NS, 2 * NS, 3 * NS, 10 * NS])
    (tmp_path / "notes.txt").write_text("skipped")
    pair = [mod.ImageSensor.from_dir(tmp_path, resize_hw=resize) for mod in (jimage, timage)]
    assert pair[1].start_ns == pair[0].start_ns == 0 and pair[1].end_ns == 10 * NS
    assert plain(pair[1].timestamps_ns) == plain(pair[0].timestamps_ns)
    sample_both(pair, dict(start_ns=0, sample_rate_hz=1.0, end_ns=10 * NS, window_size=window), tolerance)


def test_image_sensor_explicit_timestamps_and_refusals_match(tmp_path):
    paths = write_images(tmp_path, [5, 6, 7])
    for args, kw in (((paths, [300, 100, 200]), {}), ((paths, [0]), {}), (([],), {}), ((paths, [1, 1, 2]), {}),
                     (([tmp_path / "gone_9.png"],), {})):
        j, t = outcome(jimage.ImageSensor, *args, **kw), outcome(timage.ImageSensor, *args, **kw)
        assert (t[0], t[0] != "ok" and t[1]) == (j[0], j[0] != "ok" and j[1])
    pair = [mod.ImageSensor(paths, [300, 100, 200]) for mod in (jimage, timage)]
    sample_both(pair, dict(start_ns=100, sample_rate_hz=1e7, end_ns=300, window_size=2))
    missing = [mod.ImageSensor([tmp_path / "gone_9.png"]) for mod in (jimage, timage)]
    spec = [samp.SamplingSpec(samp.SamplingGrid.from_rate(9, sample_rate_hz=1.0, end_ns=9)) for samp in (jsamp,
                                                                                                            tsamp)]
    errs = [outcome(lambda s=s, sp=sp: list(s.sample(sp))) for s, sp in zip(missing, spec, strict=True)]
    assert errs[1] == errs[0] and errs[1][0] == "FileNotFoundError"


# -- the sensor group ---------------------------------------------------------------------


def test_group_refuses_an_empty_mapping():
    same(jgroup.SensorGroup, tgroup.SensorGroup, {})


def test_group_lockstep_with_partial_coverage_matches(tmp_path):
    write_images(tmp_path / "a", [0, NS, 2 * NS, 3 * NS])
    write_images(tmp_path / "b", [0, NS])
    groups = [g.SensorGroup({"a": i.ImageSensor.from_dir(tmp_path / "a"), "b": i.ImageSensor.from_dir(tmp_path / "b")})
              for g, i in ((jgroup, jimage), (tgroup, timage))]
    t = groups[1]
    assert t.start_ns == 0 and t.end_ns == 3 * NS and isinstance(t.sensors["a"], tgroup.Sensor)
    frames = sample_both(groups, dict(start_ns=0, sample_rate_hz=1.0, end_ns=3 * NS, window_size=2), NS // 4)
    assert [sorted(f[1]["sensor_data"]) for f in frames] == [["a", "b"], ["a"]]


# -- the data model and alignment (the AV session log) ------------------------------------------


def session_file(tmp_path) -> Path:
    records = []
    for cam in ("front", "rear"):
        for i in range(20):
            records.append({"type": "camera_frame", "camera": cam, "video_path": f"{cam}.mp4", "frame_index": i,
                            "timestamp_s": i * 0.1 + (0.01 if cam == "rear" else 0.0)})
    for i in range(10):
        records.append({"type": "gps", "timestamp_s": i * 0.2, "latitude": 37.0 + i * 1e-5, "longitude": -122.0,
                        "altitude_m": 10.0, "speed_mps": 5.0})
    for i in range(40):
        records.append({"type": "imu", "timestamp_s": i * 0.05, "accel": [0, 0, 9.8], "gyro": [0.01 * i, 0, 0]})
    records.append({"type": "intrinsics", "camera": "front", "fx": 1000, "fy": 1000, "cx": 960, "cy": 540,
                    "width": 1920, "height": 1080, "distortion": [0.1, -0.02]})
    records.append({"type": "extrinsics", "camera": "front", "rotation": [0.7071, 0, 0.7071, 0],
                    "translation": [1.5, 0, 1.2]})
    p = tmp_path / "session01.jsonl"
    p.write_text("\n".join(json.dumps(r) for r in records) + "\n\n")
    return p


def test_session_log_and_matrices_match(tmp_path):
    path = session_file(tmp_path)
    j, t = jdata.load_session_jsonl(path), tdata.load_session_jsonl(path)
    assert plain(t) == plain(j)
    assert t.session_id == "session01" and set(t.cameras) == {"front", "rear"}
    for cam in ("front",):
        np.testing.assert_array_equal(t.intrinsics[cam].matrix(), j.intrinsics[cam].matrix())
        np.testing.assert_array_equal(t.extrinsics[cam].matrix(), j.extrinsics[cam].matrix())
    assert t.intrinsics["front"].matrix()[0, 0] == 1000 and t.extrinsics["front"].matrix()[2, 3] == 1.2
    np.testing.assert_array_equal(tdata.CameraExtrinsics().matrix(), np.eye(4))


@pytest.mark.parametrize("rate,tolerance,cameras", [(5.0, 0.06, None), (5.0, 0.001, None), (10.0, 0.1, ["front"]),
                                                    (2.0, 0.1, None), (5.0, 0.06, ["front", "side"]),
                                                    (0.0, 0.1, None)])
def test_align_matches(rate, tolerance, cameras, tmp_path):
    path = session_file(tmp_path)
    j, t = jdata.load_session_jsonl(path), tdata.load_session_jsonl(path)
    want = plain(jalign.align(j, rate_hz=rate, tolerance_s=tolerance, cameras=cameras))
    got = plain(talign.align(t, rate_hz=rate, tolerance_s=tolerance, cameras=cameras))
    assert got == want
    assert plain(talign.sampling_grid(t, rate_hz=rate or 1.0, cameras=cameras)) == \
        plain(jalign.sampling_grid(j, rate_hz=rate or 1.0, cameras=cameras))
    if (rate, tolerance, cameras) == (5.0, 0.06, None):
        assert got and all(set(f[1]["cameras"]) == {"front", "rear"} for f in got)
        assert any(f[1]["gps"] is not None for f in got) and any(f[1]["imu"] is not None for f in got)
    if tolerance == 0.001 or cameras == ["front", "side"] or rate == 0.0:
        assert got == []


@pytest.mark.parametrize("values,target", [([0.0, 1.0, 2.0], 1.4), ([0.0, 1.0, 2.0], 1.6), ([0.0, 1.0, 2.0], 1.5),
                                           ([0.0, 1.0, 2.0], -3.0), ([0.0, 1.0, 2.0], 9.0), ([4.0], 1.0)])
def test_nearest_matches(values, target):
    assert talign.nearest(values, target) == jalign.nearest(values, target)


# -- the slice as a whole: a three-camera rig -------------------------------------------------------


CAMERAS = ("front", "left", "rear")


@pytest.fixture(scope="module")
def rig(tmp_path_factory):
    """Three cameras of one session, the rear one cut to its first 12 frames,
    each captured to MCAP by the JAX package and by the port."""
    root = tmp_path_factory.mktemp("rig")
    out = {}
    for i, camera in enumerate(CAMERAS):
        video = make_scene_video(root / f"{camera}.mp4", num_scenes=2, scene_len_frames=12 if camera != "rear" else 6,
                                 size_wh=(64, 48))
        files = {}
        for name, mod in (("jax", jmcam), ("torch", tmcam)):
            files[name] = root / f"{camera}.{name}.mcap"
            n = mod.make_mcap_from_video(video, files[name], topic=f"/{camera}/rgb", start_ns=1_000_000 * i)
            assert n == (24 if camera != "rear" else 12)
        assert files["jax"].read_bytes() == files["torch"].read_bytes()
        out[camera] = (video, files)
    return out


@pytest.mark.parametrize("rate,window,tolerance", [(10.0, 64, None), (24.0, 8, NS // 48), (24.0, 5, 0)])
def test_the_rig_samples_alike(rate, window, tolerance, rig):
    """``make_mcap_from_video`` -> ``SensorGroup.sample`` over the MCAP
    cameras, the mp4 cameras beside them, then ``align`` over the frame
    refs: the same batches in both packages, and the MCAP and mp4 sources
    the same frames."""
    results = {}
    for name, (mcam, camera, group, samp, vidx, data, align) in {
            "jax": (jmcam, jcamera, jgroup, jsamp, jvidx, jdata, jalign),
            "torch": (tmcam, tcamera, tgroup, tsamp, tvidx, tdata, talign)}.items():
        mcap = {c: mcam.McapCameraSensor(files[name], topic=f"/{c}/rgb") for c, (_, files) in rig.items()}
        refs = {c: vidx.camera_frame_refs(c, video, t0_ns=1_000_000 * i)
                for i, (c, (video, _)) in enumerate(rig.items())}
        mp4 = {c: camera.CameraSensor(c, refs[c]) for c in CAMERAS}
        runs = {}
        for label, sensors in (("mcap", mcap), ("mp4", mp4)):
            g = group.SensorGroup(sensors)
            spec = samp.SamplingSpec(samp.SamplingGrid.from_rate(g.start_ns, sample_rate_hz=rate, end_ns=g.end_ns,
                                                                 window_size=window),
                                     None if tolerance is None else samp.SamplingPolicy(tolerance))
            runs[label] = [plain(f) for f in g.sample(spec)]
        session = data.SensorSession(session_id="rig", cameras=refs)
        runs["align"] = plain(align.align(session, rate_hz=rate, tolerance_s=0.5 / 24))
        for sensor in mcap.values():
            sensor.close()
        results[name] = runs
    assert results["torch"] == results["jax"]
    runs = results["torch"]
    for f_mcap, f_mp4 in zip(runs["mcap"], runs["mp4"], strict=True):
        assert sorted(f_mcap[1]["sensor_data"]) == sorted(f_mp4[1]["sensor_data"])
        for c, batch in f_mcap[1]["sensor_data"].items():
            other = f_mp4[1]["sensor_data"][c][1]
            for key in ("frames", "frame_indices", "sensor_timestamps_ns", "align_timestamps_ns"):
                assert batch[1][key] == other[key], (c, key)
    # the rear camera covers only the first half: under a tolerance, windows
    # past it lack it; without one, every grid point takes a nearest frame
    assert any("rear" not in f[1]["sensor_data"] and "front" in f[1]["sensor_data"]
               for f in runs["mcap"]) is (tolerance is not None)
    aligned = runs["align"]
    assert aligned and all(set(a[1]["cameras"]) == set(CAMERAS) for a in aligned)
    assert max(a[1]["timestamp_s"] for a in aligned) <= 11 / 24 + 2e-3 + 1e-9
