"""``chip_smoke.py``'s ``sensors`` phase, which ``chip_smoke.py`` runs after
its ``service`` phase on the split phase's corpus and outputs, or alone on
the card's host.

Run from the repository root on a machine with one NVIDIA GPU:

    python3 scripts/sensors_phase.py

Alone, it builds the kernels, checks flash at ``chip_smoke.FLASH_CASES``,
writes the first ``len(CAMERAS)`` videos of the split corpus and runs run
A's settings on the first of them (``out_a``, whose ``embeddings/`` the
export reads). The sensors are host code: no kernel launches here, and the
phase asserts it (every kernel's launch counter zeroed as it starts, read
as it ends). One JSON line, ``sensors``:

1. **capture**: the corpus's first three videos as three cameras of one rig
   (``front``, ``left``, ``rear``; 4 s at 1280x720 and 24 fps, 96 frames,
   ~265 MB of rgb8 a camera) through ``make_mcap_from_video``, zstd where
   ``zstandard`` imports, else ``none`` (the codec is named on the line):
   seconds, raw and file MB, frames a camera.
2. **sources**: each camera read through ``McapCameraSensor`` and through
   ``CameraSensor(camera, camera_frame_refs(camera, mp4))``, sampled at
   ``benchmarks/camera_sensor_benchmark.py``'s defaults (10 Hz, 64-sample
   windows) and at the capture rate (24 Hz): the two sources give the same
   windows, ``frame_indices``, timestamps and frames, bit for bit (cv2's
   decode of one file on one host, stored losslessly); frames/s and MB/s
   of each source, timed as that benchmark times (``time.monotonic``
   around the ``sample`` loop).
3. **rig**: a ``SensorGroup`` of the three MCAP cameras with the rear
   camera's capture cut to its first 2 s (``av_phase.cut_copy``, as the
   ``av`` phase cuts its short camera), at 10 Hz in windows of 8 with a
   half-frame tolerance: front and left in every window, the rear camera
   in exactly the windows that start inside its span, its samples inside
   it; ``align`` over a ``SensorSession`` of the three cameras' frame refs
   (the rear's from the cut mp4) gives one aligned frame a grid point of
   the shared span, each with all three cameras. Windows, frames and
   seconds.
4. **lance**: ``import lance`` in this process. Where it fails
   (``pylance`` is not a dependency of the port):
   ``IndexStore(root, backend="lance")`` resolves to parquet with the
   reference's warning, ``CorpusIndex.build(..., backend="lance")`` over
   run A's embeddings still answers (every row finds itself at similarity
   ~1, probing every cluster on the card), and the port's ``export-lance``
   over run A's
   ``embeddings/`` exits 2 with the ``pip install pylance`` guidance.
   Where it imports, the same steps on lance: the store and the index on
   lance datasets, the export writing one dataset a model.
5. **no kernel**: every kernel's launches over the phase are 0.

Any mismatch raises. Reported beside the times: the card's ``nvidia-smi``
name and power limit (the times are the card host's CPU's).
"""

from __future__ import annotations

import contextlib
import io
import logging
import os
import sys
import time
from pathlib import Path

import numpy as np

# a spawned child (the corpus writers) imports this script again as
# ``__mp_main__`` and runs none of its device code
if __name__ != "__mp_main__":
    import torch

CAMERAS = ("front", "left", "rear")
SHORT_CAMERA = "rear"
SHORT_FRAMES = 48  # its first 2 s at 24 fps
# camera_sensor_benchmark.py's defaults, then the capture rate
RATES = ((10.0, 64), (24.0, 64))
RIG_RATE, RIG_WINDOW = 10.0, 8
INDEX_K = 8


def codec() -> str:
    try:
        import zstandard  # noqa: F401
    except ImportError:
        return "none"
    return "zstd"


def lance_imports() -> bool:
    try:
        import lance  # noqa: F401
    except ImportError:
        return False
    return True


def capture(videos: dict, out: Path, compression: str) -> dict:
    """Every camera's video through ``make_mcap_from_video``."""
    from cosmos_curate_tpu_torch.sensors.mcap_camera_sensor import make_mcap_from_video

    rec = {}
    for camera, video in videos.items():
        path = out / f"{camera}.mcap"
        t0 = time.monotonic()
        frames = make_mcap_from_video(video, path, compression=compression)
        seconds = time.monotonic() - t0
        rec[camera] = {"path": str(path), "frames": frames, "seconds": seconds,
                       "file_mb": path.stat().st_size / 1e6}
    return rec


def timed_batches(sensor, spec) -> tuple[list, float]:
    """Every batch of ``sensor.sample(spec)`` and the loop's seconds."""
    t0 = time.monotonic()
    batches = list(sensor.sample(spec))
    return batches, time.monotonic() - t0


def assert_same_batches(a: list, b: list, label: str) -> None:
    assert len(a) == len(b), f"{label}: {len(a)} windows against {len(b)}"
    for i, (x, y) in enumerate(zip(a, b, strict=True)):
        for key in ("align_timestamps_ns", "sensor_timestamps_ns", "frame_indices", "frames"):
            u, v = getattr(x, key), getattr(y, key)
            assert u.dtype == v.dtype and u.shape == v.shape and np.array_equal(u, v), f"{label}: window {i}, {key}"


def two_sources(videos: dict, mcaps: dict) -> dict:
    """Each camera through both sources at ``RATES``: the same batches,
    frames/s and MB/s of each."""
    from cosmos_curate_tpu_torch.sensors.camera_sensor import CameraSensor
    from cosmos_curate_tpu_torch.sensors.mcap_camera_sensor import McapCameraSensor
    from cosmos_curate_tpu_torch.sensors.sampling import SamplingGrid, SamplingSpec
    from cosmos_curate_tpu_torch.sensors.video_index import camera_frame_refs

    out = {}
    for camera, video in videos.items():
        t0 = time.monotonic()
        mcap = McapCameraSensor(mcaps[camera]["path"])
        mcap_open_s = time.monotonic() - t0
        t0 = time.monotonic()
        mp4 = CameraSensor(camera, camera_frame_refs(camera, str(video)))
        mp4_open_s = time.monotonic() - t0
        try:
            assert np.array_equal(mcap.timestamps_ns, mp4.timestamps_ns), f"{camera}: the two timelines differ"
            rec = {"open_s": {"mcap": mcap_open_s, "mp4": mp4_open_s}, "width": mcap.width, "height": mcap.height}
            for rate, window in RATES:
                spec = SamplingSpec(SamplingGrid.from_rate(mp4.start_ns, sample_rate_hz=rate, end_ns=mp4.end_ns,
                                                           window_size=window))
                got = {}
                for label, sensor in (("mcap", mcap), ("mp4", mp4)):
                    batches, seconds = timed_batches(sensor, spec)
                    frames = sum(len(b) for b in batches)
                    nbytes = sum(b.frames.nbytes for b in batches)
                    got[label] = batches
                    rec[f"{label}_{rate:g}hz"] = {"windows": len(batches), "frames": frames, "seconds": seconds,
                                                  "frames_per_s": frames / seconds, "mb_per_s": nbytes / seconds / 1e6}
                assert_same_batches(got["mcap"], got["mp4"], f"{camera} at {rate:g} Hz")
                assert rec[f"mcap_{rate:g}hz"]["frames"] == len(spec.grid.timestamps_ns) > 0
                rec[f"bit_equal_{rate:g}hz"] = True
            out[camera] = rec
        finally:
            mcap.close()
    return out


def rig(root: Path, videos: dict, mcaps: dict, compression: str) -> dict:
    """The three MCAP cameras, the rear cut to ``SHORT_FRAMES``, in one
    ``SensorGroup``; ``align`` over their frame refs."""
    import av_phase

    from cosmos_curate_tpu_torch.sensors.alignment import align
    from cosmos_curate_tpu_torch.sensors.data import SensorSession
    from cosmos_curate_tpu_torch.sensors.group import SensorGroup
    from cosmos_curate_tpu_torch.sensors.mcap_camera_sensor import McapCameraSensor, make_mcap_from_video
    from cosmos_curate_tpu_torch.sensors.sampling import NS, SamplingGrid, SamplingPolicy, SamplingSpec
    from cosmos_curate_tpu_torch.sensors.video_index import camera_frame_refs

    short = root / f"{SHORT_CAMERA}_2s.mp4"
    av_phase.cut_copy(videos[SHORT_CAMERA], short, SHORT_FRAMES)
    short_mcap = root / f"{SHORT_CAMERA}_2s.mcap"
    t0 = time.monotonic()
    assert make_mcap_from_video(short, short_mcap, compression=compression) == SHORT_FRAMES
    cut_capture_s = time.monotonic() - t0
    rig_videos = {**videos, SHORT_CAMERA: short}
    paths = {c: mcaps[c]["path"] for c in CAMERAS if c != SHORT_CAMERA} | {SHORT_CAMERA: short_mcap}
    mcap = {c: McapCameraSensor(paths[c]) for c in CAMERAS}
    try:
        tolerance = NS // 48  # half a frame
        group = SensorGroup(mcap)
        spec = SamplingSpec(SamplingGrid.from_rate(group.start_ns, sample_rate_hz=RIG_RATE, end_ns=group.end_ns,
                                                   window_size=RIG_WINDOW), SamplingPolicy(tolerance))
        t0 = time.monotonic()
        windows = list(group.sample(spec))
        seconds = time.monotonic() - t0
        rear_end = mcap[SHORT_CAMERA].end_ns
        with_rear = 0
        for i, w in enumerate(windows):
            assert {"front", "left"} <= set(w.sensor_data), f"rig window {i}: {sorted(w.sensor_data)}"
            for c, batch in w.sensor_data.items():
                assert len(batch) == len(w.align_timestamps_ns) or c == SHORT_CAMERA, f"rig window {i}: {c}"
                assert batch.frames.shape[1:] == (mcap[c].height, mcap[c].width, 3) and batch.frames.dtype == np.uint8
            # a window holds the short camera exactly when its first grid
            # point lies within its span (or half a frame past its end)
            has_rear = SHORT_CAMERA in w.sensor_data
            assert has_rear == (int(w.align_timestamps_ns[0]) <= rear_end + tolerance), f"rig window {i}"
            if has_rear:
                with_rear += 1
                assert int(w.sensor_data[SHORT_CAMERA].sensor_timestamps_ns.max()) <= rear_end
        assert 0 < with_rear < len(windows), f"{with_rear} of {len(windows)} windows with the short camera"
        refs = {c: camera_frame_refs(c, str(v)) for c, v in rig_videos.items()}
        t0 = time.monotonic()
        aligned = align(SensorSession(session_id="rig", cameras=refs), rate_hz=RIG_RATE, tolerance_s=0.5 / 24)
        align_s = time.monotonic() - t0
        shared_end = min(r[-1].timestamp_s for r in refs.values())
        assert aligned and all(set(a.cameras) == set(CAMERAS) for a in aligned)
        assert max(a.timestamp_s for a in aligned) <= shared_end + 1e-9
        assert len(aligned) == int(shared_end * RIG_RATE + 1e-9) + 1, (len(aligned), shared_end)
        return {"windows": len(windows), "windows_with_short_camera": with_rear,
                "frames": sum(len(b) for w in windows for b in w.sensor_data.values()), "seconds": seconds,
                "cut_capture_s": cut_capture_s, "aligned_frames": len(aligned), "shared_span_s": shared_end,
                "align_s": align_s}
    finally:
        for sensor in mcap.values():
            sensor.close()


@contextlib.contextmanager
def captured_warnings(records: list):
    """The port's log warnings, kept (its loggers do not propagate)."""
    class Keep(logging.Handler):
        def emit(self, record):
            records.append(record.getMessage())

    handler = Keep(level=logging.WARNING)
    root = logging.getLogger("cosmos_curate_tpu_torch")
    root.addHandler(handler)
    try:
        yield
    finally:
        root.removeHandler(handler)


def lance_steps(dev, root: Path, embeddings: Path) -> dict:
    """The lance half in this process: the store's resolution, an index built
    and queried, ``export-lance`` over ``embeddings``."""
    import pyarrow.parquet as pq

    from cosmos_curate_tpu_torch.cli import main as cli_main
    from cosmos_curate_tpu_torch.dedup.corpus_index import CorpusIndex
    from cosmos_curate_tpu_torch.dedup.index_store import IndexStore

    has_lance = lance_imports()
    want = "lance" if has_lance else "parquet"
    warnings: list = []
    with captured_warnings(warnings):
        store = IndexStore(str(root / "probe"), backend="lance")
    assert store.backend == want, store.backend
    fallback = f"lance backend unavailable for {root / 'probe'}; falling back to parquet"
    assert warnings == ([] if has_lance else [fallback]), warnings
    ids, vecs = [], []
    for path in sorted(embeddings.rglob("*.parquet")):
        table = pq.read_table(path).to_pydict()
        ids += table["clip_uuid"]
        vecs += [np.asarray(v, np.float32) for v in table["embedding"]]
    vecs = np.stack(vecs)
    t0 = time.monotonic()
    index = CorpusIndex.build(str(root / "index"), ids, vecs, model="video", k=min(INDEX_K, len(ids)),
                              backend="lance", device=dev)
    build_s = time.monotonic() - t0
    assert index.store.backend == want
    t0 = time.monotonic()
    hits = index.query(vecs, top_k=2, nprobe=index.meta["k"])
    query_s = time.monotonic() - t0
    # each row finds itself (an exact copy of a row could tie it for first)
    own = [dict(row).get(uid) for uid, row in zip(ids, hits, strict=True)]
    assert all(s is not None and s > 0.999 for s in own), "an indexed row does not find itself"
    fragments = sorted(p.name for p in (root / "index" / "clusters").rglob(f"*.{want}"))
    assert fragments and len(fragments) == sum(index.store.cluster_fragment_counts().values())
    err, out = io.StringIO(), io.StringIO()
    t0 = time.monotonic()
    with contextlib.redirect_stderr(err), contextlib.redirect_stdout(out):
        rc = cli_main.main(["export-lance", "--src", str(embeddings), "--dest", str(root / "lance")])
    export_s = time.monotonic() - t0
    if has_lance:
        assert rc == 0 and err.getvalue() == "", (rc, err.getvalue())
    else:
        assert rc == 2 and out.getvalue() == "", (rc, out.getvalue())
        assert err.getvalue().startswith("error: lance is not installed") and "pip install pylance" in \
            err.getvalue(), err.getvalue()
    return {"lance_imports": has_lance, "store_backend": store.backend, "warning": warnings[0] if warnings else None,
            "index": {"rows": len(ids), "k": index.meta["k"], "fragments": len(fragments), "build_s": build_s,
                      "query_s": query_s, "self_hits": len(ids)},
            "export_lance": {"exit_code": rc, "stderr": err.getvalue().strip(), "stdout": out.getvalue().strip(),
                             "seconds": export_s}}


def drive_sensors(cs, dev, root: Path, corpus: list[Path]) -> dict:
    from cosmos_curate_tpu_torch.ops import kernels

    ks = kernels()
    for k in ks.values():
        k.launches = 0
    out_dir = root / "sensors"
    out_dir.mkdir()
    videos = dict(zip(CAMERAS, corpus[: len(CAMERAS)], strict=True))
    compression = codec()
    mcaps = capture(videos, out_dir, compression)
    for camera, rec in mcaps.items():
        assert rec["frames"] == cs.SPLIT_NUM_SCENES * cs.SPLIT_SCENE_FRAMES, (camera, rec)
        rec["raw_mb"] = rec["frames"] * cs.SPLIT_FRAME_W * cs.SPLIT_FRAME_H * 3 / 1e6
    sources = two_sources(videos, mcaps)
    rig_rec = rig(out_dir, videos, mcaps, compression)
    lance = lance_steps(dev, out_dir, root / "out_a" / "embeddings")
    launches = {name: k.launches for name, k in ks.items()}
    assert not any(launches.values()), f"the sensors phase launched kernels: {launches}"
    return {"codec": compression, "capture": mcaps,
            "capture_s": sum(r["seconds"] for r in mcaps.values()), "sources": sources, "rig": rig_rec,
            "lance": lance, "launches": launches, "no_kernel_launched": True}


def run(cs, dev, root: Path, corpus: list[Path]) -> dict:
    """The phase, its line emitted as it ends; returns the record."""
    t0 = time.monotonic()
    record = {**drive_sensors(cs, dev, root, corpus), "phase_s": time.monotonic() - t0, "card": cs.card_line()}
    cs.emit({"phase": "sensors", **record})
    rate = {label: np.mean([s[f"{label}_24hz"]["frames_per_s"] for s in record["sources"].values()])
            for label in ("mcap", "mp4")}
    print(f"sensors: capture {record['capture_s']:.2f} s ({record['codec']}); at 24 Hz mcap {rate['mcap']:.1f} "
          f"frames/s, mp4 {rate['mp4']:.1f} frames/s; rig {record['rig']['windows']} windows; lance "
          f"{'present' if record['lance']['lance_imports'] else 'absent'} (export exit "
          f"{record['lance']['export_lance']['exit_code']}); phase {record['phase_s']:.1f} s", flush=True)
    return record


def main() -> int:
    if not torch.cuda.is_available():
        print("sensors_phase: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.getcwd())
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import pyarrow.parquet  # noqa: F401  (main thread first: see remote_phase.main)

    import chip_smoke as cs
    from cosmos_curate_tpu_torch.core.runner import default_runner
    from cosmos_curate_tpu_torch.pipelines.video import split

    dev = torch.device("cuda", 0)
    started = time.monotonic()
    timer, build_s = cs.phase_prologue(dev)
    with cs.split_corpus(len(CAMERAS)) as (root, corpus, corpus_s):
        a = cs.split_run(dev, cs.split_args(cs.subset(root, corpus, "videos_a", 1), root / "out_a"), default_runner(),
                         (split.ClipEmbeddingStage,))
        assert a["summary"]["num_with_embeddings"] > 0, a["summary"]
        cs.emit({"phase": "sensors_prologue", "build_s": build_s, "corpus_build_s": corpus_s,
                 "run_a_wall_s": a["wall"]})
        run(cs, dev, root, corpus)
    cs.emit({"phase": "timing", "script_s": time.monotonic() - started})
    return 0


if __name__ == "__main__":
    sys.exit(main())
