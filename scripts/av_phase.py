"""``chip_smoke.py``'s ``av`` phase, which ``chip_smoke.py`` runs after its
``multinode`` phase on the split phase's corpus, or alone on the card.

Run from the repository root on a machine with one NVIDIA GPU:

    python3 scripts/av_phase.py

Alone, it builds the kernels, checks flash at ``chip_smoke.FLASH_CASES`` and
writes the first ``AV_VIDEOS`` videos of the split corpus (4 s, 1280x720).
They make two sessions of three cameras (``front``, ``left``, ``rear``);
``s0``'s rear camera is cut a scene shorter (its first 2 s), so the shorter
camera's path runs. Every kernel's launch counter is zeroed just before a
run and read just after it. One JSON line, ``av``:

1. **multicam split**: ``run_split`` at run A's settings
   (``chip_smoke.split_args``) with ``multicam=True`` on the sessions as
   ``<session>/<camera>.mp4``, through the default runner: every camera's
   clips under ``clips/<primary-uuid>/<camera>.mp4`` (the shorter camera
   without its tail), metas and unit-norm embeddings of the primary only,
   flash launched; a resumed run discovers nothing; a multicam split by
   shot detection raises ``ValueError``.
2. **AV steps**: the same six files as ``<session>_<camera>.mp4`` through
   the port's ``local av`` command, in process (``cli.main.main``, its
   printed summary parsed): ``ingest``, ``split`` (2-s clips: 11),
   ``caption`` (``--limit 4`` clips, ``av`` and ``short``: one window of
   each, one batch of 8 requests on ``CaptionEngine(VLM_BASE,
   max_batch=8)``; under torch.profiler for the device's idle share; paged
   decode, paged prefill and flash launched), ``caption`` of the other 7
   clips (``av`` only), ``caption`` again (``num_captioned`` 0 and no
   launch: a resume with nothing left builds no engine), ``trajectory`` (phase correlation on the card: every
   call's input on ``cuda``; ms a clip by CUDA events on one clip's
   frames), ``annotate``, ``package`` (``T5EncoderTPU(T5_BASE)``; its
   device ms by torch.profiler), ``shard``, then ``run_av_shard`` with the T5
   ``e`` tars and the clip-session tars. Every step's wall is reported.
3. **postgres**: ``ingest`` and ``split`` again, with ``--db-path`` a
   ``postgres://`` DSN of the repository's fake server
   (``tests/pipelines/fake_pg.py``: the wire protocol over 127.0.0.1 in
   this process, SCRAM-SHA-256), then ``postgres update-schemas`` and
   ``show-tables``: the rows (sessions, clips, clipped sessions, video
   spans, runs, with output roots and run ids normalised) and the table
   counts are the sqlite run's right after its split.

Every flash shape a run gives the wrapper that ``FLASH_CASES`` lacks is
checked and timed here. Reported beside the walls: the card's
``nvidia-smi`` name and power limit.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import os
import sys
import tarfile
import time
from pathlib import Path

import numpy as np

# a spawned child (the corpus writers) imports this script again as
# ``__mp_main__`` and runs none of its device code
if __name__ != "__mp_main__":
    import torch

SEED = 20
AV_VIDEOS = 6
CAMERAS = ("front", "left", "rear")
SHORT_CAMERA = ("s0", "rear")  # cut a scene shorter
AV_CLIP_LEN_S = 2.0
AV_CLIPS = 11  # 2-s clips: two a 4-s camera, one of the shorter camera
AV_CAPTION_LIMIT = 4
AV_VARIANTS = "av,short"
AV_KERNELS = ("paged_decode", "paged_prefill", "flash")


def cut_copy(src: Path, dst: Path, frames: int) -> None:
    """The first ``frames`` frames of ``src`` written to ``dst`` (mp4v, the
    corpus's codec and rate)."""
    import cv2

    cap = cv2.VideoCapture(str(src))
    w = cv2.VideoWriter(str(dst), cv2.VideoWriter_fourcc(*"mp4v"), cap.get(cv2.CAP_PROP_FPS),
                        (int(cap.get(cv2.CAP_PROP_FRAME_WIDTH)), int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT))))
    try:
        for _ in range(frames):
            ok, frame = cap.read()
            assert ok, f"{src} holds fewer than {frames} frames"
            w.write(frame)
    finally:
        cap.release()
        w.release()


def session_inputs(cs, root: Path, corpus: list[Path]) -> tuple[Path, Path]:
    """The corpus's first six videos as two sessions of three cameras, both
    ways: ``<session>/<camera>.mp4`` (multicam) and
    ``<session>_<camera>.mp4`` (AV). Returns (multicam dir, AV dir)."""
    mc, av = root / "av_multicam_in", root / "av_in"
    av.mkdir()
    for i, path in enumerate(corpus[:AV_VIDEOS]):
        session, camera = f"s{i // len(CAMERAS)}", CAMERAS[i % len(CAMERAS)]
        (mc / session).mkdir(parents=True, exist_ok=True)
        dst = mc / session / f"{camera}.mp4"
        if (session, camera) == SHORT_CAMERA:
            cut_copy(path, dst, cs.SPLIT_SCENE_FRAMES * (cs.SPLIT_NUM_SCENES - 1))
        else:
            os.link(path, dst)
        os.link(dst, av / f"{session}_{camera}.mp4")
    return mc, av


@contextlib.contextmanager
def trajectory_devices(devices: list):
    """Record the device of every phase-correlation call's input."""
    from cosmos_curate_tpu_torch.pipelines.av import trajectory

    saved = trajectory.phase_correlate_pairs

    def recorded(gray):
        devices.append(str(gray.device))
        return saved(gray)

    trajectory.phase_correlate_pairs = recorded
    try:
        yield
    finally:
        trajectory.phase_correlate_pairs = saved


def cli(argv: list[str]) -> dict:
    """One ``cosmos-curate-tpu-torch`` command in process: its wall and
    what it printed."""
    from cosmos_curate_tpu_torch.cli import main as cli_main

    sink = io.StringIO()
    t0 = time.monotonic()
    with contextlib.redirect_stdout(sink):
        rc = cli_main.main(argv)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    assert rc == 0, f"{' '.join(argv[:3])}: exit {rc}"
    text = sink.getvalue()
    return {"wall_s": wall, "text": text}


def av_step(step: str, av_in: Path, out: Path, *extra: str) -> dict:
    res = cli(["local", "av", step, "--input-path", str(av_in), "--output-path", str(out),
               "--clip-len-s", str(AV_CLIP_LEN_S), *extra])
    return {"wall_s": res["wall_s"], **json.loads(res["text"])}


def state_rows(db_path: str, root: Path) -> tuple[dict, dict]:
    """The rows a split leaves, the output root and run ids normalised, and
    each video span's (byte size, sha256) by clip, verified against the
    file it names. An encoder that does not repeat itself (libx264) writes
    other bytes on a second split, so the sizes and hashes are compared
    apart from the rows."""
    import hashlib

    from cosmos_curate_tpu_torch.pipelines.av.state_db import open_state_db

    db = open_state_db(db_path)
    try:
        runs = db.runs()
        encoded = {}
        for span in db.video_spans():
            data = Path(span.url).read_bytes()
            assert (len(data), hashlib.sha256(data).hexdigest()) == (span.byte_size, span.sha256), span.url
            encoded[span.clip_uuid] = (span.encoder, span.byte_size, span.sha256)
        rows = {"sessions": sorted(db.sessions()),
                **{name: sorted((dataclasses.asdict(r) for r in fn()), key=lambda d: json.dumps(d, sort_keys=True))
                   for name, fn in (("clips", db.clips), ("clipped", db.clipped_sessions),
                                    ("spans", db.video_spans), ("runs", lambda: runs))}}
    finally:
        db.close()
    text = json.dumps(rows, sort_keys=True).replace(str(root), "<root>")
    for run in runs:
        text = text.replace(run.run_uuid, f"<{run.run_type}-run>")
    out = json.loads(text)
    for run in out["runs"]:
        params = json.loads(run["params"])
        params["db_path"] = "<db>"
        run["params"] = params
    for span in out["spans"]:
        del span["byte_size"], span["sha256"]
    return out, encoded


def profiled(fn) -> dict:
    """``fn()`` once under torch.profiler tracing the device: launches,
    device busy seconds, the traced wall and the device's idle share. The
    sums read the tracer's raw events: ``key_averages`` would build a
    Python event tree, ~30 s for the caption step's ~10^5 launches."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = [e for e in prof.profiler.kineto_results.events()
              if e.device_type() == torch.autograd.DeviceType.CUDA]
    busy = sum(e.duration_ns() for e in events) / 1e9
    assert busy > 0, "the profiler traced no device time"
    return {"launches": len(events), "device_busy_s": busy, "traced_wall_s": wall, "device_idle_share": 1.0 - busy / wall}


def tar_names(path: Path) -> list[str]:
    with tarfile.open(path) as tf:
        return tf.getnames()


def drive_av(cs, dev, timer, root: Path, corpus: list[Path]) -> dict:
    from cosmos_curate_tpu_torch.pipelines.av import pipeline as av
    from cosmos_curate_tpu_torch.pipelines.av import trajectory
    from cosmos_curate_tpu_torch.pipelines.video import split
    from cosmos_curate_tpu_torch.pipelines.video.input_discovery import discover_multicam_tasks
    from cosmos_curate_tpu_torch.pipelines.video.stages.writer import ClipWriterStage
    from cosmos_curate_tpu_torch.video.decode import extract_frames_at_fps
    from tests.pipelines.fake_pg import FakePgServer

    assert len(corpus) >= AV_VIDEOS, f"the av phase needs {AV_VIDEOS} corpus videos"
    mc_in, av_in = session_inputs(cs, root, corpus)
    shapes: set = set()
    walls: dict[str, float] = {}

    # 1. the multicam split at run A's settings
    stage_classes = (split.VideoDownloadStage, split.FixedStrideExtractorStage, split.ClipTranscodingStage,
                     split.ClipFrameExtractionStage, split.ClipEmbeddingStage, ClipWriterStage)
    mc_out = root / "av_multicam_out"
    a = cs.split_args(mc_in, mc_out, multicam=True, primary_camera="front")
    mc = cs.split_run(dev, a, None, stage_classes)
    shapes |= mc["flash_shapes"]
    walls["multicam_split"] = mc["wall"]
    summary = mc["summary"]
    per_camera = {cam: sorted(p.parent.name for p in mc_out.glob(f"clips/*/{cam}.mp4")) for cam in CAMERAS}
    primaries = per_camera["front"]
    assert summary["num_videos"] == 2 and summary["num_clips"] == len(primaries) == 8, summary
    assert len(per_camera["left"]) == 8 and len(per_camera["rear"]) == 6, {k: len(v) for k, v in per_camera.items()}
    assert set(per_camera["rear"]) < set(primaries) and set(per_camera["left"]) == set(primaries)
    assert summary["num_transcoded"] == 22 and not list(mc_out.glob("clips/*.mp4"))
    metas = {p.stem: json.loads(p.read_text()) for p in (mc_out / "metas" / "v0").glob("*.json")}
    assert sorted(metas) == primaries and all(m["source_video"].endswith("/front.mp4") for m in metas.values())
    _, embs, _ = cs.split_outputs(mc_out, "video-embed-tpu")
    assert sorted(embs) == primaries
    cs.check_unit_embeddings(embs, next(iter(embs.values())).shape[0], "av multicam")
    assert mc["launches"]["flash"] > 0, "av: the multicam split launched no flash"
    resumed = cs.split_run(dev, a, None, stage_classes)
    assert resumed["summary"]["num_videos"] == 0 and not discover_multicam_tasks(str(mc_in), str(mc_out))
    try:
        split.run_split(dataclasses.replace(a, splitting_algorithm="transnetv2",
                                            output_path=str(root / "av_multicam_shots")))
        raise AssertionError("a multicam split by shot detection ran")
    except ValueError as e:
        assert "fixed-stride only" in str(e), e
    multicam = {"wall_s": mc["wall"], "videos": summary["num_videos"], "primary_clips": summary["num_clips"],
                "clips_by_camera": {k: len(v) for k, v in per_camera.items()},
                "num_transcoded": summary["num_transcoded"], "launches": mc["launches"],
                "resumed_wall_s": resumed["wall"], "transnetv2_raises": True,
                "video_hours_per_day_per_chip": summary["video_hours_per_day_per_chip"]}

    # 2. the AV steps through `local av`
    out = root / "av_out"
    db = str(out / "av_state.sqlite")
    steps: dict[str, dict] = {}
    steps["ingest"] = av_step("ingest", av_in, out)
    steps["split"] = av_step("split", av_in, out)
    assert steps["ingest"]["num_sessions"] == 2 and steps["split"]["num_clips"] == AV_CLIPS, steps["split"]
    sqlite_rows, sqlite_encoded = state_rows(db, out)
    sqlite_tables = cli(["postgres", "show-tables", "--db", db])["text"]

    caption_launches: dict = {}
    captioned: dict = {}
    with cs.counted_launches(caption_launches), cs.recorded_flash_shapes(shapes):
        prof = profiled(lambda: captioned.update(av_step(
            "caption", av_in, out, "--limit", str(AV_CAPTION_LIMIT), "--caption-variants", AV_VARIANTS)))
    steps["caption"] = captioned
    assert captioned["num_captioned"] == AV_CAPTION_LIMIT and captioned["num_windows"] == 2 * AV_CAPTION_LIMIT
    for name in AV_KERNELS:
        assert caption_launches[name] > 0, f"av: the caption step launched no {name}"
    # the rest of the clips, the primary variant only (one batch of 7
    # requests), then the resume: nothing left, so no engine and no launch
    steps["caption_rest"] = av_step("caption", av_in, out, "--caption-variants", AV_VARIANTS.split(",")[0])
    assert steps["caption_rest"]["num_captioned"] == AV_CLIPS - AV_CAPTION_LIMIT, steps["caption_rest"]
    again_launches: dict = {}
    with cs.counted_launches(again_launches):
        steps["caption_again"] = av_step("caption", av_in, out, "--limit", str(AV_CAPTION_LIMIT),
                                         "--caption-variants", AV_VARIANTS)
    assert steps["caption_again"]["num_captioned"] == 0 and not any(again_launches.values()), again_launches

    devices: list = []
    with trajectory_devices(devices):
        steps["trajectory"] = av_step("trajectory", av_in, out)
    assert steps["trajectory"]["num_trajectories"] == AV_CLIPS and devices and set(devices) == {"cuda:0"}, devices
    clip0 = sorted((out / "clips").glob("*.mp4"))[0].read_bytes()
    frames = extract_frames_at_fps(clip0, target_fps=trajectory.TRAJECTORY_FPS, resize_hw=trajectory.TRAJECTORY_HW)
    gray = torch.from_numpy(frames.astype(np.float32).mean(axis=-1) / 255.0).to(dev)
    traj_ms = timer(lambda: trajectory.phase_correlate_pairs(gray))
    cpu_steps = trajectory.phase_correlate_pairs(gray.cpu())
    assert torch.equal(trajectory.phase_correlate_pairs(gray).cpu(), cpu_steps), "av: trajectory card vs CPU"

    steps["annotate"] = av_step("annotate", av_in, out)
    t5_calls: list = []
    encoder_cls = av.T5EncoderTPU

    class ProfiledT5(encoder_cls):
        """The package step's encoder, each encode call under the profiler."""

        def encode(self, texts):
            got: dict = {}
            t5_calls.append(profiled(lambda: got.update(out=super(ProfiledT5, self).encode(texts))))
            return got["out"]

    av.T5EncoderTPU = ProfiledT5
    try:
        packaged = steps["package"] = av_step("package", av_in, out)
    finally:
        av.T5EncoderTPU = encoder_cls
    assert t5_calls, "av: the package step encoded nothing"
    assert packaged["num_packaged"] == AV_CLIPS and steps["annotate"]["metas"] == AV_CLIPS
    steps["shard"] = av_step("shard", av_in, out)
    t0 = time.monotonic()
    packs = av.run_av_shard(av.AVPipelineArgs(input_path=str(av_in), output_path=str(out), clip_len_s=AV_CLIP_LEN_S,
                                              t5_packaging="e", clip_packaging=True))
    walls["shard_with_packaging"] = time.monotonic() - t0
    assert packs["num_t5_tars"] >= 1 and packs["num_clip_tars"] >= 1 and packs["num_samples"] == AV_CLIPS, packs
    e_tars = sorted((out / "datasets" / "av-dataset" / "t5_xxl").glob("*.tar"))
    clip_tars = sorted((out / "datasets" / "av-dataset" / "clips").glob("*.tar"))
    assert len(e_tars) == packs["num_t5_tars"] and all(n.endswith((".bin", ".json")) for n in tar_names(e_tars[0]))
    assert any(n.endswith(".mp4") for n in tar_names(clip_tars[0]))

    # 3. the same ingest and split on PostgreSQL (the fake server)
    pg_out = root / "av_pg_out"
    with FakePgServer(auth="scram") as srv:
        steps["pg_ingest"] = av_step("ingest", av_in, pg_out, "--db-path", srv.dsn)
        steps["pg_split"] = av_step("split", av_in, pg_out, "--db-path", srv.dsn)
        update = cli(["postgres", "update-schemas", "--db", srv.dsn])
        pg_tables = cli(["postgres", "show-tables", "--db", srv.dsn])["text"]
        pg_rows, pg_encoded = state_rows(srv.dsn, pg_out)
        queries = len(srv.queries)
    assert pg_rows == sqlite_rows, "av: the postgres rows differ from the sqlite run's"
    assert set(pg_encoded) == set(sqlite_encoded)
    # mp4v (cv2's codec, the one the H100 host has) repeats itself bit for bit
    same_bytes = sum(pg_encoded[c] == sqlite_encoded[c] for c in pg_encoded)
    assert same_bytes == len(pg_encoded) or any(e != "mp4v" for e, _, _ in pg_encoded.values())
    assert pg_tables == sqlite_tables and update["text"].startswith("schema up to date"), (pg_tables, sqlite_tables)

    return dict(
        multicam=multicam,
        steps={name: {k: v for k, v in s.items() if k != "buckets"} for name, s in steps.items()},
        caption={"tokens_per_s": captioned["tokens_per_s"], "requests": 2 * AV_CAPTION_LIMIT,
                 "launches": caption_launches, "device_idle_share": prof["device_idle_share"],
                 "device_busy_s": prof["device_busy_s"], "traced_wall_s": prof["traced_wall_s"],
                 "device_launches": prof["launches"]},
        trajectory={"ms_per_clip_device": traj_ms, "frames": list(frames.shape),
                    "wall_ms_per_clip": 1e3 * steps["trajectory"]["wall_s"] / steps["trajectory"]["num_trajectories"],
                    "calls_on": sorted(set(devices)), "card_equals_cpu": True},
        t5={"device_ms": 1e3 * sum(c["device_busy_s"] for c in t5_calls),
            "encode_wall_ms": 1e3 * sum(c["traced_wall_s"] for c in t5_calls), "encode_calls": len(t5_calls),
            "device_launches": sum(c["launches"] for c in t5_calls), "texts": packaged["num_packaged"],
            "step_wall_s": packaged["wall_s"]},
        packaging={k: packs[k] for k in ("num_t5_tars", "num_clip_tars", "num_samples")},
        postgres={"rows_equal_sqlite": True, "tables": pg_tables.strip().splitlines(), "queries": queries,
                  "encoders": sorted({e for e, _, _ in pg_encoded.values()}),
                  "spans_with_the_sqlite_runs_bytes": same_bytes, "spans": len(pg_encoded)},
        walls={**walls, **{name: s["wall_s"] for name, s in steps.items()}},
        flash_checked_here=cs.check_new_flash_shapes(timer, shapes, SEED),
    )


def run(cs, dev, timer, root: Path, corpus: list[Path]) -> dict:
    """The phase, its line emitted as it ends; returns the record."""
    t0 = time.monotonic()
    record = {**drive_av(cs, dev, timer, root, corpus), "phase_s": time.monotonic() - t0, "card": cs.card_line()}
    cs.emit({"phase": "av", **record})
    print(f"av: multicam split {record['multicam']['wall_s']:.3f} s; caption {record['caption']['tokens_per_s']:.1f} "
          f"tok/s (idle {record['caption']['device_idle_share']:.3f}); trajectory "
          f"{record['trajectory']['ms_per_clip_device']:.4f} ms a clip on the card; T5 {record['t5']['device_ms']:.2f} "
          f"device ms; phase {record['phase_s']:.1f} s", flush=True)
    return record


def main() -> int:
    if not torch.cuda.is_available():
        print("av_phase: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.getcwd())
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import pyarrow.parquet  # noqa: F401  (main thread first: see remote_phase.main)

    import chip_smoke as cs

    dev = torch.device("cuda", 0)
    started = time.monotonic()
    timer, build_s = cs.phase_prologue(dev)
    with cs.split_corpus(AV_VIDEOS) as (root, corpus, corpus_s):
        cs.emit({"phase": "av_prologue", "build_s": build_s, "corpus_build_s": corpus_s})
        run(cs, dev, timer, root, corpus)
    cs.emit({"phase": "timing", "script_s": time.monotonic() - started})
    return 0


if __name__ == "__main__":
    sys.exit(main())
