"""Port parity: split assembly, module by module and through ``run_split``.

The videos are ``tests/fixtures/media.make_scene_video``'s (96x64 at 24 fps,
one second a scene), as in ``tests/pipelines/test_split_pipeline.py``. Each
test runs the same inputs through the JAX package and the port.

Codecs: both packages encode clips through the native H.264 writer where
it builds (libavcodec, libx264 and their headers), else through cv2's
negotiated codec. libx264 does not repeat itself: encoding the same frames
twice in one process can give other bytes, and now and then other pixels
in a macroblock, in either package. So the tests run on
cv2's codec (the module forces it in both packages; ``mp4v`` repeats bit
for bit), and the native writer's own tests skip where it does not build.

Tolerances:
- spans, clip uuids, metadata, timestamps, chunk layouts, summary counts,
  output file names and clip metas: exactly equal;
- extracted frames, clip bytes and the frames decoded from each clip on
  cv2's codec: bit-equal;
- on the native writer: the same codec in the metas, the same frame
  counts, and decoded frames within ``NATIVE_TOL`` mean absolute levels of
  the JAX package's (well below the codec's own loss against the source
  frames, and above what its run-to-run wobble gives);
- embeddings: within the embed stage's bf16 bound of 2e-2
  (``test_torch_embedder.py``);
- captions: the rule of ``test_torch_engine.py`` (bf16 logits within
  ``LOGIT_TOL`` at every compared step; a window's comparison stops at a
  JAX top-2 margin below ``2 * LOGIT_TOL``, where either token could win).

Both packages' ``run_split`` write ``report/live/status.json`` (the live
status) on every run, so file-name comparisons take it in like any other
file. With ``tracing`` both write ``profile/traces/driver.ndjson`` and
``report/run_report.json``: the traced split holds the span names, the
report's sections, the dispatch counts and the caption-phase keys against
the JAX package's.
"""

from __future__ import annotations

import dataclasses
import functools
import io
import json
from pathlib import Path

import cv2
import numpy as np
import pyarrow.parquet as pq
import pytest

import jax
import jax.numpy as jnp

from cosmos_curate_tpu.core.pipeline import PipelineConfig as JPipelineConfig
from cosmos_curate_tpu.core.pipelined_runner import PipelinedRunner as JPipelinedRunner
from cosmos_curate_tpu.core.runner import SequentialRunner as JSequentialRunner
from cosmos_curate_tpu.core.stage import WorkerMetadata as JWorkerMetadata
from cosmos_curate_tpu.data import model as jdata
from cosmos_curate_tpu.models import clip as jclip_model
from cosmos_curate_tpu.models import embedder as jemb
from cosmos_curate_tpu.models import registry as jregistry
from cosmos_curate_tpu.models import transnetv2 as jtn
from cosmos_curate_tpu.models import vit as jvit
from cosmos_curate_tpu.models.vlm import SharedCaptionEngine as JShared
from cosmos_curate_tpu.models.vlm import VLM_TINY_TEST as J_TINY
from cosmos_curate_tpu.models.vlm import CaptionEngine as JEngine
from cosmos_curate_tpu.pipelines.video import split as jsplit
from cosmos_curate_tpu.pipelines.video.stages import captioning as jcap
from cosmos_curate_tpu.pipelines.video.stages import clip_extraction as jclip
from cosmos_curate_tpu.pipelines.video.stages import embedding as jembed
from cosmos_curate_tpu.pipelines.video.stages import shot_detection as jshot
from cosmos_curate_tpu.video import decode as jdecode
from cosmos_curate_tpu.video import encode as jencode
from cosmos_curate_tpu.video import splitter as jsplitter
from cosmos_curate_tpu_torch.core.pipeline import PipelineConfig
from cosmos_curate_tpu_torch.core.pipelined_runner import PipelinedRunner
from cosmos_curate_tpu_torch.core.runner import SequentialRunner, default_runner
from cosmos_curate_tpu_torch.data import model as tdata
from cosmos_curate_tpu_torch.models import clip as tclip_model
from cosmos_curate_tpu_torch.models import embedder as temb
from cosmos_curate_tpu_torch.models import transnetv2 as ttn
from cosmos_curate_tpu_torch.models.convert_jax import flax_to_state_dict
from cosmos_curate_tpu_torch.models.vlm import SharedCaptionEngine
from cosmos_curate_tpu_torch.pipelines.video import split as tsplit
from cosmos_curate_tpu_torch.pipelines.video.input_discovery import discover_split_tasks
from cosmos_curate_tpu_torch.pipelines.video.stages import captioning as tcap
from cosmos_curate_tpu_torch.pipelines.video.stages import clip_extraction as tclip
from cosmos_curate_tpu_torch.pipelines.video.stages import embedding as tembed
from cosmos_curate_tpu_torch.pipelines.video.stages import shot_detection as tshot
from cosmos_curate_tpu_torch.video import decode as tdecode
from cosmos_curate_tpu_torch.video import encode as tencode
from cosmos_curate_tpu_torch.video import splitter as tsplitter
from cosmos_curate_tpu_torch.video.h264 import h264_available
from tests.fixtures.media import make_scene_video
from tests.fixtures.observability import observability_state, preserved_observability_state  # noqa: F401
from tests.test_torch_engine import LOGIT_TOL, _record_logits

EMBED_TOL = 2e-2
CAPTION_MODEL_ID = "caption-vlm-tpu"
EMBED_MODEL_ID = "video-embed-tpu"
SPLIT = dict(fixed_stride_len_s=1.0, min_clip_len_s=0.5)
NATIVE_TOL = 0.3
# summary keys that depend on the clock
CLOCK_KEYS = ("timestamp", "pipeline_run_time_s", "video_hours_per_day_per_chip")


@pytest.fixture(scope="module", autouse=True)
def _cv2_codec():
    """Both packages on cv2's negotiated codec, which repeats itself."""
    from cosmos_curate_tpu.video import h264 as jh264
    from cosmos_curate_tpu_torch.video import h264 as th264

    mp = pytest.MonkeyPatch()
    mp.setattr(jh264, "_probe_result", False)
    mp.setattr(th264, "_probe_result", False)
    yield
    mp.undo()


@pytest.fixture
def native_codec(monkeypatch):
    """Both packages on their native H.264 writers (probed afresh); skips
    where the reference's does not build."""
    from cosmos_curate_tpu.video import h264 as jh264
    from cosmos_curate_tpu_torch.video import h264 as th264

    monkeypatch.setattr(jh264, "_probe_result", None)
    monkeypatch.setattr(th264, "_probe_result", None)
    if not jh264.h264_available():
        pytest.skip("the native H.264 writer does not build here (it needs libavcodec, libx264 and their headers)")
    assert th264.h264_available(), th264.h264_status()
    return "avc1"


@pytest.fixture(autouse=True)
def _default_runner_env(monkeypatch):
    monkeypatch.delenv("CURATE_RUNNER", raising=False)
    monkeypatch.delenv("CURATE_ENGINE_DRIVER_PORT", raising=False)
    monkeypatch.delenv(tsplit.HEALTH_GATE_ENV, raising=False)


@pytest.fixture(scope="module")
def videos(tmp_path_factory) -> Path:
    """Three videos of 2, 2 and 3 one-second scenes, and a file that is
    not a video."""
    d = tmp_path_factory.mktemp("videos")
    for i, scenes in enumerate((2, 2, 3)):
        make_scene_video(d / f"video_{i}.mp4", scene_len_frames=24, num_scenes=scenes)
    (d / "not_a_video.txt").write_text("x")
    return d


def _runner(name: str):
    runner = SequentialRunner() if name == "sequential" else default_runner()
    assert isinstance(runner, SequentialRunner if name == "sequential" else PipelinedRunner)
    return runner


def _files(out: Path) -> set[str]:
    return {str(p.relative_to(out)) for p in out.rglob("*") if p.is_file()}


def _frames(source) -> np.ndarray:
    """Every frame of an mp4 (path or bytes), BGR, as cv2 decodes it."""
    with tdecode._open_capture(source) as cap:
        out = []
        while True:
            ok, frame = cap.read()
            if not ok:
                break
            out.append(frame)
    return np.stack(out)


def _assert_native_frames_close(t_frames: np.ndarray, j_frames: np.ndarray) -> None:
    assert t_frames.shape == j_frames.shape
    assert np.abs(t_frames.astype(np.int16) - j_frames.astype(np.int16)).mean() <= NATIVE_TOL


def _counts(summary: dict) -> dict:
    return {k: v for k, v in summary.items() if k not in CLOCK_KEYS}


def _metas(out: Path) -> dict[str, dict]:
    return {p.stem: json.loads(p.read_text()) for p in (out / "metas" / "v0").glob("*.json")}


# -- (a) module by module ------------------------------------------------------


@pytest.mark.parametrize(
    "duration,clip_len,stride,min_len",
    [(2.0, 1.0, None, 0.5), (3.0, 1.0, None, 0.5), (10.5, 2.0, None, 1.0), (10.5, 2.0, 1.5, 0.6), (0.4, 1.0, None, 0.5)],
)
def test_spans_and_clip_ids_match_jax(duration, clip_len, stride, min_len):
    kw = dict(clip_len_s=clip_len, stride_s=stride, min_clip_len_s=min_len)
    spans = tsplitter.fixed_stride_spans(duration, **kw)
    assert spans == jsplitter.fixed_stride_spans(duration, **kw)
    t_clips = tsplitter.make_clips("in/v.mp4", spans)
    j_clips = jsplitter.make_clips("in/v.mp4", spans)
    assert [(c.uuid, c.span, c.source_video) for c in t_clips] == [(c.uuid, c.span, c.source_video) for c in j_clips]


@pytest.mark.parametrize("as_bytes", [False, True])
def test_metadata_and_timestamps_match_jax(videos, as_bytes):
    for path in sorted(videos.glob("*.mp4")):
        src = path.read_bytes() if as_bytes else str(path)
        assert dataclasses.asdict(tdecode.extract_video_metadata(src)) == dataclasses.asdict(
            jdecode.extract_video_metadata(src))
        t_ts, j_ts = tdecode.get_frame_timestamps(src), jdecode.get_frame_timestamps(src)
        assert t_ts.dtype == j_ts.dtype and np.array_equal(t_ts, j_ts)


@pytest.mark.parametrize("resize", [None, (32, 32)])
def test_extract_frames_multi_is_bit_equal(videos, resize):
    src = (videos / "video_2.mp4").read_bytes()
    sigs_t = (tdata.FrameExtractionSignature("fps", 8.0), tdata.FrameExtractionSignature("fps", 2.0),
              tdata.FrameExtractionSignature("fps", 8.0))
    sigs_j = tuple(jdata.FrameExtractionSignature(s.policy, s.target_fps) for s in sigs_t)
    got = tdecode.extract_frames_multi(src, sigs_t, resize_hw=resize)
    want = jdecode.extract_frames_multi(src, sigs_j, resize_hw=resize)
    assert set(got) == set(want) == {"fps-8", "fps-2"}
    for key in want:
        assert got[key].dtype == np.uint8 and got[key].shape[0] > 0
        assert np.array_equal(got[key], want[key]), key


@pytest.mark.parametrize("codec", ["cv2", "native"])
@pytest.mark.parametrize("timestamps", [True, False])
def test_transcode_clips_match_jax(videos, timestamps, codec, request):
    if codec == "native":
        request.getfixturevalue("native_codec")
    src = (videos / "video_2.mp4").read_bytes()
    spans = [(0.0, 1.0), (1.0, 2.0), (0.5, 2.5), (2.0, 3.0), (3.5, 4.0)]  # overlapping, and one past the end
    ts = tdecode.get_frame_timestamps(src) if timestamps else None
    got = tencode.transcode_clips(src, spans, timestamps_s=ts)
    want = jencode.transcode_clips(src, spans, timestamps_s=ts)
    assert tencode.negotiated_codec() == jencode.negotiated_codec()
    assert [c for _, c in got] == [c for _, c in want] == [tencode.negotiated_codec()] * len(spans)
    assert (got[0][1] == "avc1") == (codec == "native")
    assert got[-1][0] == b"" and want[-1][0] == b""
    for (a, b), (t_data, _), (j_data, _) in zip(spans, got[:-1], want[:-1]):
        t_frames, j_frames = _frames(t_data), _frames(j_data)
        assert t_frames.shape[0] == round((b - a) * 24)
        if codec == "native":
            _assert_native_frames_close(t_frames, j_frames)
        else:
            assert t_data == j_data and np.array_equal(t_frames, j_frames)


def test_native_writer_status_matches_the_reference(native_codec):
    from cosmos_curate_tpu_torch.video.h264 import h264_status

    assert h264_available() and h264_status() == "available"
    assert tencode.negotiated_codec() == jencode.negotiated_codec() == native_codec


def test_encode_frames_matches_jax():
    frames = np.random.default_rng(3).integers(0, 256, (12, 48, 64, 3), np.uint8)
    got, want = tencode.encode_frames(frames, 24.0), jencode.encode_frames(frames, 24.0)
    assert got == want and _frames(got).shape == (12, 48, 64, 3)


@pytest.mark.parametrize(
    "path,prefix",
    [("in/a/b.mp4", "in"), ("in/a/b.mp4", "in/"), ("./in/b.mp4", "in"), ("other/b.mp4", "in"),
     ("s3://bkt/in/b.mp4", "s3://bkt/in"), ("s3://bkt/x/b.mp4", "s3://bkt/in"), ("gs://b/v.mp4", "gs://b/")],
)
def test_storage_paths_match_jax(path, prefix):
    from cosmos_curate_tpu.storage import client as jclient
    from cosmos_curate_tpu_torch.storage import client as tclient

    assert tclient.relative_to_prefix(path, prefix) == jclient.relative_to_prefix(path, prefix)
    assert tclient.is_remote_path(path) == jclient.is_remote_path(path)


def test_writers_match_jax(tmp_path):
    import uuid

    from cosmos_curate_tpu.storage import writers as jwriters
    from cosmos_curate_tpu_torch.storage import writers as twriters

    obj = {"a": np.float32(0.5), "b": np.int64(3), "c": np.arange(3), "d": uuid.uuid5(uuid.NAMESPACE_URL, "x")}
    twriters.write_json(str(tmp_path / "t" / "m.json"), obj)
    jwriters.write_json(str(tmp_path / "j" / "m.json"), obj)
    assert (tmp_path / "t" / "m.json").read_bytes() == (tmp_path / "j" / "m.json").read_bytes()
    cols = {"clip_uuid": ["u0", "u1"], "embedding": [[0.25, 0.5], [1.0, -2.0]]}
    twriters.write_parquet(str(tmp_path / "t" / "e.parquet"), cols)
    jwriters.write_parquet(str(tmp_path / "j" / "e.parquet"), cols)
    assert pq.read_table(tmp_path / "t" / "e.parquet").equals(pq.read_table(tmp_path / "j" / "e.parquet"))
    assert not list(tmp_path.rglob("*.tmp"))  # the writes land through an atomic rename


def test_weights_provenance_matches_jax(tmp_path, monkeypatch):
    from cosmos_curate_tpu_torch.models import registry as tregistry

    monkeypatch.setenv(jregistry.WEIGHTS_DIR_ENV, str(tmp_path))
    assert tregistry.weights_provenance("no-such-model") == jregistry.weights_provenance("no-such-model") == "random"
    ckpt = tmp_path / "some-model" / "params.msgpack"
    ckpt.parent.mkdir()
    ckpt.write_bytes(b"\x80" * 1000)
    got = tregistry.weights_provenance("some-model")
    assert got == jregistry.weights_provenance("some-model") and got.startswith("checkpoint:")


@pytest.mark.parametrize("n_clips,chunk_size", [(10, 4), (4, 2), (3, 64), (5, 0), (1, 1)])
def test_chunk_split_task_matches_jax(n_clips, chunk_size):
    def chunks(data, mod):
        video = data.Video(path="v.mp4", clips=[data.Clip(span=(float(i), i + 1.0)) for i in range(n_clips)],
                           num_total_clips=n_clips, errors={"x": "y"})
        return mod.chunk_split_task(data.SplitPipeTask(video=video), chunk_size)

    got, want = chunks(tdata, tclip), chunks(jdata, jclip)
    assert sum(t.fraction for t in got) == pytest.approx(1.0)
    layout = lambda ts: [(t.video.clip_chunk_index, t.video.num_clip_chunks, t.video.num_total_clips,  # noqa: E731
                          [c.span for c in t.video.clips], t.video.errors, t.fraction) for t in ts]
    assert layout(got) == layout(want)
    if len(got) > 1:
        assert got[0].video is not got[1].video and got[0].stage_perf is not got[1].stage_perf


def test_split_args_mirror_the_reference_field_for_field():
    port = {f.name: f for f in dataclasses.fields(tsplit.SplitPipelineArgs)}
    ref = {f.name: f for f in dataclasses.fields(jsplit.SplitPipelineArgs)}
    assert set(port) == set(ref) | {"device"}
    t_args, j_args = tsplit.SplitPipelineArgs(), jsplit.SplitPipelineArgs()
    for name in ref:
        assert getattr(t_args, name) == getattr(j_args, name), name
    assert t_args.device == "cuda"


# -- (b) split only ------------------------------------------------------------


def _jax_split(videos: Path, out: Path) -> dict:
    return jsplit.run_split(jsplit.SplitPipelineArgs(input_path=str(videos), output_path=str(out), **SPLIT),
                            runner=JSequentialRunner())


@pytest.fixture(scope="module")
def jax_split(videos, tmp_path_factory) -> tuple[Path, dict]:
    out = tmp_path_factory.mktemp("jax_split") / "out"
    with preserved_observability_state():
        return out, _jax_split(videos, out)


@pytest.mark.parametrize("codec", ["cv2", "native"])
@pytest.mark.parametrize("runner", ["sequential", "default"])
def test_split_only_matches_jax(videos, jax_split, runner, codec, tmp_path, request):
    if codec == "native":
        request.getfixturevalue("native_codec")
        j_out = tmp_path / "jout"
        j_summary = _jax_split(videos, j_out)
    else:
        j_out, j_summary = jax_split
    out = tmp_path / "out"
    args = tsplit.SplitPipelineArgs(input_path=str(videos), output_path=str(out), **SPLIT)
    summary = tsplit.run_split(args, runner=_runner(runner))

    assert _counts(summary) == _counts(j_summary)
    assert summary["num_videos"] == 3 and summary["num_clips"] == summary["num_transcoded"] == 7
    assert json.loads((out / "summary.json").read_text()) == summary
    assert _files(out) == _files(j_out)
    metas, j_metas = _metas(out), _metas(j_out)
    assert len(metas) == 7
    for uuid, meta in j_metas.items():
        assert list(metas[uuid]) == list(meta)  # key order too
        assert metas[uuid] == meta, uuid
        assert meta["codec"] == ("avc1" if codec == "native" else tencode._pick_codec())
        clip, j_clip = out / "clips" / f"{uuid}.mp4", j_out / "clips" / f"{uuid}.mp4"
        if codec == "native":
            _assert_native_frames_close(_frames(str(clip)), _frames(str(j_clip)))
        else:
            assert clip.read_bytes() == j_clip.read_bytes()
    for rec in (out / "processed_videos").rglob("*.json"):
        assert json.loads(rec.read_text()) == json.loads((j_out / rec.relative_to(out)).read_text())

    # resume: a re-run discovers nothing and writes an empty summary
    assert discover_split_tasks(str(videos), str(out)) == []
    again = tsplit.run_split(args, runner=_runner(runner))
    assert again["num_videos"] == 0 and again["num_clips"] == 0


@pytest.mark.parametrize("runner", ["sequential", "default"])
def test_bad_input_is_contained(tmp_path, runner):
    vids = tmp_path / "in"
    vids.mkdir()
    make_scene_video(vids / "good.mp4", scene_len_frames=24, num_scenes=1)
    (vids / "broken.mp4").write_bytes(b"garbage garbage garbage")
    j_summary = jsplit.run_split(
        jsplit.SplitPipelineArgs(input_path=str(vids), output_path=str(tmp_path / "jout"), **SPLIT),
        runner=JSequentialRunner())
    summary = tsplit.run_split(
        tsplit.SplitPipelineArgs(input_path=str(vids), output_path=str(tmp_path / "out"), **SPLIT),
        runner=_runner(runner))
    assert _counts(summary) == _counts(j_summary)
    assert summary["num_videos"] == 2 and summary["num_errors"] >= 1 and summary["num_transcoded"] == 1
    assert _files(tmp_path / "out") == _files(tmp_path / "jout")


# -- (c) split + embed + caption at tiny size ----------------------------------

CAPTIONED = dict(SPLIT, extract_fps=(8.0,), extract_resize_hw=(32, 32), captioning=True, caption_model="tiny-test")


@pytest.fixture(scope="module")
def annotate_videos(tmp_path_factory) -> Path:
    d = tmp_path_factory.mktemp("annotate_videos")
    for i, scenes in enumerate((2, 3, 3)):
        make_scene_video(d / f"video_{i}.mp4", scene_len_frames=24, num_scenes=scenes)
    return d


@pytest.fixture(scope="module")
def jax_annotated(annotate_videos, tmp_path_factory):
    """The JAX run_split with the tiny embed stage in ``extra_stages`` and
    tiny-test captions, from the caption checkpoint it writes; yields that
    weights root, the embedder's seeded params, the output and the logits
    of every caption's greedy steps."""
    root = tmp_path_factory.mktemp("weights")
    out = tmp_path_factory.mktemp("jax_annotated") / "out"
    mp = pytest.MonkeyPatch()
    mp.setenv(jregistry.WEIGHTS_DIR_ENV, str(root))
    JShared.reset()
    try:
        with preserved_observability_state():
            eng = JEngine(J_TINY, max_batch=2)
            eng.setup(9)
            jregistry.save_params(CAPTION_MODEL_ID, eng.params, root=root)
            eng.shutdown()
            sig = jdata.FrameExtractionSignature("fps", 8.0)
            embed = jembed.ClipEmbeddingStage(variant="video", video_cfg=jemb.VIDEO_EMBED_TINY_TEST, extraction=sig)
            embed.setup(JWorkerMetadata())  # the stage's seeded init, carried to the port below
            traced = jcap.CaptionStage(model_flavor="tiny-test")
            traced.model.setup()  # the shared engine the split's caption stage joins
            trace = _record_logits(traced.model.engine)
            summary = jsplit.run_split(
                jsplit.SplitPipelineArgs(input_path=str(annotate_videos), output_path=str(out), extra_stages=[embed],
                                         **CAPTIONED),
                runner=JSequentialRunner())
        yield root, flax_to_state_dict(embed.model._params), out, summary, dict(trace)
    finally:
        JShared.reset()
        mp.undo()


def _embeddings(out: Path, model_id: str = EMBED_MODEL_ID) -> dict[str, np.ndarray]:
    rows = {}
    for path in (out / "embeddings" / model_id).glob("*.parquet"):
        table = pq.read_table(path).to_pydict()
        for uuid, emb in zip(table["clip_uuid"], table["embedding"]):
            rows[uuid] = np.asarray(emb, np.float32)
    return rows


@pytest.mark.parametrize("runner", ["sequential", "default"])
def test_split_embed_caption_matches_jax(annotate_videos, jax_annotated, runner, tmp_path, monkeypatch):
    root, embed_params, j_out, j_summary, j_trace = jax_annotated
    monkeypatch.setenv(jregistry.WEIGHTS_DIR_ENV, str(root))
    out = tmp_path / "out"
    SharedCaptionEngine.reset()
    try:
        sig = tdata.FrameExtractionSignature("fps", 8.0)
        embed = tembed.ClipEmbeddingStage(variant="video", video_cfg=temb.VIDEO_EMBED_TINY_TEST, extraction=sig,
                                          params=embed_params, device="cpu")
        traced = tcap.CaptionStage(model_flavor="tiny-test", device="cpu")
        traced.model.setup()
        trace = _record_logits(traced.model.engine)
        summary = tsplit.run_split(
            tsplit.SplitPipelineArgs(input_path=str(annotate_videos), output_path=str(out), extra_stages=[embed],
                                     device="cpu", **CAPTIONED),
            runner=_runner(runner))
    finally:
        SharedCaptionEngine.reset()

    assert _counts(summary) == _counts(j_summary)
    assert summary["num_clips"] == summary["num_with_embeddings"] == summary["num_with_captions"] == 8
    assert summary["weights_provenance"] == {EMBED_MODEL_ID: "random"}
    assert _files(out) == _files(j_out)
    embs, j_embs = _embeddings(out), _embeddings(j_out)
    assert set(embs) == set(j_embs) and len(embs) == 8
    for uuid, j_emb in j_embs.items():
        np.testing.assert_allclose(embs[uuid], j_emb, atol=EMBED_TOL)
    metas, j_metas = _metas(out), _metas(j_out)
    assert set(metas) == set(j_metas)
    compared = 0
    for uuid, j_meta in j_metas.items():
        meta = metas[uuid]
        assert list(meta) == list(j_meta)
        captions = [w.pop("captions") for w in meta["windows"]]
        j_captions = [w.pop("captions") for w in j_meta["windows"]]
        assert meta == j_meta, uuid
        assert len(captions) == len(j_captions) == 1
        for i, (text, j_text) in enumerate(zip(captions, j_captions)):
            assert text["default"]
            rid = f"{uuid}-{i}"
            full = True
            for step, (j, p) in enumerate(zip(j_trace[rid], trace[rid], strict=True)):
                assert np.abs(j - p).max() <= LOGIT_TOL, (rid, step)
                top2 = np.sort(j)[-2:]
                if top2[1] - top2[0] < 2 * LOGIT_TOL:
                    full = False
                    break
                assert int(np.argmax(j)) == int(np.argmax(p)), (rid, step)
                compared += 1
            if full:
                assert text == j_text, rid
    assert compared >= len(metas)  # greedy steps held to the rule: 17 of them here


def _trace_summary(out: Path) -> dict:
    """What a traced split left: its span names, run report, dispatch
    counts and caption-phase keys, and its live status."""
    spans = [json.loads(line) for f in (out / "profile").rglob("*.ndjson") for line in f.read_text().splitlines()]
    report = json.loads((out / "report" / "run_report.json").read_text())
    return dict(
        names={s["name"] for s in spans}, report=report,
        dispatch={name: (agg["dispatches"], agg["rows"]) for name, agg in report["dispatch"].items()},
        caption={name: sorted(agg) for name, agg in report["caption_phases"].items()},
        status=json.loads((out / "report" / "live" / "status.json").read_text()),
    )


@pytest.fixture(scope="module")
def jax_traced(annotate_videos, jax_annotated, tmp_path_factory) -> dict:
    """The JAX run_split of ``jax_annotated``'s settings with ``tracing``,
    through each of its in-process runners: runner -> trace summary."""
    mp = pytest.MonkeyPatch()
    mp.setenv(jregistry.WEIGHTS_DIR_ENV, str(jax_annotated[0]))
    runs = {}
    try:
        for runner in ("sequential", "default"):
            out = tmp_path_factory.mktemp(f"jax_traced_{runner}") / "out"
            sig = jdata.FrameExtractionSignature("fps", 8.0)
            embed = jembed.ClipEmbeddingStage(variant="video", video_cfg=jemb.VIDEO_EMBED_TINY_TEST, extraction=sig)
            JShared.reset()
            with preserved_observability_state():
                jsplit.run_split(
                    jsplit.SplitPipelineArgs(input_path=str(annotate_videos), output_path=str(out),
                                             extra_stages=[embed], tracing=True, **CAPTIONED),
                    runner=JSequentialRunner() if runner == "sequential" else JPipelinedRunner(raise_on_error=False))
            runs[runner] = _trace_summary(out)
    finally:
        JShared.reset()
        mp.undo()
    return runs


@pytest.mark.parametrize("runner", ["sequential", "default"])
def test_traced_split_matches_jax(annotate_videos, jax_annotated, jax_traced, runner, tmp_path, monkeypatch):
    """``tracing=True``, refused by earlier slices, runs: the same span
    names, report sections, dispatch counts and caption-phase keys as the
    JAX package's traced split through the same kind of runner."""
    root, embed_params, *_ = jax_annotated
    monkeypatch.setenv(jregistry.WEIGHTS_DIR_ENV, str(root))
    out = tmp_path / "out"
    SharedCaptionEngine.reset()
    try:
        sig = tdata.FrameExtractionSignature("fps", 8.0)
        embed = tembed.ClipEmbeddingStage(variant="video", video_cfg=temb.VIDEO_EMBED_TINY_TEST, extraction=sig,
                                          params=embed_params, device="cpu")
        summary = tsplit.run_split(
            tsplit.SplitPipelineArgs(input_path=str(annotate_videos), output_path=str(out), extra_stages=[embed],
                                     device="cpu", tracing=True, **CAPTIONED),
            runner=_runner(runner))
    finally:
        SharedCaptionEngine.reset()
    assert summary["num_clips"] == summary["num_with_embeddings"] == summary["num_with_captions"] == 8
    from cosmos_curate_tpu_torch.observability import tracing as ttracing

    assert not ttracing.tracing_enabled() and ttracing._process_parent is None
    got, want = _trace_summary(out), jax_traced[runner]
    assert got["names"] == want["names"]
    assert {"run.split", "pipeline.run", "stage.ClipEmbeddingStage.process", "device.embed/video-embed-tpu.drain",
            "caption.submit", "caption.engine", "storage.write"} <= got["names"]
    report = got["report"]
    assert set(report) == set(want["report"])
    assert report["connected"] and want["report"]["connected"] and report["span_count"] > 0
    assert report["dead_lettered"] == 0 and report["critical_path"][0]["name"] == "run.split"
    # one embed dispatch per clip batch: the runners' batch sizes decide the
    # count, so it is exact through the sequential runner; rows always are
    if runner == "sequential":
        assert got["dispatch"] == want["dispatch"]
    assert {k: rows for k, (_, rows) in got["dispatch"].items()} == \
        {k: rows for k, (_, rows) in want["dispatch"].items()} == {"embed/video-embed-tpu": 8}
    assert got["caption"] == want["caption"] and list(got["caption"]) == ["CaptionStage"]
    assert report["caption_phases"]["CaptionStage"]["requests"] == 8
    assert set(got["status"]) == set(want["status"]) and got["status"]["state"] == "finished"


# -- (c2) the split's filters and enhanced captions ---------------------------

FILTERED = dict(SPLIT, extract_fps=(8.0,), extract_resize_hw=(64, 96), text_filter="enable",
                semantic_filter="enable", embedding_model="video", captioning=True, caption_model="tiny-test",
                enhance_captions=True)


@pytest.fixture(scope="module")
def filter_videos(tmp_path_factory) -> Path:
    """Three scene videos and one with overlay text (a headline in its first
    second, a caption bar in its second)."""
    d = tmp_path_factory.mktemp("filter_videos")
    for i, scenes in enumerate((2, 3, 3)):
        # no moving box: its edges, upscaled to the detector's input, read
        # as text to the trained detector (about 0.02 of the frame)
        make_scene_video(d / f"video_{i}.mp4", scene_len_frames=24, num_scenes=scenes, moving_box=False)
    writer = cv2.VideoWriter(str(d / "overlay.mp4"), cv2.VideoWriter_fourcc(*"mp4v"), 24.0, (96, 64))
    for f in range(48):
        frame = np.full((64, 96, 3), 60, np.uint8)
        frame[:, :, 1] = 90 + f
        text = "BREAKING NEWS" if f < 24 else "LIVE 24/7"
        cv2.putText(frame, text, (2, 20 if f < 24 else 56), cv2.FONT_HERSHEY_SIMPLEX, 0.4, (255, 255, 255), 1,
                    cv2.LINE_AA)
        writer.write(frame)
    writer.release()
    return d


@pytest.fixture(scope="module")
def filter_weights(tmp_path_factory) -> Path:
    """The tiny caption checkpoint and the tiny video embedder's seeded init,
    written by the JAX registry (both packages serve the tiny configs under
    the real ids); the OCR checkpoints are the committed ones."""
    root = tmp_path_factory.mktemp("filter_weights")
    eng = JEngine(J_TINY, max_batch=2)
    eng.setup(5)
    jregistry.save_params(CAPTION_MODEL_ID, eng.params, root=root)
    eng.shutdown()
    embedder = jemb.VideoEmbedder(jemb.VIDEO_EMBED_TINY_TEST)
    embedder.setup()
    jregistry.save_params(EMBED_MODEL_ID, embedder._params, root=root)
    return root


@pytest.fixture
def filters_tiny(filter_weights, monkeypatch):
    monkeypatch.setenv(jregistry.WEIGHTS_DIR_ENV, str(filter_weights))
    monkeypatch.setitem(jemb.VIDEO_EMBED_VARIANTS, "video", (jemb.VIDEO_EMBED_TINY_TEST, EMBED_MODEL_ID))
    monkeypatch.setitem(temb.VIDEO_EMBED_VARIANTS, "video", (temb.VIDEO_EMBED_TINY_TEST, EMBED_MODEL_ID))
    JShared.reset()
    SharedCaptionEngine.reset()
    yield
    JShared.reset()
    SharedCaptionEngine.reset()


def _traced_split(run, engine_stage, args, runner) -> tuple[dict, dict]:
    """run_split with the shared caption engine's greedy logits recorded."""
    engine_stage.model.setup()  # the shared engine every caption-family stage joins
    trace = _record_logits(engine_stage.model.engine)
    return run(args, runner=runner), dict(trace)


@pytest.mark.parametrize("runner", ["sequential", "default"])
def test_filtered_split_matches_jax(filter_videos, filters_tiny, runner, tmp_path):
    """text filter (learned, the committed OCR weights) -> semantic filter ->
    ``embedding_model="video"`` -> captions -> enhanced captions through both
    packages' ``run_split``: the same clips kept and filtered (and by which
    filter), metas key for key (scores exactly; verdicts, captions and
    enhanced captions under the logit rule), and the same output files."""
    j_summary, j_trace = _traced_split(
        jsplit.run_split, jcap.CaptionStage(model_flavor="tiny-test"),
        jsplit.SplitPipelineArgs(input_path=str(filter_videos), output_path=str(tmp_path / "jout"), **FILTERED),
        JSequentialRunner())
    summary, trace = _traced_split(
        tsplit.run_split, tcap.CaptionStage(model_flavor="tiny-test", device="cpu"),
        tsplit.SplitPipelineArgs(input_path=str(filter_videos), output_path=str(tmp_path / "out"), device="cpu",
                                 **FILTERED),
        _runner(runner))

    assert _counts(summary) == _counts(j_summary)
    assert summary["num_filtered_by_text"] == 2 and summary["num_clips"] == 10, summary
    assert _files(tmp_path / "out") == _files(tmp_path / "jout")
    metas, j_metas = _all_metas(tmp_path / "out"), _all_metas(tmp_path / "jout")
    assert set(metas) == set(j_metas) and len(metas) == 10
    kept_or_filtered = {u: m["filtered_by"] for u, m in metas.items()}
    assert kept_or_filtered == {u: m["filtered_by"] for u, m in j_metas.items()}
    assert "text" in kept_or_filtered.values()
    compared = 0
    for uuid, j_meta in j_metas.items():
        meta = metas[uuid]
        assert list(meta) == list(j_meta)
        assert meta["artificial_text_score"] == j_meta["artificial_text_score"] is not None, uuid
        texts = [(w.pop("captions"), w.pop("enhanced_captions")) for w in meta["windows"]]
        j_texts = [(w.pop("captions"), w.pop("enhanced_captions")) for w in j_meta["windows"]]
        full = {}
        for rid in [uuid] + [f"{uuid}-{i}" for i in range(len(j_texts))]:
            if rid not in j_trace:
                continue
            full[rid] = True
            # the caption and the enhance pass share a request id: both
            # passes' steps are in the trace, in order
            for step, (j, p) in enumerate(zip(j_trace[rid], trace[rid], strict=True)):
                assert np.abs(j - p).max() <= LOGIT_TOL, (rid, step)
                top2 = np.sort(j)[-2:]
                if top2[1] - top2[0] < 2 * LOGIT_TOL:
                    full[rid] = False
                    break
                assert int(np.argmax(j)) == int(np.argmax(p)), (rid, step)
                compared += 1
        if full.get(uuid):
            assert meta["semantic_pass"] == j_meta["semantic_pass"], uuid
        meta.pop("semantic_pass"), j_meta.pop("semantic_pass")
        assert meta == j_meta, uuid
        for i, (pair, j_pair) in enumerate(zip(texts, j_texts, strict=True)):
            if full.get(f"{uuid}-{i}"):
                assert pair == j_pair, uuid
            assert pair[0].get("default") and "default" in pair[1]
    assert compared >= len(metas)
    embs, j_embs = _embeddings(tmp_path / "out"), _embeddings(tmp_path / "jout")
    assert set(embs) == set(j_embs) == {u for u, m in metas.items() if not m["filtered_by"]}
    for uuid, j_emb in j_embs.items():
        np.testing.assert_allclose(embs[uuid], j_emb, atol=EMBED_TOL)


def test_fanned_out_split_matches_the_jax_runners(annotate_videos, tmp_path):
    """The split on the port's pipelined runner with the fan-out on (16 CPUs
    of budget, ``transcode_cpus=1``: the thread-safe CPU stages get several
    workers) writes the same output set as both JAX runners."""
    kw = dict(SPLIT, transcode_cpus=1, clip_chunk_size=2)
    outs = {}
    for name, runner in (("jax_sequential", JSequentialRunner()), ("jax_pipelined", JPipelinedRunner())):
        outs[name] = jsplit.run_split(
            jsplit.SplitPipelineArgs(input_path=str(annotate_videos), output_path=str(tmp_path / name), **kw),
            runner=runner, config=JPipelineConfig(num_cpus=16))
    runner = PipelinedRunner(replan_interval_s=0.1)
    outs["port"] = tsplit.run_split(
        tsplit.SplitPipelineArgs(input_path=str(annotate_videos), output_path=str(tmp_path / "port"), **kw),
        runner=runner, config=PipelineConfig(num_cpus=16))
    assert runner.stage_counts["ClipTranscodingStage"]["workers"] > 1, runner.stage_counts
    assert runner.plans[0] != [1] * len(runner.plans[0])
    assert _counts(outs["port"]) == _counts(outs["jax_sequential"]) == _counts(outs["jax_pipelined"])
    assert outs["port"]["num_clips"] == 8
    files = _files(tmp_path / "port")
    assert files == _files(tmp_path / "jax_sequential") == _files(tmp_path / "jax_pipelined")
    for uuid, meta in _metas(tmp_path / "jax_sequential").items():
        assert _metas(tmp_path / "port")[uuid] == meta


# -- (d) chunking --------------------------------------------------------------


@pytest.fixture(scope="module")
def long_videos(tmp_path_factory) -> Path:
    d = tmp_path_factory.mktemp("long_videos")
    for i in range(2):
        make_scene_video(d / f"long_{i}.mp4", scene_len_frames=24, num_scenes=4)
    return d


@pytest.mark.parametrize("runner", ["sequential", "default"])
def test_chunked_split_matches_jax(long_videos, runner, tmp_path):
    kw = dict(SPLIT, clip_chunk_size=2)
    j_summary = jsplit.run_split(
        jsplit.SplitPipelineArgs(input_path=str(long_videos), output_path=str(tmp_path / "jout"), **kw),
        runner=JSequentialRunner())
    out = tmp_path / "out"
    summary = tsplit.run_split(tsplit.SplitPipelineArgs(input_path=str(long_videos), output_path=str(out), **kw),
                               runner=_runner(runner))
    assert _counts(summary) == _counts(j_summary)
    assert summary["num_clips"] == summary["num_transcoded"] == 8
    assert _files(out) == _files(tmp_path / "jout")
    records = sorted((out / "processed_videos").rglob("chunk-*.json"))
    assert len(records) == 4  # one resume record per chunk
    for rec in records:
        body = json.loads(rec.read_text())
        assert body["num_chunks"] == 2 and body["num_clips_total"] == 4
    assert discover_split_tasks(str(long_videos), str(out)) == []
    # a video with a chunk record missing is not done
    records[0].unlink()
    assert len(discover_split_tasks(str(long_videos), str(out))) == 1


# -- (e) refusals --------------------------------------------------------------

REFUSED_OPTIONS = {
    "sr_sp_size": dict(sr=True, sr_sp_size=2),
    "multicam": dict(multicam=True),
    "qwen_captions": dict(captioning=True, caption_model="qwen3vl-moe-a3b", device="cpu"),
}


REMOTE_CASES = {"remote_input": ("s3://bucket/videos", "s3://"), "remote_output": ("az://bucket/out", "az://")}


@pytest.mark.parametrize("case", [*REFUSED_OPTIONS, *REMOTE_CASES])
def test_unported_options_raise(case, videos, jax_split, tmp_path, monkeypatch):
    kw = dict(input_path=str(videos), output_path=str(tmp_path / "out"), **SPLIT)
    monkeypatch.setenv(jregistry.WEIGHTS_DIR_ENV, str(tmp_path / "weights"))
    if case in REMOTE_CASES:
        _remote_paths_are_gated_then_served(case, kw, jax_split, tmp_path, monkeypatch)
        return
    kw.update(REFUSED_OPTIONS[case])
    if case == "multicam":
        _multicam_is_served(kw, tmp_path)
        return
    # the Qwen3 flavor is ported: it refuses, as qwen2vl-2b does, for want
    # of its staged tokenizer files (and then weights)
    err, match = (FileNotFoundError, "vocab.json") if case == "qwen_captions" else (
        NotImplementedError, "ROADMAP queue A item")
    with pytest.raises(err, match=match):
        tsplit.run_split(tsplit.SplitPipelineArgs(**kw), runner=SequentialRunner())
    if case == "qwen_captions":
        # refused at the caption stage's setup, inside the run: the runner's
        # final live status is all the run leaves, as in the reference
        assert _files(tmp_path / "out") == {"report/live/status.json"}
    else:
        assert not (tmp_path / "out").exists()


def _multicam_is_served(kw, tmp_path):
    """``multicam``, once refused as unported, is served: on these flat
    videos (no ``<session>/<camera>`` directories) both packages warn, skip
    every file and write an empty summary, and a multicam split by shot
    detection raises the reference's ``ValueError`` (its sessions are
    tested in ``tests/test_torch_multicam.py``)."""
    summary = tsplit.run_split(tsplit.SplitPipelineArgs(**kw), runner=SequentialRunner())
    with preserved_observability_state():
        j_summary = jsplit.run_split(jsplit.SplitPipelineArgs(**dict(kw, output_path=str(tmp_path / "jout"))),
                                     runner=JSequentialRunner())
    assert _counts(summary) == _counts(j_summary) and summary["num_videos"] == 0
    for pkg, mod, runner in (("port", tsplit, SequentialRunner()), ("jax", jsplit, JSequentialRunner())):
        with pytest.raises(ValueError, match="fixed-stride only"), preserved_observability_state():
            mod.run_split(mod.SplitPipelineArgs(**dict(kw, splitting_algorithm="transnetv2",
                                                       output_path=str(tmp_path / f"shots-{pkg}"))), runner=runner)


def _remote_paths_are_gated_then_served(case, kw, jax_split, tmp_path, monkeypatch):
    """A remote input or output, once refused as unported, is served: with
    no credentials its backend raises ``RuntimeError`` naming what is
    missing (never reading a local file of the same name), and against the
    fake object stores (``tests/fixtures/object_stores.py``) the split
    writes what the JAX package's local run writes."""
    from tests.fixtures.object_stores import running_object_stores
    from cosmos_curate_tpu_torch.storage import client as storage_client

    remote, scheme = REMOTE_CASES[case]
    field = "input_path" if case == "remote_input" else "output_path"
    local = Path(kw[field])
    kw[field] = remote
    for var in ("AWS_ACCESS_KEY_ID", "AWS_SECRET_ACCESS_KEY", "AWS_ENDPOINT_URL", "AZURE_STORAGE_ACCOUNT",
                "AZURE_STORAGE_KEY", "AZURE_STORAGE_ENDPOINT"):
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(RuntimeError, match=f"{scheme} storage unavailable"):
        tsplit.run_split(tsplit.SplitPipelineArgs(**kw), runner=SequentialRunner())
    with running_object_stores() as stores:
        for k, v in stores.env.items():
            monkeypatch.setenv(k, v)
        if case == "remote_input":
            for p in sorted(local.iterdir()):
                storage_client.write_bytes(f"{remote}/{p.name}", p.read_bytes())
        summary = tsplit.run_split(tsplit.SplitPipelineArgs(**kw), runner=SequentialRunner())
        j_out, j_summary = jax_split
        assert _counts(summary) == _counts(j_summary) and summary["num_clips"] == 7
        if case == "remote_output":
            client = storage_client.get_storage_client(remote)
            assert set(client.list_relative(remote)) == _files(j_out) - {"report/live/status.json"}
            for uuid, meta in _metas(j_out).items():
                assert json.loads(client.read_bytes(f"{remote}/metas/v0/{uuid}.json")) == meta
        else:  # clip uuids derive from the video's path: the same files of each kind
            def kinds(files):
                return sorted(f.split("/", 1)[0] for f in files)

            assert kinds(_files(tmp_path / "out")) == kinds(_files(j_out))
        assert not stores.auth_failures(), stores.auth_failures()


# options earlier slices refused, now served: each assembles its stage where
# the JAX package puts it, with the same arguments
SERVED_OPTIONS = {
    "text_filter": (dict(text_filter="enable", text_filter_threshold=0.3), "ArtificialTextFilterStage"),
    "text_filter_score_only": (dict(text_filter="score-only"), "ArtificialTextFilterStage"),
    "semantic_filter": (dict(semantic_filter="enable", caption_model="tiny-test"), "SemanticFilterStage"),
    "semantic_filter_score_only": (dict(semantic_filter="score-only", semantic_filter_prompt="overlay-text",
                                        caption_model="tiny-test"), "SemanticFilterStage"),
    "enhance_captions": (dict(captioning=True, caption_model="tiny-test", enhance_captions=True),
                         "EnhanceCaptionStage"),
    "t5_embeddings": (dict(t5_embeddings=True, caption_prompt_variant="other"), "CaptionEmbeddingStage"),
    "previews": (dict(previews=True, extract_fps=(4.0, 2.0)), "PreviewStage"),
    "sr": (dict(sr=True, sr_window_frames=32, sr_overlap_frames=8), "SuperResolutionStage"),
    "motion_filter": (dict(motion_filter="score-only", motion_global_threshold=0.01, motion_backend="frame-diff"),
                      "MotionFilterStage"),
    "tracking": (dict(tracking=True), "TrackingStage"),
    # tracking_annotated alone assembles no stage, in both packages
    "tracking_annotated": (dict(tracking_annotated=True), None),
    "per_event_captions": (dict(per_event_captions=True, caption_model="tiny-test"), "PerEventCaptionStage"),
}


# the options the observability wrappers serve, and the files only they write
OBSERVED_OPTIONS = {
    "perf_profile": (dict(perf_profile=True), ()),
    "profile_cpu": (dict(profile_cpu=True), ("profile/cpu/",)),
    "profile_memory": (dict(profile_memory=True), ("profile/memory/",)),
    "stage_save_rate": (dict(stage_save_rate=0.5), ("stage_save/stage_inputs/",)),
}


def _observed_files(out: Path) -> tuple[set, set]:
    """(the run's files but the observability wrappers', those files with
    pids and timestamps masked)."""
    import re

    files = _files(out)
    extra = {f for f in files if f.startswith(("profile/", "stage_save/"))}
    return files - extra, {re.sub(r"\d+", "N", f) for f in extra}


@pytest.mark.parametrize("option", list(OBSERVED_OPTIONS))
def test_observability_options_match_jax(option, videos, jax_split, tmp_path):
    """Each option runs in both packages and leaves the run's output as it
    is: the profiles (named ``<stage>-<pid>``), saved batches
    (``batch-<ns>.pkl``) and delivery index are the reference's.
    ``perf_profile`` is carried and read by nothing, in both."""
    kw, prefixes = OBSERVED_OPTIONS[option]
    j_out, j_plain = tmp_path / "jout", jax_split[0]
    out = tmp_path / "out"
    with preserved_observability_state():
        j_summary = jsplit.run_split(jsplit.SplitPipelineArgs(input_path=str(videos), output_path=str(j_out),
                                                              **SPLIT, **kw), runner=JSequentialRunner())
    summary = tsplit.run_split(tsplit.SplitPipelineArgs(input_path=str(videos), output_path=str(out), **SPLIT, **kw),
                               runner=SequentialRunner())
    assert _counts(summary) == _counts(j_summary)
    files, extra = _observed_files(out)
    j_files, j_extra = _observed_files(j_out)
    assert files == j_files == _files(j_plain)
    assert _metas(out) == _metas(j_out)
    # which batches a rate of 0.5 records is the seeded draw: the same
    assert extra == j_extra
    # every extra file is the option's own (or the delivery index of the
    # profile tree the run collected)
    assert all(f.startswith((*prefixes, "profile/collected/")) for f in extra)
    assert bool(extra) == bool(prefixes)


def _preview_tasks(data, frames_by_clip):
    key = data.FrameExtractionSignature("fps", 2.0).key()
    clips = [data.Clip(source_video="v.mp4", span=(float(i), float(i + 1)), extracted_frames={key: f})
             for i, f in enumerate(frames_by_clip)]
    return [data.SplitPipeTask(video=data.Video(path="v.mp4", clips=clips))]


@pytest.mark.parametrize("n,hw", [(3, (32, 48)), (20, (180, 640)), (0, (8, 8))], ids=["few-small", "many-wide", "none"])
def test_preview_stage_matches_jax(n, hw):
    """The same frames through both preview stages: the same WebP bytes
    (the same PIL build encodes both), at most 8 frames no wider than 320."""
    from PIL import Image

    from cosmos_curate_tpu.pipelines.video.stages.preview import PreviewStage as JPreviewStage
    from cosmos_curate_tpu_torch.pipelines.video.stages.preview import PreviewStage

    frames = [np.random.default_rng(i).integers(0, 256, (n, *hw, 3), dtype=np.uint8) for i in range(2)]
    j_tasks = JPreviewStage().process_data(_preview_tasks(jdata, frames))
    t_tasks = PreviewStage().process_data(_preview_tasks(tdata, frames))
    for j_clip, t_clip in zip(j_tasks[0].video.clips, t_tasks[0].video.clips, strict=True):
        assert t_clip.webp_preview == j_clip.webp_preview
        assert t_clip.errors == j_clip.errors == {}
        if n == 0:
            assert t_clip.webp_preview is None
            continue
        img = Image.open(io.BytesIO(t_clip.webp_preview))
        assert img.format == "WEBP" and img.width <= 320 and getattr(img, "n_frames", 1) == min(n, 8)


def test_failed_preview_is_recorded_on_the_clip(monkeypatch):
    from PIL import Image

    from cosmos_curate_tpu_torch.pipelines.video.stages.preview import PreviewStage

    def refuse(self, *args, **kwargs):
        raise KeyError("WEBP")

    monkeypatch.setattr(Image.Image, "save", refuse)
    tasks = PreviewStage().process_data(_preview_tasks(tdata, [np.zeros((2, 8, 8, 3), np.uint8)]))
    clip = tasks[0].video.clips[0]
    assert clip.webp_preview is None and "WEBP" in clip.errors["preview"]


T5_PREVIEWS = dict(CAPTIONED, t5_embeddings=True, previews=True)


@pytest.mark.parametrize("runner", ["sequential", "default"])
def test_split_writes_t5_embeddings_and_previews(annotate_videos, jax_annotated, runner, tmp_path, monkeypatch):
    """A tiny captioned run with ``t5_embeddings`` and ``previews`` in both
    packages (the same staged caption weights; T5 on each package's seeded
    init): the same files, metas and WebP bytes; one ``window_{i}`` array of
    [tokens, 512] per captioned window, equal to the port's encoder on the
    meta's captions (each stage call embeds one video's windows, in clip
    order)."""
    from PIL import Image

    from cosmos_curate_tpu_torch.models.t5 import T5EncoderTPU

    root, _, _, _, _ = jax_annotated
    monkeypatch.setenv(jregistry.WEIGHTS_DIR_ENV, str(root))
    out, j_out = tmp_path / "out", tmp_path / "jout"
    JShared.reset()
    try:
        j_summary = jsplit.run_split(
            jsplit.SplitPipelineArgs(input_path=str(annotate_videos), output_path=str(j_out), **T5_PREVIEWS),
            runner=JSequentialRunner())
    finally:
        JShared.reset()
    SharedCaptionEngine.reset()
    try:
        summary = tsplit.run_split(
            tsplit.SplitPipelineArgs(input_path=str(annotate_videos), output_path=str(out), device="cpu",
                                     **T5_PREVIEWS),
            runner=_runner(runner))
    finally:
        SharedCaptionEngine.reset()
    assert _counts(summary) == _counts(j_summary)
    assert summary["num_clips"] == summary["num_with_captions"] == 8
    files = _files(out)
    assert files == _files(j_out)
    metas, j_metas = _metas(out), _metas(j_out)
    assert sum(f.startswith("previews/") for f in files) == sum(f.startswith("t5_embeddings/") for f in files) == 8
    encoder = T5EncoderTPU(device="cpu")
    encoder.setup()
    by_video: dict[str, list] = {}
    for uuid, meta in sorted(metas.items(), key=lambda kv: kv[1]["span_start"]):
        by_video.setdefault(meta["source_video"], []).append((uuid, meta["windows"][0]["captions"]["default"]))
    want = {}
    for rows in by_video.values():
        for (uuid, _), sample in zip(rows, encoder.encode([text for _, text in rows]), strict=True):
            want[uuid] = sample.embedding
    for uuid, meta in metas.items():
        j_meta = j_metas[uuid]
        captions = [w.pop("captions")["default"] for w in meta["windows"]]
        j_captions = [w.pop("captions")["default"] for w in j_meta["windows"]]
        assert meta == j_meta and all(w["has_t5_embedding"] for w in meta["windows"])
        webp = (out / "previews" / f"{uuid}.webp").read_bytes()
        assert webp == (j_out / "previews" / f"{uuid}.webp").read_bytes()
        img = Image.open(io.BytesIO(webp))
        assert getattr(img, "n_frames", 1) <= 8 and img.width <= 320
        with np.load(out / "t5_embeddings" / f"{uuid}.npz") as npz, \
                np.load(j_out / "t5_embeddings" / f"{uuid}.npz") as j_npz:
            assert sorted(npz.files) == sorted(j_npz.files) == [f"window_{i}" for i in range(len(captions))]
            for i, (text, j_text) in enumerate(zip(captions, j_captions, strict=True)):
                emb = npz[f"window_{i}"]
                assert emb.dtype == np.float32 and emb.shape == (len(text.encode()) + 1, 512)
                np.testing.assert_array_equal(emb, want[uuid])
                if text == j_text:
                    assert j_npz[f"window_{i}"].shape == emb.shape


@pytest.mark.parametrize("case", list(SERVED_OPTIONS))
def test_lifted_options_are_served(case):
    option, stage_name = SERVED_OPTIONS[case]
    j_stages = jsplit.assemble_stages(jsplit.SplitPipelineArgs(**option))
    t_stages = tsplit.assemble_stages(tsplit.SplitPipelineArgs(device="cpu", **option))
    names = [type(s).__name__ for s in t_stages]
    assert names == [type(s).__name__ for s in j_stages]
    if stage_name is None:
        assert names == [type(s).__name__ for s in tsplit.assemble_stages(tsplit.SplitPipelineArgs(device="cpu"))]
        return
    assert stage_name in names
    t_stage, j_stage = (stages[names.index(stage_name)] for stages in (t_stages, j_stages))
    for attr in ("threshold", "score_only", "prompt", "prompt_variant", "max_new_tokens", "num_frames", "max_frames",
                 "target_width", "fps", "global_threshold", "per_patch_threshold", "backend", "mv_global_threshold",
                 "mv_patch_threshold", "sample_fps", "window_len", "overlap", "write_annotated", "mode", "min_score",
                 "frames_per_event"):
        if hasattr(j_stage, attr):
            assert getattr(t_stage, attr) == getattr(j_stage, attr), attr
    assert t_stage.extraction.key() == j_stage.extraction.key() if hasattr(j_stage, "extraction") else True


@pytest.mark.parametrize("gate", ["on", "strict"])
def test_health_gate_runs_before_the_split(gate, videos, tmp_path, monkeypatch):
    """``CURATE_HEALTH_GATE=on|strict``: the probe runs first (three tries
    here, the third answering), then the split runs as without it."""
    from cosmos_curate_tpu_torch.utils import health

    answers = iter([False, False, True])
    calls = []
    monkeypatch.setattr(health, "probe_accelerator", lambda timeout_s=0: calls.append(timeout_s) or next(answers))
    monkeypatch.setattr(health.time, "sleep", lambda s: None)
    monkeypatch.setenv(tsplit.HEALTH_GATE_ENV, gate)
    summary = tsplit.run_split(tsplit.SplitPipelineArgs(input_path=str(videos), output_path=str(tmp_path / "out"),
                                                        **SPLIT), runner=SequentialRunner())
    assert calls == [120, 120, 120]
    assert summary["num_clips"] == summary["num_transcoded"] == 7


@pytest.mark.parametrize("gate", ["on", "strict"])
def test_unhealthy_card_aborts_the_split(gate, videos, tmp_path, monkeypatch):
    """An unhealthy card aborts before any stage is built, with ``on`` as
    with ``strict``: the port never moves the run to the CPU."""
    from cosmos_curate_tpu_torch.utils import health

    monkeypatch.setattr(health, "probe_accelerator", lambda timeout_s=0: False)
    monkeypatch.setattr(health.time, "sleep", lambda s: None)
    monkeypatch.setattr(tsplit, "assemble_stages", lambda args: pytest.fail("stages built past the gate"))
    monkeypatch.setenv(tsplit.HEALTH_GATE_ENV, gate)
    with pytest.raises(RuntimeError, match="accelerator unhealthy after 3 probes"):
        tsplit.run_split(tsplit.SplitPipelineArgs(input_path=str(videos), output_path=str(tmp_path / "out"),
                                                  **SPLIT), runner=SequentialRunner())
    assert not (tmp_path / "out").exists()


@pytest.mark.parametrize("staged", ["nothing", "tokenizer"])
def test_qwen_caption_model_resolves_and_refuses_without_staged_weights(staged, videos, tmp_path, monkeypatch):
    """``caption_model="qwen2vl-2b"`` resolves to the Qwen flavor and refuses
    at the caption stage's setup, as the JAX package does: without its
    tokenizer files, and with them but without weights (before any model is
    built)."""
    from tests.test_torch_qwen_vlm import write_gpt2_files

    monkeypatch.setenv(jregistry.WEIGHTS_DIR_ENV, str(tmp_path / "weights"))
    if staged == "tokenizer":
        write_gpt2_files(tmp_path / "weights" / "caption-qwen2vl-2b-tpu")
    kw = dict(input_path=str(videos), output_path=str(tmp_path / "out"), captioning=True, caption_model="qwen2vl-2b",
              device="cpu", **SPLIT)
    stages = tsplit.assemble_stages(tsplit.SplitPipelineArgs(**kw))
    caption = next(s for s in stages if type(s).__name__ == "CaptionStage")
    assert caption.model.model_id == "caption-qwen2vl-2b-tpu" and caption.model.hf_chat
    err, match = (FileNotFoundError, "vocab.json") if staged == "nothing" else (RuntimeError, "no staged weights")
    with pytest.raises(err, match=match):
        tsplit.run_split(tsplit.SplitPipelineArgs(**kw), runner=SequentialRunner())
    assert not SharedCaptionEngine._engines
    if staged == "nothing":
        jkw = {k: v for k, v in kw.items() if k != "device"}
        with pytest.raises(FileNotFoundError, match="vocab.json"):
            jsplit.run_split(jsplit.SplitPipelineArgs(**jkw), runner=JSequentialRunner())


# -- (f) no silent CPU ---------------------------------------------------------


@pytest.mark.parametrize("option", [dict(embedding_model="video"), dict(captioning=True, caption_model="tiny-test"),
                                    dict(splitting_algorithm="transnetv2"), dict(aesthetic_threshold=3.5),
                                    dict(embedding_model="clip"), dict(embedding_model="iv2"), dict(sr=True),
                                    dict(sr=True, sr_variant="srnet"), dict(motion_filter="enable"),
                                    dict(tracking=True), dict(per_event_captions=True, caption_model="tiny-test")])
def test_split_model_stages_default_to_the_gpu(option, videos, tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid here")
    args = tsplit.SplitPipelineArgs(input_path=str(videos), output_path=str(tmp_path / "out"), **SPLIT, **option)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tsplit.run_split(args, runner=SequentialRunner())
    assert not (tmp_path / "out").exists()


# -- (g) the canonical split: shot detection -> aesthetic filter -> CLIP -----

# the stage attributes assemble_stages sets from the arguments
STAGE_ARGS = ("threshold", "min_clip_len_s", "max_clip_len_s", "reduction", "score_only", "variant", "clip_len_s",
              "window_len", "prompt_variant", "num_threads", "chunk_size", "resize_hw", "overlap", "backend",
              "global_threshold", "write_annotated", "mode", "frames_per_event")


@pytest.mark.parametrize("option", [
    dict(splitting_algorithm="transnetv2", aesthetic_threshold=2.5, embedding_model="clip"),
    dict(splitting_algorithm="transnetv2", transnetv2_threshold=0.6, min_clip_len_s=1.0, max_clip_len_s=8.0,
         embedding_model="iv2", extract_fps=(4.0, 1.0)),
    dict(aesthetic_threshold=-1.0, embedding_model="video", captioning=True, caption_model="tiny-test"),
    dict(aesthetic_threshold=1.0, text_filter="enable", text_filter_threshold=0.3, semantic_filter="score-only",
         semantic_filter_prompt="overlay-text", embedding_model="video", captioning=True, caption_model="tiny-test",
         enhance_captions=True),
    dict(text_filter="score-only", semantic_filter="enable", caption_model="tiny-test", enhance_captions=True),
    dict(embedding_model="video", captioning=True, caption_model="tiny-test", enhance_captions=True,
         t5_embeddings=True, previews=True, caption_prompt_variant="short"),
    dict(sr=True, sr_variant="srnet", sr_window_frames=64, sr_overlap_frames=16, motion_filter="enable",
         motion_backend="frame-diff", text_filter="enable", embedding_model="video", captioning=True,
         caption_model="tiny-test", previews=True, tracking=True, tracking_annotated=True, per_event_captions=True),
    dict(sr=True, motion_filter="score-only", per_event_captions=True, caption_model="tiny-test"),
], ids=["transnet-aesthetic-clip", "transnet-iv2", "fixed-aesthetic-video-caption", "every-filter-and-enhance",
        "filters-without-captions", "captions-t5-previews", "every-leg", "diffusion-motion-events"])
def test_assemble_stages_puts_each_stage_where_the_reference_does(option):
    """The same stages in the same order as the JAX assembly, each with the
    same arguments, every model on the arguments' device."""
    j_stages = jsplit.assemble_stages(jsplit.SplitPipelineArgs(**option))
    t_stages = tsplit.assemble_stages(tsplit.SplitPipelineArgs(device="cpu", **option))
    assert [type(s).__name__ for s in t_stages] == [type(s).__name__ for s in j_stages]
    for t_stage, j_stage in zip(t_stages, j_stages):
        for attr in STAGE_ARGS:
            if hasattr(j_stage, attr) and hasattr(t_stage, attr):
                assert getattr(t_stage, attr) == getattr(j_stage, attr), (type(t_stage).__name__, attr)
        if hasattr(j_stage, "extraction"):
            assert t_stage.extraction.key() == j_stage.extraction.key()
        if j_stage.model is not None:
            assert t_stage.model.model_id_names == j_stage.model.model_id_names
            assert t_stage.model.device.type == "cpu" and t_stage.resources.gpus == 0.0


@pytest.fixture(scope="module")
def canonical_weights(tmp_path_factory) -> Path:
    """One ``params.msgpack`` per registry id of the canonical path, written
    by the JAX registry at tiny widths (the test serves the tiny configs
    under the real ids): TransNetV2 at ``TRANSNET_TINY_TEST``, both CLIP
    towers at ``clip-vit-tiny-test`` (other seeds), the aesthetic head over
    its 32-d embeddings."""
    root = tmp_path_factory.mktemp("canonical_weights")
    key = jax.random.PRNGKey
    jregistry.save_params("transnetv2-tpu", jax.jit(jtn.TransNet(jtn.TRANSNET_TINY_TEST).init)(
        key(1), jnp.zeros((1, 4, 8, 8, 3), jnp.uint8)), root=root)
    vit_init = jax.jit(jvit.ViT(jclip_model._CONFIGS["clip-vit-tiny-test"]).init)
    for seed, model_id in ((2, "clip-vit-l14-tpu"), (3, "clip-vit-b16-tpu")):
        jregistry.save_params(model_id, vit_init(key(seed), jnp.zeros((1, 32, 32, 3))), root=root)
    jregistry.save_params("aesthetics-mlp-tpu", jclip_model.AestheticMLP().init(key(4), jnp.zeros((1, 32))), root=root)
    return root


@pytest.fixture
def canonical_tiny(canonical_weights, monkeypatch):
    """Both packages serve the tiny configs under the canonical path's
    registry ids, from the staged checkpoints (the JAX registry's template
    init runs jitted: the same values, faster)."""
    monkeypatch.setenv(jregistry.WEIGHTS_DIR_ENV, str(canonical_weights))
    for mod in (jclip_model, tclip_model):
        for model_id in ("clip-vit-l14-tpu", "clip-vit-b16-tpu"):
            monkeypatch.setitem(mod._CONFIGS, model_id, mod._CONFIGS["clip-vit-tiny-test"])
    monkeypatch.setattr(jshot, "TransNetV2TPU", functools.partial(jtn.TransNetV2TPU, cfg=jtn.TRANSNET_TINY_TEST))
    monkeypatch.setattr(tshot, "TransNetV2", functools.partial(ttn.TransNetV2, cfg=ttn.TRANSNET_TINY_TEST))
    load_params = jregistry.load_params
    monkeypatch.setattr(jregistry, "load_params",
                        lambda model_id, init_fn, **kw: load_params(model_id, jax.jit(init_fn), **kw))


def _gap_threshold(j_values, t_values, *, upper_half: bool = False) -> float:
    """A threshold in the widest gap between the JAX values (of their upper
    half, to cut only a few), which the port's values (within the bf16
    bound of them) straddle alike."""
    j_values, t_values = np.asarray(j_values), np.asarray(t_values)
    diff = float(np.abs(t_values - j_values).max())
    assert diff <= EMBED_TOL
    ordered = np.sort(j_values)
    lo = len(ordered) // 2 if upper_half else 0
    i = lo + int(np.argmax(ordered[lo + 1 :] - ordered[lo:-1]))
    assert ordered[i + 1] - ordered[i] > 2 * diff, (ordered, diff)
    return float(ordered[i] + ordered[i + 1]) / 2


def _all_metas(out: Path) -> dict[str, dict]:
    return {p.stem: json.loads(p.read_text()) for p in (out / "metas").rglob("*.json")}


@pytest.mark.parametrize("runner", ["sequential", "default"])
def test_canonical_split_matches_jax(annotate_videos, canonical_tiny, runner, tmp_path):
    """transnetv2 -> aesthetic filter -> ``embedding_model="clip"`` through
    both packages' ``run_split``: a shot threshold and an aesthetic
    threshold that each cut (from the JAX run's own values), then the same
    clip uuids, the same kept / filtered partition and output files,
    ``aesthetic_score`` written in every meta within the bf16 bound, and
    CLIP embeddings within it."""
    paths = sorted(annotate_videos.glob("*.mp4"))
    j_det, t_det = jtn.TransNetV2TPU(cfg=jtn.TRANSNET_TINY_TEST), ttn.TransNetV2(cfg=ttn.TRANSNET_TINY_TEST, device="cpu")
    j_det.setup()
    t_det.setup()
    frames = [jdecode.decode_frames(str(p), resize_hw=(27, 48)) for p in paths]
    shot = _gap_threshold(np.concatenate([j_det.predict_transitions(f) for f in frames]),
                          np.concatenate([t_det.predict_transitions(f) for f in frames]), upper_half=True)
    kw = dict(extract_fps=(8.0,), extract_resize_hw=(32, 32), splitting_algorithm="transnetv2",
              transnetv2_threshold=shot, min_clip_len_s=0.25, embedding_model="clip")

    def j_run(out: Path, aesthetic: float) -> dict:
        return jsplit.run_split(jsplit.SplitPipelineArgs(input_path=str(annotate_videos), output_path=str(out),
                                                         aesthetic_threshold=aesthetic, **kw),
                                runner=JSequentialRunner())

    def t_run(out: Path, aesthetic: float) -> dict:
        return tsplit.run_split(tsplit.SplitPipelineArgs(input_path=str(annotate_videos), output_path=str(out),
                                                         aesthetic_threshold=aesthetic, device="cpu", **kw),
                                runner=_runner(runner))

    # every clip kept: the scores the aesthetic threshold is chosen from
    j_run(tmp_path / "j_all", -1e9)
    t_run(tmp_path / "t_all", -1e9)
    j_scored, t_scored = _all_metas(tmp_path / "j_all"), _all_metas(tmp_path / "t_all")
    assert set(t_scored) == set(j_scored) and len(j_scored) > len(paths)  # the detector cut
    uuids = sorted(j_scored)
    aesthetic = _gap_threshold([j_scored[u]["aesthetic_score"] for u in uuids],
                               [t_scored[u]["aesthetic_score"] for u in uuids])

    j_summary, summary = j_run(tmp_path / "jout", aesthetic), t_run(tmp_path / "out", aesthetic)
    assert _counts(summary) == _counts(j_summary)
    assert 0 < summary["num_filtered_by_aesthetic"] < summary["num_clips"]
    assert _files(tmp_path / "out") == _files(tmp_path / "jout")
    metas, j_metas = _all_metas(tmp_path / "out"), _all_metas(tmp_path / "jout")
    assert set(metas) == set(j_metas) == set(uuids)
    for uuid, j_meta in j_metas.items():
        meta = metas[uuid]
        assert abs(meta.pop("aesthetic_score") - j_meta.pop("aesthetic_score")) <= EMBED_TOL
        assert meta == j_meta, uuid
        assert (meta["filtered_by"] == "aesthetic") == (t_scored[uuid]["aesthetic_score"] < aesthetic)
    embs, j_embs = _embeddings(tmp_path / "out", "clip-vit-b16-tpu"), _embeddings(tmp_path / "jout", "clip-vit-b16-tpu")
    assert set(embs) == set(j_embs) == {u for u, m in metas.items() if not m["filtered_by"]}
    for uuid, j_emb in j_embs.items():
        np.testing.assert_allclose(embs[uuid], j_emb, atol=EMBED_TOL)
