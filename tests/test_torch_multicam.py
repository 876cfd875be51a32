"""Port parity: multicam sessions (``discover_multicam_tasks``, the camera-
aware stages and ``run_split(multicam=True)``).

The sessions are ``tests/fixtures/media.make_scene_video``'s (96x64 at 24
fps, one second a scene) as ``<session>/<camera>.mp4``; one camera of the
first session is a scene shorter, so its tail clip is missing, and a flat
file beside the sessions is warned about and skipped. Each test runs the
same inputs through the JAX package and the port:

- discovery: the same sessions, cameras, primaries (by stem, with the
  override, and falling back to the first stem) and resume;
- ``run_split(multicam=True)`` at fixed stride with the tiny video embedder
  (both packages' embedders in fp32, the port given the JAX stage's seeded
  parameters): the same file tree (``clips/<primary-uuid>/<camera>.mp4``),
  the same clip bytes (cv2's codec, which repeats itself, in both
  packages), the same metas, summaries and resume records, embeddings from
  the primary only within atol 1e-4 / rtol 1e-3; a resumed run is empty;
  any other splitting algorithm raises the reference's ``ValueError``;
- ``CURATE_NUM_NODES=2``: each node discovers and takes the JAX package's
  sessions and writes its files and summary;
- the port's ``StreamingRunner`` writes the pipelined run's files.
"""

from __future__ import annotations

import functools
import json
from pathlib import Path

import numpy as np
import pyarrow.parquet as pq
import pytest
import torch

import jax.numpy as jnp

from cosmos_curate_tpu.core.runner import SequentialRunner as JSequentialRunner
from cosmos_curate_tpu.core.stage import WorkerMetadata as JWorkerMetadata
from cosmos_curate_tpu.data import model as jdata
from cosmos_curate_tpu.models import embedder as jemb
from cosmos_curate_tpu.models import vit as jvit
from cosmos_curate_tpu.parallel import distributed as jdist
from cosmos_curate_tpu.pipelines.video import input_discovery as jdisc
from cosmos_curate_tpu.pipelines.video import split as jsplit
from cosmos_curate_tpu.pipelines.video.stages import embedding as jembed
from cosmos_curate_tpu_torch.core.pipelined_runner import PipelinedRunner
from cosmos_curate_tpu_torch.core.runner import SequentialRunner, default_runner
from cosmos_curate_tpu_torch.data import model as tdata
from cosmos_curate_tpu_torch.engine.runner import StreamingRunner
from cosmos_curate_tpu_torch.models import embedder as temb
from cosmos_curate_tpu_torch.models.convert_jax import flax_to_state_dict
from cosmos_curate_tpu_torch.parallel import distributed as tdist
from cosmos_curate_tpu_torch.pipelines.video import input_discovery as tdisc
from cosmos_curate_tpu_torch.pipelines.video import split as tsplit
from cosmos_curate_tpu_torch.pipelines.video.stages import embedding as tembed
from tests.fixtures.media import make_scene_video
from tests.fixtures.observability import observability_state, preserved_observability_state  # noqa: F401

ATOL, RTOL = 1e-4, 1e-3
TINY = jemb.VIDEO_EMBED_TINY_TEST
EMBED_ID = "video-embed-tpu"
SPLIT = dict(multicam=True, fixed_stride_len_s=1.0, min_clip_len_s=0.5, extract_fps=(8.0,),
             extract_resize_hw=(32, 32))
CLOCK_KEYS = ("timestamp", "pipeline_run_time_s", "video_hours_per_day_per_chip")
# session -> camera -> scenes; drive_a's rear camera is a scene shorter
SESSIONS = {"drive_a": {"front": 3, "left": 3, "rear": 2}, "drive_b": {"front": 2, "left": 2, "rear": 2}}
NODE_ENV = ("CURATE_NUM_NODES", "CURATE_NODE_RANK", "SLURM_NODEID", "CURATE_COORDINATOR_ADDRESS",
            "CURATE_WORK_STEALING", "CURATE_RUNNER", "CURATE_ENGINE_DRIVER_PORT")


@pytest.fixture(scope="module", autouse=True)
def _cv2_codec_and_fp32():
    """Both packages on cv2's codec (it repeats itself bit for bit) and both
    embedders in fp32."""
    from cosmos_curate_tpu.video import h264 as jh264
    from cosmos_curate_tpu_torch.video import h264 as th264

    mp = pytest.MonkeyPatch()
    mp.setattr(jh264, "_probe_result", False)
    mp.setattr(th264, "_probe_result", False)
    mp.setattr(jemb, "ViT", functools.partial(jvit.ViT, dtype=jnp.float32))
    mp.setattr(jemb, "TemporalPooler", functools.partial(jemb.TemporalPooler, dtype=jnp.float32))
    mp.setattr(temb, "VideoEmbedModel", functools.partial(temb.VideoEmbedModel, dtype=torch.float32))
    jemb._jitted_apply.cache_clear()  # the JAX package compiles its apply once per config
    yield
    mp.undo()
    jemb._jitted_apply.cache_clear()


@pytest.fixture(autouse=True)
def _one_node(monkeypatch):
    for k in NODE_ENV:
        monkeypatch.delenv(k, raising=False)


@pytest.fixture(scope="module")
def sessions(tmp_path_factory) -> Path:
    d = tmp_path_factory.mktemp("sessions")
    for session, cams in SESSIONS.items():
        (d / session).mkdir()
        for cam, scenes in cams.items():
            make_scene_video(d / session / f"{cam}.mp4", scene_len_frames=24, num_scenes=scenes)
    make_scene_video(d / "stray.mp4", scene_len_frames=24, num_scenes=1)  # not in a session
    return d


def _layout(tasks) -> list:
    return [(t.session_id, t.is_multicam, [(v.path, v.camera) for v in t.videos]) for t in tasks]


@pytest.mark.parametrize("primary,limit", [("", 0), ("left", 0), ("rear", 1), ("side", 0)],
                         ids=["first-stem", "override", "limit", "missing-primary"])
def test_discovery_matches_jax(sessions, primary, limit, monkeypatch):
    warned = []
    monkeypatch.setattr(tdisc.logger, "warning", lambda msg, *a: warned.append(msg % a))
    got = tdisc.discover_multicam_tasks(str(sessions), primary_camera=primary, limit=limit)
    logged = "\n".join(warned)
    want = jdisc.discover_multicam_tasks(str(sessions), primary_camera=primary, limit=limit)
    assert _layout(got) == _layout(want)
    assert len(got) == (limit or 2)
    assert got[0].video.camera == (primary if primary in ("left", "rear") else "front")
    assert all(t.is_multicam and len(t.videos) == 3 for t in got)
    assert "stray.mp4: multicam input expects <session>/<camera>" in logged
    assert ("has no 'side' camera; using front as primary" in logged) == (primary == "side")


def _embed_stage(package: str, params=None):
    if package == "jax":
        return jembed.ClipEmbeddingStage(variant="video", video_cfg=TINY,
                                         extraction=jdata.FrameExtractionSignature("fps", 8.0))
    return tembed.ClipEmbeddingStage(variant="video", video_cfg=TINY, params=params,
                                     extraction=tdata.FrameExtractionSignature("fps", 8.0), device="cpu")


@pytest.fixture(scope="module")
def jax_multicam(sessions, tmp_path_factory):
    """The JAX package's multicam split with the tiny embedder, and that
    embedder's seeded parameters as a port state dict."""
    out = tmp_path_factory.mktemp("jax_multicam") / "out"
    with preserved_observability_state():
        embed = _embed_stage("jax")
        embed.setup(JWorkerMetadata())  # the seeded init, carried to the port
        summary = jsplit.run_split(jsplit.SplitPipelineArgs(input_path=str(sessions), output_path=str(out),
                                                            primary_camera="left", extra_stages=[embed], **SPLIT),
                                   runner=JSequentialRunner())
    return out, summary, flax_to_state_dict(embed.model._params)


def _files(out: Path, skip=("report/", "profile/")) -> set[str]:
    return {f for f in (str(p.relative_to(out)) for p in out.rglob("*") if p.is_file()) if not f.startswith(skip)}


def _counts(summary: dict) -> dict:
    return {k: v for k, v in summary.items() if k not in CLOCK_KEYS}


def _embeddings(out: Path) -> dict[str, np.ndarray]:
    rows = {}
    for path in (out / "embeddings" / EMBED_ID).glob("*.parquet"):
        table = pq.read_table(path).to_pydict()
        rows.update({u: np.asarray(e, np.float32) for u, e in zip(table["clip_uuid"], table["embedding"])})
    return rows


def _assert_outputs_match(out: Path, j_out: Path, *, embeddings: bool = True, clip_bytes: bool = True) -> None:
    assert _files(out) == _files(j_out)
    for rel in sorted(_files(j_out)):
        if rel.startswith("clips/"):
            if not clip_bytes:
                continue
            assert (out / rel).read_bytes() == (j_out / rel).read_bytes(), rel
        elif rel.endswith(".json") and not rel.startswith("summary"):
            assert json.loads((out / rel).read_text()) == json.loads((j_out / rel).read_text()), rel
    if embeddings:
        embs, j_embs = _embeddings(out), _embeddings(j_out)
        assert set(embs) == set(j_embs)
        for uuid, j_emb in j_embs.items():
            np.testing.assert_allclose(embs[uuid], j_emb, atol=ATOL, rtol=RTOL, err_msg=uuid)


@pytest.mark.parametrize("runner", ["sequential", "default"])
def test_multicam_split_matches_jax(sessions, jax_multicam, runner, tmp_path):
    j_out, j_summary, params = jax_multicam
    out = tmp_path / "out"
    args = tsplit.SplitPipelineArgs(input_path=str(sessions), output_path=str(out), primary_camera="left",
                                    extra_stages=[_embed_stage("port", params)], device="cpu", **SPLIT)
    summary = tsplit.run_split(args, runner=SequentialRunner() if runner == "sequential" else default_runner())
    assert _counts(summary) == _counts(j_summary)
    # 2 sessions, 5 primary clips (3 + 2), 3 cameras each but drive_a's rear tail
    assert summary["num_videos"] == 2 and summary["num_clips"] == summary["num_with_embeddings"] == 5
    assert summary["num_transcoded"] == 14
    _assert_outputs_match(out, j_out)
    clips = sorted(p.relative_to(out / "clips") for p in (out / "clips").rglob("*.mp4"))
    assert {p.name for p in clips} == {"front.mp4", "left.mp4", "rear.mp4"}
    assert sum(p.name == "rear.mp4" for p in clips) == 4 and sum(p.name == "left.mp4" for p in clips) == 5
    # metas and embeddings of the primary only: one a primary clip
    metas = list((out / "metas" / "v0").glob("*.json"))
    assert {m.stem for m in metas} == set(_embeddings(out)) == {str(p.parent) for p in clips}
    assert all(json.loads(m.read_text())["source_video"].endswith("/left.mp4") for m in metas)
    # resume: the primaries' records make a re-run empty
    assert tdisc.discover_multicam_tasks(str(sessions), str(out), primary_camera="left") == []
    again = tsplit.run_split(args, runner=SequentialRunner())
    assert again["num_videos"] == 0 and again["num_clips"] == 0


def test_multicam_needs_fixed_stride_like_jax(sessions, tmp_path):
    kw = dict(SPLIT, splitting_algorithm="transnetv2")
    with pytest.raises(ValueError, match="fixed-stride only") as want:
        with preserved_observability_state():
            jsplit.run_split(jsplit.SplitPipelineArgs(input_path=str(sessions), output_path=str(tmp_path / "j"), **kw),
                             runner=JSequentialRunner())
    with pytest.raises(ValueError, match="fixed-stride only") as got:
        tsplit.run_split(tsplit.SplitPipelineArgs(input_path=str(sessions), output_path=str(tmp_path / "t"),
                                                  device="cpu", **kw), runner=SequentialRunner())
    assert str(got.value).split(" (")[0] == str(want.value).split(" (")[0]
    assert not (tmp_path / "t" / "clips").exists()


def test_two_nodes_take_the_jax_sessions(sessions, tmp_path, monkeypatch):
    """``CURATE_NUM_NODES=2``: node r takes every second session, as the JAX
    package's node r does, and writes that session's clips and its
    summary (``summary.json`` on rank 0, ``summary-node1.json`` on 1).
    Each node writes to its own root: nodes run at one moment, and one
    after the other into one root the second would find the first's
    resume records."""
    monkeypatch.setenv("CURATE_NUM_NODES", "2")
    for rank in (0, 1):
        monkeypatch.setenv("CURATE_NODE_RANK", str(rank))
        tasks = tdisc.discover_multicam_tasks(str(sessions))
        j_tasks = jdisc.discover_multicam_tasks(str(sessions))
        mine, j_mine = tdist.partition_tasks_for_node(tasks), jdist.partition_tasks_for_node(j_tasks)
        assert _layout(mine) == _layout(j_mine) and [t.session_id for t in mine] == [sorted(SESSIONS)[rank]]
        outs = {}
        for pkg, mod, runner in (("port", tsplit, SequentialRunner()), ("jax", jsplit, JSequentialRunner())):
            outs[pkg] = tmp_path / pkg / f"node{rank}"
            kw = dict(SPLIT, extract_fps=(2.0,), extract_resize_hw=(32, 32))
            if pkg == "port":
                kw["device"] = "cpu"
            with preserved_observability_state():
                mod.run_split(mod.SplitPipelineArgs(input_path=str(sessions), output_path=str(outs[pkg]), **kw),
                              runner=runner)
        name = "summary.json" if rank == 0 else "summary-node1.json"
        got, want = (json.loads((outs[p] / name).read_text()) for p in ("port", "jax"))
        assert _counts(got) == _counts(want) and got["num_videos"] == 1
        _assert_outputs_match(outs["port"], outs["jax"], embeddings=False)
    assert len(list((tmp_path / "port").glob("node*/metas/v0/*.json"))) == 5


def test_streaming_runner_writes_the_pipelined_runs_files(sessions, tmp_path, monkeypatch):
    """The multicam split through the port's streaming engine (the CPU
    stages in spawned workers) writes what its pipelined runner writes.
    The spawned workers probe the codec afresh, so both runs take the
    writer the probe picks; clips compare by name (libx264 does not repeat
    itself bit for bit), metas in full."""
    from cosmos_curate_tpu_torch.video import h264 as th264

    monkeypatch.setattr(th264, "_probe_result", None)
    kw = dict(SPLIT, extract_fps=(2.0,), extract_resize_hw=(32, 32))
    piped = tsplit.run_split(tsplit.SplitPipelineArgs(input_path=str(sessions), output_path=str(tmp_path / "piped"),
                                                      device="cpu", **kw), runner=PipelinedRunner(raise_on_error=False))
    streamed = tsplit.run_split(tsplit.SplitPipelineArgs(input_path=str(sessions),
                                                         output_path=str(tmp_path / "stream"), device="cpu", **kw),
                                runner=StreamingRunner())
    assert _counts(streamed) == _counts(piped) and streamed["num_transcoded"] == 14
    _assert_outputs_match(tmp_path / "stream", tmp_path / "piped", embeddings=False, clip_bytes=False)


def test_multicam_task_fields_match_jax():
    """The task's camera fields and their properties, as the reference's."""
    for data in (tdata, jdata):
        task = data.SplitPipeTask(video=data.Video(path="s/a.mp4", camera="a"),
                                  aux_videos=[data.Video(path="s/b.mp4", camera="b")], session_id="s")
        task.video.metadata.duration_s = 120.0
        assert task.is_multicam and [v.camera for v in task.videos] == ["a", "b"] and task.weight == 4.0
        assert not data.SplitPipeTask().is_multicam and data.SplitPipeTask().weight == 1.0
