"""Port parity: the motion filter's frame-difference scores, the codec
motion-vector scores and the stage's kept and filtered sets against the
JAX package, on the CPU.

Clips come from the calibration fixtures of
``benchmarks/motion_calibration.py`` (static, textured static, pans,
jitter, a corner box) through a real encode-decode roundtrip, and from a
numpy seed. The motion-vector backend runs where the native binding builds
(libavcodec and its headers), in both packages alike; elsewhere ``auto``
scores by frame difference in both.

Tolerances:
- frame-difference scores: atol 2e-5 / rtol 1e-4 (float32 sums in another
  order; measured below 1e-7);
- motion-vector scores, kept and filtered sets, summary counts: exactly
  equal.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from benchmarks.motion_calibration import MOVING_KINDS, STATIC_KINDS, make_fixture
from cosmos_curate_tpu.data import model as jdata
from cosmos_curate_tpu.models.batching import pad_batch
from cosmos_curate_tpu.native import load_mv as j_load_mv
from cosmos_curate_tpu.pipelines.video.stages import motion_filter as jmotion
from cosmos_curate_tpu.video import motion_vectors as jmv
from cosmos_curate_tpu.video.encode import encode_frames
from cosmos_curate_tpu_torch import native as tnative
from cosmos_curate_tpu_torch.data import model as tdata
from cosmos_curate_tpu_torch.pipelines.video.stages import motion_filter as tmotion
from cosmos_curate_tpu_torch.video import motion_vectors as tmv

SCORE_ATOL, SCORE_RTOL = 2e-5, 1e-4
KINDS = (*STATIC_KINDS, *MOVING_KINDS)


def _t_scores(frames: np.ndarray) -> tuple[float, float]:
    g, p = tmotion._motion_scores(torch.from_numpy(frames))
    return float(g), float(p)


def _j_scores(frames: np.ndarray) -> tuple[float, float]:
    padded, n = pad_batch(frames)
    g, p = jmotion._motion_scores(padded, n)
    return float(g), float(p)


@pytest.mark.parametrize("t,hw", [(2, (16, 16)), (5, (128, 128)), (8, (72, 128)), (13, (60, 90))])
def test_motion_scores_match_jax_on_random_frames(t, hw):
    frames = np.random.default_rng(t).integers(0, 256, (t, *hw, 3), dtype=np.uint8)
    np.testing.assert_allclose(_t_scores(frames), _j_scores(frames), atol=SCORE_ATOL, rtol=SCORE_RTOL)


@pytest.mark.parametrize("kind", KINDS)
def test_motion_scores_match_jax_on_the_calibration_fixtures(kind):
    frames = make_fixture(kind, 3, h=96, w=128, t=12)
    np.testing.assert_allclose(_t_scores(frames), _j_scores(frames), atol=SCORE_ATOL, rtol=SCORE_RTOL)


def test_motion_scores_of_a_static_clip_are_zero():
    frames = np.full((6, 32, 32, 3), 77, np.uint8)
    assert _t_scores(frames) == (0.0, 0.0)


def _field(data, rng, t, grid, has):
    return data.MVField(field=rng.random((t, grid, grid)).astype(np.float32) * 4, has_mv=np.asarray(has, bool),
                        width=160, height=96)


@pytest.mark.parametrize("has", [[True] * 5, [False, True, True, False, True], [False] * 3, [True]])
def test_mv_motion_scores_match_jax(has):
    rng = np.random.default_rng(len(has))
    t_field = _field(tmv, rng, len(has), 8, has)
    j_field = jmv.MVField(field=t_field.field, has_mv=t_field.has_mv, width=160, height=96)
    assert tmv.mv_motion_scores(t_field) == jmv.mv_motion_scores(j_field)


def test_mv_extract_source_is_the_reference_copy():
    from pathlib import Path

    ref = Path(jmv.__file__).resolve().parents[1] / "native" / "mv_extract.c"
    assert tnative.MV_SOURCE.read_bytes() == ref.read_bytes()
    assert tnative.MV_SOURCE.parent == Path(tnative.__file__).parent


@pytest.mark.parametrize("kind", ["static", "pan", "corner_box", "jitter"])
def test_mv_field_matches_jax(kind):
    data = encode_frames(make_fixture(kind, 5, h=96, w=128, t=24), 24.0)
    j_field, t_field = jmv.extract_mv_field(data), tmv.extract_mv_field(data)
    assert (t_field is None) == (j_field is None)
    assert (tnative.load_mv() is None) == (j_load_mv() is None)
    if t_field is None:
        assert tnative.mv_error() is not None
        return
    np.testing.assert_array_equal(t_field.field, j_field.field)
    np.testing.assert_array_equal(t_field.has_mv, j_field.has_mv)
    assert (t_field.width, t_field.height) == (j_field.width, j_field.height)


def _fixture_tasks(data, payloads):
    clips = [data.Clip(source_video=f"v{i}.mp4", span=(0.0, 1.0), encoded_data=p) for i, p in enumerate(payloads)]
    clips.append(data.Clip(source_video="none.mp4"))  # no payload: kept, unscored
    return [data.SplitPipeTask(video=data.Video(path="v.mp4", clips=clips[:5])),
            data.SplitPipeTask(video=data.Video(path="w.mp4", clips=clips[5:]))]


@pytest.fixture(scope="module")
def payloads():
    return [encode_frames(make_fixture(kind, seed, h=96, w=128, t=24), 24.0) for seed in (0, 1) for kind in KINDS]


def _decisions(tasks):
    return ([[(c.source_video, c.motion_score_global, c.motion_score_per_patch_min, dict(c.errors))
              for c in t.video.clips] for t in tasks],
            [[(c.source_video, c.filtered_by) for c in t.video.filtered_clips] for t in tasks])


@pytest.mark.parametrize("backend,kw", [
    ("frame-diff", {}), ("auto", {}), ("mv", {}), ("frame-diff", dict(score_only=True)),
    ("frame-diff", dict(per_patch_threshold=0.01, global_threshold=0.02)),
    ("auto", dict(mv_global_threshold=0.02, mv_patch_threshold=1e-3)),
], ids=["frame-diff", "auto", "mv", "score-only", "patch-threshold", "auto-mv-thresholds"])
def test_motion_filter_stage_matches_jax(backend, kw, payloads):
    """Both stages over the same clips: the same scores (exact on the MV
    path, within the score bounds by frame difference) and the same clips
    kept and filtered, in order."""
    if backend == "mv" and tnative.load_mv() is None:
        pytest.skip("the motion-vector binding does not build here (no libavcodec headers)")
    j_tasks = jmotion.MotionFilterStage(backend=backend, **kw).process_data(_fixture_tasks(jdata, payloads))
    t_tasks = tmotion.MotionFilterStage(backend=backend, device="cpu", **kw).process_data(
        _fixture_tasks(tdata, payloads))
    (j_kept, j_filtered), (t_kept, t_filtered) = _decisions(j_tasks), _decisions(t_tasks)
    assert t_filtered == j_filtered
    assert [[c[0] for c in v] for v in t_kept] == [[c[0] for c in v] for v in j_kept]
    for t_video, j_video in zip(t_tasks, j_tasks):
        for t_clip, j_clip in zip((*t_video.video.clips, *t_video.video.filtered_clips),
                                  (*j_video.video.clips, *j_video.video.filtered_clips), strict=True):
            assert t_clip.errors == j_clip.errors
            if j_clip.motion_score_global is None:
                assert t_clip.motion_score_global is None and t_clip.motion_score_per_patch_min is None
                continue
            np.testing.assert_allclose([t_clip.motion_score_global, t_clip.motion_score_per_patch_min],
                                       [j_clip.motion_score_global, j_clip.motion_score_per_patch_min],
                                       atol=SCORE_ATOL, rtol=SCORE_RTOL)
    if backend == "frame-diff" and not kw:
        # the reference's calibration: every static clip goes, every moving one stays
        assert sorted(v for video in t_filtered for v, _ in video) == sorted(
            f"v{i}.mp4" for i, kind in enumerate(KINDS * 2) if kind in STATIC_KINDS)


def test_motion_filter_stage_records_a_clip_that_does_not_decode():
    tasks = [tdata.SplitPipeTask(video=tdata.Video(path="v.mp4", clips=[
        tdata.Clip(source_video="bad.mp4", encoded_data=b"not an mp4")]))]
    out = tmotion.MotionFilterStage(backend="frame-diff", device="cpu").process_data(tasks)
    assert [c.source_video for c in out[0].video.clips] == ["bad.mp4"]  # unscoreable: kept
    assert out[0].video.clips[0].motion_score_global is None


def test_motion_filter_stage_lets_a_device_fault_through(monkeypatch, payloads):
    from cosmos_curate_tpu_torch.ops._build import KernelLaunchError

    stage = tmotion.MotionFilterStage(backend="frame-diff", device="cpu")

    def fault(*args, **kw):
        raise KernelLaunchError("launch failed")

    monkeypatch.setattr(stage._pipeline(), "submit", fault)
    with pytest.raises(KernelLaunchError):
        stage.process_data(_fixture_tasks(tdata, payloads[:2]))


@pytest.mark.parametrize("score_only,gpus", [(False, 0.5), (True, 0.25)])
def test_motion_filter_resources(score_only, gpus):
    assert jmotion.MotionFilterStage(score_only=score_only).resources.tpus == gpus
    assert tmotion.MotionFilterStage(score_only=score_only, device="cpu").resources.gpus == 0.0


def test_unknown_motion_backend_raises():
    with pytest.raises(ValueError, match="unknown motion backend"):
        tmotion.MotionFilterStage(backend="optical-flow", device="cpu")
