"""Port parity: ``run_split`` with the split's remaining legs (the motion
filter, tracking with annotated clips, per-event captions, super
resolution) against the JAX ``run_split`` on the same videos, on the CPU.

The videos are ``tests/fixtures/media``'s: two scene videos with a moving
box and one static video (which the motion filter drops). Both packages
encode on cv2's codec (``tests/test_torch_split.py``'s module fixture).
The motion filter's ``auto`` backend scores with codec motion vectors where
the native binding builds, in both packages alike.

Tolerances:
- summary counts (clock keys aside), output file names (``report/`` aside,
  the reference's live status), the ``tracking/`` files, filtered clips and
  every meta key but the scores below: exactly equal;
- track scores: ``TRACK_SCORE_RTOL`` / ``TRACK_SCORE_ATOL``, looser than the
  unit bounds of ``test_torch_tracker.py`` for two cases these clips hold:
  the reference's fp32 correlation rounds a first-frame score by up to
  3.1e-5 against float64 on a 64-pixel template (the port's by 1.8e-6;
  measured here 7.0e-5 apart on a score of 0.165), and on the static
  video's constant frames the patch variance falls under the 1e-8 floor,
  where the reference's score is its rounding noise over sd 1e-4 (measured
  up to 1.2e-3) and the port's is 0; motion scores: the bounds of
  ``test_torch_motion_filter.py``;
- event captions: ``test_torch_engine.py``'s logit rule (bf16 logits within
  ``LOGIT_TOL`` at every compared step; a caption's comparison stops at a
  JAX top-2 margin below ``2 * LOGIT_TOL``), the texts equal where every
  step was compared;
- super resolution: clips at twice the size, with the frames each stage
  encodes within 2 levels of the JAX stage's (the diffusion variant on the
  JAX noise; the configurations cut to ``SR_TINY_TEST`` /
  ``DIFF_SR_TINY_TEST`` in both packages).
"""

from __future__ import annotations

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cosmos_curate_tpu.core.runner import SequentialRunner as JSequentialRunner
from cosmos_curate_tpu.models import diffusion_sr as jd
from cosmos_curate_tpu.models import registry as jregistry
from cosmos_curate_tpu.models import super_resolution as js
from cosmos_curate_tpu.models.vlm import SharedCaptionEngine as JShared
from cosmos_curate_tpu.models.vlm import VLM_TINY_TEST as J_TINY
from cosmos_curate_tpu.models.vlm import CaptionEngine as JEngine
from cosmos_curate_tpu.pipelines.video import split as jsplit
from cosmos_curate_tpu.pipelines.video.stages import per_event_caption as jevent
from cosmos_curate_tpu.pipelines.video.stages import super_resolution as jsr_stage
from cosmos_curate_tpu_torch.core.runner import SequentialRunner
from cosmos_curate_tpu_torch.models import diffusion_sr as td
from cosmos_curate_tpu_torch.models import super_resolution as ts
from cosmos_curate_tpu_torch.models.vlm import SharedCaptionEngine
from cosmos_curate_tpu_torch.pipelines.video import split as tsplit
from cosmos_curate_tpu_torch.pipelines.video.stages import per_event_caption as tevent
from cosmos_curate_tpu_torch.pipelines.video.stages import super_resolution as tsr_stage
from tests.fixtures.media import make_scene_video, make_static_video
from tests.test_torch_engine import LOGIT_TOL, _record_logits
from tests.test_torch_motion_filter import SCORE_ATOL, SCORE_RTOL
from tests.test_torch_split import CAPTION_MODEL_ID, SPLIT, _cv2_codec, _counts, _files, _frames  # noqa: F401

UINT8_LEVELS = 2
TRACK_SCORE_RTOL, TRACK_SCORE_ATOL = 1e-3, 2e-3


@pytest.fixture(autouse=True)
def _no_health_gate(monkeypatch):
    monkeypatch.delenv(tsplit.HEALTH_GATE_ENV, raising=False)
    monkeypatch.delenv("CURATE_RUNNER", raising=False)


@pytest.fixture(scope="module")
def leg_videos(tmp_path_factory) -> Path:
    d = tmp_path_factory.mktemp("leg_videos")
    make_scene_video(d / "scene_0.mp4", scene_len_frames=24, num_scenes=2)
    make_scene_video(d / "scene_1.mp4", scene_len_frames=24, num_scenes=1, size_wh=(128, 96))
    make_static_video(d / "static.mp4", num_frames=48)
    return d


def _all_metas(out: Path) -> dict[str, dict]:
    return {f"{p.parent.name}/{p.stem}": json.loads(p.read_text()) for p in (out / "metas").rglob("*.json")}


def _assert_metas_match(out: Path, j_out: Path) -> dict[str, dict]:
    """Every meta key equal, but the scores (held to their bounds) and the
    event captions (returned for the logit rule)."""
    metas, j_metas = _all_metas(out), _all_metas(j_out)
    assert set(metas) == set(j_metas) and metas
    captions = {}
    for key, j_meta in j_metas.items():
        meta = dict(metas[key])
        j_meta = dict(j_meta)
        assert list(meta) == list(j_meta)
        for name in ("motion_score_global", "motion_score_per_patch_min"):
            got, want = meta.pop(name), j_meta.pop(name)
            assert (got is None) == (want is None), (key, name)
            if want is not None:
                np.testing.assert_allclose(got, want, atol=SCORE_ATOL, rtol=SCORE_RTOL)
        tracks, j_tracks = meta.pop("tracks"), j_meta.pop("tracks")
        assert len(tracks) == len(j_tracks), key
        for track, j_track in zip(tracks, j_tracks):
            assert [{k: v for k, v in p.items() if k != "score"} for p in track] == \
                [{k: v for k, v in p.items() if k != "score"} for p in j_track]
            np.testing.assert_allclose([p["score"] for p in track], [p["score"] for p in j_track],
                                       rtol=TRACK_SCORE_RTOL, atol=TRACK_SCORE_ATOL)
        captions[key] = (meta.pop("event_captions"), j_meta.pop("event_captions"), len(tracks))
        assert meta == j_meta, key
    return captions


def _run_both(videos: Path, tmp_path: Path, **kw) -> tuple[dict, dict, Path, Path]:
    j_out, out = tmp_path / "jax", tmp_path / "port"
    j_summary = jsplit.run_split(jsplit.SplitPipelineArgs(input_path=str(videos), output_path=str(j_out), **kw),
                                 runner=JSequentialRunner())
    summary = tsplit.run_split(tsplit.SplitPipelineArgs(input_path=str(videos), output_path=str(out), device="cpu",
                                                        **kw), runner=SequentialRunner())
    return summary, j_summary, out, j_out


@pytest.mark.parametrize("option", [
    dict(motion_filter="enable"),
    dict(motion_filter="score-only", motion_backend="frame-diff"),
    dict(motion_filter="enable", motion_backend="frame-diff", motion_global_threshold=0.02),
    dict(tracking=True),
    dict(tracking=True, tracking_annotated=True),
    dict(tracking_annotated=True),
    dict(motion_filter="enable", tracking=True, tracking_annotated=True),
], ids=["motion", "motion-score-only-frame-diff", "motion-frame-diff-threshold", "tracking", "tracking-annotated",
        "annotated-alone", "motion-and-tracking"])
def test_legs_split_matches_jax(option, leg_videos, tmp_path):
    summary, j_summary, out, j_out = _run_both(leg_videos, tmp_path, **SPLIT, **option)
    assert _counts(summary) == _counts(j_summary)
    assert summary["num_clips"] == 5
    if option.get("motion_filter") == "enable":
        assert summary["num_filtered_by_motion"] >= 2  # the static video's clips
    assert _files(out) == _files(j_out)
    tracked = option.get("tracking", False)
    annotated = tracked and option.get("tracking_annotated", False)
    assert bool(list((out / "tracking").glob("*.mp4"))) == annotated
    captions = _assert_metas_match(out, j_out)
    kept = {k for k in captions if k.startswith("v0/")}
    assert any(n for _, _, n in captions.values()) == tracked
    for key in kept:
        if annotated and captions[key][2]:
            assert (out / "tracking" / f"{key.split('/')[1]}.mp4").is_file()


@pytest.fixture(scope="module")
def caption_weights(tmp_path_factory) -> Path:
    """The tiny-test caption checkpoint the JAX engine writes, staged for both."""
    root = tmp_path_factory.mktemp("legs_weights")
    mp = pytest.MonkeyPatch()
    mp.setenv(jregistry.WEIGHTS_DIR_ENV, str(root))
    JShared.reset()
    try:
        eng = JEngine(J_TINY, max_batch=2)
        eng.setup(9)
        jregistry.save_params(CAPTION_MODEL_ID, eng.params, root=root)
        eng.shutdown()
    finally:
        JShared.reset()
        mp.undo()
    return root


def test_per_event_captions_split_matches_jax(leg_videos, caption_weights, tmp_path, monkeypatch):
    """``per_event_captions`` at ``caption_model="tiny-test"`` (tracking
    implied): the same tracks, one event caption a track, each held to the
    logit rule against the JAX run's."""
    monkeypatch.setenv(jregistry.WEIGHTS_DIR_ENV, str(caption_weights))
    kw = dict(SPLIT, motion_filter="enable", per_event_captions=True, caption_model="tiny-test")
    JShared.reset()
    SharedCaptionEngine.reset()
    try:
        traced = jevent.PerEventCaptionStage(model_flavor="tiny-test")
        traced.model.setup()  # the shared engine the split's stage joins
        j_trace = _record_logits(traced.model.engine)
        j_out, out = tmp_path / "jax", tmp_path / "port"
        j_summary = jsplit.run_split(jsplit.SplitPipelineArgs(input_path=str(leg_videos), output_path=str(j_out),
                                                              **kw), runner=JSequentialRunner())
        t_traced = tevent.PerEventCaptionStage(model_flavor="tiny-test", device="cpu")
        t_traced.model.setup()
        trace = _record_logits(t_traced.model.engine)
        summary = tsplit.run_split(tsplit.SplitPipelineArgs(input_path=str(leg_videos), output_path=str(out),
                                                            device="cpu", **kw), runner=SequentialRunner())
    finally:
        JShared.reset()
        SharedCaptionEngine.reset()
    assert _counts(summary) == _counts(j_summary)
    assert _files(out) == _files(j_out)
    captions = _assert_metas_match(out, j_out)
    compared = full_texts = 0
    for key, (texts, j_texts, n_tracks) in captions.items():
        assert len(texts) == len(j_texts) == (n_tracks if key.startswith("v0/") else 0)
        uuid = key.split("/")[1]
        for k, (text, j_text) in enumerate(zip(texts, j_texts)):
            rid = f"{uuid}-ev{k}"
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
                full_texts += 1
    assert sum(n for key, (_, _, n) in captions.items() if key.startswith("v0/")) == 3  # a track a moving clip
    assert compared >= 4


def _jax_noise(seed: int, shape: tuple) -> torch.Tensor:
    return torch.from_numpy(np.asarray(jax.random.normal(jax.random.PRNGKey(seed), shape, jnp.float32)))


@pytest.mark.parametrize("variant", ["srnet", "diffusion"])
def test_sr_split_matches_jax(variant, leg_videos, tmp_path, monkeypatch):
    """``sr=True`` at the tiny configurations, 16-frame windows overlapping
    by 8: the same files and metas, every clip at twice its size, and the
    frames each SR stage encodes within 2 levels of the JAX stage's."""
    monkeypatch.setenv(jregistry.WEIGHTS_DIR_ENV, str(tmp_path / "weights"))
    monkeypatch.setattr(jd, "DIFF_SR_BASE", jd.DIFF_SR_TINY_TEST)
    monkeypatch.setattr(td, "DIFF_SR_BASE", td.DIFF_SR_TINY_TEST)
    monkeypatch.setattr(jsr_stage, "SR_BASE", js.SR_TINY_TEST)
    monkeypatch.setattr(tsr_stage, "SR_BASE", ts.SR_TINY_TEST)
    monkeypatch.setattr(td, "chunk_noise", _jax_noise)
    if variant == "srnet":
        jm = js.SuperResolutionModel(js.SR_TINY_TEST)
        jm.setup()
        jregistry.save_params(js.SuperResolutionModel.MODEL_ID, jm._params)
    encoded = {"jax": [], "port": []}
    for name, module in (("jax", jsr_stage), ("port", tsr_stage)):
        real = module.encode_frames
        monkeypatch.setattr(module, "encode_frames",
                            lambda frames, fps, _real=real, _out=encoded[name]: _out.append(frames) or _real(frames, fps))
    kw = dict(SPLIT, sr=True, sr_variant=variant, sr_window_frames=16, sr_overlap_frames=8, motion_filter="enable")
    summary, j_summary, out, j_out = _run_both(leg_videos, tmp_path, **kw)
    assert _counts(summary) == _counts(j_summary)
    assert _files(out) == _files(j_out)
    _assert_metas_match(out, j_out)
    assert len(encoded["port"]) == len(encoded["jax"]) == summary["num_clips"] == 5
    for got, want in zip(encoded["port"], encoded["jax"]):
        assert got.shape == want.shape and got.shape[1:3] in ((128, 192), (192, 256), (96, 128))
        assert np.abs(got.astype(int) - want).max() <= UINT8_LEVELS
    for clip in (out / "clips").glob("*.mp4"):
        h, w = _frames(clip).shape[1:3]
        assert (h, w) in ((128, 192), (192, 256), (96, 128))


def test_sr_overlap_past_the_window_raises_like_jax(leg_videos, tmp_path):
    kw = dict(SPLIT, sr=True, sr_window_frames=8, sr_overlap_frames=8)
    with pytest.raises(ValueError, match="sr-overlap-frames"):
        jsplit.assemble_stages(jsplit.SplitPipelineArgs(**kw))
    with pytest.raises(ValueError, match="sr-overlap-frames"):
        tsplit.run_split(tsplit.SplitPipelineArgs(input_path=str(leg_videos), output_path=str(tmp_path / "o"),
                                                  device="cpu", **kw), runner=SequentialRunner())
    assert not (tmp_path / "o").exists()


def test_sequence_parallel_sr_is_refused(leg_videos, tmp_path):
    with pytest.raises(NotImplementedError, match="ROADMAP queue A item 7"):
        tsplit.run_split(tsplit.SplitPipelineArgs(input_path=str(leg_videos), output_path=str(tmp_path / "o"),
                                                  device="cpu", sr=True, sr_sp_size=2, **SPLIT),
                         runner=SequentialRunner())
