"""Port parity: the artificial-text filter stage
(``pipelines/video/stages/artificial_text_filter.py``) against the JAX
stage, through each package's ``run_pipeline``.

The same tasks (clips of 6 frames at 120x160: overlay text drawn with cv2,
subtitle-like stroke bands, clean frames and noise, made from a numpy seed)
go through both stages in each mode:

- ``learned`` and ``auto`` (the committed ``ocr-detector-tpu`` checkpoint
  is found, so both take the learned detector): the same scores (exactly:
  the coverage is a count over the same thresholded heatmap) and the same
  kept and filtered clips;
- ``heuristic``: scores within 1e-6 and the same kept and filtered clips.

``auto`` with no checkpoint staged (an empty ``CURATE_MODEL_WEIGHTS_DIR``
and the repository lookup shadowed) takes the heuristic in both packages;
``learned`` without weights raises in both.
"""

from __future__ import annotations

import cv2
import numpy as np
import pytest

from cosmos_curate_tpu.core.pipeline import run_pipeline as jrun_pipeline
from cosmos_curate_tpu.core.runner import SequentialRunner as JSequentialRunner
from cosmos_curate_tpu.data import model as jdata
from cosmos_curate_tpu.models import registry as jregistry
from cosmos_curate_tpu.pipelines.video.stages.artificial_text_filter import ArtificialTextFilterStage as JStage
from cosmos_curate_tpu.pipelines.video.stages.artificial_text_filter import _text_likeness as j_text_likeness
from cosmos_curate_tpu_torch.core.pipeline import run_pipeline
from cosmos_curate_tpu_torch.core.pipelined_runner import PipelinedRunner
from cosmos_curate_tpu_torch.core.runner import SequentialRunner
from cosmos_curate_tpu_torch.data import model as tdata
from cosmos_curate_tpu_torch.models import registry
from cosmos_curate_tpu_torch.models.batching import pad_batch
from cosmos_curate_tpu_torch.pipelines.video.stages.artificial_text_filter import ArtificialTextFilterStage, _text_likeness

HEURISTIC_TOL = 1e-6
SIG = ("fps", 2.0)


def _clip_frames(rng, kind: str, n: int = 6) -> np.ndarray:
    frames = np.full((n, 120, 160, 3), rng.integers(40, 200), np.uint8)
    if kind == "noise":
        return rng.integers(0, 256, frames.shape, dtype=np.uint8)
    if kind == "overlay":
        for f in frames:
            cv2.putText(f, "BREAKING NEWS", (4, 24), cv2.FONT_HERSHEY_SIMPLEX, 0.6, (255, 255, 255), 2, cv2.LINE_AA)
            cv2.putText(f, "live 24/7", (20, 110), cv2.FONT_HERSHEY_DUPLEX, 0.5, (0, 255, 255), 1, cv2.LINE_AA)
    elif kind == "strokes":
        frames[:, 100:116, ::2] = 255  # subtitle-like vertical strokes in the bottom band
    elif kind == "scene":
        for f in frames:
            cv2.rectangle(f, (30, 30), (120, 90), tuple(int(c) for c in rng.integers(0, 256, 3)), -1)
    return frames


KINDS = ("overlay", "strokes", "scene", "clean", "noise")


def _tasks(data, seed: int = 0, n_tasks: int = 2) -> list:
    rng = np.random.default_rng(seed)
    key = data.FrameExtractionSignature(*SIG).key()
    tasks = []
    for t in range(n_tasks):
        video = data.Video(path=f"v{t}.mp4")
        for i, kind in enumerate(KINDS):
            clip = data.Clip(uuid=data.deterministic_id(f"v{t}", str(i)), source_video=f"v{t}.mp4",
                             span=(float(i), float(i + 1)))
            clip.extracted_frames[key] = _clip_frames(rng, kind)
            video.clips.append(clip)
        video.clips.append(data.Clip(uuid=data.deterministic_id(f"v{t}", "empty"), span=(9.0, 10.0)))  # no frames
        tasks.append(data.SplitPipeTask(video=video))
    return tasks


def _result(tasks) -> tuple[dict, set, set]:
    scores = {str(c.uuid): c.artificial_text_score for t in tasks for c in (*t.video.clips, *t.video.filtered_clips)}
    kept = {str(c.uuid) for t in tasks for c in t.video.clips}
    filtered = {(str(c.uuid), c.filtered_by) for t in tasks for c in t.video.filtered_clips}
    return scores, kept, filtered


def _run_both(mode: str, runner: str = "sequential", **kw):
    j_stage = JStage(mode=mode, extraction=jdata.FrameExtractionSignature(*SIG), **kw)
    t_stage = ArtificialTextFilterStage(mode=mode, extraction=tdata.FrameExtractionSignature(*SIG), device="cpu",
                                        **kw)
    j_out = jrun_pipeline(_tasks(jdata), [j_stage], runner=JSequentialRunner())
    t_runner = SequentialRunner() if runner == "sequential" else PipelinedRunner()
    t_out = run_pipeline(_tasks(tdata), [t_stage], runner=t_runner)
    return j_stage, t_stage, _result(j_out), _result(t_out)


@pytest.mark.parametrize("runner", ["sequential", "default"])
@pytest.mark.parametrize("mode", ["learned", "auto", "heuristic"])
def test_stage_matches_jax(mode, runner):
    kw = dict(threshold=0.3) if mode == "heuristic" else {}
    j_stage, t_stage, (j_scores, j_kept, j_filtered), (scores, kept, filtered) = _run_both(mode, runner, **kw)
    assert t_stage.learned == (j_stage._ocr is not None) == (mode != "heuristic")
    assert scores.keys() == j_scores.keys() and len(scores) == 12
    for uuid, j_score in j_scores.items():
        if j_score is None:
            assert scores[uuid] is None  # a clip without frames is never scored
        elif mode == "heuristic":
            assert abs(scores[uuid] - j_score) <= HEURISTIC_TOL, uuid
        else:
            assert scores[uuid] == j_score, uuid
    assert kept == j_kept and filtered == j_filtered
    # the filter decides something here: some clips kept, some filtered
    assert filtered and len(kept) > 2, (kept, filtered)
    assert {by for _, by in filtered} == {"text"}


def test_score_only_keeps_every_clip_with_its_score():
    _, _, (j_scores, j_kept, j_filtered), (scores, kept, filtered) = _run_both("learned", score_only=True)
    assert kept == j_kept and len(kept) == 12 and not filtered and not j_filtered
    assert scores == j_scores


@pytest.mark.parametrize("seed", range(8))
@pytest.mark.parametrize("quantized", [False, True])
def test_heuristic_score_matches_jax_bit_for_bit(seed, quantized):
    """The heuristic's constants are folded as XLA folds them, so the
    scores are bit-equal. A gradient of the temporal mean of n uint8 frames
    can land exactly on the 0.15 line only when 114.75 n is a whole number
    (n a multiple of 4), and there the two frameworks' summation orders may
    round either way; those counts are left out. Coarse frames (levels 51
    apart) sit close to the line."""
    import jax.numpy as jnp
    import torch

    rng = np.random.default_rng(seed)
    t = int(rng.choice([1, 2, 3, 5, 6, 7]))
    frames = rng.integers(0, 256, (t, 40, 48, 3))
    frames = (frames // 51 * 51 if quantized else frames).astype(np.uint8)
    padded, n = pad_batch(frames)
    got = float(_text_likeness(torch.from_numpy(padded), n))
    want = float(j_text_likeness(jnp.asarray(padded), n))
    assert got == want


@pytest.fixture
def no_checkpoint(tmp_path, monkeypatch):
    """An empty staging directory and the repository's weights shadowed, in
    both packages."""
    for mod in (registry, jregistry):
        monkeypatch.setenv(mod.WEIGHTS_DIR_ENV, str(tmp_path / "w"))
        monkeypatch.setattr(mod, "REPO_WEIGHTS_DIR", tmp_path / "nonexistent")


def test_auto_without_a_checkpoint_takes_the_heuristic(no_checkpoint):
    j_stage, t_stage, (j_scores, j_kept, j_filtered), (scores, kept, filtered) = _run_both("auto")
    assert not t_stage.learned and j_stage._ocr is None
    for uuid, j_score in j_scores.items():
        assert (scores[uuid] is None) == (j_score is None)
        if j_score is not None:
            assert abs(scores[uuid] - j_score) <= HEURISTIC_TOL
    assert kept == j_kept and filtered == j_filtered


def test_learned_without_weights_raises(no_checkpoint):
    with pytest.raises(RuntimeError, match="no staged weights"):
        JStage(mode="learned").setup()
    with pytest.raises(RuntimeError, match="no staged weights"):
        ArtificialTextFilterStage(mode="learned", device="cpu").setup()


def test_auto_raises_when_a_staged_checkpoint_does_not_load(tmp_path, monkeypatch):
    """The port's one divergence: a staged checkpoint that fails to load
    raises in ``auto`` mode, where the reference falls back to the heuristic."""
    monkeypatch.setenv(registry.WEIGHTS_DIR_ENV, str(tmp_path))
    (tmp_path / "ocr-detector-tpu").mkdir()
    (tmp_path / "ocr-detector-tpu" / "params.msgpack").write_bytes(b"\x80")  # an empty map: no parameters
    with pytest.raises(RuntimeError, match="do not match"):
        ArtificialTextFilterStage(mode="auto", device="cpu").setup()


def test_unknown_mode_and_resources():
    with pytest.raises(ValueError, match="unknown text-filter mode"):
        ArtificialTextFilterStage(mode="ocr", device="cpu")
    assert ArtificialTextFilterStage(device="cpu").resources.gpus == 0.0
