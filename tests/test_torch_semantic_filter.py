"""Port parity: the semantic filter and enhanced-caption stages
(``pipelines/video/stages/semantic_filter.py``, ``enhance_caption.py``) on
``tiny-test`` on the CPU.

Both packages load ONE checkpoint of the tiny caption config, written by
the JAX registry into a temporary ``CURATE_MODEL_WEIGHTS_DIR`` (the pattern
of ``test_torch_caption_stage.py``), and answer the same requests:

- the semantic filter's yes/no question over 4 of each clip's frames, and
  the enhance stage's text-only rewrite of each window's caption. Tolerance,
  as in ``test_torch_engine.py``: the two frameworks' bf16 logits agree
  within ``LOGIT_TOL`` at every compared step, and a request's comparison
  stops at a JAX top-2 margin below ``2 * LOGIT_TOL``; a request compared
  to its end gives the same text, and so the same verdict;
- ``parse_yes_no`` on the same strings: the same answers;
- the score-only and unparseable policies (the cases of
  ``tests/pipelines/test_filter_stages.py``), and each verdict's effect on
  an engine that answers "yes", "no" or neither;
- the three owners (caption, semantic filter, enhance) on one
  ``SharedCaptionEngine``, driven from three threads at once.
"""

from __future__ import annotations

import threading

import numpy as np
import pytest

from cosmos_curate_tpu.data import model as jdata
from cosmos_curate_tpu.models import registry as jregistry
from cosmos_curate_tpu.models.vlm import CaptionEngine as JEngine
from cosmos_curate_tpu.models.vlm import SharedCaptionEngine as JShared
from cosmos_curate_tpu.models.vlm import VLM_TINY_TEST as J_TINY
from cosmos_curate_tpu.pipelines.video.stages import enhance_caption as jenh
from cosmos_curate_tpu.pipelines.video.stages import semantic_filter as jsem
from cosmos_curate_tpu_torch.core.pipeline import run_pipeline
from cosmos_curate_tpu_torch.core.runner import SequentialRunner
from cosmos_curate_tpu_torch.data import model as tdata
from cosmos_curate_tpu_torch.models.vlm import VLM_TINY_TEST, SharedCaptionEngine
from cosmos_curate_tpu_torch.pipelines.video.stages import captioning as tcap
from cosmos_curate_tpu_torch.pipelines.video.stages import enhance_caption as tenh
from cosmos_curate_tpu_torch.pipelines.video.stages import semantic_filter as tsem
from tests.test_torch_engine import LOGIT_TOL, _record_logits

MODEL_ID = "caption-vlm-tpu"
CAPTIONS = ("a dog runs across a field", "two people talk at a table", "a car drives at night")


@pytest.fixture(autouse=True)
def _fresh_registries():
    JShared.reset()
    SharedCaptionEngine.reset()
    yield
    JShared.reset()
    SharedCaptionEngine.reset()


@pytest.fixture
def checkpoint(tmp_path, monkeypatch):
    monkeypatch.setenv(jregistry.WEIGHTS_DIR_ENV, str(tmp_path))
    eng = JEngine(J_TINY, max_batch=2)
    eng.setup(5)
    jregistry.save_params(MODEL_ID, eng.params, root=tmp_path)
    eng.shutdown()


def _tasks(data, *, n_tasks=2, n_clips=3, seed=0, captions=False, tag="v"):
    """Clips with 6 frames at 2 fps (32x32, from ``seed``); with
    ``captions``, one captioned window a clip."""
    rng = np.random.default_rng(seed)
    key = data.FrameExtractionSignature("fps", 2.0).key()
    out = []
    for t in range(n_tasks):
        video = data.Video(path=f"{tag}{t}.mp4")
        for i in range(n_clips):
            clip = data.Clip(uuid=data.deterministic_id(f"{tag}{t}", str(i)), source_video=f"{tag}{t}.mp4",
                             span=(float(i), float(i) + 3.0))
            clip.extracted_frames[key] = rng.integers(0, 256, (6, 32, 32, 3), dtype=np.uint8)
            if captions:
                clip.windows = [data.Window(start_frame=0, end_frame=72,
                                            caption={"default": CAPTIONS[(t + i) % len(CAPTIONS)]})]
            video.clips.append(clip)
        out.append(data.SplitPipeTask(video=video))
    return out


def _compare(j_trace: dict, t_trace: dict, rids: list[str]) -> tuple[set, int]:
    """The engine test's logit rule over ``rids``: (requests compared to
    their end, greedy steps compared)."""
    full_rids, compared = set(), 0
    for rid in rids:
        full = True
        for step, (j, p) in enumerate(zip(j_trace[rid], t_trace[rid], strict=True)):
            assert np.abs(j - p).max() <= LOGIT_TOL, (rid, step)
            top2 = np.sort(j)[-2:]
            if top2[1] - top2[0] < 2 * LOGIT_TOL:
                full = False
                break
            assert int(np.argmax(j)) == int(np.argmax(p)), (rid, step)
            compared += 1
        if full:
            full_rids.add(rid)
    return full_rids, compared


def _drive(stage, tasks):
    stage.setup(None)
    trace = _record_logits(stage.model.engine)
    out = stage.process_data(tasks)
    return trace, out


def test_semantic_verdicts_match_jax(checkpoint):
    j_stage = jsem.SemanticFilterStage(model_flavor="tiny-test", score_only=True)
    t_stage = tsem.SemanticFilterStage(model_flavor="tiny-test", score_only=True, device="cpu")
    j_trace, j_out = _drive(j_stage, _tasks(jdata))
    t_trace, t_out = _drive(t_stage, _tasks(tdata))
    j_clips = {str(c.uuid): c for t in j_out for c in t.video.clips}
    t_clips = {str(c.uuid): c for t in t_out for c in t.video.clips}
    assert t_clips.keys() == j_clips.keys() and len(t_clips) == 6
    full, compared = _compare(j_trace, t_trace, list(j_clips))
    assert compared >= 6 and full
    for rid in full:
        assert t_clips[rid].semantic_pass == j_clips[rid].semantic_pass, rid


def test_enhanced_captions_match_jax(checkpoint):
    j_stage = jenh.EnhanceCaptionStage(model_flavor="tiny-test", max_new_tokens=16)
    t_stage = tenh.EnhanceCaptionStage(model_flavor="tiny-test", max_new_tokens=16, device="cpu")
    assert t_stage.max_new_tokens == j_stage.max_new_tokens
    j_trace, j_out = _drive(j_stage, _tasks(jdata, captions=True))
    t_trace, t_out = _drive(t_stage, _tasks(tdata, captions=True))
    j_wins = {f"{c.uuid}-0": c.windows[0] for t in j_out for c in t.video.clips}
    t_wins = {f"{c.uuid}-0": c.windows[0] for t in t_out for c in t.video.clips}
    assert t_wins.keys() == j_wins.keys() and len(t_wins) == 6
    assert all("default" in w.enhanced_caption for w in t_wins.values())
    full, compared = _compare(j_trace, t_trace, list(j_wins))
    assert compared >= 6 and full
    for rid in full:
        assert t_wins[rid].enhanced_caption == j_wins[rid].enhanced_caption, rid


def test_enhance_clamps_generation_to_half_the_context():
    stage = tenh.EnhanceCaptionStage(cfg=VLM_TINY_TEST, device="cpu")
    j_stage = jenh.EnhanceCaptionStage(cfg=J_TINY)
    assert stage.max_new_tokens == j_stage.max_new_tokens == VLM_TINY_TEST.max_seq // 2


@pytest.mark.parametrize("text", ["Yes, clearly", " no", "dunno", "YES", "No.", "", "  yes!", "nope", "maybe yes",
                                  "N", "y"])
def test_parse_yes_no_matches_jax(text):
    assert tsem.parse_yes_no(text) == jsem.parse_yes_no(text)


def test_score_only_keeps_all():
    """``tests/pipelines/test_filter_stages.py``'s case on the port."""
    stage = tsem.SemanticFilterStage(cfg=VLM_TINY_TEST, score_only=True, device="cpu")
    out = run_pipeline(_tasks(tdata, n_tasks=1, n_clips=2), [stage], runner=SequentialRunner())
    assert len(out[0].video.clips) == 2 and not out[0].video.filtered_clips
    for clip in out[0].video.clips:
        assert clip.semantic_pass in (True, False, None)


def test_unparseable_keep_policy():
    stage = tsem.SemanticFilterStage(cfg=VLM_TINY_TEST, keep_on_unparseable=False, device="cpu")
    out = run_pipeline(_tasks(tdata, n_tasks=1, n_clips=2), [stage], runner=SequentialRunner())
    assert len(out[0].video.clips) + len(out[0].video.filtered_clips) == 2


class _Result:
    def __init__(self, rid, text):
        self.request_id, self.text = rid, text


class _AnsweringEngine:
    """An engine stand-in that answers each request with a fixed text."""

    def __init__(self, answers):
        self.answers, self.requests = answers, []

    def add_request(self, req):
        self.requests.append(req)

    def run_until_complete(self, owner=None):
        return [_Result(r.request_id, self.answers[i % len(self.answers)]) for i, r in enumerate(self.requests)]


@pytest.mark.parametrize("score_only", [False, True])
@pytest.mark.parametrize("keep_on_unparseable", [True, False])
def test_verdict_policies_match_jax(score_only, keep_on_unparseable):
    """Each verdict's effect, in both packages, on an engine that answers
    "Yes.", "no" and "the sky" in turn."""
    answers = ("Yes.", "no", "the sky")
    results = []
    for mod, data, kw in ((jsem, jdata, {}), (tsem, tdata, {"device": "cpu"})):
        stage = mod.SemanticFilterStage(cfg=J_TINY if mod is jsem else VLM_TINY_TEST, score_only=score_only,
                                        keep_on_unparseable=keep_on_unparseable, **kw)
        engine = _AnsweringEngine(answers)
        stage._model.engine = engine
        tasks = _tasks(data, n_tasks=1, n_clips=6)
        tasks[0].video.clips.append(data.Clip(uuid=data.deterministic_id("no-frames"), span=(9.0, 10.0)))
        stage.process_data(tasks)
        video = tasks[0].video
        results.append((
            [(str(c.uuid), c.semantic_pass) for c in video.clips],
            [(str(c.uuid), c.semantic_pass, c.filtered_by) for c in video.filtered_clips],
            [(r.request_id, len(r.frames), r.sampling.max_new_tokens, round(r.frame_fps, 6))
             for r in engine.requests],
        ))
    assert results[1] == results[0]
    kept, filtered, requests = results[1]
    assert len(requests) == 6 and all(n == 4 and m == 8 for _, n, m, _ in requests)
    dropped = 0 if score_only else 2 + (0 if keep_on_unparseable else 2)
    assert len(filtered) == dropped and len(kept) == 7 - dropped


def test_three_owners_share_one_engine_from_three_threads(checkpoint):
    """The caption, semantic-filter and enhance stages resolve one
    ``SharedCaptionEngine`` and drive it at once from three threads; each
    gets every answer it asked for, and none of another's."""
    sig = tdata.FrameExtractionSignature("fps", 2.0)
    caption = tcap.CaptionStage(model_flavor="tiny-test", max_new_tokens=8, device="cpu")
    semantic = tsem.SemanticFilterStage(model_flavor="tiny-test", score_only=True, device="cpu")
    enhance = tenh.EnhanceCaptionStage(model_flavor="tiny-test", max_new_tokens=8, device="cpu")
    for stage in (caption, semantic, enhance):
        stage.setup(None)
    assert caption.model.engine is semantic.model.engine is enhance.model.engine
    assert len({caption.owner, semantic.owner, enhance.owner}) == 3
    cap_tasks = tcap.CaptionPrepStage(extraction=sig, frames_per_window=2).process_data(
        _tasks(tdata, n_clips=2, seed=1, tag="c"))
    for t in cap_tasks:
        t.video.metadata = tdata.VideoMetadata(fps=24.0)
    sem_tasks = _tasks(tdata, n_clips=2, seed=2, tag="s")
    enh_tasks = _tasks(tdata, n_clips=2, seed=3, tag="e", captions=True)
    errors = []

    def run(stage, tasks):
        try:
            stage.process_data(tasks)
        except Exception as e:  # surfaced by the assertion below
            errors.append(e)

    threads = [threading.Thread(target=run, args=a) for a in ((caption, cap_tasks), (semantic, sem_tasks),
                                                             (enhance, enh_tasks))]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=300)
    assert not any(th.is_alive() for th in threads) and not errors, errors
    assert all("default" in w.caption for t in cap_tasks for c in t.video.clips for w in c.windows)
    assert all(not w.enhanced_caption for t in cap_tasks for c in t.video.clips for w in c.windows)
    assert all(c.semantic_pass is None or isinstance(c.semantic_pass, bool) for t in sem_tasks for c in t.video.clips)
    assert all("default" in c.windows[0].enhanced_caption for t in enh_tasks for c in t.video.clips)
    stats = semantic.model.engine.owner_stats()
    assert {caption.owner, semantic.owner, enhance.owner} <= set(stats)


@pytest.mark.parametrize("entry", ["semantic", "enhance"])
def test_stages_default_to_the_gpu(entry):
    import torch

    make = {"semantic": tsem.SemanticFilterStage, "enhance": tenh.EnhanceCaptionStage}[entry]
    if torch.cuda.is_available():
        assert make(model_flavor="tiny-test").model.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make(model_flavor="tiny-test")
    stage = make(model_flavor="tiny-test", device="cpu")
    assert stage.model.device.type == "cpu" and not stage.resources.uses_gpu
