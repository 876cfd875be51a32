"""Port parity: stage save, replay and compare
(``observability/stage_replay.py``, ``stage_compare.py``).

The reference's end-to-end loop (tests/observability/test_replay_e2e.py) in
both packages: a ``run_split`` with ``stage_save_rate=1.0``, a motion filter
(``frame-diff``) and the tiny video embedder (the JAX stage's seeded
params carried to the port), through ``SequentialRunner`` on the CPU; then
stages replayed over the recorded batches.

Tolerances: saved batches and replayed motion outputs exactly equal across
packages but the motion scores, held at the motion-filter parity bounds of
``tests/test_torch_motion_filter.py`` (atol 2e-5, rtol 1e-4); replayed
embeddings within the embed stage's bf16 bound of 2e-2
(``tests/test_torch_embedder.py``); a port replay against the port run's own
saved outputs at the compare default (1e-5). Both packages force cv2's
codec, which repeats itself bit for bit.
"""

from __future__ import annotations

import dataclasses
import os
from pathlib import Path

import numpy as np
import pytest
import torch

from cosmos_curate_tpu.core.runner import SequentialRunner as JSequentialRunner
from cosmos_curate_tpu.core.stage import WorkerMetadata as JWorkerMetadata
from cosmos_curate_tpu.data import model as jdata
from cosmos_curate_tpu.models import embedder as jemb
from cosmos_curate_tpu.observability import stage_compare as jcompare
from cosmos_curate_tpu.observability import stage_replay as jreplay
from cosmos_curate_tpu.pipelines.video import split as jsplit
from cosmos_curate_tpu.pipelines.video.stages import embedding as jembed
from cosmos_curate_tpu.pipelines.video.stages import motion_filter as jmotion
from cosmos_curate_tpu_torch.core.pipeline import run_pipeline
from cosmos_curate_tpu_torch.core.runner import SequentialRunner
from cosmos_curate_tpu_torch.core.stage import Stage
from cosmos_curate_tpu_torch.core.tasks import PipelineTask
from cosmos_curate_tpu_torch.data import model as tdata
from cosmos_curate_tpu_torch.models import embedder as temb
from cosmos_curate_tpu_torch.models.convert_jax import flax_to_state_dict
from cosmos_curate_tpu_torch.observability import stage_compare as tcompare
from cosmos_curate_tpu_torch.observability import stage_replay as treplay
from cosmos_curate_tpu_torch.pipelines.video import split as tsplit
from cosmos_curate_tpu_torch.pipelines.video.stages import embedding as tembed
from cosmos_curate_tpu_torch.pipelines.video.stages import motion_filter as tmotion
from tests.fixtures.media import make_scene_video
from tests.fixtures.observability import observability_state, preserved_observability_state  # noqa: F401

EMBED_TOL = 2e-2
SCORE_ATOL, SCORE_RTOL = 2e-5, 1e-4
SPLIT = dict(fixed_stride_len_s=1.0, min_clip_len_s=0.5, motion_filter="score-only", motion_backend="frame-diff",
             extract_fps=(8.0,), extract_resize_hw=(32, 32), stage_save_rate=1.0)
# the motion scores, which the motion tests hold at their own bounds
IGNORED = ("motion_score_global", "motion_score_per_patch")
STAGES = ("VideoDownloadStage", "FixedStrideExtractorStage", "ClipTranscodingStage", "MotionFilterStage",
          "ClipFrameExtractionStage", "ClipEmbeddingStage", "ClipWriterStage")


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


def _sig(pkg):
    return pkg.FrameExtractionSignature("fps", 8.0)


def _jax_embed():
    """The JAX stage with its seeded init (the same params every time)."""
    return jembed.ClipEmbeddingStage(variant="video", video_cfg=jemb.VIDEO_EMBED_TINY_TEST, extraction=_sig(jdata))


def _port_embed(params):
    return tembed.ClipEmbeddingStage(variant="video", video_cfg=temb.VIDEO_EMBED_TINY_TEST, extraction=_sig(tdata),
                                     params=params, device="cpu")


@pytest.fixture(scope="module")
def saved_runs(tmp_path_factory):
    """Both packages' recorded runs of the same videos: (JAX out, port
    out, the embedder's seeded params as a port state dict)."""
    src = tmp_path_factory.mktemp("replay_src")
    make_scene_video(src / "one.mp4", scene_len_frames=24, num_scenes=2)
    make_scene_video(src / "two.mp4", scene_len_frames=24, num_scenes=1)
    j_out, t_out = tmp_path_factory.mktemp("jax_replay") / "out", tmp_path_factory.mktemp("port_replay") / "out"
    with preserved_observability_state():
        j_embed = _jax_embed()
        j_embed.setup(JWorkerMetadata())  # the seeded init, carried to the port
        params = flax_to_state_dict(j_embed.model._params)
        jsplit.run_split(jsplit.SplitPipelineArgs(input_path=str(src), output_path=str(j_out), extra_stages=[j_embed],
                                                  **SPLIT), runner=JSequentialRunner())
        tsplit.run_split(tsplit.SplitPipelineArgs(input_path=str(src), output_path=str(t_out), device="cpu",
                                                  extra_stages=[_port_embed(params)], **SPLIT),
                         runner=SequentialRunner())
    return j_out, t_out, params


def plain(x):
    """A task tree with the packages' classes taken out: dataclasses and
    objects as dicts of their fields, sequences as lists."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return {f.name: plain(getattr(x, f.name)) for f in dataclasses.fields(x)}
    if isinstance(x, dict):
        return {k: plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [plain(v) for v in x]
    if hasattr(x, "__dict__") and not isinstance(x, (np.ndarray, type)):
        return plain(vars(x))
    if isinstance(x, np.generic):
        return x.item()
    return x


def _flat(batches: list) -> list:
    return sorted((t for batch in batches for t in (batch or [])), key=lambda t: t.video.path)


def _stage_dirs(out: Path) -> set[str]:
    return {p.name for p in (out / "stage_save" / "stage_inputs").iterdir()}


def test_runs_recorded_the_same_stage_inputs(saved_runs):
    j_out, t_out, _ = saved_runs
    assert _stage_dirs(t_out) == _stage_dirs(j_out) == set(STAGES)
    for stage in STAGES:
        j_batches = jreplay.load_saved_batches(str(j_out / "stage_save"), stage)
        t_batches = treplay.load_saved_batches(str(t_out / "stage_save"), stage)
        assert len(t_batches) == len(j_batches) > 0, stage
        if stage in ("ClipEmbeddingStage", "ClipWriterStage"):
            continue  # after the embedder: held in the embed test below
        j_tasks, t_tasks = _flat(j_batches), _flat(t_batches)
        report = tcompare.compare_tasks([plain(t) for t in t_tasks], [plain(t) for t in j_tasks],
                                        ignore_fields=IGNORED)
        assert report.ok(), (stage, report.summary())
    # recorded inputs are real pipeline tasks with encoded clips
    task = treplay.load_saved_batches(str(t_out / "stage_save"), "MotionFilterStage")[0][0]
    assert isinstance(task, tdata.SplitPipeTask) and task.video.clips and task.video.clips[0].encoded_data
    # and hold host data only
    assert treplay.cuda_tensor_paths(task) == []


def _motion_scores(batches) -> np.ndarray:
    return np.array([c.motion_score_global for t in _flat(batches) for c in t.video.clips], np.float64)


def test_replayed_motion_outputs_match_jax(saved_runs):
    """Replay the recorded motion-stage inputs twice through fresh port
    stages: the golden diff passes, and the outputs equal the JAX
    package's replay."""
    j_out, t_out, _ = saved_runs
    first = treplay.run_stage_replay(tmotion.MotionFilterStage(score_only=True, backend="frame-diff", device="cpu"),
                                     str(t_out / "stage_save"))
    second = treplay.run_stage_replay(tmotion.MotionFilterStage(score_only=True, backend="frame-diff", device="cpu"),
                                      str(t_out / "stage_save"))
    assert first and len(first) == len(second)
    for a, g in zip(first, second):
        report = tcompare.compare_tasks(a, g)
        assert report.ok(), report.summary()
    j_first = jreplay.run_stage_replay(jmotion.MotionFilterStage(score_only=True, backend="frame-diff"),
                                       str(j_out / "stage_save"))
    scores, j_scores = _motion_scores(first), _motion_scores(j_first)
    assert scores.size == j_scores.size > 0 and np.isfinite(scores).all()
    np.testing.assert_allclose(scores, j_scores, atol=SCORE_ATOL, rtol=SCORE_RTOL)
    report = tcompare.compare_tasks([plain(t) for t in _flat(first)], [plain(t) for t in _flat(j_first)],
                                    ignore_fields=IGNORED)
    assert report.ok(), report.summary()


def test_replayed_embeddings_match_jax_and_the_run(saved_runs):
    """The embed stage replayed over its saved batches: within the bf16
    bound of the JAX replay, and equal to the inputs the run saved for the
    stage after it (the writer)."""
    j_out, t_out, params = saved_runs
    replayed = _flat(treplay.run_stage_replay(_port_embed(params), str(t_out / "stage_save")))
    j_replayed = _flat(jreplay.run_stage_replay(_jax_embed(), str(j_out / "stage_save")))
    embs = {str(c.uuid): c.embeddings["video-embed-tpu"] for t in replayed for c in t.video.clips}
    j_embs = {str(c.uuid): c.embeddings["video-embed-tpu"] for t in j_replayed for c in t.video.clips}
    assert set(embs) == set(j_embs) and len(embs) == 3
    for uuid, emb in embs.items():
        np.testing.assert_allclose(emb, j_embs[uuid], atol=EMBED_TOL)
    saved_next = _flat(treplay.load_saved_batches(str(t_out / "stage_save"), "ClipWriterStage"))
    report = tcompare.compare_tasks(replayed, saved_next)
    assert report.ok(), report.summary()


def test_compare_flags_a_drifted_stage(saved_runs):
    """Replaying with other stage parameters gives a failing report in
    both packages, at the same paths."""
    j_out, t_out, _ = saved_runs
    reports = {}
    for name, pkg_motion, pkg_replay, pkg_compare, out in (
        ("port", tmotion, treplay, tcompare, t_out), ("jax", jmotion, jreplay, jcompare, j_out),
    ):
        kw = {"device": "cpu"} if name == "port" else {}
        base = pkg_replay.run_stage_replay(pkg_motion.MotionFilterStage(score_only=True, backend="frame-diff", **kw),
                                           str(out / "stage_save"))
        drifted = pkg_replay.run_stage_replay(
            pkg_motion.MotionFilterStage(score_only=True, backend="frame-diff", sample_fps=1.0, **kw),
            str(out / "stage_save"))
        reports[name] = [pkg_compare.compare_tasks(a, g) for a, g in zip(base, drifted)]
    assert any(not r.ok() for r in reports["port"]), "parameter drift went undetected"
    assert [r.ok() for r in reports["port"]] == [r.ok() for r in reports["jax"]]
    assert [sorted(m.path for m in r.mismatches) for r in reports["port"]] == \
        [sorted(m.path for m in r.mismatches) for r in reports["jax"]]


# -- compare_tasks on the same trees in both packages --------------------------


@dataclasses.dataclass
class Tok:
    value: int = 0
    arr: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(3, np.float32))
    meta: dict = dataclasses.field(default_factory=dict)
    items: list = dataclasses.field(default_factory=list)
    stage_perf: float = 0.0


class Obj:
    def __init__(self, **kw):
        self.__dict__.update(kw)


TREES = {
    "equal": ([Tok(1, np.ones(3, np.float32), {"a": 1.0}, [1, "x"])],
              [Tok(1, np.ones(3, np.float32), {"a": 1.0}, [1, "x"])]),
    "array_drift": ([Tok(arr=np.ones(3, np.float32))], [Tok(arr=np.ones(3, np.float32) + 0.5)]),
    "shape": ([Tok(arr=np.ones(3, np.float32))], [Tok(arr=np.ones(4, np.float32))]),
    "int_array": ([Tok(arr=np.arange(3))], [Tok(arr=np.arange(3)[::-1].copy())]),
    "scalars": ([Tok(value=1, meta={"f": 1.0, "s": "a", "n": None})], [Tok(value=2, meta={"f": 1.5, "s": "b", "n": 1})]),
    "missing_key": ([Tok(meta={"a": 1, "b": 2})], [Tok(meta={"a": 1})]),
    "lengths": ([Tok(items=[1, 2])], [Tok(items=[1])]),
    "nested": ([Tok(items=[Obj(x=np.zeros(2), y=[1.0])])], [Tok(items=[Obj(x=np.ones(2), y=[1.25])])]),
    "types": ([Tok(items=[1])], [Tok(items=["1"])]),
    "count": ([Tok(), Tok()], [Tok()]),
    "ignored": ([Tok(stage_perf=1.0)], [Tok(stage_perf=2.0)]),
    "nan": ([Tok(arr=np.full(3, np.nan, np.float32), meta={"x": float("nan")})],
            [Tok(arr=np.full(3, np.nan, np.float32), meta={"x": float("nan")})]),
}


@pytest.mark.parametrize("case", list(TREES))
@pytest.mark.parametrize("atol", [1e-5, 1.0])
def test_compare_gives_the_same_mismatches_as_jax(case, atol):
    actual, golden = TREES[case]
    report = tcompare.compare_tasks(actual, golden, atol=atol)
    j_report = jcompare.compare_tasks(actual, golden, atol=atol)
    assert (report.total, report.passed, report.ok()) == (j_report.total, j_report.passed, j_report.ok())
    assert [(m.path, m.reason) for m in report.mismatches] == [(m.path, m.reason) for m in j_report.mismatches]
    assert report.summary() == j_report.summary()
    # within atol 1.0 the float drifts pass
    if case in ("equal", "ignored", "nan") or (atol == 1.0 and case in ("array_drift", "nested")):
        assert report.ok()
    else:
        assert not report.ok()


@pytest.mark.parametrize("case", ["equal", "array_drift", "shape", "int", "bf16", "vs_numpy"])
def test_compare_reads_tensors_as_numpy(case):
    """A torch tensor compares as its CPU numpy array, under the same shape
    and atol rules (the reference's compare walks no tensors); the result
    is the JAX package's on the same trees with numpy arrays."""
    base = np.linspace(0.0, 1.0, 6, dtype=np.float32).reshape(2, 3)
    a, g = {
        "equal": (torch.from_numpy(base.copy()), torch.from_numpy(base.copy())),
        "array_drift": (torch.from_numpy(base.copy()), torch.from_numpy(base + 0.25)),
        "shape": (torch.from_numpy(base.copy()), torch.from_numpy(base.reshape(3, 2).copy())),
        "int": (torch.arange(4), torch.arange(4).flip(0)),
        "bf16": (torch.from_numpy(base).bfloat16(), torch.from_numpy(base).bfloat16()),
        "vs_numpy": (torch.from_numpy(base.copy()), base.copy()),
    }[case]
    report = tcompare.compare_tasks([Tok(meta={"t": a})], [Tok(meta={"t": g})], atol=1e-3)

    def as_np(x):
        return x.float().numpy() if isinstance(x, torch.Tensor) and x.dtype == torch.bfloat16 else \
            (x.numpy() if isinstance(x, torch.Tensor) else x)

    j_report = jcompare.compare_tasks([Tok(meta={"t": as_np(a)})], [Tok(meta={"t": as_np(g)})], atol=1e-3)
    assert [(m.path, m.reason) for m in report.mismatches] == [(m.path, m.reason) for m in j_report.mismatches]
    assert report.ok() == (case in ("equal", "bf16", "vs_numpy"))
    # without the branch a tensor fell through to vars(): never a real diff
    assert all("__dict__" not in m.reason for m in report.mismatches)


# -- the CUDA-tensor guard ---------------------------------------------------


class FakeCudaTensor(torch.Tensor):
    """A CPU tensor that says it lies on the card (no card here)."""

    @property
    def is_cuda(self):
        return True


@dataclasses.dataclass
class Held(PipelineTask):
    value: int = 0
    payload: object = None


class Echo(Stage):
    def process_data(self, tasks):
        return tasks


def test_a_task_holding_a_cuda_tensor_is_not_saved(tmp_path):
    on_card = torch.zeros(2).as_subclass(FakeCudaTensor)
    assert treplay.cuda_tensor_paths([Held(payload={"x": [np.zeros(2), on_card]})]) == ["$[0].payload.x[1]"]
    assert treplay.cuda_tensor_paths([Held(payload=torch.zeros(2))]) == []
    stage = treplay.stage_save_wrapper(Echo(), treplay.StageSaveConfig(output_path=str(tmp_path), sample_rate=1.0))
    out = run_pipeline([Held(value=1, payload=torch.zeros(2))], [stage], runner=SequentialRunner())
    assert out[0].value == 1 and len(treplay.load_saved_batches(str(tmp_path), "Echo")) == 1
    with pytest.raises(ValueError, match=r"CUDA tensors at \['batch\[0\]\.payload'\]"):
        run_pipeline([Held(value=2, payload=on_card)], [stage], runner=SequentialRunner())
    assert len(treplay.load_saved_batches(str(tmp_path), "Echo")) == 1  # nothing written for it


def test_saved_file_names_match_the_reference(tmp_path):
    """``<out>/stage_inputs/<stage>/batch-<ns>.pkl``, byte for byte the
    reference's layout, readable by the JAX package's loader."""
    stage = treplay.stage_save_wrapper(Echo(), treplay.StageSaveConfig(output_path=str(tmp_path), sample_rate=1.0))
    run_pipeline([Held(value=i) for i in range(3)], [stage], runner=SequentialRunner())
    files = sorted((tmp_path / "stage_inputs" / "Echo").iterdir())
    assert len(files) == 3 and all(f.name.startswith("batch-") and f.suffix == ".pkl" for f in files)
    assert all(f.name[len("batch-"):-len(".pkl")].isdigit() for f in files)
    batches = jreplay.load_saved_batches(str(tmp_path), "Echo")
    assert sorted(b[0].value for b in batches) == [0, 1, 2]
    assert os.path.basename(str(files[0].parent)) == stage.name == "Echo"
