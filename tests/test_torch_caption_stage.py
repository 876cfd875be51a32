"""Port parity: the caption stages, the shared engine and the weights
registry, on ``tiny-test`` on the CPU.

- ``CaptionPrepStage`` cuts the same windows as the JAX stage: the same
  spans, the same sampled frames (exact) and the same ``frame_fps``.
- ``CaptionStage("tiny-test", device="cpu")`` and the JAX stage load ONE
  checkpoint, written by the JAX ``registry.save_params`` into a temporary
  ``CURATE_MODEL_WEIGHTS_DIR``, and give the same greedy captions.
  Tolerance, as in ``test_torch_engine.py``: the two frameworks' bf16 logits
  agree within ``LOGIT_TOL`` at every compared step; a step whose JAX top-2
  margin is below ``2 * LOGIT_TOL`` could flip either way, so comparison of
  that window stops there. The port's engine must serve the checkpoint,
  not its seeded init: its parameters equal the file's exactly.
- A checkpoint of the wrong shape raises when weights are required and
  falls back to the seeded init when they are not.
- Two stages share one engine and their requests interleave; a registry
  reset during a build does not make a second engine.
- ``refine`` runs a second pass per window; ``max_new_tokens`` clamps to
  half the context; every flavor of the JAX package constructs (the Qwen3
  MoE flavors too).
"""

from __future__ import annotations

import threading
import time

import numpy as np
import pytest
import torch

from cosmos_curate_tpu.data import model as jdata
from cosmos_curate_tpu.models import registry as jregistry
from cosmos_curate_tpu.models.vlm import CaptionEngine as JEngine
from cosmos_curate_tpu.models.vlm import SharedCaptionEngine as JShared
from cosmos_curate_tpu.models.vlm import VLM_TINY_TEST as J_TINY
from cosmos_curate_tpu.pipelines.video.stages import captioning as jcap
from cosmos_curate_tpu_torch.data import model as tdata
from cosmos_curate_tpu_torch.models import registry
from cosmos_curate_tpu_torch.models.convert_jax import flax_to_state_dict
from cosmos_curate_tpu_torch.models.vlm import VLM_BASE, VLM_TINY_TEST, CaptionEngine, SharedCaptionEngine
from cosmos_curate_tpu_torch.pipelines.video.stages import captioning as tcap
from tests.test_torch_engine import LOGIT_TOL, _record_logits

MODEL_ID = "caption-vlm-tpu"
SIG_KEY = "fps-8"


@pytest.fixture(autouse=True)
def _fresh_registries():
    JShared.reset()
    SharedCaptionEngine.reset()
    yield
    JShared.reset()
    SharedCaptionEngine.reset()


def _tasks(data, *, clips=((0.0, 1.0), (2.0, 3.0)), fps=30.0, n_frames=8, size=32, seed=0, n_tasks=2):
    """``n_tasks`` tasks over the clip spans (every other task reversed);
    frames made from ``seed`` with numpy, identical for both packages."""
    rng = np.random.default_rng(seed)
    out = []
    for t in range(n_tasks):
        spans = clips if t % 2 == 0 else clips[::-1]
        video = data.Video(
            path=f"v{t}.mp4",
            metadata=data.VideoMetadata(width=size, height=size, fps=fps, num_frames=300, duration_s=10.0),
            clips=[
                data.Clip(
                    span=span,
                    extracted_frames={SIG_KEY: rng.integers(0, 256, (n_frames, size, size, 3), dtype=np.uint8)},
                )
                for span in spans
            ],
        )
        out.append(data.SplitPipeTask(video=video))
    return out


def _windows(tasks):
    return [w for t in tasks for c in t.video.clips for w in c.windows]


@pytest.mark.parametrize(
    "clips,fps,n_frames",
    [
        (((0.0, 1.0), (2.0, 3.0)), 30.0, 8),  # one window a clip
        (((0.0, 20.0), (1.0, 10.5)), 30.0, 40),  # 600 / 285 source frames: merged runt, two windows
        (((0.0, 12.0),), 24.0, 5),  # 288 source frames: a remainder of its own
    ],
)
def test_prep_windows_match_jax(clips, fps, n_frames):
    jt = _tasks(jdata, clips=clips, fps=fps, n_frames=n_frames)
    tt = _tasks(tdata, clips=clips, fps=fps, n_frames=n_frames)
    sig_j = jdata.FrameExtractionSignature("fps", 8.0)
    sig_t = tdata.FrameExtractionSignature("fps", 8.0)
    jcap.CaptionPrepStage(extraction=sig_j).process_data(jt)
    tcap.CaptionPrepStage(extraction=sig_t).process_data(tt)
    jw, tw = _windows(jt), _windows(tt)
    assert len(tw) == len(jw) >= len(clips) * 2
    for a, b in zip(jw, tw, strict=True):
        assert (b.start_frame, b.end_frame) == (a.start_frame, a.end_frame)
        np.testing.assert_array_equal(b.frames, a.frames)
        assert b.frame_fps == a.frame_fps


def _jax_params(seed: int):
    eng = JEngine(J_TINY, max_batch=2)
    eng.setup(seed)
    params = eng.params
    eng.shutdown()
    return params


@pytest.fixture
def checkpoint(tmp_path, monkeypatch):
    """A tiny-test checkpoint written by the JAX registry, from a seed the
    seeded init does not use."""
    monkeypatch.setenv(jregistry.WEIGHTS_DIR_ENV, str(tmp_path))
    params = _jax_params(seed=3)
    jregistry.save_params(MODEL_ID, params, root=tmp_path)
    return params


def _captioned(stage_mod, data, stage, tasks):
    sig = data.FrameExtractionSignature("fps", 8.0)
    stage_mod.CaptionPrepStage(extraction=sig, frames_per_window=2).process_data(tasks)
    stage.setup(None)
    trace = _record_logits(stage.model.engine)
    stage.process_data(tasks)
    rids = [f"{c.uuid}-{i}" for t in tasks for c in t.video.clips for i in range(len(c.windows))]
    return [trace[r] for r in rids], [w.caption[stage.prompt_variant] for w in _windows(tasks)]


def test_stage_serves_the_checkpoint_and_matches_jax(checkpoint):
    jstage = jcap.CaptionStage(model_flavor="tiny-test", max_new_tokens=24)
    tstage = tcap.CaptionStage(model_flavor="tiny-test", max_new_tokens=24, device="cpu")
    jtrace, jtext = _captioned(jcap, jdata, jstage, _tasks(jdata, n_tasks=6))
    ttrace, ttext = _captioned(tcap, tdata, tstage, _tasks(tdata, n_tasks=6))

    # the ordering trap: the engine that serves holds the file's weights
    served = tstage.model.engine.model.state_dict()
    want = flax_to_state_dict(checkpoint)
    assert set(served) == set(want)
    for name, value in want.items():
        assert torch.equal(served[name].float(), value), name
    seeded = CaptionEngine(VLM_TINY_TEST, max_batch=2, device="cpu")
    seeded.setup()
    assert not torch.equal(seeded.model.state_dict()["embed.weight"], served["embed.weight"])

    assert all(ttext) and len(ttext) == len(jtext) == 12
    compared = 0
    for j_rows, t_rows, jt, tt in zip(jtrace, ttrace, jtext, ttext, strict=True):
        full = True
        for step, (j, p) in enumerate(zip(j_rows, t_rows, strict=True)):
            assert np.abs(j - p).max() <= LOGIT_TOL, step
            top2 = np.sort(j)[-2:]
            if top2[1] - top2[0] < 2 * LOGIT_TOL:
                full = False
                break
            assert int(np.argmax(j)) == int(np.argmax(p)), step
            compared += 1
        if full:
            assert tt == jt
    assert compared >= 20


def _bad_checkpoint(tmp_path, monkeypatch):
    monkeypatch.setenv(registry.WEIGHTS_DIR_ENV, str(tmp_path))
    params = _jax_params(seed=4)
    inner = params["params"]
    key = next(k for k in inner if "embed" in k)
    inner[key] = {"embedding": np.zeros((7, 3), np.float32)}
    jregistry.save_params(MODEL_ID, params, root=tmp_path)


def test_wrong_shape_checkpoint_raises_when_required(tmp_path, monkeypatch):
    _bad_checkpoint(tmp_path, monkeypatch)
    model = tcap._CaptionVLM(VLM_TINY_TEST, 2, require_weights=True, device="cpu")
    with pytest.raises(RuntimeError, match="do not match"):
        model.setup()


def test_wrong_shape_checkpoint_falls_back_to_seeded_init(tmp_path, monkeypatch):
    _bad_checkpoint(tmp_path, monkeypatch)
    model = tcap._CaptionVLM(VLM_TINY_TEST, 2, device="cpu")
    model.setup()
    seeded = CaptionEngine(VLM_TINY_TEST, max_batch=2, device="cpu")
    seeded.setup()
    for name, value in seeded.model.state_dict().items():
        assert torch.equal(model.engine.model.state_dict()[name], value), name


def test_missing_checkpoint_raises_only_when_required(tmp_path, monkeypatch):
    monkeypatch.setenv(registry.WEIGHTS_DIR_ENV, str(tmp_path))
    with pytest.raises(RuntimeError, match="no staged weights"):
        registry.load_params(MODEL_ID, lambda seed: {}, require=True)
    assert registry.load_params(MODEL_ID, lambda seed: {"seed": seed}, seed=5) == {"seed": 5}


def test_two_stages_share_one_engine_and_interleave():
    stages = [
        tcap.CaptionStage(model_flavor="tiny-test", prompt_variant=v, max_batch=4, max_new_tokens=8, device="cpu")
        for v in ("default", "short")
    ]
    for s in stages:
        s.setup(None)
    engine = stages[0].model.engine
    assert stages[1].model.engine is engine and stages[0].owner != stages[1].owner
    # both stages submit every request before either drives the engine
    barrier = threading.Barrier(2)
    drive = engine.run_until_complete

    def run_after_both_submitted(owner=None):
        barrier.wait(timeout=60)
        return drive(owner=owner)

    engine.run_until_complete = run_after_both_submitted
    sig = tdata.FrameExtractionSignature("fps", 8.0)
    task_sets = [tcap.CaptionPrepStage(extraction=sig, frames_per_window=2).process_data(_tasks(tdata, seed=s))
                 for s in (1, 2)]
    errors = []

    def work(stage, tasks):
        try:
            stage.process_data(tasks)
        except Exception as e:  # reported on the main thread below
            errors.append(e)

    threads = [threading.Thread(target=work, args=(s, t)) for s, t in zip(stages, task_sets)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads) and not errors, errors
    for stage, tasks in zip(stages, task_sets):
        assert all(w.caption.get(stage.prompt_variant) for w in _windows(tasks))
        assert engine.owner_decode_tokens.get(stage.owner, 0) > 0
        assert tasks[0].stage_perf["caption_decode_tokens"] > 0
    assert engine.interleaved_decode_steps > 0


def test_reset_during_a_build_does_not_build_twice(monkeypatch):
    """A ``get`` that arrives while another caller's build is in flight waits
    for that build, even when ``reset`` ran in between: one engine is made,
    and both callers hold it."""
    from cosmos_curate_tpu_torch.models.vlm import shared_engine

    building, release = threading.Event(), threading.Event()
    made = []

    class SlowEngine:
        def __init__(self, cfg, **kwargs):
            made.append(self)
            self.device, self.max_batch, self.lanes = kwargs["device"], kwargs["max_batch"], []

        def setup(self):
            building.set()
            assert release.wait(timeout=60)

        def shutdown(self):
            pass

    monkeypatch.setattr(shared_engine, "CaptionEngine", SlowEngine)
    got = []

    def get():
        got.append(SharedCaptionEngine.get(VLM_TINY_TEST, model_id=MODEL_ID, device="cpu"))

    first = threading.Thread(target=get)
    first.start()
    assert building.wait(timeout=60)
    SharedCaptionEngine.reset()
    second = threading.Thread(target=get)
    second.start()
    time.sleep(0.1)  # the second caller reaches the build lock
    release.set()
    for t in (first, second):
        t.join(timeout=60)
    assert len(made) == 1 and len(got) == 2 and got[0] is got[1] is made[0]


def test_refine_runs_a_second_pass_per_window():
    stage = tcap.CaptionStage(model_flavor="tiny-test", refine=True, max_new_tokens=6, device="cpu")
    stage.setup(None)
    sig = tdata.FrameExtractionSignature("fps", 8.0)
    tasks = tcap.CaptionPrepStage(extraction=sig, frames_per_window=2).process_data(_tasks(tdata))
    engine = stage.model.engine
    admitted = engine.requests_admitted
    stage.process_data(tasks)
    windows = _windows(tasks)
    assert engine.requests_admitted - admitted == 2 * len(windows)
    assert len(stage._refined_ids) == len(windows)
    assert all(w.caption.get("default") for w in windows)
    # the second pass bakes the first caption into a one-shot prefix
    assert engine.vision_reuses >= len(windows)


def test_max_new_tokens_clamps_like_jax():
    for asked in (8, 63, 64, 500):
        t = tcap.CaptionStage(model_flavor="tiny-test", max_new_tokens=asked, device="cpu")
        j = jcap.CaptionStage(model_flavor="tiny-test", max_new_tokens=asked)
        assert t.max_new_tokens == j.max_new_tokens == min(asked, 64 if asked >= 64 else asked)


def test_flavors_and_devices():
    for flavor, hf_chat in (("qwen3moe-a3b-lm", True), ("qwen3vl-moe-a3b", True), ("qwen3moe-tiny-test", False)):
        model = tcap.CaptionStage(model_flavor=flavor, device="cpu").model
        assert model.cfg.moe is not None and model.hf_chat == hf_chat
    for flavor in ("qwen2vl-2b", "qwen25vl-7b", "qwen-chat-tiny-test"):
        assert tcap.CaptionStage(model_flavor=flavor, device="cpu").model.hf_chat
    with pytest.raises(ValueError, match="unknown caption model"):
        tcap.CaptionStage(model_flavor="bogus", device="cpu")
    with pytest.raises(ValueError, match="cfg OR model_flavor"):
        tcap.CaptionStage(model_flavor="base", cfg=VLM_TINY_TEST, device="cpu")
    stage = tcap.CaptionStage(model_flavor="base", device="cpu")
    assert stage.model.cfg == VLM_BASE and not stage.resources.uses_gpu
    if torch.cuda.is_available():
        assert tcap.CaptionStage().resources.entire_gpu_host
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tcap.CaptionStage()


def test_adopted_engine_serves_the_stage_and_reports_owners():
    engine = CaptionEngine(VLM_TINY_TEST, max_batch=2, device="cpu")
    engine.setup()
    SharedCaptionEngine.adopt(engine, cfg=VLM_TINY_TEST, model_id=MODEL_ID)
    stage = tcap.CaptionStage(model_flavor="tiny-test", max_new_tokens=4, device="cpu")
    stage.setup(None)
    assert stage.model.engine is engine
    sig = tdata.FrameExtractionSignature("fps", 8.0)
    stage.process_data(tcap.CaptionPrepStage(extraction=sig, frames_per_window=2).process_data(_tasks(tdata)))
    stats = SharedCaptionEngine.stats()[MODEL_ID]
    assert stats["kv_blocks_total"] == engine.kv_blocks_total
    assert stage.owner in stats["owners"]


def test_task_accounting_matches_jax():
    """The runners' task accounting: scheduling weight and progress
    fraction as the JAX data model gives them; the payload size counts at
    least the frames."""
    for duration, chunks in ((30.0, 1), (600.0, 4)):
        jt, tt = _tasks(jdata, n_tasks=1)[0], _tasks(tdata, n_tasks=1)[0]
        for task in (jt, tt):
            task.video.metadata.duration_s = duration
            task.video.num_clip_chunks = chunks
        assert (tt.weight, tt.fraction) == (jt.weight, jt.fraction)
        frames = sum(f.nbytes for c in tt.video.clips for f in c.extracted_frames.values())
        assert frames <= tt.get_major_size() < frames + 4096
