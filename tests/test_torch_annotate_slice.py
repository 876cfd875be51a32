"""Port parity: the annotate slice as a whole, through ``run_pipeline``.

``ClipEmbeddingStage`` -> ``CaptionPrepStage`` -> ``CaptionStage`` at
``VIDEO_EMBED_TINY_TEST`` + ``tiny-test`` on the CPU, through the port's
``run_pipeline`` with its ``SequentialRunner`` and its ``PipelinedRunner``
(the default runner), against the JAX package's ``run_pipeline`` on the same
tasks. Parameters cross through ``models/convert_jax.py``: the embedder's
from the JAX stage's seeded init, the caption model's from one checkpoint
that the JAX ``registry.save_params`` writes and both stages load.

Tolerances: embeddings within the stage's bf16 bound of 2e-2
(``test_torch_embedder.py``); captions token-equal under the rule of
``test_torch_engine.py`` (bf16 logits within ``LOGIT_TOL`` at every compared
step, and a window's comparison stops at a JAX top-2 margin below
``2 * LOGIT_TOL``, where either token could win).
"""

from __future__ import annotations

import numpy as np
import pytest

from cosmos_curate_tpu.core.pipeline import run_pipeline as jrun_pipeline
from cosmos_curate_tpu.core.runner import SequentialRunner as JSequentialRunner
from cosmos_curate_tpu.core.stage import WorkerMetadata as JWorkerMetadata
from cosmos_curate_tpu.data import model as jdata
from cosmos_curate_tpu.models import embedder as jemb
from cosmos_curate_tpu.models import registry as jregistry
from cosmos_curate_tpu.models.vlm import CaptionEngine as JEngine
from cosmos_curate_tpu.models.vlm import SharedCaptionEngine as JShared
from cosmos_curate_tpu.models.vlm import VLM_TINY_TEST as J_TINY
from cosmos_curate_tpu.pipelines.video.stages import captioning as jcap
from cosmos_curate_tpu.pipelines.video.stages import embedding as jembed
from cosmos_curate_tpu_torch.core.pipeline import run_pipeline
from cosmos_curate_tpu_torch.core.pipelined_runner import PipelinedRunner
from cosmos_curate_tpu_torch.core.runner import SequentialRunner, default_runner
from cosmos_curate_tpu_torch.data import model as tdata
from cosmos_curate_tpu_torch.models import embedder as temb
from cosmos_curate_tpu_torch.models.convert_jax import flax_to_state_dict
from cosmos_curate_tpu_torch.models.vlm import SharedCaptionEngine
from cosmos_curate_tpu_torch.pipelines.video.stages import captioning as tcap
from cosmos_curate_tpu_torch.pipelines.video.stages import embedding as tembed
from tests.test_torch_engine import LOGIT_TOL, _record_logits

EMBED_TOL = 2e-2
MODEL_ID = "caption-vlm-tpu"
N_TASKS, N_CLIPS, N_FRAMES, SIZE = 12, 2, 8, 32
MAX_NEW = 24


def _tasks(data):
    """N_TASKS videos of N_CLIPS 1 s clips at 30 fps (one caption window a
    clip), frames made with numpy from one seed for both packages."""
    rng = np.random.default_rng(11)
    sig = data.FrameExtractionSignature("fps", 8.0)
    return [
        data.SplitPipeTask(video=data.Video(
            path=f"v{t}.mp4",
            metadata=data.VideoMetadata(width=SIZE, height=SIZE, fps=30.0, num_frames=60, duration_s=2.0),
            clips=[
                data.Clip(span=(float(c), float(c + 1)),
                          extracted_frames={sig.key(): rng.integers(0, 256, (N_FRAMES, SIZE, SIZE, 3), np.uint8)})
                for c in range(N_CLIPS)
            ],
        ))
        for t in range(N_TASKS)
    ]


def _by_window(out, trace):
    """(video path, clip span, window index) -> (embedding, caption, the
    logit rows of the caption's greedy steps)."""
    return {
        (t.video.path, c.span, i): (c.embeddings["video-embed-tpu"], w.caption["default"], trace[f"{c.uuid}-{i}"])
        for t in out for c in t.video.clips for i, w in enumerate(c.windows)
    }


@pytest.fixture(scope="module")
def jax_reference(tmp_path_factory):
    """The JAX slice through its run_pipeline (SequentialRunner), with the
    caption checkpoint it wrote and the embedder params it seeded."""
    root = tmp_path_factory.mktemp("weights")
    mp = pytest.MonkeyPatch()
    mp.setenv(jregistry.WEIGHTS_DIR_ENV, str(root))
    JShared.reset()
    try:
        eng = JEngine(J_TINY, max_batch=2)
        eng.setup(9)
        jregistry.save_params(MODEL_ID, eng.params, root=root)
        eng.shutdown()
        sig = jdata.FrameExtractionSignature("fps", 8.0)
        embed = jembed.ClipEmbeddingStage(variant="video", video_cfg=jemb.VIDEO_EMBED_TINY_TEST, extraction=sig)
        embed.setup(JWorkerMetadata())  # the stage's seeded init, carried to the port below
        caption = jcap.CaptionStage(model_flavor="tiny-test", max_new_tokens=MAX_NEW)
        caption.model.setup()  # registers the shared engine, so it can be traced
        trace = _record_logits(caption.model.engine)
        stages = [embed, jcap.CaptionPrepStage(extraction=sig, frames_per_window=2), caption]
        out = jrun_pipeline(_tasks(jdata), stages, runner=JSequentialRunner())
        yield root, flax_to_state_dict(embed.model._params), _by_window(out, trace)
    finally:
        JShared.reset()
        mp.undo()


@pytest.mark.parametrize("runner", ["sequential", "default"])
def test_slice_matches_jax(jax_reference, runner, monkeypatch):
    root, embed_params, want = jax_reference
    monkeypatch.setenv(jregistry.WEIGHTS_DIR_ENV, str(root))
    monkeypatch.delenv("CURATE_RUNNER", raising=False)
    monkeypatch.delenv("CURATE_ENGINE_DRIVER_PORT", raising=False)
    SharedCaptionEngine.reset()
    try:
        sig = tdata.FrameExtractionSignature("fps", 8.0)
        caption = tcap.CaptionStage(model_flavor="tiny-test", max_new_tokens=MAX_NEW, device="cpu")
        caption.model.setup()
        trace = _record_logits(caption.model.engine)
        stages = [
            tembed.ClipEmbeddingStage(variant="video", video_cfg=temb.VIDEO_EMBED_TINY_TEST, extraction=sig,
                                      params=embed_params, device="cpu"),
            tcap.CaptionPrepStage(extraction=sig, frames_per_window=2),
            caption,
        ]
        active = SequentialRunner() if runner == "sequential" else default_runner()
        assert isinstance(active, SequentialRunner if runner == "sequential" else PipelinedRunner)
        out = run_pipeline(_tasks(tdata), stages, runner=active)
        got = _by_window(out, trace)
    finally:
        SharedCaptionEngine.reset()

    assert set(got) == set(want) and len(got) == N_TASKS * N_CLIPS
    compared = 0
    for key, (j_emb, j_text, j_rows) in want.items():
        t_emb, t_text, t_rows = got[key]
        assert t_emb.dtype == np.float32 and t_emb.shape == j_emb.shape
        np.testing.assert_allclose(t_emb, j_emb, atol=EMBED_TOL)
        assert t_text
        full = True
        for step, (j, p) in enumerate(zip(j_rows, t_rows, strict=True)):
            assert np.abs(j - p).max() <= LOGIT_TOL, (key, step)
            top2 = np.sort(j)[-2:]
            if top2[1] - top2[0] < 2 * LOGIT_TOL:
                full = False
                break
            assert int(np.argmax(j)) == int(np.argmax(p)), (key, step)
            compared += 1
        if full:
            assert t_text == j_text, key
    assert compared >= 20
