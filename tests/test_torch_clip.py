"""Port parity: CLIP image embeddings, the aesthetic head and the aesthetic
filter stage.

- ``CLIPImageModel`` (the ViT of ``CLIPImageEmbeddings``, preprocessing
  and the fp32 normalisation included) against the JAX embed function on
  the same parameters (its seeded init, carried over by
  ``models/convert_jax.py``), fp32 on the CPU at the whole-model bar (atol
  1e-4, rtol 1e-3): at ``clip-vit-tiny-test``, and at the B/16 entry of
  ``_CONFIGS`` with its depth cut to 2, so ``quick_gelu``,
  ``ln_eps=1e-5`` and ``preprocess="clip"`` all run.
- ``preprocess_frames(mode="clip")`` at non-square inputs that are not
  224 (shrunk and enlarged), at the same bar.
- ``AestheticMLP`` at the same bar, and ``CLIPAestheticScorer`` in bf16 as
  both packages serve it.
- ``AestheticFilterStage`` and ``ClipEmbeddingStage(variant="clip")``
  against the JAX stages under each package's ``SequentialRunner``:
  scores and embeddings within the embed stage's bf16 bound (2e-2,
  ``test_torch_embedder.py``), the same kept / filtered partition.
"""

import dataclasses

import numpy as np
import pytest
import torch

import flax.linen as fnn
import jax
import jax.numpy as jnp

from cosmos_curate_tpu.core.pipeline import run_pipeline as jrun_pipeline
from cosmos_curate_tpu.core.runner import SequentialRunner as JSequentialRunner
from cosmos_curate_tpu.data import model as jdata
from cosmos_curate_tpu.models import clip as jclip
from cosmos_curate_tpu.models import registry as jregistry
from cosmos_curate_tpu.models import vit as jvit
from cosmos_curate_tpu.pipelines.video.stages import aesthetic_filter as jaes
from cosmos_curate_tpu.pipelines.video.stages import embedding as jembed
from cosmos_curate_tpu_torch.core.pipeline import run_pipeline
from cosmos_curate_tpu_torch.core.runner import SequentialRunner
from cosmos_curate_tpu_torch.data import model as tdata
from cosmos_curate_tpu_torch.models import clip as tclip
from cosmos_curate_tpu_torch.models import registry as tregistry
from cosmos_curate_tpu_torch.models import vit as tvit
from cosmos_curate_tpu_torch.models.convert_jax import flax_to_state_dict, load_flax_params
from cosmos_curate_tpu_torch.pipelines.video.stages import aesthetic_filter as taes
from cosmos_curate_tpu_torch.pipelines.video.stages import embedding as tembed

ATOL, RTOL = 1e-4, 1e-3
STAGE_TOL = 2e-2
TINY = "clip-vit-tiny-test"


@pytest.fixture(autouse=True)
def _weights_root(tmp_path, monkeypatch):
    """No staged checkpoint: both registries fall back to their seeded init."""
    assert jregistry.WEIGHTS_DIR_ENV == tregistry.WEIGHTS_DIR_ENV
    monkeypatch.setenv(jregistry.WEIGHTS_DIR_ENV, str(tmp_path / "weights"))


def _frames(seed, n, h=32, w=32):
    return np.random.default_rng(seed).integers(0, 256, (n, h, w, 3), dtype=np.uint8)


def test_configs_mirror_the_reference_field_for_field():
    assert dataclasses.asdict(tvit.VIT_L_14) == dataclasses.asdict(jvit.VIT_L_14)
    assert tclip._CONFIGS.keys() == jclip._CONFIGS.keys()
    for name, cfg in jclip._CONFIGS.items():
        assert dataclasses.asdict(tclip._CONFIGS[name]) == dataclasses.asdict(cfg), name
    assert tclip.AestheticMLP.hidden == jclip.AestheticMLP.hidden
    assert tclip.AestheticScorer.MODEL_ID == jclip.AestheticScorer.MODEL_ID


def _jax_embed(cfg, frames):
    """The JAX package's embed function (``clip._jitted_embed``) in fp32, and
    the params it ran with."""
    model = jvit.ViT(cfg, dtype=jnp.float32)
    pixels = jvit.preprocess_frames(jnp.asarray(frames), image_size=cfg.image_size, mode=cfg.preprocess)
    params = fnn.meta.unbox(jax.jit(model.init)(jax.random.PRNGKey(0), pixels[:1]))
    pooled, _ = jax.jit(model.apply)(params, pixels)
    pooled = pooled.astype(jnp.float32)
    return np.asarray(pooled / jnp.linalg.norm(pooled, axis=-1, keepdims=True)), params


@pytest.mark.parametrize("variant,layers,hw", [(TINY, None, (32, 32)), ("clip-vit-b16-tpu", 2, (180, 320))],
                         ids=["tiny-test", "b16-depth-2"])
def test_image_model_matches_jax(variant, layers, hw):
    cfg = jclip._CONFIGS[variant]
    if layers is not None:
        cfg = dataclasses.replace(cfg, layers=layers)
    frames = _frames(1, 3, *hw)
    want, params = _jax_embed(cfg, frames)
    model = tclip.CLIPImageModel(tvit.ViTConfig(**dataclasses.asdict(cfg)), dtype=torch.float32)
    load_flax_params(model, params)
    with torch.no_grad():
        got = model(torch.from_numpy(frames)).numpy()
    assert got.shape == (3, cfg.projection_dim)
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, atol=1e-5)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("hw,size", [((40, 56), 32), ((150, 100), 224)], ids=["shrink", "enlarge"])
def test_clip_preprocess_matches_jax(hw, size):
    frames = _frames(2, 2, *hw)
    want = np.asarray(jvit.preprocess_frames(jnp.asarray(frames), image_size=size, mode="clip"))
    got = tvit.preprocess_frames(torch.from_numpy(frames), image_size=size, mode="clip").numpy()
    assert got.shape == want.shape == (2, size, size, 3)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


def test_aesthetic_mlp_matches_jax():
    emb = np.random.default_rng(3).standard_normal((5, 768)).astype(np.float32)
    jm = jclip.AestheticMLP()
    params = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 768)))
    want = np.asarray(jm.apply(params, jnp.asarray(emb)))
    tm = tclip.AestheticMLP(768)
    load_flax_params(tm, params)
    with torch.no_grad():
        got = tm(torch.from_numpy(emb)).numpy()
    assert got.shape == (5,)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


def _jax_scorer():
    scorer = jclip.CLIPAestheticScorer(TINY)
    scorer.setup()
    return scorer, flax_to_state_dict(scorer.clip._params), flax_to_state_dict(scorer.head._params)


def test_aesthetic_scorer_matches_jax():
    """Both packages' scorers on the same params, bf16 towers as served; the
    head's scores are O(1), held to the stage bound."""
    jscorer, clip_params, head_params = _jax_scorer()
    tscorer = tclip.CLIPAestheticScorer(TINY, clip_params=clip_params, head_params=head_params, device="cpu")
    tscorer.setup()
    assert tscorer.model_id_names == jscorer.model_id_names == [TINY, "aesthetics-mlp-tpu"]
    frames = _frames(4, 5)
    want = np.asarray(jscorer.score_frames(frames))
    got = tscorer.score_frames(frames)
    assert got.shape == (5,) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=STAGE_TOL)


def _tasks(data_mod, key, n_tasks=2, clips=3):
    rng = np.random.default_rng(5)
    tasks = []
    for t in range(n_tasks):
        video = data_mod.Video(path=f"v{t}.mp4")
        for c in range(clips):
            f = rng.integers(0, 256, (3 + c, 32, 32, 3), dtype=np.uint8)
            video.clips.append(data_mod.Clip(source_video=video.path, span=(float(c), c + 1.0),
                                             extracted_frames={key: f}))
        video.clips.append(data_mod.Clip(source_video=video.path, span=(9.0, 10.0)))  # no frames: kept, unscored
        tasks.append(data_mod.SplitPipeTask(video=video))
    return tasks


def _partition(tasks):
    return [([c.span for c in t.video.clips], [(c.span, c.filtered_by) for c in t.video.filtered_clips])
            for t in tasks]


def test_aesthetic_filter_stage_matches_jax():
    """Scores first (``score_only``: every clip kept, scores within the
    bf16 bound), then a threshold in the widest gap between the middle JAX
    scores, which the two packages' scores straddle alike: both stages keep
    and filter the same clips."""
    key = jdata.FrameExtractionSignature("fps", 2.0).key()
    jscorer, clip_params, head_params = _jax_scorer()

    def run_both(**kw):
        jstage = jaes.AestheticFilterStage(**kw)
        jstage._scorer = jscorer
        tstage = taes.AestheticFilterStage(device="cpu", **kw)
        tstage._scorer = tclip.CLIPAestheticScorer(TINY, clip_params=clip_params, head_params=head_params,
                                                   device="cpu")
        return (jrun_pipeline(_tasks(jdata, key), [jstage], runner=JSequentialRunner()),
                run_pipeline(_tasks(tdata, key), [tstage], runner=SequentialRunner()))

    def scores(tasks):
        return [c.aesthetic_score for t in tasks for c in [*t.video.clips, *t.video.filtered_clips]]

    jt, tt = run_both(score_only=True)
    assert _partition(tt) == _partition(jt) and not any(t.video.filtered_clips for t in tt)
    j_scores, t_scores = scores(jt), scores(tt)
    assert [s is None for s in t_scores] == [s is None for s in j_scores] and sum(s is not None for s in j_scores) == 6
    diff = max(abs(a - b) for a, b in zip(t_scores, j_scores) if a is not None)
    assert diff <= STAGE_TOL
    ordered = sorted(s for s in j_scores if s is not None)
    gap, i = max((b - a, i) for i, (a, b) in enumerate(zip(ordered[1:-2], ordered[2:-1]), start=1))
    assert gap > 2 * diff, (ordered, diff)
    threshold = (ordered[i] + ordered[i + 1]) / 2

    jt, tt = run_both(threshold=threshold)
    assert _partition(tt) == _partition(jt)
    filtered = [c for t in tt for c in t.video.filtered_clips]
    assert filtered and all(c.filtered_by == "aesthetic" and c.aesthetic_score < threshold for c in filtered)
    assert all(c.aesthetic_score is None or c.aesthetic_score >= threshold for t in tt for c in t.video.clips)


@pytest.mark.parametrize("reduction,kept,filtered,scores", [
    ("min", [(1.0, 2.0), (9.0, 10.0)], [(0.0, 1.0)], [0.2, 0.5]),
    ("mean", [(0.0, 1.0), (1.0, 2.0), (9.0, 10.0)], [], [0.7, 0.65]),
])
def test_aesthetic_filter_reduces_and_keeps_by_the_reference_rule(reduction, kept, filtered, scores):
    """The reduction and the keep rule (``>= threshold``), on frame scores
    the test sets: clips of 3 and 4 frames, and one without frames."""
    key = tdata.FrameExtractionSignature("fps", 2.0).key()
    stage = taes.AestheticFilterStage(reduction=reduction, threshold=0.5, device="cpu")

    def score_frames(frames):
        assert frames.shape[0] == 7  # every frame of the task in one call
        return np.array([0.2, 0.9, 1.0, 0.6, 0.7, 0.8, 0.5], np.float32)

    stage._scorer.score_frames = score_frames
    (task,) = stage.process_data(_tasks(tdata, key, n_tasks=1, clips=2))
    assert [c.span for c in task.video.clips] == kept
    assert [c.span for c in task.video.filtered_clips] == filtered
    by_span = {c.span: c.aesthetic_score for c in task.video.clips + task.video.filtered_clips}
    assert [by_span[(0.0, 1.0)], by_span[(1.0, 2.0)]] == pytest.approx(scores)
    assert by_span[(9.0, 10.0)] is None


def test_clip_embedding_stage_matches_jax(monkeypatch):
    """Both stages serve the tiny tower under the B/16 id the stage embeds
    with."""
    b16 = "clip-vit-b16-tpu"
    for mod in (jclip, tclip):
        monkeypatch.setitem(mod._CONFIGS, b16, mod._CONFIGS[TINY])
    key = jdata.FrameExtractionSignature("fps", 2.0).key()
    js = jembed.ClipEmbeddingStage(variant="clip")
    js.model.setup()  # the seeded init the runner's setup gives again
    params = flax_to_state_dict(js.model._params)
    jt = jrun_pipeline(_tasks(jdata, key), [js], runner=JSequentialRunner())
    ts = tembed.ClipEmbeddingStage(variant="clip", params=params, device="cpu")
    assert ts.model_name == js.model_name == b16 and ts.variant == "clip"
    tt = run_pipeline(_tasks(tdata, key), [ts], runner=SequentialRunner())
    n = 0
    for jtask, ttask in zip(jt, tt, strict=True):
        for jc, tc in zip(jtask.video.clips, ttask.video.clips, strict=True):
            assert jc.embeddings.keys() == tc.embeddings.keys()
            if b16 in tc.embeddings:
                got = tc.embeddings[b16]
                assert got.dtype == np.float32 and got.shape == (32,)
                assert abs(float(np.linalg.norm(got)) - 1.0) < 1e-5
                np.testing.assert_allclose(got, jc.embeddings[b16], atol=STAGE_TOL)
                n += 1
    assert n == 6


def test_staged_checkpoint_serves_both_packages(tmp_path, monkeypatch):
    """One ``params.msgpack`` written by the JAX registry under the CLIP id
    is what the port's embedder loads (through ``registry.load_module``)."""
    monkeypatch.setenv(jregistry.WEIGHTS_DIR_ENV, str(tmp_path / "staged"))
    cfg = jclip._CONFIGS[TINY]
    model = jvit.ViT(cfg)
    params = model.init(jax.random.PRNGKey(7), jnp.zeros((1, 32, 32, 3)))
    jregistry.save_params(TINY, params)
    emb = tclip.CLIPImageEmbeddings(TINY, device="cpu")
    emb.setup()
    want = flax_to_state_dict(fnn.meta.unbox(params))
    for name, value in emb.model.state_dict().items():
        np.testing.assert_array_equal(value.numpy(), want[name].numpy(), err_msg=name)
    assert tregistry.weights_provenance(TINY).startswith("checkpoint:")
