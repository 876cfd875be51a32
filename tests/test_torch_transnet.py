"""Port parity: TransNetV2 shot detection.

- ``convert_jax`` on a flax 3-D ``nn.Conv`` kernel: the converted
  ``Conv3d`` gives the flax conv's output (channels-last in, channels-first
  in the port), fp32, atol 1e-5.
- ``TransNet`` at ``TRANSNET_TINY_TEST`` and at the default config against
  the JAX module on the same parameters (drawn from a seed into the flax
  tree, carried over by ``models/convert_jax.py``), fp32 on the CPU at the
  whole-model bar (atol 1e-4, rtol 1e-3).
- ``predict_transitions`` on 75 frames (four windows, the last padded by
  its last frame; batches of 3 windows), fp32, at the same bar, at
  ``TRANSNET_TINY_TEST`` (the XLA CPU convolutions of the default config
  take seconds a window).
- ``scene_spans_from_predictions`` and ``decode_frames``: exactly equal.
- ``TransNetV2ClipExtractionStage`` after ``VideoDownloadStage`` against
  the JAX stages under each package's ``SequentialRunner``, in bf16 as
  both serve, at ``TRANSNET_TINY_TEST``: the same spans and clip uuids, at a threshold in the widest
  gap between the JAX probabilities, which both packages' probabilities
  (within the bf16 bound, 2e-2) straddle alike.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import flax.linen as fnn
import jax
import jax.numpy as jnp

from cosmos_curate_tpu.core.pipeline import run_pipeline as jrun_pipeline
from cosmos_curate_tpu.core.runner import SequentialRunner as JSequentialRunner
from cosmos_curate_tpu.data import model as jdata
from cosmos_curate_tpu.models import registry as jregistry
from cosmos_curate_tpu.models import transnetv2 as jtn
from cosmos_curate_tpu.pipelines.video.stages import download as jdownload
from cosmos_curate_tpu.pipelines.video.stages import shot_detection as jshot
from cosmos_curate_tpu.video import decode as jdecode
from cosmos_curate_tpu.video import splitter as jsplitter
from cosmos_curate_tpu_torch.core.pipeline import run_pipeline
from cosmos_curate_tpu_torch.core.runner import SequentialRunner
from cosmos_curate_tpu_torch.data import model as tdata
from cosmos_curate_tpu_torch.models import transnetv2 as ttn
from cosmos_curate_tpu_torch.models.convert_jax import flax_to_state_dict, load_flax_params
from cosmos_curate_tpu_torch.pipelines.video.stages import download as tdownload
from cosmos_curate_tpu_torch.pipelines.video.stages import shot_detection as tshot
from cosmos_curate_tpu_torch.video import decode as tdecode
from cosmos_curate_tpu_torch.video import splitter as tsplitter
from tests.fixtures.media import make_scene_video

ATOL, RTOL = 1e-4, 1e-3
STAGE_TOL = 2e-2
CONFIGS = {"tiny-test": "TRANSNET_TINY_TEST", "default": None}


@pytest.fixture(autouse=True)
def _weights_root(tmp_path, monkeypatch):
    """No staged checkpoint; the JAX registry's seeded init runs jitted (the
    same values, in a fraction of the eager init's time)."""
    monkeypatch.setenv(jregistry.WEIGHTS_DIR_ENV, str(tmp_path / "weights"))
    load_params = jregistry.load_params
    monkeypatch.setattr(jregistry, "load_params",
                        lambda model_id, init_fn, **kw: load_params(model_id, jax.jit(init_fn), **kw))


def _cfgs(name):
    if CONFIGS[name] is None:
        return jtn.TransNetConfig(), ttn.TransNetConfig()
    return getattr(jtn, CONFIGS[name]), getattr(ttn, CONFIGS[name])


def _frames(seed, shape):
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)


def test_configs_mirror_the_reference_field_for_field():
    for name in CONFIGS:
        jc, tc = _cfgs(name)
        assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    for const in ("WINDOW", "STRIDE", "INPUT_H", "INPUT_W"):
        assert getattr(ttn, const) == getattr(jtn, const)
    assert ttn.TransNetV2.MODEL_ID == jtn.TransNetV2TPU.MODEL_ID


def test_bridge_maps_a_flax_3d_conv_kernel():
    x = np.random.default_rng(0).standard_normal((2, 6, 5, 7, 3)).astype(np.float32)
    conv = fnn.Conv(5, kernel_size=(3, 3, 3), kernel_dilation=(2, 1, 1), padding="SAME")
    params = conv.init(jax.random.PRNGKey(0), jnp.asarray(x))
    want = np.asarray(conv.apply(params, jnp.asarray(x)))
    sd = flax_to_state_dict(params)
    assert tuple(sd["weight"].shape) == (5, 3, 3, 3, 3)
    got = torch.nn.functional.conv3d(torch.from_numpy(x).permute(0, 4, 1, 2, 3), sd["weight"], sd["bias"],
                                     padding=(2, 1, 1), dilation=(2, 1, 1)).permute(0, 2, 3, 4, 1).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)


def seeded_params(module, frames, seed: int = 0):
    """The module's flax parameter tree (its shapes from ``jax.eval_shape``,
    no compile) filled from ``seed`` with numpy: kernels at variance 1 /
    fan-in, biases and norm offsets at 0.1, norm scales around 1, so every
    parameter shows in the output. (XLA compiles the default config's
    init for ~10 s on the CPU.)"""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), jnp.asarray(frames))

    def draw(path, leaf):
        name = path[-1].key
        if name == "kernel":
            return (rng.standard_normal(leaf.shape) / np.sqrt(np.prod(leaf.shape[:-1]))).astype(np.float32)
        base = 1.0 if name == "scale" else 0.0
        return (base + 0.1 * rng.standard_normal(leaf.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, fnn.meta.unbox(shapes))


@pytest.mark.parametrize("name", list(CONFIGS))
def test_model_matches_jax(name):
    jcfg, tcfg = _cfgs(name)
    frames = _frames(1, (2, jtn.WINDOW, jtn.INPUT_H, jtn.INPUT_W, 3))
    jm = jtn.TransNet(jcfg, dtype=jnp.float32)
    params = seeded_params(jm, frames[:1])
    want = np.asarray(jax.jit(jm.apply)(params, jnp.asarray(frames)))
    tm = ttn.TransNet(tcfg, dtype=torch.float32)
    load_flax_params(tm, params)
    with torch.no_grad():
        got = tm(torch.from_numpy(frames)).numpy()
    assert got.shape == (2, jtn.WINDOW) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


def test_predict_transitions_matches_jax(monkeypatch):
    """75 frames at 54x96 (resized on the host): windows at 0, 16, 32, 48,
    the last padded with its last frame, in batches of 3 windows."""
    monkeypatch.setattr(jtn, "TransNet", functools.partial(jtn.TransNet, dtype=jnp.float32))
    monkeypatch.setattr(ttn, "TransNet", functools.partial(ttn.TransNet, dtype=torch.float32))
    jmodel = jtn.TransNetV2TPU(batch_windows=3, cfg=jtn.TRANSNET_TINY_TEST)
    jmodel.setup()
    tmodel = ttn.TransNetV2(batch_windows=3, cfg=ttn.TRANSNET_TINY_TEST, params=flax_to_state_dict(jmodel._params),
                            device="cpu")
    tmodel.setup()
    frames = _frames(2, (75, 54, 96, 3))
    want = jmodel.predict_transitions(frames)
    got = tmodel.predict_transitions(frames)
    assert got.shape == (75,) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    assert [r.rows for r in tmodel.device_pipeline.records] == [3, 1]
    assert tmodel.predict_transitions(frames[:0]).shape == (0,)


@pytest.mark.parametrize("kw", [
    dict(threshold=0.4), dict(threshold=0.6, min_scene_len_s=0.5), dict(threshold=0.5, crop_s=0.1),
    dict(threshold=0.3, min_scene_len_s=0.2, max_scene_len_s=0.7), dict(threshold=2.0, min_scene_len_s=1.0),
    dict(threshold=0.5, min_scene_len_s=0.3, timestamps=True),
])
def test_scene_spans_match_jax(kw):
    kw = dict(kw)
    probs = np.random.default_rng(3).random(75).astype(np.float32)
    if kw.pop("timestamps", False):
        kw["timestamps_s"] = np.cumsum(np.random.default_rng(4).uniform(0.03, 0.05, 75))
    got = tsplitter.scene_spans_from_predictions(probs, 24.0, **kw)
    assert got == jsplitter.scene_spans_from_predictions(probs, 24.0, **kw)
    assert tsplitter.scene_spans_from_predictions(probs[:0], 24.0) == []


@pytest.fixture(scope="module")
def videos(tmp_path_factory):
    d = tmp_path_factory.mktemp("shot_videos")
    for i, scenes in enumerate((3, 4)):
        make_scene_video(d / f"video_{i}.mp4", scene_len_frames=24, num_scenes=scenes)
    return d


@pytest.mark.parametrize("kw", [dict(), dict(resize_hw=(27, 48)), dict(start_frame=5, num_frames=7, stride=3)])
def test_decode_frames_is_bit_equal(videos, kw):
    src = str(videos / "video_0.mp4")
    want = jdecode.decode_frames(src, **kw)
    got = tdecode.decode_frames(src, **kw)
    assert got.shape == want.shape and got.shape[0] > 0
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tdecode.decode_frames((videos / "video_0.mp4").read_bytes(), **kw), want)


def _tasks(data_mod, videos):
    return [data_mod.SplitPipeTask(video=data_mod.Video(path=str(p))) for p in sorted(videos.glob("*.mp4"))]


def test_stage_matches_jax_stage(videos):
    jmodel = jtn.TransNetV2TPU(cfg=jtn.TRANSNET_TINY_TEST)
    jmodel.setup()
    params = flax_to_state_dict(jmodel._params)
    tmodel = ttn.TransNetV2(cfg=ttn.TRANSNET_TINY_TEST, params=params, device="cpu")
    tmodel.setup()
    frames = [jdecode.decode_frames(str(p), resize_hw=(27, 48)) for p in sorted(videos.glob("*.mp4"))]
    j_probs = np.concatenate([jmodel.predict_transitions(f) for f in frames])
    t_probs = np.concatenate([tmodel.predict_transitions(f) for f in frames])
    diff = float(np.abs(t_probs - j_probs).max())
    assert diff <= STAGE_TOL
    ordered = np.sort(j_probs)
    lo, hi = len(ordered) // 2, len(ordered) - 3  # a threshold that cuts a few frames
    gaps = ordered[lo + 1 : hi] - ordered[lo : hi - 1]
    i = lo + int(np.argmax(gaps))
    assert ordered[i + 1] - ordered[i] > 2 * diff, (ordered, diff)
    threshold = float(ordered[i] + ordered[i + 1]) / 2

    def stages(pkg_download, pkg_shot, model):
        return [pkg_download.VideoDownloadStage(),
                pkg_shot.TransNetV2ClipExtractionStage(threshold=threshold, min_clip_len_s=0.25, model=model)]

    jt = jrun_pipeline(_tasks(jdata, videos), stages(jdownload, jshot, jmodel), runner=JSequentialRunner())
    tt = run_pipeline(_tasks(tdata, videos), stages(tdownload, tshot, tmodel), runner=SequentialRunner())
    spans = [[(c.span, str(c.uuid)) for c in t.video.clips] for t in tt]
    assert spans == [[(c.span, str(c.uuid)) for c in t.video.clips] for t in jt]
    assert [t.video.num_total_clips for t in tt] == [t.video.num_total_clips for t in jt]
    assert sum(len(s) for s in spans) > len(spans)  # some video was cut
    assert all(not t.video.errors for t in tt)


def test_stage_records_a_failure_on_the_video(tmp_path):
    bad = tmp_path / "bad.mp4"
    bad.write_bytes(b"not a video")
    task = tdata.SplitPipeTask(video=tdata.Video(path=str(bad)))
    stage = tshot.TransNetV2ClipExtractionStage(model=ttn.TransNetV2(cfg=ttn.TRANSNET_TINY_TEST, device="cpu"))
    (out,) = stage.process_data([task])
    assert "shot_detection" in out.video.errors and out.video.clips == []
