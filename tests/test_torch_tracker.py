"""Port parity: the NCC and siamese trackers, the motion prompt, the event
crops and the tracking stage against the JAX package, on the CPU.

Inputs come from a numpy seed (the moving-box clip of
``tests/pipelines/test_tracking.py``, a static scene, random texture and a
panning texture); the siamese weights are the JAX package's seeded init,
carried over through ``models/convert_jax.py``.

Tolerances:
- boxes (so every argmax on the track), motion prompts and event crops:
  exactly equal;
- NCC scores: ``rtol=1e-5, atol=1e-5`` (measured at most 1.8e-5 on a score
  of 1.79: the reference's own fp32 sum moves its score by 2.2e-5 between
  frames whose inputs are equal up to the template update);
- siamese scores: atol 1e-4 / rtol 1e-3 (measured below 1e-8);
- ``EmbedNet``: fp32 model bounds, atol 1e-4 / rtol 1e-3 (measured 6e-7 on
  outputs up to 0.83).
"""

from __future__ import annotations

import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cosmos_curate_tpu.data import model as jdata
from cosmos_curate_tpu.models import registry as jregistry
from cosmos_curate_tpu.models import tracker as jtracker
from cosmos_curate_tpu.models import tracker_learned as jlearned
from cosmos_curate_tpu.pipelines.video.stages import per_event_caption as jevent
from cosmos_curate_tpu.pipelines.video.stages import tracking as jtracking
from cosmos_curate_tpu.video.encode import encode_frames
from cosmos_curate_tpu_torch.data import model as tdata
from cosmos_curate_tpu_torch.models import registry as tregistry
from cosmos_curate_tpu_torch.models import tracker as ttracker
from cosmos_curate_tpu_torch.models import tracker_learned as tlearned
from cosmos_curate_tpu_torch.models.convert_jax import flax_to_state_dict
from cosmos_curate_tpu_torch.pipelines.video.stages import per_event_caption as tevent
from cosmos_curate_tpu_torch.pipelines.video.stages import tracking as ttracking
from tests.pipelines.test_tracking import _moving_box_frames

NCC_RTOL = NCC_ATOL = 1e-5
SIAMESE_ATOL, SIAMESE_RTOL = 1e-4, 1e-3


def _static_scene():
    frames = np.full((10, 64, 64, 3), 90, np.uint8)
    frames[:, 20:36, 20:36] = 200
    return frames, (20.0, 20.0, 16.0, 16.0), 64


def _random_texture():
    rng = np.random.default_rng(1)
    return rng.integers(0, 256, (16, 96, 160, 3), dtype=np.uint8), (30.0, 20.0, 20.0, 30.0), 128


def _panning_texture():
    rng = np.random.default_rng(2)
    base = rng.integers(0, 256, (180, 320, 3), dtype=np.uint8)
    frames = np.stack([np.roll(base, 2 * i, axis=1) for i in range(20)])
    return frames, (100.0, 60.0, 40.0, 40.0), 128


def _moving_box():
    frames, xs, y, box = _moving_box_frames()
    return frames, (float(xs[0]), float(y), float(box), float(box)), 128


CLIPS = {"moving_box": _moving_box, "static_scene": _static_scene, "random_texture": _random_texture,
         "panning_texture": _panning_texture}


@pytest.mark.parametrize("clip", list(CLIPS))
def test_ncc_tracker_matches_jax(clip):
    frames, box, work = CLIPS[clip]()
    j_boxes, j_scores = jtracker.TemplateTracker(jtracker.TrackerConfig(work_size=work)).track(frames, box)
    boxes, scores = ttracker.TemplateTracker(ttracker.TrackerConfig(work_size=work), device="cpu").track(frames, box)
    np.testing.assert_array_equal(boxes, j_boxes)
    np.testing.assert_allclose(scores, j_scores, rtol=NCC_RTOL, atol=NCC_ATOL)


def test_ncc_tracker_follows_the_moving_box():
    """The reference's own quality check, on the port."""
    frames, xs, y, box = _moving_box_frames()
    boxes, _ = ttracker.TemplateTracker(ttracker.TrackerConfig(work_size=128), device="cpu").track(
        frames, (float(xs[0]), float(y), float(box), float(box)))
    err = np.abs(boxes[:, 0] - xs)
    assert err[-1] < 8 and err.mean() < 6
    assert np.abs(boxes[:, 1] - y).mean() < 6


@pytest.mark.parametrize("box0,work", [((30.5, 17.25, 10.0, 14.0), 128), ((3.0, 2.0, 40.0, 4.0), 128),
                                       ((120.0, 120.0, 90.0, 90.0), 256), ((0.0, 0.0, 1.0, 1.0), 64)])
def test_template_edge_matches_jax(box0, work):
    """A power of two, at least 8 and at most work // 2, from the prompt."""
    box = np.asarray(box0, np.float32)
    extent = max(8.0, 2.0 * float(max(box[2], box[3])))
    want = min(1 << int(np.ceil(np.log2(extent))), work // 2)
    assert ttracker.template_edge(box, work) == want


@pytest.fixture(scope="module")
def siamese_params():
    net = jlearned.EmbedNet(32)
    return net.init(jax.random.PRNGKey(3), jnp.zeros((1, 32, 32, 3)))


def _siamese_pair(params):
    j = jlearned.SiameseTracker()
    j._params = params
    t = tlearned.SiameseTracker(device="cpu")
    tregistry.load_module(t.net, tlearned.MODEL_ID, flax_to_state_dict(params))
    t._ready = True
    return j, t


@pytest.mark.parametrize("clip", ["moving_box", "random_texture", "panning_texture"])
def test_siamese_tracker_matches_jax(clip, siamese_params):
    frames, box, _ = CLIPS[clip]()
    j, t = _siamese_pair(siamese_params)
    j_boxes, j_scores = j.track(frames, box)
    boxes, scores = t.track(frames, box)
    np.testing.assert_array_equal(boxes, j_boxes)
    np.testing.assert_allclose(scores, j_scores, atol=SIAMESE_ATOL, rtol=SIAMESE_RTOL)


@pytest.mark.parametrize("size", [32, 64])
def test_embed_net_matches_jax(size, siamese_params):
    x = np.random.default_rng(size).integers(0, 256, (2, size, size, 3), dtype=np.uint8)
    want = np.asarray(jlearned.EmbedNet(32).apply(siamese_params, jlearned._prep(x)))
    net = tlearned.EmbedNet(32)
    net.load_state_dict(flax_to_state_dict(siamese_params))
    with torch.no_grad():
        got = torch.cat([net(tlearned._prep(torch.from_numpy(f))) for f in x]).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, atol=SIAMESE_ATOL, rtol=SIAMESE_RTOL)


def test_prep_is_bit_equal():
    """``x / 127.5 - 1`` as XLA fuses it (one rounding)."""
    x = np.arange(256, dtype=np.uint8).reshape(1, 16, 16, 1).repeat(3, -1)[0]
    want = np.asarray(jax.jit(jlearned._prep)(x))
    np.testing.assert_array_equal(tlearned._prep(torch.from_numpy(x))[0].permute(1, 2, 0).numpy(), want)


@pytest.mark.parametrize("clip", ["moving_box", "random_texture", "panning_texture", "static_scene"])
def test_propose_motion_box_matches_jax(clip):
    frames = CLIPS[clip]()[0]
    assert ttracking.propose_motion_box(frames) == jtracking.propose_motion_box(frames)
    assert ttracking.propose_motion_box(frames, 0.5, work=64) == jtracking.propose_motion_box(frames, 0.5, work=64)


@pytest.mark.parametrize("num_frames,margin,out_size", [(4, 0.5, 224), (3, 0.0, 32), (6, 1.0, 64)])
def test_crop_track_matches_jax(num_frames, margin, out_size):
    frames, box, _ = _moving_box()
    boxes, scores = ttracker.TemplateTracker(device="cpu").track(frames, box)
    track = [{"frame": i, "x": float(b[0]), "y": float(b[1]), "w": float(b[2]), "h": float(b[3]),
              "score": float(s)} for i, (b, s) in enumerate(zip(boxes, scores))]
    kw = dict(num_frames=num_frames, margin=margin, out_size=out_size)
    np.testing.assert_array_equal(tevent.crop_track(frames, track, **kw), jevent.crop_track(frames, track, **kw))
    assert tevent.EVENT_PROMPT == jevent.EVENT_PROMPT


def _clip_tasks(data, payloads):
    clips = [data.Clip(source_video="v.mp4", span=(float(i), i + 1.0), encoded_data=p) for i, p in enumerate(payloads)]
    return [data.SplitPipeTask(video=data.Video(path="v.mp4", clips=clips))]


@pytest.mark.parametrize("annotated", [False, True])
def test_tracking_stage_matches_jax(annotated):
    """The same clips through both stages (NCC): the same tracks (boxes
    equal, scores within the NCC bounds) and the same annotated mp4s."""
    payloads = [encode_frames(CLIPS[c]()[0], 24.0) for c in ("moving_box", "random_texture", "panning_texture")]
    payloads.append(encode_frames(np.full((1, 32, 32, 3), 7, np.uint8), 24.0))  # one frame: no track
    j_tasks = jtracking.TrackingStage(mode="ncc", write_annotated=annotated).process_data(_clip_tasks(jdata, payloads))
    stage = ttracking.TrackingStage(mode="ncc", write_annotated=annotated, device="cpu")
    stage.setup()
    t_tasks = stage.process_data(_clip_tasks(tdata, payloads))
    for j_clip, t_clip in zip(j_tasks[0].video.clips, t_tasks[0].video.clips, strict=True):
        assert len(t_clip.tracks) == len(j_clip.tracks) and not t_clip.errors
        for track, j_track in zip(t_clip.tracks, j_clip.tracks):
            assert [{k: v for k, v in p.items() if k != "score"} for p in track] == \
                [{k: v for k, v in p.items() if k != "score"} for p in j_track]
            np.testing.assert_allclose([p["score"] for p in track], [p["score"] for p in j_track],
                                       rtol=NCC_RTOL, atol=NCC_ATOL)
        assert t_clip.annotated_mp4 == j_clip.annotated_mp4
        assert (t_clip.annotated_mp4 is not None) == (annotated and bool(t_clip.tracks))


def test_tracking_stage_records_a_clip_that_does_not_decode():
    stage = ttracking.TrackingStage(mode="ncc", device="cpu")
    tasks = stage.process_data(_clip_tasks(tdata, [b"not an mp4"]))
    clip = tasks[0].video.clips[0]
    assert "tracking" in clip.errors and not clip.tracks


def test_tracking_stage_lets_a_device_fault_through(monkeypatch):
    from cosmos_curate_tpu_torch.ops._build import KernelLaunchError

    stage = ttracking.TrackingStage(mode="ncc", device="cpu")

    def fault(frames, box):
        raise KernelLaunchError("launch failed")

    monkeypatch.setattr(stage._tracker, "track", fault)
    with pytest.raises(KernelLaunchError):
        stage.process_data(_clip_tasks(tdata, [encode_frames(_moving_box()[0], 24.0)]))


# -- learned / ncc / auto wiring (tests/pipelines/test_learned_mode_wiring.py)


@pytest.fixture()
def weights_dir(tmp_path, monkeypatch):
    monkeypatch.setenv(jregistry.WEIGHTS_DIR_ENV, str(tmp_path / "w"))
    monkeypatch.setattr(jregistry, "REPO_WEIGHTS_DIR", tmp_path / "nonexistent")
    monkeypatch.setattr(tregistry, "REPO_WEIGHTS_DIR", tmp_path / "nonexistent")
    return tmp_path / "w"


def _stage(package, **kw):
    if package == "jax":
        return jtracking.TrackingStage(**kw)
    return ttracking.TrackingStage(device="cpu", **kw)


@pytest.mark.parametrize("package", ["jax", "port"])
def test_tracking_auto_swaps_and_rescales_threshold(weights_dir, package, siamese_params):
    jregistry.save_params("tracker-siamese-tpu", siamese_params)
    stage = _stage(package, mode="auto", min_score=0.2, learned_min_score=0.01)
    stage.setup()
    assert type(stage._tracker).__name__ == "SiameseTracker"
    assert stage.min_score == 0.01
    if package == "port":
        want = flax_to_state_dict(siamese_params)
        for name, value in stage._tracker.net.state_dict().items():
            torch.testing.assert_close(value, want[name])


@pytest.mark.parametrize("package", ["jax", "port"])
def test_tracking_auto_without_weights_keeps_ncc(weights_dir, package):
    stage = _stage(package, mode="auto", min_score=0.2)
    stage.setup()
    assert type(stage._tracker).__name__ == "TemplateTracker"
    assert stage.min_score == 0.2


@pytest.mark.parametrize("package", ["jax", "port"])
def test_tracking_auto_with_mismatched_checkpoint_keeps_ncc(weights_dir, package):
    ckpt = weights_dir / "tracker-siamese-tpu" / "params.msgpack"
    ckpt.parent.mkdir(parents=True)
    ckpt.write_bytes(flax.serialization.to_bytes({"params": {"bogus": jnp.zeros((3, 3))}}))
    stage = _stage(package, mode="auto", min_score=0.2)
    stage.setup()
    assert type(stage._tracker).__name__ == "TemplateTracker" and stage.min_score == 0.2


@pytest.mark.parametrize("package", ["jax", "port"])
def test_tracking_learned_without_weights_raises(weights_dir, package):
    with pytest.raises(RuntimeError):
        _stage(package, mode="learned").setup()


def test_tracking_ncc_mode_ignores_a_staged_checkpoint(weights_dir, siamese_params):
    jregistry.save_params("tracker-siamese-tpu", siamese_params)
    stage = _stage("port", mode="ncc", min_score=0.2)
    stage.setup()
    assert type(stage._tracker).__name__ == "TemplateTracker" and stage.min_score == 0.2


def test_unknown_tracking_mode_raises():
    with pytest.raises(ValueError, match="unknown tracking mode"):
        ttracking.TrackingStage(mode="sam", device="cpu")


def test_tracking_stage_resources():
    assert ttracking.TrackingStage(device="cpu").resources.gpus == 0.0
    assert jtracking.TrackingStage().resources.tpus == 0.5


@pytest.mark.parametrize("name", ["TrackerConfig", "SiameseConfig"])
def test_tracker_configs_mirror_the_reference_field_for_field(name):
    import dataclasses

    port = getattr(ttracker if name == "TrackerConfig" else tlearned, name)
    ref = getattr(jtracker if name == "TrackerConfig" else jlearned, name)
    assert dataclasses.asdict(port()) == dataclasses.asdict(ref())
    assert tlearned.STRIDE == jlearned.STRIDE
