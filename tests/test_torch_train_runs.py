"""Port parity: the trainers' runs (``models/*_train.py``) against the JAX
package's, on the CPU, at small configs.

- **Short runs**: ``train(steps=k)`` gives finite losses that fall: the
  mean of the second half of the run below the first step's loss (the
  init's; batches of 2-4 make the per-step loss noisy); diffusion SR also
  meets the JAX trainer's own
  bar (``tests/models/test_diffusion_sr.py``: below 0.9 after 30 steps at
  lr 2e-3).
- **Per-step losses of a 3-step run** from the JAX run's init and data
  (the same numpy seed; the JAX losses read off its logger at
  ``log_every=1``) against the JAX run's, for every deterministic trainer
  (diffusion draws its timesteps and noise from a torch generator where
  the JAX trainer uses ``jax.random``): the fp32 trainers (the tracker and
  the OCR pair) within rtol 1e-4 (``FP32_RTOL``); TransNet and SR, bf16 in
  both packages, within 2e-2 (``BF16_RTOL``, the share their outputs are
  held to in ``tests/test_torch_transnet.py`` and
  ``tests/test_torch_super_resolution.py``).
- **The round trip**: a checkpoint each port trainer's ``train_and_stage``
  writes loads into the JAX package through ``registry.load_params(...,
  require=True)`` (no fallback to the seeded init) and into the port's
  inference class with ``require_weights=True``; the two packages' models
  then give the same outputs at each model's parity bound: the OCR logits
  atol 1e-4 / rtol 1e-3 (``tests/test_torch_ocr.py``), the tracker's boxes
  exactly and its scores atol 1e-4 / rtol 1e-3
  (``tests/test_torch_tracker.py``), TransNet's probabilities within 2e-2
  (``tests/test_torch_transnet.py``'s stage bound), SR's float frames and
  the denoiser's v prediction within 2e-2 of their largest magnitude and
  SR's uint8 frames within that share of the full scale, 5 levels
  (``tests/test_torch_super_resolution.py``'s bf16 bounds; its 2-level
  bound holds SR on its seeded init, whose residual is small: trained for
  two steps here, the uint8 frames differ by up to 3 levels).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cosmos_curate_tpu.models import diffusion_sr as jdiff
from cosmos_curate_tpu.models import diffusion_sr_train as jdiff_train
from cosmos_curate_tpu.models import ocr as jocr
from cosmos_curate_tpu.models import ocr_train as jocr_train
from cosmos_curate_tpu.models import registry as jregistry
from cosmos_curate_tpu.models import sr_train as jsr_train
from cosmos_curate_tpu.models import super_resolution as jsr
from cosmos_curate_tpu.models import tracker_learned as jtracker
from cosmos_curate_tpu.models import tracker_train as jtracker_train
from cosmos_curate_tpu.models import transnet_train as jtransnet_train
from cosmos_curate_tpu.models import transnetv2 as jtransnet
from cosmos_curate_tpu_torch.models import diffusion_sr as tdiff
from cosmos_curate_tpu_torch.models import diffusion_sr_train as tdiff_train
from cosmos_curate_tpu_torch.models import ocr as tocr
from cosmos_curate_tpu_torch.models import ocr_train as tocr_train
from cosmos_curate_tpu_torch.models import registry as tregistry
from cosmos_curate_tpu_torch.models import sr_train as tsr_train
from cosmos_curate_tpu_torch.models import super_resolution as tsr
from cosmos_curate_tpu_torch.models import tracker_learned as ttracker
from cosmos_curate_tpu_torch.models import tracker_train as ttracker_train
from cosmos_curate_tpu_torch.models import transnet_train as ttransnet_train
from cosmos_curate_tpu_torch.models import transnetv2 as ttransnet
from cosmos_curate_tpu_torch.models.convert_jax import flax_to_state_dict
from cosmos_curate_tpu_torch.models.train_common import StepLog
from tests.test_torch_train import DET_CFG, DIFF_CFG, REC_CFG, SR_CFG, TRACKER_CFG, TRANSNET_CFG, _np_tree

FP32_RTOL = 1e-4
BF16_RTOL = 2e-2
OCR_ATOL, OCR_RTOL = 1e-4, 1e-3
SIAMESE_ATOL, SIAMESE_RTOL = 1e-4, 1e-3
TRANSNET_TOL = 2e-2
BF16_SHARE = 2e-2


class _Losses:
    """Stands in for a JAX trainer's logger: the loss of every logged step."""

    def __init__(self) -> None:
        self.values: list[float] = []

    def info(self, fmt, *args) -> None:
        if "loss" in fmt and "step" in fmt:
            self.values.append(float(args[-1]))


# name -> (JAX trainer module, JAX train function, its kwargs, the JAX
#          init the JAX train makes, port train function, its kwargs)
def _runs():
    k = jax.random.PRNGKey(0)
    jtc, ttc = TRACKER_CFG
    jn, tn = TRANSNET_CFG
    jd, td = DET_CFG
    jr, tr = REC_CFG
    js, ts = SR_CFG
    return {
        "tracker": (jtracker_train, jtracker_train.train, {"cfg": jtc, "batch": 3},
                    lambda: jtracker.EmbedNet(jtc.features).init(k, jnp.zeros((1, 32, 32, 3))),
                    ttracker_train.train, {"cfg": ttc, "batch": 3}, FP32_RTOL),
        "transnet": (jtransnet_train, jtransnet_train.train, {"cfg": jn, "batch": 2},
                     lambda: jax.jit(lambda: jtransnet.TransNet(jn).init(
                         k, jnp.zeros((1, 32, 27, 48, 3), jnp.uint8)))(),
                     ttransnet_train.train, {"cfg": tn, "batch": 2}, BF16_RTOL),
        "ocr_detector": (jocr_train, jocr_train.train_detector, {"cfg": jd, "batch": 3},
                         lambda: jocr.TextDetector(jd).init(k, jnp.zeros((1, jd.height, jd.width, 3), jnp.uint8)),
                         tocr_train.train_detector, {"cfg": td, "batch": 3}, FP32_RTOL),
        "ocr_recognizer": (jocr_train, jocr_train.train_recognizer, {"cfg": jr, "batch": 3},
                           lambda: jocr.TextRecognizer(jr).init(k, jnp.zeros((1, jr.height, jr.max_width, 3),
                                                                             jnp.uint8)),
                           tocr_train.train_recognizer, {"cfg": tr, "batch": 3}, FP32_RTOL),
        "sr": (jsr_train, jsr_train.train, {"cfg": js, "batch": 3, "hr_size": 16},
               lambda: jsr.SRNet(js).init(k, jnp.zeros((1, 8, 8, 3), jnp.uint8)),
               tsr_train.train, {"cfg": ts, "batch": 3, "hr_size": 16}, BF16_RTOL),
    }


@pytest.mark.parametrize("name", ["tracker", "transnet", "ocr_detector", "ocr_recognizer", "sr"])
def test_three_step_losses_track_jax(name, monkeypatch):
    jmodule, jtrain, jkw, jinit, ttrain, tkw, rtol = _runs()[name]
    recorder = _Losses()
    monkeypatch.setattr(jmodule, "logger", recorder)
    jtrain(steps=3, seed=0, log_every=1, **jkw)
    log = StepLog()
    _, last = ttrain(steps=3, seed=0, log_every=0, device="cpu", log=log, **tkw,
                     init_params=flax_to_state_dict(_np_tree(jinit())))
    got = log.loss_values()
    assert len(got) == len(recorder.values) == 3 and last == got[-1]
    np.testing.assert_allclose(got, recorder.values, rtol=rtol, atol=0)


def _falls(losses: list[float]) -> bool:
    return bool(np.isfinite(losses).all()) and np.mean(losses[len(losses) // 2:]) < losses[0]


@pytest.mark.parametrize("name,steps,kw", [
    ("tracker", 12, {"cfg": TRACKER_CFG[1], "batch": 4}),
    ("transnet", 12, {"cfg": TRANSNET_CFG[1], "batch": 2}),
    ("ocr_detector", 12, {"cfg": DET_CFG[1], "batch": 4}),
    ("ocr_recognizer", 12, {"cfg": REC_CFG[1], "batch": 4}),
    ("sr", 12, {"cfg": SR_CFG[1], "batch": 4, "hr_size": 16, "lr": 2e-3}),
])
def test_short_run_loss_is_finite_and_falls(name, steps, kw):
    train = {"tracker": ttracker_train.train, "transnet": ttransnet_train.train,
             "ocr_detector": tocr_train.train_detector, "ocr_recognizer": tocr_train.train_recognizer,
             "sr": tsr_train.train}[name]
    log = StepLog()
    _, last = train(steps=steps, log_every=0, device="cpu", log=log, **kw)
    losses = log.loss_values()
    assert len(losses) == steps and last == losses[-1]
    assert _falls(losses), losses


def test_diffusion_short_run_meets_the_jax_trainers_bar():
    log = StepLog()
    _, loss = tdiff_train.train(DIFF_CFG[1], steps=30, batch=2, hr_size=16, lr=2e-3, log_every=0, device="cpu",
                                log=log)
    assert np.isfinite(loss) and loss < 0.9
    assert _falls(log.loss_values())


def test_transnet_trainer_refuses_another_window():
    with pytest.raises(ValueError, match="inference WINDOW"):
        ttransnet_train.train(TRANSNET_CFG[1], steps=1, window=16, device="cpu")


# --------------------------------------------------------------------- the round trip


def _load_jax(model_id: str, init_fn, path) -> dict:
    """The JAX package's load, refusing the seeded init; equal to the file."""
    params = _np_tree(jregistry.load_params(model_id, init_fn, require=True))
    want = tregistry.read_flax_msgpack(path.read_bytes())
    jax.tree_util.tree_map(np.testing.assert_array_equal, params, want)
    return params


@pytest.fixture()
def staging(tmp_path, monkeypatch):
    monkeypatch.setenv(jregistry.WEIGHTS_DIR_ENV, str(tmp_path))
    return tmp_path


def test_ocr_checkpoints_round_trip(staging):
    jd, td = DET_CFG
    jr, tr = REC_CFG
    results = tocr_train.train_and_stage(out_dir=str(staging), device="cpu",
                                         det_kw={"cfg": td, "steps": 2, "batch": 2, "log_every": 0},
                                         rec_kw={"cfg": tr, "steps": 2, "batch": 2, "log_every": 0})
    assert set(results) == {tocr.DETECTOR_ID, tocr.RECOGNIZER_ID}
    k = jax.random.PRNGKey(0)
    _load_jax(tocr.DETECTOR_ID, lambda s: jocr.TextDetector(jd).init(
        k, jnp.zeros((1, jd.height, jd.width, 3), jnp.uint8)), results[tocr.DETECTOR_ID][0])
    _load_jax(tocr.RECOGNIZER_ID, lambda s: jocr.TextRecognizer(jr).init(
        k, jnp.zeros((1, jr.height, jr.max_width, 3), jnp.uint8)), results[tocr.RECOGNIZER_ID][0])
    tm = tocr.OcrModel(td, tr, device="cpu")
    tm.setup(require_weights=True)
    jm = jocr.OcrModel(jd, jr)
    jm.setup(require_weights=True)
    # at the models' input sizes, so neither package resizes
    frames = tocr_train.synthesize_detector_batch(np.random.default_rng(11), 3, td)[0]
    np.testing.assert_allclose(tm.detector_logits(frames), np.asarray(jm.detector.apply(jm._det_params, frames)),
                               atol=OCR_ATOL, rtol=OCR_RTOL)
    crops = tocr_train.synthesize_recognizer_batch(np.random.default_rng(12), 3, tr)[0]
    np.testing.assert_allclose(tm.recognizer_logits(crops), np.asarray(jm.recognizer.apply(jm._rec_params, crops)),
                               atol=OCR_ATOL, rtol=OCR_RTOL)


def test_tracker_checkpoint_round_trips(staging):
    jc, tc = TRACKER_CFG
    ckpt, _ = ttracker_train.train_and_stage(tc, out_dir=str(staging), steps=2, batch=2, log_every=0, device="cpu")
    _load_jax(ttracker.MODEL_ID, lambda s: jtracker.EmbedNet(jc.features).init(
        jax.random.PRNGKey(s), jnp.zeros((1, 32, 32, 3))), ckpt)
    tm = ttracker.SiameseTracker(tc, device="cpu")
    tm.setup(require_weights=True)
    jm = jtracker.SiameseTracker(jc)
    jm.setup(require_weights=True)
    rng = np.random.default_rng(13)
    frames = rng.integers(0, 256, (6, 96, 128, 3), dtype=np.uint8)
    frames[:, 30:50, 40:60] = 255
    boxes, scores = tm.track(frames, (40, 30, 20, 20))
    j_boxes, j_scores = jm.track(frames, (40, 30, 20, 20))
    np.testing.assert_array_equal(boxes, np.asarray(j_boxes))
    np.testing.assert_allclose(scores, np.asarray(j_scores), atol=SIAMESE_ATOL, rtol=SIAMESE_RTOL)


def test_transnet_checkpoint_round_trips(staging):
    jc, tc = TRANSNET_CFG
    ckpt, _ = ttransnet_train.train_and_stage(tc, out_dir=str(staging), steps=2, batch=2, log_every=0,
                                              device="cpu")
    _load_jax(ttransnet.TransNetV2.MODEL_ID, lambda s: jax.jit(lambda: jtransnet.TransNet(jc).init(
        jax.random.PRNGKey(s), jnp.zeros((1, 32, 27, 48, 3), jnp.uint8)))(), ckpt)
    tm = ttransnet.TransNetV2(cfg=tc, device="cpu")
    tm.setup(require_weights=True)
    jm = jtransnet.TransNetV2TPU(cfg=jc)
    jm.setup()
    frames = ttransnet_train.synthesize_batch(np.random.default_rng(14), 1, 40)[0][0]
    got, want = tm.predict_transitions(frames), np.asarray(jm.predict_transitions(frames))
    assert got.shape == want.shape == (40,)
    assert float(np.abs(got - want).max()) <= TRANSNET_TOL


def test_sr_checkpoint_round_trips(staging):
    jc, tc = SR_CFG
    ckpt, _ = tsr_train.train_and_stage(tc, out_dir=str(staging), steps=2, batch=2, hr_size=16, log_every=0,
                                        device="cpu")
    _load_jax(tsr.MODEL_ID, lambda s: jsr.SRNet(jc).init(jax.random.PRNGKey(s), jnp.zeros((1, 8, 8, 3), jnp.uint8)),
              ckpt)
    tm = tsr.SuperResolutionModel(tc, device="cpu")
    tm.setup(require_weights=True)
    jm = jsr.SuperResolutionModel(jc)
    jm.setup()
    f = tsr_train.synthesize_batch(np.random.default_rng(15), 4, 32, 2)[0]
    got, want = tm.upscale_window(f), np.asarray(jm.upscale_window(f))
    assert got.shape == want.shape == (4, 32, 32, 3)
    assert np.abs(got.astype(int) - want).max() <= round(BF16_SHARE * 255)
    with torch.no_grad():
        got = tm.net(torch.from_numpy(f), float_out=True).numpy()
    want = np.asarray(jsr.SRNet(jc).apply(jm._params, jnp.asarray(f), float_out=True))
    assert float(np.abs(got - want).max()) <= BF16_SHARE * float(np.abs(want).max())


def test_diffusion_checkpoint_round_trips(staging):
    jc, tc = DIFF_CFG
    ckpt, _ = tdiff_train.train_and_stage(tc, out_dir=str(staging), steps=2, batch=2, hr_size=16, log_every=0,
                                          device="cpu")
    dummy = jnp.zeros((jc.window, 16, 16, 3), jnp.float32)
    params = _load_jax(tdiff.MODEL_ID, lambda s: jax.jit(lambda: jdiff.DenoiserUNet(jc).init(
        jax.random.PRNGKey(s), dummy, dummy, jnp.float32(0.5)))(), ckpt)
    tm = tdiff.DiffusionSRModel(tc, device="cpu")
    tm.setup(require_weights=True)
    rng = np.random.default_rng(16)
    z = rng.standard_normal((jc.window, 16, 16, 3)).astype(np.float32)
    cond = rng.random((jc.window, 16, 16, 3)).astype(np.float32)
    want = np.asarray(jdiff.DenoiserUNet(jc).apply(params, z, cond, jnp.float32(0.5)))
    with torch.no_grad():
        got = tm.net(torch.from_numpy(z).permute(0, 3, 1, 2), torch.from_numpy(cond).permute(0, 3, 1, 2), 0.5)
    got = got.permute(0, 2, 3, 1).numpy()
    assert float(np.abs(want).max()) > 0  # the trained head is no longer zero
    assert float(np.abs(got - want).max()) <= BF16_SHARE * float(np.abs(want).max())


@pytest.mark.parametrize("trainer", ["tracker", "transnet", "sr", "diffusion_sr"])
def test_inference_classes_refuse_a_missing_checkpoint_when_required(trainer, staging):
    model = {"tracker": lambda: ttracker.SiameseTracker(TRACKER_CFG[1], device="cpu"),
             "transnet": lambda: ttransnet.TransNetV2(cfg=TRANSNET_CFG[1], device="cpu"),
             "sr": lambda: tsr.SuperResolutionModel(SR_CFG[1], device="cpu"),
             "diffusion_sr": lambda: tdiff.DiffusionSRModel(DIFF_CFG[1], device="cpu")}[trainer]()
    with pytest.raises(RuntimeError, match="no staged weights"):
        model.setup(require_weights=True)
