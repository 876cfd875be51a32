"""Port parity: the OCR models (``models/ocr.py``) on the committed trained
weights and on the JAX package's seeded init.

The inputs are the JAX package's golden fixtures
(``models/ocr_train.golden_eval_frames`` / ``golden_rec_sample``: cv2-drawn
text on flat frames) and frames made from a numpy seed. Both packages load
the same ``params.msgpack`` (``weights/ocr-*-tpu``, or a checkpoint the
JAX package writes of its seeded init).

Tolerances: detector and recognizer logits and heatmaps fp32 within atol
1e-4 / rtol 1e-3; ``heatmap_to_boxes`` and ``greedy_ctc_decode`` on the
same input, ``text_coverage``, the boxes' geometry, the recognized strings
and the keep decisions: exactly equal; a box's score (a mean of fp32
probabilities) within the logits' bound.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cosmos_curate_tpu.models import ocr as jocr
from cosmos_curate_tpu.models import registry as jregistry
from cosmos_curate_tpu.models.ocr_train import golden_eval_frames, golden_rec_sample
from cosmos_curate_tpu_torch.models import ocr as tocr
from cosmos_curate_tpu_torch.models import registry
from cosmos_curate_tpu_torch.models.convert_jax import flax_to_state_dict

ATOL, RTOL = 1e-4, 1e-3
LEARNED_THRESHOLD = 0.02  # the text filter's keep/drop line on coverage


@pytest.fixture(scope="module")
def trained():
    """(JAX model, port model) on the committed checkpoints."""
    assert registry.find_checkpoint(tocr.DETECTOR_ID) is not None, "weights/ocr-detector-tpu is committed"
    jm = jocr.OcrModel()
    jm.setup(require_weights=True)
    tm = tocr.OcrModel(device="cpu")
    tm.setup(require_weights=True)
    return jm, tm


@pytest.fixture(scope="module")
def seeded(tmp_path_factory):
    """(JAX model, port model) on the JAX package's seeded init, which the
    JAX registry writes as the checkpoint both load."""
    root = tmp_path_factory.mktemp("ocr_seeded")
    det = jocr.TextDetector()
    rec = jocr.TextRecognizer()
    jregistry.save_params(tocr.DETECTOR_ID, det.init(jax.random.PRNGKey(3), jnp.zeros((1, 128, 224, 3), jnp.uint8)),
                          root=root)
    jregistry.save_params(tocr.RECOGNIZER_ID,
                          rec.init(jax.random.PRNGKey(4), jnp.zeros((1, 32, 160, 3), jnp.uint8)), root=root)
    mp = pytest.MonkeyPatch()
    mp.setenv(jregistry.WEIGHTS_DIR_ENV, str(root))
    try:
        jm = jocr.OcrModel()
        jm.setup(require_weights=True)
        tm = tocr.OcrModel(device="cpu")
        tm.setup(require_weights=True)
    finally:
        mp.undo()
    return jm, tm


def _frames(seed: int, n: int = 4, hw=(240, 320)) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, (n, *hw, 3), dtype=np.uint8)


def _jax_heatmap(jm, frames) -> np.ndarray:
    x = jm._resize(frames, (jm.det_cfg.height, jm.det_cfg.width))
    return np.asarray(jax.nn.sigmoid(jm._det_apply(jm._det_params, jnp.asarray(x))))


def _jax_rec_logits(jm, crops) -> np.ndarray:
    x = jm._resize(crops, (jm.rec_cfg.height, jm.rec_cfg.max_width))
    return np.asarray(jm._rec_apply(jm._rec_params, jnp.asarray(x)))


def _assert_same_boxes(boxes, j_boxes) -> None:
    assert [(b.x0, b.y0, b.x1, b.y1) for b in boxes] == [(b.x0, b.y0, b.x1, b.y1) for b in j_boxes]
    np.testing.assert_allclose([b.score for b in boxes], [b.score for b in j_boxes], atol=ATOL, rtol=RTOL)


def _inputs(kind: str) -> np.ndarray:
    clean, texty = golden_eval_frames()
    return {"golden_clean": clean, "golden_texty": texty, "random": _frames(0)}[kind]


@pytest.mark.parametrize("weights", ["trained", "seeded"])
@pytest.mark.parametrize("kind", ["golden_clean", "golden_texty", "random"])
def test_detector_matches_jax(weights, kind, request):
    jm, tm = request.getfixturevalue(weights)
    frames = _inputs(kind)
    x = tm._resize(frames, (128, 224))
    j_logits = np.asarray(jm._det_apply(jm._det_params, jnp.asarray(x)))
    with torch.no_grad():
        t_logits = tm.detector(torch.from_numpy(x)).numpy()
    assert t_logits.shape == j_logits.shape == (len(frames), 32, 56)
    np.testing.assert_allclose(t_logits, j_logits, atol=ATOL, rtol=RTOL)
    # the boxes from the two heatmaps: the same geometry; each score is a
    # mean of fp32 probabilities, held within the logits' bound
    prob, j_prob = tm.heatmap(frames), _jax_heatmap(jm, frames)
    np.testing.assert_allclose(prob, j_prob, atol=ATOL, rtol=RTOL)
    for boxes, j_boxes in ((tocr.heatmap_to_boxes(p), jocr.heatmap_to_boxes(jp)) for p, jp in zip(prob, j_prob)):
        _assert_same_boxes(boxes, j_boxes)
    for boxes, j_boxes in zip(tm.detect(frames), jm.detect(frames), strict=True):
        _assert_same_boxes(boxes, j_boxes)
    cover, j_cover = tm.text_coverage(frames), jm.text_coverage(frames)
    assert cover == j_cover
    assert (cover < LEARNED_THRESHOLD) == (j_cover < LEARNED_THRESHOLD)


@pytest.mark.parametrize("weights", ["trained", "seeded"])
@pytest.mark.parametrize("text", ["HELLO 42", "subscribe now!", "random"])
def test_recognizer_matches_jax(weights, text, request):
    jm, tm = request.getfixturevalue(weights)
    crops = _frames(1, 3, (40, 150)) if text == "random" else golden_rec_sample(text)[None]
    logits, j_logits = tm.recognizer_logits(crops), _jax_rec_logits(jm, crops)
    assert logits.shape == j_logits.shape == (len(crops), 40, len(tocr.CHARSET) + 1)
    np.testing.assert_allclose(logits, j_logits, atol=ATOL, rtol=RTOL)
    assert tm.recognize(crops) == jm.recognize(crops)
    assert tocr.greedy_ctc_decode(j_logits) == jocr.greedy_ctc_decode(j_logits)


def test_read_matches_jax(trained):
    jm, tm = trained
    _, texty = golden_eval_frames()
    for frame in texty[:2]:
        got, want = tm.read(frame), jm.read(frame)
        assert got and [s for _, s in got] == [s for _, s in want]
        _assert_same_boxes([b for b, _ in got], [b for b, _ in want])


def test_golden_assertions_hold_on_the_port(trained):
    """``tests/models/test_ocr.py``'s golden checks, on the port: overlay
    text scores well above a clean frame, and the recognizer reads clean
    rendered text."""
    _, tm = trained
    clean, texty = golden_eval_frames()
    cov_text, cov_clean = tm.text_coverage(texty), tm.text_coverage(clean)
    assert cov_text > 2 * max(cov_clean, 1e-4) and cov_text > 0.01, (cov_text, cov_clean)
    (text,) = tm.recognize(golden_rec_sample("HELLO 42")[None])
    matches = sum(a == b for a, b in zip(text, "HELLO 42"))
    if 3 <= matches < 5:
        # the reference test's band: a clear but degraded read is this
        # host's cv2 drawing the sample with other pixels (the JAX package
        # reads the same here: test_recognizer_matches_jax)
        pytest.skip(f"the recognizer reads {text!r} ({matches}/8) from this host's cv2 rendering")
    assert matches >= 5, text


def test_charset_codec_and_ctc_match_jax():
    assert tocr.CHARSET == jocr.CHARSET and tocr.BLANK_ID == jocr.BLANK_ID
    for s in ("Hello 42!", "~unknown~", ""):
        assert tocr.encode_text(s) == jocr.encode_text(s)
        assert tocr.decode_ids(tocr.encode_text(s)) == jocr.decode_ids(jocr.encode_text(s))
    rng = np.random.default_rng(5)
    logits = rng.normal(size=(4, 40, len(tocr.CHARSET) + 1)).astype(np.float32)
    logits[:, ::3, 0] += 4.0  # blanks between runs
    assert tocr.greedy_ctc_decode(logits) == jocr.greedy_ctc_decode(logits)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_heatmap_to_boxes_matches_jax(seed):
    rng = np.random.default_rng(seed)
    prob = rng.random((32, 56)).astype(np.float32) ** 3
    prob[4:8, 6:20] = 0.9
    for threshold, min_area in ((0.5, 6), (0.3, 1), (0.8, 10)):
        got = tocr.heatmap_to_boxes(prob, threshold=threshold, min_area=min_area)
        want = jocr.heatmap_to_boxes(prob, threshold=threshold, min_area=min_area)
        assert [vars(b) for b in got] == [vars(b) for b in want]


@pytest.mark.parametrize(("size", "kernel", "stride", "dilation", "pad"), [
    (128, 3, 2, 1, (0, 1)), (127, 3, 2, 1, (1, 1)), (32, 3, 1, 2, (2, 2)), (32, 3, 1, 4, (4, 4)),
    (40, 5, 1, 1, (2, 2)), (56, 1, 1, 1, (0, 0)),
])
def test_same_padding_is_flax_same(size, kernel, stride, dilation, pad):
    """A stride-2 conv on an even size pads (0, 1), as flax does; symmetric
    padding would shift every output by half a pixel."""
    assert tocr.same_padding(size, kernel, stride, dilation) == pad
    x = np.random.default_rng(0).normal(size=(1, size, 3, 2)).astype(np.float32)
    k = np.random.default_rng(1).normal(size=(kernel, 1, 2, 4)).astype(np.float32)
    want = jax.lax.conv_general_dilated(jnp.asarray(x), jnp.asarray(k), (stride, 1), "SAME",
                                        rhs_dilation=(dilation, 1), dimension_numbers=("NHWC", "HWIO", "NHWC"))
    conv = torch.nn.Conv2d(2, 4, (kernel, 1), stride=(stride, 1), dilation=(dilation, 1), bias=False)
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(k.transpose(3, 2, 0, 1)))
        got = tocr._conv2d_same(conv, torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-5, rtol=1e-5)


def test_checkpoint_maps_onto_the_port_modules():
    """The committed trees convert onto the modules' own state_dicts (HWIO
    and WIO kernels transposed, Dense kernels transposed), name for name and
    shape for shape."""
    for model_id, module in ((tocr.DETECTOR_ID, tocr.TextDetector()), (tocr.RECOGNIZER_ID, tocr.TextRecognizer())):
        tree = registry.read_flax_msgpack(registry.find_checkpoint(model_id).read_bytes())
        sd = flax_to_state_dict(tree)
        assert {k: tuple(v.shape) for k, v in sd.items()} == {k: tuple(v.shape) for k, v in module.state_dict().items()}
    wio = np.arange(5 * 3 * 2, dtype=np.float32).reshape(5, 3, 2)
    assert np.array_equal(flax_to_state_dict({"Conv_3": {"kernel": wio}})["Conv_3.weight"].numpy(),
                          wio.transpose(2, 1, 0))


def test_require_weights_raises_without_a_checkpoint(tmp_path, monkeypatch):
    monkeypatch.setenv(registry.WEIGHTS_DIR_ENV, str(tmp_path))
    monkeypatch.setattr(registry, "REPO_WEIGHTS_DIR", tmp_path / "none")
    with pytest.raises(RuntimeError, match="no staged weights for ocr-detector-tpu"):
        tocr.OcrModel(device="cpu").setup(require_weights=True)
    # a checkpoint of another architecture raises too
    bad = tmp_path / tocr.DETECTOR_ID
    bad.mkdir()
    jregistry.save_params(tocr.DETECTOR_ID, jocr.TextDetector(jocr.DetectorConfig(base_filters=8)).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 128, 224, 3), jnp.uint8)), root=tmp_path)
    with pytest.raises(RuntimeError, match="do not match"):
        tocr.OcrModel(device="cpu").setup(require_weights=True)


def test_ocr_model_defaults_to_the_gpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tocr.OcrModel()


def test_chip_smoke_golden_fixtures_equal_the_jax_ones():
    """``chip_smoke.py`` takes the golden fixture generators from the port's
    ``models/ocr_train.py`` (it imports nothing of the JAX package, and keeps
    no copy of its own): the same pixels as the JAX package's."""
    import chip_smoke

    from cosmos_curate_tpu_torch.models import ocr_train as tocr_train

    assert not hasattr(chip_smoke, "golden_eval_frames") and not hasattr(chip_smoke, "golden_rec_sample")
    for mine, theirs in zip(tocr_train.golden_eval_frames(), golden_eval_frames(), strict=True):
        np.testing.assert_array_equal(mine, theirs)
    for text in ("HELLO 42", "subscribe now!"):
        np.testing.assert_array_equal(tocr_train.golden_rec_sample(text), golden_rec_sample(text))
