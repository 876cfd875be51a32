"""The split's remaining legs on the card against their CPU path: the NCC
and siamese trackers, the motion filter's frame-difference scores and one
super-resolution window of each variant.

Marked ``cuda``: they skip without a CUDA device (this file imports no JAX).
Run on the GPU with ``python -m pytest -m cuda tests/test_torch_cuda_legs.py``.
Inputs and weights come from seeds.

Bounds:
- tracker boxes equal; NCC scores rtol 1e-5 / atol 1e-5, siamese scores
  atol 1e-4 / rtol 1e-3 (fp32 products with TF32 off on both sides);
- motion scores within 1e-5 relative;
- SR windows (bf16 convs on both sides, other algorithms): uint8 within
  ``SR_LEVELS`` levels (2e-2 of the full scale), the diffusion model on the
  same per-chunk noise (drawn on the CPU for either device).
"""

import numpy as np
import pytest
import torch

from cosmos_curate_tpu_torch.models import diffusion_sr as td
from cosmos_curate_tpu_torch.models import super_resolution as ts
from cosmos_curate_tpu_torch.models.tracker import TemplateTracker, TrackerConfig
from cosmos_curate_tpu_torch.models.tracker_learned import SiameseTracker
from cosmos_curate_tpu_torch.pipelines.video.stages.motion_filter import _motion_scores

pytestmark = pytest.mark.cuda

SR_LEVELS = 5


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _moving_box(t=24, size=128, box=24, step=3):
    rng = np.random.default_rng(0)
    frames = np.full((t, size, size, 3), 40, np.uint8)
    for i in range(t):
        frames[i, size // 2 - box // 2 : size // 2 + box // 2, 10 + i * step : 10 + i * step + box] = (220, 180, 60)
    frames = np.clip(frames.astype(np.int16) + rng.integers(-5, 6, frames.shape), 0, 255).astype(np.uint8)
    return frames, (10.0, float(size // 2 - box // 2), float(box), float(box))


def _texture(t=16):
    base = np.random.default_rng(2).integers(0, 256, (180, 320, 3), dtype=np.uint8)
    return np.stack([np.roll(base, 2 * i, axis=1) for i in range(t)]), (100.0, 60.0, 40.0, 40.0)


@pytest.mark.parametrize("clip", [_moving_box, _texture])
def test_ncc_tracker_on_the_card_matches_the_cpu(dev, clip):
    frames, box = clip()
    boxes, scores = TemplateTracker(TrackerConfig(), device=dev).track(frames, box)
    want_boxes, want_scores = TemplateTracker(TrackerConfig(), device="cpu").track(frames, box)
    np.testing.assert_array_equal(boxes, want_boxes)
    np.testing.assert_allclose(scores, want_scores, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("clip", [_moving_box, _texture])
def test_siamese_tracker_on_the_card_matches_the_cpu(dev, clip):
    frames, box = clip()
    cpu = SiameseTracker(device="cpu")
    cpu.setup()
    card = SiameseTracker(device=dev)
    card.net.load_state_dict(cpu.net.state_dict())
    card._ready = True
    boxes, scores = card.track(frames, box)
    want_boxes, want_scores = cpu.track(frames, box)
    np.testing.assert_array_equal(boxes, want_boxes)
    np.testing.assert_allclose(scores, want_scores, atol=1e-4, rtol=1e-3)


@pytest.mark.parametrize("t,hw", [(2, (128, 128)), (13, (128, 128)), (7, (72, 96))])
def test_motion_scores_on_the_card_match_the_cpu(dev, t, hw):
    frames = torch.from_numpy(np.random.default_rng(t).integers(0, 256, (t, *hw, 3), dtype=np.uint8))
    got = [float(x) for x in _motion_scores(frames.to(dev))]
    want = [float(x) for x in _motion_scores(frames)]
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)


def test_srnet_window_on_the_card_matches_the_cpu(dev):
    cpu = ts.SuperResolutionModel(ts.SR_TINY_TEST, device="cpu")
    cpu.setup()
    card = ts.SuperResolutionModel(ts.SR_TINY_TEST, device=dev)
    card.setup()
    card.net.load_state_dict(cpu.net.state_dict())
    f = np.random.default_rng(1).integers(0, 256, (6, 36, 64, 3), dtype=np.uint8)
    got, want = card.upscale_window(f), cpu.upscale_window(f)
    assert got.shape == want.shape == (6, 72, 128, 3)
    assert np.abs(got.astype(int) - want).max() <= SR_LEVELS


def test_diffusion_window_on_the_card_matches_the_cpu(dev):
    cpu = td.DiffusionSRModel(td.DIFF_SR_TINY_TEST, device="cpu")
    cpu.setup()
    with torch.no_grad():  # a residual that is not identically zero
        conv = getattr(cpu.net, cpu.net.conv_out)
        conv.weight.copy_(torch.randn(conv.weight.shape, generator=torch.Generator().manual_seed(5)) * 0.1)
    card = td.DiffusionSRModel(td.DIFF_SR_TINY_TEST, device=dev)
    card.setup()
    card.net.load_state_dict(cpu.net.state_dict())
    f = np.random.default_rng(2).integers(0, 256, (5, 36, 64, 3), dtype=np.uint8)
    got, want = card.upscale_window(f), cpu.upscale_window(f)
    assert got.shape == want.shape == (5, 72, 128, 3)
    assert np.abs(got.astype(int) - want).max() <= SR_LEVELS
