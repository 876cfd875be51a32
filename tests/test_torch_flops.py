"""Port parity: the analytic FLOPs accounting (``models/flops.py``) against
the JAX package's.

- Every formula gives exactly the JAX one's count for every configuration
  both packages define under one name (the ViTs, the video embedders, the
  caption LMs).
- The peak: ``BENCH_PEAK_FLOPS`` overrides in both packages; the port's
  table reads the card's name (an H100 SXM is 989.4e12 dense bf16) and
  falls back to ``DEFAULT_PEAK`` for a card it does not name and without a
  card.
- ``mfu`` divides the same way: the same value for a given peak, 0 for a
  non-positive time.
"""

from __future__ import annotations

import pytest
import torch

from cosmos_curate_tpu.models import embedder as jembed
from cosmos_curate_tpu.models import flops as jflops
from cosmos_curate_tpu.models import vit as jvit
from cosmos_curate_tpu.models.vlm import model as jvlm
from cosmos_curate_tpu_torch.models import embedder as tembed
from cosmos_curate_tpu_torch.models import flops as tflops
from cosmos_curate_tpu_torch.models import vit as tvit
from cosmos_curate_tpu_torch.models.vlm import model as tvlm

VITS = ("VIT_L_14", "VIT_B_16", "VIT_TINY_TEST")
EMBEDS = ("VIDEO_EMBED_BASE", "VIDEO_EMBED_512", "VIDEO_EMBED_256", "VIDEO_EMBED_TINY_TEST")
LMS = ("VLM_BASE", "VLM_QWEN2_2B", "VLM_QWEN25_7B", "VLM_TINY_TEST", "VLM_QWEN3_MOE_A3B", "VLM_QWEN3_VL_MOE_A3B",
       "VLM_QWEN3VL_TINY_TEST", "VLM_MOE_TINY_TEST", "VLM_QWEN2VL_TINY_TEST")


@pytest.mark.parametrize("tokens,width,ratio", [(1, 8, 4), (197, 768, 4), (257, 1024, 4), (9, 512, 2)])
def test_transformer_layer_flops_match_jax(tokens, width, ratio):
    assert tflops.transformer_layer_flops(tokens, width, mlp_ratio=ratio) == \
        jflops.transformer_layer_flops(tokens, width, mlp_ratio=ratio)


@pytest.mark.parametrize("name", VITS)
def test_vit_forward_flops_match_jax(name):
    assert tflops.vit_forward_flops(getattr(tvit, name)) == jflops.vit_forward_flops(getattr(jvit, name))


@pytest.mark.parametrize("name", EMBEDS)
def test_video_embed_forward_flops_match_jax(name):
    got = tflops.video_embed_forward_flops(getattr(tembed, name))
    assert got == jflops.video_embed_forward_flops(getattr(jembed, name)) and got > 0


@pytest.mark.parametrize("name", LMS)
def test_vlm_decode_flops_per_token_match_jax(name):
    got = tflops.vlm_decode_flops_per_token(getattr(tvlm, name))
    assert got == jflops.vlm_decode_flops_per_token(getattr(jvlm, name)) and got > 0


def test_peak_override_in_both_packages(monkeypatch):
    monkeypatch.setenv("BENCH_PEAK_FLOPS", "1.25e15")
    assert tflops.chip_peak_flops() == jflops.chip_peak_flops() == 1.25e15


@pytest.mark.parametrize("name,peak", [
    ("NVIDIA H100 80GB HBM3", 989.4e12),
    ("NVIDIA H100 PCIe", 756.0e12),
    ("NVIDIA H100 NVL", 835.5e12),
    ("NVIDIA A100-SXM4-80GB", 312.0e12),
    ("NVIDIA L40S", 362.05e12),
    ("NVIDIA GeForce RTX 2080", tflops.DEFAULT_PEAK),
])
def test_peak_table_reads_the_card_name(name, peak):
    assert tflops.peak_for(name) == peak


def test_peak_reads_the_attached_card(monkeypatch):
    monkeypatch.delenv("BENCH_PEAK_FLOPS", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda *a: "NVIDIA H100 PCIe")
    assert tflops.chip_peak_flops() == 756.0e12
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert tflops.chip_peak_flops() == tflops.DEFAULT_PEAK == 989.4e12


def test_mfu_matches_jax():
    flops, seconds, peak = 3.7e15, 2.5, 989.4e12
    assert tflops.mfu(flops, seconds, peak=peak) == jflops.mfu(flops, seconds, peak=peak) == \
        (flops / seconds) / peak
    assert tflops.mfu(flops, 0.0, peak=peak) == jflops.mfu(flops, 0.0, peak=peak) == 0.0
