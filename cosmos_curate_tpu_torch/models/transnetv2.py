"""Shot-transition detector: dilated 3D CNN over frame windows (port of
``cosmos_curate_tpu/models/transnetv2.py``).

Per-frame shot-transition probabilities over overlap-averaged sliding
windows of ``WINDOW`` frames at 48x27. Blocks of parallel 3D convolutions
with temporal dilations, concatenated on the channel axis in the order of
``dilations``; a LayerNorm over channels (at every t, h, w) and a 2x2
spatial average pool after each pair of blocks; a per-frame head.

The flax module is channels-last (NDHWC); this one is channels-first
(NCDHW), so the frames are transposed once at the input and the norm runs
over dim 1. Compute runs in the module's ``dtype`` (bf16 on the card) with
fp32 parameters; the norms and the output head are fp32. The convolutions
are ``torch.nn.functional.conv3d``, as the JAX package leaves them to XLA.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from cosmos_curate_tpu_torch.core.model import ModelInterface, model_device
from cosmos_curate_tpu_torch.models import registry
from cosmos_curate_tpu_torch.models.device_pipeline import DevicePipeline
from cosmos_curate_tpu_torch.models.layers import LayerNorm, Linear, lecun_normal_

INPUT_H, INPUT_W = 27, 48
# inference windows match the training window: the temporal convs' SAME
# padding gives every in-window position an edge signature
WINDOW = 32
STRIDE = 16  # overlap-averaged halves, like the published model


@dataclass(frozen=True)
class TransNetConfig:
    filters: tuple[int, ...] = (8, 16, 32)
    dilations: tuple[int, ...] = (1, 2, 4, 8)
    head_dim: int = 128


TRANSNET_TINY_TEST = TransNetConfig(filters=(4,), dilations=(1, 2), head_dim=16)


class DDCNNBlock(nn.Module):
    """Parallel temporal-dilated 3x3x3 convolutions, concatenated, ReLU.
    flax's ``padding="SAME"`` at dilation (d, 1, 1) is padding (d, 1, 1)."""

    def __init__(self, in_channels: int, filters: int, dilations: tuple[int, ...], dtype=torch.bfloat16):
        super().__init__()
        self.dilations = dilations
        self.dtype = dtype
        for d in dilations:
            self.add_module(f"conv_d{d}", nn.Conv3d(in_channels, filters, 3, padding=(d, 1, 1), dilation=(d, 1, 1)))

    def forward(self, x):
        x = x.to(self.dtype)
        outs = []
        for d in self.dilations:
            conv = getattr(self, f"conv_d{d}")
            outs.append(F.conv3d(x, conv.weight.to(self.dtype), conv.bias.to(self.dtype),
                                 padding=(d, 1, 1), dilation=(d, 1, 1)))
        return F.relu(torch.cat(outs, dim=1))


class TransNet(nn.Module):
    """uint8 frames ``[B, T, 27, 48, 3]`` -> logits ``[B, T]`` (fp32)."""

    def __init__(self, cfg: TransNetConfig = TransNetConfig(), dtype=torch.bfloat16):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        width = len(cfg.dilations)
        channels = 3
        for i, f in enumerate(cfg.filters):
            self.add_module(f"dd{i}a", DDCNNBlock(channels, f, cfg.dilations, dtype))
            self.add_module(f"dd{i}b", DDCNNBlock(f * width, f, cfg.dilations, dtype))
            self.add_module(f"ln{i}", LayerNorm(f * width))
            channels = f * width
        self.fc = Linear(channels, cfg.head_dim, dtype=dtype)
        self.head = Linear(cfg.head_dim, 1, dtype=torch.float32)

    @torch.no_grad()
    def init_weights(self, gen: torch.Generator) -> None:
        """flax's defaults: lecun-normal conv and dense kernels, zero bias
        (the norms keep their unit scale and zero bias)."""
        for m in self.modules():
            if isinstance(m, (nn.Conv3d, Linear)):
                lecun_normal_(m.weight, gen)
                m.bias.zero_()

    def forward(self, frames):
        x = frames.permute(0, 4, 1, 2, 3).to(self.dtype) / 255.0  # NCDHW
        for i in range(len(self.cfg.filters)):
            x = getattr(self, f"dd{i}b")(getattr(self, f"dd{i}a")(x))
            # over channels at every (t, h, w), fp32 out
            x = getattr(self, f"ln{i}")(x.movedim(1, -1)).movedim(-1, 1)
            x = F.avg_pool3d(x, (1, 2, 2))  # VALID: 27x48 -> 13x24 -> 6x12 -> 3x6
        x = x.mean(dim=(3, 4)).transpose(1, 2)  # [B, T, C]
        x = F.relu(self.fc(x))
        return self.head(x)[..., 0]


def transition_windows(frames: np.ndarray) -> tuple[list[int], np.ndarray]:
    """uint8 ``[T, H, W, 3]`` (T > 0) -> (window starts, uint8 ``[n, WINDOW,
    27, 48, 3]``): the frames resized on the host (``INTER_AREA``), windows
    every ``STRIDE`` frames, a short tail padded with its last frame."""
    import cv2

    t = frames.shape[0]
    small = np.stack([cv2.resize(f, (INPUT_W, INPUT_H), interpolation=cv2.INTER_AREA) for f in frames])
    starts = list(range(0, max(1, t - WINDOW + STRIDE), STRIDE))
    windows = np.zeros((len(starts), WINDOW, INPUT_H, INPUT_W, 3), np.uint8)
    for i, s in enumerate(starts):
        chunk = small[s : s + WINDOW]
        windows[i, : len(chunk)] = chunk
        if len(chunk) < WINDOW:
            windows[i, len(chunk) :] = chunk[-1]
    return starts, windows


class TransNetV2(ModelInterface):
    """Windowed inference over videos of any length: per-frame transition
    probabilities, on ``device`` ("cuda" unless the caller asks for the
    CPU). Weights: ``params`` (a ``state_dict``) when given, else the
    staged checkpoint, else the seeded init."""

    MODEL_ID = "transnetv2-tpu"

    def __init__(
        self,
        batch_windows: int = 8,
        cfg: TransNetConfig = TransNetConfig(),
        *,
        params: dict[str, Any] | None = None,
        device: str | torch.device = "cuda",
    ) -> None:
        self.device = model_device(device, "the shot detector")
        self.batch_windows = batch_windows
        self.cfg = cfg
        self.params = params
        self.model: TransNet | None = None
        self._pipeline: DevicePipeline | None = None

    @property
    def model_id_names(self) -> list[str]:
        return [self.MODEL_ID]

    def setup(self, *, require_weights: bool = False) -> None:
        """Build the model and fill it (``require_weights=True`` raises
        without a checkpoint that matches, instead of the seeded init)."""
        with torch.device(self.device):
            model = TransNet(self.cfg)
        registry.load_module(model, self.MODEL_ID, self.params, require=require_weights)
        self.model = model.eval().requires_grad_(False)
        self._pipeline = DevicePipeline("transnet", self._forward, device=self.device)

    @torch.inference_mode()
    def _forward(self, windows):
        return torch.sigmoid(self.model(windows))

    def predict_transitions(self, frames: np.ndarray) -> np.ndarray:
        """uint8 ``[T, H, W, 3]`` (any H / W; resized on the host) -> ``[T]``
        per-frame transition probabilities, overlap-averaged over windows
        (in float64) starting every ``STRIDE`` frames; a short tail window
        is padded with its last frame."""
        if self._pipeline is None:
            raise RuntimeError("call setup() first")
        t = frames.shape[0]
        if t == 0:
            return np.zeros(0, np.float32)
        starts, windows = transition_windows(frames)
        probs_sum = np.zeros(t, np.float64)
        probs_cnt = np.zeros(t, np.float64)
        # every window batch is submitted before any is read back: batch
        # k + 1's copy overlaps batch k's compute
        for i in range(0, len(starts), self.batch_windows):
            self._pipeline.submit(windows[i : i + self.batch_windows])
        outs = self._pipeline.drain()
        for i, out in zip(range(0, len(starts), self.batch_windows), outs):
            for j, s in enumerate(starts[i : i + self.batch_windows]):
                end = min(s + WINDOW, t)
                probs_sum[s:end] += out[j, : end - s]
                probs_cnt[s:end] += 1
        return (probs_sum / np.maximum(probs_cnt, 1)).astype(np.float32)
