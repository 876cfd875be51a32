"""Learned single-object tracker: a siamese appearance embedding (port of
``cosmos_curate_tpu/models/tracker_learned.py``).

A small conv net (``EmbedNet``) embeds the prompted template and each
frame's search window; their cross-correlation gives a response map whose
peak is the object's displacement (the fully-convolutional siamese
formulation). The reference runs the clip as one jitted ``lax.scan``; here
the frame loop is Python over device ops with every coordinate on the
device, read back once at the clip's end (models/tracker.py).

The weights are ``tracker-siamese-tpu`` (the JAX package's flax msgpack
through ``models/registry.py``; the modules keep flax's names ``Conv_0`` ..
``Conv_2``). No trained checkpoint ships with the repository, so without a
staged one the tracker has its seeded init, and ``TrackingStage`` in
``auto`` mode takes the NCC tracker.

Parity with the reference where a plain transcription drifts:
- flax pads ``SAME`` asymmetrically on the stride-2 convolutions (0 before,
  1 after on an even size): every conv pads through ``same_padding``;
- the response is the reference's grouped convolution summed over channels,
  which is one cross-correlation with the template as a single
  ``[1, F, h, w]`` filter (``tracker.correlate``);
- the convolutions run with TF32 off, for the call only;
- the input scaling ``x / 127.5 - 1`` is one fused multiply-add under XLA;
  the port computes it in float64 and rounds once, which gives the same
  bits.

Entry points run on ``device="cuda"`` unless the caller asks for the CPU.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from cosmos_curate_tpu_torch.core.model import model_device
from cosmos_curate_tpu_torch.models import registry
from cosmos_curate_tpu_torch.models.ocr import _conv2d_same, _fp32, _init_convs
from cosmos_curate_tpu_torch.models.tracker import correlate, crop, host_track

STRIDE = 4
MODEL_ID = "tracker-siamese-tpu"
_PREP_SCALE = float(np.float32(1.0 / 127.5))

registry.register_model(MODEL_ID, "siamese appearance tracker")


@dataclass(frozen=True)
class SiameseConfig:
    template_size: int = 32
    search_size: int = 64
    features: int = 32
    work_size: int = 128
    ema: float = 0.05  # template-embedding update rate


class EmbedNet(nn.Module):
    """Shared embedding tower: float NCHW [B, 3, S, S] -> [B, F, S/4, S/4],
    zero-mean per channel (correlation scores are shift-robust)."""

    def __init__(self, features: int = 32) -> None:
        super().__init__()
        f = features
        self.Conv_0 = nn.Conv2d(3, f // 2, 3, stride=2)
        self.Conv_1 = nn.Conv2d(f // 2, f, 3, stride=2)
        self.Conv_2 = nn.Conv2d(f, f, 3)

    def init_weights(self, generator: torch.Generator) -> None:
        _init_convs(self, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(_conv2d_same(self.Conv_0, x))
        x = F.relu(_conv2d_same(self.Conv_1, x))
        x = _conv2d_same(self.Conv_2, x)
        return x - x.mean(dim=(2, 3), keepdim=True)


def _prep(patch_u8: torch.Tensor) -> torch.Tensor:
    """uint8 [S, S, 3] -> float32 [1, 3, S, S] in [-1, 1]."""
    x = (patch_u8.to(torch.float64) * _PREP_SCALE - 1.0).to(torch.float32)
    return x.permute(2, 0, 1)[None]


def siamese_track(net: EmbedNet, frames_u8: torch.Tensor, box0: np.ndarray, cfg: SiameseConfig) -> tuple:
    """frames_u8 [T, S, S, 3] at the work size on the device; box0 (cx, cy,
    w, h) in work coordinates. Returns (centres [T, 2] float32, scores [T])
    on the device."""
    dev = frames_u8.device
    ts, ss = cfg.template_size, cfg.search_size
    cx = torch.tensor(box0[0], dtype=torch.float32, device=dev).to(torch.int32)
    cy = torch.tensor(box0[1], dtype=torch.float32, device=dev).to(torch.int32)
    centres, scores = [], []
    with torch.no_grad(), _fp32(dev):
        patch, tx0, ty0 = crop(frames_u8[0], cx, cy, ts)
        delta = torch.stack([cx - (tx0 + ts // 2), cy - (ty0 + ts // 2)]).to(torch.float32)
        tfeat = net(_prep(patch))  # [1, F, ts/4, ts/4]
        th, tw = tfeat.shape[2:]
        norm = float(th * tw * cfg.features)
        for frame in frames_u8:
            window, wx0, wy0 = crop(frame, cx, cy, ss)
            sfeat = net(_prep(window))
            flat = correlate(sfeat, tfeat)
            idx = torch.argmax(flat)
            # feature-map peak -> window pixel -> frame pixel
            cols = sfeat.shape[3] - tw + 1
            cy = wy0 + ((idx // cols).to(torch.int32) + th // 2) * STRIDE + STRIDE // 2
            cx = wx0 + ((idx % cols).to(torch.int32) + tw // 2) * STRIDE + STRIDE // 2
            scores.append(flat[idx] / norm)
            centres.append(torch.stack([cx, cy]))
            patch, _, _ = crop(frame, cx, cy, ts)
            tfeat = (1.0 - cfg.ema) * tfeat + cfg.ema * net(_prep(patch))
    return torch.stack(centres).to(torch.float32) + delta[None, :], torch.stack(scores)


class SiameseTracker:
    """Learned drop-in for ``TemplateTracker`` (the same ``track``)."""

    def __init__(self, cfg: SiameseConfig = SiameseConfig(), *, device: str | torch.device = "cuda") -> None:
        self.cfg = cfg
        self.device = model_device(device, "the siamese tracker")
        with torch.device(self.device):
            self.net = EmbedNet(cfg.features).eval()
        self._ready = False

    def setup(self, *, require_weights: bool = False) -> None:
        """Load ``tracker-siamese-tpu`` (else the seeded init, with a
        warning); ``require_weights=True`` raises without a checkpoint that
        matches."""
        registry.load_module(self.net, MODEL_ID, require=require_weights)
        self._ready = True

    def track(self, frames: np.ndarray, box_xywh: tuple[float, float, float, float]) -> tuple[np.ndarray, np.ndarray]:
        """frames uint8 [T, H, W, 3]; box (x, y, w, h) on frame 0. Returns
        (boxes [T, 4] xywh in the clip's pixels, scores [T])."""
        if not self._ready:
            self.setup()

        def scan(small: np.ndarray, box0: np.ndarray) -> tuple:
            centres, scores = siamese_track(self.net, torch.from_numpy(small).to(self.device), box0, self.cfg)
            return centres.cpu().numpy(), scores.cpu().numpy()

        return host_track(frames, box_xywh, self.cfg.work_size, scan)
