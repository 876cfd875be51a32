"""Video super resolution: a residual conv net over windows of frames (port
of ``cosmos_curate_tpu/models/super_resolution.py``).

``SRNet``: a conv trunk of residual blocks and a depth-to-space 2x
upsampler, added to a bilinear upsample of the input. The super-resolution
stage runs it window by window (stages/super_resolution.py). The weights
are ``super-resolution-tpu`` (the JAX package's flax msgpack through
``models/registry.py``; the modules keep flax's names ``Conv_0``,
``ResBlock_{i}/Conv_{j}``); none ship with the repository, so without a
staged checkpoint the net has its seeded init.

Layouts: frames come and go as uint8 NHWC; inside, the convs are NCHW, and
the depth-to-space keeps flax's channel order (``(row, col, rgb)``).

Precision mirrors the reference's dtype flow: every conv computes in bf16
over fp32 parameters (flax's ``dtype=bfloat16``), and the bilinear base and
the residual sum are fp32. The uint8 output truncates ``out * 255``. The
bilinear base is ``F.interpolate(mode="bilinear", align_corners=False)``:
for an integer upsample it equals ``jax.image.resize(..., "bilinear")``,
edges included (a test holds them to 1e-6).

Not ported: ``sp_size > 1``, the reference's ``shard_map`` of a window's
frames over a ``seq`` mesh (ROADMAP queue A item 7); it raises
``NotImplementedError``.

Entry points run on ``device="cuda"`` unless the caller asks for the CPU.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from cosmos_curate_tpu_torch.core.model import ModelInterface, model_device
from cosmos_curate_tpu_torch.models import registry
from cosmos_curate_tpu_torch.models.device_pipeline import DevicePipeline
from cosmos_curate_tpu_torch.models.ocr import _fp32, _init_convs, same_padding

MODEL_ID = "super-resolution-tpu"
SEQ_SHARDING = "sequence-parallel SR (sp_size > 1) is not ported: ROADMAP queue A item 7"

registry.register_model(MODEL_ID, "windowed conv video SR")


@dataclass(frozen=True)
class SRConfig:
    channels: int = 64
    blocks: int = 6
    scale: int = 2  # depth-to-space factor


SR_BASE = SRConfig()
SR_TINY_TEST = SRConfig(channels=8, blocks=1)


def conv_as(conv: nn.Conv2d, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Flax ``nn.Conv(..., dtype=dtype)`` with ``SAME`` padding: input,
    kernel and bias cast to ``dtype``, flax's asymmetric padding where the
    total is odd (a stride-2 conv on an even size)."""
    (kh, kw), (sh, sw) = conv.kernel_size, conv.stride
    top, bottom = same_padding(x.shape[-2], kh, sh)
    left, right = same_padding(x.shape[-1], kw, sw)
    x = x.to(dtype)
    weight, bias = conv.weight.to(dtype), conv.bias.to(dtype)
    if top == bottom and left == right:  # conv's own padding: no padded copy
        return F.conv2d(x, weight, bias, conv.stride, (top, left))
    return F.conv2d(F.pad(x, (left, right, top, bottom)), weight, bias, conv.stride)


def depth_to_space(x: torch.Tensor, s: int) -> torch.Tensor:
    """NCHW [N, s*s*C, H, W] -> [N, C, H*s, W*s], channel ``(i*s + j)*C + c``
    to pixel (y*s + i, x*s + j), as the reference's NHWC reshape orders it."""
    n, c, h, w = x.shape
    c //= s * s
    return x.reshape(n, s, s, c, h, w).permute(0, 3, 4, 1, 5, 2).reshape(n, c, h * s, w * s)


def bilinear_up(frames_u8: torch.Tensor, s: int) -> torch.Tensor:
    """uint8 NHWC [T, H, W, 3] -> float32 NCHW [T, 3, H*s, W*s] in [0, 1]."""
    x = frames_u8.permute(0, 3, 1, 2).to(torch.float32) / 255.0
    h, w = x.shape[-2:]
    return F.interpolate(x, size=(h * s, w * s), mode="bilinear", align_corners=False, antialias=False)


def to_uint8(x: torch.Tensor) -> torch.Tensor:
    """float NCHW in [0, 1] -> uint8 NHWC, ``out * 255`` truncated."""
    return (x * 255.0).to(torch.uint8).permute(0, 2, 3, 1)


class ResBlock(nn.Module):
    def __init__(self, channels: int) -> None:
        super().__init__()
        self.Conv_0 = nn.Conv2d(channels, channels, 3)
        self.Conv_1 = nn.Conv2d(channels, channels, 3)

    def forward(self, x: torch.Tensor, dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
        h = F.relu(conv_as(self.Conv_0, x, dtype))
        return x + conv_as(self.Conv_1, h, dtype)


class SRNet(nn.Module):
    def __init__(self, cfg: SRConfig = SR_BASE) -> None:
        super().__init__()
        self.cfg = cfg
        c = cfg.channels
        self.Conv_0 = nn.Conv2d(3, c, 3)
        for i in range(cfg.blocks):
            self.add_module(f"ResBlock_{i}", ResBlock(c))
        self.Conv_1 = nn.Conv2d(c, 3 * cfg.scale * cfg.scale, 3)
        self.compute_dtype = torch.bfloat16  # the reference's; float32 for a reference run

    def init_weights(self, generator: torch.Generator) -> None:
        _init_convs(self, generator)

    def residual(self, frames_u8: torch.Tensor) -> torch.Tensor:
        """uint8 [T, H, W, 3] -> the net's upsampled residual, NCHW
        [T, 3, H*scale, W*scale] in ``compute_dtype``."""
        dtype = self.compute_dtype
        x = frames_u8.permute(0, 3, 1, 2).to(dtype) / 255.0
        x = conv_as(self.Conv_0, x, dtype)
        for i in range(self.cfg.blocks):
            x = getattr(self, f"ResBlock_{i}")(x, dtype)
        return depth_to_space(conv_as(self.Conv_1, x, dtype), self.cfg.scale)

    def forward(self, frames_u8: torch.Tensor, *, float_out: bool = False) -> torch.Tensor:
        """uint8 [T, H, W, 3] -> uint8 [T, H*scale, W*scale, 3]; with
        ``float_out`` the float32 image in [0, 1] before quantisation."""
        base = bilinear_up(frames_u8, self.cfg.scale)
        out = torch.clamp(base + self.residual(frames_u8).to(torch.float32), 0.0, 1.0)
        return out.permute(0, 2, 3, 1) if float_out else to_uint8(out)


class SuperResolutionModel(ModelInterface):
    MODEL_ID = MODEL_ID

    def __init__(self, cfg: SRConfig = SR_BASE, *, sp_size: int = 1, device: str | torch.device = "cuda") -> None:
        if sp_size > 1:
            raise NotImplementedError(SEQ_SHARDING)
        self.cfg = cfg
        self.sp_size = sp_size
        self.device = model_device(device, "super resolution")
        self.net: SRNet | None = None
        self._pipeline: DevicePipeline | None = None

    @property
    def model_id_names(self) -> list[str]:
        return [self.MODEL_ID]

    def setup(self, *, require_weights: bool = False) -> None:
        """Build the net and load its checkpoint (else the seeded init;
        ``require_weights=True`` raises instead)."""
        with torch.device(self.device):
            self.net = SRNet(self.cfg).eval()
        registry.load_module(self.net, self.MODEL_ID, require=require_weights)
        self._pipeline = DevicePipeline("sr/srnet", self._forward, device=self.device)

    def _forward(self, frames_u8: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode(), _fp32(self.device):
            return self.net(frames_u8)

    def submit_window(self, frames: np.ndarray) -> None:
        """Queue one window; the results come back in submission order at
        ``drain_windows``, so the stage submits a clip's windows before
        reading any back."""
        if self._pipeline is None:
            raise RuntimeError("call setup() first")
        self._pipeline.submit(frames)

    def drain_windows(self) -> list[np.ndarray]:
        return self._pipeline.drain()

    def upscale_window(self, frames: np.ndarray) -> np.ndarray:
        """One window, synchronously."""
        self.submit_window(frames)
        return self.drain_windows()[0]
