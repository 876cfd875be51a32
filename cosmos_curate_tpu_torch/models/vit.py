"""Vision Transformer backbone (port of ``cosmos_curate_tpu/models/vit.py``).

Patchify is one stride-``patch`` convolution, compute runs in the module's
``dtype`` with fp32 parameters. Frames keep the reference's channels-last
layout (``[B, H, W, 3]``) at the public functions.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from cosmos_curate_tpu_torch.models.layers import LayerNorm, Linear, TransformerBlock, lecun_normal_


@dataclass(frozen=True)
class ViTConfig:
    image_size: int = 224
    patch_size: int = 14
    width: int = 1024
    layers: int = 24
    heads: int = 16
    projection_dim: int = 768
    act: str = "gelu"  # "gelu" | "quick_gelu"
    ln_eps: float = 1e-6
    # "simple" ([-1, 1], full-image bilinear) | "clip"
    preprocess: str = "simple"

    @property
    def head_dim(self) -> int:
        return self.width // self.heads

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2


VIT_L_14 = ViTConfig()
VIT_B_16 = ViTConfig(patch_size=16, width=768, layers=12, heads=12, projection_dim=512)
VIT_TINY_TEST = ViTConfig(image_size=32, patch_size=8, width=64, layers=2, heads=4, projection_dim=32)


class ViT(nn.Module):
    """Image encoder: pixels [B, H, W, 3] float in [-1, 1] -> (pooled [B, P],
    tokens [B, N + 1, W])."""

    def __init__(self, cfg: ViTConfig, dtype=torch.bfloat16):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        w = cfg.width
        self.patch_embed = nn.Conv2d(3, w, cfg.patch_size, stride=cfg.patch_size, bias=False)
        self.cls = nn.Parameter(torch.zeros(1, 1, w))
        self.pos_embed = nn.Parameter(torch.zeros(1, cfg.num_patches + 1, w))
        self.ln_pre = LayerNorm(w, eps=cfg.ln_eps)
        self.blocks = nn.ModuleList(
            TransformerBlock(w, cfg.heads, cfg.head_dim, dtype=dtype, act=cfg.act, ln_eps=cfg.ln_eps)
            for _ in range(cfg.layers)
        )
        self.ln_post = LayerNorm(w, eps=cfg.ln_eps)
        self.proj = Linear(w, cfg.projection_dim, bias=False, dtype=dtype)

    def init_weights(self, gen: torch.Generator) -> None:
        """flax initialisers: lecun-normal (truncated) conv, normal(0.02)
        cls / pos, xavier-uniform dense (norms keep their construction-time
        unit scale and zero bias)."""
        lecun_normal_(self.patch_embed.weight, gen)
        with torch.no_grad():
            self.cls.normal_(0.0, 0.02, generator=gen)
            self.pos_embed.normal_(0.0, 0.02, generator=gen)
        for m in self.modules():
            if isinstance(m, Linear):
                m.init_weights(gen)

    def forward(self, pixels):
        x = F.conv2d(
            pixels.to(self.dtype).permute(0, 3, 1, 2),
            self.patch_embed.weight.to(self.dtype),
            stride=self.cfg.patch_size,
        )
        b, w, gh, gw = x.shape
        x = x.permute(0, 2, 3, 1).reshape(b, gh * gw, w)
        cls = self.cls.to(self.dtype).expand(b, 1, w)
        x = torch.cat([cls, x], dim=1) + self.pos_embed.to(self.dtype)
        x = self.ln_pre(x)
        for block in self.blocks:
            x = block(x)
        x = self.ln_post(x)
        return self.proj(x[:, 0]), x


# OpenAI CLIP training normalization (HF CLIPImageProcessor defaults).
CLIP_IMAGE_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_IMAGE_STD = (0.26862954, 0.26130258, 0.27577711)


def _triangle(x):
    return torch.clamp(1.0 - x.abs(), min=0.0)


def _cubic(x):
    # Keys cubic kernel, a = -0.5 (jax.image's "cubic")
    x = x.abs()
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    return torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out).masked_fill(x >= 2.0, 0.0)


def _resize_weights(in_size: int, out_size: int, kernel, device) -> torch.Tensor:
    """[in, out] interpolation weights of ``jax.image.resize`` (antialiased:
    the kernel widens by the downsampling factor), fp32."""
    scale = out_size / in_size
    inv_scale = 1.0 / scale
    kernel_scale = max(inv_scale, 1.0)
    sample_f = (torch.arange(out_size, dtype=torch.float32, device=device) + 0.5) * inv_scale - 0.5
    x = (sample_f[None, :] - torch.arange(in_size, dtype=torch.float32, device=device)[:, None]).abs()
    weights = kernel(x / kernel_scale)
    total = weights.sum(dim=0, keepdim=True)
    eps = 1000.0 * torch.finfo(torch.float32).eps
    weights = torch.where(total.abs() > eps, weights / torch.where(total != 0, total, 1.0), 0.0)
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return torch.where(inside[None, :], weights, 0.0)


def resize_images(x, out_h: int, out_w: int, method: str = "bilinear"):
    """``jax.image.resize(x, (N, out_h, out_w, C), method)`` for fp32
    ``[N, H, W, C]`` images: separable, antialiased when downsampling."""
    kernel = {"bilinear": _triangle, "bicubic": _cubic}[method]
    n, h, w, c = x.shape
    if h != out_h:
        x = torch.einsum("nhwc,hH->nHwc", x, _resize_weights(h, out_h, kernel, x.device))
    if w != out_w:
        x = torch.einsum("nhwc,wW->nhWc", x, _resize_weights(w, out_w, kernel, x.device))
    return x


def preprocess_frames(frames, *, image_size: int, mode: str = "simple"):
    """uint8 [..., H, W, 3] -> float model input, on the frames' device.

    ``simple``: scale to [-1, 1] + full-image bilinear resize. ``clip``:
    bicubic shortest-side resize, center crop, CLIP mean/std."""
    x = frames.float()
    h, w = x.shape[-3], x.shape[-2]
    batch_dims = x.shape[:-3]
    if mode == "clip":
        x = x.reshape(-1, h, w, 3)
        if (h, w) != (image_size, image_size):
            scale = image_size / min(h, w)
            nh = max(image_size, int(round(h * scale)))
            nw = max(image_size, int(round(w * scale)))
            x = resize_images(x, nh, nw, "bicubic")
            top = (nh - image_size) // 2
            left = (nw - image_size) // 2
            x = x[:, top : top + image_size, left : left + image_size, :]
        x = x / 255.0
        mean = torch.tensor(CLIP_IMAGE_MEAN, device=x.device)
        std = torch.tensor(CLIP_IMAGE_STD, device=x.device)
        x = (x - mean) / std
        return x.reshape(*batch_dims, image_size, image_size, 3)
    if mode != "simple":
        raise ValueError(f"unknown preprocess mode {mode!r}")
    x = x / 127.5 - 1.0
    if (h, w) != (image_size, image_size):
        x = resize_images(x.reshape(-1, h, w, 3), image_size, image_size, "bilinear")
        x = x.reshape(*batch_dims, image_size, image_size, 3)
    return x
