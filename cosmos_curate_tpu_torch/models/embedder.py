"""Video embedder: frame features + temporal transformer -> one embedding
(port of ``cosmos_curate_tpu/models/embedder.py``).

A ViT encodes the N sampled frames of every clip in one batched pass; a
small temporal transformer with a learned query token pools them into one
L2-normalised vector. On the GPU every attention layer of both (12 in the
ViT-B/16, 4 in the base pooler) runs the flash kernel
(``ops/flash_attention.py``).

Weights: :meth:`VideoEmbedder.setup` initialises from a seed with flax's
initialisers, or loads a ``state_dict`` given as ``params`` (for example
the JAX model's parameters through ``models/convert_jax.py``). The JAX
package's msgpack checkpoint loader is not ported (no such checkpoint is in
the repository).
"""

from __future__ import annotations

from collections.abc import Sequence
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch
from torch import nn

from cosmos_curate_tpu_torch.core.model import ModelInterface
from cosmos_curate_tpu_torch.models.device_pipeline import DevicePipeline
from cosmos_curate_tpu_torch.models.layers import LayerNorm, Linear, TransformerBlock
from cosmos_curate_tpu_torch.models.vit import VIT_B_16, VIT_TINY_TEST, ViT, ViTConfig, preprocess_frames
from cosmos_curate_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)


@dataclass(frozen=True)
class VideoEmbedConfig:
    vit: ViTConfig = VIT_B_16
    temporal_layers: int = 4
    temporal_heads: int = 8
    num_frames: int = 8
    output_dim: int = 768


VIDEO_EMBED_BASE = VideoEmbedConfig()
VIDEO_EMBED_512 = VideoEmbedConfig(output_dim=512)
VIDEO_EMBED_256 = VideoEmbedConfig(temporal_layers=2, output_dim=256)
VIDEO_EMBED_TINY_TEST = VideoEmbedConfig(
    vit=VIT_TINY_TEST, temporal_layers=1, temporal_heads=2, num_frames=4, output_dim=32
)

# clips per dispatch: a stage call's 32 clips go out in two dispatches, so
# the host stacks the second while the device computes the first. On the
# H100 this ties one 32-clip dispatch in clips/s with half the host
# staging exposed; 8 makes the host's launches the bottleneck (PERF.md)
EMBED_MICRO_BATCH = 16

# variant name -> (config, model id): each output space has its own weights
VIDEO_EMBED_VARIANTS = {
    "video": (VIDEO_EMBED_BASE, "video-embed-tpu"),
    "video-512": (VIDEO_EMBED_512, "video-embed-512-tpu"),
    "video-256": (VIDEO_EMBED_256, "video-embed-256-tpu"),
}


class TemporalPooler(nn.Module):
    """frame features [B, T, D] -> [B, output_dim]: a learned query token
    and T frame tokens plus a learned time embedding, ``temporal_layers``
    pre-norm blocks (``t0``, ``t1``, ... as in the flax tree), a norm of the
    query token and an fp32 projection. D is the ViT's projection width."""

    def __init__(self, cfg: VideoEmbedConfig, dtype=torch.bfloat16):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        d = cfg.vit.projection_dim
        self.query = nn.Parameter(torch.zeros(1, 1, d))
        self.time_embed = nn.Parameter(torch.zeros(1, cfg.num_frames + 1, d))
        for i in range(cfg.temporal_layers):
            self.add_module(f"t{i}", TransformerBlock(d, cfg.temporal_heads, d // cfg.temporal_heads, dtype=dtype))
        self.ln = LayerNorm(d)
        self.proj = Linear(d, cfg.output_dim, dtype=torch.float32)

    def forward(self, frame_feats):
        b, t, d = frame_feats.shape
        query = self.query.to(self.dtype).expand(b, 1, d)
        x = torch.cat([query, frame_feats.to(self.dtype)], dim=1)
        x = x + self.time_embed[:, : t + 1].to(self.dtype)
        for i in range(self.cfg.temporal_layers):
            x = getattr(self, f"t{i}")(x)
        return self.proj(self.ln(x[:, 0]))


class VideoEmbedModel(nn.Module):
    """uint8 frames [B, T, H, W, 3] -> [B, output_dim] L2-normalised fp32."""

    def __init__(self, cfg: VideoEmbedConfig, dtype=torch.bfloat16):
        super().__init__()
        self.cfg = cfg
        self.vit = ViT(cfg.vit, dtype)
        self.pooler = TemporalPooler(cfg, dtype)

    @torch.no_grad()
    def init_weights(self, gen: torch.Generator) -> None:
        """flax initialisers: the ViT's own, normal(0.02) query and time
        embedding, xavier-uniform dense kernels with zero bias."""
        self.vit.init_weights(gen)
        self.pooler.query.normal_(0.0, 0.02, generator=gen)
        self.pooler.time_embed.normal_(0.0, 0.02, generator=gen)
        for m in self.pooler.modules():
            if isinstance(m, Linear):
                m.init_weights(gen)

    def forward(self, frames_u8):
        b, t = frames_u8.shape[:2]
        cfg = self.cfg.vit
        pixels = preprocess_frames(frames_u8, image_size=cfg.image_size, mode=cfg.preprocess)
        pooled, _ = self.vit(pixels.reshape(b * t, *pixels.shape[2:]))
        emb = self.pooler(pooled.reshape(b, t, -1)).float()
        return emb / torch.linalg.norm(emb, dim=-1, keepdim=True)


class VideoEmbedder(ModelInterface):
    """The embed stage's model: :class:`VideoEmbedModel` on ``device``
    ("cuda" unless the caller asks for the CPU), dispatched through a
    :class:`DevicePipeline`."""

    MODEL_ID = "video-embed-tpu"

    def __init__(
        self,
        cfg: VideoEmbedConfig = VIDEO_EMBED_BASE,
        *,
        model_id: str | None = None,
        params: dict[str, Any] | None = None,
        device: str | torch.device = "cuda",
    ) -> None:
        """``params``: a ``state_dict`` of :class:`VideoEmbedModel`, or None
        to initialise from ``setup``'s seed."""
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "VideoEmbedder runs on the GPU by default and no CUDA device is "
                "available; pass device='cpu' to run the plain versions on the CPU"
            )
        self.cfg = cfg
        self.model_id = model_id or self.MODEL_ID
        self.params = params
        self.model: VideoEmbedModel | None = None
        self._pipeline: DevicePipeline | None = None

    @property
    def model_id_names(self) -> list[str]:
        return [self.model_id]

    @property
    def embedding_dim(self) -> int:
        return self.cfg.output_dim

    def setup(self, seed: int = 0) -> None:
        with torch.device(self.device):
            model = VideoEmbedModel(self.cfg)
        if self.params is None:
            logger.info("%s: seeded random init (seed %d); pass params= for trained weights", self.model_id, seed)
            gen = torch.Generator(device=self.device)
            gen.manual_seed(seed)
            model.init_weights(gen)
        else:
            model.load_state_dict(self.params, strict=True)
        self.model = model.eval().requires_grad_(False)
        self._pipeline = DevicePipeline(
            f"embed/{self.model_id}", self._forward, device=self.device, micro_batch=EMBED_MICRO_BATCH
        )

    @torch.inference_mode()
    def _forward(self, frames_u8):
        return self.model(frames_u8)

    def sample_frame_indices(self, total: int) -> np.ndarray:
        """Uniform temporal sampling to cfg.num_frames indices."""
        n = self.cfg.num_frames
        if total <= 0:
            return np.zeros(0, np.int64)
        return np.linspace(0, max(total - 1, 0), n).round().astype(np.int64)

    def encode_clips(self, clips_frames: np.ndarray | Sequence[np.ndarray]) -> np.ndarray:
        """uint8 [B, T, H, W, 3], as one array or as B clips of [T, H, W,
        3], -> float32 [B, output_dim] normalised, through the pipeline:
        pow2 bucket micro-batches, each stacked on the host while the
        previous one computes, copies overlapped with compute, readback
        deferred."""
        if self._pipeline is None:
            raise RuntimeError("call setup() first")
        if len(clips_frames) == 0:
            return np.zeros((0, self.cfg.output_dim), np.float32)
        return self._pipeline.run(clips_frames)
