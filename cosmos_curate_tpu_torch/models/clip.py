"""CLIP-style image embedder and aesthetic head (port of
``cosmos_curate_tpu/models/clip.py``).

``CLIPImageEmbeddings``: uint8 frames -> preprocess -> ViT -> pooled in
fp32 -> divided by its norm (no epsilon), dispatched through a
:class:`DevicePipeline`. ``AestheticScorer``: a pure Linear stack over
those embeddings, in fp32. ``CLIPAestheticScorer`` composes the two, on the
L/14 tower by default: the reference's aesthetic head is trained on 768-d
CLIP-L embeddings.

On the GPU every attention layer of the ViT runs the flash kernel
(``layers.Attention``): ViT-B/16 at ``[n, 12, 197, 64]``, ViT-L/14 at
``[n, 16, 257, 64]``.

Weights: ``params`` (a ``state_dict``) when given, else the registry's
staged ``params.msgpack`` under the model's id (the JAX package's
checkpoint, bridged by ``models/convert_jax.py``), else a seeded init.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch
from torch import nn

from cosmos_curate_tpu_torch.core.model import ModelInterface, model_device
from cosmos_curate_tpu_torch.models import registry
from cosmos_curate_tpu_torch.models.device_pipeline import DevicePipeline
from cosmos_curate_tpu_torch.models.layers import Linear, lecun_normal_
from cosmos_curate_tpu_torch.models.vit import VIT_B_16, VIT_L_14, VIT_TINY_TEST, ViT, ViTConfig, preprocess_frames

# The clip-vit-* registry slots hold OpenAI-CLIP-converted checkpoints, so
# their configs carry CLIP's activation, layer-norm eps and preprocessing
_CONFIGS: dict[str, ViTConfig] = {
    "clip-vit-l14-tpu": dataclasses.replace(VIT_L_14, act="quick_gelu", ln_eps=1e-5, preprocess="clip"),
    "clip-vit-b16-tpu": dataclasses.replace(VIT_B_16, act="quick_gelu", ln_eps=1e-5, preprocess="clip"),
    "clip-vit-tiny-test": VIT_TINY_TEST,
}


class AestheticMLP(nn.Module):
    """Score head over image embeddings: Linear(768, 1024) -> ... ->
    Linear(16, 1) with NO activations (the reference checkpoint is a pure
    Linear stack), in fp32."""

    hidden: tuple[int, ...] = (1024, 128, 64, 16)

    def __init__(self, embedding_dim: int):
        super().__init__()
        dims = (embedding_dim, *self.hidden)
        for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
            self.add_module(f"fc{i}", Linear(a, b, dtype=torch.float32))
        self.out = Linear(dims[-1], 1, dtype=torch.float32)

    def init_weights(self, gen: torch.Generator) -> None:
        """flax ``nn.Dense``'s defaults: lecun-normal kernels, zero bias."""
        for m in self.modules():
            if isinstance(m, Linear):
                lecun_normal_(m.weight, gen)
                nn.init.zeros_(m.bias)

    def forward(self, emb):
        x = emb.float()
        for i in range(len(self.hidden)):
            x = getattr(self, f"fc{i}")(x)
        return self.out(x)[..., 0]


class CLIPImageModel(ViT):
    """uint8 frames ``[N, H, W, 3]`` -> ``[N, P]`` fp32, unit norm. The ViT's
    parameters at the top level, as in the flax tree."""

    def forward(self, frames_u8):
        pixels = preprocess_frames(frames_u8, image_size=self.cfg.image_size, mode=self.cfg.preprocess)
        pooled = super().forward(pixels)[0].float()
        return pooled / torch.linalg.norm(pooled, dim=-1, keepdim=True)


class CLIPImageEmbeddings(ModelInterface):
    """Batched image -> normalised embedding on ``device`` ("cuda" unless
    the caller asks for the CPU)."""

    def __init__(
        self,
        variant: str = "clip-vit-b16-tpu",
        *,
        params: dict[str, Any] | None = None,
        device: str | torch.device = "cuda",
    ) -> None:
        if variant not in _CONFIGS:
            raise ValueError(f"unknown CLIP variant {variant!r}; have {sorted(_CONFIGS)}")
        self.device = model_device(device, "the CLIP embedder")
        self.variant = variant
        self.cfg = _CONFIGS[variant]
        self.params = params
        self.model: CLIPImageModel | None = None
        self._pipeline: DevicePipeline | None = None

    @property
    def model_id_names(self) -> list[str]:
        return [self.variant]

    @property
    def embedding_dim(self) -> int:
        return self.cfg.projection_dim

    def setup(self) -> None:
        with torch.device(self.device):
            model = CLIPImageModel(self.cfg)
        registry.load_module(model, self.variant, self.params)
        self.model = model.eval().requires_grad_(False)
        self._pipeline = DevicePipeline(f"clip/{self.variant}", self._forward, device=self.device)

    @torch.inference_mode()
    def _forward(self, frames_u8):
        return self.model(frames_u8)

    def encode_frames(self, frames_u8: np.ndarray) -> np.ndarray:
        """uint8 ``[N, H, W, 3]`` -> float32 ``[N, P]`` normalised, through
        the pipeline (pow2 bucket micro-batches, copies overlapped with
        compute, readback deferred)."""
        if self._pipeline is None:
            raise RuntimeError("call setup() first")
        return self._pipeline.run(frames_u8)


class AestheticScorer(ModelInterface):
    """Embeddings -> scalar score (compose with CLIPImageEmbeddings)."""

    MODEL_ID = "aesthetics-mlp-tpu"

    def __init__(
        self,
        embedding_dim: int = 512,
        *,
        params: dict[str, Any] | None = None,
        device: str | torch.device = "cuda",
    ) -> None:
        self.device = model_device(device, "the aesthetic scorer")
        self.embedding_dim = embedding_dim
        self.params = params
        self.model: AestheticMLP | None = None
        self._pipeline: DevicePipeline | None = None

    @property
    def model_id_names(self) -> list[str]:
        return [self.MODEL_ID]

    def setup(self) -> None:
        with torch.device(self.device):
            model = AestheticMLP(self.embedding_dim)
        registry.load_module(model, self.MODEL_ID, self.params)
        self.model = model.eval().requires_grad_(False)
        self._pipeline = DevicePipeline("aesthetic-mlp", self._forward, device=self.device)

    @torch.inference_mode()
    def _forward(self, emb):
        return self.model(emb)

    def score(self, embeddings: np.ndarray) -> np.ndarray:
        if self._pipeline is None:
            raise RuntimeError("call setup() first")
        return self._pipeline.run(embeddings)


class CLIPAestheticScorer(ModelInterface):
    """Fused frames -> aesthetic score, on the L/14 tower by default.
    ``clip_params`` / ``head_params``: ``state_dict``s of the two models,
    else each loads through the registry."""

    def __init__(
        self,
        variant: str = "clip-vit-l14-tpu",
        *,
        clip_params: dict[str, Any] | None = None,
        head_params: dict[str, Any] | None = None,
        device: str | torch.device = "cuda",
    ) -> None:
        self.clip = CLIPImageEmbeddings(variant, params=clip_params, device=device)
        self.head = AestheticScorer(self.clip.embedding_dim, params=head_params, device=device)

    @property
    def device(self) -> torch.device:
        return self.clip.device

    @property
    def model_id_names(self) -> list[str]:
        return self.clip.model_id_names + self.head.model_id_names

    def setup(self) -> None:
        self.clip.setup()
        self.head.setup()

    def score_frames(self, frames_u8: np.ndarray) -> np.ndarray:
        return self.head.score(self.clip.encode_frames(frames_u8))
