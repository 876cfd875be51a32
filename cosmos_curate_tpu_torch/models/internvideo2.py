"""InternVideo2 video embedder (port of ``cosmos_curate_tpu/models/internvideo2.py``).

The reference's stage-2 video tower on its ``get_vid_feat`` path: 3D
tubelet patches, a deep ViT of RMSNorm blocks with QK-normalisation over
the whole flattened width and LayerScale, an attentive pooling block, and
the multimodal ``vision_proj`` head giving the L2-normalised 512-d
embedding the split pipeline stores per clip.

Precision follows the flax modules: parameters in fp32, compute in the
module's ``dtype`` (bf16 on the card), fp32 attention logits and softmax
with the probabilities cast back to ``dtype``, fp32 norms and pooling
statistics. TF32 stays off: the fp32 logits are fp32 products.

The attention is plain PyTorch (matmul, fp32 softmax, matmul), as the JAX
package computes it in einsums outside any Pallas kernel; its head dim (88
at ``IV2_1B``) is outside the flash kernel's. Its fp32 logits are ``[n,
heads, S, S]`` (268 MB a clip at ``IV2_1B``'s S = 2049), so the blocks run
the attention over chunks of clips (``layers.chunked_attention``): the same math,
a peak bounded whatever the micro-batch.
"""

from __future__ import annotations

from collections.abc import Sequence
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from cosmos_curate_tpu_torch.core.model import ModelInterface, model_device
from cosmos_curate_tpu_torch.models import registry
from cosmos_curate_tpu_torch.models.device_pipeline import DevicePipeline
from cosmos_curate_tpu_torch.models.layers import LayerNorm, Linear, chunked_attention



@dataclass(frozen=True)
class IV2Config:
    img_size: int = 224
    patch_size: int = 14
    tubelet_size: int = 1
    num_frames: int = 8
    embed_dim: int = 1408
    depth: int = 40
    num_heads: int = 16
    mlp_ratio: float = 48 / 11
    qkv_bias: bool = False
    qk_normalization: bool = True
    # LayerScale init (checkpoint values load over it)
    init_values: float = 1e-5
    attn_pool_num_heads: int = 16
    clip_embed_dim: int = 768
    # the multimodal head's contrastive dim
    proj_dim: int = 512
    rms_eps: float = 1e-6
    ln_eps: float = 1e-5

    @property
    def grid(self) -> tuple[int, int, int]:
        hw = self.img_size // self.patch_size
        return (self.num_frames // self.tubelet_size, hw, hw)

    @property
    def num_patches(self) -> int:
        gt, gh, gw = self.grid
        return gt * gh * gw

    @property
    def patch_dim(self) -> int:
        return 3 * self.tubelet_size * self.patch_size * self.patch_size

    @property
    def head_dim(self) -> int:
        return self.embed_dim // self.num_heads

    @property
    def mlp_hidden(self) -> int:
        """The MLP's width, computed as the flax block does (6144 at 1B)."""
        return int(self.embed_dim * self.mlp_ratio)


# InternVideo2-1B stage 2 (clip_embed_dim 768, multimodal embed_dim 512)
IV2_1B = IV2Config()
IV2_TINY_TEST = IV2Config(
    img_size=28,
    patch_size=14,
    num_frames=2,
    embed_dim=32,
    depth=2,
    num_heads=4,
    mlp_ratio=2.0,
    attn_pool_num_heads=4,
    clip_embed_dim=16,
    proj_dim=8,
)

# ImageNet normalisation
IV2_MEAN = (0.485, 0.456, 0.406)
IV2_STD = (0.229, 0.224, 0.225)


def sincos_1d(dim: int, positions: np.ndarray) -> np.ndarray:
    """Standard 1D sincos table (even dim): ``[len(positions), dim]``."""
    omega = 1.0 / (10000 ** (np.arange(dim // 2, dtype=np.float64) / (dim / 2.0)))
    out = np.einsum("p,d->pd", positions.astype(np.float64), omega)
    return np.concatenate([np.sin(out), np.cos(out)], axis=1)


def sincos_3d_pos_embed(dim: int, grid: tuple[int, int, int]) -> np.ndarray:
    """3D sincos position table with a leading class-token row of zeros:
    dim // 4 temporal + the rest spatial (2D sincos over two halves). The
    reference's quirk ("w goes first"): the FIRST spatial half encodes the
    w coordinate, the second the h coordinate."""
    gt, gh, gw = grid
    dim_t = dim // 4
    dim_s = dim - dim_t
    hh, ww = np.meshgrid(np.arange(gh), np.arange(gw), indexing="ij")
    emb_w = sincos_1d(dim_s // 2, ww.reshape(-1))
    emb_h = sincos_1d(dim_s // 2, hh.reshape(-1))
    spatial = np.concatenate([emb_w, emb_h], axis=1)  # [gh*gw, dim_s]
    temporal = sincos_1d(dim_t, np.arange(gt))  # [gt, dim_t]
    spatial = np.tile(spatial[None], (gt, 1, 1)).reshape(gt * gh * gw, dim_s)
    temporal = np.repeat(temporal, gh * gw, axis=0)
    table = np.concatenate([temporal, spatial], axis=1)
    return np.concatenate([np.zeros((1, dim)), table], axis=0).astype(np.float32)


def frames_to_tubelets(frames: torch.Tensor, cfg: IV2Config) -> torch.Tensor:
    """uint8/float ``[B, T, H, W, 3]`` -> fp32 ``[B, num_patches, patch_dim]``
    tubelet vectors in (c, kt, kh, kw) element order (the flatten order of
    the reference Conv3d's weight); the grid in (t, h, w) row-major order."""
    b = frames.shape[0]
    gt, gh, gw = cfg.grid
    tub, p = cfg.tubelet_size, cfg.patch_size
    mean = torch.tensor(IV2_MEAN, device=frames.device)
    std = torch.tensor(IV2_STD, device=frames.device)
    x = (frames.float() / 255.0 - mean) / std
    x = x.reshape(b, gt, tub, gh, p, gw, p, 3)
    x = x.permute(0, 1, 3, 5, 7, 2, 4, 6)  # [B, gt, gh, gw, c, tub, ph, pw]
    return x.reshape(b, cfg.num_patches, cfg.patch_dim)


class IV2RMSNorm(nn.Module):
    """RMSNorm in fp32, output in the input's dtype."""

    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))

    def forward(self, x):
        x32 = x.float()
        normed = x32 * torch.rsqrt((x32 * x32).mean(dim=-1, keepdim=True) + self.eps)
        return (normed * self.weight).to(x.dtype)


class IV2Block(nn.Module):
    def __init__(self, cfg: IV2Config, dtype=torch.float32):
        super().__init__()
        c = cfg.embed_dim
        self.cfg = cfg
        self.dtype = dtype
        self.ln1 = IV2RMSNorm(c, cfg.rms_eps)
        self.qkv = Linear(c, 3 * c, bias=cfg.qkv_bias, dtype=dtype)
        if cfg.qk_normalization:
            self.q_norm = IV2RMSNorm(c, cfg.rms_eps)
            self.k_norm = IV2RMSNorm(c, cfg.rms_eps)
        self.attn_out = Linear(c, c, dtype=dtype)
        self.ls1 = nn.Parameter(torch.full((c,), cfg.init_values))
        self.ln2 = IV2RMSNorm(c, cfg.rms_eps)
        self.fc1 = Linear(c, cfg.mlp_hidden, dtype=dtype)
        self.fc2 = Linear(cfg.mlp_hidden, c, dtype=dtype)
        self.ls2 = nn.Parameter(torch.full((c,), cfg.init_values))

    def forward(self, x):
        cfg = self.cfg
        b, n, c = x.shape
        h, d = cfg.num_heads, cfg.head_dim
        qkv = self.qkv(self.ln1(x)).reshape(b, n, 3, h, d)
        q, k, v = qkv.unbind(2)
        if cfg.qk_normalization:
            # over the FULL flattened width, not per head (the reference's)
            q = self.q_norm(q.reshape(b, n, c)).reshape(b, n, h, d)
            k = self.k_norm(k.reshape(b, n, c)).reshape(b, n, h, d)
        attn = self.attn_out(chunked_attention(q, k, v, self.dtype).reshape(b, n, c))
        x = x + (attn.float() * self.ls1).to(x.dtype)
        y = self.fc2(F.gelu(self.fc1(self.ln2(x))))  # exact erf, as torch's nn.GELU
        return x + (y.float() * self.ls2).to(x.dtype)


class IV2AttentionPool(nn.Module):
    """The reference's attentive pooling block: the mean token, as query,
    cross-attends the sequence; the output is projected to
    ``clip_embed_dim``."""

    def __init__(self, cfg: IV2Config, dtype=torch.float32):
        super().__init__()
        c = cfg.embed_dim
        self.cfg = cfg
        self.dtype = dtype
        self.ln_q = LayerNorm(c, eps=cfg.ln_eps)
        self.ln_k = LayerNorm(c, eps=cfg.ln_eps)
        self.ln_v = LayerNorm(c, eps=cfg.ln_eps)
        self.q = Linear(c, c, dtype=dtype)
        self.k = Linear(c, c, dtype=dtype)
        self.v = Linear(c, c, dtype=dtype)
        self.out = Linear(c, cfg.clip_embed_dim, dtype=dtype)

    def forward(self, x):
        b, n, c = x.shape
        h = self.cfg.attn_pool_num_heads
        d = c // h
        q = self.q(self.ln_q(x.mean(dim=1, keepdim=True).float())).reshape(b, 1, h, d)
        k = self.k(self.ln_k(x.float())).reshape(b, n, h, d)
        v = self.v(self.ln_v(x.float())).reshape(b, n, h, d)
        pooled = chunked_attention(q, k, v, self.dtype).reshape(b, 1, c)
        return self.out(pooled)[:, 0]


class InternVideo2Tower(nn.Module):
    """uint8 frames ``[B, T, H, W, 3]`` -> L2-normalised fp32 ``[B,
    proj_dim]`` (tower -> attentive pool -> vision_proj -> normalise)."""

    def __init__(self, cfg: IV2Config, dtype=torch.bfloat16):
        super().__init__()
        c = cfg.embed_dim
        self.cfg = cfg
        self.dtype = dtype
        self.patch_proj = Linear(cfg.patch_dim, c, dtype=dtype)
        self.cls = nn.Parameter(torch.zeros(1, 1, c))
        self.pos_embed = nn.Parameter(torch.as_tensor(sincos_3d_pos_embed(c, cfg.grid)[None], device=self.cls.device))
        self.blocks = nn.ModuleList(IV2Block(cfg, dtype) for _ in range(cfg.depth))
        self.pool = IV2AttentionPool(cfg, dtype)
        self.vision_proj = Linear(cfg.clip_embed_dim, cfg.proj_dim, dtype=torch.float32)

    @torch.no_grad()
    def init_weights(self, gen: torch.Generator) -> None:
        """flax initialisers: xavier-uniform dense kernels with zero bias,
        normal(0.02) class token; the sincos table, the norms' unit scales
        and LayerScale's ``init_values`` keep their construction values."""
        self.cls.normal_(0.0, 0.02, generator=gen)
        for m in self.modules():
            if isinstance(m, Linear):
                m.init_weights(gen)

    def forward(self, frames_u8):
        cfg = self.cfg
        x = self.patch_proj(frames_to_tubelets(frames_u8, cfg))
        b = x.shape[0]
        x = torch.cat([self.cls.to(self.dtype).expand(b, 1, cfg.embed_dim), x], dim=1)
        x = (x.float() + self.pos_embed).to(self.dtype)
        for block in self.blocks:
            x = block(x)
        proj = self.vision_proj(self.pool(x).float())
        return proj / (torch.linalg.norm(proj, dim=-1, keepdim=True) + 1e-12)


# Embedding-stage variants: name -> (config, weight-registry id, whether
# staged weights are required). The 1B flavor refuses a random init: a user
# asking for InternVideo2 embeddings must not silently get noise.
IV2_VARIANTS: dict[str, tuple[IV2Config, str, bool]] = {
    "iv2": (IV2_1B, "internvideo2-1b-tpu", True),
    "iv2-tiny-test": (IV2_TINY_TEST, "internvideo2-tiny-test", False),
}


class IV2Embedder(ModelInterface):
    """The embedding stage's InternVideo2 model (the same surface as
    ``VideoEmbedder``: ``sample_frame_indices`` / ``encode_clips`` /
    ``embedding_dim``) on ``device`` ("cuda" unless the caller asks for the
    CPU). Weights: ``params`` (a ``state_dict``) when given, else the
    staged checkpoint, else the seeded init unless ``require_weights``."""

    MODEL_ID = "internvideo2-1b-tpu"

    def __init__(
        self,
        cfg: IV2Config = IV2_1B,
        *,
        model_id: str | None = None,
        require_weights: bool = False,
        params: dict[str, Any] | None = None,
        device: str | torch.device = "cuda",
    ) -> None:
        self.device = model_device(device, "the InternVideo2 embedder")
        self.cfg = cfg
        self.model_id = model_id or self.MODEL_ID
        self.require_weights = require_weights
        self.params = params
        self.model: InternVideo2Tower | None = None
        self._pipeline: DevicePipeline | None = None

    @property
    def model_id_names(self) -> list[str]:
        return [self.model_id]

    @property
    def embedding_dim(self) -> int:
        return self.cfg.proj_dim

    def setup(self) -> None:
        # refuse before building the tower: 1B parameters for nothing
        if self.params is None and self.require_weights and registry.resolve_checkpoint(self.model_id) is None:
            raise RuntimeError(
                f"{self.model_id} requires trained weights: pass params= or stage "
                f"{registry.local_dir_for(self.model_id) / 'params.msgpack'}"
            )
        with torch.device(self.device):
            model = InternVideo2Tower(self.cfg)
        registry.load_module(model, self.model_id, self.params, require=self.require_weights)
        self.model = model.eval().requires_grad_(False)
        self._pipeline = DevicePipeline(f"iv2/{self.model_id}", self._forward, device=self.device)

    @torch.inference_mode()
    def _forward(self, frames_u8):
        return self.model(frames_u8)

    def sample_frame_indices(self, total: int) -> np.ndarray:
        """Uniform temporal sampling to ``cfg.num_frames`` indices."""
        n = self.cfg.num_frames
        if total <= 0:
            return np.zeros(0, np.int64)
        return np.linspace(0, max(total - 1, 0), n).round().astype(np.int64)

    def _resize(self, clips):
        """Each clip ``[T, H, W, 3]`` to ``img_size``² (cv2 ``INTER_AREA``)
        unless it is already that size."""
        s = self.cfg.img_size
        if all(clip.shape[1:3] == (s, s) for clip in clips):
            return clips
        import cv2

        return [np.stack([cv2.resize(f, (s, s), interpolation=cv2.INTER_AREA) for f in clip]) for clip in clips]

    def encode_clips(self, clips_frames: np.ndarray | Sequence[np.ndarray]) -> np.ndarray:
        """uint8 ``[B, T, H, W, 3]``, as one array or as B clips of ``[T, H,
        W, 3]``, -> float32 ``[B, proj_dim]`` normalised, through the
        pipeline (bucket micro-batches, copies overlapped with compute,
        readback deferred)."""
        if self._pipeline is None:
            raise RuntimeError("call setup() first")
        if len(clips_frames) == 0:
            return np.zeros((0, self.cfg.proj_dim), np.float32)
        return self._pipeline.run(self._resize(clips_frames)).astype(np.float32)
