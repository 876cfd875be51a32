"""CurateVLM, the vision-language captioning model (port of
``cosmos_curate_tpu/models/vlm/model.py``).

- vision tower = the shared ViT backbone (models/vit.py); its patch tokens
  are mean-pooled over frames, strided to ``vision_tokens`` and projected
  into the LM embedding space;
- language model = decoder-only transformer with RoPE and grouped-query
  attention, fp32 parameters and bf16 compute;
- inference is cache-centric: :meth:`VLM.forward` runs against slot caches
  ``[L, B, S, Hkv, Dh]`` and :meth:`VLM.paged_forward` against the paged
  block pools ``[L, NB, bs, Hkv, Dh]``. Both update the caches IN PLACE
  (the reference returns new ones) and return them.

This slice ports the ``vit`` vision variant with the ``base`` and
``tiny-test`` flavors; the Qwen vision towers and the MoE FFN wait for later
slices (ROADMAP queue A).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from cosmos_curate_tpu_torch.models.layers import Linear
from cosmos_curate_tpu_torch.models.vit import VIT_B_16, VIT_TINY_TEST, ViT, ViTConfig, preprocess_frames
from cosmos_curate_tpu_torch.models.vlm.paged_kv import paged_update, paged_write_plan
from cosmos_curate_tpu_torch.ops.decode_attention import decode_attention
from cosmos_curate_tpu_torch.ops.paged_attention import paged_attention
from cosmos_curate_tpu_torch.ops.prefill_attention import chunk_attention_plain, prefill_attention


@dataclass(frozen=True)
class MoEConfig:
    """Sparse mixture-of-experts FFN settings (mirrored; the MoE FFN itself
    is not ported yet)."""

    n_experts: int = 8
    top_k: int = 2
    hidden: int = 512
    capacity_factor: float | None = None


@dataclass(frozen=True)
class VLMConfig:
    vocab: int = 512
    dim: int = 1024
    n_layers: int = 12
    n_heads: int = 16
    n_kv_heads: int = 8
    head_dim: int = 64
    hidden_mult: float = 4.0
    max_seq: int = 1024
    rope_theta: float = 10000.0
    qkv_bias: bool = False
    vision: ViTConfig = VIT_B_16
    vision_tokens: int = 64
    vision_variant: str = "vit"
    qwen_vision: Any = None
    mrope_section: tuple[int, int, int] | None = None
    rms_eps: float = 1e-6
    tied_embeddings: bool = True
    qk_norm: bool = False
    moe: MoEConfig | None = None
    mrope_interleaved: bool = False


VLM_BASE = VLMConfig()
VLM_TINY_TEST = VLMConfig(
    vocab=512,
    dim=64,
    n_layers=2,
    n_heads=4,
    n_kv_heads=2,
    head_dim=16,
    max_seq=128,
    vision=VIT_TINY_TEST,
    vision_tokens=8,
)


@dataclass(frozen=True)
class FlavorSpec:
    cfg: VLMConfig
    model_id: str
    hf_chat: bool = False
    require_weights: bool = True
    specials: tuple[tuple[str, int], ...] | None = None
    text_only: bool = False
    kv_lanes: tuple[tuple[int, int], ...] | None = None


VLM_FLAVORS: dict[str, FlavorSpec] = {
    "base": FlavorSpec(VLM_BASE, "caption-vlm-tpu", require_weights=False),
    "tiny-test": FlavorSpec(VLM_TINY_TEST, "caption-vlm-tpu", require_weights=False),
}


def vlm_flavor(name: str) -> FlavorSpec:
    """The full serving spec for a named caption flavor."""
    try:
        return VLM_FLAVORS[name]
    except KeyError:
        raise ValueError(f"unknown caption model {name!r}; choose from {sorted(VLM_FLAVORS)}") from None


def rope_frequencies(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim))


def mrope_component_map(mrope_section: tuple[int, int, int], interleaved: bool) -> np.ndarray:
    """Which (t=0, h=1, w=2) position component drives each of the D/2
    rotary frequency dims: chunked sections (Qwen2-VL) or interleaved
    (Qwen3-VL)."""
    if not interleaved:
        return np.repeat(np.arange(3), np.asarray(mrope_section))
    comp = np.zeros(int(sum(mrope_section)), np.int64)
    comp[1 : 3 * mrope_section[1] : 3] = 1
    comp[2 : 3 * mrope_section[2] : 3] = 2
    return comp


def apply_rope(x, positions, theta: float, mrope_section=None, mrope_interleaved: bool = False):
    """x: [B, T, H, D]; positions: [B, T] absolute positions, or [B, T, 3]
    (t, h, w) multimodal positions under m-rope. Computed in fp32, returned
    in x's dtype."""
    freqs = rope_frequencies(x.shape[-1], theta, x.device)
    if positions.dim() == 3:
        if mrope_section is None:
            raise ValueError("3-component positions require mrope_section")
        comp = torch.as_tensor(mrope_component_map(mrope_section, mrope_interleaved), device=x.device)
        angles = positions[..., comp].float() * freqs
    else:
        angles = positions[..., None].float() * freqs
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1).to(x.dtype)


def build_mrope_positions(
    n_text_before: int,
    grid_merged: tuple[int, int, int] | None,
    n_text_after: int,
    t_scale: float = 1.0,
) -> tuple[np.ndarray, int]:
    """(t, h, w) position ids for a [text][vision][text] prompt layout (HF
    ``get_rope_index`` semantics). Returns ([T, 3] int32, next_position)."""
    parts = []
    if n_text_before:
        t = np.arange(n_text_before, dtype=np.int32)
        parts.append(np.stack([t, t, t], axis=-1))
    offset = n_text_before
    if grid_merged is not None:
        gt, gh, gw = grid_merged
        t_idx = np.floor(np.repeat(np.arange(gt, dtype=np.float64), gh * gw) * t_scale).astype(np.int32)
        h_idx = np.tile(np.repeat(np.arange(gh, dtype=np.int32), gw), gt)
        w_idx = np.tile(np.tile(np.arange(gw, dtype=np.int32), gh), gt)
        parts.append(offset + np.stack([t_idx, h_idx, w_idx], axis=-1))
        offset += max(int(t_idx[-1]) + 1 if gt else 0, gh, gw)
    if n_text_after:
        t = offset + np.arange(n_text_after, dtype=np.int32)
        parts.append(np.stack([t, t, t], axis=-1))
        offset += n_text_after
    if not parts:
        return np.zeros((0, 3), np.int32), offset
    return np.concatenate(parts, axis=0).astype(np.int32), offset


class RMSNorm(nn.Module):
    """RMS norm computed in fp32, returned in the input dtype."""

    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))

    def forward(self, x):
        x32 = x.float()
        normed = x32 * torch.rsqrt((x32 * x32).mean(dim=-1, keepdim=True) + self.eps)
        return (normed * self.weight).to(x.dtype)


def _use_decode_kernel(x) -> bool:
    """A contiguous one-token step on the GPU goes through the decode
    kernel at every cache length (no TPU-derived length gate carries over);
    the CPU keeps the einsum lines, the JAX package's path off-TPU."""
    return x.device.type == "cuda"


def write_rows(cache, chunk, write_index) -> None:
    """``cache[b, i : i + T] = chunk[b]`` for every row, in place, with
    ``dynamic_update_slice``'s clamp: a start past ``S - T`` moves back so
    the chunk stays inside the cache."""
    b, t = chunk.shape[:2]
    start = write_index.long().clamp(0, cache.shape[1] - t)
    idx = start[:, None] + torch.arange(t, device=cache.device)[None, :]
    cache[torch.arange(b, device=cache.device)[:, None], idx] = chunk.to(cache.dtype)


class DecoderLayer(nn.Module):
    def __init__(self, cfg: VLMConfig, dtype=torch.bfloat16):
        super().__init__()
        if cfg.moe is not None or cfg.qk_norm:
            raise NotImplementedError("MoE FFN and qk-norm not ported yet (ROADMAP queue A: Qwen flavors)")
        self.cfg = cfg
        self.dtype = dtype
        h, hk, dh, dim = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.dim
        hidden = int(dim * cfg.hidden_mult)
        self.ln1 = RMSNorm(dim, cfg.rms_eps)
        self.q = Linear(dim, h * dh, bias=cfg.qkv_bias, dtype=dtype)
        self.k = Linear(dim, hk * dh, bias=cfg.qkv_bias, dtype=dtype)
        self.v = Linear(dim, hk * dh, bias=cfg.qkv_bias, dtype=dtype)
        self.o = Linear(h * dh, dim, bias=False, dtype=dtype)
        self.ln2 = RMSNorm(dim, cfg.rms_eps)
        self.up = Linear(dim, hidden, bias=False, dtype=dtype)
        self.gate = Linear(dim, hidden, bias=False, dtype=dtype)
        self.down = Linear(hidden, dim, bias=False, dtype=dtype)

    def forward(
        self, x, cache_k, cache_v, positions, write_index, kv_len,
        block_tables=None, layer_index: int = 0, write_plan=None,
    ):
        """One decoder layer.

        Contiguous mode: cache_k/v ``[B, S, Hkv, Dh]``; the chunk's K/V land
        at ``write_index``. Paged mode (``block_tables`` ``[B, nbl]`` set):
        cache_k/v are the FULL pools ``[L, NB, bs, Hkv, Dh]``; K/V scatter
        through the table (``write_plan`` from :func:`paged_write_plan`,
        built here when absent) and attention reads the pool in place.
        Causality is by cache order, ``write_index + t``; ``kv_len`` is the
        valid length after writing. Caches update in place."""
        cfg = self.cfg
        b, t, _ = x.shape
        h, hk, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        y = self.ln1(x)
        q = self.q(y).reshape(b, t, h, dh)
        k = self.k(y).reshape(b, t, hk, dh)
        v = self.v(y).reshape(b, t, hk, dh)
        q = apply_rope(q, positions, cfg.rope_theta, cfg.mrope_section, cfg.mrope_interleaved)
        k = apply_rope(k, positions, cfg.rope_theta, cfg.mrope_section, cfg.mrope_interleaved)
        qg = q.reshape(b, t, hk, h // hk, dh)
        if block_tables is not None:
            if write_plan is None:
                write_plan = paged_write_plan(block_tables, write_index, t, cache_k.shape[2])
            paged_update(cache_k, cache_v, k, v, write_plan, layer_index=layer_index)
            attn = paged_attention(
                qg, cache_k, cache_v, block_tables, write_index, kv_len, layer_index=layer_index
            )
        else:
            write_rows(cache_k, k, write_index)
            write_rows(cache_v, v, write_index)
            if t > 1:
                attn = prefill_attention(qg, cache_k, cache_v, write_index, kv_len)
            elif _use_decode_kernel(x):
                attn = decode_attention(qg[:, 0], cache_k, cache_v, kv_len)[:, None]
            else:
                attn = chunk_attention_plain(qg, cache_k, cache_v, write_index, kv_len, dh**-0.5)
        x = x + self.o(attn.to(self.dtype).reshape(b, t, h * dh))
        y = self.ln2(x)
        return x + self.down(F.silu(self.gate(y)) * self.up(y))


class VLM(nn.Module):
    def __init__(self, cfg: VLMConfig, dtype=torch.bfloat16):
        super().__init__()
        if cfg.vision_variant != "vit":
            raise NotImplementedError(
                f"vision variant {cfg.vision_variant!r} not ported yet (ROADMAP queue A: Qwen flavors)"
            )
        self.cfg = cfg
        self.dtype = dtype
        self.embed = nn.Embedding(cfg.vocab, cfg.dim)
        self.layers = nn.ModuleList(DecoderLayer(cfg, dtype) for _ in range(cfg.n_layers))
        self.ln_f = RMSNorm(cfg.dim, cfg.rms_eps)
        self.lm_head = (
            None if cfg.tied_embeddings else Linear(cfg.dim, cfg.vocab, bias=False, dtype=torch.float32)
        )
        self.vision = ViT(cfg.vision, dtype)
        self.projector = nn.Sequential(
            Linear(cfg.vision.width, cfg.dim * 2, dtype=dtype),
            nn.GELU(approximate="tanh"),
            Linear(cfg.dim * 2, cfg.dim, dtype=dtype),
        )

    @torch.no_grad()
    def init_weights(self, gen: torch.Generator) -> None:
        """Seeded init with the flax initialisers: normal(0.02) embeddings,
        xavier-uniform dense kernels, zero biases (norms keep their unit
        scale from construction)."""
        self.embed.weight.normal_(0.0, 0.02, generator=gen)
        self.vision.init_weights(gen)
        for name, m in self.named_modules():
            if isinstance(m, Linear) and not name.startswith("vision."):
                m.init_weights(gen)

    def encode_images(self, frames_u8):
        """uint8 [B, N, Hp, Wp, 3] -> [B, vision_tokens, dim] LM embeddings:
        frames through the ViT, patch tokens mean-pooled over frames, strided
        to ``vision_tokens``, projected."""
        cfg = self.cfg
        b, n = frames_u8.shape[:2]
        pixels = preprocess_frames(frames_u8, image_size=cfg.vision.image_size, mode=cfg.vision.preprocess)
        _, tokens = self.vision(pixels.reshape(b * n, *pixels.shape[2:]))
        tokens = tokens[:, 1:]  # drop cls
        tokens = tokens.reshape(b, n, tokens.shape[1], tokens.shape[2]).mean(dim=1)
        stride = max(1, tokens.shape[1] // cfg.vision_tokens)
        tokens = tokens[:, ::stride][:, : cfg.vision_tokens]
        return self.projector(tokens)

    def embed_tokens(self, token_ids):
        return F.embedding(token_ids.long(), self.embed.weight).to(self.dtype)

    def _logits(self, x):
        x = self.ln_f(x)
        if self.lm_head is not None:
            return self.lm_head(x.float())
        return torch.matmul(x.to(self.dtype), self.embed.weight.to(self.dtype).t())

    def forward(self, embeds, cache_k, cache_v, positions, write_index, kv_len):
        """Forward over input embeddings against slot caches.

        embeds: [B, T, D]; cache_k/v: [L, B, S, Hkv, Dh] (updated in place);
        positions: [B, T] rope positions ([B, T, 3] under m-rope);
        write_index/kv_len: [B] int32. Returns (logits [B, T, vocab],
        cache_k, cache_v)."""
        x = embeds.to(self.dtype)
        for i, layer in enumerate(self.layers):
            x = layer(x, cache_k[i], cache_v[i], positions, write_index, kv_len)
        return self._logits(x), cache_k, cache_v

    def paged_forward(self, embeds, pool_k, pool_v, positions, write_index, kv_len, block_tables):
        """Forward straight against the paged pools ``[L, NB, bs, Hkv, Dh]``
        (updated in place): each layer scatters its chunk through
        ``block_tables`` [B, nbl] int32 and attends in place
        (ops/paged_attention.py). Returns (logits, pool_k, pool_v)."""
        x = embeds.to(self.dtype)
        plan = paged_write_plan(block_tables, write_index, x.shape[1], pool_k.shape[2])
        for i, layer in enumerate(self.layers):
            x = layer(
                x, pool_k, pool_v, positions, write_index, kv_len,
                block_tables=block_tables, layer_index=i, write_plan=plan,
            )
        return self._logits(x), pool_k, pool_v


def init_cache(cfg: VLMConfig, batch: int, dtype=torch.bfloat16, length: int | None = None, device=None):
    shape = (cfg.n_layers, batch, length or cfg.max_seq, cfg.n_kv_heads, cfg.head_dim)
    return (
        torch.zeros(shape, dtype=dtype, device=device),
        torch.zeros(shape, dtype=dtype, device=device),
    )
