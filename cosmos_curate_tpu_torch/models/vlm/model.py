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

Vision variants: ``vit`` (the ``base``, ``tiny-test`` and text-only MoE
flavors), ``qwen2`` (the Qwen2-VL / Qwen2.5-VL towers of vision_qwen.py,
whose merger is the projector: flavors ``qwen2vl-2b``, ``qwen25vl-7b`` and
``qwen-chat-tiny-test``) and ``qwen3`` (the Qwen3-VL deepstack tower:
``qwen3vl-moe-a3b``), whose deepstack levels are added to the hidden states
after the first decoder layers of a prefill. The Qwen3 LM has qk-norm,
interleaved m-rope and the sparse :class:`MoEFFN`, whose experts are stored
in the compute dtype (bf16: 58 GB at Qwen3-VL-30B-A3B, where fp32 would be
116 GB).
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
from cosmos_curate_tpu_torch.models.vlm.vision_qwen import (
    QWEN2_VL_2B_VISION,
    QWEN3_VISION_TINY_TEST,
    QWEN3_VL_MOE_VISION,
    QWEN25_VL_7B_VISION,
    QWEN_VISION_TINY_TEST,
    QwenVisionTower,
    frames_to_patches,
)
from cosmos_curate_tpu_torch.ops.decode_attention import decode_attention
from cosmos_curate_tpu_torch.ops.paged_attention import paged_attention
from cosmos_curate_tpu_torch.ops.prefill_attention import chunk_attention_plain, prefill_attention


@dataclass(frozen=True)
class MoEConfig:
    """Sparse mixture-of-experts FFN settings (:class:`MoEFFN`)."""

    n_experts: int = 8
    top_k: int = 2
    hidden: int = 512  # per-expert intermediate width
    # expert-queue capacity = ceil(top_k * tokens / n_experts * factor);
    # None = every token fits (capacity = token count)
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
# Qwen2-VL-2B-Instruct: GQA 12 / 2 heads of 128, SwiGLU 8960, tied
# embeddings, rope 1e6, m-rope 16 / 24 / 24, the 32-deep 1280-wide tower
VLM_QWEN2_2B = VLMConfig(
    vocab=151936,
    dim=1536,
    n_layers=28,
    n_heads=12,
    n_kv_heads=2,
    head_dim=128,
    hidden_mult=8960 / 1536,
    max_seq=4096,
    rope_theta=1_000_000.0,
    qkv_bias=True,
    vision=VIT_B_16,
    vision_tokens=64,
    vision_variant="qwen2",
    qwen_vision=QWEN2_VL_2B_VISION,
    mrope_section=(16, 24, 24),
)
# Qwen2.5-VL-7B-Instruct: GQA 28 / 4 heads, SwiGLU 18944, untied head,
# m-rope 16 / 24 / 24, the windowed tower
VLM_QWEN25_7B = VLMConfig(
    vocab=152064,
    dim=3584,
    n_layers=28,
    n_heads=28,
    n_kv_heads=4,
    head_dim=128,
    hidden_mult=18944 / 3584,
    max_seq=4096,
    rope_theta=1_000_000.0,
    qkv_bias=True,
    vision=VIT_B_16,
    vision_tokens=64,
    vision_variant="qwen2",
    qwen_vision=QWEN25_VL_7B_VISION,
    mrope_section=(16, 24, 24),
    tied_embeddings=False,
)
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
# Qwen3-VL-30B-A3B's LM alone (text-only slot): GQA 32 / 4 heads of 128,
# qk-norm, interleaved m-rope 24 / 20 / 20, untied head, 48 MoE layers of
# 128 experts (top 8, 768 wide, capacity factor 2)
VLM_QWEN3_MOE_A3B = VLMConfig(
    vocab=151936,
    dim=2048,
    n_layers=48,
    n_heads=32,
    n_kv_heads=4,
    head_dim=128,
    hidden_mult=6144 / 2048,
    max_seq=4096,
    rope_theta=1_000_000.0,
    qkv_bias=False,
    qk_norm=True,
    vision=VIT_TINY_TEST,
    vision_tokens=8,
    mrope_section=(24, 20, 20),
    mrope_interleaved=True,
    tied_embeddings=False,
    moe=MoEConfig(n_experts=128, top_k=8, hidden=768, capacity_factor=2.0),
)
# the same LM under the deepstack tower (Qwen3-VL-30B-A3B)
VLM_QWEN3_VL_MOE_A3B = VLMConfig(
    vocab=151936,
    dim=2048,
    n_layers=48,
    n_heads=32,
    n_kv_heads=4,
    head_dim=128,
    hidden_mult=6144 / 2048,
    max_seq=4096,
    rope_theta=1_000_000.0,
    qkv_bias=False,
    qk_norm=True,
    vision=VIT_TINY_TEST,
    vision_variant="qwen3",
    qwen_vision=QWEN3_VL_MOE_VISION,
    mrope_section=(24, 20, 20),
    mrope_interleaved=True,
    tied_embeddings=False,
    moe=MoEConfig(n_experts=128, top_k=8, hidden=768, capacity_factor=2.0),
)
VLM_QWEN3VL_TINY_TEST = VLMConfig(
    vocab=512,
    dim=64,
    n_layers=2,
    n_heads=4,
    n_kv_heads=2,
    head_dim=16,
    max_seq=128,
    vision=VIT_TINY_TEST,
    vision_variant="qwen3",
    qwen_vision=QWEN3_VISION_TINY_TEST,
    mrope_section=(2, 3, 3),
    mrope_interleaved=True,
    qk_norm=True,
    moe=MoEConfig(n_experts=4, top_k=2, hidden=32),
)
VLM_MOE_TINY_TEST = VLMConfig(
    vocab=512,
    dim=64,
    n_layers=2,
    n_heads=4,
    n_kv_heads=2,
    head_dim=16,
    max_seq=128,
    vision=VIT_TINY_TEST,
    vision_tokens=8,
    qk_norm=True,
    moe=MoEConfig(n_experts=4, top_k=2, hidden=32),
)
VLM_QWEN2VL_TINY_TEST = VLMConfig(
    vocab=512,
    dim=64,
    n_layers=2,
    n_heads=4,
    n_kv_heads=2,
    head_dim=16,
    max_seq=128,
    vision=VIT_TINY_TEST,
    vision_variant="qwen2",
    qwen_vision=QWEN_VISION_TINY_TEST,
    mrope_section=(2, 3, 3),
)
# chat-template prompts in byte-level test tokens run ~170 ids: the
# hf_chat test flavor needs the extra context
VLM_QWEN_CHAT_TINY_TEST = VLMConfig(
    vocab=512,
    dim=64,
    n_layers=2,
    n_heads=4,
    n_kv_heads=2,
    head_dim=16,
    max_seq=256,
    vision=VIT_TINY_TEST,
    vision_variant="qwen2",
    qwen_vision=QWEN_VISION_TINY_TEST,
    mrope_section=(2, 3, 3),
)
# special-token ids inside the tiny configs' 512-row embedding, in
# QWEN2_SPECIAL_TOKENS' layout
_TINY_CHAT_SPECIALS = (
    ("<|endoftext|>", 500),
    ("<|im_start|>", 501),
    ("<|im_end|>", 502),
    ("<|vision_start|>", 503),
    ("<|vision_end|>", 504),
    ("<|vision_pad|>", 505),
    ("<|image_pad|>", 506),
    ("<|video_pad|>", 507),
)


@dataclass(frozen=True)
class FlavorSpec:
    """A caption flavor's serving spec: architecture, weight id, and the
    knobs that travel with the checkpoint."""

    cfg: VLMConfig
    model_id: str
    # a converted HF checkpoint indexes its embedding by the checkpoint's
    # own token ids and was trained on its chat template: served through
    # HFVocabTokenizer (staged vocab.json / merges.txt) and vlm/chat.py
    hf_chat: bool = False
    # a flavor naming a real checkpoint refuses to serve a random init
    require_weights: bool = True
    # hf_chat special-token table, (token, id) pairs; None = Qwen2's
    specials: tuple[tuple[str, int], ...] | None = None
    # no trained vision tower: frame-bearing requests are refused
    text_only: bool = False
    # default KV lanes ((length, n_slots), ...) for the caption engine
    kv_lanes: tuple[tuple[int, int], ...] | None = None


VLM_FLAVORS: dict[str, FlavorSpec] = {
    "base": FlavorSpec(VLM_BASE, "caption-vlm-tpu", require_weights=False),
    # 2B-class KV is cheap (2 KV heads): many short-lane slots for caption
    # windows, a few full-context rows
    "qwen2vl-2b": FlavorSpec(
        VLM_QWEN2_2B, "caption-qwen2vl-2b-tpu", hf_chat=True, kv_lanes=((1024, 8), (4096, 4))
    ),
    # 7B KV rows are 4x the 2B's: half the slots
    "qwen25vl-7b": FlavorSpec(
        VLM_QWEN25_7B, "caption-qwen25vl-7b-tpu", hf_chat=True, kv_lanes=((1024, 4), (4096, 2))
    ),
    "tiny-test": FlavorSpec(VLM_TINY_TEST, "caption-vlm-tpu", require_weights=False),
    # the MoE LM of an LM-only converted checkpoint (no vision params)
    "qwen3moe-a3b-lm": FlavorSpec(
        VLM_QWEN3_MOE_A3B, "caption-qwen3moe-a3b-tpu", hf_chat=True, text_only=True, kv_lanes=((1024, 4), (4096, 2))
    ),
    # Qwen3-VL-MoE: the deepstack tower and the sparse LM
    "qwen3vl-moe-a3b": FlavorSpec(
        VLM_QWEN3_VL_MOE_A3B, "caption-qwen3vl-moe-a3b-tpu", hf_chat=True, kv_lanes=((1024, 4), (4096, 2))
    ),
    "qwen3moe-tiny-test": FlavorSpec(VLM_MOE_TINY_TEST, "caption-vlm-tpu", require_weights=False),
    # the hf_chat plumbing (HFVocabTokenizer, the chat template) at test shapes
    "qwen-chat-tiny-test": FlavorSpec(
        VLM_QWEN_CHAT_TINY_TEST,
        "caption-vlm-tpu",
        hf_chat=True,
        require_weights=False,
        specials=_TINY_CHAT_SPECIALS,
        kv_lanes=((192, 4), (256, 2)),
    ),
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


def moe_forward(moe: MoEConfig, x, router, gate_up, down, dtype, route_log: list | None = None):
    """The sparse FFN of :class:`MoEFFN` over ``x`` [B, T, D], with its
    expert tensors given: ``gate_up`` [E, D, 2H] and ``down`` [E, H, D] are
    cast to ``dtype`` here (a no-op for the module's, stored in it).

    The router (fp32 ``router`` Linear, softmax over all experts, top-k,
    renormalised) gives each token k experts; assignment ``token * k +
    rank`` queues at the number of earlier assignments to its expert,
    counted token-major over all B * T rows, so padding rows and idle
    decode rows take queue places too. A place at or past the capacity
    ``max(1, min(n, ceil(k * n / e * factor)))`` (n with no factor) is
    dropped. Kept assignments are scattered into ``[E, cap, D]``, the expert
    SwiGLU runs as two batched products (the fused ``gate_up`` split as gate
    then up), and each assignment reads its queue slot back, weighted by its
    router probability and summed over k in fp32. ``route_log``, when
    given, gets (B, T, dropped assignments), the last a device tensor."""
    b, t, d = x.shape
    n = b * t
    e, k = moe.n_experts, moe.top_k
    tokens = x.reshape(n, d)
    probs = torch.softmax(router(tokens.float()), dim=-1)
    top_w, top_i = torch.topk(probs, k, dim=-1)
    top_w = top_w / top_w.sum(dim=-1, keepdim=True)
    cap = n if moe.capacity_factor is None else max(1, min(n, int(np.ceil(k * n / e * moe.capacity_factor))))
    a_ids = top_i.reshape(-1)  # [A] expert of each assignment, token-major
    onehot = F.one_hot(a_ids, e).to(torch.int32)
    pos = (onehot.cumsum(0, dtype=torch.int32) - onehot).gather(1, a_ids[:, None])[:, 0]
    keep = pos < cap
    # an overflowing assignment lands in one spare row past the queues
    dest = torch.where(keep, a_ids * cap + pos, e * cap)
    expert_in = tokens.new_zeros((e * cap + 1, d), dtype=dtype)
    expert_in[dest] = tokens.to(dtype).repeat_interleave(k, dim=0)
    z = torch.bmm(expert_in[:-1].reshape(e, cap, d), gate_up.to(dtype))
    gate, up = z.chunk(2, dim=-1)
    out = torch.bmm(F.silu(gate) * up, down.to(dtype)).reshape(e * cap, d)
    out_a = torch.where(keep[:, None], out[dest.clamp(max=e * cap - 1)], 0).float()
    y = (out_a * top_w.reshape(-1, 1)).reshape(n, k, d).sum(dim=1)
    if route_log is not None:
        route_log.append((b, t, (~keep).sum()))
    return y.reshape(b, t, d).to(x.dtype)


class MoEFFN(nn.Module):
    """The sparse mixture-of-experts FFN of the Qwen3 MoE LMs, GShard-style
    static dispatch (:func:`moe_forward`). The JAX module keeps fp32 experts
    and casts them to the compute dtype on every call; here they are stored
    in it, which gives the same bits."""

    def __init__(self, cfg: VLMConfig, dtype=torch.bfloat16):
        super().__init__()
        moe = cfg.moe
        self.cfg = moe
        self.dtype = dtype
        self.router = Linear(cfg.dim, moe.n_experts, bias=False, dtype=torch.float32)
        self.gate_up = nn.Parameter(torch.zeros(moe.n_experts, cfg.dim, 2 * moe.hidden, dtype=dtype))
        self.down = nn.Parameter(torch.zeros(moe.n_experts, moe.hidden, cfg.dim, dtype=dtype))

    @torch.no_grad()
    def init_weights(self, gen: torch.Generator) -> None:
        """flax's init of the experts: normal(0.02) (the router is a Linear)."""
        self.gate_up.normal_(0.0, 0.02, generator=gen)
        self.down.normal_(0.0, 0.02, generator=gen)

    def forward(self, x):
        return moe_forward(self.cfg, x, self.router, self.gate_up, self.down, self.dtype)


class DecoderLayer(nn.Module):
    def __init__(self, cfg: VLMConfig, dtype=torch.bfloat16):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        h, hk, dh, dim = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.dim
        self.ln1 = RMSNorm(dim, cfg.rms_eps)
        self.q = Linear(dim, h * dh, bias=cfg.qkv_bias, dtype=dtype)
        self.k = Linear(dim, hk * dh, bias=cfg.qkv_bias, dtype=dtype)
        self.v = Linear(dim, hk * dh, bias=cfg.qkv_bias, dtype=dtype)
        if cfg.qk_norm:  # Qwen3: an RMS norm over each head's dim, before rope
            self.q_norm = RMSNorm(dh, cfg.rms_eps)
            self.k_norm = RMSNorm(dh, cfg.rms_eps)
        self.o = Linear(h * dh, dim, bias=False, dtype=dtype)
        self.ln2 = RMSNorm(dim, cfg.rms_eps)
        if cfg.moe is not None:
            self.moe = MoEFFN(cfg, dtype)
        else:
            hidden = int(dim * cfg.hidden_mult)
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
        if cfg.qk_norm:
            q, k = self.q_norm(q), self.k_norm(k)
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
        if cfg.moe is not None:
            return x + self.moe(y)
        return x + self.down(F.silu(self.gate(y)) * self.up(y))


class VLM(nn.Module):
    def __init__(self, cfg: VLMConfig, dtype=torch.bfloat16):
        super().__init__()
        if cfg.vision_variant not in ("vit", "qwen2", "qwen3"):
            raise ValueError(f"unknown vision variant {cfg.vision_variant!r}")
        self.cfg = cfg
        self.dtype = dtype
        self.embed = nn.Embedding(cfg.vocab, cfg.dim)
        self.layers = nn.ModuleList(DecoderLayer(cfg, dtype) for _ in range(cfg.n_layers))
        self.ln_f = RMSNorm(cfg.dim, cfg.rms_eps)
        self.lm_head = (
            None if cfg.tied_embeddings else Linear(cfg.dim, cfg.vocab, bias=False, dtype=torch.float32)
        )
        if cfg.vision_variant in ("qwen2", "qwen3"):
            # the tower's merger already projects into the LM width
            self.vision = QwenVisionTower(cfg.qwen_vision, dtype)
            self.projector = None
        else:
            self.vision = ViT(cfg.vision, dtype)
            self.projector = nn.Sequential(
                Linear(cfg.vision.width, cfg.dim * 2, dtype=dtype),
                nn.GELU(approximate="tanh"),
                Linear(cfg.dim * 2, cfg.dim, dtype=dtype),
            )

    @torch.no_grad()
    def init_weights(self, gen: torch.Generator) -> None:
        """Seeded init with the flax initialisers: normal(0.02) embeddings
        and experts, xavier-uniform dense kernels, zero biases (norms keep
        their unit scale from construction)."""
        self.embed.weight.normal_(0.0, 0.02, generator=gen)
        self.vision.init_weights(gen)
        for name, m in self.named_modules():
            if isinstance(m, MoEFFN):
                m.init_weights(gen)
            elif isinstance(m, Linear) and not name.startswith("vision."):
                m.init_weights(gen)

    def encode_images(self, frames_u8):
        """uint8 [B, N, Hp, Wp, 3] -> [B, T_vis, dim] LM embeddings.

        ``vit``: frames through the ViT, patch tokens mean-pooled over
        frames, strided to ``vision_tokens``, projected. ``qwen2``: frames
        -> 3-D patches -> the Qwen tower; its merged grid, t-major
        row-major (what ``build_mrope_positions`` assumes), is the
        sequence. ``qwen3``: the same, returned with its deepstack levels
        ``[L_ds, B, T_vis, dim]`` as ``(embeds, deepstack)``."""
        cfg = self.cfg
        if cfg.vision_variant in ("qwen2", "qwen3"):
            patches, grid = frames_to_patches(frames_u8, cfg.qwen_vision)
            return self.vision(patches, grid)
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

    def forward(self, embeds, cache_k, cache_v, positions, write_index, kv_len, deepstack=None):
        """Forward over input embeddings against slot caches.

        embeds: [B, T, D]; cache_k/v: [L, B, S, Hkv, Dh] (updated in place);
        positions: [B, T] rope positions ([B, T, 3] under m-rope);
        write_index/kv_len: [B] int32; deepstack: None or [L_ds, B, T, D]
        visual features, level i added to the hidden states after layer i
        (zeros at text positions; prefill only). Returns (logits [B, T,
        vocab], cache_k, cache_v)."""
        x = embeds.to(self.dtype)
        n_ds = 0 if deepstack is None else deepstack.shape[0]
        for i, layer in enumerate(self.layers):
            x = layer(x, cache_k[i], cache_v[i], positions, write_index, kv_len)
            if i < n_ds:
                x = x + deepstack[i].to(x.dtype)
        return self._logits(x), cache_k, cache_v

    def paged_forward(
        self, embeds, pool_k, pool_v, positions, write_index, kv_len, block_tables, deepstack=None
    ):
        """Forward straight against the paged pools ``[L, NB, bs, Hkv, Dh]``
        (updated in place): each layer scatters its chunk through
        ``block_tables`` [B, nbl] int32 and attends in place
        (ops/paged_attention.py); ``deepstack`` as in :meth:`forward`.
        Returns (logits, pool_k, pool_v)."""
        x = embeds.to(self.dtype)
        n_ds = 0 if deepstack is None else deepstack.shape[0]
        plan = paged_write_plan(block_tables, write_index, x.shape[1], pool_k.shape[2])
        for i, layer in enumerate(self.layers):
            x = layer(
                x, pool_k, pool_v, positions, write_index, kv_len,
                block_tables=block_tables, layer_index=i, write_plan=plan,
            )
            if i < n_ds:
                x = x + deepstack[i].to(x.dtype)
        return self._logits(x), pool_k, pool_v


def init_cache(cfg: VLMConfig, batch: int, dtype=torch.bfloat16, length: int | None = None, device=None):
    shape = (cfg.n_layers, batch, length or cfg.max_seq, cfg.n_kv_heads, cfg.head_dim)
    return (
        torch.zeros(shape, dtype=dtype, device=device),
        torch.zeros(shape, dtype=dtype, device=device),
    )
