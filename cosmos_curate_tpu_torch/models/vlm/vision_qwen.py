"""Qwen2-VL / Qwen2.5-VL / Qwen3-VL vision towers (port of
``cosmos_curate_tpu/models/vlm/vision_qwen.py``): 3-D patchify as one
matmul, 2-D rope in merge-window order, per-frame (and, for Qwen2.5-VL,
windowed) attention, and the patch merger into the LM width.

A batch is dense ``[B, S, patch_dim]`` with one static ``(t, h, w)`` grid;
the attention's frame and window boundaries are a block-diagonal mask.
Variants:

- ``qwen2``: LayerNorm (eps 1e-6, fp32 statistics) blocks, quick_gelu MLP,
  full attention within each temporal frame;
- ``qwen2_5``: RMSNorm blocks, biased SwiGLU MLP, tokens permuted into
  window-major order with attention inside each window except at
  ``fullatt_block_indexes``, and the inverse permutation after the merger;
- ``qwen3``: a biased patch projection plus a learned pos-embed table,
  bilinearly interpolated onto the patch grid (host-side matrix) and
  repeated over t; LayerNorm blocks with a tanh-GELU MLP; deepstack mergers
  (merge-window group, LayerNorm, fc1, exact GELU, fc2) on the hidden states
  after ``deepstack_indexes``, returned beside the merged tokens.

The attention is plain PyTorch, as the JAX package computes it in einsums:
rope in fp32, fp32 logits scaled by ``dh**-0.5``, the mask as ``-1e30``,
fp32 softmax, probabilities cast to the compute dtype for P·V. Its head dim
(80 at the Qwen2 towers, 72 at Qwen3-VL's) is outside every kernel's. The logits are
``[n, heads, S, S]`` fp32 (64 MB a clip at S = 1024), so they are computed
over chunks of clips (``layers.chunked_attention``).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from cosmos_curate_tpu_torch.models.layers import LayerNorm, Linear, chunked_attention, quick_gelu
from cosmos_curate_tpu_torch.models.vit import preprocess_frames


@dataclass(frozen=True)
class QwenVisionConfig:
    depth: int = 32
    embed_dim: int = 1280
    num_heads: int = 16
    hidden_size: int = 1536  # LM dim the merger projects into
    mlp_ratio: float = 4.0
    patch_size: int = 14
    temporal_patch_size: int = 2
    spatial_merge_size: int = 2
    in_channels: int = 3
    image_size: int = 224
    variant: str = "qwen2"  # "qwen2" | "qwen2_5" | "qwen3"
    intermediate_size: int | None = None  # qwen2_5 sets this explicitly
    window_size: int = 112  # pixels; qwen2_5 only
    fullatt_block_indexes: tuple[int, ...] = ()
    # Qwen2.5-VL's temporal m-rope scale: t_index = floor(grid_t_idx *
    # second_per_grid_t * tokens_per_second); None = unscaled (Qwen2-VL)
    tokens_per_second: float | None = None
    # qwen3 only: learned pos-embed grid side and deepstack tap blocks
    pos_embed_side: int = 0
    deepstack_indexes: tuple[int, ...] = ()

    @property
    def mlp_hidden(self) -> int:
        if self.intermediate_size is not None:
            return self.intermediate_size
        return int(self.embed_dim * self.mlp_ratio)

    @property
    def head_dim(self) -> int:
        return self.embed_dim // self.num_heads

    @property
    def patch_dim(self) -> int:
        return self.in_channels * self.temporal_patch_size * self.patch_size**2

    def grid(self, n_frames: int) -> tuple[int, int, int]:
        """Static (t, h, w) patch grid for n_frames at image_size."""
        t = -(-n_frames // self.temporal_patch_size)
        hw = self.image_size // self.patch_size
        return t, hw, hw

    def tokens_out(self, n_frames: int) -> int:
        t, h, w = self.grid(n_frames)
        return t * h * w // self.spatial_merge_size**2

    def merged_grid(self, n_frames: int) -> tuple[int, int, int]:
        """Grid of MERGED tokens (what the LM sees; m-rope position space)."""
        t, h, w = self.grid(n_frames)
        m = self.spatial_merge_size
        return t, h // m, w // m


# Qwen2-VL-2B-Instruct's visual config: depth 32 / 1280 / 16 heads, merger -> 1536
QWEN2_VL_2B_VISION = QwenVisionConfig()
# Qwen2.5-VL-7B-Instruct's: SwiGLU 3420, 112 px windows, full attention at
# blocks 7/15/23/31, merger -> 3584
QWEN25_VL_7B_VISION = QwenVisionConfig(
    depth=32,
    embed_dim=1280,
    num_heads=16,
    hidden_size=3584,
    intermediate_size=3420,
    variant="qwen2_5",
    window_size=112,
    fullatt_block_indexes=(7, 15, 23, 31),
    tokens_per_second=2.0,
)
# Qwen3-VL(-MoE)'s deepstack tower: 27 deep / 1152 / 16 heads (D = 72),
# tanh-GELU MLP 4304, 16 px patches, a learned 48 x 48 pos-embed grid,
# deepstack taps after blocks 8 / 16 / 24, merger -> 2048
QWEN3_VL_MOE_VISION = QwenVisionConfig(
    depth=27,
    embed_dim=1152,
    num_heads=16,
    hidden_size=2048,
    intermediate_size=4304,
    patch_size=16,
    variant="qwen3",
    pos_embed_side=48,
    deepstack_indexes=(8, 16, 24),
)
QWEN3_VISION_TINY_TEST = QwenVisionConfig(
    depth=3,
    embed_dim=32,
    num_heads=4,
    hidden_size=64,
    intermediate_size=64,
    patch_size=8,
    image_size=32,
    variant="qwen3",
    pos_embed_side=4,
    deepstack_indexes=(0, 1),
)
QWEN_VISION_TINY_TEST = QwenVisionConfig(
    depth=2,
    embed_dim=64,
    num_heads=4,
    hidden_size=64,
    mlp_ratio=2.0,
    patch_size=8,
    image_size=32,
)


def _merge_order(pos: np.ndarray, h: int, w: int, msz: int) -> np.ndarray:
    """[h, w] -> [h * w] with each msz x msz merge window contiguous."""
    return pos.reshape(h // msz, msz, w // msz, msz).transpose(0, 2, 1, 3).reshape(-1)


def pos_embed_interp_matrix(cfg: QwenVisionConfig, grid: tuple[int, int, int]) -> np.ndarray:
    """Host-side [h * w, side²] bilinear interpolation of the learned
    pos-embed table onto one temporal slice of the patch grid, in
    merge-window order (HF ``fast_pos_embed_interpolate``: linspace over
    the side, four-neighbour weights, which clipped edge neighbours
    accumulate); the caller repeats the product over t."""
    _t, h, w = grid
    side, msz = cfg.pos_embed_side, cfg.spatial_merge_size
    h_idx = np.linspace(0, side - 1, h)
    w_idx = np.linspace(0, side - 1, w)
    h0, w0 = h_idx.astype(np.int64), w_idx.astype(np.int64)
    h1, w1 = np.clip(h0 + 1, None, side - 1), np.clip(w0 + 1, None, side - 1)
    dh, dw = (h_idx - h0)[:, None], (w_idx - w0)[None, :]
    mat = np.zeros((h * w, side * side), np.float32)
    rows = np.arange(h * w)
    for hi, wi, wgt in (
        (h0, w0, (1 - dh) * (1 - dw)),
        (h0, w1, (1 - dh) * dw),
        (h1, w0, dh * (1 - dw)),
        (h1, w1, dh * dw),
    ):
        np.add.at(mat, (rows, (hi[:, None] * side + wi[None, :]).reshape(-1)), wgt.reshape(-1))
    return mat[_merge_order(np.arange(h * w).reshape(h, w), h, w, msz)]


def rotary_tables(cfg: QwenVisionConfig, grid: tuple[int, int, int]) -> np.ndarray:
    """Host-side [S, head_dim] rope angles in merge-window patch order: the
    (h, w) position of each patch indexes ``outer(pos, inv_freq(head_dim /
    2))``, the two halves concatenate to head_dim / 2, repeated over t and
    doubled for rotate-half cos / sin (HF ``rot_pos_emb``)."""
    t, h, w = grid
    msz = cfg.spatial_merge_size
    hpos = _merge_order(np.arange(h)[:, None].repeat(w, axis=1), h, w, msz)
    wpos = _merge_order(np.arange(w)[None, :].repeat(h, axis=0), h, w, msz)
    dim = cfg.head_dim // 2
    inv_freq = 1.0 / (10000.0 ** (np.arange(0, dim, 2, dtype=np.float64) / dim))
    table = np.arange(max(h, w), dtype=np.float64)[:, None] * inv_freq[None, :]
    angles = np.tile(np.concatenate([table[hpos], table[wpos]], axis=-1), (t, 1))
    return np.concatenate([angles, angles], axis=-1).astype(np.float32)


def window_partition(cfg: QwenVisionConfig, grid: tuple[int, int, int]):
    """Host-side window permutation of the qwen2_5 variant (HF
    ``get_window_index`` for one grid): merge units regrouped window-major,
    windows padded with -100 where the merged grid is not a multiple of the
    window. Returns (token permutation [S], window id of each permuted
    token [S], merge-unit permutation [S / merge²])."""
    t, h, w = grid
    msz = cfg.spatial_merge_size
    unit = msz * msz
    lh, lw = h // msz, w // msz
    vws = max(1, cfg.window_size // msz // cfg.patch_size)
    index = np.arange(t * lh * lw).reshape(t, lh, lw)
    pad_h, pad_w = (-lh) % vws, (-lw) % vws
    nh, nw = (lh + pad_h) // vws, (lw + pad_w) // vws
    padded = np.full((t, lh + pad_h, lw + pad_w), -100, dtype=np.int64)
    padded[:, :lh, :lw] = index
    padded = padded.reshape(t, nh, vws, nw, vws).transpose(0, 1, 3, 2, 4).reshape(t, nh * nw, vws, vws)
    seqlens = (padded != -100).sum(axis=(2, 3)).reshape(-1)  # merge units a window
    flat = padded.reshape(-1)
    unit_perm = flat[flat != -100]
    token_perm = (unit_perm[:, None] * unit + np.arange(unit)).reshape(-1)
    seg = np.repeat(np.arange(len(seqlens)), seqlens * unit)  # empty windows add none
    return token_perm.astype(np.int64), seg.astype(np.int64), unit_perm.astype(np.int64)


def _rotate_half(x):
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([-x2, x1], dim=-1)


class _VisionRMSNorm(nn.Module):
    """RMS norm with fp32 statistics, returned in the input dtype (flax
    param ``scale``, here ``weight``)."""

    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))

    def forward(self, x):
        x32 = x.float()
        normed = x32 * torch.rsqrt((x32 * x32).mean(dim=-1, keepdim=True) + self.eps)
        return (self.weight * normed).to(x.dtype)


def _norm(cfg: QwenVisionConfig, dim: int) -> nn.Module:
    return _VisionRMSNorm(dim) if cfg.variant == "qwen2_5" else LayerNorm(dim, eps=1e-6)


class QwenVisionBlock(nn.Module):
    def __init__(self, cfg: QwenVisionConfig, dtype=torch.bfloat16):
        super().__init__()
        e, hdim = cfg.embed_dim, cfg.mlp_hidden
        self.cfg = cfg
        self.dtype = dtype
        self.ln1 = _norm(cfg, e)
        self.qkv = Linear(e, 3 * e, dtype=dtype)  # fused, split (s, 3, h, dh)
        self.proj = Linear(e, e, dtype=dtype)
        self.ln2 = _norm(cfg, e)
        if cfg.variant == "qwen2_5":  # SwiGLU with biases (HF Qwen2_5_VLMLP)
            self.gate = Linear(e, hdim, dtype=dtype)
            self.up = Linear(e, hdim, dtype=dtype)
            self.down = Linear(hdim, e, dtype=dtype)
        else:
            self.fc1 = Linear(e, hdim, dtype=dtype)
            self.fc2 = Linear(hdim, e, dtype=dtype)

    def forward(self, x, cos, sin, block_mask):
        """x: [B, S, E]; cos / sin: [S, head_dim] fp32; block_mask: [S, S]
        bool (the frame or window blocks)."""
        cfg = self.cfg
        b, s, _ = x.shape
        h, dh = cfg.num_heads, cfg.head_dim
        qkv = self.qkv(self.ln1(x)).reshape(b, s, 3, h, dh)
        q, k, v = qkv.unbind(dim=2)
        cos_, sin_ = cos[None, :, None, :], sin[None, :, None, :]
        qf, kf = q.float(), k.float()
        q = (qf * cos_ + _rotate_half(qf) * sin_).to(self.dtype)
        k = (kf * cos_ + _rotate_half(kf) * sin_).to(self.dtype)
        attn = chunked_attention(q, k, v, self.dtype, mask=block_mask, scale_q=True)
        x = x + self.proj(attn.reshape(b, s, h * dh))
        y = self.ln2(x)
        if cfg.variant == "qwen2_5":
            return x + self.down(F.silu(self.gate(y)) * self.up(y))
        y = self.fc1(y)
        y = F.gelu(y, approximate="tanh") if cfg.variant == "qwen3" else quick_gelu(y)
        return x + self.fc2(y)


class QwenVisionTower(nn.Module):
    """[B, S, patch_dim] pixel patches -> [B, S / merge², hidden_size],
    merged tokens t-major, row-major; ``qwen3`` returns (that, its
    deepstack levels ``[L_ds, B, S / merge², hidden_size]``)."""

    def __init__(self, cfg: QwenVisionConfig, dtype=torch.bfloat16):
        super().__init__()
        if cfg.variant not in ("qwen2", "qwen2_5", "qwen3"):
            raise ValueError(f"unknown Qwen vision variant {cfg.variant!r}")
        self.cfg = cfg
        self.dtype = dtype
        qwen3 = cfg.variant == "qwen3"
        merged = cfg.spatial_merge_size**2 * cfg.embed_dim
        self.patch_embed = Linear(cfg.patch_dim, cfg.embed_dim, bias=qwen3, dtype=dtype)
        if qwen3:
            self.pos_embed = nn.Parameter(torch.zeros(cfg.pos_embed_side**2, cfg.embed_dim))
        self.blocks = nn.ModuleList(QwenVisionBlock(cfg, dtype) for _ in range(cfg.depth))
        # deepstack mergers, named as the flax ones: ds{level}_norm / _fc1 / _fc2
        for level in range(len(cfg.deepstack_indexes) if qwen3 else 0):
            setattr(self, f"ds{level}_norm", LayerNorm(merged, eps=1e-6))
            setattr(self, f"ds{level}_fc1", Linear(merged, merged, dtype=dtype))
            setattr(self, f"ds{level}_fc2", Linear(merged, cfg.hidden_size, dtype=dtype))
        self.ln_q = _norm(cfg, cfg.embed_dim)
        self.merger_fc1 = Linear(merged, merged, dtype=dtype)
        self.merger_fc2 = Linear(merged, cfg.hidden_size, dtype=dtype)

    @torch.no_grad()
    def init_weights(self, gen: torch.Generator) -> None:
        """flax's init: xavier-uniform dense kernels, zero biases, a
        normal(0.02) pos-embed table (norms keep their unit scale and zero
        bias from construction)."""
        for m in self.modules():
            if isinstance(m, Linear):
                m.init_weights(gen)
        if self.cfg.variant == "qwen3":
            self.pos_embed.normal_(0.0, 0.02, generator=gen)

    def forward(self, patches, grid: tuple[int, int, int]):
        cfg = self.cfg
        b, s, _ = patches.shape
        if s != grid[0] * grid[1] * grid[2]:
            raise ValueError(f"{s} patches do not fill the grid {grid}")
        dev = patches.device
        x = self.patch_embed(patches)
        if cfg.variant == "qwen3":
            # the learned table on one temporal slice, repeated over t
            interp = torch.as_tensor(pos_embed_interp_matrix(cfg, grid), device=dev)
            x = (x.float() + (interp @ self.pos_embed).repeat(grid[0], 1)).to(self.dtype)
        angles = rotary_tables(cfg, grid)
        frame = torch.arange(s, device=dev) // (grid[1] * grid[2])
        full_mask = frame[:, None] == frame[None, :]
        windowed_mask = inverse_unit_perm = None
        if cfg.variant == "qwen2_5":
            token_perm, seg, unit_perm = window_partition(cfg, grid)
            x = x[:, torch.as_tensor(token_perm, device=dev)]
            angles = angles[token_perm]
            seg_t = torch.as_tensor(seg, device=dev)
            windowed_mask = seg_t[:, None] == seg_t[None, :]
            inverse_unit_perm = torch.as_tensor(np.argsort(unit_perm), device=dev)
        angles_t = torch.as_tensor(angles, device=dev)
        cos, sin = torch.cos(angles_t), torch.sin(angles_t)
        msz2 = cfg.spatial_merge_size**2
        deepstack = []
        for i, block in enumerate(self.blocks):
            windowed = cfg.variant == "qwen2_5" and i not in cfg.fullatt_block_indexes
            x = block(x, cos, sin, windowed_mask if windowed else full_mask)
            if cfg.variant == "qwen3" and i in cfg.deepstack_indexes:
                # group each merge window first, then norm it (postshuffle)
                level = cfg.deepstack_indexes.index(i)
                d = getattr(self, f"ds{level}_norm")(x.reshape(b, s // msz2, msz2 * cfg.embed_dim))
                d = F.gelu(getattr(self, f"ds{level}_fc1")(d))  # exact GELU
                deepstack.append(getattr(self, f"ds{level}_fc2")(d))
        x = self.ln_q(x).reshape(b, s // msz2, msz2 * cfg.embed_dim)
        x = self.merger_fc2(F.gelu(self.merger_fc1(x)))  # exact GELU
        if inverse_unit_perm is not None:
            # undo the window permutation: merged tokens t-major, row-major
            x = x[:, inverse_unit_perm]
        if cfg.variant == "qwen3":
            return x, torch.stack(deepstack) if deepstack else x.new_zeros((0, *x.shape))
        return x


def frames_to_patches(frames_u8, cfg: QwenVisionConfig):
    """uint8 [B, N, H, W, 3] -> ([B, S, patch_dim] fp32, grid), in the HF
    processor's order: CLIP mean / std at image_size, the last frame
    repeated to a multiple of temporal_patch_size, then the (t, tps, C,
    h/m, m, ps, w/m, m, ps) -> (t, h/m, w/m, m, m, C, tps, ps, ps)
    transpose that makes each merge window's patches contiguous."""
    b, n = frames_u8.shape[:2]
    tps, ps, msz = cfg.temporal_patch_size, cfg.patch_size, cfg.spatial_merge_size
    x = preprocess_frames(frames_u8, image_size=cfg.image_size, mode="clip")
    if n % tps:
        pad = tps - n % tps
        x = torch.cat([x, x[:, -1:].expand(b, pad, *x.shape[2:])], dim=1)
        n += pad
    t, gh, gw = cfg.grid(n)
    x = x.permute(0, 1, 4, 2, 3)  # [B, N, C, H, W]
    x = x.reshape(b, t, tps, cfg.in_channels, gh // msz, msz, ps, gw // msz, msz, ps)
    x = x.permute(0, 1, 4, 7, 5, 8, 3, 2, 6, 9)
    return x.reshape(b, t * gh * gw, cfg.patch_dim), (t, gh, gw)
