"""Analytic FLOPs accounting for MFU reporting (port of
``cosmos_curate_tpu/models/flops.py``).

Every model family has an analytic forward-FLOPs formula, and
``mfu(flops, seconds)`` divides the achieved rate by the card's dense bf16
peak. The formulas count matmul FLOPs only (2·M·N·K per GEMM), as the
reference's do: elementwise and normalization work is bound by bytes, not
FLOPs, and is left out, as MFU conventions leave it. The formulas are the
reference's, unchanged; the peak table is NVIDIA's.
"""

from __future__ import annotations

import os


def transformer_layer_flops(tokens: int, width: int, *, mlp_ratio: int = 4) -> float:
    """One pre-LN transformer block forward: QKVO projections + attention
    score/value matmuls + 2-layer MLP."""
    proj = 8.0 * tokens * width * width  # 4 projections, 2·T·W·W each
    attn = 4.0 * tokens * tokens * width  # QK^T and attn·V
    mlp = 2.0 * 2.0 * tokens * width * (mlp_ratio * width)
    return proj + attn + mlp


def vit_forward_flops(cfg) -> float:
    """One image through models/vit.ViT (patch conv + blocks + projection)."""
    n = cfg.num_patches + 1  # + cls token
    patch = 2.0 * cfg.num_patches * (cfg.patch_size * cfg.patch_size * 3) * cfg.width
    blocks = cfg.layers * transformer_layer_flops(n, cfg.width)
    proj = 2.0 * cfg.width * cfg.projection_dim
    return patch + blocks + proj


def video_embed_forward_flops(cfg) -> float:
    """One clip through models/embedder.VideoEmbedModel."""
    frames = cfg.num_frames * vit_forward_flops(cfg.vit)
    t = cfg.num_frames + 1  # + query token
    d = cfg.vit.projection_dim
    temporal = cfg.temporal_layers * transformer_layer_flops(t, d)
    out = 2.0 * d * cfg.output_dim
    return frames + temporal + out


def vlm_decode_flops_per_token(cfg) -> float:
    """One decode step for one sequence through models/vlm's LM stack
    (GQA + SwiGLU + tied head). Decode attention reads the whole KV cache:
    score/value matmuls scale with max_seq (upper estimate)."""
    d = cfg.dim
    q_inner = cfg.n_heads * cfg.head_dim
    kv_inner = cfg.n_kv_heads * cfg.head_dim
    proj = 2.0 * d * q_inner + 2.0 * 2.0 * d * kv_inner + 2.0 * q_inner * d
    attn = 2.0 * 2.0 * cfg.max_seq * q_inner
    ff = int(d * cfg.hidden_mult)
    mlp = 3.0 * 2.0 * d * ff  # gate + up + down
    head = 2.0 * d * cfg.vocab
    return cfg.n_layers * (proj + attn + mlp) + head


# dense (no sparsity) bf16 tensor-core peak FLOP/s per card, from NVIDIA's
# data sheets; matched against torch.cuda.get_device_name() in this order
# (the first name the device's name holds wins, so the longer names first)
_GPU_PEAK = (
    ("h100 nvl", 835.5e12),
    ("h100 pcie", 756.0e12),
    ("h100", 989.4e12),  # SXM5 (the "H100 80GB HBM3" board)
    ("h200", 989.4e12),
    ("gh200", 989.4e12),
    ("a100", 312.0e12),
    ("l40s", 362.05e12),
)
# a card the table does not name: the H100 SXM's, the card the port targets
DEFAULT_PEAK = 989.4e12


def peak_for(device_name: str) -> float:
    """The table's peak for a card named ``device_name``, else ``DEFAULT_PEAK``."""
    name = device_name.lower()
    for key, peak in _GPU_PEAK:
        if key in name:
            return peak
    return DEFAULT_PEAK


def chip_peak_flops() -> float:
    """The attached card's peak: ``BENCH_PEAK_FLOPS`` when set, else the
    table's entry for ``torch.cuda.get_device_name()``, else
    ``DEFAULT_PEAK`` (also without a card)."""
    env = os.environ.get("BENCH_PEAK_FLOPS")
    if env:
        return float(env)
    import torch

    if not torch.cuda.is_available():
        return DEFAULT_PEAK
    return peak_for(torch.cuda.get_device_name())


def mfu(total_flops: float, seconds: float, *, peak: float | None = None) -> float:
    """Model FLOPs utilization: achieved FLOPs/s over the card's peak."""
    if seconds <= 0:
        return 0.0
    return (total_flops / seconds) / (peak or chip_peak_flops())
