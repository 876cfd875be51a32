"""Flash self-attention over ``[B, H, S, D]``.

Port of ``cosmos_curate_tpu/ops/flash_attention.py``: full self-attention
with an online softmax, keys past the sequence masked, and an optional
causal mask whose key tiles above the diagonal are never loaded.

On a CUDA tensor :func:`flash_attention` launches the hand-written kernel
``csrc/flash_attention.cu`` (bf16; the head dims in ``FLASH_HEAD_DIMS``;
tensor cores, with P rounded to bf16 for the value product). It reads
q / k / v through their strides, so a ``[B, S, H, D]`` projection
transposed to ``[B, H, S, D]`` is not copied, and the output takes q's
layout. On a CPU tensor it runs :func:`flash_attention_plain`.
"""

from __future__ import annotations

import ctypes

import torch

from cosmos_curate_tpu_torch.ops._build import CudaKernel, KernelInputError

_NEG_INF = -1e30
# head dims the CUDA kernel is instantiated for: the tiny test configs, and
# ViT-B/16 and its pooler
FLASH_HEAD_DIMS = (16, 64)

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
FLASH_KERNEL = CudaKernel(
    "flash_attention",
    "cct_flash",
    [_P, _P, _P, _P, _I, _I, _I, _I, _L, _L, _L, _L, _L, _L, _I, ctypes.c_float, _P],
)


def flash_attention_plain(q, k, v, *, causal: bool = False, sm_scale=None):
    """Plain PyTorch version: q/k/v ``[B, H, S, D]`` -> ``[B, H, S, D]`` in
    q's dtype, with the TPU kernel's precision: fp32 ``q * sm_scale`` and
    logits, a -1e30 mask, fp32 softmax and fp32 P V, divided by
    ``max(l, 1e-30)``."""
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    s = q.shape[2]
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float() * sm_scale, k.float())
    if causal:
        pos = torch.arange(s, device=q.device)
        logits = torch.where(pos[None, :] <= pos[:, None], logits, torch.full_like(logits, _NEG_INF))
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.exp(logits - m)
    l = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhqk,bhkd->bhqd", p, v.float()) / torch.clamp(l, min=1e-30)
    return out.to(q.dtype)


def flash_attention(q, k, v, *, causal: bool = False, sm_scale=None):
    """q/k/v: ``[B, H, S, D]`` (self-attention, equal lengths) -> ``[B, H,
    S, D]`` in q's layout and dtype.

    CPU tensors run the plain version; CUDA tensors launch the kernel."""
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, sm_scale=sm_scale)
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise KernelInputError(
            f"flash_attention: q/k/v must share one [B, H, S, D] shape, got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    b, h, s, d = q.shape
    if d not in FLASH_HEAD_DIMS:
        raise KernelInputError(f"flash_attention: head dim {d} not in {FLASH_HEAD_DIMS}")
    if q.device.type != "cuda":
        raise KernelInputError(f"flash_attention: the CUDA kernel needs CUDA tensors, got {q.device}")
    for label, x in (("q", q), ("k", k), ("v", v)):
        if x.dtype != torch.bfloat16:
            raise KernelInputError(f"flash_attention: {label} must be bfloat16, got {x.dtype}")
        if x.device != q.device:
            raise KernelInputError(f"flash_attention: {label} must be on {q.device}")
        if x.stride() != q.stride():
            raise KernelInputError(f"flash_attention: {label} strides {x.stride()} differ from q's {q.stride()}")
        if x.data_ptr() % 16:
            raise KernelInputError(f"flash_attention: {label} must be 16-byte aligned")
    if q.stride(3) != 1 or any(st % 8 for st in q.stride()[:3]):
        raise KernelInputError(
            f"flash_attention: strides {q.stride()} need a contiguous head dim and the others "
            "in multiples of 8 elements (16-byte loads)"
        )
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        FLASH_KERNEL.launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, h, s, d,
            *q.stride()[:3], *out.stride()[:3], int(causal), float(sm_scale),
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    return out
