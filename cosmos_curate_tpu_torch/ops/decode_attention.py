"""Single-token GQA decode attention over a contiguous KV cache.

Port of ``cosmos_curate_tpu/ops/decode_attention.py``: one new token per
row attends to its slot cache ``[B, S, Hkv, D]``; queries stay grouped
``[B, Hkv, G, D]`` so each K/V byte serves all G heads of its group, and
keys at or past ``kv_len`` are never read.

On a CUDA tensor :func:`decode_attention` launches the hand-written kernel
``csrc/decode_attention.cu`` (``cct_decode``; bf16 only). On a CPU tensor it
runs :func:`decode_attention_plain`.
"""

from __future__ import annotations

import ctypes

import torch

from cosmos_curate_tpu_torch.ops._build import CudaKernel, KernelInputError
from cosmos_curate_tpu_torch.ops.paged_attention import MAX_DECODE_GROUP
from cosmos_curate_tpu_torch.ops.prefill_attention import check_kernel_inputs

_NEG_INF = -1e30

_P = ctypes.c_void_p
_I = ctypes.c_int
DECODE_KERNEL = CudaKernel(
    "decode_attention",
    "cct_decode",
    [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, ctypes.c_float, _P],
)


def decode_attention_plain(q, k_cache, v_cache, kv_len, *, sm_scale):
    """Plain PyTorch version with the TPU kernel's precision sequence: fp32
    ``q * sm_scale`` and logits, keys at or past ``kv_len`` masked out of an
    fp32 softmax (a row with no key gives zeros), fp32 P V divided by
    ``max(l, 1e-30)``, output in q's dtype."""
    s = k_cache.shape[1]
    logits = torch.einsum("bkgd,bskd->bkgs", q.float() * sm_scale, k_cache.float())
    seen = torch.arange(s, device=q.device)[None, None, None, :] < kv_len[:, None, None, None]
    logits = torch.where(seen, logits, torch.full_like(logits, _NEG_INF))
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.where(seen, torch.exp(logits - m), torch.zeros_like(logits))
    l = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bkgs,bskd->bkgd", p, v_cache.float()) / torch.clamp(l, min=1e-30)
    return out.to(q.dtype)


def decode_attention(q, k_cache, v_cache, kv_len, *, sm_scale=None):
    """q: ``[B, Hkv, G, D]`` (one unscaled token per row, grouped heads);
    k_cache/v_cache: ``[B, S, Hkv, D]`` with the token's K/V already
    written; kv_len: ``[B]`` valid lengths. Returns ``[B, Hkv, G, D]``.

    CPU tensors run the plain version; CUDA tensors launch the kernel."""
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        return decode_attention_plain(q, k_cache, v_cache, kv_len, sm_scale=sm_scale)
    b, hk, g, d = q.shape
    if k_cache.shape != v_cache.shape or k_cache.dim() != 4 or k_cache.shape[0] != b or k_cache.shape[2] != hk:
        raise KernelInputError(f"decode_attention: cache {tuple(k_cache.shape)} vs q {tuple(q.shape)}")
    if kv_len.shape != (b,):
        raise KernelInputError("decode_attention: kv_len must be [B]")
    check_kernel_inputs(
        "decode_attention",
        q,
        (("k_cache", k_cache), ("v_cache", v_cache)),
        (("kv_len", kv_len),),
        max_g=MAX_DECODE_GROUP,
    )
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        DECODE_KERNEL.launch(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), kv_len.data_ptr(), out.data_ptr(),
            b, hk, g, d, k_cache.shape[1], float(sm_scale),
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    return out
