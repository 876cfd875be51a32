"""Single-token GQA decode attention over a contiguous KV cache.

Port of ``cosmos_curate_tpu/ops/decode_attention.py``: one new token per
row attends to its slot cache ``[B, S, Hkv, D]``; queries stay grouped
``[B, Hkv, G, D]`` so each K/V byte serves all G heads of its group, and
keys at or past ``kv_len`` are never read.

On a CUDA tensor :func:`decode_attention` launches the hand-written kernel
``csrc/decode_attention.cu`` (``cct_decode``; bf16 only): split-KV over
``decode_split_count`` CTAs per (row, kv head), merged in the same launch,
on the body paged decode runs (``csrc/split_decode.cuh``), so on the same
K/V at the same width it gives paged decode's bits. On a CPU tensor it
runs :func:`decode_attention_plain`. ``paged_attention.decode_split_plain``
mirrors the kernel's split and merge, for tests and ``chip_smoke.py``.
"""

from __future__ import annotations

import ctypes

import torch

from cosmos_curate_tpu_torch.ops._build import CudaKernel, KernelInputError
from cosmos_curate_tpu_torch.ops.paged_attention import MAX_DECODE_GROUP, split_workspace
from cosmos_curate_tpu_torch.ops.prefill_attention import check_kernel_inputs

_NEG_INF = -1e30

_P = ctypes.c_void_p
_I = ctypes.c_int
DECODE_KERNEL = CudaKernel(
    "decode_attention",
    "cct_decode",
    [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, ctypes.c_float, _P],
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

    CPU tensors run the plain version; CUDA tensors launch the kernel on
    the current stream, sharing the stream's split merge counters with
    paged decode (calls on one stream run in order)."""
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
    s = k_cache.shape[1]
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        n_split, workspace, _held = split_workspace(q.device, b * hk, g, d, s)
        DECODE_KERNEL.launch(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), kv_len.data_ptr(), out.data_ptr(),
            *workspace, b, hk, g, d, s, n_split, float(sm_scale),
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    return out
