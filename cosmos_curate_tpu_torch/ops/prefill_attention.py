"""Chunked-prefill GQA attention over a contiguous KV cache.

Port of ``cosmos_curate_tpu/ops/prefill_attention.py``. A chunk of T new
tokens (their K/V already written at ``write_index``) attends to the cache:
query t sits at absolute position ``write_index + t``, sees keys at or
before it and below ``kv_len``. The same function serves the first chunk
(``write_index = 0``) and later chunks of a chunked prefill.

On a CUDA tensor :func:`prefill_attention` launches the hand-written
tensor-core kernel ``csrc/prefill_attention.cu`` (bf16 only). On a CPU
tensor it runs :func:`chunk_attention_plain`, which replays the reference
model's attention lines (``DecoderLayer``'s XLA path) op for op.
"""

from __future__ import annotations

import ctypes

import torch

from cosmos_curate_tpu_torch.ops._build import CudaKernel, KernelInputError

_NEG_INF = -1e30
# head dims the CUDA kernels are instantiated for
SUPPORTED_HEAD_DIMS = (16, 64, 128)
# grouped heads the prefill wrappers take (contiguous and paged); a CTA holds
# 64 query rows, and more than 64 groups split over CTAs
MAX_PREFILL_ROWS = 128

_P = ctypes.c_void_p
_I = ctypes.c_int
PREFILL_KERNEL = CudaKernel(
    "prefill_attention",
    "cct_prefill",
    [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, ctypes.c_float, _P],
)


def chunk_attention_plain(q, k, v, write_index, kv_len, sm_scale):
    """Plain PyTorch version. q: [B, T, Hkv, G, D] unscaled; k/v: [B, S, Hkv, D];
    write_index/kv_len: [B]. Returns [B, T, Hkv, G, D].

    Precision sequence of the reference: ``q * sm_scale`` in the working
    dtype, fp32 logits, a -1e30 mask, fp32 softmax, probabilities cast back
    to the query dtype before the value product."""
    b, t, hk, g, d = q.shape
    s = k.shape[1]
    qg = q * sm_scale
    logits = torch.einsum("btkgd,bskd->bkgts", qg.float(), k.float())
    k_pos = torch.arange(s, device=q.device)[None, None, None, None, :]
    q_seq = write_index[:, None] + torch.arange(t, device=q.device)[None, :]
    causal = k_pos <= q_seq[:, None, None, :, None]
    written = k_pos < kv_len[:, None, None, None, None]
    logits = torch.where(causal & written, logits, torch.full_like(logits, _NEG_INF))
    probs = torch.softmax(logits, dim=-1)
    dt = torch.promote_types(q.dtype, v.dtype)
    return torch.einsum("bkgts,bskd->btkgd", probs.to(q.dtype).to(dt), v.to(dt))


def check_kernel_inputs(name: str, q, kv, ints, *, max_g: int) -> None:
    """Raise unless the tensors are what the CUDA kernels take: bf16 q and
    K/V, int32 index tensors, all contiguous on q's device, 16-byte aligned
    K/V, a supported head dim and at most ``max_g`` grouped heads."""
    dev = q.device
    if dev.type != "cuda":
        raise KernelInputError(f"{name}: the CUDA kernel needs CUDA tensors, got {dev}")
    d, g = q.shape[-1], q.shape[-2]
    if d not in SUPPORTED_HEAD_DIMS:
        raise KernelInputError(f"{name}: head dim {d} not in {SUPPORTED_HEAD_DIMS}")
    if not 1 <= g <= max_g:
        raise KernelInputError(f"{name}: {g} grouped heads, the kernel takes 1..{max_g}")
    for label, x in (("q", q), *kv):
        if x.dtype != torch.bfloat16:
            raise KernelInputError(f"{name}: {label} must be bfloat16, got {x.dtype}")
        if x.device != dev or not x.is_contiguous():
            raise KernelInputError(f"{name}: {label} must be contiguous on {dev}")
        if x.shape[-1] != d:
            raise KernelInputError(f"{name}: {label} head dim {x.shape[-1]} != {d}")
    for label, x in kv:
        if x.data_ptr() % 16:
            raise KernelInputError(f"{name}: {label} must be 16-byte aligned")
    for label, x in ints:
        if x.dtype != torch.int32 or x.device != dev or not x.is_contiguous():
            raise KernelInputError(f"{name}: {label} must be contiguous int32 on {dev}")


def prefill_attention(q, k_cache, v_cache, write_index, kv_len, *, sm_scale=None):
    """q: [B, T, Hkv, G, D] (a prefill chunk, GQA-grouped, unscaled);
    k_cache/v_cache: [B, S, Hkv, D] with the chunk's K/V already written at
    ``write_index``; write_index/kv_len: [B]. Returns [B, T, Hkv, G, D].

    CPU tensors run the plain version; CUDA tensors launch the kernel."""
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        return chunk_attention_plain(q, k_cache, v_cache, write_index, kv_len, sm_scale)
    b, t, hk, g, d = q.shape
    if k_cache.shape != v_cache.shape or k_cache.shape[0] != b or k_cache.shape[2] != hk:
        raise KernelInputError(f"prefill_attention: cache {tuple(k_cache.shape)} vs q {tuple(q.shape)}")
    if write_index.shape != (b,) or kv_len.shape != (b,):
        raise KernelInputError("prefill_attention: write_index/kv_len must be [B]")
    check_kernel_inputs(
        "prefill_attention",
        q,
        (("k_cache", k_cache), ("v_cache", v_cache)),
        (("write_index", write_index), ("kv_len", kv_len)),
        max_g=MAX_PREFILL_ROWS,
    )
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        PREFILL_KERNEL.launch(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            write_index.data_ptr(), kv_len.data_ptr(), out.data_ptr(),
            b, t, hk, g, d, k_cache.shape[1], float(sm_scale),
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    return out
