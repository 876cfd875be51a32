"""Paged GQA attention that reads the KV block pool through the block table.

Port of ``cosmos_curate_tpu/ops/paged_attention.py`` (vLLM's PagedAttention,
Kwon et al., SOSP 2023): table entry ``j`` of a row covers logical positions
``[j*bs, (j+1)*bs)`` wherever the block lives in the pool, so masking is the
contiguous kernels' and fragmented tables cost nothing extra. Decode (T=1)
and chunked prefill (T>1) share the op.

On CUDA tensors :func:`paged_attention` launches the hand-written kernels of
``csrc/paged_attention.cu`` (``cct_paged_decode`` for T=1,
``cct_paged_prefill`` for T>1; bf16 only), which read pool pages in place.
On CPU tensors it runs :func:`paged_attention_plain`, the mirror of the
reference's ``_paged_reference``: it gathers the rows' blocks and replays the
contiguous attention lines, so CPU outputs are bit-equal to the engine's
gather programs.
"""

from __future__ import annotations

import ctypes

import torch

from cosmos_curate_tpu_torch.ops._build import CudaKernel, KernelInputError
from cosmos_curate_tpu_torch.ops.prefill_attention import (
    MAX_PREFILL_ROWS,
    check_kernel_inputs,
    chunk_attention_plain,
)

# grouped heads one decode CTA holds
MAX_DECODE_GROUP = 16

_P = ctypes.c_void_p
_I = ctypes.c_int
PAGED_DECODE_KERNEL = CudaKernel(
    "paged_attention",
    "cct_paged_decode",
    [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, ctypes.c_float, _P],
)
PAGED_PREFILL_KERNEL = CudaKernel(
    "paged_attention",
    "cct_paged_prefill",
    [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, ctypes.c_float, _P],
)


def paged_attention_plain(q, pool_k, pool_v, tables, write_index, kv_len, *, layer_index, sm_scale):
    """Plain PyTorch version: gather each row's blocks of layer
    ``layer_index`` into a contiguous view, then the reference attention."""
    b, t, hk, g, d = q.shape
    s = tables.shape[1] * pool_k.shape[2]
    tables = tables.long()
    new_k = pool_k[layer_index][tables].reshape(b, s, hk, d)
    new_v = pool_v[layer_index][tables].reshape(b, s, hk, d)
    return chunk_attention_plain(q, new_k, new_v, write_index, kv_len, sm_scale)


def paged_attention(
    q, pool_k, pool_v, tables, write_index, kv_len, *, layer_index: int = 0, sm_scale=None
):
    """Attention straight out of the paged KV pool.

    q: ``[B, T, Hkv, G, D]`` unscaled grouped queries; pool_k/pool_v: the
    full pools ``[L, NB, bs, Hkv, D]`` with the chunk's K/V already written
    through the table; tables: ``[B, nbl]`` logical-to-physical block ids;
    write_index/kv_len: ``[B]``. Returns ``[B, T, Hkv, G, D]``.

    CPU tensors run the plain version; CUDA tensors launch the kernel."""
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        return paged_attention_plain(
            q, pool_k, pool_v, tables, write_index, kv_len,
            layer_index=layer_index, sm_scale=sm_scale,
        )
    b, t, hk, g, d = q.shape
    n_layers, nb, bs = pool_k.shape[:3]
    if pool_v.shape != pool_k.shape or pool_k.shape[3] != hk:
        raise KernelInputError(f"paged_attention: pool {tuple(pool_k.shape)} vs q {tuple(q.shape)}")
    if not 0 <= layer_index < n_layers:
        raise KernelInputError(f"paged_attention: layer_index {layer_index} outside [0, {n_layers})")
    if tables.dim() != 2 or tables.shape[0] != b:
        raise KernelInputError("paged_attention: tables must be [B, nbl]")
    if write_index.shape != (b,) or kv_len.shape != (b,):
        raise KernelInputError("paged_attention: write_index/kv_len must be [B]")
    check_kernel_inputs(
        "paged_attention",
        q,
        (("pool_k", pool_k), ("pool_v", pool_v)),
        (("tables", tables), ("write_index", write_index), ("kv_len", kv_len)),
        max_g=MAX_DECODE_GROUP if t == 1 else MAX_PREFILL_ROWS,
    )
    out = torch.empty_like(q)
    layer_bytes = nb * bs * hk * d * pool_k.element_size()
    k_ptr = pool_k.data_ptr() + layer_index * layer_bytes
    v_ptr = pool_v.data_ptr() + layer_index * layer_bytes
    nbl = tables.shape[1]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        common = (q.data_ptr(), k_ptr, v_ptr, tables.data_ptr(), write_index.data_ptr(),
                  kv_len.data_ptr(), out.data_ptr(), b)
        if t == 1:
            PAGED_DECODE_KERNEL.launch(*common, hk, g, d, nbl, bs, float(sm_scale), stream)
        else:
            PAGED_PREFILL_KERNEL.launch(*common, t, hk, g, d, nbl, bs, float(sm_scale), stream)
    return out
