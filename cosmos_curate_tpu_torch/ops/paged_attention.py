"""Paged GQA attention that reads the KV block pool through the block table.

Port of ``cosmos_curate_tpu/ops/paged_attention.py`` (vLLM's PagedAttention,
Kwon et al., SOSP 2023): table entry ``j`` of a row covers logical positions
``[j*bs, (j+1)*bs)`` wherever the block lives in the pool, so masking is the
contiguous kernels' and fragmented tables cost nothing extra. Decode (T=1)
and chunked prefill (T>1) share the op.

On CUDA tensors :func:`paged_attention` launches the hand-written kernels of
``csrc/paged_attention.cu`` (bf16 only), which read pool pages in place:
``cct_paged_decode`` for T=1, split-KV over :func:`decode_split_count` CTAs
per (row, kv head) and merged in the same launch, and ``cct_paged_prefill``
for T>1 on the tensor-core body. On CPU tensors it runs
:func:`paged_attention_plain`, the mirror of the reference's
``_paged_reference``: it gathers the rows' blocks and replays the contiguous
attention lines, so CPU outputs are bit-equal to the engine's gather
programs. :func:`paged_decode_split_plain` mirrors the decode kernel's split
and merge at its precision, for tests and ``chip_smoke.py``, through
:func:`decode_split_plain`, the mirror of the split body on contiguous rows
that contiguous decode (``ops/decode_attention.py``) shares.
"""

from __future__ import annotations

import ctypes
import functools
import math
import threading

import torch

from cosmos_curate_tpu_torch.ops._build import CudaKernel, KernelInputError
from cosmos_curate_tpu_torch.ops.prefill_attention import (
    MAX_PREFILL_ROWS,
    check_kernel_inputs,
    chunk_attention_plain,
)

# grouped heads one decode CTA holds
MAX_DECODE_GROUP = 16
# split-KV decode: CTAs aimed at per SM, and the fewest keys a split covers;
# they pick the fastest split count of scripts/tc_attention_ab.py's sweep at
# both caption lanes (PERF.md)
SPLIT_WAVES = 2
SPLIT_MIN_KEYS = 64

_P = ctypes.c_void_p
_I = ctypes.c_int
PAGED_DECODE_KERNEL = CudaKernel(
    "paged_attention",
    "cct_paged_decode",
    [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, ctypes.c_float, _P],
)
PAGED_PREFILL_KERNEL = CudaKernel(
    "paged_attention",
    "cct_paged_prefill",
    [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, ctypes.c_float, _P],
)
_NEG_INF = -1e30
# (device index, stream) -> int32 zeros the decode kernel's last split
# resets; calls on one stream run in order, so they may share them. Host
# threads (two pipeline stages, the engine's prep thread) read and fill the
# dict under the lock.
_split_counters: dict[tuple[int, int], torch.Tensor] = {}
_split_counters_lock = threading.Lock()


def decode_split_count(width: int, rows: int, sm_count: int) -> int:
    """Key ranges (CTAs) per (batch row, kv head) for a decode over a table
    ``width`` keys wide, ``rows`` = B * Hkv: about ``SPLIT_WAVES`` CTAs per
    SM, each covering at least ``SPLIT_MIN_KEYS`` keys of the table, at
    least one. Host integers only: the visible lengths are never read, so
    no device sync."""
    return max(1, min(SPLIT_WAVES * sm_count // max(1, rows), math.ceil(width / SPLIT_MIN_KEYS)))


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def split_counters(device: torch.device, n: int) -> torch.Tensor:
    """The int32 counters of the decode kernel's merge on ``device``'s
    current stream, at least ``n``: allocated zero once per (device,
    stream), again only when a call needs more; the kernel leaves them
    zero. The caller holds the returned tensor until its launch is
    enqueued: another thread may replace the dict's entry meanwhile, and a
    buffer that nothing references can go back to the allocator."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    key = (index, torch.cuda.current_stream(index).cuda_stream)
    with _split_counters_lock:
        buf = _split_counters.get(key)
        if buf is None or buf.numel() < n:
            buf = torch.zeros(max(n, 1 << 16), dtype=torch.int32, device=device)
            _split_counters[key] = buf
        return buf


def paged_attention_plain(q, pool_k, pool_v, tables, write_index, kv_len, *, layer_index, sm_scale):
    """Plain PyTorch version: gather each row's blocks of layer
    ``layer_index`` into a contiguous view, then the reference attention."""
    b, t, hk, g, d = q.shape
    s = tables.shape[1] * pool_k.shape[2]
    tables = tables.long()
    new_k = pool_k[layer_index][tables].reshape(b, s, hk, d)
    new_v = pool_v[layer_index][tables].reshape(b, s, hk, d)
    return chunk_attention_plain(q, new_k, new_v, write_index, kv_len, sm_scale)


def decode_split_plain(q, k, v, kv_len, *, sm_scale, n_split):
    """Plain PyTorch mirror of the split decode body (``cct_decode`` and
    ``cct_paged_decode``) over contiguous rows: the ``S`` keys cut into
    ``n_split`` ranges of ceil(S / n_split), each range's fp32 softmax
    state (m, l, acc) over its keys below kv_len (an empty range: m =
    -1e30, l = 0), merged in log-sum-exp form; q * sm_scale, scores, P and
    P V in fp32, ``acc / max(l, 1e-30)``. q: [B, Hkv, G, D]; k/v: [B, S,
    Hkv, D]. For tests and ``chip_smoke.py``: no wrapper calls it."""
    b, hk, g, d = q.shape
    width = k.shape[1]
    k, v = k.float(), v.float()
    scores = torch.einsum("bkgd,bskd->bkgs", q.float() * sm_scale, k)
    seen = torch.arange(width, device=q.device)[None, :] < kv_len[:, None]  # [B, S]
    per = -(-width // n_split)
    neg = torch.full((), _NEG_INF, device=q.device)
    ms, ls, accs = [], [], []
    for i in range(n_split):
        lo, hi = i * per, min((i + 1) * per, width)
        s = scores[..., lo:hi]
        vis = seen[:, None, None, lo:hi]
        m = torch.where(vis, s, neg).amax(dim=-1) if hi > lo else neg.expand(b, hk, g)
        p = torch.where(vis, torch.exp(s - m[..., None]), torch.zeros_like(s))
        ms.append(m)
        ls.append(p.sum(dim=-1))
        accs.append(torch.einsum("bkgs,bskd->bkgd", p, v[:, lo:hi]))
    m_all = torch.stack(ms)  # [n_split, B, Hkv, G]
    big = m_all.amax(dim=0)
    w = torch.where(torch.stack(ls) > 0, torch.exp(m_all - big), torch.zeros_like(m_all))
    l_sum = (w * torch.stack(ls)).sum(dim=0)
    acc = (w[..., None] * torch.stack(accs)).sum(dim=0)
    return (acc / torch.clamp(l_sum, min=1e-30)[..., None]).to(q.dtype)


def paged_decode_split_plain(q, pool_k, pool_v, tables, kv_len, *, layer_index, sm_scale, n_split):
    """Plain PyTorch mirror of ``cct_paged_decode``: the table's rows of
    layer ``layer_index`` gathered, then :func:`decode_split_plain` over
    the table's width. q: [B, 1, Hkv, G, D]."""
    b, _, hk, g, d = q.shape
    width = tables.shape[1] * pool_k.shape[2]
    tables = tables.long()
    k = pool_k[layer_index][tables].reshape(b, width, hk, d)
    v = pool_v[layer_index][tables].reshape(b, width, hk, d)
    return decode_split_plain(q[:, 0], k, v, kv_len, sm_scale=sm_scale, n_split=n_split)[:, None]


def split_workspace(device: torch.device, rows: int, g: int, d: int, width: int):
    """The split count of a decode over ``width`` keys for ``rows`` = B *
    Hkv (row, kv head) pairs on ``device`` (the current CUDA device), and
    the split kernel's workspace: fp32 partials [rows, n_split, G] x (m, l)
    then x D, allocated with ``torch.empty`` per call, and the stream's
    merge counters (``split_counters``). Returns ``(n_split, (part_ml,
    part_acc, counters) pointers, (partials, counters) tensors)``; with one
    split the pointers are None. Keep the tensors referenced until the
    launch is enqueued: the pointers alone keep neither alive."""
    n_split = decode_split_count(width, rows, _sm_count(torch.cuda.current_device()))
    if n_split == 1:
        return n_split, (None, None, None), None
    n_ml = rows * n_split * g * 2
    partials = torch.empty(n_ml + n_ml // 2 * d, dtype=torch.float32, device=device)
    counters = split_counters(device, rows)
    ml_ptr = partials.data_ptr()
    return n_split, (ml_ptr, ml_ptr + 4 * n_ml, counters.data_ptr()), (partials, counters)


def paged_attention(
    q, pool_k, pool_v, tables, write_index, kv_len, *, layer_index: int = 0, sm_scale=None
):
    """Attention straight out of the paged KV pool.

    q: ``[B, T, Hkv, G, D]`` unscaled grouped queries; pool_k/pool_v: the
    full pools ``[L, NB, bs, Hkv, D]`` with the chunk's K/V already written
    through the table; tables: ``[B, nbl]`` logical-to-physical block ids;
    write_index/kv_len: ``[B]``. Returns ``[B, T, Hkv, G, D]``.

    CPU tensors run the plain version; CUDA tensors launch the kernel on
    the current stream. A split decode's merge counters are shared by the
    calls on one stream, which run in order; each stream has its own."""
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
        if t == 1:
            n_split, workspace, _held = split_workspace(q.device, b * hk, g, d, nbl * bs)
            PAGED_DECODE_KERNEL.launch(
                q.data_ptr(), k_ptr, v_ptr, tables.data_ptr(), kv_len.data_ptr(), out.data_ptr(),
                *workspace, b, hk, g, d, nbl, bs, n_split, float(sm_scale), stream,
            )
        else:
            PAGED_PREFILL_KERNEL.launch(
                q.data_ptr(), k_ptr, v_ptr, tables.data_ptr(), write_index.data_ptr(), kv_len.data_ptr(),
                out.data_ptr(), b, t, hk, g, d, nbl, bs, nb, float(sm_scale), stream,
            )
    return out
