"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: they skip without a CUDA device (this file imports no JAX,
so it runs on a machine that has only PyTorch). Run on the GPU with
``python -m pytest -m cuda tests/test_torch_cuda_kernels.py``. Inputs are
bf16; the plain version computes in fp32 from the same inputs, and the bound
is 1e-2 max abs error (bf16 output rounding; the kernels round
unnormalised probabilities to bf16, or keep them in fp32, where the plain
versions round the normalised ones or keep them in fp32).
"""

import numpy as np
import pytest
import torch

from cosmos_curate_tpu_torch.ops import kernels
from cosmos_curate_tpu_torch.ops.decode_attention import decode_attention, decode_attention_plain
from cosmos_curate_tpu_torch.ops.flash_attention import flash_attention, flash_attention_plain
from cosmos_curate_tpu_torch.ops.paged_attention import paged_attention, paged_attention_plain
from cosmos_curate_tpu_torch.ops.prefill_attention import chunk_attention_plain, prefill_attention

BOUND = 1e-2


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _paged_case(seed, *, b, hk, g, d, nbl, bs, device):
    rng = np.random.default_rng(seed)
    n_blocks = b * nbl + 3
    pool_k = rng.standard_normal((2, n_blocks, bs, hk, d)).astype(np.float32)
    pool_v = rng.standard_normal((2, n_blocks, bs, hk, d)).astype(np.float32)
    tables = rng.permutation(np.arange(1, n_blocks))[: b * nbl].reshape(b, nbl).astype(np.int32)
    to = lambda x: torch.from_numpy(x).to(device, torch.bfloat16)  # noqa: E731
    return rng, to(pool_k), to(pool_v), torch.from_numpy(tables).to(device)


def _err(got, want) -> float:
    torch.cuda.synchronize()
    return (got.float() - want.float()).abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("d,g", [(16, 2), (64, 2), (128, 6)])
def test_paged_decode_kernel(dev, d, g):
    rng, pk, pv, tables = _paged_case(0, b=4, hk=2, g=g, d=d, nbl=6, bs=16, device=dev)
    q = torch.from_numpy(rng.standard_normal((4, 1, 2, g, d)).astype(np.float32)).to(dev, torch.bfloat16)
    kv_len = torch.tensor([1, 17, 50, 96], dtype=torch.int32, device=dev)
    tables[0] = 0  # an idle row: garbage block, kv_len 1
    n = kernels()["paged_decode"].launches
    got = paged_attention(q, pk, pv, tables, kv_len - 1, kv_len, layer_index=1)
    want = paged_attention_plain(
        q.float(), pk.float(), pv.float(), tables, kv_len - 1, kv_len, layer_index=1, sm_scale=d**-0.5
    )
    assert kernels()["paged_decode"].launches == n + 1
    assert torch.isfinite(got.float()).all()
    assert _err(got, want) <= BOUND


@pytest.mark.cuda
@pytest.mark.parametrize("t,d", [(37, 64), (256, 64), (20, 16)])
def test_paged_prefill_kernel_mid_context(dev, t, d):
    rng, pk, pv, tables = _paged_case(1, b=2, hk=2, g=2, d=d, nbl=20, bs=16, device=dev)
    q = torch.from_numpy(rng.standard_normal((2, t, 2, 2, d)).astype(np.float32)).to(dev, torch.bfloat16)
    write = torch.tensor([0, 40], dtype=torch.int32, device=dev)
    got = paged_attention(q, pk, pv, tables, write, write + t, layer_index=0)
    want = paged_attention_plain(
        q.float(), pk.float(), pv.float(), tables, write, write + t, layer_index=0, sm_scale=d**-0.5
    )
    assert _err(got, want) <= BOUND


def _prefill_check(dev, seed, *, t, s, hk, g, d, write, kv_len):
    rng = np.random.default_rng(seed)
    b = len(write)

    def mk(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev, torch.bfloat16)

    q, k, v = mk(b, t, hk, g, d), mk(b, s, hk, d), mk(b, s, hk, d)
    wi = torch.tensor(write, dtype=torch.int32, device=dev)
    kl = torch.tensor(kv_len, dtype=torch.int32, device=dev)
    n = kernels()["prefill"].launches
    got = prefill_attention(q, k, v, wi, kl)
    want = chunk_attention_plain(q.float(), k.float(), v.float(), wi, kl, d**-0.5)
    assert kernels()["prefill"].launches == n + 1
    assert torch.isfinite(got.float()).all()
    assert _err(got, want) <= BOUND


@pytest.mark.cuda
@pytest.mark.parametrize("t,s,kv", [(64, 64, 38), (1024, 1024, 686), (100, 300, 250)])
def test_contiguous_prefill_kernel(dev, t, s, kv):
    """G = 2 (the caption LM's grouping), the write at kv_len - T."""
    _prefill_check(dev, 2, t=t, s=s, hk=8, g=2, d=64, write=[kv - min(t, kv)], kv_len=[kv])


@pytest.mark.cuda
@pytest.mark.parametrize(
    "t,g,d,write,kv_len",
    [
        (50, 6, 128, [0], [50]),  # 10 tokens x 6 heads: 60 of a tile's 64 rows
        (33, 6, 128, [17], [40]),  # past kv_len at write 17: padded prefix rows
        (37, 2, 16, [0], [37]),  # T not a multiple of the 32-token tile
        (64, 96, 64, [5], [69]),  # G > 64: the groups split over two CTAs
    ],
)
def test_contiguous_prefill_kernel_tiles(dev, t, g, d, write, kv_len):
    _prefill_check(dev, 6, t=t, s=128, hk=2, g=g, d=d, write=write, kv_len=kv_len)


@pytest.mark.cuda
def test_contiguous_prefill_kernel_rows_differ(dev):
    """B = 3 with its own write / kv_len per row: a first chunk, a later
    chunk, and a chunk whose tail is padding past kv_len."""
    _prefill_check(dev, 7, t=70, s=256, hk=2, g=2, d=64, write=[0, 100, 30], kv_len=[70, 170, 61])


@pytest.mark.cuda
@pytest.mark.parametrize("d,g,s", [(64, 2, 1024), (16, 4, 100), (128, 6, 300)])
def test_contiguous_decode_kernel(dev, d, g, s):
    rng = np.random.default_rng(3)

    def mk(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev, torch.bfloat16)

    q, k, v = mk(4, 2, g, d), mk(4, s, 2, d), mk(4, s, 2, d)
    kv_len = torch.tensor([1, s // 3, s - 1, s], dtype=torch.int32, device=dev)
    n = kernels()["decode"].launches
    got = decode_attention(q, k, v, kv_len)
    want = decode_attention_plain(q.float(), k.float(), v.float(), kv_len, sm_scale=d**-0.5)
    assert kernels()["decode"].launches == n + 1
    assert torch.isfinite(got.float()).all()
    assert _err(got, want) <= BOUND


@pytest.mark.cuda
@pytest.mark.parametrize(
    "shape,causal",
    [
        ((8, 12, 197, 64), False),  # ViT-B/16 at 224^2: a ragged last key tile
        ((32, 8, 9, 64), False),  # the base pooler: one mostly-padded tile
        ((2, 3, 1, 64), False),
        ((2, 3, 63, 64), False),
        ((2, 3, 64, 64), False),
        ((2, 3, 65, 64), False),
        ((2, 3, 129, 16), False),  # one row past two 64-row query tiles
        ((2, 2, 64, 16), False),
        ((2, 3, 130, 16), True),
        ((1, 4, 300, 64), True),
        ((1, 2, 2305, 64), True),  # ViT-B/16 at 768^2
    ],
)
def test_flash_kernel(dev, shape, causal):
    rng = np.random.default_rng(4)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev, torch.bfloat16) for _ in range(3))
    n = kernels()["flash"].launches
    got = flash_attention(q, k, v, causal=causal)
    want = flash_attention_plain(q.float(), k.float(), v.float(), causal=causal)
    assert kernels()["flash"].launches == n + 1
    assert torch.isfinite(got.float()).all()
    assert _err(got, want) <= BOUND


@pytest.mark.cuda
def test_flash_kernel_reads_strided_views(dev):
    """layers.Attention hands [B, S, H, D] projections over as transposed
    views; the output takes q's layout."""
    rng = np.random.default_rng(5)
    q, k, v = (
        torch.from_numpy(rng.standard_normal((4, 197, 12, 64)).astype(np.float32)).to(dev, torch.bfloat16)
        for _ in range(3)
    )
    views = [x.transpose(1, 2) for x in (q, k, v)]
    n = kernels()["flash"].launches
    got = flash_attention(*views)
    assert kernels()["flash"].launches == n + 1
    assert got.stride() == views[0].stride()
    want = flash_attention_plain(*(x.float() for x in views))
    assert _err(got, want) <= BOUND


@pytest.mark.cuda
def test_wrappers_refuse_what_the_kernels_do_not_take(dev):
    q = torch.zeros(1, 1, 1, 2, 64, device=dev)  # fp32: not a kernel dtype
    pool = torch.zeros(1, 2, 16, 1, 64, device=dev, dtype=torch.bfloat16)
    tables = torch.ones(1, 1, dtype=torch.int32, device=dev)
    one = torch.ones(1, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="bfloat16"):
        paged_attention(q, pool, pool, tables, one - 1, one)
    with pytest.raises(ValueError, match="head dim"):
        paged_attention(torch.zeros(1, 1, 1, 2, 32, device=dev, dtype=torch.bfloat16),
                        pool[..., :32].contiguous(), pool[..., :32].contiguous(), tables, one - 1, one)
    with pytest.raises(ValueError, match="int32"):
        paged_attention(q.bfloat16(), pool, pool, tables.long(), one - 1, one)
    x = torch.zeros(1, 2, 9, 64, device=dev)
    with pytest.raises(ValueError, match="bfloat16"):
        flash_attention(x, x, x)
    padded = torch.zeros(1, 2, 9, 65, device=dev, dtype=torch.bfloat16)[..., :64]  # row stride 65
    with pytest.raises(ValueError, match="strides"):
        flash_attention(padded, padded, padded)
