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
from cosmos_curate_tpu_torch.ops.paged_attention import (
    decode_split_count,
    decode_split_plain,
    paged_attention,
    paged_attention_plain,
    paged_decode_split_plain,
    split_counters,
)
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


# (bs, nbl, d): every way the prefill kernel reads the pool (64 / bs TMA
# boxes per key tile at bs = 8 and 16, one box inside a block at 128,
# cp.async rows at 4, 3 and 48) and tables whose width is not a multiple of
# the 64-key tile (except at bs = 128)
BLOCK_SIZE_CASES = [(16, 6, 64), (8, 13, 16), (128, 3, 128), (4, 25, 64), (3, 40, 64), (48, 3, 128)]


def _garbage_case(seed, *, b, t, hk, g, d, nbl, bs, device, idle_row):
    """Pools whose every row the tables do not expose holds +-1e20: blocks
    outside the tables, and the rows at or past each row's kv_len inside
    its own blocks. Block 0, the idle rows' garbage block, keeps a finite
    row 0 (its kv_len is 1) and +-1e20 after it."""
    rng = np.random.default_rng(seed)
    width = nbl * bs
    n_blocks = b * nbl + 3
    pool_k = rng.standard_normal((2, n_blocks, bs, hk, d)).astype(np.float32)
    pool_v = rng.standard_normal((2, n_blocks, bs, hk, d)).astype(np.float32)
    tables = rng.permutation(np.arange(1, n_blocks))[: b * nbl].reshape(b, nbl).astype(np.int32)
    t_max = min(t, width - 1)
    write = rng.integers(0, width - t_max + 1, b).astype(np.int32)
    if t == 1:
        write[0] = width - 1  # a full table
    kv_len = (write + t_max).astype(np.int32) if t > 1 else write + 1
    if idle_row:
        tables[-1] = 0
        write[-1], kv_len[-1] = 0, 1
    unmapped = sorted(set(range(n_blocks)) - set(tables.ravel().tolist()) - {0})
    for pool, sign in ((pool_k, 1.0), (pool_v, -1.0)):
        pool[:, unmapped] = sign * 1e20
        pool[:, 0, 1:] = sign * 1e20
        for row in range(b):
            if tables[row, 0] == 0:
                continue
            for pos in range(int(kv_len[row]), width):
                pool[:, tables[row, pos // bs], pos % bs] = sign * 1e20
    to = lambda x: torch.from_numpy(x).to(device, torch.bfloat16)  # noqa: E731
    i32 = lambda x: torch.from_numpy(np.asarray(x, np.int32)).to(device)  # noqa: E731
    q = to(rng.standard_normal((b, t_max if t > 1 else 1, hk, g, d)).astype(np.float32))
    return q, to(pool_k), to(pool_v), i32(tables), i32(write), i32(kv_len)


def _paged_check(dev, q, pk, pv, tables, write, kv_len, name):
    d = q.shape[-1]
    n = kernels()[name].launches
    got = paged_attention(q, pk, pv, tables, write, kv_len, layer_index=1)
    want = paged_attention_plain(
        q.float(), pk.float(), pv.float(), tables, write, kv_len, layer_index=1, sm_scale=d**-0.5
    )
    assert kernels()[name].launches == n + 1
    assert torch.isfinite(got.float()).all()
    assert _err(got, want) <= BOUND


@pytest.mark.cuda
@pytest.mark.parametrize("bs,nbl,d", BLOCK_SIZE_CASES)
def test_paged_prefill_kernel_block_sizes(dev, bs, nbl, d):
    """B = 3 mid-context chunks with the pool's unexposed rows at +-1e20;
    the last row idle on block 0."""
    args = _garbage_case(10, b=3, t=nbl * bs // 2 + 5, hk=2, g=2, d=d, nbl=nbl, bs=bs, device=dev, idle_row=True)
    _paged_check(dev, *args, "paged_prefill")


@pytest.mark.cuda
@pytest.mark.parametrize("bs,nbl,d", BLOCK_SIZE_CASES)
def test_paged_decode_kernel_block_sizes(dev, bs, nbl, d):
    """B = 4 rows, one over its full table, the last idle on block 0, the
    pool's unexposed rows at +-1e20; the split count the wrapper picks."""
    args = _garbage_case(11, b=4, t=1, hk=2, g=2, d=d, nbl=nbl, bs=bs, device=dev, idle_row=True)
    _paged_check(dev, *args, "paged_decode")


@pytest.mark.cuda
@pytest.mark.parametrize("g,d,bs", [(2, 64, 16), (6, 128, 16), (2, 64, 4)])
def test_paged_prefill_equals_contiguous_prefill(dev, g, d, bs):
    """Over a shuffled table, paged prefill equals cct_prefill on the same
    rows gathered into a contiguous cache, bit for bit: one geometry and
    precision, K / V read from the pool in place (by TMA boxes at bs = 16,
    by cp.async at bs = 4)."""
    rng = np.random.default_rng(12)
    b, hk, nbl, t = 2, 2, 96 // bs, 40
    n_blocks = b * nbl + 3
    to = lambda *shape: torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev, torch.bfloat16)  # noqa: E731
    pk, pv = to(2, n_blocks, bs, hk, d), to(2, n_blocks, bs, hk, d)
    tables = torch.from_numpy(
        rng.permutation(np.arange(1, n_blocks))[: b * nbl].reshape(b, nbl).astype(np.int32)
    ).to(dev)
    q = to(b, t, hk, g, d)
    write = torch.tensor([0, 50], dtype=torch.int32, device=dev)
    kv_len = write + t
    paged = paged_attention(q, pk, pv, tables, write, kv_len, layer_index=1)
    k = pk[1][tables.long()].reshape(b, nbl * bs, hk, d).contiguous()
    v = pv[1][tables.long()].reshape(b, nbl * bs, hk, d).contiguous()
    contiguous = prefill_attention(q, k, v, write, kv_len)
    torch.cuda.synchronize()
    assert torch.equal(paged, contiguous)


@pytest.mark.cuda
def test_paged_decode_is_one_launch_and_leaves_counters_zero(dev):
    """The caption engine's 1024-key lane: 8 splits of 128 keys on an H100,
    merged by the last split in the same launch, which leaves the merge
    counters zero; twice, so the second call finds them zeroed."""
    rng = np.random.default_rng(13)
    b, hk, g, d, bs, nbl = 4, 8, 2, 64, 16, 64
    n_blocks = b * nbl + 1
    to = lambda *shape: torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev, torch.bfloat16)  # noqa: E731
    pk, pv = to(2, n_blocks, bs, hk, d), to(2, n_blocks, bs, hk, d)
    tables = torch.from_numpy(rng.permutation(np.arange(1, n_blocks)).reshape(b, nbl).astype(np.int32)).to(dev)
    q = to(b, 1, hk, g, d)
    kv_len = torch.tensor([1024, 700, 129, 1], dtype=torch.int32, device=dev)
    n_split = decode_split_count(nbl * bs, b * hk, torch.cuda.get_device_properties(dev).multi_processor_count)
    assert n_split > 1
    want = paged_decode_split_plain(
        q.float(), pk.float(), pv.float(), tables, kv_len, layer_index=1, sm_scale=d**-0.5, n_split=n_split
    )
    outs = []
    for _ in range(2):
        n = kernels()["paged_decode"].launches
        outs.append(paged_attention(q, pk, pv, tables, kv_len - 1, kv_len, layer_index=1))
        assert kernels()["paged_decode"].launches == n + 1
        torch.cuda.synchronize()
        assert not split_counters(q.device, b * hk).any()
    assert torch.equal(outs[0], outs[1])
    assert _err(outs[0], want) <= BOUND


@pytest.mark.cuda
def test_paged_decode_on_two_streams(dev):
    """Split decodes queued on two streams at once: each stream merges
    through its own counters, so both give the single-stream answer."""
    rng = np.random.default_rng(14)
    b, hk, g, d, bs, nbl = 4, 8, 2, 64, 16, 64
    n_blocks = b * nbl + 1
    to = lambda *shape: torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev, torch.bfloat16)  # noqa: E731
    pk, pv = to(1, n_blocks, bs, hk, d), to(1, n_blocks, bs, hk, d)
    tables = torch.from_numpy(rng.permutation(np.arange(1, n_blocks)).reshape(b, nbl).astype(np.int32)).to(dev)
    qs = [to(b, 1, hk, g, d) for _ in range(2)]
    kv_len = torch.tensor([1024, 700, 129, 1], dtype=torch.int32, device=dev)
    want = [paged_attention(q, pk, pv, tables, kv_len - 1, kv_len) for q in qs]
    streams = [torch.cuda.Stream(dev) for _ in range(2)]
    torch.cuda.synchronize()
    outs = [[], []]
    for _ in range(20):
        for i, stream in enumerate(streams):
            with torch.cuda.stream(stream):
                outs[i].append(paged_attention(qs[i], pk, pv, tables, kv_len - 1, kv_len))
    torch.cuda.synchronize()
    for i, stream in enumerate(streams):
        assert all(torch.equal(out, want[i]) for out in outs[i])
        with torch.cuda.stream(stream):
            assert not split_counters(dev, b * hk).any()


@pytest.mark.cuda
@pytest.mark.parametrize("own_stream", [False, True])
def test_decode_from_two_host_threads(dev, own_stream):
    """Two host threads (two pipeline stages sharing the card) issue split
    decodes, paged and contiguous, at once: on the default stream, and each
    on a stream of its own. The merge-counter registry starts empty, so
    both threads race to create its entries. Every output equals the same
    call run serially, bit for bit."""
    import sys
    import threading

    import cosmos_curate_tpu_torch.ops.paged_attention as paged_mod

    rng = np.random.default_rng(15)
    b, hk, g, d, bs, nbl = 4, 8, 2, 64, 16, 64
    n_blocks = b * nbl + 1
    to = lambda *shape: torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev, torch.bfloat16)  # noqa: E731
    pk, pv = to(1, n_blocks, bs, hk, d), to(1, n_blocks, bs, hk, d)
    k, v = to(b, nbl * bs, hk, d), to(b, nbl * bs, hk, d)
    tables = torch.from_numpy(rng.permutation(np.arange(1, n_blocks)).reshape(b, nbl).astype(np.int32)).to(dev)
    qs = [to(b, hk, g, d) for _ in range(2)]
    kv_len = torch.tensor([1024, 700, 129, 1], dtype=torch.int32, device=dev)

    def calls(i):
        if i == 0:
            return paged_attention(qs[0][:, None], pk, pv, tables, kv_len - 1, kv_len)[:, 0]
        return decode_attention(qs[1], k, v, kv_len)

    want = [calls(i) for i in range(2)]
    torch.cuda.synchronize()
    paged_mod._split_counters.clear()
    outs: list[list] = [[], []]
    errors = []
    start = threading.Barrier(2)

    def worker(i):
        try:
            stream = torch.cuda.Stream(dev) if own_stream else torch.cuda.current_stream(dev)
            start.wait(timeout=30)
            with torch.cuda.stream(stream):
                for _ in range(50):
                    outs[i].append(calls(i))
                stream.synchronize()
        except Exception as e:  # reported on the main thread below
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker, args=(i,)) for i in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads) and not errors, errors
    torch.cuda.synchronize()
    for i in range(2):
        assert len(outs[i]) == 50 and all(torch.equal(out, want[i]) for out in outs[i])


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
@pytest.mark.parametrize(
    "d,g,s",
    [(64, 2, 1024), (16, 4, 100), (128, 6, 300), (64, 16, 1024), (16, 16, 100), (128, 16, 300), (64, 8, 256)],
)
def test_contiguous_decode_kernel(dev, d, g, s):
    """Rows at kv_len 0 (zeros), 1, S / 3, S - 1 and S; every cache row at
    or past a row's kv_len holds +-1e20; the split count the wrapper picks."""
    rng = np.random.default_rng(3)

    def mk(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev, torch.bfloat16)

    lengths = [0, 1, s // 3, s - 1, s]
    q, k, v = mk(5, 2, g, d), mk(5, s, 2, d), mk(5, s, 2, d)
    for row, n in enumerate(lengths):
        k[row, n:] = 1e20
        v[row, n:] = -1e20
    kv_len = torch.tensor(lengths, dtype=torch.int32, device=dev)
    n = kernels()["decode"].launches
    got = decode_attention(q, k, v, kv_len)
    want = decode_attention_plain(q.float(), k.float(), v.float(), kv_len, sm_scale=d**-0.5)
    assert kernels()["decode"].launches == n + 1
    assert torch.isfinite(got.float()).all()
    assert not got[0].any()
    assert _err(got, want) <= BOUND


@pytest.mark.cuda
@pytest.mark.parametrize("width,bs", [(1024, 16), (256, 16), (1024, 4), (256, 4)])
def test_contiguous_decode_equals_paged_decode(dev, width, bs):
    """The caption engine's lanes (4 slots, Hkv 8, G 2, D 64; the last slot
    idle on block 0 at kv_len 1): contiguous decode on the table's rows
    gathered into a [B, width, Hkv, D] cache equals paged decode on the pool,
    bit for bit: one body, one split count, one merge order."""
    rng = np.random.default_rng(15)
    b, hk, g, d, nbl = 4, 8, 2, 64, width // bs
    n_blocks = b * nbl + 1
    to = lambda *shape: torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev, torch.bfloat16)  # noqa: E731
    pk, pv = to(2, n_blocks, bs, hk, d), to(2, n_blocks, bs, hk, d)
    tables = rng.permutation(np.arange(1, n_blocks)).reshape(b, nbl).astype(np.int32)
    tables[-1] = 0
    tables = torch.from_numpy(tables).to(dev)
    q = to(b, hk, g, d)
    kv = rng.integers(64, width + 1, b)
    kv[-1] = 1
    kv_len = torch.from_numpy(kv.astype(np.int32)).to(dev)
    k = pk[1][tables.long()].reshape(b, width, hk, d).contiguous()
    v = pv[1][tables.long()].reshape(b, width, hk, d).contiguous()
    paged = paged_attention(q[:, None], pk, pv, tables, kv_len - 1, kv_len, layer_index=1)
    contiguous = decode_attention(q, k, v, kv_len)
    torch.cuda.synchronize()
    assert torch.equal(contiguous, paged[:, 0])


@pytest.mark.cuda
def test_contiguous_decode_is_one_launch_and_leaves_counters_zero(dev):
    """The gather engine's 1024-key lane: 8 splits of 128 keys on an H100,
    merged by the last split in the same launch, which leaves the merge
    counters zero; twice, so the second call finds them zeroed."""
    rng = np.random.default_rng(16)
    b, hk, g, d, s = 4, 8, 2, 64, 1024
    to = lambda *shape: torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev, torch.bfloat16)  # noqa: E731
    q, k, v = to(b, hk, g, d), to(b, s, hk, d), to(b, s, hk, d)
    kv_len = torch.tensor([1024, 700, 129, 1], dtype=torch.int32, device=dev)
    n_split = decode_split_count(s, b * hk, torch.cuda.get_device_properties(dev).multi_processor_count)
    assert n_split > 1
    want = decode_split_plain(q.float(), k.float(), v.float(), kv_len, sm_scale=d**-0.5, n_split=n_split)
    outs = []
    for _ in range(2):
        n = kernels()["decode"].launches
        outs.append(decode_attention(q, k, v, kv_len))
        assert kernels()["decode"].launches == n + 1
        torch.cuda.synchronize()
        assert not split_counters(q.device, b * hk).any()
    assert torch.equal(outs[0], outs[1])
    assert _err(outs[0], want) <= BOUND


@pytest.mark.cuda
@pytest.mark.parametrize(
    "shape,causal",
    [
        ((8, 12, 197, 64), False),  # ViT-B/16 at 224^2: a ragged last key tile
        ((4, 16, 257, 64), False),  # CLIP ViT-L/14 at 224^2: one key in the last tile
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
@pytest.mark.parametrize("shape", [(256, 12, 77, 64), (256, 8, 64, 64)], ids=["clip-text-l", "clip-text-b"])
def test_flash_kernel_causal_at_the_clip_text_shapes(dev, shape):
    """The CLIP text towers' causal attention over 256 queries: S = 77
    (no tile multiple) and S = 64, both shorter than one key tile."""
    rng = np.random.default_rng(6)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev, torch.bfloat16) for _ in range(3))
    n = kernels()["flash"].launches
    got = flash_attention(q, k, v, causal=True)
    assert kernels()["flash"].launches == n + 1
    want = flash_attention_plain(q.float(), k.float(), v.float(), causal=True)
    assert torch.isfinite(got.float()).all()
    # the first rows attend to one or two keys, so outputs reach |4|, where
    # bf16's half ulp (0.0156) passes the bound: held to it beyond what
    # rounding the plain output to bf16 costs by itself
    rounding = (want.to(torch.bfloat16).float() - want).abs()
    assert ((got.float() - want).abs() - rounding).max().item() <= BOUND
    # the causal mask is on: the non-causal result differs beyond the bound
    assert _err(got, flash_attention_plain(q.float(), k.float(), v.float())) > BOUND


@pytest.mark.cuda
def test_clip_text_tower_launches_flash_once_a_layer(dev):
    from cosmos_curate_tpu_torch.models.clip_text import CLIPTextEmbeddings

    model = CLIPTextEmbeddings("clip-text-tiny-test", device=dev)
    model.setup()
    n = kernels()["flash"].launches
    out = model.encode_texts(["a dog", "the camera pans left over a city"])
    assert kernels()["flash"].launches == n + model.cfg.layers
    assert np.allclose(np.linalg.norm(out, axis=-1), 1.0, atol=1e-3)


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


# the Qwen caption flavors' LM heads (Hkv, G, D) and the 1024-key lane's
# slots: Qwen2-VL-2B 12 / 2 heads of 128 (8 slots), Qwen2.5-VL-7B 28 / 4
# (4 slots); their drives' prompt is a 45-token chat prefix and a
# 376-token suffix (256 vision tokens)
QWEN_CASES = [(2, 6, 128, 8), (4, 7, 128, 4)]
QWEN_PREFIX, QWEN_TOTAL = 45, 421


def _qwen_pool(rng, dev, b, hk, d, nbl, bs=16, idle_row=False):
    n_blocks = b * nbl + 1
    to = lambda *shape: torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev, torch.bfloat16)  # noqa: E731
    pk, pv = to(2, n_blocks, bs, hk, d), to(2, n_blocks, bs, hk, d)
    tables = rng.permutation(np.arange(1, n_blocks)).reshape(b, nbl).astype(np.int32)
    if idle_row:
        tables[-1] = 0
    return to, pk, pv, torch.from_numpy(tables).to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("hk,g,d,b", QWEN_CASES)
def test_qwen_decode_kernels_on_the_lane(dev, hk, g, d, b):
    """Both decodes on the 1024-key lane at the Qwen heads (lengths past the
    prompt, the last slot idle on block 0 at kv_len 1): each within BOUND
    of its fp32 plain version, and contiguous decode on the gathered rows
    equal to paged decode on the pool, bit for bit."""
    rng = np.random.default_rng(21)
    width, bs = 1024, 16
    to, pk, pv, tables = _qwen_pool(rng, dev, b, hk, d, width // bs, idle_row=True)
    q = to(b, hk, g, d)
    kv = rng.integers(QWEN_TOTAL, width + 1, b)
    kv[-1] = 1
    kv_len = torch.from_numpy(kv.astype(np.int32)).to(dev)
    k = pk[1][tables.long()].reshape(b, width, hk, d).contiguous()
    v = pv[1][tables.long()].reshape(b, width, hk, d).contiguous()
    n = {name: kernels()[name].launches for name in ("paged_decode", "decode")}
    paged = paged_attention(q[:, None], pk, pv, tables, kv_len - 1, kv_len, layer_index=1)[:, 0]
    contiguous = decode_attention(q, k, v, kv_len)
    assert {name: kernels()[name].launches - n[name] for name in n} == {"paged_decode": 1, "decode": 1}
    want = decode_attention_plain(q.float(), k.float(), v.float(), kv_len, sm_scale=d**-0.5)
    assert torch.isfinite(paged.float()).all()
    assert _err(paged, want) <= BOUND
    assert torch.equal(contiguous, paged)


@pytest.mark.cuda
@pytest.mark.parametrize("hk,g,d,b", QWEN_CASES)
@pytest.mark.parametrize("chunk", ["chunk_256", "bucket_512"])
def test_qwen_paged_prefill_equals_contiguous_prefill(dev, hk, g, d, b, chunk):
    """Paged prefill at the Qwen heads after the 45-token chat prefix: a
    256-token chunk (a first and a second chunk) or the whole batch's
    512-token bucket (queries past kv_len are padding): within BOUND of its
    fp32 plain version and equal to cct_prefill on the gathered rows."""
    rng = np.random.default_rng(22)
    nbl, bs = 64, 16
    if chunk == "chunk_256":
        t, write, kv = 256, [QWEN_PREFIX, QWEN_PREFIX + 256], [QWEN_PREFIX + 256, QWEN_PREFIX + 512]
    else:
        t, write, kv = 512, [QWEN_PREFIX] * b, [QWEN_TOTAL] * b
    rows = len(write)
    to, pk, pv, tables = _qwen_pool(rng, dev, rows, hk, d, nbl)
    q = to(rows, t, hk, g, d)
    wi = torch.tensor(write, dtype=torch.int32, device=dev)
    kl = torch.tensor(kv, dtype=torch.int32, device=dev)
    paged = paged_attention(q, pk, pv, tables, wi, kl, layer_index=1)
    want = paged_attention_plain(q.float(), pk.float(), pv.float(), tables, wi, kl, layer_index=1, sm_scale=d**-0.5)
    k = pk[1][tables.long()].reshape(rows, nbl * bs, hk, d).contiguous()
    v = pv[1][tables.long()].reshape(rows, nbl * bs, hk, d).contiguous()
    contiguous = prefill_attention(q, k, v, wi, kl)
    assert torch.isfinite(paged.float()).all()
    assert _err(paged, want) <= BOUND
    assert torch.equal(paged, contiguous)


@pytest.mark.cuda
@pytest.mark.parametrize("hk,g,d,b", QWEN_CASES)
def test_qwen_prefix_build_prefill(dev, hk, g, d, b):
    """The shared chat prefix's build: T = S = 64 (the prefix padded to a
    power of two), kv_len 45."""
    _prefill_check(dev, 23, t=64, s=64, hk=hk, g=g, d=d, write=[0], kv_len=[QWEN_PREFIX])


# Qwen3-VL-30B-A3B's LM heads: 32 / 4 of 128 (G = 8, the top of the split
# decode's G <= 8 body); its lanes ((1024, 4), (4096, 2)); its drive's
# prompt is the 45-token chat prefix and a 316-token suffix (196 vision
# tokens of 8 frames at 224^2 and patch 16)
QWEN3_HEADS = (4, 8, 128)
QWEN3_TOTAL = QWEN_PREFIX + 316


@pytest.mark.cuda
@pytest.mark.parametrize("width,b", [(1024, 4), (4096, 2)])
def test_qwen3_decode_kernels_on_the_lanes(dev, width, b):
    """Both decodes at G = 8 on each lane (the last slot idle on block 0 at
    kv_len 1): within BOUND of the fp32 plain version, and contiguous
    decode on the gathered rows equal to paged decode, bit for bit."""
    hk, g, d = QWEN3_HEADS
    rng = np.random.default_rng(31)
    bs = 16
    to, pk, pv, tables = _qwen_pool(rng, dev, b, hk, d, width // bs, idle_row=True)
    q = to(b, hk, g, d)
    kv = rng.integers(QWEN3_TOTAL, width + 1, b)
    kv[-1] = 1
    kv_len = torch.from_numpy(kv.astype(np.int32)).to(dev)
    k = pk[1][tables.long()].reshape(b, width, hk, d).contiguous()
    v = pv[1][tables.long()].reshape(b, width, hk, d).contiguous()
    paged = paged_attention(q[:, None], pk, pv, tables, kv_len - 1, kv_len, layer_index=1)[:, 0]
    contiguous = decode_attention(q, k, v, kv_len)
    want = decode_attention_plain(q.float(), k.float(), v.float(), kv_len, sm_scale=d**-0.5)
    assert torch.isfinite(paged.float()).all()
    assert _err(paged, want) <= BOUND
    assert torch.equal(contiguous, paged)


@pytest.mark.cuda
@pytest.mark.parametrize("chunk", ["chunk_256", "bucket_512"])
def test_qwen3_paged_prefill_equals_contiguous_prefill(dev, chunk):
    """Paged prefill at G = 8 after the chat prefix, as a 256-token chunk
    (a first and a second one) or the 4-slot lane's 512-token bucket:
    within BOUND of its fp32 plain version and equal to cct_prefill on the
    gathered rows."""
    hk, g, d = QWEN3_HEADS
    rng = np.random.default_rng(32)
    nbl = 64
    if chunk == "chunk_256":
        t, write, kv = 256, [QWEN_PREFIX, QWEN_PREFIX + 256], [QWEN_PREFIX + 256, QWEN_PREFIX + 512]
    else:
        t, write, kv = 512, [QWEN_PREFIX] * 4, [QWEN3_TOTAL] * 4
    rows = len(write)
    to, pk, pv, tables = _qwen_pool(rng, dev, rows, hk, d, nbl)
    q = to(rows, t, hk, g, d)
    wi = torch.tensor(write, dtype=torch.int32, device=dev)
    kl = torch.tensor(kv, dtype=torch.int32, device=dev)
    paged = paged_attention(q, pk, pv, tables, wi, kl, layer_index=1)
    want = paged_attention_plain(q.float(), pk.float(), pv.float(), tables, wi, kl, layer_index=1, sm_scale=d**-0.5)
    k = pk[1][tables.long()].reshape(rows, nbl * 16, hk, d).contiguous()
    v = pv[1][tables.long()].reshape(rows, nbl * 16, hk, d).contiguous()
    contiguous = prefill_attention(q, k, v, wi, kl)
    assert torch.isfinite(paged.float()).all()
    assert _err(paged, want) <= BOUND
    assert torch.equal(paged, contiguous)


@pytest.mark.cuda
def test_qwen3_prefix_build_prefill(dev):
    """The chat prefix's build at G = 8: T = S = 64, kv_len 45."""
    hk, g, d = QWEN3_HEADS
    _prefill_check(dev, 33, t=64, s=64, hk=hk, g=g, d=d, write=[0], kv_len=[QWEN_PREFIX])
