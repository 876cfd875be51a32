"""Split-KV contiguous decode: the algebra of ``cct_decode`` on the CPU.

``decode_split_plain`` mirrors the split decode body over a contiguous
``[B, S, Hkv, D]`` cache: the S keys cut into ``n_split`` ranges, each
range's fp32 softmax state, merged in log-sum-exp form. It is held against
the JAX package's ``decode_attention`` Pallas kernel in interpret mode with
32-row K/V tiles (as ``test_torch_decode_attention.py`` runs it), fp32, at
the reference's bar (atol 2e-5, rtol 1e-4), for split counts that leave
ranges past kv_len and past S, rows at kv_len 0 and 1, and stale +-1e20
rows past kv_len. On the same rows scattered into a shuffled pool, the
paged mirror (``paged_decode_split_plain``) gives the same bits: the two
kernels share one body, split at the same key boundaries.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cosmos_curate_tpu.ops.decode_attention import decode_attention as jax_decode_attention
from cosmos_curate_tpu_torch.ops.paged_attention import decode_split_plain, paged_decode_split_plain

ATOL, RTOL = 2e-5, 1e-4


def _case(seed, *, b, hk, g, d, s):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, hk, g, d)).astype(np.float32)
    k = rng.standard_normal((b, s, hk, d)).astype(np.float32)
    v = rng.standard_normal((b, s, hk, d)).astype(np.float32)
    return rng, q, k, v


def _split_and_pallas(q, k, v, kv_len, n_split):
    got = decode_split_plain(
        *(torch.from_numpy(x) for x in (q, k, v, kv_len)), sm_scale=q.shape[-1] ** -0.5, n_split=n_split
    ).numpy()
    want = jax_decode_attention(*(jnp.asarray(x) for x in (q, k, v, kv_len)), block_k=32, interpret=True)
    return got, np.asarray(want)


@pytest.mark.parametrize("n_split", [1, 2, 3, 5, 8])
def test_split_decode_matches_pallas(n_split):
    """S = 96; rows of 0, 1, 37 and 96 keys, so most splits of the short
    rows start at or past kv_len and merge as empty partials, and the
    kv_len 0 row gives zeros as the TPU kernel does."""
    _, q, k, v = _case(0, b=4, hk=2, g=4, d=16, s=96)
    kv_len = np.asarray([0, 1, 37, 96], np.int32)
    got, want = _split_and_pallas(q, k, v, kv_len, n_split)
    np.testing.assert_array_equal(got[0], np.zeros_like(got[0]))
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("n_split", [4, 7, 12])
def test_split_decode_ranges_past_s(n_split):
    """S = 20: ceil(20 / 12) = 2 keys a range leaves ranges 10 and 11 past
    the cache; D = 64, G = 2, the caption LM's grouping."""
    rng, q, k, v = _case(1, b=3, hk=2, g=2, d=64, s=20)
    kv_len = np.concatenate([[1], rng.integers(2, 21, 2)]).astype(np.int32)
    got, want = _split_and_pallas(q, k, v, kv_len, n_split)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("n_split", [1, 3, 8])
def test_split_decode_stale_rows_never_leak(n_split):
    """Cache rows at or past each row's kv_len hold +-1e20; a split that
    ends inside them, or lies wholly among them, adds nothing."""
    _, q, k, v = _case(2, b=3, hk=2, g=2, d=16, s=128)
    kv_len = np.asarray([40, 1, 97], np.int32)
    for row, n in enumerate(kv_len):
        k[row, n:] = 1e20
        v[row, n:] = -1e20
    got, want = _split_and_pallas(q, k, v, kv_len, n_split)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("bs,n_split", [(16, 1), (16, 8), (3, 1), (3, 5)])
def test_contiguous_split_equals_paged_split(bs, n_split):
    """The same rows as a contiguous cache and scattered through a shuffled
    table into a pool (its other blocks at +-1e20): the contiguous and the
    paged mirror give the same bits, at S = the table's width."""
    rng = np.random.default_rng(3)
    b, hk, g, d, nbl = 3, 2, 2, 16, 6
    s = nbl * bs
    n_blocks = b * nbl + 3
    tables = rng.permutation(np.arange(1, n_blocks))[: b * nbl].reshape(b, nbl).astype(np.int32)
    k = rng.standard_normal((b, s, hk, d)).astype(np.float32)
    v = rng.standard_normal((b, s, hk, d)).astype(np.float32)
    q = rng.standard_normal((b, hk, g, d)).astype(np.float32)
    pool_k = np.full((2, n_blocks, bs, hk, d), 1e20, np.float32)
    pool_v = np.full((2, n_blocks, bs, hk, d), -1e20, np.float32)
    pool_k[1][tables] = k.reshape(b, nbl, bs, hk, d)
    pool_v[1][tables] = v.reshape(b, nbl, bs, hk, d)
    kv_len = torch.tensor([s, 1, s // 2 + 1], dtype=torch.int32)
    contiguous = decode_split_plain(
        *(torch.from_numpy(x) for x in (q, k, v)), kv_len, sm_scale=d**-0.5, n_split=n_split
    )
    paged = paged_decode_split_plain(
        torch.from_numpy(q)[:, None], torch.from_numpy(pool_k), torch.from_numpy(pool_v), torch.from_numpy(tables),
        kv_len, layer_index=1, sm_scale=d**-0.5, n_split=n_split,
    )
    assert torch.equal(paged[:, 0], contiguous)
