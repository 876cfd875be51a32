"""Split-KV paged decode: the algebra of ``cct_paged_decode`` on the CPU.

``paged_decode_split_plain`` mirrors the kernel: the table's keys cut into
``n_split`` ranges, each range's fp32 softmax state, merged in log-sum-exp
form. It is held against the JAX package's Pallas ``_paged_decode`` in
interpret mode (``use_kernel=True, interpret=True``, as
``test_torch_paged_attention.py`` runs it) and its XLA reference, fp32, at
the reference's bar (atol 2e-5, rtol 1e-4), for split counts that leave
ranges past kv_len, ranges past the table, and an idle row. The host's
split-count function is pinned in plain Python.
"""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cosmos_curate_tpu.ops.paged_attention import paged_attention as jax_paged_attention
from cosmos_curate_tpu_torch.ops.paged_attention import (
    SPLIT_MIN_KEYS,
    SPLIT_WAVES,
    decode_split_count,
    paged_attention_plain,
    paged_decode_split_plain,
)

ATOL, RTOL = 2e-5, 1e-4


def _case(seed, *, b, hk, g, d, nbl, bs):
    rng = np.random.default_rng(seed)
    n_blocks = b * nbl + 3
    pool_k = rng.standard_normal((2, n_blocks, bs, hk, d)).astype(np.float32)
    pool_v = rng.standard_normal((2, n_blocks, bs, hk, d)).astype(np.float32)
    tables = rng.permutation(np.arange(1, n_blocks))[: b * nbl].reshape(b, nbl).astype(np.int32)
    q = rng.standard_normal((b, 1, hk, g, d)).astype(np.float32)
    return rng, q, pool_k, pool_v, tables


def _split_and_pallas(q, pool_k, pool_v, tables, kv_len, n_split, layer=1):
    d = q.shape[-1]
    got = paged_decode_split_plain(
        torch.from_numpy(q), torch.from_numpy(pool_k), torch.from_numpy(pool_v),
        torch.from_numpy(tables), torch.from_numpy(kv_len),
        layer_index=layer, sm_scale=d**-0.5, n_split=n_split,
    ).numpy()
    args = (jnp.asarray(q), jnp.asarray(pool_k), jnp.asarray(pool_v), jnp.asarray(tables),
            jnp.asarray(kv_len - 1), jnp.asarray(kv_len))
    pallas = np.asarray(jax_paged_attention(*args, layer_index=layer, use_kernel=True, interpret=True))
    ref = np.asarray(jax_paged_attention(*args, layer_index=layer, use_kernel=False))
    return got, pallas, ref


@pytest.mark.parametrize("n_split", [1, 2, 3, 5, 8])
def test_split_decode_matches_pallas(n_split):
    """Width 48 keys; rows of 1, 17 and 48 keys, so most splits of the short
    rows start at or past kv_len and merge as empty partials."""
    rng, q, pk, pv, tables = _case(0, b=3, hk=2, g=4, d=16, nbl=3, bs=16)
    kv_len = np.asarray([1, 17, 48], np.int32)
    got, pallas, ref = _split_and_pallas(q, pk, pv, tables, kv_len, n_split)
    np.testing.assert_allclose(got, pallas, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("n_split", [4, 7, 12])
def test_split_decode_ranges_past_the_table(n_split):
    """Width 20 at bs = 4: ceil(20 / 12) = 2 keys a range leaves ranges
    10 and 11 past the table; D = 64, G = 2, the caption LM's grouping."""
    rng, q, pk, pv, tables = _case(1, b=2, hk=2, g=2, d=64, nbl=5, bs=4)
    kv_len = rng.integers(1, 21, 2).astype(np.int32)
    got, pallas, ref = _split_and_pallas(q, pk, pv, tables, kv_len, n_split)
    np.testing.assert_allclose(got, pallas, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("n_split", [1, 3])
def test_split_decode_idle_row_on_garbage_block(n_split):
    """An idle row points every table entry at block 0 with kv_len 1; the
    pool's blocks outside the tables hold +-1e20."""
    rng, q, pk, pv, tables = _case(2, b=2, hk=1, g=2, d=16, nbl=4, bs=8)
    tables[1] = 0
    unmapped = sorted(set(range(1, pk.shape[1])) - set(tables.ravel().tolist()))
    pk[:, unmapped] = 1e20
    pv[:, unmapped] = -1e20
    kv_len = np.asarray([29, 1], np.int32)
    got, pallas, ref = _split_and_pallas(q, pk, pv, tables, kv_len, n_split)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, pallas, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=RTOL)


def test_split_decode_agrees_with_the_plain_version():
    """In fp32 the split mirror and paged_attention_plain (what the wrapper
    runs on a CPU tensor) compute one function."""
    rng, q, pk, pv, tables = _case(3, b=4, hk=2, g=3, d=16, nbl=9, bs=8)
    kv_len = torch.tensor([72, 1, 40, 65], dtype=torch.int32)
    args = [torch.from_numpy(x) for x in (q, pk, pv, tables)]
    plain = paged_attention_plain(*args, kv_len - 1, kv_len, layer_index=0, sm_scale=16**-0.5)
    split = paged_decode_split_plain(*args, kv_len, layer_index=0, sm_scale=16**-0.5, n_split=5)
    torch.testing.assert_close(split, plain, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize(
    "width,rows,sm,want",
    [
        (1024, 32, 132, 8),  # the caption engine's long lane: 8 splits of 128 keys, 256 CTAs
        (256, 32, 132, 4),  # its short lane: every split at least 64 keys
        (96, 8, 132, 2),
        (64, 8, 132, 1),
        (4096, 264, 132, 1),  # a batch that fills two waves alone
        (4096, 1, 132, 64),
    ],
)
def test_split_count_examples(width, rows, sm, want):
    assert decode_split_count(width, rows, sm) == want


def test_split_count_bounds():
    """At least one split, never more than the table has SPLIT_MIN_KEYS-key
    ranges, never more CTAs than SPLIT_WAVES per SM once there are two or
    more splits; a function of host integers alone."""
    for width in (1, 16, 63, 64, 65, 256, 1000, 1024, 8192):
        for rows in (1, 2, 8, 32, 64, 500):
            for sm in (1, 78, 132):
                n = decode_split_count(width, rows, sm)
                assert isinstance(n, int) and n >= 1
                assert n <= max(1, math.ceil(width / SPLIT_MIN_KEYS))
                assert n == 1 or n * rows <= SPLIT_WAVES * sm
                assert -(-width // n) * (n - 1) < width  # no range starts past the table
