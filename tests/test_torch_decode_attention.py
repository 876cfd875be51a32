"""Port parity: single-token GQA decode over a contiguous KV cache.

The port's plain version (its wrapper's CPU path) against the JAX package's
``decode_attention`` Pallas kernel in interpret mode with 32-row K/V tiles,
so ragged ``kv_len`` exercises the in-tile mask and the skip of tiles past
it. fp32 at the reference's own bar (``tests/ops/test_decode_attention.py``:
atol 2e-5, rtol 1e-4); bf16 inputs at atol 3e-2.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cosmos_curate_tpu.ops.decode_attention import decode_attention as jax_decode_attention
from cosmos_curate_tpu_torch.ops._build import KernelInputError
from cosmos_curate_tpu_torch.ops.decode_attention import decode_attention, decode_attention_plain

ATOL, RTOL = 2e-5, 1e-4


def _case(seed, b, hk, g, d, s):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, hk, g, d)).astype(np.float32)
    k = rng.standard_normal((b, s, hk, d)).astype(np.float32)
    v = rng.standard_normal((b, s, hk, d)).astype(np.float32)
    return rng, q, k, v


def _both(q, k, v, kv_len):
    got = decode_attention(*(torch.from_numpy(x) for x in (q, k, v, kv_len))).numpy()
    want = jax_decode_attention(*(jnp.asarray(x) for x in (q, k, v, kv_len)), block_k=32, interpret=True)
    return got, np.asarray(want)


@pytest.mark.parametrize(
    "b,hk,g,d,s",
    [
        (2, 2, 3, 16, 64),
        (1, 2, 6, 32, 256),
        (3, 1, 1, 16, 128),
        (4, 8, 2, 64, 100),  # base GQA geometry, S not a tile multiple
    ],
)
def test_plain_matches_pallas_interpret(b, hk, g, d, s):
    rng, q, k, v = _case(0, b, hk, g, d, s)
    kv_len = rng.integers(1, s + 1, b).astype(np.int32)
    kv_len[0] = 1  # a row that sees only its own token
    got, want = _both(q, k, v, kv_len)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


def test_stale_tail_past_kv_len_never_leaks():
    """Huge-but-finite stale cache rows past kv_len contribute nothing: the
    mask and the tile skip of the reference's own test."""
    _, q, k, v = _case(1, 1, 1, 2, 16, 128)
    k[:, 40:] = 1e20
    v[:, 40:] = -1e20
    kv_len = np.asarray([40], np.int32)
    got, want = _both(q, k, v, kv_len)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


def test_empty_row_gives_zeros_like_the_kernel():
    """kv_len 0: the TPU kernel skips every tile and divides a zero
    accumulator by max(l, 1e-30)."""
    _, q, k, v = _case(2, 2, 2, 2, 16, 64)
    kv_len = np.asarray([0, 30], np.int32)
    got, want = _both(q, k, v, kv_len)
    np.testing.assert_array_equal(got[0], np.zeros_like(got[0]))
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


def test_bf16_io():
    rng, q, k, v = _case(3, 2, 2, 2, 64, 96)
    kv_len = np.asarray([17, 96], np.int32)
    got = decode_attention_plain(
        *(torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v)), torch.from_numpy(kv_len), sm_scale=0.125
    )
    assert got.dtype == torch.bfloat16
    want = jax_decode_attention(
        *(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)), jnp.asarray(kv_len), block_k=32, interpret=True
    )
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), atol=3e-2)


def test_kernel_inputs_are_checked_before_launch():
    meta = dict(device="meta", dtype=torch.bfloat16)
    q, cache = torch.empty(2, 2, 2, 64, **meta), torch.empty(2, 32, 2, 64, **meta)
    kv_len = torch.empty(2, device="meta", dtype=torch.int32)
    with pytest.raises(KernelInputError, match="CUDA tensors"):
        decode_attention(q, cache, cache, kv_len)
    with pytest.raises(KernelInputError, match="cache"):
        decode_attention(q, cache[:, :, :1], cache[:, :, :1], kv_len)
    with pytest.raises(KernelInputError, match="kv_len"):
        decode_attention(q, cache, cache, kv_len[:1])
