"""Port parity: flash self-attention over ``[B, H, S, D]``.

The port's plain version (its wrapper's CPU path) against the JAX package's
``flash_attention`` Pallas kernel in interpret mode with 32-row tiles, so
ragged lengths exercise the padded-tail mask and several tiles exercise the
online softmax and the causal tile skip. fp32 at the reference's own bar
(``tests/ops/test_flash_attention.py``: atol 2e-5, rtol 1e-4); bf16 inputs
at its bf16 bar (atol 3e-2).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cosmos_curate_tpu.ops.flash_attention import flash_attention as jax_flash_attention
from cosmos_curate_tpu_torch.ops._build import KernelInputError
from cosmos_curate_tpu_torch.ops.flash_attention import flash_attention, flash_attention_plain

ATOL, RTOL = 2e-5, 1e-4


def _qkv(seed, shape, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(dtype) for _ in range(3)]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize(
    "shape",
    [
        (1, 2, 64, 32),  # two full tiles
        (2, 3, 50, 16),  # ragged: 50 % 32 != 0
        (1, 2, 197, 64),  # ViT-B/16 at 224^2: ragged over seven tiles
        (2, 2, 50, 96),  # a head dim that is not a power of two
        (3, 2, 9, 64),  # the temporal pooler's length: one mostly-padded tile
    ],
)
def test_plain_matches_pallas_interpret(shape, causal):
    q, k, v = _qkv(0, shape)
    got = flash_attention(*(torch.from_numpy(x) for x in (q, k, v)), causal=causal)
    want = jax_flash_attention(
        *(jnp.asarray(x) for x in (q, k, v)), causal=causal, block_q=32, block_k=32, interpret=True
    )
    assert got.shape == shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)


def test_bf16_io():
    q, k, v = _qkv(2, (1, 2, 64, 32))
    tq, tk, tv = (torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v))
    got = flash_attention_plain(tq, tk, tv)
    assert got.dtype == torch.bfloat16
    want = jax_flash_attention(
        *(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)), block_q=32, block_k=32, interpret=True
    )
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), atol=3e-2)


def test_strided_views_and_scale():
    """A [B, S, H, D] projection transposed to [B, H, S, D] (how
    layers.Attention calls it) and an explicit sm_scale."""
    q, k, v = _qkv(3, (2, 40, 3, 16))
    views = [torch.from_numpy(x).transpose(1, 2) for x in (q, k, v)]
    got = flash_attention(*views, sm_scale=0.3)
    want = jax_flash_attention(
        *(jnp.asarray(x.transpose(0, 2, 1, 3)) for x in (q, k, v)),
        sm_scale=0.3, block_q=32, block_k=32, interpret=True,
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)


def test_causal_first_token_attends_self_only():
    q, _, v = _qkv(4, (1, 1, 32, 8))
    out = flash_attention_plain(torch.from_numpy(q), torch.from_numpy(q), torch.from_numpy(v), causal=True)
    np.testing.assert_allclose(out[0, 0, 0].numpy(), v[0, 0, 0], atol=1e-6)


def test_kernel_inputs_are_checked_before_launch():
    """Off the CPU the wrapper launches or raises; these refusals need no
    card (meta tensors carry shape, dtype and device only)."""
    meta = dict(device="meta", dtype=torch.bfloat16)
    with pytest.raises(KernelInputError, match="head dim 48"):
        flash_attention(*(torch.empty(1, 2, 9, 48, **meta) for _ in range(3)))
    with pytest.raises(KernelInputError, match="CUDA tensors"):
        flash_attention(*(torch.empty(1, 2, 9, 64, **meta) for _ in range(3)))
    with pytest.raises(KernelInputError, match="one \\[B, H, S, D\\] shape"):
        flash_attention(torch.empty(1, 2, 9, 64, **meta), torch.empty(1, 2, 8, 64, **meta),
                        torch.empty(1, 2, 9, 64, **meta))
