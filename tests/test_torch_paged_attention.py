"""Port parity: paged attention (decode T=1 and chunked prefill T>1).

The port's plain version (what its wrapper runs on a CPU tensor) against
the JAX package's XLA reference (``use_kernel=False``) AND its Pallas
kernels in interpret mode (``use_kernel=True, interpret=True``), on the
same numpy-seeded inputs, fp32, at the reference's own bar (atol 2e-5,
rtol 1e-4 — tests/ops/test_paged_attention.py). Tables are fragmented,
layer_index is 1, and a mid-context write_index is covered. The CUDA
kernels themselves are compared with this plain version on the card by
chip_smoke.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cosmos_curate_tpu.ops.paged_attention import paged_attention as jax_paged_attention
from cosmos_curate_tpu_torch.ops import kernels
from cosmos_curate_tpu_torch.ops.paged_attention import paged_attention, paged_attention_plain

ATOL, RTOL = 2e-5, 1e-4


def _case(seed, *, b, t, hk, g, d, nbl, bs, extra_blocks=3):
    """Two-layer pools with block 0 reserved as garbage and each row's table
    a shuffled slice of the physical blocks (logical order != pool order)."""
    rng = np.random.default_rng(seed)
    n_blocks = b * nbl + extra_blocks
    pool_k = rng.standard_normal((2, n_blocks, bs, hk, d)).astype(np.float32)
    pool_v = rng.standard_normal((2, n_blocks, bs, hk, d)).astype(np.float32)
    tables = rng.permutation(np.arange(1, n_blocks))[: b * nbl].reshape(b, nbl).astype(np.int32)
    q = rng.standard_normal((b, t, hk, g, d)).astype(np.float32)
    return rng, q, pool_k, pool_v, tables


def _both(q, pool_k, pool_v, tables, write, kv_len, *, layer=1):
    got = paged_attention(
        torch.from_numpy(q), torch.from_numpy(pool_k), torch.from_numpy(pool_v),
        torch.from_numpy(tables), torch.from_numpy(write), torch.from_numpy(kv_len),
        layer_index=layer,
    ).numpy()
    args = (jnp.asarray(q), jnp.asarray(pool_k), jnp.asarray(pool_v), jnp.asarray(tables),
            jnp.asarray(write), jnp.asarray(kv_len))
    ref = np.asarray(jax_paged_attention(*args, layer_index=layer, use_kernel=False))
    pallas = np.asarray(
        jax_paged_attention(*args, layer_index=layer, use_kernel=True, interpret=True)
    )
    return got, ref, pallas


@pytest.mark.parametrize("b,hk,g,d,nbl,bs", [(2, 2, 4, 16, 4, 16), (3, 1, 2, 32, 2, 8), (2, 2, 2, 64, 3, 16)])
def test_decode_matches_reference_and_pallas(b, hk, g, d, nbl, bs):
    rng, q, pk, pv, tables = _case(0, b=b, t=1, hk=hk, g=g, d=d, nbl=nbl, bs=bs)
    kv_len = rng.integers(1, nbl * bs + 1, b).astype(np.int32)
    got, ref, pallas = _both(q, pk, pv, tables, kv_len - 1, kv_len)
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(got, pallas, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("t", [12, 13])
def test_prefill_chunk_mid_context_matches_reference_and_pallas(t):
    """One fresh row and one row whose chunk starts mid-context; T=13 does
    not tile the Pallas kernel's block_q."""
    rng, q, pk, pv, tables = _case(1, b=2, t=t, hk=2, g=3, d=16, nbl=4, bs=16)
    write = np.asarray([0, 17], np.int32)
    got, ref, pallas = _both(q, pk, pv, tables, write, write + t)
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(got, pallas, atol=ATOL, rtol=RTOL)


def test_layer_zero_and_one_differ():
    """layer_index selects the pool plane: a wrong layer offset would pass
    a single-layer test."""
    rng, q, pk, pv, tables = _case(2, b=1, t=1, hk=1, g=2, d=16, nbl=2, bs=8)
    kv_len = np.asarray([16], np.int32)
    got0, ref0, _ = _both(q, pk, pv, tables, kv_len - 1, kv_len, layer=0)
    got1, _, _ = _both(q, pk, pv, tables, kv_len - 1, kv_len, layer=1)
    np.testing.assert_allclose(got0, ref0, atol=ATOL, rtol=RTOL)
    assert not np.allclose(got0, got1)


def test_unmapped_garbage_blocks_do_not_leak():
    """Pool blocks outside the tables (block 0 included) hold huge values;
    the op reads only through the table."""
    rng, q, pk, pv, tables = _case(3, b=1, t=1, hk=1, g=2, d=16, nbl=2, bs=8, extra_blocks=4)
    unmapped = sorted(set(range(pk.shape[1])) - set(tables.ravel().tolist()))
    pk[:, unmapped] = 1e20
    pv[:, unmapped] = -1e20
    kv_len = np.asarray([16], np.int32)
    got, ref, pallas = _both(q, pk, pv, tables, kv_len - 1, kv_len)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(got, pallas, atol=ATOL, rtol=RTOL)


def test_idle_row_on_garbage_block_is_finite():
    """Idle decode rows point every table entry at block 0 with kv_len=1."""
    rng, q, pk, pv, tables = _case(4, b=2, t=1, hk=2, g=2, d=16, nbl=2, bs=8)
    tables[1] = 0
    kv_len = np.asarray([11, 1], np.int32)
    got, ref, pallas = _both(q, pk, pv, tables, kv_len - 1, kv_len)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(got, pallas, atol=ATOL, rtol=RTOL)


def test_cpu_wrapper_runs_plain_version_and_counts_no_launch():
    rng, q, pk, pv, tables = _case(5, b=1, t=3, hk=1, g=2, d=16, nbl=2, bs=8)
    args = [torch.from_numpy(x) for x in (q, pk, pv, tables)]
    write = torch.tensor([2], dtype=torch.int32)
    before = {k: v.launches for k, v in kernels().items()}
    out = paged_attention(*args, write, write + 3, layer_index=1)
    plain = paged_attention_plain(*args, write, write + 3, layer_index=1, sm_scale=16**-0.5)
    assert torch.equal(out, plain)
    assert {k: v.launches for k, v in kernels().items()} == before

