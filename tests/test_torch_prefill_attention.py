"""Port parity: chunked-prefill attention over a contiguous cache.

The port's plain version (its wrapper's CPU path) against the JAX
package's ``prefill_attention`` Pallas kernel in interpret mode and against
its XLA path (the ``DecoderLayer`` einsum lines, which the JAX package's
own dense oracle reproduces), fp32, atol 2e-5 / rtol 1e-4.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cosmos_curate_tpu.ops.prefill_attention import prefill_attention as jax_prefill_attention
from cosmos_curate_tpu_torch.ops.prefill_attention import chunk_attention_plain, prefill_attention

ATOL, RTOL = 2e-5, 1e-4


def _jax_xla_path(q, k, v, write_index, kv_len, sm_scale):
    """DecoderLayer's contiguous XLA attention lines (model.py), verbatim."""
    b, t, hk, g, d = q.shape
    s = k.shape[1]
    qg = q * sm_scale
    logits = jnp.einsum("btkgd,bskd->bkgts", qg.astype(jnp.float32), k.astype(jnp.float32))
    k_pos = jnp.arange(s)[None, None, None, None, :]
    q_seq = write_index[:, None] + jnp.arange(t)[None, :]
    causal = k_pos <= q_seq[:, None, None, :, None]
    written = k_pos < kv_len[:, None, None, None, None]
    logits = jnp.where(causal & written, logits, -1e30)
    probs = jax.nn.softmax(logits, axis=-1)
    return jnp.einsum("bkgts,bskd->btkgd", probs.astype(q.dtype), v)


def _case(seed, *, b, t, s, hk, g, d):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, t, hk, g, d)).astype(np.float32)
    k = rng.standard_normal((b, s, hk, d)).astype(np.float32)
    v = rng.standard_normal((b, s, hk, d)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize(
    "b,t,s,hk,g,d,write",
    [
        (1, 64, 64, 2, 2, 16, [0]),  # shared-prefix build: T = S, write 0
        (2, 12, 40, 2, 3, 16, [0, 17]),  # a later chunk mid-context
        (1, 13, 32, 1, 2, 64, [5]),  # ragged T against the Pallas block_q
    ],
)
def test_plain_matches_pallas_interpret_and_xla(b, t, s, hk, g, d, write):
    q, k, v = _case(7, b=b, t=t, s=s, hk=hk, g=g, d=d)
    write = np.asarray(write, np.int32)
    kv_len = np.minimum(write + t, s).astype(np.int32)
    got = prefill_attention(
        *(torch.from_numpy(x) for x in (q, k, v, write, kv_len))
    ).numpy()
    jargs = [jnp.asarray(x) for x in (q, k, v, write, kv_len)]
    pallas = np.asarray(jax_prefill_attention(*jargs, interpret=True))
    xla = np.asarray(_jax_xla_path(*jargs, d**-0.5))
    np.testing.assert_allclose(got, pallas, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(got, xla, atol=ATOL, rtol=RTOL)


def test_padded_prefix_rows_see_only_written_keys():
    """A pow2-padded prefix build: rows past kv_len attend only to the
    kv_len written keys, so garbage in the padded cache tail never leaks."""
    q, k, v = _case(8, b=1, t=16, s=16, hk=1, g=2, d=16)
    k[:, 11:] = 1e20
    v[:, 11:] = -1e20
    write = np.zeros(1, np.int32)
    kv_len = np.asarray([11], np.int32)
    got = prefill_attention(*(torch.from_numpy(x) for x in (q, k, v, write, kv_len))).numpy()
    assert np.isfinite(got).all()
    jargs = [jnp.asarray(x) for x in (q, k, v, write, kv_len)]
    pallas = np.asarray(jax_prefill_attention(*jargs, interpret=True))
    np.testing.assert_allclose(got, pallas, atol=ATOL, rtol=RTOL)


def test_bf16_plain_keeps_reference_precision_sequence():
    """In bf16 the plain version scales q in bf16, softmaxes in fp32 and
    rounds the probabilities to bf16 before the value product — the XLA
    lines' sequence, so it agrees with them to bf16 rounding."""
    q, k, v = _case(9, b=1, t=8, s=8, hk=2, g=2, d=16)
    write = np.zeros(1, np.int32)
    kv_len = np.asarray([8], np.int32)
    tq, tk, tv = (torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v))
    got = chunk_attention_plain(tq, tk, tv, torch.from_numpy(write), torch.from_numpy(kv_len), 0.25)
    assert got.dtype == torch.bfloat16
    jq, jk, jv = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))
    want = np.asarray(_jax_xla_path(jq, jk, jv, jnp.asarray(write), jnp.asarray(kv_len), 0.25), np.float32)
    np.testing.assert_allclose(got.float().numpy(), want, atol=2e-2, rtol=2e-2)

