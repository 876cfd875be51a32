"""Port parity: the Qwen3 LM's layer parts (``models/vlm/model.py``) against
the JAX package's.

- ``MoEFFN`` with the JAX init carried across by ``models/convert_jax.py``:
  at ``capacity_factor=None`` in fp32 (atol 1e-4 / rtol 1e-3) and in bf16
  as both packages serve it (within 2e-2 of the output's largest
  magnitude: a few bf16 ulps of the experts' products); at a finite factor
  that forces drops, the same assignments drop in both packages and in a
  plain loop over the assignments (token-major queue places, the capacity
  formula), with the outputs at the fp32 bound.
- The experts stored in bf16 give the same bits as fp32-stored experts cast
  on every call, as the JAX module casts them.
- Interleaved m-rope: ``mrope_component_map`` exact; ``apply_rope`` on
  3-component positions and qk-norm's ``RMSNorm`` over the head dim within
  1e-6 (a few fp32 ulps: XLA and torch evaluate cos, sin and rsqrt
  differently).
- One ``DecoderLayer`` with qk-norm and the MoE FFN, contiguous and paged,
  in fp32 at the layer bound.
"""

import dataclasses

import numpy as np
import pytest
import torch

import flax.linen as fnn
import jax
import jax.numpy as jnp

from cosmos_curate_tpu.models.vlm import model as jm
from cosmos_curate_tpu_torch.models.convert_jax import flax_to_state_dict, load_flax_params
from cosmos_curate_tpu_torch.models.vlm import model as tm

ATOL, RTOL = 1e-4, 1e-3
BF16_REL = 2e-2


def _cfg(mod, factor, n_experts=4, top_k=2):
    moe = dataclasses.replace(mod.VLM_MOE_TINY_TEST.moe, capacity_factor=factor, n_experts=n_experts, top_k=top_k)
    return dataclasses.replace(mod.VLM_MOE_TINY_TEST, moe=moe)


def _pair(factor, jdtype, tdtype, seed=1, **kw):
    jmod = jm.MoEFFN(_cfg(jm, factor, **kw), dtype=jdtype)
    params = fnn.meta.unbox(jmod.init(jax.random.PRNGKey(seed), jnp.zeros((1, 2, 64), jdtype)))
    tmod = tm.MoEFFN(_cfg(tm, factor, **kw), dtype=tdtype)
    load_flax_params(tmod, params)
    return jmod, params, tmod


def _x(seed, shape=(3, 7, 64)):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _loop_reference(x, params, moe):
    """The MoE FFN as a plain float64 loop over the assignments: router
    softmax, top-k (ties to the lower expert id), renormalised; queue places
    counted token-major; an assignment at or past the capacity dropped.
    Returns (y, set of dropped (token, rank))."""
    p = params["params"]
    tokens = x.reshape(-1, x.shape[-1]).astype(np.float64)
    n, (e, k) = len(tokens), (moe.n_experts, moe.top_k)
    logits = tokens @ np.asarray(p["router"]["kernel"], np.float64)
    probs = np.exp(logits - logits.max(-1, keepdims=True))
    probs /= probs.sum(-1, keepdims=True)
    cap = n if moe.capacity_factor is None else max(1, min(n, int(np.ceil(k * n / e * moe.capacity_factor))))
    gate_up, down = np.asarray(p["gate_up"], np.float64), np.asarray(p["down"], np.float64)
    filled = [0] * e
    y = np.zeros_like(tokens)
    dropped = set()
    for i, tok in enumerate(tokens):
        order = sorted(range(e), key=lambda j: (-probs[i, j], j))[:k]
        w = probs[i, order] / probs[i, order].sum()
        for rank, j in enumerate(order):
            place, filled[j] = filled[j], filled[j] + 1
            if place >= cap:
                dropped.add((i, rank))
                continue
            z = tok @ gate_up[j]
            gate, up = np.split(z, 2)
            y[i] += w[rank] * ((gate / (1 + np.exp(-gate)) * up) @ down[j])
    return y.reshape(x.shape), dropped


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_matches_jax_without_drops(dtype):
    jmod, params, tmod = _pair(None, getattr(jnp, dtype), getattr(torch, dtype))
    x = _x(0)
    want = np.asarray(jmod.apply(params, jnp.asarray(x, getattr(jnp, dtype))).astype(jnp.float32))
    log = []
    with torch.no_grad():
        got = tmod(torch.from_numpy(x).to(getattr(torch, dtype))).float().numpy()
        tm.moe_forward(tmod.cfg, torch.from_numpy(x).to(getattr(torch, dtype)), tmod.router, tmod.gate_up, tmod.down,
                       tmod.dtype, log)
    assert [(b, t, int(d)) for b, t, d in log] == [(3, 7, 0)]
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
        ref, dropped = _loop_reference(x, params, tmod.cfg)
        assert not dropped
        np.testing.assert_allclose(got, ref, atol=ATOL, rtol=RTOL)
    else:
        assert np.abs(got - want).max() <= BF16_REL * np.abs(want).max()


@pytest.mark.parametrize("factor,n_experts,top_k", [(1.0, 4, 2), (0.5, 4, 2), (1.0, 16, 4)])
def test_moe_drops_the_same_assignments_as_jax(factor, n_experts, top_k):
    """Capacity ceil(k * n / e * factor) < the busiest expert's queue: the
    loop reference names the dropped assignments; the port counts as many,
    and the port's and the JAX package's outputs both equal the loop's,
    which differs from the no-drop output at the dropped tokens."""
    jmod, params, tmod = _pair(factor, jnp.float32, torch.float32, n_experts=n_experts, top_k=top_k)
    x = _x(5, (4, 6, 64))
    ref, dropped = _loop_reference(x, params, tmod.cfg)
    assert dropped, "the case must overflow a queue"
    log = []
    with torch.no_grad():
        got = tm.moe_forward(tmod.cfg, torch.from_numpy(x), tmod.router, tmod.gate_up, tmod.down, tmod.dtype,
                             log).numpy()
    want = np.asarray(jmod.apply(params, jnp.asarray(x)))
    assert int(log[0][2]) == len(dropped)
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(want, ref, atol=ATOL, rtol=RTOL)
    undropped, none = _loop_reference(x, params, dataclasses.replace(tmod.cfg, capacity_factor=None))
    assert not none
    rows = sorted({i for i, _ in dropped})
    flat = got.reshape(-1, 64)
    assert all(np.abs(flat[i] - undropped.reshape(-1, 64)[i]).max() > 1e-5 for i in rows)


def test_bf16_stored_experts_equal_fp32_cast_per_call():
    _, params, tmod = _pair(2.0, jnp.bfloat16, torch.bfloat16, n_experts=8, top_k=2)
    assert tmod.gate_up.dtype == tmod.down.dtype == torch.bfloat16
    assert tmod.router.weight.dtype == torch.float32
    fp32 = flax_to_state_dict(params)
    x = torch.from_numpy(_x(9)).to(torch.bfloat16)
    with torch.no_grad():
        stored = tmod(x)
        cast = tm.moe_forward(tmod.cfg, x, tmod.router, fp32["gate_up"], fp32["down"], torch.bfloat16)
    assert fp32["gate_up"].dtype == torch.float32
    assert torch.equal(stored, cast)


@pytest.mark.parametrize("section", [(2, 3, 3), (24, 20, 20)])
def test_interleaved_mrope_and_qk_norm_match_jax(section):
    np.testing.assert_array_equal(tm.mrope_component_map(section, True), jm.mrope_component_map(section, True))
    np.testing.assert_array_equal(tm.mrope_component_map(section, False), jm.mrope_component_map(section, False))
    d = 2 * sum(section)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 9, 4, d)).astype(np.float32)
    pos = rng.integers(0, 400, (2, 9, 3)).astype(np.int32)
    want = np.asarray(jm.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e6, section, True))
    got = tm.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 1e6, section, True).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    # text positions (all three components equal) reduce to 1-D rope
    flat = np.repeat(pos[..., :1], 3, axis=-1)
    one_d = tm.apply_rope(torch.from_numpy(x), torch.from_numpy(pos[..., 0]), 1e6)
    torch.testing.assert_close(tm.apply_rope(torch.from_numpy(x), torch.from_numpy(flat), 1e6, section, True), one_d)
    norm = jm.RMSNorm(eps=1e-6)
    scale = rng.uniform(0.5, 1.5, d).astype(np.float32)
    nparams = {"params": {"scale": jnp.asarray(scale)}}
    tnorm = tm.RMSNorm(d)
    tnorm.weight.data = torch.from_numpy(scale)
    with torch.no_grad():
        np.testing.assert_allclose(tnorm(torch.from_numpy(x)).numpy(), np.asarray(norm.apply(nparams, jnp.asarray(x))),
                                   atol=1e-6, rtol=0)


def test_decoder_layer_with_qk_norm_and_moe_matches_jax():
    """One layer of ``VLM_QWEN3VL_TINY_TEST`` (qk-norm, interleaved m-rope,
    MoE) over a 5-token chunk written at offsets 0 and 3, contiguous and
    paged, fp32."""
    jcfg, tcfg = jm.VLM_QWEN3VL_TINY_TEST, tm.VLM_QWEN3VL_TINY_TEST
    layer = jm.DecoderLayer(jcfg, dtype=jnp.float32)
    rng = np.random.default_rng(6)
    b, t, s = 2, 5, 16
    x = rng.standard_normal((b, t, jcfg.dim)).astype(np.float32)
    pos = rng.integers(0, 20, (b, t, 3)).astype(np.int32)
    write = np.asarray([0, 3], np.int32)
    kv_len = write + t
    cache = rng.standard_normal((2, b, s, jcfg.n_kv_heads, jcfg.head_dim)).astype(np.float32)
    params = fnn.meta.unbox(layer.init(jax.random.PRNGKey(2), *(jnp.asarray(a) for a in
                                                                 (x, cache[0], cache[1], pos, write, kv_len))))
    sd = flax_to_state_dict(params)
    assert {"q_norm.weight", "k_norm.weight", "moe.router.weight", "moe.gate_up", "moe.down"} <= set(sd)
    assert not any(k.startswith(("up.", "gate.", "down.")) for k in sd)
    want, jk, jv = layer.apply(params, *(jnp.asarray(a) for a in (x, cache[0], cache[1], pos, write, kv_len)))
    tl = tm.DecoderLayer(tcfg, dtype=torch.float32)
    tl.load_state_dict(sd, strict=True)
    ck, cv = torch.from_numpy(cache[0].copy()), torch.from_numpy(cache[1].copy())
    with torch.no_grad():
        got = tl(torch.from_numpy(x), ck, cv, *(torch.from_numpy(a) for a in (pos, write, kv_len)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(ck.numpy(), np.asarray(jk), atol=ATOL, rtol=RTOL)
    # paged: the same rows through a shuffled pool of 8-token blocks
    bs = 8
    tables = rng.permutation(np.arange(1, 2 * s // bs + 1)).reshape(b, s // bs).astype(np.int32)
    pool = np.zeros((2, 1, 2 * s // bs + 1, bs, jcfg.n_kv_heads, jcfg.head_dim), np.float32)
    for r in range(b):
        for j, blk in enumerate(tables[r]):
            pool[:, 0, blk] = cache[:, r, j * bs : (j + 1) * bs]
    pk, pv = torch.from_numpy(pool[0].copy()), torch.from_numpy(pool[1].copy())
    with torch.no_grad():
        paged = tl(torch.from_numpy(x), pk, pv, *(torch.from_numpy(a) for a in (pos, write, kv_len)),
                   block_tables=torch.from_numpy(tables))
    np.testing.assert_allclose(paged.numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)
