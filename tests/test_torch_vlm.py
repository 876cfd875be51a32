"""Port parity: the weights bridge, the ViT tower and the caption VLM.

The same numpy-seeded inputs and the same parameters (the JAX model's seeded
init, carried over by models/convert_jax.py) go through the JAX modules and
their ports. Model parity runs at ``dtype=float32`` on the CPU with atol 1e-4
/ rtol 1e-3: the two frameworks sum matmuls in different orders, and the
differences compound over two layers. Two configs: the ``tiny-test`` flavor
and a reduced config with the base head geometry (16 query / 8 KV heads,
head_dim 64).
"""

import dataclasses

import numpy as np
import pytest
import torch

import flax.linen as fnn
import jax
import jax.numpy as jnp

from cosmos_curate_tpu.models import layers as jlayers
from cosmos_curate_tpu.models import vit as jvit
from cosmos_curate_tpu.models.vlm import model as jmodel
from cosmos_curate_tpu_torch.models import layers as tlayers
from cosmos_curate_tpu_torch.models import vit as tvit
from cosmos_curate_tpu_torch.models.convert_jax import flax_to_state_dict, load_flax_params
from cosmos_curate_tpu_torch.models.vlm import model as tmodel
from cosmos_curate_tpu_torch.models.vlm.paged_kv import paged_update, paged_write_plan

ATOL, RTOL = 1e-4, 1e-3

# base head geometry, narrow and shallow
BASE_HEADS = dict(
    vocab=512, dim=128, n_layers=2, n_heads=16, n_kv_heads=8, head_dim=64, max_seq=128, vision_tokens=8
)
CONFIGS = {
    "tiny-test": (jmodel.VLM_TINY_TEST, tmodel.VLM_TINY_TEST),
    "base-heads": (
        dataclasses.replace(jmodel.VLM_TINY_TEST, **BASE_HEADS),
        dataclasses.replace(tmodel.VLM_TINY_TEST, **BASE_HEADS),
    ),
}


def _jax_vlm_params(jcfg, seed=0):
    model = jmodel.VLM(jcfg, dtype=jnp.float32)
    size = jcfg.vision.image_size
    ck, cv = jmodel.init_cache(jcfg, 1, dtype=jnp.float32)
    params = model.init(
        jax.random.PRNGKey(seed),
        jnp.zeros((1, 1, size, size, 3), jnp.uint8),
        jnp.zeros((1, 4), jnp.int32),
        ck,
        cv,
        method=model.init_everything,
    )
    return model, fnn.meta.unbox(params)


def _port_vlm(tcfg, params):
    model = tmodel.VLM(tcfg, dtype=torch.float32)
    load_flax_params(model, params)
    return model.eval()


def _frames(seed, b, n, size):
    return np.random.default_rng(seed).integers(0, 255, (b, n, size, size, 3), dtype=np.uint8)


def _close(got, want, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32), atol=atol, rtol=rtol)


def test_config_mirrors_match_field_for_field():
    for name in ("VLM_BASE", "VLM_TINY_TEST"):
        assert dataclasses.asdict(getattr(tmodel, name)) == dataclasses.asdict(getattr(jmodel, name))
    for name in ("VIT_B_16", "VIT_TINY_TEST"):
        assert dataclasses.asdict(getattr(tvit, name)) == dataclasses.asdict(getattr(jvit, name))
    for flavor in ("base", "tiny-test"):
        assert dataclasses.asdict(tmodel.vlm_flavor(flavor)) == dataclasses.asdict(jmodel.vlm_flavor(flavor))


def test_bridge_round_trip():
    """Every flax leaf lands in exactly one port parameter, transposed to
    torch's layout, and the loaded module hands the same tensors back."""
    _, params = _jax_vlm_params(jmodel.VLM_TINY_TEST)
    sd = flax_to_state_dict(params)
    model = _port_vlm(tmodel.VLM_TINY_TEST, params)
    got = model.state_dict()
    assert set(got) == set(sd)
    for key, value in sd.items():
        assert torch.equal(got[key], value), key
    p = params["params"]
    np.testing.assert_array_equal(got["layers.1.q.weight"].numpy(), np.asarray(p["layer_1"]["q"]["kernel"]).T)
    np.testing.assert_array_equal(
        got["vision.patch_embed.weight"].numpy(),
        np.asarray(p["vision"]["patch_embed"]["kernel"]).transpose(3, 2, 0, 1),
    )
    proj_bias = np.asarray(p["projector"]["layers_2"]["bias"])
    np.testing.assert_array_equal(got["projector.2.bias"].numpy(), proj_bias)
    ln_scale = np.asarray(p["vision"]["block_0"]["ln1"]["scale"])
    np.testing.assert_array_equal(got["vision.blocks.0.ln1.weight"].numpy(), ln_scale)
    np.testing.assert_array_equal(got["embed.weight"].numpy(), np.asarray(p["embed"]["embedding"]))
    n_leaves = len(jax.tree_util.tree_leaves(params))
    assert len(sd) == n_leaves


def test_vit_tokens_match():
    cfg = jvit.VIT_TINY_TEST
    jv = jvit.ViT(cfg, dtype=jnp.float32)
    pixels = np.random.default_rng(1).uniform(-1, 1, (3, 32, 32, 3)).astype(np.float32)
    params = fnn.meta.unbox(jv.init(jax.random.PRNGKey(1), jnp.asarray(pixels)))
    jpooled, jtokens = jv.apply(params, jnp.asarray(pixels))
    tv = tvit.ViT(tvit.VIT_TINY_TEST, dtype=torch.float32)
    load_flax_params(tv, params)
    with torch.no_grad():
        pooled, tokens = tv(torch.from_numpy(pixels))
    _close(tokens, jtokens)
    _close(pooled, jpooled)


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_encode_images_match(config):
    jcfg, tcfg = CONFIGS[config]
    jm, params = _jax_vlm_params(jcfg)
    tm = _port_vlm(tcfg, params)
    frames = _frames(2, 2, 3, jcfg.vision.image_size)
    want = jm.apply(params, jnp.asarray(frames), method=jm.encode_images)
    with torch.no_grad():
        got = tm.encode_images(torch.from_numpy(frames))
    assert got.shape == (2, jcfg.vision_tokens, jcfg.dim)
    _close(got, want)


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_forward_logits_and_cache_match(config):
    """Contiguous forward: one fresh row and one row whose chunk lands
    mid-context on top of prior cache contents."""
    jcfg, tcfg = CONFIGS[config]
    jm, params = _jax_vlm_params(jcfg)
    tm = _port_vlm(tcfg, params)
    rng = np.random.default_rng(3)
    b, t, s = 2, 9, 32
    embeds = rng.standard_normal((b, t, jcfg.dim)).astype(np.float32)
    shape = (jcfg.n_layers, b, s, jcfg.n_kv_heads, jcfg.head_dim)
    ck = rng.standard_normal(shape).astype(np.float32)
    cv = rng.standard_normal(shape).astype(np.float32)
    write = np.asarray([0, 11], np.int32)
    kv_len = write + t
    pos = (write[:, None] + np.arange(t)[None]).astype(np.int32)
    jl, jk, jv = jm.apply(params, *(jnp.asarray(x) for x in (embeds, ck, cv, pos, write, kv_len)))
    tck, tcv = torch.from_numpy(ck.copy()), torch.from_numpy(cv.copy())
    with torch.no_grad():
        ints = (torch.from_numpy(x) for x in (pos, write, kv_len))
        tl, _, _ = tm(torch.from_numpy(embeds), tck, tcv, *ints)
    _close(tl, jl)
    _close(tck, jk)
    _close(tcv, jv)


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_contiguous_decode_route_matches_jax_decode_kernel(config, monkeypatch):
    """Contiguous T = 1 with the decode route forced on both sides: the JAX
    model's Pallas decode kernel (``CURATE_FLASH_DECODE=1``, interpret mode)
    against the port's decode wrapper, whose CPU path is the plain version
    of its CUDA kernel. Rows see 6 and 31 of 32 cache positions."""
    monkeypatch.setenv("CURATE_FLASH_DECODE", "1")
    calls = []
    real = tmodel.decode_attention

    def spy(q, k, v, kv_len):
        calls.append(tuple(q.shape))
        return real(q, k, v, kv_len)

    monkeypatch.setattr(tmodel, "decode_attention", spy)
    monkeypatch.setattr(tmodel, "_use_decode_kernel", lambda x: True)
    jcfg, tcfg = CONFIGS[config]
    jm, params = _jax_vlm_params(jcfg)
    tm = _port_vlm(tcfg, params)
    rng = np.random.default_rng(9)
    b, s = 2, 32
    embeds = rng.standard_normal((b, 1, jcfg.dim)).astype(np.float32)
    shape = (jcfg.n_layers, b, s, jcfg.n_kv_heads, jcfg.head_dim)
    ck = rng.standard_normal(shape).astype(np.float32)
    cv = rng.standard_normal(shape).astype(np.float32)
    write = np.asarray([5, 30], np.int32)
    kv_len = write + 1
    pos = write[:, None].copy()
    jl, jk, jv = jm.apply(params, *(jnp.asarray(x) for x in (embeds, ck, cv, pos, write, kv_len)))
    tck, tcv = torch.from_numpy(ck.copy()), torch.from_numpy(cv.copy())
    with torch.no_grad():
        tl, _, _ = tm(torch.from_numpy(embeds), tck, tcv, *(torch.from_numpy(x) for x in (pos, write, kv_len)))
    group = jcfg.n_heads // jcfg.n_kv_heads
    assert calls == [(b, jcfg.n_kv_heads, group, jcfg.head_dim)] * jcfg.n_layers
    _close(tl, jl)
    _close(tck, jk)
    _close(tcv, jv)


def _paged_inputs(jcfg, rng, *, b, t, nbl, bs, write):
    n_blocks = b * nbl + 3
    shape = (jcfg.n_layers, n_blocks, bs, jcfg.n_kv_heads, jcfg.head_dim)
    pk = rng.standard_normal(shape).astype(np.float32)
    pv = rng.standard_normal(shape).astype(np.float32)
    tables = rng.permutation(np.arange(1, n_blocks))[: b * nbl].reshape(b, nbl).astype(np.int32)
    embeds = rng.standard_normal((b, t, jcfg.dim)).astype(np.float32)
    write = np.asarray(write, np.int32)
    pos = (write[:, None] + np.arange(t)[None]).astype(np.int32)
    return embeds, pk, pv, pos, write, write + t, tables


def _run_paged(jm, params, tm, inputs):
    embeds, pk, pv, pos, write, kv_len, tables = inputs
    jl, jk, jv = jm.apply(
        params, *(jnp.asarray(x) for x in inputs), method=jm.paged_forward
    )
    tk, tv = torch.from_numpy(pk.copy()), torch.from_numpy(pv.copy())
    with torch.no_grad():
        tl, _, _ = tm.paged_forward(
            torch.from_numpy(embeds), tk, tv,
            *(torch.from_numpy(x) for x in (pos, write, kv_len, tables)),
        )
    return (jl, jk, jv), (tl, tk, tv)


@pytest.mark.parametrize("config", sorted(CONFIGS))
@pytest.mark.parametrize("t,write", [(1, [5, 30]), (12, [0, 17])])
def test_paged_forward_logits_and_pools_match(config, t, write):
    """Paged forward over fragmented tables: decode (T=1) and a prefill
    chunk, fresh and mid-context."""
    jcfg, tcfg = CONFIGS[config]
    jm, params = _jax_vlm_params(jcfg)
    tm = _port_vlm(tcfg, params)
    inputs = _paged_inputs(jcfg, np.random.default_rng(4), b=2, t=t, nbl=3, bs=16, write=write)
    (jl, jk, jv), (tl, tk, tv) = _run_paged(jm, params, tm, inputs)
    _close(tl, jl)
    _close(tk, jk)
    _close(tv, jv)


def test_out_of_table_writes_are_dropped():
    """A chunk running past its row's table: JAX's take_along_axis fills the
    block id with INT_MIN and the scatter drops the write. The port must
    drop exactly those writes — no raise, no wrap-around into a real block."""
    jcfg, tcfg = CONFIGS["tiny-test"]
    jm, params = _jax_vlm_params(jcfg)
    tm = _port_vlm(tcfg, params)
    # row 1 writes positions 40..51 with a 3-block (48-position) table
    inputs = _paged_inputs(jcfg, np.random.default_rng(5), b=2, t=12, nbl=3, bs=16, write=[0, 40])
    (jl, jk, jv), (tl, tk, tv) = _run_paged(jm, params, tm, inputs)
    pk0 = inputs[1]
    # the in-table part of row 1's chunk landed, the rest left no trace
    assert not np.allclose(np.asarray(jk), pk0)
    _close(tk, jk)
    _close(tv, jv)
    _close(tl[0], jl[0])
    # the plan itself: 12 + 8 kept rows of 24
    tables = torch.from_numpy(inputs[6])
    rows, keep = paged_write_plan(tables, torch.tensor([0, 40], dtype=torch.int32), 12, 16)
    assert keep.tolist() == list(range(12)) + list(range(12, 20))
    assert rows.max().item() < pk0.shape[1] * 16


def test_duplicate_scatter_rows_write_identical_values():
    """Pow2 row padding duplicates row 0: the duplicate writes carry the same
    values, so index_put_'s undefined order cannot change the pool."""
    rng = np.random.default_rng(6)
    pool_k = torch.zeros(1, 4, 4, 1, 8)
    pool_v = torch.zeros(1, 4, 4, 1, 8)
    tables = torch.tensor([[1, 2], [1, 2]], dtype=torch.int32)
    k = torch.from_numpy(rng.standard_normal((1, 3, 1, 8)).astype(np.float32)).repeat(2, 1, 1, 1)
    write = torch.tensor([2, 2], dtype=torch.int32)
    plan = paged_write_plan(tables, write, 3, 4)
    paged_update(pool_k, pool_v, k, -k, plan, layer_index=0)
    flat = pool_k[0].reshape(16, 1, 8)
    assert torch.equal(flat[6:9], k[0])
    assert torch.equal(pool_v[0].reshape(16, 1, 8)[6:9], -k[0])


def test_gelu_is_the_tanh_approximation():
    x = np.linspace(-6, 6, 101).astype(np.float32)
    want = np.asarray(fnn.gelu(jnp.asarray(x)))
    _close(tlayers.gelu(torch.from_numpy(x)), want, atol=1e-6, rtol=1e-6)
    exact = torch.nn.functional.gelu(torch.from_numpy(x))
    assert not np.allclose(exact.numpy(), want, atol=1e-6, rtol=1e-6)
    _close(tlayers.quick_gelu(torch.from_numpy(x)), np.asarray(jlayers.quick_gelu(jnp.asarray(x))), atol=1e-6)


def test_precision_sequence_in_bf16():
    """bf16 compute with fp32 params: Dense casts input and kernel to bf16;
    Attention rounds its logits to bf16 before the fp32 softmax; LayerNorm
    uses the fast variance; RMSNorm computes in fp32 and returns bf16."""
    rng = np.random.default_rng(7)
    x = (rng.standard_normal((2, 5, 32)) + 3.0).astype(np.float32)  # large mean
    ja = jlayers.Attention(4, 8, dtype=jnp.bfloat16)
    params = fnn.meta.unbox(ja.init(jax.random.PRNGKey(2), jnp.asarray(x)))
    want = ja.apply(params, jnp.asarray(x))
    ta = tlayers.Attention(32, 4, 8, dtype=torch.bfloat16)
    load_flax_params(ta, params)
    with torch.no_grad():
        got = ta(torch.from_numpy(x))
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    _close(got.float(), np.asarray(want, np.float32), atol=3e-2, rtol=3e-2)

    jln = fnn.LayerNorm(dtype=jnp.float32, epsilon=1e-6)
    lp = fnn.meta.unbox(jln.init(jax.random.PRNGKey(3), jnp.asarray(x)))
    tln = tlayers.LayerNorm(32, eps=1e-6)
    load_flax_params(tln, lp)
    with torch.no_grad():
        _close(tln(torch.from_numpy(x).to(torch.bfloat16)), jln.apply(lp, jnp.asarray(x, jnp.bfloat16)), atol=1e-5, rtol=1e-5)

    jrms = jmodel.RMSNorm()
    rp = fnn.meta.unbox(jrms.init(jax.random.PRNGKey(4), jnp.asarray(x)))
    trms = tmodel.RMSNorm(32)
    load_flax_params(trms, rp)
    xb = jnp.asarray(x, jnp.bfloat16)
    with torch.no_grad():
        out = trms(torch.from_numpy(x).to(torch.bfloat16))
    assert out.dtype == torch.bfloat16
    np.testing.assert_array_equal(out.float().numpy(), np.asarray(jrms.apply(rp, xb), np.float32))


@pytest.mark.parametrize("shape,mode", [((48, 40), "simple"), ((20, 24), "simple"), ((40, 56), "clip")])
def test_preprocess_resize_matches_jax_image(shape, mode):
    """Non-224 frames: bilinear (simple) and bicubic + crop (clip) resizes
    must follow jax.image.resize, antialiased when downsampling."""
    frames = np.random.default_rng(8).integers(0, 255, (2, *shape, 3), dtype=np.uint8)
    want = jvit.preprocess_frames(jnp.asarray(frames), image_size=32, mode=mode)
    got = tvit.preprocess_frames(torch.from_numpy(frames), image_size=32, mode=mode)
    assert got.shape == (2, 32, 32, 3)
    _close(got, want, atol=1e-4, rtol=1e-4)
