"""Port parity: the Qwen2-VL / Qwen2.5-VL vision tower
(``models/vlm/vision_qwen.py``) against the JAX package's.

- The host-side helpers are exact: ``rotary_tables`` and
  ``window_partition`` (a merged grid that is, and one that is not, a
  multiple of the window: padded entries and empty windows), and
  ``frames_to_patches`` on 8 and on 7 frames (the last frame repeated to a
  multiple of the temporal patch).
- The tower in fp32 on the CPU, the JAX init carried across by
  ``models/convert_jax.py``: ``QWEN_VISION_TINY_TEST`` (``qwen2``) and a
  ``qwen2_5`` replacement of it with a window that pads and one
  full-attention block, atol 1e-4 / rtol 1e-3 (the frameworks sum matmuls
  in other orders; the differences compound over the blocks).
- The config mirrors equal the JAX originals field for field; the
  ``qwen3`` variant builds (its parity is ``test_torch_qwen3_vision.py``'s).
"""

import dataclasses

import numpy as np
import pytest
import torch

import flax.linen as fnn
import jax
import jax.numpy as jnp

from cosmos_curate_tpu.models.vlm import vision_qwen as jvq
from cosmos_curate_tpu_torch.models.convert_jax import flax_to_state_dict, load_flax_params
from cosmos_curate_tpu_torch.models.vlm import vision_qwen as tvq

ATOL, RTOL = 1e-4, 1e-3


def _qwen25(mod):
    """The tiny tower as qwen2_5: a 32 px window (2 x 2 merge units at
    patch 8) over a 3 x 3 merged grid (48 px), padded to 4 x 4, so one
    window holds a single unit; block 1 attends to the whole frame."""
    return dataclasses.replace(
        mod.QWEN_VISION_TINY_TEST,
        variant="qwen2_5",
        intermediate_size=48,
        image_size=48,
        window_size=32,
        fullatt_block_indexes=(1,),
        tokens_per_second=2.0,
    )


CONFIGS = {
    "qwen2": (jvq.QWEN_VISION_TINY_TEST, tvq.QWEN_VISION_TINY_TEST),
    "qwen2_5": (_qwen25(jvq), _qwen25(tvq)),
}


def _frames(seed, b, n, size):
    return np.random.default_rng(seed).integers(0, 255, (b, n, size, size, 3), dtype=np.uint8)


def test_config_mirrors_match_field_for_field():
    for name in ("QWEN2_VL_2B_VISION", "QWEN25_VL_7B_VISION", "QWEN_VISION_TINY_TEST"):
        t, j = getattr(tvq, name), getattr(jvq, name)
        assert dataclasses.asdict(t) == dataclasses.asdict(j), name
        for prop in ("mlp_hidden", "head_dim", "patch_dim"):
            assert getattr(t, prop) == getattr(j, prop), (name, prop)
        for n in (1, 7, 8):
            assert t.grid(n) == j.grid(n) and t.tokens_out(n) == j.tokens_out(n)
            assert t.merged_grid(n) == j.merged_grid(n)


@pytest.mark.parametrize("config", sorted(CONFIGS))
@pytest.mark.parametrize("grid", [(4, 4, 4), (1, 6, 6), (2, 8, 8)])
def test_rotary_tables_exact(config, grid):
    jcfg, tcfg = CONFIGS[config]
    np.testing.assert_array_equal(tvq.rotary_tables(tcfg, grid), jvq.rotary_tables(jcfg, grid))


@pytest.mark.parametrize("grid", [(2, 8, 8), (2, 6, 6), (1, 10, 6), (3, 16, 16)])
def test_window_partition_exact(grid):
    """The tiny qwen2_5 tower's 2 x 2-unit window and the 7B's 4 x 4-unit
    one: (2, 8, 8) tiles the small window; the others pad (-100 entries,
    windows holding fewer units)."""
    jcfg, tcfg = CONFIGS["qwen2_5"]
    for got, want in zip(tvq.window_partition(tcfg, grid), jvq.window_partition(jcfg, grid), strict=True):
        np.testing.assert_array_equal(got, want)
    seven_b = tvq.window_partition(tvq.QWEN25_VL_7B_VISION, grid)
    for got, want in zip(seven_b, jvq.window_partition(jvq.QWEN25_VL_7B_VISION, grid), strict=True):
        np.testing.assert_array_equal(got, want)


def test_window_partition_pads_at_the_tiny_grid():
    """The qwen2_5 case of the tower test really pads: 9 merge units in 4
    windows of 4, 2, 2 and 1."""
    _, tcfg = CONFIGS["qwen2_5"]
    _, seg, unit_perm = tvq.window_partition(tcfg, tcfg.grid(4))
    assert np.bincount(seg).tolist() == [16, 8, 8, 4, 16, 8, 8, 4]
    assert sorted(unit_perm.tolist()) == list(range(18))


@pytest.mark.parametrize("config", sorted(CONFIGS))
@pytest.mark.parametrize("n_frames", [8, 7])
def test_frames_to_patches_exact(config, n_frames):
    jcfg, tcfg = CONFIGS[config]
    frames = _frames(1, 2, n_frames, jcfg.image_size)
    want, jgrid = jvq.frames_to_patches(jnp.asarray(frames), jcfg)
    got, tgrid = tvq.frames_to_patches(torch.from_numpy(frames), tcfg)
    assert tgrid == jgrid == jcfg.grid(n_frames)
    assert got.shape == want.shape == (2, np.prod(jgrid), jcfg.patch_dim)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _jax_tower(jcfg, grid, seed=0):
    tower = jvq.QwenVisionTower(jcfg, dtype=jnp.float32)
    patches = jnp.zeros((1, int(np.prod(grid)), jcfg.patch_dim), jnp.float32)
    params = fnn.meta.unbox(tower.init(jax.random.PRNGKey(seed), patches, grid))
    return tower, params


@pytest.mark.parametrize("config", sorted(CONFIGS))
@pytest.mark.parametrize("n_frames", [8, 7])
def test_tower_matches_jax_in_fp32(config, n_frames):
    jcfg, tcfg = CONFIGS[config]
    grid = jcfg.grid(n_frames)
    jt, params = _jax_tower(jcfg, grid)
    tt = tvq.QwenVisionTower(tcfg, dtype=torch.float32)
    load_flax_params(tt, params)
    assert len(flax_to_state_dict(params)) == len(jax.tree_util.tree_leaves(params))
    frames = _frames(2, 3, n_frames, jcfg.image_size)
    jp, _ = jvq.frames_to_patches(jnp.asarray(frames), jcfg)
    want = jt.apply(params, jp, grid)
    with torch.no_grad():
        tp, _ = tvq.frames_to_patches(torch.from_numpy(frames), tcfg)
        got = tt.eval()(tp, grid)
    assert got.shape == (3, jcfg.tokens_out(n_frames), jcfg.hidden_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)


def test_tower_parameter_names():
    """The converter's map of the tower: fused qkv split (s, 3, h, dh) in
    the kernel's column order, RMSNorm ``scale`` -> ``weight``, the merger
    layers, no patch-embed bias."""
    jcfg, tcfg = CONFIGS["qwen2_5"]
    _, params = _jax_tower(jcfg, jcfg.grid(2))
    sd = flax_to_state_dict(params)
    p = params["params"]
    assert "patch_embed.bias" not in sd
    np.testing.assert_array_equal(sd["blocks.0.qkv.weight"].numpy(), np.asarray(p["block_0"]["qkv"]["kernel"]).T)
    np.testing.assert_array_equal(sd["blocks.1.ln1.weight"].numpy(), np.asarray(p["block_1"]["ln1"]["scale"]))
    for name in ("gate", "up", "down"):
        assert f"blocks.1.{name}.bias" in sd
    assert {"ln_q.weight", "merger_fc1.weight", "merger_fc2.bias"} <= set(sd)
    tt = tvq.QwenVisionTower(tcfg)
    assert set(tt.state_dict()) == set(sd)


def test_qwen3_tower_is_not_ported():
    """Ported since ROADMAP item A6b: the qwen3 variant builds with its
    pos-embed table, patch bias and one merger a deepstack tap, and returns
    (tokens, levels); an unknown variant is refused."""
    cfg = tvq.QWEN3_VISION_TINY_TEST
    tower = tvq.QwenVisionTower(cfg, dtype=torch.float32)
    assert tower.pos_embed.shape == (16, 32) and tower.patch_embed.bias is not None
    patches, grid = tvq.frames_to_patches(torch.zeros(1, 2, 32, 32, 3, dtype=torch.uint8), cfg)
    with torch.no_grad():
        tokens, levels = tower(patches, grid)
    assert tokens.shape == (1, 4, 64) and levels.shape == (2, 1, 4, 64)
    with pytest.raises(ValueError, match="unknown Qwen vision variant"):
        tvq.QwenVisionTower(dataclasses.replace(cfg, variant="qwen4"))


def test_bf16_tower_tracks_fp32():
    """The tower at its serving dtype: bf16 compute, fp32 norms and
    softmax, against the same weights in fp32 (within 5e-2 of the output's
    largest magnitude)."""
    _, tcfg = CONFIGS["qwen2_5"]
    torch.manual_seed(0)
    tower = tvq.QwenVisionTower(tcfg, dtype=torch.float32)
    tower.init_weights(torch.Generator().manual_seed(0))
    bf16 = tvq.QwenVisionTower(tcfg, dtype=torch.bfloat16)
    bf16.load_state_dict(tower.state_dict())
    patches, grid = tvq.frames_to_patches(torch.from_numpy(_frames(3, 2, 8, tcfg.image_size)), tcfg)
    with torch.no_grad():
        want, got = tower(patches, grid), bf16(patches, grid)
    assert got.dtype == torch.bfloat16
    assert (got.float() - want).abs().max() <= 5e-2 * want.abs().max()
