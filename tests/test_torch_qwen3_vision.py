"""Port parity: the Qwen3-VL deepstack vision tower (the ``qwen3`` variant of
``models/vlm/vision_qwen.py``) against the JAX package's.

- ``pos_embed_interp_matrix`` is exact: grids whose side divides the
  pos-embed side, one that does not, and the published tower's 14 x 14 grid
  on its 48 x 48 table.
- ``QWEN3_VISION_TINY_TEST`` in fp32 on the CPU, the JAX init carried
  across by ``models/convert_jax.py``: the merged tokens and every deepstack
  level at atol 1e-4 / rtol 1e-3, on 8 and on 7 frames.
- The converter's names for the new parameters (the pos-embed table, the
  patch projection's bias, the ``ds{l}`` mergers) cover the module.
- The config mirrors equal the JAX originals field for field.
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


def test_config_mirrors_match_field_for_field():
    for name in ("QWEN3_VL_MOE_VISION", "QWEN3_VISION_TINY_TEST"):
        t, j = getattr(tvq, name), getattr(jvq, name)
        assert dataclasses.asdict(t) == dataclasses.asdict(j), name
        for prop in ("mlp_hidden", "head_dim", "patch_dim"):
            assert getattr(t, prop) == getattr(j, prop), (name, prop)
        for n in (1, 7, 8):
            assert t.grid(n) == j.grid(n) and t.merged_grid(n) == j.merged_grid(n)
    assert tvq.QWEN3_VL_MOE_VISION.head_dim == 72


@pytest.mark.parametrize(
    "config,grid",
    [("tiny", (4, 4, 4)), ("tiny", (1, 6, 6)), ("tiny", (2, 10, 6)), ("tiny", (1, 2, 2)), ("published", (4, 14, 14))],
)
def test_pos_embed_interp_matrix_exact(config, grid):
    name = "QWEN3_VISION_TINY_TEST" if config == "tiny" else "QWEN3_VL_MOE_VISION"
    got = tvq.pos_embed_interp_matrix(getattr(tvq, name), grid)
    want = jvq.pos_embed_interp_matrix(getattr(jvq, name), grid)
    assert got.dtype == np.float32 and got.shape == (grid[1] * grid[2], getattr(tvq, name).pos_embed_side**2)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(got.sum(axis=1), 1.0, rtol=1e-6)  # bilinear weights sum to one


def _jax_tower(grid, seed=0):
    tower = jvq.QwenVisionTower(jvq.QWEN3_VISION_TINY_TEST, dtype=jnp.float32)
    patches = jnp.zeros((1, int(np.prod(grid)), jvq.QWEN3_VISION_TINY_TEST.patch_dim), jnp.float32)
    params = fnn.meta.unbox(tower.init(jax.random.PRNGKey(seed), patches, grid))
    return tower, params


@pytest.mark.parametrize("n_frames", [8, 7])
def test_tower_and_deepstack_match_jax_in_fp32(n_frames):
    cfg = tvq.QWEN3_VISION_TINY_TEST
    grid = cfg.grid(n_frames)
    jt, params = _jax_tower(grid)
    tt = tvq.QwenVisionTower(cfg, dtype=torch.float32)
    load_flax_params(tt, params)
    frames = np.random.default_rng(3).integers(0, 255, (3, n_frames, cfg.image_size, cfg.image_size, 3), np.uint8)
    jp, _ = jvq.frames_to_patches(jnp.asarray(frames), jvq.QWEN3_VISION_TINY_TEST)
    want, want_ds = jt.apply(params, jp, grid)
    with torch.no_grad():
        tp, _ = tvq.frames_to_patches(torch.from_numpy(frames), cfg)
        got, got_ds = tt.eval()(tp, grid)
    n_tok = cfg.tokens_out(n_frames)
    assert got.shape == (3, n_tok, cfg.hidden_size)
    assert got_ds.shape == (len(cfg.deepstack_indexes), 3, n_tok, cfg.hidden_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)
    for level in range(len(cfg.deepstack_indexes)):
        np.testing.assert_allclose(got_ds[level].numpy(), np.asarray(want_ds[level]), atol=ATOL, rtol=RTOL)


def test_tower_parameter_names():
    """The new names cross: ``pos_embed`` as it is, the patch projection's
    bias, the deepstack mergers' LayerNorm and two Linears per level."""
    cfg = tvq.QWEN3_VISION_TINY_TEST
    _, params = _jax_tower(cfg.grid(2))
    sd = flax_to_state_dict(params)
    p = params["params"]
    np.testing.assert_array_equal(sd["pos_embed"].numpy(), np.asarray(p["pos_embed"]))
    assert "patch_embed.bias" in sd
    for level in range(len(cfg.deepstack_indexes)):
        names = {f"ds{level}_norm.weight", f"ds{level}_norm.bias", f"ds{level}_fc1.weight", f"ds{level}_fc2.bias"}
        assert names <= set(sd)
    np.testing.assert_array_equal(sd["ds1_fc1.weight"].numpy(), np.asarray(p["ds1_fc1"]["kernel"]).T)
    assert set(tvq.QwenVisionTower(cfg).state_dict()) == set(sd)
