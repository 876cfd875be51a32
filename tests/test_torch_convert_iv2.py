"""Port parity: the InternVideo2 converter (``models/convert_iv2.py``)
against the JAX package's, at ``IV2_TINY_TEST``, with numpy-seeded state
dicts under the stage-2 checkpoint's tensor names.

- (a) The same state dict through both converters gives the same tree
  (keys, shapes, dtypes, bits) and the same ``ConversionReport``, in the
  bare tower layout, the multimodal wrapper's (``vision_encoder.`` +
  ``vision_proj``) and without the contrastive head (reported unmapped);
  training-only tensors are reported skipped; both packages'
  ``save_params`` write the same bytes.
- (b) The port's tower loaded from the converted tree matches the JAX
  tower loaded from the JAX converter's, atol 1e-4 / rtol 1e-3, and the
  tree has exactly the flax init's structure.
- (c) Against the reference's own PyTorch tower (2e-5 / 1e-4, the bar of
  ``tests/models/test_internvideo2.py``) where the reference checkout that
  test reads is present.
- (d) ``scripts/convert_phase.py``'s generator at InternVideo2-1B's full
  width holds exactly the port tower's parameters plus its two
  training-only tensors.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

import flax.linen as fnn
import jax
import jax.numpy as jnp

from cosmos_curate_tpu.models import convert_iv2 as jconv
from cosmos_curate_tpu.models import internvideo2 as jiv2
from cosmos_curate_tpu_torch.models import convert_iv2 as tconv
from cosmos_curate_tpu_torch.models import internvideo2 as tiv2
from cosmos_curate_tpu_torch.models.convert_jax import load_flax_params
from tests.test_torch_convert_hf import (
    as_torch,
    assert_same_checkpoint,
    assert_same_report,
    assert_same_tree,
    cp,
    leaves,
    numpy_state_dict,
)

ATOL, RTOL = 1e-4, 1e-3


def _sd(layout: str, seed: int = 0) -> dict:
    cfg = tiv2.IV2_TINY_TEST
    sd = numpy_state_dict(cp.internvideo2_shapes(cfg, with_vision_proj=layout != "no_proj"), seed)
    if layout in ("wrapper", "torch"):
        sd = {(k if k.startswith("vision_proj") else f"vision_encoder.{k}"): v for k, v in sd.items()}
    return as_torch(sd) if layout == "torch" else sd


@pytest.mark.parametrize("layout", ["bare", "wrapper", "no_proj", "torch"])
def test_converter_matches_jax(layout, tmp_path):
    sd = _sd(layout)
    jtree, jreport = jconv.convert_internvideo2(sd, jiv2.IV2_TINY_TEST)
    ttree, treport = tconv.convert_internvideo2(sd, tiv2.IV2_TINY_TEST)
    assert_same_tree(ttree, jtree)
    assert_same_report(treport, jreport)
    assert sorted(treport.vision_skipped) == ["clip_pos_embed", "img_pos_embed"]
    assert treport.unmapped == (["vision_proj.weight (absent in checkpoint)"] if layout == "no_proj" else [])
    assert_same_checkpoint(tmp_path, "internvideo2-tiny-test", jtree, ttree)


def test_unknown_tensor_is_reported_not_dropped():
    sd = {**_sd("bare"), "decoder_head.weight": np.ones((2, 2), np.float32)}
    _, jreport = jconv.convert_internvideo2(sd, jiv2.IV2_TINY_TEST)
    _, treport = tconv.convert_internvideo2(sd, tiv2.IV2_TINY_TEST)
    assert_same_report(treport, jreport)
    assert treport.unmapped == ["decoder_head.weight"]


def test_converted_tower_matches_jax():
    sd = _sd("wrapper", seed=1)
    jtree, _ = jconv.convert_internvideo2(sd, jiv2.IV2_TINY_TEST)
    ttree, _ = tconv.convert_internvideo2(sd, tiv2.IV2_TINY_TEST)
    jtower = jiv2.InternVideo2Tower(jiv2.IV2_TINY_TEST)
    cfg = jiv2.IV2_TINY_TEST
    frames = np.random.default_rng(3).integers(0, 255, (2, cfg.num_frames, cfg.img_size, cfg.img_size, 3), np.uint8)
    init = fnn.meta.unbox(jtower.init(jax.random.PRNGKey(0), jnp.asarray(frames)))
    assert {k: np.shape(v) for k, v in leaves(init)} == {k: np.shape(v) for k, v in leaves(ttree)}
    want = np.asarray(jtower.apply(jtree, jnp.asarray(frames)))
    tower = tiv2.InternVideo2Tower(tiv2.IV2_TINY_TEST, dtype=torch.float32)
    load_flax_params(tower, ttree)
    with torch.no_grad():
        got = tower.eval()(torch.from_numpy(frames)).float().numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, atol=1e-5)


def test_converted_tower_matches_reference_tower():
    # skips, as tests/models/test_internvideo2.py does, where the vendored
    # reference implementation it loads is not checked out
    from tests.models.test_internvideo2 import IV2_MEAN, IV2_STD, _load_vendored

    cfg = tiv2.IV2_TINY_TEST
    torch.manual_seed(7)
    ref = _load_vendored()(
        img_size=cfg.img_size, patch_size=cfg.patch_size, embed_dim=cfg.embed_dim, depth=cfg.depth,
        num_heads=cfg.num_heads, mlp_ratio=cfg.mlp_ratio, qkv_bias=cfg.qkv_bias,
        qk_normalization=cfg.qk_normalization, init_values=cfg.init_values,
        attn_pool_num_heads=cfg.attn_pool_num_heads, clip_embed_dim=cfg.clip_embed_dim, num_frames=cfg.num_frames,
        tubelet_size=cfg.tubelet_size, clip_teacher_embed_dim=12, clip_teacher_final_dim=8, clip_return_layer=1,
        drop_path_rate=0.0,
    ).eval()
    vision_proj = torch.nn.Linear(cfg.clip_embed_dim, cfg.proj_dim)
    sd = {**ref.state_dict(), **{f"vision_proj.{k}": v for k, v in vision_proj.state_dict().items()}}
    tree, report = tconv.convert_internvideo2(sd, cfg)
    assert not report.unmapped
    frames = np.random.default_rng(3).integers(0, 255, (2, cfg.num_frames, cfg.img_size, cfg.img_size, 3), np.uint8)
    x = ((frames.astype(np.float32) / 255.0) - IV2_MEAN) / IV2_STD
    with torch.no_grad():
        _, pooled, _, _ = ref(torch.from_numpy(np.transpose(x, (0, 4, 1, 2, 3))))
        want = vision_proj(pooled)
        want = (want / want.norm(dim=-1, keepdim=True)).numpy()
        tower = tiv2.InternVideo2Tower(cfg, dtype=torch.float32)
        load_flax_params(tower, tree)
        got = tower.eval()(torch.from_numpy(frames)).float().numpy()
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=1e-4)


def test_generator_holds_the_full_width_tower():
    cfg = dataclasses.replace(tiv2.IV2_1B, depth=2)
    shapes = cp.internvideo2_shapes(cfg)
    with torch.device("meta"):
        tower = tiv2.InternVideo2Tower(cfg)
    skipped = sum(int(np.prod(shapes[k])) for k in ("clip_pos_embed", "img_pos_embed"))
    assert sum(int(np.prod(s)) for s in shapes.values()) - skipped == sum(p.numel() for p in tower.parameters())
    assert cfg.head_dim == 88
