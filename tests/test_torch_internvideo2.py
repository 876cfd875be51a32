"""Port parity: InternVideo2.

- ``sincos_3d_pos_embed`` and ``frames_to_tubelets``: exactly equal to the
  JAX functions.
- ``InternVideo2Tower`` at ``IV2_TINY_TEST`` against the JAX tower on the
  same parameters (its seeded init, carried over by
  ``models/convert_jax.py``), fp32 on the CPU at the whole-model bar (atol
  1e-4, rtol 1e-3). LayerScale initialises at 1e-5, which leaves every
  block close to the identity, so ``ls1`` / ``ls2`` are drawn from the seed
  (uniform 0.05-0.2, numpy) and given to both: then every block shows in
  the output.
- The MLP width at ``IV2_1B``, from both packages' shapes alone.
- ``ClipEmbeddingStage(variant="iv2-tiny-test")`` against the JAX stage
  under each package's ``SequentialRunner``, both serving one staged
  ``params.msgpack`` (with the drawn LayerScale) through their registries,
  in bf16: embeddings within the embed stage's bound (2e-2,
  ``test_torch_embedder.py``).
"""

import dataclasses

import numpy as np
import pytest
import torch

import flax.linen as fnn
import jax
import jax.numpy as jnp

from cosmos_curate_tpu.core.pipeline import run_pipeline as jrun_pipeline
from cosmos_curate_tpu.core.runner import SequentialRunner as JSequentialRunner
from cosmos_curate_tpu.data import model as jdata
from cosmos_curate_tpu.models import internvideo2 as jiv
from cosmos_curate_tpu.models import registry as jregistry
from cosmos_curate_tpu.pipelines.video.stages import embedding as jembed
from cosmos_curate_tpu_torch.core.pipeline import run_pipeline
from cosmos_curate_tpu_torch.core.runner import SequentialRunner
from cosmos_curate_tpu_torch.data import model as tdata
from cosmos_curate_tpu_torch.models import internvideo2 as tiv
from cosmos_curate_tpu_torch.models.convert_jax import load_flax_params
from cosmos_curate_tpu_torch.pipelines.video.stages import embedding as tembed

ATOL, RTOL = 1e-4, 1e-3
STAGE_TOL = 2e-2
TINY = jiv.IV2_TINY_TEST
TINY_ID = "internvideo2-tiny-test"


def _frames(seed, b, t, size):
    return np.random.default_rng(seed).integers(0, 256, (b, t, size, size, 3), dtype=np.uint8)


def drawn_layer_scale(params, seed: int = 11):
    """The flax params with every block's ``ls1`` / ``ls2`` drawn uniform in
    [0.05, 0.2) from ``seed`` (numpy)."""
    rng = np.random.default_rng(seed)
    tree = jax.tree_util.tree_map(np.asarray, fnn.meta.unbox(params))
    for name, block in tree["params"].items():
        if name.startswith("block_"):
            for ls in ("ls1", "ls2"):
                block[ls] = rng.uniform(0.05, 0.2, block[ls].shape).astype(np.float32)
    return tree


def test_configs_mirror_the_reference_field_for_field():
    for name in ("IV2_1B", "IV2_TINY_TEST"):
        assert dataclasses.asdict(getattr(tiv, name)) == dataclasses.asdict(getattr(jiv, name))
    assert {k: (dataclasses.asdict(c), i, r) for k, (c, i, r) in tiv.IV2_VARIANTS.items()} == {
        k: (dataclasses.asdict(c), i, r) for k, (c, i, r) in jiv.IV2_VARIANTS.items()
    }
    np.testing.assert_array_equal(np.asarray(tiv.IV2_MEAN, np.float32), jiv.IV2_MEAN)
    np.testing.assert_array_equal(np.asarray(tiv.IV2_STD, np.float32), jiv.IV2_STD)


@pytest.mark.parametrize("cfg", [jiv.IV2_TINY_TEST, jiv.IV2_1B], ids=["tiny-test", "1b"])
def test_sincos_table_is_exact(cfg):
    got = tiv.sincos_3d_pos_embed(cfg.embed_dim, cfg.grid)
    want = jiv.sincos_3d_pos_embed(cfg.embed_dim, cfg.grid)
    assert got.shape == (cfg.num_patches + 1, cfg.embed_dim) and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("cfg", [jiv.IV2_TINY_TEST, dataclasses.replace(jiv.IV2_TINY_TEST, tubelet_size=2,
                                                                        num_frames=4)],
                         ids=["tubelet-1", "tubelet-2"])
def test_tubelets_are_exact(cfg):
    frames = _frames(1, 2, cfg.num_frames, cfg.img_size)
    want = np.asarray(jiv.frames_to_tubelets(jnp.asarray(frames), cfg))
    got = tiv.frames_to_tubelets(torch.from_numpy(frames), tiv.IV2Config(**dataclasses.asdict(cfg))).numpy()
    assert got.shape == (2, cfg.num_patches, cfg.patch_dim)
    np.testing.assert_array_equal(got, want)


def test_tower_matches_jax_with_drawn_layer_scale():
    frames = _frames(2, 3, TINY.num_frames, TINY.img_size)
    jm = jiv.InternVideo2Tower(TINY, dtype=jnp.float32)
    apply = jax.jit(jm.apply)
    params = drawn_layer_scale(jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(frames[:1])))
    want = np.asarray(apply(params, jnp.asarray(frames)))
    tm = tiv.InternVideo2Tower(tiv.IV2_TINY_TEST, dtype=torch.float32)
    load_flax_params(tm, params)
    with torch.no_grad():
        got = tm(torch.from_numpy(frames)).numpy()
    assert got.shape == (3, TINY.proj_dim)
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, atol=1e-5)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    # the drawn LayerScale moves the output: the blocks are in the comparison
    flat = jax.tree_util.tree_map(np.asarray, params)
    for block in flat["params"].values():
        if "ls1" in block:
            block["ls1"][:] = TINY.init_values
            block["ls2"][:] = TINY.init_values
    assert np.abs(np.asarray(apply(flat, jnp.asarray(frames))) - want).max() > 100 * ATOL


def test_mlp_width_at_1b_without_building_it():
    shapes = jax.eval_shape(
        lambda: jiv.IV2Block(jiv.IV2_1B).init(jax.random.PRNGKey(0), jnp.zeros((1, 2, jiv.IV2_1B.embed_dim))))
    j_hidden = fnn.meta.unbox(shapes)["params"]["fc1"]["kernel"].shape[1]
    with torch.device("meta"):
        block = tiv.IV2Block(tiv.IV2_1B)
    assert tiv.IV2_1B.mlp_hidden == block.fc1.weight.shape[0] == j_hidden == 6144
    assert tiv.IV2_1B.head_dim == 88


def _tasks(data_mod, key, n_tasks=2, clips=3):
    """Clips of 5 frames at 32x32: the stage samples 2 and resizes to 28."""
    rng = np.random.default_rng(5)
    tasks = []
    for t in range(n_tasks):
        video = data_mod.Video(path=f"v{t}.mp4")
        for c in range(clips):
            f = rng.integers(0, 256, (5, 32, 32, 3), dtype=np.uint8)
            video.clips.append(data_mod.Clip(source_video=video.path, extracted_frames={key: f}))
        tasks.append(data_mod.SplitPipeTask(video=video))
    return tasks


def test_stage_matches_jax_stage_on_one_staged_checkpoint(tmp_path, monkeypatch):
    monkeypatch.setenv(jregistry.WEIGHTS_DIR_ENV, str(tmp_path / "weights"))
    jm = jiv.InternVideo2Tower(TINY)
    params = drawn_layer_scale(jm.init(jax.random.PRNGKey(3), jnp.zeros((1, 2, 28, 28, 3), jnp.uint8)))
    jregistry.save_params(TINY_ID, params)
    key = jdata.FrameExtractionSignature("fps", 2.0).key()
    js = jembed.ClipEmbeddingStage(variant="iv2-tiny-test")
    ts = tembed.ClipEmbeddingStage(variant="iv2-tiny-test", device="cpu")
    assert ts.model_name == js.model_name == TINY_ID and ts.variant == "video"
    jt = jrun_pipeline(_tasks(jdata, key), [js], runner=JSequentialRunner())
    tt = run_pipeline(_tasks(tdata, key), [ts], runner=SequentialRunner())
    n = 0
    for jtask, ttask in zip(jt, tt, strict=True):
        for jc, tc in zip(jtask.video.clips, ttask.video.clips, strict=True):
            got = tc.embeddings[TINY_ID]
            assert got.dtype == np.float32 and got.shape == (TINY.proj_dim,)
            np.testing.assert_allclose(got, jc.embeddings[TINY_ID], atol=STAGE_TOL)
            n += 1
    assert n == 6


def test_sampling_and_resize_match_jax():
    j = jiv.IV2Embedder(TINY)
    t = tiv.IV2Embedder(tiv.IV2_TINY_TEST, device="cpu")
    for total in (0, 1, 2, 5, 17, 64):
        np.testing.assert_array_equal(t.sample_frame_indices(total), j.sample_frame_indices(total))
    clips = _frames(4, 2, 3, 40)
    np.testing.assert_array_equal(np.asarray(t._resize(clips)), j._resize(clips))
    same = _frames(4, 1, 2, 28)
    assert t._resize(same) is same
