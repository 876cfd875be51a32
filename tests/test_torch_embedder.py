"""Port parity: the video-embed leg.

- ``VideoEmbedModel`` at ``VIDEO_EMBED_TINY_TEST`` against the JAX model
  holding the same parameters (its seeded init, carried over by
  ``models/convert_jax.py``), fp32 on the CPU at the whole-model bar (atol
  1e-4, rtol 1e-3). The JAX model hard-codes bf16 compute, so the test
  rebinds the embedder module's ``ViT`` and ``TemporalPooler`` to their fp32
  forms. It runs once as is (the einsum attention on both sides) and once
  with the flash route forced on both sides: the JAX ``_use_flash`` then
  runs the Pallas kernel in interpret mode, the port's runs the plain
  version of its flash kernel.
- The micro-batch planner against JAX's, and ``DevicePipeline`` on the
  CPU: submission order, the in-flight bound, abort, and batches given as
  rows that are stacked one micro-batch at a time.
- ``ClipEmbeddingStage.process_data`` against the JAX stage holding the
  same converted parameters, both in bf16 as both stages serve.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import flax.linen as fnn
import jax
import jax.numpy as jnp

from cosmos_curate_tpu.core.stage import WorkerMetadata as JWorkerMetadata
from cosmos_curate_tpu.data import model as jdata
from cosmos_curate_tpu.models import device_pipeline as jdp
from cosmos_curate_tpu.models import embedder as jemb
from cosmos_curate_tpu.models import layers as jlayers
from cosmos_curate_tpu.models import vit as jvit
from cosmos_curate_tpu.pipelines.video.stages import embedding as jstage
from cosmos_curate_tpu_torch.core.stage import WorkerMetadata
from cosmos_curate_tpu_torch.data import model as tdata
from cosmos_curate_tpu_torch.models import device_pipeline as tdp
from cosmos_curate_tpu_torch.models import embedder as temb
from cosmos_curate_tpu_torch.models import layers as tlayers
from cosmos_curate_tpu_torch.models.convert_jax import flax_to_state_dict, load_flax_params
from cosmos_curate_tpu_torch.pipelines.video.stages import embedding as tstage

ATOL, RTOL = 1e-4, 1e-3
TINY = jemb.VIDEO_EMBED_TINY_TEST


@pytest.fixture
def jax_fp32(monkeypatch):
    """The JAX embedder with fp32 compute, and its seeded params."""
    monkeypatch.setattr(jemb, "ViT", functools.partial(jvit.ViT, dtype=jnp.float32))
    monkeypatch.setattr(jemb, "TemporalPooler", functools.partial(jemb.TemporalPooler, dtype=jnp.float32))
    model = jemb.VideoEmbedModel(TINY)
    dummy = jnp.zeros((1, TINY.num_frames, 32, 32, 3), jnp.uint8)
    return model, fnn.meta.unbox(model.init(jax.random.PRNGKey(0), dummy))


def _frames(seed, b, t=4, size=32):
    return np.random.default_rng(seed).integers(0, 255, (b, t, size, size, 3), dtype=np.uint8)


def test_config_mirrors_match_field_for_field():
    for name in ("VIDEO_EMBED_BASE", "VIDEO_EMBED_512", "VIDEO_EMBED_256", "VIDEO_EMBED_TINY_TEST"):
        assert dataclasses.asdict(getattr(temb, name)) == dataclasses.asdict(getattr(jemb, name))
    assert {k: (dataclasses.asdict(c), i) for k, (c, i) in temb.VIDEO_EMBED_VARIANTS.items()} == {
        k: (dataclasses.asdict(c), i) for k, (c, i) in jemb.VIDEO_EMBED_VARIANTS.items()
    }
    assert tstage.EMBED_STAGE_TASK_BATCH == jstage.EMBED_STAGE_TASK_BATCH
    assert tdp.DEFAULT_MICRO_BATCH == jdp.DEFAULT_MICRO_BATCH
    assert tdp.IN_FLIGHT == jdp.DEFAULT_IN_FLIGHT


def test_bridge_maps_the_whole_tree(jax_fp32):
    """Every flax leaf of the embedder lands in one port parameter; the
    pooler's blocks keep their flax names (``pooler/t0`` -> ``pooler.t0``)."""
    _, params = jax_fp32
    sd = flax_to_state_dict(params)
    model = temb.VideoEmbedModel(temb.VIDEO_EMBED_TINY_TEST, dtype=torch.float32)
    assert set(model.state_dict()) == set(sd)
    assert len(sd) == len(jax.tree_util.tree_leaves(params))
    p = params["params"]["pooler"]
    np.testing.assert_array_equal(sd["pooler.t0.attn.q.weight"].numpy(), np.asarray(p["t0"]["attn"]["q"]["kernel"]).T)
    np.testing.assert_array_equal(sd["pooler.query"].numpy(), np.asarray(p["query"]))
    np.testing.assert_array_equal(sd["pooler.ln.weight"].numpy(), np.asarray(p["ln"]["scale"]))


@pytest.mark.parametrize("flash", [False, True], ids=["einsum", "flash-forced"])
def test_model_matches_jax(jax_fp32, monkeypatch, flash):
    jm, params = jax_fp32
    if flash:
        monkeypatch.setattr(jlayers, "_use_flash", lambda s, mask: mask is None)
        monkeypatch.setattr(tlayers, "_use_flash", lambda x, mask: mask is None)
    frames = _frames(1, 3)
    want = np.asarray(jm.apply(params, jnp.asarray(frames)))
    tm = temb.VideoEmbedModel(temb.VIDEO_EMBED_TINY_TEST, dtype=torch.float32)
    load_flax_params(tm, params)
    with torch.no_grad():
        got = tm(torch.from_numpy(frames)).numpy()
    assert got.shape == (3, TINY.output_dim)
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, atol=1e-5)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


def test_flash_route_on_the_cpu_is_the_plain_kernel_version(monkeypatch):
    """Forcing the flash route on the CPU calls the flash wrapper, whose CPU
    path is the plain version: fp32 logits, the same result as the einsum
    lines to fp32 rounding."""
    calls = []
    real = tlayers.flash_attention

    def spy(q, k, v, *, causal):
        calls.append(tuple(q.shape))
        return real(q, k, v, causal=causal)

    block = tlayers.TransformerBlock(32, 2, 16, dtype=torch.float32)
    x = torch.from_numpy(np.random.default_rng(2).standard_normal((2, 9, 32)).astype(np.float32))
    with torch.no_grad():
        einsum = block(x)
        monkeypatch.setattr(tlayers, "flash_attention", spy)
        monkeypatch.setattr(tlayers, "_use_flash", lambda x, mask: mask is None)
        flash = block(x)
    assert calls == [(2, 2, 9, 16)]
    np.testing.assert_allclose(flash.numpy(), einsum.numpy(), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("cap", [1, 2, 3, 5, 8, 32, 33, 64])
def test_micro_batch_plan_matches_jax(cap):
    assert tdp.micro_batch_cap(cap) == jdp.micro_batch_cap(cap)
    for n in range(0, 71):
        assert tdp.plan_micro_batches(n, tdp.micro_batch_cap(cap)) == jdp.plan_micro_batches(n, jdp.micro_batch_cap(cap))


def test_micro_batch_cap_rejects_zero():
    with pytest.raises(ValueError):
        tdp.micro_batch_cap(0)


def test_pipeline_order_bound_and_padding():
    seen = []

    def fn(x):
        seen.append(x.shape[0])
        return x.float() * 2

    pipe = tdp.DevicePipeline("test", fn, device="cpu", micro_batch=4)
    x = np.arange(11, dtype=np.int64)[:, None]
    out = pipe.run(x)
    np.testing.assert_array_equal(out, 2 * x)
    assert seen == [4, 4, 4]  # 4 + 4 + a remainder of 3 padded to 4
    assert [r.rows for r in pipe.records] == [4, 4, 3]
    assert [r.padded_rows for r in pipe.records] == [4, 4, 4]
    with pytest.raises(ValueError, match="empty batch"):
        pipe.run(np.zeros((0, 1)))

    for i in range(5):
        pipe.submit(np.full((2, 1), i), n_valid=1)
        assert len(pipe._pending) <= tdp.IN_FLIGHT
    assert pipe.pending == 5
    drained = pipe.drain()
    assert [h.tolist() for h in drained] == [[[2.0 * i]] for i in range(5)]
    assert pipe.pending == 0


@pytest.mark.parametrize("cap,n", [(4, 11), (8, 8), (8, 3), (32, 32)])
def test_pipeline_run_stacks_rows_per_micro_batch(cap, n):
    """A batch given as a sequence of rows gives what the stacked array
    gives, and each micro-batch's rows are read only after the previous
    micro-batch was dispatched."""
    events = []

    class Rows:
        def __init__(self, rows):
            self.rows = rows

        def __len__(self):
            return len(self.rows)

        def __getitem__(self, i):
            events.append(("row", i))
            return self.rows[i]

    def fn(x):
        events.append(("dispatch", x.shape[0]))
        return x.float().sum(dim=(1, 2))

    rows = [np.random.default_rng(i).integers(0, 255, (3, 2), dtype=np.uint8) for i in range(n)]
    pipe = tdp.DevicePipeline("test", fn, device="cpu", micro_batch=cap)
    got = pipe.run(Rows(rows))
    want = tdp.DevicePipeline("test", lambda x: x.float().sum(dim=(1, 2)), device="cpu", micro_batch=cap).run(
        np.stack(rows)
    )
    np.testing.assert_array_equal(got, want)
    plan = tdp.plan_micro_batches(n, tdp.micro_batch_cap(cap))
    expect = []
    for start, stop, padded in plan:
        expect += [("row", i) for i in range(start, stop)] + [("dispatch", padded)]
    assert events == expect
    assert [r.rows for r in pipe.records] == [stop - start for start, stop, _ in plan]


def test_pipeline_abort_drops_the_burst():
    def fn(x):
        if int(x[0, 0]) == 3:
            raise RuntimeError("device fault")
        return x.float()

    pipe = tdp.DevicePipeline("test", fn, device="cpu")
    for i in range(3):
        pipe.submit(np.full((1, 1), i))
    with pytest.raises(RuntimeError, match="device fault"):
        pipe.submit(np.full((1, 1), 3))
    assert pipe.pending == 0
    assert pipe.drain() == []
    pipe.submit(np.full((1, 1), 4))
    assert [r.tolist() for r in pipe.drain()] == [[[4.0]]]
    with pytest.raises(RuntimeError, match="in flight"):
        pipe.submit(np.zeros((1, 1)))
        pipe.run(np.zeros((1, 1)))
    with pytest.raises(RuntimeError, match="device fault"):
        pipe.drain()
        pipe.run(np.full((1, 1), 3))
    assert pipe.pending == 0


def test_encode_clips_takes_an_array_or_a_list_of_clips(monkeypatch):
    monkeypatch.setattr(temb, "EMBED_MICRO_BATCH", 2)
    emb = temb.VideoEmbedder(temb.VIDEO_EMBED_TINY_TEST, device="cpu")
    emb.setup(seed=0)
    frames = _frames(3, 5)
    stacked = emb.encode_clips(frames)
    listed = emb.encode_clips(list(frames))
    assert stacked.shape == (5, TINY.output_dim) and stacked.dtype == np.float32
    np.testing.assert_array_equal(listed, stacked)
    assert [r.padded_rows for r in emb.device_pipeline.records] == [2, 2, 1] * 2
    assert emb.encode_clips([]).shape == (0, TINY.output_dim)


def _tasks(data_mod, key, n_tasks=2, clips=3, frames=6, size=32):
    rng = np.random.default_rng(5)
    tasks = []
    for t in range(n_tasks):
        video = data_mod.Video(path=f"v{t}.mp4")
        for c in range(clips):
            f = rng.integers(0, 255, (frames, size, size, 3), dtype=np.uint8)
            video.clips.append(data_mod.Clip(source_video=video.path, extracted_frames={key: f}))
        video.clips.append(data_mod.Clip(source_video=video.path))  # no frames: skipped
        tasks.append(data_mod.SplitPipeTask(video=video))
    return tasks


@pytest.mark.parametrize("frames", [6, 4], ids=["sampled", "as-extracted"])
def test_stage_matches_jax_stage(frames):
    """Same seeded params and the same tasks through both stages (bf16
    compute, both pipelines); embeddings agree to bf16 rounding compounded
    over three blocks (observed <= 0.006 on unit vectors of 32). With 6
    frames a clip is sampled down to the model's 4; with 4 it goes to the
    pipeline as extracted."""
    js = jstage.ClipEmbeddingStage(variant="video", video_cfg=TINY)
    js.setup(JWorkerMetadata())
    params = flax_to_state_dict(js.model._params)
    ts = tstage.ClipEmbeddingStage(variant="video", video_cfg=temb.VIDEO_EMBED_TINY_TEST, params=params, device="cpu")
    ts.setup(WorkerMetadata())
    key = jdata.FrameExtractionSignature("fps", 2.0).key()
    assert key == tdata.FrameExtractionSignature("fps", 2.0).key() == ts.extraction.key()
    jt = js.process_data(_tasks(jdata, key, frames=frames))
    tt = ts.process_data(_tasks(tdata, key, frames=frames))
    assert ts.model_name == js.model_name
    n = 0
    for jtask, ttask in zip(jt, tt, strict=True):
        for jc, tc in zip(jtask.video.clips, ttask.video.clips, strict=True):
            assert (js.model_name in jc.embeddings) == (ts.model_name in tc.embeddings)
            if ts.model_name in tc.embeddings:
                got, want = tc.embeddings[ts.model_name], jc.embeddings[js.model_name]
                assert got.dtype == np.float32 and got.shape == (TINY.output_dim,)
                np.testing.assert_allclose(got, want, atol=2e-2)
                n += 1
    assert n == 6


def test_stage_refuses_what_is_not_ported(tmp_path, monkeypatch):
    """What the stage refuses: a variant neither package has, and ``iv2``
    (which requires trained weights) with neither ``params`` nor a staged
    checkpoint, at setup and before it builds the 1B tower, as the JAX
    stage's ``require_weights`` does: never a fallback to noise."""
    monkeypatch.setenv("CURATE_MODEL_WEIGHTS_DIR", str(tmp_path / "weights"))
    with pytest.raises(ValueError, match="unknown embedding variant"):
        tstage.ClipEmbeddingStage(variant="bogus", device="cpu")
    iv2 = tstage.ClipEmbeddingStage(variant="iv2", device="cpu")
    assert iv2.model_name == "internvideo2-1b-tpu" and iv2.model.require_weights
    with pytest.raises(RuntimeError, match="requires trained weights"):
        iv2.setup(WorkerMetadata())
    assert iv2.model.model is None
    stage = tstage.ClipEmbeddingStage(variant="video-256", device="cpu")
    assert stage.model.embedding_dim == 256 and stage.model_name == "video-embed-256-tpu"
    assert stage.resources.gpus == 0.0 and stage.batch_size == 8  # on the CPU: no card claimed
