"""Port parity: the Qwen3 caption flavors (``qwen3`` vision variant,
qk-norm, interleaved m-rope, the MoE LM, the deepstack inputs of the
engine) against the JAX package, on the CPU at test widths.

- ``VLM`` at ``VLM_QWEN3VL_TINY_TEST`` (deepstack tower and MoE LM) and
  ``VLM_MOE_TINY_TEST`` (the ViT tower and MoE LM of the text-only slot):
  ``encode_images`` with its deepstack levels, and the contiguous and
  paged forwards with deepstack levels added after the first layers, in
  fp32, the JAX init carried across, atol 1e-4 / rtol 1e-3.
- The engine's greedy bf16 tokens at ``VLM_QWEN3VL_TINY_TEST``, paged and
  gather, against the JAX engine under ``test_torch_engine.py``'s rule (the
  logits within ``LOGIT_TOL`` at every compared step; a request's
  comparison stops at a step whose JAX top-2 margin is below twice that):
  multimodal and text-only requests under one shared prefix, admitted in
  one prefill bucket, then a multimodal and a text-only prompt that
  prefill in chunks while the others decode. Once more at a finite
  capacity factor, where the rows' padding and order decide which
  assignments drop.
- ``CaptionStage("qwen3moe-tiny-test")`` through ``run_pipeline`` against
  the JAX stage, from one JAX-written checkpoint, under the same rule.
- The Qwen3 configs and flavor specs equal the JAX originals field for
  field; ``VLM(VLM_QWEN3_VL_MOE_A3B)`` built on ``meta`` stores its experts
  in bf16 and holds under 70 GB of parameters.
- ``qwen3vl-moe-a3b`` refuses without tokenizer files and without weights;
  ``qwen3moe-a3b-lm`` refuses frame-bearing requests.
"""

from __future__ import annotations

import dataclasses
import zlib

import numpy as np
import pytest
import torch

import flax.linen as fnn
import jax
import jax.numpy as jnp

from cosmos_curate_tpu.core.pipeline import run_pipeline as jrun_pipeline
from cosmos_curate_tpu.core.runner import SequentialRunner as JSequentialRunner
from cosmos_curate_tpu.data import model as jdata
from cosmos_curate_tpu.models import registry as jregistry
from cosmos_curate_tpu.models.tokenizer import ByteTokenizer as JByteTokenizer
from cosmos_curate_tpu.models.vlm import CaptionEngine as JEngine
from cosmos_curate_tpu.models.vlm import CaptionRequest as JRequest
from cosmos_curate_tpu.models.vlm import SamplingConfig as JSampling
from cosmos_curate_tpu.models.vlm import SharedCaptionEngine as JShared
from cosmos_curate_tpu.models.vlm import model as jmodel
from cosmos_curate_tpu.pipelines.video.stages import captioning as jcap
from cosmos_curate_tpu_torch.core.pipeline import run_pipeline
from cosmos_curate_tpu_torch.core.runner import SequentialRunner
from cosmos_curate_tpu_torch.data import model as tdata
from cosmos_curate_tpu_torch.models import registry
from cosmos_curate_tpu_torch.models.convert_jax import flax_to_state_dict, load_flax_params
from cosmos_curate_tpu_torch.models.tokenizer import ByteTokenizer
from cosmos_curate_tpu_torch.models.vlm import CaptionEngine, CaptionRequest, SamplingConfig, SharedCaptionEngine
from cosmos_curate_tpu_torch.models.vlm import model as tmodel
from cosmos_curate_tpu_torch.pipelines.video import split as tsplit
from cosmos_curate_tpu_torch.pipelines.video.stages import captioning as tcap
from tests.fixtures.observability import observability_state  # noqa: F401  (autouse)
from tests.test_torch_caption_stage import _tasks, _windows
from tests.test_torch_engine import LOGIT_TOL, PREFIX, _record_logits
from tests.test_torch_qwen_vlm import write_gpt2_files

ATOL, RTOL = 1e-4, 1e-3
MODEL_ID = "caption-vlm-tpu"
QWEN3_CONFIGS = ("VLM_QWEN3_MOE_A3B", "VLM_QWEN3_VL_MOE_A3B", "VLM_QWEN3VL_TINY_TEST", "VLM_MOE_TINY_TEST")
QWEN3_FLAVORS = ("qwen3moe-a3b-lm", "qwen3vl-moe-a3b", "qwen3moe-tiny-test")


@pytest.fixture(autouse=True)
def _fresh_registries():
    JShared.reset()
    SharedCaptionEngine.reset()
    yield
    JShared.reset()
    SharedCaptionEngine.reset()


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32), atol=ATOL, rtol=RTOL)


def test_configs_and_flavors_mirror_jax_field_for_field():
    for name in QWEN3_CONFIGS:
        assert dataclasses.asdict(getattr(tmodel, name)) == dataclasses.asdict(getattr(jmodel, name)), name
    for flavor in QWEN3_FLAVORS:
        assert dataclasses.asdict(tmodel.vlm_flavor(flavor)) == dataclasses.asdict(jmodel.vlm_flavor(flavor))
    assert list(tmodel.VLM_FLAVORS) == list(jmodel.VLM_FLAVORS)


def test_full_size_model_on_meta_stores_experts_in_bf16():
    """Qwen3-VL-30B-A3B's parameters: the 48 x 128 experts (28.99 B) in
    bf16, everything else fp32, under 70 GB in all."""
    with torch.device("meta"):
        model = tmodel.VLM(tmodel.VLM_QWEN3_VL_MOE_A3B)
    experts = [p for n, p in model.named_parameters() if n.endswith((".moe.gate_up", ".moe.down"))]
    assert len(experts) == 2 * 48 and all(p.dtype == torch.bfloat16 for p in experts)
    assert sum(p.numel() for p in experts) == 48 * 128 * (2048 * 1536 + 768 * 2048)
    others = [p for n, p in model.named_parameters() if not n.endswith((".moe.gate_up", ".moe.down"))]
    assert all(p.dtype == torch.float32 for p in others)
    total = sum(p.numel() * p.element_size() for p in model.parameters())
    assert 60e9 < total < 70e9, total
    assert model.vision.cfg.head_dim == 72 and len(model.vision.cfg.deepstack_indexes) == 3


def _jax_vlm(jcfg, seed=0):
    model = jmodel.VLM(jcfg, dtype=jnp.float32)
    size = (jcfg.qwen_vision or jcfg.vision).image_size
    ck, cv = jmodel.init_cache(jcfg, 1, dtype=jnp.float32)
    params = model.init(
        jax.random.PRNGKey(seed), jnp.zeros((1, 2, size, size, 3), jnp.uint8), jnp.zeros((1, 4), jnp.int32),
        ck, cv, method=model.init_everything,
    )
    return model, fnn.meta.unbox(params)


@pytest.mark.parametrize("config", ["VLM_QWEN3VL_TINY_TEST", "VLM_MOE_TINY_TEST"])
def test_vlm_matches_jax_in_fp32(config):
    """Vision tokens of 3 frames (with the deepstack levels of the qwen3
    tower; the ViT flavor gets seeded levels), then one prefill of
    [text][vision][text] with the levels at the vision span, through the
    contiguous and the paged forward, on random prior cache contents."""
    jcfg, tcfg = getattr(jmodel, config), getattr(tmodel, config)
    jm, params = _jax_vlm(jcfg)
    tm = tmodel.VLM(tcfg, dtype=torch.float32)
    load_flax_params(tm, params)
    qwen3 = tcfg.vision_variant == "qwen3"
    size = (jcfg.qwen_vision or jcfg.vision).image_size
    frames = np.random.default_rng(1).integers(0, 255, (2, 3, size, size, 3), np.uint8)
    want_vis = jm.apply(params, jnp.asarray(frames), method=jm.encode_images)
    with torch.no_grad():
        vis = tm.eval().encode_images(torch.from_numpy(frames))
    rng = np.random.default_rng(2)
    if qwen3:
        (vis, ds_vis), (want_vis, want_ds) = vis, want_vis
        assert ds_vis.shape == (2, 2, jcfg.qwen_vision.tokens_out(3), jcfg.dim)
        _close(ds_vis, want_ds)
    else:
        want_ds = rng.standard_normal((2, 2, vis.shape[1], jcfg.dim)).astype(np.float32)
    _close(vis, want_vis)

    n_pre, n_post = 3, 4
    n_vis = vis.shape[1]
    text = rng.standard_normal((2, n_pre + n_post, jcfg.dim)).astype(np.float32)
    embeds = np.concatenate([text[:, :n_pre], np.asarray(want_vis), text[:, n_pre:]], axis=1)
    t = embeds.shape[1]
    ds = np.zeros((2, 2, t, jcfg.dim), np.float32)
    ds[:, :, n_pre : n_pre + n_vis] = np.asarray(want_ds)
    if jcfg.mrope_section is not None:
        grid = jcfg.qwen_vision.merged_grid(3)
        rope, _ = jmodel.build_mrope_positions(n_pre, grid, n_post)
        pos = np.stack([rope, rope + 5]).astype(np.int32)
    else:
        pos = np.stack([np.arange(t), np.arange(t) + 5]).astype(np.int32)
    write = np.asarray([0, 5], np.int32)
    kv_len = write + t
    s, bs = 48, 16
    shape = (jcfg.n_layers, 2, s, jcfg.n_kv_heads, jcfg.head_dim)
    ck, cv = rng.standard_normal(shape).astype(np.float32), rng.standard_normal(shape).astype(np.float32)
    jl, jk, jv = jm.apply(params, *(jnp.asarray(x) for x in (embeds, ck, cv, pos, write, kv_len)),
                          deepstack=jnp.asarray(ds))
    tck, tcv = torch.from_numpy(ck.copy()), torch.from_numpy(cv.copy())
    with torch.no_grad():
        tl, _, _ = tm(torch.from_numpy(embeds), tck, tcv, *(torch.from_numpy(x) for x in (pos, write, kv_len)),
                      deepstack=torch.from_numpy(ds))
        no_ds, _, _ = tm(torch.from_numpy(embeds), torch.from_numpy(ck.copy()), torch.from_numpy(cv.copy()),
                         *(torch.from_numpy(x) for x in (pos, write, kv_len)))
    _close(tl, jl)
    _close(tck, jk)
    _close(tcv, jv)
    assert (tl - no_ds).abs().max() > 1e-3  # the levels reach the logits

    n_blocks = 2 * (s // bs) + 1
    pshape = (jcfg.n_layers, n_blocks, bs, jcfg.n_kv_heads, jcfg.head_dim)
    pk, pv = rng.standard_normal(pshape).astype(np.float32), rng.standard_normal(pshape).astype(np.float32)
    tables = rng.permutation(np.arange(1, n_blocks)).reshape(2, s // bs).astype(np.int32)
    ins = (embeds, pk, pv, pos, write, kv_len, tables)
    jl, jk, jv = jm.apply(params, *(jnp.asarray(x) for x in ins), deepstack=jnp.asarray(ds), method=jm.paged_forward)
    tk, tv = torch.from_numpy(pk.copy()), torch.from_numpy(pv.copy())
    with torch.no_grad():
        tl, _, _ = tm.paged_forward(torch.from_numpy(embeds), tk, tv,
                                    *(torch.from_numpy(x) for x in (pos, write, kv_len, tables)),
                                    deepstack=torch.from_numpy(ds))
    _close(tl, jl)
    _close(tk, jk)
    _close(tv, jv)


# (request id, text after the vision block, frames): a, b and c share a
# bucket (13-16 suffix tokens after the 41-token cached prefix), c without
# frames; "long" (a multimodal prompt) and "long-text" arrive while they
# decode and prefill in 32-token chunks
FIRST = (("a", "describe", 2), ("b", "what now", 2), ("c", "hi there you", 0))
LATER = (("long", "the camera pans across the scene. " * 2, 2), ("long-text", "a quiet street at dawn. " * 3, 0))
QWEN3_LANES = ((96, 4), (128, 2))


def _request(req_cls, sampling_cls, tok, rid, text, n_frames, size=32):
    frames = None
    if n_frames:
        frames = np.random.default_rng(zlib.crc32(rid.encode())).integers(0, 255, (n_frames, size, size, 3), np.uint8)
    return req_cls(request_id=rid, prefix_ids=tok.encode(PREFIX), prompt_ids=tok.encode(text), frames=frames,
                   sampling=sampling_cls(max_new_tokens=10))


def _drive(eng, req_cls, sampling_cls, tok):
    for rid, text, n in FIRST:
        eng.add_request(_request(req_cls, sampling_cls, tok, rid, text, n))
    eng.step()
    for rid, text, n in LATER:
        eng.add_request(_request(req_cls, sampling_cls, tok, rid, text, n))
    return {r.request_id: r.text for r in eng.run_until_complete()}


def _with_capacity(mod, factor):
    cfg = mod.VLM_QWEN3VL_TINY_TEST
    return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=factor))


@pytest.fixture(scope="module", params=[None, 1.0], ids=["no_drops", "capacity_1"])
def jax_drive(request):
    """The JAX engine at VLM_QWEN3VL_TINY_TEST (at capacity factor
    ``request.param``): (factor, params, logits trace, texts, stats)."""
    factor = request.param
    eng = JEngine(_with_capacity(jmodel, factor), max_batch=4, kv_lanes=QWEN3_LANES, tokenizer=JByteTokenizer(),
                  prefill_chunk=32)
    eng.setup(0)
    trace = _record_logits(eng)
    texts = _drive(eng, JRequest, JSampling, JByteTokenizer())
    stats = eng.stats()
    params = eng.params
    eng.shutdown()
    return factor, params, trace, texts, stats


def _compare(jtrace, ptrace, jtext, ptext) -> int:
    compared = 0
    for rid in sorted(jtext):
        full = True
        for step, (j, p) in enumerate(zip(jtrace[rid], ptrace[rid], strict=True)):
            assert np.abs(j - p).max() <= LOGIT_TOL, (rid, step)
            top2 = np.sort(j)[-2:]
            if top2[1] - top2[0] < 2 * LOGIT_TOL:
                print(f"{rid}: step {step} JAX top-2 margin {top2[1] - top2[0]:.4f} < {2 * LOGIT_TOL}; stop")
                full = False
                break
            assert int(np.argmax(j)) == int(np.argmax(p)), (rid, step)
            compared += 1
        if full:
            assert ptext[rid] == jtext[rid]
    return compared


@pytest.mark.parametrize("mode", ["auto", "gather"])
def test_engine_greedy_tokens_match_jax(jax_drive, mode, monkeypatch):
    factor, params, jtrace, jtext, jstats = jax_drive
    port = CaptionEngine(
        _with_capacity(tmodel, factor), max_batch=4, kv_lanes=QWEN3_LANES, tokenizer=ByteTokenizer(),
        prefill_chunk=32, params=flax_to_state_dict(params), paged_attention=mode, device="cpu",
    )
    port.setup(0)
    assert port._ds_levels == 2
    groups, chunks = [], []
    prefill_group, chunk_step = port._prefill_group, port._prefill_chunk_step

    def _group(lane, bucket, items):
        groups.append((bucket, sorted(it[1].request_id for it in items), [it[6] is not None for it in items]))
        return prefill_group(lane, bucket, items)

    def _chunk(lane):
        chunks.append(sorted(p.request.request_id for p in lane.pending.values()))
        return chunk_step(lane)

    port._prefill_group, port._prefill_chunk_step = _group, _chunk
    route_log = []
    moe_forward = tmodel.moe_forward
    monkeypatch.setattr(tmodel, "moe_forward", lambda *args: moe_forward(*args, route_log))
    ptrace = _record_logits(port)
    ptext = _drive(port, CaptionRequest, SamplingConfig, ByteTokenizer())
    assert set(ptext) == set(jtext) == {rid for rid, *_ in FIRST + LATER}
    assert port.stats()["prefill_tokens"] == jstats["prefill_tokens"]
    # ds and non-ds rows shared the first bucket; both later prompts chunked
    assert groups[0][1] == ["a", "b", "c"] and sorted(groups[0][2]) == [False, True, True]
    assert {"long", "long-text"} <= {rid for c in chunks for rid in c}
    assert port.vision_encodes == 3 and port.prefix_cache_hits >= 4
    # at capacity factor 1 a 4-row decode step holds 2 places an expert
    dropped = sum(int(d) for _, _, d in route_log)
    assert dropped > 0 if factor is not None else dropped == 0
    assert _compare(jtrace, ptrace, jtext, ptext) >= 20
    port.shutdown()


@pytest.fixture
def moe_checkpoint(tmp_path, monkeypatch):
    """One checkpoint of the qwen3moe-tiny-test flavor written by the JAX
    registry, in a temporary staging dir."""
    monkeypatch.setenv(jregistry.WEIGHTS_DIR_ENV, str(tmp_path))
    eng = JEngine(jmodel.VLM_MOE_TINY_TEST, max_batch=2)
    eng.setup(3)
    params = eng.params
    eng.shutdown()
    jregistry.save_params(MODEL_ID, params, root=tmp_path)
    return params


def _piped(stage_mod, data, run, runner, stage, tasks):
    """Caption prep -> the stage through ``run_pipeline``; the engine's
    logits recorded from its first request on."""
    sig = data.FrameExtractionSignature("fps", 8.0)
    stage.setup(None)
    trace = _record_logits(stage.model.engine)
    out = run(tasks, [stage_mod.CaptionPrepStage(extraction=sig, frames_per_window=2), stage], runner=runner)
    rids = [f"{c.uuid}-{i}" for t in out for c in t.video.clips for i in range(len(c.windows))]
    return [trace[r] for r in rids], [w.caption[stage.prompt_variant] for w in _windows(out)]


def test_moe_stage_through_run_pipeline_matches_jax(moe_checkpoint):
    jstage = jcap.CaptionStage(model_flavor="qwen3moe-tiny-test", max_new_tokens=24)
    tstage = tcap.CaptionStage(model_flavor="qwen3moe-tiny-test", max_new_tokens=24, device="cpu")
    jtrace, jtext = _piped(jcap, jdata, jrun_pipeline, JSequentialRunner(), jstage, _tasks(jdata, n_tasks=4))
    ttrace, ttext = _piped(tcap, tdata, run_pipeline, SequentialRunner(), tstage, _tasks(tdata, n_tasks=4))
    # the engine serves the file's weights, the experts rounded once to bf16
    served = tstage.model.engine.model.state_dict()
    for name, value in flax_to_state_dict(moe_checkpoint).items():
        assert torch.equal(served[name], value.to(served[name].dtype)), name
    assert served["layers.0.moe.gate_up"].dtype == torch.bfloat16
    assert len(ttext) == len(jtext) == 8 and all(ttext)
    compared = 0
    for j_rows, t_rows, jt, tt in zip(jtrace, ttrace, jtext, ttext, strict=True):
        full = True
        for step, (j, p) in enumerate(zip(j_rows, t_rows, strict=True)):
            assert np.abs(j - p).max() <= LOGIT_TOL, step
            top2 = np.sort(j)[-2:]
            if top2[1] - top2[0] < 2 * LOGIT_TOL:
                full = False
                break
            assert int(np.argmax(j)) == int(np.argmax(p)), step
            compared += 1
        if full:
            assert tt == jt
    assert compared >= 20


def test_qwen3vl_refuses_without_tokenizer_or_weights(tmp_path, monkeypatch):
    """As ``qwen2vl-2b``: without staged tokenizer files both packages
    refuse at setup; with them but without weights the port refuses before
    it builds the 30B model."""
    monkeypatch.setenv(registry.WEIGHTS_DIR_ENV, str(tmp_path))
    spec = tmodel.vlm_flavor("qwen3vl-moe-a3b")
    assert spec.hf_chat and spec.require_weights and not spec.text_only
    with pytest.raises(FileNotFoundError, match="vocab.json"):
        jcap.CaptionStage(model_flavor="qwen3vl-moe-a3b").setup(None)
    stage = tcap.CaptionStage(model_flavor="qwen3vl-moe-a3b", device="cpu")
    assert stage.model.cfg == tmodel.VLM_QWEN3_VL_MOE_A3B and stage.model.kv_lanes == ((1024, 4), (4096, 2))
    with pytest.raises(FileNotFoundError, match="vocab.json"):
        stage.setup(None)
    write_gpt2_files(tmp_path / spec.model_id)
    stage = tcap.CaptionStage(model_flavor="qwen3vl-moe-a3b", device="cpu")
    with pytest.raises(RuntimeError, match="no staged weights"):
        stage.setup(None)
    assert stage.model.engine is None and not SharedCaptionEngine._engines


def test_text_only_flavor_refuses_frames_like_jax(tmp_path, monkeypatch):
    monkeypatch.setenv(registry.WEIGHTS_DIR_ENV, str(tmp_path))
    write_gpt2_files(tmp_path / "caption-qwen3moe-a3b-tpu")
    for mod in (tcap, jcap):
        kw = {"device": "cpu"} if mod is tcap else {}
        model = mod.CaptionStage(model_flavor="qwen3moe-a3b-lm", **kw).model
        assert model.text_only and model.hf_chat
        with pytest.raises(ValueError, match="(?i)text-only"):
            model.encode_prompt("describe", has_vision=True)
    got = tcap.CaptionStage(model_flavor="qwen3moe-a3b-lm", device="cpu").model.encode_prompt("hi", has_vision=False)
    want = jcap.CaptionStage(model_flavor="qwen3moe-a3b-lm").model.encode_prompt("hi", has_vision=False)
    assert got == want


@pytest.mark.parametrize("staged", ["nothing", "tokenizer"])
def test_split_caption_model_qwen3vl_refuses_without_staged_files(staged, tmp_path, monkeypatch):
    """``run_split(caption_model="qwen3vl-moe-a3b")`` resolves through the
    caption stage and refuses at its setup, as ``qwen2vl-2b`` does: without
    tokenizer files, then without weights (before the model is built)."""
    monkeypatch.setenv(registry.WEIGHTS_DIR_ENV, str(tmp_path / "weights"))
    if staged == "tokenizer":
        write_gpt2_files(tmp_path / "weights" / "caption-qwen3vl-moe-a3b-tpu")
    args = tsplit.SplitPipelineArgs(input_path=str(tmp_path / "videos"), output_path=str(tmp_path / "out"),
                                    captioning=True, caption_model="qwen3vl-moe-a3b", device="cpu")
    caption = next(s for s in tsplit.assemble_stages(args) if isinstance(s, tcap.CaptionStage))
    assert caption.model.model_id == "caption-qwen3vl-moe-a3b-tpu" and caption.model.cfg.moe is not None
    err, match = (FileNotFoundError, "vocab.json") if staged == "nothing" else (RuntimeError, "no staged weights")
    with pytest.raises(err, match=match):
        caption.setup(None)
    assert not SharedCaptionEngine._engines
