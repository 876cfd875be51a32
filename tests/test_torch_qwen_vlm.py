"""Port parity: the dense Qwen-VL caption path (``qwen2`` vision variant,
m-rope serving, the HF tokenizer, the chat template, the ``hf_chat`` caption
stage) against the JAX package, on the CPU at test widths.

- ``VLM`` at ``VLM_QWEN2VL_TINY_TEST`` and at an untied-head ``qwen2_5``
  variant of it (Qwen2.5-VL-7B's head and windowed tower, at test width):
  ``encode_images`` and the contiguous and paged forwards in fp32, the JAX
  init carried across, atol 1e-4 / rtol 1e-3.
- ``build_mrope_positions`` with ``t_scale`` != 1: exact. The engine's rope
  positions for a ``qwen2_5`` request with ``frame_fps`` set equal the JAX
  engine's (the temporal component scaled by ``tokens_per_second *
  temporal_patch_size / fps``).
- The engine's greedy bf16 tokens at ``VLM_QWEN2VL_TINY_TEST``, paged and
  gather, against the JAX engine under ``test_torch_engine.py``'s rule: the
  logits agree within ``LOGIT_TOL`` at every compared step, and comparison
  of a request stops at a step whose JAX top-2 margin is below twice that.
- ``HFVocabTokenizer`` and ``build_qwen_vl_chat`` give the JAX package's ids
  on a small GPT-2 vocabulary written to ``tmp_path``.
- ``CaptionStage("qwen-chat-tiny-test")`` against the JAX stage, from one
  JAX-written checkpoint and tokenizer, under the same logit rule.
- ``qwen2vl-2b`` / ``qwen25vl-7b`` refuse to set up without tokenizer files
  and without weights; the Qwen3 flavors construct (their parity is
  ``test_torch_qwen3_*.py``'s).
- The new configs and flavor specs equal the JAX originals field for field.
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import pytest
import torch

import flax.linen as fnn
import jax
import jax.numpy as jnp

from cosmos_curate_tpu.data import model as jdata
from cosmos_curate_tpu.models import registry as jregistry
from cosmos_curate_tpu.models import tokenizer as jtok
from cosmos_curate_tpu.models.tokenizer import ByteTokenizer as JByteTokenizer
from cosmos_curate_tpu.models.vlm import CaptionEngine as JEngine
from cosmos_curate_tpu.models.vlm import CaptionRequest as JRequest
from cosmos_curate_tpu.models.vlm import SamplingConfig as JSampling
from cosmos_curate_tpu.models.vlm import SharedCaptionEngine as JShared
from cosmos_curate_tpu.models.vlm import chat as jchat
from cosmos_curate_tpu.models.vlm import model as jmodel
from cosmos_curate_tpu.models.vlm import vision_qwen as jvq
from cosmos_curate_tpu.pipelines.video.stages import captioning as jcap
from cosmos_curate_tpu_torch.data import model as tdata
from cosmos_curate_tpu_torch.models import registry
from cosmos_curate_tpu_torch.models import tokenizer as ttok
from cosmos_curate_tpu_torch.models.convert_jax import flax_to_state_dict, load_flax_params
from cosmos_curate_tpu_torch.models.tokenizer import ByteTokenizer
from cosmos_curate_tpu_torch.models.vlm import CaptionEngine, CaptionRequest, SamplingConfig, SharedCaptionEngine
from cosmos_curate_tpu_torch.models.vlm import chat as tchat
from cosmos_curate_tpu_torch.models.vlm import model as tmodel
from cosmos_curate_tpu_torch.models.vlm import vision_qwen as tvq
from cosmos_curate_tpu_torch.pipelines.video.stages import captioning as tcap
from tests.test_torch_caption_stage import _captioned, _tasks
from tests.test_torch_engine import LANES, LOGIT_TOL, _record_logits, _request

ATOL, RTOL = 1e-4, 1e-3
MODEL_ID = "caption-vlm-tpu"


def _qwen25_tiny(mod, vq):
    """Qwen2.5-VL-7B's untied head and windowed tower at test width: a 32 px
    window over the 48 px tower's 3 x 3 merged grid (padded windows), full
    attention at block 1, 2 tokens a second."""
    vision = dataclasses.replace(
        vq.QWEN_VISION_TINY_TEST, variant="qwen2_5", intermediate_size=48, image_size=48, window_size=32,
        fullatt_block_indexes=(1,), tokens_per_second=2.0,
    )
    return dataclasses.replace(mod.VLM_QWEN2VL_TINY_TEST, qwen_vision=vision, tied_embeddings=False)


CONFIGS = {
    "qwen2vl-tiny": (jmodel.VLM_QWEN2VL_TINY_TEST, tmodel.VLM_QWEN2VL_TINY_TEST),
    "qwen25-untied-tiny": (_qwen25_tiny(jmodel, jvq), _qwen25_tiny(tmodel, tvq)),
}


@pytest.fixture(autouse=True)
def _fresh_registries():
    JShared.reset()
    SharedCaptionEngine.reset()
    yield
    JShared.reset()
    SharedCaptionEngine.reset()


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32), atol=ATOL, rtol=RTOL)


def _frames(seed, n, size, b=None):
    shape = (n, size, size, 3) if b is None else (b, n, size, size, 3)
    return np.random.default_rng(seed).integers(0, 255, shape, dtype=np.uint8)


def test_configs_and_flavors_mirror_jax_field_for_field():
    for name in ("VLM_QWEN2_2B", "VLM_QWEN25_7B", "VLM_QWEN2VL_TINY_TEST", "VLM_QWEN_CHAT_TINY_TEST"):
        assert dataclasses.asdict(getattr(tmodel, name)) == dataclasses.asdict(getattr(jmodel, name)), name
    assert [f.name for f in dataclasses.fields(tmodel.FlavorSpec)] == [
        f.name for f in dataclasses.fields(jmodel.FlavorSpec)
    ]
    for flavor in ("base", "tiny-test", "qwen2vl-2b", "qwen25vl-7b", "qwen-chat-tiny-test"):
        assert dataclasses.asdict(tmodel.vlm_flavor(flavor)) == dataclasses.asdict(jmodel.vlm_flavor(flavor))
    assert ttok.QWEN2_SPECIAL_TOKENS == jtok.QWEN2_SPECIAL_TOKENS
    assert tchat.DEFAULT_SYSTEM == jchat.DEFAULT_SYSTEM


def _jax_vlm(jcfg, seed=0):
    model = jmodel.VLM(jcfg, dtype=jnp.float32)
    size = jcfg.qwen_vision.image_size
    ck, cv = jmodel.init_cache(jcfg, 1, dtype=jnp.float32)
    params = model.init(
        jax.random.PRNGKey(seed), jnp.zeros((1, 2, size, size, 3), jnp.uint8), jnp.zeros((1, 4), jnp.int32),
        ck, cv, method=model.init_everything,
    )
    return model, fnn.meta.unbox(params)


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_vlm_matches_jax_in_fp32(config):
    """Vision tokens of 3 frames (2 temporal patches), then one prefill of
    [text][vision][text] under m-rope positions through the contiguous and
    the paged forward, on random prior cache contents."""
    jcfg, tcfg = CONFIGS[config]
    jm, params = _jax_vlm(jcfg)
    tm = tmodel.VLM(tcfg, dtype=torch.float32)
    load_flax_params(tm, params)
    assert (tm.lm_head is None) == tcfg.tied_embeddings and tm.projector is None
    frames = _frames(1, 3, jcfg.qwen_vision.image_size, b=2)
    want_vis = jm.apply(params, jnp.asarray(frames), method=jm.encode_images)
    with torch.no_grad():
        vis = tm.eval().encode_images(torch.from_numpy(frames))
    assert vis.shape == (2, jcfg.qwen_vision.tokens_out(3), jcfg.dim)
    _close(vis, want_vis)

    rng = np.random.default_rng(2)
    n_pre, n_post = 3, 4
    text = rng.standard_normal((2, n_pre + n_post, jcfg.dim)).astype(np.float32)
    embeds = np.concatenate([text[:, :n_pre], np.asarray(want_vis), text[:, n_pre:]], axis=1)
    t = embeds.shape[1]
    rope, _ = jmodel.build_mrope_positions(n_pre, jcfg.qwen_vision.merged_grid(3), n_post)
    pos = np.stack([rope, rope + 5]).astype(np.int32)
    write = np.asarray([0, 5], np.int32)
    kv_len = write + t
    s, bs = 48, 16
    shape = (jcfg.n_layers, 2, s, jcfg.n_kv_heads, jcfg.head_dim)
    ck, cv = rng.standard_normal(shape).astype(np.float32), rng.standard_normal(shape).astype(np.float32)
    jl, jk, jv = jm.apply(params, *(jnp.asarray(x) for x in (embeds, ck, cv, pos, write, kv_len)))
    tck, tcv = torch.from_numpy(ck.copy()), torch.from_numpy(cv.copy())
    with torch.no_grad():
        tl, _, _ = tm(torch.from_numpy(embeds), tck, tcv, *(torch.from_numpy(x) for x in (pos, write, kv_len)))
    _close(tl, jl)
    _close(tck, jk)
    _close(tcv, jv)

    n_blocks = 2 * (s // bs) + 1
    pshape = (jcfg.n_layers, n_blocks, bs, jcfg.n_kv_heads, jcfg.head_dim)
    pk, pv = rng.standard_normal(pshape).astype(np.float32), rng.standard_normal(pshape).astype(np.float32)
    tables = rng.permutation(np.arange(1, n_blocks)).reshape(2, s // bs).astype(np.int32)
    ins = (embeds, pk, pv, pos, write, kv_len, tables)
    jl, jk, jv = jm.apply(params, *(jnp.asarray(x) for x in ins), method=jm.paged_forward)
    tk, tv = torch.from_numpy(pk.copy()), torch.from_numpy(pv.copy())
    with torch.no_grad():
        tl, _, _ = tm.paged_forward(
            torch.from_numpy(embeds), tk, tv, *(torch.from_numpy(x) for x in (pos, write, kv_len, tables))
        )
    _close(tl, jl)
    _close(tk, jk)
    _close(tv, jv)


@pytest.mark.parametrize(
    "n_pre,grid,n_post,t_scale",
    [(5, (4, 3, 3), 7, 4.0 / 3.0), (0, (3, 2, 4), 2, 0.5), (2, (1, 2, 2), 0, 2.0), (3, (5, 8, 8), 4, 2.0 / 3.0)],
)
def test_mrope_positions_with_time_scale_exact(n_pre, grid, n_post, t_scale):
    got, got_next = tmodel.build_mrope_positions(n_pre, grid, n_post, t_scale)
    want, want_next = jmodel.build_mrope_positions(n_pre, grid, n_post, t_scale)
    np.testing.assert_array_equal(got, np.asarray(want))
    assert got_next == want_next
    assert got.dtype == np.int32


@pytest.mark.parametrize("frame_fps", [3.0, 1.5])
def test_engine_rope_positions_scale_time_like_jax(frame_fps):
    """A qwen2_5 request of 8 frames (4 temporal patches) sampled at
    ``frame_fps``: the temporal m-rope component is floor(t * 2 * 2 / fps),
    not t. Both engines prep the request alone (no shared-prefix cache),
    from the same weights."""
    jcfg, tcfg = CONFIGS["qwen25-untied-tiny"]
    jeng = JEngine(jcfg, max_batch=2, tokenizer=JByteTokenizer(), enable_prefix_cache=False)
    jeng.setup(0)
    teng = CaptionEngine(
        tcfg, max_batch=2, tokenizer=ByteTokenizer(), enable_prefix_cache=False,
        params=flax_to_state_dict(jeng.params), device="cpu",
    )
    teng.setup(0)
    tok = ByteTokenizer()
    frames = _frames(4, 8, 48)

    def request(req_cls, sampling_cls):
        return req_cls(
            request_id="r", prefix_ids=tok.encode("system: caption"), prompt_ids=tok.encode("describe"),
            frames=frames, frame_fps=frame_fps, sampling=sampling_cls(max_new_tokens=8),
        )

    want = jeng._prepare(request(JRequest, JSampling))
    got = teng._prepare(request(CaptionRequest, SamplingConfig))
    np.testing.assert_array_equal(got.rope, np.asarray(want.rope))
    assert got.next_rope == want.next_rope
    n_pre = len(tok.encode("system: caption"))
    t_col = got.rope[n_pre : n_pre + 36, 0] - n_pre
    assert np.unique(t_col).tolist() == [int(t * 4 / frame_fps) for t in range(4)]
    jeng.shutdown()
    teng.shutdown()


PROMPTS = (("a", "describe"), ("b", "what happens here"), ("c", "hi"), ("d", "the scene"), ("e", "motion?"),
           ("f", "who is there"))


def _drive(eng, req_cls, sampling_cls, tok):
    """Six multimodal requests (2 frames: one temporal patch, 4 vision
    tokens) sharing a prefix; once they decode, a long text prompt joins and
    prefills in chunks on the long lane."""
    for rid, text in PROMPTS:
        eng.add_request(_request(req_cls, sampling_cls, tok, rid, text))
    eng.step()
    transcript = "the camera pans across the scene. " * 3
    eng.add_request(_request(req_cls, sampling_cls, tok, "long", transcript, frames=0))
    return {r.request_id: r.text for r in eng.run_until_complete()}


@pytest.fixture(scope="module")
def jax_drive():
    """The JAX engine at VLM_QWEN2VL_TINY_TEST through test_torch_engine's
    drive: (params, logits trace, texts, stats)."""
    eng = JEngine(
        jmodel.VLM_QWEN2VL_TINY_TEST, max_batch=4, kv_lanes=LANES, tokenizer=JByteTokenizer(), prefill_chunk=32
    )
    eng.setup(0)
    trace = _record_logits(eng)
    texts = _drive(eng, JRequest, JSampling, JByteTokenizer())
    stats = eng.stats()
    params = eng.params
    eng.shutdown()
    return params, trace, texts, stats


@pytest.mark.parametrize("mode", ["auto", "gather"])
def test_engine_greedy_tokens_match_jax(jax_drive, mode):
    params, jtrace, jtext, jstats = jax_drive
    port = CaptionEngine(
        tmodel.VLM_QWEN2VL_TINY_TEST, max_batch=4, kv_lanes=LANES, tokenizer=ByteTokenizer(), prefill_chunk=32,
        params=flax_to_state_dict(params), paged_attention=mode, device="cpu",
    )
    port.setup(0)
    ptrace = _record_logits(port)
    ptext = _drive(port, CaptionRequest, SamplingConfig, ByteTokenizer())
    assert set(ptext) == set(jtext) == {rid for rid, _ in PROMPTS} | {"long"}
    assert port.stats()["prefill_tokens"] == jstats["prefill_tokens"]
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
    assert compared >= 20
    port.shutdown()


# a GPT-2-format vocabulary: the 256 byte tokens at ids 0-255, then one id
# per merge in file order (byte-encoder characters; "Ġ" is the space)
MERGES = [
    ("t", "h"), ("th", "e"), ("Ġ", "a"), ("i", "n"), ("e", "r"), ("Ġ", "th"), ("Ġth", "e"), ("o", "n"),
    ("a", "n"), ("Ġ", "c"), ("r", "e"), ("e", "s"), ("i", "s"), ("a", "t"), ("Ġ", "s"), ("e", "n"),
    ("o", "r"), ("Ġ", "d"), ("in", "g"), ("Ġ", "t"), ("Ġ", "i"), ("Ġa", "n"), ("Ġan", "d"), ("Ċ", "Ċ"),
    ("s", "t"), ("Ġ", "w"), ("a", "l"), ("Ġ", "o"), ("c", "r"), ("cr", "i"), ("cri", "b"), ("Ġ", "1"),
]


def write_gpt2_files(directory) -> None:
    enc = ttok._gpt2_byte_encoder()
    vocab = {enc[b]: b for b in range(256)}
    for left, right in MERGES:
        vocab.setdefault(left + right, len(vocab))
    directory.mkdir(parents=True, exist_ok=True)
    (directory / "vocab.json").write_text(json.dumps(vocab))
    (directory / "merges.txt").write_text("#version: 0.2\n" + "".join(f"{a} {b}\n" for a, b in MERGES))


TEXTS = [
    "Describe this video clip in detail: the subjects, their actions, the setting.",
    "It's 10 o'clock and they're crossing the street\n\nthen 2024 cars",
    "café naïve 中文 emoji \U0001f600  trailing   ",
    "",
]


@pytest.mark.parametrize("specials", ["qwen2", "tiny"])
def test_hf_tokenizer_and_chat_ids_match_jax(tmp_path, specials):
    write_gpt2_files(tmp_path)
    sp = None if specials == "qwen2" else dict(tmodel.VLM_FLAVORS["qwen-chat-tiny-test"].specials)
    jt = jtok.HFVocabTokenizer.from_gpt2_files(tmp_path / "vocab.json", tmp_path / "merges.txt", specials=sp)
    tt = ttok.HFVocabTokenizer.from_gpt2_files(tmp_path / "vocab.json", tmp_path / "merges.txt", specials=sp)
    assert (tt.eos_id, tt.pad_id, tt.vocab_size) == (jt.eos_id, jt.pad_id, jt.vocab_size)
    assert tt.eos_id == (sp or ttok.QWEN2_SPECIAL_TOKENS)["<|im_end|>"]
    for text in TEXTS:
        ids = tt.encode(text)
        assert ids == jt.encode(text), text
        assert tt.decode(ids + [tt.eos_id]) == jt.decode(ids + [jt.eos_id])
    assert any(i >= 256 for i in tt.encode(TEXTS[0]))  # merges applied
    for has_vision in (True, False):
        got = tchat.build_qwen_vl_chat(tt, TEXTS[0], has_vision=has_vision, specials=sp)
        want = jchat.build_qwen_vl_chat(jt, TEXTS[0], has_vision=has_vision, specials=sp)
        assert got == want


def test_hf_tokenizer_needs_regex(tmp_path, monkeypatch):
    """No fallback to ``re``: without the regex module the tokenizer fails."""
    import sys

    write_gpt2_files(tmp_path)
    monkeypatch.setitem(sys.modules, "regex", None)
    with pytest.raises(ImportError):
        ttok.HFVocabTokenizer.from_gpt2_files(tmp_path / "vocab.json", tmp_path / "merges.txt")


@pytest.fixture
def chat_checkpoint(tmp_path, monkeypatch):
    """One checkpoint of the qwen-chat-tiny-test flavor written by the JAX
    registry, with its GPT-2 tokenizer files, in a temporary staging dir."""
    monkeypatch.setenv(jregistry.WEIGHTS_DIR_ENV, str(tmp_path))
    eng = JEngine(jmodel.VLM_QWEN_CHAT_TINY_TEST, max_batch=2)
    eng.setup(3)
    params = eng.params
    eng.shutdown()
    jregistry.save_params(MODEL_ID, params, root=tmp_path)
    write_gpt2_files(tmp_path / MODEL_ID)
    return params


def test_chat_stage_matches_jax(chat_checkpoint):
    jstage = jcap.CaptionStage(model_flavor="qwen-chat-tiny-test", max_new_tokens=24)
    tstage = tcap.CaptionStage(model_flavor="qwen-chat-tiny-test", max_new_tokens=24, device="cpu")
    jtrace, jtext = _captioned(jcap, jdata, jstage, _tasks(jdata, n_tasks=4))
    ttrace, ttext = _captioned(tcap, tdata, tstage, _tasks(tdata, n_tasks=4))
    model = tstage.model
    assert isinstance(model.tokenizer, ttok.HFVocabTokenizer)
    assert model.engine.tokenizer is model.tokenizer and model.engine.tokenizer.eos_id == 502
    assert tstage._encoded_prompt == jstage._encoded_prompt
    served = model.engine.model.state_dict()
    for name, value in flax_to_state_dict(chat_checkpoint).items():
        assert torch.equal(served[name].float(), value), name
    assert len(ttext) == len(jtext) == 8
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


@pytest.mark.parametrize("flavor", ["qwen2vl-2b", "qwen25vl-7b"])
def test_real_flavors_refuse_without_tokenizer_or_weights(flavor, tmp_path, monkeypatch):
    """Without staged tokenizer files both packages refuse at setup; with
    them but without weights the port refuses before it builds the model."""
    monkeypatch.setenv(registry.WEIGHTS_DIR_ENV, str(tmp_path))
    spec = tmodel.vlm_flavor(flavor)
    assert spec.hf_chat and spec.require_weights
    with pytest.raises(FileNotFoundError, match="vocab.json"):
        jcap.CaptionStage(model_flavor=flavor).setup(None)
    stage = tcap.CaptionStage(model_flavor=flavor, device="cpu")
    assert stage.model.cfg == spec.cfg and stage.model.model_id == spec.model_id
    with pytest.raises(FileNotFoundError, match="vocab.json"):
        stage.setup(None)
    write_gpt2_files(tmp_path / spec.model_id)
    stage = tcap.CaptionStage(model_flavor=flavor, device="cpu")
    with pytest.raises(RuntimeError, match="no staged weights"):
        stage.setup(None)
    assert stage.model.engine is None and not SharedCaptionEngine._engines
    assert stage.model.tokenizer.eos_id == ttok.QWEN2_SPECIAL_TOKENS["<|im_end|>"]


@pytest.mark.parametrize("flavor", ["qwen3moe-a3b-lm", "qwen3vl-moe-a3b", "qwen3moe-tiny-test"])
def test_qwen3_flavors_are_not_ported(flavor):
    """Ported since ROADMAP item A6b: each Qwen3 flavor resolves to the JAX
    package's spec."""
    model = tcap.CaptionStage(model_flavor=flavor, device="cpu").model
    spec = jmodel.vlm_flavor(flavor)
    assert dataclasses.asdict(model.cfg) == dataclasses.asdict(spec.cfg)
    assert (model.model_id, model.hf_chat, model.text_only, model.kv_lanes) == (
        spec.model_id, spec.hf_chat, spec.text_only, spec.kv_lanes)


def test_text_only_flavor_refuses_frames():
    model = tcap._CaptionVLM(tmodel.VLM_TINY_TEST, 2, text_only=True, device="cpu")
    with pytest.raises(ValueError, match="text-only"):
        model.encode_prompt("describe", has_vision=True)
    assert model.encode_prompt("describe", has_vision=False)[0]


def test_vlm_refuses_moe_qk_norm_and_qwen3():
    """Since ROADMAP item A6b the VLM builds qk-norm, the MoE FFN and the
    qwen3 tower; it refuses only a vision variant the JAX package lacks."""
    base = tmodel.VLM_QWEN2VL_TINY_TEST
    qk = tmodel.VLM(dataclasses.replace(base, qk_norm=True))
    assert qk.layers[0].q_norm.weight.shape == (base.head_dim,)
    moe = tmodel.VLM(dataclasses.replace(base, moe=tmodel.MoEConfig(n_experts=4, top_k=2, hidden=32)))
    assert isinstance(moe.layers[0].moe, tmodel.MoEFFN) and not hasattr(moe.layers[0], "up")
    qwen3 = tmodel.VLM(tmodel.VLM_QWEN3VL_TINY_TEST)
    assert qwen3.vision.cfg.variant == "qwen3" and qwen3.projector is None
    with pytest.raises(ValueError, match="unknown vision variant"):
        tmodel.VLM(dataclasses.replace(base, vision_variant="qwen4"))
