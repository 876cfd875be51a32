"""Port parity: the T5 caption encoder, its tokenizers and the caption
embedding stage.

- The relative-position bucket table over rel in [-1024, 1024]: exact.
- ``T5Encoder`` against the JAX module on the same parameters (its seeded
  init, carried over by ``models/convert_jax.py``): fp32 at the
  whole-model bar (atol 1e-4, rtol 1e-3), bf16 within 2e-2 of the output's
  largest magnitude, at ``T5_TINY_TEST`` (relu) and at a 2-layer
  gated-gelu variant.
- ``T5EncoderTPU.encode`` as both packages serve it (bf16): the same ids,
  masks and truncation (byte ids, and a staged ``tokenizer.json`` whose
  ``</s>`` survives truncation), embeddings within the bf16 bar.
- Both tokenizer guards, ``HFJsonTokenizer`` on a ``tokenizer.json`` built
  here with ``tokenizers``, and ``CaptionEmbeddingStage``: the same windows
  embedded, the same values.
"""

import dataclasses

import numpy as np
import pytest
import torch

import flax.linen as fnn
import jax
import jax.numpy as jnp

from cosmos_curate_tpu.data import model as jdata
from cosmos_curate_tpu.models import registry as jregistry
from cosmos_curate_tpu.models import t5 as jt5
from cosmos_curate_tpu.models import tokenizer as jtok
from cosmos_curate_tpu.pipelines.video.stages import caption_embedding as jce
from cosmos_curate_tpu_torch.data import model as tdata
from cosmos_curate_tpu_torch.models import registry as tregistry
from cosmos_curate_tpu_torch.models import t5 as tt5
from cosmos_curate_tpu_torch.models import tokenizer as ttok
from cosmos_curate_tpu_torch.models.convert_jax import flax_to_state_dict, load_flax_params
from cosmos_curate_tpu_torch.pipelines.video.stages import caption_embedding as tce

ATOL, RTOL = 1e-4, 1e-3
BF16_SCALE = 2e-2
GATED = dataclasses.replace(jt5.T5_TINY_TEST, act="gated-gelu", layers=2)
TEXTS = ["a dog runs across the field", "", "x" * 80, "the camera pans left over a city at night"]


@pytest.fixture(autouse=True)
def _weights_root(tmp_path, monkeypatch):
    """No staged checkpoint or tokenizer: both registries see an empty root."""
    assert jregistry.WEIGHTS_DIR_ENV == tregistry.WEIGHTS_DIR_ENV
    root = tmp_path / "weights"
    monkeypatch.setenv(jregistry.WEIGHTS_DIR_ENV, str(root))
    return root


def _cfg(cfg) -> tt5.T5Config:
    return tt5.T5Config(**dataclasses.asdict(cfg))


def _assert_bf16_close(got, want):
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    assert np.abs(got - want).max() <= BF16_SCALE * max(1.0, float(np.abs(want).max()))


def test_configs_mirror_the_reference_field_for_field():
    for name in ("T5_BASE", "T5_SMALL", "T5_TINY_TEST"):
        assert dataclasses.asdict(getattr(tt5, name)) == dataclasses.asdict(getattr(jt5, name)), name
    assert [f.name for f in dataclasses.fields(tt5.T5Config)] == [f.name for f in dataclasses.fields(jt5.T5Config)]
    assert tt5.T5EncoderTPU.MODEL_ID == jt5.T5EncoderTPU.MODEL_ID
    assert [f.name for f in dataclasses.fields(tt5.EncodedSample)] == [
        f.name for f in dataclasses.fields(jt5.EncodedSample)]
    assert tt5.T5EncoderTPU.MODEL_ID in tregistry.registered_models()
    assert tt5.T5EncoderTPU.MODEL_ID in jregistry.registered_models()


@pytest.mark.parametrize("num_buckets,max_distance", [(32, 128), (16, 64), (32, 256), (64, 512)])
def test_bucket_table_is_exact(num_buckets, max_distance):
    rel = np.arange(-1024, 1025, dtype=np.int32)
    want = np.asarray(jax.jit(lambda r: jt5.t5_relative_position_bucket(
        r, num_buckets=num_buckets, max_distance=max_distance))(jnp.asarray(rel)))
    got = tt5.t5_relative_position_bucket(torch.from_numpy(rel), num_buckets=num_buckets,
                                          max_distance=max_distance).numpy()
    np.testing.assert_array_equal(got, want)
    # and the [s, s] table the model builds, against the JAX module's
    s = 96
    bias = tt5.T5RelativeBias(_cfg(dataclasses.replace(jt5.T5_TINY_TEST, num_buckets=num_buckets,
                                                       max_distance=max_distance)))
    pos = np.arange(s)
    np.testing.assert_array_equal(bias.buckets(s).numpy(), np.asarray(jt5.t5_relative_position_bucket(
        jnp.asarray(pos[None, :] - pos[:, None]), num_buckets=num_buckets, max_distance=max_distance)))


def _ids_and_mask(seed, b=3, t=16, vocab=512):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, vocab, (b, t)).astype(np.int32)
    mask = np.ones((b, t), bool)
    mask[1, 10:] = False
    mask[2, 3:] = False
    return ids, mask


@pytest.mark.parametrize("cfg", [jt5.T5_TINY_TEST, GATED], ids=["relu", "gated-gelu-2-layers"])
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_encoder_matches_jax(cfg, dtype):
    ids, mask = _ids_and_mask(1)
    jdtype, tdtype = (jnp.float32, torch.float32) if dtype == "fp32" else (jnp.bfloat16, torch.bfloat16)
    jm = jt5.T5Encoder(cfg, dtype=jdtype)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(ids), jnp.asarray(mask))
    want = np.asarray(jax.jit(jm.apply)(params, jnp.asarray(ids), jnp.asarray(mask)))
    tm = tt5.T5Encoder(_cfg(cfg), dtype=tdtype)
    load_flax_params(tm, fnn.meta.unbox(params))
    with torch.no_grad():
        got = tm(torch.from_numpy(ids), torch.from_numpy(mask)).numpy()
    assert got.dtype == np.float32 and got.shape == (3, 16, cfg.dim)
    if dtype == "fp32":
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    else:
        _assert_bf16_close(got, want)


def _encoders(cfg, **kw):
    """The JAX T5EncoderTPU after setup (seeded init), and the port's on the
    same parameters on the CPU."""
    j = jt5.T5EncoderTPU(cfg, **kw.get("jax", {}))
    j.setup()
    t = tt5.T5EncoderTPU(_cfg(cfg), params=flax_to_state_dict(j._params), device="cpu", **kw.get("port", {}))
    t.setup()
    return j, t


def _assert_same_samples(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want, strict=True):
        assert g.text == w.text
        np.testing.assert_array_equal(g.tokens, w.tokens)
        np.testing.assert_array_equal(g.mask, w.mask)
        _assert_bf16_close(g.embedding, w.embedding)


def test_encode_matches_jax_on_byte_ids():
    j, t = _encoders(jt5.T5_TINY_TEST)
    assert isinstance(t.tokenizer, ttok.ByteTokenizer) and isinstance(j.tokenizer, jtok.ByteTokenizer)
    want, got = j.encode(TEXTS), t.encode(TEXTS)
    _assert_same_samples(got, want)
    # the byte tokenizer prepends BOS and appends no EOS; the 81-id row
    # truncates to max_len and pads T to it
    assert got[0].tokens[0] == ttok.ByteTokenizer.BOS and got[0].tokens[-1] != ttok.ByteTokenizer.EOS
    assert len(got[2].tokens) == jt5.T5_TINY_TEST.max_len == got[2].mask.shape[0]
    assert got[1].embedding.shape == (1, jt5.T5_TINY_TEST.dim)
    assert t.encode([]) == j.encode([]) == []
    # a short batch pads T to its next power of two
    assert t.encode(["abc"])[0].mask.shape == (4,)


WORDS = ["a", "dog", "runs", "across", "the", "field", "camera", "pans", "left", "over", "city", "at", "night"]


def _write_tokenizer_json(path, extra_id=None):
    """A word-level tokenizer.json whose post-processor appends ``</s>``;
    ``extra_id`` adds a token at that (sparse) id."""
    from tokenizers import Tokenizer, models, pre_tokenizers, processors

    vocab = {"<pad>": 0, "</s>": 1, "<unk>": 2, **{w: 3 + i for i, w in enumerate(WORDS)}}
    if extra_id is not None:
        vocab["<extra>"] = extra_id
    tok = Tokenizer(models.WordLevel(vocab, unk_token="<unk>"))
    tok.pre_tokenizer = pre_tokenizers.Whitespace()
    tok.post_processor = processors.TemplateProcessing(single="$A </s>", special_tokens=[("</s>", 1)])
    path.parent.mkdir(parents=True, exist_ok=True)
    tok.save(str(path))
    return path


@pytest.mark.parametrize("text", ["a dog runs across the field", "the zebra at night", "", "city " * 3])
def test_hf_json_tokenizer_matches_jax(text, tmp_path):
    path = _write_tokenizer_json(tmp_path / "tokenizer.json")
    j, t = jtok.HFJsonTokenizer(path), ttok.HFJsonTokenizer(path)
    assert (t.eos_id, t.pad_id, t.vocab_size) == (j.eos_id, j.pad_id, j.vocab_size) == (1, 0, 3 + len(WORDS))
    assert t.encode(text) == j.encode(text)
    assert t.encode(text)[-1] == t.eos_id
    ids = t.encode(text)
    assert t.decode(ids) == j.decode(ids) and t.decode_bytes(ids) == j.decode_bytes(ids)


def test_encode_with_a_staged_tokenizer_keeps_the_final_eos(_weights_root):
    _write_tokenizer_json(_weights_root / tt5.T5EncoderTPU.MODEL_ID / "tokenizer.json")
    j, t = _encoders(jt5.T5_TINY_TEST)
    assert isinstance(t.tokenizer, ttok.HFJsonTokenizer) and isinstance(j.tokenizer, jtok.HFJsonTokenizer)
    texts = ["a dog runs", " ".join(WORDS * 6)]  # 78 words + </s>: truncated to 64
    want, got = j.encode(texts), t.encode(texts)
    _assert_same_samples(got, want)
    assert len(got[1].tokens) == jt5.T5_TINY_TEST.max_len and got[1].tokens[-1] == 1
    assert got[0].tokens[-1] == 1 and len(got[0].tokens) == 4


@pytest.mark.parametrize("guard", ["checkpoint_without_tokenizer", "tokenizer_beyond_vocab"])
def test_tokenizer_guards_refuse_like_jax(guard, _weights_root):
    mid = tt5.T5EncoderTPU.MODEL_ID
    if guard == "checkpoint_without_tokenizer":
        jm = jt5.T5Encoder(jt5.T5_TINY_TEST)
        ids = jnp.zeros((1, 8), jnp.int32)
        jregistry.save_params(mid, jm.init(jax.random.PRNGKey(0), ids, jnp.ones((1, 8), bool)))
        err, match = FileNotFoundError, "tokenizer.json"
    else:
        _write_tokenizer_json(_weights_root / mid / "tokenizer.json", extra_id=600)
        err, match = ValueError, "601 ids"
    with pytest.raises(err, match=match):
        jt5.T5EncoderTPU(jt5.T5_TINY_TEST).setup()
    with pytest.raises(err, match=match):
        tt5.T5EncoderTPU(tt5.T5_TINY_TEST, device="cpu").setup()
    # an explicit tokenizer overrides the guards
    t = tt5.T5EncoderTPU(tt5.T5_TINY_TEST, tokenizer=ttok.ByteTokenizer(), device="cpu")
    if guard == "checkpoint_without_tokenizer":
        t.setup()
        assert t.encode(["ok"])[0].embedding.shape == (3, tt5.T5_TINY_TEST.dim)


def _tasks(data, captions_per_clip):
    clips = [data.Clip(source_video="v.mp4", span=(float(i), float(i + 1)),
                       windows=[data.Window(0, 8, caption=dict(c)) for c in caps])
             for i, caps in enumerate(captions_per_clip)]
    return [data.SplitPipeTask(video=data.Video(path="v.mp4", clips=clips))]


CAPTIONS = [
    [{"default": "a dog runs across the field"}, {"other": "only another variant"}],
    [{}, {"default": "", "other": "an empty default falls through"}],
    [{"default": "the camera pans left", "other": "ignored"}],
]


@pytest.mark.parametrize("variant", ["default", "other"])
def test_caption_embedding_stage_matches_jax(variant):
    j_stage = jce.CaptionEmbeddingStage(cfg=jt5.T5_TINY_TEST, prompt_variant=variant)
    j_stage.model.setup()
    t_stage = tce.CaptionEmbeddingStage(cfg=tt5.T5_TINY_TEST, prompt_variant=variant,
                                        params=flax_to_state_dict(j_stage.model._params), device="cpu")
    t_stage.model.setup()
    assert t_stage.resources.gpus == 0.0
    j_tasks = j_stage.process_data(_tasks(jdata, CAPTIONS))
    t_tasks = t_stage.process_data(_tasks(tdata, CAPTIONS))
    embedded = 0
    for j_clip, t_clip in zip(j_tasks[0].video.clips, t_tasks[0].video.clips, strict=True):
        for j_win, t_win in zip(j_clip.windows, t_clip.windows, strict=True):
            assert (t_win.t5_embedding is None) == (j_win.t5_embedding is None)
            if j_win.t5_embedding is not None:
                _assert_bf16_close(t_win.t5_embedding, j_win.t5_embedding)
                embedded += 1
    assert embedded == 4
