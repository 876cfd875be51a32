"""Port parity: the CLIP text tower and its tokenizers.

- ``layers.Attention(causal=True)`` on its einsum path (what the CPU runs;
  the card sends the same call to the flash kernel's causal branch) and
  ``CLIPTextEncoder`` against the JAX modules on the same parameters (the
  JAX seeded init, carried over by ``models/convert_jax.py``): fp32 at the
  whole-model bar (atol 1e-4, rtol 1e-3), bf16 within 2e-2 of the output's
  largest magnitude; at ``CLIP_TEXT_TINY_TEST`` and at the B tower's width
  with its depth cut to 2.
- Trailing pads after EOT leave the pooled feature as it was (causal).
- ``CLIPTextEmbeddings.encode_texts`` as both packages serve it (bf16, the
  fallback tokenizer): unit-norm rows within the bf16 bar.
- ``CLIPTokenizer`` on a small ``vocab.json`` / ``merges.txt`` written here,
  and ``FallbackClipTokenizer``: the same ids.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

import flax.linen as fnn
import jax
import jax.numpy as jnp

from cosmos_curate_tpu.models import clip_text as jct
from cosmos_curate_tpu.models import layers as jlayers
from cosmos_curate_tpu.models import registry as jregistry
from cosmos_curate_tpu_torch.models import clip_text as tct
from cosmos_curate_tpu_torch.models import layers as tlayers
from cosmos_curate_tpu_torch.models import registry as tregistry
from cosmos_curate_tpu_torch.models.convert_jax import flax_to_state_dict, load_flax_params

ATOL, RTOL = 1e-4, 1e-3
BF16_SCALE = 2e-2
TINY = jct.CLIP_TEXT_TINY_TEST
B_DEPTH_2 = dataclasses.replace(jct.CLIP_TEXT_B, layers=2)
QUERIES = ["a dog runs across the field", "The camera PANS left over a city at night", "", "x" * 100]


@pytest.fixture(autouse=True)
def _weights_root(tmp_path, monkeypatch):
    assert jregistry.WEIGHTS_DIR_ENV == tregistry.WEIGHTS_DIR_ENV
    root = tmp_path / "weights"
    monkeypatch.setenv(jregistry.WEIGHTS_DIR_ENV, str(root))
    return root


def _dtypes(name):
    return (jnp.float32, torch.float32) if name == "fp32" else (jnp.bfloat16, torch.bfloat16)


def _assert_close(got, want, dtype):
    assert got.shape == want.shape and np.isfinite(got).all()
    if dtype == "fp32":
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    else:
        assert np.abs(got - want).max() <= BF16_SCALE * max(1.0, float(np.abs(want).max()))


def test_configs_mirror_the_reference_field_for_field():
    for name in ("CLIP_TEXT_B", "CLIP_TEXT_L", "CLIP_TEXT_TINY_TEST"):
        assert dataclasses.asdict(getattr(tct, name)) == dataclasses.asdict(getattr(jct, name)), name
    assert [f.name for f in dataclasses.fields(tct.CLIPTextConfig)] == [
        f.name for f in dataclasses.fields(jct.CLIPTextConfig)]
    assert tct.CLIPTextEmbeddings._CONFIGS.keys() == jct.CLIPTextEmbeddings._CONFIGS.keys()
    for name, cfg in jct.CLIPTextEmbeddings._CONFIGS.items():
        assert dataclasses.asdict(tct.CLIPTextEmbeddings._CONFIGS[name]) == dataclasses.asdict(cfg)
    for mid in ("clip-text-b-tpu", "clip-text-l-tpu"):
        assert mid in tregistry.registered_models() and mid in jregistry.registered_models()


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_causal_attention_einsum_path_matches_jax(dtype):
    jdtype, tdtype = _dtypes(dtype)
    x = np.random.default_rng(0).standard_normal((2, 11, 32)).astype(np.float32)
    jm = jlayers.Attention(4, 8, dtype=jdtype, causal=True)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))
    want = np.asarray(jm.apply(params, jnp.asarray(x)), np.float32)
    tm = tlayers.Attention(32, 4, 8, dtype=tdtype, causal=True)
    load_flax_params(tm, fnn.meta.unbox(params))
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).float().numpy()
    _assert_close(got, want, dtype)
    # causal: the first position attends to itself alone
    with torch.no_grad():
        first = tm(torch.from_numpy(x[:, :1])).float().numpy()
    _assert_close(got[:, :1], first, dtype)


def _ids(cfg, seed, b=3, t=12):
    """Rows of body ids with EOT (the top id) placed at 12, 7 and 3, padding
    (id 0) after it."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, cfg.vocab - 2, (b, t)).astype(np.int32)
    for row, eot in enumerate((t - 1, 6, 2)[:b]):
        ids[row, eot] = cfg.vocab - 1
        ids[row, eot + 1:] = 0
    return ids


def _encoders(cfg, dtype):
    jdtype, tdtype = _dtypes(dtype)
    jm = jct.CLIPTextEncoder(cfg, dtype=jdtype)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.zeros((1, 4), jnp.int32))
    tm = tct.CLIPTextEncoder(tct.CLIPTextConfig(**dataclasses.asdict(cfg)), dtype=tdtype)
    load_flax_params(tm, fnn.meta.unbox(params))
    return jm, params, tm


@pytest.mark.parametrize("cfg", [TINY, B_DEPTH_2], ids=["tiny-test", "b-depth-2"])
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_encoder_matches_jax(cfg, dtype):
    jm, params, tm = _encoders(cfg, dtype)
    ids = _ids(cfg, 1)
    want_pooled, want_tokens = jax.jit(jm.apply)(params, jnp.asarray(ids))
    with torch.no_grad():
        pooled, tokens = tm(torch.from_numpy(ids))
    assert pooled.dtype == tokens.dtype == torch.float32
    assert pooled.shape == (3, cfg.projection_dim) and tokens.shape == (3, 12, cfg.width)
    _assert_close(pooled.numpy(), np.asarray(want_pooled), dtype)
    _assert_close(tokens.numpy(), np.asarray(want_tokens, np.float32), dtype)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_trailing_pads_leave_the_pooled_feature(dtype):
    jm, params, tm = _encoders(TINY, dtype)
    ids = _ids(TINY, 2, t=8)
    wide = np.zeros((3, 16), np.int32)
    wide[:, :8] = ids
    with torch.no_grad():
        short, _ = tm(torch.from_numpy(ids))
        long, _ = tm(torch.from_numpy(wide))
    want_short, _ = jm.apply(params, jnp.asarray(ids))
    want_long, _ = jm.apply(params, jnp.asarray(wide))
    _assert_close(long.numpy(), short.numpy(), dtype)
    _assert_close(np.asarray(want_long), np.asarray(want_short), dtype)
    _assert_close(long.numpy(), np.asarray(want_long), dtype)


def test_embeddings_encode_texts_match_jax():
    j = jct.CLIPTextEmbeddings("clip-text-tiny-test")
    j.setup()
    t = tct.CLIPTextEmbeddings("clip-text-tiny-test", params=flax_to_state_dict(j._params), device="cpu")
    t.setup()
    want, got = j.encode_texts(QUERIES), t.encode_texts(QUERIES)
    assert got.shape == (len(QUERIES), TINY.projection_dim) and got.dtype == np.float32
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, atol=1e-5)
    _assert_close(got, want, "bf16")
    assert t.encode_texts([]).shape == j.encode_texts([]).shape == (0, TINY.projection_dim)
    assert t.provenance == j.provenance == "random"
    assert t.embedding_dim == j.embedding_dim and t.model_id_names == j.model_id_names
    ids = _ids(TINY, 3)
    _assert_close(t.encode_ids(ids), j.encode_ids(ids), "bf16")
    with pytest.raises(ValueError, match="unknown variant"):
        tct.CLIPTextEmbeddings("clip-text-h-tpu", device="cpu")


@pytest.fixture
def bpe_files(tmp_path):
    """A small CLIP-format vocabulary: every byte symbol, with and without
    the end-of-word marker, a few merges, and the two specials on top."""
    from cosmos_curate_tpu_torch.models.tokenizer import _gpt2_byte_encoder

    symbols = list(_gpt2_byte_encoder().values())
    vocab = {s: i for i, s in enumerate(symbols)}
    vocab.update({s + "</w>": len(symbols) + i for i, s in enumerate(symbols)})
    merges = [("d", "o"), ("do", "g</w>"), ("t", "h"), ("th", "e</w>"), ("c", "a"), ("ca", "m")]
    for a, b in merges:
        vocab.setdefault(a + b, len(vocab))
    vocab["<|startoftext|>"] = len(vocab)
    vocab["<|endoftext|>"] = len(vocab)
    (tmp_path / "vocab.json").write_text(json.dumps(vocab))
    (tmp_path / "merges.txt").write_text("#version: 0.2\n" + "\n".join(f"{a} {b}" for a, b in merges) + "\n")
    return tmp_path / "vocab.json", tmp_path / "merges.txt"


@pytest.mark.parametrize("text", QUERIES + ["the dog's camera: 42 dogs!", "  Café  déjà vu "])
def test_clip_tokenizer_matches_jax(text, bpe_files):
    j = jct.CLIPTokenizer.from_files(*bpe_files)
    t = tct.CLIPTokenizer.from_files(*bpe_files)
    assert (t.sot_id, t.eot_id) == (j.sot_id, j.eot_id)
    for max_len in (77, 8):
        ids = t.encode(text, max_len=max_len)
        assert ids == j.encode(text, max_len=max_len)
        assert ids[0] == t.sot_id and ids[-1] == t.eot_id and len(ids) <= max_len
        assert max(ids) == t.eot_id


@pytest.mark.parametrize("vocab", [64, 49408])
def test_fallback_tokenizer_matches_jax(vocab):
    j, t = jct.FallbackClipTokenizer(vocab), tct.FallbackClipTokenizer(vocab)
    for text in QUERIES:
        assert t.encode(text) == j.encode(text)
        assert t.encode(text, max_len=16) == j.encode(text, max_len=16)
    with pytest.raises(ValueError):
        tct.FallbackClipTokenizer(3)


def test_staged_bpe_files_pick_the_clip_tokenizer(bpe_files, _weights_root):
    d = _weights_root / "clip-text-b-tpu"
    d.mkdir(parents=True)
    for f in bpe_files:
        (d / f.name).write_bytes(f.read_bytes())
    tok = tct.clip_text_tokenizer("clip-text-b-tpu", tct.CLIP_TEXT_B)
    assert isinstance(tok, tct.CLIPTokenizer)
    assert isinstance(jct.clip_text_tokenizer("clip-text-b-tpu", jct.CLIP_TEXT_B), jct.CLIPTokenizer)
    assert isinstance(tct.clip_text_tokenizer("clip-text-l-tpu", tct.CLIP_TEXT_L), tct.FallbackClipTokenizer)
