"""Port parity: the HF checkpoint converters of ``models/convert_hf.py``
(CLIP vision, CLIP text, the aesthetic head, the T5 encoder) against the
JAX package's, at the reference's test widths, with numpy-seeded state
dicts under the public HF tensor names.

- (a) The same state dict (as torch tensors and as numpy arrays) through
  the JAX converter and the port's gives the same tree: keys, shapes,
  dtypes and bits; ``registry.save_params`` of the two packages writes the
  same bytes.
- (b) The port's models loaded from the converted tree match the JAX
  models loaded from the JAX converter's, atol 1e-4 / rtol 1e-3, in fp32.
- (c) Where ``transformers`` imports, the port's models match HF's own
  models built from config with the same weights, at the reference's bars
  (``tests/models/test_convert_hf.py``): CLIP 2e-4 / 1e-3, T5 3e-4 / 1e-3,
  the aesthetic head 1e-4 / 1e-4.
- (d) ``scripts/convert_phase.py``'s name-and-shape generator gives the
  names and shapes of ``transformers``' own ``state_dict()``, and its HF
  configs map back onto the port's full-size configs through the
  converters' ``*_config`` functions.
"""

from __future__ import annotations

import dataclasses
import importlib.util
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cosmos_curate_tpu.models import convert_hf as jconv
from cosmos_curate_tpu.models import registry as jregistry
from cosmos_curate_tpu_torch.models import convert_hf as tconv
from cosmos_curate_tpu_torch.models import registry as tregistry
from cosmos_curate_tpu_torch.models.convert_jax import load_flax_params

ATOL, RTOL = 1e-4, 1e-3
REPO = Path(__file__).resolve().parents[1]


def load_convert_phase():
    """``scripts/convert_phase.py`` as a module (its generator and HF
    configs; it imports nothing of the card at import)."""
    spec = importlib.util.spec_from_file_location("convert_phase", REPO / "scripts" / "convert_phase.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


cp = load_convert_phase()


def numpy_state_dict(shapes: dict, seed: int, *, tie: dict | None = None) -> dict[str, np.ndarray]:
    """numpy-seeded fp32 tensors of ``shapes``: norms near 1, the rest
    normal at 0.1 (large enough that a misrouted tensor shows)."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, shape in shapes.items():
        if tie and name in tie:
            continue
        a = (rng.standard_normal(shape) * 0.1).astype(np.float32)
        if name.endswith("weight") and any(s in name for s in cp._UNIT_SCALES) or name.endswith(".gamma"):
            a += 1.0
        out[name] = a
    for name, src in (tie or {}).items():
        out[name] = out[src]
    return out


def as_torch(sd: dict) -> dict[str, torch.Tensor]:
    return {k: torch.from_numpy(v.copy()) for k, v in sd.items()}


def leaves(tree, path=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from leaves(v, f"{path}/{k}")
        else:
            yield f"{path}/{k}", v


def assert_same_tree(got: dict, want: dict) -> None:
    """Same keys, shapes, dtypes and bits."""
    g, w = dict(leaves(got)), dict(leaves(want))
    assert sorted(g) == sorted(w)
    for key in w:
        a, b = np.asarray(g[key]), np.asarray(w[key])
        assert a.shape == b.shape and a.dtype == b.dtype, key
        assert np.ascontiguousarray(a).tobytes() == np.ascontiguousarray(b).tobytes(), key


def assert_same_report(got, want) -> None:
    assert (got.mapped, got.vision_skipped, got.unmapped) == (want.mapped, want.vision_skipped, want.unmapped)


def assert_same_checkpoint(tmp_path: Path, model_id: str, jtree: dict, ttree: dict) -> None:
    """Both packages' ``save_params`` write the same bytes."""
    jpath = jregistry.save_params(model_id, jtree, root=tmp_path / "jax")
    tpath = tregistry.save_params(model_id, ttree, root=tmp_path / "port")
    assert jpath.read_bytes() == tpath.read_bytes()


# the reference's test widths (tests/models/test_convert_hf.py)
CLIP_VISION = SimpleNamespace(image_size=32, patch_size=8, hidden_size=64, intermediate_size=256, num_hidden_layers=2,
                              num_attention_heads=4, projection_dim=32, hidden_act="quick_gelu", layer_norm_eps=1e-5,
                              num_channels=3)
CLIP_TEXT = SimpleNamespace(vocab_size=64, hidden_size=32, intermediate_size=128, num_hidden_layers=2,
                            num_attention_heads=2, max_position_embeddings=16, projection_dim=16,
                            hidden_act="quick_gelu", layer_norm_eps=1e-5)
T5 = {
    "relu": SimpleNamespace(vocab_size=100, d_model=32, d_kv=16, d_ff=64, num_layers=2, num_heads=2,
                            relative_attention_num_buckets=8, relative_attention_max_distance=32, is_gated_act=False,
                            layer_norm_epsilon=1e-6),
    "gated-gelu": SimpleNamespace(vocab_size=100, d_model=32, d_kv=16, d_ff=64, num_layers=2, num_heads=2,
                                  relative_attention_num_buckets=8, relative_attention_max_distance=32,
                                  is_gated_act=True, layer_norm_epsilon=1e-6),
}
T5_TIE = {"encoder.embed_tokens.weight": "shared.weight"}


def _model(sd: dict, config) -> SimpleNamespace:
    return SimpleNamespace(state_dict=lambda: sd, config=config)


def _converted(family: str, kind: str = "numpy", seed: int = 0):
    """(HF config, state dict, JAX tree, port tree) for one family."""
    if family == "clip_vision":
        cfg, sd = CLIP_VISION, numpy_state_dict(cp.clip_vision_shapes(CLIP_VISION), seed)
        convert = "convert_clip_vision"
    elif family == "clip_text":
        cfg, sd = CLIP_TEXT, numpy_state_dict(cp.clip_text_shapes(CLIP_TEXT), seed)
        convert = "convert_clip_text"
    elif family.startswith("t5"):
        cfg = T5[family.split(":")[1]]
        sd, convert = numpy_state_dict(cp.t5_encoder_shapes(cfg), seed, tie=T5_TIE), "convert_t5_encoder"
    else:
        cfg, convert = None, "convert_aesthetic_head"
        sd = numpy_state_dict(cp.aesthetic_head_shapes(), seed)
        if family == "aesthetic:bare":
            sd = {k.removeprefix("layers."): v for k, v in sd.items()}
    arg_sd = as_torch(sd) if kind == "torch" else sd
    arg = arg_sd if cfg is None else _model(arg_sd, cfg)
    jarg = (as_torch(sd) if kind == "torch" else dict(sd))
    jarg = jarg if cfg is None else _model(jarg, cfg)
    return cfg, sd, getattr(jconv, convert)(jarg), getattr(tconv, convert)(arg)


FAMILIES = ["clip_vision", "clip_text", "t5:relu", "t5:gated-gelu", "aesthetic:layers", "aesthetic:bare"]
MODEL_IDS = {"clip_vision": "clip-vit-tiny-test", "clip_text": "clip-text-tiny-test", "t5:relu": "t5-encoder-tpu",
             "t5:gated-gelu": "t5-encoder-tpu", "aesthetic:layers": "aesthetics-mlp-tpu",
             "aesthetic:bare": "aesthetics-mlp-tpu"}


@pytest.mark.parametrize("kind", ["numpy", "torch"])
@pytest.mark.parametrize("family", FAMILIES)
def test_converter_matches_jax(family, kind, tmp_path):
    _, _, jtree, ttree = _converted(family, kind)
    assert_same_tree(ttree, jtree)
    assert_same_checkpoint(tmp_path, MODEL_IDS[family], jtree, ttree)


@pytest.mark.parametrize("family", ["clip_vision", "clip_text"])
def test_config_functions_match_jax(family):
    tfn, jfn = {"clip_vision": (tconv.clip_vision_config, jconv.clip_vision_config),
                "clip_text": (tconv.clip_text_config, jconv.clip_text_config)}[family]
    cfg = CLIP_VISION if family == "clip_vision" else CLIP_TEXT
    assert dataclasses.asdict(tfn(cfg)) == dataclasses.asdict(jfn(cfg))
    for bad in (dict(intermediate_size=3 * cfg.hidden_size), dict(hidden_act="silu")):
        with pytest.raises(ValueError) as te:
            tfn(SimpleNamespace(**{**vars(cfg), **bad}))
        with pytest.raises(ValueError) as je:
            jfn(SimpleNamespace(**{**vars(cfg), **bad}))
        assert str(te.value) == str(je.value)
    for act in ("relu", "gated-gelu"):
        assert dataclasses.asdict(tconv.t5_encoder_config(T5[act])) == dataclasses.asdict(
            jconv.t5_encoder_config(T5[act]))


def test_aesthetic_head_without_a_layer_raises_like_jax():
    sd = numpy_state_dict(cp.aesthetic_head_shapes(), 0)
    del sd["layers.6.weight"], sd["layers.6.bias"]
    for conv in (tconv, jconv):
        with pytest.raises(KeyError, match="sequential index 6"):
            conv.convert_aesthetic_head(sd)


# -- (b) the port's models against the JAX models ----------------------------


def _pixels(seed=0, size=32):
    return np.random.default_rng(seed).standard_normal((2, size, size, 3)).astype(np.float32)


def _ids(seed, vocab, shape, low=3):
    return np.random.default_rng(seed).integers(low, vocab - 4, shape).astype(np.int32)


def test_clip_vision_matches_jax_model():
    from cosmos_curate_tpu.models import vit as jvit
    from cosmos_curate_tpu_torch.models import vit as tvit

    _, _, jtree, ttree = _converted("clip_vision")
    jcfg, tcfg = jconv.clip_vision_config(CLIP_VISION), tconv.clip_vision_config(CLIP_VISION)
    pixels = _pixels()
    jpooled, jtokens = jvit.ViT(jcfg, dtype=jnp.float32).apply(jtree, jnp.asarray(pixels))
    model = tvit.ViT(tcfg, dtype=torch.float32)
    load_flax_params(model, ttree)
    with torch.no_grad():
        pooled, tokens = model.eval()(torch.from_numpy(pixels))
    np.testing.assert_allclose(pooled.numpy(), np.asarray(jpooled), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(tokens.numpy(), np.asarray(jtokens), atol=ATOL, rtol=RTOL)


def test_clip_text_matches_jax_model():
    from cosmos_curate_tpu.models import clip_text as jct
    from cosmos_curate_tpu_torch.models import clip_text as tct

    _, _, jtree, ttree = _converted("clip_text")
    ids = _ids(1, CLIP_TEXT.vocab_size, (2, 12))
    jpooled, jtokens = jct.CLIPTextEncoder(jconv.clip_text_config(CLIP_TEXT), dtype=jnp.float32).apply(
        jtree, jnp.asarray(ids))
    model = tct.CLIPTextEncoder(tconv.clip_text_config(CLIP_TEXT), dtype=torch.float32)
    load_flax_params(model, ttree)
    with torch.no_grad():
        pooled, tokens = model.eval()(torch.from_numpy(ids).long())
    np.testing.assert_allclose(pooled.numpy(), np.asarray(jpooled), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(tokens.float().numpy(), np.asarray(jtokens), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("act", ["relu", "gated-gelu"])
def test_t5_matches_jax_model(act):
    from cosmos_curate_tpu.models import t5 as jt5
    from cosmos_curate_tpu_torch.models import t5 as tt5

    _, _, jtree, ttree = _converted(f"t5:{act}")
    ids = _ids(3, 100, (2, 10), low=1)
    mask = np.ones((2, 10), bool)
    mask[1, 7:] = False
    want = np.asarray(jt5.T5Encoder(jconv.t5_encoder_config(T5[act]), dtype=jnp.float32).apply(
        jtree, jnp.asarray(ids), jnp.asarray(mask)))
    model = tt5.T5Encoder(tconv.t5_encoder_config(T5[act]), dtype=torch.float32)
    load_flax_params(model, ttree)
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(ids).long(), torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(got[mask], want[mask], atol=ATOL, rtol=RTOL)


def test_aesthetic_head_matches_jax_model():
    from cosmos_curate_tpu.models import clip as jclip
    from cosmos_curate_tpu_torch.models import clip as tclip

    _, _, jtree, ttree = _converted("aesthetic:layers")
    emb = np.random.default_rng(2).standard_normal((4, 768)).astype(np.float32)
    want = np.asarray(jclip.AestheticMLP().apply(jtree, jnp.asarray(emb)))
    model = tclip.AestheticMLP(768)
    load_flax_params(model, ttree)
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(emb)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


# -- (c) the port's models against HF's own ----------------------------------


def _hf_clip(family: str, seed: int):
    transformers = pytest.importorskip("transformers")
    if family == "clip_vision":
        cfg = transformers.CLIPVisionConfig(**{k: v for k, v in vars(CLIP_VISION).items()})
        cls = transformers.CLIPVisionModelWithProjection
    else:
        # eos_token_id=2 selects HF's argmax-EOT pooling, the port's rule
        cfg = transformers.CLIPTextConfig(**vars(CLIP_TEXT), eos_token_id=2)
        cls = transformers.CLIPTextModelWithProjection
    torch.manual_seed(seed)
    hf = cls(cfg).eval()
    return hf, (tconv.convert_clip_vision if family == "clip_vision" else tconv.convert_clip_text)(hf)


def test_clip_vision_matches_hf():
    from cosmos_curate_tpu_torch.models import vit as tvit

    hf, tree = _hf_clip("clip_vision", 0)
    model = tvit.ViT(tconv.clip_vision_config(hf.config), dtype=torch.float32)
    load_flax_params(model, tree)
    pixels = _pixels()
    with torch.no_grad():
        hf_out = hf(pixel_values=torch.from_numpy(pixels.transpose(0, 3, 1, 2)))
        hf_tokens = hf.vision_model.post_layernorm(hf_out.last_hidden_state).numpy()
        pooled, tokens = model.eval()(torch.from_numpy(pixels))
    np.testing.assert_allclose(pooled.numpy(), hf_out.image_embeds.numpy(), atol=2e-4, rtol=1e-3)
    np.testing.assert_allclose(tokens.numpy(), hf_tokens, atol=2e-4, rtol=1e-3)


def test_clip_text_matches_hf():
    from cosmos_curate_tpu_torch.models import clip_text as tct

    hf, tree = _hf_clip("clip_text", 1)
    model = tct.CLIPTextEncoder(tconv.clip_text_config(hf.config), dtype=torch.float32)
    load_flax_params(model, tree)
    ids = np.random.default_rng(1).integers(3, 60, (2, 12)).astype(np.int64)
    with torch.no_grad():
        hf_out = hf(input_ids=torch.from_numpy(ids))
        pooled, tokens = model.eval()(torch.from_numpy(ids))
    np.testing.assert_allclose(tokens.float().numpy(), hf_out.last_hidden_state.numpy(), atol=2e-4, rtol=1e-3)
    np.testing.assert_allclose(pooled.numpy(), hf_out.text_embeds.numpy(), atol=2e-4, rtol=1e-3)


def test_t5_matches_hf():
    transformers = pytest.importorskip("transformers")
    from cosmos_curate_tpu_torch.models import t5 as tt5

    c = T5["relu"]
    cfg = transformers.T5Config(vocab_size=c.vocab_size, d_model=c.d_model, d_kv=c.d_kv, d_ff=c.d_ff,
                                num_layers=c.num_layers, num_heads=c.num_heads,
                                relative_attention_num_buckets=c.relative_attention_num_buckets,
                                relative_attention_max_distance=c.relative_attention_max_distance, dropout_rate=0.0)
    torch.manual_seed(3)
    hf = transformers.T5EncoderModel(cfg).eval()
    model = tt5.T5Encoder(tconv.t5_encoder_config(cfg), dtype=torch.float32)
    load_flax_params(model, tconv.convert_t5_encoder(hf))
    ids = np.random.default_rng(3).integers(1, 100, (2, 10)).astype(np.int64)
    mask = np.ones((2, 10), bool)
    mask[1, 7:] = False
    with torch.no_grad():
        want = hf(input_ids=torch.from_numpy(ids), attention_mask=torch.from_numpy(mask.astype(np.int64)))
        got = model.eval()(torch.from_numpy(ids), torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(got[mask], want.last_hidden_state.numpy()[mask], atol=3e-4, rtol=1e-3)


def test_aesthetic_head_matches_published_layout():
    """A replica of the published sac-logos-ava1-l14-linearMSE layout
    (``nn.Sequential`` with dropouts), as the reference's test builds it."""
    from torch import nn

    from cosmos_curate_tpu_torch.models import clip as tclip

    torch.manual_seed(2)
    ref = nn.Sequential(nn.Linear(768, 1024), nn.Dropout(0.2), nn.Linear(1024, 128), nn.Dropout(0.2),
                        nn.Linear(128, 64), nn.Dropout(0.1), nn.Linear(64, 16), nn.Linear(16, 1)).eval()
    assert {k: tuple(v.shape) for k, v in ref.state_dict().items()} == {
        k.removeprefix("layers."): v for k, v in cp.aesthetic_head_shapes().items()}
    model = tclip.AestheticMLP(768)
    load_flax_params(model, tconv.convert_aesthetic_head(ref.state_dict()))
    emb = np.random.default_rng(2).standard_normal((4, 768)).astype(np.float32)
    with torch.no_grad():
        want = ref(torch.from_numpy(emb)).numpy()[:, 0]
        got = model.eval()(torch.from_numpy(emb)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


# -- (d) the generator against transformers ----------------------------------


def _hf_shapes(model) -> dict[str, tuple]:
    return {k: tuple(v.shape) for k, v in model.state_dict().items()}


@pytest.mark.parametrize("family", ["clip_vision", "clip_text", "t5:relu", "t5:gated-gelu"])
def test_generator_gives_transformers_names_and_shapes(family):
    transformers = pytest.importorskip("transformers")
    if family.startswith("clip"):
        hf, _ = _hf_clip(family, 0)
        want = (cp.clip_vision_shapes if family == "clip_vision" else cp.clip_text_shapes)(hf.config)
    else:
        c = T5[family.split(":")[1]]
        cfg = transformers.T5Config(vocab_size=c.vocab_size, d_model=c.d_model, d_kv=c.d_kv, d_ff=c.d_ff,
                                    num_layers=c.num_layers, num_heads=c.num_heads,
                                    relative_attention_num_buckets=c.relative_attention_num_buckets,
                                    feed_forward_proj="gated-gelu" if c.is_gated_act else "relu")
        hf = transformers.T5EncoderModel(cfg)
        assert cfg.is_gated_act == c.is_gated_act
        want = cp.t5_encoder_shapes(c)
    assert _hf_shapes(hf) == want


def test_hf_configs_map_back_to_the_full_size_configs():
    """The phase's HF configs of CLIP ViT-L/14, CLIP text L and t5-small,
    through the converters' config functions, give the configs the port
    serves them with."""
    from cosmos_curate_tpu_torch.models.clip import _CONFIGS, CLIPImageModel
    from cosmos_curate_tpu_torch.models.clip_text import CLIP_TEXT_L
    from cosmos_curate_tpu_torch.models.t5 import T5_SMALL

    l14 = _CONFIGS["clip-vit-l14-tpu"]
    assert dataclasses.replace(tconv.clip_vision_config(cp.hf_clip_vision(l14)), preprocess="clip") == l14
    assert tconv.clip_text_config(cp.hf_clip_text(CLIP_TEXT_L)) == CLIP_TEXT_L
    assert dataclasses.replace(tconv.t5_encoder_config(cp.hf_t5(T5_SMALL)), max_len=T5_SMALL.max_len) == T5_SMALL
    shapes = cp.clip_vision_shapes(cp.hf_clip_vision(l14))
    assert shapes["vision_model.embeddings.position_embedding.weight"] == (257, 1024)
    with torch.device("meta"):
        port = CLIPImageModel(l14)
    assert sum(int(np.prod(s)) for s in shapes.values()) == sum(p.numel() for p in port.parameters())
    assert cp.aesthetic_head_shapes()["layers.0.weight"] == (1024, 768)


def test_seeded_state_dict_is_seeded_and_ties():
    shapes = cp.t5_encoder_shapes(T5["relu"])
    a = cp.seeded_state_dict(shapes, 3, torch.device("cpu"), tie=T5_TIE)
    b = cp.seeded_state_dict(shapes, 3, torch.device("cpu"), tie=T5_TIE)
    assert {k: tuple(v.shape) for k, v in a.items()} == shapes
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert a["encoder.embed_tokens.weight"] is a["shared.weight"]
    assert abs(float(a["encoder.final_layer_norm.weight"].mean()) - 1.0) < 0.05


# -- serving a converted checkpoint through the stages -----------------------


def test_embedding_stage_serves_a_converted_clip_variant_like_jax(tmp_path, monkeypatch):
    """Fault repaired with this slice: the port's ``ClipEmbeddingStage``
    lacked the reference's ``clip_variant`` and always served ViT-B/16.
    Both packages' stages now name the variant's tower; the port's stage
    loads a converted checkpoint staged by either package's ``save_params``
    (the same bytes) and embeds with it: per-clip means of the unit frame
    embeddings, as the model loaded straight from the converted tree gives
    them."""
    from cosmos_curate_tpu.pipelines.video.stages.embedding import ClipEmbeddingStage as JStage
    from cosmos_curate_tpu_torch.data.model import Clip, FrameExtractionSignature, SplitPipeTask, Video
    from cosmos_curate_tpu_torch.models.clip import CLIPImageEmbeddings
    from cosmos_curate_tpu_torch.models.convert_jax import flax_to_state_dict
    from cosmos_curate_tpu_torch.pipelines.video.stages.embedding import ClipEmbeddingStage

    model_id = "clip-vit-tiny-test"
    assert JStage(variant="clip", clip_variant=model_id).model_name == model_id
    _, _, jtree, tree = _converted("clip_vision", seed=4)
    monkeypatch.setenv(tregistry.WEIGHTS_DIR_ENV, str(tmp_path))
    jregistry.save_params(model_id, jtree)
    stage = ClipEmbeddingStage(variant="clip", clip_variant=model_id, device="cpu")
    assert stage.model_name == model_id
    assert tregistry.weights_provenance(model_id).startswith("checkpoint:")
    stage.setup(None)
    sig = FrameExtractionSignature("fps", 2.0)
    rng = np.random.default_rng(5)
    clips = [Clip(source_video="v", span=(float(i), float(i + 1)),
                  extracted_frames={sig.key(): rng.integers(0, 256, (3, 32, 32, 3), dtype=np.uint8)})
             for i in range(2)]
    stage.process_data([SplitPipeTask(video=Video(path="v.mp4", clips=clips))])
    direct = CLIPImageEmbeddings(model_id, params=flax_to_state_dict(tree), device="cpu")
    direct.setup()
    for clip in clips:
        frames = direct.encode_frames(clip.extracted_frames[sig.key()])
        want = frames.mean(axis=0)
        want /= np.linalg.norm(want) + 1e-8
        np.testing.assert_array_equal(clip.embeddings[model_id], want)
