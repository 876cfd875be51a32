"""Port parity: the Qwen checkpoint converters of ``models/convert_qwen.py``
(Qwen2 / Qwen2-VL / Qwen2.5-VL, Qwen3(-VL)-MoE) against the JAX package's,
at test widths, with numpy-seeded state dicts under the public HF tensor
names.

- (a) Every converter function of both packages on the same state dict:
  the same tree (keys, shapes, dtypes, bits) and the same
  ``ConversionReport``, over the layouts they accept (bare ``model.``,
  ``model.language_model.`` + ``model.visual.``, ``visual.``; tied and
  untied heads); the config functions give the same configs;
  ``merge_lm_params`` / ``merge_vision_params`` overlay the port's init
  tree (``convert_jax.state_dict_to_flax``) as the JAX ones overlay the
  flax init, without touching their input, and both packages'
  ``save_params`` write the same bytes.
- (b) The port's ``VLM`` loaded from the converted, merged checkpoint
  matches the JAX ``VLM`` loaded from the JAX one: the tower's tokens (and
  Qwen3's deepstack levels) and the contiguous prefill's logits, atol 1e-4
  / rtol 1e-3, in fp32.
- (c) Where ``transformers`` imports: Qwen2's logits against
  ``Qwen2ForCausalLM`` (3e-4 / 1e-3, the reference's bar), the Qwen2-VL
  tower against HF's (2e-4 / 1e-3), and the Qwen3-MoE text model's logits
  against ``Qwen3VLMoeTextModel`` (5e-4 / 1e-3).
- (d) ``scripts/convert_phase.py``'s generator gives the names and shapes
  of ``Qwen2VLForConditionalGeneration`` and
  ``Qwen3VLMoeForConditionalGeneration``; its HF configs of Qwen2-VL-2B and
  Qwen3-VL-30B-A3B map back onto the flavors' configs, and its shapes hold
  exactly the flavors' parameters.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

import flax.linen as fnn
import jax
import jax.numpy as jnp

from cosmos_curate_tpu.models import convert_qwen as jconv
from cosmos_curate_tpu.models.vlm import model as jmodel
from cosmos_curate_tpu_torch.models import convert_qwen as tconv
from cosmos_curate_tpu_torch.models.convert_jax import load_flax_params, state_dict_to_flax
from cosmos_curate_tpu_torch.models.vlm import model as tmodel
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
Q2_TIE = {"lm_head.weight": "model.language_model.embed_tokens.weight"}


def _tiny(mod, family):
    """The test width of each family as its checkpoint has it: Qwen2's q/k/v
    biases, Qwen3-VL-30B-A3B's untied head."""
    if family == "qwen2vl":
        return dataclasses.replace(mod.VLM_QWEN2VL_TINY_TEST, qkv_bias=True)
    return dataclasses.replace(mod.VLM_QWEN3VL_TINY_TEST, tied_embeddings=False)


def _qwen2_sd(seed=0, *, layout="vl", untied=False):
    """A Qwen2-VL state dict at ``VLM_QWEN2VL_TINY_TEST``: transformers'
    current layout (``vl``), the published files' (``hub``: ``model.`` +
    ``visual.``, no head when tied) or a text-only Qwen2 (``lm``)."""
    sd = numpy_state_dict(cp.qwen2_vl_shapes(cp.hf_qwen2_vl(_tiny(tmodel, "qwen2vl"))), seed,
                          tie=None if untied else Q2_TIE)
    if layout == "hub":
        sd = {k.replace("model.language_model.", "model.").replace("model.visual.", "visual."): v
              for k, v in sd.items() if untied or k != "lm_head.weight"}
    elif layout == "lm":
        sd = {k.replace("model.language_model.", "model."): v for k, v in sd.items() if "visual." not in k}
    return sd


def _qwen25_vision_sd(seed=0, depth=2, e=32, hidden=48, out=64):
    """A Qwen2.5-VL vision state dict (RMS norms, SwiGLU MLP)."""
    shapes = {"visual.patch_embed.proj.weight": (e, 3, 2, 8, 8)}
    for i in range(depth):
        b = f"visual.blocks.{i}."
        shapes.update({f"{b}norm1.weight": (e,), f"{b}norm2.weight": (e,), f"{b}attn.qkv.weight": (3 * e, e),
                       f"{b}attn.qkv.bias": (3 * e,), f"{b}attn.proj.weight": (e, e), f"{b}attn.proj.bias": (e,)})
        for name, shape in (("gate_proj", (hidden, e)), ("up_proj", (hidden, e)), ("down_proj", (e, hidden))):
            shapes[f"{b}mlp.{name}.weight"], shapes[f"{b}mlp.{name}.bias"] = shape, (shape[0],)
    shapes.update({"visual.merger.ln_q.weight": (e,), "visual.merger.mlp.0.weight": (4 * e, 4 * e),
                   "visual.merger.mlp.0.bias": (4 * e,), "visual.merger.mlp.2.weight": (out, 4 * e),
                   "visual.merger.mlp.2.bias": (out,)})
    return numpy_state_dict(shapes, seed)


def _qwen3_sd(seed=0, tied=False):
    ns = cp.hf_qwen3_vl_moe(_tiny(tmodel, "qwen3vl"))
    tie = {"lm_head.weight": "model.language_model.embed_tokens.weight"} if tied else None
    return ns, numpy_state_dict(cp.qwen3_vl_moe_shapes(ns), seed, tie=tie)


def _both(name, *args, **kw):
    """(JAX result, port result) of one converter function."""
    return getattr(jconv, name)(*args, **kw), getattr(tconv, name)(*args, **kw)


def _assert_same_conversion(jout, tout) -> None:
    for j, t in zip(jout, tout, strict=True):
        if isinstance(j, dict):
            assert_same_tree(t, j)
        else:
            assert_same_report(t, j)


CASES = {
    "qwen2_lm:vl": lambda: ("convert_qwen2_lm", (_qwen2_sd(), 2), {}),
    "qwen2_lm:hub": lambda: ("convert_qwen2_lm", (_qwen2_sd(layout="hub"), 2), {}),
    "qwen2_lm:lm": lambda: ("convert_qwen2_lm", (_qwen2_sd(layout="lm"), 2), {}),
    "qwen2_lm:untied": lambda: ("convert_qwen2_lm", (_qwen2_sd(layout="hub", untied=True), 2), {}),
    "qwen2_lm:torch": lambda: ("convert_qwen2_lm", (as_torch(_qwen2_sd()), 2), {}),
    "qwen2_vision:vl": lambda: ("convert_qwen2_vision", (_qwen2_sd(), 2), {}),
    "qwen2_vision:hub": lambda: ("convert_qwen2_vision", (_qwen2_sd(layout="hub"), 2), {}),
    "qwen2_vision:qwen2_5": lambda: ("convert_qwen2_vision", (_qwen25_vision_sd(), 2), {}),
    "qwen2_vl:vl": lambda: ("convert_qwen2_vl", (_qwen2_sd(), 2, 2), {}),
    "qwen2_vl:hub": lambda: ("convert_qwen2_vl", (_qwen2_sd(layout="hub"), 2, 2), {}),
    "qwen3_moe_lm:untied": lambda: ("convert_qwen3_moe_lm", (_qwen3_sd()[1], 2), {"tied_embeddings": False}),
    "qwen3_moe_lm:tied": lambda: ("convert_qwen3_moe_lm", (_qwen3_sd(tied=True)[1], 2), {"tied_embeddings": True}),
    "qwen3_moe_lm:bare": lambda: ("convert_qwen3_moe_lm", (
        {k.removeprefix("model.language_model."): v for k, v in _qwen3_sd()[1].items() if "visual" not in k}, 2), {}),
    "qwen3_moe_lm:torch": lambda: ("convert_qwen3_moe_lm", (as_torch(_qwen3_sd()[1]), 2), {}),
    "qwen3_vision": lambda: ("convert_qwen3_vision", (_qwen3_sd()[1], _tiny(tmodel, "qwen3vl").qwen_vision), {}),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_converter_matches_jax(case):
    name, args, kw = CASES[case]()
    jout, tout = _both(name, *args, **kw)
    _assert_same_conversion(jout, tout)
    report = tout[-1]
    assert not [u for u in report.unmapped if "visual" not in u], report.unmapped


def test_missing_vision_raises_like_jax():
    for conv in (jconv, tconv):
        with pytest.raises(KeyError, match="no visual"):
            conv.convert_qwen2_vision(_qwen2_sd(layout="lm"), 2)


def test_unmapped_tensor_is_reported_not_dropped():
    sd = {**_qwen2_sd(layout="hub"), "model.extra_proj.weight": np.ones((2, 2), np.float32),
          "visual.extra.weight": np.ones(3, np.float32)}
    jout, tout = _both("convert_qwen2_vl", sd, 2, 2)
    _assert_same_conversion(jout, tout)
    assert set(tout[-1].unmapped) == {"model.extra_proj.weight", "visual.extra.weight"}


def test_config_functions_match_jax():
    q2 = cp.hf_qwen2_vl(_tiny(tmodel, "qwen2vl"))
    ns3 = cp.hf_qwen3_vl_moe(_tiny(tmodel, "qwen3vl"))
    q25 = dict(depth=2, hidden_size=32, num_heads=4, out_hidden_size=64, intermediate_size=48, patch_size=8,
               temporal_patch_size=2, spatial_merge_size=2, in_channels=3, window_size=32,
               fullatt_block_indexes=[1])
    pairs = [("qwen2_lm_config", (q2,), {"max_seq": 64}),
             ("qwen3_moe_lm_config", (ns3.text_config,), {"max_seq": 64}),
             ("qwen2_vision_config", (q2.vision_config,), {"image_size": 32}),
             ("qwen2_vision_config", (type(q2)(**q25),), {"image_size": 48}),
             ("qwen3_vision_config", (ns3.vision_config,), {"image_size": 32})]
    for name, args, kw in pairs:
        j, t = _both(name, *args, **kw)
        assert dataclasses.asdict(t) == dataclasses.asdict(j), name


def _jax_vlm(jcfg, seed=0):
    model = jmodel.VLM(jcfg, dtype=jnp.float32)
    size = jcfg.qwen_vision.image_size
    ck, cv = jmodel.init_cache(jcfg, 1, dtype=jnp.float32)
    params = model.init(jax.random.PRNGKey(seed), jnp.zeros((1, 2, size, size, 3), jnp.uint8),
                        jnp.zeros((1, 4), jnp.int32), ck, cv, method=model.init_everything)
    return model, fnn.meta.unbox(params)


def _port_init_tree(tcfg, seed=0):
    model = tmodel.VLM(tcfg, dtype=torch.float32)
    model.init_weights(torch.Generator().manual_seed(seed))
    return model, state_dict_to_flax(model)


@pytest.mark.parametrize("family", ["qwen2vl", "qwen3vl"])
def test_merge_matches_jax_and_leaves_input(family, tmp_path):
    """The merged checkpoint: every converted leaf overlays the init tree of
    either package, in either package, with the same result; the init trees
    are left as they were."""
    jcfg, tcfg = _tiny(jmodel, family), _tiny(tmodel, family)
    if family == "qwen2vl":
        (jlm, jvis, _), (tlm, tvis, _) = _both("convert_qwen2_vl", _qwen2_sd(), 2, 2)
    else:
        sd = _qwen3_sd()[1]
        (jlm, _), (tlm, _) = _both("convert_qwen3_moe_lm", sd, tcfg.n_layers, tied_embeddings=False)
        (jvis, _), (tvis, _) = _both("convert_qwen3_vision", sd, tcfg.qwen_vision)
    _, jinit = _jax_vlm(jcfg)
    tm, tinit = _port_init_tree(tcfg)
    # the port's init tree has the flax init's structure
    assert sorted(k for k, _ in leaves(tinit)) == sorted(k for k, _ in leaves(jinit))
    before = {k: np.array(v) for k, v in leaves(tinit)}
    jmerged = jconv.merge_vision_params(jconv.merge_lm_params(jinit, jlm), jvis)
    tmerged = tconv.merge_vision_params(tconv.merge_lm_params(tinit, tlm), tvis)
    assert_same_tree(tmerged, jax.tree_util.tree_map(np.asarray, jmerged))
    assert all(np.array_equal(before[k], v) for k, v in leaves(tinit))
    assert_same_checkpoint(tmp_path, "caption-vlm-tpu", jax.tree_util.tree_map(np.asarray, jmerged), tmerged)
    load_flax_params(tm, tmerged)  # strict: the merged checkpoint covers the port's model


@pytest.mark.parametrize("family", ["qwen2vl", "qwen3vl"])
def test_converted_vlm_matches_jax(family):
    """The tower on 3 frames, then one prefill of [text][vision][text]
    (m-rope positions; Qwen3's deepstack levels at the vision span)."""
    jcfg, tcfg = _tiny(jmodel, family), _tiny(tmodel, family)
    if family == "qwen2vl":
        jlm, jvis, _ = jconv.convert_qwen2_vl(_qwen2_sd(1), 2, 2)
        tlm, tvis, _ = tconv.convert_qwen2_vl(_qwen2_sd(1), 2, 2)
    else:
        sd = _qwen3_sd(1)[1]
        jlm, _ = jconv.convert_qwen3_moe_lm(sd, 2, tied_embeddings=False)
        jvis, _ = jconv.convert_qwen3_vision(sd, jcfg.qwen_vision)
        tlm, _ = tconv.convert_qwen3_moe_lm(sd, 2, tied_embeddings=False)
        tvis, _ = tconv.convert_qwen3_vision(sd, tcfg.qwen_vision)
    jm, jinit = _jax_vlm(jcfg)
    params = jconv.merge_vision_params(jconv.merge_lm_params(jinit, jlm), jvis)
    tm, tinit = _port_init_tree(tcfg)
    load_flax_params(tm, tconv.merge_vision_params(tconv.merge_lm_params(tinit, tlm), tvis))
    size = jcfg.qwen_vision.image_size
    frames = np.random.default_rng(1).integers(0, 255, (2, 3, size, size, 3), np.uint8)
    want_vis = jm.apply(params, jnp.asarray(frames), method=jm.encode_images)
    with torch.no_grad():
        vis = tm.eval().encode_images(torch.from_numpy(frames))
    ds = None
    if family == "qwen3vl":
        (vis, ds_vis), (want_vis, want_ds) = vis, want_vis
        np.testing.assert_allclose(ds_vis.numpy(), np.asarray(want_ds), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(vis.numpy(), np.asarray(want_vis), atol=ATOL, rtol=RTOL)
    rng = np.random.default_rng(2)
    n_pre, n_post, n_vis = 3, 4, vis.shape[1]
    text = rng.standard_normal((2, n_pre + n_post, jcfg.dim)).astype(np.float32)
    embeds = np.concatenate([text[:, :n_pre], np.asarray(want_vis), text[:, n_pre:]], axis=1)
    t = embeds.shape[1]
    if family == "qwen3vl":
        ds = np.zeros((2, 2, t, jcfg.dim), np.float32)
        ds[:, :, n_pre : n_pre + n_vis] = np.asarray(want_ds)
    rope, _ = jmodel.build_mrope_positions(n_pre, jcfg.qwen_vision.merged_grid(3), n_post)
    pos = np.stack([rope, rope]).astype(np.int32)
    write, kv_len = np.zeros(2, np.int32), np.full(2, t, np.int32)
    shape = (jcfg.n_layers, 2, 48, jcfg.n_kv_heads, jcfg.head_dim)
    ck = np.zeros(shape, np.float32)
    kw = {} if ds is None else {"deepstack": jnp.asarray(ds)}
    jl, _, _ = jm.apply(params, *(jnp.asarray(x) for x in (embeds, ck, ck, pos, write, kv_len)), **kw)
    with torch.no_grad():
        tl, _, _ = tm(torch.from_numpy(embeds), torch.zeros(shape), torch.zeros(shape),
                      *(torch.from_numpy(x) for x in (pos, write, kv_len)),
                      deepstack=None if ds is None else torch.from_numpy(ds))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL, rtol=RTOL)


# -- (c) against HF's own models ---------------------------------------------


def test_qwen2_logits_match_hf():
    transformers = pytest.importorskip("transformers")
    from cosmos_curate_tpu_torch.models.vit import VIT_TINY_TEST

    cfg = transformers.Qwen2Config(vocab_size=128, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
                                   num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=64,
                                   rope_theta=10000.0, tie_word_embeddings=True, attention_dropout=0.0)
    torch.manual_seed(7)
    hf = transformers.Qwen2ForCausalLM(cfg).eval()
    ours = tconv.qwen2_lm_config(cfg, max_seq=32, vision=VIT_TINY_TEST, vision_tokens=4)
    lm, report = tconv.convert_qwen2_lm(hf.state_dict(), cfg.num_hidden_layers)
    assert not report.unmapped and set(report.mapped) >= set(hf.state_dict())
    model, init = _port_init_tree(ours)
    load_flax_params(model, tconv.merge_lm_params(init, lm))
    ids = np.random.default_rng(7).integers(0, 128, (2, 9))
    t = ids.shape[1]
    shape = (ours.n_layers, 2, ours.max_seq, ours.n_kv_heads, ours.head_dim)
    with torch.no_grad():
        embeds = model.eval().embed_tokens(torch.from_numpy(ids))
        logits, _, _ = model(embeds, torch.zeros(shape), torch.zeros(shape),
                             torch.arange(t).expand(2, t).int(), torch.zeros(2, dtype=torch.int32),
                             torch.full((2,), t, dtype=torch.int32))
        want = hf(input_ids=torch.from_numpy(ids)).logits.numpy()
    np.testing.assert_allclose(logits.numpy(), want, atol=3e-4, rtol=1e-3)


def test_qwen2_vision_tower_matches_hf():
    pytest.importorskip("transformers")
    from transformers.models.qwen2_vl.configuration_qwen2_vl import Qwen2VLVisionConfig
    from transformers.models.qwen2_vl.modeling_qwen2_vl import Qwen2VisionTransformerPretrainedModel

    from cosmos_curate_tpu_torch.models.vlm.vision_qwen import QwenVisionTower

    hf_cfg = Qwen2VLVisionConfig(depth=2, embed_dim=32, hidden_size=32, mlp_ratio=2.0, num_heads=4, patch_size=4,
                                 temporal_patch_size=2, spatial_merge_size=2, in_channels=3)
    torch.manual_seed(11)
    hf = Qwen2VisionTransformerPretrainedModel(hf_cfg).eval()
    cfg = tconv.qwen2_vision_config(hf_cfg, image_size=16)
    tree, report = tconv.convert_qwen2_vision({f"visual.{k}": v for k, v in hf.state_dict().items()}, hf_cfg.depth)
    assert not report.unmapped
    tower = QwenVisionTower(cfg, dtype=torch.float32)
    load_flax_params(tower, tree)
    for t, h, w in ((1, 4, 4), (2, 4, 4)):
        patches = np.random.default_rng(3).normal(size=(t * h * w, cfg.patch_dim)).astype(np.float32)
        with torch.no_grad():
            want = hf(torch.from_numpy(patches), grid_thw=torch.tensor([[t, h, w]])).numpy()
            got = tower.eval()(torch.from_numpy(patches)[None], (t, h, w))[0].numpy()
        np.testing.assert_allclose(got, want, atol=2e-4, rtol=1e-3)


def test_qwen3_moe_text_logits_match_hf():
    pytest.importorskip("transformers")
    from transformers.models.qwen3_vl_moe.configuration_qwen3_vl_moe import Qwen3VLMoeTextConfig
    from transformers.models.qwen3_vl_moe.modeling_qwen3_vl_moe import Qwen3VLMoeTextModel

    hf_cfg = Qwen3VLMoeTextConfig(vocab_size=128, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
                                  num_attention_heads=4, num_key_value_heads=2, head_dim=8, num_experts=4,
                                  num_experts_per_tok=2, moe_intermediate_size=16, max_position_embeddings=64,
                                  tie_word_embeddings=True,
                                  rope_scaling={"rope_type": "default", "mrope_section": [2, 1, 1]})
    torch.manual_seed(3)
    hf = Qwen3VLMoeTextModel(hf_cfg).eval()
    cfg = tconv.qwen3_moe_lm_config(hf_cfg, max_seq=64, mrope_section=None)
    lm, report = tconv.convert_qwen3_moe_lm(hf.state_dict(), cfg.n_layers, tied_embeddings=cfg.tied_embeddings)
    assert not report.unmapped and not report.vision_skipped
    model, init = _port_init_tree(cfg)
    load_flax_params(model, tconv.merge_lm_params(init, lm))
    ids = np.array([[3, 17, 42, 9, 77, 5]], np.int64)
    t = ids.shape[1]
    shape = (cfg.n_layers, 1, cfg.max_seq, cfg.n_kv_heads, cfg.head_dim)
    with torch.no_grad():
        hidden = hf(input_ids=torch.from_numpy(ids)).last_hidden_state.numpy()
        embeds = model.eval().embed_tokens(torch.from_numpy(ids))
        logits, _, _ = model(embeds, torch.zeros(shape), torch.zeros(shape), torch.arange(t)[None].int(),
                             torch.zeros(1, dtype=torch.int32), torch.full((1,), t, dtype=torch.int32))
    want = hidden @ lm["params"]["embed"]["embedding"].T  # tied head
    np.testing.assert_allclose(logits[0].numpy(), want[0], atol=5e-4, rtol=1e-3)


# -- (d) the generator -------------------------------------------------------


def test_generator_gives_transformers_names_and_shapes():
    transformers = pytest.importorskip("transformers")
    ns = cp.hf_qwen2_vl(tmodel.VLM_QWEN2VL_TINY_TEST)
    cfg = transformers.Qwen2VLConfig(**{k: v for k, v in vars(ns).items() if k != "vision_config"},
                                     vision_config=vars(ns.vision_config))
    hf = transformers.Qwen2VLForConditionalGeneration(cfg)
    assert {k: tuple(v.shape) for k, v in hf.state_dict().items()} == cp.qwen2_vl_shapes(ns)
    ns3 = cp.hf_qwen3_vl_moe(tmodel.VLM_QWEN3VL_TINY_TEST)
    cfg3 = transformers.Qwen3VLMoeConfig(text_config=vars(ns3.text_config), vision_config=vars(ns3.vision_config))
    hf3 = transformers.Qwen3VLMoeForConditionalGeneration(cfg3)
    assert {k: tuple(v.shape) for k, v in hf3.state_dict().items()} == cp.qwen3_vl_moe_shapes(ns3)


@pytest.mark.parametrize("flavor", ["qwen2vl-2b", "qwen3vl-moe-a3b"])
def test_hf_configs_map_back_to_the_flavors(flavor):
    """The phase's HF configs of the full-size flavors map back onto their
    configs, and their shapes hold exactly the flavor model's parameters
    (the tied head aside)."""
    cfg = tmodel.vlm_flavor(flavor).cfg
    if flavor == "qwen2vl-2b":
        ns = cp.hf_qwen2_vl(cfg)
        v = tconv.qwen2_vision_config(ns.vision_config, image_size=224)
        got = tconv.qwen2_lm_config(ns, max_seq=cfg.max_seq, vision_variant="qwen2", qwen_vision=v)
        shapes = cp.qwen2_vl_shapes(ns)
    else:
        ns = cp.hf_qwen3_vl_moe(cfg)
        v = tconv.qwen3_vision_config(ns.vision_config, image_size=224)
        # the serving capacity factor and the unused ViT slot are not checkpoint fields
        got = tconv.qwen3_moe_lm_config(ns.text_config, max_seq=cfg.max_seq, vision_variant="qwen3", qwen_vision=v,
                                        vision=cfg.vision)
        got = dataclasses.replace(got, moe=cfg.moe)
        shapes = cp.qwen3_vl_moe_shapes(ns)
    assert got == cfg
    with torch.device("meta"):
        model = tmodel.VLM(cfg)
    n_head = cfg.vocab * cfg.dim if cfg.tied_embeddings else 0
    assert sum(int(np.prod(s)) for s in shapes.values()) - n_head == sum(p.numel() for p in model.parameters())
