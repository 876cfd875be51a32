"""``chip_smoke.py``'s ``convert`` phase, which ``chip_smoke.py`` runs after
its ``train`` phase, or alone on the card's host.

Run from the repository root on a machine with one NVIDIA GPU:

    python3 scripts/convert_phase.py

The HF checkpoint converters (``models/convert_hf.py``,
``models/convert_qwen.py``, ``models/convert_iv2.py``) serving converted
weights. Nothing is downloaded: each checkpoint is a seeded fp32 state dict
under the public HF tensor names and shapes (this script's name-and-shape
generator, the ``*_shapes`` functions, which ``tests/test_torch_convert_*.py``
hold against ``transformers``' own ``state_dict()``), drawn on the card
from a ``torch.Generator`` and copied to the host. For each model it then
converts, stages into a temporary weights root through
``registry.save_params`` where a stage loads it, and serves through the
model's normal entry point with its weights required:

- CLIP ViT-L/14 vision (24 x 1024, 16 heads, patch 14, projection 768) and
  the aesthetic head (768 -> 1024 -> 128 -> 64 -> 16 -> 1), staged under
  ``clip-vit-l14-tpu`` / ``aesthetics-mlp-tpu``:
  ``ClipEmbeddingStage(variant="clip", clip_variant="clip-vit-l14-tpu")``
  and ``AestheticFilterStage(score_only=True)`` over ``CLIP_TASKS`` tasks.
  Flash launches are counted; the stage's clip embeddings are held against
  the same converted tree loaded through ``convert_jax.load_flax_params``
  into a ViT whose attention is flash's plain version, within the embed
  phase's bf16 bound (``chip_smoke.EMBED_BOUND``).
- CLIP text L (12 x 768) and the T5 encoder at google-t5/t5-small's shapes
  (``T5_SMALL``), staged under ``clip-text-l-tpu`` / ``t5-encoder-tpu``, one
  encode call each; CLIP text's causal flash launches are counted.
- Qwen2-VL-2B at full width and depth: ``convert_qwen2_vl`` ->
  ``merge_lm_params`` / ``merge_vision_params`` into the flavor's init tree
  (its structure: every leaf is overlaid) -> ``caption-qwen2vl-2b-tpu``,
  with ``chip_smoke.write_byte_vocab``'s tokenizer files.
  ``CaptionStage(model_flavor="qwen2vl-2b")`` captions ``QWEN_TASKS`` tasks
  of one short window each at ``QWEN_NEW_TOKENS`` new tokens; paged prefill
  and paged decode launch. The staged checkpoint reads back bit-equal to
  the converter's tree (a CRC-32 a leaf, compared).
- Qwen3-VL-30B-A3B and InternVideo2-1B at full width, converted and loaded
  with ``load_flax_params`` into a model of the cut depth on the card and
  run once (Qwen3: its tower, then a paged prefill and one paged decode
  step, held against the same forward on the plain attention;
  InternVideo2: the tower on one clip, plain attention at D = 88).
  Depth cuts (at full depth the fp32 host tensors are ~120 GB and ~4 GB):

  * Qwen3-VL-30B-A3B: 2 of 48 LM layers, 2 of 27 tower blocks, deepstack
    taps after tower blocks (0, 1) in place of (8, 16, 24);
  * InternVideo2-1B: 2 of 40 blocks.

- ``lint``: ``run_lint`` plus the concurrency and schema passes over the
  port's package, in this process: the finding count and the seconds.

One JSON line, ``convert``: per model the seconds of the seeded build, the
conversion, ``save_params`` and the serve (setup to first caption for the
2B), its launches, its report's counts and its check; the lint numbers; and
the phase's seconds beside the card's name and power limit.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import sys
import tempfile
import time
import zlib
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from types import SimpleNamespace

import numpy as np

# a spawned child imports this script again as ``__mp_main__`` and runs
# none of its device code
if __name__ != "__mp_main__":
    import torch

CLIP_TASKS = 2  # tasks of chip_smoke.EMBED_CLIPS_PER_TASK clips, 4 frames each
QWEN_TASKS = 2
QWEN_NEW_TOKENS = 12
QWEN3_LAYERS = 2
QWEN3_TOWER_BLOCKS = 2
QWEN3_DEEPSTACK = (0, 1)
IV2_BLOCKS = 2
INIT_STD = 0.02


# -- HF configs: the port's configs under HF's attribute names ---------------


def hf_clip_vision(cfg) -> SimpleNamespace:
    """A ``CLIPVisionConfig``'s attributes for a ``ViTConfig``."""
    return SimpleNamespace(
        image_size=cfg.image_size, patch_size=cfg.patch_size, hidden_size=cfg.width,
        intermediate_size=4 * cfg.width, num_hidden_layers=cfg.layers, num_attention_heads=cfg.heads,
        projection_dim=cfg.projection_dim, hidden_act=cfg.act, layer_norm_eps=cfg.ln_eps, num_channels=3,
    )


def hf_clip_text(cfg) -> SimpleNamespace:
    """A ``CLIPTextConfig``'s attributes for the port's ``CLIPTextConfig``."""
    return SimpleNamespace(
        vocab_size=cfg.vocab, hidden_size=cfg.width, intermediate_size=4 * cfg.width,
        num_hidden_layers=cfg.layers, num_attention_heads=cfg.heads, max_position_embeddings=cfg.max_len,
        projection_dim=cfg.projection_dim, hidden_act=cfg.act, layer_norm_eps=cfg.ln_eps,
    )


def hf_t5(cfg) -> SimpleNamespace:
    """A ``T5Config``'s attributes for the port's ``T5Config``."""
    return SimpleNamespace(
        vocab_size=cfg.vocab, d_model=cfg.dim, d_kv=cfg.d_kv, d_ff=cfg.d_ff, num_layers=cfg.layers,
        num_heads=cfg.heads, relative_attention_num_buckets=cfg.num_buckets,
        relative_attention_max_distance=cfg.max_distance, is_gated_act=cfg.act == "gated-gelu",
        layer_norm_epsilon=cfg.ln_eps,
    )


def hf_qwen2_vl(cfg) -> SimpleNamespace:
    """A ``Qwen2VLConfig``'s attributes (text fields at the top, as the
    published config.json has them) for a qwen2-variant ``VLMConfig``."""
    v = cfg.qwen_vision
    return SimpleNamespace(
        vocab_size=cfg.vocab, hidden_size=cfg.dim, num_hidden_layers=cfg.n_layers,
        num_attention_heads=cfg.n_heads, num_key_value_heads=cfg.n_kv_heads,
        intermediate_size=round(cfg.dim * cfg.hidden_mult), rope_theta=cfg.rope_theta,
        rope_scaling={"type": "mrope", "mrope_section": list(cfg.mrope_section)}, rms_norm_eps=cfg.rms_eps,
        tie_word_embeddings=cfg.tied_embeddings,
        vision_config=SimpleNamespace(
            depth=v.depth, embed_dim=v.embed_dim, num_heads=v.num_heads, hidden_size=v.hidden_size,
            mlp_ratio=v.mlp_ratio, patch_size=v.patch_size, temporal_patch_size=v.temporal_patch_size,
            spatial_merge_size=v.spatial_merge_size, in_channels=v.in_channels,
        ),
    )


def hf_qwen3_vl_moe(cfg) -> SimpleNamespace:
    """A ``Qwen3VLMoeConfig``'s ``text_config`` / ``vision_config`` for a
    qwen3-variant MoE ``VLMConfig``."""
    v = cfg.qwen_vision
    text = SimpleNamespace(
        vocab_size=cfg.vocab, hidden_size=cfg.dim, num_hidden_layers=cfg.n_layers,
        num_attention_heads=cfg.n_heads, num_key_value_heads=cfg.n_kv_heads, head_dim=cfg.head_dim,
        intermediate_size=round(cfg.dim * cfg.hidden_mult), rope_theta=cfg.rope_theta,
        rope_scaling={"rope_type": "default", "mrope_section": list(cfg.mrope_section), "mrope_interleaved": True},
        rms_norm_eps=cfg.rms_eps, tie_word_embeddings=cfg.tied_embeddings, attention_bias=cfg.qkv_bias,
        num_experts=cfg.moe.n_experts, num_experts_per_tok=cfg.moe.top_k, moe_intermediate_size=cfg.moe.hidden,
    )
    vision = SimpleNamespace(
        depth=v.depth, hidden_size=v.embed_dim, num_heads=v.num_heads, out_hidden_size=v.hidden_size,
        intermediate_size=v.intermediate_size, patch_size=v.patch_size, temporal_patch_size=v.temporal_patch_size,
        spatial_merge_size=v.spatial_merge_size, in_channels=v.in_channels,
        num_position_embeddings=v.pos_embed_side**2, deepstack_visual_indexes=list(v.deepstack_indexes),
    )
    return SimpleNamespace(text_config=text, vision_config=vision)


# -- the name-and-shape generator -------------------------------------------


def _clip_encoder_shapes(prefix: str, n_layers: int, width: int, hidden: int) -> dict:
    out = {}
    for i in range(n_layers):
        e = f"{prefix}encoder.layers.{i}."
        for proj in ("k_proj", "v_proj", "q_proj", "out_proj"):
            out[f"{e}self_attn.{proj}.weight"] = (width, width)
            out[f"{e}self_attn.{proj}.bias"] = (width,)
        out[f"{e}layer_norm1.weight"] = out[f"{e}layer_norm1.bias"] = (width,)
        out[f"{e}mlp.fc1.weight"], out[f"{e}mlp.fc1.bias"] = (hidden, width), (hidden,)
        out[f"{e}mlp.fc2.weight"], out[f"{e}mlp.fc2.bias"] = (width, hidden), (width,)
        out[f"{e}layer_norm2.weight"] = out[f"{e}layer_norm2.bias"] = (width,)
    return out


def clip_vision_shapes(c) -> dict[str, tuple]:
    """``CLIPVisionModelWithProjection.state_dict()``'s names and shapes."""
    v, w = "vision_model.", c.hidden_size
    n_pos = (c.image_size // c.patch_size) ** 2 + 1
    return {
        f"{v}embeddings.class_embedding": (w,),
        f"{v}embeddings.patch_embedding.weight": (w, getattr(c, "num_channels", 3), c.patch_size, c.patch_size),
        f"{v}embeddings.position_embedding.weight": (n_pos, w),
        f"{v}pre_layrnorm.weight": (w,),
        f"{v}pre_layrnorm.bias": (w,),
        **_clip_encoder_shapes(v, c.num_hidden_layers, w, c.intermediate_size),
        f"{v}post_layernorm.weight": (w,),
        f"{v}post_layernorm.bias": (w,),
        "visual_projection.weight": (c.projection_dim, w),
    }


def clip_text_shapes(c) -> dict[str, tuple]:
    """``CLIPTextModelWithProjection.state_dict()``'s names and shapes."""
    t, w = "text_model.", c.hidden_size
    return {
        f"{t}embeddings.token_embedding.weight": (c.vocab_size, w),
        f"{t}embeddings.position_embedding.weight": (c.max_position_embeddings, w),
        **_clip_encoder_shapes(t, c.num_hidden_layers, w, c.intermediate_size),
        f"{t}final_layer_norm.weight": (w,),
        f"{t}final_layer_norm.bias": (w,),
        "text_projection.weight": (c.projection_dim, w),
    }


def t5_encoder_shapes(c) -> dict[str, tuple]:
    """``T5EncoderModel.state_dict()``'s names and shapes (``shared`` and the
    encoder's tied ``embed_tokens`` both)."""
    inner = c.num_heads * c.d_kv
    out = {"shared.weight": (c.vocab_size, c.d_model), "encoder.embed_tokens.weight": (c.vocab_size, c.d_model)}
    ff = ("wi_0", "wi_1") if c.is_gated_act else ("wi",)
    for i in range(c.num_layers):
        e = f"encoder.block.{i}.layer."
        for proj in ("q", "k", "v"):
            out[f"{e}0.SelfAttention.{proj}.weight"] = (inner, c.d_model)
        out[f"{e}0.SelfAttention.o.weight"] = (c.d_model, inner)
        if i == 0:
            out[f"{e}0.SelfAttention.relative_attention_bias.weight"] = (c.relative_attention_num_buckets,
                                                                         c.num_heads)
        out[f"{e}0.layer_norm.weight"] = (c.d_model,)
        for w in ff:
            out[f"{e}1.DenseReluDense.{w}.weight"] = (c.d_ff, c.d_model)
        out[f"{e}1.DenseReluDense.wo.weight"] = (c.d_model, c.d_ff)
        out[f"{e}1.layer_norm.weight"] = (c.d_model,)
    out["encoder.final_layer_norm.weight"] = (c.d_model,)
    return out


def aesthetic_head_shapes(dim: int = 768) -> dict[str, tuple]:
    """The published sac-logos-ava1-l14-linearMSE head's ``nn.Sequential``
    under ``layers.``: Linears at indices 0, 2, 4, 6 and 7."""
    dims = [(dim, 1024), (1024, 128), (128, 64), (64, 16), (16, 1)]
    out = {}
    for idx, (i, o) in zip((0, 2, 4, 6, 7), dims):
        out[f"layers.{idx}.weight"], out[f"layers.{idx}.bias"] = (o, i), (o,)
    return out


def _qwen_lm_shapes(p: str, c, *, qkv_bias: bool, qk_norm: bool, moe: bool) -> dict[str, tuple]:
    d = c.hidden_size
    hd = getattr(c, "head_dim", None) or d // c.num_attention_heads
    q_dim, kv_dim = c.num_attention_heads * hd, c.num_key_value_heads * hd
    out = {f"{p}embed_tokens.weight": (c.vocab_size, d)}
    for i in range(c.num_hidden_layers):
        e = f"{p}layers.{i}."
        for proj, n in (("q_proj", q_dim), ("k_proj", kv_dim), ("v_proj", kv_dim)):
            out[f"{e}self_attn.{proj}.weight"] = (n, d)
            if qkv_bias:
                out[f"{e}self_attn.{proj}.bias"] = (n,)
        out[f"{e}self_attn.o_proj.weight"] = (d, q_dim)
        if qk_norm:
            out[f"{e}self_attn.q_norm.weight"] = out[f"{e}self_attn.k_norm.weight"] = (hd,)
        if moe:
            e_n, h = c.num_experts, c.moe_intermediate_size
            out[f"{e}mlp.gate.weight"] = (e_n, d)
            out[f"{e}mlp.experts.gate_up_proj"] = (e_n, d, 2 * h)
            out[f"{e}mlp.experts.down_proj"] = (e_n, h, d)
        else:
            out[f"{e}mlp.gate_proj.weight"] = out[f"{e}mlp.up_proj.weight"] = (c.intermediate_size, d)
            out[f"{e}mlp.down_proj.weight"] = (d, c.intermediate_size)
        out[f"{e}input_layernorm.weight"] = out[f"{e}post_attention_layernorm.weight"] = (d,)
    out[f"{p}norm.weight"] = (d,)
    return out


def qwen2_vl_shapes(c) -> dict[str, tuple]:
    """``Qwen2VLForConditionalGeneration.state_dict()``'s names and shapes
    (``model.visual.`` / ``model.language_model.`` / ``lm_head.``)."""
    v, vp = c.vision_config, "model.visual."
    e, hidden = v.embed_dim, int(v.embed_dim * v.mlp_ratio)
    merged = e * v.spatial_merge_size**2
    out = {f"{vp}patch_embed.proj.weight": (e, v.in_channels, v.temporal_patch_size, v.patch_size, v.patch_size)}
    for i in range(v.depth):
        b = f"{vp}blocks.{i}."
        for norm in ("norm1", "norm2"):
            out[f"{b}{norm}.weight"] = out[f"{b}{norm}.bias"] = (e,)
        out[f"{b}attn.qkv.weight"], out[f"{b}attn.qkv.bias"] = (3 * e, e), (3 * e,)
        out[f"{b}attn.proj.weight"], out[f"{b}attn.proj.bias"] = (e, e), (e,)
        out[f"{b}mlp.fc1.weight"], out[f"{b}mlp.fc1.bias"] = (hidden, e), (hidden,)
        out[f"{b}mlp.fc2.weight"], out[f"{b}mlp.fc2.bias"] = (e, hidden), (e,)
    out[f"{vp}merger.ln_q.weight"] = out[f"{vp}merger.ln_q.bias"] = (e,)
    out[f"{vp}merger.mlp.0.weight"], out[f"{vp}merger.mlp.0.bias"] = (merged, merged), (merged,)
    out[f"{vp}merger.mlp.2.weight"], out[f"{vp}merger.mlp.2.bias"] = (v.hidden_size, merged), (v.hidden_size,)
    out.update(_qwen_lm_shapes("model.language_model.", c, qkv_bias=True, qk_norm=False, moe=False))
    out["lm_head.weight"] = (c.vocab_size, c.hidden_size)
    return out


def qwen3_vl_moe_shapes(c) -> dict[str, tuple]:
    """``Qwen3VLMoeForConditionalGeneration.state_dict()``'s names and
    shapes."""
    v, t, vp = c.vision_config, c.text_config, "model.visual."
    e, merged = v.hidden_size, v.hidden_size * v.spatial_merge_size**2
    out = {
        f"{vp}patch_embed.proj.weight": (e, v.in_channels, v.temporal_patch_size, v.patch_size, v.patch_size),
        f"{vp}patch_embed.proj.bias": (e,),
        f"{vp}pos_embed.weight": (v.num_position_embeddings, e),
    }
    for i in range(v.depth):
        b = f"{vp}blocks.{i}."
        for norm in ("norm1", "norm2"):
            out[f"{b}{norm}.weight"] = out[f"{b}{norm}.bias"] = (e,)
        out[f"{b}attn.qkv.weight"], out[f"{b}attn.qkv.bias"] = (3 * e, e), (3 * e,)
        out[f"{b}attn.proj.weight"], out[f"{b}attn.proj.bias"] = (e, e), (e,)
        out[f"{b}mlp.linear_fc1.weight"], out[f"{b}mlp.linear_fc1.bias"] = (v.intermediate_size, e), (
            v.intermediate_size,)
        out[f"{b}mlp.linear_fc2.weight"], out[f"{b}mlp.linear_fc2.bias"] = (e, v.intermediate_size), (e,)
    merger_lists = [(f"{vp}merger.", e)] + [
        (f"{vp}deepstack_merger_list.{i}.", merged) for i in range(len(v.deepstack_visual_indexes))
    ]
    for m, norm_dim in merger_lists:
        out[f"{m}norm.weight"] = out[f"{m}norm.bias"] = (norm_dim,)
        out[f"{m}linear_fc1.weight"], out[f"{m}linear_fc1.bias"] = (merged, merged), (merged,)
        out[f"{m}linear_fc2.weight"], out[f"{m}linear_fc2.bias"] = (v.out_hidden_size, merged), (v.out_hidden_size,)
    out.update(_qwen_lm_shapes("model.language_model.", t, qkv_bias=t.attention_bias, qk_norm=True, moe=True))
    out["lm_head.weight"] = (t.vocab_size, t.hidden_size)
    return out


def internvideo2_shapes(cfg, *, with_vision_proj: bool = True) -> dict[str, tuple]:
    """A stage-2 InternVideo2 checkpoint's names and shapes for an
    ``IV2Config`` (the reference's ``PretrainInternVideo2`` plus the
    multimodal model's ``vision_proj``), with two of its training-only
    tensors, which the converter records as skipped."""
    c, p = cfg.embed_dim, cfg.patch_size
    hidden = int(c * cfg.mlp_ratio)
    n_tokens = (cfg.num_frames // cfg.tubelet_size) * (cfg.img_size // p) ** 2 + 1
    out = {
        "patch_embed.proj.weight": (c, 3, cfg.tubelet_size, p, p),
        "patch_embed.proj.bias": (c,),
        "cls_token": (1, 1, c),
        "pos_embed": (1, n_tokens, c),
        "clip_pos_embed": (1, n_tokens, cfg.clip_embed_dim),
        "img_pos_embed": (1, (cfg.img_size // p) ** 2 + 1, c),
    }
    for i in range(cfg.depth):
        b = f"blocks.{i}."
        out[f"{b}norm1.weight"] = out[f"{b}norm2.weight"] = (c,)
        out[f"{b}attn.qkv.weight"] = (3 * c, c)
        if cfg.qkv_bias:
            out[f"{b}attn.qkv.bias"] = (3 * c,)
        out[f"{b}attn.proj.weight"], out[f"{b}attn.proj.bias"] = (c, c), (c,)
        if cfg.qk_normalization:
            out[f"{b}attn.q_norm.weight"] = out[f"{b}attn.k_norm.weight"] = (c,)
        out[f"{b}ls1.gamma"] = out[f"{b}ls2.gamma"] = (c,)
        out[f"{b}mlp.fc1.weight"], out[f"{b}mlp.fc1.bias"] = (hidden, c), (hidden,)
        out[f"{b}mlp.fc2.weight"], out[f"{b}mlp.fc2.bias"] = (c, hidden), (c,)
    cp = "clip_projector."
    for n in ("norm1_q", "norm1_k", "norm1_v"):
        out[f"{cp}{n}.weight"] = out[f"{cp}{n}.bias"] = (c,)
    for n in ("q", "k", "v"):
        out[f"{cp}cross_attn.{n}.weight"], out[f"{cp}cross_attn.{n}_bias"] = (c, c), (c,)
    out[f"{cp}cross_attn.proj.weight"] = (cfg.clip_embed_dim, c)
    out[f"{cp}cross_attn.proj.bias"] = (cfg.clip_embed_dim,)
    if with_vision_proj:
        out["vision_proj.weight"], out["vision_proj.bias"] = (cfg.proj_dim, cfg.clip_embed_dim), (cfg.proj_dim,)
    return out


_UNIT_SCALES = ("norm", "layrnorm", "layer_norm", "ln_q", ".ls1.", ".ls2.")


def seeded_state_dict(shapes: dict[str, tuple], seed: int, device, *, tie: dict[str, str] | None = None) -> dict:
    """Seeded fp32 tensors of ``shapes``, drawn on ``device`` from a
    ``torch.Generator`` and copied to the host: norm and LayerScale weights
    near 1, every other tensor normal at ``INIT_STD``. ``tie`` maps a name
    to the name whose tensor it shares (an HF tied head or embedding)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    out = {}
    for name, shape in shapes.items():
        if tie and name in tie:
            continue
        t = torch.randn(shape, generator=gen, device=device, dtype=torch.float32) * INIT_STD
        if name.endswith("weight") and any(s in name for s in _UNIT_SCALES) or name.endswith(".gamma"):
            t += 1.0
        out[name] = t.cpu()
    for name, src in (tie or {}).items():
        out[name] = out[src]
    return out


def hf_model(state_dict: dict, config) -> SimpleNamespace:
    """What the model converters read off an HF model: ``state_dict()`` and
    ``config``."""
    return SimpleNamespace(state_dict=lambda: state_dict, config=config)


def leaf_crcs(tree) -> dict[str, tuple]:
    """(dtype, shape, CRC-32 of the C-order bytes) of every leaf, by its
    path; leaves in parallel threads (``zlib`` releases the GIL on large
    buffers)."""
    leaves = {}

    def walk(node, path):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, f"{path}/{k}")
            else:
                leaves[f"{path}/{k}"] = v

    def crc(v) -> tuple:
        a = np.ascontiguousarray(v)
        return str(a.dtype), a.shape, zlib.crc32(memoryview(a.reshape(-1)).cast("B"))

    walk(tree, "")
    with ThreadPoolExecutor(8) as pool:
        return dict(zip(leaves, pool.map(crc, leaves.values())))


def init_tree_structure(model) -> dict:
    """The flax tree ``convert_jax.state_dict_to_flax`` gives ``model`` (its
    init tree), with rank-correct one-element leaves: the structure a merge
    overlays, without copying a full model's values to the host."""
    from cosmos_curate_tpu_torch.models.convert_jax import state_dict_to_flax

    return state_dict_to_flax(model, {k: torch.zeros((1,) * v.dim()) for k, v in model.state_dict().items()})


def sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


@contextlib.contextmanager
def timed(out: dict, key: str, dev):
    """``out[key]``: the block's seconds, the device synchronized at both
    ends."""
    sync(dev)
    t0 = time.monotonic()
    yield
    sync(dev)
    out[key] = time.monotonic() - t0


@contextlib.contextmanager
def timed_calls(module, name: str, out: dict):
    """``out[name]``: the seconds of ``module.name``'s calls in the block
    (the function wrapped for the block's duration)."""
    fn = getattr(module, name)

    def wrapped(*args, **kw):
        t0 = time.monotonic()
        try:
            return fn(*args, **kw)
        finally:
            out[name] = out.get(name, 0.0) + time.monotonic() - t0

    setattr(module, name, wrapped)
    try:
        yield
    finally:
        setattr(module, name, fn)


def report_counts(report) -> dict:
    return {"mapped": len(report.mapped), "vision_skipped": len(report.vision_skipped),
            "unmapped": list(report.unmapped)}


# -- the models --------------------------------------------------------------


def drive_clip(cs, dev, weights: Path) -> dict:
    """CLIP ViT-L/14 and the aesthetic head, converted and staged, through
    the embedding stage and the aesthetic filter."""
    from cosmos_curate_tpu_torch.data.model import FrameExtractionSignature
    from cosmos_curate_tpu_torch.models import registry
    from cosmos_curate_tpu_torch.models.clip import CLIPImageEmbeddings, CLIPImageModel
    from cosmos_curate_tpu_torch.models.convert_hf import (
        clip_vision_config,
        convert_aesthetic_head,
        convert_clip_vision,
    )
    from cosmos_curate_tpu_torch.models.convert_jax import load_flax_params
    from cosmos_curate_tpu_torch.ops.flash_attention import flash_attention_plain
    from cosmos_curate_tpu_torch.pipelines.video.stages.aesthetic_filter import AestheticFilterStage
    from cosmos_curate_tpu_torch.pipelines.video.stages.embedding import ClipEmbeddingStage

    cfg = CLIPImageEmbeddings("clip-vit-l14-tpu", device=dev).cfg
    hf_cfg = hf_clip_vision(cfg)
    got_cfg = clip_vision_config(hf_cfg)
    assert dataclasses.replace(got_cfg, preprocess=cfg.preprocess) == cfg, f"CLIP L/14: {got_cfg} != {cfg}"
    out: dict = {"seconds": {}}
    with timed(out["seconds"], "seeded_build", dev):
        sd = seeded_state_dict(clip_vision_shapes(hf_cfg), cs.SEED + 31, dev)
        head_sd = seeded_state_dict(aesthetic_head_shapes(cfg.projection_dim), cs.SEED + 32, dev)
    with timed(out["seconds"], "conversion", dev):
        tree = convert_clip_vision(hf_model(sd, hf_cfg))
        head = convert_aesthetic_head(head_sd)
    with timed(out["seconds"], "save_params", dev):
        registry.save_params("clip-vit-l14-tpu", tree, root=weights)
        registry.save_params("aesthetics-mlp-tpu", head, root=weights)
    del sd, head_sd
    sig = FrameExtractionSignature("fps", 2.0)
    rng = np.random.default_rng(cs.SEED + 33)
    tasks = cs.random_clip_tasks(rng, "convert-clip", sig.key(), 4, cfg.image_size)[:CLIP_TASKS]
    launches: dict = {}
    with cs.counted_launches(launches), timed(out["seconds"], "serve", dev):
        stage = ClipEmbeddingStage(variant="clip", clip_variant="clip-vit-l14-tpu", extraction=sig, device=dev)
        stage.setup(None)
        stage.process_data(tasks)
        scorer = AestheticFilterStage(score_only=True, extraction=sig, device=dev)
        scorer.setup(None)
        scorer.process_data(tasks)
    out["launches"] = launches
    assert launches["flash"] > 0, "convert: the converted CLIP L/14 did not launch flash"
    clips = [c for t in tasks for c in t.video.clips]
    embs = np.stack([c.embeddings["clip-vit-l14-tpu"] for c in clips])
    scores = np.asarray([c.aesthetic_score for c in clips])
    assert embs.shape == (len(clips), cfg.projection_dim) and np.isfinite(embs).all() and np.isfinite(scores).all()
    # the same converted tree into a ViT on flash's plain version
    with torch.device(dev):
        plain = CLIPImageModel(cfg)
    load_flax_params(plain, tree)
    plain.eval()
    frames = np.concatenate([c.extracted_frames[sig.key()] for c in clips])
    with cs.swapped_flash(lambda q, k, v, *, causal=False: flash_attention_plain(q, k, v, causal=causal)), \
            torch.inference_mode():
        per_frame = plain(torch.as_tensor(frames, device=dev)).float()
        per_frame = (per_frame / torch.linalg.norm(per_frame, dim=-1, keepdim=True)).cpu().numpy()
    n = frames.shape[0] // len(clips)
    want = per_frame.reshape(len(clips), n, -1).mean(axis=1)
    want /= np.linalg.norm(want, axis=-1, keepdims=True) + 1e-8
    err = float(np.abs(embs - want).max())
    out.update(clips=len(clips), embedding_dim=int(embs.shape[1]), max_abs_err_vs_plain_flash=err,
               bound=cs.EMBED_BOUND, aesthetic_scores=[float(s) for s in scores])
    assert err <= cs.EMBED_BOUND, f"convert: CLIP L/14 embeddings off the plain version by {err}"
    del stage, scorer, plain
    cs.release_memory()
    return out


def drive_text(cs, dev, weights: Path) -> dict:
    """CLIP text L and the T5 encoder (t5-small's shapes), converted, staged
    and one encode call each."""
    from cosmos_curate_tpu_torch.models import registry
    from cosmos_curate_tpu_torch.models.clip_text import CLIP_TEXT_L, CLIPTextEmbeddings
    from cosmos_curate_tpu_torch.models.convert_hf import (
        clip_text_config,
        convert_clip_text,
        convert_t5_encoder,
        t5_encoder_config,
    )
    from cosmos_curate_tpu_torch.models.t5 import T5_SMALL, T5EncoderTPU
    from cosmos_curate_tpu_torch.models.tokenizer import ByteTokenizer

    texts = ["a red car drives down a wet road at night", "two people walk a dog through a park"]
    out: dict = {}
    for name, cfg, hf_cfg, to_cfg, shapes, convert, model_id, seed in (
        ("clip_text_l", CLIP_TEXT_L, hf_clip_text(CLIP_TEXT_L), clip_text_config, clip_text_shapes,
         convert_clip_text, "clip-text-l-tpu", cs.SEED + 34),
        ("t5_small", T5_SMALL, hf_t5(T5_SMALL), t5_encoder_config, t5_encoder_shapes, convert_t5_encoder,
         "t5-encoder-tpu", cs.SEED + 35),
    ):
        got_cfg = to_cfg(hf_cfg)
        assert dataclasses.replace(got_cfg, max_len=cfg.max_len) == cfg, f"{name}: {got_cfg} != {cfg}"
        rec: dict = {"seconds": {}}
        with timed(rec["seconds"], "seeded_build", dev):
            tie = {"encoder.embed_tokens.weight": "shared.weight"} if name == "t5_small" else None
            sd = seeded_state_dict(shapes(hf_cfg), seed, dev, tie=tie)
        with timed(rec["seconds"], "conversion", dev):
            tree = convert(hf_model(sd, hf_cfg))
        with timed(rec["seconds"], "save_params", dev):
            registry.save_params(model_id, tree, root=weights)
        del sd
        launches: dict = {}
        with cs.counted_launches(launches), timed(rec["seconds"], "serve", dev):
            if name == "clip_text_l":
                model = CLIPTextEmbeddings(model_id, device=dev)
                model.setup()
                embs = model.encode_texts(texts)
                assert embs.shape == (len(texts), cfg.projection_dim)
                np.testing.assert_allclose(np.linalg.norm(embs, axis=-1), 1.0, atol=1e-3)
            else:
                # byte ids (< 512) address rows of the 32128-row table; a real
                # checkpoint stages its tokenizer.json beside it
                model = T5EncoderTPU(cfg, tokenizer=ByteTokenizer(), device=dev)
                model.setup()
                samples = model.encode(texts)
                embs = np.concatenate([s.embedding for s in samples])
                assert embs.shape[-1] == cfg.dim
            assert np.isfinite(embs).all(), f"{name}: non-finite output"
        rec["launches"] = launches
        if name == "clip_text_l":
            assert launches["flash"] > 0, "convert: CLIP text L did not launch causal flash"
        out[name] = rec
        del model
        cs.release_memory()
    return out


def drive_qwen2vl(cs, dev, weights: Path) -> dict:
    """Qwen2-VL-2B at full width and depth: converted, merged into the
    flavor's init tree, staged, read back, and captioned through the stage."""
    from cosmos_curate_tpu_torch.data.model import Clip, FrameExtractionSignature, SplitPipeTask, Video, VideoMetadata
    from cosmos_curate_tpu_torch.models import registry
    from cosmos_curate_tpu_torch.models.convert_qwen import (
        convert_qwen2_vl,
        merge_lm_params,
        merge_vision_params,
        qwen2_lm_config,
        qwen2_vision_config,
    )
    from cosmos_curate_tpu_torch.models.vlm import SharedCaptionEngine
    from cosmos_curate_tpu_torch.models.vlm.model import VLM, vlm_flavor
    from cosmos_curate_tpu_torch.pipelines.video.stages.captioning import CaptionPrepStage, CaptionStage

    flavor = vlm_flavor("qwen2vl-2b")
    cfg = flavor.cfg
    hf_cfg = hf_qwen2_vl(cfg)
    v_cfg = qwen2_vision_config(hf_cfg.vision_config, image_size=cfg.qwen_vision.image_size)
    got = qwen2_lm_config(hf_cfg, max_seq=cfg.max_seq, vision_variant="qwen2", qwen_vision=v_cfg, vision=cfg.vision)
    assert got == cfg, f"qwen2vl-2b: {got} != {cfg}"
    out: dict = {"seconds": {}}
    with timed(out["seconds"], "seeded_build", dev):
        sd = seeded_state_dict(qwen2_vl_shapes(hf_cfg), cs.SEED + 36, dev,
                               tie={"lm_head.weight": "model.language_model.embed_tokens.weight"})
    out["checkpoint_gb"] = sum(t.numel() for k, t in sd.items() if k != "lm_head.weight") * 4 / 1e9
    with torch.device("meta"):
        skeleton = VLM(cfg, dtype=torch.float32)
    with timed(out["seconds"], "conversion", dev):
        lm, vision, report = convert_qwen2_vl(sd, cfg.n_layers, cfg.qwen_vision.depth)
        tree = merge_vision_params(merge_lm_params(init_tree_structure(skeleton), lm), vision)
    del skeleton
    out["report"] = report_counts(report)
    assert not report.unmapped and not report.vision_skipped, report.unmapped
    assert set(report.mapped) >= set(sd), "qwen2vl-2b: a tensor of the checkpoint was not mapped"
    del sd, lm, vision
    model_id = flavor.model_id
    with timed(out["seconds"], "save_params", dev):
        ckpt = registry.save_params(model_id, tree, root=weights)
    out["staged_gb"] = ckpt.stat().st_size / 1e9
    with timed(out["seconds"], "read_back_crc", dev):
        crcs = leaf_crcs(tree)
        del tree
        back = leaf_crcs(registry.read_flax_msgpack(ckpt.read_bytes()))
    assert back == crcs, "qwen2vl-2b: the staged checkpoint does not read back bit-equal"
    out["leaves_bit_equal"] = len(crcs)
    del back
    cs.write_byte_vocab(weights / model_id)
    sig = FrameExtractionSignature("fps", 8.0)
    rng = np.random.default_rng(cs.SEED + 37)
    tasks = [
        SplitPipeTask(video=Video(
            path=f"convert-qwen-{t}.mp4",
            metadata=VideoMetadata(width=224, height=224, fps=30.0, num_frames=30, duration_s=1.0),
            clips=[Clip(source_video=f"convert-qwen-{t}", span=(0.0, 1.0),
                        extracted_frames={sig.key(): rng.integers(0, 256, (8, 224, 224, 3), dtype=np.uint8)})],
        ))
        for t in range(QWEN_TASKS)
    ]
    launches: dict = {}
    with cs.counted_launches(launches):
        tasks = CaptionPrepStage(extraction=sig).process_data(tasks)
        stage = CaptionStage(model_flavor="qwen2vl-2b", max_new_tokens=QWEN_NEW_TOKENS, device=dev)
        t0 = time.monotonic()
        with timed_calls(registry, "load_params", out["seconds"]):
            stage.setup(None)
        setup_s = time.monotonic() - t0
        first = stage.process_data(tasks[:1])
        sync(dev)
        out["seconds"]["setup_to_first_caption"] = time.monotonic() - t0
        out["seconds"]["setup"] = setup_s
        t1 = time.monotonic()
        done = first + stage.process_data(tasks[1:])
        sync(dev)
        out["seconds"]["rest"] = time.monotonic() - t1
    windows = [w for t in done for c in t.video.clips for w in c.windows]
    assert len(windows) == QWEN_TASKS and all("default" in w.caption for w in windows), (
        "qwen2vl-2b: a window has no caption")
    decoded = sum(t.stage_perf["caption_decode_tokens"] for t in done)
    assert decoded > 0, "qwen2vl-2b: no tokens decoded"
    out.update(windows_captioned=len(windows), decode_tokens=decoded, launches=launches)
    for name in ("paged_prefill", "paged_decode"):
        assert launches[name] > 0, f"qwen2vl-2b: {name} was not launched"
    del stage
    SharedCaptionEngine.reset()
    cs.release_memory()
    return out


def drive_qwen3(cs, dev) -> dict:
    """Qwen3-VL-30B-A3B at full width, QWEN3_LAYERS LM layers and
    QWEN3_TOWER_BLOCKS tower blocks: converted, loaded, the tower on 2
    frames, then a paged prefill and one paged decode step, held against the
    same forward on the plain attention."""
    from cosmos_curate_tpu_torch.models.convert_jax import load_flax_params
    from cosmos_curate_tpu_torch.models.convert_qwen import (
        convert_qwen3_moe_lm,
        convert_qwen3_vision,
        merge_lm_params,
        merge_vision_params,
        qwen3_moe_lm_config,
        qwen3_vision_config,
    )
    from cosmos_curate_tpu_torch.models.vlm.model import VLM, build_mrope_positions, vlm_flavor

    full = vlm_flavor(cs.QWEN3_FLAVOR).cfg
    vision = dataclasses.replace(full.qwen_vision, depth=QWEN3_TOWER_BLOCKS, deepstack_indexes=QWEN3_DEEPSTACK)
    cfg = dataclasses.replace(full, n_layers=QWEN3_LAYERS, qwen_vision=vision, max_seq=512)
    hf_cfg = hf_qwen3_vl_moe(cfg)
    v_cfg = qwen3_vision_config(hf_cfg.vision_config, image_size=vision.image_size)
    got = qwen3_moe_lm_config(hf_cfg.text_config, max_seq=cfg.max_seq, vision_variant="qwen3", qwen_vision=v_cfg,
                              vision=cfg.vision)
    # the flavor's serving capacity factor is not a checkpoint field
    assert dataclasses.replace(got, moe=full.moe) == cfg, f"qwen3: {got} != {cfg}"
    out: dict = {"seconds": {}, "layers": QWEN3_LAYERS, "tower_blocks": QWEN3_TOWER_BLOCKS,
                 "deepstack_indexes": list(QWEN3_DEEPSTACK)}
    with timed(out["seconds"], "seeded_build", dev):
        sd = seeded_state_dict(qwen3_vl_moe_shapes(hf_cfg), cs.SEED + 38, dev)
    out["checkpoint_gb"] = sum(t.numel() for t in sd.values()) * 4 / 1e9
    with torch.device(dev):
        model = VLM(cfg)
    with timed(out["seconds"], "conversion", dev):
        lm, lm_report = convert_qwen3_moe_lm(sd, cfg.n_layers, tied_embeddings=cfg.tied_embeddings)
        vis, vis_report = convert_qwen3_vision(sd, v_cfg)
        tree = merge_vision_params(merge_lm_params(init_tree_structure(model), lm), vis)
    out["report"] = {"lm": report_counts(lm_report), "vision": report_counts(vis_report)}
    assert not vis_report.unmapped and set(lm_report.mapped) | set(vis_report.mapped) >= set(sd)
    del sd, lm, vis
    with timed(out["seconds"], "load", dev):
        load_flax_params(model, tree)
    del tree
    model.eval()
    rng = np.random.default_rng(cs.SEED + 39)
    frames = torch.as_tensor(rng.integers(0, 256, (1, 2, vision.image_size, vision.image_size, 3), dtype=np.uint8),
                             device=dev)
    launches: dict = {}
    with cs.counted_launches(launches), torch.inference_mode(), timed(out["seconds"], "run", dev):
        vis_tokens, deepstack = model.encode_images(frames)
        n_pre, n_post = 4, 8
        ids = torch.as_tensor(rng.integers(0, 255, (1, n_pre + n_post)), device=dev)
        text = model.embed_tokens(ids)
        embeds = torch.cat([text[:, :n_pre], vis_tokens.to(text.dtype), text[:, n_pre:]], dim=1)
        zeros = torch.zeros_like(text[:, :1]).expand(-1, n_pre, -1)
        ds = torch.stack([torch.cat([zeros, lvl.to(text.dtype), torch.zeros_like(text[:, n_pre:])], dim=1)
                          for lvl in deepstack])
        rope, nxt = build_mrope_positions(n_pre, vision.merged_grid(2), n_post)
        t = embeds.shape[1]
        pos = torch.as_tensor(rope[None], device=dev)
        bs, nbl = 16, -(-(t + 1) // 16)
        tables = torch.arange(1, nbl + 1, dtype=torch.int32, device=dev)[None]
        pool_shape = (cfg.n_layers, nbl + 1, bs, cfg.n_kv_heads, cfg.head_dim)

        def run(pk, pv):
            logits, _, _ = model.paged_forward(
                embeds, pk, pv, pos, torch.zeros(1, dtype=torch.int32, device=dev),
                torch.full((1,), t, dtype=torch.int32, device=dev), tables, deepstack=ds)
            nxt_id = logits[:, -1].float().argmax(-1)
            step = model.embed_tokens(nxt_id[:, None])
            step_pos = torch.full((1, 1, 3), nxt, dtype=torch.int32, device=dev)
            step_logits, _, _ = model.paged_forward(
                step, pk, pv, step_pos, torch.full((1,), t, dtype=torch.int32, device=dev),
                torch.full((1,), t + 1, dtype=torch.int32, device=dev), tables)
            return logits.float(), step_logits.float()

        kernel = run(*(torch.zeros(pool_shape, dtype=model.dtype, device=dev) for _ in range(2)))
    with cs.plain_attention(), torch.inference_mode():
        plain = run(*(torch.zeros(pool_shape, dtype=model.dtype, device=dev) for _ in range(2)))
    errs = [float((a - b).abs().max()) for a, b in zip(kernel, plain)]
    assert all(torch.isfinite(x).all() for x in kernel), "qwen3: non-finite logits"
    out.update(launches=launches, max_abs_logit_diff_vs_plain={"prefill": errs[0], "decode": errs[1]},
               bound=cs.QWEN_FORWARD_BOUND, vision_tokens=int(vis_tokens.shape[1]))
    for name in ("paged_prefill", "paged_decode"):
        assert launches[name] > 0, f"qwen3: {name} was not launched"
    assert max(errs) <= cs.QWEN_FORWARD_BOUND, f"qwen3: paged kernels off the plain attention by {errs}"
    del model, kernel, plain
    cs.release_memory()
    return out


def drive_iv2(cs, dev) -> dict:
    """InternVideo2-1B at full width and IV2_BLOCKS blocks: converted (the
    multimodal wrapper's layout, training-only tensors included), loaded,
    and run on one clip."""
    from cosmos_curate_tpu_torch.models.convert_iv2 import convert_internvideo2
    from cosmos_curate_tpu_torch.models.convert_jax import load_flax_params
    from cosmos_curate_tpu_torch.models.internvideo2 import IV2_1B, InternVideo2Tower

    cfg = dataclasses.replace(IV2_1B, depth=IV2_BLOCKS)
    out: dict = {"seconds": {}, "blocks": IV2_BLOCKS}
    with timed(out["seconds"], "seeded_build", dev):
        shapes = internvideo2_shapes(cfg)
        sd = seeded_state_dict(shapes, cs.SEED + 40, dev)
        sd = {(k if k.startswith("vision_proj") else f"vision_encoder.{k}"): v for k, v in sd.items()}
    with timed(out["seconds"], "conversion", dev):
        tree, report = convert_internvideo2(sd, cfg)
    out["report"] = report_counts(report)
    assert not report.unmapped and len(report.vision_skipped) == 2, report
    del sd
    with torch.device(dev):
        tower = InternVideo2Tower(cfg)
    with timed(out["seconds"], "load", dev):
        load_flax_params(tower, tree)
    frames = np.random.default_rng(cs.SEED + 41).integers(
        0, 256, (1, cfg.num_frames, cfg.img_size, cfg.img_size, 3), dtype=np.uint8)
    launches: dict = {}
    with cs.counted_launches(launches), torch.inference_mode(), timed(out["seconds"], "run", dev):
        emb = tower.eval()(torch.as_tensor(frames, device=dev)).float().cpu().numpy()
    assert emb.shape == (1, cfg.proj_dim) and np.isfinite(emb).all()
    np.testing.assert_allclose(np.linalg.norm(emb, axis=-1), 1.0, atol=1e-3)
    out.update(launches=launches, embedding_dim=int(emb.shape[1]))
    del tower
    cs.release_memory()
    return out


def drive_lint() -> dict:
    """``lint --concurrency --schema`` over the port's package, in process."""
    from cosmos_curate_tpu_torch.analysis.ast_lint import run_lint
    from cosmos_curate_tpu_torch.analysis.concurrency_check import run_concurrency_check
    from cosmos_curate_tpu_torch.analysis.schema_check import run_schema_check

    package = str(Path(__file__).resolve().parents[1] / "cosmos_curate_tpu_torch")
    out: dict = {"seconds": {}}
    findings = []
    for name, fn in (("ast", lambda: run_lint([package])), ("concurrency", lambda: run_concurrency_check([package])),
                     ("schema", run_schema_check)):
        t0 = time.monotonic()
        found = fn()
        out["seconds"][name] = time.monotonic() - t0
        findings.extend(found)
    out["findings"] = len(findings)
    out["rendered"] = [f.render() for f in findings[:10]]
    assert not findings, f"lint: {out['rendered']}"
    return out


def drive_convert(cs, dev) -> dict:
    from cosmos_curate_tpu_torch.ops import kernels

    out: dict = {}
    with tempfile.TemporaryDirectory(prefix="convert_phase-") as tmp, cs.staged_weights(Path(tmp)):
        weights = Path(tmp)
        out["clip_l14"] = drive_clip(cs, dev, weights)
        out.update(drive_text(cs, dev, weights))
        out["qwen2vl_2b"] = drive_qwen2vl(cs, dev, weights)
    out["qwen3_vl_moe_a3b"] = drive_qwen3(cs, dev)
    out["internvideo2_1b"] = drive_iv2(cs, dev)
    out["lint"] = drive_lint()
    out["launches"] = {name: sum(rec["launches"][name] for key, rec in out.items() if isinstance(rec, dict)
                                 and "launches" in rec) for name in kernels()}
    return out


def run(cs, dev) -> dict:
    """The phase, its line emitted as it ends; returns the record."""
    t0 = time.monotonic()
    record = {**drive_convert(cs, dev), "phase_s": time.monotonic() - t0, "card": cs.card_line()}
    cs.emit({"phase": "convert", **record})
    for name in ("clip_l14", "clip_text_l", "t5_small", "qwen2vl_2b", "qwen3_vl_moe_a3b", "internvideo2_1b"):
        secs = ", ".join(f"{k} {v:.2f} s" for k, v in record[name]["seconds"].items())
        print(f"convert {name}: {secs}", flush=True)
    print(f"convert: lint {record['lint']['findings']} findings; phase {record['phase_s']:.1f} s", flush=True)
    return record


def main() -> int:
    if not torch.cuda.is_available():
        print("convert_phase: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs

    dev = torch.device("cuda", 0)
    started = time.monotonic()
    timer, build_s = cs.phase_prologue(dev)
    cs.emit({"phase": "build", "seconds": build_s,
             "modules": {name: cs.optional_modules()[name] for name in ("transformers", "safetensors")}})
    run(cs, dev)
    cs.emit({"phase": "timing", "script_s": time.monotonic() - started})
    return 0


if __name__ == "__main__":
    sys.exit(main())
