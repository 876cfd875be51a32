"""Qwen2(-VL) and Qwen3(-VL)-MoE checkpoint converters for the port's VLM
(port of ``cosmos_curate_tpu/models/convert_qwen.py``).

Each converter takes an HF state dict (torch tensors or numpy arrays under
the public HF tensor names) and returns the reference's flax-layout numpy
tree and :class:`ConversionReport`, tensor for tensor: so
``registry.save_params`` writes the bytes the JAX package would write for
the same checkpoint, and the port's stages load it through
``registry.load_params`` / ``convert_jax``. ``VLM_QWEN2_2B`` matches
Qwen2-VL-2B-Instruct's language model (GQA, SwiGLU, q/k/v biases, tied
embeddings, RMS norm, rope 1e6) and ``QWEN2_VL_2B_VISION`` its vision
encoder (3D-conv patchify as a matmul, 2D rope, patch merger); the Qwen3
converters map the MoE text model (qk-norm, fused experts) and the qwen3
tower with its deepstack mergers.

``convert_qwen2_lm`` alone reports vision tensors as intentionally
unmapped for the LM-only path; ``convert_qwen2_vl`` maps both halves. A
tensor no converter maps is recorded in the report, never dropped
silently. ``merge_lm_params`` / ``merge_vision_params`` overlay a
converted subtree on the port's init tree as
``convert_jax.state_dict_to_flax(model)`` gives it.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from cosmos_curate_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)


def _t(w) -> np.ndarray:
    return np.asarray(w.detach().cpu().numpy() if hasattr(w, "detach") else w)


@dataclass
class ConversionReport:
    mapped: list[str] = field(default_factory=list)
    vision_skipped: list[str] = field(default_factory=list)
    unmapped: list[str] = field(default_factory=list)


def qwen2_lm_config(hf_config, **overrides):
    """Our VLMConfig from an HF Qwen2(-VL) text config."""
    from cosmos_curate_tpu_torch.models.vlm.model import VLMConfig

    head_dim = getattr(hf_config, "head_dim", None) or (
        hf_config.hidden_size // hf_config.num_attention_heads
    )
    rope_scaling = getattr(hf_config, "rope_scaling", None) or {}
    mrope = rope_scaling.get("mrope_section")
    kw = dict(
        vocab=hf_config.vocab_size,
        dim=hf_config.hidden_size,
        n_layers=hf_config.num_hidden_layers,
        n_heads=hf_config.num_attention_heads,
        n_kv_heads=hf_config.num_key_value_heads,
        head_dim=head_dim,
        hidden_mult=hf_config.intermediate_size / hf_config.hidden_size,
        rope_theta=hf_config.rope_theta,
        qkv_bias=True,
        mrope_section=tuple(mrope) if mrope else None,
        rms_eps=getattr(hf_config, "rms_norm_eps", 1e-6),
        tied_embeddings=getattr(hf_config, "tie_word_embeddings", True),
    )
    kw.update(overrides)
    return VLMConfig(**kw)


def convert_qwen2_lm(
    state_dict, n_layers: int, *, tied_embeddings: bool | None = None
) -> tuple[dict, ConversionReport]:
    """HF Qwen2(-VL) state dict → our VLM LM params subtree + report.

    Accepts both bare Qwen2 (``model.``) and Qwen2-VL (``model.`` +
    ``visual.``) layouts. Returns params covering embed / layer_i / ln_f;
    merge into a full init tree with ``merge_lm_params``.
    """
    sd = {k: v for k, v in state_dict.items()}
    report = ConversionReport()

    def take(name: str) -> np.ndarray:
        report.mapped.append(name)
        return _t(sd[name])

    # Qwen2-VL-2B prefixes text tensors with "model."; some exports use
    # "model.language_model." — probe which exists.
    prefix = "model."
    if f"{prefix}embed_tokens.weight" not in sd:
        for cand in ("model.language_model.", "language_model.model.", ""):
            if f"{cand}embed_tokens.weight" in sd:
                prefix = cand
                break
    params: dict = {"embed": {"embedding": take(f"{prefix}embed_tokens.weight")}}
    for i in range(n_layers):
        e = f"{prefix}layers.{i}."

        def lin(name: str, bias: bool) -> dict:
            d = {"kernel": take(f"{e}{name}.weight").T}
            if bias:
                d["bias"] = take(f"{e}{name}.bias")
            return d

        params[f"layer_{i}"] = {
            "ln1": {"scale": take(f"{e}input_layernorm.weight")},
            "ln2": {"scale": take(f"{e}post_attention_layernorm.weight")},
            "q": lin("self_attn.q_proj", True),
            "k": lin("self_attn.k_proj", True),
            "v": lin("self_attn.v_proj", True),
            "o": lin("self_attn.o_proj", False),
            "gate": lin("mlp.gate_proj", False),
            "up": lin("mlp.up_proj", False),
            "down": lin("mlp.down_proj", False),
        }
    params["ln_f"] = {"scale": take(f"{prefix}norm.weight")}

    mapped = set(report.mapped)
    for k in sd:
        if k in mapped:
            continue
        if k.startswith(("visual.", "model.visual.")):
            report.vision_skipped.append(k)
        elif k == "lm_head.weight":
            head, emb = _t(sd[k]), params["embed"]["embedding"]
            # tied checkpoints may still serialize the head (covered by
            # embed.attend) — but only drop it when the TARGET config does
            # not expect a separate lm_head (see convert_qwen3_moe_lm)
            redundant = head.shape == emb.shape and np.array_equal(head, emb)
            if redundant and tied_embeddings is not False:
                report.mapped.append(k)
            else:
                # untied head (Qwen2.5-VL): its own projection matrix
                params["lm_head"] = {"kernel": head.T}
                report.mapped.append(k)
        else:
            report.unmapped.append(k)
    logger.info(
        "converted Qwen2 LM: %d tensors mapped, %d vision skipped, %d unmapped",
        len(report.mapped),
        len(report.vision_skipped),
        len(report.unmapped),
    )
    return {"params": params}, report


def qwen3_moe_lm_config(hf_text_config, **overrides):
    """Our VLMConfig from an HF Qwen3(-VL)-MoE text config: per-head qk
    RMSNorm, no attention bias, sparse MoE FFN on every layer."""
    from cosmos_curate_tpu_torch.models.vlm.model import MoEConfig, VLMConfig

    c = hf_text_config
    rope_scaling = getattr(c, "rope_scaling", None) or {}
    mrope = rope_scaling.get("mrope_section")
    kw = dict(
        vocab=c.vocab_size,
        dim=c.hidden_size,
        n_layers=c.num_hidden_layers,
        n_heads=c.num_attention_heads,
        n_kv_heads=c.num_key_value_heads,
        head_dim=getattr(c, "head_dim", c.hidden_size // c.num_attention_heads),
        hidden_mult=c.intermediate_size / c.hidden_size,
        rope_theta=c.rope_theta,
        qkv_bias=getattr(c, "attention_bias", False),
        qk_norm=True,
        # Qwen3-VL m-rope is INTERLEAVED across frequency dims
        mrope_section=tuple(mrope) if mrope else None,
        mrope_interleaved=bool(mrope),
        rms_eps=getattr(c, "rms_norm_eps", 1e-6),
        tied_embeddings=getattr(c, "tie_word_embeddings", True),
        moe=MoEConfig(
            n_experts=c.num_experts,
            top_k=c.num_experts_per_tok,
            hidden=c.moe_intermediate_size,
        ),
    )
    kw.update(overrides)
    return VLMConfig(**kw)


def convert_qwen3_moe_lm(
    state_dict, n_layers: int, *, tied_embeddings: bool | None = None
) -> tuple[dict, ConversionReport]:
    """HF Qwen3(-VL)-MoE text state dict → our VLM params subtree + report
    (reference serves this family via vLLM EP, models/vllm_qwen.py:313-349).

    Accepts the bare text-model layout (``embed_tokens.weight``, ...) and
    prefixed exports (``model.`` / ``model.language_model.``). Expert
    tensors map verbatim: HF fuses gate|up as ``experts.gate_up_proj``
    [E, D, 2H] and ``experts.down_proj`` [E, H, D] — exactly our MoEFFN's
    parameter layout."""
    sd = dict(state_dict)
    report = ConversionReport()

    def take(name: str) -> np.ndarray:
        report.mapped.append(name)
        return _t(sd[name])

    prefix = ""
    for cand in ("", "model.", "model.language_model.", "language_model.model."):
        if f"{cand}embed_tokens.weight" in sd:
            prefix = cand
            break
    params: dict = {"embed": {"embedding": take(f"{prefix}embed_tokens.weight")}}
    for i in range(n_layers):
        e = f"{prefix}layers.{i}."

        def lin(name: str) -> dict:
            return {"kernel": take(f"{e}{name}.weight").T}

        params[f"layer_{i}"] = {
            "ln1": {"scale": take(f"{e}input_layernorm.weight")},
            "ln2": {"scale": take(f"{e}post_attention_layernorm.weight")},
            "q": lin("self_attn.q_proj"),
            "k": lin("self_attn.k_proj"),
            "v": lin("self_attn.v_proj"),
            "o": lin("self_attn.o_proj"),
            "q_norm": {"scale": take(f"{e}self_attn.q_norm.weight")},
            "k_norm": {"scale": take(f"{e}self_attn.k_norm.weight")},
            "moe": {
                "router": {"kernel": take(f"{e}mlp.gate.weight").T},
                "gate_up": take(f"{e}mlp.experts.gate_up_proj"),
                "down": take(f"{e}mlp.experts.down_proj"),
            },
        }
    params["ln_f"] = {"scale": take(f"{prefix}norm.weight")}
    mapped = set(report.mapped)
    for k in sd:
        if k in mapped:
            continue
        if k.startswith(("visual.", "model.visual.")):
            report.vision_skipped.append(k)
        elif k.endswith("lm_head.weight"):
            head, emb = _t(sd[k]), params["embed"]["embedding"]
            # drop the head ONLY when it is redundant (equals the embedding)
            # AND the target config does not expect a separate lm_head: an
            # untied config whose head happens to equal the embedding must
            # still carry lm_head or the restore fails spuriously. Pass
            # tied_embeddings from the target VLMConfig; None keeps the
            # equality heuristic for bare state-dict conversions.
            redundant = head.shape == emb.shape and np.array_equal(head, emb)
            if redundant and tied_embeddings is not False:
                report.mapped.append(k)
            else:
                params["lm_head"] = {"kernel": head.T}
                report.mapped.append(k)
        else:
            report.unmapped.append(k)
    logger.info(
        "converted Qwen3-MoE LM: %d tensors mapped, %d vision skipped, %d unmapped",
        len(report.mapped),
        len(report.vision_skipped),
        len(report.unmapped),
    )
    return {"params": params}, report


def qwen2_vision_config(hf_vision_config, **overrides):
    """Our QwenVisionConfig from an HF Qwen2VLVisionConfig OR
    Qwen2_5_VLVisionConfig (detected by ``out_hidden_size``, the 2.5
    layout where ``hidden_size`` is the EMBED dim)."""
    from cosmos_curate_tpu_torch.models.vlm.vision_qwen import QwenVisionConfig

    c = hf_vision_config
    if hasattr(c, "out_hidden_size"):  # Qwen2.5-VL
        kw = dict(
            depth=c.depth,
            embed_dim=c.hidden_size,
            num_heads=c.num_heads,
            hidden_size=c.out_hidden_size,
            intermediate_size=c.intermediate_size,
            patch_size=c.patch_size,
            temporal_patch_size=c.temporal_patch_size,
            spatial_merge_size=c.spatial_merge_size,
            in_channels=c.in_channels,
            variant="qwen2_5",
            window_size=c.window_size,
            fullatt_block_indexes=tuple(c.fullatt_block_indexes),
        )
    else:
        kw = dict(
            depth=c.depth,
            embed_dim=c.embed_dim,
            num_heads=c.num_heads,
            hidden_size=c.hidden_size,
            mlp_ratio=c.mlp_ratio,
            patch_size=c.patch_size,
            temporal_patch_size=c.temporal_patch_size,
            spatial_merge_size=c.spatial_merge_size,
            in_channels=c.in_channels,
        )
    kw.update(overrides)
    return QwenVisionConfig(**kw)


def qwen3_vision_config(hf_vision_config, **overrides):
    """Our QwenVisionConfig (variant="qwen3") from an HF
    Qwen3VL(Moe)VisionConfig."""
    from cosmos_curate_tpu_torch.models.vlm.vision_qwen import QwenVisionConfig

    c = hf_vision_config
    kw = dict(
        depth=c.depth,
        embed_dim=c.hidden_size,
        num_heads=c.num_heads,
        hidden_size=c.out_hidden_size,
        intermediate_size=c.intermediate_size,
        patch_size=c.patch_size,
        temporal_patch_size=c.temporal_patch_size,
        spatial_merge_size=c.spatial_merge_size,
        in_channels=c.in_channels,
        variant="qwen3",
        pos_embed_side=int(round(c.num_position_embeddings**0.5)),
        deepstack_indexes=tuple(c.deepstack_visual_indexes),
    )
    kw.update(overrides)
    return QwenVisionConfig(**kw)


def convert_qwen3_vision(state_dict, cfg) -> tuple[dict, ConversionReport]:
    """HF Qwen3-VL vision tensors → our qwen3-variant tower params.

    Accepts the standalone vision-model layout and ``model.visual.`` /
    ``visual.`` prefixed exports. Conv3d patchify flattens exactly like
    convert_qwen2_vision; the learned pos-embed Embedding maps verbatim;
    deepstack mergers land as ds{level}_{norm,fc1,fc2}."""
    sd = dict(state_dict)
    report = ConversionReport()
    prefix = ""
    for cand in ("", "visual.", "model.visual."):
        if f"{cand}patch_embed.proj.weight" in sd:
            prefix = cand
            break

    def take(name: str) -> np.ndarray:
        report.mapped.append(name)
        return _t(sd[name])

    def lin(stem: str) -> dict:
        return {"kernel": take(f"{stem}.weight").T, "bias": take(f"{stem}.bias")}

    def ln(stem: str) -> dict:
        return {"scale": take(f"{stem}.weight"), "bias": take(f"{stem}.bias")}

    conv = take(f"{prefix}patch_embed.proj.weight")  # [E, C, tps, ps, ps]
    params: dict = {
        "patch_embed": {
            "kernel": conv.reshape(conv.shape[0], -1).T,
            "bias": take(f"{prefix}patch_embed.proj.bias"),
        },
        "pos_embed": take(f"{prefix}pos_embed.weight"),
    }
    for i in range(cfg.depth):
        e = f"{prefix}blocks.{i}."
        params[f"block_{i}"] = {
            "ln1": ln(f"{e}norm1"),
            "ln2": ln(f"{e}norm2"),
            "qkv": lin(f"{e}attn.qkv"),
            "proj": lin(f"{e}attn.proj"),
            "fc1": lin(f"{e}mlp.linear_fc1"),
            "fc2": lin(f"{e}mlp.linear_fc2"),
        }
    params["ln_q"] = ln(f"{prefix}merger.norm")
    params["merger_fc1"] = lin(f"{prefix}merger.linear_fc1")
    params["merger_fc2"] = lin(f"{prefix}merger.linear_fc2")
    for level in range(len(cfg.deepstack_indexes)):
        d = f"{prefix}deepstack_merger_list.{level}."
        params[f"ds{level}_norm"] = ln(f"{d}norm")
        params[f"ds{level}_fc1"] = lin(f"{d}linear_fc1")
        params[f"ds{level}_fc2"] = lin(f"{d}linear_fc2")
    mapped = set(report.mapped)
    report.unmapped.extend(
        k for k in sd if k not in mapped and (not prefix or k.startswith(prefix))
    )
    logger.info(
        "converted Qwen3 vision tower: %d tensors mapped, %d unmapped",
        len(report.mapped), len(report.unmapped),
    )
    return {"params": params}, report


def convert_qwen2_vision(state_dict, depth: int) -> tuple[dict, ConversionReport]:
    """HF ``visual.*`` tensors → our QwenVisionTower params subtree.

    The Conv3d patchify (kernel == stride) becomes the dense patch_embed
    kernel: ``[E, C, tps, ps, ps]`` flattens to ``[E, patch_dim]`` and
    transposes — valid because both sides consume patches flattened in
    (C, tps, ps, ps) order (HF PatchEmbed.forward views exactly that
    shape; frames_to_patches emits it).
    """
    sd = dict(state_dict)
    report = ConversionReport()
    prefix = "visual."
    if f"{prefix}patch_embed.proj.weight" not in sd:
        if "model.visual.patch_embed.proj.weight" in sd:
            prefix = "model.visual."
        else:
            raise KeyError("no visual.* tensors found in state dict")

    def take(name: str) -> np.ndarray:
        report.mapped.append(name)
        return _t(sd[name])

    def lin(stem: str) -> dict:
        return {
            "kernel": take(f"{stem}.weight").T,
            "bias": take(f"{stem}.bias"),
        }

    def ln(stem: str) -> dict:
        return {"scale": take(f"{stem}.weight"), "bias": take(f"{stem}.bias")}

    # Qwen2.5-VL: RMSNorm blocks (weight-only norms) + SwiGLU MLP
    is_25 = f"{prefix}blocks.0.mlp.gate_proj.weight" in sd

    def rms(stem: str) -> dict:
        return {"scale": take(f"{stem}.weight")}

    conv = take(f"{prefix}patch_embed.proj.weight")  # [E, C, tps, ps, ps]
    params: dict = {"patch_embed": {"kernel": conv.reshape(conv.shape[0], -1).T}}
    for i in range(depth):
        e = f"{prefix}blocks.{i}."
        block = {
            "ln1": rms(f"{e}norm1") if is_25 else ln(f"{e}norm1"),
            "ln2": rms(f"{e}norm2") if is_25 else ln(f"{e}norm2"),
            "qkv": lin(f"{e}attn.qkv"),
            "proj": lin(f"{e}attn.proj"),
        }
        if is_25:
            block["gate"] = lin(f"{e}mlp.gate_proj")
            block["up"] = lin(f"{e}mlp.up_proj")
            block["down"] = lin(f"{e}mlp.down_proj")
        else:
            block["fc1"] = lin(f"{e}mlp.fc1")
            block["fc2"] = lin(f"{e}mlp.fc2")
        params[f"block_{i}"] = block
    params["ln_q"] = rms(f"{prefix}merger.ln_q") if is_25 else ln(f"{prefix}merger.ln_q")
    params["merger_fc1"] = lin(f"{prefix}merger.mlp.0")
    params["merger_fc2"] = lin(f"{prefix}merger.mlp.2")

    mapped = set(report.mapped)
    for k in sd:
        if k not in mapped and k.startswith(prefix):
            report.unmapped.append(k)
    logger.info(
        "converted Qwen2-VL vision: %d tensors mapped, %d unmapped",
        len(report.mapped),
        len(report.unmapped),
    )
    return {"params": params}, report


def convert_qwen2_vl(
    state_dict, n_layers: int, vision_depth: int
) -> tuple[dict, dict, ConversionReport]:
    """Full Qwen2-VL checkpoint → (lm_params, vision_params, report).

    Unlike ``convert_qwen2_lm`` alone, nothing is "intentionally skipped":
    a Qwen2-VL checkpoint converts completely, so ``report.vision_skipped``
    is empty and multimodal forwards see the trained tower.
    """
    lm_params, lm_report = convert_qwen2_lm(state_dict, n_layers)
    vision_params, v_report = convert_qwen2_vision(state_dict, vision_depth)
    report = ConversionReport(
        mapped=lm_report.mapped + v_report.mapped,
        vision_skipped=[],
        unmapped=[u for u in lm_report.unmapped if not u.startswith(("visual.", "model.visual."))]
        + v_report.unmapped,
    )
    return lm_params, vision_params, report


def _copy_tree(tree: dict) -> dict:
    """A new dict structure over the same leaves (what flax's ``unfreeze``
    gives the reference)."""
    return {k: _copy_tree(v) if isinstance(v, dict) else v for k, v in tree.items()}


def merge_lm_params(init_tree: dict, lm_params: dict) -> dict:
    """Overlay converted LM params onto a full init tree (vision tower +
    projector keep their existing, e.g. self-trained, values)."""
    merged = _copy_tree(init_tree)
    for key, val in lm_params["params"].items():
        merged["params"][key] = val
    return merged


def merge_vision_params(init_tree: dict, vision_params: dict) -> dict:
    """Overlay converted Qwen vision-tower params under the VLM's
    ``vision`` submodule (plus the top-level merger ln_q, which
    QwenVisionTower owns)."""
    merged = _copy_tree(init_tree)
    merged["params"]["vision"] = vision_params["params"]
    return merged
