"""InternVideo2 checkpoint -> the reference's flax tower layout (port of
``cosmos_curate_tpu/models/convert_iv2.py``).

Maps a stage-2 InternVideo2 state dict (the reference's
``pretrain_internvideo2_1b_patch14_224`` ``.pth``, optionally wrapped in
the multimodal model whose tensors carry a ``vision_encoder.`` prefix)
onto the tree that ``registry.save_params`` stages under the JAX registry
id and :class:`cosmos_curate_tpu_torch.models.internvideo2.InternVideo2Tower`
loads through ``convert_jax``.

Training-only tensors are intentionally skipped and recorded in the
report: the masked-distillation decoders (``clip_decoder.*``,
``final_clip_decoder.*``), their private position table
(``clip_pos_embed*``), and the image-only table (``img_pos_embed*``):
``get_vid_feat`` inference never touches them.
"""

from __future__ import annotations

import numpy as np

from cosmos_curate_tpu_torch.models.convert_qwen import ConversionReport, _t
from cosmos_curate_tpu_torch.models.internvideo2 import IV2Config

# prefixes of tensors the inference tower deliberately does not carry
_SKIP_PREFIXES = (
    "clip_decoder.",
    "final_clip_decoder.",
    "clip_pos_embed",
    "clip_img_pos_embed",
    "img_pos_embed",
    "text_encoder.",
    "text_proj.",
    "temp",
    "itm_head.",
)


def convert_internvideo2(state_dict, cfg: IV2Config) -> tuple[dict, ConversionReport]:
    """State dict -> ({'params': tower_params}, report).

    Accepts the bare tower layout (`patch_embed.proj.weight`, ...) and the
    multimodal wrapper layout (`vision_encoder.` prefix + top-level
    `vision_proj.{weight,bias}`). A missing `vision_proj` (bare tower
    checkpoint without the contrastive head) is reported unmapped —
    the caller must decide whether pooled-only embeddings are acceptable.
    """
    sd = dict(state_dict)
    # normalize the multimodal wrapper prefix away; vision_proj stays
    if any(k.startswith("vision_encoder.") for k in sd):
        sd = {
            (k[len("vision_encoder.") :] if k.startswith("vision_encoder.") else k): v
            for k, v in sd.items()
        }
    report = ConversionReport()

    def take(name: str) -> np.ndarray:
        report.mapped.append(name)
        return _t(sd[name])

    def lin(name: str, bias: bool = True) -> dict:
        d = {"kernel": take(f"{name}.weight").T}
        if bias:
            d["bias"] = take(f"{name}.bias")
        return d

    params: dict = {}
    # Conv3d [C, 3, kt, kh, kw] -> dense kernel [patch_dim, C]; the flatten
    # order (c, kt, kh, kw) matches frames_to_tubelets
    w = take("patch_embed.proj.weight")
    params["patch_proj"] = {
        "kernel": w.reshape(w.shape[0], -1).T,
        "bias": take("patch_embed.proj.bias"),
    }
    params["cls"] = take("cls_token")
    params["pos_embed"] = take("pos_embed")
    for i in range(cfg.depth):
        e = f"blocks.{i}."
        blk = {
            "ln1": {"scale": take(f"{e}norm1.weight")},
            "qkv": lin(f"{e}attn.qkv", bias=cfg.qkv_bias),
            "attn_out": lin(f"{e}attn.proj"),
            "ls1": take(f"{e}ls1.gamma"),
            "ln2": {"scale": take(f"{e}norm2.weight")},
            "fc1": lin(f"{e}mlp.fc1"),
            "fc2": lin(f"{e}mlp.fc2"),
            "ls2": take(f"{e}ls2.gamma"),
        }
        if cfg.qk_normalization:
            blk["q_norm"] = {"scale": take(f"{e}attn.q_norm.weight")}
            blk["k_norm"] = {"scale": take(f"{e}attn.k_norm.weight")}
        params[f"block_{i}"] = blk
    # attentive pooling projector: separate q/k/v weights with separate
    # bias parameters (qkv_bias=True path, internvideo2.py:59)
    cp = "clip_projector."
    params["pool"] = {
        "ln_q": {
            "scale": take(f"{cp}norm1_q.weight"),
            "bias": take(f"{cp}norm1_q.bias"),
        },
        "ln_k": {
            "scale": take(f"{cp}norm1_k.weight"),
            "bias": take(f"{cp}norm1_k.bias"),
        },
        "ln_v": {
            "scale": take(f"{cp}norm1_v.weight"),
            "bias": take(f"{cp}norm1_v.bias"),
        },
        "q": {
            "kernel": take(f"{cp}cross_attn.q.weight").T,
            "bias": take(f"{cp}cross_attn.q_bias"),
        },
        "k": {
            "kernel": take(f"{cp}cross_attn.k.weight").T,
            "bias": take(f"{cp}cross_attn.k_bias"),
        },
        "v": {
            "kernel": take(f"{cp}cross_attn.v.weight").T,
            "bias": take(f"{cp}cross_attn.v_bias"),
        },
        "out": lin(f"{cp}cross_attn.proj"),
    }
    if "vision_proj.weight" in sd:
        params["vision_proj"] = lin("vision_proj")
    mapped = set(report.mapped)
    for k in sd:
        if k in mapped:
            continue
        if k.startswith(_SKIP_PREFIXES):
            report.vision_skipped.append(k)
        else:
            report.unmapped.append(k)
    if "vision_proj.weight" not in sd:
        report.unmapped.append("vision_proj.weight (absent in checkpoint)")
    return {"params": params}, report
