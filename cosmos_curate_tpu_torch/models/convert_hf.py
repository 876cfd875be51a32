"""HF checkpoint converters: real pretrained weights -> the reference's flax
layouts (port of ``cosmos_curate_tpu/models/convert_hf.py``).

Each converter takes an HF model (any object with ``.state_dict()`` and,
where the layer count is read, ``.config``) or a state dict of torch
tensors or numpy arrays, and returns the same flax-layout numpy tree as
the reference's converter. Staged with ``models/registry.py::save_params``
under the JAX registry ids, the tree loads into the port's models through
``registry.load_params`` (``convert_jax.flax_to_state_dict``).
``convert_clip_vision`` covers CLIP-family vision towers
(openai/clip-vit-*-patch*), whose ``ViTConfig`` must use
``act="quick_gelu", ln_eps=1e-5``; ``convert_clip_text`` the CLIP text
tower, ``convert_aesthetic_head`` the LAION aesthetic MLP and
``convert_t5_encoder`` T5's encoder.

Parity is held by test (tests/test_torch_convert_hf.py): the same state
dict through the reference's converter gives the same tree, and the port's
models loaded from it match HF's own models built from config.
"""

from __future__ import annotations

import numpy as np

from cosmos_curate_tpu_torch.models.vit import ViTConfig
from cosmos_curate_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)


def clip_vision_config(hf_config) -> ViTConfig:
    """ViTConfig matching an HF CLIPVisionConfig; fails fast on shapes or
    activations our ViT cannot represent (silent mismatch would surface as
    a confusing shape error, or worse, wrong numerics, at load)."""
    if hf_config.intermediate_size != 4 * hf_config.hidden_size:
        raise ValueError(
            f"unsupported MLP ratio: intermediate {hf_config.intermediate_size} "
            f"!= 4 x hidden {hf_config.hidden_size}"
        )
    if hf_config.hidden_act not in ("gelu", "quick_gelu"):
        raise ValueError(f"unsupported activation {hf_config.hidden_act!r}")
    return ViTConfig(
        image_size=hf_config.image_size,
        patch_size=hf_config.patch_size,
        width=hf_config.hidden_size,
        layers=hf_config.num_hidden_layers,
        heads=hf_config.num_attention_heads,
        projection_dim=hf_config.projection_dim,
        act=hf_config.hidden_act,
        ln_eps=hf_config.layer_norm_eps,
    )


def _t(w) -> np.ndarray:
    return np.asarray(w.detach().cpu().numpy() if hasattr(w, "detach") else w)


def convert_clip_vision(hf_model) -> dict:
    """transformers CLIPVisionModelWithProjection → our ViT params tree."""
    sd = {k: _t(v) for k, v in hf_model.state_dict().items()}
    v = "vision_model."
    params: dict = {}
    # patchify conv: torch [out, in, kh, kw] -> flax [kh, kw, in, out]
    params["patch_embed"] = {
        "kernel": sd[f"{v}embeddings.patch_embedding.weight"].transpose(2, 3, 1, 0)
    }
    params["cls"] = sd[f"{v}embeddings.class_embedding"][None, None, :]
    params["pos_embed"] = sd[f"{v}embeddings.position_embedding.weight"][None]
    params["ln_pre"] = {
        "scale": sd[f"{v}pre_layrnorm.weight"],  # (sic — HF's own key name)
        "bias": sd[f"{v}pre_layrnorm.bias"],
    }
    params["ln_post"] = {
        "scale": sd[f"{v}post_layernorm.weight"],
        "bias": sd[f"{v}post_layernorm.bias"],
    }
    n_layers = hf_model.config.num_hidden_layers
    for i in range(n_layers):
        e = f"{v}encoder.layers.{i}."

        def lin(name):  # torch Linear [out, in] -> flax kernel [in, out]
            return {
                "kernel": sd[f"{e}{name}.weight"].T,
                "bias": sd[f"{e}{name}.bias"],
            }

        params[f"block_{i}"] = {
            "ln1": {"scale": sd[f"{e}layer_norm1.weight"], "bias": sd[f"{e}layer_norm1.bias"]},
            "ln2": {"scale": sd[f"{e}layer_norm2.weight"], "bias": sd[f"{e}layer_norm2.bias"]},
            "attn": {
                "q": lin("self_attn.q_proj"),
                "k": lin("self_attn.k_proj"),
                "v": lin("self_attn.v_proj"),
                "out": lin("self_attn.out_proj"),
            },
            "mlp": {"up": lin("mlp.fc1"), "down": lin("mlp.fc2")},
        }
    params["proj"] = {"kernel": sd["visual_projection.weight"].T}
    logger.info("converted CLIP vision tower: %d layers", n_layers)
    return {"params": params}


def clip_text_config(hf_config):
    """CLIPTextConfig matching an HF CLIPTextConfig (fails fast like
    ``clip_vision_config``)."""
    from cosmos_curate_tpu_torch.models.clip_text import CLIPTextConfig

    if hf_config.intermediate_size != 4 * hf_config.hidden_size:
        raise ValueError(
            f"unsupported MLP ratio: intermediate {hf_config.intermediate_size} "
            f"!= 4 x hidden {hf_config.hidden_size}"
        )
    if hf_config.hidden_act not in ("gelu", "quick_gelu"):
        raise ValueError(f"unsupported activation {hf_config.hidden_act!r}")
    return CLIPTextConfig(
        vocab=hf_config.vocab_size,
        width=hf_config.hidden_size,
        layers=hf_config.num_hidden_layers,
        heads=hf_config.num_attention_heads,
        max_len=hf_config.max_position_embeddings,
        projection_dim=hf_config.projection_dim,
        act=hf_config.hidden_act,
        ln_eps=hf_config.layer_norm_eps,
    )


def convert_clip_text(hf_model) -> dict:
    """transformers CLIPTextModelWithProjection → our CLIPTextEncoder params."""
    sd = {k: _t(v) for k, v in hf_model.state_dict().items()}
    t = "text_model."
    params: dict = {
        "tok_embed": {"embedding": sd[f"{t}embeddings.token_embedding.weight"]},
        "pos_embed": sd[f"{t}embeddings.position_embedding.weight"][None],
        "ln_final": {
            "scale": sd[f"{t}final_layer_norm.weight"],
            "bias": sd[f"{t}final_layer_norm.bias"],
        },
    }
    n_layers = hf_model.config.num_hidden_layers
    for i in range(n_layers):
        e = f"{t}encoder.layers.{i}."

        def lin(name):
            return {
                "kernel": sd[f"{e}{name}.weight"].T,
                "bias": sd[f"{e}{name}.bias"],
            }

        params[f"block_{i}"] = {
            "ln1": {"scale": sd[f"{e}layer_norm1.weight"], "bias": sd[f"{e}layer_norm1.bias"]},
            "ln2": {"scale": sd[f"{e}layer_norm2.weight"], "bias": sd[f"{e}layer_norm2.bias"]},
            "attn": {
                "q": lin("self_attn.q_proj"),
                "k": lin("self_attn.k_proj"),
                "v": lin("self_attn.v_proj"),
                "out": lin("self_attn.out_proj"),
            },
            "mlp": {"up": lin("mlp.fc1"), "down": lin("mlp.fc2")},
        }
    params["proj"] = {"kernel": sd["text_projection.weight"].T}
    logger.info("converted CLIP text tower: %d layers", n_layers)
    return {"params": params}


def convert_aesthetic_head(state_dict) -> dict:
    """ttj/sac-logos-ava1-l14-linearMSE MLP state dict → AestheticMLP params.

    The published checkpoint (reference models/aesthetics.py:44-53) is an
    ``nn.Sequential``: Linear(768,1024) @0, Dropout, Linear(1024,128) @2,
    Dropout, Linear(128,64) @4, Dropout, Linear(64,16) @6, Linear(16,1) @7.
    Accepts keys both as ``layers.N.weight`` and bare ``N.weight``.
    """
    sd = {k: _t(v) for k, v in state_dict.items()}

    def get(idx: int) -> dict:
        for prefix in ("layers.", ""):
            wk = f"{prefix}{idx}.weight"
            if wk in sd:
                return {"kernel": sd[wk].T, "bias": sd[f"{prefix}{idx}.bias"]}
        raise KeyError(f"no Linear at sequential index {idx} in state dict")

    params = {f"fc{j}": get(idx) for j, idx in enumerate((0, 2, 4, 6))}
    params["out"] = get(7)
    logger.info("converted aesthetic head: %d linear layers", 5)
    return {"params": params}


def t5_encoder_config(hf_config):
    """Our T5Config from an HF T5Config."""
    from cosmos_curate_tpu_torch.models.t5 import T5Config

    act = "gated-gelu" if getattr(hf_config, "is_gated_act", False) else "relu"
    return T5Config(
        vocab=hf_config.vocab_size,
        dim=hf_config.d_model,
        d_kv=hf_config.d_kv,
        d_ff=hf_config.d_ff,
        layers=hf_config.num_layers,
        heads=hf_config.num_heads,
        num_buckets=hf_config.relative_attention_num_buckets,
        max_distance=getattr(hf_config, "relative_attention_max_distance", 128),
        act=act,
        ln_eps=hf_config.layer_norm_epsilon,
    )


def convert_t5_encoder(hf_model) -> dict:
    """transformers T5EncoderModel → our T5Encoder params."""
    sd = {k: _t(v) for k, v in hf_model.state_dict().items()}
    cfg = hf_model.config
    params: dict = {
        "shared": {"embedding": sd["shared.weight"]},
        "rel_bias": {
            "embedding": sd[
                "encoder.block.0.layer.0.SelfAttention.relative_attention_bias.weight"
            ]
        },
        "ln_final": {"weight": sd["encoder.final_layer_norm.weight"]},
    }
    gated = getattr(cfg, "is_gated_act", False)
    for i in range(cfg.num_layers):
        e = f"encoder.block.{i}."

        def lin(name):
            return {"kernel": sd[f"{e}{name}.weight"].T}

        mlp = (
            {
                "wi_0": lin("layer.1.DenseReluDense.wi_0"),
                "wi_1": lin("layer.1.DenseReluDense.wi_1"),
                "wo": lin("layer.1.DenseReluDense.wo"),
            }
            if gated
            else {
                "wi": lin("layer.1.DenseReluDense.wi"),
                "wo": lin("layer.1.DenseReluDense.wo"),
            }
        )
        params[f"block_{i}"] = {
            "ln1": {"weight": sd[f"{e}layer.0.layer_norm.weight"]},
            "ln2": {"weight": sd[f"{e}layer.1.layer_norm.weight"]},
            "attn": {
                "q": lin("layer.0.SelfAttention.q"),
                "k": lin("layer.0.SelfAttention.k"),
                "v": lin("layer.0.SelfAttention.v"),
                "o": lin("layer.0.SelfAttention.o"),
            },
            "mlp": mlp,
        }
    logger.info("converted T5 encoder: %d layers", cfg.num_layers)
    return {"params": params}
