"""CLIP text tower: causal transformer, EOT pooling, projection (port of
``cosmos_curate_tpu/models/clip_text.py``).

Token plus position embedding in the compute dtype, causal
``layers.TransformerBlock``s (``quick_gelu``, ``ln_eps`` 1e-5), an fp32
final LayerNorm, the feature at the EOT position (``ids.argmax(-1)``) and
a bias-free projection. On the GPU each block's attention is the flash
kernel's causal branch (``layers.Attention``: mask-free), at ``[N, 8, T,
64]`` for the B tower and ``[N, 12, T, 64]`` for L, T a power of two up to
77; the CPU runs the einsum lines.

``CLIPTextEmbeddings`` serves it: token ids or texts -> L2-normalised
embeddings through a ``DevicePipeline``, on ``device`` ("cuda" unless the
caller asks for the CPU). Texts are tokenized by the checkpoint's CLIP BPE
(``vocab.json`` + ``merges.txt``) when staged, else by the hermetic
fallback.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path
from typing import Any

import numpy as np
import torch
from torch import nn

from cosmos_curate_tpu_torch.core.model import ModelInterface, model_device
from cosmos_curate_tpu_torch.models import registry
from cosmos_curate_tpu_torch.models.batching import next_pow2
from cosmos_curate_tpu_torch.models.device_pipeline import DevicePipeline
from cosmos_curate_tpu_torch.models.layers import LayerNorm, Linear, TransformerBlock
from cosmos_curate_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)


@dataclass(frozen=True)
class CLIPTextConfig:
    vocab: int = 49408
    width: int = 512
    layers: int = 12
    heads: int = 8
    max_len: int = 77
    projection_dim: int = 512
    act: str = "quick_gelu"
    ln_eps: float = 1e-5

    @property
    def head_dim(self) -> int:
        return self.width // self.heads


CLIP_TEXT_B = CLIPTextConfig()
CLIP_TEXT_L = CLIPTextConfig(width=768, layers=12, heads=12, projection_dim=768)
CLIP_TEXT_TINY_TEST = CLIPTextConfig(vocab=64, width=32, layers=2, heads=2, max_len=16, projection_dim=16)


class CLIPTextEncoder(nn.Module):
    """ids ``[B, T]`` -> (pooled ``[B, P]`` fp32, tokens ``[B, T, W]`` fp32).

    Pooling reads the feature at ``ids.argmax(-1)``: EOT has the highest id
    of CLIP's vocabulary, so callers append it and pad with a lower id."""

    def __init__(self, cfg: CLIPTextConfig, dtype=torch.bfloat16):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        self.tok_embed = nn.Embedding(cfg.vocab, cfg.width)
        self.pos_embed = nn.Parameter(torch.zeros(1, cfg.max_len, cfg.width))
        self.blocks = nn.ModuleList(
            TransformerBlock(cfg.width, cfg.heads, cfg.head_dim, dtype=dtype, causal=True, act=cfg.act,
                             ln_eps=cfg.ln_eps)
            for _ in range(cfg.layers)
        )
        self.ln_final = LayerNorm(cfg.width, eps=cfg.ln_eps)
        self.proj = Linear(cfg.width, cfg.projection_dim, bias=False, dtype=dtype)

    def init_weights(self, gen: torch.Generator) -> None:
        """flax's initialisers: the embedding at variance 1 / width, the
        position table normal(0.01), xavier-uniform projections (norms keep
        their unit scale and zero bias)."""
        with torch.no_grad():
            self.tok_embed.weight.normal_(0.0, self.cfg.width**-0.5, generator=gen)
            self.pos_embed.normal_(0.0, 0.01, generator=gen)
        for m in self.modules():
            if isinstance(m, Linear):
                m.init_weights(gen)

    def forward(self, ids):
        t = ids.shape[1]
        x = self.tok_embed(ids).to(self.dtype) + self.pos_embed[:, :t].to(self.dtype)
        for block in self.blocks:
            x = block(x)
        x = self.ln_final(x)
        eot = ids.argmax(dim=-1)
        pooled = x[torch.arange(x.shape[0], device=x.device), eot]
        return self.proj(pooled).float(), x


class CLIPTextEmbeddings(ModelInterface):
    """Batched token ids -> L2-normalised text embeddings. ``params``: a
    ``state_dict`` of :class:`CLIPTextEncoder`, else the staged checkpoint
    under the variant's id, else the seeded init."""

    _CONFIGS = {
        "clip-text-b-tpu": CLIP_TEXT_B,
        "clip-text-l-tpu": CLIP_TEXT_L,
        "clip-text-tiny-test": CLIP_TEXT_TINY_TEST,
    }

    def __init__(
        self,
        variant: str = "clip-text-b-tpu",
        *,
        params: dict[str, Any] | None = None,
        device: str | torch.device = "cuda",
    ) -> None:
        if variant not in self._CONFIGS:
            raise ValueError(f"unknown variant {variant!r}; have {sorted(self._CONFIGS)}")
        self.device = model_device(device, "the CLIP text tower")
        self.variant = variant
        self.cfg = self._CONFIGS[variant]
        self.params = params
        self.model: CLIPTextEncoder | None = None
        self._pipeline: DevicePipeline | None = None
        self._tokenizer = None

    @property
    def model_id_names(self) -> list[str]:
        return [self.variant]

    @property
    def embedding_dim(self) -> int:
        return self.cfg.projection_dim

    def setup(self) -> None:
        with torch.device(self.device):
            model = CLIPTextEncoder(self.cfg)
        registry.load_module(model, self.variant, self.params)
        self.model = model.eval().requires_grad_(False)
        self._pipeline = DevicePipeline(f"clip-text/{self.variant}", self._forward, device=self.device)

    @torch.inference_mode()
    def _forward(self, ids):
        pooled, _ = self.model(ids)
        return pooled / torch.linalg.norm(pooled, dim=-1, keepdim=True)

    def encode_ids(self, ids: np.ndarray) -> np.ndarray:
        """int32 ``[N, T]`` (EOT appended, pad after) -> float32 ``[N, P]``,
        through the pipeline."""
        if self._pipeline is None:
            raise RuntimeError("call setup() first")
        return self._pipeline.run(np.asarray(ids, np.int32))

    @property
    def provenance(self) -> str:
        """Where this tower's weights come from right now (``"random"``
        until a checkpoint is staged)."""
        return registry.weights_provenance(self.variant)

    def encode_texts(self, texts: list[str]) -> np.ndarray:
        """Strings -> L2-normalised float32 ``[N, P]``. Rows pad with id 0
        (below EOT, so argmax pooling finds EOT) to a shared power-of-two
        width of at most ``max_len``."""
        if not texts:
            return np.zeros((0, self.cfg.projection_dim), np.float32)
        if self._tokenizer is None:
            self._tokenizer = clip_text_tokenizer(self.variant, self.cfg)
        rows = [self._tokenizer.encode(t, max_len=self.cfg.max_len) for t in texts]
        width = min(self.cfg.max_len, next_pow2(max(len(r) for r in rows)))
        ids = np.zeros((len(rows), width), np.int32)
        for i, r in enumerate(rows):
            ids[i, : len(r)] = r[:width]
        return self.encode_ids(ids)


# ---------------------------------------------------------------------------
# query tokenization


class CLIPTokenizer:
    """CLIP's BPE (the HF ``vocab.json`` + ``merges.txt`` format): lowercased
    input, GPT-2 byte alphabet, ``</w>`` end-of-word marker,
    ``<|startoftext|>`` / ``<|endoftext|>`` around the tokens. EOT is the
    vocabulary's largest id, which the encoder's argmax pooling needs.
    Imports ``regex`` when built."""

    def __init__(
        self,
        vocab: dict[str, int],
        merges: list[tuple[str, str]],
        *,
        sot: str = "<|startoftext|>",
        eot: str = "<|endoftext|>",
    ) -> None:
        import regex  # \p{L} / \p{N} classes: the standard re module has none

        from cosmos_curate_tpu_torch.models.tokenizer import _gpt2_byte_encoder

        self.vocab = vocab
        self.ranks = {m: i for i, m in enumerate(merges)}
        self.sot_id = vocab[sot]
        self.eot_id = vocab[eot]
        self._byte_enc = _gpt2_byte_encoder()
        # open_clip's simple_tokenizer split
        self._splitter = regex.compile(
            r"'s|'t|'re|'ve|'m|'ll|'d|[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+",
            regex.IGNORECASE,
        )
        self._cache: dict[str, list[int]] = {}

    @classmethod
    def from_files(cls, vocab_json, merges_txt) -> "CLIPTokenizer":
        vocab = json.loads(Path(vocab_json).read_text())
        merges: list[tuple[str, str]] = []
        for line in Path(merges_txt).read_text().splitlines():
            if not line or line.startswith("#version"):
                continue
            left, _, right = line.partition(" ")
            merges.append((left, right))
        return cls(vocab, merges)

    def _bpe(self, word: str) -> list[int]:
        cached = self._cache.get(word)
        if cached is not None:
            return cached
        chars = "".join(self._byte_enc[b] for b in word.encode("utf-8"))
        if not chars:
            return []
        parts = list(chars[:-1]) + [chars[-1] + "</w>"]
        while len(parts) > 1:
            best, best_rank = -1, None
            for i in range(len(parts) - 1):
                r = self.ranks.get((parts[i], parts[i + 1]))
                if r is not None and (best_rank is None or r < best_rank):
                    best, best_rank = i, r
            if best_rank is None:
                break
            parts[best : best + 2] = [parts[best] + parts[best + 1]]
        out = [self.vocab[p] for p in parts if p in self.vocab]
        if len(self._cache) < 16384:
            self._cache[word] = out
        return out

    def encode(self, text: str, *, max_len: int = 77) -> list[int]:
        """[SOT] + BPE tokens + [EOT], truncated so that EOT always
        survives (the pooled feature is read there)."""
        ids = [self.sot_id]
        for piece in self._splitter.findall(" ".join(text.lower().split())):
            ids.extend(self._bpe(piece))
        ids = ids[: max_len - 1]
        ids.append(self.eot_id)
        return ids


class FallbackClipTokenizer:
    """The stand-in when no tokenizer files are staged (tiny-test configs,
    seeded runs): bytes fold into the body id range, SOT / EOT take the two
    top ids so EOT stays the row's argmax, 0 stays the pad id. Not a
    semantic tokenizer."""

    def __init__(self, vocab_size: int) -> None:
        if vocab_size < 4:
            raise ValueError("vocab too small for SOT/EOT + body ids")
        self.sot_id = vocab_size - 2
        self.eot_id = vocab_size - 1
        self._body = vocab_size - 3  # ids 1..vocab-3

    def encode(self, text: str, *, max_len: int = 77) -> list[int]:
        ids = [self.sot_id]
        ids.extend(1 + (b % self._body) for b in text.lower().encode("utf-8"))
        ids = ids[: max_len - 1]
        ids.append(self.eot_id)
        return ids


def clip_text_tokenizer(variant: str, cfg: CLIPTextConfig):
    """The query tokenizer of ``variant``: the checkpoint's staged CLIP BPE
    when both files are present, else the fallback sized to the config's
    vocabulary. The BPE files are pulled from ``CURATE_WEIGHTS_URI`` where
    they are there and not staged; an unreachable store leaves the
    fallback."""
    try:
        registry.maybe_pull_tokenizer_files(variant)
    except (OSError, RuntimeError) as e:  # storage errors are RuntimeErrors; the fallback below serves
        logger.warning("tokenizer files of %s not pulled: %s", variant, e)
    vocab = registry.find_model_file(variant, "vocab.json")
    merges = registry.find_model_file(variant, "merges.txt")
    if vocab is not None and merges is not None:
        return CLIPTokenizer.from_files(vocab, merges)
    return FallbackClipTokenizer(cfg.vocab)


registry.register_model("clip-text-b-tpu", "CLIP text tower, ViT-B width")
registry.register_model("clip-text-l-tpu", "CLIP text tower, ViT-L width")
