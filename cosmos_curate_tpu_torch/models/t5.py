"""T5 text encoder for caption embeddings (port of
``cosmos_curate_tpu/models/t5.py``).

The encoder stack of T5: RMS layer norms (weight only, fp32 inside), one
relative-position-bucket attention bias shared by every layer, unscaled
attention, bias-free projections. Compute runs in the module's ``dtype``
(bf16 by default) with fp32 parameters, in the reference's precision
sequence, which is not ``layers.TransformerBlock``'s:

- the residual stream stays in ``dtype``: each norm computes in fp32 and
  casts back to its input's dtype; only the final output is cast to fp32;
- q · kᵀ is rounded to ``dtype`` before the fp32 bias is added, and there
  is no ``D**-0.5`` scale;
- padded keys get an additive ``-1e9``, not ``-inf``.

The attention is plain PyTorch on every device: it adds a bias and a key
mask, so it is not the mask-free flash kernel, and the JAX package has no
Pallas kernel for it either.

``T5EncoderTPU`` serves it: texts -> per-token embeddings through a
``DevicePipeline``, on ``device`` ("cuda" unless the caller asks for the
CPU).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from cosmos_curate_tpu_torch.core.model import ModelInterface, model_device
from cosmos_curate_tpu_torch.models import registry
from cosmos_curate_tpu_torch.models.batching import next_pow2
from cosmos_curate_tpu_torch.models.device_pipeline import DevicePipeline
from cosmos_curate_tpu_torch.models.layers import Linear


@dataclass(frozen=True)
class T5Config:
    vocab: int = 512  # byte-level default; converted checkpoints use 32128
    dim: int = 512
    d_kv: int = 64
    d_ff: int = 2048
    layers: int = 8
    heads: int = 8
    max_len: int = 512
    num_buckets: int = 32
    max_distance: int = 128
    act: str = "relu"  # "relu" (t5 v1.0) | "gated-gelu" (v1.1 / flan)
    ln_eps: float = 1e-6


T5_BASE = T5Config()
# google-t5/t5-small's shapes; its ids come from a tokenizer.json
T5_SMALL = T5Config(vocab=32128, dim=512, d_kv=64, d_ff=2048, layers=6, heads=8)
T5_TINY_TEST = T5Config(vocab=512, dim=32, d_kv=16, d_ff=64, layers=1, heads=2, max_len=64)


@dataclass
class EncodedSample:
    """One caption's encoding."""

    text: str
    tokens: np.ndarray  # int32 [T]
    embedding: np.ndarray  # float32 [T, dim]
    mask: np.ndarray  # bool [T]


class T5LayerNorm(nn.Module):
    """RMS norm, weight only, computed in fp32 and cast back to the input's
    dtype."""

    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))

    def forward(self, x):
        xf = x.float()
        var = xf.square().mean(dim=-1, keepdim=True)
        return (self.weight * xf * torch.rsqrt(var + self.eps)).to(x.dtype)


def t5_relative_position_bucket(relative_position: torch.Tensor, *, num_buckets: int = 32, max_distance: int = 128):
    """Bidirectional T5 bucketing of (key_pos - query_pos) distances. Call
    it on the CPU (``T5RelativeBias`` does): the log's last bit decides the
    bucket at the edges, so the table is made by one implementation."""
    nb = num_buckets // 2
    buckets = torch.where(relative_position > 0, nb, 0)
    rel = relative_position.abs()
    max_exact = nb // 2
    is_small = rel < max_exact
    large = max_exact + (
        torch.log(rel.clamp(min=1).float() / max_exact) / float(np.log(max_distance / max_exact)) * (nb - max_exact)
    ).to(torch.int32)
    large = large.clamp(max=nb - 1)
    return buckets + torch.where(is_small, rel, large)


class T5RelativeBias(nn.Module):
    """The bucket table ``[num_buckets, heads]`` (flax's ``embedding``)."""

    def __init__(self, cfg: T5Config):
        super().__init__()
        self.cfg = cfg
        self.weight = nn.Parameter(torch.zeros(cfg.num_buckets, cfg.heads))
        self._buckets: dict[int, torch.Tensor] = {}

    def buckets(self, s: int) -> torch.Tensor:
        """The ``[s, s]`` bucket ids, made on the CPU once per length."""
        if s not in self._buckets:
            pos = torch.arange(s)
            self._buckets[s] = t5_relative_position_bucket(
                pos[None, :] - pos[:, None], num_buckets=self.cfg.num_buckets, max_distance=self.cfg.max_distance
            ).long()
        return self._buckets[s]

    def forward(self, s: int):
        """-> ``[1, heads, s, s]`` fp32 attention bias."""
        idx = self.buckets(s).to(self.weight.device, non_blocking=True)
        return self.weight[idx].permute(2, 0, 1)[None]


class T5Attention(nn.Module):
    def __init__(self, cfg: T5Config, dtype=torch.bfloat16):
        super().__init__()
        inner = cfg.heads * cfg.d_kv
        self.cfg = cfg
        self.dtype = dtype
        self.q = Linear(cfg.dim, inner, bias=False, dtype=dtype)
        self.k = Linear(cfg.dim, inner, bias=False, dtype=dtype)
        self.v = Linear(cfg.dim, inner, bias=False, dtype=dtype)
        self.o = Linear(inner, cfg.dim, bias=False, dtype=dtype)

    def forward(self, x, bias):
        cfg = self.cfg
        b, s, _ = x.shape
        q = self.q(x).reshape(b, s, cfg.heads, cfg.d_kv)
        k = self.k(x).reshape(b, s, cfg.heads, cfg.d_kv)
        v = self.v(x).reshape(b, s, cfg.heads, cfg.d_kv)
        logits = torch.einsum("bqhd,bkhd->bhqk", q, k).float() + bias
        probs = torch.softmax(logits, dim=-1).to(self.dtype)
        out = torch.einsum("bhqk,bkhd->bqhd", probs, v).reshape(b, s, cfg.heads * cfg.d_kv)
        return self.o(out)


class T5FF(nn.Module):
    def __init__(self, cfg: T5Config, dtype=torch.bfloat16):
        super().__init__()
        self.gated = cfg.act == "gated-gelu"
        if self.gated:
            self.wi_0 = Linear(cfg.dim, cfg.d_ff, bias=False, dtype=dtype)
            self.wi_1 = Linear(cfg.dim, cfg.d_ff, bias=False, dtype=dtype)
        else:
            self.wi = Linear(cfg.dim, cfg.d_ff, bias=False, dtype=dtype)
        self.wo = Linear(cfg.d_ff, cfg.dim, bias=False, dtype=dtype)

    def forward(self, x):
        if self.gated:
            # exact (erf) gelu times the gate in fp32, rounded once: XLA
            # fuses the reference's elementwise chain and keeps it in fp32
            h = (F.gelu(self.wi_0(x).float()) * self.wi_1(x).float()).to(x.dtype)
        else:
            h = F.relu(self.wi(x))
        return self.wo(h)


class T5EncoderBlock(nn.Module):
    def __init__(self, cfg: T5Config, dtype=torch.bfloat16):
        super().__init__()
        self.ln1 = T5LayerNorm(cfg.dim, eps=cfg.ln_eps)
        self.attn = T5Attention(cfg, dtype=dtype)
        self.ln2 = T5LayerNorm(cfg.dim, eps=cfg.ln_eps)
        self.mlp = T5FF(cfg, dtype=dtype)

    def forward(self, x, bias):
        x = x + self.attn(self.ln1(x), bias)
        return x + self.mlp(self.ln2(x))


class T5Encoder(nn.Module):
    """ids ``[B, T]``, mask ``[B, T]`` bool -> per-token embeddings
    ``[B, T, dim]`` fp32."""

    def __init__(self, cfg: T5Config, dtype=torch.bfloat16):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        self.shared = nn.Embedding(cfg.vocab, cfg.dim)
        self.rel_bias = T5RelativeBias(cfg)
        self.blocks = nn.ModuleList(T5EncoderBlock(cfg, dtype=dtype) for _ in range(cfg.layers))
        self.ln_final = T5LayerNorm(cfg.dim, eps=cfg.ln_eps)

    def init_weights(self, gen: torch.Generator) -> None:
        """T5's own initialisation (mesh-tensorflow's, as HF's
        ``T5PreTrainedModel`` applies it): attention without a ``D**-0.5``
        scale keeps its logits at unit scale only through q's smaller
        draw. Normal draws: the embedding at 1, q at (dim * d_kv)^-1/2,
        k / v / wi at dim^-1/2, o at (heads * d_kv)^-1/2, wo at d_ff^-1/2,
        the bucket table at dim^-1/2; the norms keep their unit weight."""
        cfg = self.cfg
        std = {"q": (cfg.dim * cfg.d_kv) ** -0.5, "k": cfg.dim**-0.5, "v": cfg.dim**-0.5,
               "o": (cfg.heads * cfg.d_kv) ** -0.5, "wi": cfg.dim**-0.5, "wi_0": cfg.dim**-0.5,
               "wi_1": cfg.dim**-0.5, "wo": cfg.d_ff**-0.5}
        with torch.no_grad():
            self.shared.weight.normal_(0.0, 1.0, generator=gen)
            self.rel_bias.weight.normal_(0.0, cfg.dim**-0.5, generator=gen)
            for name, m in self.named_modules():
                if isinstance(m, Linear):
                    m.weight.normal_(0.0, std[name.rsplit(".", 1)[-1]], generator=gen)

    def forward(self, ids, mask):
        x = self.shared(ids).to(self.dtype)
        # key-side padding mask, additive (HF's extended attention mask)
        bias = self.rel_bias(ids.shape[1]) + torch.where(mask[:, None, None, :], 0.0, -1e9)
        for block in self.blocks:
            x = block(x, bias)
        return self.ln_final(x).float()


class T5EncoderTPU(ModelInterface):
    """Texts -> per-token T5 embeddings on ``device`` ("cuda" unless the
    caller asks for the CPU). ``params``: a ``state_dict`` of
    :class:`T5Encoder`, else the staged checkpoint, else the seeded init."""

    MODEL_ID = "t5-encoder-tpu"

    def __init__(
        self,
        cfg: T5Config = T5_BASE,
        *,
        tokenizer=None,
        params: dict | None = None,
        device: str | torch.device = "cuda",
    ) -> None:
        self.device = model_device(device, "the T5 encoder")
        self.cfg = cfg
        # resolved in setup(): the guards must see the staged state then
        self.tokenizer = tokenizer
        self.params = params
        self.model: T5Encoder | None = None
        self._pipeline: DevicePipeline | None = None

    def _resolve_tokenizer(self):
        """A staged ``tokenizer.json`` (exact T5 ids) wins; the byte
        tokenizer serves a seeded init only. A staged checkpoint without its
        ``tokenizer.json`` refuses (byte ids would address the wrong
        embedding rows; pass ``tokenizer=`` to override), and so does a
        tokenizer with more ids than the config embeds."""
        from cosmos_curate_tpu_torch.models.tokenizer import ByteTokenizer, t5_tokenizer

        # the remote checkpoint first, so the guard below sees what
        # load_params will load; its tokenizer.json only where a checkpoint
        # is in play
        if registry.resolve_checkpoint(self.MODEL_ID) is not None:
            registry.maybe_pull_tokenizer_files(self.MODEL_ID)
        tok = t5_tokenizer(self.MODEL_ID)
        if isinstance(tok, ByteTokenizer) and registry.find_checkpoint(self.MODEL_ID):
            raise FileNotFoundError(
                f"{self.MODEL_ID} has a staged checkpoint but no tokenizer.json — byte-level ids would "
                "address wrong embedding rows; stage the checkpoint's tokenizer.json (or pass tokenizer= "
                "explicitly for a byte-trained model)"
            )
        if tok.vocab_size > self.cfg.vocab:
            raise ValueError(
                f"staged tokenizer has {tok.vocab_size} ids but the config embeds only {self.cfg.vocab} — "
                "use the matching T5Config (e.g. T5_SMALL for converted checkpoints)"
            )
        return tok

    @property
    def model_id_names(self) -> list[str]:
        return [self.MODEL_ID]

    def setup(self) -> None:
        if self.tokenizer is None:
            self.tokenizer = self._resolve_tokenizer()
        with torch.device(self.device):
            model = T5Encoder(self.cfg)
        registry.load_module(model, self.MODEL_ID, self.params)
        self.model = model.eval().requires_grad_(False)
        self._pipeline = DevicePipeline("t5-encode", self._forward, device=self.device)

    @torch.inference_mode()
    def _forward(self, ids, mask):
        return self.model(ids, mask)

    def encode(self, texts: list[str]) -> list[EncodedSample]:
        if self._pipeline is None:
            raise RuntimeError("call setup() first")
        if not texts:
            return []
        tok = self.tokenizer
        max_len = self.cfg.max_len

        def truncate(ids: list[int]) -> list[int]:
            if len(ids) <= max_len:
                return ids
            out = ids[:max_len]
            # HF fast tokenizers truncate before post-processing, so a final
            # </s> survives; keep it where there was one
            if ids[-1] == tok.eos_id and out[-1] != tok.eos_id:
                out[-1] = tok.eos_id
            return out

        encoded = [truncate(tok.encode(t)) for t in texts]
        t_pad = min(next_pow2(max(len(e) for e in encoded)), max_len)
        ids = np.full((len(texts), t_pad), tok.pad_id, np.int32)
        mask = np.zeros((len(texts), t_pad), bool)
        for i, e in enumerate(encoded):
            ids[i, : len(e)] = e
            mask[i, : len(e)] = True
        # rows bucket into pow2 micro-batches; ids and mask pad together
        emb = self._pipeline.run(ids, mask)
        return [
            EncodedSample(text=texts[i], tokens=ids[i][mask[i]], embedding=emb[i][mask[i]], mask=mask[i])
            for i in range(len(texts))
        ]


registry.register_model(T5EncoderTPU.MODEL_ID, "text encoder for caption embeddings")
