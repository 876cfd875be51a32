"""Shared building blocks (port of ``cosmos_curate_tpu/models/layers.py``).

Parameters are kept in fp32 and compute runs in the module's ``dtype``
(bf16 by default), as the flax modules do with ``param_dtype=float32,
dtype=bfloat16``: a :class:`Linear` casts its input and weight to ``dtype``
and adds the bias in ``dtype`` after the product. Tensor-parallel sharding
annotations have no counterpart yet (one GPU).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from cosmos_curate_tpu_torch.ops.flash_attention import flash_attention


def _use_flash(x, mask) -> bool:
    """Mask-free self-attention on the GPU goes through the flash kernel at
    every length (no TPU-derived length gate carries over); the CPU keeps
    the einsum lines, which is what the JAX package runs off-TPU."""
    return mask is None and x.device.type == "cuda"


@torch.no_grad()
def lecun_normal_(w: torch.Tensor, gen: torch.Generator) -> None:
    """flax's default kernel init in place: a normal truncated at two
    standard deviations, scaled to variance 1 / fan-in (``w[0]``'s size for
    torch's out-first Linear and Conv weights)."""
    std = math.sqrt(1.0 / w[0].numel()) / 0.87962566103423978
    unit = torch.nn.init.trunc_normal_(torch.empty_like(w), a=-2.0, b=2.0, generator=gen)
    w.copy_(unit * std)


class Linear(nn.Linear):
    """flax ``Dense(dtype=dtype, param_dtype=float32)``: weight ``[out, in]``
    (the transpose of flax's ``kernel [in, out]``); input, weight and bias
    cast to ``dtype``. :meth:`init_weights` applies flax's xavier-uniform
    kernel and zero bias."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True, dtype=torch.bfloat16):
        super().__init__(in_features, out_features, bias=bias)
        self.dtype = dtype

    def init_weights(self, gen: torch.Generator) -> None:
        fan_out, fan_in = self.weight.shape
        limit = math.sqrt(6.0 / (fan_in + fan_out))
        with torch.no_grad():
            self.weight.uniform_(-limit, limit, generator=gen)
            if self.bias is not None:
                self.bias.zero_()

    def forward(self, x):
        y = torch.matmul(x.to(self.dtype), self.weight.to(self.dtype).t())
        if self.bias is not None:
            y = y + self.bias.to(self.dtype)
        return y


class LayerNorm(nn.Module):
    """flax ``LayerNorm(dtype=float32)``: statistics in fp32 with the fast
    variance ``E[x^2] - E[x]^2`` (clipped at 0), output in fp32."""

    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x):
        x = x.float()
        mean = x.mean(dim=-1, keepdim=True)
        mean2 = (x * x).mean(dim=-1, keepdim=True)
        var = torch.clamp(mean2 - mean * mean, min=0.0)
        mul = torch.rsqrt(var + self.eps) * self.weight
        return (x - mean) * mul + self.bias


def quick_gelu(x):
    """OpenAI CLIP's activation: x * sigmoid(1.702 x)."""
    return x * torch.sigmoid(1.702 * x)


def gelu(x):
    """flax ``nn.gelu``: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


_ACTIVATIONS = {"gelu": gelu, "quick_gelu": quick_gelu}

# clips per plain-attention chunk (the InternVideo2 and Qwen towers): 4 x
# 268 MB of fp32 logits at IV2_1B, 4 x 64 MB at a Qwen tower's 8 frames
ATTN_CHUNK_CLIPS = 4


def chunked_attention(q, k, v, dtype, *, mask=None, scale_q=False):
    """``[B, Sq, H, D]`` q against ``[B, Sk, H, D]`` k / v -> ``[B, Sq, H, D]``,
    plain PyTorch as the JAX towers' einsums: fp32 logits scaled by
    ``D**-0.5`` (on the fp32 q before the product where ``scale_q``, as the
    Qwen towers do, else on the logits, as InternVideo2 does), set to
    ``-1e30`` where the ``[Sq, Sk]`` bool ``mask`` is False, fp32 softmax,
    probabilities cast to ``dtype`` for the value product. Over chunks of
    ``ATTN_CHUNK_CLIPS`` rows of the batch, which bounds the logits' memory."""
    scale = q.shape[-1] ** -0.5
    outs = []
    for i in range(0, q.shape[0], ATTN_CHUNK_CLIPS):
        sl = slice(i, i + ATTN_CHUNK_CLIPS)
        qc = q[sl].float()
        qc = (qc * scale if scale_q else qc).transpose(1, 2)  # [b, H, Sq, D]
        logits = torch.matmul(qc, k[sl].float().transpose(1, 2).transpose(-1, -2))
        if not scale_q:
            logits = logits * scale
        if mask is not None:
            logits = logits.masked_fill_(~mask, -1e30)
        probs = torch.softmax(logits, dim=-1).to(dtype)
        del logits
        outs.append(torch.matmul(probs, v[sl].to(dtype).transpose(1, 2)).transpose(1, 2))
    return torch.cat(outs) if len(outs) > 1 else outs[0]


class Attention(nn.Module):
    """Multi-head self-attention. The einsum path has the reference's
    precision sequence: logits rounded to ``dtype`` before the fp32
    softmax, probabilities cast back to ``dtype`` for the value product.
    The flash path (``_use_flash``) has the flash kernel's: fp32 logits and
    softmax, probabilities rounded to bf16 for the value product, which
    accumulates in fp32 (the plain version on the CPU keeps them in fp32)."""

    def __init__(self, dim: int, num_heads: int, head_dim: int, dtype=torch.bfloat16, causal: bool = False):
        super().__init__()
        inner = num_heads * head_dim
        self.num_heads = num_heads
        self.head_dim = head_dim
        self.dtype = dtype
        self.causal = causal
        self.q = Linear(dim, inner, dtype=dtype)
        self.k = Linear(dim, inner, dtype=dtype)
        self.v = Linear(dim, inner, dtype=dtype)
        self.out = Linear(inner, dim, dtype=dtype)

    def forward(self, x, mask=None):
        b, s, _ = x.shape
        q = self.q(x).reshape(b, s, self.num_heads, self.head_dim)
        k = self.k(x).reshape(b, s, self.num_heads, self.head_dim)
        v = self.v(x).reshape(b, s, self.num_heads, self.head_dim)
        if _use_flash(x, mask):
            # [B, S, H, D] -> [B, H, S, D] views: the kernel reads strides
            out = flash_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), causal=self.causal
            ).transpose(1, 2)
            return self.out(out.reshape(b, s, self.num_heads * self.head_dim))
        scale = self.head_dim**-0.5
        logits = torch.einsum("bqhd,bkhd->bhqk", q * scale, k).float()
        if self.causal:
            cm = torch.tril(torch.ones((s, s), dtype=torch.bool, device=x.device))
            logits = logits.masked_fill(~cm[None, None], float("-inf"))
        if mask is not None:
            logits = logits.masked_fill(~mask, float("-inf"))
        probs = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
        probs = probs / probs.sum(dim=-1, keepdim=True)
        out = torch.einsum("bhqk,bkhd->bqhd", probs.to(self.dtype), v)
        return self.out(out.reshape(b, s, self.num_heads * self.head_dim))


class MlpBlock(nn.Module):
    def __init__(self, dim: int, hidden_mult: float = 4.0, dtype=torch.bfloat16, act: str = "gelu"):
        super().__init__()
        hidden = int(dim * hidden_mult)
        self.up = Linear(dim, hidden, dtype=dtype)
        self.down = Linear(hidden, dim, dtype=dtype)
        self.act = _ACTIVATIONS[act]

    def forward(self, x):
        return self.down(self.act(self.up(x)))


class TransformerBlock(nn.Module):
    """Pre-norm encoder block; the norms emit fp32, so the residual stream
    is fp32 after the first norm, exactly as in the flax block."""

    def __init__(
        self,
        dim: int,
        num_heads: int,
        head_dim: int,
        hidden_mult: float = 4.0,
        dtype=torch.bfloat16,
        causal: bool = False,
        act: str = "gelu",
        ln_eps: float = 1e-6,
    ):
        super().__init__()
        self.ln1 = LayerNorm(dim, eps=ln_eps)
        self.attn = Attention(dim, num_heads, head_dim, dtype=dtype, causal=causal)
        self.ln2 = LayerNorm(dim, eps=ln_eps)
        self.mlp = MlpBlock(dim, hidden_mult, dtype=dtype, act=act)

    def forward(self, x, mask=None):
        x = x + self.attn(self.ln1(x), mask)
        return x + self.mlp(self.ln2(x))
