"""Diffusion video super resolution: a conditional denoiser over windows of
frames (port of ``cosmos_curate_tpu/models/diffusion_sr.py``).

- **residual diffusion**: the model denoises the residual over the bilinear
  upsample of the input, so the small denoiser only synthesizes detail;
- **denoiser** (``DenoiserUNet``): a conv UNet (stride-2 down,
  depth-to-space up, GroupNorm + SiLU, FiLM timestep modulation) with
  self-attention across the frames at the bottleneck;
- **v-prediction** on a cosine schedule, sampled by deterministic DDIM in
  ``sample_steps`` steps (``ddim_sample``);
- **windowed**: a window's frames go in fixed ``window``-frame chunks, each
  denoised alone with its own seed.

The weights are ``diffusion-sr-tpu`` (the JAX package's flax msgpack through
``models/registry.py``). The modules keep flax's auto-names in creation
order (``Dense_0``, ``Conv_{i}``, ``_FiLMResBlock_{i}``,
``_TemporalAttention_0`` with ``q`` / ``k`` / ``v`` / ``out``,
``GroupNorm_0``), so a checkpoint maps onto them mechanically. None ships
with the repository. The seeded init zeroes the final conv, as the
reference's does, so a seeded model predicts v = 0 and each DDIM step only
rescales its noise (by cos of the step's angle; 0.86 over the 8 steps): a
seeded model's output is the bilinear base plus that scaled noise.

Precision mirrors the reference's dtype flow block by block: convs in bf16
over fp32 parameters; GroupNorm (eps 1e-6, flax's) computes and returns
fp32; the FiLM modulation promotes to fp32; the temporal attention and the
final (zero-initialised) conv are fp32. ``compute_dtype=torch.float32``
runs the bf16 convs in fp32 instead (a reference run on the same card).
The fp32 convs run with cuDNN's TF32 off, for the call only.

Divergences from the reference:
- **noise**: the reference draws ``jax.random.normal(PRNGKey(i))`` for chunk
  i. Torch cannot reproduce threefry, so the port draws each chunk's noise
  from a CPU ``torch.Generator`` seeded with i (then copies it to the
  device): the same input gives the same output on any device, which is
  the reference's contract. Parity tests pass the JAX draw in (``noise``).
- **memory**: the reference vmaps every chunk of a window at once. At
  1280x720 in, one level-0 activation of one chunk is 1.4 GB in bf16, so
  the port runs the chunks in groups sized to the card's free memory
  (``group_size``); the chunks are independent, so the function is the
  same.
- ``sp_size > 1`` (the reference's ``shard_map`` of the chunks over a
  ``seq`` mesh) is not ported: ROADMAP queue A item 7.

Entry points run on ``device="cuda"`` unless the caller asks for the CPU.
"""

from __future__ import annotations

import collections
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from cosmos_curate_tpu_torch.core.model import ModelInterface, model_device
from cosmos_curate_tpu_torch.models import registry
from cosmos_curate_tpu_torch.models.device_pipeline import DevicePipeline
from cosmos_curate_tpu_torch.models.ocr import _fp32, _init_convs
from cosmos_curate_tpu_torch.models.super_resolution import (
    SEQ_SHARDING,
    bilinear_up,
    conv_as,
    depth_to_space,
    to_uint8,
)

MODEL_ID = "diffusion-sr-tpu"
GN_EPS = 1e-6  # flax's GroupNorm epsilon (torch's default is 1e-5)
# device bytes one chunk's UNet step holds per (frame x output pixel x base
# channel) at its peak (bf16 activations and skips, fp32 norms and FiLM
# products), used to size the chunk groups to the card's free memory; a
# 1280x720 window peaked at ~30 on an H100 with one chunk at a time, and
# 40 keeps a margin
BYTES_PER_CHUNK_ELEMENT = 40
MEMORY_SHARE = 0.6  # of the free device memory the chunk groups may take

registry.register_model(MODEL_ID, "windowed conditional diffusion video SR")


@dataclass(frozen=True)
class DiffusionSRConfig:
    scale: int = 2
    channels: int = 48
    levels: int = 2  # stride-2 UNet levels
    blocks: int = 2  # res blocks per level
    temporal_heads: int = 4
    window: int = 4  # frames denoised together
    timesteps: int = 1000  # training schedule resolution
    sample_steps: int = 8  # DDIM steps at inference


DIFF_SR_BASE = DiffusionSRConfig()
DIFF_SR_TINY_TEST = DiffusionSRConfig(channels=8, levels=1, blocks=1, temporal_heads=2, window=2, sample_steps=2)


def linspace32(start: float, stop: float, num: int) -> np.ndarray:
    """float32 ``jnp.linspace(start, stop, num)`` with the reference's
    rounding: ``start * (1 - step) + stop * step`` at ``step = i * (1 /
    (num - 1))``, with XLA's folds where an end is 0 (``i * (stop * r)``,
    ``start * (1 - step)``), the last point exact. ``torch.linspace`` rounds
    other points, which moves the 6-rad-wide timestep frequencies by ulps."""
    div = num - 1
    i = np.arange(div, dtype=np.float32)
    r = np.float32(1.0 / div)
    if start == 0:
        body = i * np.float32(np.float32(stop) * r)
    else:
        body = np.float32(start) * (np.float32(1) - i * r)
        if stop != 0:
            body = body + np.float32(stop) * (i * r)
    return np.concatenate([body, np.asarray([stop], np.float32)]).astype(np.float32)


def cosine_alpha_sigma(t: float) -> tuple[float, float]:
    """Continuous cosine schedule, t in [0, 1] -> (alpha, sigma) with
    alpha^2 + sigma^2 = 1, in float32 as the reference computes them."""
    angle = np.float32(t) * np.float32(np.pi / 2)
    return float(np.cos(angle)), float(np.sin(angle))


def cosine_alpha_sigma_tensor(t: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``cosine_alpha_sigma`` over a float32 tensor of timesteps (the
    trainer's, one a window), elementwise."""
    angle = t.to(torch.float32) * float(np.float32(np.pi / 2))
    return torch.cos(angle), torch.sin(angle)


def _timestep_embedding(t: torch.Tensor, dim: int) -> torch.Tensor:
    """Sinusoidal embedding of continuous t in [0, 1] -> [..., dim]."""
    freqs = torch.exp(torch.from_numpy(linspace32(0.0, 6.0, dim // 2)).to(t.device))
    ang = t[..., None] * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def _group_norm(norm: nn.GroupNorm, x: torch.Tensor) -> torch.Tensor:
    """Flax GroupNorm: fp32 statistics and an fp32 result on any input."""
    return F.group_norm(x.to(torch.float32), norm.num_groups, norm.weight, norm.bias, norm.eps)


class _FiLMResBlock(nn.Module):
    def __init__(self, in_channels: int, channels: int, temb_dim: int) -> None:
        super().__init__()
        self.GroupNorm_0 = nn.GroupNorm(min(8, channels), in_channels, eps=GN_EPS)
        self.Conv_0 = nn.Conv2d(in_channels, channels, 3)
        self.Dense_0 = nn.Linear(temb_dim, 2 * channels)
        self.Conv_1 = nn.Conv2d(channels, channels, 3)
        # only where the channel count changes (then the last flax name)
        if in_channels != channels:
            self.Conv_2 = nn.Conv2d(in_channels, channels, 1)
        self.shortcut = in_channels != channels

    def forward(self, x: torch.Tensor, temb: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        h = F.silu(_group_norm(self.GroupNorm_0, x), inplace=True)
        h = conv_as(self.Conv_0, h, dtype)
        # [1, C] each for one t over every frame, [N, C] for one a frame
        scale, shift = self.Dense_0(temb).chunk(2, dim=-1)
        h = h.to(torch.float32) * (1 + scale)[:, :, None, None] + shift[:, :, None, None]
        h = conv_as(self.Conv_1, F.silu(h, inplace=True), dtype)
        if self.shortcut:
            x = conv_as(self.Conv_2, x, dtype)
        return x + h


class _TemporalAttention(nn.Module):
    """Self-attention across the frames of a chunk at every spatial
    position (frames agree on synthesized detail), in fp32."""

    def __init__(self, channels: int, heads: int) -> None:
        super().__init__()
        self.heads = heads
        self.GroupNorm_0 = nn.GroupNorm(min(8, channels), channels, eps=GN_EPS)
        self.q = nn.Linear(channels, channels)
        self.k = nn.Linear(channels, channels)
        self.v = nn.Linear(channels, channels)
        self.out = nn.Linear(channels, channels)

    def forward(self, x: torch.Tensor, chunks: int) -> torch.Tensor:
        """x: float32 NCHW [chunks * T, C, H, W]; attention within each chunk."""
        n, c, h, w = x.shape
        t, p, d = n // chunks, h * w, c // self.heads
        y = _group_norm(self.GroupNorm_0, x).permute(0, 2, 3, 1).reshape(chunks, t, p, c)

        def heads(proj: nn.Linear) -> torch.Tensor:  # -> [chunks, P, heads, T, d]
            return proj(y).reshape(chunks, t, p, self.heads, d).permute(0, 2, 3, 1, 4)

        q, k, v = heads(self.q), heads(self.k), heads(self.v)
        probs = torch.softmax((q @ k.transpose(-1, -2)) * (d**-0.5), dim=-1)
        out = (probs @ v).permute(0, 3, 1, 2, 4).reshape(chunks, t, p, c)
        out = self.out(out).reshape(n, h, w, c).permute(0, 3, 1, 2)
        return x + out


class DenoiserUNet(nn.Module):
    """v-prediction denoiser over the upsampled residual, conditioned on the
    bilinear-up input frames (channel concat) and the timestep (FiLM)."""

    def __init__(self, cfg: DiffusionSRConfig = DIFF_SR_BASE) -> None:
        super().__init__()
        self.cfg = cfg
        self.compute_dtype = torch.bfloat16  # the reference's; float32 for a reference run
        counts: collections.Counter = collections.Counter()

        def add(kind: str, module: nn.Module) -> str:
            name = f"{kind}_{counts[kind]}"
            counts[kind] += 1
            self.add_module(name, module)
            return name

        c, temb_dim = cfg.channels, 4 * cfg.channels
        add("Dense", nn.Linear(temb_dim, temb_dim))
        self.conv_in = add("Conv", nn.Conv2d(6, c, 3))
        self.down: list[tuple[list[str], str]] = []
        ch = in_ch = c
        for _ in range(cfg.levels):
            blocks = []
            for _ in range(cfg.blocks):
                blocks.append(add("_FiLMResBlock", _FiLMResBlock(in_ch, ch, temb_dim)))
                in_ch = ch
            ch *= 2
            self.down.append((blocks, add("Conv", nn.Conv2d(in_ch, ch, 3, stride=2))))
            in_ch = ch
        self.mid_a = [add("_FiLMResBlock", _FiLMResBlock(ch, ch, temb_dim)) for _ in range(cfg.blocks)]
        self.attn = add("_TemporalAttention", _TemporalAttention(ch, cfg.temporal_heads))
        self.mid_b = [add("_FiLMResBlock", _FiLMResBlock(ch, ch, temb_dim)) for _ in range(cfg.blocks)]
        self.up: list[tuple[str, list[str]]] = []
        for _ in range(cfg.levels):
            ch //= 2
            up = add("Conv", nn.Conv2d(in_ch, 4 * ch, 3))
            blocks = [add("_FiLMResBlock", _FiLMResBlock(2 * ch if i == 0 else ch, ch, temb_dim))
                      for i in range(cfg.blocks)]
            self.up.append((up, blocks))
            in_ch = ch
        self.norm_out = add("GroupNorm", nn.GroupNorm(min(8, ch), ch, eps=GN_EPS))
        self.conv_out = add("Conv", nn.Conv2d(ch, 3, 3))

    def init_weights(self, generator: torch.Generator) -> None:
        """The seeded init: lecun-normal kernels, zero biases, unit norms,
        and the final conv zero, as flax's ``kernel_init=zeros`` there."""
        _init_convs(self, generator)
        with torch.no_grad():
            getattr(self, self.conv_out).weight.zero_()

    def forward(self, z: torch.Tensor, cond: torch.Tensor, t: float | torch.Tensor, chunks: int = 1) -> torch.Tensor:
        """z, cond: float32 NCHW [chunks * window, 3, H, W] (the noisy
        residual and the upsampled input); t in [0, 1], a float for every
        chunk or a ``[chunks]`` tensor, one a chunk (the trainer's). Returns
        the v prediction, float32 [chunks * window, 3, H, W]."""
        dtype = self.compute_dtype
        m = self._modules
        if isinstance(t, torch.Tensor):  # each chunk's t on each of its frames
            t = t.to(device=z.device, dtype=torch.float32).repeat_interleave(z.shape[0] // chunks)
        else:
            t = torch.full((1,), t, dtype=torch.float32, device=z.device)
        temb = _timestep_embedding(t, 4 * self.cfg.channels)
        temb = F.silu(m["Dense_0"](temb))
        x = conv_as(m[self.conv_in], torch.cat([z, cond], dim=1), dtype)
        skips = []
        for blocks, down in self.down:
            for name in blocks:
                x = m[name](x, temb, dtype)
            skips.append(x)
            x = conv_as(m[down], x, dtype)
        for name in self.mid_a:
            x = m[name](x, temb, dtype)
        x = m[self.attn](x.to(torch.float32), chunks).to(dtype)
        for name in self.mid_b:
            x = m[name](x, temb, dtype)
        for (up, blocks), skip in zip(self.up, reversed(skips)):
            x = depth_to_space(conv_as(m[up], x, dtype), 2)
            x = torch.cat([x, skip.to(dtype)], dim=1)
            for name in blocks:
                x = m[name](x, temb, dtype)
        x = F.silu(_group_norm(m[self.norm_out], x), inplace=True)
        return conv_as(m[self.conv_out], x, torch.float32)


def chunk_noise(seed: int, shape: tuple[int, ...]) -> torch.Tensor:
    """One chunk's standard-normal draw, NHWC float32 on the CPU, from a
    generator seeded with ``seed`` (the same on every device)."""
    gen = torch.Generator().manual_seed(seed)
    return torch.randn(shape, generator=gen, dtype=torch.float32)


def ddim_sample(model: DenoiserUNet, cond: torch.Tensor, noise: torch.Tensor, cfg: DiffusionSRConfig,
                chunks: int = 1) -> torch.Tensor:
    """Deterministic DDIM over ``sample_steps`` from ``noise`` (NCHW, like
    ``cond``): the denoised residual x0. v-parameter identities:
    x0 = a z - s v, eps = s z + a v; z <- a' x0 + s' eps."""
    z = noise
    ts = linspace32(1.0, 0.0, cfg.sample_steps + 1)
    for i in range(cfg.sample_steps):
        a, s = cosine_alpha_sigma(ts[i])
        v = model(z, cond, float(ts[i]), chunks)
        x0 = a * z - s * v
        eps = s * z + a * v
        a2, s2 = cosine_alpha_sigma(ts[i + 1])
        z = a2 * x0 + s2 * eps
    return z  # at t = 0, alpha = 1 and sigma = 0: z is x0


class DiffusionSRModel(ModelInterface):
    MODEL_ID = MODEL_ID

    def __init__(
        self,
        cfg: DiffusionSRConfig = DIFF_SR_BASE,
        *,
        sp_size: int = 1,
        device: str | torch.device = "cuda",
    ) -> None:
        if sp_size > 1:
            raise NotImplementedError(SEQ_SHARDING)
        self.cfg = cfg
        self.sp_size = sp_size
        self.device = model_device(device, "diffusion super resolution")
        self.net: DenoiserUNet | None = None
        self._pipeline: DevicePipeline | None = None
        self.last_group = 0  # the group size the last window ran with

    @property
    def model_id_names(self) -> list[str]:
        return [self.MODEL_ID]

    def setup(self, *, require_weights: bool = False) -> None:
        """Build the denoiser and load its checkpoint (else the seeded init;
        ``require_weights=True`` raises instead)."""
        with torch.device(self.device):
            self.net = DenoiserUNet(self.cfg).eval()
        registry.load_module(self.net, self.MODEL_ID, require=require_weights)
        self._pipeline = DevicePipeline("sr/diffusion", self.upscale, device=self.device)

    def group_size(self, n_chunk: int, out_h: int, out_w: int) -> int:
        """Chunks denoised at once: as many as ``MEMORY_SHARE`` of the card's
        free memory holds at ``BYTES_PER_CHUNK_ELEMENT``, at least 1; every
        chunk of the window on the CPU."""
        if self.device.type != "cuda":
            return n_chunk
        free, _ = torch.cuda.mem_get_info(self.device)
        per_chunk = BYTES_PER_CHUNK_ELEMENT * self.cfg.window * out_h * out_w * self.cfg.channels
        return max(1, min(n_chunk, int(free * MEMORY_SHARE // per_chunk)))

    def upscale(self, frames_u8: torch.Tensor) -> torch.Tensor:
        """uint8 [T, H, W, 3] with T a multiple of ``window`` -> uint8
        [T, H*scale, W*scale, 3]: the bilinear base, each chunk's DDIM
        residual (chunk i's noise seeded with i), the sum clipped to [0, 1]
        and truncated to uint8."""
        cfg = self.cfg
        win = cfg.window
        with torch.inference_mode(), _fp32(self.device):
            base = bilinear_up(frames_u8, cfg.scale)  # [T, 3, Hs, Ws]
            t, _, hs, ws = base.shape
            n_chunk = t // win
            group = self.group_size(n_chunk, hs, ws)
            self.last_group = group
            out = torch.empty((t, hs, ws, 3), dtype=torch.uint8, device=base.device)
            for g0 in range(0, n_chunk, group):
                g1 = min(n_chunk, g0 + group)
                cond = base[g0 * win : g1 * win]
                z = torch.cat([chunk_noise(i, (win, hs, ws, 3)) for i in range(g0, g1)])
                z = z.to(base.device).permute(0, 3, 1, 2)
                residual = ddim_sample(self.net, cond, z, cfg, chunks=g1 - g0)
                out[g0 * win : g1 * win] = to_uint8(torch.clamp(cond + residual, 0.0, 1.0))
                del cond, z, residual
        return out

    def submit_window(self, frames: np.ndarray) -> None:
        """Queue one window, its frames padded to a multiple of ``window``
        with the last frame; results resolve in order at ``drain_windows``."""
        if self._pipeline is None:
            raise RuntimeError("call setup() first")
        t = frames.shape[0]
        t_pad = -(-t // self.cfg.window) * self.cfg.window
        if t_pad != t:
            frames = np.concatenate([frames, np.broadcast_to(frames[-1:], (t_pad - t, *frames.shape[1:]))])
        self._pipeline.submit(frames, n_valid=t)

    def drain_windows(self) -> list[np.ndarray]:
        return self._pipeline.drain()

    def upscale_window(self, frames: np.ndarray) -> np.ndarray:
        """uint8 [T, H, W, 3] -> uint8 [T, H*scale, W*scale, 3], synchronously."""
        self.submit_window(frames)
        return self.drain_windows()[0]
