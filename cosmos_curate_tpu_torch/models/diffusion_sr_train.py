"""Synthetic-data training for the diffusion SR denoiser (port of
``cosmos_curate_tpu/models/diffusion_sr_train.py``).

sr_train.py's story extended to video windows: each sample is a
``window``-frame sequence of one crisp procedural texture (sr_train's
``_texture``) under sub-pixel translation, so the temporal attention learns
cross-frame agreement. The objective is v-prediction MSE on the residual
diffusion of models/diffusion_sr.py. The synthesizer is the reference's,
line for line, and the init consumes one ``synthesize_windows`` draw, as
the reference's does.

Each window draws its own timestep ``t ~ U(1e-3, 1)`` and noise
``eps ~ N(0, 1)``. The reference draws them with ``jax.random``, which
torch cannot reproduce, so the port draws them from a CPU
``torch.Generator`` seeded with ``seed + 1`` (the reference's key seed),
``t`` first, every step. ``v_loss`` takes them as arguments, so a test can
pass the reference's draws in. One forward runs every window: the
windows are the UNet's chunks, with a ``[chunks]`` timestep tensor for the
FiLM modulation (``DenoiserUNet.forward``), as the reference's ``vmap``
gives each window its own ``t``. bf16 convs over fp32 parameters, as the
model infers; ``optax.adam``.

``train`` runs on ``device="cuda"`` unless the caller asks for the CPU,
and raises where CUDA is missing. ``init_params`` (a ``state_dict``)
replaces the seeded init, and ``log`` (``train_common.StepLog``) keeps each
step's records.
"""

from __future__ import annotations

import numpy as np
import torch

from cosmos_curate_tpu_torch.core.model import model_device
from cosmos_curate_tpu_torch.models.diffusion_sr import (
    DIFF_SR_BASE,
    MODEL_ID,
    DenoiserUNet,
    DiffusionSRConfig,
    cosine_alpha_sigma_tensor,
)
from cosmos_curate_tpu_torch.models.ocr import _fp32
from cosmos_curate_tpu_torch.models.sr_train import _texture
from cosmos_curate_tpu_torch.models.train_common import StepLog, optax_adam, optimizer_step, run_steps
from cosmos_curate_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

T_MIN = 1e-3  # the timesteps' lower end, as the reference draws them


def synthesize_windows(
    rng: np.random.Generator, batch: int, window: int, hr: int, scale: int
) -> tuple[np.ndarray, np.ndarray]:
    """(cond [B, T, hr, hr, 3], residual [B, T, hr, hr, 3]) float32:
    cond is the bilinear-upsampled LR, residual = HR - cond (the
    diffusion target). Frames are sub-pixel translations of one texture."""
    import cv2

    lr_size = hr // scale
    pad = 8
    conds = np.empty((batch, window, hr, hr, 3), np.float32)
    residuals = np.empty_like(conds)
    for b in range(batch):
        canvas = _texture(rng, hr + pad, hr + pad)
        dx, dy = rng.uniform(0, 2, 2)  # per-window drift (pixels/frame)
        for t in range(window):
            ox, oy = t * dx, t * dy
            m = np.float32([[1, 0, -ox], [0, 1, -oy]])
            hr_f = cv2.warpAffine(canvas, m, (hr, hr), flags=cv2.INTER_LINEAR)
            lr_f = cv2.resize(hr_f, (lr_size, lr_size), interpolation=cv2.INTER_LINEAR)
            cond = cv2.resize(lr_f, (hr, hr), interpolation=cv2.INTER_LINEAR)
            conds[b, t] = cond
            residuals[b, t] = hr_f - cond
    return conds, residuals


def draw_noise(gen: torch.Generator, windows: int, shape: tuple[int, ...]) -> tuple[torch.Tensor, torch.Tensor]:
    """One step's (timesteps [windows] ~ U(T_MIN, 1), noise ~ N(0, 1) of
    ``shape``), float32 on the CPU, in that order from ``gen``."""
    ts = torch.rand(windows, generator=gen, dtype=torch.float32) * (1.0 - T_MIN) + T_MIN
    eps = torch.randn(shape, generator=gen, dtype=torch.float32)
    return ts, eps


def _nchw(x: torch.Tensor) -> torch.Tensor:
    """[B, T, H, W, 3] -> [B * T, 3, H, W]."""
    return x.reshape(-1, *x.shape[2:]).permute(0, 3, 1, 2)


def v_loss(model: DenoiserUNet, conds: torch.Tensor, residuals: torch.Tensor, ts: torch.Tensor,
           eps: torch.Tensor) -> torch.Tensor:
    """Mean squared error of the v prediction. conds, residuals, eps:
    float32 [B, T, H, W, 3] (B windows); ts: [B]."""
    a, s = cosine_alpha_sigma_tensor(ts)
    a, s = a[:, None, None, None, None], s[:, None, None, None, None]
    z = a * residuals + s * eps
    v_target = a * eps - s * residuals
    v = model(_nchw(z), _nchw(conds), ts, chunks=conds.shape[0])
    return torch.mean((v - _nchw(v_target)) ** 2)


def train(
    cfg: DiffusionSRConfig = DIFF_SR_BASE,
    *,
    steps: int = 800,
    batch: int = 8,
    hr_size: int = 32,
    lr: float = 1e-3,
    seed: int = 0,
    log_every: int = 100,
    device: str | torch.device = "cuda",
    init_params: dict[str, torch.Tensor] | None = None,
    log: StepLog | None = None,
) -> tuple[DenoiserUNet, float]:
    """Train on synthetic windows; returns (the trained denoiser, the last
    loss)."""
    dev = model_device(device, "the diffusion SR trainer")
    rng = np.random.default_rng(seed)
    synthesize_windows(rng, 1, cfg.window, hr_size, cfg.scale)  # the reference's init draw
    with torch.device(dev):
        model = DenoiserUNet(cfg)
    if init_params is None:
        model.init_weights(torch.Generator(device=dev).manual_seed(seed))
    else:
        model.load_state_dict(init_params)
    opt = optax_adam(model.parameters(), lr)
    gen = torch.Generator().manual_seed(seed + 1)

    def step(conds, residuals) -> torch.Tensor:
        ts, eps = draw_noise(gen, conds.shape[0], residuals.shape)
        c, r, ts, eps = (torch.as_tensor(a).to(dev) for a in (conds, residuals, ts, eps))
        with _fp32(dev):
            return optimizer_step(opt, lambda: v_loss(model, c, r, ts, eps))

    loss = run_steps(steps, lambda: synthesize_windows(rng, batch, cfg.window, hr_size, cfg.scale), step, log,
                     log_every=log_every, label="diffusion sr train", logger=logger, fmt="%.5f")
    return model.eval(), loss


def train_and_stage(
    cfg: DiffusionSRConfig = DIFF_SR_BASE,
    *,
    model_id: str = MODEL_ID,
    out_dir: str | None = None,
    **train_kw,
):
    """Train, then write ``params.msgpack`` under the staging directory (or
    ``out_dir``); returns (checkpoint path, last loss)."""
    from cosmos_curate_tpu_torch.models import registry

    model, loss = train(cfg, **train_kw)
    ckpt = registry.save_params(model_id, model, root=out_dir)
    logger.info("staged %s (final loss %.5f) at %s", model_id, loss, ckpt)
    return ckpt, loss


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser(description="Train the diffusion SR denoiser")
    ap.add_argument("--steps", type=int, default=800)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--hr-size", type=int, default=32)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out-dir", default=None, help="e.g. <repo>/weights to commit")
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    a = ap.parse_args()
    train_and_stage(
        steps=a.steps, batch=a.batch, hr_size=a.hr_size, lr=a.lr, seed=a.seed,
        out_dir=a.out_dir, device=a.device,
    )
