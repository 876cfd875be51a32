"""Synthetic-data training for the super-resolution network (port of
``cosmos_curate_tpu/models/sr_train.py``).

A functional SR checkpoint comes from training the residual SRNet
(models/super_resolution.py) on synthesized LR/HR pairs: crisp procedural
textures (edges, glyph strokes, gradients, checkers) downsampled with the
bilinear kernel of the model's residual base, so the net learns the
detail the base loses. The synthesizers are the reference's, line for
line. The loss is the L1 distance of the model's float output
(``float_out=True``: the uint8 cast has no gradient) to the HR frame.

The reference ``vmap``s one-frame clips over the batch; the net treats
every frame alike, so here the batch is the frame axis. Like the
reference, the init consumes one ``synthesize_batch`` draw before the loop
(the reference sizes its init from it), so later batches match. bf16 convs
over fp32 parameters, as the model infers; ``optax.adam``.

``train`` runs on ``device="cuda"`` unless the caller asks for the CPU,
and raises where CUDA is missing. ``init_params`` (a ``state_dict``)
replaces the seeded init, and ``log`` (``train_common.StepLog``) keeps each
step's records.
"""

from __future__ import annotations

import numpy as np
import torch

from cosmos_curate_tpu_torch.core.model import model_device
from cosmos_curate_tpu_torch.models.ocr import _fp32
from cosmos_curate_tpu_torch.models.super_resolution import MODEL_ID, SR_BASE, SRConfig, SRNet
from cosmos_curate_tpu_torch.models.train_common import StepLog, optax_adam, optimizer_step, run_steps
from cosmos_curate_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)


def _texture(rng: np.random.Generator, h: int, w: int) -> np.ndarray:
    """One crisp HR frame [h, w, 3] float32 in [0, 1] with high-frequency
    content worth recovering."""
    kind = rng.integers(0, 4)
    img = np.zeros((h, w, 3), np.float32)
    if kind == 0:  # random oriented edges
        img += rng.uniform(0.1, 0.9, 3)
        for _ in range(6):
            x0, y0 = rng.integers(0, w), rng.integers(0, h)
            angle = rng.uniform(0, np.pi)
            yy, xx = np.mgrid[0:h, 0:w]
            side = (xx - x0) * np.cos(angle) + (yy - y0) * np.sin(angle) > 0
            img[side] = rng.uniform(0, 1, 3)
    elif kind == 1:  # checkerboard at random phase/scale
        s = int(rng.integers(2, 6))
        yy, xx = np.mgrid[0:h, 0:w]
        mask = ((xx // s) + (yy // s)) % 2 == 0
        a, b = rng.uniform(0, 1, (2, 3))
        img[mask] = a
        img[~mask] = b
    elif kind == 2:  # text-like glyph strokes
        img += rng.uniform(0.6, 1.0, 3)
        ink = rng.uniform(0.0, 0.3, 3)
        for _ in range(10):
            x0, y0 = rng.integers(0, w - 6), rng.integers(0, h - 6)
            lw = int(rng.integers(1, 3))
            if rng.random() < 0.5:
                img[y0 : y0 + 6, x0 : x0 + lw] = ink
            else:
                img[y0 : y0 + lw, x0 : x0 + 6] = ink
    else:  # smooth gradient + sharp dots
        yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
        img += (xx / w)[..., None] * rng.uniform(0.3, 1.0, 3)
        for _ in range(12):
            x0, y0 = rng.integers(1, w - 1), rng.integers(1, h - 1)
            img[y0, x0] = rng.uniform(0, 1, 3)
    return np.clip(img, 0.0, 1.0)


def synthesize_batch(
    rng: np.random.Generator, batch: int, hr: int, scale: int
) -> tuple[np.ndarray, np.ndarray]:
    """(lr_u8 [B, hr/scale, hr/scale, 3], hr_u8 [B, hr, hr, 3])."""
    import cv2

    lr_size = hr // scale
    hrs = np.empty((batch, hr, hr, 3), np.uint8)
    lrs = np.empty((batch, lr_size, lr_size, 3), np.uint8)
    for i in range(batch):
        img = _texture(rng, hr, hr)
        hrs[i] = (img * 255).astype(np.uint8)
        lrs[i] = (
            cv2.resize(img, (lr_size, lr_size), interpolation=cv2.INTER_LINEAR) * 255
        ).astype(np.uint8)
    return lrs, hrs


def l1_loss(model: SRNet, lr_u8: torch.Tensor, hr_u8: torch.Tensor) -> torch.Tensor:
    out = model(lr_u8, float_out=True)
    return (out - hr_u8.to(torch.float32) / 255.0).abs().mean()


def train(
    cfg: SRConfig = SR_BASE,
    *,
    steps: int = 500,
    batch: int = 16,
    hr_size: int = 64,
    lr: float = 2e-4,
    seed: int = 0,
    log_every: int = 100,
    device: str | torch.device = "cuda",
    init_params: dict[str, torch.Tensor] | None = None,
    log: StepLog | None = None,
) -> tuple[SRNet, float]:
    """Train on synthetic pairs; returns (the trained net, the last loss)."""
    dev = model_device(device, "the super-resolution trainer")
    rng = np.random.default_rng(seed)
    synthesize_batch(rng, batch, hr_size, cfg.scale)  # the reference's init draw
    with torch.device(dev):
        model = SRNet(cfg)
    if init_params is None:
        model.init_weights(torch.Generator(device=dev).manual_seed(seed))
    else:
        model.load_state_dict(init_params)
    opt = optax_adam(model.parameters(), lr)

    def step(lrs, hrs) -> torch.Tensor:
        x, y = torch.from_numpy(lrs).to(dev), torch.from_numpy(hrs).to(dev)
        with _fp32(dev):
            return optimizer_step(opt, lambda: l1_loss(model, x, y))

    loss = run_steps(steps, lambda: synthesize_batch(rng, batch, hr_size, cfg.scale), step, log,
                     log_every=log_every, label="sr train", logger=logger, fmt="%.5f")
    return model.eval(), loss


def train_and_stage(
    cfg: SRConfig = SR_BASE,
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

    ap = argparse.ArgumentParser(description="Train SRNet on synthetic LR/HR pairs")
    ap.add_argument("--steps", type=int, default=500)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--hr-size", type=int, default=64)
    ap.add_argument("--lr", type=float, default=2e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out-dir", default=None, help="e.g. <repo>/weights to commit")
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    a = ap.parse_args()
    train_and_stage(
        steps=a.steps, batch=a.batch, hr_size=a.hr_size, lr=a.lr, seed=a.seed,
        out_dir=a.out_dir, device=a.device,
    )
