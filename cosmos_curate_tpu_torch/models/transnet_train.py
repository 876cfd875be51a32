"""Synthetic-data training for the TransNet shot detector (port of
``cosmos_curate_tpu/models/transnet_train.py``).

No pretrained TransNetV2 checkpoint is reachable without network access,
so functional shot detection comes from training the DDCNN
(models/transnetv2.py) on synthesized scene-cut clips: per-scene texture
generators (solid drift, panning gradients, moving shapes, noise) joined
with hard cuts, label 1 on each transition frame, a third of the rows a
single scene with no cut. The synthesizers are the reference's, line for
line. The loss is the reference's weighted sigmoid cross-entropy (a
transition frame weighs ``pos_weight``, 8).

The trainer computes as the detector infers: bf16 convs over fp32
parameters (``TransNet``'s ``dtype``), fp32 norms and head. It trains at the
inference ``WINDOW`` only: another window raises, because the dilated
convs' ``SAME`` padding stamps every in-window position with an edge
signature.

``train`` runs on ``device="cuda"`` unless the caller asks for the CPU,
and raises where CUDA is missing. ``init_params`` (a ``state_dict``)
replaces the seeded init, and ``log`` (``train_common.StepLog``) keeps each
step's records.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from cosmos_curate_tpu_torch.core.model import model_device
from cosmos_curate_tpu_torch.models.ocr import _fp32
from cosmos_curate_tpu_torch.models.train_common import StepLog, optax_adamw, optimizer_step, run_steps
from cosmos_curate_tpu_torch.models.transnetv2 import INPUT_H, INPUT_W, WINDOW, TransNet, TransNetConfig, TransNetV2
from cosmos_curate_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)


def _scene(rng: np.random.Generator, t: int, h: int, w: int) -> np.ndarray:
    """One synthetic scene: [t, h, w, 3] uint8 with temporal coherence."""
    kind = rng.integers(0, 4)
    base = rng.integers(0, 256, 3).astype(np.float32)
    out = np.empty((t, h, w, 3), np.float32)
    if kind == 0:  # solid color with brightness drift
        drift = rng.uniform(-1.5, 1.5)
        for i in range(t):
            out[i] = np.clip(base + drift * i, 0, 255)
    elif kind == 1:  # panning linear gradient
        yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
        angle = rng.uniform(0, 2 * np.pi)
        grad = np.cos(angle) * xx / w + np.sin(angle) * yy / h
        speed = rng.uniform(-0.05, 0.05)
        for i in range(t):
            g = (grad + speed * i) % 1.0
            out[i] = base * 0.4 + g[..., None] * rng.uniform(80, 175)
    elif kind == 2:  # moving rectangle on solid background
        fg = rng.integers(0, 256, 3).astype(np.float32)
        rw, rh = int(rng.integers(w // 6, w // 2)), int(rng.integers(h // 6, h // 2))
        x0, y0 = rng.integers(0, w - rw), rng.integers(0, h - rh)
        vx, vy = rng.uniform(-2, 2, 2)
        for i in range(t):
            out[i] = base
            x = int(np.clip(x0 + vx * i, 0, w - rw))
            y = int(np.clip(y0 + vy * i, 0, h - rh))
            out[i, y : y + rh, x : x + rw] = fg
    else:  # static texture + small per-frame noise
        tex = rng.uniform(0, 255, (h, w, 3)).astype(np.float32)
        for i in range(t):
            out[i] = np.clip(tex + rng.normal(0, 4, (h, w, 3)), 0, 255)
    return out.astype(np.uint8)


def synthesize_batch(
    rng: np.random.Generator,
    batch: int,
    t: int,
    *,
    h: int = INPUT_H,
    w: int = INPUT_W,
    single_scene_frac: float = 0.35,
) -> tuple[np.ndarray, np.ndarray]:
    """-> (frames uint8 [B, T, h, w, 3], labels float32 [B, T]).

    Label 1 marks the first frame of each new scene (the transition frame,
    matching the published TransNetV2 target definition).

    ``single_scene_frac`` of rows are a SINGLE scene with all-zero labels:
    multi-scene windows alone never show the model "no cut anywhere", and
    false-positive suppression stalls without them (observed: false-cut
    probability stuck ~0.65 over the first 75 CPU training steps)."""
    frames = np.empty((batch, t, h, w, 3), np.uint8)
    labels = np.zeros((batch, t), np.float32)
    for b in range(batch):
        if rng.random() < single_scene_frac:
            frames[b] = _scene(rng, t, h, w)
            continue
        pos = 0
        while pos < t:
            scene_len = int(rng.integers(max(4, t // 8), max(8, t // 2)))
            end = min(pos + scene_len, t)
            frames[b, pos:end] = _scene(rng, end - pos, h, w)
            if pos > 0:
                labels[b, pos] = 1.0
            pos = end
    return frames, labels


def weighted_bce(logits: torch.Tensor, labels: torch.Tensor, pos_weight: float) -> torch.Tensor:
    """Mean sigmoid cross-entropy, a positive weighing ``pos_weight``."""
    weight = 1.0 + (pos_weight - 1.0) * labels
    return (F.binary_cross_entropy_with_logits(logits, labels, reduction="none") * weight).mean()


def cut_loss(model: TransNet, frames_u8: torch.Tensor, labels: torch.Tensor, pos_weight: float) -> torch.Tensor:
    return weighted_bce(model(frames_u8), labels, pos_weight)


def train(
    cfg: TransNetConfig = TransNetConfig(),
    *,
    steps: int = 600,
    batch: int = 8,
    window: int | None = None,
    lr: float = 1e-3,
    pos_weight: float = 8.0,
    seed: int = 0,
    log_every: int = 100,
    device: str | torch.device = "cuda",
    init_params: dict[str, torch.Tensor] | None = None,
    log: StepLog | None = None,
) -> tuple[TransNet, float]:
    """Train on synthetic cuts; returns (the trained model, the last loss)."""
    if window is None:
        window = WINDOW
    elif window != WINDOW:
        raise ValueError(
            f"train window {window} != inference WINDOW {WINDOW} "
            "(transnetv2.py); train at the inference window"
        )
    dev = model_device(device, "the shot detector trainer")
    rng = np.random.default_rng(seed)
    with torch.device(dev):
        model = TransNet(cfg)
    if init_params is None:
        model.init_weights(torch.Generator(device=dev).manual_seed(seed))
    else:
        model.load_state_dict(init_params)
    opt = optax_adamw(model.parameters(), lr)

    def step(frames, labels) -> torch.Tensor:
        x, y = torch.from_numpy(frames).to(dev), torch.from_numpy(labels).to(dev)
        with _fp32(dev):
            return optimizer_step(opt, lambda: cut_loss(model, x, y, pos_weight))

    loss = run_steps(steps, lambda: synthesize_batch(rng, batch, window), step, log, log_every=log_every,
                     label="transnet train", logger=logger)
    return model.eval(), loss


def train_and_stage(
    cfg: TransNetConfig = TransNetConfig(),
    *,
    model_id: str = TransNetV2.MODEL_ID,
    out_dir: str | None = None,
    **train_kw,
):
    """Train, then write ``params.msgpack`` under the staging directory (or
    ``out_dir``); returns (checkpoint path, last loss)."""
    from cosmos_curate_tpu_torch.models import registry

    model, loss = train(cfg, **train_kw)
    ckpt = registry.save_params(model_id, model, root=out_dir)
    logger.info("staged %s (final loss %.4f) at %s", model_id, loss, ckpt)
    return ckpt, loss


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser(description="Train TransNet on synthetic scene cuts")
    ap.add_argument("--steps", type=int, default=600)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--window", type=int, default=None, help="default: the inference WINDOW")
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out-dir", default=None, help="e.g. <repo>/weights to commit the result")
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    a = ap.parse_args()
    train_and_stage(
        steps=a.steps, batch=a.batch, window=a.window, lr=a.lr, seed=a.seed, out_dir=a.out_dir, device=a.device
    )
