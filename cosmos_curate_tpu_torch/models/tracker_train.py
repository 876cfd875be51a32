"""Synthetic-data training for the siamese tracker embedding (port of
``cosmos_curate_tpu/models/tracker_train.py``).

Training pairs are (template patch, search window) crops from procedurally
generated scenes: a textured target moves over cluttered backgrounds with
brightness jitter and look-alike distractors; the label is the target's
offset inside the search window. The loss is softmax cross-entropy over
the correlation response map against the target's cell (the SiamFC
formulation). The synthesizers are the reference's, line for line, so one
numpy seed gives the same batches in both packages.

The reference correlates each pair with ``conv_general_dilated(...,
feature_group_count=F)`` under ``vmap``. Here the batch folds into the
channels: the search features ``[1, B*F, hs, ws]`` against the templates
``[B*F, 1, ht, wt]`` in one grouped ``conv2d`` (``groups=B*F``), summed
over each pair's F channels. Logits keep the reference's scale
``1 / (ht * wt * F)`` and the label ``ry * resp_edge + rx``. fp32, TF32
off for the step, as the tracker's inference runs (models/ocr.py
``_fp32``).

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
from cosmos_curate_tpu_torch.models.tracker_learned import _PREP_SCALE, MODEL_ID, STRIDE, EmbedNet, SiameseConfig
from cosmos_curate_tpu_torch.models.train_common import StepLog, optax_adamw, optimizer_step, run_steps
from cosmos_curate_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)


def _texture(rng: np.random.Generator, h: int, w: int) -> np.ndarray:
    import cv2

    base = rng.integers(0, 256, 3).astype(np.float32)
    tex = np.clip(
        base + rng.normal(0, rng.uniform(5, 40), (h, w, 3)), 0, 255
    ).astype(np.uint8)
    if rng.random() < 0.5:
        tex = cv2.GaussianBlur(tex, (3, 3), 0)
    return tex


def _paste_object(
    img: np.ndarray, rng: np.random.Generator, cx: int, cy: int, size: int
) -> None:
    """Textured ellipse/rect target centered at (cx, cy)."""
    import cv2

    h, w = img.shape[:2]
    obj = _texture(rng, size, size)
    mask = np.zeros((size, size), np.uint8)
    if rng.random() < 0.5:
        cv2.ellipse(mask, (size // 2, size // 2), (size // 2 - 1, size // 3), 0, 0, 360, 255, -1)
    else:
        cv2.rectangle(mask, (1, 1), (size - 2, size - 2), 255, -1)
    x0, y0 = cx - size // 2, cy - size // 2
    x1, y1 = x0 + size, y0 + size
    sx0, sy0 = max(0, -x0), max(0, -y0)
    x0, y0 = max(0, x0), max(0, y0)
    x1, y1 = min(w, x1), min(h, y1)
    if x1 <= x0 or y1 <= y0:
        return
    region = img[y0:y1, x0:x1]
    m = mask[sy0 : sy0 + (y1 - y0), sx0 : sx0 + (x1 - x0), None] > 0
    region[:] = np.where(m, obj[sy0 : sy0 + (y1 - y0), sx0 : sx0 + (x1 - x0)], region)


def synthesize_pair_batch(
    rng: np.random.Generator, batch: int, cfg: SiameseConfig
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """-> (templates [B,ts,ts,3], searches [B,ss,ss,3], target_yx [B,2] peak
    coordinates in the response map)."""
    ts, ss = cfg.template_size, cfg.search_size
    resp_edge = (ss - ts) // STRIDE + 1
    templates = np.empty((batch, ts, ts, 3), np.uint8)
    searches = np.empty((batch, ss, ss, 3), np.uint8)
    targets = np.empty((batch, 2), np.int32)
    margin = ts // 2
    for b in range(batch):
        scene = _texture(rng, ss * 2, ss * 2)
        # clutter + distractor of similar size
        for _ in range(rng.integers(0, 4)):
            _paste_object(
                scene, rng,
                int(rng.integers(0, ss * 2)), int(rng.integers(0, ss * 2)),
                int(rng.integers(8, 24)),
            )
        obj_size = int(rng.integers(10, ts - 4))
        # place target somewhere the search window can see
        tcx = ss + int(rng.integers(-(ss // 2 - margin), ss // 2 - margin + 1))
        tcy = ss + int(rng.integers(-(ss // 2 - margin), ss // 2 - margin + 1))
        _paste_object(scene, rng, tcx, tcy, obj_size)
        searches[b] = scene[ss - ss // 2 : ss + ss // 2, ss - ss // 2 : ss + ss // 2]

        # template: crop around the true center with brightness jitter —
        # the appearance-variation the tracker must be invariant to
        patch = scene[tcy - ts // 2 : tcy + ts // 2, tcx - ts // 2 : tcx + ts // 2]
        jitter = rng.uniform(0.8, 1.2)
        templates[b] = np.clip(patch.astype(np.float32) * jitter, 0, 255).astype(np.uint8)

        # response-map coordinates of the target inside the search window
        off_x = tcx - (ss - ss // 2)  # target center in search-window pixels
        off_y = tcy - (ss - ss // 2)
        rx = int(np.clip(round((off_x - ts // 2) / STRIDE), 0, resp_edge - 1))
        ry = int(np.clip(round((off_y - ts // 2) / STRIDE), 0, resp_edge - 1))
        targets[b] = (ry, rx)
    return templates, searches, targets


def prep_batch(patches_u8: torch.Tensor) -> torch.Tensor:
    """uint8 [B, S, S, 3] -> float32 [B, 3, S, S] in [-1, 1] (the tracker's
    ``_prep`` over a batch)."""
    x = (patches_u8.to(torch.float64) * _PREP_SCALE - 1.0).to(torch.float32)
    return x.permute(0, 3, 1, 2)


def pair_logits(net: EmbedNet, templates_u8: torch.Tensor, searches_u8: torch.Tensor) -> torch.Tensor:
    """Each pair's response map, flattened and scaled: [B, re * re]."""
    tfeat = net(prep_batch(templates_u8))  # [B, F, ht, wt]
    sfeat = net(prep_batch(searches_u8))  # [B, F, hs, ws]
    b, f, ht, wt = tfeat.shape
    resp = F.conv2d(sfeat.reshape(1, b * f, *sfeat.shape[2:]), tfeat.reshape(b * f, 1, ht, wt), groups=b * f)
    resp = resp.reshape(b, f, *resp.shape[2:]).sum(dim=1)  # [B, re, re]
    return resp.reshape(b, -1) / (ht * wt * f)


def pair_loss(net: EmbedNet, templates_u8: torch.Tensor, searches_u8: torch.Tensor, targets: torch.Tensor,
              resp_edge: int) -> torch.Tensor:
    """Mean cross-entropy of the response maps against the target cells."""
    labels = (targets[:, 0] * resp_edge + targets[:, 1]).long()
    return F.cross_entropy(pair_logits(net, templates_u8, searches_u8), labels)


def train(
    cfg: SiameseConfig = SiameseConfig(),
    *,
    steps: int = 800,
    batch: int = 16,
    lr: float = 1e-3,
    seed: int = 0,
    log_every: int = 100,
    device: str | torch.device = "cuda",
    init_params: dict[str, torch.Tensor] | None = None,
    log: StepLog | None = None,
) -> tuple[EmbedNet, float]:
    """Train on synthetic pairs; returns (the trained net, the last loss)."""
    dev = model_device(device, "the tracker trainer")
    rng = np.random.default_rng(seed)
    with torch.device(dev):
        net = EmbedNet(cfg.features)
    if init_params is None:
        net.init_weights(torch.Generator(device=dev).manual_seed(seed))
    else:
        net.load_state_dict(init_params)
    opt = optax_adamw(net.parameters(), lr)
    resp_edge = (cfg.search_size - cfg.template_size) // STRIDE + 1

    def step(templates, searches, targets) -> torch.Tensor:
        t, s, y = (torch.from_numpy(a).to(dev) for a in (templates, searches, targets))
        with _fp32(dev):
            return optimizer_step(opt, lambda: pair_loss(net, t, s, y, resp_edge))

    loss = run_steps(steps, lambda: synthesize_pair_batch(rng, batch, cfg), step, log, log_every=log_every,
                     label="tracker train", logger=logger)
    return net.eval(), loss


def train_and_stage(
    cfg: SiameseConfig = SiameseConfig(),
    *,
    model_id: str = MODEL_ID,
    out_dir: str | None = None,
    **train_kw,
):
    """Train, then write ``params.msgpack`` under the staging directory (or
    ``out_dir``); returns (checkpoint path, last loss)."""
    from cosmos_curate_tpu_torch.models import registry

    net, loss = train(cfg, **train_kw)
    ckpt = registry.save_params(model_id, net, root=out_dir)
    logger.info("staged %s (final loss %.4f) at %s", model_id, loss, ckpt)
    return ckpt, loss


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser(description="Train the siamese tracker embedding")
    ap.add_argument("--steps", type=int, default=800)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--out-dir", default=None)
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    a = ap.parse_args()
    train_and_stage(steps=a.steps, batch=a.batch, out_dir=a.out_dir, device=a.device)
