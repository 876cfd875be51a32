"""Synthetic-data training for the OCR detector and recognizer (port of
``cosmos_curate_tpu/models/ocr_train.py``).

The models of models/ocr.py train on text rendered with cv2's Hershey
fonts over procedural backgrounds. The synthesizers and the golden
fixtures (``golden_eval_frames``, ``golden_rec_sample``) are the
reference's, line for line, so one numpy seed gives the same batches in
both packages.

- The detector: the reference's weighted sigmoid cross-entropy over the
  1/4-resolution heatmap (a text pixel weighs ``pos_weight``, 3).
- The recognizer: CTC. ``optax.ctc_loss`` gives each sequence's negative
  log-likelihood, not divided by its label length, and the reference takes
  the batch mean; so ``F.ctc_loss`` runs with ``reduction="none"`` on
  ``[T, B, K]`` log-probabilities (every input length ``T``, target lengths
  from the label pads, ``blank=BLANK_ID``), then the mean.

fp32 with TF32 off for the step, as the OCR models infer (models/ocr.py
``_fp32``). Each trainer runs on ``device="cuda"`` unless the caller asks
for the CPU, and raises where CUDA is missing. ``init_params`` (a
``state_dict``) replaces the seeded init, and ``log``
(``train_common.StepLog``) keeps each step's records.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from cosmos_curate_tpu_torch.core.model import model_device
from cosmos_curate_tpu_torch.models.ocr import (
    BLANK_ID,
    CHARSET,
    DETECTOR_ID,
    RECOGNIZER_ID,
    DetectorConfig,
    RecognizerConfig,
    TextDetector,
    TextRecognizer,
    _fp32,
    encode_text,
)
from cosmos_curate_tpu_torch.models.train_common import StepLog, optax_adamw, optimizer_step, run_steps
from cosmos_curate_tpu_torch.models.transnet_train import weighted_bce
from cosmos_curate_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

_FONTS = (0, 1, 2, 3, 4, 6, 7)  # cv2 FONT_HERSHEY_* family


def _background(rng: np.random.Generator, h: int, w: int) -> np.ndarray:
    import cv2

    kind = rng.integers(0, 4)
    if kind == 0:  # solid
        img = np.full((h, w, 3), rng.integers(0, 256, 3), np.uint8)
    elif kind == 1:  # linear gradient
        a = rng.integers(0, 256, 3).astype(np.float32)
        b = rng.integers(0, 256, 3).astype(np.float32)
        t = np.linspace(0, 1, w)[None, :, None]
        img = (a + (b - a) * t).astype(np.uint8)
        img = np.broadcast_to(img, (h, w, 3)).copy()
    elif kind == 2:  # random rectangles (scene-ish clutter)
        img = np.full((h, w, 3), rng.integers(0, 256, 3), np.uint8)
        for _ in range(rng.integers(2, 8)):
            x0, y0 = rng.integers(0, w), rng.integers(0, h)
            x1, y1 = rng.integers(0, w), rng.integers(0, h)
            cv2.rectangle(
                img,
                (min(x0, x1), min(y0, y1)),
                (max(x0, x1), max(y0, y1)),
                tuple(int(v) for v in rng.integers(0, 256, 3)),
                -1,
            )
    else:  # noise texture
        img = rng.integers(0, 256, (h, w, 3), np.uint8)
        import cv2 as _cv2

        img = _cv2.GaussianBlur(img, (5, 5), 0)
    return img


def _rand_text(rng: np.random.Generator, max_len: int = 10) -> str:
    n = int(rng.integers(1, max_len + 1))
    chars = CHARSET[1:]  # no leading/trailing spaces (cleaner CTC targets)
    s = "".join(chars[rng.integers(0, len(chars))] for _ in range(n))
    # interior spaces in ~half the samples: real overlays are multi-word
    # ("BREAKING NEWS"), and a recognizer that never saw the space class
    # cannot emit it (observed: 'HELLO 42' read as 'HELLO42')
    if n >= 4 and rng.random() < 0.5:
        k = int(rng.integers(1, n - 1))
        s = s[:k] + " " + s[k + 1 :]
    return s


def golden_eval_frames() -> tuple[np.ndarray, np.ndarray]:
    """(clean, texty) frames: the detector's golden pair (the trained
    detector must cover the texty frames well above the clean ones)."""
    import cv2

    clean = np.full((8, 240, 320, 3), 90, np.uint8)
    for f in clean:  # non-text structure: rectangles
        cv2.rectangle(f, (40, 60), (200, 180), (200, 180, 40), -1)
    texty = clean.copy()
    for f in texty:
        cv2.putText(f, "BREAKING NEWS UPDATE", (10, 40),
                    cv2.FONT_HERSHEY_SIMPLEX, 0.8, (255, 255, 255), 2, cv2.LINE_AA)
        cv2.putText(f, "subscribe now!", (60, 220),
                    cv2.FONT_HERSHEY_DUPLEX, 0.7, (0, 255, 255), 2, cv2.LINE_AA)
    return clean, texty


def golden_rec_sample(text: str = "HELLO 42") -> np.ndarray:
    """The recognizer's golden sample: ``text`` rendered black on white."""
    import cv2

    img = np.full((32, 160, 3), 255, np.uint8)
    cv2.putText(img, text, (6, 24), cv2.FONT_HERSHEY_SIMPLEX, 0.8, (0, 0, 0), 2)
    return img


def synthesize_detector_batch(
    rng: np.random.Generator, batch: int, cfg: DetectorConfig
) -> tuple[np.ndarray, np.ndarray]:
    """-> (frames uint8 [B,H,W,3], target float32 [B,H/4,W/4])."""
    import cv2

    h, w = cfg.height, cfg.width
    frames = np.empty((batch, h, w, 3), np.uint8)
    targets = np.zeros((batch, h // 4, w // 4), np.float32)
    for b in range(batch):
        img = _background(rng, h, w)
        if rng.random() < 0.75:  # text-bearing sample
            for _ in range(int(rng.integers(1, 4))):
                text = _rand_text(rng)
                font = int(_FONTS[rng.integers(0, len(_FONTS))])
                scale = float(rng.uniform(0.4, 1.0))
                thick = int(rng.integers(1, 3))
                (tw, th), _ = cv2.getTextSize(text, font, scale, thick)
                if tw >= w - 4 or th >= h - 4:
                    continue
                x = int(rng.integers(2, max(3, w - tw - 2)))
                y = int(rng.integers(th + 2, max(th + 3, h - 4)))
                color = tuple(int(v) for v in rng.integers(0, 256, 3))
                cv2.putText(img, text, (x, y), font, scale, color, thick, cv2.LINE_AA)
                # shrunken box target at 1/4 resolution
                sx0, sy0 = (x + tw // 10) // 4, (y - th + th // 10) // 4
                sx1, sy1 = (x + tw - tw // 10) // 4, (y - th // 10) // 4
                targets[b, max(0, sy0) : sy1 + 1, max(0, sx0) : sx1 + 1] = 1.0
        frames[b] = img
    return frames, targets


def synthesize_recognizer_batch(
    rng: np.random.Generator, batch: int, cfg: RecognizerConfig, max_len: int = 10
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """-> (crops uint8 [B,32,W,3], labels int32 [B,max_len], label_pad [B,max_len])."""
    import cv2

    h, w = cfg.height, cfg.max_width
    crops = np.empty((batch, h, w, 3), np.uint8)
    labels = np.zeros((batch, max_len), np.int32)
    pads = np.ones((batch, max_len), np.float32)
    for b in range(batch):
        img = _background(rng, h, w)
        text = _rand_text(rng, max_len)
        font = int(_FONTS[rng.integers(0, len(_FONTS))])
        thick = int(rng.integers(1, 3))
        # fit the text into the crop width
        scale = 1.0
        (tw, th), _ = cv2.getTextSize(text, font, scale, thick)
        scale = min(0.9 * w / max(tw, 1), 0.7 * h / max(th, 1))
        (tw, th), _ = cv2.getTextSize(text, font, scale, thick)
        x = max(1, (w - tw) // 2 + int(rng.integers(-4, 5)))
        y = min(h - 2, (h + th) // 2 + int(rng.integers(-2, 3)))
        # ensure contrast against the local background
        patch = img[max(0, y - th) : y + 2, x : x + tw + 1]
        mean = patch.mean(axis=(0, 1)) if patch.size else np.array([128.0] * 3)
        color = tuple(int(255 - v) if abs(v - 128) > 40 else (255 if v < 128 else 0) for v in mean)
        cv2.putText(img, text, (x, y), font, scale, color, thick, cv2.LINE_AA)
        crops[b] = img
        ids = encode_text(text)
        labels[b, : len(ids)] = ids
        pads[b, : len(ids)] = 0.0
    return crops, labels, pads


def detector_loss(model: TextDetector, frames_u8: torch.Tensor, targets: torch.Tensor,
                  pos_weight: float) -> torch.Tensor:
    return weighted_bce(model(frames_u8), targets, pos_weight)


def recognizer_loss(model: TextRecognizer, crops_u8: torch.Tensor, labels: torch.Tensor,
                    label_pads: torch.Tensor) -> torch.Tensor:
    """Batch mean of each crop's CTC negative log-likelihood."""
    logits = model(crops_u8)  # [B, T, K]
    b, t, _ = logits.shape
    log_probs = F.log_softmax(logits, dim=-1).transpose(0, 1)  # [T, B, K]
    input_lengths = torch.full((b,), t, dtype=torch.long, device=logits.device)
    target_lengths = (1.0 - label_pads).sum(dim=1).long()
    per = F.ctc_loss(log_probs, labels.long(), input_lengths, target_lengths, blank=BLANK_ID, reduction="none")
    return per.mean()


def _model(cls, cfg, dev: torch.device, seed: int, init_params):
    with torch.device(dev):
        model = cls(cfg)
    if init_params is None:
        model.init_weights(torch.Generator(device=dev).manual_seed(seed))
    else:
        model.load_state_dict(init_params)
    return model


def train_detector(
    cfg: DetectorConfig = DetectorConfig(),
    *,
    steps: int = 500,
    batch: int = 8,
    lr: float = 1e-3,
    pos_weight: float = 3.0,
    seed: int = 0,
    log_every: int = 100,
    device: str | torch.device = "cuda",
    init_params: dict[str, torch.Tensor] | None = None,
    log: StepLog | None = None,
) -> tuple[TextDetector, float]:
    dev = model_device(device, "the OCR detector trainer")
    rng = np.random.default_rng(seed)
    model = _model(TextDetector, cfg, dev, seed, init_params)
    opt = optax_adamw(model.parameters(), lr)

    def step(frames, targets) -> torch.Tensor:
        x, y = torch.from_numpy(frames).to(dev), torch.from_numpy(targets).to(dev)
        with _fp32(dev):
            return optimizer_step(opt, lambda: detector_loss(model, x, y, pos_weight))

    loss = run_steps(steps, lambda: synthesize_detector_batch(rng, batch, cfg), step, log, log_every=log_every,
                     label="ocr-det", logger=logger)
    return model.eval(), loss


def train_recognizer(
    cfg: RecognizerConfig = RecognizerConfig(),
    *,
    steps: int = 1200,
    batch: int = 16,
    lr: float = 2e-3,
    seed: int = 0,
    log_every: int = 100,
    device: str | torch.device = "cuda",
    init_params: dict[str, torch.Tensor] | None = None,
    log: StepLog | None = None,
) -> tuple[TextRecognizer, float]:
    dev = model_device(device, "the OCR recognizer trainer")
    rng = np.random.default_rng(seed)
    model = _model(TextRecognizer, cfg, dev, seed, init_params)
    opt = optax_adamw(model.parameters(), lr)

    def step(crops, labels, pads) -> torch.Tensor:
        x, y, p = (torch.from_numpy(a).to(dev) for a in (crops, labels, pads))
        with _fp32(dev):
            return optimizer_step(opt, lambda: recognizer_loss(model, x, y, p))

    loss = run_steps(steps, lambda: synthesize_recognizer_batch(rng, batch, cfg), step, log, log_every=log_every,
                     label="ocr-rec", logger=logger)
    return model.eval(), loss


def train_and_stage(*, out_dir: str | None = None, det_kw=None, rec_kw=None, device: str | torch.device = "cuda"):
    """Train both, write each ``params.msgpack`` under the staging directory
    (or ``out_dir``); returns {model id: (checkpoint path, last loss)}."""
    from cosmos_curate_tpu_torch.models import registry

    results = {}
    for model_id, trainer, kw in (
        (DETECTOR_ID, train_detector, det_kw or {}),
        (RECOGNIZER_ID, train_recognizer, rec_kw or {}),
    ):
        model, loss = trainer(**{"device": device, **kw})
        ckpt = registry.save_params(model_id, model, root=out_dir)
        logger.info("staged %s (final loss %.4f) at %s", model_id, loss, ckpt)
        results[model_id] = (ckpt, loss)
    return results


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser(description="Train OCR det/rec on synthetic text")
    ap.add_argument("--det-steps", type=int, default=500)
    ap.add_argument("--rec-steps", type=int, default=1200)
    ap.add_argument("--out-dir", default=None, help="e.g. <repo>/weights to commit")
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    a = ap.parse_args()
    train_and_stage(
        out_dir=a.out_dir,
        det_kw={"steps": a.det_steps},
        rec_kw={"steps": a.rec_steps},
        device=a.device,
    )
