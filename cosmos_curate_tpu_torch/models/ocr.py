"""Learned overlay-text detection and recognition (port of
``cosmos_curate_tpu/models/ocr.py``).

- ``TextDetector``: a small FCN over RGB frames that gives a text
  heatmap at 1/4 resolution; boxes come from connected components on the
  host (``heatmap_to_boxes``).
- ``TextRecognizer``: a CRNN whose conv features fold the height into the
  channels, giving a width-major sequence of per-step charset logits,
  decoded with greedy CTC.

The trained checkpoints ship with the repository under ``weights/``
(``ocr-detector-tpu``, ``ocr-recognizer-tpu``: the JAX package's flax
msgpack, read through ``models/registry.py``). The modules keep the flax
names (``Conv_0`` ... ``Dense_1``), so the checkpoint maps onto them
mechanically (models/convert_jax.py).

Layouts. The flax modules are NHWC; these are NCHW. Flax pads ``SAME``
asymmetrically where the total is odd (a stride-2 3x3 conv on an even size
pads 0 before and 1 after), so every conv pads explicitly with
``same_padding`` rather than through ``nn.Conv2d(padding=...)``, whose
padding is symmetric. The recognizer folds height into channels in NHWC
order (channel fastest), which NCHW reaches by permuting to [B, W, H, C].

Precision. The reference computes fp32 convolutions. On the GPU, cuDNN
runs fp32 convolutions in TF32 by default (``torch.backends.cudnn.
allow_tf32``), which moves a heatmap thresholded at 0.5 and a coverage
that decides keep or drop. So the forwards run with TF32 off, set for the
duration of the forward only (``_fp32``), never for the process.

Entry points run on ``device="cuda"`` unless the caller asks for the CPU.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from cosmos_curate_tpu_torch.core.model import model_device

# CTC charset: blank=0, then printable chars OCR must distinguish
CHARSET = " ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz0123456789.,:!?-'&%$#@()/"
BLANK_ID = 0
DETECTOR_ID = "ocr-detector-tpu"
RECOGNIZER_ID = "ocr-recognizer-tpu"


def char_to_id(c: str) -> int:
    i = CHARSET.find(c)
    return i + 1 if i >= 0 else CHARSET.find("?") + 1


def encode_text(text: str) -> list[int]:
    return [char_to_id(c) for c in text]


def decode_ids(ids: list[int]) -> str:
    return "".join(CHARSET[i - 1] for i in ids if 1 <= i <= len(CHARSET))


def same_padding(size: int, kernel: int, stride: int = 1, dilation: int = 1) -> tuple[int, int]:
    """(before, after) padding of flax's ``SAME`` along one axis: the output
    is ``ceil(size / stride)`` long, and an odd total pads one more after."""
    out = -(-size // stride)
    total = max((out - 1) * stride + (kernel - 1) * dilation + 1 - size, 0)
    return total // 2, total - total // 2


def _conv2d_same(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    (kh, kw), (sh, sw), (dh, dw) = conv.kernel_size, conv.stride, conv.dilation
    top, bottom = same_padding(x.shape[-2], kh, sh, dh)
    left, right = same_padding(x.shape[-1], kw, sw, dw)
    return conv(F.pad(x, (left, right, top, bottom)))


def _init_convs(module: nn.Module, generator: torch.Generator) -> None:
    """A seeded init (flax's defaults in kind: lecun-normal kernels, zero
    biases); parity tests load the JAX package's own init instead."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (nn.Conv1d, nn.Conv2d, nn.Linear)):
                fan_in = m.weight[0].numel()
                m.weight.copy_(torch.randn(m.weight.shape, generator=generator, device=m.weight.device) / fan_in**0.5)
                m.bias.zero_()


def _normalize(frames_u8: torch.Tensor) -> torch.Tensor:
    """uint8 [B, H, W, 3] -> float32 NCHW in [-1, 1], as the reference scales."""
    return (frames_u8.to(torch.float32) / 127.5 - 1.0).permute(0, 3, 1, 2)


@dataclass(frozen=True)
class DetectorConfig:
    height: int = 128
    width: int = 224
    base_filters: int = 16


class TextDetector(nn.Module):
    """FCN heatmap detector: uint8 [B, H, W, 3] -> logits [B, H/4, W/4]."""

    def __init__(self, cfg: DetectorConfig = DetectorConfig()) -> None:
        super().__init__()
        f = cfg.base_filters
        self.cfg = cfg
        self.Conv_0 = nn.Conv2d(3, f, 3, stride=2)
        self.Conv_1 = nn.Conv2d(f, 2 * f, 3, stride=2)
        # dilated context without further downsampling (text strokes are
        # thin; receptive field matters more than depth)
        self.Conv_2 = nn.Conv2d(2 * f, 2 * f, 3, dilation=2)
        self.Conv_3 = nn.Conv2d(2 * f, 2 * f, 3, dilation=4)
        self.Conv_4 = nn.Conv2d(2 * f, 1, 1)

    def init_weights(self, generator: torch.Generator) -> None:
        _init_convs(self, generator)

    def forward(self, frames_u8: torch.Tensor) -> torch.Tensor:
        x = _normalize(frames_u8)
        for conv in (self.Conv_0, self.Conv_1, self.Conv_2, self.Conv_3):
            x = F.relu(_conv2d_same(conv, x))
        return self.Conv_4(x)[:, 0]


@dataclass(frozen=True)
class RecognizerConfig:
    height: int = 32
    max_width: int = 160
    base_filters: int = 24
    hidden: int = 96

    @property
    def num_classes(self) -> int:
        return len(CHARSET) + 1  # + blank

    @property
    def seq_len(self) -> int:
        return self.max_width // 4


class TextRecognizer(nn.Module):
    """CRNN: uint8 crops [B, 32, W, 3] -> logits [B, W/4, num_classes]."""

    def __init__(self, cfg: RecognizerConfig = RecognizerConfig()) -> None:
        super().__init__()
        f = cfg.base_filters
        self.cfg = cfg
        self.Conv_0 = nn.Conv2d(3, f, 3, stride=2)  # H/2, W/2
        self.Conv_1 = nn.Conv2d(f, 2 * f, 3, stride=2)  # H/4, W/4
        self.Conv_2 = nn.Conv2d(2 * f, 2 * f, 3)
        self.Dense_0 = nn.Linear(2 * f * -(-cfg.height // 4), cfg.hidden)  # height after two stride-2 convs
        # the reference's cheap BiLSTM stand-in: one 5-tap conv over the
        # sequence with a residual
        self.Conv_3 = nn.Conv1d(cfg.hidden, cfg.hidden, 5)
        self.Dense_1 = nn.Linear(cfg.hidden, cfg.num_classes)

    def init_weights(self, generator: torch.Generator) -> None:
        _init_convs(self, generator)

    def forward(self, crops_u8: torch.Tensor) -> torch.Tensor:
        x = _normalize(crops_u8)
        for conv in (self.Conv_0, self.Conv_1, self.Conv_2):
            x = F.relu(_conv2d_same(conv, x))
        # fold the height into the channels in NHWC order (channel fastest):
        # [B, C, H, W] -> [B, W, H, C] -> [B, W, H * C]
        b, c, h, w = x.shape
        seq = x.permute(0, 3, 2, 1).reshape(b, w, h * c)
        seq = F.relu(self.Dense_0(seq))
        left, right = same_padding(w, self.Conv_3.kernel_size[0])
        fwd = self.Conv_3(F.pad(seq.transpose(1, 2), (left, right))).transpose(1, 2)
        seq = F.relu(fwd) + seq
        return self.Dense_1(seq)


def greedy_ctc_decode(logits: np.ndarray) -> list[str]:
    """[B, T, K] -> best-path decoded strings (collapse repeats, drop blank)."""
    out = []
    ids = np.asarray(logits).argmax(axis=-1)
    for row in ids:
        collapsed = []
        prev = -1
        for i in row:
            if i != prev and i != BLANK_ID:
                collapsed.append(int(i))
            prev = i
        out.append(decode_ids(collapsed))
    return out


@dataclass
class TextBox:
    x0: int
    y0: int
    x1: int
    y1: int
    score: float


def heatmap_to_boxes(prob: np.ndarray, *, threshold: float = 0.5, scale: int = 4, min_area: int = 6) -> list[TextBox]:
    """Connected components over a thresholded heatmap -> frame-space boxes
    (on the host; the heatmap is tiny). ``scale`` maps heatmap px -> frame px."""
    import cv2

    mask = (prob > threshold).astype(np.uint8)
    n, labels, stats, _ = cv2.connectedComponentsWithStats(mask, connectivity=8)
    boxes = []
    for i in range(1, n):
        x, y, w, h, area = stats[i]
        if area < min_area:
            continue
        comp_scores = prob[labels == i]
        boxes.append(
            TextBox(int(x * scale), int(y * scale), int((x + w) * scale), int((y + h) * scale),
                    float(comp_scores.mean()))
        )
    return boxes


@contextlib.contextmanager
def _fp32(device: torch.device):
    """True fp32 convolutions and products for the block: cuDNN's and
    cuBLAS's TF32 off on the GPU, the other cuDNN settings left as they
    are, all restored on exit."""
    if device.type != "cuda":
        yield
        return
    cudnn = torch.backends.cudnn
    matmul = torch.backends.cuda.matmul
    saved = matmul.allow_tf32
    matmul.allow_tf32 = False
    try:
        with cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark, deterministic=cudnn.deterministic,
                         allow_tf32=False):
            yield
    finally:
        matmul.allow_tf32 = saved


class OcrModel:
    """Detector and recognizer behind one interface: detect boxes, recognize
    text, score overlay coverage."""

    def __init__(
        self,
        det_cfg: DetectorConfig = DetectorConfig(),
        rec_cfg: RecognizerConfig = RecognizerConfig(),
        *,
        device: str | torch.device = "cuda",
    ) -> None:
        self.device = model_device(device, "the OCR model")
        self.det_cfg = det_cfg
        self.rec_cfg = rec_cfg
        with torch.device(self.device):
            self.detector = TextDetector(det_cfg).eval()
            self.recognizer = TextRecognizer(rec_cfg).eval()

    def setup(self, *, require_weights: bool = False) -> None:
        """Load both checkpoints (else the seeded init, with a warning).
        ``require_weights=True`` raises when a checkpoint is missing or its
        shapes do not match: a caller that would fail open on random logits
        (the text filter) must use it."""
        from cosmos_curate_tpu_torch.models import registry

        registry.load_module(self.detector, DETECTOR_ID, require=require_weights)
        registry.load_module(self.recognizer, RECOGNIZER_ID, require=require_weights)

    def _resize(self, frames, hw: tuple[int, int]) -> np.ndarray:
        """Accepts an array batch OR a list of differently sized frames."""
        import cv2

        h, w = hw
        return np.stack([cv2.resize(np.asarray(f), (w, h)) for f in frames])

    @torch.no_grad()
    def _detect(self, frames) -> torch.Tensor:
        x = torch.from_numpy(self._resize(frames, (self.det_cfg.height, self.det_cfg.width))).to(self.device)
        with _fp32(self.device):
            return self.detector(x)

    def detector_logits(self, frames) -> np.ndarray:
        """uint8 [B, H, W, 3] -> heatmap logits [B, 32, 56] (float32),
        frames resized to the detector's input first."""
        return self._detect(frames).cpu().numpy()

    def heatmap(self, frames) -> np.ndarray:
        """uint8 [B, H, W, 3] -> text probabilities [B, 32, 56] (float32)."""
        return torch.sigmoid(self._detect(frames)).cpu().numpy()

    @torch.no_grad()
    def recognizer_logits(self, crops) -> np.ndarray:
        """uint8 crops [B, h, w, 3] -> logits [B, 40, num_classes] (float32),
        crops resized to the recognizer's input first."""
        x = torch.from_numpy(self._resize(crops, (self.rec_cfg.height, self.rec_cfg.max_width))).to(self.device)
        with _fp32(self.device):
            logits = self.recognizer(x)
        return logits.cpu().numpy()

    def detect(self, frames, *, threshold: float = 0.5) -> list[list[TextBox]]:
        """uint8 [B, H, W, 3] -> per-frame text boxes in model input space."""
        return [heatmap_to_boxes(p, threshold=threshold) for p in self.heatmap(frames)]

    def text_coverage(self, frames, *, threshold: float = 0.5) -> float:
        """Max fraction of frame area covered by detected text: the filter
        stage's decision signal."""
        mask = self.heatmap(frames) > threshold
        # the reference's float32 mean: the count times the float32
        # reciprocal of the area (XLA's form of the division)
        area = np.float32(1.0 / (mask.shape[1] * mask.shape[2]))
        cover = mask.sum(axis=(1, 2)).astype(np.float32) * area
        return float(cover.max())

    def recognize(self, crops) -> list[str]:
        """uint8 [B, h, w, 3] text crops -> decoded strings."""
        return greedy_ctc_decode(self.recognizer_logits(crops))

    def read(self, frame: np.ndarray, *, threshold: float = 0.5) -> list[tuple[TextBox, str]]:
        """Full OCR on one frame: detect boxes, recognize each crop."""
        (boxes,) = self.detect(frame[None], threshold=threshold)
        if not boxes:
            return []
        # boxes are in detector input space; map back to the frame
        fh, fw = frame.shape[:2]
        sy = fh / self.det_cfg.height
        sx = fw / self.det_cfg.width
        crops = []
        mapped = []
        for b in boxes:
            x0, y0 = max(0, int(b.x0 * sx)), max(0, int(b.y0 * sy))
            x1, y1 = min(fw, int(b.x1 * sx)), min(fh, int(b.y1 * sy))
            if x1 - x0 < 4 or y1 - y0 < 4:
                continue
            crops.append(frame[y0:y1, x0:x1])
            mapped.append(TextBox(x0, y0, x1, y1, b.score))
        if not crops:
            return []
        texts = self.recognize(crops)
        return list(zip(mapped, texts))
