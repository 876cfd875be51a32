"""Promptable object tracking: normalized cross-correlation template
tracking (port of ``cosmos_curate_tpu/models/tracker.py``).

A prompted box on the first frame gives a template; each frame's search
window around the last position is correlated with it (``correlate``), the
peak is the new position, and the template follows the object by an EMA
update. ``host_track`` holds the coordinate math the NCC and siamese
trackers share: the clip is resized to a square work size on the host, the
track runs there, and the boxes are mapped back to the clip's pixels.

The reference runs the whole clip as one jitted ``lax.scan``. Here the
frame loop is Python over device ops, with every coordinate kept on the
device (crops by ``index_select``), so a clip's track is read back once, at
its end: about 30 small launches a frame, and no per-frame synchronisation.

Parity with the reference where a plain transcription drifts:
- the patch variance is the population variance (``correction=0``);
- the correlation is a cross-correlation, as ``conv_general_dilated`` is,
  computed as one fp32 product over unfolded patches (``correlate``), and
  ``argmax`` takes the first maximum, as ``jnp.argmax`` does;
- the products run with TF32 off, for the call only (``models/ocr.py``
  ``_fp32``): a TF32 sum picks another peak;
- the gray conversion folds its constants as XLA folds the reference's
  (the channel mean and the /255 one float32 product);
- the first crop clips the float prompt centre and truncates it, later
  crops take the integer peak;
- the reference pads the frame count to a power of two for XLA's compile
  cache; the scan is causal, so the port leaves the padding out.

Entry points run on ``device="cuda"`` unless the caller asks for the CPU.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F

from cosmos_curate_tpu_torch.core.model import model_device
from cosmos_curate_tpu_torch.models.ocr import _fp32

_GRAY_SCALE = float(np.float32(np.float32(1.0 / 3.0) * np.float32(1.0 / 255.0)))


@dataclass(frozen=True)
class TrackerConfig:
    template_size: int = 32  # template patch edge (resized)
    search_radius: int = 24  # pixels around last center searched
    ema: float = 0.1  # template update rate
    work_size: int = 128  # frames resized to work_size x work_size


def _to_gray(frames_u8: torch.Tensor) -> torch.Tensor:
    return frames_u8.to(torch.float32).sum(dim=-1) * _GRAY_SCALE


def _normalize(patch: torch.Tensor) -> torch.Tensor:
    centred = patch - patch.mean()
    sd = torch.sqrt(torch.clamp(patch.var(correction=0), min=1e-8))
    return centred / sd


def crop(img: torch.Tensor, cx: torch.Tensor, cy: torch.Tensor, size: int) -> tuple:
    """``img[y0:y0+size, x0:x0+size]`` with the corner clipped into the
    square image and truncated to int32 (a float centre truncates as the
    reference's ``astype`` does); returns (patch, x0, y0), all on the
    image's device."""
    s = img.shape[0]
    x0 = torch.clamp(cx - size // 2, 0, s - size).to(torch.int32)
    y0 = torch.clamp(cy - size // 2, 0, s - size).to(torch.int32)
    span = torch.arange(size, device=img.device, dtype=torch.int32)
    return img.index_select(0, y0 + span).index_select(1, x0 + span), x0, y0


def correlate(image: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """The valid cross-correlation of one [1, C, H, W] image with one
    [1, C, h, w] kernel, summed over channels, row-major flat: one fp32
    product of the kernel with the image's unfolded patches. A plain fp32
    sum: oneDNN's fp32 conv on the CPU reads 4x the reference's rounding
    error against float64 on a 64-pixel template, where this reads 1/17 of
    it."""
    return (kernel.reshape(1, -1) @ F.unfold(image, kernel.shape[-2:])[0])[0]


def template_edge(box0: np.ndarray, work_size: int) -> int:
    """The NCC template's edge: twice the scaled prompt extent (an
    exact-extent template over a uniform object has ~zero variance), a power
    of two, at least 8 and at most ``work_size // 2``."""
    extent = max(8.0, 2.0 * float(max(box0[2], box0[3])))
    return min(1 << int(np.ceil(np.log2(extent))), work_size // 2)


def ncc_track(frames_u8: torch.Tensor, box0: np.ndarray, cfg: TrackerConfig, ts: int) -> tuple:
    """frames_u8: [T, S, S, 3] at the work size on the device; box0 (cx, cy,
    w, h) in work coordinates; ts the template edge. Returns (centres
    [T, 2] float32, scores [T]) on the device."""
    dev = frames_u8.device
    gray = _to_gray(frames_u8)
    s = gray.shape[1]
    r = min(cfg.search_radius, (s - ts) // 2)
    cx0 = torch.tensor(box0[0], dtype=torch.float32, device=dev)
    cy0 = torch.tensor(box0[1], dtype=torch.float32, device=dev)
    template, tx0, ty0 = crop(gray[0], cx0, cy0, ts)
    template = _normalize(template)
    # crop() clamps at the image edges, so the template's centre can differ
    # from the prompted one; the target sits at this constant offset
    delta = torch.stack([cx0 - (tx0 + ts // 2), cy0 - (ty0 + ts // 2)]).to(torch.float32)
    search = ts + 2 * r
    cx, cy = cx0.to(torch.int32), cy0.to(torch.int32)
    centres, scores = [], []
    with _fp32(dev):
        for frame in gray:
            window, wx0, wy0 = crop(frame, cx, cy, search)
            flat = correlate(_normalize(window)[None, None], template[None, None])  # [(2r+1)^2]
            idx = torch.argmax(flat)
            cy = wy0 + (idx // (2 * r + 1)).to(torch.int32) + ts // 2
            cx = wx0 + (idx % (2 * r + 1)).to(torch.int32) + ts // 2
            scores.append(flat[idx] / float(ts * ts))
            centres.append(torch.stack([cx, cy]))
            patch, _, _ = crop(frame, cx, cy, ts)
            template = _normalize((1.0 - cfg.ema) * template + cfg.ema * _normalize(patch))
    return torch.stack(centres).to(torch.float32) + delta[None, :], torch.stack(scores)


def host_track(
    frames: np.ndarray,
    box_xywh: tuple[float, float, float, float],
    work_size: int,
    scan_fn: Callable[[np.ndarray, np.ndarray], tuple],
) -> tuple[np.ndarray, np.ndarray]:
    """The host side the NCC and siamese trackers share: resize the clip to
    the square work size (``INTER_AREA``), map the prompt box into work
    coordinates, run ``scan_fn(small_u8, box0) -> (centres, scores)`` and map
    the track back to the clip's pixels."""
    import cv2

    t, h, w = frames.shape[:3]
    small = np.stack([cv2.resize(f, (work_size, work_size), interpolation=cv2.INTER_AREA) for f in frames])
    sx, sy = work_size / w, work_size / h
    x, y, bw, bh = box_xywh
    box0 = np.asarray([(x + bw / 2) * sx, (y + bh / 2) * sy, bw * sx, bh * sy], np.float32)
    centres, scores = scan_fn(small, box0)
    centres = np.asarray(centres, np.float32)[:t]
    boxes = np.stack(
        [
            centres[:, 0] / sx - bw / 2,
            centres[:, 1] / sy - bh / 2,
            np.full(t, bw, np.float32),
            np.full(t, bh, np.float32),
        ],
        axis=1,
    )
    return boxes, np.asarray(scores)[:t]


class TemplateTracker:
    """Track a prompted box through a clip with the NCC tracker."""

    def __init__(self, cfg: TrackerConfig = TrackerConfig(), *, device: str | torch.device = "cuda") -> None:
        self.cfg = cfg
        self.device = model_device(device, "the tracker")

    def track(self, frames: np.ndarray, box_xywh: tuple[float, float, float, float]) -> tuple[np.ndarray, np.ndarray]:
        """frames: uint8 [T, H, W, 3]; box: (x, y, w, h) in pixels of the
        first frame. Returns (boxes [T, 4] xywh in the clip's pixels,
        scores [T])."""

        def scan(small: np.ndarray, box0: np.ndarray) -> tuple:
            dev_frames = torch.from_numpy(small).to(self.device)
            centres, scores = ncc_track(dev_frames, box0, self.cfg, template_edge(box0, self.cfg.work_size))
            return centres.cpu().numpy(), scores.cpu().numpy()

        return host_track(frames, box_xywh, self.cfg.work_size, scan)
