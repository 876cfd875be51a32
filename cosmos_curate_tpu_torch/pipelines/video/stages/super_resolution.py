"""Super-resolution stage: windowed upscaling with overlap blending (port of
``cosmos_curate_tpu/pipelines/video/stages/super_resolution.py``).

Each clip is decoded, cut into overlapping windows
(``video/windowing.overlapping_windows``), upscaled window by window on
``device``, blended where windows overlap (``blend_windows``: linear ramps
on each later window's leading edge), and re-encoded at the new size in
place of ``clip.encoded_data``. ``variant`` picks the model: ``diffusion``
(the default, models/diffusion_sr.py) or ``srnet`` (models/
super_resolution.py); an explicit ``SRConfig`` selects ``srnet``.

Every window of a clip is submitted before any is read back, so the next
window's host-to-device copy overlaps this one's compute. A clip that fails
on its data (a decode or codec error) keeps its original bytes with the
error on ``clip.errors["super_resolution"]``, and the windows in flight are
dropped; a device fault propagates. ``sp_size > 1`` raises
``NotImplementedError`` (ROADMAP queue A item 7).
"""

from __future__ import annotations

import numpy as np
import torch

from cosmos_curate_tpu_torch.core.model import ModelInterface
from cosmos_curate_tpu_torch.core.stage import Resources, Stage
from cosmos_curate_tpu_torch.data.model import SplitPipeTask
from cosmos_curate_tpu_torch.models.super_resolution import SR_BASE, SRConfig, SuperResolutionModel
from cosmos_curate_tpu_torch.ops._build import DEVICE_FAULTS
from cosmos_curate_tpu_torch.utils.logging import get_logger
from cosmos_curate_tpu_torch.video.decode import decode_frames, extract_video_metadata
from cosmos_curate_tpu_torch.video.encode import encode_frames
from cosmos_curate_tpu_torch.video.windowing import overlapping_windows

logger = get_logger(__name__)


def blend_windows(windows: list[tuple[int, int, np.ndarray]], total: int) -> np.ndarray:
    """Linear-ramp blend of overlapping [start, end) frame windows, rounded
    to uint8."""
    assert windows
    h, w, c = windows[0][2].shape[1:]
    acc = np.zeros((total, h, w, c), np.float32)
    weight = np.zeros((total, 1, 1, 1), np.float32)
    for start, end, frames in windows:
        n = end - start
        ramp = np.ones(n, np.float32)
        # ramp the leading edge so consecutive windows cross-fade
        lead = min(n, max(1, n // 4))
        if start > 0:
            ramp[:lead] = np.linspace(0.0, 1.0, lead, endpoint=False) + 1e-3
        acc[start:end] += frames[:n].astype(np.float32) * ramp[:, None, None, None]
        weight[start:end, 0, 0, 0] += ramp
    return (acc / np.maximum(weight, 1e-6)).round().astype(np.uint8)


class SuperResolutionStage(Stage[SplitPipeTask, SplitPipeTask]):
    def __init__(
        self,
        *,
        cfg: SRConfig | None = None,
        window_len: int = 128,
        overlap: int = 64,
        sp_size: int = 1,
        variant: str = "diffusion",
        diffusion_cfg=None,
        device: str | torch.device = "cuda",
    ) -> None:
        self.window_len = window_len
        self.overlap = overlap
        if cfg is not None and diffusion_cfg is not None:
            raise ValueError("pass cfg (srnet) OR diffusion_cfg, not both")
        if cfg is not None:
            if variant == "diffusion":
                logger.info("explicit SRConfig selects the srnet variant")
            variant = "srnet"
        if variant == "diffusion":
            from cosmos_curate_tpu_torch.models.diffusion_sr import DIFF_SR_BASE, DiffusionSRModel

            self._model = DiffusionSRModel(diffusion_cfg or DIFF_SR_BASE, sp_size=sp_size, device=device)
        elif variant == "srnet":
            self._model = SuperResolutionModel(cfg or SR_BASE, sp_size=sp_size, device=device)
        else:
            raise ValueError(f"unknown SR variant {variant!r}; have diffusion|srnet")

    @property
    def model(self) -> ModelInterface:
        return self._model

    @property
    def resources(self) -> Resources:
        return Resources(cpus=1.0, entire_gpu_host=self._model.device.type == "cuda")

    def process_data(self, tasks: list[SplitPipeTask]) -> list[SplitPipeTask]:
        for task in tasks:
            for clip in task.video.clips:
                if clip.encoded_data is None:
                    continue
                try:
                    meta = extract_video_metadata(clip.encoded_data)
                    frames = decode_frames(clip.encoded_data)
                    if frames.shape[0] == 0:
                        continue
                    spans = overlapping_windows(frames.shape[0], window_len=self.window_len, overlap=self.overlap)
                    for a, b in spans:
                        self._model.submit_window(frames[a:b])
                    upscaled = [(a, b, out) for (a, b), out in zip(spans, self._model.drain_windows(), strict=True)]
                    clip.encoded_data = encode_frames(blend_windows(upscaled, frames.shape[0]), fps=meta.fps or 24.0)
                except DEVICE_FAULTS:
                    raise
                except Exception as e:
                    logger.warning("SR failed for %s: %s", clip.uuid, e)
                    clip.errors["super_resolution"] = str(e)
                    # windows left in flight would pair with the next clip's
                    # spans at its drain
                    pipe = self._model.device_pipeline
                    if pipe is not None:
                        pipe.abort()
        return tasks
