"""Artificial (overlay) text filter stage (port of
``cosmos_curate_tpu/pipelines/video/stages/artificial_text_filter.py``).

Two detectors behind one stage:

- **learned** (``mode="learned"``, and ``"auto"`` when the
  ``ocr-detector-tpu`` checkpoint is staged or committed): the text detector
  of models/ocr.py on a fixed 4-frame sample of each clip; the score is the
  largest fraction of a frame's area its heatmap marks as text, and a clip
  at or above ``learned_threshold`` is filtered;
- **heuristic** (``mode="heuristic"``, and ``"auto"`` with no checkpoint):
  the temporally stable horizontal-stroke energy in each frame's border
  bands (titles, subtitles, watermarks), one device call per clip through a
  ``DevicePipeline``, held against ``threshold``.

A filtered clip gets ``filtered_by="text"`` and moves to
``video.filtered_clips``; ``score_only`` keeps every clip with its score.

One divergence from the reference: in ``auto`` mode the reference falls
back to the heuristic when a staged checkpoint fails to load. The port
raises instead: the heuristic is taken only when no checkpoint is staged,
never because the learned path failed.

The stage runs on ``device="cuda"`` unless the caller asks for the CPU.
"""

from __future__ import annotations

import numpy as np
import torch

from cosmos_curate_tpu_torch.core.model import model_device
from cosmos_curate_tpu_torch.core.stage import Resources, Stage, WorkerMetadata
from cosmos_curate_tpu_torch.data.model import FrameExtractionSignature, SplitPipeTask
from cosmos_curate_tpu_torch.models.batching import pad_batch
from cosmos_curate_tpu_torch.models.device_pipeline import DevicePipeline
from cosmos_curate_tpu_torch.models.ocr import DETECTOR_ID, OcrModel
from cosmos_curate_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

_BAND = 0.2  # border band fraction inspected for overlay text
_LEARNED_FRAMES = 4  # frames of a clip the learned detector scores


def _text_likeness(frames_u8: torch.Tensor, n_valid: int) -> torch.Tensor:
    """uint8 [T_pad, H, W, 3] -> scalar, about 1 for typical overlays:
    the fraction of strong horizontal gradients in the top and bottom bands
    of the valid frames' mean (a static overlay survives the mean). The
    constants are folded as XLA folds the reference's (the channel mean and
    the /255 one float32 product, the band mean and the x10 another), so the
    two agree to the last bit wherever the temporal mean does not land a
    gradient exactly on the 0.15 line."""
    to_unit = np.float32(np.float32(1.0 / 3.0) * np.float32(1.0 / 255.0))
    x = frames_u8.to(torch.float32).sum(dim=-1) * to_unit  # [T, H, W]
    h = x.shape[1]
    static = x[:n_valid].sum(dim=0) / max(n_valid, 1)
    gx = (static[:, 1:] - static[:, :-1]).abs()  # horizontal gradients
    band = max(1, int(h * _BAND))
    strong = (torch.cat([gx[:band], gx[-band:]]) > 0.15).to(torch.float32)
    return strong.sum() * np.float32(np.float32(1.0 / strong.numel()) * np.float32(10.0))


class ArtificialTextFilterStage(Stage[SplitPipeTask, SplitPipeTask]):
    def __init__(
        self,
        *,
        threshold: float = 0.5,
        score_only: bool = False,
        extraction: FrameExtractionSignature = FrameExtractionSignature("fps", 2.0),
        mode: str = "auto",  # auto | learned | heuristic
        learned_threshold: float = 0.02,  # text-area fraction that flags a clip
        device: str | torch.device = "cuda",
    ) -> None:
        if mode not in ("auto", "learned", "heuristic"):
            raise ValueError(f"unknown text-filter mode {mode!r}")
        self.threshold = threshold
        self.score_only = score_only
        self.extraction = extraction
        self.mode = mode
        self.learned_threshold = learned_threshold
        self.device = model_device(device, "the text filter")
        self._ocr: OcrModel | None = None
        self._pipe: DevicePipeline | None = None

    @property
    def resources(self) -> Resources:
        # a stage on the CPU claims no card from the runner's budget
        return Resources(cpus=1.0, gpus=0.25 if self.device.type == "cuda" else 0.0)

    def setup(self, worker: WorkerMetadata | None = None) -> None:
        if self.mode == "heuristic":
            return
        from cosmos_curate_tpu_torch.models import registry

        if self.mode == "learned" or registry.find_checkpoint(DETECTOR_ID) is not None:
            ocr = OcrModel(device=self.device)
            # random-init logits would fail OPEN (about half the heatmap over
            # the threshold: every clip filtered), so trained weights are
            # required, and a checkpoint that does not load raises
            ocr.setup(require_weights=True)
            self._ocr = ocr
        # auto with no staged checkpoint: the heuristic

    @property
    def learned(self) -> bool:
        """The learned detector scores (after ``setup``)."""
        return self._ocr is not None

    def _pipeline(self) -> DevicePipeline:
        if self._pipe is None:
            self._pipe = DevicePipeline("text-filter", _text_likeness, device=self.device)
        return self._pipe

    def _score_learned(self, frames: np.ndarray) -> float:
        # a fixed 4-frame sample: one batch shape for every clip
        idx = np.linspace(0, len(frames) - 1, _LEARNED_FRAMES).astype(int)
        return self._ocr.text_coverage(frames[idx])

    def process_data(self, tasks: list[SplitPipeTask]) -> list[SplitPipeTask]:
        key = self.extraction.key()
        threshold = self.learned_threshold if self.learned else self.threshold
        # every heuristic score is dispatched before any is read back; one
        # drain returns them in submission order (learned scores are
        # synchronous)
        scores: dict[int, float] = {}
        submitted = []
        pipe = self._pipeline()
        for task in tasks:
            for clip in task.video.clips:
                frames = clip.extracted_frames.get(key)
                if frames is None or frames.shape[0] == 0:
                    continue
                try:
                    if self.learned:
                        scores[id(clip)] = self._score_learned(frames)
                    else:
                        padded, n = pad_batch(frames)
                        pipe.submit(padded, n)
                        submitted.append(clip)
                except Exception as e:
                    logger.warning("text scoring failed for %s: %s", clip.uuid, e)
                    clip.errors["artificial_text"] = str(e)
                    if pipe.pending == 0:
                        # the pipeline aborted: the scores in flight are
                        # gone; error those clips rather than misalign the
                        # drain
                        for lost in submitted:
                            lost.errors["artificial_text"] = f"in-flight score lost to abort: {e}"
                        submitted = []
        if submitted:
            try:
                for clip, score in zip(submitted, pipe.drain(), strict=True):
                    scores[id(clip)] = float(score)
            except Exception as e:
                logger.warning("text scoring drain failed: %s", e)
                for clip in submitted:
                    clip.errors["artificial_text"] = str(e)
        # threshold in the original clip order
        for task in tasks:
            kept = []
            for clip in task.video.clips:
                if id(clip) not in scores:
                    kept.append(clip)  # unscoreable or errored: keep
                    continue
                clip.artificial_text_score = scores[id(clip)]
                if self.score_only or clip.artificial_text_score < threshold:
                    kept.append(clip)
                else:
                    clip.filtered_by = "text"
                    task.video.filtered_clips.append(clip)
            task.video.clips = kept
        return tasks
