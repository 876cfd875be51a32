"""Aesthetic filter stage: CLIP + MLP scoring, threshold filter (port of
``cosmos_curate_tpu/pipelines/video/stages/aesthetic_filter.py``).

All frames of all clips of a task are scored in one call (the CLIP tower
and the MLP head each dispatch through their ``DevicePipeline``). A clip's
frame scores reduce by ``min`` (strict) or ``mean``; the clip is kept when
the stage is ``score_only`` or its score is ``>= threshold``, else it gets
``filtered_by="aesthetic"`` and moves to ``video.filtered_clips``.
"""

from __future__ import annotations

import numpy as np
import torch

from cosmos_curate_tpu_torch.core.model import ModelInterface
from cosmos_curate_tpu_torch.core.stage import Resources, Stage
from cosmos_curate_tpu_torch.data.model import FrameExtractionSignature, SplitPipeTask
from cosmos_curate_tpu_torch.models.clip import CLIPAestheticScorer


class AestheticFilterStage(Stage[SplitPipeTask, SplitPipeTask]):
    """The scorer (CLIP ViT-L/14 and the aesthetic MLP) loads through the
    registry, on ``device`` ("cuda" unless the caller asks for the CPU)."""

    def __init__(
        self,
        *,
        threshold: float = 3.5,
        reduction: str = "min",  # min over frames (strict) or "mean"
        extraction: FrameExtractionSignature = FrameExtractionSignature("fps", 2.0),
        score_only: bool = False,
        device: str | torch.device = "cuda",
    ) -> None:
        self.threshold = threshold
        self.reduction = reduction
        self.extraction = extraction
        self.score_only = score_only
        self._scorer = CLIPAestheticScorer(device=device)

    @property
    def model(self) -> ModelInterface:
        return self._scorer

    @property
    def resources(self) -> Resources:
        # a stage on the CPU claims no card from the runner's budget
        return Resources(cpus=1.0, gpus=1.0 if self._scorer.device.type == "cuda" else 0.0)

    def process_data(self, tasks: list[SplitPipeTask]) -> list[SplitPipeTask]:
        key = self.extraction.key()
        for task in tasks:
            video = task.video
            spans: list[tuple[int, int]] = []
            stacks: list[np.ndarray] = []
            offset = 0
            for clip in video.clips:
                frames = clip.extracted_frames.get(key)
                n = 0 if frames is None else frames.shape[0]
                spans.append((offset, offset + n))
                if n:
                    stacks.append(frames)
                offset += n
            if offset == 0:
                continue
            scores = self._scorer.score_frames(np.concatenate(stacks))
            kept = []
            for clip, (a, b) in zip(video.clips, spans):
                if a == b:
                    kept.append(clip)
                    continue
                s = scores[a:b]
                clip.aesthetic_score = float(s.min() if self.reduction == "min" else s.mean())
                if self.score_only or clip.aesthetic_score >= self.threshold:
                    kept.append(clip)
                else:
                    clip.filtered_by = "aesthetic"
                    video.filtered_clips.append(clip)
            video.clips = kept
        return tasks
