"""Shot-detection clip-extraction stage (port of
``cosmos_curate_tpu/pipelines/video/stages/shot_detection.py``).

Decodes each video at the detector's input size (27x48), predicts
per-frame transition probabilities with TransNetV2, turns them into scene
spans (exact per-frame PTS from the mp4 sample tables when their count
matches, else the probed fps) and emits the clips. A video that fails
records ``errors["shot_detection"]`` and moves on.
"""

from __future__ import annotations

import torch

from cosmos_curate_tpu_torch.core.model import ModelInterface
from cosmos_curate_tpu_torch.core.stage import Resources, Stage
from cosmos_curate_tpu_torch.data.model import SplitPipeTask
from cosmos_curate_tpu_torch.models.transnetv2 import INPUT_H, INPUT_W, TransNetV2
from cosmos_curate_tpu_torch.utils.logging import get_logger
from cosmos_curate_tpu_torch.video.decode import decode_frames, get_frame_timestamps
from cosmos_curate_tpu_torch.video.splitter import make_clips, scene_spans_from_predictions

logger = get_logger(__name__)


class TransNetV2ClipExtractionStage(Stage[SplitPipeTask, SplitPipeTask]):
    """``model``: a ``TransNetV2`` to serve, else one on ``device``
    ("cuda" unless the caller asks for the CPU)."""

    def __init__(
        self,
        *,
        threshold: float = 0.4,
        min_clip_len_s: float = 2.0,
        max_clip_len_s: float = 60.0,
        model: TransNetV2 | None = None,
        device: str | torch.device = "cuda",
    ) -> None:
        self.threshold = threshold
        self.min_clip_len_s = min_clip_len_s
        self.max_clip_len_s = max_clip_len_s
        self._model = model if model is not None else TransNetV2(device=device)

    @property
    def model(self) -> ModelInterface:
        return self._model

    @property
    def resources(self) -> Resources:
        # a stage on the CPU claims no card from the runner's budget
        return Resources(cpus=1.0, gpus=1.0 if self._model.device.type == "cuda" else 0.0)

    def process_data(self, tasks: list[SplitPipeTask]) -> list[SplitPipeTask]:
        for task in tasks:
            video = task.video
            if video.errors:
                continue
            src = video.raw_bytes if video.raw_bytes is not None else video.path
            try:
                frames = decode_frames(src, resize_hw=(INPUT_H, INPUT_W))
                if frames.shape[0] == 0:
                    video.errors["shot_detection"] = "no frames decoded"
                    continue
                probs = self._model.predict_transitions(frames)
                ts = get_frame_timestamps(src)
                spans = scene_spans_from_predictions(
                    probs,
                    fps=video.metadata.fps,
                    threshold=self.threshold,
                    min_scene_len_s=self.min_clip_len_s,
                    max_scene_len_s=self.max_clip_len_s,
                    timestamps_s=ts if len(ts) == len(probs) else None,
                )
                video.clips = make_clips(video.path, spans)
                video.num_total_clips = len(video.clips)
            except Exception as e:  # one bad video must not end the run
                logger.warning("shot detection failed for %s: %s", video.path, e)
                video.errors["shot_detection"] = str(e)
        return tasks
