"""Preview stage: an animated WebP per clip (port of
``cosmos_curate_tpu/pipelines/video/stages/preview.py``).

Up to ``max_frames`` of the clip's extracted frames, evenly spaced, scaled
down to ``target_width`` and saved with PIL (imported when the stage
runs). A failed save is recorded in ``clip.errors["preview"]``; the run
goes on.
"""

from __future__ import annotations

import io

import numpy as np

from cosmos_curate_tpu_torch.core.stage import Resources, Stage
from cosmos_curate_tpu_torch.data.model import FrameExtractionSignature, SplitPipeTask
from cosmos_curate_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)


class PreviewStage(Stage[SplitPipeTask, SplitPipeTask]):
    def __init__(
        self,
        *,
        max_frames: int = 8,
        target_width: int = 320,
        fps: int = 4,
        extraction: FrameExtractionSignature = FrameExtractionSignature("fps", 2.0),
    ) -> None:
        self.max_frames = max_frames
        self.target_width = target_width
        self.fps = fps
        self.extraction = extraction

    @property
    def resources(self) -> Resources:
        return Resources(cpus=0.5)

    def process_data(self, tasks: list[SplitPipeTask]) -> list[SplitPipeTask]:
        from PIL import Image

        key = self.extraction.key()
        for task in tasks:
            for clip in task.video.clips:
                frames = clip.extracted_frames.get(key)
                if frames is None or frames.shape[0] == 0:
                    continue
                idx = np.linspace(0, frames.shape[0] - 1, min(self.max_frames, frames.shape[0]))
                images = []
                for i in idx.round().astype(int):
                    img = Image.fromarray(frames[i])
                    if img.width > self.target_width:
                        h = int(img.height * self.target_width / img.width)
                        img = img.resize((self.target_width, h))
                    images.append(img)
                buf = io.BytesIO()
                try:
                    images[0].save(
                        buf,
                        format="WEBP",
                        save_all=len(images) > 1,
                        append_images=images[1:],
                        duration=int(1000 / self.fps),
                        loop=0,
                    )
                    clip.webp_preview = buf.getvalue()
                except Exception as e:  # PIL without WebP raises KeyError; a preview never fails the run
                    logger.warning("preview failed for %s: %s", clip.uuid, e)
                    clip.errors["preview"] = str(e)
        return tasks
