"""Video download + probe stage (port of
``cosmos_curate_tpu/pipelines/video/stages/download.py``).

Fetches each video's raw bytes from storage and probes its metadata (every
camera of a multicam session); per-item errors are recorded on the video instead of raised, so one bad
input cannot kill a run.
"""

from __future__ import annotations

from cosmos_curate_tpu_torch.core.stage import Resources, Stage
from cosmos_curate_tpu_torch.data.model import SplitPipeTask
from cosmos_curate_tpu_torch.storage.client import read_bytes
from cosmos_curate_tpu_torch.utils.logging import get_logger
from cosmos_curate_tpu_torch.video.decode import extract_video_metadata

logger = get_logger(__name__)


class VideoDownloadStage(Stage[SplitPipeTask, SplitPipeTask]):
    """IO stage: a fractional CPU claim."""

    @property
    def resources(self) -> Resources:
        return Resources(cpus=0.25)

    @property
    def thread_safe(self) -> bool:
        return True

    def process_data(self, tasks: list[SplitPipeTask]) -> list[SplitPipeTask]:
        for task in tasks:
            for video in task.videos:
                try:
                    video.raw_bytes = read_bytes(video.path)
                    video.metadata = extract_video_metadata(video.raw_bytes)
                    video.metadata.size_bytes = len(video.raw_bytes)
                    if not video.metadata.is_valid:
                        video.errors["download"] = "invalid or empty video stream"
                except Exception as e:  # contained: recorded on the video, never raised
                    logger.warning("failed to fetch %s: %s", video.path, e)
                    video.errors["download"] = str(e)
        return tasks
