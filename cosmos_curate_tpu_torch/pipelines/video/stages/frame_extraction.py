"""Clip frame-extraction stage: the CPU prep that feeds every device stage
(port of ``cosmos_curate_tpu/pipelines/video/stages/frame_extraction.py``).

Decodes each clip's mp4 once and caches frames for every
``FrameExtractionSignature``, so downstream device stages (embedding,
caption prep) reuse them. Clips fan out over a thread pool of the stage's
declared ``num_cpus`` (OpenCV's FFmpeg decode releases the GIL), and all
signatures of one clip come from a single decode pass
(``video.decode.extract_frames_multi``).
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor

from cosmos_curate_tpu_torch.core.stage import Resources, Stage, WorkerMetadata
from cosmos_curate_tpu_torch.data.model import FrameExtractionSignature, SplitPipeTask
from cosmos_curate_tpu_torch.utils.logging import get_logger
from cosmos_curate_tpu_torch.video.decode import extract_frames_multi

logger = get_logger(__name__)


class ClipFrameExtractionStage(Stage[SplitPipeTask, SplitPipeTask]):
    def __init__(
        self,
        *,
        signatures: tuple[FrameExtractionSignature, ...] = (FrameExtractionSignature("fps", 2.0),),
        resize_hw: tuple[int, int] | None = None,
        num_cpus: float = 3.0,
    ) -> None:
        self.signatures = signatures
        self.resize_hw = resize_hw
        self.num_cpus = num_cpus
        # created in setup; process_data runs serially without it
        self._pool: ThreadPoolExecutor | None = None

    @property
    def resources(self) -> Resources:
        return Resources(cpus=self.num_cpus)

    @property
    def thread_safe(self) -> bool:
        # the decode pool, built once in setup, takes submissions from any
        # thread; destroy runs after the last worker thread has exited
        return True

    def setup(self, worker: WorkerMetadata) -> None:
        super().setup(worker)
        self._pool = ThreadPoolExecutor(max_workers=max(1, int(self.num_cpus)), thread_name_prefix="frame-extract")

    def process_data(self, tasks: list[SplitPipeTask]) -> list[SplitPipeTask]:
        clips = [clip for task in tasks for clip in task.video.clips if clip.encoded_data is not None]
        pool = self._pool
        if pool is None or len(clips) <= 1:
            for clip in clips:
                self._extract_clip(clip)
        else:
            # list() propagates the first worker exception, if any
            list(pool.map(self._extract_clip, clips))
        return tasks

    def _extract_clip(self, clip) -> None:
        try:
            by_key = extract_frames_multi(clip.encoded_data, self.signatures, resize_hw=self.resize_hw)
        except Exception as e:  # one clip's failure is recorded on it, never raised
            logger.warning("frame extraction failed for %s: %s", clip.uuid, e)
            for sig in self.signatures:
                clip.errors[f"frames-{sig.key()}"] = str(e)
            return
        for sig in self.signatures:
            frames = by_key[sig.key()]
            if frames.size == 0:
                clip.errors[f"frames-{sig.key()}"] = "no frames decoded"
            else:
                clip.extracted_frames[sig.key()] = frames

    def destroy(self) -> None:
        if self._pool is not None:
            self._pool.shutdown(wait=False)
            self._pool = None
