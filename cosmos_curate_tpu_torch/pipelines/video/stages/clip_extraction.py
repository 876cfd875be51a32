"""Clip extraction, transcode, and re-chunking stages (port of
``cosmos_curate_tpu/pipelines/video/stages/clip_extraction.py``).

Turns a probed video into fixed-stride clip spans, re-encodes each span as
a standalone mp4, then re-chunks one big video task into tasks of at most
``chunk_size`` clips. A multicam session's secondary cameras take the
primary's spans, each clipped to its own duration, and the session stays
one task.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from dataclasses import replace

from cosmos_curate_tpu_torch.core.stage import Resources, Stage
from cosmos_curate_tpu_torch.data.model import SplitPipeTask, Video
from cosmos_curate_tpu_torch.utils.logging import get_logger
from cosmos_curate_tpu_torch.video.decode import get_frame_timestamps
from cosmos_curate_tpu_torch.video.encode import transcode_clips
from cosmos_curate_tpu_torch.video.splitter import fixed_stride_spans, make_clips

logger = get_logger(__name__)


class FixedStrideExtractorStage(Stage[SplitPipeTask, SplitPipeTask]):
    """Fixed-duration spans → Clips with deterministic uuid5 ids."""

    def __init__(self, *, clip_len_s: float = 10.0, min_clip_len_s: float = 2.0) -> None:
        self.clip_len_s = clip_len_s
        self.min_clip_len_s = min_clip_len_s

    @property
    def thread_safe(self) -> bool:
        return True

    def process_data(self, tasks: list[SplitPipeTask]) -> list[SplitPipeTask]:
        for task in tasks:
            video = task.video
            if video.errors:
                continue
            spans = fixed_stride_spans(
                video.metadata.duration_s, clip_len_s=self.clip_len_s, min_clip_len_s=self.min_clip_len_s
            )
            if not spans and video.metadata.duration_s > 0:
                logger.warning(
                    "%s (%.1fs) produced 0 clips: clip_len_s=%.1f with min_clip_len_s=%.1f filters everything",
                    video.path, video.metadata.duration_s, self.clip_len_s, self.min_clip_len_s,
                )
            video.clips = make_clips(video.path, spans)
            video.num_total_clips = len(video.clips)
            # multicam: the secondary cameras take the primary's spans
            # verbatim (time-aligned clips), clipped to each camera's own
            # duration
            for aux in task.aux_videos:
                if aux.errors:
                    continue
                aux_spans = [(a, min(b, aux.metadata.duration_s)) for a, b in spans if a < aux.metadata.duration_s]
                aux.clips = make_clips(aux.path, aux_spans)
                aux.num_total_clips = len(aux.clips)
        return tasks


class ClipTranscodingStage(Stage[SplitPipeTask, SplitPipeTask]):
    """Re-encode every clip span as a standalone mp4, then drop the source
    bytes and re-chunk into ``chunk_size``-clip tasks."""

    def __init__(self, *, num_threads: int = 4, chunk_size: int = 64) -> None:
        self.num_threads = num_threads
        self.chunk_size = chunk_size

    @property
    def resources(self) -> Resources:
        return Resources(cpus=float(self.num_threads))

    @property
    def thread_safe(self) -> bool:
        # each call owns its executor; the codec negotiation and the native
        # writer's one-time build run under their own locks
        return True

    def process_data(self, tasks: list[SplitPipeTask]) -> list[SplitPipeTask]:
        # one sequential decode pass per video (transcode_clips decodes each
        # source frame once, feeding all spans); the batch's videos (every
        # camera of every task) fan out over the thread pool
        with ThreadPoolExecutor(max_workers=self.num_threads) as pool:
            list(pool.map(self._transcode_video, [v for t in tasks for v in t.videos]))
        out: list[SplitPipeTask] = []
        for task in tasks:
            if task.is_multicam:
                # aligned secondary clip lists would make re-slicing
                # ambiguous: a multicam session stays one task
                task.video.num_clip_chunks = 1
                task.video.clip_chunk_index = 0
                out.append(task)
            else:
                out.extend(chunk_split_task(task, self.chunk_size))
        return out

    def _transcode_video(self, video: Video) -> None:
        if not video.clips:
            video.release_raw()
            return
        src = video.raw_bytes if video.raw_bytes is not None else video.path
        try:
            # the same PTS mapping the span producers used (exact on mp4)
            ts = get_frame_timestamps(src)
            results = transcode_clips(src, [c.span for c in video.clips], timestamps_s=ts if len(ts) else None)
            for clip, (data, codec) in zip(video.clips, results):
                if not data:
                    clip.errors["transcode"] = "empty output"
                    continue
                clip.encoded_data = data
                clip.encoding_codec = codec
        except Exception as e:  # recorded on the video's clips, never raised
            logger.warning("transcode failed for %s: %s", video.path, e)
            for clip in video.clips:
                if clip.encoded_data is None:
                    clip.errors["transcode"] = str(e)
        video.release_raw()


def chunk_split_task(task: SplitPipeTask, chunk_size: int) -> list[SplitPipeTask]:
    """Split one task's clip list into tasks of ≤ ``chunk_size`` clips; each
    carries a shallow video copy so payloads are disjoint and ``fraction``
    sums to 1 across chunks."""
    video = task.video
    if chunk_size <= 0 or len(video.clips) <= chunk_size:
        video.num_clip_chunks = 1
        video.clip_chunk_index = 0
        return [task]
    chunks = [video.clips[i : i + chunk_size] for i in range(0, len(video.clips), chunk_size)]
    out = []
    for i, clip_group in enumerate(chunks):
        v = Video(
            path=video.path,
            metadata=video.metadata,
            clips=clip_group,
            num_total_clips=video.num_total_clips,
            num_clip_chunks=len(chunks),
            clip_chunk_index=i,
            errors=dict(video.errors),
        )
        # fresh mutable fields: chunks must not alias each other's perf/stats
        out.append(replace(task, video=v, stage_perf=dict(task.stage_perf), stats=None))
    return out
