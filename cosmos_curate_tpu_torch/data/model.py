"""The video-curation data model: the payload flowing through every stage
(port of ``cosmos_curate_tpu/data/model.py``, the fields the embed and
caption stages read and write; each later stage's port adds the fields it
uses).

- decoded frames are numpy ``uint8 [T, H, W, 3]`` arrays keyed by a
  ``FrameExtractionSignature``, so a CPU prep stage extracts once and many
  device stages reuse them;
- embeddings are numpy ``float32`` and captions are strings: device
  tensors never travel between stages, host values do;
- per-item errors are recorded on the object (``Clip.errors``), never
  thrown across the pipeline, so one bad video cannot kill a run.
"""

from __future__ import annotations

import uuid
from dataclasses import dataclass, field

import numpy as np

from cosmos_curate_tpu_torch.core.tasks import PipelineTask, estimate_major_size


@dataclass(frozen=True)
class FrameExtractionSignature:
    """Key for cached frame extractions: policy + rate."""

    policy: str = "fps"  # "fps" | "all" | "first_middle_last"
    target_fps: float = 1.0

    def key(self) -> str:
        return f"{self.policy}-{self.target_fps:g}"


@dataclass
class VideoMetadata:
    """Probe results for a source video."""

    width: int = 0
    height: int = 0
    fps: float = 0.0
    num_frames: int = 0
    duration_s: float = 0.0
    codec: str = ""
    pixel_format: str = ""
    bitrate_kbps: float = 0.0
    size_bytes: int = 0

    @property
    def is_valid(self) -> bool:
        return self.width > 0 and self.height > 0 and self.num_frames > 0


@dataclass
class Window:
    """A contiguous frame window of a clip, the captioning unit (256-frame
    windows by default)."""

    start_frame: int = 0
    end_frame: int = 0
    frames: np.ndarray | None = None  # uint8 [T, H, W, 3]
    # sampling rate of `frames` in source-time fps (temporal m-rope scaling)
    frame_fps: float | None = None
    caption: dict[str, str] = field(default_factory=dict)  # prompt_variant -> text

    @property
    def num_frames(self) -> int:
        return self.end_frame - self.start_frame


@dataclass
class ClipStats:
    """Aggregated accounting over clips, merged into the run summary."""

    num_clips: int = 0
    num_filtered_by_motion: int = 0
    num_filtered_by_aesthetic: int = 0
    num_filtered_by_text: int = 0
    num_filtered_by_semantic: int = 0
    num_filtered_by_dedup: int = 0
    num_transcoded: int = 0
    num_with_embeddings: int = 0
    num_with_captions: int = 0
    num_with_webp: int = 0
    total_clip_duration_s: float = 0.0
    max_clip_duration_s: float = 0.0

    def combine(self, other: ClipStats) -> None:
        self.num_clips += other.num_clips
        self.num_filtered_by_motion += other.num_filtered_by_motion
        self.num_filtered_by_aesthetic += other.num_filtered_by_aesthetic
        self.num_filtered_by_text += other.num_filtered_by_text
        self.num_filtered_by_semantic += other.num_filtered_by_semantic
        self.num_filtered_by_dedup += other.num_filtered_by_dedup
        self.num_transcoded += other.num_transcoded
        self.num_with_embeddings += other.num_with_embeddings
        self.num_with_captions += other.num_with_captions
        self.num_with_webp += other.num_with_webp
        self.total_clip_duration_s += other.total_clip_duration_s
        self.max_clip_duration_s = max(self.max_clip_duration_s, other.max_clip_duration_s)


@dataclass
class Clip:
    """One shot-detected span of a source video and everything derived
    from it as it moves down the pipeline."""

    uuid: uuid.UUID = field(default_factory=uuid.uuid4)
    source_video: str = ""
    span: tuple[float, float] = (0.0, 0.0)  # seconds in source
    # extraction-signature key -> uint8 [T, H, W, 3]
    extracted_frames: dict[str, np.ndarray] = field(default_factory=dict)
    # model name -> float32 embedding
    embeddings: dict[str, np.ndarray] = field(default_factory=dict)
    windows: list[Window] = field(default_factory=list)
    errors: dict[str, str] = field(default_factory=dict)

    @property
    def duration_s(self) -> float:
        return self.span[1] - self.span[0]

    def get_major_size(self) -> int:
        return estimate_major_size(self)


@dataclass
class Video:
    """A source video being split."""

    path: str = ""
    metadata: VideoMetadata = field(default_factory=VideoMetadata)
    clips: list[Clip] = field(default_factory=list)
    num_clip_chunks: int = 1


@dataclass
class SplitPipeTask(PipelineTask):
    """Unit of work in the split-annotate pipeline: one video (or one chunk
    of its clips)."""

    video: Video = field(default_factory=Video)
    stage_perf: dict[str, float] = field(default_factory=dict)
    stats: ClipStats | None = None

    @property
    def weight(self) -> float:
        # weight by content duration: a long video counts for more
        return max(1.0, self.video.metadata.duration_s / 60.0)

    @property
    def fraction(self) -> float:
        return 1.0 / max(1, self.video.num_clip_chunks)
