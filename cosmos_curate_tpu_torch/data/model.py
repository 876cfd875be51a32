"""The video-curation data model: the payload flowing through every stage
(port of ``cosmos_curate_tpu/data/model.py``, the fields the split's
stages read and write, multicam sessions' cameras among them).

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

_UUID_NAMESPACE = uuid.UUID("8c5aa64e-25f1-44f3-b9a2-3cfb0c1a75d1")


def deterministic_id(*parts: str) -> uuid.UUID:
    """Stable uuid5 chain over string parts, so re-runs produce identical
    clip ids and resume can dedupe."""
    u = _UUID_NAMESPACE
    for p in parts:
        u = uuid.uuid5(u, p)
    return u


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
    enhanced_caption: dict[str, str] = field(default_factory=dict)
    t5_embedding: np.ndarray | None = None  # float32 [tokens, dim] of the window's caption

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
    encoded_data: bytes | None = None  # transcoded mp4
    encoding_codec: str = ""
    # recorded by the writer before encoded_data is freed
    encoded_byte_size: int = 0
    encoded_sha256: str = ""
    encoded_url: str = ""
    # extraction-signature key -> uint8 [T, H, W, 3]
    extracted_frames: dict[str, np.ndarray] = field(default_factory=dict)
    # model name -> float32 embedding
    embeddings: dict[str, np.ndarray] = field(default_factory=dict)
    motion_score_global: float | None = None
    motion_score_per_patch_min: float | None = None
    windows: list[Window] = field(default_factory=list)
    webp_preview: bytes | None = None
    # object tracks: list of tracks, each a list of per-frame dicts
    # ({frame, x, y, w, h, score}); produced by the tracking stage
    tracks: list[list[dict]] = field(default_factory=list)
    event_captions: list[str] = field(default_factory=list)  # parallel to tracks
    annotated_mp4: bytes | None = None
    aesthetic_score: float | None = None
    artificial_text_score: float | None = None
    semantic_pass: bool | None = None
    filtered_by: str = ""  # which filter removed this clip ("" = kept)
    # incremental dedup: the indexed clip this one duplicates ("" = none)
    duplicate_of: str = ""
    errors: dict[str, str] = field(default_factory=dict)

    @property
    def duration_s(self) -> float:
        return self.span[1] - self.span[0]

    def release_frames(self) -> None:
        self.extracted_frames.clear()

    def get_major_size(self) -> int:
        return estimate_major_size(self)


@dataclass
class Video:
    """A source video being split."""

    path: str = ""
    # camera label for multicam sessions (the filename stem); empty for
    # single-camera inputs
    camera: str = ""
    raw_bytes: bytes | None = None
    metadata: VideoMetadata = field(default_factory=VideoMetadata)
    clips: list[Clip] = field(default_factory=list)
    filtered_clips: list[Clip] = field(default_factory=list)
    num_total_clips: int = 0
    num_clip_chunks: int = 1
    clip_chunk_index: int = 0
    errors: dict[str, str] = field(default_factory=dict)

    def release_raw(self) -> None:
        self.raw_bytes = None


@dataclass
class SplitPipeTask(PipelineTask):
    """Unit of work in the split-annotate pipeline: one video (or one chunk
    of its clips).

    Multi-camera sessions: ``video`` is the primary camera, which every
    single-camera stage (filters, embedding, captioning) works on as it is;
    the time-aligned secondary cameras ride in ``aux_videos`` and only the
    camera-aware stages (download, clip extraction, transcode, writer)
    handle them."""

    video: Video = field(default_factory=Video)
    # secondary cameras, their clips time-aligned with the primary's spans
    aux_videos: list[Video] = field(default_factory=list)
    # the session's name (its directory); empty for single-camera tasks
    session_id: str = ""
    stage_perf: dict[str, float] = field(default_factory=dict)
    stats: ClipStats | None = None

    @property
    def videos(self) -> list[Video]:
        """Every camera of the task, primary first."""
        return [self.video, *self.aux_videos]

    @property
    def is_multicam(self) -> bool:
        return bool(self.aux_videos)

    @property
    def weight(self) -> float:
        # weight by content duration (a long video counts for more), times
        # the cameras
        return max(1.0, self.video.metadata.duration_s / 60.0) * len(self.videos)

    @property
    def fraction(self) -> float:
        return 1.0 / max(1, self.video.num_clip_chunks)
