"""The video-curation data model: the payload flowing through every stage
(port of ``cosmos_curate_tpu/data/model.py``, the fields the embed stage
reads and writes; each later stage's port adds the fields it uses).

- decoded frames are numpy ``uint8 [T, H, W, 3]`` arrays keyed by a
  ``FrameExtractionSignature``, so a CPU prep stage extracts once and many
  device stages reuse them;
- embeddings are numpy ``float32``: device tensors never travel between
  stages, host arrays do;
- per-item errors are recorded on the object (``Clip.errors``), never
  thrown across the pipeline, so one bad video cannot kill a run.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from cosmos_curate_tpu_torch.core.tasks import PipelineTask


@dataclass(frozen=True)
class FrameExtractionSignature:
    """Key for cached frame extractions: policy + rate."""

    policy: str = "fps"  # "fps" | "all" | "first_middle_last"
    target_fps: float = 1.0

    def key(self) -> str:
        return f"{self.policy}-{self.target_fps:g}"


@dataclass
class Clip:
    """One shot-detected span of a source video and everything derived
    from it as it moves down the pipeline."""

    source_video: str = ""
    span: tuple[float, float] = (0.0, 0.0)  # seconds in source
    # extraction-signature key -> uint8 [T, H, W, 3]
    extracted_frames: dict[str, np.ndarray] = field(default_factory=dict)
    # model name -> float32 embedding
    embeddings: dict[str, np.ndarray] = field(default_factory=dict)
    errors: dict[str, str] = field(default_factory=dict)


@dataclass
class Video:
    """A source video being split."""

    path: str = ""
    clips: list[Clip] = field(default_factory=list)


@dataclass
class SplitPipeTask(PipelineTask):
    """Unit of work in the split-annotate pipeline: one video (or one chunk
    of its clips)."""

    video: Video = field(default_factory=Video)
