"""Embedding stage: per-clip video embeddings on the GPU (port of
``cosmos_curate_tpu/pipelines/video/stages/embedding.py``).

Frame prep happens in the CPU frame-extraction stage; this stage fuses the
clips of several tasks into shape-grouped batches that the embedder
dispatches through its ``DevicePipeline`` (pow2 bucket micro-batches, each
stacked on the host while the previous one computes, copies overlapped
with compute, readback deferred to the drain).

Ported variants: ``video``, ``video-512`` and ``video-256``. The ``clip``
variant and the InternVideo2 variants raise ``NotImplementedError``.
"""

from __future__ import annotations

from typing import Any

import torch

from cosmos_curate_tpu_torch.core.model import ModelInterface
from cosmos_curate_tpu_torch.core.stage import Resources, Stage
from cosmos_curate_tpu_torch.data.model import FrameExtractionSignature, SplitPipeTask
from cosmos_curate_tpu_torch.models.embedder import VIDEO_EMBED_VARIANTS, VideoEmbedConfig, VideoEmbedder

# Tasks fused per device dispatch
EMBED_STAGE_TASK_BATCH = 8

# variants of the JAX stage that are not ported yet -> their ROADMAP item
_NOT_PORTED = {
    "clip": "ROADMAP queue A item 5: the rest of the embed leg (models/clip.py)",
    "iv2": "ROADMAP queue A item 5: the rest of the embed leg (models/internvideo2.py)",
    "iv2-tiny-test": "ROADMAP queue A item 5: the rest of the embed leg (models/internvideo2.py)",
}


class ClipEmbeddingStage(Stage[SplitPipeTask, SplitPipeTask]):
    """variant="video" (or "video-512" / "video-256"): temporal-transformer
    video embedding of every clip's extracted frames, on ``device`` ("cuda"
    unless the caller asks for the CPU)."""

    def __init__(
        self,
        *,
        variant: str = "video",
        video_cfg: VideoEmbedConfig | None = None,
        extraction: FrameExtractionSignature = FrameExtractionSignature("fps", 2.0),
        params: dict[str, Any] | None = None,
        device: str | torch.device = "cuda",
    ) -> None:
        if variant in _NOT_PORTED:
            raise NotImplementedError(f"embedding variant {variant!r} is not ported yet ({_NOT_PORTED[variant]})")
        if variant not in VIDEO_EMBED_VARIANTS:
            known = [*VIDEO_EMBED_VARIANTS, *_NOT_PORTED]
            raise ValueError(f"unknown embedding variant {variant!r}; have {known}")
        self.variant = "video"
        self.extraction = extraction
        cfg, model_id = VIDEO_EMBED_VARIANTS[variant]
        if video_cfg is not None:
            cfg, model_id = video_cfg, None
        self._model = VideoEmbedder(cfg, model_id=model_id, params=params, device=device)

    @property
    def model(self) -> ModelInterface:
        return self._model

    @property
    def resources(self) -> Resources:
        # a stage on the CPU claims no card from the runner's budget
        return Resources(cpus=1.0, gpus=1.0 if self._model.device.type == "cuda" else 0.0)

    @property
    def model_name(self) -> str:
        return self._model.model_id_names[0]

    @property
    def batch_size(self) -> int:
        # several tasks per call: their clips fuse into per-shape device
        # batches, so the card sees e.g. 32 clips instead of 4 per dispatch
        return EMBED_STAGE_TASK_BATCH

    def process_data(self, tasks: list[SplitPipeTask]) -> list[SplitPipeTask]:
        self._embed_video_batch([t.video for t in tasks], self.extraction.key())
        return tasks

    def _embed_video_batch(self, videos, key: str) -> None:
        """encode_clips over every clip of every task in the batch, grouped
        by frame shape (a mixed-resolution corpus embeds per group)."""
        model: VideoEmbedder = self._model
        groups: dict[tuple, tuple[list, list]] = {}
        for video in videos:
            for clip in video.clips:
                frames = clip.extracted_frames.get(key)
                if frames is None or frames.shape[0] == 0:
                    continue
                idx = model.sample_frame_indices(frames.shape[0])
                batch, targets = groups.setdefault(frames.shape[1:], ([], []))
                # the pipeline stacks the clips per micro-batch; a clip that
                # already has the sampled frame count goes in uncopied
                batch.append(frames if len(idx) == frames.shape[0] else frames[idx])
                targets.append(clip)
        for batch, targets in groups.values():
            embs = model.encode_clips(batch)
            for clip, emb in zip(targets, embs):
                clip.embeddings[self.model_name] = emb
