"""Embedding stage: per-clip embeddings on the GPU (port of
``cosmos_curate_tpu/pipelines/video/stages/embedding.py``).

Frame prep happens in the CPU frame-extraction stage; this stage fuses the
clips of several tasks into shape-grouped batches that the model
dispatches through its ``DevicePipeline`` (pow2 bucket micro-batches, each
stacked on the host while the previous one computes, copies overlapped
with compute, readback deferred to the drain).

Variants: ``video`` / ``video-512`` / ``video-256`` (temporal-transformer
video embedding), ``iv2`` / ``iv2-tiny-test`` (InternVideo2, the same
video-batch path; ``iv2`` requires trained weights) and ``clip`` (the mean
of each clip's normalised CLIP frame embeddings).
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from cosmos_curate_tpu_torch.core.model import ModelInterface
from cosmos_curate_tpu_torch.core.stage import Resources, Stage
from cosmos_curate_tpu_torch.data.model import FrameExtractionSignature, SplitPipeTask
from cosmos_curate_tpu_torch.models.clip import CLIPImageEmbeddings
from cosmos_curate_tpu_torch.models.embedder import VIDEO_EMBED_VARIANTS, VideoEmbedConfig, VideoEmbedder
from cosmos_curate_tpu_torch.models.internvideo2 import IV2_VARIANTS, IV2Embedder

# Tasks fused per device dispatch
EMBED_STAGE_TASK_BATCH = 8


class ClipEmbeddingStage(Stage[SplitPipeTask, SplitPipeTask]):
    """Per-clip embeddings of every clip's extracted frames, on ``device``
    ("cuda" unless the caller asks for the CPU). ``params``: a ``state_dict``
    of the variant's model, else its staged checkpoint (``clip``, ``iv2``)
    or its seeded init; ``iv2`` without either raises at setup."""

    def __init__(
        self,
        *,
        variant: str = "video",
        video_cfg: VideoEmbedConfig | None = None,
        extraction: FrameExtractionSignature = FrameExtractionSignature("fps", 2.0),
        params: dict[str, Any] | None = None,
        device: str | torch.device = "cuda",
    ) -> None:
        known = ["clip", *VIDEO_EMBED_VARIANTS, *IV2_VARIANTS]
        if variant not in known:
            raise ValueError(f"unknown embedding variant {variant!r}; have {known}")
        self.variant = "clip" if variant == "clip" else "video"
        self.extraction = extraction
        self._model: VideoEmbedder | IV2Embedder | CLIPImageEmbeddings
        if variant == "clip":
            self._model = CLIPImageEmbeddings("clip-vit-b16-tpu", params=params, device=device)
        elif variant in IV2_VARIANTS:
            cfg, model_id, require = IV2_VARIANTS[variant]
            self._model = IV2Embedder(cfg, model_id=model_id, require_weights=require, params=params, device=device)
        else:
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
        videos = [t.video for t in tasks]
        if self.variant == "video":
            self._embed_video_batch(videos, self.extraction.key())
        else:
            self._embed_clip_mean_batch(videos, self.extraction.key())
        return tasks

    def _embed_video_batch(self, videos, key: str) -> None:
        """encode_clips over every clip of every task in the batch, grouped
        by frame shape (a mixed-resolution corpus embeds per group)."""
        model = self._model
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

    def _embed_clip_mean_batch(self, videos, key: str) -> None:
        """Mean of each clip's normalised CLIP frame embeddings (fp32 on the
        host), divided by its norm + 1e-8; every frame of every clip of the
        batch goes to the device at once, grouped by frame shape."""
        model: CLIPImageEmbeddings = self._model
        groups: dict[tuple, tuple[list, list]] = {}
        for video in videos:
            for clip in video.clips:
                frames = clip.extracted_frames.get(key)
                if frames is None or frames.shape[0] == 0:
                    continue
                stacks, targets = groups.setdefault(frames.shape[1:], ([], []))
                stacks.append(frames)
                targets.append(clip)
        for stacks, targets in groups.values():
            embs = model.encode_frames(np.concatenate(stacks))
            offset = 0
            for clip, frames in zip(targets, stacks):
                n = frames.shape[0]
                mean = embs[offset : offset + n].mean(axis=0)
                mean /= np.linalg.norm(mean) + 1e-8
                clip.embeddings[self.model_name] = mean.astype(np.float32)
                offset += n
