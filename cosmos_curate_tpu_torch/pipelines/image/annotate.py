"""Image annotate pipeline: curation for still images (port of
``cosmos_curate_tpu/pipelines/image/annotate.py``).

load → embed (CLIP ViT-B/16) → [aesthetic filter] → [semantic filter] →
[classifier] → [caption, local engine or an OpenAI-compatible API] →
write, on the same ``Stage`` machinery as the video pipelines.

Every model stage runs on ``device`` ("cuda" unless the caller asks for
the CPU): the CLIP tower's attention on the flash kernel, the caption
family (``filters.py`` and :class:`ImageCaptionStage`) as owners of the
process-wide ``SharedCaptionEngine`` on the paged kernels. The reference's
``Resources(tpus=...)`` / ``entire_tpu_host`` claims are ``gpus`` /
``entire_gpu_host`` here, and only when the stage runs on the GPU.

Outputs under ``output_path``: ``metas/<id>.json`` for every image,
``images/<id><suffix>`` (the raw file) for every image kept without
errors, ``processed_images/<id>.json`` (the resume record) for every image
without errors, ``embeddings/clip/<uuid>.parquet`` (``image_id``,
``embedding``) per writer call and ``summary.json``; ``<id>`` is the first
24 hex digits of the path's sha256.
"""

from __future__ import annotations

import hashlib
import json
import os
import time
import uuid
from dataclasses import dataclass, field
from pathlib import PurePath

import numpy as np
import torch

from cosmos_curate_tpu_torch.core.model import ModelInterface, model_device
from cosmos_curate_tpu_torch.core.pipeline import PipelineConfig, run_pipeline
from cosmos_curate_tpu_torch.core.runner import RunnerInterface
from cosmos_curate_tpu_torch.core.stage import Resources, Stage
from cosmos_curate_tpu_torch.core.tasks import PipelineTask
from cosmos_curate_tpu_torch.models.clip import AestheticScorer, CLIPImageEmbeddings
from cosmos_curate_tpu_torch.models.prompts import get_caption_prompt
from cosmos_curate_tpu_torch.models.tokenizer import default_caption_tokenizer
from cosmos_curate_tpu_torch.models.vlm.engine import CaptionRequest, SamplingConfig
from cosmos_curate_tpu_torch.models.vlm.model import VLM_BASE, VLMConfig
from cosmos_curate_tpu_torch.pipelines.video.stages.captioning import _CaptionVLM, _owner_tag
from cosmos_curate_tpu_torch.storage.client import get_storage_client, read_bytes, write_bytes
from cosmos_curate_tpu_torch.storage.writers import write_json, write_parquet
from cosmos_curate_tpu_torch.utils.logging import get_logger
from cosmos_curate_tpu_torch.utils.summary import write_summary

logger = get_logger(__name__)

IMAGE_SUFFIXES = (".jpg", ".jpeg", ".png", ".webp", ".bmp")


@dataclass
class ImageTask(PipelineTask):
    path: str = ""
    raw_bytes: bytes | None = None
    pixels: np.ndarray | None = None  # uint8 [H, W, 3] RGB
    width: int = 0
    height: int = 0
    embedding: np.ndarray | None = None
    aesthetic_score: float | None = None
    caption: str = ""
    label: str = ""
    semantic_pass: bool | None = None
    filtered_by: str = ""
    errors: dict[str, str] = field(default_factory=dict)


def _on_gpu(device: torch.device) -> bool:
    return device.type == "cuda"


class ImageLoadStage(Stage[ImageTask, ImageTask]):
    """Reads and decodes each image (cv2 ``IMREAD_COLOR``: alpha dropped,
    gray and 16-bit files to 3-channel 8-bit, EXIF orientation applied) to
    RGB; a file that does not read or decode lands in ``errors["load"]``."""

    @property
    def resources(self) -> Resources:
        return Resources(cpus=0.25)

    def process_data(self, tasks: list[ImageTask]) -> list[ImageTask]:
        import cv2

        for t in tasks:
            try:
                t.raw_bytes = read_bytes(t.path)
                bgr = cv2.imdecode(np.frombuffer(t.raw_bytes, np.uint8), cv2.IMREAD_COLOR)
                if bgr is None:
                    t.errors["load"] = "undecodable image"
                    continue
                t.pixels = cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB)
                t.height, t.width = t.pixels.shape[:2]
            except Exception as e:
                t.errors["load"] = str(e)
        return tasks


class ImageEmbeddingStage(Stage[ImageTask, ImageTask]):
    """CLIP image embeddings: each still resized on the host (``INTER_AREA``
    to ``resize_hw``), then the tower on ``device``."""

    def __init__(
        self, *, clip_variant: str = "clip-vit-b16-tpu", resize_hw=(224, 224), device: str | torch.device = "cuda"
    ) -> None:
        self._model = CLIPImageEmbeddings(clip_variant, device=device)
        self.resize_hw = resize_hw

    @property
    def model(self) -> ModelInterface:
        return self._model

    @property
    def resources(self) -> Resources:
        return Resources(cpus=1.0, gpus=1.0 if _on_gpu(self._model.device) else 0.0)

    @property
    def batch_size(self) -> int:
        return 32

    def process_data(self, tasks: list[ImageTask]) -> list[ImageTask]:
        import cv2

        live = [t for t in tasks if t.pixels is not None]
        if live:
            # cv2 takes the size as (w, h)
            batch = np.stack(
                [cv2.resize(t.pixels, self.resize_hw[::-1], interpolation=cv2.INTER_AREA) for t in live]
            )
            embs = self._model.encode_frames(batch)
            for t, e in zip(live, embs):
                t.embedding = e
        return tasks


class ImageVideoEmbeddingStage(Stage[ImageTask, ImageTask]):
    """Embeds stills through the temporal video embedder by repeating the
    frame ``num_frames`` times, so clips and images share one embedding
    space for joint dedup and search."""

    def __init__(self, *, variant: str = "video", video_cfg=None, device: str | torch.device = "cuda") -> None:
        from cosmos_curate_tpu_torch.models.embedder import VIDEO_EMBED_VARIANTS, VideoEmbedder

        if video_cfg is not None:
            self._model = VideoEmbedder(video_cfg, device=device)
        else:
            if variant not in VIDEO_EMBED_VARIANTS:
                raise ValueError(f"unknown embedder variant {variant!r}; have {sorted(VIDEO_EMBED_VARIANTS)}")
            cfg, model_id = VIDEO_EMBED_VARIANTS[variant]
            self._model = VideoEmbedder(cfg, model_id=model_id, device=device)

    @property
    def model(self) -> ModelInterface:
        return self._model

    @property
    def resources(self) -> Resources:
        return Resources(cpus=1.0, gpus=1.0 if _on_gpu(self._model.device) else 0.0)

    @property
    def batch_size(self) -> int:
        return 16

    def process_data(self, tasks: list[ImageTask]) -> list[ImageTask]:
        import cv2

        live = [t for t in tasks if t.pixels is not None]
        if not live:
            return tasks
        n_frames = self._model.cfg.num_frames
        s = self._model.cfg.vit.image_size
        frames = np.stack(
            [
                np.repeat(cv2.resize(t.pixels, (s, s), interpolation=cv2.INTER_AREA)[None], n_frames, axis=0)
                for t in live
            ]
        )
        embs = self._model.encode_clips(frames)
        for t, e in zip(live, embs):
            t.embedding = e
        return tasks


class ImageAestheticFilterStage(Stage[ImageTask, ImageTask]):
    """Scores each embedding with the aesthetic head; below ``threshold``
    the image is filtered unless ``score_only``."""

    def __init__(
        self,
        *,
        threshold: float = 3.5,
        score_only: bool = False,
        embedding_dim: int = 512,
        device: str | torch.device = "cuda",
    ) -> None:
        self.threshold = threshold
        self.score_only = score_only
        self._model = AestheticScorer(embedding_dim, device=device)

    @property
    def model(self) -> ModelInterface:
        return self._model

    @property
    def resources(self) -> Resources:
        return Resources(cpus=0.5, gpus=0.25 if _on_gpu(self._model.device) else 0.0)

    @property
    def batch_size(self) -> int:
        return 32

    def process_data(self, tasks: list[ImageTask]) -> list[ImageTask]:
        live = [t for t in tasks if t.embedding is not None]
        if live:
            scores = self._model.score(np.stack([t.embedding for t in live]))
            for t, s in zip(live, scores):
                t.aesthetic_score = float(s)
                if not self.score_only and t.aesthetic_score < self.threshold:
                    t.filtered_by = "aesthetic"
        return tasks


class CaptionFamilyStage(Stage[ImageTask, ImageTask]):
    """Shared frame of the image stages that ask the caption engine one
    question per kept image (the full-resolution still as a one-frame
    request, ``request_id`` = the image's path): the stage is one owner of
    the process-wide ``SharedCaptionEngine`` (its own owner tag, as the
    video caption-family stages have), so its answers come back to it
    alone while other owners' requests ride in the same batch."""

    max_new_tokens: int

    def __init__(self, cfg: VLMConfig, max_batch: int, device: str | torch.device, owner: str) -> None:
        self._model = _CaptionVLM(cfg, max_batch, device=device)
        self.tokenizer = default_caption_tokenizer()
        self.owner = _owner_tag(owner)

    @property
    def model(self) -> ModelInterface:
        return self._model

    @property
    def resources(self) -> Resources:
        return Resources(cpus=1.0, entire_gpu_host=_on_gpu(self._model.device))

    def ask(self, tasks: list[ImageTask], prompt: str) -> list[tuple[ImageTask, str]]:
        """(task, answer) for every task with pixels that is not filtered."""
        engine = self._model.engine
        if engine is None:
            raise RuntimeError(f"{self.name}.process_data before setup()")
        targets: dict[str, ImageTask] = {}
        for t in tasks:
            if t.pixels is None or t.filtered_by:
                continue
            targets[t.path] = t
            engine.add_request(
                CaptionRequest(
                    request_id=t.path,
                    prompt_ids=self.tokenizer.encode(prompt),
                    frames=t.pixels[None],
                    sampling=SamplingConfig(max_new_tokens=self.max_new_tokens),
                    owner=self.owner,
                )
            )
        if not targets:
            return []
        return [(targets[r.request_id], r.text) for r in engine.run_until_complete(owner=self.owner)
                if r.request_id in targets]


class ImageCaptionStage(CaptionFamilyStage):
    def __init__(
        self,
        *,
        prompt_variant: str = "short",
        cfg: VLMConfig = VLM_BASE,
        max_batch: int = 8,
        max_new_tokens: int = 64,
        device: str | torch.device = "cuda",
    ) -> None:
        super().__init__(cfg, max_batch, device, f"image-caption-{prompt_variant}")
        self.prompt_text = get_caption_prompt(prompt_variant)
        self.max_new_tokens = max_new_tokens

    def process_data(self, tasks: list[ImageTask]) -> list[ImageTask]:
        for t, text in self.ask(tasks, self.prompt_text):
            t.caption = text
        return tasks


class ImageWriterStage(Stage[ImageTask, ImageTask]):
    def __init__(self, output_path: str) -> None:
        self.output_path = output_path.rstrip("/")

    @property
    def resources(self) -> Resources:
        return Resources(cpus=0.5)

    def process_data(self, tasks: list[ImageTask]) -> list[ImageTask]:
        rows = []
        for t in tasks:
            iid = hashlib.sha256(t.path.encode()).hexdigest()[:24]
            meta = {
                "id": iid,
                "path": t.path,
                "width": t.width,
                "height": t.height,
                "aesthetic_score": t.aesthetic_score,
                "caption": t.caption,
                "label": t.label,
                "semantic_pass": t.semantic_pass,
                "filtered_by": t.filtered_by,
                "errors": t.errors,
            }
            write_json(f"{self.output_path}/metas/{iid}.json", meta)
            if not t.filtered_by and t.raw_bytes and not t.errors:
                write_bytes(f"{self.output_path}/images/{iid}{_suffix(t.path)}", t.raw_bytes)
            if t.embedding is not None:
                rows.append((iid, t.embedding))
            if not t.errors:
                # the resume record certifies completed processing; errored
                # images (possibly transient IO) are retried on a re-run
                write_json(f"{self.output_path}/processed_images/{iid}.json", {"path": t.path})
            t.raw_bytes = None
            t.pixels = None
        if rows:
            write_parquet(
                f"{self.output_path}/embeddings/clip/{uuid.uuid4().hex[:12]}.parquet",
                {
                    "image_id": [r[0] for r in rows],
                    "embedding": [r[1].astype(np.float32).tolist() for r in rows],
                },
            )
        return tasks


def _suffix(path: str) -> str:
    return PurePath(path).suffix.lower() or ".jpg"


@dataclass
class ImagePipelineArgs:
    """The reference's fields and defaults (a test pins them), plus
    ``device``."""

    input_path: str = ""
    output_path: str = ""
    limit: int = 0
    aesthetic_threshold: float | None = None
    captioning: bool = False
    caption_prompt_variant: str = "short"
    # VLM semantic filter: disable | score-only | enable
    semantic_filter: str = "disable"
    semantic_filter_prompt: str | None = None
    # VLM classifier; empty = off
    classifier_labels: tuple[str, ...] = ()
    # OpenAI-compatible API captioning instead of the local engine
    api_caption_url: str = ""
    api_caption_model: str = "default"
    api_caption_key: str = ""  # falls back to $CURATE_API_KEY
    # where the model stages run: "cuda" unless the caller asks for "cpu"
    device: str = "cuda"


def discover_image_tasks(input_path: str, output_path: str | None = None, *, limit: int = 0) -> list[ImageTask]:
    """Every image under ``input_path`` without a resume record under
    ``<output_path>/processed_images``, up to ``limit``."""
    client = get_storage_client(input_path)
    done: set[str] = set()
    if output_path:
        prefix = f"{output_path.rstrip('/')}/processed_images"
        for info in client.list_files(prefix, suffixes=(".json",)):
            try:
                done.add(json.loads(read_bytes(info.path))["path"])
            except Exception:
                pass
    tasks = []
    for info in client.list_files(input_path, suffixes=IMAGE_SUFFIXES):
        if info.path in done:
            continue
        tasks.append(ImageTask(path=info.path))
        if limit and len(tasks) >= limit:
            break
    logger.info("discovered %d images under %s (%d done)", len(tasks), input_path, len(done))
    return tasks


def assemble_stages(args: ImagePipelineArgs, extra_stages: list[Stage] | None = None) -> list[Stage]:
    device = model_device(args.device, "the image pipeline")
    stages: list[Stage] = [ImageLoadStage(), ImageEmbeddingStage(device=device)]
    if args.aesthetic_threshold is not None:
        stages.append(ImageAestheticFilterStage(threshold=args.aesthetic_threshold, device=device))
    if args.semantic_filter != "disable":
        from cosmos_curate_tpu_torch.pipelines.image.filters import ImageSemanticFilterStage

        stages.append(
            ImageSemanticFilterStage(
                user_prompt=args.semantic_filter_prompt,
                score_only=args.semantic_filter == "score-only",
                device=device,
            )
        )
    if args.classifier_labels:
        from cosmos_curate_tpu_torch.pipelines.image.filters import ImageClassifierStage

        stages.append(ImageClassifierStage(labels=args.classifier_labels, device=device))
    if args.api_caption_url:
        from cosmos_curate_tpu_torch.pipelines.image.api_caption import ImageApiCaptionStage

        stages.append(
            ImageApiCaptionStage(
                base_url=args.api_caption_url,
                model=args.api_caption_model,
                api_key=args.api_caption_key or os.environ.get("CURATE_API_KEY", ""),
            )
        )
    elif args.captioning:
        stages.append(ImageCaptionStage(prompt_variant=args.caption_prompt_variant, device=device))
    stages.extend(extra_stages or [])
    stages.append(ImageWriterStage(args.output_path))
    return stages


def run_image_annotate(
    args: ImagePipelineArgs,
    *,
    runner: RunnerInterface | None = None,
    config: PipelineConfig | None = None,
    extra_stages: list[Stage] | None = None,
) -> dict:
    """Discover (with resume), run, write ``summary.json``; returns the
    summary."""
    t0 = time.monotonic()
    tasks = discover_image_tasks(args.input_path, args.output_path, limit=args.limit)
    stages = assemble_stages(args, extra_stages)
    out = run_pipeline(tasks, stages, config=config, runner=runner) or []
    elapsed = time.monotonic() - t0
    summary = {
        "num_images": len(out),
        "num_embedded": sum(1 for t in out if t.embedding is not None),
        "num_filtered": sum(1 for t in out if t.filtered_by),
        "num_captioned": sum(1 for t in out if t.caption),
        "num_errors": sum(len(t.errors) for t in out),
        "pipeline_run_time_s": elapsed,
    }
    write_summary(f"{args.output_path.rstrip('/')}/summary.json", summary)
    logger.info("image annotate done: %s", summary)
    return summary
