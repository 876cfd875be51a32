"""The split-annotate pipeline: assembly + entry point (port of
``cosmos_curate_tpu/pipelines/video/split.py``).

download → clips (fixed stride, or TransNetV2 shot detection) → transcode →
frame extraction → [aesthetic filter] → [artificial-text filter] →
[semantic filter] → [embed] → [caption prep → caption] → [enhanced
captions] → [T5 caption embeddings] → [previews] → writer, through the
port's own ``run_pipeline``. The model
stages run on ``SplitPipelineArgs.device`` ("cuda" unless the caller asks
for the CPU).

``assemble_stages`` raises ``NotImplementedError``, naming the ROADMAP item,
for every option whose stage is not ported yet. ``run_split`` runs the
accelerator health gate first when ``CURATE_HEALTH_GATE`` is ``on`` or
``strict`` (utils/health.py: both abort on an unhealthy card; the port never
moves a run to the CPU by itself, and a ``device="cpu"`` run has no card to
gate). It leaves out what else the reference wraps around the run: live
status, tracing and the observability wrappers (item 14), multi-node
initialisation and work stealing (item 15) and corpus-index consolidation
(item 12).
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass, field
from typing import Callable

import torch

from cosmos_curate_tpu_torch.core.pipeline import PipelineConfig, run_pipeline
from cosmos_curate_tpu_torch.core.runner import RunnerInterface, default_runner
from cosmos_curate_tpu_torch.core.stage import Stage, StageSpec
from cosmos_curate_tpu_torch.data.model import FrameExtractionSignature
from cosmos_curate_tpu_torch.pipelines.video.input_discovery import discover_split_tasks
from cosmos_curate_tpu_torch.pipelines.video.stages.aesthetic_filter import AestheticFilterStage
from cosmos_curate_tpu_torch.pipelines.video.stages.artificial_text_filter import ArtificialTextFilterStage
from cosmos_curate_tpu_torch.pipelines.video.stages.caption_embedding import CaptionEmbeddingStage
from cosmos_curate_tpu_torch.pipelines.video.stages.captioning import CaptionPrepStage, CaptionStage
from cosmos_curate_tpu_torch.pipelines.video.stages.clip_extraction import (
    ClipTranscodingStage,
    FixedStrideExtractorStage,
)
from cosmos_curate_tpu_torch.pipelines.video.stages.download import VideoDownloadStage
from cosmos_curate_tpu_torch.pipelines.video.stages.embedding import ClipEmbeddingStage
from cosmos_curate_tpu_torch.pipelines.video.stages.enhance_caption import EnhanceCaptionStage
from cosmos_curate_tpu_torch.pipelines.video.stages.frame_extraction import ClipFrameExtractionStage
from cosmos_curate_tpu_torch.pipelines.video.stages.preview import PreviewStage
from cosmos_curate_tpu_torch.pipelines.video.stages.semantic_filter import SemanticFilterStage
from cosmos_curate_tpu_torch.pipelines.video.stages.shot_detection import TransNetV2ClipExtractionStage
from cosmos_curate_tpu_torch.pipelines.video.stages.writer import INDEX_NOT_PORTED, ClipWriterStage
from cosmos_curate_tpu_torch.utils.health import accelerator_health_gate
from cosmos_curate_tpu_torch.utils.logging import get_logger
from cosmos_curate_tpu_torch.utils.summary import build_summary, write_summary

logger = get_logger(__name__)

HEALTH_GATE_ENV = "CURATE_HEALTH_GATE"


@dataclass
class SplitPipelineArgs:
    """The reference's fields and defaults (a test pins them), plus
    ``device``."""

    input_path: str = ""
    output_path: str = ""
    limit: int = 0
    # clip extraction
    splitting_algorithm: str = "fixed-stride"  # or "transnetv2"
    fixed_stride_len_s: float = 10.0
    min_clip_len_s: float = 2.0
    transnetv2_threshold: float = 0.4
    max_clip_len_s: float = 60.0
    # transcode
    transcode_cpus: int = 4
    clip_chunk_size: int = 64
    # super-resolution after transcode
    sr: bool = False
    sr_variant: str = "diffusion"  # diffusion | srnet
    sr_window_frames: int = 128
    sr_overlap_frames: int = 64
    sr_sp_size: int = 1
    # frame extraction (uniform size so model stages can stack across clips)
    extract_fps: tuple[float, ...] = (2.0,)
    extract_resize_hw: tuple[int, int] = (224, 224)
    # model stages
    motion_filter: str = "disable"  # disable | score-only | enable
    motion_backend: str = "auto"
    motion_global_threshold: float = 0.004
    motion_patch_threshold: float = 0.0
    motion_mv_global_threshold: float = 0.001
    motion_mv_patch_threshold: float = 0.0
    aesthetic_threshold: float | None = None
    text_filter: str = "disable"  # disable | score-only | enable
    text_filter_threshold: float = 0.5
    semantic_filter: str = "disable"  # disable | score-only | enable
    semantic_filter_prompt: str = "default"
    embedding_model: str = ""  # "" | "clip" | "video" (and its widths) | "iv2"
    # persistent corpus index and incremental dedup
    corpus_index: bool = False
    index_path: str = ""
    incremental_dedup: str = "disable"
    dedup_eps: float = 0.07
    dedup_nprobe: int = 0
    # multicam sessions
    multicam: bool = False
    primary_camera: str = ""
    captioning: bool = False
    caption_window_len: int = 256
    caption_prompt_variant: str = "default"
    caption_model: str = "base"  # a VLM_FLAVORS name: base | qwen2vl-2b | qwen25vl-7b | qwen3vl-moe-a3b | ...
    enhance_captions: bool = False
    t5_embeddings: bool = False
    previews: bool = False
    tracking: bool = False
    tracking_annotated: bool = False
    per_event_captions: bool = False
    # execution
    num_chips: int = 0  # 0 = discover (CUDA devices)
    perf_profile: bool = False
    profile_cpu: bool = False
    profile_memory: bool = False
    tracing: bool = False
    stage_save_rate: float = 0.0
    stage_save_stages: tuple[str, ...] = ()
    extra_stages: list[Stage | StageSpec] = field(default_factory=list)
    # where the model stages run: "cuda" unless the caller asks for "cpu"
    device: str = "cuda"


_LEGS = "ROADMAP queue A item 8"
_OBSERVABILITY = "tracing, live status and the observability wrappers (ROADMAP queue A item 14)"
# (option as set, whether args set it, what it waits for)
_NOT_PORTED: tuple[tuple[str, Callable[[SplitPipelineArgs], bool], str], ...] = (
    ("sr", lambda a: a.sr, f"super resolution, {_LEGS}"),
    ("motion_filter", lambda a: a.motion_filter != "disable",
     "mv_extract.c with the motion filter (ROADMAP queue A item 16)"),
    ("incremental_dedup", lambda a: a.incremental_dedup != "disable", INDEX_NOT_PORTED),
    ("index_path", lambda a: bool(a.index_path), INDEX_NOT_PORTED),
    ("corpus_index", lambda a: a.corpus_index,
     "the corpus-index writer path and its consolidation (ROADMAP queue A item 12)"),
    ("multicam", lambda a: a.multicam, "multicam sessions (ROADMAP queue A item 11)"),
    ("tracking", lambda a: a.tracking or a.tracking_annotated, f"the tracker, {_LEGS}"),
    ("per_event_captions", lambda a: a.per_event_captions, f"per-event captions, {_LEGS}"),
    ("tracing", lambda a: a.tracing, _OBSERVABILITY),
    ("perf_profile", lambda a: a.perf_profile, _OBSERVABILITY),
    ("profile_cpu", lambda a: a.profile_cpu, _OBSERVABILITY),
    ("profile_memory", lambda a: a.profile_memory, _OBSERVABILITY),
    ("stage_save_rate", lambda a: a.stage_save_rate > 0, _OBSERVABILITY),
)


def assemble_stages(args: SplitPipelineArgs) -> list[Stage | StageSpec]:
    refused = [f"{option}: {item}" for option, is_set, item in _NOT_PORTED if is_set(args)]
    if refused:
        raise NotImplementedError("split options not ported yet: " + "; ".join(refused))
    primary_sig = FrameExtractionSignature("fps", args.extract_fps[0])
    stages: list[Stage | StageSpec] = [VideoDownloadStage()]
    if args.splitting_algorithm == "transnetv2":
        stages.append(TransNetV2ClipExtractionStage(
            threshold=args.transnetv2_threshold, min_clip_len_s=args.min_clip_len_s,
            max_clip_len_s=args.max_clip_len_s, device=args.device))
    else:
        stages.append(FixedStrideExtractorStage(clip_len_s=args.fixed_stride_len_s,
                                                min_clip_len_s=args.min_clip_len_s))
    stages += [
        ClipTranscodingStage(num_threads=args.transcode_cpus, chunk_size=args.clip_chunk_size),
        ClipFrameExtractionStage(
            signatures=tuple(FrameExtractionSignature("fps", f) for f in args.extract_fps),
            resize_hw=args.extract_resize_hw,
        ),
    ]
    if args.aesthetic_threshold is not None:
        stages.append(AestheticFilterStage(threshold=args.aesthetic_threshold, extraction=primary_sig,
                                           device=args.device))
    if args.text_filter != "disable":
        stages.append(ArtificialTextFilterStage(threshold=args.text_filter_threshold,
                                                score_only=args.text_filter == "score-only",
                                                extraction=primary_sig, device=args.device))
    if args.semantic_filter != "disable":
        stages.append(SemanticFilterStage(prompt_variant=args.semantic_filter_prompt,
                                          score_only=args.semantic_filter == "score-only",
                                          extraction=primary_sig, model_flavor=args.caption_model,
                                          device=args.device))
    if args.embedding_model:
        stages.append(ClipEmbeddingStage(variant=args.embedding_model, extraction=primary_sig, device=args.device))
    if args.captioning:
        stages.append(CaptionPrepStage(window_len=args.caption_window_len, extraction=primary_sig))
        stages.append(CaptionStage(prompt_variant=args.caption_prompt_variant, model_flavor=args.caption_model,
                                   device=args.device))
    if args.enhance_captions:
        stages.append(EnhanceCaptionStage(prompt_variant=args.caption_prompt_variant,
                                          model_flavor=args.caption_model, device=args.device))
    if args.t5_embeddings:
        stages.append(CaptionEmbeddingStage(prompt_variant=args.caption_prompt_variant, device=args.device))
    if args.previews:
        stages.append(PreviewStage(extraction=primary_sig))
    stages.extend(args.extra_stages)
    stages.append(ClipWriterStage(args.output_path))
    return stages


def run_split(
    args: SplitPipelineArgs,
    *,
    runner: RunnerInterface | None = None,
    config: PipelineConfig | None = None,
) -> dict:
    """Build inputs (with resume), run, write summary.json; returns summary."""
    t0 = time.monotonic()
    # a dead card is one clear error before any stage is built, not N
    # crashed model setups (off | on | strict; on means strict here)
    if os.environ.get(HEALTH_GATE_ENV, "off") in ("on", "strict") and torch.device(args.device).type == "cuda":
        accelerator_health_gate(attempts=3, probe_timeout_s=120, backoff_s=30, require=True)
    stages = assemble_stages(args)
    tasks = discover_split_tasks(args.input_path, args.output_path, limit=args.limit)
    out = run_pipeline(tasks, stages, config=config, runner=runner or default_runner()) or []
    elapsed = time.monotonic() - t0
    num_chips = args.num_chips or max(1, torch.cuda.device_count())
    summary = build_summary(out, pipeline_run_time_s=elapsed, num_chips=num_chips)
    write_summary(f"{args.output_path.rstrip('/')}/summary.json", summary)
    logger.info("split done: %d videos, %d clips, %.1fs", summary["num_videos"], summary["num_clips"], elapsed)
    return summary
