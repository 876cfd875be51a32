"""The split-annotate pipeline: assembly + entry point (port of
``cosmos_curate_tpu/pipelines/video/split.py``).

download → clips (fixed stride, or TransNetV2 shot detection) → transcode →
[super resolution] → [motion filter] → frame extraction → [aesthetic
filter] → [artificial-text filter] → [semantic filter] → [embed] →
[incremental dedup] → [caption prep → caption] → [enhanced captions] → [T5
caption embeddings] → [previews] → [tracking] → [per-event captions] →
writer, through the port's own ``run_pipeline``. Tracking runs with
``tracking`` or ``per_event_captions``; ``tracking_annotated`` alone adds
no stage (it only makes the tracking stage write annotated clips), as in
the reference. The model stages and the
corpus index's products run on ``SplitPipelineArgs.device`` ("cuda" unless
the caller asks for the CPU). With ``corpus_index`` the writer appends
pending index fragments and ``run_split`` consolidates them into the index
after the run (the summary's ``corpus_index`` block); a consolidation that
fails on storage or data is logged and leaves the run's output as it is,
but a device fault propagates.

``assemble_stages`` raises ``NotImplementedError``, naming the ROADMAP item,
for every option whose stage is not ported yet (super resolution's
``sr_sp_size > 1``). With ``multicam`` the input is session directories
of time-aligned cameras (``<session>/<camera>.mp4``, input_discovery.py's
``discover_multicam_tasks``), split fixed-stride only (any other
algorithm raises ``ValueError``): the secondary cameras take the primary's
spans and the writer puts their clips beside the primary's. ``run_split`` wraps the assembled stages
in the observability wrappers the options ask for
(``_apply_observability_wrappers``): ``stage_save_rate`` records sampled
stage inputs under ``<output>/stage_save/`` (observability/stage_replay.py)
and ``profile_cpu`` / ``profile_memory`` write cProfile / tracemalloc
artifacts under ``<output>/profile/`` (observability/profiling.py);
``perf_profile`` is carried and read by nothing, as in the reference.
``run_split`` runs the
accelerator health gate first when ``CURATE_HEALTH_GATE`` is ``on`` or
``strict`` (utils/health.py: both abort on an unhealthy card; the port never
moves a run to the CPU by itself, and a ``device="cpu"`` run has no card to
gate). Every run publishes its live status to
``<output>/report/live/status.json``. With ``tracing`` the run's spans go to
``<output>/profile/traces/driver.ndjson``, all rooted on one ``run.split``
span, and the flight recorder writes ``<output>/report/run_report.json`` at
the end; a recorder failure is logged and leaves the run's output as it is.

Multi-node runs follow the reference's environment contract
(parallel/distributed.py): under ``CURATE_NUM_NODES`` / ``CURATE_NODE_RANK``
node *i* takes every *N*-th task, or, with ``CURATE_WORK_STEALING=1``,
claims batches from the shared ledger under the output root
(parallel/work_stealing.py), its dead-lettered batches summed across the
claims. Rank 0 writes ``summary.json`` and rank *r* ``summary-node<r>.json``;
a traced node writes ``driver-n<rank>.ndjson`` and its stats sidecar, and
clears only its own stale files; artifact delivery, the run report and the
corpus index's consolidation wait for ``local merge-summaries``, which runs
once every node has finished. ``CURATE_COORDINATOR_ADDRESS`` also joins the
nodes in a gloo process group.
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
from cosmos_curate_tpu_torch.dedup.corpus_index import consolidate_index
from cosmos_curate_tpu_torch.observability import tracing
from cosmos_curate_tpu_torch.observability.artifacts import collect_artifacts, finalize_delivery
from cosmos_curate_tpu_torch.observability.flight_recorder import (
    clear_trace_artifacts,
    write_node_stats,
    write_run_report,
)
from cosmos_curate_tpu_torch.observability.live_status import export_live_status_dir
from cosmos_curate_tpu_torch.observability.profiling import ProfilingConfig, profiling_wrapper
from cosmos_curate_tpu_torch.observability.stage_replay import StageSaveConfig, stage_save_wrapper
from cosmos_curate_tpu_torch.ops._build import DEVICE_FAULTS
from cosmos_curate_tpu_torch.parallel.distributed import (
    maybe_initialize_distributed,
    node_rank_and_count,
    partition_tasks_for_node,
)
from cosmos_curate_tpu_torch.parallel.work_stealing import run_with_stealing, stealing_enabled
from cosmos_curate_tpu_torch.pipelines.video.input_discovery import (
    _processed_video_ids,
    discover_multicam_tasks,
    discover_split_tasks,
)
from cosmos_curate_tpu_torch.pipelines.video.stages.aesthetic_filter import AestheticFilterStage
from cosmos_curate_tpu_torch.pipelines.video.stages.artificial_text_filter import ArtificialTextFilterStage
from cosmos_curate_tpu_torch.pipelines.video.stages.caption_embedding import CaptionEmbeddingStage
from cosmos_curate_tpu_torch.pipelines.video.stages.captioning import CaptionPrepStage, CaptionStage
from cosmos_curate_tpu_torch.pipelines.video.stages.clip_extraction import (
    ClipTranscodingStage,
    FixedStrideExtractorStage,
)
from cosmos_curate_tpu_torch.pipelines.video.stages.dedup_stage import IncrementalDedupStage
from cosmos_curate_tpu_torch.pipelines.video.stages.download import VideoDownloadStage
from cosmos_curate_tpu_torch.pipelines.video.stages.embedding import ClipEmbeddingStage
from cosmos_curate_tpu_torch.pipelines.video.stages.enhance_caption import EnhanceCaptionStage
from cosmos_curate_tpu_torch.pipelines.video.stages.frame_extraction import ClipFrameExtractionStage
from cosmos_curate_tpu_torch.pipelines.video.stages.motion_filter import MotionFilterStage
from cosmos_curate_tpu_torch.pipelines.video.stages.per_event_caption import PerEventCaptionStage
from cosmos_curate_tpu_torch.pipelines.video.stages.preview import PreviewStage
from cosmos_curate_tpu_torch.pipelines.video.stages.semantic_filter import SemanticFilterStage
from cosmos_curate_tpu_torch.pipelines.video.stages.shot_detection import TransNetV2ClipExtractionStage
from cosmos_curate_tpu_torch.pipelines.video.stages.super_resolution import SuperResolutionStage
from cosmos_curate_tpu_torch.pipelines.video.stages.tracking import TrackingStage
from cosmos_curate_tpu_torch.pipelines.video.stages.writer import ClipWriterStage, video_record_id
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


# (option as set, whether args set it, what it waits for)
_NOT_PORTED: tuple[tuple[str, Callable[[SplitPipelineArgs], bool], str], ...] = (
    ("sr_sp_size", lambda a: a.sr and a.sr_sp_size > 1,
     "sequence-parallel super resolution (ROADMAP queue A item 7)"),
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
    stages.append(ClipTranscodingStage(num_threads=args.transcode_cpus, chunk_size=args.clip_chunk_size))
    if args.sr:
        if args.sr_overlap_frames >= args.sr_window_frames:
            # before any stage runs: the stage's per-clip error handling
            # would otherwise write a full output set without SR
            raise ValueError(f"--sr-overlap-frames ({args.sr_overlap_frames}) must be < "
                             f"--sr-window-frames ({args.sr_window_frames})")
        # straight after transcode: the filters and frame extraction see the
        # upscaled clips
        stages.append(SuperResolutionStage(variant=args.sr_variant, window_len=args.sr_window_frames,
                                           overlap=args.sr_overlap_frames, sp_size=args.sr_sp_size,
                                           device=args.device))
    if args.motion_filter != "disable":
        stages.append(MotionFilterStage(
            score_only=args.motion_filter == "score-only", global_threshold=args.motion_global_threshold,
            per_patch_threshold=args.motion_patch_threshold, backend=args.motion_backend,
            mv_global_threshold=args.motion_mv_global_threshold, mv_patch_threshold=args.motion_mv_patch_threshold,
            device=args.device))
    stages.append(ClipFrameExtractionStage(
        signatures=tuple(FrameExtractionSignature("fps", f) for f in args.extract_fps),
        resize_hw=args.extract_resize_hw,
    ))
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
    if args.incremental_dedup != "disable":
        if not args.embedding_model:
            raise ValueError("--incremental-dedup needs an --embedding-model: dedup queries the corpus index "
                             "with this run's clip embeddings")
        # straight after embedding: duplicates go before captioning,
        # previews and the writer's embedding and index writes
        stages.append(IncrementalDedupStage(resolve_index_path(args), eps=args.dedup_eps, nprobe=args.dedup_nprobe,
                                            score_only=args.incremental_dedup == "score-only", device=args.device))
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
    if args.tracking or args.per_event_captions:
        stages.append(TrackingStage(write_annotated=args.tracking_annotated, device=args.device))
    if args.per_event_captions:
        stages.append(PerEventCaptionStage(model_flavor=args.caption_model, device=args.device))
    stages.extend(args.extra_stages)
    stages.append(ClipWriterStage(args.output_path, index_path=resolve_index_path(args) if args.corpus_index else ""))
    return stages


def resolve_index_path(args: SplitPipelineArgs) -> str:
    """The corpus-index root this run writes fragments to and queries: the
    explicit ``index_path``, else ``<output>/index``."""
    return (args.index_path or f"{args.output_path.rstrip('/')}/index").rstrip("/")


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
    # before the runner exists: every runner publishes its snapshots to
    # <output>/report/live/status.json
    export_live_status_dir(args.output_path)
    # resolved here, not in run_pipeline, so the flight recorder reads the
    # instance that ran (its dead-letter counts, stage times, overlap)
    runner = runner or default_runner()
    maybe_initialize_distributed()
    rank, n_nodes = node_rank_and_count()
    # work stealing runs the pipeline once per claimed batch, and each run
    # resets the runner's DLQ accounting: the node's drops add up here
    steal_dead: dict = {"count": 0, "dirs": []}
    index_extra: dict = {}
    run_root = None
    # tracing starts right before the try whose finally ends it
    if args.tracing:
        # a re-run into the same root starts from a clean trace: stale
        # rotation parts carry the old run's trace ids. A node of a
        # multi-node run clears only its own files (peers may be writing)
        clear_trace_artifacts(args.output_path, rank=rank if n_nodes > 1 else None)
        name = "driver.ndjson" if n_nodes <= 1 else f"driver-n{rank}.ndjson"
        tracing.enable_tracing(f"{args.output_path.rstrip('/')}/profile/traces/{name}")
        # join a caller-stamped trace where there is one, then root every
        # span of the run on ONE run.split span, carried as the process
        # parent (not the contextvar stack), so any thread (and every
        # stolen batch's pipeline.run) joins it
        tracing.attach_traceparent(os.environ.get(tracing.TRACEPARENT_ENV))
        run_root = tracing.start_span("run.split", output_path=args.output_path)
        tracing.attach_traceparent(tracing.format_traceparent(run_root))
    try:
        if args.multicam:
            if args.splitting_algorithm != "fixed-stride":
                raise ValueError("multicam sessions split fixed-stride only (time-aligned spans across cameras)")
            tasks = discover_multicam_tasks(args.input_path, args.output_path, primary_camera=args.primary_camera,
                                            limit=args.limit)
        else:
            tasks = discover_split_tasks(args.input_path, args.output_path, limit=args.limit)
        stages = _apply_observability_wrappers(assemble_stages(args), args)
        if n_nodes > 1 and stealing_enabled():
            # shared-ledger mode: nodes pull claim batches until the ledger
            # is dry, so a skewed split rebalances instead of idling a node
            # (a multicam session is claimed by its primary's record id)
            done_cache = {"ts": 0.0, "ids": set()}

            def _task_done(t) -> bool:
                # the resume records are the completion signal; one listing
                # a linger poll, not one a task
                now = time.monotonic()
                if now - done_cache["ts"] > 5.0:
                    done_cache["ids"] = _processed_video_ids(args.output_path)
                    done_cache["ts"] = now
                return video_record_id(t.video.path) in done_cache["ids"]

            def _run_batch(batch):
                res = run_pipeline(batch, stages, config=config, runner=runner)
                dlq = getattr(runner, "dlq", None)
                n = int(getattr(runner, "dead_lettered", 0) or getattr(dlq, "recorded", 0) or 0)
                if n:
                    steal_dead["count"] += n
                    if dlq is not None and getattr(dlq, "recorded", 0):
                        steal_dead["dirs"].append(str(dlq.run_dir))
                return res

            out = run_with_stealing(tasks, args.output_path, _run_batch,
                                    record_id=lambda t: video_record_id(t.video.path), is_done=_task_done)
        else:
            # each node takes a disjoint slice (the resume records keep
            # re-runs consistent)
            out = run_pipeline(partition_tasks_for_node(tasks), stages, config=config, runner=runner) or []
        if args.corpus_index and n_nodes == 1:
            # before the report, so its index aggregates land in it; a
            # multi-node run leaves the pending fragments to `index
            # consolidate` after the merge (concurrent consolidations would
            # race on the centroids)
            index_extra = _consolidate_corpus_index(args)
    finally:
        if args.tracing:
            tracing.end_span(run_root)
            tracing.disable_tracing()  # flushes the buffered spans
        if args.tracing or args.profile_cpu or args.profile_memory:
            collect_artifacts(args.output_path)
            extra = None
            if steal_dead["count"]:
                # the accumulator holds every stolen batch's drops: it
                # replaces the runner's last-run accounting
                extra = {"dead_lettered": steal_dead["count"]}
                if steal_dead["dirs"]:
                    extra["dlq_run_dir"] = ",".join(dict.fromkeys(steal_dead["dirs"]))
            if n_nodes == 1:
                # one node is also the delivery driver; a multi-node run
                # finalizes in `local merge-summaries`, once every node
                # has collected
                finalize_delivery(args.output_path)
                if args.tracing:
                    try:
                        write_run_report(args.output_path, runner=runner, extra=extra)
                    except Exception:
                        logger.exception("flight recorder failed (run output unaffected)")
            elif args.tracing:
                # the merged report is built at merge time, when this
                # runner's memory is gone: keep its sections in a sidecar
                try:
                    write_node_stats(args.output_path, rank, runner, extra=extra)
                except Exception:
                    logger.exception("node stats sidecar failed (run output unaffected)")
    elapsed = time.monotonic() - t0
    # host inventory until the mesh layer owns device counts (ROADMAP queue A item 7)
    # curate-lint: disable=hardcoded-device-count
    num_chips = args.num_chips or max(1, torch.cuda.device_count())
    summary = build_summary(out, pipeline_run_time_s=elapsed, num_chips=num_chips, extra=index_extra or None)
    name = "summary.json" if rank == 0 else f"summary-node{rank}.json"
    write_summary(f"{args.output_path.rstrip('/')}/{name}", summary)
    logger.info("split done: %d videos, %d clips, %.1fs", summary["num_videos"], summary["num_clips"], elapsed)
    return summary


def _apply_observability_wrappers(stages: list[Stage | StageSpec], args: SplitPipelineArgs) -> list[Stage | StageSpec]:
    """Stage-save and profiling wrappers, each a subclass made at run time
    around the stage instance (no stage code changes); stage-save goes on
    first, so the profiler also times the saving."""
    out_root = args.output_path.rstrip("/")
    instances = [s.stage if isinstance(s, StageSpec) else s for s in stages]
    if args.stage_save_rate > 0:
        save = StageSaveConfig(output_path=f"{out_root}/stage_save", sample_rate=args.stage_save_rate,
                               stages=args.stage_save_stages)
        for stage in instances:
            stage_save_wrapper(stage, save)
    if args.profile_cpu or args.profile_memory:
        prof = ProfilingConfig(cpu=args.profile_cpu, memory=args.profile_memory, output_path=f"{out_root}/profile")
        for stage in instances:
            profiling_wrapper(stage, prof)
    return stages


def _consolidate_corpus_index(args: SplitPipelineArgs) -> dict:
    """Fold the writer's pending index fragments into per-cluster shards
    (training centroids on the first run). A failure of storage or data is
    logged and leaves the run's output as it is; a device fault propagates."""
    root = resolve_index_path(args)
    try:
        cstats = consolidate_index(root, device=args.device)
    except DEVICE_FAULTS:
        raise
    except Exception:
        logger.exception("index consolidation failed (run output unaffected)")
        return {}
    logger.info("corpus index consolidated: %d vectors in (%d random-provenance refused)", cstats["consolidated"],
                cstats["skipped_random"])
    return {"corpus_index": {**cstats, "path": root}}
