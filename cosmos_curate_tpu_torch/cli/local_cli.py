"""``cosmos-curate-tpu-torch local …``: run pipelines on this host (port of
``cosmos_curate_tpu/cli/local_cli.py``).

Every subcommand and flag of the reference's parser, with the same names,
defaults and choices, plus ``--device`` (where the models run: ``cuda``
unless given ``cpu``) on ``hello``, ``split``, ``image-annotate`` and
``dedup``; ``shard`` is host work and takes none. ``split`` takes flags or
a YAML / JSON config (``--config``), as the reference's does.

Refused, naming what they wait for: ``split --runner streaming|map``
(ROADMAP queue A item 9b), ``av`` (item 19) and ``merge-summaries`` (item
15). A split option that ``run_split`` refuses passes through and raises
there; ``split --tracing`` runs.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys

# mirrors models/vlm/model.py VLM_FLAVORS (pinned by a test); a static list
# keeps torch out of --help
CAPTION_MODEL_CHOICES = (
    "base",
    "qwen25vl-7b",
    "qwen2vl-2b",
    "qwen3moe-a3b-lm",
    "qwen3vl-moe-a3b",
    "qwen3moe-tiny-test",
    "qwen-chat-tiny-test",
    "tiny-test",
)

_AV = "the multi-camera AV pipelines (ROADMAP queue A item 19)"
_MERGE = "multi-node summaries and their merged run report (ROADMAP queue A item 15)"


def _device_flag(p: argparse.ArgumentParser, default: str | None = "cuda") -> None:
    p.add_argument(
        "--device",
        default=default,
        choices=["cuda", "cpu"],
        help="where the models run (default: cuda; never falls back to the CPU)",
    )


def register(sub: argparse._SubParsersAction) -> None:
    local = sub.add_parser("local", help="run pipelines on this host")
    lsub = local.add_subparsers(dest="subcommand", metavar="pipeline")

    hello = lsub.add_parser("hello", help="hello-world example pipeline")
    _device_flag(hello)
    hello.set_defaults(func=_cmd_hello)

    split = lsub.add_parser("split", help="split-annotate videos into curated clips")
    split.add_argument("--input-path", required=False, default="", help="videos dir or config file")
    split.add_argument("--output-path", default="")
    split.add_argument("--config", default="", help="YAML/JSON config (alternative to flags)")
    split.add_argument("--limit", type=int, default=0)
    split.add_argument("--splitting-algorithm", choices=["fixed-stride", "transnetv2"], default="fixed-stride")
    split.add_argument("--fixed-stride-len-s", type=float, default=10.0)
    split.add_argument("--min-clip-len-s", type=float, default=2.0)
    split.add_argument("--multicam", action="store_true", help="input is <session>/<camera>.mp4 dirs")
    split.add_argument("--primary-camera", default="", help="primary camera filename stem")
    split.add_argument("--motion-filter", choices=["disable", "score-only", "enable"], default="disable")
    split.add_argument(
        "--motion-backend",
        choices=["auto", "mv", "frame-diff"],
        default="auto",
        help="motion estimator: codec motion vectors, frame differences, "
        "or auto (MVs with frame-diff fallback)",
    )
    split.add_argument("--aesthetic-threshold", type=float, default=None)
    split.add_argument(
        "--embedding-model",
        choices=["", "clip", "video", "video-512", "video-256", "iv2", "iv2-tiny-test"],
        default="",
    )
    split.add_argument(
        "--corpus-index",
        action="store_true",
        help="append clip embeddings to the persistent corpus index "
        "in-pipeline (consolidated at end of run)",
    )
    split.add_argument("--index-path", default="", help="corpus index root (default <output>/index)")
    split.add_argument(
        "--incremental-dedup",
        choices=["disable", "score-only", "enable"],
        default="disable",
        help="query the corpus index as clips flow; enable drops duplicates "
        "before captioning/writing",
    )
    split.add_argument("--dedup-eps", type=float, default=0.07)
    split.add_argument(
        "--dedup-nprobe", type=int, default=0,
        help="clusters probed per incremental-dedup query (0 = index default)",
    )
    split.add_argument("--captioning", action="store_true")
    split.add_argument(
        "--caption-model",
        default="base",
        choices=CAPTION_MODEL_CHOICES,
        help="VLM flavor for every caption-family stage",
    )
    split.add_argument("--enhance-captions", action="store_true")
    split.add_argument("--t5-embeddings", action="store_true")
    split.add_argument("--previews", action="store_true")
    split.add_argument("--tracking", action="store_true")
    split.add_argument("--tracking-annotated", action="store_true")
    split.add_argument("--per-event-captions", action="store_true")
    split.add_argument("--sr", action="store_true", help="super-resolve clips after transcode")
    split.add_argument("--sr-variant", choices=["diffusion", "srnet"], default="diffusion")
    split.add_argument("--sr-window-frames", type=int, default=128)
    split.add_argument("--sr-overlap-frames", type=int, default=64)
    split.add_argument("--sr-sp-size", type=int, default=1, help="sequence-parallel mesh size for SR")
    split.add_argument("--text-filter", choices=["disable", "score-only", "enable"], default="disable")
    split.add_argument("--semantic-filter", choices=["disable", "score-only", "enable"], default="disable")
    split.add_argument("--clip-chunk-size", type=int, default=64)
    split.add_argument("--sequential", action="store_true", help="run in-process (no engine)")
    split.add_argument(
        "--runner",
        choices=["auto", "sequential", "pipelined", "streaming", "map"],
        default="auto",
        help="execution backend: stage-overlapped thread pools (pipelined; "
        "the single-host default), in-process sequential; streaming and "
        "map are not ported yet",
    )
    split.add_argument("--profile-cpu", action="store_true")
    split.add_argument("--profile-memory", action="store_true")
    split.add_argument("--tracing", action="store_true")
    split.add_argument("--stage-save-rate", type=float, default=0.0)
    # None: a --config file's own device stands; otherwise cuda
    _device_flag(split, default=None)
    split.set_defaults(func=_cmd_split)

    av = lsub.add_parser("av", help="multi-camera AV pipelines (not ported yet)")
    av.add_argument(
        "subcommand2",
        choices=["ingest", "split", "caption", "trajectory", "annotate", "package", "shard"],
        metavar="step",
    )
    av.add_argument(
        "--caption-variants",
        default="av",
        help="comma-separated prompt variants; first is the primary caption",
    )
    av.add_argument("--input-path", required=True)
    av.add_argument("--output-path", required=True)
    av.add_argument("--db-path", default="")
    av.add_argument("--clip-len-s", type=float, default=10.0)
    av.add_argument("--min-clip-len-s", type=float, default=None)
    av.add_argument("--limit", type=int, default=0)
    av.add_argument("--sequential", action="store_true")
    av.set_defaults(func=_cmd_av)

    image = lsub.add_parser("image-annotate", help="curate still images")
    image.add_argument("--input-path", required=True)
    image.add_argument("--output-path", required=True)
    image.add_argument("--limit", type=int, default=0)
    image.add_argument("--aesthetic-threshold", type=float, default=None)
    image.add_argument("--captioning", action="store_true")
    image.add_argument("--semantic-filter", choices=["disable", "score-only", "enable"], default="disable")
    image.add_argument("--semantic-filter-prompt", default=None)
    image.add_argument("--classifier-labels", default="", help="comma-separated label set; empty = off")
    image.add_argument("--api-caption-url", default="", help="OpenAI-compatible endpoint for captioning")
    image.add_argument("--api-caption-model", default="default")
    image.add_argument(
        "--api-caption-key",
        default="",
        help="bearer token for the caption endpoint (or set CURATE_API_KEY)",
    )
    image.add_argument("--sequential", action="store_true")
    _device_flag(image)
    image.set_defaults(func=_cmd_image)

    dedup = lsub.add_parser("dedup", help="semantic dedup over clip embeddings")
    dedup.add_argument("--input-path", required=True, help="split output root")
    dedup.add_argument("--output-path", default="")
    dedup.add_argument("--embedding-model", default="")
    dedup.add_argument("--eps", type=float, default=0.07)
    dedup.add_argument("--n-clusters", type=int, default=0)
    dedup.add_argument(
        "--no-index",
        action="store_true",
        help="force full re-clustering even when a corpus index exists",
    )
    dedup.add_argument("--index-path", default="", help="corpus index root (default <input>/index)")
    dedup.add_argument("--nprobe", type=int, default=0, help="0 = index default")
    _device_flag(dedup)
    dedup.set_defaults(func=_cmd_dedup)

    shard = lsub.add_parser("shard", help="pack curated clips into webdataset tars")
    shard.add_argument("--input-path", required=True, help="split output root")
    shard.add_argument("--output-path", required=True)
    shard.add_argument("--dedup-csv", default="")
    shard.add_argument("--max-samples-per-shard", type=int, default=512)
    shard.set_defaults(func=_cmd_shard)

    merge = lsub.add_parser(
        "merge-summaries",
        help="combine per-node summary-node*.json into one summary-merged.json (not ported yet)",
    )
    merge.add_argument("--output-path", required=True, help="pipeline output root")
    merge.set_defaults(func=_cmd_merge_summaries)

    local.set_defaults(func=lambda args: (local.print_help(), 2)[1])


def _cmd_merge_summaries(args: argparse.Namespace) -> int:
    raise NotImplementedError(f"local merge-summaries needs {_MERGE}, not ported yet")


def _cmd_av(args: argparse.Namespace) -> int:
    raise NotImplementedError(f"local av {args.subcommand2} runs {_AV}, not ported yet")


def _cmd_hello(args: argparse.Namespace) -> int:
    from cosmos_curate_tpu_torch.pipelines.examples.hello_world import run_hello_world

    for task in run_hello_world(device=args.device):
        print(f"{task.text!r} score={task.score:.4f} device={task.device}")
    return 0


def _cmd_image(args: argparse.Namespace) -> int:
    from cosmos_curate_tpu_torch.core.runner import SequentialRunner
    from cosmos_curate_tpu_torch.pipelines.image.annotate import ImagePipelineArgs, run_image_annotate

    summary = run_image_annotate(
        ImagePipelineArgs(
            input_path=args.input_path,
            output_path=args.output_path,
            limit=args.limit,
            aesthetic_threshold=args.aesthetic_threshold,
            captioning=args.captioning,
            semantic_filter=args.semantic_filter,
            semantic_filter_prompt=args.semantic_filter_prompt,
            classifier_labels=tuple(s.strip() for s in args.classifier_labels.split(",") if s.strip()),
            api_caption_url=args.api_caption_url,
            api_caption_model=args.api_caption_model,
            api_caption_key=args.api_caption_key,
            device=args.device,
        ),
        runner=SequentialRunner() if args.sequential else None,
    )
    print(json.dumps(summary, indent=2))
    return 0


def _cmd_dedup(args: argparse.Namespace) -> int:
    from cosmos_curate_tpu_torch.pipelines.video.dedup import DedupPipelineArgs, run_dedup

    summary = run_dedup(
        DedupPipelineArgs(
            input_path=args.input_path,
            output_path=args.output_path,
            embedding_model=args.embedding_model,
            eps=args.eps,
            n_clusters=args.n_clusters,
            use_index=not args.no_index,
            index_path=args.index_path,
            nprobe=args.nprobe,
            device=args.device,
        )
    )
    print(json.dumps(summary, indent=2))
    return 0


def _cmd_shard(args: argparse.Namespace) -> int:
    from cosmos_curate_tpu_torch.pipelines.video.shard import ShardPipelineArgs, run_shard

    summary = run_shard(
        ShardPipelineArgs(
            input_path=args.input_path,
            output_path=args.output_path,
            dedup_csv=args.dedup_csv,
            max_samples_per_shard=args.max_samples_per_shard,
        )
    )
    print(json.dumps(summary, indent=2))
    return 0


def _split_runner(choice: str):
    """The runner ``--runner`` names (None: run_split's default)."""
    from cosmos_curate_tpu_torch.core.runner import _NOT_PORTED, SequentialRunner

    if choice in _NOT_PORTED:
        raise NotImplementedError(f"--runner {choice} selects {_NOT_PORTED[choice]}, not ported yet")
    if choice == "sequential":
        return SequentialRunner()
    if choice == "pipelined":
        from cosmos_curate_tpu_torch.core.pipelined_runner import PipelinedRunner

        # the same poison-batch semantics as `auto` (default_runner):
        # exhausted batches dead-letter, the run continues
        return PipelinedRunner(raise_on_error=False)
    return None


def _cmd_split(args: argparse.Namespace) -> int:
    from cosmos_curate_tpu_torch.pipelines.video.split import SplitPipelineArgs, run_split

    choice = args.runner
    if args.sequential:
        if choice not in ("auto", "sequential"):
            print(f"error: --sequential conflicts with --runner {choice}", file=sys.stderr)
            return 2
        choice = "sequential"
    # before any config is read: a refused runner raises at once
    runner = _split_runner(choice)
    if args.config:
        from cosmos_curate_tpu_torch.utils.config import load_pipeline_config

        pargs = load_pipeline_config(args.config, SplitPipelineArgs)
        if args.device:
            pargs = dataclasses.replace(pargs, device=args.device)
    else:
        if not args.input_path or not args.output_path:
            print("error: --input-path and --output-path (or --config) are required")
            return 2
        pargs = SplitPipelineArgs(
            input_path=args.input_path,
            output_path=args.output_path,
            limit=args.limit,
            splitting_algorithm=args.splitting_algorithm,
            fixed_stride_len_s=args.fixed_stride_len_s,
            min_clip_len_s=args.min_clip_len_s,
            multicam=args.multicam,
            primary_camera=args.primary_camera,
            motion_filter=args.motion_filter,
            motion_backend=args.motion_backend,
            aesthetic_threshold=args.aesthetic_threshold,
            embedding_model=args.embedding_model,
            corpus_index=args.corpus_index,
            index_path=args.index_path,
            incremental_dedup=args.incremental_dedup,
            dedup_eps=args.dedup_eps,
            dedup_nprobe=args.dedup_nprobe,
            captioning=args.captioning,
            caption_model=args.caption_model,
            enhance_captions=args.enhance_captions,
            t5_embeddings=args.t5_embeddings,
            previews=args.previews,
            tracking=args.tracking or args.tracking_annotated,  # annotated implies tracking
            tracking_annotated=args.tracking_annotated,
            per_event_captions=args.per_event_captions,
            text_filter=args.text_filter,
            semantic_filter=args.semantic_filter,
            sr=args.sr,
            sr_variant=args.sr_variant,
            sr_window_frames=args.sr_window_frames,
            sr_overlap_frames=args.sr_overlap_frames,
            sr_sp_size=args.sr_sp_size,
            clip_chunk_size=args.clip_chunk_size,
            profile_cpu=args.profile_cpu,
            profile_memory=args.profile_memory,
            tracing=args.tracing,
            stage_save_rate=args.stage_save_rate,
            device=args.device or "cuda",
        )
    summary = run_split(pargs, runner=runner)
    print(json.dumps(summary, indent=2))
    return 0
