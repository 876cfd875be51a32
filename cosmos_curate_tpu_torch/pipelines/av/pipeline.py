"""The AV (autonomous-vehicle) multi-camera pipeline (port of
``cosmos_curate_tpu/pipelines/av/pipeline.py``): ingest → split → caption →
[trajectory] → annotate → package → shard.

Sessions are groups of synchronized camera files named
``<session>_<camera>.mp4``; clip state lives in the AV state database
(pipelines/av/state_db.py: sqlite, an object-store sqlite file, or
PostgreSQL). The split reuses the video stages; ``caption`` runs the
``VLM_BASE`` ``CaptionEngine`` (``max_batch=8``) over fixed caption windows
with the "av" prompt variant, and ``package`` the ``T5_BASE`` encoder,
both on ``AVPipelineArgs.device`` ("cuda" unless the caller asks for the
CPU). A caption run with nothing to caption builds no engine.
"""

from __future__ import annotations

import dataclasses
import json
import pickle
import re
import time
import uuid
from collections import defaultdict
from dataclasses import dataclass
from pathlib import PurePath

import numpy as np

from cosmos_curate_tpu_torch import __version__
from cosmos_curate_tpu_torch.core.pipeline import run_pipeline
from cosmos_curate_tpu_torch.core.runner import RunnerInterface
from cosmos_curate_tpu_torch.data.model import FrameExtractionSignature, SplitPipeTask, Video, deterministic_id
from cosmos_curate_tpu_torch.models.prompts import get_caption_prompt
from cosmos_curate_tpu_torch.models.t5 import T5_BASE, T5EncoderTPU
from cosmos_curate_tpu_torch.models.tokenizer import default_caption_tokenizer
from cosmos_curate_tpu_torch.models.vlm import VLM_BASE, CaptionEngine, CaptionRequest, SamplingConfig
from cosmos_curate_tpu_torch.pipelines.av.annotation_writer import write_clip_annotations
from cosmos_curate_tpu_torch.pipelines.av.downloaders import prefetch_clips
from cosmos_curate_tpu_torch.pipelines.av.packaging import (
    CameraClipMedia,
    CameraWindows,
    ClipSessionMedia,
    SessionSample,
    package_clip_sessions,
    package_t5_embeddings_e,
    package_t5_embeddings_h,
    t5_session_uuid,
    write_cosmos_predict2_clip,
)
from cosmos_curate_tpu_torch.pipelines.av.state_db import (
    CAPTION_VERSION,
    ClippedSessionRow,
    ClipRow,
    RunRow,
    VideoSpanRow,
    open_state_db,
)
from cosmos_curate_tpu_torch.pipelines.video.shard import ShardPipelineArgs, run_shard
from cosmos_curate_tpu_torch.pipelines.video.stages.clip_extraction import (
    ClipTranscodingStage,
    FixedStrideExtractorStage,
)
from cosmos_curate_tpu_torch.pipelines.video.stages.download import VideoDownloadStage
from cosmos_curate_tpu_torch.pipelines.video.stages.frame_extraction import ClipFrameExtractionStage
from cosmos_curate_tpu_torch.pipelines.video.stages.writer import ClipWriterStage
from cosmos_curate_tpu_torch.storage.client import get_storage_client, read_bytes
from cosmos_curate_tpu_torch.utils.logging import get_logger
from cosmos_curate_tpu_torch.video.mp4_index import Mp4ParseError, parse_mp4_video_index

logger = get_logger(__name__)

_SESSION_RE = re.compile(r"^(?P<session>.+?)_(?P<camera>[A-Za-z0-9\-]+)$")


# caption-time frame sampling rate; T5 tar window metadata is expressed in
# this frame space
AV_CAPTION_FPS = 1.0


@dataclass
class AVPipelineArgs:
    input_path: str = ""
    output_path: str = ""
    db_path: str = ""  # sqlite path or postgres:// DSN; default <output>/av_state.sqlite
    clip_len_s: float = 10.0
    min_clip_len_s: float | None = None  # default: min(2.0, clip_len_s)
    caption_prompt_variant: str = "av"
    # extra prompt variants captioned per clip (a clip carries one caption
    # a variant)
    extra_caption_variants: tuple[str, ...] = ()
    # windowed captioning: long clips caption in frame windows; the primary
    # variant captions every window, extra variants the front window only
    caption_window_frames: int = 8
    limit: int = 0
    # dataset name in the packaged layout (datasets/{name}/...)
    dataset_name: str = "av-dataset"
    # shard-time T5 packaging: none | e (embeddings-first, one tar per
    # session) | h (hierarchical part_NNNNNN/t5_NNNNNN.tar)
    t5_packaging: str = "none"
    # shard-time mp4 clip-session tars
    clip_packaging: bool = False
    # where the caption engine, the trajectory and T5 run: "cuda" unless
    # the caller asks for "cpu"
    device: str = "cuda"

    @property
    def resolved_db(self) -> str:
        return self.db_path or f"{self.output_path.rstrip('/')}/av_state.sqlite"


def discover_sessions(input_path: str) -> dict[str, dict[str, str]]:
    """session_id -> {camera: path} from <session>_<camera>.mp4 names."""
    client = get_storage_client(input_path)
    sessions: dict[str, dict[str, str]] = defaultdict(dict)
    for info in client.list_files(input_path, suffixes=(".mp4", ".mov", ".mkv")):
        stem = PurePath(info.path).stem
        m = _SESSION_RE.match(stem)
        if not m:
            logger.warning("skipping %s: name not <session>_<camera>", info.path)
            continue
        sessions[m.group("session")][m.group("camera")] = info.path
    return dict(sessions)


def run_av_ingest(args: AVPipelineArgs) -> dict:
    sessions = discover_sessions(args.input_path)
    db = open_state_db(args.resolved_db)
    try:
        for sid, cams in sessions.items():
            db.upsert_session(sid, len(cams))
        return {"num_sessions": len(sessions), "db": args.resolved_db}
    finally:
        db.close()


def run_av_split(args: AVPipelineArgs, *, runner: RunnerInterface | None = None) -> dict:
    t0 = time.monotonic()
    sessions = discover_sessions(args.input_path)
    db = open_state_db(args.resolved_db)
    try:
        tasks = []
        cam_of_path: dict[str, tuple[str, str]] = {}
        processed_sids: set[str] = set()
        for sid, cams in sorted(sessions.items()):
            for cam, path in sorted(cams.items()):
                tasks.append(SplitPipeTask(video=Video(path=path)))
                cam_of_path[path] = (sid, cam)
            processed_sids.add(sid)
            if args.limit and len(tasks) >= args.limit:
                break
        min_len = (
            args.min_clip_len_s
            if args.min_clip_len_s is not None
            else min(2.0, args.clip_len_s)
        )
        stages = [
            VideoDownloadStage(),
            FixedStrideExtractorStage(clip_len_s=args.clip_len_s, min_clip_len_s=min_len),
            ClipTranscodingStage(),
            ClipFrameExtractionStage(
                signatures=(FrameExtractionSignature("fps", 2.0),), resize_hw=(224, 224)
            ),
            ClipWriterStage(args.output_path),
        ]
        out = run_pipeline(tasks, stages, runner=runner) or []
        # provenance rows: one run row per invocation, one clipped_session
        # per split session, one video_span per encoded clip with geometry +
        # content hash
        run_uuid = str(uuid.uuid4())
        split_algo = "fixed-stride"
        rows = []
        span_rows = []
        span_index: dict[str, int] = defaultdict(int)
        encoders: dict[str, set[str]] = defaultdict(set)
        for task in out:
            sid, cam = cam_of_path.get(task.video.path, ("unknown", "unknown"))
            meta = task.video.metadata
            for clip in task.video.clips:
                rows.append(
                    ClipRow(
                        clip_uuid=str(clip.uuid),
                        session_id=sid,
                        camera=cam,
                        span_start=clip.span[0],
                        span_end=clip.span[1],
                    )
                )
                # span_index is the clip's position in the session timeline:
                # it must advance for EVERY clip so a failed middle transcode
                # doesn't shift later clips' indexes between runs
                idx = span_index[f"{sid}/{cam}"]
                span_index[f"{sid}/{cam}"] += 1
                # a span row asserts an mp4 on disk — clips whose transcode
                # failed (encoded_data never produced) must not mint one
                if not clip.encoded_byte_size:
                    continue
                if clip.encoding_codec:
                    encoders[sid].add(clip.encoding_codec)
                span_rows.append(
                    VideoSpanRow(
                        clip_uuid=str(clip.uuid),
                        version=CAPTION_VERSION,
                        session_uuid=_session_uuid(sid),
                        camera=cam,
                        span_index=idx,
                        split_algo_name=split_algo,
                        span_start=clip.span[0],
                        span_end=clip.span[1],
                        encoder=clip.encoding_codec,
                        # the destination the writer ACTUALLY wrote, not a
                        # re-derivation of its layout rule
                        url=clip.encoded_url,
                        byte_size=clip.encoded_byte_size,
                        duration=clip.duration_s,
                        framerate=meta.fps,
                        num_frames=int(round(clip.duration_s * meta.fps)),
                        height=meta.height,
                        width=meta.width,
                        sha256=clip.encoded_sha256,
                        run_uuid=run_uuid,
                    )
                )
        db.add_clips(rows)
        db.add_video_spans(span_rows)
        db.add_run(
            RunRow(
                run_uuid=run_uuid,
                run_type="split",
                pipeline_version=__version__,
                params=json.dumps(dataclasses.asdict(args)),
            )
        )
        # per-session encoder set (the primary key includes the encoder):
        # sessions with NO successful transcode write no row — an empty
        # encoder would mint a second PK when a later re-split succeeds
        db.add_clipped_sessions(
            [
                ClippedSessionRow(
                    session_uuid=_session_uuid(sid),
                    version=CAPTION_VERSION,
                    source_session=sid,
                    num_cameras=len(sessions.get(sid, {})),
                    split_algo_name=split_algo,
                    encoder=",".join(sorted(encoders[sid])),
                    run_uuid=run_uuid,
                )
                for sid in sorted(processed_sids)
                if encoders.get(sid)
            ]
        )
        for sid in processed_sids:  # only sessions actually processed
            db.set_session_state(sid, "split")
        return {
            "num_sessions": len(processed_sids),
            "num_clips": len(rows),
            "run_uuid": run_uuid,
            "elapsed_s": time.monotonic() - t0,
        }
    finally:
        db.close()


def _session_uuid(session_id: str) -> str:
    """Deterministic session uuid, derived from the name so re-splitting
    upserts the same rows (data/model.py's uuid5 chain)."""
    return str(deterministic_id("av-session", session_id))


def run_av_caption(args: AVPipelineArgs, *, engine=None) -> dict:
    """Caption split clips (state 'split') with the AV prompt; store in db."""
    t0 = time.monotonic()
    db = open_state_db(args.resolved_db)
    tok = default_caption_tokenizer()
    variants = [args.caption_prompt_variant, *args.extra_caption_variants]
    prompts = {v: get_caption_prompt(v) for v in variants}
    variant_req: dict[str, tuple[list[int], int]] = {}  # filled once engine exists
    try:
        todo = db.clips(state="split")
        if args.limit:
            todo = todo[: args.limit]
        # gather work BEFORE building the engine: a no-op resume run must
        # not pay the full model load
        w = max(1, args.caption_window_frames)

        def clip_windows(frames: "np.ndarray") -> list["np.ndarray"]:
            """Fixed-size caption windows; the ragged tail is padded to w by
            repeating the last frame, as the reference pads it for its
            compiler: the padded window is what gets captioned, so the
            padding decides the caption and the port keeps it."""
            wins = []
            for i in range(0, frames.shape[0], w):
                win = frames[i : i + w]
                if win.shape[0] < w:
                    pad = np.repeat(win[-1:], w - win.shape[0], axis=0)
                    win = np.concatenate([win, pad], axis=0)
                wins.append(win)
            return wins

        num_windows = 0
        num_captioned = 0
        # chunked gather→caption→store: memory stays bounded by chunk size,
        # not the full backlog of decoded frames; within a chunk the fetch+
        # decode fans out over a thread pool (downloaders.prefetch_clips) so
        # the engine overlaps with IO
        chunk_size = 32
        for start in range(0, len(todo), chunk_size):
            chunk_pending = [
                (cid, frames)
                for cid, frames in prefetch_clips(
                    todo[start : start + chunk_size],
                    args.output_path,
                    target_fps=AV_CAPTION_FPS,
                    resize_hw=(224, 224),
                )
                if frames.shape[0] > 0
            ]
            if not chunk_pending:
                continue
            if engine is None:
                engine = CaptionEngine(VLM_BASE, max_batch=8, device=args.device)
                engine.setup()
            if not variant_req:
                # per-variant prompt ids + clamped generation budget are
                # loop-invariant (windows are padded to exactly w frames):
                # encode once, not per window
                for v in variants:
                    ids = tok.encode(prompts[v])
                    variant_req[v] = (ids, engine.fit_max_new_tokens(96, ids, n_frames=w))
            for cid, frames in chunk_pending:
                windows = clip_windows(frames)
                for variant in variants:
                    # primary variant captions every window; extras front-only
                    sel = windows if variant == variants[0] else windows[:1]
                    for k, win in enumerate(sel):
                        num_windows += 1
                        # prompt + clamped budget computed once per variant
                        # (fit_max_new_tokens keeps the vision block from
                        # being rejected on small-context configs)
                        ids, max_new = variant_req[variant]
                        engine.add_request(
                            CaptionRequest(
                                request_id=f"{cid}::{variant}::w{k}",
                                prompt_ids=ids,
                                frames=win,
                                frame_fps=AV_CAPTION_FPS,
                                sampling=SamplingConfig(max_new_tokens=max_new),
                            )
                        )
            num_captioned += len(chunk_pending)
            for res in engine.run_until_complete():
                cid_variant, _, wtag = res.request_id.rpartition("::")
                cid, _, variant = cid_variant.rpartition("::")
                k = int(wtag[1:])
                name = "default" if variant == variants[0] else variant
                if k == 0:
                    # window 0 of the primary fills clips.caption + advances
                    db.set_caption(cid, res.text, name)
                else:
                    # later windows: stored per window (a caption list per
                    # variant over the caption windows)
                    db.set_caption(cid, res.text, f"{name}#w{k}")
        if num_captioned == 0:
            return {"num_captioned": 0, "tokens_per_s": 0.0, "elapsed_s": time.monotonic() - t0}
        return {
            "num_captioned": num_captioned,
            "num_windows": num_windows,
            "num_variants": len(variants),
            "tokens_per_s": engine.tokens_per_second,
            "elapsed_s": time.monotonic() - t0,
        }
    finally:
        db.close()


def run_av_annotate(args: AVPipelineArgs) -> dict:
    """Write per-clip annotation JSON artifacts + clip_caption DB rows
    (pipelines/av/annotation_writer.py)."""
    t0 = time.monotonic()
    db = open_state_db(args.resolved_db)
    run_id = str(uuid.uuid4())
    try:
        counts = write_clip_annotations(
            db,
            args.output_path,
            run_id=run_id,
            dataset=args.dataset_name,
            window_frames=args.caption_window_frames,
            framerate=AV_CAPTION_FPS,
            limit=args.limit,
        )
        db.add_run(
            RunRow(
                run_uuid=run_id,
                run_type="annotate",
                pipeline_version=__version__,
                params=json.dumps(dataclasses.asdict(args)),
            )
        )
        return {**counts, "run_uuid": run_id, "elapsed_s": time.monotonic() - t0}
    finally:
        db.close()


def run_av_package(args: AVPipelineArgs, *, encoder=None) -> dict:
    """Package captioned clips into the cosmos-predict2 dataset layout:
    ``datasets/{name}/videos/{view}/{uuid}.mp4``,
    ``metas/{view}/{uuid}.txt`` and ``t5_xxl/{view}/{uuid}.pkl``, one T5
    embedding a caption window from ``T5_BASE`` on ``args.device``. Clip
    state advances to 'packaged'; sessions whose clips are all packaged
    advance too.
    """
    t0 = time.monotonic()
    root = args.output_path.rstrip("/")
    db = open_state_db(args.resolved_db)
    try:
        todo = db.clips(state="captioned")
        if args.limit:
            todo = todo[: args.limit]
        if not todo:
            return {"num_packaged": 0, "elapsed_s": time.monotonic() - t0}
        if encoder is None:
            encoder = T5EncoderTPU(T5_BASE, device=args.device)
            encoder.setup()
        packaged = 0
        windows = [_window_texts(db, r.clip_uuid, r.caption) for r in todo]
        flat = [t for ws in windows for t in ws]
        encoded = iter(encoder.encode(flat))
        per_clip = [[next(encoded) for _ in ws] for ws in windows]
        for row, encs in zip(todo, per_clip):
            try:
                clip_bytes = read_bytes(f"{root}/clips/{row.clip_uuid}.mp4")
            except FileNotFoundError:
                logger.warning("clip %s missing on disk; skipping", row.clip_uuid)
                continue
            write_cosmos_predict2_clip(
                root,
                args.dataset_name,
                row.camera,
                row.clip_uuid,
                video_bytes=clip_bytes,
                caption=row.caption,
                t5_embeddings=[e.embedding for e in encs],
            )
            db.set_clip_state(row.clip_uuid, "packaged")
            packaged += 1
        # sessions whose clips are all packaged advance
        for sid, _, _state in db.sessions():
            states = {c.state for c in db.clips(session_id=sid)}
            if states and states <= {"packaged"}:
                db.set_session_state(sid, "packaged")
        return {"num_packaged": packaged, "elapsed_s": time.monotonic() - t0}
    finally:
        db.close()


def run_av_shard(args: AVPipelineArgs) -> dict:
    summary = {}
    if args.t5_packaging in ("e", "h"):
        summary |= _shard_t5_packaging(args)
    if args.clip_packaging:
        summary |= _shard_clip_packaging(args)
    return summary | run_shard(
        ShardPipelineArgs(
            input_path=args.output_path,
            output_path=f"{args.output_path.rstrip('/')}/shards",
        )
    )


def _window_texts(db, clip_uuid: str, fallback: str) -> list[str]:
    """Per-clip caption window texts (window k of the primary variant is
    stored as 'default#wk' by run_av_caption)."""
    vc = db.variant_captions(clip_uuid)
    wins = [vc.get("default", fallback)]
    k = 1
    while f"default#w{k}" in vc:
        wins.append(vc[f"default#w{k}"])
        k += 1
    return wins


def _shard_clip_packaging(args: AVPipelineArgs) -> dict:
    """Mp4 clip-session tars: each synchronized span's
    per-camera clips + exact per-frame timestamps (from the MP4 sample
    tables) tar up together."""
    root = args.output_path.rstrip("/")
    db = open_state_db(args.resolved_db)
    try:
        # group FIRST (rows only), then read + tar one clip-session at a
        # time — memory is bounded by a single session's clips, not the
        # whole dataset's mp4 bytes
        by_span: dict[tuple, list] = {}
        for row in db.clips():
            if row.state not in ("captioned", "packaged"):
                continue
            key = (row.session_id, round(row.span_start, 3), round(row.span_end, 3))
            by_span.setdefault(key, []).append(row)
        num_tars = 0
        for key, rows in by_span.items():
            csu = uuid.uuid5(uuid.NAMESPACE_URL, f"{key[0]}:{key[1]}:{key[2]}")
            sample = ClipSessionMedia(session_uuid=str(csu))
            for row in rows:
                try:
                    data = read_bytes(f"{root}/clips/{row.clip_uuid}.mp4")
                except FileNotFoundError:
                    logger.warning(
                        "clip %s missing; skipping from clip tar", row.clip_uuid
                    )
                    continue
                try:
                    idx = parse_mp4_video_index(data)
                    ts_ms = [int(round(t * 1000)) for t in idx.pts_s]
                except Mp4ParseError:
                    ts_ms = []
                sample.cameras[row.camera] = CameraClipMedia(
                    video_bytes=data, timestamps_ms=ts_ms
                )
            if sample.cameras:
                package_clip_sessions(
                    [sample], root, args.dataset_name, log_summary=False
                )
                num_tars += 1
        logger.info("packaged %d clip-session tars for %s", num_tars, args.dataset_name)
        return {"num_clip_tars": num_tars}
    finally:
        db.close()


def _shard_t5_packaging(args: AVPipelineArgs) -> dict:
    """Shard-time T5 tar packaging: regroup the per-clip
    ``t5_xxl/{view}/{uuid}.pkl`` files written by ``av package`` into
    clip-session tars (E) or hierarchical part tars (H).

    A "clip-session" is one synchronized span across a session's cameras,
    grouped here by
    (session_id, span_start, span_end), NOT by whole session, so every clip
    of a long multi-clip camera lands in its own tar.
    """
    root = args.output_path.rstrip("/")
    db = open_state_db(args.resolved_db)
    try:
        by_span: dict[tuple, SessionSample] = {}
        for row in db.clips(state="packaged"):
            path = (
                f"{root}/datasets/{args.dataset_name}/t5_xxl/{row.camera}/"
                f"{row.clip_uuid}.pkl"
            )
            try:
                embeddings = pickle.loads(read_bytes(path))
            except FileNotFoundError:
                logger.warning("no packaged t5 for clip %s; skipping", row.clip_uuid)
                continue
            key = (row.session_id, round(row.span_start, 3), round(row.span_end, 3))
            if key not in by_span:
                by_span[key] = SessionSample(
                    session_uuid=t5_session_uuid(
                        row.session_id, row.span_start, row.span_end
                    )
                )
            # window frame indices are in caption-frame space (clips are
            # captioned at AV_CAPTION_FPS, run_av_caption); window k spans
            # [k*w, min((k+1)*w, n)) caption frames
            n_frames = max(
                1, int(round((row.span_end - row.span_start) * AV_CAPTION_FPS))
            )
            caps = _window_texts(db, row.clip_uuid, row.caption)
            n_win = len(embeddings)
            # run_av_caption windows are caption_window_frames wide with a
            # ragged tail — use the SAME width, not a reconstruction
            w = max(1, args.caption_window_frames)
            by_span[key].cameras[row.camera] = CameraWindows(
                clip_uuid=row.clip_uuid,
                captions=[
                    caps[i] if i < len(caps) else row.caption for i in range(n_win)
                ],
                embeddings=list(embeddings),
                window_start_frames=[i * w for i in range(n_win)],
                window_end_frames=[min((i + 1) * w, n_frames) for i in range(n_win)],
            )
        samples = list(by_span.values())
        if args.t5_packaging == "e":
            tars = package_t5_embeddings_e(samples, root, args.dataset_name)
        else:
            tars = package_t5_embeddings_h(samples, root, args.dataset_name)
        return {"num_t5_tars": len(tars), "t5_packaging": args.t5_packaging}
    finally:
        db.close()
