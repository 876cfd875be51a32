"""Clip writer stage: persists pipeline output in the curated layout (port
of ``cosmos_curate_tpu/pipelines/video/stages/writer.py``):

    <output>/clips/<clip-uuid>.mp4                       transcoded clip
    <output>/clips/<clip-uuid>/<camera>.mp4              a multicam session's clip,
                                                         each camera's (primary-clip uuid)
    <output>/previews/<clip-uuid>.webp                   preview (when produced)
    <output>/tracking/<clip-uuid>.mp4                    annotated track (when produced)
    <output>/t5_embeddings/<clip-uuid>.npz               T5 caption embeddings,
                                                         ``window_{i}`` keys
    <output>/metas/v0/<clip-uuid>.json                   clip metadata + captions
    <output>/embeddings/<model>/<video-id>-<chunk>.parquet   clip embeddings
    <output>/processed_videos/<video-id>/chunk-<i>.json  resume record

Writing the resume record **last** is the crash-safety contract: a video is
only skipped on re-run if all its chunks finished writing.

A clip meta carries every key of the reference's, the motion scores,
tracks and event captions among them.

With ``index_path`` set, each chunk's embeddings are also appended as a
pending corpus-index fragment (dedup/index_store.py), which the end-of-run
consolidation folds into the index. Fragments carry their model's weights
provenance, and "random" (seeded-init) embeddings are refused unless
``CURATE_INDEX_ALLOW_RANDOM`` opts in; ``stage_perf`` counts
``index_fragment_rows`` and ``index_skipped_random``, and stage_timer's
index aggregate the same adds and refusals under the stage's name.

A multicam session's metas, embeddings, captions and resume record come
from its primary camera alone; each secondary camera's clip lands beside
the primary's under the primary clip's uuid.
"""

from __future__ import annotations

import hashlib
import io
import threading
import time
from collections import defaultdict

import numpy as np

from cosmos_curate_tpu_torch.core.stage import Resources, Stage
from cosmos_curate_tpu_torch.data.model import Clip, ClipStats, SplitPipeTask
from cosmos_curate_tpu_torch.dedup.index_store import IndexStore, allow_random_provenance
from cosmos_curate_tpu_torch.models.registry import weights_provenance
from cosmos_curate_tpu_torch.observability.stage_timer import record_index_ops
from cosmos_curate_tpu_torch.storage.client import write_bytes
from cosmos_curate_tpu_torch.storage.writers import write_json, write_parquet
from cosmos_curate_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)


def video_record_id(path: str) -> str:
    return hashlib.sha256(path.encode()).hexdigest()[:24]


def _clip_meta(clip: Clip, provenance: dict | None = None) -> dict:
    meta = {
        "uuid": str(clip.uuid),
        "source_video": clip.source_video,
        "span_start": clip.span[0],
        "span_end": clip.span[1],
        "duration_s": clip.duration_s,
        "codec": clip.encoding_codec,
        "motion_score_global": clip.motion_score_global,
        "motion_score_per_patch_min": clip.motion_score_per_patch_min,
        "aesthetic_score": clip.aesthetic_score,
        "artificial_text_score": clip.artificial_text_score,
        "semantic_pass": clip.semantic_pass,
        "filtered_by": clip.filtered_by,
        "duplicate_of": clip.duplicate_of,
        "embedding_models": sorted(clip.embeddings),
        "tracks": clip.tracks,
        "event_captions": clip.event_captions,
        "windows": [
            {
                "start_frame": w.start_frame,
                "end_frame": w.end_frame,
                "captions": w.caption,
                "enhanced_captions": w.enhanced_caption,
                "has_t5_embedding": w.t5_embedding is not None,
            }
            for w in clip.windows
        ],
        "errors": clip.errors,
    }
    if provenance:
        # per-model weights provenance: "checkpoint:<sha256-12>" or "random"
        meta["weights_provenance"] = {m: provenance[m] for m in sorted(clip.embeddings) if m in provenance}
    return meta


class ClipWriterStage(Stage[SplitPipeTask, SplitPipeTask]):
    def __init__(self, output_path: str, *, index_path: str = "") -> None:
        self.output_path = output_path.rstrip("/")
        # corpus-index root for in-pipeline fragment appends ("" disables)
        self.index_path = index_path.rstrip("/")
        # model -> weights_provenance, memoized per stage instance
        self._provenance_memo: dict[str, str] = {}
        self._memo_lock = threading.Lock()
        self._warned_random_models: set[str] = set()
        # one IndexStore for the run (built on the first fragment)
        self._index_store: IndexStore | None = None

    def __getstate__(self) -> dict:
        # the streaming engine ships the stage to its worker processes: the
        # lock and the run's index store are made anew there
        state = dict(self.__dict__)
        state.pop("_memo_lock")
        state["_index_store"] = None
        return state

    def __setstate__(self, state: dict) -> None:
        self.__dict__.update(state)
        self._memo_lock = threading.Lock()

    @property
    def resources(self) -> Resources:
        return Resources(cpus=0.5)

    @property
    def thread_safe(self) -> bool:
        # every task writes its own files; the provenance memo is guarded
        return True

    def process_data(self, tasks: list[SplitPipeTask]) -> list[SplitPipeTask]:
        for task in tasks:
            video = task.video
            stats = ClipStats()
            embedding_rows: dict[str, list[tuple[str, np.ndarray]]] = defaultdict(list)
            for clip in video.clips:
                self._write_clip(clip, stats, embedding_rows, camera=video.camera if task.is_multicam else "")
            if task.is_multicam:
                self._write_aux_cameras(task, stats)
            for clip in video.filtered_clips:
                stats.num_clips += 1
                self._count_filtered(clip, stats)
                write_json(f"{self.output_path}/metas/filtered/{clip.uuid}.json",
                           _clip_meta(clip, self._model_provenance(clip)))
            chunk_tag = f"{video_record_id(video.path)}-{video.clip_chunk_index:05d}"
            for model, rows in embedding_rows.items():
                write_parquet(
                    f"{self.output_path}/embeddings/{model}/{chunk_tag}.parquet",
                    {
                        "clip_uuid": [r[0] for r in rows],
                        "embedding": [r[1].astype(np.float32).tolist() for r in rows],
                    },
                )
                if self.index_path:
                    self._write_index_fragment(chunk_tag, model, rows, task)
            self._write_resume_record(task)
            # free payloads (kept AND filtered clips): downstream only needs
            # stats and metadata
            for clip in (*video.clips, *video.filtered_clips):
                clip.encoded_data = None
                clip.webp_preview = None
                clip.annotated_mp4 = None
                clip.release_frames()
                for w in clip.windows:
                    w.frames = None
                    w.t5_embedding = None  # persisted above
            task.stage_perf["clips_written"] = stats.num_clips
            with self._memo_lock:
                memo = dict(self._provenance_memo)
            if memo:
                # rides the task back to run_split: build_summary unions
                # these into summary.json's weights_provenance map
                task.stage_perf["weights_provenance"] = memo
            task.stats = stats
        return tasks

    def _model_provenance(self, clip: Clip) -> dict:
        """Weights provenance per embedding model on ``clip``, memoized."""
        out: dict[str, str] = {}
        for model in clip.embeddings:
            with self._memo_lock:
                if model not in self._provenance_memo:
                    try:
                        self._provenance_memo[model] = weights_provenance(model)
                    except OSError:  # provenance must never fail a write
                        self._provenance_memo[model] = "unknown"
                out[model] = self._provenance_memo[model]
        return out

    def _write_index_fragment(self, chunk_tag: str, model: str, rows: list, task: SplitPipeTask) -> None:
        """Append this chunk's embeddings as a pending corpus-index fragment.
        Chunk tags scope fragments to disjoint files, so the stage stays
        thread-safe. Random-provenance embeddings are refused here, before
        they can reach the index, unless CURATE_INDEX_ALLOW_RANDOM opts in."""
        provenance = weights_provenance(model)
        if provenance == "random" and not allow_random_provenance():
            with self._memo_lock:
                warn = model not in self._warned_random_models
                self._warned_random_models.add(model)
            if warn:
                logger.warning("not indexing %s embeddings: weights provenance is random (stage a checkpoint, "
                               "or set CURATE_INDEX_ALLOW_RANDOM=1)", model)
            record_index_ops(self.name, skipped_random=len(rows))
            task.stage_perf["index_skipped_random"] = task.stage_perf.get("index_skipped_random", 0) + len(rows)
            return
        t0 = time.monotonic()
        with self._memo_lock:
            if self._index_store is None:
                self._index_store = IndexStore(self.index_path)
            store = self._index_store
        store.write_pending_fragment(f"{chunk_tag}-{model}", [r[0] for r in rows],
                                     np.stack([r[1].astype(np.float32) for r in rows]), model=model,
                                     provenance=provenance)
        record_index_ops(self.name, adds=len(rows), add_s=time.monotonic() - t0)
        task.stage_perf["index_fragment_rows"] = task.stage_perf.get("index_fragment_rows", 0) + len(rows)

    def _write_aux_cameras(self, task: SplitPipeTask, stats: ClipStats) -> None:
        """Secondary cameras land beside the primary under the clip's
        directory, ``clips/<primary-uuid>/<camera>.mp4``. A secondary clip
        matches the primary's by span start (a shorter camera lacks the
        tail clips)."""
        for aux in task.aux_videos:
            by_start = {round(c.span[0], 6): c for c in aux.clips}
            for primary_clip in task.video.clips:
                aux_clip = by_start.get(round(primary_clip.span[0], 6))
                if aux_clip is None or not aux_clip.encoded_data:
                    continue
                write_bytes(f"{self.output_path}/clips/{primary_clip.uuid}/{aux.camera}.mp4", aux_clip.encoded_data)
                aux_clip.encoded_data = None
                stats.num_transcoded += 1

    def _write_clip(self, clip: Clip, stats: ClipStats, embedding_rows, *, camera: str = "") -> None:
        stats.num_clips += 1
        stats.total_clip_duration_s += clip.duration_s
        stats.max_clip_duration_s = max(stats.max_clip_duration_s, clip.duration_s)
        if clip.encoded_data:
            dest = (f"{self.output_path}/clips/{clip.uuid}/{camera}.mp4" if camera
                    else f"{self.output_path}/clips/{clip.uuid}.mp4")
            write_bytes(dest, clip.encoded_data)
            clip.encoded_byte_size = len(clip.encoded_data)
            clip.encoded_sha256 = hashlib.sha256(clip.encoded_data).hexdigest()
            clip.encoded_url = dest
            stats.num_transcoded += 1
        if clip.webp_preview:
            write_bytes(f"{self.output_path}/previews/{clip.uuid}.webp", clip.webp_preview)
            stats.num_with_webp += 1
        if clip.annotated_mp4:
            write_bytes(f"{self.output_path}/tracking/{clip.uuid}.mp4", clip.annotated_mp4)
        for model, emb in clip.embeddings.items():
            embedding_rows[model].append((str(clip.uuid), emb))
        if clip.embeddings:
            stats.num_with_embeddings += 1
        if any(w.caption for w in clip.windows):
            stats.num_with_captions += 1
        t5 = {f"window_{i}": w.t5_embedding for i, w in enumerate(clip.windows) if w.t5_embedding is not None}
        if t5:
            sink = io.BytesIO()
            np.savez(sink, **t5)
            write_bytes(f"{self.output_path}/t5_embeddings/{clip.uuid}.npz", sink.getvalue())
        write_json(f"{self.output_path}/metas/v0/{clip.uuid}.json", _clip_meta(clip, self._model_provenance(clip)))

    @staticmethod
    def _count_filtered(clip: Clip, stats: ClipStats) -> None:
        key = clip.filtered_by
        if key == "motion":
            stats.num_filtered_by_motion += 1
        elif key == "aesthetic":
            stats.num_filtered_by_aesthetic += 1
        elif key == "text":
            stats.num_filtered_by_text += 1
        elif key == "semantic":
            stats.num_filtered_by_semantic += 1
        elif key == "dedup":
            stats.num_filtered_by_dedup += 1

    def _write_resume_record(self, task: SplitPipeTask) -> None:
        # one record per chunk; a video counts as processed when the number
        # of chunk records matches num_chunks (input_discovery checks)
        video = task.video
        vid = video_record_id(video.path)
        write_json(
            f"{self.output_path}/processed_videos/{vid}/chunk-{video.clip_chunk_index:05d}.json",
            {
                "path": video.path,
                "chunk_index": video.clip_chunk_index,
                "num_chunks": video.num_clip_chunks,
                "num_clips_total": video.num_total_clips,
                "duration_s": video.metadata.duration_s,
                "errors": video.errors,
            },
        )
