"""AV dataset packaging writers (port of
``cosmos_curate_tpu/pipelines/av/packaging.py``; host code, numpy).

- :func:`write_cosmos_predict2_clip`: per clip,
  ``datasets/{name}/videos/{view}/{uuid}.mp4``,
  ``metas/{view}/{uuid}.txt`` and ``t5_xxl/{view}/{uuid}.pkl`` (the
  cosmos-predict2 layout); :func:`write_prefix_embeddings_cache` its
  per-view prompt-prefix embedding cache.
- :func:`package_clip_sessions`: one mp4 tar a clip-session, each camera's
  clip, per-frame timestamps and, where given, its trajectory.
- :func:`package_t5_embeddings_e` (embeddings first): one tar a
  clip-session a T5 variant at ``datasets/{name}/{variant}/{session}.tar``
  holding ``{session}.{camera}.bin`` + ``{session}.{camera}.json``.
- :func:`package_t5_embeddings_h` (hierarchical): window-indexed tars at
  ``datasets/{name}/{variant}/part_{p:06d}/t5_{i:06d}.tar``, each with a
  ``t5_{i:06d}.json`` metadata map, a bounded number of embeddings a tar
  and of tars a part.

Every write goes through the URL-aware storage client, so the layout lands
on a local root or in object storage alike. Embeddings are pickled numpy
arrays; tars are deterministic (sorted entries, fixed mtime).
"""

from __future__ import annotations

import io
import json
import pickle
import tarfile
import uuid
from dataclasses import dataclass, field

import numpy as np

from cosmos_curate_tpu_torch.storage.client import write_bytes
from cosmos_curate_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)


@dataclass
class CameraWindows:
    """One camera's contribution to a clip-session: per-window captions and
    T5 embeddings (index k = caption window k)."""

    clip_uuid: str
    captions: list[str] = field(default_factory=list)
    embeddings: list[np.ndarray] = field(default_factory=list)
    window_start_frames: list[int] = field(default_factory=list)
    window_end_frames: list[int] = field(default_factory=list)


@dataclass
class SessionSample:
    """A clip-session across its cameras."""

    session_uuid: str
    cameras: dict[str, CameraWindows] = field(default_factory=dict)


def _tar_bytes(items: list[tuple[bytes, str]]) -> bytes:
    """Deterministic in-memory tar."""
    buf = io.BytesIO()
    with tarfile.open(fileobj=buf, mode="w") as tf:
        for data, name in items:
            info = tarfile.TarInfo(name)
            info.size = len(data)
            info.mtime = 0
            tf.addfile(info, io.BytesIO(data))
    return buf.getvalue()


def predict2_paths(root: str, dataset: str, camera: str, clip_uuid: str) -> dict[str, str]:
    base = f"{root.rstrip('/')}/datasets/{dataset}"
    return {
        "video": f"{base}/videos/{camera}/{clip_uuid}.mp4",
        "meta": f"{base}/metas/{camera}/{clip_uuid}.txt",
        "t5": f"{base}/t5_xxl/{camera}/{clip_uuid}.pkl",
    }


def write_cosmos_predict2_clip(
    root: str,
    dataset: str,
    camera: str,
    clip_uuid: str,
    *,
    video_bytes: bytes,
    caption: str,
    t5_embeddings: list[np.ndarray],
) -> dict[str, str]:
    """Write one clip's predict2 triplet; returns the three paths.

    ``t5_embeddings`` is the per-caption-window embedding list (one T5
    embedding a window; a single-window clip pickles a one-element list)."""
    paths = predict2_paths(root, dataset, camera, clip_uuid)
    write_bytes(paths["video"], video_bytes)
    write_bytes(paths["meta"], caption.encode())
    write_bytes(paths["t5"], pickle.dumps([np.asarray(e) for e in t5_embeddings]))
    return paths


def write_prefix_embeddings_cache(
    root: str,
    dataset: str,
    camera: str,
    prefix_embeddings: dict[str, np.ndarray],
) -> str:
    """The predict2 per-view prompt-prefix embedding cache."""
    path = f"{root.rstrip('/')}/datasets/{dataset}/cache/prefix_t5_embeddings_{camera}.pkl"
    write_bytes(path, pickle.dumps({k: np.asarray(v) for k, v in prefix_embeddings.items()}))
    return path


@dataclass
class CameraClipMedia:
    """One camera's media for a clip-session tar."""

    video_bytes: bytes
    timestamps_ms: list[int] = field(default_factory=list)
    trajectory: np.ndarray | None = None


@dataclass
class ClipSessionMedia:
    session_uuid: str
    cameras: dict[str, CameraClipMedia] = field(default_factory=dict)


def package_clip_sessions(
    samples: list["ClipSessionMedia"],
    root: str,
    dataset: str,
    *,
    subdir: str = "clips",
    log_summary: bool = True,
) -> list[str]:
    """Mp4 clip-session tars: one tar per clip-session holding, per
    camera, ``{session}.{camera}.mp4`` (the encoded clip),
    ``{session}.{camera}.json`` (per-frame timestamps as
    ``[{"frame_num": n, "timestamp": ms}, ...]``) and optionally
    ``{session}.{camera}.bin`` (the egomotion trajectory)."""
    base = f"{root.rstrip('/')}/datasets/{dataset}/{subdir}"
    written: list[str] = []
    for sample in samples:
        items: list[tuple[bytes, str]] = []
        for camera in sorted(sample.cameras):
            media = sample.cameras[camera]
            name = f"{sample.session_uuid}.{camera}"
            items.append((media.video_bytes, f"{name}.mp4"))
            meta = [
                {"frame_num": i, "timestamp": int(ts_ms)}
                for i, ts_ms in enumerate(media.timestamps_ms)
            ]
            items.append((json.dumps(meta).encode(), f"{name}.json"))
            if media.trajectory is not None:
                items.append((np.asarray(media.trajectory).tobytes(), f"{name}.bin"))
        path = f"{base}/{sample.session_uuid}.tar"
        write_bytes(path, _tar_bytes(items))
        written.append(path)
    if log_summary:
        logger.info("packaged %d clip-session tars under %s", len(written), base)
    return written


def t5_session_uuid(session_id: str, span_start: float, span_end: float) -> str:
    """Deterministic clip-session id keying the packaged tars (span-keyed
    uuid5). Single source of truth shared by the shard packer and the
    annotation DB rows."""
    return str(
        uuid.uuid5(
            uuid.NAMESPACE_URL,
            f"{session_id}:{round(span_start, 3)}:{round(span_end, 3)}",
        )
    )


def t5_session_tar_url(
    root: str,
    dataset: str,
    session_id: str,
    span_start: float,
    span_end: float,
    variant: str = "t5_xxl",
) -> str:
    """The exact tar URL ``package_t5_embeddings_e`` writes for one
    clip-session — annotation DB rows must record THIS url, not a
    lookalike."""
    csu = t5_session_uuid(session_id, span_start, span_end)
    return f"{root.rstrip('/')}/datasets/{dataset}/{variant}/{csu}.tar"


def package_t5_embeddings_e(
    samples: list[SessionSample],
    root: str,
    dataset: str,
    *,
    variant: str = "t5_xxl",
    window: int = 0,
) -> list[str]:
    """Embeddings-first tars: one tar per clip-session for ONE T5 variant.

    A ``SessionSample`` carries one variant's per-WINDOW embeddings, so a
    multi-variant dataset calls this once per variant with that variant's
    samples.
    Tar members per camera: ``{session}.{camera}.bin`` (pickled embedding
    for ``window``) and ``{session}.{camera}.json`` holding
    ``[clip_uuid, [caption], [start_frame], [end_frame]]``.
    """
    written: list[str] = []
    base = f"{root.rstrip('/')}/datasets/{dataset}"
    for sample in samples:
        items: list[tuple[bytes, str]] = []
        for camera in sorted(sample.cameras):
            cw = sample.cameras[camera]
            if window >= len(cw.embeddings):
                logger.warning(
                    "session %s camera %s lacks window %d embedding; skipping member",
                    sample.session_uuid, camera, window,
                )
                continue
            name = f"{sample.session_uuid}.{camera}"
            items.append((pickle.dumps(np.asarray(cw.embeddings[window])), f"{name}.bin"))
            meta = [
                cw.clip_uuid,
                [cw.captions[window] if window < len(cw.captions) else ""],
                [cw.window_start_frames[window] if window < len(cw.window_start_frames) else 0],
                [cw.window_end_frames[window] if window < len(cw.window_end_frames) else 0],
            ]
            items.append((json.dumps(meta).encode(), f"{name}.json"))
        path = f"{base}/{variant}/{sample.session_uuid}.tar"
        write_bytes(path, _tar_bytes(items))
        written.append(path)
    logger.info("packaged %d embeddings-first tars under %s", len(written), base)
    return written


def package_t5_embeddings_h(
    samples: list[SessionSample],
    root: str,
    dataset: str,
    *,
    variant: str = "t5_xxl",
    window: int = 0,
    embeddings_per_tar: int = 16,
    tars_per_part: int = 1000,
) -> list[str]:
    """Hierarchical tars: sessions accumulate into fixed-size tars grouped
    into parts — ``{variant}/part_{p:06d}/t5_{i:06d}.tar`` plus a sidecar
    ``t5_{i:06d}.json`` mapping session → camera → metadata
    (T5EmbeddingPackagingStageH's layout)."""
    base = f"{root.rstrip('/')}/datasets/{dataset}/{variant}"
    written: list[str] = []
    items: list[tuple[bytes, str]] = []
    metadata: dict[str, dict[str, list]] = {}
    tar_idx = 0

    def flush() -> None:
        nonlocal items, metadata, tar_idx
        if not items:
            return
        part = tar_idx // tars_per_part
        prefix = f"{base}/part_{part:06d}/t5_{tar_idx % tars_per_part:06d}"
        write_bytes(f"{prefix}.tar", _tar_bytes(items))
        write_bytes(f"{prefix}.json", json.dumps(metadata).encode())
        written.append(f"{prefix}.tar")
        items, metadata = [], {}
        tar_idx += 1

    count = 0
    for sample in samples:
        for camera in sorted(sample.cameras):
            cw = sample.cameras[camera]
            if window >= len(cw.embeddings):
                continue
            name = f"{sample.session_uuid}.{camera}"
            items.append((pickle.dumps(np.asarray(cw.embeddings[window])), f"{name}.bin"))
            metadata.setdefault(sample.session_uuid, {})[camera] = [
                dataset,
                [cw.captions[window] if window < len(cw.captions) else ""],
                [cw.window_start_frames[window] if window < len(cw.window_start_frames) else 0],
                [cw.window_end_frames[window] if window < len(cw.window_end_frames) else 0],
            ]
            count += 1
            if count % embeddings_per_tar == 0:
                flush()
    flush()
    logger.info("packaged %d hierarchical tars under %s", len(written), base)
    return written
