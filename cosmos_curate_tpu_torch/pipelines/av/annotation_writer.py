"""AV annotation writers: per-clip JSON artifacts and ``clip_caption`` DB
rows (port of ``cosmos_curate_tpu/pipelines/av/annotation_writer.py``; host
code).

The JSON layout:

- ``{prefix}/metas/{clip_uuid}.json``: one annotation document a clip
  (identity, span, per-variant caption chains, geometry);
- ``{prefix}/processed_sessions/{session}.json``: the session's record;
- ``{prefix}/processed_session_chunks/{session}_{chunk}.json``: the chunk
  record (whole sessions are processed: chunk 0);

and the ``clip_caption`` rows: per (clip, version, prompt_type) the window
frame bounds, window captions, the packaged T5 tar's URL
(``datasets/{dataset}/{variant}/{session}.tar``, packaging.py
``package_t5_embeddings_e``) and the run id. Every JSON write goes through
the URL-aware storage client.
"""

from __future__ import annotations

from typing import Any

from cosmos_curate_tpu_torch.pipelines.av.packaging import t5_session_tar_url
from cosmos_curate_tpu_torch.pipelines.av.state_db import (
    CAPTION_VERSION,
    CaptionAnnotationRow,
    parse_caption_variant,
)
from cosmos_curate_tpu_torch.storage.writers import write_json
from cosmos_curate_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)


def _caption_chain(variants: dict[str, str], base: str) -> list[tuple[int, str]]:
    """Ordered (window_index, caption) pairs for one prompt variant:
    window 0 is the bare variant name, later windows ride as
    ``{base}#w{k}`` — parsed with the SAME rule the state db uses
    (state_db.parse_caption_variant), so a variant name that merely
    contains '#w' round-trips instead of being dropped. The PARSED index
    travels with the text so frame bounds stay correct when a middle
    window's caption is absent (e.g. a failed request on resume)."""
    chain = [
        (k, text)
        for name, text in variants.items()
        for b, k in (parse_caption_variant(name),)
        if b == base
    ]
    return sorted(chain)


def write_clip_annotations(
    db,
    output_prefix: str,
    *,
    version: str = CAPTION_VERSION,
    run_id: str = "",
    dataset: str = "av-dataset",
    window_frames: int = 8,
    framerate: float = 1.0,
    height: int | None = None,
    width: int | None = None,
    states: tuple[str, ...] = ("captioned", "packaged"),
    limit: int = 0,
) -> dict[str, int]:
    """Emit the annotation JSON layout + clip_caption DB rows for every
    captioned clip in ``db`` (at most ``limit`` clips when set). Returns
    artifact counts."""
    prefix = output_prefix.rstrip("/")
    sessions: dict[str, list] = {}
    n_clips = 0
    for state in states:
        for clip in db.clips(state=state):
            if limit and n_clips >= limit:
                break
            sessions.setdefault(clip.session_id, []).append(clip)
            n_clips += 1
    n_meta = n_rows = 0
    for session_id, clips in sorted(sessions.items()):
        rows: list[CaptionAnnotationRow] = []
        for clip in clips:
            variants = db.variant_captions(clip.clip_uuid)
            bases = sorted({parse_caption_variant(v)[0] for v in variants})
            chains = {b: _caption_chain(variants, b) for b in bases}
            # caption-frame space (clips caption at `framerate`); the last
            # window clamps to the clip's actual frame count — matching the
            # bounds run_av_shard packs into the tars (pipeline.py:485)
            clip_frames = max(
                1, int(round((clip.span_end - clip.span_start) * framerate))
            )
            doc: dict[str, Any] = {
                "uuid": clip.clip_uuid,
                "session": session_id,
                "camera": clip.camera,
                "span_start": clip.span_start,
                "span_end": clip.span_end,
                "framerate": framerate,
                "height": height,
                "width": width,
                "captions": {b: [t for _, t in chains[b]] for b in bases},
            }
            write_json(f"{prefix}/metas/{clip.clip_uuid}.json", doc)
            n_meta += 1
            for base in bases:
                chain = chains[base]
                # clip_caption arrays are POSITIONAL (entry k = window k,
                # state_db.py module docstring): emit dense arrays up to the
                # last captioned window, "" where a middle window's caption
                # is absent, so caption-state reads round-trip unchanged
                n_win = chain[-1][0] + 1 if chain else 0
                by_k = dict(chain)
                rows.append(
                    CaptionAnnotationRow(
                        clip_uuid=clip.clip_uuid,
                        version=version,
                        prompt_type=base,
                        window_start_frame=[
                            min(k * window_frames, clip_frames) for k in range(n_win)
                        ],
                        window_end_frame=[
                            min((k + 1) * window_frames, clip_frames)
                            for k in range(n_win)
                        ],
                        window_caption=[by_k.get(k, "") for k in range(n_win)],
                        t5_embedding_url=t5_session_tar_url(
                            prefix, dataset, session_id,
                            clip.span_start, clip.span_end,
                        ),
                        run_uuid=run_id,
                    )
                )
        if rows:
            db.add_caption_annotations(rows)
            n_rows += len(rows)
        session_doc = {
            "session": session_id,
            "num_clips": len(clips),
            "clip_uuids": [c.clip_uuid for c in clips],
            "version": version,
            "run_uuid": run_id,
        }
        write_json(f"{prefix}/processed_sessions/{session_id}.json", session_doc)
        write_json(
            f"{prefix}/processed_session_chunks/{session_id}_0.json",
            {**session_doc, "session_chunk_index": 0},
        )
    logger.info(
        "wrote %d clip annotation JSONs + %d clip_caption rows for %d sessions",
        n_meta, n_rows, len(sessions),
    )
    return {"metas": n_meta, "rows": n_rows, "sessions": len(sessions)}
