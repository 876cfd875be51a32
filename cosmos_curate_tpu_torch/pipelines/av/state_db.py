"""AV pipeline state database (port of
``cosmos_curate_tpu/pipelines/av/state_db.py``; host code, no torch).

Sessions and clips move through ingest → split → caption → packaged states
with retried writes. ``AVStateDB`` keeps them in sqlite (stdlib,
serverless), ``PostgresAVStateDB`` in PostgreSQL over the wire client
(utils/pg_client.py), with the same statements in the two dialects'
intersection; ``open_state_db`` picks the backend from the path (a sqlite
file, an object-store sqlite URL pulled and pushed by
``downloaders.RemoteSyncedStateDB``, or a ``postgres://`` DSN).

The tables: ``run`` (one row a pipeline invocation), ``clipped_session``
(one row a split session), ``video_span`` (one row an encoded clip, with
its geometry and content hash), ``clip_caption`` (window caption arrays a
prompt type) and ``clip_tag`` (the ego-motion taxonomy). Captions live
only in ``clip_caption``, whose arrays are positional: entry ``k`` is
caption window ``k``, and a window whose caption has not arrived holds an
empty string. Frame bounds start as ``-1`` placeholders at caption time and
are rewritten with real bounds by the annotation writer
(annotation_writer.py). A pre-existing ``clip_captions`` (variant, caption)
table is migrated into ``clip_caption`` and dropped on open.
"""

from __future__ import annotations

import dataclasses
import json
import sqlite3
import time
from dataclasses import dataclass
from pathlib import Path

from cosmos_curate_tpu_torch.storage.retry import sleep_backoff
from cosmos_curate_tpu_torch.utils.logging import get_logger
from cosmos_curate_tpu_torch.utils.pg_client import PgConnection, PgError, parse_dsn, quote_literal
from cosmos_curate_tpu_torch.utils.retry import retry

logger = get_logger(__name__)

# version tag for caption-state rows written by the caption pipeline; the
# annotation writer defaults to the same tag so its bound/url rewrites land
# on the caption rows rather than beside them
CAPTION_VERSION = "v0"

_SCHEMA = """
CREATE TABLE IF NOT EXISTS sessions (
    session_id TEXT PRIMARY KEY,
    num_cameras INTEGER NOT NULL,
    state TEXT NOT NULL DEFAULT 'ingested',
    created_s REAL NOT NULL
);
CREATE TABLE IF NOT EXISTS clips (
    clip_uuid TEXT PRIMARY KEY,
    session_id TEXT NOT NULL,
    camera TEXT NOT NULL,
    span_start REAL NOT NULL,
    span_end REAL NOT NULL,
    state TEXT NOT NULL DEFAULT 'split',
    caption TEXT DEFAULT '',
    FOREIGN KEY (session_id) REFERENCES sessions (session_id)
);
CREATE INDEX IF NOT EXISTS idx_clips_session ON clips (session_id);
CREATE INDEX IF NOT EXISTS idx_clips_state ON clips (state);
CREATE TABLE IF NOT EXISTS clip_caption (
    clip_uuid TEXT NOT NULL,
    version TEXT NOT NULL,
    prompt_type TEXT NOT NULL,
    window_start_frame TEXT NOT NULL,
    window_end_frame TEXT NOT NULL,
    window_caption TEXT NOT NULL,
    t5_embedding_url TEXT NOT NULL,
    run_uuid TEXT NOT NULL,
    created_s REAL NOT NULL,
    PRIMARY KEY (clip_uuid, version, prompt_type)
);
CREATE TABLE IF NOT EXISTS run (
    run_uuid TEXT PRIMARY KEY,
    run_type TEXT NOT NULL,
    pipeline_version TEXT NOT NULL DEFAULT '',
    description TEXT NOT NULL DEFAULT '',
    params TEXT NOT NULL DEFAULT '{}',
    created_s REAL NOT NULL
);
CREATE TABLE IF NOT EXISTS clipped_session (
    session_uuid TEXT NOT NULL,
    version TEXT NOT NULL,
    source_session TEXT NOT NULL,
    num_cameras INTEGER NOT NULL,
    split_algo_name TEXT NOT NULL,
    encoder TEXT NOT NULL,
    run_uuid TEXT NOT NULL DEFAULT '',
    created_s REAL NOT NULL,
    PRIMARY KEY (session_uuid, version, split_algo_name, encoder)
);
CREATE TABLE IF NOT EXISTS video_span (
    clip_uuid TEXT NOT NULL,
    version TEXT NOT NULL,
    session_uuid TEXT NOT NULL,
    camera TEXT NOT NULL,
    span_index INTEGER NOT NULL,
    split_algo_name TEXT NOT NULL,
    span_start REAL NOT NULL,
    span_end REAL NOT NULL,
    encoder TEXT NOT NULL,
    url TEXT NOT NULL,
    byte_size INTEGER NOT NULL DEFAULT 0,
    duration REAL NOT NULL DEFAULT 0,
    framerate REAL NOT NULL DEFAULT 0,
    num_frames INTEGER NOT NULL DEFAULT 0,
    height INTEGER NOT NULL DEFAULT 0,
    width INTEGER NOT NULL DEFAULT 0,
    sha256 TEXT NOT NULL DEFAULT '',
    run_uuid TEXT NOT NULL DEFAULT '',
    created_s REAL NOT NULL,
    PRIMARY KEY (clip_uuid, version, split_algo_name, encoder)
);
CREATE INDEX IF NOT EXISTS idx_video_span_session ON video_span (session_uuid);
CREATE TABLE IF NOT EXISTS clip_tag (
    clip_uuid TEXT NOT NULL,
    version TEXT NOT NULL,
    country TEXT NOT NULL DEFAULT 'unknown',
    traffic TEXT NOT NULL DEFAULT 'unknown',
    ego_speed TEXT NOT NULL DEFAULT 'unknown',
    ego_acceleration TEXT NOT NULL DEFAULT 'unknown',
    ego_curve TEXT NOT NULL DEFAULT 'unknown',
    ego_turn TEXT NOT NULL DEFAULT 'unknown',
    osm_features TEXT NOT NULL DEFAULT 'unknown',
    road_type TEXT NOT NULL DEFAULT 'unknown',
    visibility TEXT NOT NULL DEFAULT 'unknown',
    road_surface TEXT NOT NULL DEFAULT 'unknown',
    illumination TEXT NOT NULL DEFAULT 'unknown',
    run_uuid TEXT NOT NULL DEFAULT '',
    created_s REAL NOT NULL,
    PRIMARY KEY (clip_uuid, version)
);
"""


def _db_retry(fn):
    """Retried execution for transient lock / busy failures: the shared
    retry helper with sqlite's transient exception."""
    return retry(attempts=5, backoff_s=0.2, exceptions=(sqlite3.OperationalError,))(fn)()


@dataclass
class ClipRow:
    clip_uuid: str
    session_id: str
    camera: str
    span_start: float
    span_end: float
    state: str = "split"
    caption: str = ""


@dataclass
class CaptionAnnotationRow:
    """One clip_caption table row: per-(clip, version, prompt_type)
    window frame bounds + captions and
    the packaged t5 embedding URL. Arrays are positional over caption
    windows; an absent window's caption is an empty string."""

    clip_uuid: str
    version: str
    prompt_type: str
    window_start_frame: list[int]
    window_end_frame: list[int]
    window_caption: list[str]
    t5_embedding_url: str
    run_uuid: str


@dataclass
class RunRow:
    """One pipeline invocation."""

    run_uuid: str
    run_type: str
    pipeline_version: str = ""
    description: str = ""
    params: str = "{}"  # JSON text of pipeline args


@dataclass
class ClippedSessionRow:
    """One split session."""

    session_uuid: str
    version: str
    source_session: str
    num_cameras: int
    split_algo_name: str
    encoder: str
    run_uuid: str = ""


@dataclass
class VideoSpanRow:
    """One encoded clip span with its geometry and content hash.
    ``camera`` is the camera's name."""

    clip_uuid: str
    version: str
    session_uuid: str
    camera: str
    span_index: int
    split_algo_name: str
    span_start: float
    span_end: float
    encoder: str
    url: str
    byte_size: int = 0
    duration: float = 0.0
    framerate: float = 0.0
    num_frames: int = 0
    height: int = 0
    width: int = 0
    sha256: str = ""
    run_uuid: str = ""


@dataclass
class ClipTagRow:
    """Ego-motion / scene tag taxonomy for one clip. Values come from the
    ego-tag enums
    (pipelines/av/ego_tags.py); 'unknown' where no estimator ran."""

    clip_uuid: str
    version: str
    country: str = "unknown"
    traffic: str = "unknown"
    ego_speed: str = "unknown"
    ego_acceleration: str = "unknown"
    ego_curve: str = "unknown"
    ego_turn: str = "unknown"
    osm_features: str = "unknown"
    road_type: str = "unknown"
    visibility: str = "unknown"
    road_surface: str = "unknown"
    illumination: str = "unknown"
    run_uuid: str = ""


# table -> (row dataclass, upsert key columns); the generic add/get paths in
# both backends are driven by this metadata so each new table costs one
# dataclass + one schema block, not four hand-written methods
_GENERIC_TABLES: dict[str, tuple[type, tuple[str, ...]]] = {
    "run": (RunRow, ("run_uuid",)),
    "clipped_session": (
        ClippedSessionRow,
        ("session_uuid", "version", "split_algo_name", "encoder"),
    ),
    "video_span": (VideoSpanRow, ("clip_uuid", "version", "split_algo_name", "encoder")),
    "clip_tag": (ClipTagRow, ("clip_uuid", "version")),
}

# with `from __future__ import annotations` dataclass field types are
# strings; PG result cells arrive as text and need coercing back
_FIELD_COERCE = {"int": int, "float": float, "str": str}


def _generic_columns(table: str) -> list[str]:
    cls, _ = _GENERIC_TABLES[table]
    return [f.name for f in dataclasses.fields(cls)]


def _upsert_sql(table: str, values_sql: str) -> str:
    cls, key = _GENERIC_TABLES[table]
    cols = _generic_columns(table) + ["created_s"]
    # created_s is creation time: a re-run's upsert must not reset it
    non_key = [c for c in cols if c not in key and c != "created_s"]
    return (
        f"INSERT INTO {table} ({', '.join(cols)}) VALUES {values_sql} "
        f"ON CONFLICT({', '.join(key)}) DO UPDATE SET "
        + ", ".join(f"{c} = excluded.{c}" for c in non_key)
    )


def _coerce_row(table: str, raw: tuple):
    cls, _ = _GENERIC_TABLES[table]
    vals = [
        _FIELD_COERCE.get(f.type, str)(v)
        for f, v in zip(dataclasses.fields(cls), raw)
    ]
    return cls(*vals)


def _variants_from_caption_rows(rows) -> dict[str, str]:
    """(prompt_type, window_caption_json) pairs -> {variant_name: caption}:
    entry 0 is the bare prompt type, window k > 0 rides as
    '{prompt_type}#w{k}'. Empty (not-yet-captioned) windows are omitted."""
    out: dict[str, str] = {}
    for prompt_type, caps_json in rows:
        for k, text in enumerate(json.loads(caps_json)):
            if text:
                out[prompt_type if k == 0 else f"{prompt_type}#w{k}"] = text
    return out


class _GenericTablesMixin:
    """The provenance tables' accessors, shared by both
    backends over their ``_add_rows`` / ``_get_rows`` primitives."""

    def add_run(self, row: "RunRow") -> None:
        self._add_rows("run", [row])

    def runs(self, run_type: str | None = None) -> list["RunRow"]:
        return self._get_rows("run", {"run_type": run_type})

    def add_clipped_sessions(self, rows: list["ClippedSessionRow"]) -> None:
        self._add_rows("clipped_session", rows)

    def clipped_sessions(
        self, source_session: str | None = None
    ) -> list["ClippedSessionRow"]:
        return self._get_rows("clipped_session", {"source_session": source_session})

    def add_video_spans(self, rows: list["VideoSpanRow"]) -> None:
        self._add_rows("video_span", rows)

    def video_spans(
        self, clip_uuid: str | None = None, session_uuid: str | None = None
    ) -> list["VideoSpanRow"]:
        return self._get_rows(
            "video_span", {"clip_uuid": clip_uuid, "session_uuid": session_uuid}
        )

    def add_clip_tags(self, rows: list["ClipTagRow"]) -> None:
        self._add_rows("clip_tag", rows)

    def clip_tags(self, clip_uuid: str | None = None) -> list["ClipTagRow"]:
        return self._get_rows("clip_tag", {"clip_uuid": clip_uuid})


def parse_caption_variant(variant: str) -> tuple[str, int]:
    """'default#w3' -> ('default', 3); plain names are window 0. The
    ``#w{k}`` suffix is the storage convention run_av_caption uses for
    later caption windows (pipeline.py run_av_caption)."""
    base, sep, tail = variant.rpartition("#w")
    if sep and tail.isdigit():
        return base, int(tail)
    return variant, 0


def _merge_caption_window(
    existing: tuple[list, list, list] | None, k: int, caption: str
) -> tuple[list, list, list]:
    """Extend the positional (starts, ends, captions) arrays to cover
    window ``k`` and set its caption. New windows get -1 frame-bound
    placeholders (real bounds arrive with the annotation writer)."""
    starts, ends, caps = existing if existing else ([], [], [])
    while len(caps) <= k:
        caps.append("")
        starts.append(-1)
        ends.append(-1)
    caps[k] = caption
    return starts, ends, caps


class AVStateDB(_GenericTablesMixin):
    def __init__(self, path: str) -> None:
        Path(path).parent.mkdir(parents=True, exist_ok=True)
        self._conn = sqlite3.connect(path, timeout=10.0)
        self._conn.executescript(_SCHEMA)
        self._migrate_legacy_captions()

    def _migrate_legacy_captions(self) -> None:
        """Port rows from the pre-round-5 ``clip_captions`` (variant,
        caption) table into ``clip_caption`` window arrays, then drop it.
        Clip states are NOT touched: a packaged clip must not regress to
        'captioned' just because its caption rows moved tables."""
        has = self._conn.execute(
            "SELECT name FROM sqlite_master WHERE type='table' AND name='clip_captions'"
        ).fetchone()
        if not has:
            return
        def migrate():
            with self._conn:
                # write statement FIRST: sqlite takes the database write
                # lock here, so no still-running old-version writer can add
                # a row between our read and the DROP (it would be silently
                # destroyed with the table)
                self._conn.execute("DELETE FROM clip_captions WHERE rowid < 0")
                legacy = list(
                    self._conn.execute(
                        "SELECT clip_uuid, variant, caption FROM clip_captions"
                    )
                )
                for cid, variant, caption in legacy:
                    base, k = parse_caption_variant(variant)
                    self._store_window_caption(cid, base, k, caption)
                self._conn.execute("DROP TABLE clip_captions")
                return legacy

        try:
            legacy = _db_retry(migrate)
        except sqlite3.OperationalError:
            still_there = self._conn.execute(
                "SELECT name FROM sqlite_master WHERE type='table' "
                "AND name='clip_captions'"
            ).fetchone()
            if not still_there:
                # a concurrent opener migrated + dropped first
                return
            # migration failed with legacy data still present: readers
            # would silently see ZERO captions for those clips — refuse
            raise
        if legacy:
            logger.info(
                "migrated %d legacy clip_captions rows into clip_caption", len(legacy)
            )

    def upsert_session(self, session_id: str, num_cameras: int) -> None:
        def op():
            with self._conn:
                self._conn.execute(
                    "INSERT INTO sessions (session_id, num_cameras, created_s) "
                    "VALUES (?, ?, ?) ON CONFLICT(session_id) DO UPDATE SET "
                    "num_cameras = excluded.num_cameras",
                    (session_id, num_cameras, time.time()),
                )
        _db_retry(op)

    def set_session_state(self, session_id: str, state: str) -> None:
        def op():
            with self._conn:
                self._conn.execute(
                    "UPDATE sessions SET state = ? WHERE session_id = ?", (state, session_id)
                )
        _db_retry(op)

    def sessions(self, state: str | None = None) -> list[tuple[str, int, str]]:
        q = "SELECT session_id, num_cameras, state FROM sessions"
        args: tuple = ()
        if state:
            q += " WHERE state = ?"
            args = (state,)
        return list(self._conn.execute(q, args))

    def add_clips(self, rows: list[ClipRow]) -> None:
        # Re-splitting produces the same deterministic clip ids; an existing
        # row's state/caption must survive (a second 'av split' run must not
        # wipe captions) — only identity fields update on conflict.
        def op():
            with self._conn:
                self._conn.executemany(
                    "INSERT INTO clips "
                    "(clip_uuid, session_id, camera, span_start, span_end, state, caption) "
                    "VALUES (?, ?, ?, ?, ?, ?, ?) "
                    "ON CONFLICT(clip_uuid) DO UPDATE SET "
                    "session_id = excluded.session_id, camera = excluded.camera, "
                    "span_start = excluded.span_start, span_end = excluded.span_end",
                    [
                        (r.clip_uuid, r.session_id, r.camera, r.span_start, r.span_end, r.state, r.caption)
                        for r in rows
                    ],
                )
        _db_retry(op)

    def clips(self, *, session_id: str | None = None, state: str | None = None) -> list[ClipRow]:
        q = "SELECT clip_uuid, session_id, camera, span_start, span_end, state, caption FROM clips"
        conds, args = [], []
        if session_id:
            conds.append("session_id = ?")
            args.append(session_id)
        if state:
            conds.append("state = ?")
            args.append(state)
        if conds:
            q += " WHERE " + " AND ".join(conds)
        return [ClipRow(*row) for row in self._conn.execute(q, args)]

    def _store_window_caption(self, clip_uuid: str, base: str, k: int, caption: str) -> None:
        """Merge one window caption into the row's positional arrays.
        MUST run inside a transaction (the callers' ``with self._conn``):
        the seed INSERT is a write, so sqlite takes the database write lock
        BEFORE the read-merge-update — two processes captioning different
        windows of the same clip serialize instead of losing updates."""
        self._conn.execute(
            "INSERT INTO clip_caption (clip_uuid, version, prompt_type, "
            "window_start_frame, window_end_frame, window_caption, "
            "t5_embedding_url, run_uuid, created_s) "
            "VALUES (?, ?, ?, '[]', '[]', '[]', '', '', ?) "
            "ON CONFLICT(clip_uuid, version, prompt_type) DO NOTHING",
            (clip_uuid, CAPTION_VERSION, base, time.time()),
        )
        row = self._conn.execute(
            "SELECT window_start_frame, window_end_frame, window_caption "
            "FROM clip_caption WHERE clip_uuid = ? AND version = ? AND prompt_type = ?",
            (clip_uuid, CAPTION_VERSION, base),
        ).fetchone()
        starts, ends, caps = _merge_caption_window(
            tuple(json.loads(v) for v in row), k, caption
        )
        # t5_embedding_url / run_uuid are untouched: the annotation writer
        # owns those fields
        self._conn.execute(
            "UPDATE clip_caption SET window_start_frame = ?, "
            "window_end_frame = ?, window_caption = ? "
            "WHERE clip_uuid = ? AND version = ? AND prompt_type = ?",
            (
                json.dumps(starts), json.dumps(ends), json.dumps(caps),
                clip_uuid, CAPTION_VERSION, base,
            ),
        )

    def set_caption(self, clip_uuid: str, caption: str, variant: str = "default") -> None:
        """Store one prompt-variant caption window in ``clip_caption`` (a
        clip carries a caption list a prompt variant). Window 0 of the
        default variant also
        fills the clips.caption column and advances state."""
        base, k = parse_caption_variant(variant)

        def op():
            with self._conn:
                self._store_window_caption(clip_uuid, base, k, caption)
                # Only the default variant's window 0 advances state:
                # 'captioned' must guarantee a non-empty clips.caption
                # (packaging reads it), even if an extra variant finished
                # while the primary failed.
                if base == "default" and k == 0:
                    self._conn.execute(
                        "UPDATE clips SET caption = ?, state = 'captioned' WHERE clip_uuid = ?",
                        (caption, clip_uuid),
                    )
        _db_retry(op)

    def variant_captions(self, clip_uuid: str) -> dict[str, str]:
        """{variant_name: caption} reconstructed from the positional window
        arrays (see _variants_from_caption_rows)."""
        return _variants_from_caption_rows(
            self._conn.execute(
                "SELECT prompt_type, window_caption FROM clip_caption "
                "WHERE clip_uuid = ? AND version = ?",
                (clip_uuid, CAPTION_VERSION),
            )
        )

    def set_clip_state(self, clip_uuid: str, state: str) -> None:
        def op():
            with self._conn:
                self._conn.execute(
                    "UPDATE clips SET state = ? WHERE clip_uuid = ?", (state, clip_uuid)
                )
        _db_retry(op)

    def add_caption_annotations(self, rows: list[CaptionAnnotationRow]) -> None:
        """Bulk-write clip_caption annotation rows. Window lists ride as
        JSON text so
        sqlite and Postgres share one schema."""
        def op():
            with self._conn:
                self._conn.executemany(
                    "INSERT INTO clip_caption (clip_uuid, version, prompt_type, "
                    "window_start_frame, window_end_frame, window_caption, "
                    "t5_embedding_url, run_uuid, created_s) "
                    "VALUES (?, ?, ?, ?, ?, ?, ?, ?, ?) "
                    "ON CONFLICT(clip_uuid, version, prompt_type) DO UPDATE SET "
                    "window_start_frame = excluded.window_start_frame, "
                    "window_end_frame = excluded.window_end_frame, "
                    "window_caption = excluded.window_caption, "
                    "t5_embedding_url = excluded.t5_embedding_url, "
                    "run_uuid = excluded.run_uuid",
                    [
                        (
                            r.clip_uuid, r.version, r.prompt_type,
                            json.dumps(r.window_start_frame),
                            json.dumps(r.window_end_frame),
                            json.dumps(r.window_caption),
                            r.t5_embedding_url, r.run_uuid, time.time(),
                        )
                        for r in rows
                    ],
                )
        _db_retry(op)

    def caption_annotations(self, clip_uuid: str | None = None) -> list[CaptionAnnotationRow]:
        q = (
            "SELECT clip_uuid, version, prompt_type, window_start_frame, "
            "window_end_frame, window_caption, t5_embedding_url, run_uuid "
            "FROM clip_caption"
        )
        args: tuple = ()
        if clip_uuid:
            q += " WHERE clip_uuid = ?"
            args = (clip_uuid,)
        return [
            CaptionAnnotationRow(
                row[0], row[1], row[2],
                json.loads(row[3]), json.loads(row[4]), json.loads(row[5]),
                row[6], row[7],
            )
            for row in self._conn.execute(q, args)
        ]

    # -- the generic tables (run / clipped_session / video_span / clip_tag) --

    def _add_rows(self, table: str, rows: list) -> None:
        if not rows:
            return
        n = len(_generic_columns(table)) + 1  # + created_s
        sql = _upsert_sql(table, "(" + ", ".join("?" * n) + ")")
        now = time.time()
        data = [dataclasses.astuple(r) + (now,) for r in rows]

        def op():
            with self._conn:
                self._conn.executemany(sql, data)
        _db_retry(op)

    def _get_rows(self, table: str, where: dict[str, str]) -> list:
        cols = _generic_columns(table)
        q = f"SELECT {', '.join(cols)} FROM {table}"
        conds = {k: v for k, v in where.items() if v is not None}
        if conds:
            q += " WHERE " + " AND ".join(f"{c} = ?" for c in conds)
        return [
            _coerce_row(table, row)
            for row in self._conn.execute(q, tuple(conds.values()))
        ]

    def close(self) -> None:
        self._conn.close()


_PG_SCHEMA = _SCHEMA.replace("REAL", "DOUBLE PRECISION")


class PostgresAVStateDB(_GenericTablesMixin):
    """The same state API over PostgreSQL, through the driverless wire
    client (utils/pg_client.py).
    The SQL here is written in the dialect intersection: identical
    statements run on both backends."""

    # SQLSTATEs worth retrying: serialization/deadlock/lock + admin shutdown
    _TRANSIENT_SQLSTATES = ("40001", "40P01", "55P03", "57P03")

    def __init__(self, dsn: str) -> None:
        self._conn_kwargs = parse_dsn(dsn)
        self._conn = self._connect()
        for stmt in _PG_SCHEMA.split(";"):
            if stmt.strip():
                self._retry_execute(stmt)
        self._migrate_legacy_captions()

    def _connect(self):
        return PgConnection(**self._conn_kwargs)

    def _with_retries(self, fn):
        """Transient-only retries, with reconnect on a dead socket (a
        desynced/closed connection can never serve the retry otherwise).
        Permanent PgErrors (syntax, constraint) surface immediately —
        matching the sqlite twin's OperationalError-only policy. ``fn``
        receives the CURRENT connection (it changes across reconnects)."""
        last: Exception | None = None
        for attempt in range(5):
            try:
                return fn(self._conn)
            except (ConnectionError, OSError) as e:
                last = e
                try:
                    self._conn.close()
                except Exception:
                    pass
                try:
                    self._conn = self._connect()
                except (ConnectionError, OSError) as e2:
                    last = e2
            except PgError as e:
                if e.fields.get("C") not in self._TRANSIENT_SQLSTATES:
                    raise
                last = e
            sleep_backoff(attempt, base=0.2, cap=2.0)
        raise last  # type: ignore[misc]

    def _retry_execute(self, sql: str, params: tuple = ()):
        return self._with_retries(lambda conn: conn.execute(sql, params))

    def _migrate_legacy_captions(self) -> None:
        """Port pre-round-5 ``clip_captions`` rows into ``clip_caption``
        window arrays, then drop the legacy table (see the sqlite twin)."""
        res = self._retry_execute(
            "SELECT table_name FROM information_schema.tables "
            "WHERE table_name = 'clip_captions'"
        )
        if not any(r[0] == "clip_captions" for r in res.rows):
            return
        try:
            def txn(conn):
                # exclusive table lock FIRST: blocks concurrent old-version
                # writers (including new INSERTs, which row locks would not)
                # until the migrate-and-drop commits, so no caption written
                # mid-migration is destroyed with the table
                conn.execute("LOCK TABLE clip_captions IN ACCESS EXCLUSIVE MODE")
                legacy = conn.execute(
                    "SELECT clip_uuid, variant, caption FROM clip_captions"
                ).rows
                for cid, variant, caption in legacy:
                    base, k = parse_caption_variant(variant)
                    self._store_window_caption_on(conn, cid, base, k, caption)
                conn.execute("DROP TABLE clip_captions")
                return legacy

            legacy = self._retry_txn(txn)
        except PgError:
            res = self._retry_execute(
                "SELECT table_name FROM information_schema.tables "
                "WHERE table_name = 'clip_captions'"
            )
            if not any(r[0] == "clip_captions" for r in res.rows):
                # a concurrent opener migrated + dropped first (42P01)
                return
            # legacy table still present after a failed migration (e.g. no
            # DROP privilege): swallowing this would make every pre-upgrade
            # caption silently invisible — refuse
            raise
        if legacy:
            logger.info(
                "migrated %d legacy clip_captions rows into clip_caption", len(legacy)
            )

    def upsert_session(self, session_id: str, num_cameras: int) -> None:
        self._retry_execute(
            "INSERT INTO sessions (session_id, num_cameras, created_s) "
            "VALUES (%s, %s, %s) ON CONFLICT(session_id) DO UPDATE SET "
            "num_cameras = excluded.num_cameras",
            (session_id, num_cameras, time.time()),
        )

    def set_session_state(self, session_id: str, state: str) -> None:
        self._retry_execute(
            "UPDATE sessions SET state = %s WHERE session_id = %s", (state, session_id)
        )

    def sessions(self, state: str | None = None) -> list[tuple[str, int, str]]:
        q = "SELECT session_id, num_cameras, state FROM sessions"
        params: tuple = ()
        if state:
            q += " WHERE state = %s"
            params = (state,)
        res = self._retry_execute(q, params)
        return [(r[0], int(r[1]), r[2]) for r in res.rows]

    def add_clips(self, rows: list[ClipRow], *, chunk: int = 500) -> None:
        for i in range(0, len(rows), chunk):
            values = ", ".join(
                "(%s)" % ", ".join(
                    quote_literal(v)
                    for v in (r.clip_uuid, r.session_id, r.camera, r.span_start,
                              r.span_end, r.state, r.caption)
                )
                for r in rows[i : i + chunk]
            )
            self._retry_execute(
                "INSERT INTO clips "
                "(clip_uuid, session_id, camera, span_start, span_end, state, caption) "
                f"VALUES {values} "
                "ON CONFLICT(clip_uuid) DO UPDATE SET "
                "session_id = excluded.session_id, camera = excluded.camera, "
                "span_start = excluded.span_start, span_end = excluded.span_end"
            )

    def clips(self, *, session_id: str | None = None, state: str | None = None) -> list[ClipRow]:
        q = "SELECT clip_uuid, session_id, camera, span_start, span_end, state, caption FROM clips"
        conds, params = [], []
        if session_id:
            conds.append("session_id = %s")
            params.append(session_id)
        if state:
            conds.append("state = %s")
            params.append(state)
        if conds:
            q += " WHERE " + " AND ".join(conds)
        res = self._retry_execute(q, tuple(params))
        return [
            ClipRow(r[0], r[1], r[2], float(r[3]), float(r[4]), r[5], r[6] or "")
            for r in res.rows
        ]

    def _retry_txn(self, fn):
        """Run ``fn(conn)`` inside BEGIN/COMMIT under the shared retry
        policy (_with_retries); ROLLBACK on any failure."""
        def txn(conn):
            conn.execute("BEGIN")
            try:
                out = fn(conn)
                conn.execute("COMMIT")
                return out
            except BaseException:
                try:
                    conn.execute("ROLLBACK")
                except Exception:
                    pass
                raise
        return self._with_retries(txn)

    def _store_window_caption_on(
        self, conn, clip_uuid: str, base: str, k: int, caption: str
    ) -> None:
        """Seed-then-lock merge of one window caption: the DO NOTHING insert
        guarantees a row exists, the SELECT ... FOR UPDATE serializes
        concurrent writers on it — two workers captioning different windows
        of the same clip cannot lose each other's updates. NO transaction
        management here: the caller supplies the enclosing transaction."""
        conn.execute(
            "INSERT INTO clip_caption (clip_uuid, version, prompt_type, "
            "window_start_frame, window_end_frame, window_caption, "
            "t5_embedding_url, run_uuid, created_s) "
            "VALUES (%s, %s, %s, '[]', '[]', '[]', '', '', %s) "
            "ON CONFLICT(clip_uuid, version, prompt_type) DO NOTHING",
            (clip_uuid, CAPTION_VERSION, base, time.time()),
        )
        res = conn.execute(
            "SELECT window_start_frame, window_end_frame, window_caption "
            "FROM clip_caption WHERE clip_uuid = %s AND version = %s "
            "AND prompt_type = %s FOR UPDATE",
            (clip_uuid, CAPTION_VERSION, base),
        )
        starts, ends, caps = _merge_caption_window(
            tuple(json.loads(v) for v in res.rows[0]), k, caption
        )
        conn.execute(
            "UPDATE clip_caption SET window_start_frame = %s, "
            "window_end_frame = %s, window_caption = %s "
            "WHERE clip_uuid = %s AND version = %s AND prompt_type = %s",
            (
                json.dumps(starts), json.dumps(ends), json.dumps(caps),
                clip_uuid, CAPTION_VERSION, base,
            ),
        )

    def _store_window_caption(self, clip_uuid: str, base: str, k: int, caption: str) -> None:
        self._retry_txn(
            lambda conn: self._store_window_caption_on(conn, clip_uuid, base, k, caption)
        )

    def set_caption(self, clip_uuid: str, caption: str, variant: str = "default") -> None:
        base, k = parse_caption_variant(variant)
        self._store_window_caption(clip_uuid, base, k, caption)
        if base == "default" and k == 0:
            self._retry_execute(
                "UPDATE clips SET caption = %s, state = 'captioned' WHERE clip_uuid = %s",
                (caption, clip_uuid),
            )

    def variant_captions(self, clip_uuid: str) -> dict[str, str]:
        res = self._retry_execute(
            "SELECT prompt_type, window_caption FROM clip_caption "
            "WHERE clip_uuid = %s AND version = %s",
            (clip_uuid, CAPTION_VERSION),
        )
        return _variants_from_caption_rows(res.rows)

    def set_clip_state(self, clip_uuid: str, state: str) -> None:
        self._retry_execute(
            "UPDATE clips SET state = %s WHERE clip_uuid = %s", (state, clip_uuid)
        )

    def add_caption_annotations(
        self, rows: list[CaptionAnnotationRow], *, chunk: int = 500
    ) -> None:
        """Chunked multi-row VALUES like add_clips: one round trip per 500
        rows instead of one per row."""
        now = time.time()
        for i in range(0, len(rows), chunk):
            values = ", ".join(
                "(%s)" % ", ".join(
                    quote_literal(v)
                    for v in (
                        r.clip_uuid, r.version, r.prompt_type,
                        json.dumps(r.window_start_frame),
                        json.dumps(r.window_end_frame),
                        json.dumps(r.window_caption),
                        r.t5_embedding_url, r.run_uuid, now,
                    )
                )
                for r in rows[i : i + chunk]
            )
            self._retry_execute(
                "INSERT INTO clip_caption (clip_uuid, version, prompt_type, "
                "window_start_frame, window_end_frame, window_caption, "
                "t5_embedding_url, run_uuid, created_s) "
                f"VALUES {values} "
                "ON CONFLICT(clip_uuid, version, prompt_type) DO UPDATE SET "
                "window_start_frame = excluded.window_start_frame, "
                "window_end_frame = excluded.window_end_frame, "
                "window_caption = excluded.window_caption, "
                "t5_embedding_url = excluded.t5_embedding_url, "
                "run_uuid = excluded.run_uuid"
            )

    def caption_annotations(self, clip_uuid: str | None = None) -> list[CaptionAnnotationRow]:
        q = (
            "SELECT clip_uuid, version, prompt_type, window_start_frame, "
            "window_end_frame, window_caption, t5_embedding_url, run_uuid "
            "FROM clip_caption"
        )
        params: tuple = ()
        if clip_uuid:
            q += " WHERE clip_uuid = %s"
            params = (clip_uuid,)
        res = self._retry_execute(q, params)
        return [
            CaptionAnnotationRow(
                r[0], r[1], r[2],
                json.loads(r[3]), json.loads(r[4]), json.loads(r[5]),
                r[6], r[7],
            )
            for r in res.rows
        ]

    # -- the generic tables ----------------------------------------------------

    def _add_rows(self, table: str, rows: list, *, chunk: int = 500) -> None:
        if not rows:
            return
        now = time.time()
        for i in range(0, len(rows), chunk):
            values = ", ".join(
                "(%s)" % ", ".join(
                    quote_literal(v) for v in dataclasses.astuple(r) + (now,)
                )
                for r in rows[i : i + chunk]
            )
            self._retry_execute(_upsert_sql(table, values))

    def _get_rows(self, table: str, where: dict[str, str]) -> list:
        cols = _generic_columns(table)
        q = f"SELECT {', '.join(cols)} FROM {table}"
        conds = {k: v for k, v in where.items() if v is not None}
        if conds:
            q += " WHERE " + " AND ".join(f"{c} = %s" for c in conds)
        res = self._retry_execute(q, tuple(conds.values()))
        return [_coerce_row(table, r) for r in res.rows]

    def close(self) -> None:
        self._conn.close()


def open_state_db(path_or_dsn: str):
    """sqlite file path, object-store sqlite URL, or postgres:// DSN ->
    the matching backend."""
    if path_or_dsn.startswith(("postgres://", "postgresql://")):
        return PostgresAVStateDB(path_or_dsn)
    if path_or_dsn.startswith(("s3://", "gs://", "az://")):
        from cosmos_curate_tpu_torch.pipelines.av.downloaders import RemoteSyncedStateDB

        return RemoteSyncedStateDB(path_or_dsn)
    return AVStateDB(path_or_dsn)
