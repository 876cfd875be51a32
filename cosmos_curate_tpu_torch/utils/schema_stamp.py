"""Schema-version stamping of durable JSON (port of the part of
``cosmos_curate_tpu/utils/schema_stamp.py`` that the job service's journal,
the dead-letter queue, the corpus index's manifests, the run report, the
per-node stats sidecars and the live status write and read through). The versions are the
reference's, so a record the port writes reads as the same version of the
same surface, and a manifest either package wrote opens in the other."""

from __future__ import annotations

from typing import Callable

STAMP_KEY = "schema_version"

# surface -> published version; version 1 is each surface's historical,
# unstamped format
SCHEMA_VERSIONS: dict[str, int] = {
    # service/job_queue.py journal envelope + JobRecord snapshot
    "job-journal": 2,
    "dlq-meta": 2,
    # dedup/index_store.py manifests/gen-N.json + MANIFEST.json pointer
    "index-manifest": 2,
    # observability/flight_recorder.py report/run_report.json
    "run-report": 1,
    # observability/flight_recorder.py report/node-stats-<rank>.json
    "node-stats": 1,
    # observability/live_status.py report/live/status.json
    "live-status": 1,
}


class SchemaVersionError(ValueError):
    """A document's version cannot be reconciled with this build: newer
    than published, or older with no registered migration shim."""


def stamp(doc: dict, surface: str) -> dict:
    """Stamp ``doc`` (in place) with the surface's published version and
    return it. Unknown surfaces raise."""
    if surface not in SCHEMA_VERSIONS:
        raise KeyError(f"unknown durable surface {surface!r}; register it in SCHEMA_VERSIONS")
    doc[STAMP_KEY] = SCHEMA_VERSIONS[surface]
    return doc


def _journal_v1_to_v2(doc: dict) -> dict:
    """v1 journal lines predate stamping: the envelope was ``{ts, event,
    record}`` with no field renames since."""
    return {**doc, STAMP_KEY: 2}


def _dlq_meta_v1_to_v2(doc: dict) -> dict:
    """v1 DLQ meta.json predates stamping; the field set is unchanged."""
    return {**doc, STAMP_KEY: 2}


def _manifest_v1_to_v2(doc: dict) -> dict:
    """v1 manifests (and MANIFEST.json pointers) predate stamping; the field
    set is unchanged."""
    return {**doc, STAMP_KEY: 2}


# (surface, from_version) -> shim to from_version + 1; shims never mutate
# their input
MIGRATIONS: dict[tuple[str, int], Callable[[dict], dict]] = {
    ("job-journal", 1): _journal_v1_to_v2,
    ("dlq-meta", 1): _dlq_meta_v1_to_v2,
    ("index-manifest", 1): _manifest_v1_to_v2,
}


def doc_version(doc: dict) -> int:
    """The version a document claims; unstamped documents are version 1."""
    try:
        return int(doc.get(STAMP_KEY, 1))
    except (TypeError, ValueError):
        return 1


def has_migration(surface: str, from_version: int) -> bool:
    return (surface, from_version) in MIGRATIONS


def upgrade(doc: dict, surface: str, *, strict: bool = True) -> dict:
    """Carry ``doc`` forward to the surface's published version through the
    shim chain; a same-version document returns unchanged. A document newer
    than this build raises :class:`SchemaVersionError` when ``strict``;
    with ``strict=False`` it is returned as-is (for readers that drop
    unknown fields, such as the job journal's replay). An older document
    without a shim always raises."""
    current = SCHEMA_VERSIONS[surface]
    v = doc_version(doc)
    if v > current:
        if not strict:
            return doc
        raise SchemaVersionError(
            f"{surface} document is schema v{v} but this build publishes v{current}; "
            "upgrade this process before reading it"
        )
    while v < current:
        shim = MIGRATIONS.get((surface, v))
        if shim is None:
            raise SchemaVersionError(f"{surface} document is schema v{v} and no migration shim to v{v + 1} exists")
        doc = shim(doc)
        v = doc_version(doc)
    return doc


def describe() -> dict:
    """Machine-readable summary of the versions and shims (the schema pass's
    ``describe``)."""
    return {
        "versions": dict(SCHEMA_VERSIONS),
        "migrations": sorted(f"{s}:v{v}->v{v + 1}" for s, v in MIGRATIONS),
    }
