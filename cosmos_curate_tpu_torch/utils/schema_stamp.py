"""Schema-version stamping of durable JSON (port of the part of
``cosmos_curate_tpu/utils/schema_stamp.py`` the dead-letter queue writes
through). The versions are the reference's, so a record the port writes
reads as the same version of the same surface."""

from __future__ import annotations

STAMP_KEY = "schema_version"

# surface -> published version
SCHEMA_VERSIONS: dict[str, int] = {"dlq-meta": 2}


def stamp(doc: dict, surface: str) -> dict:
    """Stamp ``doc`` (in place) with the surface's published version and
    return it. Unknown surfaces raise."""
    if surface not in SCHEMA_VERSIONS:
        raise KeyError(f"unknown durable surface {surface!r}; register it in SCHEMA_VERSIONS")
    doc[STAMP_KEY] = SCHEMA_VERSIONS[surface]
    return doc
