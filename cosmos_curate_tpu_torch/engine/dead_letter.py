"""Durable dead-letter queue for batches a runner gives up on (port of
``cosmos_curate_tpu/engine/dead_letter.py``, the in-process runners' part).

Every permanent drop becomes a durable, inspectable, re-runnable artifact:
before the batch is released, its tasks are persisted with failure
metadata.

Layout (one directory per run, one per dead batch)::

    <root>/<run_id>/
        batch-<id>-<stage>/
            meta.json     # stage, attempts, reason, error tail
            tasks.pkl     # cloudpickle list[PipelineTask]

``root`` resolves from ``CURATE_DLQ_DIR`` (default
``~/.cache/cosmos-curate-tpu/dlq``); set it to "" to disable persistence.
Directories are created lazily: a clean run writes nothing. ``cloudpickle``
is imported only when a batch is written or read.

Not ported: the trace id of the batch's span (the port has no tracing
yet), the node-loss fields of the streaming engine, and the requeue CLI.
"""

from __future__ import annotations

import json
import os
import re
import time
import uuid
from dataclasses import dataclass
from pathlib import Path

from cosmos_curate_tpu_torch.utils import schema_stamp
from cosmos_curate_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

DLQ_DIR_ENV = "CURATE_DLQ_DIR"
_ERROR_TAIL = 4000  # chars of the failure traceback kept in meta.json


def default_root() -> str:
    """'' disables the DLQ (explicit empty env var)."""
    if DLQ_DIR_ENV in os.environ:
        return os.environ[DLQ_DIR_ENV]
    return os.path.join(os.path.expanduser("~"), ".cache", "cosmos-curate-tpu", "dlq")


@dataclass(frozen=True)
class DlqEntry:
    """One dead batch on disk."""

    path: Path  # .../<run_id>/batch-<id>-<stage>
    meta: dict

    def load_tasks(self) -> list:
        import cloudpickle

        with open(self.path / "tasks.pkl", "rb") as f:
            return cloudpickle.loads(f.read())


class DeadLetterQueue:
    """Run-scoped writer. Lazy: the run directory appears on first record.
    Persistence never turns a dropped batch into a crashed pipeline: every
    failure in here degrades to a log-only drop."""

    def __init__(self, root: str | None = None, *, run_id: str | None = None) -> None:
        self.root = default_root() if root is None else root
        # the random suffix keeps two runs started in the same second from
        # sharing a directory
        self.run_id = run_id or f"run-{time.strftime('%Y%m%d-%H%M%S')}-{os.getpid()}-{uuid.uuid4().hex[:6]}"
        self.recorded = 0

    @property
    def enabled(self) -> bool:
        return bool(self.root)

    @property
    def run_dir(self) -> Path:
        return Path(self.root) / self.run_id

    def record(
        self,
        *,
        stage_name: str,
        batch_id: int,
        tasks: list,
        attempts: int,
        worker_deaths: int,
        reason: str,
        error: str = "",
    ) -> Path | None:
        """Persist one dead batch; returns its directory (None = disabled
        or failed; the caller's drop proceeds regardless)."""
        if not self.enabled:
            return None
        import cloudpickle

        # stage names are arbitrary strings: path separators must not nest
        # or escape the entry directory
        safe_stage = re.sub(r"[^A-Za-z0-9._-]", "_", stage_name) or "stage"
        entry = self.run_dir / f"batch-{batch_id}-{safe_stage}"
        try:
            entry.mkdir(parents=True, exist_ok=True)
            with open(entry / "tasks.pkl", "wb") as f:
                f.write(cloudpickle.dumps(tasks))
            meta = {
                "stage": stage_name,
                "batch_id": batch_id,
                "num_tasks": len(tasks),
                "attempts": attempts,
                "worker_deaths": worker_deaths,
                "reason": reason,
                "error_tail": error[-_ERROR_TAIL:] if error else "",
                "dropped_at": time.time(),
                "run_id": self.run_id,
            }
            schema_stamp.stamp(meta, "dlq-meta")
            (entry / "meta.json").write_text(json.dumps(meta, indent=2))
        except Exception:
            logger.exception("DLQ write failed for stage %s batch %d (dropping without record)", stage_name, batch_id)
            return None
        self.recorded += 1
        logger.error("stage %s batch %d dead-lettered to %s (%d tasks)", stage_name, batch_id, entry, len(tasks))
        return entry


def record_exhausted_batch(
    dlq: DeadLetterQueue | None,
    *,
    stage_name: str,
    batch_id: int,
    tasks: list,
    attempts: int,
    error: str = "",
) -> bool:
    """Shared drop path of the in-process runners (SequentialRunner,
    PipelinedRunner): persist a batch whose ``num_run_attempts`` budget is
    exhausted, with the same reason string from both. True when an entry
    was written; never raises."""
    if dlq is None or not dlq.enabled:
        return False
    try:
        return (
            dlq.record(
                stage_name=stage_name,
                batch_id=batch_id,
                tasks=tasks,
                attempts=attempts,
                worker_deaths=0,
                reason=f"num_run_attempts ({attempts}) exhausted",
                error=error,
            )
            is not None
        )
    except Exception:
        logger.exception("DLQ record failed; batch dropped without record")
        return False


def list_entries(root: str | None = None, *, run_id: str | None = None) -> list[DlqEntry]:
    """All entries under ``root`` (newest run first), or one run's."""
    base = Path(default_root() if root is None else root)
    if not base.is_dir():
        return []
    runs = [base / run_id] if run_id else sorted((p for p in base.iterdir() if p.is_dir()), reverse=True)
    out: list[DlqEntry] = []
    for run in runs:
        if not run.is_dir():
            continue
        for entry in sorted(p for p in run.iterdir() if p.is_dir()):
            try:
                meta = json.loads((entry / "meta.json").read_text())
            except (OSError, ValueError):
                meta = {"stage": "?", "batch_id": -1, "error_tail": "unreadable meta.json"}
            out.append(DlqEntry(path=entry, meta=meta))
    return out
