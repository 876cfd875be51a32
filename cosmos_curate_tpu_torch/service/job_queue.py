"""Durable job records: an append-only journal that survives service crashes
(port of ``cosmos_curate_tpu/service/job_queue.py``; the same journal
format, so a journal either package wrote replays in the other's service).

The reference service (PAPER.md L6, NVCF wrapper) keeps its one job in
memory behind a single-pipeline lock — a restart forgets everything. This
module is the service's source of truth instead: every job record (spec,
tenant, priority, state transition, attempt count) is journaled to an
append-only NDJSON log under ``work_root``, so a service that comes back
after ``kill -9`` replays the journal, marks jobs that were ``running`` at
crash time as ``interrupted``, and re-enqueues them. Re-invocation reuses
the job's original ``work_dir`` and args, so the split pipeline's
input-discovery resume records (``pipelines/video/input_discovery.py``)
skip every video the dead run already completed.

Journal layout (``<work_root>/journal.ndjson``)::

    {"schema_version": 2, "ts": ..., "event": "submit", "record": {...full JobRecord...}}
    {"schema_version": 2, "ts": ..., "event": "running", "record": {...}}
    ...

Each line is a full snapshot of the record at that transition: replay is
"last line per job_id wins", which tolerates a torn final line (a crash
mid-append) by discarding it. On startup the replayed state is compacted
back to one line per job so the journal stays O(jobs), not O(transitions).

Every line is stamped with the ``job-journal`` schema version
(utils/schema_stamp.py): replay carries version-N−1 lines forward through
the registered migration shims — a service restarted onto a new build
mid-deploy replays the old build's journal with zero lost or duplicated
jobs — and reads a line newer than this build publishes best-effort
(unknown record fields are dropped).

Lifecycle::

    pending ──▶ running ──▶ done
                  │  │
                  │  ├──▶ failed        (spawn error: never started)
                  │  ├──▶ terminated    (operator kill)
                  │  ├──▶ interrupted   (service died / drain checkpoint)
                  │  │        └──▶ pending   (replayed + re-enqueued)
                  │  └──▶ pending       (non-zero exit, attempts left)
                  │            └──▶ dead_lettered (attempts exhausted)
                  └───────────────────────▶ (requeue: dead_lettered ▶ pending)

Terminal states are ``done | failed | dead_lettered | terminated``;
``interrupted`` and ``pending`` only survive until the next dispatch.

The chaos site ``service.journal.write`` fires at the top of every append,
so a journal outage can be shown to degrade to a refused submission, not a
lost job.

A job child on a GPU host holds a CUDA context and card memory. Crash
recovery therefore kills an orphaned child's process group AND waits until
no live process of the group is left before anything is re-enqueued: the
resumed attempt never shares the card with the orphan it replaces.
"""

from __future__ import annotations

import json
import os
import time
import uuid
from dataclasses import dataclass, field, asdict
from pathlib import Path

from cosmos_curate_tpu_torch import chaos
from cosmos_curate_tpu_torch.utils import schema_stamp
from cosmos_curate_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

LANES = ("interactive", "batch")

# every state a record can journal as; used to zero per-state gauges
JOB_STATES = (
    "pending",
    "running",
    "interrupted",
    "done",
    "failed",
    "dead_lettered",
    "terminated",
)
TERMINAL_STATES = frozenset({"done", "failed", "dead_lettered", "terminated"})


@dataclass
class JobRecord:
    """One job, as journaled. ``args`` is the pipeline-args dict the child
    process receives; re-running the same record is what makes resume work
    (same output_path → input discovery skips completed videos)."""

    job_id: str
    pipeline: str
    args: dict
    tenant: str = "default"
    priority: str = "batch"  # one of LANES
    state: str = "pending"
    attempts: int = 0  # dispatches so far (1-based after first spawn)
    max_attempts: int = 3
    submitted_s: float = field(default_factory=time.time)
    enqueued_s: float = field(default_factory=time.time)  # reset on requeue
    started_s: float | None = None
    finished_s: float | None = None
    pid: int | None = None  # session-leader pid while running (ops + crash cleanup)
    error: str = ""  # tail of the last failure reason
    # presigned-zip transport (reference handle_presigned_urls)
    input_zip_url: str = ""
    output_zip_url: str = ""
    output_zip_multipart: dict | None = None

    def to_dict(self) -> dict:
        return asdict(self)

    @classmethod
    def from_dict(cls, doc: dict) -> "JobRecord":
        known = {f for f in cls.__dataclass_fields__}
        return cls(**{k: v for k, v in doc.items() if k in known})

    @classmethod
    def new(cls, pipeline: str, args: dict, **kw) -> "JobRecord":
        return cls(job_id=uuid.uuid4().hex[:12], pipeline=pipeline, args=args, **kw)


class JournalWriteError(RuntimeError):
    """An append could not be made durable. Submissions must be refused
    (503) rather than accepted into a queue that would forget them."""


class JobJournal:
    """Append-only NDJSON journal with last-line-wins replay.

    Appends flush+fsync before returning: once a submission is acked, a
    ``kill -9`` one instruction later still replays it. The fsync runs on
    the CALLER's thread — the service keeps it off its event loop by
    routing every coroutine-side append through a single-thread journal
    executor (``ServiceState.record_transition_async``), which also
    serializes appends without a lock. Failures raise
    :class:`JournalWriteError` — the caller decides whether that refuses a
    submission (yes) or degrades a mid-run transition to in-memory-only
    (also yes, with a loud log: losing one transition downgrades a resumed
    job to a re-run, which resume records make idempotent anyway).
    """

    def __init__(self, path: str | Path) -> None:
        self.path = Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)

    def append(self, record: JobRecord, event: str) -> None:
        line = json.dumps(
            schema_stamp.stamp(
                {"ts": time.time(), "event": event, "record": record.to_dict()},
                "job-journal",
            )
        )
        try:
            # InjectedFault is a ConnectionError: an armed
            # service.journal.write rule surfaces as JournalWriteError, the
            # same shape as a real disk failure
            chaos.fire(chaos.SITE_SERVICE_JOURNAL_WRITE)
            with open(self.path, "a", encoding="utf-8") as f:
                f.write(line + "\n")
                f.flush()
                os.fsync(f.fileno())
        except (OSError, ConnectionError) as e:
            raise JournalWriteError(f"journal append failed: {e}") from e

    def replay(self) -> dict[str, JobRecord]:
        """Last snapshot per job_id, submission-ordered. A torn final line
        (crash mid-append) is discarded; any other unparseable line is
        skipped with a warning rather than wedging startup."""
        records: dict[str, JobRecord] = {}
        if not self.path.exists():
            return records
        try:
            lines = self.path.read_text(encoding="utf-8", errors="replace").splitlines()
        except OSError as e:
            logger.error("journal unreadable (%s); starting empty", e)
            return records
        for i, line in enumerate(lines):
            if not line.strip():
                continue
            try:
                doc = json.loads(line)
                # version-N−1 lines (including historical unstamped v1) flow
                # through the shim chain; newer-than-this-build lines pass
                # as-is (strict=False) because from_dict drops unknown
                # fields — best-effort beats wedging a rollback's startup.
                # A missing shim raises SchemaVersionError (a ValueError),
                # landing in the corrupt-line path below: skipped loudly.
                doc = schema_stamp.upgrade(doc, "job-journal", strict=False)
                rec = JobRecord.from_dict(doc["record"])
            except (ValueError, KeyError, TypeError) as e:
                if i == len(lines) - 1:
                    logger.warning("discarding torn journal tail line: %s", e)
                else:
                    logger.warning("skipping corrupt journal line %d: %s", i + 1, e)
                continue
            if doc.get("event") == "evicted":
                # GC tombstone (app.ServiceState.gc_terminal): the record
                # was terminal and aged out — drop it from replay too
                records.pop(rec.job_id, None)
                continue
            records[rec.job_id] = rec
        return records

    def compact(self, records: dict[str, JobRecord]) -> None:
        """Atomically rewrite the journal to one line per job. Called at
        startup after replay; a failure leaves the old (longer but valid)
        journal in place."""
        tmp = self.path.with_suffix(".ndjson.tmp")
        try:
            with open(tmp, "w", encoding="utf-8") as f:
                for rec in records.values():
                    f.write(
                        json.dumps(
                            schema_stamp.stamp(
                                {
                                    "ts": time.time(),
                                    "event": "compact",
                                    "record": rec.to_dict(),
                                },
                                "job-journal",
                            )
                        )
                        + "\n"
                    )
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, self.path)
        except OSError as e:
            logger.warning("journal compaction failed (keeping long journal): %s", e)
            tmp.unlink(missing_ok=True)


def _pgid_is_own_session(pid: int) -> bool:
    """True when ``pid`` leads its own process group — the shape every job
    child has (``start_new_session=True``). Guards crash-recovery cleanup
    against killing an unrelated process that reused the pid."""
    try:
        return os.getpgid(pid) == pid
    except (OSError, PermissionError):
        return False


def _is_job_process(pid: int, job_id: str) -> bool:
    """Identity check before the orphan SIGKILL: group-leadership alone is
    not enough under pid reuse (any daemon is its own session leader after
    a host reboot). Every job child is stamped
    ``CURATE_WORKER_ID=job-<job_id>-a<n>`` (service/app.py job_env), so on
    Linux ``/proc/<pid>/environ`` identifies it exactly; when /proc is
    unreadable (non-Linux, permissions) fall back to the session check."""
    marker = f"CURATE_WORKER_ID=job-{job_id}-a".encode()
    try:
        env_blob = Path(f"/proc/{pid}/environ").read_bytes()
    except OSError:
        return _pgid_is_own_session(pid)
    return marker in env_blob


# how long recovery waits for a killed orphan's process group to be gone;
# a CUDA context tears down in well under this
ORPHAN_REAP_TIMEOUT_S = 30.0


def _live_group_members(pgid: int) -> list[int] | None:
    """Pids of the processes in group ``pgid`` that are not zombies (a
    zombie holds no memory and no device context; only its parent, or
    init for an orphan, can reap it). None when /proc cannot be read."""
    members = []
    try:
        entries = os.listdir("/proc")
    except OSError:
        return None
    for name in entries:
        if not name.isdigit():
            continue
        try:
            stat = Path(f"/proc/{name}/stat").read_text()
        except OSError:
            continue  # exited between the listing and the read
        # "pid (comm) state ppid pgrp ...": comm may hold spaces and parens
        fields = stat[stat.rindex(")") + 2:].split()
        if int(fields[2]) == pgid and fields[0] != "Z":
            members.append(int(name))
    return members


def wait_group_gone(pgid: int, timeout_s: float = ORPHAN_REAP_TIMEOUT_S) -> bool:
    """Block until no live process of group ``pgid`` is left (zombies
    excepted); False if some are still alive at ``timeout_s``. Where /proc
    is unreadable, the group counts as gone once ``killpg(pgid, 0)`` finds
    no process."""
    deadline = time.monotonic() + timeout_s
    while True:
        members = _live_group_members(pgid)
        if members is None:
            try:
                os.killpg(pgid, 0)
            except ProcessLookupError:
                return True
            except PermissionError:
                pass
        elif not members:
            return True
        if time.monotonic() > deadline:
            return False
        time.sleep(0.02)


def recover_records(
    journal: JobJournal, *, kill_orphans: bool = True
) -> tuple[dict[str, JobRecord], list[str]]:
    """Replay + crash recovery: returns ``(records, requeue_ids)``.

    Jobs whose last journaled state was ``running`` were alive when the
    previous service died — they are marked ``interrupted`` and queued for
    re-enqueue. A job process that *outlived* the dead service would keep
    writing (and, on a GPU host, keep its card memory) while the resumed
    copy runs, so its process group is killed first and waited for (only
    when the pid is still the job's own process — see
    :func:`_is_job_process`). ``pending``/``interrupted`` records
    re-enqueue as-is; terminal records are kept for listing only.
    """
    import signal

    records = journal.replay()
    requeue: list[str] = []
    for rec in records.values():
        # ANY record still carrying a pid had a live process when the
        # service died — including a job journaled `terminated` where the
        # crash beat the killpg. Reap it before re-running anything, or
        # the orphan keeps writing next to the resumed copy.
        if kill_orphans and rec.pid and _is_job_process(rec.pid, rec.job_id):
            try:
                os.killpg(rec.pid, signal.SIGKILL)
            except (OSError, PermissionError):
                pass
            else:
                t0 = time.monotonic()
                gone = wait_group_gone(rec.pid)
                logger.warning(
                    "killed orphaned job process group %d (job %s) from dead service; %s after %.3fs",
                    rec.pid, rec.job_id, "gone" if gone else "STILL ALIVE", time.monotonic() - t0,
                )
        rec.pid = None
        if rec.state == "running":
            rec.state = "interrupted"
        if rec.state in ("pending", "interrupted"):
            requeue.append(rec.job_id)
    return records, requeue
