"""Durable multi-tenant job service: crash-safe queue, admission, resume
(port of ``cosmos_curate_tpu/service/app.py``: the same routes, JSON
bodies, journal and exit codes, so one client and one dashboard serve
either package's service).

The reference gets its service shape from NVCF (cosmos_curate/core/cf/
nvcf_main.py — FastAPI wrapper, one-pipeline-at-a-time lock, in-memory job
dict), which forgets every queued and running job on restart. This service
is built for heavy multi-tenant traffic instead (aiohttp; fastapi is not
in this image):

  GET  /health                  liveness + READINESS (dispatcher running,
                                journal writable, queue depths per lane,
                                index generation when serving search)
  GET  /v1/jobs                 list jobs (?tenant=&state= filters)
  POST /v1/invoke               {"pipeline": ..., "args": {...},
                                 "tenant": "t", "priority": "interactive"}
  GET  /v1/progress/{job_id}    state, attempts, summary + run_report link
  GET  /v1/jobs/{job_id}/status the job child's latest LIVE snapshot
                                (per-stage queue/busy/in-flight batches)
                                + stall-detector verdicts
  GET  /v1/slo                  per-tenant queue-wait / run-duration /
                                success-rate vs configured targets
  GET  /v1/logs/{job_id}        bounded log tail (seeks, never slurps)
  POST /v1/terminate/{job_id}   kill the job's whole process group
  POST /v1/requeue/{job_id}     dead_lettered/failed/terminated → pending
  GET  /v1/models               staged-weights registry status
  POST /v1/search               similarity search over the corpus index
                                (service/search.py; needs --index-path;
                                 its own admission lane, sheds independently
                                 of the job queue)
  GET  /v1/search/stats         index-server generation/cache/lane stats

Durability: every state transition is journaled append-only under
``work_root`` (service/job_queue.py). A ``kill -9``'d service replays the
journal on boot, marks running jobs ``interrupted``, and re-enqueues them;
the re-run reuses the same args/output_path, so input-discovery resume
records skip already-completed videos. Admission (service/admission.py)
replaces the single-job lock with interactive/batch priority lanes,
per-tenant quotas, and load shedding (429 + Retry-After, never an
unbounded queue); a dispatcher runs up to N concurrent jobs gated by the
host's NodeBudget. Failures retry with full-jitter backoff up to
``max_attempts``, then land ``dead_lettered`` (requeueable). SIGTERM
drains gracefully: stop admitting, let running jobs finish within
``drain_s``, checkpoint the rest as ``interrupted`` for the next boot.

Jobs execute in their own *session* (``start_new_session=True``) so a
crashing pipeline never takes the service down and terminate kills the
entire worker tree, not just the direct child. Chaos sites
``service.job.crash`` (child start) and ``service.journal.write`` (journal
append) plug the whole thing into the fault-injection harness.

A job child runs the port's pipelines (``SplitPipelineArgs`` /
``DedupPipelineArgs`` / ``ShardPipelineArgs`` from the job's ``args``), so a
job submitted without a ``device`` runs its models on the card; ``"device":
"cpu"`` in the args runs them on the CPU. A child that finds no card where
one is asked for fails (its log names the missing device) and is retried,
then dead-lettered: it never carries on on the CPU.
"""

from __future__ import annotations

import asyncio
import copy
import functools
import json
import os
import re
import signal
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable

from aiohttp import web

from cosmos_curate_tpu_torch.service.admission import (
    AdmissionController,
    QuotaConfig,
)
from cosmos_curate_tpu_torch.service.job_queue import (
    JOB_STATES,
    LANES,
    TERMINAL_STATES,
    JobJournal,
    JobRecord,
    JournalWriteError,
    recover_records,
)
from cosmos_curate_tpu_torch.service.slo import SloConfig, SloTracker
from cosmos_curate_tpu_torch.storage.retry import backoff_s
from cosmos_curate_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

_PIPELINES = {"split", "dedup", "shard"}
_LOG_TAIL_MAX_BYTES = 1 << 20  # hard ceiling per /v1/logs read, multi-GB safe
_TENANT_RE = re.compile(r"[A-Za-z0-9._:-]{1,64}")


@dataclass(frozen=True)
class ServiceConfig:
    quota: QuotaConfig = field(default_factory=QuotaConfig)
    max_attempts: int = 3
    drain_s: float = 30.0  # SIGTERM: grace for running jobs to finish
    term_grace_s: float = 5.0  # terminate: SIGTERM → SIGKILL escalation
    retry_base_s: float = 0.5  # full-jitter backoff between attempts
    retry_cap_s: float = 30.0
    metrics_port: int | None = None
    # terminal-record GC: a long-lived service must not hold every job it
    # ever ran in memory/journal forever. Records in a terminal state are
    # evicted (journal tombstone + drop) after retain_terminal_s, and the
    # newest max_terminal_records are kept regardless of backlog size.
    retain_terminal_s: float = 86400.0
    max_terminal_records: int = 5000
    # per-tenant SLO targets (service/slo.py; `serve --slo-*` knobs).
    # Breaches increment service_slo_breaches_total{tenant,kind}, journal
    # against the job, and surface in GET /v1/slo.
    slo: SloConfig = field(default_factory=SloConfig)
    # live ops: how often the dispatcher re-reads a running job's live
    # snapshot to journal its anomaly verdicts + fold them into the
    # service's pipeline_anomalies_total (job children have no exporter)
    anomaly_scan_interval_s: float = 3.0


# ---------------------------------------------------------------------------
# job subprocess


def _runner_code(
    pipeline: str,
    args: dict,
    summary_path: str,
    work_dir: str = "",
    input_zip_url: str = "",
    output_zip_url: str = "",
    output_zip_multipart: dict | None = None,
) -> str:
    """Child-process program: optional presigned-zip ingest (reference
    nvcf_main.py handle_presigned_urls — credential-less I/O: inputs arrive
    as a GET-able zip, results leave as a PUT-able zip), run the pipeline,
    write summary.json, optional zip+upload of the output directory.

    The chaos preamble arms ``CURATE_CHAOS`` (handed through job_env) and
    fires ``service.job.crash`` — a crash-kind rule kills the job child
    before any work, exercising the retry/dead-letter path end to end."""
    payload = json.dumps(
        {
            "pipeline": pipeline,
            "args": args,
            "summary": summary_path,
            "work_dir": work_dir,
            "input_zip_url": input_zip_url,
            "output_zip_url": output_zip_url,
            "output_zip_multipart": output_zip_multipart,
        }
    )
    return (
        "import json, sys\n"
        "from cosmos_curate_tpu_torch import chaos as _chaos\n"
        "_chaos.install_from_env()\n"
        "_chaos.fire('service.job.crash')\n"
        f"spec = json.loads({payload!r})\n"
        "args = spec['args']\n"
        "if spec['input_zip_url']:\n"
        "    from cosmos_curate_tpu_torch.storage.zip_transport import download_and_extract\n"
        "    inp = spec['work_dir'] + '/input'\n"
        "    download_and_extract(spec['input_zip_url'], inp)\n"
        "    args['input_path'] = inp\n"
        "if (spec['output_zip_url'] or spec['output_zip_multipart']) and not args.get('output_path'):\n"
        "    args['output_path'] = spec['work_dir'] + '/output'\n"
        "from cosmos_curate_tpu_torch.pipelines.video import split as split_mod\n"
        "from cosmos_curate_tpu_torch.pipelines.video import dedup as dedup_mod\n"
        "from cosmos_curate_tpu_torch.pipelines.video import shard as shard_mod\n"
        "if spec['pipeline'] == 'split':\n"
        "    s = split_mod.run_split(split_mod.SplitPipelineArgs(**args))\n"
        "elif spec['pipeline'] == 'dedup':\n"
        "    s = dedup_mod.run_dedup(dedup_mod.DedupPipelineArgs(**args))\n"
        "else:\n"
        "    s = shard_mod.run_shard(shard_mod.ShardPipelineArgs(**args))\n"
        "json.dump(s, open(spec['summary'], 'w'))\n"
        "if spec['output_zip_multipart']:\n"
        "    from cosmos_curate_tpu_torch.storage.zip_transport import PresignedMultipart, zip_and_upload_directory\n"
        "    zip_and_upload_directory(args['output_path'], PresignedMultipart.from_dict(spec['output_zip_multipart']))\n"
        "elif spec['output_zip_url']:\n"
        "    from cosmos_curate_tpu_torch.storage.zip_transport import zip_and_upload_directory\n"
        "    zip_and_upload_directory(args['output_path'], spec['output_zip_url'])\n"
    )


def _default_runner_cmd(record: JobRecord, work_dir: Path) -> list[str]:
    return [
        sys.executable,
        "-c",
        _runner_code(
            record.pipeline,
            record.args,
            str(work_dir / "summary.json"),
            work_dir=str(work_dir),
            input_zip_url=record.input_zip_url,
            output_zip_url=record.output_zip_url,
            output_zip_multipart=record.output_zip_multipart,
        ),
    ]


def job_env(record: JobRecord | None = None) -> dict[str, str]:
    """The job subprocess environment: a full copy of the ambient env —
    which by construction carries the cross-process contracts
    ``CURATE_CHAOS`` (armed fault plans fire inside job children) and
    ``CURATE_DLQ_DIR`` (the job's engine dead-letters where the operator
    configured); tests/service pin that guarantee down in the child — plus
    two additions the ambient env cannot provide:

    - ``CURATE_TRACING`` / ``CURATE_TRACEPARENT``: when the service itself
      is tracing, its *current span* (not just an inherited env var)
      becomes the job's process parent, so one trace spans
      submit → job → pipeline workers
    - ``CURATE_WORKER_ID=job-<id>-a<attempt>``: chaos rules target a
      specific attempt (``worker_re="-a1$"`` faults only the first try),
      and crash recovery uses it to identify orphaned job processes
    """
    env = dict(os.environ)
    from cosmos_curate_tpu_torch.observability.tracing import (
        TRACEPARENT_ENV,
        format_traceparent,
        tracing_enabled,
    )

    if tracing_enabled() or os.environ.get("CURATE_TRACING") == "1":
        env["CURATE_TRACING"] = "1"
        tp = format_traceparent() or os.environ.get(TRACEPARENT_ENV, "")
        if tp:
            env[TRACEPARENT_ENV] = tp
    if record is not None:
        env["CURATE_WORKER_ID"] = f"job-{record.job_id}-a{record.attempts}"
    return env


def tail_lines(path: Path, n: int, *, max_bytes: int = _LOG_TAIL_MAX_BYTES) -> list[str]:
    """Last ``n`` lines of ``path`` without reading the whole file: seek to
    the end and walk backwards in blocks until enough newlines (or the
    ``max_bytes`` cap) — a multi-GB job log costs one bounded read."""
    if not path.exists() or n <= 0:
        return []
    block = 64 * 1024
    chunks: list[bytes] = []
    newlines = 0
    read = 0
    with open(path, "rb") as f:
        f.seek(0, os.SEEK_END)
        pos = f.tell()
        while pos > 0 and newlines <= n and read < max_bytes:
            step = min(block, pos, max_bytes - read)
            pos -= step
            f.seek(pos)
            chunk = f.read(step)
            chunks.append(chunk)
            newlines += chunk.count(b"\n")
            read += step
    text = b"".join(reversed(chunks)).decode("utf-8", errors="replace")
    return text.splitlines()[-n:]


# ---------------------------------------------------------------------------
# service state


class ServiceState:
    def __init__(
        self,
        work_root: str,
        config: ServiceConfig,
        *,
        runner_cmd: Callable[[JobRecord, Path], list[str]] | None = None,
    ) -> None:
        self.work_root = Path(work_root)
        self.work_root.mkdir(parents=True, exist_ok=True)
        self.config = config
        self.journal = JobJournal(self.work_root / "journal.ndjson")
        self.admission = AdmissionController(config.quota)
        self.runner_cmd = runner_cmd or _default_runner_cmd
        self.jobs: dict[str, JobRecord] = {}
        self.procs: dict[str, subprocess.Popen] = {}
        self.draining = False
        self.stopping = False  # dispatcher exit flag (cooperative, not cancel)
        self.watchers: set[asyncio.Task] = set()  # strong refs (GC guard)
        self.wake: asyncio.Event | None = None  # created on the app's loop
        self.slo = SloTracker(config.slo)
        # readiness: flips False on a journal append failure, True on the
        # next success — /health's journal_writable field
        self.journal_ok = True
        self.dispatcher_running = False
        # live-ops anomaly relay: job_id -> anomaly_count already journaled
        # (job children detect; the service journals + exports for them)
        self._anomaly_seen: dict[str, int] = {}
        self._anomaly_scan_at = 0.0
        # journaling executor: ONE thread so appends stay ordered without a
        # lock, and the fsync never runs on the event loop (an fsync on the
        # loop stalls every in-flight request — interactive-lane latency
        # paying for batch-job journaling). Sync callers (_recover at boot,
        # tests) still call record_transition directly.
        self._journal_exec = ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="journal"
        )
        from cosmos_curate_tpu_torch.engine.metrics import get_metrics

        self.metrics = get_metrics()
        if config.metrics_port is not None:
            self.metrics.ensure_server(config.metrics_port)
        self._recover()

    # ---- durability ----------------------------------------------------

    def _recover(self) -> None:
        """Boot-time journal replay: re-enqueue pending/interrupted jobs,
        compact the journal back to one line per job."""
        records, requeue_ids = recover_records(self.journal)
        self.jobs = records
        now = time.time()
        for job_id in requeue_ids:
            rec = self.jobs[job_id]
            was = rec.state
            rec.state = "pending"
            rec.enqueued_s = now
            self.admission.requeue(rec)
            self.record_transition(rec, f"recovered-{was}")
            logger.info("job %s recovered from journal (%s → pending)", job_id, was)
        self.journal.compact(self.jobs)
        self._export_states()

    def record_transition(self, rec: JobRecord, event: str, *, required: bool = False) -> None:
        """Journal + metrics for one transition. ``required=True`` (the
        submit ack) propagates a journal failure to the caller; otherwise
        durability degrades to in-memory with a loud log — resume records
        make the resulting re-run idempotent."""
        try:
            self.journal.append(rec, event)
            self.journal_ok = True
        except JournalWriteError:
            self.journal_ok = False
            if required:
                raise
            logger.exception(
                "journal append failed for job %s (%s); state held in memory only",
                rec.job_id, event,
            )
        self.metrics.observe_service_transition(rec.tenant, rec.state)
        if rec.state in TERMINAL_STATES and event not in ("evicted",):
            # SLO accounting: run duration + success window on every
            # terminal entry (a requeued job that dies again is a new
            # outcome — correct: the tenant experienced both)
            duration = (
                (rec.finished_s - rec.started_s)
                if rec.finished_s and rec.started_s
                else None
            )
            self._note_slo_breaches(
                rec, self.slo.observe_terminal(rec.tenant, rec.state, duration)
            )
        self._export_states()

    async def on_journal_thread(self, fn: Callable, *args, **kwargs):
        """Run a journaling (fsync-bearing) callable on the single-thread
        journal executor. Appends stay ordered (one thread) and the event
        loop never blocks on the disk."""
        loop = asyncio.get_running_loop()
        return await loop.run_in_executor(
            self._journal_exec, functools.partial(fn, *args, **kwargs)
        )

    async def record_transition_async(
        self, rec: JobRecord, event: str, *, required: bool = False
    ) -> None:
        """:meth:`record_transition` off the event loop — what every
        coroutine must use (the blocking-in-async lint rule enforces it).
        The journal thread gets a copy of the record as it stands now: the
        loop may move the record on (a terminate right after a dispatch)
        before that thread writes the line and counts the transition, which
        must carry this transition's state."""
        await self.on_journal_thread(
            self.record_transition, copy.copy(rec), event, required=required
        )

    def _export_states(self) -> None:
        counts = {s: 0 for s in JOB_STATES}
        # list(): this runs on the journal thread too, concurrent with
        # loop-side inserts/evictions of self.jobs
        for rec in list(self.jobs.values()):
            counts[rec.state] = counts.get(rec.state, 0) + 1
        self.metrics.set_service_states(counts)
        for lane in LANES:
            self.metrics.set_service_queue_depth(lane, self.admission.lane_depth(lane))

    def _note_slo_breaches(self, rec: JobRecord, kinds: list[str]) -> None:
        """Metrics + a journal receipt per breached SLO kind. Raw journal
        append (never record_transition — the record's state did not
        change, and a breach must not re-fire the terminal SLO hook);
        replay ignores unknown events, so durability semantics hold."""
        for kind in kinds:
            self.metrics.observe_slo_breach(rec.tenant, kind)
            logger.warning(
                "SLO breach (%s) for tenant %s on job %s",
                kind, rec.tenant, rec.job_id,
            )
            try:
                self.journal.append(rec, f"slo-breach:{kind}")
            except JournalWriteError:
                self.journal_ok = False

    # ---- live ops ------------------------------------------------------

    def output_root(self, rec: JobRecord) -> Path:
        """The job's pipeline output root (where run_report.json and the
        live status snapshot land)."""
        return Path(
            str(rec.args.get("output_path") or self.work_dir(rec.job_id) / "output")
        )

    def job_live_status(self, rec: JobRecord) -> dict | None:
        """The job child's latest live snapshot (None before the first
        publish / for pipelines that don't publish)."""
        from cosmos_curate_tpu_torch.observability.live_status import read_status

        return read_status(str(self.output_root(rec)))

    def scan_job_anomalies(self, now: float | None = None) -> int:
        """Dispatcher-tick relay: read each running job's live snapshot and
        journal (+ export) anomaly verdicts the job child detected — the
        child has no journal and no metrics exporter, the service has both.
        Rate-limited; returns how many NEW anomalies were relayed."""
        now = time.time() if now is None else now
        if now - self._anomaly_scan_at < self.config.anomaly_scan_interval_s:
            return 0
        self._anomaly_scan_at = now
        relayed = 0
        for rec in self.running_records():
            snap = self.job_live_status(rec)
            if not snap:
                continue
            total = int(snap.get("anomaly_count") or 0)
            seen = self._anomaly_seen.get(rec.job_id, 0)
            if total <= seen:
                continue
            # the snapshot carries a bounded tail of recent events; relay
            # the newest (total - seen), or the whole tail if more
            # happened than the tail kept
            tail = [ev for ev in (snap.get("anomalies") or []) if isinstance(ev, dict)]
            for ev in tail[-min(total - seen, len(tail)) :] if tail else ():
                self.metrics.observe_anomaly(
                    str(ev.get("stage") or "_run"), str(ev.get("kind") or "unknown")
                )
                try:
                    self.journal.append(rec, f"anomaly:{ev.get('kind')}")
                except JournalWriteError:
                    self.journal_ok = False
                relayed += 1
            self._anomaly_seen[rec.job_id] = total
        # forget jobs that left the running set (bounded growth)
        running = {r.job_id for r in self.running_records()}
        for job_id in [j for j in list(self._anomaly_seen) if j not in running]:
            del self._anomaly_seen[job_id]
        return relayed

    # ---- paths ---------------------------------------------------------

    def work_dir(self, job_id: str) -> Path:
        return self.work_root / "jobs" / job_id

    def log_path(self, job_id: str) -> Path:
        return self.work_dir(job_id) / "job.log"

    def summary_path(self, job_id: str) -> Path:
        return self.work_dir(job_id) / "summary.json"

    def report_path(self, rec: JobRecord) -> Path:
        """The job's flight-recorder receipt (observability/flight_recorder.py
        writes ``<output>/report/run_report.json`` at finalize)."""
        out = str(rec.args.get("output_path") or self.work_dir(rec.job_id) / "output")
        return Path(out) / "report" / "run_report.json"

    # ---- queries -------------------------------------------------------

    def running_records(self) -> list[JobRecord]:
        # list(): called from both the loop and the journal thread
        return [r for r in list(self.jobs.values()) if r.state == "running"]

    def gc_terminal(self) -> None:
        """Evict old terminal records (dispatcher tick). Each eviction is a
        journal tombstone, so a restart doesn't resurrect them; a journal
        outage just defers the eviction to a later tick."""
        now = time.time()
        terminal = sorted(
            (
                r for r in list(self.jobs.values())
                if r.state in TERMINAL_STATES and r.finished_s
            ),
            key=lambda r: r.finished_s,
        )
        expired = [
            r for r in terminal
            if now - r.finished_s > self.config.retain_terminal_s
        ]
        overflow = len(terminal) - len(expired) - self.config.max_terminal_records
        if overflow > 0:
            keep = [r for r in terminal if now - r.finished_s <= self.config.retain_terminal_s]
            expired.extend(keep[:overflow])  # oldest first
        for rec in expired:
            try:
                self.journal.append(rec, "evicted")
            except JournalWriteError:
                continue  # keep the record; retry next tick
            del self.jobs[rec.job_id]
        if expired:
            self._export_states()

    def state_counts(self) -> dict[str, int]:
        counts: dict[str, int] = {}
        for rec in list(self.jobs.values()):
            counts[rec.state] = counts.get(rec.state, 0) + 1
        return counts

    def kick(self) -> None:
        if self.wake is not None:
            self.wake.set()


# ---------------------------------------------------------------------------
# dispatch + supervision


def _spawn_proc(state: ServiceState, rec: JobRecord, work_dir: Path) -> subprocess.Popen:
    """Blocking half of a launch (log open + fork/exec): runs on an
    executor thread, never on the event loop."""
    work_dir.mkdir(parents=True, exist_ok=True)
    log_f = open(state.log_path(rec.job_id), "ab")
    try:
        return subprocess.Popen(
            state.runner_cmd(rec, work_dir),
            stdout=log_f,
            stderr=subprocess.STDOUT,
            cwd=str(Path(__file__).resolve().parents[2]),
            env=job_env(rec),
            start_new_session=True,  # session leader: killpg reaps the tree
        )
    finally:
        log_f.close()  # child holds its own fd; parent must not leak one per job


async def _launch(state: ServiceState, rec: JobRecord) -> None:
    """Spawn one attempt of ``rec`` in its own session. A spawn failure is
    terminal ``failed`` (the command never started — retrying a bad spec
    only burns attempts). The fork/exec and the journal appends run on
    executor threads; every ``await`` is an interleave point, so the
    terminated-while-launching race is re-checked after the spawn."""
    rec.attempts += 1
    work_dir = state.work_dir(rec.job_id)
    wait_s = max(0.0, time.time() - rec.enqueued_s)
    loop = asyncio.get_running_loop()
    try:
        proc = await loop.run_in_executor(
            None, functools.partial(_spawn_proc, state, rec, work_dir)
        )
    except Exception as e:
        rec.state = "failed"
        rec.error = f"spawn failed: {e}"
        rec.finished_s = time.time()
        await state.record_transition_async(rec, "spawn-failed")
        logger.exception("job %s spawn failed", rec.job_id)
        return
    if rec.state == "terminated":
        # terminate() landed while the fork/exec was in flight: honor the
        # operator's verdict — kill the fresh group; the watcher reaps it
        # without resurrecting (terminate already journaled the state)
        state.procs[rec.job_id] = proc
        _killpg(proc.pid, signal.SIGTERM)
        task = asyncio.create_task(_watch_job(state, rec, proc))
        state.watchers.add(task)
        task.add_done_callback(state.watchers.discard)
        return
    rec.state = "running"
    rec.pid = proc.pid
    if rec.started_s is None:
        rec.started_s = time.time()
    state.procs[rec.job_id] = proc
    await state.record_transition_async(rec, "running")
    state.metrics.observe_service_dispatch(rec.priority, wait_s)
    await state.on_journal_thread(
        state._note_slo_breaches, rec, state.slo.observe_dispatch(rec.tenant, wait_s)
    )
    # fresh attempt = fresh detector: its anomaly_count restarts at 0, so
    # a stale high-water mark from a prior attempt would suppress relay
    state._anomaly_seen.pop(rec.job_id, None)
    task = asyncio.create_task(_watch_job(state, rec, proc))
    state.watchers.add(task)  # event loop holds only weak refs
    task.add_done_callback(state.watchers.discard)
    logger.info(
        "job %s dispatched (tenant=%s lane=%s attempt %d/%d pid=%d, waited %.2fs)",
        rec.job_id, rec.tenant, rec.priority, rec.attempts, rec.max_attempts,
        proc.pid, wait_s,
    )


async def _watch_job(state: ServiceState, rec: JobRecord, proc: subprocess.Popen) -> None:
    loop = asyncio.get_running_loop()
    rc = await loop.run_in_executor(None, proc.wait)
    state.procs.pop(rec.job_id, None)
    rec.pid = None
    if rec.state in ("terminated", "interrupted"):
        # terminate() / drain checkpoint already journaled the state; the
        # exit just confirms the kill landed
        rec.finished_s = rec.finished_s or time.time()
        state.kick()
        return
    if rc == 0 and state.summary_path(rec.job_id).exists():
        rec.state = "done"
        rec.finished_s = time.time()
        rec.error = ""
        await state.record_transition_async(rec, "done")
        logger.info("job %s done (attempt %d)", rec.job_id, rec.attempts)
        state.kick()
        return
    tail = tail_lines(state.log_path(rec.job_id), 5)
    rec.error = f"exit code {rc}" + (f": {tail[-1][:500]}" if tail else "")
    if rec.attempts >= rec.max_attempts:
        rec.state = "dead_lettered"
        rec.finished_s = time.time()
        await state.record_transition_async(rec, "dead-lettered")
        logger.error(
            "job %s dead-lettered after %d attempts (%s)",
            rec.job_id, rec.attempts, rec.error,
        )
        state.kick()
        return
    # transient failure: full-jitter backoff, then back into the lane. The
    # record flips to pending BEFORE the sleep — a backing-off job must not
    # hold a dispatch slot (or its tenant's running cap) while no process
    # exists, and a crash during the sleep replays it as plain pending.
    delay = backoff_s(
        rec.attempts - 1, base=state.config.retry_base_s, cap=state.config.retry_cap_s
    )
    logger.warning(
        "job %s attempt %d/%d failed (%s); retrying in %.2fs",
        rec.job_id, rec.attempts, rec.max_attempts, rec.error, delay,
    )
    rec.state = "pending"
    await state.record_transition_async(rec, "retry")
    state.kick()  # freed capacity is usable during the backoff
    if not state.draining:
        await asyncio.sleep(delay)
    if rec.state == "terminated":
        # the operator terminated the job during the backoff sleep; honor
        # the kill, don't resurrect
        rec.finished_s = rec.finished_s or time.time()
        state.kick()
        return
    if state.draining:
        # journaled pending: the next boot's replay re-enqueues it
        state.kick()
        return
    # enqueued_s stamps AFTER the backoff: queue-wait must measure time
    # spent waiting for capacity, not the deliberate retry delay
    rec.enqueued_s = time.time()
    state.admission.requeue(rec)
    state.kick()


async def _dispatch_loop(app: web.Application) -> None:
    """The scheduler: drain admission lanes into subprocesses whenever
    capacity frees up. Woken by submit/finish/retry; 0.5 s tick as a
    backstop."""
    state: ServiceState = app["state"]
    state.wake = asyncio.Event()
    # exits via state.stopping, NOT task cancellation: py3.10's wait_for can
    # swallow a CancelledError that races its timeout expiry (bpo-42130),
    # which left a cancelled dispatcher looping forever and shutdown hung
    state.dispatcher_running = True
    try:
        while not state.stopping:
            state.wake.clear()
            if not state.draining:
                while True:
                    rec = state.admission.pop_next(state.running_records())
                    if rec is None:
                        break
                    if rec.job_id not in state.jobs:
                        # submit ack (journal append) still in flight on the
                        # executor — invoke() inserts into state.jobs only
                        # after the fsync lands. Not dispatchable yet; put it
                        # back and let the next tick retry.
                        state.admission.requeue(rec)
                        break
                    await _launch(state, rec)
                await state.on_journal_thread(state.gc_terminal)
                state._export_states()
            try:
                # live-ops relay rides the dispatcher tick: journal + export
                # anomaly verdicts running job children published (reads
                # snapshots + appends, so it runs on the journal thread)
                await state.on_journal_thread(state.scan_job_anomalies)
            except Exception:
                logger.exception("anomaly scan failed (dispatcher unaffected)")
            try:
                await asyncio.wait_for(state.wake.wait(), timeout=0.5)
            except asyncio.TimeoutError:
                pass
    finally:
        state.dispatcher_running = False


def _killpg(pid: int, sig: int) -> None:
    try:
        os.killpg(pid, sig)
    except (ProcessLookupError, PermissionError):
        pass


async def _escalate_kill(proc: subprocess.Popen, grace_s: float) -> None:
    """SIGTERM was sent to the job's process group; if the group leader is
    still alive after ``grace_s``, SIGKILL the whole group. Worker
    subprocesses of a terminated job must not outlive it."""
    loop = asyncio.get_running_loop()
    try:
        await asyncio.wait_for(loop.run_in_executor(None, proc.wait), grace_s)
    except asyncio.TimeoutError:
        _killpg(proc.pid, signal.SIGKILL)


async def drain_app(app: web.Application, drain_s: float | None = None) -> None:
    """Graceful SIGTERM drain: stop admitting (invoke → 503), let running
    jobs finish within ``drain_s``, checkpoint survivors as ``interrupted``
    (journaled → next boot resumes them), leave queued jobs journaled
    ``pending``. After this returns every job is terminal or journaled for
    the next boot — nothing is silently forgotten."""
    state: ServiceState = app["state"]
    state.draining = True
    deadline = time.monotonic() + (state.config.drain_s if drain_s is None else drain_s)
    while state.procs and time.monotonic() < deadline:
        await asyncio.sleep(0.1)
    survivors = list(state.procs.items())
    for job_id, proc in survivors:
        rec = state.jobs[job_id]
        if rec.state == "running":
            # a proc in a non-running state is a terminated job mid-kill:
            # kill it with the rest but keep the operator's verdict — the
            # next boot must NOT resurrect it as interrupted
            rec.state = "interrupted"
            rec.pid = None
            await state.record_transition_async(rec, "drain-checkpoint")
            logger.info("drain: job %s checkpointed as interrupted", job_id)
        _killpg(proc.pid, signal.SIGTERM)
    if survivors:
        grace = min(2.0, state.config.term_grace_s)
        loop = asyncio.get_running_loop()
        for _, proc in survivors:
            try:
                await asyncio.wait_for(loop.run_in_executor(None, proc.wait), grace)
            except asyncio.TimeoutError:
                _killpg(proc.pid, signal.SIGKILL)
    state.kick()


# ---------------------------------------------------------------------------
# HTTP surface


def build_app(
    work_root: str = "/tmp/curate_service",
    config: ServiceConfig | None = None,
    *,
    runner_cmd: Callable[[JobRecord, Path], list[str]] | None = None,
    search_config=None,
) -> web.Application:
    cfg = config or ServiceConfig()
    state = ServiceState(work_root, cfg, runner_cmd=runner_cmd)
    app = web.Application()
    app["state"] = state
    search_state = None
    if search_config is not None and getattr(search_config, "index_path", ""):
        # retrieval rides next to the job API, but with its OWN admission
        # lane (service/search.py): searches shed on their own quota,
        # independent of the job queue
        from cosmos_curate_tpu_torch.service.search import SearchState, register_search_routes

        search_state = SearchState(search_config)
        app["search"] = search_state
        register_search_routes(app, search_state)

    async def health(request: web.Request) -> web.Response:
        """Liveness AND readiness in one payload: k8s-style probes read
        ``ready`` (dispatcher running + journal writable + not draining),
        `top` reads the same fields — one source for both."""
        running = state.running_records()
        # cheap journal probe between appends: the parent dir must remain
        # writable or the next submit will 503 — surface it here first
        journal_writable = state.journal_ok and os.access(
            state.journal.path.parent, os.W_OK
        )
        dispatcher_running = state.dispatcher_running
        out = {
            "status": "draining" if state.draining else "ok",
            "ready": bool(
                dispatcher_running and journal_writable and not state.draining
            ),
            "dispatcher_running": dispatcher_running,
            "journal_writable": journal_writable,
            "active_job": running[0].job_id if running else None,
            "running_jobs": [r.job_id for r in running],
            "num_jobs": len(state.jobs),
            "states": state.state_counts(),
            "queued": {lane: state.admission.lane_depth(lane) for lane in LANES},
            "max_concurrent": state.admission.effective_max_running(),
            "slo_enabled": state.config.slo.enabled,
        }
        if search_state is not None:
            out["search"] = search_state.stats()
            # index-server generation, hoisted for readiness probes that
            # gate on "serving search at generation >= N"
            gen = out["search"].get("generation")
            if gen is not None:
                out["index_generation"] = gen
        return web.json_response(out)

    async def list_jobs(request: web.Request) -> web.Response:
        tenant = request.query.get("tenant", "")
        want_state = request.query.get("state", "")
        out = []
        for rec in state.jobs.values():
            if tenant and rec.tenant != tenant:
                continue
            if want_state and rec.state != want_state:
                continue
            out.append(
                {
                    "job_id": rec.job_id,
                    "pipeline": rec.pipeline,
                    "tenant": rec.tenant,
                    "priority": rec.priority,
                    "state": rec.state,
                    "attempts": rec.attempts,
                    "pid": rec.pid,
                }
            )
        return web.json_response({"jobs": out})

    async def invoke(request: web.Request) -> web.Response:
        if state.draining:
            return web.json_response(
                {"error": "service is draining"},
                status=503,
                headers={"Retry-After": "30"},
            )
        try:
            body = await request.json()
        except json.JSONDecodeError:
            return web.json_response({"error": "invalid JSON body"}, status=400)
        if not isinstance(body, dict):
            # valid JSON but not an object ([1,2], "split", 3): .get below
            # would 500, not 400
            return web.json_response({"error": "body must be a JSON object"}, status=400)
        pipeline = body.get("pipeline")
        args = body.get("args", {})
        if pipeline not in _PIPELINES:
            return web.json_response(
                {"error": f"pipeline must be one of {sorted(_PIPELINES)}"}, status=400
            )
        if not isinstance(args, dict):
            return web.json_response({"error": "args must be an object"}, status=400)
        tenant = body.get("tenant", "default")
        priority = body.get("priority", "batch")
        if not isinstance(tenant, str) or not _TENANT_RE.fullmatch(tenant):
            # bounded charset+length: the tenant string becomes a journal
            # field, a work-dir-adjacent id, and a prometheus label
            return web.json_response(
                {"error": "tenant must match [A-Za-z0-9._:-]{1,64}"}, status=400
            )
        if priority not in LANES:
            return web.json_response(
                {"error": f"priority must be one of {list(LANES)}"}, status=400
            )
        try:
            max_attempts = int(body.get("max_attempts", cfg.max_attempts))
        except (TypeError, ValueError):
            return web.json_response({"error": "max_attempts must be an int"}, status=400)
        if max_attempts < 1:
            return web.json_response({"error": "max_attempts must be >= 1"}, status=400)
        input_zip_url = body.get("input_zip_url", "")
        output_zip_url = body.get("output_zip_url", "")
        # multi-GB outputs go through presigned multipart (per-part retry,
        # no single-PUT size limits, reference presigned_s3_zip.py:334)
        output_zip_multipart = body.get("output_zip_multipart")
        if not isinstance(input_zip_url, str) or not isinstance(output_zip_url, str):
            return web.json_response({"error": "zip urls must be strings"}, status=400)
        if output_zip_multipart is not None and (
            not isinstance(output_zip_multipart, dict)
            or not output_zip_multipart.get("part_urls")
            or not output_zip_multipart.get("complete_url")
        ):
            return web.json_response(
                {"error": "output_zip_multipart needs part_urls + complete_url"},
                status=400,
            )
        if (output_zip_url or output_zip_multipart) and "://" in str(args.get("output_path", "")):
            # zipping a remote output root would silently upload an empty
            # archive — the zip leaves from a local directory
            return web.json_response(
                {"error": "output_zip_url requires a local output_path (or none)"},
                status=400,
            )
        rec = JobRecord.new(
            pipeline,
            args,
            tenant=tenant,
            priority=priority,
            max_attempts=max_attempts,
            input_zip_url=input_zip_url,
            output_zip_url=output_zip_url,
            output_zip_multipart=output_zip_multipart,
        )
        decision = state.admission.admit(rec)
        if not decision.admitted:
            if not decision.retry_after_s:  # malformed, not over-capacity
                return web.json_response({"error": decision.reason}, status=400)
            # never-admitted tenants (tenant_limit, or queue_full before
            # first admission) must not mint new metric label series
            shed_label = tenant if state.admission.is_known_tenant(tenant) else "_other"
            state.metrics.observe_service_shed(shed_label, decision.reason)
            logger.warning(
                "shed %s job from tenant %s: %s (retry after %.1fs)",
                priority, tenant, decision.reason, decision.retry_after_s,
            )
            return web.json_response(
                {
                    "error": "over quota, retry later",
                    "reason": decision.reason,
                    "retry_after_s": decision.retry_after_s,
                },
                status=429,
                headers={"Retry-After": str(int(decision.retry_after_s) or 1)},
            )
        try:
            # durability gate: the ack implies the journal has the job. The
            # fsync happens on the journal thread; the dispatcher skips
            # admitted-but-not-yet-acked records (not in state.jobs) so the
            # await below cannot race a launch.
            await state.record_transition_async(rec, "submit", required=True)
        except JournalWriteError as e:
            state.admission.remove(rec.job_id)
            logger.error("refusing job: %s", e)
            return web.json_response(
                {"error": f"journal unavailable: {e}"}, status=503
            )
        state.jobs[rec.job_id] = rec
        state.kick()
        return web.json_response(
            {
                "job_id": rec.job_id,
                "state": rec.state,
                "tenant": rec.tenant,
                "priority": rec.priority,
            }
        )

    def _get_job(request: web.Request) -> JobRecord | None:
        return state.jobs.get(request.match_info["job_id"])

    async def progress(request: web.Request) -> web.Response:
        rec = _get_job(request)
        if rec is None:
            return web.json_response({"error": "unknown job"}, status=404)
        out = {
            "job_id": rec.job_id,
            "pipeline": rec.pipeline,
            "tenant": rec.tenant,
            "priority": rec.priority,
            "state": rec.state,
            "attempts": rec.attempts,
            "max_attempts": rec.max_attempts,
            "elapsed_s": (rec.finished_s or time.time()) - rec.submitted_s,
        }
        if rec.error:
            out["error"] = rec.error
        if rec.state == "done":
            out["summary"] = json.loads(state.summary_path(rec.job_id).read_text())
        report = state.report_path(rec)
        if report.exists():
            # the tenant-facing receipt: trace ids, critical path, per-stage
            # times (render with `cosmos-curate-tpu report`)
            out["report"] = str(report)
        return web.json_response(out)

    async def job_status(request: web.Request) -> web.Response:
        """Live in-flight introspection for one job: the child's latest
        atomically-swapped snapshot (per-stage queue/busy/in-flight data)
        plus the stall detector's verdicts — /v1/progress tells you the
        job's lifecycle state, THIS tells you whether it is actually
        moving."""
        from cosmos_curate_tpu_torch.observability.live_status import snapshot_age_s

        rec = _get_job(request)
        if rec is None:
            return web.json_response({"error": "unknown job"}, status=404)
        snap = state.job_live_status(rec)
        out = {
            "job_id": rec.job_id,
            "state": rec.state,
            "tenant": rec.tenant,
            "attempts": rec.attempts,
            "live": snap is not None,
            "output_path": str(state.output_root(rec)),
        }
        if snap is None:
            out["detail"] = (
                "no live snapshot yet (job not started, pipeline predates "
                "live status, or output root is remote)"
            )
        else:
            out["snapshot"] = snap
            out["snapshot_age_s"] = round(snapshot_age_s(snap), 3)
            out["anomalies"] = snap.get("anomalies") or []
            out["anomaly_count"] = int(snap.get("anomaly_count") or 0)
            out["stale"] = bool(
                rec.state == "running"
                and snap.get("state") == "running"
                and out["snapshot_age_s"] > 30.0
            )
        return web.json_response(out)

    async def slo(request: web.Request) -> web.Response:
        """Per-tenant SLO standing: observed queue-wait / run-duration /
        success-rate against the configured targets, with breach counts
        (the counter view is service_slo_breaches_total{tenant,kind})."""
        report = state.slo.report()
        # live context: what each tenant has queued/running right now
        occupancy: dict[str, dict] = {}
        for rec in state.jobs.values():
            occ = occupancy.setdefault(rec.tenant, {"queued": 0, "running": 0})
            if rec.state == "pending":
                occ["queued"] += 1
            elif rec.state == "running":
                occ["running"] += 1
        report["occupancy"] = occupancy
        return web.json_response(report)

    async def logs(request: web.Request) -> web.Response:
        rec = _get_job(request)
        if rec is None:
            return web.json_response({"error": "unknown job"}, status=404)
        try:
            tail = int(request.query.get("tail", "200"))
        except ValueError:
            return web.json_response({"error": "tail must be an int"}, status=400)
        lines = tail_lines(state.log_path(rec.job_id), tail)
        return web.json_response({"job_id": rec.job_id, "lines": lines})

    async def terminate(request: web.Request) -> web.Response:
        rec = _get_job(request)
        if rec is None:
            return web.json_response({"error": "unknown job"}, status=404)
        if rec.state == "pending":
            state.admission.remove(rec.job_id)
            rec.state = "terminated"
            rec.finished_s = time.time()
            await state.record_transition_async(rec, "terminated-queued")
        elif rec.state == "running":
            rec.state = "terminated"
            rec.finished_s = time.time()
            await state.record_transition_async(rec, "terminated")
            proc = state.procs.get(rec.job_id)
            if proc is not None and proc.poll() is None:
                # the whole process group: pipeline worker subprocesses must
                # not outlive a terminated job. SIGTERM first, SIGKILL after
                # the grace window.
                _killpg(proc.pid, signal.SIGTERM)
                task = asyncio.create_task(
                    _escalate_kill(proc, cfg.term_grace_s)
                )
                state.watchers.add(task)
                task.add_done_callback(state.watchers.discard)
        return web.json_response({"job_id": rec.job_id, "state": rec.state})

    async def requeue(request: web.Request) -> web.Response:
        rec = _get_job(request)
        if rec is None:
            return web.json_response({"error": "unknown job"}, status=404)
        if state.draining:
            return web.json_response({"error": "service is draining"}, status=503)
        if rec.state not in ("dead_lettered", "failed", "terminated"):
            return web.json_response(
                {"error": f"cannot requeue a {rec.state} job"}, status=409
            )
        if rec.job_id in state.procs:
            # a terminated job whose SIGTERM→SIGKILL escalation is still in
            # flight: re-admitting now would run two copies against one
            # work_dir and let the old exit corrupt the new attempt's state
            return web.json_response(
                {"error": "job process is still exiting; retry shortly"},
                status=409,
            )
        snapshot = (rec.state, rec.attempts, rec.error, rec.finished_s, rec.enqueued_s)
        rec.attempts = 0
        rec.error = ""
        rec.state = "pending"
        rec.finished_s = None
        rec.enqueued_s = time.time()
        decision = state.admission.admit(rec)
        if not decision.admitted:
            # shed: the record must be exactly as it was before the request
            rec.state, rec.attempts, rec.error, rec.finished_s, rec.enqueued_s = snapshot
            state.metrics.observe_service_shed(rec.tenant, decision.reason)
            return web.json_response(
                {"error": "over quota, retry later", "reason": decision.reason},
                status=429,
                headers={"Retry-After": str(int(decision.retry_after_s) or 1)},
            )
        await state.record_transition_async(rec, "requeued")
        state.kick()
        return web.json_response({"job_id": rec.job_id, "state": rec.state})

    async def models(request: web.Request) -> web.Response:
        """Weights-registry status (reference nvcf_model_manager equivalent:
        core/cf/nvcf_model_manager.py — which models a deployment has
        staged)."""
        from cosmos_curate_tpu_torch.models import registry

        out = {}
        for mid in registry.registered_models():
            ckpt = registry.local_dir_for(mid) / "params.msgpack"
            out[mid] = {
                "staged": ckpt.exists(),
                "size_bytes": ckpt.stat().st_size if ckpt.exists() else 0,
            }
        return web.json_response({"weights_root": str(registry.weights_root()), "models": out})

    async def _start_dispatcher(app: web.Application) -> None:
        app["dispatcher"] = asyncio.create_task(_dispatch_loop(app))

    async def _stop_dispatcher(app: web.Application) -> None:
        state.stopping = True
        state.kick()
        task = app.get("dispatcher")
        if task is not None:
            try:
                await asyncio.wait_for(task, 5.0)
            except (asyncio.TimeoutError, asyncio.CancelledError):
                task.cancel()  # backstop; the flag should have sufficed
        for watcher in list(state.watchers):
            watcher.cancel()
        # after the dispatcher and watchers stop, nothing schedules journal
        # work; drain the queued appends before the process exits
        state._journal_exec.shutdown(wait=True)

    app.on_startup.append(_start_dispatcher)
    app.on_cleanup.append(_stop_dispatcher)

    app.router.add_get("/health", health)
    app.router.add_get("/v1/models", models)
    app.router.add_get("/v1/jobs", list_jobs)
    app.router.add_post("/v1/invoke", invoke)
    app.router.add_get("/v1/progress/{job_id}", progress)
    app.router.add_get("/v1/jobs/{job_id}/status", job_status)
    app.router.add_get("/v1/slo", slo)
    app.router.add_get("/v1/logs/{job_id}", logs)
    app.router.add_post("/v1/terminate/{job_id}", terminate)
    app.router.add_post("/v1/requeue/{job_id}", requeue)
    return app


def serve(
    host: str = "0.0.0.0",
    port: int = 8080,
    work_root: str = "/tmp/curate_service",
    config: ServiceConfig | None = None,
    search_config=None,
) -> None:
    """Run the service until SIGTERM/SIGINT, then drain gracefully."""
    cfg = config or ServiceConfig()

    async def _main() -> None:
        app = build_app(work_root=work_root, config=cfg, search_config=search_config)
        runner = web.AppRunner(app)
        await runner.setup()
        site = web.TCPSite(runner, host, port)
        await site.start()
        logger.info("job service on %s:%d (work_root=%s)", host, port, work_root)
        stop = asyncio.Event()
        loop = asyncio.get_running_loop()
        for sig in (signal.SIGTERM, signal.SIGINT):
            loop.add_signal_handler(sig, stop.set)
        await stop.wait()
        logger.info("signal received: draining (up to %.0fs)", cfg.drain_s)
        await drain_app(app)
        await runner.cleanup()

    asyncio.run(_main())
