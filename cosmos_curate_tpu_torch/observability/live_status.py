"""Live run-status snapshots, the in-flight counterpart of run_report.json
(port of ``cosmos_curate_tpu/observability/live_status.py``).

Both in-process runners publish a bounded JSON snapshot of their live state
(per-stage queue depths, busy fractions, in-flight batch ids with ages and
attempts, worker counts, completed / errored / dead-lettered batches, and
the dispatch, caption and object-plane aggregates) to
``<output>/report/live/status.json``, in the reference's schema. A snapshot
is swapped ATOMICALLY (tmp file + ``os.replace``), so a concurrent reader
sees the previous or the current one, never torn JSON.

Cheap by construction: the publisher reads aggregates stage_timer already
keeps and counters the runners already hold, and rate-limits itself to
``CURATE_LIVE_STATUS_INTERVAL_S`` (default 2 s).

Wiring: ``run_split`` exports ``CURATE_LIVE_STATUS_DIR`` from the run's
output root on every run; a runner makes a :class:`LiveStatusPublisher`
from the environment at ``run()`` and publishes from its own loop, never
from a worker thread. The publisher also drives the anomaly detector
(observability/anomaly.py) over each snapshot and embeds its verdicts. The
reference's renderer (the ``top`` and ``report --follow`` commands) waits
for ROADMAP queue A item 22.
"""

from __future__ import annotations

import json
import os
import time
from pathlib import Path
from typing import Any, Callable

from cosmos_curate_tpu_torch.utils import schema_stamp
from cosmos_curate_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

LIVE_STATUS_DIR_ENV = "CURATE_LIVE_STATUS_DIR"
LIVE_STATUS_ENABLE_ENV = "CURATE_LIVE_STATUS"  # "0" disables publishing
LIVE_STATUS_INTERVAL_ENV = "CURATE_LIVE_STATUS_INTERVAL_S"
DEFAULT_INTERVAL_S = 2.0
STATUS_FILE = "status.json"

# at most this many in-flight batches per stage ride a snapshot (oldest
# first — the stuck ones are what the detector and the operator care about)
MAX_INFLIGHT_PER_STAGE = 16


def live_status_dir() -> str | None:
    """The directory THIS process publishes snapshots to (exported by
    run_split), or None when live status is off."""
    if os.environ.get(LIVE_STATUS_ENABLE_ENV, "1") == "0":
        return None
    return os.environ.get(LIVE_STATUS_DIR_ENV) or None


def export_live_status_dir(output_path: str) -> str | None:
    """Derive the snapshot dir from a run's output root and export it for
    this process (and every worker it spawns). Remote roots (s3://, gs://)
    are skipped — the atomic-swap contract needs a local filesystem — and
    ``CURATE_LIVE_STATUS=0`` disables publishing outright. Each run
    OVERWRITES the env var: a process running several pipelines back to
    back must publish each run under its own output root, never the first
    one's. Returns the dir in effect, or None."""
    if os.environ.get(LIVE_STATUS_ENABLE_ENV, "1") == "0":
        return None
    if "://" in output_path:
        os.environ.pop(LIVE_STATUS_DIR_ENV, None)
        return None
    d = str(Path(output_path) / "report" / "live")
    os.environ[LIVE_STATUS_DIR_ENV] = d
    return d


def read_status(path_or_dir: str) -> dict | None:
    """Tolerant snapshot reader: accepts the status file, its directory, or
    a run output root; returns None when absent or unreadable (a reader
    racing the very first publish must not crash)."""
    p = Path(path_or_dir)
    candidates = [p]
    if not p.name.endswith(".json"):
        candidates = [p / STATUS_FILE, p / "report" / "live" / STATUS_FILE]
    for c in candidates:
        try:
            return json.loads(c.read_text(encoding="utf-8"))
        except (OSError, ValueError):
            continue
    return None


class LiveStatusPublisher:
    """Rate-limited atomic snapshot writer + anomaly-detector driver.

    Construct with :meth:`from_env` (None when live status is off) or with
    an explicit directory. ``maybe_publish(build)`` is the hot-loop entry:
    it calls ``build()`` only when the interval elapsed, augments the
    snapshot with the shared stage_timer sections, runs the detector, and
    swaps the file. Publish failures are swallowed after one loud log —
    status IO must never take down a run."""

    def __init__(
        self,
        directory: str,
        *,
        runner: str = "",
        interval_s: float | None = None,
        detector: "Any | None" = None,
    ) -> None:
        self.dir = Path(directory)
        self.runner = runner
        if interval_s is None:
            try:
                interval_s = float(
                    os.environ.get(LIVE_STATUS_INTERVAL_ENV, "") or DEFAULT_INTERVAL_S
                )
            except ValueError:
                interval_s = DEFAULT_INTERVAL_S
        self.interval_s = max(0.0, interval_s)
        if detector is None:
            from cosmos_curate_tpu_torch.observability.anomaly import AnomalyDetector

            detector = AnomalyDetector()
        self.detector = detector
        self.seq = 0
        self._last_publish = 0.0
        self._started = time.time()
        self._warned = False

    @classmethod
    def from_env(
        cls, *, runner: str = "", detector: "Any | None" = None
    ) -> "LiveStatusPublisher | None":
        d = live_status_dir()
        return cls(d, runner=runner, detector=detector) if d else None

    @property
    def path(self) -> Path:
        return self.dir / STATUS_FILE

    # ------------------------------------------------------------------
    def maybe_publish(self, build: Callable[[], dict]) -> dict | None:
        """Publish if the interval elapsed; returns the snapshot or None."""
        now = time.monotonic()
        if now - self._last_publish < self.interval_s:
            return None
        self._last_publish = now
        return self.publish(build())

    def publish(self, snapshot: dict, *, final: bool = False) -> dict:
        """Augment, detect, and atomically swap one snapshot."""
        self.seq += 1
        # schema_version is the canonical stamp ("version" stays as the
        # legacy alias pre-stamp readers like `top` polled for)
        schema_stamp.stamp(snapshot, "live-status")
        snapshot.setdefault("version", schema_stamp.SCHEMA_VERSIONS["live-status"])
        snapshot.setdefault("ts", time.time())
        snapshot["seq"] = self.seq
        snapshot["pid"] = os.getpid()
        snapshot.setdefault("runner", self.runner)
        snapshot["state"] = "finished" if final else snapshot.get("state", "running")
        snapshot.setdefault("wall_s", round(snapshot["ts"] - self._started, 3))
        self._augment(snapshot)
        if not final:
            # the detector evaluates running snapshots only: a finished
            # run's zero throughput / idle stages are not anomalies
            try:
                self.detector.observe(snapshot)
            except Exception:
                logger.exception("anomaly detector failed (snapshot unaffected)")
        snapshot["anomalies"] = list(self.detector.emitted)[-16:]
        # the monotonic total, NOT the bounded tail's length: readers (the
        # service relay) key new-anomaly deltas on this
        snapshot["anomaly_count"] = int(
            getattr(self.detector, "emitted_total", len(self.detector.emitted))
        )
        self._write(snapshot)
        return snapshot

    def finalize(self, snapshot: dict | None = None) -> None:
        """Terminal snapshot: state=finished so readers (and `top`) can tell
        'run done' from 'publisher died'."""
        self.publish(snapshot or {}, final=True)

    # ------------------------------------------------------------------
    def _augment(self, snapshot: dict) -> None:
        """Attach the bounded aggregates stage_timer already keeps — the
        'no new hot-path instrumentation' contract: everything here is a
        read of existing state."""
        from cosmos_curate_tpu_torch.observability import stage_timer as st

        snapshot.setdefault("node", st.node_id())
        try:
            snapshot.setdefault("dispatch", st.dispatch_summaries())
            caption = st.caption_phase_summaries()
            if caption:
                snapshot.setdefault("caption", caption)
            plane = st.object_plane_summaries()
            if plane:
                snapshot.setdefault("object_plane", plane)
        except Exception:
            logger.exception("live status aggregate collection failed")

    def _write(self, snapshot: dict) -> None:
        try:
            self.dir.mkdir(parents=True, exist_ok=True)
            tmp = self.dir / f".{STATUS_FILE}.{os.getpid()}.tmp"
            tmp.write_text(json.dumps(snapshot), encoding="utf-8")
            os.replace(tmp, self.path)  # atomic swap: readers never see torn JSON
        except OSError as e:
            if not self._warned:
                self._warned = True
                logger.warning(
                    "live status publish to %s failed (%s); further failures "
                    "silent", self.path, e,
                )
