"""Stall and anomaly detector of the live status (port of
``cosmos_curate_tpu/observability/anomaly.py``).

It evaluates SUCCESSIVE live-status snapshots (observability/live_status.py)
and emits a structured event the moment a run starts misbehaving. Kinds
(each tunable through :class:`AnomalyConfig` / ``CURATE_ANOMALY_*``):

- ``stuck_batch``: an in-flight batch's age exceeds
  ``max(stuck_min_age_s, stuck_factor x stage p99 batch seconds)``;
- ``starved_stage``: a started stage sits at busy ~0 with an empty input
  queue while an EARLIER stage's queue is full;
- ``dispatch_gap_spike``: a device stage's dispatch-gap fraction over the
  last snapshot window exceeds the threshold (the host stopped feeding
  the card);
- ``heartbeat_degraded``: a node's heartbeat is older than the threshold
  (multi-node runs; the port's in-process runners report no nodes);
- ``throughput_declining``: completed batches/s over the trend window fell
  below ``trend_drop_frac`` of its earlier rate.

Every verdict is emitted once at ONSET into four sinks: a span event on the
ambient run span (``tracing.add_span_event``), the
``pipeline_anomalies_total{stage,kind}`` counter, the stage_timer anomaly
aggregate (the run report's ``anomalies`` section), and the snapshot
itself. Pure over snapshots: :meth:`AnomalyDetector.observe` returns the
new onsets.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass

from cosmos_curate_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)


def _env_f(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, "") or default)
    except ValueError:
        return default


@dataclass(frozen=True)
class AnomalyConfig:
    """Detector tuning. Defaults are sized so a few-second snapshot cadence
    flags a wedged batch within ~2 ticks while staying quiet on the bursty
    stage timings real pipelines have (cold compiles, first-batch setup)."""

    # stuck_batch: age > max(min_age, factor * stage p99); p99 falls back to
    # min_age when the stage has no completed batches yet (cold start must
    # not page on the first slow compile)
    stuck_min_age_s: float = 10.0
    stuck_factor: float = 5.0
    # starved_stage: busy_frac <= starved_busy_frac with own queue empty
    # while an earlier stage queues >= starved_queue_depth
    starved_busy_frac: float = 0.05
    starved_queue_depth: int = 8
    # dispatch_gap_spike: delta gap/(gap+compute) over the last window
    gap_frac_threshold: float = 0.75
    gap_min_dispatches: int = 8
    # heartbeat_degraded: node silent for this long (should sit below the
    # failure detector's declare-dead deadline, default 15 s)
    heartbeat_degraded_s: float = 10.0
    # throughput_declining: rate over the newest HALF of the trend window
    # fell below drop_frac * the earlier half's rate
    trend_window: int = 5
    trend_drop_frac: float = 0.3
    trend_min_rate: float = 0.2  # batches/s below which the trend is noise
    # flap suppression: starved_stage / throughput_declining must hold for
    # this many CONSECUTIVE snapshots before onset — batchy pipelines
    # legitimately idle a stage (or complete nothing) for one tick, and
    # pipeline warmup looks exactly like starvation for the first window
    persistence: int = 2

    @classmethod
    def from_env(cls) -> "AnomalyConfig":
        return cls(
            stuck_min_age_s=_env_f("CURATE_ANOMALY_STUCK_MIN_AGE_S", cls.stuck_min_age_s),
            stuck_factor=_env_f("CURATE_ANOMALY_STUCK_FACTOR", cls.stuck_factor),
            starved_busy_frac=_env_f(
                "CURATE_ANOMALY_STARVED_BUSY_FRAC", cls.starved_busy_frac
            ),
            starved_queue_depth=int(
                _env_f("CURATE_ANOMALY_STARVED_QUEUE_DEPTH", cls.starved_queue_depth)
            ),
            gap_frac_threshold=_env_f(
                "CURATE_ANOMALY_GAP_FRAC", cls.gap_frac_threshold
            ),
            heartbeat_degraded_s=_env_f(
                "CURATE_ANOMALY_HEARTBEAT_S", cls.heartbeat_degraded_s
            ),
            trend_drop_frac=_env_f(
                "CURATE_ANOMALY_TREND_DROP_FRAC", cls.trend_drop_frac
            ),
        )


# kinds that must HOLD for `persistence` consecutive snapshots before
# onset (flap suppression); the others carry intrinsic hysteresis in their
# thresholds and should fire on first observation
_PERSIST_KINDS = frozenset({"starved_stage", "throughput_declining"})


class AnomalyDetector:
    """Evaluates successive live-status snapshots; emits onsets once.

    Not thread-safe by itself: one publisher (runner loop) drives it.
    ``emit=False`` turns it into a pure evaluator (unit tests)."""

    def __init__(self, config: AnomalyConfig | None = None, *, emit: bool = True) -> None:
        self.config = config or AnomalyConfig.from_env()
        self.emit = emit
        # (kind, stage, subject) of conditions currently holding: an
        # anomaly re-emits only after its condition clears and recurs
        self._active: set[tuple] = set()
        # key -> consecutive snapshots a _PERSIST_KINDS condition has held
        self._pending: dict[tuple, int] = {}
        self._prev: dict | None = None
        # (ts, total completed batches) ring for the throughput trend
        self._trend: list[tuple[float, float]] = []
        # bounded tail of RECENT onsets (old ones roll off — a long run's
        # late anomalies are exactly what must stay visible) + the
        # monotonic total that snapshot readers key deltas on
        from collections import deque

        self.emitted: "deque[dict]" = deque(maxlen=self._EMITTED_CAP)
        self.emitted_total = 0

    _EMITTED_CAP = 256

    # ------------------------------------------------------------------
    def observe(self, snapshot: dict) -> list[dict]:
        """Evaluate one snapshot against the detector's history. Returns the
        NEW onsets (conditions that were not active last tick) as structured
        events; resolved conditions re-arm silently."""
        ts = snapshot.get("ts")
        now = float(ts) if ts is not None else time.time()  # ts=0.0 is a time
        raw: dict[tuple, dict] = {}  # conditions holding THIS tick
        stages = snapshot.get("stages") or {}
        stage_list = list(stages.items())
        for name, st in stage_list:
            self._check_stuck(now, name, st, raw)
        self._check_starved(stage_list, raw)
        self._check_gap(snapshot, raw)
        self._check_heartbeats(snapshot, raw)
        self._check_trend(now, stage_list, raw)
        self._prev = snapshot
        # flap suppression: persisted kinds only count as present once
        # they held `persistence` consecutive snapshots
        found: dict[tuple, dict] = {}
        for key, ev in raw.items():
            if key[0] in _PERSIST_KINDS:
                held = self._pending.get(key, 0) + 1
                self._pending[key] = held
                if held < max(1, self.config.persistence):
                    continue
            found[key] = ev
        for key in [k for k in self._pending if k not in raw]:
            del self._pending[key]
        onsets = [ev for key, ev in found.items() if key not in self._active]
        self._active = set(found)
        for ev in onsets:
            self._record(ev)
        return onsets

    # ------------------------------------------------------------------
    def _check_stuck(self, now: float, name: str, st: dict, found: dict) -> None:
        cfg = self.config
        p99 = float(st.get("p99_s") or 0.0)
        threshold = max(cfg.stuck_min_age_s, cfg.stuck_factor * p99)
        for b in st.get("inflight") or ():
            age = float(b.get("age_s") or 0.0)
            if age <= threshold:
                continue
            key = ("stuck_batch", name, b.get("batch_id"))
            found[key] = {
                "kind": "stuck_batch",
                "stage": name,
                "batch_id": b.get("batch_id"),
                "age_s": round(age, 3),
                "threshold_s": round(threshold, 3),
                "stage_p99_s": round(p99, 3),
                "worker": b.get("worker"),
                "detail": (
                    f"batch {b.get('batch_id')} in flight {age:.1f}s "
                    f"(> {threshold:.1f}s = max(min_age, "
                    f"{cfg.stuck_factor:g}×p99 {p99:.2f}s))"
                ),
            }

    def _check_starved(self, stage_list: list, found: dict) -> None:
        cfg = self.config
        for i, (name, st) in enumerate(stage_list):
            if i == 0 or not st.get("workers"):
                continue
            if st.get("finished"):
                continue
            if not int(st.get("dispatched") or 0):
                # never had flow: that's pipeline warmup (first upstream
                # batch still cooking), not flow that STOPPED — the stuck/
                # trend checks cover a pipeline wedged from the start
                continue
            if float(st.get("busy_frac") or 0.0) > cfg.starved_busy_frac:
                continue
            if int(st.get("queue_depth") or 0) > 0 or st.get("inflight"):
                continue
            blocked = [
                up
                for up, up_st in stage_list[:i]
                if int(up_st.get("queue_depth") or 0) >= cfg.starved_queue_depth
            ]
            if not blocked:
                continue
            key = ("starved_stage", name, None)
            found[key] = {
                "kind": "starved_stage",
                "stage": name,
                "upstream": blocked[-1],
                "upstream_queue_depth": int(
                    dict(stage_list)[blocked[-1]].get("queue_depth") or 0
                ),
                "detail": (
                    f"stage idle (busy≈0, empty queue) while upstream "
                    f"{blocked[-1]} queues "
                    f"{dict(stage_list)[blocked[-1]].get('queue_depth')} tasks"
                ),
            }

    def _check_gap(self, snapshot: dict, found: dict) -> None:
        """Dispatch-gap spike over the DELTA between snapshots — the
        cumulative gap_frac in the aggregate hides a mid-run stall."""
        cfg = self.config
        cur = snapshot.get("dispatch") or {}
        prev = (self._prev or {}).get("dispatch") or {}
        for name, agg in cur.items():
            p = prev.get(name) or {}
            d_n = int(agg.get("dispatches", 0)) - int(p.get("dispatches", 0))
            if d_n < cfg.gap_min_dispatches:
                continue
            d_gap = float(agg.get("gap_s", 0.0)) - float(p.get("gap_s", 0.0))
            d_busy = d_gap + float(agg.get("compute_s", 0.0)) - float(
                p.get("compute_s", 0.0)
            )
            if d_busy <= 0:
                continue
            frac = d_gap / d_busy
            if frac <= cfg.gap_frac_threshold:
                continue
            key = ("dispatch_gap_spike", name, None)
            found[key] = {
                "kind": "dispatch_gap_spike",
                "stage": name,
                "window_gap_frac": round(frac, 4),
                "window_dispatches": d_n,
                "detail": (
                    f"device idle {frac:.0%} of the last {d_n} dispatches "
                    f"(> {cfg.gap_frac_threshold:.0%}) — host stopped "
                    f"feeding the device"
                ),
            }

    def _check_heartbeats(self, snapshot: dict, found: dict) -> None:
        cfg = self.config
        for node, info in (snapshot.get("nodes") or {}).items():
            age = float(info.get("heartbeat_age_s") or 0.0)
            if age <= cfg.heartbeat_degraded_s:
                continue
            key = ("heartbeat_degraded", node, None)
            found[key] = {
                "kind": "heartbeat_degraded",
                "stage": node,  # node rides the stage label for the counter
                "node": node,
                "heartbeat_age_s": round(age, 3),
                "detail": (
                    f"node {node} silent {age:.1f}s "
                    f"(> {cfg.heartbeat_degraded_s:.1f}s; failure detector "
                    f"declares dead at its own deadline)"
                ),
            }

    def _check_trend(self, now: float, stage_list: list, found: dict) -> None:
        cfg = self.config
        total = sum(float(st.get("completed") or 0) for _, st in stage_list)
        self._trend.append((now, total))
        if len(self._trend) > cfg.trend_window:
            self._trend = self._trend[-cfg.trend_window :]
        if len(self._trend) < cfg.trend_window:
            return
        # half-window rates, not per-tick deltas: batchy pipelines complete
        # nothing for one snapshot all the time — the signal is the NEWER
        # half of the window slowing against the older half
        mid = len(self._trend) // 2
        t0, c0 = self._trend[0]
        tm, cm = self._trend[mid]
        t1, c1 = self._trend[-1]
        early = (cm - c0) / (tm - t0) if tm > t0 else 0.0
        late = (c1 - cm) / (t1 - tm) if t1 > tm else 0.0
        if early < cfg.trend_min_rate:
            return  # run is idling or tiny; a trend over noise is noise
        if late >= cfg.trend_drop_frac * early:
            return
        key = ("throughput_declining", "_run", None)
        found[key] = {
            "kind": "throughput_declining",
            "stage": "_run",
            "rate": round(late, 4),
            "peak_rate": round(early, 4),
            "detail": (
                f"completed-batch rate fell to {late:.2f}/s from "
                f"{early:.2f}/s (< {cfg.trend_drop_frac:.0%} of the earlier "
                f"window)"
            ),
        }

    # ------------------------------------------------------------------
    def _record(self, ev: dict) -> None:
        ev.setdefault("ts", time.time())
        self.emitted.append(ev)  # deque: oldest roll off past the cap
        self.emitted_total += 1
        if not self.emit:
            return
        logger.warning("anomaly %s at %s: %s", ev["kind"], ev["stage"], ev["detail"])
        try:
            from cosmos_curate_tpu_torch.observability.stage_timer import record_anomaly

            record_anomaly(ev)
        except Exception:
            pass
        try:
            from cosmos_curate_tpu_torch.observability.tracing import add_span_event

            add_span_event(
                f"anomaly.{ev['kind']}",
                **{k: v for k, v in ev.items() if k not in ("kind", "ts")},
            )
        except Exception:
            pass
