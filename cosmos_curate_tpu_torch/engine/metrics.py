"""Prometheus gauges for the runners and the caption stage (port of
``cosmos_curate_tpu/engine/metrics.py``, the series the pipelined runner
and ``CaptionStage`` write).

Same names as the reference's (``pipeline_*`` and ``caption_*``), so one
dashboard reads both; the reference's deserialize-time series is left out,
because the in-process runners deserialize nothing. The collectors live in
a registry of their own (``EngineMetrics.registry``, which a caller serves
with ``prometheus_client.start_http_server(port, registry=...)``): a
process that also holds the JAX package's gauges would otherwise register
every name twice. A no-op when ``prometheus_client`` is absent; it is
imported only when the metrics object is first made.
"""

from __future__ import annotations

import threading

_SINGLETON: EngineMetrics | None = None
_SINGLETON_LOCK = threading.Lock()


def get_metrics() -> EngineMetrics:
    """Process-wide singleton."""
    global _SINGLETON
    with _SINGLETON_LOCK:
        if _SINGLETON is None:
            _SINGLETON = EngineMetrics()
        return _SINGLETON


class EngineMetrics:
    def __init__(self) -> None:
        self.enabled = False
        try:
            from prometheus_client import CollectorRegistry, Counter, Gauge
        except ImportError:
            return
        self.registry = CollectorRegistry()
        labels = ["stage"]
        reg = {"registry": self.registry}
        self.process_time_total = Counter(
            "pipeline_stage_process_time_total", "sum of process seconds", labels, **reg
        )
        self.tasks_total = Counter("pipeline_tasks_processed_total", "tasks out", labels, **reg)
        self.errors_total = Counter("pipeline_task_errors_total", "batch errors", labels, **reg)
        # stage-overlap headline (core/pipelined_runner.py): fraction of
        # summed stage work hidden behind other stages over the LAST run
        self.overlap_frac = Gauge(
            "pipeline_overlap_frac",
            "fraction of summed stage busy time hidden by stage overlap (last completed run)",
            [],
            **reg,
        )
        # per-owner queue gauges of the SHARED caption engine: which stage
        # is occupying or starving the continuous batch
        self.caption_owner_queue = Gauge(
            "caption_owner_queue", "caption engine requests per owner by state", ["owner", "state"], **reg
        )
        self._caption_owner_seen: set[str] = set()
        self.enabled = True

    def observe_result(self, stage: str, process_s: float, n_out: int) -> None:
        if not self.enabled:
            return
        self.process_time_total.labels(stage).inc(process_s)
        self.tasks_total.labels(stage).inc(n_out)

    def observe_error(self, stage: str) -> None:
        if self.enabled:
            self.errors_total.labels(stage).inc()

    def set_overlap_frac(self, frac: float) -> None:
        if self.enabled:
            self.overlap_frac.set(min(max(frac, 0.0), 1.0))

    def observe_caption_owners(self, owners: dict) -> None:
        """Set the per-owner queue gauges from ``CaptionEngine.owner_stats``.
        Owners absent from the snapshot have their gauge children removed,
        so finished stages leave no stale series behind."""
        if not self.enabled:
            return
        seen = self._caption_owner_seen
        for owner, stats in owners.items():
            seen.add(str(owner))
            for state in ("waiting", "ready", "inflight"):
                self.caption_owner_queue.labels(owner, state).set(max(0, int(stats.get(state, 0))))
        for owner in [o for o in seen if o not in owners]:
            seen.discard(owner)
            for state in ("waiting", "ready", "inflight"):
                try:
                    self.caption_owner_queue.remove(owner, state)
                except KeyError:
                    pass
