"""Prometheus series for the runners, the caption stage and the
observability aggregates (port of ``cosmos_curate_tpu/engine/metrics.py``,
the series the in-process runners, ``CaptionStage``,
observability/stage_timer.py and the job service write).

Same names as the reference's (``pipeline_*``, ``caption_*``, ``search_*``,
``index_*`` and ``service_*``), so one dashboard reads both; the streaming
engine adds the deserialize-time and object-store series, and its
cross-node plane the per-node workers and CPUs, node deaths and lineage
reconstruction. The collectors live in a registry of their own
(``EngineMetrics.registry``, which ``ensure_server`` serves): a process
that also holds the JAX package's gauges would otherwise register every
name twice. A no-op when ``prometheus_client`` is absent; it is imported
only when the metrics object is first made.
"""

from __future__ import annotations

import threading

from cosmos_curate_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

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
            from prometheus_client import CollectorRegistry, Counter, Gauge, Histogram
        except ImportError:
            return
        self.registry = CollectorRegistry()
        labels = ["stage"]
        reg = {"registry": self.registry}
        self.process_time_total = Counter(
            "pipeline_stage_process_time_total", "sum of process seconds", labels, **reg
        )
        self.deserialize_time_total = Counter(
            "pipeline_stage_deserialize_time_total", "sum of deserialize seconds", labels, **reg
        )
        self.tasks_total = Counter("pipeline_tasks_processed_total", "tasks out", labels, **reg)
        self.store_bytes = Gauge("pipeline_object_store_bytes", "object store usage", [], **reg)
        self.errors_total = Counter("pipeline_task_errors_total", "batch errors", labels, **reg)
        # stage-overlap headline (core/pipelined_runner.py): fraction of
        # summed stage work hidden behind other stages over the LAST run
        self.overlap_frac = Gauge(
            "pipeline_overlap_frac",
            "fraction of summed stage busy time hidden by stage overlap (last completed run)",
            [],
            **reg,
        )
        # device pipeline (models/device_pipeline.py via
        # stage_timer.record_dispatch): gap = device idle between
        # micro-batches
        self.dispatches_total = Counter(
            "pipeline_device_dispatches_total", "device micro-batch dispatches", labels, **reg
        )
        self.dispatch_gap_total = Counter(
            "pipeline_device_dispatch_gap_seconds_total", "device idle between micro-batches", labels, **reg
        )
        self.dispatch_compute_total = Counter(
            "pipeline_device_compute_seconds_total", "device busy seconds", labels, **reg
        )
        self.dispatch_h2d_total = Counter(
            "pipeline_device_h2d_seconds_total", "host->device transfer seconds", labels, **reg
        )
        self.dispatch_d2h_total = Counter(
            "pipeline_device_d2h_seconds_total", "device->host readback seconds", labels, **reg
        )
        # pipelined-runner flow (stage_timer.record_stage_flow)
        self.stage_busy_frac = Gauge(
            "pipeline_stage_busy_fraction", "worker busy fraction over the last sampling window", labels, **reg
        )
        self.actor_count = Gauge("pipeline_actor_count", "workers per stage", labels + ["state"], **reg)
        self.input_queue_size = Gauge("pipeline_input_queue_size", "queued tasks", labels, **reg)
        # caption-engine phases (stage_timer.record_caption_phases)
        self.caption_phase_total = Counter(
            "caption_phase_seconds_total", "caption engine seconds by phase", labels + ["phase"], **reg
        )
        self.caption_prefix_hits = Counter(
            "caption_prefix_cache_hits_total", "shared-prefix KV cache hits", labels, **reg
        )
        self.caption_prefix_misses = Counter(
            "caption_prefix_cache_misses_total", "shared-prefix KV cache misses (builds)", labels, **reg
        )
        self.caption_prefix_saved = Counter(
            "caption_prefix_tokens_saved_total", "prefill tokens skipped via shared-prefix hits", labels, **reg
        )
        self.caption_kv_blocks_used = Gauge("caption_kv_blocks_used", "KV pool blocks in use", labels, **reg)
        self.caption_kv_blocks_total = Gauge("caption_kv_blocks_total", "KV pool block capacity", labels, **reg)
        self.caption_prefix_block_refs = Counter(
            "caption_prefix_block_refs_total", "shared-prefix blocks referenced copy-free by admitted requests",
            labels, **reg
        )
        self.caption_kv_cow = Counter(
            "caption_kv_cow_copies_total", "copy-on-write duplications of shared prefix tail blocks", labels, **reg
        )
        self.caption_interleaved_steps = Counter(
            "caption_interleaved_steps_total", "decode steps whose active slots spanned 2+ owners", labels, **reg
        )
        self.caption_paged_kernel_steps = Counter(
            "caption_paged_kernel_steps_total", "decode steps served by the paged-attention programs", labels, **reg
        )
        self.caption_kv_gather_bytes_avoided = Counter(
            "caption_kv_gather_bytes_avoided_total",
            "KV working-set bytes not materialized thanks to paged attention", labels, **reg
        )
        # object plane (stage_timer.record_object_plane), per node
        node_labels = ["node"]
        self.object_plane_transfers = Counter(
            "pipeline_object_plane_transfers_total", "cross-node segment transfers", node_labels + ["kind"], **reg
        )
        self.object_plane_bytes = Counter(
            "pipeline_object_plane_bytes_total", "cross-node bytes moved", node_labels + ["kind"], **reg
        )
        self.object_plane_wait = Counter(
            "pipeline_object_plane_wait_seconds_total", "seconds consumers waited on object-plane transfers",
            node_labels + ["kind"], **reg
        )
        self.object_plane_prefetch_hits = Counter(
            "pipeline_object_plane_prefetch_hits_total",
            "batch inputs already local when demanded (push-ahead worked)", node_labels, **reg
        )
        self.object_plane_prefetch_misses = Counter(
            "pipeline_object_plane_prefetch_misses_total", "batch inputs demand-fetched (no prefetch landed first)",
            node_labels, **reg
        )
        # corpus index (stage_timer.record_index_ops)
        self.index_adds = Counter("pipeline_index_adds_total", "vectors added to the corpus index", labels, **reg)
        self.index_add_seconds = Counter(
            "pipeline_index_add_seconds_total", "seconds spent appending/consolidating index fragments", labels, **reg
        )
        self.index_queries = Counter(
            "pipeline_index_queries_total", "index query vectors", labels, **reg
        )
        self.index_query_seconds = Counter(
            "pipeline_index_query_seconds_total", "seconds spent in index query batches", labels, **reg
        )
        self.index_probes = Counter(
            "pipeline_index_probes_total", "cluster shards probed by queries",
            labels, **reg
        )
        self.index_duplicates = Counter(
            "pipeline_index_duplicates_total", "query vectors flagged duplicate of an indexed neighbor", labels, **reg
        )
        self.index_skipped_random = Counter(
            "pipeline_index_skipped_random_total", "vectors refused for random-weight provenance",
            labels, **reg
        )
        # index-server read path (stage_timer.record_search)
        self.search_latency = Histogram(
            "search_latency_seconds", "similarity-search request latency (submit to results)", labels + ["mode"],
            buckets=(0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0), **reg
        )
        self.search_requests = Counter(
            "search_requests_total", "similarity-search requests served", labels + ["mode"], **reg
        )
        self.search_shed = Counter(
            "search_shed_total", "search requests shed with 429 (admission lane over capacity)",
            labels + ["reason"], **reg
        )
        self.index_cache_hit_bytes = Counter(
            "index_cache_hit_bytes_total", "shard bytes served from the warm cache", labels, **reg
        )
        self.index_cache_miss_bytes = Counter(
            "index_cache_miss_bytes_total", "shard bytes faulted in from storage", labels, **reg
        )
        self.index_cache_evicted_bytes = Counter(
            "index_cache_evicted_bytes_total", "shard bytes evicted under the byte budget", labels, **reg
        )
        # anomaly detector verdicts (observability/anomaly.py)
        self.anomalies_total = Counter(
            "pipeline_anomalies_total", "stall/anomaly detector verdicts", labels + ["kind"], **reg
        )
        # per node (the cross-node runner's metrics tick): workers placed on
        # and CPU units used per node, the driver included
        self.node_workers = Gauge("pipeline_node_workers", "stage workers placed per node", node_labels, **reg)
        self.node_cpus_used = Gauge("pipeline_node_cpus_used", "CPU units in use per node", node_labels, **reg)
        # node loss: declared deaths, objects re-materialized through
        # lineage, and the seconds those re-runs took. Healthy churn reads
        # deaths > 0, reconstructed > 0 and no dead-lettered batch
        self.node_deaths = Counter(
            "pipeline_node_deaths_total", "agents declared dead (heartbeat deadline or link loss)", node_labels, **reg
        )
        self.objects_reconstructed = Counter(
            "pipeline_objects_reconstructed_total", "lost objects re-materialized via lineage re-execution", labels,
            **reg
        )
        self.reconstruction_seconds = Counter(
            "pipeline_reconstruction_seconds_total", "wall seconds spent re-executing producer batches", [], **reg
        )
        # per-owner queue gauges of the SHARED caption engine: which stage
        # is occupying or starving the continuous batch
        self.caption_owner_queue = Gauge(
            "caption_owner_queue", "caption engine requests per owner by state", ["owner", "state"], **reg
        )
        self._caption_owner_seen: set[str] = set()
        # the job service (service/app.py): transitions per tenant, current
        # jobs per state, queue depth and wait per lane, sheds, and SLO
        # breaches. shed_total rising under ``tenant_queue_full`` is a noisy
        # tenant at its quota; under ``queue_full`` the whole service is
        # over capacity
        self.service_transitions = Counter(
            "service_jobs_total", "job state transitions", ["tenant", "state"], **reg
        )
        # "service_jobs" itself is taken: prometheus_client registers a
        # Counter's base name (service_jobs_total -> service_jobs)
        self.service_jobs_state = Gauge("service_jobs_current", "current jobs per state", ["state"], **reg)
        self.service_queue_depth = Gauge("service_queue_depth", "queued jobs per lane", ["lane"], **reg)
        self.service_queue_wait = Counter(
            "service_queue_wait_seconds_total", "summed pending->running wait", ["lane"], **reg
        )
        self.service_dispatches = Counter(
            "service_dispatches_total", "jobs dispatched (divide queue_wait by this for mean wait)", ["lane"], **reg
        )
        self.service_shed = Counter("service_shed_total", "admissions shed with 429", ["tenant", "reason"], **reg)
        self.slo_breaches = Counter(
            "service_slo_breaches_total", "per-tenant SLO breaches (queue_wait, run_duration, success_rate)",
            ["tenant", "kind"], **reg
        )
        self._server_port: int | None = None
        self.enabled = True

    def ensure_server(self, port: int) -> None:
        """Serve the registry on ``port`` (once a process; a failure to bind
        is logged, the caller runs on)."""
        if not self.enabled or self._server_port is not None:
            return
        from prometheus_client import start_http_server

        try:
            start_http_server(port, registry=self.registry)
            self._server_port = port
        except OSError as e:
            logger.warning("metrics server on :%d failed to start: %s", port, e)

    def observe_result(self, stage: str, process_s: float, n_out: int, deserialize_s: float = 0.0) -> None:
        if not self.enabled:
            return
        self.process_time_total.labels(stage).inc(process_s)
        if deserialize_s:
            self.deserialize_time_total.labels(stage).inc(deserialize_s)
        self.tasks_total.labels(stage).inc(n_out)

    def set_store_bytes(self, used: int) -> None:
        if self.enabled:
            self.store_bytes.set(used)

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

    def observe_dispatch(self, stage: str, *, gap_s: float, compute_s: float = 0.0, h2d_s: float = 0.0,
                         d2h_s: float = 0.0) -> None:
        if not self.enabled:
            return
        self.dispatches_total.labels(stage).inc()
        self.dispatch_gap_total.labels(stage).inc(max(gap_s, 0.0))
        self.dispatch_compute_total.labels(stage).inc(max(compute_s, 0.0))
        self.dispatch_h2d_total.labels(stage).inc(max(h2d_s, 0.0))
        self.dispatch_d2h_total.labels(stage).inc(max(d2h_s, 0.0))

    def observe_dispatch_aggregate(self, stage: str, agg: dict) -> None:
        """Fold a dumped dispatch AGGREGATE (the stage_timer dump schema)
        into the counters."""
        if not self.enabled:
            return
        self.dispatches_total.labels(stage).inc(max(0, int(agg.get("dispatches", 0))))
        for counter, key in ((self.dispatch_gap_total, "gap_s"), (self.dispatch_compute_total, "compute_s"),
                             (self.dispatch_h2d_total, "h2d_s"), (self.dispatch_d2h_total, "d2h_s")):
            counter.labels(stage).inc(max(0.0, float(agg.get(key, 0.0))))

    def set_stage_busy(self, stage: str, frac: float) -> None:
        if self.enabled:
            self.stage_busy_frac.labels(stage).set(min(max(frac, 0.0), 1.0))

    def set_pool_state(self, stage: str, ready: int, pending: int, queued: int) -> None:
        if not self.enabled:
            return
        self.actor_count.labels(stage, "ready").set(ready)
        self.actor_count.labels(stage, "pending").set(pending)
        self.input_queue_size.labels(stage).set(queued)

    def observe_caption_phases(self, stage: str, phases: dict) -> None:
        """Fold one caption-engine drive's phase and cache deltas (the
        stage_timer.record_caption_phases schema) into the counters."""
        if not self.enabled:
            return
        for phase in ("prep_s", "vision_encode_s", "prefill_s", "decode_s", "idle_s"):
            self.caption_phase_total.labels(stage, phase[:-2]).inc(max(0.0, float(phases.get(phase, 0.0))))
        for counter, key in (
            (self.caption_prefix_hits, "prefix_cache_hits"),
            (self.caption_prefix_misses, "prefix_cache_misses"),
            (self.caption_prefix_saved, "prefix_tokens_saved"),
            (self.caption_prefix_block_refs, "prefix_block_refs"),
            (self.caption_kv_cow, "kv_cow_copies"),
            (self.caption_interleaved_steps, "interleaved_steps"),
            (self.caption_paged_kernel_steps, "paged_kernel_steps"),
            (self.caption_kv_gather_bytes_avoided, "kv_gather_bytes_avoided"),
        ):
            counter.labels(stage).inc(max(0, int(phases.get(key, 0))))
        if "kv_blocks_used" in phases:
            self.caption_kv_blocks_used.labels(stage).set(max(0, int(phases["kv_blocks_used"])))
        if "kv_blocks_total" in phases:
            self.caption_kv_blocks_total.labels(stage).set(max(0, int(phases["kv_blocks_total"])))

    def observe_index(self, stage: str, deltas: dict) -> None:
        """Fold one corpus-index operation's deltas (the
        stage_timer.INDEX_OP_KEYS schema) into the counters."""
        if not self.enabled:
            return
        for counter, key in (
            (self.index_adds, "adds"),
            (self.index_add_seconds, "add_s"),
            (self.index_queries, "queries"),
            (self.index_query_seconds, "query_s"),
            (self.index_probes, "probes"),
            (self.index_duplicates, "duplicates"),
            (self.index_skipped_random, "skipped_random"),
        ):
            counter.labels(stage).inc(max(0.0, float(deltas.get(key, 0))))

    def observe_search(self, name: str, mode: str, latency_s: float | None, deltas: dict) -> None:
        """Fold one search-serving delta set (the stage_timer.SEARCH_KEYS
        schema) into the ``search_*`` / ``index_cache_*`` series."""
        if not self.enabled:
            return
        if latency_s is not None:
            self.search_latency.labels(name, mode).observe(max(0.0, float(latency_s)))
            self.search_requests.labels(name, mode).inc()
        for counter, key in (
            (self.index_cache_hit_bytes, "cache_hit_bytes"),
            (self.index_cache_miss_bytes, "cache_miss_bytes"),
            (self.index_cache_evicted_bytes, "cache_evicted_bytes"),
        ):
            v = float(deltas.get(key, 0))
            if v > 0:
                counter.labels(name).inc(v)

    def observe_anomaly(self, stage: str, kind: str) -> None:
        if self.enabled:
            self.anomalies_total.labels(stage, kind).inc()

    def observe_search_shed(self, name: str, reason: str) -> None:
        if self.enabled:
            self.search_shed.labels(name, reason).inc()

    def observe_service_transition(self, tenant: str, state: str) -> None:
        if self.enabled:
            self.service_transitions.labels(tenant, state).inc()

    def set_service_states(self, counts: dict) -> None:
        """``counts``: state -> current job count (every known state, so a
        state that empties out reads 0 instead of its stale last value)."""
        if not self.enabled:
            return
        for state, n in counts.items():
            self.service_jobs_state.labels(state).set(int(n))

    def set_service_queue_depth(self, lane: str, depth: int) -> None:
        if self.enabled:
            self.service_queue_depth.labels(lane).set(int(depth))

    def observe_service_dispatch(self, lane: str, wait_s: float) -> None:
        if not self.enabled:
            return
        self.service_dispatches.labels(lane).inc()
        self.service_queue_wait.labels(lane).inc(max(0.0, wait_s))

    def observe_service_shed(self, tenant: str, reason: str) -> None:
        if self.enabled:
            self.service_shed.labels(tenant, reason).inc()

    def observe_slo_breach(self, tenant: str, kind: str) -> None:
        if self.enabled:
            self.slo_breaches.labels(tenant, kind).inc()

    def observe_object_plane(self, node: str, deltas: dict) -> None:
        """Fold one object-plane delta set (the
        stage_timer.OBJECT_PLANE_KEYS schema) into the counters under
        ``node``."""
        if not self.enabled:
            return
        for kind, (n_key, b_key, w_key) in {
            "fetch": ("fetches", "fetch_bytes", "fetch_wait_s"),
            "prefetch": ("prefetches", "prefetch_bytes", "prefetch_transfer_s"),
            "store_read": ("store_reads", "store_read_bytes", "store_read_wait_s"),
        }.items():
            self.object_plane_transfers.labels(node, kind).inc(max(0.0, float(deltas.get(n_key, 0))))
            self.object_plane_bytes.labels(node, kind).inc(max(0.0, float(deltas.get(b_key, 0))))
            self.object_plane_wait.labels(node, kind).inc(max(0.0, float(deltas.get(w_key, 0.0))))
        self.object_plane_wait.labels(node, "prefetch_hit").inc(max(0.0, float(deltas.get("prefetch_hit_wait_s", 0.0))))
        self.object_plane_prefetch_hits.labels(node).inc(max(0.0, float(deltas.get("prefetch_hits", 0))))
        self.object_plane_prefetch_misses.labels(node).inc(max(0.0, float(deltas.get("prefetch_misses", 0))))

    def set_node_state(self, node: str, workers: int, cpus_used: float) -> None:
        if self.enabled:
            self.node_workers.labels(node).set(workers)
            self.node_cpus_used.labels(node).set(cpus_used)

    def observe_node_death(self, node: str) -> None:
        if self.enabled:
            self.node_deaths.labels(node).inc()

    def observe_reconstruction(self, stage: str, objects: int, seconds: float) -> None:
        if not self.enabled:
            return
        self.objects_reconstructed.labels(stage).inc(max(0, int(objects)))
        self.reconstruction_seconds.inc(max(0.0, float(seconds)))
