"""Bounded per-process aggregates that the run report and the live status
read (port of ``cosmos_curate_tpu/observability/stage_timer.py``).

``DispatchRecord`` / ``record_dispatch`` carry what the device pipeline
(models/device_pipeline.py) measures per micro-batch: the copy in, the
compute, the copy out, and the *dispatch gap*, the time the device sat idle
between finishing micro-batch k and starting k + 1. The other sections fold
the pipelined runner's stage flow, the caption engine's phases, the corpus
index's and index server's traffic, the anomaly detector's verdicts and the
object plane's transfers. Each is an aggregate, never a log; each forwards
to the port's prometheus series (engine/metrics.py), a no-op without
``prometheus_client``.

``StageTimer`` is the reference's per-task wall / idle statistics of one
stage (``stage_timer.py:30``): ``time_process`` around each call,
``summary`` for count, total, mean, p50, p90, max and idle seconds. Like the
reference, ``run_split``'s ``perf_profile`` option only carries the flag:
nothing reads it.

Host code only: a record is folded from numbers the caller already holds,
the node agents' object-plane deltas (``record_node_object_plane``) among
them.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np


@dataclass
class StageTimer:
    stage_name: str
    samples_s: list[float] = field(default_factory=list)
    idle_s: float = 0.0
    _last_end: float | None = None

    @contextlib.contextmanager
    def time_process(self):
        start = time.monotonic()
        if self._last_end is not None:
            self.idle_s += start - self._last_end
        try:
            yield
        finally:
            end = time.monotonic()
            self.samples_s.append(end - start)
            self._last_end = end

    def summary(self) -> dict:
        arr = np.asarray(self.samples_s)
        if arr.size == 0:
            return {"stage": self.stage_name, "count": 0}
        return {
            "stage": self.stage_name,
            "count": int(arr.size),
            "total_s": float(arr.sum()),
            "mean_s": float(arr.mean()),
            "p50_s": float(np.percentile(arr, 50)),
            "p90_s": float(np.percentile(arr, 90)),
            "max_s": float(arr.max()),
            "idle_s": self.idle_s,
        }


@dataclass(frozen=True)
class DispatchRecord:
    """One device micro-batch dispatch, as observed from the host."""

    # each time is a CUDA-event interval on the GPU (the host clock on the
    # CPU): the side-stream copy in from pinned memory, the compute on the
    # compute stream, the side-stream copy out, and the device idle time
    # between the previous dispatch's compute and this one's
    h2d_s: float
    compute_s: float
    d2h_s: float
    gap_s: float
    rows: int  # valid rows in the micro-batch
    padded_rows: int  # rows actually dispatched (bucket size)


# Aggregates per pipeline name — NOT a record log: a long-lived engine
# worker dispatches millions of micro-batches over a run, so per-record
# retention would grow without bound for data nothing reads (the prometheus
# counters already carry the stream).
_DISPATCH_LOCK = threading.Lock()
_DISPATCH: dict[str, dict] = {}
# Aggregates folded in from OTHER processes' dump files
# (merge_new_dumped_summaries). Kept separate from _DISPATCH so this
# process's own at-exit dump never re-exports them — a later merge over
# the same dump dir would count every worker's stats twice.
_FOLDED: dict[str, dict] = {}

# When set, every process that recorded dispatches writes its aggregate
# summaries to <dir>/dispatch-<pid>.json at exit — how engine WORKERS get
# their stats back to a parent (bench.py) that wants one merged view.
DISPATCH_DUMP_DIR_ENV = "CURATE_DISPATCH_DUMP_DIR"
_DUMP_REGISTERED = False


def _new_agg() -> dict:
    return {
        "dispatches": 0, "rows": 0, "padded_rows": 0,
        "h2d_s": 0.0, "compute_s": 0.0, "d2h_s": 0.0, "gap_s": 0.0,
    }


NODE_ID_ENV = "CURATE_NODE_ID"


def node_id() -> str:
    """Which node THIS process runs on, for per-node attribution in
    dispatch/flow/object-plane summaries. Node agents stamp the env into
    every worker they spawn; the driver and its local workers default to
    ``driver``."""
    return os.environ.get(NODE_ID_ENV) or "driver"


def record_dispatch(name: str, rec: DispatchRecord) -> None:
    """Fold one dispatch into the per-name aggregate and forward the
    gap/compute signal to the engine's prometheus gauges (no-op when the
    exporter is absent)."""
    with _DISPATCH_LOCK:
        agg = _DISPATCH.setdefault(name, _new_agg())
        agg["dispatches"] += 1
        agg["rows"] += rec.rows
        agg["padded_rows"] += rec.padded_rows
        agg["h2d_s"] += rec.h2d_s
        agg["compute_s"] += rec.compute_s
        agg["d2h_s"] += rec.d2h_s
        agg["gap_s"] += rec.gap_s
    _maybe_register_dump()
    try:
        from cosmos_curate_tpu_torch.engine.metrics import get_metrics

        get_metrics().observe_dispatch(
            name, gap_s=rec.gap_s, compute_s=rec.compute_s,
            h2d_s=rec.h2d_s, d2h_s=rec.d2h_s,
        )
    except Exception:  # metrics must never take down a dispatch path
        pass


def _maybe_register_dump() -> None:
    global _DUMP_REGISTERED
    if _DUMP_REGISTERED or not os.environ.get(DISPATCH_DUMP_DIR_ENV):
        return
    import atexit

    # resolve the env var at EXIT time, not registration time: a process
    # spanning several phases (bench's cold/warm passes) must dump where
    # the var points when it dies, not where it pointed at first dispatch
    atexit.register(_dump_summaries, None)
    _DUMP_REGISTERED = True


# Reserved dump key carrying a process's object-plane aggregate alongside
# its dispatch summaries (spawned workers have no exporter and no control
# link of their own — the dump is their only way home for store_read
# telemetry). Never a stage name: stages are class names.
OBJECT_PLANE_DUMP_KEY = "__object_plane__"


def _dump_summaries(path: str | None) -> None:
    try:
        import json

        path = path or os.environ.get(DISPATCH_DUMP_DIR_ENV)
        if not path:
            return
        d = Path(path)
        d.mkdir(parents=True, exist_ok=True)
        # dump this process's OWN dispatches only: aggregates merged in
        # from other processes' dumps (_FOLDED) are already on disk in
        # THEIR files, and re-exporting them would double-count on the
        # next merge over this dir
        with _DISPATCH_LOCK:
            items = {k: dict(v) for k, v in _DISPATCH.items()}
        out = _summarize(items)
        with _OP_LOCK:
            op = {k: _OP.get(k, 0.0) for k in OBJECT_PLANE_KEYS if _OP.get(k)}
        if op:
            out[OBJECT_PLANE_DUMP_KEY] = {**op, "node": node_id()}
        (d / f"dispatch-{os.getpid()}.json").write_text(json.dumps(out))
    except Exception:  # a failed dump must never break process exit
        pass


def _iter_dumps(path: str):
    """Yield ``(file, parsed dict)`` for every readable dispatch-*.json
    dump under ``path`` — the one parser both merge entry points share."""
    import json

    d = Path(path)
    if not d.is_dir():
        return
    for f in sorted(d.glob("dispatch-*.json")):
        try:
            yield f, json.loads(f.read_text())
        except (OSError, ValueError):
            continue


def _fold(into: dict, agg: dict) -> None:
    for k in into:
        if isinstance(into[k], (int, float)):
            into[k] += agg.get(k, 0)
    # per-node attribution survives the merge: one source node passes
    # through; aggregates folded across nodes say so instead of lying
    node = agg.get("node")
    if node:
        into["node"] = node if into.get("node") in (None, node) else "mixed"


def load_dumped_summaries(path: str) -> dict[str, dict]:
    """Merge dispatch summaries dumped by other processes (engine workers)
    under ``path`` into one name -> aggregate view."""
    merged: dict[str, dict] = {}
    for _f, data in _iter_dumps(path):
        for name, agg in data.items():
            if name == OBJECT_PLANE_DUMP_KEY:
                continue  # not a dispatch stage (merge_new_* folds it)
            _fold(merged.setdefault(name, _new_agg()), agg)
    for agg in merged.values():
        busy = agg["gap_s"] + agg["compute_s"]
        agg["gap_frac"] = round(agg["gap_s"] / busy, 4) if busy > 0 else 0.0
    return merged


# dump files already folded into THIS process's aggregates (path strings):
# a driver that runs several engine pipelines against the same dump dir
# must not double-count a worker's aggregate on the second merge
_MERGED_DUMPS: set[str] = set()


def merge_new_dumped_summaries(path: str) -> dict[str, dict]:
    """Fold worker-dumped dispatch aggregates into THIS process's in-memory
    aggregates AND its prometheus counters, each dump file at most once.

    This is how the driver completes its ``pipeline_device_*`` series on
    engine runs: spawned workers cannot serve their own exporter, so their
    at-exit dumps (``CURATE_DISPATCH_DUMP_DIR``) are merged at finalize.
    Returns what was newly merged (name -> aggregate)."""
    merged: dict[str, dict] = {}
    own = f"dispatch-{os.getpid()}.json"  # never re-ingest our own dump
    for f, data in _iter_dumps(path):
        key = str(f)
        if key in _MERGED_DUMPS or f.name == own:
            continue
        _MERGED_DUMPS.add(key)
        for name, agg in data.items():
            if name == OBJECT_PLANE_DUMP_KEY:
                # a spawned worker's store_read (and any other object-plane)
                # telemetry comes home through its dump: fold it under the
                # worker's node id so per-node summaries and the
                # pipeline_object_plane_* counters stay complete
                record_node_object_plane(
                    agg.get("node") or node_id(),
                    {k: v for k, v in agg.items() if k in OBJECT_PLANE_KEYS},
                )
                continue
            _fold(merged.setdefault(name, _new_agg()), agg)
            with _DISPATCH_LOCK:
                _fold(_FOLDED.setdefault(name, _new_agg()), agg)
    if merged:
        try:
            from cosmos_curate_tpu_torch.engine.metrics import get_metrics

            m = get_metrics()
            for name, agg in merged.items():
                m.observe_dispatch_aggregate(name, agg)
        except Exception:  # metrics must never take down finalize
            pass
    return merged


def reset_dispatch_stats() -> None:
    with _DISPATCH_LOCK:
        _DISPATCH.clear()
        _FOLDED.clear()


# ---------------------------------------------------------------------------
# Per-stage flow aggregates from the pipelined runner (core/
# pipelined_runner.py): batch busy time folds in per process_data call,
# queue-depth/busy-fraction snapshots per runner tick. Bounded aggregates,
# not a log — the prometheus gauges carry the stream.
_FLOW_LOCK = threading.Lock()
_FLOW: dict[str, dict] = {}


def _new_flow() -> dict:
    return {
        "batches": 0, "busy_s": 0.0, "ticks": 0,
        "queue_depth": 0, "queue_depth_peak": 0,
        "busy_frac": 0.0, "busy_frac_sum": 0.0, "workers": 0,
    }


def record_stage_busy(name: str, busy_s: float) -> None:
    """Fold one completed ``process_data`` call into the stage's aggregate."""
    with _FLOW_LOCK:
        agg = _FLOW.setdefault(name, _new_flow())
        agg["batches"] += 1
        agg["busy_s"] += busy_s


def record_stage_flow(
    name: str, *, queue_depth: int, busy_frac: float, workers: int
) -> None:
    """Fold one runner-tick snapshot (input-queue depth, worker busy
    fraction over the tick window, live workers) into the aggregate and
    forward it to the engine's gauges (no-op when the exporter is absent)."""
    with _FLOW_LOCK:
        agg = _FLOW.setdefault(name, _new_flow())
        agg["ticks"] += 1
        agg["queue_depth"] = queue_depth
        agg["queue_depth_peak"] = max(agg["queue_depth_peak"], queue_depth)
        agg["busy_frac"] = busy_frac
        agg["busy_frac_sum"] += busy_frac
        agg["workers"] = workers
    try:
        from cosmos_curate_tpu_torch.engine.metrics import get_metrics

        m = get_metrics()
        m.set_stage_busy(name, busy_frac)
        m.set_pool_state(name, workers, 0, queue_depth)
    except Exception:  # metrics must never take down the runner loop
        pass


def stage_flow_summaries() -> dict[str, dict]:
    """name -> busy/queue aggregate. ``busy_frac_mean`` is the average
    worker-busy fraction across ticks: ≈1 means the stage's workers were
    saturated (the bottleneck); ≈0 with a deep queue downstream means the
    stage is starved or over-provisioned."""
    out: dict[str, dict] = {}
    with _FLOW_LOCK:
        items = {k: dict(v) for k, v in _FLOW.items()}
    for name, agg in items.items():
        out[name] = {
            "batches": agg["batches"],
            "busy_s": round(agg["busy_s"], 4),
            "queue_depth": agg["queue_depth"],
            "queue_depth_peak": agg["queue_depth_peak"],
            "busy_frac": round(agg["busy_frac"], 4),
            "busy_frac_mean": (
                round(agg["busy_frac_sum"] / agg["ticks"], 4) if agg["ticks"] else 0.0
            ),
            "workers": agg["workers"],
            "node": node_id(),
        }
    return out


def reset_stage_flow() -> None:
    with _FLOW_LOCK:
        _FLOW.clear()


# ---------------------------------------------------------------------------
# Caption-engine phase aggregates (pipelines/video/stages/captioning.py et
# al.): per-stage prep / vision-encode / prefill / decode / idle seconds per
# engine drive, plus shared-prefix cache traffic. Bounded per-stage
# aggregates; the caption benchmark and flight recorder read them to
# attribute the caption critical path.
_CAPTION_LOCK = threading.Lock()
_CAPTION: dict[str, dict] = {}

_CAPTION_PHASE_KEYS = (
    "prep_s", "vision_encode_s", "prefill_s", "decode_s", "idle_s", "wall_s",
)
_CAPTION_COUNT_KEYS = (
    "requests", "prefill_tokens", "prefix_cache_hits", "prefix_cache_misses",
    "prefix_tokens_saved", "vision_encodes", "vision_reuses",
    # paged-KV + cross-job deltas (models/vlm/engine.py): shared prefix
    # BLOCK references served copy-free, copy-on-write tail duplications,
    # and decode steps whose active slots spanned 2+ owners
    "prefix_block_refs", "kv_cow_copies", "interleaved_steps",
    # paged-attention deltas (ops/paged_attention.py): decode steps served
    # without a gathered working set + the view bytes never materialized
    "paged_kernel_steps", "kv_gather_bytes_avoided",
    "decode_tokens",
)
# absolute occupancy gauges riding each drive record: totals overwrite,
# peaks take the max across drives
_CAPTION_GAUGE_KEYS = ("kv_blocks_total", "kv_blocks_used")
_CAPTION_PEAK_KEYS = ("kv_blocks_peak",)


def _new_caption() -> dict:
    agg = {k: 0.0 for k in _CAPTION_PHASE_KEYS}
    agg.update({k: 0 for k in _CAPTION_COUNT_KEYS})
    agg.update({k: 0 for k in _CAPTION_GAUGE_KEYS + _CAPTION_PEAK_KEYS})
    agg["drives"] = 0
    agg["owners"] = {}
    return agg


def record_caption_phases(name: str, phases: dict) -> None:
    """Fold one engine drive's phase/cache deltas into the stage's
    aggregate and forward them to the engine's metrics exporter (no-op when
    absent). ``idle_s`` is wall minus device phases (prefill + decode):
    the engine-stall signal the prep/decode overlap exists to shrink. A
    drive carrying an ``owner`` tag also folds into the per-owner
    sub-aggregate — the run report's cross-job accounting."""
    with _CAPTION_LOCK:
        agg = _CAPTION.setdefault(name, _new_caption())
        agg["drives"] += 1
        for k in _CAPTION_PHASE_KEYS:
            agg[k] += float(phases.get(k, 0.0))
        for k in _CAPTION_COUNT_KEYS:
            agg[k] += int(phases.get(k, 0))
        for k in _CAPTION_GAUGE_KEYS:
            if k in phases:
                agg[k] = int(phases[k])
        for k in _CAPTION_PEAK_KEYS:
            if k in phases:
                agg[k] = max(agg[k], int(phases[k]))
        owner = phases.get("owner")
        if owner:
            sub = agg["owners"].setdefault(
                str(owner), {"drives": 0, "requests": 0, "decode_tokens": 0}
            )
            sub["drives"] += 1
            sub["requests"] += int(phases.get("requests", 0))
            sub["decode_tokens"] += int(phases.get("decode_tokens", 0))
    try:
        from cosmos_curate_tpu_torch.engine.metrics import get_metrics

        get_metrics().observe_caption_phases(name, phases)
    except Exception:  # metrics must never take down the caption path
        pass


def caption_phase_summaries() -> dict[str, dict]:
    """name -> caption phase aggregate. ``idle_frac`` is engine idle over
    wall for the stage's drives: ≈0 means the engine was prefilling or
    decoding for the whole window (prep fully hidden); large values mean
    the stage starved the engine between batches. ``owners`` carries the
    per-owner sub-aggregates (cross-job accounting)."""
    out: dict[str, dict] = {}
    with _CAPTION_LOCK:
        items = {
            k: {**v, "owners": {o: dict(s) for o, s in v["owners"].items()}}
            for k, v in _CAPTION.items()
        }
    for name, agg in items.items():
        wall = agg["wall_s"]
        out[name] = {
            **{k: round(agg[k], 4) for k in _CAPTION_PHASE_KEYS},
            **{k: agg[k] for k in _CAPTION_COUNT_KEYS},
            **{k: agg[k] for k in _CAPTION_GAUGE_KEYS + _CAPTION_PEAK_KEYS},
            "drives": agg["drives"],
            "owners": agg["owners"],
            "idle_frac": round(agg["idle_s"] / wall, 4) if wall > 0 else 0.0,
        }
    return out


def reset_caption_phases() -> None:
    with _CAPTION_LOCK:
        _CAPTION.clear()


# ---------------------------------------------------------------------------
# Corpus-index aggregates (dedup/corpus_index.py + the writer's in-pipeline
# fragment appends): vectors added, query batches, probe fan-out, and the
# wall time each side cost. Bounded per-name aggregates like the rest of
# this module; the ``pipeline_index_*`` prometheus counters carry the
# stream and the flight recorder snapshots the summary into run_report.
_INDEX_LOCK = threading.Lock()
_INDEX: dict[str, dict] = {}

INDEX_OP_KEYS = (
    "adds", "add_s", "queries", "query_s", "probes", "duplicates",
    "skipped_random",
)


def _new_index_agg() -> dict:
    return {k: 0.0 for k in INDEX_OP_KEYS}


def record_index_ops(name: str, **deltas: float) -> None:
    """Fold corpus-index operation deltas (any subset of INDEX_OP_KEYS)
    into ``name``'s aggregate and forward them to the engine's
    ``pipeline_index_*`` counters (no-op without an exporter)."""
    with _INDEX_LOCK:
        agg = _INDEX.setdefault(name, _new_index_agg())
        for k, v in deltas.items():
            if k in INDEX_OP_KEYS:
                agg[k] += float(v)
    try:
        from cosmos_curate_tpu_torch.engine.metrics import get_metrics

        get_metrics().observe_index(name, deltas)
    except Exception:  # metrics must never take down an index operation
        pass


def index_op_summaries() -> dict[str, dict]:
    """name -> index aggregate. ``probe_fanout_mean`` is non-empty probed
    shards per query vector (≈ the effective nprobe) — the knob-vs-recall
    signal (raise nprobe, pay more shard matmuls); ``queries_per_sec`` is
    the headline the bench row carries."""
    out: dict[str, dict] = {}
    with _INDEX_LOCK:
        items = {k: dict(v) for k, v in _INDEX.items()}
    for name, agg in items.items():
        out[name] = {
            "adds": int(agg["adds"]),
            "add_s": round(agg["add_s"], 4),
            "queries": int(agg["queries"]),
            "query_s": round(agg["query_s"], 4),
            "probes": int(agg["probes"]),
            "duplicates": int(agg["duplicates"]),
            "skipped_random": int(agg["skipped_random"]),
            "probe_fanout_mean": (
                round(agg["probes"] / agg["queries"], 4) if agg["queries"] else 0.0
            ),
            "queries_per_sec": (
                round(agg["queries"] / agg["query_s"], 2) if agg["query_s"] > 0 else 0.0
            ),
            "node": node_id(),
        }
    return out


def reset_index_ops() -> None:
    with _INDEX_LOCK:
        _INDEX.clear()


# ---------------------------------------------------------------------------
# Search-serving aggregates (dedup/index_server.py + service /v1/search):
# request counts, latency percentiles (bounded reservoir), warm-shard-cache
# byte traffic, and compaction generations. The SLO surface of the
# index-server read path: p50/p99 land in run_report.json and BENCH rows;
# the ``search_latency_seconds`` prometheus histogram carries the stream.
_SEARCH_LOCK = threading.Lock()
_SEARCH: dict[str, dict] = {}
_SEARCH_LATENCY_CAP = 4096

SEARCH_KEYS = (
    "searches", "queries", "search_s", "batches", "batched_requests",
    "cache_hit_bytes", "cache_miss_bytes", "cache_evicted_bytes",
    "compactions", "compaction_s", "generations_adopted", "shed",
)


def _new_search_agg() -> dict:
    return {**{k: 0.0 for k in SEARCH_KEYS}, "generation": 0, "latencies": []}


def record_search(
    name: str, *, latency_s: float | None = None, mode: str = "clip",
    generation: int | None = None, **deltas: float,
) -> None:
    """Fold search-serving deltas (any subset of SEARCH_KEYS) into
    ``name``'s aggregate; ``latency_s`` lands in a bounded reservoir
    (random replacement once full, so percentiles stay an unbiased sample
    of the whole run, not the first N requests). Forwards to the
    ``search_*`` prometheus series (no-op without an exporter)."""
    with _SEARCH_LOCK:
        agg = _SEARCH.setdefault(name, _new_search_agg())
        for k, v in deltas.items():
            if k in SEARCH_KEYS:
                agg[k] += float(v)
        if generation is not None:
            agg["generation"] = max(agg["generation"], int(generation))
        if latency_s is not None:
            res = agg["latencies"]
            if len(res) < _SEARCH_LATENCY_CAP:
                res.append(float(latency_s))
            else:
                import random

                res[random.randrange(_SEARCH_LATENCY_CAP)] = float(latency_s)
    try:
        from cosmos_curate_tpu_torch.engine.metrics import get_metrics

        get_metrics().observe_search(name, mode, latency_s, deltas)
    except Exception:  # metrics must never take down the read path
        pass


def search_summaries() -> dict[str, dict]:
    """name -> search aggregate with the SLO headline: ``latency_p50_ms``
    / ``latency_p99_ms`` over the reservoir, ``qps`` (requests over summed
    serving-loop BUSY seconds — ``search_s`` is recorded per micro-batch,
    so many concurrent requests amortize one batch's wall and qps exceeds
    1/latency), and ``cache_hit_ratio`` by bytes (hot path served from
    resident shards)."""
    out: dict[str, dict] = {}
    with _SEARCH_LOCK:
        items = {
            k: {**v, "latencies": list(v["latencies"])} for k, v in _SEARCH.items()
        }
    for name, agg in items.items():
        lat = agg.pop("latencies")
        hit = agg["cache_hit_bytes"]
        touched = hit + agg["cache_miss_bytes"]
        out[name] = {
            **{k: (round(agg[k], 4) if k.endswith("_s") else int(agg[k])) for k in SEARCH_KEYS},
            "generation": int(agg["generation"]),
            "latency_p50_ms": round(float(np.percentile(lat, 50)) * 1e3, 3) if lat else 0.0,
            "latency_p99_ms": round(float(np.percentile(lat, 99)) * 1e3, 3) if lat else 0.0,
            "qps": round(agg["searches"] / agg["search_s"], 2) if agg["search_s"] > 0 else 0.0,
            "cache_hit_ratio": round(hit / touched, 4) if touched > 0 else 0.0,
            "node": node_id(),
        }
    return out


def reset_search() -> None:
    with _SEARCH_LOCK:
        _SEARCH.clear()


# ---------------------------------------------------------------------------
# Anomaly aggregates (observability/anomaly.py): the stall/anomaly
# detector's verdicts, folded per (stage, kind) with a bounded tail of
# recent structured events. Same contract as the rest of this module —
# bounded aggregates, never a log; the ``pipeline_anomalies_total``
# counters carry the stream and the flight recorder snapshots the summary
# into run_report.json's ``anomalies`` section.
_ANOMALY_LOCK = threading.Lock()
_ANOMALY_COUNTS: dict[tuple[str, str], int] = {}
_ANOMALY_RECENT: "deque" = None  # created lazily (collections import below)
_ANOMALY_RECENT_CAP = 64


def record_anomaly(event: dict) -> None:
    """Fold one detector verdict (``{"kind", "stage", ...}``) into the
    per-(stage, kind) counts + the bounded recent-events tail, and forward
    it to the ``pipeline_anomalies_total`` counter (no-op without an
    exporter)."""
    global _ANOMALY_RECENT
    kind = str(event.get("kind") or "unknown")
    stage = str(event.get("stage") or "_run")
    with _ANOMALY_LOCK:
        if _ANOMALY_RECENT is None:
            from collections import deque as _deque

            _ANOMALY_RECENT = _deque(maxlen=_ANOMALY_RECENT_CAP)
        _ANOMALY_COUNTS[(stage, kind)] = _ANOMALY_COUNTS.get((stage, kind), 0) + 1
        _ANOMALY_RECENT.append(dict(event))
    try:
        from cosmos_curate_tpu_torch.engine.metrics import get_metrics

        get_metrics().observe_anomaly(stage, kind)
    except Exception:  # metrics must never take down the watchdog
        pass


def anomaly_summaries() -> dict:
    """``{"total", "counts": {"<stage>/<kind>": n}, "recent": [...]}`` —
    what the flight recorder writes as run_report.json's ``anomalies``
    section and live snapshots embed as detector verdicts."""
    with _ANOMALY_LOCK:
        counts = {f"{s}/{k}": n for (s, k), n in _ANOMALY_COUNTS.items()}
        recent = list(_ANOMALY_RECENT or ())
    if not counts:
        return {}
    return {"total": sum(counts.values()), "counts": counts, "recent": recent}


def reset_anomalies() -> None:
    with _ANOMALY_LOCK:
        _ANOMALY_COUNTS.clear()
        if _ANOMALY_RECENT is not None:
            _ANOMALY_RECENT.clear()


# ---------------------------------------------------------------------------
# Object-plane transfer aggregates (engine/object_channel.py consumers): how
# many bytes crossed hosts, how long consumers WAITED for them, and whether
# push-ahead prefetch hid the transfer behind compute. Bounded per-process
# aggregates; node agents relay theirs to the driver over the control link
# (remote_plane.AgentStats), which folds them per node here.
_OP_LOCK = threading.Lock()
_OP: dict[str, float] = {}
# driver-side fold of AgentStats deltas: node_id -> aggregate
_OP_NODES: dict[str, dict] = {}

OBJECT_PLANE_KEYS = (
    # demand fetches: the consumer BLOCKED on the transfer (wait == transfer)
    "fetches", "fetch_bytes", "fetch_wait_s",
    # push-ahead transfers: moved in the background while compute ran
    "prefetches", "prefetch_bytes", "prefetch_transfer_s",
    # consumer-side cache outcomes: a hit's wait is ~0 (the bytes were
    # already local); prefetch working == hits > 0 and
    # prefetch_hit_wait_s << prefetch_transfer_s
    "prefetch_hits", "prefetch_hit_wait_s", "prefetch_misses",
    # local store reads on the worker fetch pool (shm, not network)
    "store_reads", "store_read_bytes", "store_read_wait_s",
)


def _new_op() -> dict:
    return {k: 0.0 for k in OBJECT_PLANE_KEYS}


def record_object_plane(**deltas: float) -> None:
    """Fold object-plane deltas (any subset of OBJECT_PLANE_KEYS) into this
    process's aggregate and forward them to the prometheus counters under
    this process's node id (no-op without an exporter)."""
    with _OP_LOCK:
        for k, v in deltas.items():
            if k in OBJECT_PLANE_KEYS:
                _OP[k] = _OP.get(k, 0.0) + float(v)
    # a CPU worker may record store_reads without ever dispatching to a
    # device — it still owes the parent a dump at exit
    _maybe_register_dump()
    _forward_object_plane(node_id(), deltas)


def record_node_object_plane(node: str, deltas: dict) -> None:
    """Driver-side fold of one agent's relayed object-plane DELTAS."""
    with _OP_LOCK:
        agg = _OP_NODES.setdefault(node, _new_op())
        for k in OBJECT_PLANE_KEYS:
            agg[k] += float(deltas.get(k, 0.0))
    _forward_object_plane(node, deltas)


def _forward_object_plane(node: str, deltas: dict) -> None:
    try:
        from cosmos_curate_tpu_torch.engine.metrics import get_metrics

        get_metrics().observe_object_plane(node, deltas)
    except Exception:  # metrics must never take down a transfer path
        pass


def object_plane_summaries() -> dict[str, dict]:
    """node_id -> object-plane aggregate: this process's own traffic under
    its node id, plus every agent's relayed aggregate. Integer-valued
    counters render as ints for readability."""
    out: dict[str, dict] = {}
    with _OP_LOCK:
        own = dict(_OP)
        nodes = {n: dict(a) for n, a in _OP_NODES.items()}
    if any(own.get(k) for k in OBJECT_PLANE_KEYS):
        nodes.setdefault(node_id(), _new_op())
        for k in OBJECT_PLANE_KEYS:
            nodes[node_id()][k] += own.get(k, 0.0)
    for node, agg in nodes.items():
        out[node] = {
            k: round(agg[k], 4) if k.endswith("_s") else int(agg[k])
            for k in OBJECT_PLANE_KEYS
        }
    return out


def object_plane_snapshot_delta(prev: dict | None) -> tuple[dict, dict]:
    """(current totals, delta since ``prev``) of this process's own
    aggregate: what a node agent ships in each AgentStats frame (deltas, so
    the driver's fold stays right across reconnects)."""
    with _OP_LOCK:
        cur = {k: _OP.get(k, 0.0) for k in OBJECT_PLANE_KEYS}
    prev = prev or {}
    delta = {k: cur[k] - float(prev.get(k, 0.0)) for k in OBJECT_PLANE_KEYS}
    return cur, {k: v for k, v in delta.items() if v}


def reset_object_plane() -> None:
    with _OP_LOCK:
        _OP.clear()
        _OP_NODES.clear()


def dispatch_summaries() -> dict[str, dict]:
    """name -> aggregate per-dispatch timings, including aggregates merged
    in from worker dump files. ``gap_frac`` is device idle over total
    device-relevant wall (gap + compute): < 0.2 means the host kept the
    device fed for >80% of the stage's device window."""
    with _DISPATCH_LOCK:
        items = {k: dict(v) for k, v in _DISPATCH.items()}
        for name, agg in _FOLDED.items():
            _fold(items.setdefault(name, _new_agg()), agg)
    return _summarize(items)


def _summarize(items: dict[str, dict]) -> dict[str, dict]:
    out: dict[str, dict] = {}
    for name, agg in items.items():
        busy = agg["gap_s"] + agg["compute_s"]
        out[name] = {
            "dispatches": agg["dispatches"],
            "rows": agg["rows"],
            "padded_rows": agg["padded_rows"],
            "h2d_s": round(agg["h2d_s"], 4),
            "compute_s": round(agg["compute_s"], 4),
            "d2h_s": round(agg["d2h_s"], 4),
            "gap_s": round(agg["gap_s"], 4),
            "gap_frac": round(agg["gap_s"] / busy, 4) if busy > 0 else 0.0,
            # merged multi-node reports attribute dispatch gaps per node,
            # not just per stage — dumps from an agent's workers carry the
            # agent's node id (NODE_ID_ENV rides StartWorker env)
            "node": agg.get("node") or node_id(),
        }
    return out
