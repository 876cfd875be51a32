"""Run flight recorder: one end-of-run artifact that answers "where did
the time go" (port of ``cosmos_curate_tpu/observability/flight_recorder.py``,
its single-node part).

At the end of a traced run it merges into ``<output>/report/run_report.json``:

- **the span tree**: every NDJSON span under ``<output>/profile`` (the
  driver's ``traces/driver.ndjson`` and its rotation parts, plus files the
  artifact collector delivered), the set of trace ids (ONE id means the
  propagation held end to end: ``connected``), and the **critical path**,
  from the root span down the longest child at every level;
- **per-stage time**: the runner's busy-seconds accounting when a runner
  is handed in, else the summed ``stage.*.process`` spans;
- **the stage_timer aggregates** verbatim: device dispatch, stage flow,
  caption phases, index operations, search, object plane and anomalies;
- **drop accounting**: dead-lettered batch counts and the DLQ run dir.

The report has the reference's sections and schema version. Not ported
yet: the per-node sidecars and their merge (ROADMAP queue A item 15) and
the ``report`` command that renders it (item 22).
"""

from __future__ import annotations

import json
import time
from typing import Any

from cosmos_curate_tpu_torch.storage.client import get_storage_client, write_bytes
from cosmos_curate_tpu_torch.utils import schema_stamp
from cosmos_curate_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

REPORT_REL = "report/run_report.json"


def report_path(output_path: str) -> str:
    return f"{output_path.rstrip('/')}/{REPORT_REL}"


# -- span collection ---------------------------------------------------------


def clear_trace_artifacts(output_path: str) -> int:
    """Delete the span files (``*.ndjson``) and node-stats sidecars
    (``report/node-stats-*.json``) a PRIOR run left under the output root. A
    traced re-run into the same root overwrites only the base driver file:
    stale rotation parts and collected files would keep the old run's trace
    ids and hand the new run a false DISCONNECTED verdict (and a critical
    path rooted in dead spans). Returns the number of files removed."""
    removed = 0
    for sub, keep in (("profile", lambda name: name.endswith(".ndjson")),
                      ("report", lambda name: name.startswith("node-stats-") and name.endswith(".json"))):
        root = f"{output_path.rstrip('/')}/{sub}"
        client = get_storage_client(root)
        for info in list(client.list_files(root)):
            if not keep(info.path.rsplit("/", 1)[-1]):
                continue
            try:
                client.delete(info.path)
                removed += 1
            except OSError:
                logger.warning("could not remove stale trace artifact %s", info.path)
    if removed:
        logger.info("flight recorder: cleared %d stale trace artifact(s)", removed)
    return removed


def collect_spans(output_path: str) -> list[dict]:
    """Every span record under ``<output>/profile`` (driver NDJSON + worker
    NDJSONs delivered by the artifact collector). Unreadable files/lines are
    skipped — a torn trace must not void the report."""
    root = f"{output_path.rstrip('/')}/profile"
    client = get_storage_client(root)
    spans: list[dict] = []
    try:
        files = list(client.list_files(root, suffixes=(".ndjson",)))
    except Exception:
        return spans
    for info in files:
        try:
            text = client.read_bytes(info.path).decode("utf-8", "replace")
        except Exception:
            logger.warning("flight recorder: unreadable span file %s", info.path)
            continue
        for line in text.splitlines():
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except ValueError:
                continue
            if isinstance(rec, dict) and "span_id" in rec and "name" in rec:
                spans.append(rec)
    return spans


def _critical_path(spans: list[dict]) -> list[dict]:
    """Root -> leaf chain following the longest child at every level.

    Root = the longest span whose parent is absent from the collected set
    (cross-process parents ARE in the set when propagation worked; a
    disconnected fragment shows up as extra roots and extra trace ids)."""
    if not spans:
        return []
    by_id = {s["span_id"]: s for s in spans}
    children: dict[str, list[dict]] = {}
    roots: list[dict] = []
    for s in spans:
        parent = s.get("parent_id")
        if parent and parent in by_id:
            children.setdefault(parent, []).append(s)
        else:
            roots.append(s)

    def dur(s: dict) -> float:
        return float(s.get("duration_s") or 0.0)

    path = []
    node = max(roots, key=dur)
    seen = set()
    while node is not None and node["span_id"] not in seen:
        seen.add(node["span_id"])
        path.append(
            {
                "name": node["name"],
                "duration_s": round(dur(node), 4),
                "span_id": node["span_id"],
                "pid": node.get("pid"),
            }
        )
        kids = children.get(node["span_id"])
        node = max(kids, key=dur) if kids else None
    return path


def _by_name(spans: list[dict]) -> dict[str, dict]:
    out: dict[str, dict] = {}
    for s in spans:
        agg = out.setdefault(s["name"], {"count": 0, "total_s": 0.0, "max_s": 0.0})
        d = float(s.get("duration_s") or 0.0)
        agg["count"] += 1
        agg["total_s"] = round(agg["total_s"] + d, 4)
        agg["max_s"] = round(max(agg["max_s"], d), 4)
    return out


def _stage_times_from_spans(spans: list[dict]) -> dict[str, float]:
    """Summed ``stage.<name>.process`` span seconds — the fallback when no
    runner with busy-seconds accounting is available."""
    out: dict[str, float] = {}
    for s in spans:
        name = s["name"]
        if name.startswith("stage.") and name.endswith(".process"):
            stage = name[len("stage."):-len(".process")]
            out[stage] = round(out.get(stage, 0.0) + float(s.get("duration_s") or 0.0), 4)
    return out


# -- report ------------------------------------------------------------------


def runner_stats(runner: Any) -> dict:
    """The report sections only the process that RAN the pipeline can
    source: runner accounting plus this process's in-memory dispatch/flow
    aggregates. ``runner=None`` yields the aggregate-only skeleton."""
    from cosmos_curate_tpu_torch.observability.stage_timer import (
        anomaly_summaries,
        caption_phase_summaries,
        dispatch_summaries,
        index_op_summaries,
        search_summaries,
        object_plane_summaries,
        stage_flow_summaries,
    )

    stats: dict[str, Any] = {
        "dispatch": dispatch_summaries(),
        "stage_flow": stage_flow_summaries(),
        "caption_phases": caption_phase_summaries(),
        # corpus-index traffic (adds/queries/probe fan-out per recorder
        # name) — the pipeline_index_* counters' end-of-run snapshot
        "index_ops": index_op_summaries(),
        # index-server read path: request counts, latency p50/p99, warm
        # shard-cache byte traffic, compaction generations
        "search": search_summaries(),
        # object-plane transfers per node (the port's run_dedup store reads)
        "object_plane": object_plane_summaries(),
        # stall/anomaly detector verdicts (observability/anomaly.py):
        # per-(stage, kind) counts + the bounded recent-events tail
        "anomalies": anomaly_summaries(),
        "stage_times": dict(getattr(runner, "stage_times", None) or {}),
    }
    wall = getattr(runner, "pipeline_wall_s", 0.0)
    if wall:
        stats["wall_s"] = round(float(wall), 4)
    overlap = getattr(runner, "overlap_frac", None)
    if overlap is not None:
        stats["pipeline_overlap_frac"] = round(float(overlap), 4)
    counts = getattr(runner, "stage_counts", None)
    if counts:
        stats["stage_counts"] = counts
    dlq = getattr(runner, "dlq", None)
    dead = getattr(runner, "dead_lettered", 0) or getattr(dlq, "recorded", 0)
    stats["dead_lettered"] = int(dead or 0)
    if dlq is not None and getattr(dlq, "recorded", 0):
        stats["dlq_run_dir"] = str(dlq.run_dir)
    return stats


def build_run_report(output_path: str, *, runner: Any = None, extra: dict | None = None) -> dict:
    """Assemble the report dict (no write). ``runner`` contributes
    stage_times / stage_counts / DLQ / overlap when given; span-derived
    numbers fill the gaps, so the report works for any runner (or none)."""
    spans = collect_spans(output_path)
    trace_ids = sorted({s.get("trace_id", "") for s in spans if s.get("trace_id")})
    pids = sorted({s.get("pid") for s in spans if s.get("pid") is not None})
    # "version" is the legacy alias of the schema stamp (pre-stamp readers
    # grep for it); both come from the one published number in
    # utils/schema_stamp.SCHEMA_VERSIONS — never hand-write either.
    report: dict[str, Any] = schema_stamp.stamp({}, "run-report")
    report["version"] = schema_stamp.SCHEMA_VERSIONS["run-report"]
    report.update({
        "generated_at": time.time(),
        "output_path": output_path,
        "span_count": len(spans),
        "trace_ids": trace_ids,
        # ONE trace id across every process = the propagation held;
        # vacuously false with no spans (tracing was off)
        "connected": len(trace_ids) == 1,
        "processes": len(pids),
        "critical_path": _critical_path(spans),
        "spans_by_name": _by_name(spans),
    })
    stats = runner_stats(runner)
    report["dispatch"] = stats["dispatch"]
    report["stage_flow"] = stats["stage_flow"]
    report["caption_phases"] = stats["caption_phases"]
    report["index_ops"] = stats["index_ops"]
    report["search"] = stats.get("search") or {}
    report["object_plane"] = stats["object_plane"]
    report["anomalies"] = stats.get("anomalies") or {}
    # precedence: live runner accounting (it includes setup time that spans
    # do not book to the stage) > span-derived
    report["stage_times"] = stats["stage_times"] or _stage_times_from_spans(spans)
    wall = stats.get("wall_s") or 0.0
    if not wall and report["critical_path"]:
        wall = report["critical_path"][0]["duration_s"]
    report["wall_s"] = round(float(wall or 0.0), 4)
    if "pipeline_overlap_frac" in stats:
        report["pipeline_overlap_frac"] = stats["pipeline_overlap_frac"]
    if stats.get("stage_counts"):
        report["stage_counts"] = stats["stage_counts"]
    report["dead_lettered"] = stats["dead_lettered"]
    if "dlq_run_dir" in stats:
        report["dlq_run_dir"] = stats["dlq_run_dir"]
    if extra:
        report.update(extra)
    return report


def write_run_report(output_path: str, *, runner: Any = None, extra: dict | None = None) -> dict:
    """Build the report and write it to ``<output>/report/run_report.json``
    through the storage layer. Returns the report with ``report_path``
    set."""
    from cosmos_curate_tpu_torch.observability.tracing import suppress_tracing

    report = build_run_report(output_path, runner=runner, extra=extra)
    path = report_path(output_path)
    report["report_path"] = path
    with suppress_tracing():  # the recorder's own IO is not run signal
        write_bytes(path, json.dumps(report, indent=1).encode())
    logger.info(
        "flight recorder: %d spans, %d trace(s) -> %s",
        report["span_count"], len(report["trace_ids"]), path,
    )
    return report
