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

The report has the reference's sections and schema version.
``load_report`` reads one back and ``render_report`` prints it (the
``report`` command, cli/report_cli.py); ``prior`` carries the sections only
the original driver could source into a rebuilt report. Not ported yet:
the per-node sidecars and their merge, and the node-plan and node-loss
sections (ROADMAP queue A item 15).
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


def load_report(path: str, *, strict: bool = False) -> dict | None:
    """Read an existing ``run_report.json`` (None when absent). Unreadable
    content returns None, or raises ValueError with ``strict=True``: the
    report command without ``--rebuild`` treats a torn report as an error,
    not as absence."""
    client = get_storage_client(path)
    try:
        if not client.exists(path):
            return None
        return json.loads(client.read_bytes(path))
    except (OSError, ValueError) as e:
        if strict:
            raise ValueError(f"unreadable report {path}: {e}") from e
        return None


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


def build_run_report(
    output_path: str, *, runner: Any = None, extra: dict | None = None, prior: dict | None = None
) -> dict:
    """Assemble the report dict (no write). ``runner`` contributes
    stage_times / stage_counts / DLQ / overlap when given; span-derived
    numbers fill the gaps, so the report works for any runner (or none).

    ``prior`` is a report written earlier for the same run: the sections
    this process cannot source (the original driver's aggregates, its
    runner's accounting) are carried over instead of emptied, so
    ``report --rebuild`` never degrades the artifact."""
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
    report["stage_times"] = (
        stats["stage_times"] or (prior or {}).get("stage_times") or _stage_times_from_spans(spans)
    )
    wall = stats.get("wall_s") or (prior or {}).get("wall_s") or 0.0
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
    if prior:
        # stage_times / wall_s are handled above (their span-derived
        # fallbacks would always win this not-set check)
        for key in ("dispatch", "stage_flow", "caption_phases", "index_ops", "search", "object_plane", "anomalies",
                    "stage_counts", "dead_lettered", "dlq_run_dir"):
            if not report.get(key) and prior.get(key):
                report[key] = prior[key]
        # presence, not truthiness: an overlap of 0.0 is a measurement
        if "pipeline_overlap_frac" not in report and "pipeline_overlap_frac" in prior:
            report["pipeline_overlap_frac"] = prior["pipeline_overlap_frac"]
    if extra:
        report.update(extra)
    return report


def write_run_report(
    output_path: str,
    *,
    runner: Any = None,
    extra: dict | None = None,
    require_spans: bool = False,
    prior: dict | None = None,
) -> dict:
    """Build the report and write it to ``<output>/report/run_report.json``
    through the storage layer. Returns the report with ``report_path``
    set. ``require_spans=True`` skips the write (returning the unwritten
    report) when no span was collected."""
    from cosmos_curate_tpu_torch.observability.tracing import suppress_tracing

    report = build_run_report(output_path, runner=runner, extra=extra, prior=prior)
    if require_spans and not report["span_count"]:
        return report
    path = report_path(output_path)
    report["report_path"] = path
    with suppress_tracing():  # the recorder's own IO is not run signal
        write_bytes(path, json.dumps(report, indent=1).encode())
    logger.info(
        "flight recorder: %d spans, %d trace(s) -> %s",
        report["span_count"], len(report["trace_ids"]), path,
    )
    return report


# -- rendering ---------------------------------------------------------------


def render_report(report: dict) -> str:
    """Human view: trace connectivity, the critical path, and per-stage /
    per-span-name time breakdowns (what `cosmos-curate-tpu-torch report` prints)."""
    lines: list[str] = []
    lines.append(f"run report: {report.get('output_path', '?')}")
    n_traces = len(report.get("trace_ids", []))
    if report.get("connected"):
        status = f"CONNECTED ({report['trace_ids'][0]})"
    elif n_traces:
        status = f"DISCONNECTED — {n_traces} trace ids"
    else:
        status = "no spans (tracing was off)"
    lines.append(
        f"trace: {status}; {report.get('span_count', 0)} spans from "
        f"{report.get('processes', 0)} process(es); wall {report.get('wall_s', 0):.2f}s"
    )
    cp = report.get("critical_path") or []
    if cp:
        total = cp[0]["duration_s"] or 0.0
        lines.append(f"critical path ({total:.2f}s):")
        for depth, node in enumerate(cp):
            pct = f" ({100.0 * node['duration_s'] / total:.0f}%)" if total else ""
            prefix = "  " + "  " * depth + ("└─ " if depth else "")
            pid = f" [pid {node['pid']}]" if node.get("pid") is not None else ""
            lines.append(f"{prefix}{node['name']}  {node['duration_s']:.2f}s{pct}{pid}")
    stage_times = report.get("stage_times") or {}
    if stage_times:
        wall = report.get("wall_s") or 0.0
        lines.append("per-stage time (busy seconds):")
        for name, s in sorted(stage_times.items(), key=lambda kv: -kv[1]):
            pct = f"  {100.0 * s / wall:5.1f}% of wall" if wall else ""
            lines.append(f"  {name:<40} {s:9.2f}s{pct}")
    dispatch = report.get("dispatch") or {}
    if dispatch:
        lines.append("device dispatch (per pipeline):")
        for name, agg in sorted(dispatch.items()):
            lines.append(
                f"  {name:<40} {agg.get('dispatches', 0):5d} dispatches  "
                f"compute {agg.get('compute_s', 0.0):8.2f}s  "
                f"gap_frac {agg.get('gap_frac', 0.0):.3f}"
            )
    flow = report.get("stage_flow") or {}
    if flow:
        lines.append("stage flow:")
        for name, agg in sorted(flow.items()):
            lines.append(
                f"  {name:<40} busy {agg.get('busy_s', 0.0):8.2f}s  "
                f"busy_frac_mean {agg.get('busy_frac_mean', 0.0):.3f}  "
                f"queue_peak {agg.get('queue_depth_peak', 0)}"
            )
    plane = report.get("object_plane") or {}
    if plane:
        lines.append("object plane (per node):")
        for node, agg in sorted(plane.items()):
            moved = agg.get("fetch_bytes", 0) + agg.get("prefetch_bytes", 0)
            lines.append(
                f"  {node:<24} moved {moved / 1e6:9.2f}MB  "
                f"demand-wait {agg.get('fetch_wait_s', 0.0):7.2f}s  "
                f"prefetch {agg.get('prefetches', 0)} "
                f"(hits {agg.get('prefetch_hits', 0)}, "
                f"misses {agg.get('prefetch_misses', 0)})"
            )
    node_plan = report.get("node_plan") or {}
    if node_plan:
        lines.append("node plan (stage -> workers per node):")
        for stage, counts in node_plan.items():
            placed = ", ".join(
                f"{nid or 'driver'}={n}" for nid, n in sorted(counts.items())
            )
            lines.append(f"  {stage:<40} {placed}")
    events = report.get("node_events") or {}
    if events:
        deaths = events.get("deaths") or []
        lines.append(
            f"node events: {len(deaths)} death(s), "
            f"{events.get('objects_reconstructed', 0)} object(s) reconstructed "
            f"in {events.get('reconstruction_seconds', 0.0):.2f}s"
        )
        for ev in deaths:
            lines.append(
                f"  {ev.get('node', '?'):<24} {ev.get('reason', '?')} "
                f"({ev.get('workers_lost', 0)} worker(s) lost)"
            )
    index_ops = report.get("index_ops") or {}
    if index_ops:
        lines.append("corpus index:")
        for name, agg in sorted(index_ops.items()):
            lines.append(
                f"  {name:<40} adds {agg.get('adds', 0):7d}  "
                f"queries {agg.get('queries', 0):7d}  "
                f"dupes {agg.get('duplicates', 0):6d}  "
                f"probe_fanout {agg.get('probe_fanout_mean', 0.0):.2f}  "
                f"query {agg.get('query_s', 0.0):.2f}s"
            )
    search = report.get("search") or {}
    if search:
        lines.append("search serving:")
        for name, agg in sorted(search.items()):
            lines.append(
                f"  {name:<40} req {agg.get('searches', 0):7d}  "
                f"p50 {agg.get('latency_p50_ms', 0.0):7.1f}ms  "
                f"p99 {agg.get('latency_p99_ms', 0.0):7.1f}ms  "
                f"qps {agg.get('qps', 0.0):8.1f}  "
                f"cache_hit {agg.get('cache_hit_ratio', 0.0):.2f}  "
                f"gen {agg.get('generation', 0)}"
            )
    caption = report.get("caption_phases") or {}
    if caption:
        lines.append("caption engine phases:")
        for name, agg in sorted(caption.items()):
            lines.append(
                f"  {name:<40} prep {agg.get('prep_s', 0.0):7.2f}s  "
                f"prefill {agg.get('prefill_s', 0.0):7.2f}s  "
                f"decode {agg.get('decode_s', 0.0):7.2f}s  "
                f"idle_frac {agg.get('idle_frac', 0.0):.3f}  "
                f"prefix_hits {agg.get('prefix_cache_hits', 0)}"
            )
            if agg.get("kv_blocks_total"):
                lines.append(
                    f"  {'':<40} kv_blocks {agg.get('kv_blocks_peak', 0)}/"
                    f"{agg.get('kv_blocks_total', 0)} peak  "
                    f"prefix_block_refs {agg.get('prefix_block_refs', 0)}  "
                    f"cow {agg.get('kv_cow_copies', 0)}  "
                    f"interleaved_steps {agg.get('interleaved_steps', 0)}"
                )
            # per-owner accounting: which job/stage consumed the shared
            # engine (cross-job continuous batching receipt)
            for owner, sub in sorted((agg.get("owners") or {}).items()):
                lines.append(
                    f"    owner {owner:<36} requests {sub.get('requests', 0):6d}  "
                    f"decode_tokens {sub.get('decode_tokens', 0):8d}  "
                    f"drives {sub.get('drives', 0)}"
                )
    anomalies = report.get("anomalies") or {}
    if anomalies.get("total"):
        lines.append(
            f"anomalies: {anomalies['total']} "
            f"(stall/anomaly detector — see docs/OBSERVABILITY.md)"
        )
        for key, n in sorted(anomalies.get("counts", {}).items()):
            lines.append(f"  {key:<40} {n}")
        for ev in (anomalies.get("recent") or [])[-5:]:
            lines.append(
                f"    {ev.get('kind', '?')} @ {ev.get('stage', '?')}: "
                f"{ev.get('detail', '')}"
            )
    dead = report.get("dead_lettered", 0)
    if dead:
        lines.append(
            f"dead-lettered batches: {dead} "
            f"(dlq: {report.get('dlq_run_dir', '?')} — `cosmos-curate-tpu-torch dlq list`)"
        )
    else:
        lines.append("dead-lettered batches: 0")
    return "\n".join(lines)
