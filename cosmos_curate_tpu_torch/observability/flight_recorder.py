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
the original driver could source into a rebuilt report. A multi-node run's
nodes each write a sidecar (``write_node_stats``: ``report/node-stats-<rank>
.json``), which ``local merge-summaries`` folds (``load_node_stats``) into
the merged report; the cross-node engine adds its per-node plan
(``node_plan``) and its node-loss receipts (``node_events``).
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


def clear_trace_artifacts(output_path: str, *, rank: int | None = None) -> int:
    """Delete span files (``*.ndjson``) a PRIOR traced run left under
    ``<output>/profile``. A traced re-run into the same root overwrites
    only the base driver file — stale rotation parts and collected worker
    files would keep the old run's trace ids and hand the new run a false
    DISCONNECTED verdict (and a critical path rooted in dead spans).

    ``rank=None`` (single node) clears everything, including stale
    ``report/node-stats-*.json`` sidecars. With ``rank`` set (multi-node)
    the clear is scoped to files only THIS rank ever writes — its
    ``driver-n<rank>`` NDJSON (base + rotation parts), its
    ``collected/node<rank>/`` worker spans, and its node-stats sidecar —
    so peers already writing to the shared root are never touched (rank 0
    additionally owns a prior single-node run's plain ``driver.ndjson``
    files, so growing a root from one node to N starts clean too). A
    re-run with FEWER nodes than the prior run leaves the dead ranks'
    files behind (no rank owns them at startup); use a fresh output root
    when shrinking the topology. Returns the number of files removed."""
    root = f"{output_path.rstrip('/')}/profile"
    client = get_storage_client(root)
    removed = 0
    try:
        files = list(client.list_files(root, suffixes=(".ndjson",)))
    except Exception:
        files = []
    for info in files:
        if rank is not None:
            name = info.path.rsplit("/", 1)[-1]
            own = name.startswith(f"driver-n{rank}.") or (
                f"/collected/node{rank}/" in info.path
            )
            # rank 0 exists in every topology, so it also owns the files a
            # prior SINGLE-node run left behind (plain driver.ndjson +
            # parts) — without this, growing a root from 1 node to N mixes
            # the old trace into the merge
            if rank == 0 and name.startswith("driver."):
                own = True
            if not own:
                continue
        try:
            client.delete(info.path)
            removed += 1
        except Exception:
            logger.warning("could not remove stale span file %s", info.path)
    # stale sidecars feed load_node_stats at merge time: a dead run's ranks
    # would add their drops/busy-seconds to the merged report
    report_root = f"{output_path.rstrip('/')}/report"
    report_client = get_storage_client(report_root)
    try:
        sidecars = [
            info
            for info in report_client.list_files(report_root, suffixes=(".json",))
            if info.path.rsplit("/", 1)[-1].startswith("node-stats-")
        ]
    except Exception:
        sidecars = []
    for info in sidecars:
        if rank is not None and info.path.rsplit("/", 1)[-1] != f"node-stats-{rank}.json":
            continue
        try:
            report_client.delete(info.path)
            removed += 1
        except Exception:
            logger.warning("could not remove stale node stats %s", info.path)
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
    node_plan = getattr(runner, "node_plan", None)
    if node_plan:
        stats["node_plan"] = node_plan
    # node-loss receipts: declared deaths and what lineage reconstruction
    # recomputed (engine/runner.py)
    node_events = getattr(runner, "node_events", None)
    reconstructed = int(getattr(runner, "objects_reconstructed", 0) or 0)
    if node_events or reconstructed:
        stats["node_events"] = {
            "deaths": list(node_events or []),
            "objects_reconstructed": reconstructed,
            "reconstruction_seconds": round(float(getattr(runner, "reconstruction_seconds", 0.0) or 0.0), 4),
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


def write_node_stats(
    output_path: str, rank: int, runner: Any = None, *, extra: dict | None = None
) -> str:
    """Persist this node's runner-sourced sections as a per-node sidecar.

    Multi-node runs build the merged report at merge-summaries time, in a
    process where every node runner's memory is gone — without the sidecar
    the merged report would claim ``dead_lettered: 0`` and empty
    dispatch/flow sections no matter what the run actually did.

    ``extra`` overrides runner-sourced keys: work-stealing nodes run the
    pipeline once per stolen batch on one runner, and every ``run()`` resets
    its DLQ accounting, so the caller passes drop totals accumulated across
    batches in place of the last batch's."""
    from cosmos_curate_tpu_torch.observability.tracing import suppress_tracing

    stats = runner_stats(runner)
    if extra:
        stats.update(extra)
    stats["node_rank"] = rank
    schema_stamp.stamp(stats, "node-stats")
    path = f"{output_path.rstrip('/')}/report/node-stats-{rank}.json"
    with suppress_tracing():
        write_bytes(path, json.dumps(stats, indent=1).encode())
    return path


def load_node_stats(output_path: str) -> dict | None:
    """Merge all ``report/node-stats-*.json`` sidecars into one
    prior-shaped dict (None when there are none): ``stage_times``,
    ``stage_counts`` and ``dead_lettered`` sum across nodes; dispatch/flow
    aggregates are namespaced per node (``n<rank>/<name>``) — their derived
    fractions must not be averaged blind. ``wall_s`` is the max across
    nodes (data-parallel nodes run concurrently, so the run lasts as long
    as its slowest node); ``pipeline_overlap_frac`` is the mean over the
    nodes that reported one."""
    root = f"{output_path.rstrip('/')}/report"
    client = get_storage_client(root)
    try:
        files = list(client.list_files(root, suffixes=(".json",)))
    except Exception:
        return None
    merged: dict[str, Any] = {
        "dispatch": {}, "stage_flow": {}, "caption_phases": {}, "index_ops": {},
        "search": {},
        "object_plane": {}, "stage_times": {}, "stage_counts": {},
        "dead_lettered": 0,
    }
    dlq_dirs: list[str] = []
    overlaps: list[float] = []
    found = False
    for info in files:
        if not info.path.rsplit("/", 1)[-1].startswith("node-stats-"):
            continue
        try:
            stats = json.loads(client.read_bytes(info.path))
        except (OSError, ValueError):
            continue
        found = True
        rank = stats.get("node_rank", "?")
        for key in ("dispatch", "stage_flow", "caption_phases", "index_ops", "search"):
            for name, agg in (stats.get(key) or {}).items():
                merged[key][f"n{rank}/{name}"] = agg
        # object-plane aggregates are already keyed per node: sum numeric
        # fields when two sidecars report the same node (driver rank saw
        # agent deltas AND the agent rank dumped its own totals)
        for node, agg in (stats.get("object_plane") or {}).items():
            into = merged["object_plane"].setdefault(node, {})
            for k, v in agg.items():
                if isinstance(v, (int, float)):
                    into[k] = round(into.get(k, 0) + v, 4)
        for name, s in (stats.get("stage_times") or {}).items():
            merged["stage_times"][name] = round(
                merged["stage_times"].get(name, 0.0) + float(s), 4
            )
        for name, counts in (stats.get("stage_counts") or {}).items():
            into = merged["stage_counts"].setdefault(name, {})
            for k, v in counts.items():
                if isinstance(v, (int, float)):
                    into[k] = into.get(k, 0) + v
        merged["dead_lettered"] += int(stats.get("dead_lettered", 0) or 0)
        # anomaly verdicts: counts sum across nodes, the recent tail
        # concatenates (bounded — it was bounded per node already)
        anom = stats.get("anomalies")
        if anom:
            into = merged.setdefault(
                "anomalies", {"total": 0, "counts": {}, "recent": []}
            )
            into["total"] += int(anom.get("total", 0) or 0)
            for k, v in (anom.get("counts") or {}).items():
                into["counts"][k] = into["counts"].get(k, 0) + int(v)
            into["recent"] = (into["recent"] + list(anom.get("recent") or []))[-64:]
        # node-loss receipts concatenate (deaths) / sum (reconstruction):
        # every rank's driver sees only the agents IT lost
        ne = stats.get("node_events")
        if ne:
            into = merged.setdefault(
                "node_events",
                {"deaths": [], "objects_reconstructed": 0, "reconstruction_seconds": 0.0},
            )
            into["deaths"].extend(ne.get("deaths") or [])
            into["objects_reconstructed"] += int(ne.get("objects_reconstructed", 0) or 0)
            into["reconstruction_seconds"] = round(
                into["reconstruction_seconds"]
                + float(ne.get("reconstruction_seconds", 0.0) or 0.0),
                4,
            )
        if stats.get("dlq_run_dir"):
            dlq_dirs.append(stats["dlq_run_dir"])
        if stats.get("wall_s"):
            merged["wall_s"] = max(
                merged.get("wall_s", 0.0), float(stats["wall_s"])
            )
        if stats.get("pipeline_overlap_frac") is not None:
            overlaps.append(float(stats["pipeline_overlap_frac"]))
    if not found:
        return None
    if dlq_dirs:
        merged["dlq_run_dir"] = ",".join(dlq_dirs)
    if overlaps:
        merged["pipeline_overlap_frac"] = round(sum(overlaps) / len(overlaps), 4)
    return merged


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
    if stats.get("node_plan"):
        report["node_plan"] = stats["node_plan"]
    if stats.get("node_events"):
        report["node_events"] = stats["node_events"]
    # precedence: live runner accounting (it includes setup time that spans
    # do not book to the stage) > prior or sidecar accounting > span-derived
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
                    "node_plan", "node_events", "stage_counts", "dead_lettered", "dlq_run_dir"):
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
