"""``chip_smoke.py``'s ``observe`` phase, which ``chip_smoke.py`` runs right
after its ``split`` phase on that phase's corpus and outputs, or alone on
the card.

Run from the repository root on a machine with one NVIDIA GPU:

    python3 scripts/observe_phase.py

Alone, it builds the kernels, checks flash at ``chip_smoke.FLASH_CASES``,
writes the split corpus and runs ``chip_smoke.drive_split`` first (runs A
and B, both runners, resume), whose outputs the phase compares with. Every
run has every kernel's launch counter zeroed just before it and read just
after, and stage_timer's aggregates emptied before it. One JSON line,
``observe``:

- **traced run B**: run B's ``SPLIT_CAPTION_VIDEOS`` videos at ``VLM_BASE``
  captions with ``tracing=True``, through the default (pipelined) runner.
  The same clip uuids as the untraced run B, embeddings within
  ``EMBED_BOUND``, every window captioned; each of ``PIPELINE_KERNELS``
  launched; ``profile/traces/driver.ndjson`` written and
  ``report/run_report.json`` ``connected``, its ``dispatch`` section
  holding the embed stage's device pipeline with the dispatches, rows,
  ``compute_s`` and ``gap_s`` of that pipeline's own records (the report
  rounds to 1e-4 s, as the reference's does: held within 1e-6 of the
  rounded sums), its ``caption_phases`` the caption stage; per-stage busy
  seconds of the ``stage.<name>.process`` spans within 2% or 50 ms of
  ``chip_smoke.timed_stages``' seconds. Then run B once more untraced: the
  traced wall beside both untraced walls (the split phase's, which ran
  first, and this one, which ran after) is the tracing overhead, with the
  span count, the NDJSON bytes, the seconds from the end of the
  ``run.split`` span to the report (flush, collection, delivery), and the
  host's cost of one span (``SPAN_COST_SPANS`` empty spans timed).
- **traced sequential run**: the split phase's 2-video ``videos_c`` with
  ``tracing=True`` through ``SequentialRunner``, the same report checks,
  and its spans exported over OTLP/HTTP to a fake collector on a free
  local port: the collector receives every span of the NDJSON trace.
- **live status**: run A's ``report/live/status.json`` (checked by the
  split phase right after run A) is reported again here with both traced
  runs' final snapshots: ``final``, every stage ``finished``.
- **stall detection**: a CPU-only toy pipeline whose first batch hangs
  (chaos ``worker.batch.hang``) under short anomaly thresholds publishes a
  ``stuck_batch`` anomaly in its live snapshot while the batch still
  hangs, under a hard time limit of its own.

A recorder that fails is logged and swallowed by ``run_split`` (the run's
output stands), so every check above reads the files the run wrote.
"""

from __future__ import annotations

import collections
import contextlib
import json
import os
import shutil
import sys
import tempfile
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path

import numpy as np
import torch

SEED = 16
BUSY_REL = 0.02  # span busy vs timed_stages: 2% ...
BUSY_ABS_S = 0.05  # ... or 50 ms, whichever is larger
REPORT_ROUNDING_S = 1e-6
STALL_HANG_S = 3.0
STALL_STUCK_AFTER_S = 0.5
STALL_LIMIT_S = 30.0
OTLP_ENV = "CURATE_OTLP_ENDPOINT"
SPAN_COST_SPANS = 20000


class _Collector:
    """A local OTLP/HTTP trace sink on a free port (the fake collector)."""

    def __init__(self) -> None:
        self.spans: list[dict] = []
        self.posts = 0
        lock = threading.Lock()
        sink = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *args):
                pass

            def do_POST(self):  # noqa: N802
                body = json.loads(self.rfile.read(int(self.headers.get("content-length", "0"))))
                with lock:
                    sink.posts += 1
                    sink.spans.extend(s for rs in body["resourceSpans"] for ss in rs["scopeSpans"]
                                      for s in ss["spans"])
                self.send_response(200)
                self.send_header("content-length", "0")
                self.end_headers()

        self.server = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.thread = threading.Thread(target=self.server.serve_forever, daemon=True)

    @property
    def endpoint(self) -> str:
        host, port = self.server.server_address[:2]
        return f"http://{host}:{port}"

    def __enter__(self):
        self.thread.start()
        return self

    def __exit__(self, *exc):
        self.server.shutdown()
        self.server.server_close()
        self.thread.join(timeout=10)


@contextlib.contextmanager
def captured_pipelines(out: list):
    """Every ``DevicePipeline`` made in the block, appended to ``out``."""
    from cosmos_curate_tpu_torch.models.device_pipeline import DevicePipeline

    saved = DevicePipeline.__init__

    def init(self, *args, **kw):
        saved(self, *args, **kw)
        out.append(self)

    DevicePipeline.__init__ = init
    try:
        yield
    finally:
        DevicePipeline.__init__ = saved


@contextlib.contextmanager
def env(**values):
    """Environment variables set for the block and restored after it."""
    saved = {k: os.environ.get(k) for k in values}
    os.environ.update({k: str(v) for k, v in values.items()})
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def reset_aggregates() -> None:
    from cosmos_curate_tpu_torch.observability import stage_timer as st

    for reset in (st.reset_dispatch_stats, st.reset_stage_flow, st.reset_caption_phases, st.reset_index_ops,
                  st.reset_search, st.reset_anomalies, st.reset_object_plane):
        reset()


def read_trace(out: Path) -> tuple[list[dict], int, dict]:
    """(every span record under ``<out>/profile``, their NDJSON bytes, the
    run report)."""
    files = sorted((out / "profile").rglob("*.ndjson"))
    spans = [json.loads(line) for f in files for line in f.read_text().splitlines() if line.strip()]
    report = json.loads((out / "report" / "run_report.json").read_text())
    return spans, sum(f.stat().st_size for f in files), report


def check_report(cs, label: str, out: Path, run: dict, pipelines: list, wall: float) -> dict:
    """The checks both traced runs share: the trace file, a connected
    report, its dispatch section against the device pipelines' own records,
    the span busy seconds against ``timed_stages``', and the live status."""
    assert (out / "profile" / "traces" / "driver.ndjson").is_file(), f"{label}: no driver.ndjson"
    spans, nbytes, report = read_trace(out)
    assert report["connected"] and len(report["trace_ids"]) == 1, f"{label}: trace not connected"
    assert report["span_count"] == len(spans) > 0 and report["critical_path"][0]["name"] == "run.split", label
    embeds = [p for p in pipelines if p.name.startswith("embed/")]
    assert len(embeds) == 1, f"{label}: embed pipelines {[p.name for p in embeds]}"
    pipe = embeds[0]
    records = list(pipe.records)
    agg = report["dispatch"].get(pipe.name)
    assert agg is not None, f"{label}: the report's dispatch section lacks {pipe.name}: {sorted(report['dispatch'])}"
    sums = {key: sum(getattr(r, key) for r in records) for key in ("compute_s", "gap_s", "h2d_s", "d2h_s")}
    assert agg["dispatches"] == len(records) > 0 and agg["rows"] == sum(r.rows for r in records), (label, agg)
    for key in ("compute_s", "gap_s"):
        assert abs(agg[key] - round(sums[key], 4)) <= REPORT_ROUNDING_S, (label, key, agg[key], sums[key])
    span_busy = collections.defaultdict(float)
    for s in spans:
        if s["name"].startswith("stage.") and s["name"].endswith(".process"):
            span_busy[s["name"][len("stage."):-len(".process")]] += s["duration_s"]
    timed = {name: rec["busy_s"] for name, rec in cs.stage_busy(run["spans"], wall).items()}
    assert set(span_busy) == set(timed), (label, sorted(span_busy), sorted(timed))
    busy = {}
    for name, t in timed.items():
        diff = span_busy[name] - t
        assert abs(diff) <= max(BUSY_REL * t, BUSY_ABS_S), f"{label}: {name} spans {span_busy[name]} s, timed {t} s"
        busy[name] = {"span_s": span_busy[name], "timed_s": t, "diff_s": diff}
    status = json.loads((out / "report" / "live" / "status.json").read_text())
    assert status["state"] == "finished" and all(st.get("finished", True) for st in status["stages"].values()), \
        f"{label}: live status {status['state']}"
    names = collections.Counter(s["name"] for s in spans)
    root_span = next(s for s in spans if s["name"] == "run.split")
    return dict(
        finalize_s=report["generated_at"] - root_span["end_s"],
        spans=len(spans), ndjson_bytes=nbytes, trace_files=len(list((out / "profile").rglob("*.ndjson"))),
        span_names=dict(sorted(names.items())), report_sections=sorted(report),
        dispatch={pipe.name: {**agg, "records": len(records), "records_compute_s": sums["compute_s"],
                              "records_gap_s": sums["gap_s"]}},
        caption_phases=report["caption_phases"], stage_busy=busy,
        critical_path=[n["name"] for n in report["critical_path"]],
        live_status={"state": status["state"], "seq": status["seq"], "stages": len(status["stages"])},
    )


def span_cost_us(n: int = SPAN_COST_SPANS) -> float:
    """Host microseconds one empty span costs with tracing on: open, close,
    the NDJSON record, its share of the 200-span flushes."""
    from cosmos_curate_tpu_torch.observability import tracing

    tmp = tempfile.mkdtemp(prefix="observe_spans-")
    tracing.enable_tracing(f"{tmp}/t.ndjson")
    try:
        t0 = time.perf_counter()
        for i in range(n):
            with tracing.traced_span("stage.X.process", batch_size=i):
                pass
        return (time.perf_counter() - t0) / n * 1e6
    finally:
        tracing.disable_tracing()
        shutil.rmtree(tmp, ignore_errors=True)


def toy_stall(limit_s: float = STALL_LIMIT_S) -> dict:
    """A CPU-only toy pipeline whose first batch hangs: the time from the
    run's start to the first live snapshot with a ``stuck_batch`` anomaly,
    which must come while the run is still inside that batch."""
    from cosmos_curate_tpu_torch import chaos
    from cosmos_curate_tpu_torch.core.pipeline import PipelineConfig, run_pipeline
    from cosmos_curate_tpu_torch.core.pipelined_runner import PipelinedRunner
    from cosmos_curate_tpu_torch.core.stage import Resources, Stage
    from cosmos_curate_tpu_torch.core.tasks import PipelineTask
    from cosmos_curate_tpu_torch.observability.live_status import read_status

    class Num(PipelineTask):
        def __init__(self, v: int) -> None:
            self.v = v

    class Bump(Stage):
        @property
        def resources(self):
            return Resources(cpus=0.5)

        def process_data(self, batch):
            return [Num(t.v + 1) for t in batch]

    tmp = Path(tempfile.mkdtemp(prefix="observe_stall-"))
    live_dir = tmp / "report" / "live"
    result: dict = {}

    def run() -> None:
        try:
            out = run_pipeline([Num(i) for i in range(4)], [Bump()], config=PipelineConfig(
                return_last_stage_outputs=True), runner=PipelinedRunner())
            result["out"] = sorted(t.v for t in out)
        except BaseException as e:  # reported by the assertion below
            result["error"] = repr(e)

    with env(CURATE_LIVE_STATUS_DIR=live_dir, CURATE_LIVE_STATUS_INTERVAL_S=0.05,
             CURATE_ANOMALY_STUCK_MIN_AGE_S=STALL_STUCK_AFTER_S):
        chaos.install(chaos.FaultPlan(rules=(chaos.FaultRule(site=chaos.SITE_WORKER_HANG, kind="hang",
                                                             delay_s=STALL_HANG_S, count=1),)))
        thread = threading.Thread(target=run, daemon=True, name="observe-stall")
        poll = threading.Event()
        t0 = time.monotonic()
        thread.start()
        seen = None
        try:
            while seen is None and time.monotonic() - t0 < STALL_HANG_S:
                snap = read_status(str(live_dir)) or {}
                stuck = [a for a in snap.get("anomalies") or () if a["kind"] == "stuck_batch"]
                if stuck:
                    seen = (time.monotonic() - t0, stuck[0], thread.is_alive(),
                            [b["batch_id"] for b in snap["stages"]["Bump"]["inflight"]])
                poll.wait(0.02)
        finally:
            thread.join(limit_s)
            chaos.uninstall()
    final = read_status(str(live_dir)) or {}
    shutil.rmtree(tmp, ignore_errors=True)
    assert not thread.is_alive(), f"stall: the toy pipeline outlived its {limit_s} s limit"
    assert "error" not in result and result["out"] == [1, 2, 3, 4], result
    assert seen is not None, f"stall: no stuck_batch within the {STALL_HANG_S} s hang"
    detected_s, event, hanging, inflight = seen
    assert hanging and inflight == [event["batch_id"]] and event["stage"] == "Bump", seen
    assert final.get("state") == "finished" and final.get("anomaly_count", 0) >= 1, final
    return dict(hang_s=STALL_HANG_S, stuck_after_s=STALL_STUCK_AFTER_S, detected_s=detected_s,
                event={k: event[k] for k in ("kind", "stage", "batch_id", "age_s", "threshold_s")},
                while_hanging=hanging, final_state=final["state"], anomaly_count=final["anomaly_count"])


def drive_observe(cs, dev, timer, root: Path, corpus: list[Path], split: dict) -> dict:
    """The phase on the split phase's corpus and outputs (``root``:
    ``videos_b``, ``videos_c``, ``out_a``, ``out_b``, ``out_seq``)."""
    from cosmos_curate_tpu_torch.core.runner import SequentialRunner, default_runner
    from cosmos_curate_tpu_torch.models.embedder import VIDEO_EMBED_VARIANTS
    from cosmos_curate_tpu_torch.models.vlm import SharedCaptionEngine
    from cosmos_curate_tpu_torch.observability import tracing
    from cosmos_curate_tpu_torch.pipelines.video import split as tsplit
    from cosmos_curate_tpu_torch.pipelines.video.stages.writer import ClipWriterStage

    stage_classes = (
        tsplit.VideoDownloadStage, tsplit.FixedStrideExtractorStage, tsplit.ClipTranscodingStage,
        tsplit.ClipFrameExtractionStage, tsplit.ClipEmbeddingStage, tsplit.CaptionPrepStage, tsplit.CaptionStage,
        ClipWriterStage,
    )
    cfg, model = VIDEO_EMBED_VARIANTS["video"]
    out = {}

    # traced run B, through the default runner
    b_metas, b_embs, _ = cs.split_outputs(root / "out_b", model)
    pipelines: list = []
    reset_aggregates()
    SharedCaptionEngine.reset()
    try:
        with captured_pipelines(pipelines):
            b = cs.split_run(dev, cs.split_args(root / "videos_b", root / "out_b_traced", captioning=True,
                                                caption_model="base", tracing=True), default_runner(), stage_classes)
    finally:
        SharedCaptionEngine.reset()
    assert not tracing.tracing_enabled(), "traced run B left tracing on"
    metas, embs, _ = cs.split_outputs(root / "out_b_traced", model)
    assert set(metas) == set(b_metas) and set(embs) == set(b_embs) == set(metas), "traced run B: clip uuids"
    emb_diff = max(float(np.abs(embs[u] - b_embs[u]).max()) for u in embs)
    assert emb_diff <= cs.EMBED_BOUND, f"traced run B: embeddings {emb_diff} > {cs.EMBED_BOUND}"
    windows = [w for m in metas.values() for w in m["windows"]]
    assert windows and all(w["captions"].get("default") for w in windows), "traced run B: a window has no caption"
    for name in cs.PIPELINE_KERNELS:
        assert b["launches"][name] > 0, f"traced run B: kernel {name} was not launched"
    b_report = check_report(cs, "traced run B", root / "out_b_traced", b, pipelines, b["wall"])
    assert "CaptionStage" in b_report["caption_phases"], sorted(b_report["caption_phases"])
    # run B untraced again, after the traced run: the split phase's ran first
    SharedCaptionEngine.reset()
    try:
        again = cs.split_run(dev, cs.split_args(root / "videos_b", root / "out_b_again", captioning=True,
                                                caption_model="base"), default_runner(), stage_classes)
    finally:
        SharedCaptionEngine.reset()
    assert set(cs.split_outputs(root / "out_b_again", model)[0]) == set(metas), "run B again: clip uuids"
    untraced = {"before": split["run_b"]["wall_s"], "after": again["wall"]}
    out["run_b"] = dict(
        clips=len(metas), windows_captioned=len(windows), max_abs_embedding_diff=emb_diff,
        embed_bound=cs.EMBED_BOUND, wall_s=b["wall"], untraced_wall_s=untraced,
        overhead_s={k: b["wall"] - w for k, w in untraced.items()},
        overhead_frac={k: b["wall"] / w - 1.0 for k, w in untraced.items()},
        launches=b["launches"], stages=cs.stage_busy(b["spans"], b["wall"]), **b_report,
    )

    # the traced sequential run, exported over OTLP to a local collector
    s_metas, s_embs, _ = cs.split_outputs(root / "out_seq", model)
    pipelines = []
    reset_aggregates()
    with _Collector() as sink, env(**{OTLP_ENV: sink.endpoint}):
        with captured_pipelines(pipelines):
            seq = cs.split_run(dev, cs.split_args(root / "videos_c", root / "out_seq_traced", tracing=True),
                               SequentialRunner(), stage_classes)
    metas, embs, _ = cs.split_outputs(root / "out_seq_traced", model)
    assert set(metas) == set(s_metas) and set(embs) == set(metas), "traced sequential run: clip uuids"
    seq_diff = max(float(np.abs(embs[u] - s_embs[u]).max()) for u in embs)
    assert seq_diff <= cs.EMBED_BOUND, f"traced sequential run: embeddings {seq_diff} > {cs.EMBED_BOUND}"
    assert seq["launches"]["flash"] > 0, "traced sequential run: flash was not launched"
    s_report = check_report(cs, "traced sequential run", root / "out_seq_traced", seq, pipelines, seq["wall"])
    spans, _, _ = read_trace(root / "out_seq_traced")
    assert len(sink.spans) == len(spans), f"OTLP: the collector got {len(sink.spans)} of {len(spans)} spans"
    assert collections.Counter(s["name"] for s in sink.spans) == collections.Counter(s["name"] for s in spans)
    assert {s["traceId"] for s in sink.spans} == {spans[0]["trace_id"]}, "OTLP: trace ids"
    out["sequential"] = dict(clips=len(metas), max_abs_embedding_diff=seq_diff, wall_s=seq["wall"],
                             untraced_wall_s=split["runners"]["sequential_wall_s"], launches=seq["launches"],
                             otlp={"spans": len(sink.spans), "posts": sink.posts}, **s_report)

    # run A's live status, untraced: the split phase checked it right after run A
    out["live_status_run_a"] = split["run_a"]["live_status"]
    out["stall"] = toy_stall()
    out["span_cost_us"] = span_cost_us()

    ran = b["flash_shapes"] | seq["flash_shapes"] | again["flash_shapes"]
    checked = {(tuple(shape), causal) for shape, causal in split["flash_shapes_ran"]}
    out["flash_checked_here"] = cs.check_new_flash_shapes(timer, ran - checked, SEED + 100)
    out["launches"] = {name: b["launches"][name] + again["launches"][name] + seq["launches"][name]
                       for name in b["launches"]}
    return out


def run(cs, dev, timer, root: Path, corpus: list[Path], split: dict) -> dict:
    """The phase, its line emitted as it ends; returns the record."""
    t0 = time.monotonic()
    record = {**drive_observe(cs, dev, timer, root, corpus, split), "phase_s": time.monotonic() - t0}
    b = record["run_b"]
    cs.emit({"phase": "observe", **record})
    print(f"tracing overhead: traced run B {b['wall_s']:.3f} s vs untraced {b['untraced_wall_s']['before']:.3f} s "
          f"before ({100 * b['overhead_frac']['before']:+.1f}%) and {b['untraced_wall_s']['after']:.3f} s after "
          f"({100 * b['overhead_frac']['after']:+.1f}%); {b['spans']} spans, {b['ndjson_bytes']} NDJSON bytes, "
          f"{record['span_cost_us']:.2f} us a span, report {b['finalize_s']:.3f} s after the run", flush=True)
    return record


def main() -> int:
    if not torch.cuda.is_available():
        print("observe_phase: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.getcwd())
    # pyarrow imported first in a worker thread has crashed a later read in
    # the main thread (pyarrow 25): import it here
    import pyarrow.parquet  # noqa: F401

    import chip_smoke as cs

    dev = torch.device("cuda", 0)
    started = time.monotonic()
    timer, build_s = cs.phase_prologue(dev)
    with cs.split_corpus() as (root, corpus, corpus_s):
        split = cs.drive_split(dev, timer, root, corpus, corpus_s)
        cs.emit({"phase": "split", "build_s": build_s, **split})
        run(cs, dev, timer, root, corpus, split)
    cs.emit({"phase": "timing", "script_s": time.monotonic() - started})
    return 0


if __name__ == "__main__":
    sys.exit(main())
