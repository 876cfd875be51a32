"""The port's flight recorder and artifact delivery
(``cosmos_curate_tpu_torch/observability/flight_recorder.py``,
``artifacts.py``) against the JAX package's: one toy pipeline traced through
both packages' ``SequentialRunner`` and ``PipelinedRunner`` the way
``run_split`` traces a run (the same multiset of span names under a single
trace id, the same run-report keys, ``connected``), a traced re-run into the
same root, the dead-letter entry's trace id, the report of one fixed span
file, and the collection and delivery of one staging tree.

Both packages' tracers, environment and aggregates are restored after every
test (tests/fixtures/observability.py)."""

from __future__ import annotations

import collections
import json
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

from cosmos_curate_tpu.engine import dead_letter as jdlq
from cosmos_curate_tpu.observability import artifacts as jartifacts
from cosmos_curate_tpu.observability import flight_recorder as jrecorder
from cosmos_curate_tpu.observability import tracing as jtracing
from cosmos_curate_tpu_torch.engine import dead_letter as tdlq
from cosmos_curate_tpu_torch.observability import artifacts as tartifacts
from cosmos_curate_tpu_torch.observability import flight_recorder as trecorder
from cosmos_curate_tpu_torch.observability import tracing as ttracing
from tests.fixtures.observability import observability_state  # noqa: F401  (autouse)
from tests.test_torch_live_status import run_toy, toy_package

OBS = {
    "jax": SimpleNamespace(tracing=jtracing, recorder=jrecorder, artifacts=jartifacts, dlq=jdlq),
    "torch": SimpleNamespace(tracing=ttracing, recorder=trecorder, artifacts=tartifacts, dlq=tdlq),
}
# report keys whose values depend on the clock, the pid or the path
VOLATILE = ("generated_at", "output_path", "report_path", "trace_ids", "critical_path", "spans_by_name", "wall_s",
            "stage_times", "stage_flow", "pipeline_overlap_frac", "dlq_run_dir")


def traced_run(name: str, runner_name: str, out: Path, **kw) -> tuple[list[int], dict]:
    """The toy pipeline traced as ``run_split`` traces a run: a clean trace
    root, one ``run.split`` span carried as the process parent, then the
    artifact collection, delivery and the run report."""
    obs, pkg = OBS[name], toy_package(name)
    tr = obs.tracing
    obs.recorder.clear_trace_artifacts(str(out))
    tr.enable_tracing(str(out / "profile" / "traces" / "driver.ndjson"))
    root = tr.start_span("run.split", output_path=str(out))
    tr.attach_traceparent(tr.format_traceparent(root))
    runner = pkg.sequential(raise_on_error=False) if runner_name == "sequential" else \
        pkg.pipelined(raise_on_error=False)
    try:
        result = pkg.run_pipeline([pkg.Num(i) for i in range(kw.get("n", 8))],
                                  [pkg.Bump(), pkg.Double(kw.get("fail_on", ()))],
                                  config=pkg.config(return_last_stage_outputs=True), runner=runner)
    finally:
        tr.end_span(root)
        tr.disable_tracing()
        obs.artifacts.collect_artifacts(str(out))
        obs.artifacts.finalize_delivery(str(out))
    report = obs.recorder.write_run_report(str(out), runner=runner)
    return sorted(t.v for t in result or []), report


def _span_names(out: Path) -> collections.Counter:
    return collections.Counter(json.loads(line)["name"] for f in (out / "profile").rglob("*.ndjson")
                               for line in f.read_text().splitlines() if line.strip())


@pytest.mark.parametrize("runner_name", ["sequential", "pipelined"])
def test_traced_toy_pipeline_matches_jax(runner_name, tmp_path, monkeypatch):
    monkeypatch.setenv("CURATE_TRACE_DIR", str(tmp_path / "staging"))
    outs, reports, names = {}, {}, {}
    for name in OBS:
        outs[name], reports[name] = traced_run(name, runner_name, tmp_path / name)
        names[name] = _span_names(tmp_path / name)
    assert outs["torch"] == outs["jax"] == [2 * (i + 1) for i in range(8)]
    assert names["torch"] == names["jax"]
    assert names["torch"]["stage.Bump.process"] == 4 and names["torch"]["run.split"] == 1
    got, want = reports["torch"], reports["jax"]
    assert set(got) == set(want)
    assert got["connected"] and want["connected"] and len(got["trace_ids"]) == 1
    assert got["span_count"] == sum(names["torch"].values()) == want["span_count"]
    assert got["critical_path"][0]["name"] == "run.split"
    assert [n["name"] for n in got["critical_path"]][:2] == [n["name"] for n in want["critical_path"]][:2]
    assert {k: v for k, v in got.items() if k not in VOLATILE} == {k: v for k, v in want.items() if k not in VOLATILE}
    assert set(got["stage_flow"]) == set(want["stage_flow"])
    assert set(got["stage_times"]) == set(want["stage_times"]) == {"Bump", "Double"}
    on_disk = json.loads((tmp_path / "torch" / "report" / "run_report.json").read_text())
    assert on_disk == got
    # delivery wrote the same (empty) collection in both
    for rel in ("profile/collected/index.json", "profile/collected/node0/_manifest.json"):
        assert json.loads((tmp_path / "torch" / rel).read_text()) == json.loads((tmp_path / "jax" / rel).read_text())


@pytest.mark.parametrize("name", list(OBS))
def test_traced_rerun_starts_from_a_clean_trace(name, tmp_path, monkeypatch):
    monkeypatch.setenv("CURATE_TRACE_DIR", str(tmp_path / "staging"))
    monkeypatch.setattr(OBS[name].tracing._NdjsonBackend, "FLUSH_EVERY", 4)  # rotation parts
    out = tmp_path / "out"
    _, first = traced_run(name, "sequential", out)
    assert len(list((out / "profile" / "traces").glob("*.ndjson"))) > 1
    # debris of another run: a stale part, a collected file, a node sidecar
    (out / "profile" / "traces" / "driver.part99.ndjson").write_text(
        json.dumps({"name": "stale", "trace_id": "f" * 32, "span_id": "e" * 16, "duration_s": 9.0}) + "\n")
    (out / "report" / "node-stats-3.json").write_text("{}")
    _, second = traced_run(name, "sequential", out)
    assert second["connected"] and second["trace_ids"] != first["trace_ids"]
    assert second["span_count"] == first["span_count"]
    assert not (out / "report" / "node-stats-3.json").exists()
    assert OBS[name].recorder.clear_trace_artifacts(str(out)) >= 2
    assert not list((out / "profile").rglob("*.ndjson"))


@pytest.mark.parametrize("runner_name", ["sequential", "pipelined"])
def test_dead_letter_entry_carries_the_trace_id(runner_name, tmp_path, monkeypatch):
    monkeypatch.setenv("CURATE_TRACE_DIR", str(tmp_path / "staging"))
    metas = {}
    for name, obs in OBS.items():
        monkeypatch.setenv("CURATE_DLQ_DIR", str(tmp_path / name / "dlq"))
        # Bump makes 2 * 2 + 1 = 5 of input 2: Double's batch [4, 5, 6] drops
        out, report = traced_run(name, runner_name, tmp_path / name, fail_on=(5,))
        assert out == [2, 4, 6, 14, 16]
        assert report["dead_lettered"] == 1 and report["dlq_run_dir"]
        metas[name] = (report, [e.meta for e in obs.dlq.list_entries(str(tmp_path / name / "dlq"))])
    for name, (report, entries) in metas.items():
        assert len(entries) == 1, name
        assert entries[0]["trace_id"] == report["trace_ids"][0], name
    assert set(metas["torch"][1][0]) == set(metas["jax"][1][0])
    # tracing off: the entry says so with an empty id, in both
    for name, obs in OBS.items():
        monkeypatch.setenv("CURATE_DLQ_DIR", str(tmp_path / name / "dlq_untraced"))
        pkg = toy_package(name)
        run_toy(pkg, runner_name, fail_on=(5,), raise_on_error=False)
        (entry,) = obs.dlq.list_entries(str(tmp_path / name / "dlq_untraced"))
        assert entry.meta["trace_id"] == ""


def _fixed_spans(rng) -> list[dict]:
    """A span tree with pinned ids and durations: a root, three stages with
    processes and one storage write each, and a disconnected fragment."""
    spans = [{"name": "run.split", "trace_id": "a" * 32, "span_id": "r" * 16, "parent_id": None, "duration_s": 10.0,
              "pid": 1}]
    for i, stage in enumerate(("Bump", "Double", "Writer")):
        sid = f"{i}" * 16
        spans.append({"name": f"stage.{stage}", "trace_id": "a" * 32, "span_id": sid, "parent_id": "r" * 16,
                      "duration_s": float(rng.random() * 3), "pid": 1})
        for j in range(3):
            spans.append({"name": f"stage.{stage}.process", "trace_id": "a" * 32, "span_id": f"{i}{j}".ljust(16, "p"),
                          "parent_id": sid, "duration_s": float(rng.random()), "pid": 2})
        spans.append({"name": "storage.write", "trace_id": "a" * 32, "span_id": f"{i}".ljust(16, "w"),
                      "parent_id": sid, "duration_s": 0.01, "pid": 2})
    spans.append({"name": "orphan", "trace_id": "b" * 32, "span_id": "o" * 16, "parent_id": "x" * 16,
                  "duration_s": 0.5})
    return spans


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("fragment", [False, True])
def test_report_of_a_fixed_span_file_matches_jax(seed, fragment, tmp_path):
    spans = _fixed_spans(np.random.default_rng(seed))
    if not fragment:
        spans = spans[:-1]
    reports = {}
    for name, obs in OBS.items():
        out = tmp_path / name
        part = out / "profile" / "collected" / "node0" / "run-1" / "trace-2.ndjson"
        part.parent.mkdir(parents=True)
        (out / "profile" / "traces").mkdir(parents=True)
        (out / "profile" / "traces" / "driver.ndjson").write_text(
            "\n".join(json.dumps(s) for s in spans[:6]) + "\nnot json\n\n")
        part.write_text("\n".join(json.dumps(s) for s in spans[6:]) + "\n")
        reports[name] = obs.recorder.build_run_report(str(out))
    got, want = reports["torch"], reports["jax"]
    for r in (got, want):
        r.pop("generated_at")
        r.pop("output_path")
    assert got == want
    assert got["connected"] is not fragment and got["span_count"] == len(spans) and got["processes"] == 2
    assert set(got["stage_times"]) == {"Bump", "Double", "Writer"}


@pytest.mark.parametrize("chunk_bytes", [64, 1 << 20])
def test_artifact_collection_and_delivery_match_jax(chunk_bytes, tmp_path):
    rng = np.random.default_rng(chunk_bytes)
    payload = rng.integers(0, 256, 500, dtype=np.uint8).tobytes()
    results = {}
    for name, obs in OBS.items():
        staging = tmp_path / name / "staging" / "run-1"
        (staging / "sub").mkdir(parents=True)
        (staging / "trace-1.ndjson").write_bytes(payload)
        (staging / "sub" / "small.txt").write_text("hello")
        out = tmp_path / name / "out"
        collected = obs.artifacts.ArtifactCollector(str(out), node_tag="0", chunk_bytes=chunk_bytes).collect(
            (str(staging),))
        delivery = obs.artifacts.finalize_delivery(str(out), expected_nodes=["0", "1"])
        manifest = json.loads((out / "profile" / "collected" / "node0" / "_manifest.json").read_text())
        index = json.loads((out / "profile" / "collected" / "index.json").read_text())
        results[name] = (vars(collected), vars(delivery), manifest, index)
        assert (out / "profile" / "collected" / "node0" / "run-1" / "trace-1.ndjson").read_bytes() == payload
        assert not (staging / "trace-1.ndjson").exists()  # cleaned up after collection
    assert results["torch"] == results["jax"]
    _, delivery, manifest, _ = results["torch"]
    assert delivery["missing_nodes"] == ["1"] and delivery["files"] == 2
    assert manifest["files"]["run-1/trace-1.ndjson"]["chunks"] == (8 if chunk_bytes == 64 else 0)
