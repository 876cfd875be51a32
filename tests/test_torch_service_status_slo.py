"""Port parity: the live-ops endpoints and per-tenant SLOs (``service/app.py``
+ ``service/slo.py``), the scenarios of ``tests/service/test_status_slo.py``
through both packages.

``/health``'s readiness, ``/v1/jobs/<id>/status`` serving a real pipelined
job child's live snapshot, ``/v1/slo`` with tenants breaching their
targets (the breach journaled and counted in
``service_slo_breaches_total``) and the dispatcher's anomaly relay give the
same answers in both services; ``SloTracker`` gives the same verdicts and
report on the same observations. Where the reference waits for a job to be
slow enough, these tests hold the job on a gate file and poll against a
deadline, so the verdicts do not depend on the host's load.
"""

from __future__ import annotations

import json
import sys

from tests.fixtures.service_harness import (
    PACKAGES,
    Service,
    config,
    gated_job,
    masked,
    package,
    series_delta,
    service_series,
    sleep_job,
)

PKGS = [package(name) for name in PACKAGES]
JAX, PORT = PKGS


def both(tmp_path, scenario, metrics=True):
    outs = []
    for pkg in PKGS:
        root = tmp_path / pkg.name
        root.mkdir()
        before = service_series(pkg)
        out = {"out": scenario(pkg, root)}
        if metrics:
            out["metrics"] = series_delta(before, service_series(pkg))
        outs.append(masked(out, root))
    assert outs[1] == outs[0]
    return outs[1]["out"]


def _cfg(pkg, slo=None, **kw):
    return config(pkg, slo=slo, anomaly_scan_interval_s=0.1, **kw)


class TestHealthReadiness:
    def test_ready_payload(self, tmp_path):
        def scenario(pkg, root):
            svc = Service(pkg, root / "svc", config=_cfg(pkg))
            try:
                svc.wait(lambda: svc.state.dispatcher_running, msg="dispatcher up")
                return svc.req("GET", "/health")[:2]
            finally:
                svc.close()

        status, doc = both(tmp_path, scenario)
        assert status == 200 and doc["ready"] is True and doc["dispatcher_running"] is True
        assert doc["journal_writable"] is True and set(doc["queued"]) == {"interactive", "batch"}
        assert doc["running_jobs"] == [] and doc["slo_enabled"] is False

    def test_journal_failure_flips_ready(self, tmp_path):
        def scenario(pkg, root):
            svc = Service(pkg, root / "svc", config=_cfg(pkg))
            try:
                svc.wait(lambda: svc.state.dispatcher_running, msg="dispatcher up")
                svc.state.journal_ok = False
                return svc.req("GET", "/health")[1]
            finally:
                svc.close()

        doc = both(tmp_path, scenario)
        assert doc["ready"] is False and doc["journal_writable"] is False


_LIVE_JOB = """
import json, os, sys, time
pkg, out, summary, gate, runner_kw = sys.argv[1:6]
os.environ["CURATE_LIVE_STATUS_INTERVAL_S"] = "0.05"
import importlib
importlib.import_module(pkg + ".observability.live_status").export_live_status_dir(out)
pipeline = importlib.import_module(pkg + ".core.pipeline")
stage_mod = importlib.import_module(pkg + ".core.stage")
tasks = importlib.import_module(pkg + ".core.tasks")
PipelinedRunner = importlib.import_module(pkg + ".core.pipelined_runner").PipelinedRunner

class SlowA(stage_mod.Stage):
    thread_safe = True
    def process_data(self, batch):
        time.sleep(0.02)
        return batch

class SlowB(SlowA):
    def process_data(self, batch):
        deadline = time.monotonic() + 60
        while not os.path.exists(gate) and time.monotonic() < deadline:
            time.sleep(0.01)
        return batch

PipelinedRunner(**json.loads(runner_kw)).run(pipeline.PipelineSpec(
    input_data=[tasks.PipelineTask() for _ in range(30)],
    stages=[stage_mod.StageSpec(SlowA()), stage_mod.StageSpec(SlowB())],
    config=pipeline.PipelineConfig(num_cpus=2.0),
))
json.dump({"ok": True}, open(summary, "w"))
"""


def live_job(pkg, output_dir, gate):
    """A real pipeline job: PipelinedRunner over two stages with live status
    exported to the job's output root, as run_split wires it; the second
    stage holds every batch until ``gate`` exists."""
    runner_kw = json.dumps({"poll_interval_s": 0.01} if pkg is JAX else {})

    def cmd(rec, work_dir):
        return [sys.executable, "-c", _LIVE_JOB, pkg.name, str(output_dir), str(work_dir / "summary.json"),
                str(gate), runner_kw]

    return cmd


class TestJobStatusEndpoint:
    def test_unknown_job_404(self, tmp_path):
        def scenario(pkg, root):
            svc = Service(pkg, root / "svc", config=_cfg(pkg))
            try:
                return svc.req("GET", "/v1/jobs/nope/status")[:2]
            finally:
                svc.close()

        assert both(tmp_path, scenario)[0] == 404

    def test_no_snapshot_yet(self, tmp_path):
        def scenario(pkg, root):
            gate = root / "gate"
            svc = Service(pkg, root / "svc", config=_cfg(pkg), runner_cmd=gated_job(gate))
            try:
                job_id = svc.submit(args={"output_path": str(root / "out")})
                svc.wait_state(job_id, "running")
                answer = svc.req("GET", f"/v1/jobs/{job_id}/status")[:2]
                gate.touch()
                svc.wait_state(job_id, "done")
                return answer
            finally:
                svc.close()

        status, doc = both(tmp_path, scenario)
        assert status == 200 and doc["live"] is False and "detail" in doc

    def test_live_snapshot_served_mid_run(self, tmp_path):
        """While a real pipelined job runs (held at its second stage),
        ``/v1/jobs/<id>/status`` serves a well-formed snapshot with nonzero
        per-stage data; after the run, the terminal snapshot."""

        def scenario(pkg, root):
            out, gate = root / "out", root / "gate"
            svc = Service(pkg, root / "svc", config=_cfg(pkg), runner_cmd=live_job(pkg, out, gate))
            try:
                job_id = svc.submit(args={"output_path": str(out)})
                svc.wait_state(job_id, "running")

                def accept(status, doc):
                    if status != 200 or not doc.get("live"):
                        return False
                    snap = doc["snapshot"]
                    stages = snap.get("stages") or {}
                    return snap.get("state") == "running" and len(stages) == 2 and any(
                        s.get("queue_depth", 0) > 0 or s.get("inflight") or s.get("busy_frac", 0) > 0
                        for s in stages.values())

                _, seen = svc.wait_http("GET", f"/v1/jobs/{job_id}/status", accept,
                                        msg="live snapshot with per-stage data")
                assert seen["snapshot_age_s"] < 10.0 and seen["stale"] is False
                gate.touch()
                svc.wait_state(job_id, "done", timeout=60.0)
                _, doc, _ = svc.req("GET", f"/v1/jobs/{job_id}/status")
                return {"live": seen["live"], "stale": seen["stale"], "stages": sorted(seen["snapshot"]["stages"]),
                        "final_state": doc["snapshot"]["state"], "keys": sorted(doc)}
            finally:
                svc.close()

        out = both(tmp_path, scenario, metrics=False)
        assert out["stages"] == ["SlowA", "SlowB"] and out["final_state"] == "finished"


class TestSloEndpoint:
    def test_queue_wait_breach_counts_and_reports(self, tmp_path):
        """max_concurrent=1 and another tenant's job ahead, held on its gate
        for 50 ms: the waiting tenant's job waits past the 5 ms target and
        breaches once; /v1/slo reports it, the journal and the metric
        record it. (The job ahead waits only for its dispatch, which may or
        may not pass 5 ms: its tenant is not compared.)"""

        def scenario(pkg, root):
            gate = root / "gate"
            cfg = _cfg(pkg, slo=pkg.slo.SloConfig(queue_wait_s=0.005), max_concurrent_jobs=1)
            svc = Service(pkg, root / "svc", config=cfg, runner_cmd=gated_job(gate))
            try:
                first = svc.submit(tenant="head")
                svc.wait_state(first, "running")
                before = svc.state.metrics.slo_breaches.labels("slow-co", "queue_wait")._value.get()
                second = svc.submit(tenant="slow-co")
                svc.sleep(0.05)  # the second job's wait is at least this
                gate.touch()
                svc.wait_state(first, "done")
                svc.wait_state(second, "done")
                status, doc, _ = svc.req("GET", "/v1/slo")
                breach_lines = [line for line in (root / "svc" / "journal.ndjson").read_text().splitlines()
                                if "slo-breach:queue_wait" in line and second in line]
                breaches = svc.state.metrics.slo_breaches.labels("slow-co", "queue_wait")._value.get() - before
                return status, doc["enabled"], doc["targets"], doc["tenants"]["slow-co"], len(breach_lines), breaches
            finally:
                svc.close()

        status, enabled, targets, tenant, journaled, breaches = both(tmp_path, scenario, metrics=False)
        assert status == 200 and enabled is True and targets["queue_wait_s"] == 0.005
        assert tenant["queue_wait"]["breaches"] == tenant["breaches_total"] == journaled == breaches == 1

    def test_run_duration_and_success_rate_breaches(self, tmp_path):
        def scenario(pkg, root):
            cfg = _cfg(pkg, slo=pkg.slo.SloConfig(run_duration_s=0.01, success_rate=0.9, window=10))
            svc = Service(pkg, root / "svc", config=cfg, runner_cmd=sleep_job(0.05))
            try:
                ok = svc.submit(tenant="acme")
                svc.wait_state(ok, "done")
                first = svc.req("GET", "/v1/slo")[1]["tenants"]["acme"]
                svc.state.runner_cmd = sleep_job(0.01, rc=3)
                for _ in range(5):
                    jid = svc.submit(tenant="acme", max_attempts=1)
                    svc.wait_state(jid, "dead_lettered")
                return first, svc.req("GET", "/v1/slo")[1]["tenants"]["acme"]
            finally:
                svc.close()

        first, after = both(tmp_path, scenario)
        assert first["run_duration"]["breaches"] == 1 and first["success_rate"]["breaches"] == 0
        assert after["success_rate"]["breaches"] >= 1 and after["success_rate"]["rate"] < 0.9

    def test_slo_disabled_never_breaches(self, tmp_path):
        def scenario(pkg, root):
            svc = Service(pkg, root / "svc", config=_cfg(pkg), runner_cmd=sleep_job(0.01))
            try:
                jid = svc.submit(tenant="t")
                svc.wait_state(jid, "done")
                return svc.req("GET", "/v1/slo")[1]
            finally:
                svc.close()

        doc = both(tmp_path, scenario)
        assert doc["enabled"] is False and doc["tenants"]["t"]["breaches_total"] == 0
        assert doc["occupancy"]["t"] == {"queued": 0, "running": 0}


class TestAnomalyRelay:
    def test_dispatcher_journals_child_anomalies(self, tmp_path):
        """A running job whose snapshot carries anomaly verdicts: the
        dispatcher relays them into the journal and the service metrics."""

        def anomaly_job(live, gate):
            def cmd(rec, work_dir):
                code = (
                    "import json, os, sys, time\n"
                    "live, gate = sys.argv[1], sys.argv[3]\n"
                    "os.makedirs(live, exist_ok=True)\n"
                    "snap = {'ts': time.time(), 'seq': 1, 'state': 'running',\n"
                    "        'stages': {}, 'anomaly_count': 2, 'anomalies': [\n"
                    "    {'ts': time.time(), 'kind': 'stuck_batch', 'stage': 'S',\n"
                    "     'detail': 'batch 0 in flight 99s'},\n"
                    "    {'ts': time.time(), 'kind': 'starved_stage', 'stage': 'T',\n"
                    "     'detail': 'idle behind full upstream'},\n"
                    "]}\n"
                    "tmp = os.path.join(live, '.status.json.tmp')\n"
                    "open(tmp, 'w').write(json.dumps(snap))\n"
                    "os.replace(tmp, os.path.join(live, 'status.json'))\n"
                    "deadline = time.monotonic() + 60\n"
                    "while not os.path.exists(gate) and time.monotonic() < deadline:\n"
                    "    time.sleep(0.01)\n"
                    "json.dump({'ok': True}, open(sys.argv[2], 'w'))\n"
                )
                return [sys.executable, "-c", code, str(live), str(work_dir / "summary.json"), str(gate)]

            return cmd

        def scenario(pkg, root):
            out, gate = root / "out", root / "gate"
            svc = Service(pkg, root / "svc", config=_cfg(pkg), runner_cmd=anomaly_job(out / "report" / "live", gate))
            try:
                job_id = svc.submit(args={"output_path": str(out)})
                svc.wait(lambda: svc.state._anomaly_seen.get(job_id, 0) >= 2, msg="anomaly relay")
                gate.touch()
                svc.wait_state(job_id, "done")
                svc.wait(lambda: job_id not in svc.state._anomaly_seen, msg="relay state pruned")
                doc = svc.req("GET", f"/v1/jobs/{job_id}/status")[1]
                events = [e for e, _ in svc.journal_events() if e.startswith("anomaly:")]
                return sorted(events), doc["anomaly_count"], sorted(e["kind"] for e in doc["anomalies"])
            finally:
                svc.close()

        events, count, kinds = both(tmp_path, scenario)
        assert events == ["anomaly:starved_stage", "anomaly:stuck_batch"]
        assert count == 2 and kinds == ["starved_stage", "stuck_batch"]


class TestSloTrackerUnits:
    """Injected observations (the tracker has no clock of its own): both
    packages' trackers give the same verdicts and the same report."""

    @staticmethod
    def both(make, steps):
        outs = []
        for pkg in PKGS:
            tr = pkg.slo.SloTracker(make(pkg))
            verdicts = [getattr(tr, fn)(*args) for fn, args in steps]
            outs.append((verdicts, tr.report()))
        assert outs[1] == outs[0]
        return outs[1]

    def test_queue_wait_breach(self):
        verdicts, rep = self.both(lambda pkg: pkg.slo.SloConfig(queue_wait_s=1.0),
                                  [("observe_dispatch", ("t", 0.5)), ("observe_dispatch", ("t", 2.0))])
        assert verdicts == [[], ["queue_wait"]]
        assert rep["tenants"]["t"]["queue_wait"]["breaches"] == 1 and rep["tenants"]["t"]["queue_wait"]["max_s"] == 2.0

    def test_duration_judged_on_success_only(self):
        verdicts, _ = self.both(lambda pkg: pkg.slo.SloConfig(run_duration_s=1.0),
                                [("observe_terminal", ("t", "done", 5.0)),
                                 ("observe_terminal", ("t", "dead_lettered", 9.0)),
                                 ("observe_terminal", ("t", "terminated", 9.0))])
        assert verdicts == [["run_duration"], [], []]

    def test_success_rate_needs_min_window(self):
        verdicts, rep = self.both(lambda pkg: pkg.slo.SloConfig(success_rate=0.9),
                                  [("observe_terminal", ("t", "failed", 0.1))] * 5)
        assert verdicts == [[], [], [], [], ["success_rate"]]
        assert rep["tenants"]["t"]["success_rate"]["rate"] == 0.0 and rep["tenants"]["t"]["success_rate"]["window"] == 5

    def test_terminated_excluded_from_success_window(self):
        _, rep = self.both(lambda pkg: pkg.slo.SloConfig(success_rate=0.5),
                           [("observe_terminal", ("t", "terminated", None))] * 10)
        assert rep["tenants"]["t"]["success_rate"]["window"] == 0
        assert rep["tenants"]["t"]["success_rate"]["breaches"] == 0

    def test_disabled_config_never_breaches(self):
        verdicts, rep = self.both(lambda pkg: pkg.slo.SloConfig(),
                                  [("observe_dispatch", ("t", 999.0)), ("observe_terminal", ("t", "failed", 999.0))])
        assert verdicts == [[], []] and rep["enabled"] is False
