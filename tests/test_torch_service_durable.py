"""Port parity: the durable service (crash-resume, shedding, lanes, retries,
terminate, drain, the job environment), the scenarios of
``tests/service/test_durable_service.py`` through both packages' apps.

Every scenario runs against the JAX package's service and then the port's,
with the reference's fake job commands (the ``runner_cmd`` hook), and
must give the same HTTP statuses and bodies (ids, times and the work root
masked), the same journal (event, state) sequences and the same
``service_*`` metric increments; the reference's own assertions hold on
the port. Jobs that must outlive a check wait on a gate file the test
creates, so no scenario depends on a sleep being long enough.
"""

from __future__ import annotations

import asyncio
import json
import os
import signal
import sys

import pytest

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
TERMINAL = ("done", "failed", "dead_lettered", "terminated")


@pytest.fixture(autouse=True)
def _no_chaos():
    yield
    for pkg in PKGS:
        pkg.chaos.uninstall()
    os.environ.pop("CURATE_CHAOS", None)


def both(tmp_path, scenario) -> object:
    """``scenario(pkg, root)`` for each package (``root`` its own tmp dir);
    the masked transcripts, with the metric increments the scenario made,
    must agree. Returns the port's."""
    outs = []
    for pkg in PKGS:
        root = tmp_path / pkg.name
        root.mkdir()
        before = service_series(pkg)
        out = scenario(pkg, root)
        outs.append(masked({"out": out, "metrics": series_delta(before, service_series(pkg))}, root))
    assert outs[1]["out"] == outs[0]["out"]
    assert outs[1]["metrics"] == outs[0]["metrics"]
    return outs[1]["out"]


_RESUME_JOB = """
import json, sys, time
from pathlib import Path
pkg, inp, out, summary, per_item_s = sys.argv[1], sys.argv[2], sys.argv[3], sys.argv[4], float(sys.argv[5])
import importlib
_processed_video_ids = importlib.import_module(pkg + ".pipelines.video.input_discovery")._processed_video_ids
video_record_id = importlib.import_module(pkg + ".pipelines.video.stages.writer").video_record_id
Path(out).mkdir(parents=True, exist_ok=True)
done = _processed_video_ids(out)
files = sorted(str(p) for p in Path(inp).glob("*.mp4"))
for f in files:
    vid = video_record_id(f)
    if vid in done:
        continue
    time.sleep(per_item_s)
    with open(Path(out) / "processed_log.txt", "a") as fh:
        fh.write(vid + "\\n")
    rec_dir = Path(out) / "processed_videos" / vid
    rec_dir.mkdir(parents=True, exist_ok=True)
    (rec_dir / "chunk-0.json").write_text(json.dumps({"num_chunks": 1}))
json.dump({"num_videos": len(files)}, open(summary, "w"))
"""


def resume_job(pkg, input_dir, output_dir, per_item_s):
    """Processes input videos one at a time through the package's REAL
    resume-record format (input discovery's own helper), as run_split does."""

    def cmd(rec, work_dir):
        return [sys.executable, "-c", _RESUME_JOB, pkg.name, str(input_dir), str(output_dir),
                str(work_dir / "summary.json"), str(per_item_s)]

    return cmd


class TestCrashResume:
    def test_kill9_replay_resume_no_duplicates(self, tmp_path):
        n_videos = 6

        def scenario(pkg, root):
            inp, out = root / "in", root / "out"
            inp.mkdir()
            for i in range(n_videos):
                (inp / f"v{i}.mp4").write_bytes(b"\x00")
            runner = resume_job(pkg, inp, out, per_item_s=0.25)
            svc = Service(pkg, root / "svc", config=config(pkg), runner_cmd=runner)
            job_id = svc.submit(args={"input_path": str(inp), "output_path": str(out)})
            svc.wait(lambda: (out / "processed_videos").exists()
                     and len(list((out / "processed_videos").iterdir())) >= 2, msg="partial progress")
            rec = svc.state.jobs[job_id]
            assert rec.state == "running" and rec.pid
            pre_crash = len(list((out / "processed_videos").iterdir()))
            assert pre_crash < n_videos, "job finished before the crash; slow it down"
            os.killpg(rec.pid, signal.SIGKILL)
            svc.close_abruptly()
            before_restart = svc.journal_events()

            svc2 = Service(pkg, root / "svc", config=config(pkg), runner_cmd=runner)
            assert svc2.state.jobs[job_id].state in ("pending", "running")
            svc2.wait_state(job_id, "done")
            log = (out / "processed_log.txt").read_text().splitlines()
            assert len(log) == n_videos and len(set(log)) == n_videos, "every video processed exactly once"
            assert len(log) - pre_crash < n_videos
            _, doc, _ = svc2.req("GET", f"/v1/progress/{job_id}")
            svc2.close()
            return {"before_restart": before_restart, "after": svc2.journal_events(), "progress": doc}

        out = both(tmp_path, scenario)
        assert out["before_restart"] == [("submit", "pending"), ("running", "running")]
        assert out["after"] == [("compact", "pending"), ("running", "running"), ("done", "done")]
        assert out["progress"]["summary"] == {"num_videos": n_videos} and out["progress"]["attempts"] == 2

    def test_queued_job_survives_restart(self, tmp_path):
        def scenario(pkg, root):
            cfg = config(pkg, max_concurrent_jobs=1)
            svc = Service(pkg, root / "svc", config=cfg, runner_cmd=gated_job(root / "never"))
            running = svc.submit()
            svc.wait_state(running, "running")
            queued = svc.submit()
            assert svc.state.jobs[queued].state == "pending"
            os.killpg(svc.state.jobs[running].pid, signal.SIGKILL)
            svc.close_abruptly()
            svc2 = Service(pkg, root / "svc", config=cfg, runner_cmd=sleep_job(0.01))
            svc2.wait_state(running, "done")
            svc2.wait_state(queued, "done")
            states = sorted(r.state for r in svc2.state.jobs.values())
            svc2.close()
            return states

        assert both(tmp_path, scenario) == ["done", "done"]


class TestAdmission:
    def test_over_quota_sheds_429_with_retry_after(self, tmp_path):
        def scenario(pkg, root):
            svc = Service(pkg, root / "svc", config=config(pkg, max_concurrent_jobs=1, max_queued_per_tenant=2),
                          runner_cmd=gated_job(root / "never"))
            running = svc.submit(tenant="acme")
            svc.wait_state(running, "running")
            svc.submit(tenant="acme")
            svc.submit(tenant="acme")
            status, doc, headers = svc.req("POST", "/v1/invoke",
                                           json={"pipeline": "split", "args": {}, "tenant": "acme"})
            assert float(headers["Retry-After"]) >= 1
            status2, _, _ = svc.req("POST", "/v1/invoke", json={"pipeline": "split", "args": {}, "tenant": "zen"})
            svc.req("POST", f"/v1/terminate/{running}")
            svc.wait(lambda: running not in svc.state.procs, msg="terminated job reaped")
            svc.close()
            return status, doc, headers["Retry-After"], status2

        status, doc, retry_after, status2 = both(tmp_path, scenario)
        assert status == 429 and doc["reason"] == "tenant_queue_full" and status2 == 200

    def test_global_queue_cap_sheds(self, tmp_path):
        def scenario(pkg, root):
            svc = Service(pkg, root / "svc", config=config(pkg, max_concurrent_jobs=1, max_queued_per_tenant=50,
                                                           max_queued_total=2),
                          runner_cmd=gated_job(root / "never"))
            running = svc.submit(tenant="a")
            svc.wait_state(running, "running")
            svc.submit(tenant="b")
            svc.submit(tenant="c")
            status, doc, _ = svc.req("POST", "/v1/invoke", json={"pipeline": "split", "args": {}, "tenant": "d"})
            svc.req("POST", f"/v1/terminate/{running}")
            svc.wait(lambda: running not in svc.state.procs, msg="terminated job reaped")
            svc.close()
            return status, doc

        status, doc = both(tmp_path, scenario)
        assert status == 429 and doc["reason"] == "queue_full"

    def test_interactive_lane_dispatches_before_batch(self, tmp_path):
        def scenario(pkg, root):
            gate = root / "gate"
            svc = Service(pkg, root / "svc", config=config(pkg, max_concurrent_jobs=1), runner_cmd=gated_job(gate))
            first = svc.submit(priority="batch")
            svc.wait_state(first, "running")
            b = svc.submit(priority="batch")
            i = svc.submit(priority="interactive")
            gate.touch()
            for job in (first, b, i):
                svc.wait_state(job, "done")
            order = sorted((svc.state.jobs[j].started_s, svc.state.jobs[j].priority) for j in (b, i))
            svc.close()
            return [lane for _, lane in order]

        assert both(tmp_path, scenario) == ["interactive", "batch"]

    def test_two_tenants_complete_concurrently(self, tmp_path):
        def scenario(pkg, root):
            gate = root / "gate"
            svc = Service(pkg, root / "svc", config=config(pkg, max_concurrent_jobs=2, max_running_per_tenant=1),
                          runner_cmd=gated_job(gate))
            a, b = svc.submit(tenant="a"), svc.submit(tenant="b")
            svc.wait(lambda: svc.state.jobs[a].state == "running" and svc.state.jobs[b].state == "running",
                     msg="both tenants running at once")
            gate.touch()
            svc.wait_state(a, "done")
            svc.wait_state(b, "done")
            svc.close()
            # each tenant's job's transitions in order; how the two jobs'
            # lines interleave follows the dispatcher's timing against the
            # second submission, in either package
            events: dict[str, list] = {}
            for line in (svc.work_root / "journal.ndjson").read_text().splitlines():
                doc = json.loads(line)
                tenant = {a: "a", b: "b"}[doc["record"]["job_id"]]
                events.setdefault(tenant, []).append((doc["event"], doc["record"]["state"]))
            return events

        events = both(tmp_path, scenario)
        assert events == {t: [("submit", "pending"), ("running", "running"), ("done", "done")] for t in "ab"}


class TestRetryAndDeadLetter:
    def test_failure_retries_then_succeeds(self, tmp_path):
        def scenario(pkg, root):
            calls = {"n": 0}

            def flaky(rec, work_dir):
                marker = work_dir / "tried"
                code = ("import json, sys, pathlib\n"
                        "m = pathlib.Path(sys.argv[2])\n"
                        "if not m.exists():\n"
                        "    m.write_text('1'); sys.exit(3)\n"
                        "json.dump({}, open(sys.argv[1], 'w'))\n")
                calls["n"] += 1
                return [sys.executable, "-c", code, str(work_dir / "summary.json"), str(marker)]

            svc = Service(pkg, root / "svc", config=config(pkg), runner_cmd=flaky)
            job_id = svc.submit()
            svc.wait_state(job_id, "done")
            attempts = svc.state.jobs[job_id].attempts
            svc.close()
            return attempts, calls["n"], svc.journal_events()

        attempts, calls, events = both(tmp_path, scenario)
        assert attempts == calls == 2
        assert events == [("submit", "pending"), ("running", "running"), ("retry", "pending"),
                          ("running", "running"), ("done", "done")]

    def test_attempts_exhausted_dead_letters_then_requeue(self, tmp_path):
        def scenario(pkg, root):
            svc = Service(pkg, root / "svc", config=config(pkg), runner_cmd=sleep_job(0.01, rc=5))
            job_id = svc.submit(max_attempts=2)
            svc.wait_state(job_id, "dead_lettered")
            rec = svc.state.jobs[job_id]
            assert rec.attempts == 2 and "exit code 5" in rec.error
            listed = svc.req("GET", "/v1/jobs?state=dead_lettered")[:2]
            svc.state.runner_cmd = sleep_job(0.01)
            requeued = svc.req("POST", f"/v1/requeue/{job_id}")[:2]
            svc.wait_state(job_id, "done")
            svc.close()
            return listed, requeued, svc.journal_events()

        listed, requeued, events = both(tmp_path, scenario)
        assert [j["state"] for j in listed[1]["jobs"]] == ["dead_lettered"] and requeued[0] == 200
        assert events[-3:] == [("requeued", "pending"), ("running", "running"), ("done", "done")]

    def test_job_crash_chaos_site_first_attempt_only(self, tmp_path):
        def scenario(pkg, root):
            chaos = pkg.chaos
            chaos.install(chaos.FaultPlan(rules=(chaos.FaultRule(site=chaos.SITE_SERVICE_JOB_CRASH, kind="crash",
                                                                 worker_re="-a1$"),)), export_env=True)

            def chaos_job(rec, work_dir):
                code = ("import json, sys\n"
                        f"from {pkg.name} import chaos\n"
                        "chaos.install_from_env()\n"
                        "chaos.fire('service.job.crash')\n"
                        "json.dump({}, open(sys.argv[1], 'w'))\n")
                return [sys.executable, "-c", code, str(work_dir / "summary.json")]

            try:
                svc = Service(pkg, root / "svc", config=config(pkg), runner_cmd=chaos_job)
                job_id = svc.submit()
                svc.wait_state(job_id, "done")
                attempts = svc.state.jobs[job_id].attempts
                svc.close()
            finally:
                chaos.uninstall()
                os.environ.pop("CURATE_CHAOS", None)
            return attempts

        assert both(tmp_path, scenario) == 2

    def test_journal_outage_refuses_submission(self, tmp_path):
        def scenario(pkg, root):
            svc = Service(pkg, root / "svc", config=config(pkg), runner_cmd=sleep_job(0.01))
            chaos = pkg.chaos
            chaos.install(chaos.FaultPlan(rules=(chaos.FaultRule(site=chaos.SITE_SERVICE_JOURNAL_WRITE,
                                                                 kind="error"),)))
            try:
                status, doc, _ = svc.req("POST", "/v1/invoke", json={"pipeline": "split", "args": {}})
            finally:
                chaos.uninstall()
            queued, jobs = svc.state.admission.queued_total(), dict(svc.state.jobs)
            svc.close()
            return status, doc, queued, jobs

        status, doc, queued, jobs = both(tmp_path, scenario)
        assert status == 503 and "journal" in doc["error"] and queued == 0 and not jobs


def _alive(pid: int) -> bool:
    """A process that exists and is not a zombie."""
    try:
        stat = open(f"/proc/{pid}/stat").read()
    except OSError:
        return False
    return stat.rsplit(")", 1)[1].split()[0] != "Z"


class TestTransitionRecord:
    def test_journal_thread_records_the_state_at_the_transition(self, tmp_path):
        """A transition handed to the journal thread is journaled and counted
        with the record's state at the transition, even when the loop moves
        the record on before that thread gets to it (a terminate right
        after a dispatch). The port copies the record at the hand-over; the
        reference hands the live record over and counts its later state."""
        import threading

        from cosmos_curate_tpu_torch.service.job_queue import JobRecord

        svc = Service(PORT, tmp_path / "svc", config=config(PORT), runner_cmd=sleep_job(0.01))
        rec = JobRecord(job_id="j-1", pipeline="split", args={}, state="running")
        gate = threading.Event()
        svc.state._journal_exec.submit(gate.wait, 10)  # the journal thread busy
        before = service_series(PORT)
        task = svc.loop.create_task(svc.state.record_transition_async(rec, "running"))
        svc.loop.run_until_complete(asyncio.sleep(0.05))  # handed over, not yet written
        rec.state = "terminated"
        gate.set()
        svc.loop.run_until_complete(task)
        delta = series_delta(before, service_series(PORT))
        events = svc.journal_events()
        svc.close()
        assert events[-1] == ("running", "running")
        assert delta[("service_jobs_total", (("state", "running"), ("tenant", "default")))] == 1.0
        assert ("service_jobs_total", (("state", "terminated"), ("tenant", "default"))) not in delta


class TestTerminate:
    def test_terminate_kills_whole_process_group(self, tmp_path):
        def scenario(pkg, root):
            def forking_job(rec, work_dir):
                return ["/bin/sh", "-c", f"sleep 300 & echo $! > '{work_dir}/grandchild.pid'; wait"]

            svc = Service(pkg, root / "svc", config=config(pkg, term_grace_s=1.0), runner_cmd=forking_job)
            job_id = svc.submit()
            pid_file = svc.state.work_dir(job_id) / "grandchild.pid"
            svc.wait(lambda: pid_file.exists() and pid_file.read_text().strip(), msg="grandchild spawned")
            grandchild = int(pid_file.read_text())
            # the running transition journaled and counted first: the
            # reference's journal thread reads the record's state when it
            # gets to it, so a terminate that lands before then makes it
            # count the running transition as terminated (the port's copies
            # the record at the transition)
            svc.wait_state(job_id, "running")
            _, doc, _ = svc.req("POST", f"/v1/terminate/{job_id}")
            svc.wait(lambda: not _alive(grandchild), timeout=10, msg="grandchild reaped")
            svc.wait(lambda: job_id not in svc.state.procs, msg="job reaped")
            svc.close()
            return doc, svc.journal_events()

        doc, events = both(tmp_path, scenario)
        assert doc["state"] == "terminated" and events[-1] == ("terminated", "terminated")

    def test_sigterm_immune_job_escalates_to_sigkill(self, tmp_path):
        def scenario(pkg, root):
            def stubborn_job(rec, work_dir):
                return ["/bin/sh", "-c", "trap '' TERM; while true; do sleep 0.1; done"]

            svc = Service(pkg, root / "svc", config=config(pkg, term_grace_s=0.3), runner_cmd=stubborn_job)
            job_id = svc.submit()
            svc.wait_state(job_id, "running")
            pid = svc.state.jobs[job_id].pid
            svc.req("POST", f"/v1/terminate/{job_id}")
            svc.wait(lambda: job_id not in svc.state.procs, timeout=10, msg="group killed")
            state = svc.state.jobs[job_id].state
            svc.wait(lambda: not _alive(pid), timeout=10, msg="process group reaped")
            svc.close()
            return state

        assert both(tmp_path, scenario) == "terminated"

    def test_terminate_during_retry_backoff_is_honored(self, tmp_path, monkeypatch):
        def scenario(pkg, root):
            # a pinned backoff: the terminate lands inside a known window
            monkeypatch.setattr(f"{pkg.name}.service.app.backoff_s", lambda *a, **kw: 3.0)
            svc = Service(pkg, root / "svc", config=config(pkg), runner_cmd=sleep_job(0.01, rc=7))
            job_id = svc.submit(max_attempts=3)
            svc.wait(lambda: svc.state.jobs[job_id].attempts == 1 and job_id not in svc.state.procs
                     and svc.state.jobs[job_id].state == "pending", msg="first attempt failed (backoff sleeping)")
            _, doc, _ = svc.req("POST", f"/v1/terminate/{job_id}")
            # outlive the backoff: the job must stay terminated with no attempt 2
            svc.wait(lambda: not svc.state.watchers, timeout=10, msg="the watcher's backoff ended")
            rec = svc.state.jobs[job_id]
            svc.close()
            return doc, rec.state, rec.attempts

        doc, state, attempts = both(tmp_path, scenario)
        assert doc["state"] == state == "terminated" and attempts == 1

    def test_requeue_refused_while_process_still_exiting(self, tmp_path):
        def scenario(pkg, root):
            def stubborn_job(rec, work_dir):
                return ["/bin/sh", "-c", "trap '' TERM; while true; do sleep 0.1; done"]

            svc = Service(pkg, root / "svc", config=config(pkg, term_grace_s=1.5), runner_cmd=stubborn_job)
            job_id = svc.submit()
            svc.wait_state(job_id, "running")
            svc.req("POST", f"/v1/terminate/{job_id}")
            assert job_id in svc.state.procs  # SIGTERM ignored; escalation pending
            refused = svc.req("POST", f"/v1/requeue/{job_id}")[:2]
            svc.wait(lambda: job_id not in svc.state.procs, timeout=15, msg="SIGKILL landed")
            accepted = svc.req("POST", f"/v1/requeue/{job_id}")[:2]
            svc.wait_state(job_id, "running")
            svc.req("POST", f"/v1/terminate/{job_id}")
            svc.wait(lambda: job_id not in svc.state.procs, timeout=15, msg="cleanup kill")
            svc.close()
            return refused, accepted

        refused, accepted = both(tmp_path, scenario)
        assert refused[0] == 409 and "still exiting" in refused[1]["error"] and accepted[0] == 200

    def test_terminate_queued_job(self, tmp_path):
        def scenario(pkg, root):
            svc = Service(pkg, root / "svc", config=config(pkg, max_concurrent_jobs=1),
                          runner_cmd=gated_job(root / "never"))
            running = svc.submit()
            svc.wait_state(running, "running")
            queued = svc.submit()
            _, doc, _ = svc.req("POST", f"/v1/terminate/{queued}")
            queued_total = svc.state.admission.queued_total()
            svc.req("POST", f"/v1/terminate/{running}")
            svc.wait(lambda: running not in svc.state.procs, msg="terminated job reaped")
            svc.close()
            return doc, queued_total

        doc, queued_total = both(tmp_path, scenario)
        assert doc["state"] == "terminated" and queued_total == 0


class TestDrain:
    def test_drain_finishes_running_checkpoints_queued(self, tmp_path):
        def scenario(pkg, root):
            gate = root / "gate"
            svc = Service(pkg, root / "svc", config=config(pkg, max_concurrent_jobs=1), runner_cmd=gated_job(gate))
            running = svc.submit()
            svc.wait_state(running, "running")
            queued = svc.submit()
            svc.loop.call_later(0.2, gate.touch)
            svc.loop.run_until_complete(pkg.app.drain_app(svc.app, drain_s=20))
            states = svc.state.jobs[running].state, svc.state.jobs[queued].state
            refused = svc.req("POST", "/v1/invoke", json={"pipeline": "split", "args": {}})[:2]
            svc.close()
            svc2 = Service(pkg, root / "svc", config=config(pkg), runner_cmd=sleep_job(0.01))
            svc2.wait_state(queued, "done")
            svc2.close()
            return states, refused

        states, refused = both(tmp_path, scenario)
        assert states == ("done", "pending") and refused[0] == 503

    def test_drain_deadline_checkpoints_running_as_interrupted(self, tmp_path):
        def scenario(pkg, root):
            svc = Service(pkg, root / "svc", config=config(pkg), runner_cmd=gated_job(root / "never"))
            job_id = svc.submit()
            svc.wait_state(job_id, "running")
            svc.loop.run_until_complete(pkg.app.drain_app(svc.app, drain_s=0.2))
            state, procs = svc.state.jobs[job_id].state, dict(svc.state.procs)
            svc.close()
            svc2 = Service(pkg, root / "svc", config=config(pkg), runner_cmd=sleep_job(0.01))
            svc2.wait_state(job_id, "done")
            final = sorted(r.state for r in svc2.state.jobs.values())
            svc2.close()
            return state, procs, final

        state, procs, final = both(tmp_path, scenario)
        assert state == "interrupted" and not procs and final == ["done"]


class TestEnvPropagation:
    def test_job_env_carries_cross_process_contracts(self, monkeypatch):
        monkeypatch.setenv("CURATE_CHAOS", '{"seed": 1, "rules": []}')
        monkeypatch.setenv("CURATE_DLQ_DIR", "/tmp/dlq-here")
        monkeypatch.setenv("CURATE_TRACING", "1")
        monkeypatch.setenv("CURATE_TRACEPARENT", "00-11111111111111111111111111111111-2222222222222222-01")
        envs = []
        for pkg in PKGS:
            rec = pkg.job_queue.JobRecord.new("split", {})
            rec.job_id, rec.attempts = "abcdef012345", 2
            env = pkg.app.job_env(rec)
            envs.append({k: env.get(k) for k in ("CURATE_CHAOS", "CURATE_DLQ_DIR", "CURATE_TRACING",
                                                 "CURATE_TRACEPARENT", "CURATE_WORKER_ID")})
        assert envs[1] == envs[0]
        assert envs[1]["CURATE_TRACEPARENT"].startswith("00-1111")
        assert envs[1]["CURATE_WORKER_ID"] == "job-abcdef012345-a2"

    def test_child_process_sees_propagated_env(self, tmp_path, monkeypatch):
        monkeypatch.setenv("CURATE_DLQ_DIR", str(tmp_path / "dlq"))
        monkeypatch.setenv("CURATE_TRACING", "1")

        def env_dump_job(rec, work_dir):
            code = ("import json, os, sys\n"
                    "keys = ['CURATE_DLQ_DIR', 'CURATE_TRACING', 'CURATE_WORKER_ID']\n"
                    "json.dump({k: os.environ.get(k) for k in keys}, open(sys.argv[1], 'w'))\n")
            return [sys.executable, "-c", code, str(work_dir / "summary.json")]

        def scenario(pkg, root):
            svc = Service(pkg, root / "svc", config=config(pkg), runner_cmd=env_dump_job)
            job_id = svc.submit()
            svc.wait_state(job_id, "done")
            seen = json.loads(svc.state.summary_path(job_id).read_text())
            svc.close()
            assert seen["CURATE_WORKER_ID"] == f"job-{job_id}-a1"
            return seen

        seen = both(tmp_path, scenario)
        assert seen["CURATE_DLQ_DIR"] == str(tmp_path / "dlq") and seen["CURATE_TRACING"] == "1"


class TestApiSurface:
    def test_health_and_jobs_listing(self, tmp_path):
        def scenario(pkg, root):
            svc = Service(pkg, root / "svc", config=config(pkg), runner_cmd=sleep_job(0.01))
            svc.wait(lambda: svc.state.dispatcher_running, msg="dispatcher up")
            health = svc.req("GET", "/health")[:2]
            a, b = svc.submit(tenant="a"), svc.submit(tenant="b")
            svc.wait_state(a, "done")
            svc.wait_state(b, "done")
            listing = svc.req("GET", "/v1/jobs?tenant=a")[:2]
            progress = svc.req("GET", f"/v1/progress/{a}")[:2]
            svc.close()
            return health, listing, progress

        health, listing, progress = both(tmp_path, scenario)
        assert health[1]["status"] == "ok" and health[1]["queued"] == {"interactive": 0, "batch": 0}
        assert [j["tenant"] for j in listing[1]["jobs"]] == ["a"]
        assert progress[1]["state"] == "done" and progress[1]["attempts"] == 1
        assert progress[1]["summary"] == {"ok": True}

    def test_log_tail_is_bounded(self, tmp_path):
        def chatty_job(rec, work_dir):
            code = ("import json, sys\n"
                    "for i in range(5000):\n"
                    "    print(f'line-{i}')\n"
                    "json.dump({}, open(sys.argv[1], 'w'))\n")
            return [sys.executable, "-c", code, str(work_dir / "summary.json")]

        def scenario(pkg, root):
            svc = Service(pkg, root / "svc", config=config(pkg), runner_cmd=chatty_job)
            job_id = svc.submit()
            svc.wait_state(job_id, "done")
            doc = svc.req("GET", f"/v1/logs/{job_id}?tail=50")[1]
            svc.close()
            return doc

        doc = both(tmp_path, scenario)
        assert len(doc["lines"]) == 50 and doc["lines"][-1] == "line-4999"

    def test_invalid_lane_and_tenant_rejected(self, tmp_path):
        def scenario(pkg, root):
            svc = Service(pkg, root / "svc", config=config(pkg), runner_cmd=sleep_job(0.01))
            out = [svc.req("POST", "/v1/invoke", json={"pipeline": "split", "priority": "bulk"})[:2]]
            for bad_tenant in ("", "a/b", "x" * 65, "evil\n"):
                out.append(svc.req("POST", "/v1/invoke", json={"pipeline": "split", "tenant": bad_tenant})[:2])
            out.append(svc.req("POST", "/v1/invoke", json={"pipeline": "split", "max_attempts": 0})[:2])
            for body in (b"[1, 2]", b'"split"', b"3"):
                out.append(svc.req("POST", "/v1/invoke", data=body,
                                   headers={"Content-Type": "application/json"})[:2])
            svc.close()
            return out

        assert [status for status, _ in both(tmp_path, scenario)] == [400] * 9

    def test_terminal_records_gc_with_tombstone(self, tmp_path):
        def scenario(pkg, root):
            cfg = config(pkg, retain_terminal_s=0.1)
            svc = Service(pkg, root / "svc", config=cfg, runner_cmd=sleep_job(0.01))
            job_id = svc.submit()
            svc.wait_state(job_id, "done")
            svc.wait(lambda: job_id not in svc.state.jobs, msg="terminal record evicted")
            svc.close()
            events = svc.journal_events()
            svc2 = Service(pkg, root / "svc", config=cfg, runner_cmd=sleep_job(0.01))
            resurrected = job_id in svc2.state.jobs
            svc2.close()
            return events, resurrected

        events, resurrected = both(tmp_path, scenario)
        assert events[-1] == ("evicted", "done") and not resurrected

    def test_backoff_does_not_hold_dispatch_slot(self, tmp_path, monkeypatch):
        def scenario(pkg, root):
            # full jitter is uniform(0, cap): pin it so the window is real
            monkeypatch.setattr(f"{pkg.name}.service.app.backoff_s", lambda *a, **kw: 8.0)
            cfg = config(pkg, max_concurrent_jobs=1)

            def router(rec, work_dir):
                if rec.tenant == "flaky":
                    return [sys.executable, "-c", "import sys; sys.exit(9)"]
                return sleep_job(0.01)(rec, work_dir)

            svc = Service(pkg, root / "svc", config=cfg, runner_cmd=router)
            flaky = svc.submit(tenant="flaky", max_attempts=3)
            svc.wait(lambda: svc.state.jobs[flaky].state == "pending" and svc.state.jobs[flaky].attempts == 1,
                     msg="flaky job parked in backoff")
            healthy = svc.submit(tenant="steady")
            # the healthy job completes INSIDE the flaky job's backoff window
            svc.wait_state(healthy, "done", timeout=6)
            attempts = svc.state.jobs[flaky].attempts
            svc.req("POST", f"/v1/terminate/{flaky}")
            for task in list(svc.state.watchers):
                task.cancel()
            svc.loop.run_until_complete(asyncio.sleep(0))
            svc.close()
            return attempts

        assert both(tmp_path, scenario) == 1
