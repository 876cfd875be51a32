"""Port parity: the durable job journal (``service/job_queue.py``), the
scenarios of ``tests/service/test_job_queue.py`` run through both packages.

Each scenario runs on the JAX package's journal and the port's and must
give the same records, the same (event, state) sequence on disk and the
same recovery. The journal is one format: a journal either package wrote
replays in the other's ``JobJournal`` and recovers to the same records,
and the port's recovery waits for a killed orphan's process group to be
gone before it returns.
"""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import pytest

from tests.fixtures.service_harness import PACKAGES, journal_events, package

PKGS = [package(name) for name in PACKAGES]
JAX, PORT = PKGS


def _rec(pkg, **kw):
    kw.setdefault("pipeline", "split")
    kw.setdefault("args", {"input_path": "/in", "output_path": "/out"})
    return pkg.job_queue.JobRecord.new(**kw)


def _journal(pkg, tmp_path):
    return pkg.job_queue.JobJournal(tmp_path / pkg.name / "journal.ndjson")


def _fields(rec) -> dict:
    """A record without what the clock or the uuid decides."""
    doc = rec.to_dict()
    for key in ("job_id", "submitted_s", "enqueued_s"):
        doc.pop(key)
    return doc


def test_record_fields_are_the_reference_fields():
    assert list(PORT.job_queue.JobRecord.__dataclass_fields__) == list(JAX.job_queue.JobRecord.__dataclass_fields__)
    assert PORT.job_queue.LANES == JAX.job_queue.LANES
    assert PORT.job_queue.JOB_STATES == JAX.job_queue.JOB_STATES
    assert PORT.job_queue.TERMINAL_STATES == JAX.job_queue.TERMINAL_STATES


class TestJournal:
    def test_append_replay_roundtrip(self, tmp_path):
        outs = []
        for pkg in PKGS:
            journal = _journal(pkg, tmp_path)
            rec = _rec(pkg, tenant="acme", priority="interactive", max_attempts=5)
            journal.append(rec, "submit")
            got = journal.replay()
            assert set(got) == {rec.job_id}
            back = got[rec.job_id]
            assert (back.tenant, back.priority, back.max_attempts, back.args) == ("acme", "interactive", 5, rec.args)
            outs.append((_fields(back), journal_events(journal.path)))
        assert outs[1] == outs[0]

    def test_last_snapshot_wins(self, tmp_path):
        outs = []
        for pkg in PKGS:
            journal = _journal(pkg, tmp_path)
            rec = _rec(pkg)
            journal.append(rec, "submit")
            rec.state, rec.attempts, rec.pid = "running", 1, 4242
            journal.append(rec, "running")
            rec.state, rec.pid = "done", None
            journal.append(rec, "done")
            back = journal.replay()[rec.job_id]
            assert back.state == "done" and back.attempts == 1
            outs.append((_fields(back), journal_events(journal.path)))
        assert outs[1] == outs[0]
        assert outs[1][1] == [("submit", "pending"), ("running", "running"), ("done", "done")]

    def test_torn_tail_line_discarded(self, tmp_path):
        for pkg in PKGS:
            journal = _journal(pkg, tmp_path)
            a, b = _rec(pkg), _rec(pkg)
            journal.append(a, "submit")
            journal.append(b, "submit")
            with open(journal.path, "a") as f:
                f.write('{"ts": 1, "event": "running", "record": {"job_id"')  # no newline, torn
            assert set(journal.replay()) == {a.job_id, b.job_id}

    def test_corrupt_middle_line_skipped(self, tmp_path):
        for pkg in PKGS:
            journal = _journal(pkg, tmp_path)
            a = _rec(pkg)
            journal.append(a, "submit")
            with open(journal.path, "a") as f:
                f.write("not json at all\n")
            b = _rec(pkg)
            journal.append(b, "submit")
            assert set(journal.replay()) == {a.job_id, b.job_id}

    def test_unknown_record_fields_ignored(self, tmp_path):
        for pkg in PKGS:
            journal = _journal(pkg, tmp_path)
            rec = _rec(pkg)
            doc = {"ts": 1.0, "event": "submit", "record": {**rec.to_dict(), "new_field": 1}}
            journal.path.write_text(json.dumps(doc) + "\n")
            assert set(journal.replay()) == {rec.job_id}

    def test_compact_one_line_per_job(self, tmp_path):
        outs = []
        for pkg in PKGS:
            journal = _journal(pkg, tmp_path)
            rec = _rec(pkg)
            for event in ("submit", "running", "retry", "running", "done"):
                journal.append(rec, event)
            journal.compact(journal.replay())
            assert len(journal.path.read_text().splitlines()) == 1
            assert journal.replay()[rec.job_id].job_id == rec.job_id
            outs.append(journal_events(journal.path))
        assert outs[1] == outs[0] == [("compact", "pending")]

    def test_missing_journal_is_empty(self, tmp_path):
        for pkg in PKGS:
            assert _journal(pkg, tmp_path).replay() == {}

    def test_evicted_tombstone_drops_record(self, tmp_path):
        for pkg in PKGS:
            journal = _journal(pkg, tmp_path)
            keep, gone = _rec(pkg), _rec(pkg)
            journal.append(keep, "submit")
            gone.state = "done"
            journal.append(gone, "done")
            journal.append(gone, "evicted")
            assert set(journal.replay()) == {keep.job_id}


class TestChaosSite:
    def test_journal_write_fault_raises(self, tmp_path):
        for pkg in PKGS:
            journal = _journal(pkg, tmp_path)
            chaos = pkg.chaos
            chaos.install(chaos.FaultPlan(rules=(chaos.FaultRule(site=chaos.SITE_SERVICE_JOURNAL_WRITE,
                                                                 kind="error"),)))
            try:
                with pytest.raises(pkg.job_queue.JournalWriteError):
                    journal.append(_rec(pkg), "submit")
            finally:
                chaos.uninstall()
            assert journal.replay() == {}
        assert PORT.chaos.SITE_SERVICE_JOURNAL_WRITE == JAX.chaos.SITE_SERVICE_JOURNAL_WRITE


class TestRecovery:
    def test_running_marked_interrupted_and_requeued(self, tmp_path):
        outs = []
        for pkg in PKGS:
            journal = _journal(pkg, tmp_path)
            rec = _rec(pkg)
            rec.state, rec.attempts, rec.pid = "running", 1, None
            journal.append(rec, "running")
            records, requeue = pkg.job_queue.recover_records(journal)
            assert records[rec.job_id].state == "interrupted" and requeue == [rec.job_id]
            assert records[rec.job_id].attempts == 1
            outs.append(_fields(records[rec.job_id]))
        assert outs[1] == outs[0]

    def test_pending_requeued_terminal_kept(self, tmp_path):
        for pkg in PKGS:
            journal = _journal(pkg, tmp_path)
            pend, done, dead = _rec(pkg), _rec(pkg), _rec(pkg)
            journal.append(pend, "submit")
            done.state = "done"
            journal.append(done, "done")
            dead.state = "dead_lettered"
            journal.append(dead, "dead-lettered")
            records, requeue = pkg.job_queue.recover_records(journal)
            assert requeue == [pend.job_id]
            assert records[done.job_id].state == "done" and records[dead.job_id].state == "dead_lettered"

    def test_stale_pid_not_killed(self, tmp_path):
        # pid 1 is no job child of this journal: recovery must not signal it
        for pkg in PKGS:
            journal = _journal(pkg, tmp_path)
            rec = _rec(pkg)
            rec.state, rec.pid = "running", 1
            journal.append(rec, "running")
            records, requeue = pkg.job_queue.recover_records(journal)
            assert records[rec.job_id].state == "interrupted" and requeue == [rec.job_id]

    def test_orphan_group_is_gone_before_recovery_returns(self, tmp_path):
        """An orphaned job child (its own session, stamped with the job's
        worker id) and a grandchild in its group: the port's recovery
        SIGKILLs the group and returns only once no live member is left,
        so a resumed attempt never runs beside it."""
        journal = _journal(PORT, tmp_path)
        rec = _rec(PORT)
        marker = tmp_path / "grandchild.pid"
        env = {**os.environ, "CURATE_WORKER_ID": f"job-{rec.job_id}-a1"}
        proc = subprocess.Popen(["/bin/sh", "-c", f"sleep 300 & echo $! > '{marker}'; wait"], env=env,
                                start_new_session=True)
        try:
            deadline = time.monotonic() + 30
            while not (marker.exists() and marker.read_text().strip()) and time.monotonic() < deadline:
                time.sleep(0.01)
            grandchild = int(marker.read_text())
            rec.state, rec.attempts, rec.pid = "running", 1, proc.pid
            journal.append(rec, "running")
            records, requeue = PORT.job_queue.recover_records(journal)
            # recovery returned: the group has no live member (the leader is
            # at most a zombie of this test process until it is waited for)
            assert PORT.job_queue._live_group_members(proc.pid) == []
            assert proc.wait(timeout=10) == -signal.SIGKILL
            # the grandchild is gone, or a zombie its new parent has not reaped
            stat = Path(f"/proc/{grandchild}/stat")
            assert not stat.exists() or stat.read_text().rsplit(")", 1)[1].split()[0] == "Z"
            assert requeue == [rec.job_id] and records[rec.job_id].pid is None
        finally:
            if proc.poll() is None:
                os.killpg(proc.pid, signal.SIGKILL)
                proc.wait(timeout=10)

    def test_wait_group_gone_times_out_on_a_live_group(self):
        proc = subprocess.Popen([sys.executable, "-c", "import time; time.sleep(60)"], start_new_session=True)
        try:
            t0 = time.monotonic()
            assert not PORT.job_queue.wait_group_gone(proc.pid, timeout_s=0.2)
            assert time.monotonic() - t0 >= 0.2
        finally:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait(timeout=10)
        assert PORT.job_queue.wait_group_gone(proc.pid, timeout_s=5.0)


@pytest.mark.parametrize("writer,reader", [(JAX, PORT), (PORT, JAX)], ids=["jax-to-torch", "torch-to-jax"])
def test_journal_replays_in_the_other_package(writer, reader, tmp_path):
    """A journal one package wrote (every transition kind, a tombstone, a
    compaction) replays and recovers in the other's to the same records."""
    journal = writer.job_queue.JobJournal(tmp_path / "journal.ndjson")
    recs = {}
    for name, state, event in (("done", "done", "done"), ("running", "running", "running"),
                               ("pending", "pending", "submit"), ("dead", "dead_lettered", "dead-lettered"),
                               ("gone", "done", "done")):
        rec = writer.job_queue.JobRecord.new("split", {"input_path": f"/in/{name}"}, tenant=name,
                                             priority="interactive" if name == "running" else "batch")
        journal.append(rec, "submit")
        rec.state, rec.attempts = state, (1 if state != "pending" else 0)
        journal.append(rec, event)
        recs[name] = rec
    journal.append(recs["gone"], "evicted")
    want = writer.job_queue.recover_records(writer.job_queue.JobJournal(journal.path))
    got = reader.job_queue.recover_records(reader.job_queue.JobJournal(journal.path))
    assert {k: r.to_dict() for k, r in got[0].items()} == {k: r.to_dict() for k, r in want[0].items()}
    assert got[1] == want[1] == [recs["running"].job_id, recs["pending"].job_id]
    # the reader appends and compacts in the same format
    reader_journal = reader.job_queue.JobJournal(journal.path)
    reader_journal.compact(got[0])
    again = writer.job_queue.JobJournal(journal.path).replay()
    assert {k: r.to_dict() for k, r in again.items()} == {k: r.to_dict() for k, r in got[0].items()}
