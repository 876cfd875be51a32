"""Port parity: durable-format version skew, the scenarios of
``tests/service/test_schema_versioning.py`` through both packages.

The port's ``utils/schema_stamp.py`` publishes the reference's versions for
the surfaces it writes (the job journal among them), carries version-1
documents forward through the same shims and treats a newer document by
the same policy: best-effort for the journal's replay and the DLQ's
listing, refused for index manifests. A v1, mixed-version, torn or
newer-version journal replays to the same records in both packages.
"""

from __future__ import annotations

import json

import pytest

from cosmos_curate_tpu.utils import schema_stamp as jstamp
from cosmos_curate_tpu_torch.utils import schema_stamp as tstamp
from tests.fixtures.service_harness import PACKAGES, package

PKGS = [package(name) for name in PACKAGES]
JAX, PORT = PKGS
STAMP_KEY = tstamp.STAMP_KEY
# the surfaces the port reads and writes (the reference also has bench rows)
PORT_SURFACES = ("job-journal", "dlq-meta", "index-manifest", "run-report", "node-stats", "live-status")


def _v1_line(rec, event: str, ts: float = 1000.0) -> str:
    """A journal line exactly as the pre-stamp (v1) build wrote it."""
    return json.dumps({"ts": ts, "event": event, "record": rec.to_dict()})


def _replayed(pkg, path) -> dict:
    return {k: r.to_dict() for k, r in pkg.job_queue.JobJournal(path).replay().items()}


class TestSchemaStamp:
    def test_versions_are_the_reference_versions(self):
        assert tstamp.STAMP_KEY == jstamp.STAMP_KEY
        assert {s: tstamp.SCHEMA_VERSIONS[s] for s in PORT_SURFACES} == \
            {s: jstamp.SCHEMA_VERSIONS[s] for s in PORT_SURFACES}
        assert set(tstamp.SCHEMA_VERSIONS) == set(PORT_SURFACES)

    def test_stamp_adds_version_in_place(self):
        doc = {"a": 1}
        assert tstamp.stamp(doc, "run-report") is doc
        assert doc[STAMP_KEY] == tstamp.SCHEMA_VERSIONS["run-report"]

    def test_stamp_unknown_surface_raises(self):
        for mod in (jstamp, tstamp):
            with pytest.raises(KeyError):
                mod.stamp({}, "no-such-surface")

    def test_unstamped_doc_reads_as_v1(self):
        for mod in (jstamp, tstamp):
            assert mod.doc_version({"a": 1}) == 1 and mod.doc_version({STAMP_KEY: 2}) == 2

    def test_upgrade_v1_through_shim_chain(self):
        for surface in ("job-journal", "dlq-meta", "index-manifest"):
            up = tstamp.upgrade({"payload": "x"}, surface)
            assert up == jstamp.upgrade({"payload": "x"}, surface)
            assert up[STAMP_KEY] == tstamp.SCHEMA_VERSIONS[surface] and up["payload"] == "x"

    def test_upgrade_current_is_identity(self):
        doc = tstamp.stamp({"a": 1}, "job-journal")
        assert tstamp.upgrade(dict(doc), "job-journal") == doc

    def test_newer_than_reader_strict_raises(self):
        for mod in (jstamp, tstamp):
            with pytest.raises(mod.SchemaVersionError):
                mod.upgrade({STAMP_KEY: 99, "a": 1}, "job-journal")

    def test_newer_than_reader_lenient_passes_through(self):
        doc = {STAMP_KEY: 99, "a": 1}
        assert tstamp.upgrade(dict(doc), "job-journal", strict=False) == doc
        assert jstamp.upgrade(dict(doc), "job-journal", strict=False) == doc

    def test_missing_shim_raises_even_lenient(self, monkeypatch):
        for mod in (jstamp, tstamp):
            monkeypatch.setitem(mod.SCHEMA_VERSIONS, "run-report", 2)
            with pytest.raises(mod.SchemaVersionError):
                mod.upgrade({"a": 1}, "run-report", strict=False)

    def test_shim_registry_covers_every_superseded_version(self):
        for surface, current in tstamp.SCHEMA_VERSIONS.items():
            for v in range(1, current):
                assert (surface, v) in tstamp.MIGRATIONS, (surface, v)


class TestJournalVersionSkew:
    def test_v1_journal_replays_with_zero_lost_or_duplicated(self, tmp_path):
        path = tmp_path / "journal.ndjson"
        a = JAX.job_queue.JobRecord.new("split", {}, tenant="t1")
        b = JAX.job_queue.JobRecord.new("split", {}, tenant="t2")
        lines = [_v1_line(a, "submit"), _v1_line(b, "submit")]
        a.state = "running"
        lines.append(_v1_line(a, "running"))
        path.write_text("\n".join(lines) + "\n")
        records = _replayed(PORT, path)
        assert records == _replayed(JAX, path)
        assert sorted(records) == sorted([a.job_id, b.job_id])
        assert records[a.job_id]["state"] == "running" and records[b.job_id]["state"] == "pending"

    def test_mixed_version_journal_replays(self, tmp_path):
        for pkg in PKGS:
            path = tmp_path / pkg.name / "journal.ndjson"
            path.parent.mkdir()
            rec = pkg.job_queue.JobRecord.new("split", {}, tenant="t1")
            path.write_text(_v1_line(rec, "submit") + "\n")
            journal = pkg.job_queue.JobJournal(path)
            rec.state = "done"
            journal.append(rec, "done")
            records = journal.replay()
            assert list(records) == [rec.job_id] and records[rec.job_id].state == "done"
            docs = [json.loads(line) for line in path.read_text().splitlines()]
            assert tstamp.doc_version(docs[0]) == 1
            assert tstamp.doc_version(docs[1]) == tstamp.SCHEMA_VERSIONS["job-journal"]
            assert _replayed(PORT, path) == _replayed(JAX, path)

    def test_torn_tail_line_discarded(self, tmp_path):
        path = tmp_path / "journal.ndjson"
        rec = JAX.job_queue.JobRecord.new("split", {}, tenant="t1")
        path.write_text(_v1_line(rec, "submit") + "\n" + '{"ts": 5, "ev')
        assert list(_replayed(PORT, path)) == [rec.job_id]
        assert _replayed(PORT, path) == _replayed(JAX, path)

    def test_corrupt_middle_line_skipped(self, tmp_path):
        path = tmp_path / "journal.ndjson"
        a = JAX.job_queue.JobRecord.new("split", {}, tenant="t1")
        b = JAX.job_queue.JobRecord.new("split", {}, tenant="t2")
        path.write_text(_v1_line(a, "submit") + "\n<garbage>\n" + _v1_line(b, "submit") + "\n")
        assert sorted(_replayed(PORT, path)) == sorted([a.job_id, b.job_id])
        assert _replayed(PORT, path) == _replayed(JAX, path)

    def test_newer_version_line_replays_best_effort(self, tmp_path):
        path = tmp_path / "journal.ndjson"
        rec = PORT.job_queue.JobRecord.new("split", {}, tenant="t1")
        doc = {STAMP_KEY: tstamp.SCHEMA_VERSIONS["job-journal"] + 1, "ts": 1.0, "event": "submit",
               "record": {**rec.to_dict(), "field_from_the_future": True}}
        path.write_text(json.dumps(doc) + "\n")
        assert list(_replayed(PORT, path)) == [rec.job_id]
        assert _replayed(PORT, path) == _replayed(JAX, path)

    def test_recover_requeues_v1_running_job(self, tmp_path):
        path = tmp_path / "journal.ndjson"
        rec = JAX.job_queue.JobRecord.new("split", {}, tenant="t1")
        rec.state = "running"
        path.write_text(_v1_line(rec, "running") + "\n")
        records, requeue_ids = PORT.job_queue.recover_records(PORT.job_queue.JobJournal(path))
        assert requeue_ids == [rec.job_id] and list(records) == [rec.job_id]
        assert records[rec.job_id].state == "interrupted"


class TestDlqVersionSkew:
    def test_v1_meta_listed_and_upgraded(self, tmp_path):
        from cosmos_curate_tpu.engine.dead_letter import list_entries as jlist
        from cosmos_curate_tpu_torch.engine.dead_letter import list_entries as tlist

        entry = tmp_path / "run-old" / "batch-3-stage_a"
        entry.mkdir(parents=True)
        (entry / "meta.json").write_text(json.dumps({"stage": "stage_a", "batch_id": 3, "reason": "poison"}))
        (got,) = tlist(str(tmp_path))
        (want,) = jlist(str(tmp_path))
        assert got.meta == want.meta
        assert got.meta["batch_id"] == 3 and got.meta[STAMP_KEY] == tstamp.SCHEMA_VERSIONS["dlq-meta"]


class TestManifestVersionSkew:
    def _store(self, tmp_path):
        from cosmos_curate_tpu_torch.dedup.index_store import IndexStore

        return IndexStore(str(tmp_path), backend="parquet")

    def test_v1_manifest_upgraded_on_read(self, tmp_path):
        store = self._store(tmp_path)
        gen_path = tmp_path / "manifests" / "gen-000001.json"
        gen_path.parent.mkdir(parents=True)
        gen_path.write_text(json.dumps({"generation": 1, "clusters": {}, "centroids": "c.npy"}))
        (tmp_path / "MANIFEST.json").write_text(json.dumps({"generation": 1}))
        manifest = store.read_manifest()
        assert manifest["generation"] == 1 and manifest[STAMP_KEY] == tstamp.SCHEMA_VERSIONS["index-manifest"]

    def test_newer_manifest_refused(self, tmp_path):
        store = self._store(tmp_path)
        gen_path = tmp_path / "manifests" / "gen-000001.json"
        gen_path.parent.mkdir(parents=True)
        gen_path.write_text(json.dumps({STAMP_KEY: 99, "generation": 1, "clusters": {}}))
        (tmp_path / "MANIFEST.json").write_text(json.dumps({"generation": 1}))
        with pytest.raises(RuntimeError, match="manifest"):
            store.read_manifest()

    def test_published_manifest_is_stamped(self, tmp_path):
        store = self._store(tmp_path)
        store.publish_manifest({"generation": 1, "clusters": {}, "centroids": "c.npy", "meta": {}})
        on_disk = json.loads((tmp_path / "manifests" / "gen-000001.json").read_text())
        assert on_disk[STAMP_KEY] == tstamp.SCHEMA_VERSIONS["index-manifest"]
        pointer = json.loads((tmp_path / "MANIFEST.json").read_text())
        assert pointer["generation"] == 1 and pointer[STAMP_KEY] == tstamp.SCHEMA_VERSIONS["index-manifest"]
