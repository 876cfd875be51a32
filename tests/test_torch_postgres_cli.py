"""Port parity: ``postgres`` (``cli/postgres_cli.py``), the AV state
database's admin commands, against the JAX CLI.

Each command (``show-tables``, ``show-schemas``, ``show-foreign-keys``,
``update-schemas`` with and without ``--dry-run``) runs through both
packages' ``main`` on the same database: a sqlite file (a copy a package)
and the fake PostgreSQL server of ``tests/pipelines/fake_pg.py`` (a server a
package). The database is an older deploy: ``clips`` lacks its ``caption``
column, most tables are missing and an extra table and column are there.
Printed output and exit codes are equal; the database after
``update-schemas`` is too (tables, columns, rows), and a second run finds
the schema up to date. The parser's schema DDL parse and the schema diff
are held to the reference's functions directly.
"""

from __future__ import annotations

import dataclasses
import shutil
import sqlite3

import pytest

from cosmos_curate_tpu.cli import main as jmain
from cosmos_curate_tpu.cli import postgres_cli as jpcli
from cosmos_curate_tpu_torch.cli import main as tmain
from cosmos_curate_tpu_torch.cli import postgres_cli as tpcli
from tests.pipelines.fake_pg import FakePgServer

OLD_DEPLOY = [
    "CREATE TABLE sessions (session_id TEXT PRIMARY KEY, num_cameras INTEGER NOT NULL, "
    "state TEXT NOT NULL DEFAULT 'ingested', created_s REAL NOT NULL, legacy_note TEXT)",
    "CREATE TABLE clips (clip_uuid TEXT PRIMARY KEY, session_id TEXT NOT NULL REFERENCES sessions (session_id), "
    "camera TEXT NOT NULL, span_start REAL NOT NULL, span_end REAL NOT NULL, state TEXT NOT NULL DEFAULT 'split')",
    "CREATE TABLE scratch_notes (k TEXT, v TEXT)",
    "INSERT INTO sessions VALUES ('drive_a', 3, 'split', 1.5, 'x')",
    "INSERT INTO clips VALUES ('c1', 'drive_a', 'front', 0.0, 2.0, 'split')",
]
COMMANDS = [["show-tables"], ["show-schemas"], ["show-foreign-keys"], ["update-schemas", "--dry-run"],
            ["update-schemas"], ["show-tables"], ["show-schemas"], ["update-schemas"]]


def _old_sqlite(path) -> str:
    con = sqlite3.connect(path)
    for stmt in OLD_DEPLOY:
        con.execute(stmt)
    con.commit()
    con.close()
    return str(path)


def _run(main, db: str, capsys) -> list:
    out = []
    for cmd in COMMANDS:
        rc = main.main(["postgres", cmd[0], "--db", db, *cmd[1:]])
        out.append((cmd, rc, capsys.readouterr().out))
    return out


def _dump(inspector) -> dict:
    try:
        return {t: ([dataclasses.astuple(c) for c in inspector.columns(t)], inspector.row_count(t))
                for t in inspector.tables()}
    finally:
        inspector.close()


def test_commands_on_sqlite_match_jax(tmp_path, capsys):
    j_db = _old_sqlite(tmp_path / "jax.sqlite")
    t_db = str(tmp_path / "port.sqlite")
    shutil.copy(j_db, t_db)
    want, got = _run(jmain, j_db, capsys), _run(tmain, t_db, capsys)
    assert got == want
    assert got[-1][2] == "schema up to date\nextra table (kept): scratch_notes\nextra column (kept): " \
                         "sessions.legacy_note\n"
    assert "clips.session_id -> sessions.session_id" in got[2][2]
    assert _dump(tpcli.SqliteInspector(t_db)) == _dump(jpcli.SqliteInspector(j_db))


def test_commands_on_postgres_match_jax(capsys):
    outs, dumps = {}, {}
    for name, main, pcli in (("jax", jmain, jpcli), ("port", tmain, tpcli)):
        with FakePgServer(auth="scram") as srv:
            insp = pcli.PostgresInspector(srv.dsn)
            for stmt in OLD_DEPLOY:
                insp.execute(stmt)
            insp.close()
            outs[name] = _run(main, srv.dsn, capsys)
            dumps[name] = _dump(pcli.PostgresInspector(srv.dsn))
    assert outs["port"] == outs["jax"]
    assert dumps["port"] == dumps["jax"] and "clip_caption" in dumps["port"]
    assert "applied: CREATE TABLE IF NOT EXISTS run" in outs["port"][4][2]
    assert "applied: ALTER TABLE clips ADD COLUMN caption TEXT" in outs["port"][4][2]


@pytest.mark.parametrize("dialect", ["sqlite", "postgres"])
def test_target_schema_and_diff_match_jax(dialect, tmp_path):
    plain = lambda schema: {t: [dataclasses.astuple(c) for c in cols] for t, cols in schema.items()}  # noqa: E731
    assert plain(tpcli.target_schema(dialect)) == plain(jpcli.target_schema(dialect))
    assert len(tpcli.target_schema(dialect)) == 7
    path = _old_sqlite(tmp_path / "old.sqlite")
    t_changes = tpcli.diff_schema(tpcli.SqliteInspector(path), tpcli.target_schema(dialect))
    j_changes = jpcli.diff_schema(jpcli.SqliteInspector(path), jpcli.target_schema(dialect))
    as_plain = lambda ch: (ch.missing_tables, [(t, dataclasses.astuple(c)) for t, c in ch.missing_columns],  # noqa: E731
                           ch.extra_tables, ch.extra_columns, ch.empty)
    assert as_plain(t_changes) == as_plain(j_changes)
    assert t_changes.extra_tables == ["scratch_notes"] and not t_changes.empty


def test_quote_ident_matches_jax():
    for name in ("clips", 'we"ird', "Mixed Case", ""):
        assert tpcli.quote_ident(name) == jpcli.quote_ident(name)
