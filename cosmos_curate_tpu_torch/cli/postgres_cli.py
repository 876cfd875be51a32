"""``cosmos-curate-tpu-torch postgres``: the AV state database's admin
commands (port of ``cosmos_curate_tpu/cli/postgres_cli.py``; host code, no
torch).

``show-tables``, ``show-schemas``, ``update-schemas`` and
``show-foreign-keys``, over the driverless wire client
(utils/pg_client.py) for a ``postgres://`` DSN and over sqlite for a file
path, so the same commands administer a local run's database and a shared
one. ``update-schemas`` diffs the live database against the AV state
schema declared in pipelines/av/state_db.py and applies additive changes
only (CREATE TABLE for a missing table, ALTER TABLE ADD COLUMN for a
missing column); extra tables and columns are reported, never dropped.
"""

from __future__ import annotations

import argparse
import re
import sqlite3
from dataclasses import dataclass

from cosmos_curate_tpu_torch.pipelines.av import state_db
from cosmos_curate_tpu_torch.utils.logging import get_logger
from cosmos_curate_tpu_torch.utils.pg_client import PgConnection, parse_dsn, quote_literal

logger = get_logger(__name__)


@dataclass(frozen=True)
class ColumnInfo:
    name: str
    data_type: str
    nullable: bool


@dataclass(frozen=True)
class ForeignKeyInfo:
    table: str
    column: str
    ref_table: str
    ref_column: str


# -- target schema ---------------------------------------------------------


def parse_schema_ddl(ddl: str) -> dict[str, list[ColumnInfo]]:
    """Extract table -> columns from the state_db CREATE TABLE DDL (the
    schema source of truth; simple comma-split is sufficient for it)."""
    tables: dict[str, list[ColumnInfo]] = {}
    for m in re.finditer(
        r"CREATE TABLE IF NOT EXISTS (\w+)\s*\((.*?)\);", ddl, re.S | re.I
    ):
        name, body = m.group(1), m.group(2)
        cols: list[ColumnInfo] = []
        depth = 0
        piece = ""
        pieces: list[str] = []
        for ch in body:
            if ch == "(":
                depth += 1
            elif ch == ")":
                depth -= 1
            if ch == "," and depth == 0:
                pieces.append(piece)
                piece = ""
            else:
                piece += ch
        if piece.strip():
            pieces.append(piece)
        for p in pieces:
            p = " ".join(p.split())
            if not p or re.match(r"(PRIMARY KEY|FOREIGN KEY|UNIQUE|CHECK)\b", p, re.I):
                continue
            parts = p.split()
            # type may be multi-word (DOUBLE PRECISION): take words until a
            # constraint keyword
            stop = {"NOT", "NULL", "PRIMARY", "DEFAULT", "UNIQUE", "REFERENCES", "CHECK"}
            type_words = []
            for w in parts[1:]:
                if w.upper() in stop:
                    break
                type_words.append(w.upper())
            cols.append(
                ColumnInfo(
                    name=parts[0],
                    data_type=" ".join(type_words) or "TEXT",
                    nullable="NOT NULL" not in p.upper(),
                )
            )
        tables[name] = cols
    return tables


def target_schema(dialect: str) -> dict[str, list[ColumnInfo]]:
    ddl = state_db._PG_SCHEMA if dialect == "postgres" else state_db._SCHEMA
    return parse_schema_ddl(ddl)


# -- inspectors ------------------------------------------------------------


def quote_ident(name: str) -> str:
    """Quote an SQL identifier (table names come from DB metadata, which a
    hostile or merely mixed-case schema can use to break — or inject into —
    the admin session's queries)."""
    return '"' + name.replace('"', '""') + '"'


class SqliteInspector:
    dialect = "sqlite"

    def __init__(self, path: str) -> None:
        self._db = sqlite3.connect(path)

    def tables(self) -> list[str]:
        rows = self._db.execute(
            "SELECT name FROM sqlite_master WHERE type='table' "
            "AND name NOT LIKE 'sqlite_%' ORDER BY name"
        ).fetchall()
        return [r[0] for r in rows]

    def row_count(self, table: str) -> int:
        return self._db.execute(f"SELECT COUNT(*) FROM {quote_ident(table)}").fetchone()[0]

    def columns(self, table: str) -> list[ColumnInfo]:
        rows = self._db.execute(f"PRAGMA table_info({quote_ident(table)})").fetchall()
        return [ColumnInfo(r[1], (r[2] or "TEXT").upper(), not r[3]) for r in rows]

    def foreign_keys(self) -> list[ForeignKeyInfo]:
        out = []
        for t in self.tables():
            for r in self._db.execute(f"PRAGMA foreign_key_list({quote_ident(t)})").fetchall():
                out.append(ForeignKeyInfo(t, r[3], r[2], r[4] or ""))
        return out

    def execute(self, sql: str) -> None:
        with self._db:
            self._db.execute(sql)

    def close(self) -> None:
        self._db.close()


class PostgresInspector:
    dialect = "postgres"

    def __init__(self, dsn: str) -> None:
        self._conn = PgConnection(**parse_dsn(dsn))

    def tables(self) -> list[str]:
        res = self._conn.execute(
            "SELECT table_name FROM information_schema.tables "
            "WHERE table_schema = 'public' ORDER BY table_name"
        )
        return [r[0] for r in res.rows]

    _SCHEMA_FILTER = "AND table_schema = 'public' "

    def row_count(self, table: str) -> int:
        res = self._conn.execute(f"SELECT COUNT(*) FROM {quote_ident(table)}")
        return int(res.rows[0][0])

    def columns(self, table: str) -> list[ColumnInfo]:
        res = self._conn.execute(
            "SELECT column_name, data_type, is_nullable "
            "FROM information_schema.columns "
            f"WHERE table_name = {quote_literal(table)} "
            f"{self._SCHEMA_FILTER}ORDER BY ordinal_position"
        )
        return [
            ColumnInfo(r[0], (r[1] or "text").upper(), r[2] in ("YES", "1"))
            for r in res.rows
        ]

    def foreign_keys(self) -> list[ForeignKeyInfo]:
        res = self._conn.execute(
            "SELECT tc.table_name, kcu.column_name, ccu.table_name, ccu.column_name "
            "FROM information_schema.table_constraints tc "
            "JOIN information_schema.key_column_usage kcu "
            "ON tc.constraint_name = kcu.constraint_name "
            "JOIN information_schema.constraint_column_usage ccu "
            "ON tc.constraint_name = ccu.constraint_name "
            "WHERE tc.constraint_type = 'FOREIGN KEY' "
            "AND tc.table_schema = 'public'"
        )
        return [ForeignKeyInfo(*r) for r in res.rows]

    def execute(self, sql: str) -> None:
        self._conn.execute(sql)

    def close(self) -> None:
        self._conn.close()


def open_inspector(db: str):
    if db.startswith(("postgres://", "postgresql://")):
        return PostgresInspector(db)
    return SqliteInspector(db)


# -- schema diff -----------------------------------------------------------


@dataclass
class SchemaChanges:
    missing_tables: list[str]
    missing_columns: list[tuple[str, ColumnInfo]]
    extra_tables: list[str]
    extra_columns: list[tuple[str, str]]

    @property
    def empty(self) -> bool:
        return not (self.missing_tables or self.missing_columns)


def diff_schema(insp, target: dict[str, list[ColumnInfo]]) -> SchemaChanges:
    live = {t: {c.name for c in insp.columns(t)} for t in insp.tables()}
    changes = SchemaChanges([], [], [], [])
    for table, cols in target.items():
        if table not in live:
            changes.missing_tables.append(table)
            continue
        for col in cols:
            if col.name not in live[table]:
                changes.missing_columns.append((table, col))
        for name in sorted(live[table] - {c.name for c in cols}):
            changes.extra_columns.append((table, name))
    for table in sorted(set(live) - set(target)):
        changes.extra_tables.append(table)
    return changes


def apply_changes(insp, changes: SchemaChanges, *, dry_run: bool) -> list[str]:
    """Additive DDL only. Returns the statements (executed unless dry_run)."""
    ddl = state_db._PG_SCHEMA if insp.dialect == "postgres" else state_db._SCHEMA
    stmts: list[str] = []
    for table in changes.missing_tables:
        m = re.search(
            rf"(CREATE TABLE IF NOT EXISTS {table}\s*\(.*?\);)", ddl, re.S | re.I
        )
        if m:
            stmts.append(m.group(1))
    for table, col in changes.missing_columns:
        # backfill default must match the column type; for types we can't
        # guess a safe default for, add the column nullable and warn — an
        # additive migration must not abort half-applied on bad DDL
        head = col.data_type.split()[0]
        if col.nullable:
            null = ""
        elif head in ("INTEGER", "BIGINT", "SMALLINT", "REAL", "DOUBLE", "NUMERIC", "FLOAT"):
            null = " NOT NULL DEFAULT 0"
        elif head in ("TEXT", "VARCHAR", "CHARACTER", "CHAR"):
            null = " NOT NULL DEFAULT ''"
        elif head in ("BOOLEAN", "BOOL"):
            null = " NOT NULL DEFAULT FALSE"
        else:
            logger.warning(
                "no safe backfill default for %s.%s (%s); adding as nullable",
                table, col.name, col.data_type,
            )
            null = ""
        stmts.append(f"ALTER TABLE {table} ADD COLUMN {col.name} {col.data_type}{null}")
    for sql in stmts:
        if dry_run:
            logger.info("[dry-run] %s", " ".join(sql.split()))
        else:
            logger.info("applying: %s", " ".join(sql.split()))
            insp.execute(sql)
    return stmts


# -- commands --------------------------------------------------------------


def _cmd_show_tables(args) -> int:
    insp = open_inspector(args.db)
    try:
        for t in insp.tables():
            print(f"{t}\t{insp.row_count(t)}")
    finally:
        insp.close()
    return 0


def _cmd_show_schemas(args) -> int:
    insp = open_inspector(args.db)
    try:
        for t in insp.tables():
            print(t)
            for c in insp.columns(t):
                null = "NULL" if c.nullable else "NOT NULL"
                print(f"  {c.name}\t{c.data_type}\t{null}")
    finally:
        insp.close()
    return 0


def _cmd_update_schemas(args) -> int:
    insp = open_inspector(args.db)
    try:
        changes = diff_schema(insp, target_schema(insp.dialect))
        if changes.empty:
            print("schema up to date")
        stmts = apply_changes(insp, changes, dry_run=args.dry_run)
        for s in stmts:
            print(("would apply: " if args.dry_run else "applied: ") + " ".join(s.split()))
        for table in changes.extra_tables:
            print(f"extra table (kept): {table}")
        for table, col in changes.extra_columns:
            print(f"extra column (kept): {table}.{col}")
    finally:
        insp.close()
    return 0


def _cmd_show_foreign_keys(args) -> int:
    insp = open_inspector(args.db)
    try:
        for fk in insp.foreign_keys():
            print(f"{fk.table}.{fk.column} -> {fk.ref_table}.{fk.ref_column}")
    finally:
        insp.close()
    return 0


def register(sub: argparse._SubParsersAction) -> None:
    p = sub.add_parser("postgres", help="AV state database admin")
    psub = p.add_subparsers(dest="pg_command", metavar="subcommand", required=True)

    for name, func, helptext in [
        ("show-tables", _cmd_show_tables, "list tables with row counts"),
        ("show-schemas", _cmd_show_schemas, "show per-table column schemas"),
        ("show-foreign-keys", _cmd_show_foreign_keys, "list foreign-key relationships"),
    ]:
        sp = psub.add_parser(name, help=helptext)
        sp.add_argument("--db", required=True, help="postgres:// DSN or sqlite path")
        sp.set_defaults(func=func)

    up = psub.add_parser(
        "update-schemas", help="diff live schema vs the AV state schema; apply additive DDL"
    )
    up.add_argument("--db", required=True, help="postgres:// DSN or sqlite path")
    up.add_argument("--dry-run", action="store_true", help="print DDL without applying")
    up.set_defaults(func=_cmd_update_schemas)
