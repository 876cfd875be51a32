"""A pure-Python PostgreSQL wire-protocol (v3) client (port of
``cosmos_curate_tpu/utils/pg_client.py``; host code, no torch).

Speaks the public frontend/backend protocol over a socket, with no driver:
the StartupMessage, password authentication (cleartext, MD5 and
SCRAM-SHA-256 per RFC 5802 / 7677), the simple-query cycle (Query →
RowDescription / DataRow / CommandComplete → ReadyForQuery) and errors as
``PgError``. Enough for the AV state database (DDL, INSERT / UPDATE,
SELECT with text results); not a general driver. ``quote_literal`` escapes
a value as an SQL literal, since the simple protocol has no bind
parameters.
"""

from __future__ import annotations

import base64
import hashlib
import hmac
import os
import socket
import struct
from dataclasses import dataclass


class PgError(RuntimeError):
    def __init__(self, fields: dict[str, str]) -> None:
        self.fields = fields
        super().__init__(
            f"{fields.get('S', 'ERROR')} {fields.get('C', '')}: {fields.get('M', '')}"
        )


def quote_literal(value) -> str:
    """Escape a Python value as a SQL literal (simple-query protocol has no
    bind parameters)."""
    if value is None:
        return "NULL"
    if isinstance(value, bool):
        return "TRUE" if value else "FALSE"
    if isinstance(value, (int, float)):
        return repr(value)
    s = str(value).replace("'", "''")
    if "\\" in s:
        return "E'" + s.replace("\\", "\\\\") + "'"
    return f"'{s}'"


@dataclass
class QueryResult:
    columns: list[str]
    rows: list[tuple]
    command: str


def parse_dsn(dsn: str) -> dict:
    """postgres:// DSN -> PgConnection kwargs (single source of truth for
    host/port/user/password/database defaults)."""
    import urllib.parse

    u = urllib.parse.urlparse(dsn)
    return dict(
        host=u.hostname or "127.0.0.1",
        port=u.port or 5432,
        user=urllib.parse.unquote(u.username or "postgres"),
        password=urllib.parse.unquote(u.password or ""),
        database=(u.path or "/postgres").lstrip("/") or "postgres",
    )


class PgConnection:
    def __init__(
        self,
        *,
        host: str = "127.0.0.1",
        port: int = 5432,
        user: str = "postgres",
        password: str = "",
        database: str = "postgres",
        timeout_s: float = 30.0,
        query_timeout_s: float = 600.0,
    ) -> None:
        """``timeout_s`` bounds connect+auth; ``query_timeout_s`` bounds each
        statement — generous by default so a lock wait (a normal, transient
        condition) is not misread as a dead connection by retry layers."""
        self._sock = socket.create_connection((host, port), timeout=timeout_s)
        self._query_timeout_s = query_timeout_s
        self._buf = b""
        self.user = user
        self.password = password
        self._startup(user, database)

    # -- wire primitives ---------------------------------------------------

    def _send(self, type_byte: bytes, payload: bytes) -> None:
        self._sock.sendall(type_byte + struct.pack("!I", len(payload) + 4) + payload)

    def _recv_exact(self, n: int) -> bytes:
        while len(self._buf) < n:
            chunk = self._sock.recv(65536)
            if not chunk:
                raise ConnectionError("postgres server closed the connection")
            self._buf += chunk
        out, self._buf = self._buf[:n], self._buf[n:]
        return out

    def _recv_message(self) -> tuple[bytes, bytes]:
        head = self._recv_exact(5)
        type_byte = head[:1]
        (length,) = struct.unpack("!I", head[1:])
        return type_byte, self._recv_exact(length - 4)

    @staticmethod
    def _cstr(payload: bytes, pos: int) -> tuple[str, int]:
        end = payload.index(b"\x00", pos)
        return payload[pos:end].decode(), end + 1

    @staticmethod
    def _error_fields(payload: bytes) -> dict[str, str]:
        fields: dict[str, str] = {}
        pos = 0
        while pos < len(payload) and payload[pos] != 0:
            code = chr(payload[pos])
            val, pos = PgConnection._cstr(payload, pos + 1)
            fields[code] = val
        return fields

    # -- startup & auth ----------------------------------------------------

    def _startup(self, user: str, database: str) -> None:
        params = f"user\x00{user}\x00database\x00{database}\x00\x00".encode()
        payload = struct.pack("!I", 196608) + params  # protocol 3.0
        self._sock.sendall(struct.pack("!I", len(payload) + 4) + payload)
        while True:
            t, body = self._recv_message()
            if t == b"E":
                raise PgError(self._error_fields(body))
            if t == b"R":
                (code,) = struct.unpack("!I", body[:4])
                if code == 0:  # AuthenticationOk
                    continue
                if code == 3:  # cleartext password
                    self._send(b"p", self.password.encode() + b"\x00")
                elif code == 5:  # MD5
                    salt = body[4:8]
                    inner = hashlib.md5(
                        (self.password + self.user).encode()
                    ).hexdigest()
                    digest = hashlib.md5(inner.encode() + salt).hexdigest()
                    self._send(b"p", f"md5{digest}".encode() + b"\x00")
                elif code == 10:  # SASL: pick SCRAM-SHA-256
                    self._scram(body[4:])
                else:
                    raise PgError({"M": f"unsupported auth method {code}"})
            elif t == b"Z":  # ReadyForQuery
                return
            # S (ParameterStatus), K (BackendKeyData), N (Notice): ignore

    def _scram(self, mechanisms: bytes) -> None:
        names = [m for m in mechanisms.split(b"\x00") if m]
        if b"SCRAM-SHA-256" not in names:
            raise PgError({"M": f"no supported SASL mechanism in {names}"})
        nonce = base64.b64encode(os.urandom(18)).decode()
        first_bare = f"n={self.user},r={nonce}"
        client_first = "n,," + first_bare
        init = b"SCRAM-SHA-256\x00" + struct.pack("!I", len(client_first)) + client_first.encode()
        self._send(b"p", init)

        t, body = self._recv_message()
        if t == b"E":
            raise PgError(self._error_fields(body))
        (code,) = struct.unpack("!I", body[:4])
        if code != 11:
            raise PgError({"M": f"expected SASLContinue, got {code}"})
        server_first = body[4:].decode()
        parts = dict(kv.split("=", 1) for kv in server_first.split(","))
        server_nonce, salt_b64, iterations = parts["r"], parts["s"], int(parts["i"])
        if not server_nonce.startswith(nonce):
            raise PgError({"M": "SCRAM server nonce does not extend client nonce"})

        salted = hashlib.pbkdf2_hmac(
            "sha256", self.password.encode(), base64.b64decode(salt_b64), iterations
        )
        client_key = hmac.new(salted, b"Client Key", hashlib.sha256).digest()
        stored_key = hashlib.sha256(client_key).digest()
        without_proof = f"c={base64.b64encode(b'n,,').decode()},r={server_nonce}"
        auth_message = f"{first_bare},{server_first},{without_proof}".encode()
        client_sig = hmac.new(stored_key, auth_message, hashlib.sha256).digest()
        proof = bytes(a ^ b for a, b in zip(client_key, client_sig))
        final = f"{without_proof},p={base64.b64encode(proof).decode()}"
        self._send(b"p", final.encode())

        t, body = self._recv_message()
        if t == b"E":
            raise PgError(self._error_fields(body))
        (code,) = struct.unpack("!I", body[:4])
        if code != 12:
            raise PgError({"M": f"expected SASLFinal, got {code}"})
        server_final = dict(kv.split("=", 1) for kv in body[4:].decode().split(","))
        server_key = hmac.new(salted, b"Server Key", hashlib.sha256).digest()
        expected = hmac.new(server_key, auth_message, hashlib.sha256).digest()
        if base64.b64decode(server_final.get("v", "")) != expected:
            raise PgError({"M": "SCRAM server signature verification failed"})

    # -- queries -----------------------------------------------------------

    def execute(self, sql: str, params: tuple = ()) -> QueryResult:
        """Simple-query execution. ``params`` substitute ``%s`` placeholders
        as escaped literals (client-side; the simple protocol has no binds).
        Only the literal token ``%s`` is a placeholder — other ``%``
        characters (LIKE patterns, modulo) pass through untouched."""
        if params:
            parts = sql.split("%s")
            if len(parts) - 1 != len(params):
                raise ValueError(
                    f"query has {len(parts) - 1} %s placeholders, got {len(params)} params"
                )
            sql = "".join(
                part + (quote_literal(params[i]) if i < len(params) else "")
                for i, part in enumerate(parts)
            )
        self._sock.settimeout(self._query_timeout_s)
        self._send(b"Q", sql.encode() + b"\x00")
        columns: list[str] = []
        rows: list[tuple] = []
        command = ""
        error: PgError | None = None
        while True:
            t, body = self._recv_message()
            if t == b"T":
                (n,) = struct.unpack("!H", body[:2])
                pos = 2
                columns = []
                for _ in range(n):
                    name, pos = self._cstr(body, pos)
                    pos += 18  # table oid, attnum, type oid, len, mod, fmt
                    columns.append(name)
            elif t == b"D":
                (n,) = struct.unpack("!H", body[:2])
                pos = 2
                row = []
                for _ in range(n):
                    (length,) = struct.unpack("!i", body[pos : pos + 4])
                    pos += 4
                    if length == -1:
                        row.append(None)
                    else:
                        row.append(body[pos : pos + length].decode())
                        pos += length
                rows.append(tuple(row))
            elif t == b"C":
                command, _ = self._cstr(body, 0)
            elif t == b"E":
                error = PgError(self._error_fields(body))
            elif t == b"Z":
                if error is not None:
                    raise error
                return QueryResult(columns, rows, command)
            # N (notice), I (empty query), S: ignored

    def close(self) -> None:
        try:
            self._send(b"X", b"")
        except OSError:
            pass
        self._sock.close()

    def __enter__(self) -> "PgConnection":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
