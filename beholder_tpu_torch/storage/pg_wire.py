"""PostgreSQL v3 wire-protocol client, written from scratch (the port's own
copy of the reference's ``storage/pg_wire.py``).

The original daemon's storage is Postgres via triton-core's ``Storage()``
(index.js:19,42; the ``pg`` package). The port needs no Postgres client library:
like the AMQP stack in :mod:`beholder_tpu_torch.mq`, the transport is built
from the public protocol spec (PostgreSQL docs, "Frontend/Backend
Protocol") on the standard library alone.

Implemented subset (everything the beholder path needs):

- startup + authentication: trust, cleartext, MD5, and SCRAM-SHA-256
  (the PG14+ default, RFC 5802/7677 client side with server-signature
  verification),
- the extended query protocol (Parse/Bind/Execute/Sync) with text-format
  parameters — real parameterization, no string splicing,
- simple query ('Q') for DDL,
- error surfacing with the server's SQLSTATE + message.

The client is synchronous and single-connection; the service's handlers
are sequential per consumer (like the original daemon's event loop), so one
connection guarded by a lock matches the actual concurrency.
"""

from __future__ import annotations

import base64
import hashlib
import hmac
import os
import socket
import struct
import threading
from dataclasses import dataclass
from urllib.parse import unquote, urlparse

DEFAULT_PORT = 5432


class PostgresError(RuntimeError):
    """Server-reported error (severity, SQLSTATE code, message)."""

    def __init__(self, fields: dict[str, str]):
        self.fields = fields
        self.sqlstate = fields.get("C", "")
        super().__init__(
            f"{fields.get('S', 'ERROR')} {self.sqlstate}: {fields.get('M', '?')}"
        )


class ProtocolError(RuntimeError):
    pass


@dataclass
class PgUrl:
    host: str
    port: int
    user: str
    password: str
    database: str

    @classmethod
    def parse(cls, url: str) -> "PgUrl":
        parsed = urlparse(url)
        if parsed.scheme not in ("postgres", "postgresql", ""):
            raise ValueError(f"unsupported scheme {parsed.scheme!r} in {url!r}")
        db = unquote(parsed.path[1:]) if len(parsed.path) > 1 else "postgres"
        return cls(
            host=parsed.hostname or "127.0.0.1",
            port=parsed.port or DEFAULT_PORT,
            user=unquote(parsed.username) if parsed.username else "postgres",
            password=unquote(parsed.password) if parsed.password else "",
            database=db,
        )


def _message(tag: bytes, payload: bytes) -> bytes:
    return tag + struct.pack(">I", len(payload) + 4) + payload


def _cstr(s: str) -> bytes:
    return s.encode() + b"\x00"


class PgConnection:
    """One authenticated connection; thread-safe via an internal lock."""

    def __init__(self, url: str, connect_timeout: float = 10.0):
        self.url = PgUrl.parse(url)
        self._lock = threading.Lock()
        self._sock: socket.socket | None = None
        self._buf = b""
        self._timeout = connect_timeout

    # -- lifecycle ----------------------------------------------------------
    def connect(self) -> None:
        sock = socket.create_connection(
            (self.url.host, self.url.port), timeout=self._timeout
        )
        sock.settimeout(self._timeout)
        # as libpq does: a query is one write, but the SCRAM exchange and a
        # server's pipelined replies must not wait on Nagle's algorithm
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._buf = b""  # a poisoned/closed connection may be re-connected
        self._sock = sock
        params = (
            struct.pack(">I", 196608)  # protocol 3.0
            + _cstr("user")
            + _cstr(self.url.user)
            + _cstr("database")
            + _cstr(self.url.database)
            + b"\x00"
        )
        sock.sendall(struct.pack(">I", len(params) + 4) + params)
        self._authenticate()
        # drain ParameterStatus/BackendKeyData until ReadyForQuery
        while True:
            tag, payload = self._recv()
            if tag == b"Z":
                return
            if tag == b"E":
                raise PostgresError(_error_fields(payload))
            # 'S' (parameter status), 'K' (backend key data), 'N' (notice)

    def close(self) -> None:
        with self._lock:
            if self._sock is not None:
                try:
                    self._sock.sendall(_message(b"X", b""))  # Terminate
                except OSError:
                    pass
                self._sock.close()
                self._sock = None

    @property
    def closed(self) -> bool:
        return self._sock is None

    # -- queries ------------------------------------------------------------
    def query(
        self, sql: str, params: tuple = ()
    ) -> tuple[list[str], list[tuple[str | None, ...]], str]:
        """Run one parameterized statement via the extended protocol.

        Returns (column names, rows of text values, command tag). ``None``
        cells are SQL NULLs. Raises :class:`PostgresError` on server error.
        Any I/O error (timeout, reset) POISONS the connection — a partial
        response left in the buffer would otherwise be parsed as the NEXT
        query's result, silently returning wrong rows.
        """
        with self._lock:
            if self._sock is None:
                raise ProtocolError("connection is closed")
            out = bytearray()
            out += _message(b"P", _cstr("") + _cstr(sql) + struct.pack(">H", 0))
            bind = bytearray()
            bind += _cstr("") + _cstr("")  # portal, statement
            bind += struct.pack(">H", 0)  # all params text format
            bind += struct.pack(">H", len(params))
            for p in params:
                if p is None:
                    bind += struct.pack(">i", -1)
                else:
                    raw = str(p).encode()
                    bind += struct.pack(">I", len(raw)) + raw
            bind += struct.pack(">H", 0)  # all results text format
            out += _message(b"B", bytes(bind))
            out += _message(b"D", b"P" + _cstr(""))  # describe portal
            out += _message(b"E", _cstr("") + struct.pack(">I", 0))
            out += _message(b"S", b"")  # sync
            try:
                self._sock.sendall(bytes(out))
                return self._collect()
            except (OSError, TimeoutError) as err:
                self._poison()
                raise ProtocolError(f"connection lost mid-query: {err}") from err
            except ProtocolError:
                # server EOF mid-response surfaces as ProtocolError from
                # _fill(); a partial response may sit in the buffer, so the
                # stream can no longer be trusted — poison here too
                self._poison()
                raise

    def execute(self, sql: str) -> str:
        """Simple-query protocol for DDL; returns the command tag."""
        with self._lock:
            if self._sock is None:
                raise ProtocolError("connection is closed")
            try:
                self._sock.sendall(_message(b"Q", _cstr(sql)))
                return self._collect()[2]
            except (OSError, TimeoutError) as err:
                self._poison()
                raise ProtocolError(f"connection lost mid-query: {err}") from err
            except ProtocolError:
                self._poison()
                raise

    def _poison(self) -> None:
        """Invalidate the connection after an I/O fault; the response
        stream can no longer be trusted to align with requests."""
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None
        self._buf = b""

    # -- internals ----------------------------------------------------------
    def _collect(self):
        columns: list[str] = []
        rows: list[tuple[str | None, ...]] = []
        tag_text = ""
        error: PostgresError | None = None
        while True:
            tag, payload = self._recv()
            if tag == b"T":  # RowDescription
                n = struct.unpack(">H", payload[:2])[0]
                pos = 2
                columns = []
                for _ in range(n):
                    end = payload.index(b"\x00", pos)
                    columns.append(payload[pos:end].decode())
                    pos = end + 1 + 18  # fixed per-field trailer
            elif tag == b"D":  # DataRow
                n = struct.unpack(">H", payload[:2])[0]
                pos = 2
                row: list[str | None] = []
                for _ in range(n):
                    (ln,) = struct.unpack(">i", payload[pos : pos + 4])
                    pos += 4
                    if ln == -1:
                        row.append(None)
                    else:
                        row.append(payload[pos : pos + ln].decode())
                        pos += ln
                rows.append(tuple(row))
            elif tag == b"C":  # CommandComplete
                tag_text = payload.rstrip(b"\x00").decode()
            elif tag == b"E":
                error = PostgresError(_error_fields(payload))
            elif tag == b"Z":  # ReadyForQuery — transaction boundary
                if error is not None:
                    raise error
                return columns, rows, tag_text
            # '1' parse-complete, '2' bind-complete, 'n' no-data,
            # 'N' notice, 'S' parameter status: all skippable

    def _authenticate(self) -> None:
        while True:
            tag, payload = self._recv()
            if tag == b"E":
                raise PostgresError(_error_fields(payload))
            if tag != b"R":
                raise ProtocolError(f"expected auth message, got {tag!r}")
            (code,) = struct.unpack(">I", payload[:4])
            if code == 0:  # AuthenticationOk
                return
            if code == 3:  # cleartext
                self._sock.sendall(_message(b"p", _cstr(self.url.password)))
            elif code == 5:  # MD5
                salt = payload[4:8]
                inner = hashlib.md5(
                    (self.url.password + self.url.user).encode()
                ).hexdigest()
                digest = hashlib.md5(inner.encode() + salt).hexdigest()
                self._sock.sendall(_message(b"p", _cstr("md5" + digest)))
            elif code == 10:  # SASL: pick SCRAM-SHA-256
                mechs = payload[4:].split(b"\x00")
                if b"SCRAM-SHA-256" not in mechs:
                    raise ProtocolError(f"no supported SASL mechanism in {mechs}")
                self._scram()
            else:
                raise ProtocolError(f"unsupported auth method {code}")

    def _scram(self) -> None:
        """SCRAM-SHA-256 (RFC 5802/7677), with server-signature check."""
        nonce = base64.b64encode(os.urandom(18)).decode()
        first_bare = f"n={_scram_name(self.url.user)},r={nonce}"
        client_first = ("n,," + first_bare).encode()
        init = (
            _cstr("SCRAM-SHA-256")
            + struct.pack(">I", len(client_first))
            + client_first
        )
        self._sock.sendall(_message(b"p", init))

        tag, payload = self._recv()
        if tag == b"E":
            raise PostgresError(_error_fields(payload))
        (code,) = struct.unpack(">I", payload[:4])
        if tag != b"R" or code != 11:  # SASLContinue
            raise ProtocolError(f"expected SASLContinue, got {tag!r}/{code}")
        server_first = payload[4:].decode()
        fields = dict(f.split("=", 1) for f in server_first.split(","))
        srv_nonce, salt_b64, iters = fields["r"], fields["s"], int(fields["i"])
        if not srv_nonce.startswith(nonce):
            raise ProtocolError("server nonce does not extend client nonce")

        salted = hashlib.pbkdf2_hmac(
            "sha256", self.url.password.encode(), base64.b64decode(salt_b64), iters
        )
        client_key = hmac.digest(salted, b"Client Key", "sha256")
        stored_key = hashlib.sha256(client_key).digest()
        final_wo_proof = f"c=biws,r={srv_nonce}"
        auth_message = ",".join([first_bare, server_first, final_wo_proof]).encode()
        signature = hmac.digest(stored_key, auth_message, "sha256")
        proof = bytes(a ^ b for a, b in zip(client_key, signature))
        final = f"{final_wo_proof},p={base64.b64encode(proof).decode()}"
        self._sock.sendall(_message(b"p", final.encode()))

        tag, payload = self._recv()
        if tag == b"E":
            raise PostgresError(_error_fields(payload))
        (code,) = struct.unpack(">I", payload[:4])
        if tag != b"R" or code != 12:  # SASLFinal
            raise ProtocolError(f"expected SASLFinal, got {tag!r}/{code}")
        sfields = dict(
            f.split("=", 1) for f in payload[4:].decode().split(",")
        )
        server_key = hmac.digest(salted, b"Server Key", "sha256")
        want = hmac.digest(server_key, auth_message, "sha256")
        if base64.b64decode(sfields.get("v", "")) != want:
            raise ProtocolError("server signature verification failed")

    def _recv(self) -> tuple[bytes, bytes]:
        while len(self._buf) < 5:
            self._fill()
        tag = self._buf[:1]
        (length,) = struct.unpack(">I", self._buf[1:5])
        total = 1 + length
        while len(self._buf) < total:
            self._fill()
        payload = self._buf[5:total]
        self._buf = self._buf[total:]
        return tag, payload

    def _fill(self) -> None:
        chunk = self._sock.recv(65536)
        if not chunk:
            raise ProtocolError("server closed the connection")
        self._buf += chunk


def _scram_name(name: str) -> str:
    return name.replace("=", "=3D").replace(",", "=2C")


def _error_fields(payload: bytes) -> dict[str, str]:
    fields: dict[str, str] = {}
    pos = 0
    while pos < len(payload) and payload[pos : pos + 1] != b"\x00":
        key = chr(payload[pos])
        end = payload.index(b"\x00", pos + 1)
        fields[key] = payload[pos + 1 : end].decode()
        pos = end + 1
    return fields
