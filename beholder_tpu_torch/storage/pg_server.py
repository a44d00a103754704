"""A minimal in-process PostgreSQL wire-protocol server (the port's own copy
of the reference's ``storage/pg_server.py``).

Speaks the v3 protocol subset :mod:`beholder_tpu_torch.storage.pg_wire` uses —
startup, SCRAM-SHA-256 (or cleartext) auth, extended query
(Parse/Bind/Describe/Execute/Sync), simple query — so the from-scratch
client and :class:`PostgresStorage` are tested end-to-end over real TCP
sockets without a Postgres install, exactly like
:mod:`beholder_tpu_torch.mq.server` does for AMQP.

The "SQL engine" executes the fixed statement shapes PostgresStorage
issues (CREATE TABLE / INSERT ... ON CONFLICT / UPDATE / SELECT) against
an in-memory dict; anything unrecognized gets a real ErrorResponse with
SQLSTATE 42601, which doubles as the client's error-path test surface.

Unlike the reference's copy, every connection sets ``TCP_NODELAY`` (as a
Postgres server does): a reply is several small writes, and with Nagle's
algorithm each query waited out the client's delayed ACK.
"""

from __future__ import annotations

import base64
import hashlib
import hmac
import os
import re
import socket
import socketserver
import struct
import threading
import time

SCRAM_ITERATIONS = 4096


class _PgMetrics:
    """Prometheus instrumentation for the test server (extension
    surface: registered only when a registry is handed to
    :class:`PgTestServer`, so the default exposition stays
    byte-identical). Query timings are labelled by statement kind,
    auth timings by outcome — SCRAM's 4096 PBKDF2 iterations make
    auth a visible slice of short-lived-connection workloads."""

    #: sub-ms dict lookups up to PBKDF2-bound auth handshakes
    BUCKETS = (
        1e-5, 2.5e-5, 5e-5, 1e-4, 2.5e-4, 5e-4, 1e-3, 2.5e-3, 5e-3,
        1e-2, 2.5e-2, 0.1,
    )

    def __init__(self, registry):
        from beholder_tpu_torch.metrics import get_or_create

        self.query_seconds = get_or_create(
            registry, "histogram",
            "beholder_pg_query_seconds",
            "Statement execution wall time by statement kind",
            labelnames=["stmt"],
            buckets=self.BUCKETS,
        )
        self.auth_seconds = get_or_create(
            registry, "histogram",
            "beholder_pg_auth_seconds",
            "SCRAM-SHA-256 handshake wall time by outcome",
            labelnames=["outcome"],
            buckets=self.BUCKETS,
        )


def _cstr(s: str) -> bytes:
    return s.encode() + b"\x00"


def _msg(tag: bytes, payload: bytes) -> bytes:
    return tag + struct.pack(">I", len(payload) + 4) + payload


def _error(code: str, message: str) -> bytes:
    payload = (
        b"S" + _cstr("ERROR") + b"C" + _cstr(code) + b"M" + _cstr(message) + b"\x00"
    )
    return _msg(b"E", payload)


def _ready() -> bytes:
    return _msg(b"Z", b"I")


class _Handler(socketserver.BaseRequestHandler):
    def handle(self):  # noqa: C901 - one protocol loop, clearer flat
        server: PgTestServer = self.server.owner  # type: ignore[attr-defined]
        sock = self.request
        # a reply is several small writes (ParseComplete, BindComplete,
        # rows, ReadyForQuery): with Nagle on, each query waits out the
        # client's delayed ACK (about 40 ms on Linux). Postgres itself sets
        # TCP_NODELAY on every connection
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        server.active.add(sock)
        try:
            self._serve(server, sock)
        finally:
            server.active.discard(sock)

    def _serve(self, server: "PgTestServer", sock):
        buf = b""

        def need(n):
            nonlocal buf
            while len(buf) < n:
                chunk = sock.recv(65536)
                if not chunk:
                    raise ConnectionError
                buf += chunk

        def take(n):
            nonlocal buf
            need(n)
            out, buf = buf[:n], buf[n:]
            return out

        try:
            # startup (untagged)
            (length,) = struct.unpack(">I", take(4))
            startup = take(length - 4)
            (version,) = struct.unpack(">I", startup[:4])
            if version != 196608:
                sock.sendall(_error("08P01", f"bad protocol {version}"))
                return
            kv = startup[4:].split(b"\x00")
            params = dict(zip(kv[0:-2:2], kv[1:-2:2]))
            user = params.get(b"user", b"").decode()

            if server.password:
                if not self._auth_scram(sock, take, server, user):
                    return
            sock.sendall(_msg(b"R", struct.pack(">I", 0)))  # AuthenticationOk
            sock.sendall(_msg(b"S", _cstr("server_version") + _cstr("16.0-bh")))
            sock.sendall(_ready())

            pending_sql: str | None = None
            pending_params: tuple = ()
            while True:
                tag = take(1)
                (length,) = struct.unpack(">I", take(4))
                payload = take(length - 4)
                if tag == b"X":
                    return
                if tag == b"Q":
                    sql = payload.rstrip(b"\x00").decode()
                    sock.sendall(server.run_sql(sql, ()))
                    sock.sendall(_ready())
                elif tag == b"P":  # Parse: name, sql, n param types
                    end = payload.index(b"\x00")
                    sql_end = payload.index(b"\x00", end + 1)
                    pending_sql = payload[end + 1 : sql_end].decode()
                    sock.sendall(_msg(b"1", b""))
                elif tag == b"B":  # Bind
                    pos = payload.index(b"\x00") + 1
                    pos = payload.index(b"\x00", pos) + 1
                    (nfmt,) = struct.unpack(">H", payload[pos : pos + 2])
                    pos += 2 + 2 * nfmt
                    (nparams,) = struct.unpack(">H", payload[pos : pos + 2])
                    pos += 2
                    values = []
                    for _ in range(nparams):
                        (ln,) = struct.unpack(">i", payload[pos : pos + 4])
                        pos += 4
                        if ln == -1:
                            values.append(None)
                        else:
                            values.append(payload[pos : pos + ln].decode())
                            pos += ln
                    pending_params = tuple(values)
                    sock.sendall(_msg(b"2", b""))
                elif tag == b"D":
                    pass  # row description is sent with Execute
                elif tag == b"E":
                    sock.sendall(server.run_sql(pending_sql or "", pending_params))
                elif tag == b"S":
                    sock.sendall(_ready())
                elif tag == b"p":
                    sock.sendall(_error("08P01", "unexpected password message"))
                # ignore anything else
        except ConnectionError:
            return

    def _auth_scram(self, sock, take, server: "PgTestServer", user: str) -> bool:
        t0 = time.perf_counter()
        ok = self._auth_scram_inner(sock, take, server, user)
        if server._metrics is not None:
            server._metrics.auth_seconds.observe(
                time.perf_counter() - t0,
                outcome="ok" if ok else "failed",
            )
        return ok

    def _auth_scram_inner(
        self, sock, take, server: "PgTestServer", user: str
    ) -> bool:
        sock.sendall(
            _msg(b"R", struct.pack(">I", 10) + _cstr("SCRAM-SHA-256") + b"\x00")
        )
        tag = take(1)
        (length,) = struct.unpack(">I", take(4))
        payload = take(length - 4)
        if tag != b"p":
            sock.sendall(_error("28000", "expected SASLInitialResponse"))
            return False
        mech_end = payload.index(b"\x00")
        if payload[:mech_end] != b"SCRAM-SHA-256":
            sock.sendall(_error("28000", "unsupported mechanism"))
            return False
        (resp_len,) = struct.unpack(">I", payload[mech_end + 1 : mech_end + 5])
        client_first = payload[mech_end + 5 : mech_end + 5 + resp_len].decode()
        first_bare = client_first.split(",", 2)[2]
        client_nonce = dict(
            f.split("=", 1) for f in first_bare.split(",")
        )["r"]

        salt = server._scram_salt
        srv_nonce = client_nonce + base64.b64encode(os.urandom(9)).decode()
        server_first = (
            f"r={srv_nonce},s={base64.b64encode(salt).decode()},i={SCRAM_ITERATIONS}"
        )
        sock.sendall(
            _msg(b"R", struct.pack(">I", 11) + server_first.encode())
        )

        tag = take(1)
        (length,) = struct.unpack(">I", take(4))
        final = take(length - 4).decode()
        if tag != b"p":
            sock.sendall(_error("28000", "expected SASLResponse"))
            return False
        ffields = dict(f.split("=", 1) for f in final.split(","))
        proof = base64.b64decode(ffields["p"])
        final_wo_proof = final[: final.rindex(",p=")]
        auth_message = ",".join([first_bare, server_first, final_wo_proof]).encode()

        salted = hashlib.pbkdf2_hmac(
            "sha256", server.password.encode(), salt, SCRAM_ITERATIONS
        )
        client_key = hmac.digest(salted, b"Client Key", "sha256")
        stored_key = hashlib.sha256(client_key).digest()
        signature = hmac.digest(stored_key, auth_message, "sha256")
        recovered = bytes(a ^ b for a, b in zip(proof, signature))
        if (
            ffields.get("r") != srv_nonce
            or hashlib.sha256(recovered).digest() != stored_key
        ):
            sock.sendall(_error("28P01", f'password authentication failed for "{user}"'))
            return False

        server_key = hmac.digest(salted, b"Server Key", "sha256")
        server_sig = hmac.digest(server_key, auth_message, "sha256")
        sasl_final = f"v={base64.b64encode(server_sig).decode()}"
        sock.sendall(_msg(b"R", struct.pack(">I", 12) + sasl_final.encode()))
        return True


class PgTestServer:
    """In-process Postgres-wire server over an in-memory media table."""

    COLUMNS = ("id", "name", "creator", "creator_id", "metadata_id", "status")

    def __init__(self, password: str = "", metrics=None):
        #: empty password = trust auth; non-empty = SCRAM-SHA-256
        self.password = password
        #: optional Registry (or Metrics) for query/auth timing series
        self._metrics = (
            _PgMetrics(getattr(metrics, "registry", metrics))
            if metrics is not None
            else None
        )
        self._scram_salt = os.urandom(16)
        self.rows: dict[str, dict] = {}
        self.queries: list[tuple[str, tuple]] = []  # for assertions
        self.active: set = set()  # live client sockets, killed on stop()
        self._server: socketserver.ThreadingTCPServer | None = None
        self.port: int | None = None

    # -- lifecycle ----------------------------------------------------------
    def start(self, port: int = 0) -> int:
        """Listen on ``port`` (0 = ephemeral). Restarting on the same port
        after :meth:`stop` keeps ``rows`` — the crash-recovery tests kill
        and resurrect the server while clients reconnect."""

        class _Srv(socketserver.ThreadingTCPServer):
            allow_reuse_address = True  # same-port restart right after stop

        srv = _Srv(("127.0.0.1", port), _Handler)
        srv.daemon_threads = True
        srv.owner = self  # type: ignore[attr-defined]
        self._server = srv
        self.port = srv.server_address[1]
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        return self.port

    def stop(self) -> None:
        """Stop listening AND sever every live connection (a real crash
        doesn't let handler threads keep answering)."""
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
            self._server = None
        for sock in list(self.active):
            try:
                sock.shutdown(2)  # SHUT_RDWR: wake any blocked recv
            except OSError:
                pass
            try:
                sock.close()
            except OSError:
                pass

    def url(self, user: str = "beholder") -> str:
        auth = f"{user}:{self.password}@" if self.password else f"{user}@"
        return f"postgres://{auth}127.0.0.1:{self.port}/events"

    # -- the "SQL engine" ---------------------------------------------------
    def run_sql(self, sql: str, params: tuple) -> bytes:
        t0 = time.perf_counter()
        out, stmt = self._run_sql(sql, params)
        if self._metrics is not None:
            self._metrics.query_seconds.observe(
                time.perf_counter() - t0, stmt=stmt
            )
        return out

    def _run_sql(self, sql: str, params: tuple) -> tuple[bytes, str]:
        self.queries.append((sql, params))
        flat = " ".join(sql.split())
        try:
            if flat.upper().startswith("CREATE TABLE"):
                return _msg(b"C", _cstr("CREATE TABLE")), "create"
            # transaction statements: the batched-ingest storage hop
            # wraps a drained batch's updates in BEGIN/COMMIT (one
            # commit per batch); the in-memory engine applies rows
            # eagerly, so the control statements just tag-acknowledge
            # (the semantics the idempotent UPDATE replay relies on)
            if flat.upper() in ("BEGIN", "COMMIT", "ROLLBACK"):
                return _msg(b"C", _cstr(flat.upper())), "txn"
            if flat.startswith("INSERT INTO media"):
                row = dict(zip(self.COLUMNS, params))
                self.rows[row["id"]] = row
                return _msg(b"C", _cstr("INSERT 0 1")), "insert"
            if flat.startswith("UPDATE media SET status"):
                status, media_id = params
                row = self.rows.get(media_id)
                if row is None:
                    return _msg(b"C", _cstr("UPDATE 0")), "update"
                row["status"] = status
                return _msg(b"C", _cstr("UPDATE 1")), "update"
            m = re.match(r"SELECT (.+) FROM media WHERE id = \$1", flat)
            if m:
                cols = [c.strip() for c in m.group(1).split(",")]
                row = self.rows.get(params[0])
                out = self._row_description(cols)
                n = 0
                if row is not None:
                    out += self._data_row([row.get(c) for c in cols])
                    n = 1
                return out + _msg(b"C", _cstr(f"SELECT {n}")), "select"
            return (
                _error("42601", f"unrecognized statement: {flat[:80]}"),
                "unrecognized",
            )
        except Exception as err:  # noqa: BLE001 - report, don't die
            return _error("XX000", repr(err)), "error"

    def _row_description(self, cols) -> bytes:
        body = struct.pack(">H", len(cols))
        for c in cols:
            body += _cstr(c) + struct.pack(">IHIHiH", 0, 0, 25, 0xFFFF, -1, 0)
        return _msg(b"T", body)

    def _data_row(self, values) -> bytes:
        body = struct.pack(">H", len(values))
        for v in values:
            if v is None:
                body += struct.pack(">i", -1)
            else:
                raw = str(v).encode()
                body += struct.pack(">I", len(raw)) + raw
        return _msg(b"D", body)
