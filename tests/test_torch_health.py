"""The port's operator surfaces against the reference's: ``httpd``,
``health`` (the health server, the supervisor, the checks
``health_from_config`` wires), the ``metrics.Metrics`` set and its HTTP
server, ``config`` (with and without PyYAML) and the pino ``log``
lines."""

import io
import json
import logging
import sys
import time
import urllib.request
from types import SimpleNamespace

import pytest

import beholder_tpu.config as ref_config
import beholder_tpu.health as ref_health
import beholder_tpu.httpd as ref_httpd
import beholder_tpu.log as ref_log
import beholder_tpu.metrics as ref_metrics
import beholder_tpu_torch.config as port_config
import beholder_tpu_torch.health as port_health
import beholder_tpu_torch.httpd as port_httpd
import beholder_tpu_torch.log as port_log
import beholder_tpu_torch.metrics as port_metrics
from beholder_tpu_torch.mq import InMemoryBroker
from beholder_tpu_torch.service import BeholderService
from beholder_tpu_torch.storage import MemoryStorage

REF = SimpleNamespace(name="ref", config=ref_config, health=ref_health, httpd=ref_httpd,
                      log=ref_log, metrics=ref_metrics)
PORT = SimpleNamespace(name="port", config=port_config, health=port_health, httpd=port_httpd,
                       log=port_log, metrics=port_metrics)
BOTH = pytest.mark.parametrize("impl", [REF, PORT], ids=["ref", "port"])


def get(port, path):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=5) as resp:
            return resp.status, resp.headers.get("Content-Type"), resp.read()
    except urllib.error.HTTPError as err:
        return err.code, err.headers.get("Content-Type"), err.read()


def wait_for(predicate, timeout=5.0, interval=0.01):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if predicate():
            return True
        time.sleep(interval)
    return False


# -- httpd ---------------------------------------------------------------------

def _serve(impl):
    """One request of each route kind; status, type and body of each."""

    def plain():
        return 200, "text/plain", b"plain"

    def query(q):
        return 200, "application/json", json.dumps(q, sort_keys=True).encode()

    query.wants_query = True
    server = impl.httpd.serve_routes({"/p": plain, "/q": query}, 0)
    try:
        port = server.server_address[1]
        return [get(port, path)[:3] for path in ("/p", "/q?since=3&limit=x&since=4", "/q",
                                                 "/missing")]
    finally:
        server.shutdown()
        server.server_close()


def test_serve_routes_answers_like_the_reference():
    got, want = _serve(PORT), _serve(REF)
    assert [g[:2] for g in got] == [w[:2] for w in want]
    assert [g[2] for g in got[:3]] == [w[2] for w in want[:3]]
    assert got[3][0] == 404


# -- the health server and its checks -----------------------------------------

def _health_round(impl):
    server = impl.health.HealthServer()
    state = {"ok": True}
    server.add_check("thing", lambda: state["ok"])
    server.add_check("detail", lambda: {"shards": 2})
    port = server.start()
    out = []
    try:
        for flip in (True, False):
            state["ok"] = flip
            code, ctype, body = get(port, "/healthz")
            body = json.loads(body)
            assert body.pop("uptime_s") >= 0
            out.append((code, ctype, body))
        server.add_check("boom", lambda: 1 / 0)
        out.append(json.loads(get(port, "/healthz")[2])["checks"]["boom"])
        out.append(get(port, "/readyz")[:2])
        server.set_ready(True)
        out.append(get(port, "/readyz"))
    finally:
        server.close()
    return out


def test_health_server_answers_like_the_reference():
    assert _health_round(PORT) == _health_round(REF)


class FlakyFactory:
    def __init__(self, failures):
        self.failures, self.builds, self.closed = failures, 0, []

    def __call__(self):
        self.builds += 1
        if self.builds <= self.failures:
            raise ConnectionError(f"boot failure {self.builds}")
        factory = self
        return SimpleNamespace(alive=True, close=lambda: factory.closed.append(1))


@BOTH
def test_supervisor_restarts_and_recycles(impl):
    factory = FlakyFactory(failures=2)
    sup = impl.health.Supervisor(factory, backoff_s=0.01, backoff_max_s=0.02,
                                 probe_interval_s=0.01)
    sup.start()
    try:
        assert wait_for(lambda: sup.service is not None)
        assert sup.restarts == 2 and factory.builds == 3
    finally:
        sup.stop()
    assert factory.closed == [1]
    alive = {"v": False}
    sup = impl.health.Supervisor(FlakyFactory(0), liveness=lambda s: alive["v"],
                                 backoff_s=0.01, probe_interval_s=0.01, liveness_grace_s=0.03)
    sup.start()
    try:
        assert wait_for(lambda: sup.restarts >= 1)  # recycled on sustained liveness failure
    finally:
        sup.stop()
    give_up = impl.health.Supervisor(FlakyFactory(10), backoff_s=0.001, max_restarts=2)
    give_up.run()  # returns after giving up
    assert give_up.restarts == 3


def _service(data, **kw):
    broker, db = InMemoryBroker(), MemoryStorage()
    service = BeholderService(port_config.ConfigNode(data), broker, db, device="cpu", **kw)
    service.start()
    return service, broker


def test_health_from_config_wires_broker_db_slo_and_cluster():
    base = {"keys": {"trello": {"key": "K", "token": "T"}}}
    assert port_health.health_from_config(
        port_config.ConfigNode({**base, "instance": {}}), None) is None
    service, broker = _service({**base, "instance": {
        "health": {"enabled": True}, "slo": {"enabled": True},
        "cluster": {"enabled": True}}})
    server = port_health.health_from_config(service.config, service)
    try:
        code, _, body = get(server.port, "/healthz")
        checks = json.loads(body)["checks"]
        assert code == 200 and set(checks) == {"broker", "db", "cluster", "slo"}
        assert checks["cluster"]["detail"] == "cluster configured; no scheduler attached"
        assert get(server.port, "/readyz")[0] == 200
        service.cluster_scheduler = SimpleNamespace(
            health_snapshot=lambda: {"down": ["decode-1"], "workers": {}})
        code, _, body = get(server.port, "/healthz")
        assert code == 503
        assert "decode-1" in json.loads(body)["checks"]["cluster"]["detail"]
        service.cluster_scheduler = None
        broker.close()  # a lost connection
        code, _, body = get(server.port, "/healthz")
        checks = json.loads(body)["checks"]
        assert code == 503 and checks["broker"]["ok"] is False and checks["db"]["ok"] is True
    finally:
        server.close()
        service.close()


@BOTH
def test_slo_check_degrades_on_fast_burn(impl):
    server = impl.health.HealthServer()
    burning = {"v": False}
    tracker = SimpleNamespace(health=lambda: (not burning["v"], {"burn_fast": 3.0}))
    impl.health.add_slo_check(server, lambda: tracker)
    port = server.start()
    try:
        assert get(port, "/healthz")[0] == 200
        burning["v"] = True
        code, _, body = get(port, "/healthz")
        assert code == 503 and "burn_fast" in json.loads(body)["checks"]["slo"]["detail"]
    finally:
        server.close()


# -- the Metrics set -----------------------------------------------------------

def _metrics_round(impl):
    m = impl.metrics.Metrics()
    m.add_route("/extra", lambda: (200, "application/json", b"{}"))
    port = m.expose(0)
    try:
        for status in ("downloading", "converting", 'we"ird'):
            m.progress_updates_total.labels(status=status).inc()
        bound = m.progress_updates_total.labels(status="downloading")
        bound.inc(2)
        m.trello_comments_total.inc()
        hist = m.registry.histogram("t_seconds", "timed", labelnames=["op"])
        with hist.time(op="x"):
            pass
        m.add_route("/late", lambda: (200, "text/plain", b"late"))
        return [get(port, p) for p in ("/metrics", "/", "/extra", "/late")], hist.count(op="x")
    finally:
        m.close()


def test_metrics_server_serves_the_reference_bytes():
    (got, got_n), (want, want_n) = _metrics_round(PORT), _metrics_round(REF)
    strip = lambda answers: [(c, t, b"\n".join(line for line in body.split(b"\n")
                                                 if not line.startswith(b"t_seconds_sum")))
                             for c, t, body in answers]
    assert strip(got) == strip(want)
    assert got_n == want_n == 1
    assert got[0][1] == port_metrics.CONTENT_TYPE
    assert b'beholder_progress_updates_total{status="downloading"} 3' in got[0][2]
    with pytest.raises(ValueError):
        port_metrics.Metrics().progress_updates_total.labels(bogus="x")
    m = port_metrics.Metrics()
    assert m.port is None
    assert m.expose(0) == m.port
    m.close()
    assert m.port is None


# -- config --------------------------------------------------------------------

CONFIG = {"keys": {"trello": {"key": "k", "token": "t"}},
          "instance": {"flow_ids": {"deployed": "list-deployed"},
                       "telegram": {"enabled": True, "channel": "@c"}}}


def test_config_loads_yaml_like_the_reference(tmp_path, monkeypatch):
    import yaml

    (tmp_path / "events.yaml").write_text(yaml.safe_dump(CONFIG))
    want = ref_config.Config.load("events", search_paths=[tmp_path])
    got = port_config.Config.load("events", search_paths=[tmp_path])
    assert got.to_dict() == want.to_dict()
    assert got.keys.trello.key == "k" and got.get("instance.telegram.enabled") is True
    assert got.get("instance.emby.host", "none") == "none"
    with pytest.raises(AttributeError):
        got.keys = 1
    monkeypatch.setenv("BEHOLDER_CONFIG", str(tmp_path / "missing.yaml"))
    with pytest.raises(FileNotFoundError):
        port_config.Config.load("events", search_paths=[])


def test_config_without_pyyaml_reads_json_and_names_pyyaml(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "yaml", None)
    (tmp_path / "events.yaml").write_text(json.dumps(CONFIG))
    monkeypatch.setenv("BEHOLDER_CONFIG", str(tmp_path / "events.yaml"))
    assert port_config.Config.load("events").to_dict() == CONFIG
    (tmp_path / "events.yaml").write_text("keys:\n  trello: {key: k}\n")
    with pytest.raises(ImportError, match="PyYAML"):
        port_config.Config.load("events")


def test_dyn_and_no_trello_match_the_reference(monkeypatch):
    for env in ({}, {"RABBITMQ_HOST": "mq", "RABBITMQ_PORT": "5673"},
                {"DNS_PREFIX": "prod.svc"}, {"RABBITMQ_URL": "amqp://u:p@h:1/v"}):
        for key in ("RABBITMQ_HOST", "RABBITMQ_PORT", "DNS_PREFIX", "RABBITMQ_URL"):
            monkeypatch.delenv(key, raising=False)
        for key, value in env.items():
            monkeypatch.setenv(key, value)
        for service in ("rabbitmq", "postgres", "emby", "other-svc"):
            assert port_config.dyn(service) == ref_config.dyn(service)
    for value in ("", "1"):
        monkeypatch.setenv("NO_TRELLO", value)
        assert port_config.no_trello() == ref_config.no_trello() == bool(value)


# -- log -----------------------------------------------------------------------

@BOTH
def test_pino_lines(impl):
    stream = io.StringIO()
    logger = logging.getLogger(f"torch_health.pino.{impl.name}")
    logger.handlers.clear()
    logger = impl.log.get_logger(f"torch_health.pino.{impl.name}", stream=stream)
    logger.info("hello %s", "world")
    impl.log.bind(logger, job="x").warning("bound", extra={"fields": {"n": 1}})
    try:
        raise KeyError("boom")
    except KeyError:
        logger.exception("failed")
    lines = [json.loads(line) for line in stream.getvalue().splitlines()]
    for line in lines:
        assert isinstance(line.pop("time"), int)
        line.pop("name")
    expected = [{"level": 30, "msg": "hello world"}, {"level": 40, "msg": "bound", "job": "x"},
                {"level": 50, "msg": "failed", "err": "KeyError('boom')"}]
    assert lines == expected
