"""The port's tail-based trace retention and regression sentinel against the
JAX reference's.

The same events go through both packages' :class:`TraceVault` and
:class:`Sentinel` (fake clocks, injected ``ts_us``, no sleeps) and must give
equal results: the vault's keep reasons, index, lookups, dump (with its
shift rotation) and route bodies byte for byte; the sentinel's check
records, verdicts, hysteresis, incidents, snapshot and route body; the
``beholder_retention_*`` and ``beholder_sentinel_*`` exposition text; the
``/healthz`` sentinel check over HTTP; the ``trace_ref`` joins (the SLO
tracker's worst request, histogram exemplars); the httpd prefix routes; the
config knobs. Serving with both listeners armed is held bitwise against
serving without them on the port's batcher (a tiny model), and the port's
own events, fed to both vaults, give equal indexes.

Left out: the artifact's ``retention`` block (``tests/test_torch_artifact.
py`` holds it) and the perf-gate band (``tests/test_retention.py:752``),
which waits for the port's perf gate."""

import json
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import beholder_tpu.health as ref_health
import beholder_tpu.metrics as ref_metrics
import beholder_tpu.obs as ref_obs
import beholder_tpu_torch.health as port_health
import beholder_tpu_torch.metrics as port_metrics
import beholder_tpu_torch.obs as port_obs
from beholder_tpu.config import ConfigNode as RefConfigNode
from beholder_tpu_torch.config import ConfigNode

IMPLS = {
    "ref": dict(obs=ref_obs, metrics=ref_metrics, health=ref_health, config=RefConfigNode),
    "port": dict(obs=port_obs, metrics=port_metrics, health=port_health, config=ConfigNode),
}
US = 1_000_000
NOW = 1_700_000_000.0


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The serving case runs many small ops on the port side: one intra-op
    thread keeps it from spinning beside the suite's other workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def same(fn):
    """``fn(impl)`` for the reference and the port, asserted equal; returns
    the port's."""
    want, got = fn(IMPLS["ref"]), fn(IMPLS["port"])
    assert got == want
    return got


def clock():
    return NOW


# synthetic request lifecycles: gid-keyed, one trace per request


def _claim(key, ts_us, trace, slot=0, **extra):
    return {"name": "req.claim", "ph": "i", "ts_us": ts_us, "trace_id": trace,
            "args": {"gid": key, "slot": slot, **extra}}


def _admit(ts_us, dur_us, trace, slot=0):
    return {"name": "admit", "ph": "X", "ts_us": ts_us, "dur_us": dur_us, "trace_id": trace,
            "args": {"slot": slot}}


def _retire(key, ts_us, trace, outcome="ok", tokens=4):
    return {"name": "req.retire", "ph": "i", "ts_us": ts_us, "trace_id": trace,
            "args": {"gid": key, "tokens": tokens, "outcome": outcome}}


def _lifecycle(key, ttft_us=100_000, outcome="ok", start_us=0):
    trace = f"tr-{key}"
    return [_claim(key, start_us, trace), _admit(start_us, ttft_us, trace),
            _retire(key, start_us + ttft_us + 50_000, trace, outcome)]


def _feed(listeners, events):
    for event in events:
        for listener in listeners:
            listener(json.loads(json.dumps(event)))


def _slice(name, bucket, dur_s, worker="w1"):
    return {"name": name, "ph": "X", "ts_us": bucket * US + 1, "dur_us": dur_s * US,
            "args": {"worker": worker}}


def _vault(impl, slo=None, registry=None, **cfg):
    obs = impl["obs"]
    return obs.TraceVault(obs.RetentionConfig(**cfg), slo=slo, registry=registry, clock=clock)


def _tracker(impl, **cfg):
    obs = impl["obs"]
    return obs.SLOTracker(obs.SLOConfig(**cfg), clock=clock)


def _recovered(key, trace, ts_us):
    return {"name": "req.recovered", "ph": "i", "ts_us": ts_us, "trace_id": trace,
            "args": {"gid": key, "worker": "decode-1", "reason": "kill"}}


# -- keep predicates, bounds, incidents ---------------------------------------

KEEPS = {
    # name: (vault config, tracker config or None, tracker pre-observations, events)
    "healthy_dropped": (
        {}, dict(ttft_ms=30_000.0, tpot_ms=10_000.0), 0, _lifecycle("g-ok")),
    "bad_outcomes": (
        {}, None, 0,
        _lifecycle("g-p", outcome="Preempted") + _lifecycle("g-d", outcome="Dropped",
                                                            start_us=5 * US)
        + _lifecycle("g-x", outcome="deadline_exceeded", start_us=10 * US)
        + _lifecycle("g-odd", outcome="weird", start_us=12 * US)),
    "req_dropped_instant": (
        {}, None, 0,
        [_claim("g-lost", 0, "tr-lost"),
         {"name": "req.dropped", "ph": "i", "ts_us": 2 * US, "trace_id": "tr-lost",
          "args": {"gid": "g-lost", "reason": "recovery_limit"}}]),
    "slo_violation": (
        {}, dict(ttft_ms=50.0, tpot_ms=10_000.0), 0, _lifecycle("g-slow", ttft_us=100_000)),
    "recovery_leg": (
        {}, None, 0,
        [_claim("g-rec", 0, "tr-rec"), _recovered("g-rec", "tr-rec", 1 * US),
         _claim("g-rec", 2 * US, "tr-rec2", worker="decode-0"), _admit(2 * US, 100_000, "tr-rec2"),
         _retire("g-rec", 3 * US, "tr-rec2")]),
    "p99_tail": (
        {"tail_quantile": 0.9}, dict(ttft_ms=30_000.0, tpot_ms=10_000.0), 20,
        _lifecycle("g-tail", ttft_us=1_000_000)),
    "p99_tail_abstains": (
        {"tail_quantile": 0.9}, dict(ttft_ms=30_000.0, tpot_ms=10_000.0), 5,
        _lifecycle("g-few", ttft_us=1_000_000)),
    "p99_tail_snaps_quantile": (
        {"tail_quantile": 0.97}, dict(ttft_ms=30_000.0, tpot_ms=10_000.0), 20,
        _lifecycle("g-snap", ttft_us=1_000_000)),
    "head_sample": (
        {"head_sample_every": 2}, None, 0,
        [e for i in range(4) for e in _lifecycle(f"g-{i}", start_us=i * US)]),
    "count_bound": (
        {"max_traces": 2, "head_sample_every": 1}, None, 0,
        [e for i in range(5) for e in _lifecycle(f"g-{i}", start_us=i * US)]),
    "byte_bound": (
        {"max_bytes": 1000, "head_sample_every": 1}, None, 0,
        [e for i in range(6) for e in _lifecycle(f"g-{i}", start_us=i * US)]),
    "oversized": ({"max_bytes": 10, "head_sample_every": 1}, None, 0, _lifecycle("g-big")),
    "open_cap_and_event_cap": (
        {"max_open": 2, "max_events_per_trace": 2, "head_sample_every": 1}, None, 0,
        [_claim(f"g-o{i}", i, f"tr-o{i}") for i in range(4)]
        + [_admit(10 + i, 5, "tr-o3") for i in range(4)] + [_retire("g-o3", 100, "tr-o3")]),
}


@pytest.mark.parametrize("case", list(KEEPS))
def test_keep_predicates_and_bounds_match_the_reference(case):
    vcfg, tcfg, warm, events = KEEPS[case]

    def run(impl):
        tracker = _tracker(impl, **tcfg) if tcfg is not None else None
        for i in range(warm):
            tracker.observe(ttft_s=0.01, key=i)
        scopes = set(tracker._digests) if tracker is not None else None
        vault = _vault(impl, slo=tracker, **vcfg)
        _feed([vault.on_event], events)
        if tracker is not None:
            assert set(tracker._digests) == scopes  # a read-only probe
        index = vault.index()
        refs = {t["key"]: vault.trace_ref(t["key"]) for t in index["traces"]}
        refs.update({t["trace_id"]: vault.trace_ref(t["trace_id"]) for t in index["traces"]})
        return index, refs, vault.bytes, vault.artifact_summary(), vault.trace_ref("g-0")

    index, refs, nbytes, summary, _ = same(run)
    reasons = [t["reasons"] for t in index["traces"]]
    expect = {
        "healthy_dropped": [],
        "bad_outcomes": [["outcome:Preempted"], ["outcome:Dropped"],
                         ["outcome:deadline_exceeded"], ["outcome:weird"]],
        "req_dropped_instant": [["outcome:dropped"]],
        "slo_violation": [["slo_bad"]],
        "p99_tail": [["p99_tail"]],
        "p99_tail_abstains": [],
        "p99_tail_snaps_quantile": [["p99_tail"]],
        "head_sample": [["head_sample"]] * 2,
        "count_bound": [["head_sample"]] * 2,
        "oversized": [["head_sample"]],
    }
    if case in expect:
        assert reasons == expect[case]
    if case == "recovery_leg":
        (kept,) = index["traces"]
        assert "recovery" in kept["reasons"]
        assert kept["timeline"]["recovered"] is True and kept["timeline"]["legs"] == 2
    if case == "count_bound":
        assert index["evicted"] == 3 and [t["key"] for t in index["traces"]] == ["g-3", "g-4"]
    if case == "byte_bound":
        assert nbytes <= 1000 and 0 < index["resident"] < 6
    if case == "oversized":
        assert index["resident"] == 1 and nbytes > 10
    if case == "open_cap_and_event_cap":
        assert index["traces"][0]["events"] == 2
    assert summary["evaluated"] == float(index["evaluated"])


def test_vault_metrics_match_the_reference():
    def run(impl):
        registry = impl["metrics"].Metrics().registry
        before = registry.render()
        vault = _vault(impl, registry=registry, head_sample_every=1)
        _feed([vault.on_event], _lifecycle("g-0") + _lifecycle("g-1", start_us=US))
        vault.open_incident("manual")
        return before, registry.render()

    before, text = same(run)
    assert "beholder_retention" not in before
    assert "beholder_retention_evaluated_total 2" in text
    assert 'beholder_retention_kept_total{reason="head_sample"} 2' in text
    assert "beholder_retention_vault_traces 2" in text
    assert "beholder_retention_incidents_total 1" in text


def test_incident_lifecycle_matches_the_reference():
    def run(impl):
        vault = _vault(impl, incident_budget=2)
        opened = vault.open_incident("test: manual", explanation={"verdict": "x"})
        again = vault.open_incident("another")
        _feed([vault.on_event], [e for i in range(3) for e in _lifecycle(f"g-{i}",
                                                                          start_us=i * US)])
        mid = vault.index()
        closed = vault.close_incident()
        none = vault.close_incident()
        reopened = vault.open_incident("again")
        return opened["id"], again["id"], mid, closed, none, reopened, vault.index()

    opened, again, mid, closed, none, reopened, index = same(run)
    assert opened == again == "inc-1"
    assert len(mid["traces"]) == 2 and all(t["incident"] == "inc-1" for t in mid["traces"])
    assert closed["trace_ids"] == [t["id"] for t in mid["traces"]] and none is None
    assert reopened["id"] == "inc-2" and index["incidents"][0]["id"] == "inc-1"


def test_dump_and_shift_rotation_match_the_reference(tmp_path):
    def run(impl):
        root = tmp_path / impl["obs"].__name__
        root.mkdir()
        path = str(root / "vault.jsonl")
        vault = _vault(impl, head_sample_every=1, export_path=path, rotate_keep=2)
        vault.open_incident("open while dumping")
        for gen in range(4):
            _feed([vault.on_event], _lifecycle(f"g-{gen}", start_us=gen * US))
            assert vault.dump() == path
        with pytest.raises(ValueError, match="export_path"):
            _vault(impl).dump()
        return {p.name: p.read_text() for p in sorted(root.iterdir())}

    files = same(run)
    assert sorted(files) == ["vault.jsonl", "vault.jsonl.1", "vault.jsonl.2"]
    head = json.loads(files["vault.jsonl"].splitlines()[0])
    assert head["name"] == "trace.vault" and head["kept"] == 4
    assert json.loads(files["vault.jsonl.1"].splitlines()[0])["kept"] == 3


# -- routes over HTTP (the httpd prefix dispatch) ------------------------------


def _get(port, path):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}") as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as err:
        return err.code, err.read()


def test_trace_routes_match_the_reference_over_http():
    def run(impl):
        vault = _vault(impl, head_sample_every=1)
        _feed([vault.on_event], _lifecycle("g-0") + _lifecycle("g-1", start_us=US))
        vault_id = vault.trace_ref("g-0")
        metrics = impl["metrics"].Metrics()
        metrics.add_route("/debug/traces", vault.index_route())
        metrics.add_route("/debug/traces/", vault.trace_route())
        port = metrics.expose(0)
        try:
            got = [_get(port, p) for p in ("/debug/traces", f"/debug/traces/{vault_id}",
                                           "/debug/traces/nope", "/debug/sentinel")]
            exposition = _get(port, "/metrics")[1].decode() == metrics.registry.render()
        finally:
            metrics.close()
        return vault_id, got, exposition

    vault_id, got, exposition = same(run)
    assert [code for code, _ in got] == [200, 200, 404, 404]
    assert json.loads(got[0][1])["schema"] == "beholder-trace-vault"
    doc = json.loads(got[1][1])
    assert doc["traceEvents"] and doc["vault"]["id"] == vault_id
    assert exposition


def test_debug_routes_absent_by_default():
    metrics = port_metrics.Metrics()
    port = metrics.expose(0)
    try:
        for path in ("/debug/traces", "/debug/traces/x", "/debug/sentinel",
                     "/debug/cluster-flight"):
            assert _get(port, path)[0] == 404
    finally:
        metrics.close()


# -- the sentinel ------------------------------------------------------------


def _sentinel_cfg(obs, **kw):
    cfg = dict(bucket_s=1.0, fast_buckets=1, baseline_buckets=4, growth_threshold=1.5,
               min_rate=1e-9, open_after=2, close_after=2, check_every=10**9)
    cfg.update(kw)
    return obs.SentinelConfig(**cfg)


def test_sentinel_hysteresis_and_incident_lifecycle_match_the_reference():
    """An injected 8x phase slowdown: one breaching check neither pages nor
    captures, the second opens the verdict and the incident, two clean
    checks close both."""

    def run(impl):
        obs = impl["obs"]
        vault = _vault(impl)
        registry = impl["metrics"].Metrics().registry
        sentinel = obs.Sentinel(_sentinel_cfg(obs), vault=vault, registry=registry)
        for b in range(4):
            sentinel.on_event(_slice("decode_step", b, 0.1))
            sentinel.on_event(_slice("tick", b, 0.05))
            sentinel.on_event(_slice("device_wait", b, 9.0))
        sentinel.on_event(_slice("decode_step", 4, 0.8))
        sentinel.on_event(_slice("tick", 4, 0.05))
        out = []
        for fast in (None, None, 0.1, None, None):
            if fast is not None:
                sentinel.on_event(_slice("decode_step", 5, fast))
                sentinel.on_event(_slice("tick", 5, 0.05))
            out.append((sentinel.check(), sentinel.health(), sentinel.active,
                        vault.incident, registry.render()))
        code, ctype, body = sentinel.route()()
        return out, sentinel.snapshot(), (code, ctype, body), vault.index()

    out, snap, route, index = same(run)
    (first, h1, a1, inc1, _), (second, h2, a2, inc2, text2) = out[:2]
    assert first["breach"] and first["ratio"] == pytest.approx(8.0)
    assert first["top"]["phase"] == "decode_step" and "w1" in first["verdict"]
    assert a1 is None and inc1 is None and h1[0] is True
    assert second["breach"] and a2["incident"] == "inc-1"
    assert inc2["reason"].startswith("sentinel:") and h2[0] is False
    assert "beholder_sentinel_active 1" in text2
    assert [o[0]["breach"] for o in out[2:]] == [False, False, False]
    assert out[2][2] is not None and out[3][2] is None and out[3][3] is None
    assert index["incidents"][0]["id"] == "inc-1"
    assert snap["checks"] == 5 and snap["breaches"] == 2
    assert route[0] == 200 and json.loads(route[2]) == snap


@pytest.mark.parametrize("case", ["no_baseline", "min_rate_floor", "cadence", "prune",
                                  "new_phase"])
def test_sentinel_edges_match_the_reference(case):
    def run(impl):
        obs = impl["obs"]
        if case == "no_baseline":
            s = obs.Sentinel(_sentinel_cfg(obs))
            first = s.check()
            s.on_event(_slice("tick", 0, 0.1))
            return first, s.check(), s.checks
        if case == "min_rate_floor":
            s = obs.Sentinel(_sentinel_cfg(obs, min_rate=0.5))
            for b in range(4):
                s.on_event(_slice("tick", b, 0.01))
            s.on_event(_slice("tick", 4, 0.08))
            return s.check()
        if case == "cadence":
            s = obs.Sentinel(_sentinel_cfg(obs, check_every=10, open_after=1))
            for b in range(4):
                for _ in range(2):
                    s.on_event(_slice("decode_step", b, 0.1))
            s.on_event({"name": "req.claim", "ph": "i", "ts_us": 5})
            s.on_event(_slice("decode_step", 4, 0.8))
            return s.checks, s.last_check, s.active
        if case == "prune":
            s = obs.Sentinel(_sentinel_cfg(obs, baseline_buckets=2))
            for b in range(12):
                s.on_event(_slice("tick", b, 0.1, worker=None))
            return len(s._buckets), s.check()
        s = obs.Sentinel(_sentinel_cfg(obs))
        for b in range(4):
            s.on_event(_slice("tick", b, 0.1))
        s.on_event({**_slice("verify", 4, 0.2), "args": {"worker": "d0", "family": "verify"}})
        return s.check()

    got = same(run)
    if case == "no_baseline":
        assert got == (None, None, 2)
    elif case == "min_rate_floor":
        assert got["ratio"] == pytest.approx(8.0) and got["breach"] is False
    elif case == "cadence":
        assert got[0] >= 1 and got[1] is not None
    elif case == "new_phase":
        assert got["breach"] is True and got["ratio"] == "inf"


def test_fast_burn_opens_and_closes_incident_like_the_reference():
    def run(impl):
        obs = impl["obs"]
        now = [100.0]
        tracker = obs.SLOTracker(obs.SLOConfig(ttft_ms=1e-3, target=0.99,
                                               fast_burn_threshold=2.0), clock=lambda: now[0])
        for i in range(5):
            tracker.observe(ttft_s=1.0, key=i)
        vault = _vault(impl)
        sentinel = obs.Sentinel(_sentinel_cfg(obs), slo=tracker, vault=vault)
        sentinel.on_event(_slice("tick", 0, 0.1))
        sentinel.on_event(_slice("tick", 1, 0.1))
        sentinel.check()
        opened = (dict(vault.incident), sentinel.snapshot()["burn_incident"])
        now[0] += 3600.0
        sentinel.check()
        return opened, vault.incident, sentinel.snapshot()["burn_incident"]

    (incident, burning), after, still = same(run)
    assert incident["reason"].startswith("fast burn") and burning is True
    assert after is None and still is False


def test_sentinel_healthz_check_matches_the_reference():
    def run(impl):
        obs = impl["obs"]
        sentinel = obs.Sentinel(_sentinel_cfg(obs, open_after=1), vault=_vault(impl))
        server = impl["health"].HealthServer(port=0)
        impl["health"].add_sentinel_check(server, lambda: sentinel)
        attached = impl["health"].HealthServer(port=0)
        impl["health"].add_sentinel_check(attached, lambda: None)
        port = server.start()
        try:
            ok = _get(port, "/healthz")
            for b in range(4):
                sentinel.on_event(_slice("decode_step", b, 0.1))
            sentinel.on_event(_slice("decode_step", 4, 0.8))
            sentinel.check()
            bad = _get(port, "/healthz")
        finally:
            server.close()
        return ok[0], json.loads(ok[1]), bad[0], json.loads(bad[1]), attached.snapshot()

    ok_code, ok, bad_code, bad, attached = same(run)
    assert ok_code == 200 and ok["checks"]["sentinel"]["ok"]
    assert bad_code == 503 and "decode_step" in bad["checks"]["sentinel"]["detail"]
    assert attached[1]["sentinel"]["detail"] == "sentinel configured; not attached"


# -- the trace_ref joins -------------------------------------------------------


def test_worst_request_links_to_the_kept_trace_like_the_reference():
    def run(impl):
        tracker = _tracker(impl, ttft_ms=50.0, tpot_ms=10_000.0)
        vault = _vault(impl, slo=tracker)
        tracker.link_vault(vault)
        # the service's listener order: the tracker, then the vault
        _feed([tracker.on_event, vault.on_event], _lifecycle("g-bad"))
        bare = _tracker(impl, ttft_ms=50.0, tpot_ms=10_000.0)
        bare.observe(ttft_s=1.0, key="g-bad")
        return (tracker.snapshot()["worst_request"], tracker.artifact_summary(),
                vault.index(), bare.snapshot()["worst_request"])

    worst, summary, index, bare = same(run)
    assert worst["key"] == "g-bad" and worst["trace_ref"] == index["traces"][0]["id"]
    assert summary["worst_request"]["trace_ref"] == worst["trace_ref"]
    assert "trace_ref" not in bare


def test_exemplars_gain_trace_ref_only_with_the_resolver_like_the_reference():
    def run(impl):
        m = impl["metrics"]
        vault = _vault(impl, head_sample_every=1)
        _feed([vault.on_event], _lifecycle("g-ex"))
        h = m.Histogram("retention_ex_seconds", "x", buckets=[0.1, 1.0])
        h.observe(0.05, exemplar_trace_id="tr-g-ex")
        h.observe(0.5, exemplar_trace_id="unretained")

        def shape():
            return {le: (ex["trace_id"], ex.get("trace_ref")) for le, ex in h.exemplars().items()}

        before = shape()
        m.set_exemplar_resolver(vault.trace_ref)
        try:
            armed = shape()
            m.set_exemplar_resolver(lambda _: 1 / 0)
            raising = shape()
        finally:
            m.set_exemplar_resolver(None)
        return before, armed, raising, shape(), vault.trace_ref("tr-g-ex")

    before, armed, raising, after, ref = same(run)
    assert before == after == raising == {"0.1": ("tr-g-ex", None), "1": ("unretained", None)}
    assert armed == {"0.1": ("tr-g-ex", ref), "1": ("unretained", None)}
    assert port_metrics._exemplar_resolver is None


# -- config knobs and the off shape ---------------------------------------------


def test_from_config_knobs_parse_like_the_reference():
    def run(impl):
        obs, cfg = impl["obs"], impl["config"]
        offs = [cfg({}), cfg({"instance": {"observability": {
            "retention": {"enabled": False}, "sentinel": {"enabled": False}}}})]
        off = [(obs.retention_from_config(c), obs.sentinel_from_config(c)) for c in offs]
        vault = obs.retention_from_config(cfg({"instance": {"observability": {"retention": {
            "enabled": True, "max_traces": 7, "max_bytes": 4096, "head_sample_every": 3,
            "tail_quantile": 0.9, "incident_budget": 5, "export_path": "/tmp/v.jsonl",
            "rotate_keep": 2}}}}))
        sentinel = obs.sentinel_from_config(cfg({"instance": {"observability": {"sentinel": {
            "enabled": True, "bucket_s": 2.0, "fast_buckets": 2, "baseline_buckets": 8,
            "growth_threshold": 2.5, "min_rate": 0.1, "open_after": 1, "close_after": 4,
            "check_every": 64}}}}), vault=vault)
        defaults = obs.sentinel_from_config(cfg({"instance": {"observability": {
            "sentinel": {"enabled": True}}}}))
        errors = []
        for build in (lambda: obs.RetentionConfig(max_traces=0),
                      lambda: obs.RetentionConfig(max_bytes=0),
                      lambda: obs.RetentionConfig(tail_quantile=1.5),
                      lambda: obs.SentinelConfig(growth_threshold=1.0),
                      lambda: obs.SentinelConfig(bucket_s=0.0),
                      lambda: obs.SentinelConfig(fast_buckets=0),
                      lambda: obs.SentinelConfig(open_after=0)):
            with pytest.raises(ValueError) as err:
                build()
            errors.append(str(err.value))
        return (off, vars(vault.config), vars(sentinel.config), sentinel.vault is vault,
                vars(defaults.config), errors)

    got = same(run)
    assert got[0] == [(None, None), (None, None)]
    assert got[1]["max_traces"] == 7 and got[2]["check_every"] == 64 and got[3]


def test_armed_listeners_leave_serving_bitwise_identical():
    """The vault and the sentinel only observe: a tiny port batcher serves
    the same bits with both armed as recorder listeners, the extra series
    are theirs alone, and the port's recorded events give the reference's
    vault and sentinel the same index and snapshot as the port's."""
    from beholder_tpu_torch.models import TelemetrySequenceModel
    from beholder_tpu_torch.models.serving import ContinuousBatcher, Request

    torch.manual_seed(0)
    model = TelemetrySequenceModel(dim=32, heads=2, layers=1, device="cpu")
    kw = dict(num_pages=16, page_size=8, slots=2, max_prefix=16, max_pages_per_seq=4,
              device="cpu")

    def reqs():
        out = []
        for seed in range(3):
            rng = np.random.default_rng(seed)
            out.append(Request(np.cumsum(1.0 + rng.normal(0, 0.05, 10)), np.full(10, 2), 5))
        return out

    plain_metrics = port_metrics.Metrics()
    base = ContinuousBatcher(model, metrics=plain_metrics, **kw).run(reqs())
    armed_metrics = port_metrics.Metrics()
    fr = port_obs.FlightRecorder(ring_size=512)
    vault = port_obs.TraceVault(port_obs.RetentionConfig(head_sample_every=1),
                                registry=armed_metrics.registry, clock=clock)
    sentinel = port_obs.Sentinel(_sentinel_cfg(port_obs), registry=armed_metrics.registry)
    fr.add_listener(vault.on_event)
    fr.add_listener(sentinel.on_event)
    got = ContinuousBatcher(model, metrics=armed_metrics, flight_recorder=fr, **kw).run(reqs())
    for a, b in zip(base, got):
        assert np.array_equal(np.asarray(a), np.asarray(b))
    assert vault.evaluated == 3 and vault.kept == 3

    def names(m):
        return {x.name for x in m.registry._metrics}

    extra = names(armed_metrics) - names(plain_metrics)
    assert extra and all(n.startswith(("beholder_retention", "beholder_sentinel"))
                         for n in extra)

    events = fr.events()
    jvault = ref_obs.TraceVault(ref_obs.RetentionConfig(head_sample_every=1), clock=clock)
    jsentinel = ref_obs.Sentinel(_sentinel_cfg(ref_obs))
    _feed([jvault.on_event, jsentinel.on_event], events)
    pvault = port_obs.TraceVault(port_obs.RetentionConfig(head_sample_every=1), clock=clock)
    psentinel = port_obs.Sentinel(_sentinel_cfg(port_obs))
    _feed([pvault.on_event, psentinel.on_event], events)
    assert pvault.index() == jvault.index() == vault.index()
    assert psentinel.check() == jsentinel.check()
    assert psentinel.snapshot() == jsentinel.snapshot()
