"""The port's SLO tracker and request timelines against the JAX reference's
(``beholder_tpu/obs/slo.py``, ``beholder_tpu/obs/timeline.py``, both
jax-free host code).

Model: the reference SLO tests' ``dim=32, heads=2, layers=1`` with
``init_seq_state(PRNGKey(0), 24)``'s f32 params, loaded into the port
through the weight bridge, at the same batcher geometry (``BATCHER_KW``).
Tolerances, with their reasons:

- digests, burn rates, snapshots and config fields: exactly equal, as both
  sides run the same host arithmetic on the same inputs;
- timelines: the same claims, tenants, horizons, retire tokens and outcomes
  as the reference's run of the same requests (times are each run's own
  host clock, so they are not compared); the same event list folds to the
  same records on both sides;
- streams: the port against itself bitwise (an armed tracker only
  observes); against the reference the first value within 1e-4 and the
  stream in the serving band (ROADMAP C.15).
"""

import json

import jax
import numpy as np
import pytest
import torch

from beholder_tpu.config import ConfigNode
from beholder_tpu.models import TelemetrySequenceModel as JaxModel
from beholder_tpu.models import init_seq_state
from beholder_tpu.models import serving as jsv
from beholder_tpu.obs import FlightRecorder as JaxFlightRecorder
from beholder_tpu.obs import slo as jslo
from beholder_tpu.obs import timeline as jtl
from beholder_tpu_torch.cluster import ClusterConfig, FailoverConfig
from beholder_tpu_torch.cluster.failover import Dropped
from beholder_tpu_torch.cluster.router import ClusterScheduler
from beholder_tpu_torch.metrics import Registry
from beholder_tpu_torch.models import TelemetrySequenceModel
from beholder_tpu_torch.models.bridge import load_flax_params
from beholder_tpu_torch.models.serving import ContinuousBatcher, Request
from beholder_tpu_torch.obs import (
    FlightRecorder,
    LatencyDigest,
    P2Quantile,
    SLOConfig,
    SLOTracker,
    build_timelines,
    phase_walls,
    slo_from_config,
)
from beholder_tpu_torch.reliability.chaos import WorkerFault, inject_worker_fault

SIZES = dict(dim=32, heads=2, layers=1)
BATCHER_KW = dict(num_pages=16, page_size=8, slots=2, max_prefix=16, max_pages_per_seq=4)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's side is thousands of small ops, which the intra-op pool
    slows many times over when test workers share the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def pair():
    jm = JaxModel(**SIZES)
    state, _, _ = init_seq_state(jax.random.PRNGKey(0), 24, model=jm)
    tm = TelemetrySequenceModel(**SIZES, device="cpu")
    load_flax_params(tm, jax.tree.map(np.asarray, state.params))
    return jm, state.params, tm


def _request(seed, t=9, horizon=6, tenant=None):
    rng = np.random.default_rng(seed)
    return Request(np.cumsum(1.0 + rng.normal(0, 0.05, t + 1)), np.full(t + 1, 2), horizon,
                   tenant=tenant)


def _jreq(req):
    return jsv.Request(req.progress, req.statuses, req.horizon, tenant=req.tenant)


def _batcher(tm, **kw):
    return ContinuousBatcher(tm, **{**BATCHER_KW, **kw}, device="cpu")


# -- digests and burn: the same host arithmetic ------------------------------


@pytest.mark.parametrize("dist,n", [("uniform", 3), ("uniform", 5), ("uniform", 2000),
                                    ("lognormal", 2000), ("bimodal", 700)])
def test_p2_and_digest_values_equal_the_reference(dist, n):
    rng = np.random.default_rng(7)
    samples = {
        "uniform": lambda: rng.uniform(0.0, 1.0, n),
        "lognormal": lambda: rng.lognormal(0.0, 0.5, n),
        "bimodal": lambda: np.where(rng.uniform(size=n) < 0.9, 0.01, 2.0)
        * rng.uniform(0.5, 1.5, n),
    }[dist]()
    ours, theirs = LatencyDigest(), jslo.LatencyDigest()
    for x in samples:
        ours.observe(float(x))
        theirs.observe(float(x))
    for q in (0.5, 0.95, 0.99):
        assert ours.quantile(q) == theirs.quantile(q)
    assert ours.to_dict(unit_scale=1e3) == theirs.to_dict(unit_scale=1e3)
    assert (ours.count, ours.total, ours.min, ours.max) == (
        theirs.count, theirs.total, theirs.min, theirs.max)
    for q in (0.25, 0.9):
        a, b = P2Quantile(q), jslo.P2Quantile(q)
        assert a.value() == b.value() == 0.0
        for x in samples:
            a.observe(float(x))
            b.observe(float(x))
        assert a.value() == b.value()
    for bad in (0.0, 1.0, 1.5):
        with pytest.raises(ValueError, match="quantile"):
            P2Quantile(bad)
        with pytest.raises(ValueError, match="quantile"):
            jslo.P2Quantile(bad)


def _script(tracker, clock):
    """One scripted sequence of observations and clock steps; returns every
    derived reading along the way."""
    readings = []

    def read():
        readings.append(dict(
            fast=tracker.burn_rate("fast"), slow=tracker.burn_rate("slow"),
            attainment=tracker.attainment(), budget=tracker.budget_remaining(),
            health=tracker.health(), tail0=tracker.scope_tail_ratio("decode-0"),
            tail=tracker.scope_tail_ratio(), flood=tracker.tenant_burn("flood"),
            victim=tracker.tenant_burn("victim"), never=tracker.tenant_burn("never"),
            snapshot=json.dumps(tracker.snapshot(), sort_keys=True),
            summary=tracker.artifact_summary()))

    read()
    for i in range(8):
        tracker.observe(0.001 * (i + 1), tpot_s=0.0005, worker="decode-0", key=f"g{i}",
                        tenant="flood")
    for i in range(3):
        tracker.observe(10.0, worker="decode-1", key=("t", i), tenant="victim",
                        queue_wait_s=0.25)
    tracker.observe(0.002, outcome="dropped", key=7)
    read()
    clock[0] += 45.0
    tracker.observe(0.003, tpot_s=0.9, worker="decode-0", tenant="flood")
    read()
    clock[0] += 120.0
    read()
    for i in range(20):
        tracker.observe(0.01 if i % 5 else 2.0, worker="decode-0")
    read()
    clock[0] += 4000.0
    read()
    return readings


def test_burn_windows_and_snapshots_equal_the_reference_on_an_injected_clock():
    cfg = dict(ttft_ms=100.0, tpot_ms=10.0, target=0.9, fast_window_s=60.0,
               slow_window_s=600.0, fast_burn_threshold=2.0)
    ours_clock, theirs_clock = [1000.0], [1000.0]
    ours = SLOTracker(SLOConfig(**cfg), clock=lambda: ours_clock[0])
    theirs = jslo.SLOTracker(jslo.SLOConfig(**cfg), clock=lambda: theirs_clock[0])
    got, want = _script(ours, ours_clock), _script(theirs, theirs_clock)
    assert got == want
    # the scripted sequence crossed every regime: burning, forgotten by the
    # fast window only, then by both
    assert got[1]["fast"] == pytest.approx(4 / 12 / 0.1) and not got[1]["health"][0]
    assert got[3]["fast"] == 0.0 < got[3]["slow"]
    assert got[-1]["slow"] == 0.0
    assert got[4]["tail0"] > 3.0
    assert (ours.good, ours.bad, ours.worst_request) == (
        theirs.good, theirs.bad, theirs.worst_request)
    # the route renders the snapshot
    status, ctype, body = ours.route()()
    assert (status, ctype) == (200, "application/json")
    assert json.loads(body) == json.loads(theirs.route()()[2])


def test_slo_config_and_from_config_equal_the_reference():
    for tree in ({}, {"instance": {}}, {"instance": {"slo": {"enabled": False}}}):
        assert slo_from_config(ConfigNode(tree)) is None
        assert jslo.slo_from_config(ConfigNode(tree)) is None
    node = ConfigNode({"instance": {"slo": {
        "enabled": True,
        "objectives": {"ttft_ms": 50, "tpot_ms": 20, "target": 0.95},
        "windows": {"fast_s": 30, "slow_s": 300},
        "burn": {"fast_threshold": 3.0},
    }}})
    ours, theirs = slo_from_config(node), jslo.slo_from_config(node)
    assert vars(ours.config) == vars(theirs.config)
    assert vars(slo_from_config(ConfigNode({"instance": {"slo": {"enabled": True}}})).config) \
        == vars(SLOConfig())
    registry = Registry()
    armed = slo_from_config(node, registry=registry)
    armed.observe(0.01)
    assert "beholder_slo_requests_total" in registry.render()
    for bad in (dict(target=1.0), dict(target=0.0), dict(ttft_ms=0.0), dict(tpot_ms=-1.0)):
        with pytest.raises(ValueError) as ours_err:
            SLOConfig(**bad)
        with pytest.raises(ValueError) as theirs_err:
            jslo.SLOConfig(**bad)
        assert str(ours_err.value) == str(theirs_err.value)


def test_streaming_fold_equals_the_reference_on_one_event_list():
    """The same synthetic lifecycle stream (batched and slot-tagged admits,
    a recovery leg, a queued deadline, a never-claimed drop, the open-table
    bound) through both trackers, and through both offline folds."""
    events = []
    for slot in (0, 1):
        events.append({"name": "req.claim", "ph": "i", "ts_us": 1_000_000, "trace_id": "t",
                       "args": {"rid": slot, "slot": slot, "gid": f"g-{slot}",
                                "tenant": "a" if slot else None, "queue_wait_s": 0.01,
                                "horizon": 4, "prefix_tokens": 9}})
    events += [
        {"name": "admit", "ph": "X", "ts_us": 1_100_000, "dur_us": 50_000, "trace_id": "t",
         "args": {"slot": 0}},
        {"name": "tick", "ph": "X", "ts_us": 1_200_000, "dur_us": 10_000, "trace_id": "t",
         "args": {}},
        {"name": "device_wait", "ph": "X", "ts_us": 1_200_000, "dur_us": 5_000,
         "trace_id": "t", "args": {}},
        {"name": "req.recovered", "ph": "i", "ts_us": 1_250_000, "trace_id": "t",
         "args": {"gid": "g-1", "worker": "decode-1", "reason": "kill"}},
        {"name": "req.claim", "ph": "i", "ts_us": 1_300_000, "trace_id": "u",
         "args": {"rid": 0, "slot": 1, "gid": "g-1", "worker": "decode-0"}},
        {"name": "admit", "ph": "X", "ts_us": 1_400_000, "dur_us": 50_000, "trace_id": "u",
         "args": {}},
        {"name": "req.retire", "ph": "i", "ts_us": 2_000_000, "trace_id": "t",
         "args": {"rid": 0, "gid": "g-0", "tokens": 4, "outcome": "ok"}},
        {"name": "req.retire", "ph": "i", "ts_us": 2_100_000, "trace_id": "u",
         "args": {"rid": 0, "gid": "g-1", "tokens": 4, "outcome": "ok", "worker": "decode-0"}},
        {"name": "deadline_exceeded", "ph": "i", "ts_us": 2_200_000, "trace_id": "v",
         "args": {"stage": "claim", "rid": 3, "queue_wait_s": 0.5}},
        {"name": "req.dropped", "ph": "i", "ts_us": 2_300_000, "trace_id": None,
         "args": {"gid": "s9", "reason": "tenant_preempted", "tenant": "b"}},
        {"name": "readback", "ph": "X", "ts_us": 2_400_000, "dur_us": 20_000, "trace_id": "u",
         "args": {}},
    ]
    ours, theirs = SLOTracker(SLOConfig(ttft_ms=300.0)), jslo.SLOTracker(
        jslo.SLOConfig(ttft_ms=300.0))
    for e in events:
        ours.on_event(e)
        theirs.on_event(e)
    assert json.dumps(ours.snapshot(), sort_keys=True) == json.dumps(
        theirs.snapshot(), sort_keys=True)
    assert ours._digest("cluster")["ttft"].max == pytest.approx(0.45)
    got, want = build_timelines(events), jtl.build_timelines(events)
    assert [t.to_dict() for t in got.timelines] == [t.to_dict() for t in want.timelines]
    assert (got.wall_s, got.attributed_s, got.unattributed_s) == (
        want.wall_s, want.attributed_s, want.unattributed_s)
    assert sorted(t.outcome for t in got.timelines) == [
        "deadline_exceeded", "dropped", "ok", "ok"]
    assert phase_walls(events) == jtl.phase_walls(events)
    # the open table is bounded as the reference's
    for tracker in (SLOTracker(), jslo.SLOTracker()):
        for i in range(tracker.MAX_OPEN + 5):
            tracker.on_event({"name": "req.claim", "ts_us": i, "trace_id": "t",
                              "args": {"rid": i}})
        assert (len(tracker._open), tracker.dropped_open) == (tracker.MAX_OPEN, 5)


# -- timelines of the port's serving runs -------------------------------------


def _lifecycle(report):
    """Per-request facts that do not read a clock."""
    return [dict(tenant=t.tenant, horizon=t.horizon, prefix_tokens=t.prefix_tokens,
                 tokens=t.tokens, outcome=t.outcome, legs=len(t.legs),
                 has_ttft=t.ttft_s is not None, phases=sorted(t.phases))
            for t in report.timelines]


def test_timelines_of_a_port_run_equal_the_reference_runs(pair):
    jm, params, tm = pair
    reqs = [_request(i, horizon=5 + i, tenant=("a", "b", None, "a")[i]) for i in range(4)]
    fr = FlightRecorder(ring_size=4096)
    tracker = SLOTracker(SLOConfig(ttft_ms=60_000.0, tpot_ms=60_000.0))
    fr.add_listener(tracker.on_event)
    b = _batcher(tm, flight_recorder=fr, max_pending=8)
    for r in reqs:
        assert b.submit(r).accepted
    got = b.run_pending(waves=False)
    jfr = JaxFlightRecorder(ring_size=4096)
    jb = jsv.ContinuousBatcher(jm, params, flight_recorder=jfr, max_pending=8, **BATCHER_KW)
    for r in reqs:
        assert jb.submit(_jreq(r)).accepted
    want = jb.run_pending(waves=False)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g[:1], np.asarray(w)[:1], rtol=0, atol=1e-4)
        np.testing.assert_allclose(g, np.asarray(w), rtol=3e-2, atol=1.5e-2)
    ours, theirs = build_timelines(fr.events()), jtl.build_timelines(jfr.events())
    assert _lifecycle(ours) == _lifecycle(theirs)
    assert [t.tokens for t in ours.timelines] == [r.horizon for r in reqs]
    assert all(t.queue_wait_s > 0 for t in ours.timelines)
    assert abs(ours.attributed_s + ours.unattributed_s - ours.wall_s) < 1e-6
    # the port's events fold the same in the reference's fold
    assert [t.to_dict() for t in jtl.build_timelines(fr.events()).timelines] == [
        t.to_dict() for t in ours.timelines]
    # the streaming tracker saw what the offline fold saw
    assert tracker.good + tracker.bad == len(reqs)
    assert {k: v["good"] for k, v in tracker.tenant_stats().items()} == {"a": 2, "b": 1}
    assert tracker._digest("cluster")["ttft"].count == sum(
        t.ttft_s is not None for t in ours.timelines)


def test_killed_shard_drops_reach_the_tracker_and_timelines(pair):
    """A request the failover layer loses (``recovery_limit``) counts bad
    on the tracker and closes its timeline as ``dropped``."""
    _, _, tm = pair
    fr = FlightRecorder(ring_size=8192)
    tracker = SLOTracker(SLOConfig(ttft_ms=60_000.0, tpot_ms=60_000.0))
    fr.add_listener(tracker.on_event)
    cluster = ClusterScheduler(
        tm, ClusterConfig(n_decode_workers=2, failover=FailoverConfig(max_recoveries_per_request=0)),
        flight_recorder=fr, devices=["cpu"], **BATCHER_KW)
    inject_worker_fault(cluster, WorkerFault("decode-1", "kill", after_dispatches=1))
    results = cluster.run([_request(i, horizon=5) for i in range(6)])
    dropped = [r for r in results if isinstance(r, Dropped)]
    assert dropped
    assert tracker.bad >= len(dropped) and tracker.attainment() < 1.0
    report = build_timelines(fr.events())
    lost = [t for t in report.timelines if t.outcome == "dropped"]
    assert len(lost) == len(dropped)
    for timeline in lost:
        assert {"type": "dropped", "reason": "recovery_limit"} in [
            {k: h.get(k) for k in ("type", "reason")} for h in timeline.hops]
    assert [t.outcome for t in jtl.build_timelines(fr.events()).timelines] == [
        t.outcome for t in report.timelines]


def test_slo_off_leaves_streams_and_exposition_byte_identical(pair):
    """No tracker, nothing registered; an armed tracker only observes."""
    _, _, tm = pair
    reqs = [_request(i, horizon=5) for i in range(3)]
    plain_registry = Registry()
    base = _batcher(tm, metrics=plain_registry).run(reqs)
    assert "beholder_slo" not in plain_registry.render()
    observed_registry = Registry()
    fr = FlightRecorder(ring_size=512)
    tracker = SLOTracker(SLOConfig(), registry=observed_registry)
    fr.add_listener(tracker.on_event)
    got = _batcher(tm, metrics=observed_registry, flight_recorder=fr).run(reqs)
    for a, b in zip(base, got):
        assert np.array_equal(a, b)
    assert tracker.good + tracker.bad == 3
    names = lambda r: {m.name for m in r._metrics}  # noqa: E731
    extra = names(observed_registry) - names(plain_registry)
    assert extra and all(n.startswith("beholder_slo") for n in extra)
    # a second bare batcher renders the first's exposition byte for byte
    again = Registry()
    _batcher(tm, metrics=again).run(reqs)
    strip = lambda text: [l for l in text.splitlines() if "_sum" not in l  # noqa: E731,E741
                          and "_bucket" not in l]
    assert strip(again.render()) == strip(plain_registry.render())
