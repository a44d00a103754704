"""The port's control plane against the JAX reference's
(``beholder_tpu/control/``, jax-free host code): configs and their parse,
the plane's decisions, the replay harness's traces, the metric catalog and
the scaling evaluator; and, on the port's own engines, the plane wired into
the single batcher and ``ClusterScheduler``.

Model: the reference control tests' ``dim=32, heads=2, layers=1`` with
``init_seq_state(PRNGKey(0), 16)``'s f32 params, loaded into the port
through the weight bridge, at the same batcher geometry (``BATCHER_KW``).
Tolerances, with their reasons:

- configs, decisions, scenarios' arrays, claim orders, counters and the
  exposition: exactly equal, as both sides run the same host arithmetic;
- streams the policy only reorders or moves (FIFO against DRR, scaled or
  routed clusters against one batcher, k shed against spec off): bitwise
  against the port's own oracle;
- the port's streams against the reference's: the first value within 1e-4
  and the stream in the serving band (ROADMAP C.15).
"""

import dataclasses
import json
import threading
import time

import jax
import numpy as np
import pytest
import torch

import beholder_tpu.control as jctl
import beholder_tpu.control.policy as jpolicy
import beholder_tpu.control.replay as jreplay
from beholder_tpu.config import ConfigNode
from beholder_tpu.control.evaluator import ScalingEvaluator as JaxScalingEvaluator
from beholder_tpu.control.instruments import ControlMetrics as JaxControlMetrics
from beholder_tpu.metrics import Registry as JaxRegistry
from beholder_tpu.models import TelemetrySequenceModel as JaxModel
from beholder_tpu.models import init_seq_state
from beholder_tpu.models import serving as jsv
from beholder_tpu.obs import FlightRecorder as JaxFlightRecorder
from beholder_tpu.obs import slo as jslo
from beholder_tpu.reliability.shed import IntakeQueue as JaxIntakeQueue
from beholder_tpu_torch.cluster import ROUTE_ROUND_ROBIN, ClusterConfig, FailoverConfig
from beholder_tpu_torch.cluster.router import ClusterScheduler
from beholder_tpu_torch.control import (
    AutoscaleConfig,
    ControlConfig,
    ControlMetrics,
    ControlPlane,
    Preempted,
    RoutingConfig,
    ScalingEvaluator,
    SpecShedConfig,
    TenantPolicy,
    control_from_config,
)
from beholder_tpu_torch.control.replay import (
    SCENARIOS,
    fold_tenant_latency,
    make_request,
    recovery_storm,
    replay,
    tenant_skew,
)
from beholder_tpu_torch.metrics import Registry
from beholder_tpu_torch.models import TelemetrySequenceModel
from beholder_tpu_torch.models.bridge import load_flax_params
from beholder_tpu_torch.models.serving import ContinuousBatcher, Request
from beholder_tpu_torch.obs import FlightRecorder, SLOConfig, SLOTracker
from beholder_tpu_torch.reliability.chaos import WorkerFault
from beholder_tpu_torch.reliability.shed import IntakeQueue
from beholder_tpu_torch.spec import SpecConfig

SIZES = dict(dim=32, heads=2, layers=1)
BATCHER_KW = dict(num_pages=64, page_size=8, slots=2, max_prefix=16, max_pages_per_seq=8)


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
    state, _, _ = init_seq_state(jax.random.PRNGKey(0), 16, model=jm)
    tm = TelemetrySequenceModel(**SIZES, device="cpu")
    load_flax_params(tm, jax.tree.map(np.asarray, state.params))
    return jm, state.params, tm


def _batcher(tm, **kw):
    return ContinuousBatcher(tm, **{**BATCHER_KW, **kw}, device="cpu")


def _cluster(tm, cfg, **kw):
    return ClusterScheduler(tm, cfg, devices=["cpu"], **{**BATCHER_KW, **kw})


def _bitwise(got, want):
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert isinstance(g, np.ndarray) and np.array_equal(g, w), f"result {i}"


def _as_ref(cfg):
    """The reference's ``ControlConfig`` for a port one, field for field."""
    sub = {"spec": jctl.SpecShedConfig, "routing": jctl.RoutingConfig,
           "autoscale": jctl.AutoscaleConfig}
    fields = {k: getattr(cfg, k) for k in ("default_weight", "default_quota")}
    fields["tenants"] = {t: jctl.TenantPolicy(**dataclasses.asdict(p))
                         for t, p in cfg.tenants.items()}
    for key, cls in sub.items():
        value = getattr(cfg, key)
        fields[key] = cls(**dataclasses.asdict(value)) if value is not None else None
    return jctl.ControlConfig(**fields)


# -- configs -----------------------------------------------------------------


@pytest.mark.parametrize("name,kw", [
    ("TenantPolicy", dict(weight=0.0)), ("TenantPolicy", dict(quota=0)),
    ("SpecShedConfig", dict(burn_threshold=0.0)), ("SpecShedConfig", dict(shed_to=-1)),
    ("RoutingConfig", dict(tail_threshold=1.0)), ("RoutingConfig", dict(deadline_slack_s=-1)),
    ("AutoscaleConfig", dict(min_shards=0)), ("AutoscaleConfig", dict(min_shards=2, max_shards=1)),
    ("AutoscaleConfig", dict(down_burn=2.0, up_burn=2.0)),
    ("AutoscaleConfig", dict(down_pressure=0.9, up_pressure=0.5)),
    ("AutoscaleConfig", dict(sustain_s=-1.0)), ("AutoscaleConfig", dict(evaluator_interval_s=0)),
    ("ControlConfig", dict(default_weight=0.0)), ("ControlConfig", dict(default_quota=0)),
])
def test_config_validation_errors_equal_the_reference(name, kw):
    import beholder_tpu_torch.control as ours

    with pytest.raises(ValueError) as ours_err:
        getattr(ours, name)(**kw)
    with pytest.raises(ValueError) as theirs_err:
        getattr(jctl, name)(**kw)
    assert str(ours_err.value) == str(theirs_err.value)


@pytest.mark.parametrize("tree", [
    {},
    {"instance": {"control": {"enabled": False}}},
    {"instance": {"control": {"enabled": True}}},
    {"instance": {"control": {
        "enabled": True,
        "tenants": {"premium": {"weight": 4.0, "quota": 32}, "batch": {"weight": 1.0}},
        "default_weight": 2.0, "default_quota": 8,
        "spec": {"enabled": True, "burn_threshold": 3.0, "shed_to": 1},
        "routing": {"enabled": True, "tail_threshold": 2.5, "deadline_slack_s": 0.5},
        "autoscale": {"enabled": True, "min_shards": 1, "max_shards": 3, "up_burn": 1.5,
                      "up_pressure": 0.6, "down_burn": 0.2, "down_pressure": 0.1,
                      "sustain_s": 5, "cooldown_s": 20, "evaluator_interval_s": 0.5},
    }}},
    {"instance": {"control": {"enabled": True, "routing": {"enabled": True,
                                                           "tail_threshold": 1.0}}}},
])
def test_control_from_config_equals_the_reference(tree):
    node = ConfigNode(tree)
    try:
        want = jctl.control_from_config(node)
    except ValueError as err:
        with pytest.raises(ValueError) as ours_err:
            control_from_config(node)
        assert str(ours_err.value) == str(err)
        return
    got = control_from_config(node)
    if want is None:
        assert got is None
        return
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert dataclasses.asdict(got.policy_for("nobody")) == dataclasses.asdict(
        want.policy_for("nobody"))


# -- the replay harness's traces ---------------------------------------------


@pytest.mark.parametrize("name", sorted(jreplay.SCENARIOS))
def test_scenarios_equal_the_reference_arrays(name):
    assert sorted(SCENARIOS) == sorted(jreplay.SCENARIOS)
    ours, theirs = SCENARIOS[name](), jreplay.SCENARIOS[name]()
    assert (ours.name, ours.note, ours.skewed_tenant, ours.victim_tenant) == (
        theirs.name, theirs.note, theirs.skewed_tenant, theirs.victim_tenant)
    assert len(ours.arrivals) == len(theirs.arrivals) > 0
    for a, b in zip(ours.arrivals, theirs.arrivals):
        assert (a.burst, a.tenant, a.request.tenant, a.request.horizon) == (
            b.burst, b.tenant, b.request.tenant, b.request.horizon)
        for field in ("progress", "statuses"):
            x, y = getattr(a.request, field), getattr(b.request, field)
            assert x.dtype == y.dtype and np.array_equal(x, y)
        assert (a.request.deadline is None) == (b.request.deadline is None)
    # make_request's every knob, and recovery_storm's deadline
    for kw in (dict(seed=3), dict(seed=3, prefix_t=5, horizon=2, tenant="t", prefix_seed=1)):
        x, y = make_request(**kw), jreplay.make_request(**kw)
        assert np.array_equal(x.progress, y.progress) and np.array_equal(x.statuses, y.statuses)
        assert (x.horizon, x.tenant) == (y.horizon, y.tenant)
    storm = recovery_storm(n=2, deadline_s=30.0)
    assert all(25.0 < a.request.deadline.remaining() <= 30.0 for a in storm.arrivals)


# -- the plane's decisions, scripted on both sides ----------------------------


class _Pool:
    def __init__(self, shard_id, free, num_pages=64, committed=0):
        self.shard_id, self.name = shard_id, f"decode-{shard_id}"
        self.free, self.num_pages, self.committed = free, num_pages, committed


class _Intake:
    def __init__(self, depth):
        self.depth = depth


class _Shard:
    def __init__(self, shard_id, free, depth=0, committed=0):
        self.pool, self.intake = _Pool(shard_id, free, committed=committed), _Intake(depth)


class _Deadline:
    """An injected deadline: ``remaining()`` reads no clock."""

    def __init__(self, remaining):
        self._remaining = remaining

    def remaining(self):
        return self._remaining


class _Req:
    def __init__(self, remaining=None):
        self.deadline = None if remaining is None else _Deadline(remaining)


class _Failover:
    def __init__(self):
        self.drained = []

    def state(self, name):
        return "drained" if name in self.drained else "up"


class _PoolView:
    def __init__(self, sched):
        self._sched = sched

    @property
    def total_pages(self):
        return sum(s.pool.num_pages for s in self._sched.shards)

    @property
    def total_free(self):
        return sum(s.pool.free for s in self._sched.shards)


class _Scheduler:
    """A duck-typed cluster: pool arithmetic, scale_up and drain."""

    def __init__(self, committed):
        self.shards = [_Shard(0, 64 - committed, committed=committed)]
        self.failover = _Failover()
        self.pool_view = _PoolView(self)

    def scale_up(self):
        shard = _Shard(len(self.shards), 64)
        self.shards.append(shard)
        return shard

    def drain(self, shard_id):
        name = self.shards[shard_id].pool.name
        self.failover.drained.append(name)
        return {"requeued": 1, "migrated_pages": 3, "target": "decode-0"}

    def settle(self):
        for s in self.shards:
            s.pool.committed, s.pool.free = 0, 64


def _decisions(side):
    """One scripted run of every decision the plane makes, over the same
    tracker observations and clock steps."""
    cls_plane = ControlPlane if side == "port" else jpolicy.ControlPlane
    cls_tracker = SLOTracker if side == "port" else jslo.SLOTracker
    cls_slo = SLOConfig if side == "port" else jslo.SLOConfig
    cfg = ControlConfig(
        tenants={"victim": TenantPolicy(weight=4.0, quota=8)}, default_quota=16,
        spec=SpecShedConfig(burn_threshold=2.0, shed_to=1),
        routing=RoutingConfig(tail_threshold=3.0, deadline_slack_s=1.0),
        autoscale=AutoscaleConfig(min_shards=1, max_shards=2, up_burn=1.0, up_pressure=0.3,
                                  down_burn=0.5, down_pressure=0.2, sustain_s=1.0,
                                  cooldown_s=5.0))
    clock = [0.0]
    tracker = cls_tracker(cls_slo(ttft_ms=10.0, target=0.9, fast_window_s=30.0),
                          clock=lambda: clock[0])
    plane = cls_plane(cfg if side == "port" else _as_ref(cfg), tracker=tracker,
                      clock=lambda: clock[0])
    out = []
    shards = [_Shard(0, 60, depth=5), _Shard(1, 40)]

    def route(req=None):
        shard, reason = plane.route_shard(shards, 2, req)
        return shard.pool.shard_id, reason

    out.append(("cap", plane.spec_k_cap()))
    out.append(("route", route(), route(_Req(100.0)), route(_Req(0.5))))
    for _ in range(20):
        tracker.observe(0.010, worker="decode-0")
        tracker.observe(0.010, worker="decode-1")
    for _ in range(5):
        tracker.observe(2.0, worker="decode-0")
        tracker.observe(0.012, worker="decode-1")
    out.append(("route", route(), route(_Req(0.5)), route(_Req(5.0))))
    out.append(("cap", plane.spec_k_cap(), tracker.burn_rate("fast")))
    for _ in range(5):
        tracker.observe(2.0, worker="decode-1")
    out.append(("route", route(), plane.route_shard([shards[0]], 2)[1]))
    sched = _Scheduler(committed=40)
    for step in (0.0, 0.5, 1.0, 2.0, 3.0, 10.0):
        clock[0] += step
        out.append(("scale", clock[0], plane.evaluate_scaling(sched), len(sched.shards)))
    sched.settle()
    clock[0] += 60.0
    tracker.observe(0.001)
    out.append(("cap", plane.spec_k_cap()))
    for step in (0.0, 2.0, 2.0, 10.0, 10.0):
        clock[0] += step
        out.append(("scale", clock[0], plane.evaluate_scaling(sched)))
    plane.on_k_shed(0, 4, 1)
    snap = plane.snapshot()
    out.append(("snapshot", json.dumps(snap, sort_keys=True)))
    out.append(("route_body", plane.http_route()()))
    out.append(("log", plane.scale_log, plane.k_shed_events, sched.failover.drained))
    return out


def test_plane_decisions_equal_the_reference():
    got, want = _decisions("port"), _decisions("reference")
    assert got == want
    flat = json.dumps(got, default=str)
    for reason in ("tail_avoid", "deadline", "pressure"):
        assert f'"{reason}"' in flat
    assert [e["direction"] for e in got[-1][1]] == ["up", "down"]


def test_control_metrics_exposition_equals_the_reference():
    cfg = ControlConfig(tenants={"premium": TenantPolicy(weight=4.0, quota=32)},
                        default_quota=8)
    ours, theirs = Registry(), JaxRegistry()
    for registry, metrics, config in ((ours, ControlMetrics(ours), cfg),
                                      (theirs, JaxControlMetrics(theirs), _as_ref(cfg))):
        metrics.export_policy(config)
        metrics.admitted_total.inc(tenant="premium")
        metrics.shed_total.inc(2, tenant="default", reason="tenant_quota")
        metrics.k_shed_total.inc()
        metrics.scale_events_total.inc(direction="up")
        metrics.route_overrides_total.inc(reason="deadline")
    assert ours.render() == theirs.render()
    text = ours.render()
    for line in ('beholder_control_tenant_weight{tenant="premium"} 4',
                 'beholder_control_tenant_quota{tenant="default"} 8',
                 "beholder_control_k_cap -1"):
        assert line in text
    # the plane registers the same catalog on demand, and nothing without one
    registry = Registry()
    ControlPlane(ControlConfig(), registry=registry)
    assert {m.name for m in registry._metrics} == {m.name for m in ours._metrics}


# -- the scaling evaluator ---------------------------------------------------


class _FakePlane:
    def __init__(self, fail_at=()):
        self.calls = 0
        self.fail_at = set(fail_at)

    def evaluate_scaling(self, scheduler):
        self.calls += 1
        if self.calls in self.fail_at:
            raise RuntimeError("boom")
        return {"direction": "up", "call": self.calls}


class _Log:
    def __init__(self):
        self.exceptions = 0

    def exception(self, *a, **k):
        self.exceptions += 1


@pytest.mark.parametrize("cls", [ScalingEvaluator, JaxScalingEvaluator])
def test_scaling_evaluator_counts_swallows_ticks_and_stops(cls):
    log = _Log()
    ev = cls(_FakePlane(fail_at={2}), scheduler=object(), interval_s=1.0, logger=log)
    assert ev.poll_once() == {"direction": "up", "call": 1}
    assert ev.poll_once() is None  # counted and logged, never raised
    assert ev.poll_once() == {"direction": "up", "call": 3}
    assert (ev.evaluations, ev.errors, log.exceptions) == (3, 1, 1)
    waits, plane = [], _FakePlane()
    ev = cls(plane, scheduler=object(), interval_s=0.25,
             wait=lambda t: waits.append(t) or len(waits) > 3)
    assert ev.start() is ev
    deadline = time.monotonic() + 5.0
    while ev.running and time.monotonic() < deadline:
        time.sleep(0.005)
    assert not ev.running and plane.calls == ev.evaluations == 3
    assert waits == [0.25] * 4
    ev.stop()
    ev.stop()
    ev = cls(_FakePlane(), scheduler=object(), interval_s=3600.0)
    ev.stop()  # a no-op before start
    assert ev.start() is ev.start() and ev.running
    t0 = time.monotonic()
    ev.stop()  # wakes the hour-long wait at once
    assert time.monotonic() - t0 < 5.0 and not ev.running
    assert not any(t.name == "beholder-scaling-evaluator" for t in threading.enumerate())
    with pytest.raises(ValueError, match="interval_s"):
        cls(_FakePlane(), scheduler=object(), interval_s=0)


# -- the plane on the port's engines ------------------------------------------


#: the reference control test's tenant-skew replay
SKEW = dict(heavy_n=10, victim_n=2, prefix_t=8, horizon=8)


def _skew_pass(side, fair, pair):
    """One tenant-skew replay on one side, as bench_control serves it: a
    warm-up of four requests, the ring cleared, then the replay. Returns the
    scenario, the report, the tenant of each claim in order, and the
    batcher."""
    jm, params, tm = pair
    if side == "port":
        scn, ring = tenant_skew(**SKEW), FlightRecorder(ring_size=8192)
        b = _batcher(tm, flight_recorder=ring)
        plane_cls, cfg, policy, queue_cls, run = (ControlPlane, ControlConfig, TenantPolicy,
                                                  IntakeQueue, replay)
    else:
        scn, ring = jreplay.tenant_skew(**SKEW), JaxFlightRecorder(ring_size=8192)
        b = jsv.ContinuousBatcher(jm, params, flight_recorder=ring, **BATCHER_KW)
        plane_cls, cfg, policy, queue_cls, run = (jpolicy.ControlPlane, jctl.ControlConfig,
                                                  jctl.TenantPolicy, JaxIntakeQueue,
                                                  jreplay.replay)
    if fair:
        b.intake = plane_cls(cfg(tenants={"victim": policy(weight=4.0)})).intake(
            64, cost_fn=b._need_pages)
    else:
        b.intake = queue_cls(64, cost_fn=b._need_pages)
    for arrival in scn.arrivals[:4]:
        b.submit(arrival.request)
    b.run_pending(waves=False)
    ring.clear()
    report = run(b, scn, recorder=ring, run_pending_kwargs={"waves": False})
    claims = [e["args"].get("tenant") for e in ring.events() if e["name"] == "req.claim"]
    return scn, report, claims, b


def test_tenant_skew_replay_claim_order_equals_the_reference(pair):
    """Claim order, not milliseconds (ROADMAP C.9): under FIFO the victims
    claim behind the flood, under DRR in the first admission round, on
    both sides; the streams are bitwise the same under either policy."""
    seen = {}
    for fair in (False, True):
        scn, ours, ours_claims, b = _skew_pass("port", fair, pair)
        _, theirs, theirs_claims, _ = _skew_pass("reference", fair, pair)
        assert ours_claims == theirs_claims
        assert ours.admitted == theirs.admitted == {"flood": 10, "victim": 2}
        assert ours.outcomes == theirs.outcomes == {"flood": {"ok": 10}, "victim": {"ok": 2}}
        for g, w in zip(ours.results, theirs.results):
            np.testing.assert_allclose(g[:1], np.asarray(w)[:1], rtol=0, atol=1e-4)
            np.testing.assert_allclose(g, np.asarray(w), rtol=3e-2, atol=1.5e-2)
        assert int(b.state.free_top) == b.num_pages
        assert set(ours.tenant_latency) == {"flood", "victim"}
        assert ours.tenant_latency["victim"]["count"] == 2
        # results come back in drained order: key them by request
        order = ({i: i for i in range(12)} if not fair else
                 {pos: idx for pos, idx in enumerate(_drr_order(scn))})
        seen[fair] = {order[pos]: r for pos, r in enumerate(ours.results)}
        seen[f"claims{fair}"] = ours_claims
    assert seen["claimsFalse"][-2:] == ["victim", "victim"]
    assert seen["claimsTrue"][:3] == ["flood", "victim", "victim"]
    _bitwise([seen[True][i] for i in range(12)], [seen[False][i] for i in range(12)])


def _drr_order(scn):
    queue = ControlPlane(ControlConfig(tenants={"victim": TenantPolicy(weight=4.0)})).intake(64)
    for arrival in scn.arrivals:
        queue.offer(arrival.request)
    pending, _, _ = queue.drain_all()
    index = {id(a.request): i for i, a in enumerate(scn.arrivals)}
    return [index[id(r)] for r in pending]


def test_fold_tenant_latency_orders_by_claim(pair):
    _, _, tm = pair
    ring = FlightRecorder(ring_size=4096)
    _batcher(tm, flight_recorder=ring, slots=1).run([
        make_request(1, 8, 6, tenant="first"), make_request(2, 8, 6, tenant="second")])
    folded = fold_tenant_latency(ring.events())
    assert folded["second"]["p95_ms"] > folded["first"]["p95_ms"]
    assert fold_tenant_latency(ring.events()) == jreplay.fold_tenant_latency(ring.events())


def test_single_batcher_fair_intake_and_tenant_threading(pair):
    """A single-tenant fair intake serves FIFO's bits; tenants ride the
    claim instants into the tracker; a preempted request is an explicit
    outcome after the served ones."""
    _, _, tm = pair
    requests = [make_request(i, 8, 5) for i in range(5)]
    plain, fair = _batcher(tm), _batcher(tm)
    plain.intake = IntakeQueue(16, cost_fn=plain._need_pages)
    fair.intake = ControlPlane(ControlConfig()).intake(16, cost_fn=fair._need_pages)
    for r in requests:
        assert plain.submit(r).accepted and fair.submit(r).accepted
    _bitwise(fair.run_pending(waves=False), plain.run_pending(waves=False))
    ring = FlightRecorder(ring_size=4096)
    tracker = SLOTracker(SLOConfig(ttft_ms=60_000.0, tpot_ms=60_000.0))
    ring.add_listener(tracker.on_event)
    b = _batcher(tm, flight_recorder=ring)
    b.intake = ControlPlane(ControlConfig(), tracker=tracker).intake(2, cost_fn=b._need_pages)
    for r in (make_request(1, 8, 4, tenant="flood"), make_request(2, 8, 4, tenant="flood"),
              make_request(3, 8, 4, tenant="victim")):
        assert b.submit(r).accepted
    out = b.run_pending(waves=False)
    assert [type(r).__name__ for r in out] == ["ndarray", "ndarray", "Preempted"]
    assert out[2].tenant == "flood"
    assert {k: v["good"] for k, v in tracker.tenant_stats().items()} == {"flood": 1, "victim": 1}


def test_cluster_preemption_resolves_in_admission_order_and_reaches_tenant_burn(pair):
    _, _, tm = pair
    recorder = FlightRecorder(ring_size=4096)
    tracker = SLOTracker(SLOConfig(ttft_ms=60_000.0, tpot_ms=60_000.0, target=0.9))
    recorder.add_listener(tracker.on_event)
    plane = ControlPlane(ControlConfig(), tracker=tracker)
    sched = _cluster(tm, ClusterConfig(n_decode_workers=1, max_pending_per_shard=2),
                     control_plane=plane, flight_recorder=recorder)
    reqs = [make_request(1, 8, 4, tenant="flood"), make_request(2, 8, 4, tenant="flood"),
            make_request(3, 8, 4, tenant="victim")]
    for r in reqs:
        assert sched.submit(r).accepted
    out = sched.run_pending()
    assert [type(r).__name__ for r in out] == ["ndarray", "Preempted", "ndarray"]
    assert isinstance(out[1], Preempted) and out[1].tenant == "flood"
    _bitwise([out[0], out[2]], _batcher(tm).run([reqs[0], reqs[2]]))
    assert sched.shards[0].pool.committed == 0
    assert sched.shards[0].intake.take_preempted() == []
    dropped = [e for e in recorder.events() if e["name"] == "req.dropped"]
    assert [(e["args"]["gid"], e["args"]["tenant"]) for e in dropped] == [("s1", "flood")]
    stats = tracker.tenant_stats()
    assert (stats["flood"]["bad"], stats["flood"]["good"], stats["victim"]["good"]) == (1, 1, 1)


def test_cluster_routing_control_reasons_and_round_robin(pair):
    """Tail avoidance and deadline slack are counted as ``control_*``
    routes; a round-robin cluster keeps round-robining where the plane only
    agrees; the routed streams are one batcher's bits."""
    _, _, tm = pair
    tracker = SLOTracker(SLOConfig(ttft_ms=30_000.0))
    for _ in range(20):
        tracker.observe(0.010, worker="decode-0")
        tracker.observe(0.010, worker="decode-1")
    for _ in range(5):
        tracker.observe(2.0, worker="decode-0")
        tracker.observe(0.012, worker="decode-1")
    reg = Registry()
    # the deadline far inside its slack and far from expiry: it reads the
    # wall clock
    plane = ControlPlane(ControlConfig(routing=RoutingConfig(deadline_slack_s=600.0)),
                         tracker=tracker, registry=reg)
    sched = _cluster(tm, ClusterConfig(n_decode_workers=2), metrics=reg, control_plane=plane)
    from beholder_tpu_torch.reliability import Deadline

    plain = make_request(50, 8, 4)
    urgent = make_request(51, 8, 4, deadline=Deadline.after(300.0))
    for r in (plain, urgent):
        assert sched.submit(r).accepted
    assert [s.intake.depth for s in sched.shards] == [0, 2]
    text = reg.render()
    for line in ('beholder_cluster_routes_total{reason="control_tail_avoid"} 1',
                 'beholder_cluster_routes_total{reason="control_deadline"} 1',
                 'beholder_control_route_overrides_total{reason="tail_avoid"} 1',
                 'beholder_control_route_overrides_total{reason="deadline"} 1'):
        assert line in text
    _bitwise(sched.run_pending(), _batcher(tm).run([plain, urgent]))
    rr_reg = Registry()
    rr = _cluster(tm, ClusterConfig(n_decode_workers=2, route_policy=ROUTE_ROUND_ROBIN),
                  metrics=rr_reg, control_plane=ControlPlane(
                      ControlConfig(routing=RoutingConfig()), tracker=SLOTracker(SLOConfig())))
    for i in range(4):
        assert rr.submit(make_request(i, 8, 4)).accepted
    assert [s.intake.depth for s in rr.shards] == [2, 2]
    assert 'beholder_cluster_routes_total{reason="round_robin"} 4' in rr_reg.render()


def _scaling(tm, n_shards=1, **auto_kw):
    clock = [0.0]
    tracker = SLOTracker(SLOConfig(ttft_ms=10.0, target=0.9, fast_window_s=30.0),
                         clock=lambda: clock[0])
    kw = dict(min_shards=1, max_shards=2, up_burn=1.0, up_pressure=0.3, down_burn=0.5,
              down_pressure=0.2, sustain_s=1.0, cooldown_s=0.0)
    kw.update(auto_kw)
    plane = ControlPlane(ControlConfig(autoscale=AutoscaleConfig(**kw)), tracker=tracker,
                         clock=lambda: clock[0])
    sched = _cluster(tm, ClusterConfig(n_decode_workers=n_shards, failover=FailoverConfig()),
                     control_plane=plane, num_pages=16, max_pages_per_seq=8)
    return sched, plane, tracker, clock


def test_autoscaler_spawns_cools_down_and_drains_losslessly(pair):
    _, _, tm = pair
    sched, plane, tracker, clock = _scaling(tm, cooldown_s=30.0, max_shards=3)
    for _ in range(10):
        tracker.observe(5.0)
    first = [make_request(i, 8, 4) for i in range(4)]
    for r in first:
        assert sched.submit(r).accepted
    assert plane.evaluate_scaling(sched) is None  # arms the window
    clock[0] += 0.5
    assert plane.evaluate_scaling(sched) is None  # not sustained yet
    clock[0] += 1.0
    up = plane.evaluate_scaling(sched)
    assert up["direction"] == "up" and [s.pool.name for s in sched.shards] == [
        "decode-0", "decode-1"]
    clock[0] += 2.0
    assert plane.evaluate_scaling(sched) is None  # re-arms
    clock[0] += 2.0
    assert plane.evaluate_scaling(sched) is None  # sustained, inside the cooldown
    out1 = sched.run_pending()  # served across both shards
    assert all(s.batcher.ticks > 0 for s in sched.shards)
    clock[0] += 60.0
    tracker.observe(0.001)
    later = [make_request(100 + i, 8, 6) for i in range(2)]
    for r in later:
        assert sched.submit(r).accepted
    assert plane.evaluate_scaling(sched) is None  # arms the calm window
    clock[0] += 2.0
    ev = ScalingEvaluator(plane, sched, interval_s=1.0)
    down = ev.poll_once()
    assert (ev.evaluations, ev.errors) == (1, 0)
    assert down["direction"] == "down" and down["worker"] == "decode-1"
    assert down["requeued"] == 1 and sched.failover.drains == 1
    out2 = sched.run_pending()
    _bitwise(out1 + out2, _batcher(tm, num_pages=16).run(first + later))
    clock[0] += 60.0
    plane.evaluate_scaling(sched)
    clock[0] += 60.0
    assert plane.evaluate_scaling(sched) is None  # min_shards floor
    assert [e["direction"] for e in plane.scale_log] == ["up", "down"]
    for shard in sched.shards:
        assert int(shard.batcher.state.free_top) == shard.batcher.num_pages
        assert shard.pool.committed == 0


def test_k_sheds_under_burn_and_restores_bitwise_spec_off(pair):
    _, _, tm = pair
    clock = [0.0]
    tracker = SLOTracker(SLOConfig(ttft_ms=10.0, target=0.9, fast_window_s=30.0),
                         clock=lambda: clock[0])
    reg = Registry()
    plane = ControlPlane(ControlConfig(spec=SpecShedConfig(burn_threshold=2.0, shed_to=0)),
                         tracker=tracker, registry=reg)
    b = _batcher(tm, spec=SpecConfig(max_draft=3), fused_verify=True)
    plane.attach_spec(b)
    b.run_spec([make_request(1, 8, 6)])
    assert plane.k_shed_events == 0
    for _ in range(20):
        tracker.observe(5.0)
    capped = b.run_spec([make_request(2, 8, 6)])
    assert plane.k_shed_events > 0 and b._spec_controller.choose(0) == 0
    assert "beholder_control_k_shed_total" in reg.render()
    assert "beholder_control_k_cap 0" in reg.render()
    clock[0] += 60.0
    tracker.observe(0.001)
    assert b._spec_controller.choose(0) >= 1
    _bitwise(capped, _batcher(tm, spec=SpecConfig(max_draft=3), fused_verify=True).run_spec(
        [make_request(2, 8, 6)]))
    # a cluster's spec shards are attached at build
    sched = _cluster(tm, ClusterConfig(n_decode_workers=2), spec=SpecConfig(max_draft=3),
                     control_plane=plane)
    assert all(s.batcher._spec_k_cap_fn == plane.spec_k_cap for s in sched.shards)


def test_replay_recovery_storm_with_an_injected_kill(pair):
    _, _, tm = pair
    sched = _cluster(tm, ClusterConfig(n_decode_workers=2, failover=FailoverConfig()))
    sched.failover.inject_fault(WorkerFault("decode-0", kind="kill", after_dispatches=1))
    scn = recovery_storm(n=6, prefix_t=8, horizon=6)
    report = replay(sched, scn)
    assert report.outcomes == {"storm": {"ok": 6}} and report.admitted == {"storm": 6}
    assert sched.failover.recovered_total > 0
    _bitwise(report.results, [_batcher(tm).run([a.request])[0] for a in scn.arrivals])


def test_control_off_leaves_streams_and_exposition_byte_identical(pair):
    """No plane: nothing control-flavoured registers, and a cluster serves
    and routes as it did before the plane existed."""
    _, _, tm = pair
    assert control_from_config(ConfigNode({"instance": {}})) is None
    reqs = [make_request(i, 8, 5) for i in range(4)]
    renders, streams = [], []
    for _ in range(2):
        reg = Registry()
        sched = _cluster(tm, ClusterConfig(n_decode_workers=2), metrics=reg)
        assert sched.control_plane is None
        assert all(type(s.intake) is IntakeQueue for s in sched.shards)
        for r in reqs:
            assert sched.submit(r).accepted
        streams.append(sched.run_pending())
        renders.append([line for line in reg.render().splitlines()
                        if "_sum" not in line and "_bucket" not in line])
    assert renders[0] == renders[1]
    assert not any("beholder_control" in line or "beholder_slo" in line for line in renders[0])
    assert 'beholder_cluster_routes_total{reason="pressure"} 4' in renders[0]
    _bitwise(streams[0], streams[1])
    _bitwise(streams[0], _batcher(tm).run(reqs))
