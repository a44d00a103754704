"""The port's batcher intake, deadlines and instruments against the JAX
reference: ``submit`` / ``run_pending`` over the bounded and the
tenant-fair intake, request deadlines, the serving metrics' exposition,
tracer spans and the flight recorder.

Model: ``dim=32, heads=4, kv_heads=2, layers=2``, pages of 8, flax params
cast to bf16 for every leaf with ndim >= 2 and loaded through the weight
bridge; requests from numpy seeds. Tolerances, with their reasons:

- intake outcomes, shed reasons, preempted tenants, deadline outcome
  classes and partial-stream lengths, counter and gauge values, histogram
  counts and label sets, recorder phase sequences with their non-time
  tags, and the timelines the reference's ``build_timelines`` folds from
  the port's events: exactly equal — all host bookkeeping;
- served streams against the reference batcher: ``atol=1e-4``, the serving
  tests' band (``tests/test_torch_serving.py``: the same dtype mix op for
  op, only f32 summation order differs);
- within the port, everything armed against nothing armed:
  ``np.array_equal`` (the reference's own contract,
  ``tests/test_flight_recorder.py:99``, ``tests/test_slo.py:587``).

Histogram sums and bucket counts are times, so the exposition comparison
leaves them out and keeps each histogram's ``_count`` and bucket label
sets. The reference's spec loop runs eagerly (``jax.disable_jit()``), as in
``tests/test_torch_spec.py``: jitted, XLA keeps excess bf16 precision and
the n-gram acceptance decisions could differ.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from beholder_tpu.cache import PrefixCache as JaxPrefixCache
from beholder_tpu.control import ControlConfig as JaxControlConfig
from beholder_tpu.control import TenantPolicy as JaxTenantPolicy
from beholder_tpu.control.admission import Preempted as JaxPreempted
from beholder_tpu.control.admission import TenantFairQueue as JaxTenantFairQueue
from beholder_tpu.metrics import Registry as JaxRegistry
from beholder_tpu.models import TelemetrySequenceModel as JaxModel
from beholder_tpu.models import serving as jsv
from beholder_tpu.models.sequence import FEATURES
from beholder_tpu.obs import FlightRecorder as JaxFlightRecorder
from beholder_tpu.obs.timeline import build_timelines
from beholder_tpu.reliability import chaos as jchaos
from beholder_tpu.reliability.policy import Deadline as JaxDeadline
from beholder_tpu.reliability.shed import IntakeQueue as JaxIntakeQueue
from beholder_tpu.spec import SpecConfig as JaxSpecConfig
from beholder_tpu_torch.cache import PrefixCache
from beholder_tpu_torch.control import ControlConfig, Preempted, TenantFairQueue, TenantPolicy
from beholder_tpu_torch.metrics import Registry
from beholder_tpu_torch.models import TelemetrySequenceModel
from beholder_tpu_torch.models.bridge import load_flax_params
from beholder_tpu_torch.models.serving import ContinuousBatcher, DeadlineExceededResult, Request
from beholder_tpu_torch.obs import FlightRecorder
from beholder_tpu_torch.reliability import Deadline, IntakeQueue, trip_allocator
from beholder_tpu_torch.spec import SpecConfig
from beholder_tpu_torch.tracing import InMemoryReporter, Tracer

SIZES = dict(dim=32, heads=4, layers=2, kv_heads=2)
KW = dict(num_pages=16, page_size=8, slots=2, max_prefix=16, max_pages_per_seq=4)
TIME_ARGS = ("ceiling_frac",)


@pytest.fixture(scope="module")
def pair():
    jm = JaxModel(**SIZES)
    init = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 16, FEATURES)))["params"]
    params = jax.tree.map(
        lambda x: x.astype(jnp.bfloat16) if x.ndim >= 2 else x, {"params": init}
    )
    tm = TelemetrySequenceModel(**SIZES, device="cpu")
    load_flax_params(tm, jax.tree.map(np.asarray, params))
    return jm, params, tm


def _request(seed, t=9, horizon=4, **kw):
    rng = np.random.default_rng(seed)
    return Request(np.cumsum(1.0 + rng.normal(0, 0.05, t + 1)), np.full(t + 1, 2), horizon,
                   **kw)


def _jreq(req, **kw):
    return jsv.Request(req.progress, req.statuses, req.horizon, **kw)


def _port(tm, **kw):
    return ContinuousBatcher(tm, **{**KW, **kw}, device="cpu")


def _ref(pair, **kw):
    jm, params, _ = pair
    return jsv.ContinuousBatcher(jm, params, **{**KW, **kw})


def _assert_streams_close(got, want):
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert type(g).__name__ == type(w).__name__, f"result {i}"
        if isinstance(g, np.ndarray):
            assert g.shape == w.shape, f"result {i}"
            np.testing.assert_allclose(g, np.asarray(w), rtol=0, atol=1e-4,
                                       err_msg=f"result {i}")


def _exposition(text: str) -> dict:
    """An exposition as comparable data: every line but the times
    (histogram ``_sum`` lines and bucket counts; bucket label sets kept).
    An unnamed intake queue is named from a per-process counter
    (``serving.intake``, then ``serving.intake-2``, ...), which differs
    between the two packages once a process has built other queues, so
    that suffix is dropped."""
    text = re.sub(r'queue="serving\.intake-\d+"', 'queue="serving.intake"', text)
    hists = {line.split()[2] for line in text.splitlines()
             if line.startswith("# TYPE") and line.endswith(" histogram")}
    out = {}
    for line in text.splitlines():
        if not line or line.startswith("#"):
            out[line] = None
            continue
        series, value = line.rsplit(" ", 1)
        name = series.split("{")[0]
        base = next((h for h in hists if name in (f"{h}_bucket", f"{h}_sum", f"{h}_count")),
                    None)
        if base is None or name == f"{base}_count":
            out[series] = value
        elif name == f"{base}_bucket":
            out[series] = None
    return out


def _phases(events) -> list:
    """(name, ph, non-time args) of every recorder event, in order."""
    return [(e["name"], e["ph"],
             {k: v for k, v in e["args"].items() if k not in TIME_ARGS})
            for e in events]


def _folded(events) -> list:
    """The reference's timeline fold of one event stream: (outcome, tokens,
    horizon, prefix tokens) per request, by rid."""
    report = build_timelines(events)
    return sorted((t.key[1], t.outcome, t.tokens, t.horizon, t.prefix_tokens)
                  for t in report.timelines)


# -- intake ---------------------------------------------------------------------------------


def test_intake_queue_sheds_and_renders_like_the_reference():
    """``tests/test_reliability.py:518`` on both sides: the same accept/shed
    sequence and the same exposition (the intake wait histogram's times
    aside)."""
    outs = []
    texts = []
    for queue_cls, registry in ((IntakeQueue, Registry()), (JaxIntakeQueue, JaxRegistry())):
        q = queue_cls(max_depth=2, max_cost=10, cost_fn=lambda item: item, metrics=registry,
                      name="serving.intake")
        seq = [q.offer(4), q.offer(4), q.offer(1), q.take_all(), q.offer(11), q.offer(8),
               q.offer(8), q.depth, q.pending_cost, dict(q.shed_counts)]
        outs.append([tuple(o) if isinstance(o, tuple) else o for o in seq])
        texts.append(registry.render())
    assert outs[0] == outs[1]
    assert outs[0][2] == (False, "queue_full") and outs[0][4] == (False, "oversized")
    assert outs[0][6] == (False, "cost_backlog")
    assert _exposition(texts[0]) == _exposition(texts[1])
    assert 'beholder_serving_shed_total{reason="queue_full"} 1' in texts[0]


def test_batcher_bounded_intake_matches_the_reference(pair):
    """``tests/test_reliability.py:565`` on both sides: four submits into a
    queue of two (two accepted, two ``queue_full``), ``run_pending`` serves
    the two within the serving band of the reference's, the queue drains,
    an unservable request sheds as ``oversized`` before any page is touched,
    and the shed and admitted series read the same."""
    sides = []
    for make, req_of, registry in ((lambda **kw: _port(pair[2], **kw), lambda r: r,
                                    Registry()),
                                   (lambda **kw: _ref(pair, **kw), _jreq, JaxRegistry())):
        b = make(metrics=registry, max_pending=2)
        outcomes = [tuple(b.submit(req_of(_request(i)))) for i in range(4)]
        depth = b.intake.depth
        results = b.run_pending()
        drained = (b.intake.depth, b.run_pending())
        big = tuple(b.submit(req_of(_request(0, horizon=200))))
        sides.append((outcomes, depth, results, drained, big, registry.render(), b))
    port, ref = sides
    assert port[0] == ref[0] == [(True, None)] * 2 + [(False, "queue_full")] * 2
    assert port[1] == ref[1] == 2
    _assert_streams_close(port[2], ref[2])
    assert port[3] == ref[3] == (0, [])
    assert port[4] == ref[4] == (False, "oversized")
    for line in ('beholder_serving_shed_total{reason="queue_full"} 2',
                 'beholder_serving_shed_total{reason="oversized"} 1',
                 "beholder_serving_admitted_total 2"):
        assert line in port[5] and line in ref[5]
    assert _exposition(port[5]) == _exposition(ref[5])
    assert int(port[6].state.free_top) == port[6].num_pages


@pytest.mark.parametrize("path", ["waves", "prefix", "spec", "explicit_run"])
def test_run_pending_chooses_its_path_and_keeps_admission_order(pair, path):
    """``run_waves`` by default, ``run`` with a prefix cache (or
    ``waves=False``), ``run_spec`` with ``spec``: the root span names the
    path taken, and the results are bitwise those of calling that path on a
    bare batcher with the same requests, in admission order."""
    tm = pair[2]
    kw = {"prefix": dict(prefix_cache=PrefixCache(8)),
          "spec": dict(spec=SpecConfig(max_draft=2))}.get(path, {})
    tracer = Tracer("t", reporter=InMemoryReporter())
    b = _port(tm, max_pending=4, tracer=tracer, **kw)
    reqs = [_request(i, horizon=3 + i) for i in range(3)]
    assert all(b.submit(r).accepted for r in reqs)
    got = b.run_pending(waves=False) if path == "explicit_run" else b.run_pending()
    op = {"waves": "run_waves", "prefix": "run", "spec": "run_spec",
          "explicit_run": "run"}[path]
    roots = [s.operation for s in tracer.reporter.spans if s.context.parent_id == 0]
    assert roots == [f"serving.{op}"]
    bare_kw = {"prefix": dict(prefix_cache=PrefixCache(8)),
               "spec": dict(spec=SpecConfig(max_draft=2))}.get(path, {})
    want = getattr(_port(tm, **bare_kw), op)(reqs)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert [len(g) for g in got] == [r.horizon for r in reqs]


def test_submit_needs_an_intake(pair):
    b = _port(pair[2])
    with pytest.raises(RuntimeError, match="no intake queue"):
        b.submit(_request(0))
    with pytest.raises(RuntimeError, match="no intake queue"):
        b.run_pending()


def test_tenant_fair_preemption_appends_the_reference_outcomes(pair):
    """``tests/test_control.py:292`` on both sides: a full queue of two
    ``flood`` requests, then a ``victim`` offer preempts the newest flood
    request; ``run_pending(waves=False)`` serves two and appends one
    ``Preempted("flood")``, and nothing is preempted twice."""
    sides = []
    for b, queue_cls, cfg, req_of, pre_cls in (
        (_port(pair[2], num_pages=64, max_pages_per_seq=8), TenantFairQueue, ControlConfig(),
         lambda r, t: r._replace(tenant=t), Preempted),
        (_ref(pair, num_pages=64, max_pages_per_seq=8), JaxTenantFairQueue, JaxControlConfig(),
         lambda r, t: _jreq(r, tenant=t), JaxPreempted),
    ):
        b.intake = queue_cls(2, cfg, cost_fn=b._need_pages)
        adm = [tuple(b.submit(req_of(_request(i, t=8), t)))
               for i, t in enumerate(["flood", "flood", "victim"])]
        out = b.run_pending(waves=False)
        tail = [(type(r) is pre_cls, r.tenant, r.outcome, r.reason) for r in out
                if isinstance(r, pre_cls)]
        served = [r for r in out if isinstance(r, np.ndarray)]
        sides.append((adm, tail, served, b.intake.take_preempted()))
    port, ref = sides
    assert port[0] == ref[0] == [(True, None)] * 3
    assert port[1] == ref[1] == [(True, "flood", "preempted", "tenant_preempted")]
    _assert_streams_close(port[2], ref[2])
    assert port[3] == ref[3] == []


@pytest.mark.parametrize("seed", range(4))
def test_tenant_fair_queue_orders_and_sheds_like_the_reference(seed):
    """Random tenanted offers under weights and quotas, with drains in
    between: the same outcomes, the same deficit-round-robin drain order and
    the same preempted items on both sides."""
    rng = np.random.default_rng(seed)
    tenants = ["a", "b", "c", None]
    policies = {"a": (3.0, None), "b": (1.0, 3), "c": (0.5, None)}
    port_q = TenantFairQueue(
        5, ControlConfig(tenants={k: TenantPolicy(w, q) for k, (w, q) in policies.items()}),
        max_cost=40, cost_fn=lambda item: item[1])
    ref_q = JaxTenantFairQueue(
        5, JaxControlConfig(tenants={k: JaxTenantPolicy(w, q) for k, (w, q) in policies.items()}),
        max_cost=40, cost_fn=lambda item: item[1])

    class Item(tuple):
        @property
        def tenant(self):
            return self[0]

    log = {id(port_q): [], id(ref_q): []}
    for step in range(40):
        item = Item((tenants[rng.integers(4)], int(rng.integers(1, 12)), step))
        for q in (port_q, ref_q):
            log[id(q)].append(tuple(q.offer(item)))
        if rng.random() < 0.15:
            for q in (port_q, ref_q):
                log[id(q)].append(q.take_all())
                log[id(q)].append(q.take_preempted())
    for q in (port_q, ref_q):
        log[id(q)].append(q.take_all())
        log[id(q)].append(dict(q.shed_counts))
    assert log[id(port_q)] == log[id(ref_q)]


# -- deadlines --------------------------------------------------------------------------------


class _Lapsing:
    """Passes the claim-time check, expires at the next sweep
    (``tests/test_slo.py:269-277``)."""

    def __init__(self):
        self.checks = 0

    @property
    def expired(self):
        self.checks += 1
        return self.checks > 1


@pytest.mark.parametrize("case", ["claim", "lapsing"])
def test_deadline_outcomes_match_the_reference(pair, case):
    """An already-expired deadline returns a ``DeadlineExceededResult`` with
    no tokens; one that lapses at the sweep after the short request retires
    returns its partial stream (1 to horizon-1 tokens). The same outcome
    classes, partial lengths and ``beholder_failover_deadline_exceeded_total``
    on both sides, the partial tokens within the serving band, and the pages
    come home."""
    sides = []
    for registry, make_deadline, req_of in (
        (Registry(), lambda: Deadline.after(-1.0), lambda r, d: r._replace(deadline=d)),
        (JaxRegistry(), lambda: JaxDeadline.after(-1.0), lambda r, d: _jreq(r, deadline=d)),
    ):
        b = (_port(pair[2], metrics=registry) if isinstance(registry, Registry)
             else _ref(pair, metrics=registry))
        base = _request(1, horizon=12)
        deadline = make_deadline() if case == "claim" else _Lapsing()
        out = b.run([req_of(_request(0, horizon=3), None), req_of(base, deadline)])
        counter = registry.find("beholder_failover_deadline_exceeded_total")
        sides.append((out, counter.value() if counter else None, b))
    (port_out, port_n, b), (ref_out, ref_n, _) = sides
    assert _exposition(sides[0][2]._registry.render()) == _exposition(
        sides[1][2]._registry.render())
    assert isinstance(port_out[1], DeadlineExceededResult)
    assert type(ref_out[1]).__name__ == "DeadlineExceededResult"
    np.testing.assert_allclose(port_out[0], np.asarray(ref_out[0]), rtol=0, atol=1e-4)
    got, want = port_out[1].tokens, np.asarray(ref_out[1].tokens)
    assert got.shape == want.shape
    if case == "claim":
        assert got.shape == (0,)
    else:
        assert 1 <= got.shape[0] < 12
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    assert port_n == ref_n == 1
    assert int(b.state.free_top) == b.num_pages
    assert not bool(b.state.active.any())


def test_deadline_counter_registers_on_first_use_only(pair):
    registry = Registry()
    b = _port(pair[2], metrics=registry)
    b.run([_request(0)])
    assert registry.find("beholder_failover_deadline_exceeded_total") is None
    b.run([_request(0, deadline=Deadline.after(-1.0))])
    assert registry.find("beholder_failover_deadline_exceeded_total").value() == 1


# -- exposition ---------------------------------------------------------------------------


def _serve_all(b, reqs, spec=False):
    """run, run_waves and run_what_if (or run_spec) on one batcher."""
    out = [b.run(reqs), b.run_waves(reqs)]
    r = reqs[0]
    out.append([b.run_what_if(r.progress, r.statuses, [2, 4], 5)])
    if spec:
        out.append(b.run_spec(reqs))
    return out


def test_exposition_matches_the_reference(pair):
    """The same requests through ``run``, ``run_waves``, ``run_what_if`` and
    a prefix-cache batcher's cold and warm ``run`` with a registry on each
    side: the same series, label sets, counter and gauge values, and
    histogram counts."""
    reqs = [_request(i, horizon=3 + i) for i in range(3)]
    texts = []
    for b, registry, cache, req_of in (
        (None, Registry(), PrefixCache, lambda r: r),
        (None, JaxRegistry(), JaxPrefixCache, _jreq),
    ):
        if isinstance(registry, Registry):
            b = _port(pair[2], metrics=registry)
            pb = _port(pair[2], metrics=registry, prefix_cache=cache(8, metrics=registry))
        else:
            b = _ref(pair, metrics=registry)
            pb = _ref(pair, metrics=registry, prefix_cache=cache(8, metrics=registry))
        rs = [req_of(r) for r in reqs]
        _serve_all(b, rs)
        pb.run(rs)
        pb.run(rs)
        texts.append(registry.render())
    assert _exposition(texts[0]) == _exposition(texts[1])
    assert "beholder_prefix_cache_hits_total 3" in texts[0]
    assert "beholder_serving_requests_total 13" in texts[0]


def test_spec_exposition_matches_the_reference(pair):
    """``run_spec`` (n-gram, ``accept_tol=1e-2`` so some drafts are
    accepted and some rolled back) with a registry: the same
    ``beholder_spec_*`` and serving series on both sides."""
    reqs = [_request(i, horizon=6) for i in range(3)]
    port_reg, ref_reg = Registry(), JaxRegistry()
    got = _port(pair[2], metrics=port_reg,
                spec=SpecConfig(max_draft=3, accept_tol=1e-2)).run_spec(reqs)
    with jax.disable_jit():
        want = _ref(pair, metrics=ref_reg,
                    spec=JaxSpecConfig(max_draft=3, accept_tol=1e-2)).run_spec(
                        [_jreq(r) for r in reqs])
    _assert_streams_close(got, want)
    port_text, ref_text = port_reg.render(), ref_reg.render()
    assert _exposition(port_text) == _exposition(ref_text)
    assert port_reg.find("beholder_spec_verify_steps_total").value() > 0


def test_replacement_batcher_reattaches_and_kind_clash_raises(pair):
    """A fresh batcher on the same registry re-attaches to the series
    (counters keep counting); a name held by another kind raises at
    construction, not mid-run."""
    registry = Registry()
    _port(pair[2], metrics=registry).run([_request(0)])
    _port(pair[2], metrics=registry).run([_request(1)])
    assert registry.find("beholder_serving_requests_total").value() == 2
    clash = Registry()
    clash.gauge("beholder_serving_requests_total", "x")
    with pytest.raises(ValueError, match="already registered as a Gauge"):
        _port(pair[2], metrics=clash)


# -- flight recorder --------------------------------------------------------------------------


def _recorded(pair, mode, side):
    """One scheduler call on ``side`` ("port" or "ref") with a recorder:
    its events."""
    reqs = [_request(i, horizon=3 + 2 * i) for i in range(3)]
    if side == "port":
        fr = FlightRecorder(ring_size=4096)
        make = lambda **kw: _port(pair[2], flight_recorder=fr, **kw)  # noqa: E731
        spec_cls, rs = SpecConfig, reqs
    else:
        fr = JaxFlightRecorder(ring_size=4096)
        make = lambda **kw: _ref(pair, flight_recorder=fr, **kw)  # noqa: E731
        spec_cls, rs = JaxSpecConfig, [_jreq(r) for r in reqs]
    if mode == "run":
        make().run(rs)
    elif mode == "run_waves":
        make().run_waves(rs)
    elif mode == "what_if":
        make().run_what_if(rs[0].progress, rs[0].statuses, [2, 4], 5)
    elif mode == "prefix":
        b = make(prefix_cache=(PrefixCache if side == "port" else JaxPrefixCache)(8))
        b.run(rs)
        b.run(rs)
    else:
        b = make(spec=spec_cls(max_draft=3, accept_tol=1e-2), fused_verify=mode == "spec_fused")
        if side == "ref":
            with jax.disable_jit():
                b.run_spec(rs)
        else:
            b.run_spec(rs)
    return fr.events()


@pytest.mark.parametrize("mode", ["run", "run_waves", "what_if", "prefix", "spec_dense",
                                  "spec_fused"])
def test_recorder_phases_and_timelines_match_the_reference(pair, mode):
    """The same phases in the same order with the same non-time tags (kernel
    families and FLOPs included) on both sides; the port's events folded by
    the reference's ``build_timelines`` give the per-request outcomes and
    token counts the reference's own events do."""
    port = _recorded(pair, mode, "port")
    ref = _recorded(pair, mode, "ref")
    assert _phases(port) == _phases(ref)
    names = {e["name"] for e in port}
    if mode != "what_if":
        assert _folded(port) == _folded(ref)
        assert all(t[1] == "ok" for t in _folded(port))
        assert "req.claim" in names and "req.retire" in names
    if mode.startswith("spec"):
        assert {"claim", "admit", "draft", "verify", "retire", "spec.accept",
                "device_wait"} <= names
        fams = {e["args"].get("family") for e in port if e["name"] == "verify"}
        assert fams == ({"paged_chunk:bf16"} if mode == "spec_fused" else {"verify"})
        if mode == "spec_dense":
            assert "rollback" in names


def test_recorder_run_deadline_timeline_matches_the_reference(pair):
    """``tests/test_slo.py:262``: a lapsing deadline leaves a
    ``deadline_exceeded`` timeline with its partial tokens, folded from the
    port's events as from the reference's."""
    folds = []
    for b, fr, req_of in ((None, FlightRecorder(), lambda r, d: r._replace(deadline=d)),
                          (None, JaxFlightRecorder(), lambda r, d: _jreq(r, deadline=d))):
        b = (_port(pair[2], flight_recorder=fr) if isinstance(fr, FlightRecorder)
             else _ref(pair, flight_recorder=fr))
        b.run([req_of(_request(0, horizon=3), None), req_of(_request(1, horizon=12), _Lapsing())])
        folds.append((_folded(fr.events()), _phases(fr.events())))
    assert folds[0] == folds[1]
    outcomes = {t[1]: t[2] for t in folds[0][0]}
    assert set(outcomes) == {"ok", "deadline_exceeded"}
    assert 1 <= outcomes["deadline_exceeded"] < 12


def test_run_pending_timelines_carry_queue_wait(pair):
    """``run_pending`` stamps each request's intake wait on its claim and
    retire instants (``tests/test_slo.py:301``)."""
    fr = FlightRecorder()
    b = _port(pair[2], flight_recorder=fr, max_pending=8)
    for i in range(3):
        assert b.submit(_request(i, horizon=5)).accepted
    b.run_pending()
    report = build_timelines(fr.events())
    assert len(report.timelines) == 3
    for t in report.timelines:
        assert t.outcome == "ok" and t.tokens == 5 and t.queue_wait_s >= 0
        assert "wave" in t.phases


def test_ring_stays_bounded_under_serving(pair):
    fr = FlightRecorder(ring_size=16)
    b = _port(pair[2], flight_recorder=fr)
    for _ in range(3):
        b.run([_request(i, horizon=7) for i in range(3)])
    assert len(fr) == len(fr.events()) == 16
    assert fr.dropped > 0 and fr.high_water == 16


def test_stall_marker_on_pressure_deferral(pair):
    """A request deferred for pool pressure leaves a ``stall`` instant."""
    fr = FlightRecorder()
    b = _port(pair[2], flight_recorder=fr, num_pages=4, max_prefix=24)
    b.run([_request(i, t=17, horizon=8) for i in range(2)])
    stalls = [e for e in fr.events() if e["name"] == "stall"]
    assert stalls and stalls[0]["args"]["reason"] == "pressure_deferral"


# -- spans ------------------------------------------------------------------------------------


def test_run_spans_and_recorder_share_one_trace(pair, tmp_path):
    """``tests/test_flight_recorder.py`` (run phases land with trace ids)
    and ``tests/test_observability.py:146`` (observations carry the active
    trace id): every recorder event of a ``run`` carries the run span's
    trace id, each round is a child span of it, and the round histogram's
    observations in the observation log carry that trace id too."""
    from beholder_tpu_torch.metrics import configure_observation_log

    log = tmp_path / "obs.jsonl"
    configure_observation_log(str(log))
    try:
        fr = FlightRecorder()
        tracer = Tracer("serving", reporter=InMemoryReporter())
        registry = Registry()
        b = _port(pair[2], tracer=tracer, flight_recorder=fr, metrics=registry)
        b.run([_request(i, horizon=5) for i in range(3)])
    finally:
        configure_observation_log(None)
    (root,) = tracer.reporter.by_operation("serving.run")
    trace_hex = f"{root.context.trace_id:032x}"
    events = fr.events()
    assert {"claim", "admit", "tick", "retire", "readback"} <= {e["name"] for e in events}
    assert all(e["trace_id"] == trace_hex for e in events)
    children = [s for s in tracer.reporter.spans if s is not root]
    assert children and all(s.context.parent_id == root.context.span_id for s in children)
    import json

    lines = [json.loads(line) for line in log.read_text().splitlines()]
    rounds = [x for x in lines if x["metric"] == "beholder_serving_round_duration_seconds"]
    assert rounds and all(x["trace_id"] == trace_hex for x in rounds)
    ex = registry.find("beholder_serving_round_duration_seconds").exemplars(phase="tick")
    assert ex and all(v["trace_id"] == trace_hex for v in ex.values())


def test_request_traceparent_names_its_claim_trace(pair):
    """A request carrying a W3C ``traceparent`` hands that trace id to its
    ``req.claim`` instant (the reference's string, parsed by the port)."""
    from beholder_tpu.tracing import SpanContext as JaxSpanContext
    from beholder_tpu.tracing import to_traceparent as jax_to_traceparent

    tp = jax_to_traceparent(JaxSpanContext(0xABC, 0xDEF))
    fr = FlightRecorder()
    _port(pair[2], flight_recorder=fr).run([_request(0, traceparent=tp), _request(1)])
    claims = {e["args"]["rid"]: e["trace_id"] for e in fr.events() if e["name"] == "req.claim"}
    assert claims[0] == f"{0xABC:032x}" and claims[1] is None


# -- off == on --------------------------------------------------------------------------------


@pytest.mark.parametrize("path", ["run", "run_waves", "run_pending", "what_if", "prefix",
                                  "spec_dense", "spec_fused"])
def test_everything_armed_serves_the_same_bits(pair, path):
    """Metrics, tracer, flight recorder (with a CPU roofline attributor),
    intake and never-expiring deadlines all armed against nothing armed:
    ``np.array_equal`` on every path; a bare batcher registers nothing and
    a recorder adds no series to a registry."""
    from beholder_tpu_torch.obs import RooflineAttributor

    tm = pair[2]
    reqs = [_request(i, horizon=3 + 2 * i) for i in range(3)]
    extra = {"prefix": dict(fused_verify=True),
             "spec_dense": dict(spec=SpecConfig(max_draft=3, accept_tol=1e-2)),
             "spec_fused": dict(spec=SpecConfig(max_draft=3, accept_tol=1e-2),
                                fused_verify=True)}.get(path, {})

    def serve(b, rs):
        if path == "what_if":
            return b.run_what_if(rs[0].progress, rs[0].statuses, [2, 4], 6)
        if path.startswith("spec"):
            return b.run_spec(rs)
        if path == "run_waves":
            return b.run_waves(rs)
        if path == "run_pending":
            if b.intake is None:
                return b.run_waves(rs)
            assert all(b.submit(r).accepted for r in rs)
            return b.run_pending()
        out = b.run(rs)
        return out + b.run(rs) if path == "prefix" else out

    bare = _port(tm, prefix_cache=PrefixCache(8) if path == "prefix" else None, **extra)
    assert bare._metrics is None and bare._registry is None and bare.intake is None
    want = serve(bare, reqs)

    registry = Registry()
    armed = _port(tm, metrics=registry, tracer=Tracer("t"), max_pending=8,
                  flight_recorder=FlightRecorder(
                      attributor=RooflineAttributor(device="cpu", matmul_n=32, copy_mb=0.01)),
                  prefix_cache=PrefixCache(8, metrics=registry) if path == "prefix" else None,
                  **extra)
    armed_reqs = [r._replace(deadline=Deadline.after(3600.0), tenant="t") for r in reqs]
    got = serve(armed, armed_reqs)
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w), err_msg=f"result {i}")
    assert int(armed.state.free_top) == int(bare.state.free_top)

    plain_reg, recorded_reg = Registry(), Registry()
    serve(_port(tm, metrics=plain_reg, **extra), reqs)
    serve(_port(tm, metrics=recorded_reg, flight_recorder=FlightRecorder(), **extra), reqs)
    names = lambda r: {m.name for m in r._metrics}  # noqa: E731
    assert names(plain_reg) == names(recorded_reg)


# -- chaos ------------------------------------------------------------------------------------


def test_trip_allocator_surfaces_the_error_and_poisons(pair):
    """``tests/test_reliability.py:587``: a tripped allocator flag raises
    "pool exhausted", then every later call asks for a fresh batcher; the
    reference's twin raises the same on its own batcher."""
    for b, trip in ((_port(pair[2]), trip_allocator), (_ref(pair), jchaos.trip_allocator)):
        req_of = (lambda r: r) if isinstance(b, ContinuousBatcher) else _jreq
        trip(b)
        with pytest.raises(RuntimeError, match="pool exhausted"):
            b.run_waves([req_of(_request(0))])
        with pytest.raises(RuntimeError, match="fresh ContinuousBatcher"):
            b.run_waves([req_of(_request(1))])
