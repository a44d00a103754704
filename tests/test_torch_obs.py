"""The port's host-side instruments and the small leftovers of ported
modules against the JAX reference.

Instruments: tracing (span contexts, propagation, sampling, the active
span), metrics (exposition text, exemplars, the trace-linked observation
log and its rotation), deadlines, the flight recorder (ring, listeners,
export, Chrome trace), roofline attribution, and the spec and prefix-cache
metric catalogs. Leftovers: ``forecast_eta``, ``full_attention`` with
segment ids, and the weight quantizers.

Tolerances, with their reasons:

- exposition text, span and trace-context strings, Chrome trace events,
  attribution summaries, ``model_flops_per_token``: exactly equal — the
  same host arithmetic on the same inputs;
- ``full_attention(segment_ids=...)`` in f32: ``rtol=1e-4, atol=1e-5``,
  ``tests/test_flash_attention.py``'s band;
- ``forecast_eta``: ``eta`` and ``reached`` exactly equal, at targets that
  lie farther from every forecast value than the two sides' forecasts lie
  from each other (fed-back forecasts drift within the serving band,
  ``tests/test_torch_models.py``), so a crossing cannot flip on rounding;
- weight quantizers: values and scales bit for bit after the (in, out) ->
  (out, in) transpose, ``quantized_nbytes`` equal.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from beholder_tpu import metrics as jmetrics
from beholder_tpu import tracing as jtracing
from beholder_tpu.models import TelemetrySequenceModel as JaxModel
from beholder_tpu.models.decode import forecast_deltas as jax_forecast
from beholder_tpu.models.decode import forecast_eta as jax_forecast_eta
from beholder_tpu.models.sequence import FEATURES
from beholder_tpu.obs import FlightRecorder as JaxFlightRecorder
from beholder_tpu.obs import attribution_summary as jax_attribution_summary
from beholder_tpu.obs import model_flops_per_token as jax_flops
from beholder_tpu.obs.recorder import parse_cursor as jax_parse_cursor
from beholder_tpu.ops import quant as jquant
from beholder_tpu.ops.attention import full_attention as jax_full_attention
from beholder_tpu.reliability import policy as jpolicy
from beholder_tpu.spec.instruments import SpecMetrics as JaxSpecMetrics
from beholder_tpu.cache.instruments import PrefixCacheMetrics as JaxPrefixCacheMetrics
from beholder_tpu.tools.trace_export import chrome_trace as jax_chrome_trace
from beholder_tpu_torch import metrics as tmetrics
from beholder_tpu_torch import tracing as ttracing
from beholder_tpu_torch.cache.instruments import PrefixCacheMetrics
from beholder_tpu_torch.models import TelemetrySequenceModel, forecast_deltas, forecast_eta
from beholder_tpu_torch.models.bridge import load_flax_params
from beholder_tpu_torch.obs import (
    FlightRecorder,
    RooflineAttributor,
    attribution_summary,
    chrome_trace,
    model_flops_per_token,
    parse_cursor,
)
from beholder_tpu_torch.ops import quant as tquant
from beholder_tpu_torch.ops.attention import full_attention
from beholder_tpu_torch.reliability import policy as tpolicy
from beholder_tpu_torch.spec.instruments import SpecMetrics

# -- tracing ----------------------------------------------------------------------------------


@pytest.mark.parametrize("ids", [(1, 2, 0, 1), (0xABCDEF << 64, 2**64 - 1, 7, 0),
                                 (2**128 - 1, 1, 2**64 - 1, 1)])
def test_span_context_propagation_matches_the_reference(ids):
    """jaeger text-map and W3C ``traceparent`` strings: the port writes the
    reference's strings and reads them back (and the reference reads the
    port's)."""
    t, j = ttracing.SpanContext(*ids), jtracing.SpanContext(*ids)
    assert t.encode() == j.encode()
    assert ttracing.to_traceparent(t) == jtracing.to_traceparent(j)
    carrier_t, carrier_j = ttracing.inject(t, {}), jtracing.inject(j, {})
    assert carrier_t == carrier_j
    back = ttracing.extract(carrier_j)
    assert (back.trace_id, back.span_id, back.parent_id, back.flags) == ids
    tp = jtracing.to_traceparent(j)
    parsed = ttracing.from_traceparent(tp)
    want = jtracing.from_traceparent(tp)
    assert (parsed is None) == (want is None)
    if want is not None:
        assert parsed.encode() == want.encode()
        assert ttracing.extract({"traceparent": tp}).encode() == want.encode()


@pytest.mark.parametrize("value", ["", "garbage", "00-" + "0" * 32 + "-" + "1" * 16 + "-01",
                                   "00-" + "a" * 31 + "-" + "1" * 16 + "-01",
                                   "zz-" + "a" * 32 + "-" + "1" * 16 + "-01",
                                   " 00-" + "a" * 32 + "-" + "b" * 16 + "-00 "])
def test_malformed_trace_context_reads_as_the_reference(value):
    got, want = ttracing.from_traceparent(value), jtracing.from_traceparent(value)
    assert (got is None) == (want is None)
    assert ttracing.extract({"uber-trace-id": value}) is None or value == ""
    assert (ttracing.extract({"traceparent": value}) is None) == (
        jtracing.extract({"traceparent": value}) is None)


def test_spans_nest_sample_and_report():
    """Children inherit the trace and the sampling decision through the
    active context, an unsampled root suppresses its whole trace, errors
    are tagged, ``flush`` reports open spans."""
    tracer = ttracing.Tracer("svc", reporter=ttracing.InMemoryReporter())
    with tracer.start_span("root") as root:
        assert ttracing.current_trace_id() == f"{root.context.trace_id:032x}"
        child = tracer.start_span("child")
        assert child.context.trace_id == root.context.trace_id
        assert child.context.parent_id == root.context.span_id
        child.finish()
    assert ttracing.current_trace_id() is None
    with pytest.raises(KeyError), tracer.start_span("fails"):
        raise KeyError("x")
    assert tracer.reporter.by_operation("fails")[0].tags["error"] is True
    mute = ttracing.Tracer("svc", reporter=ttracing.InMemoryReporter(), sample_rate=0.5,
                           _rand=lambda: 0.9)
    with mute.start_span("root") as noop:
        assert not noop.context.sampled
        assert not mute.start_span("child").context.sampled
    assert mute.reporter.spans == []
    open_span = tracer.start_span("open")
    assert tracer.flush() == 1 and open_span.tags["flushed_at_shutdown"]
    d = open_span.to_dict()
    assert d["operationName"] == "open" and d["traceID"] == f"{open_span.context.trace_id:032x}"


# -- metrics ----------------------------------------------------------------------------------


def _exercise(mod):
    """The same metric operations on one metrics module; returns the
    registry's exposition."""
    reg = mod.Registry()
    c = reg.counter("c_total", "a counter", labelnames=["status"])
    c.inc(status="ok")
    c.inc(2.5, status='we"ird\\\n')
    plain = reg.counter("plain_total", "unlabelled")
    plain.inc(3)
    g = reg.gauge("g", "a gauge", labelnames=["queue"])
    g.set(4, queue="a")
    g.set(0.125, queue="b")
    h = reg.histogram("h_seconds", "a histogram", labelnames=["phase"],
                      buckets=(0.1, 1.0, 0.01))
    for v in (0.005, 0.01, 0.5, 3.0, 1.0):
        h.observe(v, phase="tick")
    h.observe(0.2, phase="admit")
    reg.histogram("empty_seconds", "no labels")
    assert mod.get_or_create(reg, "counter", "c_total", "x", labelnames=["status"]) is c
    with pytest.raises(ValueError, match="already registered as a Histogram"):
        mod.get_or_create(reg, "gauge", "h_seconds", "x")
    with pytest.raises(ValueError, match="duplicate metric"):
        reg.gauge("g", "again")
    with pytest.raises(ValueError, match="expected labels"):
        c.inc(wrong="x")
    assert c.value(status="ok") == 1 and c.total() == 3.5 and h.count(phase="tick") == 5
    return reg.render()


def test_exposition_text_is_the_references():
    assert _exercise(tmetrics) == _exercise(jmetrics)


def test_exemplars_and_observation_log_carry_trace_ids(tmp_path):
    """``tests/test_observability.py:146``: an observation inside a span
    carries its trace id in the observation log, one outside carries none;
    each bucket keeps its latest traced observation as an exemplar;
    an explicit ``exemplar_trace_id`` wins."""
    path = tmp_path / "obs.jsonl"
    tmetrics.configure_observation_log(str(path))
    try:
        tracer = ttracing.Tracer("svc", reporter=ttracing.InMemoryReporter())
        h = tmetrics.Histogram("linked_seconds", "x", labelnames=["op"])
        h.observe(0.25, op="outside")
        with tracer.start_span("handle") as span:
            h.observe(0.5, op="inside")
        h.observe(70.0, op="inside", exemplar_trace_id="f" * 32)
    finally:
        tmetrics.configure_observation_log(None)
    outside, inside, explicit = [json.loads(x) for x in path.read_text().splitlines()]
    assert outside["trace_id"] is None and outside["labels"] == {"op": "outside"}
    assert inside["trace_id"] == f"{span.context.trace_id:032x}"
    assert inside["trace_id"] == tracer.reporter.spans[0].to_dict()["traceID"]
    assert explicit["trace_id"] == "f" * 32
    ex = h.exemplars(op="inside")
    assert ex["0.5"]["trace_id"] == inside["trace_id"] and ex["+Inf"]["value"] == 70.0
    assert h.exemplars(op="outside") == {}


def test_observation_log_rotates_by_size(tmp_path):
    """Past ``max_bytes`` the live file shifts to ``.1`` (``.2``, ...), the
    oldest dropped beyond ``keep``: the kept files hold the newest
    observations, each once, in order."""
    path = tmp_path / "obs.jsonl"
    tmetrics.configure_observation_log(str(path), max_bytes=300, keep=2)
    try:
        h = tmetrics.Histogram("r_seconds", "x")
        for i in range(40):
            h.observe(float(i))
        tmetrics.flush_observation_log()
    finally:
        tmetrics.configure_observation_log(None)
    files = {p.name for p in tmp_path.iterdir()}
    assert {"obs.jsonl.1", "obs.jsonl.2"} <= files <= {"obs.jsonl", "obs.jsonl.1", "obs.jsonl.2"}
    values = []
    for name in ("obs.jsonl.2", "obs.jsonl.1", "obs.jsonl"):
        if name in files:
            values += [json.loads(x)["value"] for x in (tmp_path / name).read_text().splitlines()]
    assert values == [float(i) for i in range(40 - len(values), 40)] and len(values) < 40


# -- deadlines --------------------------------------------------------------------------------


def test_deadlines_and_scopes_behave_as_the_reference():
    clock = [100.0]
    for mod in (tpolicy, jpolicy):
        d = mod.Deadline.after(2.0, clock=lambda: clock[0])
        assert d.remaining() == 2.0 and not d.expired and d.cap(5.0) == 2.0
        clock[0] = 103.0
        assert d.expired
        with pytest.raises(mod.DeadlineExceeded, match="past expiry"):
            d.cap(1.0)
        clock[0] = 100.0
        assert mod.current_deadline() is None
        with mod.deadline_scope(10.0) as outer:
            with mod.deadline_scope(3600.0) as inner:
                assert inner is outer  # the tighter deadline wins
            with mod.deadline_scope(0.5) as tighter:
                assert mod.current_deadline() is tighter
            assert mod.current_deadline() is outer
        assert mod.current_deadline() is None


# -- flight recorder --------------------------------------------------------------------------


def _record_some(fr_cls):
    fr = fr_cls(ring_size=8)
    seen = []
    fr.add_listener(seen.append)
    fr.add_listener(lambda e: 1 / 0)  # a broken listener is swallowed
    for i in range(5):
        fr.record("tick", 1000.0 + i, 0.001 * i, trace_id="ab" * 16, ticks=i,
                  **fr.kernel_tags("paged", 10.0 * (i + 1)))
    fr.instant("req.claim", trace_id=None, rid=0)
    fr.instant("deadline_exceeded", stage="tick", slots=1)
    for i in range(4):
        fr.record("admit", 2000.0 + i, 0.002, requests=i)
    return fr, seen


def test_recorder_ring_listeners_and_export(tmp_path):
    """A bounded ring keeping the tail and counting drops, listeners fed
    every event, ``since``/``limit`` cursors, and the JSON-lines dump."""
    fr, seen = _record_some(FlightRecorder)
    assert len(fr) == 8 and fr.dropped == 3 and fr.high_water == 8 and len(seen) == 11
    assert [e["seq"] for e in fr.events()] == list(range(4, 12))
    assert [e["seq"] for e in fr.events(since=9, limit=1)] == [10]
    path = fr.dump(str(tmp_path / "ring.jsonl"))
    assert [json.loads(x) for x in open(path)] == fr.events()
    with pytest.raises(ValueError, match="no path"):
        fr.dump()
    fr.clear()
    assert len(fr) == 0 and fr.dropped == 0
    with pytest.raises(ValueError, match="ring_size"):
        FlightRecorder(ring_size=0)


@pytest.mark.parametrize("query", [None, {}, {"since": ["3"]}, {"since": ["x"], "limit": ["2"]},
                                   {"limit": []}, {"since": ["5"], "limit": ["-1"]}])
def test_parse_cursor_matches_the_reference(query):
    assert parse_cursor(query) == jax_parse_cursor(query)


def test_recorder_events_chrome_trace_and_attribution_match_the_reference():
    """The same calls on both recorders give the same events (times and
    trace ids aside, which the calls fix); the port's Chrome trace and
    attribution summary of those events are the reference's."""
    port, _ = _record_some(FlightRecorder)
    ref, _ = _record_some(JaxFlightRecorder)
    strip = lambda es: [{k: v for k, v in e.items() if k != "ts_us" or e["ph"] == "X"}  # noqa: E731
                        for e in es]
    assert strip(port.events()) == strip(ref.events())
    events = ref.events()
    assert chrome_trace(events) == jax_chrome_trace(events)
    for ceilings in (None, {"matmul_flops_per_s": 1e9}):
        assert attribution_summary(events, ceilings) == jax_attribution_summary(events, ceilings)
    nested = events + [{"name": "device_wait", "ph": "X", "ts_us": 0, "dur_us": 500,
                        "args": {}}, {"name": "readback", "ph": "X", "ts_us": 0,
                                      "dur_us": 900, "args": {}}]
    assert attribution_summary(nested) == jax_attribution_summary(nested)


# -- roofline ---------------------------------------------------------------------------------


@pytest.mark.parametrize("dims", [dict(dim=32, heads=4, layers=2, kv_heads=2),
                                  dict(dim=512, heads=8, layers=4, kv_heads=2),
                                  dict(dim=128, heads=4, layers=2)])
def test_model_flops_per_token_is_the_references(dims):
    tm = TelemetrySequenceModel(**dims, device="cpu")
    jm = JaxModel(**dims)
    for ctx in (0.0, 1.0, 4.5, 256.0):
        assert model_flops_per_token(tm, ctx) == jax_flops(jm, ctx)


def test_roofline_attributor_measures_on_the_device_it_is_given():
    """On the CPU (named): positive ceilings, a dispatch's fraction of the
    measured ceiling, per-family sums; ``device=None`` means the card and
    raises without one."""
    att = RooflineAttributor(device="cpu", matmul_n=32, copy_mb=0.01)
    ceil = att.ceilings()
    assert ceil["matmul_flops_per_s"] > 0 and ceil["memcpy_bytes_per_s"] > 0
    assert ceil["device"] == "cpu" and att.ceilings() is ceil  # cached
    frac = att.observe("paged", 2e6, 1e-3)
    assert frac == round(2e6 / 1e-3 / ceil["matmul_flops_per_s"], 6)
    assert att.observe("paged", 1.0, 0.0) == 0.0
    assert att.family_stats()["paged"] == {"flops": 2e6 + 1.0, "dispatch_wall_s": 1e-3,
                                           "events": 2}
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            RooflineAttributor()


def test_roofline_attributor_sizes_its_chain_per_device():
    """On the CPU the chain keeps the reference's sizes; on the card it is
    sized past launch cost (``DEFAULT_SIZES``); an explicit size wins."""
    import inspect

    from beholder_tpu.obs.roofline import RooflineAttributor as JaxAttributor
    from beholder_tpu_torch.obs.roofline import DEFAULT_SIZES

    ref = inspect.signature(JaxAttributor).parameters
    att = RooflineAttributor(device="cpu")
    assert (att.matmul_n, att.copy_mb) == (ref["matmul_n"].default, ref["copy_mb"].default)
    assert DEFAULT_SIZES["cuda"][0] > att.matmul_n and DEFAULT_SIZES["cuda"][1] > att.copy_mb
    att = RooflineAttributor(device="cpu", matmul_n=32, copy_mb=0.01)
    assert (att.matmul_n, att.copy_mb) == (32, 0.01)


def test_recorder_stamps_ceiling_fractions_without_measuring_inline():
    """The record path never measures: before the first measurement lands a
    tagged dispatch gets 0.0; once ceilings exist it gets its fraction."""
    att = RooflineAttributor(device="cpu", matmul_n=32, copy_mb=0.01)
    att._measuring.acquire()  # a measurement in flight elsewhere
    fr = FlightRecorder(attributor=att)
    fr.record("tick", 0.0, 1e-3, **fr.kernel_tags("paged", 1e6))
    assert fr.events()[-1]["args"]["ceiling_frac"] == 0.0
    att._measuring.release()
    att.ceilings()
    fr.record("tick", 0.0, 1e-3, **fr.kernel_tags("paged", 1e6))
    assert fr.events()[-1]["args"]["ceiling_frac"] > 0
    fr.record("readback", 0.0, 1e-3, batches=1)
    assert "ceiling_frac" not in fr.events()[-1]["args"]


# -- metric catalogs --------------------------------------------------------------------------


def test_spec_and_prefix_cache_catalogs_render_as_the_reference():
    texts = []
    for reg, spec_cls, cache_cls in ((tmetrics.Registry(), SpecMetrics, PrefixCacheMetrics),
                                     (jmetrics.Registry(), JaxSpecMetrics,
                                      JaxPrefixCacheMetrics)):
        m = spec_cls(reg)
        for drafted, accepted, freed in ((3, 1, 0), (4, 4, 0), (2, 0, 1), (0, 0, 0)):
            m.observe_step(drafted, accepted, accepted + 1, freed)
        m.draft_k.set(2.5)
        assert spec_cls(reg).drafted_total is m.drafted_total  # re-attaches
        c = cache_cls(reg)
        c.hits_total.inc()
        c.cached_pages.set(7)
        texts.append(reg.render())
    assert texts[0] == texts[1]


def test_prefix_cache_counts_on_its_registry():
    from beholder_tpu_torch.cache import PrefixCache

    reg = tmetrics.Registry()
    cache = PrefixCache(4, metrics=reg)
    feats = np.arange(24, dtype=np.float32).reshape(12, 2)
    hashes = cache.hashes(feats)
    cache.record_admit(cache.lookup(hashes, 2, record=False))
    cache.insert(hashes, [5, 6, 7])
    cache.record_admit(cache.lookup(hashes, 2, record=False))
    cache.prefilled(12)
    assert cache.evict(3) == [7, 6, 5]
    text = reg.render()
    for line in ("beholder_prefix_cache_hits_total 1", "beholder_prefix_cache_misses_total 1",
                 "beholder_prefix_cache_hit_tokens_total 8",
                 "beholder_prefix_cache_prefill_tokens_total 12",
                 "beholder_prefix_cache_evictions_total 3",
                 "beholder_prefix_cache_cached_pages 0"):
        assert line in text
    assert (cache.hits, cache.misses, cache.evictions) == (1, 1, 3)


# -- leftovers --------------------------------------------------------------------------------


@pytest.fixture(scope="module")
def f32_pair():
    dims = dict(dim=32, heads=2, layers=1)
    jm = JaxModel(**dims)
    params = {"params": jm.init(jax.random.PRNGKey(3), jnp.zeros((1, 16, FEATURES)))["params"]}
    tm = TelemetrySequenceModel(**dims, device="cpu")
    load_flax_params(tm, jax.tree.map(np.asarray, params))
    return jm, params, tm


def test_forecast_eta_matches_the_reference(f32_pair):
    """The same ``eta`` and ``reached`` as the reference's on bridged
    weights, at targets each side's forecasts cross at the same step."""
    jm, params, tm = f32_pair
    rng = np.random.default_rng(1)
    prog = np.cumsum(2.0 + rng.normal(0, 0.02, (6, 33)), axis=-1).astype(np.float32)
    stats = np.full((6, 33), 2, np.int32)
    horizon = 24
    jd = np.asarray(jax_forecast(jm, params, jnp.asarray(prog), jnp.asarray(stats), horizon))
    td = forecast_deltas(tm, torch.from_numpy(prog), torch.from_numpy(stats).long(),
                         horizon).numpy()
    j_future = prog[:, -1:] + np.cumsum(jd, axis=-1)
    t_future = prog[:, -1:] + np.cumsum(td, axis=-1)
    drift = float(np.abs(j_future - t_future).max())
    values = np.sort(np.concatenate([j_future.ravel(), t_future.ravel()]))
    gaps = np.diff(values)
    # midpoints of gaps wider than twice the drift: no forecast value of
    # either side lies within the drift of such a target
    targets = [float(v) for v, gap in zip(values[:-1] + gaps / 2, gaps) if gap > 2 * drift + 1e-3]
    targets += [float(values[0]) - 1.0, float(values[-1]) + 1.0]
    assert len(targets) > 4
    any_reached = any_missed = False
    for target in targets:
        j_eta, j_reached = jax_forecast_eta(jm, params, jnp.asarray(prog), jnp.asarray(stats),
                                            horizon, target)
        t_eta, t_reached = forecast_eta(tm, torch.from_numpy(prog),
                                        torch.from_numpy(stats).long(), horizon, target)
        np.testing.assert_array_equal(t_eta.numpy(), np.asarray(j_eta), err_msg=f"{target}")
        np.testing.assert_array_equal(t_reached.numpy(), np.asarray(j_reached))
        any_reached |= bool(t_reached.any())
        any_missed |= bool((~t_reached).any())
    assert any_reached and any_missed


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("heads", [(4, 4), (4, 2), (4, 1)], ids=["mha", "gqa", "mqa"])
def test_full_attention_segment_ids_match_the_reference(causal, heads):
    """Packed sequences (unsorted segment ids, so disjoint segments
    interleave) with and without causality, over MHA, GQA and MQA, f32:
    the reference's band; a window composes with them."""
    h, hkv = heads
    rng = np.random.default_rng(h * 10 + hkv + causal)
    q = rng.normal(0, 1, (2, h, 64, 16)).astype(np.float32)
    k = rng.normal(0, 1, (2, hkv, 64, 16)).astype(np.float32)
    v = rng.normal(0, 1, (2, hkv, 64, 16)).astype(np.float32)
    seg = np.sort(rng.integers(0, 3, (2, 64)), axis=-1)
    seg[1] = rng.integers(0, 3, 64)
    kw = dict(causal=causal, segment_ids=seg)
    want = np.asarray(jax_full_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                         **{**kw, "segment_ids": jnp.asarray(seg)}))
    got = full_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                         causal=causal, segment_ids=torch.from_numpy(seg)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    if causal:
        want = np.asarray(jax_full_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                             causal=True, window=9,
                                             segment_ids=jnp.asarray(seg)))
        got = full_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                             causal=True, window=9, segment_ids=torch.from_numpy(seg)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("shape", [(32, 96), (7, 5), (128, 1)])
def test_quantize_weight_is_the_references_bit_for_bit(shape):
    """An (in, out) kernel through the reference and its (out, in)
    transpose through the port: the same int8 values and f32 scales, and
    the same dequantized weight (bf16 and f32), one row all zeros."""
    rng = np.random.default_rng(shape[0])
    w = (rng.normal(0, 1, shape) * np.exp(rng.normal(0, 3, shape[1]))).astype(np.float32)
    w[:, 0] = 0.0
    jq = jquant.quantize_weight(jnp.asarray(w))
    tq = tquant.quantize_weight(torch.from_numpy(w.T.copy()))
    np.testing.assert_array_equal(tq["qvalues"].numpy(), np.asarray(jq["qvalues"]).T)
    np.testing.assert_array_equal(tq["scale"].numpy(), np.asarray(jq["scale"]))
    for jdt, tdt in ((jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)):
        want = np.asarray(jquant.dequantize_weight(jq, jdt).astype(jnp.float32)).T
        got = tquant.dequantize_weight(tq, tdt).float().numpy()
        np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="2-D"):
        tquant.quantize_weight(torch.zeros(3))


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_quantize_params_is_the_references_over_the_state_dict(bf16):
    """The reference's ``quantize_params`` over flax params and the port's
    over the bridged model's ``state_dict``: the same leaves quantized
    (every block matrix; not ``embed`` or ``head``, no vector), values and
    scales bit for bit after the transpose, the same ``quantized_nbytes``,
    and ``dequantize_params`` gives the reference's weights back."""
    dims = dict(dim=32, heads=4, layers=2, kv_heads=2)
    jm = JaxModel(**dims)
    params = {"params": jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 16, FEATURES)))["params"]}
    if bf16:
        params = jax.tree.map(lambda x: x.astype(jnp.bfloat16) if x.ndim >= 2 else x, params)
    tm = TelemetrySequenceModel(**dims, device="cpu")
    load_flax_params(tm, jax.tree.map(np.asarray, params))
    jqp = jquant.quantize_params(params)
    tqp = tquant.quantize_params(tm.state_dict())
    assert tquant.quantized_nbytes(tqp) == jquant.quantized_nbytes(jqp)
    assert tquant.quantized_nbytes(tm.state_dict()) == jquant.quantized_nbytes(params)
    quantized = {k for k, v in tqp.items() if isinstance(v, dict)}
    assert quantized == {f"blocks.{i}.{n}.weight" for i in range(2)
                         for n in ("q_proj", "k_proj", "v_proj", "proj", "up", "down")}
    for name in sorted(quantized):
        _, i, layer, _ = name.split(".")
        jleaf = jqp["params"][f"block_{i}"][layer]["kernel"]
        np.testing.assert_array_equal(tqp[name]["qvalues"].numpy(),
                                      np.asarray(jleaf["qvalues"]).T, err_msg=name)
        np.testing.assert_array_equal(tqp[name]["scale"].numpy(), np.asarray(jleaf["scale"]))
    back = tquant.dequantize_params(tqp, torch.float32)
    jback = jquant.dequantize_params(jqp, jnp.float32)
    got = tm.__class__(**dims, device="cpu")
    got.load_state_dict({k: v.to(torch.float32) for k, v in back.items()})
    want = TelemetrySequenceModel(**dims, device="cpu")
    load_flax_params(want, jax.tree.map(np.asarray, jback))
    for (name, a), (_, b) in zip(got.state_dict().items(), want.state_dict().items()):
        np.testing.assert_array_equal(a.float().numpy(), b.float().numpy(), err_msg=name)
