"""The port's serving cluster against its own single batcher and the JAX
reference: sharded pools, prefill/decode disaggregation with the
page-granular handoff, pressure and round-robin routing, rebalance, per-shard
intakes and their shed attribution, per-shard prefix-cache pins and spec
rollback, and the recorder's cluster events.

Model: the reference cluster tests' ``dim=32, heads=2, layers=1`` with
``init_seq_state(PRNGKey(0), 24)``'s f32 params, loaded into the port
through the weight bridge, and the same per-shard geometry
(``BATCHER_KW``). The JAX side runs as ``tests/test_cluster.py`` runs it,
its shards placed over the virtual CPU devices ``tests/conftest.py`` sets
up; the port's shards run on ``devices=["cpu"]``. Tolerances, with their
reasons:

- the port's cluster against the port's single ``ContinuousBatcher`` on
  the same requests: ``np.array_equal`` (the reference's own contract,
  ``beholder_tpu/cluster/__init__.py``: routing and disaggregation change
  where work runs, never what it computes);
- the port's streams against the JAX cluster's: ``atol=1e-4``, the serving
  tests' band (``tests/test_torch_serving.py``: the same dtype mix op for
  op, only f32 summation order differs);
- route, transfer, shed and cache counters, allocator state and pool bytes:
  exactly equal, as they are host bookkeeping or raw copies.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from beholder_tpu.cache import PrefixCache as JaxPrefixCache
from beholder_tpu.cluster import ClusterConfig as JaxClusterConfig
from beholder_tpu.cluster import cluster_from_config as jax_cluster_from_config
from beholder_tpu.cluster.router import ClusterScheduler as JaxClusterScheduler
from beholder_tpu.config import ConfigNode
from beholder_tpu.metrics import Registry as JaxRegistry
from beholder_tpu.models import TelemetrySequenceModel as JaxModel
from beholder_tpu.models import init_seq_state
from beholder_tpu.models import serving as jsv
from beholder_tpu.obs import FlightRecorder as JaxFlightRecorder
from beholder_tpu.reliability.shed import IntakeQueue as JaxIntakeQueue
from beholder_tpu.spec import SpecConfig as JaxSpecConfig
from beholder_tpu_torch.cache import PrefixCache
from beholder_tpu_torch.cluster import (
    ROUTE_ROUND_ROBIN,
    ClusterConfig,
    FabricConfig,
    GroupConfig,
    cluster_from_config,
)
from beholder_tpu_torch.cluster.router import ClusterScheduler
from beholder_tpu_torch.control import ControlConfig, ControlPlane, TenantFairQueue
from beholder_tpu_torch.metrics import Registry
from beholder_tpu_torch.models import TelemetrySequenceModel
from beholder_tpu_torch.models import serving as tsv
from beholder_tpu_torch.models.bridge import load_flax_params
from beholder_tpu_torch.models.serving import ContinuousBatcher, Request
from beholder_tpu_torch.obs import WORKER_TID_BASE, FlightRecorder, chrome_trace
from beholder_tpu_torch.ops import NUM_STATUSES
from beholder_tpu_torch.parallel.mesh import serving_shard_devices
from beholder_tpu_torch.reliability.shed import IntakeQueue
from beholder_tpu_torch.spec import SpecConfig

SIZES = dict(dim=32, heads=2, layers=1)
#: one shard's geometry; the single batcher in the bitwise tests uses the
#: same values, so the only variable is the cluster
BATCHER_KW = dict(num_pages=16, page_size=8, slots=2, max_prefix=16, max_pages_per_seq=4)


@pytest.fixture(scope="module")
def pair():
    jm = JaxModel(**SIZES)
    state, _, _ = init_seq_state(jax.random.PRNGKey(0), 24, model=jm)
    tm = TelemetrySequenceModel(**SIZES, device="cpu")
    load_flax_params(tm, jax.tree.map(np.asarray, state.params))
    return jm, state.params, tm


def _request(seed, t=9, horizon=6, deadline=None):
    rng = np.random.default_rng(seed)
    return Request(np.cumsum(1.0 + rng.normal(0, 0.05, t + 1)), np.full(t + 1, 2), horizon,
                   deadline)


def _jreq(req, deadline=None):
    return jsv.Request(req.progress, req.statuses, req.horizon, deadline)


def _port(tm, cfg, **kw):
    return ClusterScheduler(tm, cfg, devices=["cpu"], **{**BATCHER_KW, **kw})


def _ref(pair, cfg, **kw):
    jm, params, _ = pair
    return JaxClusterScheduler(jm, params, cfg, **{**BATCHER_KW, **kw})


def _single(tm, **kw):
    return ContinuousBatcher(tm, **{**BATCHER_KW, **kw}, device="cpu")


def _jcfg(cfg):
    """The reference's config for a port ``ClusterConfig`` (failover, fabric
    and group included), field for field."""
    from beholder_tpu.cluster import FabricConfig as JaxFabricConfig
    from beholder_tpu.cluster import FailoverConfig as JaxFailoverConfig
    from beholder_tpu.cluster import GroupConfig as JaxGroupConfig

    fields = dataclasses.asdict(cfg)
    nested = {}
    for key, cls in (("failover", JaxFailoverConfig), ("fabric", JaxFabricConfig),
                     ("group", JaxGroupConfig)):
        sub = fields.pop(key)
        nested[key] = cls(**sub) if sub else None
    return JaxClusterConfig(**fields, **nested)


def _bitwise(got, want):
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert type(g).__name__ == type(w).__name__, f"result {i}"
        if isinstance(g, np.ndarray):
            assert np.array_equal(g, w), f"result {i}"


def _close(got, want):
    """The port's results against the reference's: outcome classes equal,
    streams (and partial streams) within the serving band."""
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert type(g).__name__ == type(w).__name__, f"result {i}"
        g = getattr(g, "tokens", g)
        w = getattr(w, "tokens", w)
        if isinstance(g, np.ndarray):
            assert g.shape == np.asarray(w).shape, f"result {i}"
            np.testing.assert_allclose(g, np.asarray(w), rtol=0, atol=1e-4,
                                       err_msg=f"result {i}")


def _transfers(cluster):
    t = cluster.transfer
    return (t.transfers, t.pages, t.bytes, t.failed, t.faults_injected, dict(t.ops_by_plane))


def _pristine(batcher):
    assert int(batcher.state.free_top) == batcher.num_pages
    assert int(batcher.state.page_ref.sum()) == 0


# -- config ------------------------------------------------------------------


def test_cluster_config_validation():
    for kw in (dict(n_decode_workers=0), dict(n_prefill_workers=-1),
               dict(route_policy="hash"), dict(max_pending_per_shard=0)):
        with pytest.raises(ValueError):
            ClusterConfig(**kw)
        with pytest.raises(ValueError):
            JaxClusterConfig(**kw)
    with pytest.raises(ValueError):
        GroupConfig(size=1)
    with pytest.raises(ValueError):
        FabricConfig(replicate_after=0)


@pytest.mark.parametrize("tree", [
    {},
    {"instance": {"cluster": {"enabled": False}}},
    {"instance": {"cluster": {
        "enabled": True, "n_decode_workers": 4, "n_prefill_workers": 2,
        "route_policy": "round_robin", "max_pending_per_shard": 32,
        "max_pending_pages_per_shard": 64,
    }}},
    {"instance": {"cluster": {
        "enabled": True,
        "failover": {"enabled": True, "heartbeat_interval_s": 0.5, "miss_threshold": 2},
        "fabric": {"enabled": True, "replicate_after": 3, "standby": True},
        "group": {"enabled": True, "size": 4},
    }}},
])
def test_cluster_from_config_matches_the_reference(tree):
    """Disabled is None; every knob parses as the reference parses it."""
    got = cluster_from_config(ConfigNode(tree))
    want = jax_cluster_from_config(ConfigNode(tree))
    if want is None:
        assert got is None
        return
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    if tree["instance"]["cluster"].get("route_policy"):
        assert got.route_policy == ROUTE_ROUND_ROBIN


def test_unported_cluster_options_refuse(pair):
    """Every cluster option builds: a control plane (each shard's intake
    its tenant-fair queue), the fabric and decode groups (a group needs a
    device list it divides: the reference's ``ValueError`` for a group
    larger than the devices)."""
    _, _, tm = pair
    for cfg in (ClusterConfig(fabric=FabricConfig()),
                ClusterConfig(fabric=FabricConfig(standby=True))):
        cluster = ClusterScheduler(tm, cfg, devices=["cpu"], **BATCHER_KW)
        assert cluster.fabric is not None and cluster.fabric.config is cfg.fabric
    cluster = ClusterScheduler(tm, ClusterConfig(group=GroupConfig(size=2)),
                               devices=["cpu"] * 4, **BATCHER_KW)
    assert [s.pool.name for s in cluster.shards] == ["decode-g0", "decode-g1"]
    plane = ControlPlane(ControlConfig())
    cluster = _port(tm, ClusterConfig(), control_plane=plane)
    assert cluster.control_plane is plane
    assert all(isinstance(s.intake, TenantFairQueue) for s in cluster.shards)
    with pytest.raises(ValueError, match="does not divide"):
        serving_shard_devices(2, group_size=2, devices=["cpu"])
    with pytest.raises(ValueError, match="does not divide"):
        _port(tm, ClusterConfig(group=GroupConfig(size=2)))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            serving_shard_devices(2)
    assert serving_shard_devices(3, devices=["cpu", "meta"]) == [
        torch.device("cpu"), torch.device("meta"), torch.device("cpu")]


# -- default off: nothing registered, the single batcher untouched -----------


def test_cluster_off_serving_and_exposition_unchanged(pair):
    """A cluster built without a registry registers nothing anywhere, its
    streams are the single batcher's bits, and the single batcher's own
    series set is unchanged by cluster use."""
    _, _, tm = pair
    reqs = [_request(i, horizon=5) for i in range(3)]
    plain = Registry()
    base = _single(tm, metrics=plain).run(reqs)
    before = Registry().render()
    cluster = _port(tm, ClusterConfig(n_decode_workers=2, n_prefill_workers=1))
    got = cluster.run(reqs)
    assert Registry().render() == before
    assert "beholder_cluster" not in plain.render()
    _bitwise(got, base)
    again = Registry()
    _single(tm, metrics=again).run(reqs)
    assert {m.name for m in plain._metrics} == {m.name for m in again._metrics}


# -- exactness: cluster == single batcher, bitwise ----------------------------


@pytest.mark.parametrize("n_prefill", [0, 1], ids=["colocated", "disaggregated"])
def test_cluster_exact_greedy_bitwise_and_against_the_reference(pair, n_prefill):
    """2 decode shards (and a prefill worker: a page handoff on every
    admission) emit the single batcher's bits; the streams agree with the
    JAX cluster's, and the transfer counters equal its counters."""
    reqs = [_request(i, t=6 + (i % 5), horizon=3 + (i % 4)) for i in range(8)]
    cfg = ClusterConfig(n_decode_workers=2, n_prefill_workers=n_prefill)
    base = _single(pair[2]).run(reqs)
    cluster = _port(pair[2], cfg)
    got = cluster.run(reqs)
    _bitwise(got, base)
    ref = _ref(pair, _jcfg(cfg))
    _close(got, ref.run([_jreq(r) for r in reqs]))
    assert _transfers(cluster) == _transfers(ref)
    assert cluster.transfer.transfers == (len(reqs) if n_prefill else 0)
    for shard in cluster.shards:
        _pristine(shard.batcher)


def test_colocated_cluster_zero_horizon(pair):
    _, _, tm = pair
    reqs = [_request(i, horizon=4) for i in range(5)]
    reqs[2] = reqs[2]._replace(horizon=0)
    base = _single(tm).run(reqs)
    got = _port(tm, ClusterConfig(n_decode_workers=2)).run(reqs)
    assert got[2].shape == (0,)
    _bitwise(got, base)
    _close(got, _ref(pair, JaxClusterConfig(n_decode_workers=2)).run([_jreq(r) for r in reqs]))


# -- the handoff's byte-for-byte pool contract -------------------------------


@pytest.mark.parametrize("cache_dtype", ["bf16", "int8", "fp8"])
def test_handoff_preserves_page_content_byte_for_byte(pair, cache_dtype):
    """kv_prefill_chunks -> paged_adopt_chunks leaves the pool with the
    bytes a colocated paged_admit_batch writes (values and scales under
    quantized pools), the prediction bitwise; the chunks and the prediction
    agree with the reference's."""
    jm, params, tm = pair
    page, t = 8, 13
    feats = np.random.default_rng(7).normal(0, 1, (t, 1 + NUM_STATUSES)).astype(np.float32)
    t_pad = -(-t // page) * page
    padded = np.pad(feats, ((0, t_pad - t), (0, 0)))[None]

    local = tsv.init_paged(tm, 8, page, 2, 4, cache_dtype=cache_dtype)
    preds, local = tsv.paged_admit_batch(
        tm, local, torch.zeros(1, dtype=torch.int32), torch.from_numpy(padded),
        torch.tensor([t], dtype=torch.int32),
    )
    remote = tsv.init_paged(tm, 8, page, 2, 4, cache_dtype=cache_dtype)
    # head_rows: the destination's slot count, the rows paged_admit_batch's
    # head runs at
    pred, ck, cv = tsv.kv_prefill_chunks(tm, torch.from_numpy(padded), t, page, head_rows=2)
    remote = tsv.paged_adopt_chunks(remote, 0, ck, cv, -(-t // page), t)

    assert torch.equal(pred, preds[0])
    assert int(remote.seq_lens[0]) == t and bool(remote.active[0])
    assert not bool(remote.alloc_failed)
    for name in ("page_table", "free_top", "page_ref"):
        assert torch.equal(getattr(remote, name), getattr(local, name)), name
    for layer in range(tm.layers):
        for a, b in zip(tsv.slot_cache(local, 0, layer), tsv.slot_cache(remote, 0, layer)):
            assert torch.equal(a, b)
        for pa, pb in ((local.k_pools[layer], remote.k_pools[layer]),
                       (local.v_pools[layer], remote.v_pools[layer])):
            for xa, xb in zip(*(p if isinstance(p, tuple) else (p,) for p in (pa, pb))):
                assert torch.equal(xa.view(torch.uint8), xb.view(torch.uint8))

    jpred, jck, jcv = jsv.kv_prefill_chunks(jm, params, padded, np.int32(t), page)
    np.testing.assert_allclose(float(pred), float(jpred), rtol=0, atol=1e-4)
    for c, jc in zip(ck + cv, jck + jcv):
        assert tuple(c.shape) == jc.shape
        np.testing.assert_allclose(c.float().numpy(), np.asarray(jc, np.float32),
                                   rtol=2**-7, atol=1e-4)


def test_prefix_cache_migration_entries_match_the_reference():
    """``export_entries`` lists the index parent first, ``adopt_entry``
    re-roots it with ``insert``'s collision rule and its pins, and
    ``drop_entries`` forgets tip first, skipping pinned entries and entries
    with cached children: entry for entry what the reference's cache does."""
    rng = np.random.default_rng(5)
    trunk = rng.normal(0, 1, (24, 1 + NUM_STATUSES)).astype(np.float32)
    a = np.concatenate([trunk, rng.normal(0, 1, (16, 1 + NUM_STATUSES))]).astype(np.float32)
    b = np.concatenate([trunk, rng.normal(0, 1, (8, 1 + NUM_STATUSES))]).astype(np.float32)
    out = []
    for cls in (PrefixCache, JaxPrefixCache):
        src, dst = cls(8), cls(8)
        ha, hb = src.hashes(a), src.hashes(b)
        src.insert(ha, [10, 11, 12, 13, 14])
        src.insert(hb, [10, 11, 12, 15])
        src.acquire(hb)                        # b's chain is pinned by a live slot
        entries = src.export_entries()
        dst.insert(ha[:1], [3])                # the destination already holds the root
        adopted = [dst.adopt_entry(k, p, pid + 100, live) for k, p, pid, live in entries]
        dropped = dst.drop_entries(ha)
        out.append((entries, adopted, dropped, dst.page_count, sorted(dst.page_ids)))
    assert out[0] == out[1]
    entries, adopted, dropped, _, _ = out[0]
    assert [k for k, _, _, _ in entries][:3] == ha[:3]    # parents before children
    assert adopted.count(False) == 1 and dropped == [114, 113]


# -- distributed invariants: per-shard pins and rollback refcounts ------------


def test_prefix_cache_pins_hold_per_shard_under_pressure(pair):
    """Each shard owns its own prefix cache over its own pool: warm replays
    are the cold run's bits, cached page ids index the shard's own pool, a
    full eviction leaves every pool pristine, and the cache counters per
    shard equal the JAX cluster's."""
    _, _, tm = pair
    reqs = [_request(i % 3, t=9, horizon=4) for i in range(6)]
    cfg = ClusterConfig(n_decode_workers=2)
    cluster = _port(tm, cfg, prefix_cache_factory=lambda: PrefixCache(8))
    ref = _ref(pair, _jcfg(cfg), prefix_cache_factory=lambda: JaxPrefixCache(8))
    cold = cluster.run(reqs)
    warm = cluster.run(reqs)
    _bitwise(warm, cold)
    _close(cold, ref.run([_jreq(r) for r in reqs]))
    _close(warm, ref.run([_jreq(r) for r in reqs]))
    for shard, jshard in zip(cluster.shards, ref.shards):
        cache, jcache = shard.batcher.prefix_cache, jshard.batcher.prefix_cache
        assert (cache.hits, cache.misses, cache.page_count) == (
            jcache.hits, jcache.misses, jcache.page_count)
        assert all(0 <= p < shard.batcher.num_pages for p in cache.page_ids)
    assert any(s.batcher.prefix_cache.page_count > 0 for s in cluster.shards)
    for shard in cluster.shards:
        shard.batcher._evict_cached(shard.batcher.num_pages)
        assert shard.batcher.prefix_cache.page_count == 0
        _pristine(shard.batcher)
    _bitwise(cluster.run(reqs), cold)


def test_spec_rollback_refcounts_stay_local_to_shard(pair):
    """Spec composes per shard: the spec-armed cluster emits a single
    spec-armed batcher's bits, and every shard's rollbacks return its
    pages."""
    _, _, tm = pair
    kw = dict(num_pages=24, max_pages_per_seq=6)
    reqs = [_request(i, t=7, horizon=6) for i in range(6)]
    base = _single(tm, spec=SpecConfig(max_draft=3, accept_tol=0.0), **kw).run_spec(reqs)
    cfg = ClusterConfig(n_decode_workers=2)
    cluster = _port(tm, cfg, spec=SpecConfig(max_draft=3, accept_tol=0.0), **kw)
    got = cluster.run(reqs)
    _bitwise(got, base)
    ref = _ref(pair, _jcfg(cfg), spec=JaxSpecConfig(max_draft=3, accept_tol=0.0), **kw)
    _close(got, ref.run([_jreq(r) for r in reqs]))
    for shard in cluster.shards:
        _pristine(shard.batcher)


# -- capacity and admission control -------------------------------------------


def _admitted_before_shed(make, n_shards):
    cluster = make(ClusterConfig(n_decode_workers=n_shards, max_pending_per_shard=128))
    for i in range(256):
        if not cluster.submit(_request(i, t=9, horizon=6)).accepted:
            return i, cluster
    raise AssertionError("intake never shed")


def test_capacity_scales_with_shard_count(pair):
    """Admitted-before-shed doubles going 1 -> 2 shards on the same
    per-shard pool, as in the reference, and everything admitted serves:
    the single batcher's bits, the reference's streams."""
    _, _, tm = pair
    one, _ = _admitted_before_shed(lambda cfg: _port(tm, cfg), 1)
    two, cluster = _admitted_before_shed(lambda cfg: _port(tm, cfg), 2)
    assert one > 0 and two == 2 * one
    assert (one, two) == (
        _admitted_before_shed(lambda cfg: _ref(pair, _jcfg(cfg)), 1)[0],
        _admitted_before_shed(lambda cfg: _ref(pair, _jcfg(cfg)), 2)[0],
    )
    results = cluster.run_pending()
    assert len(results) == two and all(len(r) == 6 for r in results)
    _bitwise(results, _single(tm).run([_request(i, t=9, horizon=6) for i in range(two)]))


def _shed_counts(registry) -> dict:
    sheds = registry.find("beholder_intake_shed_total")
    return {} if sheds is None else dict(sheds.items())


def test_per_shard_shed_attribution_and_depth_labels(pair):
    _, _, tm = pair
    registry = Registry()
    cfg = ClusterConfig(n_decode_workers=2, max_pending_per_shard=1)
    cluster = _port(tm, cfg, metrics=registry)
    jregistry = JaxRegistry()
    ref = _ref(pair, _jcfg(cfg), metrics=jregistry)
    admissions = [cluster.submit(_request(i)) for i in range(8)]
    jadmissions = [ref.submit(_jreq(_request(i))) for i in range(8)]
    assert [tuple(a) for a in admissions] == [tuple(a) for a in jadmissions]
    exposition = registry.render()
    assert 'beholder_intake_queue_depth{queue="cluster.decode-0"}' in exposition
    assert 'beholder_intake_queue_depth{queue="cluster.decode-1"}' in exposition
    assert 'beholder_intake_shed_total{queue="cluster.decode-' in exposition
    assert "beholder_cluster_routes_total" in exposition
    assert "beholder_cluster_shards 2" in exposition
    assert _shed_counts(registry) == _shed_counts(jregistry)
    routes = registry.find("beholder_cluster_routes_total")
    jroutes = jregistry.find("beholder_cluster_routes_total")
    assert dict(routes.items()) == dict(jroutes.items())


def test_rebalance_moves_queued_work_and_counts_routes(pair):
    """Queued work stuck on an overloaded shard moves to an idle one at
    drain time (``reason="rebalance"``, counted as the reference counts
    it), and everything serves: the single batcher's bits."""
    _, _, tm = pair
    cfg = ClusterConfig(n_decode_workers=2, max_pending_per_shard=64,
                        max_pending_pages_per_shard=64)
    reqs = [_request(i, t=9, horizon=14) for i in range(8)]
    out = []
    for cluster, wrap, registry in ((_port, lambda r: r, Registry()),
                                    (None, _jreq, JaxRegistry())):
        c = (_port(tm, cfg, metrics=registry) if cluster is not None
             else _ref(pair, _jcfg(cfg), metrics=registry))
        shard0 = c.shards[0]
        # pile onto shard 0 more queued worst-case pages than its pool holds
        for seq, req in enumerate(reqs):
            need = c._need(wrap(req))
            assert shard0.intake.offer((seq, wrap(req)), cost=need).accepted
            shard0.pool.reserve(need)
        assert shard0.intake.depth == 8
        results = c.run_pending()
        assert len(results) == 8
        out.append((results, registry.find("beholder_cluster_routes_total").value(
            reason="rebalance")))
    (got, moved), (want, jmoved) = out
    assert moved > 0 and moved == jmoved
    _close(got, want)
    _bitwise(got, _single(tm).run(reqs))


def test_intake_restock_preserves_fifo_and_counters():
    """Restock puts drained items back in FIFO order and re-counts neither
    admissions nor sheds, as the reference's does."""
    seen = []
    for queue_cls, registry in ((IntakeQueue, Registry()), (JaxIntakeQueue, JaxRegistry())):
        q = queue_cls(8, max_cost=100.0, cost_fn=lambda item: item, metrics=registry,
                      name="restock-test", labelled_sheds=True)
        for item in (1.0, 2.0, 3.0):
            assert q.offer(item).accepted
        admitted = registry.find("beholder_serving_admitted_total").total()
        drained = q.take_all()
        q.restock(drained[1:])
        assert q.offer(4.0).accepted
        assert q.take_all() == [2.0, 3.0, 4.0]
        assert registry.find("beholder_serving_admitted_total").total() == admitted + 1
        q2 = queue_cls(1, metrics=registry, name="restock-test-2", labelled_sheds=True)
        q2.offer("a")
        q2.offer("b")
        seen.append(registry.find("beholder_intake_shed_total").value(
            queue="restock-test-2", reason="queue_full"))
    assert seen == [1, 1]


# -- flight recorder and the Chrome export -------------------------------------


def _names(events, keep=("route", "transfer", "prefill", "claim", "tick", "admit",
                         "retire", "readback")):
    return sorted(e["name"] for e in events if e["name"] in keep)


def test_route_transfer_prefill_events_and_worker_tracks(pair):
    _, _, tm = pair
    reqs = [_request(i, horizon=4) for i in range(4)]
    cfg = ClusterConfig(n_decode_workers=2, n_prefill_workers=1)
    recorder = FlightRecorder(ring_size=512)
    _port(tm, cfg, flight_recorder=recorder).run(reqs)
    jrecorder = JaxFlightRecorder(ring_size=512)
    _ref(pair, _jcfg(cfg), flight_recorder=jrecorder).run([_jreq(r) for r in reqs])
    events = recorder.events()
    assert {"route", "transfer", "prefill", "claim", "tick"} <= {e["name"] for e in events}
    # the same phases, as often, on the same workers as the reference's
    assert _names(events) == _names(jrecorder.events())
    workers = sorted((e["name"], e["args"].get("worker")) for e in events
                     if e["name"] in ("route", "transfer", "prefill"))
    assert workers == sorted((e["name"], e["args"].get("worker")) for e in jrecorder.events()
                             if e["name"] in ("route", "transfer", "prefill"))
    transfers = [e for e in events if e["name"] == "transfer"]
    assert all(e["args"]["pages"] > 0 and e["args"]["bytes"] > 0 for e in transfers)
    assert [(e["args"]["pages"], e["args"]["bytes"]) for e in transfers] == [
        (e["args"]["pages"], e["args"]["bytes"])
        for e in jrecorder.events() if e["name"] == "transfer"]

    trace = chrome_trace(events)
    by_tid = {e["args"]["name"]: e["tid"] for e in trace["traceEvents"]
              if e["name"] == "thread_name"}
    assert {"worker decode-0", "worker decode-1", "worker prefill-0"} <= set(by_tid)
    for event in trace["traceEvents"]:
        if event.get("cat") == "serving" and event["name"] == "transfer":
            assert event["tid"] >= WORKER_TID_BASE
            assert event["tid"] in by_tid.values()


def test_round_histogram_label_set_unchanged_by_cluster(pair):
    """route/transfer/prefill are recorder-only: the round histogram keeps
    the single batcher's phase labels."""
    _, _, tm = pair
    registry = Registry()
    _port(tm, ClusterConfig(n_decode_workers=2, n_prefill_workers=1),
          metrics=registry).run([_request(i, horizon=4) for i in range(4)])
    hist = registry.find("beholder_serving_round_duration_seconds")
    assert {key[0] for key in hist._counts} <= {"admit", "tick", "retire", "wave", "readback"}


def test_run_pending_disaggregated_after_submit(pair):
    """The intake-fronted path drives the disaggregated loop too: results
    in admission order, the single batcher's bits, the reference's
    streams and transfer counts."""
    _, _, tm = pair
    reqs = [_request(i, horizon=5) for i in range(4)]
    cfg = ClusterConfig(n_decode_workers=2, n_prefill_workers=1,
                        route_policy=ROUTE_ROUND_ROBIN)
    cluster = _port(tm, cfg)
    ref = _ref(pair, _jcfg(cfg))
    for req in reqs:
        assert cluster.submit(req).accepted
        assert ref.submit(_jreq(req)).accepted
    results = cluster.run_pending()
    _bitwise(results, _single(tm).run(reqs))
    _close(results, ref.run_pending())
    assert _transfers(cluster) == _transfers(ref)
    assert cluster.transfer.pages > 0


def test_scale_up_and_health_snapshot(pair):
    """A spawned shard is routable at once and serves the single batcher's
    bits; the health snapshot lists it, as the reference's does."""
    _, _, tm = pair
    reqs = [_request(i, horizon=4) for i in range(6)]
    cfg = ClusterConfig(n_decode_workers=1, route_policy=ROUTE_ROUND_ROBIN)
    registry = Registry()
    cluster = _port(tm, cfg, metrics=registry)
    ref = _ref(pair, _jcfg(cfg))
    shard, jshard = cluster.scale_up(), ref.scale_up()
    assert shard.pool.name == jshard.pool.name == "decode-1"
    assert "beholder_cluster_shards 2" in registry.render()
    got = cluster.run(reqs)
    _bitwise(got, _single(tm).run(reqs))
    _close(got, ref.run([_jreq(r) for r in reqs]))
    assert cluster.health_snapshot() == ref.health_snapshot()


def test_bench_cluster_trace_handoff_counts():
    """``chip_smoke.py``'s cluster phase on the CPU: ``bench_cluster``'s
    16-request trace through a disaggregated cluster at its per-shard
    geometry hands off the pages and bytes the card run is held to
    (``chip_smoke.CLUSTER_HANDOFF``), and the reference's cluster hands off
    the same on the same trace. Pages and bytes depend on the trace, the
    page size and the kv geometry only, so the model keeps the headline
    model's (4 layers, 2 kv heads of 64) at a quarter of its width, which
    keeps the test cheap. The streams are held to one batcher's within the
    serving band (``tests/test_serving.py:161-163``), not bitwise: at wide
    widths the CPU's bf16 GEMMs pick their kernel by row count (on the card
    they do not, and ``chip_smoke.py`` holds the cluster bitwise there)."""
    import chip_smoke
    from beholder_tpu_torch.models.bridge import init_params

    sizes = dict(dim=128, heads=2, kv_heads=2, layers=4)
    tm = TelemetrySequenceModel(**sizes, device="cpu")
    load_flax_params(tm, init_params(tm, seed=0, bf16_matrices=True))
    trace = chip_smoke.cluster_trace(Request)
    # one intra-op thread: the trace is thousands of small ops, which the
    # thread pool slows many times over when test workers share the cores
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        cluster = ClusterScheduler(tm, ClusterConfig(n_decode_workers=2, n_prefill_workers=1),
                                   devices=["cpu"], **chip_smoke.CLUSTER)
        got = cluster.run(trace)
        want = ContinuousBatcher(tm, **chip_smoke.CLUSTER, device="cpu").run(trace)
    finally:
        torch.set_num_threads(threads)
    t = cluster.transfer
    assert dict(transfers=t.transfers, pages=t.pages, bytes=t.bytes) == chip_smoke.CLUSTER_HANDOFF
    assert chip_smoke.CLUSTER_HANDOFF == dict(transfers=16, pages=52, bytes=851_968)
    # the reference's cluster at the same kv geometry (its own weights:
    # the counts do not read them)
    jm = JaxModel(**sizes)
    state, _, _ = init_seq_state(jax.random.PRNGKey(0), 64, model=jm)
    ref = JaxClusterScheduler(jm, state.params,
                              JaxClusterConfig(n_decode_workers=2, n_prefill_workers=1),
                              **chip_smoke.CLUSTER)
    ref.run([_jreq(r) for r in trace])
    jt = ref.transfer
    assert (jt.transfers, jt.pages, jt.bytes) == (t.transfers, t.pages, t.bytes)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape, f"request {i}"
        np.testing.assert_allclose(g, w, rtol=3e-2, atol=1.5e-2, err_msg=f"request {i}")
