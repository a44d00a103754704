"""The port's cluster memory fabric against its own single batcher and the
JAX reference: the global prefix index (warm-anywhere admission by a
verbatim cross-shard page fetch, borrow or replicate, cross-shard pin
release), the dark standby (mirroring between serves, promotion in place
of the replay, a standby killed mid-mirror), pins across a drain, the
fabric-off cluster, a failed fetch falling back to a cold prefill, and the
recorder's fabric events.

Model, placement and tolerances as in ``tests/test_torch_cluster.py`` at
``tests/test_fabric.py``'s geometry (``FABRIC_KW``: 32 pages a shard):

- streams against the port's own oracle, ``np.array_equal``: a cross-shard
  hit against the same request's local warm hit, a recovered stream against
  the uninterrupted warm pass, and in bf16 the fabric-on streams against the
  fabric-off cluster's (full-precision pages make cold == hit);
- streams against the JAX cluster's: the admission prediction (a stream's
  first value) within ``atol=1e-4``, the whole stream within the band of
  ``tests/test_prefix_cache.py:138-165`` (rtol 3e-2, atol 1.5e-2), as
  ``tests/test_torch_prefix.py`` holds batcher streams. ``atol=1e-4`` over
  whole streams holds at ``tests/test_torch_cluster.py``'s 9-event requests
  but not at this file's (the reference tests' 16-event requests, seeds
  300+): request 303's first tick lands one bf16 spacing away (1.36e-3; the
  port's plain attention is within one bf16 ULP of XLA's, ROADMAP C.4), and
  the fed-back prediction carries it to 6.73e-3 by the fourth step. The
  reference run eagerly differs from the port by the same amount, and the
  port's single batcher gives the port's cluster's bits;
- the fabric's counters (lookups, hits, pages fetched, fetch failures, pins
  released and outstanding, borrows dropped, replicas, promotions, standbys
  spawned and failed, mirrored, stale and skipped pages, syncs, directory
  size), the transfer counters by plane and the shard names: exactly the
  reference's.

The reference's two federated-trace tests (``test_incident_trace_federates_
across_plane_rings``, ``test_federation_falls_back_to_local_on_single_ring``)
run here through both packages' flight plane and retention vault, with the
same events and a fake clock: the kept summaries, the merged assembly and
the served ``/debug/traces/<id>`` body equal."""

import json

import jax.numpy as jnp
import numpy as np
import pytest

from beholder_tpu.cache import PrefixCache as JaxPrefixCache
from beholder_tpu.cluster import FabricConfig as JaxFabricConfig
from beholder_tpu.cluster import cluster_from_config as jax_cluster_from_config
from beholder_tpu.cluster.fabric import GlobalPrefixIndex as JaxGlobalPrefixIndex
from beholder_tpu.cluster.fabric import IndexedPrefixCache as JaxIndexedPrefixCache
from beholder_tpu.config import ConfigNode
from beholder_tpu.obs import FlightRecorder as JaxFlightRecorder
from beholder_tpu.reliability import chaos as jchaos
from beholder_tpu_torch.cache import PrefixCache
from beholder_tpu_torch.cluster import (
    ClusterConfig,
    FabricConfig,
    FailoverConfig,
    cluster_from_config,
)
from beholder_tpu_torch.cluster.fabric import GlobalPrefixIndex, IndexedPrefixCache
from beholder_tpu_torch.models.serving import cache_unref_pages
from beholder_tpu_torch.obs import FlightRecorder
from beholder_tpu_torch.reliability.chaos import WorkerFault, inject_worker_fault

from test_torch_cluster import (  # noqa: F401 - the shared fixture
    _jcfg,
    _jreq,
    _pristine,
    _request,
    pair,
)

FABRIC_KW = dict(num_pages=32, page_size=8, slots=2, max_prefix=16, max_pages_per_seq=4)


def _req(seed, t=16, horizon=6):
    return _request(seed, t=t, horizon=horizon)


def _jdtype(family):
    """The reference's ``cache_dtype`` for a pool family name."""
    return {"int8": jnp.int8, "fp8": "fp8"}.get(family, jnp.bfloat16)


def _cfg(fabric=None, failover=False, **kw):
    return ClusterConfig(n_decode_workers=2, route_policy="round_robin", fabric=fabric,
                         failover=FailoverConfig() if failover else None, **kw)


def _both(pair, cfg, **kw):
    """The port's cluster (on the CPU) and the reference's, built alike,
    each shard with a ``PrefixCache(8)``."""
    from beholder_tpu.cluster.router import ClusterScheduler as JaxClusterScheduler
    from beholder_tpu_torch.cluster.router import ClusterScheduler

    jm, params, tm = pair
    jkw = dict(kw)
    if "cache_dtype" in jkw:
        jkw["cache_dtype"] = _jdtype(jkw["cache_dtype"])
    if "flight_recorder" in jkw:
        jkw["flight_recorder"] = JaxFlightRecorder(ring_size=kw["flight_recorder"].ring_size)
    port = ClusterScheduler(tm, cfg, devices=["cpu"], prefix_cache_factory=lambda: PrefixCache(8),
                            **{**FABRIC_KW, **kw})
    ref = JaxClusterScheduler(jm, params, _jcfg(cfg),
                              prefix_cache_factory=lambda: JaxPrefixCache(8),
                              **{**FABRIC_KW, **jkw})
    return port, ref


def _fab_state(cluster):
    fab = cluster.fabric
    return dict(
        lookups=fab.cross_shard_lookups, hits=fab.cross_shard_hits,
        fetched=fab.pages_fetched, fetch_failures=fab.fetch_failures,
        pins_released=fab.pins_released, borrows_dropped=fab.borrows_dropped,
        replicas=fab.replicas, promotions=fab.promotions, spawned=fab.standbys_spawned,
        standby_failures=fab.standby_failures, mirrored=fab.mirror.mirrored_pages,
        stale=fab.mirror.stale_dropped, skipped=fab.mirror.skipped_pages,
        syncs=fab.mirror.syncs, pins=fab.index.outstanding_pins,
        keys=fab.index.indexed_keys, planes=dict(cluster.transfer.ops_by_plane),
        shards=[s.pool.name for s in cluster.shards],
        standby=fab.standby.pool.name if fab.standby is not None else None,
    )


def _close_band(got, want):
    """The port's results against the reference's: outcome classes equal,
    first values within 1e-4, streams within the serving band (see the
    module docstring)."""
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert type(g).__name__ == type(w).__name__, f"result {i}"
        if isinstance(g, np.ndarray):
            w = np.asarray(w)
            assert g.shape == w.shape, f"result {i}"
            np.testing.assert_allclose(g[:1], w[:1], rtol=0, atol=1e-4, err_msg=f"result {i}")
            np.testing.assert_allclose(g, w, rtol=3e-2, atol=1.5e-2, err_msg=f"result {i}")


def _run_both(port, ref, reqs):
    got = port.run(reqs)
    _close_band(got, ref.run([_jreq(r) for r in reqs]))
    return got


def _bitwise_pairs(got, want):
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert np.array_equal(np.asarray(g), np.asarray(w)), f"result {i}"


def _drop_all_cached(batcher):
    cache = batcher.prefix_cache
    dropped = cache.drop_entries([key for key, _, _, _ in cache.export_entries()])
    if dropped:
        batcher.state = cache_unref_pages(batcher.state, *batcher._page_id_batch(dropped))


# -- config ------------------------------------------------------------------


def test_fabric_config_parse_and_validation():
    on = {"instance": {"cluster": {"enabled": True, "fabric": {
        "enabled": True, "replicate_after": 3, "standby": True}}}}
    cfg = cluster_from_config(ConfigNode(on))
    want = jax_cluster_from_config(ConfigNode(on))
    assert (cfg.fabric.replicate_after, cfg.fabric.standby) == (3, True)
    assert (cfg.fabric.replicate_after, cfg.fabric.standby) == (
        want.fabric.replicate_after, want.fabric.standby)
    for tree in ({"instance": {"cluster": {"enabled": True}}},
                 {"instance": {"cluster": {"enabled": True,
                                           "fabric": {"enabled": False, "standby": True}}}}):
        assert cluster_from_config(ConfigNode(tree)).fabric is None
        assert jax_cluster_from_config(ConfigNode(tree)).fabric is None
    for bad in (0, -1):
        with pytest.raises(ValueError):
            FabricConfig(replicate_after=bad)
        with pytest.raises(ValueError):
            JaxFabricConfig(replicate_after=bad)


# -- the directory and the cache proxy -----------------------------------------


def test_global_index_and_proxy_replay_the_reference_ops():
    """One scripted sequence of directory and cache operations through the
    port's ``GlobalPrefixIndex`` / ``IndexedPrefixCache`` and the
    reference's: every answer and the directory's whole state agree at each
    step."""
    rng = np.random.default_rng(5)
    feats = [rng.normal(size=(24, 7)).astype(np.float32) for _ in range(3)]
    port_index, ref_index = GlobalPrefixIndex(), JaxGlobalPrefixIndex()
    ports = {name: IndexedPrefixCache(PrefixCache(8), port_index, name) for name in "ab"}
    refs = {name: JaxIndexedPrefixCache(JaxPrefixCache(8), ref_index, name) for name in "ab"}

    def state(index):
        return (index._owners, index._parents, index._hits, index._pins,
                index.outstanding_pins, index.indexed_keys)

    def both(fn):
        got, want = fn(ports, port_index), fn(refs, ref_index)
        assert got == want
        assert state(port_index) == state(ref_index)
        return got

    chains = [ports["a"].hashes(f) for f in feats]
    assert chains == [refs["a"].hashes(f) for f in feats]
    both(lambda c, i: c["a"].insert(chains[0], [3, 4, 5]))
    both(lambda c, i: c["a"].insert(chains[1], [6, 7, 8]))
    both(lambda c, i: c["b"].insert(chains[0][:2], [1, 2]))
    both(lambda c, i: c["b"].adopt_entry(chains[2][0], None, 9, live_users=1))
    both(lambda c, i: c["b"].adopt_entry(chains[2][0], None, 10))  # a collision
    both(lambda c, i: i.best_owner(chains[0], exclude="b", beyond=2))
    both(lambda c, i: i.best_owner(chains[0], exclude="a", beyond=0))
    both(lambda c, i: i.best_owner(chains[1], exclude="a", beyond=0))
    both(lambda c, i: i.page_ids("a", chains[1]))
    both(lambda c, i: [i.record_remote_hit(chains[0][2]) for _ in range(3)])
    pins = {}
    for name, cs, idx in (("port", ports, port_index), ("ref", refs, ref_index)):
        pins[name] = idx.register_pin("a", "b", chains[0])
        idx.register_pin("b", "a", chains[0][:2])
    both(lambda c, i: i.rewrite_pin_owner("a", "c"))
    both(lambda c, i: i.take_pins(owner="b"))
    port_index.release_pin(pins["port"])
    ref_index.release_pin(pins["ref"])
    both(lambda c, i: i.outstanding_pins)
    c_port, c_ref = ports["a"], refs["a"]
    c_port.acquire(chains[0][:1])
    c_ref.acquire(chains[0][:1])
    both(lambda c, i: c["a"].evict(4))
    both(lambda c, i: c["a"].drop_entries(chains[0]))
    both(lambda c, i: c["a"].drop_entries(chains[1]))
    both(lambda c, i: i.forget_shard("b"))
    # a cache wrapped mid-life publishes what it already holds
    inner_p, inner_r = PrefixCache(8), JaxPrefixCache(8)
    inner_p.insert(chains[2], [11, 12, 13])
    inner_r.insert(chains[2], [11, 12, 13])
    IndexedPrefixCache(inner_p, port_index, "d")
    JaxIndexedPrefixCache(inner_r, ref_index, "d")
    assert state(port_index) == state(ref_index)


# -- warm-anywhere admission -------------------------------------------------


@pytest.mark.parametrize("cache_dtype", ["bf16", "int8", "fp8"])
def test_cross_shard_prefix_hit_stream_bitwise(pair, cache_dtype):
    """A request admitted on shard B against a prefix cached only on shard A
    streams the bits of the same request's local warm hit (the shifted
    replay lands every request on the other shard), in every pool dtype;
    the fabric's counters are the reference's. In bf16 the fabric-off
    cluster's shifted replay (cold admissions) is the same bits too."""
    warm = [_req(100 + i) for i in range(4)]
    shifted = warm[1:] + warm[:1]
    port, ref = _both(pair, _cfg(FabricConfig()), cache_dtype=cache_dtype)
    _run_both(port, ref, warm)
    local = _run_both(port, ref, warm)
    fab = port.fabric
    l0, h0 = fab.cross_shard_lookups, fab.cross_shard_hits
    cross = _run_both(port, ref, shifted)
    assert fab.cross_shard_lookups > l0 and fab.cross_shard_hits > h0
    assert fab.pages_fetched > 0 and "fabric" in port.transfer.ops_by_plane
    _bitwise_pairs(cross, [local[(i + 1) % len(warm)] for i in range(len(warm))])
    assert _fab_state(port) == _fab_state(ref)
    assert fab.index.outstanding_pins == 0
    if cache_dtype == "bf16":
        off, _ = _both(pair, _cfg(None), cache_dtype=cache_dtype)
        off.run(warm)
        _bitwise_pairs(cross, off.run(shifted))


def test_fabric_pins_release_on_retire_and_pool_stays_balanced(pair):
    """Cross-shard pins release at retirement (none outstanding, some
    released, as in the reference), and dropping every cache entry returns
    both pools to pristine."""
    warm = [_req(200 + i) for i in range(4)]
    port, ref = _both(pair, _cfg(FabricConfig()))
    _run_both(port, ref, warm)
    _run_both(port, ref, warm[1:] + warm[:1])
    assert port.fabric.index.outstanding_pins == 0
    assert port.fabric.pins_released > 0
    assert _fab_state(port) == _fab_state(ref)
    for shard in port.shards:
        _drop_all_cached(shard.batcher)
        _pristine(shard.batcher)


def test_fabric_pins_survive_drain(pair):
    """Draining a shard with the fabric on leaks no pin: the drained shard's
    directory entries go and its borrows release before it goes dark; the
    queued work serves as the reference's does."""
    warm = [_req(300 + i) for i in range(4)]
    port, ref = _both(pair, _cfg(FabricConfig(), failover=True))
    _run_both(port, ref, warm)
    _run_both(port, ref, warm[1:] + warm[:1])
    for req in warm:
        assert port.submit(req).accepted
        assert ref.submit(_jreq(req)).accepted
    outcome = port.drain(0)
    assert outcome == ref.drain(0)
    drained = port.run_pending()
    assert len(drained) == len(warm)
    _close_band(drained, ref.run_pending())
    assert port.fabric.index.outstanding_pins == 0
    assert _fab_state(port) == _fab_state(ref)


def test_fabric_fetch_failure_falls_back_to_cold_prefill(pair):
    """A fetch whose page hop fails terminally counts one ``fetch_failures``
    and admits cold: the borrower is not marked down, no pin is left, and in
    bf16 the stream is still the fabric-off cluster's bits. (The reference
    behaves alike; this leg of it has no test there.)"""
    warm = [_req(310 + i) for i in range(2)]
    shifted = warm[1:] + warm[:1]
    port, ref = _both(pair, _cfg(FabricConfig(), failover=True))
    _run_both(port, ref, warm)
    port.transfer.fail_next(3, worker="decode-0")
    ref.transfer.fail_next(3, worker="decode-0")
    cross = _run_both(port, ref, shifted)
    assert port.fabric.fetch_failures >= 1
    assert port.failover.state("decode-0") == "up"
    assert port.fabric.index.outstanding_pins == 0
    assert _fab_state(port) == _fab_state(ref)
    off, _ = _both(pair, _cfg(None))
    off.run(warm)
    _bitwise_pairs(cross, off.run(shifted))


# -- the standby mirror --------------------------------------------------------


def test_standby_killed_mid_mirror_primary_keeps_serving(pair):
    """A standby that dies mid-mirror is discarded, the primaries keep
    serving, and the next pass spawns a fresh standby synced from live
    pages; the warm replay of the first trace is its bits."""
    port, ref = _both(pair, _cfg(FabricConfig(standby=True), failover=True))
    trace = [_req(400 + i) for i in range(4)]
    base = _run_both(port, ref, trace)
    fab = port.fabric
    assert fab.standby is not None and fab.standbys_spawned == 1
    assert fab.mirror.mirrored_pages > 0 and "mirror" in port.transfer.ops_by_plane
    assert _fab_state(port) == _fab_state(ref)
    port.transfer.fail_next(3, worker="standby-0")
    ref.transfer.fail_next(3, worker="standby-0")
    trace2 = [_req(420 + i) for i in range(4)]
    survived = _run_both(port, ref, trace2)
    assert len(survived) == len(trace2)
    assert fab.standby_failures == 1 and fab.standby is None
    mirrored_before = fab.mirror.mirrored_pages
    replay = _run_both(port, ref, trace)
    _bitwise_pairs(replay, base)
    assert fab.standby.pool.name == "standby-1" and fab.standbys_spawned == 2
    assert fab.mirror.mirrored_pages > mirrored_before
    assert fab.index.outstanding_pins == 0
    assert _fab_state(port) == _fab_state(ref)


def test_standby_promotion_recovers_bitwise(pair):
    """A decode shard killed with the standby armed: recovery promotes the
    standby (pin adoption, no replayed prefill) and the recovered streams
    are the uninterrupted warm pass's bits; the promotion and the shards
    are the reference's."""
    port, ref = _both(pair, _cfg(FabricConfig(standby=True), failover=True))
    trace = [_req(500 + i) for i in range(4)]
    _run_both(port, ref, trace)
    base = _run_both(port, ref, trace)
    inject_worker_fault(port, WorkerFault("decode-1", "kill", after_dispatches=0))
    jchaos.inject_worker_fault(ref, jchaos.WorkerFault("decode-1", "kill",
                                                       after_dispatches=0))
    recovered = _run_both(port, ref, trace)
    _bitwise_pairs(recovered, base)
    fab = port.fabric
    assert fab.promotions == 1 and fab.index.outstanding_pins == 0
    assert any(s.pool.name.startswith("standby-") for s in port.shards)
    assert port.failover.state("standby-0") == "up"
    assert _fab_state(port) == _fab_state(ref)
    assert port.health_snapshot() == ref.health_snapshot()


def test_fabric_off_cluster_has_no_engine(pair):
    """Default off: no engine, no fabric or mirror plane, no standby."""
    port, ref = _both(pair, _cfg(None))
    _run_both(port, ref, [_req(600 + i) for i in range(2)])
    assert port.fabric is None and ref.fabric is None
    assert "fabric" not in port.transfer.ops_by_plane
    assert "mirror" not in port.transfer.ops_by_plane
    assert all(s.pool.name.startswith("decode-") for s in port.shards)
    for shard in port.shards:
        assert shard.batcher.prefix_fetcher is None


def test_fabric_events_recorded_without_edges(pair):
    """With a recorder, every page hop is a ``fabric`` or ``mirror`` event
    naming its worker, source and pages, and a spawn and a promotion are
    ``standby`` and ``promote`` instants, as many of each as the
    reference's; with no flight plane bound to the recorder, no ``*.send``
    edge instants and no edge ids."""
    names = ("fabric", "mirror", "standby", "promote")
    fr = FlightRecorder(ring_size=1 << 14)
    port, ref = _both(pair, _cfg(FabricConfig(standby=True), failover=True),
                      flight_recorder=fr)
    warm = [_req(700 + i) for i in range(4)]
    for reqs in (warm, warm[1:] + warm[:1]):
        _run_both(port, ref, reqs)
    inject_worker_fault(port, WorkerFault("decode-0", "kill", after_dispatches=0))
    jchaos.inject_worker_fault(ref, jchaos.WorkerFault("decode-0", "kill",
                                                       after_dispatches=0))
    _run_both(port, ref, warm)
    got = [e for e in fr.events() if e["name"] in names or e["name"].endswith(".send")]
    want = [e for e in ref.flight_recorder.events() if e["name"] in names]
    assert sorted(e["name"] for e in got) == sorted(e["name"] for e in want)
    assert {e["name"] for e in got} == set(names)
    for e in got:
        assert "edge" not in e.get("args", {})
        if e["name"] in ("fabric", "mirror"):
            assert {"worker", "src", "pages"} <= set(e["args"])
    assert _fab_state(port) == _fab_state(ref)


# -- federated incident traces ----------------------------------------------


def _federated_vault(impl, worker_legs):
    """A plane bound to a recorder, a vault linked to the plane with an
    incident open, and one request's lifecycle: in the plane's ring
    (``worker_legs``: the workers its events name) and folded by the
    vault. Returns (vault, the vault id of the kept trace)."""
    import beholder_tpu.obs as jobs
    import beholder_tpu.obs.flightplane as jfp
    import beholder_tpu_torch.obs as tobs
    import beholder_tpu_torch.obs.flightplane as tfp

    obs, fp = (jobs, jfp) if impl == "ref" else (tobs, tfp)
    plane = fp.FlightPlane(worker="decode-0")
    recorder = plane.bind(obs.FlightRecorder())
    recorder.set_meta(epoch_us=10_000_000, mono_us=1_000_000, pid=1)
    vault = obs.TraceVault(obs.RetentionConfig(incident_budget=4), clock=lambda: 1e9)
    vault.link_flight_plane(plane)
    vault.open_incident("chaos: mirror link down")
    trace = "tr-fed-0"
    for i, (name, worker) in enumerate(worker_legs):
        args = {"gid": "g-fed", "slot": 0}
        if worker is not None:
            args["worker"] = worker
        if name == "req.retire":
            args.update(tokens=4, outcome="ok")
        recorder._append({"name": name, "ph": "i", "ts_us": 10_000_000 + 1000 * i,
                          "trace_id": trace, "args": args})
    vault.on_event({"name": "req.claim", "ph": "i", "ts_us": 1_000, "trace_id": trace,
                    "args": {"gid": "g-fed", "slot": 0}})
    vault.on_event({"name": "req.retire", "ph": "i", "ts_us": 90_000, "trace_id": trace,
                    "args": {"gid": "g-fed", "tokens": 4, "outcome": "ok"}})
    return vault, vault.trace_ref("g-fed"), plane


def test_incident_trace_federates_across_plane_rings():
    """An incident-kept trace is assembled from the merged flight plane
    (the claim on decode-0's ring, the handoff and retirement on
    decode-1's) instead of the local buffer, marked ``federated``, and
    served so at /debug/traces/<id>: the port's and the reference's equal
    byte for byte."""
    legs = [("req.claim", None), ("handoff.recv", "decode-1"), ("req.retire", "decode-1")]
    out = {}
    for impl in ("ref", "port"):
        vault, vault_id, plane = _federated_vault(impl, legs)
        assert len(plane.rings()) >= 2
        assert vault.federated == 1 and vault_id is not None
        out[impl] = (vault.index(), vault.trace_route()(vault_id))
    assert out["port"] == out["ref"]
    code, _, body = out["port"][1]
    doc = json.loads(body)
    assert code == 200 and doc["federated"] is True and doc["vault"]["federated"] is True
    workers = {e.get("args", {}).get("worker") for e in doc["traceEvents"]
               if e.get("ph") != "M"}
    assert {"decode-0", "decode-1"} <= workers


def test_federation_falls_back_to_local_on_single_ring():
    """With one ring on the plane there is nothing to merge: the incident
    keep falls back to the local assembly, unmarked, as the reference's."""
    out = {}
    for impl in ("ref", "port"):
        vault, vault_id, _ = _federated_vault(impl, [("req.claim", None)])
        assert vault.federated == 0 and vault_id is not None
        out[impl] = (vault.index(), vault.trace_route()(vault_id))
    assert out["port"] == out["ref"]
    assert "federated" not in json.loads(out["port"][1][2])
