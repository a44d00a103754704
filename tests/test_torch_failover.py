"""The port's fault-tolerant cluster against its own single batcher and the
JAX reference: worker kill, hang and transfer faults with bitwise recovery,
explicit ``Dropped`` and ``shard_down`` outcomes, deadline-aware
retirement, graceful drain with a byte-identical migration of live slots
and prefix-cache pages (bf16, int8 and fp8 pools), the splice ledger, and
the failover events on worker tracks.

Model, geometry, placement and tolerances as in
``tests/test_torch_cluster.py``: the port's recovered streams are the
uninterrupted single batcher's bits (``np.array_equal``), within
``atol=1e-4`` of the JAX cluster's under the same fault, and worker states,
recovery, drop, shed and transfer counters equal the reference's exactly;
migrated pages are byte-identical, and the destination's allocator state
equals the reference's after the same migration.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from beholder_tpu.cache import PrefixCache as JaxPrefixCache
from beholder_tpu.cluster import FailoverConfig as JaxFailoverConfig
from beholder_tpu.cluster import cluster_from_config as jax_cluster_from_config
from beholder_tpu.cluster.failover import migrate_pool as jax_migrate_pool
from beholder_tpu.cluster.transfer import PageTransferEngine as JaxPageTransferEngine
from beholder_tpu.config import ConfigNode
from beholder_tpu.metrics import Registry as JaxRegistry
from beholder_tpu.models import serving as jsv
from beholder_tpu.obs import FlightRecorder as JaxFlightRecorder
from beholder_tpu.reliability import chaos as jchaos
from beholder_tpu.reliability.policy import Deadline as JaxDeadline
from beholder_tpu.spec import SpecConfig as JaxSpecConfig
from beholder_tpu_torch.cache import PrefixCache
from beholder_tpu_torch.cluster import ClusterConfig, FailoverConfig, cluster_from_config
from beholder_tpu_torch.cluster.failover import (
    WORKER_DOWN,
    DrainError,
    Dropped,
    FailoverEngine,
    WorkerKilled,
    migrate_pool,
)
from beholder_tpu_torch.cluster.transfer import PageTransferEngine, TransferFailed
from beholder_tpu_torch.metrics import Registry
from beholder_tpu_torch.models import serving as tsv
from beholder_tpu_torch.models.serving import DeadlineExceededResult
from beholder_tpu_torch.obs import WORKER_TID_BASE, FlightRecorder, chrome_trace
from beholder_tpu_torch.ops import NUM_STATUSES
from beholder_tpu_torch.reliability import Deadline, RetryBudget, RetryPolicy
from beholder_tpu_torch.reliability.chaos import WorkerFault, inject_worker_fault
from beholder_tpu_torch.spec import SpecConfig

from test_torch_cluster import (  # noqa: F401 - the shared fixture
    BATCHER_KW,
    _bitwise,
    _close,
    _jcfg,
    _jreq,
    _port,
    _pristine,
    _ref,
    _request,
    _single,
    _transfers,
    pair,
)


def _failover_cfg(**kw):
    return ClusterConfig(**{"n_decode_workers": 2, "failover": FailoverConfig(), **kw})


def _jfault(fault):
    return jchaos.WorkerFault(fault.worker, fault.kind, fault.after_dispatches,
                              fault.transfer_failures)


def _both(pair, cfg, faults=(), **kw):
    """The port's cluster and the reference's, built alike, each with
    ``faults`` injected."""
    cluster, ref = _port(pair[2], cfg, **kw), _ref(pair, _jcfg(cfg), **_jkw(kw))
    for fault in faults:
        inject_worker_fault(cluster, fault)
        jchaos.inject_worker_fault(ref, _jfault(fault))
    return cluster, ref


def _jkw(kw):
    """The reference's counterparts of the port's cluster keywords."""
    out = dict(kw)
    if "metrics" in out:
        out["metrics"] = JaxRegistry()
    if out.get("prefix_cache_factory") is not None:
        out["prefix_cache_factory"] = lambda: JaxPrefixCache(BATCHER_KW["page_size"])
    if "spec" in out:
        spec = out["spec"]
        out["spec"] = JaxSpecConfig(max_draft=spec.max_draft, accept_tol=spec.accept_tol)
    if "flight_recorder" in out:
        out["flight_recorder"] = JaxFlightRecorder(ring_size=out["flight_recorder"].ring_size)
    return out


def _failover_state(cluster):
    fo = cluster.failover
    return (dict(fo.states), fo.recovered_total, fo.dropped_total, fo.drains,
            fo.migrated_pages)


# -- config ------------------------------------------------------------------


def test_failover_config_parse_and_validation():
    tree = {"instance": {"cluster": {"enabled": True, "failover": {
        "enabled": True, "heartbeat_interval_s": 0.5, "miss_threshold": 2,
        "max_recoveries_per_request": 1, "drain_on_sigterm": False,
    }}}}
    cfg = cluster_from_config(ConfigNode(tree))
    want = jax_cluster_from_config(ConfigNode(tree)).failover
    assert (cfg.failover.heartbeat_interval_s, cfg.failover.miss_threshold,
            cfg.failover.max_recoveries_per_request, cfg.failover.drain_on_sigterm) == (
        want.heartbeat_interval_s, want.miss_threshold, want.max_recoveries_per_request,
        want.drain_on_sigterm) == (0.5, 2, 1, False)
    assert cluster_from_config(
        ConfigNode({"instance": {"cluster": {"enabled": True}}})).failover is None
    for kw in (dict(heartbeat_interval_s=0), dict(miss_threshold=0),
               dict(max_recoveries_per_request=-1)):
        with pytest.raises(ValueError):
            FailoverConfig(**kw)
        with pytest.raises(ValueError):
            JaxFailoverConfig(**kw)


def test_worker_fault_requires_failover(pair):
    cluster = _port(pair[2], ClusterConfig(n_decode_workers=2))
    with pytest.raises(RuntimeError, match="failover"):
        inject_worker_fault(cluster, WorkerFault("decode-0"))
    with pytest.raises(ValueError, match="kind"):
        WorkerFault("decode-0", kind="meteor")


def test_retry_policy_matches_the_reference():
    """The transfer engine's retry: backoff, give-ups and the budget, with
    injected sleep and rng, against the reference's policy."""
    from beholder_tpu.reliability.policy import RetryBudget as JaxRetryBudget
    from beholder_tpu.reliability.policy import RetryPolicy as JaxRetryPolicy

    def drive(policy_cls, budget_cls):
        sleeps = []
        budget = budget_cls(capacity=1.0, deposit_per_call=0.0)
        policy = policy_cls(max_attempts=4, base_delay_s=0.01, max_delay_s=0.025,
                            budget=budget, sleep=sleeps.append, rng=lambda: 0.5)
        calls = []

        def flaky():
            calls.append(1)
            if len(calls) < 2:
                raise ConnectionError("transient")
            return "ok"

        assert policy.call(flaky, op="t") == "ok"
        with pytest.raises(ConnectionError):
            policy.call(lambda: (_ for _ in ()).throw(ConnectionError("x")), op="t")
        return sleeps, len(calls), budget.tokens, [policy.backoff_s(a) for a in (1, 2, 3, 4)]

    assert drive(RetryPolicy, RetryBudget) == drive(JaxRetryPolicy, JaxRetryBudget)


# -- kill a decode shard mid-stream ----------------------------------------------


def test_kill_decode_shard_mid_stream_bitwise_recovery(pair):
    """Killing one of two decode shards after one tick completes every
    request with the uninterrupted single batcher's bits, leaves the
    survivor's pool pristine, and lands the failover series; worker states
    and recovery counts equal the reference's under the same fault."""
    reqs = [_request(i, horizon=5) for i in range(6)]
    base = _single(pair[2]).run(reqs)
    registry = Registry()
    fault = WorkerFault("decode-1", "kill", after_dispatches=1)
    cluster, ref = _both(pair, _failover_cfg(), [fault], metrics=registry)
    got = cluster.run(reqs)
    assert cluster.failover.state("decode-1") == "down"
    assert cluster.failover.recovered_total > 0
    _bitwise(got, base)
    _close(got, ref.run([_jreq(r) for r in reqs]))
    assert _failover_state(cluster) == _failover_state(ref)
    assert len(cluster.failover.recovery_walls) == len(ref.failover.recovery_walls) == 1
    _pristine(cluster.shards[0].batcher)
    exposition = registry.render()
    assert "beholder_failover_recoveries_total" in exposition
    assert 'beholder_failover_worker_up{worker="decode-1"} 0' in exposition
    assert 'beholder_failover_worker_failures_total{worker="decode-1"' in exposition
    # and the cluster keeps serving on the survivor
    _bitwise(cluster.run(reqs), base)


def test_kill_prefill_worker_mid_handoff(pair):
    """A prefill worker dying mid-handoff fails over to the surviving one,
    and with none left to the shard's colocated fallback: the single
    batcher's bits either way, the reference's worker states."""
    reqs = [_request(i, horizon=4) for i in range(6)]
    base = _single(pair[2]).run(reqs)
    for n_prefill, after in ((2, 1), (1, 0)):
        cluster, ref = _both(pair, _failover_cfg(n_prefill_workers=n_prefill),
                             [WorkerFault("prefill-0", "kill", after_dispatches=after)])
        got = cluster.run(reqs)
        assert cluster.failover.state("prefill-0") == "down"
        _bitwise(got, base)
        _close(got, ref.run([_jreq(r) for r in reqs]))
        assert _failover_state(cluster) == _failover_state(ref)
        assert _transfers(cluster) == _transfers(ref)
    assert cluster.shards[0].local_prefill is not None


def test_hang_detection_marks_worker_down_and_reroutes(pair):
    reqs = [_request(i, horizon=5) for i in range(4)]
    cfg = _failover_cfg(failover=FailoverConfig(heartbeat_interval_s=0.01, miss_threshold=1))
    cluster, ref = _both(pair, cfg)
    for req in reqs:
        assert cluster.submit(req).accepted
        assert ref.submit(_jreq(req)).accepted
    inject_worker_fault(cluster, WorkerFault("decode-1", "hang"))
    jchaos.inject_worker_fault(ref, jchaos.WorkerFault("decode-1", "hang"))
    results = cluster.run_pending()
    assert cluster.failover.state("decode-1") == "down"
    _bitwise(results, _single(pair[2]).run(reqs))
    _close(results, ref.run_pending())
    assert _failover_state(cluster) == _failover_state(ref)


# -- transfer faults: bounded retry, typed terminal failure ----------------------


def test_transfer_fault_absorbed_by_retry(pair):
    reqs = [_request(i, horizon=4) for i in range(4)]
    fault = WorkerFault("decode-0", "transfer_corruption", transfer_failures=1)
    cluster, ref = _both(pair, _failover_cfg(n_prefill_workers=1), [fault])
    got = cluster.run(reqs)
    assert cluster.transfer.failed == 0
    assert cluster.transfer.faults_injected == 1
    assert cluster.failover.state("decode-0") == "up"
    _bitwise(got, _single(pair[2]).run(reqs))
    _close(got, ref.run([_jreq(r) for r in reqs]))
    assert _transfers(cluster) == _transfers(ref)


def test_transfer_terminal_failure_is_typed_and_recovered(pair):
    """Retries exhausted: the fail-stop cluster raises a typed
    TransferFailed; the failover cluster marks the unreachable shard down
    and recovers the batch with the single batcher's bits."""
    reqs = [_request(i, horizon=4) for i in range(4)]
    plain = _port(pair[2], ClusterConfig(n_decode_workers=2, n_prefill_workers=1))
    plain.transfer.fail_next(3)  # the retry's max_attempts: every retry burns
    with pytest.raises(TransferFailed):
        plain.run(reqs)
    assert plain.transfer.failed == 1

    registry = Registry()
    fault = WorkerFault("decode-0", "transfer_corruption", transfer_failures=3)
    cluster, ref = _both(pair, _failover_cfg(n_prefill_workers=1), [fault], metrics=registry)
    got = cluster.run(reqs)
    assert cluster.transfer.failed == 1
    assert [n for n in ("decode-0", "decode-1")
            if cluster.failover.state(n) == "down"] == ["decode-0"]
    _bitwise(got, _single(pair[2]).run(reqs))
    _close(got, ref.run([_jreq(r) for r in reqs]))
    assert _failover_state(cluster) == _failover_state(ref)
    assert _transfers(cluster) == _transfers(ref)
    exposition = registry.render()
    assert "beholder_cluster_transfer_failed_total 1" in exposition
    assert 'beholder_failover_recoveries_total{reason="transfer_failed"}' in exposition


# -- recovery bounds and shard_down shedding -------------------------------------


def test_recovery_limit_yields_explicit_dropped_outcome(pair):
    reqs = [_request(i, horizon=4) for i in range(4)]
    cluster, ref = _both(
        pair, _failover_cfg(failover=FailoverConfig(max_recoveries_per_request=0)),
        [WorkerFault("decode-0", "kill"), WorkerFault("decode-1", "kill")],
    )
    results = cluster.run(reqs)
    assert all(isinstance(r, Dropped) for r in results)
    assert [r.reason for r in results] == [r.reason for r in ref.run([_jreq(r) for r in reqs])]
    assert {r.reason for r in results} <= {"recovery_limit", "shard_down"}
    assert _failover_state(cluster) == _failover_state(ref)


def test_oversized_on_healthy_failover_cluster_still_raises(pair):
    """An always-unservable request is a caller error, not a shard failure:
    it raises the batcher's own pool-exhausted error."""
    with pytest.raises(RuntimeError, match="page pool exhausted"):
        _port(pair[2], _failover_cfg()).run([_request(0, horizon=400)])


def test_submit_sheds_shard_down_when_survivors_cannot_fit(pair):
    registry = Registry()
    cluster, ref = _both(pair, _failover_cfg(), metrics=registry)
    for c in (cluster, ref):
        c.failover.mark_down("decode-0", "kill")
        c.failover.mark_down("decode-1", "kill")
    admission = cluster.submit(_request(0, horizon=4))
    assert tuple(admission) == tuple(ref.submit(_jreq(_request(0, horizon=4))))
    assert not admission.accepted and admission.reason == "shard_down"
    exposition = registry.render()
    assert ('beholder_intake_shed_total{queue="cluster.decode-0",reason="shard_down"} 1'
            in exposition)
    # submit-time rejections land on the intake shed counters only
    assert registry.find("beholder_failover_dropped_total").total() == 0
    assert cluster.failover.states == {"decode-0": WORKER_DOWN, "decode-1": WORKER_DOWN}


# -- deadline-aware degraded mode -------------------------------------------------


class _CountingDeadline:
    """Deterministic deadline: expires after N ``.expired`` probes."""

    def __init__(self, after: int):
        self.calls = 0
        self.after = after

    @property
    def expired(self) -> bool:
        self.calls += 1
        return self.calls > self.after


def test_deadline_exceeded_is_explicit_and_frees_the_slot(pair):
    """Expired while queued: a zero-token outcome at claim; expired
    mid-flight: a partial stream that is a bitwise prefix of the
    uninterrupted run, pages home; both counted once each, as the
    reference's batcher does."""
    jm, params, tm = pair
    registry = Registry()
    res = _single(tm, metrics=registry).run([
        _request(0, horizon=3), _request(1, horizon=3, deadline=Deadline.after(-1.0)),
        _request(2, horizon=3),
    ])
    jres = jsv.ContinuousBatcher(jm, params, **BATCHER_KW).run([
        _jreq(_request(0, horizon=3)),
        _jreq(_request(1, horizon=3), deadline=JaxDeadline.after(-1.0)),
        _jreq(_request(2, horizon=3)),
    ])
    assert isinstance(res[1], DeadlineExceededResult) and res[1].tokens.shape == (0,)
    _close(res, jres)
    base = _single(tm).run([_request(0, horizon=3), _request(2, horizon=3)])
    assert np.array_equal(res[0], base[0]) and np.array_equal(res[2], base[1])

    b2 = _single(tm, metrics=registry)
    res2 = b2.run([_request(0, horizon=3), _request(3, horizon=8, deadline=_CountingDeadline(1)),
                   _request(2, horizon=3)])
    jres2 = jsv.ContinuousBatcher(jm, params, **BATCHER_KW).run([
        _jreq(_request(0, horizon=3)),
        _jreq(_request(3, horizon=8), deadline=_CountingDeadline(1)),
        _jreq(_request(2, horizon=3)),
    ])
    partial = res2[1]
    assert isinstance(partial, DeadlineExceededResult) and 0 < len(partial.tokens) < 8
    _close(res2, jres2)
    full = _single(tm).run([_request(0, horizon=3), _request(3, horizon=8),
                            _request(2, horizon=3)])
    assert np.array_equal(partial.tokens, full[1][: len(partial.tokens)])
    _pristine(b2)
    assert "beholder_failover_deadline_exceeded_total 2" in registry.render()
    clean = Registry()
    _single(tm, metrics=clean).run([_request(0, horizon=3)])
    assert "deadline" not in clean.render()


def test_deadline_threads_through_cluster_disaggregated_loop(pair):
    """Round robin pairs the deadlined request with a short one on its
    shard, so the short retirement makes the mid-flight event where the
    expiry sweep runs: a partial stream, as in the reference."""
    cfg = _failover_cfg(n_prefill_workers=1, route_policy="round_robin")
    cluster, ref = _both(pair, cfg)
    plan = [(0, 3, None), (3, 8, 1), (2, 3, None), (4, 3, None)]
    res = cluster.run([_request(s, horizon=h, deadline=_CountingDeadline(d) if d else None)
                       for s, h, d in plan])
    jres = ref.run([_jreq(_request(s, horizon=h), deadline=_CountingDeadline(d) if d else None)
                    for s, h, d in plan])
    assert isinstance(res[1], DeadlineExceededResult) and 0 < len(res[1].tokens) < 8
    assert [np.asarray(r).shape for r in (res[0], res[2], res[3])] == [(3,)] * 3
    _close(res, jres)
    full = _single(pair[2]).run([_request(s, horizon=h) for s, h, _ in plan])
    assert np.array_equal(res[1].tokens, full[1][: len(res[1].tokens)])
    _bitwise([res[0], res[2], res[3]], [full[0], full[2], full[3]])


# -- graceful drain -----------------------------------------------------------------


def test_drain_migrates_queued_work_cache_pins_and_serves_warm(pair):
    """With warm prefix pins and spec decoding armed, draining a shard moves
    its queued work and cached pages to the survivor with zero loss: warm
    replays hit the migrated cache with the single batcher's bits, drain
    counts equal the reference's, and a full eviction leaves the survivor
    pristine (refcounts moved wholesale)."""
    tm = pair[2]
    spec_kw = dict(num_pages=24, max_pages_per_seq=6)
    reqs = [_request(i % 2, t=9, horizon=4) for i in range(4)]
    base = _single(tm, spec=SpecConfig(max_draft=3, accept_tol=0.0),
                   prefix_cache=PrefixCache(8), **spec_kw).run_spec(reqs)
    registry = Registry()
    cluster, ref = _both(
        pair, _failover_cfg(route_policy="round_robin"), metrics=registry,
        spec=SpecConfig(max_draft=3, accept_tol=0.0),
        prefix_cache_factory=lambda: PrefixCache(8), **spec_kw,
    )
    cold = cluster.run(reqs)
    _bitwise(cold, base)
    _close(cold, ref.run([_jreq(r) for r in reqs]))
    assert cluster.shards[0].batcher.prefix_cache.page_count > 0

    for req in reqs:
        assert cluster.submit(req).accepted
        assert ref.submit(_jreq(req)).accepted
    queued_before = sum(s.intake.depth for s in cluster.shards)
    outcome = cluster.drain(0)
    assert outcome == ref.drain(0)
    assert outcome["migrated_pages"] > 0
    assert cluster.failover.state("decode-0") == "drained"
    snap = cluster.health_snapshot()
    assert snap["down"] == [] and snap["drained"] == ["decode-0"]
    assert snap == ref.health_snapshot()
    assert sum(s.intake.depth for s in cluster.shards) == queued_before
    survivor = cluster.shards[1].batcher
    hits_before = survivor.prefix_cache.hits
    drained = cluster.run_pending()
    _bitwise(drained, base)
    _close(drained, ref.run_pending())
    assert survivor.prefix_cache.hits > hits_before
    assert survivor.prefix_cache.hits == ref.shards[1].batcher.prefix_cache.hits
    assert _failover_state(cluster) == _failover_state(ref)
    exposition = registry.render()
    assert "beholder_failover_drains_total 1" in exposition
    assert "beholder_failover_migrated_pages_total" in exposition
    survivor._evict_cached(survivor.num_pages)
    _pristine(survivor)


def test_drain_requires_failover_and_survivors(pair):
    with pytest.raises(RuntimeError, match="failover"):
        _port(pair[2], ClusterConfig(n_decode_workers=2)).drain(0)
    solo = _port(pair[2], ClusterConfig(n_decode_workers=1, failover=FailoverConfig()))
    with pytest.raises(DrainError, match="last healthy"):
        solo.drain(0)
    assert solo.failover.state("decode-0") == "up"  # rolled back


def _raw(pool, page):
    """One page's raw bytes in a pool (values and scales of a quantized
    pool, given as a ``QuantizedPool`` or a plain pair)."""
    parts = tuple(pool) if isinstance(pool, tuple) else (pool,)
    return [p[page].contiguous().view(torch.uint8) for p in parts]


@pytest.mark.parametrize("cache_dtype", ["bf16", "int8", "fp8"])
def test_migrate_pool_live_slots_byte_identical(pair, cache_dtype):
    """Live slots, a refcount-shared fork among them, move with destination
    pages byte-identical (raw values and scales, no requantize round trip)
    and refcounts preserved; the destination's allocator state equals the
    reference's after the same migration, the source is poisoned, and
    continued decode is bitwise an unmigrated rollout's."""
    jm, params, tm = pair
    kw = dict(BATCHER_KW, slots=4, cache_dtype=cache_dtype)
    feats = np.random.default_rng(3).normal(0, 1, (2, 16, 1 + NUM_STATUSES)).astype(np.float32)

    def admitted():
        b = _single(tm, **kw)
        _, b.state = tsv.paged_admit_batch(
            tm, b.state, torch.tensor([0, 1], dtype=torch.int32), torch.from_numpy(feats),
            torch.tensor([13, 9], dtype=torch.int32),
        )
        b.state = tsv.paged_fork(b.state, 0, torch.tensor([2], dtype=torch.int32))
        return b

    src, dst = admitted(), _single(tm, **kw)
    table = src.state.page_table.clone()
    refs = src.state.page_ref.clone()
    src_pools = [(tuple(p.clone() for p in k) if isinstance(k, tuple) else k.clone(),
                  tuple(p.clone() for p in v) if isinstance(v, tuple) else v.clone())
                 for k, v in zip(src.state.k_pools, src.state.v_pools)]
    moved = migrate_pool(src, dst, PageTransferEngine(), src="src", dst="dst")
    assert moved == int((refs > 0).sum())
    assert src._poisoned
    for s in range(3):
        assert int(dst.state.seq_lens[s]) == int(src.state.seq_lens[s])
        assert bool(dst.state.active[s])
        for j in range(-(-int(src.state.seq_lens[s]) // BATCHER_KW["page_size"])):
            o, d = int(table[s, j]), int(dst.state.page_table[s, j])
            assert int(refs[o]) == int(dst.state.page_ref[d])
            for layer, (k_src, v_src) in enumerate(src_pools):
                for pool_s, pool_d in ((k_src, dst.state.k_pools[layer]),
                                       (v_src, dst.state.v_pools[layer])):
                    for a, b in zip(_raw(pool_s, o), _raw(pool_d, d)):
                        assert torch.equal(a, b)

    # the same migration in the reference: equal moved count and allocator
    jdtype = {"int8": jnp.int8, "fp8": "fp8"}.get(cache_dtype, jnp.bfloat16)
    jkw = dict(BATCHER_KW, slots=4, cache_dtype=jdtype)
    jsrc = jsv.ContinuousBatcher(jm, params, **jkw)
    jdst = jsv.ContinuousBatcher(jm, params, **jkw)
    _, jsrc.state = jsv.paged_admit_batch(jm, params, jsrc.state, jnp.asarray([0, 1], jnp.int32),
                                          jnp.asarray(feats), jnp.asarray([13, 9], jnp.int32))
    jsrc.state = jsv.paged_fork(jsrc.state, jnp.int32(0), jnp.asarray([2], jnp.int32))
    assert jax_migrate_pool(jsrc, jdst, JaxPageTransferEngine(), src="src", dst="dst") == moved
    for name in ("page_table", "seq_lens", "active", "free_stack", "free_top", "page_ref"):
        np.testing.assert_array_equal(getattr(dst.state, name).numpy(),
                                      np.asarray(getattr(jdst.state, name)), err_msg=name)

    # continued decode on the migrated pool == an unmigrated rollout
    ref = admitted()
    feats_t = torch.from_numpy(
        np.random.default_rng(4).normal(0, 1, (4, 1 + NUM_STATUSES)).astype(np.float32))
    with torch.no_grad():
        for _ in range(3):
            p_ref, ref.state = tsv.paged_decode_tick(tm, ref.state, feats_t)
            p_dst, dst.state = tsv.paged_decode_tick(tm, dst.state, feats_t)
            assert torch.equal(p_ref, p_dst)


def test_migrate_pool_refuses_what_the_destination_cannot_hold(pair):
    tm = pair[2]
    src = _single(tm, slots=2)
    dst = _single(tm, slots=2)
    feats = torch.zeros((2, 16, 1 + NUM_STATUSES))
    for b in (src, dst):
        _, b.state = tsv.paged_admit_batch(tm, b.state, torch.tensor([0, 1], dtype=torch.int32),
                                           feats, torch.tensor([9, 9], dtype=torch.int32))
    with pytest.raises(DrainError, match="free slots"):
        migrate_pool(src, dst)
    assert not src._poisoned


# -- the splice ledger: no token emitted twice or skipped --------------------------


def test_splice_never_duplicates_or_skips_and_rejects_divergence():
    class _Router:
        shards = []
        prefill_workers = []

    engine = FailoverEngine(_Router(), FailoverConfig())
    replay = np.arange(6, dtype=np.float32)
    assert np.array_equal(engine.splice("r", replay), replay)
    # a delivered prefix splices once, and the entry is consumed
    engine.record_emitted("r", replay[:3])
    assert np.array_equal(engine.splice("r", replay), replay)
    assert np.array_equal(engine.splice("r", replay * 2), replay * 2)
    engine.record_emitted("r", replay[:3])
    bad = replay.copy()
    bad[1] = 99.0
    with pytest.raises(RuntimeError, match="diverged"):
        engine.splice("r", bad)
    engine.record_emitted("q", replay[:2])
    engine.discard_emitted(["q"])
    assert np.array_equal(engine.splice("q", replay), replay)


# -- observability: failover events on worker tracks --------------------------------


def _failover_events(events):
    return sorted((e["name"], e["args"].get("worker"), e["args"].get("reason"))
                  for e in events if e["name"] in ("failover", "drain", "heartbeat"))


def test_failover_events_render_on_worker_tracks(pair):
    reqs = [_request(i, horizon=5) for i in range(6)]
    recorder = FlightRecorder(ring_size=512)
    cluster, ref = _both(pair, _failover_cfg(route_policy="round_robin"),
                         [WorkerFault("decode-1", "kill", after_dispatches=1)],
                         metrics=Registry(), flight_recorder=recorder)
    cluster.run(reqs)
    jrecorder = ref.flight_recorder
    ref.run([_jreq(r) for r in reqs])
    # a second cluster shares the ring for the drain slice
    drained = _port(pair[2], _failover_cfg(), flight_recorder=recorder)
    drained.run([_request(i, horizon=4) for i in range(2)])
    drained.drain(0)
    jdrained = _ref(pair, _jcfg(_failover_cfg()), flight_recorder=jrecorder)
    jdrained.run([_jreq(_request(i, horizon=4)) for i in range(2)])
    jdrained.drain(0)
    events = recorder.events()
    assert {"failover", "drain"} <= {e["name"] for e in events}
    assert _failover_events(events) == _failover_events(jrecorder.events())
    assert all("worker" in e["args"] for e in events if e["name"] == "failover")

    trace = chrome_trace(events)
    failover = [e for e in trace["traceEvents"] if e.get("cat") == "failover"]
    assert failover
    for event in failover:
        assert event["tid"] >= WORKER_TID_BASE
        if event["name"] == "drain":
            assert event["ph"] == "X"
        elif event["ph"] == "i":
            assert event["s"] == "t"


def test_heartbeat_miss_event_recorded(pair):
    recorder = FlightRecorder(ring_size=64)
    cfg = _failover_cfg(failover=FailoverConfig(heartbeat_interval_s=0.01, miss_threshold=1))
    cluster = _port(pair[2], cfg, flight_recorder=recorder)
    inject_worker_fault(cluster, WorkerFault("decode-0", "hang"))
    cluster.failover.sweep()
    names = [e["name"] for e in recorder.events()]
    assert "heartbeat" in names and "failover" in names
    beat = next(e for e in recorder.events() if e["name"] == "heartbeat")
    assert beat["args"]["worker"] == "decode-0" and beat["args"]["age_s"] > 0
    assert cluster.failover.state("decode-0") == WORKER_DOWN


def test_failover_off_keeps_cluster_fail_stop_and_exposition(pair):
    """Without failover the cluster is fail-stop (a kill propagates) and
    registers no failover series."""
    registry = Registry()
    cluster = _port(pair[2], ClusterConfig(n_decode_workers=2), metrics=registry)
    assert cluster.failover is None
    batcher = cluster.shards[1].batcher
    orig = batcher._tick_chunk

    def killer(*args, **kwargs):
        raise WorkerKilled("decode-1")

    batcher._tick_chunk = killer
    with pytest.raises(WorkerKilled):
        cluster.run([_request(i, horizon=5) for i in range(6)])
    batcher._tick_chunk = orig
    assert "beholder_failover" not in registry.render()


# -- the service's shutdown drain ------------------------------------------------


def test_service_close_drains_the_cluster_like_the_reference(pair):
    """``failover.drain_on_sigterm``: the service's ``close()`` calls
    ``ClusterScheduler.shutdown(drain=True)``: a request queued before it is
    served, every shard ends ``draining``, and a submit racing the shutdown
    sheds ``shard_down`` — on the port as on the reference."""
    import beholder_tpu.config as ref_config
    import beholder_tpu.mq as ref_mq
    import beholder_tpu.service as ref_service
    import beholder_tpu.storage as ref_storage
    import beholder_tpu_torch.config as port_config
    import beholder_tpu_torch.mq as port_mq
    import beholder_tpu_torch.service as port_service
    import beholder_tpu_torch.storage as port_storage

    data = {"keys": {"trello": {"key": "K", "token": "T"}},
            "instance": {"cluster": {"enabled": True, "failover": {"enabled": True}}}}
    cluster, ref = _both(pair, _failover_cfg())
    out, streams = {}, {}
    for name, sched, svc_mod, cfg_mod, mq_mod, st_mod, req, kw in (
            ("port", cluster, port_service, port_config, port_mq, port_storage,
             _request(0, horizon=3), {"device": "cpu"}),
            ("ref", ref, ref_service, ref_config, ref_mq, ref_storage,
             _jreq(_request(0, horizon=3)), {})):
        service = svc_mod.BeholderService(cfg_mod.ConfigNode(data), mq_mod.InMemoryBroker(),
                                          st_mod.MemoryStorage(), **kw)
        assert service.cluster.failover.drain_on_sigterm
        service.cluster_scheduler = sched
        assert sched.submit(req).accepted
        served = []
        run_pending = sched.run_pending
        sched.run_pending = lambda: served.extend(run_pending()) or served
        service.close()
        racing = sched.submit(req)
        streams[name] = served
        out[name] = ([s.intake.depth for s in sched.shards],
                     {s.pool.name: sched.failover.state(s.pool.name) for s in sched.shards},
                     len(served), (racing.accepted, racing.reason))
    assert out["port"] == out["ref"]
    assert out["port"][1] == {"decode-0": "draining", "decode-1": "draining"}
    assert out["port"][2] == 1 and out["port"][3] == (False, "shard_down")
    _bitwise(streams["port"], _single(pair[2]).run([_request(0, horizon=3)]))
    _close(streams["port"], streams["ref"])
    for shard in cluster.shards:
        _pristine(shard.batcher)
