"""The port's prefix cache, prefix-hit admission in the batcher, forks and
what-if forecasts against the JAX reference.

Model: ``dim=32, heads=4, kv_heads=2, layers=2``, flax params (bf16 for
every leaf with ndim >= 2) carried across by ``load_flax_params``; inputs
from numpy seeds. Tolerances, with their reasons:

- hash keys, cache decisions and allocator state (page table, lengths,
  active mask, free stack and top, refcounts, ``alloc_failed``): exactly
  equal — host bookkeeping and integer device state;
- batcher streams, cold and warm, fused or dense: the bands of
  ``tests/test_prefix_cache.py:138-165`` (rtol 3e-2 / atol 1.5e-2 against
  an uncached run; int8 warm against cold 5e-2 / 5e-2, one quantization
  step apart);
- what-if branches against the reference's ``run_what_if``: ``atol=1e-4``
  (the same programs; the paged tick's plain version is bitwise the
  Pallas kernel's interpret mode, so only f32 summation order remains).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from beholder_tpu.cache import PrefixCache as JaxPrefixCache
from beholder_tpu.cache import page_hashes as jax_page_hashes
from beholder_tpu.models import TelemetrySequenceModel as JaxModel
from beholder_tpu.models import serving as jsv
from beholder_tpu.models.sequence import FEATURES
from beholder_tpu_torch.cache import PrefixCache, page_hashes
from beholder_tpu_torch.models import TelemetrySequenceModel
from beholder_tpu_torch.models import serving as tsv
from beholder_tpu_torch.models.bridge import load_flax_params
from beholder_tpu_torch.models.serving import ContinuousBatcher, Request

SIZES = dict(dim=32, heads=4, layers=2, kv_heads=2)
PAGE = 4
CONVERTING, DEPLOYED, ERRORED = 2, 4, 5
STATE_FIELDS = ("page_table", "seq_lens", "active", "free_stack", "free_top",
                "page_ref", "alloc_failed")


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


def _assert_state_equal(js, ts, when):
    for name in STATE_FIELDS:
        np.testing.assert_array_equal(
            getattr(ts, name).numpy(), np.asarray(getattr(js, name)),
            err_msg=f"{name} after {when}",
        )


def _shared_prefix(n_deltas, seed=0):
    rng = np.random.default_rng(seed)
    return np.cumsum(1.0 + rng.normal(0, 0.05, n_deltas + 1))


def _request(prefix, tail_seed, tail_deltas=6, horizon=3):
    rng = np.random.default_rng(10_000 + tail_seed)
    tail = prefix[-1] + np.cumsum(1.0 + rng.normal(0, 0.05, tail_deltas))
    prog = np.concatenate([prefix, tail])
    return Request(prog, np.full(len(prog), CONVERTING), horizon)


def _batcher(tm, cache=None, num_pages=64, slots=4, **kw):
    return ContinuousBatcher(
        tm, num_pages=num_pages, page_size=PAGE, slots=slots, max_prefix=32,
        max_pages_per_seq=16, prefix_cache=cache, device="cpu", **kw,
    )


# -- the radix index, host side -------------------------------------------------


@pytest.mark.parametrize("page_size", [1, 4, 8, 128])
def test_page_hashes_identical_to_the_reference(page_size):
    rows = 3 * page_size + 5
    feats = np.random.default_rng(page_size).normal(size=(rows, FEATURES)).astype(np.float32)
    for t in (0, page_size - 1, 3 * page_size + 1, rows):
        got = page_hashes(feats[:t], page_size)
        assert got == jax_page_hashes(feats[:t], page_size)
        assert len(got) == t // page_size  # full pages only
    # chained: a changed first page changes every key after it
    other = feats.copy()
    other[0, 0] += 1.0
    assert all(a != b for a, b in zip(page_hashes(other, 8), page_hashes(feats, 8)))


def test_lookup_eviction_and_insert_as_the_reference_pins():
    """The cases of ``tests/test_prefix_cache.py:58-114``."""
    pc = PrefixCache(4)
    hs = [b"a", b"b", b"c"]
    pc.insert(hs, [10, 11, 12])
    assert pc.lookup(hs, max_pages=3) == [10, 11, 12]
    assert pc.lookup(hs, max_pages=2) == [10, 11]          # the always-prefill cap
    assert pc.lookup([b"a", b"x", b"c"], max_pages=3) == [10]  # chain breaks
    assert pc.hits == 3 and pc.misses == 0
    assert pc.lookup([b"z"], max_pages=1) == [] and pc.misses == 1

    pc = PrefixCache(4)
    pc.insert([b"a", b"b"], [1, 2])
    pc.insert([b"c"], [3])
    pc.lookup([b"a", b"b"], 2)  # touch the a-chain: c is now LRU
    assert pc.evict(1) == [3]
    assert pc.evict(2) == [2, 1]  # leaf first, then the freed parent
    assert pc.page_count == 0 and pc.evictions == 3

    pc = PrefixCache(4)
    pc.insert([b"a", b"b"], [1, 2])
    pc.acquire([b"a", b"b"])
    assert pc.evict(5) == [] and pc.cold_page_count == 0  # pinned by a live slot
    pc.release([b"a", b"b"])
    assert pc.cold_page_count == 2 and sorted(pc.evict(5)) == [1, 2]

    pc = PrefixCache(4)
    assert pc.insert([b"a", b"b"], [1, 2])[0] == [1, 2]
    assert pc.insert([b"a", b"b"], [7, 8])[0] == []  # duplicates stay the slot's
    assert pc.lookup([b"a", b"b"], 2) == [1, 2] and pc.page_ids == {1, 2}
    with pytest.raises(ValueError):
        PrefixCache(0)


def test_random_operations_match_the_reference_cache():
    """One random script of inserts, lookups, pins, releases and evictions
    on both caches: every return value and counter equal."""
    rng = np.random.default_rng(0)
    ours, ref = PrefixCache(4), JaxPrefixCache(4)
    chains = [[bytes([c, i]) for i in range(1, 5)] for c in range(6)]
    held: list[list[bytes]] = []
    for step in range(400):
        chain = chains[rng.integers(len(chains))][: rng.integers(1, 5)]
        op = rng.integers(5)
        if op == 0:
            ids = [int(x) for x in rng.integers(0, 1000, len(chain))]
            assert ours.insert(chain, ids) == ref.insert(chain, ids), step
        elif op == 1:
            assert ours.lookup(chain, len(chain)) == ref.lookup(chain, len(chain)), step
        elif op == 2:
            hit = ours.lookup(chain, len(chain), record=False)
            assert hit == ref.lookup(chain, len(chain), record=False)
            ours.acquire(chain[: len(hit)])
            ref.acquire(chain[: len(hit)])
            held.append(chain[: len(hit)])
        elif op == 3 and held:
            chain = held.pop(int(rng.integers(len(held))))
            ours.release(chain)
            ref.release(chain)
        else:
            n = int(rng.integers(1, 4))
            assert ours.evict(n) == ref.evict(n), step
        for name in ("hits", "misses", "evictions", "page_count", "cold_page_count",
                     "page_ids"):
            assert getattr(ours, name) == getattr(ref, name), (step, name)


# -- prefix-hit admission and the batcher ---------------------------------------


def _warm_admit_both(pair, cache_dtype, fused):
    """Both sides: admit a 2-page request into slot 0, index and reference
    its pages as the cache does, then admit a prefix hit on them into
    slot 2."""
    jm, params, tm = pair
    js = jsv.init_paged(jm, 24, PAGE, 4, 8,
                        cache_dtype=jnp.bfloat16 if cache_dtype == "bf16" else cache_dtype)
    ts = tsv.init_paged(tm, 24, PAGE, 4, 8, cache_dtype=cache_dtype)
    feats = np.random.default_rng(1).normal(0, 1, (1, 2 * PAGE, FEATURES)).astype(np.float32)
    _, js = jsv.paged_admit_batch(jm, params, js, jnp.zeros((1,), jnp.int32),
                                  jnp.asarray(feats), jnp.full((1,), 2 * PAGE, jnp.int32))
    _, ts = tsv.paged_admit_batch(tm, ts, torch.zeros(1, dtype=torch.int32),
                                  torch.from_numpy(feats),
                                  torch.full((1,), 2 * PAGE, dtype=torch.int32))
    cached = np.array(js.page_table)[0, :2]
    ids = np.zeros(24, np.int32)
    alive = np.zeros(24, bool)
    ids[:2], alive[:2] = cached, True
    js = jsv.cache_ref_pages(js, jnp.asarray(ids), jnp.asarray(alive))
    ts = tsv.cache_ref_pages(ts, torch.from_numpy(ids), torch.from_numpy(alive))
    _assert_state_equal(js, ts, "cache ref")
    suffix = np.random.default_rng(2).normal(0, 1, (1, 2 * PAGE, FEATURES)).astype(np.float32)
    jp, js = jax.jit(lambda p, s, sf: jsv.paged_admit_with_prefix(
        jm, p, s, jnp.int32(2), sf, jnp.int32(6), jnp.asarray(cached), fused=fused,
    ))(params, js, jnp.asarray(suffix))
    tp, ts = tsv.paged_admit_with_prefix(tm, ts, 2, torch.from_numpy(suffix), 6,
                                         torch.from_numpy(cached), fused=fused)
    return (jp, js), (tp, ts), cached, ids, alive


@pytest.mark.parametrize("cache_dtype", ["bf16", "int8", "fp8"])
@pytest.mark.parametrize("fused", [False, True], ids=["dense", "fused"])
def test_warm_prefix_admit_leaves_the_references_allocator_state(pair, cache_dtype, fused):
    """After a warm admit (and after releasing it and evicting the chain),
    table, lengths, active mask, free stack and top, refcounts and the
    flag are exactly the reference's."""
    (jp, js), (tp, ts), cached, ids, alive = _warm_admit_both(pair, cache_dtype, fused)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=0, atol=2e-3)
    _assert_state_equal(js, ts, "warm admit")
    # adopted pages: the admitting slot's, the slot's own and the cache's
    assert [int(r) for r in ts.page_ref[torch.from_numpy(cached)]] == [3, 3]
    js = jsv.paged_release_many(js, jnp.asarray([0, 2], jnp.int32))
    ts = tsv.paged_release_many(ts, torch.tensor([0, 2], dtype=torch.int32))
    _assert_state_equal(js, ts, "release")
    js = jsv.cache_unref_pages(js, jnp.asarray(ids), jnp.asarray(alive))
    ts = tsv.cache_unref_pages(ts, torch.from_numpy(ids), torch.from_numpy(alive))
    _assert_state_equal(js, ts, "eviction")
    assert int(ts.free_top) == 24 and int(ts.page_ref.sum()) == 0


@pytest.mark.parametrize("fused", [False, True], ids=["dense", "fused"])
def test_warm_and_cold_streams_within_the_reference_bands(pair, fused):
    """The cases of ``tests/test_prefix_cache.py:120-146``, with
    ``fused_verify`` off and on: warm passes prefill only the suffixes, and
    cold and warm streams stay in the band of the uncached run; the cache
    makes the reference's decisions."""
    jm, params, tm = pair
    requests = [_request(_shared_prefix(16), s) for s in range(4)]
    reference = _batcher(tm).run(requests)
    pc = PrefixCache(PAGE)
    b = _batcher(tm, pc, fused_verify=fused)
    cold = b.run(requests)
    cold_tokens = pc.prefill_tokens
    assert pc.misses == 4 and pc.hits == 0
    warm = b.run(requests)
    assert pc.hits == 4 and pc.prefill_tokens - cold_tokens < cold_tokens / 2
    for i in range(4):
        np.testing.assert_allclose(cold[i], reference[i], rtol=3e-2, atol=1.5e-2)
        np.testing.assert_allclose(warm[i], reference[i], rtol=3e-2, atol=1.5e-2)
    # the reference batcher with its cache: the same hits, misses and pages
    jpc = JaxPrefixCache(PAGE)
    jb = jsv.ContinuousBatcher(jm, params, num_pages=64, page_size=PAGE, slots=4,
                               max_prefix=32, max_pages_per_seq=16, prefix_cache=jpc,
                               fused_verify=fused)
    jreqs = [jsv.Request(r.progress, r.statuses, r.horizon) for r in requests]
    jcold, jwarm = jb.run(jreqs), jb.run(jreqs)
    for name in ("hits", "misses", "prefill_tokens", "page_count", "page_ids"):
        assert getattr(pc, name) == getattr(jpc, name), name
    _assert_state_equal(jb.state, b.state, "two passes")
    for got, want in zip(cold + warm, jcold + jwarm):
        np.testing.assert_allclose(got, want, rtol=3e-2, atol=1.5e-2)


def test_admission_rounds_count_the_rounds_that_admit(pair):
    """6 requests of one horizon on 4 slots: 4 admit in the first round,
    the other 2 once those retire, in each pass, cold or warm."""
    _, _, tm = pair
    requests = [_request(_shared_prefix(16), s) for s in range(6)]
    pc = PrefixCache(PAGE)
    b = _batcher(tm, pc, fused_verify=True)
    b.run(requests)
    assert b.admission_rounds == 2
    b.run(requests)
    assert b.admission_rounds == 4 and pc.hits > 0


def test_warm_pass_within_the_band_of_cold_under_int8_pools(pair):
    _, _, tm = pair
    requests = [_request(_shared_prefix(16), s) for s in range(3)]
    pc = PrefixCache(PAGE)
    b = _batcher(tm, pc, cache_dtype="int8", fused_verify=True)
    cold = b.run(requests)
    warm = b.run(requests)
    assert pc.hits == 3
    for i in range(3):
        np.testing.assert_allclose(warm[i], cold[i], rtol=5e-2, atol=5e-2)


def test_pool_pressure_evicts_cold_pages_and_serves(pair):
    """``tests/test_prefix_cache.py:183-197``: a pool of 8 where B can only
    be admitted by evicting A's cold chain."""
    _, _, tm = pair
    pc = PrefixCache(PAGE)
    b = _batcher(tm, pc, num_pages=8, slots=1)
    b.run([_request(_shared_prefix(12, seed=1), 0, tail_deltas=0, horizon=3)])
    assert pc.page_count == 3 and pc.cold_page_count == 3
    assert int(b.state.free_top) == 8 - 3
    big = _request(_shared_prefix(18, seed=2), 1, tail_deltas=0, horizon=6)
    reference = _batcher(tm, num_pages=8, slots=1).run([big])
    got = b.run([big])
    assert pc.evictions >= 1
    np.testing.assert_allclose(got[0], reference[0], rtol=3e-2, atol=1.5e-2)
    assert int(b.state.free_top) == 8 - pc.page_count


def test_pressure_never_evicts_the_claiming_requests_own_hit_chain(pair):
    """``tests/test_prefix_cache.py:200-222``: the hit chain is pinned before
    pressure eviction runs, so the warm request keeps its hit."""
    _, _, tm = pair
    pc = PrefixCache(PAGE)
    b = _batcher(tm, pc, num_pages=8, slots=1)
    a = _request(_shared_prefix(12, seed=1), 0, tail_deltas=0, horizon=3)
    other = _request(_shared_prefix(12, seed=2), 1, tail_deltas=0, horizon=3)
    b.run([a])
    b.run([other])
    assert pc.cold_page_count == 6
    hits, evictions = pc.hits, pc.evictions
    b.run([a])  # free = 8 - 6 < need = 4
    assert pc.hits == hits + 1
    assert pc.lookup(pc.hashes(b._prep_np(a)[0]), 2) != []
    assert pc.evictions == evictions
    assert not bool(b.state.alloc_failed)


def test_full_eviction_after_churn_brings_every_page_home(pair):
    """Shared-prefix rounds with retirements, reuse and pressure: the flag
    never trips, pressure never takes a pinned page, and evicting the whole
    cache returns the pool to pristine."""
    _, _, tm = pair
    pc = PrefixCache(PAGE)
    b = _batcher(tm, pc, num_pages=7, slots=2, fused_verify=True)
    evict = b._evict_cached
    pinned_at_eviction = []

    def watched(n):
        pinned_at_eviction.append({k for chain in b._slot_chain for k in chain})
        return evict(n)

    b._evict_cached = watched
    prefixes = [_shared_prefix(8, seed=s) for s in range(3)]
    for round_i in range(4):
        b.run([_request(prefixes[(round_i + j) % 3], j, tail_deltas=2, horizon=2)
               for j in range(3)])
        assert int(b.state.free_top) == 7 - pc.page_count
    assert pc.hits > 0 and pc.evictions > 0 and pinned_at_eviction
    b._evict_cached = evict
    assert b._evict_cached(pc.page_count) > 0 and pc.page_count == 0
    assert int(b.state.free_top) == 7
    assert int(b.state.page_ref.sum()) == 0
    assert not bool(b.state.alloc_failed)


def test_eviction_never_reclaims_pages_shared_with_a_fork(pair):
    """``tests/test_prefix_cache.py:256-326``: a cached chain shared with a
    live fork survives a full eviction at refcount 1 with its content
    intact, and frees only when the fork retires."""
    _, _, tm = pair
    state = tsv.init_paged(tm, 8, PAGE, 3, 4)
    t = 8
    feats = np.random.default_rng(0).normal(size=(1, t, FEATURES)).astype(np.float32)
    _, state = tsv.paged_admit_batch(tm, state, torch.zeros(1, dtype=torch.int32),
                                     torch.from_numpy(feats),
                                     torch.full((1,), t, dtype=torch.int32))
    pages = [int(p) for p in state.page_table[0, : t // PAGE]]
    pc = PrefixCache(PAGE)
    assert pc.insert(page_hashes(feats[0], PAGE), pages)[0] == pages
    state = tsv.cache_ref_pages(state, torch.tensor(pages), torch.ones(2, dtype=torch.bool))
    state = tsv.paged_fork(state, 0, torch.tensor([1], dtype=torch.int32))
    state = tsv.paged_release(state, 0)
    assert [int(state.page_ref[p]) for p in pages] == [2, 2]
    before = tsv.slot_cache(state, 1, 0)
    evicted = pc.evict(len(pages))
    assert sorted(evicted) == sorted(pages)
    free_before = int(state.free_top)
    ids = torch.zeros(8, dtype=torch.int32)
    ids[:2] = torch.tensor(evicted)
    state = tsv.cache_unref_pages(state, ids, torch.arange(8) < 2)
    assert [int(state.page_ref[p]) for p in pages] == [1, 1]
    assert int(state.free_top) == free_before
    assert not set(pages) & set(state.free_stack[: int(state.free_top)].tolist())
    for b_, a_ in zip(before, tsv.slot_cache(state, 1, 0)):
        assert torch.equal(b_, a_)
    state = tsv.paged_release(state, 1)
    assert int(state.free_top) == 8 and not bool(state.alloc_failed)


# -- forks and what-if -----------------------------------------------------------


@pytest.mark.parametrize("cache_dtype", ["bf16", "int8", "fp8"])
@pytest.mark.parametrize("t", [13, 16], ids=["tail", "aligned"])
def test_paged_fork_matches_the_reference(pair, cache_dtype, t):
    """Admit one request, fork it into two slots: allocator state exactly the
    reference's, each fork's cache bitwise the source's (the tail page is a
    copy, values and scales), then teacher-forced ticks stay equal."""
    jm, params, tm = pair
    js = jsv.init_paged(jm, 16, 8, 3, 4,
                        cache_dtype=jnp.bfloat16 if cache_dtype == "bf16" else cache_dtype)
    ts = tsv.init_paged(tm, 16, 8, 3, 4, cache_dtype=cache_dtype)
    feats = np.random.default_rng(t).normal(0, 1, (1, 16, FEATURES)).astype(np.float32)
    _, js = jsv.paged_admit(jm, params, js, jnp.int32(0), jnp.asarray(feats), jnp.int32(t))
    _, ts = tsv.paged_admit(tm, ts, 0, torch.from_numpy(feats), t)
    js = jsv.paged_fork(js, jnp.int32(0), jnp.asarray([1, 2], jnp.int32))
    ts = tsv.paged_fork(ts, 0, torch.tensor([1, 2], dtype=torch.int32))
    _assert_state_equal(js, ts, "fork")
    for layer in range(SIZES["layers"]):
        src = tsv.slot_cache(ts, 0, layer)
        for slot in (1, 2):
            for a, b in zip(src, tsv.slot_cache(ts, slot, layer)):
                assert torch.equal(a, b)
    rng = np.random.default_rng(5)
    for tick in range(3):
        ft = rng.normal(0, 1, (3, FEATURES)).astype(np.float32)
        ft[:] = ft[0]  # every branch sees the same input
        _, js = jsv.paged_decode_tick(jm, params, js, jnp.asarray(ft))
        tp, ts = tsv.paged_decode_tick(tm, ts, torch.from_numpy(ft))
        assert torch.equal(tp[0], tp[1]) and torch.equal(tp[0], tp[2]), tick
    _assert_state_equal(js, ts, "ticks")
    ts = tsv.paged_release_many(ts, torch.tensor([0, 1, 2], dtype=torch.int32))
    assert int(ts.free_top) == 16 and not ts.page_ref.any()


def test_run_what_if_matches_the_reference(pair):
    """``run_what_if`` with three branches against the reference's
    (``tests/test_serving.py:740-776``): branches within ``atol=1e-4``,
    branch 0 (the observed status) the plain forecast, pages home."""
    jm, params, tm = pair
    rng = np.random.default_rng(3)
    prog = np.cumsum(2.0 + rng.normal(0, 0.3, 14))
    stats = np.full(14, CONVERTING)
    branches = [CONVERTING, DEPLOYED, ERRORED]
    geometry = dict(num_pages=16, page_size=8, slots=4, max_prefix=16, max_pages_per_seq=4)
    want = jsv.ContinuousBatcher(jm, params, **geometry).run_what_if(
        prog, stats, branches, horizon=6)
    b = ContinuousBatcher(tm, **geometry, device="cpu")
    got = b.run_what_if(prog, stats, branches, horizon=6)
    assert got.shape == (3, 6) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    assert int(b.state.free_top) == 16 and not bool(b.state.active.any())
    (alone,) = ContinuousBatcher(tm, **geometry, device="cpu").run_waves(
        [Request(prog, stats, 6)])
    np.testing.assert_array_equal(got[0], alone)
    assert not np.allclose(got[0], got[1], atol=1e-4)
    (again,) = b.run_waves([Request(prog, stats, 6)])
    np.testing.assert_array_equal(again, alone)


def test_run_what_if_fails_fast_without_poisoning(pair):
    _, _, tm = pair
    b = ContinuousBatcher(tm, num_pages=4, page_size=8, slots=4, max_prefix=16,
                          max_pages_per_seq=4, device="cpu")
    prog = np.cumsum(np.ones(14))
    stats = np.full(14, CONVERTING)
    with pytest.raises(RuntimeError, match="pool exhausted"):
        b.run_what_if(prog, stats, [0, 1, 2], horizon=10)
    with pytest.raises(ValueError, match="out of range"):
        b.run_what_if(prog, stats, [0, 6], horizon=2)
    with pytest.raises(ValueError, match="at least one observed delta"):
        b.run_what_if(prog[:1], stats[:1], [0], horizon=2)
    with pytest.raises(ValueError, match="branches"):
        b.run_what_if(prog, stats, [0] * 5, horizon=2)
    assert int(b.state.free_top) == 4
    assert b.run_what_if(prog, stats, [0], horizon=2).shape == (1, 2)
