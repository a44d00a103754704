"""The port's paged serving path against the JAX reference.

Model: ``dim=32, heads=4, kv_heads=2, layers=2``, pages of 8, flax params
cast to bf16 for every leaf with ndim >= 2 (as the serving benchmark does),
loaded into the port through the weight bridge. Tolerances, with reasons:

- allocator state (page table, lengths, active mask, free stack and top,
  refcounts, ``alloc_failed``): exactly equal — it is integer bookkeeping;
- teacher-forced tick predictions: ``atol=1e-4``. Both sides run the same
  dtype mix op for op (the plain paged decode version is bitwise the
  Pallas kernel's interpret mode), so only f32 summation order remains;
- the batcher against ``forecast_deltas``: the band of
  ``tests/test_serving.py:161-167`` (first two steps rtol 3e-2 / atol
  1.5e-2; the whole forecast rtol 0.25 / atol 0.05), because the paged
  tick's online softmax reassociates the dense oracle's softmax;
- the port's batcher against JAX's batcher: ``atol=1e-4`` (same programs).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from beholder_tpu.models import TelemetrySequenceModel as JaxModel
from beholder_tpu.models import forecast_deltas as jax_forecast
from beholder_tpu.models.sequence import FEATURES
from beholder_tpu.models import serving as jsv
from beholder_tpu_torch.models import TelemetrySequenceModel
from beholder_tpu_torch.models import serving as tsv
from beholder_tpu_torch.models.bridge import load_flax_params
from beholder_tpu_torch.models.serving import ContinuousBatcher, Request

SIZES = dict(dim=32, heads=4, layers=2, kv_heads=2)
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


def _request(seed, t, horizon):
    rng = np.random.default_rng(seed)
    prog = np.cumsum(2.0 + rng.normal(0, 0.3, t + 1))
    return Request(prog, np.full(t + 1, 2), horizon)


def _assert_state_equal(js, ts, when):
    for name in STATE_FIELDS:
        np.testing.assert_array_equal(
            getattr(ts, name).numpy(), np.asarray(getattr(js, name)),
            err_msg=f"{name} after {when}",
        )


@pytest.mark.parametrize("cache_dtype", ["bf16", "int8", "fp8"])
def test_paged_tick_teacher_forced_matches_jax(pair, cache_dtype):
    """Admit two requests into slots 0 and 2 of three, run 12 ticks with
    preset inputs (crossing page boundaries at 16 and 24), release one
    slot: predictions agree and the allocator state is exactly equal at
    every stage; the pools agree where written."""
    jm, params, tm = pair
    js = jsv.init_paged(jm, 16, 8, 3, 8,
                        cache_dtype=jnp.bfloat16 if cache_dtype == "bf16" else cache_dtype)
    ts = tsv.init_paged(tm, 16, 8, 3, 8, cache_dtype=cache_dtype)
    rng = np.random.default_rng(0)
    feats = rng.normal(0, 1, (2, 16, 7)).astype(np.float32)
    lens = np.array([13, 9], np.int32)
    jp, js = jsv.paged_admit_batch(jm, params, js, jnp.asarray([0, 2], jnp.int32),
                                   jnp.asarray(feats), jnp.asarray(lens))
    tp, ts = tsv.paged_admit_batch(tm, ts, torch.tensor([0, 2], dtype=torch.int32),
                                   torch.from_numpy(feats), torch.from_numpy(lens))
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=0, atol=1e-4)
    _assert_state_equal(js, ts, "admit")
    jax_tick = jax.jit(lambda p, st, f: jsv.paged_decode_tick(jm, p, st, f))
    for tick in range(12):
        ft = rng.normal(0, 1, (3, 7)).astype(np.float32)
        jp, js = jax_tick(params, js, jnp.asarray(ft))
        tp, ts = tsv.paged_decode_tick(tm, ts, torch.from_numpy(ft))
        np.testing.assert_allclose(tp.numpy()[[0, 2]], np.asarray(jp)[[0, 2]],
                                   rtol=0, atol=1e-4, err_msg=f"tick {tick}")
    _assert_state_equal(js, ts, "ticks")
    for layer in range(2):
        for slot in (0, 2):
            jk, jv = jsv.slot_cache(js, slot, layer)
            tk, tv = tsv.slot_cache(ts, slot, layer)
            np.testing.assert_allclose(tk.numpy(), np.asarray(jk), rtol=2**-7, atol=1e-3)
            np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=2**-7, atol=1e-3)
    js = jsv.paged_release(js, jnp.int32(0))
    ts = tsv.paged_release(ts, 0)
    _assert_state_equal(js, ts, "release")


def test_allocator_flags_pool_exhaustion_like_jax(pair):
    """Admitting more pages than the pool holds trips the sticky flag on
    both sides, with the same bookkeeping."""
    jm, params, tm = pair
    js = jsv.init_paged(jm, 3, 8, 2, 4)
    ts = tsv.init_paged(tm, 3, 8, 2, 4)
    feats = np.random.default_rng(1).normal(0, 1, (2, 16, 7)).astype(np.float32)
    lens = np.array([16, 9], np.int32)
    _, js = jsv.paged_admit_batch(jm, params, js, jnp.asarray([0, 1], jnp.int32),
                                  jnp.asarray(feats), jnp.asarray(lens))
    _, ts = tsv.paged_admit_batch(tm, ts, torch.tensor([0, 1], dtype=torch.int32),
                                  torch.from_numpy(feats), torch.from_numpy(lens))
    assert bool(ts.alloc_failed) and bool(js.alloc_failed)
    _assert_state_equal(js, ts, "over-admission")


# two prefix lengths and mixed horizons: more requests than slots, page
# crossings, and only two JAX forecast programs to compile
REQUESTS = [(0, 24, 5), (1, 9, 12), (2, 24, 3), (3, 9, 8), (4, 24, 10)]


@pytest.fixture(scope="module")
def forecasts(pair):
    """JAX ``forecast_deltas`` per request (the serving oracle), batched
    per prefix length at the longest horizon and cut to each request's."""
    jm, params, _ = pair
    out = {}
    for t in {t for _, t, _ in REQUESTS}:
        members = [(i, s, h) for i, (s, tt, h) in enumerate(REQUESTS) if tt == t]
        reqs = [_request(s, t, h) for _, s, h in members]
        deltas = np.asarray(jax_forecast(
            jm, params, jnp.asarray(np.stack([r.progress for r in reqs])),
            jnp.asarray(np.stack([r.statuses for r in reqs])),
            max(h for *_, h in members),
        ), np.float32)
        for row, (i, _, h) in zip(deltas, members):
            out[i] = row[:h]
    return [out[i] for i in range(len(REQUESTS))]


@pytest.mark.parametrize("mode", ["run", "run_waves"])
def test_batcher_matches_jax_forecast(pair, forecasts, mode):
    """More requests than slots, mixed lengths and horizons: forecasts track
    JAX's dense forecast and every page comes home."""
    _, _, tm = pair
    requests = [_request(*r) for r in REQUESTS]
    b = ContinuousBatcher(tm, num_pages=24, page_size=8, slots=2, max_prefix=32,
                          max_pages_per_seq=8, device="cpu")
    results = getattr(b, mode)(requests)
    for i, want in enumerate(forecasts):
        assert results[i].shape == want.shape
        np.testing.assert_allclose(results[i][:2], want[:2], rtol=3e-2, atol=1.5e-2,
                                   err_msg=f"request {i}")
        np.testing.assert_allclose(results[i], want, rtol=0.25, atol=0.05,
                                   err_msg=f"request {i}")
    assert int(b.state.free_top) == 24
    assert not bool(b.state.active.any())
    assert not bool(b.state.alloc_failed)


#: an MQA model: 32 query heads over one kv head of width 4. On the card its
#: decode ticks run the decode kernel's group in two chunks of 16 heads and
#: its prefix admissions the chunk kernel at head dim 4 (instantiated at 8)
MQA_SIZES = dict(dim=128, heads=32, kv_heads=1, layers=2)


@pytest.fixture(scope="module")
def mqa_pair():
    jm = JaxModel(**MQA_SIZES)
    init = jm.init(jax.random.PRNGKey(1), jnp.zeros((1, 16, FEATURES)))["params"]
    params = jax.tree.map(
        lambda x: x.astype(jnp.bfloat16) if x.ndim >= 2 else x, {"params": init}
    )
    tm = TelemetrySequenceModel(**MQA_SIZES, device="cpu")
    load_flax_params(tm, jax.tree.map(np.asarray, params))
    return jm, params, tm


@pytest.mark.parametrize("mode", ["run", "run_waves"])
def test_mqa_group_of_32_matches_the_reference(mqa_pair, mode):
    """The MQA model (``dim=128, heads=32, kv_heads=1``) through ``run`` and
    ``run_waves`` (the port on one torch thread) against JAX's
    ``forecast_deltas`` and against the reference's own batcher (``run``)
    on the same requests, both in the serving band (first two steps rtol
    3e-2, atol 1.5e-2; the whole forecast rtol 0.25, atol 0.05): at width
    128 the two frameworks' bf16 CPU products sum in other orders and part
    by a few 1e-3 after a tick (measured 5e-3); every page comes home."""
    jm, params, tm = mqa_pair
    requests = [_request(*r) for r in REQUESTS[:3]]
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        b = ContinuousBatcher(tm, num_pages=24, page_size=8, slots=2, max_prefix=32,
                              max_pages_per_seq=8, device="cpu")
        got = getattr(b, mode)(requests)
    finally:
        torch.set_num_threads(threads)
    batcher = jsv.ContinuousBatcher(jm, params, num_pages=24, page_size=8, slots=2,
                                    max_prefix=32, max_pages_per_seq=8)
    want = batcher.run([jsv.Request(r.progress, r.statuses, r.horizon) for r in requests])
    for i, (g, w, r) in enumerate(zip(got, want, requests)):
        oracle = np.asarray(jax_forecast(jm, params, jnp.asarray(r.progress[None]),
                                         jnp.asarray(r.statuses[None]), r.horizon),
                            np.float32)[0]
        assert g.shape == w.shape == oracle.shape
        np.testing.assert_allclose(g[:2], oracle[:2], rtol=3e-2, atol=1.5e-2,
                                   err_msg=f"request {i}")
        np.testing.assert_allclose(g, oracle, rtol=0.25, atol=0.05, err_msg=f"request {i}")
        np.testing.assert_allclose(g[:2], w[:2], rtol=3e-2, atol=1.5e-2, err_msg=f"request {i}")
        np.testing.assert_allclose(g, w, rtol=0.25, atol=0.05, err_msg=f"request {i}")
    assert int(b.state.free_top) == 24
    assert not bool(b.state.alloc_failed)


def test_run_waves_device_results_and_tick_count(pair):
    _, _, tm = pair
    requests = [_request(*r) for r in REQUESTS] + [_request(5, 7, 0)]
    b = ContinuousBatcher(tm, num_pages=24, page_size=8, slots=2, max_prefix=32,
                          max_pages_per_seq=8, device="cpu")
    got = b.run_waves(requests, device_results=True)
    want = ContinuousBatcher(tm, num_pages=24, page_size=8, slots=2, max_prefix=32,
                             max_pages_per_seq=8, device="cpu").run_waves(requests)
    for g, w in zip(got, want):
        assert torch.is_tensor(g) or g.shape == (0,)
        np.testing.assert_array_equal(np.asarray(g), w)
    # waves of two: horizons (5, 12), (3, 8), (10): 11 + 7 + 9 ticks
    assert b.ticks == 27
    assert int(b.state.free_top) == 24


def test_batcher_matches_jax_batcher_directly(pair):
    """A tiny JAX ``ContinuousBatcher.run`` (2 slots, 3 requests) against
    the port's: the same scheduling, the same programs."""
    jm, params, tm = pair
    requests = [_request(*r) for r in REQUESTS[:3]]
    want = jsv.ContinuousBatcher(
        jm, params, num_pages=24, page_size=8, slots=2, max_prefix=32,
        max_pages_per_seq=8,
    ).run([jsv.Request(r.progress, r.statuses, r.horizon) for r in requests])
    got = ContinuousBatcher(tm, num_pages=24, page_size=8, slots=2, max_prefix=32,
                            max_pages_per_seq=8, device="cpu").run(requests)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-4)


def test_run_defers_admission_under_pool_pressure(pair, forecasts):
    """Three-page requests in a four-page pool serialise through two slots
    (the reference's deferral rule) and still forecast right."""
    _, _, tm = pair
    requests = [_request(3, 17, 8)] * 3
    b = ContinuousBatcher(tm, num_pages=4, page_size=8, slots=2, max_prefix=32,
                          max_pages_per_seq=4, device="cpu")
    results = b.run(requests)
    first = b.run(requests[:1])[0]
    for r in results:
        np.testing.assert_array_equal(r, first)
    assert int(b.state.free_top) == 4
    with pytest.raises(RuntimeError):
        b.run([_request(0, 30, 8)])


def test_batcher_without_device_needs_cuda(pair):
    _, _, tm = pair
    if torch.cuda.is_available():
        assert ContinuousBatcher(tm).device.type == "cuda"
        tm.to("cpu")
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ContinuousBatcher(tm)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TelemetrySequenceModel(**SIZES)


@pytest.mark.parametrize("valid_mask", [[1, 0, 1, 0, 0], [0, 0, 0, 0, 0], [0, 1, 1, 1, 1]],
                         ids=["mixed", "none-valid", "first-dropped"])
def test_masked_writes_drop_like_jax(valid_mask):
    """The port's drop-mode scatters against ``.at[].set(mode="drop")``:
    dropped entries (pointing out of range, or at rows a valid entry also
    writes) leave no trace."""
    from beholder_tpu_torch.models.sequence import index_put_dropping_

    rng = np.random.default_rng(sum(valid_mask))
    dst = rng.normal(0, 1, (6, 3, 4)).astype(np.float32)
    rows = np.array([4, 6, 1, 9, 4], np.int32)          # distinct valid targets
    cols = np.array([2, 0, 3, 1, 2], np.int32)
    keep = np.array(valid_mask, bool)
    rows[~keep] = np.where(rng.random((~keep).sum()) < 0.5, 6, rows[~keep])
    valid = keep & (rows < 6)  # what callers pass: in range and kept
    vals = rng.normal(0, 1, (5, 3)).astype(np.float32)
    # (N, H, page) pool indexed at (page, :, offset) like a kv-column write
    want = jnp.asarray(dst).at[jnp.asarray(np.where(valid, rows, 6)), :,
                               jnp.asarray(cols)].set(jnp.asarray(vals), mode="drop")
    got = torch.from_numpy(dst.copy())
    index_put_dropping_(got.permute(0, 2, 1), (torch.from_numpy(rows), torch.from_numpy(cols)),
                        torch.from_numpy(vals), torch.from_numpy(valid))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    small = torch.arange(6, dtype=torch.int32)
    got_small = tsv._scatter_small(small, torch.from_numpy(rows), torch.arange(5) + 10,
                                   torch.from_numpy(valid))
    want_small = jnp.arange(6, dtype=jnp.int32).at[jnp.asarray(np.where(valid, rows, 6))].set(
        jnp.arange(5, dtype=jnp.int32) + 10, mode="drop")
    np.testing.assert_array_equal(got_small.numpy(), np.asarray(want_small))
