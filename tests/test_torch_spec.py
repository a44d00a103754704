"""The port's speculative decoding (``beholder_tpu_torch.spec``) against the
JAX reference, and the reference's own contracts within the port.

Model: the reference's spec test model, ``dim=32, heads=4, kv_heads=2,
layers=2`` (head dim 8), pages of 8, flax params cast to bf16 for every
leaf with ndim >= 2 and loaded through the weight bridge; inputs from numpy
seeds. Tolerances, with their reasons:

- ``SpecConfig``/``spec_from_config`` fields, n-gram proposals, and the
  host acceptance rules (``greedy_accept``, ``speculative_sample``,
  ``residual_sample``) on the same ``np.random.Generator`` seeds: exactly
  equal — the same numpy code on the same inputs;
- allocator state (page table, lengths, active mask, free stack and top,
  refcounts, ``alloc_failed``): exactly equal — integer bookkeeping;
- verify predictions and batcher streams against the reference:
  ``atol=1e-4``, the serving tests' band (``tests/test_torch_serving.py``):
  the same dtype mix op for op, only f32 summation order differs;
- pool contents against the reference where written: the band of
  ``tests/test_torch_serving.py``'s teacher-forced tick (rtol 2**-7, atol
  1e-3), one bf16 ULP of a kv value, and for quantized pools one
  quantization step (0.05 for int8, as ``tests/test_torch_chunk.py``);
- within the port: spec on == spec off and fused == dense with
  ``np.array_equal`` (the reference's contract, ``tests/test_spec.py:306``,
  and ``tests/test_paged_chunk_kernel.py:446``); against the port's own
  ``forecast_deltas`` 1e-6 (``tests/test_spec.py:330``), against the port's
  ``run()`` rtol 3e-2 / atol 1.5e-2 (``tests/test_spec.py:351``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from beholder_tpu.config import ConfigNode
from beholder_tpu.models import TelemetrySequenceModel as JaxModel
from beholder_tpu.models import serving as jsv
from beholder_tpu.models.sequence import FEATURES
from beholder_tpu.spec import SpecConfig as JaxSpecConfig
from beholder_tpu.spec import drafter as jdr
from beholder_tpu.spec import scheduler as jsched
from beholder_tpu.spec import spec_from_config as jax_spec_from_config
from beholder_tpu.spec import verify as jver
from beholder_tpu_torch.cache import PrefixCache
from beholder_tpu_torch.models import TelemetrySequenceModel, forecast_deltas
from beholder_tpu_torch.models import serving as tsv
from beholder_tpu_torch.models.bridge import load_flax_params
from beholder_tpu_torch.models.serving import ContinuousBatcher, Request
from beholder_tpu_torch.spec import SpecConfig, spec_from_config
from beholder_tpu_torch.spec import drafter as tdr
from beholder_tpu_torch.spec import scheduler as tsched
from beholder_tpu_torch.spec import verify as tver

SIZES = dict(dim=32, heads=4, layers=2, kv_heads=2)
PAGE = 8
CONVERTING, ERRORED = 2, 5
STATE_FIELDS = ("page_table", "seq_lens", "active", "free_stack", "free_top",
                "page_ref", "alloc_failed")
FAMILIES = ["bf16", "int8", "fp8"]


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


def _request(seed, deltas=2 * PAGE, horizon=9):
    rng = np.random.default_rng(seed)
    prog = np.cumsum(1.0 + rng.normal(0, 0.05, deltas + 1))
    return Request(prog, np.full(deltas + 1, CONVERTING), horizon)


def _batcher(tm, spec=None, num_pages=48, slots=2, **kw):
    return ContinuousBatcher(tm, num_pages=num_pages, page_size=PAGE, slots=slots,
                             max_prefix=24, max_pages_per_seq=16, spec=spec,
                             device="cpu", **kw)


def _jax_batcher(jm, params, spec, num_pages=48, slots=2, **kw):
    return jsv.ContinuousBatcher(jm, params, num_pages=num_pages, page_size=PAGE,
                                 slots=slots, max_prefix=24, max_pages_per_seq=16,
                                 spec=spec, **kw)


def _assert_state_equal(js, ts, when):
    for name in STATE_FIELDS:
        np.testing.assert_array_equal(
            getattr(ts, name).numpy(), np.asarray(getattr(js, name)),
            err_msg=f"{name} after {when}",
        )


def _assert_pools_close(js, ts, slots, family, when):
    atol = 0.05 if family == "int8" else 1e-3
    for layer in range(SIZES["layers"]):
        for slot in slots:
            for jc, tc in zip(jsv.slot_cache(js, slot, layer), tsv.slot_cache(ts, slot, layer)):
                np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=2**-7, atol=atol,
                                           err_msg=f"slot {slot} layer {layer} {when}")


def _slot_bytes(state, slot):
    """The raw pool bytes (values, and scales of quantized pools) at each of
    ``slot``'s positions ``< seq_lens[slot]``, every layer, k then v."""
    n = int(state.seq_lens[slot])
    ids = state.page_table[slot].long()
    out = []
    for pool in state.k_pools + state.v_pools:
        parts = (pool.values, pool.scales) if isinstance(pool, tsv.QuantizedPool) else (pool,)
        for part in parts:
            g = part[ids]                                   # (P, ..., page)
            g = g.view(torch.uint8) if g.element_size() == 1 else g
            g = g.movedim(0, -2)                            # (..., P, page)
            out.append(g.reshape(*g.shape[:-2], -1)[..., :n])
    return out


def _admit_pair(jm, params, tm, family, lens=(13, 16), slots=3, num_pages=24):
    """Both sides' pools with slots 0 and 2 admitted (lens 13 and 16: the
    second ends on a page boundary, so the next write opens a page)."""
    js = jsv.init_paged(jm, num_pages, PAGE, slots, 8,
                        cache_dtype=jnp.bfloat16 if family == "bf16" else family)
    ts = tsv.init_paged(tm, num_pages, PAGE, slots, 8, cache_dtype=family)
    feats = np.random.default_rng(0).normal(0, 1, (2, 2 * PAGE, FEATURES)).astype(np.float32)
    lens = np.asarray(lens, np.int32)
    jp, js = jsv.paged_admit_batch(jm, params, js, jnp.asarray([0, 2], jnp.int32),
                                   jnp.asarray(feats), jnp.asarray(lens))
    tp, ts = tsv.paged_admit_batch(tm, ts, torch.tensor([0, 2], dtype=torch.int32),
                                   torch.from_numpy(feats), torch.from_numpy(lens))
    _assert_state_equal(js, ts, "admit")
    return js, ts


def _chunk(seed, slots=3, w=4):
    return np.random.default_rng(seed).normal(0, 1, (slots, w, FEATURES)).astype(np.float32)


# -- config ---------------------------------------------------------------------

CONFIG_CASES = [
    {}, dict(mode="sample", temperature=0.2), dict(mode="sample", temperature=0.0),
    dict(mode="beam"), dict(max_draft=0), dict(min_draft=0), dict(min_draft=5, max_draft=4),
    dict(accept_tol=-1.0), dict(ema=0.0), dict(ema=1.0),
    dict(max_draft=6, min_draft=2, adaptive=False, ema=0.8, seed=7, accept_tol=0.01,
         ngram_max_order=5, ngram_match_tol=0.005, drafter="none"),
]


def _fields_or_error(make, **kw):
    try:
        return dataclasses.asdict(make(**kw))
    except ValueError as e:
        return ("ValueError", str(e))


@pytest.mark.parametrize("kw", CONFIG_CASES, ids=[str(i) for i in range(len(CONFIG_CASES))])
def test_spec_config_accepts_and_refuses_as_the_reference(kw):
    assert _fields_or_error(SpecConfig, **kw) == _fields_or_error(JaxSpecConfig, **kw)


CONFIG_NODES = [
    {},
    {"instance": {"spec": {"enabled": False, "max_draft": 3}}},
    {"instance": {"spec": {"enabled": True}}},
    {"instance": {"spec": {"enabled": True, "max_draft": 3, "accept_tol": 0.01}}},
    {"instance": {"spec": {
        "enabled": True, "mode": "sample", "temperature": 0.2, "accept_tol": 0.01,
        "max_draft": 6, "min_draft": 2, "adaptive": False, "ema": 0.8, "seed": 7,
        "drafter": "model", "ngram": {"max_order": 5, "match_tol": 0.005},
    }}},
    {"instance": {"spec": {"enabled": True, "max_draft": 0}}},
]


@pytest.mark.parametrize("node", CONFIG_NODES, ids=[str(i) for i in range(len(CONFIG_NODES))])
def test_spec_from_config_matches_the_reference(node):
    def parse(fn):
        try:
            cfg = fn(ConfigNode(node))
        except ValueError as e:
            return ("ValueError", str(e))
        return None if cfg is None else dataclasses.asdict(cfg)

    assert parse(spec_from_config) == parse(jax_spec_from_config)


def test_batcher_refuses_anything_but_the_ports_spec_config(pair):
    _, _, tm = pair
    with pytest.raises(TypeError):
        _batcher(tm, spec={"max_draft": 2})
    with pytest.raises(TypeError):
        _batcher(tm, spec=JaxSpecConfig(max_draft=2))
    with pytest.raises(RuntimeError, match="no spec config"):
        _batcher(tm).run_spec([_request(0)])


# -- drafters and host acceptance -------------------------------------------------

NGRAM_KNOBS = [dict(max_order=3), dict(max_order=1), dict(max_order=2, match_tol=0.05),
               dict(max_order=3, repeat_last_fallback=False), dict(max_order=2, scan_window=6)]


@pytest.mark.parametrize("knobs", NGRAM_KNOBS, ids=[str(i) for i in range(len(NGRAM_KNOBS))])
def test_ngram_proposals_equal_the_reference(knobs):
    rng = np.random.default_rng(len(str(knobs)))
    port, ref = tdr.NGramDrafter(**knobs), jdr.NGramDrafter(**knobs)
    histories = [
        np.asarray([1.0, 2.0, 3.0] * 3, np.float32),
        np.asarray([5.0, 7.0, 11.0], np.float32),
        np.asarray([1.0, 2.0, 9.0, 1.01, 2.01], np.float32),
        np.concatenate([[1.0, 2.0, 3.0], np.full(8, 9.0), [1.0, 2.0]]).astype(np.float32),
        np.zeros(0, np.float32),
        np.asarray([4.0], np.float32),
    ]
    for _ in range(20):
        motif = rng.choice([0.9, 1.0, 1.1, 1.2], size=rng.integers(1, 5)).astype(np.float32)
        reps = np.tile(motif, rng.integers(1, 8))
        noise = rng.normal(0, 0.02, rng.integers(0, 12)).astype(np.float32) + 1.0
        histories.append(np.concatenate([noise, reps]).astype(np.float32))
    for hist in histories:
        for k in range(6):
            np.testing.assert_array_equal(port.propose(0, hist, k), ref.propose(0, hist, k))


def test_greedy_accept_equals_the_reference():
    rng = np.random.default_rng(3)
    for _ in range(200):
        k = int(rng.integers(0, 5))
        preds = rng.choice([1.0, 1.004, 2.0, 2.2, 3.0], size=k + 1).astype(np.float32)
        drafts = np.where(rng.random(k) < 0.6, preds[:k],
                          rng.choice([1.0, 1.004, 2.0, np.inf], size=k)).astype(np.float32)
        for tol in (0.0, 0.01, 0.5):
            m, toks = tver.greedy_accept(drafts, preds, tol)
            wm, wtoks = jver.greedy_accept(drafts, preds, tol)
            assert m == wm
            np.testing.assert_array_equal(toks, wtoks)


def test_speculative_sample_is_bitwise_the_reference():
    """Same seeds, same draws: the emitted tokens, the accepted count and
    the generator's state afterwards all equal the reference's."""
    for seed in range(40):
        case = np.random.default_rng(1000 + seed)
        k = int(case.integers(0, 5))
        tau = float(case.choice([0.05, 0.5, 2.0]))
        means = case.normal(0, 1, k).astype(np.float32)
        drafts = (means + tau * case.standard_normal(k)).astype(np.float32)
        preds = (np.concatenate([means, [0.0]]) + case.normal(0, 0.3, k + 1)).astype(np.float32)
        got_rng, want_rng = np.random.default_rng(seed), np.random.default_rng(seed)
        m, toks = tver.speculative_sample(preds, means, drafts, tau, got_rng)
        wm, wtoks = jver.speculative_sample(preds, means, drafts, tau, want_rng)
        assert m == wm
        np.testing.assert_array_equal(toks, wtoks)
        assert got_rng.bit_generator.state == want_rng.bit_generator.state
        got = tver.residual_sample(0.3, 0.3, tau, got_rng, max_tries=4)
        assert got == jver.residual_sample(0.3, 0.3, tau, want_rng, max_tries=4)
    with pytest.raises(ValueError):
        tver.speculative_sample(preds, means, drafts, 0.0, got_rng)


def test_adaptive_controller_tracks_the_reference():
    """The reference's tracking and floor/cap cases, then a random sequence
    of updates against the reference's controller, choice for choice."""
    cfg = dict(max_draft=8, min_draft=1, ema=0.5)
    c = tsched.AdaptiveDraftController(2, SpecConfig(**cfg))
    assert c.choose(0) == 1
    for _ in range(8):
        c.update(0, 4, 4)
    assert c.choose(0) == 8
    for _ in range(8):
        c.update(0, 4, 0)
    assert c.choose(0) == 1
    assert c.choose(1) == 1
    c.update(1, 0, 0)
    assert c.ema[1] == c._init
    c.ema[0] = 0.99
    c.reset(0)
    assert c.choose(0) == 1
    rng = np.random.default_rng(0)
    c = tsched.AdaptiveDraftController(3, SpecConfig(max_draft=6, ema=0.7))
    ref = jsched.AdaptiveDraftController(3, JaxSpecConfig(max_draft=6, ema=0.7))
    for _ in range(100):
        slot, drafted = int(rng.integers(0, 3)), int(rng.integers(0, 6))
        accepted = int(rng.integers(0, drafted + 1))
        c.update(slot, drafted, accepted)
        ref.update(slot, drafted, accepted)
        assert c.choose(slot) == ref.choose(slot)
    # the control-plane cap: shed below the tuned k, reported
    shed = []
    c.k_cap_fn, c.on_k_shed = (lambda: 0), (lambda *a: shed.append(a))
    assert c.choose(0) == 0 and shed


def test_adaptive_controller_disabled_pins_max():
    c = tsched.AdaptiveDraftController(1, SpecConfig(max_draft=5, adaptive=False))
    c.update(0, 5, 0)
    assert c.choose(0) == 5


# -- the device half against the reference ------------------------------------------


@pytest.mark.parametrize("family", FAMILIES)
def test_spec_verify_step_and_rollback_match_jax(pair, family):
    """Two dense verify rounds (slot 1 inactive), each followed by a
    rollback: predictions within atol 1e-4, allocator state exactly the
    reference's after every call, the pools within a ULP (a quantization
    step) where written."""
    jm, params, tm = pair
    js, ts = _admit_pair(jm, params, tm, family)
    verify = jax.jit(lambda p, s, f, a: jver.spec_verify_step(jm, p, s, f, a))
    active = np.array([True, False, True])
    for rnd, new_lens in enumerate(([15, 0, 18], [19, 0, 20])):
        chunk = _chunk(10 + rnd)
        jp, js = verify(params, js, jnp.asarray(chunk), jnp.asarray(active))
        tp, ts = tver.spec_verify_step(tm, ts, torch.from_numpy(chunk), torch.from_numpy(active))
        np.testing.assert_allclose(tp.numpy()[active], np.asarray(jp)[active], rtol=0,
                                   atol=1e-4, err_msg=f"round {rnd}")
        _assert_state_equal(js, ts, f"verify {rnd}")
        _assert_pools_close(js, ts, (0, 2), family, f"verify {rnd}")
        lens = np.asarray(new_lens, np.int32)
        js = jver.paged_rollback(js, jnp.asarray(lens), jnp.asarray(active))
        ts = tver.paged_rollback(ts, torch.from_numpy(lens), torch.from_numpy(active))
        _assert_state_equal(js, ts, f"rollback {rnd}")


@pytest.mark.parametrize("family", FAMILIES)
def test_spec_verify_chunk_and_commit_match_jax(pair, family):
    """The fused half: ``spec_verify_chunk``'s predictions within atol 1e-4
    and its kv chunks within a bf16 ULP; ``spec_commit_step`` (2, 0 and 4
    columns kept) leaves the reference's allocator state exactly and its
    pool values within a ULP (a quantization step); then
    ``spec_verify_commit`` runs one more round the same way."""
    jm, params, tm = pair
    js, ts = _admit_pair(jm, params, tm, family)
    chunk = _chunk(20)
    jp, jkv = jax.jit(lambda p, s, f: jver.spec_verify_chunk(jm, p, s, f))(
        params, js, jnp.asarray(chunk))
    tp, tkv = tver.spec_verify_chunk(tm, ts, torch.from_numpy(chunk))
    np.testing.assert_allclose(tp.numpy()[[0, 2]], np.asarray(jp)[[0, 2]], rtol=0, atol=1e-4)
    for (jk, jv), (tk, tv) in zip(jkv, tkv):
        for j, t in ((jk, tk), (jv, tv)):
            np.testing.assert_allclose(t.float().numpy()[[0, 2]],
                                       np.asarray(j.astype(jnp.float32))[[0, 2]],
                                       rtol=2**-7, atol=2**-7)
    accepts = np.array([2, 0, 4], np.int32)
    active = accepts > 0
    js = jax.jit(jver.spec_commit_step)(js, jkv, jnp.asarray(accepts), jnp.asarray(active))
    ts = tver.spec_commit_step(ts, tkv, torch.from_numpy(accepts), torch.from_numpy(active))
    _assert_state_equal(js, ts, "commit")
    _assert_pools_close(js, ts, (0, 2), family, "commit")
    chunk = _chunk(21)
    accepts = np.array([1, 0, 3], np.int32)
    jp, jkv, js = jax.jit(lambda p, s, f, kv, a: jver.spec_verify_commit(jm, p, s, f, kv, a))(
        params, js, jnp.asarray(chunk), jkv, jnp.asarray(accepts))
    tp, tkv, ts = tver.spec_verify_commit(tm, ts, torch.from_numpy(chunk), tkv,
                                          torch.from_numpy(accepts))
    np.testing.assert_allclose(tp.numpy()[[0, 2]], np.asarray(jp)[[0, 2]], rtol=0, atol=1e-4)
    _assert_state_equal(js, ts, "verify_commit")
    _assert_pools_close(js, ts, (0, 2), family, "verify_commit")


def test_paged_rollback_keeps_fork_and_cache_pages_like_jax(pair):
    """Fork slot 0 into slot 1 (two full pages shared), pin slot 0's first
    page in the prefix cache, then roll back: the fork to its shared prefix
    (only its tail copy frees), slot 0 to inside its first page (the pinned
    page survives at refcount >= 1, its unpinned second page does not).
    State exactly the reference's after every step."""
    jm, params, tm = pair
    js = jsv.init_paged(jm, 16, PAGE, 4, 8)
    ts = tsv.init_paged(tm, 16, PAGE, 4, 8)
    t = 2 * PAGE + 3
    feats = np.random.default_rng(0).normal(size=(1, 3 * PAGE, FEATURES)).astype(np.float32)
    _, js = jsv.paged_admit_batch(jm, params, js, jnp.asarray([0], jnp.int32),
                                  jnp.asarray(feats), jnp.asarray([t], jnp.int32))
    _, ts = tsv.paged_admit_batch(tm, ts, torch.tensor([0], dtype=torch.int32),
                                  torch.from_numpy(feats), torch.tensor([t], dtype=torch.int32))
    free_after_admit = int(ts.free_top)
    js = jsv.paged_fork(js, jnp.int32(0), jnp.asarray([1], jnp.int32))
    ts = tsv.paged_fork(ts, 0, torch.tensor([1], dtype=torch.int32))
    _assert_state_equal(js, ts, "fork")
    shared = ts.page_table[0, :2].numpy()
    pinned = np.zeros(16, np.int32)
    pinned[0] = shared[0]
    alive = np.zeros(16, bool)
    alive[0] = True
    js = jsv.cache_ref_pages(js, jnp.asarray(pinned), jnp.asarray(alive))
    ts = tsv.cache_ref_pages(ts, torch.from_numpy(pinned), torch.from_numpy(alive))
    _assert_state_equal(js, ts, "pin")
    new_lens = np.array([0, 2 * PAGE, 0, 0], np.int32)
    active = np.array([False, True, False, False])
    js = jver.paged_rollback(js, jnp.asarray(new_lens), jnp.asarray(active))
    ts = tver.paged_rollback(ts, torch.from_numpy(new_lens), torch.from_numpy(active))
    _assert_state_equal(js, ts, "fork rollback")
    assert int(ts.free_top) == free_after_admit  # the fork's tail copy came home
    assert int(ts.page_ref[shared[0]]) == 3 and int(ts.page_ref[shared[1]]) == 2
    new_lens = np.array([3, 0, 0, 0], np.int32)
    active = np.array([True, False, False, False])
    js = jver.paged_rollback(js, jnp.asarray(new_lens), jnp.asarray(active))
    ts = tver.paged_rollback(ts, torch.from_numpy(new_lens), torch.from_numpy(active))
    _assert_state_equal(js, ts, "slot 0 rollback")
    # page 0: the fork's, the cache's and slot 0's references; page 1: the
    # fork's; slot 0's tail page freed
    assert int(ts.page_ref[shared[0]]) == 3 and int(ts.page_ref[shared[1]]) == 1
    assert int(ts.free_top) == free_after_admit + 1
    assert int(ts.seq_lens[0]) == 3 and int(ts.seq_lens[1]) == 2 * PAGE


@pytest.mark.parametrize("accept_tol", [0.0, 1e-2], ids=["exact", "tol1e-2"])
@pytest.mark.parametrize("fused", [False, True], ids=["dense", "fused"])
def test_run_spec_matches_the_jax_batcher(pair, fused, accept_tol):
    """``run_spec`` with the n-gram drafter, dense and fused verify, exact
    greedy and the throughput tolerance, over more requests than slots:
    every stream within atol 1e-4 of the reference batcher's; pages home.
    The reference runs eagerly: jitted, XLA keeps excess precision in its
    bf16 fusions and the verify program drifts from flax's op-by-op rounding
    (here by up to 3.8e-3 from the reference's own ``forecast_deltas``, at a
    14-token prefix), while the eager reference and the port agree with it
    to 3e-7."""
    jm, params, tm = pair
    reqs = [_request(i, deltas=12 + 2 * i, horizon=6 + 3 * i) for i in range(4)]
    kw = dict(max_draft=3, accept_tol=accept_tol)
    b = _batcher(tm, spec=SpecConfig(**kw), fused_verify=fused)
    got = b.run_spec(reqs)
    with jax.disable_jit():
        want = _jax_batcher(jm, params, JaxSpecConfig(**kw), fused_verify=fused).run_spec(reqs)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape == (reqs[i].horizon,)
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-4, err_msg=f"request {i}")
    assert int(b.state.free_top) == b.num_pages
    assert b.verify_rounds > 0


# -- the reference's contracts within the port --------------------------------------


class LyingDrafter(tdr.Drafter):
    """Proposes plausible-looking garbage every time."""

    def propose(self, slot, history, k):
        return np.asarray([float(history[-1]) + 0.37 * (i + 1) for i in range(k)], np.float32)


class PerSlotDrafter(tdr.Drafter):
    """Slot 0 drafts nothing (a plain decode in the mixed batch); slot 1
    drafts garbage of full width."""

    def propose(self, slot, history, k):
        if slot == 0:
            return np.zeros(0, np.float32)
        return np.full(k, float(history[-1]) + 1.23, np.float32)


def _spec_off(tm, reqs, fused=False, **kw):
    return _batcher(tm, spec=SpecConfig(max_draft=3, drafter=tdr.NullDrafter()),
                    fused_verify=fused, **kw).run_spec(reqs)


@pytest.mark.parametrize("fused", [False, True], ids=["dense", "fused"])
@pytest.mark.parametrize("drafter", ["ngram", "lying", "mixed", "replay"])
def test_greedy_spec_on_off_streams_identical(pair, drafter, fused, monkeypatch):
    """Under greedy exact acceptance, speculation on (n-gram, a lying
    drafter, a mixed batch of verify chunks and plain decodes, or a drafter
    replaying spec off's own stream, ``chip_smoke.replay_drafter``) emits
    the stream speculation off does, ``np.array_equal``, on a bf16 pool;
    pages come home. The replayed drafts are all accepted (read from a spy
    on ``AdaptiveDraftController.update``), so there every token but the
    first of a round comes from a chunk row past 0."""
    import chip_smoke

    _, _, tm = pair
    reqs = [_request(i, horizon=9) for i in range(3)]
    off = _spec_off(tm, reqs, fused)
    d = {"ngram": "ngram", "lying": LyingDrafter(), "mixed": PerSlotDrafter(),
         "replay": chip_smoke.replay_drafter(reqs, off)}[drafter]
    seen = []
    real = tsched.AdaptiveDraftController.update
    monkeypatch.setattr(tsched.AdaptiveDraftController, "update",
                        lambda self, slot, dr, a: (seen.append((dr, a)), real(self, slot, dr, a)))
    b = _batcher(tm, spec=SpecConfig(max_draft=3, adaptive=False, drafter=d),
                 fused_verify=fused)
    got = b.run_spec(reqs)
    for i in range(len(reqs)):
        np.testing.assert_array_equal(got[i], off[i], err_msg=f"request {i}")
    assert int(b.state.free_top) == b.num_pages
    if drafter == "replay":
        assert sum(a for _, a in seen) == sum(dr for dr, _ in seen) > 0


@pytest.mark.parametrize("family", ["bf16", "int8"])
def test_fused_verify_equals_dense_verify(pair, family):
    """Fused and dense verify serve the same stream bit for bit on CPU
    tensors (the chunk kernel's plain version runs the dense op sequence at
    the dense width; on the card this is a reading, ``ROADMAP.md`` C.4)."""
    _, _, tm = pair
    reqs = [_request(i, deltas=12 + i, horizon=11) for i in range(3)]
    spec = SpecConfig(max_draft=3, accept_tol=1e-2)
    dense = _batcher(tm, spec=spec, cache_dtype=family).run_spec(reqs)
    fused = _batcher(tm, spec=spec, cache_dtype=family, fused_verify=True).run_spec(reqs)
    for i in range(len(reqs)):
        np.testing.assert_array_equal(fused[i], dense[i], err_msg=f"request {i}")


@pytest.mark.parametrize("family", FAMILIES)
def test_fused_half_is_bitwise_the_dense_half(pair, family):
    """On one state, ``spec_verify_chunk``'s predictions are bitwise
    ``spec_verify_step``'s, and committing 3, 0 and 5 columns leaves the
    pool bytes at every committed position and the lengths that
    scatter-then-rollback leaves (the page ids differ: the dense verify pops
    pages for rejected columns too)."""
    jm, params, tm = pair
    _, ts = _admit_pair(jm, params, tm, family)
    _, ts2 = _admit_pair(jm, params, tm, family)
    chunk = torch.from_numpy(_chunk(30, w=5))
    accepts = torch.tensor([3, 0, 5], dtype=torch.int32)
    active = accepts > 0
    fp, kvs = tver.spec_verify_chunk(tm, ts, chunk)
    ts = tver.spec_commit_step(ts, kvs, accepts, active)
    dp, ts2 = tver.spec_verify_step(tm, ts2, chunk, active)
    ts2 = tver.paged_rollback(ts2, ts2.seq_lens - 5 + accepts, active)
    assert torch.equal(fp[active], dp[active])
    for name in ("seq_lens", "free_top"):
        assert torch.equal(getattr(ts, name), getattr(ts2, name)), name
    for slot in (0, 2):
        for a, b in zip(_slot_bytes(ts, slot), _slot_bytes(ts2, slot)):
            assert torch.equal(a, b)


@pytest.mark.parametrize("fused", [False, True], ids=["dense", "fused"])
def test_greedy_spec_matches_forecast_deltas_to_ulp(pair, fused):
    """Against the port's dense oracle (``forecast_deltas``): within 1e-6
    (``tests/test_spec.py:330``); against the port's ``run()`` within the
    serving band (``tests/test_spec.py:351``)."""
    _, _, tm = pair
    reqs = [_request(i, horizon=9) for i in range(3)]
    got = _batcher(tm, spec=SpecConfig(max_draft=3), fused_verify=fused).run_spec(reqs)
    off = _batcher(tm).run(reqs)
    for i, req in enumerate(reqs):
        want = forecast_deltas(tm, torch.from_numpy(req.progress)[None],
                               torch.from_numpy(req.statuses)[None], req.horizon)[0].numpy()
        np.testing.assert_allclose(got[i], want, rtol=1e-6, atol=1e-6, err_msg=f"request {i}")
        np.testing.assert_allclose(got[i], off[i], rtol=3e-2, atol=1.5e-2)


def test_small_model_drafter_same_weights(pair, monkeypatch):
    """A drafter with the target's own weights: the stream equals spec off
    and both pools come home. Acceptance is not total on the port's CPU
    path, as in the reference (``ROADMAP.md`` C.1): drafted and accepted
    counts from a spy on ``AdaptiveDraftController.update`` read 1 accepted
    of 23 drafted. The f32 ``head`` projection's sum over the model width
    runs in another order at one row a slot (the drafter's width-1 step)
    than at four (the verify chunk), so a draft misses the verifier's
    output by an f32 ULP and is rejected. Only the stream is asserted."""
    _, _, tm = pair
    seen = []
    real = tsched.AdaptiveDraftController.update
    monkeypatch.setattr(tsched.AdaptiveDraftController, "update",
                        lambda self, slot, d, a: (seen.append((d, a)), real(self, slot, d, a)))
    drafter = tdr.SmallModelDrafter(tm, num_pages=48, page_size=PAGE, slots=2,
                                    max_pages_per_seq=16, device="cpu")
    b = _batcher(tm, spec=SpecConfig(max_draft=3, drafter=drafter))
    reqs = [_request(i, horizon=10) for i in range(3)]
    off = _spec_off(tm, reqs)
    got = b.run_spec(reqs)
    for i in range(len(reqs)):
        np.testing.assert_array_equal(got[i], off[i])
    assert sum(d for d, _ in seen) > 0
    assert int(b.state.free_top) == b.num_pages
    assert int(drafter.state.free_top) == drafter.num_pages


def test_spec_composes_with_what_if_fork(pair):
    """``run_spec``, ``run_what_if``, ``run_spec`` on one batcher: the two
    spec results are bitwise equal and bitwise a fresh batcher's, within
    atol 1e-4 of the reference's ``run_spec`` run eagerly, and the pages
    come home. Against ``forecast_deltas`` this request holds only the
    serving band (rtol 3e-2 / atol 1.5e-2, ``tests/test_spec.py:351``), not
    1e-6 (``ROADMAP.md`` C.1): the oracle steps one row a slot and the
    verify three, the f32 ``head`` sums the two widths in different orders,
    and the ULP that its third token differs by flips a bf16 rounding in the
    next step; the gap grows to 4.86e-3 at the sixth token. The reference
    run eagerly shows the same gap; run jitted it does not."""
    jm, params, tm = pair
    b = _batcher(tm, spec=SpecConfig(max_draft=2))
    req = _request(11, horizon=6)
    want = forecast_deltas(tm, torch.from_numpy(req.progress)[None],
                           torch.from_numpy(req.statuses)[None], req.horizon)[0].numpy()
    got = b.run_spec([req])
    wi = b.run_what_if(req.progress, req.statuses, [CONVERTING, ERRORED], horizon=5)
    assert wi.shape == (2, 5)
    got2 = b.run_spec([req])
    np.testing.assert_array_equal(got2[0], got[0])
    np.testing.assert_array_equal(got[0], _batcher(tm, spec=SpecConfig(max_draft=2))
                                  .run_spec([req])[0])
    with jax.disable_jit():
        ref = _jax_batcher(jm, params, JaxSpecConfig(max_draft=2)).run_spec([req])[0]
    np.testing.assert_allclose(got[0], ref, rtol=0, atol=1e-4)
    np.testing.assert_allclose(got[0], want, rtol=3e-2, atol=1.5e-2)
    assert int(b.state.free_top) == b.num_pages


def test_horizon_edge_cases(pair):
    _, _, tm = pair
    b = _batcher(tm, spec=SpecConfig(max_draft=2))
    reqs = [_request(0, horizon=0), _request(1, horizon=1), _request(2, horizon=2)]
    got = b.run_spec(reqs)
    assert got[0].shape == (0,)
    for req, g in zip(reqs[1:], got[1:]):
        want = forecast_deltas(tm, torch.from_numpy(req.progress)[None],
                               torch.from_numpy(req.statuses)[None], req.horizon)[0].numpy()
        assert g.shape == (req.horizon,)
        np.testing.assert_allclose(g, want, rtol=1e-6, atol=1e-6)
    assert int(b.state.free_top) == b.num_pages


def test_spec_rollback_never_frees_prefix_cache_pages(pair):
    """A shared-prefix mix through ``run_spec`` with a lying drafter (every
    round rolls back) over a prefix cache: every cached page survives, warm
    replays adopt them, and a full eviction returns the pool to pristine."""
    _, _, tm = pair
    cache = PrefixCache(PAGE)
    b = _batcher(tm, num_pages=64, prefix_cache=cache,
                 spec=SpecConfig(max_draft=3, drafter=LyingDrafter()))
    shared = np.cumsum(1.0 + np.random.default_rng(3).normal(0, 0.05, 2 * PAGE + 1))

    def mk(seed, horizon=8):
        r = np.random.default_rng(50 + seed)
        prog = np.concatenate([shared, shared[-1] + np.cumsum(1.0 + r.normal(0, 0.05, 4))])
        return Request(prog, np.full(len(prog), CONVERTING), horizon)

    reqs = [mk(i) for i in range(4)]
    cold = b.run_spec(reqs)
    assert cache.page_count > 0
    for page_id in cache.page_ids:
        assert int(b.state.page_ref[page_id]) >= 1, f"cached page {page_id} was freed"
    assert int(b.state.free_top) == b.num_pages - cache.page_count
    warm = b.run_spec(reqs)
    assert cache.hits > 0
    for c, w in zip(cold, warm):
        np.testing.assert_allclose(w, c, rtol=5e-2, atol=5e-2)
    assert b._evict_cached(cache.page_count) > 0 and cache.page_count == 0
    assert int(b.state.free_top) == b.num_pages
    assert int(b.state.page_ref.sum()) == 0


def test_allocator_exhaustion_raises_cleanly_and_poisons(pair):
    """An unservable request raises before anything is admitted (the
    batcher still serves afterwards); a failure mid-run (the draft pool
    exhausted mid-draft) poisons the batcher, which then refuses to run."""
    _, _, tm = pair
    b = _batcher(tm, num_pages=4, slots=1, spec=SpecConfig(max_draft=2))
    with pytest.raises(RuntimeError, match="page pool exhausted"):
        b.run_spec([_request(0, deltas=16, horizon=24)])
    assert b.run_spec([_request(1, deltas=8, horizon=3)])[0].shape == (3,)
    drafter = tdr.SmallModelDrafter(tm, num_pages=3, page_size=PAGE, slots=1,
                                    max_pages_per_seq=3, device="cpu")
    b = _batcher(tm, slots=1, spec=SpecConfig(max_draft=3, adaptive=False, drafter=drafter))
    with pytest.raises(RuntimeError, match="draft pool exhausted mid-draft"):
        b.run_spec([_request(2, deltas=2 * PAGE, horizon=16)])
    with pytest.raises(RuntimeError, match="batcher state undefined"):
        b.run_spec([_request(3, horizon=3)])


def test_small_model_drafter_rejects_oversized_prefix(pair):
    _, _, tm = pair
    drafter = tdr.SmallModelDrafter(tm, num_pages=4, page_size=PAGE, slots=2,
                                    max_pages_per_seq=2, device="cpu")
    with pytest.raises(RuntimeError, match="draft pool exhausted"):
        drafter.on_admit(0, np.zeros((3 * PAGE, FEATURES), np.float32), CONVERTING)


def test_spec_entry_points_without_device_need_cuda(pair):
    """``SmallModelDrafter()`` and ``ContinuousBatcher(spec=...)`` without a
    device mean the card, and raise where there is none."""
    _, _, tm = pair
    if torch.cuda.is_available():
        assert tdr.SmallModelDrafter(tm).device.type == "cuda"
        assert ContinuousBatcher(tm, spec=SpecConfig()).device.type == "cuda"
        tm.to("cpu")
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tdr.SmallModelDrafter(tm)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ContinuousBatcher(tm, spec=SpecConfig())


def test_build_drafter_from_config_kinds(pair):
    _, _, tm = pair
    b = _batcher(tm)
    assert isinstance(tsched._build_drafter(b, SpecConfig()), tdr.NGramDrafter)
    assert isinstance(tsched._build_drafter(b, SpecConfig(drafter="none")), tdr.NullDrafter)
    with pytest.raises(ValueError, match="SmallModelDrafter"):
        tsched._build_drafter(b, SpecConfig(drafter="model"))
    with pytest.raises(ValueError, match="unknown drafter"):
        tsched._build_drafter(b, SpecConfig(drafter="beam"))


# -- the chunk kernel's key walk (mirrored from csrc/paged_chunk.cu) ---------------

KTILE = 64


def _chunk_walk(n, w, g, r0, window, page, ctx_len):
    """The key tiles one block of ``csrc/paged_chunk.cu`` (rows ``r0 ..
    r0 + 63`` of a kv head's ``g * w`` (group head, chunk row) rows, slot
    length ``n``) processes: their first positions, as the kernel's
    ``t_first``, ``last_pos`` and ``next_live`` choose them. Also returns
    the committed end ``hi`` and the overlay rows inside ``ctx_len``."""
    r_last = min(r0 + KTILE, g * w) - 1
    jmin, jmax = (r0 % w, r_last % w) if r0 // w == r_last // w else (0, w - 1)
    hi = min(n, ctx_len)
    lo = (max(n - (window - 1), 0) // page) * page if window else 0
    w_valid = max(min(w, ctx_len - n), 0)
    t_first = lo // KTILE
    last_pos = min(n + jmax, max(hi, n + w_valid) - 1)
    n_tiles = last_pos // KTILE - t_first + 1 if last_pos >= t_first * KTILE else 0
    tiles = []
    for t in range(n_tiles):
        base = (t_first + t) * KTILE
        last = base + KTILE - 1
        if base >= hi and (last < n or base >= n + w_valid):
            continue
        if window and last <= n + jmin - window:
            continue
        if base > n + jmax:
            continue
        tiles.append(base)
    return tiles, hi, w_valid


@settings(max_examples=300, deadline=None)
@given(
    n=st.integers(0, 700), w=st.integers(1, 80), g=st.sampled_from([1, 2, 4, 8]),
    window=st.sampled_from([0, 1, 37, 64, 200]), page=st.sampled_from([8, 64, 100, 128]),
    extra=st.integers(-40, 300),
)
def test_chunk_walk_covers_every_live_key_at_its_absolute_tile(n, w, g, window, page, extra):
    """Every key a row may see (committed below ``lens``, or the chunk's own
    rows inside ``ctx_len``; causal; in the window) lies in a tile the
    kernel's block processes, and that tile is the one holding the key's
    absolute position: so a row at position p meets the same keys in the
    same tiles and lanes whatever ``lens`` is (a tile masked for a row is
    a no-op in the online softmax). That is what makes the fused verify's
    spec on == spec off hold on the card."""
    ctx_len = max(n + extra, 1)
    for r0 in range(0, g * w, KTILE):
        tiles, hi, w_valid = _chunk_walk(n, w, g, r0, window, page, ctx_len)
        assert len(set(tiles)) == len(tiles) and all(b % KTILE == 0 for b in tiles)
        for r in range(r0, min(r0 + KTILE, g * w)):
            qp = n + r % w
            for p in range(qp + 1):
                live = (p < hi or n <= p < n + w_valid) and (not window or p > qp - window)
                if live:
                    assert p // KTILE * KTILE in tiles, (r, p, tiles)
