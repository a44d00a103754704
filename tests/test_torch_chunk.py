"""The port's paged chunk attention, the fused ``Block`` branch and the
fused admission lanes against the JAX reference, and fused == dense
inside the port.

Inputs are made with numpy from a seed and handed to both frameworks; the
JAX side runs as its own tests run it on the CPU (``_chunk_reference``, or
the Pallas body in interpret mode with ``FORCE_PALLAS_INTERPRET``). Model:
``dim=32, heads=4, kv_heads=2, layers=2``, pages of 8, flax params (bf16
for every leaf with ndim >= 2) carried across by ``load_flax_params``.
Tolerances, with their reasons:

- the plain chunk version against the JAX kernel: one bf16 ULP of the
  output (``rtol=2**-7``). The assembled context and the bf16 scores are
  bitwise the reference's (checked below), but XLA's CPU ``exp`` and
  torch's differ in the last f32 bit (measured), which now and then flips
  the bf16 rounding of one softmax weight;
- fused against dense inside the port: bitwise. Both run one op sequence
  (``ops.attention.attend``) over the same values at the same width;
- the ``Block`` chunk branch and the fused admits against JAX:
  ``atol=2e-3`` on predictions of size ~1-3, the model band of
  ``tests/test_torch_models.py``; allocator state exactly equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from beholder_tpu.models import TelemetrySequenceModel as JaxModel
from beholder_tpu.models import serving as jsv
from beholder_tpu.models.sequence import FEATURES
from beholder_tpu.ops import paged_attention as jpa
from beholder_tpu.ops import quant as jq
from beholder_tpu_torch.models import TelemetrySequenceModel
from beholder_tpu_torch.models import serving as tsv
from beholder_tpu_torch.models.bridge import load_flax_params
from beholder_tpu_torch.models.serving import ContinuousBatcher, Request
from beholder_tpu_torch.ops import paged_attention as tpa
from beholder_tpu_torch.ops import quant as tq

SIZES = dict(dim=32, heads=4, layers=2, kv_heads=2)
PAGE = 8
ULP = 2**-7  # one bf16 ULP, relative
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


def _bf16(x: np.ndarray):
    """The same bf16 values on both sides."""
    j = jnp.asarray(x, jnp.bfloat16)
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).bfloat16()


def _chunk_inputs(seed, family, *, slots=4, hkv=2, g=2, w=4, dh=8, p=8, n=32,
                  max_len=None):
    """(jax args, torch args, table, lens): q, chunk k/v, pools, scales."""
    rng = np.random.default_rng(seed)
    h = hkv * g
    (qj, qt), (kcj, kct), (vcj, vct) = (
        _bf16(rng.normal(0, 1, shape)) for shape in
        ((slots, h, w, dh), (slots, hkv, w, dh), (slots, hkv, w, dh))
    )
    k = rng.normal(0, 1, (n, hkv, dh, PAGE)).astype(np.float32)
    v = rng.normal(0, 1, (n, hkv, dh, PAGE)).astype(np.float32)
    table = rng.integers(0, n, (slots, p)).astype(np.int32)
    lens = rng.integers(0, (max_len or p * PAGE - w) + 1, (slots,)).astype(np.int32)
    lens[0] = 0  # an empty context: the chunk attends itself only
    if family == "bf16":
        (kj, kt), (vj, vt) = _bf16(k), _bf16(v)
        return (qj, kcj, vcj, kj, vj, None, None), (qt, kct, vct, kt, vt, None, None), table, lens
    jfn = jq.quantize_symmetric if family == "int8" else jq.quantize_fp8_block
    tfn = tq.quantize_symmetric if family == "int8" else tq.quantize_fp8_block
    kj, ksj = jfn(jnp.asarray(k), -2)
    vj, vsj = jfn(jnp.asarray(v), -2)
    kt, kst = tfn(torch.from_numpy(k), -2)
    vt, vst = tfn(torch.from_numpy(v), -2)
    return (qj, kcj, vcj, kj, vj, ksj, vsj), (qt, kct, vct, kt, vt, kst, vst), table, lens


def _run_both(family, seed=0, window=None, ctx_extra=0, live_pages=None, max_len=None):
    J, T, table, lens = _chunk_inputs(seed, family, max_len=max_len)
    kw = dict(window=window, ctx_len=table.shape[1] * PAGE + ctx_extra, live_pages=live_pages)
    want = jpa.paged_chunk_attention(
        *J[:5], jnp.asarray(table), jnp.asarray(lens), k_scale=J[5], v_scale=J[6], **kw
    )
    got = tpa.paged_chunk_attention(
        *T[:5], torch.from_numpy(table), torch.from_numpy(lens), k_scale=T[5], v_scale=T[6],
        **kw,
    )
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == tuple(want.shape)
    return got.float().numpy(), np.asarray(want.astype(jnp.float32))


@pytest.mark.parametrize("family", ["bf16", "int8", "fp8"])
@pytest.mark.parametrize(
    "window,ctx_extra,live_pages,max_len",
    [(None, 0, None, None), (11, 0, None, None), (None, 4, None, None),
     (11, 4, None, None), (None, 0, 5, 5 * PAGE - 4), (None, 4, 3, None)],
    ids=["full", "window", "ctx+W", "window-ctx+W", "live<P", "live<P-past-len"],
)
def test_chunk_plain_matches_jax_reference(family, window, ctx_extra, live_pages, max_len):
    """Random tables and per-row offsets, at ``ctx_len = P*page`` (spec
    verify's width) and ``P*page + W`` (prefix admission's), with a
    window, and with ``live_pages < P``: both when every committed page is
    live (a traffic-only bound) and when lengths run past the live pages
    (those positions are zeros in the reference's assembly)."""
    got, want = _run_both(family, window=window, ctx_extra=ctx_extra,
                          live_pages=live_pages, max_len=max_len)
    np.testing.assert_allclose(got, want, rtol=ULP, atol=0)
    assert (got != want).mean() < 0.02  # all but a few weights round alike


@pytest.mark.parametrize("family", ["bf16", "int8", "fp8"])
@pytest.mark.parametrize("window", [None, 11], ids=["full", "window"])
def test_chunk_plain_matches_pallas_interpret(monkeypatch, family, window):
    """The Pallas body itself (interpret mode), as
    ``tests/test_paged_chunk_kernel.py`` runs it."""
    monkeypatch.setattr(jpa, "FORCE_PALLAS_INTERPRET", True)
    got, want = _run_both(family, seed=7, window=window)
    np.testing.assert_allclose(got, want, rtol=ULP, atol=0)


#: head dim 128 (the served dim 512 over 4 heads): a fused wave (every slot
#: empty, the chunk attends itself, ``ctx_len`` the chunk's width) and a
#: warm prefix admit (one slot, a suffix over cached pages)
D128_SHAPES = {
    "wave": dict(slots=4, hkv=2, g=2, w=16, p=1, lens=[0, 0, 0, 0], ctx_extra=8),
    "warm": dict(slots=1, hkv=2, g=2, w=8, p=3, lens=[16], ctx_extra=8),
}


@pytest.mark.parametrize("family", ["bf16", "int8", "fp8"])
@pytest.mark.parametrize("shape", list(D128_SHAPES))
def test_chunk_plain_matches_jax_reference_at_head_dim_128(family, shape):
    """The plain chunk version at head dim 128 against the JAX reference,
    at a wave-like and a warm-like shape, for every pool family; the band
    of the other head dims."""
    c = D128_SHAPES[shape]
    J, T, table, _ = _chunk_inputs(5, family, slots=c["slots"], hkv=c["hkv"], g=c["g"],
                                   w=c["w"], dh=128, p=c["p"], max_len=c["p"] * PAGE)
    lens = np.asarray(c["lens"], np.int32)
    kw = dict(ctx_len=c["p"] * PAGE + c["ctx_extra"])
    want = jpa.paged_chunk_attention(
        *J[:5], jnp.asarray(table), jnp.asarray(lens), k_scale=J[5], v_scale=J[6], **kw
    )
    got = tpa.paged_chunk_attention(
        *T[:5], torch.from_numpy(table), torch.from_numpy(lens), k_scale=T[5], v_scale=T[6],
        **kw,
    )
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == tuple(want.shape)
    got, want = got.float().numpy(), np.asarray(want.astype(jnp.float32))
    np.testing.assert_allclose(got, want, rtol=ULP, atol=0)
    assert (got != want).mean() < 0.02  # all but a few weights round alike


def test_chunk_scores_and_context_are_bitwise_the_references(monkeypatch):
    """The part of the op sequence before the softmax (assembly, overlay,
    bf16 score product, f32 division) gives the reference's bits."""
    J, T, table, lens = _chunk_inputs(3, "int8")
    qj, kcj, vcj, kj, vj, ksj, vsj = J
    qt, kct, vct, kt, vt, kst, vst = T
    s, h, w, dh = qj.shape
    ctx = table.shape[1] * PAGE
    # the reference's assembly and overlay (its _chunk_reference, inlined)
    g = (kj[jnp.asarray(table)].astype(jnp.float32)
         * jq.pool_scales_f32(ksj[jnp.asarray(table)])[:, :, :, None, :]).astype(jnp.bfloat16)
    kall = g.transpose(0, 2, 1, 4, 3).reshape(s, 2, ctx, dh)
    pos_w = jnp.asarray(lens)[:, None] + jnp.arange(w)
    kall = kall.at[jnp.arange(s)[:, None], :, pos_w, :].set(
        kcj.transpose(0, 2, 1, 3), mode="drop")
    want = jnp.einsum("bhgqd,bhkd->bhgqk", qj.reshape(s, 2, 2, w, dh), kall) / jnp.sqrt(
        jnp.float32(dh))
    # the port's: the plain version's context through attend's first steps
    t_lens = torch.from_numpy(lens)
    got_ctx = {}

    def spy(q, k, v, live):
        got_ctx["k"] = k
        return torch.zeros(1)

    monkeypatch.setattr(tpa, "attend", spy)
    tpa.paged_chunk_reference(qt, kct, vct, kt, vt, torch.from_numpy(table), t_lens,
                              ctx_len=ctx, live_pages=table.shape[1],
                              k_scale=kst, v_scale=vst)
    np.testing.assert_array_equal(got_ctx["k"].float().numpy(),
                                  np.asarray(kall.astype(jnp.float32)))
    got = torch.matmul(qt.reshape(s, 2, 2, w, dh), got_ctx["k"].unsqueeze(2).transpose(-1, -2))
    got = got.float() / torch.sqrt(torch.tensor(float(dh)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_chunk_validates_like_the_reference():
    """The reference's errors (``tests/test_paged_chunk_kernel.py:320``).
    ``group`` names a group-parallel member's call: it changes nothing the
    launch computes (the reference keys autotuned block sizes on it), so a
    member's result is the plain call's, and a group below 1 is refused."""
    _, (q, kc, vc, kp, vp, _, _), table, lens = _chunk_inputs(0, "bf16")
    t, ln = torch.from_numpy(table), torch.from_numpy(lens)
    with pytest.raises(ValueError, match="slots, heads"):
        tpa.paged_chunk_attention(q[0], kc, vc, kp, vp, t, ln)
    with pytest.raises(ValueError, match="k_chunk"):
        tpa.paged_chunk_attention(q, kc[:, :, :1], vc, kp, vp, t, ln)
    with pytest.raises(ValueError, match="given together"):
        tpa.paged_chunk_attention(q, kc, vc, kp, vp, t, ln, k_scale=torch.ones(32, 2, PAGE))
    with pytest.raises(ValueError, match="ctx_len"):
        tpa.paged_chunk_attention(q, kc, vc, kp, vp, t, ln, ctx_len=PAGE)
    with pytest.raises(ValueError, match="live_pages"):
        tpa.paged_chunk_attention(q, kc, vc, kp, vp, t, ln, live_pages=99)
    with pytest.raises(ValueError, match="window"):
        tpa.paged_chunk_attention(q, kc, vc, kp, vp, t, ln, window=0)
    want = tpa.paged_chunk_attention(q, kc, vc, kp, vp, t, ln)
    assert torch.equal(tpa.paged_chunk_attention(q, kc, vc, kp, vp, t, ln, group=2), want)
    with pytest.raises(ValueError, match="group"):
        tpa.paged_chunk_attention(q, kc, vc, kp, vp, t, ln, group=0)


@pytest.mark.parametrize(
    "bad,error",
    [("q_f32", TypeError), ("table_i64", TypeError), ("scales_for_bf16", TypeError),
     ("int8_without_scales", TypeError), ("f16_scales", TypeError),
     ("slot_count", ValueError), ("strided", ValueError), ("pool_dtypes", TypeError)],
)
def test_kernel_input_checks(bad, error):
    """What both CUDA wrappers check before they build or launch (the
    checks run on any tensor, so they are exercised here on the CPU)."""
    _, (q, kc, vc, kp, vp, _, _), table, lens = _chunk_inputs(2, "bf16")
    _, (_, _, _, k8, v8, ks, vs), _, _ = _chunk_inputs(2, "int8")
    t, ln = torch.from_numpy(table), torch.from_numpy(lens)
    args = dict(bf16_inputs={"q": q, "k_chunk": kc, "v_chunk": vc}, k_pool=kp, v_pool=vp,
                page_table=t, lens=ln, k_scale=None, v_scale=None, kernel="paged chunk")
    assert tpa._kernel_mode(**args) == 0
    assert tpa._kernel_mode(**{**args, "k_pool": k8, "v_pool": v8, "k_scale": ks,
                               "v_scale": vs}) == 1
    broken = {
        "q_f32": {"bf16_inputs": {"q": q.float()}},
        "table_i64": {"page_table": t.long()},
        "scales_for_bf16": {"k_scale": ks, "v_scale": vs},
        "int8_without_scales": {"k_pool": k8, "v_pool": v8},
        "f16_scales": {"k_pool": k8, "v_pool": v8, "k_scale": ks.half(), "v_scale": vs.half()},
        "slot_count": {"lens": ln[:2]},
        "strided": {"bf16_inputs": {"q": q.transpose(1, 2)}},
        "pool_dtypes": {"v_pool": v8},
    }[bad]
    with pytest.raises(error):
        tpa._kernel_mode(**{**args, **broken})


def test_cpu_tensors_never_launch_the_chunk_kernel():
    _, (q, kc, vc, kp, vp, _, _), table, lens = _chunk_inputs(1, "bf16")
    t, ln = torch.from_numpy(table), torch.from_numpy(lens)
    before = tpa.paged_chunk_attention.launches
    got = tpa.paged_chunk_attention(q, kc, vc, kp, vp, t, ln)
    want = tpa.paged_chunk_reference(q, kc, vc, kp, vp, t, ln,
                                     ctx_len=table.shape[1] * PAGE, live_pages=table.shape[1])
    assert torch.equal(got, want)
    assert tpa.paged_chunk_attention.launches == before


# -- the model's chunk branch and the fused lanes ------------------------------


def _admitted(jm, params, tm, cache_dtype, slots=4, t=2 * PAGE):
    """Both sides' pools with one request of ``t`` tokens admitted in slot 0."""
    js = jsv.init_paged(jm, 24, PAGE, slots, 8,
                        cache_dtype=jnp.bfloat16 if cache_dtype == "bf16" else cache_dtype)
    ts = tsv.init_paged(tm, 24, PAGE, slots, 8, cache_dtype=cache_dtype)
    feats = np.random.default_rng(0).normal(0, 1, (1, t, FEATURES)).astype(np.float32)
    _, js = jsv.paged_admit_batch(jm, params, js, jnp.zeros((1,), jnp.int32),
                                  jnp.asarray(feats), jnp.full((1,), t, jnp.int32))
    _, ts = tsv.paged_admit_batch(tm, ts, torch.zeros(1, dtype=torch.int32),
                                  torch.from_numpy(feats), torch.full((1,), t, dtype=torch.int32))
    return js, ts


@pytest.mark.parametrize("cache_dtype", ["bf16", "int8", "fp8"])
def test_block_chunk_branch_matches_jax(pair, cache_dtype):
    """The model forward with a ``ChunkPagedInfo`` index: predictions in the
    model band, the chunk's own kv columns back (no pool write)."""
    jm, params, tm = pair
    js, ts = _admitted(jm, params, tm, cache_dtype)
    x = np.random.default_rng(4).normal(0, 1, (1, PAGE, FEATURES)).astype(np.float32)
    table = np.array(js.page_table)[:1, :2]
    info_j = jpa.ChunkPagedInfo(jnp.asarray(table), jnp.full((1,), 2 * PAGE, jnp.int32),
                                3 * PAGE)
    info_t = tpa.ChunkPagedInfo(torch.from_numpy(table), torch.full((1,), 2 * PAGE,
                                dtype=torch.int32), 3 * PAGE)
    want, want_kv = jm.apply(params, jnp.asarray(x), cache=(js.k_pools, js.v_pools, info_j))
    pool = ts.k_pools[0].values if cache_dtype != "bf16" else ts.k_pools[0]
    before = pool.clone()
    got, got_kv = tm(torch.from_numpy(x), cache=(ts.k_pools, ts.v_pools, info_t))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=2e-3)
    for (jk, jv), (tk, tv) in zip(want_kv, got_kv):
        assert tuple(tk.shape) == jk.shape == (1, 2, PAGE, 8)
        np.testing.assert_allclose(tk.float().numpy(), np.asarray(jk.astype(jnp.float32)),
                                   rtol=ULP, atol=ULP)
    assert torch.equal(before, pool)  # the forward wrote no pool


@pytest.mark.parametrize("cache_dtype", ["bf16", "int8"])
@pytest.mark.parametrize("fused", [False, True], ids=["dense", "fused"])
def test_prefix_admit_matches_jax(pair, cache_dtype, fused):
    """``paged_admit_with_prefix``: the prediction in the model band, the
    allocator state exactly the reference's, the suffix pages within a bf16
    ULP of the reference's (under int8 pools within one quantization step,
    <= 0.05 for values of size <= 6, since a ULP of input can move a value
    across a step)."""
    jm, params, tm = pair
    js, ts = _admitted(jm, params, tm, cache_dtype)
    cached = np.array(js.page_table)[0, :2]
    suffix = np.random.default_rng(5).normal(0, 1, (1, PAGE, FEATURES)).astype(np.float32)
    jp, js = jax.jit(lambda p, s, sf: jsv.paged_admit_with_prefix(
        jm, p, s, jnp.int32(2), sf, jnp.int32(5), jnp.asarray(cached), fused=fused,
    ))(params, js, jnp.asarray(suffix))
    tp, ts = tsv.paged_admit_with_prefix(
        tm, ts, 2, torch.from_numpy(suffix), 5, torch.from_numpy(cached), fused=fused,
    )
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=0, atol=2e-3)
    for name in STATE_FIELDS:
        np.testing.assert_array_equal(getattr(ts, name).numpy(), np.asarray(getattr(js, name)),
                                      err_msg=name)
    atol = 0.05 if cache_dtype == "int8" else 1e-3
    for layer in range(SIZES["layers"]):
        for jc, tc in zip(jsv.slot_cache(js, 2, layer), tsv.slot_cache(ts, 2, layer)):
            np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=ULP, atol=atol)


@pytest.mark.parametrize("cache_dtype", ["bf16", "int8"])
def test_fused_prefix_admission_bitwise_within_the_port(pair, cache_dtype):
    """Fused against dense: the same prediction and the same suffix pool
    bytes (the port's counterpart of ``test_paged_chunk_kernel.py:518``)."""
    jm, params, tm = pair
    _, ts = _admitted(jm, params, tm, cache_dtype)
    cached = ts.page_table[0, :2].clone()
    suffix = torch.from_numpy(
        np.random.default_rng(5).normal(0, 1, (1, PAGE, FEATURES)).astype(np.float32))
    outs = {}
    for fused in (False, True):
        state = ts._replace(
            k_pools=tuple(tsv.QuantizedPool(p.values.clone(), p.scales.clone())
                          if isinstance(p, tsv.QuantizedPool) else p.clone()
                          for p in ts.k_pools),
            v_pools=tuple(tsv.QuantizedPool(p.values.clone(), p.scales.clone())
                          if isinstance(p, tsv.QuantizedPool) else p.clone()
                          for p in ts.v_pools),
        )
        outs[fused] = tsv.paged_admit_with_prefix(tm, state, 2, suffix, 5, cached, fused=fused)
    assert torch.equal(outs[False][0], outs[True][0])
    for layer in range(SIZES["layers"]):
        for d, f in zip(tsv.slot_cache(outs[False][1], 2, layer),
                        tsv.slot_cache(outs[True][1], 2, layer)):
            assert torch.equal(d, f)


def _request(seed, t, horizon):
    rng = np.random.default_rng(seed)
    prog = np.cumsum(2.0 + rng.normal(0, 0.3, t + 1))
    return Request(prog, np.full(t + 1, 2), horizon)


@pytest.mark.parametrize("cache_dtype", ["bf16", "fp8"])
def test_fused_wave_bitwise_matches_dense_wave(pair, cache_dtype):
    """``run_waves`` with ``fused_wave=True`` serves the dense wave's streams
    bit for bit (the port's counterpart of ``test_serving.py:410``)."""
    _, _, tm = pair
    requests = [_request(0, 24, 5), _request(1, 9, 12), _request(2, 17, 3),
                _request(3, 30, 8)]

    def mk(fused_wave):
        return ContinuousBatcher(tm, num_pages=24, page_size=8, slots=2, max_prefix=32,
                                 max_pages_per_seq=8, cache_dtype=cache_dtype,
                                 fused_wave=fused_wave, device="cpu")

    fused = mk(True)
    assert fused.fused_wave and not mk(False).fused_wave
    want = mk(False).run_waves(requests)
    got = fused.run_waves(requests)
    for i in range(len(requests)):
        np.testing.assert_array_equal(got[i], want[i], err_msg=f"request {i}")
    assert int(fused.state.free_top) == 24
    assert not bool(fused.state.active.any())


def test_fused_wave_admit_matches_jax(pair):
    """``paged_admit_batch(fused=True)``: predictions in the model band and
    the allocator state exactly the reference's fused admit."""
    jm, params, tm = pair
    js = jsv.init_paged(jm, 16, PAGE, 3, 8)
    ts = tsv.init_paged(tm, 16, PAGE, 3, 8)
    feats = np.random.default_rng(2).normal(0, 1, (2, 16, FEATURES)).astype(np.float32)
    lens = np.array([13, 9], np.int32)
    jp, js = jax.jit(lambda p, s, f, ln: jsv.paged_admit_batch(
        jm, p, s, jnp.asarray([0, 2], jnp.int32), f, ln, fused=True,
    ))(params, js, jnp.asarray(feats), jnp.asarray(lens))
    tp, ts = tsv.paged_admit_batch(tm, ts, torch.tensor([0, 2], dtype=torch.int32),
                                   torch.from_numpy(feats), torch.from_numpy(lens), fused=True)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=0, atol=2e-3)
    for name in STATE_FIELDS:
        np.testing.assert_array_equal(getattr(ts, name).numpy(), np.asarray(getattr(js, name)),
                                      err_msg=name)


@pytest.mark.parametrize("dh", [4, 9, 64, 96, 128])
def test_chunk_card_path_picks_the_exact_or_the_padded_build(dh, monkeypatch):
    """The chunk kernel's launch, reachable without a card (the library a
    stand-in that records each call): a head dim equal to its width runs
    the exact build (``paged_chunk``), one below it the padded build
    (``paged_chunk_padded``). Both get the true head dim, the width of
    ``kernel_width`` and the square root of the true head dim; only the
    padded launch counts in ``padded_launches``."""
    from types import SimpleNamespace

    from beholder_tpu_torch.ops.flash_attention import kernel_width

    calls = []

    def lib(name):
        def launch(*args):
            # ..., S, H, Hkv, W, Dh, width, page, ...; sqrt_dh, stream last
            calls.append((name, args[14], args[15], args[-2]))
            return 0
        return SimpleNamespace(paged_chunk_launch=launch)

    monkeypatch.setattr(tpa, "_chunk_kernel_lib", lib)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: SimpleNamespace(cuda_stream=0))
    q = torch.zeros(2, 4, 8, dh, dtype=torch.bfloat16)
    chunk = torch.zeros(2, 2, 8, dh, dtype=torch.bfloat16)
    pool = torch.zeros(6, 2, dh, 16, dtype=torch.bfloat16)
    table = torch.zeros(2, 3, dtype=torch.int32)
    lens = torch.tensor([0, 20], dtype=torch.int32)
    counts = (tpa.paged_chunk_attention.launches, tpa.paged_chunk_attention.padded_launches)
    out = tpa._chunk_launch(q, chunk, chunk, pool, pool, table, lens, 48, 3, None, None, None)
    width = kernel_width(dh)
    assert out.shape == q.shape
    assert calls == [("paged_chunk" if width == dh else "paged_chunk_padded", dh, width,
                      torch.sqrt(torch.tensor(float(dh))).item())]
    assert (tpa.paged_chunk_attention.launches - counts[0],
            tpa.paged_chunk_attention.padded_launches - counts[1]) == (1, int(width != dh))
