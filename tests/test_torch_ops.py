"""The port's ops against the JAX reference on the same inputs.

Inputs come from numpy seeds and go through both frameworks; the JAX side
runs as its own tests run it (the Pallas paged kernel in interpret mode on
the CPU). Tolerances, with their reasons:

- quantizers and E8M0 decoding: bitwise (one definition each, integer
  exponent arithmetic, round-half-even on both sides);
- the plain paged decode version: bitwise — it walks pages with the TPU
  kernel's online softmax and dtype mix, and bf16 products summed in f32
  are exact before the sum;
- ``full_attention``: bitwise on bf16 inputs, which hold here because the
  sums are short; the check allows one bf16 ULP of the output for a
  different f32 summation order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from beholder_tpu.ops import attention as jattn
from beholder_tpu.ops import paged_attention as jpa
from beholder_tpu.ops import quant as jq
from beholder_tpu_torch.ops import attention as tattn
from beholder_tpu_torch.ops import paged_attention as tpa
from beholder_tpu_torch.ops import quant as tq


def _bits(a):
    a = np.asarray(a)
    return a.view(np.uint8 if a.dtype.itemsize == 1 else np.uint32)


def _bf16(x: np.ndarray):
    """The same bf16 values on both sides."""
    j = jnp.asarray(x, jnp.bfloat16)
    return j, torch.from_numpy(np.asarray(j.astype(jnp.float32))).bfloat16()


# -- quantizers ---------------------------------------------------------


# scales span tiny to huge blocks; subnormal blocks are left out because
# XLA's CPU backend flushes subnormals to zero and torch does not
@pytest.mark.parametrize("scale", [1e-25, 1e-3, 1.0, 300.0, 1e30])
@pytest.mark.parametrize("axis", [-1, -2])
def test_quantizers_bitwise(scale, axis):
    rng = np.random.default_rng(int(np.log10(scale) + 40) * 2 + axis)
    x = (rng.normal(0, 1, (6, 2, 16, 8)) * scale).astype(np.float32)
    x[0, 0] = 0.0  # an all-zero block: identity scale
    for jfn, tfn in ((jq.quantize_symmetric, tq.quantize_symmetric),
                     (jq.quantize_fp8_block, tq.quantize_fp8_block)):
        jv, js = jfn(jnp.asarray(x), axis)
        tv, ts = tfn(torch.from_numpy(x), axis)
        np.testing.assert_array_equal(_bits(jv), _bits(tv.view(torch.uint8).numpy()
                                                       if tv.dtype == torch.float8_e4m3fn
                                                       else tv.numpy()))
        np.testing.assert_array_equal(_bits(js), _bits(ts.numpy()))
        np.testing.assert_array_equal(
            _bits(jq.pool_scales_f32(js)), _bits(tq.pool_scales_f32(ts).numpy())
        )


def test_pool_quantize_dispatch_and_e8m0_range():
    x = torch.from_numpy(np.random.default_rng(0).normal(0, 1, (3, 4, 5)).astype(np.float32))
    v, s = tq.pool_quantize(x, -1, torch.int8)
    assert v.dtype == torch.int8 and s.dtype == torch.float32
    v, s = tq.pool_quantize(x, -1, torch.float8_e4m3fn)
    assert v.dtype == torch.float8_e4m3fn and s.dtype == torch.uint8
    with pytest.raises(ValueError):
        tq.pool_quantize(x, -1, torch.bfloat16)
    # every E8M0 exponent the quantizer can emit decodes to 2**(e-127) exactly
    e = torch.arange(1, 255, dtype=torch.uint8)
    np.testing.assert_array_equal(
        tq.pool_scales_f32(e).numpy(), np.ldexp(1.0, np.arange(1, 255) - 127).astype(np.float32)
    )


# -- paged decode ---------------------------------------------------------


def _paged_inputs(seed, family, s=4, h=4, hkv=2, dh=8, page=8, n=12, p=3):
    rng = np.random.default_rng(seed)
    q = rng.normal(0, 1, (s, h, dh)).astype(np.float32)
    k = rng.normal(0, 1, (n, hkv, dh, page)).astype(np.float32)
    v = rng.normal(0, 1, (n, hkv, dh, page)).astype(np.float32)
    table = rng.permutation(n)[: s * p].reshape(s, p).astype(np.int32)
    # lens: an empty history (0), page-crossing lengths, a dead slot (-1)
    lens = np.array([0, 13, p * page - 1, -1][:s], np.int32)
    qj, qt = _bf16(q)
    if family == "bf16":
        kj, kt = _bf16(k)
        vj, vt = _bf16(v)
        return (qj, kj, vj, None, None), (qt, kt, vt, None, None), table, lens
    jfn = jq.quantize_symmetric if family == "int8" else jq.quantize_fp8_block
    tfn = tq.quantize_symmetric if family == "int8" else tq.quantize_fp8_block
    kj, ksj = jfn(jnp.asarray(k), -2)
    vj, vsj = jfn(jnp.asarray(v), -2)
    kt, kst = tfn(torch.from_numpy(k), -2)
    vt, vst = tfn(torch.from_numpy(v), -2)
    return (qj, kj, vj, ksj, vsj), (qt, kt, vt, kst, vst), table, lens


@pytest.mark.parametrize(
    "family,window,heads",
    [
        ("bf16", None, (4, 2)),
        ("bf16", 5, (4, 2)),
        ("int8", None, (4, 2)),
        ("int8", 5, (4, 2)),
        ("fp8", None, (4, 2)),
        ("fp8", 5, (4, 2)),
        ("bf16", None, (4, 4)),   # MHA
        ("int8", 7, (4, 1)),      # MQA
        # MQA groups over 16 query heads, which the kernel runs in chunks
        ("bf16", None, (32, 1)),
        ("fp8", 5, (32, 1)),
        ("int8", None, (64, 1)),
    ],
    ids=["bf16", "bf16-window", "int8", "int8-window", "fp8", "fp8-window",
         "bf16-mha", "int8-mqa-window", "bf16-g32", "fp8-g32-window", "int8-g64"],
)
def test_paged_decode_plain_matches_jax(family, window, heads):
    h, hkv = heads
    (qj, kj, vj, ksj, vsj), (qt, kt, vt, kst, vst), table, lens = _paged_inputs(
        3, family, h=h, hkv=hkv
    )
    want = jpa.paged_decode_attention(
        qj, kj, vj, jnp.asarray(table), jnp.asarray(lens),
        window=window, k_scale=ksj, v_scale=vsj,
    )
    got = tpa.paged_decode_attention(
        qt, kt, vt, torch.from_numpy(table), torch.from_numpy(lens),
        window=window, k_scale=kst, v_scale=vst,
    )
    assert got.dtype == torch.bfloat16 and got.shape == tuple(want.shape)
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want.astype(jnp.float32)))
    # the -1 slot reads no page and returns an exact zero row
    assert not got[3].float().abs().max().item()


@pytest.mark.parametrize("family", ["bf16", "int8", "fp8"])
@pytest.mark.parametrize("window", [None, 9])
def test_paged_chunk_plain_matches_jax_at_head_dim_24(family, window):
    """The plain chunk version at head dim 24 (a width the kernel runs at
    32, its pools read at 24) against the reference's
    ``paged_chunk_attention``, every pool family, window off and on: one
    bf16 ULP of the output (``tests/test_torch_chunk.py``'s band: the
    context and scores are bitwise, XLA's CPU exp and torch's differ in the
    last f32 bit now and then)."""
    rng = np.random.default_rng(24)
    slots, hkv, g, w, dh, page, n, p = 3, 2, 2, 6, 24, 8, 16, 4
    (qj, qt), (kcj, kct), (vcj, vct) = (
        _bf16(rng.normal(0, 1, shape).astype(np.float32)) for shape in
        ((slots, hkv * g, w, dh), (slots, hkv, w, dh), (slots, hkv, w, dh))
    )
    (kj, vj, ksj, vsj), (kt, vt, kst, vst) = _pools(rng, family, n, hkv, dh, page)
    table = rng.permutation(n)[: slots * p].reshape(slots, p).astype(np.int32)
    lens = np.array([0, 11, p * page - w], np.int32)
    kw = dict(window=window, ctx_len=p * page + w)
    want = jpa.paged_chunk_attention(qj, kcj, vcj, kj, vj, jnp.asarray(table), jnp.asarray(lens),
                                     k_scale=ksj, v_scale=vsj, **kw)
    got = tpa.paged_chunk_attention(qt, kct, vct, kt, vt, torch.from_numpy(table),
                                    torch.from_numpy(lens), k_scale=kst, v_scale=vst, **kw)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == tuple(want.shape)
    got, want = got.float().numpy(), np.asarray(want.astype(jnp.float32))
    np.testing.assert_allclose(got, want, rtol=2**-7, atol=0)
    assert (got != want).mean() < 0.02


def _pools(rng, family, n, hkv, dh, page):
    """(jax, torch) k/v pools of ``family`` with their scales (None for bf16)."""
    k = rng.normal(0, 1, (n, hkv, dh, page)).astype(np.float32)
    v = rng.normal(0, 1, (n, hkv, dh, page)).astype(np.float32)
    if family == "bf16":
        (kj, kt), (vj, vt) = _bf16(k), _bf16(v)
        return (kj, vj, None, None), (kt, vt, None, None)
    jfn = jq.quantize_symmetric if family == "int8" else jq.quantize_fp8_block
    tfn = tq.quantize_symmetric if family == "int8" else tq.quantize_fp8_block
    (kj, ksj), (vj, vsj) = jfn(jnp.asarray(k), -2), jfn(jnp.asarray(v), -2)
    (kt, kst), (vt, vst) = tfn(torch.from_numpy(k), -2), tfn(torch.from_numpy(v), -2)
    return (kj, vj, ksj, vsj), (kt, vt, kst, vst)


def test_paged_decode_validates_like_the_reference():
    _, (qt, kt, vt, _, _), table, lens = _paged_inputs(0, "bf16")
    t, ln = torch.from_numpy(table), torch.from_numpy(lens)
    with pytest.raises(ValueError):
        tpa.paged_decode_attention(qt[0], kt, vt, t, ln)
    with pytest.raises(ValueError):
        tpa.paged_decode_attention(qt, kt, vt[:, :, :4], t, ln)
    with pytest.raises(ValueError):
        tpa.paged_decode_attention(qt, kt, vt, t, ln, window=0)
    with pytest.raises(ValueError):
        tpa.paged_decode_attention(qt, kt, vt, t, ln, k_scale=torch.ones(1))
    assert tpa.pool_dtype_family(kt, quantized=False) == "bf16"
    assert tpa.pool_dtype_family(kt.to(torch.int8), quantized=True) == "int8"
    assert tpa.pool_dtype_family(kt.to(torch.float8_e4m3fn), quantized=True) == "fp8"


def test_cpu_tensors_never_launch_the_kernel():
    """On CPU tensors the wrapper runs the plain version; the launch count
    moves only for CUDA tensors."""
    _, (qt, kt, vt, _, _), table, lens = _paged_inputs(1, "bf16")
    before = tpa.paged_decode_attention.launches
    got = tpa.paged_decode_attention(qt, kt, vt, torch.from_numpy(table), torch.from_numpy(lens))
    want = tpa.paged_decode_reference(qt, kt, vt, torch.from_numpy(table), torch.from_numpy(lens))
    assert torch.equal(got, want)
    assert tpa.paged_decode_attention.launches == before


# -- full attention ---------------------------------------------------------


@pytest.mark.parametrize(
    "hkv,window", [(4, None), (2, None), (1, 3), (2, 4)],
    ids=["mha", "gqa", "mqa-window", "gqa-window"],
)
def test_full_attention_matches_jax(hkv, window):
    rng = np.random.default_rng(hkv * 10 + (window or 0))
    q = rng.normal(0, 1, (2, 4, 11, 8)).astype(np.float32)
    k = rng.normal(0, 1, (2, hkv, 11, 8)).astype(np.float32)
    v = rng.normal(0, 1, (2, hkv, 11, 8)).astype(np.float32)
    (qj, qt), (kj, kt), (vj, vt) = _bf16(q), _bf16(k), _bf16(v)
    want = np.asarray(
        jattn.full_attention(qj, kj, vj, causal=True, window=window).astype(jnp.float32)
    )
    got = tattn.full_attention(qt, kt, vt, causal=True, window=window)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2**-8, atol=2**-9)
    with pytest.raises(ValueError):
        tattn.full_attention(qt, kt, vt, causal=False, window=2)
