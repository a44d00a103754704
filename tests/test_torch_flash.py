"""The port's flash attention (forward, gradients, checks) against the JAX
package's ``flash_attention``, whose Pallas kernels run in interpret mode
on the CPU.

Inputs are made from a numpy seed and handed to both. On CPU tensors the
port runs its plain versions (the CUDA kernels run only on the card, where
``chip_smoke.py`` holds them against these plain versions). Tolerances,
with their reasons:

- f32: the reference's own bands, ``tests/test_flash_attention.py:33``
  (forward: rtol 1e-4, atol 1e-5) and ``:54`` (gradients: rtol 1e-3,
  atol 1e-4). Both sides sum f32 products in other orders; the plain
  forward runs its softmax over the whole row, the kernel online by tiles.
- bf16: ``rtol = atol / max|ref| = 2**-6``, a few bf16 ULPs (a ULP is
  2**-8 to 2**-7 of a value). p is rounded to bf16 before PV after a
  whole-row max here and after a running max in the reference, which moves
  single weights by a ULP; the port sums dk/dv over the GQA group in f32
  and rounds once, where the reference rounds each query head's partial to
  bf16 first, so a dk/dv entry can differ by a ULP of the largest partial.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from beholder_tpu.ops.flash_attention import flash_attention as jax_flash
from beholder_tpu_torch.ops import flash_attention as fa
from beholder_tpu_torch.ops.flash_attention import flash_attention

CASES = {
    # unaligned T (the reference pads it to 256), GQA group 2
    "causal-gqa-t200": dict(b=1, h=4, hkv=2, t=200, d=16, causal=True),
    "noncausal-mqa": dict(b=2, h=4, hkv=1, t=64, d=16, causal=False),
    "window16-mqa-d64": dict(b=1, h=4, hkv=1, t=200, d=64, causal=True, window=16),
    "window100-gqa": dict(b=1, h=4, hkv=2, t=200, d=16, causal=True, window=100),
    "segments-causal-gqa": dict(b=2, h=4, hkv=2, t=130, d=16, causal=True, seg=True),
    "segments-noncausal": dict(b=2, h=4, hkv=4, t=64, d=16, causal=False, seg=True),
    # the head dims of the reference's test models (dim=32, heads=4) and of
    # its default model (dim=128, heads=4)
    "causal-gqa-d8": dict(b=2, h=4, hkv=2, t=130, d=8, causal=True),
    "window40-d32": dict(b=1, h=4, hkv=4, t=160, d=32, causal=True, window=40),
    # head dim 128 (the reference's bench_ring_block width): GQA 4:1, and a
    # window over a partial last tile
    "causal-gqa4-d128": dict(b=1, h=4, hkv=1, t=256, d=128, causal=True),
    "window64-gqa-d128": dict(b=1, h=4, hkv=2, t=200, d=128, causal=True, window=64),
    # head dims the kernels run padded to their next width: the reference's
    # own unaligned case (tests/test_flash_attention.py:39, h=3, t=77, d=9),
    # its GQA 16:8 at d=8 (:136), and 4 (the dryrun's Ulysses cell), 24 and 96
    "causal-t77-d9": dict(b=1, h=3, hkv=3, t=77, d=9, causal=True),
    "causal-gqa16x8-d8": dict(b=1, h=16, hkv=8, t=128, d=8, causal=True),
    "causal-gqa-d4": dict(b=2, h=4, hkv=2, t=100, d=4, causal=True),
    "window50-gqa-d24": dict(b=1, h=4, hkv=2, t=130, d=24, causal=True, window=50),
    "noncausal-gqa-d96": dict(b=1, h=4, hkv=2, t=96, d=96, causal=False),
}
BANDS = {"f32": ((1e-4, 1e-5), (1e-3, 1e-4)), "bf16": ((2**-6, 2**-6), (2**-6, 2**-6))}


def _inputs(seed, b, h, hkv, t, d, seg=False, **_):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, h, t, d)).astype(np.float32)
    k = rng.normal(size=(b, hkv, t, d)).astype(np.float32)
    v = rng.normal(size=(b, hkv, t, d)).astype(np.float32)
    do = rng.normal(size=(b, h, t, d)).astype(np.float32)
    ids = np.sort(rng.integers(0, 3, size=(b, t)), axis=-1).astype(np.int32) if seg else None
    return q, k, v, do, ids


def _close(got, want, band, name, scaled):
    rtol, atol = band
    want = np.asarray(jnp.asarray(want, jnp.float32))
    got = got.detach().float().numpy()
    assert got.shape == want.shape, (name, got.shape, want.shape)
    if scaled:
        atol = atol * float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol, err_msg=name)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("case", list(CASES))
def test_flash_forward_and_gradients_match_jax(case, dtype):
    c = CASES[case]
    q, k, v, do, ids = _inputs(3, **c)
    causal, window = c["causal"], c.get("window")
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "f32" else (jnp.bfloat16, torch.bfloat16)
    jseg = None if ids is None else jnp.asarray(ids)
    want_o, vjp = jax.vjp(
        lambda q, k, v: jax_flash(q, k, v, causal=causal, window=window, segment_ids=jseg),
        *(jnp.asarray(a).astype(jdt) for a in (q, k, v)),
    )
    want_grads = vjp(jnp.asarray(do).astype(jdt))

    tq, tk, tv = (torch.from_numpy(a).to(tdt).requires_grad_() for a in (q, k, v))
    tseg = None if ids is None else torch.from_numpy(ids)
    out = flash_attention(tq, tk, tv, causal=causal, window=window, segment_ids=tseg)
    out.backward(torch.from_numpy(do).to(tdt))
    fwd_band, grad_band = BANDS[dtype]
    scaled = dtype == "bf16"
    assert out.dtype == tdt
    _close(out, want_o, fwd_band, "o", scaled)
    # dk/dv come back at kv-head shape (checked inside _close)
    for name, t, want in zip(("dq", "dk", "dv"), (tq, tk, tv), want_grads):
        assert t.grad.dtype == tdt
        _close(t.grad, want, grad_band, name, scaled)


def test_window_one_attends_each_row_to_itself():
    """``window=1``: every row sees only its own key, so o = v and lse is
    that one score (the kernel's band bounds, in the plain version)."""
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.normal(size=(2, 8, 16)).astype(np.float32)) for _ in range(3))
    o, lse = fa.flash_forward(q, k, v, causal=True, window=1)
    torch.testing.assert_close(o, v, rtol=0, atol=1e-6)
    torch.testing.assert_close(lse, (q * 0.25 * k).sum(-1), rtol=1e-6, atol=1e-6)


def test_flash_backward_saves_nothing_of_size_t_by_t():
    """The port's counterpart of ``test_flash_never_materializes_scores``:
    the autograd Function saves q, k, v, o and lse (and the segment ids),
    and no tensor whose trailing dims are (T, T)."""
    t = 96
    rng = np.random.default_rng(1)
    q = torch.from_numpy(rng.normal(size=(1, 4, t, 16)).astype(np.float32)).requires_grad_()
    k, v = (torch.from_numpy(rng.normal(size=(1, 2, t, 16)).astype(np.float32)).requires_grad_()
            for _ in range(2))
    seg = torch.from_numpy(np.repeat([[0, 1]], t // 2, axis=1).astype(np.int32))
    saved = []

    def pack(x):
        saved.append(tuple(x.shape))
        return x

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda x: x):
        out = flash_attention(q, k, v, causal=True, segment_ids=seg)
    out.sum().backward()
    assert saved, "the Function saved nothing"
    assert not [s for s in saved if len(s) >= 2 and s[-2:] == (t, t)], saved
    assert sorted(saved) == sorted([(4, t, 16), (2, t, 16), (2, t, 16), (4, t, 16), (4, t),
                                    (1, t)]), saved


@pytest.mark.parametrize(
    "kwargs, err",
    [
        (dict(window=4), "window requires causal"),
        (dict(causal=True, window=0), "window must be >= 1"),
        (dict(causal=True, segment_ids=torch.zeros(2, 4, 8, dtype=torch.int32)), "batch-shaped"),
        (dict(causal=True, k=torch.zeros(2, 3, 8, 16)), "GQA shapes"),
        (dict(causal=True, v=torch.zeros(2, 2, 8, 8)), "k/v shape mismatch"),
    ],
)
def test_flash_validates_like_the_reference(kwargs, err):
    q = torch.zeros(2, 4, 8, 16)
    k = kwargs.pop("k", torch.zeros(2, 2, 8, 16))
    v = kwargs.pop("v", torch.zeros(2, 2, 8, 16))
    with pytest.raises(ValueError, match=err):
        flash_attention(q, k, v, **kwargs)


def test_cpu_wrappers_run_the_plain_versions_and_count_no_launch():
    rng = np.random.default_rng(2)
    q = torch.from_numpy(rng.normal(size=(4, 40, 64)).astype(np.float32)).bfloat16()
    k, v = (torch.from_numpy(rng.normal(size=(2, 40, 64)).astype(np.float32)).bfloat16()
            for _ in range(2))
    do = torch.from_numpy(rng.normal(size=(4, 40, 64)).astype(np.float32)).bfloat16()
    before = (fa.flash_forward.launches, fa.flash_backward_dq.launches,
              fa.flash_backward_dkv.launches)
    o, lse = fa.flash_forward(q, k, v, causal=True)
    want_o, want_lse = fa.flash_forward_reference(q, k, v, causal=True)
    assert torch.equal(o, want_o) and torch.equal(lse, want_lse)
    delta = fa.flash_delta(o, do)
    dq = fa.flash_backward_dq(q, k, v, do, lse, delta, causal=True)
    dk, dv = fa.flash_backward_dkv(q, k, v, do, lse, delta, causal=True)
    want = fa.flash_backward_reference(q, k, v, o, lse, do, causal=True)
    for got, w in zip((dq, dk, dv), want):
        assert torch.equal(got, w)
    assert (fa.flash_forward.launches, fa.flash_backward_dq.launches,
            fa.flash_backward_dkv.launches) == before


def _backward_case(seed, b=1, h=4, hkv=2, t=256, d=64):
    """bf16 flattened operands, the plain forward's lse and delta, and the
    full plain gradients: the inputs ``chip_smoke.py`` holds the backward
    kernels against, at a small shape."""
    rng = np.random.default_rng(seed)

    def normal(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32)).bfloat16()

    q, k, v, do = normal(b * h, t, d), normal(b * hkv, t, d), normal(b * hkv, t, d), \
        normal(b * h, t, d)
    kw = dict(causal=True, window=None, segment_ids=None)
    o, lse = fa.flash_forward_reference(q, k, v, **kw)
    bwd = (q, k, v, do, lse, fa.flash_delta(o, do))
    full = (fa.flash_dq_reference(*bwd, **kw), *fa.flash_dkv_reference(*bwd, **kw))
    return bwd, kw, full


@pytest.mark.parametrize("fault", ["key_tile", "query_tile", "group_head", "scale_1+2^-8"])
def test_backward_limits_catch_a_faulty_backward(fault):
    """``chip_smoke.py``'s limits for the backward kernels have teeth (B=1,
    H=4, Hkv=2, T=256, Dh=64, bf16, causal): a plain dq and dk/dv without
    one 64-key tile, a dk/dv without one 64-row query tile or without one
    query head of the GQA group read above 3x the reading's limit against
    the full plain versions; gradients scaled by 1 + 2**-8, a fault under
    one bf16 spacing, differ in above 3x the share's limit."""
    import chip_smoke

    bwd, kw, full = _backward_case(5)
    for want in full:
        assert chip_smoke.grad_readings(want, want) == (0.0, 0.0)
    controls = chip_smoke.backward_controls(torch, fa, bwd, full, bwd[0].shape[1] // 2, **kw)
    picked = {n: r for n, r in controls.items() if n.split(":")[0] == fault}
    assert len(picked) == (3 if fault in ("key_tile", "scale_1+2^-8") else 2), picked
    for name, (reading, share) in picked.items():
        if fault.startswith("scale"):
            assert share > 3 * chip_smoke.FLASH_GRAD_SHARE, (name, share)
        else:
            assert reading > 3 * chip_smoke.FLASH_TOL_RMS[name.split(":")[1]], (name, reading)


def test_backward_reading_forgives_one_bf16_spacing_at_a_few_values():
    """The reading forgives exactly one bf16 spacing at each plain value (a
    tensor-core sum in another order flips an output's rounding now and
    then), and the share only a few such flips: one value in 500 one
    spacing off reads 0 inside the share; the value largest against its
    row's (floored) RMS two spacings off fails the reading; every value one spacing
    off fails the share."""
    import chip_smoke

    _, _, full = _backward_case(6)
    for name, want in zip(("dq", "dk", "dv"), full):
        bits = want.view(torch.int16).flatten()

        def stepped(n, where):  # n bf16 steps away from 0 at the flat indices
            out = bits.clone()
            out[where] += n
            return out.view(torch.bfloat16).reshape(want.shape)

        w = want.float()
        floor = w.square().mean().sqrt() * 2**-8  # the reading's floor under a row's RMS
        ratio = (w.abs() / w.square().mean(-1, keepdim=True).sqrt().clamp_min(floor)).flatten()
        few = torch.arange(0, bits.numel(), 500)
        few = few[bits[few] != 0]
        reading, share = chip_smoke.grad_readings(stepped(1, few), want)
        assert reading == 0 and 0 < share <= chip_smoke.FLASH_GRAD_SHARE, (name, share)
        reading, _ = chip_smoke.grad_readings(stepped(2, ratio.argmax()), want)
        assert reading > chip_smoke.FLASH_TOL_RMS[name], (name, reading)
        _, share = chip_smoke.grad_readings(stepped(1, (bits != 0).nonzero()[:, 0]), want)
        assert share > 3 * chip_smoke.FLASH_GRAD_SHARE, (name, share)


class _PastTheCheck(Exception):
    """Raised by a stub standing after the head-dim check."""


@pytest.mark.parametrize("dh", [1, 4, 8, 9, 24, 64, 96, 128, 129, 160])
def test_kernel_head_dim_check_takes_the_instantiated_dims(dh, monkeypatch):
    """The CUDA path's checks (run before any launch, so reachable without
    a card): every head dim from 1 to 128 maps to its width, the next of
    the instantiated (8, 16, 32, 64, 128), and passes the checks of the
    flash forward, the flash backward kernels (dq, dk/dv) and the paged
    chunk kernel; 129 and 160 raise, naming 128. The flash checks take bf16
    and f32 and refuse f16."""
    from beholder_tpu_torch.ops import paged_attention as pa

    def past(*_, **__):
        raise _PastTheCheck

    monkeypatch.setattr(pa, "_kernel_mode", past)
    assert fa.KERNEL_HEAD_DIMS == (8, 16, 32, 64, 128) and fa.MAX_HEAD_DIM == 128

    def checks(dtype):
        q = torch.zeros(4, 8, dh, dtype=dtype)
        k = torch.zeros(2, 8, dh, dtype=dtype)
        f32 = {"lse": torch.zeros(4, 8), "delta": torch.zeros(4, 8)}
        pool = torch.zeros(3, 2, dh, 16, dtype=torch.bfloat16)
        return [
            lambda: fa._check_kernel_inputs("flash forward", {"q": q, "k": k, "v": k}, {}, None),
            lambda: fa._check_kernel_inputs("flash dq", {"q": q, "k": k, "v": k, "do": q}, f32,
                                            None),
            lambda: fa._check_kernel_inputs("flash dk/dv", {"q": q, "k": k, "v": k, "do": q},
                                            f32, None),
            lambda: pa._chunk_launch(q.bfloat16()[None], k.bfloat16()[None], k.bfloat16()[None],
                                     pool, pool, None, None, 32, 2, None, None, None),
        ]

    if dh > 128:
        with pytest.raises(ValueError, match="head_dim 1 to 128"):
            fa.kernel_width(dh)
        for check in checks(torch.bfloat16) + checks(torch.float32)[:3]:
            with pytest.raises(ValueError, match=rf"takes head_dim 1 to 128, got {dh}"):
                check()
        return
    width = fa.kernel_width(dh)
    assert width == min(w for w in (8, 16, 32, 64, 128) if w >= dh)
    for dtype in (torch.bfloat16, torch.float32):
        flash, chunk = checks(dtype)[:3], checks(dtype)[3]
        for check in flash:
            assert check() == width
        with pytest.raises(_PastTheCheck):
            chunk()
    for check in checks(torch.float16)[:3]:
        with pytest.raises(TypeError, match="takes bf16 or f32 inputs, got torch.float16"):
            check()


class _StandIns:
    """The flash kernel libraries' stand-ins: each C entry records (entry,
    width, scale) and returns 0 (launched), leaving its outputs as
    allocated."""

    ENTRIES = ("flash_fwd_launch", "flash_dq_launch", "flash_dkv_launch",
               "flash_f32_fwd_launch", "flash_f32_dq_launch", "flash_f32_dkv_launch")

    def __init__(self):
        self.calls = []

    def lib(self, name):
        def entry(fn):
            def call(*args):
                # the trailing scalars: ..., Dh (the width), H, causal, window,
                # q_offset, kv_offset, scale, stream
                self.calls.append((fn, args[-8], args[-2]))
                return 0
            return call
        return type("Lib", (), {fn: staticmethod(entry(fn)) for fn in self.ENTRIES})()


@pytest.mark.parametrize("dh", [64, 96, 160])
@pytest.mark.parametrize("entry", ["flash_attention", "ring_attention"])
def test_card_path_refuses_a_backward_at_head_dim_96_before_the_forward(entry, dh,
                                                                        monkeypatch):
    """On the card a differentiable call at head dim 96 runs the kernels
    at width 128 with the scale of 96, bf16 and f32 alike: one forward (the
    ring: one a block pair), then, in the backward, the dq and dk/dv
    kernels, every launch at width 128 and ``scale = 1/sqrt(96)``. At 64
    every launch runs at 64. At 160 the call raises before any launch,
    naming 128, with and without gradients. The card path is taken here on
    CPU tensors (``_on_card`` patched); the kernel libraries are stand-ins
    that record each launch's width and scale."""
    from types import SimpleNamespace

    from beholder_tpu_torch.ops.attention import ring_attention
    from beholder_tpu_torch.parallel import Mesh

    stand = _StandIns()
    monkeypatch.setattr(fa, "_on_card", lambda q: True)
    monkeypatch.setattr(fa, "_kernel_lib", stand.lib)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: SimpleNamespace(cuda_stream=0))
    if entry == "flash_attention":
        def call(*x):
            return flash_attention(*x, causal=True)
    else:
        def call(*x):
            return ring_attention(*x, Mesh(["cpu"] * 4), causal=True)

    for dtype in (torch.bfloat16, torch.float32):
        stand.calls.clear()
        q = torch.zeros(1, 4, 128, dh, dtype=dtype)
        k = torch.zeros(1, 2, 128, dh, dtype=dtype)
        leaf = q.clone().requires_grad_()
        if dh == 160:
            with pytest.raises(ValueError, match=r"takes head_dim 1 to 128, got 160"):
                call(leaf, k, k)
            with torch.no_grad(), pytest.raises(ValueError,
                                                match=r"takes head_dim 1 to 128, got 160"):
                call(leaf, k, k)
            assert stand.calls == []
            continue
        out = call(leaf, k, k)
        assert out.shape == q.shape and out.dtype == dtype
        prefix = "flash_f32_" if dtype == torch.float32 else "flash_"
        fwd = [c for c in stand.calls if c[0] == prefix + "fwd_launch"]
        assert fwd and len(fwd) == len(stand.calls), stand.calls
        out.float().sum().backward()
        assert leaf.grad.shape == q.shape
        kinds = {c[0] for c in stand.calls}
        assert kinds == {prefix + n for n in ("fwd_launch", "dq_launch", "dkv_launch")}, kinds
        if entry == "flash_attention":
            assert [c[0] for c in stand.calls] == [prefix + n for n in
                                                   ("fwd_launch", "dq_launch", "dkv_launch")]
        want = torch.tensor(1.0 / np.sqrt(dh), dtype=torch.float32).item()
        for fn, width, scale in stand.calls:
            assert width == (128 if dh == 96 else 64), (fn, width)
            assert torch.tensor(scale, dtype=torch.float32).item() == want, (fn, scale)


@pytest.mark.parametrize("dh", [4, 9, 24, 96])
def test_padding_to_the_width_with_the_true_scale_is_the_plain_version(dh):
    """What the card path does at a head dim below its width: q, k, v and do
    zero-padded to the width, the kernels' function there with the scale of
    the true head dim, the results sliced back, equals the plain version at
    the true head dim within the f32 band (forward rtol 1e-4, atol 1e-5;
    gradients rtol 1e-3, atol 1e-4), o, lse, dq, dk and dv. A planted scale
    taken from the width must fail the band."""
    rng = np.random.default_rng(dh)
    width = fa.kernel_width(dh)

    def normal(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32))

    q, do = normal(4, 70, dh), normal(4, 70, dh)
    k, v = normal(2, 70, dh), normal(2, 70, dh)
    kw = dict(causal=True, window=None, segment_ids=None)
    o, lse = fa.flash_forward_reference(q, k, v, **kw)
    delta = fa.flash_delta(o, do)
    want = (o, lse, fa.flash_dq_reference(q, k, v, do, lse, delta, **kw),
            *fa.flash_dkv_reference(q, k, v, do, lse, delta, **kw))

    def padded_run(scale):
        qp, kp, vp, dop = (torch.nn.functional.pad(x, (0, width - dh)) for x in (q, k, v, do))
        op, lsep = fa.flash_forward_reference(qp, kp, vp, scale=scale, **kw)
        deltap = fa.flash_delta(op, dop)
        dq = fa.flash_dq_reference(qp, kp, vp, dop, lsep, deltap, scale=scale, **kw)
        dk, dv = fa.flash_dkv_reference(qp, kp, vp, dop, lsep, deltap, scale=scale, **kw)
        return op[..., :dh], lsep, dq[..., :dh], dk[..., :dh], dv[..., :dh]

    bands = [(1e-4, 1e-5)] * 2 + [(1e-3, 1e-4)] * 3
    got = padded_run(1.0 / np.sqrt(dh))
    for name, g, w, (rtol, atol) in zip(("o", "lse", "dq", "dk", "dv"), got, want, bands):
        torch.testing.assert_close(g, w, rtol=rtol, atol=atol, msg=name)
    planted = padded_run(1.0 / np.sqrt(width))
    assert not torch.allclose(planted[0], want[0], rtol=1e-4, atol=1e-5)
    assert not torch.allclose(planted[2], want[2], rtol=1e-3, atol=1e-4)
