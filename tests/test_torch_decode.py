"""The paged decode kernel's split across the card, checked without a card.

The CUDA kernel (``beholder_tpu_torch/csrc/paged_decode.cu``) cuts each
slot's page walk into the runs that :func:`decode_splits` chooses from the
shapes, walks each run in chunks inside one page, and merges the runs'
partial softmax states in a fixed order. ``chip_smoke.py`` holds the kernel
against :func:`paged_decode_reference` on the card; here the schedule and
the combine are checked against the same plain version (itself bitwise the
JAX package's, ``tests/test_torch_ops.py``):

- the schedule: every live position of every slot falls in exactly one
  run and one chunk of the kernel's walk (mirrored below from the kernel's
  index arithmetic), every chunk within one page and 64 tokens, on the
  16-byte boundaries its copies need;
- the combine: per-run partials (m, l, acc) of a test-local plain helper,
  merged in run order, agree with the plain version within
  ``chip_smoke.KERNEL_TOL`` (the kernel's own limit: both round the output
  to bf16 and group the softmax differently, a few bf16 ULPs), and a dead
  slot's row is exact zeros.
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import chip_smoke
from beholder_tpu_torch.ops import paged_attention as pa
from beholder_tpu_torch.ops.quant import pool_quantize, pool_scales_f32

NEG_INF = -1e30


def _walk(split, max_pages, page, length, window):
    """Positions the kernel sums for one slot, as the kernel walks them:
    a block per run, chunks of at most 64 tokens inside one page, from the
    live start rounded down to 16. Asserts each chunk's bounds."""
    seen = []
    for j in range(split.splits):
        run0, run1 = j * split.span, (j + 1) * split.span
        lo = max(max(length - window + 1, 0) if window else 0, run0)
        hi = min(length, max_pages * page - 1, run1 - 1)
        if length < 0 or lo > hi:
            continue
        p = lo & ~15
        assert p >= run0
        while p <= hi:
            e = min(p + 64, (p // page + 1) * page, run1)
            assert 0 < e - p <= 64 and p // page == (e - 1) // page, (p, e)
            for vec in (8, 16):  # bf16 and int8/fp8 elements a 16-byte copy
                if page % vec == 0:
                    assert (p % page) % vec == 0 and (e - p) % vec == 0, (p, e, vec)
            seen += range(max(p, lo), min(e - 1, hi) + 1)
            p = e
    return seen


@settings(max_examples=300, deadline=None)
@given(
    slots=st.integers(1, 64),
    hkv=st.integers(1, 8),
    max_pages=st.integers(1, 24),
    page=st.sampled_from([1, 8, 16, 24, 32, 64, 100, 128, 256, 512]),
    window=st.one_of(st.none(), st.integers(1, 5000)),
    data=st.data(),
)
def test_decode_splits_cover_every_live_position_once(slots, hkv, max_pages, page, window,
                                                      data):
    split = pa.decode_splits(slots, hkv, max_pages, page, window)
    width = max_pages * page
    assert 1 <= split.splits <= pa.DECODE_MAX_SPLITS
    assert split.span % pa.DECODE_TILE == 0
    assert split.splits * split.span >= width > (split.splits - 1) * split.span
    lens = data.draw(st.lists(st.integers(-1, width + 100), min_size=1, max_size=4))
    for length in lens:
        want = []
        if length >= 0:
            want = list(range(max(length - window + 1, 0) if window else 0,
                              min(length, width - 1) + 1))
        assert sorted(_walk(split, max_pages, page, length, window)) == want


def test_decode_splits_fill_the_card_at_the_serving_shapes():
    """The headline shape (8 slots, 2 kv heads, 4 pages of 128) runs 8 runs
    of one tile, 128 blocks; the long one (8 pages of 512) 16 runs of 4
    tiles, 256 blocks; a window bounds the live tiles, so runs shorten;
    enough (slot, kv head) pairs need no split."""
    assert pa.decode_splits(8, 2, 4, 128, None) == (8, 64)
    assert pa.decode_splits(8, 2, 8, 512, None) == (16, 256)
    assert pa.decode_splits(8, 2, 8, 512, 1500) == (32, 128)
    assert pa.decode_splits(512, 2, 4, 128, None) == (1, 512)


def _split_reference(q, k_pool, v_pool, table, lens, window, k_scale, v_scale, split):
    """Per-run partials of plain dense attention, merged in run order: what
    the kernel's combine computes, with the plain version's dtype mix."""
    slots, h, dh = q.shape
    n, hkv, _, page = k_pool.shape
    g = h // hkv
    width = table.shape[1] * page
    idx = table.long().clamp(0, n - 1)

    def context(pool, scales):
        x = pool[idx].float()                                  # (S, P, Hkv, Dh, page)
        if scales is not None:
            x = (x * pool_scales_f32(scales[idx])[:, :, :, None, :]).bfloat16().float()
        return x.permute(0, 2, 3, 1, 4).reshape(slots, hkv, dh, width)

    k, v = context(k_pool, k_scale), context(v_pool, v_scale)
    s = torch.matmul(q.float().reshape(slots, hkv, g, dh), k)   # (S, Hkv, G, L)
    if k_scale is None:
        s = s.bfloat16().float()
    s = s * (1.0 / dh**0.5)
    pos = torch.arange(width)
    ln = lens.long()[:, None]
    live = (pos <= ln) & (ln >= 0)
    if window is not None:
        live &= pos > ln - window
    ms, ls, accs = [], [], []
    for j in range(split.splits):
        mask = (live & (pos >= j * split.span) & (pos < (j + 1) * split.span))[:, None, None]
        sj = torch.where(mask, s, NEG_INF)
        m = sj.amax(-1)
        p = torch.where(mask, torch.exp(sj - m[..., None]), 0.0)
        ms.append(m)
        ls.append(p.sum(-1))
        accs.append(torch.matmul(p.bfloat16().float(), v.transpose(-1, -2)))
    m = torch.stack(ms).amax(0)
    l = torch.zeros_like(m)
    acc = torch.zeros_like(accs[0])
    for mj, lj, aj in zip(ms, ls, accs):   # the kernel's fixed order
        w = torch.exp(mj - m)
        l = l + lj * w
        acc = acc + aj * w[..., None]
    return (acc / l.clamp(min=1e-37)[..., None]).reshape(slots, h, dh).bfloat16()


def _pools(seed, family, slots=6, h=8, hkv=2, dh=16, page=64, n=24, p=4):
    rng = np.random.default_rng(seed)
    q = torch.from_numpy(rng.normal(0, 1, (slots, h, dh)).astype(np.float32)).bfloat16()
    k = torch.from_numpy(rng.normal(0, 1, (n, hkv, dh, page)).astype(np.float32))
    v = torch.from_numpy(rng.normal(0, 1, (n, hkv, dh, page)).astype(np.float32))
    table = torch.from_numpy(rng.permutation(n)[: slots * p].reshape(slots, p).astype(np.int32))
    # an empty history, page-crossing lengths, the table's last position,
    # a length past the table, a dead slot
    lens = torch.tensor([0, 70, 130, p * page - 1, p * page + 40, -1], dtype=torch.int32)
    if family == "bf16":
        return q, k.bfloat16(), v.bfloat16(), table, lens, None, None
    dt = torch.int8 if family == "int8" else torch.float8_e4m3fn
    kq, ks = pool_quantize(k, axis=-2, values_dtype=dt)
    vq, vs = pool_quantize(v, axis=-2, values_dtype=dt)
    return q, kq, vq, table, lens, ks, vs


@pytest.mark.parametrize("split_kind", ["chosen", "one", "tile"])
@pytest.mark.parametrize("window", [None, 100])
@pytest.mark.parametrize("family", ["bf16", "int8", "fp8"])
def test_split_combine_matches_the_plain_version(family, window, split_kind):
    q, kp, vp, table, lens, ks, vs = _pools(11, family)
    slots, _, _ = q.shape
    _, hkv, _, page = kp.shape
    max_pages = table.shape[1]
    split = {
        "chosen": pa.decode_splits(slots, hkv, max_pages, page, window),
        "one": pa.DecodeSplit(1, -(-max_pages * page // 64) * 64),
        "tile": pa.DecodeSplit(-(-max_pages * page // 64), 64),
    }[split_kind]
    assert split.splits > 1 or split_kind == "one"
    got = _split_reference(q, kp, vp, table, lens, window, ks, vs, split)
    want = pa.paged_decode_reference(q, kp, vp, table, lens, window=window, k_scale=ks,
                                     v_scale=vs)
    err = float((got.float() - want.float()).abs().max())
    assert err <= chip_smoke.KERNEL_TOL, err
    assert not got[lens < 0].float().abs().max()
    assert torch.isfinite(got.float()).all()
