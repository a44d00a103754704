#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``beholder_tpu_torch``) on one H100.

Run from the root of a checkout: ``python3 chip_smoke.py``. It needs one
CUDA card, ``nvcc`` (it builds the port's kernels from ``csrc/`` at first
use) and nothing of JAX. Phases, in order; any failure exits non-zero:

1. device: the card's name and power limit (``nvidia-smi``);
2. build: every kernel of the serving, training and analytics paths, one
   ``nvcc`` per source, all started together;
3. kernels: each kernel's wrapper against its plain PyTorch version on the
   card, at its path's shapes, with the tolerance stated; times (CUDA
   events, median) of the kernel, the plain version and one PyTorch
   library call computing the same function, beside the bound. The paged
   decode kernel at the headline and long-context shapes; the paged chunk
   kernel at the fused-wave, warm-prefix and long-context shapes; the flash
   forward, dq and dk/dv kernels at the training shape (B=4, H=8, Hkv=2,
   T=4096, Dh=64, bf16), causal, with a 512 window, non-causal, with
   segment ids and at T=4000;
4. serving: ``TelemetrySequenceModel(dim=512, heads=8, kv_heads=2,
   layers=4)`` with random bf16 weights from a numpy seed, over bf16, int8
   and fp8 pools, served through ``ContinuousBatcher.run_waves`` and
   ``ContinuousBatcher.run`` (cold admission), ``run_waves`` with
   ``fused_wave=True``, ``run`` with a ``PrefixCache`` and
   ``fused_verify=True`` (a cold pass, then a warm pass), and one
   ``run_what_if``; per path: launch counts of both kernels (set to 0 just
   before, read just after), pages home, forecasts against the dense
   ``forecast_deltas`` oracle, tokens/s, synchronising calls;
5. training: the same model with ``attention="flash"`` and f32 params from
   a numpy seed, ``init_seq_state`` then 20 ``seq_train_step``s on 4
   streams of 4096 events (flash launches counted, losses finite and
   falling, step ms, tokens/s, one profiled step); checkpoint save, restore
   and one step, bitwise against the uninterrupted run; step-1 gradients
   against ``attention="full"``; ``remat=True`` (gradients bitwise, forward
   launches doubled) and ``window=512`` for 3 steps each; then
   ``ProgressAnomalyModel`` at ``entry()``'s shape and 20 ``train_step``s;
6. analytics: the aggregation kernel against its plain version (counts,
   max and min bitwise, the mean within rtol 1e-5) and a float64 numpy
   oracle at the sink's flush (4,096 events), 1,000,000 and 8,388,608
   events, a ragged batch with out-of-range statuses, a skewed one, f32
   progress and misaligned inputs; repeat launches bitwise; a negative
   control; times beside the bound and a four-call PyTorch yardstick. Then
   ``AnalyticsSink(flush_every=4096, async_flush=True)`` takes 2**20
   observations through ``record()``: launches == flushes (counted), every
   logged summary against the oracle; a synchronous flush makes one
   synchronising call;
7. output: a ``kernels`` JSON line, then the ``ok`` line last.

``--profile`` adds a ``torch.profiler`` breakdown of one bf16 ``run_waves``.
The full record goes to ``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import argparse
import json
import logging
import statistics
import subprocess
import sys
import time
import warnings
from pathlib import Path

import numpy as np

#: H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s and bf16 flop/s
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
#: TelemetryStatusEntry values (QUEUED 0, UPLOADING 3)
QUEUED, CONVERTING, DEPLOYED, ERRORED = 0, 2, 4, 5
SPIN_CYCLES = 2_000_000  # ~1 ms at the H100's boost clock
TIMED_RUNS = 3
#: kernel vs plain version: both round the output to bf16, sum in f32 in
#: different orders, and group the online softmax by 128-token tiles (the
#: kernel) vs whole pages (the plain version); on bf16 pools a last-bit
#: score difference can also flip the score's bf16 rounding. Outputs are
#: O(0.1-1), where a bf16 ULP is <= 2**-8.
KERNEL_TOL = 1e-2
#: chunk kernel vs plain version, per element: |kernel - plain| <=
#: CHUNK_RTOL * |plain| + CHUNK_ATOL_RMS * rms, where rms is the plain
#: output row's RMS over the head dim. Both round the output to bf16: one
#: ULP, <= 2**-7 |plain|, is the rtol term. Before that rounding they differ
#: by how they round the weights: the kernel rounds each unnormalised
#: online-softmax weight to bf16, the plain version the normalised one, a
#: relative 2**-9 each, at random; scores summed in another order can also
#: flip one score's bf16 rounding. That moves a row by a small fraction of
#: its own size, so the atol term scales with the row: an output row is
#: ~1 where a row sees a few keys and ~0.03 where it sees 3,600 (long
#: shape), and a fixed atol would hide a wrong kernel at the long shape.
#: The limit is ~3x the largest excess over the rtol term that the kernel
#: showed at any shape: 0.0128 of its row's RMS, long shape, bf16, no
#: window (NVIDIA H100 80GB HBM3, 700 W; PERF.md). At the long shape that
#: is ~1.1e-3 absolute, against rows of RMS ~0.028.
CHUNK_RTOL = 2**-7
CHUNK_ATOL_RMS = 0.04
#: first two forecast steps vs the dense oracle, per pool type: the bands of
#: tests/test_serving.py (bf16 :161-163, int8 :349-351, fp8 :391-393)
FORECAST_BAND = {"bf16": (3e-2, 1.5e-2), "int8": (5e-2, 5e-2), "fp8": (8e-2, 8e-2)}
OUT = Path("chiprun_out")


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(torch, fn, flush, reps: int = 25, warm: int = 3) -> float:
    """Median CUDA-event time of ``fn`` over ``reps`` runs after ``warm``,
    with the L2 cache flushed (64 MB written) before each timed run. A
    ~1 ms spin kernel before the start event keeps the card busy while the
    host enqueues ``fn``'s launches, so the interval holds device time and
    not the host's launch overhead (for a call that issues more than ~1 ms
    of launches, part of that overhead remains)."""
    for _ in range(warm):
        fn()
    events = []
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(SPIN_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def kernel_phase(torch, flush) -> list[dict]:
    from beholder_tpu_torch.ops.paged_attention import (
        paged_decode_attention,
        paged_decode_reference,
    )
    from beholder_tpu_torch.ops.quant import pool_quantize, pool_scales_f32

    dev = torch.device("cuda")
    F = torch.nn.functional
    shapes = {
        # the headline serving shape: lens 255..383, one dead slot
        "headline": dict(S=8, H=8, Hkv=2, Dh=64, page=128, N=32, P=4,
                         lens=[255, 275, 300, 320, 340, 360, 383, -1], window=200),
        # the long-context shape: 512-token pages, lens about 3584..3711
        "long": dict(S=8, H=8, Hkv=2, Dh=64, page=512, N=64, P=8,
                     lens=[3584, 3600, 3620, 3640, 3660, 3680, 3700, 3711],
                     window=1500),
    }
    cases = []
    for shape, c in shapes.items():
        rng = np.random.default_rng(7)
        S, H, Hkv, Dh, page, N, P = (c[k] for k in ("S", "H", "Hkv", "Dh", "page", "N", "P"))
        q = torch.from_numpy(rng.normal(0, 1, (S, H, Dh)).astype(np.float32)).to(dev).bfloat16()
        k_f = torch.from_numpy(rng.normal(0, 1, (N, Hkv, Dh, page)).astype(np.float32)).to(dev)
        v_f = torch.from_numpy(rng.normal(0, 1, (N, Hkv, Dh, page)).astype(np.float32)).to(dev)
        table = torch.from_numpy(
            rng.permutation(N)[: S * P].reshape(S, P).astype(np.int32)).to(dev)
        lens_np = np.asarray(c["lens"], np.int32)
        lens = torch.from_numpy(lens_np).to(dev)
        for family in ("bf16", "int8", "fp8"):
            if family == "bf16":
                kp, vp, ks, vs = k_f.bfloat16(), v_f.bfloat16(), None, None
                k_dense, v_dense = kp.float(), vp.float()
                elem, scale_elem = 2, 0
            else:
                dt = torch.int8 if family == "int8" else torch.float8_e4m3fn
                kp, ks = pool_quantize(k_f, axis=-2, values_dtype=dt)
                vp, vs = pool_quantize(v_f, axis=-2, values_dtype=dt)
                k_dense = (kp.float() * pool_scales_f32(ks)[:, :, None, :]).bfloat16().float()
                v_dense = (vp.float() * pool_scales_f32(vs)[:, :, None, :]).bfloat16().float()
                elem, scale_elem = 1, ks.element_size()
            for window in (None, c["window"]):
                args = (q, kp, vp, table, lens)
                kw = dict(window=window, k_scale=ks, v_scale=vs)
                out_k = paged_decode_attention(*args, **kw)
                out_p = paged_decode_reference(*args, **kw)
                torch.cuda.synchronize()
                check(bool(torch.isfinite(out_k.float()).all()), f"{shape}/{family}: non-finite")
                err = float((out_k.float() - out_p.float()).abs().max())
                dead = lens_np < 0
                if dead.any():
                    check(bool((out_k[torch.from_numpy(dead).to(dev)] == 0).all()),
                          f"{shape}/{family}: dead slot row is not zero")
                check(err <= KERNEL_TOL,
                      f"{shape}/{family}/window={window}: max abs err {err} > {KERNEL_TOL}")
                # library yardstick: SDPA on the pre-gathered dense context
                # (gather, dequant and head expansion excluded from its time)
                L = P * page
                kd = k_dense[table.long()].permute(0, 2, 1, 4, 3).reshape(S, Hkv, L, Dh)
                vd = v_dense[table.long()].permute(0, 2, 1, 4, 3).reshape(S, Hkv, L, Dh)
                kd = kd.repeat_interleave(H // Hkv, dim=1).bfloat16()
                vd = vd.repeat_interleave(H // Hkv, dim=1).bfloat16()
                pos = torch.arange(L, device=dev)[None, :]
                mask = pos <= lens[:, None]
                if window is not None:
                    mask = mask & (pos > lens[:, None] - window)
                mask = mask[:, None, None, :]
                qd = q[:, :, None, :]
                ms = time_ms(torch, lambda: paged_decode_attention(*args, **kw), flush)
                plain_ms = time_ms(torch, lambda: paged_decode_reference(*args, **kw), flush)
                lib_ms = time_ms(
                    torch,
                    lambda: F.scaled_dot_product_attention(qd, kd, vd, attn_mask=mask),
                    flush,
                )
                tokens = sum(
                    0 if n < 0 else (n + 1 if window is None else min(window, n + 1))
                    for n in lens_np.tolist()
                )
                nbytes = (
                    tokens * Hkv * 2 * (Dh * elem + scale_elem)   # live K/V (+scales)
                    + 2 * q.numel() * q.element_size()             # q in, out
                    + table.numel() * 4 + lens.numel() * 4
                )
                flops = 4 * H * Dh * tokens                        # QK and PV
                t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
                t_ops = flops / BF16_FLOPS * 1e3
                case = dict(
                    shape=shape, pool=family, window=window, max_abs_err=err,
                    tolerance=KERNEL_TOL, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                    live_bytes=nbytes, bound_ms=max(t_bytes, t_ops),
                    bound_by="bytes" if t_bytes >= t_ops else "operations",
                )
                cases.append(case)
                print(
                    f"kernel paged_decode {shape:8s} {family:4s} window={window!s:5s} "
                    f"err={err:.3e} (tol {KERNEL_TOL}) ms={ms:.4f} plain_ms={plain_ms:.4f} "
                    f"library_ms={lib_ms:.4f} bound_ms={case['bound_ms']:.5f} "
                    f"live_bytes={nbytes}",
                    flush=True,
                )
    return cases


def chunk_kernel_phase(torch, flush) -> list[dict]:
    """The paged chunk kernel against its plain version at the main path's
    shapes (and a long-context one), for every pool family, window off and
    200."""
    from beholder_tpu_torch.ops.paged_attention import (
        paged_chunk_attention,
        paged_chunk_reference,
    )
    from beholder_tpu_torch.ops.quant import pool_quantize, pool_scales_f32

    dev = torch.device("cuda")
    F = torch.nn.functional
    H, Hkv, Dh = 8, 2, 64
    shapes = {
        # a fused wave: 8 requests of 256 tokens, an empty paged context,
        # ctx_len = t_max as the fused admission passes it
        "wave": dict(S=8, W=256, page=128, N=32, P=1, lens=[0] * 8, ctx_len=256),
        # a warm prefix admit: one 128-token suffix over one cached page
        "warm": dict(S=1, W=128, page=128, N=32, P=1, lens=[128]),
        # long context: 512-token pages, 8 per slot, a 128-token chunk
        "long": dict(S=8, W=128, page=512, N=64, P=8,
                     lens=[3584, 3600, 3620, 3640, 3660, 3680, 3700, 3711]),
        # off the main path: spec verify's width (ctx_len = P*page, the
        # chunk's tail dropped past it) and lengths past live_pages (zeros)
        "edge": dict(S=4, W=64, page=128, N=32, P=3, lens=[0, 200, 300, 360],
                     ctx_len=384, live_pages=2),
    }
    cases = []
    for shape, c in shapes.items():
        rng = np.random.default_rng(11)
        S, W, page, N, P = (c[k] for k in ("S", "W", "page", "N", "P"))
        ctx_len = c.get("ctx_len", P * page + W)
        live_pages = c.get("live_pages", P)
        lens_np = np.asarray(c["lens"], np.int32)

        def normal(*shape_):
            return torch.from_numpy(rng.normal(0, 1, shape_).astype(np.float32)).to(dev)

        q = normal(S, H, W, Dh).bfloat16()
        kc = normal(S, Hkv, W, Dh).bfloat16()
        vc = normal(S, Hkv, W, Dh).bfloat16()
        k_f, v_f = normal(N, Hkv, Dh, page), normal(N, Hkv, Dh, page)
        table = torch.from_numpy(
            rng.permutation(N)[: S * P].reshape(S, P).astype(np.int32)).to(dev)
        lens = torch.from_numpy(lens_np).to(dev)
        for family in ("bf16", "int8", "fp8"):
            if family == "bf16":
                kp, vp, ks, vs = k_f.bfloat16(), v_f.bfloat16(), None, None
                elem, scale_elem = 2, 0
            else:
                dt = torch.int8 if family == "int8" else torch.float8_e4m3fn
                kp, ks = pool_quantize(k_f, axis=-2, values_dtype=dt)
                vp, vs = pool_quantize(v_f, axis=-2, values_dtype=dt)
                elem, scale_elem = 1, ks.element_size()
            for window in (None, 200):
                args = (q, kc, vc, kp, vp, table, lens)
                kw = dict(ctx_len=ctx_len, live_pages=live_pages, window=window,
                          k_scale=ks, v_scale=vs)
                out_k = paged_chunk_attention(*args, **kw)
                out_p = paged_chunk_reference(*args, **kw)
                torch.cuda.synchronize()
                where = f"chunk {shape}/{family}/window={window}"
                check(bool(torch.isfinite(out_k.float()).all()), f"{where}: non-finite")
                plain = out_p.float()
                diff = (out_k.float() - plain).abs()
                err = float(diff.max())
                excess = diff - CHUNK_RTOL * plain.abs()
                row_rms = plain.square().mean(-1, keepdim=True).sqrt()
                # the excess over the rtol term in units of its row's RMS
                reading = float((excess / row_rms.clamp_min(1e-30)).max())
                check(reading <= CHUNK_ATOL_RMS,
                      f"{where}: max abs err {err}, excess over {CHUNK_RTOL}|plain| "
                      f"{reading} x row RMS > {CHUNK_ATOL_RMS}")
                # library yardstick: SDPA on the pre-assembled dense context
                # (committed pages dequantized, the chunk overlaid, heads
                # expanded) with the per-row causal mask; assembly excluded
                def dense(pool, scales, chunk):
                    vals = pool.float() if scales is None else (
                        pool.float() * pool_scales_f32(scales)[:, :, None, :])
                    g = vals.bfloat16()[table[:, :live_pages].long()].permute(0, 2, 1, 4, 3)
                    g = g.reshape(S, Hkv, live_pages * page, Dh)
                    pad = ctx_len - live_pages * page + W
                    g = torch.cat([g, torch.zeros(S, Hkv, pad, Dh, dtype=g.dtype, device=dev)], 2)
                    for s_ in range(S):
                        n = int(lens_np[s_])
                        g[s_, :, n : n + W] = chunk[s_]
                    return g[:, :, :ctx_len].repeat_interleave(H // Hkv, dim=1)

                kd, vd = dense(kp, ks, kc), dense(vp, vs, vc)
                pos = torch.arange(ctx_len, device=dev)
                pos_w = lens[:, None].long() + torch.arange(W, device=dev)
                mask = pos[None, None, :] <= pos_w[:, :, None]
                if window is not None:
                    mask = mask & (pos[None, None, :] > pos_w[:, :, None] - window)
                mask = mask[:, None]
                ms = time_ms(torch, lambda: paged_chunk_attention(*args, **kw), flush)
                plain_ms = time_ms(torch, lambda: paged_chunk_reference(*args, **kw), flush)
                lib_ms = time_ms(
                    torch, lambda: F.scaled_dot_product_attention(q, kd, vd, attn_mask=mask),
                    flush,
                )
                # the bound counts what this data needs: each row j sees
                # positions max(0, lens+j-window+1)..lens+j; the context
                # read is the committed positions some row can see
                ctx_tokens = sum(  # pages read: committed, live, in some row's window
                    max(0, min(n, live_pages * page)
                        - (0 if window is None else max(0, n - window + 1)))
                    for n in lens_np.tolist()
                )
                visible = sum(
                    min(n + j + 1, ctx_len)
                    - (0 if window is None else max(0, n + j - window + 1))
                    for n in lens_np.tolist() for j in range(W)
                )
                nbytes = (
                    2 * q.numel() * 2                              # q in, out
                    + 2 * kc.numel() * 2                           # chunk k, v
                    + ctx_tokens * Hkv * 2 * (Dh * elem + scale_elem)
                    + table.numel() * 4 + lens.numel() * 4
                )
                flops = 4 * H * Dh * visible                       # QK and PV
                t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
                t_ops = flops / BF16_FLOPS * 1e3
                case = dict(
                    shape=shape, pool=family, window=window, max_abs_err=err,
                    max_excess=float(excess.max()), excess_per_row_rms=reading,
                    plain_rms=float(plain.square().mean().sqrt()),
                    tolerance=dict(rtol=CHUNK_RTOL, atol_row_rms=CHUNK_ATOL_RMS),
                    ms=ms, plain_ms=plain_ms,
                    library_ms=lib_ms, bytes=nbytes, flops=flops,
                    bound_ms=max(t_bytes, t_ops),
                    bound_by="bytes" if t_bytes >= t_ops else "operations",
                )
                cases.append(case)
                print(
                    f"kernel paged_chunk {shape:5s} {family:4s} window={window!s:5s} "
                    f"err={err:.3e} excess={case['max_excess']:.3e} "
                    f"excess/row_rms={reading:.3e} (tol {CHUNK_RTOL:.5f}|plain| + "
                    f"{CHUNK_ATOL_RMS} row_rms) plain_rms={case['plain_rms']:.3e} "
                    f"ms={ms:.4f} plain_ms={plain_ms:.4f} library_ms={lib_ms:.4f} "
                    f"bound_ms={case['bound_ms']:.5f} ({case['bound_by']}) "
                    f"bytes={nbytes} flops={flops}",
                    flush=True,
                )
    return cases


#: flash kernels vs their plain versions, per output, in units of the plain
#: output row's RMS over the head dim: max |kernel - plain| / row RMS. The
#: forward kernel runs the softmax online over 64-key tiles and rounds each
#: unnormalised weight to bf16, the plain forward the whole row's: o read up
#: to 0.033 over the five cases (NVIDIA H100 80GB HBM3, 700 W; PERF.md), and
#: its limit is ~3x that; a forward that drops one 64-key tile must read
#: above 3x the limit (checked on the training case). The backward kernels
#: round p and ds as their plain versions do and read 0 (bitwise) in all five
#: cases (7.5e-4 at a 200-token probe shape): their limit, 0.01, is ~2.5
#: bf16 ULPs at the row's RMS. lse (f32, ~8-10 at T=4096) read up to 1.9e-6,
#: two f32 ULPs (non-causal): limit 6e-6.
FLASH_TOL_RMS = {"o": 0.09, "dq": 0.01, "dk": 0.01, "dv": 0.01}
FLASH_LSE_ATOL = 6e-6
#: the training shape of the flash kernels: B streams of T events, 8 heads
#: over 2 kv heads, head dim 64 (dim 512 / 8 heads)
FLASH_SHAPE = dict(B=4, H=8, Hkv=2, T=4096, Dh=64)
FLASH_CASES = {
    "train": dict(causal=True),
    "window512": dict(causal=True, window=512),
    "noncausal": dict(causal=False),
    "segments": dict(causal=True, segments=4),
    "t4000": dict(causal=True, T=4000),
}


def flash_pairs(T: int, causal: bool, window, seg) -> int:
    """(query, key) pairs one head attends: what this data needs."""
    if seg is not None:
        i = np.arange(T)
        n = 0
        for row in seg:
            same = row[:, None] == row[None, :]
            if causal:
                same &= i[:, None] >= i[None, :]
            n += int(same.sum())
        return n // len(seg)
    if not causal:
        return T * T
    seen = np.arange(1, T + 1)
    return int(np.minimum(seen, window).sum() if window else seen.sum())


def row_reading(got, want) -> float:
    """max |got - want| over the plain output row's RMS (head dim last)."""
    want = want.float()
    rms = want.square().mean(-1, keepdim=True).sqrt().clamp_min(1e-30)
    return float(((got.float() - want).abs() / rms).max())


def flash_kernel_phase(torch, flush) -> list[dict]:
    """The three flash kernels against their plain versions at the training
    shape, causal, with a window, non-causal, with segment ids and at an
    unaligned T; times of each kernel, its plain version and SDPA (forward,
    and its backward for dq and dk/dv), beside the bound."""
    from beholder_tpu_torch.ops import flash_attention as fa

    dev = torch.device("cuda")
    F = torch.nn.functional
    cases = []
    for name, c in FLASH_CASES.items():
        shape = {**FLASH_SHAPE, **{k: v for k, v in c.items() if k in FLASH_SHAPE}}
        B, H, Hkv, T, Dh = (shape[k] for k in ("B", "H", "Hkv", "T", "Dh"))
        causal, window = c["causal"], c.get("window")
        rng = np.random.default_rng(13)

        def normal(*shape_):
            return torch.from_numpy(rng.normal(0, 1, shape_).astype(np.float32)).to(dev).bfloat16()

        q, k, v, do = normal(B * H, T, Dh), normal(B * Hkv, T, Dh), normal(B * Hkv, T, Dh), \
            normal(B * H, T, Dh)
        seg_np = None
        if "segments" in c:
            seg_np = np.sort(rng.integers(0, c["segments"], (B, T)), axis=-1).astype(np.int32)
        seg = None if seg_np is None else torch.from_numpy(seg_np).to(dev)
        kw = dict(causal=causal, window=window, segment_ids=seg)
        o, lse = fa.flash_forward(q, k, v, **kw)
        o_p, lse_p = fa.flash_forward_reference(q, k, v, **kw)
        # the backward kernels and their plain versions from the same
        # (plain) forward outputs
        delta = fa.flash_delta(o_p, do)
        bwd = (q, k, v, do, lse_p, delta)
        dq = fa.flash_backward_dq(*bwd, **kw)
        dk, dv = fa.flash_backward_dkv(*bwd, **kw)
        dq_p = fa.flash_dq_reference(*bwd, **kw)
        dk_p, dv_p = fa.flash_dkv_reference(*bwd, **kw)
        torch.cuda.synchronize()
        where = f"flash {name}"
        for t_name, t in (("o", o), ("lse", lse), ("dq", dq), ("dk", dk), ("dv", dv)):
            check(bool(torch.isfinite(t).all()), f"{where}: {t_name} not finite")
        readings = {"o": row_reading(o, o_p), "dq": row_reading(dq, dq_p),
                    "dk": row_reading(dk, dk_p), "dv": row_reading(dv, dv_p)}
        lse_err = float((lse - lse_p).abs().max())
        errs = {"o": float((o.float() - o_p.float()).abs().max()),
                "dq": float((dq.float() - dq_p.float()).abs().max()),
                "dk": float((dk.float() - dk_p.float()).abs().max()),
                "dv": float((dv.float() - dv_p.float()).abs().max()), "lse": lse_err}
        for out_name, reading in readings.items():
            check(reading <= FLASH_TOL_RMS[out_name],
                  f"{where}: {out_name} reading {reading} x row RMS > {FLASH_TOL_RMS[out_name]}")
        check(lse_err <= FLASH_LSE_ATOL, f"{where}: lse err {lse_err} > {FLASH_LSE_ATOL}")
        dropped = None
        if name == "train":
            # a plain forward that drops one 64-key tile must read above the limit
            keep = torch.ones(T, dtype=torch.bool, device=dev)
            keep[T // 2:T // 2 + 64] = False
            s = torch.matmul((q.float() / 8.0).bfloat16().float().reshape(B * Hkv, -1, T, Dh),
                             k.float()[:, None].transpose(-1, -2))
            live = torch.ones(T, T, dtype=torch.bool, device=dev).tril() & keep[None, :]
            w = torch.softmax(torch.where(live, s, -1e30), dim=-1)
            o_drop = torch.matmul(w.bfloat16().float(), v.float()[:, None]).reshape(o_p.shape)
            del s, w
            dropped = row_reading(o_drop, o_p)
            check(dropped > 3 * FLASH_TOL_RMS["o"],
                  f"{where}: a forward without one kv tile reads {dropped}, inside the limit")

        # library yardsticks: SDPA on (B, H, T, Dh) views, never called by the port
        q4, k4, v4, do4 = (t.reshape(B, -1, T, Dh) for t in (q, k, v, do))
        mask = None
        if window is not None or seg is not None:
            i = torch.arange(T, device=dev)
            mask = (i[:, None] >= i[None, :]) if causal else torch.ones(T, T, dtype=torch.bool, device=dev)
            if window is not None:
                mask = mask & (i[:, None] - i[None, :] < window)
            mask = mask[None, None]
            if seg is not None:
                mask = mask & (seg[:, None, :, None] == seg[:, None, None, :])

        def sdpa(q4=q4, k4=k4, v4=v4):
            if mask is None:
                return F.scaled_dot_product_attention(q4, k4, v4, is_causal=causal, enable_gqa=True)
            return F.scaled_dot_product_attention(q4, k4, v4, attn_mask=mask, enable_gqa=True)

        leaves = [t.detach().clone().requires_grad_() for t in (q4, k4, v4)]
        lib_out = sdpa(*leaves)

        def sdpa_bwd():
            return torch.autograd.grad(lib_out, leaves, do4, retain_graph=True)

        times = {
            "fwd": (time_ms(torch, lambda: fa.flash_forward(q, k, v, **kw), flush),
                    time_ms(torch, lambda: fa.flash_forward_reference(q, k, v, **kw), flush, reps=10),
                    time_ms(torch, sdpa, flush)),
            "dq": (time_ms(torch, lambda: fa.flash_backward_dq(*bwd, **kw), flush),
                   time_ms(torch, lambda: fa.flash_dq_reference(*bwd, **kw), flush, reps=10),
                   time_ms(torch, sdpa_bwd, flush)),
            "dkv": (time_ms(torch, lambda: fa.flash_backward_dkv(*bwd, **kw), flush),
                    time_ms(torch, lambda: fa.flash_dkv_reference(*bwd, **kw), flush, reps=10),
                    time_ms(torch, sdpa_bwd, flush)),
        }
        del lib_out, leaves
        pairs = flash_pairs(T, causal, window, seg_np)
        e = 2  # bf16 bytes
        qb, kb = B * H * T * Dh * e, B * Hkv * T * Dh * e
        rowb = B * H * T * 4  # one f32 per query row (lse, delta)
        segb = 0 if seg is None else B * T * 4
        work = {  # (bytes: each input read once, each output written once; flops)
            "fwd": (qb + 2 * kb + qb + rowb + segb, 4 * B * H * Dh * pairs),
            "dq": (qb + 2 * kb + qb + 2 * rowb + qb + segb, 6 * B * H * Dh * pairs),
            "dkv": (qb + 2 * kb + qb + 2 * rowb + 2 * kb + segb, 8 * B * H * Dh * pairs),
        }
        case = dict(case=name, B=B, H=H, Hkv=Hkv, T=T, Dh=Dh, causal=causal, window=window,
                    segments=c.get("segments"), pairs_per_head=pairs, readings=readings,
                    lse_err=lse_err, max_abs_err=errs, dropped_tile_reading=dropped,
                    tolerance=dict(row_rms=FLASH_TOL_RMS, lse_atol=FLASH_LSE_ATOL))
        for kern, (ms, plain_ms, lib_ms) in times.items():
            nbytes, flops = work[kern]
            t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / BF16_FLOPS * 1e3
            case[kern] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bytes=nbytes,
                              flops=flops, bound_ms=max(t_bytes, t_ops),
                              bound_by="bytes" if t_bytes >= t_ops else "operations")
        cases.append(case)
        print(
            f"kernel flash {name:9s} T={T} readings(x row RMS) o={readings['o']:.3e} "
            f"dq={readings['dq']:.3e} dk={readings['dk']:.3e} dv={readings['dv']:.3e} "
            f"(limits {FLASH_TOL_RMS}) lse_err={lse_err:.3e} (limit {FLASH_LSE_ATOL})"
            + ("" if dropped is None else f" dropped_tile_o_reading={dropped:.3e}"),
            flush=True,
        )
        for kern in ("fwd", "dq", "dkv"):
            r = case[kern]
            print(f"  {kern:3s} ms={r['ms']:.4f} plain_ms={r['plain_ms']:.4f} "
                  f"library_ms={r['library_ms']:.4f} bound_ms={r['bound_ms']:.5f} "
                  f"({r['bound_by']}) flops={r['flops']} bytes={r['bytes']}", flush=True)
    return cases


def make_requests(rng, Request, prefixes, horizons):
    return [
        Request(
            np.cumsum(1.0 + rng.normal(0, 0.05, t + 1)),
            np.full(t + 1, CONVERTING),
            h,
        )
        for t, h in zip(prefixes, horizons)
    ]


def count_syncs(torch, fn):
    """Run ``fn`` under ``torch.cuda.set_sync_debug_mode("warn")`` and
    count the synchronising calls it reports."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            result = fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    syncs = [w for w in caught if "synchroniz" in str(w.message)]
    sources: dict[str, int] = {}
    for w in syncs:
        where = f"{Path(w.filename).name}:{w.lineno}"
        sources[where] = sources.get(where, 0) + 1
    for where, n in sorted(sources.items(), key=lambda kv: -kv[1])[:5]:
        print(f"  sync source {where}: {n}", flush=True)
    return result, len(syncs)


#: the headline pool: 32 pages of 128 tokens, 8 slots, 4 pages per sequence
SERVE = dict(num_pages=32, page_size=128, slots=8, max_prefix=256, max_pages_per_seq=4)
#: the horizons of ``run``'s 12 requests (more requests than slots)
RUN_HORIZONS = [128, 96, 64, 32, 128, 80, 48, 16, 128, 100, 60, 20]


def counted(torch, fn):
    """Run ``fn`` with both kernels' launch counts set to 0 just before and
    read just after, counting its synchronising calls. Returns (result,
    syncs, decode launches, chunk launches)."""
    from beholder_tpu_torch.ops.paged_attention import (
        paged_chunk_attention,
        paged_decode_attention,
    )

    torch.cuda.synchronize()
    paged_decode_attention.launches = 0
    paged_chunk_attention.launches = 0
    result, syncs = count_syncs(torch, fn)
    decode, chunk = paged_decode_attention.launches, paged_chunk_attention.launches
    torch.cuda.synchronize()
    return result, syncs, decode, chunk


def timed(torch, fn, runs: int = TIMED_RUNS) -> list[float]:
    """Host seconds of ``runs`` calls, each ended by a synchronise."""
    out = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append(time.perf_counter() - t0)
    return out


def check_served(torch, where, b, reqs, results, want, band) -> float:
    """Pages home, no flag, no slot left active, each forecast finite and of
    its horizon, its first two steps inside ``band`` of the dense oracle.
    Returns the largest first-two-step error."""
    rtol, atol = band
    check(not bool(b.state.alloc_failed), f"{where}: alloc_failed")
    check(not bool(b.state.active.any()), f"{where}: slots left active")
    worst = 0.0
    for i, (req, w) in enumerate(zip(reqs, want)):
        got = results[i]
        got = got.cpu().numpy() if torch.is_tensor(got) else got
        check(got.shape == (req.horizon,), f"{where}: request {i} shape {got.shape}")
        check(bool(np.isfinite(got).all()), f"{where}: request {i} not finite")
        ok = np.abs(got[:2] - w) <= atol + rtol * np.abs(w)
        check(bool(ok.all()), f"{where}: request {i} first steps {got[:2]} vs oracle {w}")
        worst = max(worst, float(np.abs(got[:2] - w).max()))
    return worst


def main_path(torch, profile: bool = False) -> dict:
    from beholder_tpu_torch.cache import PrefixCache
    from beholder_tpu_torch.models import TelemetrySequenceModel, forecast_deltas
    from beholder_tpu_torch.models.bridge import init_params, load_flax_params
    from beholder_tpu_torch.models.serving import ContinuousBatcher, Request

    layers = 4
    model = TelemetrySequenceModel(dim=512, heads=8, kv_heads=2, layers=layers)
    load_flax_params(model, init_params(model, seed=0, bf16_matrices=True))
    rng = np.random.default_rng(0)
    wave_reqs = make_requests(rng, Request, [256] * 8, [128] * 8)
    run_reqs = make_requests(rng, Request, [256] * 12, RUN_HORIZONS)
    # the prefix-cache traffic: run's horizons, every request sharing its
    # first 129 progress samples (page 0 of its features) and statuses
    prefix_reqs = make_requests(rng, Request, [256] * 12, RUN_HORIZONS)
    shared = prefix_reqs[0].progress[:129]
    prefix_reqs = [
        Request(np.concatenate([shared, r.progress[129:] - r.progress[128] + shared[-1]]),
                r.statuses, r.horizon)
        for r in prefix_reqs
    ]

    # the dense oracle's first two steps, once per request
    def oracle(req):
        return forecast_deltas(
            model,
            torch.from_numpy(np.asarray(req.progress))[None].cuda(),
            torch.from_numpy(np.asarray(req.statuses))[None].cuda(),
            2,
        )[0].cpu().numpy()

    want_wave = [oracle(r) for r in wave_reqs]
    want_run = [oracle(r) for r in run_reqs]
    want_prefix = [oracle(r) for r in prefix_reqs]
    # what the sync counter reports around nothing (torch's own first use)
    _, baseline = count_syncs(torch, lambda: None)
    print(f"sync_calls around an empty call: {baseline}", flush=True)
    report = {}
    for family in ("bf16", "int8", "fp8"):
        band = FORECAST_BAND[family]
        dense_waves = None
        for mode in ("run_waves", "run", "fused_waves"):
            where = f"{family}/{mode}"
            reqs, want = (run_reqs, want_run) if mode == "run" else (wave_reqs, want_wave)
            b = ContinuousBatcher(model, **SERVE, cache_dtype=family,
                                  fused_wave=mode == "fused_waves")

            def serve():
                if mode == "run":
                    return b.run(reqs)
                return b.run_waves(reqs, device_results=True)

            # a warm-up run takes the process's one-time set-up (cuBLAS
            # handles, pinned-memory pools) out of the counted run
            serve()
            ticks0 = b.ticks
            results, syncs, launches, chunk = counted(torch, serve)
            ticks = b.ticks - ticks0
            # waves of up to `slots` requests; this traffic fits one pool
            waves = 0 if mode == "run" else -(-len(reqs) // b.slots)
            check(launches > 0, f"{where}: the paged kernel never launched")
            check(launches == layers * ticks,
                  f"{where}: {launches} kernel launches for {ticks} ticks x {layers} layers")
            want_chunk = layers * waves if mode == "fused_waves" else 0
            check(chunk == want_chunk,
                  f"{where}: {chunk} chunk kernel launches, expected {want_chunk}")
            check(int(b.state.free_top) == b.num_pages,
                  f"{where}: free_top {int(b.state.free_top)} != {b.num_pages}")
            worst = check_served(torch, where, b, reqs, results, want, band)
            got = np.stack([r.cpu().numpy() for r in results]) if mode != "run" else None
            if mode == "run_waves":
                dense_waves = got
            vs_dense = (float(np.abs(got - dense_waves).max())
                        if mode == "fused_waves" else None)
            runs = timed(torch, serve)
            seconds = statistics.median(runs)
            tokens = sum(r.horizon for r in reqs)
            report[where] = dict(
                launches=launches, chunk_launches=chunk, ticks=ticks, waves=waves,
                syncs=syncs, seconds=seconds, tokens=tokens,
                tokens_per_s=tokens / seconds,
                tokens_per_s_range=(tokens / max(runs), tokens / min(runs)),
                first_steps_max_err=worst, band=band, max_diff_vs_dense_waves=vs_dense,
            )
            print(
                f"serve {family:4s} {mode:11s} requests={len(reqs)} tokens={tokens} "
                f"seconds={seconds:.4f} tokens/s={tokens / seconds:.1f} "
                f"(range {tokens / max(runs):.1f}-{tokens / min(runs):.1f} "
                f"over {TIMED_RUNS} runs) ticks={ticks} waves={waves} "
                f"kernel_launches={launches} chunk_launches={chunk} sync_calls={syncs} "
                f"first2_max_err={worst:.3e} (band rtol {band[0]}, atol {band[1]})"
                + ("" if vs_dense is None else f" max_diff_vs_dense_waves={vs_dense:.3e}")
                + " pages_home=yes",
                flush=True,
            )
        report.update(prefix_path(torch, ContinuousBatcher, PrefixCache, model, layers,
                                  family, prefix_reqs, want_prefix, band))
        if profile and family == "bf16":
            b = ContinuousBatcher(model, **SERVE)
            report["profile"] = profile_waves(
                torch, b, wave_reqs, report["bf16/run_waves"]["seconds"]
            )
    report.update(what_if_path(torch, ContinuousBatcher, model, layers, Request))
    return report


def prefix_path(torch, ContinuousBatcher, PrefixCache, model, layers, family, reqs,
                want, band) -> dict:
    """``run`` with a prefix cache and ``fused_verify=True``: a cold pass,
    then a warm pass on the same batcher, each counted; then a full
    eviction; then timed cold and warm passes on fresh batchers."""

    def make():
        return ContinuousBatcher(model, **SERVE, cache_dtype=family,
                                 prefix_cache=PrefixCache(SERVE["page_size"]),
                                 fused_verify=True)

    # a throwaway pass takes one-time set-up out of the counted cold pass
    make().run(reqs)
    b = make()
    cache = b.prefix_cache
    out = {}
    for pass_ in ("cold", "warm"):
        where = f"{family}/prefix_{pass_}"
        hits0, ticks0, rounds0 = cache.hits, b.ticks, b.admission_rounds
        results, syncs, launches, chunk = counted(torch, lambda: b.run(reqs))
        hits, ticks = cache.hits - hits0, b.ticks - ticks0
        n_rounds = b.admission_rounds - rounds0
        check(syncs == 1 + n_rounds,
              f"{where}: {syncs} synchronising calls for {n_rounds} admission rounds "
              "(1 readback at the end, 1 page-table readback per round)")
        check(launches == layers * ticks,
              f"{where}: {launches} kernel launches for {ticks} ticks x {layers} layers")
        check(chunk == layers * hits,
              f"{where}: {chunk} chunk kernel launches for {hits} warm admits x {layers} layers")
        if pass_ == "warm":
            check(hits == len(reqs), f"{where}: {hits} hits for {len(reqs)} requests")
        check(int(b.state.free_top) == b.num_pages - cache.page_count,
              f"{where}: free_top {int(b.state.free_top)} != {b.num_pages} - "
              f"{cache.page_count} cached pages")
        worst = check_served(torch, where, b, reqs, results, want, band)
        out[where] = dict(launches=launches, chunk_launches=chunk, ticks=ticks,
                          warm_admits=hits, rounds=n_rounds, syncs=syncs,
                          cached_pages=cache.page_count, first_steps_max_err=worst,
                          band=band)
    check(cache.hits > 0, f"{family}/prefix: no prefix hit")
    b._evict_cached(cache.page_count)
    check(cache.page_count == 0 and int(b.state.free_top) == b.num_pages,
          f"{family}/prefix: free_top {int(b.state.free_top)} after a full eviction")
    check(int(b.state.page_ref.sum()) == 0, f"{family}/prefix: references left")
    # timed passes: each fresh batcher serves a cold pass, then a warm one
    cold_s, warm_s = [], []
    for _ in range(TIMED_RUNS):
        fresh = make()
        cold_s += timed(torch, lambda: fresh.run(reqs), runs=1)
        warm_s += timed(torch, lambda: fresh.run(reqs), runs=1)
    tokens = sum(r.horizon for r in reqs)
    for pass_, runs in (("cold", cold_s), ("warm", warm_s)):
        where = f"{family}/prefix_{pass_}"
        seconds = statistics.median(runs)
        out[where].update(seconds=seconds, tokens=tokens, tokens_per_s=tokens / seconds,
                          tokens_per_s_range=(tokens / max(runs), tokens / min(runs)))
        r = out[where]
        print(
            f"serve {family:4s} prefix_{pass_:5s} requests={len(reqs)} tokens={tokens} "
            f"seconds={seconds:.4f} tokens/s={tokens / seconds:.1f} "
            f"(range {tokens / max(runs):.1f}-{tokens / min(runs):.1f} over {TIMED_RUNS} "
            f"runs) ticks={r['ticks']} warm_admits={r['warm_admits']} "
            f"admission_rounds={r['rounds']} kernel_launches={r['launches']} "
            f"chunk_launches={r['chunk_launches']} sync_calls={r['syncs']} "
            f"cached_pages={r['cached_pages']} first2_max_err={r['first_steps_max_err']:.3e} "
            f"(band rtol {band[0]}, atol {band[1]}) pages_home_after_eviction=yes",
            flush=True,
        )
    return out


def what_if_path(torch, ContinuousBatcher, model, layers, Request) -> dict:
    """One ``run_what_if`` with 4 branches (bf16 pool) against four
    independent admissions of the same prefix, one per branch status
    (``serve_wave``), and its observed-status branch against ``run``."""
    from beholder_tpu_torch.models.serving import serve_wave

    rng = np.random.default_rng(5)
    # 200 steps: one full shared page and a tail page each fork copies
    (req,) = make_requests(rng, Request, [200], [128])
    branches = [CONVERTING, DEPLOYED, ERRORED, QUEUED]
    horizon = req.horizon
    band = FORECAST_BAND["bf16"]
    b = ContinuousBatcher(model, **SERVE)

    def what_if():
        return b.run_what_if(req.progress, req.statuses, branches, horizon)

    what_if()
    got, syncs, launches, chunk = counted(torch, what_if)
    check(got.shape == (len(branches), horizon), f"what_if: shape {got.shape}")
    check(bool(np.isfinite(got).all()), "what_if: not finite")
    check(launches == layers * (horizon - 1),
          f"what_if: {launches} kernel launches for {horizon - 1} ticks x {layers} layers")
    check(chunk == 0, f"what_if: {chunk} chunk kernel launches")
    check(int(b.state.free_top) == b.num_pages, "what_if: pages not home")

    ind = ContinuousBatcher(model, **SERVE)
    feats, t = ind._prep_np(req)
    t_pad = -(-t // ind.page_size) * ind.page_size
    with torch.no_grad():
        want, ind.state = serve_wave(
            model, ind.state,
            ind._up(np.stack([ind._pad_to(feats, t_pad)] * len(branches))),
            ind._up(np.full(len(branches), t, np.int32)),
            ind._up(np.asarray(branches, np.int64)), horizon - 1,
        )
    want = want.cpu().numpy()
    rtol, atol = band
    ok = np.abs(got - want) <= atol + rtol * np.abs(want)
    check(bool(ok.all()), "what_if: branches outside the band of independent admissions")
    vs_independent = float(np.abs(got - want).max())
    (alone,) = ContinuousBatcher(model, **SERVE).run([req])
    check(bool((np.abs(got[0] - alone) <= atol + rtol * np.abs(alone)).all()),
          "what_if: the observed-status branch is outside the band of run()")
    runs = timed(torch, what_if)
    seconds = statistics.median(runs)
    tokens = len(branches) * horizon
    print(
        f"serve bf16 what_if branches={len(branches)} horizon={horizon} tokens={tokens} "
        f"seconds={seconds:.4f} tokens/s={tokens / seconds:.1f} kernel_launches={launches} "
        f"sync_calls={syncs} max_diff_vs_independent={vs_independent:.3e} "
        f"max_diff_branch0_vs_run={float(np.abs(got[0] - alone).max()):.3e} "
        f"(band rtol {rtol}, atol {atol}) pages_home=yes",
        flush=True,
    )
    return {"bf16/what_if": dict(
        launches=launches, chunk_launches=chunk, ticks=horizon - 1, syncs=syncs,
        seconds=seconds, tokens=tokens, tokens_per_s=tokens / seconds,
        max_diff_vs_independent=vs_independent, band=band,
    )}


def dev_us(e) -> float:
    """A profiler row's own device time, in microseconds."""
    return getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0))


def device_rows(events) -> list:
    """The profiler's device rows (kernels, copies, fills). An operator's
    row repeats the device time of the kernels it launched, so only these
    rows add up to the time the device was busy."""
    from torch.autograd import DeviceType

    return [e for e in events if e.device_type == DeviceType.CUDA]


#: the training path: the headline model with flash attention, B streams of
#: T progress events per step, and the checks' step counts
TRAIN_MODEL = dict(dim=512, heads=8, kv_heads=2, layers=4, attention="flash")
TRAIN_B, TRAIN_T, TRAIN_STEPS, SIDE_STEPS = 4, 4096, 20, 3
#: flash step-1 gradients against attention="full":
#: tests/test_sequence_model.py:131 (rtol 5e-2, atol 5e-2)
GRAD_BAND = (5e-2, 5e-2)
FLASH_KERNEL_NAMES = ("flash_fwd_kernel", "flash_dq_kernel", "flash_dkv_kernel")


def flash_counts(fa) -> tuple[int, int, int]:
    return fa.flash_forward.launches, fa.flash_backward_dq.launches, fa.flash_backward_dkv.launches


def counted_flash(torch, fa, fn):
    """Run ``fn`` with the three flash launch counts set to 0 just before
    and read just after. Returns (result, (forward, dq, dk/dv))."""
    torch.cuda.synchronize()
    fa.flash_forward.launches = fa.flash_backward_dq.launches = 0
    fa.flash_backward_dkv.launches = 0
    result = fn()
    counts = flash_counts(fa)
    torch.cuda.synchronize()
    return result, counts


def train_streams(torch, seed: int, batch: int, t: int):
    """(feats, targets) on the card for ``batch`` encode jobs of ``t``
    progress events each (steady progress with noise, CONVERTING)."""
    from beholder_tpu_torch.models import stream_features

    rng = np.random.default_rng(seed)
    progress = np.cumsum(1.0 + rng.normal(0, 0.05, (batch, t + 1)), axis=-1)
    statuses = np.full((batch, t + 1), CONVERTING)
    return stream_features(torch.from_numpy(progress).cuda(), torch.from_numpy(statuses).cuda())


def step_grads(torch, model, feats, targets) -> dict:
    """One forward and backward of ``seq_loss``: the gradients by name."""
    from beholder_tpu_torch.models import seq_loss

    model.zero_grad(set_to_none=True)
    seq_loss(model, feats, targets).backward()
    return {n: p.grad.detach().clone() for n, p in model.named_parameters()}


def train_path(torch, flash_cases: list[dict]) -> dict:
    """The training main path: init_seq_state, then TRAIN_STEPS seq_train_steps
    of the headline model with flash attention (counted, timed per step with
    CUDA events, one profiled step); flash step-1 gradients against
    attention="full"; remat and a window for SIDE_STEPS steps; checkpoint
    save, restore and one more step, bitwise against the uninterrupted run."""
    from beholder_tpu_torch.models import (
        TelemetrySequenceModel, init_seq_state, restore_state, save_state, seq_train_step,
    )
    from beholder_tpu_torch.models.bridge import init_params, load_flax_params
    from beholder_tpu_torch.ops import flash_attention as fa

    layers = TRAIN_MODEL["layers"]
    feats, targets = train_streams(torch, 0, TRAIN_B, TRAIN_T)
    tokens = TRAIN_B * TRAIN_T
    report = {}

    # 1. the main run: init and TRAIN_STEPS steps, every launch counted
    state = init_seq_state(0, TelemetrySequenceModel(**TRAIN_MODEL))
    n_params = sum(p.numel() for p in state.model.parameters())
    events = []

    def run():
        nonlocal state
        losses = []
        for _ in range(TRAIN_STEPS):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            state, loss = seq_train_step(state, feats, targets)
            end.record()
            events.append((start, end))
            losses.append(loss)
        return torch.stack(losses).cpu().numpy()

    t0 = time.perf_counter()
    losses, launches = counted_flash(torch, fa, run)
    wall = time.perf_counter() - t0
    step_ms = [s.elapsed_time(e) for s, e in events]
    steady_ms = statistics.median(step_ms[1:])
    check(bool(np.isfinite(losses).all()), f"train: losses not finite {losses}")
    check(losses[-1] < 0.7 * losses[0],
          f"train: last loss {losses[-1]} not below 0.7 x the first {losses[0]}")
    want = (layers * TRAIN_STEPS,) * 3
    check(launches == want, f"train: flash launches (fwd, dq, dkv) {launches}, expected {want}")
    dims = " ".join(f"{k}={v}" for k, v in TRAIN_MODEL.items())
    print(f"train {dims} params={n_params} "
          f"B={TRAIN_B} T={TRAIN_T} steps={TRAIN_STEPS} loss {losses[0]:.4e} -> {losses[-1]:.4e} "
          f"launches(fwd,dq,dkv)={launches} step_ms median(2..)={steady_ms:.2f} "
          f"first={step_ms[0]:.2f} tokens/s={tokens / steady_ms * 1e3:.1f} wall_s={wall:.2f}",
          flush=True)
    # the kernels' share of a step, from the kernel phase's times at this shape
    train_case = next(c for c in flash_cases if c["case"] == "train")
    kernel_ms = layers * sum(train_case[k]["ms"] for k in ("fwd", "dq", "dkv"))
    report["train"] = dict(
        params=n_params, batch=TRAIN_B, T=TRAIN_T, steps=TRAIN_STEPS, losses=losses.tolist(),
        launches=dict(zip(("fwd", "dq", "dkv"), launches)), step_ms=step_ms,
        step_ms_median=steady_ms, tokens_per_step=tokens, tokens_per_s=tokens / steady_ms * 1e3,
        flash_ms_per_step_from_kernel_phase=kernel_ms,
        flash_share_from_kernel_phase=kernel_ms / steady_ms,
    )
    prof, (state, _) = profile_step(torch, lambda: seq_train_step(state, feats, targets),
                                    steady_ms)
    report["train"].update(prof)

    # 2. checkpoint: save, step; restore into a fresh state, step: bitwise
    ckpt = OUT / "train_state.pt"  # ~132 MB at full width: removed right after
    OUT.mkdir(exist_ok=True)
    try:
        save_state(ckpt, state)
        state, loss_a = seq_train_step(state, feats, targets)
        restored = restore_state(ckpt, init_seq_state(1, TelemetrySequenceModel(**TRAIN_MODEL)))
    finally:
        ckpt.unlink(missing_ok=True)
    check(restored.step == state.step - 1, f"checkpoint: step {restored.step}")
    restored, loss_b = seq_train_step(restored, feats, targets)
    same = torch.equal(loss_a, loss_b) and all(
        torch.equal(a, b) for a, b in zip(state.model.parameters(), restored.model.parameters()))
    check(same, "checkpoint: the resumed step is not bitwise the uninterrupted one")
    report["checkpoint"] = dict(step=restored.step, bitwise=same)
    print(f"train checkpoint save/restore at step {restored.step - 1}, one more step: "
          f"bitwise=yes", flush=True)
    del state, restored

    # 3. step-1 gradients, flash against full attention, B=1
    f1, t1 = train_streams(torch, 1, 1, TRAIN_T)
    params = init_params(TelemetrySequenceModel(**TRAIN_MODEL), 2)
    models = {}
    for attention in ("flash", "full"):
        m = TelemetrySequenceModel(**{**TRAIN_MODEL, "attention": attention})
        load_flax_params(m, params)
        models[attention] = m.requires_grad_(True)
    g_flash = step_grads(torch, models["flash"], f1, t1)
    g_full = step_grads(torch, models["full"], f1, t1)
    rtol, atol = GRAD_BAND
    worst = max(float(((g_flash[n] - g_full[n]).abs() - rtol * g_full[n].abs()).max())
                for n in g_full)
    check(worst <= atol, f"grads: flash vs full excess {worst} over rtol {rtol} > atol {atol}")
    print(f"train grads B=1 T={TRAIN_T}: flash vs full max excess over {rtol}|full| = "
          f"{worst:.3e} (atol {atol})", flush=True)
    report["grads_vs_full"] = dict(max_excess=worst, band=GRAD_BAND)
    del models

    # 4. remat: step-1 gradients bitwise no-remat's, forward launches doubled
    plain = TelemetrySequenceModel(**TRAIN_MODEL)
    remat = TelemetrySequenceModel(**TRAIN_MODEL, remat=True)
    for m in (plain, remat):
        load_flax_params(m, params)
        m.requires_grad_(True)
    g_plain = step_grads(torch, plain, feats, targets)
    g_remat, remat_launches = counted_flash(torch, fa, lambda: step_grads(torch, remat, feats, targets))
    same = all(torch.equal(g_plain[n], g_remat[n]) for n in g_plain)
    check(same, "remat: step-1 gradients differ from no-remat")
    check(remat_launches == (2 * layers, layers, layers),
          f"remat: launches {remat_launches} for one step, expected {(2 * layers, layers, layers)}")
    del plain, g_plain, g_remat
    report.update(side_run(torch, fa, "remat", remat, feats, targets, (2 * layers, layers, layers)))
    del remat
    windowed = TelemetrySequenceModel(**TRAIN_MODEL, window=512)
    load_flax_params(windowed, params)
    report.update(side_run(torch, fa, "window512", windowed, feats, targets,
                           (layers, layers, layers)))
    return report


def side_run(torch, fa, name, model, feats, targets, per_step) -> dict:
    """SIDE_STEPS steps of ``model`` (gradients on, fresh Adam): finite
    losses and ``per_step`` flash launches (fwd, dq, dk/dv) per step."""
    from beholder_tpu_torch.models import seq_train_step
    from beholder_tpu_torch.models.train import init_state

    state = init_state(model)

    def run():
        nonlocal state
        losses = []
        for _ in range(SIDE_STEPS):
            state, loss = seq_train_step(state, feats, targets)
            losses.append(loss)
        return torch.stack(losses).cpu().numpy()

    t0 = time.perf_counter()
    losses, launches = counted_flash(torch, fa, run)
    seconds = time.perf_counter() - t0
    want = tuple(SIDE_STEPS * n for n in per_step)
    check(bool(np.isfinite(losses).all()), f"{name}: losses not finite {losses}")
    check(launches == want, f"{name}: flash launches {launches}, expected {want}")
    print(f"train {name}: {SIDE_STEPS} steps losses {losses.tolist()} launches(fwd,dq,dkv)="
          f"{launches} step_ms(host, mean)={seconds / SIDE_STEPS * 1e3:.2f}", flush=True)
    return {name: dict(losses=losses.tolist(), launches=launches,
                       step_ms_host_mean=seconds / SIDE_STEPS * 1e3)}


def profile_step(torch, step, step_ms: float):
    """torch.profiler over one training step: device time by kernel, the
    flash kernels' share of it, and the device's busy share of the
    unprofiled step time ``step_ms``. Returns (that record, the step's
    result)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        result = step()
        torch.cuda.synchronize()

    events = device_rows(prof.key_averages())
    device_ms = sum(dev_us(e) for e in events) / 1e3
    flash_ms = sum(dev_us(e) for e in events
                   if any(k in e.key for k in FLASH_KERNEL_NAMES)) / 1e3
    top = sorted(events, key=dev_us, reverse=True)[:8]
    out = dict(profiled_device_ms=device_ms, profiled_flash_ms=flash_ms,
               flash_share=flash_ms / device_ms if device_ms else None,
               device_busy_share=device_ms / step_ms if device_ms else None,
               top_device=[(e.key, e.count, dev_us(e) / 1e3) for e in top])
    print(f"profile train step: device_ms={device_ms:.2f} flash_ms={flash_ms:.2f} "
          f"flash_share={out['flash_share']} busy_share={out['device_busy_share']} "
          f"(of the unprofiled {step_ms:.2f} ms step)", flush=True)
    for key, count, ms in out["top_device"]:
        print(f"  device {ms:9.3f} ms  x{count:<6d} {key[:90]}", flush=True)
    return out, result


def anomaly_path(torch) -> dict:
    """``ProgressAnomalyModel`` at ``entry()``'s shape: a forward over 256
    windows of 16 x 7 features, then 20 ``train_step``s on 256 windows of
    one job; losses finite and falling."""
    from beholder_tpu_torch.models import anomaly

    state = anomaly.init_train_state(0)
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.normal(0, 1, (256, anomaly.WINDOW * anomaly.FEATURES))
                         .astype(np.float32)).cuda()
    with torch.no_grad():
        pred = state.model(x)
    check(pred.shape == (256,) and bool(torch.isfinite(pred).all()), "anomaly: forward")
    progress = torch.from_numpy(np.cumsum(1.0 + rng.normal(0, 0.05, 256 + anomaly.WINDOW + 1)))
    windows, targets = anomaly.make_windows(progress.cuda(), torch.full((progress.shape[0],),
                                            CONVERTING, device="cuda"))
    check(windows.shape == (256, anomaly.WINDOW * anomaly.FEATURES), f"anomaly: {windows.shape}")
    losses = []
    for _ in range(20):
        state, loss = anomaly.train_step(state, windows, targets)
        losses.append(loss)
    losses = torch.stack(losses).cpu().numpy()
    check(bool(np.isfinite(losses).all()), f"anomaly: losses not finite {losses}")
    check(losses[-1] < losses[0], f"anomaly: loss did not fall {losses[0]} -> {losses[-1]}")
    print(f"anomaly forward (256, 112) -> (256,); 20 train_steps loss {losses[0]:.4e} -> "
          f"{losses[-1]:.4e}", flush=True)
    return dict(losses=losses.tolist())


def profile_waves(torch, b, reqs, wall_s: float) -> dict:
    """torch.profiler over one warm ``run_waves``: device time by kernel,
    host time by op, and the device's busy share of the unprofiled wall
    time ``wall_s``."""
    from torch.profiler import ProfilerActivity, profile

    b.run_waves(reqs, device_results=True)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        b.run_waves(reqs, device_results=True)
        torch.cuda.synchronize()

    events = prof.key_averages()
    kernel_rows = device_rows(events)
    device_ms = sum(dev_us(e) for e in kernel_rows) / 1e3
    kernels = sorted(kernel_rows, key=dev_us, reverse=True)[:8]
    host = sorted(events, key=lambda e: e.self_cpu_time_total, reverse=True)[:12]
    out = dict(
        wall_ms=wall_s * 1e3, device_ms=device_ms,
        device_busy_share=device_ms / (wall_s * 1e3),
        top_device=[(e.key, e.count, dev_us(e) / 1e3) for e in kernels],
        top_host=[(e.key, e.count, e.self_cpu_time_total / 1e3) for e in host],
    )
    print(f"profile bf16 run_waves: wall_ms={out['wall_ms']:.1f} (unprofiled) "
          f"device_ms={device_ms:.2f} device_busy_share={out['device_busy_share']:.4f}",
          flush=True)
    for key, count, ms in out["top_device"]:
        print(f"  device {ms:9.3f} ms  x{count:<6d} {key[:90]}", flush=True)
    for key, count, ms in out["top_host"]:
        print(f"  host   {ms:9.3f} ms  x{count:<6d} {key[:90]}", flush=True)
    return out


#: aggregation kernel against its plain version: counts, max and min bitwise;
#: the mean within the reference's band (tests/test_pallas_aggregate.py:19),
#: since the two sum progress in different orders
AGG_MEAN_RTOL = 1e-5
#: the aggregation kernel's shapes: the sink's flush (beholder_tpu/service.py:514),
#: bench.py's batch (bench.py:729), the 8M-event batch of
#: beholder_tpu/ops/pallas_aggregate.py:3; ragged with 1 % of statuses out of
#: range, one status absent and a misaligned start; 90 % of events in one
#: status; f32 progress; and status and progress misaligned differently (no
#: 16-byte loads). Statuses in [0, 6) and progress int32 in [0, 100] as
#: bench.py:729-732 makes them.
AGG_CASES = {
    "flush": dict(n=4096),
    "bench": dict(n=1_000_000),
    "large": dict(n=8_388_608),
    "ragged": dict(n=8_388_611, out_of_range=0.01, absent=4, offset=1),
    "skewed": dict(n=8_388_608, skew=0.9),
    "bench_f32": dict(n=1_000_000, f32=True),
    "unaligned": dict(n=1_000_003, offset=1, progress_offset=2),
}
#: the sink path: the service's default flush (beholder_tpu/service.py:514)
#: and 2**20 observations, 256 flushes
SINK_FLUSH_EVERY, SINK_EVENTS = 4096, 2**20
SINK_SKEW = [0.02, 0.02, 0.9, 0.02, 0.02, 0.02]  # 90 % CONVERTING
#: H100 SXM f32 peak outside the tensor cores (NVIDIA data sheet)
F32_FLOPS = 67e12


def agg_inputs(torch, c: dict, seed: int):
    """(statuses, progress) on the card for one AGG_CASES entry, and their
    numpy copies."""
    rng = np.random.default_rng(seed)
    n = c["n"]
    if "skew" in c:
        rest = (1 - c["skew"]) / 5
        st = rng.choice(6, size=n, p=[rest, rest, c["skew"], rest, rest, rest])
    else:
        st = rng.integers(0, 6, size=n)
    if "absent" in c:
        st[st == c["absent"]] = (c["absent"] + 1) % 6
    if "out_of_range" in c:
        bad = rng.random(n) < c["out_of_range"]
        st[bad] = rng.choice([-1, 6, 100], size=int(bad.sum()))
    st = st.astype(np.int32)
    pr = (rng.uniform(0, 100, size=n).astype(np.float32) if c.get("f32")
          else rng.integers(0, 101, size=n).astype(np.int32))

    def on_card(a, offset):  # a slice starting `offset` elements into its buffer
        buf = torch.zeros(n + offset, dtype=torch.from_numpy(a[:1]).dtype, device="cuda")
        buf[offset:] = torch.from_numpy(a).cuda()
        return buf[offset:]

    off = c.get("offset", 0)
    return on_card(st, off), on_card(pr, c.get("progress_offset", off)), st, pr


def agg_oracle(st: np.ndarray, pr: np.ndarray) -> dict:
    """count, mean, max and min per status in float64 numpy."""
    out = {k: np.zeros(6) for k in ("count", "mean_progress", "max_progress", "min_progress")}
    for s in range(6):
        sel = pr[st == s].astype(np.float64)
        if sel.size:
            out["count"][s] = sel.size
            out["mean_progress"][s] = sel.sum() / sel.size
            out["max_progress"][s], out["min_progress"][s] = sel.max(), sel.min()
    return out


def agg_agrees(got: dict, want: dict) -> tuple[bool, dict]:
    """The kernel's outputs against the plain version's: counts, max and
    min bitwise, the mean within AGG_MEAN_RTOL. Returns (agrees, the
    largest absolute difference per output)."""
    same = all(got[k].equal(want[k]) for k in ("count", "max_progress", "min_progress"))
    mean_ok = bool(((got["mean_progress"] - want["mean_progress"]).abs()
                    <= AGG_MEAN_RTOL * want["mean_progress"].abs()).all())
    diffs = {k: float((got[k].double() - want[k].double()).abs().max()) for k in got}
    return same and mean_ok, diffs


def aggregate_kernel_phase(torch, flush) -> list[dict]:
    """The aggregation kernel against its plain version (and a float64
    numpy oracle) at AGG_CASES, repeat launches bitwise, a negative control
    (the batch without its last event must fail the check), and times of
    the kernel, the plain version and a four-call PyTorch yardstick beside
    the bound."""
    from beholder_tpu_torch.ops import aggregate_telemetry, aggregate_telemetry_reference

    cases = []
    for i, (name, c) in enumerate(AGG_CASES.items()):
        st, pr, st_np, pr_np = agg_inputs(torch, c, seed=i)
        n = c["n"]
        got = aggregate_telemetry(st, pr)
        plain = aggregate_telemetry_reference(st, pr)
        again = [aggregate_telemetry(st, pr) for _ in range(3)]
        torch.cuda.synchronize()
        where = f"aggregate {name}"
        for k, v in got.items():
            check(bool(torch.isfinite(v.float()).all()), f"{where}: {k} not finite")
        agrees, diffs = agg_agrees(got, plain)
        check(agrees, f"{where}: kernel against plain version {diffs} "
                      f"(counts, max, min bitwise; mean rtol {AGG_MEAN_RTOL})")
        check(all(a[k].equal(got[k]) for a in again for k in got),
              f"{where}: repeat launches differ")
        oracle = agg_oracle(st_np, pr_np)
        vs_oracle = {k: float(np.abs(got[k].double().cpu().numpy() - oracle[k]).max())
                     for k in oracle}
        plain_vs_oracle = {k: float(np.abs(plain[k].double().cpu().numpy() - oracle[k]).max())
                           for k in oracle}
        check(vs_oracle["count"] == 0, f"{where}: counts {got['count'].tolist()} vs oracle")
        control = None
        if name == "bench":
            dropped = aggregate_telemetry(st[:-1], pr[:-1])
            control, _ = agg_agrees(dropped, plain)
            check(not control, f"{where}: the batch without its last event passes the check")
        ms = time_ms(torch, lambda: aggregate_telemetry(st, pr), flush)
        own = profile_device(torch, lambda: aggregate_telemetry(st, pr), flush)
        plain_ms = time_ms(torch, lambda: aggregate_telemetry_reference(st, pr), flush, reps=10)
        lib_ms = None
        if "out_of_range" not in c:  # index_add_ asserts on an index outside [0, 6)
            idx, pf = st.long(), pr.float()
            ones = torch.ones(n, dtype=torch.int32, device="cuda")

            def library():
                dev = st.device
                torch.zeros(6, dtype=torch.int32, device=dev).index_add_(0, idx, ones)
                torch.zeros(6, device=dev).index_add_(0, idx, pf)
                torch.full((6,), -1e9, device=dev).scatter_reduce_(0, idx, pf, "amax")
                torch.full((6,), 1e9, device=dev).scatter_reduce_(0, idx, pf, "amin")

            lib_ms = time_ms(torch, library, flush, reps=10)
            del idx, pf, ones
        nbytes = n * (st.element_size() + pr.element_size()) + 4 * 6 * 4
        ops = 4 * n  # count, sum, max and min: one update each per event
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / F32_FLOPS * 1e3
        case = dict(case=name, n=n, progress=str(pr.dtype), offset=c.get("offset", 0),
                    max_abs_err=max(diffs.values()), diffs_vs_plain=diffs,
                    vs_oracle=vs_oracle, plain_vs_oracle=plain_vs_oracle,
                    negative_control_passes=control, tolerance=dict(mean_rtol=AGG_MEAN_RTOL),
                    ms=ms, device_us_per_call=own, plain_ms=plain_ms, library_ms=lib_ms,
                    library="4 calls",
                    bytes=nbytes, ops=ops, bound_ms=max(t_bytes, t_ops),
                    bound_by="bytes" if t_bytes >= t_ops else "operations",
                    counts=got["count"].tolist())
        cases.append(case)
        print(
            f"kernel aggregate {name:9s} n={n} progress={case['progress']} "
            f"vs_plain={diffs} (counts/max/min bitwise, mean rtol {AGG_MEAN_RTOL}) "
            f"vs_f64_oracle={vs_oracle} plain_vs_f64_oracle={plain_vs_oracle} "
            f"repeat_bitwise=yes"
            + ("" if control is None else " negative_control(last event dropped)=fails_check")
            + f" ms={ms:.5f} (profiler, us per call: {own}) plain_ms={plain_ms:.4f} "
            f"library_ms(4 calls)="
            f"{'null' if lib_ms is None else f'{lib_ms:.4f}'} bound_ms={case['bound_ms']:.6f} "
            f"({case['bound_by']}) counts={case['counts']}",
            flush=True,
        )
        del st, pr, got, plain, again
    return cases


def profile_device(torch, fn, flush, calls: int = 5) -> dict:
    """Device microseconds per call of ``fn`` by profiler row (kernels,
    memsets, copies), over ``calls`` calls after one warm call, with the L2
    cache flushed before each (the flush's own row left out)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            flush.zero_()
            fn()
        torch.cuda.synchronize()
    # the aggregation path launches no fill: the fill rows are the flush's
    return {e.key[:60]: round(dev_us(e) / calls, 3)
            for e in device_rows(prof.key_averages()) if "FillFunctor" not in e.key}


def sink_summary(st: np.ndarray, pr: np.ndarray) -> dict:
    """The sink's summary of one batch, from numpy: the reference's f32
    mean (the f64 sum of at most 4096 values <= 100 is exact in f32)."""
    from beholder_tpu_torch.ops import STATUS_NAMES

    out = {}
    for s, name in enumerate(STATUS_NAMES):
        sel = pr[st == s]
        if sel.size:
            mean = np.float32(sel.sum(dtype=np.float64)) / np.float32(sel.size)
            out[name.lower()] = {"count": int(sel.size), "mean_progress": round(float(mean), 2),
                                 "max_progress": float(sel.max())}
    return out


class _Summaries(logging.Handler):
    def __init__(self):
        super().__init__(logging.INFO)
        self.summaries, self.warnings = [], []

    def emit(self, record):
        if record.levelno >= logging.WARNING:
            self.warnings.append(record.getMessage())
        else:
            self.summaries.append(record.fields["aggregate"])


def sink_logger(name: str):
    log = logging.getLogger(f"chip_smoke.{name}")
    log.handlers.clear()
    handler = _Summaries()
    log.addHandler(handler)
    log.setLevel(logging.INFO)
    log.propagate = False
    return log, handler


def sink_path(torch) -> dict:
    """The analytics main path: ``AnalyticsSink(flush_every=4096,
    async_flush=True)`` on the card takes SINK_EVENTS skewed observations
    through ``record()``, then ``flush()`` and ``drain()``, with the
    kernel's launch count set to 0 just before and read just after; every
    logged summary against the numpy oracle. Then a synchronous sink:
    synchronising calls of one flush, and flush latency."""
    from beholder_tpu_torch.analytics import AnalyticsSink
    from beholder_tpu_torch.ops import aggregate_telemetry_fused

    rng = np.random.default_rng(17)
    st = rng.choice(6, size=SINK_EVENTS, p=SINK_SKEW).astype(np.int32)
    pr = rng.integers(0, 101, size=SINK_EVENTS).astype(np.int32)
    events = list(zip(st.tolist(), pr.tolist()))
    flushes = SINK_EVENTS // SINK_FLUSH_EVERY
    want = [sink_summary(st[i * SINK_FLUSH_EVERY:(i + 1) * SINK_FLUSH_EVERY],
                         pr[i * SINK_FLUSH_EVERY:(i + 1) * SINK_FLUSH_EVERY])
            for i in range(flushes)]

    # a warm-up sink takes the process's one-time set-up (the kernel's
    # library, pinned-memory pools) out of the counted run
    warm = AnalyticsSink(flush_every=SINK_FLUSH_EVERY, logger=sink_logger("warm")[0],
                         async_flush=True)
    for s, p in events[:2 * SINK_FLUSH_EVERY]:
        warm.record(s, p)
    warm.drain()

    log, got = sink_logger("sink")
    sink = AnalyticsSink(flush_every=SINK_FLUSH_EVERY, logger=log, async_flush=True)
    torch.cuda.synchronize()
    aggregate_telemetry_fused.launches = 0
    t0 = time.perf_counter()
    for s, p in events:
        sink.record(s, p)
    t_recorded = time.perf_counter()
    sink.flush()
    sink.drain()
    seconds = time.perf_counter() - t0
    launches = aggregate_telemetry_fused.launches
    torch.cuda.synchronize()
    check(not got.warnings, f"sink: the worker logged {got.warnings[:3]}")
    check(launches == flushes, f"sink: {launches} kernel launches for {flushes} flushes")
    check(len(got.summaries) == flushes, f"sink: {len(got.summaries)} summaries logged")
    for i, (g, w) in enumerate(zip(got.summaries, want)):
        check(g == w, f"sink: flush {i} logged {g}, the oracle says {w}")

    # synchronous flushes: the one that record() triggers at the threshold;
    # the sync counter's own first use reports once per process
    count_syncs(torch, lambda: None)
    slog, _ = sink_logger("sync")
    sync = AnalyticsSink(flush_every=SINK_FLUSH_EVERY, logger=slog)
    latencies, syncs = [], None
    for rep in range(22):
        batch = events[rep * SINK_FLUSH_EVERY:(rep + 1) * SINK_FLUSH_EVERY]
        for s, p in batch[:-1]:
            check(sync.record(s, p) is None, "sync sink: flushed early")
        if rep == 1:  # after one warm flush
            summary, syncs = count_syncs(torch, lambda: sync.record(*batch[-1]))
        else:
            t = time.perf_counter()
            summary = sync.record(*batch[-1])
            latencies.append(time.perf_counter() - t)
        check(summary == want[rep], f"sync sink: flush {rep} returned {summary}")
    check(syncs == 1, f"sync sink: one flush made {syncs} synchronising calls, expected 1")
    flush_ms = statistics.median(latencies[1:]) * 1e3
    # the device's share of one synchronous flush (torch.profiler)
    from torch.profiler import ProfilerActivity, profile

    batch = events[-SINK_FLUSH_EVERY:]
    for s, p in batch[:-1]:
        sync.record(s, p)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        sync.record(*batch[-1])
    rows = device_rows(prof.key_averages())
    flush_device_us = {e.key[:60]: round(dev_us(e), 3) for e in rows}
    device_us = sum(dev_us(e) for e in rows)
    out = dict(events=SINK_EVENTS, flush_every=SINK_FLUSH_EVERY, flushes=flushes,
               launches=launches, seconds=seconds, record_seconds=t_recorded - t0,
               observations_per_s=SINK_EVENTS / seconds, summaries_match_oracle=True,
               sync_flush_syncs=syncs, sync_flush_ms_median=flush_ms,
               sync_flush_device_us=flush_device_us,
               sync_flush_device_share=device_us / 1e3 / flush_ms,
               sync_flush_ms_range=(min(latencies[1:]) * 1e3, max(latencies[1:]) * 1e3))
    print(f"analytics sink async flush_every={SINK_FLUSH_EVERY} observations={SINK_EVENTS} "
          f"flushes={flushes} kernel_launches={launches} summaries_match_oracle=yes "
          f"seconds={seconds:.4f} (record loop {out['record_seconds']:.4f}) "
          f"observations/s={out['observations_per_s']:.1f} (host clock); sync flush: "
          f"sync_calls={syncs} flush_ms median={flush_ms:.4f} "
          f"(range {out['sync_flush_ms_range'][0]:.4f}-{out['sync_flush_ms_range'][1]:.4f}, "
          f"{len(latencies) - 1} flushes, host clock); one profiled flush: device "
          f"{device_us:.3f} us ({flush_device_us}), device share of the median flush "
          f"{out['sync_flush_device_share']:.4f}", flush=True)
    return out


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--profile", action="store_true",
                        help="also profile one bf16 run_waves with torch.profiler")
    args = parser.parse_args()
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("no CUDA device: this script runs only on the card")
    try:
        from beholder_tpu_torch import csrc
    except ImportError:
        fail("beholder_tpu_torch not found: run from the root of a checkout")
    # plain products in full precision: state and set both switches
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False

    card = card_line()
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"allow_tf32=False allow_bf16_reduced_precision_reduction=False", flush=True)

    t0 = time.perf_counter()
    csrc.build("paged_decode", "paged_chunk", "flash_fwd", "flash_bwd", "aggregate")
    print(f"build: {time.perf_counter() - t0:.2f} s", flush=True)
    for name, log in csrc.build_log.items():
        print(f"build {name}: {log['seconds']:.2f} s\n{log['ptxas']}", flush=True)

    flush = torch.empty(64 * 2**20 // 4, device="cuda")
    cases = kernel_phase(torch, flush)
    chunk_cases = chunk_kernel_phase(torch, flush)
    flash_cases = flash_kernel_phase(torch, flush)
    record = {"card": card, "kernel_cases": cases, "chunk_kernel_cases": chunk_cases,
              "flash_kernel_cases": flash_cases}
    serving = main_path(torch, profile=args.profile)
    record["serving"] = serving
    paths = [v for k, v in serving.items() if k != "profile"]
    training = train_path(torch, flash_cases)
    training["anomaly"] = anomaly_path(torch)
    record["training"] = training
    agg_cases = aggregate_kernel_phase(torch, flush)
    record["aggregate_kernel_cases"] = agg_cases
    record["analytics"] = sink_path(torch)

    head = next(c for c in cases
                if c["shape"] == "headline" and c["pool"] == "bf16" and c["window"] is None)
    kernels = [{
        "name": "paged_decode_attention",
        "route": "cuda",
        "source": "beholder_tpu_torch/csrc/paged_decode.cu",
        "replaces": "beholder_tpu/ops/paged_attention.py:154",
        "launches": sum(v["launches"] for v in paths),
        "max_abs_err": max(c["max_abs_err"] for c in cases),
        "ms": head["ms"],
        "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"],
        "bound_by": head["bound_by"],
        "library_ms": head["library_ms"],
    }]
    wave = next(c for c in chunk_cases
                if c["shape"] == "wave" and c["pool"] == "bf16" and c["window"] is None)
    kernels.append({
        "name": "paged_chunk_attention",
        "route": "cuda",
        "source": "beholder_tpu_torch/csrc/paged_chunk.cu",
        "replaces": "beholder_tpu/ops/paged_attention.py:567",
        "launches": sum(v["chunk_launches"] for v in paths),
        "max_abs_err": max(c["max_abs_err"] for c in chunk_cases),
        "ms": wave["ms"],
        "plain_ms": wave["plain_ms"],
        "bound_ms": wave["bound_ms"],
        "bound_by": wave["bound_by"],
        "library_ms": wave["library_ms"],
    })
    train_case = next(c for c in flash_cases if c["case"] == "train")
    for key, name, replaces, source in (
        ("fwd", "flash_forward", "beholder_tpu/ops/flash_attention.py:227", "flash_fwd.cu"),
        ("dq", "flash_backward_dq", "beholder_tpu/ops/flash_attention.py:558", "flash_bwd.cu"),
        ("dkv", "flash_backward_dkv", "beholder_tpu/ops/flash_attention.py:635", "flash_bwd.cu"),
    ):
        outs = {"fwd": ("o", "lse"), "dq": ("dq",), "dkv": ("dk", "dv")}[key]
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": f"beholder_tpu_torch/csrc/{source}",
            "replaces": replaces,
            "launches": training["train"]["launches"][key],
            "max_abs_err": max(c["max_abs_err"][o] for c in flash_cases for o in outs),
            "ms": train_case[key]["ms"],
            "plain_ms": train_case[key]["plain_ms"],
            "bound_ms": train_case[key]["bound_ms"],
            "bound_by": train_case[key]["bound_by"],
            "library_ms": train_case[key]["library_ms"],
        })
    flush_case = next(c for c in agg_cases if c["case"] == "flush")
    kernels.append({
        "name": "aggregate_telemetry",
        "route": "cuda",
        "source": "beholder_tpu_torch/csrc/aggregate.cu",
        "replaces": "beholder_tpu/ops/pallas_aggregate.py:54",
        "launches": record["analytics"]["launches"],
        "max_abs_err": max(c["max_abs_err"] for c in agg_cases),
        "ms": flush_case["ms"],
        "plain_ms": flush_case["plain_ms"],
        "bound_ms": flush_case["bound_ms"],
        "bound_by": flush_case["bound_by"],
        "library_ms": flush_case["library_ms"],
    })
    record["kernels"] = kernels
    OUT.mkdir(exist_ok=True)
    (OUT / "chip_smoke.json").write_text(json.dumps(record, indent=1))
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
