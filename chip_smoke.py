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
   decode kernel at the headline and long-context shapes (timed), at head
   dim 32, a group of 16 at head dim 128, a group of 1 and 100-token pages,
   each with the split the wrapper chooses, one split and one 64-token
   tile a split, repeat launches bitwise, dead slots exact zeros; the paged
   chunk kernel at the fused-wave, warm-prefix, long-context and spec
   verify (8 slots of 5 rows over 4-page tables, lens 256-383) shapes; the
   flash forward, dq and dk/dv kernels at the training shape (B=4, H=8,
   Hkv=2, T=4096, Dh=64, bf16), causal, with a 512 window, non-causal,
   with segment ids and at T=4000, at two small edge shapes (a GQA group of
   8 at T=200, a group of 1 with segment ids at T=130), at head dims 8, 16
   and 32, and at head dim 128 on the reference's ``bench_flash_attention``
   shape (B=4, H=Hkv=8, T=4096, causal and not; the chunk kernel at its
   wave and warm shapes at 8, 16, 32 and 128); the registers, spills,
   shared memory and blocks per SM of the flash forward, the two backward
   kernels, the chunk kernel (each pool family) at every head dim each is
   instantiated for, of the decode kernel (each pool family, both
   instantiations) and of the aggregation kernel (int32 and f32 progress,
   each path), failing on any local memory; the backward's bits equal
   over two launches, and negative controls (a forward, dq and dk/dv
   without one key tile, a dk/dv without one query tile or one query head
   of the group, gradients scaled by 1 + 2**-8: each must fail); then the
   three flash kernels in the ring block-pair (offset) mode at the ring's
   shard shape (B=4, H=8, Hkv=2, 1,024 rows): a fully live off-axis pair,
   a dead pair, the diagonal through offset mode and a 512 window
   straddling two shards, and at head dim 128 on the reference's
   ``bench_ring_block`` shard (B=1, H=8, Hkv=2, T=2048) its off-axis
   (8192, 4096) and diagonal pairs, with the same checks and controls; then
   the forward at head dim 128 on that shard: a causal block, the off-axis
   pair, the diagonal and a dead pair, and the guard: a differentiable
   ``flash_attention`` call at head dim 96 raises before any launch, and
   at 128 launches the forward, dq and dk/dv once each;
4. serving: ``TelemetrySequenceModel(dim=512, heads=8, kv_heads=2,
   layers=4)`` with random bf16 weights from a numpy seed, over bf16, int8
   and fp8 pools, served through ``ContinuousBatcher.run_waves`` and
   ``ContinuousBatcher.run`` (cold admission), ``run_waves`` with
   ``fused_wave=True``, ``run`` with a ``PrefixCache`` and
   ``fused_verify=True`` (a cold pass, then a warm pass), one
   ``run_what_if``, and ``run_spec`` (speculative decoding over ``run``'s
   requests: spec off, n-gram and a replay of spec off's stream, each with
   the dense-gather and the fused verify, which must all agree bit for bit
   within a mode; a same-weights ``SmallModelDrafter``; int8 and fp8
   pools; ``bench_spec``'s throughput mode, timed); per path: launch
   counts of both kernels (set to 0 just before, read just after), pages
   home, forecasts against the dense ``forecast_deltas`` oracle, tokens/s,
   synchronising calls; then the batcher's intake and instruments
   (``intake_path``): ``submit`` / ``run_pending`` with a ``Registry``, a
   ``Tracer`` and a ``FlightRecorder`` whose ``RooflineAttributor``
   measures the card's f32 matmul ceiling, going to ``run_waves`` (shed
   outcomes, launches, streams and synchronising calls those of the bare
   path), to ``run`` with a prefix cache (cold and warm), to ``run_spec``
   (fused, a replay of spec off's stream: the spec counters against the
   run's own), request deadlines (expired at claim, lapsing mid-run), trace
   ids on every recorded event, a default ``RooflineAttributor()``
   measuring in the background (synchronising calls those of the bare
   path), and the armed ``run_pending`` -> ``run`` beside a bare ``run``
   in tokens/s, ten alternating pairs; then the
   reference's default model (``dim=128, heads=4``: head dim 32) through a
   fused wave and a cold and warm prefix-cache ``run``;
5. training: the same model with ``attention="flash"`` and f32 params from
   a numpy seed, ``init_seq_state`` then 20 ``seq_train_step``s on 4
   streams of 4096 events (flash launches counted, losses finite and
   falling, step ms, tokens/s, one profiled step); checkpoint save, restore
   and one step, bitwise against the uninterrupted run; step-1 gradients
   against ``attention="full"``; ``remat=True`` (gradients bitwise, forward
   launches doubled) and ``window=512`` for 3 steps each; then
   ``ProgressAnomalyModel`` at ``entry()``'s shape and 20 ``train_step``s;
   then ring attention on a P = 4 mesh of this one card
   (``Mesh(["cuda:0"] * 4)``, no bytes between devices): the ring forward
   against ``flash_attention`` at the training shape, the same model with
   ``attention="ring"`` for 20 steps (launches counted exactly: 64 of each
   kernel a step, 48 of them in offset mode), step-1 gradients against
   ``attention="full"``, remat bitwise;
6. analytics: the aggregation kernel against its plain version (counts,
   max and min bitwise, the mean within rtol 1e-5) and a float64 numpy
   oracle at the sink's flush (4,096 events), 1,000,000 and 8,388,608
   events, a ragged batch with out-of-range statuses, a skewed one, f32
   progress, misaligned inputs, one event, the one-block path's limit and
   one past it, and every event in one status; repeat launches bitwise; a
   negative control; one call is one kernel launch and no memset
   (profiler); times beside the bound, the first design's recorded time,
   the same call after a clean (read) L2 flush, the timing floor (a
   one-cycle kernel) and a four-call PyTorch yardstick, and at 8,388,608
   events ``torch.sum`` over the same bytes as a read rate. Then
   ``AnalyticsSink(flush_every=4096, async_flush=True)`` takes 2**20
   observations through ``record()``: launches == flushes (counted), every
   logged summary against the oracle; a synchronous flush makes one
   synchronising call;
7. output: a ``kernels`` JSON line (the three block-pair sites of the flash
   kernels as rows of their own), then the ``ok`` line last.

``--profile`` adds a ``torch.profiler`` breakdown of one bf16 ``run_waves``
and of one fused n-gram ``run_spec`` (a round's host time, readback wait,
device time and chunk kernel time).
``--chunk-parent DIR`` adds, after the spec phase, the chunk kernel of
another checkout (``DIR/beholder_tpu_torch/csrc/paged_chunk.cu``, e.g. the
parent commit unpacked by ``git archive``) against this one's in one
process: every chunk case in turns A B B A, and the fused verify's spec on
== spec off reading (replay against spec off) with each.
The full record goes to ``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import argparse
import cProfile
import json
import logging
import pstats
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
#: the intake phase's armed/bare overhead: bare and armed calls in this
#: many pairs, the order alternating
OVERHEAD_PAIRS = 10
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


def kernel_resources() -> dict:
    """What the flash forward, the two flash backward kernels, the paged
    chunk kernel, the paged decode kernel and the aggregation kernel take
    on this card at every instantiation (each head dim of the kernel's set;
    the paged kernels per pool family too, the decode kernel's at a group
    of 4 (headline, head dim 64) and of 16 (head dim 128); aggregation for
    int32 and f32 progress on each path): registers and local (spilled) bytes
    a thread, dynamic shared memory a block, resident blocks an SM
    (cudaFuncGetAttributes and the occupancy calculator). Fails on any
    local memory."""
    import ctypes

    from beholder_tpu_torch.ops import flash_attention as fa
    from beholder_tpu_torch.ops import paged_attention as pa

    fwd, bwd, chunk = fa._kernel_lib("flash_fwd"), fa._kernel_lib("flash_bwd"), \
        pa._chunk_kernel_lib()
    decode = pa._kernel_lib()
    fwd.flash_fwd_resources.argtypes = [ctypes.c_int, ctypes.c_void_p]
    bwd.flash_bwd_resources.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    chunk.paged_chunk_resources.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    queries = [(f"flash_fwd_kernel<{dh}>", fwd.flash_fwd_resources, (dh,))
               for dh in fa.KERNEL_HEAD_DIMS["flash forward"]]
    queries += [(f"{kernel}<{dh}>", bwd.flash_bwd_resources, (which, dh))
                for dh in fa.KERNEL_HEAD_DIMS["flash backward"]
                for which, kernel in enumerate(("flash_dq_kernel", "flash_dkv_kernel"))]
    queries += [(f"paged_chunk_kernel<{family}, {dh}>", chunk.paged_chunk_resources, (mode, dh))
                for dh in fa.KERNEL_HEAD_DIMS["paged chunk"]
                for mode, family in enumerate(("bf16", "int8", "fp8"))]
    queries += [(f"paged_decode_kernel<{family}, G={h // hkv}, Dh={dh}>",
                 decode.paged_decode_resources, (mode, h, hkv, dh))
                for h, hkv, dh in ((8, 2, 64), (16, 1, 128))
                for mode, family in enumerate(("bf16", "int8", "fp8"))]
    from beholder_tpu_torch.ops import fused_aggregate

    agg = fused_aggregate._kernel_lib()
    queries += [(f"aggregate_kernel<{prog}, {path}>", agg.aggregate_resources, (which,))
                for which, prog, path in ((0, "int32", "grid"), (1, "f32", "grid"),
                                          (2, "int32", "one block"), (3, "f32", "one block"))]
    out = {}
    for name, query, args in queries:
        query.restype = ctypes.c_int
        vals = (ctypes.c_int * 4)()
        err = query(*args, vals)
        check(err == 0, f"{name}: resource query failed, CUDA error {err}")
        out[name] = dict(zip(("registers", "local_bytes", "smem_bytes", "blocks_per_sm"), vals))
        print(f"kernel {name}: " + " ".join(f"{k}={v}" for k, v in out[name].items()),
              flush=True)
    for name, row in out.items():
        check(row["local_bytes"] == 0,
              f"{name}: {row['local_bytes']} bytes of local memory a thread (spills)")
    return out


def time_ms(torch, fn, flush, reps: int = 25, warm: int = 3, clean: bool = False) -> float:
    """Median CUDA-event time of ``fn`` over ``reps`` runs after ``warm``,
    with the L2 cache flushed (64 MB written) before each timed run. A
    ~1 ms spin kernel before the start event keeps the card busy while the
    host enqueues ``fn``'s launches, so the interval holds device time and
    not the host's launch overhead (for a call that issues more than ~1 ms
    of launches, part of that overhead remains). The written flush leaves
    L2 full of dirty lines that a large read must write back first;
    ``clean`` flushes by reading 64 MB instead, which leaves none."""
    for _ in range(warm):
        fn()
    events = []
    for _ in range(reps):
        if clean:
            flush.sum()
        else:
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


#: the paged decode kernel's shapes: the two it is timed at, then shapes
#: that reach its other instantiations and paths (checked, not timed)
DECODE_SHAPES = {
    # the headline serving shape: lens 255..383, one dead slot
    "headline": dict(S=8, H=8, Hkv=2, Dh=64, page=128, N=32, P=4,
                     lens=[255, 275, 300, 320, 340, 360, 383, -1], window=200),
    # the long-context shape: 512-token pages, lens about 3584..3711
    "long": dict(S=8, H=8, Hkv=2, Dh=64, page=512, N=64, P=8,
                 lens=[3584, 3600, 3620, 3640, 3660, 3680, 3700, 3711], window=1500),
    # the reference's default model's head dim (dim=128 over 4 heads)
    "d32": dict(S=8, H=4, Hkv=2, Dh=32, page=128, N=32, P=4,
                lens=[0, 63, 64, 200, 300, 511, 700, -1], window=100),
    # a group of 16 query heads at head dim 128 (the KG=16 instantiation)
    "d128-g16": dict(S=4, H=16, Hkv=1, Dh=128, page=128, N=16, P=4,
                     lens=[100, 300, 511, -1], window=200),
    # no GQA: a group of 1
    "g1": dict(S=8, H=4, Hkv=4, Dh=64, page=128, N=32, P=4,
               lens=[5, 127, 128, 250, 381, 400, 511, -1], window=200),
    # 100-token pages: chunks off 16-byte boundaries, the element-load path
    "page100": dict(S=8, H=8, Hkv=2, Dh=64, page=100, N=40, P=5,
                    lens=[0, 99, 100, 250, 377, 420, 499, -1], window=150),
}
DECODE_TIMED = ("headline", "long")


def kernel_phase(torch, flush) -> list[dict]:
    """The paged decode kernel against its plain version at DECODE_SHAPES,
    each pool family, window off and on, three split settings: the
    wrapper's (decode_splits), one split and one 64-token tile a split;
    two launches bitwise, dead slots exact zeros. At the two timed shapes,
    times of the kernel (the wrapper's split and one split), the plain
    version and SDPA beside the bound."""
    from beholder_tpu_torch.ops import paged_attention as pa
    from beholder_tpu_torch.ops.quant import pool_quantize, pool_scales_f32

    dev = torch.device("cuda")
    F = torch.nn.functional
    cases = []
    for shape, c in DECODE_SHAPES.items():
        rng = np.random.default_rng(7)
        S, H, Hkv, Dh, page, N, P = (c[k] for k in ("S", "H", "Hkv", "Dh", "page", "N", "P"))
        q = torch.from_numpy(rng.normal(0, 1, (S, H, Dh)).astype(np.float32)).to(dev).bfloat16()
        k_f = torch.from_numpy(rng.normal(0, 1, (N, Hkv, Dh, page)).astype(np.float32)).to(dev)
        v_f = torch.from_numpy(rng.normal(0, 1, (N, Hkv, Dh, page)).astype(np.float32)).to(dev)
        table = torch.from_numpy(
            rng.permutation(N)[: S * P].reshape(S, P).astype(np.int32)).to(dev)
        lens_np = np.asarray(c["lens"], np.int32)
        lens = torch.from_numpy(lens_np).to(dev)
        dead = torch.from_numpy(lens_np < 0).to(dev)
        tiles = -(-P * page // pa.DECODE_TILE)
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
                where = f"decode {shape}/{family}/window={window}"
                out_p = pa.paged_decode_reference(*args, **kw)
                chosen = pa.decode_splits(S, Hkv, P, page, window)
                splits = {"chosen": chosen, "one": pa.DecodeSplit(1, tiles * pa.DECODE_TILE),
                          "tile": pa.DecodeSplit(tiles, pa.DECODE_TILE)}
                errs = {}
                for name, split in splits.items():
                    out_k = pa._launch(q, kp, vp, table, lens, window, ks, vs, split)
                    again = pa._launch(q, kp, vp, table, lens, window, ks, vs, split)
                    torch.cuda.synchronize()
                    check(bool(torch.isfinite(out_k.float()).all()), f"{where}/{name}: non-finite")
                    check(torch.equal(out_k, again), f"{where}/{name}: a repeat launch changed bits")
                    if dead.any():
                        check(not bool(out_k[dead].any()), f"{where}/{name}: dead slot row not zero")
                    errs[name] = float((out_k.float() - out_p.float()).abs().max())
                    check(errs[name] <= KERNEL_TOL,
                          f"{where}/{name} splits={split.splits}: max abs err {errs[name]} > "
                          f"{KERNEL_TOL}")
                # the wrapper runs the chosen split
                check(torch.equal(pa.paged_decode_attention(*args, **kw),
                                  pa._launch(q, kp, vp, table, lens, window, ks, vs, chosen)),
                      f"{where}: the wrapper's output is not its chosen split's")
                case = dict(shape=shape, pool=family, window=window, S=S, H=H, Hkv=Hkv, Dh=Dh,
                            page=page, splits=chosen.splits, span=chosen.span,
                            max_abs_err=max(errs.values()), errs=errs, tolerance=KERNEL_TOL)
                cases.append(case)
                line = (f"kernel paged_decode {shape:8s} {family:4s} window={window!s:5s} "
                        f"splits={chosen.splits}x{chosen.span} err chosen/one/tile="
                        + "/".join(f"{e:.3e}" for e in errs.values()) + f" (tol {KERNEL_TOL})")
                if shape not in DECODE_TIMED:
                    print(line, flush=True)
                    continue
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
                ms = time_ms(torch, lambda: pa.paged_decode_attention(*args, **kw), flush)
                one_ms = time_ms(torch, lambda: pa._launch(q, kp, vp, table, lens, window, ks,
                                                           vs, splits["one"]), flush)
                plain_ms = time_ms(torch, lambda: pa.paged_decode_reference(*args, **kw), flush)
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
                case.update(ms=ms, one_split_ms=one_ms, plain_ms=plain_ms, library_ms=lib_ms,
                            live_bytes=nbytes, bound_ms=max(t_bytes, t_ops),
                            bound_by="bytes" if t_bytes >= t_ops else "operations")
                print(
                    line + f" ms={ms:.4f} one_split_ms={one_ms:.4f} plain_ms={plain_ms:.4f} "
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
    shapes = {
        # a fused wave: 8 requests of 256 tokens, an empty paged context,
        # ctx_len = t_max as the fused admission passes it
        "wave": dict(S=8, W=256, page=128, N=32, P=1, lens=[0] * 8, ctx_len=256),
        # a warm prefix admit: one 128-token suffix over one cached page
        "warm": dict(S=1, W=128, page=128, N=32, P=1, lens=[128]),
        # long context: 512-token pages, 8 per slot, a 128-token chunk
        "long": dict(S=8, W=128, page=512, N=64, P=8,
                     lens=[3584, 3600, 3620, 3640, 3660, 3680, 3700, 3711]),
        # spec verify: 8 slots of a max_draft + 1 = 5-row chunk over a 4-page
        # table, ctx_len = P*page as the verify passes it, lens 256..383
        "verify": dict(S=8, W=5, page=128, N=32, P=4,
                       lens=[256, 275, 300, 320, 340, 360, 370, 383], ctx_len=512),
        # off the main path: spec verify's width (ctx_len = P*page, the
        # chunk's tail dropped past it) and lengths past live_pages (zeros)
        "edge": dict(S=4, W=64, page=128, N=32, P=3, lens=[0, 200, 300, 360],
                     ctx_len=384, live_pages=2),
        # pages of 100 tokens: runs of 8 keys cross pages, so the kernel
        # loads context key by key instead of 8 keys at a time
        "page100": dict(S=4, W=64, page=100, N=32, P=4, lens=[0, 150, 301, 390]),
    }
    # the wave and warm shapes at the head dims of the reference's models
    # (dim 32 / 64 / 128 over 4 heads) and at the served dim 512 over 4 heads
    for dh in (8, 16, 32, 128):
        for name in ("wave", "warm"):
            shapes[f"{name}-d{dh}"] = dict(shapes[name], H=4, Hkv=4, Dh=dh)
    cases = []
    for shape, c in shapes.items():
        rng = np.random.default_rng(11)
        H, Hkv, Dh = c.get("H", 8), c.get("Hkv", 2), c.get("Dh", 64)
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
                    shape=shape, H=H, Hkv=Hkv, Dh=Dh, pool=family, window=window,
                    max_abs_err=err, max_excess=float(excess.max()),
                    excess_per_row_rms=reading,
                    plain_rms=float(plain.square().mean().sqrt()),
                    tolerance=dict(rtol=CHUNK_RTOL, atol_row_rms=CHUNK_ATOL_RMS),
                    ms=ms, plain_ms=plain_ms,
                    library_ms=lib_ms, bytes=nbytes, flops=flops,
                    bound_ms=max(t_bytes, t_ops),
                    bound_by="bytes" if t_bytes >= t_ops else "operations",
                )
                cases.append(case)
                print(
                    f"kernel paged_chunk {shape:8s} {family:4s} window={window!s:5s} "
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
#: output row's RMS over the head dim. The forward (row_reading): max
#: |kernel - plain| / row RMS. The forward kernel runs the softmax online
#: over 64-key tiles and rounds each unnormalised weight to bf16, the plain
#: forward the whole row's: o read up to 0.033 over the five cases (NVIDIA
#: H100 80GB HBM3, 700 W; PERF.md), and its limit is ~3x that; a forward
#: that drops one 64-key tile must read above 3x the limit (checked on the
#: training case). The backward (grad_readings) is held two ways. Its
#: reading is the same, beyond exactly one bf16 spacing at each plain value
#: (bf16_spacing), over a row RMS floored at 2**-8 of the whole output's
#: RMS: the tensor-core kernels sum in another order than the plain f32
#: products, so an output's bf16 rounding flips now and then, by one
#: spacing; and a row whose gradient cancels to ~0 (a query row that sees
#: one key: dp == delta) is rounding noise on both sides. Beyond that, p and
#: ds rounding where the plain versions round them, the limit 0.01 is ~2.5
#: bf16 spacings at the row's RMS. Its share is the share of the elements at
#: least that floor in size whose bits differ from the plain's at all: the
#: kernels' flips reach 1.05% (non-causal dk, the longest sums; NVIDIA H100
#: 80GB HBM3, 700 W; PERF.md) and the limit is ~3x that, so a fault of under
#: one spacing that moves every element (a scale of 1 + 2**-8 differs in 99%)
#: fails there. At the training shape, a dq without one 64-key tile, a dk/dv
#: without one 64-key tile, without one 64-row query tile or without one
#: query head of the GQA group must read above 3x the limit, and gradients
#: scaled by 1 + 2**-8 must differ in above 3x the share. lse (f32, ~8-10 at
#: T=4096) read up to 1.9e-6, two f32 ULPs (non-causal): limit 6e-6.
FLASH_TOL_RMS = {"o": 0.09, "dq": 0.01, "dk": 0.01, "dv": 0.01}
FLASH_LSE_ATOL = 6e-6
FLASH_GRAD_SHARE = 0.03
#: the training shape of the flash kernels: B streams of T events, 8 heads
#: over 2 kv heads, head dim 64 (dim 512 / 8 heads)
FLASH_SHAPE = dict(B=4, H=8, Hkv=2, T=4096, Dh=64)
FLASH_CASES = {
    "train": dict(causal=True),
    "window512": dict(causal=True, window=512),
    "noncausal": dict(causal=False),
    "segments": dict(causal=True, segments=4),
    "t4000": dict(causal=True, T=4000),
    # edges of the backward's tiling: a GQA group of 8 over one partial
    # tile, and a group of 1 with segment ids over a 2-row last tile
    "mqa-t200": dict(causal=True, B=1, H=8, Hkv=1, T=200),
    "g1-seg-t130": dict(causal=True, B=2, H=2, Hkv=2, T=130, segments=3),
    # the head dims of the reference's models (C.7): its tests' dim=32 and
    # dim=64 over 4 heads, and its default dim=128 over 4 heads
    "d8": dict(causal=True, H=4, Hkv=4, T=2048, Dh=8),
    "d16": dict(causal=True, H=4, Hkv=2, T=2048, Dh=16),
    "d32": dict(causal=True, H=4, Hkv=4, T=4096, Dh=32),
    # head dim 128 at the reference's bench_flash_attention shape
    # (bench.py:838: B=4, H=8, T=4096, forward and backward, causal and not)
    "d128-causal": dict(causal=True, H=8, Hkv=8, Dh=128),
    "d128-noncausal": dict(causal=False, H=8, Hkv=8, Dh=128),
}
#: the cases whose faulty plain versions must fail the limits
FLASH_CONTROL_CASES = ("train", "d128-causal", "d128-noncausal")


def flash_pairs(T: int, causal: bool, window, seg, offsets=(0, 0)) -> int:
    """(query, key) pairs one head attends: what this data needs. Rows and
    keys sit at global positions ``i + offsets[0]`` and ``i + offsets[1]``
    (a ring block pair); segment ids (B, T) count per batch row, averaged."""
    i = np.arange(T)
    rows, cols = i[:, None] + offsets[0], i[None, :] + offsets[1]
    live = rows >= cols if causal else np.ones((T, T), dtype=bool)
    if window:
        live &= rows - cols < window
    if seg is None:
        return int(live.sum())
    return sum(int((live & (row[:, None] == row[None, :])).sum()) for row in seg) // len(seg)


def row_reading(got, want) -> float:
    """max |got - want| over the plain output row's RMS (head dim last)."""
    want = want.float()
    rms = want.square().mean(-1, keepdim=True).sqrt().clamp_min(1e-30)
    return float(((got.float() - want).abs() / rms).max())


def bf16_spacing(x):
    """The distance from each value of ``x`` to the next bf16 up in
    magnitude (0 at 0)."""
    _, e = x.frexp()
    return (x != 0) * (e - 8).exp2()


def grad_readings(got, want) -> tuple[float, float]:
    """A gradient against its plain version: (reading, share). reading:
    max (|got - want| - one bf16 spacing at want) over the plain row's RMS
    (head dim last), floored at 2**-8 of the whole output's RMS. share: of
    the elements at least that floor in size, the share whose bits differ."""
    want, got = want.float(), got.float()
    floor = max(float(want.square().mean().sqrt()) * 2**-8, 1e-30)
    rms = want.square().mean(-1, keepdim=True).sqrt().clamp_min(floor)
    diff = (got - want).abs()
    reading = float(((diff - bf16_spacing(want)).clamp_min(0) / rms).max())
    big = want.abs() >= floor
    return reading, float((diff[big] != 0).float().mean())


def plain_backward_without(torch, fa, q, k, v, do, lse, delta, *, keys=None, queries=None,
                           **kw):
    """The plain dq, dk and dv with a part of their sums left out, as a
    backward kernel that skipped a streamed step would give: ``keys`` (T,)
    masks the keys summed into dq, ``queries`` (G, T) the GQA group's query
    heads and rows summed into dk/dv (None: all)."""
    bhkv, t, d = k.shape
    p = fa._probabilities(q, k, lse, kw["causal"], kw["window"], kw["segment_ids"],
                          kw.get("offsets"))
    dp = torch.matmul(fa._grouped(do, bhkv), v.float()[:, None].transpose(-1, -2))
    ds = p * (dp - delta.reshape(bhkv, -1, t, 1)) * (1.0 / d ** 0.5)
    del dp
    dsk = ds if keys is None else ds * keys
    dq = torch.matmul(dsk.to(k.dtype).float(), k.float()[:, None]).to(q.dtype).reshape(q.shape)
    del dsk
    if queries is not None:
        p, ds = p * queries[..., None], ds * queries[..., None]

    def group_sum(w, x):  # as flash_dkv_reference sums over the group
        w = w.permute(0, 3, 1, 2).reshape(bhkv, t, -1)
        return torch.matmul(w, fa._grouped(x, bhkv).reshape(bhkv, -1, d))

    dv = group_sum(p.to(do.dtype).float(), do).to(v.dtype)
    del p
    dk = group_sum(ds.to(q.dtype).float(), q).to(k.dtype)
    return dq, dk, dv


def plain_forward_without(torch, fa, q, k, v, keys, *, causal, window, segment_ids=None,
                          offsets=None):
    """The plain forward's o with the keys where ``keys`` (T,) is False
    left out of every row's softmax, as a forward kernel that skipped a
    streamed key tile would give."""
    bhkv, t, d = k.shape
    qs = (q.float() * (1.0 / d ** 0.5)).to(q.dtype)
    s = torch.matmul(fa._grouped(qs, bhkv), k.float()[:, None].transpose(-1, -2))
    live = fa._live(t, causal, window, segment_ids, bhkv, q.device, offsets)
    live = keys[None, :] if live is None else live & keys
    # zeroed where masked: a row with no live key gives o = 0, as the plain
    # forward's
    w = torch.where(live, torch.softmax(torch.where(live, s, -1e30), dim=-1), 0.0)
    del s
    return torch.matmul(w.to(v.dtype).float(), v.float()[:, None]).reshape(q.shape)


def backward_controls(torch, fa, bwd, plain, lo: int, row_lo: int | None = None, **kw) -> dict:
    """Faulty backwards against the plain (dq, dk, dv): (reading, share) of
    each. Without the 64 keys from ``lo`` (dq, dk, dv); without the 64
    query rows from ``row_lo`` (default ``lo``) and without the group's
    first query head (dk, dv: the dk/dv kernel's streamed steps); and
    scaled by 1 + 2**-8, a fault under one bf16 spacing (dq, dk, dv)."""
    q, k = bwd[:2]
    G, T = q.shape[0] // k.shape[0], k.shape[1]
    row_lo = lo if row_lo is None else row_lo
    keys = torch.ones(T, device=q.device)
    keys[lo:lo + 64] = 0
    rows = torch.ones(G, T, device=q.device)
    rows[:, row_lo:row_lo + 64] = 0
    head = torch.ones(G, T, device=q.device)
    head[0] = 0
    dq, dk, dv = plain_backward_without(torch, fa, *bwd, keys=keys, **kw)
    dk[:, lo:lo + 64] = 0  # the kernel's key tile: dk/dv rows never written
    dv[:, lo:lo + 64] = 0
    faults = {"key_tile": (dq, dk, dv),
              "query_tile": (None, *plain_backward_without(torch, fa, *bwd, queries=rows, **kw)[1:]),
              "group_head": (None, *plain_backward_without(torch, fa, *bwd, queries=head, **kw)[1:]),
              "scale_1+2^-8": tuple((w.float() * (1 + 2**-8)).to(w.dtype) for w in plain)}
    return {f"{name}:{g}": grad_readings(got, want)
            for name, grads in faults.items()
            for g, got, want in zip(("dq", "dk", "dv"), grads, plain) if got is not None}


def run_controls(torch, fa, where, qkv, o_p, bwd, plain, lo, row_lo=None, **kw) -> dict:
    """The negative controls of one case, each required to fail: a plain
    forward without the 64 keys from ``lo`` against ``o_p``, and the
    backward faults of :func:`backward_controls`."""
    keep = torch.ones(qkv[1].shape[1], dtype=torch.bool, device=o_p.device)
    keep[lo:lo + 64] = False
    o_drop = row_reading(plain_forward_without(torch, fa, *qkv, keep, **kw), o_p)
    check(o_drop > 3 * FLASH_TOL_RMS["o"],
          f"{where}: an o without one kv tile reads {o_drop}, inside 3x the limit")
    # and plain backwards with a part of their sums left out, or a small
    # uniform fault
    controls = {"key_tile:o": (o_drop, None),
                **backward_controls(torch, fa, bwd, plain, lo, row_lo, **kw)}
    for c_name, (reading, share) in controls.items():
        g = c_name.split(":")[1]
        if c_name.startswith("scale"):
            check(share > 3 * FLASH_GRAD_SHARE,
                  f"{where}: {c_name} differs in a share {share}, inside 3x the limit")
        else:
            check(reading > 3 * FLASH_TOL_RMS[g],
                  f"{where}: {c_name} reads {reading}, inside 3x the limit")
    return controls


def flash_kernel_phase(torch, flush) -> list[dict]:
    """The three flash kernels against their plain versions at the training
    shape, causal, with a window, non-causal, with segment ids and at an
    unaligned T, at the two edge shapes, at head dims 8, 16 and 32, and at
    head dim 128 on the reference's bench_flash_attention shape; the
    backward's bits equal over two launches; at the training shape and at
    head dim 128 faulty plain versions fail their limits
    (backward_controls); times of each kernel, its plain version and SDPA
    (forward, and its backward for dq and dk/dv), beside the bound."""
    from beholder_tpu_torch.ops import flash_attention as fa

    dev = torch.device("cuda")
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
        # a second launch on the same inputs: no atomics, no order left to
        # the scheduler, so the same bits
        repeat = (fa.flash_backward_dq(*bwd, **kw), *fa.flash_backward_dkv(*bwd, **kw))
        dq_p = fa.flash_dq_reference(*bwd, **kw)
        dk_p, dv_p = fa.flash_dkv_reference(*bwd, **kw)
        torch.cuda.synchronize()
        where = f"flash {name}"
        for t_name, t in (("o", o), ("lse", lse), ("dq", dq), ("dk", dk), ("dv", dv)):
            check(bool(torch.isfinite(t).all()), f"{where}: {t_name} not finite")
        for t_name, a, b in zip(("dq", "dk", "dv"), (dq, dk, dv), repeat):
            check(torch.equal(a, b), f"{where}: a repeat launch changed {t_name}")
        del repeat
        grads = {g: grad_readings(got, want)
                 for g, got, want in zip(("dq", "dk", "dv"), (dq, dk, dv), (dq_p, dk_p, dv_p))}
        readings = {"o": row_reading(o, o_p), **{g: r for g, (r, _) in grads.items()}}
        shares = {g: sh for g, (_, sh) in grads.items()}
        lse_err = float((lse - lse_p).abs().max())
        errs = {"o": float((o.float() - o_p.float()).abs().max()),
                "dq": float((dq.float() - dq_p.float()).abs().max()),
                "dk": float((dk.float() - dk_p.float()).abs().max()),
                "dv": float((dv.float() - dv_p.float()).abs().max()), "lse": lse_err}
        for out_name, reading in readings.items():
            check(reading <= FLASH_TOL_RMS[out_name],
                  f"{where}: {out_name} reading {reading} x row RMS > {FLASH_TOL_RMS[out_name]}")
        for g, share in shares.items():
            check(share <= FLASH_GRAD_SHARE,
                  f"{where}: {g} differs from the plain bits in a share {share} > {FLASH_GRAD_SHARE}")
        check(lse_err <= FLASH_LSE_ATOL, f"{where}: lse err {lse_err} > {FLASH_LSE_ATOL}")
        controls = None
        if name in FLASH_CONTROL_CASES:
            controls = run_controls(torch, fa, where, (q, k, v), o_p, bwd, (dq_p, dk_p, dv_p),
                                    T // 2, **kw)

        # library yardstick: SDPA, with an explicit mask for window and segments
        mask = None
        if window is not None or seg is not None:
            i = torch.arange(T, device=dev)
            mask = (i[:, None] >= i[None, :]) if causal else torch.ones(T, T, dtype=torch.bool, device=dev)
            if window is not None:
                mask = mask & (i[:, None] - i[None, :] < window)
            mask = mask[None, None]
            if seg is not None:
                mask = mask & (seg[:, None, :, None] == seg[:, None, None, :])
        pairs = flash_pairs(T, causal, window, seg_np)
        case = dict(case=name, B=B, H=H, Hkv=Hkv, T=T, Dh=Dh, causal=causal, window=window,
                    segments=c.get("segments"), pairs_per_head=pairs, readings=readings,
                    grad_shares=shares, lse_err=lse_err, max_abs_err=errs,
                    controls=controls,
                    tolerance=dict(row_rms=FLASH_TOL_RMS, grad_share=FLASH_GRAD_SHARE,
                                   lse_atol=FLASH_LSE_ATOL))
        case.update(flash_times(torch, fa, flush, B, (q, k, v, do), bwd, kw, mask, pairs,
                                0 if seg is None else B * T * 4))
        cases.append(case)
        print(
            f"kernel flash {name:9s} T={T} readings(x row RMS) o={readings['o']:.3e} "
            f"dq={readings['dq']:.3e} dk={readings['dk']:.3e} dv={readings['dv']:.3e} "
            f"(limits {FLASH_TOL_RMS}) shares dq={shares['dq']:.3e} dk={shares['dk']:.3e} "
            f"dv={shares['dv']:.3e} (limit {FLASH_GRAD_SHARE}) "
            f"lse_err={lse_err:.3e} (limit {FLASH_LSE_ATOL})"
            + ("" if controls is None else " controls(reading,share) "
               + " ".join(f"{n}={r:.3e},{sh}" for n, (r, sh) in controls.items())),
            flush=True,
        )
        print_times(case)
    return cases


def flash_times(torch, fa, flush, B, qkvdo, bwd, kw, mask, pairs, segb=0) -> dict:
    """Times (CUDA events, L2 flushed) of the three flash kernels at ``kw``,
    their plain versions and SDPA on (B, H, T, Dh) views (its forward, and
    its backward for dq and dk/dv), with the boolean ``mask`` or, when None,
    ``is_causal``; beside each the bound of the work this data needs:
    ``pairs`` (query, key) pairs a head, each input read once and each
    output written once (``segb`` bytes of segment ids)."""
    q, k, v, do = qkvdo
    q4, k4, v4, do4 = (t.reshape(B, -1, *t.shape[1:]) for t in (q, k, v, do))

    def sdpa(q4=q4, k4=k4, v4=v4):
        F = torch.nn.functional
        if mask is None:
            return F.scaled_dot_product_attention(q4, k4, v4, is_causal=kw["causal"],
                                                  enable_gqa=True)
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
    BH, T, Dh = q.shape
    qb, kb = q.numel() * 2, k.numel() * 2   # bf16 bytes
    rowb = BH * T * 4                        # one f32 per query row (lse, delta)
    work = {  # (bytes: each input read once, each output written once; flops)
        "fwd": (qb + 2 * kb + qb + rowb + segb, 4 * BH * Dh * pairs),
        "dq": (qb + 2 * kb + qb + 2 * rowb + qb + segb, 6 * BH * Dh * pairs),
        "dkv": (qb + 2 * kb + qb + 2 * rowb + 2 * kb + segb, 8 * BH * Dh * pairs),
    }
    out = {}
    for kern, (ms, plain_ms, lib_ms) in times.items():
        nbytes, flops = work[kern]
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / BF16_FLOPS * 1e3
        out[kern] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bytes=nbytes,
                         flops=flops, bound_ms=max(t_bytes, t_ops),
                         bound_by="bytes" if t_bytes >= t_ops else "operations")
    return out


def print_times(case: dict) -> None:
    for kern in ("fwd", "dq", "dkv"):
        r = case[kern]
        print(f"  {kern:3s} ms={r['ms']:.4f} plain_ms={r['plain_ms']:.4f} "
              f"library_ms={r['library_ms']:.4f} bound_ms={r['bound_ms']:.5f} "
              f"({r['bound_by']}) flops={r['flops']} bytes={r['bytes']}", flush=True)


#: the ring path: P = 4 shards of the training shape's 4,096 rows, so one
#: block pair is a (B, H, 1,024, Dh) shard against a (B, Hkv, 1,024, Dh) one
RING_P = 4
OFFSET_SHAPE = dict(B=4, H=8, Hkv=2, T=1024, Dh=64)
#: block pairs of that ring in the kernels' offset mode: (q_offset,
#: kv_offset) on global positions; key tile ``lo`` and row tile ``row_lo``
#: of the negative controls (each must hold live pairs)
OFFSET_CASES = {
    # shard 2 against shard 1's block: every pair live
    "offaxis": dict(offsets=(2048, 1024)),
    # shard 1 against shard 2's wrapped block: no pair live
    "dead": dict(offsets=(1024, 2048)),
    # the diagonal through offset mode (q_offset == kv_offset)
    "diagonal": dict(offsets=(2048, 2048)),
    # a 512 window from shard 1 reaching back into shard 0's block: rows
    # 0-510 of the shard see keys 513-1023 of the block, the rest none
    "window512": dict(offsets=(1024, 0), window=512, row_lo=0),
    # head dim 128 on bench_ring_block's shard (FWD128_SHAPE, below): its
    # mid-ring rotation, every pair live, and its diagonal rotation
    "d128-offaxis": dict(offsets=(8192, 4096), shape="d128"),
    "d128-diagonal": dict(offsets=(4096, 4096), shape="d128"),
}


def offset_kernel_phase(torch, flush) -> list[dict]:
    """The three flash kernels in the ring block-pair (offset) mode against
    their plain versions at the ring's shard shape: a fully live off-axis
    pair, a dead pair, the diagonal through offset mode and a window that
    straddles two shards; and at head dim 128 on bench_ring_block's shard,
    its off-axis and diagonal pairs. The forward's row reading and lse, the backward's
    two-part check from the ring's global lse (a pair's own lse where a row
    sees a key, its diagonal block's elsewhere), repeat launches bitwise,
    the negative controls failing (live cases), exact zeros (dead case);
    times of each kernel, its plain version and SDPA with an explicit
    boolean mask on the global positions, beside the bound of the live
    pairs."""
    from beholder_tpu_torch.ops import flash_attention as fa

    dev = torch.device("cuda")
    cases = []
    for name, c in OFFSET_CASES.items():
        shape = FWD128_SHAPE if c.get("shape") == "d128" else OFFSET_SHAPE
        B, H, Hkv, T, Dh = (shape[k] for k in ("B", "H", "Hkv", "T", "Dh"))
        offsets, window = c["offsets"], c.get("window")
        rng = np.random.default_rng(19)

        def normal(*shape_):
            return torch.from_numpy(rng.normal(0, 1, shape_).astype(np.float32)).to(dev).bfloat16()

        q, k, v, do = normal(B * H, T, Dh), normal(B * Hkv, T, Dh), normal(B * Hkv, T, Dh), \
            normal(B * H, T, Dh)
        kw = dict(causal=True, window=window, segment_ids=None, offsets=offsets)
        counts0 = flash_counts(fa) + flash_offset_counts(fa)
        o, lse = fa.flash_forward(q, k, v, **kw)
        o_p, lse_p = fa.flash_forward_reference(q, k, v, **kw)
        lse_g = torch.where(lse_p > -1e29, lse_p, fa.flash_forward_reference(q, k, v, causal=True)[1])
        delta = fa.flash_delta(o_p, do)
        bwd = (q, k, v, do, lse_g, delta)
        dq = fa.flash_backward_dq(*bwd, **kw)
        dk, dv = fa.flash_backward_dkv(*bwd, **kw)
        repeat = (fa.flash_backward_dq(*bwd, **kw), *fa.flash_backward_dkv(*bwd, **kw))
        counts = tuple(b - a for a, b in zip(counts0, flash_counts(fa) + flash_offset_counts(fa)))
        check(counts == (1, 2, 2, 1, 2, 2),
              f"offset {name}: launches (fwd, dq, dkv, offset fwd, dq, dkv) {counts}")
        dq_p = fa.flash_dq_reference(*bwd, **kw)
        dk_p, dv_p = fa.flash_dkv_reference(*bwd, **kw)
        torch.cuda.synchronize()
        where = f"offset {name}"
        for t_name, t in (("o", o), ("lse", lse), ("dq", dq), ("dk", dk), ("dv", dv)):
            check(bool(torch.isfinite(t).all()), f"{where}: {t_name} not finite")
        for t_name, a, b in zip(("dq", "dk", "dv"), (dq, dk, dv), repeat):
            check(torch.equal(a, b), f"{where}: a repeat launch changed {t_name}")
        del repeat
        errs = {"o": float((o.float() - o_p.float()).abs().max()),
                "lse": float((lse - lse_p).abs().max()),
                "dq": float((dq.float() - dq_p.float()).abs().max()),
                "dk": float((dk.float() - dk_p.float()).abs().max()),
                "dv": float((dv.float() - dv_p.float()).abs().max())}
        check(errs["lse"] <= FLASH_LSE_ATOL, f"{where}: lse err {errs['lse']} > {FLASH_LSE_ATOL}")
        readings, shares, controls = {}, {}, None
        pairs = flash_pairs(T, True, window, None, offsets)
        if pairs == 0:
            # a dead pair: exact zeros and the mask value, as the plain version
            for t_name, t in (("o", o), ("dq", dq), ("dk", dk), ("dv", dv), ("o plain", o_p)):
                check(not bool(t.any()), f"{where}: {t_name} not all zeros")
            check(bool((lse == -1e30).all()), f"{where}: lse not -1e30 everywhere")
        else:
            grads = {g: grad_readings(got, want)
                     for g, got, want in zip(("dq", "dk", "dv"), (dq, dk, dv), (dq_p, dk_p, dv_p))}
            readings = {"o": row_reading(o, o_p), **{g: r for g, (r, _) in grads.items()}}
            shares = {g: sh for g, (_, sh) in grads.items()}
            for out_name, reading in readings.items():
                check(reading <= FLASH_TOL_RMS[out_name],
                      f"{where}: {out_name} reading {reading} x row RMS > {FLASH_TOL_RMS[out_name]}")
            for g, share in shares.items():
                check(share <= FLASH_GRAD_SHARE,
                      f"{where}: {g} differs from the plain bits in a share {share} > "
                      f"{FLASH_GRAD_SHARE}")
            controls = run_controls(torch, fa, where, (q, k, v), o_p, bwd, (dq_p, dk_p, dv_p),
                                    T // 2, c.get("row_lo"), **kw)

        # library yardstick: SDPA with the block pair's mask on global positions
        i = torch.arange(T, device=dev)
        rows, cols = i[:, None] + offsets[0], i[None, :] + offsets[1]
        mask = rows >= cols
        if window is not None:
            mask = mask & (rows - cols < window)
        case = dict(case=name, B=B, H=H, Hkv=Hkv, T=T, Dh=Dh, offsets=list(offsets),
                    window=window, pairs_per_head=pairs, readings=readings, grad_shares=shares,
                    max_abs_err=errs, controls=controls,
                    tolerance=dict(row_rms=FLASH_TOL_RMS, grad_share=FLASH_GRAD_SHARE,
                                   lse_atol=FLASH_LSE_ATOL))
        case.update(flash_times(torch, fa, flush, B, (q, k, v, do), bwd, kw, mask[None, None],
                                pairs))
        cases.append(case)
        print(
            f"kernel flash offset {name:9s} offsets={offsets} window={window} pairs/head={pairs} "
            + (" ".join(f"{g}={r:.3e}" for g, r in readings.items()) + f" (limits {FLASH_TOL_RMS}) "
               + " ".join(f"share_{g}={sh:.3e}" for g, sh in shares.items())
               + f" (limit {FLASH_GRAD_SHARE})" if readings else "all zeros, lse -1e30")
            + f" lse_err={errs['lse']:.3e} (limit {FLASH_LSE_ATOL})"
            + ("" if controls is None else " controls(reading,share) "
               + " ".join(f"{n}={r:.3e},{sh}" for n, (r, sh) in controls.items())),
            flush=True,
        )
        print_times(case)
    return cases


#: the forward at head dim 128 on the reference's ``bench_ring_block`` shape
#: (``bench.py:946-1002``: one device's shard of a 16k-row ring over 8
#: devices), a causal single block and block pairs on global positions
FWD128_SHAPE = dict(B=1, H=8, Hkv=2, T=2048, Dh=128)
FWD128_CASES = {
    "causal": None,
    "offaxis": (8192, 4096),   # bench_ring_block's mid-ring rotation: every pair live
    "diagonal": (4096, 4096),  # its diagonal rotation
    "dead": (4096, 8192),      # a wrapped future block: no pair live
}


def forward_d128_phase(torch, flush) -> list[dict]:
    """The forward kernel at head dim 128 against its plain version at
    FWD128_SHAPE: the row reading and lse within the flash limits, a plain
    forward without one key tile failing them (live cases), exact zeros
    and -1e30 (dead case), times of the kernel, its plain version and SDPA
    (a boolean mask on the global positions in offset mode) beside the
    bound. Then the head-dim guard on the card: ``flash_attention`` at 96,
    outside the backward's head dims, on inputs that require a gradient
    raises, naming them, before any launch; at 128 the same call launches
    the forward, and its backward dq and dk/dv once each."""
    from beholder_tpu_torch.ops import flash_attention as fa

    dev = torch.device("cuda")
    F = torch.nn.functional
    B, H, Hkv, T, Dh = (FWD128_SHAPE[k] for k in ("B", "H", "Hkv", "T", "Dh"))
    rng = np.random.default_rng(29)

    def normal(*shape_):
        return torch.from_numpy(rng.normal(0, 1, shape_).astype(np.float32)).to(dev).bfloat16()

    q, k, v = normal(B * H, T, Dh), normal(B * Hkv, T, Dh), normal(B * Hkv, T, Dh)
    q4, k4, v4 = (t.reshape(B, -1, T, Dh) for t in (q, k, v))
    cases = []
    for name, offsets in FWD128_CASES.items():
        kw = dict(causal=True, window=None, segment_ids=None, offsets=offsets)
        o, lse = fa.flash_forward(q, k, v, **kw)
        o_p, lse_p = fa.flash_forward_reference(q, k, v, **kw)
        torch.cuda.synchronize()
        where = f"flash d128 {name}"
        check(bool(torch.isfinite(o).all() and torch.isfinite(lse).all()), f"{where}: not finite")
        lse_err = float((lse - lse_p).abs().max())
        check(lse_err <= FLASH_LSE_ATOL, f"{where}: lse err {lse_err} > {FLASH_LSE_ATOL}")
        pairs = flash_pairs(T, True, None, None, offsets or (0, 0))
        reading = control = None
        if pairs == 0:
            check(not bool(o.any()) and bool((lse == -1e30).all()),
                  f"{where}: not all zeros with lse -1e30")
        else:
            reading = row_reading(o, o_p)
            check(reading <= FLASH_TOL_RMS["o"],
                  f"{where}: o reading {reading} x row RMS > {FLASH_TOL_RMS['o']}")
            keep = torch.ones(T, dtype=torch.bool, device=dev)
            keep[T // 2:T // 2 + 64] = False
            control = row_reading(plain_forward_without(torch, fa, q, k, v, keep, causal=True,
                                                        window=None, offsets=offsets), o_p)
            check(control > 3 * FLASH_TOL_RMS["o"],
                  f"{where}: an o without one kv tile reads {control}, inside 3x the limit")
        if offsets is None:
            def sdpa():
                return F.scaled_dot_product_attention(q4, k4, v4, is_causal=True,
                                                      enable_gqa=True)
        else:
            i = torch.arange(T, device=dev)
            mask = ((i[:, None] + offsets[0]) >= (i[None, :] + offsets[1]))[None, None]

            def sdpa():
                return F.scaled_dot_product_attention(q4, k4, v4, attn_mask=mask,
                                                      enable_gqa=True)
        ms = time_ms(torch, lambda: fa.flash_forward(q, k, v, **kw), flush)
        plain_ms = time_ms(torch, lambda: fa.flash_forward_reference(q, k, v, **kw), flush,
                           reps=10)
        lib_ms = time_ms(torch, sdpa, flush)
        nbytes = 2 * q.numel() * 2 + 2 * k.numel() * 2 + B * H * T * 4  # q, o; k, v; lse
        flops = 4 * B * H * Dh * pairs
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / BF16_FLOPS * 1e3
        case = dict(case=name, B=B, H=H, Hkv=Hkv, T=T, Dh=Dh,
                    offsets=None if offsets is None else list(offsets), pairs_per_head=pairs,
                    reading_o=reading, control_o=control, lse_err=lse_err,
                    max_abs_err=float((o.float() - o_p.float()).abs().max()),
                    tolerance=dict(row_rms=FLASH_TOL_RMS["o"], lse_atol=FLASH_LSE_ATOL),
                    ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bytes=nbytes, flops=flops,
                    bound_ms=max(t_bytes, t_ops),
                    bound_by="bytes" if t_bytes >= t_ops else "operations")
        cases.append(case)
        print(f"kernel flash d128 {name:8s} offsets={offsets} pairs/head={pairs} "
              + ("all zeros, lse -1e30" if reading is None else
                 f"o={reading:.3e} (limit {FLASH_TOL_RMS['o']}) control={control:.3e}")
              + f" lse_err={lse_err:.3e} ms={ms:.4f} plain_ms={plain_ms:.4f} "
              f"library_ms={lib_ms:.4f} bound_ms={case['bound_ms']:.5f} ({case['bound_by']})",
              flush=True)

    # the guard: a differentiable call at a head dim outside the backward's
    # set (96) raises before any launch; at 128 it runs forward and backward
    before = flash_counts(fa)
    leaf96 = torch.zeros(B, H, T, 96, dtype=torch.bfloat16, device=dev, requires_grad=True)
    kv96 = torch.zeros(B, Hkv, T, 96, dtype=torch.bfloat16, device=dev)
    try:
        fa.flash_attention(leaf96, kv96, kv96, causal=True)
    except ValueError as e:
        message = str(e)
    else:
        fail("flash d96: a differentiable flash_attention call did not raise")
    torch.cuda.synchronize()
    want = str(fa.KERNEL_HEAD_DIMS["flash backward"])
    check(want in message, f"flash d96: the refusal does not name {want}: {message}")
    check(flash_counts(fa) == before, "flash d96: a kernel launched before the refusal")
    leaf = q4.detach().clone().requires_grad_()
    fa.flash_attention(leaf, k4, v4, causal=True).backward(torch.ones_like(q4))
    torch.cuda.synchronize()
    check(flash_counts(fa) == tuple(b + 1 for b in before),
          f"flash d128: a differentiable call launched {flash_counts(fa)} from {before}, "
          "not one forward, one dq and one dk/dv")
    check(bool(torch.isfinite(leaf.grad).all()), "flash d128: dq not finite")
    print(f"flash guard: at head dim 96 with gradients raises before any launch ({message}); "
          f"at 128 one forward, one dq and one dk/dv launch", flush=True)
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


def prefix_requests(rng, Request):
    """The prefix-cache traffic: run's horizons, every request sharing its
    first 129 progress samples (page 0 of its features) and statuses."""
    reqs = make_requests(rng, Request, [256] * 12, RUN_HORIZONS)
    shared = reqs[0].progress[:129]
    return [
        Request(np.concatenate([shared, r.progress[129:] - r.progress[128] + shared[-1]]),
                r.statuses, r.horizon)
        for r in reqs
    ]


def oracle_steps(torch, model, req):
    """The dense oracle's first two forecast steps of one request."""
    from beholder_tpu_torch.models import forecast_deltas

    return forecast_deltas(
        model,
        torch.from_numpy(np.asarray(req.progress))[None].cuda(),
        torch.from_numpy(np.asarray(req.statuses))[None].cuda(),
        2,
    )[0].cpu().numpy()


def main_path(torch, profile: bool = False) -> dict:
    from beholder_tpu_torch.cache import PrefixCache
    from beholder_tpu_torch.models import TelemetrySequenceModel
    from beholder_tpu_torch.models.bridge import init_params, load_flax_params
    from beholder_tpu_torch.models.serving import ContinuousBatcher, Request

    layers = 4
    model = TelemetrySequenceModel(dim=512, heads=8, kv_heads=2, layers=layers)
    load_flax_params(model, init_params(model, seed=0, bf16_matrices=True))
    rng = np.random.default_rng(0)
    wave_reqs = make_requests(rng, Request, [256] * 8, [128] * 8)
    run_reqs = make_requests(rng, Request, [256] * 12, RUN_HORIZONS)
    prefix_reqs = prefix_requests(rng, Request)
    want_wave = [oracle_steps(torch, model, r) for r in wave_reqs]
    want_run = [oracle_steps(torch, model, r) for r in run_reqs]
    want_prefix = [oracle_steps(torch, model, r) for r in prefix_reqs]
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
            if mode == "run" and family == "bf16":
                run_streams = results
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
    report.update(spec_path(torch, model, layers, run_reqs, want_run, report["bf16/run"],
                            run_streams, profile))
    report.update(intake_path(torch, model, layers, run_reqs, want_run, prefix_reqs,
                              want_prefix))
    return report


def prefix_path(torch, ContinuousBatcher, PrefixCache, model, layers, family, reqs,
                want, band, label=None) -> dict:
    """``run`` with a prefix cache and ``fused_verify=True``: a cold pass,
    then a warm pass on the same batcher, each counted; then a full
    eviction; then timed cold and warm passes on fresh batchers. Records
    and messages are keyed by ``label`` (default: the pool family)."""
    label = label or family

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
        where = f"{label}/prefix_{pass_}"
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
    check(cache.hits > 0, f"{label}/prefix: no prefix hit")
    b._evict_cached(cache.page_count)
    check(cache.page_count == 0 and int(b.state.free_top) == b.num_pages,
          f"{label}/prefix: free_top {int(b.state.free_top)} after a full eviction")
    check(int(b.state.page_ref.sum()) == 0, f"{label}/prefix: references left")
    # timed passes: each fresh batcher serves a cold pass, then a warm one
    cold_s, warm_s = [], []
    for _ in range(TIMED_RUNS):
        fresh = make()
        cold_s += timed(torch, lambda: fresh.run(reqs), runs=1)
        warm_s += timed(torch, lambda: fresh.run(reqs), runs=1)
    tokens = sum(r.horizon for r in reqs)
    for pass_, runs in (("cold", cold_s), ("warm", warm_s)):
        where = f"{label}/prefix_{pass_}"
        seconds = statistics.median(runs)
        out[where].update(seconds=seconds, tokens=tokens, tokens_per_s=tokens / seconds,
                          tokens_per_s_range=(tokens / max(runs), tokens / min(runs)))
        r = out[where]
        print(
            f"serve {label:4s} prefix_{pass_:5s} requests={len(reqs)} tokens={tokens} "
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


#: the reference's default model, TelemetrySequenceModel(dim=128, heads=4)
#: (beholder_tpu/models/sequence.py:424-425): head dim 32
DEFAULT_MODEL = dict(dim=128, heads=4, layers=2)


def default_model_path(torch) -> dict:
    """C.7 on the serving path: the reference's default model (head dim 32)
    through a fused wave (``run_waves`` with ``fused_wave=True``) and a
    prefix-cache cold and warm ``run`` (warm admission), bf16 pool; launch
    counts of both kernels, pages home, the first forecast steps against the
    dense oracle in the bf16 band."""
    from beholder_tpu_torch.cache import PrefixCache
    from beholder_tpu_torch.models import TelemetrySequenceModel
    from beholder_tpu_torch.models.bridge import init_params, load_flax_params
    from beholder_tpu_torch.models.serving import ContinuousBatcher, Request

    layers = DEFAULT_MODEL["layers"]
    model = TelemetrySequenceModel(**DEFAULT_MODEL)
    load_flax_params(model, init_params(model, seed=1, bf16_matrices=True))
    rng = np.random.default_rng(1)
    wave_reqs = make_requests(rng, Request, [256] * 8, [64] * 8)
    prefix_reqs = prefix_requests(rng, Request)
    band = FORECAST_BAND["bf16"]
    where = "d32/fused_waves"
    b = ContinuousBatcher(model, **SERVE, cache_dtype="bf16", fused_wave=True)

    def serve():
        return b.run_waves(wave_reqs, device_results=True)

    serve()
    ticks0 = b.ticks
    results, syncs, launches, chunk = counted(torch, serve)
    ticks = b.ticks - ticks0
    waves = -(-len(wave_reqs) // b.slots)
    check(launches == layers * ticks,
          f"{where}: {launches} kernel launches for {ticks} ticks x {layers} layers")
    check(chunk == layers * waves, f"{where}: {chunk} chunk kernel launches, expected "
          f"{layers * waves}")
    check(int(b.state.free_top) == b.num_pages,
          f"{where}: free_top {int(b.state.free_top)} != {b.num_pages}")
    worst = check_served(torch, where, b, wave_reqs, results,
                         [oracle_steps(torch, model, r) for r in wave_reqs], band)
    print(f"serve {where} model={DEFAULT_MODEL} requests={len(wave_reqs)} ticks={ticks} "
          f"waves={waves} kernel_launches={launches} chunk_launches={chunk} sync_calls={syncs} "
          f"first2_max_err={worst:.3e} (band rtol {band[0]}, atol {band[1]}) pages_home=yes",
          flush=True)
    report = {where: dict(launches=launches, chunk_launches=chunk, ticks=ticks, waves=waves,
                          syncs=syncs, first_steps_max_err=worst, band=band)}
    report.update(prefix_path(torch, ContinuousBatcher, PrefixCache, model, layers, "bf16",
                              prefix_reqs, [oracle_steps(torch, model, r) for r in prefix_reqs],
                              band, label="d32/bf16"))
    return report


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


#: the spec phase's draft cap: verify chunks of max_draft + 1 = 5 rows
SPEC_MAX_DRAFT = 4


class accept_spy:
    """Drafted and accepted counts of every verify step a run makes, read
    from ``AdaptiveDraftController.update`` (one call per slot per verify
    round), independently of the spec metrics, which ``intake_path`` holds
    against these counts."""

    def __enter__(self):
        from beholder_tpu_torch.spec import scheduler

        self.cls, self.real = scheduler.AdaptiveDraftController, \
            scheduler.AdaptiveDraftController.update
        self.steps = self.drafted = self.accepted = 0

        def update(ctrl, slot, drafted, accepted):
            self.steps += 1
            self.drafted += drafted
            self.accepted += accepted
            return self.real(ctrl, slot, drafted, accepted)

        self.cls.update = update
        return self

    def __exit__(self, *exc):
        self.cls.update = self.real

    def reading(self) -> dict:
        # emitted tokens a slot-step: the accepted drafts plus the verifier's
        return dict(verify_steps=self.steps, drafted=self.drafted, accepted=self.accepted,
                    mean_accept_len=(self.accepted + self.steps) / max(self.steps, 1))


def replay_drafter(reqs, streams):
    """A drafter proposing, for the request in a slot (known by its prefix),
    the tokens ``streams`` holds for it: under exact greedy every draft is
    accepted exactly when the verifier computes each position as the run
    that made ``streams`` did, so spec on == spec off is put to the test at
    every chunk row (the n-gram drafter's drafts are almost never accepted
    on random weights, so nearly every token comes from row 0)."""
    from beholder_tpu_torch.spec.drafter import Drafter

    by_prefix = {np.diff(np.asarray(r.progress, np.float32)).tobytes(): s_
                 for r, s_ in zip(reqs, streams)}

    class Replay(Drafter):
        def __init__(self):
            self.slot = {}

        def on_admit(self, slot, feats, last_status):
            self.slot[slot] = (by_prefix[np.ascontiguousarray(feats[:, 0]).tobytes()],
                               feats.shape[0])

        def propose(self, slot, history, k):
            stream, t = self.slot[slot]
            done = len(history) - t  # tokens emitted so far, the pending one too
            return np.asarray(stream[done:done + k], np.float32)

    return Replay()


def spec_path(torch, model, layers, reqs, want, run_report, run_streams,
              profile: bool = False) -> dict:
    """Speculative decoding (``ContinuousBatcher.run_spec``) on the headline
    model over ``run``'s 12 requests. bf16, exact greedy: ``NullDrafter``
    (spec off) and n-gram, each with the dense-gather and the fused verify
    (the paged chunk kernel, one launch a layer a round); n-gram must equal
    spec off bit for bit in each mode. A same-weights ``SmallModelDrafter``
    (dense) must equal spec off too. int8 and fp8 pools, n-gram, fused. The
    throughput mode of ``bench_spec`` (n-gram, ``accept_tol=1e-2``, adaptive,
    fused), timed. A replay drafter (``replay_drafter``: spec off's own
    stream as drafts) must equal spec off too, with every draft accepted,
    in each verify mode: it tests the identity at every chunk row. Every run: launch counts (chunk kernel == layers x fused
    rounds, no decode kernel), one synchronising call a verify round and one
    an admission round, pages home (the drafter's pool too), the first two
    steps within the pool's ``FORECAST_BAND`` of the dense oracle. With
    ``profile``, where a fused n-gram round's time goes (``profile_spec``)."""
    from beholder_tpu_torch.models.serving import ContinuousBatcher
    from beholder_tpu_torch.spec import SpecConfig
    from beholder_tpu_torch.spec.drafter import NullDrafter, SmallModelDrafter

    tokens = sum(r.horizon for r in reqs)
    report, streams = {}, {}

    def serve(family, mode, fused, spec, drafter=None, timed_runs=0, warm=True):
        where = f"{family}/spec_{mode}"
        band = FORECAST_BAND[family]
        b = ContinuousBatcher(model, **SERVE, cache_dtype=family, fused_verify=fused, spec=spec)
        if warm:  # one-time set-up out of the counted run
            ContinuousBatcher(model, **SERVE, cache_dtype=family, fused_verify=fused,
                              spec=spec).run_spec(reqs)
        rounds0, admits0 = b.verify_rounds, b.admission_rounds
        with accept_spy() as spy:
            results, syncs, launches, chunk = counted(torch, lambda: b.run_spec(reqs))
        rounds, admits = b.verify_rounds - rounds0, b.admission_rounds - admits0
        check(launches == 0, f"{where}: {launches} decode kernel launches")
        want_chunk = layers * rounds if fused else 0
        check(chunk == want_chunk,
              f"{where}: {chunk} chunk kernel launches for {rounds} rounds x {layers} layers"
              + ("" if fused else " (dense verify launches none)"))
        check(chunk > 0 or not fused, f"{where}: the chunk kernel never launched")
        if drafter is None:
            check(syncs == rounds + admits,
                  f"{where}: {syncs} synchronising calls for {rounds} verify rounds and "
                  f"{admits} admission rounds (one readback each)")
        check(int(b.state.free_top) == b.num_pages,
              f"{where}: free_top {int(b.state.free_top)} != {b.num_pages}")
        if drafter is not None:
            check(int(drafter.state.free_top) == drafter.num_pages,
                  f"{where}: the drafter's free_top {int(drafter.state.free_top)} != "
                  f"{drafter.num_pages}")
        worst = check_served(torch, where, b, reqs, results, want, band)
        vs_run = max(float(np.abs(g - r).max()) for g, r in zip(results, run_streams))
        rec = dict(launches=launches, chunk_launches=chunk, rounds=rounds, admission_rounds=admits,
                   syncs=syncs, first_steps_max_err=worst, band=band,
                   max_diff_vs_bf16_run=vs_run, **spy.reading())
        line = (f"serve {where:30s} rounds={rounds} admission_rounds={admits} "
                f"chunk_launches={chunk} sync_calls={syncs} verify_steps={spy.steps} "
                f"drafted={spy.drafted} accepted={spy.accepted} "
                f"mean_accept_len={rec['mean_accept_len']:.4f} first2_max_err={worst:.3e} "
                f"(band rtol {band[0]}, atol {band[1]}) max_diff_vs_bf16_run={vs_run:.3e}")
        if timed_runs:
            runs = timed(torch, lambda: b.run_spec(reqs), runs=timed_runs)
            seconds = statistics.median(runs)
            rec.update(seconds=seconds, tokens=tokens, tokens_per_s=tokens / seconds,
                       tokens_per_s_range=(tokens / max(runs), tokens / min(runs)))
            line += (f" tokens={tokens} seconds={seconds:.4f} tokens/s={tokens / seconds:.1f} "
                     f"(range {tokens / max(runs):.1f}-{tokens / min(runs):.1f} over "
                     f"{timed_runs} runs; bf16/run {run_report['tokens_per_s']:.1f})")
        print(line + " pages_home=yes", flush=True)
        report[where] = rec
        streams[where] = results
        return results

    for verify in ("dense", "fused"):
        fused = verify == "fused"
        off = serve("bf16", f"{verify}/off", fused,
                    SpecConfig(max_draft=SPEC_MAX_DRAFT, drafter=NullDrafter()))
        on = serve("bf16", f"{verify}/ngram", fused, SpecConfig(max_draft=SPEC_MAX_DRAFT),
                   timed_runs=TIMED_RUNS)
        n_diff = sum(int((a != b_).sum()) for a, b_ in zip(on, off))
        biggest = max(float(np.abs(a - b_).max()) for a, b_ in zip(on, off))
        print(f"spec bf16 {verify} verify, ngram vs off: {n_diff} of {tokens} tokens differ, "
              f"largest difference {biggest:.3e}", flush=True)
        report[f"bf16/spec_{verify}/ngram"]["vs_off"] = dict(tokens_differ=n_diff,
                                                             max_diff=biggest)
        check(n_diff == 0, f"spec {verify}: ngram differs from spec off in {n_diff} tokens "
              f"(largest {biggest:.3e})")
        replay = serve("bf16", f"{verify}/replay", fused,
                       SpecConfig(max_draft=SPEC_MAX_DRAFT, adaptive=False,
                                  drafter=replay_drafter(reqs, off)))
        rec = report[f"bf16/spec_{verify}/replay"]
        n_diff = sum(int((a != b_).sum()) for a, b_ in zip(replay, off))
        biggest = max(float(np.abs(a - b_).max()) for a, b_ in zip(replay, off))
        print(f"spec bf16 {verify} verify, replay vs off: {n_diff} of {tokens} tokens differ, "
              f"largest difference {biggest:.3e}; {rec['accepted']} of {rec['drafted']} "
              f"drafts accepted", flush=True)
        rec["vs_off"] = dict(tokens_differ=n_diff, max_diff=biggest)
        check(n_diff == 0 and rec["accepted"] == rec["drafted"] > 0,
              f"spec {verify}: replay differs from spec off in {n_diff} tokens (largest "
              f"{biggest:.3e}), {rec['accepted']} of {rec['drafted']} drafts accepted")
    fused_vs_dense = max(float(np.abs(a - b_).max())
                         for a, b_ in zip(streams["bf16/spec_fused/off"],
                                          streams["bf16/spec_dense/off"]))
    print(f"spec fused vs dense verify (spec off): largest difference {fused_vs_dense:.3e}",
          flush=True)
    report["bf16/spec_fused/off"]["max_diff_vs_dense"] = fused_vs_dense

    # the target's own weights as the drafter, dense verify: one run, untimed
    drafter = SmallModelDrafter(model, num_pages=SERVE["num_pages"],
                                page_size=SERVE["page_size"], slots=SERVE["slots"],
                                max_pages_per_seq=SERVE["max_pages_per_seq"])
    same = serve("bf16", "dense/same_weights", False,
                 SpecConfig(max_draft=SPEC_MAX_DRAFT, drafter=drafter), drafter=drafter,
                 warm=False)
    n_diff = sum(int((a != b_).sum()) for a, b_ in zip(same, streams["bf16/spec_dense/off"]))
    check(n_diff == 0, f"spec dense/same_weights: differs from spec off in {n_diff} tokens")
    for family in ("int8", "fp8"):
        serve(family, "fused/ngram", True, SpecConfig(max_draft=SPEC_MAX_DRAFT))
    if profile:
        report["bf16/spec_fused/ngram"]["profile"] = profile_spec(
            torch, ContinuousBatcher(model, **SERVE, fused_verify=True,
                                     spec=SpecConfig(max_draft=SPEC_MAX_DRAFT)), reqs)
    # bench_spec's throughput mode
    serve("bf16", "fused/throughput", True,
          SpecConfig(max_draft=SPEC_MAX_DRAFT, accept_tol=1e-2, adaptive=True),
          timed_runs=TIMED_RUNS)
    return report


class Lapsing:
    """A deadline that passes the claim-time check and expires at the next
    sweep (``tests/test_slo.py:269-277``)."""

    def __init__(self):
        self.checks = 0

    @property
    def expired(self):
        self.checks += 1
        return self.checks > 1


def traced_run(where, tracer, fr, fn):
    """Run ``fn`` with the recorder emptied first; check that exactly one
    root span opened and that every event the run recorded carries its
    trace id. Returns (result, events)."""
    fr.clear()
    roots0 = len([s for s in tracer.reporter.spans if s.context.parent_id == 0])
    result = fn()
    roots = [s for s in tracer.reporter.spans if s.context.parent_id == 0][roots0:]
    check(len(roots) == 1, f"{where}: {len(roots)} root spans for one call")
    trace_hex = f"{roots[0].context.trace_id:032x}"
    events = fr.events()
    check(bool(events), f"{where}: the recorder holds no event")
    stray = [e["name"] for e in events if e["trace_id"] != trace_hex]
    check(not stray, f"{where}: events outside the run span's trace: {stray[:5]}")
    return result, events


def ceiling_fracs(where, events) -> list[float]:
    """The ``ceiling_frac`` stamped on every dispatch event (those tagged
    with a kernel family): each finite and >= 0."""
    fracs = [e["args"].get("ceiling_frac") for e in events if e["args"].get("family")]
    check(bool(fracs), f"{where}: no dispatch event carries a kernel family")
    check(all(f is not None and np.isfinite(f) and f >= 0 for f in fracs),
          f"{where}: ceiling_frac missing or not finite on a dispatch event: {fracs[:5]}")
    return fracs


def intake_path(torch, model, layers, run_reqs, want_run, prefix_reqs, want_prefix) -> dict:
    """The batcher's intake, deadlines and instruments on the headline model,
    bf16 pool. Every armed batcher carries a ``Registry``, a ``Tracer`` on an
    ``InMemoryReporter`` and a ``FlightRecorder`` whose ``RooflineAttributor``
    measured its f32 matmul ceiling on the card before any counted run.

    1. ``max_pending=8``: ``submit`` ``run``'s 12 requests and one oversized
       (8 accepted, 4 ``queue_full``, 1 ``oversized``); ``run_pending`` goes
       to ``run_waves``: decode launches == layers x ticks, the streams and
       synchronising calls those of a bare batcher's ``run_waves`` on the
       same 8, pages home; the other 4 drain next; the shed counter and the
       served requests and tokens read back from ``render()``;
    2. a ``PrefixCache(metrics=registry)`` and ``fused_verify``: cold and
       warm ``run_pending`` go to ``run``; chunk launches == layers x warm
       admits; the cache's counters on ``render()``; streams and syncs those
       of a bare prefix batcher;
    3. ``spec``, fused, replaying spec off's stream: ``run_pending`` goes to
       ``run_spec``; the spec counters equal the run's own drafted and
       accepted counts; ``spec.accept`` instants and ``verify`` rounds tagged
       ``paged_chunk:bf16``; the stream is spec off's bit for bit;
    4. deadlines: an expired one returns no tokens, a lapsing one a partial
       stream; the counter reads 2; pages home;
    5. each run's recorder events carry its span's trace id; ``ceiling_frac``
       on dispatch events, finite and >= 0 (reported, not gated);
    5b. a batcher whose recorder holds a default ``RooflineAttributor()``,
       measuring in the background inside the counted window: the syncs,
       launches and streams of a bare ``run``;
    6. tokens/s of ``run_pending`` -> ``run`` armed beside a bare ``run``,
       ten alternating pairs, and the Python function calls one call of
       each side makes (reported, not gated)."""
    from beholder_tpu_torch.cache import PrefixCache
    from beholder_tpu_torch.metrics import Registry
    from beholder_tpu_torch.models.serving import (
        ContinuousBatcher,
        DeadlineExceededResult,
        Request,
    )
    from beholder_tpu_torch.obs import FlightRecorder, RooflineAttributor
    from beholder_tpu_torch.reliability import Deadline
    from beholder_tpu_torch.spec import SpecConfig
    from beholder_tpu_torch.spec.drafter import NullDrafter
    from beholder_tpu_torch.tracing import InMemoryReporter, Tracer

    card = card_line()
    band = FORECAST_BAND["bf16"]
    attributor = RooflineAttributor(interval_s=3600.0)
    ceilings = attributor.ceilings()
    print(f"intake: attributor f32 matmul ceiling {ceilings['matmul_flops_per_s'] / 1e12:.4f} "
          f"TFLOP/s (n={ceilings['matmul_n']}), elementwise "
          f"{ceilings['memcpy_bytes_per_s'] / 1e9:.1f} GB/s; {card}", flush=True)
    out: dict = {}

    def armed(registry, **kw):
        tracer = Tracer("chip_smoke", reporter=InMemoryReporter())
        fr = FlightRecorder(ring_size=1 << 16, attributor=attributor)
        b = ContinuousBatcher(model, **SERVE, metrics=registry, tracer=tracer,
                              flight_recorder=fr, **kw)
        return b, tracer, fr

    def same_bits(where, got, want):
        n = sum(int((np.asarray(g) != np.asarray(w)).sum()) for g, w in zip(got, want))
        check(len(got) == len(want) and n == 0,
              f"{where}: {n} tokens differ from the bare path")

    # 1. bounded intake -> run_waves
    registry = Registry()
    b, tracer, fr = armed(registry, max_pending=8)
    oversized = Request(run_reqs[0].progress, run_reqs[0].statuses, 400)
    outcomes = [b.submit(r) for r in run_reqs + [oversized]]
    reasons = {}
    for o in outcomes:
        reasons[o.reason or "accepted"] = reasons.get(o.reason or "accepted", 0) + 1
    check(reasons == {"accepted": 8, "queue_full": 4, "oversized": 1},
          f"intake: outcomes {reasons}, expected 8 accepted, 4 queue_full, 1 oversized")
    check(int(b.state.free_top) == b.num_pages, "intake: a shed request touched a page")
    bare = ContinuousBatcher(model, **SERVE)
    ticks0 = bare.ticks
    want, bare_syncs, bare_launches, _ = counted(torch, lambda: bare.run_waves(run_reqs[:8]))
    bare_ticks = bare.ticks - ticks0
    ticks0 = b.ticks
    (got, events), syncs, launches, chunk = counted(
        torch, lambda: traced_run("intake/waves", tracer, fr, b.run_pending))
    ticks = b.ticks - ticks0
    check(launches == layers * ticks and ticks == bare_ticks,
          f"intake/waves: {launches} decode launches for {ticks} ticks x {layers} layers "
          f"(bare: {bare_ticks} ticks)")
    check(chunk == 0, f"intake/waves: {chunk} chunk launches")
    same_bits("intake/waves", got, want)
    check(syncs == bare_syncs,
          f"intake/waves: {syncs} synchronising calls armed, {bare_syncs} bare")
    check({"req.claim", "wave", "req.retire", "readback"} <= {e["name"] for e in events},
          "intake/waves: recorder phases missing")
    worst = check_served(torch, "intake/waves", b, run_reqs[:8], got, want_run[:8], band)
    check(int(b.state.free_top) == b.num_pages, "intake/waves: pages not home")
    fracs = ceiling_fracs("intake/waves", events)
    out["bf16/intake_waves"] = dict(
        launches=launches, chunk_launches=chunk, ticks=ticks, syncs=syncs,
        bare_syncs=bare_syncs, outcomes=reasons, first_steps_max_err=worst,
        ceiling_frac_median=statistics.median(fracs), events=len(events))
    for r in run_reqs[8:]:
        check(b.submit(r).accepted, "intake: the other 4 were refused after the drain")
    (rest, _), syncs2, launches2, chunk2 = counted(
        torch, lambda: traced_run("intake/drain", tracer, fr, b.run_pending))
    check(int(b.state.free_top) == b.num_pages, "intake/drain: pages not home")
    served = got + rest
    text = registry.render()
    tokens = sum(len(r) for r in served)
    for line in ('beholder_serving_shed_total{reason="queue_full"} 4',
                 'beholder_serving_shed_total{reason="oversized"} 1',
                 f"beholder_serving_requests_total {len(served)}",
                 f"beholder_serving_tokens_total {tokens}",
                 "beholder_serving_admitted_total 12"):
        check(line in text, f"intake: render() lacks {line!r}")
    out["bf16/intake_drain"] = dict(launches=launches2, chunk_launches=chunk2, syncs=syncs2,
                                    requests=len(served), tokens=tokens)
    print(f"serve bf16 intake_waves submitted=13 {reasons} run_pending->run_waves "
          f"ticks={ticks} kernel_launches={launches} sync_calls={syncs} (bare {bare_syncs}) "
          f"bitwise_vs_bare=yes events={len(events)} ceiling_frac median="
          f"{statistics.median(fracs):.6f} (min {min(fracs):.6f}, max {max(fracs):.6f}) "
          f"first2_max_err={worst:.3e}; drained the other 4: requests_total={len(served)} "
          f"tokens_total={tokens} shed queue_full=4 oversized=1 pages_home=yes", flush=True)

    # 2. prefix cache -> run
    registry = Registry()
    cache = PrefixCache(SERVE["page_size"], metrics=registry)
    b, tracer, fr = armed(registry, max_pending=12, prefix_cache=cache, fused_verify=True)
    bare = ContinuousBatcher(model, **SERVE, prefix_cache=PrefixCache(SERVE["page_size"]),
                             fused_verify=True)
    for pass_ in ("cold", "warm"):
        where = f"intake/prefix_{pass_}"
        want, bare_syncs, _, bare_chunk = counted(torch, lambda: bare.run(prefix_reqs))
        for r in prefix_reqs:
            check(b.submit(r).accepted, f"{where}: a request was shed")
        hits0, rounds0 = cache.hits, b.admission_rounds
        (got, events), syncs, launches, chunk = counted(
            torch, lambda: traced_run(where, tracer, fr, b.run_pending))
        hits, rounds = cache.hits - hits0, b.admission_rounds - rounds0
        check("tick" in {e["name"] for e in events}, f"{where}: run_pending did not go to run")
        check(chunk == layers * hits and chunk == bare_chunk,
              f"{where}: {chunk} chunk launches for {hits} warm admits x {layers} layers "
              f"(bare {bare_chunk})")
        if pass_ == "warm":
            check(hits == len(prefix_reqs), f"{where}: {hits} hits")
        check(syncs == bare_syncs == 1 + rounds,
              f"{where}: {syncs} synchronising calls armed, {bare_syncs} bare, "
              f"{rounds} admission rounds")
        same_bits(where, got, want)
        worst = check_served(torch, where, b, prefix_reqs, got, want_prefix, band)
        fracs = ceiling_fracs(where, events)
        out[f"bf16/intake_prefix_{pass_}"] = dict(
            launches=launches, chunk_launches=chunk, warm_admits=hits, rounds=rounds,
            syncs=syncs, first_steps_max_err=worst, ceiling_frac_median=statistics.median(fracs))
        print(f"serve bf16 intake_prefix_{pass_} run_pending->run warm_admits={hits} "
              f"admission_rounds={rounds} kernel_launches={launches} chunk_launches={chunk} "
              f"sync_calls={syncs} (bare {bare_syncs}) bitwise_vs_bare=yes ceiling_frac "
              f"median={statistics.median(fracs):.6f}", flush=True)
    text = registry.render()
    for name, value in (("hits", cache.hits), ("misses", cache.misses),
                        ("hit_tokens", cache.hit_tokens), ("evictions", cache.evictions),
                        ("prefill_tokens", cache.prefill_tokens)):
        line = f"beholder_prefix_cache_{name}_total {value}"
        check(line in text, f"intake/prefix: render() lacks {line!r}")
    check(f"beholder_prefix_cache_cached_pages {cache.page_count}" in text,
          "intake/prefix: cached pages gauge")
    check(int(b.state.free_top) == b.num_pages - cache.page_count, "intake/prefix: pages")

    # 3. spec (fused, replay) -> run_spec
    off_b = ContinuousBatcher(model, **SERVE, fused_verify=True,
                              spec=SpecConfig(max_draft=SPEC_MAX_DRAFT, drafter=NullDrafter()))
    off = off_b.run_spec(run_reqs)
    registry = Registry()
    b, tracer, fr = armed(registry, max_pending=12, fused_verify=True,
                          spec=SpecConfig(max_draft=SPEC_MAX_DRAFT, adaptive=False,
                                          drafter=replay_drafter(run_reqs, off)))
    for r in run_reqs:
        check(b.submit(r).accepted, "intake/spec: a request was shed")
    vr0, ad0 = b.verify_rounds, b.admission_rounds
    with accept_spy() as spy:
        (got, events), syncs, launches, chunk = counted(
            torch, lambda: traced_run("intake/spec", tracer, fr, b.run_pending))
    rounds, admits = b.verify_rounds - vr0, b.admission_rounds - ad0
    check(launches == 0 and chunk == layers * rounds,
          f"intake/spec: {chunk} chunk launches for {rounds} rounds x {layers} layers, "
          f"{launches} decode launches")
    check(syncs == rounds + admits, f"intake/spec: {syncs} synchronising calls for {rounds} "
          f"verify rounds and {admits} admission rounds")
    same_bits("intake/spec (vs spec off)", got, off)
    drafted = registry.find("beholder_spec_drafted_tokens_total").value()
    accepted = registry.find("beholder_spec_accepted_tokens_total").value()
    steps = registry.find("beholder_spec_verify_steps_total").value()
    check((drafted, accepted, steps) == (spy.drafted, spy.accepted, spy.steps),
          f"intake/spec: counters drafted={drafted} accepted={accepted} steps={steps}, the "
          f"run's own {spy.drafted}, {spy.accepted}, {spy.steps}")
    check(accepted == drafted > 0, f"intake/spec: replay accepted {accepted} of {drafted}")
    names = [e["name"] for e in events]
    fams = {e["args"].get("family") for e in events if e["name"] == "verify"}
    check(names.count("spec.accept") == spy.steps,
          f"intake/spec: {names.count('spec.accept')} spec.accept instants, {spy.steps} steps")
    check(fams == {"paged_chunk:bf16"}, f"intake/spec: verify families {fams}")
    check(names.count("verify") == rounds and "device_wait" in names,
          "intake/spec: verify rounds or device_wait slices missing")
    check(int(b.state.free_top) == b.num_pages, "intake/spec: pages not home")
    fracs = ceiling_fracs("intake/spec", events)
    out["bf16/intake_spec"] = dict(
        launches=launches, chunk_launches=chunk, rounds=rounds, admission_rounds=admits,
        syncs=syncs, drafted=drafted, accepted=accepted, verify_steps=steps,
        ceiling_frac_median=statistics.median(fracs))
    print(f"serve bf16 intake_spec run_pending->run_spec rounds={rounds} chunk_launches={chunk} "
          f"sync_calls={syncs} spec counters drafted={drafted:g} accepted={accepted:g} "
          f"steps={steps:g} (the run's own {spy.drafted}, {spy.accepted}, {spy.steps}) "
          f"spec.accept={names.count('spec.accept')} verify family paged_chunk:bf16 "
          f"vs spec off: 0 tokens differ", flush=True)

    # 4. deadlines
    registry = Registry()
    b, tracer, fr = armed(registry)
    short, long_, third = run_reqs[7], run_reqs[0], run_reqs[1]
    reqs = [short._replace(horizon=3), long_._replace(deadline=Lapsing()),
            third._replace(deadline=Deadline.after(-1.0))]
    (res, events), syncs, launches, chunk = counted(
        torch, lambda: traced_run("intake/deadline", tracer, fr, lambda: b.run(reqs)))
    check(chunk == 0, f"intake/deadline: {chunk} chunk launches")
    check(isinstance(res[2], DeadlineExceededResult) and len(res[2].tokens) == 0,
          f"intake/deadline: the expired request gave {res[2]!r}")
    check(isinstance(res[1], DeadlineExceededResult)
          and 1 <= len(res[1].tokens) < long_.horizon,
          f"intake/deadline: the lapsing request gave {res[1]!r}")
    check(isinstance(res[0], np.ndarray) and res[0].shape == (3,), "intake/deadline: short")
    # the partial stream is the head of the same request's stream on a bare
    # batcher, served with the short one (the expired one never took a slot)
    full = ContinuousBatcher(model, **SERVE).run([short._replace(horizon=3), long_])
    partial = np.asarray(res[1].tokens)
    same_bits("intake/deadline (short)", [res[0]], [full[0]])
    same_bits("intake/deadline (partial)", [partial], [np.asarray(full[1])[:len(partial)]])
    counter = registry.find("beholder_failover_deadline_exceeded_total")
    check(counter is not None and counter.value() == 2,
          f"intake/deadline: counter {None if counter is None else counter.value()}")
    check(int(b.state.free_top) == b.num_pages and not bool(b.state.active.any()),
          "intake/deadline: pages not home")
    out["bf16/intake_deadline"] = dict(launches=launches, chunk_launches=chunk, syncs=syncs,
                                       partial_tokens=len(res[1].tokens))
    print(f"serve bf16 intake_deadline expired_at_claim=0 tokens lapsing="
          f"{len(res[1].tokens)} of {long_.horizon} tokens (bitwise the head of its bare "
          f"stream) deadline_exceeded_total=2 sync_calls={syncs} chunk_launches={chunk} "
          f"pages_home=yes", flush=True)

    # 5b. the attributor as users build it (defaults: its first ceiling is
    # measured in the background when the first dispatch is recorded, inside
    # the counted window): run_pending -> run against a bare run
    bare = ContinuousBatcher(model, **SERVE)
    want, bare_syncs, bare_launches, bare_chunk = counted(torch, lambda: bare.run(run_reqs))
    check(bare_chunk == 0, f"intake/run (bare): {bare_chunk} chunk launches")
    fresh = RooflineAttributor()
    fb = ContinuousBatcher(model, **SERVE, metrics=Registry(), max_pending=12,
                           tracer=Tracer("chip_smoke", reporter=InMemoryReporter()),
                           flight_recorder=FlightRecorder(ring_size=1 << 16, attributor=fresh))
    for r in run_reqs:
        check(fb.submit(r).accepted, "intake/defaults: a request was shed")
    got, syncs, launches, chunk = counted(torch, lambda: fb.run_pending(waves=False))
    started = fresh._ceilings is not None or fresh._measuring.locked()
    fresh_ceil = fresh.ceilings()  # waits for the background measurement
    check(started, "intake/defaults: the recorded dispatches started no measurement")
    same_bits("intake/defaults", got, want)
    check(syncs == bare_syncs and launches == bare_launches and chunk == 0,
          f"intake/defaults: {syncs} synchronising calls, {launches} decode and {chunk} "
          f"chunk launches with a default attributor, {bare_syncs} and {bare_launches} bare")
    out["bf16/intake_defaults"] = dict(
        launches=launches, chunk_launches=chunk, syncs=syncs, bare_syncs=bare_syncs,
        ceilings=fresh_ceil)
    print(f"serve bf16 intake_defaults run_pending->run with RooflineAttributor() measuring "
          f"in the background: sync_calls={syncs} (bare {bare_syncs}) launches={launches} "
          f"vs bare: 0 tokens differ; its ceiling under load "
          f"{fresh_ceil['matmul_flops_per_s'] / 1e12:.4f} TFLOP/s (n={fresh_ceil['matmul_n']}), "
          f"elementwise {fresh_ceil['memcpy_bytes_per_s'] / 1e9:.1f} GB/s; {card}", flush=True)

    # 6. overhead: run_pending -> run armed against a bare run, in pairs
    # whose order alternates
    b, tracer, fr = armed(Registry(), max_pending=12)

    def pending():
        for r in run_reqs:
            b.submit(r)
        return b.run_pending(waves=False)

    got, syncs, launches, chunk = counted(torch, pending)
    same_bits("intake/run", got, want)
    check(syncs == bare_syncs and launches == bare_launches and chunk == 0,
          f"intake/run: {syncs} synchronising calls, {launches} decode and {chunk} chunk "
          f"launches armed, {bare_syncs} and {bare_launches} bare")
    bare_s, armed_s = [], []
    for i in range(OVERHEAD_PAIRS):
        for side in (("bare", "armed") if i % 2 == 0 else ("armed", "bare")):
            if side == "bare":
                bare_s += timed(torch, lambda: bare.run(run_reqs), runs=1)
            else:
                armed_s += timed(torch, pending, runs=1)
    tokens = sum(r.horizon for r in run_reqs)
    events_per_run = sum(1 for e in fr.events() if e["ph"] == "X") / (1 + OVERHEAD_PAIRS)
    b_med, a_med = statistics.median(bare_s), statistics.median(armed_s)
    pair_ratios = sorted(bs / a for bs, a in zip(bare_s, armed_s))
    # the host work each side does, as a count: Python function calls of
    # one call under cProfile (the times under the profiler are not kept)
    py_calls = {}
    for side, fn in (("bare", lambda: bare.run(run_reqs)), ("armed", pending)):
        prof = cProfile.Profile()
        prof.runcall(fn)
        torch.cuda.synchronize()
        py_calls[side] = pstats.Stats(prof).total_calls
    out["bf16/intake_overhead"] = dict(
        launches=launches, chunk_launches=chunk, syncs=syncs, bare_syncs=bare_syncs,
        tokens=tokens, bare_tokens_per_s=tokens / b_med, armed_tokens_per_s=tokens / a_med,
        bare_range=(tokens / max(bare_s), tokens / min(bare_s)),
        armed_range=(tokens / max(armed_s), tokens / min(armed_s)),
        armed_over_bare=b_med / a_med, pair_ratios=pair_ratios,
        pair_ratio_median=statistics.median(pair_ratios), events_per_run=events_per_run,
        card=card,
        ceilings=ceilings, python_calls=py_calls)
    print(f"serve bf16 intake_overhead run_pending->run armed {tokens / a_med:.1f} tokens/s "
          f"(range {tokens / max(armed_s):.1f}-{tokens / min(armed_s):.1f}) vs bare run "
          f"{tokens / b_med:.1f} (range {tokens / max(bare_s):.1f}-{tokens / min(bare_s):.1f}), "
          f"median of {OVERHEAD_PAIRS} each in alternating pairs: armed/bare "
          f"{b_med / a_med:.4f}; per pair median {statistics.median(pair_ratios):.4f} "
          f"(range {pair_ratios[0]:.4f}-{pair_ratios[-1]:.4f}, "
          f"{sum(r < 1 for r in pair_ratios)} of {OVERHEAD_PAIRS} below 1); "
          f"{events_per_run:.0f} recorded phase events a run; sync_calls {syncs} armed, "
          f"{bare_syncs} bare; Python calls a run {py_calls['armed']} armed, "
          f"{py_calls['bare']} bare (x{py_calls['armed'] / py_calls['bare']:.4f}); {card}",
          flush=True)
    return out


def profile_spec(torch, b, reqs) -> dict:
    """Where a fused spec round's time goes: one warm ``run_spec`` on the
    host clock with the time spent in readbacks summed (``Tensor.cpu``
    wrapped: a readback waits for the queued device work), then one under
    torch.profiler for the device's busy time and the chunk kernel's."""
    from torch.profiler import ProfilerActivity, profile

    b.run_spec(reqs)
    waits = []
    real = torch.Tensor.cpu

    def cpu(t, *a, **kw):
        t0 = time.perf_counter()
        out = real(t, *a, **kw)
        waits.append(time.perf_counter() - t0)
        return out

    rounds0 = b.verify_rounds
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    torch.Tensor.cpu = cpu
    try:
        b.run_spec(reqs)
    finally:
        torch.Tensor.cpu = real
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    rounds = b.verify_rounds - rounds0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        b.run_spec(reqs)
        torch.cuda.synchronize()
    rows = device_rows(prof.key_averages())
    device_ms = sum(dev_us(e) for e in rows) / 1e3
    chunk_ms = sum(dev_us(e) for e in rows if "paged_chunk" in e.key) / 1e3
    out = dict(rounds=rounds, wall_ms=wall * 1e3, readback_wait_ms=sum(waits) * 1e3,
               readbacks=len(waits), device_ms=device_ms, chunk_kernel_ms=chunk_ms,
               device_busy_share=device_ms / (wall * 1e3))
    per = {k: out[k] / rounds for k in ("wall_ms", "readback_wait_ms", "device_ms",
                                         "chunk_kernel_ms")}
    print(f"profile bf16 spec fused ngram: rounds={rounds} wall_ms={out['wall_ms']:.1f} "
          f"a round: wall {per['wall_ms']:.3f} ms, host {per['wall_ms'] - per['readback_wait_ms']:.3f}, "
          f"readback wait {per['readback_wait_ms']:.3f}, device busy {per['device_ms']:.3f} "
          f"(chunk kernel {per['chunk_kernel_ms']:.4f}); device_busy_share="
          f"{out['device_busy_share']:.4f}", flush=True)
    return out


def chunk_ab(torch, flush, parent: Path) -> dict:
    """``--chunk-parent``: the chunk kernel built from ``parent``'s source
    (A) against this checkout's (B) in one process. Every case of
    ``chunk_kernel_phase`` in turns A B B A (each must pass its checks), then
    the fused verify with each: spec off and the replay of its stream on
    the headline model over ``run``'s requests, the tokens that differ and
    the drafts accepted. Returns the times per case and side and the
    readings."""
    import ctypes

    from beholder_tpu_torch import csrc
    from beholder_tpu_torch.models import TelemetrySequenceModel
    from beholder_tpu_torch.models.bridge import init_params, load_flax_params
    from beholder_tpu_torch.models.serving import ContinuousBatcher, Request
    from beholder_tpu_torch.ops import paged_attention as pa
    from beholder_tpu_torch.spec import SpecConfig
    from beholder_tpu_torch.spec.drafter import NullDrafter

    lib = csrc.BUILD_DIR / "libpaged_chunk-parent.so"
    out = subprocess.run(
        [csrc.find_nvcc(), *csrc.NVCC_FLAGS, "-o", str(lib),
         str(parent / "beholder_tpu_torch" / "csrc" / "paged_chunk.cu")],
        capture_output=True, text=True,
    )
    check(out.returncode == 0, f"chunk A/B: nvcc failed on {parent}:\n{out.stdout}{out.stderr}")
    libs = {"A": ctypes.CDLL(str(lib.resolve())), "B": csrc.load("paged_chunk")}

    def use(side):
        csrc._loaded["paged_chunk"] = libs[side]
        pa._chunk_lib = None

    times: dict = {}
    for side in "ABBA":
        use(side)
        print(f"chunk A/B: side {side}", flush=True)
        for c in chunk_kernel_phase(torch, flush):
            key = f"{c['shape']}/{c['pool']}/window={c['window']}"
            times.setdefault(key, {"A": [], "B": []})[side].append(c["ms"])
    for key, t in times.items():
        print(f"chunk A/B {key:28s} A={t['A']} B={t['B']} "
              f"B/A={statistics.mean(t['B']) / statistics.mean(t['A']):.3f}", flush=True)

    model = TelemetrySequenceModel(dim=512, heads=8, kv_heads=2, layers=4)
    load_flax_params(model, init_params(model, seed=0, bf16_matrices=True))
    rng = np.random.default_rng(0)
    make_requests(rng, Request, [256] * 8, [128] * 8)  # main_path's draws, in order
    reqs = make_requests(rng, Request, [256] * 12, RUN_HORIZONS)
    readings = {}
    for side in "AB":
        use(side)

        def spec(drafter, **kw):
            return ContinuousBatcher(model, **SERVE, fused_verify=True, spec=SpecConfig(
                max_draft=SPEC_MAX_DRAFT, drafter=drafter, **kw))

        off = spec(NullDrafter()).run_spec(reqs)
        with accept_spy() as spy:
            replay = spec(replay_drafter(reqs, off), adaptive=False).run_spec(reqs)
        diff = [np.abs(a - b_) for a, b_ in zip(replay, off)]
        readings[side] = dict(tokens_differ=int(sum((d > 0).sum() for d in diff)),
                              max_diff=max(float(d.max()) for d in diff),
                              accepted=spy.accepted, drafted=spy.drafted)
        print(f"chunk A/B side {side}: fused replay vs off: {readings[side]['tokens_differ']} "
              f"of {sum(r.horizon for r in reqs)} tokens differ, largest "
              f"{readings[side]['max_diff']:.3e}; {spy.accepted} of {spy.drafted} drafts "
              "accepted", flush=True)
    use("B")
    return {"parent": str(parent), "times": times, "identity": readings}


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


def flash_offset_counts(fa) -> tuple[int, int, int]:
    """The flash wrappers' launches in the ring block-pair (offset) mode."""
    return (fa.flash_forward.offset_launches, fa.flash_backward_dq.offset_launches,
            fa.flash_backward_dkv.offset_launches)


def counted_flash(torch, fa, fn):
    """Run ``fn`` with the flash launch counts, all and offset-mode, set to
    0 just before and read just after. Returns (result, (forward, dq,
    dk/dv), the same in offset mode)."""
    torch.cuda.synchronize()
    for wrapper in (fa.flash_forward, fa.flash_backward_dq, fa.flash_backward_dkv):
        wrapper.launches = wrapper.offset_launches = 0
    result = fn()
    counts, offset_counts = flash_counts(fa), flash_offset_counts(fa)
    torch.cuda.synchronize()
    return result, counts, offset_counts


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
    t0 = time.perf_counter()
    state, losses, step_ms, launches, _ = train_steps(torch, fa, state, feats, targets)
    wall = time.perf_counter() - t0
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
    prof, (state, _) = profile_step(torch, lambda: seq_train_step(state, feats, targets))
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
    params = init_params(TelemetrySequenceModel(**TRAIN_MODEL), 2)
    report["grads_vs_full"] = grads_vs_full(torch, "flash", TRAIN_MODEL, params)

    # 4. remat: step-1 gradients bitwise no-remat's, forward launches doubled
    remat, remat_launches, _ = remat_grads(torch, fa, "remat", TRAIN_MODEL, params, feats,
                                           targets)
    check(remat_launches == (2 * layers, layers, layers),
          f"remat: launches {remat_launches} for one step, expected {(2 * layers, layers, layers)}")
    report.update(side_run(torch, fa, "remat", remat, feats, targets, (2 * layers, layers, layers)))
    del remat
    windowed = TelemetrySequenceModel(**TRAIN_MODEL, window=512)
    load_flax_params(windowed, params)
    report.update(side_run(torch, fa, "window512", windowed, feats, targets,
                           (layers, layers, layers)))
    return report


def train_steps(torch, fa, state, feats, targets):
    """TRAIN_STEPS ``seq_train_step``s, each timed with CUDA events, every
    flash launch counted. Returns (state, losses, step ms, launches,
    offset-mode launches)."""
    from beholder_tpu_torch.models import seq_train_step

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

    losses, launches, offset_launches = counted_flash(torch, fa, run)
    return state, losses, [s.elapsed_time(e) for s, e in events], launches, offset_launches


def grads_vs_full(torch, name, model_kw, params) -> dict:
    """Step-1 gradients of ``model_kw`` against ``attention="full"`` on the
    same params, one stream of TRAIN_T events, inside GRAD_BAND."""
    from beholder_tpu_torch.models import TelemetrySequenceModel
    from beholder_tpu_torch.models.bridge import load_flax_params

    f1, t1 = train_streams(torch, 1, 1, TRAIN_T)
    grads = []
    for kw in (model_kw, {**model_kw, "attention": "full", "mesh": None}):
        m = TelemetrySequenceModel(**kw)
        load_flax_params(m, params)
        grads.append(step_grads(torch, m.requires_grad_(True), f1, t1))
        del m
    got, full = grads
    rtol, atol = GRAD_BAND
    worst = max(float(((got[n] - full[n]).abs() - rtol * full[n].abs()).max()) for n in full)
    check(worst <= atol, f"{name} grads: vs full excess {worst} over rtol {rtol} > atol {atol}")
    print(f"train {name} grads B=1 T={TRAIN_T}: vs full max excess over {rtol}|full| = "
          f"{worst:.3e} (atol {atol})", flush=True)
    return dict(max_excess=worst, band=GRAD_BAND)


def remat_grads(torch, fa, name, model_kw, params, feats, targets):
    """Step-1 gradients of ``model_kw`` with ``remat=True``, bitwise those
    without. Returns (the remat model, its launches, offset-mode launches)."""
    from beholder_tpu_torch.models import TelemetrySequenceModel
    from beholder_tpu_torch.models.bridge import load_flax_params

    plain = TelemetrySequenceModel(**model_kw)
    remat = TelemetrySequenceModel(**model_kw, remat=True)
    for m in (plain, remat):
        load_flax_params(m, params)
        m.requires_grad_(True)
    g_plain = step_grads(torch, plain, feats, targets)
    g_remat, counts, offset_counts = counted_flash(
        torch, fa, lambda: step_grads(torch, remat, feats, targets))
    check(all(torch.equal(g_plain[n], g_remat[n]) for n in g_plain),
          f"{name}: step-1 gradients differ from no-remat")
    return remat, counts, offset_counts


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
    losses, launches, _ = counted_flash(torch, fa, run)
    seconds = time.perf_counter() - t0
    want = tuple(SIDE_STEPS * n for n in per_step)
    check(bool(np.isfinite(losses).all()), f"{name}: losses not finite {losses}")
    check(launches == want, f"{name}: flash launches {launches}, expected {want}")
    print(f"train {name}: {SIDE_STEPS} steps losses {losses.tolist()} launches(fwd,dq,dkv)="
          f"{launches} step_ms(host, mean)={seconds / SIDE_STEPS * 1e3:.2f}", flush=True)
    return {name: dict(losses=losses.tolist(), launches=launches,
                       step_ms_host_mean=seconds / SIDE_STEPS * 1e3)}


def ring_path(torch, flush, flash_train: dict) -> dict:
    """The ring path on a P = 4 mesh of one card (``Mesh(["cuda:0"] * 4)``:
    every shard on the same device, so no byte moves between devices): the
    ring forward against ``flash_attention`` on the same global inputs at
    the training shape, and both timed; then the training model with
    ``attention="ring"``, ``init_seq_state`` and TRAIN_STEPS steps with
    every flash launch counted (all and offset mode, exactly), losses
    falling, step ms beside the flash step's; step-1 gradients against
    ``attention="full"``; remat (gradients bitwise, launches exact). One
    more step under the profiler gives the ring step's device and busy
    shares."""
    from beholder_tpu_torch.models import TelemetrySequenceModel, init_seq_state, seq_train_step
    from beholder_tpu_torch.models.bridge import init_params
    from beholder_tpu_torch.ops import flash_attention as fa
    from beholder_tpu_torch.ops.attention import ring_attention
    from beholder_tpu_torch.parallel import Mesh

    mesh = Mesh(["cuda:0"] * RING_P)
    ring_model = {**TRAIN_MODEL, "attention": "ring", "mesh": mesh}
    layers = TRAIN_MODEL["layers"]
    report = {}

    # 1. the ring forward against flash_attention, global (B, H, T, Dh) inputs
    B, H, Hkv, T, Dh = (FLASH_SHAPE[k] for k in ("B", "H", "Hkv", "T", "Dh"))
    rng = np.random.default_rng(23)
    q, k, v = (torch.from_numpy(rng.normal(0, 1, (B, h, T, Dh)).astype(np.float32))
               .cuda().bfloat16() for h in (H, Hkv, Hkv))
    o_ring, counts, offset_counts = counted_flash(
        torch, fa, lambda: ring_attention(q, k, v, mesh, causal=True))
    per_layer = (RING_P * RING_P, 0, 0)
    check(counts == per_layer and offset_counts == (RING_P * (RING_P - 1), 0, 0),
          f"ring forward: launches {counts}, offset {offset_counts}")
    o_flash = fa.flash_attention(q, k, v, causal=True)
    reading = row_reading(o_ring, o_flash)
    check(bool(torch.isfinite(o_ring.float()).all()), "ring forward: not finite")
    check(reading <= FLASH_TOL_RMS["o"],
          f"ring forward vs flash_attention: reading {reading} x row RMS > {FLASH_TOL_RMS['o']}")
    ring_ms = time_ms(torch, lambda: ring_attention(q, k, v, mesh, causal=True), flush)
    flash_ms = time_ms(torch, lambda: fa.flash_attention(q, k, v, causal=True), flush)
    print(f"ring forward B={B} H={H} Hkv={Hkv} T={T} Dh={Dh} P={RING_P}: reading vs "
          f"flash_attention {reading:.3e} x row RMS (limit {FLASH_TOL_RMS['o']}) "
          f"launches={counts} offset={offset_counts} ms={ring_ms:.4f} "
          f"flash_attention_ms={flash_ms:.4f}", flush=True)
    report["ring_forward"] = dict(reading_vs_flash=reading, launches=counts,
                                  offset_launches=offset_counts, ms=ring_ms,
                                  flash_attention_ms=flash_ms)
    del q, k, v, o_ring, o_flash

    # 2. the training run: TRAIN_STEPS steps, every launch counted
    feats, targets = train_streams(torch, 0, TRAIN_B, TRAIN_T)
    tokens = TRAIN_B * TRAIN_T
    state = init_seq_state(0, TelemetrySequenceModel(**ring_model))
    state, losses, step_ms, launches, offset_launches = train_steps(torch, fa, state, feats,
                                                                    targets)
    steady_ms = statistics.median(step_ms[1:])
    pairs = layers * RING_P * RING_P          # causal, no window: every rotation
    offset_pairs_ = layers * RING_P * (RING_P - 1)
    check(bool(np.isfinite(losses).all()), f"ring train: losses not finite {losses}")
    check(losses[-1] < 0.7 * losses[0],
          f"ring train: last loss {losses[-1]} not below 0.7 x the first {losses[0]}")
    want = (TRAIN_STEPS * pairs,) * 3
    want_offset = (TRAIN_STEPS * offset_pairs_,) * 3
    check(launches == want and offset_launches == want_offset,
          f"ring train: launches {launches} offset {offset_launches}, expected {want} "
          f"offset {want_offset}")
    print(f"train ring P={RING_P} B={TRAIN_B} T={TRAIN_T} steps={TRAIN_STEPS} loss "
          f"{losses[0]:.4e} -> {losses[-1]:.4e} launches(fwd,dq,dkv)={launches} "
          f"offset={offset_launches} step_ms median(2..)={steady_ms:.2f} first={step_ms[0]:.2f} "
          f"tokens/s={tokens / steady_ms * 1e3:.1f} (flash step_ms "
          f"{flash_train['step_ms_median']:.2f}, tokens/s {flash_train['tokens_per_s']:.1f})",
          flush=True)
    report["ring_train"] = dict(
        P=RING_P, batch=TRAIN_B, T=TRAIN_T, steps=TRAIN_STEPS, losses=losses.tolist(),
        launches=dict(zip(("fwd", "dq", "dkv"), launches)),
        offset_launches=dict(zip(("fwd", "dq", "dkv"), offset_launches)),
        step_ms=step_ms, step_ms_median=steady_ms, tokens_per_s=tokens / steady_ms * 1e3,
        flash_step_ms_median=flash_train["step_ms_median"],
        flash_tokens_per_s=flash_train["tokens_per_s"],
    )
    prof, _ = profile_step(torch, lambda: seq_train_step(state, feats, targets))
    report["ring_train"].update(prof)
    del state

    # 3. step-1 gradients, ring against full attention, B=1
    params = init_params(TelemetrySequenceModel(**TRAIN_MODEL), 2)
    report["ring_grads_vs_full"] = grads_vs_full(torch, "ring", ring_model, params)

    # 4. remat: the ring recomputed in the backward, gradients bitwise
    _, counts, offset_counts = remat_grads(torch, fa, "ring remat", ring_model, params, feats,
                                           targets)
    want, want_offset = (2 * pairs, pairs, pairs), (2 * offset_pairs_, offset_pairs_, offset_pairs_)
    check(counts == want and offset_counts == want_offset,
          f"ring remat: launches {counts} offset {offset_counts} for one step, expected {want} "
          f"offset {want_offset}")
    print(f"train ring remat: gradients bitwise no-remat's, launches {counts} offset "
          f"{offset_counts}", flush=True)
    report["ring_remat"] = dict(bitwise=True, launches=counts, offset_launches=offset_counts)
    return report


def profile_step(torch, step):
    """torch.profiler over one training step: device time by kernel, the
    flash kernels' share of it, and the device's busy share of that
    profiled step's wall time (both numbers from the one step). Returns
    (that record, the step's result)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        result = step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3

    events = device_rows(prof.key_averages())
    device_ms = sum(dev_us(e) for e in events) / 1e3
    flash_ms = sum(dev_us(e) for e in events
                   if any(k in e.key for k in FLASH_KERNEL_NAMES)) / 1e3
    top = sorted(events, key=dev_us, reverse=True)[:8]
    out = dict(profiled_device_ms=device_ms, profiled_flash_ms=flash_ms,
               profiled_step_ms=wall_ms,
               flash_share=flash_ms / device_ms if device_ms else None,
               device_busy_share=device_ms / wall_ms if device_ms else None,
               top_device=[(e.key, e.count, dev_us(e) / 1e3) for e in top])
    print(f"profile train step: device_ms={device_ms:.2f} flash_ms={flash_ms:.2f} "
          f"flash_share={out['flash_share']} busy_share={out['device_busy_share']} "
          f"(of the profiled step's {wall_ms:.2f} ms)", flush=True)
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
    # the kernel's paths: one event; the one-block path's limit and one past
    # it (ops/fused_aggregate.py ONE_BLOCK_MAX = 16,384; one past it is the
    # smallest grid launch); every event in one status
    "one": dict(n=1),
    "threshold": dict(n=16_384),
    "past_threshold": dict(n=16_385),
    "one_status": dict(n=8_388_608, skew=1.0),
}
#: the first design's recorded time (ms) at each AGG_CASES shape it was
#: timed at (PERF.md §6, row 5 and its history), printed beside this run's;
#: the cases added with the redesign have none
AGG_PRIOR_MS = {"flush": 0.0125, "bench": 0.02179, "large": 0.04861, "ragged": 0.04877,
                "skewed": 0.04854, "bench_f32": 0.02192, "unaligned": 0.02608}
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
    (the batch without its last event must fail the check), one call one
    kernel launch and no memset (profiler), and times of the kernel (also
    after a clean L2 flush), the plain version and a four-call PyTorch
    yardstick beside the bound and the timing floor."""
    from beholder_tpu_torch.ops import aggregate_telemetry, aggregate_telemetry_reference
    from beholder_tpu_torch.ops import fused_aggregate

    # what no kernel can go below in time_ms: a kernel that spins one cycle
    floor_ms = time_ms(torch, lambda: torch.cuda._sleep(1), flush)
    print(f"kernel aggregate timing floor: a one-cycle kernel {floor_ms:.5f} ms (time_ms)",
          flush=True)
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
        clean_ms = time_ms(torch, lambda: aggregate_telemetry(st, pr), flush, clean=True)
        read_ref = None
        if name == "large":  # torch's own reduction over the same bytes, as a read rate
            x = torch.zeros(2 * n, device="cuda")
            read_ref = {"ms": time_ms(torch, x.sum, flush),
                        "clean_ms": time_ms(torch, x.sum, flush, clean=True)}
            del x
        # one device operation a call: one kernel row, once a call, no memset.
        # The profiler has dropped kernel records under load (a row read 2
        # launches for 5 calls once, 3 for 5 three times running, and no row
        # at all), so a reading below one a call, none included, is profiled
        # again, up to five times; one above it fails at once.
        for _ in range(5):
            own = profile_device(torch, lambda: aggregate_telemetry(st, pr), flush)
            if own and all(v["per_call"] >= 1 for v in own.values()):
                break
        check(len(own) == 1 and all("aggregate_kernel" in k and v["per_call"] == 1
                                    for k, v in own.items()),
              f"{where}: a call is not exactly one kernel launch: {own}")
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
        prior = AGG_PRIOR_MS.get(name)
        case.update(first_design_ms=prior, clean_l2_ms=clean_ms, timing_floor_ms=floor_ms,
                    torch_sum_same_bytes=read_ref)
        cases.append(case)
        print(
            f"kernel aggregate {name:9s} n={n} progress={case['progress']} "
            f"path={'one block' if n <= fused_aggregate.ONE_BLOCK_MAX else 'grid'} "
            f"vs_plain={diffs} (counts/max/min bitwise, mean rtol {AGG_MEAN_RTOL}) "
            f"vs_f64_oracle={vs_oracle} plain_vs_f64_oracle={plain_vs_oracle} "
            f"repeat_bitwise=yes"
            + ("" if control is None else " negative_control(last event dropped)=fails_check")
            + f" ms={ms:.5f} (first design: "
            + ("none recorded" if prior is None else f"{prior:.5f}")
            + f"; clean L2 {clean_ms:.5f}"
            + ("" if read_ref is None else
               f"; torch.sum of the same bytes {read_ref['ms']:.5f}, clean L2 "
               f"{read_ref['clean_ms']:.5f}")
            + f"; profiler, one call: {own}) plain_ms={plain_ms:.4f} "
            f"library_ms(4 calls)="
            f"{'null' if lib_ms is None else f'{lib_ms:.4f}'} bound_ms={case['bound_ms']:.6f} "
            f"({case['bound_by']}) counts={case['counts']}",
            flush=True,
        )
        del st, pr, got, plain, again
    return cases


def profile_device(torch, fn, flush, calls: int = 5) -> dict:
    """Per profiler row (kernels, memsets, copies) of ``fn``: device
    microseconds and launches per call (``us``, ``per_call``), over
    ``calls`` calls after one warm call, with the L2 cache flushed before
    each (the flush's own row left out)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            flush.zero_()
            fn()
        torch.cuda.synchronize()
    # the aggregation path launches no fill: the fill rows are the flush's
    out = {}
    for e in device_rows(prof.key_averages()):
        if "FillFunctor" not in e.key:  # rows of one name may come split: add them up
            row = out.setdefault(e.key[:60], {"us": 0.0, "per_call": 0.0})
            row["us"] += dev_us(e) / calls
            row["per_call"] += e.count / calls
    return {k: {"us": round(v["us"], 3), "per_call": v["per_call"]} for k, v in out.items()}


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
                        help="also profile one bf16 run_waves and one fused run_spec")
    parser.add_argument("--chunk-parent", type=Path, default=None,
                        help="a checkout whose chunk kernel to time against this one's")
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
    builds = {}
    for name, log in csrc.build_log.items():
        builds[name] = log
        print(f"build {name}: {log['seconds']:.2f} s\n{log['ptxas']}", flush=True)
    builds["resources"] = kernel_resources()

    flush = torch.empty(64 * 2**20 // 4, device="cuda")
    cases = kernel_phase(torch, flush)
    chunk_cases = chunk_kernel_phase(torch, flush)
    flash_cases = flash_kernel_phase(torch, flush)
    offset_cases = offset_kernel_phase(torch, flush)
    d128_cases = forward_d128_phase(torch, flush)
    record = {"card": card, "build": builds, "kernel_cases": cases,
              "chunk_kernel_cases": chunk_cases, "flash_kernel_cases": flash_cases,
              "offset_kernel_cases": offset_cases, "flash_d128_cases": d128_cases}
    serving = main_path(torch, profile=args.profile)
    record["serving"] = serving
    if args.chunk_parent is not None:
        record["chunk_ab"] = chunk_ab(torch, flush, args.chunk_parent)
    record["serving_default_model"] = default_model_path(torch)
    paths = [v for k, v in serving.items() if k != "profile"]
    training = train_path(torch, flash_cases)
    training["anomaly"] = anomaly_path(torch)
    training.update(ring_path(torch, flush, training["train"]))
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
    # the ring block-pair (offset) mode of the same kernels: launches from the
    # ring training run, times at the fully live off-axis pair
    offaxis = next(c for c in offset_cases if c["case"] == "offaxis")
    for key, name, site, source in (
        ("fwd", "flash_block_attend", 438, "flash_fwd.cu"),
        ("dq", "flash_block_backward_dq", 783, "flash_bwd.cu"),
        ("dkv", "flash_block_backward_dkv", 809, "flash_bwd.cu"),
    ):
        outs = {"fwd": ("o", "lse"), "dq": ("dq",), "dkv": ("dk", "dv")}[key]
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": f"beholder_tpu_torch/csrc/{source}",
            "replaces": f"beholder_tpu/ops/flash_attention.py:{site}",
            "launches": training["ring_train"]["offset_launches"][key],
            "max_abs_err": max(c["max_abs_err"][o] for c in offset_cases for o in outs),
            "ms": offaxis[key]["ms"],
            "plain_ms": offaxis[key]["plain_ms"],
            "bound_ms": offaxis[key]["bound_ms"],
            "bound_by": offaxis[key]["bound_by"],
            "library_ms": offaxis[key]["library_ms"],
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
