#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``beholder_tpu_torch``) on one H100.

Run from the root of a checkout: ``python3 chip_smoke.py``. It needs one
CUDA card, ``nvcc`` (it builds the port's kernels from ``csrc/`` at first
use) and nothing of JAX. Phases, in order; any failure exits non-zero:

1. device: the card's name and power limit (``nvidia-smi``);
2. build: every kernel of the serving path, one ``nvcc`` per source;
3. kernels: each kernel's wrapper against its plain PyTorch version on the
   card, at the serving path's shapes, with the tolerance stated; times
   (CUDA events, median) of the kernel, the plain version and one PyTorch
   library call computing the same function, beside the bound;
4. main path: ``TelemetrySequenceModel(dim=512, heads=8, kv_heads=2,
   layers=4)`` with random bf16 weights from a numpy seed, served through
   ``ContinuousBatcher.run_waves`` and ``ContinuousBatcher.run`` over bf16,
   int8 and fp8 pools; launch counts, pages home, forecasts against the
   dense ``forecast_deltas`` oracle, tokens/s, synchronising calls;
5. output: a ``kernels`` JSON line, then the ``ok`` line last.

``--profile`` adds a
``torch.profiler`` breakdown of one bf16 ``run_waves``. The full record goes
to ``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import argparse
import json
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
CONVERTING = 2  # TelemetryStatusEntry.CONVERTING
SPIN_CYCLES = 2_000_000  # ~1 ms at the H100's boost clock
TIMED_RUNS = 3
#: kernel vs plain version: both round the output to bf16, sum in f32 in
#: different orders, and group the online softmax by 128-token tiles (the
#: kernel) vs whole pages (the plain version); on bf16 pools a last-bit
#: score difference can also flip the score's bf16 rounding. Outputs are
#: O(0.1-1), where a bf16 ULP is <= 2**-8.
KERNEL_TOL = 1e-2
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


def main_path(torch, profile: bool = False) -> dict:
    from beholder_tpu_torch.models import TelemetrySequenceModel, forecast_deltas
    from beholder_tpu_torch.models.bridge import init_params, load_flax_params
    from beholder_tpu_torch.models.serving import ContinuousBatcher, Request
    from beholder_tpu_torch.ops.paged_attention import paged_decode_attention

    layers = 4
    model = TelemetrySequenceModel(dim=512, heads=8, kv_heads=2, layers=layers)
    load_flax_params(model, init_params(model, seed=0, bf16_matrices=True))
    rng = np.random.default_rng(0)
    wave_reqs = make_requests(rng, Request, [256] * 8, [128] * 8)
    run_horizons = [128, 96, 64, 32, 128, 80, 48, 16, 128, 100, 60, 20]
    run_reqs = make_requests(rng, Request, [256] * 12, run_horizons)

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
    # what the sync counter reports around nothing (torch's own first use)
    _, baseline = count_syncs(torch, lambda: None)
    print(f"sync_calls around an empty call: {baseline}", flush=True)
    report = {}
    for family in ("bf16", "int8", "fp8"):
        rtol, atol = FORECAST_BAND[family]
        for mode, reqs, want in (("run_waves", wave_reqs, want_wave),
                                 ("run", run_reqs, want_run)):
            b = ContinuousBatcher(
                model, num_pages=32, page_size=128, slots=8, max_prefix=256,
                max_pages_per_seq=4, cache_dtype=family,
            )

            def serve():
                if mode == "run_waves":
                    return b.run_waves(reqs, device_results=True)
                return b.run(reqs)

            # a warm-up run takes the process's one-time set-up (cuBLAS
            # handles, pinned-memory pools) out of the counted run
            serve()
            # counted run: launches and synchronising calls of this path only
            torch.cuda.synchronize()
            paged_decode_attention.launches = 0
            ticks0 = b.ticks
            results, syncs = count_syncs(torch, serve)
            launches = paged_decode_attention.launches
            torch.cuda.synchronize()
            ticks = b.ticks - ticks0
            check(launches > 0, f"{family}/{mode}: the paged kernel never launched")
            check(launches == layers * ticks,
                  f"{family}/{mode}: {launches} kernel launches for "
                  f"{ticks} ticks x {layers} layers")
            check(int(b.state.free_top) == b.num_pages,
                  f"{family}/{mode}: free_top {int(b.state.free_top)} != {b.num_pages}")
            check(not bool(b.state.alloc_failed), f"{family}/{mode}: alloc_failed")
            check(not bool(b.state.active.any()), f"{family}/{mode}: slots left active")
            worst = 0.0
            for i, (req, w) in enumerate(zip(reqs, want)):
                got = results[i]
                got = got.cpu().numpy() if torch.is_tensor(got) else got
                check(got.shape == (req.horizon,),
                      f"{family}/{mode}: request {i} shape {got.shape}")
                check(bool(np.isfinite(got).all()), f"{family}/{mode}: request {i} not finite")
                ok = np.abs(got[:2] - w) <= atol + rtol * np.abs(w)
                check(bool(ok.all()),
                      f"{family}/{mode}: request {i} first steps {got[:2]} vs oracle {w}")
                worst = max(worst, float(np.abs(got[:2] - w).max()))
            # timed runs (warm): the median of three, and their range, since
            # the host-bound tick moves with the host's load
            runs = []
            for _ in range(TIMED_RUNS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                serve()
                torch.cuda.synchronize()
                runs.append(time.perf_counter() - t0)
            seconds = statistics.median(runs)
            tokens = sum(r.horizon for r in reqs)
            report[f"{family}/{mode}"] = dict(
                launches=launches, ticks=ticks, syncs=syncs, seconds=seconds,
                tokens=tokens, tokens_per_s=tokens / seconds,
                tokens_per_s_range=(tokens / max(runs), tokens / min(runs)),
                first_steps_max_err=worst, band=(rtol, atol),
            )
            print(
                f"serve {family:4s} {mode:9s} requests={len(reqs)} tokens={tokens} "
                f"seconds={seconds:.4f} tokens/s={tokens / seconds:.1f} "
                f"(range {tokens / max(runs):.1f}-{tokens / min(runs):.1f} "
                f"over {TIMED_RUNS} runs) ticks={ticks} "
                f"kernel_launches={launches} sync_calls={syncs} "
                f"first2_max_err={worst:.3e} (band rtol {rtol}, atol {atol}) pages_home=yes",
                flush=True,
            )
        if profile and family == "bf16":
            b = ContinuousBatcher(
                model, num_pages=32, page_size=128, slots=8, max_prefix=256,
                max_pages_per_seq=4,
            )
            report["profile"] = profile_waves(
                torch, b, wave_reqs, report["bf16/run_waves"]["seconds"]
            )
    return report


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

    def dev_us(e):
        return getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0))

    events = prof.key_averages()
    device_ms = sum(dev_us(e) for e in events) / 1e3
    kernels = sorted(events, key=dev_us, reverse=True)[:8]
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
    csrc.build("paged_decode")
    print(f"build: {time.perf_counter() - t0:.2f} s", flush=True)
    for name, log in csrc.build_log.items():
        print(f"build {name}: {log['seconds']:.2f} s\n{log['ptxas']}", flush=True)

    flush = torch.empty(64 * 2**20 // 4, device="cuda")
    cases = kernel_phase(torch, flush)
    record = {"card": card, "kernel_cases": cases}
    serving = main_path(torch, profile=args.profile)
    record["serving"] = serving

    head = next(c for c in cases
                if c["shape"] == "headline" and c["pool"] == "bf16" and c["window"] is None)
    kernels = [{
        "name": "paged_decode_attention",
        "route": "cuda",
        "source": "beholder_tpu_torch/csrc/paged_decode.cu",
        "replaces": "beholder_tpu/ops/paged_attention.py:154",
        "launches": sum(v["launches"] for k, v in serving.items() if k != "profile"),
        "max_abs_err": max(c["max_abs_err"] for c in cases),
        "ms": head["ms"],
        "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"],
        "bound_by": head["bound_by"],
        "library_ms": head["library_ms"],
    }]
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
