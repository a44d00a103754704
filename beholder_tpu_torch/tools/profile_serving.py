"""Step-level serving profile: the port's counterpart of the reference's
``tools/profile_serving.py``.

Attributes paged-serving wall time on the card with the reference's two
methods:

- SLOPE timing: run k chained calls then ONE scalar readback; the per-call
  cost is the slope between k=2 and k=10, which cancels both the readback
  constant and the launch latency (:func:`_slope`);
- latency probes: one-off costs of an eager op, of enqueueing one small
  kernel, of an 8 KB host-to-device copy and of a scalar readback
  (:func:`probe_latencies`).

"Program" in the result's keys keeps the reference's names; in the port a
program is the eager call (``serve_wave``, ``paged_wave``,
``forecast_deltas``), since nothing captures it into one graph yet.

Run on the card: ``python -m beholder_tpu_torch.tools.profile_serving``. It
writes the artifact ``profile_serving.json`` (sections ``latency_probes``
and ``serving_profile``, the four ``profile.*`` raw timings) under
``$BENCH_ARTIFACT_DIR`` or :data:`beholder_tpu_torch.artifact.DEFAULT_DIR`,
even when the run fails.
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from beholder_tpu_torch import artifact
from beholder_tpu_torch.device import resolve_device, to_device
from beholder_tpu_torch.models.sequence import FEATURES
from beholder_tpu_torch.ops import NUM_STATUSES, STATUS_NAMES

CONVERTING = STATUS_NAMES.index("CONVERTING")

#: the reference's profile: the headline serving model and shapes
#: (``beholder_tpu/tools/profile_serving.py:82-100``)
DEFAULTS = dict(dim=512, heads=8, kv_heads=2, layers=4, t=256, horizon=128, slots=8,
                num_pages=32, page_size=128, max_pages_per_seq=4)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _slope(fn, n1: int = 2, n2: int = 10, label: str | None = None) -> float:
    """Marginal per-call seconds of ``fn(k)`` (k chained calls + one
    readback): (T(n2) - T(n1)) / (n2 - n1), best of two rounds each.
    With ``label``, all four raw round times land in the artifact."""
    fn(2)  # warm
    t1s = [fn(n1) for _ in range(2)]
    t2s = [fn(n2) for _ in range(2)]
    if label is not None:
        artifact.record_raw(label, "slope_timeit", t1s + t2s, k1=n1, k2=n2)
    return (min(t2s) - min(t1s)) / (n2 - n1)


def probe_latencies(device=None) -> dict[str, float]:
    """Best of 10 of each one-off cost, in ms: ``eager_op_ms`` (a small op
    and a synchronise), ``launch_ms`` (the host time to enqueue one small
    kernel, no synchronise; the reference's ``jit_dispatch_ms``),
    ``h2d_8kb_ms`` (an 8 KB copy up, synchronised) and ``d2h_readback_ms``
    (an op and one scalar read back)."""
    dev = resolve_device(device)
    x = torch.zeros((1024,), device=dev)
    _sync(dev)

    def best(fn, n=10):
        out = float("inf")
        for _ in range(n):
            t0 = time.perf_counter()
            fn()
            out = min(out, time.perf_counter() - t0)
        return out

    def eager():
        torch.zeros((8,), device=dev) + 1
        _sync(dev)

    def h2d():
        torch.from_numpy(np.zeros(1024)).to(dev)
        _sync(dev)

    out = {"launch_ms": best(lambda: x + 1) * 1e3}
    _sync(dev)
    out["eager_op_ms"] = best(eager) * 1e3
    out["h2d_8kb_ms"] = best(h2d) * 1e3
    out["d2h_readback_ms"] = best(lambda: float((x + 1)[0])) * 1e3
    return out


def profile_serving(*, device=None, n2: int = 10, **sizes) -> dict[str, float]:
    """Slope-timed ms of ``serve_wave`` (admit + horizon-1 ticks +
    release), ``paged_wave`` alone (the admitted state held fixed; also
    ``us_per_tick``), the batcher's ``run_waves`` host path and the dense
    ``forecast_deltas`` rollout, on the reference's headline model and
    shapes (:data:`DEFAULTS`; ``sizes`` overrides any of them). Weights are
    random from seed 0, every matrix in bf16; the times do not
    depend on the values. Every call runs under ``torch.no_grad()``."""
    from beholder_tpu_torch.models import TelemetrySequenceModel, forecast_deltas
    from beholder_tpu_torch.models.bridge import init_params, load_flax_params
    from beholder_tpu_torch.models.serving import (
        ContinuousBatcher,
        Request,
        init_paged,
        paged_admit_batch,
        paged_wave,
        serve_wave,
    )

    unknown = set(sizes) - set(DEFAULTS)
    if unknown:
        raise TypeError(f"profile_serving: unknown sizes {sorted(unknown)}")
    cfg = {**DEFAULTS, **sizes}
    dev = resolve_device(device)
    t, horizon, slots = cfg["t"], cfg["horizon"], cfg["slots"]
    pool = dict(num_pages=cfg["num_pages"], page_size=cfg["page_size"], slots=slots,
                max_pages_per_seq=cfg["max_pages_per_seq"])
    model = TelemetrySequenceModel(dim=cfg["dim"], heads=cfg["heads"],
                                   kv_heads=cfg["kv_heads"], layers=cfg["layers"], device=dev)
    load_flax_params(model, init_params(model, seed=0, bf16_matrices=True))
    rng = np.random.default_rng(0)
    out: dict[str, float] = {}

    with torch.no_grad():
        # serve_wave (admit + horizon-1 ticks + release), each chain from
        # the empty pool; a wave releases every page it took
        pstate0 = init_paged(model, **pool)
        feats = to_device(rng.normal(size=(slots, t, FEATURES)).astype(np.float32), dev)
        lens = torch.full((slots,), t, dtype=torch.int32, device=dev)
        stats = torch.full((slots,), CONVERTING, dtype=torch.int32, device=dev)

        def run_serve(k):
            s = pstate0
            t0 = time.perf_counter()
            d = None
            for _ in range(k):
                d, s = serve_wave(model, s, feats, lens, stats, horizon - 1)
            float(d[0, 0])
            return time.perf_counter() - t0

        out["serve_wave_program_ms"] = _slope(
            run_serve, n2=n2, label="profile.serve_wave") * 1e3

        # the wave alone, from one admitted state: the ticks' allocator
        # vectors are new tensors, and their kv columns land past the
        # prefix, so every call sees the same state
        pred0, pstate1 = paged_admit_batch(
            model, pstate0, torch.arange(slots, dtype=torch.int32, device=dev), feats, lens)
        pred0 = pred0.float()
        oh = torch.zeros((slots, NUM_STATUSES), device=dev)

        def run_wave(k):
            t0 = time.perf_counter()
            d = None
            for _ in range(k):
                d, _ = paged_wave(model, pstate1, pred0, oh, horizon - 1)
            float(d[0, 0])
            return time.perf_counter() - t0

        out["wave_scan_program_ms"] = _slope(
            run_wave, n2=n2, label="profile.wave_scan") * 1e3
        out["us_per_tick"] = out["wave_scan_program_ms"] / (horizon - 1) * 1e3

        # the full host path (what the reference's bench_serving times)
        reqs = [
            Request(np.cumsum(1.0 + rng.normal(0, 0.05, t + 1)), np.full(t + 1, CONVERTING),
                    horizon)
            for _ in range(slots)
        ]
        b = ContinuousBatcher(model, **pool, max_prefix=t, device=dev)
        b.run_waves(reqs)

        def run_rw(k):
            t0 = time.perf_counter()
            o = None
            for _ in range(k):
                o = b.run_waves(reqs, device_results=True)
            float(o[-1][0])
            return time.perf_counter() - t0

        out["run_waves_host_path_ms"] = _slope(
            run_rw, n2=n2, label="profile.run_waves_host") * 1e3

        # the dense rollout it is compared against
        prog = to_device(
            np.cumsum(1.0 + rng.normal(0, 0.05, (slots, t + 1)), axis=-1).astype(np.float32), dev)
        sts = torch.full((slots, t + 1), CONVERTING, dtype=torch.int32, device=dev)

        def run_roll(k):
            t0 = time.perf_counter()
            d = None
            for _ in range(k):
                d = forecast_deltas(model, prog, sts, horizon)
            float(d[0, 0])
            return time.perf_counter() - t0

        out["dense_rollout_program_ms"] = _slope(
            run_roll, n2=n2, label="profile.dense_rollout") * 1e3
    return out


def main(device=None, **profile_kw) -> str:
    """Probe the latencies, profile serving and write the
    ``profile_serving`` artifact; returns its path. The artifact is
    written even on error (``outcome: "error"``), and the error re-raised.
    ``profile_kw`` goes to :func:`profile_serving` (sizes, ``n2``)."""
    # same contract as the reference's bench: every profiling run leaves a
    # schema-versioned raw artifact behind, even on error
    rec = artifact.ArtifactRecorder("profile_serving")
    artifact.set_current(rec)
    try:
        probes = rec.section("latency_probes", probe_latencies(device))
        print("latency probes:", {k: round(v, 3) for k, v in probes.items()})
        profile = rec.section("serving_profile", profile_serving(device=device, **profile_kw))
        for k, v in profile.items():
            print(f"{k}: {v:.2f}")
    except BaseException as err:
        rec.error = repr(err)
        raise
    finally:
        artifact.set_current(None)
        path = rec.write()
        print(f"profile artifact: {path}", file=sys.stderr)
    return path


if __name__ == "__main__":
    main()
