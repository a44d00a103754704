"""Runtime roofline attribution: ceilings measured on this device, now.

The port's own copy of the reference's ``obs/roofline.py``. A
:class:`RooflineAttributor` measures the device's f32 matmul and
elementwise ceilings with the slope method (k chained calls timed end to
end, the slope between two k's, so the fixed cost cancels), then
tags each recorded serving dispatch with its achieved fraction of the
matmul ceiling. It reads no hardware counter and adds no device read to
serving: a dispatch's time is the host wall the flight recorder already
captured.

:func:`attribution_summary` folds one flight-recorder event stream into
``{"phase_ms_pcts", "kernel_ceiling_fracs", "stall_pct"}``: each phase's
share of the recorded wall, each kernel family's achieved fraction of the
ceiling with the readback wait apportioned by FLOPs, and the share of the
wall spent waiting on the device (``readback`` rounds plus the spec loop's
nested ``device_wait`` slices).

Where the port differs: the ceilings are measured with torch on the
attributor's ``device`` (the CUDA card by default, the CPU only when the
caller names it). On the card a slope run goes on a stream of the
attributor's own, between two CUDA events, and the measuring thread waits
on its end event only: no device-wide ``synchronize`` and no work on the
stream serving uses, so a background re-measure neither blocks nor
reorders serving (it does share the card's SMs while it runs, about 25 ms
at the card's sizes). The chain is sized per device: the reference's 256³
matmul and 4 MB pass on the CPU, a 2048³ matmul and a 64 MB pass on the
card, where the small ones finish before the next launch arrives and would
time the launch, not the math. ``ceiling_frac`` stays what the reference
makes it: a dispatch's FLOPs over its host wall (dispatch time on the
card, which runs ahead of the device), over this ceiling.
"""

from __future__ import annotations

import threading
import time
from typing import Any

import torch

from beholder_tpu_torch.device import resolve_device

#: the dispatch phase -> kernel family map, as documentation: the serving
#: layer passes the family to ``kernel_tags()`` at the call site. ``verify``
#: rounds carry "verify" on the dense-gather path and
#: "paged_chunk:<family>" with the fused verify, where ``<family>`` is the
#: pool's dtype family (bf16/int8/fp8)
PHASE_FAMILIES = {
    "admit": "flash",    # prefill
    "wave": "paged",     # admit + decode ticks, decode-dominated
    "tick": "paged",     # paged decode ticks
    "verify": "verify",  # spec verify ("paged_chunk:<dtype>" fused)
}


def model_flops_per_token(model, ctx: float) -> float:
    """Estimated forward FLOPs for one token of a
    :class:`~beholder_tpu_torch.models.sequence.TelemetrySequenceModel` at
    context length ``ctx``: per layer the q/o projections, the k/v
    projections (GQA-shrunk), the 4x MLP and the two attention products
    over the context. An estimate for attribution: ratios are insensitive
    to the constant."""
    d = float(model.dim)
    heads = model.heads
    kv = getattr(model, "kv_heads", None) or heads
    proj = 2.0 * d * d * (2.0 + 2.0 * kv / heads)   # q, o + GQA k, v
    mlp = 16.0 * d * d                              # up (4x) + down
    attn = 4.0 * d * max(float(ctx), 1.0)           # scores + p·v
    return model.layers * (proj + mlp + attn)


#: the chain's default sizes per device type: (matmul_n, copy_mb)
DEFAULT_SIZES = {"cpu": (256, 4.0), "cuda": (2048, 64.0)}


def _slope_seconds(fn, device: torch.device, k1: int, k2: int, rounds: int) -> float:
    """Marginal per-call seconds of ``fn(prev) -> next``: k chained calls,
    the min of each endpoint separately. On the CPU the host clock times
    them; on the card, two events on the caller's current stream, waiting
    on the end event only."""

    def run(k: int) -> float:
        if device.type == "cuda":
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            out = None
            for _ in range(k):
                out = fn(out)
            end.record()
            end.synchronize()
            return start.elapsed_time(end) / 1e3
        start_s = time.perf_counter()
        out = None
        for _ in range(k):
            out = fn(out)
        return time.perf_counter() - start_s

    run(2)  # warm
    t1s, t2s = [], []
    for _ in range(rounds):
        t1s.append(run(k1))
        t2s.append(run(k2))
    return max((min(t2s) - min(t1s)) / (k2 - k1), 1e-12)


class RooflineAttributor:
    """Measures the device's matmul and elementwise ceilings (slope-timed,
    stale after ``interval_s``) and turns (family, flops, wall) dispatch
    observations into achieved-fraction-of-ceiling tags. The measurement
    is small (an ``matmul_n``³ f32 matmul chain, a ``copy_mb`` elementwise
    pass; None takes :data:`DEFAULT_SIZES` for the device) so a re-measure
    costs milliseconds.

    ``device`` is where the ceilings are measured: None means the CUDA card
    (raising when there is none); the CPU only when the caller names it."""

    def __init__(
        self,
        interval_s: float = 300.0,
        matmul_n: int | None = None,
        copy_mb: float | None = None,
        device=None,
    ):
        self.interval_s = float(interval_s)
        self.device = resolve_device(device)
        default_n, default_mb = DEFAULT_SIZES[self.device.type]
        self.matmul_n = int(default_n if matmul_n is None else matmul_n)
        self.copy_mb = float(default_mb if copy_mb is None else copy_mb)
        self._ceilings: dict[str, Any] | None = None
        self._measuring = threading.Lock()
        #: per family: [flops, dispatch_wall_s, events]
        self._families: dict[str, list[float]] = {}

    # -- ceilings --------------------------------------------------------

    def _stale(self) -> bool:
        return (
            self._ceilings is None
            or time.time() - self._ceilings["measured_unix_s"] > self.interval_s
        )

    def ceilings(self) -> dict[str, Any]:
        """The current ceilings, re-measured synchronously when older than
        ``interval_s`` (and lazily on first use). Offline callers use this;
        the serving path goes through :meth:`ceilings_nowait`."""
        if self._stale():
            with self._measuring:
                if self._stale():
                    self._ceilings = self._measure()
        return self._ceilings

    def ceilings_nowait(self) -> dict[str, Any] | None:
        """The cached ceilings, never measured inline: when stale, a
        background thread re-measures (one at a time) and the caller keeps
        the previous ceilings, or None before the first measurement."""
        if self._stale() and self._measuring.acquire(blocking=False):

            def measure_and_release():
                try:
                    self._ceilings = self._measure()
                finally:
                    self._measuring.release()

            threading.Thread(
                target=measure_and_release, name="roofline-ceilings", daemon=True
            ).start()
        return self._ceilings

    def _measure(self) -> dict[str, Any]:
        if self.device.type == "cuda":
            # a stream of its own: serving's stream gets no work and no wait
            with torch.cuda.device(self.device), torch.cuda.stream(
                torch.cuda.Stream(self.device)
            ):
                return self._measure_here()
        return self._measure_here()

    def _measure_here(self) -> dict[str, Any]:
        n, dev = self.matmul_n, self.device
        with torch.no_grad():
            # ones/n is a fixed point of A @ A, so the chain neither
            # overflows nor underflows
            a = torch.full((n, n), 1.0 / n, dtype=torch.float32, device=dev)
            per_mm = _slope_seconds(lambda prev: (a if prev is None else prev) @ a,
                                    dev, 4, 16, 3)
            buf = torch.ones(max(1, int(self.copy_mb * 1e6 / 4)), dtype=torch.float32,
                             device=dev)
            per_copy = _slope_seconds(lambda prev: (buf if prev is None else prev) + 1.0,
                                      dev, 4, 16, 3)
        nbytes = buf.numel() * buf.element_size()
        return {
            "matmul_flops_per_s": 2.0 * n**3 / per_mm,
            "memcpy_bytes_per_s": 2.0 * nbytes / per_copy,
            "matmul_n": n,
            "copy_bytes": int(nbytes),
            "device": str(dev),
            "measured_unix_s": time.time(),
        }

    # -- observation -----------------------------------------------------

    def observe(self, family: str, flops: float, dur_s: float) -> float:
        """Record one dispatch and return its achieved fraction of the
        measured matmul ceiling over its own wall. Never measures inline:
        before the first measurement lands it returns 0.0."""
        acc = self._families.setdefault(family, [0.0, 0.0, 0])
        acc[0] += float(flops)
        acc[1] += float(dur_s)
        acc[2] += 1
        ceilings = self.ceilings_nowait()
        if ceilings is None:
            return 0.0
        ceiling = ceilings["matmul_flops_per_s"]
        if dur_s <= 0 or ceiling <= 0:
            return 0.0
        return round(float(flops) / dur_s / ceiling, 6)

    def family_stats(self) -> dict[str, dict[str, float]]:
        return {
            family: {"flops": acc[0], "dispatch_wall_s": acc[1], "events": acc[2]}
            for family, acc in sorted(self._families.items())
        }


def attribution_summary(
    events: list[dict[str, Any]], ceilings: dict[str, Any] | None = None
) -> dict[str, Any]:
    """Fold a flight-recorder event stream into ``{"phase_ms_pcts",
    "kernel_ceiling_fracs", "stall_pct"}``. With ``ceilings`` (a
    :meth:`RooflineAttributor.ceilings` dict) each family's fraction charges
    its dispatch wall plus a FLOPs-prorated share of the readback wall;
    without, it is the duration-weighted mean of the ``ceiling_frac``
    stamped at record time. Nested ``device_wait`` slices are left out of
    the phase shares (they would count their parent twice) but count as
    stall."""
    all_slices = [e for e in events if e.get("ph") == "X"]
    nested = [e for e in all_slices if e["name"] == "device_wait"]
    slices = [e for e in all_slices if e["name"] != "device_wait"]
    total_us = sum(int(e.get("dur_us", 0)) for e in slices)
    phase_us: dict[str, int] = {}
    for e in slices:
        phase_us[e["name"]] = phase_us.get(e["name"], 0) + int(e.get("dur_us", 0))
    phase_ms_pcts = {
        name: round(100.0 * us / total_us, 2) if total_us else 0.0
        for name, us in sorted(phase_us.items())
    }
    readback_us = phase_us.get("readback", 0)
    device_wait_us = sum(int(e.get("dur_us", 0)) for e in nested)
    stall_pct = (
        round(100.0 * (readback_us + device_wait_us) / total_us, 2) if total_us else 0.0
    )

    fam_flops: dict[str, float] = {}
    fam_us: dict[str, float] = {}
    fam_frac_w: dict[str, float] = {}
    for e in slices:
        args = e.get("args", {})
        if not (args.get("family") and args.get("flops")):
            continue
        fam = args["family"]
        fam_flops[fam] = fam_flops.get(fam, 0.0) + float(args["flops"])
        fam_us[fam] = fam_us.get(fam, 0.0) + float(e.get("dur_us", 0))
        fam_frac_w[fam] = fam_frac_w.get(fam, 0.0) + float(
            args.get("ceiling_frac", 0.0)
        ) * float(e.get("dur_us", 0))
    total_tagged_flops = sum(fam_flops.values())

    kernel_ceiling_fracs: dict[str, float] = {}
    for fam in sorted(fam_flops):
        if ceilings is not None and ceilings.get("matmul_flops_per_s"):
            share = (
                readback_us * fam_flops[fam] / total_tagged_flops
                if total_tagged_flops else 0.0
            )
            device_s = (fam_us[fam] + share) / 1e6
            frac = (
                fam_flops[fam] / device_s / ceilings["matmul_flops_per_s"]
                if device_s > 0 else 0.0
            )
        else:
            frac = fam_frac_w[fam] / fam_us[fam] if fam_us[fam] else 0.0
        kernel_ceiling_fracs[fam] = round(frac, 4)

    return {
        "phase_ms_pcts": phase_ms_pcts,
        "kernel_ceiling_fracs": kernel_ceiling_fracs,
        "stall_pct": stall_pct,
    }
