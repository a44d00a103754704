"""Per-status telemetry aggregation in one CUDA launch: the wrapper of
``csrc/aggregate.cu``, its plan and its launch count.

Counterpart of the reference's ``ops/pallas_aggregate.py``. The kernel
replaces the TPU kernel ``beholder_tpu/ops/pallas_aggregate.py::_kernel``
(launched by ``_run``, public as ``aggregate_telemetry_pallas``): for a
``(B,)`` batch of statuses and progress values it computes the whole of
``aggregate_telemetry`` — per-status count, mean, max and min of progress,
0 for absent statuses, nothing from statuses outside ``[0, S)``.

What bounds it on the H100: bytes. It reads each event once, 4 bytes of
status and 4 of progress (int32 or f32), and writes 4 × S values. At
8,388,608 events that is 67.1 MB, 20.0 µs at 3.35 TB/s; at the sink's
4,096-event flushes the fixed chain from launch to the last store is the
cost.

What the design does about it (the kernel's header says more):

- one device operation a call: the ticket and the per-block partials live
  in a buffer per (device, stream), zeroed once when made, and each launch
  leaves it zero, so no memset precedes a launch; the SM count is cached
  per device and nothing is allocated per call but the ``(4, S)`` output;
- :func:`aggregate_plan` picks the path from ``n`` alone: up to
  :data:`ONE_BLOCK_MAX` events one block reads the batch and writes the
  outputs (no ticket, no partials); above it a persistent grid of up to
  :data:`BLOCKS_PER_SM` blocks an SM walks the batch in rounds of
  :data:`ROUND_EVENTS`, keeping the next round's loads in flight during
  this round's math, and the last block combines the partials in a fixed
  order with f64 sums;
- each thread keeps one (count, sum, max, min) record per status in
  shared memory, a handful of instructions an event, and no atomics but
  the one ticket a block: the result is the same bit for bit from run to
  run, and skewed streams serialise nothing;
- it reads the batch in place: 16-byte loads where both pointers share
  their offset within 16 bytes (:func:`vector_span`), one event at a time
  over the unaligned head, the ragged tail or a batch with no common
  offset; int32 progress is converted inside the kernel.

Counts are int32 (the Pallas kernel counts in f32, exact only to 2**24
events per lane).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from . import NUM_STATUSES

#: threads a block, and 16-byte loads of each input a thread issues a round
THREADS, UNROLL = 512, 2
#: events one round of a block reads: 4 events a 16-byte load
ROUND_EVENTS = 4 * UNROLL * THREADS
#: the persistent grid: at most this many blocks an SM (the kernel's
#: ``__launch_bounds__``; 48 KB of records a block), and at most MAX_GRID
#: blocks (the last block stages every partial in its 48 KB)
BLOCKS_PER_SM, MAX_GRID = 2, 409
#: the one-block path's limit: four rounds. One block pays a DRAM latency
#: for about every round past the first two it keeps in flight; the grid
#: reads any small batch in one round but pays a fixed chain (a fence, the
#: ticket, the last block's pass over the partials in L2). On the H100 one
#: block still reads 16,384 events faster than the grid reads one more
#: (chip_smoke.py's threshold cases; PERF.md).
ONE_BLOCK_MAX = 4 * ROUND_EVENTS
#: scratch words: the ticket and its padding, then per block and status an
#: f64 sum and the count, max and min
_SCRATCH_HEAD, _PARTIAL_WORDS = 4, 5 * NUM_STATUSES

_lib: ctypes.CDLL | None = None
_sm_counts: dict[int, int] = {}
#: per (device, stream): the kernel's scratch (the ticket, then the
#: partials of up to BLOCKS_PER_SM blocks an SM); zeroed once when made or
#: grown, left with a zero ticket by every launch. Two threads that make one
#: at once each launch on a zeroed buffer of their own, so the race is
#: harmless.
_scratch: dict[tuple[int, int], torch.Tensor] = {}


class AggregatePlan(NamedTuple):
    one_block: bool
    grid: int


def aggregate_plan(n: int, sms: int) -> AggregatePlan:
    """The kernel's path and grid for ``n`` events on a card of ``sms``
    SMs: one block up to :data:`ONE_BLOCK_MAX` events; above it a block per
    round of :data:`ROUND_EVENTS`, at least 2 and at most
    :data:`BLOCKS_PER_SM` an SM (the scratch holds that many) and
    :data:`MAX_GRID`."""
    if n <= ONE_BLOCK_MAX:
        return AggregatePlan(True, 1)
    most = min(BLOCKS_PER_SM * sms, MAX_GRID)
    return AggregatePlan(False, max(2, min(most, -(-n // ROUND_EVENTS))))


def vector_span(n: int, status_offset: int, progress_offset: int) -> tuple[int, int]:
    """``(head, nvec)``: the kernel reads events ``[head, head + 4 nvec)``
    as ``nvec`` 16-byte loads of each input and the rest one at a time.
    The offsets are each pointer's position within 16 bytes, in 4-byte
    elements (0-3); pointers at different offsets share no 16-byte
    boundary, so every event goes one at a time."""
    if status_offset != progress_offset:
        return n, 0
    head = min((4 - status_offset) % 4, n)
    return head, (n - head) // 4


def _kernel_lib() -> ctypes.CDLL:
    """``csrc/aggregate.cu``, built at first use."""
    global _lib
    if _lib is None:
        from beholder_tpu_torch import csrc

        lib = csrc.load("aggregate")
        lib.aggregate_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
            ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p,
        ]
        lib.aggregate_launch.restype = ctypes.c_int
        lib.aggregate_resources.argtypes = [ctypes.c_int, ctypes.c_void_p]
        lib.aggregate_resources.restype = ctypes.c_int
        _lib = lib
    return _lib


def _sm_count(dev: torch.device) -> int:
    sms = _sm_counts.get(dev.index)
    if sms is None:
        sms = _sm_counts[dev.index] = torch.cuda.get_device_properties(dev).multi_processor_count
    return sms


def _scratch_for(dev: torch.device, stream: int, words: int) -> torch.Tensor:
    key = (dev.index, stream)
    buf = _scratch.get(key)
    if buf is None or buf.numel() < words:
        buf = torch.zeros(words, dtype=torch.int32, device=dev)
        _scratch[key] = buf
    return buf


def check_batch(statuses: torch.Tensor, progress: torch.Tensor) -> None:
    """A batch is ``(B,)`` statuses and ``(B,)`` progress on one device."""
    if statuses.ndim != 1 or progress.shape != statuses.shape:
        raise ValueError(
            f"statuses and progress must be (B,) of one length, "
            f"got {tuple(statuses.shape)} and {tuple(progress.shape)}"
        )
    if statuses.device != progress.device:
        raise ValueError(
            f"statuses and progress on different devices: {statuses.device}, {progress.device}"
        )


def kernel_inputs(statuses: torch.Tensor, progress: torch.Tensor):
    """What the kernel takes from a batch: int32 statuses and int32 or f32
    progress, contiguous. Other integer statuses are cast to int32 and
    other progress types to f32; floating statuses and non-contiguous
    tensors raise."""
    check_batch(statuses, progress)
    if statuses.is_floating_point() or statuses.is_complex():
        raise TypeError(f"the aggregation kernel takes integer statuses, got {statuses.dtype}")
    if statuses.dtype != torch.int32:
        statuses = statuses.to(torch.int32)
    if progress.dtype not in (torch.int32, torch.float32):
        progress = progress.to(torch.float32)
    for name, t in (("statuses", statuses), ("progress", progress)):
        if not t.is_contiguous():
            raise ValueError(f"the aggregation kernel takes contiguous tensors ({name})")
    return statuses, progress


def _unpack(packed: torch.Tensor) -> dict[str, torch.Tensor]:
    """The kernel's ``(4, S)`` output: int32 counts in row 0 (their bits),
    then f32 mean, max and min."""
    return {
        "count": packed[0].view(torch.int32),
        "mean_progress": packed[1],
        "max_progress": packed[2],
        "min_progress": packed[3],
    }


def _launch(statuses: torch.Tensor, progress: torch.Tensor) -> torch.Tensor:
    """One launch of the kernel on CUDA tensors; returns its ``(4, S)``
    output."""
    if not (statuses.is_cuda and progress.is_cuda):
        raise ValueError(
            f"the aggregation kernel runs on CUDA tensors, got {statuses.device} and "
            f"{progress.device} (aggregate_telemetry runs the plain version on the CPU)"
        )
    check_batch(statuses, progress)
    dev, n = statuses.device, statuses.shape[0]
    if n == 0:
        return torch.zeros(4, NUM_STATUSES, device=dev)
    statuses, progress = kernel_inputs(statuses, progress)
    sa, pa = statuses.data_ptr(), progress.data_ptr()
    if sa % 4 or pa % 4:
        raise ValueError("the aggregation kernel takes 4-byte aligned tensors")
    sms = _sm_count(dev)
    plan = aggregate_plan(n, sms)
    head, nvec = vector_span(n, sa % 16 // 4, pa % 16 // 4)
    stream = torch.cuda.current_stream(dev).cuda_stream
    words = _SCRATCH_HEAD + _PARTIAL_WORDS * min(BLOCKS_PER_SM * sms, MAX_GRID)
    scratch = None if plan.one_block else _scratch_for(dev, stream, words)
    out = torch.empty(4, NUM_STATUSES, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = _kernel_lib().aggregate_launch(
            sa, pa, n, head, nvec, int(progress.dtype == torch.float32), NUM_STATUSES,
            plan.grid, int(plan.one_block), None if scratch is None else scratch.data_ptr(),
            0 if scratch is None else scratch.numel(), out.data_ptr(), stream,
        )
    if err != 0:
        raise RuntimeError(f"aggregation kernel launch failed: CUDA error {err}")
    aggregate_telemetry_fused.launches += 1
    return out


def aggregate_telemetry_fused(statuses: torch.Tensor, progress: torch.Tensor):
    """``aggregate_telemetry`` of CUDA tensors in one launch of
    ``csrc/aggregate.cu`` (each launch adds one to
    ``aggregate_telemetry_fused.launches``). An empty batch returns zeros
    without a launch. Raises on tensors elsewhere than the card and on
    what the kernel does not take; never falls back.

    A launch goes on the calling thread's current stream and uses that
    (device, stream)'s scratch. The async sink's worker thread never sets
    a stream, so it launches on the device's default stream, as the main
    thread does unless it picks another: the two share that stream's
    buffer, which is safe because launches on one stream run one after
    another in the order they were made, each starting from the zero
    ticket the one before it left. A thread on another stream gets a
    buffer of its own."""
    return _unpack(_launch(statuses, progress))


aggregate_telemetry_fused.launches = 0


def aggregate_telemetry_packed(statuses: torch.Tensor, progress: torch.Tensor) -> torch.Tensor:
    """The four ``(S,)`` results as one ``(4, S)`` f32 tensor: row 0 the
    int32 counts' bits, rows 1-3 mean, max and min, so a caller reads them
    back in one copy. CUDA tensors: the kernel's own output (one launch);
    CPU tensors: the plain version's results, packed; any other device
    raises."""
    if statuses.is_cuda:
        return _launch(statuses, progress)
    from .aggregate import aggregate_telemetry  # it imports this module

    out = aggregate_telemetry(statuses, progress)
    return torch.stack([out["count"].view(torch.float32), out["mean_progress"],
                        out["max_progress"], out["min_progress"]])
