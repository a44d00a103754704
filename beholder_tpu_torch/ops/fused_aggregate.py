"""Per-status telemetry aggregation in one CUDA launch: the wrapper of
``csrc/aggregate.cu`` and its launch count.

Counterpart of the reference's ``ops/pallas_aggregate.py``. The kernel
replaces the TPU kernel ``beholder_tpu/ops/pallas_aggregate.py::_kernel``
(launched by ``_run``, public as ``aggregate_telemetry_pallas``): for a
``(B,)`` batch of statuses and progress values it computes the whole of
``aggregate_telemetry`` — per-status count, mean, max and min of progress,
0 for absent statuses, nothing from statuses outside ``[0, S)``.

What bounds it on the H100: bytes. It reads each event once, 4 bytes of
status and 4 of progress (int32 or f32), and writes 4 × S values; per event
it does a handful of integer and f32 operations, far below the card's
rate. At 8,388,608 events that is 67.1 MB, 20.0 µs at 3.35 TB/s; at the
sink's 4,096-event flushes a launch costs more than the bytes.

What the design does about it:

- it reads the batch in place, in one pass: no padded copy (the TPU path
  pads to a multiple of 65,536 with status -1), no one-hot matrix, and
  int32 progress is converted inside the kernel, so the sink's int32 batch
  costs no extra pass. Each thread loads 16 bytes of each input at a time
  where the two pointers share their offset within 16 bytes, and one event
  at a time over the unaligned head and the ragged tail;
- a fixed grid of up to 2 blocks per SM strides over the batch; each
  thread keeps 4 × S accumulators in registers (the status loop is unrolled
  with selects, so no register array is indexed by a dynamic status), a
  warp shuffle and one pass through shared memory reduce them, and each
  block writes one partial;
- the last block to finish (an atomic ticket after ``__threadfence()``)
  combines the partials in block order, the sums in f64, and writes the
  four outputs. There is no float atomic and no per-event atomic, so the
  result is the same bit for bit from run to run, and skewed streams (most
  events in one status) serialise nothing.

Counts are int32 (the Pallas kernel counts in f32, exact only to 2**24
events per lane). The launch also clears the 4-byte ticket on the stream
before the kernel runs.
"""

from __future__ import annotations

import ctypes

import torch

from . import NUM_STATUSES

#: grid: at most this many blocks per SM, and at least this many events a block
_BLOCKS_PER_SM = 2
_EVENTS_PER_BLOCK = 2048
#: per block partial: counts, sums, maxes, mins
_FIELDS = 4 * NUM_STATUSES

_lib: ctypes.CDLL | None = None


def _kernel_lib() -> ctypes.CDLL:
    """``csrc/aggregate.cu``, built at first use."""
    global _lib
    if _lib is None:
        from beholder_tpu_torch import csrc

        lib = csrc.load("aggregate")
        lib.aggregate_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ]
        lib.aggregate_launch.restype = ctypes.c_int
        _lib = lib
    return _lib


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


def aggregate_telemetry_fused(statuses: torch.Tensor, progress: torch.Tensor):
    """``aggregate_telemetry`` of CUDA tensors in one launch of
    ``csrc/aggregate.cu`` (each launch adds one to
    ``aggregate_telemetry_fused.launches``). An empty batch returns zeros
    without a launch. Raises on tensors elsewhere than the card and on
    what the kernel does not take; never falls back."""
    if not (statuses.is_cuda and progress.is_cuda):
        raise ValueError(
            f"the aggregation kernel runs on CUDA tensors, got {statuses.device} and "
            f"{progress.device} (aggregate_telemetry runs the plain version on the CPU)"
        )
    check_batch(statuses, progress)
    dev, n = statuses.device, statuses.shape[0]
    if n == 0:
        return _unpack(torch.zeros(4, NUM_STATUSES, device=dev))
    statuses, progress = kernel_inputs(statuses, progress)
    for name, t in (("statuses", statuses), ("progress", progress)):
        if t.data_ptr() % 4:
            raise ValueError(f"the aggregation kernel takes 4-byte aligned tensors ({name})")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    grid = max(1, min(_BLOCKS_PER_SM * sms, -(-n // _EVENTS_PER_BLOCK)))
    scratch = torch.empty(1 + grid * _FIELDS, dtype=torch.int32, device=dev)
    out = torch.empty(4, NUM_STATUSES, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = _kernel_lib().aggregate_launch(
            statuses.data_ptr(), progress.data_ptr(), n, int(progress.dtype == torch.float32),
            NUM_STATUSES, grid, scratch.data_ptr(), out.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"aggregation kernel launch failed: CUDA error {err}")
    aggregate_telemetry_fused.launches += 1
    return _unpack(out)


aggregate_telemetry_fused.launches = 0
