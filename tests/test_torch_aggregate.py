"""The port's telemetry aggregation against the JAX reference.

The same numpy-seeded batches go through the reference's XLA
``aggregate_telemetry``, its Pallas kernel in interpret mode (as
``tests/test_pallas_aggregate.py`` runs it on the CPU) and the port's
``aggregate_telemetry`` on CPU tensors, which runs the plain version.
Tolerances: counts, max and min exactly equal; the mean within rtol 1e-5,
the reference's own band (``tests/test_pallas_aggregate.py:18-20``), since
the port sums progress in another order than XLA's one-hot product;
``ewma`` within rtol 1e-6 (``tests/test_ops.py``). The card path's plan,
partition and fixed-order combine are checked below without a card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as hst

from beholder_tpu.ops import aggregate_telemetry as ref_aggregate
from beholder_tpu.ops import ewma as ref_ewma
from beholder_tpu.ops import status_counts as ref_status_counts
from beholder_tpu.ops.pallas_aggregate import aggregate_telemetry_pallas
from beholder_tpu_torch import csrc
from beholder_tpu_torch.ops import (
    NUM_STATUSES,
    aggregate_telemetry,
    aggregate_telemetry_fused,
    aggregate_telemetry_reference,
    ewma,
    status_counts,
)
from beholder_tpu_torch.ops import fused_aggregate as fa
from beholder_tpu_torch.ops.fused_aggregate import aggregate_plan, kernel_inputs, vector_span


def _statuses(case: str, rng) -> np.ndarray:
    if case == "exact_tile":
        return rng.integers(0, NUM_STATUSES, size=4096)
    if case == "ragged":
        return rng.integers(0, NUM_STATUSES, size=2500)
    if case == "tiny":
        return np.array([0, 5, 5])
    if case == "empty":
        return np.zeros(0, np.int64)
    if case == "single_status":
        return np.full(1500, 3)
    if case == "out_of_range":
        s = rng.integers(0, NUM_STATUSES, size=3000)
        bad = rng.random(3000) < 0.1
        s[bad] = rng.choice([-1, 6, 100], size=int(bad.sum()))
        return s
    if case == "two_tiles":  # two 65,536-event grid steps of the TPU kernel, ragged
        return rng.integers(0, NUM_STATUSES, size=131_071)
    raise AssertionError(case)


CASES = ["exact_tile", "ragged", "tiny", "empty", "single_status", "out_of_range", "two_tiles"]


def _batch(case: str, progress_dtype: str):
    rng = np.random.default_rng(CASES.index(case) * 2 + (progress_dtype == "f32"))
    statuses = _statuses(case, rng).astype(np.int32)
    n = statuses.shape[0]
    if progress_dtype == "int32":
        progress = rng.integers(0, 101, size=n).astype(np.int32)
    else:
        progress = rng.uniform(0, 100, size=n).astype(np.float32)
    return statuses, progress


def _assert_matches(got: dict, want: dict) -> None:
    got = {k: v.numpy() for k, v in got.items()}
    want = {k: np.asarray(v) for k, v in want.items()}
    assert got["count"].dtype == np.int32
    np.testing.assert_array_equal(got["count"], want["count"])
    np.testing.assert_allclose(got["mean_progress"], want["mean_progress"], rtol=1e-5)
    np.testing.assert_array_equal(got["max_progress"], want["max_progress"])
    np.testing.assert_array_equal(got["min_progress"], want["min_progress"])


@pytest.mark.parametrize("reference", ["xla", "pallas_interpret"])
@pytest.mark.parametrize("progress_dtype", ["int32", "f32"])
@pytest.mark.parametrize("case", CASES)
def test_aggregate_matches_reference(case, progress_dtype, reference):
    statuses, progress = _batch(case, progress_dtype)
    ref = ref_aggregate if reference == "xla" else aggregate_telemetry_pallas
    if case == "empty" and reference == "xla":
        # the XLA path has no empty batch (jnp.max of nothing raises); the
        # port returns zeros, as the Pallas wrapper does
        with pytest.raises(ValueError, match="zero-size"):
            ref(jnp.asarray(statuses), jnp.asarray(progress))
        want = aggregate_telemetry_pallas(jnp.asarray(statuses), jnp.asarray(progress))
    else:
        want = ref(jnp.asarray(statuses), jnp.asarray(progress))
    got = aggregate_telemetry(torch.from_numpy(statuses), torch.from_numpy(progress))
    _assert_matches(got, want)
    if case == "single_status":
        assert int(got["count"][3]) == statuses.shape[0]
    if case == "empty":
        assert all(float(v.abs().sum()) == 0 for v in got.values())


@pytest.mark.parametrize("case", ["ragged", "tiny", "empty", "out_of_range"])
def test_status_counts_matches_reference(case):
    statuses = _statuses(case, np.random.default_rng(7)).astype(np.int32)
    got = status_counts(torch.from_numpy(statuses))
    assert got.dtype == torch.int32 and got.shape == (NUM_STATUSES,)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref_status_counts(jnp.asarray(statuses))))


def test_out_of_range_statuses_contribute_nothing():
    """-1, 6 and 100 match no status: the batch aggregates as if they were
    not there (``jax.nn.one_hot`` gives them a zero row)."""
    statuses = np.array([-1, 6, 100, 2, 2, 4], np.int32)
    progress = np.array([99, 98, 97, 10, 30, 70], np.int32)
    got = aggregate_telemetry(torch.from_numpy(statuses), torch.from_numpy(progress))
    want = aggregate_telemetry(torch.from_numpy(statuses[3:]), torch.from_numpy(progress[3:]))
    for k in want:
        assert torch.equal(got[k], want[k]), k
    assert got["count"].tolist() == [0, 0, 2, 0, 1, 0]
    assert got["max_progress"].tolist() == [0.0, 0.0, 30.0, 0.0, 70.0, 0.0]


@pytest.mark.parametrize(
    "series, alpha",
    [
        (np.array([0.0, 10.0, 10.0, 10.0, 100.0]), 0.5),
        (np.random.default_rng(3).uniform(0, 100, 257), 0.1),
        (np.random.default_rng(4).uniform(0, 100, (64, 3)), 0.3),
    ],
)
def test_ewma_matches_reference(series, alpha):
    """Progress-like series (positive): the two sides round ``alpha * x +
    (1 - alpha) * carry`` in f32 at different places (XLA may fuse it into
    one FMA), which rtol covers away from zero."""
    series = series.astype(np.float32)
    want = np.asarray(ref_ewma(jnp.asarray(series), alpha))
    got = ewma(torch.from_numpy(series), alpha)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)


def test_arrays_go_to_the_card_by_default(monkeypatch):
    """numpy inputs with ``device=None`` go to the card, and raise where
    there is none; ``device="cpu"`` runs the plain version."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    statuses, progress = _batch("tiny", "int32")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        aggregate_telemetry(statuses, progress)
    got = aggregate_telemetry(statuses, progress, device="cpu")
    assert got["count"].device.type == "cpu"
    assert got["count"].tolist() == [1, 0, 0, 0, 0, 2]


def test_cpu_tensors_build_no_kernel(monkeypatch):
    def refuse(*names):
        raise AssertionError(f"a kernel build was asked for: {names}")

    monkeypatch.setattr(csrc, "build", refuse)
    monkeypatch.setattr(csrc, "load", refuse)
    launches = aggregate_telemetry_fused.launches
    statuses, progress = _batch("ragged", "int32")
    aggregate_telemetry(torch.from_numpy(statuses), torch.from_numpy(progress))
    assert aggregate_telemetry_fused.launches == launches
    assert "aggregate" not in csrc._loaded


def test_kernel_wrapper_never_falls_back():
    """The kernel's wrapper takes CUDA tensors only; ``aggregate_telemetry``
    raises on a device other than the CPU and the card."""
    cpu = torch.zeros(8, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA tensors"):
        aggregate_telemetry_fused(cpu, cpu)
    meta = torch.zeros(8, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CUDA tensors"):
        aggregate_telemetry(meta, meta)


@pytest.mark.parametrize(
    "statuses, progress, error",
    [
        (torch.zeros(4, 2, dtype=torch.int32), torch.zeros(4, 2, dtype=torch.int32), ValueError),
        (torch.zeros(4, dtype=torch.int32), torch.zeros(5, dtype=torch.int32), ValueError),
        (torch.zeros(4), torch.zeros(4), TypeError),
        (torch.zeros(8, dtype=torch.int32)[::2], torch.zeros(4, dtype=torch.int32), ValueError),
    ],
    ids=["2d", "lengths", "float_statuses", "strided"],
)
def test_kernel_refuses_what_it_does_not_take(statuses, progress, error):
    with pytest.raises(error):
        kernel_inputs(statuses, progress)


@pytest.mark.parametrize(
    "status_dtype, progress_dtype, want",
    [
        (torch.int64, torch.int32, torch.int32),
        (torch.int16, torch.float32, torch.float32),
        (torch.int32, torch.int64, torch.float32),
        (torch.uint8, torch.bfloat16, torch.float32),
        (torch.int32, torch.float64, torch.float32),
    ],
)
def test_kernel_inputs_cast_to_what_the_kernel_takes(status_dtype, progress_dtype, want):
    statuses, progress = kernel_inputs(
        torch.arange(6).to(status_dtype), (torch.arange(6) * 7).to(progress_dtype)
    )
    assert statuses.dtype == torch.int32 and progress.dtype == want
    assert statuses.tolist() == list(range(6))
    assert progress.tolist() == [7.0 * i for i in range(6)]


def test_reference_is_the_plain_version_on_any_device():
    """``aggregate_telemetry`` on CPU tensors is its plain version."""
    statuses, progress = _batch("out_of_range", "f32")
    a = aggregate_telemetry(torch.from_numpy(statuses), torch.from_numpy(progress))
    b = aggregate_telemetry_reference(torch.from_numpy(statuses), torch.from_numpy(progress))
    for k in a:
        assert torch.equal(a[k], b[k]), k


# --- the card path's plan and partition, checked without a card -------------
#
# ``csrc/aggregate.cu`` runs one block up to ``ONE_BLOCK_MAX`` events and a
# persistent grid above it (``aggregate_plan``), reads events
# ``[head, head + 4 nvec)`` as 16-byte loads (``vector_span``) in rounds of
# ``fa.ROUND_EVENTS`` taken by block ``round mod grid``, and the rest one at
# a time, element ``j`` by global thread ``j mod (grid * THREADS)``. The walk
# below mirrors the kernel's two loops; ``chip_smoke.py`` holds the kernel
# itself against the plain version on the card.

#: the H100's SMs
SMS = 132


def _walk(n: int, head: int, nvec: int, grid: int):
    """(event, block, thread) for every event the kernel's loops add, in
    the order each thread adds them: the body's rounds, then the element
    path (its four loads ahead a thread taken in order)."""
    threads, per_round = fa.THREADS, fa.ROUND_EVENTS // 4
    rounds = -(-nvec // per_round)
    tail0 = head + 4 * nvec
    rest = head + (n - tail0)
    stride = grid * threads
    events, blocks, tids = [], [], []
    for b in range(grid):
        g = (np.arange(b, rounds, grid)[:, None] * per_round + np.arange(per_round)).ravel()
        g = g[g < nvec]
        ev = (head + 4 * g[:, None] + np.arange(4)).ravel()
        events.append(ev)
        tids.append(np.repeat(g % threads, 4))
        j = (b * threads + np.arange(threads))[None, :] + np.arange(0, rest, 4 * stride)[:, None]
        j = (j[:, None, :] + np.arange(4)[None, :, None] * stride).reshape(-1, threads)
        t = np.broadcast_to(np.arange(threads), j.shape)
        keep = j < rest
        j, t = j[keep], t[keep]
        events.append(np.where(j < head, j, tail0 + (j - head)))
        tids.append(t)
        blocks.append(np.full(ev.size + j.size, b))
    return np.concatenate(events), np.concatenate(blocks), np.concatenate(tids)


def test_plan_runs_one_block_at_the_sink_flush():
    """The sink's flush of 4,096 events is one block (no ticket, no
    partials), as is everything up to the limit; one past it is a grid."""
    assert aggregate_plan(4096, SMS) == (True, 1)
    assert aggregate_plan(1, SMS) == (True, 1)
    assert aggregate_plan(fa.ONE_BLOCK_MAX, SMS) == (True, 1)
    assert aggregate_plan(fa.ONE_BLOCK_MAX + 1, SMS).one_block is False
    assert aggregate_plan(8_388_608, SMS) == (False, fa.BLOCKS_PER_SM * SMS)


@settings(max_examples=200, deadline=None)
@given(n=hst.integers(1, 10**9), sms=hst.integers(1, 400))
def test_plan_grid_is_never_empty_and_fits_the_scratch(n, sms):
    """Never 0 blocks; one block exactly on the one-block path; a grid never
    larger than the scratch holds (BLOCKS_PER_SM a SM) nor than the last
    block can stage (MAX_GRID); the same answer for the same (n, SMs)."""
    plan = aggregate_plan(n, sms)
    assert plan.grid >= 1
    assert plan.one_block == (n <= fa.ONE_BLOCK_MAX)
    if plan.one_block:
        assert plan.grid == 1
    else:
        assert 2 <= plan.grid <= min(fa.BLOCKS_PER_SM * sms, fa.MAX_GRID)
        assert plan.grid <= -(-n // fa.ROUND_EVENTS)  # no block without a round
    assert aggregate_plan(n, sms) == plan


@settings(max_examples=60, deadline=None)
@given(n=hst.integers(1, 3_000_000), status_offset=hst.integers(0, 3),
       progress_offset=hst.integers(0, 3), sms=hst.sampled_from([1, 2, 5, 132]))
def test_partition_puts_every_event_in_exactly_one_block(n, status_offset, progress_offset,
                                                         sms):
    """Head offsets of 0-3 elements for each pointer: every event is in
    exactly one block's share (element head, 16-byte body, ragged tail), no
    event outside the batch, and the body starts on a 16-byte boundary of
    both inputs."""
    head, nvec = vector_span(n, status_offset, progress_offset)
    assert 0 <= head and head + 4 * nvec <= n
    if nvec:
        assert (status_offset + head) % 4 == 0 and (progress_offset + head) % 4 == 0
        assert head < 4 and n - head - 4 * nvec < 4
    plan = aggregate_plan(n, sms)
    events, blocks, tids = _walk(n, head, nvec, plan.grid)
    assert events.min() >= 0 and events.max() < n
    assert np.array_equal(np.bincount(events, minlength=n), np.ones(n, np.int64))
    assert blocks.max() < plan.grid and tids.max() < fa.THREADS


def _emulate(statuses: np.ndarray, progress: np.ndarray, offsets, sms: int) -> dict:
    """The kernel's arithmetic in numpy: per thread and status an f32 sum in
    the thread's order; per block, lane l sums threads l, l + 32, ... in f64,
    then the xor tree; the partials combined the same way over blocks
    (lane l: blocks l, l + 32, ...). Max and min from -1e9 / +1e9."""
    n, big = statuses.shape[0], np.float32(1e9)
    p32 = progress.astype(np.float32)
    zero = {k: np.zeros(NUM_STATUSES, np.float32) for k in
            ("mean_progress", "max_progress", "min_progress")}
    if n == 0:
        return {"count": np.zeros(NUM_STATUSES, np.int32), **zero}
    head, nvec = vector_span(n, *offsets)
    plan = aggregate_plan(n, sms)
    events, blocks, tids = _walk(n, head, nvec, plan.grid)
    st = statuses[events]
    ok = (st >= 0) & (st < NUM_STATUSES)
    events, blocks, tids, st = events[ok], blocks[ok], tids[ok], st[ok]
    threads, grid = fa.THREADS, plan.grid
    thread_sum = np.zeros((grid, threads, NUM_STATUSES), np.float32)
    for e, b, t, s in zip(events, blocks, tids, st):  # each thread's own order
        thread_sum[b, t, s] = np.float32(thread_sum[b, t, s] + p32[e])

    def lanes_then_tree(x):  # (..., m) -> (...,): lane l sums l, l + 32, ... then xor tree
        m = x.shape[-1]
        lanes = np.zeros(x.shape[:-1] + (32,), np.float64)
        for k in range(0, m, 32):
            chunk = x[..., k:k + 32].astype(np.float64)
            lanes[..., :chunk.shape[-1]] += chunk
        for off in (16, 8, 4, 2, 1):
            lanes = lanes + lanes[..., np.arange(32) ^ off]
        return lanes[..., 0]

    block_sum = lanes_then_tree(thread_sum.transpose(0, 2, 1))  # (grid, S)
    total = lanes_then_tree(block_sum.T)  # (S,)
    count = np.bincount(st, minlength=NUM_STATUSES).astype(np.int32)
    hi = np.full(NUM_STATUSES, -big)
    lo = np.full(NUM_STATUSES, big)
    np.maximum.at(hi, st, p32[events])
    np.minimum.at(lo, st, p32[events])
    present = count > 0
    mean = np.where(present, total.astype(np.float32) / np.maximum(count, 1).astype(np.float32),
                    np.float32(0))
    return {"count": count, "mean_progress": mean.astype(np.float32),
            "max_progress": np.where(present, hi, np.float32(0)).astype(np.float32),
            "min_progress": np.where(present, lo, np.float32(0)).astype(np.float32)}


@pytest.mark.parametrize("sms", [SMS, 4], ids=["132sm", "4sm"])
@pytest.mark.parametrize("progress_dtype", ["int32", "f32"])
@pytest.mark.parametrize("case", CASES)
def test_block_partials_combine_to_the_plain_version(case, progress_dtype, sms):
    """The kernel's per-block partials, combined in its fixed order with f64
    sums, against ``aggregate_telemetry_reference``: counts, max and min
    exact, the mean within rtol 1e-5 (the chip check's band). Pointer
    offsets vary by case; ``out_of_range`` has none in common (every event
    one at a time); at 4 SMs ``two_tiles`` walks several rounds a block."""
    statuses, progress = _batch(case, progress_dtype)
    i = CASES.index(case)
    offsets = (1, 2) if case == "out_of_range" else (i % 4, i % 4)
    got = _emulate(statuses, progress, offsets, sms)
    want = aggregate_telemetry_reference(torch.from_numpy(statuses), torch.from_numpy(progress))
    np.testing.assert_array_equal(got["count"], want["count"].numpy())
    np.testing.assert_array_equal(got["max_progress"], want["max_progress"].numpy())
    np.testing.assert_array_equal(got["min_progress"], want["min_progress"].numpy())
    np.testing.assert_allclose(got["mean_progress"], want["mean_progress"].numpy(), rtol=1e-5)


@pytest.mark.parametrize("case", ["ragged", "tiny", "empty", "out_of_range"])
def test_packed_readback_on_the_cpu_is_the_plain_version(case):
    """``aggregate_telemetry_packed`` on CPU tensors: one (4, S) f32 tensor,
    row 0 the int32 counts' bits, rows 1-3 mean, max and min, equal to
    ``aggregate_telemetry``'s dict (what the sink reads back in one copy)."""
    statuses, progress = _batch(case, "int32")
    s, p = torch.from_numpy(statuses), torch.from_numpy(progress)
    packed = fa.aggregate_telemetry_packed(s, p)
    want = aggregate_telemetry(s, p)
    assert packed.shape == (4, NUM_STATUSES) and packed.dtype == torch.float32
    assert torch.equal(packed[0].view(torch.int32), want["count"])
    for row, key in enumerate(("mean_progress", "max_progress", "min_progress"), start=1):
        assert torch.equal(packed[row], want[key]), key
