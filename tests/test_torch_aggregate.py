"""The port's telemetry aggregation against the JAX reference.

The same numpy-seeded batches go through the reference's XLA
``aggregate_telemetry``, its Pallas kernel in interpret mode (as
``tests/test_pallas_aggregate.py`` runs it on the CPU) and the port's
``aggregate_telemetry`` on CPU tensors, which runs the plain version.
Tolerances: counts, max and min exactly equal; the mean within rtol 1e-5,
the reference's own band (``tests/test_pallas_aggregate.py:18-20``), since
the port sums progress in another order than XLA's one-hot product;
``ewma`` within rtol 1e-6 (``tests/test_ops.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

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
from beholder_tpu_torch.ops.fused_aggregate import kernel_inputs


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
