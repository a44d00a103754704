"""PyTorch/CUDA port of the beholder_tpu accelerator path.

The JAX package ``beholder_tpu`` stays the reference; this package is its
counterpart for an NVIDIA Hopper card (H100, ``sm_90a``). It keeps the
reference's module layout and names so a reader finds each counterpart:

- :mod:`beholder_tpu_torch.ops.quant` — KV page quantizers (int8, fp8/E8M0);
- :mod:`beholder_tpu_torch.ops.attention` — ``full_attention`` and
  ``ring_attention`` (context parallelism over a mesh's ``sp`` axis, on the
  flash kernels' block-pair mode);
- :mod:`beholder_tpu_torch.ops.paged_attention` — ``paged_decode_attention``
  and ``paged_chunk_attention``, hand-written CUDA kernels
  (``csrc/paged_decode.cu``, ``csrc/paged_chunk.cu``), each with its plain
  PyTorch version beside it;
- :mod:`beholder_tpu_torch.ops.flash_attention` — ``flash_attention``, a
  ``torch.autograd.Function`` over three hand-written CUDA kernels (forward
  in ``csrc/flash_fwd.cu``, dq and dk/dv in ``csrc/flash_bwd.cu``), each
  with its plain PyTorch version beside it, and the block-pair entry points
  ``flash_block_attend`` / ``flash_block_backward`` that ring attention
  runs on;
- :mod:`beholder_tpu_torch.ops.aggregate` — ``status_counts``,
  ``aggregate_telemetry`` and ``ewma``; on CUDA tensors
  ``aggregate_telemetry`` runs a hand-written CUDA kernel
  (``csrc/aggregate.cu``, wrapper in
  :mod:`beholder_tpu_torch.ops.fused_aggregate`), on CPU tensors its plain
  PyTorch version;
- :mod:`beholder_tpu_torch.analytics` — ``AnalyticsSink``, which buffers
  progress observations and aggregates each full batch on the card;
- :mod:`beholder_tpu_torch.cache.prefix` — the automatic prefix cache (a
  radix index over page hashes, host side);
- :mod:`beholder_tpu_torch.parallel` — ``Mesh``, the ordered devices of
  the ``sp`` axis (one card may repeat);
- :mod:`beholder_tpu_torch.models.sequence` — ``TelemetrySequenceModel``
  (full, flash or ring attention, remat) and its training step;
- :mod:`beholder_tpu_torch.models.anomaly` — ``ProgressAnomalyModel`` and
  its training step;
- :mod:`beholder_tpu_torch.models.train` — the shared ``TrainState`` and
  Adam;
- :mod:`beholder_tpu_torch.models.checkpoint` — ``save_state`` /
  ``restore_state`` (bit-identical resume);
- :mod:`beholder_tpu_torch.models.bridge` — loads the reference's flax
  params and optax Adam state into the port's modules;
- :mod:`beholder_tpu_torch.models.decode` — the dense forecast oracle;
- :mod:`beholder_tpu_torch.models.serving` — the paged pool and the
  ``ContinuousBatcher``: cold, fused-wave and prefix-hit admission, forks
  and what-if forecasts;
- :mod:`beholder_tpu_torch.spec` — speculative decoding
  (``ContinuousBatcher(spec=SpecConfig(...)).run_spec``): the null, n-gram
  and small-model drafters, the dense-gather verify and the fused verify
  through the paged chunk kernel, greedy and sampled acceptance.

Not ported yet: the intake queue, metrics, tracing,
the flight recorder, deadlines, autotune, MoE, Ulysses attention, the
rest of the parallel stack (``dp``/``tp`` axes, a multi-process ring,
sequence sharding), and the cluster and group engines.

The package imports ``torch`` and numpy only: never ``jax`` and never a
module of ``beholder_tpu``. Entry points run on the card unless the caller
passes ``device="cpu"`` (see :func:`beholder_tpu_torch.device.resolve_device`).
"""

from .device import resolve_device

__all__ = ["resolve_device"]
