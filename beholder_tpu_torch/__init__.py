"""PyTorch/CUDA port of the beholder_tpu accelerator path.

The JAX package ``beholder_tpu`` stays the reference; this package is its
counterpart for an NVIDIA Hopper card (H100, ``sm_90a``). It keeps the
reference's module layout and names so a reader finds each counterpart:

- :mod:`beholder_tpu_torch.ops.quant` — KV page quantizers (int8, fp8/E8M0);
- :mod:`beholder_tpu_torch.ops.attention` — ``full_attention``;
- :mod:`beholder_tpu_torch.ops.paged_attention` — ``paged_decode_attention``
  and ``paged_chunk_attention``, hand-written CUDA kernels
  (``csrc/paged_decode.cu``, ``csrc/paged_chunk.cu``), each with its plain
  PyTorch version beside it;
- :mod:`beholder_tpu_torch.ops.flash_attention` — ``flash_attention``, a
  ``torch.autograd.Function`` over three hand-written CUDA kernels (forward
  in ``csrc/flash_fwd.cu``, dq and dk/dv in ``csrc/flash_bwd.cu``), each
  with its plain PyTorch version beside it;
- :mod:`beholder_tpu_torch.cache.prefix` — the automatic prefix cache (a
  radix index over page hashes, host side);
- :mod:`beholder_tpu_torch.models.sequence` — ``TelemetrySequenceModel``
  (full or flash attention, remat) and its training step;
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
  and what-if forecasts.

Not ported yet: speculative decoding, the intake queue, metrics, tracing,
the flight recorder, deadlines, autotune, the analytics sink and the
aggregate kernels, MoE, ring/Ulysses attention and the flash block-pair
(ring) entry points, the parallel stack, and the cluster and group
engines.

The package imports ``torch`` and numpy only: never ``jax`` and never a
module of ``beholder_tpu``. Entry points run on the card unless the caller
passes ``device="cpu"`` (see :func:`beholder_tpu_torch.device.resolve_device`).
"""

from .device import resolve_device

__all__ = ["resolve_device"]
