"""PyTorch/CUDA port of beholder_tpu: the service and its accelerator path.

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
- :mod:`beholder_tpu_torch.parallel` — the named-axis ``Mesh`` (``dp``,
  ``tp``, ``sp``, ``ep``, ``pp``; one card may repeat), megatron tensor
  parallelism with sequence sharding, ZeRO-2/3, the GPipe and 1F1B
  pipelines, and ``initialize`` (a ``torch.distributed`` group) with
  ``make_hybrid_mesh``, a mesh over every process of the group on which
  the sharded steps and ZeRO train (dp across processes);
- :mod:`beholder_tpu_torch.dryrun` — ``entry()`` and ``dryrun_multichip``,
  the counterparts of the reference's ``__graft_entry__.py``;
- :mod:`beholder_tpu_torch.ops.moe` — Switch, GShard and expert-choice
  MoE; :mod:`beholder_tpu_torch.ops.attention` also holds Ulysses;
- :mod:`beholder_tpu_torch.models.sequence` — ``TelemetrySequenceModel``
  (full, flash, ring or Ulysses attention, remat) and its training step;
- :mod:`beholder_tpu_torch.models.anomaly` — ``ProgressAnomalyModel`` and
  its training step;
- :mod:`beholder_tpu_torch.models.train` — the shared ``TrainState`` and
  Adam;
- :mod:`beholder_tpu_torch.models.checkpoint` — ``save_state`` /
  ``restore_state`` (bit-identical resume);
- :mod:`beholder_tpu_torch.models.bridge` — loads the reference's flax
  params and optax Adam state into the port's modules;
- :mod:`beholder_tpu_torch.models.decode` — the dense forecast oracle and
  dp/tp-sharded dense serving;
- :mod:`beholder_tpu_torch.models.serving` — the paged pool and the
  ``ContinuousBatcher``: cold, fused-wave and prefix-hit admission, forks
  and what-if forecasts, the bounded intake (``submit`` / ``run_pending``)
  and request deadlines;
- :mod:`beholder_tpu_torch.spec` — speculative decoding
  (``ContinuousBatcher(spec=SpecConfig(...)).run_spec``): the null, n-gram
  and small-model drafters, the dense-gather verify and the fused verify
  through the paged chunk kernel, greedy and sampled acceptance;
- :mod:`beholder_tpu_torch.cluster` — the serving cluster (sharded pools,
  prefill/decode handoff, routing, failover and drain), its memory fabric
  and group-parallel decode;
- the serving layer's host-side instruments, each off by default:
  :mod:`beholder_tpu_torch.metrics` (the Prometheus exposition and its
  HTTP server), :mod:`beholder_tpu_torch.tracing` (spans, trace context,
  span reporters), :mod:`beholder_tpu_torch.obs` (the flight recorder,
  roofline attribution, request timelines, the SLO tracker),
  :mod:`beholder_tpu_torch.reliability` (deadlines, retries, the circuit
  breaker, the dead-letter consumer, the intake queue, fault injection) and :mod:`beholder_tpu_torch.control` (the tenant-fair
  intake, k-shedding, tail and deadline routing, the autoscaler);
- :mod:`beholder_tpu_torch.artifact` and :mod:`beholder_tpu_torch.tools`
  — the schema-versioned artifact recorder, the serving profile and the
  producer CLI (``tools.publish``);
- the service itself: :mod:`beholder_tpu_torch.service` (``init``,
  ``main``, the status and progress consumers, feeding ``AnalyticsSink``),
  :mod:`beholder_tpu_torch.config`, :mod:`beholder_tpu_torch.log`,
  :mod:`beholder_tpu_torch.proto` (the ``api`` messages, a hand-written
  proto3 codec), :mod:`beholder_tpu_torch.mq` (the in-memory broker, the
  AMQP 0-9-1 client and mini broker, and the batched native ingest path
  with its frame scanner built from C++ at first use),
  :mod:`beholder_tpu_torch.storage`
  (memory, SQLite and Postgres), :mod:`beholder_tpu_torch.clients` (Trello,
  Telegram, Emby), :mod:`beholder_tpu_torch.httpd` and
  :mod:`beholder_tpu_torch.health`.

The chunk kernel's autotune table is :mod:`beholder_tpu_torch.ops.autotune`
and the ratio-only perf gate :mod:`beholder_tpu_torch.tools.perf_gate`.
Every parallel path also runs on a mesh over processes, its collectives
crossing them bitwise (:mod:`beholder_tpu_torch.parallel.collectives`). Not
ported yet (``ROADMAP.md``): the port's bench (A.6).

The package imports ``torch`` and numpy only: never ``jax`` and never a
module of ``beholder_tpu``. Entry points run on the card unless the caller
passes ``device="cpu"`` (see :func:`beholder_tpu_torch.device.resolve_device`).
"""

from .device import resolve_device

__all__ = ["resolve_device"]
