"""The beholder service: bootstrap + the two telemetry consumers.

The port's own copy of the reference's ``service.py``, with the same
observable semantics:

- status consumer: decode -> update DB -> early-ack if NO_TRELLO -> fetch
  row -> move the Trello card when the creator is TRELLO and a flow list
  is mapped (pos=2) -> on DEPLOYED, fire the Telegram and Emby hooks with
  errors swallowed (warn only) -> ack. Failures *before* the hook block
  (DB, Trello move) propagate and the message is left unacked.
- progress consumer: the whole body wrapped; any error warns and acks
  anyway — at-most-once. With ``instance.analytics.enabled`` every
  progress observation goes to an :class:`~beholder_tpu_torch.analytics.
  AnalyticsSink`, which aggregates each full batch on the card (the
  aggregation kernel, ``csrc/aggregate.cu``).
- the comment helper increments ``beholder_trello_comments``.

Reliability (``instance.reliability.enabled``; off by default, so the
semantics above and the default exposition stay byte-identical):

- the consumers become AT-LEAST-ONCE with a dead-letter parking lot: a
  failing handler nacks for redelivery up to ``consumer.max_attempts``
  deliveries, then the message is parked on ``<topic>.dlq`` with
  death-provenance headers; an idempotency window acks redeliveries of
  already-handled messages without re-running side effects;
- outbound HTTP (Trello, Telegram, Emby share one transport) rides a
  :class:`~beholder_tpu_torch.reliability.ResilientTransport`: a circuit
  breaker, bounded jittered retries under a shared budget, per-attempt
  timeouts capped by the deadline. An open breaker degrades /healthz.

Batched native ingest (``instance.ingest.enabled``; off by default): a
broker that supports it (``AmqpBroker``) scans each socket poll in one
native pass with zero-copy payloads and dispatches whole batches; the
consumers' prepare stages fold one decode pass and ONE storage transaction
per drained batch, while the per-message handler chain (tracing, timing,
at-least-once settlement) runs unchanged.

Caching (``instance.cache.enabled``; off by default): storage reads go
through a :class:`~beholder_tpu_torch.storage.CachingStorage` (TTL, writer-side
invalidation, singleflight), read-only outbound lookups through a
:class:`~beholder_tpu_torch.clients.http.CachingTransport` outside the
resilience stack, and ``init()`` memoizes the /metrics exposition for
``instance.cache.httpd.metrics_max_age_s``.

Storage: ``init()`` opens ``$BEHOLDER_DB`` as SQLite, or as
:class:`~beholder_tpu_torch.storage.PostgresStorage` when it is a
``postgres://`` or ``postgresql://`` URL.

``device`` goes to the analytics sink and the flight recorder's roofline
attributor: None means the CUDA card (raising where there is none),
``"cpu"`` the plain PyTorch path. With neither knob on, the service does
no device work.

Cluster observability (each off by default; off, serving output, wire bytes
and the default exposition are unchanged):

- ``instance.observability.flight_plane``: the recorder's ring gains worker
  identity, a clock anchor and cross-worker edge ids; outbound HTTP carries
  the active span's W3C ``traceparent`` (:class:`~beholder_tpu_torch.
  clients.http.TracingTransport`, outermost); ``GET /debug/cluster-flight``
  serves the merged timeline, dumped at shutdown;
- ``.retention``: a tail-based trace vault behind the SLO tracker
  (``GET /debug/traces`` and ``/debug/traces/<id>``; SLO worst requests and
  histogram exemplars gain ``trace_ref`` joins);
- ``.sentinel``: the online regression sentinel behind the vault, opening
  incidents on it (``GET /debug/sentinel`` and a ``/healthz`` check).
"""

from __future__ import annotations

import os
import time

from beholder_tpu_torch import proto
from beholder_tpu_torch.clients import (
    EmbyClient,
    HttpTransport,
    TelegramClient,
    TrelloClient,
)
from beholder_tpu_torch.config import Config, ConfigNode, dyn, no_trello
from beholder_tpu_torch.log import get_logger
from beholder_tpu_torch.metrics import Metrics
from beholder_tpu_torch.mq import Broker, Delivery
from beholder_tpu_torch.mq.ingest import ingest_from_config
from beholder_tpu_torch.storage import MediaNotFound, PostgresStorage, SqliteStorage, Storage

STATUS_TOPIC = "v1.telemetry.status"
PROGRESS_TOPIC = "v1.telemetry.progress"
PREFETCH = 100


class BeholderService:
    def __init__(
        self,
        config: ConfigNode,
        broker: Broker,
        db: Storage,
        metrics: Metrics | None = None,
        transport: HttpTransport | None = None,
        logger=None,
        *,
        device=None,
    ):
        self.config = config
        self.broker = broker
        self.db = db
        self.metrics = metrics or Metrics()
        self.logger = logger or get_logger("beholder")

        #: optional deep observability (off by default so the reference
        #: exposition stays byte-identical): per-message handle histograms
        #: on the consumers and outbound HTTP latency via TimedTransport
        self.handle_seconds = None
        if config.get("instance.observability.enabled"):
            from beholder_tpu_torch.clients.http import RequestsTransport, TimedTransport
            from beholder_tpu_torch.metrics import get_or_create

            self.handle_seconds = get_or_create(
                self.metrics.registry,
                "histogram",
                "beholder_message_handle_seconds",
                "Telemetry message handle wall time by topic and outcome",
                labelnames=["topic", "outcome"],
            )
            transport = TimedTransport(transport or RequestsTransport(), self.metrics.registry)

        #: the reliability subsystem: at-least-once consumers with DLQ
        #: parking and dedup, and breaker/retry/deadline armour on the
        #: shared outbound transport
        self._at_least_once = bool(config.get("instance.reliability.enabled"))
        self.breaker = None
        self.reliability = None
        self.reliable_consumers: dict[str, object] = {}
        if self._at_least_once:
            from beholder_tpu_torch.reliability import (
                CircuitBreaker,
                ReliabilityMetrics,
                ResilientTransport,
                RetryBudget,
                RetryPolicy,
            )

            if transport is None:
                from beholder_tpu_torch.clients.http import RequestsTransport

                transport = RequestsTransport()

            rel = config.get("instance.reliability") or ConfigNode({})
            self.reliability = ReliabilityMetrics(self.metrics.registry)
            self.breaker = CircuitBreaker(
                name="http",
                window=int(rel.get("breaker.window", 20)),
                min_calls=int(rel.get("breaker.min_calls", 5)),
                failure_threshold=float(rel.get("breaker.failure_threshold", 0.5)),
                reset_timeout_s=float(rel.get("breaker.reset_timeout_s", 30.0)),
                half_open_probes=int(rel.get("breaker.half_open_probes", 1)),
                half_open_successes=int(rel.get("breaker.half_open_successes", 2)),
                metrics=self.reliability,
                logger=self.logger,
            )
            retry = RetryPolicy(
                max_attempts=int(rel.get("retry.max_attempts", 3)),
                base_delay_s=float(rel.get("retry.base_delay_s", 0.05)),
                max_delay_s=float(rel.get("retry.max_delay_s", 2.0)),
                budget=RetryBudget(
                    capacity=float(rel.get("retry.budget_capacity", 10.0)),
                    deposit_per_call=float(rel.get("retry.budget_per_call", 0.1)),
                ),
                # the transport decides retryability per error (4xx never
                # raises; BreakerOpenError is excluded by should_retry)
                retry_on=(Exception,),
                metrics=self.reliability,
                logger=self.logger,
            )
            # Resilient OUTSIDE Timed: each attempt is timed on its own,
            # while the breaker sees the attempt stream
            transport = ResilientTransport(
                transport,
                breaker=self.breaker,
                retry=retry,
                default_deadline_s=float(config.get("instance.http.deadline_s", 10.0)),
                logger=self.logger,
            )
            self._consumer_max_attempts = int(rel.get("consumer.max_attempts", 3))
            self._consumer_dedup_window = int(rel.get("consumer.dedup_window", 4096))

        #: the caching subsystem: storage reads memoized with writer-side
        #: invalidation (a progress message's ``get_by_id`` stops re-querying
        #: rows that change only on status transitions), and read-only
        #: outbound lookups TTL-cached OUTSIDE the resilience stack (a hit
        #: costs the dependency, and the breaker's window, nothing).
        #: Side-effectful GETs (Telegram sendMessage, Emby refresh) are never
        #: cached: ``clients.http.read_only_get`` is an allowlist
        if config.get("instance.cache.enabled"):
            cache_cfg = config.get("instance.cache") or ConfigNode({})
            if bool(cache_cfg.get("storage.enabled", True)):
                from beholder_tpu_torch.storage import CachingStorage

                self.db = CachingStorage(
                    db,
                    ttl_s=float(cache_cfg.get("storage.ttl_s", 30.0)),
                    max_entries=int(cache_cfg.get("storage.max_entries", 1024)),
                    metrics=self.metrics.registry,
                )
            if bool(cache_cfg.get("http.enabled", True)):
                from beholder_tpu_torch.clients.http import CachingTransport, RequestsTransport

                transport = CachingTransport(
                    transport or RequestsTransport(),
                    ttl_s=float(cache_cfg.get("http.ttl_s", 5.0)),
                    max_entries=int(cache_cfg.get("http.max_entries", 256)),
                    metrics=self.metrics.registry,
                )

        #: library knobs the service only parses, for whatever embeds the
        #: serving layer next to the consumers (each None when off)
        from beholder_tpu_torch.spec import spec_from_config

        self.spec = spec_from_config(config)

        from beholder_tpu_torch.obs import (
            flight_plane_from_config,
            flight_recorder_from_config,
            register_build_info,
        )

        self.flight_recorder = flight_recorder_from_config(config, device=device)
        if self.flight_recorder is not None:
            # the drop-pressure series and beholder_build_info register
            # only with the recorder armed: off, the exposition is unchanged
            self.flight_recorder.bind_metrics(self.metrics.registry)
            register_build_info(self.metrics.registry)

        #: the cluster-wide flight plane: it stamps this process's ring with
        #: worker identity and a clock anchor, arms cross-worker edge ids,
        #: carries ``traceparent`` on outbound HTTP (TracingTransport below)
        #: and serves the merged timeline at GET /debug/cluster-flight
        self.flight_plane = flight_plane_from_config(config)
        if self.flight_plane is not None and self.flight_recorder is not None:
            self.flight_plane.bind(self.flight_recorder)

        #: library knobs for whatever embeds a batcher beside the service (the
        #: service builds none): ``ContinuousBatcher(fused_verify=
        #: service.fused_verify, autotune_table=service.autotune_table)``;
        #: None keeps the committed table (ops/autotune_paged.json)
        self.fused_verify = bool(config.get("instance.serving.fused_verify", False))
        self.autotune_table = config.get("instance.serving.autotune.table", None)
        cache_dtype = str(config.get("instance.serving.cache_dtype", "bf16"))
        if cache_dtype not in ("bf16", "int8", "fp8"):
            raise ValueError(
                f"instance.serving.cache_dtype must be one of "
                f"bf16/int8/fp8, got {cache_dtype!r}"
            )
        self.cache_dtype = cache_dtype
        self.fused_wave = bool(config.get("instance.serving.fused_wave", False))

        #: batched native ingest (an IngestConfig, or None when off)
        self.ingest = ingest_from_config(config)

        #: the request-level SLO engine: a flight-recorder listener; the
        #: metrics server gains GET /slo and /healthz the ``slo`` check
        from beholder_tpu_torch.obs.slo import slo_from_config

        self.slo = slo_from_config(config, registry=self.metrics.registry)
        if self.slo is not None and self.flight_recorder is not None:
            self.flight_recorder.add_listener(self.slo.on_event)

        #: tail-based trace retention and the online regression sentinel,
        #: both recorder listeners. The order matters: the SLO tracker folds
        #: first (the vault probes its live digests for the p99-tail keep),
        #: then the vault, then the sentinel (which opens incidents on it)
        from beholder_tpu_torch.obs import retention_from_config, sentinel_from_config

        self.trace_vault = retention_from_config(
            config, slo=self.slo, registry=self.metrics.registry
        )
        if self.trace_vault is not None:
            if self.flight_recorder is not None:
                self.flight_recorder.add_listener(self.trace_vault.on_event)
            if self.slo is not None:
                # worst_request blocks gain trace_ref joins
                self.slo.link_vault(self.trace_vault)
            # histogram exemplars gain trace_ref joins (module-global:
            # histograms predate the vault; close() removes it again)
            from beholder_tpu_torch.metrics import set_exemplar_resolver

            set_exemplar_resolver(self.trace_vault.trace_ref)
            if self.flight_plane is not None:
                # incident-kept traces assemble from the merged plane
                self.trace_vault.link_flight_plane(self.flight_plane)
        self.sentinel = sentinel_from_config(
            config, slo=self.slo, vault=self.trace_vault, registry=self.metrics.registry
        )
        if self.sentinel is not None and self.flight_recorder is not None:
            self.flight_recorder.add_listener(self.sentinel.on_event)

        from beholder_tpu_torch.cluster import cluster_from_config

        self.cluster = cluster_from_config(config)
        if self.cluster is not None and self.cluster.group is not None and self.spec is not None:
            raise ValueError(
                "instance.cluster.group and instance.spec are mutually "
                "exclusive: speculative decoding is a single-device "
                "lane (GroupBatcher rejects spec) — disable one"
            )
        #: set by whatever embeds a live ClusterScheduler next to the
        #: consumers; /healthz's ``cluster`` check reads it at probe time
        self.cluster_scheduler = None

        #: the SLO-acting control plane (host side: it reads the tracker);
        #: the metrics server gains GET /control
        from beholder_tpu_torch.control import control_from_config

        self.control = control_from_config(config)
        self.control_plane = None
        if self.control is not None:
            from beholder_tpu_torch.control.policy import ControlPlane

            self.control_plane = ControlPlane(
                self.control,
                tracker=self.slo,
                registry=self.metrics.registry,
                flight_recorder=self.flight_recorder,
            )
        #: the periodic autoscaler clock, started by
        #: :meth:`start_scaling_evaluator`, stopped in :meth:`close`
        self.scaling_evaluator = None

        if self.flight_plane is not None:
            # trace context on every egress call, outermost on the transport
            # chain (above caching: a cache hit has no wire request to
            # stamp); off, no wrapper exists and outbound bytes are unchanged
            from beholder_tpu_torch.clients.http import RequestsTransport, TracingTransport

            transport = TracingTransport(transport or RequestsTransport())

        deadline_s = float(config.get("instance.http.deadline_s", 10.0))
        self.trello = TrelloClient(
            config.get("keys.trello.key", ""),
            config.get("keys.trello.token", ""),
            transport=transport,
            deadline_s=deadline_s,
        )
        self.telegram = TelegramClient(
            config.get("keys.telegram.token", ""),
            transport=transport,
            deadline_s=deadline_s,
        )
        self.emby = EmbyClient(
            config.get("instance.emby.host", ""),
            config.get("keys.emby.token", ""),
            transport=transport,
            deadline_s=deadline_s,
        )

        #: status-name (lowercase) -> Trello list id; config is load-once,
        #: so it is resolved to plain values here
        flow = config.get("instance.flow_ids") or ConfigNode({})
        self.flow_ids = flow.to_dict() if isinstance(flow, ConfigNode) else dict(flow)
        self._telegram_enabled = bool(config.get("instance.telegram.enabled"))
        self._telegram_channel = config.get("instance.telegram.channel")
        self._emby_enabled = bool(
            config.get("keys.emby.token") and config.get("instance.emby.enabled")
        )
        self._emby_host = config.get("instance.emby.host")
        self._progress_counters = {}  # status text -> bound counter child
        self._status_names = {}  # status int -> enum name

        from beholder_tpu_torch.tracing import tracer_from_config

        self.tracer = tracer_from_config(config, logger=self.logger)

        #: batch analytics on the card
        self.analytics = None
        if config.get("instance.analytics.enabled"):
            from beholder_tpu_torch.analytics import AnalyticsSink

            self.analytics = AnalyticsSink(
                flush_every=int(config.get("instance.analytics.flush_every", 4096)),
                logger=self.logger,
                async_flush=True,  # device work must not stall the consumer
                device=device,
            )

        #: set by init() when instance.health.enabled (see health.py)
        self.health = None

        self._status_proto = proto.load("api.TelemetryStatus")
        self._progress_proto = proto.load("api.TelemetryProgress")
        self._deployed_status = proto.string_to_enum(
            self._status_proto, "TelemetryStatusEntry", "DEPLOYED"
        )
        self._creator_trello = proto.string_to_enum(proto.Media, "CreatorType", "TRELLO")

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> None:
        """Register both consumers and log 'initialized'."""
        if self.ingest is not None:
            # arm the broker's batched ingest path BEFORE connect (the
            # per-connection batch feed is built at handshake time);
            # brokers without the surface (InMemoryBroker) stay on the
            # per-message path with identical semantics
            configure = getattr(self.broker, "configure_ingest", None)
            if configure is not None:
                configure(
                    self.ingest,
                    registry=self.metrics.registry,
                    flight_recorder=self.flight_recorder,
                )
        self.broker.connect()
        status, progress = self.handle_status, self.handle_progress
        if self.handle_seconds is not None:
            # timing INSIDE tracing: observations carry the consumer span's
            # trace id
            status = self._timed(STATUS_TOPIC, status)
            progress = self._timed(PROGRESS_TOPIC, progress)
        if self.tracer is not None:
            status = self._traced("telemetry.status", status)
            progress = self._traced("telemetry.progress", progress)
        if self._at_least_once:
            # OUTERMOST wrapper: it owns settlement on failure (nack for
            # redelivery, park to the DLQ at the attempt cap, dedup acks
            # on redelivered already-done messages)
            from beholder_tpu_torch.reliability import ReliableConsumer

            status, progress = (
                ReliableConsumer(
                    self.broker,
                    topic,
                    handler,
                    max_attempts=self._consumer_max_attempts,
                    dedup_window=self._consumer_dedup_window,
                    metrics=self.reliability,
                    logger=self.logger,
                )
                for topic, handler in ((STATUS_TOPIC, status), (PROGRESS_TOPIC, progress))
            )
            self.reliable_consumers = {STATUS_TOPIC: status, PROGRESS_TOPIC: progress}
        if self.ingest is not None:
            self.broker.listen_batch(STATUS_TOPIC, status, self.prepare_status_batch)
            self.broker.listen_batch(PROGRESS_TOPIC, progress, self.prepare_progress_batch)
        else:
            self.broker.listen(STATUS_TOPIC, status)
            self.broker.listen(PROGRESS_TOPIC, progress)
        self.logger.info("initialized")

    def _timed(self, topic: str, handler):
        """Observe per-message handle wall time into
        ``beholder_message_handle_seconds{topic, outcome}``; an escaping
        exception counts as ``outcome="error"`` and still propagates."""
        hist = self.handle_seconds

        def timed_handler(delivery: Delivery) -> None:
            t0 = time.perf_counter()
            try:
                handler(delivery)
            except Exception:
                hist.observe(time.perf_counter() - t0, topic=topic, outcome="error")
                raise
            hist.observe(time.perf_counter() - t0, topic=topic, outcome="ok")

        return timed_handler

    def _traced(self, operation: str, handler):
        """Run ``handler`` inside a consumer span; joins the producer's
        trace when the delivery carries an uber-trace-id header."""
        from beholder_tpu_torch.tracing import extract

        tracer = self.tracer

        def traced_handler(delivery: Delivery) -> None:
            parent = extract(delivery.headers)
            with tracer.start_span(
                operation,
                child_of=parent,
                tags={"topic": delivery.topic, "redelivered": delivery.redelivered},
            ):
                handler(delivery)

        return traced_handler

    def start_scaling_evaluator(self):
        """Start the periodic autoscaler evaluator thread, if armed: call
        after attaching ``cluster_scheduler``. Returns the running
        :class:`~beholder_tpu_torch.control.evaluator.ScalingEvaluator`,
        or None when the control plane, the autoscaler, its
        ``evaluator_interval_s`` or the scheduler is missing."""
        if self.scaling_evaluator is not None:
            return self.scaling_evaluator
        cfg = getattr(self.control, "autoscale", None)
        if (
            self.control_plane is None
            or cfg is None
            or cfg.evaluator_interval_s is None
            or self.cluster_scheduler is None
        ):
            return None
        from beholder_tpu_torch.control.evaluator import ScalingEvaluator

        self.scaling_evaluator = ScalingEvaluator(
            self.control_plane,
            self.cluster_scheduler,
            cfg.evaluator_interval_s,
            logger=self.logger,
        ).start()
        return self.scaling_evaluator

    def close(self) -> None:
        """Graceful teardown: stop consuming, drain analytics, flush the
        observability tail (open spans, raw observations, the flight-
        recorder ring, the merged flight plane, the trace vault), close."""
        self.logger.info("shutting down")
        if self.scaling_evaluator is not None:
            try:
                self.scaling_evaluator.stop()
            except Exception:  # noqa: BLE001 - best effort on the way out
                pass
        self.broker.close()
        # graceful cluster drain (SIGTERM routes here): stop admitting and
        # serve what is queued, so a decommission loses nothing
        if (
            self.cluster_scheduler is not None
            and self.cluster is not None
            and self.cluster.failover is not None
            and self.cluster.failover.drain_on_sigterm
        ):
            try:
                self.cluster_scheduler.shutdown(drain=True)
            except Exception as err:  # noqa: BLE001 - best effort on the way out
                self.logger.warning(f"cluster drain at shutdown failed: {err!r}")
        if self.analytics is not None:
            try:
                self.analytics.flush()
                self.analytics.drain()
            except Exception:  # noqa: BLE001 - best effort on the way out
                pass
        if self.health is not None:
            self.health.close()
        if self.tracer is not None:
            try:
                flushed = self.tracer.flush()
                if flushed:
                    self.logger.info("flushed %d open trace span(s) at shutdown", flushed)
            except Exception:  # noqa: BLE001
                pass
        from beholder_tpu_torch.metrics import flush_observation_log

        flush_observation_log()
        if self.flight_recorder is not None and self.flight_recorder.export_path:
            try:
                self.flight_recorder.dump()
            except Exception:  # noqa: BLE001
                pass
        if self.flight_plane is not None and self.flight_plane.export_path:
            # the merged cluster timeline dumps beside the raw ring
            try:
                self.flight_plane.dump()
            except Exception:  # noqa: BLE001
                pass
        if self.trace_vault is not None:
            if self.trace_vault.config.export_path:
                # shift-rotating any previous generation
                try:
                    self.trace_vault.dump()
                except Exception:  # noqa: BLE001
                    pass
            # the exemplar join is module-global: remove it, so a later
            # vault-less service renders exemplars without it
            from beholder_tpu_torch.metrics import set_exemplar_resolver

            set_exemplar_resolver(None)
        self.metrics.close()
        self.db.close()

    # -- helpers -----------------------------------------------------------
    def comment(self, card_id: str, text: str) -> None:
        """Comment on a Trello card + count it."""
        self.logger.info("creating comment on %s with text: %s", card_id, text)
        self.trello.comment_card(card_id, text)
        self.metrics.trello_comments_total.inc()

    def _status_text(self, status: int) -> str:
        text = self._status_names.get(status)
        if text is None:
            text = self._status_names[status] = proto.enum_to_string(
                self._status_proto, "TelemetryStatusEntry", status
            )
        return text

    # -- batched ingest prepare stages -------------------------------------
    def prepare_status_batch(self, deliveries: list[Delivery]) -> None:
        """Batched-ingest prepare for ``v1.telemetry.status``: one
        protobuf decode pass and ONE storage transaction for the whole
        drained run (``update_status_batch``), stashing per-delivery
        results on ``delivery.prepared`` for :meth:`handle_status` —
        which still runs per message under its usual wrappers, so acks,
        redelivery, tracing and error outcomes are unchanged.

        In at-least-once mode the fold STOPS at the first redelivered
        message: the ReliableConsumer's dedup window may skip its handler
        entirely (the prepare must not run side effects the handler
        won't), and folding LATER same-media writes into a transaction
        that commits BEFORE the redelivered message's own inline write
        would invert the per-message loop's arrival-order outcome — so
        everything from the redelivered message on falls back to the
        per-message path, in order. A message whose decode fails is left
        without a ``msg`` (the handler re-decodes and raises in its OWN
        scope); a wholesale write failure leaves the ``found`` flags off
        and every handler re-runs its update inline."""
        rows: dict[str, proto.Media] = {}
        pending: list[tuple[dict, str, int]] = []
        for delivery in deliveries:
            if self._at_least_once and delivery.redelivered:
                break
            prepared: dict = {"rows": rows}
            delivery.prepared = prepared
            try:
                msg = proto.decode(self._status_proto, delivery.body)
            except Exception:  # noqa: BLE001 - re-raised by the handler
                continue
            prepared["msg"] = msg
            pending.append((prepared, msg.mediaId, msg.status))
        if not pending or not self.ingest.batch_storage:
            return
        try:
            found = self.db.update_status_batch(
                [(media_id, status) for _, media_id, status in pending]
            )
        except Exception as err:  # noqa: BLE001 - degrade to inline writes
            self.logger.warning(
                f"batched status write failed ({err!r}); "
                "falling back to per-message updates"
            )
            return
        for (prepared, _, _), ok in zip(pending, found):
            prepared["found"] = ok
        # prefetch the post-write rows in ONE query (the handlers'
        # read-after-own-write; _read_media overrides status per message).
        # Best-effort: a miss here just re-reads inline. NO_TRELLO handlers
        # ack right after the write and never read.
        if no_trello():
            return
        try:
            rows.update(self.db.get_by_ids([p[1] for p, ok in zip(pending, found) if ok]))
        except Exception:  # noqa: BLE001
            pass

    def prepare_progress_batch(self, deliveries: list[Delivery]) -> None:
        """Batched-ingest prepare for ``v1.telemetry.progress``: one
        decode pass plus a shared per-run row-read memo (the progress
        handler only reads media rows — one read per distinct id per run
        instead of per message). Redelivered messages are skipped in
        at-least-once mode: the dedup window decides whether they run."""
        rows: dict[str, proto.Media] = {}
        media_ids: list[str] = []
        for delivery in deliveries:
            if self._at_least_once and delivery.redelivered:
                continue
            prepared: dict = {"rows": rows}
            delivery.prepared = prepared
            try:
                msg = proto.decode(self._progress_proto, delivery.body)
            except Exception:  # noqa: BLE001 - re-raised by the handler
                continue
            prepared["msg"] = msg
            media_ids.append(msg.mediaId)
        # one read round trip for the whole run; a missing id keeps its
        # MediaNotFound outcome (the handler's fallback read raises)
        if media_ids:
            try:
                rows.update(self.db.get_by_ids(media_ids))
            except Exception:  # noqa: BLE001 - handlers re-read inline
                pass

    def _read_media(
        self, prepared: dict | None, media_id: str, status: int | None = None
    ) -> proto.Media:
        """Row read, batch-aware: on the per-message path it is exactly
        ``db.get_by_id``; on the batched path the run's shared memo
        serves one read per distinct id. ``status`` overrides the
        returned row's status with THIS message's own just-written value
        — precisely what the per-message read-after-own-write observes,
        also when a later message in the batch already moved the row on."""
        if prepared is None:
            return self.db.get_by_id(media_id)
        rows = prepared["rows"]
        media = rows.get(media_id)
        if media is None:
            media = rows[media_id] = self.db.get_by_id(media_id)
        clone = proto.Media()
        clone.CopyFrom(media)
        if status is not None:
            clone.status = status
        return clone

    # -- consumers ---------------------------------------------------------
    def handle_status(self, delivery: Delivery) -> None:
        """v1.telemetry.status."""
        prepared = delivery.prepared
        if prepared is not None and "msg" in prepared:
            msg = prepared["msg"]
        else:
            msg = proto.decode(self._status_proto, delivery.body)
        media_id, status = msg.mediaId, msg.status

        self.logger.info(
            "processing status update for media %s, status: %s", media_id, status
        )
        found = prepared.get("found") if prepared is not None else None
        if found is None:
            self.db.update_status(media_id, status)
        elif not found:
            raise MediaNotFound(media_id)

        if no_trello():
            return delivery.ack()

        status_text = self._status_text(status)
        media = self._read_media(prepared, media_id, status)

        # Trello card movement
        if media.creator == 1:
            list_pointer = self.flow_ids.get(status_text.lower())
            if list_pointer:
                self.logger.info(
                    "moving media card %s (card id %s)", media_id, media.creatorId
                )
                self.trello.move_card(media.creatorId, list_pointer, pos=2)
            else:
                self.logger.warning(
                    f"unable to find list for status {status} ({status_text}) "
                    f"avail ([{','.join(self.flow_ids)}])"
                )

        # deployed hooks — failures swallowed
        try:
            if media.status == self._deployed_status:
                if self._telegram_enabled:
                    self.logger.info(
                        "informing telegram that media '%s' is available", media_id
                    )
                    self.telegram.notify_deployed(
                        self._telegram_channel, media.name, media.metadataId
                    )

                if self._emby_enabled:
                    self.logger.info("telling emby to refresh at %s", self._emby_host)
                    self.emby.refresh_library()
        except Exception as err:  # noqa: BLE001 - the reference swallows hook errors
            self.logger.warning(f"failed to run deployed hooks: {err}")

        delivery.ack()

    def handle_progress(self, delivery: Delivery) -> None:
        """v1.telemetry.progress."""
        try:
            prepared = delivery.prepared
            if prepared is not None and "msg" in prepared:
                msg = prepared["msg"]
            else:
                msg = proto.decode(self._progress_proto, delivery.body)
            media_id, status = msg.mediaId, msg.status
            progress, host = msg.progress, msg.host

            self.logger.info(
                "processing progress update on media %s status %s percent %s",
                media_id,
                status,
                progress,
            )
            status_text = self._status_text(status)

            counter = self._progress_counters.get(status_text)
            if counter is None:
                counter = self.metrics.progress_updates_total.labels(
                    status=status_text.lower()
                )
                self._progress_counters[status_text] = counter
            counter.inc()

            if self.analytics is not None:
                try:
                    self.analytics.record(status, progress)
                except Exception as err:  # noqa: BLE001
                    # the extension must never break the parity path: on any
                    # sink failure, disable analytics and keep consuming
                    self.logger.warning(
                        f"analytics sink failed ({err!r}); disabling analytics"
                    )
                    self.analytics = None

            media = self._read_media(prepared, media_id)

            if media.creator == self._creator_trello:
                comment_text = f"{status_text}: Progress **{progress}%**"
                if host:
                    comment_text += f" (_{host}_)"
                self.comment(media.creatorId, comment_text)
        except Exception as err:  # noqa: BLE001 - the reference warns and acks
            if self._at_least_once:
                # the error propagates to the ReliableConsumer, which nacks
                # for redelivery or parks the message: ack-on-error would
                # LOSE it
                raise
            self.logger.warning(f"failed to update media progress {err}")
            return delivery.ack()

        return delivery.ack()


def init(
    config: ConfigNode | None = None,
    broker: Broker | None = None,
    db: Storage | None = None,
    metrics_port: int | None = None,
    *,
    device=None,
) -> BeholderService:
    """Bootstrap: config, the /metrics server, storage, the broker, the
    consumers, the operator routes and the health server. ``device`` goes
    to :class:`BeholderService`."""
    config = config or Config.load("events")

    metrics = Metrics()
    #: the cache subsystem's /metrics memoization (ETag + max-age: a scrape
    #: storm renders the exposition once per window)
    max_age = (
        config.get("instance.cache.httpd.metrics_max_age_s")
        if config.get("instance.cache.enabled")
        else None
    )
    metrics.expose(metrics_port, cache_max_age_s=float(max_age) if max_age else None)

    service = None
    own_db = db is None
    own_broker = broker is None
    try:
        if db is None:
            target = os.environ.get("BEHOLDER_DB", "beholder.db")
            if target.startswith(("postgres://", "postgresql://")):
                db = PostgresStorage(target)
            else:
                db = SqliteStorage(target)

        if broker is None:
            from beholder_tpu_torch.mq.amqp import AmqpBroker

            broker = AmqpBroker(dyn("rabbitmq"), prefetch=PREFETCH)

        service = BeholderService(config, broker, db, metrics=metrics, device=device)
        service.start()

        #: operator endpoints riding the metrics server, each gated on its
        #: knob, so the default server stays /metrics-only
        if service.slo is not None:
            metrics.add_route("/slo", service.slo.route())
        if service.control_plane is not None:
            metrics.add_route("/control", service.control_plane.http_route())
        if service.flight_recorder is not None:
            metrics.add_route("/debug/flight", service.flight_recorder.route())
        if service.flight_plane is not None:
            # the live skew-aligned merged timeline, with /debug/flight's
            # ?since=/limit poll cursor
            metrics.add_route("/debug/cluster-flight", service.flight_plane.route())
        if service.trace_vault is not None:
            # the vault's index, and one kept trace as Perfetto JSON (a
            # prefix route: the trailing "/" key and wants_path)
            metrics.add_route("/debug/traces", service.trace_vault.index_route())
            metrics.add_route("/debug/traces/", service.trace_vault.trace_route())
        if service.sentinel is not None:
            # the live regression verdict and the ranking behind it
            metrics.add_route("/debug/sentinel", service.sentinel.route())

        from beholder_tpu_torch.health import health_from_config

        service.health = health_from_config(config, service)
    except Exception:
        # a failed boot must release everything it acquired (metrics port,
        # broker threads, db handles), or a supervised restart would hit
        # Address-already-in-use / fd exhaustion forever
        if service is not None:
            try:
                service.close()
            except Exception:  # noqa: BLE001
                pass
        else:
            metrics.close()
            for resource, owned in ((broker, own_broker), (db, own_db)):
                if owned and resource is not None:
                    try:
                        resource.close()
                    except Exception:  # noqa: BLE001
                        pass
        raise
    return service


def main() -> None:  # pragma: no cover - process entrypoint
    """Run the service until SIGTERM or SIGINT. ``$BEHOLDER_SUPERVISE``
    wraps it in the crash-restart :class:`~beholder_tpu_torch.health.
    Supervisor`."""
    import signal
    import threading

    supervised = bool(os.environ.get("BEHOLDER_SUPERVISE"))
    stop = threading.Event()
    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, lambda *_: stop.set())

    if supervised:
        from beholder_tpu_torch.health import Supervisor

        supervisor = Supervisor(
            init,
            liveness=lambda svc: getattr(svc.broker, "connected", True),
            liveness_grace_s=float(os.environ.get("BEHOLDER_LIVENESS_GRACE", 60)),
        )
        supervisor.start()
        stop.wait()
        supervisor.stop()
        return

    service = init()
    stop.wait()
    service.close()


if __name__ == "__main__":  # pragma: no cover
    main()
