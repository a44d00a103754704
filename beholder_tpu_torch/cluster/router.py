"""The cluster scheduler: the batcher promoted to an admission router.

One :class:`ClusterScheduler` owns N decode shards (each a
:class:`~beholder_tpu_torch.models.serving.ContinuousBatcher` over its own
paged pool on its own device) and, optionally, M prefill workers
(:class:`~beholder_tpu_torch.cluster.transfer.PrefillWorker`). Its API is
the batcher's own, ``run(requests)`` or ``submit(request)`` then
``run_pending()``, and under exact greedy its streams are the single
batcher's bits.

- **Routing** (:meth:`ClusterScheduler._route`): by pool pressure (most
  free worst-case pages, ties to the lowest id) or round robin. Every
  decision lands on ``beholder_cluster_routes_total{reason}`` and as a
  recorder-only ``route`` event.
- **Serving**: every shard runs the batcher's own loop: colocated shards
  through their ``run()`` / ``run_spec()``, disaggregated ones through
  ``ContinuousBatcher._run`` with its admission round replaced.
- **Disaggregation** (:meth:`ClusterScheduler._run_disaggregated`):
  claimed requests prefill on a prefill worker, the kv hands off page by
  page to the owning shard (:meth:`ClusterScheduler._handoff_admit`), and
  the decode loop ticks on the shard's own pool. Shards with a prefix
  cache or a spec config serve colocated.
- **Rebalance** (:meth:`ClusterScheduler._rebalance`): at drain time,
  queued requests that no longer fit their shard move to the
  least-pressure shard (``reason="rebalance"``).
- **Memory fabric** (``ClusterConfig.fabric``,
  :mod:`beholder_tpu_torch.cluster.fabric`): a prefix cached on one shard
  admits as a hit on another after a verbatim page fetch; a dark standby
  mirrors the cached pages between serves and is promoted when a worker
  dies.
- **Decode groups** (``ClusterConfig.group``,
  :mod:`beholder_tpu_torch.cluster.group`): each decode shard is a
  :class:`~beholder_tpu_torch.cluster.group.engine.GroupBatcher` over a
  contiguous block of ``group.size`` devices, named ``decode-g<id>``;
  prefill workers and a fabric standby stay single-device, placed after the
  blocks.
- **Control plane** (``control_plane=``, a
  :class:`~beholder_tpu_torch.control.policy.ControlPlane`): each shard's
  intake is the plane's tenant-fair queue (a preempted request resolves to
  a ``Preempted`` outcome in its admission-order slot), spec shards shed
  draft length under burn, routing consults the plane's tail and deadline
  policy (``control_tail_avoid`` / ``control_deadline`` routes), and
  ``run_pending`` evaluates the autoscaler between serves. Without one,
  routing, intakes and the shard count are exactly the plain cluster's.

The scheduler is single-controller: one process drives every worker, each
worker's tensors live on its device, and a tensor moves with
``Tensor.to``. Shards on one device share one model; a shard on another
device gets its own copy of the weights (``nn.Module.to`` moves a module
in place, so one module cannot serve two devices).

Instruments are host-side only (no device reads): cluster series register
only when a registry is wired, ``route``/``transfer``/``prefill`` are
recorder-only events, and per-shard shed attribution rides each shard's
uniquely named intake (``beholder_intake_shed_total{queue, reason}``).
"""

from __future__ import annotations

import copy
import functools
import time

import numpy as np
import torch

from . import ROUTE_ROUND_ROBIN, ClusterConfig
from .failover import WORKER_UP, FailoverEngine, NoHealthyShards
from .pool import ShardedPoolView, ShardPool
from .transfer import PageTransferEngine, PrefillWorker


class _Shard:
    """One decode shard: pool view, batcher and bounded intake."""

    def __init__(self, pool: ShardPool, batcher, intake):
        self.pool = pool
        self.batcher = batcher
        self.intake = intake
        #: the colocated prefill fallback, built when every prefill worker
        #: is down (failover)
        self.local_prefill = None


class ClusterScheduler:
    """Cluster-level serving over sharded paged pools.

    ``model`` is a :class:`~beholder_tpu_torch.models.TelemetrySequenceModel`
    holding the weights. ``batcher_kwargs`` are the per-shard
    :class:`~beholder_tpu_torch.models.serving.ContinuousBatcher` knobs
    (``num_pages``, per shard, ``page_size``, ``slots``, ``max_prefix``,
    ``max_pages_per_seq``, ``cache_dtype``, ``fused_verify``, ...).
    ``prefix_cache_factory`` builds one
    :class:`~beholder_tpu_torch.cache.PrefixCache` per shard (page ids are
    shard-local); ``spec`` is a shared
    :class:`~beholder_tpu_torch.spec.SpecConfig`. ``devices`` is what
    :func:`~beholder_tpu_torch.parallel.mesh.serving_shard_devices` cycles
    over: ``None`` means every visible card (and raises without one), and
    ``["cpu"]`` runs the plain PyTorch path."""

    def __init__(
        self,
        model,
        cluster: ClusterConfig,
        *,
        metrics=None,
        tracer=None,
        flight_recorder=None,
        prefix_cache_factory=None,
        spec=None,
        control_plane=None,
        devices=None,
        **batcher_kwargs,
    ):
        from beholder_tpu_torch.parallel.mesh import serving_shard_devices
        from beholder_tpu_torch.reliability.policy import RetryPolicy

        self.cluster = cluster
        self.model = model
        self.flight_recorder = flight_recorder
        self._metrics = metrics
        self._tracer = tracer
        self._prefix_cache_factory = prefix_cache_factory
        self._spec = spec
        self._devices = devices
        self._batcher_kwargs = dict(batcher_kwargs)
        #: the SLO-acting control plane (None: the plain cluster)
        self.control_plane = control_plane
        #: the model per device: shards on one device share it
        self._models: dict[str, object] = {}
        self._registry = getattr(metrics, "registry", metrics) if metrics is not None else None
        self.instruments = None
        if self._registry is not None:
            from .instruments import ClusterMetrics

            self.instruments = ClusterMetrics(self._registry)
            self.instruments.shards.set(cluster.n_decode_workers)

        n_workers = cluster.n_decode_workers + cluster.n_prefill_workers
        if cluster.group is not None:
            # each decode shard owns a contiguous block of group.size
            # devices; prefill workers stay single-device, continuing the
            # cycle after the blocks
            gsz = cluster.group.size
            decode_devices = serving_shard_devices(
                cluster.n_decode_workers, group_size=gsz, devices=devices
            )
            singles = serving_shard_devices(
                cluster.n_decode_workers * gsz + cluster.n_prefill_workers, devices=devices
            )
            prefill_devices = singles[cluster.n_decode_workers * gsz:]
            #: blocks handed out so far; scale_up() continues the block cycle
            self._devices_used = cluster.n_decode_workers
        else:
            placed = serving_shard_devices(n_workers, devices=devices)
            decode_devices = placed[: cluster.n_decode_workers]
            prefill_devices = placed[cluster.n_decode_workers:]
            #: devices handed out so far; scale_up() continues the cycle
            self._devices_used = n_workers

        self.shards: list[_Shard] = [
            self._build_shard(i, decode_devices[i]) for i in range(cluster.n_decode_workers)
        ]
        self.pool_view = ShardedPoolView([s.pool for s in self.shards])
        self.prefill_workers: list[PrefillWorker] = [
            PrefillWorker(
                self._model_on(prefill_devices[j]),
                self.shards[0].batcher.page_size,
                device=prefill_devices[j],
                name=f"prefill-{j}",
                head_rows=self.shards[0].batcher.slots,
            )
            for j in range(cluster.n_prefill_workers)
        ]
        # every hop is retried: transient faults are absorbed, persistent
        # ones surface as a typed TransferFailed
        self.transfer = PageTransferEngine(
            instruments=self.instruments,
            flight_recorder=flight_recorder,
            retry=RetryPolicy(max_attempts=3, base_delay_s=0.005, max_delay_s=0.05),
        )
        #: fault tolerance (None: the fail-stop cluster)
        self.failover = (
            FailoverEngine(self, cluster.failover, registry=self._registry,
                           flight_recorder=flight_recorder)
            if cluster.failover is not None
            else None
        )
        #: the memory fabric (None: private prefix caches, failover replays):
        #: the global prefix index and the standby mirror, over the transfer
        #: engine
        self.fabric = None
        if cluster.fabric is not None:
            from .fabric.engine import FabricEngine

            self.fabric = FabricEngine(cluster.fabric, self.transfer,
                                       flight_recorder=flight_recorder)
            for shard in self.shards:
                self.fabric.attach_shard(shard)
        #: admission-order results decided outside a serve (drain-time
        #: shard_down drops), merged by run_pending
        self._pending_drops: dict[int, object] = {}
        self._rr = 0
        self._pf_rr = 0
        #: monotone submit sequence: the admission-order key
        self._seq = 0
        #: one timeline epoch per _serve_pairs call, so request gids never
        #: recur across calls but stay put across a call's recovery passes
        self._gid_epoch = 0

    # -- shard construction / scaling ------------------------------------

    def _model_on(self, device) -> object:
        """The model on ``device``: the caller's module for the first
        device (moved there, as a batcher would move it), a copy for every
        other device."""
        key = str(torch.device(device))
        model = self._models.get(key)
        if model is None:
            model = self.model if not self._models else copy.deepcopy(self.model)
            model = model.to(device)
            self._models[key] = model
        return model

    def _build_shard(self, shard_id: int, device, name: str | None = None) -> _Shard:
        """One decode shard exactly as ``__init__`` builds them; also
        :meth:`scale_up`'s path, so a spawned shard is indistinguishable
        from a boot-time one. ``device`` a tuple builds a decode group
        (``decode-g<id>``, its pool's device member 0); ``name`` overrides
        the pool name (the fabric's standby lives outside the decode ids
        until promotion)."""
        from beholder_tpu_torch.models.serving import ContinuousBatcher
        from beholder_tpu_torch.reliability.shed import IntakeQueue

        shared = dict(
            metrics=self._metrics,
            tracer=self._tracer,
            flight_recorder=self.flight_recorder,
            prefix_cache=(
                self._prefix_cache_factory() if self._prefix_cache_factory is not None else None
            ),
            spec=self._spec,
            **self._batcher_kwargs,
        )
        if isinstance(device, tuple):
            from .group.engine import GroupBatcher

            name = name if name is not None else f"decode-g{shard_id}"
            batcher = GroupBatcher(self._model_on(device[0]), devices=device,
                                   axis=self.cluster.group.axis, name=name, **shared)
        else:
            batcher = ContinuousBatcher(self._model_on(device), device=device, **shared)
        pool = ShardPool(shard_id, batcher.num_pages, device=batcher.transfer_device)
        if name is not None:
            pool.name = name
        # the router owns the shard intakes: queued items are (submit
        # sequence, request) pairs, so run_pending() hands results back in
        # admission order across the cluster
        intake_kwargs = dict(
            max_cost=(
                self.cluster.max_pending_pages_per_shard
                if self.cluster.max_pending_pages_per_shard is not None
                else batcher.num_pages
            ),
            cost_fn=lambda item, b=batcher: b._need_pages(item[1]),
            metrics=self._registry,
            name=f"cluster.{pool.name}",
            labelled_sheds=True,
        )
        if self.control_plane is not None:
            # tenant-fair admission: the intake drains in weighted DRR order
            # and preempts over-share tenants under pressure
            batcher.intake = self.control_plane.intake(
                self.cluster.max_pending_per_shard,
                on_preempt=self._make_on_preempt(pool), **intake_kwargs,
            )
            if self._spec is not None:
                self.control_plane.attach_spec(batcher)
        else:
            batcher.intake = IntakeQueue(self.cluster.max_pending_per_shard, **intake_kwargs)
        return _Shard(pool, batcher, batcher.intake)

    def _make_on_preempt(self, pool):
        """Preemption for one shard's tenant-fair intake: release the
        submit-time reservation, park a ``Preempted`` outcome in the
        request's admission-order slot, and emit ``req.dropped`` carrying
        the tenant (the request never claimed, so the SLO tracker has no
        open entry to read it from)."""

        def on_preempt(item, tenant):
            from beholder_tpu_torch.control.admission import Preempted

            seq, request = item
            pool.release(self._need(request))
            self._pending_drops[seq] = Preempted(tenant)
            if self.flight_recorder is not None:
                tenant_note = {"tenant": tenant} if tenant is not None else {}
                self.flight_recorder.instant("req.dropped", gid=f"s{seq}",
                                             reason="tenant_preempted", **tenant_note)

        return on_preempt

    def scale_up(self) -> _Shard:
        """Spawn one decode shard on the next device in the cycle, routable
        at once. The inverse is :meth:`drain`."""
        from beholder_tpu_torch.parallel.mesh import serving_shard_devices

        # a group shard claims the next contiguous block, as at boot
        gsz = self.cluster.group.size if self.cluster.group is not None else 1
        device = serving_shard_devices(self._devices_used + 1, group_size=gsz,
                                       devices=self._devices)[-1]
        self._devices_used += 1
        shard = self._build_shard(len(self.shards), device)
        self.shards.append(shard)
        self.pool_view.shards.append(shard.pool)
        if self.failover is not None:
            self.failover._set_state(shard.pool.name, WORKER_UP)
        if self.fabric is not None:
            self.fabric.attach_shard(shard)
        if self.instruments is not None:
            self.instruments.shards.set(sum(
                1 for s in self.shards
                if self.failover is None
                or self.failover.state(s.pool.name) not in ("down", "drained")
            ))
        self.pool_view.refresh_gauges(self.instruments)
        return shard

    # -- introspection ---------------------------------------------------

    def health_snapshot(self) -> dict:
        """Per-worker health: every decode shard's state and pool pressure,
        every prefill worker's state, and the down / draining / drained
        rollups. Without failover every worker reports up."""
        fo = self.failover
        workers: dict[str, dict] = {}
        for shard in self.shards:
            workers[shard.pool.name] = {
                "state": fo.state(shard.pool.name) if fo else WORKER_UP,
                "free_pages": shard.pool.free,
                "committed_pages": shard.pool.committed,
            }
        for worker in self.prefill_workers:
            workers[worker.name] = {"state": fo.state(worker.name) if fo else WORKER_UP}
        return {
            # only failed workers roll up into "down"; a drained shard is a
            # planned decommission
            "workers": workers,
            "down": sorted(n for n, w in workers.items() if w["state"] == "down"),
            "draining": sorted(n for n, w in workers.items() if w["state"] == "draining"),
            "drained": sorted(n for n, w in workers.items() if w["state"] == "drained"),
        }

    def drain(self, shard_id: int) -> dict:
        """Decommission decode shard ``shard_id`` with zero loss (needs
        failover): queued work moves to surviving intakes and the resident
        pool moves byte-identically. See
        :meth:`~beholder_tpu_torch.cluster.failover.FailoverEngine.drain`."""
        if self.failover is None:
            raise RuntimeError(
                "drain requires instance.cluster.failover — the "
                "fail-stop cluster has no migration machinery"
            )
        name = self.shards[shard_id].pool.name
        result = self.failover.drain(shard_id)
        if self.fabric is not None:
            # pins against the drained pool repoint to the migration target;
            # the drained shard leaves the directory
            self.fabric.on_drain(name, result["target"])
        return result

    def shutdown(self, drain: bool = True) -> None:
        """Planned full-cluster shutdown (the service's ``close()`` with
        ``failover.drain_on_sigterm``): every shard stops admitting FIRST
        (``draining`` — a submit racing the shutdown sheds ``shard_down``
        instead of being lost at exit), then queued work is served to
        completion, so a decommission loses nothing. ``drain=False`` skips
        the final serve."""
        fo = self.failover
        if fo is not None:
            from .failover import WORKER_DRAINING

            for shard in self.shards:
                if fo.state(shard.pool.name) == WORKER_UP:
                    fo._set_state(shard.pool.name, WORKER_DRAINING)
        if drain and any(s.intake.depth for s in self.shards):
            if fo is not None:
                # draining shards still SERVE during the final drain
                fo._drain_serving = True
                try:
                    self.run_pending()
                finally:
                    fo._drain_serving = False
            else:
                self.run_pending()

    # -- routing ---------------------------------------------------------

    def _need(self, request) -> int:
        # shards share geometry, so any batcher's arithmetic serves
        return self.shards[0].batcher._need_pages(request)

    @staticmethod
    def _fits(shard: _Shard, need: int) -> bool:
        """Whether a worst-case ``need`` can ever run on this shard."""
        return need <= shard.batcher.num_pages and need <= shard.batcher.max_pages_per_seq

    def _routable(self) -> list[_Shard]:
        """Shards admissions may route to: all of them fail-stop, the up
        subset under failover."""
        if self.failover is None:
            return self.shards
        routable = self.failover.routable_shards()
        if not routable:
            raise NoHealthyShards("every decode shard is down — nothing can serve")
        return routable

    def _record_route(self, shard: _Shard, reason: str, need: int, dur_s: float,
                      ts_s: float) -> None:
        if self.instruments is not None:
            self.instruments.routes_total.inc(reason=reason)
        if self.flight_recorder is not None:
            self.flight_recorder.record("route", ts_s, dur_s, worker=shard.pool.name,
                                        reason=reason, need=int(need))

    def _route(self, need: int, request=None) -> _Shard:
        """Pick the shard for one request of worst-case ``need`` pages and
        record the decision. Under failover only up shards are candidates.
        With a control plane whose routing is armed, placement consults
        :meth:`~beholder_tpu_torch.control.policy.ControlPlane.route_shard`;
        its overrides are counted as ``control_tail_avoid`` /
        ``control_deadline``, and where it only agrees with plain pressure a
        round-robin cluster keeps round-robining."""
        ts = time.time()
        t0 = time.perf_counter()
        candidates = self._routable()
        controlled = None
        if self.control_plane is not None and len(candidates) > 1:
            controlled = self.control_plane.route_shard(candidates, need, request)
            if (
                controlled is not None
                and controlled[1] == "pressure"
                and self.cluster.route_policy == ROUTE_ROUND_ROBIN
            ):
                controlled = None
        if controlled is not None:
            shard, control_reason = controlled
            reason = "pressure" if control_reason == "pressure" else f"control_{control_reason}"
        elif len(candidates) == 1:
            shard, reason = candidates[0], "only_shard"
        elif self.cluster.route_policy == ROUTE_ROUND_ROBIN:
            shard = candidates[self._rr % len(candidates)]
            self._rr += 1
            reason = "round_robin"
        else:
            target = self.pool_view.least_pressure([s.pool for s in candidates])
            shard = self.shards[target.shard_id]
            reason = "pressure"
        self._record_route(shard, reason, need, time.perf_counter() - t0, ts)
        return shard

    def _next_prefill_worker(self) -> PrefillWorker:
        worker = self.prefill_workers[self._pf_rr % len(self.prefill_workers)]
        self._pf_rr += 1
        return worker

    def _prefill_with_failover(self, shard: _Shard, feats_np, t: int):
        """One request's prefill on a healthy prefill worker: a worker that
        dies is marked down and the next survivor takes the request; with
        every prefill worker down the shard prefills on its own device. The
        chunks are the same bits wherever the forward ran. Returns
        ``(worker, (pred, ck, cv, n_pages))``."""
        from .failover import WorkerKilled

        fo = self.failover
        if fo is None:
            worker = self._next_prefill_worker()
            return worker, worker.prefill(feats_np, t)
        while True:
            candidates = fo.up_prefill_workers()
            if not candidates:
                break
            worker = candidates[self._pf_rr % len(candidates)]
            self._pf_rr += 1
            try:
                out = worker.prefill(feats_np, t)
            except WorkerKilled as err:
                fo.mark_down(worker.name, err.kind)
                continue
            fo.heartbeat(worker.name)
            return worker, out
        if shard.local_prefill is None:
            shard.local_prefill = PrefillWorker(
                shard.batcher.model, shard.batcher.page_size,
                device=shard.pool.device, name=shard.pool.name,
                head_rows=shard.batcher.slots,
            )
        return shard.local_prefill, shard.local_prefill.prefill(feats_np, t)

    # -- the batcher-shaped API ------------------------------------------

    def run(self, requests: list) -> list:
        """Serve ``requests`` across the cluster; results are the
        per-request forecast arrays of the single batcher, in the same
        order. Under exact greedy they are the bits of one
        :meth:`~beholder_tpu_torch.models.serving.ContinuousBatcher.run`
        over the same requests, and with failover armed that holds through
        a shard dying mid-stream."""
        out = self._serve_pairs(list(enumerate(requests)))
        return [out[gid] for gid in range(len(requests))]

    def _serve_pairs(self, pairs: list, waits: dict | None = None) -> dict:
        """Route and serve ``(key, request)`` pairs; returns ``{key:
        result}``. Fail-stop this is one pass and exceptions propagate.
        With failover it is the recovery loop: a typed worker failure marks
        the shard down and its batch re-routes to survivors on the next
        pass, where the deterministic replay re-prefills from the request's
        host-side state, and :meth:`FailoverEngine.splice` joins it onto
        anything already delivered. A request recovered more than
        ``max_recoveries_per_request`` times, or one no surviving shard can
        hold, resolves to an explicit ``Dropped`` outcome."""
        from beholder_tpu_torch.reliability.shed import SHED_SHARD_DOWN

        fo = self.failover
        out: dict = {}
        pending = list(pairs)
        attempts: dict = {}
        pass_index = 0
        self._gid_epoch += 1
        gid_of = (
            {key: f"g{self._gid_epoch}-{key}" for key, _ in pairs}
            if self.flight_recorder is not None
            else {}
        )
        while pending:
            if fo is not None:
                fo.sweep()
            t_pass = time.perf_counter()
            assignments: dict[int, list] = {s.pool.shard_id: [] for s in self.shards}
            for key, req in pending:
                need = self._need(req)
                if fo is not None:
                    routable = fo.routable_shards()
                    if (
                        not routable or not any(self._fits(s, need) for s in routable)
                    ) and any(self._fits(s, need) for s in self.shards):
                        # servable on the full cluster, not on what is left:
                        # an explicit outcome. A request no shard could ever
                        # hold falls through to the batcher's own error
                        out[key] = fo.drop(SHED_SHARD_DOWN, key=gid_of.get(key))
                        continue
                shard = self._route(need, request=req)
                shard.pool.reserve(need)
                assignments[shard.pool.shard_id].append((key, req, need))
            pending = []
            self.pool_view.refresh_gauges(self.instruments)
            for shard in self.shards:
                items = assignments.get(shard.pool.shard_id)
                if not items:
                    continue
                if fo is not None:
                    fo.begin_serve(shard.pool.name)
                if self.flight_recorder is not None:
                    # the gid keys this request's claim and retire instants
                    # across shards and recovery passes
                    shard.batcher.annotate_requests({
                        rid: {
                            "gid": gid_of[key],
                            "worker": shard.pool.name,
                            **(
                                {"queue_wait_s": round(waits[key], 6)}
                                if waits and key in waits
                                else {}
                            ),
                        }
                        for rid, (key, _, _) in enumerate(items)
                    })
                try:
                    served = self._serve(shard, [req for _, req, _ in items])
                except Exception as err:
                    if fo is None or not isinstance(err, fo.RECOVERABLE):
                        raise
                    # the shard is gone: release its reservations, mark it
                    # down, re-admit the batch on survivors
                    for _, _, need in items:
                        shard.pool.release(need)
                    kind = fo.on_shard_failure(shard, err)
                    if self.fabric is not None:
                        # release the dead worker's pins, forget it, and
                        # promote a mirroring standby in place of the replay
                        self.fabric.on_worker_down(self, shard.pool.name)
                    retried = 0
                    for key, req, _ in items:
                        attempts[key] = attempts.get(key, 0) + 1
                        if attempts[key] > fo.config.max_recoveries_per_request:
                            out[key] = fo.drop("recovery_limit", key=gid_of.get(key))
                        else:
                            pending.append((key, req))
                            retried += 1
                            if self.flight_recorder is not None:
                                self.flight_recorder.instant(
                                    "req.recovered", gid=gid_of[key],
                                    worker=shard.pool.name, reason=kind,
                                )
                    fo.count_recovered(shard.pool.name, kind, retried)
                    continue
                finally:
                    if fo is not None:
                        fo.end_serve(shard.pool.name)
                # reservations come off first: the serve is done
                for _, _, need in items:
                    shard.pool.release(need)
                if self.fabric is not None:
                    # release this borrower's pins, drop transient borrows
                    self.fabric.finish_serve(shard)
                for (key, _, _), res in zip(items, served):
                    if fo is not None and isinstance(res, np.ndarray):
                        res = fo.splice(key, res)
                    out[key] = res
                if self.instruments is not None:
                    self.instruments.requests_total.inc(len(items), shard=str(shard.pool.shard_id))
            if fo is not None and pass_index > 0:
                fo.recovery_walls.append(time.perf_counter() - t_pass)
            pass_index += 1
        if fo is not None:
            # keys recur across run() calls: terminal outcomes' ledger
            # entries must not survive into the next call
            fo.discard_emitted(list(out))
        if self.fabric is not None:
            # between serves: spawn the standby on first use, refresh its
            # mirror against settled pools
            self.fabric.sync(self)
        self.pool_view.refresh_gauges(self.instruments)
        return out

    def submit(self, request):
        """Offer one request to the cluster: route, then the owning shard's
        bounded intake decides (an
        :class:`~beholder_tpu_torch.reliability.shed.Admission`; sheds are
        attributed to the shard's queue). With failover, routing sees only
        up shards, and a request the full cluster could hold but the
        survivors cannot sheds ``shard_down``."""
        from beholder_tpu_torch.reliability.shed import SHED_OVERSIZED, SHED_SHARD_DOWN

        fo = self.failover
        need = self._need(request)
        if fo is not None:
            fo.sweep()
            if not any(self._fits(s, need) for s in fo.routable_shards()):
                reason = (
                    SHED_SHARD_DOWN
                    if any(self._fits(s, need) for s in self.shards)
                    else SHED_OVERSIZED
                )
                return fo.shed(reason)
        shard = self._route(need, request=request)
        batcher = shard.batcher
        if need > batcher.num_pages or need > batcher.max_pages_per_seq:
            # unservable at any load (the batcher's own submit rule)
            return shard.intake.shed(SHED_OVERSIZED)
        admission = shard.intake.offer((self._seq, request), cost=need)
        if admission.accepted:
            self._seq += 1
            shard.pool.reserve(need)
            self.pool_view.refresh_gauges(self.instruments)
        return admission

    def run_pending(self) -> list:
        """Rebalance queued work across shards, then drain and serve every
        shard. Results come back in admission order across the cluster.
        With failover the drain goes through the recovery-aware loop
        instead: queued work on a down shard moves to survivors, and items
        nothing can hold (and drain-time drops) resolve to explicit
        ``Dropped`` outcomes in their admission-order positions; preempted
        requests (a control plane's intakes) to ``Preempted`` outcomes, in
        either mode. With a control plane the autoscaler is evaluated
        first, between serves, against settled pools."""
        if self.control_plane is not None:
            self.control_plane.evaluate_scaling(self)
        if self.failover is not None:
            return self._run_pending_failover()
        self._rebalance()
        drops, self._pending_drops = self._pending_drops, {}
        collected: list[tuple[int, object]] = []
        for shard in self.shards:
            pending, drain_waits, _ = shard.intake.drain_all()
            if not pending:
                continue
            requests = [req for _, req in pending]
            if self.flight_recorder is not None:
                shard.batcher.annotate_requests({
                    rid: {
                        "gid": f"s{seq}",
                        "worker": shard.pool.name,
                        **(
                            {"queue_wait_s": round(drain_waits[rid], 6)}
                            if rid < len(drain_waits)
                            else {}
                        ),
                    }
                    for rid, (seq, _) in enumerate(pending)
                })
            served = self._serve(shard, requests)
            for req in requests:
                shard.pool.release(self._need(req))
            if self.fabric is not None:
                self.fabric.finish_serve(shard)
            collected.extend(zip((seq for seq, _ in pending), served))
            if self.instruments is not None:
                self.instruments.requests_total.inc(len(pending), shard=str(shard.pool.shard_id))
        if self.fabric is not None:
            self.fabric.sync(self)
        self.pool_view.refresh_gauges(self.instruments)
        collected.extend(drops.items())
        collected.sort(key=lambda pair: pair[0])
        return [result for _, result in collected]

    def _run_pending_failover(self) -> list:
        """The failover drain: pull every shard's queue (down shards'
        too), release the submit-time reservations, and push everything
        through the recovery-aware ``_serve_pairs`` in admission order."""
        self.failover.sweep()
        pairs: list[tuple[int, object]] = []
        waits: dict[int, float] = {}
        for shard in self.shards:
            pending, drain_waits, _ = shard.intake.drain_all()
            for (seq, req), wait in zip(pending, drain_waits):
                shard.pool.release(self._need(req))
                pairs.append((seq, req))
                waits[seq] = wait
        drops, self._pending_drops = self._pending_drops, {}
        pairs.sort(key=lambda pair: pair[0])
        out = self._serve_pairs(pairs, waits=waits)
        out.update(drops)
        return [out[seq] for seq in sorted(out)]

    def _serve(self, shard: _Shard, requests: list) -> list:
        batcher = shard.batcher
        if self.prefill_workers and batcher.prefix_cache is None and batcher.spec is None:
            return self._run_disaggregated(shard, requests)
        if batcher.spec is not None:
            return batcher.run_spec(requests)
        return batcher.run(requests)

    # -- rebalance -------------------------------------------------------

    def _rebalance(self) -> None:
        """Re-pack queued requests across shards: a queued request whose
        shard can no longer hold its worst case moves to the
        least-pressure shard that fits it. Items move by
        :meth:`~beholder_tpu_torch.reliability.shed.IntakeQueue.restock`
        (admitted once, never re-counted or re-shed), with their original
        enqueue stamps."""
        if len(self.shards) < 2:
            return
        drained: dict[int, list] = {}
        stamps: dict[int, list[float]] = {}
        for s in self.shards:
            # a re-pack, not a claim: waits stay off the histogram
            drained[s.pool.shard_id], _, stamps[s.pool.shard_id] = s.intake.drain_all(
                record_waits=False
            )
        if not any(drained.values()):
            return
        # queued commitments come off while we re-pack
        needs: dict[int, list[int]] = {}
        for shard in self.shards:
            needs[shard.pool.shard_id] = [
                self._need(req) for _, req in drained[shard.pool.shard_id]
            ]
            shard.pool.release(sum(needs[shard.pool.shard_id]))
        final: dict[int, list] = {s.pool.shard_id: [] for s in self.shards}
        final_stamps: dict[int, list[float]] = {s.pool.shard_id: [] for s in self.shards}
        for shard in self.shards:
            sid = shard.pool.shard_id
            for (item, stamp), need in zip(zip(drained[sid], stamps[sid]), needs[sid]):
                target = shard
                if shard.pool.free < need:
                    best = self.pool_view.least_pressure()
                    if best.shard_id != sid and best.free >= need:
                        target = self.shards[best.shard_id]
                        self._record_route(target, "rebalance", need, 0.0, time.time())
                final[target.pool.shard_id].append(item)
                final_stamps[target.pool.shard_id].append(stamp)
                target.pool.reserve(need)
        for shard in self.shards:
            shard.intake.restock(
                final[shard.pool.shard_id], enqueued_at=final_stamps[shard.pool.shard_id]
            )
        self.pool_view.refresh_gauges(self.instruments)

    # -- the disaggregated serving loop ----------------------------------

    def _run_disaggregated(self, shard: _Shard, requests: list) -> list:
        """Prefill on a worker, decode on the shard: the batcher's own
        per-event loop (claim under page headroom, admit, tick the
        event-free stretch, retire, one packed readback) with its admission
        round replaced by :meth:`_handoff_admit`. A slot's stream depends
        only on its own pages and carry seed, and the handoff writes both
        as a colocated admit would."""
        b = shard.batcher
        b._start_run(requests)
        t0 = time.perf_counter()
        try:
            with torch.no_grad(), b._run_span(
                "serving.run_cluster", requests=len(requests), shard=shard.pool.name
            ) as span:
                results = b._run(requests, span, worker=shard.pool.name,
                                 admit=functools.partial(self._handoff_admit, shard))
        except BaseException:
            b._poisoned = True
            raise
        if b._metrics:
            b._metrics.observe_run(
                "run_cluster", time.perf_counter() - t0,
                sum(max(r.horizon, 0) for r in requests), trace_id=b._span_trace_id(span),
            )
        return results

    def _handoff_admit(self, shard: _Shard, span, requests, batch, carry):
        """The disaggregated admission round: each claimed request prefills
        on a prefill worker (a recorder-only ``prefill`` event; under
        failover a dead worker's request goes to the next), its pages hop
        to the shard, and the shard adopts them and seeds the slot's carry
        (the ``admit`` phase label: no new histogram labels). The claim
        loop's prefix-cache branch is inert here: this lane serves shards
        without a prefix cache."""
        from beholder_tpu_torch.models.serving import _adopt_chunks_carry

        b = shard.batcher
        fr = self.flight_recorder
        if self.failover is not None:
            self.failover.heartbeat(shard.pool.name)
        for slot, rid, feats_np, t, _hit, _hashes in batch:
            pf_ts = time.time() if fr is not None else 0.0
            pf_t0 = time.perf_counter()
            worker, (pred, chunks_k, chunks_v, n_pages) = self._prefill_with_failover(
                shard, feats_np, t
            )
            if fr is not None:
                fr.record("prefill", pf_ts, time.perf_counter() - pf_t0,
                          worker=worker.name, slot=slot, tokens=int(t),
                          **b._kernel_tags("flash", t * b._flops_per_token(t / 2.0)))
            pred, chunks_k, chunks_v = self.transfer.handoff(
                pred, chunks_k, chunks_v, n_pages, shard.pool.device,
                src=worker.name, dst=shard.pool.name,
            )
            with b._round(span, "admit", requests=1, slot=slot):
                b.state, carry = _adopt_chunks_carry(
                    b.state, carry, slot, chunks_k, chunks_v, n_pages, t, pred,
                    int(requests[rid].statuses[-1]),
                )
        return carry
