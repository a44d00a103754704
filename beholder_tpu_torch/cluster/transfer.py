"""Prefill workers and the page-granular KV handoff between workers.

Disaggregation splits one admission into three steps:

1. **Prefill** on a prefill worker:
   :func:`~beholder_tpu_torch.models.serving.kv_prefill_chunks` runs the
   prefill forward a colocated admit runs, but returns the kv as page
   chunks instead of writing a local pool: prefill workers own FLOPs, not
   pages.
2. **Transfer**: the chunks and the admit prediction move to the owning
   decode shard's device with ``Tensor.to``. Between two cards that is a
   peer copy; on one card it is no copy at all (``.to`` returns the same
   tensor), and the handoff is still counted. The chunks are fresh
   tensors of the forward, so nothing else holds them.
3. **Adopt** on the decode shard:
   :func:`~beholder_tpu_torch.models.serving.paged_adopt_chunks` pops pages
   off that shard's free stack and writes the chunks through the cast or
   quantize path a local prefill would use.

The handoff is counted on the host (the ``beholder_cluster_transfer*``
counters of :mod:`.instruments`, from tensor shapes only: no device read)
and recorded as a recorder-only ``transfer`` event carrying the worker
pair. With a flight plane bound to the recorder, a ``transfer.send`` instant
on the source worker and the ``transfer`` event share an edge id.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .pool import place_paged_state


class TransferFailed(RuntimeError):
    """A page transfer failed terminally (the bounded retry inside
    :class:`PageTransferEngine` was exhausted). Typed so the router can
    treat it as a worker fault and recover the request elsewhere."""

    def __init__(self, src: str, dst: str, cause: BaseException):
        super().__init__(f"page transfer {src} -> {dst} failed after retries: {cause!r}")
        self.src = src
        self.dst = dst
        self.kind = "transfer_failed"


class PrefillWorker:
    """A prefill worker: the model's prefill forward on its own device,
    producing handoff chunks instead of pool writes. It holds no pages.
    ``model`` must already sit on ``device``; ``head_rows`` is the decode
    shards' slot count (see
    :func:`~beholder_tpu_torch.models.serving.kv_prefill_chunks`)."""

    def __init__(self, model, page_size: int, *, head_rows: int, device=None,
                 name: str = "prefill-0"):
        self.model = model
        self.page_size = int(page_size)
        self.device = torch.device(device) if device is not None else model.device
        self.name = name
        self.head_rows = head_rows

    def prefill(self, feats_np: np.ndarray, t: int):
        """Prefill one request's (t, F) features. Returns ((,) admit
        prediction, per-layer k chunks, per-layer v chunks, live page
        count), on this worker's device."""
        from beholder_tpu_torch.device import to_device
        from beholder_tpu_torch.models.serving import kv_prefill_chunks

        t_pad = -(-t // self.page_size) * self.page_size
        n_pages = -(-t // self.page_size)
        padded = np.pad(feats_np, ((0, t_pad - feats_np.shape[0]), (0, 0)))
        with torch.no_grad():
            pred, chunks_k, chunks_v = kv_prefill_chunks(
                self.model, to_device(padded[None], self.device), t, self.page_size,
                head_rows=self.head_rows,
            )
        return pred, chunks_k, chunks_v, n_pages


class PageTransferEngine:
    """Moves prefilled kv chunks to the owning decode shard.

    Counts every handoff on the host (``transfers``, ``pages``, ``bytes``
    mirror the ``beholder_cluster_transfer*`` counters when a registry is
    wired, and exist without one) and records a recorder-only ``transfer``
    event per handoff with the (src, dst) pair.

    ``retry`` (a :class:`~beholder_tpu_torch.reliability.policy.RetryPolicy`)
    bounds each hop: a transient fault retries with jittered backoff, a
    persistent one surfaces as a typed :class:`TransferFailed` (counted on
    ``failed``). ``fail_next`` is the deterministic fault hook (the
    ``transfer_corruption`` leg of
    :class:`~beholder_tpu_torch.reliability.chaos.WorkerFault`)."""

    def __init__(self, instruments=None, flight_recorder=None, retry=None):
        self.instruments = instruments
        self.flight_recorder = flight_recorder
        self.retry = retry
        self.transfers = 0
        self.pages = 0
        self.bytes = 0
        #: terminal transfer failures (retries exhausted)
        self.failed = 0
        #: successful hops by plane (the ``op`` prefix before the first
        #: ``.``: "transfer", "drain")
        self.ops_by_plane: dict[str, int] = {}
        #: injected faults observed
        self.faults_injected = 0
        self._fail_next = 0
        self._fail_exc: Exception | None = None
        self._fail_worker: str | None = None

    # -- fault injection and the retried hop ------------------------------

    def fail_next(self, n: int, exc: Exception | None = None, worker: str | None = None) -> None:
        """Script the next ``n`` hops to fail. ``worker`` scopes the fault
        to hops whose destination is that worker (one broken link); None
        faults any hop. The default exception, ``ConnectionError``, is
        retryable: ``n`` below the retry budget exercises recovery by
        retry, ``n`` at or above it the terminal :class:`TransferFailed`."""
        self._fail_next = int(n)
        self._fail_exc = exc
        self._fail_worker = worker

    def _device_put(self, tree, device, dst: str | None = None):
        """The fault-gated hop; ``device=None`` keeps the tensors where
        they are, behind the same gate."""
        if self._fail_next > 0 and (self._fail_worker is None or self._fail_worker == dst):
            self._fail_next -= 1
            self.faults_injected += 1
            raise (
                self._fail_exc
                if self._fail_exc is not None
                else ConnectionError("chaos: injected page-transfer fault")
            )
        return place_paged_state(tree, device)

    def raw_move(self, tree, device, *, src: str, dst: str, op: str):
        """One retried hop of a nested tuple of tensors. A terminal failure
        raises :class:`TransferFailed` and counts it."""
        plane = op.split(".", 1)[0]
        try:
            if self.retry is not None:
                out = self.retry.call(lambda: self._device_put(tree, device, dst=dst), op=op)
            else:
                out = self._device_put(tree, device, dst=dst)
            self.ops_by_plane[plane] = self.ops_by_plane.get(plane, 0) + 1
            return out
        except Exception as err:  # noqa: BLE001 - typed terminal surface
            self.failed += 1
            if self.instruments is not None:
                self.instruments.transfer_failed_total.inc()
            raise TransferFailed(src, dst, err) from err

    @staticmethod
    def _live_bytes(chunks_k, chunks_v, n_pages: int) -> int:
        """Bytes of the live pages moved, from shapes and dtypes alone (the
        dead tail of the static-width chunks moves too but is dropped at
        adopt; the counter reports the page payload)."""
        per_page = 0
        for c in (*chunks_k, *chunks_v):
            # (p_max, Hkv, Dh, page) -> bytes of one page row
            per_page += (c.numel() // c.shape[0]) * c.element_size()
        return per_page * int(n_pages)

    def handoff(self, pred, chunks_k, chunks_v, n_pages: int, dst_device, src: str, dst: str):
        """Move (pred, chunks) to ``dst_device`` through :meth:`raw_move`'s
        bounded retry and count the handoff. Returns the moved tensors."""
        fr = self.flight_recorder
        ts = time.time() if fr is not None else 0.0
        # edge id: None unless a flight plane is bound; with one, the send
        # instant lands on the source worker's track and the transfer
        # record on the destination's (the receive's ts was taken above,
        # before the send is stamped, as the reference orders them)
        edge = fr.next_edge() if fr is not None else None
        if edge is not None:
            fr.instant("transfer.send", worker=src, dst=dst, pages=int(n_pages), edge=edge)
        t0 = time.perf_counter()
        pred, chunks_k, chunks_v = self.raw_move(
            (pred, chunks_k, chunks_v), dst_device,
            src=src, dst=dst, op=f"transfer.{src}->{dst}",
        )
        nbytes = self._live_bytes(chunks_k, chunks_v, n_pages)
        self.transfers += 1
        self.pages += int(n_pages)
        self.bytes += nbytes
        if self.instruments is not None:
            self.instruments.observe_transfer(int(n_pages), nbytes)
        if fr is not None:
            edge_note = {"edge": edge} if edge is not None else {}
            fr.record("transfer", ts, time.perf_counter() - t0,
                      worker=dst, src=src, pages=int(n_pages), bytes=nbytes, **edge_note)
        return pred, chunks_k, chunks_v
