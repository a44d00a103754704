"""Pluggable draft-token proposers for speculative decoding.

Port of the reference's ``spec/drafter.py``. A drafter proposes up to ``k``
future forecast tokens per slot; the verify step scores them all in one
forward. Drafter quality moves only the acceptance rate: under greedy exact
acceptance the emitted stream is the same whatever a drafter proposes.

- :class:`NGramDrafter` — greedy suffix matching over the request's own
  history (observed deltas and emitted tokens), no model work;
- :class:`SmallModelDrafter` — a smaller
  :class:`~beholder_tpu_torch.models.sequence.TelemetrySequenceModel` on its
  own paged slots; after each verify its speculated suffix is rolled back
  (:func:`~beholder_tpu_torch.spec.verify.paged_rollback`) and the corrected
  token re-ingested;
- :class:`NullDrafter` — proposes nothing: every verify step is a plain
  one-token decode.

Only :class:`SmallModelDrafter` touches a device.
"""

from __future__ import annotations

import numpy as np
import torch

from beholder_tpu_torch.device import resolve_device, to_device
from beholder_tpu_torch.models.serving import init_paged, paged_admit_batch, paged_release_many
from beholder_tpu_torch.ops import NUM_STATUSES

from .verify import paged_rollback, spec_verify_step


class Drafter:
    """Interface. ``history`` is the request's input-token stream so far —
    observed feature deltas followed by emitted forecast tokens, including
    the pending last token (the one the next verify chunk feeds first)."""

    def on_admit(self, slot: int, feats: np.ndarray, last_status: int) -> None:
        """A request was admitted into ``slot``; ``feats`` is its (t, F)
        prefix feature matrix."""

    def propose(self, slot: int, history: np.ndarray, k: int) -> np.ndarray:
        """Up to ``k`` proposed continuations of ``history`` (may return
        fewer, including none)."""
        raise NotImplementedError

    def resync(self, slot: int, history: np.ndarray) -> None:
        """Called after each verify step with the slot's updated history;
        stateful drafters roll their speculation back to it here."""

    def on_retire(self, slot: int) -> None:
        """The slot's request finished; drop any per-slot state."""


class NullDrafter(Drafter):
    """Proposes nothing — spec serving degenerates to one-token verify
    steps (the spec-off baseline)."""

    def propose(self, slot: int, history: np.ndarray, k: int) -> np.ndarray:
        return np.zeros(0, np.float32)


class NGramDrafter(Drafter):
    """Greedy n-gram / suffix-match drafting over the request's own history.

    For order ``max_order`` down to 1, the latest earlier occurrence of the
    history's order-long suffix (values within ``match_tol``; 0.0 =
    bitwise) is found and the tokens following it are proposed. No match at
    any order falls back to repeating the last token. Matching looks at the
    most recent ``scan_window`` tokens only, so a round stays O(window)."""

    def __init__(
        self,
        max_order: int = 3,
        match_tol: float = 0.0,
        repeat_last_fallback: bool = True,
        scan_window: int = 256,
    ):
        if max_order < 1:
            raise ValueError(f"max_order must be >= 1, got {max_order}")
        if scan_window < max_order + 1:
            raise ValueError(f"scan_window {scan_window} too small for order {max_order}")
        self.max_order = int(max_order)
        self.match_tol = float(match_tol)
        self.repeat_last_fallback = bool(repeat_last_fallback)
        self.scan_window = int(scan_window)

    def _find_suffix(self, history: np.ndarray, order: int) -> int | None:
        """Index (into ``history``) after the latest earlier occurrence of
        the order-long suffix within the scan window, or None."""
        base = max(0, history.shape[0] - self.scan_window)
        recent = history[base:]
        suffix = recent[-order:]
        windows = np.lib.stride_tricks.sliding_window_view(recent, order)
        if self.match_tol == 0.0:
            hits = np.all(windows[:-1] == suffix, axis=1)
        else:
            hits = np.all(np.abs(windows[:-1] - suffix) <= self.match_tol, axis=1)
        if not hits.any():
            return None
        start = int(np.nonzero(hits)[0][-1])  # latest occurrence
        return base + start + order

    def propose(self, slot: int, history: np.ndarray, k: int) -> np.ndarray:
        history = np.asarray(history, np.float32)
        if history.shape[0] == 0 or k <= 0:
            return np.zeros(0, np.float32)
        for order in range(min(self.max_order, history.shape[0] - 1), 0, -1):
            nxt = self._find_suffix(history, order)
            if nxt is not None and nxt < history.shape[0]:
                out = history[nxt : nxt + k]
                if out.shape[0] < k:
                    out = np.concatenate([out, np.full(k - out.shape[0], out[-1], np.float32)])
                return np.asarray(out, np.float32)
        if self.repeat_last_fallback:
            return np.full(k, history[-1], np.float32)
        return np.zeros(0, np.float32)


class SmallModelDrafter(Drafter):
    """Draft with a smaller sequence model on its own paged slots.

    The drafter owns a :class:`~beholder_tpu_torch.models.serving.
    PagedKVState` on ``device`` (``None``: the CUDA card, raising when there
    is none) sized for the draft model. Admission prefills through
    :func:`~beholder_tpu_torch.models.serving.paged_admit_batch`; each draft
    step is a width-1 :func:`~beholder_tpu_torch.spec.verify.
    spec_verify_step` on its own pool, masked to one slot, so a drafter with
    the target's weights runs the target's dense verify op sequence. After
    each verify, :meth:`resync` truncates the cache to the longest common
    prefix of what it ingested (``_inputs``, host side) and the accepted
    stream."""

    def __init__(
        self,
        model,
        *,
        num_pages: int = 64,
        page_size: int = 8,
        slots: int = 4,
        max_pages_per_seq: int = 32,
        device=None,
    ):
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.page_size = int(page_size)
        self.slots = int(slots)
        self.num_pages = int(num_pages)
        self.max_pages_per_seq = int(max_pages_per_seq)
        self.state = init_paged(self.model, num_pages, page_size, slots, max_pages_per_seq)
        self._inputs: list[list[float]] = [[] for _ in range(slots)]
        self._status = np.zeros(slots, np.int64)

    def _up(self, arr) -> torch.Tensor:
        return to_device(np.asarray(arr), self.device)

    # -- lifecycle -------------------------------------------------------
    def on_admit(self, slot: int, feats: np.ndarray, last_status: int) -> None:
        t = feats.shape[0]
        # fail here if the prefix alone cannot fit the draft pool: the
        # masked allocator would otherwise clip its pops and corrupt this
        # pool's table and refcounts (growth past the prefix is caught per
        # draft by the sticky flag in propose())
        need = -(-t // self.page_size)
        if need > self.max_pages_per_seq or need > self.num_pages:
            raise RuntimeError(
                f"draft pool exhausted: a {t}-token prefix needs {need} "
                f"pages (drafter pool {self.num_pages}, per-seq cap "
                f"{self.max_pages_per_seq}) — size the SmallModelDrafter "
                f"for the target batcher's workload"
            )
        pad = need * self.page_size
        if self._inputs[slot]:
            self.on_retire(slot)
        with torch.no_grad():
            _, self.state = paged_admit_batch(
                self.model, self.state, self._up(np.asarray([slot], np.int32)),
                self._up(np.pad(feats, ((0, pad - t), (0, 0)))[None]),
                self._up(np.asarray([t], np.int32)),
            )
        self._inputs[slot] = [float(x) for x in feats[:, 0]]
        self._status[slot] = int(last_status)

    def on_retire(self, slot: int) -> None:
        if self._inputs[slot]:
            self.state = paged_release_many(self.state, self._up(np.asarray([slot], np.int32)))
            self._inputs[slot] = []

    # -- drafting --------------------------------------------------------
    def _tick(self, token: torch.Tensor, status_oh: torch.Tensor, active: torch.Tensor,
              slot: int) -> torch.Tensor:
        """One draft step: a width-1 verify chunk on the drafter's pool,
        masked to ``slot``; returns its prediction (a 0-d device tensor)."""
        chunk = torch.cat([token.reshape(1).expand(self.slots)[:, None], status_oh],
                          dim=-1)[:, None, :]
        preds, self.state = spec_verify_step(self.model, self.state, chunk, active)
        return preds[slot, 0]

    def propose(self, slot: int, history: np.ndarray, k: int) -> np.ndarray:
        if k <= 0 or not self._inputs[slot]:
            return np.zeros(0, np.float32)
        self.resync(slot, history)
        inputs = self._inputs[slot]
        pending = np.asarray(history[len(inputs):], np.float32)
        if pending.shape[0] == 0:  # fully in sync (not reached mid-run)
            return np.zeros(0, np.float32)
        oh = self._up(np.eye(NUM_STATUSES, dtype=np.float32)[self._status])
        active = self._up(np.arange(self.slots) == slot)
        tokens = self._up(pending)
        preds = []
        with torch.no_grad():
            # ingest the tokens the drafter has not seen (>= 1: the pending
            # emitted token); the last ingestion's output is proposal 1
            for i in range(pending.shape[0]):
                pred = self._tick(tokens[i], oh, active, slot)
            inputs.extend(float(x) for x in pending)
            preds.append(pred)
            # the remaining k - 1 proposals feed back on the device
            for _ in range(k - 1):
                pred = self._tick(pred, oh, active, slot)
                preds.append(pred)
            # one readback: the sticky flag of the draft pool rides along,
            # so exhaustion mid-draft raises instead of corrupting the pool
            packed = torch.cat([
                self.state.alloc_failed.float()[None], torch.stack(preds).float(),
            ]).cpu().numpy()
        if packed[0]:
            raise RuntimeError(
                "draft pool exhausted mid-draft (drafter allocator tripped) "
                "— raise the SmallModelDrafter's num_pages / max_pages_per_seq"
            )
        out = packed[1:].astype(np.float32)
        # the cache ingested proposals 1..k-1 as inputs (proposal k is
        # output-only); mirror that host side for resync
        inputs.extend(float(x) for x in out[:-1])
        return out

    def resync(self, slot: int, history: np.ndarray) -> None:
        inputs = self._inputs[slot]
        keep = 0
        limit = min(len(inputs), history.shape[0])
        while keep < limit and inputs[keep] == float(history[keep]):
            keep += 1
        if keep < len(inputs):
            # paged_rollback reads new_lens only where active: a broadcast
            # length and a one-hot mask need no device read
            with torch.no_grad():
                self.state = paged_rollback(
                    self.state, self._up(np.full(self.slots, keep, np.int32)),
                    self._up(np.arange(self.slots) == slot),
                )
            del inputs[keep:]
