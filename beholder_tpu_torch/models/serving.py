"""Paged KV cache and continuous batching: the port's serving main path.

Port of the reference's ``models/serving.py`` (the cold-admission serving
core). Each layer's cache is a ``(num_pages, Hkv, Dh, page)`` pool, tokens
minor; a sequence owns a row of the page table; retired requests return
their pages to a free stack. The decode tick writes each slot's new kv
column into its page and attends the pages in place through the CUDA
kernel behind :func:`~beholder_tpu_torch.ops.paged_attention.
paged_decode_attention` — no dense view of the cache is built.

How the reference's JAX idioms map here:

- ``mode="drop"`` scatters become masked writes that never index out of
  bounds (:func:`~beholder_tpu_torch.models.sequence.index_put_dropping_`
  for the pools, :func:`_scatter_small` for the allocator's small
  vectors), and ``.at[].add`` with repeated ids becomes a one-hot count;
- ``lax.scan``/``lax.while_loop`` over ticks become Python loops (the tick
  count is a host integer already);
- pools are updated in place (JAX returns new arrays): a
  :class:`PagedKVState` handed to a function here is consumed.

Host rules kept from the reference: page headroom and retirement are host
arithmetic over request lengths, features are built in numpy and copied up
asynchronously, and nothing is read back from the card in the middle of a
run. :meth:`ContinuousBatcher.run` reads one packed buffer at its end;
:meth:`ContinuousBatcher.run_waves` with ``device_results=True`` reads
nothing.

Not ported yet: fused chunk admission (``fused=True``), prefix caching,
forks and ``run_what_if``, speculative decoding, metrics, tracing, the
flight recorder, deadlines and the intake queue.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from beholder_tpu_torch.device import resolve_device, to_device
from beholder_tpu_torch.ops import NUM_STATUSES
from beholder_tpu_torch.ops.paged_attention import PagedInfo, QuantizedPool
from beholder_tpu_torch.ops.quant import E8M0_BIAS, pool_quantize, pool_scales_f32

from .sequence import TelemetrySequenceModel, index_put_dropping_, one_hot


class PagedKVState(NamedTuple):
    """Paged serving state; every tensor has a fixed shape.

    - ``k_pools``/``v_pools``: per-layer (num_pages, Hkv, Dh, page) bf16
      pools, or :class:`QuantizedPool` (int8 + f32 scales, fp8 + uint8
      E8M0 scales);
    - ``page_table`` (slots, max_pages) int32, ``seq_lens`` (slots,) int32,
      ``active`` (slots,) bool;
    - ``free_stack`` (num_pages,) int32 with ``free_stack[:free_top]`` free;
    - ``page_ref`` (num_pages,) int32 reference counts;
    - ``alloc_failed``: 0-d bool, sticky (pool exhausted / table overflow).
    """

    k_pools: tuple
    v_pools: tuple
    page_table: torch.Tensor
    seq_lens: torch.Tensor
    active: torch.Tensor
    free_stack: torch.Tensor
    free_top: torch.Tensor
    page_ref: torch.Tensor
    alloc_failed: torch.Tensor


def _cache_dtype(cache_dtype) -> torch.dtype:
    names = {"bf16": torch.bfloat16, "bfloat16": torch.bfloat16,
             "int8": torch.int8, "fp8": torch.float8_e4m3fn}
    dtype = names.get(cache_dtype, cache_dtype)
    if dtype not in (torch.bfloat16, torch.int8, torch.float8_e4m3fn):
        raise ValueError(f"unsupported cache_dtype {cache_dtype!r}")
    return dtype


def init_paged(
    model: TelemetrySequenceModel,
    num_pages: int,
    page_size: int,
    slots: int,
    max_pages_per_seq: int,
    cache_dtype=torch.bfloat16,
) -> PagedKVState:
    """An empty pool on the model's device: bf16 (``"bf16"``), int8
    (``"int8"``) or fp8 (``"fp8"``) pages."""
    dev = model.device
    dh = model.dim // model.heads
    hkv = model.kv_heads or model.heads
    shape = (num_pages, hkv, dh, page_size)
    dtype = _cache_dtype(cache_dtype)

    def pool():
        if dtype == torch.int8:
            return QuantizedPool(
                torch.zeros(shape, dtype=torch.int8, device=dev),
                torch.ones((num_pages, hkv, page_size), device=dev),
            )
        if dtype == torch.float8_e4m3fn:
            # 127 = biased exponent of 2**0, the identity scale
            return QuantizedPool(
                torch.zeros(shape, dtype=torch.float8_e4m3fn, device=dev),
                torch.full((num_pages, hkv, page_size), E8M0_BIAS,
                           dtype=torch.uint8, device=dev),
            )
        return torch.zeros(shape, dtype=dtype, device=dev)

    i32 = dict(dtype=torch.int32, device=dev)
    return PagedKVState(
        tuple(pool() for _ in range(model.layers)),
        tuple(pool() for _ in range(model.layers)),
        torch.zeros((slots, max_pages_per_seq), **i32),
        torch.zeros((slots,), **i32),
        torch.zeros((slots,), dtype=torch.bool, device=dev),
        torch.arange(num_pages, **i32),
        torch.tensor(num_pages, **i32),
        torch.zeros((num_pages,), **i32),
        torch.zeros((), dtype=torch.bool, device=dev),
    )


def _pool_geometry(state: PagedKVState) -> tuple[int, int]:
    """(num_pages, page_size) of the state's pools."""
    p0 = state.k_pools[0]
    vals = p0.values if isinstance(p0, QuantizedPool) else p0
    return vals.shape[0], vals.shape[3]


def _scatter_small(old: torch.Tensor, idx: torch.Tensor, vals, valid: torch.Tensor):
    """``old.at[idx].set(vals, mode="drop")`` over the entries where
    ``valid``, for the allocator's small tensors: a one-hot select over
    ``old``'s rows (ids outside ``[0, len(old))`` never match, so they
    drop), with no host synchronisation. Returns a new tensor."""
    rows = torch.arange(old.shape[0], device=old.device)
    hit = (idx.to(torch.int64)[:, None] == rows[None, :]) & valid[:, None]
    if torch.is_tensor(vals):
        vals = vals.to(old.dtype)
    else:  # a Python scalar: filled on the device, never copied up
        vals = torch.full((idx.shape[0], *old.shape[1:]), vals, dtype=old.dtype,
                          device=old.device)
    src = torch.argmax(hit.to(torch.int32), dim=0)
    sel = hit.any(dim=0).view(-1, *([1] * (old.ndim - 1)))
    return torch.where(sel, vals[src], old)


def _pop_pages(state: PagedKVState, need: torch.Tensor):
    """Vectorized masked stack pop: needer i (with ``need[i]``) gets page
    ``free_stack[free_top - 1 - rank_i]``; popped pages start at refcount
    1. Returns (pages (len(need),), new_top, new_ref, failed)."""
    num_pages = state.free_stack.shape[0]
    need_i = need.to(torch.int32)
    rank = torch.cumsum(need_i, 0, dtype=torch.int32) - 1
    n = need_i.sum(dtype=torch.int32)
    idx = state.free_top - 1 - rank
    failed = state.alloc_failed | (n > state.free_top)
    pages = state.free_stack[idx.clamp(0, num_pages - 1).to(torch.int64)]
    ref = _scatter_small(state.page_ref, pages, 1, need)
    return pages, state.free_top - n, ref, failed


def _unref_pages(
    state: PagedKVState, held_flat: torch.Tensor, alive_flat: torch.Tensor
) -> PagedKVState:
    """Drop one reference from each held page (where ``alive_flat``);
    pages whose count reaches zero go back on the free stack in one
    vectorized compaction (no dedup needed when slots shared a page)."""
    num_pages, _ = _pool_geometry(state)
    ids = torch.arange(num_pages, device=state.page_ref.device)
    hits = (held_flat.to(torch.int64)[:, None] == ids[None, :]) & alive_flat[:, None]
    ref = state.page_ref - hits.sum(dim=0, dtype=torch.int32)
    newly_free = (ref <= 0) & (state.page_ref > 0)
    rank = torch.cumsum(newly_free.to(torch.int32), 0, dtype=torch.int32) - 1
    dest = state.free_top + rank
    stack = _scatter_small(state.free_stack, dest, ids, newly_free)
    return state._replace(
        free_stack=stack,
        free_top=state.free_top + newly_free.sum(dtype=torch.int32),
        page_ref=torch.clamp(ref, min=0),
    )


def _alloc_for_tick(state: PagedKVState) -> PagedKVState:
    """Give every active slot whose next write opens a fresh page
    (len % page == 0) a page off the free stack."""
    _, page = _pool_geometry(state)
    _, max_pages = state.page_table.shape
    need = state.active & (state.seq_lens % page == 0)
    pages, new_top, ref, failed = _pop_pages(state, need)
    pidx = state.seq_lens // page
    failed = failed | (need & (pidx >= max_pages)).any()
    cols = torch.arange(max_pages, device=pidx.device)
    hit = need[:, None] & (cols[None, :] == pidx.clamp(0, max_pages - 1)[:, None])
    table = torch.where(hit, pages[:, None], state.page_table)
    return state._replace(
        page_table=table, free_top=new_top, page_ref=ref, alloc_failed=failed
    )


def slot_cache(state: PagedKVState, slot: int, layer: int):
    """Debug/test helper: ``slot``'s written cache for ``layer`` as dense
    (Hkv, Dh, seq_len) f32 tensors, dequantized. Reads the length back to
    the host; the serving path never calls it."""

    def dense(pool):
        if isinstance(pool, QuantizedPool):
            vals = pool.values.float() * pool_scales_f32(pool.scales)[:, :, None, :]
        else:
            vals = pool.float()
        g = vals[state.page_table[slot].to(torch.int64)]     # (P, Hkv, Dh, page)
        g = g.permute(1, 2, 0, 3).reshape(vals.shape[1], vals.shape[2], -1)
        return g[:, :, : int(state.seq_lens[slot])]

    return dense(state.k_pools[layer]), dense(state.v_pools[layer])


def paged_decode_tick(
    model: TelemetrySequenceModel, state: PagedKVState, feats_t: torch.Tensor
):
    """One decode step for all slots: ``feats_t`` is (slots, FEATURES);
    inactive slots run too (their writes drop, their outputs are
    ignored, and they pass the -1 length so the kernel reads none of
    their pages). Returns ((slots,) predictions, updated state)."""
    state = _alloc_for_tick(state)
    num_pages, page = _pool_geometry(state)
    slots, max_pages = state.page_table.shape
    rows = torch.arange(slots, device=feats_t.device)
    pidx = (state.seq_lens // page).clamp(0, max_pages - 1).to(torch.int64)
    write_pages = torch.where(state.active, state.page_table[rows, pidx], num_pages)
    info = PagedInfo(
        state.page_table,
        torch.where(state.active, state.seq_lens, -1),
        write_pages,
        state.seq_lens % page,
    )
    preds, new_kvs = model(
        feats_t[:, None, :], cache=(state.k_pools, state.v_pools, info)
    )
    state = state._replace(
        k_pools=tuple(k for k, _ in new_kvs),
        v_pools=tuple(v for _, v in new_kvs),
        seq_lens=state.seq_lens + state.active.to(torch.int32),
    )
    return preds[:, 0], state


def _quantize_tokens(x: torch.Tensor, values_dtype: torch.dtype):
    """(..., Dh, T) -> 8-bit values + (..., T) per-(head, token) scales,
    through the same dispatch as the decode tick's column writes."""
    return pool_quantize(x, axis=-2, values_dtype=values_dtype)


def _write_chunks(pool, drop_pages: torch.Tensor, chunks: torch.Tensor):
    """Write (n, Hkv, Dh, page) chunks into pool rows ``drop_pages`` in
    place (ids ``>= num_pages`` drop), quantizing per token when the pool
    is quantized."""
    values = pool.values if isinstance(pool, QuantizedPool) else pool
    valid = drop_pages < values.shape[0]
    if isinstance(pool, QuantizedPool):
        q, scale = _quantize_tokens(chunks, pool.values.dtype)
        index_put_dropping_(pool.values, (drop_pages,), q, valid)
        index_put_dropping_(pool.scales, (drop_pages,), scale, valid)
        return pool
    index_put_dropping_(pool, (drop_pages,), chunks, valid)
    return pool


def paged_admit_batch(
    model: TelemetrySequenceModel,
    state: PagedKVState,
    slot_ids: torch.Tensor,
    feats_padded: torch.Tensor,
    prefix_lens: torch.Tensor,
    fused: bool = False,
):
    """Admit a wave of requests with one dense prefill: ``feats_padded``
    (n, T_max, F) with a page-multiple T_max, ``slot_ids``/``prefix_lens``
    (n,). A request with ``prefix_lens[i] == 0`` is skipped. Allocates
    ceil(len/page) pages per request and writes the prefix kv into them.
    Returns ((n,) last predictions, state)."""
    if fused:
        raise NotImplementedError("fused (chunk-kernel) admission is not ported yet")
    num_pages, page = _pool_geometry(state)
    slots, max_pages = state.page_table.shape
    n, t_max, _ = feats_padded.shape
    if t_max % page:
        raise ValueError(f"padded prefix {t_max} not a page multiple ({page})")
    p_max = t_max // page
    dev = feats_padded.device

    preds, kvs = model(feats_padded, return_kv=True)
    prefix_lens = prefix_lens.to(torch.int32)
    last_pred = preds[
        torch.arange(n, device=dev), (prefix_lens - 1).clamp(0, t_max - 1).to(torch.int64)
    ]

    n_pages = (prefix_lens + page - 1) // page                       # (n,) ceil
    chunk_alive = torch.arange(p_max, device=dev)[None, :] < n_pages[:, None]
    pages, new_top, ref, failed = _pop_pages(state, chunk_alive.reshape(-1))
    pages = pages.reshape(n, p_max)
    failed = failed | (n_pages > max_pages).any()
    if p_max < max_pages:
        padded = F.pad(pages, (0, max_pages - p_max))
    else:
        padded = pages[:, :max_pages]
    table_rows = torch.where(
        torch.arange(max_pages, device=dev)[None, :] < n_pages[:, None], padded, 0
    )
    drop = torch.where(chunk_alive, pages, num_pages).reshape(-1)

    def chunks(a):
        # (n, Hkv, T_max, Dh) -> (n*p_max, Hkv, Dh, page)
        hkv, dh = a.shape[1], a.shape[3]
        a = a.transpose(2, 3).reshape(n, hkv, dh, p_max, page)
        return a.permute(0, 3, 1, 2, 4).reshape(n * p_max, hkv, dh, page)

    k_pools = tuple(
        _write_chunks(pool, drop, chunks(k)) for pool, (k, _) in zip(state.k_pools, kvs)
    )
    v_pools = tuple(
        _write_chunks(pool, drop, chunks(v)) for pool, (_, v) in zip(state.v_pools, kvs)
    )

    admitted = prefix_lens > 0
    safe_slots = torch.where(admitted, slot_ids.to(torch.int64).clamp(0, slots - 1), slots)
    state = state._replace(
        k_pools=k_pools,
        v_pools=v_pools,
        page_table=_scatter_small(state.page_table, safe_slots, table_rows, admitted),
        seq_lens=_scatter_small(state.seq_lens, safe_slots, prefix_lens, admitted),
        active=_scatter_small(state.active, safe_slots, admitted, admitted),
        free_top=new_top,
        page_ref=ref,
        alloc_failed=failed,
    )
    return last_pred, state


def paged_admit(
    model: TelemetrySequenceModel,
    state: PagedKVState,
    slot,
    feats_padded: torch.Tensor,
    prefix_len,
):
    """Admit one request into ``slot`` (see :func:`paged_admit_batch`).
    Returns ((,) last prediction, state)."""
    dev = feats_padded.device
    preds, state = paged_admit_batch(
        model, state,
        torch.as_tensor(slot, dtype=torch.int32, device=dev).reshape(1),
        feats_padded,
        torch.as_tensor(prefix_len, dtype=torch.int32, device=dev).reshape(1),
    )
    return preds[0], state


def paged_release_many(state: PagedKVState, slot_ids: torch.Tensor) -> PagedKVState:
    """Retire several distinct slots in one vectorized unref; inactive
    slots contribute no pages (their length is 0)."""
    _, page = _pool_geometry(state)
    max_pages = state.page_table.shape[1]
    sid = slot_ids.to(torch.int64)
    counts = (state.seq_lens[sid] + page - 1) // page
    alive = (
        torch.arange(max_pages, device=sid.device)[None, :] < counts[:, None]
    ).reshape(-1)
    state = _unref_pages(state, state.page_table[sid].reshape(-1), alive)
    every = torch.ones_like(sid, dtype=torch.bool)
    return state._replace(
        active=_scatter_small(state.active, sid, False, every),
        seq_lens=_scatter_small(state.seq_lens, sid, 0, every),
    )


def paged_release(state: PagedKVState, slot) -> PagedKVState:
    """Retire ``slot``: drop one reference from each of its pages."""
    dev = state.seq_lens.device
    return paged_release_many(
        state, torch.as_tensor(slot, dtype=torch.int32, device=dev).reshape(1)
    )


def paged_wave(
    model: TelemetrySequenceModel,
    state: PagedKVState,
    last_pred: torch.Tensor,
    status_oh: torch.Tensor,
    n_ticks: int,
):
    """Roll every active slot ``n_ticks`` decode steps with the prediction
    fed back on the device. Returns ((slots, n_ticks + 1) deltas — the
    admit prediction plus each tick's — and the rolled state)."""
    pred = last_pred
    deltas = []
    for _ in range(n_ticks):
        deltas.append(pred)
        feats_t = torch.cat([pred[:, None], status_oh], dim=-1).float()
        pred, state = paged_decode_tick(model, state, feats_t)
    deltas.append(pred)
    return torch.stack(deltas, dim=1), state


def _roll_and_release(
    model, state: PagedKVState, preds, status_ids, n: int, n_ticks: int
):
    """Seed slot-wide carriers with the admit predictions and frozen
    status one-hots of slots ``0..n-1``, roll ``n_ticks`` ticks, release
    those slots. Returns the (slots, n_ticks + 1) deltas and the state."""
    slots = state.page_table.shape[0]
    dev = preds.device
    status_oh = torch.zeros((slots, NUM_STATUSES), device=dev)
    status_oh[:n] = one_hot(status_ids, NUM_STATUSES)
    pred0 = torch.zeros((slots,), device=dev)
    pred0[:n] = preds.float()
    deltas, state = paged_wave(model, state, pred0, status_oh, n_ticks)
    state = paged_release_many(state, torch.arange(n, dtype=torch.int32, device=dev))
    return deltas, state


def serve_wave(
    model: TelemetrySequenceModel,
    state: PagedKVState,
    feats_padded: torch.Tensor,
    prefix_lens: torch.Tensor,
    last_statuses: torch.Tensor,
    n_ticks: int,
    horizons: tuple[int, ...] | None = None,
    fused: bool = False,
):
    """One serving wave: admit ``n`` requests into slots ``0..n-1``, roll
    ``n_ticks`` ticks, release the wave's pages. Returns ((n, n_ticks + 1)
    deltas, state), or with ``horizons`` a tuple of per-request
    ``(horizons[i],)`` device views."""
    n = feats_padded.shape[0]
    dev = feats_padded.device
    preds, state = paged_admit_batch(
        model, state, torch.arange(n, dtype=torch.int32, device=dev),
        feats_padded, prefix_lens, fused=fused,
    )
    deltas, state = _roll_and_release(model, state, preds, last_statuses, n, n_ticks)
    if horizons is not None:
        return tuple(deltas[i, : horizons[i]] for i in range(n)), state
    return deltas[:n], state


class _RunCarry(NamedTuple):
    """Device-resident feedback state of :meth:`ContinuousBatcher.run`."""

    last_pred: torch.Tensor  # (slots,) f32
    status_oh: torch.Tensor  # (slots, NUM_STATUSES) f32
    delta_buf: torch.Tensor  # (slots, cap) f32; tick t writes column t


def _admit_many_carry(
    model, state, carry: _RunCarry, slot_ids, feats_padded, prefix_lens, last_statuses
):
    """Admit a batch of requests with one prefill and record their
    predictions and status one-hots in the device carry."""
    preds, state = paged_admit_batch(model, state, slot_ids, feats_padded, prefix_lens)
    sid = (slot_ids.to(torch.int64),)
    return state, carry._replace(
        last_pred=carry.last_pred.index_put(sid, preds.float()),
        status_oh=carry.status_oh.index_put(sid, one_hot(last_statuses, NUM_STATUSES)),
    )


def _tick_with_carry(model, state, carry: _RunCarry, write_idx: torch.Tensor):
    """One decode tick for all slots, feedback on the device: append each
    active slot's pending prediction to its forecast row (inactive slots
    pass ``write_idx == cap``, which matches no column), run the tick,
    keep the new predictions."""
    cap = carry.delta_buf.shape[1]
    cols = torch.arange(cap, device=write_idx.device)
    hit = cols[None, :] == write_idx.to(torch.int64)[:, None]
    buf = torch.where(hit, carry.last_pred[:, None], carry.delta_buf)
    feats_t = torch.cat([carry.last_pred[:, None], carry.status_oh], dim=-1)
    preds, state = paged_decode_tick(model, state, feats_t)
    return state, carry._replace(last_pred=preds.float(), delta_buf=buf)


def _tick_chunk(model, state, carry: _RunCarry, write_idx: torch.Tensor, n: int):
    """``n`` decode ticks between two scheduling events; tick i writes
    forecast column ``write_idx + i`` (the cap sentinel stays out of
    range)."""
    cap = carry.delta_buf.shape[1]
    for i in range(n):
        cur = torch.where(write_idx >= cap, cap, write_idx + i)
        state, carry = _tick_with_carry(model, state, carry, cur)
    return state, carry


class Request(NamedTuple):
    progress: np.ndarray   # (T+1,) observed progress
    statuses: np.ndarray   # (T+1,) observed statuses
    horizon: int


class ContinuousBatcher:
    """Host-side scheduler over the paged state.

    :meth:`run` admits queued requests into slots as they free up and runs
    the event-free stretches between admissions and retirements as tick
    chunks; :meth:`run_waves` serves greedy waves of up to ``slots``
    requests, each admit + ticks + release. Results are per-request
    forecast delta arrays. Page headroom is host arithmetic that mirrors
    the device allocator, so scheduling never waits on the card; the
    sticky ``alloc_failed`` flag is checked once at the end.

    ``model`` holds the weights (load them with
    :func:`beholder_tpu_torch.models.bridge.load_flax_params`); it is moved
    to ``device``, which ``None`` resolves to the CUDA card (raising when
    there is none). ``ticks`` counts decode ticks run, so a caller can hold
    the kernel's launch count against ``layers * ticks``.
    """

    _ALLOCATOR_TRIPPED = (
        "page pool exhausted mid-run (device allocator tripped despite "
        "host headroom checks) — raise num_pages"
    )

    def __init__(
        self,
        model: TelemetrySequenceModel,
        *,
        num_pages: int = 64,
        page_size: int = 16,
        slots: int = 4,
        max_prefix: int = 64,
        max_pages_per_seq: int = 32,
        cache_dtype=torch.bfloat16,
        device=None,
    ):
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.page_size = page_size
        self.num_pages = num_pages
        self.max_pages_per_seq = max_pages_per_seq
        self.max_prefix = -(-max_prefix // page_size) * page_size
        self.slots = slots
        self.state = init_paged(
            self.model, num_pages, page_size, slots, max_pages_per_seq,
            cache_dtype=cache_dtype,
        )
        self.ticks = 0
        self._poisoned = False

    # -- shared helpers -------------------------------------------------

    def _need_pages(self, req: Request) -> int:
        """Worst-case pages a request holds: prefix plus the horizon-1
        fed-back tokens (the horizon-th prediction needs no tick)."""
        tokens = len(req.progress) - 1 + max(req.horizon - 1, 0)
        return -(-tokens // self.page_size)

    def _prep_np(self, req: Request):
        """numpy ``stream_features`` for one request: ((t, F) feats, t)."""
        deltas = np.diff(np.asarray(req.progress, np.float32))
        oh = np.eye(NUM_STATUSES, dtype=np.float32)[
            np.asarray(req.statuses[1:], np.int64)
        ]
        feats = np.concatenate([deltas[:, None], oh], axis=1)
        t = feats.shape[0]
        if t > self.max_prefix:
            raise ValueError(f"prefix {t} exceeds max_prefix {self.max_prefix}")
        return feats, t

    def _pad_to(self, feats: np.ndarray, width: int) -> np.ndarray:
        return np.pad(feats, ((0, width - feats.shape[0]), (0, 0)))

    def _up(self, arr) -> torch.Tensor:
        return to_device(np.asarray(arr), self.device)

    def _check_not_poisoned(self):
        if self._poisoned:
            raise RuntimeError(
                "batcher state undefined after an earlier mid-run error "
                "— construct a fresh ContinuousBatcher"
            )

    def _check_servable(self, req: Request):
        need = self._need_pages(req)
        if need > self.num_pages or need > self.max_pages_per_seq:
            raise RuntimeError(
                f"page pool exhausted: request needs {need} pages "
                f"(pool {self.num_pages}, per-seq cap "
                f"{self.max_pages_per_seq}) — raise num_pages or shorten "
                f"the horizon"
            )

    def _claim_admissions(self, queue, results, req_of, free_pages, commit):
        """One admission round: claim every (free slot, queued request)
        pair that fits under the page headroom, in queue order. Zero-
        horizon requests resolve at once. Returns (slot, rid, feats, t)
        tuples; raises when nothing is active and the head request can
        never fit."""
        batch = []
        for slot in range(self.slots):
            if not queue or req_of[slot] is not None:
                continue
            rid, req = queue[0]
            if req.horizon <= 0:
                queue.pop(0)
                results[rid] = np.zeros(0, np.float32)
                continue
            self._check_servable(req)
            feats_np, t = self._prep_np(req)
            need = self._need_pages(req)
            free = free_pages()
            if need > free:
                if not any(r is not None for r in req_of):
                    raise RuntimeError(
                        "page pool exhausted: request needs "
                        f"{need} pages but only {free} exist free — "
                        "raise num_pages or lower concurrency"
                    )
                break  # defer until an active request retires
            queue.pop(0)
            batch.append((slot, rid, feats_np, t))
            req_of[slot] = rid
            commit(slot, rid, req, need)
        return batch

    # -- flexible path: per-event scheduling ------------------------------

    def run(self, requests: list[Request]) -> list[np.ndarray]:
        """Per-event scheduling with feedback on the device: admissions
        are one batched prefill per round, the ticks until the next
        retirement run back to back, retirements snapshot forecast rows on
        the device. The only device-to-host read is one packed buffer at
        the end."""
        self._check_not_poisoned()
        try:
            with torch.no_grad():
                return self._run(requests)
        except BaseException:
            self._poisoned = True
            raise

    def _run(self, requests: list[Request]) -> list[np.ndarray]:
        dev = self.device
        queue = list(enumerate(requests))
        results: list = [None] * len(requests)
        cap = max(1, max((r.horizon for r in requests), default=1) - 1)
        carry = _RunCarry(
            torch.zeros((self.slots,), device=dev),
            torch.zeros((self.slots, NUM_STATUSES), device=dev),
            torch.zeros((self.slots, cap), device=dev),
        )
        req_of: list = [None] * self.slots
        remaining = np.zeros(self.slots, np.int64)
        total_need = np.zeros(self.slots, np.int64)  # pages at horizon end
        written = np.zeros(self.slots, np.int64)     # forecast entries
        snap_batches: list = []  # (rids, (R, cap) rows, (R,) tails, widths)

        def free_pages() -> int:
            # held pages cancel between free_top and committed growth, so
            # the worst cases alone give the headroom: no device read
            return self.num_pages - int(total_need.sum())

        def retire_many(done: list[int]):
            idx = self._up(np.asarray(done, np.int32))
            rows = idx.to(torch.int64)
            snap_batches.append((
                [req_of[s] for s in done],
                carry.delta_buf[rows],
                carry.last_pred[rows],
                [int(written[s]) for s in done],
            ))
            self.state = paged_release_many(self.state, idx)
            for s in done:
                req_of[s] = None
                total_need[s] = 0
                written[s] = 0

        def commit(slot, rid, req, need):
            remaining[slot] = req.horizon
            total_need[slot] = need
            written[slot] = 0

        while queue or any(r is not None for r in req_of):
            batch = self._claim_admissions(queue, results, req_of, free_pages, commit)
            if batch:
                t_pad = -(-max(t for *_, t in batch) // self.page_size) * self.page_size
                self.state, carry = _admit_many_carry(
                    self.model, self.state, carry,
                    self._up(np.asarray([s for s, *_ in batch], np.int32)),
                    self._up(np.stack([self._pad_to(f, t_pad) for _, _, f, _ in batch])),
                    self._up(np.asarray([t for *_, t in batch], np.int32)),
                    self._up(np.asarray(
                        [int(requests[r].statuses[-1]) for _, r, _, _ in batch], np.int64
                    )),
                )
                done = [b[0] for b in batch if remaining[b[0]] == 1]
                if done:
                    retire_many(done)  # the admit predictions were the forecasts
            if not any(r is not None for r in req_of):
                continue

            # every tick until the next scheduling event (the earliest
            # retirement), back to back; inactive slots ride along
            active = [r is not None for r in req_of]
            n_chunk = max(
                1, int(min(remaining[s] for s in range(self.slots) if active[s])) - 1
            )
            write_idx = np.where(active, written, cap).astype(np.int32)
            self.state, carry = _tick_chunk(
                self.model, self.state, carry, self._up(write_idx), n_chunk
            )
            self.ticks += n_chunk
            done = []
            for slot in range(self.slots):
                if req_of[slot] is None:
                    continue
                written[slot] += n_chunk
                remaining[slot] -= n_chunk
                if remaining[slot] <= 1:
                    done.append(slot)
            if done:
                retire_many(done)

        # one readback of one buffer: the allocator flag, tails and rows
        if snap_batches:
            rows = torch.cat([b[1] for b in snap_batches])
            tails = torch.cat([b[2] for b in snap_batches])
            packed = torch.cat([
                self.state.alloc_failed.float()[None], tails.float(), rows.reshape(-1),
            ])
            got = packed.cpu().numpy()
            if got[0]:
                raise RuntimeError(self._ALLOCATOR_TRIPPED)
            rids = [rid for b in snap_batches for rid in b[0]]
            widths = [w for b in snap_batches for w in b[3]]
            r = len(rids)
            tails_v = got[1 : 1 + r]
            rows_v = got[1 + r :].reshape(r, cap)
            for i, (rid, w) in enumerate(zip(rids, widths)):
                results[rid] = np.append(rows_v[i, :w], tails_v[i]).astype(np.float32)
        elif bool(self.state.alloc_failed):
            raise RuntimeError(self._ALLOCATOR_TRIPPED)
        return results

    # -- throughput path: waves ------------------------------------------

    def run_waves(self, requests: list[Request], device_results: bool = False) -> list:
        """Fixed-horizon throughput mode: greedy waves of up to ``slots``
        requests, each admitted with one prefill, rolled over the wave's
        longest horizon and released. Page headroom is checked per wave
        with host arithmetic. With ``device_results=True`` the forecasts
        come back as tensors on the device and nothing is read back (the
        caller owns checking ``state.alloc_failed``); otherwise one
        packed readback at the end."""
        self._check_not_poisoned()
        try:
            with torch.no_grad():
                return self._run_waves(requests, device_results)
        except BaseException:
            self._poisoned = True
            raise

    def _run_waves(self, requests: list[Request], device_results: bool) -> list:
        results: list = [None] * len(requests)
        queue = list(enumerate(requests))
        batches: list = []  # (wave members, deltas)

        def pages_at(r, hh):
            return -(-(len(r.progress) - 1 + hh - 1) // self.page_size)

        while queue:
            wave: list = []
            free = self.num_pages  # every wave releases what it admits
            horizon = 0
            while queue and len(wave) < self.slots:
                rid, req = queue[0]
                if req.horizon <= 0:
                    queue.pop(0)
                    results[rid] = np.zeros(0, np.float32)
                    continue
                self._check_servable(req)
                h = max(horizon, req.horizon)
                # members decode h-1 ticks whatever their own horizon, so
                # the pool and each member's table cap are checked at h
                need = pages_at(req, h)
                others = sum(pages_at(r, h) for _, r in wave)
                over_cap = any(
                    pages_at(r, h) > self.max_pages_per_seq
                    for r in [req] + [r for _, r in wave]
                )
                if need + others > free or over_cap:
                    if not wave:
                        raise RuntimeError(
                            f"page pool exhausted: request needs {need} "
                            f"pages but only {free} exist free (per-seq "
                            f"cap {self.max_pages_per_seq})"
                        )
                    break
                queue.pop(0)
                wave.append((rid, req))
                horizon = h
            if not wave:
                continue
            prepped = [self._prep_np(req) for _, req in wave]
            t_pad = -(-max(t for _, t in prepped) // self.page_size) * self.page_size
            feats = np.stack([self._pad_to(p, t_pad) for p, _ in prepped])
            lens = np.asarray([t for _, t in prepped], np.int32)
            stats = np.asarray([int(req.statuses[-1]) for _, req in wave], np.int64)
            horizons = tuple(req.horizon for _, req in wave) if device_results else None
            deltas, self.state = serve_wave(
                self.model, self.state, self._up(feats), self._up(lens),
                self._up(stats), horizon - 1, horizons,
            )
            self.ticks += horizon - 1
            batches.append((wave, deltas))

        if device_results:
            for wave, rows in batches:
                for (rid, _), row in zip(wave, rows):
                    results[rid] = row
            return results

        # one readback for all waves' results and the allocator flag
        packed = torch.cat(
            [self.state.alloc_failed.float()[None]]
            + [d.reshape(-1) for _, d in batches]
        )
        got = packed.cpu().numpy()
        if got[0]:
            raise RuntimeError(self._ALLOCATOR_TRIPPED)
        at = 1
        for wave, d in batches:
            arr = got[at : at + d.numel()].reshape(d.shape)
            at += d.numel()
            for i, (rid, req) in enumerate(wave):
                results[rid] = np.asarray(arr[i, : req.horizon], np.float32)
        return results
