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
run. :meth:`ContinuousBatcher.run` reads one packed buffer at its end, plus
one page-table readback per admission round when it keeps a prefix cache;
:meth:`ContinuousBatcher.run_waves` with ``device_results=True`` reads
nothing.

Ported: cold admission (dense prefill, or ``fused=True`` through the paged
chunk kernel of ``csrc/paged_chunk.cu``), prefix-hit admission
(:func:`paged_admit_with_prefix`, dense or fused) with the automatic prefix
cache (:class:`beholder_tpu_torch.cache.PrefixCache`: lookup, pinning,
eviction under pool pressure), forks (:func:`paged_fork`,
:func:`fork_wave`, :meth:`ContinuousBatcher.run_what_if`), the batcher's
``run`` / ``run_waves``, speculative decoding (``spec=``,
:meth:`ContinuousBatcher.run_spec`; the loop lives in
:mod:`beholder_tpu_torch.spec.scheduler`), the bounded intake
(``submit`` / ``run_pending``), request deadlines, and the instruments:
serving metrics, tracer spans and the flight recorder, all off by default
and all on the host clock; and the shard-aware pool ops the cluster
(:mod:`beholder_tpu_torch.cluster`) serves through: an off-pool prefill
into page chunks (:func:`kv_prefill_chunks`), their adoption into another
pool (:func:`paged_adopt_chunks`), and the raw page move of a drain
(:func:`paged_export_pages` / :func:`paged_import_pages`); the cluster
fabric's admission hook (``prefix_fetcher``) and its record of served
request shapes (``seen_request_shapes``); and the pool ops of a decode group
(:mod:`beholder_tpu_torch.cluster.group`), whose layers hold one pool per
member, each a contiguous slice of the kv heads on its member's device:
every op here writes, imports and exports such a layer member by member
(:func:`_slice_chunk_heads`), and the wire format stays full-head; and the
chunk kernel's autotune table (``autotune_table=``,
:mod:`beholder_tpu_torch.ops.autotune`).
"""

from __future__ import annotations

import functools
import time
from contextlib import contextmanager, nullcontext
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from beholder_tpu_torch.control.admission import Preempted
from beholder_tpu_torch.device import resolve_device, to_device
from beholder_tpu_torch.metrics import get_or_create
from beholder_tpu_torch.obs.roofline import model_flops_per_token
from beholder_tpu_torch.ops import NUM_STATUSES, autotune
from beholder_tpu_torch.ops.paged_attention import (
    ChunkPagedInfo,
    GroupSpec,
    PagedInfo,
    QuantizedPool,
    pool_dtype_family,
)
from beholder_tpu_torch.ops.quant import E8M0_BIAS, pool_quantize, pool_scales_f32
from beholder_tpu_torch.reliability.shed import SHED_OVERSIZED, IntakeQueue
from beholder_tpu_torch.spec import SpecConfig
from beholder_tpu_torch.tracing import current_trace_id, from_traceparent

from .sequence import TelemetrySequenceModel, _pool_device, index_put_dropping_, one_hot


class PagedKVState(NamedTuple):
    """Paged serving state; every tensor has a fixed shape.

    - ``k_pools``/``v_pools``: per-layer (num_pages, Hkv, Dh, page) bf16
      pools, or :class:`QuantizedPool` (int8 + f32 scales, fp8 + uint8
      E8M0 scales); in a decode group each layer is a tuple of member
      pools, member ``m`` holding its slice of the kv heads;
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


def _members(pool) -> bool:
    """Whether a layer's pool is a decode group's tuple of member pools."""
    return not torch.is_tensor(pool) and not isinstance(pool, QuantizedPool)


def _pool_geometry(state: PagedKVState) -> tuple[int, int]:
    """(num_pages, page_size) of the state's pools."""
    p0 = state.k_pools[0]
    if _members(p0):
        p0 = p0[0]
    vals = p0.values if isinstance(p0, QuantizedPool) else p0
    return vals.shape[0], vals.shape[3]


def _slice_chunk_heads(chunk, size: int, m: int, device):
    """Member ``m`` of ``size``'s kv-head slice of a full-head chunk, on
    ``device``: (n, Hkv, ...) values, or a ``(values, scales)`` pair, both
    with heads on dim 1. Pages cross the wire full-head, and each member
    keeps its slice. Slicing commutes with the per-(head, token)
    quantization, so a member's pool bytes are the full pool's slice."""
    if isinstance(chunk, tuple):
        return tuple(_slice_chunk_heads(c, size, m, device) for c in chunk)
    hloc = chunk.shape[1] // size
    return chunk[:, m * hloc:(m + 1) * hloc].to(device)


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


def _one_hot_counts(ids: torch.Tensor, n: int) -> torch.Tensor:
    """How often each of ``0..n-1`` occurs in ``ids`` (int32): the
    counterpart of ``.at[ids].add(1, mode="drop")``; ids outside the range
    count nowhere."""
    rows = torch.arange(n, device=ids.device)
    return (ids.to(torch.int64)[:, None] == rows[None, :]).sum(dim=0, dtype=torch.int32)


def _on_device(x, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """``x`` (a Python number or a tensor) as a 1-element tensor on
    ``device``. A number is filled in on the device: ``torch.as_tensor`` would
    copy it up from pageable memory, which synchronises."""
    if torch.is_tensor(x):
        return x.to(device=device, dtype=dtype).reshape(1)
    return torch.full((1,), x, dtype=dtype, device=device)


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
    held = torch.where(alive_flat, held_flat.to(torch.int64), num_pages)
    ref = state.page_ref - _one_hot_counts(held, num_pages)
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
    model: TelemetrySequenceModel, state: PagedKVState, feats_t: torch.Tensor,
    group: GroupSpec | None = None,
):
    """One decode step for all slots: ``feats_t`` is (slots, FEATURES);
    inactive slots run too (their writes drop, their outputs are
    ignored, and they pass the -1 length so the kernel reads none of
    their pages). ``group`` runs the step over a decode group's member
    pools. Returns ((slots,) predictions, updated state)."""
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
        feats_t[:, None, :], cache=(state.k_pools, state.v_pools, info), group=group
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
    is quantized; a group's member pools each take their head slice."""
    if _members(pool):
        return tuple(
            _write_chunks(p, drop_pages.to(_pool_device(p)),
                          _slice_chunk_heads(chunks, len(pool), m, _pool_device(p)))
            for m, p in enumerate(pool)
        )
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
    group: GroupSpec | None = None,
):
    """Admit a wave of requests with one prefill: ``feats_padded`` (n,
    T_max, F) with a page-multiple T_max, ``slot_ids``/``prefix_lens``
    (n,). A request with ``prefix_lens[i] == 0`` is skipped. Allocates
    ceil(len/page) pages per request and writes the prefix kv into them.

    ``fused=False`` runs the dense prefill (``return_kv``); ``fused=True``
    runs the same forward through the paged chunk kernel with an empty
    context (lens 0, width T_max: the dense branch's width), so each chunk
    attends itself causally and no dense per-wave context is built. Both
    return the chunk's own kv columns, written below the same way. Under
    a decode group (member pools) the dense prefill runs at full width and
    each member writes its head slice; ``fused`` needs ``group`` there.
    Returns ((n,) last predictions, state)."""
    num_pages, page = _pool_geometry(state)
    slots, max_pages = state.page_table.shape
    n, t_max, _ = feats_padded.shape
    if t_max % page:
        raise ValueError(f"padded prefix {t_max} not a page multiple ({page})")
    p_max = t_max // page
    dev = feats_padded.device

    prefix_lens = prefix_lens.to(torch.int32)
    # the head runs at each request's last row, at `slots` rows whatever n
    # is: a request's prediction does not depend on its batch
    head = dict(last=(prefix_lens - 1).clamp(0, t_max - 1), head_rows=slots)
    if fused:
        info = ChunkPagedInfo(
            torch.zeros((n, 1), dtype=torch.int32, device=dev),
            torch.zeros((n,), dtype=torch.int32, device=dev),
            t_max,
        )
        last_pred, kvs = model(feats_padded, cache=(state.k_pools, state.v_pools, info),
                               group=group, **head)
    else:
        last_pred, kvs = model(feats_padded, return_kv=True, **head)

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
        _on_device(slot, torch.int32, dev),
        feats_padded,
        _on_device(prefix_len, torch.int32, dev),
    )
    return preds[0], state


def paged_admit_with_prefix(
    model: TelemetrySequenceModel,
    state: PagedKVState,
    slot,
    suffix_feats: torch.Tensor,
    suffix_len,
    cached_pages: torch.Tensor,
    fused: bool = False,
    group: GroupSpec | None = None,
):
    """Admit one request whose first ``len(cached_pages) * page`` tokens are
    already in the pool (a prefix-cache hit): prefill only the suffix.

    ``suffix_feats`` is the (1, S_max, F) page-multiple-padded feature tail,
    ``suffix_len`` how many of its rows are real (>= 1), ``cached_pages``
    the (P_hit,) chain of pool pages holding the prefix, root-first.

    ``fused=False`` (the oracle) gathers the hit pages into a dense (1, Hkv,
    T_hit + S_max, Dh) bf16 context (dequantized under quantized pools) and
    runs the suffix through the scalar-index dense-cache forward;
    ``fused=True`` attends the cached pages in place through the paged
    chunk kernel at the same width. Either way the suffix kv goes into
    freshly popped pages as :func:`paged_admit_batch` writes them, and the
    slot takes one reference on every adopted page (the cache's own
    reference keeps it resident after the slot retires).

    ``group`` runs the fused forward over a decode group's member pools.
    A group's warm admission is fused only: a member holds a slice of the
    heads, so there is no full-head context to gather for the dense path
    (and fused differs from dense on the card, ROADMAP C.4).
    Returns ((,) last prediction, state)."""
    if group is not None and not fused:
        raise ValueError(
            "group-parallel prefix-hit admission requires fused=True "
            "(the dense context gather cannot run on a head slice)"
        )
    num_pages, page = _pool_geometry(state)
    slots, max_pages = state.page_table.shape
    _, s_max, _ = suffix_feats.shape
    if s_max % page:
        raise ValueError(f"padded suffix {s_max} not a page multiple ({page})")
    dev = suffix_feats.device
    cached_pages = cached_pages.to(torch.int32)
    p_hit = cached_pages.shape[0]
    t_hit = p_hit * page
    p_sfx = s_max // page
    suffix_len = _on_device(suffix_len, torch.int32, dev).reshape(())
    # the head at the last suffix row, at `slots` rows, as a cold admit runs it
    head = dict(last=(suffix_len - 1).clamp(0, s_max - 1).reshape(1), head_rows=slots)

    if fused:
        info = ChunkPagedInfo(
            cached_pages[None, :],
            torch.full((1,), t_hit, dtype=torch.int32, device=dev),
            t_hit + s_max,
        )
        last_pred, kvs = model(suffix_feats, cache=(state.k_pools, state.v_pools, info),
                               group=group, **head)
    else:
        ids = cached_pages.to(torch.int64)

        def ctx_cache(pool):
            if isinstance(pool, QuantizedPool):
                g = (
                    pool.values[ids].float()
                    * pool_scales_f32(pool.scales[ids])[:, :, None, :]
                ).to(torch.bfloat16)
            else:
                g = pool[ids].to(torch.bfloat16)              # (P, Hkv, Dh, page)
            hkv, dh = g.shape[1], g.shape[2]
            buf = torch.zeros((1, hkv, t_hit + s_max, dh), dtype=torch.bfloat16, device=dev)
            buf[0, :, :t_hit] = g.permute(1, 0, 3, 2).reshape(hkv, t_hit, dh)
            return buf

        last_pred, kvs = model(
            suffix_feats,
            cache=(
                tuple(ctx_cache(p) for p in state.k_pools),
                tuple(ctx_cache(p) for p in state.v_pools),
                torch.tensor(t_hit, dtype=torch.int64, device=dev),
            ),
            **head,
        )
    last_pred = last_pred.reshape(())

    n_sfx_pages = (suffix_len + page - 1) // page
    chunk_alive = torch.arange(p_sfx, device=dev) < n_sfx_pages
    pages, new_top, ref, failed = _pop_pages(state, chunk_alive)
    failed = failed | (p_hit + n_sfx_pages > max_pages)
    drop = torch.where(chunk_alive, pages, num_pages)

    def chunks(a):
        # the suffix's (Hkv, S_max, Dh) columns -> (p_sfx, Hkv, Dh, page):
        # the fused path returns exactly those, the dense path its whole
        # updated context
        a = a[0] if fused else a[0, :, t_hit:]
        hkv, _, dh = a.shape
        return a.transpose(1, 2).reshape(hkv, dh, p_sfx, page).permute(2, 0, 1, 3)

    k_pools = tuple(
        _write_chunks(pool, drop, chunks(k)) for pool, (k, _) in zip(state.k_pools, kvs)
    )
    v_pools = tuple(
        _write_chunks(pool, drop, chunks(v)) for pool, (_, v) in zip(state.v_pools, kvs)
    )
    # adopted pages: one more reference each, for this slot
    ref = ref + _one_hot_counts(cached_pages, num_pages)

    row = torch.cat([
        cached_pages,
        torch.where(chunk_alive, pages, 0),
        torch.zeros((max(0, max_pages - p_hit - p_sfx),), dtype=torch.int32, device=dev),
    ])[:max_pages]
    sid = _on_device(slot, torch.int64, dev).clamp(0, slots - 1)
    one = torch.ones((1,), dtype=torch.bool, device=dev)
    return last_pred, state._replace(
        k_pools=k_pools,
        v_pools=v_pools,
        page_table=_scatter_small(state.page_table, sid, row[None], one),
        seq_lens=_scatter_small(state.seq_lens, sid, (t_hit + suffix_len).reshape(1), one),
        active=_scatter_small(state.active, sid, True, one),
        free_top=new_top,
        page_ref=ref,
        alloc_failed=failed,
    )


def kv_prefill_chunks(
    model: TelemetrySequenceModel,
    feats_padded: torch.Tensor,
    prefix_len,
    page_size: int,
    *,
    head_rows: int,
):
    """Prefill ONE request off-pool for a prefill -> decode handoff
    (:mod:`beholder_tpu_torch.cluster`): the dense prefill forward
    :func:`paged_admit_batch` runs, but the kv comes back as page chunks
    instead of being written into this worker's pool. The chunks are the
    transpose :func:`paged_admit_batch` feeds :func:`_write_chunks`, in the
    forward's dtype, so :func:`paged_adopt_chunks` on another pool writes
    the bits a colocated admit would. ``head_rows`` is the destination
    pool's slot count: :func:`paged_admit_batch` runs the head at that many
    rows, and so must this, for the prediction's bits to match.

    ``feats_padded`` is (1, T_max, F) with a page-multiple T_max. Returns
    ((,) last prediction, per-layer k chunks, per-layer v chunks), each
    chunk (p_max, Hkv, Dh, page)."""
    n, t_max, _ = feats_padded.shape
    if n != 1:
        raise ValueError(f"kv_prefill_chunks takes ONE request, got {n}")
    if t_max % page_size:
        raise ValueError(f"padded prefix {t_max} not a page multiple ({page_size})")
    p_max = t_max // page_size
    dev = feats_padded.device
    last = (_on_device(prefix_len, torch.int32, dev) - 1).clamp(0, t_max - 1)
    preds, kvs = model(feats_padded, return_kv=True, last=last, head_rows=head_rows)
    last_pred = preds.reshape(())

    def chunks(a):
        # (1, Hkv, T_max, Dh) -> (p_max, Hkv, Dh, page): paged_admit_batch's n == 1
        hkv, dh = a.shape[1], a.shape[3]
        a = a.transpose(2, 3).reshape(1, hkv, dh, p_max, page_size)
        return a.permute(0, 3, 1, 2, 4).reshape(p_max, hkv, dh, page_size)

    return (
        last_pred,
        tuple(chunks(k) for k, _ in kvs),
        tuple(chunks(v) for _, v in kvs),
    )


def paged_adopt_chunks(
    state: PagedKVState,
    slot,
    chunks_k: tuple,
    chunks_v: tuple,
    n_pages,
    seq_len,
) -> PagedKVState:
    """Admit one request whose prefill kv arrives as page chunks from
    another worker (:func:`kv_prefill_chunks`): pop ``n_pages`` pages off
    this pool's free stack, write the chunks through :func:`_write_chunks`
    (cast or quantize as a local prefill would), and install the slot's
    page-table row, length and active bit. Chunk rows past ``n_pages`` drop,
    as :func:`paged_admit_batch`'s dead rows do. The chunks arrive
    full-head; a decode group's members each write their head slice."""
    num_pages, _ = _pool_geometry(state)
    slots, max_pages = state.page_table.shape
    dev = state.seq_lens.device
    p_max = chunks_k[0].shape[0]
    n_pages = _on_device(n_pages, torch.int32, dev).reshape(())
    chunk_alive = torch.arange(p_max, device=dev) < n_pages
    pages, new_top, ref, failed = _pop_pages(state, chunk_alive)
    failed = failed | (n_pages > max_pages)
    drop = torch.where(chunk_alive, pages, num_pages)
    k_pools = tuple(_write_chunks(pool, drop, ck) for pool, ck in zip(state.k_pools, chunks_k))
    v_pools = tuple(_write_chunks(pool, drop, cv) for pool, cv in zip(state.v_pools, chunks_v))
    row = torch.cat([
        torch.where(chunk_alive, pages, 0),
        torch.zeros((max(0, max_pages - p_max),), dtype=torch.int32, device=dev),
    ])[:max_pages]
    sid = _on_device(slot, torch.int64, dev).clamp(0, slots - 1)
    one = torch.ones((1,), dtype=torch.bool, device=dev)
    return state._replace(
        k_pools=k_pools,
        v_pools=v_pools,
        page_table=_scatter_small(state.page_table, sid, row[None], one),
        seq_lens=_scatter_small(state.seq_lens, sid, _on_device(seq_len, torch.int32, dev), one),
        active=_scatter_small(state.active, sid, True, one),
        free_top=new_top,
        page_ref=ref,
        alloc_failed=failed,
    )


def paged_export_pages(state: PagedKVState, page_ids: torch.Tensor):
    """Pages ``page_ids`` (n,) in pool representation, for a live migration
    (:func:`beholder_tpu_torch.cluster.failover.migrate_pool`): raw 8-bit
    values and their scales under quantized pools, raw bf16 rows otherwise,
    with no dequantize/requantize round trip. Each is a gather into a new
    tensor, so nothing later done to the source pages reaches the export.
    Returns per-layer (k chunks, v chunks); a quantized layer's chunk is a
    ``(values, scales)`` pair. A decode group's members are merged back
    into the full-head chunk (a concatenation along the heads, on
    ``page_ids``' device): the wire format is one."""
    ids = page_ids.to(torch.int64)

    def take(pool):
        if _members(pool):
            parts = [take_one(p, ids.to(_pool_device(p))) for p in pool]
            if isinstance(parts[0], tuple):
                return tuple(
                    torch.cat([x[i].to(ids.device) for x in parts], dim=1) for i in range(2)
                )
            return torch.cat([x.to(ids.device) for x in parts], dim=1)
        return take_one(pool, ids)

    def take_one(pool, ids):
        if isinstance(pool, QuantizedPool):
            return (pool.values[ids], pool.scales[ids])
        return pool[ids]

    return tuple(take(p) for p in state.k_pools), tuple(take(p) for p in state.v_pools)


def paged_import_pages(
    state: PagedKVState,
    chunks_k: tuple,
    chunks_v: tuple,
    n_pages,
    refs: torch.Tensor,
):
    """Adopt migrated pages into this pool: pop ``n_pages`` pages, write the
    exported chunks verbatim (the byte-identical twin of
    :func:`paged_export_pages`) and install the source refcounts ``refs``
    (n,), so prefix sharing, cache references and forks survive the move.
    Rows past ``n_pages`` drop; a decode group's members each take their
    head slice of the full-head chunks. Returns (state, dest_ids):
    ``dest_ids[i]`` is the page now holding chunk row ``i`` (garbage past
    ``n_pages``)."""
    num_pages, _ = _pool_geometry(state)
    dev = state.seq_lens.device
    first = chunks_k[0][0] if isinstance(chunks_k[0], tuple) else chunks_k[0]
    p_max = first.shape[0]
    n_pages = _on_device(n_pages, torch.int32, dev).reshape(())
    chunk_alive = torch.arange(p_max, device=dev) < n_pages
    pages, new_top, ref, failed = _pop_pages(state, chunk_alive)
    drop = torch.where(chunk_alive, pages, num_pages)

    def put(pool, chunk, drop=drop, alive=chunk_alive):
        if _members(pool):
            return tuple(
                put(p, _slice_chunk_heads(chunk, len(pool), m, _pool_device(p)),
                    drop.to(_pool_device(p)), alive.to(_pool_device(p)))
                for m, p in enumerate(pool)
            )
        if isinstance(pool, QuantizedPool):
            values, scales = chunk
            index_put_dropping_(pool.values, (drop,), values, alive)
            index_put_dropping_(pool.scales, (drop,), scales, alive)
            return pool
        index_put_dropping_(pool, (drop,), chunk, alive)
        return pool

    k_pools = tuple(put(pool, ck) for pool, ck in zip(state.k_pools, chunks_k))
    v_pools = tuple(put(pool, cv) for pool, cv in zip(state.v_pools, chunks_v))
    # _pop_pages seeded the popped pages at refcount 1; migrated pages carry
    # their source counts instead (shared pages stay shared)
    ref = _scatter_small(ref, drop, torch.where(chunk_alive, refs.to(torch.int32), 1), chunk_alive)
    return (
        state._replace(
            k_pools=k_pools, v_pools=v_pools, free_top=new_top, page_ref=ref,
            alloc_failed=failed,
        ),
        pages,
    )


def cache_ref_pages(
    state: PagedKVState, page_ids: torch.Tensor, alive: torch.Tensor
) -> PagedKVState:
    """Take the prefix cache's one reference on each freshly indexed page
    (``page_ids`` where ``alive``): slot release then leaves the page
    resident at refcount >= 1, a cold cached page."""
    num_pages, _ = _pool_geometry(state)
    ids = torch.where(alive, page_ids.to(torch.int64), num_pages)
    return state._replace(page_ref=state.page_ref + _one_hot_counts(ids, num_pages))


def cache_unref_pages(
    state: PagedKVState, page_ids: torch.Tensor, alive: torch.Tensor
) -> PagedKVState:
    """Drop the cache's reference on evicted pages. A page still shared
    with a live or forked slot stays off the free stack (the allocator's
    unref pushes only pages whose count reaches zero)."""
    return _unref_pages(state, page_ids, alive)


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
        state, _on_device(slot, torch.int32, dev)
    )


def paged_fork(state: PagedKVState, src, dst_slots: torch.Tensor) -> PagedKVState:
    """Fork slot ``src``'s sequence into each slot of ``dst_slots``
    (distinct, not containing ``src``). Every full page of the source is
    shared by reference (+1 per fork): a slot only writes at its own
    length, past every full page. A partial tail page will take the forks'
    writes, so each fork gets its own copy of it, in a freshly popped page.
    Destinations become active at the source's length. The pools are
    updated in place; the source tail page is read (copied out) before any
    destination page is written."""
    num_pages, page = _pool_geometry(state)
    _, max_pages = state.page_table.shape
    dev = state.seq_lens.device
    dst = dst_slots.to(torch.int64)
    k = dst.shape[0]
    if k == 0:
        return state
    src_i = _on_device(src, torch.int64, dev)
    length = state.seq_lens.index_select(0, src_i)                   # (1,)
    n_full = length // page
    src_row = state.page_table.index_select(0, src_i)[0]            # (max_pages,)
    cols = torch.arange(max_pages, device=dev)

    # the full prefix pages: one more reference per fork
    share_alive = cols < n_full
    shared = torch.where(share_alive, src_row.to(torch.int64), num_pages)
    state = state._replace(page_ref=state.page_ref + k * _one_hot_counts(shared, num_pages))

    # one fresh page per fork for the tail copy (none when there is no tail)
    need = ((length % page) != 0).expand(k)
    pages, new_top, ref, failed = _pop_pages(state, need)
    tail_col = n_full.clamp(0, max_pages - 1)                        # (1,)
    src_tail = src_row.index_select(0, tail_col).to(torch.int64).clamp(0, num_pages - 1)
    dest = torch.where(need, pages, num_pages)

    def copy_tail(pool):
        for part in ((pool.values, pool.scales) if isinstance(pool, QuantizedPool) else (pool,)):
            src_page = part.index_select(0, src_tail)  # a copy, read first
            index_put_dropping_(part, (dest,), src_page.expand(k, *part.shape[1:]), need)
        return pool

    rows = torch.where(share_alive, src_row, 0)[None, :].expand(k, max_pages)
    rows = torch.where((cols[None, :] == tail_col) & need[:, None], pages[:, None], rows)
    every = torch.ones((k,), dtype=torch.bool, device=dev)
    return state._replace(
        k_pools=tuple(copy_tail(p) for p in state.k_pools),
        v_pools=tuple(copy_tail(p) for p in state.v_pools),
        page_table=_scatter_small(state.page_table, dst, rows, every),
        seq_lens=_scatter_small(state.seq_lens, dst, length.expand(k), every),
        active=_scatter_small(state.active, dst, True, every),
        free_top=new_top,
        page_ref=ref,
        alloc_failed=failed,
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


def fork_wave(
    model: TelemetrySequenceModel,
    state: PagedKVState,
    feats_padded: torch.Tensor,
    prefix_len,
    branch_statuses: torch.Tensor,
    n_ticks: int,
):
    """What-if forecasting: prefill one telemetry prefix once (slot 0),
    :func:`paged_fork` it into ``k - 1`` more slots, pin each slot's status
    one-hot to its own branch (``branch_statuses`` (k,)), roll all branches
    ``n_ticks`` ticks, release. Returns ((k, n_ticks + 1) deltas, state)."""
    k = branch_statuses.shape[0]
    if feats_padded.shape[0] != 1:
        raise ValueError(f"fork_wave takes ONE prefix, got {feats_padded.shape[0]}")
    dev = feats_padded.device
    preds, state = paged_admit_batch(
        model, state, torch.zeros((1,), dtype=torch.int32, device=dev), feats_padded,
        _on_device(prefix_len, torch.int32, dev),
    )
    state = paged_fork(state, 0, torch.arange(1, k, dtype=torch.int32, device=dev))
    deltas, state = _roll_and_release(
        model, state, preds[0].expand(k), branch_statuses, k, n_ticks
    )
    return deltas[:k], state


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


def _admit_cached_carry(
    model, state, carry: _RunCarry, slot, suffix_feats, suffix_len, cached_pages,
    last_status, fused: bool = False, group: GroupSpec | None = None,
):
    """Admit one prefix-cache hit (:func:`paged_admit_with_prefix`) and
    record its prediction and status one-hot in the device carry: the warm
    twin of :func:`_admit_many_carry`. ``fused`` routes the suffix forward
    through the paged chunk kernel (a decode group's ``group`` needs it)."""
    pred, state = paged_admit_with_prefix(
        model, state, slot, suffix_feats, suffix_len, cached_pages, fused=fused, group=group
    )
    sid = (slot.to(torch.int64).reshape(1),)
    return state, carry._replace(
        last_pred=carry.last_pred.index_put(sid, pred.float().reshape(1)),
        status_oh=carry.status_oh.index_put(
            sid, one_hot(last_status.reshape(1), NUM_STATUSES)
        ),
    )


def _adopt_chunks_carry(
    state, carry: _RunCarry, slot, chunks_k, chunks_v, n_pages, seq_len, pred, last_status
):
    """Admit one transferred request (:func:`paged_adopt_chunks`) and record
    its prefill prediction and status one-hot in the device carry: the
    handoff twin of :func:`_admit_many_carry`, with the same casts, so the
    carry seed is the bits a colocated admit would set. ``slot``,
    ``n_pages``, ``seq_len`` and ``last_status`` may be Python integers:
    they are then filled in on the device, never copied up."""
    state = paged_adopt_chunks(state, slot, chunks_k, chunks_v, n_pages, seq_len)
    dev = state.seq_lens.device
    sid = (_on_device(slot, torch.int64, dev),)
    return state, carry._replace(
        last_pred=carry.last_pred.index_put(sid, pred.float().reshape(1)),
        status_oh=carry.status_oh.index_put(
            sid, one_hot(_on_device(last_status, torch.int64, dev), NUM_STATUSES)
        ),
    )


def _tick_with_carry(model, state, carry: _RunCarry, write_idx: torch.Tensor,
                     group: GroupSpec | None = None):
    """One decode tick for all slots, feedback on the device: append each
    active slot's pending prediction to its forecast row (inactive slots
    pass ``write_idx == cap``, which matches no column), run the tick,
    keep the new predictions."""
    cap = carry.delta_buf.shape[1]
    cols = torch.arange(cap, device=write_idx.device)
    hit = cols[None, :] == write_idx.to(torch.int64)[:, None]
    buf = torch.where(hit, carry.last_pred[:, None], carry.delta_buf)
    feats_t = torch.cat([carry.last_pred[:, None], carry.status_oh], dim=-1)
    preds, state = paged_decode_tick(model, state, feats_t, group=group)
    return state, carry._replace(last_pred=preds.float(), delta_buf=buf)


def _tick_chunk(model, state, carry: _RunCarry, write_idx: torch.Tensor, n: int,
                group: GroupSpec | None = None):
    """``n`` decode ticks between two scheduling events; tick i writes
    forecast column ``write_idx + i`` (the cap sentinel stays out of
    range)."""
    cap = carry.delta_buf.shape[1]
    for i in range(n):
        cur = torch.where(write_idx >= cap, cap, write_idx + i)
        state, carry = _tick_with_carry(model, state, carry, cur, group=group)
    return state, carry


class Request(NamedTuple):
    progress: np.ndarray   # (T+1,) observed progress
    statuses: np.ndarray   # (T+1,) observed statuses
    horizon: int
    #: optional :class:`~beholder_tpu_torch.reliability.policy.Deadline`:
    #: once it expires the batcher retires the request with a
    #: :class:`DeadlineExceededResult` (checked at claim and at every
    #: tick-chunk boundary). None changes nothing.
    deadline: object = None
    #: optional tenant id: the tenant-fair intake
    #: (:class:`~beholder_tpu_torch.control.TenantFairQueue`) schedules by
    #: it, and the recorder's ``req.claim`` instant carries it. None changes
    #: nothing.
    tenant: str | None = None
    #: optional W3C ``traceparent`` of the span that caused this request:
    #: its ``req.claim`` instant then carries that trace id. None changes
    #: nothing.
    traceparent: str | None = None


class DeadlineExceededResult:
    """Terminal outcome of a request whose deadline expired before its
    horizon completed. ``tokens`` holds the forecast prefix that was
    decoded (empty when the deadline expired before the claim)."""

    __slots__ = ("tokens",)
    outcome = "deadline_exceeded"

    def __init__(self, tokens: np.ndarray | None = None):
        self.tokens = tokens if tokens is not None else np.zeros(0, np.float32)

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return f"DeadlineExceededResult(tokens={len(self.tokens)})"


class _ServingMetrics:
    """Prometheus series of one batcher, registered only when a registry is
    handed to :class:`ContinuousBatcher`. Every value comes from the
    scheduler's host bookkeeping: no device reads."""

    #: rounds span sub-ms dispatches to a readback's wait
    ROUND_BUCKETS = (
        0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5,
    )
    RUN_BUCKETS = (0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0)
    TOKEN_BUCKETS = (
        1e-5, 2.5e-5, 5e-5, 1e-4, 2.5e-4, 5e-4, 1e-3, 2.5e-3, 5e-3, 1e-2, 0.1,
    )

    def __init__(self, registry, num_pages: int):
        # get_or_create: a replacement batcher re-attaches to the existing
        # series; a name held by another kind raises here, not mid-run
        self.pool_pages_free = get_or_create(
            registry, "gauge",
            "beholder_serving_pool_pages_free",
            "KV pages not reserved by any in-flight request",
        )
        self.slots_active = get_or_create(
            registry, "gauge",
            "beholder_serving_slots_active",
            "Serving slots holding an in-flight request",
        )
        self.requests_total = get_or_create(
            registry, "counter",
            "beholder_serving_requests_total",
            "Requests fully served by the paged serving layer",
        )
        self.tokens_total = get_or_create(
            registry, "counter",
            "beholder_serving_tokens_total",
            "Forecast tokens decoded by the paged serving layer",
        )
        # device_results mode returns unchecked device tensors (the caller
        # owns the alloc_failed check), so its work counts as dispatched,
        # never as served
        self.requests_dispatched_total = get_or_create(
            registry, "counter",
            "beholder_serving_requests_dispatched_total",
            "Requests dispatched in device_results mode (unverified by "
            "the end-of-run allocator check)",
        )
        self.tokens_dispatched_total = get_or_create(
            registry, "counter",
            "beholder_serving_tokens_dispatched_total",
            "Forecast tokens dispatched in device_results mode "
            "(unverified by the end-of-run allocator check)",
        )
        self.round_seconds = get_or_create(
            registry, "histogram",
            "beholder_serving_round_duration_seconds",
            "Wall time of one scheduling round by phase "
            "(admit/tick/retire/wave/readback)",
            labelnames=["phase"],
            buckets=self.ROUND_BUCKETS,
        )
        self.run_seconds = get_or_create(
            registry, "histogram",
            "beholder_serving_run_duration_seconds",
            "End-to-end scheduler call wall time by mode",
            labelnames=["mode"],
            buckets=self.RUN_BUCKETS,
        )
        self.token_seconds = get_or_create(
            registry, "histogram",
            "beholder_serving_token_latency_seconds",
            "Per-token wall time of one scheduler call (run wall time / "
            "forecast tokens produced)",
            labelnames=["mode"],
            buckets=self.TOKEN_BUCKETS,
        )
        self.pool_pages_free.set(num_pages)
        # the pool-pressure gauges register on their first feed, so an
        # exposition rendered before any run keeps its series set
        self._registry = registry
        self._pool_frag = None
        self._tenant_pages = None
        self._tenants_seen: set = set()

    def pool_pressure(self, free: int, claimable: int, committed: dict | None = None) -> None:
        """Feed the pool gauges: ``free`` pages, ``claimable`` (the largest
        run of them one request could claim now: bounded by the per-sequence
        page cap and a free slot), ``committed`` (tenant -> pages reserved
        by its in-flight requests). Fragmentation renders as ``claimable /
        free``."""
        if self._pool_frag is None:
            self._pool_frag = get_or_create(
                self._registry, "gauge",
                "beholder_serving_pool_fragmentation",
                "Largest single-request-claimable free page run over "
                "free pages (1 = unfragmented; < 1 = free pages "
                "stranded behind the per-seq cap or slot exhaustion)",
            )
        self._pool_frag.set(round(min(claimable, free) / free, 6) if free > 0 else 1.0)
        if committed is None or (not committed and self._tenant_pages is None):
            # the tenant series registers once a tenanted request commits
            # pages: an untenanted run adds no empty family
            return
        if self._tenant_pages is None:
            self._tenant_pages = get_or_create(
                self._registry, "gauge",
                "beholder_serving_tenant_committed_pages",
                "KV pages committed to a tenant's in-flight requests",
                labelnames=["tenant"],
            )
        for tenant, pages in committed.items():
            label = str(tenant)
            self._tenants_seen.add(label)
            self._tenant_pages.set(float(pages), tenant=label)
        # a tenant whose last request retired reads 0
        for label in self._tenants_seen - {str(t) for t in committed}:
            self._tenant_pages.set(0.0, tenant=label)

    def pool_pressure_from(self, free, req_of, requests, total_need, page_cap) -> None:
        """:meth:`pool_pressure` from the scheduler loops' bookkeeping:
        ``req_of`` (slot -> rid or None), ``requests`` (rid-indexable),
        ``total_need`` (per-slot pages at horizon end) and the per-sequence
        page cap."""
        slot_open = any(r is None for r in req_of)
        claimable = min(free, page_cap) if slot_open and free > 0 else 0
        committed: dict[str, int] = {}
        for slot, rid in enumerate(req_of):
            if rid is None:
                continue
            tenant = getattr(requests[rid], "tenant", None)
            if tenant is None:
                continue
            label = str(tenant)
            committed[label] = committed.get(label, 0) + int(total_need[slot])
        self.pool_pressure(free, claimable, committed)

    def occupancy(self, slots_active: int, free, req_of, requests, total_need,
                  page_cap) -> None:
        """The slot, free-page and pool-pressure gauges at one update
        site."""
        self.slots_active.set(slots_active)
        self.pool_pages_free.set(free)
        self.pool_pressure_from(free, req_of, requests, total_need, page_cap)

    def served(self, n_requests: int, n_tokens: int) -> None:
        self.requests_total.inc(n_requests)
        self.tokens_total.inc(n_tokens)

    def dispatched(self, n_requests: int, n_tokens: int) -> None:
        self.requests_dispatched_total.inc(n_requests)
        self.tokens_dispatched_total.inc(n_tokens)

    def observe_round(self, phase: str, seconds: float, trace_id: str | None = None) -> None:
        # trace_id: the exemplar link; the round span closes before this
        # observation lands, so the batcher passes the id it captured
        self.round_seconds.observe(seconds, exemplar_trace_id=trace_id, phase=phase)

    def observe_run(
        self, mode: str, seconds: float, n_tokens: int, trace_id: str | None = None
    ) -> None:
        self.run_seconds.observe(seconds, exemplar_trace_id=trace_id, mode=mode)
        if n_tokens > 0:
            self.token_seconds.observe(seconds / n_tokens, exemplar_trace_id=trace_id, mode=mode)

    def idle(self, num_pages: int) -> None:
        self.slots_active.set(0)
        self.pool_pages_free.set(num_pages)
        # a drained pool owes no tenant anything
        if self._tenant_pages is not None:
            for label in self._tenants_seen:
                self._tenant_pages.set(0.0, tenant=label)


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
    the kernel's launch count against ``layers * ticks``;
    ``admission_rounds`` counts the rounds of :meth:`run` that admitted
    requests (with a prefix cache, each reads the page table back once).

    ``prefix_cache`` (a :class:`beholder_tpu_torch.cache.PrefixCache` with
    the same page size) turns on automatic prefix caching in :meth:`run`:
    each admit looks up its longest cached page chain and prefills only
    the rest (:func:`paged_admit_with_prefix`), through the paged chunk
    kernel when ``fused_verify`` is set. ``fused_wave`` admits each
    :meth:`run_waves` wave through the chunk kernel instead of the dense
    prefill. Served forecasts are the same either way. ``autotune_table``
    (``instance.serving.autotune.table``) points the chunk kernel's launch
    configs at that table (:func:`beholder_tpu_torch.ops.autotune.configure`):
    process-global, as the table belongs to the card it was measured on;
    every config gives the same bits.

    ``spec`` (a :class:`beholder_tpu_torch.spec.SpecConfig`) turns on
    :meth:`run_spec`, draft-then-verify decoding over the same pool;
    ``fused_verify`` then also selects the fused verify (the chunk attends
    the pools in place through the paged chunk kernel) over the dense-gather
    one. ``verify_rounds`` counts the verify rounds run.

    ``max_pending``/``max_pending_pages`` (or an explicit ``intake``, a
    :class:`~beholder_tpu_torch.reliability.shed.IntakeQueue`) put a bounded
    queue in front of the schedulers: :meth:`submit` returns an explicit
    accept/shed outcome and :meth:`run_pending` drains and serves.

    Instruments, each off by default (off, nothing is registered and the
    streams are the same bits as on):

    - ``metrics`` (a :class:`~beholder_tpu_torch.metrics.Registry`, or any
      object with a ``.registry``): pool and slot gauges, served and
      dispatched counters, round, run and per-token histograms;
    - ``tracer`` (a :class:`~beholder_tpu_torch.tracing.Tracer`): one span a
      scheduler call (``serving.run``, ``serving.run_waves``,
      ``serving.what_if``, ``serving.run_spec``) with a child span a round;
    - ``flight_recorder`` (a :class:`~beholder_tpu_torch.obs.FlightRecorder`):
      one event a phase (claim, admit, draft, tick or wave, verify,
      readback, rollback, retire) and instants for prefix lookups, stalls,
      request claims and retirements, spec outcomes and deadline expiries;
      dispatch rounds carry kernel-attribution tags. It also takes the
      autotune table's ``autotune.table_bad`` report (process-global:
      :func:`beholder_tpu_torch.ops.autotune.set_recorder`).

    All of them read host clocks and host bookkeeping only: they add no
    synchronising call. On the card a round's time is its dispatch time.
    """

    #: the :class:`~beholder_tpu_torch.ops.paged_attention.GroupSpec` of a
    #: decode group (:mod:`beholder_tpu_torch.cluster.group`), whose warm
    #: admissions and ticks run over member pools; None for one device
    group: GroupSpec | None = None

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
        metrics=None,
        tracer=None,
        intake=None,
        max_pending: int | None = None,
        max_pending_pages: int | None = None,
        prefix_cache=None,
        spec=None,
        flight_recorder=None,
        fused_verify: bool = False,
        fused_wave: bool = False,
        autotune_table: str | None = None,
        device=None,
    ):
        if spec is not None and not isinstance(spec, SpecConfig):
            raise TypeError(
                f"spec must be a beholder_tpu_torch.spec.SpecConfig, got {type(spec).__name__}"
            )
        if prefix_cache is not None and prefix_cache.page_size != page_size:
            raise ValueError(
                f"prefix_cache page_size {prefix_cache.page_size} != "
                f"batcher page_size {page_size}"
            )
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
        self.admission_rounds = 0
        self.verify_rounds = 0
        self.spec = spec
        self._poisoned = False
        self._registry = getattr(metrics, "registry", metrics) if metrics is not None else None
        self._metrics = (
            _ServingMetrics(self._registry, num_pages) if metrics is not None else None
        )
        self._tracer = tracer
        if intake is None and (max_pending is not None or max_pending_pages is not None):
            intake = IntakeQueue(
                max_pending if max_pending is not None else 2 * slots,
                max_cost=max_pending_pages,
                cost_fn=self._need_pages,
                metrics=self._registry,
            )
        self.intake = intake
        self.flight_recorder = flight_recorder
        if flight_recorder is not None:
            autotune.set_recorder(flight_recorder)
        if autotune_table is not None:
            # before the first chunk launch resolves a config; None leaves
            # the current resolution as it is
            autotune.configure(autotune_table)
        self.prefix_cache = prefix_cache
        #: prefix-hit admissions and spec verify rounds attend the pools in
        #: place through the paged chunk kernel instead of a dense context
        self.fused_verify = bool(fused_verify)
        #: run_waves admits each wave through the paged chunk kernel
        self.fused_wave = bool(fused_wave)
        #: hash chain each live slot holds in the prefix cache; released
        #: at retirement
        self._slot_chain: list[list[bytes]] = [[] for _ in range(slots)]
        #: registered on the first deadline expiry only
        self._deadline_counter = None
        #: per-request notes for the next scheduler call
        #: (:meth:`annotate_requests`), moved into ``_run_notes`` by
        #: ``_start_run``; read only with a flight recorder
        self._timeline_notes: dict[int, dict] = {}
        self._run_notes: dict[int, dict] = {}
        #: the tick-chunk dispatch ``(state, carry, write_idx, n)``: an
        #: attribute of the instance, so fault injection
        #: (:meth:`beholder_tpu_torch.cluster.failover.FailoverEngine.
        #: inject_fault`) can wrap one shard's ticks, and a decode group can
        #: run its own
        self._tick_chunk = functools.partial(_tick_chunk, self.model)
        #: the cluster fabric's admission hook ``(hashes, max_pages,
        #: free_pages)``, called right before the prefix lookup so a chain
        #: cached on another shard can be pulled into this pool and the
        #: local lookup hits it; None leaves admission as it is
        self.prefix_fetcher = None
        #: request geometries :meth:`run` has served, ``(T + 1, horizon) ->``
        #: the most of them in one call (at most ``slots``): the fabric
        #: replays them through a new standby before it can be promoted
        self.seen_request_shapes: dict[tuple[int, int], int] = {}

    # -- shared helpers -------------------------------------------------

    def _need_pages(self, req: Request) -> int:
        """Worst-case pages a request holds: prefix plus the horizon-1
        fed-back tokens (the horizon-th prediction needs no tick). With spec
        on the dense-gather verify path, a verify step writes up to
        ``max_draft`` tokens past the final accepted end before the rollback
        reclaims them, so that transient is budgeted too; the fused verify
        writes accepted tokens only."""
        tokens = len(req.progress) - 1 + max(req.horizon - 1, 0)
        if self.spec is not None and not self.fused_verify:
            tokens += self.spec.max_draft
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

    def _page_id_batch(self, pages: list[int]) -> tuple[torch.Tensor, torch.Tensor]:
        """(ids, alive) padded to the pool width, for the cache's device
        ref/unref."""
        ids = np.zeros(self.num_pages, np.int32)
        alive = np.zeros(self.num_pages, bool)
        ids[: len(pages)] = pages
        alive[: len(pages)] = True
        return self._up(ids), self._up(alive)

    @property
    def transfer_device(self) -> torch.device:
        """The device page transfers to or from this batcher land on: its
        pool's."""
        return self.state.seq_lens.device

    def export_pages(self, page_ids: torch.Tensor):
        """Pages ``page_ids`` in wire representation
        (:func:`paged_export_pages`)."""
        return paged_export_pages(self.state, page_ids)

    def import_pages(self, chunks_k, chunks_v, n_pages, refs):
        """Adopt wire chunks into this pool (:func:`paged_import_pages`).
        Returns (new_state, dest_ids); the caller assigns ``self.state``."""
        return paged_import_pages(self.state, chunks_k, chunks_v, n_pages, refs)

    def _evict_cached(self, n_pages: int) -> int:
        """Reclaim up to ``n_pages`` cold cached pages (LRU leaf-first):
        the index forgets them, then one vectorized unref drops the cache's
        device reference. A page still shared with a live slot survives."""
        pages = self.prefix_cache.evict(n_pages)
        if not pages:
            return 0
        self.state = cache_unref_pages(self.state, *self._page_id_batch(pages))
        return len(pages)

    def _index_admitted(self, admitted: list[tuple[int, list[bytes], int]]):
        """Index one admission round's freshly prefilled full pages: one
        page-table readback (the host must learn where prefill landed),
        then insert and pin each slot's chain and take the cache's one
        device reference on every newly indexed page."""
        idx = self._up(np.asarray([slot for slot, _, _ in admitted], np.int64))
        rows = self.state.page_table[idx].cpu().numpy()
        fresh_pages: list[int] = []
        for (slot, hashes, n_full), row in zip(admitted, rows):
            chain = hashes[:n_full]
            pinned = len(self._slot_chain[slot])  # hit pages, pinned at claim
            new_ids, _ = self.prefix_cache.insert(chain, [int(p) for p in row[:n_full]])
            fresh_pages.extend(new_ids)
            self.prefix_cache.acquire(chain[pinned:])
            self._slot_chain[slot] = chain
        if fresh_pages:
            self.state = cache_ref_pages(self.state, *self._page_id_batch(fresh_pages))

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

    def _count_deadline_exceeded(self, n: int = 1) -> None:
        """Count deadline expiries on
        ``beholder_failover_deadline_exceeded_total``, registered on first
        use only."""
        if self._registry is None:
            return
        if self._deadline_counter is None:
            self._deadline_counter = get_or_create(
                self._registry, "counter",
                "beholder_failover_deadline_exceeded_total",
                "Requests retired with an expired deadline (explicit "
                "deadline_exceeded outcome instead of a wedged slot)",
            )
        self._deadline_counter.inc(n)

    @staticmethod
    def _deadline_expired(req) -> bool:
        deadline = getattr(req, "deadline", None)
        return deadline is not None and deadline.expired

    def _start_run(self, requests: list[Request]):
        """Fail fast before anything is admitted: every request's prefix cap
        and pool/table fit is checked up front, so an unservable request
        cannot raise mid-run with earlier requests' pages held (an error
        that escapes mid-run poisons the batcher). Timeline notes set by
        :meth:`annotate_requests` apply to this call alone."""
        self._check_not_poisoned()
        self._run_notes, self._timeline_notes = self._timeline_notes, {}
        for req in requests:
            if req.horizon <= 0:
                continue
            t = len(req.progress) - 1
            if t > self.max_prefix:
                raise ValueError(f"prefix {t} exceeds max_prefix {self.max_prefix}")
            self._check_servable(req)

    def _claim_admissions(self, queue, results, req_of, free_pages, commit):
        """One admission round: claim every (free slot, queued request)
        pair that fits under the page headroom, in queue order. Zero-
        horizon requests resolve at once, and a request whose deadline
        already expired resolves to :class:`DeadlineExceededResult` without
        a prefill. With a prefix cache, each claim's hit chain is looked up
        and pinned before any pressure eviction this round (eviction must
        never take pages a claim is about to adopt), cold cached pages are
        evicted when the pool is short, pins are released on deferral, and
        hits/misses count once per admission. Returns (slot, rid, feats, t,
        hit_pages, hashes) tuples; raises when nothing is active and the
        head request can never fit. With a flight recorder: one ``claim``
        event, and ``req.claim``, ``prefix_lookup``, ``stall`` and
        ``deadline_exceeded`` instants."""
        cache = self.prefix_cache
        fr = self.flight_recorder
        claim_ts = time.time() if fr is not None else 0.0
        claim_t0 = time.perf_counter()
        claim_tid = current_trace_id() if fr is not None else None
        batch = []
        try:
            for slot in range(self.slots):
                if not queue or req_of[slot] is not None:
                    continue
                rid, req = queue[0]
                if req.horizon <= 0:
                    queue.pop(0)
                    results[rid] = np.zeros(0, np.float32)
                    continue
                if self._deadline_expired(req):
                    # the budget ran out while queued: no prefill, and the
                    # slot goes to a request that can still make it
                    queue.pop(0)
                    results[rid] = DeadlineExceededResult()
                    self._count_deadline_exceeded()
                    if fr is not None:
                        fr.instant("deadline_exceeded", trace_id=claim_tid, stage="claim",
                                   rid=rid, **self._run_notes.get(rid, {}))
                    continue
                self._check_servable(req)
                feats_np, t = self._prep_np(req)
                hit_pages: list[int] = []
                hashes: list[bytes] = []
                pinned: list[bytes] = []
                if cache is not None:
                    hashes = cache.hashes(feats_np)
                    if self.prefix_fetcher is not None and hashes:
                        # the cluster fabric pulls a chain cached on another
                        # shard into this pool, so the lookup below hits
                        self.prefix_fetcher(hashes, (t - 1) // self.page_size, free_pages)
                    hit_pages = cache.lookup(hashes, (t - 1) // self.page_size, record=False)
                    pinned = hashes[: len(hit_pages)]
                    cache.acquire(pinned)
                    if fr is not None:
                        fr.instant("prefix_lookup", trace_id=claim_tid, slot=slot,
                                   hit_pages=len(hit_pages))
                need = self._need_pages(req)
                free = free_pages()
                if need > free and cache is not None:
                    # pool pressure: surrender cold cached pages before deferring
                    free += self._evict_cached(need - free)
                if need > free:
                    if cache is not None:
                        cache.release(pinned)  # not admitted this round
                    if not any(r is not None for r in req_of):
                        raise RuntimeError(
                            "page pool exhausted: request needs "
                            f"{need} pages but only {free} exist free — "
                            "raise num_pages or lower concurrency"
                        )
                    if fr is not None:
                        fr.instant("stall", trace_id=claim_tid, reason="pressure_deferral",
                                   slot=slot, need=int(need), free=int(free))
                    break  # defer until an active request retires
                queue.pop(0)
                if cache is not None:
                    self._slot_chain[slot] = pinned
                    cache.record_admit(hit_pages)
                batch.append((slot, rid, feats_np, t, hit_pages, hashes))
                req_of[slot] = rid
                commit(slot, rid, req, need)
                if fr is not None:
                    # the request's lifecycle marker: a tenant rides along
                    # only when set, and a request's own traceparent names
                    # the trace
                    tenant = getattr(req, "tenant", None)
                    tenant_note = {"tenant": tenant} if tenant is not None else {}
                    req_tid = claim_tid
                    tp = getattr(req, "traceparent", None)
                    if tp is not None:
                        pctx = from_traceparent(str(tp))
                        if pctx is not None:
                            req_tid = f"{pctx.trace_id:032x}"
                    fr.instant("req.claim", trace_id=req_tid, rid=rid, slot=slot,
                               prefix_tokens=int(t), hit_pages=len(hit_pages),
                               horizon=int(req.horizon), **tenant_note,
                               **self._run_notes.get(rid, {}))
        finally:
            if fr is not None:
                fr.record("claim", claim_ts, time.perf_counter() - claim_t0,
                          trace_id=claim_tid, claimed=len(batch), queued=len(queue))
        return batch

    # -- instruments ------------------------------------------------------

    def _run_span(self, operation: str, **tags):
        """Root span of one scheduler call (a nullcontext without a
        tracer)."""
        if self._tracer is None:
            return nullcontext()
        return self._tracer.start_span(operation, tags=tags)

    @staticmethod
    def _span_trace_id(span) -> str | None:
        """The 32-hex trace id of a run span (None for nullcontext): the
        exemplar link for observations made after the span closed."""
        ctx = getattr(span, "context", None)
        return f"{ctx.trace_id:032x}" if ctx is not None else None

    def _kernel_tags(self, family: str, flops: float) -> dict:
        """Roofline-attribution tags for one dispatch round; empty without a
        flight recorder."""
        if self.flight_recorder is None:
            return {}
        return self.flight_recorder.kernel_tags(family, flops)

    @property
    def pool_family(self) -> str:
        """The KV pool's dtype family (``"bf16"``/``"int8"``/``"fp8"``),
        which qualifies the fused verify round's roofline family."""
        pool = self.state.k_pools[0]
        if _members(pool):
            pool = pool[0]
        quantized = isinstance(pool, QuantizedPool)
        return pool_dtype_family(pool.values if quantized else pool, quantized=quantized)

    def _flops_per_token(self, ctx: float) -> float:
        return model_flops_per_token(self.model, ctx)

    @contextmanager
    def _round(self, parent, phase: str, **tags):
        """One scheduling round: a child span of the run span, a
        ``round_duration_seconds{phase=...}`` observation and, with a
        flight recorder, one event carrying the round's tags. The trace id
        is read inside the child span, so the event and the histogram
        exemplar both link to it. Host clocks only."""
        fr = self.flight_recorder
        ts = time.time() if fr is not None else 0.0
        t0 = time.perf_counter()
        cm = (
            self._tracer.start_span(f"serving.{phase}", child_of=parent, tags=tags)
            if self._tracer is not None and parent is not None
            else nullcontext()
        )
        trace_id = None
        try:
            with cm:
                trace_id = current_trace_id()
                yield
        finally:
            dur = time.perf_counter() - t0
            if self._metrics is not None:
                self._metrics.observe_round(phase, dur, trace_id=trace_id)
            if fr is not None:
                fr.record(phase, ts, dur, trace_id=trace_id, **tags)

    def _emit_req_retire(self, rid: int, slot: int, tokens: int, outcome: str = "ok",
                         **extra) -> None:
        """The ``req.retire`` instant every serving loop emits (one copy, so
        its shape cannot drift between loops); caller-set notes win over
        ``extra``."""
        fr = self.flight_recorder
        if fr is None:
            return
        note = {**extra, **self._run_notes.get(rid, {})}
        fr.instant("req.retire", rid=rid, slot=slot, tokens=int(tokens), outcome=outcome,
                   **note)

    def annotate_requests(self, notes: dict[int, dict]) -> None:
        """Attach per-request notes to the next scheduler call:
        ``notes[rid]`` merges into that request's ``req.claim`` and
        ``req.retire`` instants (e.g. ``queue_wait_s``). Read only with a
        flight recorder."""
        self._timeline_notes = dict(notes)

    # -- admission control: bounded intake + shed -----------------------

    def submit(self, request: Request):
        """Offer one request to the bounded intake; returns an
        :class:`~beholder_tpu_torch.reliability.shed.Admission`: accepted,
        or shed with its reason (``queue_full`` / ``cost_backlog`` /
        ``oversized``). A request that could never fit the pool sheds as
        ``oversized`` before any page is touched. Needs ``intake=`` or
        ``max_pending=``."""
        if self.intake is None:
            raise RuntimeError(
                "no intake queue configured — construct the batcher with "
                "max_pending= (or an explicit IntakeQueue) to use submit()"
            )
        need = self._need_pages(request)
        if need > self.num_pages or need > self.max_pages_per_seq:
            return self.intake.shed(SHED_OVERSIZED)
        return self.intake.offer(request, cost=need)

    def run_pending(self, waves: bool | None = None) -> list:
        """Drain the intake and serve everything admitted since the last
        drain, results in admission order: :meth:`run_waves` by default,
        :meth:`run` with a prefix cache (only ``run`` reuses and fills it),
        :meth:`run_spec` with ``spec``; ``waves`` overrides (``False``
        still picks spec when set). A tenant-fair intake's preempted
        requests come after them as
        :class:`~beholder_tpu_torch.control.Preempted` outcomes."""
        if self.intake is None:
            raise RuntimeError("no intake queue configured")
        pending, waits, _ = self.intake.drain_all()
        take_preempted = getattr(self.intake, "take_preempted", None)
        preempted = take_preempted() if take_preempted is not None else []
        tail = [Preempted(tenant) for _, tenant in preempted]
        if not pending:
            return tail
        if self.flight_recorder is not None:
            self.annotate_requests(
                {rid: {"queue_wait_s": round(wait, 6)} for rid, wait in enumerate(waits)}
            )
        if waves is None:
            waves = self.prefix_cache is None and self.spec is None
        if waves:
            return self.run_waves(pending) + tail
        if self.spec is not None:
            return self.run_spec(pending) + tail
        return self.run(pending) + tail

    # -- flexible path: per-event scheduling ------------------------------

    def run(self, requests: list[Request]) -> list[np.ndarray]:
        """Per-event scheduling with feedback on the device: admissions
        are one batched prefill per round, the ticks until the next
        retirement run back to back, retirements snapshot forecast rows on
        the device. The only device-to-host read is one packed buffer at
        the end. A request whose deadline expires comes back as a
        :class:`DeadlineExceededResult`. Each call's request shapes land in
        ``seen_request_shapes``."""
        self._start_run(requests)
        counts: dict[tuple[int, int], int] = {}
        for r in requests:
            key = (len(r.progress), r.horizon)
            counts[key] = counts.get(key, 0) + 1
        for key, n in counts.items():
            self.seen_request_shapes[key] = max(
                self.seen_request_shapes.get(key, 0), min(n, self.slots)
            )
        t0 = time.perf_counter()
        try:
            with torch.no_grad(), self._run_span("serving.run", requests=len(requests)) as span:
                results = self._run(requests, span)
        except BaseException:
            self._poisoned = True
            raise
        if self._metrics:
            self._metrics.observe_run(
                "run", time.perf_counter() - t0, sum(max(r.horizon, 0) for r in requests),
                trace_id=self._span_trace_id(span),
            )
        return results

    def _admit_claimed(self, span, requests, batch, carry) -> _RunCarry:
        """One admission round of :meth:`_run`: the cold admits in one
        batched prefill, each warm (prefix-hit) admit in a forward of its
        own. Returns the carry with the admitted slots seeded."""
        page = self.page_size
        admit_tags = {"requests": len(batch)}
        if self.flight_recorder is not None:
            # prefill FLOPs follow the uncached suffix; t/2 is the
            # mean causal context
            admit_tags.update(self._kernel_tags("flash", sum(
                (b[3] - len(b[4]) * page) * self._flops_per_token(b[3] / 2.0)
                for b in batch
            )))
        with self._round(span, "admit", **admit_tags):
            cold = [b for b in batch if not b[4]]
            warm = [b for b in batch if b[4]]
            if cold:
                # cold admits: one batched prefill
                t_pad = -(-max(b[3] for b in cold) // page) * page
                self.state, carry = _admit_many_carry(
                    self.model, self.state, carry,
                    self._up(np.asarray([b[0] for b in cold], np.int32)),
                    self._up(np.stack([self._pad_to(b[2], t_pad) for b in cold])),
                    self._up(np.asarray([b[3] for b in cold], np.int32)),
                    self._up(np.asarray(
                        [int(requests[b[1]].statuses[-1]) for b in cold], np.int64
                    )),
                )
            for slot, rid, feats_np, t, hit_pages, _ in warm:
                # warm admits: adopt the cached pages, prefill the
                # suffix only (one forward per hit: hit shapes vary)
                t_hit = len(hit_pages) * page
                s_len = t - t_hit
                s_pad = -(-s_len // page) * page
                self.state, carry = _admit_cached_carry(
                    self.model, self.state, carry,
                    self._up(np.asarray([slot], np.int64)),
                    self._up(self._pad_to(feats_np[t_hit:], s_pad)[None]),
                    self._up(np.asarray(s_len, np.int32)),
                    self._up(np.asarray(hit_pages, np.int32)),
                    self._up(np.asarray([int(requests[rid].statuses[-1])], np.int64)),
                    fused=self.fused_verify,
                    group=self.group,
                )
            if self.prefix_cache is not None:
                self.prefix_cache.prefilled(
                    sum(b[3] - len(b[4]) * page for b in batch)
                )
                self._index_admitted([(b[0], b[5], b[3] // page) for b in batch])
        return carry

    def _run(self, requests: list[Request], span=None, admit=None,
             worker: str | None = None) -> list[np.ndarray]:
        """The per-event loop of :meth:`run`. ``admit`` replaces the
        admission round (same signature as :meth:`_admit_claimed`): the
        cluster's disaggregated lane prefills elsewhere and adopts the
        handed-off pages. ``worker`` tags the tick, retire and deadline
        events with the serving worker's name."""
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
        # requests, tokens: counted into the metrics only after the
        # allocator check (a failed run served nothing)
        served = [0, 0]
        #: rids retired by deadline expiry: their results wrap in
        #: DeadlineExceededResult after the readback
        deadline_rids: list[int] = []
        has_deadlines = any(getattr(r, "deadline", None) is not None for r in requests)
        tag = {"worker": worker} if worker is not None else {}

        def free_pages() -> int:
            # held pages cancel between free_top and committed growth, so
            # the worst cases alone give the headroom: no device read. Cold
            # cached pages are reserved too (a page both adopted and cached
            # counts in the slot's need, never in the cold set, so this only
            # ever understates what is free)
            cold = self.prefix_cache.cold_page_count if self.prefix_cache else 0
            return self.num_pages - int(total_need.sum()) - cold

        def occupancy():
            if self._metrics:
                self._metrics.occupancy(sum(r is not None for r in req_of), free_pages(),
                                        req_of, requests, total_need, self.max_pages_per_seq)

        def retire_many(done: list[int], expired: bool = False):
            """Snapshot and release a retirement round; ``expired`` retires
            slots whose deadline ran out, with their partial forecasts."""
            with self._round(span, "retire", slots=len(done)):
                idx = self._up(np.asarray(done, np.int32))
                rows = idx.to(torch.int64)
                rids = [req_of[s] for s in done]
                widths = [int(written[s]) for s in done]
                snap_batches.append((rids, carry.delta_buf[rows], carry.last_pred[rows], widths))
                self.state = paged_release_many(self.state, idx)
                for s in done:
                    req_of[s] = None
                    total_need[s] = 0
                    written[s] = 0
                    if self.prefix_cache is not None and self._slot_chain[s]:
                        # the slot's references are gone; the cache's own keeps
                        # its prefix pages resident as cold entries
                        self.prefix_cache.release(self._slot_chain[s])
                        self._slot_chain[s] = []
                served[0] += len(done)
                if expired:
                    served[1] += sum(w + 1 for w in widths)
                    deadline_rids.extend(rids)
                    self._count_deadline_exceeded(len(done))
                    if self.flight_recorder is not None:
                        self.flight_recorder.instant("deadline_exceeded", stage="tick",
                                                     slots=len(done), **tag)
                else:
                    served[1] += sum(requests[r].horizon for r in rids)
                outcome = "deadline_exceeded" if expired else "ok"
                for s, rid, w in zip(done, rids, widths):
                    self._emit_req_retire(rid, s, w + 1, outcome, **tag)

        def commit(slot, rid, req, need):
            remaining[slot] = req.horizon
            total_need[slot] = need
            written[slot] = 0

        while queue or any(r is not None for r in req_of):
            if has_deadlines:
                # the deadline sweep at a scheduling-event boundary: an
                # expired slot retires now with its partial forecast
                lapsed = [s for s in range(self.slots) if req_of[s] is not None
                          and self._deadline_expired(requests[req_of[s]])]
                if lapsed:
                    retire_many(lapsed, expired=True)
            batch = self._claim_admissions(queue, results, req_of, free_pages, commit)
            if batch:
                self.admission_rounds += 1
                carry = (admit or self._admit_claimed)(span, requests, batch, carry)
                done = [b[0] for b in batch if remaining[b[0]] == 1]
                if done:
                    retire_many(done)  # the admit predictions were the forecasts
            occupancy()
            if not any(r is not None for r in req_of):
                continue

            # every tick until the next scheduling event (the earliest
            # retirement), back to back; inactive slots ride along
            active = [r is not None for r in req_of]
            n_chunk = max(
                1, int(min(remaining[s] for s in range(self.slots) if active[s])) - 1
            )
            write_idx = np.where(active, written, cap).astype(np.int32)
            tick_tags = {"ticks": n_chunk, **tag}
            if self.flight_recorder is not None:
                lens = [len(requests[req_of[s]].progress) - 1 + int(written[s])
                        for s in range(self.slots) if active[s]]
                tick_tags.update(self._kernel_tags(
                    "paged", n_chunk * len(lens) * self._flops_per_token(float(np.mean(lens)))
                ))
            with self._round(span, "tick", **tick_tags):
                self.state, carry = self._tick_chunk(
                    self.state, carry, self._up(write_idx), n_chunk
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
                occupancy()

        # one readback of one buffer: the allocator flag, tails and rows
        if snap_batches:
            with self._round(span, "readback", batches=len(snap_batches)):
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
            for rid in deadline_rids:
                results[rid] = DeadlineExceededResult(results[rid])
        elif bool(self.state.alloc_failed):
            raise RuntimeError(self._ALLOCATOR_TRIPPED)
        if self._metrics:
            self._metrics.served(*served)
        return results

    # -- speculative path: draft-then-verify ------------------------------

    def run_spec(self, requests: list[Request]) -> list[np.ndarray]:
        """Speculative decoding over the paged pool: a drafter proposes up
        to k tokens per slot, one verify round scores them all (dense-gather,
        or fused through the paged chunk kernel with ``fused_verify``), the
        host accepts a prefix per slot. Needs ``spec=``. Results follow
        :meth:`run`'s contract; under greedy exact acceptance the stream does
        not depend on the drafter (see :mod:`beholder_tpu_torch.spec`)."""
        if self.spec is None:
            raise RuntimeError(
                "no spec config — construct the batcher with "
                "spec=SpecConfig(...) to use run_spec()"
            )
        from beholder_tpu_torch.spec.scheduler import run_spec

        return run_spec(self, requests)

    # -- throughput path: waves ------------------------------------------

    def run_waves(self, requests: list[Request], device_results: bool = False) -> list:
        """Fixed-horizon throughput mode: greedy waves of up to ``slots``
        requests, each admitted with one prefill, rolled over the wave's
        longest horizon and released. Page headroom is checked per wave
        with host arithmetic. With ``device_results=True`` the forecasts
        come back as tensors on the device and nothing is read back (the
        caller owns checking ``state.alloc_failed``); otherwise one
        packed readback at the end."""
        self._start_run(requests)
        t0 = time.perf_counter()
        try:
            with torch.no_grad(), self._run_span(
                "serving.run_waves", requests=len(requests), device_results=device_results
            ) as span:
                results = self._run_waves(requests, device_results, span)
        except BaseException:
            self._poisoned = True
            raise
        if self._metrics:
            self._metrics.observe_run(
                "run_waves", time.perf_counter() - t0,
                sum(max(r.horizon, 0) for r in requests), trace_id=self._span_trace_id(span),
            )
        return results

    def _run_waves(self, requests: list[Request], device_results: bool, span=None) -> list:
        results: list = [None] * len(requests)
        queue = list(enumerate(requests))
        batches: list = []  # (wave members, deltas)
        fr = self.flight_recorder

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
                if fr is not None:
                    # claim = wave membership (the wave that follows is the
                    # request's admission and its first token)
                    tenant = getattr(req, "tenant", None)
                    tenant_note = {"tenant": tenant} if tenant is not None else {}
                    fr.instant("req.claim", rid=rid, slot=len(wave) - 1,
                               prefix_tokens=len(req.progress) - 1, horizon=int(req.horizon),
                               **tenant_note, **self._run_notes.get(rid, {}))
            if not wave:
                continue
            wave_tags = {"requests": len(wave), "horizon": horizon}
            if fr is not None:
                # each member's prefill plus horizon-1 ticks at the end-of-wave
                # context
                wave_tags.update(self._kernel_tags("paged", sum(
                    (len(req.progress) - 1) * self._flops_per_token((len(req.progress) - 1) / 2.0)
                    + (horizon - 1) * self._flops_per_token(len(req.progress) - 1 + horizon / 2.0)
                    for _, req in wave
                )))
            with self._round(span, "wave", **wave_tags):
                prepped = [self._prep_np(req) for _, req in wave]
                t_pad = -(-max(t for _, t in prepped) // self.page_size) * self.page_size
                feats = np.stack([self._pad_to(p, t_pad) for p, _ in prepped])
                lens = np.asarray([t for _, t in prepped], np.int32)
                stats = np.asarray([int(req.statuses[-1]) for _, req in wave], np.int64)
                horizons = tuple(req.horizon for _, req in wave) if device_results else None
                deltas, self.state = serve_wave(
                    self.model, self.state, self._up(feats), self._up(lens),
                    self._up(stats), horizon - 1, horizons, fused=self.fused_wave,
                )
                self.ticks += horizon - 1
                batches.append((wave, deltas))
            # the wave released its slots (retired before the readback)
            for slot_i, (rid, req) in enumerate(wave):
                self._emit_req_retire(rid, slot_i, req.horizon)
            if self._metrics:
                # the last dispatched wave's occupancy; the served counters
                # wait for the allocator check
                need = [pages_at(r, horizon) for _, r in wave]
                self._metrics.occupancy(
                    len(wave), self.num_pages - sum(need), [rid for rid, _ in wave],
                    {rid: r for rid, r in wave}, need, self.max_pages_per_seq,
                )

        if self._metrics:
            self._metrics.idle(self.num_pages)
        n_served = sum(len(w) for w, _ in batches)
        t_served = sum(req.horizon for w, _ in batches for _, req in w)
        if device_results:
            # unchecked: the dispatched counters, never the served ones
            if self._metrics:
                self._metrics.dispatched(n_served, t_served)
            for wave, rows in batches:
                for (rid, _), row in zip(wave, rows):
                    results[rid] = row
            return results

        # one readback for all waves' results and the allocator flag
        with self._round(span, "readback", batches=len(batches)):
            packed = torch.cat(
                [self.state.alloc_failed.float()[None]]
                + [d.reshape(-1) for _, d in batches]
            )
            got = packed.cpu().numpy()
        if got[0]:
            raise RuntimeError(self._ALLOCATOR_TRIPPED)
        if self._metrics:
            self._metrics.served(n_served, t_served)
        at = 1
        for wave, d in batches:
            arr = got[at : at + d.numel()].reshape(d.shape)
            at += d.numel()
            for i, (rid, req) in enumerate(wave):
                results[rid] = np.asarray(arr[i, : req.horizon], np.float32)
        return results

    # -- what-if path: one prefix, many hypothetical futures -------------

    def run_what_if(
        self,
        progress: np.ndarray,
        statuses: np.ndarray,
        branch_statuses: list[int],
        horizon: int,
    ) -> np.ndarray:
        """Forecast one observed telemetry stream under ``k`` hypothetical
        status branches: the prefix is prefilled once, its full pages
        shared across branches (:func:`paged_fork`), and all branches roll
        together (:func:`fork_wave`). One packed readback. Returns (k,
        horizon) forecast deltas."""
        k = len(branch_statuses)
        if not 1 <= k <= self.slots:
            raise ValueError(f"branches {k} must be in [1, slots={self.slots}]")
        if horizon < 1:
            raise ValueError(f"horizon must be >= 1, got {horizon}")
        bad = [s for s in branch_statuses if not 0 <= int(s) < NUM_STATUSES]
        if bad:
            # an out-of-range status would one-hot to an all-zeros row
            raise ValueError(f"branch statuses {bad} out of range [0, {NUM_STATUSES})")
        self._check_not_poisoned()
        req = Request(np.asarray(progress), np.asarray(statuses), horizon)
        feats_np, t = self._prep_np(req)
        if t == 0:
            raise ValueError(
                "prefix must contain at least one observed delta "
                "(progress needs >= 2 samples)"
            )
        n_ticks = horizon - 1
        end_pages = -(-(t + n_ticks) // self.page_size)
        shared = t // self.page_size
        need = shared + k * (end_pages - shared)
        if end_pages > self.max_pages_per_seq or need > self.num_pages:
            raise RuntimeError(
                f"page pool exhausted: {k} branches of a {t}-token prefix at "
                f"horizon {horizon} need {need} pages (pool {self.num_pages}, "
                f"per-seq cap {self.max_pages_per_seq})"
            )
        t_pad = -(-t // self.page_size) * self.page_size
        t0 = time.perf_counter()
        try:
            with torch.no_grad(), self._run_span(
                "serving.what_if", branches=k, horizon=horizon
            ) as span:
                with self._round(span, "wave", requests=1, horizon=horizon):
                    deltas, self.state = fork_wave(
                        self.model, self.state,
                        self._up(self._pad_to(feats_np, t_pad)[None]),
                        self._up(np.asarray(t, np.int32)),
                        self._up(np.asarray(branch_statuses, np.int64)),
                        n_ticks,
                    )
                    self.ticks += n_ticks
                with self._round(span, "readback", batches=1):
                    packed = torch.cat([
                        self.state.alloc_failed.float()[None], deltas.float().reshape(-1),
                    ])
                    got = packed.cpu().numpy()
        except BaseException:
            self._poisoned = True
            raise
        if got[0]:
            self._poisoned = True
            raise RuntimeError(self._ALLOCATOR_TRIPPED)
        if self._metrics:
            # one request, k branch rollouts of decode work
            self._metrics.served(1, k * horizon)
            self._metrics.idle(self.num_pages)
            self._metrics.observe_run("what_if", time.perf_counter() - t0, k * horizon,
                                      trace_id=self._span_trace_id(span))
        return got[1:].reshape(k, n_ticks + 1)[:, :horizon].astype(np.float32)
