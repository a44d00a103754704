"""Chunked draft verification, commit and paged rollback (the device half),
plus the host-side acceptance rules.

Port of the reference's ``spec/verify.py``. Two verify paths score one
``(slots, W, F)`` chunk per round, W = max draft + 1 (row 0 carries the
already-verified pending token, rows 1.. the drafts):

- dense-gather (:func:`spec_verify_step`): each slot's pages are gathered
  into a dense bf16 context and the chunk runs through the per-row
  causal-offset dense-cache forward; all W kv columns are scattered into
  freshly popped pages, and :func:`paged_rollback` truncates the rejected
  suffix afterwards. Plain PyTorch; no kernel runs.
- fused (:func:`spec_verify_chunk`, :func:`spec_commit_step`,
  :func:`spec_verify_commit`): the chunk attends the pools in place through
  :func:`~beholder_tpu_torch.ops.paged_attention.paged_chunk_attention`
  (the CUDA kernel on the card, one launch per layer) and nothing is
  written; the next round's commit writes exactly the accepted columns.

Pools are updated in place (a :class:`PagedKVState` handed in is consumed),
and nothing here reads the card back: the scheduler's one packed readback a
round carries the predictions and the sticky allocator flag.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from beholder_tpu_torch.models.sequence import _pool_write_column
from beholder_tpu_torch.models.serving import (
    PagedKVState,
    _pool_geometry,
    _pop_pages,
    _unref_pages,
)
from beholder_tpu_torch.ops.paged_attention import ChunkPagedInfo, PagedInfo, QuantizedPool
from beholder_tpu_torch.ops.quant import pool_scales_f32


def _gather_dense(pool, page_table: torch.Tensor) -> torch.Tensor:
    """(num_pages, Hkv, Dh, page) pool rows -> (slots, Hkv, P*page, Dh) dense
    bf16 contexts through each slot's page table row (dequantized as ``f32 *
    scale`` rounded to bf16 under quantized pools)."""
    ids = page_table.to(torch.int64)
    if isinstance(pool, QuantizedPool):
        g = (pool.values[ids].float()
             * pool_scales_f32(pool.scales[ids])[:, :, :, None, :]).to(torch.bfloat16)
    else:
        g = pool[ids].to(torch.bfloat16)                     # (S, P, Hkv, Dh, page)
    s, p, hkv, dh, page = g.shape
    return g.permute(0, 2, 1, 4, 3).reshape(s, hkv, p * page, dh)


def _alloc_chunk(state: PagedKVState, pos: torch.Tensor, writes: torch.Tensor):
    """Pop a page for every chunk position in ``writes`` that opens one
    (``pos % page == 0``) and enter it in the table: the reference's
    ``.at[rows, clip(pidx)].set(pages, mode="drop")``. Returns (state,
    (S*W,) write pages, ``num_pages`` where not ``writes``: dropped)."""
    num_pages, page = _pool_geometry(state)
    slots, max_pages = state.page_table.shape
    w = pos.shape[1]
    need = writes & (pos % page == 0)
    pages, new_top, ref, failed = _pop_pages(state, need.reshape(-1))
    pages = pages.reshape(slots, w)
    pidx = pos // page
    failed = failed | (need & (pidx >= max_pages)).any()
    col = pidx.clamp(0, max_pages - 1)
    cols = torch.arange(max_pages, device=pos.device)
    hit = need[:, :, None] & (col[:, :, None] == cols)                # (S, W, P)
    src = torch.argmax(hit.to(torch.int32), dim=1)                   # (S, P)
    table = torch.where(hit.any(dim=1), torch.gather(pages, 1, src), state.page_table)
    write_pages = torch.where(writes, torch.gather(table, 1, col), num_pages)
    state = state._replace(
        page_table=table, free_top=new_top, page_ref=ref, alloc_failed=failed
    )
    return state, write_pages.reshape(-1)


def spec_verify_step(
    model,
    state: PagedKVState,
    chunk_feats: torch.Tensor,
    active: torch.Tensor,
):
    """Score one ``(slots, W, F)`` chunk against every slot's paged context.

    For each active slot: pop pages covering the W tentative writes, gather
    its dense context, run the chunk through the per-row causal-offset
    forward, scatter all W kv columns into the pool, advance ``seq_lens`` by
    W. Inactive slots ride along (no pops, dropped writes, ignored outputs).
    Returns ((slots, W) predictions, state); the host accepts a prefix and
    calls :func:`paged_rollback` with the surviving lengths."""
    _, page = _pool_geometry(state)
    slots, max_pages = state.page_table.shape
    s, w, _ = chunk_feats.shape
    if s != slots:
        raise ValueError(f"chunk batch {s} != slots {slots}")
    dev = chunk_feats.device
    lens = state.seq_lens
    pos = lens[:, None].to(torch.int64) + torch.arange(w, device=dev)  # write positions
    state, write_pages = _alloc_chunk(state, pos, active[:, None].expand(s, w))

    ks = tuple(_gather_dense(p, state.page_table) for p in state.k_pools)
    vs = tuple(_gather_dense(p, state.page_table) for p in state.v_pools)
    preds, kvs = model(chunk_feats, cache=(ks, vs, lens))

    # scatter all W columns (tentatively: the rollback truncates the rest)
    safe_pos = pos.clamp(0, max_pages * page - 1)
    info = PagedInfo(state.page_table, lens, write_pages, (pos % page).reshape(-1))
    rows = torch.arange(s, device=dev)[:, None]

    def cols(a):
        # (S, Hkv, Lmax, Dh) -> the chunk's columns (S*W, Hkv, Dh)
        return a[rows, :, safe_pos, :].reshape(s * w, a.shape[1], a.shape[3])

    for layer, (k_dense, v_dense) in enumerate(kvs):
        _pool_write_column(state.k_pools[layer], info, cols(k_dense))
        _pool_write_column(state.v_pools[layer], info, cols(v_dense))
    return preds, state._replace(seq_lens=lens + w * active.to(torch.int32))


def spec_verify_chunk(
    model,
    state: PagedKVState,
    chunk_feats: torch.Tensor,
    live_pages: int | None = None,
):
    """Fused verify, read-only: the ``(slots, W, F)`` chunk attends every
    slot's pages in place through the paged chunk kernel (no pops, no pool
    writes, no ``seq_lens`` advance); its own kv stays in the returned
    per-layer ``(slots, Hkv, W, Dh)`` tensors for :func:`spec_commit_step`.
    ``live_pages`` bounds the table columns the kernel reads (None: all).
    On CPU tensors the predictions are bitwise :func:`spec_verify_step`'s
    (the chunk kernel's plain version runs the dense path's op sequence at
    the dense width). Returns ((slots, W) predictions, per-layer (k, v))."""
    _, page = _pool_geometry(state)
    slots, max_pages = state.page_table.shape
    s = chunk_feats.shape[0]
    if s != slots:
        raise ValueError(f"chunk batch {s} != slots {slots}")
    info = ChunkPagedInfo(state.page_table, state.seq_lens, max_pages * page, live_pages)
    return model(chunk_feats, cache=(state.k_pools, state.v_pools, info))


def spec_verify_commit(
    model,
    state: PagedKVState,
    chunk_feats: torch.Tensor,
    prev_kvs,
    prev_accepts: torch.Tensor,
    live_pages: int | None = None,
):
    """One fused round: commit the previous round's accepted prefix
    (:func:`spec_commit_step`), then score this round's chunk against the
    just-committed context (:func:`spec_verify_chunk`).
    ``prev_accepts[s] == 0`` marks nothing to commit (first round, inactive
    or retired slot: a retiring slot's last chunk is never written). Returns
    ((slots, W) predictions, this round's per-layer kv chunks, state)."""
    accepts = prev_accepts.to(torch.int32)
    state = spec_commit_step(state, prev_kvs, accepts, accepts > 0)
    preds, kvs = spec_verify_chunk(model, state, chunk_feats, live_pages=live_pages)
    return preds, kvs, state


def spec_commit_step(
    state: PagedKVState,
    kvs,
    accepts: torch.Tensor,
    active: torch.Tensor,
) -> PagedKVState:
    """Commit a fused round's accepted prefix: pop pages for the
    ``accepts[s]`` columns slot ``s`` keeps, write exactly those columns
    through :func:`~beholder_tpu_torch.models.sequence._pool_write_column`
    (the cast or quantization every pool write uses), advance ``seq_lens``
    by the accepted count. The committed pool bytes are those
    :func:`spec_verify_step`'s scatter-then-rollback leaves; rejected columns
    are never written and no page is popped for them."""
    _, page = _pool_geometry(state)
    slots = state.page_table.shape[0]
    w = kvs[0][0].shape[2]
    lens = state.seq_lens
    dev = lens.device
    accepts = accepts.to(torch.int32)
    steps = torch.arange(w, device=dev)
    pos = lens[:, None].to(torch.int64) + steps                      # (S, W)
    keep = active[:, None] & (steps[None, :] < accepts[:, None])
    state, write_pages = _alloc_chunk(state, pos, keep)
    info = PagedInfo(state.page_table, lens, write_pages, (pos % page).reshape(-1))

    def cols(a):
        # (S, Hkv, W, Dh) -> (S*W, Hkv, Dh), the values spec_verify_step
        # takes from its dense kv at the chunk positions
        return a.transpose(1, 2).reshape(slots * w, a.shape[1], a.shape[3])

    for layer, (k_chunk, v_chunk) in enumerate(kvs):
        _pool_write_column(state.k_pools[layer], info, cols(k_chunk))
        _pool_write_column(state.v_pools[layer], info, cols(v_chunk))
    return state._replace(seq_lens=lens + torch.where(active, accepts, 0))


def paged_rollback(
    state: PagedKVState, new_lens: torch.Tensor, active: torch.Tensor
) -> PagedKVState:
    """Truncate every active slot to ``new_lens[s]`` tokens (at most its
    current length), returning pages wholly past the new end to the free
    stack in one refcount-aware unref: a page the slot shares (a fork, a
    prefix-cache pin) survives at refcount >= 1. Inactive slots are
    untouched."""
    _, page = _pool_geometry(state)
    max_pages = state.page_table.shape[1]
    old = state.seq_lens
    new_lens = new_lens.to(old.dtype)
    first_dead = (new_lens + page - 1) // page                       # ceil
    n_old = (old + page - 1) // page
    cols = torch.arange(max_pages, device=old.device)
    dead = (
        active[:, None]
        & (cols[None, :] >= first_dead[:, None])
        & (cols[None, :] < n_old[:, None])
    )
    state = _unref_pages(state, state.page_table.reshape(-1), dead.reshape(-1))
    return state._replace(seq_lens=torch.where(active, torch.minimum(new_lens, old), old))


# -- host-side acceptance ----------------------------------------------------


def greedy_accept(
    drafts: np.ndarray, preds: np.ndarray, tol: float = 0.0
) -> tuple[int, np.ndarray]:
    """Greedy accept-longest-prefix. ``preds[i]`` is the verifier's next
    token given the pending token and ``drafts[:i]``. Returns (accepted
    count m, the m + 1 emitted tokens: the accepted drafts plus
    ``preds[m]``). ``tol == 0`` demands bitwise agreement; ``tol > 0``
    accepts a finite draft within ``tol`` of the prediction."""
    drafts = np.asarray(drafts, np.float32)
    preds = np.asarray(preds, np.float32)
    m = 0
    emitted: list[float] = []
    for i in range(drafts.shape[0]):
        d, p = drafts[i], preds[i]
        ok = (d == p) if tol == 0.0 else (
            math.isfinite(float(d)) and abs(float(d) - float(p)) <= tol
        )
        if not ok:
            break
        emitted.append(float(d))
        m += 1
    emitted.append(float(preds[m]))
    return m, np.asarray(emitted, np.float32)


def _gauss_logpdf_ratio(x: float, mu_num: float, mu_den: float, tau: float) -> float:
    """log( N(x; mu_num, tau) / N(x; mu_den, tau) )."""
    return ((x - mu_den) ** 2 - (x - mu_num) ** 2) / (2.0 * tau * tau)


def residual_sample(
    mu_p: float, mu_q: float, tau: float, rng: np.random.Generator,
    max_tries: int = 256,
) -> float:
    """Sample the normalized residual ``max(0, p - q)`` of ``p = N(mu_p,
    tau)``, ``q = N(mu_q, tau)`` by rejection: draw ``y ~ p``, keep it with
    probability ``1 - min(1, q(y)/p(y))``. The try cap only guards
    ``mu_p == mu_q`` (a residual of measure zero), where a target sample is
    the limit."""
    for _ in range(max_tries):
        y = float(rng.normal(mu_p, tau))
        keep = 1.0 - math.exp(min(0.0, _gauss_logpdf_ratio(y, mu_q, mu_p, tau)))
        if rng.random() < keep:
            return y
    return float(rng.normal(mu_p, tau))


def speculative_sample(
    preds: np.ndarray,
    draft_means: np.ndarray,
    drafts: np.ndarray,
    tau: float,
    rng: np.random.Generator,
) -> tuple[int, np.ndarray]:
    """Temperature-mode speculative sampling over shared-sigma Gaussians:
    ``drafts[i] ~ N(draft_means[i], tau)``, target ``N(preds[i], tau)``.
    Each draft is accepted with probability ``min(1, p(x)/q(x))``; the first
    rejection is replaced by a residual sample, full acceptance earns a
    bonus target sample. Each emitted token is distributed as a direct
    target sample. Returns (accepted count m, the m + 1 emitted tokens)."""
    if tau <= 0:
        raise ValueError(f"speculative_sample needs tau > 0, got {tau}")
    drafts = np.asarray(drafts, np.float32)
    draft_means = np.asarray(draft_means, np.float32)
    preds = np.asarray(preds, np.float32)
    emitted: list[float] = []
    m = 0
    for i in range(drafts.shape[0]):
        x = float(drafts[i])
        log_ratio = _gauss_logpdf_ratio(x, float(preds[i]), float(draft_means[i]), tau)
        if math.log(max(rng.random(), 1e-300)) < min(0.0, log_ratio):
            emitted.append(x)
            m += 1
            continue
        emitted.append(residual_sample(float(preds[i]), float(draft_means[i]), tau, rng))
        return m, np.asarray(emitted, np.float32)
    emitted.append(float(rng.normal(float(preds[m]), tau)))
    return m, np.asarray(emitted, np.float32)
