"""Paged-KV attention: two CUDA kernels for Hopper and their plain versions.

Counterpart of the reference's ``ops/paged_attention.py``. Pools are
``(N, Hkv, Dh, page)`` (tokens minor, the reference's layout), read in
place through a page table.

- :func:`paged_decode_attention`: each slot's single query attends its own
  pages (the decode tick). Kernel ``csrc/paged_decode.cu``, its page walk
  split across blocks by :func:`decode_splits` and merged in the same
  launch; plain version :func:`paged_decode_reference` (the TPU kernel's
  online softmax and dtype mix).
- :func:`paged_chunk_attention`: each slot's W-token chunk attends its
  committed pages plus the chunk's own k/v (prefix-hit and fused-wave
  admission, spec's fused verify). Kernel ``csrc/paged_chunk.cu``, plain version
  :func:`paged_chunk_reference` (the dense path's op sequence over the
  assembled context, :func:`~beholder_tpu_torch.ops.attention.attend`).

On a CUDA tensor each wrapper launches its hand-written kernel (see the
note at the top of each source: what it replaces, what bounds it, how its
design answers that) or raises; it never falls back. On a CPU tensor it
runs the plain version.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from . import autotune
from .attention import attend
from .flash_attention import kernel_width
from .quant import pool_scales_f32

_NEG_INF = -1e30


class QuantizedPool(NamedTuple):
    """Quantized KV page pool: ``values`` (N, Hkv, Dh, page) and per-(head,
    token) ``scales`` (N, Hkv, page) — int8 values with f32 scales, or
    ``float8_e4m3fn`` values with uint8 E8M0 scales."""

    values: torch.Tensor
    scales: torch.Tensor


class PagedInfo(NamedTuple):
    """Per-tick paged-cache bookkeeping handed to the model's blocks:
    ``lens[s]`` tokens are already in slot ``s``'s pages (-1 for a dead
    slot); the tick's kv column goes to page ``write_pages[s]`` (``N`` for
    an inactive slot: the write is dropped) at row ``write_offsets[s]``."""

    page_table: torch.Tensor     # (S, P) int32
    lens: torch.Tensor           # (S,) int32
    write_pages: torch.Tensor    # (S,) int32
    write_offsets: torch.Tensor  # (S,) int32


class ChunkPagedInfo(NamedTuple):
    """Cache index marking a fused chunk-attention forward (``Block``
    dispatches on it as on :class:`PagedInfo`): the ``t >= 1`` chunk
    attends its slot's pool pages in place through
    :func:`paged_chunk_attention`, and the block returns the chunk's own
    (k, v) projections instead of an updated cache, so the caller writes
    exactly the chunk's columns into the pool. No pool write happens in
    the forward.

    - ``page_table``: (S, P) pool page ids; only pages holding positions
      ``< lens[s]`` are read.
    - ``lens``: (S,) — row ``j`` of slot ``s``'s chunk sits at position
      ``lens[s] + j`` and attends positions ``<= lens[s] + j``.
    - ``ctx_len``: attention width, the dense path's buffer width:
      ``P*page + t`` for prefix-hit admission, ``t_max`` for a fused wave.
    - ``live_pages``: optional bound on the table columns read (None = all).
    """

    page_table: torch.Tensor
    lens: torch.Tensor
    ctx_len: int
    live_pages: int | None = None


class GroupSpec(NamedTuple):
    """The group-parallel layout a model forward runs under
    (:mod:`beholder_tpu_torch.cluster.group`): ``size`` members, member
    ``m`` holding KV heads ``[m * Hkv/size, (m + 1) * Hkv/size)`` of every
    paged pool as a contiguous tensor of its own. ``axis`` names the
    reference's mesh axis and is kept for its configs; one controller
    drives every member here, so no collective runs over it."""

    axis: str
    size: int


def pool_dtype_family(pool_values: torch.Tensor, *, quantized: bool) -> str:
    """``"bf16"``, ``"int8"`` or ``"fp8"`` (any other dtype keys by its
    name)."""
    if quantized:
        return "fp8" if pool_values.dtype == torch.float8_e4m3fn else "int8"
    if pool_values.dtype == torch.bfloat16:
        return "bf16"
    return str(pool_values.dtype).removeprefix("torch.")


def paged_decode_reference(
    q: torch.Tensor,
    k_pool: torch.Tensor,
    v_pool: torch.Tensor,
    page_table: torch.Tensor,
    lens: torch.Tensor,
    *,
    window: int | None = None,
    k_scale: torch.Tensor | None = None,
    v_scale: torch.Tensor | None = None,
) -> torch.Tensor:
    """The plain PyTorch version of the kernel: a walk over page columns,
    all slots at once, with the TPU kernel's online softmax (one update
    per page) and dtype mix. Dead rounds (pages outside a slot's live
    range) contribute exact zeros."""
    slots, h, dh = q.shape
    n, hkv, _, page = k_pool.shape
    group = h // hkv
    max_pages = page_table.shape[1]
    quant = k_scale is not None
    scale = float(1.0 / (dh**0.5))
    dev = q.device
    lens = lens.to(torch.int64)
    table = page_table.to(torch.int64)
    n_hi = torch.clamp(torch.div(lens, page, rounding_mode="floor") + 1, max=max_pages)
    if window is None:
        p_lo = torch.zeros_like(lens)
    else:
        p_lo = torch.div(
            torch.clamp(lens - (window - 1), min=0), page, rounding_mode="floor"
        )
    qh = q.to(torch.bfloat16).float().reshape(slots, hkv, group, dh)
    m = torch.full((slots, hkv, group), _NEG_INF, device=dev)
    l = torch.zeros((slots, hkv, group), device=dev)
    acc = torch.zeros((slots, hkv, group, dh), device=dev)
    offs = torch.arange(page, device=dev)
    for i in range(max_pages):
        live_round = (i >= p_lo) & (i < n_hi)                      # (S,)
        pid = table[:, i].clamp(0, n - 1)
        if quant:
            kp = (
                k_pool[pid].float() * pool_scales_f32(k_scale[pid])[:, :, None, :]
            ).to(torch.bfloat16).float()
            vp = (
                v_pool[pid].float() * pool_scales_f32(v_scale[pid])[:, :, None, :]
            ).to(torch.bfloat16).float()
        else:
            kp = k_pool[pid].float()                               # (S,Hkv,Dh,page)
            vp = v_pool[pid].float()
        pos = i * page + offs
        live = (pos[None, :] <= lens[:, None]) & live_round[:, None]
        if window is not None:
            live = live & (pos[None, :] > lens[:, None] - window)
        s_all = torch.matmul(qh, kp)                               # (S,Hkv,G,page)
        if not quant:
            s_all = s_all.to(torch.bfloat16).float()
        s_all = torch.where(live[:, None, None, :], s_all * scale, _NEG_INF)
        m_new = torch.maximum(m, s_all.amax(dim=-1))
        p = torch.exp(s_all - m_new[..., None])
        p = torch.where(s_all <= _NEG_INF / 2, 0.0, p)
        alpha = torch.exp(torch.clamp(m - m_new, max=0.0))
        l = l * alpha + p.sum(dim=-1)
        pv = torch.matmul(p.to(torch.bfloat16).float(), vp.transpose(-1, -2))
        pv = torch.where(live_round[:, None, None, None], pv, 0.0)
        acc = acc * alpha[..., None] + pv
        m = m_new
    out = acc / torch.clamp(l, min=1e-37)[..., None]
    return out.reshape(slots, h, dh).to(q.dtype)


_MODES = {torch.bfloat16: 0, torch.int8: 1, torch.float8_e4m3fn: 2}
_SCALE_DTYPES = {torch.int8: torch.float32, torch.float8_e4m3fn: torch.uint8}
_lib = None

#: tokens of the decode kernel's chunk; a split's run is a whole number of them
DECODE_TILE = 64
#: blocks the split aims for: two waves of the H100's 132 SMs
DECODE_BLOCKS = 264
#: the most splits one launch merges (the kernel refuses more)
DECODE_MAX_SPLITS = 64


class DecodeSplit(NamedTuple):
    """The decode kernel's split: ``splits`` blocks per (slot, kv head),
    split ``j`` reading the table positions ``[j * span, (j + 1) * span)``."""

    splits: int
    span: int


def decode_splits(slots: int, hkv: int, max_pages: int, page: int,
                  window: int | None) -> DecodeSplit:
    """The decode kernel's split, from the shapes alone (never from
    ``lens``, which lives on the card: a launch reads nothing back).

    The table's ``max_pages * page`` positions are cut into runs of whole
    64-token tiles. A slot can hold live positions in at most ``live``
    tiles (all of them, or those a ``window`` can reach), and the runs are
    made as long as keeps about :data:`DECODE_BLOCKS` blocks busy across
    ``slots * hkv`` (slot, kv head) pairs, at most
    :data:`DECODE_MAX_SPLITS` of them. Where the pairs alone fill the card,
    one split."""
    tiles = -(-max_pages * page // DECODE_TILE)
    live = tiles if window is None else min(tiles, -(-window // DECODE_TILE) + 1)
    per = min(tiles, max(1, -(-live * slots * hkv // DECODE_BLOCKS),
                         -(-tiles // DECODE_MAX_SPLITS)))
    return DecodeSplit(-(-tiles // per), per * DECODE_TILE)


#: per (device, stream): the int32 tickets of the split's combine, one per
#: (slot, kv head); zeroed once when made or grown, left zero by each launch.
#: Launches on one stream run in order, so they can share a buffer; two
#: streams get two.
_counters: dict[tuple[int, int], torch.Tensor] = {}


def _split_counters(dev: torch.device, n: int, stream: int) -> torch.Tensor:
    key = (dev.index, stream)
    buf = _counters.get(key)
    if buf is None or buf.numel() < n:
        buf = torch.zeros(n, dtype=torch.int32, device=dev)
        _counters[key] = buf
    return buf


def _kernel_lib() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        from beholder_tpu_torch import csrc

        lib = csrc.load("paged_decode")
        lib.paged_decode_launch.argtypes = (
            [ctypes.c_void_p] * 10
            + [ctypes.c_int] * 11
            + [ctypes.c_float, ctypes.c_void_p]
        )
        lib.paged_decode_launch.restype = ctypes.c_int
        lib.paged_decode_smem_bytes.argtypes = [ctypes.c_int] * 4
        lib.paged_decode_smem_bytes.restype = ctypes.c_size_t
        lib.paged_decode_resources.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p]
        lib.paged_decode_resources.restype = ctypes.c_int
        lib.paged_decode_head_chunks.argtypes = [ctypes.c_int] * 2
        lib.paged_decode_head_chunks.restype = ctypes.c_int
        _lib = lib
    return _lib


def _kernel_mode(bf16_inputs: dict, k_pool, v_pool, page_table, lens, k_scale,
                 v_scale, kernel: str) -> int:
    """Check what a paged kernel takes (bf16 activations, one pool dtype
    with its scale dtype, int32 table and lengths, one slot count, every
    tensor contiguous on the activations' device) and return the pool's
    mode: 0 bf16, 1 int8, 2 fp8."""
    mode = _MODES.get(k_pool.dtype)
    if mode is None:
        raise TypeError(f"no {kernel} kernel for {k_pool.dtype} pools")
    for name, t in bf16_inputs.items():
        if t.dtype != torch.bfloat16:
            raise TypeError(f"the kernel takes bf16 {name}, got {t.dtype}")
    if v_pool.dtype != k_pool.dtype:
        raise TypeError(f"pool dtypes differ: {k_pool.dtype} vs {v_pool.dtype}")
    if (mode == 0) != (k_scale is None):
        raise TypeError("int8/fp8 pools need scales and bf16 pools take none")
    tensors = [*bf16_inputs.values(), k_pool, v_pool, page_table, lens]
    if k_scale is not None:
        want = _SCALE_DTYPES[k_pool.dtype]
        if k_scale.dtype != want or v_scale.dtype != want:
            raise TypeError(f"{k_pool.dtype} pools take {want} scales")
        tensors += [k_scale, v_scale]
    if page_table.dtype != torch.int32 or lens.dtype != torch.int32:
        raise TypeError("page_table and lens must be int32")
    slots = tensors[0].shape[0]
    if lens.shape != (slots,) or page_table.shape[0] != slots:
        raise ValueError(
            f"page_table {tuple(page_table.shape)} / lens {tuple(lens.shape)} "
            f"do not match {slots} slots"
        )
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"all inputs must be on {dev}, got {t.device}")
        if not t.is_contiguous():
            # pools go by data pointer with full-head strides: a group
            # member's pool must be a tensor of its own, never a head view
            raise ValueError("the kernel takes contiguous tensors (a group member's pool "
                             "must be its own tensor, not a view of a full pool)")
    return mode


def _launch(q, k_pool, v_pool, page_table, lens, window, k_scale, v_scale,
            split: DecodeSplit | None = None):
    """Check what the kernel takes, allocate the output (and, with more
    than one split, the partials' workspace), launch on the current
    stream, raise on a launch error. ``split`` overrides
    :func:`decode_splits` (the card checks force one split, or one tile a
    split)."""
    slots, h, dh = q.shape
    n, hkv, _, page = k_pool.shape
    max_pages = page_table.shape[1]
    dev = q.device
    mode = _kernel_mode({"q": q}, k_pool, v_pool, page_table, lens, k_scale, v_scale,
                        "paged decode")
    lib = _kernel_lib()
    smem = lib.paged_decode_smem_bytes(h, hkv, dh, mode)
    if smem == 0:
        raise ValueError(f"the kernel refuses {h} query heads over {hkv} kv heads of {dh}")
    if smem > 227 * 1024:
        raise ValueError(
            f"head_dim {dh} with {h // hkv} query heads per kv head needs {smem} bytes "
            "of shared memory, over the 227 KB a block may have"
        )
    if split is None:
        split = decode_splits(slots, hkv, max_pages, page, window)
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(dev).cuda_stream
    ws = counters = None
    if split.splits > 1:
        ws = torch.empty(slots * hkv * split.splits * (h // hkv) * (dh + 2),
                         dtype=torch.float32, device=dev)
        # one ticket a (slot, head chunk): at most one a query head
        counters = _split_counters(dev, slots * h, stream)
    err = lib.paged_decode_launch(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        k_scale.data_ptr() if k_scale is not None else None,
        v_scale.data_ptr() if v_scale is not None else None,
        page_table.data_ptr(), lens.data_ptr(), out.data_ptr(),
        ws.data_ptr() if ws is not None else None,
        counters.data_ptr() if counters is not None else None,
        slots, h, hkv, dh, page, n, max_pages,
        0 if window is None else window, split.splits, split.span, mode,
        float(1.0 / math.sqrt(dh)), stream,
    )
    if err != 0:
        raise RuntimeError(f"paged_decode kernel launch failed: CUDA error {err}")
    paged_decode_attention.launches += 1
    paged_decode_attention.chunked_launches += lib.paged_decode_head_chunks(h, hkv) > 1
    return out


def _check_pools(h, dh, k_pool, v_pool, k_scale, v_scale, window) -> None:
    """The reference's checks of the pools, scales and window against
    ``h`` query heads of width ``dh``, shared by both paged entry points."""
    n, hkv, dh_p, page = k_pool.shape
    if dh_p != dh:
        raise ValueError(f"head_dim mismatch: q {dh} vs pool {dh_p}")
    if h % hkv:
        raise ValueError(f"q heads {h} must be a multiple of kv heads {hkv}")
    if k_pool.shape != v_pool.shape:
        raise ValueError(
            f"pool shape mismatch: {tuple(k_pool.shape)} vs {tuple(v_pool.shape)}"
        )
    if (k_scale is None) != (v_scale is None):
        raise ValueError("k_scale and v_scale must be given together")
    if k_scale is not None and tuple(k_scale.shape) != (n, hkv, page):
        raise ValueError(
            f"scales must be {(n, hkv, page)}, got {tuple(k_scale.shape)}"
        )
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")


def paged_decode_attention(
    q: torch.Tensor,
    k_pool: torch.Tensor,
    v_pool: torch.Tensor,
    page_table: torch.Tensor,
    lens: torch.Tensor,
    *,
    window: int | None = None,
    k_scale: torch.Tensor | None = None,
    v_scale: torch.Tensor | None = None,
    group: int = 1,
) -> torch.Tensor:
    """Single-token decode attention over a paged KV pool, in place.

    - ``q``: (S, H, Dh) — slot ``s``'s query for position ``lens[s]``,
      whose kv column is already in the pool;
    - ``k_pool``/``v_pool``: (N, Hkv, Dh, page) — bf16; int8 with
      ``k_scale``/``v_scale`` (N, Hkv, page) f32; or fp8 e4m3 with uint8
      E8M0 scales of that shape;
    - ``page_table``: (S, P); entry ``(s, i)`` holds slot ``s``'s positions
      ``[i*page, (i+1)*page)``;
    - ``lens``: (S,) — slot ``s`` attends positions ``0..lens[s]`` (minus
      those at or before ``lens[s] - window``); -1 marks a dead slot,
      which reads no page and returns a zero row;
    - ``group``: the call is one of ``group`` members of a group-parallel
      launch (:class:`GroupSpec`), holding ``Hkv`` of the model's ``group *
      Hkv`` kv heads. The split is the full-head launch's
      (:func:`decode_splits` over ``group * Hkv`` heads): a member's own
      head count would split the walk differently, merge the partials in
      another order and change the bits.

    Any group of ``H / Hkv`` query heads a kv head: over 16 the kernel
    runs it in equal chunks, a block each. Returns (S, H, Dh) in q's
    dtype. CUDA tensors go to the kernel (each launch adds one to
    ``paged_decode_attention.launches``, and to ``.chunked_launches``
    where the group ran in chunks); CPU tensors to
    :func:`paged_decode_reference`."""
    if q.ndim != 3:
        raise ValueError(f"q must be (slots, heads, head_dim), got {tuple(q.shape)}")
    if group < 1:
        raise ValueError(f"group must be >= 1, got {group}")
    _, h, dh = q.shape
    _check_pools(h, dh, k_pool, v_pool, k_scale, v_scale, window)
    if q.is_cuda:
        slots = q.shape[0]
        _, hkv, _, page = k_pool.shape
        split = decode_splits(slots, hkv * group, page_table.shape[1], page, window)
        return _launch(
            q, k_pool, v_pool, page_table.to(torch.int32), lens.to(torch.int32),
            window, k_scale, v_scale, split=split,
        )
    return paged_decode_reference(
        q, k_pool, v_pool, page_table, lens,
        window=window, k_scale=k_scale, v_scale=v_scale,
    )


#: kernel launches since the count was last set to 0, and those of them
#: whose group of query heads ran in chunks (the kernel's
#: paged_decode_head_chunks: more than 16 query heads a kv head)
paged_decode_attention.launches = 0
paged_decode_attention.chunked_launches = 0


# -- paged chunk attention (prefix-hit and fused-wave admission) -------------


def paged_chunk_reference(
    q: torch.Tensor,
    k_chunk: torch.Tensor,
    v_chunk: torch.Tensor,
    k_pool: torch.Tensor,
    v_pool: torch.Tensor,
    page_table: torch.Tensor,
    lens: torch.Tensor,
    *,
    ctx_len: int,
    live_pages: int,
    window: int | None = None,
    k_scale: torch.Tensor | None = None,
    v_scale: torch.Tensor | None = None,
) -> torch.Tensor:
    """The plain PyTorch version of the chunk kernel, the counterpart of the
    reference's ``_chunk_reference`` / ``_chunk_block_math``:

    1. assemble each slot's context as bf16: the first ``live_pages`` table
       columns gathered (quantized pages dequantized as ``f32 * scale`` and
       rounded to bf16), zeros out to ``ctx_len``;
    2. overlay the chunk's own k/v at positions ``lens[s] + j`` (positions
       at or past ``ctx_len`` drop);
    3. attend with the dense path's op sequence (:func:`attend`), row ``j``
       masked causally at ``lens[s] + j`` and by ``window``.

    Positions past a slot's committed length hold stale pool bytes or
    zeros, but every such lane is masked (or overlaid) before the softmax,
    so the kernel, which never reads them, computes the same function."""
    slots, h, w, dh = q.shape
    n, hkv, _, page = k_pool.shape
    dev = q.device
    table = page_table[:, :live_pages].to(torch.int64).clamp(0, n - 1)

    def assemble(pool, scales):
        g = pool[table]                                     # (S, P', Hkv, Dh, page)
        if scales is not None:
            g = (g.float() * pool_scales_f32(scales[table])[:, :, :, None, :]).to(
                torch.bfloat16
            )
        else:
            g = g.to(torch.bfloat16)
        g = g.permute(0, 2, 1, 4, 3).reshape(slots, hkv, live_pages * page, dh)
        # w spare columns past ctx_len take the overlay's dropped writes
        return F.pad(g, (0, 0, 0, ctx_len - live_pages * page + w))

    lens = lens.to(torch.int64)
    pos_w = lens[:, None] + torch.arange(w, device=dev)              # (S, W)
    rows = torch.arange(slots, device=dev)[:, None].expand(slots, w)
    spare = ctx_len + torch.arange(w, device=dev)[None, :].expand(slots, w)
    at = torch.where(pos_w < ctx_len, pos_w, spare).clamp(min=0)

    def overlay(ctx, chunk):
        ctx[rows, :, at, :] = chunk.transpose(1, 2).to(ctx.dtype)
        return ctx[:, :, :ctx_len]

    k_all = overlay(assemble(k_pool, k_scale), k_chunk)
    v_all = overlay(assemble(v_pool, v_scale), v_chunk)
    positions = torch.arange(ctx_len, device=dev)
    live = positions[None, None, :] <= pos_w[:, :, None]             # (S, W, L)
    if window is not None:
        live = live & (positions[None, None, :] > pos_w[:, :, None] - window)
    return attend(q, k_all, v_all, live[:, None, None])


#: the chunk kernel's libraries: ``paged_chunk`` for head dims equal to
#: their width, ``paged_chunk_padded`` for those below it (csrc/paged_chunk.cu)
_chunk_libs: dict[str, ctypes.CDLL] = {}


def _chunk_kernel_lib(name: str = "paged_chunk") -> ctypes.CDLL:
    if name not in _chunk_libs:
        from beholder_tpu_torch import csrc

        lib = csrc.load(name)
        lib.paged_chunk_launch.argtypes = (
            [ctypes.c_void_p] * 10
            + [ctypes.c_int] * 15
            + [ctypes.c_float, ctypes.c_void_p]
        )
        lib.paged_chunk_launch.restype = ctypes.c_int
        _chunk_libs[name] = lib
    return _chunk_libs[name]


def _chunk_launch(q, k_chunk, v_chunk, k_pool, v_pool, page_table, lens, ctx_len,
                  live_pages, window, k_scale, v_scale, row_tiles=1, plant=-1):
    """Check what the chunk kernel takes, allocate the output, launch on
    the current stream, raise on a launch error. ``row_tiles``: 64-row
    query tiles a block (1 or 2; the same bits either way). ``plant``: -1,
    or the row of the kernel's test-only control (its notes), which
    changes the bits of that row's block."""
    slots, h, w, dh = q.shape
    n, hkv, _, page = k_pool.shape
    dev = q.device
    width = kernel_width(dh, "paged chunk")
    chunk = {"q": q, "k_chunk": k_chunk, "v_chunk": v_chunk}
    mode = _kernel_mode(chunk, k_pool, v_pool, page_table, lens, k_scale, v_scale,
                        "paged chunk")
    for name, t in chunk.items():
        if t.data_ptr() % 16:
            raise ValueError(f"the paged chunk kernel takes 16-byte aligned tensors ({name})")
    lib = _chunk_kernel_lib("paged_chunk" if width == dh else "paged_chunk_padded")
    out = torch.empty_like(q)
    err = lib.paged_chunk_launch(
        q.data_ptr(), k_chunk.data_ptr(), v_chunk.data_ptr(),
        k_pool.data_ptr(), v_pool.data_ptr(),
        k_scale.data_ptr() if k_scale is not None else None,
        v_scale.data_ptr() if v_scale is not None else None,
        page_table.data_ptr(), lens.data_ptr(), out.data_ptr(),
        slots, h, hkv, w, dh, width, page, n, page_table.shape[1], live_pages, ctx_len,
        0 if window is None else window, mode, row_tiles, plant,
        # the plain version divides by this f32 value: the kernel divides
        # by the same bits
        torch.sqrt(torch.tensor(float(dh))).item(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"paged_chunk kernel launch failed: CUDA error {err}")
    paged_chunk_attention.launches += 1
    paged_chunk_attention.padded_launches += width != dh
    return out


def paged_chunk_attention(
    q: torch.Tensor,
    k_chunk: torch.Tensor,
    v_chunk: torch.Tensor,
    k_pool: torch.Tensor,
    v_pool: torch.Tensor,
    page_table: torch.Tensor,
    lens: torch.Tensor,
    *,
    ctx_len: int | None = None,
    live_pages: int | None = None,
    window: int | None = None,
    k_scale: torch.Tensor | None = None,
    v_scale: torch.Tensor | None = None,
    config: dict | None = None,
    group: int = 1,
) -> torch.Tensor:
    """Chunk attention against the paged pools, in place.

    - ``q``: (S, H, W, Dh); row ``j`` of slot ``s`` sits at position
      ``lens[s] + j`` and attends positions ``<= lens[s] + j`` (minus those
      at or before ``lens[s] + j - window``);
    - ``k_chunk``/``v_chunk``: (S, Hkv, W, Dh), the chunk's own kv (not in
      the pool: the kernel overlays it);
    - ``k_pool``/``v_pool``/``k_scale``/``v_scale``: the pools, as
      :func:`paged_decode_attention` takes them;
    - ``page_table``: (S, P); ``lens``: (S,) committed tokens per slot;
    - ``ctx_len``: attention width (default ``P * page``; prefix-hit
      admission passes ``P * page + W``);
    - ``live_pages``: bound on the table columns read (default all);
    - ``config``: an explicit ``{"row_tiles_per_block": n}``; by default
      the shape's entry in the autotune table (:mod:`.autotune`) or its
      defaults. Every config gives the same bits: it moves time only. The
      plain version takes none;
    - ``group``: the call is one of ``group`` members of a group-parallel
      forward (:class:`GroupSpec`), on its own slice of the kv heads. It
      picks the table's ``<dtype>:g<group>`` family; the launch is the
      same for any head count (its grid is slot x kv head x row tiles), so
      a member's heads get the bits of the full-head launch.

    Returns (S, H, W, Dh) bf16, at any head dim from 1 to 128 (the kernel
    reads the pools at their own width). CUDA tensors go to the kernel
    (each launch adds one to ``paged_chunk_attention.launches``, and to
    ``.padded_launches`` at a head dim below its instantiated width); CPU
    tensors to :func:`paged_chunk_reference`."""
    if q.ndim != 4:
        raise ValueError(
            f"q must be (slots, heads, width, head_dim), got {tuple(q.shape)}"
        )
    slots, h, w, dh = q.shape
    _check_pools(h, dh, k_pool, v_pool, k_scale, v_scale, window)
    _, hkv, _, page = k_pool.shape
    for name, chunk in (("k_chunk", k_chunk), ("v_chunk", v_chunk)):
        if tuple(chunk.shape) != (slots, hkv, w, dh):
            raise ValueError(
                f"{name} must be {(slots, hkv, w, dh)}, got {tuple(chunk.shape)}"
            )
    max_pages = page_table.shape[1]
    if ctx_len is None:
        ctx_len = max_pages * page
    if ctx_len < max_pages * page:
        raise ValueError(
            f"ctx_len {ctx_len} cannot be narrower than the table span "
            f"{max_pages * page}"
        )
    if live_pages is None:
        live_pages = max_pages
    if not 0 <= live_pages <= max_pages:
        raise ValueError(f"live_pages {live_pages} must be in [0, {max_pages}]")
    if group < 1:
        raise ValueError(f"group must be >= 1, got {group}")
    key = autotune.shape_key(
        "paged_chunk", slots=slots, width=w, max_pages=max_pages, page=page,
        kv_heads=hkv, head_dim=dh,
        dtype=pool_dtype_family(k_pool, quantized=k_scale is not None), group=group,
    )
    row_tiles = autotune.normalize(autotune.resolve_config(key, explicit=config), h // hkv * w)
    autotune.note_used(key, {"row_tiles_per_block": row_tiles})
    if q.is_cuda:
        return _chunk_launch(
            q, k_chunk, v_chunk, k_pool, v_pool, page_table.to(torch.int32),
            lens.to(torch.int32), int(ctx_len), int(live_pages), window,
            k_scale, v_scale, row_tiles=row_tiles,
        )
    return paged_chunk_reference(
        q, k_chunk, v_chunk, k_pool, v_pool, page_table, lens,
        ctx_len=int(ctx_len), live_pages=int(live_pages), window=window,
        k_scale=k_scale, v_scale=v_scale,
    )


#: kernel launches since the count was last set to 0, and those of them at a
#: head dim below its instantiated width (the kernel zero-fills past it)
paged_chunk_attention.launches = 0
paged_chunk_attention.padded_launches = 0
