"""Paged-KV decode attention: a CUDA kernel for Hopper and its plain version.

Counterpart of the reference's ``ops/paged_attention.py``. Each slot's
single query attends its own pages read in place from a ``(N, Hkv, Dh,
page)`` pool (tokens minor, the reference's layout) through the page table.
On a CUDA tensor :func:`paged_decode_attention` launches the hand-written
kernel in ``csrc/paged_decode.cu`` (see the note at its top: what it
replaces, what bounds it, how its design answers that) or raises; it never
falls back. On a CPU tensor it runs :func:`paged_decode_reference`, the
plain PyTorch version, which walks the pages with the same online-softmax
recurrence and the same dtype mix.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch

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


def _kernel_lib() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        from beholder_tpu_torch import csrc

        lib = csrc.load("paged_decode")
        lib.paged_decode_launch.argtypes = (
            [ctypes.c_void_p] * 8
            + [ctypes.c_int] * 9
            + [ctypes.c_float, ctypes.c_void_p]
        )
        lib.paged_decode_launch.restype = ctypes.c_int
        lib.paged_decode_smem_bytes.argtypes = [ctypes.c_int] * 3
        lib.paged_decode_smem_bytes.restype = ctypes.c_size_t
        _lib = lib
    return _lib


def _launch(q, k_pool, v_pool, page_table, lens, window, k_scale, v_scale):
    """Check what the kernel takes, allocate the output, launch on the
    current stream, raise on a launch error."""
    slots, h, dh = q.shape
    n, hkv, _, page = k_pool.shape
    dev = q.device
    mode = _MODES.get(k_pool.dtype)
    if mode is None:
        raise TypeError(f"no paged decode kernel for {k_pool.dtype} pools")
    if q.dtype != torch.bfloat16:
        raise TypeError(f"the kernel takes bf16 q, got {q.dtype}")
    if v_pool.dtype != k_pool.dtype:
        raise TypeError(f"pool dtypes differ: {k_pool.dtype} vs {v_pool.dtype}")
    if (mode == 0) != (k_scale is None):
        raise TypeError("int8/fp8 pools need scales and bf16 pools take none")
    tensors = [q, k_pool, v_pool, page_table, lens]
    if k_scale is not None:
        want = _SCALE_DTYPES[k_pool.dtype]
        if k_scale.dtype != want or v_scale.dtype != want:
            raise TypeError(f"{k_pool.dtype} pools take {want} scales")
        tensors += [k_scale, v_scale]
    if page_table.dtype != torch.int32 or lens.dtype != torch.int32:
        raise TypeError("page_table and lens must be int32")
    if lens.shape != (slots,) or page_table.shape[0] != slots:
        raise ValueError(
            f"page_table {tuple(page_table.shape)} / lens {tuple(lens.shape)} "
            f"do not match {slots} slots"
        )
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"all inputs must be on {dev}, got {t.device}")
        if not t.is_contiguous():
            raise ValueError("the kernel takes contiguous tensors")
    lib = _kernel_lib()
    if lib.paged_decode_smem_bytes(h, hkv, dh) == 0:
        raise ValueError(
            f"the kernel takes at most 16 query heads per kv head, got {h // hkv}"
        )
    out = torch.empty_like(q)
    err = lib.paged_decode_launch(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        k_scale.data_ptr() if k_scale is not None else None,
        v_scale.data_ptr() if v_scale is not None else None,
        page_table.data_ptr(), lens.data_ptr(), out.data_ptr(),
        slots, h, hkv, dh, page, n, page_table.shape[1],
        0 if window is None else window, mode, float(1.0 / math.sqrt(dh)),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"paged_decode kernel launch failed: CUDA error {err}")
    paged_decode_attention.launches += 1
    return out


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
      which reads no page and returns a zero row.

    Returns (S, H, Dh) in q's dtype. CUDA tensors go to the kernel (each
    launch adds one to ``paged_decode_attention.launches``); CPU tensors
    to :func:`paged_decode_reference`."""
    if q.ndim != 3:
        raise ValueError(f"q must be (slots, heads, head_dim), got {tuple(q.shape)}")
    slots, h, dh = q.shape
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
    if q.is_cuda:
        return _launch(
            q, k_pool, v_pool, page_table.to(torch.int32), lens.to(torch.int32),
            window, k_scale, v_scale,
        )
    return paged_decode_reference(
        q, k_pool, v_pool, page_table, lens,
        window=window, k_scale=k_scale, v_scale=v_scale,
    )


#: kernel launches since the count was last set to 0
paged_decode_attention.launches = 0
