"""Telemetry sequence model: the port of the reference's ``models/sequence.py``.

A small causal transformer over telemetry streams: per-step features are
(progress delta, one-hot status), predictions are next-step deltas. The
arithmetic follows the flax modules it mirrors:

- ``Dense(dtype=bf16)`` projections (q/k/v, proj, up, down) promote input,
  weight and bias to bf16 and return bf16 (:func:`_dense_bf16`);
- ``embed`` and ``head`` compute in the promoted type, f32 (:func:`_dense_f32`);
- LayerNorm uses flax's defaults: epsilon 1e-6 and the fast variance
  ``E[x^2] - E[x]^2`` computed in f32;
- gelu is the tanh approximation, op by op in bf16 (:func:`_gelu_tanh`);
- the residual stream stays f32.

Ported: the full-attention forward, ``attention="flash"`` (the flash
kernels, forward and backward, :mod:`beholder_tpu_torch.ops.flash_attention`),
``attention="ring"`` over a :class:`~beholder_tpu_torch.parallel.Mesh`
(ring attention on the flash kernels' block-pair mode; the rest of each
block runs on the whole sequence),
``return_kv`` (prefill), the dense-cache step (scalar or per-row index,
``t >= 1``), the paged decode tick (:class:`PagedInfo`) and the fused chunk
forward over the paged pools (:class:`ChunkPagedInfo`, prefix-hit and
fused-wave admission). The dense branches and the chunk kernel's plain
version share one op sequence
(:func:`~beholder_tpu_torch.ops.attention.attend`). Training:
:func:`seq_loss`, :func:`init_seq_state` and :func:`seq_train_step`, with
``remat=True`` recomputing each block in the backward
(``torch.utils.checkpoint``). ``group=`` (a
:class:`~beholder_tpu_torch.ops.paged_attention.GroupSpec`) runs a paged
forward over a decode group's pools, each member holding a slice of the kv
heads (:func:`_group_attention`). Ulysses attention, MoE and sequence
sharding raise ``NotImplementedError``.

The model is built with gradients off, so the serving paths record no
autograd graph; :func:`init_seq_state` turns them on for training.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from beholder_tpu_torch.device import resolve_device
from beholder_tpu_torch.ops import NUM_STATUSES
from beholder_tpu_torch.ops.attention import attend, full_attention, ring_attention
from beholder_tpu_torch.ops.flash_attention import flash_attention
from beholder_tpu_torch.ops.paged_attention import (
    ChunkPagedInfo,
    GroupSpec,
    PagedInfo,
    QuantizedPool,
    paged_chunk_attention,
    paged_decode_attention,
)
from beholder_tpu_torch.ops.quant import pool_quantize

from .train import TrainState, apply_gradients, init_state

FEATURES = 1 + NUM_STATUSES


def index_put_dropping_(
    dst: torch.Tensor,
    indices: tuple[torch.Tensor, ...],
    values: torch.Tensor,
    valid: torch.Tensor,
) -> torch.Tensor:
    """In place ``dst[indices][i] = values[i]`` where ``valid[i]``, other
    entries dropped: the counterpart of JAX's ``.at[...].set(mode="drop")``
    without a host synchronisation and without growing ``dst``. The valid
    targets must be distinct. A dropped entry repeats the first valid
    entry's write (same place, same value); when none is valid, every
    entry writes back what its (clamped) place already holds. Either way
    duplicates carry equal values, so the result is well defined."""
    # a 1-element index tensor, never a 0-d one: indexing with a 0-d
    # tensor reads it back to the host
    first = torch.argmax(valid.to(torch.int32)).reshape(1)
    any_valid = valid.index_select(0, first)
    idx = []
    for dim, ix in enumerate(indices):
        ix = ix.to(torch.int64).clamp(0, dst.shape[dim] - 1)
        idx.append(torch.where(valid, ix, torch.where(any_valid, ix.index_select(0, first), ix)))
    idx = tuple(idx)
    shape = (-1,) + (1,) * (values.ndim - 1)
    values = values.to(dst.dtype)
    fallback = torch.where(
        any_valid.view(shape), values.index_select(0, first), dst[idx]
    )
    dst.index_put_(idx, torch.where(valid.view(shape), values, fallback))
    return dst


def _pool_write_column(pool, info: PagedInfo, col: torch.Tensor):
    """Write each slot's new (Hkv, Dh) kv column into its write page at its
    write offset, in place (the pool is updated, not copied); inactive
    slots (``write_pages == N``) drop. Quantized pools quantize the column
    per (head, token) on the way in."""
    values = pool.values if isinstance(pool, QuantizedPool) else pool
    valid = info.write_pages < values.shape[0]
    idx = (info.write_pages, info.write_offsets)
    if isinstance(pool, QuantizedPool):
        q, scale = pool_quantize(col, axis=-1, values_dtype=pool.values.dtype)
        # tokens-minor pools: index (page, offset) on a (N, page, ...) view
        index_put_dropping_(pool.values.permute(0, 3, 1, 2), idx, q, valid)
        index_put_dropping_(pool.scales.permute(0, 2, 1), idx, scale, valid)
        return pool
    index_put_dropping_(pool.permute(0, 3, 1, 2), idx, col, valid)
    return pool


def _dense_bf16(x: torch.Tensor, lin: nn.Linear) -> torch.Tensor:
    """flax ``Dense(dtype=bf16)``: the product rounds to bf16, then the
    bf16 bias is added (another bf16 rounding), as XLA does it."""
    y = torch.matmul(x.to(torch.bfloat16), lin.weight.to(torch.bfloat16).t())
    return y + lin.bias.to(torch.bfloat16)


def _dense_f32(x: torch.Tensor, lin: nn.Linear) -> torch.Tensor:
    """flax ``Dense`` computing in f32 (``embed``, ``head``)."""
    return torch.matmul(x.float(), lin.weight.float().t()) + lin.bias.float()


def _gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """flax ``nn.gelu`` (the tanh approximation) op by op in x's dtype,
    with its constants rounded to that dtype, as XLA runs it on a bf16
    input: bitwise the reference. ``F.gelu(approximate="tanh")`` rounds
    once at the end instead and lands up to a bf16 ULP away, which the
    rest of the forward then carries."""
    c, a = _gelu_constants(x.dtype)
    return x * (0.5 * (1.0 + torch.tanh(c * (x + a * (x * x * x)))))


@functools.lru_cache(maxsize=None)
def _gelu_constants(dtype: torch.dtype) -> tuple[float, float]:
    """sqrt(2/pi) and 0.044715 rounded to ``dtype``, as jax.nn.gelu
    embeds them."""
    return (
        torch.tensor(0.7978845608028654, dtype=dtype).item(),
        torch.tensor(0.044715, dtype=dtype).item(),
    )


def _row_mean(x: torch.Tensor) -> torch.Tensor:
    """Mean over the last dim, keepdim, with each row's bits independent of
    the row count: on the card one reduction over 512 elements picks its
    thread layout by how many rows there are, and the sums differ in the
    last bit (8 rows against 16, say). Means of 32-element runs, then the
    mean of those, keep one layout for any row count; the power-of-two
    scalings are exact, so this is the sum of the runs' sums over n."""
    n = x.shape[-1]
    if n % 32 or n == 32:
        return x.mean(dim=-1, keepdim=True)
    return x.reshape(*x.shape[:-1], n // 32, 32).mean(dim=-1).mean(dim=-1, keepdim=True)


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm()``: epsilon 1e-6, fast variance, f32 math.
    Without autograd (every serving path) the statistics come from
    :func:`_row_mean`, so a row normalizes to the same bits in any batch (a
    serving cluster's shard and one batcher admit the same request in
    different batches). Under autograd (training) each is one reduction:
    there the two-level mean buys nothing and cost about 4 % of a training
    step on the card."""

    def __init__(self, dim: int, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim, device=device))
        self.bias = nn.Parameter(torch.zeros(dim, device=device))
        self.eps = 1e-6

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float()
        if torch.is_grad_enabled():
            mu = x.mean(dim=-1, keepdim=True)
            mu2 = (x * x).mean(dim=-1, keepdim=True)
        else:
            mu = _row_mean(x)
            mu2 = _row_mean(x * x)
        var = torch.clamp(mu2 - mu * mu, min=0.0)
        mul = torch.rsqrt(var + self.eps) * self.weight.float()
        return (x - mu) * mul + self.bias.float()


def _dense_attention(q, k_cache, v_cache, index, window, t):
    """The dense-cache attention of the reference's ``Block``
    (``sequence.py:313-369``): query ``j`` of row ``b`` sits at ``index +
    j`` (a scalar index) or ``index[b] + j`` (one per row) and sees cache
    positions up to itself, within ``window``; the op sequence is
    :func:`attend`'s."""
    positions = torch.arange(k_cache.shape[2], device=q.device)
    steps = torch.arange(t, device=q.device)
    if index.ndim == 1:
        pos_q = index[:, None] + steps                               # (B, t)
        live = positions[None, None, :] <= pos_q[:, :, None]
        if window is not None:
            live = live & (positions[None, None, :] > pos_q[:, :, None] - window)
        live = live[:, None, None, :, :]
    else:
        pos_q = index + steps
        live = positions[None, :] <= pos_q[:, None]
        if window is not None:
            live = live & (positions[None, :] > pos_q[:, None] - window)
        live = live[None, None, None, :, :]
    return attend(q, k_cache, v_cache, live)


def _write_dense_cache(cache: torch.Tensor, new: torch.Tensor, index):
    """Write (B, Hkv, t, Dh) columns into a dense (B, Hkv, L, Dh) cache in
    place: at ``index`` for a scalar index, at ``index[b]`` per row for a
    vector index (positions past L drop)."""
    b, _, t, _ = new.shape
    new = new.to(cache.dtype)
    steps = torch.arange(t, device=cache.device)
    if index.ndim == 0:
        cache.index_copy_(2, index.to(torch.int64) + steps, new)
        return cache
    rows = torch.arange(b, device=cache.device)[:, None].expand(b, t)
    pos = index.to(torch.int64)[:, None] + steps                     # (B, t)
    index_put_dropping_(
        cache.permute(0, 2, 1, 3),
        (rows.reshape(-1), pos.reshape(-1)),
        new.permute(0, 2, 1, 3).reshape(b * t, *new.shape[1:2], new.shape[3]),
        pos.reshape(-1) < cache.shape[2],
    )
    return cache


def _pool_device(pool) -> torch.device:
    return (pool.values if isinstance(pool, QuantizedPool) else pool).device


def _paged_attention(q, k, v, k_cache, v_cache, index, window, group: int = 1):
    """One pool's paged attention: the decode tick (:class:`PagedInfo`,
    ``t == 1``: the kv column is written into the pool first) or the chunk
    (:class:`ChunkPagedInfo`: the chunk's own kv is overlaid, the pool is
    not written). Returns the attention (S, H, t, Dh) and the block's kv
    output: the updated pools for a tick, the chunk's own (k, v) columns
    for a chunk. ``group`` is the member count of a group-parallel call."""
    quant = isinstance(k_cache, QuantizedPool)
    if isinstance(index, PagedInfo):
        if q.shape[2] != 1:
            raise ValueError(f"the paged decode tick takes t == 1, got {q.shape[2]}")
        k_cache = _pool_write_column(k_cache, index, k[:, :, 0, :])
        v_cache = _pool_write_column(v_cache, index, v[:, :, 0, :])
        att = paged_decode_attention(
            q[:, :, 0, :].contiguous(),
            k_cache.values if quant else k_cache,
            v_cache.values if quant else v_cache,
            index.page_table,
            index.lens,
            window=window,
            k_scale=k_cache.scales if quant else None,
            v_scale=v_cache.scales if quant else None,
            group=group,
        )[:, :, None, :]                                            # (S, H, 1, Dh)
        return att, (k_cache, v_cache)
    # the t >= 1 chunk attends its slot's pages in place plus its own kv (the
    # kernel's overlay); nothing is written to the pools here: the caller
    # writes the columns it keeps
    att = paged_chunk_attention(
        q.contiguous(), k.contiguous(), v.contiguous(),
        k_cache.values if quant else k_cache,
        v_cache.values if quant else v_cache,
        index.page_table,
        index.lens,
        ctx_len=index.ctx_len,
        live_pages=index.live_pages,
        window=window,
        k_scale=k_cache.scales if quant else None,
        v_scale=v_cache.scales if quant else None,
        group=group,
    )                                                               # (S, H, t, Dh)
    return att, (k, v)


def _group_attention(q, k, v, k_members, v_members, index, window, group: GroupSpec):
    """Paged attention over a decode group's pools: ``k_members[m]`` /
    ``v_members[m]`` hold kv heads ``[m * Hkv/n, (m + 1) * Hkv/n)`` of every
    page, each a contiguous pool on its member's device. The projections
    came in at full width; each member gets its head slice (q heads stay
    next to their kv head, GQA groups being contiguous), taken before its
    pool write, attends over its own pool, and the members' outputs are
    concatenated along the head axis: a copy, never a sum of partials, so
    the heads carry the single-pool launch's bits. Returns the attention on
    q's device and the block's kv output: the members' pools for a tick,
    the chunk's own full-width (k, v) for a chunk."""
    if len(k_members) != group.size or len(v_members) != group.size:
        raise ValueError(
            f"a group of {group.size} takes {group.size} member pools, got {len(k_members)}"
        )
    hkv, h = k.shape[1], q.shape[1]
    if hkv % group.size:
        raise ValueError(f"group size {group.size} does not divide {hkv} kv heads")
    hloc = hkv // group.size
    qloc = hloc * (h // hkv)
    info_fields = index._fields
    atts, new_k, new_v = [], [], []
    for m, (kp, vp) in enumerate(zip(k_members, v_members)):
        dev = _pool_device(kp)
        info = type(index)(*(
            x.to(dev) if torch.is_tensor(x) else x
            for x in (getattr(index, f) for f in info_fields)
        ))
        att, (kp, vp) = _paged_attention(
            q[:, m * qloc:(m + 1) * qloc].to(dev),
            k[:, m * hloc:(m + 1) * hloc].to(dev),
            v[:, m * hloc:(m + 1) * hloc].to(dev),
            kp, vp, info, window, group=group.size,
        )
        atts.append(att.to(q.device))
        new_k.append(kp)
        new_v.append(vp)
    kv_out = (k, v) if isinstance(index, ChunkPagedInfo) else (tuple(new_k), tuple(new_v))
    return torch.cat(atts, dim=1), kv_out


class Block(nn.Module):
    """Pre-LN transformer block: attention (full, flash or ring, dense-cache
    step, paged decode tick or paged chunk) and a gelu MLP. ``attention``
    picks the cache-less path's backend, as in the reference; cached steps
    run their own attention whatever it is. Ring attention needs ``mesh``
    (a :class:`~beholder_tpu_torch.parallel.Mesh`)."""

    def __init__(
        self,
        dim: int,
        heads: int,
        *,
        kv_heads: int | None = None,
        window: int | None = None,
        attention: str = "full",
        mesh=None,
        device=None,
    ):
        super().__init__()
        if attention not in ("full", "flash", "ring"):
            raise NotImplementedError(f"attention={attention!r} is not ported yet")
        if attention == "ring" and mesh is None:
            raise ValueError("ring attention needs a mesh")
        hkv = kv_heads or heads
        if heads % hkv:
            raise ValueError(f"heads {heads} not a multiple of kv_heads {hkv}")
        self.dim, self.heads, self.kv_heads, self.window = dim, heads, hkv, window
        self.attention, self.mesh = attention, mesh
        dh = dim // heads
        self.ln0 = LayerNorm(dim, device=device)
        self.q_proj = nn.Linear(dim, dim, device=device)
        self.k_proj = nn.Linear(dim, hkv * dh, device=device)
        self.v_proj = nn.Linear(dim, hkv * dh, device=device)
        self.proj = nn.Linear(dim, dim, device=device)
        self.ln1 = LayerNorm(dim, device=device)
        self.up = nn.Linear(dim, 4 * dim, device=device)
        self.down = nn.Linear(4 * dim, dim, device=device)

    def forward(self, x: torch.Tensor, cache=None, return_kv: bool = False,
                group: GroupSpec | None = None):
        """Full forward, or with ``cache=(k, v, index)`` one cached step:
        ``index`` a :class:`PagedInfo` (paged decode tick, t == 1), a
        :class:`ChunkPagedInfo` (paged chunk, t >= 1: the chunk's own (k, v)
        come back and the pools are not written) or an integer tensor
        (dense cache: scalar, or one position per row). Dense caches and
        the tick's pools are updated in place and returned.

        ``group`` (paged caches only): ``k`` and ``v`` are a decode group's
        member pools, tuples of ``group.size`` (see
        :func:`_group_attention`); the tick's member pools come back as such
        tuples, the chunk's kv at full width."""
        b, t, d = x.shape
        h, hkv = self.heads, self.kv_heads
        dh = d // h
        if group is not None and (
            cache is None or not isinstance(cache[2], (PagedInfo, ChunkPagedInfo))
        ):
            raise ValueError(
                "group-parallel forwards are paged-only (a PagedInfo or "
                "ChunkPagedInfo cache index)"
            )
        y = self.ln0(x)
        q = _dense_bf16(y, self.q_proj).reshape(b, t, h, dh).transpose(1, 2)
        k = _dense_bf16(y, self.k_proj).reshape(b, t, hkv, dh).transpose(1, 2)
        v = _dense_bf16(y, self.v_proj).reshape(b, t, hkv, dh).transpose(1, 2)
        if cache is not None:
            k_cache, v_cache, index = cache
            if group is not None:
                att, kv_out = _group_attention(q, k, v, k_cache, v_cache, index, self.window,
                                               group)
            elif isinstance(index, (PagedInfo, ChunkPagedInfo)):
                att, kv_out = _paged_attention(q, k, v, k_cache, v_cache, index, self.window)
            elif isinstance(index, torch.Tensor) and not index.is_floating_point():
                if index.ndim > 1:
                    raise ValueError(f"cache index must be 0-d or 1-d, got {index.ndim}-d")
                k_cache = _write_dense_cache(k_cache, k, index)
                v_cache = _write_dense_cache(v_cache, v, index)
                att = _dense_attention(q, k_cache, v_cache, index, self.window, t)
                kv_out = (k_cache, v_cache)
            else:
                raise NotImplementedError(
                    f"cache index {type(index).__name__} is not ported yet"
                )
        else:
            kv_out = (k, v)
            if self.attention == "ring":
                att = ring_attention(q, k, v, self.mesh, causal=True, window=self.window)
            else:
                attend_fn = flash_attention if self.attention == "flash" else full_attention
                att = attend_fn(q, k, v, causal=True, window=self.window)
        att = att.transpose(1, 2).reshape(b, t, d)
        x = x + _dense_bf16(att, self.proj).to(x.dtype)
        y = self.ln1(x)
        y = _gelu_tanh(_dense_bf16(y, self.up))
        x = x + _dense_bf16(y, self.down).to(x.dtype)
        if cache is not None or return_kv:
            return x, kv_out
        return x


class TelemetrySequenceModel(nn.Module):
    """Causal next-delta predictor over telemetry streams. ``attention`` is
    ``"full"``, ``"flash"`` or ``"ring"`` (with ``mesh``); the parameters do
    not depend on it."""

    def __init__(
        self,
        dim: int = 128,
        heads: int = 4,
        layers: int = 2,
        *,
        kv_heads: int | None = None,
        window: int | None = None,
        attention: str = "full",
        mesh=None,
        ffn: str = "dense",
        remat: bool = False,
        seq_shard: bool = False,
        device=None,
    ):
        super().__init__()
        if ffn != "dense":
            raise NotImplementedError(f"ffn={ffn!r} is not ported yet")
        if seq_shard:
            raise NotImplementedError("seq_shard is not ported yet")
        device = resolve_device(device)
        self.dim, self.heads, self.layers = dim, heads, layers
        self.remat = remat
        self.kv_heads, self.window = kv_heads, window
        self.embed = nn.Linear(FEATURES, dim, device=device)
        self.blocks = nn.ModuleList(
            Block(dim, heads, kv_heads=kv_heads, window=window,
                  attention=attention, mesh=mesh, device=device)
            for _ in range(layers)
        )
        self.ln = LayerNorm(dim, device=device)
        self.head = nn.Linear(dim, 1, device=device)
        self.requires_grad_(False)

    @property
    def device(self) -> torch.device:
        return self.embed.weight.device

    def forward(self, feats: torch.Tensor, cache=None, return_kv: bool = False,
                group: GroupSpec | None = None, last: torch.Tensor | None = None,
                head_rows: int | None = None):
        """(B, T, FEATURES) -> (B, T) predicted next delta per position.
        With ``cache=(keys, values, index)`` (per-layer sequences) one cached
        step; with ``return_kv`` the per-layer (k, v) come back too.

        ``last`` ((B,) positions) runs the head at those rows only and
        returns (B,) predictions: one row a sequence, padded with zero rows
        to ``head_rows`` (when given), in one product. The head's f32 GEMM
        picks its kernel by its row count, and on the card kernels differ in
        the last bit (a split-K kernel at 224 rows, another at 8), so a fixed
        ``head_rows`` keeps a sequence's prediction independent of the batch
        it was prefilled in.

        ``group`` runs a paged step over a decode group's member pools
        (per-layer tuples of member pools; see :meth:`Block.forward`)."""
        if group is not None and cache is None:
            raise ValueError(
                "group-parallel forwards need a paged cache (prefill runs at "
                "full width on one device)"
            )
        x = _dense_f32(feats, self.embed)
        # remat only pays in the training backward: each block's activations
        # are dropped after the forward and recomputed when its gradient is
        # taken (the reference's nn.remat(Block), off the decode paths)
        remat = self.remat and cache is None and not return_kv and torch.is_grad_enabled()
        kvs = []
        for i, block in enumerate(self.blocks):
            if remat:
                x = checkpoint(block, x, use_reentrant=False)
            elif cache is not None:
                x, kv = block(x, cache=(cache[0][i], cache[1][i], cache[2]), group=group)
                kvs.append(kv)
            elif return_kv:
                x, kv = block(x, return_kv=True)
                kvs.append(kv)
            else:
                x = block(x)
        if last is not None:
            b = x.shape[0]
            x = x[torch.arange(b, device=x.device), last.to(torch.int64)]
            if head_rows is not None and head_rows > b:
                x = F.pad(x, (0, 0, 0, head_rows - b))
            preds = _dense_f32(self.ln(x), self.head)[:b, 0]
        else:
            preds = _dense_f32(self.ln(x), self.head)[..., 0]
        if cache is not None or return_kv:
            return preds, kvs
        return preds


def one_hot(x: torch.Tensor, n: int) -> torch.Tensor:
    """f32 one-hot of integer ``x`` over ``n`` classes. Unlike
    ``F.one_hot`` it never checks its input's range, so it never reads
    the device from the host."""
    return (x.to(torch.int64)[..., None] == torch.arange(n, device=x.device)).float()


def stream_features(
    progress: torch.Tensor, statuses: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, T+1) progress / statuses -> (B, T, F) feats, (B, T) targets:
    feature t is (delta_t, one-hot status_t), target t is delta_{t+1} (the
    last target is a zero pad)."""
    deltas = torch.diff(progress.float(), dim=-1)
    oh = one_hot(statuses[:, 1:], NUM_STATUSES)
    feats = torch.cat([deltas[..., None], oh], dim=-1)
    targets = torch.cat([deltas[:, 1:], torch.zeros_like(deltas[:, :1])], dim=-1)
    return feats, targets


def seq_loss(model: TelemetrySequenceModel, feats: torch.Tensor,
             targets: torch.Tensor) -> torch.Tensor:
    """Masked mean squared error of the next-delta predictions; the last
    position's target is padding. (MoE router terms do not arise: MoE is
    not ported.)"""
    err = (model(feats) - targets) ** 2
    mask = torch.ones_like(err)
    mask[:, -1] = 0.0
    return (err * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def init_seq_state(
    seed: int,
    model: TelemetrySequenceModel | None = None,
    learning_rate: float = 1e-3,
    *,
    device=None,
) -> TrainState:
    """A training state for ``model`` (default ``TelemetrySequenceModel()``
    on ``device``): f32 params from a numpy seed
    (:func:`~beholder_tpu_torch.models.bridge.init_params`), gradients on,
    Adam at step 0. The reference's ``seq_len`` only shaped flax's init and
    has no counterpart."""
    from .bridge import init_params, load_flax_params

    model = model or TelemetrySequenceModel(device=device)
    load_flax_params(model, init_params(model, seed))
    return init_state(model, learning_rate)


def seq_train_step(
    state: TrainState, feats: torch.Tensor, targets: torch.Tensor
) -> tuple[TrainState, torch.Tensor]:
    """One Adam step on :func:`seq_loss`; returns the new state and the
    loss (a 0-d tensor on the device)."""
    return apply_gradients(state, lambda m: seq_loss(m, feats, targets))
