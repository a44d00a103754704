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
heads (:func:`_group_attention`). ``attention="ulysses"`` runs
:func:`~beholder_tpu_torch.ops.attention.ulysses_attention` over the mesh's
``sp`` axis, and ``ffn="moe"`` a
:class:`~beholder_tpu_torch.ops.moe.SwitchFFN` whose router terms come back
through ``terms``, a per-forward dict that :func:`seq_loss` adds to the
loss.

The sharded training step (:mod:`beholder_tpu_torch.parallel.mesh`) runs
:meth:`TelemetrySequenceModel.members_forward`: every mesh member's forward
in lockstep over its own parameter slices, with megatron tensor parallelism
over ``tp`` (each member holds ``heads/tp`` q heads and ``kv_heads/tp`` kv
heads; a row layer's bias is added once, after the member sum), ring or
Ulysses attention over ``sp`` inside each (dp, tp) member, expert
parallelism over ``ep``, and, with ``seq_shard=True``, the residual stream
and LayerNorms as T-slices over tp (and sp): reduce-scattered after
``proj``/``down`` and all-gathered before q/k/v/``up``, so each member saves
1/tp of those activations for the backward. On one device (the plain
forward) ``seq_shard`` changes nothing, as the reference's sharding
constraint changes no value.

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
from beholder_tpu_torch.ops.attention import (
    attend,
    full_attention,
    ring_attention,
    ring_attention_members,
    ulysses_attention,
    ulysses_attention_members,
)
from beholder_tpu_torch.ops.flash_attention import flash_attention
from beholder_tpu_torch.ops.moe import SwitchFFN
from beholder_tpu_torch.ops.paged_attention import (
    ChunkPagedInfo,
    GroupSpec,
    PagedInfo,
    QuantizedPool,
    paged_chunk_attention,
    paged_decode_attention,
)
from beholder_tpu_torch.ops.quant import pool_quantize
from beholder_tpu_torch.parallel.collectives import (
    all_gather,
    along,
    reduce_scatter,
    tp_all_reduce,
    tp_replicate,
    unzip,
)
from beholder_tpu_torch.parallel.mesh import members_mesh
from beholder_tpu_torch.parallel.sharding import batch_slices

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
    return _linear_bf16(x, lin.weight, lin.bias)


def _linear_bf16(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    y = torch.matmul(x.to(torch.bfloat16), w.to(torch.bfloat16).t())
    return y + b.to(torch.bfloat16)


def _dense_f32(x: torch.Tensor, lin: nn.Linear) -> torch.Tensor:
    """flax ``Dense`` computing in f32 (``embed``, ``head``)."""
    return _linear_f32(x, lin.weight, lin.bias)


def _linear_f32(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.matmul(x.float(), w.float().t()) + b.float()


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
        return layer_norm(x, self.weight, self.bias, self.eps)


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-6) -> torch.Tensor:
    """:class:`LayerNorm`'s arithmetic on given parameters."""
    x = x.float()
    if torch.is_grad_enabled():
        mu = x.mean(dim=-1, keepdim=True)
        mu2 = (x * x).mean(dim=-1, keepdim=True)
    else:
        mu = _row_mean(x)
        mu2 = _row_mean(x * x)
    var = torch.clamp(mu2 - mu * mu, min=0.0)
    mul = torch.rsqrt(var + eps) * weight.float()
    return (x - mu) * mul + bias.float()


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
    """Pre-LN transformer block: attention (full, flash, ring or Ulysses,
    dense-cache step, paged decode tick or paged chunk) and a gelu MLP or a
    routed MoE FFN. ``attention`` picks the cache-less path's backend, as in
    the reference; cached steps run their own attention whatever it is.
    Ring and Ulysses attention need ``mesh`` (a
    :class:`~beholder_tpu_torch.parallel.Mesh` with an ``sp`` axis)."""

    def __init__(
        self,
        dim: int,
        heads: int,
        *,
        kv_heads: int | None = None,
        window: int | None = None,
        attention: str = "full",
        mesh=None,
        ffn: str = "dense",
        num_experts: int = 4,
        moe_topk: int = 1,
        moe_router: str = "tokens",
        seq_shard: bool = False,
        device=None,
    ):
        super().__init__()
        if attention not in ("full", "flash", "ring", "ulysses"):
            raise ValueError(f"attention must be full, flash, ring or ulysses, got {attention!r}")
        if attention in ("ring", "ulysses") and mesh is None:
            raise ValueError(f"{attention} attention needs a mesh")
        if ffn not in ("dense", "moe"):
            raise ValueError(f"ffn must be 'dense' or 'moe', got {ffn!r}")
        hkv = kv_heads or heads
        if heads % hkv:
            raise ValueError(f"heads {heads} not a multiple of kv_heads {hkv}")
        self.dim, self.heads, self.kv_heads, self.window = dim, heads, hkv, window
        self.attention, self.mesh, self.ffn, self.seq_shard = attention, mesh, ffn, seq_shard
        dh = dim // heads
        self.ln0 = LayerNorm(dim, device=device)
        self.q_proj = nn.Linear(dim, dim, device=device)
        self.k_proj = nn.Linear(dim, hkv * dh, device=device)
        self.v_proj = nn.Linear(dim, hkv * dh, device=device)
        self.proj = nn.Linear(dim, dim, device=device)
        self.ln1 = LayerNorm(dim, device=device)
        if ffn == "moe":
            self.moe = SwitchFFN(dim, 4 * dim, num_experts, router_topk=moe_topk,
                                 router_type=moe_router, mesh=mesh, device=device)
        else:
            self.up = nn.Linear(dim, 4 * dim, device=device)
            self.down = nn.Linear(4 * dim, dim, device=device)

    def forward(self, x: torch.Tensor, cache=None, return_kv: bool = False,
                group: GroupSpec | None = None, terms: dict | None = None):
        """Full forward, or with ``cache=(k, v, index)`` one cached step:
        ``index`` a :class:`PagedInfo` (paged decode tick, t == 1), a
        :class:`ChunkPagedInfo` (paged chunk, t >= 1: the chunk's own (k, v)
        come back and the pools are not written) or an integer tensor
        (dense cache: scalar, or one position per row). Dense caches and
        the tick's pools are updated in place and returned.

        ``group`` (paged caches only): ``k`` and ``v`` are a decode group's
        member pools, tuples of ``group.size`` (see
        :func:`_group_attention`); the tick's member pools come back as such
        tuples, the chunk's kv at full width. ``terms`` (a dict) receives
        the MoE layer's router terms."""
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
            elif self.attention == "ulysses":
                att = ulysses_attention(q, k, v, self.mesh, causal=True, window=self.window)
            else:
                attend_fn = flash_attention if self.attention == "flash" else full_attention
                att = attend_fn(q, k, v, causal=True, window=self.window)
        att = att.transpose(1, 2).reshape(b, t, d)
        x = x + _dense_bf16(att, self.proj).to(x.dtype)
        y = self.ln1(x)
        if self.ffn == "moe":
            x = x + self.moe(y, terms)
        else:
            y = _gelu_tanh(_dense_bf16(y, self.up))
            x = x + _dense_bf16(y, self.down).to(x.dtype)
        if cache is not None or return_kv:
            return x, kv_out
        return x

    def members_forward(self, params: list[dict], xs: list, mesh, prefix: str,
                        terms: list[dict], cache=None, return_kv: bool = False):
        """The block on every member of ``mesh`` this process holds
        (``mesh.local``), in lockstep: ``params[i]`` holds local member
        ``i``'s slices under their ``state_dict`` names
        (``prefix`` + ``"q_proj.weight"``, ...), ``xs[i]`` its (B/dp, T',
        D) rows (T' = T/sp, or T/(sp*tp) with ``seq_shard``); ``terms[i]``
        receives its MoE terms. Returns each member's output rows.

        ``cache=(k_caches, v_caches, index)`` runs one dense-cache step
        over a tp group (sharded serving): ``k_caches[i]`` / ``v_caches[i]``
        hold member ``i``'s ``Hkv/tp`` kv heads of its rows' cache, which it
        writes and attends alone (in place) at the 0-d ``index``. With a
        cache or ``return_kv`` each member's (k, v) come back too: its
        updated cache shards, or its heads' columns, as ``(xs, (ks, vs))``."""
        tp = mesh.shape.get("tp", 1)
        h, hkv = self.heads, self.kv_heads
        if h % tp or hkv % tp:
            raise ValueError(
                f"tp={tp} must divide heads {h} and kv_heads {hkv} (each member holds whole heads)"
            )
        ys = [layer_norm(x, p[prefix + "ln0.weight"], p[prefix + "ln0.bias"])
              for p, x in zip(params, xs)]
        ys = self._to_columns(ys, mesh)
        b, t, d = ys[0].shape
        dh = d // h

        def heads(name, n):
            return [_linear_bf16(y, p[prefix + name + ".weight"], p[prefix + name + ".bias"])
                    .reshape(b, t, n // tp, dh).transpose(1, 2) for p, y in zip(params, ys)]

        qs, ks, vs = heads("q_proj", h), heads("k_proj", hkv), heads("v_proj", hkv)
        if cache is None:
            atts = self._members_attention(qs, ks, vs, mesh)
            kv_out = (ks, vs)
        else:
            k_caches, v_caches, index = cache
            k_caches = [_write_dense_cache(c, k, index.to(c.device)) for c, k in zip(k_caches, ks)]
            v_caches = [_write_dense_cache(c, v, index.to(c.device)) for c, v in zip(v_caches, vs)]
            atts = [_dense_attention(q, kc, vc, index.to(q.device), self.window, t)
                    for q, kc, vc in zip(qs, k_caches, v_caches)]
            kv_out = (k_caches, v_caches)
        atts = [a.transpose(1, 2).reshape(b, t, d // tp) for a in atts]
        xs = self._row(params, atts, xs, mesh, prefix + "proj")
        ys = [layer_norm(x, p[prefix + "ln1.weight"], p[prefix + "ln1.bias"])
              for p, x in zip(params, xs)]
        if self.ffn == "moe":
            out = self.moe.members_forward(params, ys, mesh, prefix + "moe.", terms)
            xs = [x + o for x, o in zip(xs, out)]
        else:
            ys = self._to_columns(ys, mesh)
            ys = [_gelu_tanh(_linear_bf16(y, p[prefix + "up.weight"], p[prefix + "up.bias"]))
                  for p, y in zip(params, ys)]
            xs = self._row(params, ys, xs, mesh, prefix + "down")
        return (xs, kv_out) if cache is not None or return_kv else xs

    def _to_columns(self, ys: list, mesh) -> list:
        """A column layer's input: all-gathered over tp from T-slices under
        ``seq_shard``, else megatron's *f* over the replicated rows."""
        if self.seq_shard:
            return along(mesh, "tp", all_gather, ys, dim=1)
        return along(mesh, "tp", tp_replicate, ys)

    def _row(self, params: list[dict], ins: list, xs: list, mesh, name: str) -> list:
        """A row-parallel layer added to the residual: each member's product
        over its input features, of bf16 operands but in f32 (exact
        products, f32 sums), summed over tp in f32 (megatron's *g*, or a
        reduce-scatter onto the T-slices under ``seq_shard``), rounded to
        bf16 once, then the bias, once: the unsharded ``Dense(dtype=bf16)``
        up to the order of its f32 sums. (The reference's partitioner
        rounds each member's partial to bf16 before its sum, a rounding the
        unsharded layer does not make.) With one member along tp it is the
        unsharded layer's own op."""
        if mesh.shape.get("tp", 1) == 1:
            return [x + _linear_bf16(a, p[name + ".weight"], p[name + ".bias"]).to(x.dtype)
                    for p, a, x in zip(params, ins, xs)]
        bf = torch.bfloat16
        parts = [torch.matmul(a.to(bf).float(), p[name + ".weight"].to(bf).float().t())
                 for p, a in zip(params, ins)]
        if self.seq_shard:
            parts = along(mesh, "tp", reduce_scatter, parts, dim=1)
        else:
            parts = along(mesh, "tp", tp_all_reduce, parts)
        return [x + (s.to(torch.bfloat16) + p[name + ".bias"].to(torch.bfloat16)).to(x.dtype)
                for p, s, x in zip(params, parts, xs)]

    def _members_attention(self, qs: list, ks: list, vs: list, mesh) -> list:
        """Each member's attention over its heads: within the member when
        the mesh has no ``sp`` axis, else ring or Ulysses over ``sp``."""
        kw = dict(causal=True, window=self.window)
        if mesh.shape.get("sp", 1) == 1:
            attend_fn = full_attention if self.attention == "full" else flash_attention
            return [attend_fn(q, k, v, **kw) for q, k, v in zip(qs, ks, vs)]
        if self.attention == "ring":
            fn = ring_attention_members
        elif self.attention == "ulysses":
            fn = ulysses_attention_members
        else:
            raise ValueError(
                f"an sp axis needs attention='ring' or 'ulysses', got {self.attention!r}"
            )
        return along(mesh, "sp", lambda qkv: fn(*unzip(qkv), **kw), list(zip(qs, ks, vs)))


class TelemetrySequenceModel(nn.Module):
    """Causal next-delta predictor over telemetry streams. ``attention`` is
    ``"full"``, ``"flash"``, ``"ring"`` or ``"ulysses"`` (the last two with
    ``mesh``); the parameters do not depend on it. ``ffn="moe"`` swaps each
    block's MLP for a :class:`~beholder_tpu_torch.ops.moe.SwitchFFN` of
    ``num_experts`` experts (``moe_topk`` 1 or 2, ``moe_router`` "tokens" or
    "experts"; routing groups of 1,024 tokens, as many as ``mesh``'s token
    shards need)."""

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
        num_experts: int = 4,
        moe_topk: int = 1,
        moe_router: str = "tokens",
        remat: bool = False,
        seq_shard: bool = False,
        device=None,
    ):
        super().__init__()
        device = resolve_device(device)
        self.dim, self.heads, self.layers = dim, heads, layers
        self.remat, self.seq_shard, self.ffn = remat, seq_shard, ffn
        self.kv_heads, self.window = kv_heads, window
        self.embed = nn.Linear(FEATURES, dim, device=device)
        self.blocks = nn.ModuleList(
            Block(dim, heads, kv_heads=kv_heads, window=window, attention=attention, mesh=mesh,
                  ffn=ffn, num_experts=num_experts, moe_topk=moe_topk, moe_router=moe_router,
                  seq_shard=seq_shard, device=device)
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
                head_rows: int | None = None, terms: dict | None = None):
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
        (per-layer tuples of member pools; see :meth:`Block.forward`).
        ``terms`` (a dict) receives each MoE layer's router terms under
        ``"block_{i}"``."""
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
            kw = {} if terms is None else {"terms": terms.setdefault(f"block_{i}", {})}
            if remat:
                x = checkpoint(block, x, use_reentrant=False, **kw)
            elif cache is not None:
                x, kv = block(x, cache=(cache[0][i], cache[1][i], cache[2]), group=group, **kw)
                kvs.append(kv)
            elif return_kv:
                x, kv = block(x, return_kv=True, **kw)
                kvs.append(kv)
            else:
                x = block(x, **kw)
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

    def _check_mesh(self, mesh) -> None:
        unknown = set(mesh.axis_names) - {"dp", "tp", "sp", "ep"}
        if unknown:
            raise ValueError(f"mesh axes must come from dp, tp, sp, ep; got {mesh.axis_names}")
        if self.ffn == "moe" and (mesh.shape.get("tp", 1) > 1 or mesh.shape.get("sp", 1) > 1):
            raise ValueError("a sharded MoE model runs on dp and ep axes only")
        if self.ffn != "moe" and mesh.shape.get("ep", 1) > 1:
            raise ValueError("an ep axis needs ffn='moe'")

    def _member_pieces(self, mesh) -> list[int]:
        """Each local member's piece of the sequence, of ``sp`` pieces
        (``sp * tp`` under ``seq_shard``: member (t, s) holds piece ``s * tp
        + t``)."""
        tp = mesh.shape.get("tp", 1) if self.seq_shard else 1
        axes = mesh.axis_names
        out = []
        for c in mesh.local_coords():
            s = c[axes.index("sp")] if "sp" in axes else 0
            t = c[axes.index("tp")] if "tp" in axes and self.seq_shard else 0
            out.append(s * tp + t)
        return out

    def members_forward(self, params: list[dict], feats: list, mesh) -> tuple[list, list]:
        """The forward on every member of ``mesh`` this process holds, in
        lockstep (see :meth:`Block.members_forward`): ``params[i]`` local
        member ``i``'s slices by ``state_dict`` name, ``feats[i]`` its (B/dp,
        T', FEATURES) piece of the batch (:meth:`_member_pieces`). Returns
        each member's (B/dp, T') predictions and its terms
        (``{"block_{i}": {...}}``)."""
        self._check_mesh(mesh)
        xs = [_linear_f32(f, p["embed.weight"], p["embed.bias"]) for p, f in zip(params, feats)]
        terms = [{} for _ in xs]
        remat = self.remat and torch.is_grad_enabled()
        for i, block in enumerate(self.blocks):
            layer = [t.setdefault(f"block_{i}", {}) for t in terms]

            def run(*xs_, block=block, i=i, layer=layer):
                return tuple(block.members_forward(params, list(xs_), mesh, f"blocks.{i}.",
                                                   layer))

            xs = list(checkpoint(run, *xs, use_reentrant=False) if remat else run(*xs))
        preds = [_linear_f32(layer_norm(x, p["ln.weight"], p["ln.bias"]), p["head.weight"],
                             p["head.bias"])[..., 0] for p, x in zip(params, xs)]
        return preds, terms

    def members_loss(self, params: list[dict], feats: torch.Tensor, targets: torch.Tensor,
                     mesh) -> list:
        """Each local member's share of :func:`seq_loss` on the whole ``feats`` /
        ``targets``: its piece's masked squared error over its dp row's
        ``B/dp * (T-1)`` targets, plus the MoE router terms (whole-row
        values on every ep member)."""
        b, t = targets.shape
        pieces = mesh.shape.get("sp", 1) * (mesh.shape.get("tp", 1) if self.seq_shard else 1)
        if t % pieces:
            raise ValueError(f"sequence length {t} does not split {pieces} ways")
        w = t // pieces
        where = self._member_pieces(mesh)
        bd = b // mesh.shape.get("dp", 1)

        def pieces_of(x):
            return [r[:, j * w:(j + 1) * w] for r, j in zip(batch_slices(mesh, x), where)]

        targets = pieces_of(targets)
        preds, terms = self.members_forward(params, pieces_of(feats), mesh)
        losses = []
        for i, (pred, term) in enumerate(zip(preds, terms)):
            err = (pred - targets[i]) ** 2
            live = torch.arange(where[i] * w, (where[i] + 1) * w, device=err.device) != t - 1
            loss = (err * live).sum() / max(bd * (t - 1), 1)
            losses.append(_add_router_terms(loss, term))
        return losses


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


#: the Switch load-balance and ST-MoE z-loss coefficients (the reference's)
AUX_LOSS_WEIGHT = 0.01
Z_LOSS_WEIGHT = 1e-3


def _add_router_terms(loss: torch.Tensor, terms: dict) -> torch.Tensor:
    """``loss`` plus each MoE layer's weighted load-balance and z-loss terms
    (the drop and unrouted fractions are metrics, not losses)."""
    for layer in terms.values():
        if "aux_loss" in layer:
            loss = loss + AUX_LOSS_WEIGHT * layer["aux_loss"]
        if "router_z_loss" in layer:
            loss = loss + Z_LOSS_WEIGHT * layer["router_z_loss"]
    return loss


def seq_loss(model: TelemetrySequenceModel, feats: torch.Tensor,
             targets: torch.Tensor, terms: dict | None = None) -> torch.Tensor:
    """Masked mean squared error of the next-delta predictions (the last
    position's target is padding), plus ``AUX_LOSS_WEIGHT * aux +
    Z_LOSS_WEIGHT * z`` for each MoE layer. ``terms`` (a dict, when given)
    keeps the forward's router terms, for
    :func:`~beholder_tpu_torch.ops.moe.moe_metrics`."""
    terms = {} if terms is None else terms
    err = (model(feats, terms=terms) - targets) ** 2
    mask = torch.ones_like(err)
    mask[:, -1] = 0.0
    return _add_router_terms((err * mask).sum() / torch.clamp(mask.sum(), min=1.0), terms)


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


def pipeline_stages(model: TelemetrySequenceModel, n_stages: int) -> tuple:
    """The model's blocks as ``n_stages`` pipeline stages of ``layers /
    n_stages`` consecutive blocks each (:mod:`beholder_tpu_torch.parallel.pipeline`).
    Returns ``(stage_fn, stage_params)``: each stage's parameters (detached)
    under the ``state_dict`` names of ``nn.Sequential`` over its blocks
    (``"0.ln0.weight"``, ``"1.q_proj.weight"``, ...), and
    ``stage_fn(params, x)``, the stage's blocks in order on a (Bm, T, D)
    residual stream through ``torch.func.functional_call``. Over a tp group
    (tensor parallelism inside the stages) ``params`` and ``x`` are the
    group's member lists, cut megatron's way (``x`` a
    :class:`~beholder_tpu_torch.parallel.collectives.Members` where the
    group is split between processes: its collectives then cross them,
    :func:`~beholder_tpu_torch.parallel.mesh.members_mesh`), and each block
    runs :meth:`Block.members_forward` on them."""
    if n_stages < 1 or model.layers % n_stages:
        raise ValueError(f"{model.layers} layers do not split into {n_stages} stages")
    per = model.layers // n_stages
    stage = nn.Sequential(*model.blocks[:per])
    params = [{f"{k}.{name}": p.detach()
               for k, block in enumerate(model.blocks[i * per:(i + 1) * per])
               for name, p in block.named_parameters()}
              for i in range(n_stages)]

    def stage_fn(params, x):
        if isinstance(x, list):
            mesh = members_mesh(x)
            for k, block in enumerate(stage):
                x = block.members_forward(params, x, mesh, f"{k}.", [{} for _ in x])
            return x
        return torch.func.functional_call(stage, params, (x,))

    return stage_fn, params


def seq_train_step(
    state: TrainState, feats: torch.Tensor, targets: torch.Tensor
) -> tuple[TrainState, torch.Tensor]:
    """One Adam step on :func:`seq_loss`; returns the new state and the
    loss (a 0-d tensor on the device)."""
    return apply_gradients(state, lambda m: seq_loss(m, feats, targets))
