"""Full (O(T^2)) attention, the dense attention op sequence, and ring
attention.

Counterpart of the reference's ``ops/attention.py``: ``full_attention``
(plain XLA there too) and ``ring_attention``, context parallelism over the
``sp`` axis of a :class:`~beholder_tpu_torch.parallel.Mesh`. Ulysses
attention is not ported yet.

:func:`attend` is the one dense op sequence of the port: ``full_attention``
(prefill), the dense-cache branch of ``models.sequence.Block`` and the plain
version of the paged chunk kernel all run it, so a fused (paged) forward
and its dense counterpart give the same bits on the same values, as the
reference's shared ``_chunk_block_math`` does for it.
"""

from __future__ import annotations

import torch

from .flash_attention import (
    check_backward_head_dim,
    flash_block_attend,
    flash_block_backward,
    flash_delta,
)

_NEG_INF = -1e30


def attend(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    live: torch.Tensor | None = None,
) -> torch.Tensor:
    """Masked softmax attention of ``(..., H, t, d)`` q over ``(..., Hkv,
    L, d)`` k/v with the reference's dtype mix: the score product runs in
    k's dtype (bf16 on the serving paths, rounded there), is divided by an
    f32 ``sqrt(d)``, masked to -1e30 where ``live`` is false, softmaxed in
    f32, and the weights are cast to q's dtype before the PV product. GQA:
    group ``g`` of ``H // Hkv`` consecutive q heads reads kv head ``h //
    G``. ``live`` broadcasts against the grouped scores ``(..., Hkv, G, t,
    L)``. Operands are made contiguous first, so equal values give equal
    bits whatever view they came in as."""
    d = q.shape[-1]
    hkv = k.shape[-3]
    g = q.shape[-3] // hkv
    qg = q.to(k.dtype).reshape(*q.shape[:-3], hkv, g, *q.shape[-2:]).contiguous()
    k = k.contiguous()
    v = v.contiguous()
    scores = torch.matmul(qg, k.unsqueeze(-3).transpose(-1, -2))
    scores = scores.float() / torch.sqrt(torch.tensor(float(d)))
    if live is not None:
        scores = torch.where(live, scores, _NEG_INF)
    weights = torch.softmax(scores, dim=-1)
    out = torch.matmul(weights.to(q.dtype), v.unsqueeze(-3))
    return out.reshape(*out.shape[:-4], -1, *out.shape[-2:])


def full_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = False,
    window: int | None = None,
    segment_ids: torch.Tensor | None = None,
) -> torch.Tensor:
    """Reference attention over ``(..., H, T, d)`` q and ``(..., Hkv, T,
    d)`` k/v (see :func:`attend`). ``window`` (with ``causal``) keeps the
    previous ``window`` positions of each row; ``segment_ids``
    (``q.shape[:-3] + (T,)``) masks attention across segments."""
    if window is not None:
        if not causal:
            raise ValueError("window requires causal=True")
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
    if q.ndim < 3:
        raise ValueError(f"q must be (..., heads, T, d), got {tuple(q.shape)}")
    if q.shape[-3] % k.shape[-3]:
        raise ValueError(
            f"GQA q heads must be a multiple of kv heads; got "
            f"{tuple(q.shape)} vs {tuple(k.shape)}"
        )
    rows = torch.arange(q.shape[-2], device=q.device)[:, None]
    cols = torch.arange(k.shape[-2], device=q.device)[None, :]
    live = None
    if causal:
        live = rows >= cols
    if window is not None:
        live = live & (rows - cols < window)
    if segment_ids is not None:
        same = segment_ids[..., :, None] == segment_ids[..., None, :]
        # (..., T, T) -> the grouped scores' (..., Hkv, G, T, T)
        same = same[..., None, None, :, :]
        live = same if live is None else live & same
    return attend(q, k, v, live)


# -- ring attention -------------------------------------------------------------


def _grouped(q, k):
    """GQA group view: (..., H, t, d) q against (..., Hkv, t, d) kv -> q
    reshaped (..., Hkv, G, t, d); rank-2 (t, d) inputs get a singleton
    group axis."""
    if q.ndim == 2:
        return q[None], 1
    hkv = k.shape[-3]
    g = q.shape[-3] // hkv
    return q.reshape(*q.shape[:-3], hkv, g, *q.shape[-2:]), g


def _causal_live(tq, tk, q_offset, kv_offset, window, device):
    """(tq, tk) mask on global positions: row ``q_offset + i`` sees key
    ``kv_offset + j`` at or before it, within ``window``."""
    rows = q_offset + torch.arange(tq, device=device)[:, None]
    cols = kv_offset + torch.arange(tk, device=device)[None, :]
    live = rows >= cols
    if window is not None:
        live = live & (rows - cols < window)
    return live


def _block_attend(q, k, v, q_offset, kv_offset, causal, window=None):
    """Scores of a local q block against one k/v block and its flash
    partials (the reference's plain path): (m, p_sum, pv), the row max, the
    exp-sum and the exp-weighted values, in the grouped (..., Hkv, G, tq,
    ...) layout. The score product runs in k's dtype, is divided by an f32
    ``sqrt(d)``; p is cast to v's dtype before PV."""
    d = q.shape[-1]
    qg, _ = _grouped(q, k)
    scores = torch.matmul(qg, k.unsqueeze(-3).transpose(-1, -2))
    scores = scores.float() / torch.sqrt(torch.tensor(float(d)))
    if causal:
        live = _causal_live(q.shape[-2], k.shape[-2], q_offset, kv_offset, window, q.device)
        scores = torch.where(live, scores, _NEG_INF)
    m = scores.amax(dim=-1)
    p = torch.exp(scores - m[..., None])
    p_sum = p.sum(dim=-1)
    pv = torch.matmul(p.to(v.dtype), v.unsqueeze(-3)).float()
    return m, p_sum, pv


def _combine(state, block):
    """Online-softmax combine of a running (m, l, o) with a new block."""
    m, l, o = state
    bm, bl, bo = block
    m_new = torch.maximum(m, bm)
    scale_old = torch.exp(m - m_new)
    scale_new = torch.exp(bm - m_new)
    l_new = l * scale_old + bl * scale_new
    o_new = o * scale_old[..., None] + bo * scale_new[..., None]
    return m_new, l_new, o_new


def _ring_steps(p_size: int, block: int, causal: bool, window) -> int:
    """Ring rotations that can ever hit live blocks: under a causal window,
    block pair (qi, kj) is live only while (qi - kj - 1) * block + 1 <
    window, so later rotations carry blocks dead on every shard and are
    skipped."""
    if not causal or window is None:
        return p_size
    reach = 0 if window <= 1 else 1 + (window - 2) // block
    return min(p_size, reach + 1)


def _rotate(mesh, blocks: list) -> list:
    """One ring hop: shard ``j`` receives shard ``j - 1``'s block, moved to
    its device (the reference's ppermute ``j -> j + 1``)."""
    p = len(blocks)
    return [mesh.to(blocks[(j - 1) % p], j) for j in range(p)]


def _ring_local_fwd(mesh, qs, ks, vs, *, block, causal, window=None, backend="flash"):
    """The ring forward over every shard, step-major: each rotation's pair
    for every shard, then the rotation. ``qs``/``ks``/``vs`` hold shard
    ``j`` on ``mesh.devices[j]``. Returns the shards' (o, lse).

    ``backend="flash"`` runs each pair on the flash forward kernel
    (:func:`~beholder_tpu_torch.ops.flash_attention.flash_block_attend`):
    step 0 is the shard's own diagonal block (the kernel's causal mode),
    later steps pass the rotated block's global offsets (none for the
    non-causal ring, which has no mask to place). Each pair's (o, lse),
    o in q's dtype, enters the combine as an (m=lse, l=1, o) block; a dead
    pair (o = 0, lse = -1e30) scales to exactly 0 against the diagonal's
    finite running max. ``backend="einsum"`` runs the plain
    :func:`_block_attend` path."""
    p_size = len(qs)
    n_steps = _ring_steps(p_size, block, causal, window)
    kc, vc = list(ks), list(vs)
    states = []
    for j in range(p_size):
        if backend == "flash":
            states.append(None)
        else:
            qg, _ = _grouped(qs[j], ks[j])
            states.append((
                torch.full(qg.shape[:-1], _NEG_INF, device=qg.device),
                torch.zeros(qg.shape[:-1], device=qg.device),
                torch.zeros(qg.shape, device=qg.device),
            ))
    for step in range(n_steps):
        for j in range(p_size):
            kv_offset = ((j - step) % p_size) * block
            if backend == "flash":
                offs = dict(q_offset=j * block, kv_offset=kv_offset) if causal and step else {}
                ob, lb = flash_block_attend(qs[j], kc[j], vc[j], causal=causal, window=window,
                                            **offs)
                blk = (lb, torch.ones_like(lb), ob.float())
                states[j] = blk if step == 0 else _combine(states[j], blk)
            else:
                blk = _block_attend(qs[j], kc[j], vc[j], j * block, kv_offset, causal, window)
                states[j] = _combine(states[j], blk)
        if step < n_steps - 1:
            kc, vc = _rotate(mesh, kc), _rotate(mesh, vc)
    outs, lses = [], []
    for q, (m, l, o) in zip(qs, states):
        # causal rows see at least their own position and non-causal rows
        # every block, so l > 0
        outs.append((o / l[..., None]).reshape(q.shape).to(q.dtype))
        lses.append((m + torch.log(torch.clamp(l, min=1e-37))).reshape(q.shape[:-1]))
    return outs, lses


def _ring_local_bwd(mesh, qs, ks, vs, os_, lses, dos, *, block, causal, window=None,
                    backend="flash"):
    """The ring backward over every shard, step-major: dq accumulates per
    shard in f32; each kv block's (dk, dv) partial travels with the block,
    summing the contributions of shard j, j + 1, ... in that order, then
    jumps home. Returns the shards' (dq, dk, dv) in their inputs' dtypes.

    ``backend="flash"`` runs each pair on the dq and dk/dv kernels
    (:func:`~beholder_tpu_torch.ops.flash_attention.flash_block_backward`)
    from the saved GLOBAL lse, with ``delta = rowsum(do * o)`` computed once
    per shard; ``backend="einsum"`` runs the reference's plain path."""
    p_size = len(qs)
    n_steps = _ring_steps(p_size, block, causal, window)
    kc, vc = list(ks), list(vs)
    dkc = [torch.zeros(k.shape, device=k.device) for k in ks]
    dvc = [torch.zeros(v.shape, device=v.device) for v in vs]
    if backend == "flash":
        deltas = [flash_delta(o, do) for o, do in zip(os_, dos)]
        dq = [torch.zeros(q.shape, device=q.device) for q in qs]
    else:
        scale = 1.0 / torch.sqrt(torch.tensor(float(qs[0].shape[-1])))
        qgs = [_grouped(q, k)[0] for q, k in zip(qs, ks)]
        dogs = [do.float().reshape(qg.shape) for do, qg in zip(dos, qgs)]
        deltags = [(do.float() * o.float()).sum(dim=-1).reshape(qg.shape[:-1])
                   for do, o, qg in zip(dos, os_, qgs)]
        lsegs = [lse.reshape(qg.shape[:-1]) for lse, qg in zip(lses, qgs)]
        dq = [torch.zeros(qg.shape, device=qg.device) for qg in qgs]
    for step in range(n_steps):
        for j in range(p_size):
            kv_offset = ((j - step) % p_size) * block
            if backend == "flash":
                offs = dict(q_offset=j * block, kv_offset=kv_offset) if causal and step else {}
                dq_s, dk_s, dv_s = flash_block_backward(
                    qs[j], kc[j], vc[j], os_[j], lses[j], dos[j], causal=causal,
                    window=window, delta=deltas[j], **offs,
                )
                dq[j] = dq[j] + dq_s.float()
                dkc[j] = dkc[j] + dk_s.float()
                dvc[j] = dvc[j] + dv_s.float()
                continue
            qg, dog = qgs[j], dogs[j]
            s = torch.matmul(qg, kc[j].unsqueeze(-3).transpose(-1, -2)).float() * scale
            if causal:
                live = _causal_live(qg.shape[-2], kc[j].shape[-2], j * block, kv_offset,
                                    window, qg.device)
                s = torch.where(live, s, _NEG_INF)
            p = torch.exp(s - lsegs[j][..., None])    # transient (T/P, T/P) block
            dvc[j] = dvc[j] + torch.einsum("...gqk,...gqd->...kd", p, dog)
            dp = torch.einsum("...gqd,...kd->...gqk", dog, vc[j].float())
            ds = (p * (dp - deltags[j][..., None]) * scale).to(qs[j].dtype)
            dq[j] = dq[j] + torch.einsum("...gqk,...kd->...gqd", ds, kc[j]).float()
            dkc[j] = dkc[j] + torch.einsum("...gqk,...gqd->...kd", ds.float(), qg.float())
        if step < n_steps - 1:
            kc, vc = _rotate(mesh, kc), _rotate(mesh, vc)
            dkc, dvc = _rotate(mesh, dkc), _rotate(mesh, dvc)
    # the partials have hopped n_steps - 1 times: shard j holds block
    # j - (n_steps - 1); send each home in one jump
    home = n_steps - 1
    dk = [mesh.to(dkc[(b + home) % p_size], b).to(ks[b].dtype) for b in range(p_size)]
    dv = [mesh.to(dvc[(b + home) % p_size], b).to(vs[b].dtype) for b in range(p_size)]
    dq = [g.reshape(q.shape).to(q.dtype) for g, q in zip(dq, qs)]
    return dq, dk, dv


def _shards(mesh, x: torch.Tensor, dim: int) -> list:
    """``x`` cut along ``dim`` into the mesh's P blocks, block ``j`` on
    device ``j``, each contiguous once here rather than at every pair."""
    return [mesh.to(c.contiguous(), j)
            for j, c in enumerate(x.chunk(mesh.shape["sp"], dim=dim))]


class RingAttention(torch.autograd.Function):
    """The reference's custom VJP ``_ring_vjp``: the forward saves only q,
    k, v, o and the per-row logsumexp; the backward re-rotates k/v around
    the ring and recomputes each pair's probabilities from that lse, so no
    (T/P, T/P) block outlives its step."""

    @staticmethod
    def forward(ctx, q, k, v, mesh, causal, window, backend):
        block = q.shape[-2] // mesh.shape["sp"]
        outs, lses = _ring_local_fwd(
            mesh, _shards(mesh, q, -2), _shards(mesh, k, -2), _shards(mesh, v, -2),
            block=block, causal=causal, window=window, backend=backend,
        )
        o = torch.cat([x.to(q.device) for x in outs], dim=-2)
        lse = torch.cat([x.to(q.device) for x in lses], dim=-1)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.mesh, ctx.causal, ctx.window, ctx.backend = mesh, causal, window, backend
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        mesh = ctx.mesh
        grads = _ring_local_bwd(
            mesh, *(_shards(mesh, x, -2) for x in (q, k, v, o)), _shards(mesh, lse, -1),
            _shards(mesh, do, -2), block=q.shape[-2] // mesh.shape["sp"],
            causal=ctx.causal, window=ctx.window, backend=ctx.backend,
        )
        dq, dk, dv = (torch.cat([g.to(x.device) for g in gs], dim=-2)
                      for gs, x in zip(grads, (q, k, v)))
        return dq, dk, dv, None, None, None, None


def ring_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mesh,
    causal: bool = False,
    window: int | None = None,
    backend: str = "flash",
) -> torch.Tensor:
    """Context-parallel attention over the ``sp`` axis of ``mesh`` (a
    :class:`~beholder_tpu_torch.parallel.Mesh`), differentiable in q, k and
    v through :class:`RingAttention`.

    Inputs are ``(..., T, d)`` tensors, cut along T into P blocks, block
    ``j`` on the mesh's device ``j``; T must divide by P. The output is
    whole, on q's device, and matches :func:`full_attention` up to float
    tolerance. GQA is native: k/v may carry fewer heads on dim -3 and
    rotate at kv-head width. ``window`` (requires ``causal``) bounds the
    rotations (:func:`_ring_steps`). ``backend="flash"`` (the default) runs
    every pair on the flash kernels, ``"einsum"`` the plain block path; on
    the card at a head dim only the forward kernel takes (128), a flash
    call whose inputs require a gradient raises before it launches."""
    p_size = mesh.shape["sp"]
    t = q.shape[-2]
    if t % p_size:
        raise ValueError(f"sequence length {t} not divisible by sp={p_size}")
    if window is not None:
        if not causal:
            raise ValueError("window requires causal=True")
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
    if q.ndim >= 3 and k.shape[-3] != q.shape[-3] and q.shape[-3] % k.shape[-3]:
        raise ValueError(
            f"GQA q heads must be a multiple of kv heads; got "
            f"{tuple(q.shape)} vs {tuple(k.shape)}"
        )
    if backend not in ("flash", "einsum"):
        raise ValueError(f"backend must be 'flash' or 'einsum', got {backend!r}")
    if backend == "flash":
        check_backward_head_dim(q, k, v)
    return RingAttention.apply(q, k, v, mesh, causal, window, backend)
