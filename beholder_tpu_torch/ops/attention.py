"""Full (O(T^2)) attention, the dense attention op sequence, and ring
attention.

Counterpart of the reference's ``ops/attention.py``: ``full_attention``
(plain XLA there too), and context parallelism over the ``sp`` axis of a
:class:`~beholder_tpu_torch.parallel.Mesh`: ``ring_attention`` (k/v blocks
rotate around the members) and ``ulysses_attention`` (one all-to-all trades
each member's sequence slice of all heads for the whole sequence of a slice
of the heads, the flash kernels run on those, and one all-to-all trades
back). Each has a member-list form (:func:`ring_attention_members`,
:func:`ulysses_attention_members`) that the sharded training step runs
inside each (dp, tp) member. On a mesh over processes a member list is
this process's share of the ``sp`` group (a
:class:`~beholder_tpu_torch.parallel.collectives.Members`): each process
runs its own shards' kernels, and the k/v blocks (and, backward, their
partial gradients) hop between processes byte for byte.

:func:`attend` is the one dense op sequence of the port: ``full_attention``
(prefill), the dense-cache branch of ``models.sequence.Block`` and the plain
version of the paged chunk kernel all run it, so a fused (paged) forward
and its dense counterpart give the same bits on the same values, as the
reference's shared ``_chunk_block_math`` does for it.
"""

from __future__ import annotations

import torch

from torch.autograd import Function

from beholder_tpu_torch.parallel.collectives import (
    Members,
    all_to_all,
    exchange,
    gather_every,
    group_size,
    like,
    positions,
    shifted,
)

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


def _rotate(blocks: list) -> list:
    """One ring hop: shard ``j`` receives shard ``j - 1``'s block on its
    device (the reference's ppermute ``j -> j + 1``; :func:`ring_shift`'s
    forward, copying nothing between shards on one device; a ring split
    between processes gets the blocks of its other shards from their
    processes)."""
    return shifted(blocks, 1, copy=False)


def _ring_local_fwd(qs, ks, vs, *, block, causal, window=None, backend="flash"):
    """The ring forward over every shard, step-major: each rotation's pair
    for every shard, then the rotation. ``qs``/``ks``/``vs`` hold shard
    ``j``, each on its member's device (this process's shards, a
    :class:`Members`, of a ring split between processes). Returns the
    shards' (o, lse).

    ``backend="flash"`` runs each pair on the flash forward kernel
    (:func:`~beholder_tpu_torch.ops.flash_attention.flash_block_attend`):
    step 0 is the shard's own diagonal block (the kernel's causal mode),
    later steps pass the rotated block's global offsets (none for the
    non-causal ring, which has no mask to place). Each pair's (o, lse),
    o in q's dtype, enters the combine as an (m=lse, l=1, o) block; a dead
    pair (o = 0, lse = -1e30) scales to exactly 0 against the diagonal's
    finite running max. ``backend="einsum"`` runs the plain
    :func:`_block_attend` path."""
    p_size, pos = group_size(qs), positions(qs)
    n_steps = _ring_steps(p_size, block, causal, window)
    kc, vc = like(ks, ks), like(vs, vs)
    states = []
    for j in range(len(qs)):
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
        for j, at in enumerate(pos):
            kv_offset = ((at - step) % p_size) * block
            if backend == "flash":
                offs = dict(q_offset=at * block, kv_offset=kv_offset) if causal and step else {}
                ob, lb = flash_block_attend(qs[j], kc[j], vc[j], causal=causal, window=window,
                                            **offs)
                blk = (lb, torch.ones_like(lb), ob.float())
                states[j] = blk if step == 0 else _combine(states[j], blk)
            else:
                blk = _block_attend(qs[j], kc[j], vc[j], at * block, kv_offset, causal, window)
                states[j] = _combine(states[j], blk)
        if step < n_steps - 1:
            kc, vc = _rotate(kc), _rotate(vc)
    outs, lses = [], []
    for q, (m, l, o) in zip(qs, states):
        # causal rows see at least their own position and non-causal rows
        # every block, so l > 0
        outs.append((o / l[..., None]).reshape(q.shape).to(q.dtype))
        lses.append((m + torch.log(torch.clamp(l, min=1e-37))).reshape(q.shape[:-1]))
    return outs, lses


def _ring_local_bwd(qs, ks, vs, os_, lses, dos, *, block, causal, window=None,
                    backend="flash"):
    """The ring backward over every shard, step-major: dq accumulates per
    shard in f32; each kv block's (dk, dv) partial travels with the block,
    summing the contributions of shard j, j + 1, ... in that order, then
    jumps home. Returns the shards' (dq, dk, dv) in their inputs' dtypes.

    ``backend="flash"`` runs each pair on the dq and dk/dv kernels
    (:func:`~beholder_tpu_torch.ops.flash_attention.flash_block_backward`)
    from the saved GLOBAL lse, with ``delta = rowsum(do * o)`` computed once
    per shard; ``backend="einsum"`` runs the reference's plain path."""
    p_size, pos = group_size(qs), positions(qs)
    n_steps = _ring_steps(p_size, block, causal, window)
    devices = [q.device for q in qs]
    kc, vc = like(ks, ks), like(vs, vs)
    dkc = like(ks, [torch.zeros(k.shape, device=k.device) for k in ks])
    dvc = like(vs, [torch.zeros(v.shape, device=v.device) for v in vs])
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
        for j, at in enumerate(pos):
            kv_offset = ((at - step) % p_size) * block
            if backend == "flash":
                offs = dict(q_offset=at * block, kv_offset=kv_offset) if causal and step else {}
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
                live = _causal_live(qg.shape[-2], kc[j].shape[-2], at * block, kv_offset,
                                    window, qg.device)
                s = torch.where(live, s, _NEG_INF)
            p = torch.exp(s - lsegs[j][..., None])    # transient (T/P, T/P) block
            dvc[j] = dvc[j] + torch.einsum("...gqk,...gqd->...kd", p, dog)
            dp = torch.einsum("...gqd,...kd->...gqk", dog, vc[j].float())
            ds = (p * (dp - deltags[j][..., None]) * scale).to(qs[j].dtype)
            dq[j] = dq[j] + torch.einsum("...gqk,...kd->...gqd", ds, kc[j]).float()
            dkc[j] = dkc[j] + torch.einsum("...gqk,...gqd->...kd", ds.float(), qg.float())
        if step < n_steps - 1:
            kc, vc = _rotate(kc), _rotate(vc)
            dkc, dvc = _rotate(dkc), _rotate(dvc)
    # the partials have hopped n_steps - 1 times: shard j holds block
    # j - (n_steps - 1); send each home in one jump
    home = n_steps - 1
    if isinstance(qs, Members) and home:
        every = gather_every(qs.group, list(zip(dkc, dvc)))
        dkc, dvc = [e[0] for e in every], [e[1] for e in every]
        src = {j: (at + home) % p_size for j, at in enumerate(pos)}
    else:
        src = {j: (j + home) % p_size for j in range(len(qs))}
    dk = [dkc[src[j]].to(devices[j]).to(ks[j].dtype) for j in range(len(qs))]
    dv = [dvc[src[j]].to(devices[j]).to(vs[j].dtype) for j in range(len(qs))]
    dq = [g.reshape(q.shape).to(q.dtype) for g, q in zip(dq, qs)]
    return dq, dk, dv


def _shards(mesh, x: torch.Tensor, dim: int) -> list:
    """``x`` cut along ``dim`` into the mesh's P blocks, block ``j`` on
    device ``j``, each contiguous once here rather than at every pair: the
    blocks of the members this process holds."""
    chunks = x.chunk(mesh.shape["sp"], dim=dim)
    return [mesh.to(chunks[j].contiguous(), j) for j in mesh.local]


class _ScatterWhole(Function):
    """Whole tensors that every process of a mesh holds, cut along ``dim``
    into the one-axis ``mesh``'s P blocks: forward returns the chain token
    and, tensor by tensor, the blocks of this process's members on their
    devices; backward gathers every block's cotangent from its owner (every
    process takes part) and concatenates them, the one-process cut's own
    backward."""

    @staticmethod
    def forward(ctx, mesh, dim, token, *xs):
        ctx.mesh, ctx.dim = mesh, dim
        ctx.like = [(tuple(c.shape), x.dtype, x.device) for x in xs
                    for c in x.chunk(mesh.shape["sp"], dim=dim)[:1]]
        return (token.new_empty(0), *(b for x in xs for b in _shards(mesh, x, dim)))

    @staticmethod
    def backward(ctx, g_token, *gs):
        mesh, n = ctx.mesh, len(ctx.mesh.local)
        mine = {(f, j): g for f in range(len(ctx.like))
                for j, g in zip(mesh.local, gs[f * n:(f + 1) * n])}
        items = [((f, j), mesh.owners[j], shape, dtype)
                 for f, (shape, dtype, _) in enumerate(ctx.like) for j in range(mesh.size)]
        got = exchange(items, mine, ctx.like[0][2])
        return (None, None, torch.zeros_like(g_token),
                *(torch.cat([got[f, j].to(device) for j in range(mesh.size)], dim=ctx.dim)
                  for f, (_, _, device) in enumerate(ctx.like)))


class _GatherWhole(Function):
    """The one-axis ``mesh``'s output blocks concatenated along ``dim``, on
    every process (every process takes part): this process's members'
    blocks as given, the others' from their owners. Backward keeps each
    member's own block of the cotangent, the loss over the whole being
    replicated."""

    @staticmethod
    def forward(ctx, mesh, dim, shape, dtype, device, token, *mine):
        ctx.mesh, ctx.dim = mesh, dim
        got = exchange([(j, mesh.owners[j], shape, dtype) for j in range(mesh.size)],
                       dict(zip(mesh.local, mine)), device)
        return torch.cat([got[j].to(device) for j in range(mesh.size)], dim=dim)

    @staticmethod
    def backward(ctx, g):
        blocks = g.chunk(ctx.mesh.size, dim=ctx.dim)
        return (None, None, None, None, None, g.new_zeros(0),
                *(blocks[j] for j in ctx.mesh.local))


def _across_processes(mesh, attend, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, dim: int):
    """``attend(qs, ks, vs)`` over the one-axis ``mesh``'s blocks of whole
    tensors every process holds, whose members span processes: each process
    cuts out its members' blocks, runs ``attend`` on them (a plain list when
    it holds the whole group, a :class:`Members` of its share otherwise,
    nothing when it holds none), and gets the whole output back."""
    grad = torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v))
    token = torch.zeros(0, device=q.device, requires_grad=grad)
    token, *blocks = _ScatterWhole.apply(mesh, dim, token, q, k, v)
    n = len(mesh.local)
    outs = []
    if n:
        lists = [blocks[f * n:(f + 1) * n] for f in range(3)]
        if n < mesh.size:
            lists = [Members(b, mesh.layout("sp", 0)) for b in lists]
        outs = attend(*lists)
    shape = tuple(q.chunk(mesh.size, dim=dim)[0].shape)
    return _GatherWhole.apply(mesh, dim, shape, q.dtype, q.device, token, *outs)


def _sp_mesh(mesh, at: dict | None = None):
    """The one-axis ``sp`` mesh of ``mesh`` (at ``at``'s other coordinates,
    0 where not given)."""
    if "sp" not in mesh.shape:
        raise ValueError(f"context parallelism needs an 'sp' axis, got {mesh.axis_names}")
    return mesh if mesh.axis_names == ("sp",) else mesh.axis_mesh("sp", at)


class RingShards(torch.autograd.Function):
    """The reference's custom VJP ``_ring_vjp`` over P member shards: the
    forward saves only each shard's q, k, v, o and per-row logsumexp; the
    backward re-rotates k/v around the ring and recomputes each pair's
    probabilities from that lse, so no (T/P, T/P) block outlives its step.
    Inputs are the q shards, then the k and the v shards: every shard of
    the ring (``group`` None), or this process's shards of a ring split
    between processes (``group`` its layout), whose rotations then cross
    processes forward and backward."""

    @staticmethod
    def forward(ctx, group, causal, window, backend, *qkv):
        p = len(qkv) // 3
        qs, ks, vs = (_listed(qkv[f * p:(f + 1) * p], group) for f in range(3))
        block = qs[0].shape[-2]
        outs, lses = _ring_local_fwd(qs, ks, vs, block=block, causal=causal, window=window,
                                     backend=backend)
        ctx.save_for_backward(*qkv, *outs, *lses)
        ctx.group, ctx.causal, ctx.window, ctx.backend = group, causal, window, backend
        return tuple(outs)

    @staticmethod
    def backward(ctx, *dos):
        p, group = len(dos), ctx.group
        saved = ctx.saved_tensors
        qs, ks, vs = (_listed(saved[f * p:(f + 1) * p], group) for f in range(3))
        outs, lses = saved[3 * p:4 * p], saved[4 * p:]
        dq, dk, dv = _ring_local_bwd(
            qs, ks, vs, outs, lses, [d.contiguous() for d in dos], block=qs[0].shape[-2],
            causal=ctx.causal, window=ctx.window, backend=ctx.backend,
        )
        return (None, None, None, None, *dq, *dk, *dv)


def _listed(xs, group) -> list:
    return list(xs) if group is None else Members(xs, group)


def _check_window(causal: bool, window) -> None:
    if window is not None:
        if not causal:
            raise ValueError("window requires causal=True")
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")


def ring_attention_members(qs: list, ks: list, vs: list, causal: bool = False,
                           window: int | None = None, backend: str = "flash") -> list:
    """Ring attention over P members' shards: ``qs[j]`` (..., T/P, d) holds
    rows ``j*T/P ..`` on member ``j``'s device, ``ks``/``vs`` likewise
    (GQA: fewer heads on dim -3); a :class:`Members` holds this process's
    shards of a ring split between processes. Returns each member's output
    shard, on its device; differentiable through :class:`RingShards`."""
    _check_window(causal, window)
    q = qs[0]
    if q.ndim >= 3 and ks[0].shape[-3] != q.shape[-3] and q.shape[-3] % ks[0].shape[-3]:
        raise ValueError(
            f"GQA q heads must be a multiple of kv heads; got "
            f"{tuple(q.shape)} vs {tuple(ks[0].shape)}"
        )
    if backend not in ("flash", "einsum"):
        raise ValueError(f"backend must be 'flash' or 'einsum', got {backend!r}")
    if backend == "flash":
        check_backward_head_dim(q, ks[0], vs[0])
    group = qs.group if isinstance(qs, Members) else None
    qs, ks, vs = ([x.contiguous() for x in xs] for xs in (qs, ks, vs))
    return _listed(RingShards.apply(group, causal, window, backend, *qs, *ks, *vs), group)


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
    :class:`~beholder_tpu_torch.parallel.Mesh`; on a mesh of more axes, its
    ``sp`` members at coordinate 0 of the others), differentiable in q, k
    and v through :class:`RingShards`.

    Inputs are ``(..., T, d)`` tensors, cut along T into P blocks, block
    ``j`` on the mesh's device ``j``; T must divide by P. The output is
    whole, on q's device, and matches :func:`full_attention` up to float
    tolerance. GQA is native: k/v may carry fewer heads on dim -3 and
    rotate at kv-head width. ``window`` (requires ``causal``) bounds the
    rotations (:func:`_ring_steps`). ``backend="flash"`` (the default) runs
    every pair on the flash kernels, ``"einsum"`` the plain block path; on
    the card a flash call the backward kernels would refuse (a head dim
    over 128, a dtype other than bf16 and f32) whose inputs require a
    gradient raises before it launches. On a
    mesh over processes every process passes the whole tensors and gets
    the whole output (and q, k and v their whole gradients); each runs the
    pairs of its own members."""
    across = mesh.crosses_processes
    mesh = _sp_mesh(mesh)
    p_size = mesh.shape["sp"]
    t = q.shape[-2]
    if t % p_size:
        raise ValueError(f"sequence length {t} not divisible by sp={p_size}")
    kw = dict(causal=causal, window=window, backend=backend)
    if across:
        return _across_processes(
            mesh, lambda qs, ks, vs: ring_attention_members(qs, ks, vs, **kw), q, k, v, -2)
    outs = ring_attention_members(*(_shards(mesh, x, -2) for x in (q, k, v)), **kw)
    return torch.cat([o.to(q.device) for o in outs], dim=-2)


def ulysses_attention_members(qs: list, ks: list, vs: list, causal: bool = False,
                              window: int | None = None, backend: str = "flash") -> list:
    """Ulysses over P members' (B, H', T/P, d) shards (``H'`` the heads a
    member holds, after any tp split): an all-to-all gives each member the
    whole sequence of ``H'/P`` heads, :func:`flash_attention` (or
    ``full_attention`` for ``backend="full"``) runs on them, an all-to-all
    trades back. kv heads that do not split P ways are broadcast to the q
    heads first (whole GQA groups, so each q head keeps its kv head). A
    :class:`Members` holds this process's shards of a group split between
    processes; its exchanges cross them."""

    from .flash_attention import flash_attention

    _check_window(causal, window)
    p = group_size(qs)
    h, hkv = qs[0].shape[-3], ks[0].shape[-3]
    if h % hkv:
        raise ValueError(f"GQA q heads must be a multiple of kv heads; got {h} vs {hkv}")
    if h % p:
        raise ValueError(f"per-device heads {h} not divisible by sp={p}")
    if hkv % p:
        ks = like(ks, [k.repeat_interleave(h // hkv, dim=-3) for k in ks])
        vs = like(vs, [v.repeat_interleave(h // hkv, dim=-3) for v in vs])
    attend = flash_attention if backend == "flash" else full_attention
    qh, kh, vh = (all_to_all(xs, split_dim=-3, concat_dim=-2) for xs in (qs, ks, vs))
    att = like(qh, [attend(q, k, v, causal=causal, window=window) for q, k, v in zip(qh, kh, vh)])
    return all_to_all(att, split_dim=-2, concat_dim=-3)


def ulysses_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mesh,
    axis: str = "sp",
    causal: bool = False,
    backend: str = "flash",
    window: int | None = None,
) -> torch.Tensor:
    """DeepSpeed-Ulysses over the ``axis`` of ``mesh`` on whole (B, H, T, d)
    tensors: T is cut into P slices, one a member; on a mesh with ``tp`` the
    heads are first cut into tp column shards (megatron's layout) and each
    runs its own exchange over its ``sp`` members. The reference's checks
    and GQA rules: ``H / tp`` must divide by P and T by P; when the kv heads
    do not split over tp they are broadcast to H first; otherwise the
    exchange stays at kv-head width when ``(Hkv / tp) % P == 0`` and
    broadcasts the groups inside each member when not. ``window`` requires
    ``causal``. The output is whole, on q's device; on a mesh over
    processes every process passes the whole tensors and gets the whole
    output, each running its own members' exchanges and kernels."""
    if axis != "sp":
        raise ValueError(f"Ulysses runs over the 'sp' axis, got {axis!r}")
    p_size = mesh.shape[axis]
    b, h, t, d = q.shape
    hkv = k.shape[1]
    if h % hkv:
        raise ValueError(f"GQA q heads must be a multiple of kv heads; got {h} vs {hkv}")
    _check_window(causal, window)
    tp = mesh.shape.get("tp", 1)
    h_local = h // tp
    if h_local % p_size:
        raise ValueError(f"per-device heads {h_local} not divisible by {axis}={p_size}")
    if t % p_size:
        raise ValueError(f"sequence length {t} not divisible by {axis}={p_size}")
    if hkv % tp:
        k = k.repeat_interleave(h // hkv, dim=1)
        v = v.repeat_interleave(h // hkv, dim=1)
        hkv = h
    if backend not in ("flash", "full"):
        raise ValueError(f"backend must be 'flash' or 'full', got {backend!r}")
    kv_local = hkv // tp
    kw = dict(causal=causal, window=window, backend=backend)
    outs = []
    for i in range(tp):
        sub = _sp_mesh(mesh, {"tp": i})
        heads = slice(i * h_local, (i + 1) * h_local)
        kv_heads = slice(i * kv_local, (i + 1) * kv_local)
        qi, ki, vi = q[:, heads], k[:, kv_heads], v[:, kv_heads]
        if mesh.crosses_processes:
            outs.append(_across_processes(
                sub, lambda qs, ks, vs: ulysses_attention_members(qs, ks, vs, **kw), qi, ki, vi,
                -2))
            continue
        shards = ulysses_attention_members(
            _shards(sub, qi, -2), _shards(sub, ki, -2), _shards(sub, vi, -2), **kw)
        outs.append(torch.cat([o.to(q.device) for o in shards], dim=-2))
    return torch.cat(outs, dim=1)


def sequence_sharding(mesh, x: torch.Tensor, axis: str = "sp") -> list:
    """``x`` cut along its sequence dim (-2) into one slice a member of
    ``mesh``'s ``axis``, each on its member's device: the counterpart of the
    reference's ``NamedSharding`` with the sequence dim on ``axis``."""
    return _shards(_sp_mesh(mesh) if axis == "sp" else mesh.axis_mesh(axis), x, -2)
