"""Full (O(T^2)) attention and the dense attention op sequence.

Counterpart of the reference's ``ops/attention.py::full_attention``, which
is plain XLA there too. Ring and Ulysses attention are not ported yet.

:func:`attend` is the one dense op sequence of the port: ``full_attention``
(prefill), the dense-cache branch of ``models.sequence.Block`` and the plain
version of the paged chunk kernel all run it, so a fused (paged) forward
and its dense counterpart give the same bits on the same values, as the
reference's shared ``_chunk_block_math`` does for it.
"""

from __future__ import annotations

import torch

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
    previous ``window`` positions of each row."""
    if segment_ids is not None:
        raise NotImplementedError("segment ids are not ported yet")
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
    return attend(q, k, v, live)
