"""Full (O(T^2)) attention: the prefill path's attention.

Counterpart of the reference's ``ops/attention.py::full_attention``, which
is plain XLA there too. Ring and Ulysses attention are not ported yet.
"""

from __future__ import annotations

import torch

_NEG_INF = -1e30


def full_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = False,
    window: int | None = None,
    segment_ids: torch.Tensor | None = None,
) -> torch.Tensor:
    """Reference attention over ``(..., H, T, d)`` q and ``(..., Hkv, T,
    d)`` k/v: group ``g`` of ``H // Hkv`` consecutive q heads reads kv head
    ``h // G`` (GQA; MHA is G=1). ``window`` (with ``causal``) keeps the
    previous ``window`` positions of each row.

    The dtype mix is the reference's: the score product runs in the input
    dtype (bf16 on the main path, rounded there), is divided by an f32
    ``sqrt(d)``, the softmax runs in f32, and the weights are cast back to
    q's dtype before the PV product."""
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
    d = q.shape[-1]
    hkv = k.shape[-3]
    g = q.shape[-3] // hkv
    qg = q.reshape(*q.shape[:-3], hkv, g, *q.shape[-2:])
    scores = torch.matmul(qg, k.unsqueeze(-3).transpose(-1, -2))
    scores = scores.float() / torch.sqrt(torch.tensor(float(d)))
    tq, tk = scores.shape[-2], scores.shape[-1]
    rows = torch.arange(tq, device=q.device)[:, None]
    cols = torch.arange(tk, device=q.device)[None, :]
    if causal:
        scores = scores.masked_fill(rows < cols, _NEG_INF)
    if window is not None:
        scores = scores.masked_fill(rows - cols >= window, _NEG_INF)
    weights = torch.softmax(scores, dim=-1)
    out = torch.matmul(weights.to(q.dtype), v.unsqueeze(-3))
    return out.reshape(*out.shape[:-4], -1, *out.shape[-2:])
