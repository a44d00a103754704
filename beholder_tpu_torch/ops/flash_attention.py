"""Flash attention, forward and backward: three CUDA kernels for Hopper and
their plain versions.

Counterpart of the reference's ``ops/flash_attention.py``. The public
:func:`flash_attention` takes ``(..., H, T, d)`` q and ``(..., Hkv, T, d)``
k/v like the reference and is differentiable through :class:`FlashAttention`
(the reference's custom VJP ``_flash``), which saves ``q, k, v, o, lse``
and nothing of size T x T.

Per kernel, a wrapper with a ``launches`` count, over flattened
``(B*H, T, Dh)`` q and ``(B*Hkv, T, Dh)`` k/v (GQA: q head ``bh`` reads kv
head ``bh // G``):

- :func:`flash_forward` -> ``(o, lse)``: kernel ``csrc/flash_fwd.cu``,
  plain version :func:`flash_forward_reference`;
- :func:`flash_backward_dq` -> ``dq``: kernel ``flash_dq_kernel`` in
  ``csrc/flash_bwd.cu``, plain version :func:`flash_dq_reference`;
- :func:`flash_backward_dkv` -> ``(dk, dv)`` at kv-head shape, summed over
  the GQA group: kernel ``flash_dkv_kernel`` in ``csrc/flash_bwd.cu``,
  plain version :func:`flash_dkv_reference`.

Each wrapper takes ``offsets=(q_offset, kv_offset)``, the ring block-pair
mode of the reference's kernels: the causal and window masks then compare
global positions, row ``r + q_offset`` against key ``c + kv_offset`` (the
kernels take the two ints by value, so a launch reads nothing back from
the device). A fully dead pair gives ``o = 0`` and ``lse = -1e30``. Each
wrapper counts its offset-mode launches apart (``offset_launches``) as well
as in ``launches``. :func:`flash_block_attend` and
:func:`flash_block_backward` are the reference's block-pair entry points on
top of them, the local step of ring attention
(:mod:`beholder_tpu_torch.ops.attention`).

On a CUDA tensor each wrapper launches its kernel or raises; it never
falls back. bf16 inputs go to ``csrc/flash_fwd.cu`` / ``flash_bwd.cu``,
f32 inputs to ``csrc/flash_f32.cu`` (f32 products with f32 sums, the
reference's mix for f32), at any head dim from 1 to 128: the kernels are
instantiated at the widths of :data:`KERNEL_HEAD_DIMS`, and a call runs
the next width up (:func:`kernel_width`) on a zero-padded copy of q, k, v
and do, with the true head dim's scale, and slices the results (the
reference pads too; the kernels keep their width's compile-time strides
and 16-byte row copies, and the copies' cost is measured beside the
kernel's in ``chip_smoke.py``, ``alone_ms``). A
differentiable :func:`flash_attention` or ring attention call on the card
that the backward kernels would refuse raises before the forward launches
(:func:`check_backward_head_dim`). On a CPU tensor each wrapper runs the
plain version.
The plain versions compute the same function densely (the (T, T) scores
exist there) with the reference's dtype mix:

- the forward folds ``1/sqrt(d)`` into q and rounds it back to q's dtype
  before the score product; the backward multiplies the f32 score instead;
- products take input-dtype operands with f32 accumulation;
- p is cast to v's dtype before PV, to do's before dv; ds to k's dtype
  before dq and to q's before dk;
- masking uses -1e30, and p is zeroed where the score is masked, so a row
  with no live key gives ``o = 0`` and ``lse = -1e30``.

What bounds the kernels is operations: at the training shape the
forward's two products are 68.7 GFLOP against ~42 MB of inputs and
outputs. So the three bf16 kernels run every product on the tensor cores
(``mma.sync``, bf16 operands, f32 sums, operands by ``ldmatrix`` from
double-buffered bf16 tiles), and p and ds pass from one product to the
next in registers, rounded to bf16 where the plain versions round them:
no score tile touches memory. What holds them below the tensor-core rate
now is that ldmatrix traffic and the f32 exp and mask arithmetic between
the products (the note at the top of each source). They sum in another
order than the plain versions' f32 products, so an output's bf16
rounding can differ by one ULP. The forward
kernel runs the softmax online over 64-key tiles, the plain forward over
the whole row: their bf16 weights round differently. The kernels use no
atomics: two launches on the same inputs give the same bits. dk/dv are
summed over the group in f32 and rounded once (the reference rounds
per-q-head partials to k's dtype and sums those). The f32 kernels run
every product as f32 FMA from shared-memory tiles (TF32 on the tensor
cores would miss the reference's f32 bands), with the same tiles, masks,
order of work and bitwise repeats (the note at the top of
``csrc/flash_f32.cu``).
"""

from __future__ import annotations

import ctypes
import math

import torch
import torch.nn.functional as F

_NEG_INF = -1e30
#: the head dims each CUDA kernel (the flash forward, the flash backward,
#: the paged chunk kernel; bf16 and f32 alike) is instantiated for. A call
#: at any head dim from 1 to :data:`MAX_HEAD_DIM` runs the instantiation
#: of the next of them up (:func:`kernel_width`): the flash wrappers
#: zero-pad a copy of q, k, v and do to that width and slice the results,
#: the chunk kernel reads its pages at the true width and zero-fills its
#: shared tiles past it. The scale is always the true head dim's.
KERNEL_HEAD_DIMS = (8, 16, 32, 64, 128)
MAX_HEAD_DIM = KERNEL_HEAD_DIMS[-1]
#: the input dtypes of the flash kernels: bf16 (csrc/flash_fwd.cu,
#: flash_bwd.cu, on the tensor cores) and f32 (csrc/flash_f32.cu, f32 FMA)
FLASH_DTYPES = (torch.bfloat16, torch.float32)


def kernel_width(dh: int, kernel: str = "flash") -> int:
    """The instantiated head dim a call at head dim ``dh`` runs at: the
    smallest of :data:`KERNEL_HEAD_DIMS` at or above it. Raises for a head
    dim outside 1 to :data:`MAX_HEAD_DIM`, naming ``kernel``."""
    if not 1 <= dh <= MAX_HEAD_DIM:
        raise ValueError(f"the {kernel} kernel takes head_dim 1 to {MAX_HEAD_DIM}, got {dh}")
    return next(w for w in KERNEL_HEAD_DIMS if w >= dh)


def check_backward_head_dim(q: torch.Tensor, *others: torch.Tensor) -> None:
    """Before a forward that autograd will differentiate (gradients on and
    some input requiring one): on a CUDA tensor, raise unless the backward
    kernels take q's head dim and dtype, so a call fails before the forward
    launches rather than in the backward."""
    if (_on_card(q) and torch.is_grad_enabled()
            and any(x.requires_grad for x in (q, *others))):
        kernel_width(q.shape[-1], "flash backward")
        _check_dtype("flash backward", q.dtype)


def _live(t: int, causal: bool, window: int | None, segment_ids, bhkv: int,
          device, offsets=None) -> torch.Tensor | None:
    """Boolean mask broadcasting against grouped scores ``(BHkv, G, T, T)``,
    or None when every pair is live. ``offsets`` (q_offset, kv_offset)
    place rows and keys on the global positions the masks compare."""
    qoff, kvoff = offsets or (0, 0)
    rows = torch.arange(t, device=device)[:, None] + qoff
    cols = torch.arange(t, device=device)[None, :] + kvoff
    live = None
    if causal:
        live = rows >= cols
    if window is not None:
        live = live & (rows - cols < window)
    if segment_ids is not None:
        # batch-lead ids (B, T) -> one row per kv head
        seg = segment_ids.repeat_interleave(bhkv // segment_ids.shape[0], dim=0)
        same = seg[:, None, :, None] == seg[:, None, None, :]          # (BHkv,1,T,T)
        live = same if live is None else live & same
    return live


def _grouped(x: torch.Tensor, bhkv: int) -> torch.Tensor:
    """(BH, T, d) -> f32 (BHkv, G, T, d)."""
    return x.float().reshape(bhkv, -1, *x.shape[1:])


def _scale(d: int, scale: float | None) -> float:
    """``1/sqrt(d)``, or the scale given (a head dim padded to a kernel's
    width keeps its own head dim's)."""
    return 1.0 / math.sqrt(d) if scale is None else scale


def _probabilities(q, k, lse, causal, window, segment_ids, offsets=None, scale=None):
    """The backward's p = exp(s - lse) from the saved logsumexp, with s the
    unscaled-q score times the scale in f32, masked to -1e30 and p
    zeroed there: (BHkv, G, T, T) f32."""
    bhkv, t, d = k.shape
    scale = _scale(d, scale)
    s = torch.matmul(_grouped(q, bhkv), k.float()[:, None].transpose(-1, -2)) * scale
    live = _live(t, causal, window, segment_ids, bhkv, q.device, offsets)
    if live is not None:
        s = torch.where(live, s, _NEG_INF)
    p = torch.exp(s - lse.reshape(bhkv, -1, t, 1))
    return torch.where(s <= _NEG_INF / 2, 0.0, p)


def flash_forward_reference(q, k, v, *, causal=False, window=None, segment_ids=None,
                            offsets=None, scale=None):
    """The plain PyTorch version of the forward kernel: ``(o, lse)`` for
    ``(BH, T, d)`` q and ``(BHkv, T, d)`` k/v; o in q's dtype, lse f32
    ``(BH, T)``. ``scale`` (default ``1/sqrt(d)``) multiplies q."""
    bh, t, d = q.shape
    bhkv = k.shape[0]
    scale = _scale(d, scale)
    qs = (q.float() * scale).to(q.dtype)
    s = torch.matmul(_grouped(qs, bhkv), k.float()[:, None].transpose(-1, -2))
    live = _live(t, causal, window, segment_ids, bhkv, q.device, offsets)
    if live is not None:
        s = torch.where(live, s, _NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    p = torch.where(s <= _NEG_INF / 2, 0.0, p)
    l = p.sum(dim=-1)
    acc = torch.matmul(p.to(v.dtype).float(), v.float()[:, None])
    safe_l = torch.clamp(l, min=1e-37)
    o = (acc / safe_l[..., None]).to(q.dtype).reshape(bh, t, d)
    lse = torch.where(l > 0, m[..., 0] + torch.log(safe_l), _NEG_INF)
    return o, lse.reshape(bh, t)


def flash_dq_reference(q, k, v, do, lse, delta, *, causal=False, window=None,
                       segment_ids=None, offsets=None, scale=None):
    """The plain PyTorch version of the dq kernel: ``dq`` in q's dtype."""
    bhkv, t, d = k.shape
    p = _probabilities(q, k, lse, causal, window, segment_ids, offsets, scale)
    dp = torch.matmul(_grouped(do, bhkv), v.float()[:, None].transpose(-1, -2))
    ds = p * (dp - delta.reshape(bhkv, -1, t, 1)) * _scale(d, scale)
    dq = torch.matmul(ds.to(k.dtype).float(), k.float()[:, None])
    return dq.to(q.dtype).reshape(q.shape)


def flash_dkv_reference(q, k, v, do, lse, delta, *, causal=False, window=None,
                        segment_ids=None, offsets=None, scale=None):
    """The plain PyTorch version of the dk/dv kernel: ``(dk, dv)`` at
    kv-head shape in k's and v's dtypes, each summed over the GQA group in
    f32."""
    bhkv, t, d = k.shape
    p = _probabilities(q, k, lse, causal, window, segment_ids, offsets, scale)
    dp = torch.matmul(_grouped(do, bhkv), v.float()[:, None].transpose(-1, -2))
    ds = p * (dp - delta.reshape(bhkv, -1, t, 1)) * _scale(d, scale)

    def group_sum(w, x):
        # sum over the group's query heads and rows: (BHkv, T, G*T) @ (BHkv, G*T, d)
        w = w.permute(0, 3, 1, 2).reshape(bhkv, t, -1)
        return torch.matmul(w, _grouped(x, bhkv).reshape(bhkv, -1, d))

    dv = group_sum(p.to(do.dtype).float(), do).to(v.dtype)
    dk = group_sum(ds.to(q.dtype).float(), q).to(k.dtype)
    return dk, dv


def flash_delta(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """``rowsum(do * o)`` in f32, ``(BH, T)``: plain torch on either device,
    as the reference computes it in XLA."""
    return (do.float() * o.float()).sum(dim=-1)


def flash_backward_reference(q, k, v, o, lse, do, *, causal=False, window=None,
                             segment_ids=None):
    """Plain ``(dq, dk, dv)`` from the saved ``o`` and ``lse``."""
    delta = flash_delta(o, do)
    kw = dict(causal=causal, window=window, segment_ids=segment_ids)
    dk, dv = flash_dkv_reference(q, k, v, do, lse, delta, **kw)
    return flash_dq_reference(q, k, v, do, lse, delta, **kw), dk, dv


# -- the kernels --------------------------------------------------------------

_libs: dict[str, ctypes.CDLL] = {}
#: per input dtype, the (library, C entry) of the forward, dq and dk/dv
_ENTRIES = {
    torch.bfloat16: (("flash_fwd", "flash_fwd_launch"), ("flash_bwd", "flash_dq_launch"),
                     ("flash_bwd", "flash_dkv_launch")),
    torch.float32: (("flash_f32", "flash_f32_fwd_launch"), ("flash_f32", "flash_f32_dq_launch"),
                    ("flash_f32", "flash_f32_dkv_launch")),
}
#: the pointer arguments of the forward, dq and dk/dv entries
_POINTERS = (6, 8, 9)


def _kernel_lib(name: str) -> ctypes.CDLL:
    """``flash_fwd``, ``flash_bwd`` or ``flash_f32``, built at first use."""
    if name not in _libs:
        from beholder_tpu_torch import csrc

        lib = csrc.load(name)
        tail = [ctypes.c_int] * 9 + [ctypes.c_float, ctypes.c_void_p]
        for entries in _ENTRIES.values():
            for (lib_name, entry), n in zip(entries, _POINTERS):
                if lib_name == name:
                    fn = getattr(lib, entry)
                    fn.argtypes = [ctypes.c_void_p] * n + tail
                    fn.restype = ctypes.c_int
        _libs[name] = lib
    return _libs[name]


def _entry(which: int, dtype: torch.dtype):
    """The C entry of kernel ``which`` (0 forward, 1 dq, 2 dk/dv) for
    inputs of ``dtype``."""
    lib, entry = _ENTRIES[dtype][which]
    return getattr(_kernel_lib(lib), entry)


def _check_dtype(kernel: str, dtype: torch.dtype) -> None:
    if dtype not in FLASH_DTYPES:
        raise TypeError(f"the {kernel} kernel takes bf16 or f32 inputs, got {dtype}")


def _check_kernel_inputs(kernel: str, same: dict, f32: dict, segment_ids) -> int:
    """What the kernels take: q/k/v/do of one dtype of :data:`FLASH_DTYPES`
    and a head dim from 1 to :data:`MAX_HEAD_DIM`, f32 lse and delta, int32
    segment ids, all contiguous on one device. Returns the width the call
    runs at (:func:`kernel_width`)."""
    q = same["q"]
    dev = q.device
    tensors = {**same, **f32}
    if segment_ids is not None:
        if segment_ids.dtype != torch.int32:
            raise TypeError(f"the {kernel} kernel takes int32 segment ids")
        tensors["segment_ids"] = segment_ids
    _check_dtype(kernel, q.dtype)
    for name, t in same.items():
        if t.dtype != q.dtype:
            raise TypeError(f"the {kernel} kernel takes {name} in q's dtype {q.dtype}, "
                            f"got {t.dtype}")
    for name, t in f32.items():
        if t.dtype != torch.float32:
            raise TypeError(f"the {kernel} kernel takes f32 {name}, got {t.dtype}")
    width = kernel_width(q.shape[-1],
                         kernel if kernel == "flash forward" else "flash backward")
    for name, t in tensors.items():
        if t.device != dev:
            raise ValueError(f"all inputs must be on {dev}; {name} is on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"the {kernel} kernel takes contiguous tensors ({name})")
        if name not in same and t.data_ptr() % 16:
            raise ValueError(f"the {kernel} kernel takes 16-byte aligned tensors ({name})")
    return width


def _padded(width: int, *xs: torch.Tensor) -> list:
    """Each tensor with its last dim zero-padded to ``width`` (a copy; the
    tensor itself at its width), each 16-byte aligned."""
    out = [x if x.shape[-1] == width else F.pad(x, (0, width - x.shape[-1])) for x in xs]
    for x in out:
        if x.data_ptr() % 16:
            raise ValueError("the flash kernels take 16-byte aligned tensors")
    return out


def _unpadded(x: torch.Tensor, dh: int) -> torch.Tensor:
    return x if x.shape[-1] == dh else x[..., :dh].contiguous()


def _on_card(q: torch.Tensor) -> bool:
    """True for a CUDA tensor (the kernel runs), False for a CPU tensor
    (the plain version runs); any other device raises."""
    if q.device.type not in ("cuda", "cpu"):
        raise ValueError(
            f"flash attention runs on CUDA tensors (the kernels) or CPU tensors "
            f"(the plain versions), got {q.device}"
        )
    return q.is_cuda


def _common_args(q, k, segment_ids, causal, window, offsets, dh):
    """The launch's trailing scalars: BH, BHkv, T, the width (the padded
    q's head dim), H, causal, window, q_offset, kv_offset, scale (the f32
    value the plain versions multiply by, ``1/sqrt(dh)`` of the true head
    dim ``dh``), stream."""
    bh, t, width = q.shape
    heads = bh // segment_ids.shape[0] if segment_ids is not None else bh
    qoff, kvoff = offsets or (0, 0)
    return (
        bh, k.shape[0], t, width, heads, int(causal), 0 if window is None else int(window),
        int(qoff), int(kvoff), 1.0 / math.sqrt(dh),
        torch.cuda.current_stream(q.device).cuda_stream,
    )


def _raise_on(err: int, kernel: str) -> None:
    if err != 0:
        raise RuntimeError(f"{kernel} kernel launch failed: CUDA error {err}")


def _check_flat(q, k, v, segment_ids, window, causal, offsets=None) -> None:
    """Shape checks of the flattened operands, shared by the wrappers."""
    if q.ndim != 3 or k.ndim != 3:
        raise ValueError(f"q and k/v must be (rows, T, d), got {tuple(q.shape)}, {tuple(k.shape)}")
    if k.shape != v.shape:
        raise ValueError(f"k/v shape mismatch: {tuple(k.shape)} vs {tuple(v.shape)}")
    if q.shape[1:] != k.shape[1:] or q.shape[0] % k.shape[0]:
        raise ValueError(
            f"GQA shapes must differ only in rows, with q rows a multiple of kv rows; "
            f"got {tuple(q.shape)} vs {tuple(k.shape)}"
        )
    if window is not None and (not causal or window < 1):
        raise ValueError(f"window needs causal=True and window >= 1, got {window}")
    if segment_ids is not None:
        if segment_ids.ndim != 2 or segment_ids.shape[1] != q.shape[1] or (
            k.shape[0] % segment_ids.shape[0]
        ):
            raise ValueError(
                f"segment_ids must be (B, T) with B dividing the kv rows, "
                f"got {tuple(segment_ids.shape)}"
            )
    if offsets is not None:
        if segment_ids is not None:
            raise NotImplementedError("segment ids + ring offsets unsupported")
        if len(offsets) != 2 or not all(isinstance(o, int) for o in offsets):
            raise TypeError(f"offsets must be two Python ints (q, kv), got {offsets!r}")


def _count(wrapper, offsets, dtype, padded: bool) -> None:
    wrapper.launches += 1
    wrapper.offset_launches += offsets is not None
    wrapper.f32_launches += dtype == torch.float32
    wrapper.padded_launches += padded


def flash_forward(q, k, v, *, causal=False, window=None, segment_ids=None, offsets=None):
    """``(o, lse)`` of flattened ``(BH, T, d)`` q over ``(BHkv, T, d)`` k/v;
    ``offsets=(q_offset, kv_offset)`` runs the ring block-pair mode. CUDA
    tensors launch ``csrc/flash_fwd.cu`` (bf16) or the forward of
    ``csrc/flash_f32.cu`` (f32) at :func:`kernel_width` of d (each launch
    adds one to ``flash_forward.launches``, and to ``.offset_launches``,
    ``.f32_launches`` and ``.padded_launches`` where it is one of those);
    CPU tensors run :func:`flash_forward_reference`."""
    _check_flat(q, k, v, segment_ids, window, causal, offsets)
    if not _on_card(q):
        return flash_forward_reference(
            q, k, v, causal=causal, window=window, segment_ids=segment_ids,
            offsets=offsets,
        )
    dh = q.shape[-1]
    width = _check_kernel_inputs("flash forward", {"q": q, "k": k, "v": v}, {}, segment_ids)
    qp, kp, vp = _padded(width, q, k, v)
    o = torch.empty_like(qp)
    lse = torch.empty(q.shape[:2], dtype=torch.float32, device=q.device)
    err = _entry(0, q.dtype)(
        qp.data_ptr(), kp.data_ptr(), vp.data_ptr(),
        segment_ids.data_ptr() if segment_ids is not None else None,
        o.data_ptr(), lse.data_ptr(),
        *_common_args(qp, kp, segment_ids, causal, window, offsets, dh),
    )
    _raise_on(err, "flash forward")
    _count(flash_forward, offsets, q.dtype, width != dh)
    return _unpadded(o, dh), lse


def flash_backward_dq(q, k, v, do, lse, delta, *, causal=False, window=None,
                      segment_ids=None, offsets=None):
    """``dq`` from the saved ``lse`` and ``delta = rowsum(do * o)``;
    ``offsets`` as in :func:`flash_forward`. CUDA tensors launch the dq
    kernel of ``csrc/flash_bwd.cu`` (bf16) or ``csrc/flash_f32.cu`` (f32),
    counted as :func:`flash_forward` counts; CPU tensors run
    :func:`flash_dq_reference`."""
    _check_flat(q, k, v, segment_ids, window, causal, offsets)
    kw = dict(causal=causal, window=window, segment_ids=segment_ids, offsets=offsets)
    if not _on_card(q):
        return flash_dq_reference(q, k, v, do, lse, delta, **kw)
    dh = q.shape[-1]
    width = _check_kernel_inputs("flash dq", {"q": q, "k": k, "v": v, "do": do},
                                 {"lse": lse, "delta": delta}, segment_ids)
    qp, kp, vp, dop = _padded(width, q, k, v, do)
    dq = torch.empty_like(qp)
    err = _entry(1, q.dtype)(
        qp.data_ptr(), kp.data_ptr(), vp.data_ptr(), dop.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), segment_ids.data_ptr() if segment_ids is not None else None,
        dq.data_ptr(), *_common_args(qp, kp, segment_ids, causal, window, offsets, dh),
    )
    _raise_on(err, "flash dq")
    _count(flash_backward_dq, offsets, q.dtype, width != dh)
    return _unpadded(dq, dh)


def flash_backward_dkv(q, k, v, do, lse, delta, *, causal=False, window=None,
                       segment_ids=None, offsets=None):
    """``(dk, dv)`` at kv-head shape, each summed over the GQA group;
    ``offsets`` as in :func:`flash_forward`. CUDA tensors launch the dk/dv
    kernel of ``csrc/flash_bwd.cu`` (bf16) or ``csrc/flash_f32.cu`` (f32),
    counted as :func:`flash_forward` counts; CPU tensors run
    :func:`flash_dkv_reference`."""
    _check_flat(q, k, v, segment_ids, window, causal, offsets)
    kw = dict(causal=causal, window=window, segment_ids=segment_ids, offsets=offsets)
    if not _on_card(q):
        return flash_dkv_reference(q, k, v, do, lse, delta, **kw)
    dh = q.shape[-1]
    width = _check_kernel_inputs("flash dk/dv", {"q": q, "k": k, "v": v, "do": do},
                                 {"lse": lse, "delta": delta}, segment_ids)
    qp, kp, vp, dop = _padded(width, q, k, v, do)
    dk, dv = torch.empty_like(kp), torch.empty_like(vp)
    err = _entry(2, q.dtype)(
        qp.data_ptr(), kp.data_ptr(), vp.data_ptr(), dop.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), segment_ids.data_ptr() if segment_ids is not None else None,
        dk.data_ptr(), dv.data_ptr(),
        *_common_args(qp, kp, segment_ids, causal, window, offsets, dh),
    )
    _raise_on(err, "flash dk/dv")
    _count(flash_backward_dkv, offsets, q.dtype, width != dh)
    return _unpadded(dk, dh), _unpadded(dv, dh)


#: kernel launches since each count was last set to 0: all of them, those
#: in the ring block-pair (offset) mode, those on f32 inputs (the
#: csrc/flash_f32.cu kernels) and those at a head dim padded to its width
for _wrapper in (flash_forward, flash_backward_dq, flash_backward_dkv):
    _wrapper.launches = 0
    _wrapper.offset_launches = 0
    _wrapper.f32_launches = 0
    _wrapper.padded_launches = 0


class FlashAttention(torch.autograd.Function):
    """The reference's custom VJP ``_flash``: the forward kernel, then the
    dq and dk/dv kernels from the saved ``q, k, v, o, lse`` (nothing of size
    T x T is saved). Operands are flattened ``(BH, T, d)`` / ``(BHkv, T,
    d)``; ``segment_ids`` ``(B, T)`` integers or None."""

    @staticmethod
    def forward(ctx, q, k, v, segment_ids, causal, window):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        o, lse = flash_forward(q, k, v, causal=causal, window=window,
                               segment_ids=segment_ids)
        ctx.save_for_backward(q, k, v, o, lse, segment_ids)
        ctx.causal, ctx.window = causal, window
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse, segment_ids = ctx.saved_tensors
        do = do.contiguous()
        kw = dict(causal=ctx.causal, window=ctx.window, segment_ids=segment_ids)
        delta = flash_delta(o, do)
        dq = flash_backward_dq(q, k, v, do, lse, delta, **kw)
        dk, dv = flash_backward_dkv(q, k, v, do, lse, delta, **kw)
        return dq, dk, dv, None, None, None


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = False,
    window: int | None = None,
    segment_ids: torch.Tensor | None = None,
) -> torch.Tensor:
    """Memory-efficient attention, ``(..., T, d) -> (..., T, d)``, with the
    reference's checks: GQA k/v may carry fewer heads on dim -3 (q heads a
    multiple of kv heads, every other dim equal); ``window`` (requires
    ``causal``, ``>= 1``) keeps the previous ``window`` positions of each
    row; ``segment_ids`` (batch-shaped ``q.shape[:-3] + (T,)``, integers)
    masks attention across segments. Differentiable in q, k and v. On the
    card bf16 and f32 at head dims 1 to 128 run the kernels; a call the
    backward kernels would refuse raises before the forward launches when
    its inputs require a gradient."""
    shape = q.shape
    t, d = shape[-2], shape[-1]
    if k.shape != q.shape:
        if (
            q.ndim < 3
            or k.shape[:-3] != q.shape[:-3]
            or k.shape[-2:] != q.shape[-2:]
            or q.shape[-3] % k.shape[-3]
        ):
            raise ValueError(
                f"GQA shapes must differ only in heads (-3 dim), with q heads a "
                f"multiple of kv heads; got {tuple(q.shape)} vs {tuple(k.shape)}"
            )
    if k.shape != v.shape:
        raise ValueError(f"k/v shape mismatch: {tuple(k.shape)} vs {tuple(v.shape)}")
    if window is not None:
        if not causal:
            raise ValueError("window requires causal=True")
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
    seg = None
    if segment_ids is not None:
        want = (*shape[:-3], t) if q.ndim >= 3 else (t,)
        if tuple(segment_ids.shape) != want:
            raise ValueError(
                f"segment_ids must be batch-shaped {want} (no head dim); "
                f"got {tuple(segment_ids.shape)}"
            )
        if segment_ids.is_floating_point():
            raise TypeError("segment_ids must be integers")
        seg = segment_ids.reshape(-1, t).to(torch.int32).contiguous()
    check_backward_head_dim(q, k, v)
    q3 = q.reshape(-1, t, d)
    k3, v3 = (a.reshape(-1, t, d) for a in (k, v))
    return FlashAttention.apply(q3, k3, v3, seg, causal, window).reshape(shape)


def _offsets(q_offset, kv_offset):
    if (q_offset is None) != (kv_offset is None):
        raise ValueError("q_offset and kv_offset come together")
    return None if q_offset is None else (int(q_offset), int(kv_offset))


def flash_block_attend(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int | None = None,
    q_offset: int | None = None,
    kv_offset: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """One block pair's attention and logsumexp: the ring's local step, on
    the forward kernel (the reference's ``flash_block_attend``).

    q is ``(..., T, d)``, k/v ``(..., T, d)`` with fewer heads on dim -3
    under GQA. With ``q_offset``/``kv_offset`` (Python ints) the causal
    and window masks run on global positions: a rotated kv block knows
    where it came from; a fully dead pair yields o = 0 and lse = -1e30,
    which the online-softmax combine neutralises. Returns (o in q's dtype,
    lse ``(..., T)`` f32), each normalised within the pair only."""
    shape = q.shape
    t, d = shape[-2], shape[-1]
    q3 = q.reshape(-1, t, d).contiguous()
    k3, v3 = (a.reshape(-1, a.shape[-2], d).contiguous() for a in (k, v))
    o, lse = flash_forward(q3, k3, v3, causal=causal, window=window,
                           offsets=_offsets(q_offset, kv_offset))
    return o.reshape(shape), lse.reshape(shape[:-1])


def flash_block_backward(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    o: torch.Tensor,
    lse: torch.Tensor,
    do: torch.Tensor,
    *,
    causal: bool = True,
    window: int | None = None,
    q_offset: int | None = None,
    kv_offset: int | None = None,
    delta: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Block-pair gradients for the ring backward, on the dq and dk/dv
    kernels (the reference's ``flash_block_backward``): this pair's
    probabilities are recomputed from the GLOBAL logsumexp ``lse`` that the
    ring forward saved, ``o``/``do`` are the shard's global output and
    cotangent. ``delta = rowsum(do * o)`` may be passed in, computed once
    per shard (:func:`flash_delta`), since it does not depend on the pair.
    The reference pads T and gives padding rows lse = +1e30; here T is
    exact and the kernels give rows past it that lse themselves. Returns
    (dq, dk, dv), dk/dv at kv-head shape, summed over the GQA group."""
    shape = q.shape
    t, d = shape[-2], shape[-1]
    q3, o3, do3 = (a.reshape(-1, t, d).contiguous() for a in (q, o, do))
    k3, v3 = (a.reshape(-1, a.shape[-2], d).contiguous() for a in (k, v))
    lse3 = lse.reshape(-1, t).contiguous()
    delta3 = flash_delta(o3, do3) if delta is None else delta.reshape(-1, t).contiguous()
    kw = dict(causal=causal, window=window, offsets=_offsets(q_offset, kv_offset))
    dq = flash_backward_dq(q3, k3, v3, do3, lse3, delta3, **kw)
    dk, dv = flash_backward_dkv(q3, k3, v3, do3, lse3, delta3, **kw)
    return dq.reshape(shape), dk.reshape(k.shape), dv.reshape(v.shape)
