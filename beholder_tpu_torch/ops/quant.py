"""KV page quantizers (the pool half of the reference's ``ops/quant.py``).

Two encodings share one ``(values, scales)`` pool container:

- **int8** (:func:`quantize_symmetric`): int8 values and f32 per-block
  scales, ``x ≈ q * scale``;
- **fp8** (:func:`quantize_fp8_block`): ``float8_e4m3fn`` values and uint8
  **E8M0** per-block scales, ``x ≈ q * 2**(e - 127)``. A power-of-two scale
  makes every dequant an exact exponent shift.

Both must match the reference bit for bit on the same f32 input: every pool
write (admit chunks, decode-tick columns) goes through :func:`pool_quantize`
and every dequant site through :func:`pool_scales_f32`.
"""

from __future__ import annotations

import torch

#: float8_e4m3fn's largest finite value
FP8_MAX = 448.0

#: E8M0 exponent bias (scale = 2**(int(e) - 127), e stored uint8)
E8M0_BIAS = 127


def quantize_symmetric(
    x: torch.Tensor, axis: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 quantization reducing ``axis``: (q int8, scale f32
    with ``axis`` removed). Round half to even, like ``jnp.round``."""
    xf = x.float()
    amax = xf.abs().amax(dim=axis)
    scale = torch.clamp(amax, min=1e-8) / 127.0
    q = torch.clamp(torch.round(xf / scale.unsqueeze(axis)), -127, 127)
    return q.to(torch.int8), scale


def _exp2_neg(e: torch.Tensor) -> torch.Tensor:
    """``2**-e`` exactly, for integer ``e`` in [-126, 127], built from the
    f32 bit pattern (``2**-127`` is the one subnormal in that range)."""
    normal = ((E8M0_BIAS - e.clamp(max=E8M0_BIAS - 1)).to(torch.int32) << 23).view(
        torch.float32
    )
    return torch.where(e == E8M0_BIAS, torch.full_like(normal, 2.0**-127), normal)


def quantize_fp8_block(
    x: torch.Tensor, axis: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Shared-exponent fp8 block quantization reducing ``axis``: (q
    ``float8_e4m3fn``, E8M0 scales uint8 with ``axis`` removed). The block
    exponent is the smallest power of two that brings the block's amax
    inside fp8 range, from ``frexp`` (exact: no transcendental), clamped to
    f32's normal exponent window; an all-zero block gets e = bias."""
    xf = x.float()
    amax = xf.abs().amax(dim=axis)
    m, exp = torch.frexp(torch.clamp(amax, min=1e-30))
    e = exp - 9 + (m > 0.875).to(exp.dtype)
    e = torch.where(amax > 0, e, torch.zeros_like(e))
    e = torch.clamp(e, -E8M0_BIAS + 1, E8M0_BIAS)
    inv = _exp2_neg(e)
    q = torch.clamp(xf * inv.unsqueeze(axis), -FP8_MAX, FP8_MAX).to(
        torch.float8_e4m3fn
    )
    return q, (e + E8M0_BIAS).to(torch.uint8)


def pool_quantize(
    x: torch.Tensor, axis: int, values_dtype: torch.dtype
) -> tuple[torch.Tensor, torch.Tensor]:
    """Quantize a KV block for a pool of ``values_dtype``: the one dispatch
    every pool write shares."""
    if values_dtype == torch.int8:
        return quantize_symmetric(x, axis)
    if values_dtype == torch.float8_e4m3fn:
        return quantize_fp8_block(x, axis)
    raise ValueError(f"no pool quantizer for {values_dtype}")


def pool_scales_f32(scales: torch.Tensor) -> torch.Tensor:
    """A pool's per-block scales as f32 multipliers: f32 scales (int8
    pools) pass through; uint8 E8M0 exponents (fp8 pools) decode to
    ``2**(e - 127)`` by building the float from its bits (``e << 23``),
    never through ``exp2``."""
    if scales.dtype == torch.uint8:
        return (scales.to(torch.int32) << 23).view(torch.float32)
    return scales
