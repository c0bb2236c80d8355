"""Fake-quantization primitives with straight-through-estimator gradients
(the JAX package's ``ops/quantize.py``), as ``torch.autograd.Function``s
over an explicit reduction ``axis``.

Numerics contract, kept from the reference:

* symmetric scale ``s = (2^(b-1)-1) / (absmax + 1e-6)``, dequant divides by
  ``s + 1e-6``; asymmetric uses ``alpha = max - min``, ``beta = min``, 1e-8;
* rounding is half to even; the forward does NOT clamp; absmax / min / max
  carry no gradient;
* the backward passes the gradient through where ``-2 < x < 2`` and zeroes
  it elsewhere (``DEFAULT_CLIP``); the 1- and 2-bit weight branches use a
  plain identity STE with no mask.

``axis`` may be ``None`` (per tensor), an int or a tuple. Weights are stored
``[in, out]``, so per-output-channel is ``axis=0``; per-token is ``axis=-1``.
All arithmetic runs in ``x``'s type, as the JAX functions' does.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import torch

Axis = Union[None, int, Sequence[int]]

DEFAULT_CLIP: Tuple[float, float] = (-2.0, 2.0)

_SYM_EPS = 1e-6
_ASYM_EPS = 1e-8


def _canon_axis(axis: Axis) -> Optional[Tuple[int, ...]]:
    if axis is None:
        return None
    if isinstance(axis, int):
        return (axis,)
    return tuple(axis)


def _reduce(x: torch.Tensor, ax, op: str) -> torch.Tensor:
    """amax / amin / mean over ``ax`` with kept dims, or over everything."""
    if ax is None:
        return getattr(x, op)()
    return getattr(x, op)(dim=ax, keepdim=True)


def _div_into(num: float, den: torch.Tensor) -> torch.Tensor:
    """``num / den`` as one IEEE division in ``den``'s type (torch's
    ``scalar / tensor`` multiplies by the reciprocal, which can differ in
    the last bit and flip a rounded integer)."""
    return torch.full_like(den, num) / den


def sym_fake_quant_raw(x: torch.Tensor, bits: int, axis: Axis) -> torch.Tensor:
    """Quantize-dequantize: ``round(x*s) / (s + 1e-6)`` with
    ``s = qmax / (absmax + 1e-6)``; absmax is detached."""
    ax = _canon_axis(axis)
    absmax = _reduce(x.detach().abs(), ax, "amax")
    qmax = float(2 ** (bits - 1) - 1)
    s = _div_into(qmax, absmax + _SYM_EPS)
    return torch.round(x * s) / (s + _SYM_EPS)


def asym_fake_quant_raw(x: torch.Tensor, bits: int, axis: Axis) -> torch.Tensor:
    """Min-max affine quantize-dequantize onto ``2^b - 1`` levels."""
    ax = _canon_axis(axis)
    xd = x.detach()
    xmax, xmin = _reduce(xd, ax, "amax"), _reduce(xd, ax, "amin")
    alpha = xmax - xmin
    beta = xmin
    xn = (x - beta) / (alpha + _ASYM_EPS)
    levels = float(2 ** bits - 1)
    q = torch.round(xn * levels) / levels
    return q * (alpha + _ASYM_EPS) + beta


class _ClipSTE(torch.autograd.Function):
    """``raw(x, bits, axis)`` forward; gradient passed through inside the
    open clip interval and zeroed outside it."""

    @staticmethod
    def forward(ctx, x, raw, bits, axis, clip):
        ctx.save_for_backward(x)
        ctx.clip = clip
        return raw(x.detach(), bits, axis)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        lo, hi = ctx.clip
        mask = (x < hi) & (x > lo)
        return torch.where(mask, g, torch.zeros_like(g)), None, None, None, None


def sym_fake_quant(x: torch.Tensor, bits: int, axis: Axis = -1,
                   clip: Tuple[float, float] = DEFAULT_CLIP) -> torch.Tensor:
    """Symmetric dynamic-range fake-quant with the STE backward."""
    return _ClipSTE.apply(x, sym_fake_quant_raw, bits, axis, clip)


def asym_fake_quant(x: torch.Tensor, bits: int, axis: Axis = -1,
                    clip: Tuple[float, float] = DEFAULT_CLIP) -> torch.Tensor:
    """Asymmetric fake-quant with the same STE backward."""
    return _ClipSTE.apply(x, asym_fake_quant_raw, bits, axis, clip)


def _binary_weight_raw(w: torch.Tensor, axis: Axis) -> torch.Tensor:
    """1-bit: ``scale * sign(w / scale)``, ``scale = mean|w|``."""
    scale = _reduce(w.abs(), _canon_axis(axis), "mean")
    return scale * torch.sign(w / scale)


def _twobit_weight_raw(w: torch.Tensor, axis: Axis) -> torch.Tensor:
    """2-bit: half-level-offset rounding of ``w / (2*mean|w|)`` clamped to
    +-(1 - 1e-2), two levels a side."""
    num_levels = 2.0
    clip_val = 1.0 - 1e-2
    scale = 2.0 * _reduce(w.abs(), _canon_axis(axis), "mean")
    q = (torch.round(torch.clamp(w / scale, -clip_val, clip_val) * num_levels - 0.5)
         + 0.5) / num_levels
    return scale * q


class _IdentitySTE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, w, bits, axis):
        wd = w.detach()
        return _binary_weight_raw(wd, axis) if bits == 1 else _twobit_weight_raw(wd, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def lowbit_weight_fake_quant(w: torch.Tensor, bits: int, axis: Axis = 0) -> torch.Tensor:
    """1/2-bit weight fake-quant with an identity STE (no clip mask)."""
    return _IdentitySTE.apply(w, bits, axis)


def weight_fake_quant(w: torch.Tensor, bits: int, *, layerwise: bool = False) -> torch.Tensor:
    """Weight policy: passthrough at >= 32 bits, symmetric per output channel
    with the masked STE from 3 bits on, the scaled-mean branches at 2 and 1."""
    if bits >= 32:
        return w
    axis = None if layerwise else 0
    if bits >= 3:
        return sym_fake_quant(w, bits, axis)
    return lowbit_weight_fake_quant(w, bits, axis)


def act_fake_quant(x: torch.Tensor, bits: int, *, symmetric: bool = True,
                   layerwise: bool = False) -> torch.Tensor:
    """Activation policy: active only for ``2 < bits < 32``; per token."""
    if not (2 < bits < 32):
        return x
    axis = None if layerwise else -1
    fn = sym_fake_quant if symmetric else asym_fake_quant
    return fn(x, bits, axis)


def kv_fake_quant(x: torch.Tensor, bits: int) -> torch.Tensor:
    """KV fake-quant: symmetric per token over the full hidden dim, applied
    to ``[b, s, hidden]`` before the head reshape and RoPE."""
    if bits >= 32:
        return x
    return sym_fake_quant(x, bits, -1)
