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

``group``: the 'tp' process group over which the reduced dims are split
(``parallel.tensor``), or None. Where JAX's GSPMD reduces over the whole dim
(a row-parallel layer's input, a per-tensor scale, the K/V heads of a
rank), the statistic is combined over the group: the absmax and the maximum
by MAX, the minimum by MIN, the scaled means' sums by SUM over the global
count.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import torch

from llm_qat_torch.parallel import tensor as ptensor

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


def _reduce(x: torch.Tensor, ax, op: str, group=None) -> torch.Tensor:
    """amax / amin / mean over ``ax`` with kept dims, or over everything,
    combined over ``group`` where that splits the reduced dims."""
    if group is None:
        return getattr(x, op)() if ax is None else getattr(x, op)(dim=ax, keepdim=True)
    if op == "mean":
        total = x.sum() if ax is None else x.sum(dim=ax, keepdim=True)
        count = x.numel() // total.numel() * ptensor.size(group)
        return ptensor.sum_over_tp(total, group) / count
    r = getattr(x, op)() if ax is None else getattr(x, op)(dim=ax, keepdim=True)
    return (ptensor.max_over_tp if op == "amax" else ptensor.min_over_tp)(r, group)


def _div_into(num: float, den: torch.Tensor) -> torch.Tensor:
    """``num / den`` as one IEEE division in ``den``'s type (torch's
    ``scalar / tensor`` multiplies by the reciprocal, which can differ in
    the last bit and flip a rounded integer)."""
    return torch.full_like(den, num) / den


def sym_fake_quant_raw(x: torch.Tensor, bits: int, axis: Axis, group=None) -> torch.Tensor:
    """Quantize-dequantize: ``round(x*s) / (s + 1e-6)`` with
    ``s = qmax / (absmax + 1e-6)``; absmax is detached."""
    ax = _canon_axis(axis)
    absmax = _reduce(x.detach().abs(), ax, "amax", group)
    qmax = float(2 ** (bits - 1) - 1)
    s = _div_into(qmax, absmax + _SYM_EPS)
    return torch.round(x * s) / (s + _SYM_EPS)


def asym_fake_quant_raw(x: torch.Tensor, bits: int, axis: Axis, group=None) -> torch.Tensor:
    """Min-max affine quantize-dequantize onto ``2^b - 1`` levels."""
    ax = _canon_axis(axis)
    xd = x.detach()
    xmax, xmin = _reduce(xd, ax, "amax", group), _reduce(xd, ax, "amin", group)
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
    def forward(ctx, x, raw, bits, axis, clip, group):
        ctx.save_for_backward(x)
        ctx.clip = clip
        return raw(x.detach(), bits, axis, group)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        lo, hi = ctx.clip
        mask = (x < hi) & (x > lo)
        return torch.where(mask, g, torch.zeros_like(g)), None, None, None, None, None


def sym_fake_quant(x: torch.Tensor, bits: int, axis: Axis = -1,
                   clip: Tuple[float, float] = DEFAULT_CLIP, group=None) -> torch.Tensor:
    """Symmetric dynamic-range fake-quant with the STE backward."""
    return _ClipSTE.apply(x, sym_fake_quant_raw, bits, axis, clip, group)


def asym_fake_quant(x: torch.Tensor, bits: int, axis: Axis = -1,
                    clip: Tuple[float, float] = DEFAULT_CLIP, group=None) -> torch.Tensor:
    """Asymmetric fake-quant with the same STE backward."""
    return _ClipSTE.apply(x, asym_fake_quant_raw, bits, axis, clip, group)


def _binary_weight_raw(w: torch.Tensor, axis: Axis, group=None) -> torch.Tensor:
    """1-bit: ``scale * sign(w / scale)``, ``scale = mean|w|``."""
    scale = _reduce(w.abs(), _canon_axis(axis), "mean", group)
    return scale * torch.sign(w / scale)


def _twobit_weight_raw(w: torch.Tensor, axis: Axis, group=None) -> torch.Tensor:
    """2-bit: half-level-offset rounding of ``w / (2*mean|w|)`` clamped to
    +-(1 - 1e-2), two levels a side."""
    num_levels = 2.0
    clip_val = 1.0 - 1e-2
    scale = 2.0 * _reduce(w.abs(), _canon_axis(axis), "mean", group)
    q = (torch.round(torch.clamp(w / scale, -clip_val, clip_val) * num_levels - 0.5)
         + 0.5) / num_levels
    return scale * q


class _IdentitySTE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, w, bits, axis, group):
        wd = w.detach()
        raw = _binary_weight_raw if bits == 1 else _twobit_weight_raw
        return raw(wd, axis, group)

    @staticmethod
    def backward(ctx, g):
        return g, None, None, None


def lowbit_weight_fake_quant(w: torch.Tensor, bits: int, axis: Axis = 0,
                             group=None) -> torch.Tensor:
    """1/2-bit weight fake-quant with an identity STE (no clip mask)."""
    return _IdentitySTE.apply(w, bits, axis, group)


def weight_fake_quant(w: torch.Tensor, bits: int, *, layerwise: bool = False,
                      group=None) -> torch.Tensor:
    """Weight policy: passthrough at >= 32 bits, symmetric per output channel
    with the masked STE from 3 bits on, the scaled-mean branches at 2 and 1.
    ``group``: as the module says, for the dims the scale reduces."""
    if bits >= 32:
        return w
    axis = None if layerwise else 0
    if bits >= 3:
        return sym_fake_quant(w, bits, axis, group=group)
    return lowbit_weight_fake_quant(w, bits, axis, group)


def act_fake_quant(x: torch.Tensor, bits: int, *, symmetric: bool = True,
                   layerwise: bool = False, group=None) -> torch.Tensor:
    """Activation policy: active only for ``2 < bits < 32``; per token.
    ``group``: the 'tp' group of a row-parallel layer's input (its hidden dim
    split), or None."""
    if not (2 < bits < 32):
        return x
    axis = None if layerwise else -1
    fn = sym_fake_quant if symmetric else asym_fake_quant
    return fn(x, bits, axis, group=group)


def kv_fake_quant(x: torch.Tensor, bits: int, group=None) -> torch.Tensor:
    """KV fake-quant: symmetric per token over the full hidden dim, applied
    to ``[b, s, hidden]`` before the head reshape and RoPE. ``group``: the
    'tp' group whose ranks hold the other kv heads of the token's row."""
    if bits >= 32:
        return x
    return sym_fake_quant(x, bits, -1, group=group)
