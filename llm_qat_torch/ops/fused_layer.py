"""Producer-fused QAT blocks: norm / activation fused into the integer
matmul path (the JAX package's ``ops/fused_layer.py``).

The quantization runs inside the op that produces the activation
(``ops/fused_quant.py``: the RMSNorm+quant and SiLU*up+quant kernels), and the
int8 values with their per-token scales feed the integer product directly.

* ``fused_norm_dense(h, g, ws)``: RMSNorm -> act-quant -> N integer matmuls
  sharing the quantized activation (q/k/v share the attention norm, gate/up
  the MLP norm).
* ``fused_norm_qkv_flash``: the same for q/k/v, emitting the flash kernel's
  head-major layout ``q [b, kvh, g, s, d]``, ``k, v [b, kvh, s, d]``.
* ``fused_attn_out_dense(attn5, wo)``: per-token act-quant of the flash-layout
  attention output + the o projection, ``[b, s, H]`` out.
* ``fused_silu_mul_dense(gate, up, w)``: SiLU*up -> act-quant -> the down
  projection.

The JAX package runs the two flash-layout projections as einsums straight
into and out of the head-major layout (a relayout that rides its matrix unit);
here they are the flat integer product and a relayout of its result (of the
int8 values on the way in): the same integers, scales and output layout.

Gradients are the reference's STE semantics: pass-through masked to zero
outside [-2, 2] on BOTH the activation input of each matmul and the latent
weight, composed with the analytic RMSNorm / SiLU backward. The backward
rebuilds the fake-quant operands from the int8 residuals, recomputes the
cheap elementwise producers from the block inputs, and takes its products at
the gradient's type with fp32 results, summed in fp32 before the mask.

Under tensor parallelism (``tp``: the mesh's 'tp' group, ``parallel.tensor``)
each block is this rank's part of the one-device function, as GSPMD computes
it in the JAX package: ``fused_norm_dense`` is column-parallel (weights
``[H, N/tp]``; the norm and its quantization are whole on every rank; ``dh``
sums its f32 partials over 'tp' before the mask); ``fused_attn_out_dense``
and ``fused_silu_mul_dense`` are row-parallel (this rank's heads or
intermediate columns; the activation's per-token scale and the weight's
per-channel scale take their absmax over 'tp', the integer partial products
are summed over 'tp' before the division, and the backward needs no
collective). SiLU*up's row max comes from ``fused_quant.silu_mul_amax``,
taken over 'tp', and feeds ``silu_mul_quant(..., amax=)``.
"""

from __future__ import annotations

from typing import Tuple

import torch

from llm_qat_torch.ops import fused_quant
from llm_qat_torch.ops.qat_matmul import (
    _quant_int, dequant, int_dense, mm_f32, ste_mask as _ste_mask,
    supported as _qm_supported,
)
from llm_qat_torch.ops.quant_matmul import _scale
from llm_qat_torch.parallel import comm
from llm_qat_torch.parallel import tensor as ptensor


def supported(x2: torch.Tensor, w_bits: int, a_bits: int) -> bool:
    return _qm_supported(w_bits, a_bits) and fused_quant.supported(x2)


def _rms_r(h2: torch.Tensor, eps: float):
    """(fp32 input, ``rsqrt(mean(x^2) + eps)``) of the rows of ``h2``."""
    xf = h2.float()
    return xf, torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)


def _rms_norm_bwd(h2, g, eps: float, dxn):
    """Analytic RMSNorm backward for ``xn = (xf * rsqrt(mean(xf^2)+eps))
    .to(dt) * g`` (casts treated as identity)."""
    xf, r = _rms_r(h2, eps)
    u = xf * r
    du = dxn * g.float()
    H = h2.shape[-1]
    dxf = r * du - (r / H) * u * (u * du).sum(dim=-1, keepdim=True)
    dg = (dxn * u).sum(dim=0)
    return dxf.to(h2.dtype), dg.to(g.dtype)


class _NormDense(torch.autograd.Function):
    """RMSNorm -> quant -> N shared-activation matmuls on ``[M, H]`` rows."""

    @staticmethod
    def forward(ctx, w_bits, a_bits, eps, tp, h2, g, *ws):
        out_dt = torch.promote_types(h2.dtype, g.dtype)
        xq, sx = fused_quant.rmsnorm_quant(h2, g, eps, a_bits)
        outs = []
        for w in ws:
            wq, sw = _quant_int(w, w_bits, axis=0)
            outs.append(int_dense(xq, sx, wq, sw, out_dt))
        ctx.save_for_backward(h2, g, xq, sx, *ws)
        ctx.cfg = (w_bits, eps, tp)
        return tuple(outs)

    @staticmethod
    def backward(ctx, *gs):
        h2, g, xq, sx, *ws = ctx.saved_tensors
        w_bits, eps, tp = ctx.cfg
        mm_t = gs[0].dtype
        x_fq = dequant(xq, sx, mm_t)
        # the normed activation again, for the STE clip mask (elementwise)
        xf, r = _rms_r(h2, eps)
        xn = (xf * r).to(h2.dtype) * g

        dxn = torch.zeros(h2.shape, dtype=torch.float32, device=h2.device)
        dws = []
        for w, gy in zip(ws, gs):
            wq, sw = _quant_int(w, w_bits, axis=0)
            w_fq = dequant(wq, sw, mm_t)
            dxn = dxn + mm_f32(gy, w_fq.t())
            dws.append(_ste_mask(w, mm_f32(x_fq.t(), gy)).to(w.dtype))
        if tp is not None:
            comm.all_reduce_(dxn, tp)         # the output columns' partials
        dxn = _ste_mask(xn, dxn)
        dh, dg = _rms_norm_bwd(h2, g, eps, dxn)
        return (None, None, None, None, dh, dg, *dws)


def fused_norm_dense(
    h: torch.Tensor,   # [..., H] residual stream
    g: torch.Tensor,   # [H] norm gain
    ws: Tuple[torch.Tensor, ...],  # each [H, N_i] latent fp weights
    *,
    w_bits: int,
    a_bits: int,
    eps: float,
    tp=None,
) -> Tuple[torch.Tensor, ...]:
    """``(act_fq(rms_norm(h, g)) @ w_fq for w in ws)`` in one fused pass;
    column-parallel over ``tp``."""
    lead = h.shape[:-1]
    h2 = h.reshape(-1, h.shape[-1])
    outs = _NormDense.apply(w_bits, a_bits, eps, tp, h2, g, *ws)
    return tuple(o.reshape(*lead, w.shape[-1]) for o, w in zip(outs, ws))


def fused_norm_qkv_flash(
    h: torch.Tensor,   # [b, s, H]
    g: torch.Tensor,   # [H]
    wq: torch.Tensor,  # [H, nh*hd]
    wk: torch.Tensor,  # [H, kvh*hd]
    wv: torch.Tensor,  # [H, kvh*hd]
    kvh: int,
    *,
    w_bits: int,
    a_bits: int,
    eps: float,
    tp=None,
):
    """RMSNorm + act-quant + q/k/v projections emitting the flash kernel's
    head-major layout: ``q [b, kvh, g, s, d]; k, v [b, kvh, s, d]`` (``kvh``
    this rank's kv heads under ``tp``)."""
    b, s, _ = h.shape
    d = wk.shape[1] // kvh
    groups = wq.shape[1] // wk.shape[1]
    q, k, v = fused_norm_dense(h, g, (wq, wk, wv), w_bits=w_bits, a_bits=a_bits, eps=eps, tp=tp)
    q5 = q.reshape(b, s, kvh, groups, d).permute(0, 2, 3, 1, 4)
    k4 = k.reshape(b, s, kvh, d).permute(0, 2, 1, 3)
    v4 = v.reshape(b, s, kvh, d).permute(0, 2, 1, 3)
    return q5, k4, v4


def _quant_per_token_heads(attn5: torch.Tensor, a_bits: int, tp=None):
    """Per-token symmetric act quant with the token's hidden dim spread over
    (kvh, g, d): the absmax over those axes is the flat per-token absmax
    (with the other ranks' heads under ``tp``). The maximum runs at the
    input's type and only the reduced absmax goes to f32."""
    qmax = float(2 ** (a_bits - 1) - 1)
    am = ptensor.max_over_tp(attn5.abs().amax(dim=(1, 2, 4), keepdim=True), tp)
    s = _scale(qmax, am)
    return torch.round(attn5.float() * s).to(torch.int8), s


class _AttnOutDense(torch.autograd.Function):
    @staticmethod
    def forward(ctx, w_bits, a_bits, tp, attn5, wo):
        b, kvh, groups, s, d = attn5.shape
        # quantize in the flash layout, move the int8 values (one byte each)
        # to token-major rows, then the flat integer product
        aq, sa = _quant_per_token_heads(attn5, a_bits, tp)
        aq2 = aq.permute(0, 3, 1, 2, 4).reshape(b * s, kvh * groups * d)
        sa2 = sa.reshape(b * s, 1)
        woq, swo = _quant_int(wo, w_bits, axis=0, group=tp)
        out = int_dense(aq2, sa2, woq, swo, attn5.dtype, tp).reshape(b, s, wo.shape[1])
        ctx.save_for_backward(attn5, aq2, sa2, wo)
        ctx.w_bits, ctx.tp = w_bits, tp
        return out

    @staticmethod
    def backward(ctx, gy):
        attn5, aq2, sa2, wo = ctx.saved_tensors
        b, kvh, groups, s, d = attn5.shape
        mm_t = gy.dtype
        gy2 = gy.reshape(b * s, wo.shape[1])
        woq, swo = _quant_int(wo, ctx.w_bits, axis=0, group=ctx.tp)
        wo_fq = dequant(woq, swo, mm_t)
        a_fq = dequant(aq2, sa2, mm_t)
        da = mm_f32(gy2, wo_fq.t()).reshape(b, s, kvh, groups, d).permute(0, 2, 3, 1, 4)
        da = _ste_mask(attn5, da).to(attn5.dtype)
        dwo = _ste_mask(wo, mm_f32(a_fq.t(), gy2)).to(wo.dtype)
        return None, None, None, da, dwo


def fused_attn_out_dense(
    attn5: torch.Tensor,  # [b, kvh, g, s, d] flash-layout attention output
    wo: torch.Tensor,     # [nh*hd, H]
    *,
    w_bits: int,
    a_bits: int,
    tp=None,
) -> torch.Tensor:
    """Per-token act-quant + o projection consuming the flash layout:
    ``[b, s, H]`` out; row-parallel over ``tp`` (this rank's heads and
    ``wo``'s rows for them)."""
    return _AttnOutDense.apply(w_bits, a_bits, tp, attn5, wo)


def _silu_mul_quant(gate2, up2, a_bits: int, tp):
    """SiLU*up + per-token quant; under ``tp`` with the row max over 'tp'."""
    if tp is None:
        return fused_quant.silu_mul_quant(gate2, up2, a_bits)
    amax = ptensor.max_over_tp(fused_quant.silu_mul_amax(gate2, up2), tp)
    return fused_quant.silu_mul_quant(gate2, up2, a_bits, amax=amax)


class _SiluMulDense(torch.autograd.Function):
    @staticmethod
    def forward(ctx, w_bits, a_bits, tp, gate2, up2, w):
        yq, sy = _silu_mul_quant(gate2, up2, a_bits, tp)
        wq, sw = _quant_int(w, w_bits, axis=0, group=tp)
        ctx.save_for_backward(gate2, up2, yq, sy, w)
        ctx.w_bits, ctx.tp = w_bits, tp
        return int_dense(yq, sy, wq, sw, gate2.dtype, tp)

    @staticmethod
    def backward(ctx, gy):
        gate2, up2, yq, sy, w = ctx.saved_tensors
        mm_t = gy.dtype
        wq, sw = _quant_int(w, ctx.w_bits, axis=0, group=ctx.tp)
        w_fq = dequant(wq, sw, mm_t)
        y_fq = dequant(yq, sy, mm_t)

        gf = gate2.float()
        sig = torch.sigmoid(gf)
        silu = (gf * sig).to(gate2.dtype)
        y = silu * up2   # the product again, for the STE mask

        dy = _ste_mask(y, mm_f32(gy, w_fq.t()))
        dw = _ste_mask(w, mm_f32(y_fq.t(), gy)).to(w.dtype)
        dgate = dy * up2.float() * (sig * (1.0 + gf * (1.0 - sig)))
        dup = dy * silu.float()
        return None, None, None, dgate.to(gate2.dtype), dup.to(up2.dtype), dw


def fused_silu_mul_dense(
    gate: torch.Tensor,  # [..., I]
    up: torch.Tensor,    # [..., I]
    w: torch.Tensor,     # [I, H]
    *,
    w_bits: int,
    a_bits: int,
    tp=None,
) -> torch.Tensor:
    """``act_fq(silu(gate) * up) @ w_fq`` in one fused pass; row-parallel
    over ``tp`` (this rank's intermediate columns and ``w``'s rows)."""
    lead = gate.shape[:-1]
    g2 = gate.reshape(-1, gate.shape[-1])
    u2 = up.reshape(-1, up.shape[-1])
    out = _SiluMulDense.apply(w_bits, a_bits, tp, g2, u2, w)
    return out.reshape(*lead, w.shape[-1])
