"""Fused fake-quant matmul for QAT: integer forward, STE backward (the JAX
package's ``ops/pallas/qat_matmul.py``).

``sym_fake_quant(x) @ sym_fake_quant(w)`` equals the exact integer dot
``qx . qw`` followed by one division by ``(sx+eps) * (sw+eps)``, so the
forward runs as an int8 product. That product is a library GEMM in both
packages (the JAX package leaves it to XLA's ``dot_general``, outside any
Pallas kernel): ``torch._int_mm`` on the GPU, the exact float64 product on the
CPU. The backward applies the reference's STE masks (zero outside +-2)
around matmuls at the gradient's type, with fp32 results, against the
*fake-quant* operands.

Valid for ``3 <= w_bits <= 8`` and ``2 < a_bits <= 8``.

Under tensor parallelism (``tp``, the mesh's 'tp' group; ``parallel.tensor``)
the product is the one-device one, as GSPMD gives it in the JAX package. A
column-parallel layer (``row=False``: ``[K, N/tp]``) computes its columns
locally and sums its ``dx`` partials over 'tp' in f32 before the mask and the
one rounding. A row-parallel layer (``row=True``: ``[K/tp, N]``, the input's
K split alike) takes its activation and weight absmax over 'tp' and sums the
exact integer partial products over 'tp' before its one division, which is
the integer XLA's K-sharded int32 ``dot_general`` gives.
"""

from __future__ import annotations

from typing import Tuple

import torch

from llm_qat_torch.ops.quant_matmul import _exact_int_dot, _scale
from llm_qat_torch.ops.quantize import DEFAULT_CLIP
from llm_qat_torch.parallel import comm
from llm_qat_torch.parallel import tensor as ptensor

_EPS = 1e-6


def supported(w_bits: int, a_bits: int) -> bool:
    return 3 <= w_bits <= 8 and 2 < a_bits <= 8


def _quant_int(x: torch.Tensor, bits: int, axis, group=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int quantization along ``axis`` into an int8 container; the
    absmax is taken at the input's type (its maximum over ``group`` where
    that splits ``axis``), the scale in f32."""
    qmax = float(2 ** (bits - 1) - 1)
    s = _scale(qmax, ptensor.max_over_tp(x.abs().amax(dim=axis, keepdim=True), group))
    q = torch.round(x.float() * s).to(torch.int8)
    return q, s


def int_dot(xq: torch.Tensor, wq: torch.Tensor, group=None) -> torch.Tensor:
    """``[M, K] int8 @ [K, N] int8`` as f32: the exact integer sum, rounded to
    f32 once (the JAX package's ``acc.astype(f32)``); with ``group`` the
    rank's K block, its exact partial (int32 on the GPU, float64 on the CPU)
    summed over the group first. On the GPU the library int8 GEMM, which
    wants more than 16 rows (padded here) and K, N multiples of 8; it is
    handed the weight K-contiguous (a transposed copy, 1 byte an element),
    the layout it has a tensor-core kernel for."""
    if not xq.is_cuda:
        acc = _exact_int_dot(xq, wq)
    else:
        M, K = xq.shape
        N = wq.shape[1]
        if K % 8 or N % 8:
            raise NotImplementedError(
                f"int_dot: the GPU int8 GEMM needs K and N multiples of 8, got {K}, {N}")
        wt = wq.t().contiguous().t()
        if M <= 16:
            pad = xq.new_zeros((32 - M, K))
            acc = torch._int_mm(torch.cat([xq, pad]), wt)[:M].contiguous()
        else:
            acc = torch._int_mm(xq.contiguous(), wt)
    if group is not None:
        comm.all_reduce_(acc, group)
    return acc.float()


def mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` (2-D) with an fp32 result from operands of one type: fp32
    accumulation and no rounding of the result to bf16, as the JAX package's
    ``preferred_element_type=float32`` products."""
    if a.dtype == torch.float32:
        return a @ b
    if a.is_cuda:
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


def dequant(q: torch.Tensor, s: torch.Tensor, dtype) -> torch.Tensor:
    """The fake-quant operand ``q / (s + eps)`` rebuilt from its integers."""
    return (q.float() / (s + _EPS)).to(dtype)


def ste_mask(x: torch.Tensor, dx: torch.Tensor) -> torch.Tensor:
    lo, hi = DEFAULT_CLIP
    return torch.where((x < hi) & (x > lo), dx, torch.zeros_like(dx))


def int_dense(xq, sx, wq, sw, out_dtype, group=None) -> torch.Tensor:
    """The fake-quant product from the integers: one division of the exact
    integer sum (over ``group``, a row-parallel layer's, where given)."""
    return (int_dot(xq, wq, group) / ((sx + _EPS) * (sw + _EPS))).to(out_dtype)


def _fwd_impl(x2: torch.Tensor, w: torch.Tensor, w_bits: int, a_bits: int, group=None):
    xq, sx = _quant_int(x2, a_bits, axis=-1, group=group)
    wq, sw = _quant_int(w, w_bits, axis=0, group=group)
    out = int_dot(xq, wq, group) / ((sx + _EPS) * (sw + _EPS))
    return out, (xq, sx, wq, sw)


class _FusedQuantMatmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, w_bits, a_bits, tp, row):
        x2 = x.reshape(-1, x.shape[-1])
        out, (xq, sx, _, _) = _fwd_impl(x2, w, w_bits, a_bits, tp if row else None)
        # residuals: the activation's integers and scales rebuild its
        # fake-quant operand; the weight's are recomputed (a weight is small
        # beside an activation); raw x and w only for the STE masks
        ctx.save_for_backward(x, w, xq, sx)
        ctx.w_bits, ctx.tp, ctx.row = w_bits, tp, row
        return out.reshape(*x.shape[:-1], w.shape[-1]).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        x, w, xq, sx = ctx.saved_tensors
        mm_t = g.dtype
        g2 = g.reshape(-1, g.shape[-1])
        wq, sw = _quant_int(w, ctx.w_bits, axis=0, group=ctx.tp if ctx.row else None)
        x_fq = dequant(xq, sx, mm_t)
        w_fq = dequant(wq, sw, mm_t)
        x2 = x.reshape(-1, x.shape[-1])
        dx = mm_f32(g2, w_fq.t())
        if ctx.tp is not None and not ctx.row:
            comm.all_reduce_(dx, ctx.tp)      # the columns' partials, in f32
        dx = ste_mask(x2, dx)
        dw = ste_mask(w, mm_f32(x_fq.t(), g2))
        return dx.reshape(x.shape).to(x.dtype), dw.to(w.dtype), None, None, None, None


def fused_quant_matmul(x: torch.Tensor, w: torch.Tensor, w_bits: int,
                       a_bits: int, tp=None, row: bool = False) -> torch.Tensor:
    """``act_fake_quant(x) @ weight_fake_quant(w)`` as an integer product.
    ``x``: ``[..., K]`` activations, ``w``: ``[K, N]`` latent fp weights.
    ``tp``, ``row``: this rank's part of a column- or row-parallel layer
    (see the module's docstring)."""
    return _FusedQuantMatmul.apply(x, w, w_bits, a_bits, tp, row)
