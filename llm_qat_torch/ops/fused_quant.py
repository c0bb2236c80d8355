"""Producer-fused activation quantization (the JAX package's
``ops/pallas/fused_quant.py``): the quantization runs inside the op that
produces the activation, so the bf16 tensor never reaches device memory.

* ``rmsnorm_quant`` launches ``csrc/fused_quant.cu:rmsnorm_quant``, which
  replaces ``llm_qat_tpu/ops/pallas/fused_quant.py:_rmsnorm_quant_kernel``:
  RMSNorm + per-token symmetric quant in one pass.
* ``silu_mul_quant`` launches ``csrc/fused_quant.cu:silu_mul_quant``, which
  replaces ``...:_silu_mul_quant_kernel``: SiLU(gate) * up + per-token quant.

Beside each its plain PyTorch version; a wrapper takes it only for tensors on
the CPU. Numerics contract: the normed / gated value is rounded to the
activation type first (what the unfused path materializes), then quantized
from that value with ``s = qmax/(absmax+1e-6)`` and ``round(x*s)``. RMSNorm
accumulates in fp32 and takes the mean as ``sum * (1/K)``; SiLU's sigmoid is
evaluated in fp32. Against another fp32 summation order the scales agree to
the last bits and an integer may differ by exactly 1 where ``x*s`` sits on a
rounding boundary.
"""

from __future__ import annotations

from typing import Tuple

import torch

from llm_qat_torch.ops import _build
from llm_qat_torch.ops.quant_matmul import _scale

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_ROW = 56 * 1024     # fp32 values of one row a block holds in shared memory


def supported(x: torch.Tensor) -> bool:
    """Shape contract of the JAX package's kernels, kept so that both
    packages take the same route: ``[M, K]`` with M a multiple of 8 and K a
    multiple of 128."""
    if x.dim() != 2:
        return False
    m, k = x.shape
    return m % 8 == 0 and k % 128 == 0 and k >= 128


def _quant_rows(x32: torch.Tensor, a_bits: int) -> Tuple[torch.Tensor, torch.Tensor]:
    qmax = float(2 ** (a_bits - 1) - 1)
    s = _scale(qmax, x32.abs().amax(dim=1, keepdim=True))
    return torch.round(x32 * s).to(torch.int8), s


def _rmsnorm_quant_plain(h, g, eps: float, a_bits: int):
    """Plain PyTorch version of the RMSNorm+quant kernel."""
    out_dt = torch.promote_types(h.dtype, g.dtype)
    xf = h.float()
    var = (xf * xf).sum(dim=1, keepdim=True) * (1.0 / h.shape[1])
    xn = (xf * torch.rsqrt(var + eps)).to(h.dtype).float()
    xnf = (xn * g.float()).to(out_dt).float()
    return _quant_rows(xnf, a_bits)


def _silu_mul_quant_plain(gate, up, a_bits: int):
    """Plain PyTorch version of the SiLU*up+quant kernel."""
    sig = torch.sigmoid(gate.float()).to(gate.dtype)
    y = gate * sig * up
    return _quant_rows(y.float(), a_bits)


def _check(name, x, *same):
    if x.dim() != 2:
        raise ValueError(f"{name}: expected [M, K], got {tuple(x.shape)}")
    for t in same:
        if t.shape != x.shape or t.dtype != x.dtype or t.device != x.device:
            raise ValueError(f"{name}: operands differ in shape, type or device")
    if not x.is_cuda:
        raise ValueError(f"{name}: input on {x.device}")
    if x.dtype not in _DTYPE_CODES:
        raise NotImplementedError(f"{name}: f32 or bf16 input, got {x.dtype}")
    if x.shape[1] > _MAX_ROW:
        raise NotImplementedError(f"{name}: rows of at most {_MAX_ROW}, got {x.shape[1]}")


def rmsnorm_quant(h: torch.Tensor, g: torch.Tensor, eps: float,
                  a_bits: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused RMSNorm + per-token symmetric quant. ``h``: ``[M, H]`` bf16/f32,
    ``g``: ``[H]`` gain. Returns ``(xq int8 [M, H], sx f32 [M, 1])`` with
    ``xq/sx == fake_quant(rms_norm(h, g))`` under the int-dot identity."""
    if g.shape != (h.shape[-1],):
        raise ValueError(f"rmsnorm_quant: gain {tuple(g.shape)} for h {tuple(h.shape)}")
    if h.device.type == "cpu":
        return _rmsnorm_quant_plain(h, g, eps, a_bits)
    _check("rmsnorm_quant", h)
    m, k = h.shape
    out_dt = torch.promote_types(h.dtype, g.dtype)
    hc, gf = h.contiguous(), g.float().contiguous()
    xq = torch.empty((m, k), dtype=torch.int8, device=h.device)
    sx = torch.empty((m, 1), dtype=torch.float32, device=h.device)
    f = _build.bind("fused_quant", "rmsnorm_quant", 4, 4, 3)
    err = f(hc.data_ptr(), gf.data_ptr(), xq.data_ptr(), sx.data_ptr(), m, k,
            _DTYPE_CODES[h.dtype], int(out_dt == torch.bfloat16), float(eps),
            float(2 ** (a_bits - 1) - 1), 1.0 / k,
            torch.cuda.current_stream(h.device).cuda_stream)
    _build.check(err, "rmsnorm_quant")
    rmsnorm_quant.launches += 1
    return xq, sx


rmsnorm_quant.launches = 0


def silu_mul_quant(gate: torch.Tensor, up: torch.Tensor,
                   a_bits: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused SiLU(gate)*up + per-token symmetric quant. ``gate``, ``up``:
    ``[M, I]``. Returns ``(yq int8 [M, I], sy f32 [M, 1])``."""
    if gate.device.type == "cpu":
        return _silu_mul_quant_plain(gate, up, a_bits)
    _check("silu_mul_quant", gate, up)
    m, k = gate.shape
    gc, uc = gate.contiguous(), up.contiguous()
    yq = torch.empty((m, k), dtype=torch.int8, device=gate.device)
    sy = torch.empty((m, 1), dtype=torch.float32, device=gate.device)
    f = _build.bind("fused_quant", "silu_mul_quant", 4, 3, 1)
    err = f(gc.data_ptr(), uc.data_ptr(), yq.data_ptr(), sy.data_ptr(), m, k,
            _DTYPE_CODES[gate.dtype], float(2 ** (a_bits - 1) - 1),
            torch.cuda.current_stream(gate.device).cuda_stream)
    _build.check(err, "silu_mul_quant")
    silu_mul_quant.launches += 1
    return yq, sy


silu_mul_quant.launches = 0
