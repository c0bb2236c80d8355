"""Producer-fused activation quantization (the JAX package's
``ops/pallas/fused_quant.py``): the quantization runs inside the op that
produces the activation, so the bf16 tensor never reaches device memory.

* ``rmsnorm_quant`` launches ``csrc/fused_quant.cu:rmsnorm_quant``, which
  replaces ``llm_qat_tpu/ops/pallas/fused_quant.py:_rmsnorm_quant_kernel``:
  RMSNorm + per-token symmetric quant in one pass.
* ``silu_mul_quant`` launches ``csrc/fused_quant.cu:silu_mul_quant``, which
  replaces ``...:_silu_mul_quant_kernel``: SiLU(gate) * up + per-token quant.
  Under tensor parallelism a rank holds ``I/tp`` of each row, and the scale
  spans the whole row: ``silu_mul_amax`` (``fused_quant.cu:silu_mul_amax``)
  writes each row's local max ``|silu(gate) * up|``, the caller takes the
  MAX over 'tp', and ``silu_mul_quant(..., amax=)`` (launching
  ``silu_mul_quant_amax``) quantizes with that given row max: the integers
  and scale the one-device kernel gives the whole row.

Beside each its plain PyTorch version; a wrapper takes it only for tensors on
the CPU. ``plan`` picks the kernel's layout from the row width (a row held in
registers by a group of warps, or, for rows too wide or misaligned, staged in
shared memory). Numerics contract: the normed / gated value is rounded to the
activation type first (what the unfused path materializes), then quantized
from that value with ``s = qmax/(absmax+1e-6)`` and ``round(x*s)``. RMSNorm
sums the fp32 squares in fp32 and takes the mean as ``sum * (1/K)``; SiLU's
sigmoid is evaluated in fp32. SiLU*up+quant sums nothing, and its kernel
agrees with its plain version to the bit. The RMSNorm kernel sums the squares
in its own order: each thread's strided partial sum, then a fixed pairwise
tree over the threads of a row (``_sum_sq_kernel_order``). On the card the
plain version sums in that order too, so kernel and plain version agree to
the bit; on the CPU it keeps the fp32 ``sum(dim=1)`` that JAX's mean matches
(one sum order cannot serve both: the two can put ``rsqrt`` an ulp apart, and
two bf16 roundings then carry an integer two levels).
"""

from __future__ import annotations

from typing import Tuple

import torch

from llm_qat_torch.ops import _build
from llm_qat_torch.ops.quant_matmul import _scale

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# csrc/fused_quant.cu's limits, by hand (its fused_quant_limits reports them,
# and a -m cuda test holds these to it)
_IN_WORDS = 32           # IN_WORDS: 32-bit words a thread holds for its chunks at most
_MAX_ROW = 56 * 1024     # STAGED_ROW: fp32 values of one row a staged kernel holds
_MAX_GROUPS = 8          # MAX_GROUPS: row groups a block
_MAX_WARPS = 32          # MAX_THREADS / 32
# plan()'s own choices
_WORDS = 16              # the words a thread plan() prefers
_STAGE_SMEM = 220 * 1024  # bytes of shared memory a block's two stages may take


def supported(x: torch.Tensor) -> bool:
    """Shape contract of the JAX package's kernels, kept so that both
    packages take the same route: ``[M, K]`` with M a multiple of 8 and K a
    multiple of 128."""
    if x.dim() != 2:
        return False
    m, k = x.shape
    return m % 8 == 0 and k % 128 == 0 and k >= 128


def plan(k: int, itemsize: int, n_inputs: int, aligned: bool = True,
         f32_products: bool = False) -> Tuple[int, int, int]:
    """``(v, wpr, rows)`` for ``csrc/fused_quant.cu`` at row width ``k``,
    ``itemsize`` bytes an input element, ``n_inputs`` inputs (1: RMSNorm,
    2: SiLU*up). A row is ``k / 8`` chunks of 8 elements: 4 words an input in
    bf16, 8 in f32, and 8 more where RMSNorm keeps its products with an f32
    gain (``f32_products``). The register kernel gives each thread ``v``
    chunks of a row and a row ``wpr`` warps: the fewest warps that hold the
    row at ``_WORDS`` words a thread (at least two chunks where the kernel
    takes two; else at the most it takes, ``_IN_WORDS``), then the fewest
    chunks a thread, a power of two, that cover it; ``rows`` row groups a
    block (8 of one warp, 4 of two, 2 of three or four, else one). RMSNorm's
    row groups walk the rows through a ring of two shared-memory stages,
    which must fit ``_STAGE_SMEM`` a block; SiLU*up's take a row each. Rows
    no register plan fits, rows whose width is not a multiple of 8 and
    tensors that are not 16-byte aligned take the staged kernel (``v = -1``),
    an element a thread at a time; ``wpr`` is then its block's warps."""
    staged = -1, min(_MAX_WARPS, -(-k // 32)), 1
    if k % 8 or not aligned:
        return staged
    chunks = k // 8
    cw = 2 * itemsize * n_inputs                 # input words of a chunk
    rw = cw + (8 if f32_products else 0)         # words a thread holds for it
    for budget in (max(_WORDS, 2 * rw), _IN_WORDS):
        vmax = 1 << ((budget // rw).bit_length() - 1) if budget >= rw else 0
        if not vmax or chunks > 32 * _MAX_WARPS * vmax:
            continue
        wpr = -(-chunks // (32 * vmax))
        v = 1 << (-(-chunks // (32 * wpr)) - 1).bit_length()   # a power of two
        rows = max(1, _MAX_GROUPS // wpr)
        if n_inputs == 2:
            return v, wpr, rows
        group_bytes = 2 * 4 * cw * v * 32 * wpr  # a row group's two stages
        if group_bytes <= _STAGE_SMEM:
            return v, wpr, max(1, min(rows, _STAGE_SMEM // group_bytes))
        break                                    # more words a thread need no fewer bytes
    return staged


def _aligned(*ts) -> bool:
    return all(t.data_ptr() % 16 == 0 for t in ts)


def kernel_attributes() -> dict:
    """What the compiler gave every kernel of ``csrc/fused_quant.cu``, by name
    ``{rmsnorm_quant|silu_mul_quant|silu_mul_amax|silu_mul_quant_amax}_{input}
    [_{gain}]_{v<n>|staged}``:
    registers a thread, shared bytes (static, dynamic), local (spill) bytes a
    thread, threads a block and blocks an SM can hold (the register kernels
    at 256 threads, RMSNorm's with two stages, the staged ones at 1024 and a
    row of ``_MAX_ROW`` values). Launches nothing."""
    # kernel, name, h's code, the gain's, words of a chunk a thread holds
    variants = [(0, "rmsnorm_quant_bf16_bf16", 1, 1, 4), (0, "rmsnorm_quant_bf16_f32", 1, 0, 12),
                (0, "rmsnorm_quant_f32", 0, 0, 16)]
    for kernel, name in ((1, "silu_mul_quant"), (2, "silu_mul_amax"), (3, "silu_mul_quant_amax")):
        variants += [(kernel, f"{name}_bf16", 1, 0, 8), (kernel, f"{name}_f32", 0, 0, 16)]
    out = {}
    for kernel, name, code, gain_code, rw in variants:
        vmax = 1 << ((_IN_WORDS // rw).bit_length() - 1)
        for v in [*(1 << j for j in range(vmax.bit_length())), -1]:
            tag = f"v{v}" if v > 0 else "staged"
            out[f"{name}_{tag}"] = _build.attributes("fused_quant", "fused_quant_attributes",
                                                     kernel, code, gain_code, v)
    return out


def _quant_rows(x32: torch.Tensor, a_bits: int) -> Tuple[torch.Tensor, torch.Tensor]:
    qmax = float(2 ** (a_bits - 1) - 1)
    s = _scale(qmax, x32.abs().amax(dim=1, keepdim=True))
    return torch.round(x32 * s).to(torch.int8), s


def _launch_operands(h, g):
    """(h, gain, plan) as ``rmsnorm_quant`` hands them to the kernel: a bf16
    gain stays bf16 beside a bf16 h (the product is bf16), else f32."""
    hc = h.contiguous()
    same = h.dtype == g.dtype == torch.bfloat16
    gc = g.contiguous() if same else g.float().contiguous()
    return hc, gc, plan(h.shape[1], h.element_size(), 1, _aligned(hc, gc), f32_products=not same)


def _sum_sq_kernel_order(xf: torch.Tensor, v: int, wpr: int) -> torch.Tensor:
    """Per-row fp32 sum of squares ``[M, 1]`` in ``csrc/fused_quant.cu``'s
    order for the plan ``(v, wpr)``: a row's ``T = 32 wpr`` threads each sum
    their elements sequentially (the register kernel: chunks of 8, chunk
    ``c = t + i T``, i then the 8 elements; the staged kernel, ``v = -1``:
    elements ``t + j T``), every square rounded to fp32; then each warp's
    xor-shuffle butterfly (the upper 16 lanes onto the lower, then 8, 4, 2,
    1), then the warps' sums in warp order. Elements past the row add +0,
    which changes no sum."""
    m, k = xf.shape
    tpr = 32 * wpr
    if v > 0:
        x = torch.nn.functional.pad(xf, (0, 8 * v * tpr - k))
        x = x.reshape(m, v, tpr, 8).permute(0, 1, 3, 2).reshape(m, 8 * v, tpr)
    else:
        x = torch.nn.functional.pad(xf, (0, -(-k // tpr) * tpr - k)).reshape(m, -1, tpr)
    sq = x * x
    ss = sq[:, 0]
    for i in range(1, sq.shape[1]):
        ss = ss + sq[:, i]
    ss = ss.reshape(m, wpr, 32)
    for off in (16, 8, 4, 2, 1):
        ss = ss[..., :off] + ss[..., off:2 * off]
    total = ss[:, 0]
    for w in range(1, wpr):
        total = total + ss[:, w]
    return total


def _rmsnorm_quant_plain(h, g, eps: float, a_bits: int, kernel_order=None):
    """Plain PyTorch version of the RMSNorm+quant kernel. ``kernel_order``
    (default: h on the card) sums the squares as the kernel does
    (``_sum_sq_kernel_order``); else as one ``sum(dim=1)``."""
    out_dt = torch.promote_types(h.dtype, g.dtype)
    xf = h.float()
    if h.is_cuda if kernel_order is None else kernel_order:
        _, _, (v, wpr, _) = _launch_operands(h, g)
        ss = _sum_sq_kernel_order(xf, v, wpr)
    else:
        ss = (xf * xf).sum(dim=1, keepdim=True)
    var = ss * (1.0 / h.shape[1])
    xn = (xf * torch.rsqrt(var + eps)).to(h.dtype).float()
    xnf = (xn * g.float()).to(out_dt).float()
    return _quant_rows(xnf, a_bits)


def _silu_mul(gate, up):
    sig = torch.sigmoid(gate.float()).to(gate.dtype)
    return gate * sig * up


def _silu_mul_quant_plain(gate, up, a_bits: int, amax=None):
    """Plain PyTorch version of the SiLU*up+quant kernel; ``amax`` ``[M, 1]``
    f32: the row max to quantize with, in place of the row's own."""
    y = _silu_mul(gate, up).float()
    if amax is None:
        return _quant_rows(y, a_bits)
    s = _scale(float(2 ** (a_bits - 1) - 1), amax)
    return torch.round(y * s).to(torch.int8), s


def _silu_mul_amax_plain(gate, up):
    """Plain PyTorch version of the row-max entry: ``[M, 1]`` f32."""
    return _silu_mul(gate, up).float().abs().amax(dim=1, keepdim=True)


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
    hc, gc, layout = _launch_operands(h, g)
    xq = torch.empty((m, k), dtype=torch.int8, device=h.device)
    sx = torch.empty((m, 1), dtype=torch.float32, device=h.device)
    f = _build.bind("fused_quant", "rmsnorm_quant", 4, 7, 3)
    err = f(hc.data_ptr(), gc.data_ptr(), xq.data_ptr(), sx.data_ptr(), m, k,
            _DTYPE_CODES[h.dtype], _DTYPE_CODES[gc.dtype],
            *layout,
            float(eps), float(2 ** (a_bits - 1) - 1), 1.0 / k,
            torch.cuda.current_stream(h.device).cuda_stream)
    _build.check(err, "rmsnorm_quant")
    rmsnorm_quant.launches += 1
    return xq, sx


rmsnorm_quant.launches = 0


def silu_mul_quant(gate: torch.Tensor, up: torch.Tensor, a_bits: int,
                   amax: torch.Tensor = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused SiLU(gate)*up + per-token symmetric quant. ``gate``, ``up``:
    ``[M, I]``. Returns ``(yq int8 [M, I], sy f32 [M, 1])``. ``amax``
    (``[M, 1]`` f32): quantize with this row max (``silu_mul_quant_amax``)."""
    if amax is not None:
        return silu_mul_quant_amax(gate, up, amax, a_bits)
    if gate.device.type == "cpu":
        return _silu_mul_quant_plain(gate, up, a_bits)
    _check("silu_mul_quant", gate, up)
    m, k = gate.shape
    gc, uc = gate.contiguous(), up.contiguous()
    yq = torch.empty((m, k), dtype=torch.int8, device=gate.device)
    sy = torch.empty((m, 1), dtype=torch.float32, device=gate.device)
    f = _build.bind("fused_quant", "silu_mul_quant", 4, 6, 1)
    err = f(gc.data_ptr(), uc.data_ptr(), yq.data_ptr(), sy.data_ptr(), m, k,
            _DTYPE_CODES[gate.dtype], *plan(k, gate.element_size(), 2, _aligned(gc, uc)),
            float(2 ** (a_bits - 1) - 1), torch.cuda.current_stream(gate.device).cuda_stream)
    _build.check(err, "silu_mul_quant")
    silu_mul_quant.launches += 1
    return yq, sy


silu_mul_quant.launches = 0


def silu_mul_amax(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    """Each row's max ``|silu(gate) * up|`` as ``[M, 1]`` f32 (a rank's part
    of the row under tensor parallelism), quantizing nothing."""
    if gate.device.type == "cpu":
        return _silu_mul_amax_plain(gate, up)
    _check("silu_mul_amax", gate, up)
    m, k = gate.shape
    gc, uc = gate.contiguous(), up.contiguous()
    am = torch.empty((m, 1), dtype=torch.float32, device=gate.device)
    f = _build.bind("fused_quant", "silu_mul_amax", 3, 6)
    err = f(gc.data_ptr(), uc.data_ptr(), am.data_ptr(), m, k, _DTYPE_CODES[gate.dtype],
            *plan(k, gate.element_size(), 2, _aligned(gc, uc)),
            torch.cuda.current_stream(gate.device).cuda_stream)
    _build.check(err, "silu_mul_amax")
    silu_mul_amax.launches += 1
    return am


silu_mul_amax.launches = 0


def silu_mul_quant_amax(gate: torch.Tensor, up: torch.Tensor, amax: torch.Tensor,
                        a_bits: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``silu_mul_quant`` with each row's max given (``amax`` ``[M, 1]`` f32,
    e.g. ``silu_mul_amax``'s taken over the 'tp' group)."""
    if amax.shape != (gate.shape[0], 1) or amax.dtype != torch.float32:
        raise ValueError(f"silu_mul_quant_amax: amax {amax.dtype}{tuple(amax.shape)} for "
                         f"{tuple(gate.shape)}")
    if gate.device.type == "cpu":
        return _silu_mul_quant_plain(gate, up, a_bits, amax)
    _check("silu_mul_quant_amax", gate, up)
    m, k = gate.shape
    gc, uc, ac = gate.contiguous(), up.contiguous(), amax.contiguous()
    if ac.device != gate.device:
        raise ValueError(f"silu_mul_quant_amax: amax on {ac.device}")
    yq = torch.empty((m, k), dtype=torch.int8, device=gate.device)
    sy = torch.empty((m, 1), dtype=torch.float32, device=gate.device)
    f = _build.bind("fused_quant", "silu_mul_quant_amax", 5, 6, 1)
    err = f(gc.data_ptr(), uc.data_ptr(), ac.data_ptr(), yq.data_ptr(), sy.data_ptr(), m, k,
            _DTYPE_CODES[gate.dtype], *plan(k, gate.element_size(), 2, _aligned(gc, uc)),
            float(2 ** (a_bits - 1) - 1), torch.cuda.current_stream(gate.device).cuda_stream)
    _build.check(err, "silu_mul_quant_amax")
    silu_mul_quant_amax.launches += 1
    return yq, sy


silu_mul_quant_amax.launches = 0
