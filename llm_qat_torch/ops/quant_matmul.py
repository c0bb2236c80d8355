"""True low-bit quantized matmul: int8 x int8 and W4A8, with the scale fixup.

Math contract (the JAX package's ``ops/pallas/quant_matmul.py``)::

    s_w[j] = qmax / (absmax_k |w[k,j]| + 1e-6)      per output channel
    s_x[i] = qmax / (absmax_k |x[i,k]| + 1e-6)      per token
    wq = round(w * s_w);  xq = round(x * s_x)       (round half to even)
    out[i,j] = (sum_k xq[i,k] * wq[k,j]) * (1 / ((s_x[i]+1e-6) * (s_w[j]+1e-6)))

Four kernel entry points, each beside its plain PyTorch version:

* ``int8_matmul`` (``csrc/int8_matmul.cu``) replaces
  ``llm_qat_tpu/ops/pallas/quant_matmul.py:_int8_matmul_kernel``.
* ``int4_matmul`` (``csrc/w4a8_matmul.cu``) replaces
  ``llm_qat_tpu/ops/pallas/quant_matmul.py:_w4a8_matmul_kernel``.
* ``int8_matmul_stacked`` (``csrc/int8_matmul.cu``, entry point
  ``int8_matmul_stacked``) replaces
  ``llm_qat_tpu/ops/pallas/quant_matmul.py:int8_matmul_stacked``, and
  ``int4_matmul_stacked`` (``csrc/w4a8_matmul.cu``, entry point
  ``w4a8_matmul_stacked``) replaces ``...:int4_matmul_stacked``: the same
  device code reading layer ``layer`` of a stacked ``[L, K(/2), N]`` weight
  in place (the kernel offsets its base pointers; no slice is copied).

Each entry point has two variants (``csrc/gemm_int8.cuh``), which
``gemm_plan`` picks from the (padded) row count: ``decode`` (M <= 64, bound
by the weight bytes: K split over every SM, a cp.async ring of weight
tiles) and ``prefill`` (M > 64, bound by the tensor cores: 128 x 128 wgmma
tiles). The blocks that split one tile along K form a cluster and sum
their int32 partials in distributed shared memory: no workspace, and
integer sums are exact, so every plan gives the same bits.

A wrapper takes the plain version only for tensors on the CPU; on a CUDA
tensor it launches its kernel or raises. Each wrapper counts its launches in
its ``launches`` attribute. The plain versions accumulate in float64, which
holds every int8 x int8 sum of these shapes exactly (|sum| < 2**53), so they
give the kernels' int32 accumulator bit for bit on either device.
"""

from __future__ import annotations

import functools
from typing import Tuple

import torch

from llm_qat_torch.ops import _build

_EPS = 1e-6  # reference epsilon (utils_quant.py:71-72)

# Below this row count quant_linear's W8 path launches the int8 kernel; at or
# above it, it takes the library int8 GEMM (the JAX package's XLA int8 dot).
XLA_INT8_MIN_ROWS = 128


# ---------------------------------------------------------------------------
# Quantizers (produce the true-int operands)
# ---------------------------------------------------------------------------


def _scale(qmax: float, absmax: torch.Tensor) -> torch.Tensor:
    """``qmax / (absmax + 1e-6)`` in f32 as one IEEE division (torch's
    ``scalar / tensor`` multiplies by the reciprocal, which can differ in
    the last bit and flip a rounded integer). The numerator is filled on
    the tensor's device: no host-to-device copy."""
    den = absmax.float() + _EPS
    return torch.full((), qmax, dtype=torch.float32, device=den.device) / den


def quantize_per_token(
    x: torch.Tensor, bits: int = 8, amax: torch.Tensor = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """[..., K] -> (int8 values, f32 scales [..., 1]); symmetric absmax with
    the reference's +1e-6. ``amax`` overrides the local absmax."""
    qmax = float(2 ** (bits - 1) - 1)
    if amax is None:
        amax = x.abs().amax(dim=-1, keepdim=True)
    s = _scale(qmax, amax)
    q = torch.round(x.float() * s).to(torch.int8)
    return q, s


def quantize_per_channel(
    w: torch.Tensor, bits: int = 8
) -> Tuple[torch.Tensor, torch.Tensor]:
    """[..., K, N] -> (int8 values, f32 scales [..., 1, N]); per output
    channel (absmax over K)."""
    qmax = float(2 ** (bits - 1) - 1)
    s = _scale(qmax, w.abs().amax(dim=-2, keepdim=True))
    q = torch.round(w.float() * s).to(torch.int8)
    return q, s


def pack_int4(q: torch.Tensor, axis: int = -2) -> torch.Tensor:
    """int8 in [-8, 7] -> uint8 with half the length along ``axis``,
    split-half packed: element k of the top half rides in the high nibble
    of element k - n/2. The one owner of the nibble format: weights pack
    along K (axis -2 of ``[..., K, N]``), KV caches along the head dim."""
    n = q.shape[axis]
    assert n % 2 == 0, q.shape
    lo = q.narrow(axis, 0, n // 2).to(torch.uint8) & 0xF
    hi = q.narrow(axis, n // 2, n // 2).to(torch.uint8) & 0xF
    return (hi << 4) | lo


def unpack_int4(packed: torch.Tensor, axis: int = -2) -> torch.Tensor:
    """Inverse of pack_int4 -> int8 (sign-extended nibbles), the low
    nibbles first along ``axis``."""
    p = packed.to(torch.int32)
    lo = ((p << 28) >> 28).to(torch.int8)
    hi = ((p << 24) >> 28).to(torch.int8)
    return torch.cat([lo, hi], dim=axis)


def quantize_weights_w4(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """[..., K, N] fp -> (packed uint8 [..., K//2, N], scales [..., 1, N])."""
    q, s = quantize_per_channel(w, bits=4)
    return pack_int4(q), s


def _pad_rows(x: torch.Tensor, multiple: int) -> Tuple[torch.Tensor, int]:
    M = x.shape[0]
    pad = (-M) % multiple
    if pad:
        x = torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))], dim=0)
    return x, M


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------


def _exact_int_dot(xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """The int8 x int8 product, exact, as float64 (see module docstring)."""
    return xq.to(torch.float64) @ wq.to(torch.float64)


def _int8_matmul_plain(xq, wq, sx, sw, out_dtype=torch.bfloat16):
    """Plain version of the int8 kernel: the exact int32 accumulator through
    the kernel's epilogue ``acc * (1/((sx+eps)*(sw+eps)))``."""
    acc = _exact_int_dot(xq, wq).float()
    inv = 1.0 / ((sx + _EPS) * (sw + _EPS))
    return (acc * inv).to(out_dtype)


def _int4_matmul_plain(xq, w_packed, sx, sw, out_dtype=torch.bfloat16):
    """Plain version of the W4A8 kernel: unpack the nibbles, then the int8
    product and epilogue (integer sums are exact, so the split-half K order
    cannot change the result)."""
    return _int8_matmul_plain(xq, unpack_int4(w_packed), sx, sw, out_dtype)


def int8_matmul_xla(xq, wq, sx, sw, *, out_dtype=torch.bfloat16):
    """Same math as ``int8_matmul`` with the epilogue as a division, the
    JAX package's ``int8_matmul_xla`` (its large-M W8 route). On the GPU the
    product is the library int8 GEMM ``torch._int_mm`` (the JAX package leaves
    this product to XLA, outside any Pallas kernel); on the CPU it is the
    exact float64 product."""
    if xq.is_cuda:
        acc = torch._int_mm(xq, wq)
    else:
        acc = _exact_int_dot(xq, wq)
    return (acc.float() / ((sx + _EPS) * (sw + _EPS))).to(out_dtype)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

_OUT_CODES = {torch.float32: 0, torch.bfloat16: 1}

# Variant picking (csrc/gemm_int8.cuh). GEMM_BK: weight rows a stage (packed
# rows at W4; half as many in the W4 prefill variant). Decode: 64-column
# blocks over all M <= 64 rows, K split until the grid holds
# DECODE_BLOCKS_PER_SM blocks an SM or more. Prefill: 128 x 128 tiles, K
# split until the tiles cover the SMs, and no split shorter than
# PREFILL_MIN_STEPS stages. A tile's splits form one cluster that sums
# their partials in distributed shared memory: MAX_SPLITS at most.

DECODE_MAX_ROWS = 64
GEMM_BK = 128
# K the kernels take: any multiple of 32 (a last, partial stage zero-fills
# the rows past K; the W4 high half starts at K/2, read in 16-byte pieces)
GEMM_K_MULTIPLE = 32
DECODE_BN, PREFILL_BM, PREFILL_BN = 64, 128, 128
DECODE_BLOCKS_PER_SM = 1
MAX_SPLITS = 8          # csrc/gemm_int8.cuh MAX_SPLITS: a portable cluster
PREFILL_MIN_STEPS = 4
H100_SMS = 132
_VARIANTS = {"decode": 0, "prefill": 1}


def gemm_plan(M: int, N: int, K: int, w4: bool, sms: int = H100_SMS) -> dict:
    """How the kernels run an ``[M, K] x [K, N]`` product (``w4``: packed
    ``[K/2, N]`` weight) on a card of ``sms`` SMs: the variant, its tile
    (``bm`` x ``bn``), the output tiles, the steps of ``bk`` stored weight
    rows, and the split of those steps over the blocks of a tile's cluster.
    Pure: the CPU tests call it."""
    kw = K // 2 if w4 else K
    if M <= DECODE_MAX_ROWS:
        variant, bm, bn, bk = "decode", (32 if M <= 32 else 64), DECODE_BN, GEMM_BK
        tiles = -(-N // bn)
        steps = -(-kw // bk)
        splits = -(-DECODE_BLOCKS_PER_SM * sms // tiles)
    else:
        variant, bm, bn = "prefill", PREFILL_BM, PREFILL_BN
        bk = GEMM_BK // 2 if w4 else GEMM_BK
        tiles = -(-M // bm) * -(-N // bn)
        steps = -(-kw // bk)
        splits = min(-(-sms // tiles), steps // PREFILL_MIN_STEPS)
    return dict(variant=variant, bm=bm, bn=bn, bk=bk, tiles=tiles, steps=steps,
                splits=max(1, min(splits, steps, MAX_SPLITS)))


def _check_operands(xq, w, sx, sw, out_dtype, k_per_row):
    M, K = xq.shape
    Kw, N = w.shape
    if K != k_per_row * Kw:
        raise ValueError(f"K mismatch: x {tuple(xq.shape)}, w {tuple(w.shape)}")
    if tuple(sx.shape) != (M, 1) or tuple(sw.shape) != (1, N):
        raise ValueError(f"scale shapes {tuple(sx.shape)}, {tuple(sw.shape)}")
    if out_dtype not in _OUT_CODES:
        raise ValueError(f"out_dtype {out_dtype} not supported")
    return M, K, N


@functools.lru_cache(maxsize=4096)
def _plan(M: int, N: int, K: int, w4: bool, device_index: int) -> dict:
    """``gemm_plan`` for the card of ``device_index``, cached: the serving
    path calls the same few shapes thousands of times a run."""
    sms = torch.cuda.get_device_properties(device_index).multi_processor_count
    return gemm_plan(M, N, K, w4, sms)


def check_gemm_shape(fn: str, N: int, K: int) -> None:
    """Raise ``ValueError`` unless the kernels take an ``[., K] x [K, N]``
    product: ``N % 64 == 0`` and ``K % GEMM_K_MULTIPLE == 0``."""
    if N % 64 or K % GEMM_K_MULTIPLE:
        raise ValueError(f"{fn}: needs N % 64 == 0 and K % {GEMM_K_MULTIPLE} == 0, got {N}, {K}")


def _launch_gemm(stem, fn, xq, w, sx, sw, out_dtype, M, N, K, layer=None, plan=None):
    """``layer`` given: ``w``/``sw`` are the stacked tensors and ``fn`` the
    stacked entry point, which takes the layer index. ``plan``: a
    ``gemm_plan`` to run instead of the wrapper's own (the card tests force
    every split count with it)."""
    for name, t, dt in (("xq", xq, torch.int8), ("sx", sx, torch.float32),
                        ("sw", sw, torch.float32)):
        if t.dtype != dt or not t.is_contiguous() or not t.is_cuda:
            raise ValueError(f"{fn}: {name} must be a contiguous CUDA {dt}")
    if not w.is_contiguous() or not w.is_cuda:
        raise ValueError(f"{fn}: weight must be a contiguous CUDA tensor")
    check_gemm_shape(fn, N, K)
    out = torch.empty((M, N), dtype=out_dtype, device=xq.device)
    if M == 0:
        return out
    if plan is None:
        plan = _plan(M, N, K, stem == "w4a8_matmul", xq.device.index)
    ints = (M, N, K) if layer is None else (M, N, K, layer)
    ints += (_VARIANTS[plan["variant"]], plan["splits"])
    f = _build.bind(stem, fn, 5, len(ints) + 1)
    err = f(xq.data_ptr(), w.data_ptr(), sx.data_ptr(), sw.data_ptr(), out.data_ptr(),
            *ints, _OUT_CODES[out_dtype], torch.cuda.current_stream(xq.device).cuda_stream)
    _build.check(err, fn)
    return out


def kernel_attributes() -> dict:
    """What the compiler gave every variant of K1/K2 (and so K5/K6), by name
    ``{int8|w4a8}_{variant}_m{rows}_{bf16|f32}``: registers a thread, shared
    bytes (static, dynamic), local (spill) bytes a thread, threads a block
    and blocks an SM can hold. Launches nothing."""
    return {f"{tag}_{variant}_m{bm}_{od}": _build.attributes(
                stem, f"{stem}_attributes", _VARIANTS[variant], bm, code)
            for tag, stem in (("int8", "int8_matmul"), ("w4a8", "w4a8_matmul"))
            for variant, bm in (("decode", 32), ("decode", 64), ("prefill", PREFILL_BM))
            for od, code in (("bf16", 1), ("f32", 0))}


def int8_matmul(
    xq: torch.Tensor,   # [M, K] int8
    wq: torch.Tensor,   # [K, N] int8
    sx: torch.Tensor,   # [M, 1] f32 per-token scales
    sw: torch.Tensor,   # [1, N] f32 per-channel scales
    *,
    out_dtype=torch.bfloat16,
) -> torch.Tensor:
    """True-int8 matmul with scale fixup: ``(xq @ wq) / (sx * sw)``."""
    M, K, N = _check_operands(xq, wq, sx, sw, out_dtype, 1)
    if xq.device.type == "cpu":
        return _int8_matmul_plain(xq, wq, sx, sw, out_dtype)
    if wq.dtype != torch.int8:
        raise ValueError("int8_matmul: wq must be int8")
    out = _launch_gemm("int8_matmul", "int8_matmul", xq, wq, sx, sw,
                       out_dtype, M, N, K)
    int8_matmul.launches += 1
    return out


int8_matmul.launches = 0


def int4_matmul(
    xq: torch.Tensor,        # [M, K] int8
    w_packed: torch.Tensor,  # [K//2, N] uint8, split-half packed
    sx: torch.Tensor,        # [M, 1] f32
    sw: torch.Tensor,        # [1, N] f32
    *,
    out_dtype=torch.bfloat16,
) -> torch.Tensor:
    """True-W4 matmul: packed nibbles are the only weight traffic; the kernel
    unpacks them in registers and feeds int8 tensor-core products for the low
    and high halves of K."""
    M, K, N = _check_operands(xq, w_packed, sx, sw, out_dtype, 2)
    if xq.device.type == "cpu":
        return _int4_matmul_plain(xq, w_packed, sx, sw, out_dtype)
    if w_packed.dtype != torch.uint8:
        raise ValueError("int4_matmul: w_packed must be uint8")
    out = _launch_gemm("w4a8_matmul", "w4a8_matmul", xq, w_packed, sx, sw,
                       out_dtype, M, N, K)
    int4_matmul.launches += 1
    return out


int4_matmul.launches = 0


def _check_stacked(xq, w_all, sx, sw_all, layer, out_dtype, k_per_row):
    if w_all.dim() != 3 or sw_all.dim() != 3 or not 0 <= layer < w_all.shape[0]:
        raise ValueError(f"stacked weight {tuple(w_all.shape)}, scales "
                         f"{tuple(sw_all.shape)}, layer {layer}")
    if sw_all.shape[0] != w_all.shape[0]:
        raise ValueError(f"stacked scales {tuple(sw_all.shape)} for weight "
                         f"{tuple(w_all.shape)}")
    return _check_operands(xq, w_all[layer], sx, sw_all[layer], out_dtype, k_per_row)


def int8_matmul_stacked(
    xq: torch.Tensor,      # [M, K] int8
    wq_all: torch.Tensor,  # [L, K, N] int8: the WHOLE stacked weight
    sx: torch.Tensor,      # [M, 1] f32
    sw_all: torch.Tensor,  # [L, 1, N] f32
    *,
    layer: int,
    out_dtype=torch.bfloat16,
) -> torch.Tensor:
    """``int8_matmul`` reading layer ``layer`` of a stacked weight in place."""
    M, K, N = _check_stacked(xq, wq_all, sx, sw_all, layer, out_dtype, 1)
    if xq.device.type == "cpu":
        return _int8_matmul_plain(xq, wq_all[layer], sx, sw_all[layer], out_dtype)
    if wq_all.dtype != torch.int8:
        raise ValueError("int8_matmul_stacked: wq_all must be int8")
    out = _launch_gemm("int8_matmul", "int8_matmul_stacked", xq, wq_all, sx, sw_all,
                       out_dtype, M, N, K, layer)
    int8_matmul_stacked.launches += 1
    return out


int8_matmul_stacked.launches = 0


def int4_matmul_stacked(
    xq: torch.Tensor,      # [M, K] int8
    wp_all: torch.Tensor,  # [L, K//2, N] uint8, split-half packed: WHOLE stack
    sx: torch.Tensor,      # [M, 1] f32
    sw_all: torch.Tensor,  # [L, 1, N] f32
    *,
    layer: int,
    out_dtype=torch.bfloat16,
) -> torch.Tensor:
    """``int4_matmul`` reading layer ``layer`` of the stacked packed weight
    in place."""
    M, K, N = _check_stacked(xq, wp_all, sx, sw_all, layer, out_dtype, 2)
    if xq.device.type == "cpu":
        return _int4_matmul_plain(xq, wp_all[layer], sx, sw_all[layer], out_dtype)
    if wp_all.dtype != torch.uint8:
        raise ValueError("int4_matmul_stacked: wp_all must be uint8")
    out = _launch_gemm("w4a8_matmul", "w4a8_matmul_stacked", xq, wp_all, sx, sw_all,
                       out_dtype, M, N, K, layer)
    int4_matmul_stacked.launches += 1
    return out


int4_matmul_stacked.launches = 0


def quantize_rows(x, bits: int, amax=None):
    """Per-token activation quant at ``bits`` levels of ``[M, K]`` rows,
    padded to a multiple of 32: (int8 rows, f32 scales, M). ``amax``: the
    rows' absmax when another computed it (the global one under tensor
    parallelism, where ``x`` holds a K-shard)."""
    xq, sx = quantize_per_token(x, bits, amax=amax)
    xq, M = _pad_rows(xq, 32)
    sx, _ = _pad_rows(sx, 32)
    return xq, sx, M


def act_matmul(xq, w, sx, sw, w4: bool, out_dtype):
    """The int product of padded rows from ``quantize_rows``: W4 through
    ``int4_matmul``; W8 through ``int8_matmul`` below ``XLA_INT8_MIN_ROWS``
    padded rows, the library int8 GEMM from there. The JAX package decides on
    the unpadded count: the two differ only for 97..127 rows, and only in the
    epilogue's last bit."""
    if w4:
        return int4_matmul(xq, w, sx, sw, out_dtype=out_dtype)
    kernel = int8_matmul_xla if xq.shape[0] >= XLA_INT8_MIN_ROWS else int8_matmul
    return kernel(xq, w, sx, sw, out_dtype=out_dtype)


def w8a8_matmul(x, wq, sw, *, out_dtype=torch.bfloat16, bits: int = 8, amax=None):
    """Dynamic per-token activation quant + int8 matmul: the weight-bound
    int8 kernel at decode row counts, the library int8 GEMM from
    ``XLA_INT8_MIN_ROWS`` padded rows on."""
    xq, sx, M = quantize_rows(x, bits, amax)
    return act_matmul(xq, wq, sx, sw, False, out_dtype)[:M]


def w4a8_matmul(x, w_packed, sw, *, out_dtype=torch.bfloat16, bits: int = 8, amax=None):
    """Dynamic per-token activation quant + fused W4 matmul (every row
    count)."""
    xq, sx, M = quantize_rows(x, bits, amax)
    return act_matmul(xq, w_packed, sx, sw, True, out_dtype)[:M]
