"""Whole-model decode step: all L layers of one token per slot in one kernel.

Port of the JAX package's ``inference/megakernel.py``. ``decode_step`` has
the contract of ``model._forward`` at s = 1; ``model._forward`` sends the
default configuration (``use_megakernel=True``) here when ``supported()``.

``decode_layers`` launches ``csrc/megakernel.cu``, which replaces
``llm_qat_tpu/inference/megakernel.py:_kernel`` (the body of its
``pl.pallas_call``): one persistent cooperative launch computes every layer.
Beside it ``decode_layers_plain`` (and ``decode_step_plain`` around it)
repeats the TPU kernel's arithmetic step by step in plain PyTorch at any
shape; it runs for tensors on the CPU and in the tests, never for a CUDA
tensor on the serving path: there ``decode_layers`` launches the kernel or
raises.

Numerics (per layer, as the TPU kernel): RMSNorm, per-token activation quant
``sx = qmax / (absmax + 1e-6)``, exact int32 products (W4: split-half packed
nibbles), fixup ``acc / ((sx + 1e-6)(sw + 1e-6))`` as a division; new K/V
quantized per token, before RoPE in "pre" mode and after it in "post" mode;
the query rotated in the compute type; attention as an online softmax over
``BK``-column blocks of the int8 or nibble-packed cache (a slot skips blocks
past its length; ``cos * ks``, ``sin * ks`` and ``p * vs`` round to the
compute type), the current token folded in as a last term (``p = 0`` for an
inactive slot, ``l`` floored at 1e-9); SiLU in fp32 then cast (the scan path
takes it in the model type: the two paths differ there by design); the
residual stream kept in ``dtype``.

``BK`` is part of the numerics (it decides where the running maximum and the
roundings fall), so ``pick_bk`` reproduces the JAX package's choice for the
same ``(config, b, max_len)``. Its weight-chunk width and head tile only
order exact integer sums and independent rows; the CUDA kernel tiles for the
H100 instead (see the source).

Every floating-point sum whose result is rounded afterwards (the RMSNorm sum
of squares, q.k, the softmax denominator, p.V) is accumulated in float64 and
rounded to float32 once. Such a sum does not depend on the order of its
terms beyond 2**-53, so the kernel, whose threads add in another order than
PyTorch does, gives the plain version's float32 values bit for bit, and 22
re-quantizing layers have no last-bit difference to amplify.

Shape rules. ``supported()`` (decided from the configuration, before any
launch): ``w_bits`` in {4, 8}, ``2 < a_bits <= 8``, ``b <= 32``,
``max_len % BK == 0``. The CUDA kernel is built for (query heads per kv
head, head dim) = (8, 64) (TinyLlama-1.1B) and (1, 128) (the LLaMA-7B/13B
family), ``H`` and ``I`` multiples of 256, projection widths multiples of
128, ``BK`` and ``S`` multiples of 16, bf16 or f32 (``card_takes``); its
shared memory does not depend on ``BK`` or ``b``. For another shape on the
GPU ``decode_layers`` raises ``NotImplementedError`` and ``model._forward``
sends the step to the scan path (decided from the configuration).

The kernel reads a K-contiguous copy of the projections' integers
(``card_weights``: ``[L, N, K]`` int8, or ``[L, N, K/2]`` split-half
nibbles at W4, cut into the kernel's contiguous 128 x 256 tiles), made
once and kept beside the JAX-layout ``q`` that the scan path and the plain
version read: as many bytes again as the weights (6.5 GB at LLaMA-7B W8).
"""

from __future__ import annotations

import ctypes
import math
import weakref
from typing import Any, Dict, Tuple

import torch

from llm_qat_torch.device import check_on, resolve_device
from llm_qat_torch.inference import model as M
from llm_qat_torch.models import llama
from llm_qat_torch.models.config import LlamaConfig
from llm_qat_torch.ops import _build
from llm_qat_torch.ops import quant_matmul as QM

_EPS = QM._EPS
_NEG_INF = -1e30


# ---------------------------------------------------------------------------
# BK: the JAX package's picker, kept only to reproduce its KV block size
# ---------------------------------------------------------------------------
# The functions below copy ``_vmem_estimate`` / ``_budget`` / ``_pick_nc_bk``
# of the JAX package. Their byte counts and budgets describe the TPU
# compiler's scratch memory, not this port or the GPU; they stay because the
# block size they arrive at is part of the numerics.

_TPU_BUDGET = 15_500_000
_TPU_BUDGET_MHA = 12_800_000


def _pad8(x: int) -> int:
    return -(-x // 8) * 8


def _pad128(x: int) -> int:
    return -(-x // 128) * 128


def _tpu_budget(c: LlamaConfig) -> int:
    groups = c.num_attention_heads // c.kv_heads
    return _TPU_BUDGET_MHA if groups < 8 and c.kv_heads >= 16 else _TPU_BUDGET


def _tpu_estimate(c: LlamaConfig, b: int, max_len: int, nc: int, bk: int, kh: int) -> int:
    H, I = c.hidden_size, c.intermediate_size
    nh, kvh, hd = c.num_attention_heads, c.kv_heads, c.head_dim
    groups = nh // kvh
    kh = kh or kvh
    dq = H + 2 * kvh * hd
    wdiv = 2 if c.w_bits == 4 else 1
    west = 2 * (H // wdiv) * nc + 2 * (I // wdiv) * nc
    hdc = hd // 2 if (c.kv_cache_pack and c.kv_bits <= 4) else hd
    kvbufs = 2 * 2 * b * kh * hdc * bk + 2 * 2 * b * bk * 4
    bm = max(32, -(-b // 8) * 8)
    rep = 8 if (groups == 1 and kh % 8 == 0) else 1
    if (groups % 8 == 0 and kvh > 1) or rep > 1:
        ge = groups * rep
        nt = max(kvh // kh, 1)
        ml = 2 * b * nt * _pad8(kh * ge) * 128 * 4
        accq4 = (b * nt * _pad8(kh * ge) + b * _pad8(nh)) * _pad128(hd) * 4
    else:
        ml = 2 * b * kvh * _pad8(groups) * 128 * 4
        accq4 = 2 * b * kvh * _pad8(groups) * _pad128(hd) * 4
    scratch = (b * (2 * H + dq + 2 * I) * 2 + bm * max(H, I) + b * nh * hd * 4
               + ml + accq4 + nh * bk * 4 + 2 * max_len * (hd // 2) * 4)
    return west + kvbufs + scratch


def pick_bk(c: LlamaConfig, b: int, max_len: int) -> int:
    """The KV block size the JAX package picks for ``(c, b, max_len)``:
    ``megakernel_bk`` if it divides ``max_len``, else 512 halved until it
    does, then halved further (floor 128) while its estimate is over its
    budget; the estimate depends on its chunk width and head tile, so their
    choice is followed too."""
    kvh = c.kv_heads
    groups = c.num_attention_heads // kvh
    batched = groups % 8 == 0 and kvh > 1
    dq = c.hidden_size + 2 * kvh * c.head_dim
    g = math.gcd(math.gcd(c.hidden_size, dq), 2 * c.intermediate_size)

    def over(nc, bk, kh):
        return _tpu_estimate(c, b, max_len, nc, bk, kh) > _tpu_budget(c)

    def auto_nc():
        nc = 256
        while nc > g or g % nc:
            nc //= 2
            if nc == 0:
                return g
        while nc > 1 and c.hidden_size // nc < 2 and nc % 2 == 0:
            nc //= 2
        return nc

    def auto_bk_kh(nc):
        bk = (c.megakernel_bk
              if c.megakernel_bk and max_len % c.megakernel_bk == 0 else 512)
        while max_len % bk:
            bk //= 2
        kh = kvh
        if not c.megakernel_bk:
            while bk > 128 and over(nc, bk, kh):
                bk //= 2
        while (over(nc, bk, kh) and kh % 2 == 0 and kh > 1
               and (not batched or ((kh // 2) * groups) % 8 == 0)):
            kh //= 2
        return max(bk, 1), kh

    if c.megakernel_nc:
        nc = c.megakernel_nc
        bk, kh = auto_bk_kh(nc)
        if g % nc == 0 and c.hidden_size // nc >= 2 and not over(nc, bk, kh):
            return bk
    nc = auto_nc()
    bk, kh = auto_bk_kh(nc)
    while (over(nc, bk, kh) and nc > 128 and nc % 2 == 0
           and c.hidden_size // (nc // 2) >= 2):
        nc //= 2
        bk, kh = auto_bk_kh(nc)
    return bk


# ---------------------------------------------------------------------------
# the configurations the kernel takes
# ---------------------------------------------------------------------------


def supported(config: LlamaConfig, b: int, max_len: int) -> bool:
    """Whether ``decode_step`` takes this configuration (else the scan path
    serves it): decided from the configuration alone, before any launch."""
    c = config
    if c.w_bits not in (4, 8) or not (2 < c.a_bits <= 8):
        return False
    if b > 32:
        return False
    return max_len % pick_bk(c, b, max_len) == 0


# ---------------------------------------------------------------------------
# plain version
# ---------------------------------------------------------------------------


def _dot64(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """A float32 contraction accumulated in float64 (see module docstring)."""
    return torch.einsum(eq, a.double(), b.double()).float()


def _rms_norm(x: torch.Tensor, gain: torch.Tensor, eps: float) -> torch.Tensor:
    """``llama.rms_norm`` with the sum of squares taken in float64."""
    xf = x.float()
    xd = xf.double()
    var = ((xd * xd).sum(dim=-1, keepdim=True) * (1.0 / x.shape[-1])).float()
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * gain


def _rope_halves(x1, x2, cos, sin):
    """Rotate-half RoPE on the two halves of a head, in their own type."""
    return x1 * cos - x2 * sin, x2 * cos + x1 * sin


def _linear(x, qw, l: int, w4: bool, a_bits: int, dtype) -> torch.Tensor:
    """Per-token activation quant, the exact int product with layer ``l`` of
    a stacked weight, and the fixup as a division."""
    xq, sx = QM.quantize_per_token(x, a_bits)
    w = QM.unpack_int4(qw["q"][l]) if w4 else qw["q"][l]
    acc = QM._exact_int_dot(xq, w).float()
    return (acc / ((sx + _EPS) * (qw["s"][l] + _EPS))).to(dtype)


def _attend_plain(q4, k_int, v_int, k_inv, v_inv, layer_cache, kcos, ksin, qcos, qsin,
                  lens, active, config: LlamaConfig, bk: int, dtype):
    """One layer's attention in the plain version: the rotated queries
    ``q4`` [b, kvh, G, hd] (compute type, as f32) against the layer's
    read-only cache ``(k_q, k_s, v_q, v_s)`` as an online softmax over
    ``bk``-column blocks, then the current token (``k_int``/``v_int``
    [b, kv_dim], inverse scales [b, 1]) folded in. Returns [b, nh * hd] in
    ``dtype``."""
    c = config
    b = q4.shape[0]
    hd, kvh, nh = c.head_dim, c.kv_heads, c.num_attention_heads
    h2, groups = hd // 2, nh // kvh
    rope = c.kv_cache_rope != "post"
    packed = M.cache_is_packed(c)
    ct = torch.bfloat16 if dtype == torch.bfloat16 else torch.float32
    scale = 1.0 / (hd ** 0.5)
    k_q, k_s, v_q, v_s = layer_cache
    dev = q4.device
    lens = lens.to(torch.int32)
    act = active.to(torch.bool).reshape(b, 1, 1, 1)
    n_blocks = -(-int(lens.max()) // bk) if b else 0
    # online softmax over the cache, block by block
    m = torch.full((b, kvh, groups, 1), _NEG_INF, dtype=torch.float32, device=dev)
    lsum = torch.zeros_like(m)
    acc = torch.zeros((b, kvh, groups, hd), dtype=torch.float32, device=dev)
    for kb in range(n_blocks):
        st = kb * bk
        kq, vq = k_q[..., st:st + bk], v_q[..., st:st + bk]
        if packed:
            kq, vq = QM.unpack_int4(kq, 2), QM.unpack_int4(vq, 2)
        k1, k2 = kq[:, :, :h2].to(ct), kq[:, :, h2:].to(ct)       # [b, kvh, h2, bk]
        ksl = k_s[:, None, None, st:st + bk]                      # [b, 1, 1, bk]
        vsl = v_s[:, None, None, st:st + bk]
        if rope:
            cc = (kcos[:, st:st + bk] * ksl).to(ct)               # [b, 1, h2, bk]
            ss = (ksin[:, st:st + bk] * ksl).to(ct)
            kr = torch.cat(_rope_halves(k1, k2, cc, ss), dim=2)
        else:
            sl = ksl.to(ct)
            kr = torch.cat([k1 * sl, k2 * sl], dim=2)
        s = _dot64("bhgd,bhdk->bhgk", q4.to(ct), kr) * scale
        col = st + torch.arange(bk, dtype=torch.int32, device=dev)
        valid = (col[None, :] < lens[:, None])[:, None, None, :]
        s = torch.where(valid, s, torch.full_like(s, _NEG_INF))
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        l_new = lsum * alpha + p.double().sum(dim=-1, keepdim=True).float()
        pv = (p * vsl).to(ct)
        acc_new = acc * alpha + _dot64("bhgk,bhdk->bhgd", pv, vq.to(ct))
        # a block past a slot's length contributes nothing
        live = (lens > st).reshape(b, 1, 1, 1)
        m = torch.where(live, m_new, m)
        lsum = torch.where(live, l_new, lsum)
        acc = torch.where(live, acc_new, acc)

    # fold the current token in (active slots only)
    kinv, vinv = k_inv.reshape(b, 1, 1), v_inv.reshape(b, 1, 1).to(ct)
    ki = k_int.reshape(b, kvh, hd).to(ct)
    if rope:
        cc_i = (qcos[:, None, :] * kinv).to(ct)
        ss_i = (qsin[:, None, :] * kinv).to(ct)
        k_fold = torch.cat(_rope_halves(ki[..., :h2], ki[..., h2:], cc_i, ss_i), -1)
    else:
        k_fold = ki * kinv.to(ct)
    v_fold = (v_int.reshape(b, kvh, hd).to(ct) * vinv).float()
    s_cur = _dot64("bhgd,bhd->bhg", q4, k_fold.float())[..., None] * scale
    s_cur = torch.where(act, s_cur, torch.full_like(s_cur, _NEG_INF))
    m_new = torch.maximum(m, s_cur)
    alpha = torch.exp(m - m_new)
    p = torch.where(act, torch.exp(s_cur - m_new), torch.zeros_like(s_cur))
    l_new = torch.clamp(lsum * alpha + p, min=1e-9)
    acc = acc * alpha + p * v_fold[:, :, None, :]
    attn = (acc / l_new).to(dtype).reshape(b, nh * hd)

    return attn


def decode_layers_plain(x, qcos, qsin, kcos, ksin, lay, cache, lens, active,
                        config: LlamaConfig, bk: int, dtype, card=None):
    """Plain PyTorch version of the kernel: ``x`` [b, H] through all L layers
    against the read-only cache. Returns (y [b, H], K ints [L, b, kv_dim]
    int8, V ints, K inverse scales [L, b, 1] f32, V inverse scales).
    ``card`` is not read: the plain version takes the JAX-layout ``q``."""
    c = config
    b, H = x.shape
    hd, kvh, nh = c.head_dim, c.kv_heads, c.num_attention_heads
    h2, groups, kv_dim, q_dim = hd // 2, nh // kvh, kvh * hd, nh * hd
    rope = c.kv_cache_rope != "post"
    w4 = c.w_bits == 4
    kv_bits = min(c.kv_bits, 8)
    ct = torch.bfloat16 if dtype == torch.bfloat16 else torch.float32
    lens = lens.to(torch.int32)
    qc, qs = qcos.to(dtype)[:, None, :], qsin.to(dtype)[:, None, :]   # [b, 1, h2]

    h = x.to(dtype)
    outs = ([], [], [], [])
    for l in range(c.num_hidden_layers):
        xn = _rms_norm(h, lay["attn_norm"][l], c.rms_norm_eps)
        qkv = _linear(xn, lay["qkv"], l, w4, c.a_bits, dtype)

        # the current token's K/V, quantized per token
        k_new = qkv[:, q_dim:q_dim + kv_dim].reshape(b, kvh, hd)
        v_new = qkv[:, q_dim + kv_dim:]
        if not rope:    # "post": rotate K at its position before quantizing
            k_new = torch.cat(_rope_halves(k_new[..., :h2], k_new[..., h2:], qc, qs), -1)
        k_int, ks_s = QM.quantize_per_token(k_new.reshape(b, kv_dim), kv_bits)
        v_int, vs_s = QM.quantize_per_token(v_new, kv_bits)
        k_inv, v_inv = 1.0 / (ks_s + _EPS), 1.0 / (vs_s + _EPS)       # [b, 1]
        for o, t in zip(outs, (k_int, v_int, k_inv, v_inv)):
            o.append(t)

        # query RoPE in the model type, rounded to the compute type
        q = qkv[:, :q_dim].reshape(b, nh, hd)
        q = torch.cat(_rope_halves(q[..., :h2], q[..., h2:], qc, qs), -1)
        q4 = q.to(ct).float().reshape(b, kvh, groups, hd)

        attn = _attend_plain(q4, k_int, v_int, k_inv, v_inv,
                             tuple(cache[k][l] for k in ("k_q", "k_s", "v_q", "v_s")),
                             kcos, ksin, qcos, qsin, lens, active, c, bk, dtype)

        h = h + _linear(attn, lay["o"], l, w4, c.a_bits, dtype)
        xn = _rms_norm(h, lay["mlp_norm"][l], c.rms_norm_eps)
        gu = _linear(xn, lay["gateup"], l, w4, c.a_bits, dtype)
        gate, up = gu[:, :c.intermediate_size].float(), gu[:, c.intermediate_size:].float()
        actv = (gate * torch.sigmoid(gate) * up).to(dtype)            # SiLU in fp32
        h = h + _linear(actv, lay["down"], l, w4, c.a_bits, dtype)
    k_ints, v_ints, k_invs, v_invs = (torch.stack(o) for o in outs)
    return h, k_ints, v_ints, k_invs, v_invs


# ---------------------------------------------------------------------------
# kernel wrapper
# ---------------------------------------------------------------------------

_PTRS = ("x", "qcos", "qsin", "kcos", "ksin", "qkv_s", "o_s", "gu_s", "dn_s",
         "anorm", "mnorm", "qkv_w", "o_w", "gu_w", "dn_w", "kq", "ks", "vq", "vs",
         "lens", "active", "y", "kint", "vint", "kinv", "vinv", "xn", "attn", "act",
         "acc_qkv", "acc_o", "acc_gu", "acc_dn", "amax", "kvmax", "ss", "tcnt",
         "scores", "cmax", "ppart", "pvpart", "stamps", "arrive")
_INTS = ("L", "b", "H", "I", "kvh", "S", "BK", "CH", "w4", "packed", "rope",
         "norm_round", "smem", "shape")
_FLOATS = ("eps", "a_qmax", "kv_qmax", "scale")


class _Params(ctypes.Structure):
    """``struct Params`` of ``csrc/megakernel.cu``, field for field."""
    _fields_ = ([(n, ctypes.c_void_p) for n in _PTRS]
                + [(n, ctypes.c_int) for n in _INTS]
                + [(n, ctypes.c_float) for n in _FLOATS])


_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# (query heads per kv head, head dim) -> the kernel's instantiation
SHAPES = {(8, 64): 0, (1, 128): 1}
_TILE = 128            # the products' column tile (and the sum-of-squares partials)
_TK = 256              # the products' K tile
_CHUNK = 128           # cache columns of an attention item (at most)
_MAX_CHUNKS = 256      # attention chunks a slot may have


def _fn(name: str, argtypes):
    f = getattr(_build.library("megakernel"), name)
    if f.argtypes is None:
        f.argtypes, f.restype = argtypes, ctypes.c_int
    return f


def _card_shape_error(c: LlamaConfig, b: int, S: int, bk: int, dtype):
    """Why the CUDA kernel cannot take this shape, or None."""
    groups = c.num_attention_heads // c.kv_heads
    kv_dim = c.kv_heads * c.head_dim
    widths = (c.hidden_size + 2 * kv_dim, c.hidden_size, 2 * c.intermediate_size)
    if (groups, c.head_dim) not in SHAPES:
        return (f"{groups} query heads per kv head at head dim {c.head_dim} "
                f"(built for {' and '.join(f'{g} at {d}' for g, d in SHAPES)})")
    if (c.hidden_size % 256 or c.intermediate_size % 256 or any(n % _TILE for n in widths)
            or c.num_attention_heads * c.head_dim != c.hidden_size):
        return (f"H={c.hidden_size}, I={c.intermediate_size} (multiples of 256, H = heads x "
                f"head dim), projection widths {widths} (multiples of {_TILE})")
    if bk % 16 or S % 16 or S // math.gcd(_CHUNK, bk) > _MAX_CHUNKS:
        return (f"KV block {bk} and cache length {S} (multiples of 16, at most "
                f"{_MAX_CHUNKS} attention chunks of gcd({_CHUNK}, BK) columns)")
    if dtype not in _DTYPE_CODES:
        return f"{dtype} (bf16 or f32)"
    if not supported(c, b, S):
        return f"b={b}, max_len={S}, BK={bk}: outside supported()"
    return None


def card_takes(config: LlamaConfig, b: int, max_len: int, dtype) -> bool:
    """Whether the CUDA kernel takes this configuration: ``supported`` and
    the shapes the kernel is built for, decided before any launch.
    ``model._forward`` sends a step on the card to ``decode_step`` only
    then, and to the scan path otherwise."""
    return _card_shape_error(config, b, max_len, pick_bk(config, b, max_len), dtype) is None


_PROJ = ("qkv", "o", "gateup", "down")


def _k_contiguous(q: torch.Tensor) -> torch.Tensor:
    """``[L, K(/2), N]`` -> ``[L, N / 128, K / 256, 128, 256 (/2)]``: the
    kernel's tiles (128 output columns x 256 K values, as int8, or packed
    nibble pairs at W4), each tile's rows K-contiguous and each tile
    contiguous, in the order a block streams them."""
    L, kp, n = q.shape
    rb = _TK // 2 if q.dtype == torch.uint8 else _TK
    if n % _TILE or kp % rb:
        raise ValueError(f"weights [L, {kp}, {n}] are off the kernel's tile grid "
                         f"({_TILE} output columns x {_TK} K values)")
    t = q.transpose(1, 2).reshape(L, n // _TILE, _TILE, kp // rb, rb)
    return t.permute(0, 1, 3, 2, 4).contiguous()


def untile(t: torch.Tensor) -> torch.Tensor:
    """A ``card_weights`` tensor back to ``[L, N, K(/2)]``."""
    L, nt, kt, tn, rb = t.shape
    return t.permute(0, 1, 3, 2, 4).reshape(L, nt * tn, kt * rb)


_CARDS: Dict[int, Tuple[tuple, Dict[str, torch.Tensor]]] = {}


def card_weights(qparams: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """The K-contiguous copy of every projection's integers that the CUDA
    kernel reads, by projection name, in its tiles (``_k_contiguous``).
    Made once and kept beside the params while their ``qkv`` integers live
    (a cache keyed on that tensor, dropped with it), next to the JAX-layout
    ``q`` that the scan path and the plain version read; made again for
    other layer tensors. ``InferenceEngine`` calls it when it takes the card
    path, so the memory (as much as the weights) is taken up front."""
    lay = qparams["layers"]
    anchor = lay["qkv"]["q"]
    key = tuple((n, lay[n]["q"].data_ptr(), tuple(lay[n]["q"].shape)) for n in _PROJ)
    held = _CARDS.get(id(anchor))
    if held is None or held[0] != key:
        held = (key, {n: _k_contiguous(lay[n]["q"]) for n in _PROJ})
        if id(anchor) not in _CARDS:
            weakref.finalize(anchor, _CARDS.pop, id(anchor), None)
        _CARDS[id(anchor)] = held
    return held[1]


STAGES = ("norm", "qkv", "scores", "softmax.v", "finish", "o+resid", "norm", "gateup",
          "silu", "down+resid")    # what runs before each of a layer's barriers


def n_stamps(L: int) -> int:
    """Entries of ``decode_layers``' ``stamps``: the start, the first
    residual stage, then ``STAGES`` for each layer."""
    return 2 + len(STAGES) * L


def decode_layers(x, qcos, qsin, kcos, ksin, lay, cache, lens, active,
                  config: LlamaConfig, bk: int, dtype, stamps=None, card=None, arrive=None):
    """All L layers of one decode step: the CUDA kernel for tensors on a
    GPU (one launch), the plain version for tensors on the CPU. Arguments
    and results as ``decode_layers_plain``; ``card``: ``card_weights`` of the
    params (made here from ``lay`` when not given). ``stamps``: an int64
    CUDA tensor of ``n_stamps(L)`` entries to receive the device clock (ns)
    at the start and after every grid barrier, stage by stage as
    ``STAGES`` names them; ``arrive``: one of ``n_stamps(L) - 1`` rows of
    ``grid_size()`` entries, each block's clock as it arrives at each grid
    barrier."""
    if x.device.type == "cpu":
        return decode_layers_plain(x, qcos, qsin, kcos, ksin, lay, cache, lens,
                                   active, config, bk, dtype)
    c = config
    b, H = x.shape
    L, S = c.num_hidden_layers, cache["k_q"].shape[-1]
    why = _card_shape_error(c, b, S, bk, dtype)
    if why:
        raise NotImplementedError(
            f"megakernel.cu does not take {why}; serve this configuration "
            "with use_megakernel=False (the scan path)")
    if card is None:
        card = {n: _k_contiguous(lay[n]["q"]) for n in _PROJ}
    dev = x.device
    I, kvh, hd = c.intermediate_size, c.kv_heads, c.head_dim
    nh, kv_dim = c.num_attention_heads, kvh * hd
    dq = H + 2 * kv_dim
    packed, w4 = M.cache_is_packed(c), c.w_bits == 4
    wdt = torch.uint8 if w4 else torch.int8
    f32, i32, f64 = torch.float32, torch.int32, torch.float64
    ch = math.gcd(_CHUNK, bk)
    nc = S // ch

    def want(name, t, dt, shape):
        if (t.device != dev or t.dtype != dt or tuple(t.shape) != tuple(shape)
                or not t.is_contiguous()):
            raise ValueError(
                f"decode_layers: {name} is {t.dtype} {tuple(t.shape)} on {t.device}"
                f"{'' if t.is_contiguous() else ' (not contiguous)'}, expected "
                f"contiguous {dt} {tuple(shape)} on {dev}")
        return t

    gains = (lay["attn_norm"], lay["mlp_norm"])
    norm_round = dtype == torch.bfloat16 and all(g.dtype == torch.bfloat16 for g in gains)
    kdiv = 2 if w4 else 1
    rb = _TK // kdiv
    hdc = hd // 2 if packed else hd
    cdt = torch.uint8 if packed else torch.int8
    t = dict(
        x=want("x", x, dtype, (b, H)),
        qcos=want("qcos", qcos, f32, (b, hd // 2)), qsin=want("qsin", qsin, f32, (b, hd // 2)),
        kcos=want("kcos", kcos, f32, (hd // 2, S)), ksin=want("ksin", ksin, f32, (hd // 2, S)),
        qkv_s=want("qkv scales", lay["qkv"]["s"], f32, (L, 1, dq)),
        o_s=want("o scales", lay["o"]["s"], f32, (L, 1, H)),
        gu_s=want("gateup scales", lay["gateup"]["s"], f32, (L, 1, 2 * I)),
        dn_s=want("down scales", lay["down"]["s"], f32, (L, 1, H)),
        anorm=want("attn_norm", gains[0].float(), f32, (L, H)),
        mnorm=want("mlp_norm", gains[1].float(), f32, (L, H)),
        qkv_w=want("qkv weights", card["qkv"], wdt, (L, dq // _TILE, H // _TK, _TILE, rb)),
        o_w=want("o weights", card["o"], wdt, (L, H // _TILE, H // _TK, _TILE, rb)),
        gu_w=want("gateup weights", card["gateup"], wdt, (L, 2 * I // _TILE, H // _TK, _TILE, rb)),
        dn_w=want("down weights", card["down"], wdt, (L, H // _TILE, I // _TK, _TILE, rb)),
        kq=want("k_q", cache["k_q"], cdt, (L, b, kvh, hdc, S)),
        ks=want("k_s", cache["k_s"], f32, (L, b, S)),
        vq=want("v_q", cache["v_q"], cdt, (L, b, kvh, hdc, S)),
        vs=want("v_s", cache["v_s"], f32, (L, b, S)),
        lens=want("lens", lens.to(i32), i32, (b,)),
        active=want("active", active.to(i32), i32, (b,)),
        # outputs, then scratch (the kernel clears what it accumulates into)
        y=torch.empty((b, H), dtype=dtype, device=dev),
        kint=torch.empty((L, b, kv_dim), dtype=torch.int8, device=dev),
        vint=torch.empty((L, b, kv_dim), dtype=torch.int8, device=dev),
        kinv=torch.empty((L, b, 1), dtype=f32, device=dev),
        vinv=torch.empty((L, b, 1), dtype=f32, device=dev),
        xn=torch.empty((b, H), dtype=f32, device=dev),
        attn=torch.empty((b, H), dtype=dtype, device=dev),
        act=torch.empty((b, I), dtype=dtype, device=dev),
        acc_qkv=torch.empty((b, dq), dtype=i32, device=dev),
        acc_o=torch.empty((b, H), dtype=i32, device=dev),
        acc_gu=torch.empty((b, 2 * I), dtype=i32, device=dev),
        acc_dn=torch.empty((b, H), dtype=i32, device=dev),
        amax=torch.empty((4, b), dtype=i32, device=dev),
        kvmax=torch.empty((2, b), dtype=i32, device=dev),
        ss=torch.empty((b, H // _TILE), dtype=f64, device=dev),
        tcnt=torch.empty((H // _TILE,), dtype=i32, device=dev),
        scores=torch.empty((b, nh, S), dtype=f32, device=dev),
        cmax=torch.empty((b, nh, nc), dtype=f32, device=dev),
        ppart=torch.empty((b, nh, nc), dtype=f64, device=dev),
        pvpart=torch.empty((b, nh, nc, hd), dtype=f64, device=dev),
    )
    ptrs = {n: t[n].data_ptr() for n in t}
    ptrs["stamps"] = (None if stamps is None else
                      want("stamps", stamps, torch.int64, (n_stamps(L),)).data_ptr())
    ptrs["arrive"] = (None if arrive is None else
                      want("arrive", arrive, torch.int64,
                           (n_stamps(L) - 1, grid_size(dev))).data_ptr())
    p = _Params(
        **ptrs,
        L=L, b=b, H=H, I=I, kvh=kvh, S=S, BK=bk, CH=ch, w4=int(w4), packed=int(packed),
        rope=int(c.kv_cache_rope != "post"), norm_round=int(norm_round), smem=0,
        shape=SHAPES[(nh // kvh, hd)], eps=c.rms_norm_eps,
        a_qmax=float(2 ** (c.a_bits - 1) - 1),
        kv_qmax=float(2 ** (min(c.kv_bits, 8) - 1) - 1), scale=1.0 / (hd ** 0.5),
    )
    f = _fn("megakernel_decode", [ctypes.POINTER(_Params), ctypes.c_int, ctypes.c_void_p])
    err = f(ctypes.byref(p), _DTYPE_CODES[dtype], torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "megakernel_decode")
    decode_layers.launches += 1
    return t["y"], t["kint"], t["vint"], t["kinv"], t["vinv"]


decode_layers.launches = 0

def kernel_attributes() -> dict:
    """What the compiler gave each variant of the kernel, by name
    (``{dtype}_g{G}_d{hd}``): registers a thread, shared bytes (static,
    dynamic), local (spill) bytes a thread, threads a block and blocks an
    SM can hold. Launches nothing."""
    return {f"{dn}_g{g}_d{d}": _build.attributes("megakernel", "megakernel_attributes", code,
                                                 shape)
            for dn, code in (("f32", 0), ("bf16", 1)) for (g, d), shape in SHAPES.items()}


def grid_size(device=None) -> int:
    """Blocks of the kernel's cooperative grid: one per SM."""
    return torch.cuda.get_device_properties(resolve_device(device)).multi_processor_count


def grid_barriers(n: int, device=None) -> None:
    """Launch the kernel's grid (one block of 256 threads per SM) through
    ``n`` grid-wide barriers and nothing else: the yardstick for what the
    barriers of a decode step cost."""
    dev = resolve_device(device)
    f = _fn("megakernel_barriers", [ctypes.c_int, ctypes.c_void_p])
    _build.check(f(n, torch.cuda.current_stream(dev).cuda_stream), "megakernel_barriers")


# ---------------------------------------------------------------------------
# the decode step
# ---------------------------------------------------------------------------

def _cache_rope_tables(S: int, hd: int, theta: float, device):
    """cos/sin of every cache position, ``[hd/2, S]`` f32 (K's transposed
    layout)."""
    pos = torch.arange(S, dtype=torch.int32, device=device)[None]
    kcos, ksin = llama.rope_cos_sin(pos, hd, theta)
    return kcos[0, :, :hd // 2].T.contiguous(), ksin[0, :, :hd // 2].T.contiguous()


def _step(qparams, config: LlamaConfig, input_ids, seq_lens, active, cache,
          dtype, layers_fn):
    """The host side of a decode step around ``layers_fn``. Returns (logits,
    cache, final hidden [b, H] before the last norm)."""
    c = config
    b, s = input_ids.shape
    S, hd = cache["k_q"].shape[-1], c.head_dim
    packed = M.cache_is_packed(c)
    if s != 1:
        raise ValueError(f"decode_step takes one token per slot, got input_ids {(b, s)}")
    if (cache["k_q"].shape[3] != (hd // 2 if packed else hd)
            or cache["v_q"].shape != cache["k_q"].shape):
        raise ValueError(f"cache k_q {tuple(cache['k_q'].shape)} / v_q "
                         f"{tuple(cache['v_q'].shape)} do not fit head dim {hd}, "
                         f"packed={packed} (V shares K's transposed layout)")
    dev = input_ids.device
    bk = pick_bk(c, b, S)

    x = qparams["embed"][input_ids[:, 0].long()].to(dtype)
    qcos, qsin = llama.rope_cos_sin(seq_lens[:, None], hd, c.rope_theta)
    qcos = qcos[:, 0, :hd // 2].contiguous()                 # [b, hd/2] f32
    qsin = qsin[:, 0, :hd // 2].contiguous()
    kcos, ksin = _cache_rope_tables(S, hd, c.rope_theta, dev)

    card = (card_weights(qparams)
            if dev.type == "cuda" and layers_fn is not decode_layers_plain else None)
    y, k_ints, v_ints, k_invs, v_invs = layers_fn(
        x, qcos, qsin, kcos, ksin, qparams["layers"], cache, seq_lens, active,
        c, bk, dtype, card=card)

    # commit every layer's new column, IN PLACE; inactive slots write the
    # scratch position S - 1 (never validated)
    write_pos = torch.where(active, seq_lens, S - 1).to(torch.int32)
    kvh = c.kv_heads
    M.commit_kv_columns(
        cache["k_q"], cache["k_s"], cache["v_q"], cache["v_s"],
        k_ints.reshape(-1, b, kvh, hd), v_ints.reshape(-1, b, kvh, hd),
        k_invs, v_invs, write_pos, packed)
    logits = M.final_logits(y[:, None, :], qparams, c)
    new_len = torch.where(active, seq_lens + 1, seq_lens).to(torch.int32)
    return logits, dict(cache, lengths=new_len), y


def _entry(qparams, input_ids, seq_lens, active, cache, device):
    dev = resolve_device(device)
    check_on(dev, embed=qparams["embed"], k_q=cache["k_q"])
    return (M._as_tensor(input_ids, torch.int64, dev),
            M._as_tensor(seq_lens, torch.int32, dev),
            M._as_tensor(active, torch.bool, dev))


def decode_step(qparams: Dict[str, Any], config: LlamaConfig, input_ids, seq_lens,
                active, cache, dtype=torch.bfloat16, device=None):
    """One token per slot through the whole model on ``device`` (``cuda``
    unless ``device="cpu"``): the contract of ``model._forward`` at s = 1.
    ``input_ids`` [b, 1], ``seq_lens`` [b] (pre-append), ``active`` [b].
    Returns (logits [b, 1, V] f32, cache); the cache tensors are updated IN
    PLACE. On a GPU the layers run in the CUDA kernel, one launch."""
    ids, lens, act = _entry(qparams, input_ids, seq_lens, active, cache, device)
    return _step(qparams, config, ids, lens, act, cache, dtype, decode_layers)[:2]


def decode_step_plain(qparams: Dict[str, Any], config: LlamaConfig, input_ids,
                      seq_lens, active, cache, dtype=torch.bfloat16, device=None):
    """``decode_step`` with the plain PyTorch version of the kernel on
    either device: the kernel's reference."""
    ids, lens, act = _entry(qparams, input_ids, seq_lens, active, cache, device)
    return _step(qparams, config, ids, lens, act, cache, dtype, decode_layers_plain)[:2]
