"""Fused quantized-KV decode attention: one new token per slot against the
int8 or nibble-packed KV4 cache.

Three entry points of one device design (``csrc/decode_attn.cuh``: one
cooperative launch over every SM, items of (slot, chunk of columns, kv
head)), each beside its plain PyTorch version; a wrapper takes the plain
version only for tensors on the CPU, and on a CUDA tensor it launches its
kernel or raises. Each wrapper counts its launches in ``launches``. On the
card all three take (query heads per kv head, head dim) (8, 64) and
(1, 128), f32 or bf16 q, and at most 256 slots.

* ``quantized_decode_attention`` (``csrc/decode_attention.cu``, plain
  ``_decode_attention_plain``) replaces
  ``llm_qat_tpu/ops/pallas/decode_attention.py:_decode_attn_kernel``; any
  cache length that is a multiple of 8.
* ``quantized_decode_attention_stacked`` (the same source, entry point
  ``decode_attention_stacked``; plain ``_decode_attention_stacked_plain``)
  replaces ``llm_qat_tpu/ops/pallas/decode_attention.py:
  _decode_attn_stacked_kernel``: the same attention over layer ``layer`` of a
  stacked cache ``[L, b, kvh, hd, S]`` read in place, with its own fold
  contract (the current pair arrives as fake-quantized floats, K rotated).
* ``quantized_paged_attention`` (``csrc/paged_attention.cu``, plain
  ``_paged_attention_plain``) replaces
  ``llm_qat_tpu/ops/pallas/decode_attention.py:_paged_attn_kernel`` and
  ``_paged_attn_kernel_fold``: the same attention over a shared page pool
  ``[n_pages, kvh, hd(/2), P]`` through per-slot block tables (P = 128 on
  the card).

Layout (the JAX package's): K AND V are stored transposed, ``[b, kvh, hd, S]``
int8, or ``[b, kvh, hd/2, S]`` uint8 when packed (low nibble = head-dim rows
``0..hd/2-1``, high nibble = ``hd/2..hd-1``: the RoPE pair order); per-token
inverse scales ``[b, S]`` f32; hoisted RoPE tables ``[hd/2, S]`` f32.

Numerics contract: K/V quantized per token before RoPE; dequantize, then
RoPE by absolute cache position ("pre"), or no RoPE when the cache holds
rotated K ("post", ``rope=False``); fp32 softmax. With ``fold`` the current
token's (K, V) pair is one more softmax term and ``lengths`` are the
pre-append lengths (may be 0); inactive slots exclude the pair.

Both versions follow the TPU kernel's roundings: with a bf16 ``q`` they
round ``cos*ks``, ``sin*ks``, the rotated ``k`` and ``p*vs`` to bf16 before
the products; statistics and sums stay fp32. Both walk the TPU kernel's KV
blocks with an online softmax (``_walk_blocks``): the contiguous versions
``bk``-column blocks, ``bk`` as the JAX function picks it (``_pick_bk``:
1024 at TinyLlama's heads and S = 2048, 256 at LLaMA-7B's), the paged
version one page a block in table order. So ``p*vs`` rounds against the
RUNNING maximum ``m_j = max(m_{j-1}, rowmax(s_j))`` and ``l``, ``acc`` are
rescaled at every block, as in the TPU kernel; a slot skips the blocks at
or past its length. The plain versions take q.k, the sums of p and the p.V
products in float64 and round each once to fp32, as the kernels do, so the
two agree bit for bit but for float64 rounding noise.
"""

from __future__ import annotations

import math

import torch

from llm_qat_torch.ops import _build
from llm_qat_torch.ops import quant_matmul as QM

_NEG_INF = -1e30


def _halves(cq: torch.Tensor, packed: bool, dim: int):
    """(rows 0..hd/2-1, rows hd/2..hd-1) of a cache block along ``dim``, as
    int8 (packed: the low and the high nibbles, sign-extended)."""
    if packed:
        cq = QM.unpack_int4(cq, dim)
    h2 = cq.shape[dim] // 2
    return cq.narrow(dim, 0, h2), cq.narrow(dim, h2, h2)


def _rope_tables(S: int, hd: int, theta: float, device) -> tuple:
    """The kernel's in-kernel RoPE tables ``[hd/2, S]``, for calls without
    hoisted tables: ``inv_freq = exp(i * (-2/hd) * ln(theta))``."""
    pos = torch.arange(S, dtype=torch.float32, device=device)[None, :]
    i = torch.arange(hd // 2, dtype=torch.float32, device=device)[:, None]
    inv_freq = torch.exp(
        i * (-2.0 / hd) * torch.log(torch.full((), theta, dtype=torch.float32,
                                                device=device))
    )
    freqs = inv_freq * pos
    return torch.cos(freqs), torch.sin(freqs)


def _compute_type(q: torch.Tensor) -> torch.dtype:
    return torch.bfloat16 if q.dtype == torch.bfloat16 else torch.float32


def _dequant_rope_k(k_q, ks, cos, sin, ct, rope, packed):
    """K block ``[b, kvh, hd(/2), n]`` ints, ``ks`` broadcastable inverse
    scales, tables broadcastable ``[.., hd/2, n]`` -> dequantized (and, with
    ``rope``, rotated) K ``[b, kvh, hd, n]`` in ``ct``."""
    k1_i, k2_i = _halves(k_q, packed, 2)
    if rope:
        cc = (cos.float() * ks).to(ct)
        ss = (sin.float() * ks).to(ct)
        k1, k2 = k1_i.to(ct), k2_i.to(ct)
        return torch.cat([k1 * cc - k2 * ss, k2 * cc + k1 * ss], dim=2)
    sk = ks.to(ct)
    return torch.cat([k1_i.to(ct) * sk, k2_i.to(ct) * sk], dim=2)


def _pick_bk(S: int, kvh: int, hd: int, bk: int) -> int:
    """The JAX kernel's KV block for a cache of ``S`` columns (its
    ``_pick_bk``): ``bk`` capped so the block's f32 working set stays near
    4 MB, then lowered in steps of 8 to a divisor of ``S`` (8 at the least)."""
    cap = max(2 ** 20 // (kvh * hd), 8)
    bk = min(bk, cap, S)
    while S % bk or bk % 8:
        bk -= 8
        if bk <= 8:
            return 8
    return bk


def _walk_blocks(q, kvh, lens, n_blocks, width, block):
    """The TPU kernel's online softmax over KV blocks of ``width`` columns:
    block ``j`` holds logical positions ``j*width ..`` and a slot takes it
    while ``j*width < len``. ``block(j)`` gives the block's rotated K and V
    ``[b, kvh, hd, n]`` and V scales ``[b, 1, 1, n]`` in the compute type,
    and its logical positions ``[b or 1, n]``. Returns (m, l [b, kvh, g, 1],
    acc [b, kvh, g, hd]) in f32."""
    b, nh, hd = q.shape
    groups = nh // kvh
    ct = _compute_type(q)
    scale = 1.0 / (hd ** 0.5)
    dev = q.device
    qg = q.reshape(b, kvh, groups, hd).to(ct).double()
    m = torch.full((b, kvh, groups, 1), _NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros_like(m)
    acc = torch.zeros((b, kvh, groups, hd), dtype=torch.float32, device=dev)
    for j in range(n_blocks):
        live = lens > j * width                               # [b]
        if not bool(live.any()):
            break
        kr, v, vs, cols = block(j)
        s = torch.einsum("bhgd,bhds->bhgs", qg, kr.double()).float() * scale
        valid = (cols < lens[:, None])[:, None, None, :]
        s = torch.where(valid, s, torch.full_like(s, _NEG_INF))
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.where(valid, torch.exp(s - m_new), torch.zeros_like(s))
        l_new = l * alpha + p.double().sum(dim=-1, keepdim=True).float()
        acc_new = acc * alpha + torch.einsum(
            "bhgs,bhds->bhgd", (p * vs).to(ct).double(), v.double()).float()
        lv = live[:, None, None, None]
        m, l, acc = (torch.where(lv, m_new, m), torch.where(lv, l_new, l),
                     torch.where(lv, acc_new, acc))
    return m, l, acc


def _cache_softmax(q, k_q, k_s, v_q, v_s, lengths, k_cos, k_sin, theta, rope,
                   packed, bk):
    """The contiguous cache's softmax terms, ``bk``-column blocks as the JAX
    function picks them: (m, l [b, kvh, g, 1], acc [b, kvh, g, hd]) in f32.
    Its grid has ``S // bk`` blocks."""
    hd = q.shape[2]
    kvh, S = k_q.shape[1], k_q.shape[3]
    bk = _pick_bk(S, kvh, hd, bk)
    ct = _compute_type(q)
    if rope and k_cos is None:
        k_cos, k_sin = _rope_tables(S, hd, theta, q.device)

    def block(j):
        cs = slice(j * bk, (j + 1) * bk)
        cos = sin = None
        if rope:
            cos, sin = k_cos[:, cs], k_sin[:, cs]
        kr = _dequant_rope_k(k_q[..., cs], k_s[:, None, None, cs], cos, sin, ct,
                             rope, packed)
        v = torch.cat(_halves(v_q[..., cs], packed, 2), dim=2).to(ct)
        vs = v_s[:, cs].to(ct)[:, None, None, :]
        return kr, v, vs, torch.arange(j * bk, (j + 1) * bk, device=q.device)[None, :]

    return _walk_blocks(q, kvh, lengths.to(q.device).long(), S // bk, bk, block)


def _fold_quantized_pair(q, kvh, m, l, acc, fold, rope):
    """The current token's quantized (K, V) pair as one more online-softmax
    term (excluded for inactive slots); returns the new (l, acc)."""
    b, nh, hd = q.shape
    groups, h2 = nh // kvh, hd // 2
    ct = _compute_type(q)
    scale = 1.0 / (hd ** 0.5)
    k_new, k_inv, v_new, v_inv, active, q_cos, q_sin = fold
    kinv = k_inv.reshape(b, 1, 1).float()
    vinv = v_inv.reshape(b, 1, 1).to(ct)
    kn = k_new.reshape(b, kvh, hd)
    if rope:
        cc_i = (q_cos.reshape(b, 1, h2).float() * kinv).to(ct)
        ss_i = (q_sin.reshape(b, 1, h2).float() * kinv).to(ct)
        k1, k2 = kn[..., :h2].to(ct), kn[..., h2:].to(ct)
        k_fold = torch.cat([k1 * cc_i - k2 * ss_i, k2 * cc_i + k1 * ss_i],
                           dim=-1).float()                # [b, kvh, hd]
    else:
        k_fold = (kn.to(ct) * kinv.to(ct)).float()
    v_fold = (v_new.reshape(b, kvh, hd).to(ct) * vinv).float()
    s_cur = torch.einsum("bhgd,bhd->bhg", q.reshape(b, kvh, groups, hd)
                         .double(), k_fold.double()).float()[..., None] * scale
    inc = (active.to(q.device) != 0).reshape(b, 1, 1, 1)
    s_cur = torch.where(inc, s_cur, torch.full_like(s_cur, _NEG_INF))
    m_new = torch.maximum(m, s_cur)
    alpha = torch.exp(m - m_new)
    p_cur = torch.where(inc, torch.exp(s_cur - m_new), torch.zeros_like(s_cur))
    return l * alpha + p_cur, acc * alpha + p_cur * v_fold[:, :, None, :]


def _decode_attention_plain(q, k_q, k_s, v_q, v_s, lengths, k_cos=None,
                            k_sin=None, fold=None, *, theta=10000.0, bk=1024,
                            rope=True, packed=False):
    """Plain PyTorch version of the decode kernel (see module docstring)."""
    m, l, acc = _cache_softmax(q, k_q, k_s, v_q, v_s, lengths, k_cos, k_sin,
                               theta, rope, packed, bk)
    if fold is not None:
        l, acc = _fold_quantized_pair(q, k_q.shape[1], m, l, acc, fold, rope)
    out = acc / torch.clamp(l, min=1e-9)
    return out.reshape(q.shape).to(q.dtype)


def _decode_attention_stacked_plain(q, k_q_all, k_s_all, v_q_all, v_s_all,
                                    lengths, include_new, k_new, v_new,
                                    k_cos=None, k_sin=None, *, layer,
                                    theta=10000.0, bk=1024, rope=True):
    """Plain PyTorch version of the stacked decode kernel: the contiguous
    version's cache terms on layer ``layer``, then the stacked fold contract:
    ``k_new``/``v_new`` are floats (fake-quantized, K rotated), rounded to the
    compute type; ``include_new`` takes the place of ``active``; the pair's p
    is rounded to the compute type before p.v and, as in the TPU kernel, is
    not zeroed for an excluded pair (``exp(-1e30 - m)`` is 0 unless the slot
    is also empty, where the output is then ``v_new``)."""
    b, nh, hd = q.shape
    kvh = k_q_all.shape[2]
    groups = nh // kvh
    ct = _compute_type(q)
    scale = 1.0 / (hd ** 0.5)
    m, l, acc = _cache_softmax(q, k_q_all[layer], k_s_all[layer], v_q_all[layer],
                               v_s_all[layer], lengths, k_cos, k_sin, theta,
                               rope, False, bk)
    qg = q.reshape(b, kvh, groups, hd).to(ct).double()
    kn = k_new.reshape(b, kvh, hd).to(ct).double()
    vn = v_new.reshape(b, kvh, hd).to(ct).float()
    s = torch.einsum("bhgd,bhd->bhg", qg, kn).float()[..., None] * scale
    inc = (include_new.to(q.device) > 0).reshape(b, 1, 1, 1)
    s = torch.where(inc, s, torch.full_like(s, _NEG_INF))
    m_new = torch.maximum(m, s)
    alpha = torch.exp(m - m_new)
    p = torch.exp(s - m_new)
    l = l * alpha + p
    acc = acc * alpha + p.to(ct).float() * vn[:, :, None, :]
    out = acc / torch.clamp(l, min=1e-9)
    return out.reshape(b, nh, hd).to(q.dtype)


def _paged_attention_plain(q, k_q, k_s, v_q, v_s, lengths, block_tables,
                           k_cos=None, k_sin=None, fold=None, *,
                           theta=10000.0, rope=True, packed=False):
    """Plain PyTorch version of the paged kernel, any page size and any
    (groups, head dim): the online softmax one page a block, each slot's
    live pages in table order (see module docstring). Page ``pg`` of a slot
    holds logical positions ``pg*P .. pg*P+P-1``; a slot reads
    ``ceil(len/P)`` pages and never an entry of its table past them."""
    b, nh, hd = q.shape
    kvh, P = k_q.shape[1], k_q.shape[3]
    max_pages = block_tables.shape[1]
    ct = _compute_type(q)
    dev = q.device
    lens = lengths.to(dev).long()
    bt = block_tables.to(dev).long()
    if rope and k_cos is None:
        k_cos, k_sin = _rope_tables(max_pages * P, hd, theta, dev)
    last = torch.clamp((lens + P - 1) // P, min=1) - 1    # last live page

    def block(pg):
        # slots past their last page stand in with pool page 0 (never a dead
        # table entry, which may hold anything); their result is discarded
        lp = torch.clamp(last, max=pg)
        pid = torch.where(lens > pg * P, bt.gather(1, lp[:, None])[:, 0],
                          torch.zeros_like(lens))         # [b] pool page ids
        cols = lp[:, None] * P + torch.arange(P, device=dev)[None, :]  # [b, P]
        cos = sin = None
        if rope:
            cos = k_cos[:, cols].permute(1, 0, 2)[:, None]   # [b, 1, hd/2, P]
            sin = k_sin[:, cols].permute(1, 0, 2)[:, None]
        kr = _dequant_rope_k(k_q[pid], k_s[pid][:, None, None, :], cos, sin, ct,
                             rope, packed)
        v = torch.cat(_halves(v_q[pid], packed, 2), dim=2).to(ct)
        return kr, v, v_s[pid].to(ct)[:, None, None, :], cols

    m, l, acc = _walk_blocks(q, kvh, lens, max_pages, P, block)
    if fold is not None:
        l, acc = _fold_quantized_pair(q, kvh, m, l, acc, fold, rope)
    out = acc / torch.clamp(l, min=1e-9)
    return out.reshape(b, nh, hd).to(q.dtype)


_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# csrc/decode_attn.cuh: the (query heads per kv head, head dim) it is built
# for, its widest chunk, its most slots, and the page size of the paged entry
_SHAPES = ((8, 64), (1, 128))
_CHUNK = 128
_MAX_SLOTS = 256
_PAGED_P = 128


def _kernel_chunk(S: int, kvh: int, hd: int, bk: int) -> tuple:
    """(KV block, chunk width) of the card's contiguous kernel for a cache of
    ``S`` columns: the JAX picker's block and ``gcd(128, block)``, so a chunk
    never straddles a block."""
    bk = _pick_bk(S, kvh, hd, bk)
    return bk, math.gcd(_CHUNK, bk)


def _scratch(b: int, nh: int, n_chunks: int, ch: int, hd: int, dev) -> torch.Tensor:
    """The kernel's scratch (``decode_attn.cuh: carve``): per slot, query
    head and chunk, the float64 partial sums of p and of p.V over the head
    dim, the chunk's scores, maximum and its block's rescale factor."""
    return torch.empty(b * nh * n_chunks * (8 * (1 + hd) + 4 * (ch + 2)), dtype=torch.uint8,
                       device=dev)


def _contig(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``t`` as a contiguous ``dtype`` tensor whose data starts on a 16-byte
    boundary (the kernels read it in 16-byte pieces)."""
    t = t.to(dtype).contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _check_sizes(what: str, dev, want) -> None:
    """``want``: {name: (tensor, elements expected)}; all on ``dev``."""
    for name, (t, n) in want.items():
        if t.device != dev or t.numel() != n:
            raise ValueError(f"{what}: {name} has {t.numel()} elements on "
                             f"{t.device}, expected {n} on {dev}")


def _fold_operands(what, fold, b, kvh, hd, rope, dev):
    """The quantized fold pair as the kernels take it: seven contiguous
    tensors (None without a fold, and for the tables without RoPE)."""
    if fold is None:
        return [None] * 7
    k_new, k_inv, v_new, v_inv, active, q_cos, q_sin = fold
    fold_t = [
        _contig(k_new, torch.int8), _contig(k_inv, torch.float32),
        _contig(v_new, torch.int8), _contig(v_inv, torch.float32),
        _contig(active, torch.int32),
        _contig(q_cos, torch.float32) if rope else None,
        _contig(q_sin, torch.float32) if rope else None,
    ]
    want = dict(k_new=(fold_t[0], b * kvh * hd), k_inv=(fold_t[1], b),
                v_new=(fold_t[2], b * kvh * hd), v_inv=(fold_t[3], b),
                active=(fold_t[4], b))
    if rope:
        want.update(q_cos=(fold_t[5], b * (hd // 2)), q_sin=(fold_t[6], b * (hd // 2)))
    _check_sizes(what, dev, want)
    return fold_t


def _check_kernel_shape(what, q, groups, hd, b):
    """Raise unless ``(groups, hd)`` is one the kernels are built for, with
    an f32/bf16 q and at most 256 slots."""
    if (groups, hd) not in _SHAPES or q.dtype not in _DTYPE_CODES or b > _MAX_SLOTS:
        raise NotImplementedError(
            f"{what}: decode_attn.cuh is built for (query heads per kv head, head dim) in "
            f"{list(_SHAPES)}, f32/bf16 q, at most {_MAX_SLOTS} slots; got G={groups}, "
            f"hd={hd}, {q.dtype}, b={b}")


def _check_contiguous_kernel_shape(what, q, groups, hd, S, b=1):
    """``_check_kernel_shape`` for the contiguous cache: any length ``S``
    that is a multiple of 8 (the JAX picker's blocks then tile it)."""
    _check_kernel_shape(what, q, groups, hd, b)
    if S % 8:
        raise NotImplementedError(f"{what}: cache length S = {S} is not a multiple of 8")


def _ptr(t) -> int:
    return 0 if t is None else t.data_ptr()


def _launch(stem, fn, what, ptrs, ints, scale, dev):
    f = _build.bind(stem, fn, len(ptrs), len(ints), 1)
    err = f(*[_ptr(t) for t in ptrs], *ints, scale, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, what)


def kernel_attributes() -> dict:
    """What the compiler gave every variant of ``csrc/decode_attn.cuh`` (K3,
    K7, K8), by name ``decode_attention_g{G}_d{hd}_{bf16|f32}``: registers a
    thread, shared bytes (static, dynamic), local (spill) bytes a thread,
    threads a block and blocks an SM can hold. Launches nothing."""
    return {f"decode_attention_g{g}_d{hd}_{name}": _build.attributes(
                "decode_attention", "decode_attention_attributes", code, g, hd)
            for g, hd in _SHAPES for name, code in (("bf16", 1), ("f32", 0))}


def quantized_decode_attention(
    q: torch.Tensor,        # [b, nh, hd] post-RoPE query of the new token
    k_q: torch.Tensor,      # [b, kvh, hd(/2), S] int8 / packed uint8, transposed
    k_s: torch.Tensor,      # [b, S] f32 per-token inverse scales
    v_q: torch.Tensor,      # [b, kvh, hd(/2), S] (K's layout)
    v_s: torch.Tensor,      # [b, S] f32
    lengths: torch.Tensor,  # [b] int32: positions < length attend
    k_cos: torch.Tensor = None,  # [hd/2, S] f32 hoisted RoPE tables ("pre")
    k_sin: torch.Tensor = None,
    fold=None,              # (k_new [b,kvh,hd] i8, k_inv [b,1], v_new, v_inv,
                            #  active [b], q_cos [b,hd/2], q_sin [b,hd/2])
    *,
    theta: float = 10000.0,
    bk: int = 1024,         # the TPU kernel's KV block, through _pick_bk
    rope: bool = True,      # False => cache holds rotated K ("post")
    packed: bool = False,   # KV4 nibble-packed cache
) -> torch.Tensor:          # [b, nh, hd]
    b, nh, hd = q.shape
    kvh, S = k_q.shape[1], k_q.shape[3]
    groups = nh // kvh
    hdc = hd // 2 if packed else hd
    if nh != kvh * groups or k_q.shape[2] != hdc or v_q.shape != k_q.shape:
        raise ValueError(
            f"bad shapes q {tuple(q.shape)} k {tuple(k_q.shape)} v {tuple(v_q.shape)}"
        )
    if q.device.type == "cpu":
        return _decode_attention_plain(
            q, k_q, k_s, v_q, v_s, lengths, k_cos, k_sin, fold,
            theta=theta, bk=bk, rope=rope, packed=packed,
        )
    what = "quantized_decode_attention"
    if not q.is_cuda:
        raise ValueError(f"{what}: q on {q.device}")
    _check_contiguous_kernel_shape(what, q, groups, hd, S, b)
    dev = q.device
    blk, ch = _kernel_chunk(S, kvh, hd, bk)
    qc = _contig(q, q.dtype)
    kq = _contig(k_q.view(torch.uint8), torch.uint8)
    vq = _contig(v_q.view(torch.uint8), torch.uint8)
    ksc, vsc = _contig(k_s, torch.float32), _contig(v_s, torch.float32)
    lens = _contig(lengths, torch.int32)
    if rope and k_cos is None:
        k_cos, k_sin = _rope_tables(S, hd, theta, dev)
    kc = _contig(k_cos, torch.float32) if rope else None
    ksn = _contig(k_sin, torch.float32) if rope else None
    want = {"k_q": (kq, b * kvh * hdc * S), "v_q": (vq, b * kvh * hdc * S),
            "k_s": (ksc, b * S), "v_s": (vsc, b * S), "lengths": (lens, b)}
    if rope:
        want.update(k_cos=(kc, (hd // 2) * S), k_sin=(ksn, (hd // 2) * S))
    _check_sizes(what, dev, want)
    fold_t = _fold_operands(what, fold, b, kvh, hd, rope, dev)
    out = torch.empty_like(qc)
    ptrs = [qc, kq, ksc, vq, vsc, lens, None, kc, ksn, *fold_t, out,
            _scratch(b, nh, S // ch, ch, hd, dev)]
    _launch("decode_attention", "decode_attention", what, ptrs,
            [b, kvh, groups, hd, S, ch, blk, S // ch, S, int(packed), int(rope),
             int(fold is not None), _DTYPE_CODES[q.dtype]], 1.0 / math.sqrt(hd), dev)
    quantized_decode_attention.launches += 1
    return out


quantized_decode_attention.launches = 0


def quantized_decode_attention_stacked(
    q: torch.Tensor,            # [b, nh, hd] post-RoPE query of the new token
    k_q_all: torch.Tensor,      # [L, b, kvh, hd, S] int8: the WHOLE stacked cache
    k_s_all: torch.Tensor,      # [L, b, S] f32
    v_q_all: torch.Tensor,      # [L, b, kvh, hd, S] int8 (K's layout)
    v_s_all: torch.Tensor,      # [L, b, S] f32
    lengths: torch.Tensor,      # [b] int32: valid OLD rows (current token excluded)
    include_new: torch.Tensor,  # [b] int32: fold the current token's pair?
    k_new: torch.Tensor,        # [b, kvh, hd] current K: fake-quantized, rotated
    v_new: torch.Tensor,        # [b, kvh, hd] current V: fake-quantized
    k_cos: torch.Tensor = None,  # [hd/2, S] hoisted RoPE tables ("pre")
    k_sin: torch.Tensor = None,
    *,
    layer: int,
    theta: float = 10000.0,
    bk: int = 1024,             # the TPU kernel's KV block, through _pick_bk
    rope: bool = True,
) -> torch.Tensor:              # [b, nh, hd]
    """``quantized_decode_attention`` over layer ``layer`` of the stacked
    cache, read in place (the kernel gets the layer index and offsets its
    own base pointers: no slice is copied). The cache is read-only; the
    current token's K/V enter as one more softmax pair (see
    ``_decode_attention_stacked_plain`` for the pair's contract)."""
    b, nh, hd = q.shape
    L, _, kvh, _, S = k_q_all.shape
    groups = nh // kvh
    if (nh != kvh * groups or k_q_all.shape[3] != hd
            or v_q_all.shape != k_q_all.shape or not 0 <= layer < L):
        raise ValueError(f"bad shapes q {tuple(q.shape)} k {tuple(k_q_all.shape)} "
                         f"v {tuple(v_q_all.shape)} layer {layer}")
    if q.device.type == "cpu":
        return _decode_attention_stacked_plain(
            q, k_q_all, k_s_all, v_q_all, v_s_all, lengths, include_new, k_new,
            v_new, k_cos, k_sin, layer=layer, theta=theta, bk=bk, rope=rope,
        )
    what = "quantized_decode_attention_stacked"
    if not q.is_cuda:
        raise ValueError(f"{what}: q on {q.device}")
    _check_contiguous_kernel_shape(what, q, groups, hd, S, b)
    dev = q.device
    for name, t, dt in (("k_q_all", k_q_all, torch.int8), ("v_q_all", v_q_all, torch.int8),
                        ("k_s_all", k_s_all, torch.float32),
                        ("v_s_all", v_s_all, torch.float32)):
        # no copy here: a copy of the stack is what this entry avoids
        if (t.dtype != dt or not t.is_contiguous() or t.device != dev
                or t.data_ptr() % 16):
            raise ValueError(f"{what}: {name} must be a contiguous {dt} tensor on {dev}, "
                             "16-byte aligned")
    blk, ch = _kernel_chunk(S, kvh, hd, bk)
    qc = _contig(q, q.dtype)
    lens = _contig(lengths, torch.int32)
    inc = _contig(include_new, torch.int32)
    kn, vn = _contig(k_new, q.dtype), _contig(v_new, q.dtype)
    if rope and k_cos is None:
        k_cos, k_sin = _rope_tables(S, hd, theta, dev)
    kc = _contig(k_cos, torch.float32) if rope else None
    ksn = _contig(k_sin, torch.float32) if rope else None
    want = {"k_s_all": (k_s_all, L * b * S), "v_s_all": (v_s_all, L * b * S),
            "lengths": (lens, b), "include_new": (inc, b),
            "k_new": (kn, b * kvh * hd), "v_new": (vn, b * kvh * hd)}
    if rope:
        want.update(k_cos=(kc, (hd // 2) * S), k_sin=(ksn, (hd // 2) * S))
    _check_sizes(what, dev, want)
    out = torch.empty_like(qc)
    ptrs = [qc, k_q_all, k_s_all, v_q_all, v_s_all, lens, kc, ksn, kn, vn, inc, out,
            _scratch(b, nh, S // ch, ch, hd, dev)]
    _launch("decode_attention", "decode_attention_stacked", what, ptrs,
            [b, kvh, groups, hd, S, ch, blk, layer, int(rope), _DTYPE_CODES[q.dtype]],
            1.0 / math.sqrt(hd), dev)
    quantized_decode_attention_stacked.launches += 1
    return out


quantized_decode_attention_stacked.launches = 0


def quantized_paged_attention(
    q: torch.Tensor,             # [b, nh, hd] post-RoPE query
    k_q: torch.Tensor,           # [n_pages, kvh, hd(/2), P] int8 / packed uint8
    k_s: torch.Tensor,           # [n_pages, P] f32 per-token inverse scales
    v_q: torch.Tensor,           # [n_pages, kvh, hd(/2), P] (K's layout)
    v_s: torch.Tensor,           # [n_pages, P] f32
    lengths: torch.Tensor,       # [b] int32
    block_tables: torch.Tensor,  # [b, max_pages] int32: logical page -> pool id
    k_cos: torch.Tensor = None,  # [hd/2, max_pages*P] f32 hoisted RoPE tables
    k_sin: torch.Tensor = None,  # at LOGICAL positions; None => built here
    fold=None,                   # as quantized_decode_attention; with fold,
                                 # ``lengths`` are PRE-append and the pool is
                                 # read-only
    *,
    theta: float = 10000.0,
    rope: bool = True,
    packed: bool = False,        # KV4 nibble-packed pool
) -> torch.Tensor:               # [b, nh, hd]
    """Decode attention over the shared page pool: each slot walks
    ``ceil(len/P)`` pages of its block table in order (logical position of
    page ``pg`` row ``j`` is ``pg*P + j``) and masks the tail of the last;
    table entries past a slot's live pages are never read."""
    b, nh, hd = q.shape
    n_pages, kvh, _, P = k_q.shape
    max_pages = block_tables.shape[1]
    groups = nh // kvh
    hdc = hd // 2 if packed else hd
    if nh != kvh * groups or k_q.shape[2] != hdc or v_q.shape != k_q.shape:
        raise ValueError(
            f"bad shapes q {tuple(q.shape)} k {tuple(k_q.shape)} v {tuple(v_q.shape)}"
        )
    if q.device.type == "cpu":
        return _paged_attention_plain(
            q, k_q, k_s, v_q, v_s, lengths, block_tables, k_cos, k_sin, fold,
            theta=theta, rope=rope, packed=packed,
        )
    what = "quantized_paged_attention"
    if not q.is_cuda:
        raise ValueError(f"{what}: q on {q.device}")
    _check_kernel_shape(what, q, groups, hd, b)
    if P != _PAGED_P:
        raise NotImplementedError(f"{what}: paged_attention.cu is built for page size "
                                  f"{_PAGED_P}; got P={P}")
    dev = q.device
    for name, t, dts in (("k_q", k_q, (torch.int8, torch.uint8)),
                         ("v_q", v_q, (torch.int8, torch.uint8)),
                         ("k_s", k_s, (torch.float32,)), ("v_s", v_s, (torch.float32,))):
        # the pool is shared by every slot and layer call: never copied here
        if t.dtype not in dts or not t.is_contiguous() or t.device != dev or t.data_ptr() % 16:
            raise ValueError(f"{what}: {name} must be a contiguous tensor of "
                             f"{dts} on {dev}, 16-byte aligned")
    qc = _contig(q, q.dtype)
    lens = _contig(lengths, torch.int32)
    bt = _contig(block_tables, torch.int32)
    if rope and k_cos is None:
        k_cos, k_sin = _rope_tables(max_pages * P, hd, theta, dev)
    kc = _contig(k_cos, torch.float32) if rope else None
    ksn = _contig(k_sin, torch.float32) if rope else None
    want = {"k_s": (k_s, n_pages * P), "v_s": (v_s, n_pages * P),
            "lengths": (lens, b), "block_tables": (bt, b * max_pages)}
    if rope:
        want.update(k_cos=(kc, (hd // 2) * max_pages * P),
                    k_sin=(ksn, (hd // 2) * max_pages * P))
    _check_sizes(what, dev, want)
    fold_t = _fold_operands(what, fold, b, kvh, hd, rope, dev)
    out = torch.empty_like(qc)
    ptrs = [qc, k_q, k_s, v_q, v_s, lens, bt, kc, ksn, *fold_t, out,
            _scratch(b, nh, max_pages, P, hd, dev)]
    _launch("paged_attention", "paged_attention", what, ptrs,
            [b, kvh, groups, hd, P, P, P, max_pages, max_pages * P, int(packed), int(rope),
             int(fold is not None), _DTYPE_CODES[q.dtype]], 1.0 / math.sqrt(hd), dev)
    quantized_paged_attention.launches += 1
    return out


quantized_paged_attention.launches = 0


def decode_attention_reference(q, k_q, k_s, v_q, v_s, lengths, *,
                               theta: float = 10000.0) -> torch.Tensor:
    """Plain f32 oracle with identical semantics, for tests. Takes the
    UNtransposed K/V layout ``[b, kvh, S, hd]``."""
    b, nh, hd = q.shape
    kvh, S = k_q.shape[1], k_q.shape[2]
    groups = nh // kvh
    kd = k_q.float() * k_s[:, None, :, None]
    vd = v_q.float() * v_s[:, None, :, None]
    pos = torch.arange(S, dtype=torch.float32, device=q.device)
    inv_freq = 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                             device=q.device) / hd))
    freqs = pos[:, None] * inv_freq[None, :]
    cos = torch.cat([torch.cos(freqs)] * 2, dim=-1)
    sin = torch.cat([torch.sin(freqs)] * 2, dim=-1)
    k1, k2 = kd[..., : hd // 2], kd[..., hd // 2:]
    rot = torch.cat([-k2, k1], dim=-1)
    kd = kd * cos[None, None] + rot * sin[None, None]
    qg = q.reshape(b, kvh, groups, hd).float()
    s = torch.einsum("bhgd,bhsd->bhgs", qg, kd) / (hd ** 0.5)
    valid = torch.arange(S, device=q.device)[None, :] < lengths[:, None]
    s = torch.where(valid[:, None, None, :], s, torch.full_like(s, _NEG_INF))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgs,bhsd->bhgd", p, vd)
    return out.reshape(b, nh, hd).to(q.dtype)
