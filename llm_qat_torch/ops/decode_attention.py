"""Fused quantized-KV decode attention: one new token per slot against the
int8 or nibble-packed KV4 cache.

``quantized_decode_attention`` launches ``csrc/decode_attention.cu``, which
replaces ``llm_qat_tpu/ops/pallas/decode_attention.py:_decode_attn_kernel``.
Beside it, ``_decode_attention_plain`` computes the same function in plain
PyTorch; the wrapper takes it only for tensors on the CPU.

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
the products; statistics and sums stay fp32.
"""

from __future__ import annotations

import math

import torch

from llm_qat_torch.ops import _build
from llm_qat_torch.ops import quant_matmul as QM

_NEG_INF = -1e30
_MAX_S = 4096   # the kernel's G * S f32 scores in shared memory (128 KiB)


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


def _decode_attention_plain(q, k_q, k_s, v_q, v_s, lengths, k_cos=None,
                            k_sin=None, fold=None, *, theta=10000.0,
                            rope=True, packed=False):
    """Plain PyTorch version of the decode kernel (see module docstring)."""
    b, nh, hd = q.shape
    kvh, S = k_q.shape[1], k_q.shape[3]
    groups = nh // kvh
    h2 = hd // 2
    ct = torch.bfloat16 if q.dtype == torch.bfloat16 else torch.float32
    scale = 1.0 / (hd ** 0.5)

    ks = k_s[:, None, None, :]                            # [b, 1, 1, S]
    k1_i, k2_i = _halves(k_q, packed, 2)                  # [b, kvh, h2, S]
    if rope:
        if k_cos is None:
            k_cos, k_sin = _rope_tables(S, hd, theta, q.device)
        cc = (k_cos.float() * ks).to(ct)                  # [b, 1, h2, S]
        ss = (k_sin.float() * ks).to(ct)
        k1, k2 = k1_i.to(ct), k2_i.to(ct)
        kr = torch.cat([k1 * cc - k2 * ss, k2 * cc + k1 * ss], dim=2)
    else:
        sk = ks.to(ct)
        kr = torch.cat([k1_i.to(ct) * sk, k2_i.to(ct) * sk], dim=2)
    v = torch.cat(_halves(v_q, packed, 2), dim=2).to(ct)  # [b, kvh, hd, S]
    vs = v_s.to(ct)[:, None, None, :]                     # [b, 1, 1, S]

    qg = q.reshape(b, kvh, groups, hd).to(ct)
    s = torch.einsum("bhgd,bhds->bhgs", qg.float(), kr.float()) * scale
    valid = (torch.arange(S, device=q.device)[None, :]
             < lengths.to(q.device)[:, None])[:, None, None, :]
    s = torch.where(valid, s, torch.full_like(s, _NEG_INF))
    m = s.amax(dim=-1, keepdim=True)                      # [b, kvh, g, 1]
    p = torch.where(valid, torch.exp(s - m), torch.zeros_like(s))
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.einsum("bhgs,bhds->bhgd", (p * vs).to(ct).float(), v.float())

    if fold is not None:
        k_new, k_inv, v_new, v_inv, active, q_cos, q_sin = fold
        kinv = k_inv.reshape(b, 1, 1).float()
        vinv = v_inv.reshape(b, 1, 1).to(ct)
        kn = k_new.reshape(b, kvh, hd)
        if rope:
            cc_i = (q_cos.reshape(b, 1, h2).float() * kinv).to(ct)
            ss_i = (q_sin.reshape(b, 1, h2).float() * kinv).to(ct)
            k1, k2 = kn[..., :h2].to(ct), kn[..., h2:].to(ct)
            k_fold = torch.cat([k1 * cc_i - k2 * ss_i, k2 * cc_i + k1 * ss_i],
                               dim=-1).float()            # [b, kvh, hd]
        else:
            k_fold = (kn.to(ct) * kinv.to(ct)).float()
        v_fold = (v_new.reshape(b, kvh, hd).to(ct) * vinv).float()
        s_cur = torch.einsum("bhgd,bhd->bhg", q.reshape(b, kvh, groups, hd)
                             .float(), k_fold)[..., None] * scale
        inc = (active.to(q.device) != 0).reshape(b, 1, 1, 1)
        s_cur = torch.where(inc, s_cur, torch.full_like(s_cur, _NEG_INF))
        m_new = torch.maximum(m, s_cur)
        alpha = torch.exp(m - m_new)
        p_cur = torch.where(inc, torch.exp(s_cur - m_new),
                            torch.zeros_like(s_cur))
        l = l * alpha + p_cur
        acc = acc * alpha + p_cur * v_fold[:, :, None, :]
    out = acc / torch.clamp(l, min=1e-9)
    return out.reshape(b, nh, hd).to(q.dtype)


_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _contig(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return t.to(dtype).contiguous()


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
            theta=theta, rope=rope, packed=packed,
        )
    if not q.is_cuda:
        raise ValueError(f"quantized_decode_attention: q on {q.device}")
    if (groups, hd) != (8, 64) or q.dtype not in _DTYPE_CODES:
        raise NotImplementedError(
            "decode_attention.cu is built for 8 query heads per kv head, "
            f"head dim 64, f32/bf16 q; got G={groups}, hd={hd}, {q.dtype}"
        )
    if S > _MAX_S:
        raise NotImplementedError(
            f"decode_attention.cu keeps a slot's scores in shared memory: "
            f"cache length S <= {_MAX_S}, got {S}"
        )
    dev = q.device
    qc = q.contiguous()
    kq = k_q.contiguous().view(torch.uint8)
    vq = v_q.contiguous().view(torch.uint8)
    ksc, vsc = _contig(k_s, torch.float32), _contig(v_s, torch.float32)
    lens = _contig(lengths, torch.int32)
    if rope and k_cos is None:
        k_cos, k_sin = _rope_tables(S, hd, theta, dev)
    dummy = torch.zeros(1, dtype=torch.float32, device=dev)
    kc = _contig(k_cos, torch.float32) if rope else dummy
    ksn = _contig(k_sin, torch.float32) if rope else dummy
    if fold is not None:
        k_new, k_inv, v_new, v_inv, active, q_cos, q_sin = fold
        fold_t = [
            _contig(k_new, torch.int8), _contig(k_inv, torch.float32),
            _contig(v_new, torch.int8), _contig(v_inv, torch.float32),
            _contig(active, torch.int32),
            _contig(q_cos, torch.float32) if rope else dummy,
            _contig(q_sin, torch.float32) if rope else dummy,
        ]
    else:
        zi8 = torch.zeros(1, dtype=torch.int8, device=dev)
        zi32 = torch.zeros(1, dtype=torch.int32, device=dev)
        fold_t = [zi8, dummy, zi8, dummy, zi32, dummy, dummy]
    h2 = hd // 2
    want = {"k_q": (kq, b * kvh * hdc * S), "v_q": (vq, b * kvh * hdc * S),
            "k_s": (ksc, b * S), "v_s": (vsc, b * S), "lengths": (lens, b)}
    if rope:
        want.update(k_cos=(kc, h2 * S), k_sin=(ksn, h2 * S))
    if fold is not None:
        want.update(k_new=(fold_t[0], b * kvh * hd), k_inv=(fold_t[1], b),
                    v_new=(fold_t[2], b * kvh * hd), v_inv=(fold_t[3], b),
                    active=(fold_t[4], b))
        if rope:
            want.update(q_cos=(fold_t[5], b * h2), q_sin=(fold_t[6], b * h2))
    for name, (t, n) in want.items():
        if t.device != dev or t.numel() != n:
            raise ValueError(f"quantized_decode_attention: {name} has "
                             f"{t.numel()} elements on {t.device}, expected {n} on {dev}")
    out = torch.empty_like(qc)
    f = _build.bind("decode_attention", "decode_attention", 16, 7, 1)
    ptrs = [qc, kq, ksc, vq, vsc, lens, kc, ksn, *fold_t, out]
    err = f(*[t.data_ptr() for t in ptrs], b, kvh, S, int(packed), int(rope),
            int(fold is not None), _DTYPE_CODES[q.dtype], 1.0 / math.sqrt(hd),
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "decode_attention")
    quantized_decode_attention.launches += 1
    return out


quantized_decode_attention.launches = 0


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
