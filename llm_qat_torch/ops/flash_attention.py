"""Blockwise (flash) causal attention, forward and backward.

``_flash_fwd`` launches ``csrc/flash_attention.cu``, which replaces
``llm_qat_tpu/ops/pallas/flash_attention.py:_flash_fwd_kernel``;
``_flash_bwd_dq`` and ``_flash_bwd_dkv`` launch ``csrc/flash_attention_bwd.cu``,
which replaces ``_flash_bwd_dq_kernel`` and ``_flash_bwd_dkv_kernel`` of the
same file. Beside each its plain PyTorch version (``_flash_fwd_plain``,
``_flash_bwd_dq_plain``, ``_flash_bwd_dkv_plain``; ``_flash_bwd_plain`` is the
pair); a wrapper takes it only for tensors on the CPU.
``flash_attention_gqa`` joins them as a ``torch.autograd.Function``: the
forward saves O and the log-sum-exp, the backward is the kernel pair.

Layout (the JAX package's): q ``[B, G, S, D]`` with ``B = batch*kv_heads`` and
``G`` the GQA group size, k/v ``[B, S, D]`` (never repeated), ``lengths``
``[B]`` int32 masking columns ``>= max(length, 1)``. Base-2 softmax in fp32;
p is rounded to V's type before the p.V product; ``soft_bf16`` evaluates
exp2 on bf16 operands (``config.flash_softmax_bf16``; the forward only).
Returns O and the per-row log-sum-exp in nats, ``[B, G, 1, S]``.

Block structure: the TPU forward walks 1024-key blocks with an online
softmax, so beyond 1024 keys it rounds a block's p against the running
maximum and rescales. The port's kernel and plain version take p against the
row's final maximum at every length. The two agree to the order of fp32 sums
in float32 and within a bf16 step of O in bf16; the log-sum-exp, which the
backward consumes, agrees to 1e-5 (``tests/test_torch_flash_backward.py``
holds S = 2048 against the JAX kernel).
"""

from __future__ import annotations

import math

import torch

from llm_qat_torch.ops import _build

_NEG_INF = -1e30
_LOG2E = 1.4426950408889634  # log2(e)
_LN2 = 0.6931471805599453    # ln(2)


def _exp2(x: torch.Tensor) -> torch.Tensor:
    """``jnp.exp2`` as JAX defines it: ``exp(ln2 * x)`` in x's type (for
    bf16, ln2 and the product round to bf16 first)."""
    return torch.exp(x * torch.full((), _LN2, dtype=x.dtype, device=x.device))


def _flash_fwd_plain(q, k, v, lengths, causal: bool = True,
                     soft_bf16: bool = False):
    """Plain PyTorch version of the flash forward kernel: the whole masked
    score matrix at once, p against each row's final maximum. Up to 1024 keys
    the TPU kernel's default block holds the whole row and this is its
    arithmetic step for step; beyond, see the module docstring."""
    B, G, S, D = q.shape
    scale = 1.0 / (D ** 0.5)
    s = (scale * _LOG2E) * torch.einsum("bgqd,bkd->bgqk", q.float(), k.float())
    col = torch.arange(S, device=q.device)
    ok = (col[None, :] < torch.clamp(lengths.to(q.device), min=1)[:, None])
    ok = ok[:, None, None, :]                                  # [B, 1, 1, S]
    if causal:
        ok = ok & (col[None, :] <= col[:, None])[None, None]
    s = torch.where(ok, s, torch.full_like(s, _NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    if soft_bf16:
        p16 = _exp2((s - m).to(torch.bfloat16))
        p, pv = p16.float(), p16.to(v.dtype)
    else:
        p = _exp2(s - m)
        pv = p.to(v.dtype)
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.einsum("bgqk,bkd->bgqd", pv.float(), v.float())
    o = (acc / l).to(q.dtype)
    lse = (m * _LN2 + torch.log(l))[..., 0][:, :, None, :]
    return o, lse


_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _flash_fwd(q, k, v, lengths, causal: bool = True, soft_bf16: bool = False):
    """q: [B, G, S, D]; k/v: [B, S, D]; lengths [B] (causal within each S).
    Returns ([B, G, S, D], lse [B, G, 1, S]). The JAX version's block sizes
    (and its ``_fit_block``) have no counterpart: the CUDA kernel tiles by
    fixed blocks and masks the ragged edge."""
    B, G, S, D = q.shape
    if k.shape != (B, S, D) or v.shape != (B, S, D):
        raise ValueError(f"bad shapes q {tuple(q.shape)} k {tuple(k.shape)}")
    if q.device.type == "cpu":
        return _flash_fwd_plain(q, k, v, lengths, causal, soft_bf16)
    if not q.is_cuda:
        raise ValueError(f"_flash_fwd: q on {q.device}")
    if D != 64 or q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise NotImplementedError(
            f"flash_attention.cu is built for head dim 64 in f32/bf16; got "
            f"D={D}, {q.dtype}/{k.dtype}/{v.dtype}"
        )
    qc, kc, vc = q.contiguous(), k.contiguous(), v.contiguous()
    lens = lengths.to(device=q.device, dtype=torch.int32).contiguous()
    if lens.numel() != B:
        raise ValueError(f"_flash_fwd: {lens.numel()} lengths for B={B}")
    o = torch.empty_like(qc)
    lse = torch.empty((B, G, 1, S), dtype=torch.float32, device=q.device)
    f = _build.bind("flash_attention", "flash_fwd", 6, 6, 1)
    err = f(qc.data_ptr(), kc.data_ptr(), vc.data_ptr(), lens.data_ptr(),
            o.data_ptr(), lse.data_ptr(), B, G, S, int(causal), int(soft_bf16),
            _DTYPE_CODES[q.dtype], float(_LOG2E / math.sqrt(D)),
            torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "flash_fwd")
    _flash_fwd.launches += 1
    return o, lse


_flash_fwd.launches = 0


# ---------------------------------------------------------------------------
# backward
# ---------------------------------------------------------------------------


def _bwd_p_ds(q, k, v, lengths, lse, delta, do, causal):
    """p recomputed from the saved log-sum-exp in base 2 and
    ``p * (dO.V - delta)``, both fp32 ``[B, G, S, S]``: what the two backward
    kernels share."""
    B, G, S, D = q.shape
    scale = 1.0 / (D ** 0.5)
    s2 = (scale * _LOG2E) * torch.einsum("bgqd,bkd->bgqk", q.float(), k.float())
    col = torch.arange(S, device=q.device)
    ok = (col[None, :] < torch.clamp(lengths.to(q.device), min=1)[:, None])
    ok = ok[:, None, None, :]
    if causal:
        ok = ok & (col[None, :] <= col[:, None])[None, None]
    s2 = torch.where(ok, s2, torch.full_like(s2, _NEG_INF))
    lse2 = lse.reshape(B, G, S, 1) * _LOG2E
    p = _exp2(s2 - lse2)
    dp = torch.einsum("bgqd,bkd->bgqk", do.float(), v.float())
    return p, p * (dp - delta.reshape(B, G, S, 1))


def _flash_bwd_dq_plain(q, k, v, lengths, lse, delta, do, causal: bool = True):
    """Plain PyTorch version of the dQ kernel: ``ds`` rounds to K's type
    before the product, fp32 accumulation, ``scale *`` at the end."""
    _, ds = _bwd_p_ds(q, k, v, lengths, lse, delta, do, causal)
    scale = 1.0 / (q.shape[-1] ** 0.5)
    dq = torch.einsum("bgqk,bkd->bgqd", ds.to(k.dtype).float(), k.float())
    return (scale * dq).to(q.dtype)


def _flash_bwd_dkv_plain(q, k, v, lengths, lse, delta, do, causal: bool = True):
    """Plain PyTorch version of the dK/dV kernel: p rounds to dO's type and
    ``ds`` to Q's before the products, summed over the G query heads."""
    p, ds = _bwd_p_ds(q, k, v, lengths, lse, delta, do, causal)
    scale = 1.0 / (q.shape[-1] ** 0.5)
    dv = torch.einsum("bgqk,bgqd->bkd", p.to(do.dtype).float(), do.float())
    dk = torch.einsum("bgqk,bgqd->bkd", ds.to(q.dtype).float(), q.float())
    return (scale * dk).to(k.dtype), dv.to(v.dtype)


def _delta(o, do):
    """``rowsum(dO * O)`` in fp32, ``[B, G, 1, S]`` (outside the kernels in
    both packages)."""
    return (do.float() * o.float()).sum(dim=-1)[:, :, None, :]


def _flash_bwd_plain(q, k, v, lengths, o, lse, do, causal: bool = True):
    """Plain version of ``_flash_bwd``: (dq, dk, dv)."""
    delta = _delta(o, do)
    dq = _flash_bwd_dq_plain(q, k, v, lengths, lse, delta, do, causal)
    dk, dv = _flash_bwd_dkv_plain(q, k, v, lengths, lse, delta, do, causal)
    return dq, dk, dv


def _bwd_operands(name, q, k, v, lengths, lse, delta, do):
    B, G, S, D = q.shape
    if (k.shape != (B, S, D) or v.shape != (B, S, D) or do.shape != q.shape
            or lse.shape != (B, G, 1, S) or delta.shape != (B, G, 1, S)):
        raise ValueError(f"{name}: bad shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"lse {tuple(lse.shape)} delta {tuple(delta.shape)}")
    if not q.is_cuda:
        raise ValueError(f"{name}: q on {q.device}")
    if (D != 64 or q.dtype not in _DTYPE_CODES
            or any(t.dtype != q.dtype for t in (k, v, do))):
        raise NotImplementedError(
            f"flash_attention_bwd.cu is built for head dim 64 in f32/bf16; got "
            f"D={D}, {q.dtype}/{k.dtype}/{v.dtype}/{do.dtype}")
    lens = lengths.to(device=q.device, dtype=torch.int32).contiguous()
    if lens.numel() != B:
        raise ValueError(f"{name}: {lens.numel()} lengths for B={B}")
    return (q.contiguous(), k.contiguous(), v.contiguous(), do.contiguous(),
            lse.float().contiguous(), delta.float().contiguous(), lens)


def _flash_bwd_dq(q, k, v, lengths, lse, delta, do, causal: bool = True):
    """dQ ``[B, G, S, D]`` from the saved log-sum-exp and
    ``delta = rowsum(dO * O)`` (both ``[B, G, 1, S]`` f32)."""
    if q.device.type == "cpu":
        return _flash_bwd_dq_plain(q, k, v, lengths, lse, delta, do, causal)
    ops = _bwd_operands("_flash_bwd_dq", q, k, v, lengths, lse, delta, do)
    B, G, S, D = q.shape
    dq = torch.empty_like(ops[0])
    f = _build.bind("flash_attention_bwd", "flash_bwd_dq", 8, 5, 2)
    err = f(*(t.data_ptr() for t in ops), dq.data_ptr(), B, G, S, int(causal),
            _DTYPE_CODES[q.dtype], float(_LOG2E / math.sqrt(D)), float(1.0 / math.sqrt(D)),
            torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "flash_bwd_dq")
    _flash_bwd_dq.launches += 1
    return dq


_flash_bwd_dq.launches = 0


def _flash_bwd_dkv(q, k, v, lengths, lse, delta, do, causal: bool = True):
    """(dK, dV) ``[B, S, D]``, summed over the G query heads of a kv head."""
    if q.device.type == "cpu":
        return _flash_bwd_dkv_plain(q, k, v, lengths, lse, delta, do, causal)
    ops = _bwd_operands("_flash_bwd_dkv", q, k, v, lengths, lse, delta, do)
    B, G, S, D = q.shape
    dk, dv = torch.empty_like(ops[1]), torch.empty_like(ops[2])
    f = _build.bind("flash_attention_bwd", "flash_bwd_dkv", 9, 5, 2)
    err = f(*(t.data_ptr() for t in ops), dk.data_ptr(), dv.data_ptr(), B, G, S,
            int(causal), _DTYPE_CODES[q.dtype], float(_LOG2E / math.sqrt(D)),
            float(1.0 / math.sqrt(D)), torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "flash_bwd_dkv")
    _flash_bwd_dkv.launches += 1
    return dk, dv


_flash_bwd_dkv.launches = 0


def _flash_bwd(q, k, v, lengths, o, lse, do, causal: bool = True):
    """(dq, dk, dv) by the kernel pair; ``delta`` in plain PyTorch."""
    delta = _delta(o, do)
    dq = _flash_bwd_dq(q, k, v, lengths, lse, delta, do, causal)
    dk, dv = _flash_bwd_dkv(q, k, v, lengths, lse, delta, do, causal)
    return dq, dk, dv


class AttnSaved:
    """What a rematerialized layer keeps of its attention: the forward
    kernel's O and log-sum-exp. ``flash_attention_gqa`` fills an empty holder
    and reads a full one instead of launching the forward again, so a layer
    recomputed for its backward never re-runs the attention forward (the JAX
    package's ``save_attn`` remat policy)."""

    __slots__ = ("o", "lse")

    def __init__(self):
        self.o = self.lse = None

    def clear(self):
        self.o = self.lse = None


class _FlashAttentionGQA(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, lengths, soft_bf16, saved):
        if saved is not None and saved.o is not None:
            o, lse = saved.o, saved.lse
        else:
            o, lse = _flash_fwd(q, k, v, lengths, soft_bf16=soft_bf16)
            if saved is not None:
                saved.o, saved.lse = o, lse
        ctx.save_for_backward(q, k, v, lengths, o, lse)
        return o

    @staticmethod
    def backward(ctx, g):
        # the backward recomputes p in fp32 whatever soft_bf16 was: the flag
        # trades rounding in the forward only
        q, k, v, lengths, o, lse = ctx.saved_tensors
        dq, dk, dv = _flash_bwd(q, k, v, lengths, o, lse, g)
        return dq, dk, dv, None, None, None


def flash_attention_gqa(q, k, v, lengths, soft_bf16: bool = False,
                        saved: AttnSaved = None):
    """Causal flash attention with a gradient: q ``[B, G, S, D]``, k/v
    ``[B, S, D]``, ``lengths`` ``[B]`` int32 (pass ``S`` for no padding).
    The backward is the kernel pair driven by the saved log-sum-exp; no
    ``[S, S]`` tensor reaches device memory. ``saved``: see ``AttnSaved``."""
    return _FlashAttentionGQA.apply(q, k, v, lengths, soft_bf16, saved)


def flash_attention(
    q: torch.Tensor,  # [b, s, nh, d]
    k: torch.Tensor,  # [b, s, kvh, d]
    v: torch.Tensor,  # [b, s, kvh, d]
    *,
    lengths: torch.Tensor = None,  # [b] int32 valid prefix per sequence
    softmax_bf16: bool = False,
    saved: AttnSaved = None,
) -> torch.Tensor:
    """Model-layout wrapper: GQA via the kernel's group dim (head h reads kv
    head ``h // groups``); returns ``[b, s, nh*d]``. Outputs at padded query
    rows are finite garbage, as in the JAX package."""
    b, s, nh, d = q.shape
    kvh = k.shape[2]
    groups = nh // kvh
    q4 = (q.reshape(b, s, kvh, groups, d).permute(0, 2, 3, 1, 4)
          .reshape(b * kvh, groups, s, d))

    def fold(x):
        return x.permute(0, 2, 1, 3).reshape(b * kvh, s, d)

    if lengths is None:
        lens_b = torch.full((b * kvh,), s, dtype=torch.int32, device=q.device)
    else:
        lens_b = torch.repeat_interleave(lengths.to(torch.int32), kvh)
    out = flash_attention_gqa(q4, fold(k), fold(v), lens_b, softmax_bf16, saved)
    return (out.reshape(b, kvh, groups, s, d).permute(0, 3, 1, 2, 4)
            .reshape(b, s, nh * d))
