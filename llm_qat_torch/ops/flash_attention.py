"""Blockwise (flash) causal attention, forward only.

``_flash_fwd`` launches ``csrc/flash_attention.cu``, which replaces
``llm_qat_tpu/ops/pallas/flash_attention.py:_flash_fwd_kernel``. Beside it,
``_flash_fwd_plain`` computes the same function in plain PyTorch; the
wrapper takes it only for tensors on the CPU. The backward pair waits for
the training slice of the port.

Layout (the JAX package's): q ``[B, G, S, D]`` with ``B = batch*kv_heads`` and
``G`` the GQA group size, k/v ``[B, S, D]`` (never repeated), ``lengths``
``[B]`` int32 masking columns ``>= max(length, 1)``. Base-2 softmax in fp32;
p is rounded to V's type before the p.V product; ``soft_bf16`` evaluates
exp2 on bf16 operands (``config.flash_softmax_bf16``). Returns O and the
per-row log-sum-exp in nats, ``[B, G, 1, S]``.
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
    score matrix at once. For S <= 1024 (every prefill bucket) the TPU
    kernel's default 1024-key block holds the whole row, so this is its
    arithmetic step for step."""
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


def flash_attention(
    q: torch.Tensor,  # [b, s, nh, d]
    k: torch.Tensor,  # [b, s, kvh, d]
    v: torch.Tensor,  # [b, s, kvh, d]
    *,
    lengths: torch.Tensor = None,  # [b] int32 valid prefix per sequence
    softmax_bf16: bool = False,
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
    out, _ = _flash_fwd(q4, fold(k), fold(v), lens_b, soft_bf16=softmax_bf16)
    return (out.reshape(b, kvh, groups, s, d).permute(0, 3, 1, 2, 4)
            .reshape(b, s, nh * d))
