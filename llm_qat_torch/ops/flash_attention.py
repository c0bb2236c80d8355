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

On the card the forward and the backward pair take head dims 16, 32, 64
and 128 (``HEAD_DIMS``), each in f32 and bf16, and every other head dim
with ``hd % 4 == 0`` and ``32 < hd <= 128`` (``padded``: OpenLLaMA-3B's 100,
and 48, 80, 96) through one build of each kernel's D = 128 code with hd an
argument (``flash_fwd_dpad``, ``flash_bwd_dq_dpad``, ``flash_bwd_dkv_dpad``).
The forward also takes head dim 256 (Falcon3's serving prefill:
``flash_fwd_d256``, ``FWD_HEAD_DIMS``); the backward pair is not built
there. Another head dim raises ``NotImplementedError`` naming the rule of
the source it asked for. In bf16
all three kernels run their products on the tensor cores, and their plain
versions take q.k and dO.v the same way (``_scores``); in f32 they run on
the fp32 units with fp32 products.

Block structure: the TPU forward walks key blocks of
``_fit_block(1024, S)`` (the ``bk`` every caller of the JAX package passes)
with an online softmax: each block's p
is taken against the running maximum ``m_new`` over the blocks so far and
rounded to V's type, and ``alpha = exp2(m - m_new)`` rescales ``l`` and the
p.V sum at each block edge. The plain version walks the same blocks the same
way, and so does the kernel (its second pass takes each column's p against
the running maximum at the end of that column's block). Within a block the
fp32 sums run in another order, so O agrees with the TPU kernel's bits but
for a few last-bit differences before the bf16 rounding
(``tests/test_torch_flash_backward.py`` holds S = 2048, 1536 and a ragged
length against the JAX kernel), and the log-sum-exp, which the backward
consumes, to 1e-5.
"""

from __future__ import annotations

import math

import torch

from llm_qat_torch.ops import _build

_NEG_INF = -1e30
_KEY_BLOCK = 1024  # the TPU forward's key block before _fit_block
_LOG2E = 1.4426950408889634  # log2(e)
_LN2 = 0.6931471805599453    # ln(2)


def _exp2(x: torch.Tensor) -> torch.Tensor:
    """``jnp.exp2`` as JAX defines it: ``exp(ln2 * x)`` in x's type (for
    bf16, ln2 and the product round to bf16 first)."""
    return torch.exp(x * torch.full((), _LN2, dtype=x.dtype, device=x.device))


def _scores(a, b, tensor_cores: bool = True):
    """``a . b^T`` per (B, g) with fp32 sums: a ``[B, G, S, D]``, b ``[B, S, D]``,
    out ``[B, G, S, S]``. For bf16 operands on the GPU, with ``tensor_cores``,
    the library's bf16 product with an fp32 result: the arithmetic of the
    tensor-core kernels (K4, K10, K11), whose fp32 accumulation differs from a
    chain of fp32 multiply-adds by enough to move p or ds across a bf16
    rounding step, and a sum that cancels then misses the kernels' limit
    (``flash_numerics.py`` measures it). At a head dim of the padded build
    the operands are zero-padded to its 128-wide tiles first: the library's
    product over a depth of 100 sums in another order than the kernel's
    16-deep chunks (it moved a p a step past K4's limit at hd 100). At
    D = 256 the two 128-deep halves are taken apart and summed, as K4's two
    warps of a row group take them. Otherwise fp32 products of the widened
    operands (the CPU and f32 operands)."""
    if tensor_cores and a.is_cuda and a.dtype == torch.bfloat16:
        B, G, S, D = a.shape
        if padded(D):
            a, b = (torch.nn.functional.pad(t, (0, 128 - D)) for t in (a, b))
            D = 128
        if D == 256:
            lo, hi = (torch.bmm(a[..., h:h + 128].reshape(B, G * S, 128),
                                b[..., h:h + 128].transpose(1, 2), out_dtype=torch.float32)
                      for h in (0, 128))
            return (lo + hi).reshape(B, G, S, -1)
        return torch.bmm(a.reshape(B, G * S, D), b.transpose(1, 2),
                         out_dtype=torch.float32).reshape(B, G, S, -1)
    return torch.einsum("bgqd,bkd->bgqk", a.float(), b.float())


def _fit_block(target: int, s: int) -> int:
    """Largest block <= target that divides ``s`` (lane-aligned when s is):
    the JAX package's ``_fit_block``, which sizes the TPU kernel's key
    blocks."""
    t = min(target, s)
    while s % t:
        t = t - t % 128 - 128 if t > 128 else t - 1
    if t < 1:
        raise ValueError(f"cannot block seq len {s}")
    return t


def _flash_fwd_plain(q, k, v, lengths, causal: bool = True, soft_bf16: bool = False,
                     bk: int = _KEY_BLOCK):
    """Plain PyTorch version of the flash forward kernel: the masked score
    matrix at once, then the TPU kernel's walk over key blocks of
    ``_fit_block(bk, S)``: per block, p against the running maximum, rounded
    to V's type for p.V, and ``l`` and the p.V sum rescaled by
    ``alpha = exp2(m - m_new)``. A block with no live column in a row leaves
    that row as it was (``alpha = 1``, ``p = 0``), as a skipped block does."""
    B, G, S, D = q.shape
    bk = _fit_block(bk, S)
    scale = 1.0 / (D ** 0.5)
    s = (scale * _LOG2E) * _scores(q, k)
    col = torch.arange(S, device=q.device)
    ok = (col[None, :] < torch.clamp(lengths.to(q.device), min=1)[:, None])
    ok = ok[:, None, None, :]                                  # [B, 1, 1, S]
    if causal:
        ok = ok & (col[None, :] <= col[:, None])[None, None]
    s = torch.where(ok, s, torch.full_like(s, _NEG_INF))
    m = torch.full((B, G, S, 1), _NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((B, G, S, D), dtype=torch.float32, device=q.device)
    for k0 in range(0, S, bk):
        sb = s[..., k0:k0 + bk]
        m_new = torch.maximum(m, sb.amax(dim=-1, keepdim=True))
        alpha = _exp2(m - m_new)
        if soft_bf16:
            p16 = _exp2((sb - m_new).to(torch.bfloat16))
            p, pv = p16.float(), p16.to(v.dtype)
        else:
            p = _exp2(sb - m_new)
            pv = p.to(v.dtype)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + torch.einsum("bgqk,bkd->bgqd", pv.float(),
                                         v[:, k0:k0 + bk].float())
        m = m_new
    o = (acc / l).to(q.dtype)
    lse = (m * _LN2 + torch.log(l))[..., 0][:, :, None, :]
    return o, lse


_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# the head dims the card's kernels (K4, K10, K11) are built for, each in f32
# and bf16: the tiny test and pipeline models' 16, the accuracy experiment's
# 32, TinyLlama-1.1B's 64 and the LLaMA-7B family's 128; and the forward's
# (K4) beside them, Falcon3's 256
HEAD_DIMS = (16, 32, 64, 128)
FWD_HEAD_DIMS = HEAD_DIMS + (256,)


def padded(D: int) -> bool:
    """Whether head dim ``D`` goes through the padded builds
    (``flash_fwd_dpad``, ``flash_bwd_dq_dpad``, ``flash_bwd_dkv_dpad``;
    OpenLLaMA-3B's 100)."""
    return D not in HEAD_DIMS and _build.in_padded_rule(D)


def _check_built(source: str, D: int, tensors) -> None:
    """Raise ``NotImplementedError``, naming the built set, unless every
    tensor has q's f32 / bf16 type and ``D`` is a head dim ``source`` takes:
    ``HEAD_DIMS`` and the padded build's for the backward pair
    (``flash_attention_bwd.cu``), and 256 beside them for the forward
    (``flash_attention.cu``)."""
    fwd = source == "flash_attention.cu"
    dts = [t.dtype for t in tensors]
    if (dts[0] in _DTYPE_CODES and all(d == dts[0] for d in dts)
            and (D in (FWD_HEAD_DIMS if fwd else HEAD_DIMS) or padded(D))):
        return
    also = (", and for 256," if fwd else "")
    note = ("" if fwd or D not in FWD_HEAD_DIMS else
            f" (head dim {D} has the forward's build only, flash_attention.cu)")
    raise NotImplementedError(
        f"{source} is built for head dims {HEAD_DIMS} and every {_build.PADDED_RULE}{also} in "
        f"f32 or bf16 (one type for every operand); got D={D}, "
        f"{'/'.join(str(d) for d in dts)}{note}")


def _entry(stem: str, D: int) -> str:
    """The kernel entry of head dim ``D``: ``stem`` at 64, ``stem_dpad``
    for the padded build, else ``stem_d{D}``."""
    return stem if D == 64 else f"{stem}_dpad" if padded(D) else f"{stem}_d{D}"


def _flash_fwd(q, k, v, lengths, causal: bool = True, soft_bf16: bool = False,
               bk: int = _KEY_BLOCK):
    """q: [B, G, S, D]; k/v: [B, S, D]; lengths [B] (causal within each S;
    ``causal=False``: every column below the length). Returns
    ([B, G, S, D], lse [B, G, 1, S]). p is rounded in the TPU kernel's key
    blocks (``_fit_block(bk, S)``: every caller of the JAX kernel passes
    1024); the CUDA kernel's own tiles are fixed and mask the ragged edge. On the card: head dims
    ``FWD_HEAD_DIMS`` and the padded build's (``padded``) in f32 or bf16."""
    B, G, S, D = q.shape
    if k.shape != (B, S, D) or v.shape != (B, S, D):
        raise ValueError(f"bad shapes q {tuple(q.shape)} k {tuple(k.shape)}")
    if q.device.type == "cpu":
        return _flash_fwd_plain(q, k, v, lengths, causal, soft_bf16, bk)
    if not q.is_cuda:
        raise ValueError(f"_flash_fwd: q on {q.device}")
    _check_built("flash_attention.cu", D, (q, k, v))
    qc, kc, vc = q.contiguous(), k.contiguous(), v.contiguous()
    lens = lengths.to(device=q.device, dtype=torch.int32).contiguous()
    if lens.numel() != B:
        raise ValueError(f"_flash_fwd: {lens.numel()} lengths for B={B}")
    o = torch.empty_like(qc)
    lse = torch.empty((B, G, 1, S), dtype=torch.float32, device=q.device)
    ints = [B, G, S, _fit_block(bk, S), int(causal), int(soft_bf16), _DTYPE_CODES[q.dtype]]
    if padded(D):
        ints.append(D)
    f = _build.bind("flash_attention", _entry("flash_fwd", D), 6, len(ints), 1)
    err = f(qc.data_ptr(), kc.data_ptr(), vc.data_ptr(), lens.data_ptr(),
            o.data_ptr(), lse.data_ptr(), *ints, float(_LOG2E / math.sqrt(D)),
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
    kernels share (q.k and dO.v by ``_scores``)."""
    B, G, S, D = q.shape
    scale = 1.0 / (D ** 0.5)
    s2 = (scale * _LOG2E) * _scores(q, k)
    col = torch.arange(S, device=q.device)
    ok = (col[None, :] < torch.clamp(lengths.to(q.device), min=1)[:, None])
    ok = ok[:, None, None, :]
    if causal:
        ok = ok & (col[None, :] <= col[:, None])[None, None]
    s2 = torch.where(ok, s2, torch.full_like(s2, _NEG_INF))
    lse2 = lse.reshape(B, G, S, 1) * _LOG2E
    p = _exp2(s2 - lse2)
    dp = _scores(do, v)
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
    _check_built("flash_attention_bwd.cu", D, (q, k, v, do))
    lens = lengths.to(device=q.device, dtype=torch.int32).contiguous()
    if lens.numel() != B:
        raise ValueError(f"{name}: {lens.numel()} lengths for B={B}")
    return (q.contiguous(), k.contiguous(), v.contiguous(), do.contiguous(),
            lse.float().contiguous(), delta.float().contiguous(), lens)


def _bwd_scales(D):
    """(scale * log2 e, scale) as the plain versions compute them, from the
    true head dim (the padded build's tiles are 128 wide)."""
    scale = 1.0 / (D ** 0.5)
    return float(scale * _LOG2E), float(scale)


def _bwd_ints(q, causal):
    """The backward entries' integers: B, G, S, causal, the type's code and,
    for the padded build, the head dim."""
    B, G, S, D = q.shape
    return [B, G, S, int(causal), _DTYPE_CODES[q.dtype]] + ([D] if padded(D) else [])


def _flash_bwd_dq(q, k, v, lengths, lse, delta, do, causal: bool = True):
    """dQ ``[B, G, S, D]`` from the saved log-sum-exp and
    ``delta = rowsum(dO * O)`` (both ``[B, G, 1, S]`` f32)."""
    if q.device.type == "cpu":
        return _flash_bwd_dq_plain(q, k, v, lengths, lse, delta, do, causal)
    ops = _bwd_operands("_flash_bwd_dq", q, k, v, lengths, lse, delta, do)
    D = q.shape[-1]
    dq = torch.empty_like(ops[0])
    ints = _bwd_ints(q, causal)
    f = _build.bind("flash_attention_bwd", _entry("flash_bwd_dq", D), 8, len(ints), 2)
    err = f(*(t.data_ptr() for t in ops), dq.data_ptr(), *ints, *_bwd_scales(D),
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
    D = q.shape[-1]
    dk, dv = torch.empty_like(ops[1]), torch.empty_like(ops[2])
    ints = _bwd_ints(q, causal)
    f = _build.bind("flash_attention_bwd", _entry("flash_bwd_dkv", D), 9, len(ints), 2)
    err = f(*(t.data_ptr() for t in ops), dk.data_ptr(), dv.data_ptr(), *ints,
            *_bwd_scales(D), torch.cuda.current_stream(q.device).cuda_stream)
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


def kernel_attributes() -> dict:
    """What the compiler gave every kernel of K4, K10 and K11 at every head
    dim it is built for (K4 at 256 too: ``flash_fwd_d256``; the padded
    builds as ``flash_fwd_dpad``, ``flash_bwd_dq_dpad`` and
    ``flash_bwd_dkv_dpad``), by entry name, ``_f32``
    appended for the f32 (SIMT) kernels (the bf16 tensor-core kernels keep
    the bare name): registers a thread, shared
    bytes (static, dynamic), local (spill) bytes a thread, threads a block
    and blocks an SM can hold. Launches nothing."""
    return {_entry(stem, D) + ("" if code else "_f32"): _build.attributes(
                src, f"{stem}_attributes", D, code)
            for stem, src, dims in (("flash_fwd", "flash_attention", FWD_HEAD_DIMS),
                                    ("flash_bwd_dq", "flash_attention_bwd", HEAD_DIMS),
                                    ("flash_bwd_dkv", "flash_attention_bwd", HEAD_DIMS))
            for D in dims + (100,) for code in (1, 0)}


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
