"""Ring context-parallel causal attention with quantized KV exchange (the JAX
package's ``parallel/ring_attention.py``).

The sequence is split over the mesh's 'cp' axis: rank ``idx`` of ``n`` holds
query/KV chunk ``idx`` of ``sl`` tokens. The KV chunks rotate around the ring
(``comm.shift``: rank i sends to i + 1) while every rank accumulates its
queries' attention step by step: at step i it holds chunk ``(idx - i) mod n``,
which is its own (step 0, causal), wholly visible (``idx >= i``, non-causal)
or wholly masked (skipped, its chunk passed on all the same). Each step's
normalized partial (O and the log-sum-exp) merges into a running one in fp32
(``_merge_partials``). With ``kv_bits`` the chunks travel as int8 plus a
per-token fp32 scale, ``_quantize``'s transport, and attention sees the
dequantized values.

``ring_flash_attention_local`` runs each live step as the flash forward
kernel (K4, ``ops/flash_attention.py:_flash_fwd``, with the ring's key block
``bk``) and replays the ring in its backward with the dQ and dK/dV kernels
(K10, K11), step 0 causal and the live steps not: the dK/dV accumulators
travel with their chunk and arrive home after n rotations; the transport's
quantization passes the gradient straight through. The forward's last
rotation would bring every chunk home unchanged, so it is not made: the
backward replays the chunks this rank sent, as they were sent.
``ring_attention_local`` is the fp32 einsum body, the ring's plain version.
Both take the ring's process group (``parallel.mesh.axis_group(mesh,
"cp")``) and this rank's chunks; the JAX package's ``ring_attention``
wrapper, a ``shard_map`` over global arrays, has no counterpart here.

Numerics: with ``kv_bits=None`` the result is single-device causal attention
up to the merge's reassociation; with ``kv_bits=8``, attention over per-token
fake-quantized K/V.
"""

from __future__ import annotations

from typing import Optional

import torch

from llm_qat_torch.parallel import comm

_NEG = -1e30
_EPS = 1e-6


def _quantize(x: torch.Tensor, bits: int):
    """``[b, sl, h, d]`` -> int8 values ``[b, sl, h*d]`` and f32 scales
    ``[b, sl, 1]`` per token over (h, d) (``kv_fake_quant``'s flat-hidden
    per-token granularity)."""
    b, sl, h, d = x.shape
    flat = x.reshape(b, sl, h * d).float()
    amax = flat.abs().amax(dim=-1, keepdim=True) + _EPS
    s = torch.full_like(amax, float(2 ** (bits - 1) - 1)) / amax
    return torch.round(flat * s).to(torch.int8), s


def _dequantize(q: torch.Tensor, s: torch.Tensor, shape, dtype) -> torch.Tensor:
    return (q.float() / (s + _EPS)).reshape(shape).to(dtype)


def _to_flash(x: torch.Tensor, hk: int, G: int) -> torch.Tensor:
    """``[b, sl, hk*G, d]`` query -> ``[b*hk, G, sl, d]`` (the kernels' GQA
    layout)."""
    b, sl, h, d = x.shape
    return x.reshape(b, sl, hk, G, d).permute(0, 2, 3, 1, 4).reshape(b * hk, G, sl, d)


def _from_flash(x: torch.Tensor, b: int, hk: int, G: int) -> torch.Tensor:
    """``[b*hk, G, sl, d]`` -> ``[b, sl, hk*G, d]``."""
    _, _, sl, d = x.shape
    return x.reshape(b, hk, G, sl, d).permute(0, 3, 1, 2, 4).reshape(b, sl, hk * G, d)


def _fold_kv(x: torch.Tensor) -> torch.Tensor:
    """``[b, sl, hk, d]`` -> ``[b*hk, sl, d]`` (the kernels' KV layout, never
    repeated)."""
    b, sl, hk, d = x.shape
    return x.permute(0, 2, 1, 3).reshape(b * hk, sl, d)


def _unfold_kv(x: torch.Tensor, b: int, hk: int) -> torch.Tensor:
    B, sl, d = x.shape
    return x.reshape(b, hk, sl, d).permute(0, 2, 1, 3)


def _merge_partials(o1, lse1, o2, lse2):
    """Combine two normalized flash partials (o ``[B, G, sl, d]``, lse
    ``[B, G, 1, sl]`` in nats) into one: the streaming softmax merge, fp32."""
    m = torch.maximum(lse1, lse2)
    e1 = torch.exp(lse1 - m)
    e2 = torch.exp(lse2 - m)
    w1 = e1.transpose(2, 3)
    w2 = e2.transpose(2, 3)
    o = (o1 * w1 + o2 * w2) / torch.clamp_min(w1 + w2, 1e-30)
    lse = m + torch.log(torch.clamp_min(e1 + e2, 1e-30))
    return o, lse


def _kv_chunks(k, v, kv_bits):
    """What travels the ring: (k, k scale, v, v scale), the scales None
    without ``kv_bits``."""
    if kv_bits is None:
        return [k, None, v, None]
    return [*_quantize(k, kv_bits), *_quantize(v, kv_bits)]


class _Shift(torch.autograd.Function):
    """``comm.shift`` with a gradient: a received float tensor's gradient
    goes back to its sender (a shift the other way)."""

    @staticmethod
    def forward(ctx, group, *tensors):
        ctx.group = group
        ctx.floats = [t.is_floating_point() for t in tensors]
        out = comm.shift(tensors, group)
        ctx.likes = [torch.empty_like(o, device="meta") for o in out]
        ctx.mark_non_differentiable(*[o for o, f in zip(out, ctx.floats) if not f])
        return tuple(out)

    @staticmethod
    def backward(ctx, *grads):
        dev = next(g.device for g in grads if g is not None)
        sent = [torch.zeros(m.shape, dtype=m.dtype, device=dev) if g is None else g
                for g, m, f in zip(grads, ctx.likes, ctx.floats) if f]
        back = iter(comm.shift(sent, ctx.group, step=-1))
        return (None, *(next(back) if f else None for f in ctx.floats))


def _rotate(state, group):
    """Every chunk of ``state`` one rank along the ring."""
    live = [t for t in state if t is not None]
    it = iter(_Shift.apply(group, *live))
    return [None if t is None else next(it) for t in state]


def _readable(state, shape, dtype):
    """The held chunk's K and V in the kernels' layout ``[b*hk, sl, d]``."""
    k_q, k_s, v_q, v_s = state
    if k_s is None:
        return _fold_kv(k_q.to(dtype)), _fold_kv(v_q.to(dtype))
    return (_fold_kv(_dequantize(k_q, k_s, shape, dtype)),
            _fold_kv(_dequantize(v_q, v_s, shape, dtype)))


def ring_steps(n: int, idx: int):
    """The ring's schedule on rank ``idx`` of ``n``: for each step, whether
    it runs a kernel and whether that kernel is causal (step 0 causal; step
    i >= 1 non-causal when ``idx >= i``, else skipped)."""
    return [(True, True)] + [(idx >= i, False) for i in range(1, n)]


class _RingFlash(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, group, kv_bits, bk):
        from llm_qat_torch.ops.flash_attention import _flash_fwd

        n, idx = torch.distributed.get_world_size(group), torch.distributed.get_rank(group)
        b, sl, h, d = q.shape
        hk = k.shape[2]
        G, B = h // hk, b * hk
        qB = _to_flash(q, hk, G)
        lens = torch.full((B,), sl, dtype=torch.int32, device=q.device)
        home = _kv_chunks(k, v, kv_bits)
        state = home
        o_run = torch.zeros((B, G, sl, d), dtype=torch.float32, device=q.device)
        lse_run = torch.full((B, G, 1, sl), _NEG, dtype=torch.float32, device=q.device)
        for i, (live, causal) in enumerate(ring_steps(n, idx)):
            if live:
                kB, vB = _readable(state, k.shape, q.dtype)
                o_i, lse_i = _flash_fwd(qB, kB, vB, lens, causal=causal, bk=bk)
                o_run, lse_run = _merge_partials(o_run, lse_run, o_i.float(), lse_i)
            if i < n - 1:
                state = _rotate(state, group)
        ctx.group, ctx.kv_bits, ctx.hk = group, kv_bits, hk
        ctx.has_scales = home[1] is not None
        ctx.save_for_backward(q, o_run, lse_run, *[t for t in home if t is not None])
        return _from_flash(o_run, b, hk, G).to(q.dtype)

    @staticmethod
    def backward(ctx, g):
        from llm_qat_torch.ops.flash_attention import _flash_bwd

        q, o_run, lse_run, *chunks = ctx.saved_tensors
        state = chunks if ctx.has_scales else [chunks[0], None, chunks[1], None]
        group, hk = ctx.group, ctx.hk
        n, idx = torch.distributed.get_world_size(group), torch.distributed.get_rank(group)
        b, sl, h, d = q.shape
        G, B = h // hk, b * hk
        qB = _to_flash(q, hk, G)
        gB = _to_flash(g, hk, G).to(q.dtype)
        oB = o_run.to(q.dtype)
        lens = torch.full((B,), sl, dtype=torch.int32, device=q.device)
        dq_acc = torch.zeros((B, G, sl, d), dtype=torch.float32, device=q.device)
        # the dK/dV accumulators travel with their chunk: after n rotations
        # each is home holding every rank's contribution
        dk_roll = torch.zeros((b, sl, hk, d), dtype=torch.float32, device=q.device)
        dv_roll = torch.zeros_like(dk_roll)
        for i, (live, causal) in enumerate(ring_steps(n, idx)):
            if live:
                kB, vB = _readable(state, (b, sl, hk, d), q.dtype)
                dq_i, dk_i, dv_i = _flash_bwd(qB, kB, vB, lens, oB, lse_run, gB, causal=causal)
                dq_acc = dq_acc + dq_i.float()
                dk_roll = dk_roll + _unfold_kv(dk_i, b, hk).float()
                dv_roll = dv_roll + _unfold_kv(dv_i, b, hk).float()
            if i < n - 1:
                state = _rotate(state, group)
            dk_roll, dv_roll = comm.shift([dk_roll, dv_roll], group)
        dq = _from_flash(dq_acc, b, hk, G).to(q.dtype)
        # the transport's quantization passes the gradient straight through
        return dq, dk_roll.to(q.dtype), dv_roll.to(q.dtype), None, None, None


def ring_flash_attention_local(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, group,
                               kv_bits: Optional[int] = 8, bk: int = 1024) -> torch.Tensor:
    """This rank's attention output ``[b, sl, h, d]`` (q's type) for its
    query chunk ``q`` ``[b, sl, h, d]`` and KV chunk ``k``/``v``
    ``[b, sl, hk, d]`` (``hk`` divides ``h``; GQA rides the kernels' group
    dim, so K/V travel un-repeated), over the ring of ``group``.
    Differentiable."""
    return _RingFlash.apply(q, k, v, group, kv_bits, bk)


def ring_attention_local(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, group,
                         kv_bits: Optional[int] = 8) -> torch.Tensor:
    """The ring's plain version: each step's attention as an fp32 einsum with
    the global causal mask, accumulated with an online softmax. Heads must
    already match (repeat KV for GQA first). ``[b, sl, h, d]`` in q's type."""
    n, idx = torch.distributed.get_world_size(group), torch.distributed.get_rank(group)
    b, sl, h, d = q.shape
    qf = q.float() * (1.0 / d ** 0.5)
    state = _kv_chunks(k, v, kv_bits)
    local = torch.arange(sl, device=q.device)
    row = idx * sl + local
    m = torch.full((b, h, sl, 1), _NEG, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, h, sl, 1), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, h, sl, d), dtype=torch.float32, device=q.device)
    for i in range(n):
        j = (idx - i) % n                # the origin of the chunk held
        k_q, k_s, v_q, v_s = state
        if k_s is None:
            k_, v_ = k_q.float(), v_q.float()
        else:
            k_ = _dequantize(k_q, k_s, k.shape, torch.float32)
            v_ = _dequantize(v_q, v_s, v.shape, torch.float32)
        s = torch.einsum("bqhd,bkhd->bhqk", qf, k_)
        mask = (j * sl + local)[None, :] <= row[:, None]
        s = torch.where(mask[None, None], s, torch.full_like(s, _NEG))
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new) * mask[None, None]
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + torch.einsum("bhqk,bkhd->bhqd", p, v_)
        m = m_new
        if i < n - 1:
            state = _rotate(state, group)
    out = (acc / torch.clamp_min(l, 1e-30)).to(q.dtype)
    return out.permute(0, 2, 1, 3)
