"""Quantized LLaMA decoder: the building blocks the serving path shares, the
training / scoring forward and the fixed-size-cache decode path of
generation (``init_cache`` / ``forward_with_cache``): the JAX package's
``models/llama.py`` without ``classify``.

Params are a plain dict with the per-layer weights stacked on a leading layer
axis, stored ``[in, out]``; the decoder is a Python loop over the layers, and
rematerialization re-runs a layer in its backward (``remat``).

Numerics kept from the reference: every projection is ``quant_dense``
(per-channel symmetric weight fake-quant, per-token activation fake-quant);
the KV fake-quant is applied to the flat ``[b, s, kv_dim]`` projections before
the head reshape and RoPE; RMSNorm accumulates in fp32, RoPE uses fp32 cos/sin
tables (``inv_freq = theta^(-2i/d)``, table ``concat(freqs, freqs)``),
attention takes an fp32 softmax; embeddings, lm_head and norm gains are never
quantized.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch

from llm_qat_torch.models.config import LlamaConfig
from llm_qat_torch.ops.linear import quant_dense
from llm_qat_torch.ops.qat_matmul import mm_f32
from llm_qat_torch.ops.quantize import kv_fake_quant, sym_fake_quant

Params = Dict[str, Any]

_NEG_INF = -1e9  # additive mask value; fp32-softmax-safe


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm with fp32 accumulation, rounded to ``x``'s type before the
    gain (which promotes like the JAX package: bf16 x, f32 gain -> f32)."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * scale


def rope_cos_sin(
    positions: torch.Tensor, head_dim: int, theta: float
) -> Tuple[torch.Tensor, torch.Tensor]:
    """fp32 cos/sin tables ``[b, s, head_dim]`` for absolute positions
    ``[b, s]``."""
    inv_freq = 1.0 / (
        theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                               device=positions.device) / head_dim)
    )
    freqs = positions.float()[..., None] * inv_freq
    emb = torch.cat([freqs, freqs], dim=-1)
    return torch.cos(emb), torch.sin(emb)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotate-half RoPE. ``x`` is ``[b, s, heads, head_dim]``; cos/sin
    ``[b, s, head_dim]``."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    rotated = torch.cat([-x2, x1], dim=-1)
    c = cos[:, :, None, :].to(x.dtype)
    s = sin[:, :, None, :].to(x.dtype)
    return x * c + rotated * s


def _attend(
    q: torch.Tensor,     # [b, s_q, nh, hd]
    k: torch.Tensor,     # [b, s_kv, kvh, hd]
    v: torch.Tensor,     # [b, s_kv, kvh, hd]
    mask: torch.Tensor,  # [b, 1, s_q, s_kv] additive (0 or -1e9)
) -> torch.Tensor:
    """Scaled dot-product attention with fp32 softmax over the full score
    matrix; GQA by head groups, K/V never repeated. Returns
    ``[b, s_q, nh*hd]``."""
    b, s_q, nh, hd = q.shape
    kvh = k.shape[2]
    groups = nh // kvh
    qg = q.reshape(b, s_q, kvh, groups, hd)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), k.float())
    scores = scores / math.sqrt(hd)
    scores = scores + mask[:, :, None, :, :]
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs.to(v.dtype).float(), v.float())
    return out.reshape(b, s_q, nh * hd).to(q.dtype)


def _rope_rotate(x: torch.Tensor, c: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """Rotate-half RoPE on the last dim with pre-broadcast cos/sin (the
    flash-layout path; same math as :func:`apply_rope`)."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    rotated = torch.cat([-x2, x1], dim=-1)
    return x * c.to(x.dtype) + rotated * s.to(x.dtype)


def silu(x: torch.Tensor) -> torch.Tensor:
    """``x * sigmoid(x)`` with the sigmoid rounded to ``x``'s type first (JAX's
    ``jax.nn.silu``; ``torch.nn.functional.silu`` rounds once)."""
    return x * torch.sigmoid(x)


# ---------------------------------------------------------------------------
# Rematerialization
# ---------------------------------------------------------------------------


class _Remat(torch.autograd.Function):
    """``fn(*tensors)`` without a saved graph: the forward runs under
    ``no_grad`` and keeps only the inputs, the backward runs ``fn`` again with
    a graph and differentiates it. ``fn`` must be deterministic (there is no
    dropout here, so no RNG state is kept)."""

    @staticmethod
    def forward(ctx, fn, *tensors):
        ctx.fn = fn
        ctx.save_for_backward(*tensors)
        with torch.no_grad():
            return fn(*tensors)

    @staticmethod
    def backward(ctx, g):
        leaves = [t.detach().requires_grad_(need)
                  for t, need in zip(ctx.saved_tensors, ctx.needs_input_grad[1:])]
        with torch.enable_grad():
            out = ctx.fn(*leaves)
        diff = [t for t in leaves if t.requires_grad]
        grads = iter(torch.autograd.grad(out, diff, g, allow_unused=True))
        return (None, *(next(grads) if t.requires_grad else None for t in leaves))


def remat(fn, *tensors):
    """``fn(*tensors)`` (one tensor out), recomputed in the backward instead
    of saved."""
    return _Remat.apply(fn, *tensors)


# ---------------------------------------------------------------------------
# Decoder layer (training / scoring path)
# ---------------------------------------------------------------------------


def decoder_layer(
    h: torch.Tensor,
    lp: Params,
    config: LlamaConfig,
    mask: torch.Tensor,
    cos: torch.Tensor,
    sin: torch.Tensor,
    cache_kv=None,
    cache_index=None,
    use_flash: bool = False,
    flash_lengths: Optional[torch.Tensor] = None,
    attn_saved=None,
):
    """One decoder block. ``attn_saved``: an ``ops.flash_attention.AttnSaved``
    holder through which a rematerialized layer keeps its attention output
    (see ``backbone``).

    With ``cache_kv=(k_cache, v_cache)`` of shape ``[b, max_len, kvh, hd]``
    the new (fake-quantized, RoPE'd) K and (fake-quantized) V are written at
    ``cache_index`` (in place; a start past ``max_len - s`` is clamped, as
    ``dynamic_update_slice`` clamps it) and attention runs over the whole
    cache under ``mask``; returns ``(h, (k_cache, v_cache))``. Without, the
    training path; returns ``(h, None)``."""
    c = config
    b, s, _ = h.shape
    hd, nh, kvh = c.head_dim, c.num_attention_heads, c.kv_heads
    qd = dict(
        w_bits=c.w_bits, a_bits=c.a_bits, symmetric=c.symmetric,
        act_layerwise=c.act_layerwise, weight_layerwise=c.weight_layerwise,
        fused=c.fused_qat_matmul,
    )
    fq = dict(w_bits=c.w_bits, a_bits=c.a_bits)
    # producer-fused RMSNorm+quant / SiLU+quant path (ops/fused_layer.py):
    # same STE numerics, one pass over device memory per activation
    use_fused_norm = False
    if (
        c.fused_norm_quant and c.fused_qat_matmul and c.symmetric
        and not c.act_layerwise and not c.weight_layerwise
    ):
        from llm_qat_torch.ops import fused_layer

        use_fused_norm = fused_layer.supported(h.reshape(-1, h.shape[-1]), c.w_bits, c.a_bits)

    # --- attention ---
    # flash-layout path: the q/k/v projections emit the flash kernel's
    # head-major layout and the o projection consumes it
    if use_fused_norm and use_flash and cache_kv is None:
        from llm_qat_torch.ops.flash_attention import flash_attention_gqa

        q5, k4, v4 = fused_layer.fused_norm_qkv_flash(
            h, lp["attn_norm"], lp["q"], lp["k"], lp["v"], kvh, eps=c.rms_norm_eps, **fq)
        # KV fake-quant at the reference hook (pre-RoPE); the per-token
        # absmax spans (kvh, d) == the flat hidden dim
        if c.kv_bits < 32:
            k4 = sym_fake_quant(k4, c.kv_bits, (1, 3))
            v4 = sym_fake_quant(v4, c.kv_bits, (1, 3))
        q5 = _rope_rotate(q5, cos[:, None, None, :, :], sin[:, None, None, :, :])
        k4 = _rope_rotate(k4, cos[:, None, :, :], sin[:, None, :, :])
        groups = nh // kvh
        if flash_lengths is None:
            lens_b = torch.full((b * kvh,), s, dtype=torch.int32, device=h.device)
        else:
            lens_b = torch.repeat_interleave(flash_lengths.to(torch.int32), kvh)
        out = flash_attention_gqa(
            q5.reshape(b * kvh, groups, s, hd), k4.reshape(b * kvh, s, hd),
            v4.reshape(b * kvh, s, hd), lens_b, c.flash_softmax_bf16, attn_saved)
        attn = fused_layer.fused_attn_out_dense(
            out.reshape(b, kvh, groups, s, hd), lp["o"], **fq)
        h = h + attn
        # --- MLP ---
        gate, up = fused_layer.fused_norm_dense(
            h, lp["mlp_norm"], (lp["gate"], lp["up"]), eps=c.rms_norm_eps, **fq)
        if c.fused_silu_quant:
            x = fused_layer.fused_silu_mul_dense(gate, up, lp["down"], **fq)
        else:
            x = quant_dense(silu(gate) * up, lp["down"], **qd)
        return h + x, None

    if use_fused_norm:
        q, k, v = fused_layer.fused_norm_dense(
            h, lp["attn_norm"], (lp["q"], lp["k"], lp["v"]), eps=c.rms_norm_eps, **fq)
    else:
        x = rms_norm(h, lp["attn_norm"], c.rms_norm_eps)
        q = quant_dense(x, lp["q"], **qd)
        k = quant_dense(x, lp["k"], **qd)
        v = quant_dense(x, lp["v"], **qd)

    # KV fake-quant at the reference's hook point: flat [b, s, kv_dim],
    # before the head reshape and RoPE
    k = kv_fake_quant(k, c.kv_bits)
    v = kv_fake_quant(v, c.kv_bits)

    q = q.reshape(b, s, nh, hd)
    k = k.reshape(b, s, kvh, hd)
    v = v.reshape(b, s, kvh, hd)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)

    new_cache = None
    if cache_kv is not None:
        k_cache, v_cache = cache_kv
        at = max(0, min(int(cache_index), k_cache.shape[1] - s))
        k_cache[:, at:at + s] = k.to(k_cache.dtype)
        v_cache[:, at:at + s] = v.to(v_cache.dtype)
        k, v = k_cache, v_cache
        new_cache = (k_cache, v_cache)

    if use_flash and cache_kv is None:
        from llm_qat_torch.ops.flash_attention import flash_attention

        attn = flash_attention(q, k, v, lengths=flash_lengths,
                               softmax_bf16=c.flash_softmax_bf16, saved=attn_saved)
    else:
        attn = _attend(q, k, v, mask)
    attn = quant_dense(attn, lp["o"], **qd)
    h = h + attn

    # --- MLP: down(silu(gate(x)) * up(x)) ---
    if use_fused_norm:
        gate, up = fused_layer.fused_norm_dense(
            h, lp["mlp_norm"], (lp["gate"], lp["up"]), eps=c.rms_norm_eps, **fq)
    else:
        x = rms_norm(h, lp["mlp_norm"], c.rms_norm_eps)
        gate = quant_dense(x, lp["gate"], **qd)
        up = quant_dense(x, lp["up"], **qd)
    if use_fused_norm and c.fused_silu_quant:
        x = fused_layer.fused_silu_mul_dense(gate, up, lp["down"], **fq)
    else:
        x = quant_dense(silu(gate) * up, lp["down"], **qd)
    return h + x, new_cache


# ---------------------------------------------------------------------------
# Full forward (training / scoring path)
# ---------------------------------------------------------------------------


def causal_mask(b: int, s: int, attention_mask: Optional[torch.Tensor],
                dtype=torch.float32, device=None) -> torch.Tensor:
    """Additive ``[b, 1, s, s]`` (``[1, 1, s, s]`` without a padding mask)
    mask: causal, optionally combined with a ``[b, s]`` padding mask."""
    if attention_mask is not None:
        device = attention_mask.device
    m = torch.tril(torch.ones((s, s), dtype=torch.bool, device=device))[None, None]
    if attention_mask is not None:
        m = m & attention_mask.bool()[:, None, None, :]
    zero = torch.zeros((), dtype=dtype, device=device)
    return torch.where(m, zero, torch.full_like(zero, _NEG_INF))


def head_matrix(params: Params, config: LlamaConfig) -> torch.Tensor:
    """The (unquantized) lm_head weight ``[H, V]``; tied embeddings
    transpose."""
    return params["embed"].t() if config.tie_word_embeddings else params["lm_head"]


class _MatmulF32(torch.autograd.Function):
    """``x @ w`` with an fp32 result from operands of ``x``'s type. The
    backward rounds the fp32 cotangent to that type and takes both products
    at it (fp32 results), as the reference's bf16 ``lm_head`` does."""

    @staticmethod
    def forward(ctx, x2, w):
        ctx.save_for_backward(x2, w)
        return mm_f32(x2, w.to(x2.dtype))

    @staticmethod
    def backward(ctx, g):
        x2, w = ctx.saved_tensors
        gt = g.to(x2.dtype)
        dx = mm_f32(gt, w.to(x2.dtype).t()).to(x2.dtype)
        dw = mm_f32(x2.t(), gt).to(w.dtype)
        return dx, dw


def head_logits(h: torch.Tensor, head: torch.Tensor) -> torch.Tensor:
    """fp32 logits ``[..., V]`` of hidden states ``[..., H]`` through the fp
    head ``[H, V]``, cast to the activation type first."""
    out = _MatmulF32.apply(h.reshape(-1, h.shape[-1]), head)
    return out.reshape(*h.shape[:-1], head.shape[-1])


def _logits(params: Params, config: LlamaConfig, h: torch.Tensor) -> torch.Tensor:
    h = rms_norm(h, params["final_norm"], config.rms_norm_eps)
    return head_logits(h, head_matrix(params, config))


_LAYER_KEYS = ("attn_norm", "q", "k", "v", "o", "mlp_norm", "gate", "up", "down")


def backbone(
    params: Params,
    config: LlamaConfig,
    input_ids: torch.Tensor,  # [b, s] integer
    *,
    attention_mask: Optional[torch.Tensor] = None,  # [b, s] 1 = keep
    positions: Optional[torch.Tensor] = None,       # [b, s] absolute positions
    remat: bool = False,
    remat_policy: str = "save_attn",
    dtype=None,
) -> torch.Tensor:
    """Decoder sweep returning the final hidden states ``[b, s, H]`` (before
    the final norm): a loop over the stacked layers, the residual stream kept
    at the activation type.

    ``remat=True`` re-runs each layer in its backward instead of saving its
    graph. ``remat_policy="save_attn"`` keeps each layer's attention output
    and log-sum-exp, so the backward never re-runs the flash forward kernel;
    ``"none"`` keeps nothing.

    The flash path takes full-sequence attention with ``s >= 16`` and ``s``
    a multiple of ``min(128, s)``. A padding mask rides as per-sequence
    lengths, which is valid only for a right-padded prefix mask: any other
    mask (left padding, packed documents) falls back to the exact
    full-score-matrix path.
    """
    c = config
    b, s = input_ids.shape
    h = params["embed"][input_ids]
    if dtype is not None:
        h = h.to(dtype)
    if positions is None:
        positions = torch.arange(s, dtype=torch.int32, device=h.device).expand(b, s)
    cos, sin = rope_cos_sin(positions, c.head_dim, c.rope_theta)
    use_flash = c.use_flash_attention and s % min(128, s) == 0 and s >= 16
    flash_lengths = None
    if use_flash and attention_mask is not None:
        flash_lengths = attention_mask.to(torch.int32).sum(dim=-1)
        prefix = torch.arange(s, device=h.device)[None, :] < flash_lengths[:, None]
        if not bool((attention_mask.bool() == prefix).all()):
            use_flash = False
            flash_lengths = None
    mask = (
        torch.zeros((b, 1, 1, 1), dtype=torch.float32, device=h.device)
        if use_flash
        else causal_mask(b, s, attention_mask, dtype=torch.float32, device=h.device)
    )
    layers = {k: params["layers"][k].unbind(0) for k in _LAYER_KEYS}
    rematerialize = remat and torch.is_grad_enabled()
    for l in range(c.num_hidden_layers):
        leaves = [layers[k][l] for k in _LAYER_KEYS]
        saved = None
        if rematerialize and use_flash and remat_policy == "save_attn":
            from llm_qat_torch.ops.flash_attention import AttnSaved

            saved = AttnSaved()

        def body(h, *leaves, saved=saved):
            out, _ = decoder_layer(
                h, dict(zip(_LAYER_KEYS, leaves)), c, mask, cos, sin,
                use_flash=use_flash, flash_lengths=flash_lengths, attn_saved=saved)
            return out.to(h.dtype)

        h = _Remat.apply(body, h, *leaves) if rematerialize else body(h, *leaves)
    return h


def final_hidden(params: Params, config: LlamaConfig, input_ids: torch.Tensor,
                 **kw) -> torch.Tensor:
    """Backbone + final RMSNorm, WITHOUT the lm_head: ``[b, s, H]``. Losses
    that chunk the vocab projection consume this, so the full fp32
    ``[b, s, V]`` logits never exist."""
    h = backbone(params, config, input_ids, **kw)
    return rms_norm(h, params["final_norm"], config.rms_norm_eps)


def forward(params: Params, config: LlamaConfig, input_ids: torch.Tensor,
            **kw) -> torch.Tensor:
    """Causal-LM forward: backbone + final norm + fp lm_head -> fp32 logits
    ``[b, s, vocab]``."""
    h = backbone(params, config, input_ids, **kw)
    return _logits(params, config, h)


def causal_lm_loss_sum(logits: torch.Tensor, labels: torch.Tensor,
                       ignore_index: int = -100) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(nll_sum, valid_token_count)`` of the shifted next-token
    cross-entropy, so callers can aggregate a token-weighted mean."""
    logits = logits[:, :-1, :]
    labels = labels[:, 1:].long()
    valid = labels != ignore_index
    safe = torch.where(valid, labels, torch.zeros_like(labels))
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, safe[..., None])[..., 0]
    return torch.where(valid, nll, torch.zeros_like(nll)).sum(), valid.sum().float()


def causal_lm_loss(logits: torch.Tensor, labels: torch.Tensor,
                   ignore_index: int = -100) -> torch.Tensor:
    """Shifted next-token cross-entropy: mean over valid positions of
    ``-log p(labels[1:] | logits[:-1])``."""
    nll, count = causal_lm_loss_sum(logits, labels, ignore_index)
    return nll / count.clamp(min=1)


# ---------------------------------------------------------------------------
# KV-cache decode path (generation)
# ---------------------------------------------------------------------------


def init_cache(config: LlamaConfig, batch: int, max_len: int, dtype=torch.float32,
               device=None) -> Dict[str, Any]:
    """Fixed-size stacked KV cache ``[L, batch, max_len, kvh, hd]`` on
    ``device`` (``cuda`` unless ``"cpu"`` is passed). Holds the
    *fake-quantized*, RoPE'd K and quantized V exactly as the reference
    caches them (modeling_llama_quant.py:345-350). ``index`` (an int) is the
    write position."""
    from llm_qat_torch.device import resolve_device

    c = config
    shape = (c.num_hidden_layers, batch, max_len, c.kv_heads, c.head_dim)
    dev = resolve_device(device)
    return {"k": torch.zeros(shape, dtype=dtype, device=dev),
            "v": torch.zeros(shape, dtype=dtype, device=dev), "index": 0}


def forward_with_cache(
    params: Params,
    config: LlamaConfig,
    input_ids: torch.Tensor,  # [b, s]: a prompt chunk or one decode token
    cache: Dict[str, Any],
    *,
    dtype=None,
) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Run ``s`` new tokens against the cache (prefill when ``index == 0``,
    decode when ``s == 1``). Returns fp32 logits ``[b, s, vocab]`` and the
    cache with ``index + s``; the K/V tensors are written in place, so the
    cache passed in must not be used again."""
    c = config
    b, s = input_ids.shape
    max_len = cache["k"].shape[2]
    index = int(cache["index"])
    with torch.no_grad():
        h = params["embed"][input_ids]
        if dtype is not None:
            h = h.to(dtype)
        positions = index + torch.arange(s, dtype=torch.int32, device=h.device).expand(b, s)
        cos, sin = rope_cos_sin(positions, c.head_dim, c.rope_theta)
        # additive mask over the fixed-size cache: key j is visible to query
        # i iff j <= index + i (causal over absolute positions)
        kv_pos = torch.arange(max_len, dtype=torch.int32, device=h.device)
        visible = kv_pos[None, None, None, :] <= positions[:, None, :, None]
        zero = torch.zeros((), dtype=torch.float32, device=h.device)
        mask = torch.where(visible, zero, torch.full_like(zero, _NEG_INF))
        layers = {k: params["layers"][k].unbind(0) for k in _LAYER_KEYS}
        for l in range(c.num_hidden_layers):
            lp = {k: layers[k][l] for k in _LAYER_KEYS}
            out, _ = decoder_layer(h, lp, c, mask, cos, sin,
                                   cache_kv=(cache["k"][l], cache["v"][l]), cache_index=index)
            # keep the carry at the activation type (f32 params + bf16 compute)
            h = out.to(h.dtype)
        logits = _logits(params, c, h)
    return logits, {"k": cache["k"], "v": cache["v"], "index": index + s}
