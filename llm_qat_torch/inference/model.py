"""Serving forward pass: true-int weights, quantized KV cache, ragged batch.

Port of the JAX package's ``inference/model.py`` (scan serving path, one
device). Numerics as in training: K/V quantized per token before RoPE (the
cache holds the integers and per-token inverse scales; RoPE is applied after
dequantization), int8/int4 weight products with per-channel scales, fp32
softmax and RMSNorm, fp lm_head.

Cache layout: K AND V transposed, ``[L, b, kvh, hd, S]`` int8 (or
``[L, b, kvh, hd/2, S]`` uint8 nibble-packed at KV4) with f32 inverse scales
``[L, b, S]``, so the decode kernel reads along S, the contiguous axis.

Where the JAX package returns a new cache from a donated buffer
(``dynamic_update_slice``), the port writes the cache tensors IN PLACE
(``scatter_`` / slice assignment) and returns the same dict with new
``lengths``; each function that does so says it.

Per step: the prefill of fresh slots runs the flash kernel over this call's
own fake-quant K/V. A decode step (s = 1) of the default configuration
(``use_megakernel=True``) goes to ``megakernel.decode_step``, one kernel
launch for all layers, where ``megakernel.supported`` (on the card, also
where ``megakernel.card_takes``: the kernel is built for (8, 64) and
(1, 128) heads, TinyLlama-1.1B's and the LLaMA-7B/13B family's; another
shape decodes on the scan path there); otherwise, and with
``use_megakernel=False``, the scan path here runs the fused decode kernel
per layer over the read-only cache with the current token folded in, then
commits one K/V column per layer and slot. The scan path's layer stack is a
Python loop (JAX: scan).
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from llm_qat_torch.device import check_on, resolve_device
from llm_qat_torch.inference import quantized as Q
from llm_qat_torch.models import llama
from llm_qat_torch.models.config import LlamaConfig
from llm_qat_torch.ops import decode_attention as DA
from llm_qat_torch.ops import qat_matmul
from llm_qat_torch.ops import quant_matmul as QM
from llm_qat_torch.ops.flash_attention import flash_attention

_NEG_INF = -1e9
_CACHE_KEYS = ("k_q", "k_s", "v_q", "v_s")


def init_serving_cache(config: LlamaConfig, batch: int, max_len: int,
                       device=None) -> Dict[str, torch.Tensor]:
    """Quantized KV cache for ``batch`` slots of ``max_len`` positions on
    ``device`` (``cuda`` unless ``device="cpu"``). ``max_len`` must be a
    multiple of 8 (the JAX decode kernel's tiling; kept so caches match)."""
    if max_len % 8:
        raise ValueError(f"serving cache max_len must be a multiple of 8, got {max_len}")
    return _empty_cache(config, batch, max_len, resolve_device(device))


def cache_is_packed(config: LlamaConfig) -> bool:
    """KV4 nibble packing (config.kv_cache_pack at kv_bits <= 4): storage is
    [.., hd/2, S] uint8 for K and V, hd halves split-half packed per byte."""
    return bool(config.kv_cache_pack) and config.kv_bits <= 4


def _empty_cache(config: LlamaConfig, batch: int, max_len: int,
                 device) -> Dict[str, torch.Tensor]:
    c = config
    packed = cache_is_packed(c)
    hd = c.head_dim // 2 if packed else c.head_dim
    qdt = torch.uint8 if packed else torch.int8
    kshape = (c.num_hidden_layers, batch, c.kv_heads, hd, max_len)
    sshape = (c.num_hidden_layers, batch, max_len)
    return {
        "k_q": torch.zeros(kshape, dtype=qdt, device=device),
        "k_s": torch.ones(sshape, dtype=torch.float32, device=device),
        "v_q": torch.zeros(kshape, dtype=qdt, device=device),
        "v_s": torch.ones(sshape, dtype=torch.float32, device=device),
        "lengths": torch.zeros((batch,), dtype=torch.int32, device=device),
    }


def _write_kv(cache_q, cache_s, new, write_pos, kvh, hd, kv_bits, packed=False):
    """Quantize ``new`` [b, s, kvh*hd] per token and write each slot's rows
    at its own offset, IN PLACE, into the transposed cache_q
    [b, kvh, hd(/2), S] and cache_s [b, S]. As with ``dynamic_update_slice``
    the offset is clamped to ``S - s`` so the rows fit. Returns the
    fake-quant value of ``new`` ([b, s, kvh, hd] f32, equal to reading the
    written rows back)."""
    b, s, _ = new.shape
    nq, ns = Q.quantize_kv(new, kv_bits)           # int8 [b,s,kv], [b,s,1]
    inv = (1.0 / (ns + 1e-6))[..., 0]              # [b, s] inverse scales
    fq = (nq.float() * inv[..., None]).reshape(b, s, kvh, hd)
    nq = nq.reshape(b, s, kvh, hd)
    if packed:
        nq = QM.pack_int4(nq, axis=-1)
    nq = nq.permute(0, 2, 3, 1).to(cache_q.dtype)  # [b, kvh, hd(/2), s]
    S = cache_q.shape[-1]
    start = torch.clamp(write_pos.long(), 0, S - s)
    idx = start[:, None] + torch.arange(s, device=new.device)[None, :]  # [b, s]
    cache_q.scatter_(3, idx[:, None, None, :].expand(nq.shape), nq)
    cache_s.scatter_(1, idx, inv)
    return fq


def _quant_kv_cols(new, kvh, hd, kv_bits):
    """Quantize one decode step's K or V per token without touching the
    cache: ``new`` [b, 1, kvh*hd] -> (int8 columns [b, kvh, hd], inverse
    scales [b, 1]). Same integers as ``_write_kv``."""
    b = new.shape[0]
    nq, ns = Q.quantize_kv(new, kv_bits)
    inv = (1.0 / (ns + 1e-6))[:, 0]                # [b, 1]
    return nq[:, 0].reshape(b, kvh, hd), inv


def commit_kv_columns(k_q, k_s, v_q, v_s, k_cols, v_cols, k_invs, v_invs,
                      write_pos, packed):
    """Write one quantized K/V column per (layer, slot) into the stacked
    transposed cache, IN PLACE (slice assignment where the JAX package
    updates a donated buffer): the single small write a decode step makes.

    k_cols/v_cols [L, b, kvh, hd] int8; k_invs/v_invs [L, b, 1] f32;
    write_pos [b] (inactive slots point at the scratch row S-1)."""
    b = k_cols.shape[1]
    if packed:
        k_cols = QM.pack_int4(k_cols, axis=3)
        v_cols = QM.pack_int4(v_cols, axis=3)
    slots = torch.arange(b, device=k_q.device)
    wp = write_pos.long()
    # advanced indices split by slices put the slot dim first: [b, L, kvh, hd]
    k_q[:, slots, :, :, wp] = k_cols.to(k_q.dtype).transpose(0, 1)
    v_q[:, slots, :, :, wp] = v_cols.to(v_q.dtype).transpose(0, 1)
    k_s[:, slots, wp] = k_invs[..., 0]
    v_s[:, slots, wp] = v_invs[..., 0]
    return k_q, k_s, v_q, v_s


def _dequant_transposed(cq, cs, dtype, packed=False):
    """[b, kvh, hd(/2), S] ints + [b, S] -> [b, S, kvh, hd] fp."""
    if packed:
        cq = QM.unpack_int4(cq, axis=-2)
    d = cq.float() * cs[:, None, None, :]
    return d.permute(0, 3, 1, 2).to(dtype)


def _serving_layer(
    h: torch.Tensor,            # [b, s, H]
    lq: Dict[str, Any],         # this layer's quantized params
    config: LlamaConfig,
    positions: torch.Tensor,    # [b, s]
    kv_layer: Tuple[torch.Tensor, ...],
    write_pos: torch.Tensor,    # [b]
    new_len: torch.Tensor,      # [b] valid length after this step's write
    dtype,
    rope_tables=None,           # (cos, sin) [hd/2, max_len] for decode
    from_empty=False,           # active slots prefill at length 0
):
    c = config
    b, s, _ = h.shape
    hd = c.head_dim
    kb = min(c.kv_bits, 8)  # cache storage is int8: >= 8-bit configs quantize at 8
    # flash prefill: active slots start at length 0, so the only visible
    # rows are this call's own fresh K/V
    flash_prefill = (
        from_empty and s > 1 and c.use_prefill_flash and s % min(128, s) == 0
    )
    k_q, k_s, v_q, v_s = kv_layer
    max_len = k_q.shape[-1]
    packed = cache_is_packed(c)
    kvh = k_q.shape[1]

    x = llama.rms_norm(h, lq["attn_norm"], c.rms_norm_eps)
    qkv = Q.quant_linear(x, lq["qkv"], c.w_bits, a_bits=c.a_bits, out_dtype=dtype)
    kv_dim = kvh * hd
    q_dim = qkv.shape[-1] - 2 * kv_dim
    nh = q_dim // hd
    q = qkv[..., :q_dim]
    k = qkv[..., q_dim:q_dim + kv_dim]
    v = qkv[..., q_dim + kv_dim:]

    qcos, qsin = llama.rope_cos_sin(positions, hd, c.rope_theta)
    post_rope = c.kv_cache_rope == "post"
    if post_rope:
        # rotate K at its absolute position BEFORE quantizing
        k = llama.apply_rope(k.reshape(b, s, kvh, hd), qcos, qsin).reshape(b, s, kv_dim)

    fold_decode = s == 1 and c.use_decode_kernel and not flash_prefill
    if fold_decode:
        # quantize the current K/V but don't write: the kernel folds the
        # pair in, and the caller commits all layers' columns afterwards
        k_cols, k_inv = _quant_kv_cols(k, kvh, hd, kb)
        v_cols, v_inv = _quant_kv_cols(v, kvh, hd, kb)
    else:
        fq_k = _write_kv(k_q, k_s, k, write_pos, kvh, hd, kb, packed)
        fq_v = _write_kv(v_q, v_s, v, write_pos, kvh, hd, kb, packed)

    qh = llama.apply_rope(q.reshape(b, s, nh, hd), qcos, qsin)

    if flash_prefill:
        # fake-quant K/V of this call (== the dequantized just-written rows)
        kf, vf = fq_k.to(dtype), fq_v.to(dtype)
        if not post_rope:
            kf = llama.apply_rope(kf, qcos, qsin)
        attn = flash_attention(qh.to(dtype), kf, vf)
    elif fold_decode:
        kc, ksn = rope_tables if rope_tables is not None else (None, None)
        old_len = positions[:, 0]
        attn = DA.quantized_decode_attention(
            qh[:, 0], k_q, k_s, v_q, v_s, old_len, kc, ksn,
            fold=(k_cols, k_inv, v_cols, v_inv, new_len > old_len,
                  qcos[:, 0, :hd // 2], qsin[:, 0, :hd // 2]),
            theta=c.rope_theta, rope=not post_rope, packed=packed,
        ).reshape(b, 1, nh * hd)
    else:
        # plain prefill path: dequantize the cache; "pre" re-applies RoPE
        kd = _dequant_transposed(k_q, k_s, dtype, packed=packed)
        vd = _dequant_transposed(v_q, v_s, dtype, packed=packed)
        cache_pos = torch.arange(max_len, dtype=torch.int32,
                                 device=h.device).expand(b, max_len)
        if not post_rope:
            kcos, ksin = llama.rope_cos_sin(cache_pos, hd, c.rope_theta)
            kd = llama.apply_rope(kd, kcos, ksin)
        kv_valid = cache_pos < new_len[:, None]
        vis = (cache_pos[:, None, :] <= positions[:, :, None]) & kv_valid[:, None, :]
        mask = torch.where(vis, 0.0, _NEG_INF)[:, None].float()
        attn = llama._attend(qh, kd, vd, mask)

    h = h + Q.quant_linear(attn, lq["o"], c.w_bits, a_bits=c.a_bits, out_dtype=dtype)
    x = llama.rms_norm(h, lq["mlp_norm"], c.rms_norm_eps)
    gateup = Q.quant_linear(x, lq["gateup"], c.w_bits, a_bits=c.a_bits, out_dtype=dtype)
    gate, up = gateup.chunk(2, dim=-1)
    x = Q.quant_linear(torch.nn.functional.silu(gate) * up, lq["down"], c.w_bits,
                       a_bits=c.a_bits, out_dtype=dtype)
    if fold_decode:
        return h + x, (k_cols, k_inv, v_cols, v_inv)
    return h + x, None


def _layer_params(layers: Dict[str, Any], i: int) -> Dict[str, Any]:
    """Layer ``i`` of the stacked params (views, no copies)."""
    return {k: ({kk: vv[i] for kk, vv in v.items()} if isinstance(v, dict) else v[i])
            for k, v in layers.items()}


def _forward(qparams, config: LlamaConfig, input_ids, seq_lens, active, cache,
             dtype=torch.bfloat16, from_empty=False):
    """Run ``s`` new tokens for every slot at its own offset. Inactive slots
    compute but don't commit (their rows go to a scratch position and their
    lengths don't advance). The cache tensors are updated IN PLACE; the
    returned dict holds them and the new ``lengths``.

    ``from_empty=True`` asserts every active slot has ``seq_lens == 0`` (the
    engine's prefill contract), enabling the flash prefill."""
    c = config
    b, s = input_ids.shape
    max_len = cache["k_q"].shape[4]
    dev = input_ids.device
    if s == 1 and c.use_megakernel:
        from llm_qat_torch.inference import megakernel

        # configs outside supported() serve via the scan path below, and so,
        # on the card, do those the CUDA kernel is not built for
        if megakernel.supported(c, b, max_len) and (
                dev.type != "cuda" or megakernel.card_takes(c, b, max_len, dtype)):
            return megakernel.decode_step(qparams, c, input_ids, seq_lens, active,
                                          cache, dtype, device=dev)
    h = qparams["embed"][input_ids.long()].to(dtype)
    positions = seq_lens[:, None] + torch.arange(s, dtype=torch.int32, device=dev)[None]
    # inactive slots write into the last row (scratch) and never validate it
    write_pos = torch.where(active, seq_lens, max_len - 1).to(torch.int32)
    new_len = torch.where(active, seq_lens + s, seq_lens).to(torch.int32)

    fold_decode = s == 1 and c.use_decode_kernel
    rope_tables = None
    if fold_decode and c.kv_cache_rope != "post":
        # hoisted decode RoPE tables, transposed [hd/2, S] like the K cache
        hd = c.head_dim
        cache_pos = torch.arange(max_len, dtype=torch.int32, device=dev)[None]
        kcos, ksin = llama.rope_cos_sin(cache_pos, hd, c.rope_theta)
        rope_tables = (kcos[0, :, :hd // 2].T.contiguous(),
                       ksin[0, :, :hd // 2].T.contiguous())

    cols = []
    for i in range(c.num_hidden_layers):
        kv = tuple(cache[k][i] for k in _CACHE_KEYS)
        h, new_cols = _serving_layer(
            h, _layer_params(qparams["layers"], i), c, positions, kv,
            write_pos, new_len, dtype, rope_tables, from_empty,
        )
        cols.append(new_cols)
    if fold_decode:
        # one stacked commit of every layer's current-token columns
        k_cols, k_invs, v_cols, v_invs = (torch.stack(t) for t in zip(*cols))
        commit_kv_columns(cache["k_q"], cache["k_s"], cache["v_q"], cache["v_s"],
                          k_cols, v_cols, k_invs, v_invs, write_pos,
                          cache_is_packed(c))

    return final_logits(h, qparams, c), dict(cache, lengths=new_len)


def final_logits(h: torch.Tensor, qparams, config: LlamaConfig) -> torch.Tensor:
    """Final RMSNorm and the fp lm_head: operands in the model type, fp32
    products and output (the JAX package's ``preferred_element_type=f32``)."""
    h = llama.rms_norm(h, qparams["final_norm"], config.rms_norm_eps)
    head = qparams["lm_head"] if "lm_head" in qparams else qparams["embed"].T
    logits = qat_matmul.mm_f32(h.reshape(-1, h.shape[-1]), head.to(h.dtype))
    return logits.reshape(*h.shape[:-1], logits.shape[-1])


def _as_tensor(x, dtype, device) -> torch.Tensor:
    return torch.as_tensor(x, device=device).to(dtype)


def prefill_slot(qparams, config: LlamaConfig, input_ids, dtype=torch.bfloat16,
                 device=None):
    """Batch prefill from empty: run each row's (bucketed) prompt against a
    temporary ``s``-row cache and return (logits [b, s, V], rows), the rows
    to splice into the persistent cache with ``insert_slot``. Runs on
    ``device`` (``cuda`` unless ``device="cpu"``)."""
    dev = resolve_device(device)
    ids = _as_tensor(input_ids, torch.int64, dev)
    b, s = ids.shape
    cache = _empty_cache(config, b, s, dev)  # prefill-only: no alignment need
    check_on(dev, embed=qparams["embed"])
    return _forward(
        qparams, config, ids, torch.zeros((b,), dtype=torch.int32, device=dev),
        torch.ones((b,), dtype=torch.bool, device=dev), cache, dtype,
        from_empty=True,
    )


def insert_slot(cache: Dict[str, torch.Tensor], rows: Dict[str, torch.Tensor],
                slot: int) -> Dict[str, torch.Tensor]:
    """Splice a batch-1 prefilled cache (``rows``, s positions) into ``slot``
    at position 0 of the persistent cache, IN PLACE (slice assignment where
    the JAX package updates a donated buffer). ``lengths`` stays managed by
    the engine."""
    s = rows["k_q"].shape[-1]
    for k in ("k_q", "v_q"):
        cache[k][:, slot:slot + 1, :, :, :s] = rows[k]
    for k in ("k_s", "v_s"):
        cache[k][:, slot:slot + 1, :s] = rows[k]
    return cache


def serving_forward(qparams, config: LlamaConfig, input_ids, seq_lens, active,
                    cache, dtype=torch.bfloat16, from_empty=False, device=None):
    """One serving step for every slot (see ``_forward``) on ``device``
    (``cuda`` unless ``device="cpu"``); params and cache must lie there.
    Returns (logits [b, s, V] f32, cache) with the cache updated IN PLACE."""
    dev = resolve_device(device)
    check_on(dev, embed=qparams["embed"], k_q=cache["k_q"])
    return _forward(
        qparams, config, _as_tensor(input_ids, torch.int64, dev),
        _as_tensor(seq_lens, torch.int32, dev), _as_tensor(active, torch.bool, dev),
        cache, dtype, from_empty=from_empty,
    )
