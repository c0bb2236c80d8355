"""Paged quantized KV cache (paged-attention-style block tables).

Port of the JAX package's ``inference/paged.py`` (one device). Instead of one
contiguous ``[b, max_len]`` region per slot (``inference/model.py``), K/V live
in a global pool of fixed-size **pages** shared by all slots,
``[L, n_pages, kvh, hd, page_size]`` int8 (``[.., hd/2, page_size]`` uint8
nibble-packed at KV4) with per-token inverse scales ``[L, n_pages,
page_size]``, and each slot maps logical positions to pages through a block
table. Capacity is pooled: total tokens = n_pages x page_size however they
spread over slots, so long and short requests mix without reserving the
worst case for each.

The attention math is that of the contiguous path (same pre-RoPE int8
storage, per-token scales, fp32 softmax). A decode step (s = 1) with
``config.use_decode_kernel`` runs the paged decode-attention kernel
(``ops/decode_attention.py:quantized_paged_attention``) over the read-only
pool with the current token folded in, then commits one K/V column per layer
and slot. Which path a call takes (``_paged_fold_capable``): on the CPU the
fold path runs the kernel's plain version at any page size; on the GPU it
launches the kernel when ``page_size % 128 == 0`` and otherwise, as for every
``s > 1`` call that is not a flash prefill from empty, gathers the slot's
pages (``_gather_dequant``) and attends with the plain attention.

Where the JAX package returns a new pool from a donated buffer, the port
writes the pool tensors IN PLACE and returns the same dict; each function
that does so says it. ``tp_group`` is ``model.py``'s: the pool holds this
rank's kv heads, the block tables are the same on every rank.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import torch

from llm_qat_torch.device import check_on, resolve_device
from llm_qat_torch.inference import model as M
from llm_qat_torch.inference import quantized as Q
from llm_qat_torch.models import llama
from llm_qat_torch.models.config import LlamaConfig
from llm_qat_torch.ops import decode_attention as DA
from llm_qat_torch.ops import quant_matmul as QM
from llm_qat_torch.ops.flash_attention import flash_attention

_NEG_INF = -1e9
_POOL_KEYS = ("k_q", "k_s", "v_q", "v_s")


@dataclasses.dataclass(frozen=True)
class PagedConfig:
    # 128 on the GPU: the paged kernel is built for that page size, and other
    # sizes take the gather path there (any size runs on the CPU)
    page_size: int = 128
    n_pages: int = 256
    max_pages_per_seq: int = 32

    @property
    def max_seq_len(self) -> int:
        return self.page_size * self.max_pages_per_seq


def init_paged_cache(config: LlamaConfig, pcfg: PagedConfig,
                     device=None, kv_heads: int = None) -> Dict[str, torch.Tensor]:
    """The page pool on ``device`` (``cuda`` unless ``device="cpu"``). K AND
    V pages are stored transposed, ``[L, n_pages, kvh, hd, P]``, so the decode
    kernel reads along the page, the contiguous axis. With
    ``config.kv_cache_pack`` and ``kv_bits <= 4`` the pool nibble-packs:
    ``[.., hd/2, P]`` uint8, split-half along hd (the contiguous cache's
    scheme, ``model.cache_is_packed``). ``kv_heads``: the heads a
    tensor-parallel rank holds (default: all)."""
    dev = resolve_device(device)
    c = config
    packed = M.cache_is_packed(c)
    hd = c.head_dim // 2 if packed else c.head_dim
    qdt = torch.uint8 if packed else torch.int8
    kshape = (c.num_hidden_layers, pcfg.n_pages, kv_heads or c.kv_heads, hd, pcfg.page_size)
    sshape = (c.num_hidden_layers, pcfg.n_pages, pcfg.page_size)
    return {
        "k_q": torch.zeros(kshape, dtype=qdt, device=dev),
        "k_s": torch.ones(sshape, dtype=torch.float32, device=dev),
        "v_q": torch.zeros(kshape, dtype=qdt, device=dev),
        "v_s": torch.ones(sshape, dtype=torch.float32, device=dev),
    }


def _write_pool(pool_q, pool_s, new, pages, offsets, kvh, hd, kv_bits, packed=False,
                group=None):
    """Quantize ``new`` [b, s, kvh*hd] per token and scatter the rows, IN
    PLACE, into the transposed pool at (page, offset): pool_q
    [np, kvh, hd(/2), P] (``packed`` nibble-packs split-half along hd first),
    pool_s [np, P]. Inactive slots all aim at the scratch page, several at
    one offset: which of them lands is not defined, and nothing reads that
    page. Returns the fake-quant value of ``new`` ([b, s, kvh, hd] f32, equal
    to gathering the written rows back out of the pool). ``group``: as
    ``model._write_kv``'s."""
    b, s, _ = new.shape
    nq, ns = Q.quantize_kv(new, kv_bits, Q.token_absmax(new, group))
    inv = (1.0 / (ns + 1e-6))[..., 0]                    # [b, s]
    fq = (nq.float() * inv[..., None]).reshape(b, s, kvh, hd)
    nq = nq.reshape(b * s, kvh, hd)
    if packed:
        nq = QM.pack_int4(nq, axis=-1)                   # [n, kvh, hd/2]
    pg = pages.reshape(-1).long()
    of = offsets.reshape(-1).long()
    # advanced indices split by slices put the row dim first: [n, kvh, hd(/2)]
    pool_q[pg, :, :, of] = nq.to(pool_q.dtype)
    pool_s[pg, of] = inv.reshape(-1)
    return fq


def _gather_dequant(pool_q, pool_s, block_tables, dtype, packed=False):
    """Transposed pool + block table -> [b, max_tok, kvh, hd] (whole tables
    are gathered, unused entries included; the caller masks by length)."""
    b, mp = block_tables.shape
    bt = block_tables.long()
    g = pool_q[bt]                                       # [b, mp, kvh, hd(/2), P]
    s = pool_s[bt]                                       # [b, mp, P]
    if packed:
        g = QM.unpack_int4(g, axis=-2)
    d = g.float() * s[:, :, None, None, :]
    d = d.permute(0, 1, 4, 2, 3)                         # [b, mp, P, kvh, hd]
    P = d.shape[2]
    return d.reshape(b, mp * P, *d.shape[3:]).to(dtype)


def _paged_layer(
    h: torch.Tensor,              # [b, s, H]
    lq: Dict[str, Any],
    config: LlamaConfig,
    pcfg: PagedConfig,
    positions: torch.Tensor,      # [b, s]
    block_tables: torch.Tensor,   # [b, max_pages] page ids (unused entries 0)
    kv_pool: Tuple[torch.Tensor, ...],
    write_pages: torch.Tensor,    # [b, s] destination page id per new token
    write_offsets: torch.Tensor,  # [b, s] destination offset per new token
    new_len: torch.Tensor,        # [b] valid length after this step's write
    dtype,
    fold_decode: bool,            # decided once, by ``_forward``
    rope_tables=None,             # (cos, sin) [hd/2, max_tok] hoisted for decode
    from_empty=False,             # active slots prefill at seq_len 0
    tp_group=None,                # the tensor-parallel group (model.py)
):
    c = config
    b, s, _ = h.shape
    hd = c.head_dim
    P = pcfg.page_size
    kb = min(c.kv_bits, 8)  # pool storage is int8: >= 8-bit configs quantize at 8
    # flash prefill (see model._serving_layer): from-empty slots see only
    # this call's own fresh K/V, so the whole-table gather is skipped
    flash_prefill = (
        from_empty and s > 1 and c.use_prefill_flash and s % min(128, s) == 0
    )
    k_q, k_s, v_q, v_s = kv_pool
    kvh = k_q.shape[1]
    packed = M.cache_is_packed(c)

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
        # post-RoPE pool: rotate K at its absolute position BEFORE quantizing
        k = llama.apply_rope(k.reshape(b, s, kvh, hd), qcos, qsin).reshape(b, s, kv_dim)

    if fold_decode:
        # the pool stays read-only inside the layer loop: the current pair
        # rides the kernel's fold operands and the caller commits every
        # layer's columns afterwards
        k_cols, k_inv = M._quant_kv_cols(k, kvh, hd, kb, tp_group)
        v_cols, v_inv = M._quant_kv_cols(v, kvh, hd, kb, tp_group)
    else:
        fq_k = _write_pool(k_q, k_s, k, write_pages, write_offsets, kvh, hd, kb, packed,
                           tp_group)
        fq_v = _write_pool(v_q, v_s, v, write_pages, write_offsets, kvh, hd, kb, packed,
                           tp_group)

    qh = llama.apply_rope(q.reshape(b, s, nh, hd), qcos, qsin)

    if flash_prefill:
        kf, vf = fq_k.to(dtype), fq_v.to(dtype)
        if not post_rope:
            kf = llama.apply_rope(kf, qcos, qsin)
        attn = flash_attention(qh.to(dtype), kf, vf)
    elif fold_decode:
        kc, ksn = rope_tables if rope_tables is not None else (None, None)
        old_len = positions[:, 0]
        attn = DA.quantized_paged_attention(
            qh[:, 0], k_q, k_s, v_q, v_s, old_len, block_tables, kc, ksn,
            fold=(k_cols, k_inv, v_cols, v_inv, new_len > old_len,
                  qcos[:, 0, :hd // 2], qsin[:, 0, :hd // 2]),
            theta=c.rope_theta, rope=not post_rope, packed=packed,
        ).reshape(b, 1, nh * hd)
    else:
        max_tok = block_tables.shape[1] * P
        kd = _gather_dequant(k_q, k_s, block_tables, dtype, packed=packed)
        vd = _gather_dequant(v_q, v_s, block_tables, dtype, packed=packed)
        cache_pos = torch.arange(max_tok, dtype=torch.int32,
                                 device=h.device).expand(b, max_tok)
        if not post_rope:
            kcos, ksin = llama.rope_cos_sin(cache_pos, hd, c.rope_theta)
            kd = llama.apply_rope(kd, kcos, ksin)
        kv_valid = cache_pos < new_len[:, None]
        vis = (cache_pos[:, None, :] <= positions[:, :, None]) & kv_valid[:, None, :]
        mask = torch.where(vis, 0.0, _NEG_INF)[:, None].float()
        attn = llama._attend(qh, kd, vd, mask)

    return M._post_attention(h, attn, lq, c, dtype, tp_group), (
        (k_cols, k_inv, v_cols, v_inv) if fold_decode else None)


def _paged_fold_capable(c: LlamaConfig, pcfg: PagedConfig, device) -> bool:
    """Can a decode step fold through the paged kernel? On the CPU its plain
    version takes any page size; the CUDA kernel is built for pages of 128."""
    return bool(c.use_decode_kernel) and (
        pcfg.page_size % 128 == 0 or torch.device(device).type == "cpu"
    )


def _commit_pool_columns(pool_q, pool_s, cols, invs, pages, offsets, packed):
    """Write one quantized column per (layer, slot) into the shared page
    pool, IN PLACE: one indexed write for all slots (the JAX package updates
    a donated buffer slot by slot), ``pages``/``offsets`` staying on the
    device. The single small write a paged decode step makes.

    cols [L, b, kvh, hd] int8; invs [L, b, 1] f32; pages/offsets [b]."""
    nq = cols
    if packed:
        nq = QM.pack_int4(nq, axis=-1)                   # [L, b, kvh, hd/2]
    pg, of = pages.long(), offsets.long()
    # advanced indices split by slices put the slot dim first: [b, L, kvh, hd]
    pool_q[:, pg, :, :, of] = nq.to(pool_q.dtype).transpose(0, 1)
    pool_s[:, pg, of] = invs[..., 0]
    return pool_q, pool_s


def _forward(qparams, config: LlamaConfig, pcfg: PagedConfig, input_ids, seq_lens,
             active, block_tables, cache, dtype=torch.bfloat16, from_empty=False,
             tp_group=None):
    """Paged counterpart of ``model._forward``. The host must have assigned
    enough pages in ``block_tables`` to cover ``seq_lens + s``. Inactive
    slots write into page ``n_pages - 1`` (reserved scratch) and don't
    advance. The pool tensors are updated IN PLACE; the returned dict holds
    them.

    ``from_empty=True`` asserts every active slot has ``seq_lens == 0`` (the
    engine's prefill contract), enabling the flash prefill. Because writes
    scatter straight into the shared pool, prefilling one slot is this call
    with ``b == 1``."""
    c = config
    b, s = input_ids.shape
    P = pcfg.page_size
    dev = input_ids.device

    h = qparams["embed"][input_ids.long()].to(dtype)
    positions = seq_lens[:, None] + torch.arange(s, dtype=torch.int32, device=dev)[None]

    # destination (page, offset) of each new token
    page_idx = torch.div(positions, P, rounding_mode="floor")    # logical page
    offsets = positions % P
    pages = torch.gather(
        block_tables, 1, page_idx.clamp(0, block_tables.shape[1] - 1).long()
    )
    scratch = pcfg.n_pages - 1
    pages = torch.where(active[:, None], pages, scratch)
    new_len = torch.where(active, seq_lens + s, seq_lens).to(torch.int32)

    # the one place that decides whether this call folds through the kernel
    fold_decode = s == 1 and _paged_fold_capable(c, pcfg, dev)
    rope_tables = None
    if fold_decode and c.kv_cache_rope != "post":
        # hoisted decode RoPE tables at LOGICAL positions, transposed
        # [hd/2, max_tok] like the K pages
        hd = c.head_dim
        max_tok = block_tables.shape[1] * P
        cache_pos = torch.arange(max_tok, dtype=torch.int32, device=dev)[None]
        kcos, ksin = llama.rope_cos_sin(cache_pos, hd, c.rope_theta)
        rope_tables = (kcos[0, :, :hd // 2].T.contiguous(),
                       ksin[0, :, :hd // 2].T.contiguous())

    cols = []
    for i in range(c.num_hidden_layers):
        kv = tuple(cache[k][i] for k in _POOL_KEYS)
        h, new_cols = _paged_layer(
            h, M._layer_params(qparams["layers"], i), c, pcfg, positions,
            block_tables, kv, pages, offsets, new_len, dtype, fold_decode,
            rope_tables, from_empty, tp_group,
        )
        cols.append(new_cols)
    if fold_decode:
        k_cols, k_invs, v_cols, v_invs = (torch.stack(t) for t in zip(*cols))
        packed = M.cache_is_packed(c)
        wp, wo = pages[:, 0], offsets[:, 0]
        _commit_pool_columns(cache["k_q"], cache["k_s"], k_cols, k_invs, wp, wo, packed)
        _commit_pool_columns(cache["v_q"], cache["v_s"], v_cols, v_invs, wp, wo, packed)

    return M.final_logits(h, qparams, c, tp_group), cache


def paged_forward(qparams, config: LlamaConfig, pcfg: PagedConfig, input_ids,
                  seq_lens, active, block_tables, cache, dtype=torch.bfloat16,
                  from_empty=False, device=None, tp_group=None):
    """One paged serving step for every slot (see ``_forward``) on ``device``
    (``cuda`` unless ``device="cpu"``); params and pool must lie there.
    Returns (logits [b, s, V] f32, pool) with the pool updated IN PLACE."""
    dev = resolve_device(device)
    check_on(dev, embed=qparams["embed"], k_q=cache["k_q"])
    return _forward(
        qparams, config, pcfg, M._as_tensor(input_ids, torch.int64, dev),
        M._as_tensor(seq_lens, torch.int32, dev), M._as_tensor(active, torch.bool, dev),
        M._as_tensor(block_tables, torch.int32, dev), cache, dtype,
        from_empty=from_empty, tp_group=tp_group,
    )


class PageAllocator:
    """Host-side free list of pages. Page ``n_pages - 1`` is reserved as the
    scratch page for inactive slots' writes."""

    def __init__(self, pcfg: PagedConfig):
        self.pcfg = pcfg
        self.free = list(range(pcfg.n_pages - 1))

    def alloc(self, n: int):
        if n > len(self.free):
            raise MemoryError(f"paged KV pool exhausted (need {n}, have {len(self.free)})")
        return [self.free.pop() for _ in range(n)]

    def release(self, pages):
        self.free.extend(int(p) for p in pages)

    @property
    def available(self) -> int:
        return len(self.free)
