// One-token attention over the quantized KV cache, for Hopper (sm_90a): K3,
// K7 and K8, three entry points of one set of kernels.
//
// decode_attention replaces
// llm_qat_tpu/ops/pallas/decode_attention.py:_decode_attn_kernel
// (quantized_decode_attention): the contiguous cache. decode_attention_stacked
// replaces :_decode_attn_stacked_kernel (quantized_decode_attention_stacked:
// the same attention on layer l of a stacked cache [L, b, kvh, hd, S], read
// in place through base pointers offset by the layer, with the stacked fold
// contract, fold 2). paged_attention replaces :_paged_attn_kernel and
// :_paged_attn_kernel_fold (quantized_paged_attention): K and V in a pool of
// pages shared by all slots, a slot mapping logical page pg (positions pg*P
// .. pg*P+P-1) to a pool page through its block table, a chunk and a softmax
// block one page, as the TPU kernel's grid steps one page at a time; RoPE at
// the LOGICAL position; a slot reads its ceil(len/P) live table entries and
// none past them. The device code, its bound and its design are
// decode_attn.cuh's: one cooperative launch over all SMs, items of (slot,
// chunk of CH columns, kv head), the TPU kernel's online softmax over its
// bk-column blocks (CH = gcd(128, bk), so no chunk straddles a block). The
// contiguous cache: any length S that is a multiple of 8 (the JAX picker's
// blocks then tile it); the pool: pages of P = 128. One source builds the
// kernels once for the three entries.
//
// Layouts: q [b, nh, hd] (f32 or bf16), K/V [b, kvh, hd, S] int8 or
// [b, kvh, hd/2, S] uint8 (low nibble = rows 0..hd/2-1, high = hd/2..hd-1),
// scales [b, S] f32 (pool: K/V [n_pages, kvh, hd(/2), P], scales [n_pages,
// P], block tables [b, max_pages] int32), lengths [b] int32 (pre-append with
// a fold), RoPE tables [hd/2, S] f32 (pool: [hd/2, max_pages * P]); fold 1:
// k_new/v_new [b, kvh, hd] int8, k_inv/v_inv [b] f32, active [b] int32,
// q_cos/q_sin [b, hd/2] f32. Out [b, nh, hd] in q's type. G = 1..16 query
// heads a kv head (decode_attn.cuh kernel_of). The entry points are
// decode_attn.cuh's; this source builds them at head dim 64, and
// decode_attention_d16.cu, _d32.cu and _d128.cu at the other head dims, so
// the four compile side by side.

#define DECODE_ATTN_HD 64
#include "decode_attn.cuh"
