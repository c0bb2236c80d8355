// One-token attention over the paged quantized KV pool, for Hopper (sm_90a):
// K8.
//
// Replaces llm_qat_tpu/ops/pallas/decode_attention.py:_paged_attn_kernel and
// _paged_attn_kernel_fold (quantized_paged_attention). K and V live in a pool
// of pages shared by all slots; a slot maps logical page pg (positions
// pg*P .. pg*P+P-1) to a pool page through its block table. The device
// code, its bound and its design are decode_attn.cuh's, with a chunk = a
// page and a softmax block = a page, as the TPU kernel's grid steps one
// page at a time: items of (slot, live page, kv head) over all SMs, p * vs
// rounded against the running maximum of the pages before and at its own.
// RoPE at the LOGICAL position from the hoisted [hd/2, max_pages*P] tables.
// A slot reads its ceil(len/P) live table entries and none past them.
//
// Layouts: q [b, nh, hd] (f32 or bf16); pool K/V [n_pages, kvh, hd, P] int8
// or [n_pages, kvh, hd/2, P] uint8 (low nibble = rows 0..hd/2-1, high =
// hd/2..hd-1); scales [n_pages, P] f32; lengths [b] int32 (pre-append with
// fold); block tables [b, max_pages] int32; fold as decode_attention.cu.
// Out [b, nh, hd] in q's type. Built for P = 128 and the (G, hd) of
// decode_attn.cuh's kernel_of.

#include "decode_attn.cuh"

// S = CH = BK = P, NC = max_pages, TS = max_pages * P. dtype_code: 0 = f32
// q/out, 1 = bf16. The pool's page count is not an argument: the tables
// index the pool.
extern "C" int paged_attention(DECODE_ATTN_PARAMS) { return decode_attn::run(DECODE_ATTN_ARGS); }

// as decode_attention_attributes
extern "C" int paged_attention_attributes(int* out, int dtype_code, int G, int hd) {
  return decode_attn::attributes(out, dtype_code, G, hd);
}

#ifdef DECODE_ATTN_TRACE
// the last launch's stamps (decode_attn.cuh, DECODE_ATTN_TRACE): host [8][4096]
extern "C" int paged_attention_read_trace(unsigned long long* host) { return decode_attn::read_trace(host); }
#endif
