// One-token attention over the contiguous quantized KV cache, for Hopper
// (sm_90a): K3 and K7.
//
// Replaces llm_qat_tpu/ops/pallas/decode_attention.py:_decode_attn_kernel
// (quantized_decode_attention, entry point decode_attention) and
// :_decode_attn_stacked_kernel (quantized_decode_attention_stacked, entry
// point decode_attention_stacked: the same attention on layer l of a
// stacked cache [L, b, kvh, hd, S], read in place through base pointers
// offset by the layer, with the stacked fold contract, fold 2). The device
// code, its bound and its design are decode_attn.cuh's: one cooperative
// launch over all SMs, items of (slot, chunk of CH columns, kv head), the
// TPU kernel's online softmax over its bk-column blocks (CH = gcd(128, bk),
// so no chunk straddles a block). Any cache length S that is a multiple of
// 8 (the JAX picker's blocks then tile it).
//
// Layouts: q [b, nh, hd] (f32 or bf16), K/V [b, kvh, hd, S] int8 or
// [b, kvh, hd/2, S] uint8 (low nibble = rows 0..hd/2-1, high = hd/2..hd-1),
// scales [b, S] f32, lengths [b] int32 (pre-append with a fold), RoPE tables
// [hd/2, S] f32; fold 1: k_new/v_new [b, kvh, hd] int8, k_inv/v_inv [b]
// f32, active [b] int32, q_cos/q_sin [b, hd/2] f32. Out [b, nh, hd] in q's
// type. Built for the (G, hd) of decode_attn.cuh's kernel_of.

#include "decode_attn.cuh"

// tables null, NC = S / CH chunks, TS = S. dtype_code: 0 = f32 q/out, 1 = bf16.
extern "C" int decode_attention(DECODE_ATTN_PARAMS) { return decode_attn::run(DECODE_ATTN_ARGS); }

// Layer `layer` of the stacked int8 cache kq_all/vq_all [L, b, kvh, hd, S]
// and scales ks_all/vs_all [L, b, S]: only the base pointers move, nothing
// is copied. k_new/v_new [b, kvh, hd] in q's type (fake-quantized, K
// rotated), include_new [b] int32: the pair's p rounds to q's type before
// p.v and is not zeroed for an excluded pair, as in the TPU kernel.
extern "C" int decode_attention_stacked(const void* q, const void* kq_all, const void* ks_all,
                                        const void* vq_all, const void* vs_all,
                                        const void* lens, const void* kcos, const void* ksin,
                                        const void* k_new, const void* v_new,
                                        const void* include_new, void* out, void* scratch,
                                        int b, int kvh, int G, int hd, int S, int CH, int BK,
                                        int layer, int rope, int dtype_code, float scale,
                                        void* stream) {
  const size_t q_off = (size_t)layer * b * kvh * hd * S, s_off = (size_t)layer * b * S;
  return decode_attn::run(q, static_cast<const uint8_t*>(kq_all) + q_off,
                          static_cast<const float*>(ks_all) + s_off,
                          static_cast<const uint8_t*>(vq_all) + q_off,
                          static_cast<const float*>(vs_all) + s_off, lens, nullptr, kcos, ksin,
                          k_new, nullptr, v_new, nullptr, include_new, nullptr, nullptr, out,
                          scratch, b, kvh, G, hd, S, CH, BK, S / CH, S, 0, rope, 2, dtype_code,
                          scale, stream);
}

// {registers, static shared bytes, dynamic shared bytes, spill bytes,
// threads a block, blocks an SM holds} of the (dtype_code, G, hd) variant.
extern "C" int decode_attention_attributes(int* out, int dtype_code, int G, int hd) {
  return decode_attn::attributes(out, dtype_code, G, hd);
}

#ifdef DECODE_ATTN_TRACE
// the last launch's stamps (decode_attn.cuh, DECODE_ATTN_TRACE): host [8][4096]
extern "C" int decode_attention_read_trace(unsigned long long* host) { return decode_attn::read_trace(host); }
#endif
