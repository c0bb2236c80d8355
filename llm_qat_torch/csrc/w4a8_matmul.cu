// W4A8 GEMM on split-half packed int4 weights, for Hopper (sm_90a).
//
// Replaces llm_qat_tpu/ops/pallas/quant_matmul.py:_w4a8_matmul_kernel
// (int4_matmul). Byte = hi << 4 | lo; the low nibble is weight row k of the
// top half K (k < K/2), the high nibble row k + K/2. The kernel bodies are
// gemm_int8.cuh: each packed word becomes two int8 words (16 x the signed
// nibbles, two logic operations) in registers or shared memory, feeding one
// product against x[:, :K/2] and one against x[:, K/2:]. Hopper has no int4
// tensor-core product, so unpacking to int8 is the design here too.
//
// What bounds it on this card, and what the design does about it:
// * decode rows (M <= 64): the K x N / 2 packed weight bytes. The decode
//   variant splits K over every SM and streams the packed tiles through a
//   4-stage cp.async ring; device memory carries only nibbles.
// * prefill rows (M > 64; the serving path sends W4 products here at every
//   row count): the int8 tensor-core rate. The prefill variant unpacks each
//   packed tile once, on its way into wgmma's register operand (both K
//   halves from one tile), and runs wgmma on 128 x 128 output tiles from a
//   4-stage ring of 64 packed rows, two blocks an SM.

#include "gemm_int8.cuh"

// variant, splits: as int8_matmul (int8_matmul.cu).
extern "C" int w4a8_matmul(const void* x, const void* w, const void* sx, const void* sw,
                           void* out, int M, int N, int K, int variant, int splits,
                           int out_code, void* stream) {
  return gemm_int8::launch<true>(x, w, sx, sw, out, M, N, K, variant, splits,
                                 out_code, stream);
}

// int4_matmul_stacked (replaces llm_qat_tpu/ops/pallas/quant_matmul.py:
// int4_matmul_stacked): the same kernels on layer `layer` of the stacked
// packed weight w_all [L, K/2, N] uint8 and scales sw_all [L, 1, N], read in
// place: only the base pointers move, nothing is copied.
extern "C" int w4a8_matmul_stacked(const void* x, const void* w_all, const void* sx,
                                   const void* sw_all, void* out, int M, int N, int K,
                                   int layer, int variant, int splits, int out_code,
                                   void* stream) {
  const uint8_t* w = (const uint8_t*)w_all + (size_t)layer * (K / 2) * N;
  const float* sw = (const float*)sw_all + (size_t)layer * N;
  return gemm_int8::launch<true>(x, w, sx, sw, out, M, N, K, variant, splits,
                                 out_code, stream);
}

// as int8_matmul_attributes (int8_matmul.cu)
extern "C" int w4a8_matmul_attributes(int* out, int variant, int bm, int out_code) {
  return gemm_int8::attributes<true>(variant, bm, out_code, out);
}

#ifdef GEMM_TRACE
extern "C" int gemm_read_trace(void* host) {
  return gemm_int8::read_trace((unsigned long long*)host);
}
#endif
