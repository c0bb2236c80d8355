// int8 x int8 -> int32 GEMM with the scale epilogue, for Hopper (sm_90a).
//
// Replaces llm_qat_tpu/ops/pallas/quant_matmul.py:_int8_matmul_kernel
// (int8_matmul). The kernel bodies are gemm_int8.cuh with int8 weights.
//
// What bounds it on this card, and what the design does about it:
// * decode rows (M <= 64; the engine pads 8 slots to 32 rows): 2 M int8
//   operations a weight byte, far below the H100's ~590 a byte of device
//   memory, so the K x N weight bytes bound it. The decode variant splits K
//   until the grid covers every SM, keeps 4 stages of 8 KB weight tiles in
//   flight a block through a cp.async ring, and sums the split partials
//   exactly (int32) across the tile's cluster in distributed shared memory.
// * prefill rows (M > 64): the int8 tensor-core rate bounds it. The prefill
//   variant runs wgmma on 128 x 128 tiles from a 3-stage ring, two blocks an
//   SM, the weight tile turned K-contiguous on its way into registers (the
//   register operand of wgmma, with x the shared-memory one). The serving
//   path sends W8 products of 128 rows and more to the library int8 GEMM,
//   as the JAX package sends them to XLA; this variant serves direct calls.

#include "gemm_int8.cuh"

// variant: 0 decode (M <= 64), 1 prefill; splits: blocks a tile along K (a
// cluster, at most 8).
extern "C" int int8_matmul(const void* x, const void* w, const void* sx, const void* sw,
                           void* out, int M, int N, int K, int variant, int splits,
                           int out_code, void* stream) {
  return gemm_int8::launch<false>(x, w, sx, sw, out, M, N, K, variant, splits,
                                  out_code, stream);
}

// int8_matmul_stacked (replaces llm_qat_tpu/ops/pallas/quant_matmul.py:
// int8_matmul_stacked): the same kernels on layer `layer` of the stacked
// weight w_all [L, K, N] int8 and scales sw_all [L, 1, N], read in place:
// only the base pointers move, nothing is copied.
extern "C" int int8_matmul_stacked(const void* x, const void* w_all, const void* sx,
                                   const void* sw_all, void* out, int M, int N, int K,
                                   int layer, int variant, int splits, int out_code,
                                   void* stream) {
  const int8_t* w = (const int8_t*)w_all + (size_t)layer * K * N;
  const float* sw = (const float*)sw_all + (size_t)layer * N;
  return gemm_int8::launch<false>(x, w, sx, sw, out, M, N, K, variant, splits,
                                  out_code, stream);
}

// out = {registers, static smem, dynamic smem, spill bytes, threads, blocks
// an SM holds} of one variant (bm: 32 or 64 for decode, 128 for prefill).
extern "C" int int8_matmul_attributes(int* out, int variant, int bm, int out_code) {
  return gemm_int8::attributes<false>(variant, bm, out_code, out);
}

#ifdef GEMM_TRACE
extern "C" int gemm_read_trace(void* host) {
  return gemm_int8::read_trace((unsigned long long*)host);
}
#endif
