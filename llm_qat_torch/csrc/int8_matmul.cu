// int8 x int8 -> int32 GEMM with the scale epilogue, for Hopper (sm_90a).
//
// Replaces llm_qat_tpu/ops/pallas/quant_matmul.py:_int8_matmul_kernel
// (int8_matmul). The kernel body is gemm_int8.cuh with int8 weights.
//
// Bound on this card: at decode (M = 8 slots, padded to 32 rows) the work is
// 2*M*K*N int8 operations against K*N weight bytes, about 64 operations per
// byte, far below the H100's ~590 int8 operations per byte of device memory:
// the kernel is bound by the weight bytes. Its design reads each weight byte
// from device memory once per 64-row tile (once in all at decode) and keeps
// the int32 sums in registers; what it does not do yet is keep enough loads
// in flight (no cp.async / TMA pipeline, 64-column blocks), which a later
// change adds.

#include "gemm_int8.cuh"

extern "C" int int8_matmul(const void* x, const void* w, const void* sx, const void* sw,
                           void* out, int M, int N, int K, int out_code, void* stream) {
  return gemm_int8::launch<false>(x, w, sx, sw, out, M, N, K, out_code, stream);
}

// int8_matmul_stacked (replaces llm_qat_tpu/ops/pallas/quant_matmul.py:
// int8_matmul_stacked): the same kernel on layer `layer` of the stacked
// weight w_all [L, K, N] int8 and scales sw_all [L, 1, N], read in place:
// only the base pointers move, nothing is copied.
extern "C" int int8_matmul_stacked(const void* x, const void* w_all, const void* sx,
                                   const void* sw_all, void* out, int M, int N, int K,
                                   int layer, int out_code, void* stream) {
  const int8_t* w = (const int8_t*)w_all + (size_t)layer * K * N;
  const float* sw = (const float*)sw_all + (size_t)layer * N;
  return gemm_int8::launch<false>(x, w, sx, sw, out, M, N, K, out_code, stream);
}
