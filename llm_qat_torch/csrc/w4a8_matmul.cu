// W4A8 GEMM on split-half packed int4 weights, for Hopper (sm_90a).
//
// Replaces llm_qat_tpu/ops/pallas/quant_matmul.py:_w4a8_matmul_kernel
// (int4_matmul). Byte = hi << 4 | lo; the low nibble is weight row k of the
// top half K (k < K/2), the high nibble row k + K/2. The kernel body is
// gemm_int8.cuh: nibbles are sign-extended to int8 in registers and feed two
// int8 mma streams, against x[:, :K/2] and x[:, K/2:]. Hopper has no int4
// tensor-core product, so unpacking to int8 is the design here too.
//
// Bound on this card: at decode the weight bytes (K*N/2) bound it, as for
// the int8 kernel, with half the bytes; at prefill (M >= 128 rows) the int8
// tensor-core rate does. The design reads each packed byte once per 64-row
// tile and unpacks it in registers, so device memory carries only nibbles.

#include "gemm_int8.cuh"

extern "C" int w4a8_matmul(const void* x, const void* w, const void* sx, const void* sw,
                           void* out, int M, int N, int K, int out_code, void* stream) {
  return gemm_int8::launch<true>(x, w, sx, sw, out, M, N, K, out_code, stream);
}

// int4_matmul_stacked (replaces llm_qat_tpu/ops/pallas/quant_matmul.py:
// int4_matmul_stacked): the same kernel on layer `layer` of the stacked
// packed weight w_all [L, K/2, N] uint8 and scales sw_all [L, 1, N], read in
// place: only the base pointers move, nothing is copied.
extern "C" int w4a8_matmul_stacked(const void* x, const void* w_all, const void* sx,
                                   const void* sw_all, void* out, int M, int N, int K,
                                   int layer, int out_code, void* stream) {
  const uint8_t* w = (const uint8_t*)w_all + (size_t)layer * (K / 2) * N;
  const float* sw = (const float*)sw_all + (size_t)layer * N;
  return gemm_int8::launch<true>(x, w, sx, sw, out, M, N, K, out_code, stream);
}
