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
