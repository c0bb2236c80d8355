// bf16 tensor-core building blocks shared by flash_attention.cu (K4) and
// flash_attention_bwd.cu (K11): cp.async tile copies into a swizzled shared
// layout, ldmatrix fragment loads and mma.sync m16n8k16 (bf16 x bf16 ->
// fp32).
//
// Tiles are [rows][D] bf16, D a multiple of 64, one row 2 * D bytes. The
// 16-byte chunk ch of row r lives at chunk ch ^ (r % 8): the 8 rows that one
// ldmatrix 8 x 8 matrix reads then fall in 8 different bank groups.
//
// Fragment addresses (lane l of a warp; each ldmatrix.x4 loads four 8 x 8
// matrices, lanes 8i..8i+7 giving the row addresses of matrix i):
//   a_addr: the A operand (16 rows x 16 deep) of rows [r0, r0 + 16), depth
//     chunk kc (elements [16 kc, 16 kc + 16)) of a row-major tile;
//   b_addr: the B operands of two 8-column tiles (rows [n0, n0 + 16) of a
//     tile stored [n][depth]), depth chunk kc: registers 0, 1 for columns
//     n0..n0+7, 2, 3 for n0+8..n0+15;
//   t_addr: the same from a tile stored [depth][n], for ldmatrix.trans
//     (depth rows [16 kc, 16 kc + 16), column chunks 2 np and 2 np + 1).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tc_bf16 {

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, zero-filled when !in (src is then not read)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(in ? 16 : 0));
}
// 4 bytes global -> shared, zero-filled when !in
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(in ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// c += a (16 x 16, row) . b (16 x 8, col), bf16 operands, fp32 sums
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats rounded to bf16 (round to nearest even), the first in the low half
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// the A fragment of accumulator columns [16c, 16c + 16): an m16n8 fp32
// accumulator pair, rounded to bf16, is the A operand of the next product
// (the FlashAttention-2 register layout)
__device__ __forceinline__ void acc_to_a(const float (&lo)[4], const float (&hi)[4],
                                         uint32_t (&a)[4]) {
  a[0] = pack(lo[0], lo[1]);
  a[1] = pack(lo[2], lo[3]);
  a[2] = pack(hi[0], hi[1]);
  a[3] = pack(hi[2], hi[3]);
}

template <int D>
__device__ __forceinline__ uint32_t swz(int r, int ch) {
  return (uint32_t)(r * D * 2 + ((ch ^ (r & 7)) << 4));
}

// rows [r0, r0 + ROWS) of a [nrows, D] bf16 matrix into a swizzled tile at
// dst, zeros past nrows; NTHREADS threads share the copies
template <int D, int ROWS, int NTHREADS>
__device__ __forceinline__ void load_tile(uint32_t dst, const bf16* src, int r0, int nrows) {
  constexpr int CH = D / 8;
  for (int i = threadIdx.x; i < ROWS * CH; i += NTHREADS) {
    const int r = i / CH, ch = i % CH;
    const bool in = r0 + r < nrows;
    cp_async16(dst + swz<D>(r, ch), src + (size_t)(in ? r0 + r : 0) * D + ch * 8, in);
  }
}

// fragment addresses (see the header)
template <int D>
__device__ __forceinline__ uint32_t a_addr(uint32_t tile, int r0, int kc, int lane) {
  return tile + swz<D>(r0 + (lane & 7) + (((lane >> 3) & 1) << 3), kc * 2 + (lane >> 4));
}
template <int D>
__device__ __forceinline__ uint32_t b_addr(uint32_t tile, int n0, int kc, int lane) {
  return tile + swz<D>(n0 + (lane & 7) + ((lane >> 4) << 3), kc * 2 + ((lane >> 3) & 1));
}
template <int D>
__device__ __forceinline__ uint32_t t_addr(uint32_t tile, int kc, int np, int lane) {
  return tile + swz<D>(kc * 16 + (lane & 7) + (((lane >> 3) & 1) << 3), np * 2 + (lane >> 4));
}

// what the compiler gave a kernel, for the record: out = {registers a
// thread, static shared bytes, dynamic shared bytes, local (spill) bytes a
// thread, threads a block, blocks an SM can hold}. Launches nothing.
template <typename Kern>
int attributes(Kern kern, int threads, int smem, int* out) {
  if (int e = (int)cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem))
    return e;
  cudaFuncAttributes a;
  if (int e = (int)cudaFuncGetAttributes(&a, kern)) return e;
  int per_sm = 0;
  if (int e = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, threads, smem))
    return e;
  out[0] = a.numRegs;
  out[1] = (int)a.sharedSizeBytes;
  out[2] = smem;
  out[3] = (int)a.localSizeBytes;
  out[4] = threads;
  out[5] = per_sm;
  return 0;
}

}  // namespace tc_bf16
