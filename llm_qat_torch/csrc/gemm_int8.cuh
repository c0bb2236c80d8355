// Int8 tensor-core GEMM with the per-token x per-channel scale epilogue,
// shared by int8_matmul.cu (int8 weights) and w4a8_matmul.cu (split-half
// packed int4 weights).
//
//   out[m, n] = float(sum_k xq[m, k] * wq[k, n]) * (1 / ((sx[m] + 1e-6) * (sw[n] + 1e-6)))
//
// Layouts (the JAX package's): xq [M, K] int8 row-major, weights [K, N]
// ([in, out]) int8, or [K/2, N] uint8 whose low nibble holds row k and high
// nibble row k + K/2, sx [M] f32, sw [N] f32, out [M, N] f32 or bf16.
//
// Design: one block of 128 threads (4 warps, 2 x 2) computes a 64 x 64
// output tile with mma.sync m16n8k32 (s8 x s8 -> s32). The weight tile is
// read from device memory once, 4 bytes a thread along N (coalesced), and
// transposed in registers (__byte_perm) into the K-contiguous words that the
// mma B operand wants. For int4 the nibbles are sign-extended to int8 in
// registers (__vsub4); Hopper has no int4 mma. Loads are not pipelined yet:
// a simple kernel that is right first.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace gemm_int8 {

constexpr int BM = 64, BN = 64, BK = 64;   // BK: int8 columns of x per tile
constexpr int THREADS = 128;
constexpr int SROW = BK / 4 + 4;           // 32-bit words per smem row, padded
constexpr float EPS = 1e-6f;

__device__ __forceinline__ void mma_s8(int* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// r[j] holds 4 bytes of row k+j (columns n..n+3); returns c[i] = the 4 bytes
// of column n+i (rows k..k+3).
__device__ __forceinline__ void transpose4x4(const uint32_t* r, uint32_t* c) {
  uint32_t t0 = __byte_perm(r[0], r[1], 0x5140);
  uint32_t t1 = __byte_perm(r[0], r[1], 0x7362);
  uint32_t t2 = __byte_perm(r[2], r[3], 0x5140);
  uint32_t t3 = __byte_perm(r[2], r[3], 0x7362);
  c[0] = __byte_perm(t0, t2, 0x5410);
  c[1] = __byte_perm(t0, t2, 0x7632);
  c[2] = __byte_perm(t1, t3, 0x5410);
  c[3] = __byte_perm(t1, t3, 0x7632);
}

// Sign-extend the 4-bit fields (bits 0-3 of each byte of w) to int8 bytes.
__device__ __forceinline__ uint32_t sext_nibbles(uint32_t w) {
  return __vsub4((w & 0x0F0F0F0Fu) ^ 0x08080808u, 0x08080808u);
}

// Copy rows [m0, m0 + BM) x columns [k0, k0 + BK) of x into s (zero rows >= M).
__device__ __forceinline__ void load_x_tile(const int8_t* __restrict__ x, int M, int K,
                                            int m0, int k0, uint32_t (*s)[SROW]) {
  for (int idx = threadIdx.x; idx < BM * (BK / 16); idx += THREADS) {
    int row = idx / (BK / 16), chunk = idx % (BK / 16);
    uint4 v = make_uint4(0, 0, 0, 0);
    if (m0 + row < M)
      v = *reinterpret_cast<const uint4*>(x + (size_t)(m0 + row) * K + k0 + chunk * 16);
    *reinterpret_cast<uint4*>(&s[row][chunk * 4]) = v;
  }
}

// One BK-deep step of the 64 x 64 tile: 2 k32 slices x (2 m16 x 4 n8) mma.
__device__ __forceinline__ void mma_tile(uint32_t (*sa)[SROW], uint32_t (*sb)[SROW],
                                         int (*acc)[4][4]) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, t = lane % 4;
  const int wm = (warp / 2) * 32, wn = (warp % 2) * 32;
#pragma unroll
  for (int ks = 0; ks < BK / 32; ++ks) {
    uint32_t a[2][4], b[4][2];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      int r = wm + mi * 16 + g;
      a[mi][0] = sa[r][ks * 8 + t];
      a[mi][1] = sa[r + 8][ks * 8 + t];
      a[mi][2] = sa[r][ks * 8 + t + 4];
      a[mi][3] = sa[r + 8][ks * 8 + t + 4];
    }
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      int n = wn + ni * 8 + g;
      b[ni][0] = sb[n][ks * 8 + t];
      b[ni][1] = sb[n][ks * 8 + t + 4];
    }
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) mma_s8(acc[mi][ni], a[mi], b[ni]);
  }
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// W4 = false: w is int8 [K, N]. W4 = true: w is packed uint8 [K/2, N].
template <bool W4, typename OutT>
__global__ void __launch_bounds__(THREADS)
gemm_kernel(const int8_t* __restrict__ x, const uint8_t* __restrict__ w,
            const float* __restrict__ sx, const float* __restrict__ sw,
            OutT* __restrict__ out, int M, int N, int K) {
  __shared__ __align__(16) uint32_t sa[BM][SROW];
  __shared__ __align__(16) uint32_t sb[BN][SROW];
  __shared__ __align__(16) uint32_t sa_hi[W4 ? BM : 1][SROW];
  __shared__ __align__(16) uint32_t sb_hi[W4 ? BN : 1][SROW];

  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int kw = W4 ? K / 2 : K;   // weight rows stored
  int acc[2][4][4] = {};

  for (int k0 = 0; k0 < kw; k0 += BK) {
    load_x_tile(x, M, K, m0, k0, sa);
    if constexpr (W4) load_x_tile(x, M, K, m0, kw + k0, sa_hi);
    // weight tile: BK rows x BN columns in 4 x 4 byte blocks
    for (int idx = threadIdx.x; idx < (BK / 4) * (BN / 4); idx += THREADS) {
      int kg = idx / (BN / 4), ng = idx % (BN / 4);
      uint32_t r[4], c[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        r[j] = *reinterpret_cast<const uint32_t*>(w + (size_t)(k0 + kg * 4 + j) * N + n0 + ng * 4);
      if constexpr (W4) {
        uint32_t lo[4], hi[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          lo[j] = sext_nibbles(r[j]);
          hi[j] = sext_nibbles(r[j] >> 4);
        }
        transpose4x4(lo, c);
#pragma unroll
        for (int i = 0; i < 4; ++i) sb[ng * 4 + i][kg] = c[i];
        transpose4x4(hi, c);
#pragma unroll
        for (int i = 0; i < 4; ++i) sb_hi[ng * 4 + i][kg] = c[i];
      } else {
        transpose4x4(r, c);
#pragma unroll
        for (int i = 0; i < 4; ++i) sb[ng * 4 + i][kg] = c[i];
      }
    }
    __syncthreads();
    mma_tile(sa, sb, acc);
    if constexpr (W4) mma_tile(sa_hi, sb_hi, acc);
    __syncthreads();
  }

  // epilogue: the TPU kernel's order, acc * (1 / ((sx + eps) * (sw + eps)))
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, t = lane % 4;
  const int wm = (warp / 2) * 32, wn = (warp % 2) * 32;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        int row = m0 + wm + mi * 16 + g + (i >= 2 ? 8 : 0);
        int col = n0 + wn + ni * 8 + t * 2 + (i & 1);
        if (row < M) {
          float inv = 1.0f / ((sx[row] + EPS) * (sw[col] + EPS));
          store(out + (size_t)row * N + col, __int2float_rn(acc[mi][ni][i]) * inv);
        }
      }
}

template <bool W4>
int launch(const void* x, const void* w, const void* sx, const void* sw, void* out,
           int M, int N, int K, int out_code, void* stream) {
  dim3 grid(N / BN, (M + BM - 1) / BM);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (out_code == 1)
    gemm_kernel<W4, __nv_bfloat16><<<grid, THREADS, 0, s>>>(
        (const int8_t*)x, (const uint8_t*)w, (const float*)sx, (const float*)sw,
        (__nv_bfloat16*)out, M, N, K);
  else
    gemm_kernel<W4, float><<<grid, THREADS, 0, s>>>(
        (const int8_t*)x, (const uint8_t*)w, (const float*)sx, (const float*)sw,
        (float*)out, M, N, K);
  return (int)cudaGetLastError();
}

}  // namespace gemm_int8
