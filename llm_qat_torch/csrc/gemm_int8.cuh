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
// Two variants, picked by the caller from the row count (quant_matmul.py
// gemm_plan):
//
// * decode (M <= 64): bound by the weight bytes (2 M operations a weight
//   byte against the card's ~590). Blocks of 4 warps own 64 output columns
//   and all M rows; K is split until the grid covers every SM. Each block
//   streams its share of the weight through a ring of 4 stages of 128
//   weight rows (16-byte cp.async, 8 KB a stage, 2-4 blocks an SM) and
//   reads the activations from L2 beside them. The row-major [K, N] tile is
//   turned K-contiguous on its way into registers (ldmatrix.trans on 16-bit
//   pairs plus one byte_perm a register) for mma.sync m16n8k32.
// * prefill (M > 64): bound by the int8 tensor-core rate. Blocks of two
//   warpgroups own 128 tokens x 128 columns, two blocks an SM; weight and x
//   tiles arrive through a 3- (W8) or 4-stage (W4) cp.async ring, and each
//   warpgroup runs wgmma m64n128k32 with the operands swapped (out^T = W^T
//   x^T): x, K-contiguous, is the shared-memory B operand that wgmma's 8-bit
//   forms read only K-major, and the weight tile becomes the register A
//   operand through the same ldmatrix.trans + byte_perm as at decode, once
//   per tile, with no transposed copy in shared or device memory.
//
// W4: a packed byte b = hi << 4 | lo becomes the two int8 values lo << 4 and
// b & 0xF0: 16 times the signed nibbles, two logic operations a word. Both
// K halves add into one int32 sum (|16 sum| <= 16 * 8 * 127 * K, below 2^31
// for K < 132000), shifted right by 4 before the epilogue: exact. Device
// memory carries only the nibbles; Hopper has no int4 tensor-core product.
//
// Split-K: the blocks that share one output tile along K form a thread-block
// cluster (at most 8, the portable size). Each leaves its int32 partial tile
// in its own shared memory; after a cluster barrier each block sums a share
// of the tile over all of them through distributed shared memory, in split
// order, and runs its share of the epilogue. No workspace in device memory,
// no counters. Integer sums are exact in any order, so every split count
// gives the same bits as the plain version.

#pragma once

#include <cooperative_groups.h>

#include "tc_bf16.cuh"

namespace gemm_int8 {

using tc_bf16::cp_async16;
using tc_bf16::cp_async_commit;
using tc_bf16::cp_async_wait;
using tc_bf16::ldsm_x4;
using tc_bf16::ldsm_x4_t;
using tc_bf16::smem_u32;

constexpr float EPS = 1e-6f;
constexpr int MAX_SPLITS = 8;   // split-K blocks a tile at most: one cluster (portable size)
constexpr int BK = 128;   // weight rows a stage (packed rows at W4); x columns a stage
enum { DECODE = 0, PREFILL = 1 };

// decode: 64 columns a block, 4 warps of 16 columns, 4 stages
constexpr int D_BN = 64, D_THREADS = 128, D_STAGES = 4;
// prefill: 128 tokens x 128 columns a block, two warpgroups of 64 columns
constexpr int P_BM = 128, P_BN = 128, P_THREADS = 256;

template <bool W4, int MT>   // stages of [raw w | x (| x hi)], MT 16-row tiles of x
__host__ __device__ constexpr int decode_smem() {
  return D_STAGES * (BK * D_BN + (W4 ? 2 : 1) * MT * 16 * BK);
}
// prefill stages: W8 3 of 128 weight rows (32 KB), W4 4 of 64 packed rows
// (24 KB), so that two blocks share an SM
template <bool W4>
__host__ __device__ constexpr int prefill_bk() { return W4 ? 64 : 128; }
template <bool W4>
__host__ __device__ constexpr int prefill_stages() { return W4 ? 4 : 3; }
template <bool W4>
__host__ __device__ constexpr int prefill_smem() {   // stages of [raw w | x (| x hi)]
  return prefill_stages<W4>() * prefill_bk<W4>() * (P_BN + (W4 ? 2 : 1) * P_BM) +
         1024;   // + 1 KB: the base is aligned up
}

// c (16 x 8 int32) += a (16 x 32 int8, row) . b (32 x 8 int8, col): mma.sync m16n8k32
__device__ __forceinline__ void mma_s8(int* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Sign-extend the 4-bit fields (bits 0-3 of each byte of w) to int8 bytes
// (the decode megakernel's unpack; megakernel.cu includes this header).
__device__ __forceinline__ uint32_t sext_nibbles(uint32_t w) {
  return __vsub4((w & 0x0F0F0F0Fu) ^ 0x08080808u, 0x08080808u);
}

// packed nibbles -> 16 x the signed low / high nibbles, as int8 bytes
__device__ __forceinline__ uint32_t lo16(uint32_t w) { return (w << 4) & 0xF0F0F0F0u; }
__device__ __forceinline__ uint32_t hi16(uint32_t w) { return w & 0xF0F0F0F0u; }

__device__ __forceinline__ void store4(float* p, float a, float b, float c, float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float a, float b, float c, float d) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(a, b), hi = __floats2bfloat162_rn(c, d);
  uint2 v;
  v.x = *reinterpret_cast<uint32_t*>(&lo);
  v.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = v;
}

// The epilogue of four neighbouring columns, in the TPU kernel's order:
// acc * (1 / ((sx + eps) * (sw + eps))), one product per output (no fma).
// sxe = sx + eps of the row, sw4 = sw + eps of the columns.
template <bool W4, typename OutT>
__device__ __forceinline__ void finish4(OutT* out, int row, int col, int N, float sxe,
                                        float4 sw4, int4 v) {
  if (W4) { v.x >>= 4; v.y >>= 4; v.z >>= 4; v.w >>= 4; }
  store4(out + (size_t)row * N + col, __int2float_rn(v.x) * (1.0f / (sxe * sw4.x)),
         __int2float_rn(v.y) * (1.0f / (sxe * sw4.y)), __int2float_rn(v.z) * (1.0f / (sxe * sw4.z)),
         __int2float_rn(v.w) * (1.0f / (sxe * sw4.w)));
}

// The tile's scales + eps into shared memory (zero past the edges), so that
// the epilogue waits for no device memory: rows [r0, r0 + nr), columns
// [c0, c0 + nc).
__device__ __forceinline__ void stage_scales(const float* sx, const float* sw, float* s_sx,
                                             float* s_sw, int r0, int nr, int M, int c0, int nc,
                                             int N) {
  for (int i = threadIdx.x; i < nr; i += blockDim.x)
    s_sx[i] = r0 + i < M ? sx[r0 + i] + EPS : 0.f;
  for (int i = threadIdx.x; i < nc; i += blockDim.x)
    s_sw[i] = c0 + i < N ? sw[c0 + i] + EPS : 0.f;
}

// Split-K: the `splits` blocks of one output tile form a cluster (grid z =
// cluster z). Each has put its int32 partial tile in its own shared memory
// (`tile`, rows of `row` ints); after a cluster barrier, block r sums the
// 4-int chunks [r n / splits, (r + 1) n / splits) of all the partials in
// split order through distributed shared memory and hands each sum to
// `fin(chunk, sum)`; a second barrier keeps every partial alive until all
// reads are done. Integer sums: exact in any order.
template <typename Fin>
__device__ __forceinline__ void cluster_reduce(const int* tile, int rows, int cols, int row,
                                               int splits, Fin fin) {
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const int n = rows * (cols / 4), r = (int)cluster.block_rank();
  const int c0 = (int)((long long)r * n / splits), c1 = (int)((long long)(r + 1) * n / splits);
  for (int c = c0 + (int)threadIdx.x; c < c1; c += (int)blockDim.x) {
    const int off = (c / (cols / 4)) * row + (c % (cols / 4)) * 4;
    int4 v = make_int4(0, 0, 0, 0);
    for (int q = 0; q < splits; ++q) {
      const int4 p = *reinterpret_cast<const int4*>(cluster.map_shared_rank(tile, q) + off);
      v.x += p.x; v.y += p.y; v.z += p.z; v.w += p.w;
    }
    fin(c, v);
  }
  cluster.sync();
}

// GEMM_TRACE (gemm_timeline.py builds with it; off otherwise): thread 0 of
// each block stamps the global timer (ns) at entry (0), when its first
// stage has landed (1), after its main loop (2) and at its end (3).
#ifdef GEMM_TRACE
__device__ unsigned long long gemm_trace[4][65536];
__device__ __forceinline__ void trace(int slot) {
  if (threadIdx.x == 0) {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    const int b = (blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x;
    if (b < 65536) gemm_trace[slot][b] = t;
  }
}
#define TRACE(i) trace(i)
#else
#define TRACE(i)
#endif

// the stages [s0, s1) (of BK or PBK weight rows) that split z of `splits` walks
__device__ __forceinline__ void split_range(int nsteps, int splits, int z, int& s0, int& s1) {
  s0 = (int)((long long)z * nsteps / splits);
  s1 = (int)((long long)(z + 1) * nsteps / splits);
}

// ---------------------------------------------------------------------------
// decode variant
// ---------------------------------------------------------------------------
//
// Stage layout: raw weight [BK rows][64 bytes], 16-byte chunk c of row r at
// chunk c ^ ((r >> 2) & 3); x [BM rows][BK bytes] (two tiles at W4: columns
// k0.. and K/2 + k0..), chunk c of row r at c ^ (r & 7). Both make every
// ldmatrix phase touch 32 different banks.
//
// B fragments: warp w owns columns [16w, 16w + 16). One ldmatrix.x4.trans
// reads four 8 x 8 matrices of 16-bit pairs whose rows are weight rows
// {0,1,4,5,8,9,12,13} (+2, +16, +18) of a 32-row slice: lane (g, t) gets
// rows 4t, 4t+1 and 4t+2, 4t+3 of columns 2g, 2g+1, and two byte_perms give
// the K-contiguous words of column 2g (n-tile 0) and 2g+1 (n-tile 1). So
// accumulator element c[i] of n-tile j is column 16w + 4t + 2(i & 1) + j:
// each lane holds 4 neighbouring columns of a row.

template <bool W4, int MT, typename OutT>
__global__ void __launch_bounds__(D_THREADS)
decode_kernel(const int8_t* __restrict__ x, const uint8_t* __restrict__ w,
              const float* __restrict__ sx, const float* __restrict__ sw,
              OutT* __restrict__ out, int M, int N, int K, int splits) {
  constexpr int BM = MT * 16, H = W4 ? 2 : 1;
  constexpr int WT = BK * D_BN, XT = BM * BK, STAGE = WT + H * XT;
  extern __shared__ __align__(1024) uint8_t gemm_smem[];
  const uint32_t base = smem_u32(gemm_smem);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int kw = W4 ? K / 2 : K;
  const int n0 = blockIdx.x * D_BN;
  __shared__ __align__(16) float s_sx[BM], s_sw[D_BN];
  int s0, s1;
  split_range((kw + BK - 1) / BK, splits, blockIdx.z, s0, s1);
  TRACE(0);
  stage_scales(sx, sw, s_sx, s_sw, 0, BM, M, n0, D_BN, N);   // read after the loop's barriers

  auto load = [&](int step, int slot) {
    const uint32_t st = base + slot * STAGE;
    const int k0 = step * BK;
#pragma unroll
    for (int i = tid; i < BK * 4; i += D_THREADS) {
      const int r = i >> 2, c = i & 3;
      const bool in = k0 + r < kw;
      cp_async16(st + r * D_BN + ((c ^ ((r >> 2) & 3)) << 4),
                 w + (size_t)(in ? k0 + r : 0) * N + n0 + c * 16, in);
    }
#pragma unroll
    for (int h = 0; h < H; ++h) {
#pragma unroll
      for (int i = tid; i < BM * 8; i += D_THREADS) {
        const int r = i >> 3, c = i & 7;
        const bool in = r < M && k0 + c * 16 < kw;
        cp_async16(st + WT + h * XT + r * BK + ((c ^ (r & 7)) << 4),
                   x + (in ? (size_t)r * K + h * kw + k0 + c * 16 : 0), in);
      }
    }
  };

  int acc[MT][2][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][j][i] = 0;

  const int q = lane >> 3, i8 = lane & 7;
  const int brow = 16 * (q >> 1) + 2 * (q & 1) + (i8 & 1) + 4 * (i8 >> 1);
  const uint32_t b_off = brow * D_BN + ((warp ^ ((brow >> 2) & 3)) << 4);
  const int arow = (q & 1) * 8 + i8;   // + 16 mt; arow & 7 == i8

#pragma unroll
  for (int s = 0; s < D_STAGES - 1; ++s) {
    if (s0 + s < s1) load(s0 + s, s);
    cp_async_commit();
  }
  for (int step = s0; step < s1; ++step) {
    const int j = step - s0;
    cp_async_wait<D_STAGES - 2>();
    __syncthreads();   // stage j landed; every warp is done with stage j - 1
    if (j == 0) TRACE(1);
    if (step + D_STAGES - 1 < s1) load(step + D_STAGES - 1, (j + D_STAGES - 1) % D_STAGES);
    cp_async_commit();
    const uint32_t st = base + (j % D_STAGES) * STAGE;
#pragma unroll
    for (int ks = 0; ks < BK / 32; ++ks) {
      uint32_t r[4], b[2][2];
      ldsm_x4_t(st + ks * 32 * D_BN + b_off, r);
      b[0][0] = __byte_perm(r[0], r[1], 0x6420);
      b[1][0] = __byte_perm(r[0], r[1], 0x7531);
      b[0][1] = __byte_perm(r[2], r[3], 0x6420);
      b[1][1] = __byte_perm(r[2], r[3], 0x7531);
#pragma unroll
      for (int h = 0; h < H; ++h) {
        uint32_t bb[2][2];
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            bb[n][e] = !W4 ? b[n][e] : (h == 0 ? lo16(b[n][e]) : hi16(b[n][e]));
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          uint32_t a[4];
          ldsm_x4(st + WT + h * XT + (mt * 16 + arow) * BK + (((ks * 2 + (q >> 1)) ^ i8) << 4), a);
          mma_s8(acc[mt][0], a, bb[0]);
          mma_s8(acc[mt][1], a, bb[1]);
        }
      }
    }
  }
  cp_async_wait<0>();
  TRACE(2);

  const int g = lane >> 2, t = lane & 3;
  const int cl = warp * 16 + t * 4;   // the lane's 4 columns: cl .. cl + 3 of the tile
  if (splits > 1) {   // the partial tile into the (now free) ring, then the cluster's sum
    constexpr int TROW = D_BN + 4;   // ints a row, padded
    int* tile = reinterpret_cast<int*>(gemm_smem);
    __syncthreads();
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
        *reinterpret_cast<int4*>(tile + (mt * 16 + g + 8 * hf) * TROW + cl) =
            make_int4(acc[mt][0][2 * hf], acc[mt][1][2 * hf], acc[mt][0][2 * hf + 1],
                      acc[mt][1][2 * hf + 1]);
    cluster_reduce(tile, BM, D_BN, TROW, splits, [&](int c, int4 v) {
      const int row = c / (D_BN / 4), cc = (c % (D_BN / 4)) * 4;
      if (row < M)
        finish4<W4>(out, row, n0 + cc, N, s_sx[row], *reinterpret_cast<const float4*>(s_sw + cc),
                    v);
    });
    TRACE(3);
    return;
  }
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int row = mt * 16 + g + 8 * hf;
      if (row < M)
        finish4<W4>(out, row, n0 + cl, N, s_sx[row], *reinterpret_cast<const float4*>(s_sw + cl),
                    make_int4(acc[mt][0][2 * hf], acc[mt][1][2 * hf], acc[mt][0][2 * hf + 1],
                              acc[mt][1][2 * hf + 1]));
    }
  TRACE(3);
}

// ---------------------------------------------------------------------------
// prefill variant
// ---------------------------------------------------------------------------
//
// Swapped operands: a block computes out^T for 128 weight columns x 128
// tokens, each warpgroup 64 columns, as wgmma m64n128k32 with A = W^T from
// registers and B = the x tile from shared memory. wgmma's 8-bit forms read
// B only K-major, and x is K-contiguous; the [K, N] weight tile becomes the
// K-contiguous A fragment on its way from shared memory into registers
// (ldmatrix.trans on 16-bit pairs and one byte_perm a register, as in the
// decode variant), so no transposed copy is written anywhere.
//
// Stage layout: raw weight [PBK rows][128 bytes], chunk c of row r at
// c ^ ((r & 1) | ((r >> 1) & 6)) (the 8 rows of each ldmatrix.trans matrix
// land in 8 different chunks); x [128 tokens][PBK bytes] (two tiles at W4)
// in the 128- or 64-byte swizzle that wgmma's descriptors read (1 KB
// aligned). PBK is 128 weight rows at W8, 64 packed rows at W4 (whose x
// tiles are twice the bytes). A ring of 3 (W8) or 4 (W4) stages of 32 / 24
// KB, loads ST - 1 stages ahead, one barrier a stage, and two blocks an SM
// (97 KB of shared memory each, at most 128 registers a thread): one
// block's products run while the other builds its fragments or waits for
// its loads.
//
// Warp w owns weight columns 16w + [0, 16): A row g of the warp's 16 is
// column 16w + 2g, row g + 8 column 16w + 2g + 1.

// K-major tile of ROW-byte rows (128 or 64) in the matching swizzle: chunk c
// of row r at c ^ (r & 7) (128) or c ^ ((r >> 1) & 3) (64), 8-row atoms
template <int ROW>
__device__ __forceinline__ uint32_t kmajor_swz(int r, int c) {
  return r * ROW + ((c ^ (ROW == 128 ? (r & 7) : ((r >> 1) & 3))) << 4);
}
template <int ROW>
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(8 * ROW >> 4) << 32) | ((uint64_t)(ROW == 128 ? 1 : 2) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keeps the compiler from touching an accumulator while a wgmma may write it
__device__ __forceinline__ void reg_fence(int& r) { asm volatile("" : "+r"(r)::"memory"); }

// d (64 columns x 128 tokens, int32, the warpgroup's) = A (64 x 32 int8,
// registers) . B (32 x 128 tokens, K-major in shared memory) + (acc ? d : 0)
__device__ __forceinline__ void wgmma_rs(int (&d)[64], const uint32_t (&a)[4], uint64_t db,
                                         int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p;\n}\n"
      :
        "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
        "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]),
        "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}

template <bool W4, typename OutT>
__global__ void __launch_bounds__(P_THREADS, 2)
prefill_kernel(const int8_t* __restrict__ x, const uint8_t* __restrict__ w,
               const float* __restrict__ sx, const float* __restrict__ sw,
               OutT* __restrict__ out, int M, int N, int K, int splits) {
  constexpr int ST = prefill_stages<W4>(), H = W4 ? 2 : 1, PBK = prefill_bk<W4>();
  constexpr int WT = PBK * P_BN, XT = P_BM * PBK, STAGE = WT + H * XT;
  extern __shared__ __align__(1024) uint8_t gemm_smem[];
  const uint32_t base = (smem_u32(gemm_smem) + 1023) & ~1023u;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int kw = W4 ? K / 2 : K;
  // token tiles vary fastest: the blocks that run together share weight columns
  const int m0 = blockIdx.x * P_BM, n0 = blockIdx.y * P_BN;
  __shared__ __align__(16) float s_sx[P_BM], s_sw[P_BN];
  int s0, s1;
  split_range((kw + PBK - 1) / PBK, splits, blockIdx.z, s0, s1);
  TRACE(0);
  stage_scales(sx, sw, s_sx, s_sw, m0, P_BM, M, n0, P_BN, N);   // read after the loop's barriers

  // 32-bit element offsets (one weight or x matrix is under 4 GB): fewer
  // registers held across the loop than 64-bit addresses
  auto load = [&](int step, int slot) {
    const uint32_t st = base + slot * STAGE;
    const int k0 = step * PBK;
#pragma unroll
    for (int i = tid; i < PBK * 8; i += P_THREADS) {
      const int r = i >> 3, c = i & 7;
      const bool in = k0 + r < kw && n0 + c * 16 < N;
      const uint32_t off = in ? (uint32_t)(k0 + r) * (uint32_t)N + n0 + c * 16 : 0u;
      cp_async16(st + r * P_BN + ((c ^ ((r & 1) | ((r >> 1) & 6))) << 4), w + off, in);
    }
#pragma unroll
    for (int h = 0; h < H; ++h) {
#pragma unroll
      for (int i = tid; i < P_BM * (PBK / 16); i += P_THREADS) {
        const int r = i / (PBK / 16), c = i % (PBK / 16);
        const bool in = m0 + r < M && k0 + c * 16 < kw;
        const uint32_t off = in ? (uint32_t)(m0 + r) * (uint32_t)K + h * kw + k0 + c * 16 : 0u;
        cp_async16(st + WT + h * XT + kmajor_swz<PBK>(r, c), x + off, in);
      }
    }
  };

  const int q = lane >> 3, i8 = lane & 7;
  const int brow = 16 * (q >> 1) + 2 * (q & 1) + (i8 & 1) + 4 * (i8 >> 1);
  const uint32_t a_off = brow * P_BN + ((warp ^ ((brow & 1) | ((brow >> 1) & 6))) << 4);

  int d[64];   // the first product of the split writes it (acc = 0)
  uint32_t a[H][PBK / 32][4];

#pragma unroll
  for (int s = 0; s < ST - 1; ++s) {
    if (s0 + s < s1) load(s0 + s, s);
    cp_async_commit();
  }
  for (int step = s0; step < s1; ++step) {
    const int j = step - s0;
    cp_async_wait<ST - 2>();
    __syncthreads();   // stage j landed; stage j - 1's products are done in both warpgroups
    if (j == 0) TRACE(1);
    if (step + ST - 1 < s1) load(step + ST - 1, (j + ST - 1) % ST);
    cp_async_commit();
    const uint32_t st = base + (j % ST) * STAGE;
#pragma unroll
    for (int kk = 0; kk < PBK / 32; ++kk) {
      uint32_t r[4];
      ldsm_x4_t(st + kk * 32 * P_BN + a_off, r);
      const uint32_t f[4] = {__byte_perm(r[0], r[1], 0x6420), __byte_perm(r[0], r[1], 0x7531),
                             __byte_perm(r[2], r[3], 0x6420), __byte_perm(r[2], r[3], 0x7531)};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (W4) {
          a[0][kk][e] = lo16(f[e]);
          a[H - 1][kk][e] = hi16(f[e]);
        } else {
          a[0][kk][e] = f[e];
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 64; ++i) reg_fence(d[i]);
    wgmma_fence();
#pragma unroll
    for (int h = 0; h < H; ++h) {
      const uint64_t db = kmajor_desc<PBK>(st + WT + h * XT);
#pragma unroll
      for (int kk = 0; kk < PBK / 32; ++kk)
        wgmma_rs(d, a[h][kk], db + 2 * kk, j > 0 || h > 0 || kk > 0);
    }
    wgmma_commit();
    // Wait for them here: the fragments of the next stage would otherwise be
    // written while these products read their registers, and ptxas then
    // serializes every wgmma. The other block on the SM fills the gap.
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < 64; ++i) reg_fence(d[i]);
  }
  cp_async_wait<0>();
  TRACE(2);

  // The epilogue goes through an int32 copy of the tile in shared memory (the
  // ring is free once every thread has left the loop): the accumulators die
  // at once, and every device-memory access is a 16-byte row chunk.
  // d[4 j + e]: column 16 warp + 2 g (+ 1 for e >= 2), token 8 j + 2 t (+ 1
  // for odd e).
  constexpr int TROW = P_BN + 4;   // ints a row, padded
  int* tile = reinterpret_cast<int*>(gemm_smem + (base - smem_u32(gemm_smem)));
  const int g = lane >> 2, t = lane & 3;
  __syncthreads();
#pragma unroll
  for (int jn = 0; jn < 16; ++jn)
#pragma unroll
    for (int e = 0; e < 2; ++e)
      *reinterpret_cast<int2*>(tile + (8 * jn + 2 * t + e) * TROW + warp * 16 + 2 * g) =
          make_int2(d[4 * jn + e], d[4 * jn + 2 + e]);
  __syncthreads();
  constexpr int CPR = P_BN / 4;   // 4-int chunks a row
  auto fin = [&](int c, int4 v) {
    const int tl = c / CPR, cl = (c % CPR) * 4, tok = m0 + tl, col = n0 + cl;
    if (tok < M && col < N)
      finish4<W4>(out, tok, col, N, s_sx[tl], *reinterpret_cast<const float4*>(s_sw + cl), v);
  };
  if (splits > 1) {
    cluster_reduce(tile, P_BM, P_BN, TROW, splits, fin);
  } else {
    for (int c = tid; c < P_BM * CPR; c += P_THREADS)
      fin(c, *reinterpret_cast<const int4*>(tile + (c / CPR) * TROW + (c % CPR) * 4));
  }
  TRACE(3);
}

#ifdef GEMM_TRACE
// the stamps of the last launch: host [4][65536]
inline int read_trace(unsigned long long* host) {
  return (int)cudaMemcpyFromSymbol(host, gemm_trace, sizeof(gemm_trace));
}
#endif

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

// One launch; `splits` > 1 makes each tile's split blocks a cluster (1, 1, splits).
template <typename OutT>
int launch_kernel(void (*kern)(const int8_t*, const uint8_t*, const float*, const float*, OutT*,
                               int, int, int, int),
                  dim3 grid, int threads, int smem, cudaStream_t s, int splits, const int8_t* x,
                  const uint8_t* w, const float* sx, const float* sw, OutT* out, int M, int N,
                  int K) {
  if (int e = (int)cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem))
    return e;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = splits;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (int e = (int)cudaLaunchKernelEx(&cfg, kern, x, w, sx, sw, out, M, N, K, splits)) return e;
  return (int)cudaGetLastError();
}

template <bool W4, typename OutT>
int launch_t(const void* x, const void* w, const void* sx, const void* sw, void* out, int M,
             int N, int K, int variant, int splits, cudaStream_t s) {
  const int8_t* xp = (const int8_t*)x;
  const uint8_t* wp = (const uint8_t*)w;
  const float *sxp = (const float*)sx, *swp = (const float*)sw;
  OutT* op = (OutT*)out;
  const int kw = W4 ? K / 2 : K;
  const int bk = variant == PREFILL ? prefill_bk<W4>() : BK;
  if (M < 1 || N % 64 || K % 128 || splits < 1 || splits > MAX_SPLITS ||
      splits > (kw + bk - 1) / bk)
    return (int)cudaErrorInvalidValue;
  if (variant == DECODE) {
    if (M > 64) return (int)cudaErrorInvalidValue;
    const dim3 grid(N / D_BN, 1, splits);
    if (M <= 32)
      return launch_kernel(decode_kernel<W4, 2, OutT>, grid, D_THREADS, decode_smem<W4, 2>(), s,
                           splits, xp, wp, sxp, swp, op, M, N, K);
    return launch_kernel(decode_kernel<W4, 4, OutT>, grid, D_THREADS, decode_smem<W4, 4>(), s,
                         splits, xp, wp, sxp, swp, op, M, N, K);
  }
  if (variant == PREFILL) {
    const dim3 grid((M + P_BM - 1) / P_BM, (N + P_BN - 1) / P_BN, splits);
    return launch_kernel(prefill_kernel<W4, OutT>, grid, P_THREADS, prefill_smem<W4>(), s, splits,
                         xp, wp, sxp, swp, op, M, N, K);
  }
  return (int)cudaErrorInvalidValue;
}

template <bool W4>
int launch(const void* x, const void* w, const void* sx, const void* sw, void* out, int M, int N,
           int K, int variant, int splits, int out_code, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (out_code == 1)
    return launch_t<W4, __nv_bfloat16>(x, w, sx, sw, out, M, N, K, variant, splits, s);
  return launch_t<W4, float>(x, w, sx, sw, out, M, N, K, variant, splits, s);
}

// registers, shared memory, spills and occupancy of one variant
// (tc_bf16::attributes; launches nothing): bm 32 or 64 for decode, 128 for prefill
template <bool W4, typename OutT>
int attributes_t(int variant, int bm, int* out) {
  if (variant == DECODE && bm == 32)
    return tc_bf16::attributes(decode_kernel<W4, 2, OutT>, D_THREADS, decode_smem<W4, 2>(), out);
  if (variant == DECODE && bm == 64)
    return tc_bf16::attributes(decode_kernel<W4, 4, OutT>, D_THREADS, decode_smem<W4, 4>(), out);
  if (variant == PREFILL)
    return tc_bf16::attributes(prefill_kernel<W4, OutT>, P_THREADS, prefill_smem<W4>(), out);
  return (int)cudaErrorInvalidValue;
}

template <bool W4>
int attributes(int variant, int bm, int out_code, int* out) {
  return out_code == 1 ? attributes_t<W4, __nv_bfloat16>(variant, bm, out)
                       : attributes_t<W4, float>(variant, bm, out);
}

}  // namespace gemm_int8
