// Whole-model decode step for Hopper (sm_90a): every layer of one token per
// slot in ONE persistent cooperative launch.
//
// Replaces llm_qat_tpu/inference/megakernel.py:_kernel (the body of
// decode_step's pallas_call). Per layer: RMSNorm -> per-token int8
// activation quant -> qkv product -> new K/V quantized per token (before
// RoPE in "pre" mode, after it in "post" mode) -> query RoPE -> online
// softmax over BK-column blocks of the int8 or nibble-packed KV cache with
// the current token folded in -> o product + residual -> RMSNorm -> gate/up
// product -> SiLU(gate) * up in fp32 -> down product + residual. It returns
// each layer's new K/V integers and inverse scales; the caller commits them.
//
// Bound on this card: bytes. A step reads every layer's int8 / packed int4
// weights and the live cache once (about 1 GB at TinyLlama-1.1B W8, 0.30 ms
// at 3.35 TB/s; 7.5 GB at LLaMA-7B W8, 2.24 ms) and does a few operations a
// byte. The TPU kernel is a sequential grid over layers on one core; here
// every stage is spread over all SMs (one block of 256 threads each) and
// the stages are separated by grid-wide barriers, ten a layer:
//
//   norm        every block derives each row's RMS from float64 partial
//               sums of squares (one per slot and 128-column tile, combined
//               in a fixed order, so every block gets the same value); the
//               normed rows (fp32 scratch) and their absmax (atomicMax on
//               the float's bits) over all threads of the grid. The product
//               after it quantizes its activations as they arrive.
//   GEMM        the weights are a K-contiguous copy made once by the
//               wrapper ([L, N, K] int8, or [L, N, K/2] split-half nibbles,
//               cut into contiguous 128 x 256 tiles in streaming order):
//               item = (128 output columns, 256 K values); each block takes
//               a contiguous run of items, weight tiles and activations
//               arriving through a ring of three cp.async stages (the first
//               weight tiles issued before the barrier that precedes the
//               stage) into a swizzled shared layout. Swap-AB: the weight
//               tile is the 16-row A operand of mma.sync m16n8k32 (ldmatrix,
//               no transposition; nibbles sign-extended in registers) and
//               the <= 32 tokens are B, so no mma row is wasted at b = 8.
//               Sums stay in registers over a column tile's K chunks and go
//               to a global int32 accumulator with atomics: integer addition
//               is exact in any order. The o and down products count a
//               tile's chunks; the block that adds the last applies the
//               fixup acc / ((sx+eps)(sw+eps)), the residual add and the
//               tile's float64 sum of squares.
//   scores      item = (slot, 128 cache columns, kv head), all query heads
//               of the kv head, a contiguous run a block, the next item's
//               K bytes, scales, query inputs and RoPE columns arriving by
//               cp.async: q.k in float64 per column (RoPE or scale applied
//               to the cached integers in the compute type, on bf16 pairs
//               in bf16), the scores to a scratch and
//               each chunk's row maximum. The current token's K and V are
//               quantized by items of 256 pairs spread over the blocks:
//               their absmax here, their integers in the next stage.
//   softmax.V   the same items. In the online softmax a BK block's p, its
//               sum P_j and its p.V product depend only on the prefix
//               maximum m_j = max(m_{j-1}, rowmax(s_j)), so an item takes
//               m_j from the chunk maxima and writes float64 partial sums of
//               p and p.V.
//   finish      item = (slot, kv head): the fp32 recurrence l = l a + P_j,
//               acc = acc a + PV_j block by block from the partial sums,
//               the current token folded in, the division: the sequential
//               walk's values in its order.
//   SiLU        over all threads of the grid, 32 columns of a row a warp.
//
// Every floating-point sum whose result is rounded afterwards (sum of
// squares, q.k, the softmax denominator, p.V) is accumulated in float64 and
// rounded once, as the plain PyTorch version does: such a sum does not
// depend on the order of its terms, so the two agree bit for bit. Where
// PyTorch rounds a product and then a sum (two operations), the kernel uses
// __fmul_rn / __fadd_rn, which the compiler never contracts into one fused
// multiply-add. Scratch written by one block and read by another is read
// with __ldcg (L2 only). Built for head dims 64 and 128 (a template each)
// and for the other head dims of the padded build (below), with 1 to 8
// query heads a kv head taken at run time (p.G): the attention
// stages' shared memory is sized for 8, the q.k loop runs with a register
// tile of 1, 2, 4 or 8 heads (G rounded up; the padding heads' query rows
// are zeros) and the finish stage with 1, 2 or 4 outputs a thread. A wide
// build of each (MEGAKERNEL_WIDE: megakernel_g16.cu, megakernel_d128_g16.cu,
// megakernel_dpad_g16.cu) takes 9 to 16 at run time: its shared memory sized
// for 16 (one buffer of RoPE columns at 128, see AttnSmem), the q.k loop in
// two passes of 8 over 16 query rows (the padding rows zero), a warp two
// heads where it takes a head, and the finish stage up to 8 outputs a
// thread; the builds of 1 to 8 keep their code (WIDE is false there). The
// wrapper refuses other shapes.
//
// Memory plan, bytes of a block's dynamic shared memory (the larger of the
// attention stages' AttnSmem and the products' GemmSmem, 204800): 1 to 8
// heads, hd 64 204800 (AttnSmem 118148), hd 128 and padded 212868 (AttnSmem);
// 9 to 16 heads, hd 64 204800 (AttnSmem 150916), hd 128 and padded 204800
// (AttnSmem 192388 with one RoPE buffer; 257924 with two, over the 232448 a
// block may take). So the 12- and 16-head shapes leave room for GemmSmem at
// every head dim, one block an SM. Head dim 256, 1 to 8 heads: 204800
// (AttnSmem about 170 KB with 64-column items and one RoPE buffer).
//
// One source builds one head dim (MEGAKERNEL_HD: megakernel.cu 64,
// megakernel_d128.cu 128, megakernel_d256.cu 256), so they compile side by
// side.
// megakernel_dpad.cu defines MEGAKERNEL_PAD beside HD = 128: its kernels
// take every head dim p.hd % 4 == 0 with 32 < p.hd <= 128 (OpenLLaMA-3B's
// 100) at run time. HD is then the most the attention stages' shared memory
// holds (sized as at 128); every layout in global memory keeps the true hd
// (projection columns, cache rows, RoPE tables, scratch) and every count,
// stride and pair (j, j + hd/2) comes from it (head_dim). Heads then
// straddle the products' 128-column tiles, which nothing assumes otherwise.
// A RoPE row of hd/2 floats that is no multiple of 16 bytes (hd 100: 200)
// arrives in 8-byte pieces.
//
// megakernel_d256.cu builds head dim 256 (Falcon3's), 1 to 8 query heads a
// kv head: there an attention item is CHMAX = 64 cache columns (the host
// passes CH = gcd(64, BK)) and the scores stage keeps one buffer of RoPE
// columns, so AttnSmem<256> takes 170 KB, under GemmSmem's 200 KB (with
// 128-column items the RoPE columns alone were 256 KB with two buffers, 128
// KB with one, and the stage about 271 KB). Every float64 sum is as before
// (its terms do not depend on the chunk width) and a chunk still never
// straddles a BK block, so the plain version is unchanged. Only these
// constants (CHMAX, and from it NQ, VS and ChunkRegs) and AttnSmem::TB differ
// from the builds of 64 and 128, which keep their code.
//
// The padded build also takes products whose K is no multiple of TK
// (OpenLLaMA-3B's H = 3200 and I = 8640): the wrapper's tiled weight copy is
// zero-padded to whole TK chunks, the activations past K arrive as zeros
// (issue_x), so the int32 sums are exact; the norms' sums of squares and
// absmax run over the true width. The builds of head dims 64 and 128 keep
// K % TK == 0 and their code: the zero-filling copies cost LLaMA-7B's W8 step
// 6-7% there (registers at 255), with nothing of theirs to take.

#pragma once

#ifndef MEGAKERNEL_HD
#error "define MEGAKERNEL_HD (64, 128 or 256) before including megakernel.cuh"
#endif

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "gemm_int8.cuh"

namespace cg = cooperative_groups;
using gemm_int8::mma_s8;
using gemm_int8::sext_nibbles;

// Field for field the ctypes structure of inference/megakernel.py.
struct Params {
  const void* x;            // [b, H] T: embedded token
  const float* qcos;        // [b, hd/2] RoPE at each slot's position
  const float* qsin;
  const float* kcos;        // [hd/2, S] RoPE of every cache position
  const float* ksin;
  const float* qkv_s;       // [L, Dq] weight scales
  const float* o_s;         // [L, H]
  const float* gu_s;        // [L, 2I]
  const float* dn_s;        // [L, H]
  const float* anorm;       // [L, H] norm gains (f32 copies)
  const float* mnorm;
  const uint8_t* qkv_w;     // [L, Dq/TN, H/TK, TN, TK(/2)] K-contiguous tiles, int8 or
  const uint8_t* o_w;       //   split-half packed int4 ([L, N, K] cut into tiles)
  const uint8_t* gu_w;
  const uint8_t* dn_w;
  const uint8_t* kq;        // [L, b, kvh, hd(/2), S] cache (read-only)
  const float* ks;          // [L, b, S] inverse scales
  const uint8_t* vq;
  const float* vs;
  const int* lens;          // [b] pre-append lengths
  const int* active;        // [b] 1 where the slot commits
  void* y;                  // [b, H] T: the residual stream, and the result
  int8_t* kint;             // [L, b, kv_dim] new K integers
  int8_t* vint;
  float* kinv;              // [L, b] inverse scales
  float* vinv;
  float* xn;                // scratch: [b, H] normed rows (fp32)
  void* attn;               // [b, H] T attention output
  void* act;                // [b, I] T SiLU(gate) * up
  int* acc_qkv;             // [b, Dq] int32 accumulators
  int* acc_o;               // [b, H]
  int* acc_gu;              // [b, 2I]
  int* acc_dn;              // [b, H]
  int* amax;                // [4, b] row absmax (float bits): attn norm, mlp norm, attn, act
  int* kvmax;               // [2, b] absmax of the current token's K, V (float bits)
  double* ss;               // [b, H/64] partial sums of squares
  int* tcnt;                // [H/64] K chunks added to a column tile
  float* scores;            // [b, nh, S]
  float* cmax;              // [b, nh, S/CH] chunk maxima
  double* ppart;            // [b, nh, S/CH] partial softmax denominators
  double* pvpart;           // [b, nh, S/CH, hd] partial p.V
  unsigned long long* stamps;   // null, or [2 + 10L] globaltimer ns: at the start
                                // and after every grid barrier (block 0)
  unsigned long long* arrive;   // null, or [1 + 10L, grid]: each block's arrival
                                // at every grid barrier
  int L, b, H, I, kvh, S, BK, CH, w4, packed, rope, norm_round, smem, G, hd;   // smem: set by the host
  float eps, a_qmax, kv_qmax, scale;
};

namespace {

constexpr int NT = 256;               // threads per block
constexpr int NW = NT / 32;
constexpr int TN = 128;               // GEMM item: output columns
constexpr int TK = 256;               // GEMM item: K values
constexpr int NSTAGE = 3;             // weight tiles a block has in flight (4 measured no faster)
// attention item: cache columns (at most); 64 at head dim 256 (see the header)
constexpr int CHMAX = MEGAKERNEL_HD >= 256 ? 64 : 128;
constexpr int NQ = NT / CHMAX;        // threads a column in the scores stage
constexpr int VS = CHMAX + 4;         // V chunk row stride: an odd count of words
constexpr float QEPS = 1e-6f;
constexpr float NEG_INF = -1e30f;
#ifdef MEGAKERNEL_PAD
constexpr bool PAD = true;            // the head dim from the launch (p.hd)
#else
constexpr bool PAD = false;
#endif
#ifdef MEGAKERNEL_WIDE
constexpr bool WIDE = true;           // 9..16 query heads a kv head (GMAX below)
#else
constexpr bool WIDE = false;
#endif

__device__ __forceinline__ float ld_f(const float* p) { return __ldcg(p); }
__device__ __forceinline__ float ld_f(const __nv_bfloat16* p) {
  return __bfloat162float(__ldcg(p));
}
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// round to the model / compute type T and widen again
template <typename T>
__device__ __forceinline__ float rt(float v) {
  if constexpr (sizeof(T) == 2) return __bfloat162float(__float2bfloat16_rn(v));
  return v;
}

// rotate-half RoPE on one pair, every operation rounded to T as PyTorch
// rounds it (and never contracted into a fused multiply-add)
template <typename T>
__device__ __forceinline__ void rope_pair(float x1, float x2, float c, float s, float& r1,
                                          float& r2) {
  r1 = rt<T>(__fsub_rn(rt<T>(__fmul_rn(x1, c)), rt<T>(__fmul_rn(x2, s))));
  r2 = rt<T>(__fadd_rn(rt<T>(__fmul_rn(x2, c)), rt<T>(__fmul_rn(x1, s))));
}

// the product's fixup, as a division
__device__ __forceinline__ float fixup(int acc, float sx, float sw) {
  return __int2float_rn(acc) / __fmul_rn(__fadd_rn(sx, QEPS), __fadd_rn(sw, QEPS));
}

// small signed integer -> double without a conversion instruction
__device__ __forceinline__ double int_to_double(int v) {
  return __hiloint2double(0x43300000, (int)((unsigned)v ^ 0x80000000u)) - 4503601774854144.0;
}

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int o = 16; o > 0; o /= 2) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o /= 2) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Block-wide maximum; every thread gets the result.
__device__ float block_max(float v) {
  __shared__ float red[NW];
  v = warp_max(v);
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = v;
  __syncthreads();
  float t = red[0];
#pragma unroll
  for (int w = 1; w < NW; ++w) t = fmaxf(t, red[w]);
  __syncthreads();
  return t;
}

// p.G (query heads a kv head) as an attention stage starts: the empty asm
// hides that it is the same value everywhere, so nothing derived from it is
// hoisted out of the layer loop and kept live through the products, whose
// registers are at the limit
__device__ __forceinline__ int stage_g(const Params& p) {
  int g = p.G;
  asm volatile("" : "+r"(g));
  return g;
}

// the head dim: HD, or p.hd in the padded build, re-read as stage_g does
template <int HD>
__device__ __forceinline__ int head_dim(const Params& p) {
  if constexpr (PAD) {
    int h = p.hd;
    asm volatile("" : "+r"(h));
    return h;
  } else {
    return HD;
  }
}

// K chunks of TK values a product of depth K has (the padded build: the last
// one zero-padded; the others take K % TK == 0)
__device__ __forceinline__ int k_chunks(int K) { return PAD ? (K + TK - 1) / TK : K / TK; }

// v, hidden from the compiler as stage_g hides p.G, so that what is derived
// from it is computed where used and not held across the products
__device__ __forceinline__ int fresh(int v) {
  asm volatile("" : "+r"(v));
  return v;
}

__device__ __forceinline__ float act_scale(const Params& p, const int* amax) {
  return p.a_qmax / (__int_as_float(__ldcg(amax)) + QEPS);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(s), "l"(gmem));
}
// 16 bytes, zeros when !in (gmem is then not read)
__device__ __forceinline__ void cp_async16z(void* smem, const void* gmem, bool in) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(s), "l"(gmem),
               "r"(in ? 16 : 0));
}
__device__ __forceinline__ void cp_async8(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* smem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}
__device__ __forceinline__ void ldmatrix_x2(uint32_t* r, const void* smem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(s));
}

// ---------------------------------------------------------------------------
// residual tiles and norm stages
// ---------------------------------------------------------------------------

// Column tile `nt` (TN columns) of every slot: h = src (+ fixup of acc,
// which it clears) -> y, and the tile's float64 sum of squares -> ss.
// amax: the absmax cells behind acc's activation scale.
template <typename T>
__device__ void resid_tile(const Params& p, int nt, const T* src, int* acc, const int* amax,
                           const float* sw) {
  __shared__ double red[NW];
  const int H = p.H, n_tiles = H / TN, c = threadIdx.x % TN, sg = threadIdx.x / TN;
  const int col = nt * TN + c;
  T* y = static_cast<T*>(p.y);
  for (int i0 = 0; i0 < p.b; i0 += NT / TN) {
    const int i = i0 + sg;
    double ss = 0.0;
    if (i < p.b) {
      float hv = ld_f(src + (size_t)i * H + col);
      if (acc) {
        int* a = acc + (size_t)i * H + col;
        hv = rt<T>(__fadd_rn(hv, rt<T>(fixup(__ldcg(a), act_scale(p, amax + i), __ldg(sw + col)))));
        *a = 0;
      }
      put(y + (size_t)i * H + col, hv);
      ss = (double)hv * (double)hv;
    }
    ss = warp_sum(ss);
    if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = ss;
    __syncthreads();
    if (threadIdx.x < NT / TN && i0 + (int)threadIdx.x < p.b) {
      double t = 0.0;
#pragma unroll
      for (int w = 0; w < TN / 32; ++w) t += red[threadIdx.x * (TN / 32) + w];
      p.ss[(size_t)(i0 + threadIdx.x) * n_tiles + nt] = t;
    }
    __syncthreads();
  }
}

// RMSNorm of y with `gain` -> xn (fp32) and the rows' absmax -> amax
// (atomicMax). Every block first derives each row's RMS from the float64
// partial sums of squares (a warp a row, the same order everywhere); the
// b x H elements are then spread over all threads of the grid, 32
// neighbouring columns of one row a warp.
template <typename T>
__device__ void norm_stage(const Params& p, const float* gain, int* amax) {
  __shared__ float rr[32];
  const int H = p.H, n_tiles = H / TN, lane = threadIdx.x % 32;
  const int n = p.b * H, stride = gridDim.x * NT;
  const T* y = static_cast<const T*>(p.y);
  // the block's first elements, loaded while the RMS is derived
  const int e1 = blockIdx.x * NT + threadIdx.x;
  float y1 = 0.f, g1 = 0.f;
  if (e1 < n) {
    y1 = ld_f(y + e1);
    g1 = __ldg(gain + e1 % H);
  }
  for (int i = threadIdx.x / 32; i < p.b; i += NW) {
    double ss = 0.0;
    for (int t = lane; t < n_tiles; t += 32) ss += __ldcg(p.ss + (size_t)i * n_tiles + t);
    ss = warp_sum(ss);
    const float var = (float)(ss * (1.0 / (double)H));
    if (lane == 0) rr[i] = rsqrtf(var + p.eps);
  }
  __syncthreads();
  for (int e0 = blockIdx.x * NT; e0 < n; e0 += stride) {   // a whole block steps together
    const int e = e0 + threadIdx.x;
    float xn = 0.f;
    if (e < n) {
      const float yv = e0 == (int)blockIdx.x * NT ? y1 : ld_f(y + e);
      const float gv = e0 == (int)blockIdx.x * NT ? g1 : __ldg(gain + e % H);
      xn = __fmul_rn(rt<T>(__fmul_rn(yv, rr[e / H])), gv);
      if (p.norm_round) xn = rt<T>(xn);
      p.xn[e] = xn;
    }
    const float am = warp_max(fabsf(xn));
    if (lane == 0 && e < n) atomicMax(amax + e / H, __float_as_int(am));
  }
}

// SiLU(gate) * up in fp32, cast to T -> act [b, I] and its rows' absmax
// (atomicMax), the b x I elements spread over all threads of the grid.
// Clears the accumulator.
template <typename T>
__device__ void silu_stage(const Params& p, int l) {
  const int I = p.I, n = p.b * I, stride = gridDim.x * NT;
  const float* sw = p.gu_s + (size_t)l * 2 * I;
  for (int e0 = blockIdx.x * NT; e0 < n; e0 += stride) {
    const int e = e0 + threadIdx.x;
    float a = 0.f;
    if (e < n) {
      const int i = e / I, c = e % I;
      const float sxp = act_scale(p, p.amax + p.b + i);
      int* acc = p.acc_gu + (size_t)i * 2 * I;
      const float g = rt<T>(fixup(__ldcg(acc + c), sxp, __ldg(sw + c)));
      const float u = rt<T>(fixup(__ldcg(acc + I + c), sxp, __ldg(sw + I + c)));
      acc[c] = 0;
      acc[I + c] = 0;
      const float sig = 1.0f / __fadd_rn(1.0f, expf(-g));
      a = rt<T>(__fmul_rn(__fmul_rn(g, sig), u));
      put(static_cast<T*>(p.act) + e, a);
    }
    const float am = warp_max(fabsf(a));
    if (threadIdx.x % 32 == 0 && e < n) atomicMax(p.amax + 3 * p.b + e / I, __float_as_int(am));
  }
}

// ---------------------------------------------------------------------------
// GEMM stage
// ---------------------------------------------------------------------------

struct GemmSmem {
  uint8_t ring[NSTAGE][TN * TK];      // weight tiles: rows = output columns, K contiguous
  uint8_t xraw[NSTAGE][32 * TK * 4];  // the items' activations as they lie in memory
  uint8_t xt[32 * TK];                // quantized x tile: rows = slots, K contiguous
};

// the block's contiguous run of items [lo, hi)
__device__ __forceinline__ void item_range(int items, int& lo, int& hi) {
  lo = (int)((long long)blockIdx.x * items / gridDim.x);
  hi = (int)((long long)(blockIdx.x + 1) * items / gridDim.x);
}

// 16-byte chunk `ch` of row `row` of a tile whose rows are `rb` bytes
__device__ __forceinline__ int swz(int row, int ch, int rb) {
  return row * rb + ((ch ^ (row & 7)) << 4);
}

// Start the copy of an item's weight tile (TN rows of TK or, packed, TK/2
// bytes, contiguous: w is [N / TN, k_chunks(K)] such tiles) into ring slot
// `slot`.
template <bool W4>
__device__ __forceinline__ void issue_w(const uint8_t* w, int item, GemmSmem* s, int slot) {
  constexpr int RB = W4 ? TK / 2 : TK, CPR = RB / 16;
  const uint8_t* base = w + (size_t)item * TN * RB;
#pragma unroll
  for (int q = 0; q < TN * CPR / NT; ++q) {
    const int idx = threadIdx.x + q * NT, row = idx / CPR, ch = idx % CPR;
    cp_async16(s->ring[slot] + swz(row, ch, RB), base + (size_t)idx * 16);
  }
}

// Start the copy of an item's activations (b rows of TK values of type S:
// K chunk kc, or at W4 the chunk's low-half and high-half K values) from
// src [b, K] into slot `slot`. The padded build: zeros past K (past K/2 in
// each half at W4: K % 16 == 0 keeps each 16-byte piece whole on one side).
template <typename S, bool W4>
__device__ __forceinline__ void issue_x(const S* src, int K, int b, int kc, GemmSmem* s,
                                        int slot) {
  constexpr int VPC = 16 / sizeof(S), CPR = TK / VPC;   // values a chunk, chunks a row
  for (int idx = threadIdx.x; idx < b * CPR; idx += NT) {
    const int row = idx / CPR, v = (idx % CPR) * VPC;
    if constexpr (PAD) {
      const int kk = W4 ? kc * (TK / 2) + (v < TK / 2 ? v : v - TK / 2) : kc * TK + v;
      const bool in = kk < (W4 ? K / 2 : K);
      const int col = W4 && v >= TK / 2 ? K / 2 + kk : kk;
      cp_async16z(s->xraw[slot] + (size_t)idx * 16, src + (in ? (size_t)row * K + col : 0), in);
    } else {
      const int col = W4 ? (v < TK / 2 ? kc * (TK / 2) + v : K / 2 + kc * (TK / 2) + v - TK / 2)
                         : kc * TK + v;
      cp_async16(s->xraw[slot] + (size_t)idx * 16, src + (size_t)row * K + col);
    }
  }
}

// Start the copies of the block's first NSTAGE - 1 weight tiles of a stage.
// Weights are read-only, so this may run before the barrier that precedes
// the stage (and over the attention stages' shared memory, once the block
// is done with it). Always commits NSTAGE - 1 groups.
template <bool W4>
__device__ __forceinline__ void prefetch_w(GemmSmem* s, const uint8_t* w, int N, int K) {
  int lo, hi;
  item_range(N / TN * k_chunks(K), lo, hi);
#pragma unroll
  for (int k = 0; k < NSTAGE - 1; ++k) {
    if (lo + k < hi) issue_w<W4>(w, lo + k, s, k);
    cp_async_commit();
  }
}

__device__ __forceinline__ uint32_t pack4(float a, float b, float c, float d, float sx) {
  return (uint32_t)(__float2int_rn(a * sx) & 0xff) | ((uint32_t)(__float2int_rn(b * sx) & 0xff) << 8) |
         ((uint32_t)(__float2int_rn(c * sx) & 0xff) << 16) | ((uint32_t)__float2int_rn(d * sx) << 24);
}
__device__ __forceinline__ float bf_lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf_hi(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }

// Slot `slot`'s activations, quantized per row with the row's scale sxs ->
// xt (rows b .. 16 mt - 1 zero).
template <typename S>
__device__ __forceinline__ void quant_x(int b, int mt, const float* sxs, GemmSmem* s, int slot) {
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const int idx = threadIdx.x + q * NT, row = idx / 16, ch = idx % 16;
    if (q < mt) {
      uint4 v = make_uint4(0, 0, 0, 0);
      if (row < b) {
        const float sx = sxs[row];
        const uint4* u = reinterpret_cast<const uint4*>(s->xraw[slot] + (size_t)row * TK * sizeof(S)) +
                         ch * sizeof(S);
        if constexpr (sizeof(S) == 2) {
          const uint4 u0 = u[0], u1 = u[1];
          v.x = pack4(bf_lo(u0.x), bf_hi(u0.x), bf_lo(u0.y), bf_hi(u0.y), sx);
          v.y = pack4(bf_lo(u0.z), bf_hi(u0.z), bf_lo(u0.w), bf_hi(u0.w), sx);
          v.z = pack4(bf_lo(u1.x), bf_hi(u1.x), bf_lo(u1.y), bf_hi(u1.y), sx);
          v.w = pack4(bf_lo(u1.z), bf_hi(u1.z), bf_lo(u1.w), bf_hi(u1.w), sx);
        } else {
          uint4 w[4];
#pragma unroll
          for (int k = 0; k < 4; ++k) w[k] = u[k];
          v.x = pack4(__uint_as_float(w[0].x), __uint_as_float(w[0].y),
                      __uint_as_float(w[0].z), __uint_as_float(w[0].w), sx);
          v.y = pack4(__uint_as_float(w[1].x), __uint_as_float(w[1].y),
                      __uint_as_float(w[1].z), __uint_as_float(w[1].w), sx);
          v.z = pack4(__uint_as_float(w[2].x), __uint_as_float(w[2].y),
                      __uint_as_float(w[2].z), __uint_as_float(w[2].w), sx);
          v.w = pack4(__uint_as_float(w[3].x), __uint_as_float(w[3].y),
                      __uint_as_float(w[3].z), __uint_as_float(w[3].w), sx);
        }
      }
      *reinterpret_cast<uint4*>(s->xt + swz(row, ch, TK)) = v;
    }
  }
}

// Column tile `nt` is done by this block for `count` K chunks: add them to
// the tile's counter; the block that completes it applies the fixup and the
// residual add (resid_tile).
template <typename T>
__device__ void tile_done(const Params& p, int nt, int count, int kch, int* acc,
                          const int* amax, const float* sw) {
  __shared__ int last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(p.tcnt + nt, count) + count == kch;
  __syncthreads();
  if (last) {
    __threadfence();
    resid_tile<T>(p, nt, static_cast<const T*>(p.y), acc, amax, sw);
    if (threadIdx.x == 0) p.tcnt[nt] = 0;
  }
}

// activations [b, K] (x) w [N, K(/2)] -> += acc [b, N], after prefetch_w.
// src: the activations of type S, quantized per row with their absmax as
// they arrive; RESID: the residual add once a column tile is complete (o
// and down products).
template <typename T, typename S, bool W4, bool RESID>
__device__ void gemm_stage(const Params& p, GemmSmem* s, const uint8_t* w, int N, int K,
                           const S* src, const int* amax, int* acc, const float* sw) {
  constexpr int RB = W4 ? TK / 2 : TK;
  __shared__ float sxs[32];
  const int kch = k_chunks(K), b = p.b;
  const int nb_n = (b + 7) / 8, mt = b > 16 ? 2 : 1;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32, g = lane / 4, t = lane % 4;
  const int mi = warp & 3, kh = warp >> 2;    // m16 tiles mi and mi + 4, K half kh
  int lo, hi;
  item_range(N / TN * kch, lo, hi);
  // the activations of the items whose weights prefetch_w started
#pragma unroll
  for (int k = 0; k < NSTAGE - 1; ++k)
    if (lo + k < hi) issue_x<S, W4>(src, K, b, (lo + k) % kch, s, k);
  cp_async_commit();
  if ((int)threadIdx.x < b) sxs[threadIdx.x] = act_scale(p, amax + threadIdx.x);
  int c[2][4][4] = {};
  int first = lo;                       // first item of the current column tile
  for (int item = lo, k = 0; item < hi; ++item, ++k) {
    const int nt = item / kch;
    if (k == 0)
      cp_async_wait<0>();
    else
      cp_async_wait<NSTAGE - 2>();      // this thread's part of item k has landed
    __syncthreads();                    // all of it; and everyone is done with item k - 1
    if (item + NSTAGE - 1 < hi) {
      const int slot = (k + NSTAGE - 1) % NSTAGE;
      issue_w<W4>(w, item + NSTAGE - 1, s, slot);
      issue_x<S, W4>(src, K, b, (item + NSTAGE - 1) % kch, s, slot);
    }
    cp_async_commit();
    quant_x<S>(b, mt, sxs, s, k % NSTAGE);
    __syncthreads();
    const uint8_t* tile = s->ring[k % NSTAGE];
#pragma unroll
    for (int st = 0; st < 4; ++st) {
      uint32_t a[2][4];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = (mi + 4 * h) * 16 + ((lane >> 3) & 1) * 8 + (lane & 7);
        if constexpr (W4) {
          ldmatrix_x4(a[h], tile + swz(row, st * 2 + (lane >> 4), RB));
#pragma unroll
          for (int r = 0; r < 4; ++r) a[h][r] = sext_nibbles(kh ? a[h][r] >> 4 : a[h][r]);
        } else {
          ldmatrix_x4(a[h], tile + swz(row, kh * 8 + st * 2 + (lane >> 4), RB));
        }
      }
#pragma unroll
      for (int nb = 0; nb < 4; ++nb)
        if (nb < nb_n) {
          uint32_t bf[2];
          const int xr = nb * 8 + (lane & 7);
          ldmatrix_x2(bf, s->xt + swz(xr, kh * 8 + st * 2 + ((lane >> 3) & 1), TK));
          mma_s8(c[0][nb], a[0], bf);
          mma_s8(c[1][nb], a[1], bf);
        }
    }
    if (item + 1 == hi || (item + 1) / kch != nt) {      // the tile's last item here
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int nb = 0; nb < 4; ++nb)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int n = nt * TN + (mi + 4 * h) * 16 + g + (e >= 2 ? 8 : 0);
            const int tok = nb * 8 + t * 2 + (e & 1);
            if (nb < nb_n && tok < b) atomicAdd(acc + (size_t)tok * N + n, c[h][nb][e]);
            c[h][nb][e] = 0;
          }
      if constexpr (RESID) tile_done<T>(p, nt, item + 1 - first, kch, acc, amax, sw);
      first = item + 1;
    }
  }
  cp_async_wait<0>();
  __syncthreads();                      // the stage's shared memory is free again
}

// ---------------------------------------------------------------------------
// attention stages
// ---------------------------------------------------------------------------

constexpr int NCMAX = 256;            // cache chunks (and BK blocks) a slot may have
// query heads a kv head (p.G, at run time): the build of GMAX = 8 takes
// 1..8, that of 16 (MEGAKERNEL_WIDE) 9..16
constexpr int GMAX = WIDE ? 16 : 8, GMIN = WIDE ? 9 : 1;
constexpr int HPW = GMAX > NW ? 2 : 1;   // heads a warp takes where a warp takes a head

// the query heads' rows of the q.k loop for G query heads a kv head: its
// register tile (1, 2, 4 or 8 heads), and 16 past 8, which runs two passes
// of 8
__device__ __forceinline__ int g_tile(int G) {
  return G <= 1 ? 1 : G <= 2 ? 2 : G <= 4 ? 4 : G <= 8 || !WIDE ? 8 : 16;
}

// Sized for GMAX query heads a kv head, whatever p.G is: the kernel runs one
// block an SM, and the GEMM stages' ring takes about as much. The wide build
// at head dim 128 (and the padded build, sized as 128) keeps one buffer of
// RoPE columns (TB): two would make the scores stage 258 KB, over the 227 KB
// a block may take, while one leaves 188 KB, under GemmSmem's 200 KB. Its
// chunk's columns then load when a run of items reaches a new chunk, not
// behind the previous item (as decode_attn.cuh does at 128).
template <int HD>
struct AttnSmem {
  static constexpr int TB = (WIDE && HD >= 128) || HD >= 256 ? 1 : 2;
  double sq[GMAX * HD];                               // rotated query, float64 [G][hd]
                                                      // (scores stage: g_tile(G) rows,
                                                      // the padding rows zero)
  union {
    struct {                                          // scores
      double red[NQ * GMAX * CHMAX];                  // part sums of q.k [NQ][G][CHMAX]
      float scf[GMAX * CHMAX];                        // the chunk's scores
      uint8_t kbuf[2][HD * CHMAX];                    // K chunk [hd(/2)][CHMAX], two in flight
      float tab[TB][2][HD / 2 * CHMAX];               // its RoPE cos, sin [hd/2][CHMAX]
      float ksb[2][CHMAX];                            // its K inverse scales
      int qacc[2][GMAX * HD];                         // the query heads' accumulators,
      float qsw[2][GMAX * HD];                        //   weight scales
      float qcs[2][2][HD / 2];                        //   and RoPE at the slot's position
      uint32_t lut4[256];                             // byte -> bf16 pair of its nibbles
      uint16_t lut8[256];                             // byte -> bf16 of the int8
      float sxa[32];                                  // the slots' activation scales
    } a;
    struct {                                          // softmax.V
      double spv[CHMAX * GMAX];                       // p * vs in the compute type [CHMAX][G]
      float spf[GMAX * CHMAX];                        // p
      uint8_t vbuf[HD * VS];                          // V chunk [hd(/2)][VS]
      double redd[NT];
      double chp[GMAX][NCMAX];                        // finish: the chunks' partial sums of p
      float chm[GMAX][NCMAX];                         //   and maxima
      float bal[GMAX][NCMAX];                         //   each block's alpha
      float kf[HD], vf[HD];                           //   the current token, folded
      float vsc[CHMAX];                               // the chunk's V scales
      float sm[GMAX], scur[GMAX], fin_m[GMAX], fin_l[GMAX];
    } v;
  } u;
  int first[33];                                      // items before each slot
  int lens[32];                                       // the slots' lengths
};

// Items of an attention stage: per slot, ceil(len / CH) chunks (at least
// one with `one`) for each kv head; first[i] counts those before slot i,
// lens[i] is slot i's length.
template <int HD>
__device__ int prep_items(const Params& p, AttnSmem<HD>* s, bool one) {
  if ((int)threadIdx.x < p.b) {
    const int len = __ldg(p.lens + threadIdx.x), c = (len + p.CH - 1) / p.CH;
    s->lens[threadIdx.x] = len;
    s->first[threadIdx.x + 1] = (one ? max(c, 1) : c) * p.kvh;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    s->first[0] = 0;
    for (int i = 0; i < p.b; ++i) s->first[i + 1] += s->first[i];
  }
  __syncthreads();
  return s->first[p.b];
}

__device__ __forceinline__ void find_item(const Params& p, const int* first, int r, int& i,
                                          int& hh, int& c) {
  i = 0;
  while (r >= first[i + 1]) ++i;
  const int loc = r - first[i];      // chunk-major: the kv heads of a chunk in a row
  c = loc / p.kvh;
  hh = loc % p.kvh;
}

// the G query heads of kv head hh, rotated in T and rounded to the compute
// type -> sq (float64)
template <typename T, int HD>
__device__ void rotate_query(const Params& p, int l, int i, int hh, double* sq) {
  const int hd = head_dim<HD>(p), H2 = hd / 2;
  const int G = stage_g(p), q_dim = p.kvh * G * hd, Dq = q_dim + 2 * p.kvh * hd;
  const float sxi = act_scale(p, p.amax + i);
  const int* acc = p.acc_qkv + (size_t)i * Dq;
  const float* sw = p.qkv_s + (size_t)l * Dq;
  const float* qc = p.qcos + (size_t)i * H2;
  const float* qs = p.qsin + (size_t)i * H2;
  for (int idx = threadIdx.x; idx < G * H2; idx += NT) {
    const int g = idx / H2, j = idx % H2, c1 = (hh * G + g) * hd + j, c2 = c1 + H2;
    const float q1 = rt<T>(fixup(__ldcg(acc + c1), sxi, __ldg(sw + c1)));
    const float q2 = rt<T>(fixup(__ldcg(acc + c2), sxi, __ldg(sw + c2)));
    float r1, r2;
    rope_pair<T>(q1, q2, rt<T>(__ldg(qc + j)), rt<T>(__ldg(qs + j)), r1, r2);
    sq[g * hd + j] = (double)r1;
    sq[g * hd + j + H2] = (double)r2;
  }
}

// The current token's K and V of slot i, pair idx of the kv_dim / 2 pairs
// (kv head idx / (hd/2), its columns j and j + hd/2): K rotated in "post"
// mode.
template <typename T, int HD>
__device__ __forceinline__ void kv_pair(const Params& p, int l, int i, int idx, float& k1,
                                        float& k2, float& v1, float& v2) {
  const int hd = head_dim<HD>(p), H2 = hd / 2;
  const int kv_dim = p.kvh * hd, q_dim = p.H, Dq = q_dim + 2 * kv_dim;
  const float sxi = act_scale(p, p.amax + i);
  const int* acc = p.acc_qkv + (size_t)i * Dq;
  const float* sw = p.qkv_s + (size_t)l * Dq;
  const int c1 = q_dim + (idx / H2) * hd + idx % H2, c2 = c1 + H2;
  k1 = rt<T>(fixup(__ldcg(acc + c1), sxi, __ldg(sw + c1)));
  k2 = rt<T>(fixup(__ldcg(acc + c2), sxi, __ldg(sw + c2)));
  if (!p.rope) {   // "post": the cache holds rotated K
    float r1, r2;
    rope_pair<T>(k1, k2, rt<T>(__ldg(p.qcos + (size_t)i * H2 + idx % H2)),
                 rt<T>(__ldg(p.qsin + (size_t)i * H2 + idx % H2)), r1, r2);
    k1 = r1;
    k2 = r2;
  }
  v1 = rt<T>(fixup(__ldcg(acc + kv_dim + c1), sxi, __ldg(sw + kv_dim + c1)));
  v2 = rt<T>(fixup(__ldcg(acc + kv_dim + c2), sxi, __ldg(sw + kv_dim + c2)));
}

// Items that quantize the current token's K and V per token, NT pairs of a
// slot each: kv_absmax (scores stage) takes each slice's absmax into the
// slot's cells (atomicMax on the float's bits); kv_quant (softmax.V stage)
// writes kint, vint and, from slice 0, kinv, vinv. Item k goes to block k
// in the first and to block grid - 1 - k in the second, the blocks whose
// runs of chunk items are shortest there.
__device__ __forceinline__ int kv_items(const Params& p, int hd) {
  return p.b * ((p.kvh * hd / 2 + NT - 1) / NT);
}

template <typename T, int HD>
__device__ void kv_absmax(const Params& p, int l) {
  const int hd = head_dim<HD>(p), per = (p.kvh * hd / 2 + NT - 1) / NT;
  for (int k = blockIdx.x; k < kv_items(p, hd); k += gridDim.x) {
    const int i = k / per, idx = (k % per) * NT + threadIdx.x;
    float kam = 0.f, vam = 0.f;
    if (idx < p.kvh * hd / 2) {
      float k1, k2, v1, v2;
      kv_pair<T, HD>(p, l, i, idx, k1, k2, v1, v2);
      kam = fmaxf(fabsf(k1), fabsf(k2));
      vam = fmaxf(fabsf(v1), fabsf(v2));
    }
    kam = block_max(kam);
    vam = block_max(vam);
    if (threadIdx.x == 0) {
      atomicMax(p.kvmax + i, __float_as_int(kam));
      atomicMax(p.kvmax + p.b + i, __float_as_int(vam));
    }
  }
}

template <typename T, int HD>
__device__ void kv_quant(const Params& p, int l) {
  const int hd = head_dim<HD>(p), H2 = hd / 2;
  const int per = (p.kvh * H2 + NT - 1) / NT, kv_dim = p.kvh * hd;
  for (int k = gridDim.x - 1 - blockIdx.x; k < kv_items(p, hd); k += gridDim.x) {
    const int i = k / per, idx = (k % per) * NT + threadIdx.x;
    const float ks_s = p.kv_qmax / (__int_as_float(__ldcg(p.kvmax + i)) + QEPS);
    const float vs_s = p.kv_qmax / (__int_as_float(__ldcg(p.kvmax + p.b + i)) + QEPS);
    if (idx < p.kvh * H2) {
      float k1, k2, v1, v2;
      kv_pair<T, HD>(p, l, i, idx, k1, k2, v1, v2);
      const size_t o = ((size_t)l * p.b + i) * kv_dim + (idx / H2) * hd + idx % H2;
      p.kint[o] = (int8_t)__float2int_rn(k1 * ks_s);
      p.kint[o + H2] = (int8_t)__float2int_rn(k2 * ks_s);
      p.vint[o] = (int8_t)__float2int_rn(v1 * vs_s);
      p.vint[o + H2] = (int8_t)__float2int_rn(v2 * vs_s);
    }
    if (k % per == 0 && threadIdx.x == 0) {
      p.kinv[(size_t)l * p.b + i] = 1.0f / (ks_s + QEPS);
      p.vinv[(size_t)l * p.b + i] = 1.0f / (vs_s + QEPS);
    }
  }
}

// the G query heads from the accumulators, weight scales and RoPE values
// in shared memory (as rotate_query) -> sq, and rows G..GB-1 of sq zero
template <typename T>
__device__ __forceinline__ void rotate_query_smem(int G, int GB, int hd, const int* qacc,
                                                  const float* qsw, const float* qc,
                                                  const float* qs, float sxi, double* sq) {
  const int H2 = hd / 2;
  for (int idx = threadIdx.x; idx < GB * H2; idx += NT) {
    const int g = idx / H2, j = idx % H2, c1 = g * hd + j, c2 = c1 + H2;
    float r1 = 0.f, r2 = 0.f;
    if (g < G) {
      const float q1 = rt<T>(fixup(qacc[c1], sxi, qsw[c1]));
      const float q2 = rt<T>(fixup(qacc[c2], sxi, qsw[c2]));
      rope_pair<T>(q1, q2, rt<T>(qc[j]), rt<T>(qs[j]), r1, r2);
    }
    sq[c1] = (double)r1;
    sq[c2] = (double)r2;
  }
}

__device__ __forceinline__ uint32_t bf2_bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}
// bf16 pair arithmetic with an explicit rounding mode, which the compiler
// never contracts into a fused multiply-add
__device__ __forceinline__ uint32_t bf2_mul_rn(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("mul.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}
__device__ __forceinline__ uint32_t bf2_add_rn(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("add.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

// q.k of cache column `col` of the item in buffer bf against GB query heads
// from g0 (sq's rows G..g_tile(G)-1 are zero; thread part q of NQ takes PQ
// of the hd/2 pairs) -> red (the G real heads' part sums). In bf16 the RoPE of the
// cached integers runs on bf16 pairs (a product of two bf16 values is exact
// in fp32, so one bf16 rounding of it is the fp32 product rounded to bf16,
// and a bf16 sum of two bf16 values rounds as the fp32 sum does).
template <typename T, int GB, int HD>
__device__ __forceinline__ void qk_col(const Params& p, AttnSmem<HD>* s, int bf, int q, int col,
                                       int ncol, int g0) {
  constexpr int TB = AttnSmem<HD>::TB;
  const int hd = head_dim<HD>(p), H2 = hd / 2, PQ = H2 / NQ;
  constexpr bool BF = sizeof(T) == 2;
  auto& A = s->u.a;
  double a[GB];
#pragma unroll
  for (int g = 0; g < GB; ++g) a[g] = 0.0;
  if (col < ncol) {
    const float ksc = A.ksb[bf][col];
    const float sl_t = rt<T>(ksc);
    const uint8_t* kb = A.kbuf[bf];
    const float* tc = A.tab[TB == 2 ? bf : 0][0];
    const float* ts = A.tab[TB == 2 ? bf : 0][1];
    const uint32_t sl2 = bf2_bits(__floats2bfloat162_rn(sl_t, sl_t));
#pragma unroll 4
    for (int u = 0; u < PQ; ++u) {
      const int j = q * PQ + u;
      float r1, r2;
      if constexpr (BF) {
        const uint32_t kk = p.packed ? A.lut4[kb[j * CHMAX + col]]
                                     : (uint32_t)A.lut8[kb[j * CHMAX + col]] |
                                           ((uint32_t)A.lut8[kb[(j + H2) * CHMAX + col]] << 16);
        uint32_t r;                   // (r1, r2) as a bf16 pair
        if (p.rope) {
          const uint32_t cs = bf2_bits(__floats2bfloat162_rn(tc[j * CHMAX + col] * ksc,
                                                             ts[j * CHMAX + col] * ksc));
          const uint32_t kc = bf2_mul_rn(kk, __byte_perm(cs, 0, 0x1010));   // (k1 c, k2 c)
          const uint32_t ks = bf2_mul_rn(kk, __byte_perm(cs, 0, 0x3232));   // (k1 s, k2 s)
          // (k1 c - k2 s, k2 c + k1 s)
          r = bf2_add_rn(kc, __byte_perm(ks, 0, 0x1032) ^ 0x8000u);
        } else {
          r = bf2_mul_rn(kk, sl2);
        }
        r1 = bf_lo(r);
        r2 = bf_hi(r);
      } else {
        float k1, k2;
        if (p.packed) {
          const uint8_t v = kb[j * CHMAX + col];
          k1 = (float)((int8_t)(v << 4) >> 4);
          k2 = (float)((int8_t)v >> 4);
        } else {
          k1 = (float)(int8_t)kb[j * CHMAX + col];
          k2 = (float)(int8_t)kb[(j + H2) * CHMAX + col];
        }
        if (p.rope) {
          rope_pair<T>(k1, k2, rt<T>(tc[j * CHMAX + col] * ksc), rt<T>(ts[j * CHMAX + col] * ksc),
                       r1, r2);
        } else {
          r1 = rt<T>(k1 * sl_t);
          r2 = rt<T>(k2 * sl_t);
        }
      }
      const double d1 = (double)r1, d2 = (double)r2;
#pragma unroll
      for (int g = 0; g < GB; ++g)
        a[g] = fma(s->sq[(g0 + g) * hd + j], d1, fma(s->sq[(g0 + g) * hd + j + H2], d2, a[g]));
    }
  }
#pragma unroll
  for (int g = 0; g < GB; ++g)
    if (g0 + g < p.G) A.red[(q * p.G + g0 + g) * CHMAX + col] = a[g];
}

// Items: (slot, chunk of CH columns, kv head), a contiguous run of them a
// block: the G heads' scores of the chunk -> scores, and its maxima ->
// cmax. The next item's K bytes, K scales, query inputs and (for a new
// chunk) RoPE table columns arrive by cp.async while one is computed; the
// q.k loop runs with the register tile of g_tile(G) heads (qk_col; two
// passes of 8 past 8). Before its run, a block takes its kv_absmax items.
template <typename T, int HD>
__device__ void scores_stage(const Params& p, AttnSmem<HD>* s, int l) {
  const int hd = head_dim<HD>(p), H2 = hd / 2;
  const int G = stage_g(p), GB = g_tile(G);
  const int b = p.b, S = p.S, CH = p.CH, NC = S / CH, nh = p.kvh * G;
  const int q_dim = nh * hd, Dq = q_dim + 2 * p.kvh * hd;
  const int hdc = p.packed ? H2 : hd, tid = threadIdx.x, q = tid / CHMAX, col = tid % CHMAX;
  auto& A = s->u.a;
  {   // byte -> bf16 tables, and the slots' activation scales
    const int v = tid;
    const __nv_bfloat162 n2 = __floats2bfloat162_rn((float)((int8_t)(v << 4) >> 4),
                                                    (float)((int8_t)v >> 4));
    A.lut4[v] = bf2_bits(n2);
    A.lut8[v] = (uint16_t)(bf2_bits(__floats2bfloat162_rn((float)(int8_t)v, 0.f)) & 0xffffu);
    if (tid < b) A.sxa[tid] = act_scale(p, p.amax + tid);
  }
  const int items = prep_items<HD>(p, s, false);
  int lo, hi;
  item_range(items, lo, hi);
  int tab0 = -1, tab1 = -1;           // the chunk whose RoPE columns buffer 0 / 1 holds
  auto issue = [&](int item, int buf) {
    if (item < hi) {
      int i, hh, c;
      find_item(p, s->first, item, i, hh, c);
      const uint8_t* base = p.kq + (((size_t)l * b + i) * p.kvh + hh) * hdc * S + (size_t)c * CH;
      const int per_row = CH / 16;
      for (int idx = tid; idx < hdc * per_row; idx += NT)
        cp_async16(A.kbuf[buf] + (idx / per_row) * CHMAX + (idx % per_row) * 16,
                   base + (size_t)(idx / per_row) * S + (idx % per_row) * 16);
      if (tid < CH / 4)
        cp_async16(A.ksb[buf] + tid * 4, p.ks + ((size_t)l * b + i) * S + c * CH + tid * 4);
      const int q0 = hh * G * hd;     // the query heads' first column
      for (int idx = tid; idx < G * hd / 4; idx += NT) {
        cp_async16(A.qacc[buf] + idx * 4, p.acc_qkv + (size_t)i * Dq + q0 + idx * 4);
        cp_async16(A.qsw[buf] + idx * 4, p.qkv_s + (size_t)l * Dq + q0 + idx * 4);
      }
      if (H2 % 4 == 0) {
        if (tid < H2 / 2) {
          const int t2 = tid % (H2 / 4), tb = tid / (H2 / 4);
          cp_async16(A.qcs[buf][tb] + t2 * 4, (tb ? p.qsin : p.qcos) + (size_t)i * H2 + t2 * 4);
        }
      } else if (tid < H2) {          // rows of hd/2 floats only 8-byte aligned (hd 100)
        const int t2 = tid % (H2 / 2), tb = tid / (H2 / 2);
        cp_async8(A.qcs[buf][tb] + t2 * 2, (tb ? p.qsin : p.qcos) + (size_t)i * H2 + t2 * 2);
      }
      if (AttnSmem<HD>::TB == 2 && p.rope && (buf ? tab1 : tab0) != c) {
        const int per_t = CH / 4;
        for (int idx = tid; idx < 2 * H2 * per_t; idx += NT) {
          const int tb = idx / (H2 * per_t), r = idx % (H2 * per_t), row = r / per_t, ch = r % per_t;
          cp_async16(A.tab[buf][tb] + row * CHMAX + ch * 4,
                     (tb ? p.ksin : p.kcos) + (size_t)row * S + c * CH + ch * 4);
        }
        if (buf)
          tab1 = c;
        else
          tab0 = c;
      }
    }
    cp_async_commit();
  };
  issue(lo, 0);
  kv_absmax<T, HD>(p, l);
  for (int item = lo, k = 0; item < hi; ++item, ++k) {
    __syncthreads();                  // the previous item is done with the shared memory
    if constexpr (AttnSmem<HD>::TB == 1) {   // a new chunk: its RoPE columns, not prefetched
      int i1, h1, c1;
      find_item(p, s->first, item, i1, h1, c1);
      if (p.rope && tab0 != c1) {
        const int per_t = CH / 4;
        for (int idx = tid; idx < 2 * H2 * per_t; idx += NT) {
          const int tb = idx / (H2 * per_t), r = idx % (H2 * per_t), row = r / per_t, ch = r % per_t;
          cp_async16(A.tab[0][tb] + row * CHMAX + ch * 4,
                     (tb ? p.ksin : p.kcos) + (size_t)row * S + c1 * CH + ch * 4);
        }
        cp_async_commit();
        tab0 = c1;
      }
    }
    issue(item + 1, (k + 1) & 1);
    int i, hh, c;
    find_item(p, s->first, item, i, hh, c);
    const int bf = k & 1;
    cp_async_wait<1>();
    __syncthreads();
    rotate_query_smem<T>(G, GB, hd, A.qacc[bf], A.qsw[bf], A.qcs[bf][0], A.qcs[bf][1], A.sxa[i],
                         s->sq);
    __syncthreads();
    const int ncol = min(CH, s->lens[i] - c * CH);
    if constexpr (WIDE) {             // G = 9..16: two passes of 8, one after the other
qk_col<T, 8, HD>(p, s, bf, q, col, ncol, 0);
      qk_col<T, 8, HD>(p, s, bf, q, col, ncol, 8);
    } else {
      switch (GB) {
        case 1: qk_col<T, 1, HD>(p, s, bf, q, col, ncol, 0); break;
        case 2: qk_col<T, 2, HD>(p, s, bf, q, col, ncol, 0); break;
        case 4: qk_col<T, 4, HD>(p, s, bf, q, col, ncol, 0); break;
        default: qk_col<T, 8, HD>(p, s, bf, q, col, ncol, 0); break;
      }
    }
    __syncthreads();
    for (int idx = tid; idx < G * CHMAX; idx += NT) {
      const int g = idx / CHMAX, cl = idx % CHMAX;
      float v = NEG_INF;
      if (cl < ncol) {
        const double* r = A.red + g * CHMAX + cl;
        double t = r[0];
#pragma unroll
        for (int k = 1; k < NQ; ++k) t += r[k * G * CHMAX];
        v = (float)t * p.scale;
        p.scores[(size_t)(i * nh + hh * G + g) * S + c * CH + cl] = v;
      }
      A.scf[g * CHMAX + cl] = v;
    }
    __syncthreads();
    for (int g = tid / 32; g < G; g += NW) {
      const int lane = tid % 32;
      float m = A.scf[g * CHMAX + lane];
#pragma unroll
      for (int k = 1; k < CHMAX / 32; ++k) m = fmaxf(m, A.scf[g * CHMAX + lane + 32 * k]);
      m = warp_max(m);
      if (lane == 0) p.cmax[(size_t)(i * nh + hh * G + g) * NC + c] = m;
    }
  }
  cp_async_wait<0>();
}

// (slot i, kv head hh) after the softmax.V stage: the fp32 recurrence over
// the slot's BK blocks from the chunks' partial sums, the current token
// folded in as one more online-softmax term, the division -> attn, and the
// row's absmax for the o product's activation quant. OPT: outputs a
// thread, at least ceil(G hd / NT); NB: chunks of partial p.V sums loaded
// at a time.
template <typename T, int HD, int OPT>
__device__ void finish_head(const Params& p, AttnSmem<HD>* s, int l, int i, int hh, int nch) {
  constexpr int NB = OPT > 4 ? 1 : OPT > 2 ? 4 : 8;
  // past 4 outputs a thread the pointers are found and the first chunk's
  // partial sums loaded where used (held, they cost the wide build
  // registers it has not got)
  constexpr bool HOLD_PV = OPT <= 4;
  const int hd = head_dim<HD>(p), H2 = hd / 2;
  const int G = stage_g(p), NO = G * hd;
  const int b = p.b, CH = p.CH, NC = p.S / CH, nh = p.kvh * G, tid = threadIdx.x, lane = tid % 32;
  const int kv_dim = p.kvh * hd, q_dim = nh * hd, len = s->lens[i];
  const int cpb = p.BK / CH, nblk = (len + p.BK - 1) / p.BK;
  const bool act = __ldg(p.active + i) != 0;
  auto& V = s->u.v;
  // every load first, so that they are in flight together
  const float k_inv = __ldcg(p.kinv + (size_t)l * b + i), v_inv = __ldcg(p.vinv + (size_t)l * b + i);
  const int8_t* ki = p.kint + ((size_t)l * b + i) * kv_dim + hh * hd;
  const int8_t* vi = p.vint + ((size_t)l * b + i) * kv_dim + hh * hd;
  float kr[2] = {0.f, 0.f}, vr[2] = {0.f, 0.f}, qcs[2] = {0.f, 0.f};
  if (tid < H2) {
    kr[0] = (float)__ldcg(ki + tid);
    kr[1] = (float)__ldcg(ki + tid + H2);
    vr[0] = (float)__ldcg(vi + tid);
    vr[1] = (float)__ldcg(vi + tid + H2);
    qcs[0] = __ldg(p.qcos + (size_t)i * H2 + tid);
    qcs[1] = __ldg(p.qsin + (size_t)i * H2 + tid);
  }
  // the heads whose chunk statistics this warp walks, gw (and gw + NW in the
  // wide build), and gw's first 64, loaded here (the second head's where
  // used: held here they cost the wide build registers it has not got)
  const int gw = tid / 32;
  size_t cbase[HPW];
#pragma unroll
  for (int w = 0; w < HPW; ++w) cbase[w] = (size_t)(i * nh + hh * G + min(gw + w * NW, G - 1)) * NC;
  float cm[2];
  double cp[2];
#pragma unroll
  for (int m = 0; m < 2; ++m) {
    const int cc = lane + 32 * m;
    const bool ok = gw < G && cc < nch;
    cm[m] = ok ? __ldcg(p.cmax + cbase[0] + cc) : NEG_INF;
    cp[m] = ok ? __ldcg(p.ppart + cbase[0] + cc) : 0.0;
  }
  auto pv_of = [&](int u) {           // output u's partial sums, chunk 0
    const int o = min(tid + u * NT, NO - 1);
    return p.pvpart + (size_t)(i * nh + hh * G + o / hd) * NC * hd + o % hd;
  };
  const double* pv[HOLD_PV ? OPT : 1];
  auto pvp = [&](int u) {
    if constexpr (HOLD_PV) return pv[u]; else return pv_of(u);
  };
  double v0[HOLD_PV ? OPT : 1][NB];   // NB chunks' partial p.V, the first NB loaded here
  if constexpr (HOLD_PV) {
#pragma unroll
    for (int u = 0; u < OPT; ++u) {
      pv[u] = pv_of(u);
#pragma unroll
      for (int e = 0; e < NB; ++e) v0[u][e] = e < nch ? __ldcg(pvp(u) + (size_t)e * hd) : 0.0;
    }
  }
  rotate_query<T, HD>(p, l, i, hh, s->sq);
#pragma unroll
  for (int w = 0; w < HPW; ++w) {
    const int g = gw + w * NW;
    if (g >= G) break;
    if (w == 0) {
#pragma unroll
      for (int m = 0; m < 2; ++m)
        if (lane + 32 * m < nch) {
          V.chm[g][lane + 32 * m] = cm[m];
          V.chp[g][lane + 32 * m] = cp[m];
        }
    }
    for (int cc = lane + (w == 0 ? 64 : 0); cc < nch; cc += 32) {
      V.chm[g][cc] = __ldcg(p.cmax + cbase[w] + cc);
      V.chp[g][cc] = __ldcg(p.ppart + cbase[w] + cc);
    }
    __syncwarp();
    if (lane == 0) {   // the denominator's recurrence, block by block
      float m = NEG_INF, lsum = 0.f;
      for (int jb = 0; jb < nblk; ++jb) {
        float mb = m;
        double P = 0.0;
        for (int cc = jb * cpb; cc < min(nch, (jb + 1) * cpb); ++cc) {
          mb = fmaxf(mb, V.chm[g][cc]);
          P += V.chp[g][cc];
        }
        const float alpha = expf(m - mb);
        lsum = __fadd_rn(__fmul_rn(lsum, alpha), (float)P);
        V.bal[g][jb] = alpha;
        m = mb;
      }
      V.fin_m[g] = m;
      V.fin_l[g] = lsum;
    }
  }
  if (tid < H2) {   // the current token, folded
    const float vinv_t = rt<T>(v_inv), kinv_t = rt<T>(k_inv);
    float kf1, kf2;
    if (p.rope) {
      rope_pair<T>(kr[0], kr[1], rt<T>(qcs[0] * k_inv), rt<T>(qcs[1] * k_inv), kf1, kf2);
    } else {
      kf1 = rt<T>(kr[0] * kinv_t);
      kf2 = rt<T>(kr[1] * kinv_t);
    }
    V.kf[tid] = kf1;
    V.kf[tid + H2] = kf2;
    V.vf[tid] = rt<T>(vr[0] * vinv_t);
    V.vf[tid + H2] = rt<T>(vr[1] * vinv_t);
  }
  __syncthreads();
  for (int g = tid / 32; g < G; g += NW) {   // the current token's score: a warp a head
    double sc = 0.0;
    for (int d = lane; d < hd; d += 32) sc = fma(s->sq[g * hd + d], (double)V.kf[d], sc);
    sc = warp_sum(sc);
    if (lane == 0) V.scur[g] = (float)sc * p.scale;
  }
  __syncthreads();
  // p.V: acc = acc alpha + PV_j block by block, the chunks' partials loaded
  // NB at a time
  float am = 0.f;
  if (tid < NO) {
    float acc[OPT];
    double PV[OPT];
#pragma unroll
    for (int u = 0; u < OPT; ++u) {
      acc[u] = 0.f;
      PV[u] = 0.0;
    }
    int jb = 0;
    for (int c0 = 0; c0 < nch; c0 += NB) {
      double v[OPT][NB];
#pragma unroll
      for (int u = 0; u < OPT; ++u)
#pragma unroll
        for (int e = 0; e < NB; ++e)
          v[u][e] = c0 == 0 && HOLD_PV ? v0[HOLD_PV ? u : 0][e]
                    : c0 + e < nch ? __ldcg(pvp(u) + (size_t)(c0 + e) * hd) : 0.0;
#pragma unroll
      for (int e = 0; e < NB; ++e) {
        const int cc = c0 + e;
        if (cc < nch) {
#pragma unroll
          for (int u = 0; u < OPT; ++u) PV[u] += v[u][e];
          if ((cc + 1) % cpb == 0 || cc + 1 == nch) {     // block jb is complete
#pragma unroll
            for (int u = 0; u < OPT; ++u) {
              const float alpha = V.bal[min(tid + u * NT, NO - 1) / hd][jb];
              acc[u] = __fadd_rn(__fmul_rn(acc[u], alpha), (float)PV[u]);
              PV[u] = 0.0;
            }
            ++jb;
          }
        }
      }
    }
#pragma unroll
    for (int u = 0; u < OPT; ++u) {
      const int o = tid + u * NT, g = o / hd, d = o % hd;
      if (o >= NO) break;
      const float m = V.fin_m[g];
      const float sc = act ? V.scur[g] : NEG_INF;
      const float m_new = fmaxf(m, sc);
      const float al = expf(m - m_new);
      const float pr = act ? expf(sc - m_new) : 0.f;
      const float ll = fmaxf(__fadd_rn(__fmul_rn(V.fin_l[g], al), pr), 1e-9f);
      const float num = __fadd_rn(__fmul_rn(acc[u], al), __fmul_rn(pr, V.vf[d]));
      const float res = rt<T>(num / ll);
      put(static_cast<T*>(p.attn) + (size_t)i * q_dim + (hh * G + g) * hd + d, res);
      am = fmaxf(am, fabsf(res));
    }
  }
  am = block_max(am);
  if (tid == 0) atomicMax(p.amax + 2 * b + i, __float_as_int(am));
}

// A cache chunk (hd(/2) rows x CH bytes) of (layer l, slot i, kv head hh)
// in registers, 16 bytes a thread and pass: CHMAX / 32 passes (the most a
// chunk of hd <= 128 rows needs), at head dim 256 hd CHMAX / 16 / NT
constexpr int CHUNK_PASSES = MEGAKERNEL_HD >= 256 ? MEGAKERNEL_HD * CHMAX / 16 / NT : CHMAX / 32;
struct ChunkRegs {
  uint4 v[CHUNK_PASSES];
};

__device__ __forceinline__ void load_chunk(const Params& p, const uint8_t* cache, int hdc, int l,
                                           int i, int hh, int c, ChunkRegs& R) {
  const uint8_t* base = cache + (((size_t)l * p.b + i) * p.kvh + hh) * hdc * p.S + (size_t)c * p.CH;
  const int per_row = p.CH / 16;
#pragma unroll
  for (int q = 0; q < CHUNK_PASSES; ++q) {
    const int idx = threadIdx.x + q * NT;
    if (idx < hdc * per_row)
      R.v[q] = __ldg(reinterpret_cast<const uint4*>(base + (size_t)(idx / per_row) * p.S +
                                                    (idx % per_row) * 16));
  }
}

// ... into rows of VS bytes (an odd count of words: the p.V loop's lanes,
// one head-dim row each, fall on distinct banks)
__device__ __forceinline__ void store_chunk(const Params& p, const ChunkRegs& R, int hdc,
                                            uint8_t* buf) {
  const int per_row = p.CH / 16;
#pragma unroll
  for (int q = 0; q < CHUNK_PASSES; ++q) {
    const int idx = threadIdx.x + q * NT;
    if (idx < hdc * per_row) {
      uint32_t* d = reinterpret_cast<uint32_t*>(buf + (idx / per_row) * VS + (idx % per_row) * 16);
      d[0] = R.v[q].x; d[1] = R.v[q].y; d[2] = R.v[q].z; d[3] = R.v[q].w;
    }
  }
}

// The same chunks as scores_stage, dealt round robin: p against the prefix
// maximum of the chunk's BK block, float64 partial sums of p and of p.V ->
// ppart, pvpart. The next item's V bytes, scores, V scales and chunk maxima
// arrive in registers while one is computed. A block first takes its
// kv_quant items.
template <typename T, int HD>
__device__ void softmax_v_stage(const Params& p, AttnSmem<HD>* s, int l) {
  constexpr int SPT = (GMAX * CHMAX + NT - 1) / NT;
  const int hd = head_dim<HD>(p), H2 = hd / 2;
  const int G = stage_g(p), NO = G * hd;
  const int b = p.b, S = p.S, CH = p.CH, NC = S / CH, nh = p.kvh * G, tid = threadIdx.x;
  const int hdc = p.packed ? H2 : hd, lane = tid % 32, cpb = p.BK / CH;
  const int items = s->first[b];    // first and lens as the scores stage left them
  ChunkRegs R;
  // the next item's scores (sreg) and this warp's head's first 64 chunk
  // maxima (cmr), loaded with its V bytes; the wide build reads its scores
  // and its second head's maxima where used (held here they cost it
  // registers it has not got)
  float sreg[SPT], vsr = 0.f, cmr[2];
  auto fetch = [&](int item) {        // what the item reads from device memory
    int i, hh, c;
    find_item(p, s->first, item, i, hh, c);
    load_chunk(p, p.vq, hdc, l, i, hh, c, R);
    const int len = s->lens[i], ncol = min(CH, len - c * CH);
    const int ce = min((len + CH - 1) / CH, (c / cpb + 1) * cpb);
#pragma unroll
    for (int u = 0; u < SPT; ++u) {
      const int idx = tid + u * NT, g = idx / CHMAX, cl = idx % CHMAX;
      if (!WIDE && idx < G * CHMAX && cl < ncol)
        sreg[u] = __ldcg(p.scores + (size_t)(i * nh + hh * G + g) * S + c * CH + cl);
    }
    if (tid < ncol) vsr = __ldg(p.vs + ((size_t)l * b + i) * S + c * CH + tid);
    if (tid / 32 < G) {
      const float* cm = p.cmax + (size_t)(i * nh + hh * G + tid / 32) * NC;
      cmr[0] = lane < ce ? __ldcg(cm + lane) : NEG_INF;
      cmr[1] = lane + 32 < ce ? __ldcg(cm + lane + 32) : NEG_INF;
    }
  };
  if ((int)blockIdx.x < items) fetch(blockIdx.x);
  kv_quant<T, HD>(p, l);
  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    __syncthreads();                  // the previous item is done with the shared memory
    int i, hh, c;
    find_item(p, s->first, item, i, hh, c);
    const int len = s->lens[i], ncol = min(CH, len - c * CH);
    const int ce = min((len + CH - 1) / CH, (c / cpb + 1) * cpb);
    store_chunk(p, R, hdc, s->u.v.vbuf);
    float sc[SPT];
#pragma unroll
    for (int u = 0; u < SPT; ++u) sc[u] = WIDE ? 0.f : sreg[u];
    const float vsc = vsr;
    // the prefix maximum m_j of the chunk's block: a warp a head (two in
    // the wide build)
#pragma unroll
    for (int w = 0; w < HPW; ++w) {
      const int g = tid / 32 + w * NW;
      if (g < G) {
        const float* cm = p.cmax + (size_t)(i * nh + hh * G + g) * NC;
        float m = w == 0 ? fmaxf(cmr[0], cmr[1])
                         : fmaxf(lane < ce ? __ldcg(cm + lane) : NEG_INF,
                                 lane + 32 < ce ? __ldcg(cm + lane + 32) : NEG_INF);
        for (int cc = lane + 64; cc < ce; cc += 32) m = fmaxf(m, __ldcg(cm + cc));
        m = warp_max(m);
        if (lane == 0) s->u.v.sm[g] = m;
      }
    }
    if (tid < CHMAX) s->u.v.vsc[tid] = vsc;
    if (item + (int)gridDim.x < items) fetch(item + gridDim.x);
    __syncthreads();
    // p and p * vs of output u of the thread (the wide build takes them one
    // at a time: unrolled, its registers spilled)
    auto p_of = [&](int u) {
      const int idx = tid + u * NT, g = idx / CHMAX, cl = idx % CHMAX;
      if (idx < G * CHMAX) {
        float pr = 0.f;
        double pv = 0.0;
        if (cl < ncol) {
          const float sv = WIDE ? __ldcg(p.scores + (size_t)(i * nh + hh * G + g) * S + c * CH + cl)
                                : sc[u];
          pr = expf(sv - s->u.v.sm[g]);
          pv = (double)rt<T>(pr * s->u.v.vsc[cl]);
        }
        s->u.v.spf[g * CHMAX + cl] = pr;
        s->u.v.spv[cl * G + g] = pv;
      }
    };
    if constexpr (WIDE) {
#pragma unroll 1
      for (int u = 0; u < SPT; ++u) p_of(u);
    } else {
#pragma unroll
      for (int u = 0; u < SPT; ++u) p_of(u);
    }
    __syncthreads();
    for (int g = tid / 32; g < G; g += NW) {
      double t = 0.0;
#pragma unroll
      for (int k = 0; k < CHMAX / 32; ++k) t += (double)s->u.v.spf[g * CHMAX + lane + 32 * k];
      t = warp_sum(t);
      if (lane == 0) p.ppart[(size_t)(i * nh + hh * G + g) * NC + c] = t;
    }
    const int ncol4 = (ncol + 3) & ~3;
    auto pv_out = [&](int o, int c0, int c1) {
      const int g = o / hd, d = o % hd;
      const uint8_t* vrow = s->u.v.vbuf + (p.packed ? d % H2 : d) * VS;
      const int shift = p.packed ? (d < H2 ? 28 : 24) : 24, back = p.packed ? 28 : 24;
      double a4[4] = {0.0, 0.0, 0.0, 0.0};   // independent chains
      for (int c4 = c0; c4 < c1; c4 += 4) {
        const uint32_t w = *reinterpret_cast<const uint32_t*>(vrow + c4);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          a4[e] = fma(s->u.v.spv[(c4 + e) * G + g],
                      int_to_double((int)(((w >> (8 * e)) & 0xffu) << shift) >> back), a4[e]);
      }
      return (a4[0] + a4[1]) + (a4[2] + a4[3]);
    };
    if (NO >= NT) {
      for (int o = tid; o < NO; o += NT)
        p.pvpart[((size_t)(i * nh + hh * G + o / hd) * NC + c) * hd + o % hd] = pv_out(o, 0, ncol4);
    } else {
      // split parts of the columns an output, summed through shared memory
      // (threads past split x NO, where NO does not divide NT, take none);
      // in the padded build a part is rounded up to whole words (hd 48: 5
      // parts of 28 columns)
      const int split = NT / NO;
      const int part_w = PAD ? ((CHMAX + split - 1) / split + 3) & ~3 : CHMAX / split;
      const int o = tid % NO, part = tid / NO;
      double a = part < split ? pv_out(o, part * part_w, min(ncol4, (part + 1) * part_w)) : 0.0;
      s->u.v.redd[tid] = a;
      __syncthreads();
      if (part == 0) {
        for (int k = 1; k < split; ++k) a += s->u.v.redd[tid + k * NO];
        p.pvpart[((size_t)(i * nh + hh * G + o / hd) * NC + c) * hd + o % hd] = a;
      }
    }
  }
}

// One item per (slot, kv head), dealt round robin: finish_head with the
// fewest outputs a thread that G hd / NT needs (only those G <= GMAX can ask
// for at this head dim are built: 8 in the wide build at head dim 128).
template <typename T, int HD>
__device__ void finish_stage(const Params& p, AttnSmem<HD>* s, int l) {
  // first and lens as the scores stage left them (no GEMM tile has been
  // staged over them since)
  const int no = stage_g(p) * head_dim<HD>(p);
  for (int item = blockIdx.x; item < p.b * p.kvh; item += gridDim.x) {
    __syncthreads();                  // the previous item is done with the shared memory
    const int i = item / p.kvh, hh = item % p.kvh, nch = (s->lens[i] + p.CH - 1) / p.CH;
    if constexpr (GMAX * HD > 4 * NT) {
      if (no > 4 * NT) {
        finish_head<T, HD, 8>(p, s, l, i, hh, nch);
        continue;
      }
    }
    if constexpr (GMAX * HD > 2 * NT) {
      if (no > 2 * NT) {
        finish_head<T, HD, 4>(p, s, l, i, hh, nch);
        continue;
      }
    }
    if (no > NT)
      finish_head<T, HD, 2>(p, s, l, i, hh, nch);
    else
      finish_head<T, HD, 1>(p, s, l, i, hh, nch);
  }
}

// ---------------------------------------------------------------------------
// the kernel
// ---------------------------------------------------------------------------

__device__ __forceinline__ unsigned long long globaltimer() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %globaltimer;" : "=l"(t));
  return t;
}

// grid-wide barrier; block 0 notes the time after it, and every block the
// time it arrives, when stamps are asked for
__device__ __forceinline__ void barrier(cg::grid_group& grid, const Params& p, int& k) {
  if (p.arrive && threadIdx.x == 0) p.arrive[(size_t)(k - 1) * gridDim.x + blockIdx.x] = globaltimer();
  grid.sync();
  if (p.stamps && blockIdx.x == 0 && threadIdx.x == 0) p.stamps[k] = globaltimer();
  ++k;
}

// zero n ints, spread over the grid
__device__ __forceinline__ void clear(int* a, size_t n) {
  for (size_t k = (size_t)blockIdx.x * NT + threadIdx.x; k < n; k += (size_t)gridDim.x * NT) a[k] = 0;
}

template <typename T, bool W4, int HD>
__device__ void run_layers(const Params& p, unsigned char* smem) {
  cg::grid_group grid = cg::this_grid();
  int stamp = 1;
  if (p.stamps && blockIdx.x == 0 && threadIdx.x == 0) p.stamps[0] = globaltimer();
  AttnSmem<HD>* as = reinterpret_cast<AttnSmem<HD>*>(smem);
  GemmSmem* gs = reinterpret_cast<GemmSmem*>(smem);
  const int H = p.H, I = p.I, b = p.b, bid = blockIdx.x;
  const int Dq = H + 2 * p.kvh * head_dim<HD>(p);
  const size_t kdiv = W4 ? 2 : 1;
  // layer l's weight tiles of a product of N columns and depth K (the
  // padded build's copy zero-pads K to whole chunks), computed where used;
  // there K is re-read (fresh): held across the products it spilled
  auto layer_w = [&](const uint8_t* w, int l, int N, int K) {
    return w + (size_t)l * N * ((size_t)k_chunks(PAD ? fresh(K) : K) * TK / kdiv);
  };
  const T* attn = static_cast<const T*>(p.attn);
  const T* actv = static_cast<const T*>(p.act);
  int* amax_a = p.amax;           // attention norm's rows
  int* amax_m = p.amax + b;       // mlp norm's rows
  int* amax_o = p.amax + 2 * b;   // attention output
  int* amax_d = p.amax + 3 * b;   // SiLU output

  // clear the accumulators and counters (published by the first barrier);
  // y = x and its sums of squares
  clear(p.acc_qkv, (size_t)b * Dq);
  clear(p.acc_o, (size_t)b * H);
  clear(p.acc_gu, (size_t)b * 2 * I);
  clear(p.acc_dn, (size_t)b * H);
  clear(p.amax, 4 * b);
  clear(p.kvmax, 2 * b);
  clear(p.tcnt, H / TN);
  for (int t = bid; t < H / TN; t += gridDim.x)
    resid_tile<T>(p, t, static_cast<const T*>(p.x), nullptr, nullptr, nullptr);
  barrier(grid, p, stamp);

  for (int l = 0; l < p.L; ++l) {
    prefetch_w<W4>(gs, layer_w(p.qkv_w, l, Dq, H), Dq, H);
    if (bid == 0 && threadIdx.x < b) amax_d[threadIdx.x] = 0;
    norm_stage<T>(p, p.anorm + (size_t)l * H, amax_a);
    barrier(grid, p, stamp);
    gemm_stage<T, float, W4, false>(p, gs, layer_w(p.qkv_w, l, Dq, H), Dq, H, p.xn, amax_a,
                                    p.acc_qkv, nullptr);
    barrier(grid, p, stamp);
    scores_stage<T, HD>(p, as, l);
    barrier(grid, p, stamp);
    softmax_v_stage<T, HD>(p, as, l);
    barrier(grid, p, stamp);
    finish_stage<T, HD>(p, as, l);
    __syncthreads();
    prefetch_w<W4>(gs, layer_w(p.o_w, l, H, H), H, H);
    barrier(grid, p, stamp);
    clear(p.acc_qkv, (size_t)b * Dq);   // the attention stages are done with it
    if (bid == 0 && threadIdx.x < b) {   // the attention stages are done with these
      amax_a[threadIdx.x] = 0;
      p.kvmax[threadIdx.x] = 0;
      p.kvmax[b + threadIdx.x] = 0;
    }
    gemm_stage<T, T, W4, true>(p, gs, layer_w(p.o_w, l, H, H), H, H, attn, amax_o, p.acc_o,
                               p.o_s + (size_t)l * H);
    barrier(grid, p, stamp);
    prefetch_w<W4>(gs, layer_w(p.gu_w, l, 2 * I, H), 2 * I, H);
    if (bid == 0 && threadIdx.x < b) amax_o[threadIdx.x] = 0;
    norm_stage<T>(p, p.mnorm + (size_t)l * H, amax_m);
    barrier(grid, p, stamp);
    gemm_stage<T, float, W4, false>(p, gs, layer_w(p.gu_w, l, 2 * I, H), 2 * I, H, p.xn, amax_m,
                                    p.acc_gu, nullptr);
    barrier(grid, p, stamp);
    silu_stage<T>(p, l);
    prefetch_w<W4>(gs, layer_w(p.dn_w, l, H, I), H, I);
    barrier(grid, p, stamp);
    if (bid == 0 && threadIdx.x < b) amax_m[threadIdx.x] = 0;
    gemm_stage<T, T, W4, true>(p, gs, layer_w(p.dn_w, l, H, I), H, I, actv, amax_d, p.acc_dn,
                               p.dn_s + (size_t)l * H);
    barrier(grid, p, stamp);
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(NT, 1) decode_kernel(const __grid_constant__ Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  if (p.w4)
    run_layers<T, true, HD>(p, smem);
  else
    run_layers<T, false, HD>(p, smem);
}

__global__ void __launch_bounds__(NT) barrier_kernel(int n) {
  cg::grid_group grid = cg::this_grid();
  for (int k = 0; k < n; ++k) grid.sync();
}

// The attention stages and the GEMM stages share the dynamic shared memory:
// a product's first tiles are issued only once the block is done with the
// stage before it. At head dim 128 the attention stages' (213 KB, sized for
// 8 query heads a kv head) are the larger, within the 227 KB a block may
// take; in the wide build (16 heads, one RoPE buffer: 188 KB at 128, 147 KB
// at 64) and at head dim 256 (170 KB) GemmSmem's 200 KB is.
template <int HD>
constexpr int smem_bytes() {
  return (int)(sizeof(AttnSmem<HD>) > sizeof(GemmSmem) ? sizeof(AttnSmem<HD>) : sizeof(GemmSmem));
}

// the kernel for dtype_code at this source's head dim (hd must be it; the
// padded build: hd % 4 == 0, 32 < hd <= HD); at head dim 256 a narrow build
// only (AttnSmem<256> is sized for 8 query heads a kv head)
int kernel_of(int dtype_code, int hd, const void** kern, int* smem) {
  constexpr int HD = MEGAKERNEL_HD;
  if (PAD ? hd % 4 || hd <= 32 || hd > HD : hd != HD) return (int)cudaErrorInvalidValue;
  *kern = dtype_code == 1 ? reinterpret_cast<const void*>(&decode_kernel<__nv_bfloat16, HD>)
                          : reinterpret_cast<const void*>(&decode_kernel<float, HD>);
  *smem = smem_bytes<HD>();
  return 0;
}

// blocks of a cooperative launch of `kern`: one per SM, all resident
int grid_blocks(const void* kern, size_t smem, int* grid) {
  int dev = 0, sms = 0, occ = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e == cudaSuccess) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kern, NT, smem);
  if (e != cudaSuccess) return (int)e;
  if (occ < 1) return (int)cudaErrorLaunchOutOfResources;
  *grid = sms;
  return 0;
}

}  // namespace

// One decode step. dtype_code: 0 = f32, 1 = bf16; p.hd as kernel_of, p.G
// query heads a kv head, GMIN to GMAX.
extern "C" int megakernel_decode(const Params* hp, int dtype_code, void* stream) {
  Params p = *hp;
  const void* kern = nullptr;
  if (p.G < GMIN || p.G > GMAX || p.CH > CHMAX || p.CH < 16 || p.CH % 16 || p.S % p.CH ||
      p.S / p.CH > NCMAX)
    return (int)cudaErrorInvalidValue;
  int err = kernel_of(dtype_code, p.hd, &kern, &p.smem);
  int grid = 0;
  if (!err) err = grid_blocks(kern, (size_t)p.smem, &grid);
  if (err) return err;
  void* args[] = {&p};
  cudaError_t e = cudaLaunchCooperativeKernel(kern, dim3(grid), dim3(NT), args, (size_t)p.smem,
                                              static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// What the compiler gave a variant: {registers a thread, static shared
// bytes, dynamic shared bytes, local (spill) bytes a thread, threads a
// block, blocks an SM can hold}. Launches nothing.
extern "C" int megakernel_attributes(int* out, int dtype_code, int hd) {
  const void* kern = nullptr;
  int smem = 0;
  int err = kernel_of(dtype_code, hd, &kern, &smem);
  if (err) return err;
  if (int e = (int)cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem))
    return e;
  cudaFuncAttributes a;
  if (int e = (int)cudaFuncGetAttributes(&a, kern)) return e;
  int per_sm = 0;
  if (int e = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, NT, smem)) return e;
  out[0] = a.numRegs;
  out[1] = (int)a.sharedSizeBytes;
  out[2] = smem;
  out[3] = (int)a.localSizeBytes;
  out[4] = NT;
  out[5] = per_sm;
  return 0;
}

// The same grid through n grid-wide barriers and nothing else.
extern "C" int megakernel_barriers(int n, void* stream) {
  const void* kern = reinterpret_cast<const void*>(&barrier_kernel);
  int grid = 0;
  int err = grid_blocks(kern, 0, &grid);
  if (err) return err;
  void* args[] = {&n};
  cudaError_t e = cudaLaunchCooperativeKernel(kern, dim3(grid), dim3(NT), args, 0,
                                              static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
