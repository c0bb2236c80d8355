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
// weights and the live cache once (about 1 GB at TinyLlama-1.1B W8, 0.3 ms at
// 3.35 TB/s) and does a few operations per byte. The TPU kernel is a
// sequential grid over layers on one core that hides memory latency with
// double-buffered copies; here the work of each stage is spread over all
// SMs and the stages are separated by grid-wide barriers:
//
//   norm stage  one block per slot: residual add (the previous product's
//               fixup), RMSNorm, per-token quant -> xq [b, H] int8, sx [b]
//   GEMM stage  work items (64 output columns x 256 K values), dealt round
//               robin to the blocks; the weight tile is read in place from
//               the stacked [L, K, N] tensor, transposed in registers
//               (__byte_perm) into a swizzled shared tile, multiplied with
//               mma.sync m16n8k32 (s8 x s8 -> s32), and the partial sums
//               are added to a global int32 accumulator with atomics.
//               Integer addition is exact in any order, so the split over K
//               costs no determinism; the fixup acc / ((sx+eps)(sw+eps)) is
//               applied by whichever stage reads the accumulator next, which
//               also clears it. Weight tiles arrive through a ring of three
//               cp.async copies per block, the first ones started before
//               the barrier that precedes the stage.
//   attention   one block per (slot, kv head, 2 of its 8 query heads): walks
//               that head's BK-column blocks in order (the running maximum
//               and the roundings of cos*ks, sin*ks and p*vs to the compute
//               type depend on the block edges, so S is not split across
//               blocks), K and V blocks copied to shared memory 16 bytes a
//               thread. It leaves the row's absmax (atomicMax on the float's
//               bits) so that the o product quantizes its activations as it
//               loads them; the SiLU stage (all blocks, 256 columns of a slot
//               each) does the same for the down product.
//
// Eight barriers a layer. Every floating-point sum whose result is rounded
// afterwards (sum of squares, q.k, the softmax denominator, p.V) is
// accumulated in float64 and rounded once, as the plain PyTorch version
// does: such a sum does not depend on the order of its terms, so the two
// agree bit for bit. Where PyTorch rounds a product and then a sum (two
// operations), the kernel uses __fmul_rn / __fadd_rn, which the compiler
// never contracts into one fused multiply-add.
//
// Scratch written by one block and read by another is read with __ldcg (L2
// only); weights, scales, tables and the cache are read-only (__ldg).
// Built for 8 query heads per kv head at head dim 64; the wrapper refuses
// other shapes. Not yet done: TMA, fewer barriers
// (spreading the norm stages over all blocks), splitting a slot's KV blocks
// over thread blocks (scores first, then p against the prefix maximum).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "gemm_int8.cuh"

namespace cg = cooperative_groups;
using gemm_int8::mma_s8;
using gemm_int8::sext_nibbles;
using gemm_int8::transpose4x4;

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
  const uint8_t* qkv_w;     // [L, H(/2), Dq] int8 or split-half packed int4
  const uint8_t* o_w;       // [L, H(/2), H]
  const uint8_t* gu_w;      // [L, H(/2), 2I]
  const uint8_t* dn_w;      // [L, I(/2), H]
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
  int8_t* xq;               // scratch: [b, K] quantized activations
  float* sx;                // [b] their scales
  void* attn;               // [b, H] T attention output
  void* act;                // [b, I] T SiLU(gate) * up
  int* acc_qkv;             // [b, Dq] int32 accumulators
  int* acc_o;               // [b, H]
  int* acc_gu;              // [b, 2I]
  int* acc_dn;              // [b, H]
  int* amax_o;              // [b] absmax of attn rows (float bits, atomicMax)
  int* amax_dn;             // [b] absmax of act rows
  unsigned long long* stamps;   // null, or [1 + 8L] globaltimer ns: at the start
                                // and after every grid barrier (block 0)
  int L, b, H, I, kvh, S, BK, w4, packed, rope, norm_round, smem, gemm_off;
  float eps, a_qmax, kv_qmax, scale;
};

namespace {

constexpr int NT = 256;               // threads per block
constexpr int NW = NT / 32;
constexpr int TN = 64;                // GEMM tile: output columns
constexpr int TK = 256;               // GEMM tile: K values
constexpr int SROW = TK / 4 + 4;      // 32-bit words per shared tile row
constexpr float QEPS = 1e-6f;
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
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

// Block-wide reductions; every thread gets the result. red: NW entries.
__device__ double block_sum(double v, double* red) {
  v = warp_sum(v);
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = v;
  __syncthreads();
  double t = 0.0;
#pragma unroll
  for (int w = 0; w < NW; ++w) t += red[w];
  __syncthreads();
  return t;
}
__device__ float block_max(float v, float* red) {
  v = warp_max(v);
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = v;
  __syncthreads();
  float t = red[0];
#pragma unroll
  for (int w = 1; w < NW; ++w) t = fmaxf(t, red[w]);
  __syncthreads();
  return t;
}

// ---------------------------------------------------------------------------
// row stages (one block per slot)
// ---------------------------------------------------------------------------

struct RowSmem {
  double redd[NW];
  float redf[NW];
  float row[1];   // H floats follow
};

__device__ __forceinline__ float act_scale(const Params& p, const int* amax) {
  return p.a_qmax / (__int_as_float(__ldcg(amax)) + QEPS);
}

// One block per slot. h[i] (+= fixup of acc, which it clears) -> y; then,
// with a gain, RMSNorm and per-token quant of the normed row -> xq, sx.
// amax: the absmax (float bits) behind acc's activation scale; cleared.
template <typename T>
__device__ void row_resid_norm(const Params& p, RowSmem* s, int i, const T* src, int* acc,
                               int* amax, const float* sw, const float* gain) {
  const int H = p.H;
  T* h = static_cast<T*>(p.y) + (size_t)i * H;
  const float sxp = acc ? act_scale(p, amax + i) : 0.f;
  double ss = 0.0;
  for (int c = threadIdx.x; c < H; c += NT) {
    float hv = to_f(src[(size_t)i * H + c]);
    if (acc) {
      int* a = acc + (size_t)i * H + c;
      hv = rt<T>(__fadd_rn(hv, rt<T>(fixup(__ldcg(a), sxp, __ldg(sw + c)))));
      *a = 0;
    }
    put(h + c, hv);
    s->row[c] = hv;
    ss += (double)hv * (double)hv;
  }
  if (!gain) return;
  ss = block_sum(ss, s->redd);     // (every thread has read amax[i] by now)
  if (acc && threadIdx.x == 0) amax[i] = 0;
  const float var = (float)(ss * (1.0 / (double)H));
  const float r = rsqrtf(var + p.eps);
  float am = 0.f;
  for (int c = threadIdx.x; c < H; c += NT) {
    float xn = __fmul_rn(rt<T>(__fmul_rn(s->row[c], r)), __ldg(gain + c));
    if (p.norm_round) xn = rt<T>(xn);
    s->row[c] = xn;
    am = fmaxf(am, fabsf(xn));
  }
  am = block_max(am, s->redf);
  const float sx = p.a_qmax / (am + QEPS);
  for (int c = threadIdx.x; c < H; c += NT)
    p.xq[(size_t)i * H + c] = (int8_t)__float2int_rn(s->row[c] * sx);
  if (threadIdx.x == 0) p.sx[i] = sx;
}

// SiLU(gate) * up in fp32, cast to T -> act [b, I] and its row absmax, over
// all blocks: one item is 256 columns of one slot. Clears the accumulator.
template <typename T>
__device__ void silu_stage(const Params& p, float* redf, int l) {
  const int I = p.I, chunks = I / NT;
  const float* sw = p.gu_s + (size_t)l * 2 * I;
  for (int item = blockIdx.x; item < p.b * chunks; item += gridDim.x) {
    const int i = item / chunks, c = (item % chunks) * NT + threadIdx.x;
    const float sxp = __ldcg(p.sx + i);
    int* acc = p.acc_gu + (size_t)i * 2 * I;
    const float g = rt<T>(fixup(__ldcg(acc + c), sxp, __ldg(sw + c)));
    const float u = rt<T>(fixup(__ldcg(acc + I + c), sxp, __ldg(sw + I + c)));
    acc[c] = 0;
    acc[I + c] = 0;
    const float sig = 1.0f / __fadd_rn(1.0f, expf(-g));
    const float a = rt<T>(__fmul_rn(__fmul_rn(g, sig), u));
    put(static_cast<T*>(p.act) + (size_t)i * I + c, a);
    const float am = block_max(fabsf(a), redf);
    if (threadIdx.x == 0) atomicMax(p.amax_dn + i, __float_as_int(am));
  }
}

// ---------------------------------------------------------------------------
// GEMM stage
// ---------------------------------------------------------------------------

constexpr int NSTAGE = 3;              // weight tiles in flight per block
constexpr int RAW_WORDS = TK * TN / 4;  // one tile as it lies in device memory

struct GemmSmem {
  uint32_t sa[32][SROW];   // x tile: rows = slots (zero above b), K contiguous
  uint32_t sb[TN][SROW];   // weight tile transposed: rows = columns, words swizzled
  uint32_t raw[NSTAGE][RAW_WORDS];   // ring of tiles arriving by cp.async
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N));
}

// word swizzle of the transposed weight tile: conflict-free transposing
// stores (16 columns x 2 word indices a warp) and fragment loads
__device__ __forceinline__ int swz(int col) { return ((col >> 3) & 7) << 1; }

// Registers that hold the next work item's x tile while the current item
// multiplies: 16-value chunks, int8 from xq, or values of type T that are
// quantized on the way in.
template <typename T, bool W4, bool QUANT>
struct TileRegs {
  uint4 x[2][QUANT ? sizeof(T) : 1];
};

// Where the activations of a product come from: xq / sx (quantized by a row
// stage), or src [b, K] of type T with the rows' absmax (quantized here).
struct ActSource {
  const void* src;
  const int* amax;
};

__device__ __forceinline__ uint32_t pack4(float a, float b, float c, float d, float sx) {
  return (uint32_t)(__float2int_rn(a * sx) & 0xff) | ((uint32_t)(__float2int_rn(b * sx) & 0xff) << 8) |
         ((uint32_t)(__float2int_rn(c * sx) & 0xff) << 16) | ((uint32_t)__float2int_rn(d * sx) << 24);
}

__device__ __forceinline__ float bf_lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf_hi(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }

// item -> (column tile, K chunk); neighbouring items read neighbouring columns.
// Starts the copy of the item's weight tile (TK or, packed, TK/2 rows of TN
// bytes, read in place from the stacked tensor) into ring slot `slot`.
template <bool W4>
__device__ __forceinline__ void issue_w(const uint8_t* w, int N, int item, int n_tiles,
                                        GemmSmem* s, int slot) {
  const int nt = item % n_tiles, kc = item / n_tiles;
  constexpr int ROWS = W4 ? TK / 2 : TK, PER_ROW = TN / 16;
  const uint8_t* base = w + (size_t)kc * ROWS * N + nt * TN;
#pragma unroll
  for (int q = 0; q < ROWS * PER_ROW / NT; ++q) {
    const int idx = threadIdx.x + q * NT, row = idx / PER_ROW, ch = idx % PER_ROW;
    cp_async16(&s->raw[slot][idx * 4], base + (size_t)row * N + ch * 16);
  }
}

// the item's x tile: mt * 16 rows x 16 chunks of 16 K values
template <typename T, bool W4, bool QUANT>
__device__ __forceinline__ void load_x(const Params& p, int K, int item, int n_tiles,
                                       const ActSource& a, int mt, TileRegs<T, W4, QUANT>& R) {
  const int kc = item / n_tiles;
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const int idx = threadIdx.x + q * NT, row = idx / 16, ch = idx % 16;
    if (q < mt && row < p.b) {
      int col;
      if constexpr (W4)
        col = (ch < 8 ? 0 : K / 2) + kc * (TK / 2) + (ch % 8) * 16;
      else
        col = kc * TK + ch * 16;
      if constexpr (QUANT) {
        const uint4* src = reinterpret_cast<const uint4*>(static_cast<const T*>(a.src) +
                                                          (size_t)row * K + col);
#pragma unroll
        for (int k = 0; k < (int)sizeof(T); ++k) R.x[q][k] = __ldcg(src + k);
      } else {
        R.x[q][0] = __ldcg(reinterpret_cast<const uint4*>(p.xq + (size_t)row * K + col));
      }
    }
  }
}

// Ring slot `slot` (4 x 4 byte blocks transposed in registers) -> sb, and
// the x tile in R -> sa.
template <typename T, bool W4, bool QUANT>
__device__ __forceinline__ void store_item(const Params& p, const TileRegs<T, W4, QUANT>& R,
                                           const ActSource& a, int mt, GemmSmem* s, int slot) {
#pragma unroll
  for (int q = 0; q < (W4 ? 2 : 4); ++q) {
    const int idx = threadIdx.x + q * NT, kg = idx / 16, ng = idx % 16;
    uint32_t r[4], c[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) r[j] = s->raw[slot][(kg * 4 + j) * (TN / 4) + ng];
    if constexpr (W4) {
      uint32_t lo[4], hi[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        lo[j] = sext_nibbles(r[j]);
        hi[j] = sext_nibbles(r[j] >> 4);
      }
      transpose4x4(lo, c);
#pragma unroll
      for (int i = 0; i < 4; ++i) s->sb[ng * 4 + i][kg ^ swz(ng * 4 + i)] = c[i];
      transpose4x4(hi, c);
#pragma unroll
      for (int i = 0; i < 4; ++i) s->sb[ng * 4 + i][(TK / 8 + kg) ^ swz(ng * 4 + i)] = c[i];
    } else {
      transpose4x4(r, c);
#pragma unroll
      for (int i = 0; i < 4; ++i) s->sb[ng * 4 + i][kg ^ swz(ng * 4 + i)] = c[i];
    }
  }
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const int idx = threadIdx.x + q * NT, row = idx / 16, ch = idx % 16;
    if (q < mt) {
      uint4 v = make_uint4(0, 0, 0, 0);
      if (row < p.b) {
        if constexpr (QUANT) {
          const float sx = act_scale(p, a.amax + row);
          if constexpr (sizeof(T) == 2) {
            const uint4 u0 = R.x[q][0], u1 = R.x[q][1];
            v.x = pack4(bf_lo(u0.x), bf_hi(u0.x), bf_lo(u0.y), bf_hi(u0.y), sx);
            v.y = pack4(bf_lo(u0.z), bf_hi(u0.z), bf_lo(u0.w), bf_hi(u0.w), sx);
            v.z = pack4(bf_lo(u1.x), bf_hi(u1.x), bf_lo(u1.y), bf_hi(u1.y), sx);
            v.w = pack4(bf_lo(u1.z), bf_hi(u1.z), bf_lo(u1.w), bf_hi(u1.w), sx);
          } else {
            const uint4* u = R.x[q];
            v.x = pack4(__uint_as_float(u[0].x), __uint_as_float(u[0].y),
                        __uint_as_float(u[0].z), __uint_as_float(u[0].w), sx);
            v.y = pack4(__uint_as_float(u[1].x), __uint_as_float(u[1].y),
                        __uint_as_float(u[1].z), __uint_as_float(u[1].w), sx);
            v.z = pack4(__uint_as_float(u[2].x), __uint_as_float(u[2].y),
                        __uint_as_float(u[2].z), __uint_as_float(u[2].w), sx);
            v.w = pack4(__uint_as_float(u[3].x), __uint_as_float(u[3].y),
                        __uint_as_float(u[3].z), __uint_as_float(u[3].w), sx);
          }
        } else {
          v = R.x[q][0];
        }
      }
      *reinterpret_cast<uint4*>(&s->sa[row][ch * 4]) = v;
    }
  }
}

// Start the copies of the block's first NSTAGE - 1 weight tiles of a stage.
// Weights are read-only, so this may run before the barrier that precedes
// the stage. Always commits NSTAGE - 1 groups (empty ones where the block
// has fewer items), which gemm_stage's waits count on.
template <bool W4>
__device__ __forceinline__ void prefetch_w(GemmSmem* s, const uint8_t* w, int N, int K) {
  const int n_tiles = N / TN, items = n_tiles * (K / TK);
#pragma unroll
  for (int k = 0; k < NSTAGE - 1; ++k) {
    const int item = blockIdx.x + k * gridDim.x;
    if (item < items) issue_w<W4>(w, N, item, n_tiles, s, k);
    cp_async_commit();
  }
}

// activations [b, K] (x) w [K(/2), N] -> += acc [b, N], after prefetch_w.
template <typename T, bool W4, bool QUANT>
__device__ void gemm_stage(const Params& p, GemmSmem* s, const uint8_t* w, int N, int K,
                           const ActSource& a, int* acc) {
  const int n_tiles = N / TN, items = n_tiles * (K / TK);
  const int grid = gridDim.x, b = p.b, mt = b > 16 ? 2 : 1;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32, g = lane / 4, t = lane % 4;
  TileRegs<T, W4, QUANT> R;
  if ((int)blockIdx.x < items) load_x<T, W4, QUANT>(p, K, blockIdx.x, n_tiles, a, mt, R);
  int k = 0;
  for (int item = blockIdx.x; item < items; item += grid, ++k) {
    const int nt = item % n_tiles;
    cp_async_wait<NSTAGE - 2>();     // this thread's part of tile k has landed
    __syncthreads();                 // all of it; and everyone is done with item k - 1
    const int ahead = item + (NSTAGE - 1) * grid;
    if (ahead < items) issue_w<W4>(w, N, ahead, n_tiles, s, (k + NSTAGE - 1) % NSTAGE);
    cp_async_commit();
    store_item<T, W4, QUANT>(p, R, a, mt, s, k % NSTAGE);
    if (item + grid < items) load_x<T, W4, QUANT>(p, K, item + grid, n_tiles, a, mt, R);
    __syncthreads();
    int c[2][4] = {};
    const int n = warp * 8 + g, sw_n = swz(n);
#pragma unroll
    for (int ks = 0; ks < TK / 32; ++ks) {
      uint32_t bf[2] = {s->sb[n][(ks * 8 + t) ^ sw_n], s->sb[n][(ks * 8 + t + 4) ^ sw_n]};
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
        if (mi < mt) {
          const int r = mi * 16 + g;
          uint32_t af[4] = {s->sa[r][ks * 8 + t], s->sa[r + 8][ks * 8 + t],
                            s->sa[r][ks * 8 + t + 4], s->sa[r + 8][ks * 8 + t + 4]};
          mma_s8(c[mi], af, bf);
        }
    }
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = mi * 16 + g + (e >= 2 ? 8 : 0);
        const int col = nt * TN + warp * 8 + t * 2 + (e & 1);
        if (row < b) atomicAdd(acc + (size_t)row * N + col, c[mi][e]);
      }
  }
  cp_async_wait<0>();
  __syncthreads();                   // the stage's shared memory is free again
}

// ---------------------------------------------------------------------------
// attention stage (one block per slot, kv head and GS query heads)
// ---------------------------------------------------------------------------

template <typename T, int G, int GS, int HD>
__device__ void attention_item(const Params& p, unsigned char* smem, int l, int i, int hh,
                               int gq) {
  constexpr int H2 = HD / 2, NO = GS * HD;     // outputs of the item
  static_assert(NT == 2 * NO, "two threads an output: each takes half of the columns");
  const int BK = p.BK, S = p.S, kvh = p.kvh, b = p.b;
  const int hdc = p.packed ? H2 : HD;
  const int kv_dim = kvh * HD, q_dim = kvh * G * HD, Dq = q_dim + 2 * kv_dim;
  const int tid = threadIdx.x;
  const int head0 = hh * G + gq * GS;          // first query head of the item

  // shared memory carve-up
  double* sq = reinterpret_cast<double*>(smem);            // [GS][HD] rotated query
  double* sp = sq + GS * HD;                               // [BK][GS] scores (as floats), then p*vs
  uint8_t* sk = reinterpret_cast<uint8_t*>(sp + (size_t)BK * GS);  // [hdc][BK]
  uint8_t* sv = sk + (size_t)hdc * BK;                     // [hdc][VS]
  const int VS = BK + 4;   // V row stride: an odd count of words, so the p.V loop's
                           // lanes (one head-dim row each) fall on distinct banks
  double* redd = reinterpret_cast<double*>(sv + (((size_t)hdc * VS + 15) & ~(size_t)15));
                                                           // [max(NW * GS, NO)]
  float* redf = reinterpret_cast<float*>(redd + NO);       // [NW][GS]
  float* skf = redf + NW * GS;                             // [HD] new K (values, then folded)
  float* svf = skf + HD;                                   // [HD] new V
  float* sm = svf + HD;                                    // [GS] running max
  float* sl = sm + GS;                                     // [GS] running denominator
  float* sal = sl + GS;                                    // [GS] alpha of the block
  float* scur = sal + GS;                                  // [GS] current token's score

  const int len = __ldg(p.lens + i);
  const bool act = __ldg(p.active + i) != 0;
  const float sxi = __ldcg(p.sx + i);
  const int* acc = p.acc_qkv + (size_t)i * Dq;
  const float* sw = p.qkv_s + (size_t)l * Dq;
  const float* qc = p.qcos + (size_t)i * H2;
  const float* qs = p.qsin + (size_t)i * H2;

  // query RoPE in T, rounded to the compute type
  for (int idx = tid; idx < GS * H2; idx += NT) {
    const int g = idx / H2, j = idx % H2, c1 = (head0 + g) * HD + j, c2 = c1 + H2;
    const float q1 = rt<T>(fixup(__ldcg(acc + c1), sxi, __ldg(sw + c1)));
    const float q2 = rt<T>(fixup(__ldcg(acc + c2), sxi, __ldg(sw + c2)));
    const float co = rt<T>(__ldg(qc + j)), si = rt<T>(__ldg(qs + j));
    float r1, r2;
    rope_pair<T>(q1, q2, co, si, r1, r2);
    sq[g * HD + j] = (double)r1;
    sq[g * HD + j + H2] = (double)r2;
  }
  // the current token's K and V: absmax over all kv heads of the slot
  float kam = 0.f, vam = 0.f;
  for (int idx = tid; idx < kvh * H2; idx += NT) {
    const int h2i = idx / H2, j = idx % H2, c1 = q_dim + h2i * HD + j, c2 = c1 + H2;
    float k1 = rt<T>(fixup(__ldcg(acc + c1), sxi, __ldg(sw + c1)));
    float k2 = rt<T>(fixup(__ldcg(acc + c2), sxi, __ldg(sw + c2)));
    if (!p.rope) {   // "post": the cache holds rotated K
      const float co = rt<T>(__ldg(qc + j)), si = rt<T>(__ldg(qs + j));
      float r1, r2;
      rope_pair<T>(k1, k2, co, si, r1, r2);
      k1 = r1;
      k2 = r2;
    }
    const float v1 = rt<T>(fixup(__ldcg(acc + kv_dim + c1), sxi, __ldg(sw + kv_dim + c1)));
    const float v2 = rt<T>(fixup(__ldcg(acc + kv_dim + c2), sxi, __ldg(sw + kv_dim + c2)));
    kam = fmaxf(kam, fmaxf(fabsf(k1), fabsf(k2)));
    vam = fmaxf(vam, fmaxf(fabsf(v1), fabsf(v2)));
    if (h2i == hh) {
      skf[j] = k1; skf[j + H2] = k2;
      svf[j] = v1; svf[j + H2] = v2;
    }
  }
  kam = block_max(kam, redf);
  vam = block_max(vam, redf);
  const float ks_s = p.kv_qmax / (kam + QEPS), vs_s = p.kv_qmax / (vam + QEPS);
  const float k_inv = 1.0f / (ks_s + QEPS), v_inv = 1.0f / (vs_s + QEPS);
  for (int d = tid; d < HD; d += NT) {
    const int ki = __float2int_rn(skf[d] * ks_s), vi = __float2int_rn(svf[d] * vs_s);
    if (gq == 0) {
      const size_t o = ((size_t)l * b + i) * kv_dim + hh * HD + d;
      p.kint[o] = (int8_t)ki;
      p.vint[o] = (int8_t)vi;
    }
    skf[d] = (float)ki;
    svf[d] = (float)vi;
  }
  if (tid == 0 && hh == 0 && gq == 0) {
    p.kinv[(size_t)l * b + i] = k_inv;
    p.vinv[(size_t)l * b + i] = v_inv;
  }
  if (tid < GS) { sm[tid] = NEG_INF; sl[tid] = 0.f; }
  __syncthreads();

  // p.V: thread (o, half) owns output o = (g, d) for half of the columns
  const int o = tid % NO, half = tid / NO, og = o / HD, od = o % HD;
  float out_acc = 0.f;     // kept by the half-0 thread of each output

  const size_t kv_base = (((size_t)l * b + i) * kvh + hh) * hdc * S;
  const float* ksp = p.ks + ((size_t)l * b + i) * S;
  const float* vsp = p.vs + ((size_t)l * b + i) * S;

  for (int start = 0; start < len; start += BK) {
    const int ncol = min(BK, len - start);
    // this block's K and V bytes -> shared memory, 16 bytes a thread
    // (4 chunks of K and of V in flight per thread before any is stored)
    const int per_row = BK / 16;
    for (int idx0 = tid; idx0 < hdc * per_row; idx0 += 4 * NT) {
      uint4 kr[4], vr[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int idx = idx0 + u * NT, row = idx / per_row, ch = idx % per_row;
        if (idx < hdc * per_row && ch * 16 < ncol) {
          const size_t go = kv_base + (size_t)row * S + start + ch * 16;
          kr[u] = __ldg(reinterpret_cast<const uint4*>(p.kq + go));
          vr[u] = __ldg(reinterpret_cast<const uint4*>(p.vq + go));
        }
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int idx = idx0 + u * NT, row = idx / per_row, ch = idx % per_row;
        if (idx < hdc * per_row && ch * 16 < ncol) {
          *reinterpret_cast<uint4*>(sk + (size_t)row * BK + ch * 16) = kr[u];
          uint32_t* vd = reinterpret_cast<uint32_t*>(sv + (size_t)row * VS + ch * 16);
          vd[0] = vr[u].x; vd[1] = vr[u].y; vd[2] = vr[u].z; vd[3] = vr[u].w;
        }
      }
    }
    __syncthreads();
    // scores: one column a thread, GS query heads, float64 sums
    float mloc[GS];
#pragma unroll
    for (int g = 0; g < GS; ++g) mloc[g] = NEG_INF;
    for (int cl = tid; cl < ncol; cl += NT) {
      const int col = start + cl;
      const float ksc = __ldg(ksp + col);
      const float sl_t = rt<T>(ksc);
      double s[GS];
#pragma unroll
      for (int g = 0; g < GS; ++g) s[g] = 0.0;
      constexpr int JB = 16;   // rows of the RoPE tables loaded together
      static_assert(H2 % JB == 0, "table batches");
      for (int jb = 0; jb < H2; jb += JB) {
        float tc[JB], ts[JB];
        if (p.rope) {
#pragma unroll
          for (int u = 0; u < JB; ++u) {
            tc[u] = __ldg(p.kcos + (size_t)(jb + u) * S + col);
            ts[u] = __ldg(p.ksin + (size_t)(jb + u) * S + col);
          }
        }
#pragma unroll
        for (int u = 0; u < JB; ++u) {
          const int j = jb + u;
          float k1, k2;
          if (p.packed) {
            const uint8_t kb = sk[(size_t)j * BK + cl];
            k1 = (float)((int8_t)(kb << 4) >> 4);
            k2 = (float)((int8_t)kb >> 4);
          } else {
            k1 = (float)(int8_t)sk[(size_t)j * BK + cl];
            k2 = (float)(int8_t)sk[(size_t)(j + H2) * BK + cl];
          }
          float r1, r2;
          if (p.rope) {
            const float cc = rt<T>(tc[u] * ksc), sn = rt<T>(ts[u] * ksc);
            rope_pair<T>(k1, k2, cc, sn, r1, r2);
          } else {
            r1 = rt<T>(k1 * sl_t);
            r2 = rt<T>(k2 * sl_t);
          }
          const double d1 = (double)r1, d2 = (double)r2;
#pragma unroll
          for (int g = 0; g < GS; ++g)
            s[g] = fma(sq[g * HD + j], d1, fma(sq[g * HD + j + H2], d2, s[g]));
        }
      }
      float* sc = reinterpret_cast<float*>(sp + (size_t)cl * GS);
#pragma unroll
      for (int g = 0; g < GS; ++g) {
        const float v = (float)s[g] * p.scale;
        sc[g] = v;
        mloc[g] = fmaxf(mloc[g], v);
      }
    }
#pragma unroll
    for (int g = 0; g < GS; ++g) {
      const float wm = warp_max(mloc[g]);
      if (tid % 32 == 0) redf[(tid / 32) * GS + g] = wm;
    }
    __syncthreads();
    if (tid < GS) {
      float mb = redf[tid];
      for (int w = 1; w < NW; ++w) mb = fmaxf(mb, redf[w * GS + tid]);
      const float m_new = fmaxf(sm[tid], mb);
      sal[tid] = expf(sm[tid] - m_new);
      sm[tid] = m_new;
    }
    __syncthreads();
    // p against the running maximum; p * vs rounded to the compute type
    double psum[GS];
#pragma unroll
    for (int g = 0; g < GS; ++g) psum[g] = 0.0;
    for (int cl = tid; cl < ncol; cl += NT) {
      const float vsc = __ldg(vsp + start + cl);
      float sc[GS];
      const float* scp = reinterpret_cast<const float*>(sp + (size_t)cl * GS);
#pragma unroll
      for (int g = 0; g < GS; ++g) sc[g] = scp[g];
#pragma unroll
      for (int g = 0; g < GS; ++g) {
        const float pr = expf(sc[g] - sm[g]);
        psum[g] += (double)pr;
        sp[(size_t)cl * GS + g] = (double)rt<T>(pr * vsc);
      }
    }
    // zero the tail of the last group of 8 columns (read by the p.V loop)
    for (int cl = ncol + tid; cl < ((ncol + 7) & ~7); cl += NT)
#pragma unroll
      for (int g = 0; g < GS; ++g) sp[(size_t)cl * GS + g] = 0.0;
#pragma unroll
    for (int g = 0; g < GS; ++g) {
      const double ws = warp_sum(psum[g]);
      if (tid % 32 == 0) redd[(tid / 32) * GS + g] = ws;
    }
    __syncthreads();
    if (tid < GS) {
      double t = 0.0;
      for (int w = 0; w < NW; ++w) t += redd[w * GS + tid];
      sl[tid] = __fadd_rn(__fmul_rn(sl[tid], sal[tid]), (float)t);
    }
    // p.V: groups of 4 columns, even groups to half 0 and odd ones to half 1
    double a = 0.0;
    {
      double a4[4] = {0.0, 0.0, 0.0, 0.0};   // independent chains
      const uint8_t* vrow = sv + (size_t)(p.packed ? od % H2 : od) * VS;
      const int shift = p.packed ? (od < H2 ? 28 : 24) : 24, back = p.packed ? 28 : 24;
      for (int c4 = half * 4; c4 < ncol; c4 += 8) {
        const uint32_t w4 = *reinterpret_cast<const uint32_t*>(vrow + c4);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const uint32_t byte = (w4 >> (8 * e)) & 0xffu;
          a4[e] = fma(sp[(size_t)(c4 + e) * GS + og],
                      int_to_double((int)(byte << shift) >> back), a4[e]);
        }
      }
      a = (a4[0] + a4[1]) + (a4[2] + a4[3]);
    }
    __syncthreads();                 // redd is free again (sl is updated)
    if (half == 1) redd[o] = a;
    __syncthreads();
    if (half == 0) out_acc = __fadd_rn(__fmul_rn(out_acc, sal[og]), (float)(a + redd[o]));
    __syncthreads();
  }

  // fold the current token in as one more online-softmax term
  {
    const float vinv_t = rt<T>(v_inv), kinv_t = rt<T>(k_inv);
    if (tid < H2) {
      const float k1 = skf[tid], k2 = skf[tid + H2];
      float kf1, kf2;
      if (p.rope) {
        const float cc = rt<T>(__ldg(qc + tid) * k_inv), sn = rt<T>(__ldg(qs + tid) * k_inv);
        rope_pair<T>(k1, k2, cc, sn, kf1, kf2);
      } else {
        kf1 = rt<T>(k1 * kinv_t);
        kf2 = rt<T>(k2 * kinv_t);
      }
      skf[tid] = kf1;
      skf[tid + H2] = kf2;
      svf[tid] = rt<T>(svf[tid] * vinv_t);
      svf[tid + H2] = rt<T>(svf[tid + H2] * vinv_t);
    }
    __syncthreads();
    if (tid < GS) {
      double sc = 0.0;
      for (int d = 0; d < HD; ++d) sc = fma(sq[tid * HD + d], (double)skf[d], sc);
      scur[tid] = (float)sc * p.scale;
    }
    __syncthreads();
    float res = 0.f;
    if (half == 0) {
      const float sc = act ? scur[og] : NEG_INF;
      const float m_new = fmaxf(sm[og], sc);
      const float al = expf(sm[og] - m_new);
      const float pr = act ? expf(sc - m_new) : 0.f;
      const float ll = fmaxf(__fadd_rn(__fmul_rn(sl[og], al), pr), 1e-9f);
      const float num = __fadd_rn(__fmul_rn(out_acc, al), __fmul_rn(pr, svf[od]));
      res = rt<T>(num / ll);
      put(static_cast<T*>(p.attn) + (size_t)i * q_dim + (head0 + og) * HD + od, res);
    }
    // the row's absmax, for the o product's activation quant
    const float am = block_max(fabsf(res), redf);
    if (tid == 0) atomicMax(p.amax_o + i, __float_as_int(am));
  }
  __syncthreads();
}

// ---------------------------------------------------------------------------
// the kernel
// ---------------------------------------------------------------------------

__device__ __forceinline__ unsigned long long globaltimer() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %globaltimer;" : "=l"(t));
  return t;
}

// grid-wide barrier; block 0 notes the time after it when stamps are asked for
__device__ __forceinline__ void barrier(cg::grid_group& grid, const Params& p, int& k) {
  grid.sync();
  if (p.stamps && blockIdx.x == 0 && threadIdx.x == 0) p.stamps[k] = globaltimer();
  ++k;
}

template <typename T, bool W4>
__device__ void run_layers(const Params& p, unsigned char* smem) {
  constexpr int G = 8, GS = 2, HD = 64;
  cg::grid_group grid = cg::this_grid();
  int stamp = 1;
  if (p.stamps && blockIdx.x == 0 && threadIdx.x == 0) p.stamps[0] = globaltimer();
  RowSmem* rs = reinterpret_cast<RowSmem*>(smem);
  // past the norm stage's row buffer, so that the qkv product's first tiles
  // can arrive while that stage runs
  GemmSmem* gs = reinterpret_cast<GemmSmem*>(smem + p.gemm_off);
  const int H = p.H, I = p.I, b = p.b, bid = blockIdx.x;
  const int Dq = H + 2 * p.kvh * HD;
  const size_t kdiv = W4 ? 2 : 1;
  const ActSource from_xq = {nullptr, nullptr};
  const ActSource from_attn = {p.attn, p.amax_o}, from_act = {p.act, p.amax_dn};

  // clear the accumulators and the absmax cells (published by the first barrier)
  for (size_t k = (size_t)bid * NT + threadIdx.x; k < (size_t)b * (Dq + 2 * H + 2 * I);
       k += (size_t)gridDim.x * NT) {
    size_t r = k;
    if (r < (size_t)b * Dq) { p.acc_qkv[r] = 0; continue; }
    r -= (size_t)b * Dq;
    if (r < (size_t)b * H) { p.acc_o[r] = 0; continue; }
    r -= (size_t)b * H;
    if (r < (size_t)b * H) { p.acc_dn[r] = 0; continue; }
    r -= (size_t)b * H;
    p.acc_gu[r] = 0;
  }
  if (bid == 0 && threadIdx.x < b) {
    p.amax_o[threadIdx.x] = 0;
    p.amax_dn[threadIdx.x] = 0;
  }

  for (int l = 0; l < p.L; ++l) {
    const uint8_t* wq = p.qkv_w + (size_t)l * (H / kdiv) * Dq;
    const uint8_t* wo = p.o_w + (size_t)l * (H / kdiv) * H;
    const uint8_t* wg = p.gu_w + (size_t)l * (H / kdiv) * 2 * I;
    const uint8_t* wd = p.dn_w + (size_t)l * (I / kdiv) * H;

    prefetch_w<W4>(gs, wq, Dq, H);
    if (bid < b) {
      if (l == 0)
        row_resid_norm<T>(p, rs, bid, static_cast<const T*>(p.x), nullptr, nullptr, nullptr,
                          p.anorm);
      else
        row_resid_norm<T>(p, rs, bid, static_cast<const T*>(p.y), p.acc_dn, p.amax_dn,
                          p.dn_s + (size_t)(l - 1) * H, p.anorm + (size_t)l * H);
    }
    barrier(grid, p, stamp);
    gemm_stage<T, W4, false>(p, gs, wq, Dq, H, from_xq, p.acc_qkv);
    barrier(grid, p, stamp);
    for (int item = bid; item < b * p.kvh * (G / GS); item += gridDim.x)
      attention_item<T, G, GS, HD>(p, smem, l, item / (p.kvh * (G / GS)),
                                   item / (G / GS) % p.kvh, item % (G / GS));
    prefetch_w<W4>(gs, wo, H, H);
    barrier(grid, p, stamp);
    gemm_stage<T, W4, true>(p, gs, wo, H, H, from_attn, p.acc_o);
    prefetch_w<W4>(gs, wg, 2 * I, H);
    barrier(grid, p, stamp);
    if (bid < b) {
      // the attention stage is done with the slot's qkv accumulator
      for (int c = threadIdx.x; c < Dq; c += NT) p.acc_qkv[(size_t)bid * Dq + c] = 0;
      row_resid_norm<T>(p, rs, bid, static_cast<const T*>(p.y), p.acc_o, p.amax_o,
                        p.o_s + (size_t)l * H, p.mnorm + (size_t)l * H);
    }
    barrier(grid, p, stamp);
    gemm_stage<T, W4, false>(p, gs, wg, 2 * I, H, from_xq, p.acc_gu);
    barrier(grid, p, stamp);
    silu_stage<T>(p, rs->redf, l);
    prefetch_w<W4>(gs, wd, H, I);
    barrier(grid, p, stamp);
    gemm_stage<T, W4, true>(p, gs, wd, H, I, from_act, p.acc_dn);
    barrier(grid, p, stamp);
  }
  if (bid < b)
    row_resid_norm<T>(p, rs, bid, static_cast<const T*>(p.y), p.acc_dn, p.amax_dn,
                      p.dn_s + (size_t)(p.L - 1) * H, nullptr);
}

template <typename T>
__global__ void __launch_bounds__(NT) decode_kernel(const __grid_constant__ Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  if (p.w4)
    run_layers<T, true>(p, smem);
  else
    run_layers<T, false>(p, smem);
}

__global__ void __launch_bounds__(NT) barrier_kernel(int n) {
  cg::grid_group grid = cg::this_grid();
  for (int k = 0; k < n; ++k) grid.sync();
}

// blocks of a cooperative launch of `kern`: one per SM (the kernel's
// registers and shared memory leave room for no second one), all resident
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

// One decode step. dtype_code: 0 = f32, 1 = bf16.
extern "C" int megakernel_decode(const Params* hp, int dtype_code, void* stream) {
  Params p = *hp;
  const void* kern = dtype_code == 1
                         ? reinterpret_cast<const void*>(&decode_kernel<__nv_bfloat16>)
                         : reinterpret_cast<const void*>(&decode_kernel<float>);
  int grid = 0;
  int err = grid_blocks(kern, (size_t)p.smem, &grid);
  if (err) return err;
  void* args[] = {&p};
  cudaError_t e = cudaLaunchCooperativeKernel(kern, dim3(grid), dim3(NT), args, (size_t)p.smem,
                                              static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
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
