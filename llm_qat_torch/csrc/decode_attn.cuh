// One-token attention over a quantized KV cache, split over every SM of a
// Hopper card (sm_90a): the device code and entry points of K3, K7 and K8
// (decode_attention.cu and its siblings build them, one head dim each).
//
// Replaces the body the TPU kernels share,
// llm_qat_tpu/ops/pallas/decode_attention.py:_decode_attn_kernel (K3, and
// K8 through _paged_attn_kernel(_fold)) and :_decode_attn_stacked_kernel
// (K7). For each slot and kv head: dequantize the int8 (or nibble-packed
// int4) cache columns by their per-token inverse scales, rotate K by RoPE at
// its logical position from the hoisted [hd/2, TS] tables ("pre") or not at
// all ("post"), score them against the G query heads, and run the TPU
// kernel's online softmax over its KV blocks of BK columns (K3/K7: the JAX
// picker's bk; K8: one page): m_j = max(m_{j-1}, rowmax(s_j)), p = exp(s -
// m_j), p * vs rounded to the compute type, l and acc rescaled by
// exp(m_{j-1} - m_j). Then the current token's pair is folded in as one
// more term (fold 1: quantized K/V integers, excluded for inactive slots;
// fold 2, K7's contract: fake-quantized K/V in q's type, p rounded to q's
// type and not zeroed for an excluded pair), l is clamped at 1e-9 and the
// sum divided. With a bf16 q, cos*ks, sin*ks, the rotated k and p*vs round
// to bf16 where the TPU kernel rounds them (its dots take bf16 operands).
//
// Bound on this card: the live cache bytes (and their scales and RoPE
// columns). Each byte takes about 2 G multiply-adds, far below the ~295
// operations a byte at which Hopper turns compute-bound. One cooperative
// launch of NT-thread blocks, two an SM where they fit (all resident), in
// three stages separated by grid-wide barriers (the design of the decode
// megakernel's attention, cut to one layer):
//
//   scores     item = (slot, CH cache columns, kv head), only chunks below
//              the slot's length; chunk-major, so the kv heads of a chunk
//              (an item group) run in a row and share its RoPE columns. A
//              block takes a contiguous run, inside one group while there
//              are no more groups than blocks (item_run); the next item's K
//              rows, K scales, query heads and (at head dim 64 and below)
//              RoPE columns arrive by 16-byte cp.async while one is
//              computed, and the item's V rows go to L2 for the next stage.
//              q.k in float64 (NQ threads a column), the scores and each
//              chunk's row maxima -> scratch.
//   softmax.V  the same runs; V rows, scores and V scales two items ahead
//              by cp.async into a ring of three buffers (the first two
//              items' V rows issued before the barrier). m_j is the maximum
//              of the chunk maxima from the slot's first chunk to the end of
//              the chunk's BK block (a chunk never straddles one: CH divides
//              BK); float64 partial sums of p and of p.V (a thread widens
//              each V value once for the G heads) -> scratch.
//   finish     item = (slot, kv head): every load issued first, then the
//              fp32 recurrence l = l a + P_j, acc = acc a + PV_j in block
//              order from the partials, the fold, the division: the
//              sequential walk's values.
//
// Every sum whose result is rounded (q.k, the sums of p, p.V) is taken in
// float64 and rounded once, as the plain PyTorch versions do, and every
// rounding the contract names is written with __fmul_rn / __fsub_rn /
// __fadd_rn, which the compiler never contracts into a fused multiply-add:
// kernel and plain version agree bit for bit but for float64 noise, and a
// launch gives the same bits every time (no atomics). The scratch (the
// wrapper's torch.empty, laid out by carve below) holds per (slot, query
// head, chunk) the chunk's partial sums, scores, maximum and its block's
// rescale factor.
//
// Shapes: any G = 1..GMAX (16) query heads a kv head at head dims hd = 16,
// 32, 64 and 128, and G = 1..GMAX_D256 (4) at head dim 256 (Falcon3's; see
// Smem for why no more), f32 or bf16 q, at most BMAX slots. The q.k and p.V loops
// hold a register tile of GT = 1, 2, 4 or 8 heads (4 at most at hd <= 32,
// where a tile of 8 spills: G > 4 then runs two passes, and G > 8 two
// passes of 8 at hd >= 64, up to four of 4 at hd <= 32); G is rounded up to
// g_tile(G) (1, 2, 4, 8 or 16), the padding heads' query rows and p * vs
// columns are zeros, so their sums are zeros that nothing reads. Each head
// dim has one build a range of G [GL, GH] (build_lo): G = 1, 2, 3..4, 5..7,
// 8, 9..15 and 16, so that G rounds to one tile in each. A build of one G
// has it as a constant; the others read it from the launch. G = 8 has a
// build of its own beside 5..7: with G from the launch it measured 5-7%
// slower at (8, 64) and (8, 128); at hd 32 one build of G = 3..8 spilled;
// G = 16 has one beside 9..15 for the same reason: 4-14% faster at (8, 16,
// 128) and (1, 16, 128) (PERF.md). The shared memory is carved at run time
// by G (Smem below), so a shape takes only what it uses: two blocks an SM at every G
// for hd <= 32, at G <= 8 for hd 64 and at G <= 2 for hd = 128, one block
// an SM past that (see min_blocks). The finish stage is built for 1, 2, 4
// or 8 outputs a thread (ceil(G hd / NT) rounded up). Past 8 heads (NW
// warps) a warp takes two heads (HPW) where the softmax.V and finish stages
// give a warp a head. Nothing of the layout
// depends on hd but the buffers' sizes: the cache rows run along S, so a
// packed row of hd = 16 (8 bytes of head dim) is still S bytes, read in the
// same 16-byte pieces. The finish stage loads each output's partial p.V sums
// NB chunks at a time (8, or 4 where a thread owns 4 outputs), summed in the
// same order either way.

#pragma once

// One source builds one head dim (DECODE_ATTN_HD: decode_attention.cu 64,
// decode_attention_d16.cu, _d32.cu, _d128.cu and _d256.cu the others), so
// they compile side by side; each exports the same entry points (end of file).
// decode_attention_dpad.cu defines DECODE_ATTN_PAD beside HD = 128: its
// kernels take every head dim hd % 4 == 0 with 32 < hd <= 128 (OpenLLaMA-3B's
// 100, and 48, 80, 96) from the launch (Args::hd). HD is then the most the
// shared buffers hold, sized as at head dim 128; the layouts in global memory
// keep the true hd (cache rows, q and out rows of hd values, the scratch's
// hd partial sums), and every count, stride and pair (j, j + hd/2) of RoPE
// and of the nibble packing comes from it (head_dim). A q row of hd bf16
// values that is no multiple of 16 bytes (hd 100: 200 bytes) arrives in
// 8-byte cp.async pieces; the p.V stage's column parts round up to whole
// words (pv_parts).
// decode_attention_d256.cu builds head dim 256 with the same layout and
// code; what changes there is behind `if constexpr (HD >= NT)` (a thread a
// head-dim row of the V chunk) and the range of G (kernel_hd).
#ifndef DECODE_ATTN_HD
#error "define DECODE_ATTN_HD (16, 32, 64, 128 or 256) before including decode_attn.cuh"
#endif

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace decode_attn {

namespace cg = cooperative_groups;

constexpr int NT = 256;              // threads a block
constexpr int NW = NT / 32;
constexpr int CHMAX = 128;           // columns a chunk, at most
constexpr int NQ = NT / CHMAX;       // threads a column in the scores stage
constexpr int VSA = CHMAX + 16;      // V chunk row stride: 16-byte pieces, rows 4 banks apart
constexpr int BMAX = 256;            // slots
constexpr int GMAX = 16;             // query heads a kv head
constexpr int GMID = 8;              // ... of the builds whose warps take a head each
constexpr int GMAX_D256 = 4;         // ... at head dim 256 (Smem)
constexpr int FW = 256;              // chunk statistics the finish stage stages at a time
constexpr int MINB = 2;              // blocks an SM: registers a thread at most 65536 / (2 NT)
                                     // (but see min_blocks)
constexpr float NEG_INF = -1e30f;
#ifdef DECODE_ATTN_PAD
constexpr bool PAD = true;           // hd from the launch, at most DECODE_ATTN_HD
constexpr int HD_MIN = 36;           // the fewest it takes
#else
constexpr bool PAD = false;
constexpr int HD_MIN = DECODE_ATTN_HD;
#endif

// G query heads a kv head rounded up to a register tile of heads, the
// largest tile the q.k and p.V loops take at head dim HD, the tile of a
// build whose most G is GH there, and the fewest G of the build that takes G
__host__ __device__ constexpr int g_tile(int G) {
  return G <= 1 ? 1 : G <= 2 ? 2 : G <= 4 ? 4 : G <= 8 ? 8 : 16;
}
template <int HD>
__host__ __device__ constexpr int tile_max() { return HD <= 32 ? 4 : 8; }
template <int HD>
__host__ __device__ constexpr int build_tile(int GH) {
  return g_tile(GH) < tile_max<HD>() ? g_tile(GH) : tile_max<HD>();
}
__host__ __device__ constexpr int build_lo(int G) {
  return G <= 2 ? G : G <= 4 ? 3 : G < GMID ? 5 : G == GMID ? GMID : G < GMAX ? GMID + 1 : GMAX;
}
// heads a warp takes in the softmax.V and finish stages of a build whose
// most G is GH: one, or two past NW heads
__host__ __device__ constexpr int heads_a_warp(int GH) { return GH > NW ? 2 : 1; }

struct Args {
  const void* q;                     // [b, nh, hd] T
  const uint8_t* kq;                 // [b, kvh, hd(/2), S] (pool: [n_pages, kvh, hd(/2), S = P])
  const float* ks;                   // [b, S] (pool: [n_pages, P])
  const uint8_t* vq;
  const float* vs;
  const int* lens;                   // [b]
  const int* tables;                 // [b, NC] pool page of each logical page; null: contiguous
  const float* kcos;                 // [hd/2, TS] RoPE at logical positions
  const float* ksin;
  const void* knew;                  // fold 1: [b, kvh, hd] int8; fold 2: T
  const float* kinv;                 // [b]
  const void* vnew;
  const float* vinv;
  const int* active;                 // [b] (fold 2: include_new)
  const float* qcos;                 // [b, hd/2]
  const float* qsin;
  void* out;                         // [b, nh, hd] T
  double* ppart;                     // scratch, [b, nh, NC] cells
  double* pvpart;                    // [b, nh, NC, hd]
  float* scores;                     // [b, nh, NC, CH]
  float* cmax;                       // [b, nh, NC]
  float* alpha;                      // [b, nh, NC]: block jb's rescale factor at jb
  int b, kvh, G, S, CH, BK, NC, TS, packed, rope, fold;
  float scale;
  int hd;                            // last: the other fields keep their offsets
};

// the head dim of the launch: the build's HD, or the launch's in the padded
// build (a constant everywhere else, so those builds' code is unchanged)
template <int HD>
__device__ __forceinline__ int head_dim(const Args& a) {
  return PAD ? a.hd : HD;
}

// p.V splits each head dim's columns into parts, one thread a part: (parts,
// columns a part, a multiple of 4) for head dim hd (a part past CHMAX is empty)
__host__ __device__ constexpr int pv_nparts(int hd) { return NT / hd; }
__host__ __device__ constexpr int pv_part_w(int hd) {
  return ((CHMAX + pv_nparts(hd) - 1) / pv_nparts(hd) + 3) & ~3;
}

// DECODE_ATTN_TRACE (decode_attn_timeline.py builds with it; off
// otherwise): thread 0 of each block stamps the global timer (ns) at entry
// (0), after the item table (1), at the end of the scores stage (2), after
// the first grid barrier (3), at the end of the softmax.V stage (4), after
// the second barrier (5) and at its end (6); row 7 holds the block's count
// of scores items.
#ifdef DECODE_ATTN_TRACE
__device__ unsigned long long attn_trace[8][4096];
__device__ __forceinline__ void trace(int row) {
  if (threadIdx.x == 0 && blockIdx.x < 4096) {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    attn_trace[row][blockIdx.x] = t;
  }
}
__device__ __forceinline__ void trace_count(int n) {
  if (threadIdx.x == 0 && blockIdx.x < 4096) attn_trace[7][blockIdx.x] = (unsigned long long)n;
}
// the stamps of the last launch: host [8][4096]
inline int read_trace(unsigned long long* host) {
  return (int)cudaMemcpyFromSymbol(host, attn_trace, sizeof(attn_trace));
}
#else
__device__ __forceinline__ void trace(int) {}
__device__ __forceinline__ void trace_count(int) {}
#endif

// The scratch: b * nh * NC cells, each 8 (1 + hd) + 4 (CH + 2) bytes
// (ops/decode_attention.py:_scratch allocates it).
inline void carve(Args& a, void* scratch, int nh, int hd) {
  const size_t n = (size_t)a.b * nh * a.NC;
  a.ppart = static_cast<double*>(scratch);
  a.pvpart = a.ppart + n;
  a.scores = reinterpret_cast<float*>(a.pvpart + n * hd);
  a.cmax = a.scores + n * a.CH;
  a.alpha = a.cmax + n;
}

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// round to the compute type T and widen again
template <typename T>
__device__ __forceinline__ float rt(float v) {
  if constexpr (sizeof(T) == 2) return __bfloat162float(__float2bfloat16_rn(v));
  return v;
}

// rotate-half RoPE on one pair, every operation rounded to T as PyTorch
// rounds it
template <typename T>
__device__ __forceinline__ void rope_pair(float x1, float x2, float c, float s, float& r1,
                                          float& r2) {
  r1 = rt<T>(__fsub_rn(rt<T>(__fmul_rn(x1, c)), rt<T>(__fmul_rn(x2, s))));
  r2 = rt<T>(__fadd_rn(rt<T>(__fmul_rn(x2, c)), rt<T>(__fmul_rn(x1, s))));
}

__device__ __forceinline__ uint32_t bf2_bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}
// bf16 pair arithmetic with an explicit rounding mode, which the compiler
// never contracts into a fused multiply-add. The product of two bf16 values
// is exact in fp32 and a bf16 sum of two bf16 values rounds as the fp32 sum
// rounded to bf16 does, so these round as PyTorch's bf16 operations.
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
__device__ __forceinline__ float bf_lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf_hi(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }

__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];" ::"l"(p));
}

// small signed integer -> double without a conversion instruction
__device__ __forceinline__ double int_to_double(int v) {
  return __hiloint2double(0x43300000, (int)((unsigned)v ^ 0x80000000u)) - 4503601774854144.0;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o /= 2) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int o = 16; o > 0; o /= 2) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ void cp_async(void* smem, const void* gmem, bool v16) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  if (v16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(s), "l"(gmem));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N));
}

// RoPE column buffers of the scores stage: two (prefetched with the next
// item) at head dim 64 and below, one at 128, where two would not leave
// room for two blocks an SM (a run stays in one chunk while there are no
// more item groups than blocks, see item_run, so it loads them once)
template <int HD>
__host__ __device__ constexpr int tab_bufs() { return HD >= 128 ? 1 : 2; }

// The block's dynamic shared memory (every kernel of a source launches with
// its own size of it)
extern __shared__ __align__(16) unsigned char attn_smem[];

// The dynamic shared memory of a block for G query heads a kv head (the
// build takes G = GL..GH), carved at run time. The plan past 8 heads, bytes(G)
// (blocks an SM of the 228 KB, each with its 1 KB reserve) at G = 9 / 12 /
// 16: hd 16 65888 / 78176 / 94576 (3 / 2 / 2); hd 32 74848 / 87136 / 103536
// (3 / 2 / 2); hd 64 117952 / 125680 / 135984 (1; G = 8: 111280, 2); hd 128
// and the padded build 147136 / 156400 / 168752 (1, as from G = 3), all
// under the 227 KB a block may take. At head dim 256 (one RoPE buffer, as
// at 128): 213584 / 221792 / 225904 at G = 2 / 3 / 4, one block an SM; G = 5
// rounds to a tile of 8 and needs 238208, over the 232448 a block may take
// (the RoPE columns alone are 131072), so that build takes G <= GMAX_D256. The scores stage's per-G arrays (qb,
// red, wmax) set the size at hd >= 64, the softmax.V stage's (sbuf, spv,
// redd) at hd <= 32; the register tile stays at most 8 heads (two passes of
// 8 past 8, up to four of 4 at hd <= 32). The layout: the
// three stages' buffers, which share its start (128-byte aligned: off that,
// the scores stage measured 14% slower at (1, 128)), then the scores stage's
// query heads in float64 (GP = g_tile(G) rows, the padding rows zero) and
// the item table. Every offset is a multiple of 16 bytes; the arrays that
// scale with G come after the fixed ones of their stage. bytes(G) is the
// size the host launches with.
template <int HD, int GL, int GH>
struct Smem {
  static constexpr int H2 = HD / 2, TB = tab_bufs<HD>();
  // the item table: first[BMAX + 1] (items before each slot; 1040 bytes),
  // lens[BMAX] (the slots' lengths, at most NC * CH), wsum[NW]
  static constexpr int TABLE = 1040 + 4 * BMAX + 4 * NW;
  // scores: kbuf[2][hd(/2) x CHMAX] (K chunks, two in flight), tab[TB][2]
  // [hd/2 x CHMAX] (their RoPE cos, sin), ksb[2][CHMAX] (K inverse scales),
  // lut4[256] (byte -> bf16 pair of its nibbles), lut8[256] (byte -> bf16 of
  // the int8); then per G: qb[2][G hd] (the query heads, T's bytes),
  // red[NQ][G][CHMAX] (part sums of q.k), wmax[G][CHMAX / 32] (the chunk's
  // maxima, a warp's part)
  static constexpr int A_TAB = 2 * HD * CHMAX, A_KSB = A_TAB + TB * 2 * H2 * CHMAX * 4,
                       A_LUT4 = A_KSB + 2 * CHMAX * 4, A_LUT8 = A_LUT4 + 1024,
                       A_QB = A_LUT8 + 512, A_PER_G = 8 * HD + NQ * CHMAX * 8 + CHMAX / 32 * 4;
  // softmax.V: vbuf[3][hd(/2) x VSA] (V chunks, a ring of three),
  // vsb[3][CHMAX] (their V scales); then per G: sbuf[3][G][CHMAX] (their
  // scores), spv[CHMAX][GP] (p * vs in the compute type, float64; the GP - G
  // padding columns zero), spf[G][CHMAX] (p), redd[NT / hd][G][hd] (p.V over
  // each part of the columns), sm[G] (m_j)
  static constexpr int V_VSB = 3 * HD * VSA, V_SBUF = V_VSB + 3 * CHMAX * 4;
  // finish: kf[hd], vf[hd] (the current token, folded); then per G:
  // chp[G][FW] (chunk partial sums of p), chm[G][FW] (and maxima),
  // bal[G][FW] (each block's rescale factor), scur[G], fin_m[G], fin_l[G]
  static constexpr int F_CHP = 8 * HD;

  // the stages' shared part, rounded to 16 bytes
  __host__ __device__ static constexpr int ubytes(int G) {
    const int a = A_QB + G * A_PER_G;
    const int v = V_SBUF + G * (3 * CHMAX * 4 + CHMAX * 4 + NT * 8 + 4) + g_tile(G) * CHMAX * 8;
    const int f = F_CHP + G * (FW * 16 + 12);
    return ((a > v ? (a > f ? a : f) : (v > f ? v : f)) + 15) / 16 * 16;
  }
  __host__ __device__ static constexpr int bytes(int G) {
    return ubytes(G) + g_tile(G) * HD * 8 + TABLE;
  }

  int g;
  __device__ explicit Smem(int g_run) : g(g_run) {}
  // G, a constant in a build of one G; G rounded up to the tile (all the
  // build's G round to one)
  __device__ int G() const { return GL == GH ? GL : g; }
  __device__ int GP() const { return g_tile(GH); }

  __device__ int table() const { return ubytes(G()) + GP() * HD * 8; }
  __device__ int* first() const { return reinterpret_cast<int*>(attn_smem + table()); }
  __device__ int* lens() const { return reinterpret_cast<int*>(attn_smem + table() + 1040); }
  __device__ int* wsum() const {
    return reinterpret_cast<int*>(attn_smem + table() + 1040 + 4 * BMAX);
  }
  // the item's query heads (scores stage: the pairs (j, j + hd/2) side by
  // side, GP rows; finish: G rows of hd)
  __device__ double* sq() const { return reinterpret_cast<double*>(attn_smem + ubytes(G())); }
  __device__ unsigned char* u() const { return attn_smem; }
  // scores
  __device__ uint8_t* kbuf(int buf) const { return u() + buf * HD * CHMAX; }
  __device__ float* tab(int buf, int tb) const {
    return reinterpret_cast<float*>(u() + A_TAB) + (buf * 2 + tb) * H2 * CHMAX;
  }
  __device__ float* ksb(int buf) const { return reinterpret_cast<float*>(u() + A_KSB) + buf * CHMAX; }
  __device__ uint32_t* lut4() const { return reinterpret_cast<uint32_t*>(u() + A_LUT4); }
  __device__ uint16_t* lut8() const { return reinterpret_cast<uint16_t*>(u() + A_LUT8); }
  __device__ float* qb(int buf) const { return reinterpret_cast<float*>(u() + A_QB) + buf * G() * HD; }
  __device__ double* red() const { return reinterpret_cast<double*>(u() + A_QB + G() * 8 * HD); }
  __device__ float* wmax() const {
    return reinterpret_cast<float*>(u() + A_QB + G() * (8 * HD + NQ * CHMAX * 8));
  }
  // softmax.V
  __device__ uint8_t* vbuf(int buf) const { return u() + buf * HD * VSA; }
  __device__ float* vsb(int buf) const { return reinterpret_cast<float*>(u() + V_VSB) + buf * CHMAX; }
  __device__ float* sbuf(int buf) const {
    return reinterpret_cast<float*>(u() + V_SBUF) + buf * G() * CHMAX;
  }
  __device__ double* spv() const {
    return reinterpret_cast<double*>(u() + V_SBUF + G() * 3 * CHMAX * 4);
  }
  __device__ float* spf() const {
    return reinterpret_cast<float*>(u() + V_SBUF + G() * 3 * CHMAX * 4 + GP() * CHMAX * 8);
  }
  __device__ double* redd() const {
    return reinterpret_cast<double*>(u() + V_SBUF + G() * 4 * CHMAX * 4 + GP() * CHMAX * 8);
  }
  __device__ float* sm() const {
    return reinterpret_cast<float*>(u() + V_SBUF + G() * (4 * CHMAX * 4 + NT * 8) +
                                    GP() * CHMAX * 8);
  }
  // finish
  __device__ float* kf() const { return reinterpret_cast<float*>(u()); }
  __device__ float* vf() const { return reinterpret_cast<float*>(u()) + HD; }
  __device__ double* chp() const { return reinterpret_cast<double*>(u() + F_CHP); }
  __device__ float* chm() const { return reinterpret_cast<float*>(u() + F_CHP + G() * FW * 8); }
  __device__ float* bal() const { return reinterpret_cast<float*>(u() + F_CHP + G() * FW * 12); }
  __device__ float* scur() const { return reinterpret_cast<float*>(u() + F_CHP + G() * FW * 16); }
  __device__ float* fin_m() const { return scur() + G(); }
  __device__ float* fin_l() const { return scur() + 2 * G(); }
};

// Items: per slot ceil(len / CH) chunks for each kv head; first[i] counts
// those before slot i. Every block derives the same table.
template <int HD, int GL, int GH>
__device__ int prep_items(const Args& a, Smem<HD, GL, GH> s) {
  const int t = threadIdx.x, lane = t % 32, w = t / 32;
  int* first = s.first();
  int* wsum = s.wsum();
  int x = 0;
  if (t < a.b) {
    const int len = min(max(__ldg(a.lens + t), 0), a.NC * a.CH);
    s.lens()[t] = len;
    x = (len + a.CH - 1) / a.CH * a.kvh;
  }
#pragma unroll
  for (int o = 1; o < 32; o *= 2) {               // inclusive scan: warp, then block
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) wsum[w] = x;
  __syncthreads();
  if (w == 0) {
    int z = lane < NW ? wsum[lane] : 0;
#pragma unroll
    for (int o = 1; o < NW; o *= 2) {
      const int y = __shfl_up_sync(0xffffffffu, z, o);
      if (lane >= o) z += y;
    }
    if (lane < NW) wsum[lane] = z;
  }
  __syncthreads();
  if (w > 0) x += wsum[w - 1];
  if (t < a.b) first[t + 1] = x;
  if (t == 0) first[0] = 0;
  __syncthreads();
  return first[a.b];
}

// A block's contiguous run [lo, hi) of the items. Items come in groups of
// kvh (one slot's chunk, every kv head: the same RoPE columns); while there
// are no more groups than blocks, each block's run stays inside one group,
// so it loads one chunk's RoPE columns, and the blocks of a group split its
// items evenly.
__device__ __forceinline__ void item_run(int items, int kvh, int& lo, int& hi) {
  const long long grid = gridDim.x, b = blockIdx.x, groups = items / kvh;
  if (groups > 0 && groups <= grid) {
    const long long g = b * groups / grid;
    const long long b0 = (g * grid + groups - 1) / groups, b1 = ((g + 1) * grid + groups - 1) / groups;
    lo = (int)(g * kvh + (b - b0) * kvh / (b1 - b0));
    hi = (int)(g * kvh + (b - b0 + 1) * kvh / (b1 - b0));
  } else {
    lo = (int)(items * b / grid);
    hi = (int)(items * (b + 1) / grid);
  }
}

// item r -> (slot i, kv head h, chunk c), chunk-major within a slot
__device__ __forceinline__ void find_item(const Args& a, const int* first, int r, int& i, int& h,
                                          int& c) {
  int lo = 0, hi = a.b - 1;                       // the last slot whose first item is <= r
  while (lo < hi) {
    const int mid = (lo + hi + 1) / 2;
    if (first[mid] <= r) lo = mid; else hi = mid - 1;
  }
  i = lo;
  const int loc = r - first[i];
  c = loc / a.kvh;
  h = loc % a.kvh;
}

// where chunk c of (slot i, kv head h) lives: its first byte of K/V (rows
// S bytes apart) and its first scale
__device__ __forceinline__ void chunk_src(const Args& a, int i, int h, int c, int hdc,
                                          size_t& kv, size_t& sc) {
  if (a.tables) {
    const int pid = __ldg(a.tables + (size_t)i * a.NC + c);
    kv = ((size_t)pid * a.kvh + h) * hdc * a.S;
    sc = (size_t)pid * a.S;
  } else {
    kv = ((size_t)i * a.kvh + h) * hdc * a.S + (size_t)c * a.CH;
    sc = (size_t)i * a.S + (size_t)c * a.CH;
  }
}

// the (slot i, query head hq, chunk c) cell of the scratch arrays (G: the
// stage's, a constant in the builds of tile 1 and 2)
__device__ __forceinline__ size_t cell(const Args& a, int G, int i, int hq, int c) {
  return ((size_t)i * a.kvh * G + hq) * a.NC + c;
}

// q.k of column `col` of the item in buffer `bf` against the GT query heads
// from g0 (sq's rows G..GP-1 are zero), NQ threads a column, each over PQ of
// the hd/2 pairs -> red (the real heads' part sums). With a bf16 q the
// cached integers become bf16 through a table and their RoPE runs on bf16
// pairs: no conversion instruction but one to pack (cos ks, sin ks).
template <typename T, int HD, int GL, int GH>
__device__ __forceinline__ void qk_col(const Args& a, Smem<HD, GL, GH> s, int bf, int qp,
                                       int col, int ncol, int g0) {
  constexpr int TB = tab_bufs<HD>(), GT = build_tile<HD>(GH);
  const int H2 = head_dim<HD>(a) / 2, PQ = H2 / NQ;
  double acc[GT];
#pragma unroll
  for (int g = 0; g < GT; ++g) acc[g] = 0.0;
  if (col < ncol) {
    const float ksc = s.ksb(bf)[col];
    const float st = rt<T>(ksc);
    const uint8_t* kb = s.kbuf(bf);
    const float* tc = s.tab(TB == 2 ? bf : 0, 0);
    const float* ts = s.tab(TB == 2 ? bf : 0, 1);
    const uint32_t* lut4 = s.lut4();
    const uint16_t* lut8 = s.lut8();
    const double2* sq2 = reinterpret_cast<const double2*>(s.sq());
    const uint32_t st2 = bf2_bits(__floats2bfloat162_rn(st, st));
#pragma unroll 4
    for (int u = 0; u < PQ; ++u) {
      const int j = qp * PQ + u;
      float r1, r2;
      if constexpr (sizeof(T) == 2) {
        const uint32_t kk = a.packed ? lut4[kb[j * CHMAX + col]]
                                     : (uint32_t)lut8[kb[j * CHMAX + col]] |
                                           ((uint32_t)lut8[kb[(j + H2) * CHMAX + col]] << 16);
        uint32_t r;                   // (r1, r2) as a bf16 pair
        if (a.rope) {
          const uint32_t cs = bf2_bits(__floats2bfloat162_rn(__fmul_rn(tc[j * CHMAX + col], ksc),
                                                             __fmul_rn(ts[j * CHMAX + col], ksc)));
          const uint32_t kc = bf2_mul_rn(kk, __byte_perm(cs, 0, 0x1010));   // (k1 c, k2 c)
          const uint32_t ks2 = bf2_mul_rn(kk, __byte_perm(cs, 0, 0x3232));  // (k1 s, k2 s)
          r = bf2_add_rn(kc, __byte_perm(ks2, 0, 0x1032) ^ 0x8000u);         // (k1 c - k2 s, k2 c + k1 s)
        } else {
          r = bf2_mul_rn(kk, st2);
        }
        r1 = bf_lo(r);
        r2 = bf_hi(r);
      } else {
        float k1, k2;
        if (a.packed) {
          const uint8_t v = kb[j * CHMAX + col];
          k1 = (float)((int8_t)(v << 4) >> 4);
          k2 = (float)((int8_t)v >> 4);
        } else {
          k1 = (float)(int8_t)kb[j * CHMAX + col];
          k2 = (float)(int8_t)kb[(j + H2) * CHMAX + col];
        }
        if (a.rope) {
          rope_pair<T>(k1, k2, __fmul_rn(tc[j * CHMAX + col], ksc),
                       __fmul_rn(ts[j * CHMAX + col], ksc), r1, r2);
        } else {
          r1 = __fmul_rn(k1, st);
          r2 = __fmul_rn(k2, st);
        }
      }
      const double d1 = (double)r1, d2 = (double)r2;
#pragma unroll
      for (int g = 0; g < GT; ++g) {
        const double2 qq = sq2[(g0 + g) * H2 + j];
        acc[g] = fma(qq.x, d1, fma(qq.y, d2, acc[g]));
      }
    }
  }
  double* red = s.red();
  const int G = s.G();
#pragma unroll
  for (int g = 0; g < GT; ++g)
    if (g0 + g < G) red[(qp * G + g0 + g) * CHMAX + col] = acc[g];
}

// The scores stage: a contiguous run of items a block (item_run). The next
// item's K rows, K scales, query heads and (for a new chunk, at head dim 64
// and below) RoPE columns arrive by cp.async while one is computed: q.k of
// each live column against the G query heads in float64 (qk_col) ->
// scores; the chunk's maxima -> cmax. The item's V rows and scales are
// prefetched into L2 for the softmax.V stage.
template <typename T, int HD, int GL, int GH>
__device__ void scores_stage(const Args& a, Smem<HD, GL, GH> s, int items) {
  constexpr int TB = tab_bufs<HD>(), GT = build_tile<HD>(GH);
  const int hd = head_dim<HD>(a), H2 = hd / 2;
  const int G = s.G(), GP = s.GP();
  const int tid = threadIdx.x, qp = tid / CHMAX, col = tid % CHMAX, lane = tid % 32;
  const int nh = a.kvh * G, hdc = a.packed ? H2 : hd, CH = a.CH;
  // the query heads' bytes: 16-byte pieces, or 8 where a row is no multiple
  // of 16 bytes (bf16 at hd 100)
  const bool q16 = hd * (int)sizeof(T) % 16 == 0;
  const int qvec = q16 ? 16 : 8;
  const bool v16 = CH % 16 == 0 && a.S % 16 == 0;  // else 8-byte pieces (CH = 8)
  const int vec = v16 ? 16 : 8, per_row = CH / vec;
  const int* first = s.first();
  int lo, hi;
  item_run(items, a.kvh, lo, hi);
  trace_count(hi - lo);
  {                                 // byte -> bf16 tables
    const int v = tid;
    s.lut4()[v] = bf2_bits(__floats2bfloat162_rn((float)((int8_t)(v << 4) >> 4), (float)((int8_t)v >> 4)));
    s.lut8()[v] = (uint16_t)(bf2_bits(__floats2bfloat162_rn((float)(int8_t)v, 0.f)) & 0xffffu);
  }
  int tab0 = -1, tab1 = -1;         // the chunk whose RoPE columns buffer 0 / 1 holds
  auto issue_tab = [&](int c, int buf) {
    const int per_t = CH / 4;
    for (int idx = tid; idx < 2 * H2 * per_t; idx += NT) {
      const int tb = idx / (H2 * per_t), r = idx % (H2 * per_t), row = r / per_t;
      const int pc = r % per_t;
      cp_async(s.tab(buf, tb) + row * CHMAX + pc * 4,
               (tb ? a.ksin : a.kcos) + (size_t)row * a.TS + (size_t)c * CH + pc * 4, true);
    }
    if (buf)
      tab1 = c;
    else
      tab0 = c;
  };
  auto issue = [&](int item, int buf) {
    if (item < hi) {
      int i, h, c;
      find_item(a, first, item, i, h, c);
      size_t kv, so;
      chunk_src(a, i, h, c, hdc, kv, so);
      uint8_t* kb = s.kbuf(buf);
      for (int idx = tid; idx < hdc * per_row; idx += NT) {
        const int row = idx / per_row, pc = idx % per_row;
        cp_async(kb + row * CHMAX + pc * vec, a.kq + kv + (size_t)row * a.S + pc * vec, v16);
      }
      if (tid < CH / 4) cp_async(s.ksb(buf) + tid * 4, a.ks + so + tid * 4, true);
      const char* qsrc = static_cast<const char*>(a.q) + ((size_t)i * nh + h * G) * hd * sizeof(T);
      char* qdst = reinterpret_cast<char*>(s.qb(buf));
      for (int idx = tid; idx < G * hd * (int)sizeof(T) / qvec; idx += NT)
        cp_async(qdst + idx * qvec, qsrc + idx * qvec, q16);
      if (TB == 2 && a.rope && (buf ? tab1 : tab0) != c) issue_tab(c, buf);
    }
    cp_async_commit();
  };
  issue(lo, 0);
  double* sq = s.sq();
  const double* red = s.red();
  float* wmax = s.wmax();
  for (int item = lo, k = 0; item < hi; ++item, ++k) {
    __syncthreads();                // the previous item is done with the shared memory
    int i, h, c;
    find_item(a, first, item, i, h, c);
    if (TB == 1 && a.rope && tab0 != c) {   // a new chunk: its RoPE columns, not prefetched
      issue_tab(c, 0);
      cp_async_commit();
    }
    issue(item + 1, (k + 1) & 1);
    {
      size_t kv, so;
      chunk_src(a, i, h, c, hdc, kv, so);
      if constexpr (HD >= NT) {     // as many V rows as threads: the scales after them
        for (int r = tid; r < hdc + (CH * 4 + 127) / 128; r += NT)
          prefetch_l2(r < hdc ? a.vq + kv + (size_t)r * a.S
                              : static_cast<const void*>(a.vs + so + (r - hdc) * 32));
      } else {
        if (tid < hdc)
          prefetch_l2(a.vq + kv + (size_t)tid * a.S);
        else if (tid < hdc + (CH * 4 + 127) / 128)
          prefetch_l2(a.vs + so + (tid - hdc) * 32);
      }
    }
    const int bf = k & 1;
    cp_async_wait<1>();
    __syncthreads();
    const T* qt = reinterpret_cast<const T*>(s.qb(bf));
    for (int idx = tid; idx < GP * hd; idx += NT) {
      const int g = idx / hd, d = idx % hd;
      sq[(g * H2 + d % H2) * 2 + d / H2] = g < G ? (double)to_f(qt[idx]) : 0.0;
    }
    __syncthreads();
    const int ncol = min(CH, s.lens()[i] - c * CH);
    for (int g0 = 0; g0 < G; g0 += GT)         // one pass but at hd <= 32 past 4 heads
      qk_col<T>(a, s, bf, qp, col, ncol, g0);
    __syncthreads();
    for (int idx = tid; idx < G * CHMAX; idx += NT) {   // a warp: 32 columns of one head
      const int g = idx / CHMAX, cl = idx % CHMAX;
      float v = NEG_INF;
      if (cl < ncol) {
        double t = red[g * CHMAX + cl];
#pragma unroll
        for (int e = 1; e < NQ; ++e) t += red[(e * G + g) * CHMAX + cl];
        v = __fmul_rn((float)t, a.scale);
        a.scores[cell(a, G, i, h * G + g, c) * CH + cl] = v;
      }
      v = warp_max(v);
      if (lane == 0) wmax[g * (CHMAX / 32) + cl / 32] = v;
    }
    __syncthreads();
    if (tid < G) {
      float m = wmax[tid * (CHMAX / 32)];
#pragma unroll
      for (int e = 1; e < CHMAX / 32; ++e) m = fmaxf(m, wmax[tid * (CHMAX / 32) + e]);
      a.cmax[cell(a, G, i, h * G + tid, c)] = m;
    }
  }
  cp_async_wait<0>();
}

// The softmax.V stage's loads of item `item` of the run [.., hi) into ring
// buffer `buf`: its V rows and V scales (issue_v, which need nothing of the
// scores stage), and its scores (issue_s). The caller commits.
template <int HD, int GL, int GH>
__device__ void issue_v(const Args& a, Smem<HD, GL, GH> s, int item, int hi,
                                        int buf) {
  if (item >= hi) return;
  const int hd = head_dim<HD>(a), hdc = a.packed ? hd / 2 : hd, CH = a.CH, tid = threadIdx.x;
  const bool v16 = CH % 16 == 0 && a.S % 16 == 0;  // else 8-byte pieces (CH = 8)
  const int vec = v16 ? 16 : 8, per_row = CH / vec;
  int i, h, c;
  find_item(a, s.first(), item, i, h, c);
  size_t kv, so;
  chunk_src(a, i, h, c, hdc, kv, so);
  uint8_t* vb = s.vbuf(buf);
  for (int idx = tid; idx < hdc * per_row; idx += NT) {
    const int row = idx / per_row, pc = idx % per_row;
    cp_async(vb + row * VSA + pc * vec, a.vq + kv + (size_t)row * a.S + pc * vec, v16);
  }
  if (tid < CH / 4) cp_async(s.vsb(buf) + tid * 4, a.vs + so + tid * 4, true);
}

template <int HD, int GL, int GH>
__device__ void issue_s(const Args& a, Smem<HD, GL, GH> s, int item, int hi,
                                        int buf) {
  if (item >= hi) return;
  const int CH = a.CH;
  int i, h, c;
  find_item(a, s.first(), item, i, h, c);
  float* sb = s.sbuf(buf);
  const int G = s.G();
  for (int idx = threadIdx.x; idx < G * (CH / 4); idx += NT) {
    const int g = idx / (CH / 4), pc = idx % (CH / 4);
    cp_async(sb + g * CHMAX + pc * 4, a.scores + cell(a, G, i, h * G + g, c) * CH + pc * 4, true);
  }
}

// Before the barrier that ends the scores stage: the V rows of the
// softmax.V stage's first two items (one commit group each).
template <int HD, int GL, int GH>
__device__ void prefetch_v(const Args& a, Smem<HD, GL, GH> s, int items) {
  int lo, hi;
  item_run(items, a.kvh, lo, hi);
  __syncthreads();                  // the scores stage is done with the shared memory
  for (int k = 0; k < 2; ++k) {
    issue_v(a, s, lo + k, hi, k);
    cp_async_commit();
  }
}

// p.V of the item in buffer `bf`: a thread takes head dim d of the GT heads
// from g0 over a part of the columns (each V value is widened once for the
// heads; spv's padding columns G..GP-1 are zero) -> redd (the real heads).
template <int HD, int GL, int GH>
__device__ __forceinline__ void pv_col(const Args& a, Smem<HD, GL, GH> s, int bf, int ncol,
                                       int g0) {
  constexpr int GT = build_tile<HD>(GH);
  const int hd = head_dim<HD>(a), H2 = hd / 2, NPART = pv_nparts(hd), PART = pv_part_w(hd);
  const int tid = threadIdx.x, d = tid % hd, part = tid / hd, ncol4 = (ncol + 3) & ~3;
  if (PAD && part >= NPART) return;   // threads past NPART x hd (hd no divisor of NT)
  const uint8_t* vrow = s.vbuf(bf) + (a.packed ? d % H2 : d) * VSA;
  const int shift = a.packed ? (d < H2 ? 28 : 24) : 24, back = a.packed ? 28 : 24;
  const int G = s.G(), GP = s.GP();
  const double* spv = s.spv() + g0;
  double acc[GT];
#pragma unroll
  for (int g = 0; g < GT; ++g) acc[g] = 0.0;
  for (int c4 = part * PART; c4 < min(ncol4, (part + 1) * PART); c4 += 4) {
    const uint32_t w = *reinterpret_cast<const uint32_t*>(vrow + c4);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const double v = int_to_double((int)(((w >> (8 * e)) & 0xffu) << shift) >> back);
#pragma unroll
      for (int g = 0; g < GT; ++g) acc[g] = fma(spv[(c4 + e) * GP + g], v, acc[g]);
    }
  }
  double* redd = s.redd();
#pragma unroll
  for (int g = 0; g < GT; ++g)
    if (g0 + g < G) redd[(part * G + g0 + g) * hd + d] = acc[g];
}

// The same runs as the scores stage: p against m_j, the prefix maximum of
// the chunk's BK block; float64 partial sums of p and of p.V. The V rows, V
// scales and scores of the item two ahead arrive by cp.async into a ring of
// three buffers (the first two items' V rows since prefetch_v), its first
// chunk maxima one item ahead in registers.
template <typename T, int HD, int GL, int GH>
__device__ void softmax_v_stage(const Args& a, Smem<HD, GL, GH> s, int items) {
  constexpr int SPT = (g_tile(GH) * CHMAX + NT - 1) / NT, GT = build_tile<HD>(GH);
  constexpr int HPW = heads_a_warp(GH);
  const int hd = head_dim<HD>(a), G = s.G(), GP = s.GP(), NO = G * hd;
  const int tid = threadIdx.x, lane = tid % 32;
  const int CH = a.CH, cpb = a.BK / CH;
  const int* first = s.first();
  int lo, hi;
  item_run(items, a.kvh, lo, hi);
  float* sm = s.sm();
  float* spf = s.spf();
  double* spv = s.spv();
  float cmr[HPW];                     // this warp's heads' first 32 chunk maxima
#pragma unroll
  for (int e = 0; e < HPW; ++e) cmr[e] = NEG_INF;
  auto fetch_max = [&](int item) {
    if (item < hi && tid / 32 < G) {
      int i, h, c;
      find_item(a, first, item, i, h, c);
      const int ce = min((s.lens()[i] + CH - 1) / CH, (c / cpb + 1) * cpb);
#pragma unroll
      for (int e = 0; e < HPW; ++e) {   // heads tid / 32 (and tid / 32 + NW)
        const int g = tid / 32 + e * NW;
        if (e == 0 || g < G)
          cmr[e] = lane < ce ? __ldcg(a.cmax + cell(a, G, i, h * G + g, 0) + lane) : NEG_INF;
      }
    }
  };
  fetch_max(lo);
  for (int k = 0; k < 2; ++k) {
    issue_s(a, s, lo + k, hi, k);
    cp_async_commit();
  }
  for (int item = lo, k = 0; item < hi; ++item, ++k) {
    __syncthreads();                // the previous item is done with the shared memory
    issue_v(a, s, item + 2, hi, (k + 2) % 3);
    issue_s(a, s, item + 2, hi, (k + 2) % 3);
    cp_async_commit();
    int i, h, c;
    find_item(a, first, item, i, h, c);
    const int bf = k % 3, len = s.lens()[i], ncol = min(CH, len - c * CH);
    const int ce = min((len + CH - 1) / CH, (c / cpb + 1) * cpb);
#pragma unroll
    for (int e = 0; e < HPW; ++e) {   // m_j: a warp a head (two past NW heads)
      const int g = tid / 32 + e * NW;
      if (g < G) {
        const size_t c0 = cell(a, G, i, h * G + g, 0);
        float m = cmr[e];
        for (int cc = lane + 32; cc < ce; cc += 32) m = fmaxf(m, __ldcg(a.cmax + c0 + cc));
        m = warp_max(m);
        if (lane == 0) sm[g] = m;
      }
    }
    fetch_max(item + 1);
    cp_async_wait<2>();
    __syncthreads();
    const float* sb = s.sbuf(bf);
    const float* vsb = s.vsb(bf);
#pragma unroll
    for (int e = 0; e < SPT; ++e) {
      const int idx = tid + e * NT, g = idx / CHMAX, cl = idx % CHMAX;
      if (idx < GP * CHMAX) {
        float pr = 0.f;
        double pv = 0.0;
        if (g < G && cl < ncol) {
          pr = expf(__fsub_rn(sb[idx], sm[g]));
          pv = (double)rt<T>(__fmul_rn(pr, rt<T>(vsb[cl])));
        }
        if (g < G) spf[g * CHMAX + cl] = pr;
        spv[cl * GP + g] = pv;
      }
    }
    __syncthreads();
    for (int g = tid / 32; g < G; g += NW) {
      double t = 0.0;
#pragma unroll
      for (int e = 0; e < CHMAX / 32; ++e) t += (double)spf[g * CHMAX + lane + 32 * e];
      t = warp_sum(t);
      if (lane == 0) a.ppart[cell(a, G, i, h * G + g, c)] = t;
    }
    // p.V over each part of the columns, the parts summed through shared
    // memory
    for (int g0 = 0; g0 < G; g0 += GT)         // one pass but at hd <= 32 past 4 heads
      pv_col(a, s, bf, ncol, g0);
    __syncthreads();
    const double* redd = s.redd();
    for (int o = tid; o < NO; o += NT) {
      double t = redd[o];
#pragma unroll
      for (int e = 1; e < pv_nparts(hd); ++e) t += redd[e * NO + o];
      a.pvpart[cell(a, G, i, h * G + o / hd, c) * hd + o % hd] = t;
    }
  }
  cp_async_wait<0>();
}

// (slot i, kv head h): the fp32 recurrence over the slot's BK blocks from
// the chunks' partial sums, the current token folded in, the division.
// Every load is issued first, so that they are in flight together. OPT:
// outputs a thread, at least ceil(G hd / NT).
template <typename T, int OPT, int HD, int GL, int GH>
__device__ void finish_head(const Args& a, Smem<HD, GL, GH> s, int i, int h) {
  // chunks of partial sums in flight an output
  constexpr int NB = OPT > 4 ? 2 : OPT > 2 ? 4 : 8, HPW = heads_a_warp(GH);
  const int hd = head_dim<HD>(a), H2 = hd / 2;
  const int G = s.G(), NO = G * hd;
  const int tid = threadIdx.x, lane = tid % 32, gw = tid / 32, nh = a.kvh * G, CH = a.CH;
  const int nch = (s.lens()[i] + CH - 1) / CH, cpb = a.BK / CH;
  double* sq = s.sq();
  float* kf = s.kf();
  float* vf = s.vf();
  double* chp = s.chp();
  float* chm = s.chm();
  float* bal = s.bal();
  // the query heads, the current token's pair, this warp's head's first 64
  // chunk statistics and each output's first NB partial p.V sums
  const T* qp = static_cast<const T*>(a.q) + ((size_t)i * nh + h * G) * hd;
  float qv[OPT];
#pragma unroll
  for (int u = 0; u < OPT; ++u) qv[u] = tid + u * NT < NO ? to_f(qp[tid + u * NT]) : 0.f;
  float f1 = 0.f, f2 = 0.f, f3 = 0.f, f4 = 0.f, fc = 0.f, fs = 0.f, ki = 0.f, vi = 0.f;
  const size_t pair = ((size_t)i * a.kvh + h) * hd;
  if (a.fold == 1 && tid < H2) {
    const int8_t* kn = static_cast<const int8_t*>(a.knew) + pair;
    const int8_t* vn = static_cast<const int8_t*>(a.vnew) + pair;
    f1 = (float)kn[tid];
    f2 = (float)kn[tid + H2];
    f3 = (float)vn[tid];
    f4 = (float)vn[tid + H2];
    ki = __ldg(a.kinv + i);
    vi = __ldg(a.vinv + i);
    if (a.rope) {
      fc = __ldg(a.qcos + (size_t)i * H2 + tid);
      fs = __ldg(a.qsin + (size_t)i * H2 + tid);
    }
  } else if (a.fold == 2 && tid < hd) {
    f1 = to_f(static_cast<const T*>(a.knew)[pair + tid]);
    f3 = to_f(static_cast<const T*>(a.vnew)[pair + tid]);
  }
  // this warp's heads gw (and gw + NW): their cells
  size_t cg0[HPW];
  float cmr[HPW][2];
  double cpr[HPW][2];
#pragma unroll
  for (int w = 0; w < HPW; ++w) {
    cg0[w] = cell(a, G, i, h * G + min(gw + w * NW, G - 1), 0);
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int cc = lane + 32 * e;
      const bool ok = gw + w * NW < G && cc < nch;
      cmr[w][e] = ok ? __ldcg(a.cmax + cg0[w] + cc) : NEG_INF;
      cpr[w][e] = ok ? __ldcg(a.ppart + cg0[w] + cc) : 0.0;
    }
  }
  double v0[OPT][NB];
#pragma unroll
  for (int u = 0; u < OPT; ++u) {
    const int o = min(tid + u * NT, NO - 1);
    const double* pv = a.pvpart + cell(a, G, i, h * G + o / hd, 0) * hd + o % hd;
#pragma unroll
    for (int e = 0; e < NB; ++e) v0[u][e] = e < nch ? __ldcg(pv + (size_t)e * hd) : 0.0;
  }
  // into shared memory
#pragma unroll
  for (int u = 0; u < OPT; ++u)
    if (tid + u * NT < NO) sq[tid + u * NT] = (double)qv[u];
#pragma unroll
  for (int w = 0; w < HPW; ++w) {
    const int g = gw + w * NW;
    if (g < G) {
#pragma unroll
      for (int e = 0; e < 2; ++e)
        if (lane + 32 * e < nch) {
          chm[g * FW + lane + 32 * e] = cmr[w][e];
          chp[g * FW + lane + 32 * e] = cpr[w][e];
        }
    }
  }
  if (a.fold == 1 && tid < H2) {
    float kf1, kf2;
    if (a.rope) {
      rope_pair<T>(f1, f2, rt<T>(__fmul_rn(fc, ki)), rt<T>(__fmul_rn(fs, ki)), kf1, kf2);
    } else {
      kf1 = rt<T>(__fmul_rn(f1, rt<T>(ki)));
      kf2 = rt<T>(__fmul_rn(f2, rt<T>(ki)));
    }
    const float vt = rt<T>(vi);
    kf[tid] = kf1;
    kf[tid + H2] = kf2;
    vf[tid] = rt<T>(__fmul_rn(f3, vt));
    vf[tid + H2] = rt<T>(__fmul_rn(f4, vt));
  } else if (a.fold == 2 && tid < hd) {
    kf[tid] = f1;
    vf[tid] = f3;
  }
  __syncthreads();
  // the denominator's recurrence, a warp a head (two past NW heads): lane 0
  // walks the chunk statistics in order (FW at a time; past the first 64
  // the warp loads them here), the block factors -> bal (block FW on:
  // a.alpha)
#pragma unroll
  for (int w = 0; w < HPW; ++w) {
    const int g = gw + w * NW;
    if (g >= G) break;
    const size_t cg0w = cg0[w];
    float m = NEG_INF, l = 0.f, mb = NEG_INF;
    double P = 0.0;
    int jb = 0, end = min(nch, cpb);  // block jb ends at chunk end
    for (int w0 = 0; w0 < nch; w0 += FW) {
      const int wn = min(FW, nch - w0);
      __syncwarp();
      for (int e = w0 ? lane : lane + 64; e < wn; e += 32) {
        chm[g * FW + e] = __ldcg(a.cmax + cg0w + w0 + e);
        chp[g * FW + e] = __ldcg(a.ppart + cg0w + w0 + e);
      }
      __syncwarp();
      if (lane == 0) {
        for (int e = 0; e < wn; ++e) {
          const int cc = w0 + e;
          mb = fmaxf(mb, chm[g * FW + e]);
          P += chp[g * FW + e];
          if (cc + 1 == end) {         // block jb is complete
            mb = fmaxf(m, mb);
            const float al = expf(__fsub_rn(m, mb));
            l = __fadd_rn(__fmul_rn(l, al), (float)P);
            if (jb < FW)
              bal[g * FW + jb] = al;
            else
              a.alpha[cg0w + jb] = al;
            m = mb;
            P = 0.0;
            ++jb;
            end = min(nch, end + cpb);
          }
        }
      }
    }
    if (lane == 0) {
      s.fin_m()[g] = m;
      s.fin_l()[g] = l;
    }
    if (a.fold) {                     // the current token's score
      double sc = 0.0;
      for (int d = lane; d < hd; d += 32) sc = fma(sq[g * hd + d], (double)kf[d], sc);
      sc = warp_sum(sc);
      if (lane == 0) s.scur()[g] = __fmul_rn((float)sc, a.scale);
    }
  }
  __syncthreads();
  if (tid >= NO) return;
  const bool inc = a.fold == 2 ? __ldg(a.active + i) > 0 : a.fold && __ldg(a.active + i) != 0;
  float acc[OPT];
  double PV[OPT];
#pragma unroll
  for (int u = 0; u < OPT; ++u) {
    acc[u] = 0.f;
    PV[u] = 0.0;
  }
  // NB chunks of every output of the thread a batch: their loads in flight together
  int jb = 0, end = min(nch, cpb);    // block jb ends at chunk end
  for (int b0 = 0; b0 < nch; b0 += NB) {
    if (b0 > 0) {                     // the first batch is v0, loaded first
#pragma unroll
      for (int u = 0; u < OPT; ++u) {
        const int o = min(tid + u * NT, NO - 1);
        const double* pv = a.pvpart + cell(a, G, i, h * G + o / hd, 0) * hd + o % hd;
#pragma unroll
        for (int e = 0; e < NB; ++e) v0[u][e] = b0 + e < nch ? __ldcg(pv + (size_t)(b0 + e) * hd) : 0.0;
      }
    }
#pragma unroll
    for (int e = 0; e < NB; ++e) {
      const int cc = b0 + e;
      if (cc < nch) {
#pragma unroll
        for (int u = 0; u < OPT; ++u) PV[u] += v0[u][e];
        if (cc + 1 == end) {          // block jb is complete
#pragma unroll
          for (int u = 0; u < OPT; ++u) {
            const int g = min(tid + u * NT, NO - 1) / hd;
            const float al = jb < FW ? bal[g * FW + jb] : __ldcg(a.alpha + cell(a, G, i, h * G + g, jb));
            acc[u] = __fadd_rn(__fmul_rn(acc[u], al), (float)PV[u]);
            PV[u] = 0.0;
          }
          ++jb;
          end = min(nch, end + cpb);
        }
      }
    }
  }
#pragma unroll
  for (int u = 0; u < OPT; ++u) {
    const int o = tid + u * NT, g = o / hd, d = o % hd;
    if (o >= NO) break;
    float l = s.fin_l()[g], r = acc[u];
    if (a.fold) {
      const float m = s.fin_m()[g], sc = inc ? s.scur()[g] : NEG_INF, m_new = fmaxf(m, sc);
      const float al = expf(__fsub_rn(m, m_new));
      const float pr = a.fold == 2 || inc ? expf(__fsub_rn(sc, m_new)) : 0.f;
      l = __fadd_rn(__fmul_rn(l, al), pr);
      r = __fadd_rn(__fmul_rn(r, al), __fmul_rn(a.fold == 2 ? rt<T>(pr) : pr, vf[d]));
    }
    put(static_cast<T*>(a.out) + ((size_t)i * nh + h * G + g) * hd + d, r / fmaxf(l, 1e-9f));
  }
}

// outputs a thread for NO = G hd outputs: 1, 2, 4 or 8
__host__ __device__ constexpr int outputs_a_thread(int no) {
  return no > 4 * NT ? 8 : no > 2 * NT ? 4 : no > NT ? 2 : 1;
}

// finish_head with the fewest outputs a thread that G hd needs (only those
// the build's G can ask for are built)
template <typename T, int HD, int GL, int GH>
__device__ __forceinline__ void finish(const Args& a, Smem<HD, GL, GH> s, int i, int h) {
  constexpr int LO = outputs_a_thread(GL * HD_MIN), HI = outputs_a_thread(GH * HD);
  const int opt = outputs_a_thread(s.G() * head_dim<HD>(a));
  if constexpr (HI == 8) {
    if (opt == 8) return finish_head<T, 8>(a, s, i, h);
  }
  if constexpr (LO <= 4 && HI >= 4) {
    if (opt == 4) return finish_head<T, 4>(a, s, i, h);
  }
  if constexpr (LO <= 2 && HI >= 2) {
    if (opt == 2) return finish_head<T, 2>(a, s, i, h);
  }
  if constexpr (LO == 1) finish_head<T, 1>(a, s, i, h);
}

// blocks an SM a build asks its registers to allow: MINB, but one where the
// shared memory of the build's fewest G already leaves room for one block an
// SM only (head dim 128 from G = 3, 64 from G = 9), so the registers have
// nothing to buy (MINB there cost the run-time-G build at (8, 128) 13%,
// PERF.md)
constexpr int SM_SMEM = 228 * 1024, BLOCK_SMEM_RESERVED = 1024;   // Hopper, a block's reserve
template <int HD, int GL, int GH>
__host__ __device__ constexpr int min_blocks() {
  return 2 * (Smem<HD, GL, GH>::bytes(GL) + BLOCK_SMEM_RESERVED) > SM_SMEM ? 1 : MINB;
}

// GL..GH: the query heads a kv head the build takes (build_lo)
template <typename T, int HD, int GL, int GH>
__global__ void __launch_bounds__(NT, (min_blocks<HD, GL, GH>())) attn_kernel(Args a) {
  const Smem<HD, GL, GH> s(a.G);
  cg::grid_group grid = cg::this_grid();
  trace(0);
  const int items = prep_items(a, s);
  trace(1);
  scores_stage<T>(a, s, items);
  trace(2);
  prefetch_v(a, s, items);
  grid.sync();
  trace(3);
  softmax_v_stage<T>(a, s, items);
  trace(4);
  grid.sync();
  trace(5);
  for (int item = blockIdx.x; item < a.b * a.kvh; item += gridDim.x) {
    __syncthreads();                // the previous item is done with the shared memory
    finish<T>(a, s, item / a.kvh, item % a.kvh);
  }
  trace(6);
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

// the kernel of the build GL..GH for dtype_code (0 f32, 1 bf16) at head
// dim HD, the dynamic shared memory of a launch at G query heads a kv head,
// and the most a launch of that build takes
template <int HD, int GL, int GH>
const void* kernel_t(int dtype_code, int G, int* smem, int* smem_max) {
  *smem = Smem<HD, GL, GH>::bytes(G);
  *smem_max = Smem<HD, GL, GH>::bytes(GH);
  return dtype_code == 1 ? reinterpret_cast<const void*>(&attn_kernel<__nv_bfloat16, HD, GL, GH>)
                         : reinterpret_cast<const void*>(&attn_kernel<float, HD, GL, GH>);
}

// the build of head dim HD that takes G (build_lo); at head dim 256 only
// those of G <= GMAX_D256 are built
template <int HD>
const void* kernel_hd(int dtype_code, int G, int* smem, int* smem_max) {
  if constexpr (HD >= 256) {
    switch (build_lo(G)) {
      case 1: return kernel_t<HD, 1, 1>(dtype_code, G, smem, smem_max);
      case 2: return kernel_t<HD, 2, 2>(dtype_code, G, smem, smem_max);
      default: return kernel_t<HD, 3, GMAX_D256>(dtype_code, G, smem, smem_max);
    }
  } else {
    switch (build_lo(G)) {
      case 1: return kernel_t<HD, 1, 1>(dtype_code, G, smem, smem_max);
      case 2: return kernel_t<HD, 2, 2>(dtype_code, G, smem, smem_max);
      case 3: return kernel_t<HD, 3, 4>(dtype_code, G, smem, smem_max);
      case 5: return kernel_t<HD, 5, GMID - 1>(dtype_code, G, smem, smem_max);
      case GMID: return kernel_t<HD, GMID, GMID>(dtype_code, G, smem, smem_max);
      case GMID + 1: return kernel_t<HD, GMID + 1, GMAX - 1>(dtype_code, G, smem, smem_max);
      default: return kernel_t<HD, GMAX, GMAX>(dtype_code, G, smem, smem_max);
    }
  }
}

// nullptr for a shape this source does not take (ops/decode_attention.py
// _check_kernel_shape states the rule: G = 1..16 at every head dim but 256,
// 1..4 there, each head dim in its own source)
inline const void* kernel_of(int dtype_code, int G, int hd, int* smem, int* smem_max) {
  const bool hd_ok = PAD ? hd % 4 == 0 && hd >= HD_MIN && hd <= DECODE_ATTN_HD : hd == DECODE_ATTN_HD;
  if (G < 1 || G > (DECODE_ATTN_HD >= 256 ? GMAX_D256 : GMAX) || !hd_ok) return nullptr;
  return kernel_hd<DECODE_ATTN_HD>(dtype_code, G, smem, smem_max);
}

// blocks the card holds of `kern` at once with `smem` bytes a block (all of
// them resident: the cooperative launch's ceiling), cached per device,
// kernel and size. The kernel's dynamic shared memory limit is set to the
// most any G takes, so every launch of it fits.
inline int resident_blocks(const void* kern, int smem, int smem_max, int* grid) {
  struct Entry { const void* kern; int dev, smem, grid; };
  static Entry cache[128];
  static int n = 0;
  int dev = 0;
  if (int e = (int)cudaGetDevice(&dev)) return e;
  for (int k = 0; k < n; ++k)
    if (cache[k].kern == kern && cache[k].dev == dev && cache[k].smem == smem) {
      *grid = cache[k].grid;
      return 0;
    }
  int sms = 0, occ = 0;
  cudaError_t e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_max);
  if (e == cudaSuccess) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kern, NT, smem);
  if (e != cudaSuccess) return (int)e;
  if (occ < 1) return (int)cudaErrorLaunchOutOfResources;
  *grid = sms * occ;
  if (n < 128) cache[n++] = Entry{kern, dev, smem, *grid};
  return 0;
}

// One launch: the grid is the resident blocks, at most one per item the
// lengths could give (b * kvh * NC).
inline int launch(Args a, void* scratch, int hd, int dtype_code, cudaStream_t st) {
  int smem = 0, smem_max = 0;
  const void* kern = kernel_of(dtype_code, a.G, hd, &smem, &smem_max);
  if (!kern || a.b < 1 || a.b > BMAX || a.CH < 8 || a.CH > CHMAX || a.BK % a.CH) return (int)cudaErrorInvalidValue;
  carve(a, scratch, a.kvh * a.G, hd);
  int grid = 0;
  if (int e = resident_blocks(kern, smem, smem_max, &grid)) return e;
  const long long most = (long long)a.b * a.kvh * a.NC;
  grid = (int)(most < grid ? (most > 0 ? most : 1) : grid);
  void* args[] = {&a};
  cudaError_t e = cudaLaunchCooperativeKernel(kern, dim3(grid), dim3(NT), args, (size_t)smem, st);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// What the compiler gave a variant: {registers a thread, static shared
// bytes, dynamic shared bytes, local (spill) bytes a thread, threads a
// block, blocks an SM can hold}, the last two at G query heads a kv head.
// Launches nothing.
inline int attributes(int* out, int dtype_code, int G, int hd) {
  int smem = 0, smem_max = 0;
  const void* kern = kernel_of(dtype_code, G, hd, &smem, &smem_max);
  if (!kern) return (int)cudaErrorInvalidValue;
  if (int e = (int)cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_max))
    return e;
  cudaFuncAttributes fa;
  if (int e = (int)cudaFuncGetAttributes(&fa, kern)) return e;
  int per_sm = 0;
  if (int e = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, NT, smem)) return e;
  out[0] = fa.numRegs;
  out[1] = (int)fa.sharedSizeBytes;
  out[2] = smem;
  out[3] = (int)fa.localSizeBytes;
  out[4] = NT;
  out[5] = per_sm;
  return 0;
}

// The arguments every entry point takes, in its order.
#define DECODE_ATTN_PARAMS                                                                      \
  const void *q, const void *kq, const void *ks, const void *vq, const void *vs,               \
      const void *lens, const void *tables, const void *kcos, const void *ksin,                 \
      const void *knew, const void *kinv, const void *vnew, const void *vinv,                   \
      const void *active, const void *qcos, const void *qsin, void *out, void *scratch, int b, \
      int kvh, int G, int hd, int S, int CH, int BK, int NC, int TS, int packed, int rope,      \
      int fold, int dtype_code, float scale, void *stream

// ... and their names, to forward them
#define DECODE_ATTN_ARGS                                                                     \
  q, kq, ks, vq, vs, lens, tables, kcos, ksin, knew, kinv, vnew, vinv, active, qcos, qsin, out, \
      scratch, b, kvh, G, hd, S, CH, BK, NC, TS, packed, rope, fold, dtype_code, scale, stream

inline int run(DECODE_ATTN_PARAMS) {
  Args a{};
  a.q = q;
  a.kq = static_cast<const uint8_t*>(kq);
  a.ks = static_cast<const float*>(ks);
  a.vq = static_cast<const uint8_t*>(vq);
  a.vs = static_cast<const float*>(vs);
  a.lens = static_cast<const int*>(lens);
  a.tables = static_cast<const int*>(tables);
  a.kcos = static_cast<const float*>(kcos);
  a.ksin = static_cast<const float*>(ksin);
  a.knew = knew;
  a.kinv = static_cast<const float*>(kinv);
  a.vnew = vnew;
  a.vinv = static_cast<const float*>(vinv);
  a.active = static_cast<const int*>(active);
  a.qcos = static_cast<const float*>(qcos);
  a.qsin = static_cast<const float*>(qsin);
  a.out = out;
  a.b = b;
  a.kvh = kvh;
  a.G = G;
  a.hd = hd;
  a.S = S;
  a.CH = CH;
  a.BK = BK;
  a.NC = NC;
  a.TS = TS;
  a.packed = packed;
  a.rope = rope;
  a.fold = fold;
  a.scale = scale;
  return launch(a, scratch, hd, dtype_code, static_cast<cudaStream_t>(stream));
}

}  // namespace decode_attn

// ---------------------------------------------------------------------------
// entry points (the same in every source; decode_attention.cu says what each replaces)
// ---------------------------------------------------------------------------

// tables null, NC = S / CH chunks, TS = S. dtype_code: 0 = f32 q/out, 1 = bf16.
extern "C" int decode_attention(DECODE_ATTN_PARAMS) { return decode_attn::run(DECODE_ATTN_ARGS); }

// S = CH = BK = P, NC = max_pages, TS = max_pages * P. The pool's page count
// is not an argument: the tables index the pool.
extern "C" int paged_attention(DECODE_ATTN_PARAMS) { return decode_attn::run(DECODE_ATTN_ARGS); }

// Layer `layer` of the stacked int8 cache kq_all/vq_all [L, b, kvh, hd, S]
// and scales ks_all/vs_all [L, b, S]: only the base pointers move, nothing
// is copied. k_new/v_new [b, kvh, hd] in q's type (fake-quantized, K
// rotated), include_new [b] int32: the pair's p rounds to q's type before
// p.v and is not zeroed for an excluded pair, as in the TPU kernel.
extern "C" int decode_attention_stacked(const void* q, const void* kq_all, const void* ks_all,
                                        const void* vq_all, const void* vs_all,
                                        const void* lens, const void* kcos, const void* ksin,
                                        const void* k_new, const void* v_new,
                                        const void* include_new, void* out, void* scratch,
                                        int b, int kvh, int G, int hd, int S, int CH, int BK,
                                        int layer, int rope, int dtype_code, float scale,
                                        void* stream) {
  const size_t q_off = (size_t)layer * b * kvh * hd * S, s_off = (size_t)layer * b * S;
  return decode_attn::run(q, static_cast<const uint8_t*>(kq_all) + q_off,
                          static_cast<const float*>(ks_all) + s_off,
                          static_cast<const uint8_t*>(vq_all) + q_off,
                          static_cast<const float*>(vs_all) + s_off, lens, nullptr, kcos, ksin,
                          k_new, nullptr, v_new, nullptr, include_new, nullptr, nullptr, out,
                          scratch, b, kvh, G, hd, S, CH, BK, S / CH, S, 0, rope, 2, dtype_code,
                          scale, stream);
}

// {registers, static shared bytes, dynamic shared bytes, spill bytes,
// threads a block, blocks an SM holds} of the kernel a launch at
// (dtype_code, G, hd) takes.
extern "C" int decode_attention_attributes(int* out, int dtype_code, int G, int hd) {
  return decode_attn::attributes(out, dtype_code, G, hd);
}

#ifdef DECODE_ATTN_TRACE
// the last launch's stamps (decode_attn.cuh, DECODE_ATTN_TRACE): host [8][4096]
extern "C" int decode_attention_read_trace(unsigned long long* host) { return decode_attn::read_trace(host); }
#endif
