// One-token attention over a quantized KV cache, split over every SM of a
// Hopper card (sm_90a): the device code of K3 and K7 (decode_attention.cu)
// and K8 (paged_attention.cu).
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
// launch of NT-thread blocks, two an SM (all resident), in three stages
// separated by grid-wide barriers (the design of the decode megakernel's
// attention, cut to one layer):
//
//   scores     item = (slot, CH cache columns, kv head), only chunks below
//              the slot's length; chunk-major, so the kv heads of a chunk
//              (an item group) run in a row and share its RoPE columns. A
//              block takes a contiguous run, inside one group while there
//              are no more groups than blocks (item_run); the next item's K
//              rows, K scales, query heads and (at head dim 64) RoPE columns
//              arrive by 16-byte cp.async while one is computed, and the
//              item's V rows go to L2 for the next stage. q.k in float64
//              (NQ threads a column), the scores and each chunk's row maxima
//              -> scratch.
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
// rescale factor. Built for (G, hd) = (8, 64) (TinyLlama-1.1B) and (1, 128)
// (the LLaMA-7B family) with f32 or bf16 q, at most BMAX slots.

#pragma once

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
constexpr int FW = 256;              // chunk statistics the finish stage stages at a time
constexpr int MINB = 2;              // blocks an SM: registers a thread at most 65536 / (2 NT)
constexpr float NEG_INF = -1e30f;

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
  int b, kvh, S, CH, BK, NC, TS, packed, rope, fold;
  float scale;
};

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
// item) at head dim 64, one at 128, where two would not leave room for two
// blocks an SM (a run stays in one chunk while there are no more item
// groups than blocks, see item_run, so it loads them once)
template <int HD>
__host__ __device__ constexpr int tab_bufs() { return HD >= 128 ? 1 : 2; }

template <int G, int HD>
struct Smem {
  union {
    struct {                                     // scores
      double red[NQ * G * CHMAX];                // part sums of q.k [NQ][G][CHMAX]
      uint8_t kbuf[2][HD * CHMAX];               // K chunk [hd(/2)][CHMAX], two in flight
      float tab[tab_bufs<HD>()][2][HD / 2 * CHMAX];   // its RoPE cos, sin [hd/2][CHMAX]
      float ksb[2][CHMAX];                       // its K inverse scales
      float qb[2][G * HD];                       // the query heads (T's bytes)
      float wmax[G][CHMAX / 32];                 // the chunk's maxima, a warp's part
      uint32_t lut4[256];                        // byte -> bf16 pair of its nibbles
      uint16_t lut8[256];                        // byte -> bf16 of the int8
    } a;
    struct {                                     // softmax.V
      uint8_t vbuf[3][HD * VSA];                 // V chunks [hd(/2)][VSA], a ring of three
      float sbuf[3][G * CHMAX];                  // their scores
      float vsb[3][CHMAX];                       // their V scales
      double spv[CHMAX * G];                     // p * vs in the compute type
      float spf[G * CHMAX];                      // p
      double redd[NT / HD * G * HD];            // p.V over each part of the columns
      float sm[G];                               // m_j
    } v;
    struct {                                     // finish
      double chp[G][FW];                         // chunk partial sums of p
      float chm[G][FW];                          //   and maxima
      float bal[G][FW];                          // each block's rescale factor
      float kf[HD], vf[HD];                      // the current token, folded
      float scur[G], fin_m[G], fin_l[G];
    } f;
  } u;
  alignas(16) double sq[G * HD];                 // the item's query heads (scores stage:
                                                 // the pairs (j, j + hd/2) side by side)
  int first[BMAX + 1];                           // items before each slot
  int lens[BMAX];                                // the slots' lengths (at most NC * CH)
  int wsum[NW];
};

// Items: per slot ceil(len / CH) chunks for each kv head; first[i] counts
// those before slot i. Every block derives the same table.
template <int G, int HD>
__device__ int prep_items(const Args& a, Smem<G, HD>* s) {
  const int t = threadIdx.x, lane = t % 32, w = t / 32;
  int x = 0;
  if (t < a.b) {
    const int len = min(max(__ldg(a.lens + t), 0), a.NC * a.CH);
    s->lens[t] = len;
    x = (len + a.CH - 1) / a.CH * a.kvh;
  }
#pragma unroll
  for (int o = 1; o < 32; o *= 2) {               // inclusive scan: warp, then block
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) s->wsum[w] = x;
  __syncthreads();
  if (w == 0) {
    int z = lane < NW ? s->wsum[lane] : 0;
#pragma unroll
    for (int o = 1; o < NW; o *= 2) {
      const int y = __shfl_up_sync(0xffffffffu, z, o);
      if (lane >= o) z += y;
    }
    if (lane < NW) s->wsum[lane] = z;
  }
  __syncthreads();
  if (w > 0) x += s->wsum[w - 1];
  if (t < a.b) s->first[t + 1] = x;
  if (t == 0) s->first[0] = 0;
  __syncthreads();
  return s->first[a.b];
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

// the (slot i, query head hq, chunk c) cell of the scratch arrays
template <int G>
__device__ __forceinline__ size_t cell(const Args& a, int i, int hq, int c) {
  return ((size_t)i * a.kvh * G + hq) * a.NC + c;
}

// The scores stage: a contiguous run of items a block (item_run). The next
// item's K rows, K scales, query heads and (for a new chunk, at head dim 64)
// RoPE columns arrive by cp.async while one is computed: q.k of each live
// column against the G query heads in float64, NQ threads a column ->
// scores; the chunk's maxima -> cmax. With a bf16 q the cached integers
// become bf16 through a table and their RoPE runs on bf16 pairs: no
// conversion instruction but one to pack (cos ks, sin ks). The item's V
// rows and scales are prefetched into L2 for the softmax.V stage.
template <typename T, int G, int HD>
__device__ void scores_stage(const Args& a, Smem<G, HD>* s, int items) {
  constexpr int H2 = HD / 2, PQ = H2 / NQ;
  const int tid = threadIdx.x, qp = tid / CHMAX, col = tid % CHMAX, lane = tid % 32;
  const int nh = a.kvh * G, hdc = a.packed ? H2 : HD, CH = a.CH;
  const bool v16 = CH % 16 == 0 && a.S % 16 == 0;  // else 8-byte pieces (CH = 8)
  const int vec = v16 ? 16 : 8, per_row = CH / vec;
  int lo, hi;
  item_run(items, a.kvh, lo, hi);
  trace_count(hi - lo);
  auto& A = s->u.a;
  {                                 // byte -> bf16 tables
    const int v = tid;
    A.lut4[v] = bf2_bits(__floats2bfloat162_rn((float)((int8_t)(v << 4) >> 4), (float)((int8_t)v >> 4)));
    A.lut8[v] = (uint16_t)(bf2_bits(__floats2bfloat162_rn((float)(int8_t)v, 0.f)) & 0xffffu);
  }
  constexpr int TB = tab_bufs<HD>();
  int tab0 = -1, tab1 = -1;         // the chunk whose RoPE columns buffer 0 / 1 holds
  auto issue_tab = [&](int c, int buf) {
    const int per_t = CH / 4;
    for (int idx = tid; idx < 2 * H2 * per_t; idx += NT) {
      const int tb = idx / (H2 * per_t), r = idx % (H2 * per_t), row = r / per_t;
      const int pc = r % per_t;
      cp_async(A.tab[buf][tb] + row * CHMAX + pc * 4,
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
      find_item(a, s->first, item, i, h, c);
      size_t kv, so;
      chunk_src(a, i, h, c, hdc, kv, so);
      for (int idx = tid; idx < hdc * per_row; idx += NT) {
        const int row = idx / per_row, pc = idx % per_row;
        cp_async(A.kbuf[buf] + row * CHMAX + pc * vec, a.kq + kv + (size_t)row * a.S + pc * vec,
                 v16);
      }
      if (tid < CH / 4) cp_async(A.ksb[buf] + tid * 4, a.ks + so + tid * 4, true);
      const char* qsrc = static_cast<const char*>(a.q) + ((size_t)i * nh + h * G) * HD * sizeof(T);
      for (int idx = tid; idx < G * HD * (int)sizeof(T) / 16; idx += NT)
        cp_async(reinterpret_cast<char*>(A.qb[buf]) + idx * 16, qsrc + idx * 16, true);
      if (TB == 2 && a.rope && (buf ? tab1 : tab0) != c) issue_tab(c, buf);
    }
    cp_async_commit();
  };
  issue(lo, 0);
  for (int item = lo, k = 0; item < hi; ++item, ++k) {
    __syncthreads();                // the previous item is done with the shared memory
    int i, h, c;
    find_item(a, s->first, item, i, h, c);
    if (TB == 1 && a.rope && tab0 != c) {   // a new chunk: its RoPE columns, not prefetched
      issue_tab(c, 0);
      cp_async_commit();
    }
    issue(item + 1, (k + 1) & 1);
    {
      size_t kv, so;
      chunk_src(a, i, h, c, hdc, kv, so);
      if (tid < hdc)
        prefetch_l2(a.vq + kv + (size_t)tid * a.S);
      else if (tid < hdc + (CH * 4 + 127) / 128)
        prefetch_l2(a.vs + so + (tid - hdc) * 32);
    }
    const int bf = k & 1;
    cp_async_wait<1>();
    __syncthreads();
    const T* qt = reinterpret_cast<const T*>(A.qb[bf]);
    for (int idx = tid; idx < G * HD; idx += NT) {
      const int g = idx / HD, d = idx % HD;
      s->sq[(g * H2 + d % H2) * 2 + d / H2] = (double)to_f(qt[idx]);
    }
    __syncthreads();
    const double2* sq2 = reinterpret_cast<const double2*>(s->sq);
    const int ncol = min(CH, s->lens[i] - c * CH);
    double acc[G];
#pragma unroll
    for (int g = 0; g < G; ++g) acc[g] = 0.0;
    if (col < ncol) {
      const float ksc = A.ksb[bf][col];
      const float st = rt<T>(ksc);
      const uint8_t* kb = A.kbuf[bf];
      const float* tc = A.tab[TB == 2 ? bf : 0][0];
      const float* ts = A.tab[TB == 2 ? bf : 0][1];
      const uint32_t st2 = bf2_bits(__floats2bfloat162_rn(st, st));
#pragma unroll 4
      for (int u = 0; u < PQ; ++u) {
        const int j = qp * PQ + u;
        float r1, r2;
        if constexpr (sizeof(T) == 2) {
          const uint32_t kk = a.packed ? A.lut4[kb[j * CHMAX + col]]
                                       : (uint32_t)A.lut8[kb[j * CHMAX + col]] |
                                             ((uint32_t)A.lut8[kb[(j + H2) * CHMAX + col]] << 16);
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
        for (int g = 0; g < G; ++g) {
          const double2 qq = sq2[g * H2 + j];
          acc[g] = fma(qq.x, d1, fma(qq.y, d2, acc[g]));
        }
      }
    }
#pragma unroll
    for (int g = 0; g < G; ++g) A.red[(qp * G + g) * CHMAX + col] = acc[g];
    __syncthreads();
    for (int idx = tid; idx < G * CHMAX; idx += NT) {   // a warp: 32 columns of one head
      const int g = idx / CHMAX, cl = idx % CHMAX;
      float v = NEG_INF;
      if (cl < ncol) {
        double t = A.red[g * CHMAX + cl];
#pragma unroll
        for (int e = 1; e < NQ; ++e) t += A.red[(e * G + g) * CHMAX + cl];
        v = __fmul_rn((float)t, a.scale);
        a.scores[cell<G>(a, i, h * G + g, c) * CH + cl] = v;
      }
      v = warp_max(v);
      if (lane == 0) A.wmax[g][cl / 32] = v;
    }
    __syncthreads();
    if (tid < G) {
      float m = A.wmax[tid][0];
#pragma unroll
      for (int e = 1; e < CHMAX / 32; ++e) m = fmaxf(m, A.wmax[tid][e]);
      a.cmax[cell<G>(a, i, h * G + tid, c)] = m;
    }
  }
  cp_async_wait<0>();
}

// The softmax.V stage's loads of item `item` of the run [.., hi) into ring
// buffer `buf`: its V rows and V scales (issue_v, which need nothing of the
// scores stage), and its scores (issue_s). The caller commits.
template <int G, int HD>
__device__ void issue_v(const Args& a, Smem<G, HD>* s, int item, int hi, int buf) {
  if (item >= hi) return;
  const int hdc = a.packed ? HD / 2 : HD, CH = a.CH, tid = threadIdx.x;
  const bool v16 = CH % 16 == 0 && a.S % 16 == 0;  // else 8-byte pieces (CH = 8)
  const int vec = v16 ? 16 : 8, per_row = CH / vec;
  int i, h, c;
  find_item(a, s->first, item, i, h, c);
  size_t kv, so;
  chunk_src(a, i, h, c, hdc, kv, so);
  for (int idx = tid; idx < hdc * per_row; idx += NT) {
    const int row = idx / per_row, pc = idx % per_row;
    cp_async(s->u.v.vbuf[buf] + row * VSA + pc * vec, a.vq + kv + (size_t)row * a.S + pc * vec,
             v16);
  }
  if (tid < CH / 4) cp_async(s->u.v.vsb[buf] + tid * 4, a.vs + so + tid * 4, true);
}

template <int G, int HD>
__device__ void issue_s(const Args& a, Smem<G, HD>* s, int item, int hi, int buf) {
  if (item >= hi) return;
  const int CH = a.CH;
  int i, h, c;
  find_item(a, s->first, item, i, h, c);
  for (int idx = threadIdx.x; idx < G * (CH / 4); idx += NT) {
    const int g = idx / (CH / 4), pc = idx % (CH / 4);
    cp_async(s->u.v.sbuf[buf] + g * CHMAX + pc * 4,
             a.scores + cell<G>(a, i, h * G + g, c) * CH + pc * 4, true);
  }
}

// Before the barrier that ends the scores stage: the V rows of the
// softmax.V stage's first two items (one commit group each).
template <int G, int HD>
__device__ void prefetch_v(const Args& a, Smem<G, HD>* s, int items) {
  int lo, hi;
  item_run(items, a.kvh, lo, hi);
  __syncthreads();                  // the scores stage is done with the shared memory
  for (int k = 0; k < 2; ++k) {
    issue_v<G, HD>(a, s, lo + k, hi, k);
    cp_async_commit();
  }
}

// The same runs as the scores stage: p against m_j, the prefix maximum of
// the chunk's BK block; float64 partial sums of p and of p.V. The V rows, V
// scales and scores of the item two ahead arrive by cp.async into a ring of
// three buffers (the first two items' V rows since prefetch_v), its first
// chunk maxima one item ahead in registers.
template <typename T, int G, int HD>
__device__ void softmax_v_stage(const Args& a, Smem<G, HD>* s, int items) {
  constexpr int H2 = HD / 2, NO = G * HD, SPT = (G * CHMAX + NT - 1) / NT;
  const int tid = threadIdx.x, lane = tid % 32;
  const int CH = a.CH, cpb = a.BK / CH;
  int lo, hi;
  item_run(items, a.kvh, lo, hi);
  auto& V = s->u.v;
  float cmr = NEG_INF;                // this warp's head's first 32 chunk maxima
  auto fetch_max = [&](int item) {
    if (item < hi && tid / 32 < G) {
      int i, h, c;
      find_item(a, s->first, item, i, h, c);
      const int ce = min((s->lens[i] + CH - 1) / CH, (c / cpb + 1) * cpb);
      cmr = lane < ce ? __ldcg(a.cmax + cell<G>(a, i, h * G + tid / 32, 0) + lane) : NEG_INF;
    }
  };
  fetch_max(lo);
  for (int k = 0; k < 2; ++k) {
    issue_s<G, HD>(a, s, lo + k, hi, k);
    cp_async_commit();
  }
  for (int item = lo, k = 0; item < hi; ++item, ++k) {
    __syncthreads();                // the previous item is done with the shared memory
    issue_v<G, HD>(a, s, item + 2, hi, (k + 2) % 3);
    issue_s<G, HD>(a, s, item + 2, hi, (k + 2) % 3);
    cp_async_commit();
    int i, h, c;
    find_item(a, s->first, item, i, h, c);
    const int bf = k % 3, len = s->lens[i], ncol = min(CH, len - c * CH);
    const int ce = min((len + CH - 1) / CH, (c / cpb + 1) * cpb);
    if (tid / 32 < G) {             // m_j: a warp a head
      const size_t c0 = cell<G>(a, i, h * G + tid / 32, 0);
      float m = cmr;
      for (int cc = lane + 32; cc < ce; cc += 32) m = fmaxf(m, __ldcg(a.cmax + c0 + cc));
      m = warp_max(m);
      if (lane == 0) V.sm[tid / 32] = m;
    }
    fetch_max(item + 1);
    cp_async_wait<2>();
    __syncthreads();
#pragma unroll
    for (int e = 0; e < SPT; ++e) {
      const int idx = tid + e * NT, g = idx / CHMAX, cl = idx % CHMAX;
      if (idx < G * CHMAX) {
        float pr = 0.f;
        double pv = 0.0;
        if (cl < ncol) {
          pr = expf(__fsub_rn(V.sbuf[bf][idx], V.sm[g]));
          pv = (double)rt<T>(__fmul_rn(pr, rt<T>(V.vsb[bf][cl])));
        }
        V.spf[g * CHMAX + cl] = pr;
        V.spv[cl * G + g] = pv;
      }
    }
    __syncthreads();
    for (int g = tid / 32; g < G; g += NW) {
      double t = 0.0;
#pragma unroll
      for (int e = 0; e < CHMAX / 32; ++e) t += (double)V.spf[g * CHMAX + lane + 32 * e];
      t = warp_sum(t);
      if (lane == 0) a.ppart[cell<G>(a, i, h * G + g, c)] = t;
    }
    // p.V: a thread takes head dim d of every head over a part of the
    // columns (each V value is widened once for the G heads), the parts
    // summed through shared memory
    {
      constexpr int NPART = NT / HD, PART = CHMAX / NPART;
      const int d = tid % HD, part = tid / HD, ncol4 = (ncol + 3) & ~3;
      const uint8_t* vrow = V.vbuf[bf] + (a.packed ? d % H2 : d) * VSA;
      const int shift = a.packed ? (d < H2 ? 28 : 24) : 24, back = a.packed ? 28 : 24;
      double acc[G];
#pragma unroll
      for (int g = 0; g < G; ++g) acc[g] = 0.0;
      for (int c4 = part * PART; c4 < min(ncol4, (part + 1) * PART); c4 += 4) {
        const uint32_t w = *reinterpret_cast<const uint32_t*>(vrow + c4);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const double v = int_to_double((int)(((w >> (8 * e)) & 0xffu) << shift) >> back);
#pragma unroll
          for (int g = 0; g < G; ++g) acc[g] = fma(V.spv[(c4 + e) * G + g], v, acc[g]);
        }
      }
#pragma unroll
      for (int g = 0; g < G; ++g) V.redd[(part * G + g) * HD + d] = acc[g];
      __syncthreads();
      for (int o = tid; o < NO; o += NT) {
        double t = V.redd[o];
#pragma unroll
        for (int e = 1; e < NPART; ++e) t += V.redd[e * NO + o];
        a.pvpart[cell<G>(a, i, h * G + o / HD, c) * HD + o % HD] = t;
      }
    }
  }
  cp_async_wait<0>();
}

// (slot i, kv head h): the fp32 recurrence over the slot's BK blocks from
// the chunks' partial sums, the current token folded in, the division.
// Every load is issued first, so that they are in flight together.
template <typename T, int G, int HD>
__device__ void finish_head(const Args& a, Smem<G, HD>* s, int i, int h) {
  constexpr int H2 = HD / 2, NO = G * HD, OPT = NO > NT ? NO / NT : 1, QPT = (NO + NT - 1) / NT;
  const int tid = threadIdx.x, lane = tid % 32, gw = tid / 32, nh = a.kvh * G, CH = a.CH;
  const int nch = (s->lens[i] + CH - 1) / CH, cpb = a.BK / CH;
  auto& F = s->u.f;
  // the query heads, the current token's pair, this warp's head's first 64
  // chunk statistics and each output's first eight partial p.V sums
  const T* qp = static_cast<const T*>(a.q) + ((size_t)i * nh + h * G) * HD;
  float qv[QPT];
#pragma unroll
  for (int u = 0; u < QPT; ++u) qv[u] = tid + u * NT < NO ? to_f(qp[tid + u * NT]) : 0.f;
  float f1 = 0.f, f2 = 0.f, f3 = 0.f, f4 = 0.f, fc = 0.f, fs = 0.f, ki = 0.f, vi = 0.f;
  const size_t pair = ((size_t)i * a.kvh + h) * HD;
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
  } else if (a.fold == 2 && tid < HD) {
    f1 = to_f(static_cast<const T*>(a.knew)[pair + tid]);
    f3 = to_f(static_cast<const T*>(a.vnew)[pair + tid]);
  }
  const size_t cg0 = cell<G>(a, i, h * G + min(gw, G - 1), 0);
  float cmr[2];
  double cpr[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int cc = lane + 32 * e;
    const bool ok = gw < G && cc < nch;
    cmr[e] = ok ? __ldcg(a.cmax + cg0 + cc) : NEG_INF;
    cpr[e] = ok ? __ldcg(a.ppart + cg0 + cc) : 0.0;
  }
  double v0[OPT][8];
#pragma unroll
  for (int u = 0; u < OPT; ++u) {
    const int o = min(tid + u * NT, NO - 1);
    const double* pv = a.pvpart + cell<G>(a, i, h * G + o / HD, 0) * HD + o % HD;
#pragma unroll
    for (int e = 0; e < 8; ++e) v0[u][e] = e < nch ? __ldcg(pv + (size_t)e * HD) : 0.0;
  }
  // into shared memory
#pragma unroll
  for (int u = 0; u < QPT; ++u)
    if (tid + u * NT < NO) s->sq[tid + u * NT] = (double)qv[u];
  if (gw < G) {
#pragma unroll
    for (int e = 0; e < 2; ++e)
      if (lane + 32 * e < nch) {
        F.chm[gw][lane + 32 * e] = cmr[e];
        F.chp[gw][lane + 32 * e] = cpr[e];
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
    F.kf[tid] = kf1;
    F.kf[tid + H2] = kf2;
    F.vf[tid] = rt<T>(__fmul_rn(f3, vt));
    F.vf[tid + H2] = rt<T>(__fmul_rn(f4, vt));
  } else if (a.fold == 2 && tid < HD) {
    F.kf[tid] = f1;
    F.vf[tid] = f3;
  }
  __syncthreads();
  // the denominator's recurrence, a warp a head: lane 0 walks the chunk
  // statistics in order (FW at a time; past the first 64 the warp loads
  // them here), the block factors -> F.bal (block FW on: a.alpha)
  if (gw < G) {
    const int g = gw;
    float m = NEG_INF, l = 0.f, mb = NEG_INF;
    double P = 0.0;
    int jb = 0, end = min(nch, cpb);  // block jb ends at chunk end
    for (int w0 = 0; w0 < nch; w0 += FW) {
      const int wn = min(FW, nch - w0);
      __syncwarp();
      for (int e = w0 ? lane : lane + 64; e < wn; e += 32) {
        F.chm[g][e] = __ldcg(a.cmax + cg0 + w0 + e);
        F.chp[g][e] = __ldcg(a.ppart + cg0 + w0 + e);
      }
      __syncwarp();
      if (lane == 0) {
        for (int e = 0; e < wn; ++e) {
          const int cc = w0 + e;
          mb = fmaxf(mb, F.chm[g][e]);
          P += F.chp[g][e];
          if (cc + 1 == end) {         // block jb is complete
            mb = fmaxf(m, mb);
            const float al = expf(__fsub_rn(m, mb));
            l = __fadd_rn(__fmul_rn(l, al), (float)P);
            if (jb < FW)
              F.bal[g][jb] = al;
            else
              a.alpha[cg0 + jb] = al;
            m = mb;
            P = 0.0;
            ++jb;
            end = min(nch, end + cpb);
          }
        }
      }
    }
    if (lane == 0) {
      F.fin_m[g] = m;
      F.fin_l[g] = l;
    }
    if (a.fold) {                     // the current token's score
      double sc = 0.0;
      for (int d = lane; d < HD; d += 32) sc = fma(s->sq[g * HD + d], (double)F.kf[d], sc);
      sc = warp_sum(sc);
      if (lane == 0) F.scur[g] = __fmul_rn((float)sc, a.scale);
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
  // eight chunks of every output of the thread a batch: their loads in flight together
  int jb = 0, end = min(nch, cpb);    // block jb ends at chunk end
  for (int b0 = 0; b0 < nch; b0 += 8) {
    if (b0 > 0) {                     // the first batch is v0, loaded first
#pragma unroll
      for (int u = 0; u < OPT; ++u) {
        const int o = tid + u * NT;
        const double* pv = a.pvpart + cell<G>(a, i, h * G + o / HD, 0) * HD + o % HD;
#pragma unroll
        for (int e = 0; e < 8; ++e) v0[u][e] = b0 + e < nch ? __ldcg(pv + (size_t)(b0 + e) * HD) : 0.0;
      }
    }
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int cc = b0 + e;
      if (cc < nch) {
#pragma unroll
        for (int u = 0; u < OPT; ++u) PV[u] += v0[u][e];
        if (cc + 1 == end) {          // block jb is complete
#pragma unroll
          for (int u = 0; u < OPT; ++u) {
            const int g = (tid + u * NT) / HD;
            const float al = jb < FW ? F.bal[g][jb] : __ldcg(a.alpha + cell<G>(a, i, h * G + g, jb));
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
    const int o = tid + u * NT, g = o / HD, d = o % HD;
    float l = F.fin_l[g], r = acc[u];
    if (a.fold) {
      const float m = F.fin_m[g], sc = inc ? F.scur[g] : NEG_INF, m_new = fmaxf(m, sc);
      const float al = expf(__fsub_rn(m, m_new));
      const float pr = a.fold == 2 || inc ? expf(__fsub_rn(sc, m_new)) : 0.f;
      l = __fadd_rn(__fmul_rn(l, al), pr);
      r = __fadd_rn(__fmul_rn(r, al), __fmul_rn(a.fold == 2 ? rt<T>(pr) : pr, F.vf[d]));
    }
    put(static_cast<T*>(a.out) + ((size_t)i * nh + h * G + g) * HD + d, r / fmaxf(l, 1e-9f));
  }
}

template <typename T, int G, int HD>
__global__ void __launch_bounds__(NT, MINB) attn_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  auto* s = reinterpret_cast<Smem<G, HD>*>(smem_raw);
  cg::grid_group grid = cg::this_grid();
  trace(0);
  const int items = prep_items(a, s);
  trace(1);
  scores_stage<T, G, HD>(a, s, items);
  trace(2);
  prefetch_v<G, HD>(a, s, items);
  grid.sync();
  trace(3);
  softmax_v_stage<T, G, HD>(a, s, items);
  trace(4);
  grid.sync();
  trace(5);
  for (int item = blockIdx.x; item < a.b * a.kvh; item += gridDim.x) {
    __syncthreads();                // the previous item is done with the shared memory
    finish_head<T, G, HD>(a, s, item / a.kvh, item % a.kvh);
  }
  trace(6);
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

template <typename T, int G, int HD>
const void* kernel_ptr() {
  return reinterpret_cast<const void*>(&attn_kernel<T, G, HD>);
}

// the kernel and its dynamic shared memory for dtype_code (0 f32, 1 bf16)
// and (G, hd); nullptr for a shape it is not built for
inline const void* kernel_of(int dtype_code, int G, int hd, int* smem) {
  if (G == 8 && hd == 64) {
    *smem = (int)sizeof(Smem<8, 64>);
    return dtype_code == 1 ? kernel_ptr<__nv_bfloat16, 8, 64>() : kernel_ptr<float, 8, 64>();
  }
  if (G == 1 && hd == 128) {
    *smem = (int)sizeof(Smem<1, 128>);
    return dtype_code == 1 ? kernel_ptr<__nv_bfloat16, 1, 128>() : kernel_ptr<float, 1, 128>();
  }
  return nullptr;
}

// blocks the card holds of `kern` at once (all of them resident: the
// cooperative launch's ceiling), cached per device and variant
inline int resident_blocks(const void* kern, int smem, int* grid) {
  struct Entry { const void* kern; int dev, grid; };
  static Entry cache[32];
  static int n = 0;
  int dev = 0;
  if (int e = (int)cudaGetDevice(&dev)) return e;
  for (int k = 0; k < n; ++k)
    if (cache[k].kern == kern && cache[k].dev == dev) {
      *grid = cache[k].grid;
      return 0;
    }
  int sms = 0, occ = 0;
  cudaError_t e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess) e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kern, NT, smem);
  if (e != cudaSuccess) return (int)e;
  if (occ < 1) return (int)cudaErrorLaunchOutOfResources;
  *grid = sms * occ;
  if (n < 32) cache[n++] = Entry{kern, dev, *grid};
  return 0;
}

// One launch: the grid is the resident blocks, at most one per item the
// lengths could give (b * kvh * NC).
inline int launch(Args a, void* scratch, int G, int hd, int dtype_code, cudaStream_t st) {
  int smem = 0;
  const void* kern = kernel_of(dtype_code, G, hd, &smem);
  if (!kern || a.b < 1 || a.b > BMAX || a.CH < 8 || a.CH > CHMAX || a.BK % a.CH) return (int)cudaErrorInvalidValue;
  carve(a, scratch, a.kvh * G, hd);
  int grid = 0;
  if (int e = resident_blocks(kern, smem, &grid)) return e;
  const long long most = (long long)a.b * a.kvh * a.NC;
  grid = (int)(most < grid ? (most > 0 ? most : 1) : grid);
  void* args[] = {&a};
  cudaError_t e = cudaLaunchCooperativeKernel(kern, dim3(grid), dim3(NT), args, (size_t)smem, st);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// What the compiler gave a variant: {registers a thread, static shared
// bytes, dynamic shared bytes, local (spill) bytes a thread, threads a
// block, blocks an SM can hold}. Launches nothing.
inline int attributes(int* out, int dtype_code, int G, int hd) {
  int smem = 0;
  const void* kern = kernel_of(dtype_code, G, hd, &smem);
  if (!kern) return (int)cudaErrorInvalidValue;
  if (int e = (int)cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem))
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
  a.S = S;
  a.CH = CH;
  a.BK = BK;
  a.NC = NC;
  a.TS = TS;
  a.packed = packed;
  a.rope = rope;
  a.fold = fold;
  a.scale = scale;
  return launch(a, scratch, G, hd, dtype_code, static_cast<cudaStream_t>(stream));
}

}  // namespace decode_attn
