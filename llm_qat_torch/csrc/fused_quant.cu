// Producer-fused activation quantization, for Hopper (sm_90a): K12 and K13.
//
// rmsnorm_quant replaces llm_qat_tpu/ops/pallas/fused_quant.py:
// _rmsnorm_quant_kernel (rmsnorm_quant): the mean of squares in fp32,
// rsqrt(var + eps), the product rounded to h's type, times the gain, rounded
// to the promoted type of h and the gain; then per-row symmetric
// quantization: s = qmax / (absmax + 1e-6), q = round_half_even(x * s) as
// int8, s as f32.
//
// silu_mul_quant replaces _silu_mul_quant_kernel (silu_mul_quant): sigmoid in
// fp32 rounded to gate's type, gate * sig and then * up each rounded to that
// type, then the same per-row quantization.
//
// Bound on this card: bytes. Each reads its input once (2 or 4 bytes an
// element; two inputs for silu_mul_quant) and writes one byte an element and
// a scale a row, with a few operations an element. What keeps such a pass
// from the memory's rate is too few bytes in flight and phases in which a
// block has none, so:
//  * A row lives in registers. A group of `wpr` warps takes a row; each
//    thread holds V chunks of 8 consecutive elements (one 16-byte piece in
//    bf16, two in f32), chunk c = t + i * 32 wpr, in the input type, widened
//    where used; V, a power of two, is a template parameter, at most
//    IN_WORDS words a thread. The host picks (V, wpr) from K
//    (ops/fused_quant.py:plan). A block holds up to MAX_GROUPS row groups.
//  * rmsnorm_quant's row groups walk the rows (row, row + step, ...; the grid
//    is what the SMs hold at once) and keep the next row in flight while
//    they reduce the current one: each thread copies its 16-byte pieces of
//    the next row by cp.async into its own slots of a ring of two
//    shared-memory stages and reads the current row's back into registers.
//    silu_mul_quant, with twice the bytes and a sigmoid an element, takes
//    one row a group, every load of it issued before any arithmetic, over a
//    grid of all the rows.
//  * The row's reductions are warp shuffles; a row of several warps then
//    exchanges one value a warp through shared memory behind its own named
//    barrier (bar.sync 1 + group, 32 wpr threads): no row waits on another.
//  * A chunk's 8 integers leave in one 8-byte store; one thread writes the
//    scale. The gain (8-16 KB, L1/L2-resident) is read per chunk through the
//    read-only path in its own type: a bf16 gain multiplies packed pairs, an
//    f32 gain's products stay in registers until they are quantized.
//  * Rows the register kernels cannot hold (rmsnorm_quant's with an f32 gain
//    or f32 h over 16384 elements, or bf16 whose ring would not fit over
//    55296; silu_mul_quant's over 32768 in bf16 and 16384 in f32; no model's
//    row), and rows whose K is not a multiple of 8 or whose tensors are not
//    16-byte aligned, take the staged kernels: one row a block, the row in
//    dynamic shared memory as fp32 (at most STAGED_ROW values), an element a
//    thread at a time.
//
// Numerics: the plain PyTorch versions' (ops/fused_quant.py). Each square
// rounds to fp32 and the squares are summed in fp32, in this kernel's order
// (the one rounding the plain version takes elsewhere: scales agree to the
// last bits, an integer may be 1 apart); the mean is __fmul_rn(ss, 1/K), then
// __fadd_rn(., eps), then rsqrtf (what torch's CUDA rsqrt calls). The
// sigmoid is 1 / (1 + expf(-g)) as ATen's: the correctly rounded reciprocal
// (__frcp_rn) is the correctly rounded quotient, so silu_mul_quant is
// bit-equal to its plain version. The scale is one IEEE division. x * s
// rounds half to even through the addition of 1.5 * 2^23, which leaves the
// integer in the low byte of the sum (|x * s| <= qmax < 2^22): rintf's
// rounding. A product of two bf16 values is exact in fp32, so mul.rn.bf16x2
// rounds it where the plain version's bf16 product does.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

typedef __nv_bfloat16 bf16;

// ops/fused_quant.py mirrors these (fused_quant_limits reports them)
constexpr int MAX_THREADS = 1024;        // _MAX_WARPS warps
constexpr int MAX_GROUPS = 8;            // row groups a block: named barriers 1..8
constexpr int IN_WORDS = 32;             // _IN_WORDS: 32-bit words a thread holds for its chunks
constexpr int STAGED_ROW = 56 * 1024;    // _MAX_ROW: fp32 values of a staged kernel's row
constexpr float ROUNDER = 12582912.0f;   // 1.5 * 2^23

// 32-bit words of a chunk of 8 elements
template <typename T> struct Words { static constexpr int n = 2 * (int)sizeof(T); };

__device__ __forceinline__ float lo_f(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float hi_f(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}
__device__ __forceinline__ uint32_t mul_bf16x2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("mul.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}
__device__ __forceinline__ uint32_t max_bf16x2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("max.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

// element e of a chunk held as 32-bit words
template <typename T> __device__ __forceinline__ float elt(const uint32_t* w, int e);
template <> __device__ __forceinline__ float elt<bf16>(const uint32_t* w, int e) {
  return (e & 1) ? hi_f(w[e >> 1]) : lo_f(w[e >> 1]);
}
template <> __device__ __forceinline__ float elt<float>(const uint32_t* w, int e) {
  return __uint_as_float(w[e]);
}

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ float round_to(float v);
template <> __device__ __forceinline__ float round_to<float>(float v) { return v; }
template <> __device__ __forceinline__ float round_to<bf16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float sigmoid(float v) {
  return __frcp_rn(__fadd_rn(1.0f, expf(-v)));
}

template <typename T>
__device__ __forceinline__ void load_chunk(uint32_t* w, const T* p) {
  const uint4* q = reinterpret_cast<const uint4*>(p);
#pragma unroll
  for (int j = 0; j < Words<T>::n / 4; ++j) {
    const uint4 u = __ldg(q + j);
    w[4 * j] = u.x;
    w[4 * j + 1] = u.y;
    w[4 * j + 2] = u.z;
    w[4 * j + 3] = u.w;
  }
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(a), "l"(gmem) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all_but_newest() {
  asm volatile("cp.async.wait_group 1;" ::: "memory");
}

// A thread's V chunks of a row, as 16-byte pieces, through its slots of a
// stage: piece j at slot[j * blockDim.x] (neighbouring threads, neighbouring
// 16 bytes). fetch starts the copies, unstage reads them back once landed.
template <typename T, int V>
__device__ __forceinline__ void fetch(uint4* slot, const T* src, int t, int tpr, int nch) {
  constexpr int Q = Words<T>::n / 4;
#pragma unroll
  for (int i = 0; i < V; ++i)
    if (t + i * tpr < nch) {
#pragma unroll
      for (int q = 0; q < Q; ++q)
        cp_async16(slot + (i * Q + q) * blockDim.x, src + 8 * (t + i * tpr) + 4 * q);
    }
}

template <typename T, int V>
__device__ __forceinline__ void unstage(uint32_t (&x)[V][Words<T>::n], const uint4* slot, int t,
                                        int tpr, int nch) {
  constexpr int Q = Words<T>::n / 4;
#pragma unroll
  for (int i = 0; i < V; ++i)
    if (t + i * tpr < nch) {
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        const uint4 u = slot[(i * Q + q) * blockDim.x];
        x[i][4 * q] = u.x;
        x[i][4 * q + 1] = u.y;
        x[i][4 * q + 2] = u.z;
        x[i][4 * q + 3] = u.w;
      }
    }
}

// rint(x * s) as int8 in the low byte
__device__ __forceinline__ uint32_t qbyte(float x, float s) {
  return __float_as_uint(__fadd_rn(__fmul_rn(x, s), ROUNDER));
}
__device__ __forceinline__ uint32_t quant4(float a, float b, float c, float d, float s) {
  return __byte_perm(__byte_perm(qbyte(a, s), qbyte(b, s), 0x0040),
                     __byte_perm(qbyte(c, s), qbyte(d, s), 0x0040), 0x5410);
}
__device__ __forceinline__ void store_chunk(int8_t* p, const float* y, float s) {
  *reinterpret_cast<uint2*>(p) = make_uint2(quant4(y[0], y[1], y[2], y[3], s),
                                            quant4(y[4], y[5], y[6], y[7], s));
}

// Sum (MAX = false) or maximum (MAX = true) over the row. The warp's
// shuffles leave every lane the same value (each step adds two equal sets,
// in either order); a row of wpr > 1 warps then puts one value a warp into
// `slots` behind the row group's named barrier `bar` (32 wpr threads), and
// every thread combines them in one order.
template <bool MAX, typename F>
__device__ __forceinline__ F row_reduce(F v, F* slots, int wpr, int warp, int bar) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const F o = __shfl_xor_sync(0xffffffffu, v, off);
    if constexpr (MAX) v = fmaxf(v, o); else v = v + o;
  }
  if (wpr == 1) return v;
  if ((threadIdx.x & 31) == 0) slots[warp] = v;
  asm volatile("bar.sync %0, %1;" ::"r"(bar), "r"(32 * wpr) : "memory");
  F r = slots[0];
  for (int w = 1; w < wpr; ++w) {
    if constexpr (MAX) r = fmaxf(r, slots[w]); else r = r + slots[w];
  }
  return r;
}

__device__ __forceinline__ float rms_factor(float ss, float inv_k, float eps) {
  return rsqrtf(__fadd_rn(__fmul_rn(ss, inv_k), eps));
}

__device__ __forceinline__ float row_scale(float am, float qmax) {
  return __fdiv_rn(qmax, __fadd_rn(am, 1e-6f));
}

// ---------------------------------------------------------------------------
// register kernels: a row group of wpr warps a row, V chunks a thread
// ---------------------------------------------------------------------------

template <typename T, int V>
__device__ __forceinline__ void load_row(uint32_t (&x)[V][Words<T>::n], const T* src, int t,
                                         int tpr, int nch) {
#pragma unroll
  for (int i = 0; i < V; ++i)
    if (t + i * tpr < nch) load_chunk<T>(x[i], src + 8 * (t + i * tpr));
}

// Where a thread of a row group stands, and its group's exchange slots.
struct Group {
  int t, tpr, nch, wpr, warp, bar;
  float* sum_slots;                        // the two reductions' own slots: a
  float* max_slots;                        // row never overwrites one still read
};

// One row of rmsnorm_quant from the thread's chunks x. G: the gain's type.
// A bf16 gain with a bf16 h gives a bf16 product (the promoted type); an f32
// gain an f32 one (the host hands an f32 h an f32 gain).
template <typename T, typename G, int V>
__device__ __forceinline__ void rmsnorm_row(uint32_t (&x)[V][Words<T>::n], const G* g,
                                            int8_t* q_row, float* s_out, const Group& gr,
                                            float eps, float qmax, float inv_k) {
  constexpr bool OUT_BF16 = sizeof(G) == 2;
  static_assert(!OUT_BF16 || sizeof(T) == 2, "a bf16 gain goes with a bf16 h");
  const int t = gr.t, tpr = gr.tpr, nch = gr.nch;
  float ss = 0.f;                          // the squares, each rounded to fp32
#pragma unroll
  for (int i = 0; i < V; ++i)
    if (t + i * tpr < nch) {
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float v = elt<T>(x[i], e);
        ss = __fadd_rn(ss, __fmul_rn(v, v));
      }
    }
  ss = row_reduce<false>(ss, gr.sum_slots, gr.wpr, gr.warp, gr.bar);
  const float r = rms_factor(ss, inv_k, eps);

  // xn = round_T(x r), then y = xn g: kept packed in x for a bf16 gain, as
  // fp32 in y for an f32 one
  float am = 0.f, y[V][8];
  uint32_t am2 = 0u;                       // bf16 product: the pairs' maxima of |y|
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const int c = t + i * tpr;
    if (c < nch) {
      uint32_t gw[Words<G>::n];
      load_chunk<G>(gw, g + 8 * c);
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        float a = __fmul_rn(elt<T>(x[i], 2 * p), r), b = __fmul_rn(elt<T>(x[i], 2 * p + 1), r);
        if constexpr (OUT_BF16) {
          const uint32_t yp = mul_bf16x2(pack_bf16(a, b), gw[p]);
          x[i][p] = yp;
          am2 = max_bf16x2(am2, yp & 0x7fff7fffu);
        } else {
          if constexpr (sizeof(T) == 2) {
            const uint32_t xn = pack_bf16(a, b);
            a = lo_f(xn);
            b = hi_f(xn);
          }
          y[i][2 * p] = __fmul_rn(a, elt<float>(gw, 2 * p));
          y[i][2 * p + 1] = __fmul_rn(b, elt<float>(gw, 2 * p + 1));
          am = fmaxf(am, fmaxf(fabsf(y[i][2 * p]), fabsf(y[i][2 * p + 1])));
        }
      }
    }
  }
  if constexpr (OUT_BF16) am = fmaxf(lo_f(am2), hi_f(am2));
  am = row_reduce<true>(am, gr.max_slots, gr.wpr, gr.warp, gr.bar);
  const float s = row_scale(am, qmax);

#pragma unroll
  for (int i = 0; i < V; ++i) {
    const int c = t + i * tpr;
    if (c < nch) {
      if constexpr (OUT_BF16) {
#pragma unroll
        for (int e = 0; e < 8; ++e) y[i][e] = elt<bf16>(x[i], e);
      }
      store_chunk(q_row + 8 * c, y[i], s);
    }
  }
  if (t == 0) *s_out = s;
}

// One row of silu_mul_quant from the thread's chunks of gate (xg) and up (xu).
template <typename T, int V>
__device__ __forceinline__ void silu_row(uint32_t (&xg)[V][Words<T>::n],
                                         const uint32_t (&xu)[V][Words<T>::n], int8_t* q_row,
                                         float* s_out, const Group& gr, float qmax) {
  const int t = gr.t, tpr = gr.tpr, nch = gr.nch;
  // y = round_T(round_T(g sig) u), kept in xg in T
  float am = 0.f;
  uint32_t am2 = 0u;
#pragma unroll
  for (int i = 0; i < V; ++i)
    if (t + i * tpr < nch) {
      if constexpr (sizeof(T) == 2) {
#pragma unroll
        for (int p = 0; p < 4; ++p) {
          const uint32_t sig = pack_bf16(sigmoid(lo_f(xg[i][p])), sigmoid(hi_f(xg[i][p])));
          const uint32_t y = mul_bf16x2(mul_bf16x2(xg[i][p], sig), xu[i][p]);
          xg[i][p] = y;
          am2 = max_bf16x2(am2, y & 0x7fff7fffu);
        }
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const float gv = __uint_as_float(xg[i][e]);
          const float y = __fmul_rn(__fmul_rn(gv, sigmoid(gv)), __uint_as_float(xu[i][e]));
          xg[i][e] = __float_as_uint(y);
          am = fmaxf(am, fabsf(y));
        }
      }
    }
  if constexpr (sizeof(T) == 2) am = fmaxf(lo_f(am2), hi_f(am2));
  am = row_reduce<true>(am, gr.max_slots, gr.wpr, gr.warp, gr.bar);
  const float s = row_scale(am, qmax);
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const int c = t + i * tpr;
    if (c < nch) {
      float y[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) y[e] = elt<T>(xg[i], e);
      store_chunk(q_row + 8 * c, y, s);
    }
  }
  if (t == 0) *s_out = s;
}

// Words a thread holds for a chunk of rmsnorm_quant: its input, and with an
// f32 gain its 8 products xn g as fp32.
template <typename T, typename G>
struct RmsWords { static constexpr int n = Words<T>::n + (sizeof(G) == 2 ? 0 : 8); };

// rmsnorm_quant: every row group walks rows row, row + step, ... and fetches
// the next while it reduces the current one, through a ring of two
// shared-memory stages. Its launch bounds ask for one block an SM at least:
// without, ptxas held some variants to 32 registers and spilled.
template <typename T, typename G, int V>
__global__ void __launch_bounds__(MAX_THREADS, 1)
rmsnorm_quant_regs(const T* __restrict__ h, const G* __restrict__ g, int8_t* __restrict__ xq,
                   float* __restrict__ sx, int M, int K, int wpr, float eps, float qmax,
                   float inv_k) {
  constexpr int W = Words<T>::n, SLOTS = V * W / 4;
  extern __shared__ uint4 fq_stage[];      // two stages of SLOTS pieces a thread
  __shared__ float sum_slots[MAX_GROUPS][32];
  __shared__ float max_slots[MAX_GROUPS][32];
  const int tpr = 32 * wpr, groups = blockDim.x / tpr, grp = threadIdx.x / tpr;
  const int t = threadIdx.x - grp * tpr;
  const Group gr{t, tpr, K >> 3, wpr, t >> 5, grp + 1, sum_slots[grp], max_slots[grp]};
  const int step = gridDim.x * groups;
  int row = blockIdx.x * groups + grp;
  if (row >= M) return;
  uint4* const slots = fq_stage + threadIdx.x;
  const int stage_at = SLOTS * blockDim.x;
  fetch<T, V>(slots, h + (size_t)row * K, t, tpr, gr.nch);
  cp_async_commit();
  for (int rd = 0; row < M; row += step, rd ^= 1) {
    // the next row, into the stage this thread read a row ago
    if (row + step < M)
      fetch<T, V>(slots + (rd ^ 1) * stage_at, h + (size_t)(row + step) * K, t, tpr, gr.nch);
    cp_async_commit();
    cp_async_wait_all_but_newest();
    uint32_t x[V][W];
    unstage<T, V>(x, slots + rd * stage_at, t, tpr, gr.nch);
    rmsnorm_row<T, G, V>(x, g, xq + (size_t)row * K, sx + row, gr, eps, qmax, inv_k);
  }
}

// silu_mul_quant: a row group takes one row, loaded straight into registers;
// the grid covers the rows.
template <typename T, int V>
__global__ void __launch_bounds__(MAX_THREADS)
silu_mul_quant_regs(const T* __restrict__ gate, const T* __restrict__ up, int8_t* __restrict__ yq,
                    float* __restrict__ sy, int M, int K, int wpr, float qmax) {
  constexpr int W = Words<T>::n;
  __shared__ float max_slots[MAX_GROUPS][32];
  const int tpr = 32 * wpr, grp = threadIdx.x / tpr, t = threadIdx.x - grp * tpr;
  const int row = blockIdx.x * (blockDim.x / tpr) + grp;
  if (row >= M) return;
  const Group gr{t, tpr, K >> 3, wpr, t >> 5, grp + 1, nullptr, max_slots[grp]};
  uint32_t xg[V][W], xu[V][W];
  load_row<T, V>(xg, gate + (size_t)row * K, t, tpr, gr.nch);
  load_row<T, V>(xu, up + (size_t)row * K, t, tpr, gr.nch);
  silu_row<T, V>(xg, xu, yq + (size_t)row * K, sy + row, gr, qmax);
}

// ---------------------------------------------------------------------------
// staged kernels: one row a block, the row as fp32 in shared memory, an
// element a thread at a time (any K, any alignment)
// ---------------------------------------------------------------------------

template <typename T, typename G>
__global__ void __launch_bounds__(MAX_THREADS, 1)
rmsnorm_quant_staged(const T* __restrict__ h, const G* __restrict__ g,
                     int8_t* __restrict__ xq, float* __restrict__ sx, int K, float eps,
                     float qmax, float inv_k) {
  extern __shared__ float fq_row[];        // the row, K values
  __shared__ float sum_slots[32];
  __shared__ float max_slots[32];
  const int wpr = blockDim.x >> 5, warp = threadIdx.x >> 5;
  const size_t base = (size_t)blockIdx.x * K;
  float ss = 0.f;
  for (int u = threadIdx.x; u < K; u += blockDim.x) {
    const float v = to_f(h[base + u]);
    ss = __fadd_rn(ss, __fmul_rn(v, v));
    fq_row[u] = v;
  }
  ss = row_reduce<false>(ss, sum_slots, wpr, warp, 1);
  const float r = rms_factor(ss, inv_k, eps);
  float am = 0.f;
  for (int u = threadIdx.x; u < K; u += blockDim.x) {
    float y = __fmul_rn(round_to<T>(__fmul_rn(fq_row[u], r)), to_f(g[u]));
    if constexpr (sizeof(G) == 2) y = round_to<bf16>(y);   // the promoted type
    fq_row[u] = y;
    am = fmaxf(am, fabsf(y));
  }
  am = row_reduce<true>(am, max_slots, wpr, warp, 1);
  const float s = row_scale(am, qmax);
  for (int u = threadIdx.x; u < K; u += blockDim.x)
    xq[base + u] = (int8_t)(qbyte(fq_row[u], s) & 0xffu);
  if (threadIdx.x == 0) sx[blockIdx.x] = s;
}

template <typename T>
__global__ void __launch_bounds__(MAX_THREADS, 1)
silu_mul_quant_staged(const T* __restrict__ gate, const T* __restrict__ up,
                      int8_t* __restrict__ yq, float* __restrict__ sy, int K, float qmax) {
  extern __shared__ float fq_row[];
  __shared__ float max_slots[32];
  const int wpr = blockDim.x >> 5, warp = threadIdx.x >> 5;
  const size_t base = (size_t)blockIdx.x * K;
  float am = 0.f;
  for (int u = threadIdx.x; u < K; u += blockDim.x) {
    const float gv = to_f(gate[base + u]);
    const float sig = round_to<T>(sigmoid(gv));
    const float y = round_to<T>(__fmul_rn(round_to<T>(__fmul_rn(gv, sig)), to_f(up[base + u])));
    fq_row[u] = y;
    am = fmaxf(am, fabsf(y));
  }
  am = row_reduce<true>(am, max_slots, wpr, warp, 1);
  const float s = row_scale(am, qmax);
  for (int u = threadIdx.x; u < K; u += blockDim.x)
    yq[base + u] = (int8_t)(qbyte(fq_row[u], s) & 0xffu);
  if (threadIdx.x == 0) sy[blockIdx.x] = s;
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

// f(std::integral_constant<int, v>) for v a power of two up to VMAX
template <int VMAX, typename F>
void with_v(int v, F&& f) {
  if (v == VMAX) f(std::integral_constant<int, VMAX>());
  else if constexpr (VMAX > 1) with_v<VMAX / 2>(v, f);
}

// the dynamic shared memory a launch asks for (with the static, the default
// 48 KB can be too little even below 48 KB)
template <typename Kern>
int allow_smem(Kern kern, size_t smem) {
  return (int)cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

bool plan_ok(int v, int vmax, int wpr, int rows) {
  if (v > 0) return v <= vmax && (v & (v - 1)) == 0 && wpr >= 1 && rows >= 1 &&
                    rows <= MAX_GROUPS && rows * wpr * 32 <= MAX_THREADS;
  return v == -1 && wpr >= 1 && wpr * 32 <= MAX_THREADS;
}

int sm_count(int* sms) {
  static int n = 0;
  if (!n) {
    int dev = 0;
    if (int e = (int)cudaGetDevice(&dev)) return e;
    if (int e = (int)cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev)) return e;
  }
  *sms = n;
  return 0;
}

// the largest power of two at most IN_WORDS / words
constexpr int vmax_of(int words) {
  return IN_WORDS / words >= 8 ? 8 : IN_WORDS / words >= 4 ? 4 : IN_WORDS / words >= 2 ? 2 : 1;
}

template <typename T, typename G>
int rmsnorm_launch(const void* h, const void* g, void* xq, void* sx, int M, int K, int v,
                   int wpr, int rows, float eps, float qmax, float inv_k, cudaStream_t st) {
  constexpr int VMAX = vmax_of(RmsWords<T, G>::n);
  if (!plan_ok(v, VMAX, wpr, rows) || (v > 0 && K % 8) || K > STAGED_ROW)
    return (int)cudaErrorInvalidValue;
  const T* hp = static_cast<const T*>(h);
  const G* gp = static_cast<const G*>(g);
  int8_t* qp = static_cast<int8_t*>(xq);
  float* sp = static_cast<float*>(sx);
  int e = 0;
  if (v > 0) {
    // as many blocks as the SMs hold at once; the row groups walk the rows
    const int block = rows * wpr * 32;
    const size_t smem = (size_t)2 * v * Words<T>::n * 4 * block;
    int sms = 0;
    if ((e = sm_count(&sms))) return e;
    with_v<VMAX>(v, [&](auto vc) {
      auto kern = rmsnorm_quant_regs<T, G, decltype(vc)::value>;
      int per_sm = 0;
      if ((e = allow_smem(kern, smem))) return;
      if ((e = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, block, smem)))
        return;
      const int need = (M + rows - 1) / rows;
      const int grid = per_sm > 0 && per_sm * sms < need ? per_sm * sms : need;
      kern<<<grid, block, smem, st>>>(hp, gp, qp, sp, M, K, wpr, eps, qmax, inv_k);
    });
  } else {
    const size_t smem = (size_t)K * sizeof(float);
    auto kern = rmsnorm_quant_staged<T, G>;
    e = allow_smem(kern, smem);
    if (!e) kern<<<M, wpr * 32, smem, st>>>(hp, gp, qp, sp, K, eps, qmax, inv_k);
  }
  return e ? e : (int)cudaGetLastError();
}

template <typename T>
int silu_launch(const void* gate, const void* up, void* yq, void* sy, int M, int K, int v,
                int wpr, int rows, float qmax, cudaStream_t st) {
  constexpr int VMAX = vmax_of(2 * Words<T>::n);
  if (!plan_ok(v, VMAX, wpr, rows) || (v > 0 && K % 8) || K > STAGED_ROW)
    return (int)cudaErrorInvalidValue;
  const T* gp = static_cast<const T*>(gate);
  const T* up_ = static_cast<const T*>(up);
  int8_t* qp = static_cast<int8_t*>(yq);
  float* sp = static_cast<float*>(sy);
  int e = 0;
  if (v > 0) {
    with_v<VMAX>(v, [&](auto vc) {
      silu_mul_quant_regs<T, decltype(vc)::value><<<(M + rows - 1) / rows, rows * wpr * 32, 0,
                                                   st>>>(gp, up_, qp, sp, M, K, wpr, qmax);
    });
  } else {
    const size_t smem = (size_t)K * sizeof(float);
    auto kern = silu_mul_quant_staged<T>;
    e = allow_smem(kern, smem);
    if (!e) kern<<<M, wpr * 32, smem, st>>>(gp, up_, qp, sp, K, qmax);
  }
  return e ? e : (int)cudaGetLastError();
}

template <typename Kern>
int attributes(Kern kern, int threads, int smem, int* out) {
  if (int e = allow_smem(kern, smem)) return e;
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

constexpr int REPORT_THREADS = 256;          // a register kernel's block in the report
constexpr int STAGED_SMEM = STAGED_ROW * 4;

template <typename T, typename G>
int rmsnorm_attributes(int v, int* out) {
  constexpr int VMAX = vmax_of(RmsWords<T, G>::n);
  if (v == -1) return attributes(rmsnorm_quant_staged<T, G>, MAX_THREADS, STAGED_SMEM, out);
  int e = (int)cudaErrorInvalidValue;
  with_v<VMAX>(v, [&](auto vc) {    // with two stages
    e = attributes(rmsnorm_quant_regs<T, G, decltype(vc)::value>, REPORT_THREADS,
                   2 * v * Words<T>::n * 4 * REPORT_THREADS, out);
  });
  return e;
}

template <typename T>
int silu_attributes(int v, int* out) {
  constexpr int VMAX = vmax_of(2 * Words<T>::n);
  if (v == -1) return attributes(silu_mul_quant_staged<T>, MAX_THREADS, STAGED_SMEM, out);
  int e = (int)cudaErrorInvalidValue;
  with_v<VMAX>(v, [&](auto vc) {
    e = attributes(silu_mul_quant_regs<T, decltype(vc)::value>, REPORT_THREADS, 0, out);
  });
  return e;
}

}  // namespace

// dtype_code: 0 = f32 h, 1 = bf16. gain_code: 0 = f32 gain, 1 = bf16 (only
// with a bf16 h: the product with the gain then rounds to bf16). The plan
// (v, wpr, rows) is ops/fused_quant.py:plan's: v >= 1 the register kernel
// with v chunks a thread, wpr warps a row and rows row groups a block; v = -1
// the staged kernel on blocks of 32 wpr threads.
extern "C" int rmsnorm_quant(const void* h, const void* g, void* xq, void* sx, int M, int K,
                             int dtype_code, int gain_code, int v, int wpr, int rows, float eps,
                             float qmax, float inv_k, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype_code == 1)
    return gain_code == 1
               ? rmsnorm_launch<bf16, bf16>(h, g, xq, sx, M, K, v, wpr, rows, eps, qmax, inv_k, st)
               : rmsnorm_launch<bf16, float>(h, g, xq, sx, M, K, v, wpr, rows, eps, qmax, inv_k, st);
  if (gain_code != 0) return (int)cudaErrorInvalidValue;
  return rmsnorm_launch<float, float>(h, g, xq, sx, M, K, v, wpr, rows, eps, qmax, inv_k, st);
}

// The plan (v, wpr, rows) as above; a row group takes one row.
extern "C" int silu_mul_quant(const void* gate, const void* up, void* yq, void* sy, int M,
                              int K, int dtype_code, int v, int wpr, int rows, float qmax,
                              void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype_code == 1) return silu_launch<bf16>(gate, up, yq, sy, M, K, v, wpr, rows, qmax, st);
  return silu_launch<float>(gate, up, yq, sy, M, K, v, wpr, rows, qmax, st);
}

// {registers, static shared bytes, dynamic shared bytes, spill bytes,
// threads a block, blocks an SM holds} of one kernel: kernel 0 =
// rmsnorm_quant (dtype_code, gain_code as there), 1 = silu_mul_quant; v as
// in the launches (the register kernels at 256 threads and their stages, the
// staged kernels at 1024 threads and a row of STAGED_ROW values). Launches
// nothing.
extern "C" int fused_quant_attributes(int* out, int kernel, int dtype_code, int gain_code,
                                      int v) {
  if (kernel == 0) {
    if (dtype_code == 1)
      return gain_code == 1 ? rmsnorm_attributes<bf16, bf16>(v, out)
                            : rmsnorm_attributes<bf16, float>(v, out);
    return rmsnorm_attributes<float, float>(v, out);
  }
  return dtype_code == 1 ? silu_attributes<bf16>(v, out) : silu_attributes<float>(v, out);
}

// {IN_WORDS, STAGED_ROW, MAX_GROUPS, MAX_THREADS}: the limits that
// ops/fused_quant.py:plan mirrors. Launches nothing.
extern "C" int fused_quant_limits(int* out) {
  out[0] = IN_WORDS;
  out[1] = STAGED_ROW;
  out[2] = MAX_GROUPS;
  out[3] = MAX_THREADS;
  return 0;
}
