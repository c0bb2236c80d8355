// Causal blockwise (flash) attention forward, for Hopper (sm_90a).
//
// Replaces llm_qat_tpu/ops/pallas/flash_attention.py:_flash_fwd_kernel
// (_flash_fwd). q [B, G, S, D] with B = batch * kv_heads and G query heads
// per kv head, k/v [B, S, D] un-repeated, lengths [B] int32. Columns
// >= max(length, 1) are masked, and columns > row when causal. Base-2
// softmax in fp32 (log2(e) folded into the score scale), walked over the TPU
// kernel's key blocks of bk columns (bk = _fit_block(1024, S), computed by
// the caller): each block's p is taken against the running maximum at the
// end of that block and l and the p.V sum are rescaled by
// alpha = exp2(m - m_new) at the block's start, as the TPU kernel does. With
// soft_bf16 the exp2 runs on bf16 operands and p is bf16. p is rounded to
// V's type before the p.V product, as the TPU kernel does; l sums the
// unrounded p.
// Returns O [B, G, S, D] in q's type and the per-row log-sum-exp in nats,
// [B, G, S] f32.
//
// Bound on this card: 2 * 2 * D operations per live (row, column) pair
// against ~4 * S * D bytes per (B, G): at the prefill and train shapes the
// bf16 tensor-core rate (989 TFLOP/s) bounds it, by 10-50x over the bytes.
//
// Head dims 16, 32, 64, 128 and 256 (Falcon3's), in bf16 and in f32 (one
// entry per head dim: flash_fwd is 64, flash_fwd_d16 / _d32 / _d128 / _d256
// the others), and every
// other hd with hd % 4 == 0 and 32 < hd <= 128 (OpenLLaMA-3B's 100, 48, 80,
// 96) through flash_fwd_dpad: the D = 128 kernels built with PAD, hd an
// argument. Global memory keeps rows of hd values (2 hd bytes, 8-byte
// aligned at hd 100, so the bf16 tiles arrive in 8-byte cp.async pieces,
// tc_bf16.cuh load_tile_hd); the shared tiles are 128 wide with the columns
// past hd zero, which add exact zeros to q.k; the 16-deep q.k chunks and
// 16-wide P.V column pairs wholly past hd are skipped, and output columns
// past hd are never written. The scale comes from the true hd.
//
// bf16: the products run on the tensor cores,
// mma.sync m16n8k16 bf16 x bf16 -> fp32, which is exactly the contract's
// "bf16 operands, fp32 sums". One block of 4 warps per (B, g, 64 query
// rows), each warp 16 rows. The Q tile arrives once by cp.async into a
// swizzled shared layout (tc_bf16.cuh swz: 16-byte chunk index XOR row % 8,
// or at D = 16 and 32, where a row holds 2 or 4 chunks, several rows to a
// 128-byte line XOR the line % 8, so that ldmatrix is free of bank
// conflicts) and stays in registers as A fragments. At D = 256 O's
// accumulator alone is 128 registers a thread, and with the scores beside it
// a warp spilled at 255 registers whatever else was cut (32-key tiles, Q's
// fragments read from shared memory each time): there 8 warps take the 64
// rows, two a 16-row group (fwd_dsplit). Each takes q.k over half of the
// depth from its half of Q's fragments, the two partial scores are summed
// through shared memory in both warps alike (so both hold the same p, l and
// maxima), and each takes the P.V of half of O's columns (two warps that
// each took the whole q.k would do it twice). Its plain version sums the
// two halves alike (ops/flash_attention.py _scores). 64-key
// K and V tiles stream through a 2-stage cp.async ring, so the next tile's
// copy overlaps this tile's products; rows past S are zero-filled by the
// copy's src-size operand. Two passes over the live tiles of each TPU key
// block so that p rounds against the TPU kernel's running maximum: pass 0
// takes only q.k and the row maxima over the block (K tiles only, no exp),
// pass 1 recomputes q.k, takes p, l and P.V. A tile that straddles a block
// edge (bk not a multiple of 64) is taken in both blocks, each time with
// the other block's columns masked. Scores, maxima and sums stay in registers (quad shuffles); p turns
// from the fp32 accumulator fragment into the bf16 A fragment of P.V in
// registers (the FlashAttention-2 layout); V fragments come by
// ldmatrix.trans. Only the diagonal and the length-edge tiles mask element
// by element; causally dead tiles and tiles past the length are never
// loaded; the heaviest query blocks launch first so the causal tail is short.
//
// f32: a SIMT kernel (flash_fwd_kernel below): products on the fp32 units
// through fp32 shared-memory tiles (dynamic shared memory: 74 KB at
// D = 128, 137 KB at 256), each of 16 threads of a row owning D / 16 output
// columns.
// Tensor cores would need TF32 operands (about three decimal digits), which
// the f32 contract (1e-5) does not allow.

// Launch bounds: the f32 kernels, and the bf16 kernels at head dims 16, 32
// and 256 (the *_narrow_kernel instantiations of one body; 256 threads at
// 256, 128 elsewhere), name one block an SM as their minimum. With the
// thread count alone, ptxas held them to 64 or 128 registers a thread and
// spilled to local memory; with the minimum stated it gives them what they
// use, without a spill (kernel_attributes()).
// The bf16 kernels at 64 and 128 keep the thread count alone, and so the
// code they had.
// Named on them too, the minimum lets ptxas give the D = 64 forward and dQ
// kernels 185 and 214 registers instead of 168: an SM then holds two blocks
// instead of three, and at TinyLlama's training shape (B = 16, G = 8,
// S = 2048) an H100 runs the forward 17% and dQ 8% slower, with the same
// outputs (flash_launch_bounds.py). So each kind has two kernels of one body.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tc_bf16.cuh"

namespace {

constexpr int BQ = 64, BKV = 32, THREADS = 256;
constexpr float NEG_INF = -1e30f;
constexpr float LN2 = 0.6931471805599453f;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <int D>
__host__ __device__ constexpr int fwd_simt_smem() {   // sq, sk, sv, sp
  return (int)sizeof(float) * (BQ * (D + 1) + BKV * (D + 1) + BKV * D + BQ * (BKV + 1));
}

// PAD: rows of hd <= D values in global memory (zeros past hd in the tiles)
template <typename T, int D, bool PAD = false>
__global__ void __launch_bounds__(THREADS, 1)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 const int* __restrict__ lengths, T* __restrict__ o,
                 float* __restrict__ lse, int G, int S, int bk, float scale_log2, int causal,
                 int soft_bf16, int hd) {
  constexpr bool P_BF16 = sizeof(T) == 2;   // p rounds to V's type for p.V
  constexpr int DC = D / 16;                // output columns per thread
  const int HD = PAD ? hd : D;              // values a row in global memory
  extern __shared__ float simt_smem[];
  float (*sq)[D + 1] = reinterpret_cast<float (*)[D + 1]>(simt_smem);
  float (*sk)[D + 1] = sq + BQ;
  float (*sv)[D] = reinterpret_cast<float (*)[D]>(sk + BKV);
  float (*sp)[BKV + 1] = reinterpret_cast<float (*)[BKV + 1]>(sv + BKV);

  const int iq = blockIdx.x, grp = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int q0 = iq * BQ;
  const int lenc = max(lengths[b], 1);
  const size_t qoff = ((size_t)b * G + grp) * S * HD;
  const size_t kvoff = (size_t)b * S * HD;

  for (int i = tid; i < BQ * D; i += THREADS) {
    int r = i / D, d = i % D;
    sq[r][d] = q0 + r < S && d < HD ? to_f(q[qoff + (size_t)(q0 + r) * HD + d]) : 0.f;
  }
  int last = lenc - 1;
  if (causal) last = min(last, min(q0 + BQ, S) - 1);

  float m[4], l[4], acc[4][DC];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m[r] = NEG_INF; l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[r][c] = 0.f;
  }

  // the TPU kernel's key blocks [j0, j0 + bk) up to the last live column;
  // in each, pass 0 takes the running maximum over the block, pass 1 p
  // against it, its sum and p.V (the scores are computed twice)
  for (int j0 = 0; j0 <= last; j0 += bk) {
    const int j1 = min(j0 + bk, last + 1);
    float m_old[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) m_old[r] = m[r];
    for (int pass = 0; pass < 2; ++pass) {
      for (int k0 = j0 - j0 % BKV; k0 < j1; k0 += BKV) {
        for (int i = tid; i < BKV * D; i += THREADS) {
          int j = i / D, d = i % D;
          bool in = k0 + j < S && d < HD;
          sk[j][d] = in ? to_f(k[kvoff + (size_t)(k0 + j) * HD + d]) : 0.f;
          if (pass) sv[j][d] = in ? to_f(v[kvoff + (size_t)(k0 + j) * HD + d]) : 0.f;
        }
        __syncthreads();

        float s[4][2];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 2; ++c) s[r][c] = 0.f;
        for (int d = 0; d < HD; ++d) {
          float kd0 = sk[tx * 2][d], kd1 = sk[tx * 2 + 1][d];
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            float qd = sq[ty * 4 + r][d];
            s[r][0] += qd * kd0;
            s[r][1] += qd * kd1;
          }
        }
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int row = q0 + ty * 4 + r;
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int col = k0 + tx * 2 + c;
            bool ok = col >= j0 && col < j1 && col < lenc && (!causal || col <= row);
            s[r][c] = ok ? s[r][c] * scale_log2 : NEG_INF;
          }
          if (pass == 0) {
            m[r] = fmaxf(m[r], fmaxf(s[r][0], s[r][1]));
            continue;
          }
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            // jnp.exp2 is exp(ln2 * x) in x's type (bf16 steps with soft_bf16)
            float p;
            if (soft_bf16) p = round_bf16(expf(round_bf16(0.69140625f * round_bf16(s[r][c] - m[r]))));
            else p = expf((s[r][c] - m[r]) * LN2);
            l[r] += p;
            sp[ty * 4 + r][tx * 2 + c] = P_BF16 ? round_bf16(p) : p;
          }
        }
        if (pass) {
          __syncthreads();
          for (int j = 0; j < BKV; ++j) {
            float vj[DC];
#pragma unroll
            for (int c = 0; c < DC; ++c) vj[c] = sv[j][tx + 16 * c];
#pragma unroll
            for (int r = 0; r < 4; ++r) {
              float p = sp[ty * 4 + r][j];
#pragma unroll
              for (int c = 0; c < DC; ++c) acc[r][c] += p * vj[c];
            }
          }
        }
        __syncthreads();
      }
      if (pass == 0) {
        // the 16 threads of a row (tx) share one half-warp; then the
        // block's rescale of l and the p.V sum
#pragma unroll
        for (int r = 0; r < 4; ++r) {
#pragma unroll
          for (int off = 8; off > 0; off /= 2)
            m[r] = fmaxf(m[r], __shfl_xor_sync(0xffffffffu, m[r], off));
          const float alpha = expf(__fmul_rn(__fsub_rn(m_old[r], m[r]), LN2));
          l[r] *= alpha;
#pragma unroll
          for (int c = 0; c < DC; ++c) acc[r][c] *= alpha;
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int off = 8; off > 0; off /= 2) l[r] += __shfl_xor_sync(0xffffffffu, l[r], off);

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = q0 + ty * 4 + r;
    if (row >= S) continue;
#pragma unroll
    for (int c = 0; c < DC; ++c)
      if (!PAD || tx + 16 * c < HD) put(o + qoff + (size_t)row * HD + tx + 16 * c, acc[r][c] / l[r]);
    if (tx == 0) lse[((size_t)b * G + grp) * S + row] = m[r] * LN2 + logf(l[r]);
  }
}

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

using namespace tc_bf16;
constexpr int TC_BQ = 64, TC_BK = 64, TC_THREADS = 128;   // 4 warps x 16 rows

// the parts D is split in: at D = 256 two warps take a 16-row group, each
// half of q.k's depth and half of O's columns (see the header)
template <int D>
__host__ __device__ constexpr int fwd_dsplit() {
  return D >= 256 ? 2 : 1;
}
template <int D>
__host__ __device__ constexpr int fwd_threads() {
  return TC_THREADS * fwd_dsplit<D>();
}

// Q, then 2 stages of K and V, then (split D) each warp's partial scores
template <int D>
constexpr int fwd_tc_smem() {
  return TC_BQ * D * 2 + 2 * 2 * TC_BK * D * 2 +
         (fwd_dsplit<D>() > 1 ? fwd_threads<D>() * TC_BK * 2 : 0);
}

// bar.sync on named barrier `id` (1 + a row group) for the 64 threads of a
// warp pair
__device__ __forceinline__ void pair_sync(int id) {
  asm volatile("bar.sync %0, 64;" ::"r"(id) : "memory");
}

#define FWD_TC_PARAMS                                                                        \
  const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,       \
      const int* __restrict__ lengths, bf16* __restrict__ o, float* __restrict__ lse, int G,   \
      int S, int bk, float scale_log2, int causal, int soft_bf16, int hd
#define FWD_TC_ARGS \
  q, k, v, lengths, o, lse, G, S, bk, scale_log2, causal, soft_bf16, hd

// PAD: rows of hd <= D values in global memory (load_tile_hd; the chunks
// and column pairs wholly past hd skipped, their outputs not written)
template <int D, bool PAD>
__device__ __forceinline__ void flash_fwd_tc_body(FWD_TC_PARAMS) {
  constexpr int KC = D / 16;          // 16-deep chunks of the q.k product
  constexpr int NT = TC_BK / 8;       // 8-key column tiles of the scores
  constexpr int DS = fwd_dsplit<D>(), NTH = fwd_threads<D>();
  constexpr int DT = D / 8 / DS;      // 8-wide column tiles of O a warp holds
  constexpr int TILE = TC_BK * D * 2;
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t sq = smem_u32(smem);
  const uint32_t sk = sq + TC_BQ * D * 2;      // stage s at sk + s * TILE
  const uint32_t sv = sk + 2 * TILE;

  // heaviest query blocks first: blockIdx.x runs over (b, g) fastest, then
  // over the query blocks from the last one down
  const int nq = (S + TC_BQ - 1) / TC_BQ;
  const int BG = gridDim.x / nq;
  const int iq = nq - 1 - (int)blockIdx.x / BG, bg = (int)blockIdx.x % BG, b = bg / G;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  // the warp's 16 rows (rw), and which of the DS parts of O's columns it takes
  const int rw = DS > 1 ? warp & 3 : warp, dh = DS > 1 ? warp >> 2 : 0;
  const int q0 = iq * TC_BQ, wr = q0 + rw * 16;     // the warp's first row
  const int lenc = min(max(lengths[b], 1), S);
  const int HD = PAD ? hd : D;          // values a row in global memory
  const size_t qoff = (size_t)bg * S * HD;
  const bf16* kbase = k + (size_t)b * S * HD;
  const bf16* vbase = v + (size_t)b * S * HD;
  int last = lenc - 1;
  if (causal) last = min(last, min(q0 + TC_BQ, S) - 1);
  auto tile = [&](uint32_t dst, const bf16* src, int r0) {
    if constexpr (PAD) load_tile_hd<D, TC_BK, NTH>(dst, src, r0, S, HD);
    else load_tile<D, TC_BK, NTH>(dst, src, r0, S);
  };

  if constexpr (PAD) load_tile_hd<D, TC_BQ, NTH>(sq, q + qoff, q0, S, HD);
  else load_tile<D, TC_BQ, NTH>(sq, q + qoff, q0, S);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  // Q's A fragments of the warp's share of the depth (chunks dh QF ..)
  constexpr int QF = KC / DS;
  uint32_t qa[QF][4];
#pragma unroll
  for (int i = 0; i < QF; ++i) ldsm_x4(a_addr<D>(sq, rw * 16, dh * QF + i, lane), qa[i]);

  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  float acc[DT][4];
#pragma unroll
  for (int j = 0; j < DT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  // the TPU kernel's key blocks [j0, j0 + bk) up to the last live column,
  // each over its tiles [t0, t1): pass 0 the running maxima (K tiles only),
  // pass 1 p against them, l, P.V
  for (int j0 = 0; j0 <= last; j0 += bk) {
    const int j1 = min(j0 + bk, last + 1);
    const int t0 = j0 / TC_BK, t1 = (j1 - 1) / TC_BK + 1;
    const float m_old[2] = {m[0], m[1]};
    for (int pass = 0; pass < 2; ++pass) {
      tile(sk, kbase, t0 * TC_BK);
      if (pass) tile(sv, vbase, t0 * TC_BK);
      cp_async_commit();
      for (int kt = t0; kt < t1; ++kt) {
        const int k0 = kt * TC_BK;
        const int stage = (kt - t0) & 1;
        const uint32_t skt = sk + stage * TILE, svt = sv + stage * TILE;
        if (kt + 1 < t1) {           // the next tile's copy overlaps this tile's products
          const uint32_t nxt = (stage ^ 1) * TILE;
          tile(sk + nxt, kbase, k0 + TC_BK);
          if (pass) tile(sv + nxt, vbase, k0 + TC_BK);
          cp_async_commit();
          cp_async_wait<1>();
        } else {
          cp_async_wait<0>();
        }
        __syncthreads();

        float s[NT][4];
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
        for (int i = 0; i < QF; ++i) {
          const int kc = dh * QF + i;
#pragma unroll
          for (int np = 0; np < NT / 2; ++np) {
            if (PAD && kc * 16 >= HD) continue;   // zero columns only
            uint32_t kf[4];
            ldsm_x4(b_addr<D>(skt, np * 16, kc, lane), kf);
            mma(s[2 * np], qa[i], kf[0], kf[1]);
            mma(s[2 * np + 1], qa[i], kf[2], kf[3]);
          }
        }
        if constexpr (DS > 1) {
          // the pair's two halves of the depth summed through shared memory:
          // each warp adds its partner's to its own, so both hold the same
          // sums (a + b == b + a); the buffer is free again after the
          // tile's closing __syncthreads
          float* xs = reinterpret_cast<float*>(smem + TC_BQ * D * 2 + 4 * TILE);
#pragma unroll
          for (int j = 0; j < NT; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) xs[(warp * NT * 4 + j * 4 + e) * 32 + lane] = s[j][e];
          pair_sync(1 + rw);
#pragma unroll
          for (int j = 0; j < NT; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              s[j][e] = __fadd_rn(s[j][e], xs[((warp ^ 4) * NT * 4 + j * 4 + e) * 32 + lane]);
        }
        // element masks only on the length-edge tile, the diagonal tile and
        // a tile that straddles a key block's edge
        const bool edge = k0 + TC_BK > lenc || (causal && k0 + TC_BK - 1 > q0) ||
                          k0 < j0 || k0 + TC_BK > j1;
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            // _rn: the product and the difference below round on their own,
            // as in the plain version; a contracted fma would move p
            float x = __fmul_rn(s[j][e], scale_log2);
            if (edge) {
              const int row = wr + g + (e >> 1) * 8, col = k0 + j * 8 + 2 * t + (e & 1);
              if (!(col >= j0 && col < j1 && col < lenc && (!causal || col <= row))) x = NEG_INF;
            }
            s[j][e] = x;
          }

        if (pass == 0) {
#pragma unroll
          for (int j = 0; j < NT; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) m[e >> 1] = fmaxf(m[e >> 1], s[j][e]);
        } else {
#pragma unroll
          for (int j = 0; j < NT; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float x = __fsub_rn(s[j][e], m[e >> 1]);
              // jnp.exp2 is exp(ln2 * x) in x's type (bf16 steps with soft_bf16)
              const float p = soft_bf16 ? round_bf16(expf(round_bf16(0.69140625f * round_bf16(x))))
                                        : expf(__fmul_rn(x, LN2));
              l[e >> 1] += p;
              s[j][e] = p;
            }
          // P, rounded to bf16, . V: key columns [16c, 16c + 16) of the scores
          // are the A fragment of that 16-deep chunk
#pragma unroll
          for (int c = 0; c < TC_BK / 16; ++c) {
            uint32_t pa[4];
            acc_to_a(s[2 * c], s[2 * c + 1], pa);
#pragma unroll
            for (int np = 0; np < DT / 2; ++np) {
              if (PAD && np * 16 >= HD) continue;   // output columns past hd
              uint32_t vf[4];
              ldsm_x4_t(t_addr<D>(svt, c, np + dh * DT / 2, lane), vf);
              mma(acc[2 * np], pa, vf[0], vf[1]);
              mma(acc[2 * np + 1], pa, vf[2], vf[3]);
            }
          }
        }
        __syncthreads();             // this stage is free for the tile after next
      }
      if (pass == 0) {
        // the 4 threads of a quad hold one row's columns; then the block's
        // rescale of l and the p.V sum by alpha = exp2(m_old - m_new)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          m[h] = fmaxf(m[h], __shfl_xor_sync(0xffffffffu, m[h], 1));
          m[h] = fmaxf(m[h], __shfl_xor_sync(0xffffffffu, m[h], 2));
        }
        if (j0 > 0) {
          float alpha[2];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            alpha[h] = expf(__fmul_rn(__fsub_rn(m_old[h], m[h]), LN2));
            l[h] = __fmul_rn(l[h], alpha[h]);
          }
#pragma unroll
          for (int j = 0; j < DT; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[j][e] = __fmul_rn(acc[j][e], alpha[e >> 1]);
        }
      }
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = wr + g + 8 * h;
    if (row >= S) continue;
    bf16* orow = o + qoff + (size_t)row * HD;
#pragma unroll
    for (int j = 0; j < DT; ++j)
      if (!PAD || j * 8 + 2 * t < HD)
        *reinterpret_cast<uint32_t*>(orow + (j + dh * DT) * 8 + 2 * t) =
            pack(acc[j][2 * h] / l[h], acc[j][2 * h + 1] / l[h]);
    if (t == 0 && dh == 0) lse[(size_t)bg * S + row] = __fadd_rn(__fmul_rn(m[h], LN2), logf(l[h]));
  }
}

template <int D, bool PAD>
__global__ void __launch_bounds__(TC_THREADS) flash_fwd_tc_kernel(FWD_TC_PARAMS) {
  flash_fwd_tc_body<D, PAD>(FWD_TC_ARGS);
}
template <int D, bool PAD>
__global__ void __launch_bounds__(fwd_threads<D>(), 1)
flash_fwd_tc_narrow_kernel(FWD_TC_PARAMS) {
  flash_fwd_tc_body<D, PAD>(FWD_TC_ARGS);
}
// head dims 16, 32 and 256 take the kernel with one block an SM named as its
// minimum (see the header); 64 and 128 keep the thread count alone, and so
// does the padded build
template <int D, bool PAD>
auto flash_fwd_tc() {
  if constexpr (D < 64 || D > 128) return &flash_fwd_tc_narrow_kernel<D, PAD>;
  else return &flash_fwd_tc_kernel<D, PAD>;
}

template <int D, bool PAD>
int launch_fwd_tc(const void* q, const void* k, const void* v, const void* lengths, void* o,
                  void* lse, int B, int G, int S, int bk, int causal, int soft_bf16,
                  float scale_log2, int hd, cudaStream_t st) {
  constexpr int smem = fwd_tc_smem<D>();
  if (int e = (int)cudaFuncSetAttribute(flash_fwd_tc<D, PAD>(),
                                        cudaFuncAttributeMaxDynamicSharedMemorySize, smem))
    return e;
  const int nq = (S + TC_BQ - 1) / TC_BQ;
  flash_fwd_tc<D, PAD>()<<<nq * G * B, fwd_threads<D>(), smem, st>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const int*)lengths, (bf16*)o,
      (float*)lse, G, S, bk, scale_log2, causal, soft_bf16, hd);
  return (int)cudaGetLastError();
}

template <int D, bool PAD>
int launch_fwd_simt(const void* q, const void* k, const void* v, const void* lengths, void* o,
                    void* lse, int B, int G, int S, int bk, int causal, int soft_bf16,
                    float scale_log2, int hd, cudaStream_t st) {
  constexpr int smem = fwd_simt_smem<D>();
  if (int e = (int)cudaFuncSetAttribute(flash_fwd_kernel<float, D, PAD>,
                                        cudaFuncAttributeMaxDynamicSharedMemorySize, smem))
    return e;
  flash_fwd_kernel<float, D, PAD><<<dim3((S + BQ - 1) / BQ, G, B), THREADS, smem, st>>>(
      (const float*)q, (const float*)k, (const float*)v, (const int*)lengths, (float*)o,
      (float*)lse, G, S, bk, scale_log2, causal, soft_bf16, hd);
  return (int)cudaGetLastError();
}

// dtype_code: 0 = f32 q/k/v/o (SIMT kernel), 1 = bf16 (tensor cores). bk:
// the TPU kernel's key block, a divisor of S (_fit_block). hd: the head dim
// of the rows in memory, D unless PAD.
template <int D, bool PAD>
int fwd_entry(const void* q, const void* k, const void* v, const void* lengths, void* o,
              void* lse, int B, int G, int S, int bk, int causal, int soft_bf16, int dtype_code,
              float scale_log2, int hd, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bk < 1 || S % bk || dtype_code < 0 || dtype_code > 1) return (int)cudaErrorInvalidValue;
  if (PAD ? hd % 4 || hd <= 32 || hd > D : hd != D) return (int)cudaErrorInvalidValue;
  if (dtype_code == 1)
    return launch_fwd_tc<D, PAD>(q, k, v, lengths, o, lse, B, G, S, bk, causal, soft_bf16,
                                 scale_log2, hd, st);
  return launch_fwd_simt<D, PAD>(q, k, v, lengths, o, lse, B, G, S, bk, causal, soft_bf16,
                                 scale_log2, hd, st);
}

template <int D, bool PAD = false>
int fwd_attributes(int* out, int dtype_code) {
  if (dtype_code == 1)
    return tc_bf16::attributes(flash_fwd_tc<D, PAD>(), fwd_threads<D>(), fwd_tc_smem<D>(), out);
  return tc_bf16::attributes(flash_fwd_kernel<float, D, PAD>, THREADS, fwd_simt_smem<D>(), out);
}

}  // namespace

// One entry per head dim, each with the arguments of fwd_entry.
#define FLASH_FWD_ENTRY(name, D)                                                              \
  extern "C" int name(const void* q, const void* k, const void* v, const void* lengths,      \
                      void* o, void* lse, int B, int G, int S, int bk, int causal,            \
                      int soft_bf16, int dtype_code, float scale_log2, void* stream) {        \
    return fwd_entry<D, false>(q, k, v, lengths, o, lse, B, G, S, bk, causal, soft_bf16,    \
                               dtype_code, scale_log2, D, stream);                            \
  }
FLASH_FWD_ENTRY(flash_fwd, 64)
FLASH_FWD_ENTRY(flash_fwd_d16, 16)
FLASH_FWD_ENTRY(flash_fwd_d32, 32)
FLASH_FWD_ENTRY(flash_fwd_d128, 128)
FLASH_FWD_ENTRY(flash_fwd_d256, 256)

// Any other head dim hd % 4 == 0, 32 < hd <= 128: the arguments of the
// entries above with hd after dtype_code.
extern "C" int flash_fwd_dpad(const void* q, const void* k, const void* v, const void* lengths,
                              void* o, void* lse, int B, int G, int S, int bk, int causal,
                              int soft_bf16, int dtype_code, int hd, float scale_log2,
                              void* stream) {
  return fwd_entry<128, true>(q, k, v, lengths, o, lse, B, G, S, bk, causal, soft_bf16,
                              dtype_code, scale_log2, hd, stream);
}

// A kernel's registers, shared memory, spills and occupancy at a head dim
// (16, 32, 64, 128, 256; another: the padded build) and dtype_code
// (tc_bf16::attributes; launches nothing).
extern "C" int flash_fwd_attributes(int* out, int head_dim, int dtype_code) {
  switch (head_dim) {
    case 16: return fwd_attributes<16>(out, dtype_code);
    case 32: return fwd_attributes<32>(out, dtype_code);
    case 64: return fwd_attributes<64>(out, dtype_code);
    case 128: return fwd_attributes<128>(out, dtype_code);
    case 256: return fwd_attributes<256>(out, dtype_code);
  }
  if (head_dim % 4 == 0 && head_dim > 32 && head_dim < 128)
    return fwd_attributes<128, true>(out, dtype_code);
  return (int)cudaErrorInvalidValue;
}
