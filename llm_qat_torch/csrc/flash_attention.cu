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
// bf16 (D = 64 and 128): the products run on the tensor cores,
// mma.sync m16n8k16 bf16 x bf16 -> fp32, which is exactly the contract's
// "bf16 operands, fp32 sums". One block of 4 warps per (B, g, 64 query
// rows), each warp 16 rows. The Q tile arrives once by cp.async into a
// swizzled shared layout (16-byte chunk index XOR row % 8, so that ldmatrix
// is free of bank conflicts) and stays in registers as A fragments. 64-key
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
// f32 (D = 64): a SIMT kernel (flash_fwd_kernel below): products on
// the fp32 units through fp32 shared-memory tiles. Tensor cores would need
// TF32 operands (about three decimal digits), which the f32 contract (1e-5)
// does not allow.

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

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 const int* __restrict__ lengths, T* __restrict__ o,
                 float* __restrict__ lse, int G, int S, int bk, float scale_log2, int causal,
                 int soft_bf16) {
  constexpr bool P_BF16 = sizeof(T) == 2;   // p rounds to V's type for p.V
  constexpr int DC = D / 16;                // output columns per thread
  __shared__ float sq[BQ][D + 1];
  __shared__ float sk[BKV][D + 1];
  __shared__ float sv[BKV][D];
  __shared__ float sp[BQ][BKV + 1];

  const int iq = blockIdx.x, grp = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int q0 = iq * BQ;
  const int lenc = max(lengths[b], 1);
  const size_t qoff = ((size_t)b * G + grp) * S * D;
  const size_t kvoff = (size_t)b * S * D;

  for (int i = tid; i < BQ * D; i += THREADS) {
    int r = i / D, d = i % D;
    sq[r][d] = q0 + r < S ? to_f(q[qoff + (size_t)(q0 + r) * D + d]) : 0.f;
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
          bool in = k0 + j < S;
          sk[j][d] = in ? to_f(k[kvoff + (size_t)(k0 + j) * D + d]) : 0.f;
          if (pass) sv[j][d] = in ? to_f(v[kvoff + (size_t)(k0 + j) * D + d]) : 0.f;
        }
        __syncthreads();

        float s[4][2];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 2; ++c) s[r][c] = 0.f;
        for (int d = 0; d < D; ++d) {
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
      put(o + qoff + (size_t)row * D + tx + 16 * c, acc[r][c] / l[r]);
    if (tx == 0) lse[((size_t)b * G + grp) * S + row] = m[r] * LN2 + logf(l[r]);
  }
}

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

using namespace tc_bf16;
constexpr int TC_BQ = 64, TC_BK = 64, TC_THREADS = 128;   // 4 warps x 16 rows

template <int D>
constexpr int fwd_tc_smem() {
  return TC_BQ * D * 2 + 2 * 2 * TC_BK * D * 2;   // Q, then 2 stages of K and V
}

template <int D>
__global__ void __launch_bounds__(TC_THREADS)
flash_fwd_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const int* __restrict__ lengths,
                    bf16* __restrict__ o, float* __restrict__ lse, int G, int S, int bk,
                    float scale_log2, int causal, int soft_bf16) {
  constexpr int KC = D / 16;          // 16-deep chunks of the q.k product
  constexpr int NT = TC_BK / 8;       // 8-key column tiles of the scores
  constexpr int DT = D / 8;           // 8-wide column tiles of O
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
  const int q0 = iq * TC_BQ, wr = q0 + warp * 16;   // the warp's first row
  const int lenc = min(max(lengths[b], 1), S);
  const size_t qoff = (size_t)bg * S * D;
  const bf16* kbase = k + (size_t)b * S * D;
  const bf16* vbase = v + (size_t)b * S * D;
  int last = lenc - 1;
  if (causal) last = min(last, min(q0 + TC_BQ, S) - 1);

  load_tile<D, TC_BQ, TC_THREADS>(sq, q + qoff, q0, S);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  uint32_t qa[KC][4];
#pragma unroll
  for (int kc = 0; kc < KC; ++kc) ldsm_x4(a_addr<D>(sq, warp * 16, kc, lane), qa[kc]);

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
      load_tile<D, TC_BK, TC_THREADS>(sk, kbase, t0 * TC_BK, S);
      if (pass) load_tile<D, TC_BK, TC_THREADS>(sv, vbase, t0 * TC_BK, S);
      cp_async_commit();
      for (int kt = t0; kt < t1; ++kt) {
        const int k0 = kt * TC_BK;
        const int stage = (kt - t0) & 1;
        const uint32_t skt = sk + stage * TILE, svt = sv + stage * TILE;
        if (kt + 1 < t1) {           // the next tile's copy overlaps this tile's products
          const uint32_t nxt = (stage ^ 1) * TILE;
          load_tile<D, TC_BK, TC_THREADS>(sk + nxt, kbase, k0 + TC_BK, S);
          if (pass) load_tile<D, TC_BK, TC_THREADS>(sv + nxt, vbase, k0 + TC_BK, S);
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
        for (int kc = 0; kc < KC; ++kc)
#pragma unroll
          for (int np = 0; np < NT / 2; ++np) {
            uint32_t kf[4];
            ldsm_x4(b_addr<D>(skt, np * 16, kc, lane), kf);
            mma(s[2 * np], qa[kc], kf[0], kf[1]);
            mma(s[2 * np + 1], qa[kc], kf[2], kf[3]);
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
              uint32_t vf[4];
              ldsm_x4_t(t_addr<D>(svt, c, np, lane), vf);
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
    bf16* orow = o + qoff + (size_t)row * D;
#pragma unroll
    for (int j = 0; j < DT; ++j)
      *reinterpret_cast<uint32_t*>(orow + j * 8 + 2 * t) =
          pack(acc[j][2 * h] / l[h], acc[j][2 * h + 1] / l[h]);
    if (t == 0) lse[(size_t)bg * S + row] = __fadd_rn(__fmul_rn(m[h], LN2), logf(l[h]));
  }
}

template <int D>
int launch_fwd_tc(const void* q, const void* k, const void* v, const void* lengths, void* o,
                  void* lse, int B, int G, int S, int bk, int causal, int soft_bf16,
                  float scale_log2, cudaStream_t st) {
  constexpr int smem = fwd_tc_smem<D>();
  if (int e = (int)cudaFuncSetAttribute(flash_fwd_tc_kernel<D>,
                                        cudaFuncAttributeMaxDynamicSharedMemorySize, smem))
    return e;
  const int nq = (S + TC_BQ - 1) / TC_BQ;
  flash_fwd_tc_kernel<D><<<nq * G * B, TC_THREADS, smem, st>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const int*)lengths, (bf16*)o,
      (float*)lse, G, S, bk, scale_log2, causal, soft_bf16);
  return (int)cudaGetLastError();
}

}  // namespace

// D = 64. dtype_code: 0 = f32 q/k/v/o (SIMT kernel), 1 = bf16 (tensor cores).
// bk: the TPU kernel's key block, a divisor of S (_fit_block).
extern "C" int flash_fwd(const void* q, const void* k, const void* v, const void* lengths,
                         void* o, void* lse, int B, int G, int S, int bk, int causal,
                         int soft_bf16, int dtype_code, float scale_log2, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bk < 1 || S % bk) return (int)cudaErrorInvalidValue;
  if (dtype_code == 1)
    return launch_fwd_tc<64>(q, k, v, lengths, o, lse, B, G, S, bk, causal, soft_bf16,
                             scale_log2, st);
  dim3 grid((S + BQ - 1) / BQ, G, B);
  flash_fwd_kernel<float, 64><<<grid, THREADS, 0, st>>>(
      (const float*)q, (const float*)k, (const float*)v, (const int*)lengths, (float*)o,
      (float*)lse, G, S, bk, scale_log2, causal, soft_bf16);
  return (int)cudaGetLastError();
}

// D = 128 (the LLaMA-7B family's heads), bf16 only; the same arguments.
extern "C" int flash_fwd_d128(const void* q, const void* k, const void* v, const void* lengths,
                              void* o, void* lse, int B, int G, int S, int bk, int causal,
                              int soft_bf16, int dtype_code, float scale_log2, void* stream) {
  if (dtype_code != 1 || bk < 1 || S % bk) return (int)cudaErrorInvalidValue;
  return launch_fwd_tc<128>(q, k, v, lengths, o, lse, B, G, S, bk, causal, soft_bf16,
                            scale_log2, static_cast<cudaStream_t>(stream));
}

// The bf16 kernel's registers, shared memory, spills and occupancy at head
// dim 64 or 128 (tc_bf16::attributes; launches nothing).
extern "C" int flash_fwd_attributes(int* out, int head_dim) {
  if (head_dim == 128)
    return tc_bf16::attributes(flash_fwd_tc_kernel<128>, TC_THREADS, fwd_tc_smem<128>(), out);
  return tc_bf16::attributes(flash_fwd_tc_kernel<64>, TC_THREADS, fwd_tc_smem<64>(), out);
}
