// Causal blockwise (flash) attention forward, for Hopper (sm_90a).
//
// Replaces llm_qat_tpu/ops/pallas/flash_attention.py:_flash_fwd_kernel
// (_flash_fwd). q [B, G, S, D] with B = batch * kv_heads and G query heads
// per kv head, k/v [B, S, D] un-repeated, lengths [B] int32. Columns
// >= max(length, 1) are masked, and columns > row when causal. Base-2
// softmax in fp32 (log2(e) folded into the score scale) against each row's
// final maximum, as the TPU kernel computes it for S <= 1024; with soft_bf16
// the exp2 runs on bf16 operands and p is bf16. p is rounded to V's type
// before the p.V product, as the TPU kernel does. Returns O [B, G, S, D] in
// q's type and the per-row log-sum-exp in nats, [B, G, S] f32.
//
// Bound on this card: at the prefill shapes (S <= 1024, D = 64) the work is
// ~2 * 2 * S * S / 2 * D operations per (B, G) row set against ~4 * S * D
// bytes, so the tensor-core rate bounds it. This first kernel does not reach
// the tensor cores: it runs the products on the fp32 units (SIMT), one
// block of 256 threads per 64 query rows of one (B, G), streaming 32-key K/V
// tiles through shared memory and skipping tiles that are causally dead or
// past the length, twice: once for the row maxima, once for p and p.V (the
// q.k product runs twice, so p never needs rescaling and rounds as the TPU
// kernel's does). Scores and statistics never leave the block. Moving the
// two products to mma.sync / wgmma bf16 is the next step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64, BKV = 32, THREADS = 256;
constexpr float NEG_INF = -1e30f;
constexpr float LN2 = 0.6931471805599453f;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }
__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 const int* __restrict__ lengths, T* __restrict__ o,
                 float* __restrict__ lse, int G, int S, float scale_log2, int causal,
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
  const int nkb = last / BKV + 1;

  float m[4], l[4], acc[4][DC];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m[r] = NEG_INF; l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[r][c] = 0.f;
  }

  // pass 0: each row's maximum score over its live columns; pass 1: p
  // against that final maximum, its sum and p.V. Two passes (the scores are
  // computed twice) so that p, and its rounding to V's type, is the TPU
  // kernel's: its one 1024-key block holds a whole prefill row, so it never
  // rescales.
  for (int pass = 0; pass < 2; ++pass) {
    for (int kb = 0; kb < nkb; ++kb) {
      const int k0 = kb * BKV;
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
          bool ok = col < lenc && (!causal || col <= row);
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
      // the 16 threads of a row (tx) share one half-warp
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int off = 8; off > 0; off /= 2)
          m[r] = fmaxf(m[r], __shfl_xor_sync(0xffffffffu, m[r], off));
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

}  // namespace

// D = 64 only (TinyLlama-1.1B); the wrapper raises on other head dims.
// dtype_code: 0 = f32 q/k/v/o, 1 = bf16.
extern "C" int flash_fwd(const void* q, const void* k, const void* v, const void* lengths,
                         void* o, void* lse, int B, int G, int S, int causal, int soft_bf16,
                         int dtype_code, float scale_log2, void* stream) {
  dim3 grid((S + BQ - 1) / BQ, G, B);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype_code == 1)
    flash_fwd_kernel<__nv_bfloat16, 64><<<grid, THREADS, 0, st>>>(
        (const __nv_bfloat16*)q, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v,
        (const int*)lengths, (__nv_bfloat16*)o, (float*)lse, G, S, scale_log2, causal,
        soft_bf16);
  else
    flash_fwd_kernel<float, 64><<<grid, THREADS, 0, st>>>(
        (const float*)q, (const float*)k, (const float*)v, (const int*)lengths, (float*)o,
        (float*)lse, G, S, scale_log2, causal, soft_bf16);
  return (int)cudaGetLastError();
}
