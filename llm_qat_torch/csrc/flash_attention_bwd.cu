// Causal blockwise (flash) attention backward, for Hopper (sm_90a).
//
// flash_bwd_dq replaces llm_qat_tpu/ops/pallas/flash_attention.py:
// _flash_bwd_dq_kernel, flash_bwd_dkv replaces _flash_bwd_dkv_kernel (both
// reached through _flash_bwd). Layout as the forward: q, dO, dQ [B, G, S, D]
// with B = batch * kv_heads and G query heads per kv head, k, v, dK, dV
// [B, S, D] un-repeated, lse and delta = rowsum(dO * O) [B, G, S] f32,
// lengths [B] int32. Columns >= max(length, 1) are masked, and columns > row
// when causal; rows are never masked (rows >= length carry whatever
// cotangent arrives, as in the TPU kernels).
//
// Both recompute p from the saved log-sum-exp in base 2, in fp32:
//   s2 = (scale * log2 e) * q.k,  p = exp2(s2 - lse * log2 e)
// (exp2(x) as exp(ln2 * x), the forward's rule), never from an online
// softmax, and round where the TPU kernels round:
//   dQ_i = scale * sum_j ds_ij K_j,     ds = p * (dO_i.V_j - delta_i) rounded to K's type
//   dV_j = sum_i p_ij dO_i,             p rounded to dO's type
//   dK_j = scale * sum_i ds_ij Q_i,     ds rounded to Q's type
// with fp32 accumulation and one final cast.
//
// dQ: one block per (B, g, 64 query rows), a loop over the live 32-key tiles
// (causal and length), dQ in registers, one write. dK/dV: one block per
// (B, 64 keys), loops over the G query heads of the kv head and the live
// 32-row query tiles (from the diagonal on when causal), dK and dV in
// registers, one write: the sum over G stays inside the block, so there are
// no atomics and the result is the same from run to run. A block whose keys
// all lie past the length writes exact zeros.
//
// Bound on this card: operations (about 2.5x the forward's products against
// a few bytes an element). These first kernels, like the forward, run their
// products on the fp32 units (SIMT) through shared-memory tiles; moving them
// to mma.sync / wgmma is the next step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr float NEG_INF = -1e30f;
constexpr float LN2 = 0.6931471805599453f;
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }
template <typename T> __device__ __forceinline__ float round_to(float v);
template <> __device__ __forceinline__ float round_to<float>(float v) { return v; }
template <> __device__ __forceinline__ float round_to<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// rows [r0, r0 + n) of a [rows_total, D] matrix at src into dst[n][D + 1] as
// fp32, zeros past rows_total
template <typename T, int D>
__device__ __forceinline__ void load_tile(float (*dst)[D + 1], const T* src, int r0, int n,
                                          int rows_total) {
  for (int i = threadIdx.x; i < n * D; i += THREADS) {
    const int r = i / D, d = i % D;
    dst[r][d] = r0 + r < rows_total ? to_f(src[(size_t)(r0 + r) * D + d]) : 0.f;
  }
}

// ---------------------------------------------------------------------------
// dQ
// ---------------------------------------------------------------------------

constexpr int DQ_BQ = 64, DQ_BKV = 32;

template <int D>
constexpr size_t dq_smem_bytes() {
  return sizeof(float) * ((2 * DQ_BQ + 2 * DQ_BKV) * (D + 1) + DQ_BQ * (DQ_BKV + 1));
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const T* __restrict__ dout, const float* __restrict__ lse,
                    const float* __restrict__ delta, const int* __restrict__ lengths,
                    T* __restrict__ dq, int G, int S, float scale_log2, float scale,
                    int causal) {
  constexpr int BQ = DQ_BQ, BKV = DQ_BKV, DC = D / 16;
  extern __shared__ float smem[];
  float (*sq)[D + 1] = reinterpret_cast<float (*)[D + 1]>(smem);
  float (*sdo)[D + 1] = sq + BQ;
  float (*sk)[D + 1] = sdo + BQ;
  float (*sv)[D + 1] = sk + BKV;
  float (*sp)[BKV + 1] = reinterpret_cast<float (*)[BKV + 1]>(sv + BKV);

  const int iq = blockIdx.x, grp = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int q0 = iq * BQ;
  const int lenc = max(lengths[b], 1);
  const size_t qoff = ((size_t)b * G + grp) * S * D;
  const size_t kvoff = (size_t)b * S * D;
  const size_t roff = ((size_t)b * G + grp) * S;

  load_tile<T, D>(sq, q + qoff, q0, BQ, S);
  load_tile<T, D>(sdo, dout + qoff, q0, BQ, S);
  float lse2[4], dl[4], acc[4][DC];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = q0 + ty * 4 + r;
    lse2[r] = row < S ? lse[roff + row] * LOG2E : 0.f;
    dl[r] = row < S ? delta[roff + row] : 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[r][c] = 0.f;
  }
  int last = lenc - 1;
  if (causal) last = min(last, min(q0 + BQ, S) - 1);
  const int nkb = last / BKV + 1;

  for (int kb = 0; kb < nkb; ++kb) {
    const int k0 = kb * BKV;
    __syncthreads();                       // the last tile's sk and sp are read no more
    load_tile<T, D>(sk, k + kvoff, k0, BKV, S);
    load_tile<T, D>(sv, v + kvoff, k0, BKV, S);
    __syncthreads();

    float s[4][2], dp[4][2];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 2; ++c) s[r][c] = dp[r][c] = 0.f;
    for (int d = 0; d < D; ++d) {
      const float kd0 = sk[tx * 2][d], kd1 = sk[tx * 2 + 1][d];
      const float vd0 = sv[tx * 2][d], vd1 = sv[tx * 2 + 1][d];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float qd = sq[ty * 4 + r][d], od = sdo[ty * 4 + r][d];
        s[r][0] += qd * kd0;
        s[r][1] += qd * kd1;
        dp[r][0] += od * vd0;
        dp[r][1] += od * vd1;
      }
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = q0 + ty * 4 + r;
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int col = k0 + tx * 2 + c;
        const bool ok = col < lenc && (!causal || col <= row);
        const float s2 = ok ? s[r][c] * scale_log2 : NEG_INF;
        const float p = expf((s2 - lse2[r]) * LN2);
        sp[ty * 4 + r][tx * 2 + c] = round_to<T>(p * (dp[r][c] - dl[r]));
      }
    }
    __syncthreads();
    for (int j = 0; j < BKV; ++j) {
      float kj[DC];
#pragma unroll
      for (int c = 0; c < DC; ++c) kj[c] = sk[j][tx + 16 * c];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float ds = sp[ty * 4 + r][j];
#pragma unroll
        for (int c = 0; c < DC; ++c) acc[r][c] += ds * kj[c];
      }
    }
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = q0 + ty * 4 + r;
    if (row >= S) continue;
#pragma unroll
    for (int c = 0; c < DC; ++c)
      put(dq + qoff + (size_t)row * D + tx + 16 * c, scale * acc[r][c]);
  }
}

// ---------------------------------------------------------------------------
// dK, dV
// ---------------------------------------------------------------------------

constexpr int KV_BKV = 64, KV_BQ = 32;

template <int D>
constexpr size_t dkv_smem_bytes() {
  return sizeof(float) * ((2 * KV_BKV + 2 * KV_BQ) * (D + 1) + 2 * KV_BKV * (KV_BQ + 1)
                          + 2 * KV_BQ);
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const T* __restrict__ dout, const float* __restrict__ lse,
                     const float* __restrict__ delta, const int* __restrict__ lengths,
                     T* __restrict__ dk, T* __restrict__ dv, int G, int S, float scale_log2,
                     float scale, int causal) {
  constexpr int BKV = KV_BKV, BQ = KV_BQ, DC = D / 16;
  extern __shared__ float smem[];
  float (*sk)[D + 1] = reinterpret_cast<float (*)[D + 1]>(smem);
  float (*sv)[D + 1] = sk + BKV;
  float (*sq)[D + 1] = sv + BKV;
  float (*sdo)[D + 1] = sq + BQ;
  float (*spt)[BQ + 1] = reinterpret_cast<float (*)[BQ + 1]>(sdo + BQ);   // p, [key][row]
  float (*sds)[BQ + 1] = spt + BKV;                                        // ds, [key][row]
  float* slse = reinterpret_cast<float*>(sds + BKV);
  float* sdl = slse + BQ;

  const int k0 = blockIdx.x * BKV, b = blockIdx.y;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int lenc = max(lengths[b], 1);
  const size_t kvoff = (size_t)b * S * D;

  float ak[4][DC], av[4][DC];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < DC; ++c) ak[r][c] = av[r][c] = 0.f;

  if (k0 < lenc) {                         // else every column is masked: p = 0
    load_tile<T, D>(sk, k + kvoff, k0, BKV, S);
    load_tile<T, D>(sv, v + kvoff, k0, BKV, S);
    const int nqt = (S + BQ - 1) / BQ;
    const int first = causal ? k0 / BQ : 0;
    for (int grp = 0; grp < G; ++grp) {
      const size_t qoff = ((size_t)b * G + grp) * S * D;
      const size_t roff = ((size_t)b * G + grp) * S;
      for (int iq = first; iq < nqt; ++iq) {
        const int q0 = iq * BQ;
        __syncthreads();                   // the last tile's sq, sdo, spt, sds are read no more
        load_tile<T, D>(sq, q + qoff, q0, BQ, S);
        load_tile<T, D>(sdo, dout + qoff, q0, BQ, S);
        if (tid < BQ) {
          const int row = q0 + tid;
          slse[tid] = row < S ? lse[roff + row] * LOG2E : 0.f;
          sdl[tid] = row < S ? delta[roff + row] : 0.f;
        }
        __syncthreads();

        float s[4][2], dp[4][2];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 2; ++c) s[r][c] = dp[r][c] = 0.f;
        for (int d = 0; d < D; ++d) {
          const float qd0 = sq[tx * 2][d], qd1 = sq[tx * 2 + 1][d];
          const float od0 = sdo[tx * 2][d], od1 = sdo[tx * 2 + 1][d];
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const float kd = sk[ty * 4 + r][d], vd = sv[ty * 4 + r][d];
            s[r][0] += qd0 * kd;
            s[r][1] += qd1 * kd;
            dp[r][0] += od0 * vd;
            dp[r][1] += od1 * vd;
          }
        }
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int col = k0 + ty * 4 + r;
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int lr = tx * 2 + c, row = q0 + lr;
            const bool ok = col < lenc && row < S && (!causal || col <= row);
            const float s2 = ok ? s[r][c] * scale_log2 : NEG_INF;
            const float p = expf((s2 - slse[lr]) * LN2);
            spt[ty * 4 + r][lr] = round_to<T>(p);
            sds[ty * 4 + r][lr] = round_to<T>(p * (dp[r][c] - sdl[lr]));
          }
        }
        __syncthreads();
        for (int i = 0; i < BQ; ++i) {
          float oi[DC], qi[DC];
#pragma unroll
          for (int c = 0; c < DC; ++c) {
            oi[c] = sdo[i][tx + 16 * c];
            qi[c] = sq[i][tx + 16 * c];
          }
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const float p = spt[ty * 4 + r][i], ds = sds[ty * 4 + r][i];
#pragma unroll
            for (int c = 0; c < DC; ++c) {
              av[r][c] += p * oi[c];
              ak[r][c] += ds * qi[c];
            }
          }
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int key = k0 + ty * 4 + r;
    if (key >= S) continue;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      put(dk + kvoff + (size_t)key * D + tx + 16 * c, scale * ak[r][c]);
      put(dv + kvoff + (size_t)key * D + tx + 16 * c, av[r][c]);
    }
  }
}

template <typename Kern>
int allow_smem(Kern kern, size_t bytes) {
  return (int)cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)bytes);
}

}  // namespace

// D = 64 only (TinyLlama-1.1B); the wrappers raise on other head dims.
// dtype_code: 0 = f32 q/k/v/dO and gradients, 1 = bf16.
extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                            const void* lse, const void* delta, const void* lengths, void* dq,
                            int B, int G, int S, int causal, int dtype_code, float scale_log2,
                            float scale, void* stream) {
  constexpr int D = 64;
  dim3 grid((S + DQ_BQ - 1) / DQ_BQ, G, B);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = dq_smem_bytes<D>();
  if (dtype_code == 1) {
    if (int e = allow_smem(flash_bwd_dq_kernel<__nv_bfloat16, D>, smem)) return e;
    flash_bwd_dq_kernel<__nv_bfloat16, D><<<grid, THREADS, smem, st>>>(
        (const __nv_bfloat16*)q, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v,
        (const __nv_bfloat16*)dout, (const float*)lse, (const float*)delta,
        (const int*)lengths, (__nv_bfloat16*)dq, G, S, scale_log2, scale, causal);
  } else {
    if (int e = allow_smem(flash_bwd_dq_kernel<float, D>, smem)) return e;
    flash_bwd_dq_kernel<float, D><<<grid, THREADS, smem, st>>>(
        (const float*)q, (const float*)k, (const float*)v, (const float*)dout,
        (const float*)lse, (const float*)delta, (const int*)lengths, (float*)dq, G, S,
        scale_log2, scale, causal);
  }
  return (int)cudaGetLastError();
}

extern "C" int flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                             const void* lse, const void* delta, const void* lengths, void* dk,
                             void* dv, int B, int G, int S, int causal, int dtype_code,
                             float scale_log2, float scale, void* stream) {
  constexpr int D = 64;
  dim3 grid((S + KV_BKV - 1) / KV_BKV, B);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = dkv_smem_bytes<D>();
  if (dtype_code == 1) {
    if (int e = allow_smem(flash_bwd_dkv_kernel<__nv_bfloat16, D>, smem)) return e;
    flash_bwd_dkv_kernel<__nv_bfloat16, D><<<grid, THREADS, smem, st>>>(
        (const __nv_bfloat16*)q, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v,
        (const __nv_bfloat16*)dout, (const float*)lse, (const float*)delta,
        (const int*)lengths, (__nv_bfloat16*)dk, (__nv_bfloat16*)dv, G, S, scale_log2, scale,
        causal);
  } else {
    if (int e = allow_smem(flash_bwd_dkv_kernel<float, D>, smem)) return e;
    flash_bwd_dkv_kernel<float, D><<<grid, THREADS, smem, st>>>(
        (const float*)q, (const float*)k, (const float*)v, (const float*)dout,
        (const float*)lse, (const float*)delta, (const int*)lengths, (float*)dk, (float*)dv,
        G, S, scale_log2, scale, causal);
  }
  return (int)cudaGetLastError();
}
