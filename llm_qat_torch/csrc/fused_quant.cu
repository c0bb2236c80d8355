// Producer-fused activation quantization, for Hopper (sm_90a).
//
// rmsnorm_quant replaces llm_qat_tpu/ops/pallas/fused_quant.py:
// _rmsnorm_quant_kernel (rmsnorm_quant): RMSNorm accumulated in fp32, rounded
// to h's type, times the fp32 gain, rounded to the promoted type of h and the
// gain, then per-row symmetric quantization: s = qmax / (absmax + 1e-6),
// q = round_half_even(x * s) as int8, s as f32.
//
// silu_mul_quant replaces _silu_mul_quant_kernel (silu_mul_quant): sigmoid in
// fp32 rounded to gate's type, gate * sig and then * up each rounded to that
// type, then the same per-row quantization.
//
// Bound on this card: bytes. Each reads its input once (2 or 4 bytes an
// element; two inputs for silu_mul_quant) and writes one byte an element plus
// a scale a row; the arithmetic is a few operations an element. Design: one
// block per row, the row's values held in shared memory as fp32 between the
// two block reductions (sum of squares, absmax), so device memory is touched
// once each way. The mean is sum * (1/K), the division for the scale is
// __fdiv_rn, the rounding rintf: the arithmetic of the plain PyTorch version
// but for the order of the fp32 sum of squares.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}
template <typename T> __device__ __forceinline__ float round_to(float v);
template <> __device__ __forceinline__ float round_to<float>(float v) { return v; }
template <> __device__ __forceinline__ float round_to<__nv_bfloat16>(float v) {
  return round_bf16(v);
}

// sum (MAX = false) or maximum (MAX = true) over the block; every thread
// gets the result. red holds one slot a warp.
template <bool MAX>
__device__ __forceinline__ float block_reduce(float v, float* red) {
#pragma unroll
  for (int off = 16; off > 0; off /= 2) {
    float o = __shfl_xor_sync(0xffffffffu, v, off);
    v = MAX ? fmaxf(v, o) : v + o;
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  __syncthreads();               // red may still be read from the last call
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float r = red[0];
#pragma unroll
  for (int w = 1; w < THREADS / 32; ++w) r = MAX ? fmaxf(r, red[w]) : r + red[w];
  return r;
}

__device__ __forceinline__ void quantize_row(const float* row, int K, float qmax,
                                             int8_t* q, float* s_out, float* red) {
  float am = 0.f;
  for (int i = threadIdx.x; i < K; i += THREADS) am = fmaxf(am, fabsf(row[i]));
  am = block_reduce<true>(am, red);
  const float s = __fdiv_rn(qmax, am + 1e-6f);
  for (int i = threadIdx.x; i < K; i += THREADS) q[i] = (int8_t)(int)rintf(row[i] * s);
  if (threadIdx.x == 0) *s_out = s;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
rmsnorm_quant_kernel(const T* __restrict__ h, const float* __restrict__ g,
                     int8_t* __restrict__ xq, float* __restrict__ sx, int K, float eps,
                     float qmax, float inv_k, int round_out_bf16) {
  extern __shared__ float row[];          // K values
  __shared__ float red[THREADS / 32];
  const size_t base = (size_t)blockIdx.x * K;
  float ss = 0.f;
  for (int i = threadIdx.x; i < K; i += THREADS) {
    float v = to_f(h[base + i]);
    row[i] = v;
    ss += __fmul_rn(v, v);          // the square rounds before the sum, as in the plain version
  }
  ss = block_reduce<false>(ss, red);
  const float r = rsqrtf(ss * inv_k + eps);
  for (int i = threadIdx.x; i < K; i += THREADS) {
    float xn = round_to<T>(row[i] * r) * g[i];
    row[i] = round_out_bf16 ? round_bf16(xn) : xn;
  }
  quantize_row(row, K, qmax, xq + base, sx + blockIdx.x, red);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
silu_mul_quant_kernel(const T* __restrict__ gate, const T* __restrict__ up,
                      int8_t* __restrict__ yq, float* __restrict__ sy, int K, float qmax) {
  extern __shared__ float row[];
  __shared__ float red[THREADS / 32];
  const size_t base = (size_t)blockIdx.x * K;
  for (int i = threadIdx.x; i < K; i += THREADS) {
    const float gv = to_f(gate[base + i]);
    const float sig = round_to<T>(__fdiv_rn(1.0f, 1.0f + expf(-gv)));
    row[i] = round_to<T>(round_to<T>(gv * sig) * to_f(up[base + i]));
  }
  quantize_row(row, K, qmax, yq + base, sy + blockIdx.x, red);
}

template <typename Kern>
int prepare(Kern kern, size_t smem) {
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}

}  // namespace

// dtype_code: 0 = f32 input, 1 = bf16. round_out_bf16: the product with the
// gain rounds to bf16 (bf16 input with a bf16 gain).
extern "C" int rmsnorm_quant(const void* h, const void* g, void* xq, void* sx, int M, int K,
                             int dtype_code, int round_out_bf16, float eps, float qmax,
                             float inv_k, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = (size_t)K * sizeof(float);
  if (dtype_code == 1) {
    if (int e = prepare(rmsnorm_quant_kernel<__nv_bfloat16>, smem)) return e;
    rmsnorm_quant_kernel<__nv_bfloat16><<<M, THREADS, smem, st>>>(
        (const __nv_bfloat16*)h, (const float*)g, (int8_t*)xq, (float*)sx, K, eps, qmax,
        inv_k, round_out_bf16);
  } else {
    if (int e = prepare(rmsnorm_quant_kernel<float>, smem)) return e;
    rmsnorm_quant_kernel<float><<<M, THREADS, smem, st>>>(
        (const float*)h, (const float*)g, (int8_t*)xq, (float*)sx, K, eps, qmax, inv_k,
        0);
  }
  return (int)cudaGetLastError();
}

extern "C" int silu_mul_quant(const void* gate, const void* up, void* yq, void* sy, int M,
                              int K, int dtype_code, float qmax, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = (size_t)K * sizeof(float);
  if (dtype_code == 1) {
    if (int e = prepare(silu_mul_quant_kernel<__nv_bfloat16>, smem)) return e;
    silu_mul_quant_kernel<__nv_bfloat16><<<M, THREADS, smem, st>>>(
        (const __nv_bfloat16*)gate, (const __nv_bfloat16*)up, (int8_t*)yq, (float*)sy, K, qmax);
  } else {
    if (int e = prepare(silu_mul_quant_kernel<float>, smem)) return e;
    silu_mul_quant_kernel<float><<<M, THREADS, smem, st>>>(
        (const float*)gate, (const float*)up, (int8_t*)yq, (float*)sy, K, qmax);
  }
  return (int)cudaGetLastError();
}
