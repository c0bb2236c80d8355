// One-token attention over the quantized KV cache, for Hopper (sm_90a).
//
// Replaces llm_qat_tpu/ops/pallas/decode_attention.py:_decode_attn_kernel
// (quantized_decode_attention, entry point decode_attention) and
// :_decode_attn_stacked_kernel (quantized_decode_attention_stacked, entry
// point decode_attention_stacked: the same kernel on layer l of a stacked
// cache [L, b, kvh, hd, S], read in place through base pointers offset by
// the layer, with the stacked fold contract below). For each slot and kv head: dequantize the
// int8 (or nibble-packed int4) cache columns by their per-token inverse
// scale, rotate K by RoPE at its absolute position from the hoisted
// [hd/2, S] tables ("pre" cache) or not at all ("post" cache), run an fp32
// softmax over the slot's valid columns against their final maximum, then
// fold in the current token's K/V pair (excluded for inactive slots) as one
// more online-softmax term, l clamped at 1e-9.
//
// Layouts: q [b, nh, hd] (f32 or bf16), K/V [b, kvh, hd, S] int8 or
// [b, kvh, hd/2, S] uint8 (low nibble = rows 0..hd/2-1, high = hd/2..hd-1),
// scales [b, S] f32, lengths [b] int32 (pre-append), tables [hd/2, S] f32,
// fold: k_new/v_new [b, kvh, hd] int8, k_inv/v_inv [b] f32, active [b]
// int32, q_cos/q_sin [b, hd/2] f32. Out [b, nh, hd] in q's type.
// Stacked fold (fold = 2): k_new/v_new [b, kvh, hd] in q's type, already
// fake-quantized (K rotated); include_new [b] int32 takes active's place;
// the pair's p rounds to q's type before p.v and, as in the TPU kernel, is
// not zeroed for an excluded pair (exp(-1e30 - m) is 0 unless the slot is
// also empty).
//
// Bound on this card: the cache bytes. Each cached element is read once
// and takes about 2 * G multiply-adds per byte (G = 8 query heads per kv
// head): far below the ~295 operations per byte at which Hopper turns
// compute-bound. Design: one block of 256 threads per (kv head, slot);
// thread j owns cache columns j, j + 256, ..., so the reads along S (the
// contiguous axis of the transposed cache) are coalesced. Pass 1 reads K
// once: dequant, RoPE and the G scores stay in registers, and the scores go
// to shared memory (G * S * 4 bytes, 64 KiB at S = 2048). Pass 2 reads V
// once: p against the final maximum, and the chunk's int8 V columns and
// p * vs go through shared memory for the p.V sum. Both passes run over the
// slot's length only. Keeping the final maximum (no rescaling) makes p, and
// its rounding, the TPU kernel's for lengths up to its 1024-column block.
// The softmax statistics and sums are fp32; with a bf16 q the kernel rounds
// cos*ks, sin*ks, the rotated k and p*vs to bf16 where the TPU kernel does
// (its dots take bf16 operands), so it follows the same numerics.
// Built for (G, hd) = (8, 64) (TinyLlama-1.1B; entry decode_attention) and
// (1, 128) (the MHA heads of the LLaMA-7B family; entry
// decode_attention_g1_d128, contiguous cache only): the scores take G * S
// floats of shared memory, so S <= 32768 / G. Not yet done: splitting S
// across blocks (b * kvh blocks fill a quarter of the card at b = 8, kvh = 4).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int C = 256;        // columns per chunk = threads per block
constexpr int NW = C / 32;
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// bf16 rounding where the TPU kernel computes in bf16 (BF = q is bf16)
template <bool BF>
__device__ __forceinline__ float rb(float v) {
  if constexpr (BF) return __bfloat162float(__float2bfloat16_rn(v));
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o /= 2) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o /= 2) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T, int G, int HD>
__global__ void __launch_bounds__(C)
decode_attn_kernel(const T* __restrict__ q, const uint8_t* __restrict__ kq,
                   const float* __restrict__ ks, const uint8_t* __restrict__ vq,
                   const float* __restrict__ vs, const int* __restrict__ lengths,
                   const float* __restrict__ kcos, const float* __restrict__ ksin,
                   const void* __restrict__ knew_, const float* __restrict__ kinv,
                   const void* __restrict__ vnew_, const float* __restrict__ vinv,
                   const int* __restrict__ active, const float* __restrict__ qcos,
                   const float* __restrict__ qsin, T* __restrict__ out,
                   int kvh, int S, int packed, int rope, int fold, float scale) {
  constexpr int H2 = HD / 2;
  constexpr bool BF = sizeof(T) == 2;
  constexpr int NOUT = (G * HD + C - 1) / C;   // outputs per thread
  extern __shared__ float s_all[];             // [G][S] this slot's scores
  __shared__ float sq[G][HD];
  __shared__ float sp[G][C];
  __shared__ float red[NW][G];
  __shared__ float skf[HD], svf[HD], scur[G];
  __shared__ int8_t sv[C][HD + 4];   // padded: conflict-free column writes

  const int h = blockIdx.x, ib = blockIdx.y, tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const int nh = kvh * G;
  const int len = lengths[ib];
  const int hdc = packed ? H2 : HD;
  const size_t kv_base = ((size_t)ib * kvh + h) * hdc * S;

  for (int i = tid; i < G * HD; i += C)
    sq[i / HD][i % HD] = to_f(q[((size_t)ib * nh + h * G) * HD + i]);
  __syncthreads();

  // pass 1: dequant + RoPE of K, the G scores of each valid column into
  // shared memory, and their maxima
  float m[G], l[G], acc[NOUT];
#pragma unroll
  for (int g = 0; g < G; ++g) { m[g] = NEG_INF; l[g] = 0.f; }
#pragma unroll
  for (int r = 0; r < NOUT; ++r) acc[r] = 0.f;

  for (int col = tid; col < len; col += C) {
    const float ksc = ks[(size_t)ib * S + col];
    float s[G];
#pragma unroll
    for (int g = 0; g < G; ++g) s[g] = 0.f;
    for (int i = 0; i < H2; ++i) {
      float k1, k2;
      if (packed) {
        uint8_t kb = kq[kv_base + (size_t)i * S + col];
        k1 = (float)((int8_t)(kb << 4) >> 4); k2 = (float)((int8_t)kb >> 4);
      } else {
        k1 = (float)(int8_t)kq[kv_base + (size_t)i * S + col];
        k2 = (float)(int8_t)kq[kv_base + (size_t)(i + H2) * S + col];
      }
      float r1, r2;
      if (rope) {
        float cc = rb<BF>(kcos[(size_t)i * S + col] * ksc);
        float ss = rb<BF>(ksin[(size_t)i * S + col] * ksc);
        r1 = rb<BF>(rb<BF>(k1 * cc) - rb<BF>(k2 * ss));
        r2 = rb<BF>(rb<BF>(k2 * cc) + rb<BF>(k1 * ss));
      } else {
        r1 = rb<BF>(k1 * rb<BF>(ksc));
        r2 = rb<BF>(k2 * rb<BF>(ksc));
      }
#pragma unroll
      for (int g = 0; g < G; ++g) s[g] += sq[g][i] * r1 + sq[g][i + H2] * r2;
    }
#pragma unroll
    for (int g = 0; g < G; ++g) {
      s[g] *= scale;
      s_all[g * S + col] = s[g];
      m[g] = fmaxf(m[g], s[g]);
    }
  }
#pragma unroll
  for (int g = 0; g < G; ++g) {
    float wm = warp_max(m[g]);
    if (lane == 0) red[warp][g] = wm;
  }
  __syncthreads();
#pragma unroll
  for (int g = 0; g < G; ++g) {
    float cm = red[0][g];
    for (int w = 1; w < NW; ++w) cm = fmaxf(cm, red[w][g]);
    m[g] = cm;
  }

  // pass 2: p against the slot's final maximum (the TPU kernel's one
  // 1024-column block holds a whole row up to that length, so it never
  // rescales), p * vs rounded as the TPU kernel rounds it, and p.V
  for (int c0 = 0; c0 < len; c0 += C) {
    const int col = c0 + tid;
    if (col < len) {
      const float vsc = rb<BF>(vs[(size_t)ib * S + col]);
      for (int i = 0; i < hdc; ++i) {
        uint8_t vb = vq[kv_base + (size_t)i * S + col];
        if (packed) {
          sv[tid][i] = (int8_t)(vb << 4) >> 4;
          sv[tid][i + H2] = (int8_t)vb >> 4;
        } else {
          sv[tid][i] = (int8_t)vb;
        }
      }
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float p = expf(s_all[g * S + col] - m[g]);
        l[g] += p;
        sp[g][tid] = rb<BF>(p * vsc);
      }
    }
    __syncthreads();
    const int ncol = min(C, len - c0);
#pragma unroll
    for (int r = 0; r < NOUT; ++r) {
      const int o = tid + r * C;
      if (o < G * HD) {
        const int g = o / HD, d = o % HD;
        float a = acc[r];
        for (int j = 0; j < ncol; ++j) a += sp[g][j] * (float)sv[j][d];
        acc[r] = a;
      }
    }
    __syncthreads();
  }
  __syncthreads();   // every thread has read the maxima from red (len = 0)
#pragma unroll
  for (int g = 0; g < G; ++g) {
    float ws = warp_sum(l[g]);
    if (lane == 0) red[warp][g] = ws;
  }
  __syncthreads();
#pragma unroll
  for (int g = 0; g < G; ++g) {
    float cs = 0.f;
    for (int w = 0; w < NW; ++w) cs += red[w][g];
    l[g] = cs;
  }

  if (fold == 2) {
    // stacked contract: the pair arrives as floats in q's type
    const bool inc = active[ib] > 0;
    const T* kn = (const T*)knew_ + ((size_t)ib * kvh + h) * HD;
    const T* vn = (const T*)vnew_ + ((size_t)ib * kvh + h) * HD;
    for (int i = tid; i < HD; i += C) { skf[i] = to_f(kn[i]); svf[i] = to_f(vn[i]); }
    __syncthreads();
    for (int g = tid; g < G; g += C) {
      float sc = 0.f;
      for (int d = 0; d < HD; ++d) sc += sq[g][d] * skf[d];
      scur[g] = sc * scale;
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < NOUT; ++r) {
      const int o = tid + r * C;
      if (o < G * HD) {
        const int g = o / HD, d = o % HD;
        const float sc = inc ? scur[g] : NEG_INF;
        const float m_new = fmaxf(m[g], sc);
        const float al = expf(m[g] - m_new);
        const float p = expf(sc - m_new);
        const float ll = fmaxf(l[g] * al + p, 1e-9f);
        put(out + ((size_t)ib * nh + h * G + g) * HD + d,
            (acc[r] * al + rb<BF>(p) * svf[d]) / ll);
      }
    }
  } else if (fold) {
    // the current token's (K, V) pair, one more online-softmax term
    const int8_t* knew = (const int8_t*)knew_;
    const int8_t* vnew = (const int8_t*)vnew_;
    const bool inc = active[ib] != 0;
    const float ki = kinv[ib], vi = rb<BF>(vinv[ib]);
    const int8_t* kn = knew + ((size_t)ib * kvh + h) * HD;
    const int8_t* vn = vnew + ((size_t)ib * kvh + h) * HD;
    for (int i = tid; i < H2; i += C) {
      float k1 = (float)kn[i], k2 = (float)kn[i + H2];
      if (rope) {
        float cc = rb<BF>(qcos[(size_t)ib * H2 + i] * ki);
        float ss = rb<BF>(qsin[(size_t)ib * H2 + i] * ki);
        skf[i] = rb<BF>(rb<BF>(k1 * cc) - rb<BF>(k2 * ss));
        skf[i + H2] = rb<BF>(rb<BF>(k2 * cc) + rb<BF>(k1 * ss));
      } else {
        skf[i] = rb<BF>(k1 * rb<BF>(ki));
        skf[i + H2] = rb<BF>(k2 * rb<BF>(ki));
      }
      svf[i] = rb<BF>((float)vn[i] * vi);
      svf[i + H2] = rb<BF>((float)vn[i + H2] * vi);
    }
    __syncthreads();
    for (int g = tid; g < G; g += C) {
      float sc = 0.f;
      for (int d = 0; d < HD; ++d) sc += sq[g][d] * skf[d];
      scur[g] = sc * scale;
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < NOUT; ++r) {
      const int o = tid + r * C;
      if (o < G * HD) {
        const int g = o / HD, d = o % HD;
        const float sc = inc ? scur[g] : NEG_INF;
        const float m_new = fmaxf(m[g], sc);
        const float al = expf(m[g] - m_new);
        const float p = inc ? expf(sc - m_new) : 0.f;
        const float ll = fmaxf(l[g] * al + p, 1e-9f);
        put(out + ((size_t)ib * nh + h * G + g) * HD + d, (acc[r] * al + p * svf[d]) / ll);
      }
    }
  } else {
#pragma unroll
    for (int r = 0; r < NOUT; ++r) {
      const int o = tid + r * C;
      if (o < G * HD) {
        const int g = o / HD, d = o % HD;
        put(out + ((size_t)ib * nh + h * G + g) * HD + d, acc[r] / fmaxf(l[g], 1e-9f));
      }
    }
  }
}

template <typename T, int G, int HD>
int launch(const void* q, const void* kq, const void* ks, const void* vq, const void* vs,
           const void* lengths, const void* kcos, const void* ksin, const void* knew,
           const void* kinv, const void* vnew, const void* vinv, const void* active,
           const void* qcos, const void* qsin, void* out, int b, int kvh, int S,
           int packed, int rope, int fold, float scale, cudaStream_t st) {
  dim3 grid(kvh, b);
  const size_t smem = (size_t)G * S * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(decode_attn_kernel<T, G, HD>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  decode_attn_kernel<T, G, HD><<<grid, C, smem, st>>>(
      (const T*)q, (const uint8_t*)kq, (const float*)ks, (const uint8_t*)vq,
      (const float*)vs, (const int*)lengths, (const float*)kcos, (const float*)ksin,
      knew, (const float*)kinv, vnew, (const float*)vinv,
      (const int*)active, (const float*)qcos, (const float*)qsin, (T*)out,
      kvh, S, packed, rope, fold, scale);
  return (int)cudaGetLastError();
}

template <int G, int HD>
int launch_contiguous(const void* q, const void* kq, const void* ks, const void* vq,
                      const void* vs, const void* lengths, const void* kcos, const void* ksin,
                      const void* knew, const void* kinv, const void* vnew, const void* vinv,
                      const void* active, const void* qcos, const void* qsin, void* out, int b,
                      int kvh, int S, int packed, int rope, int fold, int dtype_code,
                      float scale, cudaStream_t st) {
  if (dtype_code == 1)
    return launch<__nv_bfloat16, G, HD>(q, kq, ks, vq, vs, lengths, kcos, ksin, knew, kinv,
                                        vnew, vinv, active, qcos, qsin, out, b, kvh, S,
                                        packed, rope, fold, scale, st);
  return launch<float, G, HD>(q, kq, ks, vq, vs, lengths, kcos, ksin, knew, kinv, vnew, vinv,
                              active, qcos, qsin, out, b, kvh, S, packed, rope, fold, scale,
                              st);
}

}  // namespace

// Groups per kv head 8 and head dim 64 (TinyLlama-1.1B); the wrapper raises
// on other shapes. dtype_code: 0 = f32 q/out, 1 = bf16.
extern "C" int decode_attention(const void* q, const void* kq, const void* ks, const void* vq,
                                const void* vs, const void* lengths, const void* kcos,
                                const void* ksin, const void* knew, const void* kinv,
                                const void* vnew, const void* vinv, const void* active,
                                const void* qcos, const void* qsin, void* out, int b, int kvh,
                                int S, int packed, int rope, int fold, int dtype_code,
                                float scale, void* stream) {
  return launch_contiguous<8, 64>(q, kq, ks, vq, vs, lengths, kcos, ksin, knew, kinv, vnew,
                                  vinv, active, qcos, qsin, out, b, kvh, S, packed, rope, fold,
                                  dtype_code, scale, static_cast<cudaStream_t>(stream));
}

// One query head per kv head at head dim 128 (LLaMA-7B/13B/30B); the same
// arguments.
extern "C" int decode_attention_g1_d128(const void* q, const void* kq, const void* ks,
                                        const void* vq, const void* vs, const void* lengths,
                                        const void* kcos, const void* ksin, const void* knew,
                                        const void* kinv, const void* vnew, const void* vinv,
                                        const void* active, const void* qcos, const void* qsin,
                                        void* out, int b, int kvh, int S, int packed, int rope,
                                        int fold, int dtype_code, float scale, void* stream) {
  return launch_contiguous<1, 128>(q, kq, ks, vq, vs, lengths, kcos, ksin, knew, kinv, vnew,
                                   vinv, active, qcos, qsin, out, b, kvh, S, packed, rope, fold,
                                   dtype_code, scale, static_cast<cudaStream_t>(stream));
}

// The same kernel on layer `layer` of the stacked int8 cache kq_all/vq_all
// [L, b, kvh, 64, S] and scales ks_all/vs_all [L, b, S]: only the base
// pointers move, nothing is copied. k_new/v_new [b, kvh, 64] in q's type,
// include_new [b] int32 (see the header for the fold contract).
extern "C" int decode_attention_stacked(const void* q, const void* kq_all, const void* ks_all,
                                        const void* vq_all, const void* vs_all,
                                        const void* lengths, const void* kcos,
                                        const void* ksin, const void* k_new, const void* v_new,
                                        const void* include_new, void* out, int b, int kvh,
                                        int S, int layer, int rope, int dtype_code,
                                        float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t q_off = (size_t)layer * b * kvh * 64 * S, s_off = (size_t)layer * b * S;
  const uint8_t* kq = (const uint8_t*)kq_all + q_off;
  const uint8_t* vq = (const uint8_t*)vq_all + q_off;
  const float* ks = (const float*)ks_all + s_off;
  const float* vs = (const float*)vs_all + s_off;
  return launch_contiguous<8, 64>(q, kq, ks, vq, vs, lengths, kcos, ksin, k_new, nullptr,
                                  v_new, nullptr, include_new, nullptr, nullptr, out, b, kvh, S,
                                  0, rope, 2, dtype_code, scale, st);
}
