// One-token attention over the paged quantized KV pool, for Hopper (sm_90a).
//
// Replaces llm_qat_tpu/ops/pallas/decode_attention.py:_paged_attn_kernel and
// _paged_attn_kernel_fold (quantized_paged_attention). K and V live in a pool
// of pages shared by all slots; a slot maps logical page pg (positions
// pg*P .. pg*P+P-1) to a pool page through its block table. For each slot
// and kv head the kernel walks the slot's ceil(len/P) live pages in table
// order: dequantize the page's int8 (or nibble-packed int4) columns by their
// per-token inverse scales, rotate K by RoPE at the LOGICAL position from the
// hoisted [hd/2, max_pages*P] tables ("pre" pool) or not at all ("post"),
// score against the G query heads, and run an fp32 online softmax with one
// page a step: the running maximum, the rescale of l and acc, and p * vs
// rounded against the running maximum, exactly where the TPU kernel's grid
// (one page a grid step) does them. Then the current token's K/V pair is
// folded in as one more term (excluded for inactive slots), l is clamped at
// 1e-9 and the sum divided. Table entries past a slot's live pages and
// columns at or past its length are never read.
//
// Layouts: q [b, nh, hd] (f32 or bf16); pool K/V [n_pages, kvh, hd, P] int8
// or [n_pages, kvh, hd/2, P] uint8 (low nibble = rows 0..hd/2-1, high =
// hd/2..hd-1); scales [n_pages, P] f32; lengths [b] int32 (pre-append with
// fold); block tables [b, max_pages] int32; RoPE tables [hd/2, max_pages*P]
// f32; fold: k_new/v_new [b, kvh, hd] int8, k_inv/v_inv [b] f32, active [b]
// int32, q_cos/q_sin [b, hd/2] f32. Out [b, nh, hd] in q's type.
//
// Bound on this card: the live pages' bytes. Each cached element is read
// once and takes about 2 * G multiply-adds per byte, far below the ~295
// operations per byte at which Hopper turns compute-bound. Design: one
// block of P = 128 threads per (kv head, slot); thread j owns column j of
// the page, so every row of a page (128 contiguous bytes, one kv head's
// page is hd x 128 contiguous bytes) is one coalesced load, as are the
// page's scales and its RoPE table columns. The scores of a column stay in
// registers; p * vs and the page's V columns go through shared memory for
// the p.V sum, where a thread owns outputs (g, d). With a bf16 q the kernel
// rounds cos*ks, sin*ks, the rotated k and p*vs to bf16 where the TPU
// kernel does. Not yet done: a slot's pages split over blocks (b * kvh
// blocks fill a quarter of the card at b = 8, kvh = 4), cp.async or TMA for
// the page loads, tensor-core products.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int P = 128;        // page size = columns per step = threads per block
constexpr int NW = P / 32;
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
__global__ void __launch_bounds__(P)
paged_attn_kernel(const T* __restrict__ q, const uint8_t* __restrict__ kq,
                  const float* __restrict__ ks, const uint8_t* __restrict__ vq,
                  const float* __restrict__ vs, const int* __restrict__ lengths,
                  const int* __restrict__ tables, const float* __restrict__ kcos,
                  const float* __restrict__ ksin, const int8_t* __restrict__ knew,
                  const float* __restrict__ kinv, const int8_t* __restrict__ vnew,
                  const float* __restrict__ vinv, const int* __restrict__ active,
                  const float* __restrict__ qcos, const float* __restrict__ qsin,
                  T* __restrict__ out, int kvh, int max_pages, int packed, int rope,
                  int fold, float scale) {
  constexpr int H2 = HD / 2;
  constexpr bool BF = sizeof(T) == 2;
  constexpr int NOUT = (G * HD + P - 1) / P;   // outputs per thread
  __shared__ float sq[G][HD];
  __shared__ float sp[G][P];
  __shared__ float red_m[NW][G], red_l[NW][G];
  __shared__ float skf[HD], svf[HD], scur[G];
  __shared__ int8_t sv[P][HD + 4];   // padded: conflict-free column writes

  const int h = blockIdx.x, ib = blockIdx.y, tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const int nh = kvh * G;
  const int len = lengths[ib];
  const int hdc = packed ? H2 : HD;
  const size_t ST = (size_t)max_pages * P;     // RoPE table row stride
  const int live_pages = (len + P - 1) / P;

  for (int i = tid; i < G * HD; i += P)
    sq[i / HD][i % HD] = to_f(q[((size_t)ib * nh + h * G) * HD + i]);
  __syncthreads();

  float m[G], l[G], acc[NOUT];
#pragma unroll
  for (int g = 0; g < G; ++g) { m[g] = NEG_INF; l[g] = 0.f; }
#pragma unroll
  for (int r = 0; r < NOUT; ++r) acc[r] = 0.f;

  for (int pg = 0; pg < live_pages; ++pg) {
    const int pid = tables[(size_t)ib * max_pages + pg];
    const size_t base = ((size_t)pid * kvh + h) * hdc * P;
    const int col = pg * P + tid;              // logical position
    const bool valid = col < len;

    // scores of this thread's column against the G query heads
    float s[G];
#pragma unroll
    for (int g = 0; g < G; ++g) s[g] = 0.f;
    float vsc = 0.f;
    if (valid) {
      const float ksc = ks[(size_t)pid * P + tid];
      vsc = rb<BF>(vs[(size_t)pid * P + tid]);
      for (int i = 0; i < H2; ++i) {
        float k1, k2;
        if (packed) {
          uint8_t kb = kq[base + (size_t)i * P + tid];
          k1 = (float)((int8_t)(kb << 4) >> 4); k2 = (float)((int8_t)kb >> 4);
        } else {
          k1 = (float)(int8_t)kq[base + (size_t)i * P + tid];
          k2 = (float)(int8_t)kq[base + (size_t)(i + H2) * P + tid];
        }
        float r1, r2;
        if (rope) {
          float cc = rb<BF>(kcos[(size_t)i * ST + col] * ksc);
          float ss = rb<BF>(ksin[(size_t)i * ST + col] * ksc);
          r1 = rb<BF>(rb<BF>(k1 * cc) - rb<BF>(k2 * ss));
          r2 = rb<BF>(rb<BF>(k2 * cc) + rb<BF>(k1 * ss));
        } else {
          r1 = rb<BF>(k1 * rb<BF>(ksc));
          r2 = rb<BF>(k2 * rb<BF>(ksc));
        }
#pragma unroll
        for (int g = 0; g < G; ++g) s[g] += sq[g][i] * r1 + sq[g][i + H2] * r2;
      }
      // this column's V, unpacked, for the p.V sum
      for (int i = 0; i < hdc; ++i) {
        uint8_t vb = vq[base + (size_t)i * P + tid];
        if (packed) {
          sv[tid][i] = (int8_t)(vb << 4) >> 4;
          sv[tid][i + H2] = (int8_t)vb >> 4;
        } else {
          sv[tid][i] = (int8_t)vb;
        }
      }
    }
#pragma unroll
    for (int g = 0; g < G; ++g) {
      s[g] = valid ? s[g] * scale : NEG_INF;
      float wm = warp_max(s[g]);
      if (lane == 0) red_m[warp][g] = wm;
    }
    __syncthreads();

    // the page's online-softmax step: new maximum, rescale, p against it
    float alpha[G];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float bm = red_m[0][g];
#pragma unroll
      for (int w = 1; w < NW; ++w) bm = fmaxf(bm, red_m[w][g]);
      const float m_new = fmaxf(m[g], bm);
      alpha[g] = expf(m[g] - m_new);
      const float p = valid ? expf(s[g] - m_new) : 0.f;
      sp[g][tid] = rb<BF>(p * vsc);
      float ws = warp_sum(p);
      if (lane == 0) red_l[warp][g] = ws;
      m[g] = m_new;
    }
    __syncthreads();
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float ps = red_l[0][g];
#pragma unroll
      for (int w = 1; w < NW; ++w) ps += red_l[w][g];
      l[g] = l[g] * alpha[g] + ps;
    }
    const int ncol = min(P, len - pg * P);
#pragma unroll
    for (int r = 0; r < NOUT; ++r) {
      const int o = tid + r * P;
      if (o < G * HD) {
        const int g = o / HD, d = o % HD;
        float a = 0.f;
        for (int j = 0; j < ncol; ++j) a += sp[g][j] * (float)sv[j][d];
        acc[r] = acc[r] * alpha[g] + a;
      }
    }
    __syncthreads();   // sp, sv and the reduction rows are rewritten next page
  }

  if (fold) {
    // the current token's (K, V) pair, one more online-softmax term
    const bool inc = active[ib] != 0;
    const float ki = kinv[ib], vi = rb<BF>(vinv[ib]);
    const int8_t* kn = knew + ((size_t)ib * kvh + h) * HD;
    const int8_t* vn = vnew + ((size_t)ib * kvh + h) * HD;
    for (int i = tid; i < H2; i += P) {
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
    for (int g = tid; g < G; g += P) {
      float sc = 0.f;
      for (int d = 0; d < HD; ++d) sc += sq[g][d] * skf[d];
      scur[g] = sc * scale;
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < NOUT; ++r) {
      const int o = tid + r * P;
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
      const int o = tid + r * P;
      if (o < G * HD) {
        const int g = o / HD, d = o % HD;
        put(out + ((size_t)ib * nh + h * G + g) * HD + d, acc[r] / fmaxf(l[g], 1e-9f));
      }
    }
  }
}

struct Args {
  const void *q, *kq, *ks, *vq, *vs, *lengths, *tables, *kcos, *ksin, *knew, *kinv, *vnew,
      *vinv, *active, *qcos, *qsin;
  void* out;
  int b, kvh, max_pages, packed, rope, fold;
  float scale;
  cudaStream_t st;
};

template <typename T, int G, int HD>
int launch(const Args& a) {
  dim3 grid(a.kvh, a.b);
  paged_attn_kernel<T, G, HD><<<grid, P, 0, a.st>>>(
      (const T*)a.q, (const uint8_t*)a.kq, (const float*)a.ks, (const uint8_t*)a.vq,
      (const float*)a.vs, (const int*)a.lengths, (const int*)a.tables, (const float*)a.kcos,
      (const float*)a.ksin, (const int8_t*)a.knew, (const float*)a.kinv,
      (const int8_t*)a.vnew, (const float*)a.vinv, (const int*)a.active,
      (const float*)a.qcos, (const float*)a.qsin, (T*)a.out, a.kvh, a.max_pages, a.packed,
      a.rope, a.fold, a.scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_shape(const Args& a, int G, int hd) {
  if (G == 8 && hd == 64) return launch<T, 8, 64>(a);     // TinyLlama-1.1B
  if (G == 1 && hd == 128) return launch<T, 1, 128>(a);   // LLaMA-7B/13B/30B
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// (G, hd) = (8, 64) or (1, 128), page size 128; the wrapper raises on other
// shapes. dtype_code: 0 = f32 q/out, 1 = bf16. The pool's page count is not
// an argument: the tables index the pool.
extern "C" int paged_attention(const void* q, const void* kq, const void* ks, const void* vq,
                               const void* vs, const void* lengths, const void* tables,
                               const void* kcos, const void* ksin, const void* knew,
                               const void* kinv, const void* vnew, const void* vinv,
                               const void* active, const void* qcos, const void* qsin,
                               void* out, int b, int kvh, int G, int hd, int max_pages,
                               int packed, int rope, int fold, int dtype_code, float scale,
                               void* stream) {
  Args a{q, kq, ks, vq, vs, lengths, tables, kcos, ksin, knew, kinv, vnew, vinv, active,
         qcos, qsin, out, b, kvh, max_pages, packed, rope, fold, scale,
         static_cast<cudaStream_t>(stream)};
  if (dtype_code == 1) return launch_shape<__nv_bfloat16>(a, G, hd);
  return launch_shape<float>(a, G, hd);
}
