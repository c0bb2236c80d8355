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
// Bound on this card: operations (dQ three products, dK/dV four, against a
// few bytes an element), at the bf16 tensor-core rate.
//
// Head dims 16, 32, 64 and 128, in bf16 and in f32: one entry per head dim
// and kernel (flash_bwd_dq / flash_bwd_dkv are 64, the _d16 / _d32 / _d128
// entries the others); and every other hd with hd % 4 == 0 and
// 32 < hd <= 128 (OpenLLaMA-3B's 100, 48, 80, 96) through
// flash_bwd_dq_dpad / flash_bwd_dkv_dpad: the D = 128 kernels built with
// PAD, hd an argument, as the forward's flash_fwd_dpad. Global memory keeps
// rows of hd values (2 hd bytes, 8-byte aligned at hd 100, so the bf16 tiles
// arrive in 8-byte cp.async pieces, tc_bf16.cuh load_tile_hd; the f32 rows
// element by element); the shared tiles are 128 wide with the columns past
// hd zero, which add exact zeros to q.k and dO.v; the 16-deep chunks of those
// products and the 16-wide output column pairs wholly past hd are skipped,
// and output columns past hd are never written. The scales come from the
// true hd (the caller's). Every padded difference sits behind PAD, so the
// power-of-two builds compile to the code they had.
//
// bf16: tensor cores, mma.sync m16n8k16 bf16 x bf16 ->
// fp32 (exactly the contract's bf16 operands and fp32 sums); tiles arrive
// by cp.async in the swizzled layout of tc_bf16.cuh and are read by
// ldmatrix (.trans for the second products). Every rounding the contract
// names is written out (__fmul_rn / __fsub_rn): a contracted fma would move
// p or ds across a bf16 step. No atomics: every output row has one owner,
// so the same bits come out every run.
//
// dQ: one block of 4 warps per (B, g, 64 query rows), each warp 16 rows,
// the heaviest query blocks launched first. Q and dO arrive once and stay in
// registers as A fragments, with the thread's two rows of lse * log2 e and
// delta; 64-key K and V tiles stream through a 2-stage cp.async ring over
// the live tiles only (up to the diagonal when causal, none past the
// length). Per tile S = Q.K^T and dP = dO.V^T (B fragments from K and V
// rows), the mask (element by element only on the diagonal and length-edge
// tiles), p and ds in fp32, ds rounded to bf16 straight into A fragments,
// then dQ += dS.K with K's B fragments by ldmatrix.trans. At D = 128 a tile
// is taken 32 keys at a time (S and dP in half the registers), so that the
// resident Q and dO fragments (64 registers) and the dQ accumulator (64)
// fit without spilling. dQ stays in registers and is written once.
//
// dK/dV: a block of 4 warps owns 64 keys, each warp 16; the K and V tiles
// arrive once. The block loops over the G query heads and the live 64-row
// query tiles (from the diagonal on when causal); Q, dO, lse and delta
// stream through a 2-stage cp.async ring. Per tile S^T = K.Q^T and
// dP^T = V.dO^T (fp32 fragments), the mask (element by element only on the
// diagonal, length-edge and row-edge tiles), p and ds in fp32, both rounded
// to bf16 straight into A fragments, then dV += P^T.dO and dK += dS^T.Q
// with B fragments by ldmatrix.trans. dK and dV stay in registers: the sum
// over G never leaves the block; keys past the length get exact zeros. At
// D = 64 the K and V A fragments stay in registers and a query tile is one
// step; at D = 128 the dK and dV accumulators alone take 128 registers, so
// the K and V fragments are read again from their resident shared tiles and
// a tile is taken 16 rows at a time (at 32 rows the compiler spilled).
// Balance: key block kb shares a thread block with key block nkb - 1 - kb,
// one after the other, so every block
// walks S/64 + 1 query tiles a head when causal (the middle key block runs
// alone when nkb is odd); each key block still has one owner.
//
// f32: SIMT kernels, products on the fp32 units through fp32
// shared-memory tiles (dynamic shared memory: 107 KB for dQ and 116 KB for
// dK/dV at D = 128, one block an SM there), each of 16 threads of a row
// owning D / 16 output columns. dQ: one block per (B, g, 64 query rows), a loop over
// the live 32-key tiles (causal and length), dQ in registers, one write.
// dK/dV: one block per (B, 64 keys), the same loops as the bf16 kernel over
// 32-row tiles. Tensor cores would need TF32 operands in f32 (about three
// decimal digits), which the f32 contract (1e-5) does not allow.

// Launch bounds: the f32 kernels, and the bf16 kernels at head dims 16 and
// 32 (the *_narrow_kernel instantiations of one body), name one block an SM
// as their minimum. With the thread count alone, ptxas held them (and the
// f32 dQ kernel at D = 64) to 64 or 128 registers a thread and spilled to
// local memory; with the minimum stated it gives them what they use,
// without a spill (kernel_attributes()). The bf16 kernels at 64 and 128 keep
// the thread count alone, and so the code they had.
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

constexpr int THREADS = 256;
constexpr float NEG_INF = -1e30f;
constexpr float LN2 = 0.6931471805599453f;
constexpr float LOG2E = 1.4426950408889634f;

// rows [r0, r0 + n) of a [rows_total, D] matrix at src into dst[n][D + 1],
// zeros past rows_total; PAD: of a [rows_total, hd] matrix, zeros also in
// the columns [hd, D)
template <int D, bool PAD>
__device__ __forceinline__ void load_tile(float (*dst)[D + 1], const float* src, int r0, int n,
                                          int rows_total, int hd) {
  for (int i = threadIdx.x; i < n * D; i += THREADS) {
    const int r = i / D, d = i % D;
    if constexpr (PAD)
      dst[r][d] = r0 + r < rows_total && d < hd ? src[(size_t)(r0 + r) * hd + d] : 0.f;
    else
      dst[r][d] = r0 + r < rows_total ? src[(size_t)(r0 + r) * D + d] : 0.f;
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

// PAD: rows of hd <= D values in global memory (zeros past hd in the tiles)
template <int D, bool PAD>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    const int* __restrict__ lengths, float* __restrict__ dq, int G, int S,
                    float scale_log2, float scale, int causal, int hd) {
  constexpr int BQ = DQ_BQ, BKV = DQ_BKV, DC = D / 16;
  const int HD = PAD ? hd : D;              // values a row in global memory
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
  const size_t qoff = ((size_t)b * G + grp) * S * HD;
  const size_t kvoff = (size_t)b * S * HD;
  const size_t roff = ((size_t)b * G + grp) * S;

  load_tile<D, PAD>(sq, q + qoff, q0, BQ, S, HD);
  load_tile<D, PAD>(sdo, dout + qoff, q0, BQ, S, HD);
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
    load_tile<D, PAD>(sk, k + kvoff, k0, BKV, S, HD);
    load_tile<D, PAD>(sv, v + kvoff, k0, BKV, S, HD);
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
        sp[ty * 4 + r][tx * 2 + c] = p * (dp[r][c] - dl[r]);
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
      if (!PAD || tx + 16 * c < HD) dq[qoff + (size_t)row * HD + tx + 16 * c] = scale * acc[r][c];
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

template <int D, bool PAD>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     const int* __restrict__ lengths, float* __restrict__ dk,
                     float* __restrict__ dv, int G, int S, float scale_log2, float scale,
                     int causal, int hd) {
  constexpr int BKV = KV_BKV, BQ = KV_BQ, DC = D / 16;
  const int HD = PAD ? hd : D;              // values a row in global memory
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
  const size_t kvoff = (size_t)b * S * HD;

  float ak[4][DC], av[4][DC];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < DC; ++c) ak[r][c] = av[r][c] = 0.f;

  if (k0 < lenc) {                         // else every column is masked: p = 0
    load_tile<D, PAD>(sk, k + kvoff, k0, BKV, S, HD);
    load_tile<D, PAD>(sv, v + kvoff, k0, BKV, S, HD);
    const int nqt = (S + BQ - 1) / BQ;
    const int first = causal ? k0 / BQ : 0;
    for (int grp = 0; grp < G; ++grp) {
      const size_t qoff = ((size_t)b * G + grp) * S * HD;
      const size_t roff = ((size_t)b * G + grp) * S;
      for (int iq = first; iq < nqt; ++iq) {
        const int q0 = iq * BQ;
        __syncthreads();                   // the last tile's sq, sdo, spt, sds are read no more
        load_tile<D, PAD>(sq, q + qoff, q0, BQ, S, HD);
        load_tile<D, PAD>(sdo, dout + qoff, q0, BQ, S, HD);
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
            spt[ty * 4 + r][lr] = p;
            sds[ty * 4 + r][lr] = p * (dp[r][c] - sdl[lr]);
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
      if (PAD && tx + 16 * c >= HD) continue;
      dk[kvoff + (size_t)key * HD + tx + 16 * c] = scale * ak[r][c];
      dv[kvoff + (size_t)key * HD + tx + 16 * c] = av[r][c];
    }
  }
}

// ---------------------------------------------------------------------------
// dK, dV in bf16: tensor cores
// ---------------------------------------------------------------------------

using namespace tc_bf16;
constexpr int TC_BK = 64, TC_BQ = 64, TC_THREADS = 128;   // 4 warps x 16 keys
static_assert(TC_BK == TC_BQ, "one tile height for every operand (the kernels' tile())");

template <int D>
__host__ __device__ constexpr int dkv_tc_stage() {
  return 2 * TC_BQ * D * 2 + 2 * TC_BQ * 4;   // Q, dO, then lse and delta
}
template <int D>
__host__ __device__ constexpr int dkv_tc_smem() {
  return 2 * TC_BK * D * 2 + 2 * dkv_tc_stage<D>();   // K, V, 2 stages
}

// Register plans by head dim (see the header): the query rows of a dK/dV
// inner step, the keys of a dQ inner step, and whether dK/dV keeps the K and
// V A fragments in registers
template <int D>
__host__ __device__ constexpr int dkv_step_rows() { return D <= 64 ? 64 : 16; }
template <int D>
__host__ __device__ constexpr int dq_step_keys() { return D <= 64 ? 64 : 32; }
template <int D>
__host__ __device__ constexpr bool kv_in_registers() { return D <= 64; }

#define DKV_TC_PARAMS                                                                        \
  const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,       \
      const bf16* __restrict__ dout, const float* __restrict__ lse,                         \
      const float* __restrict__ delta, const int* __restrict__ lengths, bf16* __restrict__ dk, \
      bf16* __restrict__ dv, int G, int S, float scale_log2, float scale, int causal, int hd
#define DKV_TC_ARGS \
  q, k, v, dout, lse, delta, lengths, dk, dv, G, S, scale_log2, scale, causal, hd

// PAD: rows of hd <= D values in global memory (load_tile_hd; the chunks
// and column pairs wholly past hd skipped, their outputs not written)
template <int D, bool PAD>
__device__ __forceinline__ void flash_bwd_dkv_tc_body(DKV_TC_PARAMS) {
  constexpr int KC = D / 16;          // 16-deep chunks of the products over d
  constexpr int QW = dkv_step_rows<D>();   // query rows of an inner step
  constexpr int NT = QW / 8;          // 8-row column tiles of S^T and dP^T in a step
  constexpr int DT = D / 8;           // 8-wide column tiles of dK and dV
  constexpr bool KV_REGS = kv_in_registers<D>();
  constexpr int TILE = TC_BQ * D * 2, STAGE = dkv_tc_stage<D>();
  extern __shared__ __align__(128) unsigned char tc_smem[];
  const uint32_t sk = smem_u32(tc_smem), sv = sk + TC_BK * D * 2;
  const uint32_t ring = sv + TC_BK * D * 2;    // stage s: Q, dO, lse, delta at ring + s * STAGE
  const float* fring = reinterpret_cast<const float*>(tc_smem + 2 * TC_BK * D * 2);

  const int b = blockIdx.y, nkb = (S + TC_BK - 1) / TC_BK, nqt = (S + TC_BQ - 1) / TC_BQ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int lenc = max(lengths[b], 1);
  const int HD = PAD ? hd : D;          // values a row in global memory
  const size_t kvoff = (size_t)b * S * HD;
  // rows [r0, r0 + 64) of a [S, HD] matrix into a swizzled shared tile
  auto tile = [&](uint32_t dst, const bf16* src, int r0) {
    if constexpr (PAD) load_tile_hd<D, TC_BQ, TC_THREADS>(dst, src, r0, S, HD);
    else tc_bf16::load_tile<D, TC_BQ, TC_THREADS>(dst, src, r0, S);
  };

  for (int half = 0; half < 2; ++half) {
    // key blocks kb and nkb - 1 - kb share this block: the same causal work in every block
    const int kb = half ? nkb - 1 - (int)blockIdx.x : (int)blockIdx.x;
    if (half && kb == (int)blockIdx.x) break;   // odd nkb: the middle key block runs alone
    const int k0 = kb * TC_BK, kw = k0 + warp * 16;   // the warp's first key
    float dka[DT][4], dva[DT][4];
#pragma unroll
    for (int j = 0; j < DT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) dka[j][e] = dva[j][e] = 0.f;

    if (k0 < lenc) {                     // else every column is masked: p = 0
      const int first = causal ? k0 / TC_BQ : 0, nlive = nqt - first, ntile = G * nlive;
      // copies of tile `it` (query head it / nlive, its (it % nlive)-th live
      // query tile) into stage it % 2
      auto issue = [&](int it) {
        const int q0 = (first + it % nlive) * TC_BQ;
        const size_t r0 = ((size_t)b * G + it / nlive) * S;
        const uint32_t st = ring + (it & 1) * STAGE;
        tile(st, q + r0 * HD, q0);
        tile(st + TILE, dout + r0 * HD, q0);
        const int i = threadIdx.x % TC_BQ, which = threadIdx.x / TC_BQ;   // lse, then delta
        const bool in = q0 + i < S;
        cp_async4(st + 2 * TILE + (which * TC_BQ + i) * 4,
                  (which ? delta : lse) + r0 + (in ? q0 + i : 0), in);
      };
      __syncthreads();                   // the last key block's tiles are read no more
      tile(sk, k + kvoff, k0);
      tile(sv, v + kvoff, k0);
      cp_async_commit();
      issue(0);
      cp_async_commit();
      cp_async_wait<1>();
      __syncthreads();
      uint32_t ka[KV_REGS ? KC : 1][4], va[KV_REGS ? KC : 1][4];
      if constexpr (KV_REGS) {
#pragma unroll
        for (int kc = 0; kc < KC; ++kc) {
          ldsm_x4(a_addr<D>(sk, warp * 16, kc, lane), ka[kc]);
          ldsm_x4(a_addr<D>(sv, warp * 16, kc, lane), va[kc]);
        }
      }

      for (int it = 0; it < ntile; ++it) {
        const int q0 = (first + it % nlive) * TC_BQ;
        const uint32_t sq = ring + (it & 1) * STAGE, sdo = sq + TILE;
        const float* slse = fring + ((it & 1) * STAGE + 2 * TILE) / 4;
        const float* sdl = slse + TC_BQ;
        if (it + 1 < ntile) {            // the next tile's copy overlaps this tile's products
          issue(it + 1);
          cp_async_commit();
          cp_async_wait<1>();
        } else {
          cp_async_wait<0>();
        }
        __syncthreads();
        // element masks only on the length-edge, row-edge and diagonal tiles
        const bool edge = k0 + TC_BK > lenc || q0 + TC_BQ > S || (causal && q0 < k0 + TC_BK);

        // the step's first row in the tile; the steps stay rolled (one step at
        // D = 64): unrolled, the compiler overlaps them and spills at D = 128
#pragma unroll 1
        for (int r0 = 0; r0 < TC_BQ; r0 += QW) {
          float s[NT][4], dp[NT][4];
#pragma unroll
          for (int j = 0; j < NT; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
          for (int kc = 0; kc < KC; ++kc) {
            if (PAD && kc * 16 >= HD) continue;   // zero columns only
            uint32_t kf[4], vf[4];
            if constexpr (KV_REGS) {
#pragma unroll
              for (int e = 0; e < 4; ++e) kf[e] = ka[kc][e], vf[e] = va[kc][e];
            } else {
              ldsm_x4(a_addr<D>(sk, warp * 16, kc, lane), kf);
              ldsm_x4(a_addr<D>(sv, warp * 16, kc, lane), vf);
            }
#pragma unroll
            for (int np = 0; np < NT / 2; ++np) {
              uint32_t qf[4], of[4];
              ldsm_x4(b_addr<D>(sq, r0 + np * 16, kc, lane), qf);
              ldsm_x4(b_addr<D>(sdo, r0 + np * 16, kc, lane), of);
              mma(s[2 * np], kf, qf[0], qf[1]);
              mma(s[2 * np + 1], kf, qf[2], qf[3]);
              mma(dp[2 * np], vf, of[0], of[1]);
              mma(dp[2 * np + 1], vf, of[2], of[3]);
            }
          }
#pragma unroll
          for (int j = 0; j < NT; ++j) {
            const int lr = r0 + j * 8 + 2 * t;
            const float2 l2 = *reinterpret_cast<const float2*>(slse + lr);
            const float2 d2 = *reinterpret_cast<const float2*>(sdl + lr);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int key = kw + g + (e >> 1) * 8, row = q0 + lr + (e & 1);
              const bool ok = !edge || (key < lenc && row < S && (!causal || key <= row));
              // _rn: each product and difference rounds on its own, as in the
              // plain version; a contracted fma would round p across a bf16 step
              const float s2 = ok ? __fmul_rn(s[j][e], scale_log2) : NEG_INF;
              const float lse2 = __fmul_rn((e & 1) ? l2.y : l2.x, LOG2E);
              const float p = expf(__fmul_rn(__fsub_rn(s2, lse2), LN2));
              s[j][e] = p;
              dp[j][e] = __fmul_rn(p, __fsub_rn(dp[j][e], (e & 1) ? d2.y : d2.x));
            }
          }
          // dV += P^T . dO and dK += dS^T . Q, P and dS rounded to bf16: query
          // rows [16c, 16c + 16) of the step are the A fragment of that chunk
#pragma unroll
          for (int c = 0; c < QW / 16; ++c) {
            uint32_t pa[4], da[4];
            acc_to_a(s[2 * c], s[2 * c + 1], pa);
            acc_to_a(dp[2 * c], dp[2 * c + 1], da);
#pragma unroll
            for (int np = 0; np < DT / 2; ++np) {
              if (PAD && np * 16 >= HD) continue;   // output columns past hd
              uint32_t of[4], qf[4];
              ldsm_x4_t(t_addr<D>(sdo, r0 / 16 + c, np, lane), of);
              ldsm_x4_t(t_addr<D>(sq, r0 / 16 + c, np, lane), qf);
              mma(dva[2 * np], pa, of[0], of[1]);
              mma(dva[2 * np + 1], pa, of[2], of[3]);
              mma(dka[2 * np], da, qf[0], qf[1]);
              mma(dka[2 * np + 1], da, qf[2], qf[3]);
            }
          }
        }
        __syncthreads();                 // this stage is free for the tile after next
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int key = kw + g + 8 * h;
      if (key >= S) continue;
      bf16* dkr = dk + kvoff + (size_t)key * HD;
      bf16* dvr = dv + kvoff + (size_t)key * HD;
#pragma unroll
      for (int j = 0; j < DT; ++j) {
        if (PAD && j * 8 + 2 * t >= HD) continue;
        *reinterpret_cast<uint32_t*>(dkr + j * 8 + 2 * t) =
            pack(scale * dka[j][2 * h], scale * dka[j][2 * h + 1]);
        *reinterpret_cast<uint32_t*>(dvr + j * 8 + 2 * t) = pack(dva[j][2 * h], dva[j][2 * h + 1]);
      }
    }
  }
}

template <int D, bool PAD>
__global__ void __launch_bounds__(TC_THREADS) flash_bwd_dkv_tc_kernel(DKV_TC_PARAMS) {
  flash_bwd_dkv_tc_body<D, PAD>(DKV_TC_ARGS);
}
template <int D, bool PAD>
__global__ void __launch_bounds__(TC_THREADS, 1)
flash_bwd_dkv_tc_narrow_kernel(DKV_TC_PARAMS) {
  flash_bwd_dkv_tc_body<D, PAD>(DKV_TC_ARGS);
}
// head dims 16 and 32 take the kernel with one block an SM named as its
// minimum (see the header); 64 and 128 keep the thread count alone, and so
// does the padded build
template <int D, bool PAD>
auto flash_bwd_dkv_tc() {
  if constexpr (D < 64) return &flash_bwd_dkv_tc_narrow_kernel<D, PAD>;
  else return &flash_bwd_dkv_tc_kernel<D, PAD>;
}

// ---------------------------------------------------------------------------
// dQ in bf16: tensor cores
// ---------------------------------------------------------------------------

template <int D>
__host__ __device__ constexpr int dq_tc_smem() {
  return 2 * TC_BQ * D * 2 + 2 * 2 * TC_BK * D * 2;   // Q, dO, then 2 stages of K and V
}

#define DQ_TC_PARAMS                                                                         \
  const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,       \
      const bf16* __restrict__ dout, const float* __restrict__ lse,                         \
      const float* __restrict__ delta, const int* __restrict__ lengths, bf16* __restrict__ dq, \
      int G, int S, float scale_log2, float scale, int causal, int hd
#define DQ_TC_ARGS \
  q, k, v, dout, lse, delta, lengths, dq, G, S, scale_log2, scale, causal, hd

// PAD: as flash_bwd_dkv_tc_body's
template <int D, bool PAD>
__device__ __forceinline__ void flash_bwd_dq_tc_body(DQ_TC_PARAMS) {
  constexpr int KC = D / 16;          // 16-deep chunks of q.k and dO.v
  constexpr int KW = dq_step_keys<D>();    // keys of an inner step
  constexpr int NT = KW / 8;          // 8-key column tiles of S and dP in a step
  constexpr int DT = D / 8;           // 8-wide column tiles of dQ
  constexpr int TILE = TC_BK * D * 2;
  extern __shared__ __align__(128) unsigned char tc_smem[];
  const uint32_t sq = smem_u32(tc_smem), sdo = sq + TC_BQ * D * 2;
  const uint32_t sk = sdo + TC_BQ * D * 2;     // stage s at sk + s * TILE
  const uint32_t sv = sk + 2 * TILE;

  // heaviest query blocks first: blockIdx.x runs over (b, g) fastest, then
  // over the query blocks from the last one down
  const int nq = (S + TC_BQ - 1) / TC_BQ;
  const int BG = gridDim.x / nq;
  const int iq = nq - 1 - (int)blockIdx.x / BG, bg = (int)blockIdx.x % BG, b = bg / G;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int q0 = iq * TC_BQ, wr = q0 + warp * 16;   // the warp's first row
  const int lenc = min(max(lengths[b], 1), S);
  const int HD = PAD ? hd : D;          // values a row in global memory
  const size_t qoff = (size_t)bg * S * HD;
  const bf16* kbase = k + (size_t)b * S * HD;
  const bf16* vbase = v + (size_t)b * S * HD;
  int last = lenc - 1;
  if (causal) last = min(last, min(q0 + TC_BQ, S) - 1);
  const int nkt = last / TC_BK + 1;
  // rows [r0, r0 + 64) of a [S, HD] matrix into a swizzled shared tile
  auto tile = [&](uint32_t dst, const bf16* src, int r0) {
    if constexpr (PAD) load_tile_hd<D, TC_BK, TC_THREADS>(dst, src, r0, S, HD);
    else tc_bf16::load_tile<D, TC_BK, TC_THREADS>(dst, src, r0, S);
  };

  tile(sq, q + qoff, q0);
  tile(sdo, dout + qoff, q0);
  cp_async_commit();
  tile(sk, kbase, 0);
  tile(sv, vbase, 0);
  cp_async_commit();
  // the thread's two rows (g and g + 8 of the warp's 16): lse in base 2, delta
  float lse2[2], dl[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = wr + g + 8 * h;
    lse2[h] = row < S ? __fmul_rn(lse[(size_t)bg * S + row], LOG2E) : 0.f;
    dl[h] = row < S ? delta[(size_t)bg * S + row] : 0.f;
  }
  cp_async_wait<1>();
  __syncthreads();
  uint32_t qa[KC][4], oa[KC][4];
#pragma unroll
  for (int kc = 0; kc < KC; ++kc) {
    ldsm_x4(a_addr<D>(sq, warp * 16, kc, lane), qa[kc]);
    ldsm_x4(a_addr<D>(sdo, warp * 16, kc, lane), oa[kc]);
  }

  float acc[DT][4];
#pragma unroll
  for (int j = 0; j < DT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  for (int kt = 0; kt < nkt; ++kt) {
    const int k0 = kt * TC_BK;
    const uint32_t skt = sk + (kt & 1) * TILE, svt = sv + (kt & 1) * TILE;
    if (kt + 1 < nkt) {              // the next tile's copy overlaps this tile's products
      const uint32_t nxt = ((kt + 1) & 1) * TILE;
      tile(sk + nxt, kbase, k0 + TC_BK);
      tile(sv + nxt, vbase, k0 + TC_BK);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    // element masks only on the length-edge tile and the diagonal tile
    const bool edge = k0 + TC_BK > lenc || (causal && k0 + TC_BK - 1 > q0);

#pragma unroll
    for (int c0 = 0; c0 < TC_BK; c0 += KW) {     // the step's first key in the tile
      float s[NT][4], dp[NT][4];
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
      for (int kc = 0; kc < KC; ++kc)
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          if (PAD && kc * 16 >= HD) continue;   // zero columns only
          uint32_t kf[4], vf[4];
          ldsm_x4(b_addr<D>(skt, c0 + np * 16, kc, lane), kf);
          ldsm_x4(b_addr<D>(svt, c0 + np * 16, kc, lane), vf);
          mma(s[2 * np], qa[kc], kf[0], kf[1]);
          mma(s[2 * np + 1], qa[kc], kf[2], kf[3]);
          mma(dp[2 * np], oa[kc], vf[0], vf[1]);
          mma(dp[2 * np + 1], oa[kc], vf[2], vf[3]);
        }
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int h = e >> 1;
          // _rn: each product and difference rounds on its own, as in the
          // plain version; a contracted fma would round ds across a bf16 step
          float s2 = __fmul_rn(s[j][e], scale_log2);
          if (edge) {
            const int row = wr + g + 8 * h, col = k0 + c0 + j * 8 + 2 * t + (e & 1);
            if (!(col < lenc && (!causal || col <= row))) s2 = NEG_INF;
          }
          const float p = expf(__fmul_rn(__fsub_rn(s2, lse2[h]), LN2));
          dp[j][e] = __fmul_rn(p, __fsub_rn(dp[j][e], dl[h]));
        }
      // dQ += dS . K, dS rounded to bf16: key columns [16c, 16c + 16) of the
      // step are the A fragment of that chunk, K's B fragments by .trans
#pragma unroll
      for (int c = 0; c < KW / 16; ++c) {
        uint32_t da[4];
        acc_to_a(dp[2 * c], dp[2 * c + 1], da);
#pragma unroll
        for (int np = 0; np < DT / 2; ++np) {
          if (PAD && np * 16 >= HD) continue;   // output columns past hd
          uint32_t kf[4];
          ldsm_x4_t(t_addr<D>(skt, c0 / 16 + c, np, lane), kf);
          mma(acc[2 * np], da, kf[0], kf[1]);
          mma(acc[2 * np + 1], da, kf[2], kf[3]);
        }
      }
    }
    __syncthreads();                 // this stage is free for the tile after next
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = wr + g + 8 * h;
    if (row >= S) continue;
    bf16* drow = dq + qoff + (size_t)row * HD;
#pragma unroll
    for (int j = 0; j < DT; ++j)
      if (!PAD || j * 8 + 2 * t < HD)
        *reinterpret_cast<uint32_t*>(drow + j * 8 + 2 * t) =
            pack(scale * acc[j][2 * h], scale * acc[j][2 * h + 1]);
  }
}

template <int D, bool PAD>
__global__ void __launch_bounds__(TC_THREADS) flash_bwd_dq_tc_kernel(DQ_TC_PARAMS) {
  flash_bwd_dq_tc_body<D, PAD>(DQ_TC_ARGS);
}
template <int D, bool PAD>
__global__ void __launch_bounds__(TC_THREADS, 1)
flash_bwd_dq_tc_narrow_kernel(DQ_TC_PARAMS) {
  flash_bwd_dq_tc_body<D, PAD>(DQ_TC_ARGS);
}
// head dims 16 and 32 take the kernel with one block an SM named as its
// minimum (see the header); 64 and 128 keep the thread count alone, and so
// does the padded build
template <int D, bool PAD>
auto flash_bwd_dq_tc() {
  if constexpr (D < 64) return &flash_bwd_dq_tc_narrow_kernel<D, PAD>;
  else return &flash_bwd_dq_tc_kernel<D, PAD>;
}

template <typename Kern>
int allow_smem(Kern kern, size_t bytes) {
  return (int)cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)bytes);
}

template <int D, bool PAD>
int launch_dq_tc(const void* q, const void* k, const void* v, const void* dout,
                 const void* lse, const void* delta, const void* lengths, void* dq, int B,
                 int G, int S, int causal, float scale_log2, float scale, int hd,
                 cudaStream_t st) {
  constexpr int smem = dq_tc_smem<D>();
  if (int e = allow_smem(flash_bwd_dq_tc<D, PAD>(), smem)) return e;
  const int nq = (S + TC_BQ - 1) / TC_BQ;
  flash_bwd_dq_tc<D, PAD>()<<<nq * G * B, TC_THREADS, smem, st>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dout, (const float*)lse,
      (const float*)delta, (const int*)lengths, (bf16*)dq, G, S, scale_log2, scale, causal, hd);
  return (int)cudaGetLastError();
}

template <int D, bool PAD>
int launch_dkv_tc(const void* q, const void* k, const void* v, const void* dout,
                  const void* lse, const void* delta, const void* lengths, void* dk, void* dv,
                  int B, int G, int S, int causal, float scale_log2, float scale, int hd,
                  cudaStream_t st) {
  constexpr int smem = dkv_tc_smem<D>();
  if (int e = allow_smem(flash_bwd_dkv_tc<D, PAD>(), smem)) return e;
  const int nkb = (S + TC_BK - 1) / TC_BK;
  flash_bwd_dkv_tc<D, PAD>()<<<dim3((nkb + 1) / 2, B), TC_THREADS, smem, st>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dout, (const float*)lse,
      (const float*)delta, (const int*)lengths, (bf16*)dk, (bf16*)dv, G, S, scale_log2, scale,
      causal, hd);
  return (int)cudaGetLastError();
}

// hd: the head dim of the rows in memory, D unless PAD (then hd % 4 == 0,
// 32 < hd <= D)
template <int D, bool PAD>
bool head_dim_ok(int hd) {
  return PAD ? hd % 4 == 0 && hd > 32 && hd <= D : hd == D;
}

// dtype_code: 0 = f32 q/k/v/dO and gradients (SIMT kernels), 1 = bf16
// (tensor cores)
template <int D, bool PAD>
int dq_entry(const void* q, const void* k, const void* v, const void* dout, const void* lse,
             const void* delta, const void* lengths, void* dq, int B, int G, int S, int causal,
             int dtype_code, float scale_log2, float scale, int hd, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!head_dim_ok<D, PAD>(hd)) return (int)cudaErrorInvalidValue;
  if (dtype_code == 1)
    return launch_dq_tc<D, PAD>(q, k, v, dout, lse, delta, lengths, dq, B, G, S, causal,
                                scale_log2, scale, hd, st);
  if (dtype_code != 0) return (int)cudaErrorInvalidValue;
  const size_t smem = dq_smem_bytes<D>();
  if (int e = allow_smem(flash_bwd_dq_kernel<D, PAD>, smem)) return e;
  flash_bwd_dq_kernel<D, PAD><<<dim3((S + DQ_BQ - 1) / DQ_BQ, G, B), THREADS, smem, st>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)dout,
      (const float*)lse, (const float*)delta, (const int*)lengths, (float*)dq, G, S,
      scale_log2, scale, causal, hd);
  return (int)cudaGetLastError();
}

template <int D, bool PAD>
int dkv_entry(const void* q, const void* k, const void* v, const void* dout, const void* lse,
              const void* delta, const void* lengths, void* dk, void* dv, int B, int G, int S,
              int causal, int dtype_code, float scale_log2, float scale, int hd, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!head_dim_ok<D, PAD>(hd)) return (int)cudaErrorInvalidValue;
  if (dtype_code == 1)
    return launch_dkv_tc<D, PAD>(q, k, v, dout, lse, delta, lengths, dk, dv, B, G, S, causal,
                                 scale_log2, scale, hd, st);
  if (dtype_code != 0) return (int)cudaErrorInvalidValue;
  const size_t smem = dkv_smem_bytes<D>();
  if (int e = allow_smem(flash_bwd_dkv_kernel<D, PAD>, smem)) return e;
  flash_bwd_dkv_kernel<D, PAD><<<dim3((S + KV_BKV - 1) / KV_BKV, B), THREADS, smem, st>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)dout,
      (const float*)lse, (const float*)delta, (const int*)lengths, (float*)dk, (float*)dv,
      G, S, scale_log2, scale, causal, hd);
  return (int)cudaGetLastError();
}

template <int D, bool PAD = false>
int dq_attributes(int* out, int dtype_code) {
  if (dtype_code == 1)
    return tc_bf16::attributes(flash_bwd_dq_tc<D, PAD>(), TC_THREADS, dq_tc_smem<D>(), out);
  return tc_bf16::attributes(flash_bwd_dq_kernel<D, PAD>, THREADS, (int)dq_smem_bytes<D>(),
                             out);
}

template <int D, bool PAD = false>
int dkv_attributes(int* out, int dtype_code) {
  if (dtype_code == 1)
    return tc_bf16::attributes(flash_bwd_dkv_tc<D, PAD>(), TC_THREADS, dkv_tc_smem<D>(), out);
  return tc_bf16::attributes(flash_bwd_dkv_kernel<D, PAD>, THREADS, (int)dkv_smem_bytes<D>(),
                             out);
}

}  // namespace

// One entry per head dim and kernel, each with the arguments of dq_entry /
// dkv_entry but hd.
#define FLASH_BWD_ENTRIES(suffix, D)                                                          \
  extern "C" int flash_bwd_dq##suffix(                                                        \
      const void* q, const void* k, const void* v, const void* dout, const void* lse,         \
      const void* delta, const void* lengths, void* dq, int B, int G, int S, int causal,      \
      int dtype_code, float scale_log2, float scale, void* stream) {                          \
    return dq_entry<D, false>(q, k, v, dout, lse, delta, lengths, dq, B, G, S, causal,        \
                              dtype_code, scale_log2, scale, D, stream);                      \
  }                                                                                           \
  extern "C" int flash_bwd_dkv##suffix(                                                       \
      const void* q, const void* k, const void* v, const void* dout, const void* lse,         \
      const void* delta, const void* lengths, void* dk, void* dv, int B, int G, int S,        \
      int causal, int dtype_code, float scale_log2, float scale, void* stream) {              \
    return dkv_entry<D, false>(q, k, v, dout, lse, delta, lengths, dk, dv, B, G, S, causal,   \
                               dtype_code, scale_log2, scale, D, stream);                     \
  }
FLASH_BWD_ENTRIES(, 64)
FLASH_BWD_ENTRIES(_d16, 16)
FLASH_BWD_ENTRIES(_d32, 32)
FLASH_BWD_ENTRIES(_d128, 128)

// Any other head dim hd % 4 == 0, 32 < hd <= 128: the arguments of the
// entries above with hd after dtype_code.
extern "C" int flash_bwd_dq_dpad(const void* q, const void* k, const void* v, const void* dout,
                                 const void* lse, const void* delta, const void* lengths,
                                 void* dq, int B, int G, int S, int causal, int dtype_code,
                                 int hd, float scale_log2, float scale, void* stream) {
  return dq_entry<128, true>(q, k, v, dout, lse, delta, lengths, dq, B, G, S, causal,
                             dtype_code, scale_log2, scale, hd, stream);
}

extern "C" int flash_bwd_dkv_dpad(const void* q, const void* k, const void* v,
                                  const void* dout, const void* lse, const void* delta,
                                  const void* lengths, void* dk, void* dv, int B, int G, int S,
                                  int causal, int dtype_code, int hd, float scale_log2,
                                  float scale, void* stream) {
  return dkv_entry<128, true>(q, k, v, dout, lse, delta, lengths, dk, dv, B, G, S, causal,
                              dtype_code, scale_log2, scale, hd, stream);
}

// A kernel's registers, shared memory, spills and occupancy at a head dim
// (16, 32, 64, 128; another: the padded build) and dtype_code
// (tc_bf16::attributes; launches nothing).
extern "C" int flash_bwd_dq_attributes(int* out, int head_dim, int dtype_code) {
  switch (head_dim) {
    case 16: return dq_attributes<16>(out, dtype_code);
    case 32: return dq_attributes<32>(out, dtype_code);
    case 64: return dq_attributes<64>(out, dtype_code);
    case 128: return dq_attributes<128>(out, dtype_code);
  }
  if (head_dim % 4 == 0 && head_dim > 32 && head_dim < 128)
    return dq_attributes<128, true>(out, dtype_code);
  return (int)cudaErrorInvalidValue;
}

extern "C" int flash_bwd_dkv_attributes(int* out, int head_dim, int dtype_code) {
  switch (head_dim) {
    case 16: return dkv_attributes<16>(out, dtype_code);
    case 32: return dkv_attributes<32>(out, dtype_code);
    case 64: return dkv_attributes<64>(out, dtype_code);
    case 128: return dkv_attributes<128>(out, dtype_code);
  }
  if (head_dim % 4 == 0 && head_dim > 32 && head_dim < 128)
    return dkv_attributes<128, true>(out, dtype_code);
  return (int)cudaErrorInvalidValue;
}
