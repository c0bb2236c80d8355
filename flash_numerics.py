"""Why the bf16 flash kernels are held against plain versions with tensor-core
score products, measured on one NVIDIA GPU.

    python3 flash_numerics.py

1. Builds a one-tile product kernel from ``llm_qat_torch/csrc/tc_bf16.cuh``
   (the ``mma.sync`` m16n8k16 path of K4, K10 and K11) into ``build/`` and counts
   the scores where it differs from the library's bf16 product with an fp32
   result (both operand orders) and from fp32 products of the widened
   operands.
2. Over several seeds and the shapes of ``tests/test_torch_cuda_kernels.py``,
   the worst ratio to the K3/K4 limit (2 bf16 steps of |expected| + 1e-2 x
   median|expected|, element by element) of: K4, K10 and K11 against their
   plain versions (tensor-core products, as shipped); the same kernels
   against plain versions with fp32 products; and the two plain versions
   against each other, with no kernel involved.

Prints one JSON line. Imports nothing of JAX. Exits 1 without a GPU.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

import torch

REPO = os.path.dirname(os.path.abspath(__file__))
TILE_SRC = r'''
#include "tc_bf16.cuh"
using namespace tc_bf16;
// C[b][m][n] = sum_d A[b][m][d] B[b][n][d] at D = 64, one 64 x 64 tile a block
__global__ void tile_kernel(const bf16* A, const bf16* B, float* C, int M, int N) {
  constexpr int D = 64;
  __shared__ __align__(128) unsigned char sm[2 * 64 * D * 2];
  const uint32_t sa = smem_u32(sm), sb = sa + 64 * D * 2;
  const int bm = blockIdx.x * 64, bn = blockIdx.y * 64, b = blockIdx.z;
  load_tile<D, 64, 128>(sa, A + (size_t)b * M * D, bm, M);
  load_tile<D, 64, 128>(sb, B + (size_t)b * N * D, bn, N);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  uint32_t af[4][4];
  for (int kc = 0; kc < 4; ++kc) ldsm_x4(a_addr<D>(sa, warp * 16, kc, lane), af[kc]);
  float c[8][4] = {};
  for (int kc = 0; kc < 4; ++kc)
    for (int np = 0; np < 4; ++np) {
      uint32_t f[4];
      ldsm_x4(b_addr<D>(sb, np * 16, kc, lane), f);
      mma(c[2 * np], af[kc], f[0], f[1]);
      mma(c[2 * np + 1], af[kc], f[2], f[3]);
    }
  for (int j = 0; j < 8; ++j)
    for (int e = 0; e < 4; ++e)
      C[((size_t)b * M + bm + warp * 16 + g + (e >> 1) * 8) * N + bn + j * 8 + 2 * t + (e & 1)] =
          c[j][e];
}
extern "C" int tile_mm(const void* A, const void* B, void* C, int nb, int M, int N) {
  tile_kernel<<<dim3(M / 64, N / 64, nb), 128>>>((const bf16*)A, (const bf16*)B, (float*)C, M, N);
  return (int)cudaDeviceSynchronize();
}
'''


def worst(got, want) -> float:
    """Largest |got - want| over the K3/K4 limit (1 = at it)."""
    w = want.float()
    step = torch.exp2(torch.floor(torch.log2(w.abs().clamp_min(2.0 ** -126))) - 7)
    return float(((got.float() - w).abs() / (2 * step + 1e-2 * w.abs().median())).max())


def mma_against_library(_build, gen) -> dict:
    out_dir = os.path.join(REPO, "build", "flash_numerics")
    os.makedirs(out_dir, exist_ok=True)
    src, lib = os.path.join(out_dir, "tile.cu"), os.path.join(out_dir, "tile.so")
    with open(src, "w") as f:
        f.write(TILE_SRC)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o", lib, src],
                   check=True, capture_output=True, text=True)
    fn = ctypes.CDLL(lib).tile_mm
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
    fn.restype = ctypes.c_int
    nb, M, N = 4, 2048, 2048
    a, b = (torch.randn(nb, n, 64, device="cuda", generator=gen).to(torch.bfloat16)
            for n in (M, N))
    c = torch.empty(nb, M, N, device="cuda")
    if fn(a.data_ptr(), b.data_ptr(), c.data_ptr(), nb, M, N):
        raise RuntimeError("tile_mm failed")
    refs = {"library a.b^T": torch.bmm(a, b.transpose(1, 2), out_dtype=torch.float32),
            "library (b.a^T)^T": torch.bmm(b, a.transpose(1, 2), out_dtype=torch.float32)
            .transpose(1, 2),
            "fp32 products": torch.bmm(a.float(), b.float().transpose(1, 2))}
    return dict(scores=c.numel(), **{f"differ from {k}": int((c != r).sum())
                                     for k, r in refs.items()})


def main() -> int:
    if not torch.cuda.is_available():
        print("flash_numerics: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from llm_qat_torch.ops import _build
    from llm_qat_torch.ops import flash_attention as FA

    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    result = {"card": torch.cuda.get_device_name(0), "mma_tile": mma_against_library(_build, gen)}

    real = FA._scores

    def fp32_scores(a, b, tensor_cores=True):
        return real(a, b, tensor_cores=False)

    def with_fp32_products(fn, *args):
        FA._scores = fp32_scores
        try:
            return fn(*args)
        finally:
            FA._scores = real

    w = {k: 0.0 for k in ("K4 vs plain", "K4 vs fp32-product plain", "plain vs fp32-product plain (forward)",
                          "K10 vs plain", "K10 vs fp32-product plain", "plain vs fp32-product plain (dQ)",
                          "K11 vs plain", "K11 vs fp32-product plain", "plain vs fp32-product plain (dK/dV)")}
    cases = 0
    for seed in range(6):
        gen.manual_seed(seed)
        for B, G, S, D in ((4, 8, 100, 64), (4, 8, 1100, 64), (4, 1, 2048, 64), (4, 8, 2048, 64),
                           (8, 1, 1024, 128)):
            rnd = lambda *sh: torch.randn(*sh, device="cuda", generator=gen).to(torch.bfloat16)  # noqa: E731
            q, k, v, do = rnd(B, G, S, D), rnd(B, S, D), rnd(B, S, D), rnd(B, G, S, D)
            lens = torch.tensor(([S, 0, S // 2, S - 1] * 2)[:B], dtype=torch.int32, device="cuda")
            for causal in (True, False):
                for soft in (False, True):
                    o, _ = FA._flash_fwd(q, k, v, lens, causal, soft)
                    tc = FA._flash_fwd_plain(q, k, v, lens, causal, soft)[0]
                    f32 = with_fp32_products(FA._flash_fwd_plain, q, k, v, lens, causal, soft)[0]
                    for key, val in (("K4 vs plain", worst(o, tc)),
                                     ("K4 vs fp32-product plain", worst(o, f32)),
                                     ("plain vs fp32-product plain (forward)", worst(tc, f32))):
                        w[key] = max(w[key], val)
                    cases += 1
                o, lse = FA._flash_fwd(q, k, v, lens, causal)
                args = (q, k, v, lens, lse, FA._delta(o, do), do, causal)
                for name, part, kern, plain in (
                        ("K10", "dQ", lambda *a: (FA._flash_bwd_dq(*a),),
                         lambda *a: (FA._flash_bwd_dq_plain(*a),)),
                        ("K11", "dK/dV", FA._flash_bwd_dkv, FA._flash_bwd_dkv_plain)):
                    got, tc = kern(*args), plain(*args)
                    f32 = with_fp32_products(plain, *args)
                    for key, (x, y) in ((f"{name} vs plain", (got, tc)),
                                        (f"{name} vs fp32-product plain", (got, f32)),
                                        (f"plain vs fp32-product plain ({part})", (tc, f32))):
                        w[key] = max(w[key], max(worst(a, b) for a, b in zip(x, y)))
                    cases += 1
    result.update(cases=cases, seeds=6, worst_of_limit=w)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
