// The floor of K12's and K13's bytes (csrc/fused_quant.cu): a pass that
// moves what they move and computes nothing. Each thread reads one 16-byte
// piece of a row-major [M, K] bf16 input (and of a second one, xor-ed in, for
// K13's two inputs) and writes 8 bytes, one of each element. chip_smoke.py
// times it beside each kernel: the rate a pass of these bytes attains on the
// card, below the byte bound. Not on any path of the package.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void stream_floor_kernel(const uint4* __restrict__ a, const uint4* __restrict__ b,
                                    uint2* __restrict__ out, long n16) {
  const long i = blockIdx.x * (long)blockDim.x + threadIdx.x;
  if (i >= n16) return;
  uint4 v = __ldg(a + i);
  if (b) {
    const uint4 w = __ldg(b + i);
    v.x ^= w.x;
    v.y ^= w.y;
    v.z ^= w.z;
    v.w ^= w.w;
  }
  out[i] = make_uint2(__byte_perm(v.x, v.y, 0x7531), __byte_perm(v.z, v.w, 0x7531));
}

}  // namespace

// a, b (b may be null): n16 16-byte pieces each; out: n16 8-byte pieces
extern "C" int stream_floor(const void* a, const void* b, void* out, int n16, void* stream) {
  stream_floor_kernel<<<(unsigned)((n16 + 255) / 256), 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(a), static_cast<const uint4*>(b), static_cast<uint2*>(out), n16);
  return (int)cudaGetLastError();
}
