"""The port's CUDA kernels against their plain PyTorch versions, on the GPU.

Marked ``cuda``: these skip where there is no GPU (this suite's CPU runs)
and run on the GPU host with

    python -m pytest -m cuda tests/test_torch_cuda_kernels.py --noconftest -q

They import no JAX. Tolerances: the int8 and W4A8 GEMMs are bit-exact (the
exact int32 sum through the same f32 epilogue). Decode attention and flash
attention round at the same points against the same softmax maximum as
their plain versions and differ only in fp32 summation order: held element
by element, in bf16 to 2 bf16 steps of the expected value plus 1e-2 of the
median expected magnitude, in f32 to 1e-5 of the value plus 1e-4 of the
median.
"""

import pytest
import torch

from llm_qat_torch.ops import decode_attention as DA
from llm_qat_torch.ops import flash_attention as FA
from llm_qat_torch.ops import quant_matmul as QM

pytestmark = pytest.mark.cuda


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: run with -m cuda on the GPU host")
    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    return g


def _close(got, want):
    """Element-wise agreement at the tolerance of the module docstring."""
    g, w = got.float(), want.float()
    if want.dtype == torch.bfloat16:
        step = torch.exp2(torch.floor(torch.log2(w.abs().clamp_min(2.0 ** -126))) - 7)
        lim = 2 * step + 1e-2 * w.abs().median()
    else:
        lim = 1e-5 * w.abs() + 1e-4 * w.abs().median()
    return bool(torch.isfinite(g).all()) and bool(((g - w).abs() <= lim).all())


@pytest.mark.parametrize("M,K,N", [(32, 2048, 2560), (40, 5632, 2048), (256, 512, 192)])
@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
def test_gemm_kernels_bit_exact(gen, M, K, N, out_dtype):
    x = torch.randn(M, K, device="cuda", generator=gen)
    w = torch.randn(K, N, device="cuda", generator=gen) * 0.02
    xq, sx = QM.quantize_per_token(x)
    wq, sw = QM.quantize_per_channel(w)
    n8 = QM.int8_matmul.launches
    got = QM.int8_matmul(xq, wq, sx, sw, out_dtype=out_dtype)
    assert QM.int8_matmul.launches == n8 + 1
    assert torch.equal(got, QM._int8_matmul_plain(xq, wq, sx, sw, out_dtype))
    wp, sw4 = QM.quantize_weights_w4(w)
    got4 = QM.int4_matmul(xq, wp, sx, sw4, out_dtype=out_dtype)
    assert torch.equal(got4, QM._int4_matmul_plain(xq, wp, sx, sw4, out_dtype))


def test_gemm_kernel_rejects_unsupported_shapes(gen):
    xq = torch.zeros(8, 100, dtype=torch.int8, device="cuda")
    wq = torch.zeros(100, 64, dtype=torch.int8, device="cuda")
    with pytest.raises(ValueError, match="K % 128"):
        QM.int8_matmul(xq, wq, torch.ones(8, 1, device="cuda"),
                       torch.ones(1, 64, device="cuda"))


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("rope", [True, False])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_decode_attention_kernel(gen, packed, rope, dtype):
    b, kvh, G, hd, S = 8, 4, 8, 64, 512
    hdc = hd // 2 if packed else hd
    lo, hi, qdt = (0, 256, torch.uint8) if packed else (-127, 128, torch.int8)
    kq = torch.randint(lo, hi, (b, kvh, hdc, S), device="cuda", generator=gen).to(qdt)
    vq = torch.randint(lo, hi, (b, kvh, hdc, S), device="cuda", generator=gen).to(qdt)
    ks = torch.rand(b, S, device="cuda", generator=gen) * 0.02 + 0.005
    vs = torch.rand(b, S, device="cuda", generator=gen) * 0.02 + 0.005
    q = torch.randn(b, kvh * G, hd, device="cuda", generator=gen).to(dtype)
    # empty, one-chunk and multi-chunk slots; inactive slots 1 and 7
    lens = torch.tensor([0, 1, 17, 255, 256, 257, 400, 511], dtype=torch.int32,
                        device="cuda")
    kc, ksn = DA._rope_tables(S, hd, 10000.0, "cuda")
    # the folded pair in the cache's range, as the serving path quantizes it
    flo, fhi = (-8, 8) if packed else (-127, 128)
    fold = (torch.randint(flo, fhi, (b, kvh, hd), device="cuda", generator=gen).to(torch.int8),
            torch.rand(b, 1, device="cuda", generator=gen) * 0.02 + 0.005,
            torch.randint(flo, fhi, (b, kvh, hd), device="cuda", generator=gen).to(torch.int8),
            torch.rand(b, 1, device="cuda", generator=gen) * 0.02 + 0.005,
            torch.tensor([1, 0, 1, 1, 1, 1, 1, 0], dtype=torch.int32, device="cuda"),
            kc[:, :b].T.contiguous(), ksn[:, :b].T.contiguous())
    args = (q, kq, ks, vq, vs, lens, kc if rope else None, ksn if rope else None, fold)
    got = DA.quantized_decode_attention(*args, rope=rope, packed=packed)
    want = DA._decode_attention_plain(*args, rope=rope, packed=packed)
    assert _close(got, want)


@pytest.mark.parametrize("S", [16, 100, 1024])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("soft_bf16", [False, True])
def test_flash_fwd_kernel(gen, S, causal, soft_bf16):
    B, G, D = 4, 8, 64
    q = torch.randn(B, G, S, D, device="cuda", generator=gen).to(torch.bfloat16)
    k = torch.randn(B, S, D, device="cuda", generator=gen).to(torch.bfloat16)
    v = torch.randn(B, S, D, device="cuda", generator=gen).to(torch.bfloat16)
    lens = torch.tensor([S, 0, S // 2, S - 1], dtype=torch.int32, device="cuda")
    o, lse = FA._flash_fwd(q, k, v, lens, causal=causal, soft_bf16=soft_bf16)
    o2, lse2 = FA._flash_fwd_plain(q, k, v, lens, causal, soft_bf16)
    assert _close(o, o2)
    assert float((lse - lse2).abs().max()) < 1e-3
