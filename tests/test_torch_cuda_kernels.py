"""The port's CUDA kernels against their plain PyTorch versions, on the GPU.

Marked ``cuda``: these skip where there is no GPU (this suite's CPU runs)
and run on the GPU host with

    python -m pytest -m cuda tests/test_torch_cuda_kernels.py --noconftest -q

They import no JAX. Tolerances: the int8 and W4A8 GEMMs are bit-exact (the
exact int32 sum through the same f32 epilogue), in both variants and at
every split-K count. Decode attention and flash
attention round at the same points against the same softmax maximum as
their plain versions and differ only in fp32 summation order: held element
by element, in bf16 to 2 bf16 steps of the expected value plus 1e-2 of the
median expected magnitude, in f32 to 1e-5 of the value plus 1e-4 of the
median; the paged decode attention and the stacked decode attention follow
their plain versions the same way (both walk the TPU kernel's blocks with a
running maximum: bk columns, or a page) and are held alike. The three
decode attention kernels take their sums in float64 as their plain
versions do (bit-equal but for float64 noise) and give the same bits on a
second launch (``-k "decode_attention or paged_attention"``); the stacked GEMMs are bit-exact
against their plain versions and against the unstacked kernels. The
whole-model decode kernel takes every rounded sum in float64, as
its plain version does, so the two are expected to agree bit for bit; held
here to: committed K/V integers and lengths equal, inverse scales at rtol
1e-6, logits element-wise as above. The flash backward kernels recompute p
from the saved log-sum-exp and round ds and p where their plain versions do:
held as the forward is; the bf16 ones give the same bits on a second
launch (no atomics). The bf16 flash kernels (forward, dQ, dK/dV) take q.k
and dO.v on the tensor cores, and so do their plain versions (the library's
bf16 product with an fp32 result): with fp32 products instead, p and ds
cross bf16 rounding steps that the limit does not allow (``flash_numerics.py``). The RMSNorm+quant and SiLU*up+quant kernels are held
at every width of the models' rows, with a row of zeros and a row with one
outlier in each case (``-k "rmsnorm or silu"``), and give the same bits on a
second launch. SiLU*up+quant sums nothing and gives its plain version's
integers and scales to the bit. RMSNorm+quant's plain version sums the fp32
squares in the kernel's order on the card (``_sum_sq_kernel_order``), so
the two agree to the bit as well.
"""

import pytest
import torch

import chip_smoke
from llm_qat_torch.inference import engine as E
from llm_qat_torch.inference import megakernel as MK
from llm_qat_torch.inference import model as M
from llm_qat_torch.inference import quantized as Q
from llm_qat_torch.models import params as P
from llm_qat_torch.models.config import LLAMA_7B, TINYLLAMA_1B
from llm_qat_torch.ops import decode_attention as DA
from llm_qat_torch.ops import flash_attention as FA
from llm_qat_torch.ops import fused_quant as FQ
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


# (K, N) of the served projections: TinyLlama-1.1B's qkv, o, gate-up, down,
# then LLaMA-7B's down and o
GEMM_PROJ = [(2048, 2560), (2048, 2048), (2048, 11264), (5632, 2048), (11008, 4096),
             (4096, 4096)]
# every variant boundary (decode up to 64 rows, 32 rows a tile up to 32) and
# the engine's row counts (32 a decode step, prefill buckets up to 4096)
GEMM_ROWS = [1, 8, 32, 33, 64, 65, 127, 128, 129, 1024, 4096]
GEMM_SHAPES = ([(M, K, N) for M in GEMM_ROWS for K, N in GEMM_PROJ]
               + [(40, 5632, 2048), (256, 512, 192)])


def _gemm_operands(gen, M, K, N):
    x = torch.randn(M, K, device="cuda", generator=gen)
    w = torch.randn(K, N, device="cuda", generator=gen) * 0.02
    xq, sx = QM.quantize_per_token(x)
    wq, sw = QM.quantize_per_channel(w)
    wp, sw4 = QM.quantize_weights_w4(w)
    return xq, sx, wq, sw, wp, sw4


@pytest.mark.parametrize("M,K,N", GEMM_SHAPES)
@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
def test_gemm_kernels_bit_exact(gen, M, K, N, out_dtype):
    xq, sx, wq, sw, wp, sw4 = _gemm_operands(gen, M, K, N)
    n8, n4 = QM.int8_matmul.launches, QM.int4_matmul.launches
    got = QM.int8_matmul(xq, wq, sx, sw, out_dtype=out_dtype)
    assert QM.int8_matmul.launches == n8 + 1
    assert torch.equal(got, QM._int8_matmul_plain(xq, wq, sx, sw, out_dtype))
    got4 = QM.int4_matmul(xq, wp, sx, sw4, out_dtype=out_dtype)
    assert QM.int4_matmul.launches == n4 + 1
    assert torch.equal(got4, QM._int4_matmul_plain(xq, wp, sx, sw4, out_dtype))


@pytest.mark.parametrize("M", [32, 128, 1024])
@pytest.mark.parametrize("K,N", GEMM_PROJ)
def test_gemm_kernels_same_bits_twice_and_at_every_split(gen, M, K, N):
    """The split-K partials meet in a cluster's distributed shared memory: a
    second launch gives the same bits, and so does every split count (1, 2,
    the wrapper's, and the most, a cluster of 8)."""
    xq, sx, wq, sw, wp, sw4 = _gemm_operands(gen, M, K, N)
    for stem, fn, w, s in (("int8_matmul", QM.int8_matmul, wq, sw),
                           ("w4a8_matmul", QM.int4_matmul, wp, sw4)):
        first = fn(xq, w, sx, s)
        assert torch.equal(first, fn(xq, w, sx, s))
        plan = QM.gemm_plan(M, N, K, stem == "w4a8_matmul")
        for splits in sorted({1, 2, plan["splits"], min(plan["steps"], QM.MAX_SPLITS)}):
            got = QM._launch_gemm(stem, stem, xq, w, sx, s, torch.bfloat16, M, N, K,
                                  plan=dict(plan, splits=splits))
            assert torch.equal(got, first), (stem, splits)


def test_gemm_kernel_attributes(gen):
    """Every K1/K2 variant (decode at 32 and 64 rows, prefill; bf16 and f32
    out) compiles without a spill and fits an SM at its shared memory."""
    attrs = QM.kernel_attributes()
    assert len(attrs) == 12
    for name, a in attrs.items():
        assert a["spill_bytes"] == 0 and a["registers"] <= 255, (name, a)
        assert a["blocks_per_sm"] >= 1, (name, a)
        assert a["threads"] == (256 if "prefill" in name else 128), (name, a)


def test_gemm_kernel_rejects_unsupported_shapes(gen):
    """K = 2736 is a multiple of 16 but not of 32: refused by both kernels."""
    K = 2736
    xq = torch.zeros(8, K, dtype=torch.int8, device="cuda")
    wq = torch.zeros(K, 64, dtype=torch.int8, device="cuda")
    sx, sw = torch.ones(8, 1, device="cuda"), torch.ones(1, 64, device="cuda")
    with pytest.raises(ValueError, match="K % 32"):
        QM.int8_matmul(xq, wq, sx, sw)
    with pytest.raises(ValueError, match="K % 32"):
        QM.int4_matmul(xq, wq[:K // 2].view(torch.uint8).contiguous(), sx, sw)


# (K, N) whose K is no multiple of the 128-row stage: the tiny models' qkv
# (64), the accuracy model's qkv and down (256, 768), LLaMA-7B's down at
# tp = 8 and 4 (1376, 2752); and K = 2080 (a stage and a 32-row tail at W8)
K_TAIL_PROJ = [(64, 128), (256, 512), (768, 256), (1376, 4096), (2752, 4096), (2080, 192)]


@pytest.mark.parametrize("M", [1, 32, 64, 65, 1024])
@pytest.mark.parametrize("K,N", K_TAIL_PROJ)
def test_gemm_kernels_k_tail_at_every_split(gen, M, K, N):
    """K1/K2 (and so K5/K6) at K a multiple of 32 but not of 128: the last
    stage is partial and zero-filled. Bit-equal to the plain versions at every
    split count the plan could take (the split holding the tail included),
    and the same bits on a second launch."""
    xq, sx, wq, sw, wp, sw4 = _gemm_operands(gen, M, K, N)
    for stem, fn, plain, w, s in (("int8_matmul", QM.int8_matmul, QM._int8_matmul_plain, wq, sw),
                                  ("w4a8_matmul", QM.int4_matmul, QM._int4_matmul_plain, wp,
                                   sw4)):
        want = plain(xq, w, sx, s, torch.bfloat16)
        first = fn(xq, w, sx, s)
        assert torch.equal(first, want), stem
        assert torch.equal(fn(xq, w, sx, s), first), stem
        plan = QM.gemm_plan(M, N, K, stem == "w4a8_matmul")
        for splits in range(1, min(plan["steps"], QM.MAX_SPLITS) + 1):
            got = QM._launch_gemm(stem, stem, xq, w, sx, s, torch.bfloat16, M, N, K,
                                  plan=dict(plan, splits=splits))
            assert torch.equal(got, want), (stem, splits)


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
    assert torch.equal(got, DA.quantized_decode_attention(*args, rope=rope, packed=packed))
    want = DA._decode_attention_plain(*args, rope=rope, packed=packed)
    assert _close(got, want)


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("rope", [True, False])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_decode_attention_kernel_mha_head_dim_128(gen, packed, rope, dtype):
    """The (1, 128) instantiation (LLaMA-7B-shaped heads): b = 8, 32 kv
    heads, S = 2048 (the scores take S floats of shared memory a block)."""
    b, kvh, hd, S = 8, 32, 128, 2048
    hdc = hd // 2 if packed else hd
    lo, hi, qdt = (0, 256, torch.uint8) if packed else (-127, 128, torch.int8)
    kq = torch.randint(lo, hi, (b, kvh, hdc, S), device="cuda", generator=gen).to(qdt)
    vq = torch.randint(lo, hi, (b, kvh, hdc, S), device="cuda", generator=gen).to(qdt)
    ks = torch.rand(b, S, device="cuda", generator=gen) * 0.02 + 0.005
    vs = torch.rand(b, S, device="cuda", generator=gen) * 0.02 + 0.005
    q = torch.randn(b, kvh, hd, device="cuda", generator=gen).to(dtype)
    lens = torch.tensor([0, 1, 17, 255, 256, 1000, 2000, 2047], dtype=torch.int32,
                        device="cuda")
    kc, ksn = DA._rope_tables(S, hd, 10000.0, "cuda")
    flo, fhi = (-8, 8) if packed else (-127, 128)
    fold = (torch.randint(flo, fhi, (b, kvh, hd), device="cuda", generator=gen).to(torch.int8),
            torch.rand(b, 1, device="cuda", generator=gen) * 0.02 + 0.005,
            torch.randint(flo, fhi, (b, kvh, hd), device="cuda", generator=gen).to(torch.int8),
            torch.rand(b, 1, device="cuda", generator=gen) * 0.02 + 0.005,
            torch.tensor([1, 0, 1, 1, 1, 1, 1, 0], dtype=torch.int32, device="cuda"),
            kc[:, :b].T.contiguous(), ksn[:, :b].T.contiguous())
    args = (q, kq, ks, vq, vs, lens, kc if rope else None, ksn if rope else None, fold)
    n = DA.quantized_decode_attention.launches
    got = DA.quantized_decode_attention(*args, rope=rope, packed=packed)
    assert DA.quantized_decode_attention.launches == n + 1
    want = DA._decode_attention_plain(*args, rope=rope, packed=packed)
    assert _close(got, want)


def test_decode_attention_kernel_refuses_shapes_it_is_not_built_for(gen):
    q = torch.zeros(1, 34, 128, device="cuda")
    kq = torch.zeros(1, 2, 128, 64, dtype=torch.int8, device="cuda")
    ks = torch.ones(1, 64, device="cuda")
    lens = torch.ones(1, dtype=torch.int32, device="cuda")
    with pytest.raises(NotImplementedError, match=r"1 <= G <= 16 query heads per kv head"):
        DA.quantized_decode_attention(q, kq, ks, kq, ks, lens, rope=False)   # G = 17
    # no length limit any more: a cache past the old 32768 / G runs; a
    # length that is no multiple of 8 is refused
    kq = torch.zeros(1, 1, 128, 32768 + 64, dtype=torch.int8, device="cuda")
    ks = torch.ones(1, 32768 + 64, device="cuda")
    out = DA.quantized_decode_attention(q[:, :1], kq, ks, kq, ks, lens, rope=False)
    assert torch.equal(out, torch.zeros_like(out))                       # V is 0
    with pytest.raises(NotImplementedError, match="multiple of 8"):
        DA.quantized_decode_attention(q[:, :1], kq[..., :100], ks[:, :100], kq[..., :100],
                                      ks[:, :100], lens, rope=False)


def _cache(gen, b, kvh, hd, S, packed):
    hdc = hd // 2 if packed else hd
    lo, hi, qdt = (0, 256, torch.uint8) if packed else (-127, 128, torch.int8)
    kq = torch.randint(lo, hi, (b, kvh, hdc, S), device="cuda", generator=gen).to(qdt)
    vq = torch.randint(lo, hi, (b, kvh, hdc, S), device="cuda", generator=gen).to(qdt)
    ks = torch.rand(b, S, device="cuda", generator=gen) * 0.02 + 0.005
    vs = torch.rand(b, S, device="cuda", generator=gen) * 0.02 + 0.005
    return kq, ks, vq, vs


def _quant_fold(gen, b, kvh, hd, packed, active, kc, ksn, pos):
    flo, fhi = (-8, 8) if packed else (-127, 128)
    return (torch.randint(flo, fhi, (b, kvh, hd), device="cuda", generator=gen).to(torch.int8),
            torch.rand(b, 1, device="cuda", generator=gen) * 0.02 + 0.005,
            torch.randint(flo, fhi, (b, kvh, hd), device="cuda", generator=gen).to(torch.int8),
            torch.rand(b, 1, device="cuda", generator=gen) * 0.02 + 0.005,
            torch.tensor(active, dtype=torch.int32, device="cuda"),
            kc[:, pos].T.contiguous(), ksn[:, pos].T.contiguous())


# kv heads of each (G, hd) in these cases: TinyLlama-1.1B's, LLaMA-7B's, the
# tiny models', the accuracy model's, then 8 (the public GQA checkpoints')
# for every other G of 1..8 and for 9, 12 and 16 (the builds of 9..15 and
# 16: Mistral-Large-2's 12, Llama-3.1-405B's 16) at head dims 64 and 128, and
# G = 12 and 16 at head dims 16 and 32 (two and four passes of their 4-head
# register tile), and G = 1..4 at head dim 256 over Falcon3's 4 kv heads
DECODE_KVH = {(8, 64): 4, (1, 128): 32, (2, 16): 2, (2, 32): 4,
              **{(g, hd): 8 for hd in (64, 128) for g in (*range(1, 9), 9, 12, 16)
                 if (g, hd) not in ((8, 64), (1, 128))},
              (12, 16): 2, (16, 16): 2, (12, 32): 4, (16, 32): 4,
              **{(g, 256): 4 for g in range(1, 5)}}


@pytest.mark.parametrize("G,hd", list(DECODE_KVH))
@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("rope", [True, False])
@pytest.mark.parametrize("fold", [True, False])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_decode_attention_kernel_block_edges(gen, G, hd, packed, rope, fold, dtype):
    """S = 2048 at the JAX picker's block (1024 at (8, 64) with 4 kv heads,
    256 at (1, 128) with 32) at every (G, hd) of the table: lengths 0, 1, 127, 128,
    129, bk - 1, bk, bk + 1 and S, slot 2 inactive; the same bits on a
    second launch."""
    kvh, S = DECODE_KVH[(G, hd)], 2048
    bk = DA._pick_bk(S, kvh, hd, 1024)
    lens_l = [0, 1, 127, 128, 129, bk - 1, bk, bk + 1, S]
    b = len(lens_l)
    kq, ks, vq, vs = _cache(gen, b, kvh, hd, S, packed)
    q = torch.randn(b, kvh * G, hd, device="cuda", generator=gen).to(dtype)
    lens = torch.tensor(lens_l, dtype=torch.int32, device="cuda")
    kc, ksn = DA._rope_tables(S, hd, 10000.0, "cuda")
    fd = None
    if fold:
        fd = _quant_fold(gen, b, kvh, hd, packed, [int(i != 2) for i in range(b)], kc, ksn,
                         torch.clamp(lens.long(), max=S - 1))
    args = (q, kq, ks, vq, vs, lens, kc if rope else None, ksn if rope else None, fd)
    n = DA.quantized_decode_attention.launches
    got = DA.quantized_decode_attention(*args, rope=rope, packed=packed)
    again = DA.quantized_decode_attention(*args, rope=rope, packed=packed)
    assert DA.quantized_decode_attention.launches == n + 2
    want = DA._decode_attention_plain(*args, rope=rope, packed=packed)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    assert _close(got, want)
    if not fold:
        assert not got[0].any()              # l clamps at 1e-9: 0, not NaN


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("bk", [1024, 256, 200])
def test_decode_attention_kernel_long_cache(gen, packed, bk):
    """S = 8192 at G = 8 (over the old limit of 32768 / G), bf16, fold on;
    the block the picker gives for ``bk`` (200 -> 128, chunks of 128)."""
    b, kvh, G, hd, S = 4, 4, 8, 64, 8192
    kq, ks, vq, vs = _cache(gen, b, kvh, hd, S, packed)
    q = torch.randn(b, kvh * G, hd, device="cuda", generator=gen).to(torch.bfloat16)
    lens = torch.tensor([S, 5000, 1, 0], dtype=torch.int32, device="cuda")
    kc, ksn = DA._rope_tables(S, hd, 10000.0, "cuda")
    fd = _quant_fold(gen, b, kvh, hd, packed, [1, 1, 0, 1], kc, ksn,
                     torch.clamp(lens.long(), max=S - 1))
    args = (q, kq, ks, vq, vs, lens, kc, ksn, fd)
    got = DA.quantized_decode_attention(*args, bk=bk, packed=packed)
    assert torch.equal(got, DA.quantized_decode_attention(*args, bk=bk, packed=packed))
    want = DA._decode_attention_plain(*args, bk=bk, packed=packed)
    torch.cuda.synchronize()
    assert _close(got, want)


def test_decode_attention_kernel_small_chunks(gen):
    """S = 2040: the picker's block is 680, so chunks of gcd(128, 680) = 8
    columns read in 8-byte pieces."""
    b, kvh, G, hd, S = 3, 4, 8, 64, 2040
    assert DA._kernel_chunk(S, kvh, hd, 1024) == (680, 8)
    kq, ks, vq, vs = _cache(gen, b, kvh, hd, S, False)
    q = torch.randn(b, kvh * G, hd, device="cuda", generator=gen).to(torch.bfloat16)
    lens = torch.tensor([2040, 681, 9], dtype=torch.int32, device="cuda")
    kc, ksn = DA._rope_tables(S, hd, 10000.0, "cuda")
    args = (q, kq, ks, vq, vs, lens, kc, ksn)
    got = DA.quantized_decode_attention(*args)
    want = DA._decode_attention_plain(*args)
    torch.cuda.synchronize()
    assert _close(got, want)


def test_decode_attention_kernel_attributes(gen):
    """Every build of decode_attn.cuh (K3, K7, K8: one for each head dim,
    range of G and q type): no spill, one block an SM at least at every G
    (the cooperative launch needs them resident), two or more where the
    carve of G heads leaves room (every G at head dims 16 and 32, G <= 8 at
    64, G <= 2 at 128 and in the padded build, whose buffers are 128's; none
    at 256); the builds of a head dim take G = 1..16 between them (1..4 at
    256), each G in the build ``_build_name`` names."""
    attrs = DA.kernel_attributes()
    gmax = {hd: DA._HD256_MAX_GROUPS if hd == DA._HD256 else 16
            for hd in DA._HEAD_DIMS + (100, DA._HD256)}
    names = {DA._build_name(g, hd, dt) for hd in gmax for g in range(1, gmax[hd] + 1)
             for dt in ("bf16", "f32")}
    assert set(attrs) == names
    room = {16: 16, 32: 16, 64: 8, 128: 2, 100: 2, 256: 0}   # the most G with two blocks an SM
    for hd in gmax:
        for dt in ("bf16", "f32"):
            for g in range(1, gmax[hd] + 1):
                by_g = attrs[DA._build_name(g, hd, dt)]["blocks_per_sm_by_g"]
                assert by_g[g] >= (2 if g <= room[hd] else 1), (hd, dt, g, by_g)
    for name, a in attrs.items():
        assert a["spill_bytes"] == 0 and a["blocks_per_sm"] >= 1, (name, a)


def _random_pool(n_pages, kvh, hd, packed, gen):
    hdc = hd // 2 if packed else hd
    lo, hi, qdt = (0, 256, torch.uint8) if packed else (-127, 128, torch.int8)
    ints = lambda: torch.randint(lo, hi, (n_pages, kvh, hdc, 128), device="cuda",  # noqa: E731
                                 generator=gen).to(qdt)
    scales = lambda: torch.rand(n_pages, 128, device="cuda", generator=gen) * 0.02 + 0.005  # noqa: E731
    return ints(), scales(), ints(), scales()


def _paged_case(b, G, hd, packed, dtype, gen, fold=True, max_pages=8):
    """Slots that are empty, hold one token, end on a page edge, mid-page
    and fill their table; shuffled tables whose unused entries point outside
    the pool; every third slot inactive."""
    kvh, P = PAGED_KVH[(G, hd)], 128
    base = [0, 1, P - 1, P, P + 1, 2 * P + 37, max_pages * P, 3 * P - 1]
    lens_l = [base[i % len(base)] for i in range(b)]
    n_pages = sum(-(-n // P) for n in lens_l) + b + 3
    pool = _random_pool(n_pages, kvh, hd, packed, gen)
    ids = torch.randperm(n_pages, device="cuda", generator=gen).tolist()
    bt = torch.full((b, max_pages), 10 ** 6, dtype=torch.int32)
    at = 0
    for i, n in enumerate(lens_l):
        live = -(-n // P)
        bt[i, :live] = torch.tensor(ids[at:at + live], dtype=torch.int32)
        at += live + 1                      # a hole: slots' pages never adjacent
    q = torch.randn(b, kvh * G, hd, device="cuda", generator=gen).to(dtype)
    lens = torch.tensor(lens_l, dtype=torch.int32, device="cuda")
    kc, ksn = DA._rope_tables(max_pages * P, hd, 10000.0, "cuda")
    fd = None
    if fold:
        flo, fhi = (-8, 8) if packed else (-127, 128)
        pos = (lens.long() % (max_pages * P))
        fd = (torch.randint(flo, fhi, (b, kvh, hd), device="cuda", generator=gen).to(torch.int8),
              torch.rand(b, 1, device="cuda", generator=gen) * 0.02 + 0.005,
              torch.randint(flo, fhi, (b, kvh, hd), device="cuda", generator=gen).to(torch.int8),
              torch.rand(b, 1, device="cuda", generator=gen) * 0.02 + 0.005,
              torch.tensor([int(i % 3 != 2) for i in range(b)], dtype=torch.int32,
                           device="cuda"),
              kc[:, pos].T.contiguous(), ksn[:, pos].T.contiguous())
    return q, pool, lens, bt.cuda(), kc, ksn, fd


PAGED_KVH = {**DECODE_KVH, (1, 128): 8}


@pytest.mark.parametrize("G,hd", list(PAGED_KVH))
@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("fold", [True, False])
@pytest.mark.parametrize("rope", [True, False])
@pytest.mark.parametrize("b", [1, 32])
def test_paged_attention_kernel(gen, G, hd, packed, dtype, fold, rope, b):
    if b == 1:
        # one slot: mid-page in its third page
        q, pool, lens, bt, kc, ksn, fd = _paged_case(6, G, hd, packed, dtype, gen, fold)
        q, lens, bt = q[5:6], lens[5:6], bt[5:6]
        fd = None if fd is None else tuple(a[5:6] for a in fd)
    else:
        q, pool, lens, bt, kc, ksn, fd = _paged_case(b, G, hd, packed, dtype, gen, fold)
    args = (q, *pool, lens, bt, kc if rope else None, ksn if rope else None, fd)
    n = DA.quantized_paged_attention.launches
    got = DA.quantized_paged_attention(*args, rope=rope, packed=packed)
    assert DA.quantized_paged_attention.launches == n + 1
    assert torch.equal(got, DA.quantized_paged_attention(*args, rope=rope, packed=packed))
    want = DA._paged_attention_plain(*args, rope=rope, packed=packed)
    torch.cuda.synchronize()
    assert _close(got, want)
    if not fold:
        empty = lens == 0
        assert not got[empty].any()          # l clamps at 1e-9: 0, not NaN


def test_paged_attention_kernel_builds_its_own_tables_and_refuses_other_shapes(gen):
    q, pool, lens, bt, kc, ksn, fd = _paged_case(8, 8, 64, False, torch.bfloat16, gen)
    a = DA.quantized_paged_attention(q, *pool, lens, bt, kc, ksn, fd)
    b = DA.quantized_paged_attention(q, *pool, lens, bt, None, None, fd)
    assert torch.equal(a, b)
    with pytest.raises(NotImplementedError, match=r"1 <= G <= 16 query heads per kv head"):
        DA.quantized_paged_attention(torch.cat([q, q, q[:, :4]], 1), *pool, lens, bt)  # G = 17
    small = tuple(t[..., :64].contiguous() for t in pool)
    with pytest.raises(NotImplementedError, match="page size 128"):
        DA.quantized_paged_attention(q, *small, lens, bt)
    with pytest.raises(ValueError, match="contiguous"):
        DA.quantized_paged_attention(q, pool[0].transpose(0, 1).contiguous().transpose(0, 1),
                                     *pool[1:], lens, bt)


@pytest.mark.parametrize("layer", [0, 3, 21])
@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
def test_stacked_gemm_kernels_bit_exact(gen, layer, out_dtype):
    """Layer ``layer`` of a 22-layer stack read in place: equal to the plain
    version and to the unstacked kernel on that layer's slice."""
    L, M, K, N = 22, 32, 2048, 256
    x = torch.randn(M, K, device="cuda", generator=gen)
    w = torch.randn(L, K, N, device="cuda", generator=gen) * 0.02
    xq, sx = QM.quantize_per_token(x)
    wq, sw = QM.quantize_per_channel(w)
    n = QM.int8_matmul_stacked.launches
    got = QM.int8_matmul_stacked(xq, wq, sx, sw, layer=layer, out_dtype=out_dtype)
    assert QM.int8_matmul_stacked.launches == n + 1
    assert torch.equal(got, QM._int8_matmul_plain(xq, wq[layer], sx, sw[layer], out_dtype))
    assert torch.equal(got, QM.int8_matmul(xq, wq[layer], sx, sw[layer], out_dtype=out_dtype))
    wp, sw4 = QM.quantize_weights_w4(w)
    got4 = QM.int4_matmul_stacked(xq, wp, sx, sw4, layer=layer, out_dtype=out_dtype)
    assert torch.equal(got4, QM._int4_matmul_plain(xq, wp[layer], sx, sw4[layer], out_dtype))
    assert torch.equal(got4, QM.int4_matmul(xq, wp[layer], sx, sw4[layer], out_dtype=out_dtype))
    with pytest.raises(ValueError, match="contiguous"):
        QM.int8_matmul_stacked(xq, wq.transpose(1, 2).contiguous().transpose(1, 2), sx, sw,
                               layer=layer)


@pytest.mark.parametrize("layer", [0, 2])
@pytest.mark.parametrize("rope", [True, False])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("kvh,G,hd", [(4, 8, 64), (32, 1, 128), (2, 2, 16), (4, 2, 32),
                                      (8, 4, 128), (8, 8, 128), (12, 1, 64), (8, 3, 128),
                                      (8, 4, 64), (8, 7, 128), (8, 12, 128), (8, 16, 128),
                                      (1, 16, 128), (8, 9, 64), (2, 12, 32), (4, 3, 256),
                                      (4, 4, 256)])
def test_stacked_decode_attention_kernel(gen, layer, rope, dtype, kvh, G, hd):
    L, b, S = 3, 8, 512
    kq = torch.randint(-127, 128, (L, b, kvh, hd, S), device="cuda", generator=gen).to(torch.int8)
    vq = torch.randint(-127, 128, (L, b, kvh, hd, S), device="cuda", generator=gen).to(torch.int8)
    ks = torch.rand(L, b, S, device="cuda", generator=gen) * 0.02 + 0.005
    vs = torch.rand(L, b, S, device="cuda", generator=gen) * 0.02 + 0.005
    q = torch.randn(b, kvh * G, hd, device="cuda", generator=gen).to(dtype)
    lens = torch.tensor([0, 0, 17, 255, 256, 257, 400, 511], dtype=torch.int32, device="cuda")
    inc = torch.tensor([1, 0, 1, 1, 0, 1, 1, 1], dtype=torch.int32, device="cuda")
    kn = (torch.randn(b, kvh, hd, device="cuda", generator=gen) * 0.5).to(dtype)
    vn = (torch.randn(b, kvh, hd, device="cuda", generator=gen) * 0.5).to(dtype)
    kc, ksn = DA._rope_tables(S, hd, 10000.0, "cuda")
    args = (q, kq, ks, vq, vs, lens, inc, kn, vn, kc if rope else None, ksn if rope else None)
    n = DA.quantized_decode_attention_stacked.launches
    got = DA.quantized_decode_attention_stacked(*args, layer=layer, rope=rope)
    assert DA.quantized_decode_attention_stacked.launches == n + 1
    assert torch.equal(got, DA.quantized_decode_attention_stacked(*args, layer=layer, rope=rope))
    want = DA._decode_attention_stacked_plain(*args, layer=layer, rope=rope)
    torch.cuda.synchronize()
    assert _close(got, want)


@pytest.mark.parametrize("S", [16, 100, 1024, 1536, 1800, 2048])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("soft_bf16", [False, True])
def test_flash_fwd_kernel(gen, S, causal, soft_bf16):
    """1536 and 2048 cross the TPU kernel's key blocks (768, 1024 keys); at
    1800 its 120-key blocks straddle the kernel's 64-key tiles."""
    B, G, D = 4, 8, 64
    q = torch.randn(B, G, S, D, device="cuda", generator=gen).to(torch.bfloat16)
    k = torch.randn(B, S, D, device="cuda", generator=gen).to(torch.bfloat16)
    v = torch.randn(B, S, D, device="cuda", generator=gen).to(torch.bfloat16)
    lens = torch.tensor([S, 0, S // 2, S - 1], dtype=torch.int32, device="cuda")
    o, lse = FA._flash_fwd(q, k, v, lens, causal=causal, soft_bf16=soft_bf16)
    o2, lse2 = FA._flash_fwd_plain(q, k, v, lens, causal, soft_bf16)
    assert _close(o, o2)
    assert float((lse - lse2).abs().max()) < 1e-3


@pytest.mark.parametrize("S", [32, 64, 100, 200])
def test_flash_fwd_kernel_scorer_shapes(gen, S):
    """The zero-shot scorer's buckets: powers of two from 32 and caps of 100
    and 200 keys (the kernel's 64-key tiles are wider than S = 32 and
    straddle the edge at 100 and 200), 16 rows x 4 kv heads, G = 8, ragged
    lengths and a padded tail of empty rows, as ``chip_smoke.py`` runs it."""
    lens_l = chip_smoke.scorer_lens(S)
    B, G, D = len(lens_l), 8, 64
    q = torch.randn(B, G, S, D, device="cuda", generator=gen).to(torch.bfloat16)
    k = torch.randn(B, S, D, device="cuda", generator=gen).to(torch.bfloat16)
    v = torch.randn(B, S, D, device="cuda", generator=gen).to(torch.bfloat16)
    lens = torch.tensor(lens_l, dtype=torch.int32, device="cuda")
    n = FA._flash_fwd.launches
    o, lse = FA._flash_fwd(q, k, v, lens)
    assert FA._flash_fwd.launches == n + 1
    o2, lse2 = FA._flash_fwd_plain(q, k, v, lens)
    assert _close(o, o2)
    assert float((lse - lse2).abs().max()) < 1e-3


@pytest.mark.parametrize("soft_bf16", [False, True])
def test_flash_fwd_kernel_full_lengths(gen, soft_bf16):
    """The train step's sequence length, causal, every sequence full (the
    ragged lengths at S = 2048 are ``test_flash_fwd_kernel``'s)."""
    B, G, S, D = 4, 8, 2048, 64
    q = torch.randn(B, G, S, D, device="cuda", generator=gen).to(torch.bfloat16)
    k = torch.randn(B, S, D, device="cuda", generator=gen).to(torch.bfloat16)
    v = torch.randn(B, S, D, device="cuda", generator=gen).to(torch.bfloat16)
    lens = torch.full((B,), S, dtype=torch.int32, device="cuda")
    o, lse = FA._flash_fwd(q, k, v, lens, soft_bf16=soft_bf16)
    o2, lse2 = FA._flash_fwd_plain(q, k, v, lens, True, soft_bf16)
    assert _close(o, o2)
    assert float((lse - lse2).abs().max()) < 1e-3


@pytest.mark.parametrize("S", [100, 1024, 1536, 2048])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_fwd_kernel_head_dim_128(gen, S, causal):
    """LLaMA-7B's heads: MHA (G = 1) at head dim 128, bf16."""
    B, G, D = 4, 1, 128
    q = torch.randn(B, G, S, D, device="cuda", generator=gen).to(torch.bfloat16)
    k = torch.randn(B, S, D, device="cuda", generator=gen).to(torch.bfloat16)
    v = torch.randn(B, S, D, device="cuda", generator=gen).to(torch.bfloat16)
    lens = torch.tensor([S, 0, S // 2, S - 1], dtype=torch.int32, device="cuda")
    n = FA._flash_fwd.launches
    o, lse = FA._flash_fwd(q, k, v, lens, causal=causal)
    assert FA._flash_fwd.launches == n + 1
    o2, lse2 = FA._flash_fwd_plain(q, k, v, lens, causal)
    assert _close(o, o2)
    assert float((lse - lse2).abs().max()) < 1e-3


def test_flash_fwd_kernel_refuses_shapes_it_is_not_built_for(gen):
    q = torch.randn(1, 1, 64, 128, device="cuda", generator=gen)
    k = torch.randn(1, 64, 128, device="cuda", generator=gen)
    lens = torch.tensor([64], dtype=torch.int32, device="cuda")
    with pytest.raises(NotImplementedError, match=r"head dims \(16, 32, 64, 128\) and every "
                                                  r"hd % 4 == 0 with 32 < hd <= 128"):
        FA._flash_fwd(*(t[..., :98].to(torch.bfloat16) for t in (q, k, k)), lens)
    with pytest.raises(NotImplementedError, match="one type for every operand"):
        FA._flash_fwd(q, k.to(torch.bfloat16), k, lens)


@pytest.mark.parametrize("S", [100, 1024, 1536, 1800])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_fwd_kernel_f32(gen, S, causal):
    """The f32 instantiation (the fp32-unit kernel) to 1e-5."""
    B, G, D = 4, 8, 64
    q = torch.randn(B, G, S, D, device="cuda", generator=gen)
    k = torch.randn(B, S, D, device="cuda", generator=gen)
    v = torch.randn(B, S, D, device="cuda", generator=gen)
    lens = torch.tensor([S, 0, S // 2, S - 1], dtype=torch.int32, device="cuda")
    o, lse = FA._flash_fwd(q, k, v, lens, causal=causal)
    o2, lse2 = FA._flash_fwd_plain(q, k, v, lens, causal)
    assert _close(o, o2)
    assert float((lse - lse2).abs().max()) < 1e-5


def _random_cache(cfg, b, S, gen):
    packed = M.cache_is_packed(cfg)
    shape = (cfg.num_hidden_layers, b, cfg.kv_heads,
             cfg.head_dim // 2 if packed else cfg.head_dim, S)
    lo, hi, qdt = (0, 256, torch.uint8) if packed else (-127, 128, torch.int8)
    ints = lambda: torch.randint(lo, hi, shape, device="cuda", generator=gen).to(qdt)  # noqa: E731
    scales = lambda: torch.rand(shape[0], b, S, device="cuda", generator=gen) * 0.02 + 0.005  # noqa: E731
    return {"k_q": ints(), "k_s": scales(), "v_q": ints(), "v_s": scales()}


def _megakernel_against_plain(cfg, lens, active, dtype, gen, S, exact=False):
    """One decode step through the kernel and through its plain version
    from the same random cache and weights (``exact``: logits bit-equal)."""
    qp = Q.quantize_params(P.init_params(cfg, seed=0, dtype=dtype), cfg)
    b = len(lens)
    cache = _random_cache(cfg, b, S, gen)
    lens_t = torch.tensor(lens, dtype=torch.int32, device="cuda")
    act = torch.tensor(active, device="cuda")
    ids = torch.randint(0, cfg.vocab_size, (b, 1), device="cuda", generator=gen)
    n0 = MK.decode_layers.launches
    c1 = {k: v.clone() for k, v in cache.items()}
    lg1, c1 = MK.decode_step(qp, cfg, ids, lens_t, act, c1, dtype)
    assert MK.decode_layers.launches == n0 + 1          # one launch for all layers
    c2 = {k: v.clone() for k, v in cache.items()}
    lg2, c2 = MK.decode_step_plain(qp, cfg, ids, lens_t, act, c2, dtype)
    assert MK.decode_layers.launches == n0 + 1
    torch.cuda.synchronize()
    for k in ("k_q", "v_q", "lengths"):
        assert torch.equal(c1[k], c2[k]), k
    for k in ("k_s", "v_s"):
        assert torch.allclose(c1[k], c2[k], rtol=1e-6, atol=0), k
    assert torch.equal(lg1, lg2) if exact else _close(lg1, lg2)
    # the step wrote column `length` of active slots and nothing below it
    for i, (n, a) in enumerate(zip(lens, active)):
        assert torch.equal(c1["k_q"][:, i, :, :, :n], cache["k_q"][:, i, :, :, :n])
        assert c1["lengths"][i] == n + int(a)
    return lg1


K9_MODES = {
    "w8kv8": dict(w_bits=8, a_bits=8, kv_bits=8),
    "w4kv4_packed": dict(w_bits=4, a_bits=8, kv_bits=4, kv_cache_pack=True),
}


@pytest.mark.parametrize("mode", list(K9_MODES))
@pytest.mark.parametrize("rope_mode", ["pre", "post"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b", [1, 8, 32])
def test_decode_megakernel_against_plain(gen, mode, rope_mode, dtype, b):
    """A 2-layer cut at TinyLlama-1.1B width, max_len 2048: slots that are
    empty, end inside a KV block, on a block edge and some blocks in; one
    inactive. b = 32 fills the products' second row tile; at W8A8KV8 it
    takes the KV block of 128 that the JAX picker gives it (512 elsewhere)."""
    cfg = TINYLLAMA_1B.replace(num_hidden_layers=2, kv_cache_rope=rope_mode, **K9_MODES[mode])
    assert MK.supported(cfg, b, 2048)
    assert MK.pick_bk(cfg, b, 2048) == (128 if (b, mode) == (32, "w8kv8") else 512)
    lens = [48, 0, 282, 511, 512, 513, 1024, 1400]
    active = [True, True, False, True, True, True, True, True]
    if b == 1:
        lens, active = [700], [True]
    elif b == 32:
        lens = lens + [(37 * i) % 2000 for i in range(24)]
        active = active + [i % 5 != 0 for i in range(24)]
    lg = _megakernel_against_plain(cfg, lens, active, dtype, gen, 2048)
    assert lg.shape == (b, 1, cfg.vocab_size) and lg.dtype == torch.float32


@pytest.mark.parametrize("bk,S", [(128, 1024), (64, 64), (1024, 2048)])
def test_decode_megakernel_other_kv_blocks(gen, bk, S):
    """megakernel_bk overrides and a short cache: more blocks per slot (the
    online rescale runs more often), one block, and the largest block whose
    scores, K and V bytes fit a block's shared memory."""
    cfg = TINYLLAMA_1B.replace(num_hidden_layers=2, w_bits=4, a_bits=8, kv_bits=4,
                               megakernel_bk=bk)
    assert MK.pick_bk(cfg, 4, S) == bk
    lens = [min(n, S - 2) for n in (5, 130, 500, 1023)]
    _megakernel_against_plain(cfg, lens, [True, False, True, True], torch.bfloat16, gen, S)


@pytest.mark.parametrize("mode", list(K9_MODES))
@pytest.mark.parametrize("rope_mode", ["pre", "post"])
@pytest.mark.parametrize("bk", [0, 128])
@pytest.mark.parametrize("b", [1, 8, 32])
def test_decode_megakernel_mha_head_dim_128_against_plain(gen, mode, rope_mode, bk, b):
    """The (1, 128) instantiation on a 2-layer cut at LLaMA-7B width, max_len
    2048: the JAX picker's KV block (bk = 0) and a block of 128 (two
    attention chunks a block); lengths as the TinyLlama case."""
    cfg = LLAMA_7B.replace(num_hidden_layers=2, kv_cache_rope=rope_mode, megakernel_bk=bk,
                           **K9_MODES[mode])
    assert MK.card_takes(cfg, b, 2048, torch.bfloat16)
    if bk:
        assert MK.pick_bk(cfg, b, 2048) == bk
    lens = [48, 0, 282, 511, 512, 513, 1024, 1400]
    active = [True, True, False, True, True, True, True, True]
    if b == 1:
        lens, active = [700], [True]
    elif b == 32:
        lens = lens + [(37 * i) % 2000 for i in range(24)]
        active = active + [i % 5 != 0 for i in range(24)]
    lg = _megakernel_against_plain(cfg, lens, active, torch.bfloat16, gen, 2048)
    assert lg.shape == (b, 1, cfg.vocab_size) and lg.dtype == torch.float32


def test_decode_megakernel_kernel_attributes(gen):
    """Every variant of the kernel (bf16 and f32 at head dims 64 and 128 and
    in the padded build, for 1..8 and 9..16 query heads a kv head, and at
    256 for 1..8; G at run time) keeps its registers (no spill) and fits one
    block an SM: the cooperative grid is one block per SM."""
    attrs = MK.kernel_attributes()
    assert len(attrs) == 14 and {"bf16_d256", "f32_d256"} <= set(attrs)
    for name, a in attrs.items():
        assert a["spill_bytes"] == 0, (name, a)
        assert a["blocks_per_sm"] >= 1 and a["threads"] == 256, (name, a)


def test_decode_megakernel_refuses_shapes_it_is_not_built_for(gen):
    cfg = LLAMA_7B.replace(num_hidden_layers=1, vocab_size=256, hidden_size=4352,
                           intermediate_size=8192, w_bits=8, a_bits=8, kv_bits=8)  # head dim 136
    qp = Q.quantize_params(P.init_params(cfg, seed=0, dtype=torch.bfloat16), cfg)
    cache = M.init_serving_cache(cfg, 1, 256)
    assert not MK.card_takes(cfg, 1, 256, torch.bfloat16)
    with pytest.raises(NotImplementedError,
                       match="1 <= G <= 16 query heads per kv head at head dims 64 and 128 and "
                             "every hd % 4 == 0 with 32 < hd <= 128"):
        MK.decode_step(qp, cfg, [[3]], [0], [True], cache)


@pytest.mark.parametrize("G", [*range(1, 9), 9, 12, 16])
@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("mode", list(K9_MODES))
@pytest.mark.parametrize("rope_mode", ["pre", "post"])
def test_decode_megakernel_every_gqa_shape_against_plain(gen, G, hd, mode, rope_mode):
    """G query heads per kv head at head dims 64 and 128 (8 kv heads, the
    public GQA checkpoints'), a 2-layer cut with an intermediate size of
    2048, b = 8, max_len 2048 at the JAX picker's block: lengths as the
    TinyLlama case. G = 9, 12 and 16 through the builds of 9..16."""
    kvh = 8
    cfg = LLAMA_7B.replace(num_hidden_layers=2, hidden_size=kvh * G * hd, intermediate_size=2048,
                           num_attention_heads=kvh * G, num_key_value_heads=kvh,
                           kv_cache_rope=rope_mode, **K9_MODES[mode])
    assert MK.card_takes(cfg, 8, 2048, torch.bfloat16)
    lens = [48, 0, 282, 511, 512, 513, 1024, 1400]
    active = [True, True, False, True, True, True, True, True]
    lg = _megakernel_against_plain(cfg, lens, active, torch.bfloat16, gen, 2048)
    assert lg.shape == (8, 1, cfg.vocab_size)


@pytest.mark.parametrize("G", range(1, 9))
@pytest.mark.parametrize("mode", list(K9_MODES))
@pytest.mark.parametrize("rope_mode", ["pre", "post"])
@pytest.mark.parametrize("b", [1, 8])
def test_decode_megakernel_head_dim_256_against_plain(gen, G, mode, rope_mode, b):
    """The hd-256 build (Falcon3's (3, 256) and (2, 256); attention items of
    64 cache columns) at every G of 1..8 over 4 kv heads, a 2-layer cut with
    an intermediate size of 2048, max_len 2048 at the JAX picker's block;
    bit-equal to its plain version."""
    kvh = 4
    cfg = LLAMA_7B.replace(num_hidden_layers=2, hidden_size=kvh * G * 256, intermediate_size=2048,
                           num_attention_heads=kvh * G, num_key_value_heads=kvh,
                           kv_cache_rope=rope_mode, **K9_MODES[mode])
    assert MK.card_takes(cfg, b, 2048, torch.bfloat16) and MK._stem(256, G) == "megakernel_d256"
    lens = [48, 0, 282, 511, 512, 513, 1024, 2000]
    active = [True, True, False, True, True, True, True, True]
    if b == 1:
        lens, active = [1500], [True]
    lg = _megakernel_against_plain(cfg, lens, active, torch.bfloat16, gen, 2048, exact=True)
    assert lg.shape == (b, 1, cfg.vocab_size)


@pytest.mark.parametrize("S", [16, 100, 256, 1100])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype,G", [(torch.bfloat16, 8), (torch.float32, 4), (torch.bfloat16, 1)])
def test_flash_bwd_kernels(gen, S, causal, dtype, G):
    """dQ and dK/dV against their plain versions from the forward kernel's
    own O and log-sum-exp; full, empty, half and one-short lengths. Columns
    past the length get exact-zero dK and dV."""
    B, D = 4, 64
    q = torch.randn(B, G, S, D, device="cuda", generator=gen).to(dtype)
    k = torch.randn(B, S, D, device="cuda", generator=gen).to(dtype)
    v = torch.randn(B, S, D, device="cuda", generator=gen).to(dtype)
    do = torch.randn(B, G, S, D, device="cuda", generator=gen).to(dtype)
    lens = torch.tensor([S, 0, S // 2, S - 1], dtype=torch.int32, device="cuda")
    o, lse = FA._flash_fwd(q, k, v, lens, causal=causal)
    n = (FA._flash_bwd_dq.launches, FA._flash_bwd_dkv.launches)
    dq, dk, dv = FA._flash_bwd(q, k, v, lens, o, lse, do, causal)
    assert (FA._flash_bwd_dq.launches, FA._flash_bwd_dkv.launches) == (n[0] + 1, n[1] + 1)
    dq2, dk2, dv2 = FA._flash_bwd_plain(q, k, v, lens, o, lse, do, causal)
    torch.cuda.synchronize()
    assert _close(dq, dq2) and _close(dk, dk2) and _close(dv, dv2)
    assert not dk[1, 1:].any() and not dv[1, 1:].any()
    assert not dk[2, S // 2:].any() and not dv[2, S // 2:].any()


@pytest.mark.parametrize("S,G", [(2048, 1), (2048, 8), (1050, 1), (1050, 8)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_bwd_dkv_kernel_pairs_key_blocks(gen, S, G, causal):
    """The bf16 dK/dV kernel runs key blocks kb and nkb - 1 - kb in one
    thread block; S = 1050 has 17 key blocks of 64, so the middle one runs
    alone. Against the plain version, exact zeros past each length, and a
    second launch on the same inputs gives the same bits (no atomics). One
    sequence of length 1 and one cut mid-tile: more empty sequences would
    make most of dK exact zeros, and the limit's median floor zero."""
    B, D = 4, 64
    q, do = (torch.randn(B, G, S, D, device="cuda", generator=gen).to(torch.bfloat16)
             for _ in range(2))
    k, v = (torch.randn(B, S, D, device="cuda", generator=gen).to(torch.bfloat16)
            for _ in range(2))
    lens_l = [S, S // 2 + 3, 1, S - 5]
    lens = torch.tensor(lens_l, dtype=torch.int32, device="cuda")
    o, lse = FA._flash_fwd(q, k, v, lens, causal=causal)
    args = (q, k, v, lens, lse, FA._delta(o, do), do, causal)
    dk, dv = FA._flash_bwd_dkv(*args)
    dk_again, dv_again = FA._flash_bwd_dkv(*args)
    dk2, dv2 = FA._flash_bwd_dkv_plain(*args)
    torch.cuda.synchronize()
    assert _close(dk, dk2) and _close(dv, dv2)
    assert torch.equal(dk, dk_again) and torch.equal(dv, dv_again)
    for b, n in enumerate(lens_l):
        assert not dk[b, max(n, 1):].any() and not dv[b, max(n, 1):].any()


@pytest.mark.parametrize("short", [0, 1])
@pytest.mark.parametrize("S", [100, 1100])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("G", [1, 8])
@pytest.mark.parametrize("D", [64, 128])
def test_flash_bwd_tensor_core_kernels(gen, D, G, causal, S, short):
    """The bf16 dQ and dK/dV kernels at head dim 64 and 128 against their
    plain versions, from the forward kernel's O and log-sum-exp; lengths S,
    one near-empty sequence (0 or 1: more would make most of dK exact zeros
    and the limit's median floor zero), one cut mid-tile (a non-multiple of
    64) and one a few short. Exact zeros past each length in dK and dV, and
    the same bits from a second launch of each kernel."""
    B = 4
    q, do = (torch.randn(B, G, S, D, device="cuda", generator=gen).to(torch.bfloat16)
             for _ in range(2))
    k, v = (torch.randn(B, S, D, device="cuda", generator=gen).to(torch.bfloat16)
            for _ in range(2))
    lens_l = [S, short, S // 2 + 3, S - 5]
    lens = torch.tensor(lens_l, dtype=torch.int32, device="cuda")
    o, lse = FA._flash_fwd(q, k, v, lens, causal=causal)
    args = (q, k, v, lens, lse, FA._delta(o, do), do, causal)
    n = (FA._flash_bwd_dq.launches, FA._flash_bwd_dkv.launches)
    dq, (dk, dv) = FA._flash_bwd_dq(*args), FA._flash_bwd_dkv(*args)
    assert (FA._flash_bwd_dq.launches, FA._flash_bwd_dkv.launches) == (n[0] + 1, n[1] + 1)
    dq_again, (dk_again, dv_again) = FA._flash_bwd_dq(*args), FA._flash_bwd_dkv(*args)
    dq2, (dk2, dv2) = FA._flash_bwd_dq_plain(*args), FA._flash_bwd_dkv_plain(*args)
    torch.cuda.synchronize()
    assert _close(dq, dq2) and _close(dk, dk2) and _close(dv, dv2)
    assert torch.equal(dq, dq_again) and torch.equal(dk, dk_again) and torch.equal(dv, dv_again)
    for b, n_live in enumerate(lens_l):
        assert not dk[b, max(n_live, 1):].any() and not dv[b, max(n_live, 1):].any()


def test_flash_bwd_kernels_refuse_other_head_dims(gen):
    """Outside the built head dims and the padded rule (98: hd % 4 != 0;
    132 and 256: above 128, 256 being the forward's only) K10 and K11 raise
    naming both; the padded rule's 96 launches."""
    lens = torch.full((1,), 64, dtype=torch.int32, device="cuda")
    lse = torch.zeros(1, 1, 1, 64, device="cuda")
    for D in (98, 132, 256, 96):
        q = torch.randn(1, 1, 64, D, device="cuda", generator=gen)
        k = torch.randn(1, 64, D, device="cuda", generator=gen)
        for fn in (FA._flash_bwd_dq, FA._flash_bwd_dkv):
            if D == 96:
                fn(q, k, k, lens, lse, lse, q)
                continue
            rule = r"head dims \(16, 32, 64, 128\) and every hd % 4 == 0 with 32 < hd <= 128"
            with pytest.raises(NotImplementedError, match=rule):
                fn(q, k, k, lens, lse, lse, q)
    torch.cuda.synchronize()


@pytest.mark.parametrize("S", [100, 1100])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("G", [1, 2, 8])
@pytest.mark.parametrize("D,dtype", [(16, torch.bfloat16), (16, torch.float32),
                                     (32, torch.bfloat16), (32, torch.float32),
                                     (128, torch.float32)])
def test_flash_kernels_at_the_new_head_dims(gen, D, dtype, G, causal, S):
    """K4, K10 and K11 at head dims 16 and 32 (bf16: the narrow-row swizzle;
    f32: the SIMT kernels) and 128 in f32 against their plain versions, from
    the forward kernel's O and log-sum-exp; lengths S, 1, one cut mid-tile and
    one a few short. Exact zeros past each length in dK and dV, and the same
    bits from a second launch of each kernel."""
    B = 4
    q, do = (torch.randn(B, G, S, D, device="cuda", generator=gen).to(dtype) for _ in range(2))
    k, v = (torch.randn(B, S, D, device="cuda", generator=gen).to(dtype) for _ in range(2))
    lens_l = [S, 1, S // 2 + 3, S - 5]
    lens = torch.tensor(lens_l, dtype=torch.int32, device="cuda")
    n = FA._flash_fwd.launches
    o, lse = FA._flash_fwd(q, k, v, lens, causal=causal)
    o_again, _ = FA._flash_fwd(q, k, v, lens, causal=causal)
    assert FA._flash_fwd.launches == n + 2
    o2, lse2 = FA._flash_fwd_plain(q, k, v, lens, causal)
    args = (q, k, v, lens, lse, FA._delta(o, do), do, causal)
    dq, (dk, dv) = FA._flash_bwd_dq(*args), FA._flash_bwd_dkv(*args)
    dq_again, (dk_again, dv_again) = FA._flash_bwd_dq(*args), FA._flash_bwd_dkv(*args)
    dq2, (dk2, dv2) = FA._flash_bwd_dq_plain(*args), FA._flash_bwd_dkv_plain(*args)
    torch.cuda.synchronize()
    assert _close(o, o2) and torch.equal(o, o_again)
    assert float((lse - lse2).abs().max()) < (1e-3 if dtype == torch.bfloat16 else 1e-5)
    assert _close(dq, dq2) and _close(dk, dk2) and _close(dv, dv2)
    assert torch.equal(dq, dq_again) and torch.equal(dk, dk_again) and torch.equal(dv, dv_again)
    for b, n_live in enumerate(lens_l):
        assert not dk[b, max(n_live, 1):].any() and not dv[b, max(n_live, 1):].any()


def test_flash_kernel_attributes(gen):
    """Every K4/K10/K11 kernel (bf16 tensor-core and f32 SIMT, head dims 16,
    32, 64, 128, and the padded builds; K4 at 256 too) compiles to at most
    255 registers a thread, spills nothing, and fits at least one block on
    an SM."""
    attrs = FA.kernel_attributes()
    assert set(attrs) == {FA._entry(stem, D) + suf for stem in
                          ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
                          for D in FA.HEAD_DIMS for suf in ("", "_f32")} | {
        f"{stem}_dpad{suf}" for stem in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
        for suf in ("", "_f32")} | {"flash_fwd_d256", "flash_fwd_d256_f32"}
    for name, a in attrs.items():
        assert a["spill_bytes"] == 0 and a["registers"] <= 255, (name, a)
        assert a["threads"] == (256 if name.endswith(("_f32", "_d256")) else 128), (name, a)
        assert a["blocks_per_sm"] >= 1, (name, a)


def test_flash_attention_gqa_gradient_runs_the_kernels(gen):
    B, G, S, D = 2, 8, 128, 64
    q, k, v = (torch.randn(*sh, device="cuda", generator=gen).to(torch.bfloat16)
               .requires_grad_(True) for sh in ((B, G, S, D), (B, S, D), (B, S, D)))
    lens = torch.tensor([S, 70], dtype=torch.int32, device="cuda")
    saved = FA.AttnSaved()
    n4, n10 = FA._flash_fwd.launches, FA._flash_bwd_dq.launches
    o = FA.flash_attention_gqa(q, k, v, lens, False, saved)
    o_again = FA.flash_attention_gqa(q, k, v, lens, False, saved)    # reads the holder
    assert FA._flash_fwd.launches == n4 + 1 and o_again.data_ptr() == saved.o.data_ptr()
    g = torch.randn_like(o)
    dq, dk, dv = torch.autograd.grad(o, (q, k, v), g)
    assert FA._flash_bwd_dq.launches == n10 + 1
    want = FA._flash_bwd_plain(q.detach(), k.detach(), v.detach(), lens, o.detach(),
                               saved.lse, g)
    assert all(_close(a, b) for a, b in zip((dq, dk, dv), want))
    with pytest.raises(NotImplementedError, match=r"head dims \(16, 32, 64, 128\)"):
        FA._flash_bwd(q[..., :50].detach(), k[..., :50].detach(), v[..., :50].detach(), lens,
                      o[..., :50].detach(), saved.lse, g[..., :50])


# row widths of the models' hidden and MLP rows (TinyLlama, LLaMA-7B/13B/30B)
QUANT_WIDTHS = [128, 2048, 4096, 5120, 5632, 6656, 11008, 13824, 17920]


def _quant_input(gen, M, K, dtype, scale):
    """Random rows with row 0 all zeros (s = qmax / 1e-6) and one outlier in
    row 1 (it alone sets the row's scale)."""
    x = torch.randn(M, K, device="cuda", generator=gen) * scale
    x[0] = 0
    x[1, K // 3] = 40 * scale
    return x.to(dtype)


def _same_bits(got, again, want):
    """Integers and scales equal to the plain version's, and a second
    launch's equal to the first's."""
    return all(torch.equal(a, b) for a, b in zip(got, want)) and all(
        torch.equal(a, b) for a, b in zip(got, again))


# 8192 + 5 rows are several times what the SMs hold at once at these widths,
# so each of RMSNorm's row groups walks rows through its ring of two stages
@pytest.mark.parametrize("M,K", [(M, K) for M in (8, 13) for K in QUANT_WIDTHS]
                         + [(8192 + 5, K) for K in (2048, 4096, 5120)])
@pytest.mark.parametrize("h_dtype,g_dtype", [(torch.bfloat16, torch.bfloat16),
                                             (torch.bfloat16, torch.float32),
                                             (torch.float32, torch.float32),
                                             (torch.float32, torch.bfloat16)])
@pytest.mark.parametrize("a_bits", [8, 4])
def test_rmsnorm_quant_kernel(gen, M, K, h_dtype, g_dtype, a_bits):
    """13 and 8197 rows are multiples of no block's row count (8, 4 or 2 row
    groups); at 8197 the grid (what the SMs hold at once) is smaller than
    the row groups the rows need."""
    h = _quant_input(gen, M, K, h_dtype, 1.5)
    g = (1 + 0.1 * torch.randn(K, device="cuda", generator=gen)).to(g_dtype)
    n = FQ.rmsnorm_quant.launches
    got = FQ.rmsnorm_quant(h, g, 1e-5, a_bits)
    assert FQ.rmsnorm_quant.launches == n + 1
    again = FQ.rmsnorm_quant(h, g, 1e-5, a_bits)
    want = FQ._rmsnorm_quant_plain(h, g, 1e-5, a_bits)
    torch.cuda.synchronize()
    assert got[0].dtype == torch.int8 and got[1].shape == (M, 1)
    assert _same_bits(got, again, want)
    assert not got[0][0].any() and float(got[1][0]) == float(want[1][0])
    if M > 8192:   # an SM holds at most 2048 threads: fewer row groups than rows
        v, wpr, _ = FQ.plan(K, h.element_size(), 1, f32_products=g_dtype != torch.bfloat16
                            or h_dtype != torch.bfloat16)
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        assert v > 0 and sms * (2048 // (32 * wpr)) < M


def test_rmsnorm_quant_bit_equal_where_the_sum_order_moves_an_integer(gen):
    """The shape where K12 once gave an integer two levels off its plain
    version (the input stream is not kept): [4096, 5120] bf16 with a bf16
    gain. A seeded search stands in for it: rows from four seeds, among
    which the fp32 ``sum(dim=1)`` order, the plain version's before it took
    the kernel's, moves integers off the kernel's. The kernel equals the
    plain version to the bit on every seed."""
    moved = []
    for seed in range(4):
        g = gen
        g.manual_seed(1000 + seed)
        h = (torch.randn(4096, 5120, device="cuda", generator=g) * 1.5).to(torch.bfloat16)
        w = (1 + 0.1 * torch.randn(5120, device="cuda", generator=g)).to(torch.bfloat16)
        got = FQ.rmsnorm_quant(h, w, 1e-5, 8)
        assert _same_bits(got, FQ.rmsnorm_quant(h, w, 1e-5, 8),
                          FQ._rmsnorm_quant_plain(h, w, 1e-5, 8)), seed
        other = FQ._rmsnorm_quant_plain(h, w, 1e-5, 8, kernel_order=False)
        moved.append(int((got[0] != other[0]).sum()))
    assert sum(moved) > 0, moved


@pytest.mark.parametrize("K", QUANT_WIDTHS)
@pytest.mark.parametrize("M", [8, 13])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("a_bits", [8, 4])
def test_silu_mul_quant_kernel(gen, M, K, dtype, a_bits):
    gate = _quant_input(gen, M, K, dtype, 2.0)
    up = torch.randn(M, K, device="cuda", generator=gen).to(dtype)
    n = FQ.silu_mul_quant.launches
    got = FQ.silu_mul_quant(gate, up, a_bits)
    assert FQ.silu_mul_quant.launches == n + 1
    again = FQ.silu_mul_quant(gate, up, a_bits)
    want = FQ._silu_mul_quant_plain(gate, up, a_bits)
    torch.cuda.synchronize()
    assert _same_bits(got, again, want)
    assert not got[0][0].any()


# a tp rank's intermediate columns: TinyLlama-1.1B at tp = 2, LLaMA-7B at tp = 2 and 4
TP_SILU_WIDTHS = [2816, 5504, 2752]


@pytest.mark.parametrize("K", TP_SILU_WIDTHS)
@pytest.mark.parametrize("M", [8, 8192 + 5])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_silu_mul_quant_tp_entries(gen, M, K, dtype):
    """K13's entries for tensor parallelism at a tp rank's widths: the row
    max and the quantization with a given row max, each bit-equal to its
    plain version and the same bits twice; two ranks' columns quantized with
    the MAX of their row maxima give the one-pass kernel's integers and
    scales of the whole row."""
    gate = _quant_input(gen, M, 2 * K, dtype, 2.0)
    up = torch.randn(M, 2 * K, device="cuda", generator=gen).to(dtype)
    parts = [(gate[:, :K].contiguous(), up[:, :K].contiguous()),
             (gate[:, K:].contiguous(), up[:, K:].contiguous())]
    n_amax, n_given = FQ.silu_mul_amax.launches, FQ.silu_mul_quant_amax.launches
    amax = [FQ.silu_mul_amax(g, u) for g, u in parts]
    assert FQ.silu_mul_amax.launches == n_amax + 2
    for a, (g, u) in zip(amax, parts):
        assert torch.equal(a, FQ._silu_mul_amax_plain(g, u))
        assert torch.equal(a, FQ.silu_mul_amax(g, u))
    row_max = torch.maximum(*amax)
    got = [FQ.silu_mul_quant(g, u, 8, amax=row_max) for g, u in parts]
    assert FQ.silu_mul_quant_amax.launches == n_given + 2
    for q, (g, u) in zip(got, parts):
        assert _same_bits(q, FQ.silu_mul_quant(g, u, 8, amax=row_max),
                          FQ._silu_mul_quant_plain(g, u, 8, row_max))
    whole = FQ.silu_mul_quant(gate, up, 8)
    assert torch.equal(torch.cat([got[0][0], got[1][0]], dim=1), whole[0])
    assert torch.equal(got[0][1], whole[1]) and torch.equal(got[1][1], whole[1])
    torch.cuda.synchronize()


@pytest.mark.parametrize("case", ["rows too wide for the registers", "width not a multiple of 8",
                                  "misaligned tensors", "the widest row"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_fused_quant_staged_kernels(gen, case, dtype):
    """The staged kernels (one row a block in shared memory, an element a
    thread at a time): rows the register kernels do not hold, a width that
    is not a multiple of 8, tensors that are not 16-byte aligned, and the
    widest row (56K values). Held as above."""
    K = {"rows too wide for the registers": 40960, "width not a multiple of 8": 1004,
         "misaligned tensors": 2048, "the widest row": FQ._MAX_ROW}[case]
    M = 5

    def rows(scale):
        x = _quant_input(gen, M, K, dtype, scale)
        if case != "misaligned tensors":
            return x
        buf = torch.empty(M * K + 1, dtype=dtype, device="cuda")
        buf[1:] = x.reshape(-1)
        return buf[1:].view(M, K)         # contiguous, 2 or 4 bytes past 16-byte alignment

    h, gate, up = rows(1.5), rows(2.0), rows(1.0)
    g = (1 + 0.1 * torch.randn(K, device="cuda", generator=gen)).to(dtype)
    itemsize = h.element_size()
    assert FQ.plan(K, itemsize, 2, FQ._aligned(gate, up))[0] == -1
    assert FQ.plan(K, itemsize, 1, FQ._aligned(h, g), f32_products=True)[0] == -1
    got = FQ.rmsnorm_quant(h, g, 1e-5, 8)
    assert _same_bits(got, FQ.rmsnorm_quant(h, g, 1e-5, 8), FQ._rmsnorm_quant_plain(h, g, 1e-5, 8))
    got = FQ.silu_mul_quant(gate, up, 8)
    assert _same_bits(got, FQ.silu_mul_quant(gate, up, 8), FQ._silu_mul_quant_plain(gate, up, 8))
    amax = FQ.silu_mul_amax(gate, up)
    assert torch.equal(amax, FQ._silu_mul_amax_plain(gate, up))
    given = FQ.silu_mul_quant(gate, up, 8, amax=2 * amax)
    assert _same_bits(given, FQ.silu_mul_quant(gate, up, 8, amax=2 * amax),
                      FQ._silu_mul_quant_plain(gate, up, 8, 2 * amax))
    torch.cuda.synchronize()


def test_fused_quant_rejects_rows_over_the_staged_limit(gen):
    h = torch.zeros(8, FQ._MAX_ROW + 128, device="cuda")
    with pytest.raises(NotImplementedError, match="rows of at most"):
        FQ.rmsnorm_quant(h, torch.ones(h.shape[1], device="cuda"), 1e-5, 8)
    with pytest.raises(NotImplementedError, match="rows of at most"):
        FQ.silu_mul_quant(h, h, 8)


def test_fused_quant_kernel_attributes(gen):
    """Every register and staged kernel of fused_quant.cu compiles without a
    spill; the register kernels hold 1024 threads a block."""
    attrs = FQ.kernel_attributes()
    # RMSNorm's V = 1, 2 (, 4, 8) and staged; each SiLU*up entry's (one-pass,
    # row max, given max) V = 1, 2 (, 4) and staged
    assert len(attrs) == (4 + 2 + 2 + 3) + 3 * (3 + 2 + 2)
    for name, a in attrs.items():
        assert a["spill_bytes"] == 0 and a["blocks_per_sm"] >= 1, (name, a)
        assert a["registers"] <= 64, (name, a)


def test_fused_quant_plan_limits_are_the_kernels(gen):
    """``ops/fused_quant.py`` mirrors csrc/fused_quant.cu's limits by hand;
    they must be the ones the source was built with."""
    from llm_qat_torch.ops import _build

    limits = _build.query("fused_quant", "fused_quant_limits", 4)
    assert limits == [FQ._IN_WORDS, FQ._MAX_ROW, FQ._MAX_GROUPS, 32 * FQ._MAX_WARPS]


@pytest.mark.parametrize("remat_policy,k4", [("save_attn", 2), ("none", 3)])
def test_train_step_launch_counts(gen, remat_policy, k4, monkeypatch):
    """One KD-QAT step on a 2-layer cut at TinyLlama-1.1B width: the forward
    kernel runs once a layer for the teacher and once for the student (the
    rematerialized layer reads its saved attention output), twice for the
    student when nothing is saved; dQ and dK/dV once a layer."""
    from llm_qat_torch.models import llama
    from llm_qat_torch.training import trainer as T

    L = 2
    cfg = TINYLLAMA_1B.replace(num_hidden_layers=L, w_bits=4, a_bits=8, kv_bits=4)
    student = P.init_params(cfg, seed=0, dtype=torch.bfloat16)
    teacher = P.init_params(cfg, seed=1, dtype=torch.bfloat16)
    if remat_policy == "none":
        real = llama.backbone
        monkeypatch.setattr(llama, "backbone",
                            lambda *a, **k: real(*a, **dict(k, remat_policy="none")))
    tr = T.Trainer(cfg, T.TrainConfig(kl_chunk=64), student, teacher)
    ids = torch.randint(0, cfg.vocab_size, (2, 128), device="cuda", generator=gen)
    fns = (FA._flash_fwd, FA._flash_bwd_dq, FA._flash_bwd_dkv, FQ.rmsnorm_quant,
           FQ.silu_mul_quant)
    before = [f.launches for f in fns]
    m = tr.train_step({"input_ids": ids, "labels": ids})
    torch.cuda.synchronize()
    got = [f.launches - b for f, b in zip(fns, before)]
    assert got == [k4 * L, L, L, 4 * L, 0]
    assert torch.isfinite(m["loss"]) and torch.isfinite(m["grad_norm"])


MHA_SMALL = LLAMA_7B.replace(num_hidden_layers=2, hidden_size=256, intermediate_size=512,
                             num_attention_heads=2, num_key_value_heads=2, vocab_size=256,
                             w_bits=8, a_bits=8, kv_bits=8)


def test_engine_serves_mha_head_dim_128_on_the_scan_path(gen):
    """One query head per kv head at head dim 128 with ``use_megakernel=False``:
    ``InferenceEngine`` on the card decodes on the scan path (K3 at (1, 128))
    and never launches the megakernel; its greedy tokens equal those of the
    CPU engine on the scan path (the plain versions) on the same weights."""
    cfg = MHA_SMALL.replace(use_megakernel=False)
    params = P.init_params(cfg, seed=0, device="cpu", dtype=torch.bfloat16)
    prompts = [[3, 5, 7, 11, 13], list(range(1, 40))]
    tokens = {}
    for dev in ("cuda", "cpu"):
        eng = E.InferenceEngine(Q.quantize_params(params, cfg, device=dev), cfg, max_batch=2,
                                max_len=128, device=dev)
        for p in prompts:
            eng.submit(p, max_new_tokens=8)
        n3, n9 = DA.quantized_decode_attention.launches, MK.decode_layers.launches
        tokens[dev] = {r.uid: r.output for r in eng.run()}
        if dev == "cuda":
            assert DA.quantized_decode_attention.launches > n3
            assert MK.decode_layers.launches == n9
    assert tokens["cuda"] == tokens["cpu"] and all(len(t) == 8 for t in tokens["cpu"].values())


def test_engine_serves_mha_head_dim_128_through_the_megakernel(gen, monkeypatch):
    """The default configuration (``use_megakernel=True``) with (1, 128)
    heads: ``InferenceEngine`` on the card decodes every step in one launch
    of the megakernel and never launches K3 while decoding. Against the scan
    path (which takes SiLU in the model type: the paths differ by design) one
    decode step's logits stay within 0.15 relative L2, the 2-layer limit of
    ``chip_smoke.py``."""
    cfg = MHA_SMALL
    assert cfg.use_megakernel and MK.card_takes(cfg, 2, 128, torch.bfloat16)
    qp = Q.quantize_params(P.init_params(cfg, seed=0, device="cpu", dtype=torch.bfloat16),
                           cfg, device="cuda")
    eng = E.InferenceEngine(qp, cfg, max_batch=2, max_len=128)
    steps = {"n": 0}
    real = eng._fwd

    def counted(*a, **k):
        steps["n"] += 1
        return real(*a, **k)

    monkeypatch.setattr(eng, "_fwd", counted)
    for p in ([3, 5, 7, 11, 13], list(range(1, 40))):
        eng.submit(p, max_new_tokens=8)
    n3, n9 = DA.quantized_decode_attention.launches, MK.decode_layers.launches
    out = eng.run()
    assert MK.decode_layers.launches - n9 == steps["n"] >= 7
    assert DA.quantized_decode_attention.launches == n3
    assert all(len(r.output) == 8 and all(0 <= t < cfg.vocab_size for t in r.output) for r in out)
    # one step of both paths from the same cache
    cache = M.init_serving_cache(cfg, 2, 128)
    ids = torch.tensor([[3, 5, 7, 11, 13, 17, 19, 23]] * 2, device="cuda")
    _, cache = M.serving_forward(qp, cfg.replace(use_megakernel=False), ids, [0, 0],
                                 [True, True], cache)
    lg = []
    for flag in (True, False):
        c = {k: v.clone() for k, v in cache.items()}
        lg.append(M.serving_forward(qp, cfg.replace(use_megakernel=flag), [[29], [31]],
                                    c["lengths"], [True, True], c)[0])
    assert float((lg[0] - lg[1]).norm() / lg[1].norm()) <= 0.15


# ---------------------------------------------------------------- head dims of the padded builds

PAD_DIMS = (48, 80, 96, 100)


@pytest.mark.parametrize("hd", PAD_DIMS)
@pytest.mark.parametrize("G", [1, 3, 8, 12, 16])
@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("fold", [True, False])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_decode_attention_kernel_padded_head_dims(gen, hd, G, packed, fold, dtype):
    """K3's padded build (hd from the launch, buffers sized for 128) at S =
    2048 and the JAX picker's block: lengths 0, 1, 127-129, bk - 1..bk + 1
    and S, slot 2 inactive, RoPE from the tables; bit-equal to its plain
    version and the same bits twice."""
    kvh, S = 4, 2048
    bk = DA._pick_bk(S, kvh, hd, 1024)
    lens_l = [0, 1, 127, 128, 129, bk - 1, bk, bk + 1, S]
    b = len(lens_l)
    kq, ks, vq, vs = _cache(gen, b, kvh, hd, S, packed)
    q = torch.randn(b, kvh * G, hd, device="cuda", generator=gen).to(dtype)
    lens = torch.tensor(lens_l, dtype=torch.int32, device="cuda")
    kc, ksn = DA._rope_tables(S, hd, 10000.0, "cuda")
    fd = None
    if fold:
        fd = _quant_fold(gen, b, kvh, hd, packed, [int(i != 2) for i in range(b)], kc, ksn,
                         torch.clamp(lens.long(), max=S - 1))
    args = (q, kq, ks, vq, vs, lens, kc, ksn, fd)
    n = DA.quantized_decode_attention.launches
    got = DA.quantized_decode_attention(*args, packed=packed)
    again = DA.quantized_decode_attention(*args, packed=packed)
    assert DA.quantized_decode_attention.launches == n + 2
    want = DA._decode_attention_plain(*args, packed=packed)
    torch.cuda.synchronize()
    assert torch.equal(got, again) and torch.equal(got, want)


PAGED_KVH.update({(g, hd): 4 for hd in PAD_DIMS for g in (1, 8, 12)})


@pytest.mark.parametrize("hd", PAD_DIMS)
@pytest.mark.parametrize("G", [1, 8, 12])
@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_paged_attention_kernel_padded_head_dims(gen, hd, G, packed, dtype):
    """K8's padded build over 32 slots of ``_paged_case`` (fold on, RoPE):
    bit-equal to its plain version and the same bits twice."""
    q, pool, lens, bt, kc, ksn, fd = _paged_case(32, G, hd, packed, dtype, gen)
    args = (q, *pool, lens, bt, kc, ksn, fd)
    got = DA.quantized_paged_attention(*args, packed=packed)
    assert torch.equal(got, DA.quantized_paged_attention(*args, packed=packed))
    want = DA._paged_attention_plain(*args, packed=packed)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("hd", PAD_DIMS)
@pytest.mark.parametrize("G", [1, 4])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_stacked_decode_attention_kernel_padded_head_dims(gen, hd, G, dtype):
    """K7's padded build on layer 2 of a 3-layer stacked cache: bit-equal to
    its plain version."""
    L, b, S, kvh = 3, 8, 512, 4
    kq = torch.randint(-127, 128, (L, b, kvh, hd, S), device="cuda", generator=gen).to(torch.int8)
    vq = torch.randint(-127, 128, (L, b, kvh, hd, S), device="cuda", generator=gen).to(torch.int8)
    ks = torch.rand(L, b, S, device="cuda", generator=gen) * 0.02 + 0.005
    vs = torch.rand(L, b, S, device="cuda", generator=gen) * 0.02 + 0.005
    q = torch.randn(b, kvh * G, hd, device="cuda", generator=gen).to(dtype)
    lens = torch.tensor([0, 0, 17, 255, 256, 257, 400, 511], dtype=torch.int32, device="cuda")
    inc = torch.tensor([1, 0, 1, 1, 0, 1, 1, 1], dtype=torch.int32, device="cuda")
    kn = (torch.randn(b, kvh, hd, device="cuda", generator=gen) * 0.5).to(dtype)
    vn = (torch.randn(b, kvh, hd, device="cuda", generator=gen) * 0.5).to(dtype)
    kc, ksn = DA._rope_tables(S, hd, 10000.0, "cuda")
    args = (q, kq, ks, vq, vs, lens, inc, kn, vn, kc, ksn)
    got = DA.quantized_decode_attention_stacked(*args, layer=2)
    want = DA._decode_attention_stacked_plain(*args, layer=2)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("hd", PAD_DIMS)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("S", [100, 1100])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_fwd_kernel_padded_head_dims(gen, hd, dtype, S, causal):
    """K4's padded build (rows of hd values in 8-byte pieces, tiles 128 wide
    with zeros past hd) against its plain version within its gate, lengths
    S, 1, one cut mid-tile and one a few short; the same bits twice."""
    B, G = 4, 2
    q = torch.randn(B, G, S, hd, device="cuda", generator=gen).to(dtype)
    k, v = (torch.randn(B, S, hd, device="cuda", generator=gen).to(dtype) for _ in range(2))
    lens = torch.tensor([S, 1, S // 2 + 3, S - 5], dtype=torch.int32, device="cuda")
    n = FA._flash_fwd.launches
    o, lse = FA._flash_fwd(q, k, v, lens, causal=causal)
    o_again, _ = FA._flash_fwd(q, k, v, lens, causal=causal)
    assert FA._flash_fwd.launches == n + 2
    o2, lse2 = FA._flash_fwd_plain(q, k, v, lens, causal)
    torch.cuda.synchronize()
    assert o.shape == (B, G, S, hd) and _close(o, o2) and torch.equal(o, o_again)
    assert float((lse - lse2).abs().max()) < (1e-3 if dtype == torch.bfloat16 else 1e-5)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("S", [100, 1100, 2048])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("G", [1, 3])
@pytest.mark.parametrize("soft_bf16", [False, True])
def test_flash_fwd_kernel_head_dim_256(gen, dtype, S, causal, G, soft_bf16):
    """K4's D = 256 entry (bf16: 32-key tiles, Q's fragments read where used;
    f32: the SIMT kernel) against its plain version within its gate,
    lengths S, 1, one cut mid-tile and one a few short; the same bits
    twice; K10/K11 refuse the head dim."""
    B, D = 4, 256
    q = torch.randn(B, G, S, D, device="cuda", generator=gen).to(dtype)
    k, v = (torch.randn(B, S, D, device="cuda", generator=gen).to(dtype) for _ in range(2))
    lens = torch.tensor([S, 1, S // 2 + 3, S - 5], dtype=torch.int32, device="cuda")
    n = FA._flash_fwd.launches
    o, lse = FA._flash_fwd(q, k, v, lens, causal=causal, soft_bf16=soft_bf16)
    o_again, _ = FA._flash_fwd(q, k, v, lens, causal=causal, soft_bf16=soft_bf16)
    assert FA._flash_fwd.launches == n + 2
    o2, lse2 = FA._flash_fwd_plain(q, k, v, lens, causal, soft_bf16)
    torch.cuda.synchronize()
    assert o.shape == (B, G, S, D) and _close(o, o2) and torch.equal(o, o_again)
    assert float((lse - lse2).abs().max()) < (1e-3 if dtype == torch.bfloat16 else 1e-5)


@pytest.mark.parametrize("hd", PAD_DIMS)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("S", [100, 1100])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("G", [1, 2])
def test_flash_bwd_kernels_padded_head_dims(gen, hd, dtype, S, causal, G):
    """K10 and K11's padded builds (flash_bwd_dq_dpad, flash_bwd_dkv_dpad:
    rows of hd values, tiles 128 wide with zeros past hd) against their plain
    versions within their gate, from the forward kernel's O and log-sum-exp;
    lengths S, 1, one cut mid-tile and one a few short. Exact zeros past each
    length in dK and dV, the same bits from a second launch of each kernel,
    and the backward of ``flash_attention_gqa`` through both."""
    B = 4
    q, do = (torch.randn(B, G, S, hd, device="cuda", generator=gen).to(dtype) for _ in range(2))
    k, v = (torch.randn(B, S, hd, device="cuda", generator=gen).to(dtype) for _ in range(2))
    lens_l = [S, 1, S // 2 + 3, S - 5]
    lens = torch.tensor(lens_l, dtype=torch.int32, device="cuda")
    o, lse = FA._flash_fwd(q, k, v, lens, causal=causal)
    args = (q, k, v, lens, lse, FA._delta(o, do), do, causal)
    n = (FA._flash_bwd_dq.launches, FA._flash_bwd_dkv.launches)
    dq, (dk, dv) = FA._flash_bwd_dq(*args), FA._flash_bwd_dkv(*args)
    assert (FA._flash_bwd_dq.launches, FA._flash_bwd_dkv.launches) == (n[0] + 1, n[1] + 1)
    dq_again, (dk_again, dv_again) = FA._flash_bwd_dq(*args), FA._flash_bwd_dkv(*args)
    dq2, (dk2, dv2) = FA._flash_bwd_dq_plain(*args), FA._flash_bwd_dkv_plain(*args)
    torch.cuda.synchronize()
    assert dq.shape == (B, G, S, hd) and dk.shape == dv.shape == (B, S, hd)
    assert _close(dq, dq2) and _close(dk, dk2) and _close(dv, dv2)
    assert torch.equal(dq, dq_again) and torch.equal(dk, dk_again) and torch.equal(dv, dv_again)
    for b, n_live in enumerate(lens_l):
        assert not dk[b, max(n_live, 1):].any() and not dv[b, max(n_live, 1):].any()
    if causal:
        ql, kl, vl = (t.detach().requires_grad_(True) for t in (q, k, v))
        out = FA.flash_attention_gqa(ql, kl, vl, lens)
        grads = torch.autograd.grad(out, (ql, kl, vl), do)
        assert all(torch.equal(a, b) for a, b in zip(grads, (dq, dk, dv)))


# (kv heads, G, intermediate) of each head dim's 2-layer K9 case: widths on
# the products' 128-column tiles; I = 2112 at 80 and OpenLLaMA-3B's 32 MHA
# heads and I = 8640 at 100 (K off the 256 grid: the zero-padded last chunk);
# "96 wide": 12 query heads over 8 kv heads of 96 (the padded build of
# G = 9..16; at 100 the q/k/v width is on the 128-column tiles only from 16
# kv heads)
PAD_K9 = {48: (8, 1, 2048), 80: (8, 2, 2112), 96: (8, 4, 2048), 100: (32, 1, 8640),
          "96 wide": (8, 12, 2048)}


@pytest.mark.parametrize("hd", [*PAD_DIMS, "96 wide"])
@pytest.mark.parametrize("mode", list(K9_MODES))
@pytest.mark.parametrize("rope_mode", ["pre", "post"])
def test_decode_megakernel_padded_head_dims_against_plain(gen, hd, mode, rope_mode):
    """K9's padded build on a 2-layer cut, b = 8, max_len 2048 at the JAX
    picker's block, lengths as the TinyLlama case: bit-equal logits."""
    kvh, G, inter = PAD_K9[hd]
    hd = 96 if hd == "96 wide" else hd
    cfg = LLAMA_7B.replace(num_hidden_layers=2, hidden_size=kvh * G * hd,
                           intermediate_size=inter, num_attention_heads=kvh * G,
                           num_key_value_heads=kvh, kv_cache_rope=rope_mode, **K9_MODES[mode])
    assert cfg.head_dim == hd and MK.card_takes(cfg, 8, 2048, torch.bfloat16)
    lens = [48, 0, 282, 511, 512, 513, 1024, 1400]
    active = [True, True, False, True, True, True, True, True]
    lg = _megakernel_against_plain(cfg, lens, active, torch.bfloat16, gen, 2048, exact=True)
    assert lg.shape == (8, 1, cfg.vocab_size)


def test_measure_times_a_cuda_graph_of_the_kernel(gen):
    """``utils.benchmarking.measure`` on the card: N launches of K1 captured
    in one CUDA graph, the replay timed between events, the floor (the same
    harness around a one-element op) subtracted; the graph's launches give
    the kernel's bits."""
    from llm_qat_torch.utils import benchmarking as B

    xq, sx, wq, sw, _, _ = _gemm_operands(gen, 32, 2048, 2560)
    want = QM.int8_matmul(xq, wq, sx, sw)
    outs = []
    per = B.measure(lambda *a: outs.append(QM.int8_matmul(*a)), [xq, wq, sx, sw],
                    iters=20, reps=2)
    torch.cuda.synchronize()
    assert 0.0 <= per < 1e-3
    assert all(torch.equal(o, want) for o in outs)
    floor = B.dispatch_floor(iters=20, reps=2)
    assert 0.0 < floor < 1e-2
    assert B.measure(lambda *a: QM.int8_matmul(*a), [xq, wq, sx, sw], iters=20, reps=2,
                     floor=1e9) == 0.0                 # clamped at 0
