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
median; the paged decode attention and the stacked decode attention follow
their plain versions the same way (the paged pair both against the running
maximum, page by page) and are held alike; the stacked GEMMs are bit-exact
against their plain versions and against the unstacked kernels. The
whole-model decode kernel takes every rounded sum in float64, as
its plain version does, so the two are expected to agree bit for bit; held
here to: committed K/V integers and lengths equal, inverse scales at rtol
1e-6, logits element-wise as above. The flash backward kernels recompute p
from the saved log-sum-exp and round ds and p where their plain versions do:
held as the forward is. The RMSNorm+quant and SiLU*up+quant kernels give the
plain versions' scales to rtol 1e-6; an integer may differ by 1 where x*s
sits on a rounding boundary (the kernels' fp32 sum of squares runs in another
order): at most 1 apart everywhere and equal in all but 1% of the elements.
"""

import pytest
import torch

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
    kvh, P = (4, 128) if G == 8 else (8, 128)
    base = [0, 1, 2 * P, 2 * P + 37, max_pages * P, 5, 3 * P - 1, P]
    lens_l = [base[i % len(base)] for i in range(b)]
    n_pages = sum(-(-n // P) for n in lens_l) + 3
    pool = _random_pool(n_pages, kvh, hd, packed, gen)
    ids = torch.randperm(n_pages, device="cuda", generator=gen).tolist()
    bt = torch.full((b, max_pages), 10 ** 6, dtype=torch.int32)
    at = 0
    for i, n in enumerate(lens_l):
        live = -(-n // P)
        bt[i, :live] = torch.tensor(ids[at:at + live], dtype=torch.int32)
        at += live
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


@pytest.mark.parametrize("G,hd", [(8, 64), (1, 128)])
@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("fold", [True, False])
@pytest.mark.parametrize("rope", [True, False])
@pytest.mark.parametrize("b", [1, 32])
def test_paged_attention_kernel(gen, G, hd, packed, dtype, fold, rope, b):
    if b == 1:
        # one slot: mid-page in its third page
        q, pool, lens, bt, kc, ksn, fd = _paged_case(4, G, hd, packed, dtype, gen, fold)
        q, lens, bt = q[3:4], lens[3:4], bt[3:4]
        fd = None if fd is None else tuple(a[3:4] for a in fd)
    else:
        q, pool, lens, bt, kc, ksn, fd = _paged_case(b, G, hd, packed, dtype, gen, fold)
    args = (q, *pool, lens, bt, kc if rope else None, ksn if rope else None, fd)
    n = DA.quantized_paged_attention.launches
    got = DA.quantized_paged_attention(*args, rope=rope, packed=packed)
    assert DA.quantized_paged_attention.launches == n + 1
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
    with pytest.raises(NotImplementedError, match=r"\(8, 64\), \(1, 128\)"):
        DA.quantized_paged_attention(q[:, :16], *pool, lens, bt)        # G = 4
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
def test_stacked_decode_attention_kernel(gen, layer, rope, dtype):
    L, b, kvh, G, hd, S = 3, 8, 4, 8, 64, 512
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
    want = DA._decode_attention_stacked_plain(*args, layer=layer, rope=rope)
    torch.cuda.synchronize()
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


def _random_cache(cfg, b, S, gen):
    packed = M.cache_is_packed(cfg)
    shape = (cfg.num_hidden_layers, b, cfg.kv_heads,
             cfg.head_dim // 2 if packed else cfg.head_dim, S)
    lo, hi, qdt = (0, 256, torch.uint8) if packed else (-127, 128, torch.int8)
    ints = lambda: torch.randint(lo, hi, shape, device="cuda", generator=gen).to(qdt)  # noqa: E731
    scales = lambda: torch.rand(shape[0], b, S, device="cuda", generator=gen) * 0.02 + 0.005  # noqa: E731
    return {"k_q": ints(), "k_s": scales(), "v_q": ints(), "v_s": scales()}


def _megakernel_against_plain(cfg, lens, active, dtype, gen, S):
    """One decode step through the kernel and through its plain version
    from the same random cache and weights."""
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
    assert _close(lg1, lg2)
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


def test_decode_megakernel_refuses_shapes_it_is_not_built_for(gen):
    cfg = LLAMA_7B.replace(num_hidden_layers=1, vocab_size=256, w_bits=8, a_bits=8, kv_bits=8)
    qp = Q.quantize_params(P.init_params(cfg, seed=0, dtype=torch.bfloat16), cfg)
    cache = M.init_serving_cache(cfg, 1, 256)
    with pytest.raises(NotImplementedError, match="1 query heads per kv head at head dim 128"):
        MK.decode_step(qp, cfg, [[3]], [0], [True], cache)


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
    with pytest.raises(NotImplementedError, match="head dim 64"):
        FA._flash_bwd(q[..., :32].detach(), k[..., :32].detach(), v[..., :32].detach(), lens,
                      o[..., :32].detach(), saved.lse, g[..., :32])


def _ints_agree(got, want):
    d = (got.int() - want.int()).abs()
    return int(d.max()) <= 1 and float((d != 0).float().mean()) <= 0.01


@pytest.mark.parametrize("M,K", [(64, 2048), (8, 128), (40, 5632)])
@pytest.mark.parametrize("h_dtype,g_dtype", [(torch.bfloat16, torch.bfloat16),
                                             (torch.bfloat16, torch.float32),
                                             (torch.float32, torch.float32)])
@pytest.mark.parametrize("a_bits", [8, 4])
def test_rmsnorm_quant_kernel(gen, M, K, h_dtype, g_dtype, a_bits):
    h = (torch.randn(M, K, device="cuda", generator=gen) * 1.5).to(h_dtype)
    g = (1 + 0.1 * torch.randn(K, device="cuda", generator=gen)).to(g_dtype)
    n = FQ.rmsnorm_quant.launches
    xq, sx = FQ.rmsnorm_quant(h, g, 1e-6, a_bits)
    assert FQ.rmsnorm_quant.launches == n + 1
    xq2, sx2 = FQ._rmsnorm_quant_plain(h, g, 1e-6, a_bits)
    torch.cuda.synchronize()
    assert xq.dtype == torch.int8 and sx.shape == (M, 1)
    assert torch.allclose(sx, sx2, rtol=1e-6, atol=0)
    assert _ints_agree(xq, xq2)


@pytest.mark.parametrize("M,K", [(64, 5632), (8, 128), (24, 17920)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_silu_mul_quant_kernel(gen, M, K, dtype):
    gate = (torch.randn(M, K, device="cuda", generator=gen) * 2).to(dtype)
    up = torch.randn(M, K, device="cuda", generator=gen).to(dtype)
    n = FQ.silu_mul_quant.launches
    yq, sy = FQ.silu_mul_quant(gate, up, 8)
    assert FQ.silu_mul_quant.launches == n + 1
    yq2, sy2 = FQ._silu_mul_quant_plain(gate, up, 8)
    torch.cuda.synchronize()
    assert torch.allclose(sy, sy2, rtol=1e-6, atol=0)
    assert _ints_agree(yq, yq2)
    if dtype == torch.bfloat16:
        # nothing is summed here: the kernel's roundings are the plain version's
        assert torch.equal(yq, yq2) and torch.equal(sy, sy2)


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
