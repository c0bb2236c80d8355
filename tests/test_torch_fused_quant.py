"""Port parity: llm_qat_torch.ops.fused_quant (plain versions, CPU) against the
JAX package's Pallas kernels rmsnorm_quant / silu_mul_quant in interpret mode.

Inputs come from a numpy seed. Scales are held at rtol 1e-6: the absmax is an
exact maximum of values that agree to the last bits, and the scale one IEEE
division. Integers are equal, or 1 apart where x*s sits on a rounding boundary
(XLA's and torch's fp32 mean / rsqrt / sigmoid differ in the last bit, the
class the JAX kernels' docstring names): every case states the share it
allows, 0.5% of the elements, and none may differ by more than 1.

Both take the mean of the fp32 squares as ``sum * (1/K)``. At H = 5120 and
6656 (LLaMA-13B's and LLaMA-30B's widths) ``1/K`` is inexact in fp32: the
cases there hold the same allowance.

bf16: XLA's CPU compiler by default keeps excess precision (it carries a
chain of bf16 elementwise ops in f32 and drops the roundings in between), so
the JAX kernel in interpret mode would not round where its source says. The
bf16 cases compile the JAX function with ``xla_allow_excess_precision`` off:
then every ``astype`` and every bf16 product rounds as written, which is what
the port implements.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_qat_tpu.ops.pallas import fused_quant as JFQ
from llm_qat_torch.ops import fused_quant as TFQ

MAX_FLIPPED = 0.005

JDT = {"f32": jnp.float32, "bf16": jnp.bfloat16}
TDT = {"f32": torch.float32, "bf16": torch.bfloat16}


def _t(a, dt):
    return torch.from_numpy(a).to(TDT[dt])


def _strict(fn, *args):
    """``fn(*args)`` jitted with XLA's excess precision off."""
    return jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": False})(*args)


def _check(tq, ts, jq, js):
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    assert tuple(ts.shape) == (tq.shape[0], 1)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-6, atol=0)
    d = np.abs(tq.numpy().astype(np.int32) - np.asarray(jq).astype(np.int32))
    assert d.max() <= 1
    assert (d != 0).mean() <= MAX_FLIPPED, (d != 0).mean()


@pytest.mark.parametrize("M,K", [(8, 128), (24, 256), (16, 384)])
@pytest.mark.parametrize("h_dt,g_dt", [("f32", "f32"), ("bf16", "bf16"), ("bf16", "f32")])
@pytest.mark.parametrize("a_bits", [8, 4])
def test_rmsnorm_quant_matches_jax(M, K, h_dt, g_dt, a_bits):
    rng = np.random.default_rng(M + K)
    h = (rng.normal(size=(M, K)) * 1.5).astype(np.float32)
    g = (1.0 + 0.1 * rng.normal(size=(K,))).astype(np.float32)
    jq, js = _strict(lambda a, b: JFQ.rmsnorm_quant(a, b, 1e-6, a_bits),
                     jnp.asarray(h, JDT[h_dt]), jnp.asarray(g, JDT[g_dt]))
    tq, ts = TFQ.rmsnorm_quant(_t(h, h_dt), _t(g, g_dt), 1e-6, a_bits)
    _check(tq, ts, jq, js)


@pytest.mark.parametrize("M,K", [(8, 5120), (8, 6656)])
@pytest.mark.parametrize("h_dt,g_dt", [("f32", "f32"), ("bf16", "bf16"), ("bf16", "f32")])
@pytest.mark.parametrize("a_bits", [8, 4])
def test_rmsnorm_quant_matches_jax_where_one_over_k_is_inexact(M, K, h_dt, g_dt, a_bits):
    rng = np.random.default_rng(K + a_bits)
    h = (rng.normal(size=(M, K)) * 1.5).astype(np.float32)
    h[1, K // 3] = 40.0                 # one outlier sets the row's scale
    g = (1.0 + 0.1 * rng.normal(size=(K,))).astype(np.float32)
    jq, js = _strict(lambda a, b: JFQ.rmsnorm_quant(a, b, 1e-5, a_bits),
                     jnp.asarray(h, JDT[h_dt]), jnp.asarray(g, JDT[g_dt]))
    tq, ts = TFQ.rmsnorm_quant(_t(h, h_dt), _t(g, g_dt), 1e-5, a_bits)
    _check(tq, ts, jq, js)


@pytest.mark.parametrize("M,K", [(8, 128), (24, 256)])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("a_bits", [8, 4])
def test_silu_mul_quant_matches_jax(M, K, dt, a_bits):
    rng = np.random.default_rng(M * K)
    gate = (rng.normal(size=(M, K)) * 2).astype(np.float32)
    up = rng.normal(size=(M, K)).astype(np.float32)
    jq, js = _strict(lambda a, b: JFQ.silu_mul_quant(a, b, a_bits),
                     jnp.asarray(gate, JDT[dt]), jnp.asarray(up, JDT[dt]))
    tq, ts = TFQ.silu_mul_quant(_t(gate, dt), _t(up, dt), a_bits)
    _check(tq, ts, jq, js)


@pytest.mark.parametrize("shape", [(8, 128), (16, 2048), (8, 64), (7, 128), (8, 192), (2, 8, 128)])
def test_supported_matches_jax(shape):
    assert TFQ.supported(torch.zeros(shape)) == JFQ.supported(jnp.zeros(shape))


# the widths of the -m cuda cases and of the models' hidden and MLP rows
PLAN_WIDTHS = [128, 2048, 4096, 5120, 5632, 6656, 11008, 13824, 17920, 22016, 28672, 32768,
               40960, 57344]


# (itemsize, inputs, RMSNorm's products kept as fp32): bf16 RMSNorm with a bf16
# and with an f32 gain, f32 RMSNorm, SiLU*up in bf16 and in f32
PLAN_KINDS = [(2, 1, False), (2, 1, True), (4, 1, True), (2, 2, False), (4, 2, False)]


@pytest.mark.parametrize("K", PLAN_WIDTHS)
@pytest.mark.parametrize("itemsize,n_inputs,f32_products", PLAN_KINDS)
def test_plan_covers_the_row_within_the_registers(K, itemsize, n_inputs, f32_products):
    """A register plan gives every chunk of 8 elements to one thread, holds at
    most 32 words a thread (16, or two chunks, where that holds the row in
    32 warps), covers the row with a power of two chunks a thread, half of
    which would not cover it, and fits a block of at most 8 row groups and
    1024 threads; RMSNorm's ring of two stages fits ``_STAGE_SMEM`` bytes,
    SiLU*up loads straight into registers. Other rows take the staged
    kernel."""
    v, wpr, rows = TFQ.plan(K, itemsize, n_inputs, f32_products=f32_products)
    chunks, cw = K // 8, 2 * itemsize * n_inputs   # input words of a chunk
    rw = cw + 8 * f32_products                     # words a thread holds for it
    if v == -1:
        assert (wpr, rows) == (32, 1)
        assert chunks > 32 * 32 * (32 // rw) or 2 * 4 * cw * chunks > TFQ._STAGE_SMEM * 0.9
        return
    assert v in (1, 2, 4, 8) and v * rw <= 32
    if chunks <= 32 * 32 * max(1, 16 // rw) and 2 * rw <= 32:
        assert v * rw <= max(16, 2 * rw)
    assert v * wpr * 32 >= chunks > v // 2 * wpr * 32
    assert 1 <= rows <= 8 and rows * wpr * 32 <= 1024
    if n_inputs == 1:
        assert 2 * 4 * cw * v * 32 * wpr * rows <= TFQ._STAGE_SMEM


@pytest.mark.parametrize("itemsize,n_inputs,f32_products,widest",
                         [(2, 1, False, 55296), (2, 1, True, 16384), (4, 1, True, 16384),
                          (2, 2, False, 32768), (4, 2, False, 16384)])
def test_plan_stages_only_what_the_registers_cannot_hold(itemsize, n_inputs, f32_products,
                                                         widest):
    """Every width that is a multiple of 128 up to the widest row the register
    kernels hold (1024 threads at 32 words; for bf16 RMSNorm with a bf16
    gain, the widest whose ring fits) runs in registers, LLaMA-65B's 22016
    among them where it fits; past it, the staged kernel."""
    kind = dict(f32_products=f32_products)
    assert all(TFQ.plan(k, itemsize, n_inputs, **kind)[0] > 0 for k in range(128, widest + 1, 128))
    assert TFQ.plan(widest + 128, itemsize, n_inputs, **kind) == (-1, 32, 1)


@pytest.mark.parametrize("K,aligned", [(100, True), (1004, True), (2048, False), (57344, False)])
def test_plan_takes_single_elements_for_misaligned_rows(K, aligned):
    v, wpr, rows = TFQ.plan(K, 2, 1, aligned)
    assert v == -1 and rows == 1 and 1 <= wpr <= 32 and (wpr * 32 >= K or wpr == 32)


def test_the_int_dot_identity():
    """xq / sx is the fake-quant of the normed activation."""
    rng = np.random.default_rng(3)
    h = torch.from_numpy(rng.normal(size=(8, 128)).astype(np.float32))
    g = torch.ones(128)
    xq, sx = TFQ.rmsnorm_quant(h, g, 1e-6, 8)
    from llm_qat_torch.models.llama import rms_norm
    from llm_qat_torch.ops.quantize import sym_fake_quant
    want = sym_fake_quant(rms_norm(h, g, 1e-6), 8, -1)
    np.testing.assert_allclose((xq.float() / (sx + 1e-6)).numpy(), want.numpy(), atol=2e-2)
    close = np.isclose((xq.float() / (sx + 1e-6)).numpy(), want.numpy(), rtol=1e-5, atol=1e-6)
    assert close.mean() > 0.99


def test_cpu_counts_no_launch_and_other_devices_raise():
    h, g = torch.zeros(8, 128), torch.ones(128)
    n = (TFQ.rmsnorm_quant.launches, TFQ.silu_mul_quant.launches)
    TFQ.rmsnorm_quant(h, g, 1e-6, 8)
    TFQ.silu_mul_quant(h, h, 8)
    assert (TFQ.rmsnorm_quant.launches, TFQ.silu_mul_quant.launches) == n
    with pytest.raises(ValueError):
        TFQ.rmsnorm_quant(h.to("meta"), g.to("meta"), 1e-6, 8)
    with pytest.raises(ValueError):
        TFQ.silu_mul_quant(h.to("meta"), h.to("meta"), 8)
    with pytest.raises(ValueError, match="gain"):
        TFQ.rmsnorm_quant(h, torch.ones(64), 1e-6, 8)


def _kernel_order_loop(x: np.ndarray, v: int, wpr: int) -> np.ndarray:
    """The RMSNorm kernel's documented sum order, one float32 operation at a
    time: each of a row's 32 wpr threads sums its squares in sequence (the
    register kernel: chunk t + i*32wpr of 8 elements, i then the 8; the
    staged kernel, v = -1: elements t, t + 32wpr, ...), each warp's xor
    butterfly folds lanes 16..31 onto 0..15, then 8, 4, 2, 1, and the warps'
    sums add in warp order."""
    m, k = x.shape
    T = 32 * wpr
    out = np.zeros((m, 1), np.float32)
    for r in range(m):
        parts = []
        for t in range(T):
            acc = np.float32(0.0)
            idx = ([8 * (t + i * T) + e for i in range(v) if t + i * T < k // 8 for e in range(8)]
                   if v > 0 else range(t, k, T))
            for j in idx:
                acc = np.float32(acc + np.float32(x[r, j] * x[r, j]))
            parts.append(acc)
        warps = []
        for w in range(wpr):
            lanes = parts[32 * w:32 * w + 32]
            for off in (16, 8, 4, 2, 1):
                lanes = [np.float32(lanes[i] + lanes[i + off]) for i in range(off)]
            warps.append(lanes[0])
        total = warps[0]
        for s in warps[1:]:
            total = np.float32(total + s)
        out[r, 0] = total
    return out


@pytest.mark.parametrize("K,h_dt,g_dt", [(2048, "bf16", "f32"), (2048, "bf16", "bf16"),
                                         (5120, "bf16", "bf16"), (4096, "f32", "f32"),
                                         (1004, "f32", "f32"), (128, "bf16", "bf16")])
def test_rmsnorm_kernel_order_route_is_the_kernels_sum(K, h_dt, g_dt):
    """The plain version's card route, run on the CPU: its sum of squares
    has the bits of a loop in the kernel's documented order, for the plan
    the kernel takes (register rows of 1 to 5 warps, and a width that is
    no multiple of 8, which takes the staged kernel); its integers and
    scales are those of that sum carried through the rest of the plain
    version."""
    rng = np.random.default_rng(K)
    h = _t((rng.normal(size=(3, K)) * 1.5).astype(np.float32), h_dt)
    g = _t((1.0 + 0.1 * rng.normal(size=(K,))).astype(np.float32), g_dt)
    _, _, (v, wpr, _) = TFQ._launch_operands(h, g)
    assert (v == -1) == (K % 8 != 0)
    xf = h.float()
    got = TFQ._sum_sq_kernel_order(xf, v, wpr)
    want = _kernel_order_loop(xf.numpy(), v, wpr)
    assert np.array_equal(got.numpy(), want)
    q, s = TFQ._rmsnorm_quant_plain(h, g, 1e-5, 8, kernel_order=True)
    r = torch.rsqrt(torch.from_numpy(want) * (1.0 / K) + 1e-5)
    xn = (xf * r).to(h.dtype).float()
    wq, ws = TFQ._quant_rows((xn * g.float()).to(torch.promote_types(h.dtype, g.dtype)).float(), 8)
    assert torch.equal(q, wq) and torch.equal(s, ws)


@pytest.mark.parametrize("h_dt,g_dt", [("bf16", "f32"), ("bf16", "bf16"), ("f32", "f32")])
def test_rmsnorm_cpu_route_keeps_jax_mean(h_dt, g_dt):
    """On the CPU the plain version (what ``rmsnorm_quant`` takes there) sums
    the squares as one fp32 ``sum(dim=1)``, which JAX's fp32 mean matches:
    held against the JAX kernel at TinyLlama's width as the cases above.
    The card route sums in the kernel's order: a different fp32 sum, held
    to JAX's scales at the same rtol."""
    rng = np.random.default_rng(11)
    h = (rng.normal(size=(16, 2048)) * 1.5).astype(np.float32)
    g = (1.0 + 0.1 * rng.normal(size=(2048,))).astype(np.float32)
    jq, js = _strict(lambda a, b: JFQ.rmsnorm_quant(a, b, 1e-5, 8),
                     jnp.asarray(h, JDT[h_dt]), jnp.asarray(g, JDT[g_dt]))
    th, tg = _t(h, h_dt), _t(g, g_dt)
    cpu = TFQ._rmsnorm_quant_plain(th, tg, 1e-5, 8)
    assert all(torch.equal(a, b) for a, b in
               zip(cpu, TFQ._rmsnorm_quant_plain(th, tg, 1e-5, 8, kernel_order=False)))
    assert all(torch.equal(a, b) for a, b in zip(cpu, TFQ.rmsnorm_quant(th, tg, 1e-5, 8)))
    _check(*cpu, jq, js)
    _check(*TFQ._rmsnorm_quant_plain(th, tg, 1e-5, 8, kernel_order=True), jq, js)
