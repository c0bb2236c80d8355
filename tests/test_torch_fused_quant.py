"""Port parity: llm_qat_torch.ops.fused_quant (plain versions, CPU) against the
JAX package's Pallas kernels rmsnorm_quant / silu_mul_quant in interpret mode.

Inputs come from a numpy seed. Scales are held at rtol 1e-6: the absmax is an
exact maximum of values that agree to the last bits, and the scale one IEEE
division. Integers are equal, or 1 apart where x*s sits on a rounding boundary
(XLA's and torch's fp32 mean / rsqrt / sigmoid differ in the last bit, the
class the JAX kernels' docstring names): every case states the share it
allows, 0.5% of the elements, and none may differ by more than 1.

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
