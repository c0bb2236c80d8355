"""Port parity: llm_qat_torch.ops.qat_matmul and ops.linear against the JAX
package's ops/pallas/qat_matmul.py and ops/linear.py, on CPU in float32.

Inputs come from a numpy seed; some activations and weights lie beyond the
STE clip at +-2. The forward is the exact integer dot through one f32
division on both sides: held at 1e-5 (rtol and atol). Gradients are f32
matmuls against the same fake-quant operands in another summation order: held
at 1e-4; where the STE masks a gradient both sides give exact zeros.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_qat_tpu.ops import linear as JLIN
from llm_qat_tpu.ops.pallas import qat_matmul as JQM
from llm_qat_torch.ops import linear as TLIN
from llm_qat_torch.ops import qat_matmul as TQM

FWD = dict(rtol=1e-5, atol=1e-5)
GRAD = dict(rtol=1e-4, atol=1e-4)


def _xw(lead=(2, 5), K=32, N=24, seed=0):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=lead + (K,)) * 1.2).astype(np.float32)
    w = (rng.normal(size=(K, N)) * 0.8).astype(np.float32)
    x.flat[:3] = [2.0, -2.5, 3.0]
    w.flat[:3] = [2.0, -2.0, 2.2]
    g = rng.normal(size=lead + (N,)).astype(np.float32)
    return x, w, g


def _both(jfn, tfn, x, w, g):
    jy, vjp = jax.vjp(jfn, jnp.asarray(x), jnp.asarray(w))
    jdx, jdw = vjp(jnp.asarray(g))
    tx = torch.from_numpy(x).requires_grad_(True)
    tw = torch.from_numpy(w).requires_grad_(True)
    ty = tfn(tx, tw)
    tdx, tdw = torch.autograd.grad(ty, (tx, tw), torch.from_numpy(g))
    return (np.asarray(jy), np.asarray(jdx), np.asarray(jdw),
            ty.detach().numpy(), tdx.numpy(), tdw.numpy())


def _check(res, x, w, masked=True):
    jy, jdx, jdw, ty, tdx, tdw = res
    np.testing.assert_allclose(ty, jy, **FWD)
    np.testing.assert_allclose(tdx, jdx, **GRAD)
    np.testing.assert_allclose(tdw, jdw, **GRAD)
    if masked:
        out_x, out_w = ~((x < 2) & (x > -2)), ~((w < 2) & (w > -2))
        assert out_x.any() and out_w.any()
        assert not tdx[out_x].any() and not jdx[out_x].any()
        assert not tdw[out_w].any() and not jdw[out_w].any()


@pytest.mark.parametrize("w_bits,a_bits", [(8, 8), (4, 8), (3, 4), (4, 3)])
@pytest.mark.parametrize("lead", [(2, 5), (7,), (1, 2, 3)])
def test_fused_quant_matmul_matches_jax(w_bits, a_bits, lead):
    x, w, g = _xw(lead)
    assert TQM.supported(w_bits, a_bits) and JQM.supported(w_bits, a_bits)
    _check(_both(lambda a, b: JQM.fused_quant_matmul(a, b, w_bits, a_bits),
                 lambda a, b: TQM.fused_quant_matmul(a, b, w_bits, a_bits), x, w, g), x, w)


@pytest.mark.parametrize("w_bits,a_bits", [(2, 8), (8, 2), (9, 8), (8, 16), (32, 32)])
def test_supported_matches_jax(w_bits, a_bits):
    assert TQM.supported(w_bits, a_bits) == JQM.supported(w_bits, a_bits) is False


@pytest.mark.parametrize("bits,axis", [(8, -1), (4, 0), (3, -1)])
def test_quant_int_bit_exact(bits, axis):
    x, w, _ = _xw((6,), seed=3)
    a = x if axis == -1 else w
    jq, js = JQM._quant_int(jnp.asarray(a), bits, axis)
    tq, ts = TQM._quant_int(torch.from_numpy(a), bits, axis)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32


def test_fwd_impl_matches_jax():
    x, w, _ = _xw((6,), seed=4)
    jo, (jxq, jsx, jwq, jsw) = JQM._fwd_impl(jnp.asarray(x), jnp.asarray(w), 4, 8)
    to, (txq, tsx, twq, tsw) = TQM._fwd_impl(torch.from_numpy(x), torch.from_numpy(w), 4, 8)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), **FWD)
    np.testing.assert_array_equal(txq.numpy(), np.asarray(jxq))
    np.testing.assert_array_equal(twq.numpy(), np.asarray(jwq))


DENSE = {
    "fp": dict(),
    "w8a8": dict(w_bits=8, a_bits=8),
    "w4a8": dict(w_bits=4, a_bits=8),
    "w4a8_fused": dict(w_bits=4, a_bits=8, fused=True),
    "w8a8_fused": dict(w_bits=8, a_bits=8, fused=True),
    "w2a8_fused_falls_back": dict(w_bits=2, a_bits=8, fused=True),
    "w1a16": dict(w_bits=1, a_bits=16),
    "asym": dict(w_bits=4, a_bits=8, symmetric=False),
    "asym_fused_falls_back": dict(w_bits=4, a_bits=8, symmetric=False, fused=True),
    "act_layerwise": dict(w_bits=4, a_bits=8, act_layerwise=True, fused=True),
    "weight_layerwise": dict(w_bits=8, a_bits=4, weight_layerwise=True),
    "weights_only": dict(w_bits=4, a_bits=32),
}


@pytest.mark.parametrize("name", list(DENSE))
def test_quant_dense_matches_jax(name):
    kw = DENSE[name]
    x, w, g = _xw(seed=5)
    res = _both(lambda a, b: JLIN.quant_dense(a, b, **kw),
                lambda a, b: TLIN.quant_dense(a, b, **kw), x, w, g)
    _check(res, x, w, masked=False)
    jy, jdx, jdw, ty, tdx, tdw = res
    # wherever one side's STE zeroes a gradient, so does the other's
    np.testing.assert_array_equal(tdx == 0, jdx == 0)
    np.testing.assert_array_equal(tdw == 0, jdw == 0)


def test_fused_equals_unfused_fake_quant_product():
    """The integer dot IS the fake-quant product (less rounding): the two
    routes agree to f32 matmul rounding."""
    x, w, _ = _xw(seed=6)
    a = TLIN.quant_dense(torch.from_numpy(x), torch.from_numpy(w), w_bits=4, a_bits=8, fused=True)
    b = TLIN.quant_dense(torch.from_numpy(x), torch.from_numpy(w), w_bits=4, a_bits=8)
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4, atol=1e-4)


def test_mixed_types_promote_as_jax():
    x, w, _ = _xw(seed=7)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    out = TLIN.quant_dense(xb, torch.from_numpy(w))
    want = JLIN.quant_dense(jnp.asarray(x, jnp.bfloat16), jnp.asarray(w))
    assert out.dtype == torch.float32 and want.dtype == jnp.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(want), **GRAD)
    fused = TQM.fused_quant_matmul(xb, torch.from_numpy(w), 4, 8)
    assert fused.dtype == torch.bfloat16       # the output takes x's type


def test_int_dot_and_mm_f32_on_cpu():
    rng = np.random.default_rng(8)
    a = torch.from_numpy(rng.integers(-127, 128, (5, 40)).astype(np.int8))
    b = torch.from_numpy(rng.integers(-127, 128, (40, 9)).astype(np.int8))
    np.testing.assert_array_equal(TQM.int_dot(a, b).numpy(),
                                  (a.numpy().astype(np.int64) @ b.numpy().astype(np.int64)))
    x = torch.randn(4, 8).to(torch.bfloat16)
    y = torch.randn(8, 3).to(torch.bfloat16)
    out = TQM.mm_f32(x, y)
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), (x.float() @ y.float()).numpy(), rtol=1e-6)
