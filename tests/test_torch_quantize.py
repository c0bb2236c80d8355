"""Port parity: llm_qat_torch.ops.quantize against llm_qat_tpu.ops.quantize,
forward and gradient, on CPU in float32.

Inputs come from a numpy seed and straddle the STE clip at +-2. Forward
outputs are held at rtol/atol 1e-6: both sides take the same f32 scale by one
IEEE division and round half to even, so they differ at most in the last bit
of the final division. Gradients are held exactly: the STE backward is a mask
(pass-through inside (-2, 2), zero outside), so both sides return the
cotangent's own bits or zeros.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_qat_tpu.ops import quantize as JQ
from llm_qat_torch.ops import quantize as TQ

TOL = dict(rtol=1e-6, atol=1e-6)
AXES = [None, -1, 0, 1, (1, 3), (-2, -1)]


def _x(shape=(3, 4, 5, 6), seed=0, scale=1.5):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=shape) * scale).astype(np.float32)
    x.flat[:4] = [2.0, -2.0, 1.9999999, -1.9999999]   # the mask's edges
    return x


def _both(jfn, tfn, x, g):
    """(forward, gradient) of both sides for the cotangent ``g``."""
    jy, vjp = jax.vjp(jfn, jnp.asarray(x))
    (jg,) = vjp(jnp.asarray(g))
    tx = torch.from_numpy(x).requires_grad_(True)
    ty = tfn(tx)
    (tg,) = torch.autograd.grad(ty, tx, torch.from_numpy(g))
    return np.asarray(jy), np.asarray(jg), ty.detach().numpy(), tg.numpy()


@pytest.mark.parametrize("axis", AXES, ids=str)
@pytest.mark.parametrize("bits", [8, 4, 3])
@pytest.mark.parametrize("kind", ["sym", "asym"])
def test_fake_quant_matches_jax(kind, bits, axis):
    x = _x()
    g = np.random.default_rng(1).normal(size=x.shape).astype(np.float32)
    jf = getattr(JQ, f"{kind}_fake_quant")
    tf = getattr(TQ, f"{kind}_fake_quant")
    jy, jg, ty, tg = _both(lambda a: jf(a, bits, axis), lambda a: tf(a, bits, axis), x, g)
    np.testing.assert_allclose(ty, jy, **TOL)
    np.testing.assert_array_equal(tg, jg)
    inside = (x < 2) & (x > -2)
    np.testing.assert_array_equal(tg, np.where(inside, g, 0.0))
    assert not inside.all() and inside.any()
    # the raw functions are the forward alone
    jr = getattr(JQ, f"{kind}_fake_quant_raw")(jnp.asarray(x), bits, axis)
    tr = getattr(TQ, f"{kind}_fake_quant_raw")(torch.from_numpy(x), bits, axis)
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), **TOL)


def test_forward_does_not_clamp_and_custom_clip():
    x = _x(scale=3.0)
    g = np.ones_like(x)
    jy, jg, ty, tg = _both(lambda a: JQ.sym_fake_quant(a, 4, -1, (-1.0, 0.5)),
                           lambda a: TQ.sym_fake_quant(a, 4, -1, (-1.0, 0.5)), x, g)
    np.testing.assert_allclose(ty, jy, **TOL)
    np.testing.assert_array_equal(tg, jg)
    assert np.abs(ty).max() > 2.5          # values beyond the clip survive the forward


@pytest.mark.parametrize("axis", [0, None, 1])
@pytest.mark.parametrize("bits", [1, 2])
def test_lowbit_weight_matches_jax(bits, axis):
    w = _x((16, 12), seed=2, scale=0.5)
    g = np.random.default_rng(3).normal(size=w.shape).astype(np.float32)
    jy, jg, ty, tg = _both(lambda a: JQ.lowbit_weight_fake_quant(a, bits, axis),
                           lambda a: TQ.lowbit_weight_fake_quant(a, bits, axis), w, g)
    np.testing.assert_allclose(ty, jy, **TOL)
    np.testing.assert_array_equal(tg, jg)
    np.testing.assert_array_equal(tg, g)   # identity STE: no mask


@pytest.mark.parametrize("layerwise", [False, True])
@pytest.mark.parametrize("bits", [32, 8, 4, 2, 1])
def test_weight_fake_quant_policy(bits, layerwise):
    w = _x((16, 12), seed=4, scale=1.2)
    g = np.random.default_rng(5).normal(size=w.shape).astype(np.float32)
    jy, jg, ty, tg = _both(lambda a: JQ.weight_fake_quant(a, bits, layerwise=layerwise),
                           lambda a: TQ.weight_fake_quant(a, bits, layerwise=layerwise), w, g)
    np.testing.assert_allclose(ty, jy, **TOL)
    np.testing.assert_array_equal(tg, jg)


@pytest.mark.parametrize("symmetric", [True, False])
@pytest.mark.parametrize("layerwise", [False, True])
@pytest.mark.parametrize("bits", [32, 8, 4, 2])
def test_act_fake_quant_policy(bits, layerwise, symmetric):
    x = _x((2, 6, 16), seed=6)
    g = np.random.default_rng(7).normal(size=x.shape).astype(np.float32)
    kw = dict(symmetric=symmetric, layerwise=layerwise)
    jy, jg, ty, tg = _both(lambda a: JQ.act_fake_quant(a, bits, **kw),
                           lambda a: TQ.act_fake_quant(a, bits, **kw), x, g)
    np.testing.assert_allclose(ty, jy, **TOL)
    np.testing.assert_array_equal(tg, jg)
    if bits in (32, 2):                     # inactive outside 2 < bits < 32
        np.testing.assert_array_equal(ty, x)


@pytest.mark.parametrize("bits", [32, 8, 4])
def test_kv_fake_quant_matches_jax(bits):
    x = _x((2, 6, 16), seed=8)
    g = np.random.default_rng(9).normal(size=x.shape).astype(np.float32)
    jy, jg, ty, tg = _both(lambda a: JQ.kv_fake_quant(a, bits),
                           lambda a: TQ.kv_fake_quant(a, bits), x, g)
    np.testing.assert_allclose(ty, jy, **TOL)
    np.testing.assert_array_equal(tg, jg)


def test_constants_and_bf16_keeps_its_type():
    assert TQ.DEFAULT_CLIP == JQ.DEFAULT_CLIP == (-2.0, 2.0)
    x = torch.from_numpy(_x((4, 16))).to(torch.bfloat16)
    for fn in (TQ.sym_fake_quant, TQ.asym_fake_quant):
        assert fn(x, 8, -1).dtype == torch.bfloat16
    want = JQ.sym_fake_quant(jnp.asarray(x.float().numpy(), jnp.bfloat16), 8, -1)
    # bf16: every step rounds to bf16 on both sides; one bf16 step apart at most
    np.testing.assert_allclose(TQ.sym_fake_quant(x, 8, -1).float().numpy(),
                               np.asarray(want.astype(jnp.float32)), rtol=2 ** -7, atol=1e-3)
