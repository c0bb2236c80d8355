"""Port parity: llm_qat_torch.ops.fused_layer against the JAX package's
ops/fused_layer.py (its Pallas producers in interpret mode), forward and
every gradient, on CPU in float32.

Inputs come from a numpy seed; activations and weights are scaled so that
some normed activations, SiLU products and weights lie beyond the STE clip at
+-2. Forward outputs are the exact integer dot through one f32 division: 1e-5,
unless an int8 activation rounds the other way between XLA's and torch's fp32
RMSNorm / sigmoid (one quantization step of one row, about 1e-2 of it; the
cases here meet none, and a case that met one would have to name it).
Gradients are f32 matmuls in another summation order: rtol/atol 1e-4 of the
tensor's largest magnitude; a gradient the STE zeroes is an exact zero on both
sides. The flash-layout blocks are checked for the (kvh, g, s, d) layouts
the kernel consumes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_qat_tpu.ops import fused_layer as JFL
from llm_qat_torch.ops import fused_layer as TFL

FWD = dict(rtol=1e-5, atol=1e-5)


def _grad_close(t, j, what):
    t, j = t.numpy(), np.asarray(j)
    assert t.shape == j.shape, what
    np.testing.assert_allclose(t, j, rtol=1e-4, atol=1e-4 * np.abs(j).max(), err_msg=what)
    np.testing.assert_array_equal(t == 0, j == 0, err_msg=what)


def _run(jfn, tfn, args, cots):
    """Both sides' outputs and gradients w.r.t. every arg, for cotangents
    ``cots`` (one per output)."""
    jout, vjp = jax.vjp(jfn, *(jnp.asarray(a) for a in args))
    single = not isinstance(jout, (tuple, list))
    jg = vjp(jnp.asarray(cots[0]) if single else tuple(jnp.asarray(c) for c in cots))
    targs = [torch.from_numpy(a).requires_grad_(True) for a in args]
    tout = tfn(*targs)
    touts = [tout] if single else list(tout)
    tg = torch.autograd.grad(touts, targs, [torch.from_numpy(c) for c in cots])
    return ([jout] if single else list(jout)), jg, [o.detach() for o in touts], tg


def _rng_w(rng, *shape, scale=0.6):
    w = (rng.normal(size=shape) * scale).astype(np.float32)
    w.flat[:2] = [2.0, -2.3]
    return w


@pytest.mark.parametrize("lead,H,Ns", [((2, 8), 128, (64, 32, 32)), ((16,), 256, (128, 128))])
@pytest.mark.parametrize("w_bits,a_bits", [(4, 8), (8, 8)])
def test_fused_norm_dense_matches_jax(lead, H, Ns, w_bits, a_bits):
    rng = np.random.default_rng(H)
    h = (rng.normal(size=lead + (H,)) * 1.5).astype(np.float32)
    g = (1.0 + 0.3 * rng.normal(size=(H,))).astype(np.float32)
    ws = [_rng_w(rng, H, n) for n in Ns]
    cots = [rng.normal(size=lead + (n,)).astype(np.float32) for n in Ns]
    kw = dict(w_bits=w_bits, a_bits=a_bits, eps=1e-6)
    jout, jg, tout, tg = _run(lambda h_, g_, *w_: JFL.fused_norm_dense(h_, g_, w_, **kw),
                              lambda h_, g_, *w_: TFL.fused_norm_dense(h_, g_, w_, **kw),
                              [h, g, *ws], cots)
    for t, j in zip(tout, jout):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), **FWD)
    for name, t, j in zip(["dh", "dg"] + [f"dw{i}" for i in range(len(ws))], tg, jg):
        _grad_close(t, j, name)
    for w, dw in zip(ws, tg[2:]):
        assert not dw.numpy()[~((w < 2) & (w > -2))].any()


@pytest.mark.parametrize("b,s,H,nh,kvh", [(2, 16, 128, 4, 2), (1, 8, 128, 4, 4)])
def test_fused_norm_qkv_flash_matches_jax(b, s, H, nh, kvh):
    rng = np.random.default_rng(s)
    d = H // nh
    groups = nh // kvh
    h = (rng.normal(size=(b, s, H)) * 1.5).astype(np.float32)
    g = (1.0 + 0.3 * rng.normal(size=(H,))).astype(np.float32)
    wq, wk, wv = _rng_w(rng, H, nh * d), _rng_w(rng, H, kvh * d), _rng_w(rng, H, kvh * d)
    cots = [rng.normal(size=(b, kvh, groups, s, d)).astype(np.float32),
            rng.normal(size=(b, kvh, s, d)).astype(np.float32),
            rng.normal(size=(b, kvh, s, d)).astype(np.float32)]
    kw = dict(w_bits=4, a_bits=8, eps=1e-6)
    jout, jg, tout, tg = _run(lambda *a: JFL.fused_norm_qkv_flash(*a, kvh, **kw),
                              lambda *a: TFL.fused_norm_qkv_flash(*a, kvh, **kw),
                              [h, g, wq, wk, wv], cots)
    assert tuple(tout[0].shape) == (b, kvh, groups, s, d)
    assert tuple(tout[1].shape) == tuple(tout[2].shape) == (b, kvh, s, d)
    for t, j in zip(tout, jout):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), **FWD)
    for name, t, j in zip(("dh", "dg", "dwq", "dwk", "dwv"), tg, jg):
        _grad_close(t, j, name)
    # the layouts are the flat projections', head-major: q head k*groups+g
    flat = TFL.fused_norm_dense(torch.from_numpy(h), torch.from_numpy(g),
                                (torch.from_numpy(wq),), **kw)[0]
    assert torch.equal(tout[0].permute(0, 3, 1, 2, 4).reshape(b, s, nh * d), flat)


@pytest.mark.parametrize("b,kvh,groups,s,d,H", [(2, 2, 2, 16, 32, 128), (1, 4, 1, 8, 32, 64)])
def test_fused_attn_out_dense_matches_jax(b, kvh, groups, s, d, H):
    rng = np.random.default_rng(d + s)
    attn5 = (rng.normal(size=(b, kvh, groups, s, d)) * 1.2).astype(np.float32)
    attn5.flat[:2] = [2.0, -2.5]
    wo = _rng_w(rng, kvh * groups * d, H)
    cot = rng.normal(size=(b, s, H)).astype(np.float32)
    kw = dict(w_bits=4, a_bits=8)
    jout, jg, tout, tg = _run(lambda a, w: JFL.fused_attn_out_dense(a, w, **kw),
                              lambda a, w: TFL.fused_attn_out_dense(a, w, **kw),
                              [attn5, wo], [cot])
    np.testing.assert_allclose(tout[0].numpy(), np.asarray(jout[0]), **FWD)
    _grad_close(tg[0], jg[0], "dattn")
    _grad_close(tg[1], jg[1], "dwo")
    assert not tg[0].numpy()[~((attn5 < 2) & (attn5 > -2))].any()
    jq, js = JFL._quant_per_token_heads(jnp.asarray(attn5), 8)
    tq, ts = TFL._quant_per_token_heads(torch.from_numpy(attn5), 8)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


@pytest.mark.parametrize("lead,I,H", [((2, 8), 128, 64), ((8,), 256, 128)])
def test_fused_silu_mul_dense_matches_jax(lead, I, H):
    rng = np.random.default_rng(I)
    gate = (rng.normal(size=lead + (I,)) * 2).astype(np.float32)
    up = (rng.normal(size=lead + (I,)) * 1.5).astype(np.float32)
    w = _rng_w(rng, I, H)
    cot = rng.normal(size=lead + (H,)).astype(np.float32)
    kw = dict(w_bits=4, a_bits=8)
    jout, jg, tout, tg = _run(lambda *a: JFL.fused_silu_mul_dense(*a, **kw),
                              lambda *a: TFL.fused_silu_mul_dense(*a, **kw),
                              [gate, up, w], [cot])
    np.testing.assert_allclose(tout[0].numpy(), np.asarray(jout[0]), **FWD)
    for name, t, j in zip(("dgate", "dup", "dw"), tg, jg):
        _grad_close(t, j, name)
    y = gate / (1 + np.exp(-gate)) * up
    masked = np.abs(y) > 2.001
    assert masked.any() and not tg[0].numpy()[masked].any() and not tg[1].numpy()[masked].any()


def test_rms_norm_bwd_and_ste_mask_match_jax():
    rng = np.random.default_rng(9)
    h = rng.normal(size=(8, 128)).astype(np.float32)
    g = (1.0 + 0.3 * rng.normal(size=(128,))).astype(np.float32)
    dxn = rng.normal(size=(8, 128)).astype(np.float32)
    jdh, jdg = JFL._rms_norm_bwd(jnp.asarray(h), jnp.asarray(g), 1e-6, jnp.asarray(dxn))
    tdh, tdg = TFL._rms_norm_bwd(torch.from_numpy(h), torch.from_numpy(g), 1e-6,
                                 torch.from_numpy(dxn))
    np.testing.assert_allclose(tdh.numpy(), np.asarray(jdh), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tdg.numpy(), np.asarray(jdg), rtol=1e-5, atol=1e-5)
    x = np.asarray([-2.5, -2.0, -1.0, 0.0, 1.999, 2.0, 3.0], np.float32)
    np.testing.assert_array_equal(
        TFL._ste_mask(torch.from_numpy(x), torch.ones(7)).numpy(),
        np.asarray(JFL._ste_mask(jnp.asarray(x), jnp.ones(7))))


@pytest.mark.parametrize("shape,w_bits,a_bits", [((16, 128), 4, 8), ((16, 64), 4, 8),
                                                 ((16, 128), 2, 8), ((7, 128), 8, 8),
                                                 ((16, 128), 8, 16)])
def test_supported_matches_jax(shape, w_bits, a_bits):
    assert (TFL.supported(torch.zeros(shape), w_bits, a_bits)
            == JFL.supported(jnp.zeros(shape), w_bits, a_bits))
