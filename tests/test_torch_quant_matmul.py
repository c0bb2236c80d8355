"""Port parity: llm_qat_torch.ops.quant_matmul against the JAX package's
ops/pallas/quant_matmul.py (its Pallas kernels in interpret mode on CPU).

Inputs come from a numpy seed and go to both packages. Integers (quantized
values, packing) must be bit-exact: both sides compute the scale in f32 and
round half to even (jnp.round / torch.round). Kernel outputs are held at
rtol/atol 1e-5 in float32 (the int32 sums are exact on both sides; only the
f32 epilogue may round differently).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_qat_tpu.ops.pallas import quant_matmul as JQM
from llm_qat_torch.ops import quant_matmul as TQM

TOL = dict(rtol=1e-5, atol=1e-5)


def _x(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("bits", [8, 6, 4])
def test_quantize_per_token_bit_exact(bits):
    x = _x((24, 96), 0)
    jq, js = JQM.quantize_per_token(jnp.asarray(x), bits)
    tq, ts = TQM.quantize_per_token(torch.from_numpy(x), bits)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


@pytest.mark.parametrize("bits", [8, 4])
def test_quantize_per_channel_and_pack_bit_exact(bits):
    w = _x((64, 48), 1) * 0.02
    jq, js = JQM.quantize_per_channel(jnp.asarray(w), bits)
    tq, ts = TQM.quantize_per_channel(torch.from_numpy(w), bits)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    if bits == 4:
        jp = JQM.pack_int4(jq)
        tp = TQM.pack_int4(tq)
        np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
        np.testing.assert_array_equal(TQM.unpack_int4(tp).numpy(),
                                      np.asarray(JQM.unpack_int4(jp)))
        jw, jsw = JQM.quantize_weights_w4(jnp.asarray(w))
        tw, tsw = TQM.quantize_weights_w4(torch.from_numpy(w))
        np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
        np.testing.assert_array_equal(tsw.numpy(), np.asarray(jsw))


def _operands(M, K, N, seed):
    x, w = _x((M, K), seed), _x((K, N), seed + 1) * 0.02
    xq, sx = JQM.quantize_per_token(jnp.asarray(x))
    wq, sw = JQM.quantize_per_channel(jnp.asarray(w))
    return x, w, [np.asarray(a) for a in (xq, wq, sx, sw)]


@pytest.mark.parametrize("M,K,N", [(32, 256, 128), (64, 128, 256)])
def test_int8_matmul_matches_jax(M, K, N):
    _, _, (xq, wq, sx, sw) = _operands(M, K, N, 2)
    want = JQM.int8_matmul(*(jnp.asarray(a) for a in (xq, wq, sx, sw)),
                           out_dtype=jnp.float32)
    got = TQM.int8_matmul(*(torch.from_numpy(a) for a in (xq, wq, sx, sw)),
                          out_dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    want_x = JQM.int8_matmul_xla(*(jnp.asarray(a) for a in (xq, wq, sx, sw)),
                                 out_dtype=jnp.float32)
    got_x = TQM.int8_matmul_xla(*(torch.from_numpy(a) for a in (xq, wq, sx, sw)),
                                out_dtype=torch.float32)
    np.testing.assert_allclose(got_x.numpy(), np.asarray(want_x), **TOL)


@pytest.mark.parametrize("M,K,N", [(32, 256, 128), (32, 512, 256)])
def test_int4_matmul_matches_jax(M, K, N):
    x, w, _ = _operands(M, K, N, 3)
    xq, sx = JQM.quantize_per_token(jnp.asarray(x))
    wp, sw = JQM.quantize_weights_w4(jnp.asarray(w))
    want = JQM.int4_matmul(xq, wp, sx, sw, out_dtype=jnp.float32)
    got = TQM.int4_matmul(*(torch.from_numpy(np.asarray(a)) for a in (xq, wp, sx, sw)),
                          out_dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("M", [5, 200])
def test_w8a8_and_w4a8_matmul_match_jax(M):
    """Activation quant + padding + the row-count route (kernel below 128
    rows, library product at or above)."""
    K, N = 128, 64
    x, w, _ = _operands(M, K, N, 4)
    wq, sw = JQM.quantize_per_channel(jnp.asarray(w))
    want = JQM.w8a8_matmul(jnp.asarray(x), wq, sw, out_dtype=jnp.float32)
    got = TQM.w8a8_matmul(torch.from_numpy(x), torch.from_numpy(np.asarray(wq)),
                          torch.from_numpy(np.asarray(sw)), out_dtype=torch.float32)
    assert got.shape == (M, N)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    wp, sw4 = JQM.quantize_weights_w4(jnp.asarray(w))
    want4 = JQM.w4a8_matmul(jnp.asarray(x), wp, sw4, out_dtype=jnp.float32)
    got4 = TQM.w4a8_matmul(torch.from_numpy(x), torch.from_numpy(np.asarray(wp)),
                           torch.from_numpy(np.asarray(sw4)), out_dtype=torch.float32)
    np.testing.assert_allclose(got4.numpy(), np.asarray(want4), **TOL)


def test_pad_rows_matches_jax():
    x = np.arange(10 * 3, dtype=np.int8).reshape(10, 3)
    jp, jm = JQM._pad_rows(jnp.asarray(x), 32)
    tp, tm = TQM._pad_rows(torch.from_numpy(x), 32)
    assert tm == jm == 10
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    assert TQM.XLA_INT8_MIN_ROWS == JQM.XLA_INT8_MIN_ROWS


def test_plain_epilogue_order_differs_from_division():
    """The kernel's epilogue multiplies by the reciprocal, the library route
    divides; both are kept as in the JAX package (they may differ in the
    last f32 bit, never more)."""
    _, _, (xq, wq, sx, sw) = _operands(32, 128, 64, 5)
    t = [torch.from_numpy(a) for a in (xq, wq, sx, sw)]
    a = TQM.int8_matmul(*t, out_dtype=torch.float32)
    b = TQM.int8_matmul_xla(*t, out_dtype=torch.float32)
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-7, atol=0)


def test_cpu_path_counts_no_launch_and_other_devices_raise():
    _, _, (xq, wq, sx, sw) = _operands(32, 128, 64, 6)
    t = [torch.from_numpy(a) for a in (xq, wq, sx, sw)]
    n8, n4 = TQM.int8_matmul.launches, TQM.int4_matmul.launches
    TQM.int8_matmul(*t)
    TQM.int4_matmul(t[0], TQM.pack_int4(t[1]), t[2], t[3])
    assert (TQM.int8_matmul.launches, TQM.int4_matmul.launches) == (n8, n4)
    meta = [a.to("meta") for a in t]
    with pytest.raises(ValueError, match="CUDA"):
        TQM.int8_matmul(*meta)
