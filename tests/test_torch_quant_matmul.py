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


# ---------------------------------------------------------------------------
# Variant picking and split-K sizing (pure; the kernels run on the card
# only)
# ---------------------------------------------------------------------------

# (K, N) of the served projections: TinyLlama-1.1B's qkv, o, gate-up, down,
# then LLaMA-7B's
PROJ = [(2048, 2560), (2048, 2048), (2048, 11264), (5632, 2048),
        (4096, 12288), (4096, 4096), (4096, 22016), (11008, 4096)]
ROWS = [1, 8, 32, 33, 64, 65, 127, 128, 129, 1024, 4096]


@pytest.mark.parametrize("M", ROWS)
@pytest.mark.parametrize("w4", [False, True])
def test_gemm_plan_picks_the_variant_from_the_rows(M, w4):
    """Decode up to 64 rows (tiles of 32 or 64 rows over 64 columns),
    prefill above (128 x 128 tiles); stages of 128 stored weight rows, 64
    packed rows in the W4 prefill variant."""
    for K, N in PROJ:
        p = TQM.gemm_plan(M, N, K, w4)
        decode = M <= TQM.DECODE_MAX_ROWS
        assert p["variant"] == ("decode" if decode else "prefill")
        assert p["bm"] == (32 if M <= 32 else 64 if decode else 128)
        assert p["bn"] == (64 if decode else 128)
        assert p["bk"] == (64 if (w4 and not decode) else 128)
        assert p["steps"] == -(-(K // 2 if w4 else K) // p["bk"])
        assert p["tiles"] == (-(-M // p["bm"]) if not decode else 1) * -(-N // p["bn"])


@pytest.mark.parametrize("K,N", PROJ)
@pytest.mark.parametrize("w4", [False, True])
def test_gemm_plan_decode_splits_cover_the_card(K, N, w4):
    """At decode rows every projection's blocks cover the 132 SMs (split K
    while the column tiles are fewer), with at most one cluster of
    MAX_SPLITS blocks a tile, each split at least one stage deep."""
    p = TQM.gemm_plan(32, N, K, w4)
    assert 1 <= p["splits"] <= min(p["steps"], TQM.MAX_SPLITS)
    assert p["tiles"] * p["splits"] >= min(132, p["tiles"] * TQM.MAX_SPLITS)
    assert p["tiles"] * (p["splits"] - 1) < 132   # no split more than the card needs


@pytest.mark.parametrize("M", [128, 1024, 4096])
@pytest.mark.parametrize("K,N", PROJ)
def test_gemm_plan_prefill_splits_only_an_idle_card(M, K, N):
    """Prefill splits K only until the output tiles cover the 132 SMs, and no
    split is shorter than PREFILL_MIN_STEPS stages (LLaMA-7B's down at W4:
    5504 packed rows, 86 stages of 64)."""
    for w4 in (False, True):
        p = TQM.gemm_plan(M, N, K, w4)
        assert 1 <= p["splits"] <= TQM.MAX_SPLITS
        assert p["tiles"] * (p["splits"] - 1) < 132
        assert p["splits"] == 1 or p["steps"] // p["splits"] >= TQM.PREFILL_MIN_STEPS
        if p["tiles"] >= 132:
            assert p["splits"] == 1
    assert TQM.gemm_plan(128, 4096, 11008, True)["steps"] == 86


def test_gemm_plan_follows_the_card_size():
    """The split count is chosen for the card the wrapper runs on."""
    small = TQM.gemm_plan(32, 2048, 2048, False, sms=66)
    big = TQM.gemm_plan(32, 2048, 2048, False, sms=132)
    assert small["splits"] < big["splits"]
    assert TQM.gemm_plan(32, 2048, 2048, False) == big
