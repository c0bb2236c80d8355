"""Port parity for the stacked kernels' plain versions: int8_matmul_stacked,
int4_matmul_stacked and quantized_decode_attention_stacked of llm_qat_torch
against the JAX package's (Pallas in interpret mode), at the first, a middle
and the last layer of the stack, and against the port's unstacked functions
on the slice.

Inputs come from a numpy seed. The GEMMs are the exact int32 sum through the
same f32 epilogue: against JAX held at rtol 1e-6 (XLA may fuse the
epilogue's reciprocal; never more than the last bit), against the port's
unstacked functions bit-equal. The attention is held at rtol/atol 1e-5 in
float32 and, with a bf16 query (both sides round alike), at 1e-2.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_qat_tpu.ops.pallas import decode_attention as JDA
from llm_qat_tpu.ops.pallas import quant_matmul as JQM
from llm_qat_torch.ops import decode_attention as TDA
from llm_qat_torch.ops import quant_matmul as TQM

L = 5
LAYERS = [0, 2, L - 1]
t = torch.from_numpy


@pytest.mark.parametrize("layer", LAYERS)
@pytest.mark.parametrize("w4", [False, True], ids=["int8", "int4"])
@pytest.mark.parametrize("out", ["bfloat16", "float32"])
def test_stacked_matmul_matches_jax_and_the_unstacked_port(layer, w4, out):
    rng = np.random.default_rng(10 + layer)
    M, K, N = 32, 256, 128
    xq = rng.integers(-127, 128, (M, K)).astype(np.int8)
    sx = rng.uniform(5.0, 50.0, (M, 1)).astype(np.float32)
    sw = rng.uniform(50.0, 500.0, (L, 1, N)).astype(np.float32)
    if w4:
        w = rng.integers(0, 256, (L, K // 2, N)).astype(np.uint8)
        jfn, tfn, tflat = JQM.int4_matmul_stacked, TQM.int4_matmul_stacked, TQM.int4_matmul
    else:
        w = rng.integers(-127, 128, (L, K, N)).astype(np.int8)
        jfn, tfn, tflat = JQM.int8_matmul_stacked, TQM.int8_matmul_stacked, TQM.int8_matmul
    want = jfn(jnp.asarray(xq), jnp.asarray(w), jnp.asarray(sx), jnp.asarray(sw),
               layer=layer, out_dtype=getattr(jnp, out))
    got = tfn(t(xq), t(w), t(sx), t(sw), layer=layer, out_dtype=getattr(torch, out))
    assert got.dtype == getattr(torch, out)
    # bf16 outputs: one bf16 step where the f32 value sits on a rounding edge
    rtol = 1e-6 if out == "float32" else 2.0 ** -7
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)), rtol=rtol, atol=0)
    flat = tflat(t(xq), t(w[layer]), t(sx), t(sw[layer]), out_dtype=getattr(torch, out))
    assert torch.equal(got, flat)


def test_stacked_matmul_rejects_bad_layer_and_shapes():
    xq = torch.zeros(8, 64, dtype=torch.int8)
    w = torch.zeros(3, 64, 16, dtype=torch.int8)
    sx, sw = torch.ones(8, 1), torch.ones(3, 1, 16)
    n = TQM.int8_matmul_stacked.launches
    assert TQM.int8_matmul_stacked(xq, w, sx, sw, layer=2).shape == (8, 16)
    assert TQM.int8_matmul_stacked.launches == n       # the CPU launches nothing
    with pytest.raises(ValueError, match="layer"):
        TQM.int8_matmul_stacked(xq, w, sx, sw, layer=3)
    with pytest.raises(ValueError, match="K mismatch"):
        TQM.int4_matmul_stacked(xq, w.to(torch.uint8), sx, sw, layer=0)


def _attn_operands(seed, b=3, kvh=2, groups=4, S=64, hd=32):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, kvh * groups, hd)).astype(np.float32)
    k_q = rng.integers(-127, 128, (L, b, kvh, hd, S)).astype(np.int8)
    v_q = rng.integers(-127, 128, (L, b, kvh, hd, S)).astype(np.int8)
    k_s = rng.uniform(0.005, 0.02, (L, b, S)).astype(np.float32)
    v_s = rng.uniform(0.005, 0.02, (L, b, S)).astype(np.float32)
    k_new = (rng.integers(-127, 128, (b, kvh, hd)) * 0.01).astype(np.float32)
    v_new = (rng.integers(-127, 128, (b, kvh, hd)) * 0.01).astype(np.float32)
    pos = np.arange(S, dtype=np.float32)
    inv_freq = 1.0 / (10000.0 ** (np.arange(0, hd, 2, dtype=np.float32) / hd))
    fr = inv_freq[:, None] * pos[None, :]
    return (q, k_q, k_s, v_q, v_s, k_new, v_new,
            np.cos(fr).astype(np.float32), np.sin(fr).astype(np.float32))


def _attn_both(ops, lengths, inc, layer, rope, tables, bf16=False):
    q, k_q, k_s, v_q, v_s, k_new, v_new, kc, ks = ops
    jt = (jnp.asarray(kc), jnp.asarray(ks)) if tables else (None, None)
    tt = (t(kc), t(ks)) if tables else (None, None)
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if bf16 else (jnp.float32, torch.float32)
    want = JDA.quantized_decode_attention_stacked(
        jnp.asarray(q, jdt), *(jnp.asarray(a) for a in (k_q, k_s, v_q, v_s)),
        jnp.asarray(lengths), jnp.asarray(inc), jnp.asarray(k_new, jdt),
        jnp.asarray(v_new, jdt), *jt, layer=layer, rope=rope)
    got = TDA.quantized_decode_attention_stacked(
        t(q).to(tdt), *(t(a) for a in (k_q, k_s, v_q, v_s)), t(lengths), t(inc),
        t(k_new).to(tdt), t(v_new).to(tdt), *tt, layer=layer, rope=rope)
    return np.asarray(want.astype(jnp.float32)), got.float().numpy()


@pytest.mark.parametrize("layer", LAYERS)
@pytest.mark.parametrize("rope,tables", [(True, True), (True, False), (False, False)])
def test_stacked_decode_attention_matches_jax(layer, rope, tables):
    """Ragged lengths, an empty slot whose pair is included, and a slot whose
    pair is excluded."""
    ops = _attn_operands(20 + layer)
    lengths = np.asarray([35, 0, 63], np.int32)
    inc = np.asarray([1, 1, 0], np.int32)
    want, got = _attn_both(ops, lengths, inc, layer, rope, tables)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_stacked_decode_attention_empty_excluded_slot_returns_the_pair_as_jax_does():
    """The stacked kernel does not zero an excluded pair's p: with an empty
    cache too, ``exp(-1e30 - -1e30)`` is 1 and the output is ``v_new``. The
    port mirrors it."""
    ops = _attn_operands(31)
    lengths, inc = np.asarray([0, 7, 9], np.int32), np.asarray([0, 0, 1], np.int32)
    want, got = _attn_both(ops, lengths, inc, 1, True, True)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    v_new = ops[6]
    np.testing.assert_allclose(got[0].reshape(2, 4, 32), np.repeat(v_new[0][:, None], 4, 1),
                               rtol=1e-6)


def test_stacked_decode_attention_bf16_mirrors_jax_roundings():
    ops = _attn_operands(32)
    want, got = _attn_both(ops, np.asarray([40, 17, 64], np.int32),
                           np.asarray([1, 1, 1], np.int32), 3, True, True, bf16=True)
    np.testing.assert_allclose(got, want, rtol=1e-2, atol=1e-2 * np.abs(want).max())


@pytest.mark.parametrize("layer", LAYERS)
def test_stacked_decode_attention_cache_terms_are_the_unstacked_ports(layer):
    """With an excluded pair and non-empty slots the stacked function is the
    unstacked one on that layer's slice, bit for bit."""
    q, k_q, k_s, v_q, v_s, k_new, v_new, kc, ks = _attn_operands(40 + layer)
    lengths = np.asarray([35, 1, 64], np.int32)
    got = TDA.quantized_decode_attention_stacked(
        t(q), t(k_q), t(k_s), t(v_q), t(v_s), t(lengths), torch.zeros(3, dtype=torch.int32),
        t(k_new), t(v_new), t(kc), t(ks), layer=layer)
    flat = TDA.quantized_decode_attention(
        t(q), t(k_q[layer]), t(k_s[layer]), t(v_q[layer]), t(v_s[layer]), t(lengths),
        t(kc), t(ks))
    assert torch.equal(got, flat)
    n = TDA.quantized_decode_attention_stacked.launches
    with pytest.raises(ValueError, match="layer"):
        TDA.quantized_decode_attention_stacked(
            t(q), t(k_q), t(k_s), t(v_q), t(v_s), t(lengths),
            torch.zeros(3, dtype=torch.int32), t(k_new), t(v_new), layer=L)
    assert TDA.quantized_decode_attention_stacked.launches == n


def test_stacked_decode_attention_bf16_walks_jax_blocks():
    """bk = 16 at S = 64, compiled without XLA's excess precision (see
    tests/test_torch_decode_attention.py): lengths cross one to four blocks,
    one slot empty with its pair, one pair excluded; at most 1% of the
    outputs differ from JAX's bits."""
    import jax

    q, k_q, k_s, v_q, v_s, k_new, v_new, kc, ks = _attn_operands(33, b=4)
    lengths = np.asarray([0, 17, 40, 63], np.int32)
    inc = np.asarray([1, 1, 0, 1], np.int32)
    kw = dict(layer=2, rope=True, bk=16)
    jops = [jnp.asarray(q, jnp.bfloat16)] + [jnp.asarray(a) for a in (k_q, k_s, v_q, v_s)] + [
        jnp.asarray(lengths), jnp.asarray(inc), jnp.asarray(k_new, jnp.bfloat16),
        jnp.asarray(v_new, jnp.bfloat16), jnp.asarray(kc), jnp.asarray(ks)]
    f = jax.jit(lambda *a: JDA.quantized_decode_attention_stacked(*a, **kw))
    want = f.lower(*jops).compile(
        compiler_options={"xla_allow_excess_precision": False})(*jops)
    want = np.asarray(want.astype(jnp.float32))
    got = TDA.quantized_decode_attention_stacked(
        t(q).to(torch.bfloat16), *(t(a) for a in (k_q, k_s, v_q, v_s)), t(lengths), t(inc),
        t(k_new).to(torch.bfloat16), t(v_new).to(torch.bfloat16), t(kc), t(ks), **kw).float().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-2, atol=1e-2 * np.abs(want).max())
    differ = float(np.mean(got != want))
    assert differ <= 0.01, f"{differ:.2%} of the outputs differ from JAX's"
