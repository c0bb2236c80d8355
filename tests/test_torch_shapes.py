"""The shapes the card's kernels were widened to, held on the CPU against the
JAX package: the plain versions that ``chip_smoke.py`` and the ``-m cuda``
tests hold each new kernel instantiation against, and the wrappers' gates.

* K1/K2 at K = 64 (the tiny models' hidden size) and 2752 (LLaMA-7B's down
  projection at tp = 4): no multiple of the kernels' 128-row stage. The plain
  versions against JAX's Pallas kernels in interpret mode, to the bit.
* K3, K7 and K8 at (query heads per kv head, head dim) = (2, 16), (2, 32),
  (4, 128), (8, 128), int8 and nibble-packed caches, at rtol / atol 1e-5
  (the tolerance of ``test_torch_decode_attention.py``).
* K4, K10 and K11 at head dims 16 and 32 (f32 and bf16) and 128 (f32): f32 at
  1e-5, bf16 with the JAX side compiled without excess precision, held at 2
  bf16 steps + 1e-2 x the median (``test_torch_flash_backward.py``'s limit).
* The gates: what the kernels are built for passes, anything else raises and
  names the built set.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_qat_tpu.ops.pallas import decode_attention as JDA
from llm_qat_tpu.ops.pallas import flash_attention as JFA
from llm_qat_tpu.ops.pallas import quant_matmul as JQM
from llm_qat_torch.ops import decode_attention as TDA
from llm_qat_torch.ops import flash_attention as TFA
from llm_qat_torch.ops import quant_matmul as TQM

TOL = dict(rtol=1e-5, atol=1e-5)
NEW_DECODE_SHAPES = [(2, 16), (2, 32), (4, 128), (8, 128)]


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a))


def _j(a):
    return None if a is None else jnp.asarray(a)


# ---------------------------------------------------------------- K1 / K2


@pytest.mark.parametrize("K", [64, 2752])
@pytest.mark.parametrize("w4", [False, True])
def test_gemm_plain_matches_jax_kernels_at_a_k_tail(K, w4):
    M, N = 8, 128
    rng = np.random.default_rng(K + w4)
    x = rng.normal(size=(M, K)).astype(np.float32)
    w = (rng.normal(size=(K, N)) * 0.02).astype(np.float32)
    xq, sx = JQM.quantize_per_token(jnp.asarray(x))
    if w4:
        wq, sw = JQM.quantize_weights_w4(jnp.asarray(w))
        want = JQM.int4_matmul(xq, wq, sx, sw, out_dtype=jnp.float32)
        got = TQM.int4_matmul(*(_t(a) for a in (xq, wq, sx, sw)), out_dtype=torch.float32)
    else:
        wq, sw = JQM.quantize_per_channel(jnp.asarray(w))
        want = JQM.int8_matmul(xq, wq, sx, sw, out_dtype=jnp.float32)
        got = TQM.int8_matmul(*(_t(a) for a in (xq, wq, sx, sw)), out_dtype=torch.float32)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    plan = TQM.gemm_plan(M, N, K, w4)
    assert plan["steps"] == -(-(K // 2 if w4 else K) // plan["bk"])   # the tail is a step


def test_gemm_gate_takes_every_k_that_is_a_multiple_of_32():
    for K in (32, 64, 256, 768, 1376, 2752, 2048):
        TQM.check_gemm_shape("int8_matmul", 128, K)
    for K, N in ((2736, 128), (100, 64), (64, 96)):
        with pytest.raises(ValueError, match="N % 64 == 0 and K % 32 == 0"):
            TQM.check_gemm_shape("int8_matmul", N, K)


# ---------------------------------------------------------------- K3 / K7 / K8


def _cache(rng, lead, kvh, hd, S, packed):
    hdc = hd // 2 if packed else hd
    lo, hi, dt = (0, 256, np.uint8) if packed else (-127, 128, np.int8)
    scale = (0.05, 0.2) if packed else (0.005, 0.02)
    k_q = rng.integers(lo, hi, size=lead + (kvh, hdc, S)).astype(dt)
    v_q = rng.integers(lo, hi, size=lead + (kvh, hdc, S)).astype(dt)
    k_s = rng.uniform(*scale, size=lead + (S,)).astype(np.float32)
    v_s = rng.uniform(*scale, size=lead + (S,)).astype(np.float32)
    return k_q, k_s, v_q, v_s


def _rope(n, hd):
    inv_freq = 1.0 / (10000.0 ** (np.arange(0, hd, 2, dtype=np.float32) / hd))
    fr = inv_freq[:, None] * np.arange(n, dtype=np.float32)[None, :]
    return np.cos(fr).astype(np.float32), np.sin(fr).astype(np.float32)


def _fold(rng, b, kvh, hd, active, packed):
    lo, hi = (-8, 8) if packed else (-127, 128)
    kc, ks = _rope(100, hd)
    pos = rng.integers(0, 100, size=(b,))
    return (rng.integers(lo, hi, size=(b, kvh, hd)).astype(np.int8),
            rng.uniform(0.005, 0.02, size=(b, 1)).astype(np.float32),
            rng.integers(lo, hi, size=(b, kvh, hd)).astype(np.int8),
            rng.uniform(0.005, 0.02, size=(b, 1)).astype(np.float32),
            np.asarray(active, np.int32), kc[:, pos].T.copy(), ks[:, pos].T.copy())


@pytest.mark.parametrize("G,hd", NEW_DECODE_SHAPES)
@pytest.mark.parametrize("packed", [False, True])
def test_decode_attention_plain_matches_jax_at_the_new_shapes(G, hd, packed):
    """K3: ragged lengths, an empty slot with its pair folded in, slot 1
    inactive, RoPE from the hoisted tables."""
    rng = np.random.default_rng(G * hd + packed)
    b, kvh, S = 3, 2, 64
    q = rng.normal(size=(b, kvh * G, hd)).astype(np.float32)
    cache = _cache(rng, (b,), kvh, hd, S, packed)
    lengths = np.asarray([S // 2 + 3, S - 1, 0], np.int32)
    kc, ks = _rope(S, hd)
    fd = _fold(rng, b, kvh, hd, [1, 0, 1], packed)
    kw = dict(rope=True, packed=packed)
    want = JDA.quantized_decode_attention(_j(q), *(_j(a) for a in cache), _j(lengths), _j(kc),
                                          _j(ks), fold=tuple(_j(a) for a in fd), **kw)
    got = TDA.quantized_decode_attention(_t(q), *(_t(a) for a in cache), _t(lengths), _t(kc),
                                         _t(ks), fold=tuple(_t(a) for a in fd), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("G,hd", NEW_DECODE_SHAPES)
@pytest.mark.parametrize("packed", [False, True])
def test_paged_attention_plain_matches_jax_at_the_new_shapes(G, hd, packed):
    """K8: pages of 8, shuffled tables whose unused entries point far outside
    the pool; slots empty, on a page edge, mid-page and full; slot 3
    inactive."""
    rng = np.random.default_rng(7 + G * hd + packed)
    P, max_pages, kvh, n_pages = 8, 4, 2, 24
    lengths = np.asarray([0, 1, 2 * P, 2 * P + 3, max_pages * P], np.int32)
    b = len(lengths)
    q = rng.normal(size=(b, kvh * G, hd)).astype(np.float32)
    pool = _cache(rng, (n_pages,), kvh, hd, P, packed)
    ids = rng.permutation(n_pages)
    bt = np.full((b, max_pages), 10 ** 6, np.int32)
    at = 0
    for i, n in enumerate(lengths):
        live = -(-int(n) // P)
        bt[i, :live] = ids[at:at + live]
        at += live
    kc, ks = _rope(max_pages * P, hd)
    fd = _fold(rng, b, kvh, hd, [1, 1, 1, 0, 1], packed)
    kw = dict(rope=True, packed=packed)
    want = JDA.quantized_paged_attention(_j(q), *(_j(a) for a in pool), _j(lengths), _j(bt),
                                         _j(kc), _j(ks), fold=tuple(_j(a) for a in fd), **kw)
    got = TDA.quantized_paged_attention(_t(q), *(_t(a) for a in pool), _t(lengths), _t(bt),
                                        _t(kc), _t(ks), fold=tuple(_t(a) for a in fd), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("G,hd", NEW_DECODE_SHAPES)
def test_stacked_decode_attention_plain_matches_jax_at_the_new_shapes(G, hd):
    """K7 on layer 1 of a 3-layer stacked int8 cache: ragged lengths, an
    empty slot whose pair is included, a slot whose pair is excluded."""
    rng = np.random.default_rng(31 + G * hd)
    L, b, kvh, S = 3, 3, 2, 64
    q = rng.normal(size=(b, kvh * G, hd)).astype(np.float32)
    cache = _cache(rng, (L, b), kvh, hd, S, False)
    k_new = (rng.integers(-127, 128, (b, kvh, hd)) * 0.01).astype(np.float32)
    v_new = (rng.integers(-127, 128, (b, kvh, hd)) * 0.01).astype(np.float32)
    lengths, inc = np.asarray([35, 0, 63], np.int32), np.asarray([1, 1, 0], np.int32)
    kc, ks = _rope(S, hd)
    ops = (q, *cache, lengths, inc, k_new, v_new, kc, ks)
    want = JDA.quantized_decode_attention_stacked(*(_j(a) for a in ops), layer=1, rope=True)
    got = TDA.quantized_decode_attention_stacked(*(_t(a) for a in ops), layer=1, rope=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_decode_gate_takes_the_built_shapes_and_names_them():
    q = torch.zeros(1, 1, dtype=torch.bfloat16)
    for G, hd in TDA._SHAPES:
        TDA._check_kernel_shape("decode", q, G, hd, 8)
    assert set(NEW_DECODE_SHAPES) <= set(TDA._SHAPES)
    for G, hd in ((2, 64), (4, 64), (2, 128), (1, 16), (8, 32)):
        with pytest.raises(NotImplementedError, match=r"\(2, 16\), \(2, 32\), \(4, 128\)"):
            TDA._check_kernel_shape("decode", q, G, hd, 8)


# ---------------------------------------------------------------- K4 / K10 / K11


def _strict(fn, *args):
    """``fn(*args)`` jitted with XLA's excess precision off."""
    return jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": False})(*args)


def _assert_close(got, want, dt, what, rows):
    g, w = got.float().numpy(), np.array(jnp.asarray(want, jnp.float32))
    if dt == "f32":
        np.testing.assert_allclose(g, w, err_msg=what, **TOL)
        return
    step = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(w), 2.0 ** -126))) - 7)
    lim = 2 * step + 1e-2 * np.median(np.abs(w[rows]))
    assert np.isfinite(g).all() and (np.abs(g - w) <= lim).all(), (
        what, float((np.abs(g - w) / lim).max()))


@pytest.mark.parametrize("D,dt", [(16, "f32"), (16, "bf16"), (32, "f32"), (32, "bf16"),
                                  (128, "f32")])
def test_flash_plain_matches_jax_kernels_at_the_new_head_dims(D, dt):
    """The forward (O, log-sum-exp) and the dQ / dK / dV pair, causal, two
    query heads a kv head, lengths full, cut mid-block and 1."""
    jdt, tdt = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}[dt]
    B, G, S = 3, 2, 64
    lens = [S, 37, 1]
    rng = np.random.default_rng(D)
    q, k, v, do = (rng.normal(size=sh).astype(np.float32)
                   for sh in ((B, G, S, D), (B, S, D), (B, S, D), (B, G, S, D)))
    lengths = np.asarray(lens, np.int32)
    jq, jk, jv, jdo = (jnp.asarray(a, jdt) for a in (q, k, v, do))
    jo, jlse = _strict(lambda *a: JFA._flash_fwd(*a, 512, 1024, causal=True),
                       jq, jk, jv, jnp.asarray(lengths))
    want = _strict(lambda *a: JFA._flash_bwd(*a, 512, 1024, causal=True),
                   jq, jk, jv, jnp.asarray(lengths), jo, jlse, jdo)
    tq, tk, tv, tdo = (torch.from_numpy(a).to(tdt) for a in (q, k, v, do))
    to, tlse = TFA._flash_fwd(tq, tk, tv, torch.from_numpy(lengths))
    rows = [i for i, n in enumerate(lens) if n > 1]
    _assert_close(to, jo, dt, "o", rows)
    np.testing.assert_allclose(tlse.numpy(), np.asarray(jlse), rtol=1e-5, atol=1e-5)
    got = TFA._flash_bwd(tq, tk, tv, torch.from_numpy(lengths),
                         torch.from_numpy(np.array(jnp.asarray(jo, jnp.float32))).to(tdt),
                         torch.from_numpy(np.asarray(jlse)), tdo, True)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == tdt and tuple(g.shape) == tuple(w.shape)
        _assert_close(g, w, dt, name, rows)


def test_flash_gate_takes_every_built_head_dim_in_both_types_and_names_them():
    assert TFA.HEAD_DIMS == (16, 32, 64, 128)
    for D in TFA.HEAD_DIMS:
        for dt in (torch.float32, torch.bfloat16):
            t = torch.zeros(1, dtype=dt)
            TFA._check_built("flash_attention.cu", D, (t, t, t))
    f, b = torch.zeros(1), torch.zeros(1, dtype=torch.bfloat16)
    for D, ts in ((96, (b, b, b)), (8, (f, f, f)), (256, (b, b, b)), (64, (f, b, f)),
                  (32, (torch.zeros(1, dtype=torch.float16),) * 3)):
        with pytest.raises(NotImplementedError, match=r"head dims \(16, 32, 64, 128\)"):
            TFA._check_built("flash_attention.cu", D, ts)
    assert [TFA._entry("flash_fwd", D) for D in TFA.HEAD_DIMS] == [
        "flash_fwd_d16", "flash_fwd_d32", "flash_fwd", "flash_fwd_d128"]
