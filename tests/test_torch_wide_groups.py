"""More than 8 query heads a kv head (G = 9..16), held on the CPU against the
JAX package: the plain versions that ``chip_smoke.py`` and the ``-m cuda``
tests hold the card's builds of G = 9..15 and 16 against, the serving paths
that route to them, and the RoPE tables those paths share.

* K3, K7 and K8 at (G, hd) = (9, 64), (12, 128), (16, 128) and (12, 100)
  (Mistral-Large-2's 12 and Llama-3.1-405B's 16 heads of 128; 100 through
  the padded build on the card), int8 and nibble-packed caches (K7: int8),
  one and two kv heads, ragged lengths, an inactive slot, the current
  token's pair folded in: at rtol / atol 1e-5, the tolerance of the G <= 8
  cases (``tests/test_torch_shapes.py``).
* K9's plain version through the port's decode step against JAX's
  ``megakernel.decode_step`` (its Pallas kernel in interpret mode) on a
  2-layer model at G = 12 and 16, head dim 16, two kv heads, W8KV8 "pre"
  and W4KV4 packed, b = 2 (one slot inactive): integers equal, scales rtol
  1e-6, logits 1e-5 (``tests/test_torch_megakernel.py``). JAX batches the
  softmax over a kv head's G rows at G = 16 and runs it a head at a time at
  G = 12 (``llm_qat_tpu/inference/megakernel.py`` ``batched``); the two
  orders compute the same per-head values, which the port's plain version
  takes in float64.
* ``InferenceEngine`` at G = 12 on the default path (K9's plain version)
  and the scan path (K3's) against JAX's engine: the same greedy tokens.
* ``llama.rope_cos_sin``: the f32 angle, its cos / sin in float64 rounded
  once, nearer XLA's f32 tables than torch's f32 cos / sin.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_qat_tpu.inference import engine as JE
from llm_qat_tpu.inference import megakernel as JMK
from llm_qat_tpu.models import llama as JL
from llm_qat_tpu.ops.pallas import decode_attention as JDA
from llm_qat_torch.inference import engine as TE
from llm_qat_torch.inference import megakernel as TMK
from llm_qat_torch.models import llama as TL
from llm_qat_torch.ops import decode_attention as TDA

from tests.test_torch_megakernel import BASE as MK_BASE
from tests.test_torch_megakernel import assert_step_equal, both_steps
from tests.test_torch_serving import both_qparams, tcfg
from tests.test_torch_shapes import TOL, _cache, _fold, _j, _rope, _t

WIDE_SHAPES = [(9, 64), (12, 128), (16, 128), (12, 100)]


def _lengths(b, S):
    return np.asarray([S // 2 + 3, S - 1, 0, 17][:b], np.int32)


@pytest.mark.parametrize("G,hd", WIDE_SHAPES)
@pytest.mark.parametrize("kvh", [1, 2])
@pytest.mark.parametrize("packed", [False, True])
def test_decode_attention_plain_matches_jax_past_8_heads(G, hd, kvh, packed):
    """K3: ragged lengths, an empty slot with its pair folded in, slot 1
    inactive, RoPE from the hoisted tables."""
    rng = np.random.default_rng(1000 + G * hd + 2 * kvh + packed)
    b, S = 4, 64
    q = rng.normal(size=(b, kvh * G, hd)).astype(np.float32)
    cache = _cache(rng, (b,), kvh, hd, S, packed)
    lengths = _lengths(b, S)
    kc, ks = _rope(S, hd)
    fd = _fold(rng, b, kvh, hd, [1, 0, 1, 1], packed)
    kw = dict(rope=True, packed=packed)
    want = JDA.quantized_decode_attention(_j(q), *(_j(a) for a in cache), _j(lengths), _j(kc),
                                          _j(ks), fold=tuple(_j(a) for a in fd), **kw)
    got = TDA.quantized_decode_attention(_t(q), *(_t(a) for a in cache), _t(lengths), _t(kc),
                                         _t(ks), fold=tuple(_t(a) for a in fd), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("G,hd", WIDE_SHAPES)
@pytest.mark.parametrize("kvh", [1, 2])
@pytest.mark.parametrize("packed", [False, True])
def test_paged_attention_plain_matches_jax_past_8_heads(G, hd, kvh, packed):
    """K8: pages of 8, shuffled tables whose unused entries point far outside
    the pool; slots empty, on a page edge, mid-page and full; slot 3
    inactive."""
    rng = np.random.default_rng(2000 + G * hd + 2 * kvh + packed)
    P, max_pages, n_pages = 8, 4, 24
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


@pytest.mark.parametrize("G,hd", WIDE_SHAPES)
@pytest.mark.parametrize("kvh", [1, 2])
def test_stacked_decode_attention_plain_matches_jax_past_8_heads(G, hd, kvh):
    """K7 on layer 1 of a 3-layer stacked int8 cache: ragged lengths, an
    empty slot whose pair is included, a slot whose pair is excluded."""
    rng = np.random.default_rng(3000 + G * hd + kvh)
    L, b, S = 3, 3, 64
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


def test_wide_gates_take_9_to_16_heads_and_name_the_rule_past_them():
    """K3/K7/K8 take G = 9..16 at every head dim they take (each in the
    build ``_build_range`` names: 9..15 or 16) and refuse G = 17 naming the
    rule; K9 takes 9..16 at head dims 64 and 128 and the padded rule."""
    q = torch.zeros(1, 1, dtype=torch.bfloat16)
    for hd in TDA._HEAD_DIMS + (100, 48):
        for G in range(9, 17):
            TDA._check_kernel_shape("decode", q, G, hd, 8)
            assert TDA._build_range(G) == ((16, 16) if G == 16 else (9, 15))
        with pytest.raises(NotImplementedError, match=r"1 <= G <= 16 query heads per kv head"):
            TDA._check_kernel_shape("decode", q, 17, hd, 8)
    for G, hd, stem in ((12, 128, "megakernel_d128_g16"), (16, 64, "megakernel_g16"),
                        (9, 100, "megakernel_dpad_g16"), (8, 128, "megakernel_d128"),
                        (1, 100, "megakernel_dpad")):
        assert TMK._stem(hd, G) == stem


def _wide_cfg(G, **kw):
    """The tiny test model (2 layers) with G query heads over 2 kv heads of
    16."""
    return MK_BASE.replace(hidden_size=2 * G * 16, intermediate_size=128,
                           num_attention_heads=2 * G, num_key_value_heads=2, **kw)


WIDE_MODES = {"w8kv8_pre": dict(w_bits=8, kv_bits=8, kv_cache_pack=False),
              "w4kv4_packed": dict(w_bits=4, kv_bits=4, kv_cache_pack=True)}


@pytest.mark.parametrize("G", [12, 16])
@pytest.mark.parametrize("mode", list(WIDE_MODES))
def test_decode_step_matches_jax_past_8_heads(G, mode):
    """K9's plain version through the port's decode step against JAX's
    decode_step (its Pallas kernel in interpret mode, batched softmax at
    G = 16 and per head at 12): an active slot and an inactive one."""
    cfg = _wide_cfg(G, **WIDE_MODES[mode])
    assert cfg.head_dim == 16 and cfg.num_attention_heads // cfg.kv_heads == G
    assert JMK.supported(cfg, 2, 32) and TMK.supported(tcfg(cfg), 2, 32)
    tl, tc, jl, jc, _ = both_steps(cfg, [9, 5], [True, False])
    assert_step_equal(tl, tc, jl, jc, rows=[0])


@pytest.mark.parametrize("use_megakernel", [True, False])
def test_engine_greedy_matches_jax_engine_at_12_heads_a_kv_head(use_megakernel):
    """3 requests through a 2-slot engine at G = 12 on the default path (K9's
    plain version; JAX's megakernel in interpret mode) and on the scan path
    (K3's): the JAX engine's greedy tokens."""
    cfg = _wide_cfg(12, w_bits=8, kv_bits=8, use_megakernel=use_megakernel)
    jq, tq = both_qparams(cfg)
    rng = np.random.default_rng(12)
    prompts = [list(map(int, rng.integers(1, cfg.vocab_size, n))) for n in (3, 9, 20)]
    kw = dict(max_batch=2, max_len=64, steps_per_sync=4)
    jeng = JE.InferenceEngine(jq, cfg, dtype=jnp.float32, **kw)
    teng = TE.InferenceEngine(tq, tcfg(cfg), dtype=torch.float32, device="cpu", **kw)
    ju = [jeng.submit(p, max_new_tokens=5) for p in prompts]
    tu = [teng.submit(p, max_new_tokens=5) for p in prompts]
    jdone = {r.uid: r.output for r in jeng.run()}
    tdone = {r.uid: r.output for r in teng.run()}
    for j, t, p in zip(ju, tu, prompts):
        assert tdone[t] == jdone[j], (p, tdone[t], jdone[j])


def test_rope_tables_round_cos_and_sin_once_from_float64():
    """The port's cos / sin are those of the f32 angle taken in float64 and
    rounded once (so the card and the CPU give the same bits), and at head
    dim 64 over 2048 positions at least 3x nearer XLA's f32 tables than
    torch's f32 cos / sin (1482 against 6848 differing cos values of 131072,
    1896 against 6312 sin values, on the suite's CPU host)."""
    hd, pos = 64, np.arange(2048, dtype=np.int32)[None, :]
    jc, js = (np.asarray(t) for t in JL.rope_cos_sin(jnp.asarray(pos), hd, 10000.0))
    tc, ts = TL.rope_cos_sin(torch.from_numpy(pos), hd, 10000.0)
    e = torch.arange(0, hd, 2, dtype=torch.float32) / hd
    inv_freq = 1.0 / (10000.0 ** e.double()).float()
    ang = torch.from_numpy(pos).float()[..., None] * inv_freq
    ang = torch.cat([ang, ang], dim=-1)
    assert torch.equal(tc, torch.cos(ang.double()).float())
    assert torch.equal(ts, torch.sin(ang.double()).float())
    for got, f32, want in ((tc, torch.cos(ang), jc), (ts, torch.sin(ang), js)):
        n_port = int((got.numpy() != want).sum())
        n_f32 = int((f32.numpy() != want).sum())
        assert 3 * n_port <= n_f32, (n_port, n_f32)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2.0 ** -23)
