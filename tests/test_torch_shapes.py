"""The shapes the card's kernels were widened to, held on the CPU against the
JAX package: the plain versions that ``chip_smoke.py`` and the ``-m cuda``
tests hold each new kernel instantiation against, and the wrappers' gates.

* K1/K2 at K = 64 (the tiny models' hidden size) and 2752 (LLaMA-7B's down
  projection at tp = 4): no multiple of the kernels' 128-row stage. The plain
  versions against JAX's Pallas kernels in interpret mode, to the bit.
* K3, K7 and K8 at (query heads per kv head, head dim) = (2, 16), (2, 32),
  (4, 128), (8, 128), and (1, 4) x (100, 80) of the padded builds
  (``PAD_DECODE_SHAPES``), int8 and nibble-packed caches, at rtol / atol
  1e-5 (the tolerance of ``test_torch_decode_attention.py``).
* K4, K10 and K11 at head dims 16 and 32 (f32 and bf16), 128 (f32), and 100
  and 80 (f32 and bf16, causal and not; on the card the padded builds): f32 at
  1e-5, bf16 with the JAX side compiled without excess precision, held at 2
  bf16 steps + 1e-2 x the median (``test_torch_flash_backward.py``'s limit).
* The gates: what the kernels are built for passes, anything else raises and
  names the built set.
* The GQA head shapes of public checkpoints (1 to 8 query heads per kv head
  at head dims 64 and 128, ``GQA_SHAPES``): K3/K7/K8 as above, the
  whole-model decode step K9 (its plain version against JAX's
  ``megakernel.decode_step`` in interpret mode, W8KV8 "pre" and W4KV4
  packed: integers equal, scales rtol 1e-6, logits 1e-5, as
  ``test_torch_megakernel.py``), a greedy engine rollout at (3, 128) against
  the JAX serving loop (tokens equal), and the card routing: every public
  config that JAX's ``supported()`` sends to its megakernel is one the
  card's K9 and K3/K8 gates take (OpenLLaMA-3B's head dim 100 since the
  padded builds; Mistral-Large-2's 12 and Llama-3.1-405B's 16 query heads a
  kv head since the builds of G = 9..16, ``WIDE_PUBLIC``), and G = 17 is
  refused naming the rule. The G = 9..16 plain versions against JAX:
  ``tests/test_torch_wide_groups.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_qat_tpu.inference import megakernel as JMK
from llm_qat_tpu.models import config as JC
from llm_qat_tpu.ops.pallas import decode_attention as JDA
from llm_qat_tpu.ops.pallas import flash_attention as JFA
from llm_qat_tpu.ops.pallas import quant_matmul as JQM
from llm_qat_torch.inference import engine as TE
from llm_qat_torch.inference import megakernel as TMK
from llm_qat_torch.ops import decode_attention as TDA
from llm_qat_torch.ops import flash_attention as TFA
from llm_qat_torch.ops import quant_matmul as TQM

from tests.test_torch_megakernel import BASE as MK_BASE
from tests.test_torch_megakernel import assert_step_equal, both_steps
from tests.test_torch_serving import _jax_greedy, both_qparams, tcfg

TOL = dict(rtol=1e-5, atol=1e-5)
NEW_DECODE_SHAPES = [(2, 16), (2, 32), (4, 128), (8, 128)]
# (query heads per kv head, head dim) of public GQA checkpoints: Llama-3.2-1B's
# (4, 64), Llama-3.2-3B's (3, 128), Llama-3-8B's and Mistral-7B's (4, 128),
# Yi-34B's (7, 128), Llama-2-70B's (8, 128), and MHA at head dim 64
GQA_SHAPES = [(1, 64), (3, 128), (4, 64), (4, 128), (7, 128), (8, 128)]
# head dims off the power-of-two set through the padded builds: OpenLLaMA-3B's
# 100 and 80, one and four query heads a kv head
PAD_DECODE_SHAPES = [(1, 100), (4, 100), (1, 80), (4, 80)]
DECODE_SHAPES = (NEW_DECODE_SHAPES + [s for s in GQA_SHAPES if s not in NEW_DECODE_SHAPES]
                 + PAD_DECODE_SHAPES)


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


@pytest.mark.parametrize("G,hd", DECODE_SHAPES)
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


@pytest.mark.parametrize("G,hd", DECODE_SHAPES)
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


@pytest.mark.parametrize("G,hd", DECODE_SHAPES)
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
    """Every G of 1..16 at head dims 16, 32, 64 and 128 passes, and at the
    padded build's head dims (hd % 4 == 0, 32 < hd <= 128: 96 and 100
    here), and G = 1..4 at head dim 256; past that the gate raises and names
    the rule."""
    q = torch.zeros(1, 1, dtype=torch.bfloat16)
    for G, hd in TDA._SHAPES + ((2, 96), (8, 100), (16, 100)):
        TDA._check_kernel_shape("decode", q, G, hd, 8)
    assert set(NEW_DECODE_SHAPES) <= set(TDA._SHAPES)
    assert set(TDA._SHAPES) == ({(g, hd) for g in range(1, 17) for hd in (16, 32, 64, 128)}
                                | {(g, 256) for g in range(1, 5)})
    for G, hd in ((17, 64), (17, 128), (2, 98), (1, 8), (5, 256), (0, 64), (17, 100)):
        with pytest.raises(NotImplementedError,
                           match=r"1 <= G <= 16 query heads per kv head at head dims "
                                 r"\(16, 32, 64, 128\)"):
            TDA._check_kernel_shape("decode", q, G, hd, 8)


# ---------------------------------------------------------------- K9 and routing at the GQA shapes

GQA_MODES = {"w8kv8_pre": dict(w_bits=8, kv_bits=8, kv_cache_pack=False),
             "w4kv4_packed": dict(w_bits=4, kv_bits=4, kv_cache_pack=True)}


def gqa_cfg(G, hd, **kw):
    """The tiny test model (2 layers) with G query heads per kv head at head
    dim ``hd``: 1 kv head at 128, 2 at 64."""
    kvh = 1 if hd == 128 else 2
    return MK_BASE.replace(hidden_size=kvh * G * hd, intermediate_size=256,
                           num_attention_heads=kvh * G, num_key_value_heads=kvh, **kw)


@pytest.mark.parametrize("G,hd", GQA_SHAPES)
@pytest.mark.parametrize("mode", list(GQA_MODES))
def test_decode_step_matches_jax_at_every_gqa_shape(G, hd, mode):
    """K9's plain version through the port's decode step against JAX's
    decode_step (its Pallas kernel in interpret mode): an active slot, an
    empty active slot, an inactive slot."""
    cfg = gqa_cfg(G, hd, **GQA_MODES[mode])
    assert cfg.head_dim == hd and cfg.num_attention_heads // cfg.kv_heads == G
    assert JMK.supported(cfg, 3, 32) and TMK.supported(tcfg(cfg), 3, 32)
    tl, tc, jl, jc, _ = both_steps(cfg, [5, 0, 11], [True, True, False])
    assert_step_equal(tl, tc, jl, jc, rows=[0, 1])


@pytest.mark.parametrize("use_megakernel", [True, False])
def test_engine_greedy_matches_jax_at_three_heads_of_128(use_megakernel):
    """Llama-3.2-3B's (3, 128) heads: 3 requests through a 2-slot engine on
    the default path (K9's plain version) and on the scan path (K3's) give
    the JAX serving loop's greedy tokens."""
    cfg = gqa_cfg(3, 128, w_bits=8, kv_bits=8, use_megakernel=use_megakernel)
    jq, tq = both_qparams(cfg)
    rng = np.random.default_rng(6)
    prompts = [list(map(int, rng.integers(1, cfg.vocab_size, n))) for n in (3, 9, 20)]
    eng = TE.InferenceEngine(tq, tcfg(cfg), max_batch=2, max_len=64, steps_per_sync=4,
                             dtype=torch.float32, device="cpu")
    uids = [eng.submit(p, max_new_tokens=5) for p in prompts]
    done = {r.uid: r.output for r in eng.run()}
    for uid, p in zip(uids, prompts):
        assert done[uid] == _jax_greedy(jq, cfg, p, 5), (uid, p)


# Public config.json widths: (hidden, intermediate, heads, kv heads), each
# loadable through LlamaConfig.from_json in both packages
PUBLIC_GQA = {
    "Meta-Llama-3-8B": (4096, 14336, 32, 8),
    "Mistral-7B-v0.1": (4096, 14336, 32, 8),
    "SOLAR-10.7B": (4096, 14336, 32, 8),
    "Llama-2-70B": (8192, 28672, 64, 8),
    "Meta-Llama-3-70B": (8192, 28672, 64, 8),
    "Yi-6B": (4096, 11008, 32, 4),
    "Llama-3.2-1B": (2048, 8192, 32, 8),
    "Llama-3.2-3B": (3072, 8192, 24, 8),
    "Yi-34B": (7168, 20480, 56, 8),
    "llama-68m": (768, 3072, 12, 12),
    "TinyLlama-1.1B": (2048, 5632, 32, 4),
    "LLaMA-7B": (4096, 11008, 32, 32),
    "LLaMA-13B": (5120, 13824, 40, 40),
    "open_llama_3b": (3200, 8640, 32, 32),
    "Falcon3-7B": (3072, 23040, 12, 4),
    "Falcon3-1B": (2048, 8192, 8, 4),
}


# the GQA rows whose K9 routing the card must take at b = 8, S = 1024 and 2048
CARD_MUST_TAKE = ("Meta-Llama-3-8B", "Llama-2-70B", "Llama-3.2-1B", "Llama-3.2-3B", "Yi-34B",
                  "Mistral-7B-v0.1", "SOLAR-10.7B", "Meta-Llama-3-70B", "Yi-6B", "llama-68m",
                  "open_llama_3b", "Falcon3-7B", "Falcon3-1B")


@pytest.mark.parametrize("name", list(PUBLIC_GQA))
@pytest.mark.parametrize("w_bits,kv_bits", [(8, 8), (4, 4)])
def test_card_routing_takes_every_public_gqa_shape(name, w_bits, kv_bits):
    """At b = 8 and S = 1024, 2048: wherever JAX's megakernel.supported()
    is True (for every GQA row, ``CARD_MUST_TAKE``), the card's K9 takes the
    config (card_takes) at JAX's KV block and K3/K8's gates take its
    (G, hd)."""
    H, I, nh, kvh = PUBLIC_GQA[name]
    jcfg = JC.LlamaConfig(hidden_size=H, intermediate_size=I, num_attention_heads=nh,
                          num_key_value_heads=kvh, w_bits=w_bits, a_bits=8, kv_bits=kv_bits,
                          kv_cache_pack=kv_bits == 4)
    cfg = tcfg(jcfg)
    G, hd = nh // kvh, H // nh
    q = torch.zeros(1, 1, dtype=torch.bfloat16)
    for S in (1024, 2048):
        if not JMK.supported(jcfg, 8, S):        # JAX serves it on its scan path
            assert name not in CARD_MUST_TAKE
            continue
        assert TMK.pick_bk(cfg, 8, S) == JMK._pick_nc_bk(jcfg, 8, S)[1]
        assert TMK.card_takes(cfg, 8, S, torch.bfloat16), (
            name, S, TMK._card_shape_error(cfg, 8, S, TMK.pick_bk(cfg, 8, S), torch.bfloat16))
        TDA._check_contiguous_kernel_shape("decode", q, G, hd, S, 8)
        TDA._check_kernel_shape("paged", q, G, hd, 8)


def test_jax_kv_blocks_at_llama3_8b_and_llama2_70b():
    """(nc, bk, kh) of JAX's picker at W8, b = 8, S = 1024: the block K9 walks."""
    for name, want in (("Meta-Llama-3-8B", (256, 128, 4)), ("Llama-2-70B", (128, 128, 2))):
        H, I, nh, kvh = PUBLIC_GQA[name]
        jcfg = JC.LlamaConfig(hidden_size=H, intermediate_size=I, num_attention_heads=nh,
                              num_key_value_heads=kvh, w_bits=8, a_bits=8, kv_bits=8)
        assert JMK._pick_nc_bk(jcfg, 8, 1024) == want
        assert TMK.pick_bk(tcfg(jcfg), 8, 1024) == want[1]


K9_RULE = ("1 <= G <= 16 query heads per kv head at head dims 64 and 128 and every "
           "hd % 4 == 0 with 32 < hd <= 128")


@pytest.mark.parametrize("G,hd", [(9, 128), (16, 64), (4, 96), (2, 32), (4, 136), (2, 98)])
def test_card_routing_refuses_shapes_outside_the_rule_and_names_it(G, hd):
    """hd = 32, 98 and 136: K9 refuses and names its rule (the step then
    takes the scan path); hd = 32 is K3/K8's but not K9's; K3/K8 refuse hd
    98 and 136, naming theirs. hd = 96 is inside the rule since the padded
    builds, and G = 9 and 16 since the builds of G = 9..16: K9 and K3/K8
    take them."""
    kvh = 8
    cfg = tcfg(JC.LlamaConfig(hidden_size=kvh * G * hd, intermediate_size=4096,
                              num_attention_heads=kvh * G, num_key_value_heads=kvh,
                              w_bits=8, a_bits=8, kv_bits=8))
    assert cfg.head_dim == hd
    assert TMK.supported(cfg, 8, 2048)
    q = torch.zeros(1, 1, dtype=torch.bfloat16)
    if (G, hd) in ((4, 96), (9, 128), (16, 64)):
        assert TMK.card_takes(cfg, 8, 2048, torch.bfloat16)
        assert TMK.padded(hd) == (hd == 96)
        TDA._check_kernel_shape("decode", q, G, hd, 8)
        return
    assert not TMK.card_takes(cfg, 8, 2048, torch.bfloat16)
    why = TMK._card_shape_error(cfg, 8, 2048, TMK.pick_bk(cfg, 8, 2048), torch.bfloat16)
    assert K9_RULE in why
    if (G, hd) in TDA._SHAPES:
        TDA._check_kernel_shape("decode", q, G, hd, 8)
    else:
        with pytest.raises(NotImplementedError, match=r"1 <= G <= 16 .* \(16, 32, 64, 128\) "
                                                      r"and every hd % 4 == 0"):
            TDA._check_kernel_shape("decode", q, G, hd, 8)


# public checkpoints past 8 query heads a kv head, which the card took only
# from the builds of G = 9..16 on (JAX's kernels take any G): (hidden,
# intermediate, heads, kv heads)
WIDE_PUBLIC = {"Mistral-Large-2": (12288, 28672, 96, 8),
               "Llama-3.1-405B": (16384, 53248, 128, 8),
               "Llama-3.1-405B tp=8 shard": (2048, 6656, 16, 1)}


def test_card_names_the_public_shapes_it_still_refuses_where_jax_takes_them():
    """Past 8 query heads a kv head the card takes what JAX takes:
    Mistral-Large-2 (G = 12), Llama-3.1-405B (G = 16) and its tp = 8 shard
    (16 query heads over one kv head of 128). At W4A8KV4 and W8A8KV8, b = 1
    and 8, max_len 1024 and 2048, the card's K9 takes the config
    (``card_takes``) wherever JAX's ``supported()`` sends it to its
    megakernel, at JAX's KV block (Mistral-Large-2: W4 at b = 1 and 8, W8 at
    b = 1; Llama-3.1-405B: W4 at b = 1), and K3/K8's gates take its G. Where
    only JAX's TPU scratch budget refuses (Mistral-Large-2 W8 and
    Llama-3.1-405B W4 at b = 8) the card takes it too: the port's
    ``supported()`` has no such budget (as at LLaMA-7B's b = 32). JAX's
    decode attention kernel at the shard's (16, 128) on a 32-column cache,
    beside the port's plain version."""
    q = torch.zeros(1, 1, dtype=torch.bfloat16)
    taken = set()
    for name, (H, I, nh, kvh) in WIDE_PUBLIC.items():
        G, hd = nh // kvh, H // nh
        assert hd == 128 and G > 8
        TDA._check_kernel_shape("decode", q, G, hd, 8)
        TDA._check_kernel_shape("paged", q, G, hd, 8)
        for w in (4, 8):
            jcfg = JC.LlamaConfig(hidden_size=H, intermediate_size=I, num_attention_heads=nh,
                                  num_key_value_heads=kvh, w_bits=w, a_bits=8, kv_bits=w,
                                  kv_cache_pack=w == 4)
            cfg = tcfg(jcfg)
            for b in (1, 8):
                for S in (1024, 2048):
                    jax_takes = JMK.supported(jcfg, b, S)
                    card = TMK.card_takes(cfg, b, S, torch.bfloat16)
                    assert card == TMK.supported(cfg, b, S) and card >= jax_takes, (name, w, b, S)
                    if jax_takes:
                        taken.add((name, w, b))
                        assert TMK.pick_bk(cfg, b, S) == JMK._pick_nc_bk(jcfg, b, S)[1]
    assert {("Mistral-Large-2", 4, 1), ("Mistral-Large-2", 4, 8), ("Mistral-Large-2", 8, 1),
            ("Llama-3.1-405B", 4, 1)} <= taken
    assert not {("Mistral-Large-2", 8, 8), ("Llama-3.1-405B", 4, 8)} & taken
    # JAX's kernel at the shard's (16, 128), a 32-column cache, and the port's
    rng = np.random.default_rng(405)
    b, kvh, S = 2, 1, 32
    qj = rng.normal(size=(b, 16, 128)).astype(np.float32)
    cache = _cache(rng, (b,), kvh, 128, S, False)
    kc, ks = _rope(S, 128)
    lengths = np.asarray([S, 5], np.int32)
    got = JDA.quantized_decode_attention(_j(qj), *(_j(a) for a in cache), _j(lengths), _j(kc),
                                         _j(ks))
    assert np.isfinite(np.asarray(got)).all() and got.shape == (b, 16, 128)
    mine = TDA.quantized_decode_attention(_t(qj), *(_t(a) for a in cache), _t(lengths), _t(kc),
                                          _t(ks))
    np.testing.assert_allclose(mine.numpy(), np.asarray(got), **TOL)


@pytest.mark.parametrize("G,hd", [(17, 128), (17, 64), (24, 128)])
def test_card_refuses_more_than_16_heads_a_kv_head_and_names_the_rule(G, hd):
    """G = 17 and 24: K9 refuses naming its rule (the step then takes the
    scan path) and K3/K8 refuse naming theirs; no repo or named public
    config has G > 16 (ROADMAP section 2 A)."""
    kvh = 2
    cfg = tcfg(JC.LlamaConfig(hidden_size=kvh * G * hd, intermediate_size=4096,
                              num_attention_heads=kvh * G, num_key_value_heads=kvh,
                              w_bits=8, a_bits=8, kv_bits=8))
    assert cfg.head_dim == hd and TMK.supported(cfg, 1, 2048)
    assert not TMK.card_takes(cfg, 1, 2048, torch.bfloat16)
    assert K9_RULE in TMK._card_shape_error(cfg, 1, 2048, TMK.pick_bk(cfg, 1, 2048),
                                            torch.bfloat16)
    q = torch.zeros(1, 1, dtype=torch.bfloat16)
    for what in ("decode", "paged"):
        with pytest.raises(NotImplementedError, match=r"1 <= G <= 16 query heads per kv head"):
            TDA._check_kernel_shape(what, q, G, hd, 8)


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


@pytest.mark.parametrize("D,dt,causal", [
    *(pytest.param(D, dt, True, id=f"{D}-{dt}")
      for D, dt in ((16, "f32"), (16, "bf16"), (32, "f32"), (32, "bf16"), (128, "f32"),
                    (100, "f32"), (100, "bf16"), (80, "f32"), (80, "bf16"))),
    # the ring's backward (parallel/ring_attention.py) at the padded head dims
    *(pytest.param(D, dt, False, id=f"{D}-{dt}-noncausal")
      for D in (100, 80) for dt in ("f32", "bf16"))])
def test_flash_plain_matches_jax_kernels_at_the_new_head_dims(D, dt, causal):
    """The forward (O, log-sum-exp) and the dQ / dK / dV pair, causal or not,
    two query heads a kv head, lengths full, cut mid-block and 1."""
    jdt, tdt = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}[dt]
    B, G, S = 3, 2, 64
    lens = [S, 37, 1]
    rng = np.random.default_rng(D)
    q, k, v, do = (rng.normal(size=sh).astype(np.float32)
                   for sh in ((B, G, S, D), (B, S, D), (B, S, D), (B, G, S, D)))
    lengths = np.asarray(lens, np.int32)
    jq, jk, jv, jdo = (jnp.asarray(a, jdt) for a in (q, k, v, do))
    jo, jlse = _strict(lambda *a: JFA._flash_fwd(*a, 512, 1024, causal=causal),
                       jq, jk, jv, jnp.asarray(lengths))
    want = _strict(lambda *a: JFA._flash_bwd(*a, 512, 1024, causal=causal),
                   jq, jk, jv, jnp.asarray(lengths), jo, jlse, jdo)
    tq, tk, tv, tdo = (torch.from_numpy(a).to(tdt) for a in (q, k, v, do))
    to, tlse = TFA._flash_fwd(tq, tk, tv, torch.from_numpy(lengths), causal)
    rows = [i for i, n in enumerate(lens) if n > 1]
    _assert_close(to, jo, dt, "o", rows)
    np.testing.assert_allclose(tlse.numpy(), np.asarray(jlse), rtol=1e-5, atol=1e-5)
    got = TFA._flash_bwd(tq, tk, tv, torch.from_numpy(lengths),
                         torch.from_numpy(np.array(jnp.asarray(jo, jnp.float32))).to(tdt),
                         torch.from_numpy(np.asarray(jlse)), tdo, causal)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == tdt and tuple(g.shape) == tuple(w.shape)
        _assert_close(g, w, dt, name, rows)


def test_flash_gate_takes_every_built_head_dim_in_both_types_and_names_them():
    """The forward and backward take head dims 16, 32, 64 and 128 and the
    padded builds' (96 here), the forward 256 too; anything else raises
    naming the built set, the backward too."""
    assert TFA.HEAD_DIMS == (16, 32, 64, 128)
    for D in TFA.HEAD_DIMS:
        for dt in (torch.float32, torch.bfloat16):
            t = torch.zeros(1, dtype=dt)
            TFA._check_built("flash_attention.cu", D, (t, t, t))
            TFA._check_built("flash_attention_bwd.cu", D, (t, t, t, t))
    f, b = torch.zeros(1), torch.zeros(1, dtype=torch.bfloat16)
    TFA._check_built("flash_attention.cu", 96, (b, b, b))
    TFA._check_built("flash_attention_bwd.cu", 96, (b, b, b, b))
    TFA._check_built("flash_attention_bwd.cu", 96, (f, f, f, f))
    TFA._check_built("flash_attention.cu", 256, (b, b, b))
    TFA._check_built("flash_attention.cu", 256, (f, f, f))
    with pytest.raises(NotImplementedError, match=r"head dims \(16, 32, 64, 128\) and every hd "
                                                  r"% 4 == 0 with 32 < hd <= 128 in f32 or bf16"):
        TFA._check_built("flash_attention_bwd.cu", 98, (b, b, b, b))
    for D, ts in ((98, (b, b, b)), (8, (f, f, f)), (512, (b, b, b)), (64, (f, b, f)),
                  (32, (torch.zeros(1, dtype=torch.float16),) * 3)):
        with pytest.raises(NotImplementedError, match=r"head dims \(16, 32, 64, 128\)"):
            TFA._check_built("flash_attention.cu", D, ts)
    assert [TFA._entry("flash_fwd", D) for D in TFA.HEAD_DIMS] == [
        "flash_fwd_d16", "flash_fwd_d32", "flash_fwd", "flash_fwd_d128"]
