"""Head dim 256 (the Falcon3 family's, ``tiiuae/Falcon3-1B/3B/7B/10B-Base``),
held on the CPU against the JAX package: the plain versions that the card's
hd-256 builds (``decode_attention_d256.cu``, ``megakernel_d256.cu``, K4's
``flash_fwd_d256``) are held against in ``chip_smoke.py`` and the ``-m cuda``
tests, and the routing and gates at that head dim.

* K9's plain decode step against JAX's ``megakernel.decode_step`` (its Pallas
  kernel in interpret mode) in the three ``K9_MODES``, at (2, 2) and (3, 1)
  (query heads, kv heads) of 256: integers equal, scales rtol 1e-6, logits
  1e-4 (``test_torch_megakernel.py``).
* K3, K7 and K8 at (G, 256), G = 1..4, int8 and nibble-packed caches, at
  rtol / atol 1e-5 (``test_torch_shapes.py``'s cases at the other shapes).
* K4's plain version at D = 256, f32 at 1e-5 and bf16 (JAX compiled without
  excess precision) at 2 bf16 steps + 1e-2 x the median, causal and not.
* Whole serving at H = 768 (three query heads over one kv head of 256):
  prefill and decode logits at every step and the committed cache against
  JAX's ``serving_forward``; the engine's greedy tokens on the default and
  the scan path against the JAX serving loop, by the tie rule of
  ``test_torch_head_dims.py`` (``FLIP_LEAD``, ``FLIP_DRIFT``).
* Routing at Falcon3-7B's and Falcon3-1B's published widths: the card's K9
  takes the config exactly where the port's and JAX's ``supported()`` do,
  at JAX's KV block; the gates that still refuse name their rule (K10/K11 at
  256, K3/K8 past 4 query heads a kv head at 256, K9 past 8, hd 264, 512).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_qat_tpu.inference import megakernel as JMK
from llm_qat_tpu.inference import model as JM
from llm_qat_tpu.models import config as JC
from llm_qat_tpu.ops.pallas import decode_attention as JDA
from llm_qat_tpu.ops.pallas import flash_attention as JFA
from llm_qat_torch.inference import engine as TE
from llm_qat_torch.inference import megakernel as TMK
from llm_qat_torch.inference import model as TM
from llm_qat_torch.ops import decode_attention as TDA
from llm_qat_torch.ops import flash_attention as TFA

from tests.test_torch_head_dims import FLIP_DRIFT, FLIP_LEAD, K9_MODES, _forced_logits, hd_cfg
from tests.test_torch_megakernel import assert_step_equal, both_steps
from tests.test_torch_serving import (LOGIT_TOL, _jax_greedy, assert_cache_equal, both_qparams,
                                      tcfg)
from tests.test_torch_shapes import TOL, _cache, _fold, _j, _rope, _strict, _t

HD = 256
# Falcon3-7B-Base's and Falcon3-1B-Base's published config.json: hidden,
# intermediate, heads, kv heads, layers, vocabulary (head_dim 256 in both,
# which LlamaConfig derives as hidden / heads)
FALCON3 = {"Falcon3-7B": (3072, 23040, 12, 4, 28, 131072),
           "Falcon3-1B": (2048, 8192, 8, 4, 18, 131072)}


# ---------------------------------------------------------------- K9


@pytest.mark.parametrize("nh,kvh", [(2, 2), (3, 1)])
@pytest.mark.parametrize("mode", list(K9_MODES))
def test_decode_step_matches_jax(nh, kvh, mode):
    """K9's plain version through the port's decode step against JAX's
    decode_step: an active slot, an empty active slot, an inactive slot."""
    cfg = hd_cfg(HD, nh, kvh, **K9_MODES[mode])
    assert cfg.head_dim == HD
    assert JMK.supported(cfg, 3, 32) and TMK.supported(tcfg(cfg), 3, 32)
    tl, tc, jl, jc, _ = both_steps(cfg, [5, 0, 11], [True, True, False])
    assert_step_equal(tl, tc, jl, jc, rows=[0, 1])


# ---------------------------------------------------------------- K3 / K7 / K8

D256_SHAPES = [(g, HD) for g in range(1, TDA._HD256_MAX_GROUPS + 1)]


@pytest.mark.parametrize("G,hd", D256_SHAPES)
@pytest.mark.parametrize("packed", [False, True])
def test_decode_and_paged_attention_plain_match_jax(G, hd, packed):
    """K3: ragged lengths, an empty slot with its pair folded in, slot 1
    inactive; K8: pages of 8, shuffled tables whose unused entries point far
    outside the pool, slots empty, on a page edge, mid-page and full."""
    rng = np.random.default_rng(G * hd + packed)
    b, kvh, S = 3, 2, 32
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

    P, max_pages, n_pages = 8, 4, 16
    lengths = np.asarray([0, P, 2 * P + 3, max_pages * P], np.int32)
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
    fd = _fold(rng, b, kvh, hd, [1, 1, 0, 1], packed)
    want = JDA.quantized_paged_attention(_j(q), *(_j(a) for a in pool), _j(lengths), _j(bt),
                                         _j(kc), _j(ks), fold=tuple(_j(a) for a in fd), **kw)
    got = TDA.quantized_paged_attention(_t(q), *(_t(a) for a in pool), _t(lengths), _t(bt),
                                        _t(kc), _t(ks), fold=tuple(_t(a) for a in fd), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("G,hd", D256_SHAPES)
def test_stacked_decode_attention_plain_matches_jax(G, hd):
    """K7 on layer 1 of a 3-layer stacked int8 cache: ragged lengths, an
    empty slot whose pair is included, a slot whose pair is excluded."""
    rng = np.random.default_rng(31 + G * hd)
    L, b, kvh, S = 3, 3, 2, 32
    q = rng.normal(size=(b, kvh * G, hd)).astype(np.float32)
    cache = _cache(rng, (L, b), kvh, hd, S, False)
    k_new = (rng.integers(-127, 128, (b, kvh, hd)) * 0.01).astype(np.float32)
    v_new = (rng.integers(-127, 128, (b, kvh, hd)) * 0.01).astype(np.float32)
    lengths, inc = np.asarray([19, 0, 31], np.int32), np.asarray([1, 1, 0], np.int32)
    kc, ks = _rope(S, hd)
    ops = (q, *cache, lengths, inc, k_new, v_new, kc, ks)
    want = JDA.quantized_decode_attention_stacked(*(_j(a) for a in ops), layer=1, rope=True)
    got = TDA.quantized_decode_attention_stacked(*(_t(a) for a in ops), layer=1, rope=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# ---------------------------------------------------------------- K4


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_fwd_plain_matches_jax_kernel(dt, causal):
    """O and the log-sum-exp, three query heads a kv head (Falcon3's), lengths
    full, cut mid-block and 1."""
    jdt, tdt = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}[dt]
    B, G, S = 3, 3, 64
    lens = [S, 37, 1]
    rng = np.random.default_rng(HD + causal)
    q, k, v = (rng.normal(size=sh).astype(np.float32)
               for sh in ((B, G, S, HD), (B, S, HD), (B, S, HD)))
    lengths = np.asarray(lens, np.int32)
    jo, jlse = _strict(lambda *a: JFA._flash_fwd(*a, 512, 1024, causal=causal),
                       *(jnp.asarray(a, jdt) for a in (q, k, v)), jnp.asarray(lengths))
    to, tlse = TFA._flash_fwd(*(torch.from_numpy(a).to(tdt) for a in (q, k, v)),
                              torch.from_numpy(lengths), causal)
    g, w = to.float().numpy(), np.array(jnp.asarray(jo, jnp.float32))
    if dt == "f32":
        np.testing.assert_allclose(g, w, **TOL)
    else:
        step = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(w), 2.0 ** -126))) - 7)
        lim = 2 * step + 1e-2 * np.median(np.abs(w[:2]))
        assert np.isfinite(g).all() and (np.abs(g - w) <= lim).all(), float(
            (np.abs(g - w) / lim).max())
    np.testing.assert_allclose(tlse.numpy(), np.asarray(jlse), rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------- whole serving

SERVE_MODES = {"w8kv8_pre": dict(w_bits=8, a_bits=8, kv_bits=8, kv_cache_pack=False),
               "w4kv4_packed": dict(w_bits=4, a_bits=8, kv_bits=4, kv_cache_pack=True)}


def serve_cfg(mode, **kw):
    """The tiny test model (2 layers) at H = 768: three query heads over one
    kv head of 256."""
    return JC.TINY_TEST.replace(hidden_size=3 * HD, intermediate_size=256,
                                num_attention_heads=3, num_key_value_heads=1,
                                **SERVE_MODES[mode], **kw)


@pytest.mark.parametrize("mode", list(SERVE_MODES))
def test_serving_prefill_and_decode_match_jax(mode):
    """Slot a prefills 12 tokens, slot b 7 (each while the other is
    inactive), then 3 greedy decode steps on the default path: logits at
    every step and the committed cache after them."""
    cfg = serve_cfg(mode)
    tc = tcfg(cfg)
    assert tc.head_dim == HD and tc.use_megakernel
    jq, tq = both_qparams(cfg)
    rng = np.random.default_rng(2)
    b, max_len = 2, 32
    jcache = JM.init_serving_cache(cfg, b, max_len)
    tcache = TM.init_serving_cache(tc, b, max_len, device="cpu")

    def step(ids, active):
        nonlocal jcache, tcache
        jl, jcache = JM.serving_forward(jq, cfg, jnp.asarray(ids), jcache["lengths"],
                                        jnp.asarray(active), jcache, dtype=jnp.float32)
        tl, tcache = TM.serving_forward(tq, tc, ids, tcache["lengths"], active, tcache,
                                        dtype=torch.float32, device="cpu")
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
        return np.asarray(jl)

    ids = np.zeros((b, 12), np.int64)
    ids[0] = rng.integers(0, cfg.vocab_size, 12)
    step(ids, np.asarray([True, False]))
    ids = np.zeros((b, 7), np.int64)
    ids[1] = rng.integers(0, cfg.vocab_size, 7)
    lg = step(ids, np.asarray([False, True]))
    tok = np.asarray([[0], [lg[1, 6].argmax()]], np.int64)
    for i in range(3):
        lg = step(tok, np.asarray([True, i != 1]))
        tok = lg[:, -1].argmax(-1)[:, None].astype(np.int64)
    assert_cache_equal(tcache, jcache)


@pytest.mark.parametrize("use_megakernel", [True, False])
def test_engine_greedy_matches_jax(use_megakernel):
    """3 requests through a 2-slot engine at W8A8KV8 on the default path
    (K9's plain version) and on the scan path (K3's) give the JAX serving
    loop's greedy tokens, or part from them only at an int8 flip's near tie
    (``test_torch_head_dims.py``'s rule)."""
    cfg = serve_cfg("w8kv8_pre", use_megakernel=use_megakernel)
    jq, tq = both_qparams(cfg)
    rng = np.random.default_rng(6)
    prompts = [list(map(int, rng.integers(1, cfg.vocab_size, n))) for n in (3, 9, 20)]
    eng = TE.InferenceEngine(tq, tcfg(cfg), max_batch=2, max_len=64, steps_per_sync=4,
                             dtype=torch.float32, device="cpu")
    uids = [eng.submit(p, max_new_tokens=5) for p in prompts]
    done = {r.uid: r.output for r in eng.run()}
    for uid, p in zip(uids, prompts):
        got, want = done[uid], _jax_greedy(jq, cfg, p, 5)
        t = next((i for i, (a, b) in enumerate(zip(got, want)) if a != b), None)
        if t is None:
            continue
        assert t > 0, (uid, p, got, want)       # the prefill's token: no flip allowed there
        jl, tl = _forced_logits(jq, tq, cfg, p + want[:t])
        lead = float(jl[want[t]] - jl[got[t]])
        drift = float(np.linalg.norm(jl - tl) / np.linalg.norm(jl))
        assert lead <= FLIP_LEAD and drift <= FLIP_DRIFT, (uid, p, t, got, want, lead, drift)


# ---------------------------------------------------------------- routing and gates


def falcon3(name, w_bits):
    H, I, nh, kvh, L, V = FALCON3[name]
    return JC.LlamaConfig(vocab_size=V, hidden_size=H, intermediate_size=I,
                          num_attention_heads=nh, num_key_value_heads=kvh, num_hidden_layers=L,
                          rope_theta=1000042.0, rms_norm_eps=1e-6, w_bits=w_bits, a_bits=8,
                          kv_bits=w_bits, kv_cache_pack=w_bits == 4)


@pytest.mark.parametrize("name", list(FALCON3))
@pytest.mark.parametrize("w_bits", [8, 4])
def test_falcon3_takes_the_card_path_where_jax_takes_its_megakernel(name, w_bits):
    """At b = 1 and 8, max_len 1024 and 2048: the card's K9 takes the config
    (``card_takes``) exactly where the port's ``supported()`` and JAX's do,
    at JAX's KV block, through the hd-256 build; K3/K8 and K4 take its
    (G, 256)."""
    jcfg = falcon3(name, w_bits)
    cfg = tcfg(jcfg)
    G = cfg.num_attention_heads // cfg.kv_heads
    assert cfg.head_dim == HD and G in (2, 3)
    for b in (1, 8):
        for S in (1024, 2048):
            jax_takes = JMK.supported(jcfg, b, S)
            card = TMK.card_takes(cfg, b, S, torch.bfloat16)
            assert card == TMK.supported(cfg, b, S) == jax_takes, (
                b, S, TMK._card_shape_error(cfg, b, S, TMK.pick_bk(cfg, b, S), torch.bfloat16))
            assert TMK.pick_bk(cfg, b, S) == JMK._pick_nc_bk(jcfg, b, S)[1]
    assert TMK.card_takes(cfg, 8, 2048, torch.bfloat16)
    assert TMK._stem(HD, G) == "megakernel_d256"
    q = torch.zeros(1, 1, dtype=torch.bfloat16)
    TDA._check_contiguous_kernel_shape("decode", q, G, HD, 2048, 8)
    TDA._check_kernel_shape("paged", q, G, HD, 8)
    TFA._check_built("flash_attention.cu", HD, (q, q, q))
    assert TDA._stem(HD) == "decode_attention_d256"
    assert TFA._entry("flash_fwd", HD) == "flash_fwd_d256"


def test_jax_kv_blocks_at_falcon3_7b():
    """(nc, bk, kh) of JAX's picker at b = 8, max_len 2048: the block K9 walks
    (its items of gcd(64, bk) cache columns at head dim 256)."""
    for w_bits, want in ((8, (128, 128, 2)), (4, (256, 128, 4))):
        jcfg = falcon3("Falcon3-7B", w_bits)
        assert JMK._pick_nc_bk(jcfg, 8, 2048) == want
        assert TMK.pick_bk(tcfg(jcfg), 8, 2048) == want[1]
        assert TMK._chunk(HD) == 64 and TMK._chunk(128) == 128


def test_gates_that_refuse_name_their_rule():
    """K10/K11 refuse head dim 256 naming their own set (the forward takes
    it); K3/K8 refuse G = 5..16 at 256 naming the 4-head limit; K9 refuses
    G = 9 at 256 naming its rule; every gate refuses hd 264 and 512."""
    q = torch.zeros(1, 1, dtype=torch.bfloat16)
    for G in range(1, 5):
        TDA._check_kernel_shape("decode", q, G, HD, 8)
    with pytest.raises(NotImplementedError, match=r"flash_attention_bwd.cu is built for head "
                                                  r"dims \(16, 32, 64, 128\) and every hd % 4 "
                                                  r"== 0 with 32 < hd <= 128 in f32 or bf16"):
        TFA._check_built("flash_attention_bwd.cu", HD, (q, q, q, q))
    for G in (5, 8, 16):
        for what in ("decode", "paged"):
            with pytest.raises(NotImplementedError, match=r"and 1 <= G <= 4 at head dim 256 "
                                                          r"\(G = 5 would need 238208 bytes"):
                TDA._check_kernel_shape(what, q, G, HD, 8)
    for G, takes in ((8, True), (9, False)):
        cfg = tcfg(JC.LlamaConfig(hidden_size=2 * G * HD, intermediate_size=4096,
                                  num_attention_heads=2 * G, num_key_value_heads=2,
                                  w_bits=8, a_bits=8, kv_bits=8))
        assert TMK.card_takes(cfg, 1, 2048, torch.bfloat16) == takes, G
        if not takes:
            why = TMK._card_shape_error(cfg, 1, 2048, TMK.pick_bk(cfg, 1, 2048), torch.bfloat16)
            assert "and 1 <= G <= 8 at head dim 256" in why, why
    for hd in (264, 512):
        with pytest.raises(NotImplementedError, match=r"1 <= G <= 16 query heads per kv head"):
            TDA._check_kernel_shape("decode", q, 1, hd, 8)
        with pytest.raises(NotImplementedError, match=r"flash_attention.cu is built for head "
                                                      r"dims \(16, 32, 64, 128\) .* and for 256"):
            TFA._check_built("flash_attention.cu", hd, (q, q, q))
        with pytest.raises(NotImplementedError, match=r"flash_attention_bwd.cu is built for"):
            TFA._check_built("flash_attention_bwd.cu", hd, (q, q, q, q))
        cfg = tcfg(JC.LlamaConfig(hidden_size=2 * hd, intermediate_size=4096,
                                  num_attention_heads=2, num_key_value_heads=2,
                                  w_bits=8, a_bits=8, kv_bits=8))
        why = TMK._card_shape_error(cfg, 1, 2048, TMK.pick_bk(cfg, 1, 2048), torch.bfloat16)
        assert "and 1 <= G <= 8 at head dim 256" in why, (hd, why)
