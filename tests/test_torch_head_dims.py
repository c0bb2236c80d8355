"""Head dims off the power-of-two set (OpenLLaMA-3B's 100, and 80), held on
the CPU against the JAX package: the plain versions that the card's padded
builds (``hd % 4 == 0`` with ``32 < hd <= 128``) are held against in
``chip_smoke.py`` and the ``-m cuda`` tests, and the routing and gates of
that rule. K3/K7/K8 and K4 at these head dims are cases of
``test_torch_shapes.py``'s tests (``PAD_DECODE_SHAPES``, the flash list).

* K9's plain decode step against JAX's ``megakernel.decode_step`` (its Pallas
  kernel in interpret mode): W8KV8 "pre" and "post", W4KV4 packed; integers
  equal, scales rtol 1e-6, logits 1e-4 (``test_torch_megakernel.py``).
* Whole serving on two layers at H = 200 (two MHA heads of 100) and H = 400
  (four query heads over two kv heads of 100): prefill and decode logits
  at every step and the committed cache against JAX's ``serving_forward``,
  and the engine's greedy tokens on the default and the scan path against
  the JAX serving loop. The tokens may part only at a near tie that an int8
  rounding flip explains (the named class: XLA's and torch's f32 sums differ
  in the last bit and one activation rounds the other way; at H = 400 one of
  the prompts meets it in the prefill): teacher-forced on the same context,
  JAX's lead of its token over the port's is at most ``FLIP_LEAD`` and the
  two packages' logits there are within ``FLIP_DRIFT`` (relative L2).
* OpenLLaMA-3B's widths: both packages' routing, and the card's K9, K3/K8,
  K4 and K10/K11 gates take it; outside the rule each gate raises naming it.
  (Its training steps at head dims 100 and 80 are cases of
  ``test_torch_trainer.py``'s whole-step test.)
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_qat_tpu.inference import megakernel as JMK
from llm_qat_tpu.inference import model as JM
from llm_qat_tpu.models import config as JC
from llm_qat_torch.inference import engine as TE
from llm_qat_torch.inference import megakernel as TMK
from llm_qat_torch.inference import model as TM
from llm_qat_torch.ops import decode_attention as TDA
from llm_qat_torch.ops import flash_attention as TFA

from tests.test_torch_megakernel import BASE as MK_BASE
from tests.test_torch_megakernel import assert_step_equal, both_steps
from tests.test_torch_serving import (LOGIT_TOL, _jax_greedy, assert_cache_equal, both_qparams,
                                      tcfg)

HEAD_DIMS = (100, 80)
# OpenLLaMA-3B's published config.json: hidden, intermediate, heads, kv heads
OPENLLAMA_3B = (3200, 8640, 32, 32)


# ---------------------------------------------------------------- K9


K9_MODES = {"w8kv8_pre": dict(w_bits=8, kv_bits=8, kv_cache_pack=False),
            "w8kv8_post": dict(w_bits=8, kv_bits=8, kv_cache_pack=False, kv_cache_rope="post"),
            "w4kv4_packed": dict(w_bits=4, kv_bits=4, kv_cache_pack=True)}


def hd_cfg(hd, nh, kvh, **kw):
    """The tiny test model (2 layers) with ``nh`` query heads over ``kvh`` kv
    heads of ``hd``."""
    return MK_BASE.replace(hidden_size=nh * hd, intermediate_size=256, num_attention_heads=nh,
                           num_key_value_heads=kvh, **kw)


@pytest.mark.parametrize("hd", HEAD_DIMS)
@pytest.mark.parametrize("mode", list(K9_MODES))
def test_decode_step_matches_jax(hd, mode):
    """K9's plain version through the port's decode step against JAX's
    decode_step: two MHA heads; an active slot, an empty active slot, an
    inactive slot."""
    cfg = hd_cfg(hd, 2, 2, **K9_MODES[mode])
    assert cfg.head_dim == hd
    assert JMK.supported(cfg, 3, 32) and TMK.supported(tcfg(cfg), 3, 32)
    tl, tc, jl, jc, _ = both_steps(cfg, [5, 0, 11], [True, True, False])
    assert_step_equal(tl, tc, jl, jc, rows=[0, 1])


# ---------------------------------------------------------------- whole serving

SERVE_SHAPES = {"h200_mha": (2, 2), "h400_g2": (4, 2)}   # (query heads, kv heads) of 100
# a token may part from JAX's only where JAX's lead is this small (the tiny
# model's logit rows have a std of ~0.4) and the logits on the same context
# are this close (relative L2; unrelated rows read ~1.4): an int8 flip
FLIP_LEAD, FLIP_DRIFT = 0.05, 0.05
SERVE_MODES = {"w8kv8_pre": dict(w_bits=8, a_bits=8, kv_bits=8, kv_cache_pack=False),
               "w4kv4_packed": dict(w_bits=4, a_bits=8, kv_bits=4, kv_cache_pack=True)}


def serve_cfg(shape, mode, **kw):
    nh, kvh = SERVE_SHAPES[shape]
    return JC.TINY_TEST.replace(hidden_size=nh * 100, intermediate_size=256,
                                num_attention_heads=nh, num_key_value_heads=kvh,
                                **SERVE_MODES[mode], **kw)


@pytest.mark.parametrize("shape", list(SERVE_SHAPES))
@pytest.mark.parametrize("mode", list(SERVE_MODES))
def test_serving_prefill_and_decode_match_jax(shape, mode):
    """Slot a prefills 12 tokens, slot b 7 (each while the other is
    inactive), then 3 greedy decode steps on the default path: logits at
    every step and the committed cache after them."""
    cfg = serve_cfg(shape, mode)
    tc = tcfg(cfg)
    assert tc.head_dim == 100 and tc.use_megakernel
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


def _forced_logits(jq, tq, cfg, ids):
    """Both packages' last-position logits after ``ids`` (one slot: the
    prefill of all but the last, then the last as a decode step)."""
    jc = JM.init_serving_cache(cfg, 1, 64)
    tc = TM.init_serving_cache(tcfg(cfg), 1, 64, device="cpu")
    for chunk in (ids[:-1], ids[-1:]):
        jl, jc = JM.serving_forward(jq, cfg, jnp.asarray([chunk]), jc["lengths"],
                                    jnp.asarray([True]), jc, dtype=jnp.float32)
        tl, tc = TM.serving_forward(tq, tcfg(cfg), np.asarray([chunk]), tc["lengths"],
                                    np.asarray([True]), tc, dtype=torch.float32, device="cpu")
    return np.asarray(jl)[0, -1], tl.numpy()[0, -1]


@pytest.mark.parametrize("shape", list(SERVE_SHAPES))
@pytest.mark.parametrize("use_megakernel", [True, False])
def test_engine_greedy_matches_jax(shape, use_megakernel):
    """3 requests through a 2-slot engine at W8A8KV8 on the default path
    (K9's plain version) and on the scan path (K3's) give the JAX serving
    loop's greedy tokens, or part from them only at an int8 flip's near tie
    (module docstring)."""
    cfg = serve_cfg(shape, "w8kv8_pre", use_megakernel=use_megakernel)
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


@pytest.mark.parametrize("w_bits,kv_bits", [(8, 8), (4, 4)])
def test_openllama_3b_takes_the_card_path_where_jax_takes_its_megakernel(w_bits, kv_bits):
    """OpenLLaMA-3B (head dim 100, H 3200 and I 8640 off the 256 grid) at
    b = 8, S = 1024 and 2048: JAX's supported() sends it to its megakernel,
    and the card's K9 takes it at JAX's KV block; K3/K8 and K4 take hd 100,
    and the products' K (3200, 8640) are whole 16-value pieces."""
    H, I, nh, kvh = OPENLLAMA_3B
    jcfg = JC.LlamaConfig(hidden_size=H, intermediate_size=I, num_attention_heads=nh,
                          num_key_value_heads=kvh, num_hidden_layers=26, rms_norm_eps=1e-6,
                          w_bits=w_bits, a_bits=8, kv_bits=kv_bits, kv_cache_pack=kv_bits == 4)
    cfg = tcfg(jcfg)
    assert cfg.head_dim == 100 and H % 256 and I % 256
    for S in (1024, 2048):
        assert JMK.supported(jcfg, 8, S)
        bk = TMK.pick_bk(cfg, 8, S)
        assert bk == JMK._pick_nc_bk(jcfg, 8, S)[1]
        assert TMK.card_takes(cfg, 8, S, torch.bfloat16), TMK._card_shape_error(
            cfg, 8, S, bk, torch.bfloat16)
    q = torch.zeros(1, 1, dtype=torch.bfloat16)
    TDA._check_contiguous_kernel_shape("decode", q, 1, 100, 2048, 8)
    TDA._check_kernel_shape("paged", q, 1, 100, 8)
    TFA._check_built("flash_attention.cu", 100, (q, q, q))
    assert TMK._stem(100) == "megakernel_dpad" and TDA._stem(100) == "decode_attention_dpad"
    assert TFA._entry("flash_fwd", 100) == "flash_fwd_dpad"


def test_k9_takes_k_off_the_256_grid_in_the_padded_build_only():
    """The products' K tail (a zero-padded last chunk of 256) is the padded
    build's: I = 2112 at head dim 80 goes to K9, at head dim 64 to the scan
    path, K9 naming its rule; the tiled weight copy pads K with zeros."""
    for hd, takes in ((80, True), (64, False)):
        cfg = tcfg(MK_BASE.replace(hidden_size=8 * hd, intermediate_size=2112,
                                   num_attention_heads=8, num_key_value_heads=8))
        assert TMK.card_takes(cfg, 8, 2048, torch.bfloat16) == takes, hd
        if not takes:
            why = TMK._card_shape_error(cfg, 8, 2048, TMK.pick_bk(cfg, 8, 2048), torch.bfloat16)
            assert "multiples of 256 at head dims 64 and 128, of 16 at the padded build" in why
    q = torch.arange(3 * 2112 * 128, dtype=torch.int32).reshape(3, 2112, 128).to(torch.int8)
    t = TMK.untile(TMK._k_contiguous(q))
    assert t.shape == (3, 128, 2304) and torch.equal(t[..., :2112], q.transpose(1, 2))
    assert not t[..., 2112:].any()


def test_gates_take_the_rule_and_name_it_outside():
    """Every hd % 4 == 0 with 32 < hd <= 128 passes K3/K8's, K4's and K9's
    gates (the power-of-two dims through their own builds, the rest through
    the padded ones), and so does K10/K11's; outside it each raises and names
    the rule."""
    q = torch.zeros(1, 1, dtype=torch.bfloat16)
    for hd in range(36, 129, 4):
        for G in (1, 8):
            TDA._check_kernel_shape("decode", q, G, hd, 8)
        TFA._check_built("flash_attention.cu", hd, (q, q, q))
        TFA._check_built("flash_attention_bwd.cu", hd, (q, q, q, q))
        assert TFA._entry("flash_bwd_dq", hd) == (
            "flash_bwd_dq" if hd == 64 else f"flash_bwd_dq_d{hd}" if hd == 128
            else "flash_bwd_dq_dpad")
        cfg = tcfg(MK_BASE.replace(hidden_size=4 * hd, intermediate_size=256,
                                   num_attention_heads=4, num_key_value_heads=4))
        if 4 * hd % 128 == 0:                  # the products' 128-column tiles
            assert TMK.card_takes(cfg, 8, 2048, torch.float32), hd
        assert (TMK._stem(hd) == "megakernel_dpad") == (hd not in (64, 128))
    for hd in (34, 30, 98, 132, 264):
        with pytest.raises(NotImplementedError, match=r"and every hd % 4 == 0 with 32 < hd <= 128"):
            TDA._check_kernel_shape("decode", q, 1, hd, 8)
        with pytest.raises(NotImplementedError, match=r"and every hd % 4 == 0 with 32 < hd <= 128"):
            TFA._check_built("flash_attention.cu", hd, (q, q, q))
        with pytest.raises(NotImplementedError, match=r"flash_attention_bwd.cu is built for .* "
                                                      r"and every hd % 4 == 0 with 32 < hd <= 128"):
            TFA._check_built("flash_attention_bwd.cu", hd, (q, q, q, q))
        cfg = tcfg(MK_BASE.replace(hidden_size=8 * hd, intermediate_size=256,
                                   num_attention_heads=8, num_key_value_heads=8))
        why = TMK._card_shape_error(cfg, 8, 2048, TMK.pick_bk(cfg, 8, 2048), torch.float32)
        assert "every hd % 4 == 0 with 32 < hd <= 128" in why, (hd, why)
