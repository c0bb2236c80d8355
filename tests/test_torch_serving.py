"""Port parity for the serving slice as a whole: llm_qat_torch.inference
(model, engine) against the JAX package's scan serving path, on CPU.

Inputs come from a numpy seed and go to both packages; JAX configs pass
use_megakernel=False so both sides take the scan path, whose Pallas kernels
run in interpret mode. Tolerances: logits at rtol/atol 1e-4 (float32;
different f32 summation orders only); committed cache integers bit-exact
(both round half to even); cache scales at rtol 1e-6, because XLA's CPU
rsqrt and mean round the RMSNorm differently from torch in the last f32 bit
and the per-token scale inherits that ulp; greedy tokens equal.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_qat_tpu.inference import model as JM
from llm_qat_tpu.inference import quantized as JQ
from llm_qat_tpu.models.config import TINY_TEST as J_TINY
from llm_qat_torch.inference import engine as TE
from llm_qat_torch.inference import model as TM
from llm_qat_torch.inference import quantized as TQ
from llm_qat_torch.models import config as TC
from llm_qat_torch.models import params as TP

LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
BASE = J_TINY.replace(w_bits=8, a_bits=8, kv_bits=8, use_megakernel=False)
MODES = {
    "w8kv8_pre": BASE,
    "w8kv8_post": BASE.replace(kv_cache_rope="post"),
    "w4kv4p_pre": BASE.replace(w_bits=4, kv_bits=4),
    "w4kv4p_post": BASE.replace(w_bits=4, kv_bits=4, kv_cache_rope="post"),
    "mha_w8kv8": BASE.replace(num_key_value_heads=None),
}
CACHE_KEYS = ("k_q", "k_s", "v_q", "v_s")


def tcfg(jcfg):
    return TC.LlamaConfig(**dataclasses.asdict(jcfg))


def np_params(cfg, seed=0):
    """Latent fp params in the JAX layout, from numpy; norm gains near 1."""
    rng = np.random.default_rng(seed)
    hd, nh, kvh, L, H, I = (cfg.head_dim, cfg.num_attention_heads, cfg.kv_heads,
                            cfg.num_hidden_layers, cfg.hidden_size,
                            cfg.intermediate_size)

    def w(*shape):
        return (rng.normal(size=shape) * 0.02).astype(np.float32)

    def g(*shape):
        return (1.0 + 0.1 * rng.normal(size=shape)).astype(np.float32)

    return {
        "embed": w(cfg.vocab_size, H),
        "layers": {
            "attn_norm": g(L, H), "q": w(L, H, nh * hd), "k": w(L, H, kvh * hd),
            "v": w(L, H, kvh * hd), "o": w(L, nh * hd, H), "mlp_norm": g(L, H),
            "gate": w(L, H, I), "up": w(L, H, I), "down": w(L, I, H),
        },
        "final_norm": g(H),
        "lm_head": w(H, cfg.vocab_size),
    }


def _tree(fn, node):
    return {k: _tree(fn, v) for k, v in node.items()} if isinstance(node, dict) else fn(node)


def both_qparams(cfg, seed=0):
    p = np_params(cfg, seed)
    jq = JQ.quantize_params(_tree(jnp.asarray, p), cfg)
    tq = TQ.quantize_params(TP.from_numpy(p, "cpu"), tcfg(cfg), device="cpu")
    return jq, tq


def assert_cache_equal(tc, jc):
    for k in ("k_q", "v_q", "lengths"):
        np.testing.assert_array_equal(tc[k].numpy(), np.asarray(jc[k]), err_msg=k)
    for k in ("k_s", "v_s"):
        np.testing.assert_allclose(tc[k].numpy(), np.asarray(jc[k]), rtol=1e-6,
                                   atol=0, err_msg=k)


@pytest.mark.parametrize("mode", list(MODES))
def test_prefill_slot_matches_jax(mode):
    cfg = MODES[mode]
    jq, tq = both_qparams(cfg)
    ids = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 16))
    jl, jrows = JM.prefill_slot(jq, cfg, jnp.asarray(ids), dtype=jnp.float32)
    tl, trows = TM.prefill_slot(tq, tcfg(cfg), ids, dtype=torch.float32, device="cpu")
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
    assert_cache_equal(trows, jrows)


@pytest.mark.parametrize("mode", ["w8kv8_pre", "w4kv4p_post"])
def test_serving_forward_from_empty_flash_prefill_matches_jax(mode):
    """serving_forward(from_empty=True): the flash prefill into the
    persistent cache, one slot active and one inactive."""
    cfg = MODES[mode]
    jq, tq = both_qparams(cfg)
    ids = np.random.default_rng(5).integers(0, cfg.vocab_size, (2, 16))
    lens, act = np.zeros(2, np.int32), np.asarray([True, False])
    jc = JM.init_serving_cache(cfg, 2, 32)
    jl, jc = JM.serving_forward(jq, cfg, jnp.asarray(ids), jnp.asarray(lens),
                                jnp.asarray(act), jc, dtype=jnp.float32, from_empty=True)
    tc = TM.init_serving_cache(tcfg(cfg), 2, 32, device="cpu")
    tl, tc = TM.serving_forward(tq, tcfg(cfg), ids, lens, act, tc, dtype=torch.float32,
                                from_empty=True, device="cpu")
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
    assert_cache_equal(tc, jc)


@pytest.mark.parametrize("mode", list(MODES))
def test_serving_ragged_prefill_and_decode_match_jax(mode):
    """Slot a prefills 12 tokens, slot b 7 (each while the other is
    inactive), then 6 greedy decode steps: logits at every step and the
    committed cache after them."""
    cfg = MODES[mode]
    tc = tcfg(cfg)
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
    for i in range(6):
        active = np.asarray([True, i % 3 != 1])   # slot b sits out some steps
        lg = step(tok, active)
        tok = lg[:, -1].argmax(-1)[:, None].astype(np.int64)
    assert_cache_equal(tcache, jcache)


@pytest.mark.parametrize("packed", [False, True])
def test_insert_slot_and_commit_kv_columns_match_jax(packed):
    rng = np.random.default_rng(3)
    L, b, kvh, hd, S, s = 2, 3, 2, 16, 32, 8
    hdc = hd // 2 if packed else hd
    qdt = np.uint8 if packed else np.int8
    lo, hi = (0, 256) if packed else (-128, 128)
    cache = {
        "k_q": rng.integers(lo, hi, (L, b, kvh, hdc, S)).astype(qdt),
        "v_q": rng.integers(lo, hi, (L, b, kvh, hdc, S)).astype(qdt),
        "k_s": rng.uniform(size=(L, b, S)).astype(np.float32),
        "v_s": rng.uniform(size=(L, b, S)).astype(np.float32),
        "lengths": np.asarray([3, 0, 9], np.int32),
    }
    rows = {k: (cache[k][:, :1, ..., :s] + 1).astype(cache[k].dtype) for k in CACHE_KEYS}
    jc = JM.insert_slot(_tree(jnp.asarray, cache), _tree(jnp.asarray, rows), jnp.int32(2))
    tc = TM.insert_slot(_tree(lambda a: torch.from_numpy(a.copy()), cache),
                        _tree(torch.from_numpy, rows), 2)
    assert_cache_equal(tc, jc)

    cols = [rng.integers(-8 if packed else -127, 8 if packed else 128,
                         (L, b, kvh, hd)).astype(np.int8) for _ in range(2)]
    invs = [rng.uniform(size=(L, b, 1)).astype(np.float32) for _ in range(2)]
    wp = np.asarray([4, S - 1, 0], np.int32)
    jout = JM.commit_kv_columns(*(jnp.asarray(cache[k]) for k in CACHE_KEYS),
                                *map(jnp.asarray, cols), *map(jnp.asarray, invs),
                                jnp.asarray(wp), packed)
    t = [torch.from_numpy(cache[k].copy()) for k in CACHE_KEYS]
    tout = TM.commit_kv_columns(*t, *map(torch.from_numpy, cols),
                                *map(torch.from_numpy, invs), torch.from_numpy(wp), packed)
    for a, e in zip(tout, jout):
        np.testing.assert_array_equal(a.numpy(), np.asarray(e))


def _jax_greedy(jq, cfg, prompt, n):
    """Greedy rollout with the JAX package's serving_forward, one slot."""
    cache = JM.init_serving_cache(cfg, 1, 64)
    lg, cache = JM.serving_forward(jq, cfg, jnp.asarray([prompt]), cache["lengths"],
                                   jnp.asarray([True]), cache, dtype=jnp.float32)
    out = [int(np.asarray(lg)[0, -1].argmax())]
    for _ in range(n - 1):
        lg, cache = JM.serving_forward(jq, cfg, jnp.asarray([[out[-1]]]),
                                       cache["lengths"], jnp.asarray([True]), cache,
                                       dtype=jnp.float32)
        out.append(int(np.asarray(lg)[0, -1].argmax()))
    return out


@pytest.mark.parametrize("mode", ["w8kv8_pre", "w4kv4p_pre"])
def test_engine_greedy_matches_jax_serving_loop(mode):
    """3 requests of mixed lengths through a 2-slot engine (queueing, a
    shared prefill bucket, mixed-length decode) give the JAX loop's tokens."""
    cfg = MODES[mode]
    jq, tq = both_qparams(cfg)
    rng = np.random.default_rng(4)
    prompts = [list(map(int, rng.integers(1, cfg.vocab_size, n))) for n in (3, 9, 20)]
    eng = TE.InferenceEngine(tq, tcfg(cfg), max_batch=2, max_len=64, steps_per_sync=4,
                             dtype=torch.float32, device="cpu")
    uids = [eng.submit(p, max_new_tokens=6) for p in prompts]
    done = {r.uid: r.output for r in eng.run()}
    for uid, p in zip(uids, prompts):
        assert done[uid] == _jax_greedy(jq, cfg, p, 6), (uid, p)
