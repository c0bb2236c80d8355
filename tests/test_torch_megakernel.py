"""Port parity for the whole-model decode step: llm_qat_torch.inference
.megakernel against the JAX package's megakernel.decode_step, on CPU.

Inputs come from numpy seeds and go to both packages; the JAX side runs its
Pallas kernel in interpret mode, as tests/test_megakernel.py does, and the
port runs the kernel's plain PyTorch version (the CUDA kernel itself is held
against that version on the GPU, tests/test_torch_cuda_kernels.py). A cache
prefilled by the JAX package feeds both decode steps.

Tolerances, float32. Port decode_step against JAX decode_step: committed
integers equal, inverse scales rtol 1e-6 (XLA's CPU rsqrt and mean round
the RMSNorm differently from torch in the last bit, and the per-token scale
inherits that ulp), logits rtol 1e-5 / atol 1e-5 (the two differ in float32
summation order only; the port accumulates its sums in float64). Port
megakernel against port scan path: rtol 2e-4 / atol 2e-4 and integers
equal, as the JAX tests hold their two paths (the paths differ by design:
SiLU in fp32, the attention's block-wise roundings).
"""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_qat_tpu.inference import megakernel as JMK
from llm_qat_tpu.inference import model as JM
from llm_qat_tpu.models import config as JC
from llm_qat_tpu.models.config import TINY_TEST as J_TINY
from llm_qat_torch.inference import engine as TE
from llm_qat_torch.inference import megakernel as TMK
from llm_qat_torch.inference import model as TM
from llm_qat_torch.models import params as TP

from tests.test_torch_serving import _tree, both_qparams, tcfg

LOGIT_TOL = dict(rtol=1e-5, atol=1e-5)
SCAN_TOL = dict(rtol=2e-4, atol=2e-4)
BASE = J_TINY.replace(w_bits=8, a_bits=8, kv_bits=8)
W4KV4P = BASE.replace(w_bits=4, kv_bits=4, kv_cache_pack=True)
GQA8 = BASE.replace(hidden_size=128, intermediate_size=128, num_attention_heads=16,
                    num_key_value_heads=2)      # 8 query heads per kv head


def jax_prefilled(cfg, jq, b, max_len, lens, seed=0):
    """A JAX serving cache holding ``lens`` tokens per slot (scan path, one
    slot at a time), ids from a numpy seed."""
    scan = cfg.replace(use_megakernel=False)
    cache = JM.init_serving_cache(scan, b, max_len)
    ids = np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, max(max(lens), 1)))
    for i, n in enumerate(lens):
        if n:
            active = jnp.asarray([j == i for j in range(b)])
            _, cache = JM.serving_forward(jq, scan, jnp.asarray(ids[:, :n]),
                                          cache["lengths"], active, cache,
                                          dtype=jnp.float32)
    return cache


def both_steps(cfg, lens, active, max_len=32, seed=0):
    """One decode step of both packages from the same prefilled cache.
    Returns (port logits, port cache, JAX logits, JAX cache, the port's
    cache before the step)."""
    b = len(lens)
    jq, tq = both_qparams(cfg, seed)
    jcache = jax_prefilled(cfg, jq, b, max_len, lens, seed)
    tcache = TP.cache_from_numpy(_tree(np.asarray, jcache), "cpu")
    before = {k: v.clone() for k, v in tcache.items()}
    tok = np.random.default_rng(seed + 7).integers(0, cfg.vocab_size, (b, 1))
    act = np.asarray(active)
    jl, jc = JMK.decode_step(jq, cfg, jnp.asarray(tok), jcache["lengths"],
                             jnp.asarray(act), jcache, dtype=jnp.float32)
    tl, tc = TMK.decode_step(tq, tcfg(cfg), tok, tcache["lengths"], act, tcache,
                             dtype=torch.float32, device="cpu")
    return tl, tc, np.asarray(jl), jc, before


def assert_step_equal(tl, tc, jl, jc, rows=None):
    rows = range(tl.shape[0]) if rows is None else rows
    for i in rows:   # inactive slots' logits are discarded by the engine
        np.testing.assert_allclose(tl[i].numpy(), jl[i], **LOGIT_TOL)
    for k in ("k_q", "v_q", "lengths"):
        np.testing.assert_array_equal(tc[k].numpy(), np.asarray(jc[k]), err_msg=k)
    for k in ("k_s", "v_s"):
        np.testing.assert_allclose(tc[k].numpy(), np.asarray(jc[k]), rtol=1e-6,
                                   atol=0, err_msg=k)


@pytest.mark.parametrize("rope_mode", ["pre", "post"])
def test_decode_step_matches_jax(rope_mode):
    cfg = BASE.replace(kv_cache_rope=rope_mode)
    tl, tc, jl, jc, _ = both_steps(cfg, [5, 11, 8], [True, True, True])
    assert tl.shape == (3, 1, cfg.vocab_size) and tl.dtype == torch.float32
    assert_step_equal(tl, tc, jl, jc)


@pytest.mark.parametrize("lens,active", [([6, 4, 0], [True, False, True]),
                                         ([6, 0, 9], [True, False, False])])
def test_inactive_and_empty_slots_match_jax(lens, active):
    """An inactive slot keeps its length and its rows below it; an empty
    active slot attends to its own token only; an empty inactive slot does
    not poison the softmax."""
    tl, tc, jl, jc, before = both_steps(BASE, lens, active)
    assert torch.isfinite(tl).all()
    assert_step_equal(tl, tc, jl, jc, rows=[i for i, a in enumerate(active) if a])
    want_len = [n + int(a) for n, a in zip(lens, active)]
    assert tc["lengths"].tolist() == want_len
    for i, (n, a) in enumerate(zip(lens, active)):
        if not a:
            for k in ("k_q", "v_q"):
                assert torch.equal(tc[k][:, i, :, :, :n], before[k][:, i, :, :, :n])
            for k in ("k_s", "v_s"):
                assert torch.equal(tc[k][:, i, :n], before[k][:, i, :n])


@pytest.mark.parametrize("kv_bits", [8, 4])
def test_w4_weights_match_jax(kv_bits):
    cfg = BASE.replace(w_bits=4, kv_bits=kv_bits, kv_cache_pack=False)
    assert_step_equal(*both_steps(cfg, [6, 11], [True, True])[:4])


@pytest.mark.parametrize("rope_mode", ["pre", "post"])
def test_packed_kv4_matches_jax(rope_mode):
    cfg = W4KV4P.replace(kv_cache_rope=rope_mode)
    tl, tc, jl, jc, _ = both_steps(cfg, [5, 11, 8], [True, True, False])
    assert tc["k_q"].dtype == torch.uint8
    assert_step_equal(tl, tc, jl, jc, rows=[0, 1])


@pytest.mark.parametrize("kv_pack", [False, True])
def test_gqa_eight_heads_per_kv_head_matches_jax(kv_pack):
    """The JAX kernel's cross-head batched softmax computes the same rows."""
    cfg = GQA8.replace(w_bits=4 if kv_pack else 8, kv_bits=4 if kv_pack else 8,
                       kv_cache_pack=kv_pack)
    tl, tc, jl, jc, _ = both_steps(cfg, [5, 11, 8], [True, True, False])
    assert_step_equal(tl, tc, jl, jc, rows=[0, 1])


@pytest.mark.parametrize("kv_bits,kv_pack", [(8, False), (4, True)])
def test_mha_matches_jax(kv_bits, kv_pack):
    cfg = BASE.replace(w_bits=4, kv_bits=kv_bits, kv_cache_pack=kv_pack,
                       num_key_value_heads=4)
    assert_step_equal(*both_steps(cfg, [7, 13], [True, True], seed=3)[:4])


@pytest.mark.parametrize("rope_mode", ["pre", "post"])
def test_two_blocks_online_rescale_matches_jax(rope_mode):
    """megakernel_bk = 8 under lengths up to 21: three KV blocks, so the
    running maximum rescales, and slots end inside a block, on a block edge
    and before the last block."""
    cfg = BASE.replace(megakernel_bk=8, kv_cache_rope=rope_mode)
    assert TMK.pick_bk(tcfg(cfg), 3, 32) == 8
    assert_step_equal(*both_steps(cfg, [21, 16, 3], [True, True, True])[:4])


def test_greedy_rollout_matches_jax():
    cfg = BASE
    b, max_len = 2, 32
    jq, tq = both_qparams(cfg)
    jcache = jax_prefilled(cfg, jq, b, max_len, [7, 12])
    tcache = TP.cache_from_numpy(_tree(np.asarray, jcache), "cpu")
    tok = np.random.default_rng(5).integers(0, cfg.vocab_size, (b, 1))
    jtok, act = tok, np.ones((b,), bool)
    for _ in range(6):
        jl, jcache = JMK.decode_step(jq, cfg, jnp.asarray(jtok), jcache["lengths"],
                                     jnp.asarray(act), jcache, dtype=jnp.float32)
        tl, tcache = TMK.decode_step(tq, tcfg(cfg), tok, tcache["lengths"], act, tcache,
                                     dtype=torch.float32, device="cpu")
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
        jtok = np.asarray(jl)[:, -1].argmax(-1)[:, None]
        tok = tl.numpy()[:, -1].argmax(-1)[:, None]
        np.testing.assert_array_equal(tok, jtok)
    assert_step_equal(tl, tcache, np.asarray(jl), jcache)


MODES = {"w8kv8_pre": BASE, "w8kv8_post": BASE.replace(kv_cache_rope="post"),
         "w4kv4p_pre": W4KV4P, "gqa8": GQA8}


@pytest.mark.parametrize("mode", list(MODES))
def test_megakernel_matches_port_scan_path(mode):
    """serving_forward with the default flag against use_megakernel=False."""
    cfg = MODES[mode]
    jq, tq = both_qparams(cfg)
    jcache = jax_prefilled(cfg, jq, 3, 32, [5, 11, 8])
    tok = np.random.default_rng(7).integers(0, cfg.vocab_size, (3, 1))
    act, out = np.asarray([True, True, False]), []
    for flag in (True, False):
        c = tcfg(cfg.replace(use_megakernel=flag))
        cache = TP.cache_from_numpy(_tree(np.asarray, jcache), "cpu")
        out.append(TM.serving_forward(tq, c, tok, cache["lengths"], act, cache,
                                      dtype=torch.float32, device="cpu"))
    (lm, cm), (ls, cs) = out
    for i in (0, 1):
        np.testing.assert_allclose(lm[i].numpy(), ls[i].numpy(), **SCAN_TOL)
    for k in ("k_q", "v_q", "lengths"):
        assert torch.equal(cm[k], cs[k]), k
    for k in ("k_s", "v_s"):
        np.testing.assert_allclose(cm[k].numpy(), cs[k].numpy(), rtol=1e-6)


@pytest.mark.parametrize("mode", ["w8kv8_pre", "w4kv4p_pre"])
def test_engine_default_flag_matches_scan_engine(mode, monkeypatch):
    """The engine on the default configuration decodes through
    megakernel.decode_step and gives the scan engine's greedy tokens."""
    cfg = MODES[mode]
    _, tq = both_qparams(cfg)
    rng = np.random.default_rng(3)
    prompts = [list(map(int, rng.integers(1, cfg.vocab_size, n))) for n in (9, 13, 4)]
    calls = {"n": 0}
    real = TMK.decode_layers_plain

    def counted(*a, **k):
        calls["n"] += 1
        return real(*a, **k)

    monkeypatch.setattr(TMK, "decode_layers_plain", counted)

    def run(c):
        eng = TE.InferenceEngine(tq, tcfg(c), max_batch=2, max_len=64, steps_per_sync=4,
                                 dtype=torch.float32, device="cpu")
        for p in prompts:
            eng.submit(p, max_new_tokens=6)
        return {r.uid: r.output for r in eng.run()}

    assert cfg.use_megakernel            # the default
    got = run(cfg)
    steps = calls["n"]
    assert steps >= 6
    want = run(cfg.replace(use_megakernel=False))
    assert calls["n"] == steps           # the scan engine never went there
    assert got == want


PICK_GRID = {
    "tiny": BASE,
    "tiny_bk8": BASE.replace(megakernel_bk=8),
    "tinyllama_w8": JC.TINYLLAMA_1B.replace(w_bits=8, a_bits=8, kv_bits=8),
    "tinyllama_w4kv4": JC.TINYLLAMA_1B.replace(w_bits=4, a_bits=8, kv_bits=4),
    "tinyllama_bk256": JC.TINYLLAMA_1B.replace(w_bits=8, a_bits=8, kv_bits=8,
                                               megakernel_bk=256),
    "tinyllama_nc512": JC.TINYLLAMA_1B.replace(w_bits=4, a_bits=8, kv_bits=4,
                                               megakernel_nc=512),
    "llama7b_w8": JC.LLAMA_7B.replace(w_bits=8, a_bits=8, kv_bits=8),
    "llama7b_w4kv4": JC.LLAMA_7B.replace(w_bits=4, a_bits=8, kv_bits=4),
    "llama13b_w4kv4": JC.LLAMA_13B.replace(w_bits=4, a_bits=8, kv_bits=4),
}


@pytest.mark.parametrize("name", list(PICK_GRID))
def test_kv_block_equals_jax_picker(name):
    """BK decides where the online softmax rounds: the port's must be the
    JAX package's for every (config, b, max_len)."""
    cfg = PICK_GRID[name]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")     # JAX warns on a rejected megakernel_nc
        for b in (1, 3, 8, 16, 32):
            for max_len in (32, 64, 256, 1024, 2048, 4096):
                want = JMK._pick_nc_bk(cfg, b, max_len)[1]
                assert TMK.pick_bk(tcfg(cfg), b, max_len) == want, (b, max_len)


def test_supported_rules_and_fallback_to_scan():
    c = tcfg(BASE)
    assert TMK.supported(c, 3, 32)
    assert TMK.supported(tcfg(PICK_GRID["tinyllama_w4kv4"]), 8, 2048)
    assert TMK.supported(tcfg(PICK_GRID["tinyllama_w8"]), 32, 4096)
    assert not TMK.supported(c, 33, 32)                      # batch
    assert not TMK.supported(c.replace(w_bits=16), 3, 32)    # fp weights
    assert not TMK.supported(c.replace(a_bits=16), 3, 32)    # fp activations
    assert not TMK.supported(c.replace(a_bits=2), 3, 32)
    # a KV block whose scores, K and V bytes outgrow one block's shared memory
    big = tcfg(PICK_GRID["tinyllama_w8"]).replace(megakernel_bk=2048)
    assert TMK.smem_bytes(big, 2048) > TMK.SMEM_PER_BLOCK and not TMK.supported(big, 8, 2048)
    # outside supported(): the default flag serves through the scan path
    cfg = BASE.replace(w_bits=16)
    _, tq = both_qparams(cfg)
    cache = TM.init_serving_cache(tcfg(cfg), 1, 16, device="cpu")
    lg, cache = TM.serving_forward(tq, tcfg(cfg), np.zeros((1, 1), np.int64), [0], [True],
                                   cache, dtype=torch.float32, device="cpu")
    assert torch.isfinite(lg).all() and cache["lengths"].tolist() == [1]


def test_cache_from_numpy_checks_the_cache():
    cache = _tree(np.asarray, JM.init_serving_cache(W4KV4P, 2, 16))
    t = TP.cache_from_numpy(cache, "cpu")
    assert t["k_q"].dtype == torch.uint8 and t["k_q"].shape == (2, 2, 2, 8, 16)
    assert t["k_s"].dtype == torch.float32 and t["lengths"].dtype == torch.int32
    with pytest.raises(ValueError, match="keys"):
        TP.cache_from_numpy({k: v for k, v in cache.items() if k != "v_s"}, "cpu")
    with pytest.raises(ValueError, match="k_s"):
        TP.cache_from_numpy(dict(cache, k_s=cache["k_s"].astype(np.float64)), "cpu")


def test_decode_step_needs_a_gpu_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    c = tcfg(BASE)
    _, tq = both_qparams(BASE)
    cache = TM.init_serving_cache(c, 1, 16, device="cpu")
    for fn in (TMK.decode_step, TMK.decode_step_plain):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fn(tq, c, np.zeros((1, 1), np.int64), [0], [True], cache)
