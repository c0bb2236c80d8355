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

import math
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
from llm_qat_torch.ops import quant_matmul as QM

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
    # the kernel's shared memory no longer grows with the KV block: a block
    # of 2048 columns is taken
    big = tcfg(PICK_GRID["tinyllama_w8"]).replace(megakernel_bk=2048)
    assert TMK.supported(big, 8, 2048) and TMK.pick_bk(big, 8, 2048) == 2048
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


# ---------------------------------------------------------------------------
# the CUDA kernel's design, held on the CPU: the attention split over cache
# chunks, the K-contiguous weight copy, the shapes the kernel takes
# ---------------------------------------------------------------------------


def split_attention(q4, k_int, v_int, k_inv, v_inv, layer_cache, kcos, ksin, qcos, qsin,
                    lens, active, c, bk, dtype, chunk=128):
    """The attention as the CUDA kernel splits it (test-only reference):
    every column's score at once; each ``chunk``-column chunk's maximum; the
    BK blocks' prefix maxima m_j from the chunk maxima; per chunk float64
    partial sums of p = exp(s - m_j) and of p.V, combined per block and
    rounded once; then the fp32 recurrence over the blocks in order and the
    current token folded in, as ``_attend_plain`` folds it."""
    b = q4.shape[0]
    hd, kvh = c.head_dim, c.kv_heads
    h2 = hd // 2
    k_q, k_s, v_q, v_s = layer_cache
    S = k_q.shape[-1]
    ch = math.gcd(chunk, bk)
    ct = torch.bfloat16 if dtype == torch.bfloat16 else torch.float32
    scale = 1.0 / (hd ** 0.5)
    if TM.cache_is_packed(c):
        k_q, v_q = QM.unpack_int4(k_q, 2), QM.unpack_int4(v_q, 2)
    k1, k2 = k_q[:, :, :h2].to(ct), k_q[:, :, h2:].to(ct)           # [b, kvh, h2, S]
    ksl = k_s[:, None, None, :]
    if c.kv_cache_rope != "post":
        cc, ss = (kcos * ksl).to(ct), (ksin * ksl).to(ct)
        kr = torch.cat(TMK._rope_halves(k1, k2, cc, ss), dim=2)
    else:
        kr = torch.cat([k1 * ksl.to(ct), k2 * ksl.to(ct)], dim=2)
    s_all = TMK._dot64("bhgd,bhdk->bhgk", q4.to(ct), kr) * scale    # [b, kvh, G, S]
    groups = q4.shape[2]
    out_m = torch.full((b, kvh, groups, 1), TMK._NEG_INF)
    out_l = torch.zeros_like(out_m)
    out_acc = torch.zeros((b, kvh, groups, hd))
    for i in range(b):
        n = int(lens[i])
        nch = -(-n // ch)
        cmax = [s_all[i, :, :, k * ch:min(n, (k + 1) * ch)].amax(-1) for k in range(nch)]
        m = torch.full((kvh, groups), TMK._NEG_INF)
        lsum = torch.zeros((kvh, groups))
        acc = torch.zeros((kvh, groups, hd))
        for j in range(-(-n // bk)):
            cs, ce = j * bk // ch, min(nch, (j + 1) * bk // ch)
            mb = m
            for k in range(cs, ce):
                mb = torch.maximum(mb, cmax[k])
            P = torch.zeros((kvh, groups), dtype=torch.float64)
            PV = torch.zeros((kvh, groups, hd), dtype=torch.float64)
            for k in range(cs, ce):
                lo, hi = k * ch, min(n, (k + 1) * ch)
                p = torch.exp(s_all[i, :, :, lo:hi] - mb[..., None])
                P += p.double().sum(-1)
                pv = (p * v_s[i, None, None, lo:hi]).to(ct)
                PV += torch.einsum("hgk,hdk->hgd", pv.double(), v_q[i, :, :, lo:hi].double())
            alpha = torch.exp(m - mb)
            lsum = lsum * alpha + P.float()
            acc = acc * alpha[..., None] + PV.float()
            m = mb
        out_m[i, ..., 0], out_l[i, ..., 0], out_acc[i] = m, lsum, acc
    # the current token, as the plain version folds it
    act = active.to(torch.bool).reshape(b, 1, 1, 1)
    kinv, vinv = k_inv.reshape(b, 1, 1), v_inv.reshape(b, 1, 1).to(ct)
    ki = k_int.reshape(b, kvh, hd).to(ct)
    if c.kv_cache_rope != "post":
        k_fold = torch.cat(TMK._rope_halves(ki[..., :h2], ki[..., h2:], (qcos[:, None, :] * kinv).to(ct),
                                            (qsin[:, None, :] * kinv).to(ct)), -1)
    else:
        k_fold = ki * kinv.to(ct)
    v_fold = (v_int.reshape(b, kvh, hd).to(ct) * vinv).float()
    s_cur = TMK._dot64("bhgd,bhd->bhg", q4, k_fold.float())[..., None] * scale
    s_cur = torch.where(act, s_cur, torch.full_like(s_cur, TMK._NEG_INF))
    m_new = torch.maximum(out_m, s_cur)
    alpha = torch.exp(out_m - m_new)
    p = torch.where(act, torch.exp(s_cur - m_new), torch.zeros_like(s_cur))
    l_new = torch.clamp(out_l * alpha + p, min=1e-9)
    acc = out_acc * alpha + p * v_fold[:, :, None, :]
    return (acc / l_new).to(dtype).reshape(b, -1)


# (G, hd) at narrow widths: the kernel's two shapes
SPLIT_SHAPES = {"g8_d64": dict(num_attention_heads=16, num_key_value_heads=2, head_dim=64),
                "g1_d128": dict(num_attention_heads=2, num_key_value_heads=2, head_dim=128)}


def _split_case(shape, rope_mode, packed, bk, dtype, lens, active, seed=0):
    kw = SPLIT_SHAPES[shape]
    c = tcfg(BASE).replace(hidden_size=kw["num_attention_heads"] * kw["head_dim"],
                           num_attention_heads=kw["num_attention_heads"],
                           num_key_value_heads=kw["num_key_value_heads"],
                           kv_cache_rope=rope_mode, kv_bits=4 if packed else 8,
                           kv_cache_pack=packed)
    assert c.head_dim == kw["head_dim"]
    rng = np.random.default_rng(seed)
    b, S, hd, kvh = len(lens), 4 * bk, c.head_dim, c.kv_heads
    G = c.num_attention_heads // kvh
    hdc = hd // 2 if packed else hd
    ct = torch.bfloat16 if dtype == torch.bfloat16 else torch.float32
    if packed:
        ints = lambda: torch.from_numpy(rng.integers(0, 256, (b, kvh, hdc, S)).astype(np.uint8))  # noqa: E731
    else:
        ints = lambda: torch.from_numpy(rng.integers(-127, 128, (b, kvh, hdc, S)).astype(np.int8))  # noqa: E731
    scales = lambda: torch.from_numpy((rng.random((b, S)) * 0.02 + 0.005).astype(np.float32))  # noqa: E731
    layer = (ints(), scales(), ints(), scales())
    q4 = torch.from_numpy(rng.normal(0, 2.0, (b, kvh, G, hd)).astype(np.float32)).to(ct).float()
    k_int = torch.from_numpy(rng.integers(-127, 128, (b, kvh * hd)).astype(np.int8))
    v_int = torch.from_numpy(rng.integers(-127, 128, (b, kvh * hd)).astype(np.int8))
    k_inv = torch.from_numpy((rng.random((b, 1)) * 0.05 + 0.01).astype(np.float32))
    v_inv = torch.from_numpy((rng.random((b, 1)) * 0.05 + 0.01).astype(np.float32))
    lens_t = torch.tensor(lens, dtype=torch.int32)
    qcos, qsin = llama_rope(lens_t, hd, c.rope_theta)
    kcos, ksin = TMK._cache_rope_tables(S, hd, c.rope_theta, "cpu")
    args = (q4, k_int, v_int, k_inv, v_inv, layer, kcos, ksin, qcos, qsin, lens_t,
            torch.tensor(active), c, bk, dtype)
    return TMK._attend_plain(*args), split_attention(*args)


def llama_rope(lens, hd, theta):
    from llm_qat_torch.models import llama
    cos, sin = llama.rope_cos_sin(lens[:, None], hd, theta)
    return cos[:, 0, :hd // 2].contiguous(), sin[:, 0, :hd // 2].contiguous()


@pytest.mark.parametrize("shape", list(SPLIT_SHAPES))
@pytest.mark.parametrize("rope_mode,packed", [("pre", False), ("post", False), ("pre", True),
                                               ("post", True)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_split_attention_equals_the_sequential_walk(shape, rope_mode, packed, dtype):
    """Lengths 0, 1, BK - 1, BK, BK + 1 and S at BK = 256 (two chunks a
    block), one inactive slot and one empty inactive slot: the split gives
    the online softmax's bits."""
    bk = 256
    lens = [0, 1, bk - 1, bk, bk + 1, 4 * bk, 300, 0]
    active = [True, True, True, False, True, True, True, False]
    want, got = _split_case(shape, rope_mode, packed, bk, dtype, lens, active)
    assert torch.equal(got, want)


@pytest.mark.parametrize("bk", [16, 128, 512])
def test_split_attention_block_and_chunk_edges(bk):
    """A block narrower than a chunk (the chunk shrinks to the block), one
    chunk a block, four chunks a block."""
    lens = [bk - 1, bk, 2 * bk + 5, 4 * bk, 1]
    want, got = _split_case("g1_d128", "pre", False, bk, torch.bfloat16, lens, [True] * 5, seed=4)
    assert torch.equal(got, want)


@pytest.mark.parametrize("w_bits", [8, 4])
def test_card_weights_are_the_k_contiguous_integers(w_bits):
    """The kernel's copy, its tiles put back in place, is the transposition
    of the JAX-layout integers (W8); at W4 its bytes unpack, along K, to
    QM.unpack_int4 of the JAX layout. It is made once, made again for other
    layer tensors, and refused off the kernel's tile grid."""
    cfg = BASE.replace(w_bits=w_bits, hidden_size=256, intermediate_size=512,
                       num_attention_heads=2, num_key_value_heads=2, num_hidden_layers=2)
    _, tq = both_qparams(cfg)
    card = TMK.card_weights(tq)
    assert TMK.card_weights(tq) is card
    for name in ("qkv", "o", "gateup", "down"):
        q = tq["layers"][name]["q"]
        assert card[name].is_contiguous() and card[name].shape[-2] == 128
        got = TMK.untile(card[name])
        assert got.shape == (q.shape[0], q.shape[2], q.shape[1])
        if w_bits == 8:
            assert torch.equal(got, q.transpose(1, 2))
        else:
            assert torch.equal(QM.unpack_int4(got, -1), QM.unpack_int4(q, -2).transpose(1, 2))
    cut = dict(tq, layers={k: ({kk: vv[:1] for kk, vv in v.items()} if isinstance(v, dict)
                               else v[:1]) for k, v in tq["layers"].items()})
    assert TMK.card_weights(cut)["qkv"].shape[0] == 1
    _, small = both_qparams(BASE.replace(w_bits=w_bits))
    with pytest.raises(ValueError, match="tile"):
        TMK.card_weights(small)


CARD_GRID = {
    "tinyllama": (JC.TINYLLAMA_1B, True),
    "llama7b": (JC.LLAMA_7B, True),
    "llama13b": (JC.LLAMA_13B, True),
    "g4_d64": (JC.TINYLLAMA_1B.replace(num_key_value_heads=8), False),
    "g2_d128": (JC.LLAMA_7B.replace(num_key_value_heads=16), False),
    "off_grid": (JC.LLAMA_7B.replace(intermediate_size=11000), False),
}


@pytest.mark.parametrize("name", list(CARD_GRID))
@pytest.mark.parametrize("w_bits,kv_bits", [(8, 8), (4, 4)])
def test_card_takes_the_shapes_it_is_built_for(name, w_bits, kv_bits):
    """(8, 64) at TinyLlama-1.1B's widths, (1, 128) at LLaMA-7B's and 13B's;
    not (4, 64), (2, 128), or an intermediate size off the 256 grid."""
    base, takes = CARD_GRID[name]
    cfg = tcfg(base.replace(w_bits=w_bits, a_bits=8, kv_bits=kv_bits,
                            kv_cache_pack=kv_bits == 4))
    assert TMK.card_takes(cfg, 8, 2048, torch.bfloat16) == takes
    assert TMK.supported(cfg, 8, 2048)
