"""Port parity: beam search over the serving cache
(llm_qat_torch.inference.beam) against the JAX package's, on the CPU.

The same numpy weights are quantized by both packages (scan serving path:
``use_megakernel=False``; the JAX decode kernel runs in interpret mode) and
the same prompts are beam-decoded in float32. Limits: tokens equal, the
normalized score at 1e-5 relative (float32 logits agree to ~1e-6; the
serving tests hold them at 1e-4), over JAX's own ``eos_id`` x
``length_penalty`` cases (``tests/test_beam.py``), at W8A8KV8 and at
W4A8KV4 with the nibble-packed cache. ``num_beams=1`` gives the engine's
greedy tokens. Ties: ``jax.lax.top_k`` puts the lower index first, and the
port's search is held to that on logits made of ties, from step 0 (where
every row holds the same logits), through a forward of fixed logit rows
given to both packages' search loops.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_qat_tpu.inference import beam as JB
from llm_qat_tpu.models.config import TINY_TEST
from llm_qat_torch.inference import beam as TB
from llm_qat_torch.inference import engine as TE
from llm_qat_torch.inference import model as TM

from tests.test_torch_serving import both_qparams, tcfg

SCORE_REL = 1e-5
BASE = TINY_TEST.replace(w_bits=8, a_bits=8, kv_bits=8, use_megakernel=False)
MODES = {"w8a8kv8": BASE, "w4a8kv4_packed": BASE.replace(w_bits=4, kv_bits=4)}
PROMPT = [5, 9, 2, 14]


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("eos_id,lp", [(None, 1.0), (3, 1.0), (3, 0.7)])
def test_beam_matches_jax(mode, eos_id, lp):
    cfg = MODES[mode]
    jq, tq = both_qparams(cfg)
    kw = dict(num_beams=3, max_new_tokens=6, eos_id=eos_id, length_penalty=lp)
    want_toks, want_score = JB.beam_generate(jq, cfg, PROMPT, dtype=jnp.float32, **kw)
    got_toks, got_score = TB.beam_generate(tq, tcfg(cfg), PROMPT, dtype=torch.float32,
                                           device="cpu", **kw)
    assert isinstance(got_toks, np.ndarray) and isinstance(got_score, float)
    assert list(got_toks) == list(want_toks)
    np.testing.assert_allclose(got_score, want_score, rtol=SCORE_REL)


@pytest.mark.parametrize("mode", list(MODES))
def test_beam_long_prompt_and_eos_hit_match_jax(mode):
    """A 40-token prompt (bucket 64, cache of 128), 4 beams, 10 steps, with
    EOS set to a token the search meets: the finished pool decides."""
    cfg = MODES[mode]
    jq, tq = both_qparams(cfg, seed=1)
    prompt = list(map(int, np.random.default_rng(2).integers(1, cfg.vocab_size, 40)))
    free, _ = TB.beam_generate(tq, tcfg(cfg), prompt, num_beams=4, max_new_tokens=10,
                               dtype=torch.float32, device="cpu")
    kw = dict(num_beams=4, max_new_tokens=10, eos_id=int(free[2]), length_penalty=1.0)
    want_toks, want_score = JB.beam_generate(jq, cfg, prompt, dtype=jnp.float32, **kw)
    got_toks, got_score = TB.beam_generate(tq, tcfg(cfg), prompt, dtype=torch.float32,
                                           device="cpu", **kw)
    assert list(got_toks) == list(want_toks)
    np.testing.assert_allclose(got_score, want_score, rtol=SCORE_REL)


@pytest.mark.parametrize("mode", list(MODES))
def test_beam1_equals_greedy(mode):
    """``num_beams=1`` is greedy decode: the engine's tokens on the scan path
    (and JAX's one-beam search)."""
    cfg = MODES[mode]
    jq, tq = both_qparams(cfg)
    prompt = [1, 2, 3]
    toks, _ = TB.beam_generate(tq, tcfg(cfg), prompt, num_beams=1, max_new_tokens=5,
                               dtype=torch.float32, device="cpu")
    eng = TE.InferenceEngine(tq, tcfg(cfg), max_batch=2, max_len=64, dtype=torch.float32,
                             device="cpu")
    eng.submit(prompt, max_new_tokens=5)
    greedy = eng.run()[0].output
    assert list(toks) == list(greedy)
    want, _ = JB.beam_generate(jq, cfg, prompt, num_beams=1, max_new_tokens=5,
                               dtype=jnp.float32)
    assert list(toks) == list(want)


@pytest.mark.parametrize("mode", list(MODES))
def test_reorder_cache_gathers_fresh_rows(mode):
    """Rows gathered on the batch axis (K/V ``[L, b, ...]``, lengths ``[b]``)
    into new tensors: writing one beam's row touches neither the source
    cache nor the beam that came from the same parent."""
    cfg = tcfg(MODES[mode])
    cache = TM.init_serving_cache(cfg, 3, 8, device="cpu")
    assert cache["k_q"].dtype == (torch.uint8 if mode.endswith("packed") else torch.int8)
    cache["lengths"] = torch.tensor([1, 2, 3], dtype=torch.int32)
    for k in ("k_q", "v_q"):
        cache[k][:, 1] = 7
    cache["k_s"][:, 1] = 0.5
    out = TB.reorder_cache(cache, torch.tensor([1, 1, 0]))
    assert (out["k_q"][:, 0] == 7).all() and (out["k_q"][:, 1] == 7).all()
    assert (out["v_q"][:, 2] == 0).all() and (out["k_s"][:, :2] == 0.5).all()
    assert out["lengths"].tolist() == [2, 2, 1] and out["lengths"].dtype == torch.int32
    for k in cache:
        assert out[k].untyped_storage().data_ptr() != cache[k].untyped_storage().data_ptr()
    out["k_q"][:, 0] = 9
    assert (out["k_q"][:, 1] == 7).all() and (cache["k_q"][:, 1] == 7).all()


def _tied_forward(table):
    """Both packages' ``fwd``: the next logits are the row of ``table`` of the
    token just taken (every entry one of a few values, so most tie)."""
    jt, tt = jnp.asarray(table), torch.from_numpy(table)

    def jfwd(qparams, ids, lens, active, cache):
        return jt[ids[:, 0]][:, None], dict(cache, lengths=cache["lengths"] + 1)

    def tfwd(qparams, ids, lens, active, cache):
        return tt[ids[:, 0].long()][:, None], dict(cache, lengths=cache["lengths"] + 1)

    return jfwd, tfwd


@pytest.mark.parametrize("B,V", [(2, 6), (3, 5), (2, 3)])
@pytest.mark.parametrize("eos_id,lp", [(None, 1.0), (1, 1.0), (1, 0.7)])
@pytest.mark.parametrize("rows", ["same", "mixed"])
def test_ties_resolve_as_jax_top_k(B, V, eos_id, lp, rows):
    """Row 0 of the logit table (the prompt's logits) has its maximum at
    every odd token. At step 0 every beam row holds those logits, beams 1..
    at -1e30 + logp, which ties them all, and at V = 3 the 2B candidates
    reach into them. ``same``: every row is row 0, so every hypothesis ties
    with others at every step and the answer is decided by the tie order
    alone; ``mixed``: the other rows are random from three values. The
    search takes the lower index first among ties, as ``jax.lax.top_k``: the
    same tokens, lengths and scores."""
    rng = np.random.default_rng(B * 10 + V)
    table = rng.integers(0, 3, (V, V)).astype(np.float32)
    table[0] = 1.0
    table[0, 1::2] = 2.0
    if rows == "same":
        table[1:] = table[0]
    jfwd, tfwd = _tied_forward(table)
    jcache = {k: jnp.zeros((1, B, 1, 1, 1), jnp.int8) for k in ("k_q", "v_q")}
    jcache.update({k: jnp.ones((1, B, 1), jnp.float32) for k in ("k_s", "v_s")},
                  lengths=jnp.zeros((B,), jnp.int32))
    tcache = {k: torch.from_numpy(np.array(v)) for k, v in jcache.items()}
    T = 5
    wt, ws, wl = JB._beam_scan(jfwd, None, jnp.asarray(table[0]), jcache, B, T, eos_id, lp)
    gt, gs, gl = TB._beam_loop(tfwd, None, torch.from_numpy(table[0]), tcache, B, T, eos_id,
                               lp)
    np.testing.assert_array_equal(gt.numpy(), np.asarray(wt))
    np.testing.assert_array_equal(gl.numpy(), np.asarray(wl))
    np.testing.assert_allclose(gs.numpy(), np.asarray(ws), rtol=SCORE_REL)


def test_top_k_takes_the_lower_index_among_ties():
    vals, idx = TB._top_k(torch.tensor([1.0, 2.0, 2.0, 0.0, 2.0, -1e30, -1e30]), 5)
    assert idx.tolist() == [1, 2, 4, 0, 3] and vals.tolist() == [2.0, 2.0, 2.0, 1.0, 0.0]
    _, idx = TB._top_k(torch.full((6,), -1e30), 3)
    assert idx.tolist() == [0, 1, 2]


def test_beam_needs_the_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is available")
    _, tq = both_qparams(BASE)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TB.beam_generate(tq, tcfg(BASE), PROMPT, num_beams=2, max_new_tokens=2)
