"""Port parity: evaluation (llm_qat_torch.eval.perplexity and
llm_qat_torch.eval.zero_shot) against the JAX package's, on the CPU.

The same numpy weights (``np_params``) and the same documents
(``zero_shot.random_docs``, each task's field layout from a seed) go through
both packages; JAX's flash kernel runs in interpret mode.

Limits:
- perplexity: ``eval_loss`` at 1e-5 relative in float32; in bf16 compute at
  ``BF16_LOSS_REL`` relative, with JAX compiled without excess precision
  (its jit swapped for one that compiles so), as the port's other bf16
  cases are held;
- adapters: every ``MCExample`` token for token and field for field;
- scorer: summed log-probs at ``SCORE_REL`` = 1e-5 relative in float32 (the
  forward's summation orders only). Where the two packages' argmax differ
  (``acc`` / ``acc_norm`` on a near tie), the example's two best scores must
  lie within that tolerance of each other (``_hold_scores``); the accuracies
  are then allowed to differ by those examples and no more.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_qat_tpu.eval import perplexity as JP
from llm_qat_tpu.eval import zero_shot as JZ
from llm_qat_tpu.models.config import TINY_TEST
from llm_qat_torch.eval import perplexity as TP_
from llm_qat_torch.eval import zero_shot as TZ
from llm_qat_torch.models import params as TP

from tests.test_torch_serving import np_params, tcfg

SCORE_REL = 1e-5
BF16_LOSS_REL = 2e-3
CONFIGS = {"fp": TINY_TEST, "w8a8kv8": TINY_TEST.replace(w_bits=8, a_bits=8, kv_bits=8),
           "w4a8kv4": TINY_TEST.replace(w_bits=4, a_bits=8, kv_bits=4)}
TASKS = list(TZ.TASK_ADAPTERS)


def fake_tokenize(text):
    return [ord(c) % 251 for c in text]


def _tree(fn, node):
    return {k: _tree(fn, v) for k, v in node.items()} if isinstance(node, dict) else fn(node)


def _both(cfg, seed=0):
    p = np_params(cfg, seed)
    return _tree(jnp.asarray, p), TP.from_numpy(p, "cpu")


def _strict_jit(fn):
    """``jax.jit`` with XLA's excess precision off (bf16 rounds as written)."""
    jitted = jax.jit(fn)
    return lambda *a: jitted.lower(*a).compile(
        compiler_options={"xla_allow_excess_precision": False})(*a)


def _hold_scores(got, want):
    """Summed log-probs ``[n, choices]`` at SCORE_REL; each example whose
    argmax (raw or per-token) parts has its two best within that tolerance."""
    finite = np.isfinite(want)
    assert (np.isfinite(got) == finite).all()
    np.testing.assert_allclose(got[finite], want[finite], rtol=SCORE_REL, atol=0)
    parted = np.nonzero(got.argmax(-1) != want.argmax(-1))[0]
    for e in parted:
        top2 = np.sort(want[e][finite[e]])[-2:]
        assert top2[1] - top2[0] <= SCORE_REL * abs(top2[1]), (e, want[e], got[e])
    return parted


# ---------------------------------------------------------------------------
# perplexity
# ---------------------------------------------------------------------------


def _ppl_batches(cfg):
    rng = np.random.default_rng(3)
    return [{"input_ids": rng.integers(0, cfg.vocab_size, shape).astype(np.int32)}
            for shape in ((2, 16), (1, 16), (3, 32), (2, 10))]


@pytest.mark.parametrize("name", list(CONFIGS))
def test_perplexity_matches_jax(name):
    """Batches of 2, 1 and 3 rows (16 and 32 columns take the flash path, 10
    the score matrix): JAX's mean of per-batch means, not a token-weighted
    one."""
    cfg = CONFIGS[name]
    jp, tp = _both(cfg)
    batches = _ppl_batches(cfg)
    want = JP.evaluate_perplexity(jp, cfg, batches, compute_dtype=jnp.float32)
    got = TP_.evaluate_perplexity(tp, tcfg(cfg), batches, compute_dtype=torch.float32)
    assert set(got) == {"eval_loss", "perplexity"}
    np.testing.assert_allclose(got["eval_loss"], want["eval_loss"], rtol=1e-5)
    np.testing.assert_allclose(got["perplexity"], np.exp(got["eval_loss"]), rtol=1e-12)
    per_batch = [TP_.evaluate_perplexity(tp, tcfg(cfg), [b], compute_dtype=torch.float32)
                 ["eval_loss"] for b in batches]
    np.testing.assert_allclose(got["eval_loss"], np.mean(per_batch), rtol=1e-12)
    weights = [b["input_ids"].shape[0] * (b["input_ids"].shape[1] - 1) for b in batches]
    assert abs(got["eval_loss"] - np.average(per_batch, weights=weights)) > 1e-6


def test_perplexity_bf16_matches_jax(monkeypatch):
    cfg = CONFIGS["w4a8kv4"]
    jp, tp = _both(cfg)
    batches = _ppl_batches(cfg)
    monkeypatch.setattr(JP, "jax", types.SimpleNamespace(jit=_strict_jit))
    want = JP.evaluate_perplexity(jp, cfg, batches, compute_dtype=jnp.bfloat16)
    got = TP_.evaluate_perplexity(tp, tcfg(cfg), batches, compute_dtype=torch.bfloat16)
    np.testing.assert_allclose(got["eval_loss"], want["eval_loss"], rtol=BF16_LOSS_REL)


def test_perplexity_of_no_batches_is_nan():
    cfg = CONFIGS["fp"]
    _, tp = _both(cfg)
    got = TP_.evaluate_perplexity(tp, tcfg(cfg), [], compute_dtype=torch.float32)
    assert np.isnan(got["eval_loss"]) and np.isnan(got["perplexity"])


# ---------------------------------------------------------------------------
# task adapters
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("task", TASKS)
def test_adapters_give_jax_examples(task):
    docs = TZ.random_docs(task, 16, seed=1)
    assert TZ.TASK_ADAPTERS[task].__name__ == JZ.TASK_ADAPTERS[task].__name__
    for d in docs:
        got = TZ.TASK_ADAPTERS[task](d, fake_tokenize)
        want = JZ.TASK_ADAPTERS[task](d, fake_tokenize)
        assert list(got.context) == list(want.context)
        assert [list(c) for c in got.choices] == [list(c) for c in want.choices]
        assert got.gold == want.gold and got.ctx_lens == want.ctx_lens


def test_adapters_boundary_rule_and_preprocessing_match_jax():
    """A tokenizer that merges at the context / choice boundary (lm-eval's
    rule takes the suffix of the whole, else the choice alone), hellaswag's
    tag cleanup and winogrande's longest-common-prefix alignment."""
    def merging(text):        # "r " merges into one token
        out, i = [], 0
        while i < len(text):
            if text[i:i + 2] == "r ":
                out.append(250)
                i += 2
            else:
                out.append(ord(text[i]) % 250)
                i += 1
        return out

    docs = {
        "piqa": {"goal": "stir", "sol1": "x", "sol2": "pour", "label": 1},
        "hellaswag": {"activity_label": "Cooking", "ctx_a": "He stirs.", "ctx_b": "then",
                      "endings": ["eats [step] fast", "x [title] y", "a  b", "z"],
                      "label": "0"},
        "winogrande": {"sentence": "the _ ran home", "option1": "otter", "option2": "cat",
                       "answer": "1"},
        "obqa": {"question_stem": "water", "choices": {"label": ["A", "B"],
                                                       "text": ["r", "cold"]},
                 "answerKey": "A"},
    }
    for task, d in docs.items():
        for tok in (fake_tokenize, merging):
            got, want = TZ.TASK_ADAPTERS[task](d, tok), JZ.TASK_ADAPTERS[task](d, tok)
            assert (list(got.context), [list(c) for c in got.choices], got.gold,
                    got.ctx_lens) == (list(want.context), [list(c) for c in want.choices],
                                      want.gold, want.ctx_lens), task
    for text in (" a [title] b [x]  c ", "x [step] y", "[header] Cut [title]  it."):
        assert TZ._hellaswag_preprocess(text) == JZ._hellaswag_preprocess(text)


def test_random_docs_are_seeded_and_cover_every_task():
    for task in TASKS:
        a, b = TZ.random_docs(task, 4, seed=2), TZ.random_docs(task, 4, seed=2)
        assert a == b and a != TZ.random_docs(task, 4, seed=3)
        for d in a:
            TZ.TASK_ADAPTERS[task](d, fake_tokenize)
    with pytest.raises(KeyError, match="unknown task"):
        TZ.random_docs("mmlu", 1)


# ---------------------------------------------------------------------------
# scorer
# ---------------------------------------------------------------------------


def _examples(cfg, n=6, seed=0):
    """Mixed-length shared-context examples and per-choice-context ones."""
    rng = np.random.default_rng(seed)
    exs = []
    for i in range(n):
        ctx = list(map(int, rng.integers(1, cfg.vocab_size, 3 + 11 * (i % 4))))
        choices = [list(map(int, rng.integers(1, cfg.vocab_size, 2 + (i + c) % 3)))
                   for c in range(2 + i % 3)]
        exs.append((ctx, choices, i % 2, None))
    for i in range(2):
        ctxs = [list(map(int, rng.integers(1, cfg.vocab_size, 4 + 3 * c))) for c in range(2)]
        suffix = list(map(int, rng.integers(1, cfg.vocab_size, 5)))
        exs.append(([], [c + suffix for c in ctxs], i, [len(c) for c in ctxs]))
    return exs


@pytest.mark.parametrize("name", list(CONFIGS))
@pytest.mark.parametrize("batch_rows,max_len", [(16, None), (3, None), (4, 40)])
def test_score_examples_matches_jax(name, batch_rows, max_len):
    """Shared and per-choice contexts, rows of 5 to 45 tokens sorted into
    pow2 buckets (32, 64), short last batches, and a 40-token cap that cuts
    the longest rows (a bucket that is no power of two)."""
    cfg = CONFIGS[name]
    jp, tp = _both(cfg, seed=1)
    raw = _examples(cfg)
    jex = [JZ.MCExample(*e) for e in raw]
    tex = [TZ.MCExample(*e) for e in raw]
    kw = dict(batch_rows=batch_rows, max_len=max_len, return_scores=True)
    want = JZ.score_examples(jp, cfg, jex, compute_dtype=jnp.float32, **kw)
    got = TZ.score_examples(tp, tcfg(cfg), tex, compute_dtype=torch.float32, **kw)
    assert got["n"] == want["n"] == len(raw)
    parted = _hold_scores(got["scores"], np.asarray(want["scores"]))
    for key in ("acc", "acc_norm"):
        assert abs(got[key] - want[key]) * len(raw) <= len(parted), key


def test_score_examples_bf16_matches_jax(monkeypatch):
    """bf16 compute, JAX compiled without excess precision: the summed
    log-probs at 1e-2 relative (bf16 activations)."""
    cfg = CONFIGS["w8a8kv8"]
    jp, tp = _both(cfg, seed=1)
    raw = _examples(cfg)
    monkeypatch.setattr(JZ, "jax", types.SimpleNamespace(jit=_strict_jit, nn=jax.nn))
    want = JZ.score_examples(jp, cfg, [JZ.MCExample(*e) for e in raw], batch_rows=4,
                             compute_dtype=jnp.bfloat16, return_scores=True)
    got = TZ.score_examples(tp, tcfg(cfg), [TZ.MCExample(*e) for e in raw], batch_rows=4,
                            compute_dtype=torch.bfloat16, return_scores=True)
    w = np.asarray(want["scores"])
    finite = np.isfinite(w)
    np.testing.assert_allclose(got["scores"][finite], w[finite], rtol=1e-2)


def test_score_examples_pads_the_last_batch_with_zero_rows(monkeypatch):
    """Every batch is ``[batch_rows, bucket]``: a short last batch's tail
    rows are all zero (ids, padding mask and target mask), as in JAX."""
    cfg = tcfg(CONFIGS["fp"])
    _, tp = _both(CONFIGS["fp"])
    seen = []
    real = TZ.row_logprobs

    def spy(params, config, ids, attn, tmask, compute_dtype):
        seen.append((ids.clone(), attn.clone(), tmask.clone()))
        return real(params, config, ids, attn, tmask, compute_dtype)

    monkeypatch.setattr(TZ, "row_logprobs", spy)
    exs = [TZ.MCExample([1, 2, 3], [[4], [5, 6]], 0), TZ.MCExample([7] * 40, [[8]], 0)]
    TZ.score_examples(tp, cfg, exs, batch_rows=2, compute_dtype=torch.float32)
    assert [tuple(s[0].shape) for s in seen] == [(2, 32), (2, 64)]
    ids, attn, tmask = seen[1]
    assert not ids[1].any() and not attn[1].any() and not tmask[1].any()
    assert attn[0].sum() == 41 and tmask[0].sum() == 1


@pytest.mark.parametrize("task", TASKS)
def test_evaluate_task_matches_jax(task):
    """Every task end to end (adapter, scorer, acc / acc_norm) on the
    W4A8KV4 model, 6 documents each, under a 64-token cap."""
    cfg = CONFIGS["w4a8kv4"]
    jp, tp = _both(cfg, seed=2)
    docs = TZ.random_docs(task, 6, seed=4, max_words=10)
    kw = dict(batch_rows=8, max_len=64, return_scores=True)
    want = JZ.evaluate_task(jp, cfg, task, docs, fake_tokenize, compute_dtype=jnp.float32, **kw)
    got = TZ.evaluate_task(tp, tcfg(cfg), task, docs, fake_tokenize,
                           compute_dtype=torch.float32, **kw)
    golds = np.asarray([JZ.TASK_ADAPTERS[task](d, fake_tokenize).gold for d in docs])
    parted = _hold_scores(got["scores"], np.asarray(want["scores"]))
    assert got["n"] == want["n"] == len(docs)
    for key in ("acc", "acc_norm"):
        assert abs(got[key] - want[key]) * len(docs) <= len(parted), key
    np.testing.assert_allclose(got["acc"], np.mean(got["scores"].argmax(-1) == golds))
