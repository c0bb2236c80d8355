"""Port parity for the paged engine: llm_qat_torch.inference.paged_engine
against the JAX package's PagedInferenceEngine, on CPU, float32, greedy.

Params come from a numpy seed and go to both packages (as in
tests/test_torch_serving.py). Greedy tokens must be EQUAL: between the two
packages, between the paged and the contiguous engine, and between a run
with preemption (tight pool) and one without. One JAX engine (a roomy pool)
is built for the module and reused: every engine of the JAX package compiles
its decode chunk anew.
"""

import jax.numpy as jnp
import pytest
import torch

from llm_qat_tpu.inference import paged as JPG
from llm_qat_tpu.inference import paged_engine as JPE
from llm_qat_tpu.models.config import TINY_TEST as J_TINY
from llm_qat_torch.inference import engine as TE
from llm_qat_torch.inference import paged as TPG
from llm_qat_torch.inference import paged_engine as TPE

from test_torch_serving import both_qparams, tcfg

CFG = J_TINY.replace(w_bits=8, a_bits=8, kv_bits=8)
PROMPTS = [[5, 9, 3], [7, 7], [1, 2, 3, 4]]


@pytest.fixture(scope="module")
def qparams():
    return both_qparams(CFG)


@pytest.fixture(scope="module")
def jax_engine(qparams):
    pcfg = JPG.PagedConfig(page_size=8, n_pages=32, max_pages_per_seq=8)
    return JPE.PagedInferenceEngine(qparams[0], CFG, pcfg=pcfg, max_batch=2,
                                    dtype=jnp.float32)


def _paged(tq, n_pages=32, max_batch=2, **kw):
    pcfg = TPG.PagedConfig(page_size=8, n_pages=n_pages, max_pages_per_seq=8)
    return TPE.PagedInferenceEngine(tq, tcfg(CFG), pcfg=pcfg, max_batch=max_batch,
                                    dtype=torch.float32, device="cpu", **kw)


def _run(eng, prompts, n):
    uids = [eng.submit(p, max_new_tokens=n) for p in prompts]
    done = {r.uid: r.output for r in eng.run()}
    return [[int(t) for t in done[u]] for u in uids]


def test_paged_engine_matches_jax_and_the_contiguous_engine(qparams, jax_engine):
    """Three requests through two slots (queueing, a slot reused)."""
    want = _run(jax_engine, PROMPTS, 5)
    pe = _paged(qparams[1])
    total = pe.alloc.available
    got = _run(pe, PROMPTS, 5)
    assert got == want
    assert pe.alloc.available == total and not pe.lengths.any()
    ce = TE.InferenceEngine(qparams[1], tcfg(CFG.replace(use_megakernel=False)),
                            max_batch=2, max_len=64, dtype=torch.float32, device="cpu")
    assert _run(ce, PROMPTS, 5) == got


def test_pages_released_after_completion(qparams):
    pe = _paged(qparams[1])
    total = pe.alloc.available
    assert total == 31                       # the last page is scratch
    pe.submit([1, 2, 3], max_new_tokens=4)
    pe.submit([4, 5], max_new_tokens=4)
    done = pe.run()
    assert len(done) == 2 and all(len(r.output) == 4 for r in done)
    assert pe.alloc.available == total       # everything returned to the pool
    assert not pe._tables.any() and all(p == [] for p in pe.slot_pages)


LONG = [list(range(3, 17)), list(range(40, 55))]     # 14 and 15 tokens: 2 pages each


@pytest.mark.parametrize("prompts,n_pages,preempts", [
    ([[5, 9, 3], [1, 2, 3, 4]], 7, False),
    (LONG, 6, True),
], ids=["short_prompts_6_pages", "long_prompts_5_pages"])
def test_tight_pool_gives_the_roomy_tokens(qparams, jax_engine, monkeypatch,
                                           prompts, n_pages, preempts):
    """A tight pool must give the unconstrained run's tokens (greedy is
    deterministic whatever the scheduling, the recompute after a preemption
    included), which are the JAX package's, and return every page. The first
    case is the JAX suite's own "preemption under pressure" (6 usable pages):
    its two requests take 2 pages each at admission and never grow past
    them, so nothing is preempted there. The second forces it: both slots
    need a third page in the first chunk and 5 usable pages hold only one."""
    want = _run(jax_engine, prompts, 10)
    assert _run(_paged(qparams[1]), prompts, 10) == want

    tight = _paged(qparams[1], n_pages=n_pages)
    preempted = []
    real = tight._preempt_victim
    monkeypatch.setattr(tight, "_preempt_victim",
                        lambda skip: preempted.append(skip) or real(skip))
    assert _run(tight, prompts, 10) == want
    assert bool(preempted) == preempts
    assert tight.alloc.available == n_pages - 1


def test_pool_too_small_raises(qparams):
    pe = _paged(qparams[1], n_pages=2, max_batch=1)   # 1 usable page = 8 tokens
    pe.submit(list(range(1, 7)), max_new_tokens=16)
    with pytest.raises(MemoryError):
        pe.run()


def test_sequence_exceeding_block_table_rejected(qparams):
    """prompt + max_new beyond the per-sequence table capacity is REJECTED
    at submit (no silent truncation); a fitting request of the same prompt
    completes normally."""
    pe = _paged(qparams[1], n_pages=64, max_batch=1)  # 8 pages x 8 = 64 per sequence
    with pytest.raises(ValueError, match="does not fit"):
        pe.submit(list(range(1, 30)), max_new_tokens=60)
    pe.submit(list(range(1, 30)), max_new_tokens=30)
    done = pe.run()
    assert len(done) == 1 and len(done[0].output) == 30
    assert int(pe.lengths[0]) == 0           # slot freed
    assert pe.alloc.available == 63          # all pages returned


def test_eos_retires_a_request_and_sampling_stays_in_range(qparams):
    pe = _paged(qparams[1], seed=3)
    first = _run(_paged(qparams[1]), [[5, 9, 3]], 6)[0]
    uid = pe.submit([5, 9, 3], max_new_tokens=6, eos_id=first[2])
    hot = pe.submit([7, 7], max_new_tokens=6, temperature=0.8, top_k=5)
    done = {r.uid: r for r in pe.run()}
    assert done[uid].output == first[:first.index(first[2]) + 1]
    assert len(done[hot].output) == 6
    assert all(0 <= t < CFG.vocab_size for t in done[hot].output)
    assert pe.alloc.available == 31
