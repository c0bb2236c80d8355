"""Port parity: the multi-host serving driver
(``llm_qat_torch.inference.multihost``) on gloo ranks spawned on the CPU,
against the JAX package's one-device engine (its ``tests/test_multihost.py``
holds its own driver to the same reference; that test is ``slow``).

World 4 as 2 hosts x tp 2 (``local_size=2``): each host serves exactly the
requests it owns (uid round-robin), the two hosts together every request
once, each with the one-device engine's greedy tokens, and the two ranks of a
host emit the same tokens. World 2 as 2 hosts x tp 1: the same, through
``quantize_params``; then a stream that one rank submits differently raises
on every rank at drain. A tp larger than a host raises JAX's ValueError.
Weights and prompts are the JAX test's shapes (``TINY_TEST`` with 4 kv heads,
W8A8KV8, prompts of 5, 9, 7 and 12 tokens, 6 new tokens), from numpy.

The ranks import this module, so JAX is imported inside the reference
functions only.
"""

import numpy as np
import pytest
import torch

from llm_qat_torch.parallel import launch

NEW_TOKENS = 6


def _prompts(vocab):
    rng = np.random.default_rng(11)
    return [list(map(int, rng.integers(1, vocab, n))) for n in (5, 9, 7, 12)]


def _driver_rank(rank, world, cfg, params, local_size, diverge):
    from llm_qat_torch.inference.multihost import MultiHostServingDriver
    from llm_qat_torch.models import params as TP

    p = TP.from_numpy(params, "cpu")
    kw = dict(max_batch=2, max_len=64, steps_per_sync=4, dtype=torch.float32,
              local_size=local_size, device="cpu")
    out = {}
    try:
        MultiHostServingDriver(p, cfg, tp=2 * local_size, **kw)
    except ValueError as e:
        out["too_wide"] = str(e)
    drv = MultiHostServingDriver(p, cfg, **kw)
    out["host"], out["hosts"] = drv.process_index, drv.process_count
    prompts = _prompts(cfg.vocab_size)
    uids = [drv.submit(q, max_new_tokens=NEW_TOKENS) for q in prompts]
    out["owners"] = {u: drv.owner(u) for u in uids}
    out["served"] = {r.uid: [int(t) for t in r.output] for r in drv.run()}
    if diverge:
        drv = MultiHostServingDriver(p, cfg, **kw)
        for i, q in enumerate(prompts):
            drv.submit(q + [1] if rank == 1 and i == 2 else q, max_new_tokens=NEW_TOKENS)
        try:
            drv.run()
        except RuntimeError as e:
            out["diverged"] = str(e)
    return out


def _reference(jcfg, params):
    """The JAX package's one-device engine on the same prompts."""
    import jax
    import jax.numpy as jnp

    from llm_qat_tpu.inference import quantized as JQ
    from llm_qat_tpu.inference.engine import InferenceEngine

    eng = InferenceEngine(JQ.quantize_params(jax.tree.map(jnp.asarray, params), jcfg), jcfg,
                          max_batch=2, max_len=64, steps_per_sync=4, dtype=jnp.float32)
    uids = [eng.submit(p, max_new_tokens=NEW_TOKENS) for p in _prompts(jcfg.vocab_size)]
    out = {r.uid: [int(t) for t in r.output] for r in eng.run()}
    return [out[u] for u in uids]


@pytest.mark.parametrize("world,local_size", [(4, 2), (2, 1)])
def test_driver_partitions_requests_with_one_device_tokens(world, local_size):
    from llm_qat_tpu.models.config import TINY_TEST
    from tests.test_torch_serving import np_params, tcfg

    jcfg = TINY_TEST.replace(w_bits=8, a_bits=8, kv_bits=8, num_key_value_heads=4)
    params = np_params(jcfg)
    ranks = launch.spawn(_driver_rank, world, args=(tcfg(jcfg), params, local_size,
                                                     local_size == 1), timeout=240)
    want = _reference(jcfg, params)
    hosts = world // local_size
    served = {}
    for rank, r in enumerate(ranks):
        assert (r["host"], r["hosts"]) == (rank // local_size, hosts)
        assert "exceeds" in r["too_wide"] and "local devices" in r["too_wide"]
        assert r["owners"] == {u: u % hosts for u in range(4)}
        assert sorted(r["served"]) == [u for u in range(4) if u % hosts == r["host"]]
        for u, toks in r["served"].items():
            assert toks == want[u], (rank, u)
        served.setdefault(r["host"], r["served"])
        assert r["served"] == served[r["host"]]      # the ranks of a host agree
    assert sorted(u for s in served.values() for u in s) == [0, 1, 2, 3]
    if local_size == 1:
        for r in ranks:
            assert "request streams diverged" in r["diverged"]
