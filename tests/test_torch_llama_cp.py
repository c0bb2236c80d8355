"""Port parity: llm_qat_torch.models.llama_cp (the context-parallel forward,
the sequence split over a ring of gloo ranks spawned on the CPU) against the
JAX package's ``cp_forward`` on the suite's fake CPU devices, in float32 from
the same numpy weights and token ids.

Logits are held at 1e-4 (rtol and atol) and the gradients of a scalar of the
logits at a relative L2 of 1e-3 per leaf: the limits of
``tests/test_torch_llama_train.py`` for the single-device forward, at its
sizes (2 layers, b*s = 32 rows, where no int8 activation rounds differently
between XLA and torch). A rank's gradients are those of its chunk's part of
the scalar, summed over the ring as the trainer sums them. The single-device
forward of the port is held to the same limits (with ``kv_bits``' transport
off the ring adds only the merge's reassociation), and the int8 transport
against the fp transport the way the JAX package's test holds it.

The ranks import this module, so JAX is imported inside the reference
functions only.
"""

import numpy as np
import pytest
import torch

from llm_qat_torch.parallel import launch

LOGITS = dict(rtol=1e-4, atol=1e-4)
GRAD_REL_L2 = 1e-3
SCALE = 1e-3          # the differentiated scalar: SCALE * sum(logits ** 2)


def _jcfg(**kw):
    from llm_qat_tpu.models.config import TINY_TEST

    return TINY_TEST.replace(**kw)


def _setup(jcfg, seed, s=32):
    from tests.test_torch_serving import np_params, tcfg

    ids = np.random.default_rng(seed + 1).integers(0, jcfg.vocab_size, (1, s)).astype(np.int32)
    return tcfg(jcfg), np_params(jcfg, seed=seed), ids


def _leaves(tree, prefix=""):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _leaves(tree[k], f"{prefix}{k}/")
        else:
            yield prefix + k, tree[k]


def _cp_rank(rank, world, jobs):
    """For each job (cfg, params, ids, kw, with_grads): this rank's logits
    chunk and, with ``with_grads``, the gradients of its chunk's part of the
    scalar summed over the ring."""
    from llm_qat_torch.models import llama_cp
    from llm_qat_torch.models import params as TP
    from llm_qat_torch.parallel import comm, mesh as pmesh
    from llm_qat_torch.training.trainer import tree_leaves, tree_map

    mesh = pmesh.make_mesh(fsdp=1, cp=world)
    out = {}
    for name, (cfg, params, ids, kw, with_grads) in jobs.items():
        p = TP.from_numpy(params, "cpu")
        sl = ids.shape[1] // world
        chunk = torch.from_numpy(ids[:, rank * sl:(rank + 1) * sl].copy())
        if not with_grads:
            with torch.no_grad():
                out[name] = llama_cp.cp_forward(p, cfg, chunk, mesh, **kw).numpy(), None
            continue
        leaves = tree_leaves(p)
        for t in leaves:
            t.requires_grad_(True)
        logits = llama_cp.cp_forward(p, cfg, chunk, mesh, **kw)
        grads = iter(torch.autograd.grad(SCALE * (logits ** 2).sum(), leaves))
        grads = tree_map(lambda _: comm.all_reduce_(next(grads), pmesh.axis_group(mesh, "cp")),
                         p)
        out[name] = logits.detach().numpy(), tree_map(lambda g: g.numpy(), grads)
    return out


def _jobs():
    """Every cp forward the tests hold, by ring size and name."""
    jobs = {2: {}, 4: {}}
    for case, (bits, world, kw) in CASES.items():
        cfg, params, ids = _setup(_jcfg(**bits), seed=len(case))
        jobs[world][case] = (cfg, params, ids, kw, True)
    cfg, params, ids = _setup(_jcfg(w_bits=4, a_bits=8, kv_bits=4), seed=3)
    jobs[2]["single"] = (cfg, params, ids, dict(remat=True), True)
    cfg, params, ids = _setup(_jcfg(w_bits=32, a_bits=32, kv_bits=8), seed=6)
    jobs[4]["transport8"] = (cfg, params, ids, dict(ring_transport_bits=8), False)
    jobs[4]["transport_fp"] = (cfg, params, ids, dict(), False)
    return jobs


@pytest.fixture(scope="module")
def port():
    """The port's forwards: one spawn of each ring size runs its jobs; the
    ranks' logits chunks joined, rank 0's (summed) gradients."""
    out = {}
    for world, jobs in _jobs().items():
        ranks = launch.spawn(_cp_rank, world, args=(jobs,), timeout=180)
        for name in jobs:
            out[name] = (np.concatenate([r[name][0] for r in ranks], axis=1), ranks[0][name][1])
    return out


def _jax(world, jcfg, params, ids, kw, with_grads=True):
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from llm_qat_tpu.models import llama_cp

    mesh = Mesh(np.asarray(jax.devices()[:world]), ("cp",))
    jp = jax.tree.map(jnp.asarray, params)

    def loss(p):
        logits = llama_cp.cp_forward(p, jcfg, jnp.asarray(ids), mesh, **kw)
        return SCALE * jnp.sum(logits ** 2), logits

    if not with_grads:
        return np.asarray(jax.jit(loss)(jp)[1]), None
    (_, logits), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(jp)
    return np.asarray(logits), jax.tree.map(np.asarray, grads)


def _hold_grads(got, want):
    for (name, a), (_, b) in zip(_leaves(got), _leaves(want)):
        rel = np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)
        assert rel <= GRAD_REL_L2, (name, rel)


CASES = {
    "w4a8kv4_cp2": (dict(w_bits=4, a_bits=8, kv_bits=4), 2, dict()),
    "w4a8kv4_cp4": (dict(w_bits=4, a_bits=8, kv_bits=4), 4, dict()),
    "w8a8kv8_gqa_remat_cp4": (dict(w_bits=8, a_bits=8, kv_bits=8), 4, dict(remat=True)),
    "mha_cp2": (dict(w_bits=4, a_bits=8, kv_bits=4, num_key_value_heads=None), 2, dict()),
}


@pytest.mark.parametrize("case", list(CASES))
def test_cp_forward_and_grads_match_jax(port, case):
    bits, world, kw = CASES[case]
    jcfg = _jcfg(**bits)
    _, params, ids = _setup(jcfg, seed=len(case))
    got, gg = port[case]
    want, jg = _jax(world, jcfg, params, ids, kw)
    np.testing.assert_allclose(got, want, **LOGITS)
    _hold_grads(gg, jg)


def test_cp_forward_is_the_single_device_forward(port):
    from llm_qat_torch.models import llama as TL
    from llm_qat_torch.models import params as TP

    jcfg = _jcfg(w_bits=4, a_bits=8, kv_bits=4)
    cfg, params, ids = _setup(jcfg, seed=3)
    got, gg = port["single"]
    p = TP.from_numpy(params, "cpu")
    leaves = [t.requires_grad_(True) for _, t in _leaves(p)]
    logits = TL.forward(p, cfg, torch.from_numpy(ids))
    want = dict(zip([n for n, _ in _leaves(p)],
                    torch.autograd.grad(SCALE * (logits ** 2).sum(), leaves)))
    np.testing.assert_allclose(got, logits.detach().numpy(), **LOGITS)
    _hold_grads(gg, {n: g.numpy() for n, g in want.items()})


def test_cp_transport_quantization_matches_jax_and_stays_close(port):
    """int8 ring transport on top of the model's own KV quant: the JAX
    package's result at the logits' limit, and (as its test holds it) not
    the fp transport's, but within rtol 0.1 / atol 0.05 of it."""
    jcfg = _jcfg(w_bits=32, a_bits=32, kv_bits=8)
    _, params, ids = _setup(jcfg, seed=6)
    got, _ = port["transport8"]
    want, _ = _jax(4, jcfg, params, ids, dict(ring_transport_bits=8), with_grads=False)
    np.testing.assert_allclose(got, want, **LOGITS)
    exact, _ = port["transport_fp"]
    assert not np.array_equal(exact, got)
    np.testing.assert_allclose(got, exact, rtol=0.1, atol=0.05)
