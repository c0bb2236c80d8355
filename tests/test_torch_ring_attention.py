"""Port parity: llm_qat_torch.parallel.ring_attention on gloo ranks (spawned on
the CPU through ``parallel.launch``) against the JAX package's ring on the
suite's fake CPU devices (``tests/conftest.py``), from the same numpy inputs.

Each rank holds chunk ``idx`` of the sequence; the test joins the ranks'
chunks. The flash ring (the flash kernels' plain versions here, the Pallas
kernels in interpret mode on the JAX side) is held at cp = 2 and 4, with
the transport in fp32 and in int8 (per-token scales: the same integers on
both sides, the inputs being equal), forward and the gradients of
``sum(out * w)`` for a random cotangent ``w``, at rtol/atol 2e-5 (fp32 sums in
other orders: the JAX ring test's own limit against naive attention); the
fp32 einsum body, the ring's plain version, the same way. Then, port only:
the flash ring against the einsum ring and against single-device attention,
and causality (a poisoned last chunk moves no earlier output).

The ranks import this module, so JAX is imported inside the reference
functions only: a rank needs torch alone.
"""

import numpy as np
import pytest
import torch

from llm_qat_torch.parallel import launch
from llm_qat_torch.parallel import ring_attention as RA

TOL = dict(rtol=2e-5, atol=2e-5)
B, S, H, HK, D = 2, 64, 4, 2, 16


def _inputs(seed, hk=HK, s=S):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, s, H, D)).astype(np.float32)
    k = rng.standard_normal((B, s, hk, D)).astype(np.float32)
    v = rng.standard_normal((B, s, hk, D)).astype(np.float32)
    w = rng.standard_normal((B, s, H, D)).astype(np.float32)
    return q, k, v, w


def _chunk(a, rank, world):
    sl = a.shape[1] // world
    return torch.from_numpy(np.ascontiguousarray(a[:, rank * sl:(rank + 1) * sl]))


def _ring_rank(rank, world, jobs):
    """For each job (arrays, kv_bits, impl): this rank's output chunk and
    the gradients of sum(out * w)."""
    import torch.distributed as dist

    out = {}
    for name, (arrays, kv_bits, impl) in jobs.items():
        q, k, v, w = (_chunk(a, rank, world) for a in arrays)
        q.requires_grad_(True)
        k.requires_grad_(True)
        v.requires_grad_(True)
        body = RA.ring_flash_attention_local if impl == "flash" else RA.ring_attention_local
        o = body(q, k, v, dist.group.WORLD, kv_bits)
        dq, dk, dv = torch.autograd.grad((o * w).sum(), (q, k, v))
        out[name] = [t.detach().numpy() for t in (o, dq, dk, dv)]
    return out


def _jobs():
    """Every ring the tests hold, by world size and name."""
    q, k, v, w = _inputs(13)
    k2, v2 = k.copy(), v.copy()
    k2[:, 48:] = 50.0
    v2[:, 48:] = -50.0
    a11 = _inputs(11)
    rep = [a11[0], np.repeat(a11[1], H // HK, axis=2), np.repeat(a11[2], H // HK, axis=2), a11[3]]
    jobs = {2: {}, 4: {}}
    for world in (2, 4):
        for kv_bits in (None, 8):
            jobs[world][f"flash_{kv_bits}"] = (_inputs(world + (kv_bits or 0)), kv_bits, "flash")
    for kv_bits in (None, 8):
        jobs[4][f"einsum_{kv_bits}"] = (_inputs(7, hk=H), kv_bits, "einsum")
    jobs[4]["gqa_flash"] = (a11, None, "flash")
    jobs[4]["gqa_einsum"] = (rep, None, "einsum")
    jobs[4]["clean"] = ((q, k, v, w), 8, "flash")
    jobs[4]["poisoned"] = ((q, k2, v2, w), 8, "flash")
    return jobs


@pytest.fixture(scope="module")
def rings():
    """The port's rings: two spawns (2 and 4 ranks) run every job; the
    ranks' chunks joined along the sequence."""
    out = {}
    for world, jobs in _jobs().items():
        ranks = launch.spawn(_ring_rank, world, args=(jobs,), timeout=180)
        for name in jobs:
            out[world, name] = [np.concatenate([r[name][i] for r in ranks], axis=1)
                                for i in range(4)]
    return out


def _jax_ring(world, arrays, kv_bits, impl="flash"):
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from llm_qat_tpu.parallel.ring_attention import ring_attention

    mesh = Mesh(np.asarray(jax.devices()[:world]), ("cp",))
    q, k, v, w = (jnp.asarray(a) for a in arrays)

    def loss(q, k, v):
        out = ring_attention(q, k, v, mesh, kv_bits=kv_bits, impl=impl)
        return jnp.sum(out * w), out

    (_, out), grads = jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True))(q, k, v)
    return [np.asarray(out)] + [np.asarray(g) for g in grads]


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("kv_bits", [None, 8])
def test_flash_ring_matches_jax(rings, world, kv_bits):
    arrays = _inputs(world + (kv_bits or 0))
    got, want = rings[world, f"flash_{kv_bits}"], _jax_ring(world, arrays, kv_bits)
    for name, a, b in zip(("out", "dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(a, b, err_msg=name, **TOL)


@pytest.mark.parametrize("kv_bits", [None, 8])
def test_einsum_ring_matches_jax(rings, kv_bits):
    arrays = _inputs(7, hk=H)
    got, want = rings[4, f"einsum_{kv_bits}"], _jax_ring(4, arrays, kv_bits, "einsum")
    for name, a, b in zip(("out", "dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(a, b, err_msg=name, **TOL)


def test_flash_ring_is_attention_and_its_plain_version(rings):
    """GQA flash ring = the einsum ring on repeated KV heads = causal
    attention on one device (grads of repeated heads summed back)."""
    q, k, v, w = _inputs(11)
    got = rings[4, "gqa_flash"]
    rep = [q, np.repeat(k, H // HK, axis=2), np.repeat(v, H // HK, axis=2), w]
    plain = list(rings[4, "gqa_einsum"])
    plain[2] = plain[2].reshape(B, S, HK, H // HK, D).sum(axis=3)
    plain[3] = plain[3].reshape(B, S, HK, H // HK, D).sum(axis=3)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True) for a in rep[:3])
    s = torch.einsum("bqhd,bkhd->bhqk", tq, tk) / D ** 0.5
    s = s.masked_fill(~torch.tril(torch.ones(S, S, dtype=torch.bool)), float("-inf"))
    out = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1), tv)
    single = [out.detach().numpy(), *(t.numpy() for t in torch.autograd.grad(
        (out * torch.from_numpy(w)).sum(), (tq, tk, tv)))]
    single[2] = single[2].reshape(B, S, HK, H // HK, D).sum(axis=3)
    single[3] = single[3].reshape(B, S, HK, H // HK, D).sum(axis=3)
    for name, a, b, c in zip(("out", "dq", "dk", "dv"), got, plain, single):
        np.testing.assert_allclose(a, b, err_msg=name, **TOL)
        np.testing.assert_allclose(a, c, err_msg=name, **TOL)


def test_ring_causality(rings):
    """Poisoning the last of 4 chunks' K and V moves no earlier output."""
    a, b = rings[4, "clean"][0], rings[4, "poisoned"][0]
    np.testing.assert_array_equal(a[:, :48], b[:, :48])
    assert not np.allclose(a[:, 48:], b[:, 48:])


def test_ring_schedule():
    """Step 0 causal; step i live (non-causal) on ranks idx >= i."""
    assert RA.ring_steps(4, 0) == [(True, True), (False, False), (False, False), (False, False)]
    assert RA.ring_steps(4, 2) == [(True, True), (True, False), (True, False), (False, False)]
    assert RA.ring_steps(2, 1) == [(True, True), (True, False)]
