"""Port parity: the flash backward (llm_qat_torch.ops.flash_attention's plain
versions on CPU) against the JAX package's _flash_bwd (the Pallas kernel pair
in interpret mode) and jax.grad of flash_attention_gqa; and the forward at
S = 2048, where the TPU kernel walks two 1024-key blocks.

Inputs come from a numpy seed. float32: dq, dk, dv at rtol/atol 1e-5 (the same
p from the same log-sum-exp, fp32 sums in another order). bfloat16: held
element by element at 2 bf16 steps of the expected value plus 1e-2 of the
median expected magnitude, the limit the decode and forward kernels are held
to (ds and p round to bf16 once on both sides; a last-bit fp32 difference
before that rounding moves a value by one bf16 step). The bf16 cases compile
the JAX side with XLA's excess precision off, so that its bf16 roundings
happen where its source puts them.

Forward past one key block (S = 2048, 1536, 1800): both walk the TPU
kernel's key blocks, rounding each block's p against the running maximum. In
float32 the two agree to summation order (O and log-sum-exp at 1e-5); in
bf16 at most 1% of O may differ from the JAX kernel's bits, the rest is held
at the element-wise limit above, and the log-sum-exp, which the backward
consumes, at 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_qat_tpu.ops.pallas import flash_attention as JFA
from llm_qat_torch.ops import flash_attention as TFA

TOL = dict(rtol=1e-5, atol=1e-5)
JDT = {"f32": jnp.float32, "bf16": jnp.bfloat16}
TDT = {"f32": torch.float32, "bf16": torch.bfloat16}


def _strict(fn, *args):
    """``fn(*args)`` jitted with XLA's excess precision off."""
    return jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": False})(*args)


def _np(a):
    return np.array(jnp.asarray(a, jnp.float32))


def _assert_close(got, want, dt, what="", rows=slice(None)):
    """``rows``: the batch entries whose values set the median (a sequence of
    one token or none has p = 1 on its only column, so its gradients are the
    rounding noise of O against V and would pull the median down to it)."""
    g, w = got.float().numpy(), _np(want)
    if dt == "f32":
        np.testing.assert_allclose(g, w, err_msg=what, **TOL)
        return
    step = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(w), 2.0 ** -126))) - 7)
    lim = 2 * step + 1e-2 * np.median(np.abs(w[rows]))
    assert np.isfinite(g).all() and (np.abs(g - w) <= lim).all(), (
        what, float((np.abs(g - w) / lim).max()))


def _inputs(B, G, S, D, seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=sh).astype(np.float32)
            for sh in ((B, G, S, D), (B, S, D), (B, S, D), (B, G, S, D))]


CASES = [  # B, G, S, D, lengths
    (3, 4, 128, 64, [128, 70, 0]),
    (2, 1, 256, 64, [256, 1]),
    (2, 4, 64, 32, [33, 64]),
    (2, 1, 256, 128, [256, 77]),  # the MHA heads of the LLaMA-7B family
]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("B,G,S,D,lens", CASES)
def test_flash_bwd_plain_matches_jax_kernels(B, G, S, D, lens, dt, causal):
    q, k, v, do = _inputs(B, G, S, D, seed=S + G)
    lengths = np.asarray(lens, np.int32)
    jq, jk, jv, jdo = (jnp.asarray(a, JDT[dt]) for a in (q, k, v, do))
    jo, jlse = JFA._flash_fwd(jq, jk, jv, jnp.asarray(lengths), 512, 1024, causal=causal)
    want = _strict(lambda *a: JFA._flash_bwd(*a, 512, 1024, causal=causal),
                   jq, jk, jv, jnp.asarray(lengths), jo, jlse, jdo)
    tq, tk, tv, tdo = (torch.from_numpy(a).to(TDT[dt]) for a in (q, k, v, do))
    to = torch.from_numpy(_np(jo)).to(TDT[dt])
    tlse = torch.from_numpy(np.asarray(jlse))
    n = (TFA._flash_bwd_dq.launches, TFA._flash_bwd_dkv.launches)
    got = TFA._flash_bwd(tq, tk, tv, torch.from_numpy(lengths), to, tlse, tdo, causal)
    assert (TFA._flash_bwd_dq.launches, TFA._flash_bwd_dkv.launches) == n   # CPU: plain
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == TDT[dt] and tuple(g.shape) == tuple(w.shape)
        _assert_close(g, w, dt, name, rows=[i for i, n in enumerate(lens) if n > 1])
    # columns at and past max(length, 1) get exact-zero dK and dV
    for b, n_live in enumerate(lens):
        assert not got[1][b, max(n_live, 1):].any() and not got[2][b, max(n_live, 1):].any()
    again = TFA._flash_bwd_plain(tq, tk, tv, torch.from_numpy(lengths), to, tlse, tdo, causal)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("G", [1, 4])
@pytest.mark.parametrize("soft_bf16", [False, True])
def test_flash_attention_gqa_gradient_matches_jax(G, soft_bf16):
    B, S, D = 2, 128, 64
    q, k, v, g = _inputs(B, G, S, D, seed=7 + G)
    lengths = np.asarray([S, 50], np.int32)

    def jf(q_, k_, v_):
        return JFA.flash_attention_gqa(q_, k_, v_, jnp.asarray(lengths), 512, 1024, soft_bf16)

    jo, vjp = jax.vjp(jf, *(jnp.asarray(a) for a in (q, k, v)))
    want = vjp(jnp.asarray(g))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    to = TFA.flash_attention_gqa(tq, tk, tv, torch.from_numpy(lengths), soft_bf16)
    got = torch.autograd.grad(to, (tq, tk, tv), torch.from_numpy(g))
    # soft_bf16 rounds p in the forward only: O moves by bf16 steps (held at
    # 1e-2 as in the forward's tests), and the backward sees that O through
    # delta = rowsum(dO * O)
    tol = dict(rtol=1e-2, atol=1e-2) if soft_bf16 else TOL
    np.testing.assert_allclose(to.detach().numpy(), np.asarray(jo), **tol)
    for a, w in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), **tol)


@pytest.mark.parametrize("b,s,nh,kvh,d", [(2, 32, 4, 2, 16), (1, 16, 4, 4, 16)])
def test_flash_attention_model_layout_gradient_matches_jax(b, s, nh, kvh, d):
    rng = np.random.default_rng(11)
    q = rng.normal(size=(b, s, nh, d)).astype(np.float32)
    k = rng.normal(size=(b, s, kvh, d)).astype(np.float32)
    v = rng.normal(size=(b, s, kvh, d)).astype(np.float32)
    g = rng.normal(size=(b, s, nh * d)).astype(np.float32)
    lengths = np.asarray([s, s - 5][:b], np.int32)
    jo, vjp = jax.vjp(lambda *a: JFA.flash_attention(*a, lengths=jnp.asarray(lengths)),
                      *(jnp.asarray(a) for a in (q, k, v)))
    want = vjp(jnp.asarray(g))
    ts = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    to = TFA.flash_attention(*ts, lengths=torch.from_numpy(lengths))
    got = torch.autograd.grad(to, ts, torch.from_numpy(g))
    np.testing.assert_allclose(to.detach().numpy(), np.asarray(jo), **TOL)
    for a, w in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), **TOL)


def test_saved_attention_is_read_back_not_recomputed(monkeypatch):
    """A full ``AttnSaved`` holder stands in for the forward: the function
    returns the held O and its backward uses the held log-sum-exp."""
    q, k, v, g = (torch.from_numpy(a) for a in _inputs(1, 2, 32, 16, seed=3))
    lens = torch.tensor([32], dtype=torch.int32)
    saved = TFA.AttnSaved()
    o1 = TFA.flash_attention_gqa(q, k, v, lens, False, saved)
    assert saved.o is o1 and saved.lse is not None
    calls = []
    monkeypatch.setattr(TFA, "_flash_fwd", lambda *a, **kw: calls.append(1))
    qr, kr, vr = (t.clone().requires_grad_(True) for t in (q, k, v))
    o2 = TFA.flash_attention_gqa(qr, kr, vr, lens, False, saved)
    assert not calls and torch.equal(o2, o1)
    got = torch.autograd.grad(o2, (qr, kr, vr), g)
    want = TFA._flash_bwd_plain(q, k, v, lens, o1, saved.lse, g)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    saved.clear()
    assert saved.o is None and saved.lse is None


def _fwd_walks_jax_blocks(S, dt, causal=True):
    """The forward at S against the JAX kernel (blocks of 512 queries and
    ``_fit_block(1024, S)`` keys). float32: O and log-sum-exp at 1e-5.
    bfloat16: at most 1% of O off the JAX kernel's bits (p rounds against the
    same running maxima on both sides; only a last-bit fp32 difference in a
    sum moves an element, by one bf16 step: 0.04-0.05% measured at these
    lengths, where p against the row's final maximum put 6-30% off), the rest
    at the element-wise limit, and the log-sum-exp at 1e-5."""
    B, G, D = 2, 2, 64
    q, k, v, _ = _inputs(B, G, S, D, seed=S)
    lengths = np.asarray([S, S * 3 // 4], np.int32)
    jo, jlse = _strict(lambda *a: JFA._flash_fwd(*a, 512, 1024, causal=causal),
                       *(jnp.asarray(a, JDT[dt]) for a in (q, k, v)), jnp.asarray(lengths))
    to, tlse = TFA._flash_fwd(*(torch.from_numpy(a).to(TDT[dt]) for a in (q, k, v)),
                              torch.from_numpy(lengths), causal)
    _assert_close(to, jo, dt, "o")
    if dt == "bf16":
        off = float((to.float().numpy() != _np(jo)).mean())
        assert off <= 0.01, off
    np.testing.assert_allclose(tlse.numpy(), np.asarray(jlse), **TOL)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_flash_fwd_two_key_blocks_matches_jax(dt):
    """S = 2048: two 1024-key blocks, so p rounds against block 0's maximum
    and then the running maximum, with a rescale between."""
    _fwd_walks_jax_blocks(2048, dt)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("S,causal", [(1536, True), (1800, True), (1536, False)])
def test_flash_fwd_walks_jax_key_blocks(S, causal, dt):
    """S = 1536: two blocks of 768 keys, causal and not (the ring's
    full-visibility steps). S = 1800: ``_fit_block`` gives 15 blocks of 120
    keys, which no kernel tile lines up with."""
    assert TFA._fit_block(1024, S) == {1536: 768, 1800: 120}[S]
    _fwd_walks_jax_blocks(S, dt, causal)


def test_fit_block_is_the_jax_packages():
    for S in (16, 100, 128, 1000, 1024, 1031, 1536, 1800, 2048, 4096, 6144):
        assert TFA._fit_block(1024, S) == JFA._fit_block(1024, S)
        assert TFA._fit_block(512, S) == JFA._fit_block(512, S)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_bwd_dq_plain_on_cpu_keeps_fp32_score_products(dt, causal, monkeypatch):
    """The dQ plain version asks ``_scores`` for tensor-core products, which
    it takes (the library's bf16 product) for CUDA tensors only: on the CPU
    its output is bit for bit the one with fp32 products of the widened
    operands forced."""
    B, G, S, D = 2, 2, 96, 128
    q, k, v, do = (torch.from_numpy(a).to(TDT[dt]) for a in _inputs(B, G, S, D, seed=5))
    lens = torch.tensor([S, 40], dtype=torch.int32)
    o, lse = TFA._flash_fwd(q, k, v, lens, causal)
    args = (q, k, v, lens, lse, TFA._delta(o, do), do, causal)
    got = TFA._flash_bwd_dq_plain(*args)
    real = TFA._scores
    monkeypatch.setattr(TFA, "_scores", lambda a, b, tensor_cores=True: real(a, b, False))
    want = TFA._flash_bwd_dq_plain(*args)
    assert got.dtype == q.dtype and torch.equal(got, want)
