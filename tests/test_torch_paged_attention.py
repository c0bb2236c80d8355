"""Port parity: llm_qat_torch.ops.decode_attention.quantized_paged_attention
(its plain version, on CPU) against the JAX package's
quantized_paged_attention (the Pallas kernel in interpret mode).

Inputs come from a numpy seed. Both sides walk a slot's pages in table order
with an online softmax, one page a step, so they round at the same points:
float32 outputs are held at rtol/atol 1e-5 (f32 summation order inside a page
only); with a bf16 query both round cos*ks, sin*ks, k and p*vs (against the
running maximum) to bf16 alike and agree to one bf16 rounding of the output
(2**-8 relative, held at 1e-2). The pool is random everywhere, also in the
pages and columns past a slot's length, and unused block-table entries point
outside the pool: neither side may read them.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_qat_tpu.ops.pallas import decode_attention as JDA
from llm_qat_torch.ops import decode_attention as TDA

TOL = dict(rtol=1e-5, atol=1e-5)
GARBAGE = 10 ** 6          # an unused table entry: far outside the pool


def _pool(n_pages, kvh, hd, P, packed, rng):
    hdc = hd // 2 if packed else hd
    if packed:
        k_q = rng.integers(0, 256, size=(n_pages, kvh, hdc, P)).astype(np.uint8)
        v_q = rng.integers(0, 256, size=(n_pages, kvh, hdc, P)).astype(np.uint8)
        scale = (0.05, 0.2)
    else:
        k_q = rng.integers(-127, 128, size=(n_pages, kvh, hdc, P)).astype(np.int8)
        v_q = rng.integers(-127, 128, size=(n_pages, kvh, hdc, P)).astype(np.int8)
        scale = (0.005, 0.02)
    k_s = rng.uniform(*scale, size=(n_pages, P)).astype(np.float32)
    v_s = rng.uniform(*scale, size=(n_pages, P)).astype(np.float32)
    return k_q, k_s, v_q, v_s


def _tables_for(lengths, P, max_pages, n_pages, rng):
    """Shuffled, non-contiguous page ids for the live pages of each slot;
    every other entry is GARBAGE."""
    ids = rng.permutation(n_pages)
    bt = np.full((len(lengths), max_pages), GARBAGE, np.int32)
    at = 0
    for i, n in enumerate(lengths):
        live = -(-int(n) // P)
        bt[i, :live] = ids[at:at + live]
        at += live
    return bt


def _fold(b, kvh, hd, active, packed, rng):
    lo, hi = (-8, 8) if packed else (-127, 128)
    k_new = rng.integers(lo, hi, size=(b, kvh, hd)).astype(np.int8)
    v_new = rng.integers(lo, hi, size=(b, kvh, hd)).astype(np.int8)
    k_inv = rng.uniform(0.005, 0.02, size=(b, 1)).astype(np.float32)
    v_inv = rng.uniform(0.005, 0.02, size=(b, 1)).astype(np.float32)
    pos = rng.integers(0, 100, size=(b,)).astype(np.float32)
    inv_freq = 1.0 / (10000.0 ** (np.arange(0, hd, 2, dtype=np.float32) / hd))
    fr = pos[:, None] * inv_freq[None]
    return (k_new, k_inv, v_new, v_inv, np.asarray(active, np.int32),
            np.cos(fr).astype(np.float32), np.sin(fr).astype(np.float32))


def _rope_tables(n, hd):
    pos = np.arange(n, dtype=np.float32)
    inv_freq = 1.0 / (10000.0 ** (np.arange(0, hd, 2, dtype=np.float32) / hd))
    fr = inv_freq[:, None] * pos[None, :]
    return np.cos(fr).astype(np.float32), np.sin(fr).astype(np.float32)


def _both(q, pool, lengths, bt, k_cos, k_sin, fold, kw, bf16=False):
    """Run JAX and the port on the same numpy operands; f32 results."""
    def jx(a):
        return None if a is None else jnp.asarray(a)

    def tx(a):
        return None if a is None else torch.from_numpy(np.array(a))

    jq = jnp.asarray(q, jnp.bfloat16 if bf16 else jnp.float32)
    tq = tx(q).to(torch.bfloat16 if bf16 else torch.float32)
    want = JDA.quantized_paged_attention(
        jq, *(jx(a) for a in pool), jx(lengths), jx(bt), jx(k_cos), jx(k_sin),
        fold=None if fold is None else tuple(jx(a) for a in fold), **kw,
    )
    got = TDA.quantized_paged_attention(
        tq, *(tx(a) for a in pool), tx(lengths), tx(bt), tx(k_cos), tx(k_sin),
        fold=None if fold is None else tuple(tx(a) for a in fold), **kw,
    )
    return np.asarray(want.astype(jnp.float32)), got.float().numpy()


def _case(groups, hd, packed, fold, rope, tables, P=8, max_pages=4, seed=0):
    """Five slots: empty, one token, a page edge, mid-page, a full table;
    slot 3 inactive."""
    rng = np.random.default_rng(seed)
    kvh, n_pages = 2, 24
    lengths = np.asarray([0, 1, 2 * P, 2 * P + 3, max_pages * P], np.int32)
    b = len(lengths)
    q = rng.normal(size=(b, kvh * groups, hd)).astype(np.float32)
    pool = _pool(n_pages, kvh, hd, P, packed, rng)
    bt = _tables_for(lengths, P, max_pages, n_pages, rng)
    kc, ks = _rope_tables(max_pages * P, hd) if tables else (None, None)
    fd = _fold(b, kvh, hd, [1, 1, 1, 0, 1], packed, rng) if fold else None
    return q, pool, lengths, bt, kc, ks, fd, dict(rope=rope, packed=packed)


@pytest.mark.parametrize("groups,hd", [(1, 128), (4, 64), (8, 64), (4, 128)])
@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("rope,tables", [(True, True), (True, False), (False, False)])
@pytest.mark.parametrize("fold", [False, True])
def test_paged_attention_matches_jax(groups, hd, packed, rope, tables, fold):
    want, got = _both(*_case(groups, hd, packed, fold, rope, tables))
    np.testing.assert_allclose(got, want, **TOL)
    if not fold:
        assert np.all(got[0] == 0.0)         # empty, no pair: l clamps, output 0


def test_paged_attention_page_size_16_matches_jax():
    want, got = _both(*_case(8, 64, False, True, True, True, P=16, max_pages=3, seed=2))
    np.testing.assert_allclose(got, want, **TOL)


def test_empty_inactive_slot_is_zero_not_nan():
    """length 0 and inactive: no term at all, l clamps at 1e-9, output 0."""
    q, pool, lengths, bt, kc, ks, fd, kw = _case(4, 64, False, True, True, True, seed=3)
    act = np.asarray([0, 1, 1, 0, 1], np.int32)
    fd = fd[:4] + (act,) + fd[5:]
    want, got = _both(q, pool, lengths, bt, kc, ks, fd, kw)
    np.testing.assert_allclose(got, want, **TOL)
    assert np.all(got[0] == 0.0)


@pytest.mark.parametrize("groups,hd", [(8, 64), (1, 128)])
@pytest.mark.parametrize("packed", [False, True])
def test_paged_attention_bf16_mirrors_jax_roundings(groups, hd, packed):
    want, got = _both(*_case(groups, hd, packed, True, True, True, seed=5), bf16=True)
    np.testing.assert_allclose(got, want, rtol=1e-2, atol=1e-2 * np.abs(want).max())


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("fold", [False, True])
def test_paged_matches_contiguous_on_gathered_pages(packed, fold):
    """The port's paged plain version against its contiguous plain version on
    the same K/V gathered into a contiguous cache: same function, other
    layout. The two differ in where they rescale (every page against every
    bk-column block): f32 rounding only, held at 1e-5."""
    q, pool, lengths, bt, kc, ks, fd, kw = _case(4, 64, packed, fold, True, True, seed=7)
    k_q, k_s, v_q, v_s = pool
    b, max_pages = bt.shape
    P = k_q.shape[-1]
    safe = np.where(bt == GARBAGE, 0, bt)
    # [b, mp, kvh, hdc, P] -> [b, kvh, hdc, mp*P]
    ck = np.transpose(k_q[safe], (0, 2, 3, 1, 4)).reshape(b, k_q.shape[1], k_q.shape[2], -1)
    cv = np.transpose(v_q[safe], (0, 2, 3, 1, 4)).reshape(b, v_q.shape[1], v_q.shape[2], -1)
    cks, cvs = k_s[safe].reshape(b, -1), v_s[safe].reshape(b, -1)
    t = torch.from_numpy
    tf = None if fd is None else tuple(t(np.array(a)) for a in fd)
    paged = TDA.quantized_paged_attention(
        t(q), *(t(a) for a in pool), t(lengths), t(bt), t(kc), t(ks), fold=tf, **kw)
    contig = TDA.quantized_decode_attention(
        t(q), t(ck), t(cks), t(cv), t(cvs), t(lengths), t(kc), t(ks), fold=tf, **kw)
    np.testing.assert_allclose(paged.numpy(), contig.numpy(), **TOL)
    assert max_pages * P == ck.shape[-1]


def test_cpu_counts_no_launch_and_other_device_raises():
    q, pool, lengths, bt, kc, ks, fd, kw = _case(8, 64, False, False, True, False)
    ops = [torch.from_numpy(a) for a in (q, *pool, lengths, bt)]
    n = TDA.quantized_paged_attention.launches
    TDA.quantized_paged_attention(*ops, **kw)
    assert TDA.quantized_paged_attention.launches == n
    with pytest.raises(ValueError):
        TDA.quantized_paged_attention(*(a.to("meta") for a in ops), **kw)
