"""Port parity: llm_qat_torch.ops.decode_attention (its plain version, on
CPU) against the JAX package's quantized_decode_attention (the Pallas kernel
in interpret mode).

Inputs come from a numpy seed. float32 outputs are held at rtol/atol 1e-5:
the port computes the softmax over the whole row where the TPU kernel goes
block by block, which changes only the f32 rounding. With a bf16 query both
sides round cos*ks, sin*ks, k and p*vs to bf16 at the same points, so they
agree to one bf16 rounding of the output (2**-8 relative, held at 1e-2).

Both sides walk the TPU kernel's ``bk``-column blocks with a running
maximum, so with a bf16 query ``p*vs`` rounds against the same maximum. The
block-crossing cases compile the JAX side without XLA's excess precision
(which on the CPU skips bf16 roundings the TPU makes) and hold the port to
JAX's bits: at most 1% of the outputs may differ (each within the bf16
tolerance above), where p taken against the final maximum makes 10-26% of
them differ.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_qat_tpu.ops.pallas import decode_attention as JDA
from llm_qat_torch.ops import decode_attention as TDA

TOL = dict(rtol=1e-5, atol=1e-5)


def _make(b, kvh, groups, S, hd, packed, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, kvh * groups, hd)).astype(np.float32)
    hdc = hd // 2 if packed else hd
    if packed:
        k_q = rng.integers(0, 256, size=(b, kvh, hdc, S)).astype(np.uint8)
        v_q = rng.integers(0, 256, size=(b, kvh, hdc, S)).astype(np.uint8)
        scale = (0.05, 0.2)
    else:
        k_q = rng.integers(-127, 128, size=(b, kvh, hdc, S)).astype(np.int8)
        v_q = rng.integers(-127, 128, size=(b, kvh, hdc, S)).astype(np.int8)
        scale = (0.005, 0.02)
    k_s = rng.uniform(*scale, size=(b, S)).astype(np.float32)
    v_s = rng.uniform(*scale, size=(b, S)).astype(np.float32)
    return q, k_q, k_s, v_q, v_s


def _fold(b, kvh, hd, active, seed=1):
    rng = np.random.default_rng(seed)
    k_new = rng.integers(-127, 128, size=(b, kvh, hd)).astype(np.int8)
    v_new = rng.integers(-127, 128, size=(b, kvh, hd)).astype(np.int8)
    k_inv = rng.uniform(0.005, 0.02, size=(b, 1)).astype(np.float32)
    v_inv = rng.uniform(0.005, 0.02, size=(b, 1)).astype(np.float32)
    pos = rng.integers(0, 100, size=(b,)).astype(np.float32)
    inv_freq = 1.0 / (10000.0 ** (np.arange(0, hd, 2, dtype=np.float32) / hd))
    fr = pos[:, None] * inv_freq[None]
    return (k_new, k_inv, v_new, v_inv, np.asarray(active, np.int32),
            np.cos(fr).astype(np.float32), np.sin(fr).astype(np.float32))


def _tables(S, hd):
    pos = np.arange(S, dtype=np.float32)
    inv_freq = 1.0 / (10000.0 ** (np.arange(0, hd, 2, dtype=np.float32) / hd))
    fr = inv_freq[:, None] * pos[None, :]
    return np.cos(fr).astype(np.float32), np.sin(fr).astype(np.float32)


def _both(args, kw, bf16=False):
    """Run JAX and the port on the same numpy operands; f32 results."""
    q, k_q, k_s, v_q, v_s, lengths, k_cos, k_sin, fold = args

    def jx(a):
        return None if a is None else jnp.asarray(a)

    def tx(a):
        return None if a is None else torch.from_numpy(np.array(a))

    jq = jnp.asarray(q, jnp.bfloat16 if bf16 else jnp.float32)
    tq = tx(q).to(torch.bfloat16 if bf16 else torch.float32)
    want = JDA.quantized_decode_attention(
        jq, jx(k_q), jx(k_s), jx(v_q), jx(v_s), jx(lengths), jx(k_cos), jx(k_sin),
        fold=None if fold is None else tuple(jx(a) for a in fold), **kw,
    )
    got = TDA.quantized_decode_attention(
        tq, tx(k_q), tx(k_s), tx(v_q), tx(v_s), tx(lengths), tx(k_cos), tx(k_sin),
        fold=None if fold is None else tuple(tx(a) for a in fold), **kw,
    )
    return np.asarray(want.astype(jnp.float32)), got.float().numpy()


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("rope,tables", [(True, True), (True, False), (False, False)])
@pytest.mark.parametrize("fold", [False, True])
def test_decode_attention_matches_jax(packed, rope, tables, fold):
    b, kvh, groups, S, hd = 3, 2, 4, 64, 32
    q, k_q, k_s, v_q, v_s = _make(b, kvh, groups, S, hd, packed)
    # ragged, including an empty cache (valid only with fold)
    lengths = np.asarray([S // 2 + 3, S - 1, 0 if fold else 5], np.int32)
    kc, ks = _tables(S, hd) if tables else (None, None)
    fd = _fold(b, kvh, hd, [1, 0, 1]) if fold else None
    want, got = _both((q, k_q, k_s, v_q, v_s, lengths, kc, ks, fd),
                      dict(rope=rope, packed=packed))
    np.testing.assert_allclose(got, want, **TOL)


def test_decode_attention_mha_matches_jax():
    b, kvh, groups, S, hd = 2, 4, 1, 32, 16
    q, k_q, k_s, v_q, v_s = _make(b, kvh, groups, S, hd, False, seed=3)
    lengths = np.asarray([7, 32], np.int32)
    kc, ks = _tables(S, hd)
    want, got = _both((q, k_q, k_s, v_q, v_s, lengths, kc, ks,
                       _fold(b, kvh, hd, [1, 1])), dict(rope=True))
    np.testing.assert_allclose(got, want, **TOL)


def test_empty_inactive_slot_is_zero():
    """length 0 and inactive: no term at all, l clamps at 1e-9, output 0."""
    b, kvh, groups, S, hd = 2, 2, 2, 16, 16
    q, k_q, k_s, v_q, v_s = _make(b, kvh, groups, S, hd, False, seed=4)
    lengths = np.asarray([0, 4], np.int32)
    want, got = _both((q, k_q, k_s, v_q, v_s, lengths, None, None,
                       _fold(b, kvh, hd, [0, 1])), dict(rope=True))
    np.testing.assert_allclose(got, want, **TOL)
    assert np.all(got[0] == 0.0)


@pytest.mark.parametrize("packed", [False, True])
def test_decode_attention_bf16_mirrors_jax_roundings(packed):
    b, kvh, groups, S, hd = 2, 2, 4, 64, 32
    q, k_q, k_s, v_q, v_s = _make(b, kvh, groups, S, hd, packed, seed=5)
    lengths = np.asarray([40, 17], np.int32)
    kc, ks = _tables(S, hd)
    want, got = _both((q, k_q, k_s, v_q, v_s, lengths, kc, ks,
                       _fold(b, kvh, hd, [1, 1])), dict(rope=True, packed=packed),
                      bf16=True)
    np.testing.assert_allclose(got, want, rtol=1e-2, atol=1e-2 * np.abs(want).max())


def test_reference_oracle_matches_jax():
    b, kvh, groups, S, hd = 2, 2, 2, 32, 16
    q, k_q, k_s, v_q, v_s = _make(b, kvh, groups, S, hd, False, seed=6)
    kn, vn = np.swapaxes(k_q, 2, 3).copy(), np.swapaxes(v_q, 2, 3).copy()
    lengths = np.asarray([9, 32], np.int32)
    want = JDA.decode_attention_reference(*(jnp.asarray(a) for a in
                                            (q, kn, k_s, vn, v_s, lengths)))
    got = TDA.decode_attention_reference(*(torch.from_numpy(a) for a in
                                           (q, kn, k_s, vn, v_s, lengths)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # and the kernel's plain version agrees with the oracle
    plain = TDA.quantized_decode_attention(
        *(torch.from_numpy(a) for a in (q, k_q, k_s, v_q, v_s, lengths)))
    np.testing.assert_allclose(plain.numpy(), got.numpy(), rtol=2e-5, atol=2e-5)


def test_cpu_counts_no_launch_and_meta_raises():
    b, kvh, groups, S, hd = 1, 1, 8, 16, 64
    ops = [torch.from_numpy(a) for a in _make(b, kvh, groups, S, hd, False)]
    lens = torch.tensor([5], dtype=torch.int32)
    n = TDA.quantized_decode_attention.launches
    TDA.quantized_decode_attention(*ops, lens)
    assert TDA.quantized_decode_attention.launches == n
    with pytest.raises(ValueError):
        TDA.quantized_decode_attention(*(a.to("meta") for a in ops), lens.to("meta"))


def _jax_strict(fn, *args, **kw):
    """``fn(*args, **kw)`` compiled without XLA's excess precision, so each
    bf16 rounding of the TPU kernel happens on the CPU too."""
    f = jax.jit(lambda *a: fn(*a, **kw))
    return f.lower(*args).compile(compiler_options={"xla_allow_excess_precision": False})(*args)


def _same_bits(got, want, share=0.01):
    """At most ``share`` of the outputs differ from JAX's bits, and those
    within the bf16 tolerance of this module."""
    np.testing.assert_allclose(got, want, rtol=1e-2, atol=1e-2 * np.abs(want).max())
    differ = float(np.mean(got != want))
    assert differ <= share, f"{differ:.2%} of the outputs differ from JAX's"


def _strict_case(b, kvh, groups, S, hd, packed, lengths, fold, bk, seed):
    q, k_q, k_s, v_q, v_s = _make(b, kvh, groups, S, hd, packed, seed=seed)
    kc, ks = _tables(S, hd)
    lengths = np.asarray(lengths, np.int32)
    fd = _fold(b, kvh, hd, [1] * b) if fold else None
    kw = dict(rope=True, packed=packed) if bk is None else dict(rope=True, packed=packed, bk=bk)
    ops = [q, k_q, k_s, v_q, v_s, lengths, kc, ks] + ([] if fd is None else list(fd))
    jops = [jnp.asarray(q, jnp.bfloat16)] + [jnp.asarray(a) for a in ops[1:]]
    want = _jax_strict(lambda *a, **k: JDA.quantized_decode_attention(
        *a[:8], fold=a[8:] or None, **k), *jops, **kw)
    tops = [torch.from_numpy(np.array(a)) for a in ops]
    got = TDA.quantized_decode_attention(
        tops[0].to(torch.bfloat16), *tops[1:8], fold=tuple(tops[8:]) or None, **kw)
    return np.asarray(want.astype(jnp.float32)), got.float().numpy()


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("fold", [False, True])
def test_decode_attention_bf16_walks_jax_blocks(packed, fold):
    """bk = 16 at S = 64: the lengths 0 / 17 / 40 / 63 cross one to four
    blocks, so ``p*vs`` rounds against each block's running maximum."""
    want, got = _strict_case(4, 2, 4, 64, 32, packed, [0, 17, 40, 63], fold, 16, seed=5)
    _same_bits(got, want)


def test_decode_attention_bf16_at_the_pickers_block_for_llama7b_heads():
    """kvh 32, hd 128: the JAX picker takes bk = 256 (not 1024) at S = 512, so
    a length of 500 crosses a block edge with the default ``bk``."""
    want, got = _strict_case(2, 32, 1, 512, 128, False, [500, 300], True, None, seed=7)
    _same_bits(got, want)
    assert TDA._pick_bk(512, 32, 128, 1024) == 256


@pytest.mark.parametrize("S,kvh,hd,bk,want", [
    (2048, 4, 64, 1024, 1024), (2048, 32, 128, 1024, 256), (8192, 4, 64, 1024, 1024),
    (64, 2, 32, 16, 16), (2040, 4, 64, 1024, 680), (100, 1, 8, 1024, 8)])
def test_pick_bk_is_the_jax_pickers(S, kvh, hd, bk, want):
    from llm_qat_tpu.ops.pallas.decode_attention import _pick_bk
    assert TDA._pick_bk(S, kvh, hd, bk) == _pick_bk(S, kvh, hd, bk) == want


def test_kernel_shape_check_takes_long_caches():
    """The card's K3 has no cache-length limit: S = 8192 at G = 8 (over the
    old 32768 / G) and S = 65536 pass the wrapper's shape check, and the
    kernel's chunks never straddle a ``bk`` block."""
    q = torch.empty(8, 32, 64, dtype=torch.bfloat16, device="meta")
    for S in (8192, 65536):
        TDA._check_contiguous_kernel_shape("t", q, 8, 64, S)
    assert TDA._kernel_chunk(8192, 4, 64, 1024) == (1024, 128)
    assert TDA._kernel_chunk(2048, 32, 128, 1024) == (256, 128)
    assert TDA._kernel_chunk(2040, 4, 64, 1024) == (680, 8)
