"""Port parity: llm_qat_torch.ops.decode_attention (its plain version, on
CPU) against the JAX package's quantized_decode_attention (the Pallas kernel
in interpret mode).

Inputs come from a numpy seed. float32 outputs are held at rtol/atol 1e-5:
the port computes the softmax over the whole row where the TPU kernel goes
block by block, which changes only the f32 rounding. With a bf16 query both
sides round cos*ks, sin*ks, k and p*vs to bf16 at the same points, so they
agree to one bf16 rounding of the output (2**-8 relative, held at 1e-2).
"""

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
