"""Port parity: llm_qat_torch.ops.flash_attention (forward; its plain version
on CPU) against the JAX package's _flash_fwd / flash_attention (the Pallas
kernel in interpret mode).

Inputs come from a numpy seed. O and the log-sum-exp are held at rtol/atol
1e-5 in float32: at these lengths the TPU kernel's 1024-key block holds the
whole row, so the only difference is the order of f32 sums. With soft_bf16
the exponent's argument rounds to bf16, so an f32 last-bit difference in a
score can move p by one bf16 step of the argument (2**-8 * |s - m|): those
cases are held at 1e-2, the JAX suite's own tolerance class for the flag.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_qat_tpu.ops.pallas import flash_attention as JFA
from llm_qat_torch.ops import flash_attention as TFA

TOL = dict(rtol=1e-5, atol=1e-5)


def _qkv(B, G, S, D, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, G, S, D)).astype(np.float32),
            rng.normal(size=(B, S, D)).astype(np.float32),
            rng.normal(size=(B, S, D)).astype(np.float32))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("soft_bf16", [False, True])
@pytest.mark.parametrize("B,G,S,D", [(3, 4, 64, 32), (2, 1, 128, 16)])
def test_flash_fwd_matches_jax(causal, soft_bf16, B, G, S, D):
    q, k, v = _qkv(B, G, S, D)
    lengths = np.asarray([S, S // 2 + 5, 0][:B], np.int32)
    jo, jl = JFA._flash_fwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            jnp.asarray(lengths), 512, 1024, causal=causal,
                            soft_bf16=soft_bf16)
    to, tl = TFA._flash_fwd(torch.from_numpy(q), torch.from_numpy(k),
                            torch.from_numpy(v), torch.from_numpy(lengths),
                            causal=causal, soft_bf16=soft_bf16)
    assert tuple(tl.shape) == (B, G, 1, S)
    tol = dict(rtol=1e-2, atol=1e-2) if soft_bf16 else TOL
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), **tol)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **tol)


def test_flash_fwd_bf16_matches_jax():
    """bf16 operands: both round p to bf16 before p.V; one bf16 rounding of
    the output apart at most (2**-8 relative)."""
    q, k, v = _qkv(2, 4, 64, 32, seed=1)
    lengths = np.asarray([64, 40], np.int32)
    jo, _ = JFA._flash_fwd(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)),
                           jnp.asarray(lengths), 512, 1024)
    to, _ = TFA._flash_fwd(*(torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v)),
                           torch.from_numpy(lengths))
    want = np.asarray(jo.astype(jnp.float32))
    np.testing.assert_allclose(to.float().numpy(), want, rtol=1e-2,
                               atol=1e-2 * np.abs(want).max())


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("soft_bf16", [False, True])
@pytest.mark.parametrize("B,S", [(2, 64), (3, 128)])
def test_flash_fwd_head_dim_128_matches_jax(causal, soft_bf16, B, S):
    """LLaMA-7B's attention shape: MHA (G = 1) at head dim 128, which the
    prefill path routes to the forward kernel."""
    q, k, v = _qkv(B, 1, S, 128, seed=3)
    lengths = np.asarray([S, S // 2 + 5, 1][:B], np.int32)
    jo, jl = JFA._flash_fwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            jnp.asarray(lengths), 512, 1024, causal=causal,
                            soft_bf16=soft_bf16)
    to, tl = TFA._flash_fwd(torch.from_numpy(q), torch.from_numpy(k),
                            torch.from_numpy(v), torch.from_numpy(lengths),
                            causal=causal, soft_bf16=soft_bf16)
    tol = dict(rtol=1e-2, atol=1e-2) if soft_bf16 else TOL
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), **tol)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **tol)


def test_flash_fwd_bf16_head_dim_128_matches_jax():
    """bf16 at head dim 128, G = 1: as the bf16 case above."""
    q, k, v = _qkv(2, 1, 128, 128, seed=4)
    lengths = np.asarray([128, 77], np.int32)
    jo, _ = JFA._flash_fwd(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)),
                           jnp.asarray(lengths), 512, 1024)
    to, _ = TFA._flash_fwd(*(torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v)),
                           torch.from_numpy(lengths))
    want = np.asarray(jo.astype(jnp.float32))
    np.testing.assert_allclose(to.float().numpy(), want, rtol=1e-2,
                               atol=1e-2 * np.abs(want).max())


@pytest.mark.parametrize("b,s,nh,kvh,d", [(2, 32, 4, 2, 16), (1, 16, 4, 4, 16)])
def test_flash_attention_model_layout_matches_jax(b, s, nh, kvh, d):
    rng = np.random.default_rng(2)
    q = rng.normal(size=(b, s, nh, d)).astype(np.float32)
    k = rng.normal(size=(b, s, kvh, d)).astype(np.float32)
    v = rng.normal(size=(b, s, kvh, d)).astype(np.float32)
    lengths = np.asarray([s, s - 3][:b], np.int32)
    for lens, soft in ((None, False), (lengths, False), (lengths, True)):
        want = JFA.flash_attention(*(jnp.asarray(a) for a in (q, k, v)),
                                   lengths=None if lens is None else jnp.asarray(lens),
                                   softmax_bf16=soft)
        got = TFA.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                                  lengths=None if lens is None else torch.from_numpy(lens),
                                  softmax_bf16=soft)
        assert tuple(got.shape) == (b, s, nh * d)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   **(dict(rtol=1e-2, atol=1e-2) if soft else TOL))


def test_cpu_counts_no_launch_and_meta_raises():
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 8, 16, 64))
    lens = torch.tensor([16], dtype=torch.int32)
    n = TFA._flash_fwd.launches
    TFA._flash_fwd(q, k, v, lens)
    assert TFA._flash_fwd.launches == n
    with pytest.raises(ValueError):
        TFA._flash_fwd(q.to("meta"), k.to("meta"), v.to("meta"), lens.to("meta"))
