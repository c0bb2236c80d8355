"""Port parity: the training / scoring forward of llm_qat_torch.models.llama
(forward, final_hidden, the losses, and gradients through the fake-quant
layers) against llm_qat_tpu.models.llama, on CPU in float32, from the same
numpy weights and token ids.

Routes (both packages pick theirs from the same flags and shapes): the fused
flash-layout route (H a multiple of 128, flash on), the fused flat route
(flash off, or a non-prefix mask, which falls back to the full score matrix),
the unfused route (H = 64: the RMSNorm+quant kernel's shape gate is false)
and the fp model. Cases are kept at b*s <= 32 rows and 2 layers: every
projection input is re-quantized to int8, and beyond some 30 rows a run meets
an activation that XLA's and torch's f32 sums round to different integers,
which moves a loss by 1e-3. Logits are held at 1e-4 (rtol and atol); the
gradient of a scalar loss at a relative L2 of 1e-3 per leaf (f32 matmuls in
another order, through two layers of STE masks).

Rounding flips (a named class): even at 32 rows, whether an activation lands
on the other side of a rounding edge depends on the host's f32 sums. Where
it does, the forward checks (``_hold_outputs``) record every quantizer's
integer codes in both packages, in order, and name the first tensor whose
codes part: it must differ in one element by one level, and every code
before it must be equal. The output rows that cannot see that element (other
sequences, and the flipped sequence's earlier tokens) stay at 1e-4; the rows
at and after it are held at a relative L2 of ``FLIP_REL_L2``. Met on an AMD
EPYC host: ``asym_layerwise`` (seed 0) flips layer 2's down-projection input
at sequence 1, token 6; ``test_final_hidden_positions_and_compute_dtype``
(seed 5) flips layer 1's attention-output quant at sequence 0, token 13.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import llm_qat_tpu.ops.fused_layer as JFL
import llm_qat_tpu.ops.pallas.fused_quant as JFQ
import llm_qat_tpu.ops.pallas.qat_matmul as JQM
import llm_qat_tpu.ops.quantize as JQ
import llm_qat_torch.ops.fused_layer as TFL
import llm_qat_torch.ops.fused_quant as TFQ
import llm_qat_torch.ops.qat_matmul as TQM
import llm_qat_torch.ops.quantize as TQ
from llm_qat_tpu.models import llama as JL
from llm_qat_tpu.models.config import LlamaConfig as JConfig
from llm_qat_torch.models import llama as TL
from llm_qat_torch.models import params as TP

from tests.test_torch_serving import np_params, tcfg

LOGITS = dict(rtol=1e-4, atol=1e-4)
FLIP_REL_L2 = 0.05   # rows that see a flipped code: measured 2.7e-4 (logits), 7.0e-3 (hidden)
WIDE = JConfig(vocab_size=256, hidden_size=128, intermediate_size=256, num_hidden_layers=2,
               num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=128,
               w_bits=4, a_bits=8, kv_bits=4)
ROUTES = {
    "fused_flash_gqa": WIDE,
    "fused_flash_mha": WIDE.replace(num_key_value_heads=None),
    "fused_flash_w8": WIDE.replace(w_bits=8, kv_bits=8),
    "fused_flash_silu": WIDE.replace(fused_silu_quant=True),
    "fused_flat": WIDE.replace(use_flash_attention=False),
    "fused_flat_silu": WIDE.replace(use_flash_attention=False, fused_silu_quant=True),
    "unfused_matmul": WIDE.replace(fused_qat_matmul=False),
    "unfused_narrow": WIDE.replace(hidden_size=64, intermediate_size=128),
    "no_norm_fusion_flash": WIDE.replace(fused_norm_quant=False),
    "tied": WIDE.replace(tie_word_embeddings=True),
    "fp": WIDE.replace(w_bits=32, a_bits=32, kv_bits=32),
    "kv16": WIDE.replace(kv_bits=32),
    "asym_layerwise": WIDE.replace(symmetric=False, act_layerwise=True),
}


def _tree(fn, node):
    return {k: _tree(fn, v) for k, v in node.items()} if isinstance(node, dict) else fn(node)


def _setup(cfg, b=2, s=16, seed=0):
    p = np_params(cfg, seed=seed)
    if cfg.tie_word_embeddings:
        del p["lm_head"]
    rng = np.random.default_rng(seed + 1)
    ids = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    return p, ids


def _record_quantizers(monkeypatch):
    """Wrap every quantizer of both packages' forward paths so that each call
    appends ``(kind, bits, axis, input, outputs)`` to a list per package (the
    JAX side through an ordered callback, as the calls sit inside a scan)."""
    rec = {"jax": [], "torch": []}

    def flat(out):
        return list(out) if isinstance(out, tuple) else [out]

    def wrap_jax(kind, f):
        def g(x, bits, axis=-1, *a, **kw):
            out = f(x, bits, axis, *a, **kw)
            jax.debug.callback(lambda x_, *o: rec["jax"].append(
                (kind, bits, axis, np.asarray(x_, np.float32), [np.asarray(t) for t in o])),
                x, *flat(out), ordered=True)
            return out
        return g

    def wrap_torch(kind, f):
        def g(x, bits, axis=-1, *a, **kw):
            out = f(x, bits, axis, *a, **kw)
            rec["torch"].append((kind, bits, axis, x.detach().float().numpy(),
                                 [t.detach().numpy() for t in flat(out)]))
            return out
        return g

    def rms_jax(f):
        def g(h, gain, eps, bits):
            return wrap_jax("int", lambda x, b, a: f(x, gain, eps, b))(h, bits)
        return g

    def rms_torch(f):
        def g(h, gain, eps, bits):
            return wrap_torch("int", lambda x, b, a: f(x, gain, eps, b))(h, bits)
        return g

    for name, kind in (("sym_fake_quant", "sym"), ("asym_fake_quant", "asym")):
        monkeypatch.setattr(JQ, name, wrap_jax(kind, getattr(JQ, name)))
        monkeypatch.setattr(TQ, name, wrap_torch(kind, getattr(TQ, name)))
    monkeypatch.setattr(TL, "sym_fake_quant", TQ.sym_fake_quant)
    monkeypatch.setattr(JQM, "_quant_int", wrap_jax("int", JQM._quant_int))
    monkeypatch.setattr(JFL, "_quant_int", JQM._quant_int)
    monkeypatch.setattr(TQM, "_quant_int", wrap_torch("int", TQM._quant_int))
    monkeypatch.setattr(TFL, "_quant_int", TQM._quant_int)
    heads_j, heads_t = JFL._quant_per_token_heads, TFL._quant_per_token_heads
    monkeypatch.setattr(JFL, "_quant_per_token_heads",
                        wrap_jax("int", lambda x, b, a: heads_j(x, b)))
    monkeypatch.setattr(TFL, "_quant_per_token_heads",
                        wrap_torch("int", lambda x, b, a: heads_t(x, b)))
    monkeypatch.setattr(JFQ, "rmsnorm_quant", rms_jax(JFQ.rmsnorm_quant))
    monkeypatch.setattr(TFQ, "rmsnorm_quant", rms_torch(TFQ.rmsnorm_quant))
    return rec


def _codes(kind, bits, axis, x_ref, out):
    """Integer codes of a quantizer's output: its integer output as is; a
    fake-quant output mapped back onto its levels with the torch side's
    statistics (``x_ref``), so both packages' outputs land on one grid."""
    if kind == "int":
        return out[0].astype(np.int64)
    ax = TQ._canon_axis(axis)
    x = torch.from_numpy(x_ref)
    o = torch.from_numpy(np.asarray(out[0], np.float32))
    if kind == "sym":
        s = (2 ** (bits - 1) - 1) / (TQ._reduce(x.abs(), ax, "amax") + TQ._SYM_EPS)
        return torch.round(o * (s + TQ._SYM_EPS)).numpy().astype(np.int64)
    lo = TQ._reduce(x, ax, "amin")
    alpha = TQ._reduce(x, ax, "amax") - lo
    return torch.round((o - lo) / (alpha + TQ._ASYM_EPS) * (2 ** bits - 1)).numpy().astype(np.int64)


def _token_of(index, shape, b, s):
    """(sequence, token) of an element of an activation of ``b`` sequences of
    ``s`` tokens: flat rows ``[b*s, ...]``, ``[b, s, ...]``, or the flash
    layouts ``[b, kvh, s, d]`` and ``[b, kvh, g, s, d]``."""
    if shape[0] == b * s:
        return divmod(int(index[0]), s)
    return int(index[0]), int(index[{2: 1, 3: 1, 4: 2, 5: 3}[len(shape)]])


def _first_flip(rec, b, s):
    """None when every code agrees; else the (sequence, token) of the one
    element of the first parting tensor, after checking that it is one
    element one level apart."""
    assert [r[0] for r in rec["jax"]] == [r[0] for r in rec["torch"]]
    for rj, rt in zip(rec["jax"], rec["torch"]):
        cj = _codes(*rj[:3], rt[3], rj[4])
        ct = _codes(*rt[:3], rt[3], rt[4])
        assert cj.shape == ct.shape
        diff = np.argwhere(cj != ct)
        if len(diff):
            assert len(diff) == 1 and abs(int(cj[tuple(diff[0])]) - int(ct[tuple(diff[0])])) == 1, (
                "codes part by more than one flip", rj[0], len(diff))
            return _token_of(diff[0], cj.shape, b, s)
    return None


def _hold_outputs(got, want, flip):
    """``got``/``want`` ``[b, s, ...]``: all at 1e-4 with no flip; with one at
    (sequence i, token t), every row but sequence i's tokens >= t at 1e-4 and
    those at a relative L2 of ``FLIP_REL_L2``."""
    if flip is None:
        np.testing.assert_allclose(got, want, **LOGITS)
        return
    i, t = flip
    keep = np.ones(got.shape[:2], bool)
    keep[i, t:] = False
    np.testing.assert_allclose(got[keep], want[keep], **LOGITS)
    d = got[i, t:] - want[i, t:]
    assert np.linalg.norm(d) <= FLIP_REL_L2 * np.linalg.norm(want[i, t:]), np.linalg.norm(d)


def _jax_loss_and_grads(cfg, p, ids, loss_of_logits, **kw):
    def loss(params):
        return loss_of_logits(JL.forward(params, cfg, jnp.asarray(ids), **kw))
    return jax.value_and_grad(loss)(_tree(jnp.asarray, p))


def _torch_loss_and_grads(cfg, p, ids, loss_of_logits, **kw):
    tp = TP.from_numpy(p, "cpu")
    leaves = []
    _tree(lambda t: leaves.append(t.requires_grad_(True)), tp)
    loss = loss_of_logits(TL.forward(tp, tcfg(cfg), torch.from_numpy(ids), **kw))
    flat = iter(torch.autograd.grad(loss, leaves))
    return loss.detach(), _tree(lambda t: next(flat), tp)


def _assert_grads_close(tg, jg, prefix=""):
    for k in jg:
        if isinstance(jg[k], dict):
            _assert_grads_close(tg[k], jg[k], f"{prefix}{k}/")
            continue
        t, j = tg[k].numpy(), np.asarray(jg[k])
        assert t.shape == j.shape, prefix + k
        rel = np.linalg.norm(t - j) / max(np.linalg.norm(j), 1e-30)
        assert rel <= 1e-3, (prefix + k, rel)


@pytest.mark.parametrize("route", list(ROUTES))
def test_forward_and_gradients_match_jax(route, monkeypatch):
    cfg = ROUTES[route]
    p, ids = _setup(cfg)
    with monkeypatch.context() as mp:
        rec = _record_quantizers(mp)
        jlogits = JL.forward(_tree(jnp.asarray, p), cfg, jnp.asarray(ids))
        jax.effects_barrier()
        tlogits = TL.forward(TP.from_numpy(p, "cpu"), tcfg(cfg), torch.from_numpy(ids))
    assert tlogits.dtype == torch.float32 and tuple(tlogits.shape) == jlogits.shape
    _hold_outputs(tlogits.numpy(), np.asarray(jlogits), _first_flip(rec, *ids.shape))

    labels = np.where(np.arange(ids.shape[1])[None] < 3, -100, ids).astype(np.int32)
    jl, jg = _jax_loss_and_grads(cfg, p, ids,
                                 lambda lg: JL.causal_lm_loss(lg, jnp.asarray(labels)))
    tl, tg = _torch_loss_and_grads(cfg, p, ids,
                                   lambda lg: TL.causal_lm_loss(lg, torch.from_numpy(labels)))
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    _assert_grads_close(tg, jg)


def test_the_routes_are_the_ones_named(monkeypatch):
    """The fused flash-layout route runs the RMSNorm+quant producer twice a
    layer and the flash function once; the narrow model runs neither producer."""
    from llm_qat_torch.ops import flash_attention as TFA
    from llm_qat_torch.ops import fused_quant as TFQ

    calls = {"norm": 0, "silu": 0, "flash": 0}
    real_n, real_s, real_f = TFQ.rmsnorm_quant, TFQ.silu_mul_quant, TFA._flash_fwd
    monkeypatch.setattr(TFQ, "rmsnorm_quant",
                        lambda *a: (calls.__setitem__("norm", calls["norm"] + 1), real_n(*a))[1])
    monkeypatch.setattr(TFQ, "silu_mul_quant",
                        lambda *a: (calls.__setitem__("silu", calls["silu"] + 1), real_s(*a))[1])
    monkeypatch.setattr(TFA, "_flash_fwd", lambda *a, **k: (
        calls.__setitem__("flash", calls["flash"] + 1), real_f(*a, **k))[1])
    want = {"fused_flash_gqa": (4, 0, 2), "fused_flash_silu": (4, 2, 2), "fused_flat": (4, 0, 0),
            "unfused_narrow": (0, 0, 2), "fp": (0, 0, 2)}
    for route, counts in want.items():
        cfg = ROUTES[route]
        p, ids = _setup(cfg)
        for k in calls:
            calls[k] = 0
        TL.forward(TP.from_numpy(p, "cpu"), tcfg(cfg), torch.from_numpy(ids))
        assert (calls["norm"], calls["silu"], calls["flash"]) == counts, route


@pytest.mark.parametrize("route", ["fused_flash_gqa", "unfused_narrow"])
def test_padded_batch_rides_as_lengths(route):
    """A right-padded prefix mask: flash with per-sequence lengths. Logits of
    the kept positions and the gradient of their loss match."""
    cfg = ROUTES[route]
    p, ids = _setup(cfg, seed=2)
    mask = (np.arange(16)[None] < np.asarray([16, 9])[:, None]).astype(np.int32)
    labels = np.where(mask == 1, ids, -100).astype(np.int32)
    jl, jg = _jax_loss_and_grads(cfg, p, ids, lambda lg: JL.causal_lm_loss(lg, jnp.asarray(labels)),
                                 attention_mask=jnp.asarray(mask))
    tl, tg = _torch_loss_and_grads(cfg, p, ids,
                                   lambda lg: TL.causal_lm_loss(lg, torch.from_numpy(labels)),
                                   attention_mask=torch.from_numpy(mask))
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    _assert_grads_close(tg, jg)
    jlogits = JL.forward(_tree(jnp.asarray, p), cfg, jnp.asarray(ids),
                         attention_mask=jnp.asarray(mask))
    tlogits = TL.forward(TP.from_numpy(p, "cpu"), tcfg(cfg), torch.from_numpy(ids),
                         attention_mask=torch.from_numpy(mask))
    keep = mask.astype(bool)
    np.testing.assert_allclose(tlogits.numpy()[keep], np.asarray(jlogits)[keep], **LOGITS)


def test_non_prefix_mask_falls_back_to_the_full_score_matrix(monkeypatch):
    """Left padding is no prefix: both packages leave the flash path (the JAX
    package for a concrete mask; eager PyTorch has no traced masks, so its
    NaN sentinel has no counterpart here)."""
    from llm_qat_torch.ops import flash_attention as TFA

    cfg = ROUTES["fused_flash_gqa"]
    p, ids = _setup(cfg, seed=3)
    mask = np.ones((2, 16), np.int32)
    mask[1, :5] = 0
    monkeypatch.setattr(TFA, "_flash_fwd", lambda *a, **k: pytest.fail("flash path taken"))
    jlogits = JL.forward(_tree(jnp.asarray, p), cfg, jnp.asarray(ids),
                         attention_mask=jnp.asarray(mask))
    tlogits = TL.forward(TP.from_numpy(p, "cpu"), tcfg(cfg), torch.from_numpy(ids),
                         attention_mask=torch.from_numpy(mask))
    keep = mask.astype(bool)
    np.testing.assert_allclose(tlogits.numpy()[keep], np.asarray(jlogits)[keep], **LOGITS)
    assert np.isfinite(tlogits.numpy()).all()


@pytest.mark.parametrize("route", ["fused_flash_gqa", "fused_flat", "unfused_narrow", "fp"])
@pytest.mark.parametrize("policy", ["save_attn", "none"])
def test_remat_changes_nothing(route, policy):
    """A rematerialized layer recomputes the same numbers: loss and every
    gradient are bit-equal with remat on and off; with ``save_attn`` the
    flash forward runs once a layer, with ``none`` twice."""
    from llm_qat_torch.ops import flash_attention as TFA

    cfg = ROUTES[route]
    p, ids = _setup(cfg, seed=4)
    loss_of = lambda lg: TL.causal_lm_loss(lg, torch.from_numpy(ids))  # noqa: E731
    l0, g0 = _torch_loss_and_grads(cfg, p, ids, loss_of)
    calls = []
    real = TFA._flash_fwd
    TFA._flash_fwd = lambda *a, **k: (calls.append(1), real(*a, **k))[1]
    try:
        l1, g1 = _torch_loss_and_grads(cfg, p, ids, loss_of, remat=True, remat_policy=policy)
    finally:
        TFA._flash_fwd = real
    assert torch.equal(l0, l1)
    flat0, flat1 = [], []
    _tree(flat0.append, g0), _tree(flat1.append, g1)
    assert all(torch.equal(a, b) for a, b in zip(flat0, flat1))
    if route != "fused_flat":
        assert len(calls) == cfg.num_hidden_layers * (1 if policy == "save_attn" else 2)


def test_final_hidden_positions_and_compute_dtype(monkeypatch):
    cfg = ROUTES["fused_flash_gqa"]
    p, ids = _setup(cfg, seed=5)
    pos = (np.arange(16)[None] + np.asarray([[0], [7]])).astype(np.int32)
    with monkeypatch.context() as mp:
        rec = _record_quantizers(mp)
        jh = JL.final_hidden(_tree(jnp.asarray, p), cfg, jnp.asarray(ids),
                             positions=jnp.asarray(pos))
        jax.effects_barrier()
        th = TL.final_hidden(TP.from_numpy(p, "cpu"), tcfg(cfg), torch.from_numpy(ids),
                             positions=torch.from_numpy(pos))
    _hold_outputs(th.numpy(), np.asarray(jh), _first_flip(rec, *ids.shape))
    # f32 master params under a bf16 compute type: the residual stream stays
    # bf16, the logits come out f32
    tb = TL.final_hidden(TP.from_numpy(p, "cpu"), tcfg(cfg), torch.from_numpy(ids),
                         dtype=torch.bfloat16)
    assert tb.dtype == torch.float32      # bf16 stream times the f32 final gain
    hb = TL.backbone(TP.from_numpy(p, "cpu"), tcfg(cfg), torch.from_numpy(ids),
                     dtype=torch.bfloat16)
    jb = JL.backbone(_tree(jnp.asarray, p), cfg, jnp.asarray(ids), dtype=jnp.bfloat16)
    assert hb.dtype == torch.bfloat16 and jb.dtype == jnp.bfloat16
    lg = TL.forward(TP.from_numpy(p, "cpu", torch.bfloat16), tcfg(cfg), torch.from_numpy(ids),
                    dtype=torch.bfloat16)
    assert lg.dtype == torch.float32 and bool(torch.isfinite(lg).all())


def test_losses_and_small_pieces_match_jax():
    rng = np.random.default_rng(6)
    logits = rng.normal(size=(2, 9, 50)).astype(np.float32)
    labels = rng.integers(0, 50, (2, 9)).astype(np.int32)
    labels[0, 4:] = -100
    js, jc = JL.causal_lm_loss_sum(jnp.asarray(logits), jnp.asarray(labels))
    ts, tc = TL.causal_lm_loss_sum(torch.from_numpy(logits), torch.from_numpy(labels))
    np.testing.assert_allclose(float(ts), float(js), rtol=1e-6)
    assert float(tc) == float(jc)
    np.testing.assert_allclose(
        float(TL.causal_lm_loss(torch.from_numpy(logits), torch.from_numpy(labels))),
        float(JL.causal_lm_loss(jnp.asarray(logits), jnp.asarray(labels))), rtol=1e-6)
    allpad = np.full((2, 9), -100, np.int32)
    assert float(TL.causal_lm_loss(torch.from_numpy(logits), torch.from_numpy(allpad))) == 0.0
    mask = (rng.uniform(size=(2, 6)) < 0.7).astype(np.int32)
    for m in (None, mask):
        jm = JL.causal_mask(2, 6, None if m is None else jnp.asarray(m))
        tm = TL.causal_mask(2, 6, None if m is None else torch.from_numpy(m))
        np.testing.assert_array_equal(np.broadcast_to(tm.numpy(), jm.shape), np.asarray(jm))
    x = rng.normal(size=(2, 3, 4, 8)).astype(np.float32)
    c, s = rng.normal(size=(2, 1, 4, 8)).astype(np.float32), rng.normal(size=(2, 1, 4, 8)).astype(np.float32)
    np.testing.assert_allclose(
        TL._rope_rotate(*(torch.from_numpy(a) for a in (x, c, s))).numpy(),
        np.asarray(JL._rope_rotate(*(jnp.asarray(a) for a in (x, c, s)))), rtol=1e-6, atol=1e-6)
    cfg = ROUTES["tied"]
    p, _ = _setup(cfg)
    head = TL.head_matrix(TP.from_numpy(p, "cpu"), tcfg(cfg))
    np.testing.assert_array_equal(head.numpy(), np.asarray(JL.head_matrix(_tree(jnp.asarray, p), cfg)))
