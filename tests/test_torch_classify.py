"""Port parity: the sequence-classification head (llm_qat_torch.models.llama
``init_classifier_params`` / ``classify`` / ``classification_loss``) against
the JAX package's, on the CPU.

JAX's classifier params (``init_classifier_params``, ``score`` included) are
carried to the port with ``params.from_numpy``; the same numpy ids go through
both. Limits: pooled logits at 1e-4 (rtol and atol; float32, the forward's
summation orders only; the serving tests' logit limit), in bf16 at 1e-2
relative L2 with JAX compiled without excess precision; losses at 1e-5
relative.

Rounding flips (the class ``tests/test_torch_llama_train.py`` names): every
quantizer's codes are recorded in both packages; at the first tensor where
they part, every parting element must be one level apart and lie in one
sequence i, from token t on. Row i's pooled logits, when pooled at or after
t, are then held at a relative L2 of ``LT.FLIP_REL_L2``, every other row at
1e-4. Met here: the W8A8KV8 model at 32 columns without a pad id, whose row
of length 5 pools over 27 pad tokens: one quantizer's codes part at two of
those pad tokens (22 and 23), one level each.

The behaviours of ``tests/test_model.py::test_sequence_classification``
(pooling at the last non-pad token, the CE / MSE dispatch) are held on the
port alone at that test's 1e-4 / 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_qat_tpu.models import llama as JL
from llm_qat_tpu.models.config import TINY_TEST
from llm_qat_torch.models import llama as TL
from llm_qat_torch.models import params as TP

import tests.test_torch_llama_train as LT
from tests.test_torch_serving import tcfg

CFG = TINY_TEST.replace(w_bits=8, a_bits=8, kv_bits=8)
CONFIGS = {"w8a8kv8": CFG, "w4a8kv4": CFG.replace(w_bits=4, kv_bits=4), "fp": TINY_TEST}
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
BF16_REL_L2 = 1e-2
PAD = 0


def _both(cfg, num_labels, seed=0):
    jp = JL.init_classifier_params(cfg, jax.random.PRNGKey(seed), num_labels=num_labels)
    return jp, TP.from_numpy(jax.tree.map(np.asarray, jp), "cpu")


def _padded_ids(cfg, b, s, lens, seed=1):
    ids = np.random.default_rng(seed).integers(1, cfg.vocab_size, (b, s)).astype(np.int32)
    for i, n in enumerate(lens):
        ids[i, n:] = PAD
    return ids


def _first_flips(rec, b, s):
    """None when every code agrees; else (sequence, first token) of the
    first parting tensor's elements, after checking that each is one level
    apart and that all lie in one sequence."""
    assert [r[0] for r in rec["jax"]] == [r[0] for r in rec["torch"]]
    for rj, rt in zip(rec["jax"], rec["torch"]):
        cj = LT._codes(*rj[:3], rt[3], rj[4])
        ct = LT._codes(*rt[:3], rt[3], rt[4])
        assert cj.shape == ct.shape
        diff = np.argwhere(cj != ct)
        if len(diff):
            assert all(abs(int(cj[tuple(d)]) - int(ct[tuple(d)])) == 1 for d in diff), rj[0]
            at = sorted(LT._token_of(d, cj.shape, b, s) for d in diff)
            assert len({i for i, _ in at}) == 1, ("flips in more than one sequence", at)
            return at[0]
    return None


def _hold_pooled(got, want, flip, pooled_at):
    """Pooled logits ``[b, n]``: all at 1e-4 with no flip; with one at
    (sequence i, token t), row i at ``LT.FLIP_REL_L2`` if it pools at or
    after t, every other row at 1e-4."""
    keep = np.ones(len(got), bool)
    if flip is not None and pooled_at[flip[0]] >= flip[1]:
        keep[flip[0]] = False
        d = got[flip[0]] - want[flip[0]]
        assert np.linalg.norm(d) <= LT.FLIP_REL_L2 * np.linalg.norm(want[flip[0]])
    np.testing.assert_allclose(got[keep], want[keep], **LOGIT_TOL)


@pytest.mark.parametrize("name", list(CONFIGS))
@pytest.mark.parametrize("s,lens", [(10, (7, 10, 1)), (16, (16, 9, 3)), (32, (20, 32, 5))])
def test_classify_matches_jax(monkeypatch, name, s, lens):
    """Right-padded rows with a pad id and its mask: 10 columns take the
    score-matrix path, 16 and 32 the flash path with per-row lengths; then
    the same rows without a pad id, pooled at the last position."""
    cfg = CONFIGS[name]
    jp, tp = _both(cfg, num_labels=3)
    ids = _padded_ids(cfg, len(lens), s, lens)
    mask = (ids != PAD).astype(np.int32)
    rec = LT._record_quantizers(monkeypatch)
    for pad_kw, pooled_at in (({"pad_token_id": PAD}, [n - 1 for n in lens]),
                              ({}, [s - 1] * len(lens))):
        jmask = {"attention_mask": jnp.asarray(mask)} if pad_kw else {}
        tmask = {"attention_mask": torch.from_numpy(mask)} if pad_kw else {}
        want = np.asarray(JL.classify(jp, cfg, jnp.asarray(ids), **pad_kw, **jmask))
        jax.effects_barrier()
        got = TL.classify(tp, tcfg(cfg), torch.from_numpy(ids), **pad_kw, **tmask)
        assert got.dtype == torch.float32 and tuple(got.shape) == (len(lens), 3)
        _hold_pooled(got.numpy(), want, _first_flips(rec, len(lens), s), pooled_at)
        rec["jax"].clear()
        rec["torch"].clear()


def test_classify_bf16_matches_jax():
    """bf16 compute from f32 params, JAX compiled without excess precision."""
    cfg = CFG
    jp, tp = _both(cfg, num_labels=4)
    ids = _padded_ids(cfg, 3, 16, (16, 11, 4))
    mask = (ids != PAD).astype(np.int32)
    fn = jax.jit(lambda p, i, m: JL.classify(p, cfg, i, pad_token_id=PAD, attention_mask=m,
                                             dtype=jnp.bfloat16))
    args = (jp, jnp.asarray(ids), jnp.asarray(mask))
    want = np.asarray(fn.lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": False})(*args))
    got = TL.classify(tp, tcfg(cfg), torch.from_numpy(ids), pad_token_id=PAD,
                      attention_mask=torch.from_numpy(mask), dtype=torch.bfloat16).numpy()
    assert np.isfinite(got).all()
    assert np.linalg.norm(got - want) <= BF16_REL_L2 * np.linalg.norm(want)


@pytest.mark.parametrize("num_labels", [1, 3])
def test_classification_loss_matches_jax(num_labels):
    rng = np.random.default_rng(2)
    pooled = rng.normal(size=(5, num_labels)).astype(np.float32)
    labels = (rng.normal(size=5).astype(np.float32) if num_labels == 1
              else rng.integers(0, num_labels, 5).astype(np.int32))
    want = float(JL.classification_loss(jnp.asarray(pooled), jnp.asarray(labels)))
    got = TL.classification_loss(torch.from_numpy(pooled), torch.from_numpy(labels))
    assert got.dim() == 0 and got.dtype == torch.float32
    np.testing.assert_allclose(float(got), want, rtol=1e-5)


def test_sequence_classification_behaviours():
    """``tests/test_model.py::test_sequence_classification`` on the port:
    shape, padding after position 6 leaves the pooled logits as they were,
    finite CE and MSE."""
    cfg = tcfg(CFG)
    params = TL.init_classifier_params(cfg, num_labels=3, seed=0, device="cpu")
    ids = torch.from_numpy(np.random.default_rng(1).integers(1, cfg.vocab_size, (2, 10)))
    out = TL.classify(params, cfg, ids)
    assert tuple(out.shape) == (2, 3)
    ids_padded = torch.cat([ids[:, :7], torch.full((2, 3), PAD)], dim=1)
    a = TL.classify(params, cfg, ids[:, :7], pad_token_id=PAD,
                    attention_mask=torch.ones((2, 7), dtype=torch.int32))
    b = TL.classify(params, cfg, ids_padded, pad_token_id=PAD,
                    attention_mask=(ids_padded != PAD).to(torch.int32))
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4, atol=1e-5)
    assert np.isfinite(float(TL.classification_loss(out, torch.tensor([0, 2]))))
    assert np.isfinite(float(TL.classification_loss(out[:, :1], torch.tensor([0.5, -1.0]))))


def test_init_classifier_params_layout_and_seed():
    """Backbone without lm_head, a ``score`` head [H, num_labels] in the
    requested type; the seed decides every weight, and the head also
    depends on ``num_labels``."""
    cfg = tcfg(CFG)
    a = TL.init_classifier_params(cfg, num_labels=3, seed=4, device="cpu",
                                  dtype=torch.bfloat16)
    b = TL.init_classifier_params(cfg, num_labels=3, seed=4, device="cpu",
                                  dtype=torch.bfloat16)
    c = TL.init_classifier_params(cfg, num_labels=5, seed=4, device="cpu",
                                  dtype=torch.bfloat16)
    assert "lm_head" not in a and tuple(a["score"].shape) == (cfg.hidden_size, 3)
    assert a["score"].dtype == torch.bfloat16
    assert torch.equal(a["score"], b["score"]) and torch.equal(a["embed"], b["embed"])
    assert torch.equal(a["embed"], c["embed"])
    assert not torch.equal(a["score"], c["score"][:, :3])
    assert abs(float(c["score"].float().std()) - 0.02) < 0.005
    if not torch.cuda.is_available():       # the default device is the card
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TL.init_classifier_params(cfg, num_labels=3)
