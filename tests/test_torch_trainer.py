"""Port parity: llm_qat_torch.training.trainer against the JAX package's
training/trainer.py, on CPU in float32, from the same numpy weights, token ids
and gradients.

Losses and schedules are held at 1e-6 relative (the same fp32 formulas). The
optimizer is held against BOTH of the JAX package's optimizers (its
single-pass clip+AdamW and the optax chain) on random gradients over three
steps at 1e-6.

Whole train steps (2 layers, b*s = 32 rows; cases with two heads of 128 and
of 100, and one with 8 query heads over 2 kv heads of 80 at H = 640):
loss and grad_norm at 1e-4 relative; the first moment after step 1 is 0.1 x the clipped gradient, so it
is the gradient's witness and is held at a relative L2 of 1e-3 per leaf.
Updated params: at step 1 Adam moves a weight by lr * g / (|g| + 1e-8), so
where a gradient is within ~1e-8 of zero its update is anywhere in +-lr
whatever its exact value, and two correct implementations may differ by up to
2 lr there. The params are therefore held at 2.1 lr everywhere and at
1e-3 lr + 1e-6 |p| for all but 0.1% of a leaf's elements.

Rounding flips (the named class, ROADMAP.md section 3): before every step
both packages' student forward runs from the params each holds, every
quantizer's codes recorded (``tests/test_torch_llama_train.py``
``_record_quantizers`` / ``_first_flip``). Where they part, the first parting
tensor must part in one element by one level, the two packages' forward from
one set of params is held by ``_hold_outputs`` (the rows that cannot see a
flip at 1e-4), and the step is the flip step: the steps before it are held
at the limits above, it and the later ones are not (the two runs part there
by design), as
``tests/test_torch_trainer_parallel.py`` ``MESH_FLIPS`` does. Met on the
suite's CPU host: ``flat_unfused_narrow_seed0`` and ``tied_weight_decay`` at
step 2, ``gqa_head_dim_80_fused_seed15`` at step 3 (each first parting an
int8 activation code); the other cases meet none.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from llm_qat_tpu.models.config import LlamaConfig as JConfig
from llm_qat_tpu.training import trainer as JT
from llm_qat_torch.models import params as TP
from llm_qat_torch.training import trainer as TT

from llm_qat_tpu.models import llama as JL
from llm_qat_torch.models import llama as TL

from tests.test_torch_llama_train import _first_flip, _hold_outputs, _record_quantizers
from tests.test_torch_serving import np_params, tcfg

WIDE = JConfig(vocab_size=256, hidden_size=128, intermediate_size=256, num_hidden_layers=2,
               num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=128,
               w_bits=4, a_bits=8, kv_bits=4)
NARROW = WIDE.replace(hidden_size=64, intermediate_size=128)
# multi-head attention at head dim 128, the attention of the LLaMA-7B family
MHA128 = WIDE.replace(hidden_size=256, intermediate_size=512, num_attention_heads=2,
                      num_key_value_heads=2)
# head dims of the padded builds: OpenLLaMA-3B's MHA heads of 100 (H = 200 is no
# multiple of 128: the unfused route), and 8 query heads over 2 kv heads of 80
# (H = 640: the fused flash-layout route; at 100 that takes H = 3200)
MHA100 = WIDE.replace(hidden_size=200, intermediate_size=400, num_attention_heads=2,
                      num_key_value_heads=2)
GQA80 = WIDE.replace(hidden_size=640, intermediate_size=256, num_attention_heads=8,
                     num_key_value_heads=2)
LR = 1e-3


def _tree(fn, node):
    return {k: _tree(fn, v) for k, v in node.items()} if isinstance(node, dict) else fn(node)


def _leaves(node, prefix=""):
    for k in sorted(node):
        if isinstance(node[k], dict):
            yield from _leaves(node[k], f"{prefix}{k}/")
        else:
            yield prefix + k, node[k]


def _cfgs(**kw):
    kw.setdefault("compute_dtype", jnp.float32)
    j = JT.TrainConfig(**kw)
    kw["compute_dtype"] = torch.float32
    return j, TT.TrainConfig(**kw)


def test_train_config_defaults_match_jax():
    j, t = JT.TrainConfig(), TT.TrainConfig()
    for f in (f.name for f in JT.dataclasses.fields(j)):
        if f != "compute_dtype":
            assert getattr(t, f) == getattr(j, f), f
    assert t.compute_dtype == torch.bfloat16 and j.compute_dtype == jnp.bfloat16


@pytest.mark.parametrize("chunk", [0, 4, 5])
def test_kd_kl_loss_matches_jax(chunk):
    rng = np.random.default_rng(0)
    s = rng.normal(size=(3, 8, 40)).astype(np.float32) * 2
    t = rng.normal(size=(3, 8, 40)).astype(np.float32) * 2
    want = JT.kd_kl_loss(jnp.asarray(s), jnp.asarray(t), chunk)
    got = TT.kd_kl_loss(torch.from_numpy(s), torch.from_numpy(t), chunk)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    # chunked = unchunked; batchmean divides by the batch size only
    np.testing.assert_allclose(float(got), float(TT.kd_kl_loss(torch.from_numpy(s),
                                                               torch.from_numpy(t))), rtol=1e-6)
    ref = torch.nn.functional.kl_div(torch.log_softmax(torch.from_numpy(s), -1),
                                     torch.softmax(torch.from_numpy(t), -1),
                                     reduction="batchmean")
    np.testing.assert_allclose(float(got), float(ref), rtol=1e-5)


@pytest.mark.parametrize("chunk", [4, 8, 3])
def test_chunked_kd_kl_matches_jax_value_and_gradients(chunk):
    rng = np.random.default_rng(1)
    hs, ht = (rng.normal(size=(2, 8, 16)).astype(np.float32) for _ in range(2))
    ws, wt = (rng.normal(size=(16, 50)).astype(np.float32) * 0.3 for _ in range(2))
    jv, (jdh, jdw) = jax.value_and_grad(
        lambda h, w: JT.chunked_kd_kl(h, jnp.asarray(ht), w, jnp.asarray(wt), chunk),
        argnums=(0, 1))(jnp.asarray(hs), jnp.asarray(ws))
    th = torch.from_numpy(hs).requires_grad_(True)
    tw = torch.from_numpy(ws).requires_grad_(True)
    tv = TT.chunked_kd_kl(th, torch.from_numpy(ht), tw, torch.from_numpy(wt), chunk)
    tdh, tdw = torch.autograd.grad(tv, (th, tw))
    np.testing.assert_allclose(float(tv.detach()), float(jv), rtol=1e-6)
    np.testing.assert_allclose(tdh.numpy(), np.asarray(jdh), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(tdw.numpy(), np.asarray(jdw), rtol=1e-4, atol=1e-6)
    full = TT.kd_kl_loss(th.detach() @ tw.detach(), torch.from_numpy(ht) @ torch.from_numpy(wt))
    np.testing.assert_allclose(float(tv.detach()), float(full), rtol=1e-5)


SCHEDULES = {
    "cosine": dict(lr_schedule="cosine", total_steps=50),
    "cosine_warmup": dict(lr_schedule="cosine", total_steps=50, warmup_steps=7),
    "constant": dict(lr_schedule="constant"),
    "linear": dict(lr_schedule="linear", total_steps=40, warmup_steps=5),
}


@pytest.mark.parametrize("name", list(SCHEDULES))
def test_schedules_match_optax(name):
    j, t = _cfgs(learning_rate=3e-4, **SCHEDULES[name])
    js, ts = JT.make_schedule(j), TT.make_schedule(t)
    for step in (0, 1, 3, 6, 7, 8, 20, 34, 35, 36, 49, 50, 51, 1000):
        np.testing.assert_allclose(ts(step), float(js(step)), rtol=1e-6, atol=1e-12,
                                   err_msg=f"{name} step {step}")
    with pytest.raises(ValueError, match="unknown schedule"):
        TT.make_schedule(TT.TrainConfig(lr_schedule="exp"))


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("weight_decay,scale", [(0.0, 0.01), (0.1, 5.0)])
def test_optimizer_matches_both_jax_optimizers(fused, weight_decay, scale):
    """Random gradients over 3 steps, small (no clipping) and large (clipped),
    with and without weight decay: updated params and both moments at 1e-6."""
    j, t = _cfgs(learning_rate=LR, total_steps=10, weight_decay=weight_decay,
                 fused_optimizer=fused)
    rng = np.random.default_rng(2)
    shapes = {"a": (5, 7), "layers": {"b": (2, 3, 4), "c": (6,)}}
    p = _tree(lambda sh: rng.normal(size=sh).astype(np.float32), shapes)
    jtx, ttx = JT.make_optimizer(j), TT.make_optimizer(t)
    jp = _tree(jnp.asarray, p)
    jstate = jtx.init(jp)
    tp = _tree(lambda a: torch.from_numpy(a.copy()), p)
    tstate = ttx.init(tp)
    for step in range(3):
        g = _tree(lambda sh: (rng.normal(size=sh) * scale).astype(np.float32), shapes)
        jupd, jstate = jtx.update(_tree(jnp.asarray, g), jstate, jp)
        jp = optax.apply_updates(jp, jupd)
        tupd, tstate = ttx.update(_tree(torch.from_numpy, g), tstate, tp)
        tp = _tree(lambda a: a, TT.tree_map(lambda x, u: x + u, tp, tupd))
        for (name, a), (_, b) in zip(_leaves(TP.to_numpy(tp)), _leaves(jp)):
            np.testing.assert_allclose(a, np.asarray(b), rtol=1e-6, atol=1e-7,
                                       err_msg=f"step {step} {name}")
    count, mu, nu = TP.opt_state_to_numpy(tstate)
    adam = jstate if fused else jstate[1][0]
    assert int(count) == int(adam.count) == 3
    for (name, a), (_, b) in zip(_leaves(mu), _leaves(adam.mu)):
        # a moment is a sum of terms of the clipped gradients' size (<= 1): a
        # term's f32 rounding, 2**-24 x 0.1, stays when the terms cancel
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-6, atol=2e-8, err_msg=name)
    for (name, a), (_, b) in zip(_leaves(nu), _leaves(adam.nu)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=2e-6, atol=1e-12, err_msg=name)


def test_optimizer_state_round_trips_through_numpy():
    p = {"a": torch.ones(2, 3), "layers": {"b": torch.zeros(4)}}
    st = TT.make_optimizer(TT.TrainConfig()).init(p)
    st["count"] = 5
    st["mu"]["a"] += 0.25
    back = TP.opt_state_from_numpy(*TP.opt_state_to_numpy(st), device="cpu")
    assert back["count"] == 5 and torch.equal(back["mu"]["a"], st["mu"]["a"])
    assert torch.equal(back["nu"]["layers"]["b"], st["nu"]["layers"]["b"])
    j = JT.FusedClipAdamWState(*TP.opt_state_to_numpy(st))
    assert int(j.count) == 5 and j.mu["a"].shape == (2, 3)


def _trainers(cfg, jt, tt, teacher=True, seed=0):
    p, tch = np_params(cfg, seed=seed), np_params(cfg, seed=seed + 100)
    jtr = JT.Trainer(cfg, jt, _tree(jnp.asarray, p),
                     _tree(jnp.asarray, tch) if teacher else None)
    ttr = TT.Trainer(tcfg(cfg), tt, TP.from_numpy(p, "cpu"),
                     TP.from_numpy(tch, "cpu") if teacher else None, device="cpu")
    return jtr, ttr


def _batch(cfg, b=2, s=16, seed=9):
    ids = np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    return {"input_ids": ids, "labels": ids}


def _assert_params_close(tparams, jparams, lr, what):
    for (name, a), (_, b) in zip(_leaves(TP.to_numpy(tparams)), _leaves(jparams)):
        b = np.asarray(b)
        d = np.abs(a - b)
        assert d.max() <= 2.1 * lr, (what, name, d.max())
        tight = d <= 1e-3 * lr + 1e-6 * np.abs(b)
        assert tight.mean() >= 0.999, (what, name, tight.mean())


def _assert_rel_l2(ttree, jtree, limit, what):
    for (name, a), (_, b) in zip(_leaves(ttree), _leaves(jtree)):
        b = np.asarray(b)
        rel = np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)
        assert rel <= limit, (what, name, rel)


# With the weights of seed 0 the narrow case agrees to 1e-7 at step 1 and then
# meets a rounding flip: after the first update one 4-bit weight sits on a
# rounding boundary and the two packages' params, 1e-9 apart, quantize it to
# different integers (loss 2.9e-4 and grad_norm 1.7e-3 off at step 2). Seeds 1
# and 2 meet none and agree to 2e-6 over the three steps. Both are cases.
SEED_NARROW = 1
# At H = 640 the 32 rows put 20480 activations through every quantizer, and a
# last-bit difference of the two packages' f32 sums moves an int8 code one
# level in most seeds within three steps: 30 of seeds 15-50 meet such a flip
# in GQA80's run, and the same width at head dim 64 (10 query heads) meets
# one in seeds 4, 5, 7, 8 and 10 of 3-10, so the width, not the head dim,
# sets the rate; the port's fused and unfused routes give one loss to the
# bit where JAX's two routes part. Seed 30, the first of 15-50 that meets
# none, agrees to 4e-7 over the three steps; seed 15, the first that meets
# one, is a case of its own.
SEED_GQA80 = 30

# case -> (config, TrainConfig arguments, the weights' seed)
STEP_CASES = {
    "fused_flash_chunked_kl": (WIDE, dict(kl_chunk=8), 0),
    "fused_flash_full_kl": (WIDE, dict(), 0),
    "flat_unfused_narrow": (NARROW, dict(kl_chunk=4, remat=False), SEED_NARROW),
    "flat_unfused_narrow_seed0": (NARROW, dict(kl_chunk=4, remat=False), 0),
    "mse": (WIDE, dict(kd_loss_type="mse"), 0),
    "tied_weight_decay": (WIDE.replace(tie_word_embeddings=True),
                          dict(kl_chunk=8, weight_decay=0.05, lr_schedule="linear"), 0),
    "mha_head_dim_128": (MHA128, dict(kl_chunk=8), 0),
    "mha_head_dim_100": (MHA100, dict(kl_chunk=8), 0),
    "gqa_head_dim_80_fused": (GQA80, dict(kl_chunk=8), SEED_GQA80),
    "gqa_head_dim_80_fused_seed15": (GQA80, dict(kl_chunk=8), 15),
}


def _forward_codes(cfg, jparams, tparams, ids):
    """Both packages' student forward (JAX's from ``jparams``, the port's
    from ``tparams``), every quantizer's codes recorded: (record, JAX's
    logits, the port's logits)."""
    with pytest.MonkeyPatch.context() as mp:
        rec = _record_quantizers(mp)
        jl = JL.forward(jparams, cfg, jnp.asarray(ids))
        jax.effects_barrier()
        with torch.no_grad():
            tl = TL.forward(tparams, tcfg(cfg), torch.from_numpy(ids))
    return rec, np.asarray(jl), tl.numpy()


def _step_flip(cfg, jparams, tparams, ids):
    """Whether the step that starts from these params meets a rounding flip:
    both packages' student forward from the params each holds, every
    quantizer's codes recorded; None when they all agree, else the
    (sequence, token) of the first parting tensor's one flipped element
    (``_first_flip``: one element, one level; a 4-bit weight on a rounding
    boundary, where the params part by 1e-9, or an int8 activation). At such
    a step the forward of both packages from one set of params (JAX's) is
    held by ``_hold_outputs``: the rows that cannot see a flip there at 1e-4,
    the rest at FLIP_REL_L2. (From each package's own params, rows that see
    no flip may part by more than 1e-4: the two Adams' updates of a weight
    whose gradient is within ~1e-8 of zero part by up to 2 lr, the module
    docstring, and a tied embedding carries that into the logits.)"""
    b, s = ids.shape
    flip = _first_flip(_forward_codes(cfg, jparams, tparams, ids)[0], b, s)
    if flip is not None:
        rec, jl, tl = _forward_codes(cfg, jparams, TP.from_numpy(_tree(np.asarray, jparams),
                                                                 "cpu"), ids)
        _hold_outputs(tl, jl, _first_flip(rec, b, s))
    return flip


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_train_steps_match_jax(case):
    """One and three steps on the same batch: metrics, the gradient's
    witness (the first moment), params and second moment, each step before
    the one whose student forward meets a rounding flip (``_step_flip``)."""
    cfg, kw, seed = STEP_CASES[case]
    jt, tt = _cfgs(learning_rate=LR, total_steps=20, **kw)
    if cfg.tie_word_embeddings:
        strip = lambda p: {k: v for k, v in p.items() if k != "lm_head"}  # noqa: E731
        p, tch = strip(np_params(cfg)), strip(np_params(cfg, seed=100))
        jtr = JT.Trainer(cfg, jt, _tree(jnp.asarray, p), _tree(jnp.asarray, tch))
        ttr = TT.Trainer(tcfg(cfg), tt, TP.from_numpy(p, "cpu"), TP.from_numpy(tch, "cpu"),
                         device="cpu")
    else:
        jtr, ttr = _trainers(cfg, jt, tt, seed=seed)
    batch = _batch(cfg)
    losses, flip_step = [], None
    for step in (1, 2, 3):
        if flip_step is None and _step_flip(cfg, jtr.state.params, ttr.state.params,
                                            batch["input_ids"]) is not None:
            flip_step = step
        jm = jtr.train_step({k: jnp.asarray(v) for k, v in batch.items()})
        tm = ttr.train_step(batch)
        losses.append(float(tm["loss"]))
        if flip_step is not None:          # the runs part from here by design
            continue
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-4)
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-4)
        if step in (1, 3):
            count, mu, nu = TP.opt_state_to_numpy(ttr.state.opt_state)
            jo = jtr.state.opt_state
            assert int(count) == int(jo.count) == step == ttr.state.step == int(jtr.state.step)
            if step == 1:
                _assert_rel_l2(mu, jo.mu, 1e-3, f"{case} mu (0.1 x clipped gradient)")
                _assert_rel_l2(nu, jo.nu, 2e-3, f"{case} nu")
            _assert_params_close(ttr.state.params, jtr.state.params, step * LR,
                                 f"{case} step {step}")
    assert losses[-1] < losses[0]


def test_grad_accumulation_matches_jax():
    cfg = WIDE
    jt, tt = _cfgs(learning_rate=LR, total_steps=20, kl_chunk=8, grad_accum_steps=2)
    jtr, ttr = _trainers(cfg, jt, tt, seed=1)
    p0 = TP.to_numpy(ttr.state.params)
    for i in range(4):
        batch = _batch(cfg, seed=20 + i)
        jm = jtr.train_step({k: jnp.asarray(v) for k, v in batch.items()})
        tm = ttr.train_step(batch)
        # the loss is divided by the accumulation steps, the norm is the micro-batch's
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-4)
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-4)
        if i == 0:      # no update before the second micro-batch
            for (_, a), (_, b) in zip(_leaves(TP.to_numpy(ttr.state.params)), _leaves(p0)):
                np.testing.assert_array_equal(a, b)
        st, js = ttr.state.opt_state, jtr.state.opt_state
        assert st["mini_step"] == int(js.mini_step) == (i + 1) % 2
        assert st["gradient_step"] == int(js.gradient_step) == (i + 1) // 2
        assert st["inner"]["count"] == int(js.inner_opt_state.count)
    _assert_params_close(ttr.state.params, jtr.state.params, 2 * LR, "accumulated")


def test_label_ce_training_without_teacher():
    cfg = WIDE
    jt, tt = _cfgs(learning_rate=LR, total_steps=20, use_kd=False)
    jtr, ttr = _trainers(cfg, jt, tt, teacher=False, seed=2)
    batch = _batch(cfg, seed=30)
    for _ in range(2):
        jm = jtr.train_step({k: jnp.asarray(v) for k, v in batch.items()})
        tm = ttr.train_step(batch)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-4)
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-4)
    _assert_params_close(ttr.state.params, jtr.state.params, 2 * LR, "label CE")


def test_evaluate_matches_jax():
    cfg = WIDE
    jt, tt = _cfgs()
    jtr, ttr = _trainers(cfg, jt, tt, seed=3)
    batches = [_batch(cfg, b=2, s=16, seed=40), _batch(cfg, b=1, s=16, seed=41)]
    batches[1]["labels"] = np.where(np.arange(16)[None] < 6, batches[1]["labels"], -100)
    batches[0]["attention_mask"] = np.ones((2, 16), np.int32)
    je = jtr.evaluate([{k: jnp.asarray(v) for k, v in b.items()} for b in batches])
    te = ttr.evaluate(batches)
    np.testing.assert_allclose(te["eval_loss"], je["eval_loss"], rtol=1e-5)
    np.testing.assert_allclose(te["perplexity"], je["perplexity"], rtol=1e-4)
    assert ttr.evaluate([]) == {"eval_loss": 0.0, "perplexity": 1.0}


def test_teacher_is_untouched_and_shared_leaves_are_copied():
    """The port updates the student in place: a student made from the
    teacher's own tensors must not move the teacher."""
    cfg = tcfg(WIDE)
    teacher = TP.from_numpy(np_params(WIDE, seed=5), "cpu")
    before = TP.to_numpy(teacher)
    student = {k: (dict(v) if isinstance(v, dict) else v) for k, v in teacher.items()}
    student["embed"] = student["embed"].clone()          # one leaf of its own
    tr = TT.Trainer(cfg, TT.TrainConfig(kl_chunk=8, compute_dtype=torch.float32,
                                        learning_rate=LR, total_steps=10),
                    student, teacher, device="cpu")
    assert tr.state.params["embed"] is student["embed"]  # unshared leaves are kept
    assert tr.state.params["layers"]["q"] is not teacher["layers"]["q"]
    # the student equals the teacher here, so the KD loss and its gradient are
    # 0 but for the quantization: move the student first
    with torch.no_grad():
        tr.state.params["layers"]["q"].mul_(1.5)
    for _ in range(2):
        m = tr.train_step(_batch(WIDE))
    assert float(m["loss"]) > 0 and np.isfinite(float(m["grad_norm"]))
    for (name, a), (_, b) in zip(_leaves(TP.to_numpy(teacher)), _leaves(before)):
        np.testing.assert_array_equal(a, b, err_msg=name)
    moved = np.abs(TP.to_numpy(tr.state.params)["layers"]["o"] - before["layers"]["o"]).max()
    assert moved > 0


def test_multi_device_arguments_raise():
    """The JAX package's checks: "pp" and "cp" need a mesh with that axis
    (``tests/test_trainer_ppcp.py``); a mesh is a ``DeviceMesh``. The
    multi-device paths themselves: ``tests/test_torch_trainer_parallel.py``."""
    cfg = tcfg(WIDE)
    p = TP.init_params(cfg, device="cpu")
    for kw in (dict(parallel="pp"), dict(parallel="cp")):
        with pytest.raises(ValueError, match="needs a mesh with that axis"):
            TT.Trainer(cfg, TT.TrainConfig(), p, device="cpu", **kw)
    with pytest.raises(TypeError, match="DeviceMesh"):
        TT.Trainer(cfg, TT.TrainConfig(), p, device="cpu", mesh=object())
    with pytest.raises(ValueError, match="unknown parallel mode"):
        TT.Trainer(cfg, TT.TrainConfig(), p, device="cpu", parallel="zero")
    with pytest.raises(ValueError, match="needs a mesh with that axis"):
        TT.make_train_step(cfg, cfg, TT.TrainConfig(), None, parallel="pp")


def test_trainer_raises_without_gpu_unless_cpu_asked():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the CUDA default is valid here")
    cfg = tcfg(WIDE)
    p = TP.init_params(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TT.Trainer(cfg, TT.TrainConfig(), p)
    with pytest.raises(ValueError, match="expected"):
        TT.Trainer(cfg, TT.TrainConfig(), {"embed": torch.zeros(2, device="meta")}, device="cpu")
