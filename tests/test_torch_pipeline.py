"""Port parity: GPipe pipeline parallelism (``llm_qat_torch.parallel.pipeline``
and ``Trainer(parallel="pp")``) on gloo ranks spawned on the CPU through
``parallel.launch``, against the JAX package's ``parallel/pipeline.py`` and
its trainer on the suite's fake CPU devices, in float64 from the same numpy
weights and batches. One spawn a world size (2 and 4) runs every job.

The cases are the JAX package's: ``tests/test_pipeline.py``'s (4 layers,
width 32, vocabulary 97; the forward at (pp, microbatches) = (2, 2), (4, 4)
and (4, 2), the CE gradient at (4, 4); the errors for ``b % M`` and
``L % P``) and ``tests/test_trainer_ppcp.py``'s (``TINY_TEST`` at W4A8KV8, a
KD step and a label-CE step at pp = 2, held against one device), plus a KD
step with 4 microbatches at pp = 2.

Limits. The forward at JAX's pipeline forward's, rtol = atol = 1e-6 (the
logits are fp32 in both packages), and bit for bit against the port's
one-device forward (a stage runs the same layers on a microbatch's rows);
the gradients at rtol 1e-6 plus 1e-6 of the leaf's largest element against
JAX's, the embedding's summed over 'pp' and every replicated leaf equal on
every rank. The steps as ``test_trainer_ppcp.py`` holds them against one
device (the loss at rel 1e-8, at least 99.9% of each leaf within
1e-6 + 1e-6 |p|, the rest within 2 lr), against the port's one-device run;
the first step also against JAX's pp run, with the loss at rel 1e-6 (the
port's losses are fp32, as its logits are, JAX's float64 under x64: ~1e-7
apart).

The ranks import this module, so JAX is imported inside the reference
functions only.
"""

import copy

import numpy as np
import pytest
import torch

from llm_qat_torch.parallel import launch

LR = 1e-3
PIPE = dict(vocab_size=97, hidden_size=32, intermediate_size=64, num_hidden_layers=4,
            num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=32,
            w_bits=4, a_bits=8, kv_bits=4)
FORWARD_CASES = ((2, 2), (4, 4), (4, 2))          # (pp, microbatches)
GRAD_CASE = (4, 4)
# case -> (TrainConfig fields, teacher)
STEP_CASES = {"kd": (dict(), True), "label_ce": (dict(use_kd=False), False),
              "kd_4_microbatches": (dict(num_microbatches=4), True)}


def _pipe_cfg():
    from llm_qat_tpu.models.config import LlamaConfig

    return LlamaConfig(**PIPE)


def _step_cfg():
    from llm_qat_tpu.models.config import TINY_TEST

    return TINY_TEST.replace(w_bits=4, a_bits=8, kv_bits=8)


def _f64(tree):
    if isinstance(tree, dict):
        return {k: _f64(v) for k, v in tree.items()}
    return np.asarray(tree, np.float64)


def _weights(cfg, seed):
    from tests.test_torch_serving import np_params

    return _f64(np_params(cfg, seed))


def _ids(cfg, seed, b=4, s=16):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, s)).astype(np.int32)


def _leaves(tree, prefix=""):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _leaves(tree[k], f"{prefix}{k}/")
        else:
            yield prefix + k, tree[k]


# --- the ranks' jobs ---------------------------------------------------------


def _forward(mesh, tcfg, params, ids, M):
    from llm_qat_torch.models import params as TP
    from llm_qat_torch.parallel import pipeline as PP

    sp = PP.shard_params_pp(TP.from_numpy(copy.deepcopy(params), "cpu"), mesh)
    with torch.no_grad():
        return PP.pipeline_forward(sp, tcfg, torch.as_tensor(ids), mesh,
                                   num_microbatches=M).numpy()


def _grads(mesh, tcfg, params, ids, M):
    """The CE gradient through the pipeline, the embedding's summed over
    'pp' (as the trainer sums it), every layer gathered whole; the
    replicated leaves as this rank holds them."""
    from llm_qat_torch.models import params as TP
    from llm_qat_torch.parallel import comm
    from llm_qat_torch.parallel import mesh as pmesh
    from llm_qat_torch.parallel import pipeline as PP

    sp = PP.shard_params_pp(TP.from_numpy(copy.deepcopy(params), "cpu"), mesh)
    for _, t in _leaves(sp):
        t.requires_grad_(True)
    ids_t = torch.as_tensor(ids)
    PP.pipeline_lm_loss(sp, tcfg, {"input_ids": ids_t, "labels": ids_t}, mesh,
                        num_microbatches=M, remat=True).backward()
    grad = lambda t: torch.zeros_like(t) if t.grad is None else t.grad  # noqa: E731
    grads = {k: ({n: grad(t) for n, t in v.items()} if isinstance(v, dict) else grad(v))
             for k, v in sp.items()}
    comm.all_reduce_(grads["embed"], pmesh.axis_group(mesh, "pp"))
    whole = pmesh.gather_params(grads, mesh, PP.pipeline_param_specs())
    return {n: g.numpy() for n, g in _leaves(whole)}


def _train(mesh, tcfg, params, teacher, batch, kw, steps=2):
    from llm_qat_torch.models import params as TP
    from llm_qat_torch.parallel import mesh as pmesh
    from llm_qat_torch.training import trainer as TT

    tc = TT.TrainConfig(learning_rate=LR, total_steps=10, remat=False,
                        compute_dtype=torch.float64, **kw)
    tr = TT.Trainer(tcfg, tc, TP.from_numpy(copy.deepcopy(params), "cpu"),
                    TP.from_numpy(copy.deepcopy(teacher), "cpu") if teacher is not None else None,
                    mesh=mesh, parallel="pp", device="cpu")
    out = {"metrics": [], "params": [],
           "shapes": {n: tuple(t.shape) for n, t in _leaves(tr.state.opt_state["mu"])}}
    for _ in range(steps):
        m = tr.train_step(batch)
        out["metrics"].append(float(m["loss"]))
        whole = pmesh.gather_params(tr.state.params, mesh, tr.param_specs)
        out["params"].append({n: np.array(a) for n, a in _leaves(TP.to_numpy(whole))})
    out["eval"] = tr.evaluate([batch])["eval_loss"]
    return out


def _errors(mesh, tcfg, params, ids):
    from llm_qat_torch.models import params as TP
    from llm_qat_torch.parallel import pipeline as PP

    sp = PP.shard_params_pp(TP.from_numpy(copy.deepcopy(params), "cpu"), mesh)
    out = {}
    for name, fn in (("microbatches", lambda: PP.pipeline_forward(
            sp, tcfg, torch.as_tensor(ids), mesh, num_microbatches=3)),
                     ("layers", lambda: PP.pipeline_backbone(
            sp, tcfg.replace(num_hidden_layers=6), torch.as_tensor(ids), mesh,
            num_microbatches=2))):
        try:
            fn()
        except ValueError as e:
            out[name] = str(e)
    return out


def _rank_jobs(rank, world, jobs):
    from llm_qat_torch.parallel import mesh as pmesh

    mesh = pmesh.make_mesh(fsdp=1, pp=world)
    return {name: globals()[fn](mesh, *args) for name, fn, args in jobs}


# --- the JAX side ------------------------------------------------------------


def _jax_pp_mesh(pp):
    import jax
    from jax.sharding import Mesh

    return Mesh(np.asarray(jax.devices()[:pp]), ("pp",))


@pytest.fixture(scope="module")
def runs():
    from tests.test_torch_serving import tcfg

    pcfg, scfg = tcfg(_pipe_cfg()), tcfg(_step_cfg())
    params, ids = _weights(_pipe_cfg(), 0), _ids(_pipe_cfg(), 1)
    jobs = {2: [], 4: []}
    for pp, M in FORWARD_CASES:
        jobs[pp].append((f"forward {pp} {M}", "_forward", (pcfg, params, ids, M)))
    jobs[4].append(("grads", "_grads", (pcfg, _weights(_pipe_cfg(), 7), _ids(_pipe_cfg(), 8),
                                        GRAD_CASE[1])))
    jobs[4].append(("errors", "_errors", (pcfg, params, ids)))
    sp, tp_ = _weights(_step_cfg(), 1), _weights(_step_cfg(), 0)
    sids = _ids(_step_cfg(), 2)
    batch = {"input_ids": sids, "labels": sids}
    for case, (kw, kd) in STEP_CASES.items():
        jobs[2].append((case, "_train", (scfg, sp, tp_ if kd else None, batch, kw)))
    return {w: launch.spawn(_rank_jobs, w, args=(jobs[w],), timeout=240) for w in (2, 4)}


@pytest.mark.parametrize("pp,M", FORWARD_CASES)
def test_pipeline_forward_matches_jax(runs, pp, M):
    import jax
    import jax.numpy as jnp

    from llm_qat_tpu.models import llama as JL
    from llm_qat_tpu.parallel import pipeline as JP
    from llm_qat_torch.models import llama
    from llm_qat_torch.models import params as TP
    from tests.test_torch_serving import tcfg

    params, ids = _weights(_pipe_cfg(), 0), _ids(_pipe_cfg(), 1)
    cfg = _pipe_cfg()
    with jax.enable_x64(True):
        mesh = _jax_pp_mesh(pp)
        jp = jax.tree.map(jnp.asarray, params)
        want = np.asarray(jax.jit(lambda p, i: JP.pipeline_forward(
            p, cfg, i, mesh, num_microbatches=M))(JP.shard_params_pp(jp, mesh), jnp.asarray(ids)))
        one = np.asarray(JL.forward(jp, cfg, jnp.asarray(ids)))
    np.testing.assert_allclose(want, one, rtol=1e-6, atol=1e-6)
    with torch.no_grad():
        port_one = llama.forward(TP.from_numpy(copy.deepcopy(params), "cpu"), tcfg(cfg),
                                 torch.as_tensor(ids)).numpy()
    for r in runs[pp]:
        got = r[f"forward {pp} {M}"]
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
        assert np.array_equal(got, port_one)


def test_pipeline_grads_match_jax(runs):
    import jax
    import jax.numpy as jnp

    from llm_qat_tpu.parallel import pipeline as JP

    pp, M = GRAD_CASE
    params, ids = _weights(_pipe_cfg(), 7), _ids(_pipe_cfg(), 8)
    cfg = _pipe_cfg()
    with jax.enable_x64(True):
        mesh = _jax_pp_mesh(pp)
        jp = JP.shard_params_pp(jax.tree.map(jnp.asarray, params), mesh)
        batch = {"input_ids": jnp.asarray(ids), "labels": jnp.asarray(ids)}
        want = jax.jit(jax.grad(lambda p: JP.pipeline_lm_loss(p, cfg, batch, mesh,
                                                              num_microbatches=M)))(jp)
        want = {n: np.asarray(g) for n, g in _leaves(want)}
    for r in runs[pp]:
        for n, g in r["grads"].items():
            w = want[n]
            np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6 * np.abs(w).max(), err_msg=n)
    for n in ("embed", "final_norm", "lm_head"):       # the same on every stage
        for r in runs[pp][1:]:
            assert np.array_equal(r["grads"][n], runs[pp][0]["grads"][n]), n


def _jax_pp_train(params, teacher, batch, kw, steps):
    import jax
    import jax.numpy as jnp

    from llm_qat_tpu.parallel import mesh as JM
    from llm_qat_tpu.training import trainer as JT

    with jax.enable_x64(True):
        jt = JT.TrainConfig(learning_rate=LR, total_steps=10, remat=False,
                            compute_dtype=jnp.float64, **kw)
        tree = lambda p: jax.tree.map(jnp.asarray, p)  # noqa: E731
        mesh = JM.make_mesh(data=1, fsdp=1, tp=1, pp=2, devices=jax.devices()[:2])
        tr = JT.Trainer(_step_cfg(), jt, tree(params), tree(teacher) if teacher else None,
                        mesh=mesh, parallel="pp")
        out = {"metrics": [], "params": []}
        for _ in range(steps):
            m = tr.train_step({k: jnp.asarray(v) for k, v in batch.items()})
            out["metrics"].append(float(m["loss"]))
            out["params"].append({n: np.array(a) for n, a in _leaves(tr.state.params)})
        return out


def _one_device_train(params, teacher, batch, kw, steps=2):
    """The port's one-device run of ``_train``'s steps."""
    from llm_qat_torch.models import params as TP
    from llm_qat_torch.training import trainer as TT
    from tests.test_torch_serving import tcfg

    kw = {k: v for k, v in kw.items() if k != "num_microbatches"}
    tc = TT.TrainConfig(learning_rate=LR, total_steps=10, remat=False,
                        compute_dtype=torch.float64, **kw)
    tr = TT.Trainer(tcfg(_step_cfg()), tc, TP.from_numpy(copy.deepcopy(params), "cpu"),
                    TP.from_numpy(copy.deepcopy(teacher), "cpu") if teacher is not None else None,
                    device="cpu")
    out = {"metrics": [], "params": []}
    for _ in range(steps):
        out["metrics"].append(float(tr.train_step(batch)["loss"]))
        out["params"].append({n: np.array(a) for n, a in _leaves(TP.to_numpy(tr.state.params))})
    out["eval"] = tr.evaluate([batch])["eval_loss"]
    return out


def _hold_params(got, want, what):
    for n, b in want.items():
        d = np.abs(got[n] - b)
        assert (d <= 1e-6 + 1e-6 * np.abs(b)).mean() >= 0.999, (what, n)
        assert d.max() < 2 * LR, (what, n, d.max())


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_pp_train_steps_match_one_device_and_jax(runs, case):
    """``test_trainer_ppcp.py``'s hold of the pp steps against one device
    (the loss at rel 1e-8), on the port's own one-device run; and the first
    step against JAX's pp run. Later steps against JAX can meet the
    one-device flip class (a 4-bit weight on a rounding boundary after an
    update: label CE's second step parts from JAX by 4e-6 on ONE device
    already)."""
    kw, kd = STEP_CASES[case]
    sp, tp_ = _weights(_step_cfg(), 1), _weights(_step_cfg(), 0)
    sids = _ids(_step_cfg(), 2)
    batch = {"input_ids": sids, "labels": sids}
    teacher = tp_ if kd else None
    one = _one_device_train(sp, teacher, batch, kw)
    want = _jax_pp_train(sp, teacher, batch, kw, steps=1)
    for r in runs[2]:
        got = r[case]
        for step, (gl, ol) in enumerate(zip(got["metrics"], one["metrics"])):
            assert gl == pytest.approx(ol, rel=1e-8), (case, step)
            _hold_params(got["params"][step], one["params"][step], f"{case} step {step + 1}")
        assert got["metrics"][0] == pytest.approx(want["metrics"][0], rel=1e-6), case
        _hold_params(got["params"][0], want["params"][0], f"{case} step 1 against JAX")
        # the moments of the layers split over 'pp', the rest whole
        for n, shape in got["shapes"].items():
            full = dict(_leaves(sp))[n].shape
            assert shape == ((full[0] // 2, *full[1:]) if n.startswith("layers/") else full), n
        assert got["eval"] == pytest.approx(one["eval"], rel=1e-8), case


def test_pipeline_errors_as_jax(runs):
    import jax
    import jax.numpy as jnp

    from llm_qat_tpu.parallel import pipeline as JP

    for r in runs[4]:
        assert "batch 4 not divisible by microbatches 3" in r["errors"]["microbatches"]
        assert "layers 6 not divisible by pp=4" in r["errors"]["layers"]
    params, ids = _weights(_pipe_cfg(), 0), _ids(_pipe_cfg(), 1)
    mesh = _jax_pp_mesh(4)
    sharded = JP.shard_params_pp(jax.tree.map(jnp.asarray, params), mesh)
    with pytest.raises(ValueError, match="not divisible by microbatches"):
        JP.pipeline_forward(sharded, _pipe_cfg(), jnp.asarray(ids), mesh, num_microbatches=3)
    with pytest.raises(ValueError, match="not divisible by pp"):
        JP.pipeline_backbone(sharded, _pipe_cfg().replace(num_hidden_layers=6), jnp.asarray(ids),
                             mesh, num_microbatches=2)
