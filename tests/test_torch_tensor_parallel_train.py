"""Port parity: KD-QAT training over the mesh's 'tp' axis (the Megatron split
of ``parallel/mesh.py:param_specs``, ``parallel.tensor``), on gloo ranks
spawned on the CPU through ``parallel.launch``, against the JAX package's
GSPMD runs of the same specs on the suite's fake CPU devices, in float64
from the same numpy weights and batches, on ``TINY_TEST``'s widths (2
layers, width 64, 4 query and 2 kv heads, so a tp = 2 rank holds one kv
head and its two query heads). One spawn a world size (2: data = 1,
fsdp = 1, tp = 2; 4: data = 1, fsdp = 2, tp = 2) runs every job.

Limits. The quantizers' scales, the int8 products and the logits run in
fp32 in both packages whatever the params' type (``qat_matmul``'s and the
head's f32 products), so float64 params bound the agreement at fp32's
rounding, as in JAX's own tests:

* the forward at ``test_parallel.py:test_tp_sharded_forward_matches_single_
  device``'s limits (rtol = atol = 1e-6) against JAX's mesh forward, and bit
  for bit against the port's one-device forward (every quantizer statistic
  is an exact MAX over 'tp', the int8 partial products an exact sum);
* the gradient of ``1e-6 sum(logits^2)`` at ``test_grad_under_fsdp_tp_
  matches``'s rtol 1e-6 plus 1e-6 of the leaf's largest gradient, against
  JAX's mesh gradient: the column-parallel ``dx`` sums its fp32 partials over
  'tp' in another order than one device's product, ~5e-7 of the largest
  element (JAX's atol of 1e-8 is below fp32's step at these magnitudes);
* three KD-QAT steps through ``Trainer`` held as
  ``test_trainer.py:test_sharded_train_step_matches_unsharded`` holds its
  step, but with the loss at rel 1e-6 for the label CE and the MSE (the
  port's losses are fp32, as its logits are, where JAX's are float64 under
  x64: ~3e-7 apart), and at rel 1e-5 for the KL, whose fp32 log-sum-exp
  over the vocabulary meets over 'tp' (a partial sum a rank, then their
  sum: ~3e-6 from one device's order); at least 99.9% of each leaf within
  1e-6 + 1e-6 |p| and the rest within 2 lr after each step. ``MESH_FLIPS``
  would name a step at which a rounding flip parts the runs (none at this
  seed: seed 0 of these weights flips an fp32 ``dx`` partial sum into a
  4-bit weight code at step 2, the flip class of ROADMAP.md section 3);
* the row-parallel integer product, the vocabulary-parallel embedding, and
  K13's plain given-max entry bit-equal to one device; the 1- and 2-bit
  scaled means, a per-tensor weight scale and the asymmetric activation
  quantizer over a split dim at rtol 1e-12 (float64); the chunked KL at rel
  1e-6 and its gradients at rtol 1e-5 plus 1e-5 of the largest element
  against JAX's one-device ``kd_kl_loss`` (the port's head products and
  their backward are fp32, JAX's float64 here).

JAX's ``chunked_kd_kl`` does not trace in float64 (its scan carries an f32
total and the body returns f64), so the port's chunked runs are held
against JAX's unchunked KL (``kl_chunk=0``), which its docstring gives the
same numbers.

The ranks import this module, so JAX is imported inside the reference
functions only.
"""

import copy

import numpy as np
import pytest
import torch

from llm_qat_torch.parallel import launch

LR = 1e-3
STEPS = 3
SEED = 1              # seed 0 meets a flip at step 2 (see the docstring)
WIDTHS = dict(vocab_size=256, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
              num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=128)
MESHES = {2: dict(data=1, fsdp=1, tp=2), 4: dict(data=1, fsdp=2, tp=2)}
B, S = 4, 16
CHUNK = 8
# case -> (world, TrainConfig fields, LlamaConfig fields)
STEP_CASES = {
    "tp2_chunked_kl": (2, dict(kl_chunk=CHUNK), {}),
    "fsdp2_tp2_chunked_kl": (4, dict(kl_chunk=CHUNK), {}),
    "tp2_label_ce": (2, dict(use_kd=False), {}),
    "tp2_mse": (2, dict(kd_loss_type="mse"), {}),
    "tp2_fused_silu_quant": (2, dict(kl_chunk=CHUNK), dict(fused_silu_quant=True)),
}
MESH_FLIPS = {}       # case -> the step at which a named rounding flip parts the runs


def _jcfg(**kw):
    from llm_qat_tpu.models.config import LlamaConfig

    return LlamaConfig(**WIDTHS, w_bits=4, a_bits=8, kv_bits=4, **kw)


def _f64(tree):
    if isinstance(tree, dict):
        return {k: _f64(v) for k, v in tree.items()}
    return np.asarray(tree, np.float64)


def _weights(seed=SEED):
    from tests.test_torch_serving import np_params

    return _f64(np_params(_jcfg(), seed)), _f64(np_params(_jcfg(), seed + 100))


def _ids():
    return np.random.default_rng(9).integers(0, WIDTHS["vocab_size"], (B, S)).astype(np.int32)


def _leaves(tree, prefix=""):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _leaves(tree[k], f"{prefix}{k}/")
        else:
            yield prefix + k, tree[k]


# --- the ranks' jobs ---------------------------------------------------------


def _grads_whole(tr_ranks, mesh, params):
    """The gradients of ``params`` (this rank's shards) reduced as the
    trainer reduces them, gathered whole."""
    from llm_qat_torch.parallel import mesh as pmesh

    grads = {k: ({n: t.grad for n, t in v.items()} if isinstance(v, dict) else v.grad)
             for k, v in params.items()}
    tr_ranks.reduce_grads(grads)
    return pmesh.gather_params(grads, mesh)


def _fwd_grad(mesh, tcfg, params, ids):
    """This rank's rows of the logits; the gradient of ``1e-6 sum(logits^2)``
    over the global batch, whole."""
    from llm_qat_torch.models import llama
    from llm_qat_torch.models import params as TP
    from llm_qat_torch.parallel import mesh as pmesh
    from llm_qat_torch.training.trainer import _Ranks

    p = pmesh.shard_params(TP.from_numpy(copy.deepcopy(params), "cpu"), mesh)
    for _, t in _leaves(p):
        t.requires_grad_(True)
    rows = pmesh.shard_batch({"ids": torch.as_tensor(ids)}, mesh)["ids"]
    logits = llama.forward(p, tcfg, rows, mesh=mesh)
    (1e-6 * (logits ** 2).sum()).backward()
    whole = _grads_whole(_Ranks(mesh, "fsdp", pmesh.param_specs()), mesh, p)
    return logits.detach().numpy(), {n: g.numpy() for n, g in _leaves(whole)}


def _train(mesh, tcfg, params, teacher, batch, kw):
    """Per step the metrics and the whole params; the shapes the rank holds;
    the evaluation."""
    from llm_qat_torch.models import params as TP
    from llm_qat_torch.parallel import mesh as pmesh
    from llm_qat_torch.training import trainer as TT

    tc = TT.TrainConfig(learning_rate=LR, total_steps=20, compute_dtype=torch.float64, **kw)
    tr = TT.Trainer(tcfg, tc, TP.from_numpy(copy.deepcopy(params), "cpu"),
                    TP.from_numpy(copy.deepcopy(teacher), "cpu") if teacher is not None else None,
                    mesh=mesh, device="cpu")
    out = {"metrics": [], "params": [],
           "shapes": {n: tuple(t.shape) for n, t in _leaves(tr.state.params)},
           "mu_shapes": {n: tuple(t.shape) for n, t in _leaves(tr.state.opt_state["mu"])}}
    out["eval_before"] = tr.evaluate([batch])["eval_loss"]
    for _ in range(STEPS):
        m = tr.train_step(batch)
        out["metrics"].append((float(m["loss"]), float(m["grad_norm"])))
        whole = pmesh.gather_params(tr.state.params, mesh, tr.param_specs)
        out["params"].append({n: np.array(a) for n, a in _leaves(TP.to_numpy(whole))})
    out["eval"] = tr.evaluate([batch])["eval_loss"]
    return out


def _pieces(mesh, tcfg, params, teacher, ids):
    """The tp-split building blocks against one device, on this rank."""
    from llm_qat_torch.models import llama
    from llm_qat_torch.models import params as TP
    from llm_qat_torch.ops import fused_quant as FQ
    from llm_qat_torch.ops import qat_matmul as QM
    from llm_qat_torch.parallel import mesh as pmesh
    from llm_qat_torch.parallel import tensor as ptensor
    from llm_qat_torch.training import trainer as TT

    tp = pmesh.tp_group(mesh)
    n, r = ptensor.size(tp), ptensor.rank(tp)
    g = torch.Generator().manual_seed(5)
    out = {}
    # the row-parallel integer product: this rank's K block, summed over tp
    x = torch.randn(24, 128, generator=g, dtype=torch.float64)
    w = 0.02 * torch.randn(128, 64, generator=g, dtype=torch.float64)
    cols = slice(r * 128 // n, (r + 1) * 128 // n)
    xq, sx = QM._quant_int(x[:, cols], 8, -1, tp)
    wq, sw = QM._quant_int(w[cols], 4, 0, tp)
    got = QM.int_dense(xq, sx, wq, sw, torch.float64, tp)
    xq1, sx1 = QM._quant_int(x, 8, -1)
    wq1, sw1 = QM._quant_int(w, 4, 0)
    want = QM.int_dense(xq1, sx1, wq1, sw1, torch.float64)
    out["row_parallel_bit_equal"] = bool(torch.equal(got, want) and torch.equal(sx, sx1)
                                         and torch.equal(sw, sw1)
                                         and torch.equal(xq, xq1[:, cols]))
    # the other quantizers over a split dim: the scaled means at 1 and 2 bits
    # (SUM over tp, the global count), per-tensor weights, the asymmetric
    # activation quantizer (MIN and MAX), against one device's on the whole
    from llm_qat_torch.ops import quantize as Q

    out["quantizers_close"] = []
    for fn, whole_t, ax in (
            (lambda t, gr: Q.weight_fake_quant(t, 1, group=gr), w, 0),
            (lambda t, gr: Q.weight_fake_quant(t, 2, group=gr), w, 0),
            (lambda t, gr: Q.weight_fake_quant(t, 4, layerwise=True, group=gr), w, 0),
            (lambda t, gr: Q.act_fake_quant(t, 8, symmetric=False, group=gr), x, 1)):
        cols = slice(r * 128 // n, (r + 1) * 128 // n)
        part = whole_t[cols] if ax == 0 else whole_t[:, cols]
        want_part = fn(whole_t, None)
        want_part = want_part[cols] if ax == 0 else want_part[:, cols]
        out["quantizers_close"].append(bool(torch.allclose(fn(part, tp), want_part, rtol=1e-12,
                                                           atol=1e-15)))
    # K13 with the row max over tp: its plain given-max path against one device's plain K13
    gate = 2 * torch.randn(16, 256, generator=g)
    up = torch.randn(16, 256, generator=g)
    cols = slice(r * 256 // n, (r + 1) * 256 // n)
    amax = ptensor.max_over_tp(FQ.silu_mul_amax(gate[:, cols], up[:, cols]), tp)
    yq, sy = FQ.silu_mul_quant(gate[:, cols], up[:, cols], 8, amax=amax)
    yq1, sy1 = FQ._silu_mul_quant_plain(gate, up, 8)
    out["k13_given_max_bit_equal"] = bool(torch.equal(yq, yq1[:, cols]) and torch.equal(sy, sy1))
    # the vocabulary-parallel embedding lookup
    table = torch.from_numpy(params["embed"])
    v = table.shape[0] // n
    ids_t = torch.as_tensor(ids).long()
    out["embed_bit_equal"] = bool(torch.equal(
        ptensor.vocab_embed(table[r * v:(r + 1) * v], ids_t, tp), table[ids_t]))
    # the chunked KL over the vocabulary's split, and its gradient
    hs = 0.5 * torch.randn(B, S, WIDTHS["hidden_size"], generator=g, dtype=torch.float64)
    ht = 0.5 * torch.randn(B, S, WIDTHS["hidden_size"], generator=g, dtype=torch.float64)
    head_s = torch.from_numpy(params["lm_head"]).clone()
    head_t = torch.from_numpy(teacher["lm_head"]).clone()
    hs_l = hs.clone().requires_grad_(True)
    head_l = head_s[:, r * v:(r + 1) * v].clone().requires_grad_(True)
    kl = TT.chunked_kd_kl(hs_l, ht, head_l, head_t[:, r * v:(r + 1) * v], CHUNK, tp=tp)
    kl.backward()
    dhead = pmesh.gather_params({"lm_head": head_l.grad}, mesh, {"lm_head": (None, "tp")})
    out["chunked_kl"] = dict(kl=float(kl), dh=hs_l.grad.numpy(),
                             dhead=dhead["lm_head"].numpy(), inputs=(hs.numpy(), ht.numpy()))
    # the column-parallel head's logits, gathered whole by the forward
    out["logits_tp"] = llama.head_logits(hs, head_s[:, r * v:(r + 1) * v], tp).numpy()
    return out


def _rank_jobs(rank, world, jobs):
    from llm_qat_torch.parallel import mesh as pmesh

    mesh = pmesh.make_mesh(**MESHES[world])
    return {name: globals()[fn](mesh, *args) for name, fn, args in jobs}


def _refusals(rank, world):
    """What the port refuses, as JAX refuses it: a mesh that is not the
    world, a split a dim does not divide; and, the port's own, a tp that
    does not divide the kv heads (a rank holds whole kv heads)."""
    from llm_qat_torch.models import params as TP
    from llm_qat_torch.models.config import LlamaConfig
    from llm_qat_torch.parallel import mesh as pmesh
    from llm_qat_torch.training import trainer as TT

    out = {}
    try:
        pmesh.make_mesh(data=1, fsdp=1, tp=3)
    except ValueError as e:
        out["mesh"] = str(e)
    mesh = pmesh.make_mesh(data=1, fsdp=1, tp=2)
    for name, kw in (("vocab", dict(vocab_size=255)), ("kv_heads", dict(num_key_value_heads=1))):
        cfg = LlamaConfig(**{**WIDTHS, **kw}, w_bits=4, a_bits=8, kv_bits=4)
        from tests.test_torch_serving import np_params

        try:
            TT.Trainer(cfg, TT.TrainConfig(compute_dtype=torch.float32),
                       TP.from_numpy(np_params(cfg), "cpu"), mesh=mesh, device="cpu")
        except ValueError as e:
            out[name] = str(e)
    return out


# --- the JAX side ------------------------------------------------------------


def _jax_mesh(world):
    import jax

    from llm_qat_tpu.parallel import mesh as JM

    return JM.make_mesh(devices=jax.devices()[:world], **MESHES[world])


def _jax_fwd_grad(world, params, ids):
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding

    from llm_qat_tpu.models import llama as JL
    from llm_qat_tpu.parallel import mesh as JM

    cfg = _jcfg()
    mesh = _jax_mesh(world)
    with jax.enable_x64(True):
        sp = JM.shard_params(jax.tree.map(jnp.asarray, params), mesh)
        ids_s = jax.device_put(jnp.asarray(ids), NamedSharding(mesh, JM.batch_spec()))
        logits = jax.jit(lambda p, i: JL.forward(p, cfg, i))(sp, ids_s)
        grads = jax.jit(jax.grad(lambda p, i: jnp.sum(JL.forward(p, cfg, i) ** 2) * 1e-6))(
            sp, ids_s)
        return np.asarray(logits), {n: np.asarray(g) for n, g in _leaves(grads)}


def _jax_train(world, params, teacher, batch, kw, ckw):
    import jax
    import jax.numpy as jnp

    from llm_qat_tpu.training import trainer as JT

    with jax.enable_x64(True):
        # the unchunked KL: JAX's chunked one does not trace in float64
        jt = JT.TrainConfig(learning_rate=LR, total_steps=20, compute_dtype=jnp.float64,
                            **{**kw, "kl_chunk": 0})
        tree = lambda p: jax.tree.map(jnp.asarray, p)  # noqa: E731
        tr = JT.Trainer(_jcfg(**ckw), jt, tree(params),
                        tree(teacher) if teacher is not None else None, mesh=_jax_mesh(world))
        out = {"metrics": [], "params": []}
        for _ in range(STEPS):
            m = tr.train_step({k: jnp.asarray(v) for k, v in batch.items()})
            out["metrics"].append((float(m["loss"]), float(m["grad_norm"])))
            out["params"].append({n: np.array(a) for n, a in _leaves(tr.state.params)})
        return out


def _nest(flat):
    """A tree of copies from ``{"a/b": array}`` names."""
    tree = {}
    for n, a in flat.items():
        *path, leaf = n.split("/")
        node = tree
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = np.array(a)
    return tree


def _jax_eval(params, batch, ckw):
    """JAX's one-device ``make_eval_step`` on ``params`` (flat names): the
    token-weighted mean label CE."""
    import jax
    import jax.numpy as jnp

    from llm_qat_tpu.training import trainer as JT

    with jax.enable_x64(True):
        nll, count = jax.jit(JT.make_eval_step(_jcfg(**ckw), jnp.float64))(
            jax.tree.map(jnp.asarray, _nest(params)),
            {k: jnp.asarray(v) for k, v in batch.items()})
        return float(nll) / float(count)


def _port_eval(params, batch, ckw):
    """The port's one-device ``Trainer.evaluate`` on ``params`` (flat names)."""
    from llm_qat_torch.models import params as TP
    from llm_qat_torch.training import trainer as TT
    from tests.test_torch_serving import tcfg

    tr = TT.Trainer(tcfg(_jcfg(**ckw)), TT.TrainConfig(compute_dtype=torch.float64),
                    TP.from_numpy(_nest(params), "cpu"), device="cpu")
    return tr.evaluate([batch])["eval_loss"]


# --- the runs ----------------------------------------------------------------


@pytest.fixture(scope="module")
def runs():
    from tests.test_torch_serving import tcfg

    params, teacher = _weights()
    ids = _ids()
    batch = {"input_ids": ids, "labels": ids}
    jobs = {2: [("pieces", "_pieces", (tcfg(_jcfg()), params, teacher, ids))], 4: []}
    for world in (2, 4):
        jobs[world].append(("fwd_grad", "_fwd_grad", (tcfg(_jcfg()), params, ids)))
    for case, (world, kw, ckw) in STEP_CASES.items():
        t = teacher if kw.get("use_kd", True) else None
        jobs[world].append((case, "_train", (tcfg(_jcfg(**ckw)), params, t, batch, kw)))
    out = {w: launch.spawn(_rank_jobs, w, args=(jobs[w],), timeout=240) for w in (2, 4)}
    out["refusals"] = launch.spawn(_refusals, 2, timeout=120)
    return out


def _one_device_forward(params, ids):
    from llm_qat_torch.models import llama
    from llm_qat_torch.models import params as TP
    from tests.test_torch_serving import tcfg

    with torch.no_grad():
        return llama.forward(TP.from_numpy(copy.deepcopy(params), "cpu"), tcfg(_jcfg()),
                             torch.as_tensor(ids)).numpy()


@pytest.mark.parametrize("world", [2, 4])
def test_forward_and_grads_match_jax_mesh(runs, world):
    params, _ = _weights()
    ids = _ids()
    want_logits, want_grads = _jax_fwd_grad(world, params, ids)
    one = _one_device_forward(params, ids)
    rows = ids.shape[0] // (world // 2)
    for rank, r in enumerate(runs[world]):
        logits, grads = r["fwd_grad"]
        f = (rank // 2) * rows        # the rank's rows: its fsdp index
        np.testing.assert_allclose(logits, want_logits[f:f + rows], rtol=1e-6, atol=1e-6)
        assert np.array_equal(logits, one[f:f + rows]), rank
        for n, g in grads.items():
            w = want_grads[n]
            np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6 * np.abs(w).max(), err_msg=n)


def _hold_params(got, want, what):
    for n, b in want.items():
        a = got[n]
        d = np.abs(a - b)
        tight = d <= 1e-6 + 1e-6 * np.abs(b)
        assert tight.mean() >= 0.999, (what, n, tight.mean())
        assert d.max() < 2 * LR, (what, n, d.max())


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_train_steps_match_jax_mesh(runs, case):
    world, kw, ckw = STEP_CASES[case]
    params, teacher = _weights()
    ids = _ids()
    batch = {"input_ids": ids, "labels": ids}
    want = _jax_train(world, params, teacher if kw.get("use_kd", True) else None, batch, kw, ckw)
    kl = kw.get("use_kd", True) and kw.get("kd_loss_type", "kl") == "kl"
    rel = 1e-5 if kl else 1e-6
    flip = MESH_FLIPS.get(case, STEPS + 1)
    fsdp = MESHES[world]["fsdp"]
    split = {"embed": (0, 1), "lm_head": (1, 0), "layers/q": (2, 1), "layers/k": (2, 1),
             "layers/v": (2, 1), "layers/o": (1, 2), "layers/gate": (2, 1), "layers/up": (2, 1),
             "layers/down": (1, 2)}      # (the dim split over tp, over fsdp)
    full = dict(_leaves(params))
    for r in runs[world]:
        got = r[case]
        for step in range(min(flip, STEPS + 1) - 1):
            (gl, gn), (wl, wn) = got["metrics"][step], want["metrics"][step]
            assert abs(gl - wl) <= rel * abs(wl), (case, step, gl, wl)
            assert abs(gn - wn) <= 1e-6 * abs(wn), (case, step, gn, wn)
            _hold_params(got["params"][step], want["params"][step], f"{case} step {step + 1}")
        # the evaluation: before the steps JAX's eval step's, after them the
        # port's one-device evaluation of the params this run holds, to the bit
        # (JAX's eval of them can meet a flip: the params part by ~1e-7)
        assert got["eval_before"] == pytest.approx(_jax_eval(dict(_leaves(params)), batch, ckw),
                                                   rel=1e-6), case
        assert got["eval"] == _port_eval(got["params"][-1], batch, ckw), case
        # each rank holds its tp block of every split leaf, 1/fsdp of it, and so do the moments
        for tree in ("shapes", "mu_shapes"):
            for n, shape in got[tree].items():
                exp = list(full[n].shape)
                if n in split:
                    exp[split[n][0]] //= 2
                    exp[split[n][1]] //= fsdp
                assert shape == tuple(exp), (case, tree, n, shape)
    assert want["metrics"][-1][0] < want["metrics"][0][0]


def test_pieces_bit_equal_to_one_device_and_kl_to_jax(runs):
    import jax
    import jax.numpy as jnp

    from llm_qat_tpu.training import trainer as JT

    params, teacher = _weights()
    for r in runs[2]:
        p = r["pieces"]
        assert p["row_parallel_bit_equal"] and p["k13_given_max_bit_equal"] and p["embed_bit_equal"]
        assert p["quantizers_close"] == [True] * 4
    ck = runs[2][0]["pieces"]["chunked_kl"]
    hs, ht = ck["inputs"]
    with jax.enable_x64(True):
        def f(h, head):
            return JT.kd_kl_loss(h @ head, jnp.asarray(ht) @ jnp.asarray(teacher["lm_head"]))
        kl, (dh, dhead) = jax.value_and_grad(f, argnums=(0, 1))(jnp.asarray(hs),
                                                                 jnp.asarray(params["lm_head"]))
        dh, dhead = np.asarray(dh), np.asarray(dhead)
    for r in runs[2]:
        c = r["pieces"]["chunked_kl"]
        assert c["kl"] == pytest.approx(float(kl), rel=1e-6)
        np.testing.assert_allclose(c["dh"], dh, rtol=1e-5, atol=1e-5 * np.abs(dh).max())
        np.testing.assert_allclose(c["dhead"], dhead, rtol=1e-5, atol=1e-5 * np.abs(dhead).max())
    logits = np.concatenate([r["pieces"]["logits_tp"] for r in runs[2]], axis=-1)
    one = (torch.from_numpy(hs).float() @ torch.from_numpy(params["lm_head"]).float()).numpy()
    np.testing.assert_allclose(logits, one, rtol=1e-5, atol=1e-6)


def test_refusals_where_jax_refuses(runs):
    import jax
    import jax.numpy as jnp

    from llm_qat_tpu.parallel import mesh as JM
    from tests.test_torch_serving import np_params

    for r in runs["refusals"]:
        assert "mesh 1x1x3x1x1 != 2 devices" in r["mesh"]
        assert "tp=2 does not divide vocab_size=255" in r["vocab"]
        assert "tp=2 does not divide kv heads=1" in r["kv_heads"]
    with pytest.raises(ValueError):
        JM.make_mesh(data=1, fsdp=1, tp=3, devices=jax.devices()[:2])
    cfg = _jcfg().replace(vocab_size=255)
    with pytest.raises(ValueError):
        JM.shard_params(jax.tree.map(jnp.asarray, np_params(cfg)), _jax_mesh(2))
