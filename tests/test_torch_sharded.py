"""Port parity: tensor-parallel serving (``llm_qat_torch.inference.sharded``,
the TP engines, beam search over TP) on gloo ranks spawned on the CPU through
``parallel.launch``, against the JAX package's ``inference/sharded.py`` over
the suite's fake CPU devices (``tests/conftest.py``) and against one device.
The JAX package's own TP tests (``tests/test_tp_serving.py``) are ``slow``;
the cases here are theirs: ``(w_bits, kv_bits, tp)`` = (8, 8, 2) and
(4, 4, 4) with the int8 cache container, and W4 with the nibble-packed KV4
cache at tp = 2, on ``TINY_TEST`` with 4 kv heads (2 layers, width 64), from
the same numpy weights, in float32.

Limits:
* ``quantize_params_tp``: every leaf bit-equal to JAX's at tp 1, 2, 4 and
  w 4, 8, 32; at tp = 1 it is ``quantize_params``.
* The TP forwards (a prefill of 4 tokens from empty, then a ragged decode
  step through the decode kernels' plain versions): the ranks' caches,
  joined over kv heads, hold the integers of JAX's sharded run, of JAX's
  one-device run and of the port's one-device run bit for bit, at every
  layer. Scales: layer 0's bit for bit against the port's one device (the
  same inputs; the global absmax is an exact MAX); a deeper layer's input
  carries the row-parallel sum's f32 order, so its scales may sit a last bit
  off one device (JAX's test says the same of its own), and every scale is
  held at rtol 1e-6 against all three runs, the serving tests' limit against
  JAX (XLA's CPU rsqrt in the RMSNorm rounds a last bit another way).
  Logits at 1e-4, equal on every rank.
* ``quant_linear`` row-parallel over tp = 4 in the four chunks
  ``shard_qparams`` stores against JAX's ``shard_map`` of it at 1e-5 (its
  test's limit against one device), bit-equal on every rank.
* The TP scan and paged engines: tokens equal to JAX's TP engines, on every
  rank. Beam search over TP: tokens and score equal to ``num_beams`` beams on
  one device, the port's and JAX's (score at 1e-5 relative).

The ranks import this module, so JAX is imported inside the reference
functions only.
"""

import numpy as np
import pytest
import torch

from llm_qat_torch.parallel import launch

LOGITS = dict(rtol=1e-4, atol=1e-4)
SCALE_RTOL = 1e-6
B, CAP = 2, 32                              # the forward cases' slots and cache rows
FWD_CASES = {                               # (w_bits, kv_bits, tp, kv_cache_pack)
    "w8kv8_tp2": (8, 8, 2, False),
    "w4kv4_tp4": (4, 4, 4, False),
    "w4kv4_packed_tp2": (4, 4, 2, True),
}
PAGED_CASES = {"w8kv8_tp2": (8, 8, 2), "w4kv4_tp4": (4, 4, 4)}
PROMPTS = [[1, 2, 3], [7, 5], [9, 9, 9, 9, 2]]
BEAM_PROMPT = [5, 9, 2, 14]
CACHE_KEYS = ("k_q", "k_s", "v_q", "v_s")


def _jcfg(w_bits, kv_bits, pack=True, **kw):
    from llm_qat_tpu.models.config import TINY_TEST

    return TINY_TEST.replace(w_bits=w_bits, a_bits=8, kv_bits=kv_bits, num_key_value_heads=4,
                             kv_cache_pack=pack, **kw)


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    return np.asarray(tree.detach().cpu() if isinstance(tree, torch.Tensor) else tree)


def _leaves(tree, prefix=""):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _leaves(tree[k], f"{prefix}{k}/")
        else:
            yield prefix + k, tree[k]


# --- the ranks ----------------------------------------------------------------


def _no_megakernel(*a, **kw):
    raise AssertionError("the decode megakernel ran under tensor parallelism")


def _tp_forward(cfg, params, ids, tp, mesh, paged):
    """Prefill from empty (slots at length 0), then one decode step with slot
    1 inactive: (prefill logits, decode logits, cache after each)."""
    from llm_qat_torch.inference import sharded as S
    from llm_qat_torch.models import params as TP

    qp = S.shard_qparams(S.quantize_params_tp(TP.from_numpy(params, "cpu"), cfg, tp,
                                              device="cpu"), mesh)
    lens, act = np.zeros(B, np.int32), np.ones(B, bool)
    if paged:
        pcfg, tables = paged
        cache = S.init_paged_cache_tp(cfg, pcfg, mesh, device="cpu")
        fwd = S.make_tp_paged_forward(cfg, pcfg, mesh, dtype=torch.float32, device="cpu")
        lg, cache = fwd(qp, ids, lens, act, tables, cache)
        first = _np({k: cache[k].clone() for k in CACHE_KEYS})
        tok = lg[:, -1].argmax(-1)[:, None]
        lgd, cache = fwd(qp, tok, np.full(B, ids.shape[1], np.int32), act, tables, cache)
    else:
        cache = S.init_serving_cache_tp(cfg, B, CAP, mesh, device="cpu")
        fwd = S.make_tp_forward(cfg, mesh, dtype=torch.float32, device="cpu")
        lg, cache = fwd(qp, ids, lens, act, cache)
        first = _np({k: cache[k].clone() for k in CACHE_KEYS})
        tok = lg[:, -1].argmax(-1)[:, None]
        lgd, cache = fwd(qp, tok, cache["lengths"], np.array([True, False]), cache)
    return dict(logits=_np(lg), logits_decode=_np(lgd), cache=first,
                cache_decode=_np({k: cache[k] for k in CACHE_KEYS}))


def _chunked_linear(w_bits, x, q_row, s, mesh):
    """Rank r's quant_linear over its K-shard, summed over tp in the 4
    chunks of the stored chunk-major weight (``shard_qparams``'s layout)."""
    from llm_qat_torch.inference import quantized as Q
    from llm_qat_torch.inference import sharded as S
    from llm_qat_torch.parallel import mesh as pmesh

    n, r = pmesh.axis_size(mesh, "tp"), pmesh.axis_index(mesh, "tp")
    group = pmesh.axis_group(mesh, "tp")
    kx, kq = x.shape[1] // n, q_row.shape[0] // n
    xl = torch.from_numpy(x[:, r * kx:(r + 1) * kx])
    ql = torch.from_numpy(q_row[r * kq:(r + 1) * kq])
    stored = {k: S._chunk_major(v[None], S.TP_CHUNKS)[0]
              for k, v in (("q", ql), ("s", torch.from_numpy(s)))}
    return _np(Q.quant_linear(xl, stored, w_bits, out_dtype=torch.float32, reduce_group=group))


def _engine(cfg, params, tp, mesh, pcfg):
    from llm_qat_torch.inference import paged_engine as PE
    from llm_qat_torch.inference import sharded as S
    from llm_qat_torch.inference.engine import InferenceEngine
    from llm_qat_torch.models import params as TP

    qp = S.quantize_params_tp(TP.from_numpy(params, "cpu"), cfg, tp, device="cpu")
    kw = dict(max_batch=2, steps_per_sync=4, dtype=torch.float32, mesh=mesh, device="cpu")
    eng = (PE.PagedInferenceEngine(qp, cfg, pcfg=pcfg, **kw) if pcfg
           else InferenceEngine(qp, cfg, max_len=64, **kw))
    uids = [eng.submit(p, max_new_tokens=8) for p in PROMPTS]
    out = {r.uid: r.output for r in eng.run()}
    return [out[u] for u in uids]


def _beam(cfg, params, tp, mesh):
    from llm_qat_torch.inference import beam as TB
    from llm_qat_torch.inference import sharded as S
    from llm_qat_torch.models import params as TP

    qp = S.shard_qparams(S.quantize_params_tp(TP.from_numpy(params, "cpu"), cfg, tp,
                                              device="cpu"), mesh)
    toks, score = TB.beam_generate(
        qp, cfg, BEAM_PROMPT, num_beams=3, max_new_tokens=6, dtype=torch.float32,
        fwd=S.make_tp_forward(cfg, mesh, dtype=torch.float32, device="cpu"),
        prefill=S.make_tp_prefill(cfg, mesh, dtype=torch.float32, device="cpu"), device="cpu")
    return list(map(int, toks)), score


def _tp_rank(rank, world, jobs):
    """Every job of ``jobs`` (name -> (kind, args)) on this rank's shard of
    a ``('tp',)`` mesh over the whole world."""
    from llm_qat_torch.inference import megakernel
    from llm_qat_torch.parallel import mesh as pmesh

    megakernel.decode_step = _no_megakernel
    mesh = pmesh.make_serving_mesh(world)
    run = {"forward": lambda *a: _tp_forward(*a, world, mesh, None),
           "paged": lambda cfg, p, ids, pcfg, tables: _tp_forward(cfg, p, ids, world, mesh,
                                                                   (pcfg, tables)),
           "linear": lambda *a: _chunked_linear(*a, mesh),
           "engine": lambda cfg, p, pcfg: _engine(cfg, p, world, mesh, pcfg),
           "beam": lambda cfg, p: _beam(cfg, p, world, mesh)}
    return {name: run[kind](*args) for name, (kind, args) in jobs.items()}


# --- the JAX side and the jobs ------------------------------------------------


def _fwd_inputs(jcfg):
    from tests.test_torch_serving import np_params

    params = np_params(jcfg, seed=0)
    ids = np.random.default_rng(1).integers(0, jcfg.vocab_size, (B, 4)).astype(np.int32)
    return params, ids


def _paged_cfg():
    from llm_qat_torch.inference import paged as PG

    # slot 0 -> pages 1, 2; slot 1 -> pages 3, 4 (page 15 is scratch)
    return (PG.PagedConfig(page_size=8, n_pages=16, max_pages_per_seq=4),
            np.array([[1, 2, 0, 0], [3, 4, 0, 0]], np.int32))


def _linear_inputs(w_bits):
    """JAX's row-parallel test's operands: x [8, 64], one [64, 32] weight,
    quantized by JAX; the row weight packed per K-shard at W4."""
    import jax

    from llm_qat_tpu.inference import sharded as JS
    from llm_qat_tpu.ops.pallas import quant_matmul as JQM

    x = np.asarray(jax.random.normal(jax.random.PRNGKey(0), (8, 64)))
    w = jax.random.normal(jax.random.PRNGKey(1), (1, 64, 32))
    q, s = jax.vmap(lambda wl: JQM.quantize_per_channel(wl, w_bits))(w)
    q_row = q[0] if w_bits == 8 else JS._pack_int4_rowsharded(q, 4)[0]
    return x, np.asarray(q_row), np.asarray(s[0])


@pytest.fixture(scope="module")
def ranks():
    """One spawn a world size (2 and 4), every job of that size in it."""
    from tests.test_torch_serving import np_params, tcfg

    jobs = {2: {}, 4: {}}
    for name, (w, kv, tp, pack) in FWD_CASES.items():
        jcfg = _jcfg(w, kv, pack)
        jobs[tp][f"fwd_{name}"] = ("forward", (tcfg(jcfg), *_fwd_inputs(jcfg)))
    pcfg, tables = _paged_cfg()
    for name, (w, kv, tp) in PAGED_CASES.items():
        jcfg = _jcfg(w, kv, False)
        jobs[tp][f"paged_{name}"] = ("paged", (tcfg(jcfg), *_fwd_inputs(jcfg), pcfg, tables))
    for w in (4, 8):
        jobs[4][f"linear_w{w}"] = ("linear", (w, *_linear_inputs(w)))
    from llm_qat_torch.inference import paged as PG

    scan, paged = _jcfg(4, 4), _jcfg(8, 8)
    jobs[2]["engine_scan"] = ("engine", (tcfg(scan), np_params(scan), None))
    jobs[2]["engine_paged"] = ("engine", (tcfg(paged), np_params(paged), PG.PagedConfig(
        page_size=8, n_pages=32, max_pages_per_seq=8)))
    for w in (8, 4):
        bcfg = _jcfg(w, w, use_megakernel=False)
        jobs[2][f"beam_w{w}"] = ("beam", (tcfg(bcfg), np_params(bcfg, seed=3)))
    return {n: launch.spawn(_tp_rank, n, args=(j,), timeout=240) for n, j in jobs.items()}


def _jax_forward(jcfg, params, ids, tp):
    """JAX's sharded run (prefill, then the ragged decode step) and its
    one-device run, as the ranks run them."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from llm_qat_tpu.inference import model as JM
    from llm_qat_tpu.inference import quantized as JQ
    from llm_qat_tpu.inference import sharded as JS

    p = jax.tree.map(jnp.asarray, params)
    ids = jnp.asarray(ids)
    lens, act, act2 = jnp.zeros((B,), jnp.int32), jnp.ones((B,), bool), jnp.array([True, False])
    out = {}
    qp1 = JQ.quantize_params(p, jcfg.replace(use_megakernel=False))
    c1 = JM.init_serving_cache(jcfg, B, CAP)
    one = jcfg.replace(use_megakernel=False)
    lg, c1 = JM.serving_forward(qp1, one, ids, lens, act, c1, dtype=jnp.float32)
    first = _np({k: c1[k] for k in CACHE_KEYS})
    tok = jnp.argmax(lg[:, -1], -1)[:, None].astype(jnp.int32)
    lgd, c1 = JM.serving_forward(qp1, one, tok, c1["lengths"], act2, c1, dtype=jnp.float32)
    out["one"] = dict(logits=np.asarray(lg), logits_decode=np.asarray(lgd), cache=first,
                      cache_decode=_np({k: c1[k] for k in CACHE_KEYS}))
    mesh = Mesh(np.array(jax.devices()[:tp]), ("tp",))
    qp2 = JS.quantize_params_tp(p, jcfg, tp)
    qp2 = JS.place(qp2, mesh, JS.qparam_specs(qp2))
    c2 = JS.init_serving_cache_tp(jcfg, B, CAP, mesh)
    fwd = JS.make_tp_forward(jcfg, mesh, qp2, dtype=jnp.float32)
    lg, c2 = fwd(qp2, ids, lens, act, c2)
    first = _np({k: c2[k] for k in CACHE_KEYS})
    lgd, c2 = fwd(qp2, tok, c2["lengths"], act2, c2)
    out["tp"] = dict(logits=np.asarray(lg), logits_decode=np.asarray(lgd), cache=first,
                     cache_decode=_np({k: c2[k] for k in CACHE_KEYS}))
    return out


def _jax_paged(jcfg, params, ids, tp):
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from llm_qat_tpu.inference import paged as JPG
    from llm_qat_tpu.inference import quantized as JQ
    from llm_qat_tpu.inference import sharded as JS

    pcfg = JPG.PagedConfig(page_size=8, n_pages=16, max_pages_per_seq=4)
    tables = jnp.asarray(_paged_cfg()[1])
    p = jax.tree.map(jnp.asarray, params)
    ids = jnp.asarray(ids)
    lens, act = jnp.zeros((B,), jnp.int32), jnp.ones((B,), bool)
    lens1 = jnp.full((B,), ids.shape[1], jnp.int32)
    out = {}
    qp1 = JQ.quantize_params(p, jcfg)
    c1 = JPG.init_paged_cache(jcfg, pcfg)
    lg, c1 = JPG.paged_forward(qp1, jcfg, pcfg, ids, lens, act, tables, c1, dtype=jnp.float32)
    first = _np({k: c1[k] for k in CACHE_KEYS})
    tok = jnp.argmax(lg[:, -1], -1)[:, None].astype(jnp.int32)
    lgd, c1 = JPG.paged_forward(qp1, jcfg, pcfg, tok, lens1, act, tables, c1, dtype=jnp.float32)
    out["one"] = dict(logits=np.asarray(lg), logits_decode=np.asarray(lgd), cache=first,
                      cache_decode=_np({k: c1[k] for k in CACHE_KEYS}))
    mesh = Mesh(np.array(jax.devices()[:tp]), ("tp",))
    qp2 = JS.quantize_params_tp(p, jcfg, tp)
    qp2 = JS.place(qp2, mesh, JS.qparam_specs(qp2))
    c2 = JS.init_paged_cache_tp(jcfg, pcfg, mesh)
    fwd = JS.make_tp_paged_forward(jcfg, pcfg, mesh, qp2, dtype=jnp.float32)
    lg, c2 = fwd(qp2, ids, lens, act, tables, c2)
    first = _np({k: c2[k] for k in CACHE_KEYS})
    lgd, c2 = fwd(qp2, tok, lens1, act, tables, c2)
    out["tp"] = dict(logits=np.asarray(lg), logits_decode=np.asarray(lgd), cache=first,
                     cache_decode=_np({k: c2[k] for k in CACHE_KEYS}))
    return out


def _port_one_device(jcfg, params, ids, paged):
    """The port's one-device run of the same two steps."""
    from llm_qat_torch.inference import model as TM
    from llm_qat_torch.inference import paged as TPG
    from llm_qat_torch.inference import quantized as TQ
    from llm_qat_torch.models import params as TP
    from tests.test_torch_serving import tcfg

    cfg = tcfg(jcfg.replace(use_megakernel=False))
    qp = TQ.quantize_params(TP.from_numpy(params, "cpu"), cfg, device="cpu")
    lens, act = np.zeros(B, np.int32), np.ones(B, bool)
    if paged:
        pcfg, tables = _paged_cfg()
        c = TPG.init_paged_cache(cfg, pcfg, device="cpu")
        lg, c = TPG.paged_forward(qp, cfg, pcfg, ids, lens, act, tables, c, dtype=torch.float32,
                                  device="cpu")
        first = _np({k: c[k].clone() for k in CACHE_KEYS})
        tok = lg[:, -1].argmax(-1)[:, None]
        TPG.paged_forward(qp, cfg, pcfg, tok, np.full(B, ids.shape[1], np.int32), act, tables,
                          c, dtype=torch.float32, device="cpu")
    else:
        c = TM.init_serving_cache(cfg, B, CAP, device="cpu")
        lg, c = TM.serving_forward(qp, cfg, ids, lens, act, c, dtype=torch.float32, device="cpu")
        first = _np({k: c[k].clone() for k in CACHE_KEYS})
        tok = lg[:, -1].argmax(-1)[:, None]
        _, c = TM.serving_forward(qp, cfg, tok, c["lengths"], np.array([True, False]), c,
                                  dtype=torch.float32, device="cpu")
    return dict(cache=first, cache_decode=_np({k: c[k] for k in CACHE_KEYS}))


def _joined(rank_results, key):
    """The ranks' caches joined over the kv-head dim (scales: rank 0's, after
    checking every rank holds the same)."""
    out = {}
    for k in CACHE_KEYS:
        parts = [r[key][k] for r in rank_results]
        if k.endswith("_q"):
            out[k] = np.concatenate(parts, axis=2)
        else:
            for p in parts[1:]:
                np.testing.assert_array_equal(p, parts[0])
            out[k] = parts[0]
    return out


def _hold_forward(rank_results, jax_runs, port_one):
    for r in rank_results[1:]:                  # the logits are replicated
        for k in ("logits", "logits_decode"):
            np.testing.assert_array_equal(r[k], rank_results[0][k])
    got = rank_results[0]
    for run in ("tp", "one"):
        np.testing.assert_allclose(got["logits"], jax_runs[run]["logits"], **LOGITS)
        np.testing.assert_allclose(got["logits_decode"][0], jax_runs[run]["logits_decode"][0],
                                   **LOGITS)
    for key in ("cache", "cache_decode"):
        cache = _joined(rank_results, key)
        for k in ("k_q", "v_q"):
            np.testing.assert_array_equal(cache[k], jax_runs["tp"][key][k], err_msg=k)
            np.testing.assert_array_equal(cache[k], jax_runs["one"][key][k], err_msg=k)
            np.testing.assert_array_equal(cache[k], port_one[key][k], err_msg=k)
        for k in ("k_s", "v_s"):
            np.testing.assert_array_equal(cache[k][0], port_one[key][k][0], err_msg=k)
            for want in (jax_runs["tp"][key][k], jax_runs["one"][key][k], port_one[key][k]):
                np.testing.assert_allclose(cache[k], want, rtol=SCALE_RTOL, err_msg=k)


# --- the tests ----------------------------------------------------------------


@pytest.mark.parametrize("w_bits", [4, 8, 32])
@pytest.mark.parametrize("tp", [1, 2, 4])
def test_quantize_params_tp_matches_jax(w_bits, tp):
    import jax
    import jax.numpy as jnp

    from llm_qat_tpu.inference import sharded as JS
    from llm_qat_torch.inference import quantized as TQ
    from llm_qat_torch.inference import sharded as TS
    from llm_qat_torch.models import params as TP
    from tests.test_torch_serving import np_params, tcfg

    jcfg = _jcfg(w_bits, 8)
    params = np_params(jcfg, seed=2)
    want = dict(_leaves(_np(JS.quantize_params_tp(jax.tree.map(jnp.asarray, params), jcfg, tp))))
    got = TS.quantize_params_tp(TP.from_numpy(params, "cpu"), tcfg(jcfg), tp, device="cpu")
    got = dict(_leaves(_np(got)))
    assert got.keys() == want.keys()
    for name in want:
        assert got[name].dtype == want[name].dtype, name
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    if tp == 1:
        one = dict(_leaves(_np(TQ.quantize_params(TP.from_numpy(params, "cpu"), tcfg(jcfg),
                                                  device="cpu"))))
        for name in want:
            np.testing.assert_array_equal(got[name], one[name], err_msg=name)


def test_specs_are_the_jax_packages():
    import jax
    import jax.numpy as jnp

    from llm_qat_tpu.inference import sharded as JS
    from llm_qat_torch.inference import sharded as TS
    from llm_qat_torch.models import params as TP
    from tests.test_torch_serving import np_params, tcfg

    def as_tuples(tree):
        if isinstance(tree, dict):
            return {k: as_tuples(v) for k, v in tree.items()}
        return tuple(tree) + (None,) * (5 - len(tuple(tree)))

    for w_bits in (4, 32):
        jcfg = _jcfg(w_bits, 8)
        p = np_params(jcfg)
        jq = JS.quantize_params_tp(jax.tree.map(jnp.asarray, p), jcfg, 2)
        tq = TS.quantize_params_tp(TP.from_numpy(p, "cpu"), tcfg(jcfg), 2, device="cpu")
        want, got = as_tuples(JS.qparam_specs(jq)), as_tuples(TS.qparam_specs(tq))
        assert dict(_leaves(got)) == dict(_leaves(want))
    for j, t in ((JS.cache_specs(), TS.cache_specs()),
                 (JS.paged_cache_specs(), TS.paged_cache_specs())):
        assert as_tuples(t) == as_tuples(dict(j))


@pytest.mark.parametrize("case", list(FWD_CASES))
def test_tp_forward_matches_jax_and_one_device(ranks, case):
    w, kv, tp, pack = FWD_CASES[case]
    jcfg = _jcfg(w, kv, pack)
    params, ids = _fwd_inputs(jcfg)
    res = [r[f"fwd_{case}"] for r in ranks[tp]]
    if pack:
        assert res[0]["cache"]["k_q"].dtype == np.uint8        # the packed container
    _hold_forward(res, _jax_forward(jcfg, params, ids, tp),
                  _port_one_device(jcfg, params, ids, paged=False))


@pytest.mark.parametrize("case", list(PAGED_CASES))
def test_tp_paged_forward_matches_jax_and_one_device(ranks, case):
    w, kv, tp = PAGED_CASES[case]
    jcfg = _jcfg(w, kv, False)
    params, ids = _fwd_inputs(jcfg)
    _hold_forward([r[f"paged_{case}"] for r in ranks[tp]], _jax_paged(jcfg, params, ids, tp),
                  _port_one_device(jcfg, params, ids, paged=True))


@pytest.mark.parametrize("w_bits", [4, 8])
def test_rowparallel_chunked_quant_linear_matches_jax(ranks, w_bits):
    import jax
    from jax.sharding import Mesh, PartitionSpec as P

    from llm_qat_tpu.inference import quantized as JQ

    x, q_row, s = _linear_inputs(w_bits)

    def local(xl, ql, sl):
        return JQ.quant_linear(xl, {"q": ql, "s": sl}, w_bits, out_dtype=jax.numpy.float32,
                               reduce_axis="tp", n_chunks=4)

    want = np.asarray(jax.shard_map(
        local, mesh=Mesh(np.array(jax.devices()[:4]), ("tp",)),
        in_specs=(P(None, "tp"), P("tp", None), P(None, None)), out_specs=P(None, None),
        check_vma=False)(x, q_row, s))
    for r in ranks[4]:
        got = r[f"linear_w{w_bits}"]
        np.testing.assert_array_equal(got, ranks[4][0][f"linear_w{w_bits}"])
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("kind", ["scan", "paged"])
def test_tp_engines_match_jax_tp_engines(ranks, kind):
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from llm_qat_tpu.inference import paged as JPG
    from llm_qat_tpu.inference import sharded as JS
    from llm_qat_tpu.inference.engine import InferenceEngine
    from llm_qat_tpu.inference.paged_engine import PagedInferenceEngine
    from tests.test_torch_serving import np_params

    jcfg = _jcfg(4, 4) if kind == "scan" else _jcfg(8, 8)
    qp = JS.quantize_params_tp(jax.tree.map(jnp.asarray, np_params(jcfg)), jcfg, 2)
    kw = dict(max_batch=2, steps_per_sync=4, dtype=jnp.float32,
              mesh=Mesh(np.array(jax.devices()[:2]), ("tp",)))
    eng = (InferenceEngine(qp, jcfg, max_len=64, **kw) if kind == "scan" else
           PagedInferenceEngine(qp, jcfg, pcfg=JPG.PagedConfig(page_size=8, n_pages=32,
                                                               max_pages_per_seq=8), **kw))
    uids = [eng.submit(p, max_new_tokens=8) for p in PROMPTS]
    out = {r.uid: [int(t) for t in r.output] for r in eng.run()}
    want = [out[u] for u in uids]
    for r in ranks[2]:
        assert r[f"engine_{kind}"] == want


@pytest.mark.parametrize("w_bits", [8, 4])
def test_beam_over_tp_matches_one_device(ranks, w_bits):
    import jax
    import jax.numpy as jnp

    from llm_qat_tpu.inference import beam as JB
    from llm_qat_tpu.inference import quantized as JQ
    from llm_qat_torch.inference import beam as TB
    from llm_qat_torch.inference import quantized as TQ
    from llm_qat_torch.models import params as TP
    from tests.test_torch_serving import np_params, tcfg

    jcfg = _jcfg(w_bits, w_bits, use_megakernel=False)
    params = np_params(jcfg, seed=3)
    kw = dict(num_beams=3, max_new_tokens=6)
    one_t, one_s = TB.beam_generate(
        TQ.quantize_params(TP.from_numpy(params, "cpu"), tcfg(jcfg), device="cpu"), tcfg(jcfg),
        BEAM_PROMPT, dtype=torch.float32, device="cpu", **kw)
    jax_t, jax_s = JB.beam_generate(JQ.quantize_params(jax.tree.map(jnp.asarray, params), jcfg),
                                    jcfg, BEAM_PROMPT, dtype=jnp.float32, **kw)
    assert list(map(int, one_t)) == list(map(int, jax_t))
    for r in ranks[2]:
        toks, score = r[f"beam_w{w_bits}"]
        assert toks == list(map(int, one_t))
        assert score == one_s
        np.testing.assert_allclose(score, jax_s, rtol=1e-5)


def test_tp_entry_points_refuse_what_they_cannot_serve():
    from llm_qat_torch.inference import engine as TE
    from llm_qat_torch.inference import sharded as TS
    from llm_qat_torch.models import params as TP
    from tests.test_torch_serving import np_params, tcfg

    jcfg = _jcfg(8, 8)
    tp = TP.from_numpy(np_params(jcfg), "cpu")
    with pytest.raises(ValueError, match="must divide heads"):
        TS.quantize_params_tp(tp, tcfg(jcfg), 3, device="cpu")
    with pytest.raises(TypeError, match="DeviceMesh"):
        TE.InferenceEngine(tp, tcfg(jcfg), mesh=object(), device="cpu")
