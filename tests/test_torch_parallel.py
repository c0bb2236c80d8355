"""Port parity: llm_qat_torch.parallel (the mesh, the sharding rules, the ZeRO-3
gather) on gloo ranks spawned on the CPU through ``parallel.launch``, against
the JAX package's ``parallel/mesh.py`` and its GSPMD-sharded forward on the
suite's fake CPU devices (``tests/conftest.py``; as ``tests/test_parallel.py``
holds it against one device).

The sharded forward and its gradients (of ``SCALE * sum(logits ** 2)``) at
fsdp = 2 and data = 2 x fsdp = 2, from the same numpy weights and ids, in
float32: logits at 1e-4 and gradients at a relative L2 of 1e-3 a leaf, the
limits of ``tests/test_torch_llama_train.py`` at its sizes (2 layers, at
most 32 rows). A rank's gradient of a split leaf is its shard's; the test
gathers them whole. The launcher's failures are held too: a rank's exception
ends every rank with its traceback, and a deadlock ends at the timeout.

The ranks import this module, so JAX is imported inside the reference
functions only.
"""

import time

import numpy as np
import pytest
import torch

from llm_qat_torch.parallel import launch

LOGITS = dict(rtol=1e-4, atol=1e-4)
GRAD_REL_L2 = 1e-3
SCALE = 1e-3


def _leaves(tree, prefix=""):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _leaves(tree[k], f"{prefix}{k}/")
        else:
            yield prefix + k, tree[k]


def _mesh_rank(rank, world):
    """The mesh's axes and refusals, the shards of a param tree and their
    round trip, and this rank's rows of a batch, at data = 2 x fsdp = 2."""
    from llm_qat_torch.models import params as TP
    from llm_qat_torch.models.config import TINY_TEST
    from llm_qat_torch.parallel import mesh as pmesh

    out = {"absorb": pmesh.mesh_shape(pmesh.make_mesh(data=2))}
    out["cp"] = pmesh.mesh_shape(pmesh.make_mesh(fsdp=2, cp=2))
    out["tp"] = pmesh.mesh_shape(pmesh.make_mesh(tp=2, fsdp=2))
    out["pp"] = pmesh.mesh_shape(pmesh.make_mesh(pp=2, fsdp=2))
    out["tp_coords"] = [pmesh.axis_index(pmesh.make_mesh(tp=2, fsdp=2), a) for a in ("fsdp", "tp")]
    for kw in (dict(data=3, fsdp=3), dict(fsdp=3), dict(tp=3, fsdp=2), dict(pp=3, fsdp=1)):
        try:
            pmesh.make_mesh(**kw)
            out[str(kw)] = None
        except (ValueError, NotImplementedError) as e:
            out[str(kw)] = (type(e).__name__, str(e))
    mesh = pmesh.make_mesh(data=2, fsdp=2)
    out["coords"] = (pmesh.axis_index(mesh, "data"), pmesh.axis_index(mesh, "fsdp"))
    full = TP.init_params(TINY_TEST, seed=0, device="cpu")
    shards = pmesh.shard_params(full, mesh)
    out["shapes"] = {n: tuple(t.shape) for n, t in _leaves(shards)}
    back = pmesh.gather_params(shards, mesh)
    out["round_trip"] = all(torch.equal(a, b) for (_, a), (_, b) in zip(_leaves(back),
                                                                         _leaves(full)))
    ids = torch.arange(8 * 3).reshape(8, 3)
    out["rows"] = pmesh.shard_batch({"input_ids": ids}, mesh)["input_ids"].numpy()
    try:
        pmesh.shard_params({"embed": torch.zeros(4, 3)}, mesh, {"embed": (None, "fsdp")})
    except ValueError as e:
        out["uneven"] = str(e)
    return out


def test_mesh_shapes_shards_and_errors():
    from llm_qat_torch.models.config import TINY_TEST as C

    res = launch.spawn(_mesh_rank, 4, timeout=120)
    H, I, L, V = C.hidden_size, C.intermediate_size, C.num_hidden_layers, C.vocab_size
    for rank, r in enumerate(res):
        assert r["absorb"] == {"data": 2, "fsdp": 2, "tp": 1}        # fsdp=-1 absorbs the rest
        assert r["cp"] == {"data": 1, "fsdp": 2, "tp": 1, "cp": 2}
        assert r["{'data': 3, 'fsdp': 3}"] == ("ValueError", "mesh 3x3x1x1x1 != 4 devices")
        assert r["{'fsdp': 3}"][0] == "ValueError"
        assert r["tp"] == {"data": 1, "fsdp": 2, "tp": 2}
        assert r["pp"] == {"data": 1, "fsdp": 2, "tp": 1, "pp": 2}
        assert r["tp_coords"] == [rank // 2, rank % 2]              # tp the minor axis
        assert r["{'tp': 3, 'fsdp': 2}"] == ("ValueError", "mesh 1x2x3x1x1 != 4 devices")
        assert r["{'pp': 3, 'fsdp': 1}"] == ("ValueError", "mesh 1x1x1x3x1 != 4 devices")
        assert r["coords"] == (rank // 2, rank % 2)
        q, kv, o = C.num_attention_heads * C.head_dim, C.kv_heads * C.head_dim, H
        assert r["shapes"] == {
            "embed": (V, H // 2), "lm_head": (H // 2, V), "final_norm": (H,),
            "layers/attn_norm": (L, H), "layers/mlp_norm": (L, H),
            "layers/q": (L, H // 2, q), "layers/k": (L, H // 2, kv), "layers/v": (L, H // 2, kv),
            "layers/o": (L, q, o // 2), "layers/gate": (L, H // 2, I),
            "layers/up": (L, H // 2, I), "layers/down": (L, I, H // 2)}
        assert r["round_trip"]
        np.testing.assert_array_equal(r["rows"], np.arange(24).reshape(8, 3)[2 * rank:2 * rank + 2])
        assert "does not split over fsdp=2" in r["uneven"]


def test_param_specs_and_batch_spec_are_the_jax_packages():
    from llm_qat_tpu.parallel import mesh as JM
    from llm_qat_torch.parallel import mesh as TM

    for tie in (False, True):
        want = dict(_leaves(JM.param_specs(tie)))
        got = dict(_leaves(TM.param_specs(tie)))
        assert got.keys() == want.keys()
        for k in want:
            assert got[k] == tuple(want[k]), k
    assert TM.batch_spec() == tuple(JM.batch_spec())
    assert TM.MESH_AXES == JM.MESH_AXES


def _fsdp_rank(rank, world, cfg, params, ids, axes, kw):
    """This rank's logits rows and the whole gradients (the split leaves'
    shards gathered, the replicated leaves' summed over the ranks)."""
    from llm_qat_torch.models import llama as TL
    from llm_qat_torch.models import params as TP
    from llm_qat_torch.parallel import comm, mesh as pmesh
    from llm_qat_torch.training.trainer import tree_leaves, tree_map

    mesh = pmesh.make_mesh(**axes)
    specs = pmesh.param_specs("lm_head" not in params)
    shards = pmesh.shard_params(TP.from_numpy(params, "cpu"), mesh, specs)
    leaves = tree_leaves(shards)
    for t in leaves:
        t.requires_grad_(True)
    local = pmesh.shard_batch({"ids": torch.from_numpy(ids)}, mesh)["ids"]
    logits = TL.forward(shards, cfg, local, mesh=mesh, **kw)
    grads = iter(torch.autograd.grad(SCALE * (logits ** 2).sum(), leaves))
    grads = tree_map(lambda _: next(grads), shards)

    def whole(g, spec):
        if pmesh.split_dim(spec) is None:
            for a in ("data", "fsdp"):
                comm.all_reduce_(g, pmesh.axis_group(mesh, a))
        return g

    grads = pmesh.gather_params(pmesh.map_specs(whole, grads, specs), mesh, specs)
    return logits.detach().numpy(), tree_map(lambda g: g.numpy(), grads)


def _jax_sharded(jcfg, params, ids, axes, kw):
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding

    from llm_qat_tpu.models import llama as JL
    from llm_qat_tpu.parallel import mesh as JM

    n = int(np.prod(list(axes.values())))
    mesh = JM.make_mesh(tp=1, devices=jax.devices()[:n], **axes)
    sp = JM.shard_params(jax.tree.map(jnp.asarray, params), mesh)
    ids_s = jax.device_put(jnp.asarray(ids), NamedSharding(mesh, JM.batch_spec()))

    def loss(p):
        logits = JL.forward(p, jcfg, ids_s, **kw)
        return SCALE * jnp.sum(logits ** 2), logits

    (_, logits), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(sp)
    return np.asarray(logits), jax.tree.map(np.asarray, grads)


FSDP_CASES = {
    # the fused flash-layout route, each layer gathered inside its remat
    "fsdp2_flash_remat": (dict(fsdp=2), dict(hidden_size=128, intermediate_size=256),
                          (2, 16), dict(remat=True)),
    "data2_fsdp2_unfused": (dict(data=2, fsdp=2), dict(), (4, 8), dict()),
    "fsdp2_tied": (dict(fsdp=2), dict(tie_word_embeddings=True), (2, 16), dict()),
}


@pytest.mark.parametrize("case", list(FSDP_CASES))
def test_fsdp_forward_and_grads_match_jax(case):
    from llm_qat_tpu.models.config import TINY_TEST
    from tests.test_torch_serving import np_params, tcfg

    axes, widths, (b, s), kw = FSDP_CASES[case]
    jcfg = TINY_TEST.replace(w_bits=4, a_bits=8, kv_bits=4, **widths)
    params = np_params(jcfg, seed=len(case))
    if jcfg.tie_word_embeddings:
        del params["lm_head"]
    ids = np.random.default_rng(len(case)).integers(0, jcfg.vocab_size, (b, s)).astype(np.int32)
    world = int(np.prod(list(axes.values())))
    ranks = launch.spawn(_fsdp_rank, world, args=(tcfg(jcfg), params, ids, axes, kw),
                         timeout=120)
    want, jg = _jax_sharded(jcfg, params, ids, axes, kw)
    np.testing.assert_allclose(np.concatenate([r[0] for r in ranks]), want, **LOGITS)
    for rank in ranks:
        for (name, a), (_, g) in zip(_leaves(rank[1]), _leaves(jg)):
            rel = np.linalg.norm(a - g) / max(np.linalg.norm(g), 1e-30)
            assert rel <= GRAD_REL_L2, (name, rel)


def _fails(rank, world):
    import torch.distributed as dist

    if rank == 1:
        raise ArithmeticError("rank 1 stops here")
    dist.barrier()                      # waits for rank 1, which never comes


def _hangs(rank, world):
    time.sleep(600)


def test_launch_reports_a_failed_rank_and_a_deadlock():
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="rank 1 stops here"):
        launch.spawn(_fails, 2, timeout=60)
    with pytest.raises(TimeoutError, match="still running after 3"):
        launch.spawn(_hangs, 2, timeout=3)
    assert time.monotonic() - t0 < 120      # the hung ranks sleep 600 s
    assert launch.spawn(_echo, 3, args=("x",)) == [(0, 3, "x"), (1, 3, "x"), (2, 3, "x")]


def _echo(rank, world, arg):
    return rank, world, arg
