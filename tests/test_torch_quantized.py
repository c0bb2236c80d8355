"""Port parity for the serving params and building blocks, and the port's
package rules: llm_qat_torch.inference.quantized, models.{config, llama,
params} against the JAX package, on CPU.

Inputs come from a numpy seed. Quantized weights and their packing are held
bit-exact (same f32 scale, round half to even on both sides); fp building
blocks at rtol/atol 1e-5 in float32.
"""

import ast
import contextlib
import dataclasses
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_qat_tpu.inference import quantized as JQ
from llm_qat_tpu.models import config as JC
from llm_qat_tpu.models import llama as JL
from llm_qat_torch.inference import model as TM
from llm_qat_torch.inference import quantized as TQ
from llm_qat_torch.models import config as TC
from llm_qat_torch.models import llama as TL
from llm_qat_torch.models import params as TP

from tests.test_torch_serving import BASE, np_params, tcfg

TOL = dict(rtol=1e-5, atol=1e-5)
REPO = pathlib.Path(__file__).resolve().parent.parent


def _tree(fn, node):
    return {k: _tree(fn, v) for k, v in node.items()} if isinstance(node, dict) else fn(node)


def _assert_tree_equal(t, j, prefix=""):
    assert set(t) == set(j), (prefix, set(t), set(j))
    for k in t:
        if isinstance(t[k], dict):
            _assert_tree_equal(t[k], j[k], f"{prefix}/{k}")
        else:
            a, e = t[k].float().numpy(), np.asarray(j[k], np.float32)
            assert a.shape == e.shape, (prefix, k)
            np.testing.assert_array_equal(a, e, err_msg=f"{prefix}/{k}")


@pytest.mark.parametrize("name", ["TINY_TEST", "TINYLLAMA_1B", "LLAMA_7B",
                                  "LLAMA_13B", "LLAMA_30B"])
def test_config_copy_matches_jax(name):
    j, t = getattr(JC, name), getattr(TC, name)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert (t.head_dim, t.kv_heads) == (j.head_dim, j.kv_heads)
    assert tcfg(j) == t


@pytest.mark.parametrize("w_bits", [8, 4, 16])
def test_quantize_params_bit_exact(w_bits):
    cfg = BASE.replace(w_bits=w_bits)
    p = np_params(cfg, seed=7)
    j = JQ.quantize_params(_tree(jnp.asarray, p), cfg)
    t = TQ.quantize_params(TP.from_numpy(p, "cpu"), tcfg(cfg), device="cpu")
    _assert_tree_equal(t, j)
    if w_bits < 16:
        assert t["layers"]["qkv"]["q"].dtype == (torch.int8 if w_bits == 8 else torch.uint8)


@pytest.mark.parametrize("w_bits", [8, 4])
def test_quantize_params_host_bit_exact(w_bits):
    cfg = BASE.replace(w_bits=w_bits)
    p = np_params(cfg, seed=8)
    j = JQ.quantize_params_host(p, cfg)
    t = TQ.quantize_params_host(p, tcfg(cfg), device="cpu")
    _assert_tree_equal(t, j)
    # and the host path's ints are the device path's
    d = TQ.quantize_params(TP.from_numpy(p, "cpu"), tcfg(cfg), device="cpu")
    for k in ("qkv", "o", "gateup", "down"):
        np.testing.assert_array_equal(t["layers"][k]["q"].numpy(),
                                      d["layers"][k]["q"].numpy())


@pytest.mark.parametrize("w_bits", [8, 4])
def test_dequant_weight_matches_jax(w_bits):
    cfg = BASE.replace(w_bits=w_bits)
    p = np_params(cfg, seed=9)
    j = JQ.quantize_params(_tree(jnp.asarray, p), cfg)["layers"]["down"]
    t = TQ.quantize_params(TP.from_numpy(p, "cpu"), tcfg(cfg), device="cpu")["layers"]["down"]
    np.testing.assert_allclose(
        TQ.dequant_weight(t, w_bits, torch.float32).numpy(),
        np.asarray(JQ.dequant_weight(j, w_bits, jnp.float32)), **TOL)


@pytest.mark.parametrize("a_bits", [8, 6, 16, 2])
def test_quant_linear_matches_jax(a_bits):
    """The a_bits contract: 3..8 int kernels, >= 16 or <= 2 fp, also for
    unquantized (w16) weights."""
    rng = np.random.default_rng(10)
    x = rng.normal(size=(3, 5, 64)).astype(np.float32)
    for w_bits in (8, 4, 16):
        cfg = BASE.replace(w_bits=w_bits)
        p = np_params(cfg, seed=11)
        jqw = JQ.quantize_params(_tree(jnp.asarray, p), cfg)["layers"]["gateup"]
        tqw = TQ.quantize_params(TP.from_numpy(p, "cpu"), tcfg(cfg),
                                 device="cpu")["layers"]["gateup"]
        jqw = {k: v[0] for k, v in jqw.items()}
        tqw = {k: v[0] for k, v in tqw.items()}
        with pytest.warns(UserWarning) if a_bits == 16 else contextlib.nullcontext():
            want = JQ.quant_linear(jnp.asarray(x), jqw, w_bits, a_bits, jnp.float32)
        with pytest.warns(UserWarning) if a_bits == 16 else contextlib.nullcontext():
            got = TQ.quant_linear(torch.from_numpy(x), tqw, w_bits, a_bits, torch.float32)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_quant_linear_a12_raises():
    qw = {"q": torch.zeros(64, 8, dtype=torch.int8), "s": torch.ones(1, 8)}
    with pytest.raises(NotImplementedError, match="int8"):
        TQ.quant_linear(torch.zeros(2, 64), qw, 8, a_bits=12)


def test_llama_blocks_match_jax():
    rng = np.random.default_rng(12)
    b, s, nh, kvh, hd = 2, 6, 4, 2, 16
    x = rng.normal(size=(b, s, nh * hd)).astype(np.float32)
    g = (1 + 0.1 * rng.normal(size=(nh * hd,))).astype(np.float32)
    np.testing.assert_allclose(
        TL.rms_norm(torch.from_numpy(x), torch.from_numpy(g), 1e-6).numpy(),
        np.asarray(JL.rms_norm(jnp.asarray(x), jnp.asarray(g), 1e-6)), **TOL)
    pos = rng.integers(0, 100, (b, s)).astype(np.int32)
    jc, js = JL.rope_cos_sin(jnp.asarray(pos), hd, 10000.0)
    tc, ts = TL.rope_cos_sin(torch.from_numpy(pos), hd, 10000.0)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), **TOL)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), **TOL)
    q = rng.normal(size=(b, s, nh, hd)).astype(np.float32)
    np.testing.assert_allclose(
        TL.apply_rope(torch.from_numpy(q), tc, ts).numpy(),
        np.asarray(JL.apply_rope(jnp.asarray(q), jc, js)), **TOL)
    k = rng.normal(size=(b, 9, kvh, hd)).astype(np.float32)
    v = rng.normal(size=(b, 9, kvh, hd)).astype(np.float32)
    mask = np.where(rng.uniform(size=(b, 1, s, 9)) < 0.7, 0.0, -1e9).astype(np.float32)
    mask[..., 0] = 0.0
    np.testing.assert_allclose(
        TL._attend(*(torch.from_numpy(a) for a in (q, k, v, mask))).numpy(),
        np.asarray(JL._attend(*(jnp.asarray(a) for a in (q, k, v, mask)))), **TOL)


def test_init_params_layout_and_from_numpy():
    cfg = BASE
    jp = JL.init_params(cfg, jax.random.PRNGKey(0))
    tp = TP.init_params(tcfg(cfg), seed=0, device="cpu")
    shapes = _tree(lambda a: tuple(a.shape), tp)
    assert shapes == _tree(lambda a: tuple(a.shape), jp)
    std = tp["layers"]["q"].std().item()
    assert 0.015 < std < 0.025
    # from_numpy: fp leaves take dtype, ints keep theirs, scales stay f32
    q = TQ.quantize_params_host(np_params(cfg), tcfg(cfg), device="cpu")
    back = TP.from_numpy(_tree(lambda t: t.float().numpy() if t.is_floating_point()
                               else t.numpy(), q), "cpu", torch.bfloat16)
    assert back["layers"]["qkv"]["q"].dtype == torch.int8
    assert back["layers"]["qkv"]["s"].dtype == torch.float32
    assert back["embed"].dtype == torch.bfloat16
    jb = jnp.asarray(np.ones((2, 3), np.float32), jnp.bfloat16)
    assert TP.from_numpy({"w": np.asarray(jb)}, "cpu")["w"].dtype == torch.float32


def test_entry_points_raise_without_gpu_unless_cpu_asked():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the CUDA default is valid here")
    cfg = tcfg(BASE)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TP.init_params(cfg)
    p = TP.init_params(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TQ.quantize_params(p, cfg)
    qp = TQ.quantize_params(p, cfg, device="cpu")
    from llm_qat_torch.inference import engine as TE
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TE.InferenceEngine(qp, cfg, max_batch=1, max_len=16)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TM.prefill_slot(qp, cfg, np.zeros((1, 16), np.int64))
    cache = TM.init_serving_cache(cfg, 1, 16, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TM.serving_forward(qp, cfg, np.zeros((1, 1), np.int64), [0], [True], cache)
    from llm_qat_torch.training import trainer as TT
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TT.Trainer(cfg, TT.TrainConfig(), p, p)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TP.opt_state_from_numpy(0, {"w": np.zeros(2, np.float32)}, {"w": np.zeros(2, np.float32)})
    tr = TT.Trainer(cfg, TT.TrainConfig(compute_dtype=torch.float32), p, device="cpu")
    assert tr.device.type == "cpu"


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_port_imports_no_jax_and_nothing_of_the_jax_package():
    files = sorted((REPO / "llm_qat_torch").rglob("*.py")) + [
        REPO / name for name in ("chip_smoke.py", "train_torch.py", "generate_data_torch.py",
                                 "merge_gen_data_torch.py")]
    assert len(files) > 10
    names = {str(f.relative_to(REPO)) for f in files}
    assert {"llm_qat_torch/models/convert.py", "llm_qat_torch/utils/args.py",
            "llm_qat_torch/utils/tb_writer.py", "llm_qat_torch/utils/logging_utils.py",
            "llm_qat_torch/utils/profiling.py", "llm_qat_torch/utils/checkpoint.py",
            "llm_qat_torch/native/__init__.py", "llm_qat_torch/data/dataset.py",
            "llm_qat_torch/data/synthesis.py", "llm_qat_torch/cli/train.py",
            "llm_qat_torch/cli/generate_data.py", "train_torch.py", "generate_data_torch.py",
            "merge_gen_data_torch.py"} <= names
    assert {"llm_qat_torch/inference/paged.py", "llm_qat_torch/inference/paged_engine.py",
            "llm_qat_torch/inference/megakernel.py", "chip_smoke.py",
            "llm_qat_torch/ops/quantize.py", "llm_qat_torch/ops/qat_matmul.py",
            "llm_qat_torch/ops/linear.py", "llm_qat_torch/ops/fused_quant.py",
            "llm_qat_torch/ops/fused_layer.py", "llm_qat_torch/ops/flash_attention.py",
            "llm_qat_torch/models/llama.py", "llm_qat_torch/models/params.py",
            "llm_qat_torch/training/trainer.py"} <= names
    for f in files:
        for mod in _imports(f):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "llm_qat_tpu", "flax", "optax"), (f, mod)
