"""Port parity: llm_qat_torch.models.convert (HF checkpoint I/O) against
llm_qat_tpu.models.convert, both ways, on the same numpy weights.

Params are compared bit for bit (float32 and bfloat16, tied and untied
embeddings): every conversion is a transpose, a stack and one rounding to the
params' type on both sides. The port writes the safetensors format by hand;
its file must be byte-identical to the ``safetensors`` package's for the same
tensors, and it must read the package's files.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from safetensors.numpy import save_file as np_save_file
from safetensors.torch import save_file as torch_save_file

from llm_qat_tpu.models import convert as JC
from llm_qat_tpu.models.config import LlamaConfig as JConfig
from llm_qat_torch.models import convert as TC
from llm_qat_torch.models import params as TP

from tests.test_torch_serving import np_params, tcfg

CFG = JConfig(vocab_size=96, hidden_size=64, intermediate_size=96, num_hidden_layers=2,
              num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=64,
              w_bits=4, a_bits=8, kv_bits=4)
JDT = {"f32": jnp.float32, "bf16": jnp.bfloat16}
TDT = {"f32": torch.float32, "bf16": torch.bfloat16}


def _params(tied, seed=0):
    cfg = CFG.replace(tie_word_embeddings=tied)
    p = np_params(cfg, seed)
    if tied:
        del p["lm_head"]
    return cfg, p


def _assert_same(tparams, jparams):
    """Bit-equal leaves (bf16 compared through float32, which is exact)."""
    assert set(tparams) == set(jparams)
    for k, v in jparams.items():
        if isinstance(v, dict):
            _assert_same(tparams[k], v)
            continue
        t = tparams[k]
        assert tuple(t.shape) == tuple(v.shape), k
        np.testing.assert_array_equal(t.float().numpy(), np.asarray(v, np.float32), err_msg=k)


@pytest.mark.parametrize("tied", [False, True])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_jax_save_port_load(tmp_path, tied, dt):
    cfg, p = _params(tied)
    jparams = {k: (jnp.asarray(v, JDT[dt]) if not isinstance(v, dict)
                   else {kk: jnp.asarray(vv, JDT[dt]) for kk, vv in v.items()})
               for k, v in p.items()}
    JC.save_hf_checkpoint(jparams, cfg, str(tmp_path))
    tcfg2, tparams = TC.load_hf_checkpoint(str(tmp_path), dtype=TDT[dt], device="cpu",
                                           w_bits=4, a_bits=8, kv_bits=4)
    jcfg2, jparams2 = JC.load_hf_checkpoint(str(tmp_path), dtype=JDT[dt],
                                            w_bits=4, a_bits=8, kv_bits=4)
    assert tcfg2 == tcfg(jcfg2)
    _assert_same(tparams, jparams2)
    _assert_same(tparams, jparams)
    assert all(t.dtype == TDT[dt] and t.device.type == "cpu" for t in _leaves(tparams))


def _leaves(tree):
    for v in tree.values():
        yield from (_leaves(v) if isinstance(v, dict) else [v])


@pytest.mark.parametrize("tied", [False, True])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_port_save_jax_load(tmp_path, tied, dt):
    cfg, p = _params(tied, seed=1)
    tparams = TP.from_numpy(p, "cpu", dtype=TDT[dt])
    n = TC.save_hf_checkpoint(tparams, tcfg(cfg), str(tmp_path))
    assert n == (tmp_path / "model.safetensors").stat().st_size
    jcfg2, jparams = JC.load_hf_checkpoint(str(tmp_path), dtype=JDT[dt])
    assert jcfg2.num_hidden_layers == cfg.num_hidden_layers
    assert jcfg2.tie_word_embeddings == tied
    hf = json.loads((tmp_path / "config.json").read_text())
    assert (hf["w_bits"], hf["a_bits"], hf["kv_bits"]) == (4, 8, 4)
    _assert_same(tparams, jparams)
    # the config file is the JAX package's, key for key
    JC.save_hf_checkpoint(jparams, cfg, str(tmp_path / "jax"))
    assert (json.loads((tmp_path / "config.json").read_text())
            == json.loads((tmp_path / "jax" / "config.json").read_text()))
    if dt == "bf16":
        # bf16 on disk (the card's teacher) round-trips the same bits
        TC.save_hf_checkpoint(tparams, tcfg(cfg), str(tmp_path / "b"), dtype=torch.bfloat16)
        _, back = TC.load_hf_checkpoint(str(tmp_path / "b"), dtype=TDT[dt], device="cpu")
        _assert_same(back, TP.to_numpy(tparams))


def test_safetensors_bytes_are_the_packages(tmp_path):
    """The port's writer against ``safetensors.numpy.save_file`` (what the JAX
    package calls) on an HF state dict, and against
    ``safetensors.torch.save_file`` on every dtype the port reads."""
    cfg, p = _params(False, seed=2)
    sd = TC.state_dict_from_params(TP.from_numpy(p, "cpu"), tcfg(cfg))
    jsd = JC.state_dict_from_params(p, cfg)
    assert set(sd) == set(jsd)
    for k in sd:
        np.testing.assert_array_equal(sd[k].numpy(), jsd[k], err_msg=k)
    TC.save_safetensors(sd, str(tmp_path / "port.safetensors"))
    np_save_file(jsd, str(tmp_path / "pkg.safetensors"))
    assert (tmp_path / "port.safetensors").read_bytes() == (tmp_path / "pkg.safetensors").read_bytes()

    g = torch.Generator().manual_seed(0)
    mixed = {
        "w": torch.randn(3, 5, generator=g).to(torch.bfloat16),
        "a": torch.randn(7, generator=g).to(torch.float16),
        "b": torch.randn(2, 2, generator=g),
        "c": torch.randint(-100, 100, (9,), generator=g, dtype=torch.int8),
        "d": torch.randint(-9, 9, (2, 3), generator=g, dtype=torch.int32),
        "scalar": torch.tensor(1.5),
        "empty": torch.zeros(0, 4),
    }
    TC.save_safetensors(mixed, str(tmp_path / "port2.safetensors"))
    torch_save_file(mixed, str(tmp_path / "pkg2.safetensors"))
    assert ((tmp_path / "port2.safetensors").read_bytes()
            == (tmp_path / "pkg2.safetensors").read_bytes())
    back = TC.load_safetensors(str(tmp_path / "pkg2.safetensors"))
    assert set(back) == set(mixed)
    for k, v in mixed.items():
        assert back[k].dtype == v.dtype and torch.equal(back[k], v), k


def test_bin_shards_load(tmp_path):
    """Torch ``.bin`` shards (no safetensors files) load as the JAX package
    loads them."""
    cfg, p = _params(False, seed=3)
    sd = TC.state_dict_from_params(TP.from_numpy(p, "cpu"), tcfg(cfg))
    keys = sorted(sd)
    half = len(keys) // 2
    torch.save({k: sd[k] for k in keys[:half]}, tmp_path / "pytorch_model-00001-of-00002.bin")
    torch.save({k: sd[k] for k in keys[half:]}, tmp_path / "pytorch_model-00002-of-00002.bin")
    hf = dict(vocab_size=cfg.vocab_size, hidden_size=cfg.hidden_size,
              intermediate_size=cfg.intermediate_size, num_hidden_layers=cfg.num_hidden_layers,
              num_attention_heads=cfg.num_attention_heads, num_key_value_heads=2,
              max_position_embeddings=64)
    (tmp_path / "config.json").write_text(json.dumps(hf))
    _, tparams = TC.load_hf_checkpoint(str(tmp_path), dtype=torch.float32, device="cpu")
    _, jparams = JC.load_hf_checkpoint(str(tmp_path), dtype=jnp.float32)
    _assert_same(tparams, jparams)
    (tmp_path / "empty").mkdir()
    with pytest.raises(FileNotFoundError):
        TC._load_raw_state_dict(str(tmp_path / "empty"))


def test_untied_checkpoint_without_head_loads_tied(tmp_path):
    """No ``lm_head.weight`` in the files: the config turns tied, as in JAX."""
    cfg, p = _params(True, seed=4)
    TC.save_hf_checkpoint(TP.from_numpy(p, "cpu"), tcfg(cfg), str(tmp_path))
    hf = json.loads((tmp_path / "config.json").read_text())
    hf["tie_word_embeddings"] = False
    (tmp_path / "config.json").write_text(json.dumps(hf))
    tcfg2, tparams = TC.load_hf_checkpoint(str(tmp_path), device="cpu")
    jcfg2, _ = JC.load_hf_checkpoint(str(tmp_path))
    assert tcfg2.tie_word_embeddings and jcfg2.tie_word_embeddings
    assert "lm_head" not in tparams
