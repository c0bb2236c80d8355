"""Port parity: llm_qat_torch.utils (flags, TensorBoard writer, metrics
logger, profiling helpers, step checkpoints) against the JAX package's
``utils``.

The TensorBoard writer's file is held byte for byte to the JAX package's for
the same scalars, wall time and host name. ``CheckpointManager`` follows
Orbax's rules as the JAX package uses them: the first ``maybe_save`` writes,
then every ``save_interval_steps``-th step; ``save`` writes any step not yet
written; the newest ``max_to_keep`` steps stay.
"""

import json
import math
import os

import numpy as np
import pytest
import torch

from llm_qat_tpu.models.config import LlamaConfig as JConfig
from llm_qat_tpu.utils import args as JA
from llm_qat_tpu.utils import profiling as JP
from llm_qat_tpu.utils import tb_writer as JW
from llm_qat_torch.models import params as TP
from llm_qat_torch.training import trainer as TT
from llm_qat_torch.utils import args as TA
from llm_qat_torch.utils import checkpoint as TCK
from llm_qat_torch.utils import logging_utils as TLOG
from llm_qat_torch.utils import profiling as TPR
from llm_qat_torch.utils import tb_writer as TW

from tests.test_torch_serving import np_params, tcfg


def test_process_args_defaults_and_overrides():
    m, d, t = TA.process_args([])
    assert m.w_bits == 32 and t.learning_rate == 2e-5 and t.save_steps == 2000
    assert t.device == "cuda"
    m, d, t = TA.process_args(
        ["--w_bits", "4", "--a_bits", "8", "--kv_bits", "4", "--qat", "true",
         "--use_kd", "true", "--mesh_tp", "2", "--learning_rate", "1e-4", "--device", "cpu"])
    assert (m.w_bits, m.a_bits, m.kv_bits) == (4, 8, 4)
    assert t.qat and t.use_kd and t.mesh_tp == 2 and t.device == "cpu"
    assert t.learning_rate == 1e-4


def test_flags_are_the_jax_packages_plus_device():
    for jcls, tcls in ((JA.ModelArguments, TA.ModelArguments),
                       (JA.DataArguments, TA.DataArguments),
                       (JA.TrainingArguments, TA.TrainingArguments)):
        jf = {f.name: f.default for f in jcls.__dataclass_fields__.values()}
        tf = {f.name: f.default for f in tcls.__dataclass_fields__.values()}
        assert set(tf) - set(jf) <= {"device"} and set(jf) <= set(tf)
        for name in jf:
            if name not in ("local_dir", "output_dir"):   # temp dirs of each package
                assert tf[name] == jf[name], name
    with pytest.raises(NotImplementedError, match="single device"):
        TA.check_single_device(TA.TrainingArguments(mesh_fsdp=8))
    TA.check_single_device(TA.TrainingArguments())


def test_tb_writer_bytes_are_the_jax_packages(tmp_path, monkeypatch):
    ticks = []
    monkeypatch.setattr(JW.time, "time", lambda: 1700000000.25 + 1.5 * len(ticks.append(0) or ticks))
    monkeypatch.setattr(JW.socket, "gethostname", lambda: "host")
    assert TW.time is JW.time and TW.socket is JW.socket
    files = []
    for mod, d in ((JW, tmp_path / "jax"), (TW, tmp_path / "torch")):
        ticks.clear()
        w = mod.ScalarEventWriter(str(d))
        w.add_scalars(1, {"loss": 2.5, "lr": 1e-4})
        w.add_scalars(2, {"loss": 1.25, "grad_norm": float("nan")})
        w.close()
        (f,) = os.listdir(d)
        files.append((f, (d / f).read_bytes()))
    assert files[0] == files[1]
    assert TW._crc32c(b"123456789") == 0xE3069283


def test_metrics_logger_jsonl_and_events(tmp_path):
    m = TLOG.MetricsLogger(str(tmp_path))
    m.log(5, {"loss": torch.tensor(3.0), "grad_norm": 0.5})
    m.log(6, {"loss": 2.0})
    m.close()
    recs = [json.loads(line) for line in open(tmp_path / "metrics.jsonl")]
    assert [r["step"] for r in recs] == [5, 6]
    assert recs[0]["loss"] == 3.0 and recs[0]["grad_norm"] == 0.5 and "time" in recs[0]
    assert any(f.startswith("events.out.tfevents.") for f in os.listdir(tmp_path))
    off = TLOG.MetricsLogger(str(tmp_path / "off"), use_tensorboard=False)
    off.log(1, {"x": 1})
    off.close()
    assert os.listdir(tmp_path / "off") == ["metrics.jsonl"]
    assert TLOG.process_index() == 0 and TLOG.process_count() == 1
    assert TLOG.get_logger().name == "llm_qat_torch"


def test_step_timer_summary(monkeypatch):
    now = iter([0.0, 1.0, 3.0, 6.0, 10.0])
    monkeypatch.setattr(TPR.time, "perf_counter", lambda: next(now))
    t = TPR.StepTimer(warmup_steps=1)
    assert math.isnan(t.summary()["step_time_s"])
    for _ in range(5):
        t.tick(tokens=100)
    # intervals 1, 2, 3, 4: the first is warm-up
    assert t.steps_timed == 3
    s = t.summary()
    assert s["step_time_s"] == 3.0 and s["tokens_per_s"] == 300 / 9
    assert s["tokens_per_s_per_chip"] == s["tokens_per_s"]


def test_profiling_helpers(tmp_path):
    cfg = JConfig(vocab_size=500, hidden_size=64, intermediate_size=96, num_hidden_layers=3,
                  num_attention_heads=4, num_key_value_heads=2)
    for training in (False, True):
        assert (TPR.model_flops_per_token(tcfg(cfg), 128, training)
                == JP.model_flops_per_token(cfg, 128, training))
    if not torch.cuda.is_available():
        assert TPR.chip_peak_flops() is None
    with TPR.trace(str(tmp_path / "tr")):
        with TPR.annotate("phase"):
            torch.ones(4).sum()
    assert (tmp_path / "tr" / "trace.json").exists()


CFG = JConfig(vocab_size=64, hidden_size=32, intermediate_size=64, num_hidden_layers=1,
              num_attention_heads=2, num_key_value_heads=1, max_position_embeddings=32,
              w_bits=4, a_bits=8, kv_bits=4)


def _trainer():
    p, t = np_params(CFG, 0), np_params(CFG, 1)
    tr = TT.Trainer(tcfg(CFG), TT.TrainConfig(compute_dtype=torch.float32, total_steps=10),
                    TP.from_numpy(p, "cpu"), TP.from_numpy(t, "cpu"), device="cpu")
    ids = np.random.default_rng(0).integers(0, CFG.vocab_size, (2, 8)).astype(np.int32)
    return tr, {"input_ids": ids, "labels": ids}


def test_checkpoint_round_trip_and_no_teacher(tmp_path):
    tr, batch = _trainer()
    tr.train_step(batch)
    m = TCK.CheckpointManager(str(tmp_path / "ck"), save_interval_steps=1)
    assert m.latest_step() is None
    with pytest.raises(FileNotFoundError):
        m.restore(tr.state)
    assert m.save(1, tr.state) and not m.save(1, tr.state)
    m.wait()
    assert m.latest_step() == 1
    saved = torch.load(tmp_path / "ck" / "1" / "state.pt", weights_only=True)
    assert set(saved) == {"params", "opt_state", "step"}
    n_student = sum(t.numel() for t in TT.tree_leaves(tr.state.params))
    n_saved = sum(t.numel() for t in TT.tree_leaves(saved["params"]))
    assert n_saved == n_student                      # the teacher is not written
    template, _ = _trainer()
    back = m.restore(template.state)
    assert back.step == 1 and back.opt_state["count"] == 1
    for a, b in zip(TT.tree_leaves(back.params), TT.tree_leaves(tr.state.params)):
        assert torch.equal(a, b)
    for k in ("mu", "nu"):
        for a, b in zip(TT.tree_leaves(back.opt_state[k]), TT.tree_leaves(tr.state.opt_state[k])):
            assert torch.equal(a, b)
    # a template of another shape refuses the checkpoint
    bad = TT.TrainState({"embed": torch.zeros(3)}, template.state.opt_state, 0)
    with pytest.raises(ValueError):
        m.restore(bad)
    assert not [f for f in os.listdir(tmp_path / "ck") if f.startswith(".")]   # no temp dirs


def test_checkpoint_interval_and_retention(tmp_path):
    tr, _ = _trainer()
    m = TCK.CheckpointManager(str(tmp_path / "ck"), max_to_keep=2, save_interval_steps=2)
    written = [s for s in range(1, 8) if m.maybe_save(s, tr.state)]
    # Orbax's rule, as the JAX package's manager shows it: the first step,
    # then every second
    assert written == [1, 2, 4, 6]
    assert m.all_steps() == [4, 6]
    assert m.save(7, tr.state) and m.all_steps() == [6, 7] and m.latest_step() == 7
    m.close()
