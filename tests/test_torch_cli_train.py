"""Port parity: the train CLI (llm_qat_torch.cli.train.run) against the JAX
package's (llm_qat_tpu.cli.train.run on a 1 x 1 x 1 mesh), on the same tiny
HF checkpoint and jsonl, in float32 on the CPU: 4 KD-QAT steps with a step
checkpoint every 2, the HF export and the eval perplexity.

Limits are those ``tests/test_torch_trainer.py`` holds whole steps to: each
step's loss in ``metrics.jsonl`` at 1e-4 relative; the exported params within
2.1 x (steps x lr) everywhere and within 1e-3 lr + 1e-6 |p| for 99.9% of each
leaf (Adam moves a weight whose gradient is within ~1e-8 of zero anywhere in
+-lr). Eval perplexity at 1e-4 relative. The model keeps b*s = 32 rows a step
and 2 layers.

Rounding flips (the class ``tests/test_torch_llama_train.py`` names): each
step's student forward is re-run in both packages from each one's params
before that step, with every quantizer's codes recorded. At the first step
whose codes part, they must part in one element by one level; that step's
loss and every later one are held at ``FLIP_LOSS`` relative, the exported
params at a relative L2 of ``FLIP_PARAMS`` per leaf (and the 2.1 x steps x lr
bound everywhere), the perplexity at ``FLIP_LOSS``. Met on an AMD EPYC host:
step 3's forward flips layer 1's attention-output quant at sequence 0,
token 11 (the loss 0.05% off at step 3, 0.16% at step 4).

A resumed run (2 steps, a crash, then a restart) is held bit for bit to 4
straight steps: params and both Adam moments.
"""

import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_qat_tpu.cli import train as JCLI
from llm_qat_tpu.models import convert as JC
from llm_qat_tpu.models.config import LlamaConfig as JConfig
from llm_qat_tpu.utils import args as JA
from llm_qat_torch.cli import train as TCLI
from llm_qat_torch.data import dataset as TD
from llm_qat_torch.models import convert as TC
from llm_qat_torch.training import trainer as TT
from llm_qat_torch.utils import args as TA
from llm_qat_tpu.models import llama as JL
from llm_qat_tpu.training import trainer as JT
from llm_qat_torch.models import llama as TL
from llm_qat_torch.models import params as TP

import tests.test_torch_llama_train as LT
from tests.test_torch_serving import np_params, tcfg

CFG = JConfig(vocab_size=256, hidden_size=128, intermediate_size=256, num_hidden_layers=2,
              num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=128)
LR = 1e-3
STEPS = 4
FLIP_LOSS = 1e-2
FLIP_PARAMS = 1e-3


def fake_tokenize(text):
    return [ord(c) % 251 for c in text]


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli")
    p = np_params(CFG, seed=0)
    JC.save_hf_checkpoint({k: (jnp.asarray(v) if not isinstance(v, dict) else
                               {kk: jnp.asarray(vv) for kk, vv in v.items()})
                           for k, v in p.items()}, CFG, str(d / "teacher"))
    rng = np.random.default_rng(0)
    with open(d / "train.jsonl", "w") as f:
        for _ in range(12):
            f.write(json.dumps({"text": "".join(chr(97 + c) for c in rng.integers(0, 26, 40))})
                    + "\n")
    return d


def _args(A, d, name, **kw):
    margs = A.ModelArguments(input_model_filename=str(d / "teacher"),
                             output_model_filename="student", local_dir=str(d / name / "local"),
                             w_bits=4, a_bits=8, kv_bits=4)
    dargs = A.DataArguments(train_data_local_path=str(d / "train.jsonl"),
                            eval_data_local_path=str(d / "train.jsonl"))
    targs = dict(output_dir=str(d / name / "out"), model_max_length=16, qat=True, use_kd=True,
                 per_device_train_batch_size=2, per_device_eval_batch_size=2,
                 learning_rate=LR, max_steps=STEPS, save_steps=2, bf16=False,
                 mesh_data=1, mesh_fsdp=1, mesh_tp=1)
    targs.update(kw)
    return margs, dargs, A.TrainingArguments(**targs)


def _losses(d, name):
    path = os.path.join(d, name, "out", "logs", "metrics.jsonl")
    return [json.loads(line)["loss"] for line in open(path)]


def _leaves(node, prefix=""):
    for k in sorted(node):
        if isinstance(node[k], dict):
            yield from _leaves(node[k], f"{prefix}{k}/")
        else:
            yield prefix + k, node[k]


@pytest.fixture(scope="module")
def runs(workdir):
    """Both CLIs' results, and each step's (params before it, batch) on
    both sides."""
    d = workdir
    seen = {"jax": [], "torch": []}
    jstep, tstep = JT.Trainer.train_step, TT.Trainer.train_step

    def jax_step(self, batch):
        seen["jax"].append((jax.tree.map(np.asarray, self.state.params), batch))
        return jstep(self, batch)

    def torch_step(self, batch):
        # copies: the port updates its params in place
        seen["torch"].append((jax.tree.map(np.array, TP.to_numpy(self.state.params)), batch))
        return tstep(self, batch)

    with pytest.MonkeyPatch.context() as mp:
        # the suite's 8 virtual devices: the JAX CLI's mesh takes one of them
        mp.setattr(JCLI.pmesh, "make_mesh",
                   functools.partial(JCLI.pmesh.make_mesh, devices=jax.devices()[:1]))
        mp.setattr(JT.Trainer, "train_step", jax_step)
        mp.setattr(TT.Trainer, "train_step", torch_step)
        jres = JCLI.run(*_args(JA, d, "jax"), tokenize=fake_tokenize)
        tres = TCLI.run(*_args(TA, d, "torch"), tokenize=fake_tokenize, device="cpu")
    return jres, tres, seen


def _first_flipped_step(seen):
    """The first step (1-based) whose student forward parts in its codes, or
    None; checks that it parts by one flip."""
    cfg = CFG.replace(w_bits=4, a_bits=8, kv_bits=4)
    for k, ((jp, batch), (tp, tbatch)) in enumerate(zip(seen["jax"], seen["torch"]), 1):
        ids = np.asarray(batch["input_ids"])
        assert np.array_equal(ids, np.asarray(tbatch["input_ids"]))
        with pytest.MonkeyPatch.context() as mp:
            rec = LT._record_quantizers(mp)
            JL.forward(jax.tree.map(jnp.asarray, jp), cfg, jnp.asarray(ids))
            jax.effects_barrier()
            TL.forward(TP.from_numpy(tp, "cpu"), tcfg(cfg), torch.from_numpy(ids))
        if LT._first_flip(rec, *ids.shape) is not None:
            return k
    return None


def test_cli_matches_jax_cli(workdir, runs):
    jres, tres, seen = runs
    assert jres["train_steps"] == tres["train_steps"] == STEPS
    flip = _first_flipped_step(seen)
    n_exact = STEPS if flip is None else flip - 1
    jl, tl = _losses(workdir, "jax"), _losses(workdir, "torch")
    assert len(jl) == len(tl) == STEPS
    np.testing.assert_allclose(tl[:n_exact], jl[:n_exact], rtol=1e-4)
    np.testing.assert_allclose(tl[n_exact:], jl[n_exact:], rtol=FLIP_LOSS)
    tol = 1e-4 if flip is None else FLIP_LOSS
    np.testing.assert_allclose(tres["perplexity"], jres["perplexity"], rtol=tol)
    np.testing.assert_allclose(tres["eval_loss"], jres["eval_loss"], rtol=tol)
    assert tres["jsonl_reader"] in ("native", "python")
    # the exports: the same HF files, params at the whole-step limits
    _, jp = JC.load_hf_checkpoint(jres["model_path"], dtype=jnp.float32)
    tcfg2, tp = TC.load_hf_checkpoint(tres["model_path"], dtype=torch.float32, device="cpu")
    assert tcfg2.hidden_size == CFG.hidden_size
    for (name, a), (_, b) in zip(_leaves(tp), _leaves(jp)):
        a, b = a.numpy(), np.asarray(b)
        d = np.abs(a - b)
        assert d.max() <= 2.1 * STEPS * LR, (name, d.max())
        if flip is None:
            assert (d <= 1e-3 * LR + 1e-6 * np.abs(b)).mean() >= 0.999, name
        else:
            assert np.linalg.norm(d) <= FLIP_PARAMS * np.linalg.norm(b), (
                name, np.linalg.norm(d) / np.linalg.norm(b))
    # step checkpoints at 2 and 4, the newest kept (save_total_limit 1)
    ckpts = os.listdir(os.path.join(workdir, "torch", "out", "checkpoints"))
    assert ckpts == ["4"]


class _Crash(Exception):
    pass


def test_resume_is_bit_equal_to_straight_steps(workdir, runs, monkeypatch):
    """2 steps, a crash before the third, a restart with
    ``resume_from_checkpoint``: the step-2 checkpoint is restored and the
    data order replayed, so params and moments equal 4 straight steps'."""
    d = workdir
    real = TT.Trainer.train_step
    calls = []

    def crashing(self, batch):
        calls.append(1)
        if len(calls) == 3:
            raise _Crash
        return real(self, batch)

    monkeypatch.setattr(TT.Trainer, "train_step", crashing)
    with pytest.raises(_Crash):
        TCLI.run(*_args(TA, d, "resumed"), tokenize=fake_tokenize, device="cpu")
    monkeypatch.setattr(TT.Trainer, "train_step", real)
    assert os.listdir(os.path.join(d, "resumed", "out", "checkpoints")) == ["2"]
    res = TCLI.run(*_args(TA, d, "resumed", resume_from_checkpoint=True),
                   tokenize=fake_tokenize, device="cpu")
    assert res["train_steps"] == STEPS
    straight = torch.load(os.path.join(d, "torch", "out", "checkpoints", "4", "state.pt"),
                          weights_only=True)
    resumed = torch.load(os.path.join(d, "resumed", "out", "checkpoints", "4", "state.pt"),
                         weights_only=True)
    assert straight["step"] == resumed["step"] == STEPS
    assert straight["opt_state"]["count"] == resumed["opt_state"]["count"] == STEPS
    for tree in ("params", "opt_state"):
        a = dict(_leaves({k: v for k, v in straight[tree].items() if k != "count"}))
        b = dict(_leaves({k: v for k, v in resumed[tree].items() if k != "count"}))
        assert a.keys() == b.keys() and a
        for k in a:
            assert torch.equal(a[k], b[k]), (tree, k)
    # the resumed run logged steps 3 and 4 only, with the straight run's losses
    assert _losses(d, "resumed")[-2:] == _losses(d, "torch")[2:]


@pytest.mark.parametrize("axis", ["mesh_fsdp", "mesh_tp", "mesh_data", "mesh_pp", "mesh_cp"])
def test_mesh_larger_than_one_raises(workdir, axis):
    """Every axis the trainer splits (tp and pp too) needs the ranks of a
    process group, which a single process does not have: the run asks for
    torchrun."""
    with pytest.raises(ValueError, match="torchrun"):
        TCLI.run(*_args(TA, workdir, "mesh", **{axis: 2}), tokenize=fake_tokenize,
                 device="cpu")


def test_run_needs_a_gpu_unless_cpu_is_asked(workdir, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TCLI.run(*_args(TA, workdir, "nogpu"), tokenize=fake_tokenize)


def test_main_parses_the_flags(workdir, monkeypatch):
    """``main`` is ``run(*process_args(argv))``: the torch flags reach the
    run, the byte tokenizer works offline."""
    seen = {}
    monkeypatch.setattr(TCLI, "run", lambda m, d, t: seen.update(m=m, d=d, t=t) or {})
    TCLI.main(["--input_model_filename", "x", "--tokenizer", "byte", "--device", "cpu",
               "--qat", "true", "--w_bits", "4", "--max_steps", "3"])
    assert seen["t"].device == "cpu" and seen["t"].qat and seen["t"].max_steps == 3
    assert seen["m"].tokenizer == "byte" and seen["m"].w_bits == 4
    tok, encode = TD.load_tokenizer("byte")
    assert encode("ab") == [1, 100, 101] and tok.decode([1, 100, 101]) == "ab"
