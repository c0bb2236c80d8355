"""Port parity: the eval CLI (llm_qat_torch.cli.eval.main, and eval_torch.py)
against the JAX package's (llm_qat_tpu.cli.eval.main), on the CPU.

Both read one HF checkpoint written by the JAX package's ``convert`` and the
same task files (all eight tasks, ``zero_shot.random_docs`` in each task's
field layout) and perplexity jsonl, with the byte tokenizer. Limits: every
task's ``n`` equal, its summed log-probs held as ``tests/test_torch_eval.py``
holds them (1e-5 relative in float32, an argmax that parts only on a near
tie, the accuracies apart by those examples only), the perplexity's
``eval_loss`` at 1e-5 relative (float32). In bf16 JAX's eval modules compile
without excess precision (``test_torch_eval._strict_jit``), as the port's
other bf16 cases do: ``eval_loss`` at ``TE.BF16_LOSS_REL``.
"""

import json
import os
import subprocess
import sys
import types

import jax

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_qat_tpu.cli import eval as JCLI
from llm_qat_tpu.eval import perplexity as JP
from llm_qat_tpu.eval import zero_shot as JZ
from llm_qat_tpu.models import convert as JC
from llm_qat_tpu.models.config import TINY_TEST
from llm_qat_torch.cli import eval as TCLI
from llm_qat_torch.eval import zero_shot as TZ

import tests.test_torch_eval as TE
from tests.test_torch_serving import np_params

CFG = TINY_TEST.replace(num_hidden_layers=2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    d = tmp_path_factory.mktemp("eval_cli")
    p = np_params(CFG, seed=0)
    JC.save_hf_checkpoint(TE._tree(jnp.asarray, p), CFG, str(d / "model"))
    os.makedirs(d / "tasks")
    for task in TZ.TASK_ADAPTERS:
        with open(d / "tasks" / f"{task}.jsonl", "w") as f:
            for doc in TZ.random_docs(task, 5, seed=6, max_words=8):
                f.write(json.dumps(doc) + "\n")
    rng = np.random.default_rng(0)
    with open(d / "ppl.jsonl", "w") as f:
        for _ in range(6):
            f.write(json.dumps({"text": "".join(chr(97 + c) for c in rng.integers(0, 26, 50))})
                    + "\n")
    return d


def _argv(d, *extra):
    return ["--model", str(d / "model"), "--tokenizer", "byte", "--w_bits", "4", "--a_bits",
            "8", "--kv_bits", "4", "--tasks", ",".join(TZ.TASK_ADAPTERS), "--task_dir",
            str(d / "tasks"), "--perplexity_data", str(d / "ppl.jsonl"), "--block_size", "32",
            *extra]


def _scores(d, task, w_bits, max_len):
    """Both packages' summed log-probs of a task, as the CLI scores it."""
    from llm_qat_tpu.data.dataset import load_tokenizer
    from llm_qat_tpu.models import convert
    from llm_qat_torch.models import convert as tconvert

    _, tok = load_tokenizer("byte")
    docs = [json.loads(line) for line in open(d / "tasks" / f"{task}.jsonl")]
    bits = dict(w_bits=w_bits, a_bits=8, kv_bits=4)
    jcfg, jp = convert.load_hf_checkpoint(str(d / "model"), dtype=jnp.float32, **bits)
    tcfg, tp = tconvert.load_hf_checkpoint(str(d / "model"), dtype=torch.float32,
                                           device="cpu", **bits)
    kw = dict(batch_rows=4, max_len=max_len, return_scores=True)
    want = JZ.evaluate_task(jp, jcfg, task, docs, tok, compute_dtype=jnp.float32, **kw)
    got = TZ.evaluate_task(tp, tcfg, task, docs, tok, compute_dtype=torch.float32, **kw)
    return got["scores"], np.asarray(want["scores"])


@pytest.mark.parametrize("max_len", ["0", "40"])
def test_eval_cli_matches_jax(workdir, max_len, capsys):
    """float32, all eight tasks, with and without a 40-token cap."""
    d = workdir
    args = _argv(d, "--bf16", "false", "--max_len", max_len, "--batch_rows", "4")
    want = JCLI.main(args + ["--output_json", str(d / f"jax_{max_len}.json")])
    jax_out = capsys.readouterr().out
    got = TCLI.main(args + ["--output_json", str(d / f"torch_{max_len}.json"),
                            "--device", "cpu"])
    torch_out = capsys.readouterr().out
    assert set(got) == set(want) == {"perplexity", "average_acc_norm", *TZ.TASK_ADAPTERS}
    np.testing.assert_allclose(got["perplexity"]["eval_loss"], want["perplexity"]["eval_loss"],
                               rtol=1e-5)
    for task in TZ.TASK_ADAPTERS:
        assert got[task]["n"] == want[task]["n"] == 5
        parted = TE._hold_scores(*_scores(d, task, 4, int(max_len) or None))
        for key in ("acc", "acc_norm"):
            assert abs(got[task][key] - want[task][key]) * 5 <= len(parted), (task, key)
    if got == want:
        assert torch_out == jax_out
    assert [line.split(":")[0] for line in torch_out.splitlines()] == \
        [line.split(":")[0] for line in jax_out.splitlines()]
    assert json.load(open(d / f"torch_{max_len}.json")) == got


def test_eval_cli_bf16_matches_jax(workdir, capsys, monkeypatch):
    d = workdir
    args = _argv(d, "--bf16", "true")
    monkeypatch.setattr(JP, "jax", types.SimpleNamespace(jit=TE._strict_jit))
    monkeypatch.setattr(JZ, "jax", types.SimpleNamespace(jit=TE._strict_jit, nn=jax.nn))
    want = JCLI.main(args)
    got = TCLI.main(args + ["--device", "cpu"])
    capsys.readouterr()
    np.testing.assert_allclose(got["perplexity"]["eval_loss"], want["perplexity"]["eval_loss"],
                               rtol=TE.BF16_LOSS_REL)
    for task in TZ.TASK_ADAPTERS:
        assert got[task]["n"] == want[task]["n"]
        assert 0.0 <= got[task]["acc"] <= 1.0 and 0.0 <= got[task]["acc_norm"] <= 1.0


def test_eval_cli_needs_the_card_unless_asked_for_the_cpu(workdir):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is available")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TCLI.main(_argv(workdir))


def test_eval_torch_script_runs_the_cli(workdir):
    """``python eval_torch.py ... --device cpu`` from the repository root
    prints each task's line and writes the same json."""
    d = workdir
    out = d / "script.json"
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run(
        [sys.executable, os.path.join(REPO, "eval_torch.py"), "--model", str(d / "model"),
         "--tokenizer", "byte", "--tasks", "piqa,winogrande", "--task_dir", str(d / "tasks"),
         "--bf16", "false", "--device", "cpu", "--output_json", str(out)],
        capture_output=True, text=True, timeout=300, env=env, cwd=str(d))
    assert res.returncode == 0, res.stderr
    saved = json.load(open(out))
    assert saved["piqa"]["n"] == saved["winogrande"]["n"] == 5
    assert res.stdout.splitlines()[-1].startswith("average acc_norm:")
