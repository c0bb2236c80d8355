"""The port's example scripts against the JAX package's, on the CPU.

* ``examples/accuracy_experiment_torch.py``: its host-side stages equal
  ``examples/accuracy_experiment.py``'s (the corpus files byte for byte on a
  small ``max_mb``, the two-choice tasks example for example), and on the
  same numpy teacher the margin filter keeps the same candidates and
  ``evaluate_model`` gives the same accuracies and the perplexity within
  1e-5 (relative; f32 on both sides). Its ``--small --device cpu`` run writes
  a ``results.json`` that ``examples/accuracy_table.py`` reads.
* ``examples/tiny_pipeline_torch.py`` runs its five stages on the CPU from
  JAX's teacher (``init_params(PRNGKey(0))``), and the student it exports
  loads in both packages with the same logits (1e-5, f32).
* Without a workdir, each run of either script takes a fresh directory
  under the temporary directory, so two runs share no artifact.
"""

import contextlib
import importlib.util
import io
import json
import os
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_qat_tpu.models import convert as JC
from llm_qat_tpu.models import llama as JL
from llm_qat_torch.models import convert as TC
from llm_qat_torch.models import llama as TL
from llm_qat_torch.models import params as TP

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load(name):
    path = os.path.join(REPO, "examples", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"_example_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def acc(tmp_path_factory):
    """(JAX script, torch script, the JAX corpus's and the torch corpus's
    train / holdout paths, the torch corpus's holdout texts)."""
    jmod, tmod = _load("accuracy_experiment"), _load("accuracy_experiment_torch")
    jdir, tdir = (str(tmp_path_factory.mktemp(n)) for n in ("jax", "torch"))
    with contextlib.redirect_stdout(io.StringIO()):
        jpaths = jmod.build_corpus(jdir, max_mb=0.1)
        tpaths = tmod.build_corpus(tdir, max_mb=0.1)
    hold = tmod.read_jsonl_texts(tpaths[1])
    return jmod, tmod, jpaths, tpaths, hold


def _same_examples(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert list(x.context) == list(y.context) and x.gold == y.gold
        assert [list(c) for c in x.choices] == [list(c) for c in y.choices]


def test_corpus_and_tasks_are_the_jax_scripts(acc):
    jmod, tmod, jpaths, tpaths, hold = acc
    for jp, tp in zip(jpaths, tpaths):
        with open(jp, "rb") as f, open(tp, "rb") as g:
            assert f.read() == g.read()
    assert len(hold) >= 20
    _same_examples(jmod.make_mc_examples(hold, 24, seed=3), tmod.make_mc_examples(hold, 24, seed=3))
    _same_examples(jmod.make_word_swap_candidates(hold, 24, seed=4),
                   tmod.make_word_swap_candidates(hold, 24, seed=4))


def test_filter_and_evaluate_match_jax_on_the_same_teacher(acc):
    jmod, tmod, _, tpaths, hold = acc
    cfg_t = tmod.model_config(small=True)
    cfg_j = JL.LlamaConfig(**{k: getattr(cfg_t, k) for k in (
        "vocab_size", "hidden_size", "intermediate_size", "num_hidden_layers",
        "num_attention_heads", "num_key_value_heads", "max_position_embeddings")})
    jteacher = JL.init_params(cfg_j, jax.random.PRNGKey(0), dtype=jnp.float32)
    tteacher = TP.from_numpy(jax.tree.map(np.asarray, jteacher), device="cpu",
                             dtype=torch.float32)
    cand = tmod.make_word_swap_candidates(hold, 48, seed=1)
    with contextlib.redirect_stdout(io.StringIO()):
        jkeep = jmod.filter_by_teacher_margin(jteacher, cfg_j, cand, 16, jnp.float32)
        tkeep = tmod.filter_by_teacher_margin(tteacher, cfg_t, cand, 16, torch.float32)
    _same_examples(jkeep, tkeep)
    blocks = tmod.pack_blocks(hold, tmod.TOK.encode, 64)[:8]
    tasks = {"mc_far": tmod.make_mc_examples(hold, 16, seed=0), "mc_margin": tkeep}
    for bits in (dict(), dict(w_bits=4, a_bits=8, kv_bits=4)):
        want = jmod.evaluate_model(jteacher, cfg_j.replace(**bits), blocks, tasks, 4,
                                   jnp.float32)
        got = tmod.evaluate_model(tteacher, cfg_t.replace(**bits), blocks, tasks, 4,
                                  torch.float32)
        assert set(got) == set(want)
        assert abs(got["ppl"] - want["ppl"]) <= 1e-5 * want["ppl"] + 1e-4   # both rounded to 4
        assert abs(got["eval_loss"] - want["eval_loss"]) <= 1e-5           # both rounded to 5
        assert {k: v for k, v in got.items() if k.startswith("mc_")} == {
            k: v for k, v in want.items() if k.startswith("mc_")}


def test_accuracy_experiment_small_on_cpu_and_the_table_reads_it(tmp_path):
    tmod, table = _load("accuracy_experiment_torch"), _load("accuracy_table")
    work = str(tmp_path / "acc")
    with contextlib.redirect_stdout(io.StringIO()):
        res = tmod.main([work, "--small", "--device", "cpu", "--teacher_steps", "3",
                         "--qat_steps", "2", "--corpus_mb", "0.1"])
    with open(os.path.join(work, "results.json")) as f:
        saved = json.load(f)
    assert saved["config"]["platform"] == "cpu" and saved["config"]["model"]["hidden"] == 64
    assert set(saved["configs"]) == {"W4A8KV4"} and saved["qat"] == res["qat"]
    for entry in (saved["fp_teacher"], saved["ptq"], saved["qat"]):
        assert np.isfinite(entry["ppl"]) and entry["mc_far_n"] == 64
    assert {"corpus_s", "teacher_s", "synthesis_s", "qat_w4a8kv4_s"} <= set(saved["timing"])
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        table.main([os.path.join(work, "results.json")])
    assert "| W4A8KV4 |" in out.getvalue() and "fp teacher" in out.getvalue()


def test_tiny_pipeline_on_cpu_from_the_jax_teacher(tmp_path):
    tiny = _load("tiny_pipeline_torch")
    cfg_t = tiny.CONFIG
    cfg_j = JL.LlamaConfig(**{k: getattr(cfg_t, k) for k in (
        "vocab_size", "hidden_size", "intermediate_size", "num_hidden_layers",
        "num_attention_heads", "num_key_value_heads", "max_position_embeddings")})
    teacher = jax.tree.map(np.asarray, JL.init_params(cfg_j, jax.random.PRNGKey(0)))
    stages = []
    with contextlib.redirect_stdout(io.StringIO()):
        res = tiny.main(str(tmp_path / "tiny"), device="cpu", teacher_params=teacher,
                        stage_hook=stages.append)
    assert tuple(stages) == tiny.STAGES
    assert res["train"]["train_steps"] == 10 and np.isfinite(res["train"]["perplexity"])
    assert res["corpus_docs"] == 48 and len(res["served"]) == 2
    assert 0.0 <= res["zero_shot"]["acc"] <= 1.0
    # the teacher checkpoint holds JAX's weights; the student loads alike in both
    _, t_teacher = TC.load_hf_checkpoint(str(tmp_path / "tiny" / "teacher"),
                                         dtype=torch.float32, device="cpu")
    got_leaves, want_leaves = jax.tree.leaves(TP.to_numpy(t_teacher)), jax.tree.leaves(teacher)
    assert len(got_leaves) == len(want_leaves)
    for g, w in zip(got_leaves, want_leaves):
        np.testing.assert_array_equal(g, w)
    path = res["train"]["model_path"]
    jcfg, jp = JC.load_hf_checkpoint(path, dtype=jnp.float32)
    tcfg, tp = TC.load_hf_checkpoint(path, dtype=torch.float32, device="cpu")
    ids = np.random.default_rng(0).integers(0, cfg_t.vocab_size, size=(2, 32))
    for bits in (dict(w_bits=32, a_bits=32, kv_bits=32), dict(w_bits=4, a_bits=8, kv_bits=4)):
        want = np.asarray(JL.forward(jp, jcfg.replace(**bits), jnp.asarray(ids),
                                     dtype=jnp.float32))
        got = TL.forward(tp, tcfg.replace(**bits), torch.from_numpy(ids),
                         dtype=torch.float32).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


class _Stop(Exception):
    pass


def test_without_a_workdir_each_run_takes_a_fresh_temporary_directory(tmp_path, monkeypatch):
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    acc, tiny = _load("accuracy_experiment_torch"), _load("tiny_pipeline_torch")
    assert acc.parse_args([]).workdir is None
    seen = []

    def first_stage(workdir, **kw):
        seen.append(workdir)
        raise _Stop

    def stop(name):
        raise _Stop

    monkeypatch.setattr(acc, "build_corpus", first_stage)
    with contextlib.redirect_stdout(io.StringIO()):
        for _ in range(2):
            with pytest.raises(_Stop):
                acc.main(["--small", "--device", "cpu"])
            with pytest.raises(_Stop):     # stops once the teacher's checkpoint is written
                tiny.main(device="cpu", stage_hook=stop)
    assert len(set(seen)) == 2
    assert all(os.path.dirname(w) == str(tmp_path)
               and os.path.basename(w).startswith("llm_qat_accuracy_torch_") for w in seen)
    tiny_dirs = sorted(tmp_path.glob("llm_qat_tiny_pipeline_torch_*"))
    assert len(tiny_dirs) == 2 and all((d / "teacher" / "config.json").exists() for d in tiny_dirs)
