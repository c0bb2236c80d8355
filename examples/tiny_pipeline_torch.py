#!/usr/bin/env python
"""End-to-end mini pipeline on a tiny model through the PyTorch port
(``llm_qat_torch``): ``tiny_pipeline.py``'s lifecycle, step for step, on the
card by default or on the CPU with ``--device cpu``.

    1. "teacher": random-init tiny LLaMA saved as an HF checkpoint
    2. data-free synthesis: sample a corpus from the teacher (2 shards, merge)
    3. KD-QAT: distill the W4A8KV4 student from the teacher (10 steps)
    4. eval: a zero-shot task through the harness
    5. export + serve: true-int8 weights through the continuous-batching
       engine

The model (hidden 64, 4 query and 2 kv heads: head dim 16, two query heads a
kv head) runs on the card through the flash kernels at head dim 16 (train,
eval, prefill), and serves W8A8KV8 on the scan path through the int8 GEMM
at K = 64 and the decode attention kernel at (2, 16). With no card and no
``--device cpu`` it stops: it does not fall back to the CPU.

Usage: python examples/tiny_pipeline_torch.py [workdir] [--device cpu]

Without a workdir each run takes a fresh directory under the temporary
directory (``TMPDIR``).
"""

import argparse
import os
import sys
import tempfile

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from llm_qat_torch.cli import train as cli_train
from llm_qat_torch.data import synthesis as S
from llm_qat_torch.data.dataset import ByteTokenizer
from llm_qat_torch.device import resolve_device
from llm_qat_torch.eval import zero_shot as Z
from llm_qat_torch.inference import engine as E
from llm_qat_torch.inference import quantized as Q
from llm_qat_torch.models import convert
from llm_qat_torch.models import params as P
from llm_qat_torch.models.config import LlamaConfig
from llm_qat_torch.utils import args as A

TOK = ByteTokenizer()
CONFIG = LlamaConfig(
    vocab_size=TOK.vocab_size,
    hidden_size=64,
    intermediate_size=128,
    num_hidden_layers=2,
    num_attention_heads=4,
    num_key_value_heads=2,
    max_position_embeddings=128,
)
STAGES = ("teacher", "synthesis", "qat", "zero_shot", "serve")


def main(workdir=None, device=None, teacher_params=None, stage_hook=None):
    """Run the five stages in ``workdir`` (a fresh temporary directory when
    None) on ``device`` (``cuda`` unless ``"cpu"``). ``teacher_params``: the teacher as a tree of numpy arrays in
    the JAX layout (``params.from_numpy``), else ``init_params(seed=0)``.
    ``stage_hook(name)`` is called after each stage of ``STAGES``. Returns the
    train result, the zero-shot metrics and the served texts."""
    dev = resolve_device(device)
    if workdir is None:
        workdir = tempfile.mkdtemp(prefix="llm_qat_tiny_pipeline_torch_")
    os.makedirs(workdir, exist_ok=True)
    print(f"[workdir] {workdir}")
    cfg = CONFIG
    hook = stage_hook or (lambda name: None)

    # 1. teacher checkpoint
    teacher_dir = os.path.join(workdir, "teacher")
    if teacher_params is None:
        params = P.init_params(cfg, seed=0, device=dev, dtype=torch.float32)
    else:
        params = P.from_numpy(teacher_params, device=dev, dtype=torch.float32)
    convert.save_hf_checkpoint(params, cfg, teacher_dir)
    print(f"[1/5] teacher checkpoint -> {teacher_dir}")
    hook("teacher")

    # 2. data-free synthesis (2 shards, then merge)
    gen_dir = os.path.join(workdir, "gen_data")
    for shard in range(2):
        S.synthesize_shard(
            params, cfg, shard, gen_dir,
            detokenize=TOK.decode,
            n_vocab_per_shard=8, batch_size=8, total_len=48,
            eos_id=None, dtype=torch.float32,
        )
    corpus = S.merge_shards(gen_dir)
    with open(corpus) as f:
        n_docs = sum(1 for _ in f)
    print(f"[2/5] synthesized {n_docs} docs -> {corpus}")
    hook("synthesis")

    # 3. KD-QAT at W4A8KV4
    out_dir = os.path.join(workdir, "qat")
    result = cli_train.run(
        A.ModelArguments(
            input_model_filename=teacher_dir,
            output_model_filename="tiny-w4a8kv4",
            local_dir=workdir,
            tokenizer="byte",
            w_bits=4, a_bits=8, kv_bits=4,
        ),
        A.DataArguments(
            train_data_local_path=corpus, eval_data_local_path=corpus
        ),
        A.TrainingArguments(
            output_dir=out_dir, model_max_length=32, qat=True, use_kd=True,
            max_steps=10, save_steps=5, learning_rate=1e-3, bf16=False,
            gradient_checkpointing=False, per_device_train_batch_size=2,
            mesh_fsdp=-1, device=dev.type,
        ),
        tokenize=TOK.encode,
        device=dev,
    )
    print(
        f"[3/5] QAT: {result['train_steps']} steps, "
        f"eval ppl {result['perplexity']:.1f} -> {result['model_path']}"
    )
    hook("qat")

    # 4. zero-shot through the harness (toy task)
    qcfg, qat_params = convert.load_hf_checkpoint(
        result["model_path"], dtype=torch.float32, device=dev,
        w_bits=4, a_bits=8, kv_bits=4,
    )
    docs = [
        {"goal": "say hello", "sol1": "hello", "sol2": "xq!z", "label": 0},
        {"goal": "count", "sol1": "one two", "sol2": "zz@@", "label": 0},
    ]
    m = Z.evaluate_task(
        qat_params, qcfg, "piqa", docs, TOK.encode, compute_dtype=torch.float32
    )
    print(f"[4/5] zero-shot piqa (toy): acc={m['acc']:.2f} acc_norm={m['acc_norm']:.2f}")
    hook("zero_shot")

    # 5. int8 export + continuous-batching serving
    serve_cfg = qcfg.replace(w_bits=8, a_bits=8, kv_bits=8)
    qparams = Q.quantize_params(qat_params, serve_cfg, device=dev)
    eng = E.InferenceEngine(
        qparams, serve_cfg, max_batch=2, max_len=96, dtype=torch.float32, device=dev
    )
    for prompt in ["hello ", "the quick "]:
        eng.submit(TOK.encode(prompt), max_new_tokens=12, temperature=0.8)
    done = eng.run()
    served = []
    for r in done:
        served.append(TOK.decode(r.output))
        print(f"[5/5] served: {served[-1]!r}")
    hook("serve")
    print("pipeline complete")
    return dict(train=result, zero_shot=m, served=served, corpus_docs=n_docs,
                device=str(dev))


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("workdir", nargs="?", default=None,
                    help="default: a fresh temporary directory")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    a = ap.parse_args()
    main(a.workdir, device=a.device)
