"""Zero-shot / perplexity evaluation entry point (the JAX package's
``cli/eval.py``) on one device: ``cuda`` unless ``--device cpu``.

The reference has no eval harness in-repo (its README table came from an
external lm-eval run, SURVEY.md §3.5); this CLI makes the 8-task zero-shot
evaluation a first-class surface:

    python eval_torch.py --model <ckpt> --w_bits 4 --a_bits 8 --kv_bits 4 \\
        --tasks boolq,piqa --task_dir tasks/ [--limit 200] [--device cpu]

``task_dir`` holds one ``{task}.jsonl`` per task with the standard fields
(see eval/zero_shot.py adapters). ``--perplexity_data`` evaluates block
perplexity on a jsonl corpus as well.
"""

from __future__ import annotations

import argparse
import json
from typing import Optional, Sequence

import torch

from llm_qat_torch.data.dataset import BlockDataset, load_tokenizer, read_jsonl_texts
from llm_qat_torch.device import resolve_device
from llm_qat_torch.eval import zero_shot as Z
from llm_qat_torch.eval.perplexity import evaluate_perplexity
from llm_qat_torch.models import convert


def main(argv: Optional[Sequence[str]] = None) -> dict:
    p = argparse.ArgumentParser("eval")
    p.add_argument("--model", required=True, help="HF checkpoint dir")
    p.add_argument("--tokenizer", default="", help="'byte' or tokenizer dir")
    p.add_argument("--w_bits", type=int, default=32)
    p.add_argument("--a_bits", type=int, default=32)
    p.add_argument("--kv_bits", type=int, default=32)
    p.add_argument("--tasks", default="", help="comma list of task names")
    p.add_argument("--task_dir", default="tasks")
    p.add_argument("--limit", type=int, default=0, help="docs per task (0=all)")
    p.add_argument("--batch_rows", type=int, default=16)
    p.add_argument("--max_len", type=int, default=0)
    p.add_argument("--perplexity_data", default="")
    p.add_argument("--block_size", type=int, default=1024)
    p.add_argument("--bf16", default="true")
    p.add_argument("--output_json", default="")
    p.add_argument("--device", default="cuda", help="'cuda' or 'cpu'")
    args = p.parse_args(argv)

    dev = resolve_device(args.device)
    dtype = torch.bfloat16 if args.bf16.lower() in ("1", "true") else torch.float32
    config, params = convert.load_hf_checkpoint(
        args.model, dtype=dtype, device=dev,
        w_bits=args.w_bits, a_bits=args.a_bits, kv_bits=args.kv_bits,
    )
    _, tokenize = load_tokenizer(args.tokenizer or args.model)

    results: dict = {}
    if args.perplexity_data:
        texts = read_jsonl_texts(args.perplexity_data)
        ds = BlockDataset.from_texts(texts, tokenize, args.block_size)
        results["perplexity"] = evaluate_perplexity(
            params, config, ds.batches(1), compute_dtype=dtype
        )

    accs = []
    for task in [t for t in args.tasks.split(",") if t]:
        with open(f"{args.task_dir}/{task}.jsonl") as f:
            docs = [json.loads(l) for l in f if l.strip()]
        if args.limit:
            docs = docs[: args.limit]
        m = Z.evaluate_task(
            params, config, task, docs, tokenize,
            batch_rows=args.batch_rows,
            max_len=args.max_len or None,
            compute_dtype=dtype,
        )
        results[task] = m
        accs.append(m["acc_norm"])
        print(f"{task}: acc={m['acc']:.4f} acc_norm={m['acc_norm']:.4f} n={m['n']}")

    if accs:
        results["average_acc_norm"] = sum(accs) / len(accs)
        print(f"average acc_norm: {results['average_acc_norm']:.4f}")
    if args.output_json:
        with open(args.output_json, "w") as f:
            json.dump(results, f, indent=2)
    return results


if __name__ == "__main__":
    main()
