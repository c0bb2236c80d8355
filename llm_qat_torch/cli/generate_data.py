"""Data synthesis entry point (the JAX package's ``cli/generate_data.py``):
the reference's ``generate_data.py`` (C11) + merge (C12).

``python generate_data_torch.py <shard_id> --teacher DIR`` appends to
``gen_data/gen.chunk.NN.jsonl`` and resumes from its existing lines;
``--merge`` concatenates all chunks (merge_gen_data.py). Generation is
batched on ``cuda`` unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

import torch

from llm_qat_torch.data import synthesis as S
from llm_qat_torch.data.dataset import load_tokenizer
from llm_qat_torch.models import convert


def main(argv: Optional[Sequence[str]] = None):
    p = argparse.ArgumentParser("generate_data")
    p.add_argument("shard_id", type=int, nargs="?", default=0)
    p.add_argument("--teacher", type=str, help="fp teacher HF checkpoint dir")
    p.add_argument("--tokenizer", type=str, default="",
                   help="tokenizer dir; 'byte' for the built-in byte tokenizer")
    p.add_argument("--out_dir", type=str, default="gen_data")
    p.add_argument("--n_vocab_per_shard", type=int, default=500)
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--max_length", type=int, default=2048)
    p.add_argument("--top_k", type=int, default=50)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", type=str, default="cuda", help="'cpu': no card needed")
    p.add_argument("--merge", action="store_true", help="merge chunks and exit")
    args = p.parse_args(argv)

    if args.merge:
        out = S.merge_shards(args.out_dir)
        print(f"merged -> {out}")
        return out

    config, params = convert.load_hf_checkpoint(args.teacher, dtype=torch.bfloat16,
                                                device=args.device)
    tok, _ = load_tokenizer(args.tokenizer or args.teacher)
    path = S.synthesize_shard(
        params,
        config,
        args.shard_id,
        args.out_dir,
        detokenize=lambda ids: tok.decode(ids, skip_special_tokens=True),
        n_vocab_per_shard=args.n_vocab_per_shard,
        batch_size=args.batch_size,
        total_len=args.max_length,
        eos_id=tok.eos_token_id,
        top_k=args.top_k,
        seed=args.seed,
        log_every=100,
    )
    print(f"shard {args.shard_id} -> {path}")
    return path


if __name__ == "__main__":
    main()
