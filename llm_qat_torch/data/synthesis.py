"""Data-free synthesis: sample the training corpus from the fp teacher (the
JAX package's ``data/synthesis.py``).

Reference: generate_data.py (C11) + merge_gen_data.py (C12). The paper's
hybrid strategy: for every start token id, decode the first ``j in 3..5``
tokens greedily, then continue with stochastic sampling to 2048 tokens
(generate_data.py:37-43); shards are ranges of start-token ids (64 shards x
500 ids = the first 32k of the vocab, README.md:35); a killed shard resumes
from the line count of its output file (generate_data.py:25-32).

Generation is batched over many start tokens at once and runs the cached
forward (``models.llama.forward_with_cache``) one token at a time over a
fixed-size KV cache. Sampling is HF generate's default of the reference's
era: temperature 1.0 with top-k 50. A sample is drawn the way
``jax.random.categorical`` draws it, ``argmax(logits + gumbel)``, with the
Gumbel noise from a ``torch.Generator`` (or handed in, which the tests do to
reproduce the JAX package's stream).
"""

from __future__ import annotations

import json
import os
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from llm_qat_torch.models import llama
from llm_qat_torch.models.config import LlamaConfig

GREEDY_LENGTHS = (3, 4, 5)  # generate_data.py:37 (j in 3..5 inclusive)


def gumbel(shape, generator: torch.Generator, device) -> torch.Tensor:
    """Standard Gumbel noise ``-log(-log(u))``, u uniform in [tiny, 1) (the
    JAX package's ``jax.random.gumbel`` recipe)."""
    tiny = torch.finfo(torch.float32).tiny
    u = torch.rand(shape, generator=generator, device=device)
    return -torch.log(-torch.log(u.clamp_min(tiny)))


def sample(logits_1: torch.Tensor, step: int, noise: torch.Tensor, *, greedy_len: int,
           top_k: int, temperature: float) -> torch.Tensor:
    """One token per row from ``logits_1`` ``[B, V]``: greedy while
    ``step < greedy_len``, else top-k temperature sampling by Gumbel-max
    with ``noise`` ``[B, V]``."""
    greedy = torch.argmax(logits_1, dim=-1).to(torch.int32)
    if step < greedy_len:
        return greedy
    lg = logits_1 / torch.full((), temperature, dtype=logits_1.dtype, device=logits_1.device)
    if top_k and top_k < lg.shape[-1]:
        kth = torch.topk(lg, top_k, dim=-1).values[..., -1:]
        lg = torch.where(lg < kth, torch.full_like(lg, -float("inf")), lg)
    return torch.argmax(noise.to(lg.dtype) + lg, dim=-1).to(torch.int32)


def generate_batch(
    params,
    config: LlamaConfig,
    start_tokens: torch.Tensor,  # [B] integer, on the params' device
    generator: Optional[torch.Generator] = None,
    *,
    greedy_len: int = 3,
    total_len: int = 2048,
    top_k: int = 50,
    temperature: float = 1.0,
    dtype=torch.bfloat16,
    noise: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Decode ``total_len`` tokens per row: positions < greedy_len greedy,
    then top-k temperature sampling. Returns ``[B, total_len]`` int32 ids
    (the start token at column 0). ``noise``: the Gumbel noise of steps
    ``1 .. total_len - 1``, ``[total_len - 1, B, V]``; without it each step
    draws its own from ``generator``."""
    B = start_tokens.shape[0]
    dev = params["embed"].device
    cache = llama.init_cache(config, B, total_len, dtype=dtype, device=dev)
    ids0 = start_tokens.to(device=dev, dtype=torch.int64)[:, None]
    logits, cache = llama.forward_with_cache(params, config, ids0, cache, dtype=dtype)
    toks = []
    for step in range(1, total_len):
        nz = (noise[step - 1].to(dev) if noise is not None
              else gumbel((B, logits.shape[-1]), generator, dev))
        tok = sample(logits[:, -1], step, nz, greedy_len=greedy_len, top_k=top_k,
                     temperature=temperature)
        toks.append(tok)
        logits, cache = llama.forward_with_cache(params, config, tok[:, None].long(), cache,
                                                 dtype=dtype)
    return torch.cat([ids0.to(torch.int32)] + [t[:, None] for t in toks], dim=1)


def _truncate_at_eos(row: np.ndarray, eos_id: Optional[int]) -> np.ndarray:
    if eos_id is None:
        return row
    hits = np.nonzero(row == eos_id)[0]
    return row[: hits[0]] if hits.size else row


def _count_lines(path: str) -> int:
    from llm_qat_torch.native import get_fastdata

    fd = get_fastdata()
    if fd is not None:
        return fd.count_lines(path)
    with open(path) as f:
        return sum(1 for _ in f)


def synthesize_shard(
    params,
    config: LlamaConfig,
    shard_id: int,
    out_dir: str,
    *,
    detokenize: Callable[[Sequence[int]], str],
    n_vocab_per_shard: int = 500,      # generate_data.py:22
    batch_size: int = 32,
    total_len: int = 2048,
    eos_id: Optional[int] = 2,
    top_k: int = 50,
    seed: int = 0,
    dtype=torch.bfloat16,
    log_every: int = 0,
) -> str:
    """Generate this shard's documents into ``gen.chunk.{NN}.jsonl`` on the
    params' device.

    Work list = [(j, start_id)] for j in GREEDY_LENGTHS and start ids in the
    shard's vocab range: the reference's coverage and file naming
    (generate_data.py:22-48), resumable by counting existing lines
    (generate_data.py:25-32), executed in batches of ``batch_size`` (a batch
    never mixes two ``j``). Each batch's noise comes from a generator seeded
    by ``seed`` and the count of documents already written, so a shard
    resumed at a batch's start draws what an unbroken one would have.
    """
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"gen.chunk.{shard_id:02d}.jsonl")
    start0 = shard_id * n_vocab_per_shard
    work = [(j, start0 + i) for j in GREEDY_LENGTHS for i in range(n_vocab_per_shard)]
    done = _count_lines(path) if os.path.exists(path) else 0
    work = work[done:]
    dev = params["embed"].device

    with open(path, "a") as f:
        while work:
            batch = [w for w in work[:batch_size] if w[0] == work[0][0]]
            work = work[len(batch):]
            j = batch[0][0]
            starts = torch.tensor([w[1] for w in batch], dtype=torch.int32, device=dev)
            gen = torch.Generator(device=dev)
            gen.manual_seed(seed * 1_000_003 + done)
            out = generate_batch(params, config, starts, gen, greedy_len=j, total_len=total_len,
                                 top_k=top_k, dtype=dtype).cpu().numpy()
            for row in out:
                text = detokenize(list(_truncate_at_eos(row, eos_id)))
                f.write(json.dumps({"text": text}) + "\n")
            f.flush()
            done += len(batch)
            if log_every and done % log_every < batch_size:
                print(f"shard {shard_id}: {done} docs", flush=True)
    return path


def merge_shards(gen_dir: str, out_name: str = "all_gen.jsonl") -> str:
    """Concatenate gen.chunk.*.jsonl -> all_gen.jsonl (merge_gen_data.py:14-24)."""
    out_path = os.path.join(gen_dir, out_name)
    chunks = sorted(f for f in os.listdir(gen_dir)
                    if f.startswith("gen.chunk.") and f.endswith(".jsonl"))
    with open(out_path, "w") as out:
        for c in chunks:
            with open(os.path.join(gen_dir, c)) as f:
                for line in f:
                    if line.strip():
                        out.write(line.rstrip("\n") + "\n")
    return out_path
