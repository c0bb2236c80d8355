"""Data pipeline: jsonl -> tokenize -> concat -> fixed blocks (the JAX
package's ``data/dataset.py``, numpy only; the same batch stream, bit for bit,
for the same seed).

Reference: utils/datautils.py (C7 in SURVEY.md §2). Semantics preserved:
  * input is jsonl with ``{"text": ...}`` per line (datautils.py:31-54);
  * if no eval path is given, the FIRST 10,000 lines become validation and
    the rest training (datautils.py:51-53);
  * every document is tokenized, all token streams are concatenated, and the
    stream is chopped into ``block_size`` blocks with the remainder dropped;
    ``labels = input_ids`` (datautils.py:57-114).

Blocks live in one contiguous int32 numpy array (host RAM); batches are
sliced views that the trainer moves to the card; multi-process sharding is a
strided split of the block array by rank. Tokenization stays host-side on
SentencePiece via the HF tokenizer, imported only when asked for; the byte
tokenizer needs nothing.
"""

from __future__ import annotations

import json
import os
from typing import Callable, Iterator, List, Optional, Sequence, Tuple

import numpy as np

DEFAULT_VAL_LINES = 10_000  # datautils.py:51-53


last_reader = None  # "native" or "python": which reader the last read took


def read_jsonl_texts(path: str, max_lines: Optional[int] = None) -> List[str]:
    """Read ``{"text": ...}`` lines (datautils.py:31-54). Uses the native
    C++ reader (llm_qat_torch.native) when it builds, else the Python one;
    ``last_reader`` records which."""
    global last_reader
    from llm_qat_torch.native import get_fastdata

    fd = get_fastdata()
    if fd is not None:
        try:
            texts = fd.read_jsonl_texts(path, -1 if max_lines is None else max_lines)
            last_reader = "native"
            return texts
        except ValueError:
            pass  # unusual jsonl; fall through to the strict parser
    last_reader = "python"
    texts: List[str] = []
    with open(path) as f:
        for i, line in enumerate(f):
            if max_lines is not None and i >= max_lines:
                break
            line = line.strip()
            if not line:
                continue
            texts.append(json.loads(line)["text"])
    return texts


def split_train_val(
    texts: Sequence[str], val_lines: int = DEFAULT_VAL_LINES
) -> Tuple[Sequence[str], Sequence[str]]:
    """First ``val_lines`` docs -> validation, rest -> train
    (datautils.py:51-53)."""
    return texts[val_lines:], texts[:val_lines]


def pack_blocks(
    texts: Sequence[str],
    tokenize: Callable[[str], Sequence[int]],
    block_size: int,
) -> np.ndarray:
    """Tokenize + concatenate + chop into ``[n_blocks, block_size]`` int32,
    dropping the tail remainder (datautils.py:86-114)."""
    streams = [np.asarray(tokenize(t), np.int32) for t in texts]
    if not streams:
        return np.zeros((0, block_size), np.int32)
    flat = np.concatenate(streams)
    n = len(flat) // block_size
    return flat[: n * block_size].reshape(n, block_size)


class BlockDataset:
    """Fixed-block LM dataset over a packed token array.

    ``labels = input_ids`` (datautils.py:106-113); the causal shift happens
    in the loss (models/llama.py `causal_lm_loss`), mirroring the reference
    where the model shifts internally (modeling_llama_quant.py:884-895).
    """

    def __init__(self, blocks: np.ndarray):
        assert blocks.ndim == 2
        self.blocks = blocks

    @classmethod
    def from_texts(cls, texts, tokenize, block_size: int) -> "BlockDataset":
        return cls(pack_blocks(texts, tokenize, block_size))

    @classmethod
    def from_jsonl(
        cls, path: str, tokenize, block_size: int, max_lines=None
    ) -> "BlockDataset":
        return cls.from_texts(read_jsonl_texts(path, max_lines), tokenize, block_size)

    def __len__(self) -> int:
        return len(self.blocks)

    def __getitem__(self, i) -> dict:
        ids = self.blocks[i]
        return {"input_ids": ids, "labels": ids}

    def shard(self, process_index: int, process_count: int) -> "BlockDataset":
        """Strided multi-process shard: each rank owns blocks[i::n]."""
        return BlockDataset(self.blocks[process_index::process_count])

    def batches(
        self,
        batch_size: int,
        *,
        shuffle: bool = False,
        seed: int = 0,
        drop_last: bool = True,
        epochs: int = 1,
    ) -> Iterator[dict]:
        """Yield ``{"input_ids", "labels"}`` numpy batches."""
        n = len(self.blocks)
        rng = np.random.default_rng(seed)
        for _ in range(epochs):
            order = rng.permutation(n) if shuffle else np.arange(n)
            stop = n - n % batch_size if drop_last else n
            for i in range(0, stop, batch_size):
                ids = self.blocks[order[i : i + batch_size]]
                yield {"input_ids": ids, "labels": ids}


def get_train_val_datasets(
    train_path: str,
    tokenize: Callable[[str], Sequence[int]],
    block_size: int,
    eval_path: Optional[str] = None,
    eval_block_size: Optional[int] = None,
    val_lines: int = DEFAULT_VAL_LINES,
) -> Tuple[BlockDataset, BlockDataset]:
    """`get_train_val_dataset` equivalent (datautils.py:31-54 + train.py:99-110).

    Eval block size is clamped to ``min(block_size, 1024)`` like
    train.py:108-110 unless given explicitly."""
    if eval_block_size is None:
        eval_block_size = min(block_size, 1024)
    if eval_path:
        train_texts = read_jsonl_texts(train_path)
        val_texts = read_jsonl_texts(eval_path)
    else:
        texts = read_jsonl_texts(train_path)
        train_texts, val_texts = split_train_val(texts, val_lines)
    return (
        BlockDataset.from_texts(train_texts, tokenize, block_size),
        BlockDataset.from_texts(val_texts, tokenize, eval_block_size),
    )


def load_tokenizer(path: str):
    """SentencePiece LLaMA tokenizer via HF (train.py:90-96); host-side.
    ``path == "byte"`` returns the built-in byte-level tokenizer."""
    if path == "byte":
        tok = ByteTokenizer()
        return tok, tok.encode
    from transformers import AutoTokenizer

    tok = AutoTokenizer.from_pretrained(path, use_fast=True)

    def tokenize(text: str):
        return tok(text).input_ids

    return tok, tokenize


class ByteTokenizer:
    """Trivial byte-level tokenizer for smoke tests and CI: ids = UTF-8
    bytes + 3 (reserving 0/1/2 for pad/bos/eos like SentencePiece LLaMA)."""

    vocab_size = 259
    bos_token_id = 1
    eos_token_id = 2

    def encode(self, text: str):
        return [self.bos_token_id] + [b + 3 for b in text.encode("utf-8")]

    def __call__(self, text: str):
        import types

        return types.SimpleNamespace(input_ids=self.encode(text))

    def decode(self, ids, skip_special_tokens: bool = True):
        data = bytes(i - 3 for i in ids if i >= 3)
        return data.decode("utf-8", errors="replace")
