"""Perplexity evaluation: ``exp(mean CE)`` over fixed blocks (the JAX
package's ``eval/perplexity.py``).

Reference: train.py:131-143 — `trainer.evaluate()` with the default label-CE
loss, then ``metrics["perplexity"] = exp(eval_loss)``, on jsonl blocks of
size <= 1024 (train.py:108-110).

The mean is that of the per-batch mean losses, as in the JAX package's
``evaluate_perplexity``; ``training.trainer.Trainer.evaluate`` weights by
tokens instead, as the JAX trainer does. The two agree when every batch has
as many valid tokens.
"""

from __future__ import annotations

from typing import Dict, Iterable

import numpy as np
import torch

from llm_qat_torch.models import llama
from llm_qat_torch.models.config import LlamaConfig


def evaluate_perplexity(
    params,
    config: LlamaConfig,
    batches: Iterable[dict],
    compute_dtype=torch.bfloat16,
) -> Dict[str, float]:
    """Mean shifted-CE over batches -> {'eval_loss', 'perplexity'}, on the
    device the params lie on."""
    dev = params["embed"].device
    losses = []
    with torch.no_grad():
        for batch in batches:
            ids = torch.as_tensor(np.asarray(batch["input_ids"], np.int64), device=dev)
            logits = llama.forward(params, config, ids, dtype=compute_dtype)
            losses.append(float(llama.causal_lm_loss(logits, ids)))
    mean = float(np.mean(losses)) if losses else float("nan")
    with np.errstate(over="ignore"):
        return {"eval_loss": mean, "perplexity": float(np.exp(mean))}
