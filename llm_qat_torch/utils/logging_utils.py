"""Logging / metrics (the JAX package's ``utils/logging_utils.py``).

Reference: stdlib console logger (utils/utils.py:17-36) + HF Trainer
tensorboard scalars every step (run_train.sh:28,34). Here: the same console
format, rank-0 gating for multi-process runs (the rank of
``torch.distributed`` when it is initialized, else 0), and a JSONL metrics
sink mirrored to TensorBoard by the in-repo event writer.
"""

from __future__ import annotations

import json
import logging
import os
import sys
import time
from typing import Dict, Optional

import torch.distributed as dist

_FMT = "%(asctime)s - %(name)s - %(levelname)s - %(message)s"


def process_index() -> int:
    """This process's rank: ``torch.distributed``'s when initialized, else 0."""
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def process_count() -> int:
    """The number of processes: the world size when initialized, else 1."""
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def get_logger(name: str = "llm_qat_torch", rank0_only: bool = True) -> logging.Logger:
    """Timestamped console logger (utils/utils.py:17-36); silenced on
    non-zero ranks when rank0_only."""
    logger = logging.getLogger(name)
    if not logger.handlers:
        h = logging.StreamHandler(sys.stdout)
        h.setFormatter(logging.Formatter(_FMT))
        logger.addHandler(h)
        logger.setLevel(logging.INFO)
        logger.propagate = False
    if rank0_only and process_index() != 0:
        logger.setLevel(logging.ERROR)
    return logger


class MetricsLogger:
    """Per-step scalar metrics: JSONL file + TensorBoard (default on; disable
    with ``LLM_QAT_TENSORBOARD=0``). Only rank 0 writes."""

    def __init__(self, log_dir: Optional[str] = None, use_tensorboard: Optional[bool] = None):
        self.log_dir = log_dir
        self._jsonl = None
        self._tb = None
        if use_tensorboard is None:
            use_tensorboard = os.environ.get("LLM_QAT_TENSORBOARD", "1") != "0"
        if log_dir and process_index() == 0:
            os.makedirs(log_dir, exist_ok=True)
            self._jsonl = open(os.path.join(log_dir, "metrics.jsonl"), "a")
            if use_tensorboard:
                from llm_qat_torch.utils.tb_writer import ScalarEventWriter

                self._tb = ScalarEventWriter(log_dir)

    def log(self, step: int, metrics: Dict[str, float]) -> None:
        if self._jsonl is not None:
            rec = {"step": step, "time": time.time()}
            rec.update({k: float(v) for k, v in metrics.items()})
            self._jsonl.write(json.dumps(rec) + "\n")
            self._jsonl.flush()
        if self._tb is not None:
            self._tb.add_scalars(step, {k: float(v) for k, v in metrics.items()})

    def close(self):
        if self._jsonl:
            self._jsonl.close()
        if self._tb:
            self._tb.close()
