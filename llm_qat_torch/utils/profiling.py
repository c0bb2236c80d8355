"""Tracing / profiling (the JAX package's ``utils/profiling.py``).

* ``trace(log_dir)``: context manager around ``torch.profiler`` capturing the
  host and (on the card) device activity, written as a Chrome trace;
* ``StepTimer``: wall-clock per-step stats with tokens/s; on the card each
  tick first waits for the device, so a step's time is its work's;
* ``annotate(name)``: a ``record_function`` label for a step phase;
* ``chip_peak_flops``: the card's published dense peak, for MFU accounting.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Optional

import torch

from llm_qat_torch.utils.logging_utils import process_count

# Published dense (no sparsity) peaks of NVIDIA's H100 datasheet, FLOP/s for
# bf16 on the tensor cores and OP/s for int8, keyed by substrings of
# ``torch.cuda.get_device_name``; checked in order (the SXM card's name is
# "NVIDIA H100 80GB HBM3").
_PEAK_FLOPS = (
    ("H100 NVL", (835e12, 1670e12)),
    ("H100 PCIe", (756e12, 1513e12)),
    ("H100", (989e12, 1979e12)),
)


def chip_peak_flops(int8: bool = False) -> Optional[float]:
    """Peak FLOP/s of the attached card (bf16, or int8 OP/s), or None for a
    card not in the table or no card."""
    if not torch.cuda.is_available():
        return None
    name = torch.cuda.get_device_name(0)
    for key, (bf16, i8) in _PEAK_FLOPS:
        if key in name:
            return i8 if int8 else bf16
    return None


def model_flops_per_token(cfg, seq_len: int, training: bool = False) -> float:
    """Model FLOPs per processed token for one forward pass (x3 when
    ``training`` for fwd+bwd), standard 2*N-params matmul accounting plus the
    2*2*s*H attention-score term. ``cfg`` is an ``LlamaConfig``."""
    h, layers = cfg.hidden_size, cfg.num_hidden_layers
    kv_dim = cfg.kv_heads * cfg.head_dim
    per_layer_params = (
        h * h + 2 * h * kv_dim + h * h          # q, k, v, o projections
        + 3 * h * cfg.intermediate_size         # gate, up, down
    )
    matmul = 2 * (layers * per_layer_params + h * cfg.vocab_size)
    attn = layers * 4 * seq_len * h
    fwd = matmul + attn
    return fwd * (3 if training else 1)


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a ``torch.profiler`` trace (CPU, and CUDA when present) into
    ``log_dir/trace.json``; yields the profiler."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def annotate(name: str):
    """Label a region in the profiler timeline."""
    return torch.profiler.record_function(name)


class StepTimer:
    """Rolling per-step timing: call ``tick(tokens)`` once per step. With
    ``device`` a CUDA device, each tick waits for that device first."""

    def __init__(self, warmup_steps: int = 2, device=None):
        self.warmup = warmup_steps
        self.device = torch.device(device) if device is not None else None
        self.reset()

    def reset(self):
        self._count = 0
        self._tokens = 0
        self._elapsed = 0.0
        self._last: Optional[float] = None

    def tick(self, tokens: int = 0) -> None:
        if self.device is not None and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        now = time.perf_counter()
        if self._last is not None:
            self._count += 1
            if self._count > self.warmup:
                self._elapsed += now - self._last
                self._tokens += tokens
        self._last = now

    @property
    def steps_timed(self) -> int:
        return max(self._count - self.warmup, 0)

    def summary(self) -> Dict[str, float]:
        n = self.steps_timed
        if n == 0 or self._elapsed == 0:
            return {"step_time_s": float("nan"), "tokens_per_s": 0.0}
        per_chip = process_count()
        return {
            "step_time_s": self._elapsed / n,
            "tokens_per_s": self._tokens / self._elapsed,
            "tokens_per_s_per_chip": self._tokens / self._elapsed / per_chip,
        }
