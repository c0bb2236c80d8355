"""Typed dataclass flag parsing (the JAX package's ``utils/args.py``).

Reference: utils/process_args.py, an ``HfArgumentParser`` over
ModelArguments / DataArguments / TrainingArguments with the bit-widths on
ModelArguments and the QAT/KD switches on TrainingArguments. The same three
dataclasses, flag for flag, parsed with a small argparse parser, plus a
``device`` field (``cuda`` unless ``cpu`` is asked for). The mesh fields size
the ranks' mesh (``parallel.mesh.make_mesh``): data, fsdp and tp for the
ZeRO-3 / tensor-parallel trainer, pp for GPipe, cp for the context ring.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile
from typing import Optional, Sequence, Tuple, Type


@dataclasses.dataclass
class ModelArguments:
    """process_args.py:16-42 equivalent."""

    input_model_filename: Optional[str] = None   # HF checkpoint dir
    output_model_filename: Optional[str] = None
    local_dir: str = os.path.join(tempfile.gettempdir(), "llm_qat_torch")
    # "" -> tokenizer files from input_model_filename; "byte" -> built-in
    # byte-level tokenizer (smoke runs without SentencePiece files)
    tokenizer: str = ""
    w_bits: int = 32
    a_bits: int = 32
    kv_bits: int = 32


@dataclasses.dataclass
class DataArguments:
    """process_args.py:46-66 equivalent."""

    train_data_local_path: Optional[str] = None
    eval_data_local_path: Optional[str] = None


@dataclasses.dataclass
class TrainingArguments:
    """process_args.py:70-87 + the run_train.sh:8-43 recipe knobs."""

    output_dir: str = os.path.join(tempfile.gettempdir(), "output")
    model_max_length: int = 2048
    qat: bool = False
    use_kd: bool = False
    kd_loss_scale: float = 1.0
    do_train: bool = True
    do_eval: bool = True
    num_train_epochs: int = 1
    per_device_train_batch_size: int = 1
    per_device_eval_batch_size: int = 1
    gradient_accumulation_steps: int = 1
    learning_rate: float = 2e-5
    weight_decay: float = 0.0
    lr_scheduler_type: str = "cosine"
    warmup_steps: int = 0
    max_grad_norm: float = 1.0
    gradient_checkpointing: bool = True
    save_steps: int = 2000
    save_total_limit: int = 1
    logging_dir: Optional[str] = None
    logging_steps: int = 1
    bf16: bool = True
    seed: int = 0
    max_steps: int = -1                 # -1: derive from epochs x data
    resume_from_checkpoint: bool = False  # restore latest step in output_dir
    debug_nans: bool = False            # torch.autograd.set_detect_anomaly
    # fast paths (on by default; flags to fall back to the plain paths)
    no_flash_attention: bool = False    # flash attention fwd + bwd kernels
    no_fused_qat_matmul: bool = False   # int8 fused fake-quant matmuls
    no_fused_norm_quant: bool = False   # producer-fused norm+quant / flash-
                                        # layout projections
    device: str = "cuda"                # "cpu": the kernels' plain versions
    # mesh layout (the JAX package's flags)
    mesh_data: int = 1
    mesh_fsdp: int = -1
    mesh_tp: int = 1
    mesh_pp: int = 1                    # GPipe pipeline axis (trainer "pp")
    mesh_cp: int = 1                    # ring-attention context axis ("cp")


def _add_dataclass_args(parser: argparse.ArgumentParser, cls: Type) -> None:
    for f in dataclasses.fields(cls):
        name = "--" + f.name
        default = (
            f.default
            if f.default is not dataclasses.MISSING
            else f.default_factory()  # type: ignore[misc]
        )
        if f.type in (bool, "bool") or isinstance(default, bool):
            parser.add_argument(
                name, type=lambda s: s.lower() in ("1", "true", "yes"),
                default=default,
            )
        elif isinstance(default, int):
            parser.add_argument(name, type=int, default=default)
        elif isinstance(default, float):
            parser.add_argument(name, type=float, default=default)
        else:
            parser.add_argument(name, type=str, default=default)


def process_args(
    argv: Optional[Sequence[str]] = None,
) -> Tuple[ModelArguments, DataArguments, TrainingArguments]:
    """Parse one flat CLI into the three dataclasses (process_args.py:89-103)."""
    parser = argparse.ArgumentParser("llm_qat_torch")
    for cls in (ModelArguments, DataArguments, TrainingArguments):
        _add_dataclass_args(parser, cls)
    ns = parser.parse_args(argv)

    def build(cls):
        return cls(**{f.name: getattr(ns, f.name) for f in dataclasses.fields(cls)})

    return build(ModelArguments), build(DataArguments), build(TrainingArguments)
