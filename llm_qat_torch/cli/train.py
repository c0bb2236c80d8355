"""QAT training entry point (the JAX package's ``cli/train.py``): ``cuda``
unless ``--device cpu`` (or ``run(..., device="cpu")``), on one device or,
under ``torchrun --nproc_per_node N train_torch.py --mesh_fsdp N ...``, on a
mesh of N ranks (``--mesh_data`` / ``--mesh_fsdp`` / ``--mesh_tp`` for the
ZeRO-3 and tensor-parallel trainer, ``--mesh_pp`` for GPipe,
``--mesh_cp`` for the context ring; the process group comes from torchrun's
environment, ``maybe_init_distributed``). Every rank reads the same data
and walks the same global batches (``per_device_train_batch_size`` rows for
each of the data x fsdp ranks); the trainer hands each rank its part. Checkpoints hold the whole state, so a
run resumes at any world size; rank 0 writes them and the HF export.

Reference flow (train.py:42-149): build the quantized student from an HF
checkpoint with the bit-widths injected into the config; attach a frozen fp
teacher from the same checkpoint; tokenize; build block datasets; run the
KD trainer; save step checkpoints (teacher-free); export the latent fp
weights in HF format; evaluate perplexity. ``resume_from_checkpoint``
restores the newest step and replays the data order up to it.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import torch
import torch.distributed as dist

from llm_qat_torch.data import dataset as D
from llm_qat_torch.device import resolve_device
from llm_qat_torch.models import convert
from llm_qat_torch.parallel import mesh as pmesh
from llm_qat_torch.training import trainer as T
from llm_qat_torch.utils import args as A
from llm_qat_torch.utils.checkpoint import CheckpointManager
from llm_qat_torch.utils.logging_utils import MetricsLogger, get_logger, process_index
from llm_qat_torch.utils.profiling import StepTimer


def maybe_init_distributed(device=None) -> bool:
    """``init_process_group`` from torchrun's ``RANK`` / ``WORLD_SIZE`` /
    ``LOCAL_RANK`` (and its rendezvous address) when ``WORLD_SIZE > 1``: NCCL
    for ``cuda``, each rank on card ``LOCAL_RANK``; gloo for ``cpu``. A
    single-process run skips it (the reference's
    ``dist.init_process_group("nccl")``, train.py:43). True when it made the
    group."""
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world <= 1 or dist.is_initialized():
        return False
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo", init_method="env://",
                            rank=int(os.environ["RANK"]), world_size=world)
    return True


def run(
    model_args: A.ModelArguments,
    data_args: A.DataArguments,
    training_args: A.TrainingArguments,
    *,
    tokenize=None,
    detokenize=None,
    device=None,
) -> dict:
    """Train, export and evaluate as the flags say; returns
    ``train_steps``, the step timer's summary, ``model_path`` (when
    exporting), ``eval_loss`` / ``perplexity`` (when evaluating) and
    ``jsonl_reader`` (``native`` or ``python``). ``device`` overrides
    ``training_args.device``. ``detokenize`` is accepted for the JAX
    package's signature; training does not decode."""
    log = get_logger()
    log.info("model args %s", model_args)
    if training_args.mesh_pp > 1 and training_args.mesh_cp > 1:
        raise ValueError("choose one of --mesh_pp / --mesh_cp (not both)")
    dev = resolve_device(device if device is not None else training_args.device)
    anomaly = torch.is_anomaly_enabled()
    if training_args.debug_nans:
        # the sanitizer mode the reference lacks (SURVEY.md §5): fail at the
        # first backward op that produces a NaN
        torch.autograd.set_detect_anomaly(True)
    try:
        return _run(model_args, data_args, training_args, tokenize, dev, log)
    finally:
        torch.autograd.set_detect_anomaly(anomaly)


def _run(model_args, data_args, training_args, tokenize, dev, log) -> dict:
    # --- model (train.py:49-70): bit-widths injected into the config copy ---
    bits = dict(
        w_bits=model_args.w_bits if training_args.qat else 32,
        a_bits=model_args.a_bits if training_args.qat else 32,
        kv_bits=model_args.kv_bits if training_args.qat else 32,
    )
    dtype = torch.bfloat16 if training_args.bf16 else torch.float32
    config, params = convert.load_hf_checkpoint(
        model_args.input_model_filename, dtype=dtype, device=dev, **bits)
    config = config.replace(
        max_position_embeddings=max(config.max_position_embeddings,
                                    training_args.model_max_length),
        # fast paths on by default: flash attention (forward and backward
        # kernels), the int8 fused fake-quant matmul and the producer-fused
        # norm+quant / flash-layout projections
        use_flash_attention=not training_args.no_flash_attention,
        fused_qat_matmul=not training_args.no_fused_qat_matmul,
        fused_norm_quant=not training_args.no_fused_norm_quant,
    )

    teacher_params = None
    teacher_cfg = config.replace(w_bits=32, a_bits=32, kv_bits=32)
    if training_args.use_kd:
        # frozen fp teacher from the same checkpoint (train.py:72-86)
        _, teacher_params = convert.load_hf_checkpoint(
            model_args.input_model_filename, dtype=dtype, device=dev)

    # --- tokenizer + data (train.py:90-110) ---
    if tokenize is None:
        _, tokenize = D.load_tokenizer(model_args.tokenizer or model_args.input_model_filename)
    train_ds, val_ds = D.get_train_val_datasets(
        data_args.train_data_local_path,
        tokenize,
        block_size=training_args.model_max_length,
        eval_path=data_args.eval_data_local_path,
    )
    reader = D.last_reader
    log.info("train blocks %d, val blocks %d (%s jsonl reader)", len(train_ds), len(val_ds),
             reader)
    if training_args.do_train and len(train_ds) == 0:
        log.warning(
            "0 train blocks: with no --eval_data_local_path the first %d "
            "jsonl lines become validation (reference datautils.py:51-53); "
            "small corpora are swallowed entirely", D.DEFAULT_VAL_LINES,
        )

    # --- mesh + trainer: the ranks of the process group, if there is one ---
    ta = training_args
    axes = dict(data=ta.mesh_data, fsdp=ta.mesh_fsdp, tp=ta.mesh_tp, pp=ta.mesh_pp,
                cp=ta.mesh_cp)
    mesh = None
    if dist.is_initialized():
        mesh = pmesh.make_mesh(**axes, device_type=dev.type)
    elif any(n not in (1, -1) for n in axes.values()):
        raise ValueError(f"mesh {axes} on one process: launch the ranks with torchrun "
                         f"(--nproc_per_node) or parallel.launch.spawn")
    parallel = "pp" if ta.mesh_pp > 1 else "cp" if ta.mesh_cp > 1 else "fsdp"
    n_batch_shards = 1 if mesh is None else pmesh.batch_shards(mesh)[0]
    global_batch = training_args.per_device_train_batch_size * n_batch_shards
    steps_per_epoch = max(len(train_ds) // max(global_batch, 1), 1)
    total_steps = (
        training_args.max_steps
        if training_args.max_steps > 0
        else steps_per_epoch * training_args.num_train_epochs
    )
    tcfg = T.TrainConfig(
        learning_rate=training_args.learning_rate,
        total_steps=total_steps,
        warmup_steps=training_args.warmup_steps,
        weight_decay=training_args.weight_decay,
        max_grad_norm=training_args.max_grad_norm,
        lr_schedule=training_args.lr_scheduler_type,
        kd_loss_scale=training_args.kd_loss_scale,
        use_kd=training_args.use_kd and teacher_params is not None,
        grad_accum_steps=training_args.gradient_accumulation_steps,
        remat=training_args.gradient_checkpointing,
        compute_dtype=dtype,
        # chunk the fp32 KL reduction over the sequence so the [b, s, V]
        # logits never fully materialize at 2048 x 32k
        kl_chunk=256 if training_args.model_max_length >= 1024 else 0,
    )
    tr = T.Trainer(config, tcfg, params, teacher_params, teacher_cfg=teacher_cfg, mesh=mesh,
                   parallel=parallel, device=dev)
    del params, teacher_params   # the trainer keeps this rank's part

    mngr = CheckpointManager(
        os.path.join(training_args.output_dir, "checkpoints"),
        max_to_keep=training_args.save_total_limit,
        save_interval_steps=training_args.save_steps,
        mesh=mesh, specs=tr.param_specs,
    )
    metrics_log = MetricsLogger(
        training_args.logging_dir or os.path.join(training_args.output_dir, "logs"))

    # --- resume: the newest step checkpoint, then the data order replayed ---
    start_step = 0
    if training_args.resume_from_checkpoint:
        latest = mngr.latest_step()
        if latest is not None:
            tr.state = mngr.restore(tr.state)
            start_step = latest
            log.info("resumed from checkpoint step %d", latest)

    # --- train loop (train.py:126; the HF Trainer's inner loop) ---
    result = {"jsonl_reader": reader}
    if training_args.do_train:
        step = start_step
        timer = StepTimer(device=dev)
        for i, batch in enumerate(train_ds.batches(
                global_batch, shuffle=True, seed=training_args.seed,
                epochs=training_args.num_train_epochs)):
            if i < start_step:  # replay the data order up to the restore point
                continue
            if step >= total_steps:
                break
            m = tr.train_step(batch)
            timer.tick(tokens=batch["input_ids"].size)
            step += 1
            if step % training_args.logging_steps == 0:
                metrics_log.log(step, m)
            if step % 50 == 0 or step == 1:
                log.info("step %d/%d loss %.4f", step, total_steps, float(m["loss"]))
            mngr.maybe_save(step, tr.state)
        mngr.save(step, tr.state)
        mngr.wait()
        result["train_steps"] = step
        result.update(timer.summary())
        log.info("throughput %s", timer.summary())

        # final HF-format latent-fp export, teacher-free by construction
        # (utils/utils.py:39-49); the ranks gather the whole params, rank 0 writes
        if model_args.output_model_filename:
            whole = (tr.state.params if mesh is None
                     else pmesh.gather_params(tr.state.params, mesh, tr.param_specs))
            out = os.path.join(model_args.local_dir, "models", model_args.output_model_filename)
            if process_index() == 0:
                convert.save_hf_checkpoint(whole, config, out)
            del whole
            if mesh is not None:
                dist.barrier()
            result["model_path"] = out

    # --- eval -> perplexity (train.py:131-143) ---
    if training_args.do_eval and len(val_ds):
        m = tr.evaluate(list(val_ds.batches(
            training_args.per_device_eval_batch_size * n_batch_shards)))
        log.info("eval %s", m)
        result.update(m)

    metrics_log.close()
    mngr.close()
    return result


def main(argv: Optional[Sequence[str]] = None) -> dict:
    margs, dargs, targs = A.process_args(argv)
    made = maybe_init_distributed(targs.device)
    try:
        return run(margs, dargs, targs)
    finally:
        if made:
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
