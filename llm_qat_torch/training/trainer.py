"""KD-QAT trainer (the JAX package's ``training/trainer.py``).

One train step is: frozen teacher forward under ``no_grad``, fake-quant
student forward and backward (rematerialized layer by layer), clip by global
norm, AdamW:

* loss = ``kd_loss_scale * KL(student || teacher)`` with *batchmean*
  reduction (sum over sequence and vocab divided by the batch size only) and
  no ground-truth CE term; ``kl_chunk`` fuses the lm_head into sequence chunks
  so the full fp32 ``[b, s, V]`` logits never exist;
* the teacher is a separate frozen dict of tensors, outside the optimizer
  state and outside the student's rematerialization;
* optimizer: AdamW with global grad-norm clip 1.0, cosine decay from lr 2e-5
  with no warmup. There is no optax here: the schedules, the clip, the update
  rule and the gradient accumulation are written out to give optax's numbers.

Where the JAX package returns new arrays the port updates the student's
params in place (``Trainer`` takes ownership of the ``params`` it is given);
moments are replaced leaf by leaf. Eval is label CE -> perplexity.

Over a device mesh (``parallel.mesh.make_mesh``; one process a rank):

* ``parallel="fsdp"``: ZeRO-3, with tensor parallelism where the mesh's
  'tp' is above 1. Student and teacher are split with ``param_specs`` (a
  rank holds 1/fsdp of every split leaf, and of its AdamW moments, and its
  Megatron block of the leaves split over 'tp'), each layer gathers its
  weights over 'fsdp' while it runs (``parallel.zero``) and computes its
  heads and columns (``parallel.tensor``), and the global batch's rows split
  over ('data', 'fsdp'): the ranks of a 'tp' line share their rows. Only
  this mode chunks the KL, and under 'tp' the chunk's softmax terms meet
  over the vocabulary's split.
* ``parallel="pp"``: GPipe (``parallel.pipeline``): the stacked layers and
  their moments split over 'pp', the teacher stays whole, every rank sees
  the global batch, and the loss is the unchunked one (as the JAX
  package's). The embedding's gradient is summed over 'pp'.
* ``parallel="cp"``: ring context parallelism (``models.llama_cp``): the
  sequence splits over 'cp', student and teacher stay whole on every rank,
  and the gradients are summed over the ring.

Under "fsdp" and "cp" each rank differentiates the loss of its own tokens
with the GLOBAL normalizer (the KL's batch, the MSE's element count, the
CE's token count), so the summed gradients are the global loss's; the
reported loss is the sum over those ranks (never over 'tp' or 'pp', whose
ranks compute the same loss). A leaf replicated over 'tp' (the norm gains)
has the same gradient on every 'tp' rank and is not summed over it. The
gradient norm sums each leaf's squares over every axis that splits it and
counts a replicated leaf once.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from llm_qat_torch.device import resolve_device
from llm_qat_torch.models import llama
from llm_qat_torch.models.config import LlamaConfig
from llm_qat_torch.parallel import comm
from llm_qat_torch.parallel import mesh as pmesh
from llm_qat_torch.parallel import tensor as ptensor


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Canonical QAT recipe (the reference's run_train.sh + HF Trainer
    defaults)."""

    learning_rate: float = 2e-5
    total_steps: int = 1000
    warmup_steps: int = 0
    weight_decay: float = 0.0
    adam_b1: float = 0.9
    adam_b2: float = 0.999
    adam_eps: float = 1e-8
    max_grad_norm: float = 1.0
    lr_schedule: str = "cosine"        # "cosine" | "constant" | "linear"
    kd_loss_scale: float = 1.0
    kd_loss_type: str = "kl"           # "kl" (default) | "mse"
    use_kd: bool = True
    grad_accum_steps: int = 1
    remat: bool = True                 # gradient checkpointing
    compute_dtype: Any = torch.bfloat16
    kl_chunk: int = 0                  # >0: chunk the seq dim of the KL to bound
                                       # the fp32 [b, s, V] logits memory
    num_microbatches: int = 0          # pipeline microbatches (multi-device)
    # parallel="cp": the ring's KV transport (None: as computed; 8: int8 plus
    # a per-token scale). The JAX package's trainer leaves its cp_forward at
    # the default, None.
    ring_transport_bits: Optional[int] = None
    # Kept for parity with the JAX package's configuration: there it selects
    # a single-pass clip+AdamW over the optax chain; here one implementation
    # gives both their numbers.
    fused_optimizer: bool = True


@dataclasses.dataclass
class TrainState:
    params: Any
    opt_state: Any
    step: int


# ---------------------------------------------------------------------------
# Trees (dicts of tensors, one level of nesting under "layers")
# ---------------------------------------------------------------------------


def tree_map(fn, tree, *rest):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    return fn(tree, *rest)


def tree_leaves(tree):
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in tree_leaves(v)]
    return [tree]


def global_norm(tree) -> torch.Tensor:
    """``sqrt(sum over leaves of sum(x*x))``, each leaf's sum at its type."""
    return torch.sqrt(sum(torch.sum(x * x) for x in tree_leaves(tree)))


# ---------------------------------------------------------------------------
# Losses
# ---------------------------------------------------------------------------


def _kl_sum(s_logits: torch.Tensor, t_logits: torch.Tensor, tp=None) -> torch.Tensor:
    """``sum p_T (log p_T - log p_S)`` in fp32; ``tp``: the logits are this
    rank's vocabulary columns, the softmax's terms and the sum meet over it."""
    ls = ptensor.log_softmax_over_tp(s_logits.float(), tp)
    lt = ptensor.log_softmax_over_tp(t_logits.float(), tp)
    return ptensor.reduce_from_tp(torch.sum(torch.exp(lt) * (lt - ls)), tp)


def kd_kl_loss(student_logits: torch.Tensor, teacher_logits: torch.Tensor,
               chunk: int = 0, batch: Optional[int] = None) -> torch.Tensor:
    """``F.kl_div(log_softmax(S), softmax(T), reduction="batchmean")``: sum
    over (seq, vocab) of ``p_T (log p_T - log p_S)``, divided by the *batch
    size only* (``batch``, default the logits' own). ``chunk > 0`` evaluates
    the reduction in sequence chunks."""
    b, s = student_logits.shape[:2]
    if chunk and s % chunk == 0:
        total = sum(_kl_sum(student_logits[:, i:i + chunk], teacher_logits[:, i:i + chunk])
                    for i in range(0, s, chunk))
    else:
        total = _kl_sum(student_logits, teacher_logits)
    return total / (batch or b)


def chunked_kd_kl(
    student_h: torch.Tensor,     # [b, s, H] post-final-norm hidden
    teacher_h: torch.Tensor,     # [b, s, H]
    student_head: torch.Tensor,  # [H, V]
    teacher_head: torch.Tensor,  # [H, V]
    chunk: int,
    batch: Optional[int] = None,
    tp=None,
) -> torch.Tensor:
    """``kd_kl_loss`` with the lm_head fused into the sequence chunks: each
    step projects one ``[b, chunk, H]`` slice through the head and reduces the
    KL sum in fp32; the chunk is rematerialized, so the backward recomputes
    its logits instead of saving n copies. Peak loss memory is one chunk's
    logits (student + teacher). Same numbers as ``kd_kl_loss`` (same matmul
    type, same fp32 reduction order over chunks); ``batch`` as there.
    ``tp``: the heads are this rank's ``[H, V/tp]`` and so are a chunk's
    logits; the maximum, the log-sum-exp and the KL sum meet over 'tp'
    (``parallel.tensor``), and the recomputed chunk issues them again in the
    same order on every rank."""
    b, s, _ = student_h.shape
    if not (chunk and s % chunk == 0):
        chunk = s

    def body(hs_i, ht_i, s_head, t_head):
        return _kl_sum(llama.head_logits(hs_i, s_head, tp), llama.head_logits(ht_i, t_head, tp),
                       tp)

    total = torch.zeros((), dtype=torch.float32, device=student_h.device)
    for i in range(0, s, chunk):
        total = total + llama.remat(body, student_h[:, i:i + chunk], teacher_h[:, i:i + chunk],
                                    student_head, teacher_head)
    return total / (batch or b)


# ---------------------------------------------------------------------------
# Optimizer / schedule
# ---------------------------------------------------------------------------


def make_schedule(cfg: TrainConfig) -> Callable[[int], float]:
    """Step count -> learning rate: optax's ``warmup_cosine_decay_schedule``
    (linear warm-up from 0, or none, then cosine decay to 0 over
    ``total_steps`` in all), ``constant_schedule`` and ``linear_schedule``
    (to 0 over ``total_steps - warmup_steps``)."""
    lr = cfg.learning_rate
    if cfg.lr_schedule == "cosine":
        warm, decay = cfg.warmup_steps, cfg.total_steps - cfg.warmup_steps
        if not decay > 0:
            raise ValueError(f"cosine schedule needs total_steps > warmup_steps, got {cfg}")

        def cosine(count):
            if count < warm:                    # linear from 0 to the peak
                return lr * count / warm
            t = min(count - warm, decay)
            return lr * 0.5 * (1.0 + math.cos(math.pi * t / decay))

        return cosine
    if cfg.lr_schedule == "constant":
        return lambda count: lr
    if cfg.lr_schedule == "linear":
        steps = cfg.total_steps - cfg.warmup_steps
        if steps <= 0:
            return lambda count: lr
        return lambda count: lr * (1.0 - min(max(count, 0), steps) / steps)
    raise ValueError(f"unknown schedule {cfg.lr_schedule}")


class ClipAdamW:
    """``clip_by_global_norm`` + AdamW with decoupled weight decay, bias
    correction and optax's schedule indexing (the learning rate of update n
    is ``schedule(n - 1)``). State: ``{"count": int, "mu": tree, "nu": tree}``,
    the fields of the JAX package's ``FusedClipAdamWState``; moments take the
    params' types."""

    def __init__(self, schedule, b1: float, b2: float, eps: float, weight_decay: float,
                 max_norm: float):
        self.schedule, self.b1, self.b2, self.eps = schedule, b1, b2, eps
        self.weight_decay, self.max_norm = weight_decay, max_norm
        self.norm = global_norm   # the clip's norm; a sharded trainer counts its shards

    def init(self, params):
        return {"count": 0, "mu": tree_map(torch.zeros_like, params),
                "nu": tree_map(torch.zeros_like, params)}

    def update(self, grads, state, params):
        """(updates, new state); ``params + updates`` is the step."""
        b1, b2 = self.b1, self.b2
        g_norm = self.norm(grads).float()
        # scale only when the norm exceeds the limit
        clip = torch.where(g_norm < self.max_norm, torch.ones_like(g_norm),
                           torch.full_like(g_norm, self.max_norm) / g_norm)
        count = state["count"] + 1
        lr = float(np.float32(self.schedule(state["count"])))
        bc1 = float(np.float32(1.0) - np.float32(b1) ** np.float32(count))
        bc2 = float(np.float32(1.0) - np.float32(b2) ** np.float32(count))

        def leaf(g, mu, nu, p):
            gc = g * clip.to(g.dtype)
            mu = b1 * mu + (1.0 - b1) * gc.to(mu.dtype)
            nu = b2 * nu + (1.0 - b2) * (gc * gc).to(nu.dtype)
            # divisors as tensors: ``tensor / python_scalar`` multiplies by the
            # reciprocal on the GPU
            u = ((mu / torch.full_like(clip, bc1, dtype=mu.dtype))
                 / (torch.sqrt(nu / torch.full_like(clip, bc2, dtype=nu.dtype)) + self.eps))
            if self.weight_decay:
                u = u + self.weight_decay * p.to(u.dtype)
            return (-lr * u).to(g.dtype), mu, nu

        out = tree_map(leaf, grads, state["mu"], state["nu"], params)
        pick = lambda i: tree_map(lambda _, o: o[i], grads, out)  # noqa: E731
        return pick(0), {"count": count, "mu": pick(1), "nu": pick(2)}


def fused_clip_adamw(schedule, b1: float, b2: float, eps: float, weight_decay: float,
                     max_norm: float) -> ClipAdamW:
    """The JAX package's single-pass clip + AdamW; the same numbers as its
    optax chain ``clip_by_global_norm + adamw``."""
    return ClipAdamW(schedule, b1, b2, eps, weight_decay, max_norm)


class MultiSteps:
    """Gradient accumulation as ``optax.MultiSteps``: a running mean of the
    micro-batch gradients; every ``k`` calls the inner optimizer steps on
    that mean, the other calls update nothing."""

    def __init__(self, inner, every_k: int):
        self.inner, self.k = inner, every_k

    def init(self, params):
        return {"mini_step": 0, "gradient_step": 0, "inner": self.inner.init(params),
                "acc_grads": tree_map(torch.zeros_like, params)}

    def update(self, grads, state, params):
        n = state["mini_step"]
        acc = tree_map(lambda g, a: a + (g - a) / (n + 1), grads, state["acc_grads"])
        new = dict(state, mini_step=(n + 1) % self.k, acc_grads=acc)
        if n != self.k - 1:
            return None, new
        updates, new["inner"] = self.inner.update(acc, state["inner"], params)
        new["gradient_step"] = state["gradient_step"] + 1
        new["acc_grads"] = tree_map(torch.zeros_like, acc)
        return updates, new


def make_optimizer(cfg: TrainConfig):
    tx = fused_clip_adamw(make_schedule(cfg), cfg.adam_b1, cfg.adam_b2, cfg.adam_eps,
                          cfg.weight_decay, cfg.max_grad_norm)
    if cfg.grad_accum_steps > 1:
        tx = MultiSteps(tx, cfg.grad_accum_steps)
    return tx


# ---------------------------------------------------------------------------
# Train / eval steps
# ---------------------------------------------------------------------------


def _check_parallel(mesh, parallel: str) -> None:
    if parallel not in ("fsdp", "pp", "cp"):
        raise ValueError(f"unknown parallel mode {parallel!r}")
    if mesh is not None:
        from torch.distributed.device_mesh import DeviceMesh

        if not isinstance(mesh, DeviceMesh):
            raise TypeError(f"mesh: a DeviceMesh from parallel.mesh.make_mesh, got {type(mesh)}")
    if parallel in ("pp", "cp") and (mesh is None or parallel not in pmesh.mesh_shape(mesh)):
        raise ValueError(f"parallel={parallel!r} needs a mesh with that axis")


class _Ranks:
    """What a step needs of the mesh: the specs of the student's leaves
    (``specs``, the Trainer's), the axes its tokens split over and the sums
    over them."""

    def __init__(self, mesh, parallel: str, specs):
        self.mesh, self.parallel, self.specs = mesh, parallel, specs
        self.axes = {"fsdp": ("data", "fsdp"), "cp": ("cp",), "pp": ()}[parallel]
        self.shards = math.prod(pmesh.axis_size(mesh, a) for a in self.axes)

    def sum_(self, x: torch.Tensor, axes=None) -> torch.Tensor:
        """``x`` summed over the ranks that hold other tokens (in place)."""
        for a in self.axes if axes is None else axes:
            comm.all_reduce_(x, pmesh.axis_group(self.mesh, a))
        return x

    def leaves(self, tree):
        """(name, leaf, spec) over a params-shaped tree, in its order."""
        out = []

        def walk(t, sp, name):
            if isinstance(t, dict):
                for k, v in t.items():
                    walk(v, sp[k], k)
            else:
                out.append((name, t, sp))

        walk(tree, self.specs, "")
        return out

    def grad_axes(self, name: str, spec) -> Tuple[str, ...]:
        """The axes a leaf's gradient is summed over after the backward:
        under "fsdp" a leaf not split over 'fsdp' over ('data', 'fsdp') (the
        split leaves' gathers reduce-scatter theirs; nothing is summed over
        'tp'); under "cp" every leaf over the ring; under "pp" the
        embedding, whose gradient arises on stage 0, over 'pp'."""
        if self.parallel == "fsdp":
            return () if pmesh.split_dim(spec, "fsdp") is not None else self.axes
        if self.parallel == "pp":
            return ("pp",) if name == "embed" else ()
        return self.axes

    def reduce_grads(self, grads) -> None:
        for name, g, spec in self.leaves(grads):
            self.sum_(g, self.grad_axes(name, spec))

    def norm(self, tree) -> torch.Tensor:
        """The global norm: each leaf's squares summed over the axes that
        split it (leaves grouped by those axes), every replicated leaf
        counted once."""
        groups: Dict[Tuple[str, ...], list] = {}
        for _, g, spec in self.leaves(tree):
            axes = tuple(a for a in pmesh.split_axes(spec) if pmesh.axis_size(self.mesh, a) > 1)
            groups.setdefault(axes, []).append(torch.sum(g * g).float())
        first = next(iter(groups.values()))[0]
        total = torch.zeros((), dtype=torch.float32, device=first.device)
        for axes, sqs in sorted(groups.items(), key=lambda kv: not kv[0]):
            total = total + self.sum_(sum(sqs, torch.zeros_like(total)), axes)
        return torch.sqrt(total)


def _param_specs(params, mesh, parallel: str):
    """The spec tree a mode splits the student with."""
    if parallel == "fsdp":
        return pmesh.param_specs("lm_head" not in params)
    if parallel == "pp":
        from llm_qat_torch.parallel import pipeline

        return pipeline.pipeline_param_specs("lm_head" not in params)
    return pmesh.replicated_specs(params)


def _inner(tx):
    return tx.inner if isinstance(tx, MultiSteps) else tx


def make_train_step(model_cfg: LlamaConfig, teacher_cfg: LlamaConfig,
                    train_cfg: TrainConfig, tx, mesh=None, parallel: str = "fsdp") -> Callable:
    """Build the KD-QAT step: teacher forward + student forward/backward +
    clip + AdamW update. The teacher forward runs under ``no_grad`` outside
    the student's rematerialization, so it is never recomputed.
    ``step(state, teacher_params, batch) -> (state, metrics)`` with metrics
    ``loss`` and the pre-clip ``grad_norm`` (0-dim tensors); the state's
    params are updated in place. Under a mesh the state and teacher hold
    what ``Trainer`` gives this rank and ``batch`` is this rank's part
    (``Trainer.place_batch``); the optimizer's clip then takes the mesh's
    norm."""
    _check_parallel(mesh, parallel)
    tc = train_cfg
    cp = parallel == "cp"
    ranks = None
    tp = pmesh.tp_group(mesh) if parallel == "fsdp" else None

    def student_forward(params, ids, fwd):
        if parallel == "pp":
            from llm_qat_torch.parallel import pipeline

            mb = tc.num_microbatches or pmesh.axis_size(mesh, "pp")
            return pipeline.pipeline_forward(params, model_cfg, ids, mesh, num_microbatches=mb,
                                             remat=tc.remat, dtype=tc.compute_dtype)
        if cp:
            from llm_qat_torch.models import llama_cp

            return llama_cp.cp_forward(params, model_cfg, ids, mesh, remat=tc.remat,
                                       dtype=tc.compute_dtype,
                                       ring_transport_bits=tc.ring_transport_bits)
        return llama.forward(params, model_cfg, ids, remat=tc.remat, **fwd)

    def teacher_forward(teacher_params, ids, fwd):
        if cp:
            from llm_qat_torch.models import llama_cp

            return llama_cp.cp_forward(teacher_params, teacher_cfg, ids, mesh,
                                       dtype=tc.compute_dtype,
                                       ring_transport_bits=tc.ring_transport_bits)
        return llama.forward(teacher_params, teacher_cfg, ids, **fwd)

    def step(state: TrainState, teacher_params, batch) -> Tuple[TrainState, Dict[str, Any]]:
        nonlocal ranks
        if mesh is not None and ranks is None:
            ranks = _Ranks(mesh, parallel, _param_specs(state.params, mesh, parallel))
            _inner(tx).norm = ranks.norm
        ids = batch["input_ids"]
        mask = batch.get("attention_mask")
        if parallel in ("cp", "pp") and mask is not None:
            raise ValueError(f"{parallel} training expects packed blocks (no attention_mask)")
        chunked_kl = (tc.use_kd and tc.kd_loss_type != "mse" and bool(tc.kl_chunk)
                      and parallel == "fsdp")
        fwd = dict(attention_mask=mask, dtype=tc.compute_dtype)
        if mesh is not None and parallel == "fsdp":
            fwd["mesh"] = mesh
        # the global normalizers: the batch (rows split over the ranks under
        # fsdp, columns under cp) and the element count
        n_rows = ids.shape[0] * (ranks.shards if ranks is not None and not cp else 1)

        with torch.no_grad():
            if chunked_kl:
                # head fused into the chunked loss: full logits never exist
                teacher_ref = llama.final_hidden(teacher_params, teacher_cfg, ids, **fwd)
                teacher_head = llama.head_matrix(teacher_params, teacher_cfg, fwd.get("mesh"))
            elif tc.use_kd:
                teacher_ref = teacher_forward(teacher_params, ids, fwd)
            else:
                teacher_ref = None   # label-CE training: teacher_params may be None

        def loss_fn(params):
            if chunked_kl:
                student_h = llama.final_hidden(params, model_cfg, ids, remat=tc.remat, **fwd)
                kd = chunked_kd_kl(student_h, teacher_ref,
                                   llama.head_matrix(params, model_cfg, fwd.get("mesh")),
                                   teacher_head, tc.kl_chunk, batch=n_rows, tp=tp)
                return tc.kd_loss_scale * kd
            student_logits = student_forward(params, ids, fwd)
            if not tc.use_kd:
                if ranks is None:
                    return llama.causal_lm_loss(student_logits, batch["labels"])
                # cp ranks hold their chunk's next-token targets (place_batch)
                nll, count = (llama.token_nll_sum(student_logits, batch["labels"]) if cp
                              else llama.causal_lm_loss_sum(student_logits, batch["labels"]))
                return nll / ranks.sum_(count).clamp(min=1)
            if tc.kd_loss_type == "mse":
                err = (student_logits.float() - teacher_ref.float()) ** 2
                kd = (torch.mean(err) if ranks is None
                      else torch.sum(err) / (err.numel() * ranks.shards))
            else:
                kd = kd_kl_loss(student_logits, teacher_ref, 0, batch=n_rows)
            return tc.kd_loss_scale * kd

        leaves = tree_leaves(state.params)
        for t in leaves:
            t.requires_grad_(True)
        loss = loss_fn(state.params)
        flat = torch.autograd.grad(loss, leaves, allow_unused=True)
        loss = loss.detach()
        it = iter(flat)
        grads = tree_map(lambda p: _or_zeros(next(it), p), state.params)
        if ranks is not None:
            ranks.reduce_grads(grads)
            ranks.sum_(loss)
        if tc.grad_accum_steps > 1:
            loss = loss / tc.grad_accum_steps
        with torch.no_grad():
            updates, new_opt = tx.update(grads, state.opt_state, state.params)
            if updates is not None:
                tree_map(lambda p, u: p.add_(u.to(p.dtype)), state.params, updates)
            norm = global_norm if ranks is None else ranks.norm
            metrics = {"loss": loss, "grad_norm": norm(grads)}
        return TrainState(state.params, new_opt, state.step + 1), metrics

    return step


def _or_zeros(g, p):
    return torch.zeros_like(p) if g is None else g


def make_eval_step(model_cfg: LlamaConfig, compute_dtype=torch.bfloat16, mesh=None,
                   parallel: str = "fsdp") -> Callable:
    """Eval = label CE (not the KD loss); perplexity = exp(mean loss).
    ``step(params, batch) -> (nll_sum, valid_token_count)``; ``mesh``: params
    are this rank's shards and batch its rows (the sums are this rank's; the
    vocabulary's 'tp' split is gathered whole). ``parallel="pp"``: params are
    this stage's, the batch is whole, and the forward is the pipeline's (P
    microbatches where they divide the batch, else one)."""

    def step(params, batch):
        ids = batch["input_ids"]
        with torch.no_grad():
            if parallel == "pp":
                from llm_qat_torch.parallel import pipeline

                P = pmesh.axis_size(mesh, "pp")
                logits = pipeline.pipeline_forward(
                    params, model_cfg, ids, mesh, num_microbatches=P if ids.shape[0] % P == 0
                    else 1, dtype=compute_dtype)
            else:
                logits = llama.forward(params, model_cfg, ids,
                                       attention_mask=batch.get("attention_mask"),
                                       dtype=compute_dtype, mesh=mesh)
            return llama.causal_lm_loss_sum(logits, batch["labels"])

    return step


def init_train_state(params, tx, mesh=None, specs=None) -> TrainState:
    """Optimizer state for ``params`` and step 0. Under a mesh ``params`` are
    this rank's shards (``parallel.mesh.shard_params``), and the moments,
    made like them, are split as they are; ``mesh`` and ``specs`` are taken
    for the JAX package's signature."""
    return TrainState(params, tx.init(params), 0)


class Trainer:
    """Minimal orchestration wrapper: holds state, steps batches, evaluates
    perplexity. Runs on ``cuda`` unless ``device="cpu"`` is passed; params,
    teacher and batches must lie on (batches are moved to) that device.

    ``mesh`` (``parallel.mesh.make_mesh``) and ``parallel`` ("fsdp", with
    'tp' where the mesh has it; "pp"; or "cp"): every rank builds the Trainer
    from the same full params and teacher and steps the same global batches;
    the Trainer keeps this rank's part of each (``state.params`` holds its
    shards under "fsdp" and its stage's layers under "pp")."""

    def __init__(
        self,
        model_cfg: LlamaConfig,
        train_cfg: TrainConfig,
        params: Any,
        teacher_params: Any = None,
        teacher_cfg: Optional[LlamaConfig] = None,
        mesh=None,
        parallel: str = "fsdp",
        device=None,
    ):
        _check_parallel(mesh, parallel)
        self.device = resolve_device(device)
        for name, tree in (("params", params), ("teacher_params", teacher_params or {})):
            for t in tree_leaves(tree):
                if t.device.type != self.device.type:
                    raise ValueError(f"{name} lie on {t.device}, expected {self.device}")
        self.model_cfg = model_cfg
        self.train_cfg = train_cfg
        self.mesh = mesh
        self.parallel = parallel
        if teacher_params is not None:
            # the student is routinely initialised FROM the teacher. The train
            # step updates the student in place, so a param leaf that shares
            # storage with a teacher leaf would move the teacher: copy those.
            shared = {t.untyped_storage().data_ptr() for t in tree_leaves(teacher_params)}
            params = tree_map(
                lambda x: x.clone() if x.untyped_storage().data_ptr() in shared else x, params)
        self.param_specs = None
        if mesh is not None:
            self.param_specs = _param_specs(params, mesh, parallel)
            if parallel == "fsdp":
                llama.check_tp(model_cfg, pmesh.axis_size(mesh, "tp"))
                params = pmesh.shard_params(params, mesh, self.param_specs)
                if teacher_params is not None:
                    teacher_params = pmesh.shard_params(teacher_params, mesh)
            elif parallel == "pp":
                params = pmesh.shard_params(params, mesh, self.param_specs)
        self.teacher_params = teacher_params
        self.teacher_cfg = teacher_cfg or model_cfg.replace(w_bits=32, a_bits=32, kv_bits=32)
        self.tx = make_optimizer(train_cfg)
        self.state = init_train_state(params, self.tx, mesh, self.param_specs)
        self._step = make_train_step(model_cfg, self.teacher_cfg, train_cfg, self.tx,
                                     mesh=mesh, parallel=parallel)
        self._eval = make_eval_step(model_cfg, train_cfg.compute_dtype,
                                    mesh if parallel in ("fsdp", "pp") else None,
                                    parallel if mesh is not None else "fsdp")

    def place_batch(self, batch, evaluation: bool = False):
        """A global batch on this rank's device, cut to this rank's part:
        its rows under "fsdp"; the whole batch under "pp"; under "cp"
        (training) its chunk of the sequence, ``labels`` becoming the chunk's
        next-token targets (-100 past the end), while evaluation takes the
        whole batch on every rank."""
        out = {k: torch.as_tensor(np.asarray(v) if not torch.is_tensor(v) else v)
               .to(self.device) for k, v in batch.items()}
        if self.mesh is None:
            return out
        if self.parallel == "fsdp":
            return pmesh.shard_batch(out, self.mesh)
        if evaluation or self.parallel == "pp":
            return out
        n, i = pmesh.axis_size(self.mesh, "cp"), pmesh.axis_index(self.mesh, "cp")
        s = out["input_ids"].shape[1]
        if s % n:
            raise ValueError(f"seq {s} not divisible by cp={n}")
        sl = s // n
        cut = {k: v[:, i * sl:(i + 1) * sl] for k, v in out.items() if k != "labels"}
        if "labels" in out:
            nxt = out["labels"][:, i * sl + 1:(i + 1) * sl + 1]
            pad = torch.full((nxt.shape[0], sl - nxt.shape[1]), -100, dtype=nxt.dtype,
                             device=nxt.device)
            cut["labels"] = torch.cat([nxt, pad], dim=1)
        return cut

    def train_step(self, batch) -> Dict[str, Any]:
        self.state, metrics = self._step(self.state, self.teacher_params,
                                         self.place_batch(batch))
        return metrics

    def evaluate(self, batches) -> Dict[str, float]:
        """Token-weighted mean label CE over ``batches`` and its perplexity
        (``inf``, not an exception, for a divergent model); under "fsdp" the
        sums are over every rank's rows (the ranks of a 'tp' line share
        theirs)."""
        total_nll = 0.0
        total_tokens = 0.0
        for batch in batches:
            nll_sum, count = self._eval(self.state.params, self.place_batch(batch, True))
            if self.mesh is not None and self.parallel == "fsdp":
                sums = torch.stack([nll_sum.float(), count.float()])
                for a in ("data", "fsdp"):
                    comm.all_reduce_(sums, pmesh.axis_group(self.mesh, a))
                nll_sum, count = sums[0], sums[1]
            total_nll += float(nll_sum)
            total_tokens += float(count)
        mean = total_nll / max(total_tokens, 1.0)
        with np.errstate(over="ignore"):
            ppl = float(np.exp(mean))
        return {"eval_loss": mean, "perplexity": ppl}
