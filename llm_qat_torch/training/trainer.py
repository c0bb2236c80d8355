"""KD-QAT trainer (the JAX package's ``training/trainer.py``, single device).

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


def _kl_sum(s_logits: torch.Tensor, t_logits: torch.Tensor) -> torch.Tensor:
    ls = torch.log_softmax(s_logits.float(), dim=-1)
    lt = torch.log_softmax(t_logits.float(), dim=-1)
    return torch.sum(torch.exp(lt) * (lt - ls))


def kd_kl_loss(student_logits: torch.Tensor, teacher_logits: torch.Tensor,
               chunk: int = 0) -> torch.Tensor:
    """``F.kl_div(log_softmax(S), softmax(T), reduction="batchmean")``: sum
    over (seq, vocab) of ``p_T (log p_T - log p_S)``, divided by the *batch
    size only*. ``chunk > 0`` evaluates the reduction in sequence chunks."""
    b, s = student_logits.shape[:2]
    if chunk and s % chunk == 0:
        total = sum(_kl_sum(student_logits[:, i:i + chunk], teacher_logits[:, i:i + chunk])
                    for i in range(0, s, chunk))
    else:
        total = _kl_sum(student_logits, teacher_logits)
    return total / b


def chunked_kd_kl(
    student_h: torch.Tensor,     # [b, s, H] post-final-norm hidden
    teacher_h: torch.Tensor,     # [b, s, H]
    student_head: torch.Tensor,  # [H, V]
    teacher_head: torch.Tensor,  # [H, V]
    chunk: int,
) -> torch.Tensor:
    """``kd_kl_loss`` with the lm_head fused into the sequence chunks: each
    step projects one ``[b, chunk, H]`` slice through the head and reduces the
    KL sum in fp32; the chunk is rematerialized, so the backward recomputes
    its logits instead of saving n copies. Peak loss memory is one chunk's
    logits (student + teacher). Same numbers as ``kd_kl_loss`` (same matmul
    type, same fp32 reduction order over chunks)."""
    b, s, _ = student_h.shape
    if not (chunk and s % chunk == 0):
        chunk = s

    def body(hs_i, ht_i, s_head, t_head):
        return _kl_sum(llama.head_logits(hs_i, s_head), llama.head_logits(ht_i, t_head))

    total = torch.zeros((), dtype=torch.float32, device=student_h.device)
    for i in range(0, s, chunk):
        total = total + llama.remat(body, student_h[:, i:i + chunk], teacher_h[:, i:i + chunk],
                                    student_head, teacher_head)
    return total / b


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

    def init(self, params):
        return {"count": 0, "mu": tree_map(torch.zeros_like, params),
                "nu": tree_map(torch.zeros_like, params)}

    def update(self, grads, state, params):
        """(updates, new state); ``params + updates`` is the step."""
        b1, b2 = self.b1, self.b2
        g_norm = global_norm(grads).float()
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


def _single_device(mesh, parallel: str) -> None:
    if parallel not in ("fsdp", "pp", "cp"):
        raise ValueError(f"unknown parallel mode {parallel!r}")
    if mesh is not None or parallel != "fsdp":
        raise NotImplementedError(
            "llm_qat_torch trains on a single device so far: mesh= and "
            "parallel='pp'/'cp' belong to the multi-device slice")


def make_train_step(model_cfg: LlamaConfig, teacher_cfg: LlamaConfig,
                    train_cfg: TrainConfig, tx, mesh=None, parallel: str = "fsdp") -> Callable:
    """Build the KD-QAT step: teacher forward + student forward/backward +
    clip + AdamW update. The teacher forward runs under ``no_grad`` outside
    the student's rematerialization, so it is never recomputed.
    ``step(state, teacher_params, batch) -> (state, metrics)`` with metrics
    ``loss`` and the pre-clip ``grad_norm`` (0-dim tensors); the state's
    params are updated in place."""
    _single_device(mesh, parallel)
    tc = train_cfg

    def step(state: TrainState, teacher_params, batch) -> Tuple[TrainState, Dict[str, Any]]:
        ids = batch["input_ids"]
        mask = batch.get("attention_mask")
        chunked_kl = tc.use_kd and tc.kd_loss_type != "mse" and bool(tc.kl_chunk)
        fwd = dict(attention_mask=mask, dtype=tc.compute_dtype)

        with torch.no_grad():
            if chunked_kl:
                # head fused into the chunked loss: full logits never exist
                teacher_ref = llama.final_hidden(teacher_params, teacher_cfg, ids, **fwd)
                teacher_head = llama.head_matrix(teacher_params, teacher_cfg)
            elif tc.use_kd:
                teacher_ref = llama.forward(teacher_params, teacher_cfg, ids, **fwd)
            else:
                teacher_ref = None   # label-CE training: teacher_params may be None

        def loss_fn(params):
            if chunked_kl:
                student_h = llama.final_hidden(params, model_cfg, ids, remat=tc.remat, **fwd)
                kd = chunked_kd_kl(student_h, teacher_ref, llama.head_matrix(params, model_cfg),
                                   teacher_head, tc.kl_chunk)
                return tc.kd_loss_scale * kd
            student_logits = llama.forward(params, model_cfg, ids, remat=tc.remat, **fwd)
            if not tc.use_kd:
                return llama.causal_lm_loss(student_logits, batch["labels"])
            if tc.kd_loss_type == "mse":
                kd = torch.mean((student_logits.float() - teacher_ref.float()) ** 2)
            else:
                kd = kd_kl_loss(student_logits, teacher_ref, 0)
            return tc.kd_loss_scale * kd

        leaves = tree_leaves(state.params)
        for t in leaves:
            t.requires_grad_(True)
        loss = loss_fn(state.params)
        flat = torch.autograd.grad(loss, leaves, allow_unused=True)
        loss = loss.detach()
        it = iter(flat)
        grads = tree_map(lambda p: _or_zeros(next(it), p), state.params)
        if tc.grad_accum_steps > 1:
            loss = loss / tc.grad_accum_steps
        with torch.no_grad():
            updates, new_opt = tx.update(grads, state.opt_state, state.params)
            if updates is not None:
                tree_map(lambda p, u: p.add_(u.to(p.dtype)), state.params, updates)
            metrics = {"loss": loss, "grad_norm": global_norm(grads)}
        return TrainState(state.params, new_opt, state.step + 1), metrics

    return step


def _or_zeros(g, p):
    return torch.zeros_like(p) if g is None else g


def make_eval_step(model_cfg: LlamaConfig, compute_dtype=torch.bfloat16) -> Callable:
    """Eval = label CE (not the KD loss); perplexity = exp(mean loss).
    ``step(params, batch) -> (nll_sum, valid_token_count)``."""

    def step(params, batch):
        with torch.no_grad():
            logits = llama.forward(params, model_cfg, batch["input_ids"],
                                   attention_mask=batch.get("attention_mask"),
                                   dtype=compute_dtype)
            return llama.causal_lm_loss_sum(logits, batch["labels"])

    return step


def init_train_state(params, tx, mesh=None, specs=None) -> TrainState:
    """Optimizer state for ``params`` and step 0."""
    if mesh is not None or specs is not None:
        raise NotImplementedError("init_train_state: sharded state belongs to the "
                                  "multi-device slice")
    return TrainState(params, tx.init(params), 0)


class Trainer:
    """Minimal orchestration wrapper: holds state, steps batches, evaluates
    perplexity. Runs on ``cuda`` unless ``device="cpu"`` is passed; params,
    teacher and batches must lie on (batches are moved to) that device."""

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
        _single_device(mesh, parallel)
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
        self.teacher_params = teacher_params
        self.teacher_cfg = teacher_cfg or model_cfg.replace(w_bits=32, a_bits=32, kv_bits=32)
        self.tx = make_optimizer(train_cfg)
        self.state = init_train_state(params, self.tx)
        self._step = make_train_step(model_cfg, self.teacher_cfg, train_cfg, self.tx)
        self._eval = make_eval_step(model_cfg, train_cfg.compute_dtype)

    def _place_batch(self, batch):
        return {k: torch.as_tensor(np.asarray(v) if not torch.is_tensor(v) else v)
                .to(self.device) for k, v in batch.items()}

    def train_step(self, batch) -> Dict[str, Any]:
        self.state, metrics = self._step(self.state, self.teacher_params,
                                         self._place_batch(batch))
        return metrics

    def evaluate(self, batches) -> Dict[str, float]:
        """Token-weighted mean label CE over ``batches`` and its perplexity
        (``inf``, not an exception, for a divergent model)."""
        total_nll = 0.0
        total_tokens = 0.0
        for batch in batches:
            nll_sum, count = self._eval(self.state.params, self._place_batch(batch))
            total_nll += float(nll_sum)
            total_tokens += float(count)
        mean = total_nll / max(total_tokens, 1.0)
        with np.errstate(over="ignore"):
            ppl = float(np.exp(mean))
        return {"eval_loss": mean, "perplexity": ppl}
