"""GPipe pipeline parallelism over the mesh's 'pp' axis (the JAX package's
``parallel/pipeline.py``).

* The stacked layer axis ``[L, ...]`` splits over 'pp': stage ``p`` holds
  layers ``[p L/P, (p+1) L/P)`` with no change of layout; embed, final norm
  and lm_head are replicated (``pipeline_param_specs``).
* The schedule is JAX's: ``M + P - 1`` ticks; on each every stage applies
  its layers to its current activation. Stage 0 reads microbatch ``t``
  (clamped, so bubble ticks re-read the last), the last stage keeps
  microbatch ``t - (P - 1)``, and the activation moves one stage on with
  ``comm.shift`` (JAX's ``ppermute`` ring). Bubble ticks compute on what the
  stage holds and their results are never kept. Then the last stage's
  output goes to every stage (JAX's ``psum`` of the last stage's buffer).
* The backward crosses processes, which autograd does not: the shift is a
  ``torch.autograd.Function`` whose backward shifts the cotangent one stage
  back. Every rank issues the same shifts in the same order, forward and
  backward, so every tick stays in every rank's graph, bubbles too: stage 0
  keeps what it receives in its graph (a ``where`` that takes the
  embedding), and the step that replicates the last stage's output also
  takes each rank's last activation, whose cotangent it returns as zeros.
  That step passes the last stage's cotangent through once (each rank's is
  the same); a SUM there would count it P times.
* The embedding's gradient arises on stage 0 only and is summed over 'pp'
  by the trainer; the lm_head's and the final norm's are the same on every
  rank. With tied embeddings the head reads the embedding detached on the
  other stages, so that sum counts the head's part once.
* Each layer of a stage's sweep is rematerialized with ``llama._Remat``
  (JAX's ``jax.checkpoint`` per layer), keeping its attention output as the
  backbone does.
"""

from __future__ import annotations

from typing import Any, Dict

import torch
import torch.distributed as dist

from llm_qat_torch.models import llama
from llm_qat_torch.models.config import LlamaConfig
from llm_qat_torch.parallel import comm
from llm_qat_torch.parallel import mesh as pmesh

Params = Dict[str, Any]


def pipeline_param_specs(tie_word_embeddings: bool = False) -> Params:
    """Spec tree: the stacked layer weights split their layer dim over 'pp';
    everything else is replicated."""
    specs = {
        "embed": (None, None),
        "layers": {k: ("pp",) + (None,) * (len(spec) - 1)
                   for k, spec in pmesh.param_specs()["layers"].items()},
        "final_norm": (None,),
    }
    if not tie_word_embeddings:
        specs["lm_head"] = (None, None)
    return specs


def shard_params_pp(params: Params, mesh) -> Params:
    """This stage's layers and the replicated leaves of a full param tree."""
    return pmesh.shard_params(params, mesh, pipeline_param_specs("lm_head" not in params))


class _Shift(torch.autograd.Function):
    """The activation one stage on along the 'pp' ring; the cotangent one
    stage back."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return comm.shift([x], group, 1)[0]

    @staticmethod
    def backward(ctx, g):
        return comm.shift([g.contiguous()], ctx.group, -1)[0], None


class _FromLast(torch.autograd.Function):
    """The last stage's ``bank`` on every stage. ``tail``, each rank's last
    activation, keeps the rank's ticks in its graph: its cotangent is zero."""

    @staticmethod
    def forward(ctx, bank, tail, group, last):
        ctx.mine = dist.get_rank(group) == last
        return comm.broadcast_(bank.detach().clone(), last, group)

    @staticmethod
    def backward(ctx, g):
        return (g if ctx.mine else None), torch.zeros_like(g[0]), None, None


def _stage_sweep(layers_local, n_local, h, config, mask, cos, sin, use_flash, remat):
    """This stage's layers over ``h``, each rematerialized when ``remat``
    (and grad is on), keeping its attention output (``backbone``'s
    ``save_attn``)."""
    rematerialize = remat and torch.is_grad_enabled()
    for l in range(n_local):
        leaves = [layers_local[k][l] for k in llama._LAYER_KEYS]
        saved = None
        if rematerialize and use_flash:
            from llm_qat_torch.ops.flash_attention import AttnSaved

            saved = AttnSaved()

        def body(h, *leaves, saved=saved):
            out, _ = llama.decoder_layer(h, dict(zip(llama._LAYER_KEYS, leaves)), config, mask,
                                         cos, sin, use_flash=use_flash, attn_saved=saved)
            return out.to(h.dtype)

        h = llama._Remat.apply(body, h, *leaves) if rematerialize else body(h, *leaves)
    return h


def pipeline_backbone(params: Params, config: LlamaConfig, input_ids: torch.Tensor, mesh, *,
                      num_microbatches: int, remat: bool = False, dtype=None) -> torch.Tensor:
    """Pipelined decoder sweep -> final hidden states ``[b, s, H]``, the same
    on every stage (as ``models.llama.backbone``'s). ``params``: this stage's
    (``shard_params_pp``). Needs ``L % P == 0`` and ``b % num_microbatches
    == 0``."""
    c = config
    P = pmesh.axis_size(mesh, "pp")
    M = num_microbatches
    b, s = input_ids.shape
    if b % M:
        raise ValueError(f"batch {b} not divisible by microbatches {M}")
    if c.num_hidden_layers % P:
        raise ValueError(f"layers {c.num_hidden_layers} not divisible by pp={P}")
    n_local = c.num_hidden_layers // P
    if params["layers"]["q"].shape[0] != n_local:
        raise ValueError(f"the stage holds {params['layers']['q'].shape[0]} layers, expected "
                         f"{n_local}: pass shard_params_pp's params")
    group = pmesh.axis_group(mesh, "pp")
    p = pmesh.axis_index(mesh, "pp")
    mbs = b // M
    use_flash = c.use_flash_attention and s % min(128, s) == 0 and s >= 16
    embed = params["embed"]
    dev = embed.device
    positions = torch.arange(s, dtype=torch.int32, device=dev).expand(mbs, s)
    cos, sin = llama.rope_cos_sin(positions, c.head_dim, c.rope_theta)
    mask = (torch.zeros((mbs, 1, 1, 1), dtype=torch.float32, device=dev) if use_flash
            else llama.causal_mask(mbs, s, None, dtype=torch.float32, device=dev))
    layers_local = {k: params["layers"][k].unbind(0) for k in llama._LAYER_KEYS}
    mb_ids = input_ids.reshape(M, mbs, s)
    act = dtype if dtype is not None else embed.dtype
    h_cur = torch.zeros((mbs, s, c.hidden_size), dtype=act, device=dev)
    take_embed = torch.ones((), dtype=torch.bool, device=dev)
    bank, ticks = [], M + P - 1
    for t in range(ticks):
        if p == 0:
            # a bubble tick re-reads the last microbatch; what the ring brings
            # stays in the graph with a zero cotangent
            x0 = embed[mb_ids[min(t, M - 1)]].to(act)
            h_in = x0 if t == 0 else torch.where(take_embed, x0, h_cur)
        else:
            h_in = h_cur
        h_out = _stage_sweep(layers_local, n_local, h_in, c, mask, cos, sin, use_flash, remat)
        if p == P - 1 and t >= P - 1:
            bank.append(h_out)
        if t < ticks - 1:
            h_cur = _Shift.apply(h_out, group)
    bank = (torch.stack(bank) if p == P - 1
            else torch.zeros((M, mbs, s, c.hidden_size), dtype=act, device=dev))
    out = _FromLast.apply(bank, h_out, group, P - 1)
    return out.reshape(b, s, c.hidden_size)


def pipeline_forward(params: Params, config: LlamaConfig, input_ids: torch.Tensor, mesh, *,
                     num_microbatches: int, remat: bool = False, dtype=None) -> torch.Tensor:
    """Pipelined causal-LM forward -> fp32 logits ``[b, s, vocab]`` on every
    stage (``models.llama.forward``'s numbers: the same layers in the same
    order)."""
    h = pipeline_backbone(params, config, input_ids, mesh, num_microbatches=num_microbatches,
                          remat=remat, dtype=dtype)
    if config.tie_word_embeddings and pmesh.axis_index(mesh, "pp") != 0:
        params = dict(params, embed=params["embed"].detach())
    return llama._logits(params, config, h)


def pipeline_lm_loss(params: Params, config: LlamaConfig, batch: Dict[str, torch.Tensor], mesh,
                     *, num_microbatches: int, remat: bool = False, dtype=None) -> torch.Tensor:
    """Shifted next-token CE through the pipeline; its gradient (with the
    embedding's summed over 'pp') is the one-device gradient."""
    logits = pipeline_forward(params, config, batch["input_ids"], mesh,
                              num_microbatches=num_microbatches, remat=remat, dtype=dtype)
    return llama.causal_lm_loss(logits, batch["labels"])
