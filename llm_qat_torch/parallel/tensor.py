"""Tensor parallelism over the mesh's 'tp' axis: the collectives GSPMD
inserts for the JAX package's 'tp' specs (``parallel/mesh.py:param_specs``),
in imperative form, as ``parallel.zero`` is for 'fsdp'.

Under those specs the JAX package computes the one-device function. A rank
here holds the Megatron split (column-parallel q/k/v/gate/up ``[in, out/tp]``,
row-parallel o/down ``[in/tp, out]``, embed ``[V/tp, H]``, lm_head
``[H, V/tp]``), computes its part and meets the others where a reduction
crosses the split:

* ``copy_to_tp``: identity forward, SUM over 'tp' backward. What GSPMD does
  at a column-parallel layer's replicated input ``P(None)`` -> ``P(.., "tp")``:
  each rank's ``dx`` is a partial over its output columns.
* ``reduce_from_tp``: SUM forward, identity backward. A row-parallel layer's
  output, which JAX's K-split ``dot_general`` sums over 'tp'.
* ``max_over_tp`` / ``min_over_tp`` / ``sum_over_tp``: a quantizer's
  statistic over a dim split over 'tp' (the absmax, the min and max, the
  scaled means' sums: JAX's ``jnp.max`` / ``jnp.min`` / ``jnp.mean`` over a
  'tp'-sharded axis), carrying no gradient, as the statistics never do.
* ``vocab_embed``: the lookup in an embedding split ``P("tp", ..)`` over the
  vocabulary: rows outside this rank's block give zeros, then the SUM.
* ``log_softmax_over_tp``: a rank's columns of the log-softmax over a
  vocabulary split over 'tp' (the max and the sum of exponentials meet over
  the group; the log-sum-exp's gradient, the softmax, sums its partials),
  for the vocabulary-parallel softmax of the KD loss.
* ``gather_from_tp``: the whole vocabulary's logits on every rank (the
  reshard to ``P()`` of a loss that needs them whole); its backward keeps
  this rank's columns.

Every function takes the 'tp' group; with ``None`` (no mesh, or tp = 1)
each is the identity or the local reduction, so one code path serves both.
Every rank of a group must make the same calls in the same order, forward
and backward (inside a rematerialized layer the backward re-runs them).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from llm_qat_torch.parallel import comm


def size(group) -> int:
    """The group's ranks (1 for None)."""
    return 1 if group is None else dist.get_world_size(group)


def rank(group) -> int:
    """This rank's index in the group (0 for None)."""
    return 0 if group is None else dist.get_rank(group)


class _CopyToTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return comm.all_reduce_(g.clone(), ctx.group), None


class _ReduceFromTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return comm.all_reduce_(x.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_tp(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` (the same on every rank); its gradient summed over the group."""
    return x if group is None else _CopyToTP.apply(x, group)


def reduce_from_tp(x: torch.Tensor, group) -> torch.Tensor:
    """The group's sum of ``x``; the gradient passes to each rank whole."""
    return x if group is None else _ReduceFromTP.apply(x, group)


def max_over_tp(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` (a statistic, detached) maximized over the group."""
    if group is None:
        return x
    return comm.all_reduce_(x.detach().clone(), group, op=dist.ReduceOp.MAX)


def min_over_tp(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` (a statistic, detached) minimized over the group."""
    if group is None:
        return x
    return comm.all_reduce_(x.detach().clone(), group, op=dist.ReduceOp.MIN)


def sum_over_tp(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` (a statistic, detached) summed over the group."""
    if group is None:
        return x
    return comm.all_reduce_(x.detach().clone(), group)


def vocab_embed(table: torch.Tensor, ids: torch.Tensor, group) -> torch.Tensor:
    """``whole_table[ids]`` from this rank's block of rows ``table`` (the
    vocabulary split in rank order): ids outside the block look up zeros,
    the group's SUM fills them. The gradient reaches only this block's rows."""
    if group is None:
        return table[ids]
    n = table.shape[0]
    local = ids - rank(group) * n
    inside = (local >= 0) & (local < n)
    rows = table[torch.where(inside, local, torch.zeros_like(local))]
    rows = rows * inside[..., None].to(rows.dtype)
    return reduce_from_tp(rows, group)


class _LseOverTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        m = comm.all_reduce_(x.detach().amax(dim=-1, keepdim=True), group,
                             op=dist.ReduceOp.MAX)
        se = comm.all_reduce_(torch.exp(x - m).sum(dim=-1, keepdim=True), group)
        lse = m + torch.log(se)
        ctx.save_for_backward(x, lse)
        ctx.group = group
        return lse

    @staticmethod
    def backward(ctx, g):
        x, lse = ctx.saved_tensors
        # each rank's cotangent of the shared log-sum-exp is a partial
        g = comm.all_reduce_(g.clone(), ctx.group)
        return g * torch.exp(x - lse), None


def log_softmax_over_tp(x: torch.Tensor, group) -> torch.Tensor:
    """This rank's columns of ``log_softmax`` over the last dim, which the
    group splits."""
    if group is None:
        return torch.log_softmax(x, dim=-1)
    return x - _LseOverTP.apply(x, group)


class _GatherFromTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group, ctx.n = group, x.shape[-1]
        return comm.all_gather(x, x.dim() - 1, group)

    @staticmethod
    def backward(ctx, g):
        i = rank(ctx.group)
        return g[..., i * ctx.n:(i + 1) * ctx.n].contiguous(), None


def gather_from_tp(x: torch.Tensor, group) -> torch.Tensor:
    """The group's ``x`` concatenated along the last dim, whole on every rank
    (each rank then computes the same function of it); the gradient keeps
    this rank's columns."""
    return x if group is None else _GatherFromTP.apply(x, group)
