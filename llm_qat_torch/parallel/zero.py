"""ZeRO-3 over the mesh: a rank holds 1/fsdp of every split weight and gathers
a weight whole only while the layer that reads it runs.

``gather(shard, spec, mesh)`` is the imperative form of the collectives GSPMD
inserts for the JAX package's sharded params: its forward all-gathers the
shard over 'fsdp' along the dim the spec splits; its backward reduce-scatters
the full weight's gradient over 'fsdp' back onto the shard and sums it over
'data'. Each rank differentiates the loss of its own rows, so the sums make
every rank's shard gradient the gradient of the global loss. A dim the spec
splits over 'tp' stays split: that is ``parallel.tensor``'s, and a 'tp'
rank's gradient of its block needs no sum over 'tp'. The decoder
calls it inside the function that ``models/llama.py:_Remat`` re-runs, so a
layer's full weights live only while that layer runs, forward and recompute
alike. FSDP2's ``fully_shard`` is not used: the port keeps the JAX package's
stacked ``[L, ...]`` leaves, and wrapping a module would gather all L layers
at once.
"""

from __future__ import annotations

import torch

from llm_qat_torch.parallel import comm
from llm_qat_torch.parallel import mesh as pmesh


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, shard, dim, fsdp_group, data_group):
        ctx.dim, ctx.groups = dim, (fsdp_group, data_group)
        return comm.all_gather(shard, dim, fsdp_group)

    @staticmethod
    def backward(ctx, g):
        fsdp_group, data_group = ctx.groups
        gs = comm.reduce_scatter(g, ctx.dim, fsdp_group)
        return comm.all_reduce_(gs, data_group), None, None, None


def gather(shard: torch.Tensor, spec, mesh) -> torch.Tensor:
    """The whole tensor of ``shard`` (a leaf split as ``spec`` says), with a
    gradient that reaches the shard; a replicated leaf as it is."""
    d = pmesh.split_dim(spec)
    if d is None:
        return shard
    return _Gather.apply(shard, d, pmesh.axis_group(mesh, "fsdp"), pmesh.axis_group(mesh, "data"))
