"""The collectives the port's parallel paths issue, over one process group.

With NCCL the tensors stay on the card. gloo has no CUDA collectives or
point-to-point transfers, so over a gloo group a CUDA tensor goes through
host memory (copied out, exchanged, copied back): the transport a caller
names by the backend it gives the process group, not a fallback. Every rank
of a group must issue the same calls in the same order.
"""

from __future__ import annotations

import warnings
from typing import List, Sequence

import torch
import torch.distributed as dist

# torch >= 2.12 renames the *_tensor collectives; the card's torch has only these names
warnings.filterwarnings("ignore", message=r".*(all_gather_into_tensor|reduce_scatter_tensor)",
                        category=FutureWarning)


def _staged(x: torch.Tensor, group) -> bool:
    return x.is_cuda and dist.get_backend(group) == "gloo"


def all_gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The group's tensors concatenated along ``dim`` in rank order
    (contiguous)."""
    n = dist.get_world_size(group)
    xs = x.movedim(dim, 0).contiguous()
    src = xs.cpu() if _staged(x, group) else xs
    out = torch.empty((n * xs.shape[0], *xs.shape[1:]), dtype=src.dtype, device=src.device)
    dist.all_gather_into_tensor(out, src, group=group)
    return out.to(x.device).movedim(0, dim).contiguous()


def reduce_scatter(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """This rank's slice along ``dim`` of the group's sum of ``x``."""
    n = dist.get_world_size(group)
    xs = x.movedim(dim, 0).contiguous()
    if xs.shape[0] % n:
        raise ValueError(f"reduce_scatter: dim {dim} of {tuple(x.shape)} over {n} ranks")
    src = xs.cpu() if _staged(x, group) else xs
    out = torch.empty((xs.shape[0] // n, *xs.shape[1:]), dtype=src.dtype, device=src.device)
    dist.reduce_scatter_tensor(out, src, group=group)
    return out.to(x.device).movedim(0, dim).contiguous()


def all_reduce_(x: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """Reduce ``x`` over the group with ``op`` (a sum by default), in place;
    returns ``x``."""
    if _staged(x, group):
        h = x.cpu()
        dist.all_reduce(h, op=op, group=group)
        x.copy_(h)
    else:
        dist.all_reduce(x, op=op, group=group)
    return x


def broadcast_(x: torch.Tensor, src: int, group) -> torch.Tensor:
    """``x`` of the group's rank ``src`` (an index in the group) on every
    rank, in place; returns ``x``."""
    g_src = dist.get_global_rank(group, src)
    if _staged(x, group):
        h = x.cpu()
        dist.broadcast(h, g_src, group=group)
        x.copy_(h)
    else:
        dist.broadcast(x, g_src, group=group)
    return x


def shift(tensors: Sequence[torch.Tensor], group, step: int = 1) -> List[torch.Tensor]:
    """Send each tensor ``step`` ranks on along the group's ring (``rank +
    step`` mod n) and receive those of ``rank - step``: one
    ``batch_isend_irecv`` holding every send and receive, so no rank waits on
    a send its neighbour has not posted."""
    n, me = dist.get_world_size(group), dist.get_rank(group)
    nxt = dist.get_global_rank(group, (me + step) % n)
    prv = dist.get_global_rank(group, (me - step) % n)
    staged = [_staged(t, group) for t in tensors]
    src = [t.cpu() if s else t.contiguous() for t, s in zip(tensors, staged)]
    dst = [torch.empty_like(t) for t in src]
    ops = []
    for tag, (s, d) in enumerate(zip(src, dst)):
        ops += [dist.P2POp(dist.isend, s, nxt, group=group, tag=tag),
                dist.P2POp(dist.irecv, d, prv, group=group, tag=tag)]
    for w in dist.batch_isend_irecv(ops):
        w.wait()
    return [d.to(t.device) if s else d for d, t, s in zip(dst, tensors, staged)]
