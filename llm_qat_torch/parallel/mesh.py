"""Device mesh and sharding rules (the JAX package's ``parallel/mesh.py``).

The whole topology is one ``torch.distributed.device_mesh.DeviceMesh`` over
the ranks of the default process group, with the JAX package's named axes

    ('data', 'fsdp', 'tp')   (+ 'pp' and 'cp' when those are > 1)

and the same per-parameter layout (``param_specs``): stacked layer weights
``[L, in, out]`` split ``in`` over fsdp for the column-parallel projections
(q/k/v/gate/up) and ``out`` for the row-parallel ones (o/down); embed
``[V, H]`` and lm_head ``[H, V]`` split the hidden dim; norm scales are
replicated. Over 'tp' the column-parallel projections split ``out``, the
row-parallel ones ``in``, embed and lm_head the vocabulary (the Megatron
layout). A spec is a tuple with one entry a dim: an axis name, a tuple of
them, or None. Where GSPMD inserts the all-gathers and reduce-scatters in
the JAX package, the port issues them itself (``parallel.zero`` over
'fsdp', ``parallel.tensor`` over 'tp'), so a rank holds only its shard of
every split leaf (and of its AdamW moments). The batch splits over
('data', 'fsdp'), data-major: the ranks of one 'tp' line see the same rows.
``pp > 1`` appends the pipeline's axis, over which ``parallel.pipeline``
splits the stacked layers.

Serving has a mesh of its own (``make_serving_mesh``): one ``('tp',)`` axis,
or ``('host', 'tp')`` where the world holds several tensor-parallel groups
(``inference/multihost.py``); ``inference/sharded.py`` splits the serving
params and caches over 'tp'.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.distributed as dist

from llm_qat_torch.parallel import comm

MESH_AXES = ("data", "fsdp", "tp")


def make_mesh(data: int = 1, fsdp: int = -1, tp: int = 1, pp: int = 1, cp: int = 1,
              device_type: Optional[str] = None):
    """The global mesh over every rank of the initialized default process
    group, ``('data', 'fsdp', 'tp')`` with ``pp > 1`` appending the
    pipeline's axis and ``cp > 1`` the ring's context axis, as the JAX
    package's. ``fsdp=-1`` absorbs the ranks the other axes leave. ``device_type``: where the ranks' tensors
    live (``cuda`` when the backend is NCCL, else ``cpu``)."""
    from torch.distributed.device_mesh import DeviceMesh

    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs torch.distributed initialized (torchrun with "
                           "cli.train.maybe_init_distributed, or parallel.launch.spawn)")
    n = dist.get_world_size()
    if fsdp == -1:
        fsdp = n // (data * tp * pp * cp)
    if data * fsdp * tp * pp * cp != n:
        raise ValueError(f"mesh {data}x{fsdp}x{tp}x{pp}x{cp} != {n} devices")
    axes, shape = list(MESH_AXES), [data, fsdp, tp]
    if pp > 1:
        axes.append("pp")
        shape.append(pp)
    if cp > 1:
        axes.append("cp")
        shape.append(cp)
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return DeviceMesh(device_type, torch.arange(n).reshape(shape), mesh_dim_names=tuple(axes))


def make_serving_mesh(tp: int, device_type: Optional[str] = None):
    """The serving mesh over every rank of the initialized default process
    group: ``('tp',)`` when ``tp`` is the world, else ``('host', 'tp')`` of
    shape ``[world // tp, tp]``, each row ``tp`` consecutive ranks. Every rank
    builds it (a group's creation is collective over the whole world)."""
    from torch.distributed.device_mesh import DeviceMesh

    if not dist.is_initialized():
        raise RuntimeError("make_serving_mesh needs torch.distributed initialized")
    n = dist.get_world_size()
    if tp < 1 or n % tp:
        raise ValueError(f"tp={tp} does not divide the world of {n} ranks")
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    if tp == n:
        return DeviceMesh(device_type, torch.arange(n), mesh_dim_names=("tp",))
    return DeviceMesh(device_type, torch.arange(n).reshape(n // tp, tp),
                      mesh_dim_names=("host", "tp"))


def mesh_shape(mesh) -> Dict[str, int]:
    """``{axis: size}``, as a JAX mesh's ``shape``."""
    return {a: mesh.size(i) for i, a in enumerate(mesh.mesh_dim_names)}


def axis_size(mesh, axis: str) -> int:
    """The size of ``axis`` (1 for an axis the mesh lacks)."""
    return mesh_shape(mesh).get(axis, 1)


def axis_index(mesh, axis: str) -> int:
    """This rank's coordinate on ``axis``."""
    return mesh.get_local_rank(axis)


def axis_group(mesh, axis: str):
    """The process group of this rank's line along ``axis``."""
    return mesh.get_group(axis)


def tp_group(mesh):
    """The 'tp' group of this rank, or None without a mesh or at tp = 1 (the
    tensor-parallel functions' "no split")."""
    if mesh is None or axis_size(mesh, "tp") == 1:
        return None
    return axis_group(mesh, "tp")


def batch_shards(mesh):
    """(shard count, this rank's shard) of a batch split over ('data',
    'fsdp'), data-major."""
    f = axis_size(mesh, "fsdp")
    return axis_size(mesh, "data") * f, axis_index(mesh, "data") * f + axis_index(mesh, "fsdp")


def param_specs(tie_word_embeddings: bool = False) -> Dict[str, Any]:
    """Spec tree matching ``models.params.init_params``'s structure."""
    specs = {
        "embed": ("tp", "fsdp"),
        "layers": {
            "attn_norm": (None, None),
            "q": (None, "fsdp", "tp"),
            "k": (None, "fsdp", "tp"),
            "v": (None, "fsdp", "tp"),
            "o": (None, "tp", "fsdp"),
            "mlp_norm": (None, None),
            "gate": (None, "fsdp", "tp"),
            "up": (None, "fsdp", "tp"),
            "down": (None, "tp", "fsdp"),
        },
        "final_norm": (None,),
    }
    if not tie_word_embeddings:
        specs["lm_head"] = ("fsdp", "tp")
    return specs


def replicated_specs(tree) -> Any:
    """A spec tree that splits nothing, for ``tree``'s structure."""
    if isinstance(tree, dict):
        return {k: replicated_specs(v) for k, v in tree.items()}
    return (None,) * tree.dim()


def batch_spec():
    """Token batches split over the combined data-parallel axes."""
    return (("data", "fsdp"), None)


def split_dim(spec, axis: str = "fsdp") -> Optional[int]:
    """The dim ``spec`` splits over ``axis``, or None."""
    for d, e in enumerate(spec):
        if e == axis or (isinstance(e, tuple) and axis in e):
            return d
    return None


def split_axes(spec) -> Tuple[str, ...]:
    """Every axis ``spec`` splits a dim over, in the spec's order."""
    out = []
    for e in spec:
        out += [] if e is None else [e] if isinstance(e, str) else list(e)
    return tuple(out)


def map_specs(fn, tree, specs):
    """``fn(leaf, spec)`` over a tree of tensors and its spec tree."""
    if isinstance(tree, dict):
        return {k: map_specs(fn, v, specs[k]) for k, v in tree.items()}
    return fn(tree, specs)


def _dim_axes(spec):
    """(dim, its axes major to minor) for every dim ``spec`` splits."""
    return [(d, (e,) if isinstance(e, str) else tuple(e))
            for d, e in enumerate(spec) if e is not None]


def shard_params(params, mesh, specs=None):
    """This rank's shard of every leaf of a full param tree: a dim a spec
    splits keeps the rank's block over the axes it names (a copy, so the
    full tensor can be freed; a dim over several axes splits major to
    minor); a mesh without an axis holds it at size 1. Replicated leaves stay
    whole. A split dim must divide evenly, as a JAX ``NamedSharding``
    requires."""
    if specs is None:
        specs = param_specs("lm_head" not in params)

    def shard(t, spec):
        for d, axes in _dim_axes(spec):
            n = math.prod(axis_size(mesh, a) for a in axes)
            if t.shape[d] % n:
                raise ValueError(f"dim {d} of {tuple(t.shape)} does not split over "
                                 f"{'x'.join(axes)}={n}")
            i = 0
            for a in axes:
                i = i * axis_size(mesh, a) + (axis_index(mesh, a) if a in mesh_shape(mesh) else 0)
            c = t.shape[d] // n
            t = t.narrow(d, i * c, c)
        return t if not _dim_axes(spec) else t.clone()

    return map_specs(shard, params, specs)


def gather_params(shards, mesh, specs=None):
    """The full tree from every rank's shards (a collective: every rank of
    the mesh calls it). No gradient flows through it."""
    if specs is None:
        specs = param_specs("lm_head" not in shards)

    def gather(t, spec):
        t = t.detach()
        for d, axes in _dim_axes(spec):
            for a in reversed(axes):            # minor first
                if axis_size(mesh, a) > 1:
                    t = comm.all_gather(t, d, axis_group(mesh, a))
        return t

    with torch.no_grad():
        return map_specs(gather, shards, specs)


def shard_batch(batch: Dict[str, Any], mesh) -> Dict[str, Any]:
    """This rank's rows of a global batch split over ('data', 'fsdp')."""
    n, i = batch_shards(mesh)
    out = {}
    for k, v in batch.items():
        if v.shape[0] % n:
            raise ValueError(f"batch of {v.shape[0]} rows does not split over {n} ranks")
        c = v.shape[0] // n
        out[k] = v[i * c:(i + 1) * c]
    return out
