"""Tensor-parallel serving: the true-int engine over a ``tp`` process group.

Port of the JAX package's ``inference/sharded.py``. JAX runs one program over
a device mesh (``shard_map``); here each rank is one process holding its
shard, and the collectives are explicit calls over the ``tp`` group of a
``DeviceMesh`` (``parallel/mesh.make_serving_mesh``) through
``parallel/comm.py``. Every rank runs the same engine loop on the same
request stream; the logits are replicated, so every rank samples the same
tokens. The numerics contract is the JAX package's:

* **Quantize before sharding.** ``quantize_params_tp`` computes every scale
  over the full K per output channel, so tp changes the layout, never the
  integers. tp = 1 is ``quantized.quantize_params``'s layout.
* **Megatron column/row pair.** qkv and gate-up are split over their output
  columns (a rank owns a contiguous block of heads / ffn channels: the fused
  weights are TP-interleaved, ``[q_d | k_d | v_d]`` per rank, so a plain
  N-shard hands every rank its own heads); o and down are split over K and
  summed over the group. W4 row weights are packed per K-shard
  (``_pack_int4_rowsharded``), so a rank's nibbles unpack from its shard.
* **Global per-token absmax.** A row-parallel input and the new K/V hold only
  a shard of their row: their absmax is an all-reduce MAX over the group, so
  the sharded cache holds exactly the single-device integers and scales.
* **Row-parallel partials in f32**, summed in ``TP_CHUNKS`` column chunks and
  rounded once (``quantized.quant_linear``). ``shard_qparams`` stores each
  row weight's chunks contiguous, chunk-major, once: the stored layout is
  what chunks the sum.
* **KV cache and page pool split over kv heads**; scales, lengths and block
  tables replicated. KV4 nibble packing is per head, so it composes.
* **A vocab-split lm_head**: the logits are all-gathered (a tied head stays
  replicated). The decode megakernel stays off under TP.

Specs say which dim a leaf splits, in the style of ``parallel/mesh.py``: a
tuple with one entry a dim, ``'tp'`` where the dim is split.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from llm_qat_torch.device import resolve_device
from llm_qat_torch.inference import model as M
from llm_qat_torch.inference import paged as PG
from llm_qat_torch.inference import quantized as Q
from llm_qat_torch.models.config import LlamaConfig
from llm_qat_torch.ops import quant_matmul as QM
from llm_qat_torch.parallel import mesh as pmesh

_COL_GROUPS = {"qkv": ("q", "k", "v"), "gateup": ("gate", "up")}
_ROW_SINGLES = ("o", "down")
# the row-parallel sum's column chunks (JAX model.py: ``nc = 4 if tp_axis``)
TP_CHUNKS = 4


def _interleave_tp(parts, tp: int) -> torch.Tensor:
    """Fuse ``[L, K, N_i]`` weights as per-rank blocks
    ``[p0_r0 | p1_r0 | ... | p0_r1 | ...]`` so a contiguous N-shard over tp
    gives rank r exactly its own slice of every part."""
    chunks = [w.reshape(*w.shape[:-1], tp, w.shape[-1] // tp) for w in parts]
    per_rank = [torch.cat([c[..., r, :] for c in chunks], dim=-1) for r in range(tp)]
    return torch.cat(per_rank, dim=-1)


def _pack_int4_rowsharded(q8: torch.Tensor, tp: int) -> torch.Tensor:
    """``[L, K, N]`` int8 -> ``[L, K/2, N]`` uint8, split-half packed within
    each K/tp shard: rank r's packed rows unpack from its own shard alone
    (``QM.pack_int4`` exactly when tp == 1)."""
    L, K, N = q8.shape
    kl = K // tp
    if kl % 2:
        raise ValueError(f"a K-shard of {kl} rows cannot be nibble-packed (K={K}, tp={tp})")
    return QM.pack_int4(q8.reshape(L, tp, kl, N)).reshape(L, K // 2, N)


def quantize_params_tp(params: Dict[str, Any], config: LlamaConfig, tp: int,
                       device=None) -> Dict[str, Any]:
    """Latent-fp params -> serving params in the tp-interleaved layout, whole,
    on ``device`` (``cuda`` unless ``device="cpu"``): every rank's shard of it
    is ``shard_qparams``'s. Requires tp to divide the heads, the kv heads and
    the ffn width."""
    c = config
    Q._check_w_bits(c.w_bits)
    if c.num_attention_heads % tp or c.kv_heads % tp or c.intermediate_size % tp:
        raise ValueError(
            f"tp={tp} must divide heads ({c.num_attention_heads}), kv heads "
            f"({c.kv_heads}) and ffn ({c.intermediate_size})"
        )
    dev = resolve_device(device)
    w_bits = c.w_bits
    lay = params["layers"]
    out: Dict[str, Any] = {
        "embed": params["embed"].to(dev),
        "final_norm": params["final_norm"].to(dev),
        "layers": {"attn_norm": lay["attn_norm"].to(dev), "mlp_norm": lay["mlp_norm"].to(dev)},
    }
    if "lm_head" in params:
        out["lm_head"] = params["lm_head"].to(dev)

    def quantize(w, row):
        if w_bits >= 16:
            return {"w": w}
        q, s = QM.quantize_per_channel(w, w_bits)
        if w_bits == 4:
            # column-parallel: K whole, the global split-half pack
            q = _pack_int4_rowsharded(q, tp) if row else QM.pack_int4(q)
        return {"q": q, "s": s}

    for name, parts in _COL_GROUPS.items():
        w = _interleave_tp([lay[k].to(dev) for k in parts], tp)
        out["layers"][name] = quantize(w, row=False)
        del w
    for key in _ROW_SINGLES:
        out["layers"][key] = quantize(lay[key].to(dev), row=True)
    return out


# ---------------------------------------------------------------------------
# Specs and shards
# ---------------------------------------------------------------------------


def _wspec(qw: Dict[str, Any], col: bool) -> Dict[str, tuple]:
    """One projection's ``{"q", "s"}`` / ``{"w"}``: column-parallel splits N
    (scales with it), row-parallel splits K (scales replicated)."""
    if "w" in qw:
        return {"w": (None, None, "tp") if col else (None, "tp", None)}
    if col:
        return {"q": (None, None, "tp"), "s": (None, None, "tp")}
    return {"q": (None, "tp", None), "s": (None, None, None)}


def qparam_specs(qparams: Dict[str, Any]) -> Dict[str, Any]:
    """Spec tree of a ``quantize_params_tp`` tree."""
    lay = qparams["layers"]
    specs: Dict[str, Any] = {
        "embed": (None, None),
        "final_norm": (None,),
        "layers": {
            "attn_norm": (None, None),
            "mlp_norm": (None, None),
            **{k: _wspec(lay[k], True) for k in _COL_GROUPS},
            **{k: _wspec(lay[k], False) for k in _ROW_SINGLES},
        },
    }
    if "lm_head" in qparams:
        specs["lm_head"] = (None, "tp")      # vocab-split; logits all-gathered
    return specs


def cache_specs() -> Dict[str, tuple]:
    """The serving cache: values split over kv heads, per-token scales and
    lengths replicated (a scale is shared by all heads)."""
    kv = (None, None, "tp", None, None)
    return {"k_q": kv, "k_s": (None, None, None), "v_q": kv, "v_s": (None, None, None),
            "lengths": (None,)}


def paged_cache_specs() -> Dict[str, tuple]:
    """The page pool ``[L, n_pages, kvh, hd(/2), P]``: split over kv heads,
    per-token scales replicated."""
    kv = (None, None, "tp", None, None)
    return {"k_q": kv, "k_s": (None, None, None), "v_q": kv, "v_s": (None, None, None)}


def shard_tree(tree, specs, mesh):
    """This rank's slice of every leaf (a copy where a dim is split, so the
    whole can be freed; a replicated leaf as is)."""
    n, i = pmesh.axis_size(mesh, "tp"), pmesh.axis_index(mesh, "tp")

    def shard(t, spec):
        d = pmesh.split_dim(spec, "tp")
        if d is None:
            return t
        if t.shape[d] % n:
            raise ValueError(f"dim {d} of {tuple(t.shape)} does not split over tp={n}")
        c = t.shape[d] // n
        return t.narrow(d, i * c, c).clone()

    return pmesh.map_specs(shard, tree, specs)


def _chunk_major(t: torch.Tensor, n_chunks: int) -> torch.Tensor:
    """``[L, K, N]`` -> ``[L, n, K, N/n]``, each column chunk contiguous."""
    L, K, N = t.shape
    return t.reshape(L, K, n_chunks, N // n_chunks).permute(0, 2, 1, 3).contiguous()


def shard_qparams(qparams: Dict[str, Any], mesh) -> Dict[str, Any]:
    """This rank's slice of a ``quantize_params_tp`` tree (the counterpart
    of the JAX package's ``place``). The quantized row-parallel weights are
    stored chunk-major, ``{"q": [L, n, K/tp(/2), N/n], "s": [L, n, 1, N/n]}``
    with n = ``TP_CHUNKS``, so the chunked sum launches on contiguous operands
    (``quantized.column_chunks``); where ``TP_CHUNKS`` does not divide N, one
    chunk (the JAX package's ``quant_linear`` falls back so too)."""
    out = shard_tree(qparams, qparam_specs(qparams), mesh)
    for key in _ROW_SINGLES:
        qw = out["layers"][key]
        if "q" in qw:
            n = TP_CHUNKS if qw["s"].shape[-1] % TP_CHUNKS == 0 else 1
            out["layers"][key] = {"q": _chunk_major(qw["q"], n), "s": _chunk_major(qw["s"], n)}
    return out


def init_serving_cache_tp(config: LlamaConfig, batch: int, max_len: int, mesh,
                          device=None) -> Dict[str, torch.Tensor]:
    """This rank's shard of the serving cache (the single-device cache's
    shapes with kv_heads / tp heads; the KV4 packed container too)."""
    return M.init_serving_cache(config, batch, max_len, device,
                                kv_heads=config.kv_heads // pmesh.axis_size(mesh, "tp"))


def init_paged_cache_tp(config: LlamaConfig, pcfg, mesh, device=None) -> Dict[str, torch.Tensor]:
    """This rank's shard of the page pool."""
    return PG.init_paged_cache(config, pcfg, device,
                               kv_heads=config.kv_heads // pmesh.axis_size(mesh, "tp"))


# ---------------------------------------------------------------------------
# The tensor-parallel steps
# ---------------------------------------------------------------------------


def make_tp_forward(config: LlamaConfig, mesh, dtype=torch.bfloat16,
                    from_empty: bool = False, device=None):
    """The tensor-parallel serving step with ``serving_forward``'s signature
    minus config and dtype: ``fn(qparams, ids, seq_lens, active, cache) ->
    (logits, cache)``, over this rank's shards (``shard_qparams``,
    ``init_serving_cache_tp``). ``from_empty`` builds the prefill variant."""
    group = pmesh.axis_group(mesh, "tp")

    def fn(qp, ids, seq_lens, active, cache):
        return M.serving_forward(qp, config, ids, seq_lens, active, cache, dtype=dtype,
                                 from_empty=from_empty, device=device, tp_group=group)

    return fn


def make_tp_prefill(config: LlamaConfig, mesh, dtype=torch.bfloat16, device=None):
    """The tensor-parallel batch prefill from empty: ``fn(qparams, ids[b, s])
    -> (logits, rows)``, the rows split over kv heads as the persistent cache
    is, so ``model.insert_slot`` splices them in."""
    group = pmesh.axis_group(mesh, "tp")

    def fn(qp, ids):
        return M.prefill_slot(qp, config, ids, dtype=dtype, device=device, tp_group=group)

    return fn


def make_tp_paged_forward(config: LlamaConfig, pcfg, mesh, dtype=torch.bfloat16,
                          from_empty: bool = False, device=None):
    """The tensor-parallel paged step: ``fn(qparams, ids, seq_lens, active,
    block_tables, cache) -> (logits, cache)``. Block tables and lengths are
    the host's, the same on every rank. ``from_empty`` builds the prefill
    variant (called with ``b == 1`` rows)."""
    group = pmesh.axis_group(mesh, "tp")

    def fn(qp, ids, seq_lens, active, block_tables, cache):
        return PG.paged_forward(qp, config, pcfg, ids, seq_lens, active, block_tables, cache,
                                dtype=dtype, from_empty=from_empty, device=device,
                                tp_group=group)

    return fn


def check_mesh(mesh):
    """A serving mesh is a ``DeviceMesh`` with a ``tp`` axis."""
    from torch.distributed.device_mesh import DeviceMesh

    if not isinstance(mesh, DeviceMesh) or "tp" not in (mesh.mesh_dim_names or ()):
        raise TypeError("mesh: a DeviceMesh with a 'tp' axis from "
                        f"parallel.mesh.make_serving_mesh, got {mesh!r}")
