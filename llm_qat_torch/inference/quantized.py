"""True low-bit serving parameters and the serving linear.

Port of the JAX package's ``inference/quantized.py``: materialized int8 or
split-half packed int4 weights with per-channel scales feed the int kernels
of ``ops/quant_matmul.py``; the KV cache holds int8 values and per-token
scales. Under tensor parallelism (``inference/sharded.py``) ``quant_linear``
is the row-parallel half of the Megatron pair: ``reduce_group`` is the tp
process group, the activation scale comes from the group's global absmax, and
the f32 partial products are summed over the group one column chunk at a
time, rounded once at the end (the JAX package's ``reduce_axis`` and
``n_chunks``: here the chunks are those ``sharded.shard_qparams`` stores).
"""

from __future__ import annotations

import warnings
from typing import Any, Dict, Tuple

import numpy as np
import torch
import torch.distributed as dist

from llm_qat_torch.device import resolve_device
from llm_qat_torch.models.config import LlamaConfig
from llm_qat_torch.ops import quant_matmul as QM
from llm_qat_torch.parallel import comm

# serving fuses shared-input projections into single wider matmuls;
# per-output-channel quantization is column-independent, so fusion changes
# no numerics
_FUSED_GROUPS = {"qkv": ("q", "k", "v"), "gateup": ("gate", "up")}
_FUSED_SINGLES = ("o", "down")


def _check_w_bits(w_bits: int) -> None:
    if w_bits not in (4, 8, 16, 32):
        raise NotImplementedError(
            f"serving w_bits {w_bits}: the true-int serving engine packs "
            "w4/w8 (and serves w>=16 fp)"
        )


def quantize_params(params: Dict[str, Any], config: LlamaConfig,
                    device=None) -> Dict[str, Any]:
    """Latent-fp params -> serving params on ``device`` (``cuda`` unless
    ``device="cpu"``).

    Every projection becomes ``{"q": int8 [L, K, N] or packed uint8
    [L, K/2, N], "s": f32 [L, 1, N]}`` quantized per output channel at
    ``config.w_bits``; embeddings, lm_head and norm gains stay fp."""
    _check_w_bits(config.w_bits)
    dev = resolve_device(device)
    w_bits = config.w_bits
    lay = params["layers"]
    out: Dict[str, Any] = {
        "embed": params["embed"].to(dev),
        "final_norm": params["final_norm"].to(dev),
        "layers": {
            "attn_norm": lay["attn_norm"].to(dev),
            "mlp_norm": lay["mlp_norm"].to(dev),
        },
    }
    if "lm_head" in params:
        out["lm_head"] = params["lm_head"].to(dev)

    def quantize(w):
        if w_bits >= 16:
            return {"w": w}
        if w_bits == 8:
            q, s = QM.quantize_per_channel(w, 8)
        else:
            q, s = QM.quantize_weights_w4(w)
        return {"q": q, "s": s}

    for name, parts in _FUSED_GROUPS.items():
        w = torch.cat([lay[k].to(dev) for k in parts], dim=-1)
        out["layers"][name] = quantize(w)
        del w
    for key in _FUSED_SINGLES:
        out["layers"][key] = quantize(lay[key].to(dev))
    return out


def quantize_params_host(params_host: Dict[str, Any], config: LlamaConfig,
                         device=None) -> Dict[str, Any]:
    """Host-side (numpy) quantization; only the int result, the scales and
    the bf16 embeddings/norms are copied to ``device``. For models whose fp
    weights do not fit on the card beside their int copy."""
    _check_w_bits(config.w_bits)
    dev = resolve_device(device)
    w_bits = config.w_bits

    def put(x, dtype=None):
        t = torch.from_numpy(np.ascontiguousarray(np.asarray(x)))
        return t.to(device=dev, dtype=dtype) if dtype else t.to(dev)

    lay = params_host["layers"]
    out: Dict[str, Any] = {
        "embed": put(np.asarray(params_host["embed"], np.float32), torch.bfloat16),
        "final_norm": put(np.asarray(params_host["final_norm"], np.float32),
                          torch.bfloat16),
        "layers": {
            "attn_norm": put(np.asarray(lay["attn_norm"], np.float32), torch.bfloat16),
            "mlp_norm": put(np.asarray(lay["mlp_norm"], np.float32), torch.bfloat16),
        },
    }
    if "lm_head" in params_host:
        out["lm_head"] = put(np.asarray(params_host["lm_head"], np.float32),
                             torch.bfloat16)

    qmax = float(2 ** (w_bits - 1) - 1) if w_bits < 16 else None

    def quantize_np(w):
        if w_bits >= 16:
            return {"w": put(w, torch.bfloat16)}
        absmax = np.max(np.abs(w), axis=1, keepdims=True)
        s = qmax / (absmax + 1e-6)
        q = torch.from_numpy(np.rint(w * s).astype(np.int8))
        if w_bits == 4:
            q = QM.pack_int4(q)      # split-half along K, axis -2 of [L, K, N]
        return {"q": q.to(dev), "s": put(s.astype(np.float32))}

    for name, parts in _FUSED_GROUPS.items():
        w = np.concatenate([np.asarray(lay[k], np.float32) for k in parts], axis=-1)
        out["layers"][name] = quantize_np(w)
    for key in _FUSED_SINGLES:
        out["layers"][key] = quantize_np(np.asarray(lay[key], np.float32))
    return out


def dequant_weight(qw: Dict[str, torch.Tensor], w_bits: int,
                   dtype=torch.bfloat16) -> torch.Tensor:
    """The fp weight of a serving entry: ``w = q / (s + 1e-6)``; int4
    entries are split-half packed along axis -2."""
    if "w" in qw:
        return qw["w"].to(dtype)
    q = qw["q"]
    if w_bits == 4:
        q = QM.unpack_int4(q)
    return (q.float() / (qw["s"] + QM._EPS)).to(dtype)


def column_chunks(qw: Dict[str, torch.Tensor]):
    """The ``(q, s)`` column chunks of one layer's serving weight, each
    contiguous: the stored chunks of a chunk-major ``q`` ``[n, K(/2), N/n]``
    (``sharded.shard_qparams`` splits the row-parallel weights so once), else
    the ``[K(/2), N]`` weight whole."""
    q, s = qw["q"], qw["s"]
    if q.dim() == 3:
        return list(zip(q.unbind(0), s.unbind(0)))
    return [(q, s)]


def token_absmax(x: torch.Tensor, group=None) -> torch.Tensor:
    """Per-token absmax of ``x`` [..., K]; over ``group``'s K-shards when
    given (an all-reduce MAX), so every rank quantizes with the global
    scale."""
    amax = x.abs().amax(dim=-1, keepdim=True)
    return amax if group is None else comm.all_reduce_(amax, group, op=dist.ReduceOp.MAX)


def quant_linear(
    x: torch.Tensor,   # [..., K] fp (a K-shard under reduce_group)
    qw: Dict[str, torch.Tensor],
    w_bits: int,
    a_bits: int = 8,
    out_dtype=torch.bfloat16,
    reduce_group=None,
) -> torch.Tensor:
    """Serving linear: int kernels when quantized, plain matmul else.

    ``a_bits`` follows the training activation contract (quantizer active
    iff ``2 < a_bits < 32``): 3..8 ride the int8 kernels with ``a_bits``-level
    per-token quantization; ``<= 2`` or ``>= 32`` is the fp passthrough;
    16..31 is served fp (a documented approximation, with a warning);
    9..15 cannot be held in the int8 activation container and raises.

    ``reduce_group``: the row-parallel product over a tp group (``x`` and the
    weight's K split over it): the output is summed over the group, on the int
    route in f32 one stored column chunk at a time (``column_chunks``)."""
    if 8 < a_bits < 16:
        raise NotImplementedError(
            f"serving activation container is int8: a_bits={a_bits} "
            "unsupported (use a_bits<=8 or >=16)"
        )
    if 16 <= a_bits < 32:
        warnings.warn(
            f"a_bits={a_bits}: training fake-quants activations at this "
            "width but serving runs them in full precision (documented "
            "approximation; use a_bits<=8 for int-exact serving)",
            stacklevel=2,
        )
    fp_act = a_bits <= 2 or a_bits >= 16
    reduce = (lambda t: t) if reduce_group is None else (  # noqa: E731
        lambda t: comm.all_reduce_(t, reduce_group))
    if "w" in qw:  # unquantized weight
        if not fp_act:
            xq, sx = QM.quantize_per_token(x, a_bits, amax=token_absmax(x, reduce_group))
            x = (xq.float() / (sx + QM._EPS)).to(x.dtype)
        return reduce(torch.matmul(x, qw["w"].to(x.dtype)))
    if fp_act:
        # fp activations against a quantized weight: dequantize the weight
        ws = [dequant_weight({"q": q, "s": s}, w_bits, dtype=x.dtype)
              for q, s in column_chunks(qw)]
        w = ws[0] if len(ws) == 1 else torch.cat(ws, dim=-1)
        return reduce(torch.matmul(x, w)).to(out_dtype)
    lead, K = x.shape[:-1], x.shape[-1]
    x2 = x.reshape(-1, K)
    if reduce_group is None:
        mm = QM.w8a8_matmul if w_bits == 8 else QM.w4a8_matmul
        out = mm(x2, qw["q"], qw["s"], out_dtype=out_dtype, bits=a_bits)
        return out.reshape(*lead, out.shape[-1])
    xq, sx, M = QM.quantize_rows(x2, a_bits, token_absmax(x2, reduce_group))
    # partials summed over the group in f32, one rounding at the end
    outs = [reduce(QM.act_matmul(xq, q, sx, s, w_bits == 4, torch.float32))
            for q, s in column_chunks(qw)]
    out = outs[0] if len(outs) == 1 else torch.cat(outs, dim=-1)
    return out[:M].to(out_dtype).reshape(*lead, out.shape[-1])


def quantize_kv(x: torch.Tensor, bits: int = 8,
                amax: torch.Tensor = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """[b, s, kv_dim] -> (int8 [b, s, kv_dim], scales [b, s, 1]): the serving
    form of the per-token KV fake-quant. Caches store the inverse scale
    ``1/(s+1e-6)``, so dequant is a multiply."""
    return QM.quantize_per_token(x, bits, amax=amax)
