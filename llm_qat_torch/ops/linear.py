"""Quantized dense (linear) op, the ``QuantizeLinear`` equivalent (the JAX
package's ``ops/linear.py``): a pure function over an ``[in, out]`` weight,
``act_quant(x) @ weight_quant(w)`` with no bias.
"""

from __future__ import annotations

import torch

from llm_qat_torch.ops.quantize import act_fake_quant, weight_fake_quant
from llm_qat_torch.parallel import tensor as ptensor


def matmul_promoted(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` at the promoted type of the two (bf16 activations against
    f32 master weights give f32, as in JAX; torch would raise)."""
    dt = torch.promote_types(x.dtype, w.dtype)
    return x.to(dt) @ w.to(dt)


def quant_dense(
    x: torch.Tensor,
    w: torch.Tensor,
    *,
    w_bits: int = 32,
    a_bits: int = 32,
    symmetric: bool = True,
    act_layerwise: bool = False,
    weight_layerwise: bool = False,
    fused: bool = False,
    tp=None,
    row: bool = False,
) -> torch.Tensor:
    """Weight path by ``w_bits`` (passthrough / symmetric per channel / the
    1-2-bit branches), activation quantized only when ``2 < a_bits < 32``.
    ``fused=True`` routes the supported symmetric per-channel / per-token
    configurations (3 <= w <= 8, 2 < a <= 8) through the integer product with
    the same STE gradients (``ops/qat_matmul.py``).

    ``tp`` (the mesh's 'tp' group) makes this rank's part of a tensor-parallel
    layer: column-parallel (``w`` ``[in, out/tp]``, ``x`` whole, its gradient
    summed over 'tp') or, with ``row``, row-parallel (``w`` ``[in/tp, out]``,
    ``x`` this rank's ``in`` block; the scales reduce over 'tp' and the
    output is the group's sum). A per-tensor weight scale spans 'tp' either
    way."""
    if fused and symmetric and not act_layerwise and not weight_layerwise:
        from llm_qat_torch.ops.qat_matmul import fused_quant_matmul, supported

        if supported(w_bits, a_bits):
            return fused_quant_matmul(x, w, w_bits, a_bits, tp, row)
    if not row:
        x = ptensor.copy_to_tp(x, tp)
    wq = weight_fake_quant(w, w_bits, layerwise=weight_layerwise,
                           group=tp if row or weight_layerwise else None)
    xq = act_fake_quant(x, a_bits, symmetric=symmetric, layerwise=act_layerwise,
                        group=tp if row else None)
    out = matmul_promoted(xq, wq)
    return ptensor.reduce_from_tp(out, tp) if row else out
