"""Quantized dense (linear) op, the ``QuantizeLinear`` equivalent (the JAX
package's ``ops/linear.py``): a pure function over an ``[in, out]`` weight,
``act_quant(x) @ weight_quant(w)`` with no bias.
"""

from __future__ import annotations

import torch

from llm_qat_torch.ops.quantize import act_fake_quant, weight_fake_quant


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
) -> torch.Tensor:
    """Weight path by ``w_bits`` (passthrough / symmetric per channel / the
    1-2-bit branches), activation quantized only when ``2 < a_bits < 32``.
    ``fused=True`` routes the supported symmetric per-channel / per-token
    configurations (3 <= w <= 8, 2 < a <= 8) through the integer product with
    the same STE gradients (``ops/qat_matmul.py``)."""
    if fused and symmetric and not act_layerwise and not weight_layerwise:
        from llm_qat_torch.ops.qat_matmul import fused_quant_matmul, supported

        if supported(w_bits, a_bits):
            return fused_quant_matmul(x, w, w_bits, a_bits)
    wq = weight_fake_quant(w, w_bits, layerwise=weight_layerwise)
    xq = act_fake_quant(x, a_bits, symmetric=symmetric, layerwise=act_layerwise)
    return matmul_promoted(xq, wq)
