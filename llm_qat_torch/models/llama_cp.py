"""Context-parallel (ring) training forward: the sequence split over a ``cp``
mesh axis (the JAX package's ``models/llama_cp.py``).

Every projection and norm is local to a rank's chunk of the sequence, and
attention runs as the ring of ``parallel.ring_attention`` (the flash kernels
on every live step): per-rank scores are O((s/n)^2) and activations O(s/n),
so context grows with the ring. A rank passes its own chunk of the token ids
and gets its chunk's logits; its RoPE positions start at ``idx * sl``.

Numerics: the KV fake-quant runs at the reference's hook point (before the
head reshape and RoPE) on the local tokens; it is per token, so this is the
single-device math exactly. The ring can compress its transport to int8
(``ring_transport_bits=8``), a second quantization on top of the model's
own; the default (None) keeps the training numerics of ``llama.forward``.

A layer takes the unfused norm and quantization (``rms_norm`` and
``quant_dense``, as the JAX package's ``_cp_decoder_layer`` does) whatever
``fused_norm_quant`` says. Params are whole on every rank (replicated over
the ring); the caller sums their gradients over the ring
(``training.trainer`` does).
"""

from __future__ import annotations

from typing import Optional

import torch

from llm_qat_torch.models import llama
from llm_qat_torch.models.config import LlamaConfig
from llm_qat_torch.ops.linear import quant_dense
from llm_qat_torch.ops.quantize import kv_fake_quant
from llm_qat_torch.parallel import mesh as pmesh
from llm_qat_torch.parallel.ring_attention import ring_flash_attention_local


def _cp_decoder_layer(h: torch.Tensor, lp, config: LlamaConfig, cos: torch.Tensor,
                      sin: torch.Tensor, group, ring_transport_bits: Optional[int]):
    c = config
    b, sl, _ = h.shape
    hd, nh, kvh = c.head_dim, c.num_attention_heads, c.kv_heads
    qd = dict(
        w_bits=c.w_bits, a_bits=c.a_bits, symmetric=c.symmetric,
        act_layerwise=c.act_layerwise, weight_layerwise=c.weight_layerwise,
        fused=c.fused_qat_matmul,
    )
    x = llama.rms_norm(h, lp["attn_norm"], c.rms_norm_eps)
    q = quant_dense(x, lp["q"], **qd)
    k = quant_dense(x, lp["k"], **qd)
    v = quant_dense(x, lp["v"], **qd)
    # the model's KV fake-quant at the reference hook point (local tokens)
    k = kv_fake_quant(k, c.kv_bits)
    v = kv_fake_quant(v, c.kv_bits)
    q = llama.apply_rope(q.reshape(b, sl, nh, hd), cos, sin)
    k = llama.apply_rope(k.reshape(b, sl, kvh, hd), cos, sin)
    v = v.reshape(b, sl, kvh, hd)
    attn = ring_flash_attention_local(q, k, v, group, kv_bits=ring_transport_bits)
    attn = quant_dense(attn.reshape(b, sl, nh * hd).to(h.dtype), lp["o"], **qd)
    h = h + attn
    x = llama.rms_norm(h, lp["mlp_norm"], c.rms_norm_eps)
    gate = quant_dense(x, lp["gate"], **qd)
    up = quant_dense(x, lp["up"], **qd)
    return h + quant_dense(llama.silu(gate) * up, lp["down"], **qd)


def cp_forward(params, config: LlamaConfig, input_ids: torch.Tensor, mesh, axis: str = "cp", *,
               remat: bool = False, dtype=None,
               ring_transport_bits: Optional[int] = None) -> torch.Tensor:
    """Ring-parallel forward of this rank's chunk ``input_ids`` ``[b, sl]``
    (chunk ``idx`` of the sequence, ``idx`` the rank's place on ``axis``) ->
    its fp32 logits ``[b, sl, vocab]``. ``remat`` re-runs each layer in its
    backward, ring included."""
    c = config
    group = pmesh.axis_group(mesh, axis)
    idx = pmesh.axis_index(mesh, axis)
    b, sl = input_ids.shape
    h = params["embed"][input_ids]
    if dtype is not None:
        h = h.to(dtype)
    positions = idx * sl + torch.arange(sl, dtype=torch.int32, device=h.device).expand(b, sl)
    cos, sin = llama.rope_cos_sin(positions, c.head_dim, c.rope_theta)
    layers = {k: params["layers"][k].unbind(0) for k in llama._LAYER_KEYS}
    rematerialize = remat and torch.is_grad_enabled()

    def body(h, *leaves):
        out = _cp_decoder_layer(h, dict(zip(llama._LAYER_KEYS, leaves)), c, cos, sin, group,
                                ring_transport_bits)
        # keep the carry at the activation type (f32 params + bf16 compute)
        return out.to(h.dtype)

    for l in range(c.num_hidden_layers):
        leaves = [layers[k][l] for k in llama._LAYER_KEYS]
        h = llama.remat(body, h, *leaves) if rematerialize else body(h, *leaves)
    return llama._logits(params, c, h)
