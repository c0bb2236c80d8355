"""LLaMA building blocks used by the serving path (the serving subset of the
JAX package's ``models/llama.py``).

Numerics kept from the reference: RMSNorm accumulates in fp32, RoPE uses fp32
cos/sin tables (``inv_freq = theta^(-2i/d)``, table ``concat(freqs, freqs)``),
attention takes an fp32 softmax. The training forward (fake-quant
projections, KV hook, remat) comes with the training slice.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm with fp32 accumulation, rounded to ``x``'s type before the
    gain (which promotes like the JAX package: bf16 x, f32 gain -> f32)."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * scale


def rope_cos_sin(
    positions: torch.Tensor, head_dim: int, theta: float
) -> Tuple[torch.Tensor, torch.Tensor]:
    """fp32 cos/sin tables ``[b, s, head_dim]`` for absolute positions
    ``[b, s]``."""
    inv_freq = 1.0 / (
        theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                               device=positions.device) / head_dim)
    )
    freqs = positions.float()[..., None] * inv_freq
    emb = torch.cat([freqs, freqs], dim=-1)
    return torch.cos(emb), torch.sin(emb)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotate-half RoPE. ``x`` is ``[b, s, heads, head_dim]``; cos/sin
    ``[b, s, head_dim]``."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    rotated = torch.cat([-x2, x1], dim=-1)
    c = cos[:, :, None, :].to(x.dtype)
    s = sin[:, :, None, :].to(x.dtype)
    return x * c + rotated * s


def _attend(
    q: torch.Tensor,     # [b, s_q, nh, hd]
    k: torch.Tensor,     # [b, s_kv, kvh, hd]
    v: torch.Tensor,     # [b, s_kv, kvh, hd]
    mask: torch.Tensor,  # [b, 1, s_q, s_kv] additive (0 or -1e9)
) -> torch.Tensor:
    """Scaled dot-product attention with fp32 softmax over the full score
    matrix; GQA by head groups, K/V never repeated. Returns
    ``[b, s_q, nh*hd]``."""
    b, s_q, nh, hd = q.shape
    kvh = k.shape[2]
    groups = nh // kvh
    qg = q.reshape(b, s_q, kvh, groups, hd)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), k.float())
    scores = scores / math.sqrt(hd)
    scores = scores + mask[:, :, None, :, :]
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs.to(v.dtype).float(), v.float())
    return out.reshape(b, s_q, nh * hd).to(q.dtype)
