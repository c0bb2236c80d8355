"""Model configuration: the port's own copy of ``LlamaConfig`` and presets.

Field for field the same dataclass as the JAX package's ``models/config.py``
(so a config converts between the two packages with
``dataclasses.asdict``); it is copied rather than imported because the port
imports nothing of the JAX package. The flags name the serving paths; the
port honours each one it implements and raises on the rest.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    """Static (hashable) model configuration."""

    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: Optional[int] = None  # None => MHA (= num_attention_heads)
    max_position_embeddings: int = 2048
    rms_norm_eps: float = 1e-6
    rope_theta: float = 10000.0
    tie_word_embeddings: bool = False

    # Quantization bit-widths.
    w_bits: int = 32
    a_bits: int = 32
    kv_bits: int = 32
    symmetric: bool = True
    use_flash_attention: bool = True   # blockwise attention (training forward)
    use_decode_kernel: bool = True     # fused quantized-KV decode attention
    use_prefill_flash: bool = True     # flash prefill over fresh fake-quant KV
                                       # (serving, from-empty slots only)
    # Serving KV-cache layout: "pre" stores pre-RoPE integers (RoPE applied
    # on read); "post" rotates K before quantizing so reads skip RoPE.
    kv_cache_rope: str = "pre"
    # Nibble-pack the serving KV cache when kv_bits <= 4: two head-dim halves
    # per byte (split-half along head_dim, the int4 weights' scheme).
    kv_cache_pack: bool = True
    # Whole-model decode kernel (inference/megakernel.py): one launch per
    # decode step for all layers. Configs outside megakernel.supported() and
    # use_megakernel=False serve via the scan path. megakernel_bk overrides
    # the KV block of its online softmax; megakernel_nc is the JAX package's
    # weight-chunk width, read only to reproduce that package's KV block.
    use_megakernel: bool = True
    megakernel_nc: int = 0
    megakernel_bk: int = 0
    fused_qat_matmul: bool = True      # fused fake-quant matmul (QAT forward)
    # Evaluate the flash forward's exp2 on bf16 operands (default off: the
    # reference specifies an fp32 softmax). max/l/acc stay fp32.
    flash_softmax_bf16: bool = False
    fused_norm_quant: bool = True
    fused_silu_quant: bool = False
    act_layerwise: bool = False   # per-tensor instead of per-token
    weight_layerwise: bool = False

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @property
    def kv_heads(self) -> int:
        return self.num_key_value_heads or self.num_attention_heads

    def __post_init__(self):
        if self.hidden_size % self.num_attention_heads != 0:
            raise ValueError(
                f"hidden_size {self.hidden_size} not divisible by "
                f"num_attention_heads {self.num_attention_heads}"
            )

    def replace(self, **kw) -> "LlamaConfig":
        return dataclasses.replace(self, **kw)

    @classmethod
    def from_hf_dict(cls, d: dict, **overrides) -> "LlamaConfig":
        """Build from a HuggingFace ``config.json`` dict; quantization
        bit-widths come in via ``overrides``."""
        kw = dict(
            vocab_size=d.get("vocab_size", 32000),
            hidden_size=d.get("hidden_size", 4096),
            intermediate_size=d.get("intermediate_size", 11008),
            num_hidden_layers=d.get("num_hidden_layers", 32),
            num_attention_heads=d.get("num_attention_heads", 32),
            num_key_value_heads=d.get("num_key_value_heads"),
            max_position_embeddings=d.get("max_position_embeddings", 2048),
            rms_norm_eps=d.get("rms_norm_eps", 1e-6),
            rope_theta=d.get("rope_theta", 10000.0),
            tie_word_embeddings=d.get("tie_word_embeddings", False),
        )
        kw.update(overrides)
        return cls(**kw)

    @classmethod
    def from_json(cls, path: str, **overrides) -> "LlamaConfig":
        with open(path) as f:
            return cls.from_hf_dict(json.load(f), **overrides)


TINY_TEST = LlamaConfig(
    vocab_size=256,
    hidden_size=64,
    intermediate_size=128,
    num_hidden_layers=2,
    num_attention_heads=4,
    num_key_value_heads=2,
    max_position_embeddings=128,
)

TINYLLAMA_1B = LlamaConfig(
    vocab_size=32000,
    hidden_size=2048,
    intermediate_size=5632,
    num_hidden_layers=22,
    num_attention_heads=32,
    num_key_value_heads=4,
    max_position_embeddings=2048,
    rope_theta=10000.0,
)

LLAMA_7B = LlamaConfig()

LLAMA_13B = LlamaConfig(
    hidden_size=5120, intermediate_size=13824, num_hidden_layers=40,
    num_attention_heads=40,
)

LLAMA_30B = LlamaConfig(
    hidden_size=6656, intermediate_size=17920, num_hidden_layers=60,
    num_attention_heads=52,
)
