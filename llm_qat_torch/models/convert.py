"""HF checkpoint <-> llm_qat_torch params conversion (the JAX package's
``models/convert.py``).

The on-disk format is the reference's: ``config.json`` + ``*.safetensors``
(or torch ``*.bin``) with ``model.layers.{i}.self_attn.q_proj.weight``-style
keys, linear weights ``[out, in]``. Params keep the JAX package's layout:
``[in, out]`` with the per-layer tensors stacked on a leading layer axis.

The safetensors format is read and written here by hand (8-byte little-endian
header length, a JSON header, then the raw bytes of each tensor), so the port
needs no ``safetensors`` package; the bytes written are the package's own for
the same tensors (``tests/test_torch_convert.py``).
"""

from __future__ import annotations

import json
import mmap
import os
import struct
from typing import Dict, Tuple

import torch

from llm_qat_torch.device import resolve_device
from llm_qat_torch.models.config import LlamaConfig

# HF key templates -> (our path, transpose?)
_LAYER_KEYS = {
    "input_layernorm.weight": ("attn_norm", False),
    "self_attn.q_proj.weight": ("q", True),
    "self_attn.k_proj.weight": ("k", True),
    "self_attn.v_proj.weight": ("v", True),
    "self_attn.o_proj.weight": ("o", True),
    "post_attention_layernorm.weight": ("mlp_norm", False),
    "mlp.gate_proj.weight": ("gate", True),
    "mlp.up_proj.weight": ("up", True),
    "mlp.down_proj.weight": ("down", True),
}

# safetensors dtype names, in the order the format lays tensors out (first
# to last; ties by name)
_ST_DTYPES = {
    "I64": torch.int64, "F64": torch.float64, "F32": torch.float32, "I32": torch.int32,
    "BF16": torch.bfloat16, "F16": torch.float16, "I16": torch.int16, "I8": torch.int8,
    "U8": torch.uint8, "BOOL": torch.bool,
}
_ST_NAMES = {v: k for k, v in _ST_DTYPES.items()}
_ST_RANK = {name: i for i, name in enumerate(_ST_DTYPES)}


def save_safetensors(tensors: Dict[str, torch.Tensor], path: str) -> int:
    """Write ``tensors`` as one safetensors file; returns the bytes written.
    Layout as the ``safetensors`` package lays it out: tensors ordered by
    dtype (widest first) then name, the JSON header compact and padded with
    spaces to a multiple of 8 bytes."""
    items = sorted(tensors.items(), key=lambda kv: (_ST_RANK[_ST_NAMES[kv[1].dtype]], kv[0]))
    header, offset = {}, 0
    for name, t in items:
        n = t.numel() * t.element_size()
        header[name] = {"dtype": _ST_NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + n]}
        offset += n
    head = json.dumps(header, separators=(",", ":")).encode()
    head += b" " * (-len(head) % 8)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(struct.pack("<Q", len(head)))
        f.write(head)
        for _, t in items:
            flat = t.detach().to("cpu").contiguous().reshape(-1)
            if flat.numel():
                f.write(flat.view(torch.uint8).numpy().data)
    os.replace(tmp, path)
    return 8 + len(head) + offset


def load_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """Read every tensor of one safetensors file into CPU tensors."""
    out: Dict[str, torch.Tensor] = {}
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        size = os.fstat(f.fileno()).st_size
        if size == 8 + n:
            buf = None
        else:
            buf = torch.frombuffer(mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY),
                                   dtype=torch.uint8)
    for name, info in header.items():
        if name == "__metadata__":
            continue
        if info["dtype"] not in _ST_DTYPES:
            raise ValueError(f"{path}: {name} has dtype {info['dtype']}, which is not read")
        lo, hi = info["data_offsets"]
        raw = buf[8 + n + lo:8 + n + hi] if hi > lo else torch.empty(0, dtype=torch.uint8)
        out[name] = raw.view(_ST_DTYPES[info["dtype"]]).reshape(info["shape"]).clone()
    return out


def params_from_state_dict(sd: Dict[str, torch.Tensor], config: LlamaConfig,
                           dtype=torch.bfloat16, device=None):
    """Convert an HF LLaMA state dict (CPU tensors) to the stacked params on
    ``device`` (``cuda`` unless ``"cpu"`` is passed)."""
    dev = resolve_device(device)
    L = config.num_hidden_layers

    def put(t):
        return t.to(dtype).contiguous().to(dev)

    layers = {}
    for hf_key, (ours, transpose) in _LAYER_KEYS.items():
        ws = [sd[f"model.layers.{i}.{hf_key}"] for i in range(L)]
        layers[ours] = put(torch.stack([w.t() if transpose else w for w in ws]))
    params = {
        "embed": put(sd["model.embed_tokens.weight"]),
        "layers": layers,
        "final_norm": put(sd["model.norm.weight"]),
    }
    if not config.tie_word_embeddings:
        params["lm_head"] = put(sd["lm_head.weight"].t())
    return params


def state_dict_from_params(params, config: LlamaConfig,
                           dtype=torch.float32) -> Dict[str, torch.Tensor]:
    """Inverse of :func:`params_from_state_dict`: the latent fp weights in HF
    layout, as contiguous CPU tensors of ``dtype`` (float32, as the JAX
    package writes them, unless asked otherwise)."""

    def host(t):
        return t.detach().to("cpu").to(dtype)

    sd: Dict[str, torch.Tensor] = {
        "model.embed_tokens.weight": host(params["embed"]).contiguous(),
        "model.norm.weight": host(params["final_norm"]).contiguous(),
    }
    if not config.tie_word_embeddings:
        sd["lm_head.weight"] = host(params["lm_head"]).t().contiguous()
    for hf_key, (ours, transpose) in _LAYER_KEYS.items():
        stacked = host(params["layers"][ours])
        for i in range(config.num_hidden_layers):
            w = stacked[i]
            sd[f"model.layers.{i}.{hf_key}"] = (w.t() if transpose else w).contiguous()
    return sd


def _load_raw_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """Read safetensors shards (preferred) or torch .bin shards."""
    st_files = sorted(f for f in os.listdir(path) if f.endswith(".safetensors"))
    sd: Dict[str, torch.Tensor] = {}
    if st_files:
        for fname in st_files:
            sd.update(load_safetensors(os.path.join(path, fname)))
        return sd
    bin_files = sorted(f for f in os.listdir(path) if f.endswith(".bin"))
    if not bin_files:
        raise FileNotFoundError(f"no safetensors/bin weights under {path}")
    for fname in bin_files:
        sd.update(torch.load(os.path.join(path, fname), map_location="cpu",
                             weights_only=True))
    return sd


def load_hf_checkpoint(path: str, dtype=torch.bfloat16, device=None,
                       **config_overrides) -> Tuple[LlamaConfig, dict]:
    """Load an HF LLaMA checkpoint directory into (config, params).

    ``config_overrides`` carries the quantization bit-widths, mirroring the
    reference's config injection (train.py:50-54). Params land on ``device``
    (``cuda`` unless ``"cpu"`` is passed)."""
    config = LlamaConfig.from_json(os.path.join(path, "config.json"), **config_overrides)
    sd = _load_raw_state_dict(path)
    if "lm_head.weight" not in sd and not config.tie_word_embeddings:
        config = config.replace(tie_word_embeddings=True)
    return config, params_from_state_dict(sd, config, dtype, device)


def save_hf_checkpoint(params, config: LlamaConfig, path: str,
                       dtype=torch.float32) -> int:
    """Write params as an HF-format directory (config.json + safetensors,
    float32 as the JAX package writes it unless ``dtype`` says otherwise);
    returns the bytes of the weights file."""
    os.makedirs(path, exist_ok=True)
    sd = state_dict_from_params(params, config, dtype)
    n = save_safetensors(sd, os.path.join(path, "model.safetensors"))
    hf_cfg = {
        "architectures": ["LlamaForCausalLM"],
        "model_type": "llama",
        "vocab_size": config.vocab_size,
        "hidden_size": config.hidden_size,
        "intermediate_size": config.intermediate_size,
        "num_hidden_layers": config.num_hidden_layers,
        "num_attention_heads": config.num_attention_heads,
        "num_key_value_heads": config.kv_heads,
        "max_position_embeddings": config.max_position_embeddings,
        "rms_norm_eps": config.rms_norm_eps,
        "rope_theta": config.rope_theta,
        "tie_word_embeddings": config.tie_word_embeddings,
        "w_bits": config.w_bits,
        "a_bits": config.a_bits,
        "kv_bits": config.kv_bits,
    }
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(hf_cfg, f, indent=2)
    return n
