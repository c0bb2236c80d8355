"""Model weights for the port: random initialisation and conversion from and
to the JAX package's parameter layout (params and optimizer state).

Params are a dict of tensors in the JAX package's layout: per-layer weights
stacked on a leading ``[L, ...]`` axis and stored ``[in, out]``::

    {"embed": [V, H], "final_norm": [H], ("lm_head": [H, V]),
     "layers": {"attn_norm": [L, H], "q": [L, H, nh*hd], "k"/"v": [L, H, kvh*hd],
                "o": [L, nh*hd, H], "mlp_norm": [L, H], "gate"/"up": [L, H, I],
                "down": [L, I, H]}}

Quantized serving params (``inference.quantized.quantize_params``) replace
each projection by ``{"q": ints, "s": f32 scales}``.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from llm_qat_torch.device import resolve_device
from llm_qat_torch.models.config import LlamaConfig

Params = Dict[str, Any]


def from_numpy(tree, device=None, dtype=None):
    """A JAX-layout pytree of numpy arrays (latent fp or already quantized)
    -> the same dict of tensors on ``device``. Integer arrays keep their
    type, quantization scales (key ``"s"``) stay float32, and other floating
    arrays become ``dtype`` when one is given (bfloat16 arrays from JAX,
    which numpy holds as ml_dtypes, go through float32)."""
    dev = resolve_device(device)

    def conv(x, key):
        a = np.asarray(x)
        if a.dtype.kind not in "biuf":   # e.g. ml_dtypes.bfloat16
            a = a.astype(np.float32)
        t = torch.from_numpy(np.ascontiguousarray(a)).to(dev)
        if t.is_floating_point():
            if key == "s":
                t = t.float()
            elif dtype is not None:
                t = t.to(dtype)
        return t

    def walk(node, key=None):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        return conv(node, key)

    return walk(tree)


def to_numpy(tree):
    """A dict of tensors (params, gradients, Adam moments) -> the same dict
    of numpy arrays on the host, in the JAX package's layout (the port keeps
    that layout, so nothing moves); bfloat16 goes through float32."""
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    t = tree.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy()


def opt_state_from_numpy(count, mu, nu, device=None, dtype=None):
    """The JAX package's ``FusedClipAdamWState`` fields as numpy (``count``
    int32 scalar, ``mu`` / ``nu`` param-shaped trees) -> the port's optimizer
    state ``{"count": int, "mu": ..., "nu": ...}`` on ``device``."""
    return {"count": int(np.asarray(count)), "mu": from_numpy(mu, device, dtype),
            "nu": from_numpy(nu, device, dtype)}


def opt_state_to_numpy(state):
    """The port's optimizer state -> ``(count, mu, nu)`` as numpy, the fields
    of the JAX package's ``FusedClipAdamWState``."""
    return (np.asarray(state["count"], np.int32), to_numpy(state["mu"]),
            to_numpy(state["nu"]))


_CACHE_DTYPES = {"k_q": (torch.int8, torch.uint8), "v_q": (torch.int8, torch.uint8),
                 "k_s": (torch.float32,), "v_s": (torch.float32,),
                 "lengths": (torch.int32,)}


def cache_from_numpy(cache, device=None) -> Dict[str, torch.Tensor]:
    """A serving cache of the JAX package as numpy arrays (``k_q``/``v_q``
    int8 or nibble-packed uint8 ``[L, b, kvh, hd(/2), S]``, ``k_s``/``v_s``
    f32 ``[L, b, S]``, ``lengths`` int32 ``[b]``) -> the port's cache on
    ``device``: same layout, so a cache prefilled by one package feeds the
    other's decode step. The tensors are copies; the port writes them in
    place."""
    if set(cache) != set(_CACHE_DTYPES):
        raise ValueError(f"serving cache keys {sorted(cache)}, expected {sorted(_CACHE_DTYPES)}")
    out = from_numpy({k: np.array(v) for k, v in cache.items()}, device)
    for k, t in out.items():
        if t.dtype not in _CACHE_DTYPES[k]:
            raise ValueError(f"serving cache {k} is {t.dtype}, expected {_CACHE_DTYPES[k]}")
    if out["v_q"].shape != out["k_q"].shape or out["k_q"].dtype != out["v_q"].dtype:
        raise ValueError("serving cache: V must share K's layout and type")
    return out


def paged_cache_from_numpy(cache, device=None) -> Dict[str, torch.Tensor]:
    """A page pool of the JAX package as numpy arrays (``k_q``/``v_q`` int8
    or nibble-packed uint8 ``[L, n_pages, kvh, hd(/2), P]``, ``k_s``/``v_s``
    f32 ``[L, n_pages, P]``) -> the port's pool on ``device``: same layout, so
    both packages can continue from the same pool. The tensors are copies;
    the port writes them in place."""
    keys = ("k_q", "k_s", "v_q", "v_s")
    if set(cache) != set(keys):
        raise ValueError(f"page pool keys {sorted(cache)}, expected {sorted(keys)}")
    out = from_numpy({k: np.array(v) for k, v in cache.items()}, device)
    for k, t in out.items():
        if t.dtype not in _CACHE_DTYPES[k]:
            raise ValueError(f"page pool {k} is {t.dtype}, expected {_CACHE_DTYPES[k]}")
    if (out["k_q"].dim() != 5 or out["v_q"].shape != out["k_q"].shape
            or out["k_q"].dtype != out["v_q"].dtype):
        raise ValueError("page pool: K and V are [L, n_pages, kvh, hd(/2), P] and "
                         "share layout and type")
    L, n_pages, _, _, P = out["k_q"].shape
    for k in ("k_s", "v_s"):
        if tuple(out[k].shape) != (L, n_pages, P):
            raise ValueError(f"page pool {k} is {tuple(out[k].shape)}, expected "
                             f"{(L, n_pages, P)}")
    return out


def init_params(config: LlamaConfig, seed: int = 0, device=None,
                dtype=torch.float32) -> Params:
    """Random init, normal(0, 0.02) like the reference's ``_init_weights``,
    drawn from a ``torch.Generator`` seeded with ``seed`` on ``device``
    (torch's numbers, not JAX's: the tests hand both packages numpy weights).
    Norm gains are ones."""
    dev = resolve_device(device)
    c = config
    hd, nh, kvh, L = c.head_dim, c.num_attention_heads, c.kv_heads, c.num_hidden_layers
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)

    def w(*shape):
        t = torch.empty(shape, dtype=torch.float32, device=dev)
        return t.normal_(0.0, 0.02, generator=gen).to(dtype)

    def ones(*shape):
        return torch.ones(shape, dtype=dtype, device=dev)

    params: Params = {
        "embed": w(c.vocab_size, c.hidden_size),
        "layers": {
            "attn_norm": ones(L, c.hidden_size),
            "q": w(L, c.hidden_size, nh * hd),
            "k": w(L, c.hidden_size, kvh * hd),
            "v": w(L, c.hidden_size, kvh * hd),
            "o": w(L, nh * hd, c.hidden_size),
            "mlp_norm": ones(L, c.hidden_size),
            "gate": w(L, c.hidden_size, c.intermediate_size),
            "up": w(L, c.hidden_size, c.intermediate_size),
            "down": w(L, c.intermediate_size, c.hidden_size),
        },
        "final_norm": ones(c.hidden_size),
    }
    if not c.tie_word_embeddings:
        params["lm_head"] = w(c.hidden_size, c.vocab_size)
    return params
